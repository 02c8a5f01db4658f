#!/usr/bin/env python3
"""Time the meshless serving phases of ``chip_smoke.py`` in two checkouts.

    python3 tools/serve_ab.py --pair <parent checkout> <change checkout>
    python3 tools/serve_ab.py --root <checkout> [--label NAME]

``--root`` runs, in this process, the phases of ``<checkout>``'s own
``chip_smoke.py`` (importing ``repro_torch`` from ``<checkout>/src``)
that serve without a mesh: ``serve`` (llama3.2-3b, full width and
depth, 8 requests of 5-300 prompt tokens and 32 new tokens),
``control_plane``, ``lm_session``, ``serve_deepseek`` (4 layers) and
``serve_llama4`` (4 layers, 64 experts), each on its own seeded
weights and ticket, the card's memory handed back between them, after
building the checkout's kernels.  It prints one JSON line: each phase's
seconds on the host clock and the numbers of its summary (decode step
p50/min in ms, tokens/s, TTFT; the control plane's decode p50 by cache
layout, fleet TTFT and swap verify ms; the LM session's times).

``--pair`` runs ``--root`` in a fresh process for parent, change,
change, parent (the first run of each checkout builds its kernels),
prints each run's line and then one summary line: every number's
values by checkout in run order.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

PHASES = ("serve", "control_plane", "lm_session", "serve_deepseek",
          "serve_llama4")


def _numbers(summary: dict) -> dict:
    """The summary's numbers, and its dicts of numbers."""
    def num(v):
        return isinstance(v, (int, float)) and not isinstance(v, bool)

    out = {}
    for k, v in summary.items():
        if num(v):
            out[k] = v
        elif isinstance(v, dict) and v and all(num(x) for x in v.values()):
            out[k] = v
    return out


def run_root(root: Path, label: str) -> dict:
    sys.path[:0] = [str(root), str(root / "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build

    cs.OUT.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    _build.build_all()
    out = {"label": label, "root": str(root),
           "build_s": time.perf_counter() - t0, "phases": {}}
    cfg = get_arch("llama3.2-3b")
    runs = {"serve": lambda: cs.serve(cfg, "cuda", dispatch=True)[1],
            "control_plane": lambda: cs.control_plane(cfg, "cuda")[1],
            "lm_session": lambda: cs.lm_session("cuda"),
            "serve_deepseek": lambda: cs.serve_deepseek(
                cs.deepseek_config(), "cuda")[1],
            "serve_llama4": lambda: cs.serve_llama4("cuda")[1]}
    for name in PHASES:
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        summary = runs[name]()
        out["phases"][name] = {"s": time.perf_counter() - t0,
                               **_numbers(summary)}
    return out


def run_pair(parent: Path, change: Path) -> None:
    lines = []
    for label, root in (("parent", parent), ("change", change),
                        ("change", change), ("parent", parent)):
        res = subprocess.run(
            [sys.executable, __file__, "--root", str(root), "--label",
             label], capture_output=True, text=True)
        if res.returncode:
            sys.stderr.write(res.stdout[-4000:] + res.stderr[-8000:])
            raise SystemExit(f"{label} run in {root} exited "
                             f"{res.returncode}")
        line = res.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        lines.append(json.loads(line))
    by = {}
    for run in lines:
        for phase, nums in run["phases"].items():
            for k, v in nums.items():
                by.setdefault(phase, {}).setdefault(k, {}).setdefault(
                    run["label"], []).append(v)
    print(json.dumps({"serve_ab": by}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path)
    ap.add_argument("--label", default="run")
    ap.add_argument("--pair", type=Path, nargs=2,
                    metavar=("PARENT", "CHANGE"))
    args = ap.parse_args()
    if args.pair:
        run_pair(*(p.resolve() for p in args.pair))
    elif args.root:
        print(json.dumps(run_root(args.root.resolve(), args.label),
                         default=str))
    else:
        ap.error("give --root or --pair")
    return 0


if __name__ == "__main__":
    sys.exit(main())
