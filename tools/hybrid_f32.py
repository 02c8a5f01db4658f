"""recurrentgemma-2b's engine against its teacher-forced forward, in
float32 and in bfloat16.

``chip_smoke.serve_hybrid`` holds the bf16 engine's logits of a 4096-
and a 129-token request to a teacher-forced ``forward`` at
``TEACHER_TOL`` of each row's max |logit|.  This tool runs the same
ticket, prompts and comparison (``chip_smoke.teacher_forced``) at full
width and depth in both dtypes, so that a gap that shrinks to float32
rounding in float32 reads as bf16 rounding, and one that stays reads
as a departure.  One JSON line, with the card's name and power limit:

    python3 tools/hybrid_f32.py [--device cuda] [--max-new 8]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def run(cfg, device, max_new: int) -> dict:
    """The teacher-forced errors of ``serve_hybrid``'s two held requests
    (their prompts, ``max_new`` tokens each) at ``cfg``'s dtype."""
    from repro_torch._bridge import apply_masks
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import Request, ServeEngine

    gen = torch.Generator(device=device).manual_seed(0)
    params = tfm.init_params(gen, cfg, device=device)
    masks = cs.build_planned_ticket(params, device)
    params = apply_masks(params, masks)
    eng = ServeEngine(params=params, cfg=cfg, masks=masks, batch_slots=8,
                      capacity=cs.HYBRID_CAPACITY, device=device)
    prng = np.random.default_rng(5)
    prompts = [prng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in cs.HYBRID_LENGTHS]
    held = [Request(uid=i, prompt=prompts[i], max_new_tokens=max_new)
            for i in (len(prompts) - 1, 3)]        # 4096 and 129 tokens
    rows = {r.uid: [] for r in held}
    eng.logits_sink = lambda uid, row: rows[uid].append(row.copy())
    t0 = time.perf_counter()
    for r in held:
        eng.submit(r)
    while not eng.idle:
        eng.step()
    cs.sync(device)
    serve_s = time.perf_counter() - t0
    eng.logits_sink = None
    errs = {len(r.prompt): cs.teacher_forced(params, cfg, r, rows[r.uid],
                                             device) for r in held}
    return {"dtype": cfg.dtype, "teacher_forced_rel_err": errs,
            "serve_s": serve_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-new", type=int, default=8)
    args = ap.parse_args(argv)
    from repro_torch.configs import get_arch

    smi = None
    if torch.device(args.device).type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    base = get_arch("recurrentgemma-2b")
    out = {"device": smi or args.device, "tol": cs.TEACHER_TOL, "runs": []}
    for dtype in ("float32", "bfloat16"):
        out["runs"].append(run(dataclasses.replace(base, dtype=dtype),
                               args.device, args.max_new))
        if torch.device(args.device).type == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
