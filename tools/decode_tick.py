#!/usr/bin/env python3
"""Time llama3.2-3b's decode tick in the PyTorch/CUDA port of a checkout.

    python3 tools/decode_tick.py --root <checkout> [--label NAME] [--rounds 3]

Imports ``repro_torch`` from ``<checkout>/src``, so that two checkouts
(a commit and its parent) can be timed one after the other on the same
card, builds the kernels the serving path runs, and serves llama3.2-3b
at full width and depth (28 layers, seeded random weights, the ticket
of ``chip_smoke.build_ticket``: one seeded ~25 %-live 128x128 tile
bitmap per projection shared by every layer) on 8 slots: ``--rounds``
rounds of 8 requests of 5-300 prompt tokens and 32 new tokens, the
first round a warm-up.  It prints one JSON line:

- ``tick_ms``: every decode-only tick on the host clock, synchronised
  (p50, min, mean, count);
- ``profiled_tick``: one more decode-only tick of 8 busy slots under
  ``torch.profiler``: wall, device time, and the device time and
  launches of the paged-attention kernels and of the 2-D block-sparse
  forward (kernels #1 and #2, ``chip_smoke._kernel_group``'s
  ``bsmm_forward``);
- ``paged_call``: ``paged_attention`` at the decode shape (B = 8, 24/8
  heads, hd 128, bf16, the requests' lengths after 16 new tokens), 200
  calls issued back to back: host microseconds a call before the
  synchronise (what dispatching a call costs the host) and
  microseconds a call until the card is done;
- ``bsmm_call``: ``bsmm`` at the decode shape (8 rows, the up
  projection's 3072 x 8192 under a seeded ~25 %-live tile plan, bf16),
  timed the same way in 5 rounds (median and least), with the
  wrapper's launches a call and the card memory allocated across a
  round beyond its outputs (0 when no call allocates scratch).

Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import _kernel_group, build_ticket, random_bitmap  # noqa: E402

PROMPTS = (5, 17, 64, 127, 128, 129, 200, 300)
NEW_TOKENS = 32
CALLS = 200


def profiled_tick(eng) -> dict:
    """One decode-only tick under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ts = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - ts) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    device = sum(r[1] for r in rows)
    paged = [r for r in rows if "paged_attention" in r[0]]
    bsmm = [r for r in rows if _kernel_group(r[0]) == "bsmm_forward"]
    return {"wall_ms": wall,
            "device_ms": device if device else "not measured",
            "paged_ms": sum(r[1] for r in paged),
            "paged_launches": sum(r[2] for r in paged),
            "bsmm2d_ms": sum(r[1] for r in bsmm),
            "bsmm2d_launches": sum(r[2] for r in bsmm)}


def paged_call(PA, cfg, device) -> dict:
    """Host and card microseconds a ``paged_attention`` call."""
    g = torch.Generator(device=device).manual_seed(3)
    B, T, NB = 8, 128, 4
    hd, Hq, Hkv = cfg.head_dim_, cfg.n_heads, cfg.n_kv_heads
    q = torch.randn(B, Hq, hd, device=device, generator=g).bfloat16()
    kp, vp = (torch.randn(B * NB, T, Hkv, hd, device=device, generator=g)
              .bfloat16() for _ in range(2))
    tables = torch.arange(B * NB, dtype=torch.int32,
                          device=device).reshape(B, NB)
    lens = torch.tensor([n + 16 for n in PROMPTS], dtype=torch.int32,
                        device=device)

    def call():
        return PA.paged_attention(q, kp, vp, tables, lens, scale=hd ** -0.5)

    for _ in range(20):
        call()
    torch.cuda.synchronize()
    ts = time.perf_counter()
    for _ in range(CALLS):
        call()
    host = time.perf_counter() - ts
    torch.cuda.synchronize()
    done = time.perf_counter() - ts
    return {"host_us": host / CALLS * 1e6,
            "until_done_us": done / CALLS * 1e6}


def bsmm_call(B, device, rounds: int = 5) -> dict:
    """Host and card microseconds a ``bsmm`` call at the decode shape
    (the median and least of ``rounds`` rounds of CALLS calls), the
    wrapper's launches a call, and the bytes the calls allocated beyond
    their outputs."""
    K, N, M = 3072, 8192, 8
    bm = random_bitmap(np.random.default_rng(9), K, N)
    plan = B.make_tile_plan(np.kron(bm, np.ones((128, 128), bool)))
    g = torch.Generator(device=device).manual_seed(4)
    x = torch.randn(M, K, device=device, generator=g).bfloat16()
    w = (torch.randn(K, N, device=device, generator=g) / K ** 0.5).bfloat16()
    for _ in range(20):
        B.bsmm(x, w, plan)
    torch.cuda.synchronize()
    host, done, extra = [], [], 0
    n0 = B.bsmm.launches
    for _ in range(rounds):
        before = torch.cuda.memory_allocated()
        outs = []
        ts = time.perf_counter()
        for _ in range(CALLS):
            outs.append(B.bsmm(x, w, plan))
        host.append((time.perf_counter() - ts) / CALLS * 1e6)
        torch.cuda.synchronize()
        done.append((time.perf_counter() - ts) / CALLS * 1e6)
        extra = max(extra, torch.cuda.memory_allocated() - before
                    - sum(o.numel() * o.element_size() for o in outs))
        del outs
    return {"host_us": statistics.median(host), "host_us_min": min(host),
            "until_done_us": statistics.median(done),
            "launches_per_call": (B.bsmm.launches - n0) / (rounds * CALLS),
            "extra_bytes_allocated": extra}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, type=Path,
                    help="checkout whose src/repro_torch is timed")
    ap.add_argument("--label", default="")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_tick: CUDA is not available", file=sys.stderr)
        return 2
    root = args.root.resolve()
    sys.path.insert(0, str(root / "src"))
    import repro_torch
    from repro_torch._bridge import apply_masks
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.kernels import bsmm as B
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import Request, ServeEngine

    if root not in Path(repro_torch.__file__).resolve().parents:
        print(f"decode_tick: imported {repro_torch.__file__}, not the "
              f"package under {root}", file=sys.stderr)
        return 2
    _build.build_all(("bsmm", "paged_attention", "flash_attention"))
    cfg = get_arch("llama3.2-3b")
    device = "cuda"
    gen = torch.Generator(device=device).manual_seed(0)
    params = tfm.init_params(gen, cfg, device=device)
    masks = build_ticket(params, cfg, device)
    params = apply_masks(params, masks)
    eng = ServeEngine(params=params, cfg=cfg, masks=masks, batch_slots=8,
                      capacity=512, device=device)
    prng = np.random.default_rng(5)
    ticks = []
    for r in range(args.rounds + 1):
        for i, n in enumerate(PROMPTS):
            eng.submit(Request(
                uid=100 * r + i, prompt=prng.integers(
                    1, cfg.vocab_size, size=n).astype(np.int32),
                max_new_tokens=NEW_TOKENS if r < args.rounds else 4))
        if r == args.rounds:                # one profiled tick, 8 busy slots
            eng.step()
            eng.step()
            torch.cuda.synchronize()
            prof = profiled_tick(eng)
            eng.run()
            break
        while not eng.idle:
            before = eng.report.prefills
            ts = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            if eng.report.prefills == before and r > 0:     # r 0 warms up
                ticks.append((time.perf_counter() - ts) * 1e3)
    with torch.inference_mode():
        call = paged_call(PA, cfg, device)
        b_call = bsmm_call(B, device)
    ticks.sort()
    print(json.dumps({
        "label": args.label, "root": str(root),
        "tick_ms": {"p50": ticks[len(ticks) // 2], "min": ticks[0],
                    "mean": statistics.fmean(ticks), "count": len(ticks)},
        "profiled_tick": prof, "paged_call": call, "bsmm_call": b_call}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
