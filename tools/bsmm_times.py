#!/usr/bin/env python3
"""Time the block-sparse matmul kernels (and fused-V paged attention) of
a checkout's PyTorch/CUDA port.

    python3 tools/bsmm_times.py --root <checkout> [--label NAME] [--sweep]

Imports ``repro_torch`` from ``<checkout>/src``, so that two checkouts
(a commit and its parent) can be timed one after the other on the same
card, builds its ``bsmm`` kernels and times, in bfloat16, on seeded
~25 %-live tile plans (``chip_smoke.random_bitmap``, column tile 0
dead) at the four llama3.2-3b projection shapes (3072x3072, 3072x1024,
3072x8192, 8192x3072):

- ``bsmm`` (#1) and ``bsmm_epilogue`` (#2, bias and silu) at 8, 512 and
  1024 rows;
- ``bsmm_dx`` (#3) and ``bsmm_dw`` (#4) at 1024 rows;
- ``bsmm_batched`` (#1b) at deepseek-v3's expert up/gate shape (256
  experts, 8 rows, 7168x2048);
- ``bsmm_batched`` and ``bsmm_batched_dx`` (#3b) at training capacity
  (``chip_smoke.py``'s deepseek retrain: 32 experts, 320 rows an
  expert) at the expert up/gate (7168x2048) and down (2048x7168)
  shapes;
- ``paged_attention`` in its fused-V form (#7) at ``chip_smoke.py``'s
  deepseek-v3 inputs (B = 8, 128 query heads over one latent head of
  576 lanes, values its first 512, lengths 1-1000);

each as the mean device milliseconds of a CUDA-graph replay
(``chip_smoke.time_ms``), cycling weight copies so that weights come
from device memory, beside one PyTorch call on the same inputs
(``torch.matmul`` on the dense masked weight, ``x.T @ g``, ``torch.bmm``)
and the bound (``chip_smoke.bsmm_bound_ms`` / ``grad_bound_ms``).
Where the checkout names routes (``route_and_splits``, ``bsmm_dx_route``,
``bsmm_batched_route``, ``fused_route``) it records the route and split
count of each call.  ``--sweep`` also times #1, #3 and #4 with each live
list (dw: each tile's rows) cut into 1-4 pieces, on a fresh plan with
the checkout's split rule (``bsmm_splits`` / ``bsmm_dx_splits`` /
``bsmm_dw_splits`` / ``bsmm_batched_splits``) set to that count (#3 and
the batched forms only where the checkout has their rules).  ``--only``
picks row groups
(``fwd``, ``grads``, ``batched``, ``training``, ``fused``).  It prints
one JSON line.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import (BSMM_SHAPES, EXPERT_SHAPES, EXPERTS,  # noqa: E402
                        RETRAIN_EXPERTS, bsmm_bound_ms, grad_bound_ms,
                        paged_inputs, random_bitmap, time_ms)

FWD_ROWS = (8, 512, 1024)
GRAD_ROWS = 1024
BATCHED = (8, 7168, 2048)       # rows per expert, K, N
TRAINING_ROWS = 320             # the deepseek retrain's capacity an expert
GROUPS = ("fwd", "grads", "batched", "training", "fused")


def _plan(B, rng, K, N):
    bm = random_bitmap(rng, K, N)
    return bm, B.make_tile_plan(np.kron(bm, np.ones((128, 128), bool)))


def _route(B, plan, kind, M):
    """The checkout's (route, splits) of a call, or (None, None) where it
    has no rule for ``kind``."""
    if not hasattr(plan, "route_and_splits") or (
            kind == "dx" and not hasattr(B, "bsmm_dx_route")):
        return None, None
    return plan.route_and_splits(kind, M, torch.bfloat16)


def _forced(B, bm, S, rows=FWD_ROWS, experts=1):
    """A fresh plan of ``bm`` whose calls at ``rows`` (of each of
    ``experts`` experts) cut their lists into ``S`` pieces (the
    checkout's split rules answer ``S`` while it is made and first
    used)."""
    plan = B.make_tile_plan(np.kron(bm, np.ones((128, 128), bool)))
    names = [n for n in ("bsmm_splits", "bsmm_dx_splits", "bsmm_dw_splits",
                         "bsmm_batched_splits") if hasattr(B, n)]
    rules = [getattr(B, n) for n in names]
    for n in names:
        setattr(B, n, lambda *a, **k: S)
    kinds = ["fwd", "dw"] + ["dx"] * ("bsmm_dx_splits" in names)
    if experts > 1:
        kinds += ["batched"] * ("bsmm_batched_splits" in names)
    try:
        for kind in kinds:
            for M in rows:
                plan.route_and_splits(kind, M, torch.bfloat16, experts)
    finally:
        for n, rule in zip(names, rules):
            setattr(B, n, rule)
    return plan


def _masked(w, bm):
    return w * torch.as_tensor(np.kron(bm, np.ones((128, 128))),
                               dtype=w.dtype, device=w.device)


def forward_rows(B, rng, sweep):
    rows = []
    for K, N in BSMM_SHAPES:
        bm, plan = _plan(B, rng, K, N)
        g = torch.Generator(device="cuda").manual_seed(K + N)
        w = (torch.randn(K, N, device="cuda", generator=g) / K ** 0.5
             ).bfloat16()
        copies = max(2, int(400e6 // (w.numel() * 2)) + 1)
        ws = [w.clone() for _ in range(copies)]
        ds = [_masked(v, bm) for v in ws]
        b = torch.randn(N, device="cuda", generator=g).bfloat16()
        for M in FWD_ROWS:
            x = torch.randn(M, K, device="cuda", generator=g).bfloat16()
            route, S = _route(B, plan, "fwd", M)
            row = {"kernel": "bsmm", "M": M, "K": K, "N": N,
                   "route": route, "splits": S,
                   "live_tiles": plan.live_tiles}
            row["ms"] = time_ms(lambda i: B.bsmm(x, ws[i % copies], plan))
            row["epilogue_ms"] = time_ms(
                lambda i: B.bsmm_epilogue(x, ws[i % copies], plan, b, "silu"))
            row["library_ms"] = time_ms(
                lambda i: torch.matmul(x, ds[i % copies]))
            row["bound_ms"], row["bound_by"] = bsmm_bound_ms(
                M, K, N, plan, 2, "bfloat16")
            if sweep:
                row["ms_by_splits"] = {}
                for S in range(1, 5):
                    p = _forced(B, bm, S)
                    row["ms_by_splits"][S] = time_ms(
                        lambda i: B.bsmm(x, ws[i % copies], p))
            rows.append(row)
        del ws, ds
    return rows


def grad_rows(B, rng, sweep):
    rows = []
    M = GRAD_ROWS
    for K, N in BSMM_SHAPES:
        bm, plan = _plan(B, rng, K, N)
        g_ = torch.Generator(device="cuda").manual_seed(K * 7 + N)
        w = (torch.randn(K, N, device="cuda", generator=g_) / K ** 0.5
             ).bfloat16()
        copies = max(2, int(400e6 // (w.numel() * 2)) + 1)
        ops = [(w.clone(),
                torch.randn(M, K, device="cuda", generator=g_).bfloat16(),
                torch.randn(M, N, device="cuda", generator=g_).bfloat16())
               for _ in range(copies)]
        ds = [_masked(o[0], bm) for o in ops]
        route, S = _route(B, plan, "dw", M)
        dx_route, dx_S = _route(B, plan, "dx", M)
        row = {"kernel": "bsmm_grads", "M": M, "K": K, "N": N,
               "dw_route": route, "dw_splits": S, "dx_route": dx_route,
               "dx_splits": dx_S, "live_tiles": plan.live_tiles}
        row["dx_ms"] = time_ms(lambda i: B.bsmm_dx(ops[i % copies][2],
                                                   ops[i % copies][0], plan))
        row["dw_ms"] = time_ms(lambda i: B.bsmm_dw(ops[i % copies][1],
                                                   ops[i % copies][2], plan))
        row["dx_library_ms"] = time_ms(
            lambda i: torch.matmul(ops[i % copies][2], ds[i % copies].T))
        row["dw_library_ms"] = time_ms(
            lambda i: torch.matmul(ops[i % copies][1].T, ops[i % copies][2]))
        for kind in ("dx", "dw"):
            row[f"{kind}_bound_ms"], row[f"{kind}_bound_by"] = grad_bound_ms(
                kind, M, K, N, plan, 2, "bfloat16")
        if sweep:
            row["dw_ms_by_splits"] = {}
            if dx_route is not None:
                row["dx_ms_by_splits"] = {}
            for S in range(1, 5):
                p = _forced(B, bm, S)
                row["dw_ms_by_splits"][S] = time_ms(
                    lambda i: B.bsmm_dw(ops[i % copies][1],
                                        ops[i % copies][2], p))
                if dx_route is not None:
                    row["dx_ms_by_splits"][S] = time_ms(
                        lambda i: B.bsmm_dx(ops[i % copies][2],
                                            ops[i % copies][0], p))
        rows.append(row)
        del ops, ds
    return rows


def _batched_route(B, plan, M, E):
    """The checkout's (route, splits) of a batched forward call, or
    (None, None) where it has no batched rule."""
    if not hasattr(B, "bsmm_batched_route"):
        return None, None
    return plan.route_and_splits("batched", M, torch.bfloat16, E)


def batched_row(B, rng):
    M, K, N = BATCHED
    bm, plan = _plan(B, rng, K, N)
    g = torch.Generator(device="cuda").manual_seed(K + 3 * N)
    w = torch.randn(EXPERTS, K, N, device="cuda", generator=g,
                    dtype=torch.bfloat16) / K ** 0.5
    a = torch.randn(EXPERTS, M, K, device="cuda", generator=g,
                    dtype=torch.bfloat16)
    route, S = _batched_route(B, plan, M, EXPERTS)
    row = {"kernel": "bsmm_batched", "E": EXPERTS, "M": M, "K": K, "N": N,
           "route": route, "splits": S, "live_tiles": plan.live_tiles}
    row["ms"] = time_ms(lambda i: B.bsmm_batched(a, w, plan), iters=10)
    dense = _masked(w, bm)
    row["library_ms"] = time_ms(lambda i: torch.bmm(a, dense), iters=10)
    row["bound_ms"], row["bound_by"] = bsmm_bound_ms(
        M, K, N, plan, 2, "bfloat16", experts=EXPERTS)
    return row


def training_rows(B, rng, sweep):
    """#1b and #3b at the deepseek retrain's capacity (32 experts, 320
    rows an expert) at the expert up/gate and down shapes, beside
    ``torch.bmm`` on the dense masked experts and the bounds; with
    ``sweep``, with each live list cut into 1-4 pieces.  A call reads
    more than the L2 holds."""
    E, M = RETRAIN_EXPERTS, TRAINING_ROWS
    rows = []
    for K, N in EXPERT_SHAPES:
        bm, plan = _plan(B, rng, K, N)
        g_ = torch.Generator(device="cuda").manual_seed(K + 5 * N)
        w = (torch.randn(E, K, N, device="cuda", generator=g_) / K ** 0.5
             ).bfloat16()
        x = torch.randn(E, M, K, device="cuda", generator=g_).bfloat16()
        g = torch.randn(E, M, N, device="cuda", generator=g_).bfloat16()
        dense = _masked(w, bm)
        fwd_route, fwd_S = _batched_route(B, plan, M, E)
        dx_route, dx_S = plan.route_and_splits("dx", M, torch.bfloat16, E)
        row = {"kernel": "bsmm_batched_training", "E": E, "M": M, "K": K,
               "N": N, "live_tiles": plan.live_tiles, "fwd_route": fwd_route,
               "fwd_splits": fwd_S, "dx_route": dx_route, "dx_splits": dx_S}
        calls = {"fwd": lambda p: (lambda i: B.bsmm_batched(x, w, p)),
                 "dx": lambda p: (lambda i: B.bsmm_batched_dx(g, w, p))}
        for kind, call in calls.items():
            row[f"{kind}_ms"] = time_ms(call(plan), iters=10)
        row["fwd_library_ms"] = time_ms(lambda i: torch.bmm(x, dense),
                                        iters=10)
        row["dx_library_ms"] = time_ms(
            lambda i: torch.bmm(g, dense.transpose(1, 2)), iters=10)
        row["fwd_bound_ms"], row["fwd_bound_by"] = bsmm_bound_ms(
            M, K, N, plan, 2, "bfloat16", experts=E)
        row["dx_bound_ms"], row["dx_bound_by"] = grad_bound_ms(
            "dx", M, K, N, plan, 2, "bfloat16", experts=E)
        if sweep:
            for kind, call in calls.items():
                if kind == "fwd" and fwd_route is None:
                    continue
                row[f"{kind}_ms_by_splits"] = {
                    S: time_ms(call(_forced(B, bm, S, (M,), E)), iters=10)
                    for S in range(1, 5)}
        rows.append(row)
        del w, x, g, dense
        torch.cuda.empty_cache()
    return rows


def fused_row(PA):
    """#7 at chip_smoke.py's deepseek-v3 inputs (bf16), cycling pool
    copies so that the latent rows come from device memory."""
    g = torch.Generator(device="cuda").manual_seed(11)
    q, kp, _, tables, lens = paged_inputs(torch.bfloat16, g, 128, 1, 576,
                                          True)
    copies = int(400e6 // (kp.numel() * kp.element_size())) + 1
    pools = [kp.clone() for _ in range(copies)]
    row = {"kernel": "paged_attention_fused_v", "B": q.shape[0], "Hq": 128,
           "Hkv": 1, "hd": 576, "dv": 512, "lengths": lens.tolist()}
    if hasattr(PA, "fused_route"):
        row["route"] = PA.fused_route(PA._check_geometry(
            q, kp, None, tables, lens, 512), q.dtype)
    row["ms"] = time_ms(lambda i: PA.paged_attention(
        q, pools[i % copies], None, tables, lens, scale=192 ** -0.5,
        v_dim=512))
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, type=Path,
                    help="checkout whose src/repro_torch is timed")
    ap.add_argument("--label", default="")
    ap.add_argument("--sweep", action="store_true",
                    help="also time #1, #3, #4 and the batched #1b and #3b "
                    "cut into 1-4 pieces")
    ap.add_argument("--only", default=",".join(GROUPS),
                    help="comma-separated row groups to time, of "
                    + ", ".join(GROUPS))
    args = ap.parse_args()
    only = set(args.only.split(","))
    if not only <= set(GROUPS):
        ap.error(f"--only takes {', '.join(GROUPS)}")
    if not torch.cuda.is_available():
        print("bsmm_times: CUDA is not available", file=sys.stderr)
        return 2
    root = args.root.resolve()
    sys.path.insert(0, str(root / "src"))
    import repro_torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import bsmm as B
    from repro_torch.kernels import paged_attention as PA

    if root not in Path(repro_torch.__file__).resolve().parents:
        print(f"bsmm_times: imported {repro_torch.__file__}, not the "
              f"package under {root}", file=sys.stderr)
        return 2
    _build.build_all(("bsmm", "paged_attention"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(1)
    rows = []
    with torch.inference_mode():
        if "fwd" in only:
            rows += forward_rows(B, rng, args.sweep)
        if "grads" in only:
            rows += grad_rows(B, rng, args.sweep)
        if "batched" in only:
            rows.append(batched_row(B, rng))
        if "training" in only:
            rows += training_rows(B, rng, args.sweep)
        if "fused" in only:
            rows.append(fused_row(PA))
    print(json.dumps({"label": args.label, "root": str(root), "device": smi,
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
