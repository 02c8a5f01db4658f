#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout with no arguments:

    python3 chip_smoke.py

Phases, each of which must pass (the script exits non-zero and prints
no result line otherwise):

1. print the card's name and power limit (``nvidia-smi``) and build the
   CUDA kernels from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per
   source, started together);
2. check every kernel against its plain PyTorch version on the card, at
   the shapes serving and retraining llama3.2-3b give it (forward bsmm
   and its epilogue, paged attention, the backward dx and dw with a
   ragged row count) and serving deepseek-v3 gives it (the fused-V
   paged attention of absorbed MLA, and bsmm batched over 256 experts),
   in bfloat16 and float32, with the tolerance printed, and time
   kernel, plain version and a library yardstick;
3. serve 8 requests through ``ServeEngine`` at the full width and depth
   of llama3.2-3b (28 layers, random weights from a seeded generator)
   with a crossbar-pruned ticket (one seeded 128x128 tile bitmap per
   projection, ~25 % live, shared by all layers), and check that every
   request finishes, that every kernel was launched on that path, that
   every logit is finite, and that block-sparse prefill through the
   ticket's plan agrees with dense prefill on the masked weights;
4. check one loss backward through the ticket's plan against dense
   autograd at full width and 2 layers;
5. retrain the full-width, full-depth ticket for 4 steps through
   ``LMAdapter.make_trainer(params, masks).run`` and check losses,
   parameters, pruned coordinates, ``sent_fraction`` and the launches
   of every kernel per step; then profile one more step;
6. free the llama models and serve 8 requests through ``ServeEngine`` on
   deepseek-v3 at full width with its one cut, 61 layers to 4 (three
   dense, one MoE layer of 256 experts, top-8, one shared expert; MLA
   attention; ~30 GB of bf16 parameters), with a ticket of one seeded
   tile bitmap per projection shared by every layer and expert, and
   check that every request finishes with finite logits, that the
   fused-V kernel ran once per layer and decode step (the GQA kernel
   never), that the bsmm, epilogue and batched launches match the
   model, and that block-sparse prefill agrees with dense prefill.

Before the last line it prints ``{"kernels": [...]}`` (per kernel: its
launches in its path's run — llama serving for the 2-D forward kernels
and GQA paged attention, retraining for dx and dw, deepseek serving for
the batched bsmm and the fused-V kernel — its error against the plain
version, its time, the plain version's, the bound and the library
call's), the serving, gradient-check, retrain and deepseek summaries
and the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``.  Longer records go to ``chiprun_out/``.
"""
from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"

# published H100 SXM peaks (NVIDIA data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

BSMM_SHAPES = ((3072, 3072), (3072, 1024), (3072, 8192), (8192, 3072))
GRAD_ROWS = (1024, 1000)      # LMAdapter's 8 x 128 tokens, and ragged
BSMM_ROWS = (8, 128, 512) + GRAD_ROWS     # serving, then retraining
LIVE_FRACTION = 0.25


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn, iters: int = 20, graph: bool = True) -> float:
    """Mean device milliseconds per call over ``iters`` calls (CUDA
    events).  With ``graph`` the calls are captured once into a CUDA
    graph and replayed, so that host launch overhead does not hide the
    device time of a kernel of a few microseconds; the plain versions,
    which copy host indices, run eagerly."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    run = lambda: [fn(i) for i in range(iters)]     # noqa: E731
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            run()
        run = g.replay
        run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def tolerance(dtype, ref) -> float:
    """bfloat16: 1e-2 of the output scale (outputs round to 8-bit
    mantissas and the two sums run in different orders); float32:
    1e-4 of it (K up to 8192 products summed in another order)."""
    scale = max(1.0, ref.float().abs().max().item())
    return (1e-2 if dtype == torch.bfloat16 else 1e-4) * scale


def random_bitmap(rng, K: int, N: int):
    """~25 % live 128x128 tiles; column tile 0 entirely dead."""
    bm = rng.random((K // 128, N // 128)) < LIVE_FRACTION
    bm[:, 0] = False
    return bm


def bsmm_bound_ms(M, K, N, plan, elem, dtype_name, experts=1) -> tuple:
    """Each expert's rows' live columns, live weight tiles and output
    once (one plan for all experts), or their flops."""
    live_k = len(set(int(k) for j in range(len(plan.counts))
                     for k in plan.idx[j, :plan.counts[j]]))
    nbytes = (experts * (M * live_k * 128 * elem
                         + plan.live_tiles * 128 * 128 * elem + M * N * elem)
              + plan.idx.size * 4 + plan.counts.size * 4)
    flops = 2.0 * experts * M * plan.live_tiles * 128 * 128
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# (bias, activation) cases; (None, None) is the backward's pre-activation
# recompute
EPILOGUES = ((None, "silu"), ("bias", "silu"), ("bias", "relu"),
             ("bias", "gelu"), ("bias", None), (None, None))


def check_bsmm(B, shapes=BSMM_SHAPES, rows=BSMM_ROWS, epilogues=EPILOGUES,
               timed=True, seed=1):
    """Both bsmm kernels against their plain versions at every shape;
    with ``timed``, times at the bfloat16 shapes.  Returns (errors,
    times)."""
    rng = np.random.default_rng(seed)
    dev = "cuda"
    err = {"bsmm": 0.0, "bsmm_epilogue": 0.0}
    times = []
    for dtype in (torch.bfloat16, torch.float32):
        for K, N in shapes:
            bm = random_bitmap(rng, K, N)
            plan = B.make_tile_plan(np.kron(bm, np.ones((128, 128), bool)))
            require(int((plan.counts == 0).sum()) > 0, "no dead column")
            g = torch.Generator(device=dev).manual_seed(K + N)
            w = (torch.randn(K, N, device=dev, generator=g) / K ** 0.5
                 ).to(dtype)
            bias = torch.randn(N, device=dev, generator=g).to(dtype)
            for M in rows:
                x = torch.randn(M, K, device=dev, generator=g).to(dtype)
                cases = [("bsmm", B.bsmm(x, w, plan), B.bsmm_plain(x, w, plan))]
                for b, act in epilogues:
                    b = bias if b == "bias" else None
                    cases.append(("bsmm_epilogue",
                                  B.bsmm_epilogue(x, w, plan, b, act),
                                  B.bsmm_epilogue_plain(x, w, plan, b, act)))
                torch.cuda.synchronize()
                for name, got, want in cases:
                    e = (got.float() - want.float()).abs().max().item()
                    tol = tolerance(dtype, want)
                    print(f"check {name} {str(dtype)[6:]} M={M} K={K} N={N} "
                          f"max_abs_err={e:.3e} tol={tol:.3e}")
                    require(torch.isfinite(got).all().item(),
                            f"{name} non-finite")
                    require(e <= tol, f"{name} disagrees with its plain "
                            f"version at M={M} K={K} N={N} {dtype}")
                    err[name] = max(err[name], e)
                if timed and dtype == torch.bfloat16 and M in (8, 512):
                    times.append(time_bsmm(B, x, w, bm, plan, M, K, N))
            del w
    return err, times


def time_bsmm(B, x, w, bm, plan, M, K, N):
    """Kernel, plain and torch.matmul (on the masked dense weight) times,
    cycling weight copies so that the weights come from device memory
    as they do across 28 layers."""
    copies = max(2, int(400e6 // (w.numel() * w.element_size())) + 1)
    ws = [w.clone() for _ in range(copies)]
    dense = w * torch.as_tensor(np.kron(bm, np.ones((128, 128))),
                                dtype=w.dtype, device=w.device)
    ds = [dense.clone() for _ in range(copies)]
    b = torch.zeros(N, dtype=x.dtype, device=x.device)
    row = {"M": M, "K": K, "N": N, "dtype": "bfloat16",
           "live_tiles": plan.live_tiles, "total_tiles": plan.total_tiles}
    row["bsmm_ms"] = time_ms(lambda i: B.bsmm(x, ws[i % copies], plan))
    row["bsmm_epilogue_ms"] = time_ms(
        lambda i: B.bsmm_epilogue(x, ws[i % copies], plan, b, "silu"))
    row["plain_ms"] = time_ms(lambda i: B.bsmm_plain(x, ws[i % copies], plan),
                              iters=5, graph=False)
    row["epilogue_plain_ms"] = time_ms(
        lambda i: B.bsmm_epilogue_plain(x, ws[i % copies], plan, b, "silu"),
        iters=5, graph=False)
    row["matmul_ms"] = time_ms(lambda i: torch.matmul(x, ds[i % copies]))
    row["bound_ms"], row["bound_by"] = bsmm_bound_ms(M, K, N, plan, 2,
                                                     "bfloat16")
    print("time bsmm " + json.dumps(row))
    return row


def grad_bound_ms(kind, M, K, N, plan, elem, dtype_name) -> tuple:
    """Least time for dx or dw: bytes each input read once and the
    output written once (live columns and live tiles only), or the
    live tiles' flops, whichever is larger."""
    live_n = int((plan.counts > 0).sum())
    live_k = int((plan.counts_t > 0).sum())
    L = plan.live_tiles
    if kind == "dx":
        nbytes = (M * live_n * 128 * elem + L * 128 * 128 * elem
                  + M * K * elem + plan.idx_t.size * 4
                  + plan.counts_t.size * 4)
    else:
        nbytes = (M * live_k * 128 * elem + M * live_n * 128 * elem
                  + K * N * elem + 2 * L * 4)
    flops = 2.0 * M * L * 128 * 128
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_bsmm_grads(B):
    """dx and dw kernels against their plain versions at the four
    llama3.2-3b projection shapes, M = 1024 and a ragged 1000, bf16 and
    f32; dw exactly zero on dead tiles; times at bf16 M = 1024.
    Returns (errors, times)."""
    rng = np.random.default_rng(2)
    dev = "cuda"
    err = {"bsmm_dx": 0.0, "bsmm_dw": 0.0}
    times = []
    for dtype in (torch.bfloat16, torch.float32):
        for K, N in BSMM_SHAPES:
            bm = random_bitmap(rng, K, N)
            plan = B.make_tile_plan(np.kron(bm, np.ones((128, 128), bool)))
            dead = ~torch.as_tensor(bm, device=dev).repeat_interleave(
                128, 0).repeat_interleave(128, 1)
            g_ = torch.Generator(device=dev).manual_seed(K * 7 + N)
            w = (torch.randn(K, N, device=dev, generator=g_) / K ** 0.5
                 ).to(dtype)
            for M in GRAD_ROWS:
                x = torch.randn(M, K, device=dev, generator=g_).to(dtype)
                g = torch.randn(M, N, device=dev, generator=g_).to(dtype)
                cases = [("bsmm_dx", B.bsmm_dx(g, w, plan),
                          B.bsmm_dx_plain(g, w, plan)),
                         ("bsmm_dw", B.bsmm_dw(x, g, plan),
                          B.bsmm_dw_plain(x, g, plan))]
                torch.cuda.synchronize()
                for name, got, want in cases:
                    e = (got.float() - want.float()).abs().max().item()
                    tol = tolerance(dtype, want)
                    print(f"check {name} {str(dtype)[6:]} M={M} K={K} N={N} "
                          f"max_abs_err={e:.3e} tol={tol:.3e}")
                    require(torch.isfinite(got).all().item(),
                            f"{name} non-finite")
                    require(e <= tol, f"{name} disagrees with its plain "
                            f"version at M={M} K={K} N={N} {dtype}")
                    err[name] = max(err[name], e)
                require(bool((cases[1][1][dead] == 0).all().item()),
                        f"bsmm_dw wrote a dead tile at K={K} N={N}")
                if dtype == torch.bfloat16 and M == GRAD_ROWS[0]:
                    times.append(time_grads(B, x, g, w, bm, plan, M, K, N))
    return err, times


def time_grads(B, x, g, w, bm, plan, M, K, N):
    """dx and dw kernel, plain and library times (library: torch.matmul
    of g with the masked dense weight transposed, and of x^T with g),
    cycling operand copies so that they come from device memory."""
    copies = max(2, int(400e6 // (w.numel() * w.element_size())) + 1)
    ops = [(w.clone(), x.clone(), g.clone()) for _ in range(copies)]
    dense = w * torch.as_tensor(np.kron(bm, np.ones((128, 128))),
                                dtype=w.dtype, device=w.device)
    ds = [dense.clone() for _ in range(copies)]
    xt = [o[1].T for o in ops]
    row = {"M": M, "K": K, "N": N, "dtype": "bfloat16",
           "live_tiles": plan.live_tiles, "total_tiles": plan.total_tiles}
    row["dx_ms"] = time_ms(lambda i: B.bsmm_dx(ops[i % copies][2],
                                               ops[i % copies][0], plan))
    row["dw_ms"] = time_ms(lambda i: B.bsmm_dw(ops[i % copies][1],
                                               ops[i % copies][2], plan))
    row["dx_plain_ms"] = time_ms(lambda i: B.bsmm_dx_plain(g, w, plan),
                                 iters=5, graph=False)
    row["dw_plain_ms"] = time_ms(lambda i: B.bsmm_dw_plain(x, g, plan),
                                 iters=5, graph=False)
    row["dx_library_ms"] = time_ms(
        lambda i: torch.matmul(ops[i % copies][2], ds[i % copies].T))
    row["dw_library_ms"] = time_ms(
        lambda i: torch.matmul(xt[i % copies], ops[i % copies][2]))
    for kind in ("dx", "dw"):
        row[f"{kind}_bound_ms"], row[f"{kind}_bound_by"] = grad_bound_ms(
            kind, M, K, N, plan, 2, "bfloat16")
    print("time bsmm_grads " + json.dumps(row))
    return row


PAGED_LENGTHS = [1, 127, 128, 129, 300, 511, 64, 1000]


def paged_inputs(dtype, g, Hq, Hkv, hd, fused):
    """Batch 8 at the lengths above, a NaN scratch block behind every
    dead table entry; ``fused`` leaves out the value pool (values are
    the first lanes of each key row)."""
    B_, T, NB = 8, 128, 8
    P = 1 + sum(-(-n // T) for n in PAGED_LENGTHS) + 2
    kp = torch.randn(P, T, Hkv, hd, device="cuda", generator=g).to(dtype)
    kp[0] = float("nan")          # scratch block: dead table entries
    vp = None
    if not fused:
        vp = torch.randn(P, T, Hkv, hd, device="cuda", generator=g).to(dtype)
        vp[0] = float("nan")
    tables = torch.zeros(B_, NB, dtype=torch.int32)
    nxt = 1
    for b, n in enumerate(PAGED_LENGTHS):
        for j in range(-(-n // T)):
            tables[b, j] = nxt
            nxt += 1
    q = torch.randn(B_, Hq, hd, device="cuda", generator=g).to(dtype)
    lens = torch.tensor(PAGED_LENGTHS, dtype=torch.int32, device="cuda")
    return q, kp, vp, tables.cuda(), lens


def check_paged(PA, Hq=24, Hkv=8, hd=128, dv=None, scale=None, seed=7):
    """Paged attention against its plain version, bf16 and f32, timed in
    bf16: by default the GQA form (kernel #6) at llama3.2-3b's heads;
    with ``dv`` the fused-V form (kernel #7), values the first dv lanes
    of each key row."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    fused = dv is not None
    name = "paged_attention_fused_v" if fused else "paged_attention"
    scale = scale or hd ** -0.5
    err = 0.0
    row = None
    for dtype in (torch.bfloat16, torch.float32):
        q, kp, vp, tables, lens = paged_inputs(dtype, g, Hq, Hkv, hd, fused)
        got = PA.paged_attention(q, kp, vp, tables, lens, scale=scale,
                                 v_dim=dv)
        want = PA.paged_attention_ref(q, kp, vp, tables, lens, scale=scale,
                                      v_dim=dv)
        torch.cuda.synchronize()
        e = (got.float() - want.float()).abs().max().item()
        tol = tolerance(dtype, want)
        print(f"check {name} {str(dtype)[6:]} B=8 Hq={Hq} Hkv={Hkv} "
              f"hd={hd} dv={dv or hd} lengths={lens.tolist()} "
              f"max_abs_err={e:.3e} tol={tol:.3e}")
        require(torch.isfinite(got).all().item(),
                f"{name} saw a dead (NaN) block")
        require(e <= tol, f"{name} disagrees ({dtype})")
        err = max(err, e)
        if dtype == torch.bfloat16:
            row = time_paged(PA, name, q, kp, vp, tables, lens, scale, dv)
    return err, row


def time_paged(PA, name, q, kp, vp, tables, lens, scale, dv):
    B_, Hq, hd = q.shape
    Hkv = kp.shape[2]
    dv = dv or hd
    kp = kp.clone()
    kp[0] = 0.0        # the library yardstick reads dead entries too
    if vp is not None:
        vp = vp.clone()
        vp[0] = 0.0
    row = {"B": B_, "Hq": Hq, "Hkv": Hkv, "hd": hd, "dv": dv,
           "lengths": lens.tolist()}
    # cycle pool copies: a model's layers of pools do not stay in the L2
    pool_bytes = (kp.numel() + (0 if vp is None else vp.numel())) \
        * kp.element_size()
    copies = int(400e6 // pool_bytes) + 1
    pools = [(kp.clone(), None if vp is None else vp.clone())
             for _ in range(copies)]
    row["ms"] = time_ms(lambda i: PA.paged_attention(
        q, *pools[i % copies], tables, lens, scale=scale,
        v_dim=None if vp is not None else dv))
    row["plain_ms"] = time_ms(lambda i: PA.paged_attention_ref(
        q, kp, vp, tables, lens, scale=scale,
        v_dim=None if vp is not None else dv), iters=5, graph=False)
    # yardstick: SDPA on K/V already gathered to dense, each KV head
    # expanded to its query heads (fused: V = K[..., :dv])
    G = Hq // Hkv
    k = PA.paged_gather(kp, tables).permute(0, 2, 1, 3)
    k = k.repeat_interleave(G, dim=1).contiguous()
    if vp is None:
        v = k[..., :dv].contiguous()
    else:
        v = PA.paged_gather(vp, tables).permute(0, 2, 1, 3)
        v = v.repeat_interleave(G, dim=1).contiguous()
    L = k.shape[2]
    mask = (torch.arange(L, device="cuda")[None] < lens[:, None].long())
    mask = mask[:, None, None, :]
    qq = q[:, :, None, :]
    row["library_ms"] = time_ms(lambda i: F.scaled_dot_product_attention(
        qq, k, v, attn_mask=mask, scale=scale))
    elem = q.element_size()
    live = int(lens.sum().item())
    row_bytes = Hkv * (hd if vp is None else 2 * hd) * elem
    nbytes = (q.numel() * elem + live * row_bytes + B_ * Hq * dv * elem
              + tables.numel() * 4 + B_ * 4)
    flops = live * Hq * 2.0 * (hd + dv)
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = flops / PEAK_FLOPS["bfloat16"] * 1e3
    row["bound_ms"] = max(t_b, t_o)
    row["bound_by"] = "bytes" if t_b >= t_o else "operations"
    print(f"time {name} " + json.dumps(row))
    return row


def build_ticket(params, cfg, device):
    """One seeded ~25 %-live 128x128 tile bitmap per projection, shared
    by every layer (a (K, N) mask broadcast over the stacked repeats)."""
    rng = np.random.default_rng(1234)
    seg = params["segments"][0][0]
    reps = cfg.n_layers
    masks = {"attn": {}, "mlp": {}}
    for group, keys in (("attn", ("wq", "wk", "wv", "wo")),
                        ("mlp", ("up", "gate", "down"))):
        for key in keys:
            K, N = seg[group][key].shape[-2:]
            bm = torch.as_tensor(random_bitmap(rng, K, N), device=device)
            m = bm.repeat_interleave(128, 0).repeat_interleave(128, 1)
            masks[group][key] = m.expand(reps, K, N)
    return {"segments": [[masks]]}


def serve(cfg, device):
    from repro_torch._bridge import apply_masks
    from repro_torch.kernels import bsmm as B
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import Request, ServeEngine

    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    params = tfm.init_params(gen, cfg, device=device)
    masks = build_ticket(params, cfg, device)
    params = apply_masks(params, masks)
    sync(device)
    setup_s = time.perf_counter() - t0
    eng = ServeEngine(params=params, cfg=cfg, masks=masks, batch_slots=8,
                      capacity=512, device=device)
    nonfinite = [0]
    sample = eng._sample_row

    def checked(row, rng):
        nonfinite[0] += int((~np.isfinite(row)).sum())
        return sample(row, rng)

    eng._sample_row = checked
    prng = np.random.default_rng(5)
    lengths = (5, 17, 64, 127, 128, 129, 200, 300)
    reqs = [Request(uid=i, prompt=prng.integers(1, cfg.vocab_size, size=n)
                    .astype(np.int32), max_new_tokens=32)
            for i, n in enumerate(lengths)]
    for r in reqs:
        eng.submit(r)

    B.bsmm.launches = 0
    B.bsmm_epilogue.launches = 0
    PA.paged_attention.launches = 0
    step_ms = []
    t0 = time.perf_counter()
    while not eng.idle:
        before = eng.report.prefills
        ts = time.perf_counter()
        eng.step()
        sync(device)
        if eng.report.prefills == before:       # a decode-only tick
            step_ms.append((time.perf_counter() - ts) * 1e3)
    serve_s = time.perf_counter() - t0
    launches = {"bsmm": B.bsmm.launches,
                "bsmm_epilogue": B.bsmm_epilogue.launches,
                "paged_attention": PA.paged_attention.launches}
    rep = eng.report
    require(all(r.done and len(r.tokens) == 32 for r in reqs),
            "not every request finished")
    require(nonfinite[0] == 0, f"{nonfinite[0]} non-finite logits")
    require(all(v > 0 for v in launches.values()),
            f"a kernel was not launched on the serving path: {launches}")
    L = cfg.n_layers
    passes = rep.prefills + rep.decode_steps
    require(launches["bsmm"] == passes * L * 6
            and launches["bsmm_epilogue"] == passes * L
            and launches["paged_attention"] == rep.decode_steps * L,
            f"launch counts {launches} do not match {rep.prefills} prefills "
            f"and {rep.decode_steps} decode steps over {L} layers")

    # block-sparse prefill through the plan vs dense prefill on the
    # masked weights: same function, bf16 rounding in other places
    n = 129
    S = eng._bucket(n)
    toks = np.zeros((1, S), np.int64)
    toks[0, :n] = reqs[5].prompt
    with torch.inference_mode():
        batch = {"tokens": torch.as_tensor(toks, device=device)}
        vl = torch.tensor([n], dtype=torch.int32, device=device)
        got, _ = tfm.prefill(params, cfg, batch, S, valid_len=vl,
                             plan=eng.plan)
        want, _ = tfm.prefill(params, cfg, batch, S, valid_len=vl)
    diff = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    tol = 5e-2 * scale
    same_argmax = bool((got.argmax(-1) == want.argmax(-1)).all().item())
    print(f"check plan prefill vs dense masked prefill ({cfg.dtype}, "
          f"{L} layers, prompt {n}, bucket {S}): max_abs_err={diff:.4e} "
          f"max|logit|={scale:.4e} tol={tol:.4e} same_argmax={same_argmax}")
    require(bool(torch.isfinite(got).all().item()), "plan prefill non-finite")
    require(diff <= tol, "plan prefill disagrees with dense prefill")

    dispatch = time_decode_dispatch(eng, cfg, B, device)
    step_ms.sort()
    summary = {
        "setup_s": setup_s, "serve_s": serve_s,
        "decode_only_steps": len(step_ms),
        "decode_step_ms_p50": step_ms[len(step_ms) // 2] if step_ms else None,
        "decode_step_ms_min": step_ms[0] if step_ms else None,
        "launches": launches,
        "launches_per_decode_step": {"bsmm": 6 * L, "bsmm_epilogue": L,
                                     "paged_attention": L},
        "prefill_plan_vs_dense_max_abs_err": diff,
        "decode_dispatch": dispatch,
        "report": rep.__dict__,
    }
    return launches, summary


def time_decode_dispatch(eng, cfg, B, device) -> dict:
    """Decode-step host time with ``bsmm_apply`` calling the forward
    kernels directly (what serving runs: gradients are off) against
    routing every planned product through the ``torch.autograd.Function``
    the retrain path uses, alternating tick by tick on one engine so
    that both see the same batch and cache lengths.  A measurement, not
    a gate."""
    from repro_torch.serve import Request

    direct = B.bsmm_apply

    def via_function(x, w, plan, bias=None, act=None):
        return B.BsmmApply.apply(x, w, bias, plan, act)

    prng = np.random.default_rng(6)
    for i in range(8):
        eng.submit(Request(uid=100 + i, prompt=prng.integers(
            1, cfg.vocab_size, size=64).astype(np.int32), max_new_tokens=41))
    ms = {"direct": [], "function": []}
    tick = 0
    try:
        while not eng.idle:
            mode = ("direct", "function")[tick % 2]
            B.bsmm_apply = direct if mode == "direct" else via_function
            before = eng.report.prefills
            ts = time.perf_counter()
            eng.step()
            sync(device)
            if eng.report.prefills == before:
                ms[mode].append((time.perf_counter() - ts) * 1e3)
                tick += 1
    finally:
        B.bsmm_apply = direct
    out = {f"{k}_ms_p50": sorted(v)[len(v) // 2] for k, v in ms.items()}
    out["steps_each"] = min(len(v) for v in ms.values())
    print(f"decode dispatch: {json.dumps(out)}")
    return out


ROUTED = (("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
          ("mlp", "up"), ("mlp", "gate"), ("mlp", "down"))


def grad_check(cfg, device):
    """One loss backward at full width and 2 layers on masked weights,
    through the ticket's plan and densely (plan=None, torch autograd):
    the masked gradients of every routed weight agree within 5e-2 of
    their scale (bf16), and the plan path's are exactly zero on dead
    tiles before masking."""
    import dataclasses

    from repro_torch._bridge import apply_masks, tree_map
    from repro_torch.data import SyntheticLM
    from repro_torch.models import transformer as tfm
    from repro_torch.train import lm_train_plan

    cfg2 = dataclasses.replace(cfg, n_layers=2)
    gen = torch.Generator(device=device).manual_seed(3)
    params = tfm.init_params(gen, cfg2, device=device)
    masks = build_ticket(params, cfg2, device)
    params = apply_masks(params, masks)
    plan, _ = lm_train_plan(masks)
    b = SyntheticLM(256, 128, seed=0).batch(0, 8)
    batch = {k: torch.as_tensor(v, device=device) for k, v in b.items()}

    def grads(plan):
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss, _ = tfm.loss_fn(p, cfg2, batch, plan=plan)
        layer = p["segments"][0][0]
        return loss, torch.autograd.grad(
            loss, [layer[g][k] for g, k in ROUTED])

    loss_p, g_plan = grads(plan)
    loss_d, g_dense = grads(None)
    worst = 0.0
    for (group, key), gp, gd in zip(ROUTED, g_plan, g_dense):
        m = masks["segments"][0][0][group][key]
        gpm, gdm = gp.float() * m, gd.float() * m
        err = (gpm - gdm).abs().max().item()
        scale = gdm.abs().max().item()
        worst = max(worst, err / max(scale, 1e-30))
        dead_clean = bool((gp[~m] == 0).all().item())
        print(f"check grad {group}.{key} {tuple(gp.shape)} plan vs dense "
              f"max_abs_err={err:.4e} max|grad|={scale:.4e} "
              f"tol={5e-2 * scale:.4e} dead_tiles_zero={dead_clean}")
        require(bool(torch.isfinite(gp).all().item()), "non-finite grad")
        require(err <= 5e-2 * scale, f"plan grad of {group}.{key} disagrees "
                "with the dense grad")
        require(dead_clean, f"plan grad of {group}.{key} is not zero on "
                "dead tiles")
    print(f"check loss plan {loss_p.item():.6f} dense {loss_d.item():.6f}")
    return {"grad_rel_err_max": worst, "loss_plan": loss_p.item(),
            "loss_dense": loss_d.item()}


def retrain(cfg, device, steps: int = 4):
    """``LMAdapter.make_trainer(params, masks).run`` at full width and
    depth: finite losses and parameters, pruned coordinates exactly zero,
    ``sent_fraction`` equal to the mask share counted on the host, and
    the launch counts a step must make.  Steps run one ``run(1)`` at a
    time so that each is timed on the host clock (``run`` synchronises
    the card)."""
    from repro_torch._bridge import tree_leaves
    from repro_torch.api import LMAdapter
    from repro_torch.kernels import bsmm as B
    from repro_torch.models import transformer as tfm

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    adapter = LMAdapter(cfg, batch_size=8, seq_len=128, device=device)
    params = adapter.init_params(
        torch.Generator(device=device).manual_seed(0))
    masks = build_ticket(params, cfg, device)
    trainer = adapter.make_trainer(params, masks, learning_rate=1e-4)
    del params
    sync(device)
    setup_s = time.perf_counter() - t0

    # live prunable coordinates plus every unmasked one, over all
    total = sum(p.numel() for p in tree_leaves(trainer.state.params))
    pruned = sum(p.numel() - int(m.count_nonzero().item())
                 for p, m in _mask_pairs(trainer.state.params, masks))
    want_sent = (total - pruned) / total

    for f in (B.bsmm, B.bsmm_epilogue, B.bsmm_dx, B.bsmm_dw):
        f.launches = 0
    losses, sent, step_s = [], [], []
    for _ in range(steps):
        ts = time.perf_counter()
        m = trainer.run(1)
        step_s.append(time.perf_counter() - ts)
        losses.append(m["loss"])
        sent.append(m["sent_fraction"])
    launches = {"bsmm": B.bsmm.launches,
                "bsmm_epilogue": B.bsmm_epilogue.launches,
                "bsmm_dx": B.bsmm_dx.launches, "bsmm_dw": B.bsmm_dw.launches}
    peak = torch.cuda.max_memory_allocated() if on_card else None

    L = cfg.n_layers
    remat = tfm.remat_enabled()
    r = 2 if remat else 1
    want = {"bsmm": 6 * r * L, "bsmm_epilogue": (r + 1) * L,
            "bsmm_dx": 7 * L, "bsmm_dw": 7 * L}
    print(f"retrain: remat={remat} layers={L} losses={losses} "
          f"sent_fraction={sent[-1]} (host {want_sent}) launches={launches} "
          f"per step want {want}")
    require(all(np.isfinite(losses)), f"non-finite loss {losses}")
    require(all(abs(s - want_sent) < 1e-12 for s in sent),
            f"sent_fraction {sent} != host count {want_sent}")
    require(all(launches[k] == steps * v for k, v in want.items()),
            f"launch counts {launches} do not match {steps} steps of {want}")
    finite = all(bool(torch.isfinite(p).all().item())
                 for p in tree_leaves(trainer.state.params))
    require(finite, "a parameter is non-finite after retraining")
    for p, m in _mask_pairs(trainer.state.params, masks):
        require(not bool(((p != 0) & ~m).any().item()),
                "a pruned coordinate is non-zero after retraining")

    tokens = 8 * 128
    mid = sorted(step_s[1:])
    step_med = mid[len(mid) // 2]
    profile = profile_step(trainer) if on_card else None
    return launches, {
        "setup_s": setup_s, "steps": steps, "remat": remat,
        "step_s": step_s, "step_s_median_2_to_4": step_med,
        "tokens_per_s": tokens / step_med, "losses": losses,
        "sent_fraction": sent[-1], "sent_fraction_host": want_sent,
        "max_memory_allocated_bytes": peak,
        "launches_per_step": want, "live_tiles": adapter.last_plan_stats
        .live_tiles, "total_tiles": adapter.last_plan_stats.total_tiles,
        "profile": profile}


def _kernel_group(name: str) -> str:
    """A profiled CUDA kernel's group: the bsmm kernels by role (dx is
    the forward template with its last template argument, TRANS,
    true; the weight-streaming kernel runs the expert-batched products),
    paged attention, cuBLAS products, PyTorch's elementwise kernels,
    the rest."""
    import re

    if "bsmm_dw" in name:
        return "bsmm_dw"
    if "bsmm_stream" in name:
        return "bsmm_batched"
    if "paged_attention" in name:
        return "paged_attention"
    m = re.search(r"bsmm_\w+<([^>]*)>", name)
    if m:
        return "bsmm_dx" if m.group(1).replace(" ", "").endswith("true") \
            else "bsmm_forward"
    if "gemm" in name or "cutlass" in name or "nvjet" in name:
        return "library_gemm"
    if "elementwise" in name:
        return "elementwise"
    return "other"


def profile_step(trainer) -> dict:
    """One more retrain step under ``torch.profiler`` (after the counted
    run); see ``profile_call``."""
    return profile_call(lambda: trainer.run(1))


def profile_call(fn) -> dict:
    """``fn()`` under ``torch.profiler``: device time by kernel name,
    the call's host-clock time (``fn`` must end synchronised) and the
    device's busy share (kernel time over it).  A measurement, not a
    gate: where the profiler shows no device time it says so."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ts = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - ts) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    if device_ms == 0:
        return {"wall_ms": wall_ms, "device_ms": "not measured"}
    groups = {}
    for name, ms, _ in rows:
        groups[_kernel_group(name)] = groups.get(_kernel_group(name),
                                                 0.0) + ms
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms, "by_group_ms": groups,
            "top_kernels": [{"name": n[:120], "ms": ms, "calls": c}
                            for n, ms, c in rows[:25]]}


def _mask_pairs(params, masks):
    """(parameter, bool mask) for every masked routed weight."""
    for seg_p, seg_m in zip(params["segments"], masks["segments"]):
        for pos_p, pos_m in zip(seg_p, seg_m):
            for group, key in ROUTED:
                yield pos_p[group][key], pos_m[group][key]


# ---------------------------------------------------------------------------
# deepseek-v3: the expert-batched bsmm and the serving phase
# ---------------------------------------------------------------------------
EXPERT_SHAPES = ((7168, 2048), (2048, 7168))    # up/gate, down
# the 2-D bsmm shapes of deepseek-v3's dense FFNs (up/gate, down) and
# shared expert, at its decode rows, the 17-token prompt and the longest
DEEPSEEK_BSMM_SHAPES = ((7168, 18432), (18432, 7168)) + EXPERT_SHAPES
DEEPSEEK_BSMM_ROWS = (8, 17, 300)
EXPERT_ROWS = (8, 16, 20)     # rows per expert: decode, prefill, ragged
EXPERTS = 256


def check_bsmm_batched(B):
    """The expert-batched bsmm against its plain version at deepseek-v3's
    expert shapes (E = 256, one shared plan), M = 8, 16 and a ragged 20,
    bf16 and f32; timed in bf16 at M = 8 and 16 beside torch.bmm on the
    dense masked experts."""
    rng = np.random.default_rng(3)
    err = 0.0
    times = []
    for dtype in (torch.bfloat16, torch.float32):
        for K, N in EXPERT_SHAPES:
            bm = random_bitmap(rng, K, N)
            plan = B.make_tile_plan(np.kron(bm, np.ones((128, 128), bool)))
            g = torch.Generator(device="cuda").manual_seed(K + 3 * N)
            w = torch.randn(EXPERTS, K, N, device="cuda", generator=g,
                            dtype=dtype) / K ** 0.5
            for M in EXPERT_ROWS:
                a = torch.randn(EXPERTS, M, K, device="cuda", generator=g,
                                dtype=dtype)
                got = B.bsmm_batched(a, w, plan)
                want = B.bsmm_batched_plain(a, w, plan)
                torch.cuda.synchronize()
                e = (got.float() - want.float()).abs().max().item()
                tol = tolerance(dtype, want)
                print(f"check bsmm_batched {str(dtype)[6:]} E={EXPERTS} M={M} "
                      f"K={K} N={N} max_abs_err={e:.3e} tol={tol:.3e}")
                require(torch.isfinite(got).all().item(),
                        "bsmm_batched non-finite")
                require(e <= tol, f"bsmm_batched disagrees with its plain "
                        f"version at M={M} K={K} N={N} {dtype}")
                err = max(err, e)
                if dtype == torch.bfloat16 and M in (8, 16):
                    times.append(time_bsmm_batched(B, a, w, bm, plan, M, K,
                                                   N))
                del got, want
            del w
            torch.cuda.empty_cache()
    return err, times


def time_bsmm_batched(B, a, w, bm, plan, M, K, N):
    """Kernel, plain and torch.bmm (dense masked experts) times; one
    call reads gigabytes of weights, so nothing stays in the L2."""
    row = {"E": EXPERTS, "M": M, "K": K, "N": N, "dtype": "bfloat16",
           "live_tiles": plan.live_tiles, "total_tiles": plan.total_tiles}
    row["ms"] = time_ms(lambda i: B.bsmm_batched(a, w, plan), iters=10)
    row["plain_ms"] = time_ms(lambda i: B.bsmm_batched_plain(a, w, plan),
                              iters=3, graph=False)
    dense = w * torch.as_tensor(np.kron(bm, np.ones((128, 128))),
                                dtype=w.dtype, device=w.device)
    row["library_ms"] = time_ms(lambda i: torch.bmm(a, dense), iters=10)
    del dense
    row["bound_ms"], row["bound_by"] = bsmm_bound_ms(
        M, K, N, plan, 2, "bfloat16", experts=EXPERTS)
    print("time bsmm_batched " + json.dumps(row))
    return row


def build_expert_ticket(params, device):
    """deepseek-v3's ticket: one seeded ~25 %-live 128x128 tile bitmap
    per routed projection (dense-FFN, expert and shared-expert up, gate
    and down), shared by every layer of a segment and every expert as
    an expanded view, like ``build_ticket``.  MLA projections and the
    router stay unpruned (the reference plans neither)."""
    rng = np.random.default_rng(4321)

    def bitmap(shape):
        K, N = shape[-2:]
        bm = torch.as_tensor(random_bitmap(rng, K, N), device=device)
        return bm.repeat_interleave(128, 0).repeat_interleave(128, 1) \
            .expand(shape)

    def group(p):
        m = {k: bitmap(p[k].shape) for k in ("up", "gate", "down")}
        if "shared" in p:
            m["shared"] = group(p["shared"])
        return m

    return {"segments": [[{g: group(p[g]) for g in ("mlp", "moe") if g in p}
                          for p in pos_trees]
                         for pos_trees in params["segments"]]}


def serve_deepseek(cfg, device):
    """Serve 8 requests through ``ServeEngine`` on deepseek-v3 at full
    width, 4 layers (3 dense, 1 MoE of 256 experts), a crossbar ticket
    shared by every layer and expert; check finishing, finite logits,
    the launch counts the model implies and plan-vs-dense prefill."""
    from repro_torch._bridge import tree_leaves
    from repro_torch.core.masks import apply_masks_
    from repro_torch.kernels import bsmm as B
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import Request, ServeEngine

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    params = tfm.init_params(gen, cfg, device=device)
    masks = build_expert_ticket(params, device)
    apply_masks_(params, masks)            # full-width copies do not fit
    sync(device)
    setup_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    eng = ServeEngine(params=params, cfg=cfg, masks=masks, batch_slots=8,
                      capacity=512, device=device)
    nonfinite = [0]
    sample = eng._sample_row

    def checked(row, rng):
        nonfinite[0] += int((~np.isfinite(row)).sum())
        return sample(row, rng)

    eng._sample_row = checked
    prng = np.random.default_rng(8)
    lengths = (5, 17, 64, 127, 128, 129, 200, 300)
    budgets = [16 + (i * 16) // 7 for i in range(len(lengths))]   # 16..32
    reqs = [Request(uid=i, prompt=prng.integers(1, cfg.vocab_size, size=n)
                    .astype(np.int32), max_new_tokens=budgets[i])
            for i, n in enumerate(lengths)]
    for r in reqs:
        eng.submit(r)

    counters = ((B.bsmm, "launches"), (B.bsmm_epilogue, "launches"),
                (B.bsmm_batched, "launches"), (PA.paged_attention, "launches"),
                (PA.paged_attention, "fused_launches"))
    for f, attr in counters:
        setattr(f, attr, 0)
    step_ms = []
    t0 = time.perf_counter()
    while not eng.idle:
        before = eng.report.prefills
        ts = time.perf_counter()
        eng.step()
        sync(device)
        if eng.report.prefills == before:       # a decode-only tick
            step_ms.append((time.perf_counter() - ts) * 1e3)
    serve_s = time.perf_counter() - t0
    launches = {"bsmm": B.bsmm.launches,
                "bsmm_epilogue": B.bsmm_epilogue.launches,
                "bsmm_batched": B.bsmm_batched.launches,
                "paged_attention": PA.paged_attention.launches,
                "paged_attention_fused_v": PA.paged_attention.fused_launches}
    rep = eng.report
    require(all(r.done and len(r.tokens) == r.max_new_tokens for r in reqs),
            "not every deepseek request finished")
    require(nonfinite[0] == 0, f"{nonfinite[0]} non-finite logits")
    # per pass: a dense layer runs up and down through bsmm and the gate
    # through the epilogue; a MoE layer runs its three expert products
    # batched and its shared expert like a dense FFN; MLA runs dense
    n_moe = sum(1 for i in range(cfg.n_layers)
                if tfm.layer_signature(cfg, i)[1])
    n_dense = cfg.n_layers - n_moe
    passes = rep.prefills + rep.decode_steps
    want = {"bsmm": passes * 2 * (n_dense + n_moe),
            "bsmm_epilogue": passes * (n_dense + n_moe),
            "bsmm_batched": passes * 3 * n_moe,
            "paged_attention": 0,
            "paged_attention_fused_v": rep.decode_steps * cfg.n_layers}
    print(f"deepseek launches {launches}, want {want} ({rep.prefills} "
          f"prefills, {rep.decode_steps} decode steps, {n_dense} dense and "
          f"{n_moe} MoE layers)")
    require(launches == want, "deepseek launch counts do not match the model")

    # block-sparse prefill through the plan vs dense prefill on the
    # masked weights, at one exact-length prompt
    n = 129
    with torch.inference_mode():
        batch = {"tokens": torch.as_tensor(reqs[5].prompt[None].astype(
            np.int64), device=device)}
        got, _ = tfm.prefill(params, cfg, batch, n, plan=eng.plan)
        want_l, _ = tfm.prefill(params, cfg, batch, n)
    diff = (got.float() - want_l.float()).abs().max().item()
    scale = want_l.float().abs().max().item()
    tol = 5e-2 * scale
    same_argmax = bool((got.argmax(-1) == want_l.argmax(-1)).all().item())
    print(f"check deepseek plan prefill vs dense masked prefill ({cfg.dtype},"
          f" {cfg.n_layers} layers, exact length {n}): max_abs_err={diff:.4e} "
          f"max|logit|={scale:.4e} tol={tol:.4e} same_argmax={same_argmax}")
    require(bool(torch.isfinite(got).all().item()), "plan prefill non-finite")
    require(diff <= tol, "deepseek plan prefill disagrees with dense prefill")

    step_ms.sort()
    peak = torch.cuda.max_memory_allocated() if on_card else None
    profile = profile_decode(eng, cfg, device) if on_card else None
    summary = {
        "config": cfg.name, "n_layers": cfg.n_layers, "parameters": n_params,
        "setup_s": setup_s, "serve_s": serve_s,
        "decode_only_steps": len(step_ms),
        "decode_step_ms_p50": step_ms[len(step_ms) // 2] if step_ms else None,
        "decode_step_ms_min": step_ms[0] if step_ms else None,
        "tokens_per_s": rep.tokens_per_s,
        "ttft_p50_s": rep.ttft_p50, "ttft_p95_s": rep.ttft_p95,
        "max_memory_allocated_bytes": peak,
        "skipped_tile_fraction": rep.skipped_tile_fraction,
        "launches": launches, "launches_want": want,
        "prefill_plan_vs_dense_max_abs_err": diff,
        "prefill_plan_vs_dense_tol": tol,
        "decode_profile": profile,
        "report": rep.__dict__,
    }
    print("deepseek serve: " + json.dumps(
        {k: summary[k] for k in ("decode_step_ms_p50", "decode_step_ms_min",
                                 "tokens_per_s", "ttft_p50_s", "ttft_p95_s",
                                 "max_memory_allocated_bytes",
                                 "skipped_tile_fraction")}))
    return launches, summary


def profile_decode(eng, cfg, device) -> dict:
    """One decode-only tick with 8 busy slots under ``torch.profiler``:
    8 more requests are prefilled first, then the next tick is profiled
    (``profile_call``); the engine then runs to the end."""
    from repro_torch.serve import Request

    prng = np.random.default_rng(9)
    for i in range(8):
        eng.submit(Request(uid=200 + i, prompt=prng.integers(
            1, cfg.vocab_size, size=64).astype(np.int32), max_new_tokens=4))
    eng.step()                      # prefills all 8 and decodes once
    eng.step()                      # warm decode-only tick
    sync(device)

    def tick():
        eng.step()
        sync(device)

    out = profile_call(tick)
    eng.run()
    print("deepseek decode profile: " + json.dumps(
        {k: v for k, v in out.items() if k != "top_kernels"}))
    return out


def deepseek_config():
    """deepseek-v3-671b as registered, with its one cut: 61 layers -> 4
    (three dense, one MoE: every block signature once)."""
    import dataclasses

    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch("deepseek-v3-671b"), n_layers=4)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs the port "
              "on an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.kernels import bsmm as B
    from repro_torch.kernels import paged_attention as PA

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    OUT.mkdir(exist_ok=True)

    t0 = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    (OUT / "chip_smoke_build.log").write_text(
        "\n".join(f"== {k}\n{v}" for k, v in logs.items()))
    print(f"build: {build_s:.1f} s ({', '.join(logs) or 'cached'})")

    cfg = get_arch("llama3.2-3b")
    with torch.inference_mode():
        bsmm_err, bsmm_times = check_bsmm(B)
        paged_err, paged_row = check_paged(PA)
        grad_err, grad_times = check_bsmm_grads(B)
        # deepseek-v3's absorbed MLA: one latent head of r + dr = 576
        # lanes under 128 query heads, values its first 512, scale
        # 1/sqrt(qk_nope + qk_rope)
        mla_err, mla_row = check_paged(PA, Hq=128, Hkv=1, hd=576, dv=512,
                                       scale=192 ** -0.5, seed=11)
        batched_err, batched_times = check_bsmm_batched(B)
        # the dense FFN's gate and the shared expert's run the epilogue
        # with silu and no bias
        ds_err, _ = check_bsmm(B, DEEPSEEK_BSMM_SHAPES, DEEPSEEK_BSMM_ROWS,
                               ((None, "silu"),), timed=False, seed=5)
        bsmm_err = {k: max(v, ds_err[k]) for k, v in bsmm_err.items()}
    torch.cuda.empty_cache()
    launches, summary = serve(cfg, "cuda")
    grad_summary = grad_check(cfg, "cuda")
    t_launches, train_summary = retrain(cfg, "cuda")
    # the llama models are gone (each phase's locals); hand their memory
    # back before the ~30 GB deepseek-v3 model is drawn
    gc.collect()
    torch.cuda.empty_cache()
    ds_launches, ds_summary = serve_deepseek(deepseek_config(), "cuda")

    rep_row = next(r for r in bsmm_times if r["M"] == 8 and r["N"] == 8192)
    grad_row = next(r for r in grad_times if r["N"] == 8192)
    # the expert up/gate shape at decode rows
    batched_row = next(r for r in batched_times
                       if r["M"] == 8 and r["N"] == 2048)
    kernels = [
        {"name": "bsmm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/bsmm.cu",
         "replaces": "src/repro/kernels/bsmm.py:118",
         "launches": launches["bsmm"], "max_abs_err": bsmm_err["bsmm"],
         "ms": rep_row["bsmm_ms"], "plain_ms": rep_row["plain_ms"],
         "bound_ms": rep_row["bound_ms"], "bound_by": rep_row["bound_by"],
         "library_ms": rep_row["matmul_ms"]},
        {"name": "bsmm_epilogue", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/bsmm.cu",
         "replaces": "src/repro/kernels/bsmm.py:136",
         "launches": launches["bsmm_epilogue"],
         "max_abs_err": bsmm_err["bsmm_epilogue"],
         "ms": rep_row["bsmm_epilogue_ms"],
         "plain_ms": rep_row["epilogue_plain_ms"],
         "bound_ms": rep_row["bound_ms"], "bound_by": rep_row["bound_by"],
         "library_ms": None},
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:171",
         "launches": launches["paged_attention"], "max_abs_err": paged_err,
         "ms": paged_row["ms"], "plain_ms": paged_row["plain_ms"],
         "bound_ms": paged_row["bound_ms"], "bound_by": paged_row["bound_by"],
         "library_ms": paged_row["library_ms"]},
    ]
    for kind, line in (("dx", 322), ("dw", 399)):
        kernels.append(
            {"name": f"bsmm_{kind}", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/bsmm.cu",
             "replaces": f"src/repro/kernels/bsmm.py:{line}",
             "launches": t_launches[f"bsmm_{kind}"],
             "max_abs_err": grad_err[f"bsmm_{kind}"],
             "ms": grad_row[f"{kind}_ms"],
             "plain_ms": grad_row[f"{kind}_plain_ms"],
             "bound_ms": grad_row[f"{kind}_bound_ms"],
             "bound_by": grad_row[f"{kind}_bound_by"],
             "library_ms": grad_row[f"{kind}_library_ms"]})
    kernels += [
        {"name": "bsmm_batched", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/bsmm.cu",
         "replaces": "src/repro/kernels/bsmm.py:118",
         "launches": ds_launches["bsmm_batched"], "max_abs_err": batched_err,
         "ms": batched_row["ms"], "plain_ms": batched_row["plain_ms"],
         "bound_ms": batched_row["bound_ms"],
         "bound_by": batched_row["bound_by"],
         "library_ms": batched_row["library_ms"]},
        {"name": "paged_attention_fused_v", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:133",
         "launches": ds_launches["paged_attention_fused_v"],
         "max_abs_err": mla_err, "ms": mla_row["ms"],
         "plain_ms": mla_row["plain_ms"], "bound_ms": mla_row["bound_ms"],
         "bound_by": mla_row["bound_by"],
         "library_ms": mla_row["library_ms"]},
    ]
    (OUT / "chip_smoke_kernels.json").write_text(json.dumps(
        {"device": smi, "bsmm": bsmm_times, "paged_attention": paged_row,
         "bsmm_grads": grad_times, "paged_attention_fused_v": mla_row,
         "bsmm_batched": batched_times, "serve": summary,
         "grad_check": grad_summary, "retrain": train_summary,
         "serve_deepseek": ds_summary},
        indent=1, default=str))
    print(json.dumps({"serve": summary}, default=str))
    print(json.dumps({"grad_check": grad_summary}))
    print(json.dumps({"retrain": train_summary}, default=str))
    print(json.dumps({"serve_deepseek": {k: v for k, v in ds_summary.items()
                                         if k != "report"}}, default=str))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
