"""The port's kernel modules against the reference's.

``repro_torch.kernels.bsmm`` (with ``masked_matmul``), ``.tile_stats``
and ``.paged_attention`` on CPU tensors run their plain PyTorch versions; the reference runs its Pallas kernels in
interpret mode.  Both get the same numpy inputs; float32 parity is held
at rtol = atol = 1e-5.  Tests marked ``cuda`` hold each CUDA kernel
against its plain version on the card and skip where there is none.
"""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import PruneConfig as RPruneConfig
from repro.kernels import bsmm as rb
from repro.kernels import flash_attention as rfa
from repro.kernels import ops as rops
from repro.kernels import paged_attention as rpa
from repro.kernels import ref as rref
from repro.kernels import tile_stats as rts
from repro.models import attention as rattn
from repro_torch import _bridge
from repro_torch.configs import PruneConfig
from repro_torch.kernels import bsmm as tb
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import ref as tref
from repro_torch.kernels import tile_stats as tts

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _tile_mask(rng, K, N, density, dead_col=True):
    bm = rng.random((K // 128, N // 128)) < density
    if dead_col:
        bm[:, 0] = False
    return np.kron(bm, np.ones((128, 128), np.float32))


def _operands(seed, M, K, N, density=0.4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    b = rng.standard_normal((N,)).astype(np.float32)
    return x, w, b, _tile_mask(rng, K, N, density)


# ---------------------------------------------------------------------------
# TilePlan builders (numpy copies of the reference's)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,K,N,density", [(0, 256, 384, 0.5),
                                              (1, 512, 128, 0.2),
                                              (2, 128, 512, 0.0),
                                              (3, 384, 256, 1.0)])
def test_tile_plan_matches_reference(seed, K, N, density):
    mask = _tile_mask(np.random.default_rng(seed), K, N, density,
                      dead_col=False)
    want = rb.make_tile_plan(mask)
    got = tb.make_tile_plan(mask)
    for f in ("idx", "counts", "idx_t", "counts_t", "kk", "nn"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    for f in ("kmax", "nmax", "tile", "live_tiles", "total_tiles"):
        assert getattr(got, f) == getattr(want, f)


def test_tile_plan_geometry():
    assert tb.make_tile_plan(np.ones((100, 128))) is None
    with pytest.raises(tb.GeometryError, match="does not tile"):
        tb.make_tile_plan(np.ones((100, 128)), strict=True, where="t.wq")
    with pytest.raises(tb.GeometryError, match="positive"):
        tb.make_tile_plan(np.ones((128, 128)), tile=0)


# ---------------------------------------------------------------------------
# bsmm (kernels #1 and #2) — plain versions against the Pallas kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("M,K,N", [(8, 256, 384), (5, 384, 256),
                                   (130, 256, 256), (1, 128, 128)])
def test_bsmm_matches_reference(M, K, N):
    x, w, _, mask = _operands(M + K, M, K, N)
    want = rb.plan_matmul(jnp.asarray(x), jnp.asarray(w),
                          rb.make_tile_plan(mask))
    got = tb.plan_matmul(torch.from_numpy(x), torch.from_numpy(w),
                         tb.make_tile_plan(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("act,with_bias", [
    ("relu", True), ("gelu", True), ("silu", True), (None, True),
    ("relu", False), ("gelu", False), ("silu", False)])
def test_bsmm_epilogue_matches_reference(act, with_bias):
    x, w, b, mask = _operands(7, 24, 256, 384)
    bias_r = jnp.asarray(b) if with_bias else None
    bias_t = torch.from_numpy(b) if with_bias else None
    want = rb.plan_matmul(jnp.asarray(x), jnp.asarray(w),
                          rb.make_tile_plan(mask), bias=bias_r, act=act)
    got = tb.plan_matmul(torch.from_numpy(x), torch.from_numpy(w),
                         tb.make_tile_plan(mask), bias=bias_t, act=act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bsmm_dead_column_is_act_of_bias():
    """counts[j] == 0: the column tile is act(bias) (0 without bias)."""
    x, w, b, mask = _operands(3, 8, 256, 256)
    plan = tb.make_tile_plan(mask)
    assert plan.counts[0] == 0
    xt, wt, bt = map(torch.from_numpy, (x, w, b))
    assert torch.all(tb.bsmm(xt, wt, plan)[:, :128] == 0)
    out = tb.bsmm_epilogue(xt, wt, plan, bt, "silu")
    expect = torch.nn.functional.silu(bt[:128]).expand(8, 128)
    torch.testing.assert_close(out[:, :128], expect, **TOL)


def test_plan_matmul_dense_path_matches_reference():
    x, w, b, _ = _operands(4, 6, 128, 256)
    want = rb.plan_matmul(jnp.asarray(x), jnp.asarray(w), None,
                          bias=jnp.asarray(b), act="gelu")
    got = tb.plan_matmul(torch.from_numpy(x), torch.from_numpy(w), None,
                         bias=torch.from_numpy(b), act="gelu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_plan_matmul_rejects_stale_plan():
    x, w, _, mask = _operands(5, 8, 256, 256)
    stale = tb.make_tile_plan(mask[:, :128])
    with pytest.raises(tb.GeometryError, match="plan_matmul"):
        tb.plan_matmul(torch.from_numpy(x), torch.from_numpy(w), stale)
    with pytest.raises(ValueError, match="unsupported epilogue act"):
        tb.plan_matmul(torch.from_numpy(x), torch.from_numpy(w),
                       tb.make_tile_plan(mask), act="tanh")


def test_cpu_calls_run_the_plain_version_and_count_nothing():
    x, w, b, mask = _operands(6, 8, 128, 128)
    plan = tb.make_tile_plan(mask)
    before = (tb.bsmm.launches, tb.bsmm_epilogue.launches)
    tb.bsmm(torch.from_numpy(x), torch.from_numpy(w), plan)
    tb.bsmm_epilogue(torch.from_numpy(x), torch.from_numpy(w), plan,
                     torch.from_numpy(b), "relu")
    assert (tb.bsmm.launches, tb.bsmm_epilogue.launches) == before


# ---------------------------------------------------------------------------
# the 2-D forward's routes and splits (kernels #1, #2) and dw's (#4):
# rules on the host, and a plain emulation of the split-order sum held
# to the Pallas kernels
# ---------------------------------------------------------------------------
_LLAMA_SHAPES = [(3072, 3072), (3072, 1024), (3072, 8192), (8192, 3072)]


def _llama_plan(K, N, seed=1):
    """A seeded ~25 %-live tile plan with column tile 0 dead, as
    chip_smoke.random_bitmap makes them."""
    bm = np.random.default_rng(seed + K + N).random((K // 128, N // 128)) \
        < 0.25
    bm[:, 0] = False
    return tb.make_tile_plan(np.kron(bm, np.ones((128, 128), bool)))


def _working_blocks(plan, route, M, S):
    per_col, rows = tb._route_blocks(route, M)
    return per_col * rows * sum(len(tb.split_pieces(int(c), S))
                                for c in plan.counts if c > 0)


@pytest.mark.parametrize("K,N", _LLAMA_SHAPES)
@pytest.mark.parametrize("M", [1, 8, 63, 64, 300, 512, 1024])
def test_bsmm_route_by_rows_and_dtype(K, N, M):
    """Below 64 rows both dtypes stream; from 64 rows bfloat16 takes
    wgmma and float32 the CUDA-core kernel; a 2-D call never takes the
    expert-batched kernel."""
    plan = _llama_plan(K, N)
    bf, f32 = (tb.bsmm_route(M, K, N, d, plan)
               for d in (torch.bfloat16, torch.float32))
    if M < 64:
        assert bf == f32 == "stream"
    else:
        assert (bf, f32) == ("wgmma", "fma")
    assert set(tb.bsmm.launches_by_route) == {"stream", "wgmma", "fma"}
    assert set(tb.bsmm_epilogue.launches_by_route) == {"stream", "wgmma",
                                                       "fma"}


@pytest.mark.parametrize("K,N", _LLAMA_SHAPES)
@pytest.mark.parametrize("M", [8, 63, 64, 512, 1024])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bsmm_splits_are_whole_tiles(K, N, M, dtype):
    """Each column's live list is cut into contiguous pieces of whole
    tiles, in order, never more pieces than it has tiles, none empty
    (an empty list is one empty piece); the split count is a function
    of the shape and the plan alone."""
    plan = _llama_plan(K, N)
    S = tb.bsmm_splits(M, K, N, dtype, plan)
    assert S == tb.bsmm_splits(M, K, N, dtype, plan) >= 1
    assert plan.route_and_splits("fwd", M, dtype) == (
        tb.bsmm_route(M, K, N, dtype, plan), S)
    for c in plan.counts:
        pieces = tb.split_pieces(int(c), S)
        assert pieces[0][0] == 0 and pieces[-1][1] == c
        assert all(a[1] == b[0] for a, b in zip(pieces, pieces[1:]))
        assert len(pieces) <= max(int(c), 1)
        assert all(t1 > t0 for t0, t1 in pieces) or c == 0
        sizes = [t1 - t0 for t0, t1 in pieces]
        assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("K,N", _LLAMA_SHAPES)
def test_bsmm_stream_splits_at_decode(K, N):
    """At 8 rows (decode) the stream route takes the most pieces whose
    working blocks all stay resident at once (3 an SM on 132 SMs), each
    piece of the longest list keeping 2 tiles: one round of blocks, at
    least a wave of them where the live counts allow it."""
    plan = _llama_plan(K, N)
    top = int(plan.counts.max())
    S = tb.bsmm_splits(8, K, N, torch.bfloat16, plan)
    got = _working_blocks(plan, "stream", 8, S)
    assert got <= 3 * 132
    assert S == top // 2 or _working_blocks(plan, "stream", 8, S + 1) > 396
    assert got >= 132 or S == top // 2


@pytest.mark.parametrize("K,N", _LLAMA_SHAPES)
@pytest.mark.parametrize("M", [64, 128, 300, 512, 1024])
def test_bsmm_tile_route_splits(K, N, M):
    """From 64 rows: at most 4 pieces, each piece of the longest list
    keeping 2 tiles; on wgmma the most whose grid stays within 96 blocks
    (one an SM, with room for the clusters to pack); on fma the most
    within four blocks an SM."""
    plan = _llama_plan(K, N)
    top = int(plan.counts.max())
    for dtype, route, per in ((torch.bfloat16, "wgmma", 96),
                              (torch.float32, "fma", 4 * 132)):
        S = tb.bsmm_splits(M, K, N, dtype, plan)
        grid = (N // 128) * tb._route_blocks(route, M)[1]
        assert S == max(1, min(4, top // 2, per // grid))
        assert S == 1 or min(t1 - t0 for t0, t1 in
                             tb.split_pieces(top, S)) >= 2


def test_bsmm_splits_at_the_llama_shapes():
    """The llama shapes' bf16 split counts: q/o, k/v and down in 4 at
    decode and at prefill's first buckets (64, 128 rows), k/v (9 live
    tiles at most) also at 300 and 512; the up projection's 252 working
    blocks and every shape at 1024 rows uncut."""
    want = {(3072, 3072): {8: 4, 64: 4, 128: 4, 300: 1, 512: 1, 1024: 1},
            (3072, 1024): {8: 4, 64: 4, 128: 4, 300: 4, 512: 3, 1024: 1},
            (3072, 8192): {8: 1, 64: 1, 128: 1, 300: 1, 512: 1, 1024: 1},
            (8192, 3072): {8: 4, 64: 4, 128: 4, 300: 1, 512: 1, 1024: 1}}
    for (K, N), by_rows in want.items():
        plan = _llama_plan(K, N)
        assert {M: tb.bsmm_splits(M, K, N, torch.bfloat16, plan)
                for M in by_rows} == by_rows


def test_bsmm_dw_split_rule():
    """dw cuts each live tile's rows while its grid stays within one
    block an SM, at most 4 pieces of at least 16 row steps (64 rows
    bfloat16, 32 float32): L = 41 splits from 2048 rows (not at the
    retrain's 1024, where the pieces measured slower), L = 148 and
    L >= 264 never."""
    assert tb.bsmm_dw_splits(41, 1024, torch.bfloat16) == 1
    assert tb.bsmm_dw_splits(41, 2048, torch.bfloat16) == 2
    assert tb.bsmm_dw_splits(41, 4096, torch.bfloat16) == 3
    assert tb.bsmm_dw_splits(30, 4096, torch.bfloat16) == 4
    assert tb.bsmm_dw_splits(41, 1024, torch.float32) == 2
    for L in (148, 264, 384):
        assert tb.bsmm_dw_splits(L, 1 << 16, torch.bfloat16) == 1
    assert tb.bsmm_dw_route(torch.bfloat16) == "wgmma"
    assert tb.bsmm_dw_route(torch.float32) == "fma"
    assert set(tb.bsmm_dw.launches_by_route) == {"wgmma", "fma"}


@pytest.mark.parametrize("M", [1, 8, 63, 64, 300, 1024])
def test_bsmm_dx_route_by_rows_and_dtype(M):
    """dx takes wgmma for bfloat16 from 64 rows and the CUDA-core
    transposed walk otherwise; the plan caches what the rules say."""
    plan = _llama_plan(3072, 8192)
    bf, f32 = (tb.bsmm_dx_route(M, d) for d in (torch.bfloat16,
                                                 torch.float32))
    assert (bf, f32) == ("wgmma" if M >= 64 else "simt", "simt")
    for d in (torch.bfloat16, torch.float32):
        assert plan.route_and_splits("dx", M, d) == (
            tb.bsmm_dx_route(M, d),
            tb.bsmm_dx_splits(M, 3072, 8192, d, plan))
    assert set(tb.bsmm_dx.launches_by_route) == {"wgmma", "simt"}


@pytest.mark.parametrize("K,N", _LLAMA_SHAPES)
@pytest.mark.parametrize("M", [8, 64, 128, 300, 1024])
def test_bsmm_dx_splits_are_whole_tiles(K, N, M):
    """dx cuts each K-row tile's live N list (counts_t) into contiguous
    whole-tile pieces under the forward's wgmma rule: at most 4, each
    piece of the longest list keeping 2 tiles, the grid within 96
    blocks; never on simt."""
    plan = _llama_plan(K, N)
    top = int(plan.counts_t.max())
    S = tb.bsmm_dx_splits(M, K, N, torch.bfloat16, plan)
    grid = (K // 128) * -(-M // 128)
    assert S == (max(1, min(4, top // 2, 96 // grid)) if M >= 64 else 1)
    assert tb.bsmm_dx_splits(M, K, N, torch.float32, plan) == 1
    for c in plan.counts_t:
        pieces = tb.split_pieces(int(c), S)
        assert pieces[0][0] == 0 and pieces[-1][1] == c
        assert all(a[1] == b[0] for a, b in zip(pieces, pieces[1:]))
        assert all(t1 > t0 for t0, t1 in pieces) or c == 0
    assert S == 1 or min(t1 - t0 for t0, t1 in
                         tb.split_pieces(top, S)) >= 2


def test_bsmm_dx_splits_at_the_llama_shapes():
    """At the retrain's 1024 rows every llama shape's dx grid holds
    192-512 blocks, so its lists are uncut."""
    for K, N in _LLAMA_SHAPES:
        plan = _llama_plan(K, N)
        assert 192 <= (K // 128) * 8 <= 512
        assert plan.route_and_splits("dx", 1024, torch.bfloat16) == (
            "wgmma", 1)


def _split_fwd_plain(x, w, plan, S, bias=None, act=None):
    """The split forward as the kernels compute it, in numpy f32: each
    column tile's live list cut by ``split_pieces``, each piece's
    product summed over its tiles, the pieces added in split order, then
    bias and activation."""
    M = x.shape[0]
    T = plan.tile
    out = np.zeros((M, w.shape[1]), np.float32)
    for j, c in enumerate(plan.counts):
        total = None
        for t0, t1 in tb.split_pieces(int(c), S):
            part = np.zeros((M, T), np.float32)
            for kt in plan.idx[j, t0:t1]:
                part += x[:, kt * T:(kt + 1) * T] @ w[kt * T:(kt + 1) * T,
                                                      j * T:(j + 1) * T]
            total = part if total is None else total + part
        out[:, j * T:(j + 1) * T] = total
    if bias is not None:
        out = out + bias
    return tb._epilogue(torch.from_numpy(out), act).numpy()


def _split_dw_plain(x, g, plan, S, step):
    """dw as the kernels compute it: each live tile's rows cut into
    pieces of whole ``step``-row steps, the pieces added in order."""
    M = x.shape[0]
    T = plan.tile
    dw = np.zeros((x.shape[1], g.shape[1]), np.float32)
    for k, n in zip(plan.kk, plan.nn):
        total = None
        for s0, s1 in tb.split_pieces(-(-M // step), S):
            r0, r1 = s0 * step, min(s1 * step, M)
            part = x[r0:r1, k * T:(k + 1) * T].T @ g[r0:r1, n * T:(n + 1) * T]
            total = part if total is None else total + part
        dw[k * T:(k + 1) * T, n * T:(n + 1) * T] = total
    return dw


def _split_dx_plain(g, w, plan, S):
    """dx as the wgmma kernel computes it, in numpy f32: each K-row
    tile's live N list idx_t[k, :counts_t[k]] cut by ``split_pieces``,
    each piece's product g[:, n] @ w[k, n]^T summed over its tiles, the
    pieces added in split order; an empty list gives zeros."""
    M = g.shape[0]
    T = plan.tile
    out = np.zeros((M, w.shape[0]), np.float32)
    for k, c in enumerate(plan.counts_t):
        total = np.zeros((M, T), np.float32)
        for z, (t0, t1) in enumerate(tb.split_pieces(int(c), S)):
            part = np.zeros((M, T), np.float32)
            for nt in plan.idx_t[k, t0:t1]:
                part += g[:, nt * T:(nt + 1) * T] @ \
                    w[k * T:(k + 1) * T, nt * T:(nt + 1) * T].T
            total = part if z == 0 else total + part
        out[:, k * T:(k + 1) * T] = total
    return out


def _pallas_fwd(x, w, mask, bias=None, act=None, bm=16):
    """The reference's Pallas forward in interpret mode, rows padded to
    its block."""
    M = x.shape[0]
    xp = np.pad(x, ((0, -M % bm), (0, 0)))
    rplan = rb.make_tile_plan(mask)
    out = rb._bsmm_compact(jnp.asarray(xp), jnp.asarray(w), rplan.idx,
                           rplan.counts, rplan.kmax, bm=bm, bk=128, bn=128,
                           interpret=True,
                           bias=None if bias is None else jnp.asarray(bias),
                           act=act)
    return np.asarray(out)[:M]


@pytest.mark.parametrize("M", [13, 70])
@pytest.mark.parametrize("S", [1, 2, 3])
@pytest.mark.parametrize("act,with_bias", [(None, False), ("silu", True),
                                           ("gelu", True), ("relu", False)])
def test_bsmm_split_sum_matches_reference(M, S, act, with_bias):
    """The split-order sum (kept here, not in the package) against the
    Pallas forward and its fused epilogue, ragged rows, column tile 0
    dead: float32 at 1e-5."""
    x, w, b, mask = _operands(M + S, M, 640, 384, density=0.6)
    plan = tb.make_tile_plan(mask)
    assert plan.counts[0] == 0 and plan.kmax >= 3
    bias = b if with_bias else None
    got = _split_fwd_plain(x, w, plan, S, bias, act)
    if act is None and bias is None:
        want = _pallas_fwd(x, w, mask)
    else:
        want = _pallas_fwd(x, w, mask, bias, act)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("M", [13, 70])
@pytest.mark.parametrize("S", [1, 2, 3])
def test_bsmm_dx_split_sum_matches_reference(M, S):
    """dx's split-order sum over the transposed plan against the plain
    version and the reference's Pallas dx kernel (ragged rows padded
    with zeros), float32 at 1e-5; an all-dead K-row tile gives zeros."""
    x, w, _, mask = _operands(M + S, M, 640, 512, density=0.8)
    mask[:128] = 0                    # K-row tile 0 all dead
    g = np.random.default_rng(M * S).standard_normal((M, 512)).astype(
        np.float32)
    plan = tb.make_tile_plan(mask)
    assert plan.counts_t[0] == 0 and plan.nmax >= 3
    got = _split_dx_plain(g, w, plan, S)
    plain = tb.bsmm_dx_plain(torch.from_numpy(g), torch.from_numpy(w), plan)
    np.testing.assert_allclose(got, plain.numpy(), **TOL)
    pad = ((0, -M % 16), (0, 0))
    want = rb._bsmm_dx(jnp.asarray(np.pad(g, pad)), jnp.asarray(w),
                       rb.make_tile_plan(mask), bm=16)
    np.testing.assert_allclose(got, np.asarray(want)[:M], **TOL)
    assert not got[:, :128].any()


@pytest.mark.parametrize("act", ["silu", "gelu", "relu", None])
def test_bsmm_split_dead_column_is_act_of_bias(act):
    """Under splits an all-dead column tile is one empty piece: its
    output is act(bias) exactly, and 0 without a bias."""
    x, w, b, mask = _operands(9, 8, 512, 384, density=0.7)
    plan = tb.make_tile_plan(mask)
    assert plan.counts[0] == 0
    got = _split_fwd_plain(x, w, plan, 3, b, act)
    want = tb._epilogue(torch.from_numpy(b[:128]), act).numpy()
    np.testing.assert_array_equal(got[:, :128], np.broadcast_to(want,
                                                                (8, 128)))
    assert not _split_fwd_plain(x, w, plan, 3)[:, :128].any()


@pytest.mark.parametrize("M", [13, 200])
@pytest.mark.parametrize("S,step", [(1, 64), (2, 64), (4, 32), (3, 32)])
def test_bsmm_dw_split_sum_matches_reference(M, S, step):
    """dw's split-order sum over row pieces against the Pallas dw kernel
    (ragged rows padded with zeros), float32 at 1e-5; dead tiles zero."""
    x, w, _, mask = _operands(M + 2, M, 384, 256, density=0.5)
    g = np.random.default_rng(M).standard_normal((M, 256)).astype(
        np.float32)
    plan = tb.make_tile_plan(mask)
    got = _split_dw_plain(x, g, plan, S, step)
    pad = ((0, -M % 16), (0, 0))
    want = rb._bsmm_dw(jnp.asarray(np.pad(x, pad)),
                       jnp.asarray(np.pad(g, pad)), rb.make_tile_plan(mask),
                       bm=16, out_dtype=jnp.float32)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    dead = np.kron(tb.tile_bitmap(mask) == 0, np.ones((128, 128), bool))
    assert not got[dead].any()


def test_bsmm_routes_count_nothing_on_the_cpu():
    x, w, b, mask = _operands(8, 70, 256, 256)
    plan = tb.make_tile_plan(mask)
    g = np.random.default_rng(0).standard_normal((70, 256)).astype(
        np.float32)
    counters = (tb.bsmm, tb.bsmm_epilogue, tb.bsmm_dx, tb.bsmm_dw)
    before = [(dict(f.launches_by_route), f.split_launches)
              for f in counters]
    fused = dict(tpa.paged_attention.fused_launches_by_route)
    q, kp, _, tables, lengths = _pool_setup(4, 2, 64, 1, 64, NB=2, P=6)
    for dtype in (torch.float32, torch.bfloat16):
        xt, wt, bt, gt = (torch.from_numpy(a).to(dtype) for a in (x, w, b, g))
        tb.bsmm(xt[:8].contiguous(), wt, plan)
        tb.bsmm(xt, wt, plan)
        tb.bsmm_epilogue(xt, wt, plan, bt, "silu")
        tb.bsmm_dx(gt, wt, plan)
        tb.bsmm_dw(xt, gt, plan)
        tpa.paged_attention(torch.from_numpy(q).to(dtype),
                            torch.from_numpy(kp).to(dtype), None,
                            *map(torch.from_numpy, (tables, lengths)),
                            scale=0.125, v_dim=64)
    assert [(dict(f.launches_by_route), f.split_launches)
            for f in counters] == before
    assert tpa.paged_attention.fused_launches_by_route == fused
    assert set(fused) == {"wgmma", "simt"}
    assert not tb._SCRATCH


# ---------------------------------------------------------------------------
# tile stats (kernel #9): liveness exact, sums at rtol 1e-5, at two
# geometries (one ragged), float32 and bfloat16
# ---------------------------------------------------------------------------
_TS_CASES = [(0, 256, 384, 128, 128), (1, 300, 200, 64, 256)]


def _stats_weight(seed, K, N, bk, bn):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((K, N)).astype(np.float32)
    w[:bk, :bn] = 0.0                   # one dead tile
    w[bk:2 * bk, -1] = 0.0
    return w


@pytest.mark.parametrize("seed,K,N,bk,bn", _TS_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tile_stats_matches_reference(seed, K, N, bk, bn, dtype):
    w = _stats_weight(seed, K, N, bk, bn)
    wj = jnp.asarray(w, dtype)
    wt = torch.from_numpy(w).to(getattr(torch, dtype))
    want = rops.tile_stats(wj, bk=bk, bn=bn, interpret=True)
    got = tops.tile_stats(wt, bk=bk, bn=bn)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.float32
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-5, atol=0)
    assert got[0][0, 0] == 0
    # the PruneConfig geometry path, and the boolean oracle
    cfg_got = tts.tile_stats_for_config(wt, PruneConfig(xbar_rows=bk,
                                                        xbar_cols=bn))
    cfg_want = rts.tile_stats_for_config(wj, RPruneConfig(xbar_rows=bk,
                                                          xbar_cols=bn))
    np.testing.assert_array_equal(cfg_got[0].numpy(), np.asarray(cfg_want[0]))
    np.testing.assert_allclose(cfg_got[1].numpy(), np.asarray(cfg_want[1]),
                               rtol=1e-5, atol=0)
    r_live, r_sums = rref.tile_stats_ref(wj, bk, bn)
    t_live, t_sums = tref.tile_stats_ref(wt, bk, bn)
    assert t_live.dtype == torch.bool
    np.testing.assert_array_equal(t_live.numpy(), np.asarray(r_live))
    np.testing.assert_allclose(t_sums.numpy(), np.asarray(r_sums), rtol=1e-5)


def test_tile_stats_rejects_bad_operands():
    with pytest.raises(ValueError, match="2-D"):
        tts.tile_stats(torch.zeros(2, 3, 4))
    with pytest.raises(ValueError, match="positive"):
        tts.tile_stats(torch.zeros(4, 4), bk=0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tts.tile_stats(torch.zeros(4, 4, dtype=torch.float64))


# ---------------------------------------------------------------------------
# masked matmul (kernel #5): the crossbar-unaware LTP baseline
# ---------------------------------------------------------------------------
def _masked_operands(seed, M, K, N, density=0.1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    mask = (rng.random((K, N)) < density).astype(np.float32)
    mask[:128, 128:256] = 0.0           # an all-dead tile
    return x, w, mask


@pytest.mark.parametrize("M,bm", [(8, 8), (128, 128), (256, 128)])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 1e-2)])
def test_masked_matmul_matches_reference(M, bm, dtype, tol):
    x, w, mask = _masked_operands(M, M, 256, 384)
    want = rb.masked_matmul_pallas(jnp.asarray(x, dtype), jnp.asarray(w, dtype),
                                   jnp.asarray(mask, dtype), bm=bm,
                                   interpret=True)
    td = getattr(torch, dtype)
    got = tb.masked_matmul(torch.from_numpy(x).to(td),
                           torch.from_numpy(w).to(td),
                           torch.from_numpy(mask).to(td), bm=bm)
    assert got.dtype == td and got.shape == (M, 384)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def test_masked_matmul_skips_all_dead_tiles_only():
    """A dead tile adds nothing even where w holds NaN; a live tile's
    entries are masked elementwise, as in the reference."""
    x, w, mask = _masked_operands(3, 8, 256, 384, density=0.5)
    w[:128, 128:256] = np.nan           # under the all-dead tile
    want = rb.masked_matmul_pallas(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(mask), bm=8, interpret=True)
    got = tb.masked_matmul(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(mask), bm=8)
    assert np.isfinite(np.asarray(want)).all()
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # a bool mask means the same product
    got_b = tb.masked_matmul(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(mask != 0), bm=8)
    torch.testing.assert_close(got_b, got, rtol=0, atol=0)


@pytest.mark.parametrize("M,K,N,bm", [(12, 256, 256, 8), (8, 200, 256, 8),
                                      (8, 256, 300, 8), (100, 128, 128, 128)])
def test_masked_matmul_geometry_errors(M, K, N, bm):
    x, w, mask = (np.zeros((M, K), np.float32), np.zeros((K, N), np.float32),
                  np.zeros((K, N), np.float32))
    with pytest.raises(rb.GeometryError, match="must tile"):
        rb.masked_matmul_pallas(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(mask), bm=bm, interpret=True)
    with pytest.raises(tb.GeometryError, match="must tile"):
        tb.masked_matmul(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(mask), bm=bm)


_SPLIT_SHAPES = [(1, 128, 128), (8, 3072, 8192), (8, 8192, 3072),
                 (40, 3072, 1024), (63, 384, 256), (64, 3072, 3072),
                 (128, 512, 512), (300, 1280, 384), (1024, 3072, 8192)]


@pytest.mark.parametrize("M,K,N", _SPLIT_SHAPES)
def test_masked_splits_are_whole_tiles(M, K, N):
    """Kernel #5's K-splits: whole 128-row tiles, none empty, in order,
    covering [0, K); a function of (M, K, N) alone."""
    splits = tb.masked_splits(M, K, N)
    assert splits == tb.masked_splits(M, K, N)
    assert splits[0][0] == 0 and splits[-1][1] == K
    for (k0, k1), (n0, _) in zip(splits, splits[1:] + ((K, None),)):
        assert k0 % 128 == 0 and k1 % 128 == 0 and k0 < k1 == n0
    per = splits[0][1] - splits[0][0]
    assert all(k1 - k0 == per for k0, k1 in splits[:-1])
    assert splits[-1][1] - splits[-1][0] <= per


@pytest.mark.parametrize("M,K,N", _SPLIT_SHAPES)
def test_masked_route_by_shape_and_dtype(M, K, N):
    """Below 64 rows both dtypes stream split-K; from 64 rows bfloat16
    takes wgmma and float32 the CUDA-core kernel, which splits K where
    its grid would fill less than one wave of 132 SMs."""
    bf, f32 = (tb.masked_route(M, K, N, d)
               for d in (torch.bfloat16, torch.float32))
    if M < 64:
        assert bf == f32 == "stream"
    else:
        assert (bf, f32) == ("wgmma", "fma")
        fma_grid = (N // 128) * -(-M // 64)
        assert (len(tb.masked_splits(M, K, N)) > 1) == (
            fma_grid < 132 and K > 128)


def test_masked_splits_fill_two_waves_at_decode():
    """At M = 8 on 3072 x 8192 the split-K grid covers two waves of the
    H100's 132 SMs (the unsplit grid was 64 blocks), and fits the three
    blocks an SM holds in one round."""
    splits = tb.masked_splits(8, 3072, 8192)
    assert 2 * 132 <= (8192 // 128) * len(splits) <= 3 * 132
    assert len(splits) == 6


def test_masked_cnn_fc_call_takes_splitk():
    """The CNN path's own launch, the 512 x 512 FC weight at M = 128 in
    float32, runs the CUDA-core kernel, which has 8 output blocks
    unsplit: it splits K."""
    assert tb.masked_route(128, 512, 512, torch.float32) == "fma"
    assert len(tb.masked_splits(128, 512, 512)) == 4


def test_masked_routes_count_nothing_on_the_cpu():
    x, w, mask = _masked_operands(6, 8, 256, 128)
    before = dict(tb.masked_matmul.launches_by_route)
    splits = tb.masked_matmul.split_launches
    assert set(before) == {"stream", "wgmma", "fma"}
    for dtype in (torch.float32, torch.bfloat16):
        tb.masked_matmul(torch.from_numpy(x).to(dtype),
                         torch.from_numpy(w).to(dtype),
                         torch.from_numpy(mask), bm=8)
    assert tb.masked_matmul.launches_by_route == before
    assert tb.masked_matmul.split_launches == splits


def test_new_kernels_count_nothing_on_the_cpu():
    x, w, mask = _masked_operands(4, 8, 128, 128)
    before = (tb.masked_matmul.launches, tts.tile_stats.launches)
    tb.masked_matmul(torch.from_numpy(x), torch.from_numpy(w),
                     torch.from_numpy(mask), bm=8)
    tts.tile_stats(torch.from_numpy(w))
    assert (tb.masked_matmul.launches, tts.tile_stats.launches) == before


# ---------------------------------------------------------------------------
# bsmm backward (kernels #3 and #4) — plain versions through bsmm_apply
# against the reference's custom VJP
# ---------------------------------------------------------------------------
_EPILOGUES = [(None, False), (None, True), ("relu", True), ("relu", False),
              ("gelu", True), ("gelu", False), ("silu", True),
              ("silu", False)]
GRAD_TOL = dict(rtol=1e-4, atol=1e-3)      # as tests/test_bsmm_grad.py


def _vjp_both(x, w, b, mask, g, act, with_bias):
    """(out, dx, dw, db) of plan_matmul from both packages for the
    cotangent g."""
    bias_r = jnp.asarray(b) if with_bias else None

    def rfn(x, w, *bias):
        return rb.plan_matmul(x, w, rb.make_tile_plan(mask),
                              bias=bias[0] if bias else None, act=act)

    rargs = (jnp.asarray(x), jnp.asarray(w)) + ((bias_r,) if with_bias
                                                else ())
    rout, vjp = jax.vjp(rfn, *rargs)
    rgrads = vjp(jnp.asarray(g))
    targs = [torch.from_numpy(a).requires_grad_(True)
             for a in ((x, w, b) if with_bias else (x, w))]
    tout = tb.plan_matmul(targs[0], targs[1], tb.make_tile_plan(mask),
                          bias=targs[2] if with_bias else None, act=act)
    tgrads = torch.autograd.grad(tout, targs, torch.from_numpy(g))
    return (np.asarray(rout), [np.asarray(a) for a in rgrads],
            tout.detach().numpy(), [a.numpy() for a in tgrads])


@pytest.mark.parametrize("M", [5, 24, 300])
@pytest.mark.parametrize("act,with_bias", _EPILOGUES)
def test_bsmm_apply_grads_match_reference(M, act, with_bias):
    """Forward, dx, dw and db through ``plan_matmul`` against
    ``jax.vjp`` of the reference's (column tile 0 all dead); dw is
    exactly zero on dead tiles."""
    x, w, b, mask = _operands(M * 3 + 1, M, 256, 384)
    g = np.random.default_rng(M).standard_normal((M, 384)).astype(np.float32)
    rout, rgrads, tout, tgrads = _vjp_both(x, w, b, mask, g, act, with_bias)
    np.testing.assert_allclose(tout, rout, **TOL)
    for name, got, want in zip(("dx", "dw", "db"), tgrads, rgrads):
        np.testing.assert_allclose(got, want, err_msg=name, **GRAD_TOL)
    dead = np.kron(tb.tile_bitmap(mask) == 0, np.ones((128, 128), bool))
    assert dead[:, :128].all() and not np.any(tgrads[1][dead])


def test_bsmm_apply_all_dead_mask():
    x, w, b, _ = _operands(9, 7, 128, 256)
    mask = np.zeros((128, 256), np.float32)
    g = np.ones((7, 256), np.float32)
    rout, rgrads, tout, tgrads = _vjp_both(x, w, b, mask, g, "silu", True)
    np.testing.assert_allclose(tout, rout, **TOL)
    assert not np.any(tgrads[0]) and not np.any(tgrads[1])
    for got, want in zip(tgrads, rgrads):
        np.testing.assert_allclose(got, want, **GRAD_TOL)


def test_plan_matmul_grad_goes_through_bsmm_apply(monkeypatch):
    """On the CPU the planned product is the autograd Function the card
    runs, and its backward calls the plain dx and dw once each (it no
    longer differentiates through the plain forward's ops)."""
    x, w, b, mask = _operands(8, 6, 256, 256)
    plan = tb.make_tile_plan(mask)
    calls = {"dx": 0, "dw": 0}
    dx_plain, dw_plain = tb.bsmm_dx_plain, tb.bsmm_dw_plain

    def count(name, fn):
        def wrapped(*a):
            calls[name] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(tb, "bsmm_dx_plain", count("dx", dx_plain))
    monkeypatch.setattr(tb, "bsmm_dw_plain", count("dw", dw_plain))
    xt = torch.from_numpy(x).reshape(2, 3, 256).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    out = tb.plan_matmul(xt, wt, plan)
    assert type(out.grad_fn)._forward_cls is tb.BsmmApply
    assert out.shape == (2, 3, 256)
    out.sum().backward()
    assert calls == {"dx": 1, "dw": 1}
    assert xt.grad.shape == xt.shape and wt.grad.shape == wt.shape
    bt = torch.from_numpy(b).requires_grad_(True)
    out = tb.plan_matmul(xt, wt, plan, bias=bt, act="gelu")
    assert type(out.grad_fn)._forward_cls is tb.BsmmApply
    out.sum().backward()
    assert calls == {"dx": 2, "dw": 2} and bt.grad is not None
    with torch.inference_mode():          # serving: no graph, nothing saved
        assert tb.plan_matmul(xt, wt, plan).grad_fn is None


def test_bsmm_dx_dw_plain_match_reference():
    """The plain backward versions against the reference's dx and dw
    Pallas kernels, ragged M, column tile 0 dead."""
    x, w, _, mask = _operands(11, 13, 384, 256)
    g = np.random.default_rng(2).standard_normal((13, 256)).astype(
        np.float32)
    rplan = rb.make_tile_plan(mask)
    xp = np.pad(x, ((0, 3), (0, 0)))
    gp = np.pad(g, ((0, 3), (0, 0)))
    want_dx = rb._bsmm_dx(jnp.asarray(gp), jnp.asarray(w), rplan, bm=16)
    want_dw = rb._bsmm_dw(jnp.asarray(xp), jnp.asarray(gp), rplan, bm=16,
                          out_dtype=jnp.float32)
    plan = tb.make_tile_plan(mask)
    got_dx = tb.bsmm_dx(torch.from_numpy(g), torch.from_numpy(w), plan)
    got_dw = tb.bsmm_dw(torch.from_numpy(x), torch.from_numpy(g), plan)
    np.testing.assert_allclose(got_dx.numpy(), np.asarray(want_dx)[:13],
                               **TOL)
    np.testing.assert_allclose(got_dw.numpy(), np.asarray(want_dw), **TOL)


def test_bsmm_grad_wrappers_check_operands():
    x, w, _, mask = _operands(12, 4, 256, 128)
    plan = tb.make_tile_plan(mask)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    g = torch.zeros(4, 128)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tb.bsmm_dx(g.double(), wt.double(), plan)
    with pytest.raises(tb.GeometryError, match="bsmm_dw"):
        tb.bsmm_dw(xt, torch.zeros(4, 256), plan)
    with pytest.raises(tb.GeometryError, match="bsmm_dx"):
        tb.bsmm_dx(torch.zeros(4, 256), wt, plan)
    before = (tb.bsmm_dx.launches, tb.bsmm_dw.launches)
    tb.bsmm_dx(g, wt, plan)
    tb.bsmm_dw(xt, g, plan)
    assert (tb.bsmm_dx.launches, tb.bsmm_dw.launches) == before
    devs = plan.device_tensors("cpu")
    assert devs.kk.tolist() == plan.kk.tolist()
    assert plan.device_tensors("cpu") is devs


@pytest.mark.parametrize("M,K,N", [(8, 256, 128), (5, 256, 128),
                                   (64, 256, 256), (3, 128, 384)])
def test_sparse_dense_grads_match_dense_oracle(M, K, N):
    """Output, dx and dw of ``sparse_dense`` against ``jax.vjp`` of the
    reference's (Pallas in interpret mode) and against the dense masked
    oracle."""
    rng = np.random.RandomState(M * 7 + K + N)
    mask = (rng.rand(K, N) < 0.4).astype(np.float32)
    if N >= 256:
        mask[:, 128:256] = 0.0              # an all-dead tile column
    x = rng.randn(M, K).astype(np.float32)
    w = rng.randn(K, N).astype(np.float32)
    rout, vjp = jax.vjp(lambda x, w: rops.sparse_dense(x, w, mask),
                        jnp.asarray(x), jnp.asarray(w))
    rdx, rdw = vjp(2 * rout)                # the cotangent of Σ out²
    want = tuple(torch.from_numpy(np.array(a)) for a in (rout, rdx, rdw))
    grads = []
    for fn in (lambda x, w: tops.sparse_dense(x, w, mask),
               lambda x, w: tref.masked_matmul_ref(x, w,
                                                   torch.from_numpy(mask))):
        xt = torch.from_numpy(x).requires_grad_(True)
        wt = torch.from_numpy(w).requires_grad_(True)
        out = fn(xt, wt)
        out.square().sum().backward()
        grads.append((out.detach(), xt.grad, wt.grad))
    (o1, dx1, dw1), (o2, dx2, dw2) = grads
    torch.testing.assert_close(o1, want[0], rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(dx1, want[1], rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(dw1, want[2], rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(o1, o2, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(dx1, dx2, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(dw1, dw2, rtol=1e-4, atol=1e-3)


def test_sparse_dense_ragged_k_falls_back_and_tile_density():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 100)).astype(np.float32)
    w = rng.standard_normal((100, 128)).astype(np.float32)
    mask = (rng.random((100, 128)) < 0.5).astype(np.float32)
    want = rops.sparse_dense(jnp.asarray(x), jnp.asarray(w), mask)
    got = tops.sparse_dense(torch.from_numpy(x), torch.from_numpy(w), mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    m2 = _tile_mask(rng, 384, 256, 0.5)
    assert tops.tile_density(m2) == rops.tile_density(m2)


# ---------------------------------------------------------------------------
# paged attention (kernel #6) — plain version against the Pallas kernel
# ---------------------------------------------------------------------------
def _pool_setup(seed, B, Hq, Hkv, hd, NB, P):
    rng = np.random.default_rng(seed)
    T = tpa.BLOCK_TOKENS
    q = rng.standard_normal((B, Hq, hd)).astype(np.float32)
    k_pool = rng.standard_normal((P, T, Hkv, hd)).astype(np.float32)
    v_pool = rng.standard_normal((P, T, Hkv, hd)).astype(np.float32)
    perm = rng.permutation(P - 1)[:B * NB].reshape(B, NB) + 1
    lengths = rng.integers(1, NB * T + 1, size=B).astype(np.int32)
    lengths[0] = 1
    tables = np.zeros((B, NB), np.int32)
    for b in range(B):
        nb = -(-int(lengths[b]) // T)
        tables[b, :nb] = perm[b, :nb]
    return q, k_pool, v_pool, tables, lengths


@pytest.mark.parametrize("seed,B,Hq,Hkv,hd", [(0, 3, 4, 2, 16),
                                              (1, 4, 6, 2, 32),
                                              (2, 2, 3, 3, 8)])
def test_paged_attention_matches_reference(seed, B, Hq, Hkv, hd):
    q, kp, vp, tables, lengths = _pool_setup(seed, B, Hq, Hkv, hd, NB=3, P=14)
    scale = hd ** -0.5
    want = rpa.paged_attention(*map(jnp.asarray, (q, kp, vp, tables,
                                                  lengths)), scale=scale)
    got = tpa.paged_attention(*map(torch.from_numpy, (q, kp, vp, tables,
                                                      lengths)), scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_paged_attention_ignores_dead_pool_contents():
    """NaN in the scratch block, in unused blocks and past the length
    inside the last live block never reaches the output."""
    q, kp, vp, tables, lengths = _pool_setup(3, 2, 4, 2, 16, NB=3, P=8)
    tables[:] = 0
    tables[0, :2] = [1, 2]
    tables[1, :1] = [3]
    lengths[:] = [tpa.BLOCK_TOKENS + 5, 3]
    args = lambda k, v: tuple(map(torch.from_numpy, (q, k, v, tables,  # noqa
                                                     lengths)))
    base = tpa.paged_attention(*args(kp, vp), scale=0.25)
    kp2, vp2 = kp.copy(), vp.copy()
    for p in (0, 4, 5, 6, 7):
        kp2[p] = np.nan
        vp2[p] = np.nan
    kp2[2, 5:] = np.nan
    vp2[3, 3:] = np.nan
    got = tpa.paged_attention(*args(kp2, vp2), scale=0.25)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, base, rtol=0, atol=0)


def test_paged_attention_fused_v_matches_reference():
    """The fused-V (MLA) form's plain version equals the reference's
    Pallas kernel, and NaN in the scratch block never reaches it."""
    q, kp, _, tables, lengths = _pool_setup(4, 2, 2, 1, 16, NB=2, P=6)
    want = rpa.paged_attention(*map(jnp.asarray, (q, kp)), None,
                               *map(jnp.asarray, (tables, lengths)),
                               scale=0.25, v_dim=8)
    kp[0] = np.nan
    got = tpa.paged_attention(*map(torch.from_numpy, (q, kp)), None,
                              *map(torch.from_numpy, (tables, lengths)),
                              scale=0.25, v_dim=8)
    assert got.shape == (2, 2, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _split_plain(q, k_pool, v_pool, tables, lengths, *,
                 scale: float, v_dim=None, p_bf16=False):
    """The CUDA kernels' split and merge in plain PyTorch: per sequence b
    and live logical block j, over the block's live rows only, the
    partial ``m_j = max s``, ``l_j = sum exp(s - m_j)`` and ``acc_j =
    exp(s - m_j) @ v`` in f32; then ``m = max m_j``, ``l = sum l_j
    e^(m_j - m)`` and ``acc = sum acc_j e^(m_j - m)`` added in j order,
    and ``acc / l`` in q's dtype.  Each row is computed alone, from its
    own length and blocks, so its bits do not depend on the batch.  With
    ``p_bf16`` the weights are rounded to bfloat16 for ``acc_j`` (l_j
    sums them unrounded), as the fused form's wgmma kernel does."""
    geo = tpa._check_geometry(q, k_pool, v_pool, tables, lengths, v_dim)
    G, T, dv = geo.Hq // geo.Hkv, geo.T, geo.dv
    out = torch.empty((geo.B, geo.Hq, dv), dtype=q.dtype, device=q.device)
    lens = [int(n) for n in lengths.tolist()]
    rows = tables.tolist()
    for b in range(geo.B):
        qg = q[b].float().reshape(geo.Hkv, G, geo.hd)
        parts = []
        for j in range(-(-lens[b] // T)):
            live = min(T, lens[b] - j * T)
            k = k_pool[rows[b][j], :live].float()            # (live, Hkv, hd)
            v = k[..., :dv] if v_pool is None \
                else v_pool[rows[b][j], :live].float()
            s = torch.einsum("kgd,tkd->kgt", qg, k) * scale
            m = s.amax(-1)
            e = torch.exp(s - m[..., None])
            pe = e.bfloat16().float() if p_bf16 else e
            parts.append((m, e.sum(-1), torch.einsum("kgt,tkd->kgd", pe, v)))
        m = torch.stack([p[0] for p in parts]).amax(0)
        l = torch.zeros_like(m)
        acc = torch.zeros(geo.Hkv, G, dv, dtype=torch.float32,
                          device=q.device)
        for mj, lj, aj in parts:
            c = torch.exp(mj - m)
            l = l + lj * c
            acc = acc + aj * c[..., None]
        out[b] = (acc / l[..., None]).reshape(geo.Hq, dv).to(q.dtype)
    return out


@pytest.mark.parametrize("seed,B,Hq,Hkv,hd,fused", [(0, 3, 4, 2, 16, False),
                                                    (1, 4, 6, 2, 32, False),
                                                    (2, 2, 3, 3, 8, False),
                                                    (4, 3, 4, 1, 16, True)])
def test_paged_split_plain_matches_reference(seed, B, Hq, Hkv, hd, fused):
    """The CUDA kernels' split-KV partials and their merge in block
    order, in plain PyTorch, equal the reference's Pallas kernel."""
    q, kp, vp, tables, lengths = _pool_setup(seed, B, Hq, Hkv, hd, NB=3,
                                             P=14)
    vp, dv = (None, hd // 2) if fused else (vp, None)
    want = rpa.paged_attention(
        *map(jnp.asarray, (q, kp)), None if fused else jnp.asarray(vp),
        *map(jnp.asarray, (tables, lengths)), scale=hd ** -0.5, v_dim=dv)
    got = _split_plain(
        *map(torch.from_numpy, (q, kp)),
        None if fused else torch.from_numpy(vp),
        *map(torch.from_numpy, (tables, lengths)), scale=hd ** -0.5,
        v_dim=dv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fused_bf16_weights_model_matches_reference():
    """The fused form's wgmma kernel rounds each block's softmax weights
    to bfloat16 for P V: that model, in plain PyTorch on float32 inputs,
    stays within the bf16 gate (1e-2 of the output scale) of the
    reference's Pallas kernel, and NaN past each length never reaches
    it."""
    q, kp, _, tables, lengths = _pool_setup(7, 3, 8, 1, 128, NB=3, P=14)
    want = np.asarray(rpa.paged_attention(
        *map(jnp.asarray, (q, kp)), None,
        *map(jnp.asarray, (tables, lengths)), scale=0.09, v_dim=64))
    T = tpa.BLOCK_TOKENS
    for b, n in enumerate(lengths):
        kp[tables[b, (n - 1) // T], n - (n - 1) // T * T:] = np.nan
    got = _split_plain(*map(torch.from_numpy, (q, kp)), None,
                       *map(torch.from_numpy, (tables, lengths)),
                       scale=0.09, v_dim=64, p_bf16=True).numpy()
    tol = 1e-2 * max(1.0, np.abs(want).max())
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= tol
    assert not np.array_equal(got, want)      # the rounding is modelled


def test_fused_route_and_smem_rule():
    """deepseek-v3's absorbed MLA (128 heads over one latent head of 576
    lanes, values its first 512) takes the wgmma kernel in bfloat16:
    q's 64 heads and the block's 128 rows, 24 KB a 64-lane chunk, fit
    the 227 KB a block may take; float32 and geometries it does not
    take stay on the CUDA-core kernel, whose own limits still hold."""
    mla = tpa.PagedGeometry(B=8, Hq=128, hd=576, Hkv=1, T=128, NB=8, P=64,
                            dv=512)
    assert tpa.fused_wgmma_smem_bytes(576) == 9 * (8192 + 16384 + 8) \
        + 1024 + 1024 == 223304 <= tpa._SMEM_LIMIT
    assert tpa.fused_wgmma_smem_bytes(640) > tpa._SMEM_LIMIT
    assert tpa.fused_route(mla, torch.bfloat16) == "wgmma"
    assert tpa.fused_route(mla._replace(Hq=256, Hkv=2), torch.bfloat16) \
        == "wgmma"
    tpa._check_kernel_geometry(mla, 2, fused=True, route="wgmma")
    with pytest.raises(tb.GeometryError, match="shared"):
        tpa._check_kernel_geometry(mla._replace(hd=640), 2, fused=True,
                                   route="wgmma")
    refused = [mla._replace(Hq=96), mla._replace(Hq=16), mla._replace(hd=600),
               mla._replace(hd=640), mla._replace(dv=192),
               mla._replace(dv=640, hd=640), mla._replace(hd=448),
               mla._replace(T=64)]
    for geo in refused:
        assert tpa.fused_route(geo, torch.bfloat16) == "simt", geo
    assert tpa.fused_route(mla, torch.float32) == "simt"
    tpa._check_kernel_geometry(mla, 4, fused=True)


def test_paged_split_plain_is_batch_invariant():
    """A row's split-KV result has the same bits alone as inside a batch
    of other lengths, and dead pool contents never reach it."""
    q, kp, vp, tables, lengths = _pool_setup(5, 5, 6, 2, 16, NB=3, P=16)
    kp[0] = np.nan
    vp[0] = np.nan
    args = [torch.from_numpy(a) for a in (q, kp, vp, tables, lengths)]
    full = _split_plain(*args, scale=0.25)
    assert torch.isfinite(full).all()
    for b in range(5):
        one = _split_plain(
            args[0][b:b + 1], args[1], args[2], args[3][b:b + 1],
            args[4][b:b + 1], scale=0.25)
        assert torch.equal(one[0], full[b])


def test_paged_kernel_geometry_by_form():
    """The GQA kernel stages a pool block's K and V rows in shared
    memory; the fused (MLA) kernel does not, so MLA's widths fit only
    the fused form."""
    mla = tpa.PagedGeometry(B=8, Hq=128, hd=576, Hkv=1, T=128, NB=8, P=64,
                            dv=512)
    tpa._check_kernel_geometry(mla, 2, fused=True)
    with pytest.raises(tb.GeometryError, match="shared"):
        tpa._check_kernel_geometry(mla, 2)
    llama = mla._replace(Hq=24, hd=128, Hkv=8, dv=128)
    tpa._check_kernel_geometry(llama, 2)
    tpa._check_kernel_geometry(llama, 4)
    with pytest.raises(tb.GeometryError, match="multiple of 8"):
        tpa._check_kernel_geometry(llama._replace(dv=4), 2)
    tpa._check_kernel_geometry(llama._replace(dv=4), 2, fused=True)


def test_paged_gather_logical_order():
    pool = torch.arange(8, dtype=torch.float32).reshape(4, 2, 1, 1)
    dense = tpa.paged_gather(pool, torch.tensor([[3, 1]], dtype=torch.int32))
    assert dense.flatten().tolist() == [6., 7., 2., 3.]


def test_paged_geometry_errors():
    q = torch.zeros(2, 3, 8)
    pool = torch.zeros(4, 128, 2, 8)
    with pytest.raises(tpa.GeometryError, match="multiple"):
        tpa.paged_attention(q, pool, pool, torch.zeros(2, 1, dtype=torch.int32),
                            torch.ones(2, dtype=torch.int32), scale=1.0)


# ---------------------------------------------------------------------------
# the operand contract: checked on the CPU as on the card
# ---------------------------------------------------------------------------
def _misaligned(*shape, dtype=torch.float32):
    """A contiguous tensor whose base sits 4 bytes off a 16-byte line."""
    n = int(np.prod(shape))
    buf = torch.zeros(n + 4, dtype=dtype)
    off = next(i for i in range(1, 8) if
               (buf.data_ptr() + i * buf.element_size()) % 16)
    t = buf[off:off + n].view(*shape)
    assert t.is_contiguous() and t.data_ptr() % 16
    return t


def _strided(*shape, dtype=torch.float32):
    """A non-contiguous view of the given shape (a transpose)."""
    t = torch.zeros(*reversed(shape), dtype=dtype).permute(
        *reversed(range(len(shape))))
    assert not t.is_contiguous()
    return t


def _bsmm_case(fault):
    plan = tb.make_tile_plan(np.ones((256, 128), np.float32))
    x, w = torch.zeros(8, 256), torch.zeros(256, 128)
    if fault == "view":
        w = _strided(256, 128)
    elif fault == "dtype":
        x = x.bfloat16()
    else:
        x = _misaligned(8, 256)
    return lambda: tb.bsmm(x, w, plan)


def _epilogue_case(fault):
    plan = tb.make_tile_plan(np.ones((256, 128), np.float32))
    x, w, b = torch.zeros(8, 256), torch.zeros(256, 128), torch.zeros(128)
    if fault == "view":
        x = _strided(8, 256)
    elif fault == "dtype":
        w = w.bfloat16()
    else:
        w = _misaligned(256, 128)
    return lambda: tb.bsmm_epilogue(x, w, plan, b, "relu")


def _batched_case(fault):
    plan = tb.make_tile_plan(np.ones((128, 128), np.float32))
    a, w = torch.zeros(2, 8, 128), torch.zeros(2, 128, 128)
    if fault == "view":
        a = _strided(2, 8, 128)
    elif fault == "dtype":
        a = a.bfloat16()
    else:
        a = _misaligned(2, 8, 128)
    return lambda: tb.bsmm_batched(a, w, plan)


def _dx_case(fault):
    plan = tb.make_tile_plan(np.ones((256, 128), np.float32))
    g, w = torch.zeros(8, 128), torch.zeros(256, 128)
    if fault == "view":
        g = _strided(8, 128)
    elif fault == "dtype":
        g = g.bfloat16()
    else:
        g = _misaligned(8, 128)
    return lambda: tb.bsmm_dx(g, w, plan)


def _dw_case(fault):
    plan = tb.make_tile_plan(np.ones((256, 128), np.float32))
    x, g = torch.zeros(8, 256), torch.zeros(8, 128)
    if fault == "view":
        g = _strided(8, 128)
    elif fault == "dtype":
        x = x.bfloat16()
    else:
        x = _misaligned(8, 256)
    return lambda: tb.bsmm_dw(x, g, plan)


def _batched_dx_case(fault):
    plan = tb.make_tile_plan(np.ones((256, 128), np.float32))
    g, w = torch.zeros(2, 8, 128), torch.zeros(2, 256, 128)
    if fault == "view":
        w = _strided(2, 256, 128)
    elif fault == "dtype":
        g = g.bfloat16()
    else:
        g = _misaligned(2, 8, 128)
    return lambda: tb.bsmm_batched_dx(g, w, plan)


def _batched_dw_case(fault):
    plan = tb.make_tile_plan(np.ones((256, 128), np.float32))
    x, g = torch.zeros(2, 8, 256), torch.zeros(2, 8, 128)
    if fault == "view":
        x = _strided(2, 8, 256)
    elif fault == "dtype":
        g = g.bfloat16()
    else:
        g = _misaligned(2, 8, 128)
    return lambda: tb.bsmm_batched_dw(x, g, plan)


def _masked_case(fault):
    x, w, m = torch.zeros(8, 128), torch.zeros(128, 128), torch.ones(128, 128)
    if fault == "view":
        m = _strided(128, 128)
    elif fault == "dtype":
        w = w.bfloat16()
    else:
        m = _misaligned(128, 128)
    return lambda: tb.masked_matmul(x, w, m, bm=8)


def _paged_case(fault):
    q, kp, vp, tables, lengths = (torch.from_numpy(a) for a in _pool_setup(
        0, 2, 4, 2, 16, NB=2, P=6))
    if fault == "view":
        q = _strided(2, 4, 16)
    elif fault == "dtype":
        vp = vp.bfloat16()
    elif fault == "index_dtype":
        lengths = lengths.long()
    else:
        q = _misaligned(2, 4, 16)
    return lambda: tpa.paged_attention(q, kp, vp, tables, lengths, scale=0.25)


def _tile_stats_case(fault):
    w = _strided(256, 128) if fault == "view" else torch.zeros(
        256, 128, dtype=torch.float64)
    return lambda: tts.tile_stats(w)


def _flash_case(fault):
    q, k, v = (torch.from_numpy(a) for a in _qkv(0, 1, 16, 4, 2, 32))
    if fault == "view":
        k = _strided(1, 16, 2, 32)
    else:
        v = v.bfloat16()
    return lambda: tfa.flash_attention(q, k, v)


_CONTRACT = {"view": (ValueError, "contiguous"),
             "dtype": (TypeError, "float32 or bfloat16|float32, bfloat16"),
             "index_dtype": (TypeError, "int32"),
             "misaligned": (ValueError, "16-byte aligned")}


@pytest.mark.parametrize("case,fault", [
    *((c, f) for c in (_bsmm_case, _epilogue_case, _batched_case, _dx_case,
                       _dw_case, _batched_dx_case, _batched_dw_case,
                       _masked_case, _paged_case)
      for f in ("view", "dtype", "misaligned")),
    (_paged_case, "index_dtype"), (_tile_stats_case, "view"),
    (_tile_stats_case, "dtype"), (_flash_case, "view"),
    (_flash_case, "dtype")], ids=lambda v: getattr(v, "__name__", v))
def test_wrappers_refuse_on_the_cpu_what_the_card_refuses(case, fault):
    """A strided view, mixed dtypes, int64 indices or a misaligned base
    raise on the CPU the error the card route raises, before any plain
    version runs."""
    exc, match = _CONTRACT[fault]
    with pytest.raises(exc, match=match):
        case(fault)()


def test_card_only_geometry_rules():
    """The kernels' own limits, held by named functions the card route
    calls; the plain versions take more (a tile of 64, a T of 100)."""
    bf = torch.bfloat16
    for hd, dv in ((128, 128), (192, 128), (64, 32)):
        q, k, v = (torch.from_numpy(a).to(bf)
                   for a in _qkv(0, 1, 9, 4, 2, hd, dv))
        tfa.wgmma_geometry(q, k, v)
    q, k, v = (torch.from_numpy(a).to(bf) for a in _qkv(0, 1, 9, 1, 1, 20))
    with pytest.raises(tb.GeometryError, match="multiples of 8"):
        tfa.wgmma_geometry(q, k, v)      # row stride Hq * hd = 20
    q, k, v = (torch.from_numpy(a).to(bf) for a in _qkv(0, 1, 9, 2, 1, 64))
    q = _misaligned(*q.shape, dtype=bf)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa.wgmma_geometry(q, k, v)
    tfa.kernel_widths(256, 256)
    tfa.wgmma_geometry(*(torch.zeros(1, 2, 1, 256, dtype=bf)
                         for _ in range(3)))
    with pytest.raises(tb.GeometryError, match="hd <= 256"):
        tfa.kernel_widths(264, 128)
    with pytest.raises(tb.GeometryError, match="dv <= 256"):
        tfa.kernel_widths(256, 264)
    tb.kernel_tile("bsmm", 128)
    tb.kernel_tile("masked_matmul", 128, 128)
    with pytest.raises(tb.GeometryError, match="tiles at 128"):
        tb.kernel_tile("bsmm", 64)
    with pytest.raises(tb.GeometryError, match="tiles at 128"):
        tb.kernel_tile("masked_matmul", 128, 64)
    tb.batched_grid(256)
    with pytest.raises(tb.GeometryError, match="at most 65535"):
        tb.batched_grid(65536)
    ok = tpa.PagedGeometry(B=8, Hq=24, hd=128, Hkv=8, T=128, NB=8, P=64,
                           dv=128)
    tpa._check_kernel_geometry(ok, 2)
    with pytest.raises(tb.GeometryError, match="multiple of 32"):
        tpa._check_kernel_geometry(ok._replace(T=100), 2)
    # the plain versions take what the kernels refuse
    x, w, _, mask = _operands(3, 8, 256, 128)
    plan64 = tb.make_tile_plan(mask, tile=64)
    assert tb.bsmm(torch.from_numpy(x), torch.from_numpy(w), plan64).shape \
        == (8, 128)


def test_flash_routes_count_nothing_on_the_cpu():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 1, 33, 4, 2, 64))
    before = (tfa.flash_attention.launches,
              dict(tfa.flash_attention.launches_by_route))
    for dtype in (torch.float32, torch.bfloat16):
        tfa.flash_attention(q.to(dtype), k.to(dtype), v.to(dtype))
    assert before == (tfa.flash_attention.launches,
                      tfa.flash_attention.launches_by_route)
    assert set(before[1]) == {"wgmma", "simt"}


# ---------------------------------------------------------------------------
# the weight bridge
# ---------------------------------------------------------------------------
def test_params_from_numpy_round_trip():
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "segments": [[{"w": rng.standard_normal((2, 5)).astype(
                np.float32), "n": None}]],
            "i": np.arange(4, dtype=np.int32)}
    t = _bridge.params_from_numpy(tree, device="cpu")
    assert t["segments"][0][0]["n"] is None
    assert t["i"].dtype == torch.int32
    back = _bridge.to_numpy(t)
    np.testing.assert_array_equal(back["a"], tree["a"])
    np.testing.assert_array_equal(back["segments"][0][0]["w"],
                                  tree["segments"][0][0]["w"])
    bf = _bridge.params_from_numpy(tree, device="cpu", dtype=torch.bfloat16)
    assert bf["a"].dtype == torch.bfloat16 and bf["i"].dtype == torch.int32
    again = _bridge.params_from_numpy(_bridge.to_numpy(bf), device="cpu",
                                      dtype=torch.bfloat16)
    assert torch.equal(again["a"], bf["a"])


def test_params_from_numpy_reads_jax_bfloat16():
    a = jnp.asarray(np.linspace(-3, 3, 12).reshape(3, 4), jnp.bfloat16)
    t = _bridge.params_from_numpy({"w": np.asarray(a)}, device="cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(a.astype(jnp.float32)))


def test_path_str_matches_reference():
    """Key paths from torch's pytree print like the reference's JAX ones,
    so mask and checkpoint keys line up across the packages."""
    import jax
    from torch.utils import _pytree
    from repro.core.masks import path_str as r_path_str
    tree = {"segments": [[{"attn": {"wq": 0}}]], "embed": {"table": 0}}
    want = [r_path_str(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(tree)[0]]
    got = [_bridge.path_str(p) for p, _ in
           _pytree.tree_flatten_with_path(tree)[0]]
    assert sorted(got) == sorted(want) == ["embed/table",
                                          "segments/0/0/attn/wq"]


def test_resolve_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _bridge.resolve_device("cuda")
    assert _bridge.resolve_device("cpu").type == "cpu"


def test_build_has_no_side_effects_on_import():
    """Importing the kernel modules builds nothing and needs no nvcc."""
    code = ("import repro_torch.kernels.bsmm, "
            "repro_torch.kernels.paged_attention as p, sys, "
            "repro_torch.kernels.tile_stats, repro_torch.kernels.ops; "
            "import repro_torch.kernels._build as b; "
            "print(b.library.cache_info().currsize)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env={"PYTHONPATH": "src", "PATH": ""},
                         cwd=_repo_root())
    assert out.stdout.strip() == "0"


def _repo_root():
    import pathlib
    return str(pathlib.Path(__file__).resolve().parent.parent)


# ---------------------------------------------------------------------------
# CUDA kernels against their plain versions (skip without a card)
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [8, 128, 300])
def test_cuda_bsmm_matches_plain(cuda, dtype, M):
    x, w, b, mask = _operands(M, M, 512, 384, density=0.3)
    plan = tb.make_tile_plan(mask)
    xt, wt, bt = (torch.from_numpy(a).to(cuda, dtype) for a in (x, w, b))
    tol = dict(rtol=1e-2, atol=1e-2) if dtype == torch.bfloat16 \
        else dict(rtol=1e-4, atol=1e-4)
    n0 = tb.bsmm.launches
    torch.testing.assert_close(tb.bsmm(xt, wt, plan),
                               tb.bsmm_plain(xt, wt, plan), **tol)
    assert tb.bsmm.launches == n0 + 1
    for act in ("relu", "gelu", "silu"):
        torch.testing.assert_close(
            tb.bsmm_epilogue(xt, wt, plan, bt, act),
            tb.bsmm_epilogue_plain(xt, wt, plan, bt, act), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [8, 40, 64, 300])
def test_cuda_bsmm_routes_counted_and_repeatable(cuda, dtype, M):
    """Each call runs on the route ``bsmm_route`` names, is counted as
    split where ``bsmm_splits`` cuts the lists, and two calls give the
    same bits; a row's bits do not depend on the other rows."""
    x, w, b, mask = _operands(M + 5, M, 1024, 1280, density=0.5)
    plan = tb.make_tile_plan(mask)
    xt, wt, bt = (torch.from_numpy(a).to(cuda, dtype) for a in (x, w, b))
    route, S = plan.route_and_splits("fwd", M, dtype)
    for fn, args in ((tb.bsmm, ()), (tb.bsmm_epilogue, (bt, "gelu"))):
        before = dict(fn.launches_by_route)
        splits = fn.split_launches
        got = fn(xt, wt, plan, *args)
        again = fn(xt, wt, plan, *args)
        after = fn.launches_by_route
        assert {k: after[k] - before[k] for k in after} == {
            k: 2 * int(k == route) for k in after}
        assert fn.split_launches - splits == 2 * int(S > 1)
        assert torch.equal(got, again)
        other = xt.clone()
        other[1:] = -other[1:]
        assert torch.equal(fn(other, wt, plan, *args)[0], got[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [8, 300])
def test_cuda_bsmm_dw_routes_counted_and_repeatable(cuda, dtype, M):
    x, w, _, mask = _operands(M + 9, M, 512, 384, density=0.3)
    g = np.random.default_rng(M).standard_normal((M, 384)).astype(np.float32)
    plan = tb.make_tile_plan(mask)
    xt, gt = (torch.from_numpy(a).to(cuda, dtype) for a in (x, g))
    route, S = plan.route_and_splits("dw", M, dtype)
    before = dict(tb.bsmm_dw.launches_by_route)
    splits = tb.bsmm_dw.split_launches
    got = tb.bsmm_dw(xt, gt, plan)
    assert torch.equal(got, tb.bsmm_dw(xt, gt, plan))
    after = tb.bsmm_dw.launches_by_route
    assert {k: after[k] - before[k] for k in after} == {
        k: 2 * int(k == route) for k in after}
    assert tb.bsmm_dw.split_launches - splits == 2 * int(S > 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [8, 64, 300, 1000])
def test_cuda_bsmm_dx_routes_counted_and_repeatable(cuda, dtype, M):
    """Each dx call runs on the route ``bsmm_dx_route`` names (wgmma for
    bf16 from 64 rows, simt otherwise), is counted as split where
    ``bsmm_dx_splits`` cuts the lists, repeats bitwise, keeps a row's
    bits when the other rows change, zeroes an all-dead K-row tile and
    agrees with the plain version."""
    x, w, _, mask = _operands(M + 7, M, 1024, 1280, density=0.5)
    mask[:128] = 0
    g = np.random.default_rng(M).standard_normal((M, 1280)).astype(
        np.float32)
    plan = tb.make_tile_plan(mask)
    wt, gt = (torch.from_numpy(a).to(cuda, dtype) for a in (w, g))
    route, S = plan.route_and_splits("dx", M, dtype)
    assert route == ("wgmma" if dtype == torch.bfloat16 and M >= 64
                     else "simt")
    before = dict(tb.bsmm_dx.launches_by_route)
    splits = tb.bsmm_dx.split_launches
    got = tb.bsmm_dx(gt, wt, plan)
    assert torch.equal(got, tb.bsmm_dx(gt, wt, plan))
    after = tb.bsmm_dx.launches_by_route
    assert {k: after[k] - before[k] for k in after} == {
        k: 2 * int(k == route) for k in after}
    assert tb.bsmm_dx.split_launches - splits == 2 * int(S > 1)
    other = gt.clone()
    other[1:] = -other[1:]
    assert torch.equal(tb.bsmm_dx(other, wt, plan)[0], got[0])
    assert not got[:, :128].any()
    tol = dict(rtol=1e-2, atol=1e-2) if dtype == torch.bfloat16 \
        else dict(rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got, tb.bsmm_dx_plain(gt, wt, plan), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_paged_attention_matches_plain(cuda, dtype):
    q, kp, vp, tables, lengths = _pool_setup(5, 4, 6, 2, 128, NB=3, P=14)
    kp[0] = np.nan
    vp[0] = np.nan
    args = [torch.from_numpy(a).to(cuda) for a in (q, kp, vp)]
    args = [a.to(dtype) for a in args] + [torch.from_numpy(tables).to(cuda),
                                          torch.from_numpy(lengths).to(cuda)]
    tol = dict(rtol=1e-2, atol=1e-2) if dtype == torch.bfloat16 \
        else dict(rtol=1e-5, atol=1e-5)
    got = tpa.paged_attention(*args, scale=128 ** -0.5)
    torch.testing.assert_close(
        got, tpa.paged_attention_ref(*args, scale=128 ** -0.5), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [8, 300, 1024])
def test_cuda_bsmm_dx_dw_match_plain(cuda, dtype, M):
    x, w, _, mask = _operands(M + 1, M, 512, 384, density=0.3)
    g = np.random.default_rng(M).standard_normal((M, 384)).astype(np.float32)
    plan = tb.make_tile_plan(mask)
    xt, wt, gt = (torch.from_numpy(a).to(cuda, dtype) for a in (x, w, g))
    tol = dict(rtol=1e-2, atol=1e-2) if dtype == torch.bfloat16 \
        else dict(rtol=1e-4, atol=1e-4)
    n0 = (tb.bsmm_dx.launches, tb.bsmm_dw.launches)
    torch.testing.assert_close(tb.bsmm_dx(gt, wt, plan),
                               tb.bsmm_dx_plain(gt, wt, plan), **tol)
    dw = tb.bsmm_dw(xt, gt, plan)
    torch.testing.assert_close(dw, tb.bsmm_dw_plain(xt, gt, plan), **tol)
    assert (tb.bsmm_dx.launches, tb.bsmm_dw.launches) == (n0[0] + 1,
                                                          n0[1] + 1)
    dead = torch.from_numpy(np.kron(tb.tile_bitmap(mask) == 0,
                                    np.ones((128, 128), bool))).to(cuda)
    assert not dw[dead].any()


@pytest.mark.cuda
def test_cuda_plan_matmul_backward_matches_plain(cuda):
    """A backward through plan_matmul on the card yields gradients (not
    None) equal to the same backward on the CPU's plain versions."""
    x, w, b, mask = _operands(21, 40, 256, 384)
    plan = tb.make_tile_plan(mask)
    g = np.random.default_rng(1).standard_normal((40, 384)).astype(
        np.float32)
    grads = {}
    for dev in ("cpu", cuda):
        args = [torch.from_numpy(a).to(dev).requires_grad_(True)
                for a in (x, w, b)]
        out = tb.plan_matmul(args[0], args[1], plan, bias=args[2],
                             act="silu")
        out.backward(torch.from_numpy(g).to(dev))
        assert all(a.grad is not None for a in args)
        grads[str(dev)] = [a.grad.cpu() for a in args]
    for got, want in zip(grads[str(cuda)], grads["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seed,K,N,bk,bn", _TS_CASES)
def test_cuda_tile_stats_matches_plain(cuda, dtype, seed, K, N, bk, bn):
    w = torch.from_numpy(_stats_weight(seed, K, N, bk, bn)).to(cuda, dtype)
    n0 = tts.tile_stats.launches
    live, sums = tts.tile_stats(w, bk=bk, bn=bn)
    assert tts.tile_stats.launches == n0 + 1
    p_live, p_sums = tts.tile_stats_plain(w, bk, bn)
    torch.testing.assert_close(live, p_live, rtol=0, atol=0)
    torch.testing.assert_close(sums, p_sums, rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask_dtype", [torch.float32, torch.bfloat16,
                                        torch.bool])
@pytest.mark.parametrize("M", [8, 256])
def test_cuda_masked_matmul_matches_plain(cuda, dtype, mask_dtype, M):
    x, w, mask = _masked_operands(M, M, 256, 384)
    xt, wt = (torch.from_numpy(a).to(cuda, dtype) for a in (x, w))
    mt = torch.from_numpy(mask).to(cuda, mask_dtype)
    tol = dict(rtol=1e-2, atol=1e-2) if dtype == torch.bfloat16 \
        else dict(rtol=1e-4, atol=1e-4)
    n0 = tb.masked_matmul.launches
    got = tb.masked_matmul(xt, wt, mt, bm=8)
    assert tb.masked_matmul.launches == n0 + 1
    torch.testing.assert_close(got, tb.masked_matmul_plain(xt, wt, mt), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("M,dtype,mask_dtype", [
    (1, torch.bfloat16, torch.bfloat16), (8, torch.float32, torch.float32),
    (40, torch.bfloat16, torch.bool), (64, torch.float32, torch.bool),
    (100, torch.bfloat16, torch.bfloat16), (128, torch.bfloat16, torch.bool),
    (128, torch.float32, torch.float32), (256, torch.bfloat16, torch.float32),
    (300, torch.bfloat16, torch.bfloat16),
    (1024, torch.bfloat16, torch.bfloat16)])
def test_cuda_masked_routes_match_plain(cuda, M, dtype, mask_dtype):
    """Each route of kernel #5 against its plain version, counted on the
    kernel ``masked_route`` names, and as split where ``masked_splits``
    cuts K."""
    x, w, mask = _masked_operands(M + 7, M, 1024, 1280)
    xt, wt = (torch.from_numpy(a).to(cuda, dtype) for a in (x, w))
    mt = torch.from_numpy(mask).to(cuda, mask_dtype)
    tol = dict(rtol=1e-2, atol=1e-2) if dtype == torch.bfloat16 \
        else dict(rtol=1e-4, atol=1e-4)
    route = tb.masked_route(M, 1024, 1280, dtype)
    before = dict(tb.masked_matmul.launches_by_route)
    splits = tb.masked_matmul.split_launches
    got = tb.masked_matmul(xt, wt, mt, bm=1)
    after = tb.masked_matmul.launches_by_route
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == route) for k in after}
    assert tb.masked_matmul.split_launches - splits == int(
        route != "wgmma" and len(tb.masked_splits(M, 1024, 1280)) > 1)
    torch.testing.assert_close(got, tb.masked_matmul_plain(xt, wt, mt), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("M,dtype", [(8, torch.bfloat16), (8, torch.float32),
                                     (128, torch.float32),
                                     (256, torch.bfloat16)])
def test_cuda_masked_nan_rules_and_determinism(cuda, M, dtype):
    """NaN in w under a dead tile leaves the output finite; NaN under a
    zero mask element of a live tile gives NaN in the same places as
    the plain version; two calls give the same bits."""
    x, w, mask = _masked_operands(M + 3, M, 512, 384)
    xt, mt = (torch.from_numpy(a).to(cuda, dtype) for a in (x, mask))
    w[:128, 128:256] = np.nan               # under the all-dead tile
    wt = torch.from_numpy(w).to(cuda, dtype)
    out = tb.masked_matmul(xt, wt, mt, bm=1)
    assert torch.isfinite(out).all()
    assert torch.equal(out, tb.masked_matmul(xt, wt, mt, bm=1))
    k, n = np.argwhere(mask[128:256, :128] == 0)[0]
    w[128 + k, n] = np.nan                  # under a zero of a live tile
    wt = torch.from_numpy(w).to(cuda, dtype)
    got = torch.isnan(tb.masked_matmul(xt, wt, mt, bm=1))
    assert got[:, n].all()
    assert torch.equal(got, torch.isnan(tb.masked_matmul_plain(xt, wt, mt)))


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["gqa", "fused", "deepseek"])
def test_cuda_paged_attention_row_alone_equals_in_batch(cuda, form):
    """Split-KV on the card: a row's output has the same bits alone as in
    a batch of other lengths, repeats bitwise, and agrees with the split
    and merge in plain PyTorch; at deepseek-v3's geometry (128 heads,
    hd 576, dv 512) on the fused form's wgmma kernel, with NaN past each
    length."""
    Hq, Hkv, hd = (128, 1, 576) if form == "deepseek" else (8, 2, 128)
    q, kp, vp, tables, lengths = _pool_setup(6, 5, Hq, Hkv, hd, NB=3, P=16)
    kp[0] = np.nan
    vp[0] = np.nan
    if form == "deepseek":
        T = tpa.BLOCK_TOKENS
        for b, n in enumerate(lengths):
            kp[tables[b, (n - 1) // T], n - (n - 1) // T * T:] = np.nan
    args = [torch.from_numpy(a).to(cuda) for a in (q, kp, vp, tables,
                                                    lengths)]
    args[:3] = [a.bfloat16() for a in args[:3]]
    if form != "gqa":
        args[2] = None
    dv = {"gqa": None, "fused": 64, "deepseek": 512}[form]
    kw = dict(scale=0.1, v_dim=dv)
    by_route = dict(tpa.paged_attention.fused_launches_by_route)
    full = tpa.paged_attention(*args, **kw)
    if form != "gqa":
        route = "wgmma" if form == "deepseek" else "simt"
        after = tpa.paged_attention.fused_launches_by_route
        assert {k: after[k] - by_route[k] for k in after} == {
            k: int(k == route) for k in after}
    assert torch.isfinite(full).all()
    assert torch.equal(full, tpa.paged_attention(*args, **kw))
    torch.testing.assert_close(
        full, _split_plain(*args, **kw, p_bf16=form == "deepseek"),
        rtol=1e-2, atol=1e-2)
    for b in range(5):
        one = tpa.paged_attention(args[0][b:b + 1].contiguous(), args[1],
                                  args[2], args[3][b:b + 1].contiguous(),
                                  args[4][b:b + 1].contiguous(), **kw)
        assert torch.equal(one[0], full[b])


# ---------------------------------------------------------------------------
# kernel #8: flash attention
# ---------------------------------------------------------------------------
def _qkv(seed, B, S, Hq, Hkv, hd, dv=None):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, Hq, hd)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, hd)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, dv or hd)).astype(np.float32))


def _flash_pair(q, k, v, dtype, causal=True, bq=128, bk=128):
    """(the port's plain flash_attention, the Pallas kernel in interpret
    mode) on the same inputs, both as float32 numpy."""
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = rfa.flash_attention(*(jnp.asarray(a, jd) for a in (q, k, v)),
                               causal=causal, bq=bq, bk=bk, interpret=True)
    got = tfa.flash_attention(*(torch.from_numpy(a).to(dtype)
                                for a in (q, k, v)), causal=causal, bq=bq,
                              bk=bk)
    assert got.dtype == dtype
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("S,bq,bk", [(128, 64, 64), (256, 64, 128),
                                     (256, 128, 64)])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (8, 2), (6, 1)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_reference(S, bq, bk, Hq, Hkv, causal):
    """The reference's sweep (tests/test_kernels_flash.py), causal and
    full, float32 at 2e-4."""
    got, want = _flash_pair(*_qkv(S + Hq, 2, S, Hq, Hkv, 32), torch.float32,
                            causal=causal, bq=bq, bk=bk)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 3e-2)])
def test_flash_attention_dtypes_match_reference(dtype, tol):
    got, want = _flash_pair(*_qkv(1, 1, 128, 4, 4, 64), dtype)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_flash_attention_large_logits_stable():
    """Logits x30: the online max rescaling keeps everything finite and
    on the reference."""
    q, k, v = _qkv(7, 1, 128, 2, 2, 16)
    got, want = _flash_pair(q * 30.0, k * 30.0, v, torch.float32)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("S", [1, 5, 300])
@pytest.mark.parametrize("dv", [None, 32])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_ragged_and_narrow_values(S, dv, causal):
    """Beyond the Pallas grid: any S and a value width dv < hd, against
    the reference's plain attention (causal_attention / attend)."""
    q, k, v = _qkv(S, 2, S, 6, 2, 64, dv)
    got = tfa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=causal).numpy()
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = (rattn.causal_attention(jq, jk, jv) if causal
            else rattn.attend(jq, jk, jv, causal=False, q_offset=0))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_flash_attention_rejects_bad_geometry():
    q, k, v = (torch.from_numpy(a) for a in _qkv(0, 1, 8, 6, 4, 16))
    with pytest.raises(tb.GeometryError, match="multiple"):
        tfa.flash_attention(q, k, v)
    q, k, v = (torch.from_numpy(a) for a in _qkv(0, 1, 8, 4, 2, 16, 32))
    with pytest.raises(tb.GeometryError, match="dv <= hd"):
        tfa.flash_attention(q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,Hq,Hkv,hd,dv,causal", [
    (300, 24, 8, 128, 128, True), (129, 6, 1, 64, 32, False),
    (64, 8, 8, 192, 128, True), (1, 24, 8, 128, 128, True),
    (129, 24, 8, 128, 128, True), (300, 10, 1, 256, 256, True)])
def test_cuda_flash_attention_matches_plain(cuda, dtype, S, Hq, Hkv, hd, dv,
                                            causal):
    """Both routes against the plain version; bfloat16 runs the wgmma
    kernel, float32 the CUDA-core one."""
    q, k, v = (torch.from_numpy(a).to(cuda, dtype)
               for a in _qkv(S, 1, S, Hq, Hkv, hd, dv))
    route = "wgmma" if dtype == torch.bfloat16 else "simt"
    n0 = tfa.flash_attention.launches
    r0 = tfa.flash_attention.launches_by_route[route]
    got = tfa.flash_attention(q, k, v, causal=causal)
    assert tfa.flash_attention.launches == n0 + 1
    assert tfa.flash_attention.launches_by_route[route] == r0 + 1
    tol = dict(rtol=1e-2, atol=1e-2) if dtype == torch.bfloat16 \
        else dict(rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(
        got, tfa.flash_attention_plain(q, k, v, causal=causal), **tol)
