"""The port's MLA + MoE serving slice against the reference's.

Same weights (the reference's ``init_params`` through the numpy bridge),
same crossbar ticket (numpy masks) and same inputs go through ``repro``
(Pallas kernels in interpret mode) and ``repro_torch`` (plain PyTorch
versions on the CPU).  The config is deepseek-v3 scaled so that the
dense FFN, the experts and the shared expert tile at 128 (d_model,
d_ff, d_ff_expert and d_ff_shared 256; 8 experts, top-2; MoE from layer
1 of 4, so the MoE segment stacks 3 repeats), in float32.  Tolerances:
1e-5 for kernels, 1e-4 for the model; token streams identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.configs as tcfgs
from repro.configs import MoEConfig, get_arch, scaled_down
from repro.core.masks import apply_masks as r_apply_masks
from repro.kernels.bsmm import make_tile_plan as r_make_plan
from repro.kernels.bsmm import plan_matmul as r_plan_matmul
from repro.kernels.paged_attention import paged_attention as r_paged
from repro.models import attention as rattn
from repro.models import moe as rmoe
from repro.models import transformer as rtfm
from repro.models.plans import build_decode_plan as r_build_plan
from repro.serve import Request as RRequest
from repro.serve import ServeEngine as RServeEngine
from repro_torch import _bridge
from repro_torch.core import masks as tmasks
from repro_torch.kernels import bsmm as tb
from repro_torch.kernels import paged_attention as tpa
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttfm
from repro_torch.models.plans import build_decode_plan as t_build_plan
from repro_torch.serve import Request, ServeEngine

torch.set_num_threads(2)

KTOL = dict(rtol=1e-5, atol=1e-5)      # kernels
TOL = dict(rtol=1e-4, atol=1e-4)       # the model
PROJ = ("up", "gate", "down")
MOE = dict(num_experts=8, top_k=2, d_ff_expert=256, num_shared_experts=1,
           d_ff_shared=256, first_moe_layer=1)
SMALL = dict(dtype="float32", n_layers=4, d_model=256, d_ff=256)


def _cfgs():
    rcfg = scaled_down(get_arch("deepseek-v3-671b"), moe=MoEConfig(**MOE),
                       **SMALL)
    tcfg = tcfgs.scaled_down(tcfgs.get_arch("deepseek-v3-671b"),
                             moe=tcfgs.MoEConfig(**MOE), **SMALL)
    return rcfg, tcfg


def _ticket(params_np, seed=0, density=0.5):
    """A random 128x128 tile bitmap per routed projection, independent
    per layer and per expert; column tile 0 dead everywhere, so that the
    union plans skip tiles."""
    rng = np.random.default_rng(seed)

    def mk(path, a):
        if str(path[-1].key) not in PROJ:
            return None
        *lead, K, N = a.shape
        bm = rng.random((*lead, K // 128, N // 128)) < density
        bm[..., 0] = False
        return np.repeat(np.repeat(bm, 128, -2), 128, -1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(mk, params_np)


@pytest.fixture(scope="module")
def setup():
    rcfg, tcfg = _cfgs()
    rparams = rtfm.init_params(jax.random.PRNGKey(0), rcfg)
    params_np = jax.tree.map(np.asarray, rparams)
    masks = _ticket(params_np)
    return dict(rcfg=rcfg, tcfg=tcfg, masks=masks,
                rparams=r_apply_masks(rparams, masks),
                tparams=_bridge.apply_masks(
                    _bridge.params_from_numpy(params_np, device="cpu"), masks))


def _tokens(n, seed=3, vocab=512):
    return np.random.default_rng(seed).integers(1, vocab, size=(1, n)) \
        .astype(np.int32)


# ---------------------------------------------------------------------------
# 1. the fused-V paged kernel's plain version against the Pallas kernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("Hq,hd,dv", [(3, 24, 16), (16, 72, 64)])
def test_fused_v_paged_attention_matches_reference(Hq, hd, dv):
    rng = np.random.default_rng(Hq)
    B, T, P = 2, tpa.BLOCK_TOKENS, 6
    q = rng.standard_normal((B, Hq, hd)).astype(np.float32)
    pool = rng.standard_normal((P, T, 1, hd)).astype(np.float32)
    tables = np.asarray([[1, 2], [3, 0]], np.int32)
    lengths = np.asarray([T + 17, 5], np.int32)
    scale = 0.2
    want = r_paged(q, pool, None, tables, lengths, scale=scale, v_dim=dv,
                   interpret=True)
    got = tpa.paged_attention(*map(torch.from_numpy, (q, pool)), None,
                              *map(torch.from_numpy, (tables, lengths)),
                              scale=scale, v_dim=dv)
    assert got.shape == (B, Hq, dv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KTOL)


# ---------------------------------------------------------------------------
# 2. the expert-batched bsmm's plain version against vmap(plan_matmul)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("M", [5, 24])
def test_bsmm_batched_matches_vmapped_plan_matmul(M):
    rng = np.random.default_rng(M)
    E, K, N = 3, 256, 384
    bm = rng.random((E, K // 128, N // 128)) < 0.5
    bm[:, :, 1] = False
    mask = np.repeat(np.repeat(bm, 128, -2), 128, -1)
    union = mask.any(axis=0)
    a = rng.standard_normal((E, M, K)).astype(np.float32)
    w = (rng.standard_normal((E, K, N)) * mask).astype(np.float32)
    rplan = r_make_plan(union, interpret=True)
    want = jax.vmap(lambda ae, we: r_plan_matmul(ae, we, rplan))(a, w)
    tplan = tb.make_tile_plan(union)
    got = tb.bsmm_batched(torch.from_numpy(a), torch.from_numpy(w), tplan)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KTOL)
    np.testing.assert_allclose(
        tb.bsmm_batched_plain(torch.from_numpy(a), torch.from_numpy(w),
                              tplan).numpy(), np.asarray(want), **KTOL)


def test_bsmm_batched_geometry_errors():
    plan = tb.make_tile_plan(np.ones((128, 128)))
    with pytest.raises(tb.GeometryError):
        tb.bsmm_batched(torch.zeros(2, 4, 128), torch.zeros(3, 128, 128),
                        plan)
    with pytest.raises(tb.GeometryError):
        tb.bsmm_batched(torch.zeros(2, 4, 128), torch.zeros(2, 128, 256),
                        plan)


# ---------------------------------------------------------------------------
# 3. moe_forward
# ---------------------------------------------------------------------------
def _moe_case(setup, router_zero=False, cf=None):
    s = setup
    rp = s["rparams"]["segments"][1][0]["moe"]
    tp = s["tparams"]["segments"][1][0]["moe"]
    rp = jax.tree.map(lambda a: a[0], rp)          # repeat 0 of the stack
    tp = _bridge.tree_index(tp, 0)
    if router_zero:
        rp = dict(rp, router=jnp.zeros_like(rp["router"]))
        tp = dict(tp, router=torch.zeros_like(tp["router"]))
    rmc, tmc = s["rcfg"].moe, s["tcfg"].moe
    if cf is not None:
        rmc = dataclasses.replace(rmc, capacity_factor=cf)
        tmc = dataclasses.replace(tmc, capacity_factor=cf)
    x = np.random.default_rng(9).standard_normal((2, 24, 256)) \
        .astype(np.float32)
    return rp, tp, rmc, tmc, x


@pytest.mark.parametrize("with_plan", [False, True])
@pytest.mark.parametrize("case", ["plain", "drops", "tied_router"])
def test_moe_forward_matches_reference(setup, with_plan, case):
    s = setup
    rp, tp, rmc, tmc, x = _moe_case(setup, router_zero=case == "tied_router",
                                    cf=0.25 if case == "drops" else None)
    mk = s["masks"]["segments"][1][0]["moe"]
    mk = jax.tree.map(lambda a: a[0], mk)
    rplan = r_build_plan({"segments": [[{"moe": mk}]]},
                         interpret=True)[0][0][0]["moe"] if with_plan else None
    tplan = t_build_plan({"segments": [[{"moe": mk}]]})[0][0][0]["moe"] \
        if with_plan else None
    want = rmoe.moe_forward(rp, jnp.asarray(x), rmc, "silu", True, plan=rplan)
    got = tmoe.moe_forward(tp, torch.from_numpy(x), tmc, "silu", True,
                           plan=tplan)
    np.testing.assert_allclose(got.y.numpy(), np.asarray(want.y), **TOL)
    np.testing.assert_allclose(float(got.aux_loss), float(want.aux_loss),
                               **TOL)
    assert float(got.drop_fraction) == float(want.drop_fraction)
    if case == "drops":
        assert float(got.drop_fraction) > 0.0
    if case == "tied_router":           # every expert ties: the lowest
        assert float(got.drop_fraction) > 0.0      # two take every token


def test_moe_top_k_breaks_ties_to_the_lower_index():
    probs = torch.tensor([[0.2, 0.3, 0.2, 0.3]])
    vals, idx = tmoe._top_k(probs, 3)
    rv, ri = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    assert idx.tolist() == np.asarray(ri).tolist() == [[1, 3, 0]]
    np.testing.assert_array_equal(vals.numpy(), np.asarray(rv))


def test_expert_capacity_matches_reference(setup):
    for T in (1, 8, 24, 300, 1024):
        assert tmoe.expert_capacity(T, setup["tcfg"].moe) == \
            rmoe.expert_capacity(T, setup["rcfg"].moe)


# ---------------------------------------------------------------------------
# 4. MLA
# ---------------------------------------------------------------------------
def _mla_kw(cfg):
    return dict(n_heads=cfg.n_heads, mla=cfg.mla, rope_theta=cfg.rope_theta)


def test_mla_forward_and_make_cache_match_reference(setup):
    s = setup
    rp = jax.tree.map(lambda a: a[0], s["rparams"]["segments"][1][0]["attn"])
    tp = _bridge.tree_index(s["tparams"]["segments"][1][0]["attn"], 0)
    x = np.random.default_rng(4).standard_normal((2, 9, 256)) \
        .astype(np.float32)
    want = rattn.mla_forward(rp, jnp.asarray(x), **_mla_kw(s["rcfg"]))
    got = tattn.mla_forward(tp, torch.from_numpy(x), **_mla_kw(s["tcfg"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for capacity, valid_len in ((9, None), (12, [9, 6])):
        ro, rc = rattn.mla_make_cache(
            rp, jnp.asarray(x), capacity=capacity, **_mla_kw(s["rcfg"]),
            valid_len=None if valid_len is None else jnp.asarray(valid_len))
        to, tc = tattn.mla_make_cache(
            tp, torch.from_numpy(x), capacity=capacity, **_mla_kw(s["tcfg"]),
            valid_len=None if valid_len is None else torch.tensor(valid_len))
        np.testing.assert_allclose(to.numpy(), np.asarray(ro), **TOL)
        for a, b in zip(rc, tc):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


def test_mla_paged_adopt_and_decode_match_reference(setup):
    s = setup
    rp = jax.tree.map(lambda a: a[0], s["rparams"]["segments"][1][0]["attn"])
    tp = _bridge.tree_index(s["tparams"]["segments"][1][0]["attn"], 0)
    x = np.random.default_rng(5).standard_normal((1, 130, 256)) \
        .astype(np.float32)
    _, rc = rattn.mla_make_cache(rp, jnp.asarray(x), capacity=130,
                                 **_mla_kw(s["rcfg"]))
    _, tc = tattn.mla_make_cache(tp, torch.from_numpy(x), capacity=130,
                                 **_mla_kw(s["tcfg"]))
    rpool = rattn.PagedLatentCache(jnp.zeros((5, 128, 1, 24), jnp.float32))
    tpool = tattn.PagedLatentCache(torch.zeros(5, 128, 1, 24))
    rpool = rattn.mla_paged_adopt(rpool, rc, jnp.asarray([3, 1], jnp.int32))
    tpool = tattn.mla_paged_adopt(tpool, tc, [3, 1])
    np.testing.assert_allclose(tpool.pool.numpy(), np.asarray(rpool.pool),
                               **TOL)
    # two rows: one at 130 tokens (its new token lands in block 1 at
    # offset 2), one idle on the scratch block
    tables = np.asarray([[3, 1], [0, 0]], np.int32)
    lens = np.asarray([130, 0], np.int32)
    xd = np.random.default_rng(6).standard_normal((2, 1, 256)) \
        .astype(np.float32)
    ro, rpool = rattn.mla_paged_decode(rp, rpool, jnp.asarray(xd),
                                       tables=jnp.asarray(tables),
                                       lens=jnp.asarray(lens),
                                       interpret=True, **_mla_kw(s["rcfg"]))
    to, tpool = tattn.mla_paged_decode(tp, tpool, torch.from_numpy(xd),
                                       tables=torch.from_numpy(tables),
                                       lens=torch.from_numpy(lens),
                                       **_mla_kw(s["tcfg"]))
    np.testing.assert_allclose(to[0].numpy(), np.asarray(ro)[0], **TOL)
    for blk in (1, 3):
        np.testing.assert_allclose(tpool.pool[blk].numpy(),
                                   np.asarray(rpool.pool)[blk], **TOL)


def test_mla_dense_slot_decode_not_yet_ported(setup):
    """Decode without a paged pool — the reference's ``mla_decode`` over
    dense per-slot caches, ported since — matches the reference: two
    steps over two slots at their own positions (a masked prefill), and
    over a lockstep batch (a scalar cache index)."""
    s = setup
    rp = jax.tree.map(lambda a: a[0], s["rparams"]["segments"][1][0]["attn"])
    tp = _bridge.tree_index(s["tparams"]["segments"][1][0]["attn"], 0)
    x = np.random.default_rng(7).standard_normal((2, 9, 256)) \
        .astype(np.float32)
    for valid_len in ([9, 4], None):
        _, rc = rattn.mla_make_cache(
            rp, jnp.asarray(x), capacity=12, **_mla_kw(s["rcfg"]),
            valid_len=None if valid_len is None else jnp.asarray(valid_len))
        _, tc = tattn.mla_make_cache(
            tp, torch.from_numpy(x), capacity=12, **_mla_kw(s["tcfg"]),
            valid_len=None if valid_len is None else torch.tensor(valid_len))
        for step in range(2):
            xd = np.random.default_rng(step).standard_normal((2, 1, 256)) \
                .astype(np.float32)
            ro, rc = rattn.mla_decode(rp, rc, jnp.asarray(xd),
                                      **_mla_kw(s["rcfg"]))
            to, tc = tattn.mla_decode(tp, tc, torch.from_numpy(xd),
                                      **_mla_kw(s["tcfg"]))
            np.testing.assert_allclose(to.numpy(), np.asarray(ro), **TOL)
        for a, b in zip(rc, tc):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


# ---------------------------------------------------------------------------
# 5. plans with MoE groups
# ---------------------------------------------------------------------------
def test_build_decode_plan_with_moe_groups_matches_reference(setup):
    s = setup
    rplan, rstats = r_build_plan(s["masks"], interpret=True)
    tplan, tstats = t_build_plan(s["masks"])
    assert (tstats.routed, tstats.live_tiles, tstats.total_tiles,
            tstats.by_layer) == (rstats.routed, rstats.live_tiles,
                                 rstats.total_tiles, rstats.by_layer)
    rmoe_plan, tmoe_plan = rplan[1][0]["moe"], tplan[1][0]["moe"]
    assert set(tmoe_plan) == set(rmoe_plan) == {"up", "gate", "down",
                                                 "shared"}
    for key in ("up", "gate", "down"):
        np.testing.assert_array_equal(tmoe_plan[key].idx, rmoe_plan[key].idx)
        np.testing.assert_array_equal(tmoe_plan[key].counts,
                                      rmoe_plan[key].counts)
    for key, p in rmoe_plan["shared"].items():
        np.testing.assert_array_equal(tmoe_plan["shared"][key].idx, p.idx)
    assert "attn" not in tplan[1][0]                # MLA runs dense


def test_union_of_an_expanded_expert_mask_is_unchanged():
    """A (K, N) mask expanded to (reps, E, K, N), as a ticket shared by
    every layer and expert gives it, plans like its materialised copy
    and like the (K, N) mask itself."""
    rng = np.random.default_rng(7)
    bm = rng.random((2, 3)) < 0.5
    bm[:, 0] = False
    m2 = torch.as_tensor(np.repeat(np.repeat(bm, 128, 0), 128, 1))
    expanded = m2.expand(3, 8, 256, 384)
    full = expanded.contiguous()
    full[1, 2, :128, :128] = True           # one tile live in one expert
    want = t_build_plan({"segments": [[{"moe": {"up": m2}}]]})[0]
    got = t_build_plan({"segments": [[{"moe": {"up": expanded}}]]})[0]
    np.testing.assert_array_equal(got[0][0]["moe"]["up"].idx,
                                  want[0][0]["moe"]["up"].idx)
    np.testing.assert_array_equal(got[0][0]["moe"]["up"].counts,
                                  want[0][0]["moe"]["up"].counts)
    ref = r_build_plan({"segments": [[{"moe": {"up": full.numpy()}}]]},
                       interpret=True)[0]
    tfull = t_build_plan({"segments": [[{"moe": {"up": full}}]]})[0]
    np.testing.assert_array_equal(tfull[0][0]["moe"]["up"].idx,
                                  ref[0][0]["moe"]["up"].idx)
    np.testing.assert_array_equal(tfull[0][0]["moe"]["up"].counts,
                                  ref[0][0]["moe"]["up"].counts)


def test_family_prunable_matches_reference():
    from repro.core.masks import family_prunable as r_family
    leaf = np.zeros((4, 4))
    paths = ("segments/1/0/moe/up", "segments/1/0/moe/router",
             "segments/0/0/attn/w_dq", "segments/0/0/norm1/scale", "embed")
    for fam in ("dense", "moe", "hybrid", "ssm", "vlm", "audio", "cnn"):
        for p in paths:
            assert tmasks.family_prunable(fam)(p, leaf) == \
                r_family(fam)(p, leaf), (fam, p)
    assert not tmasks.moe_prunable("segments/1/0/moe/router", leaf)
    with pytest.raises(KeyError):
        tmasks.family_prunable("nope")


# ---------------------------------------------------------------------------
# 6. prefill and paged decode over several steps
# ---------------------------------------------------------------------------
def test_prefill_and_paged_decode_match_reference(setup):
    s = setup
    rplan = r_build_plan(s["masks"], interpret=True)[0]
    tplan = t_build_plan(s["masks"])[0]
    n = 11
    toks = _tokens(n)
    rl, rdense = rtfm.prefill(s["rparams"], s["rcfg"],
                              {"tokens": jnp.asarray(toks)}, n, plan=rplan)
    tl, tdense = ttfm.prefill(s["tparams"], s["tcfg"],
                              {"tokens": torch.from_numpy(toks).long()}, n,
                              plan=tplan)
    np.testing.assert_allclose(tl.numpy(), np.asarray(rl), **TOL)
    r_leaves = jax.tree.leaves(rdense)
    t_leaves = _bridge.tree_leaves(_bridge.to_numpy(tdense))
    assert len(r_leaves) == len(t_leaves) == 6
    for a, b in zip(r_leaves, t_leaves):
        np.testing.assert_allclose(b, np.asarray(a), **TOL)
    rpools = rtfm.adopt_prefill(s["rcfg"], rtfm.make_paged_caches(s["rcfg"],
                                                                  4),
                                rdense, [2])
    tpools = ttfm.adopt_prefill(
        s["tcfg"], ttfm.make_paged_caches(s["tcfg"], 4, device="cpu"),
        tdense, [2])
    tables = np.asarray([[2, 0], [0, 0]], np.int32)
    tok = np.asarray([[5], [7]], np.int32)
    for step in range(2):
        lens = np.asarray([n + step, 0], np.int32)
        rl, rpools = rtfm.decode_step_paged(
            s["rparams"], s["rcfg"], rpools, jnp.asarray(tok), tables, lens,
            plan=rplan)
        tl, tpools = ttfm.decode_step_paged(
            s["tparams"], s["tcfg"], tpools, torch.from_numpy(tok).long(),
            torch.from_numpy(tables), torch.from_numpy(lens), plan=tplan)
        np.testing.assert_allclose(tl[0].numpy(), np.asarray(rl)[0], **TOL)
        tok = np.asarray(rl).argmax(-1).astype(np.int32)
    r_leaves = jax.tree.leaves(rpools)
    t_leaves = _bridge.tree_leaves(_bridge.to_numpy(tpools))
    for a, b in zip(r_leaves, t_leaves):        # live block 2 only
        np.testing.assert_allclose(b[..., 2, :, :, :],
                                   np.asarray(a)[..., 2, :, :, :], **TOL)


def test_paged_cache_spec_is_the_latent_pool(setup):
    spec = ttfm.paged_cache_spec(setup["tcfg"], 5)
    assert isinstance(spec[0][0], tattn.PagedLatentCache)
    assert tuple(spec[0][0].pool.shape) == (5, 128, 1, 24)
    assert tuple(spec[1][0].pool.shape) == (3, 5, 128, 1, 24)
    rspec = rtfm.paged_cache_spec(setup["rcfg"], 5)
    assert [tuple(t.shape) for t in _bridge.tree_leaves(spec)] == \
        [t.shape for t in jax.tree.leaves(rspec)]
    assert not ttfm.supports_masked_prefill(setup["tcfg"])


# ---------------------------------------------------------------------------
# 7. the engine, through the exact-length prefill lane
# ---------------------------------------------------------------------------
def _ragged(cls, n=4, seed=1, max_new=4):
    """Prompts of two lengths (the reference retraces its exact-length
    prefill for every new length)."""
    rng = np.random.RandomState(seed)
    return [cls(uid=i, prompt=rng.randint(1, 512, size=(6, 11)[i % 2]
                                          ).astype(np.int32),
                max_new_tokens=max_new)
            for i in range(n)]


def _run(eng, reqs):
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    assert all(r.done for r in done) and len(done) == len(reqs)
    return {r.uid: r.tokens for r in done}


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_engine_streams_match_reference(setup, temperature):
    s = setup
    kw = dict(batch_slots=3, capacity=48, masks=s["masks"],
              temperature=temperature, sample_seed=4)
    ref = RServeEngine(params=s["rparams"], cfg=s["rcfg"],
                       prefill_fn=rtfm.prefill, decode_fn=rtfm.decode_step,
                       paged=True, **kw)
    want = _run(ref, _ragged(RRequest))
    eng = ServeEngine(params=s["tparams"], cfg=s["tcfg"], device="cpu", **kw)
    assert not eng._masked_prefill
    got = _run(eng, _ragged(Request))
    assert got == want
    rr, tr = ref.report, eng.report
    for f in ("requests", "prefills", "decode_steps", "tokens_generated",
              "slot_occupancy", "bsmm_enabled", "routed_matmuls",
              "live_tiles", "total_tiles", "kv_blocks", "kv_blocks_live",
              "kv_blocks_peak", "kv_block_bytes", "kv_bytes_per_token"):
        assert getattr(tr, f) == getattr(rr, f), f
    eng.generations[-1].pool.check()


def test_in_place_masking_matches_apply_masks(setup):
    s = setup
    params = _bridge.params_from_numpy(
        jax.tree.map(np.asarray, rtfm.init_params(jax.random.PRNGKey(0),
                                                  s["rcfg"])), device="cpu")
    want = tmasks.apply_masks(params, s["masks"])
    got = tmasks.apply_masks_(params, s["masks"])
    assert got is params
    for a, b in zip(_bridge.tree_leaves(want), _bridge.tree_leaves(got)):
        torch.testing.assert_close(b, a, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the CUDA kernels against their plain versions (skip without a card)
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,hd,dv", [(3, 24, 16), (20, 72, 64),
                                      (128, 576, 512)])
def test_cuda_fused_v_paged_attention_matches_plain(cuda, dtype, Hq, hd, dv):
    rng = np.random.default_rng(Hq)
    T = tpa.BLOCK_TOKENS
    pool = torch.from_numpy(rng.standard_normal((6, T, 1, hd))).to(cuda, dtype)
    pool[0] = float("nan")                     # scratch block
    q = torch.from_numpy(rng.standard_normal((3, Hq, hd))).to(cuda, dtype)
    tables = torch.tensor([[1, 2], [3, 0], [4, 5]], dtype=torch.int32,
                          device=cuda)
    lengths = torch.tensor([T + 1, 5, 2 * T], dtype=torch.int32, device=cuda)
    tol = dict(rtol=1e-2, atol=1e-2) if dtype == torch.bfloat16 \
        else dict(rtol=1e-5, atol=1e-5)
    n0 = tpa.paged_attention.fused_launches
    got = tpa.paged_attention(q, pool, None, tables, lengths, scale=0.1,
                              v_dim=dv)
    assert tpa.paged_attention.fused_launches == n0 + 1
    torch.testing.assert_close(got, tpa.paged_attention_ref(
        q, pool, None, tables, lengths, scale=0.1, v_dim=dv), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,M", [(5, 8), (5, 24), (5, 130), (96, 8),
                                 (96, 21)])
def test_cuda_bsmm_batched_matches_plain(cuda, dtype, E, M):
    """Few experts take the CUDA-core walk (bfloat16 from 64 rows the
    wgmma kernel); 96 experts x 3 column tiles fill the card twice over
    and take the weight-streaming one.  Each call launches once, on its
    rule's route."""
    rng = np.random.default_rng(M)
    K, N = 256, 384
    bm = rng.random((K // 128, N // 128)) < 0.5
    bm[:, 1] = False
    plan = tb.make_tile_plan(np.repeat(np.repeat(bm, 128, 0), 128, 1))
    a = torch.from_numpy(rng.standard_normal((E, M, K))).to(cuda, dtype)
    w = torch.from_numpy(rng.standard_normal((E, K, N)) / 16).to(cuda, dtype)
    tol = dict(rtol=1e-2, atol=1e-2) if dtype == torch.bfloat16 \
        else dict(rtol=1e-4, atol=1e-4)
    route, _ = plan.route_and_splits("batched", M, dtype, E)
    n0, r0 = tb.bsmm_batched.launches, tb.bsmm_batched.launches_by_route[route]
    got = tb.bsmm_batched(a, w, plan)
    assert tb.bsmm_batched.launches == n0 + 1
    assert tb.bsmm_batched.launches_by_route[route] == r0 + 1
    torch.testing.assert_close(got, tb.bsmm_batched_plain(a, w, plan), **tol)
