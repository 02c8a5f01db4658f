"""The port's MLA + MoE training slice against the reference's.

The expert-batched backward (kernels #3 and #4 over a stack of experts,
``bsmm_batched_dx``/``bsmm_batched_dw`` and the autograd Function around
them) against ``jax.vjp`` of the reference's ``jax.vmap`` of
``plan_matmul`` (Pallas in interpret mode); ``moe_forward``'s gradients,
the training ``forward``/``loss_fn`` with their gradients (remat on and
off) and two ``LMAdapter`` trainer steps against the reference's, on
the same numpy weights, ticket and batches.  The model is deepseek-v3
scaled so that the dense FFN, the experts and the shared expert tile at
128 (d_model, d_ff, d_ff_expert and d_ff_shared 256; 8 experts, top-2;
MoE from layer 1 of 4, so the MoE segment stacks 3 repeats), in float32;
each reference run happens once per scenario in a module fixture.
Tolerances: 1e-5 for the kernels, 1e-4 for the model and the trainer.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree

import repro_torch.configs as tcfgs
from repro.api.adapters import LMAdapter as RLMAdapter
from repro.configs import MoEConfig, get_arch, scaled_down
from repro.core import masks as rmasks
from repro.kernels.bsmm import make_tile_plan as r_make_plan
from repro.kernels.bsmm import plan_matmul as r_plan_matmul
from repro.models import moe as rmoe
from repro.models import transformer as rtfm
from repro.models.plans import build_decode_plan as r_build_plan
from repro.train.plans import lm_train_plan as r_lm_train_plan
from repro_torch import _bridge
from repro_torch.api import LMAdapter, PruningSession, make_adapter
from repro_torch.configs import PruneConfig
from repro_torch.core import masks as tmasks
from repro_torch.data import SyntheticLM
from repro_torch.kernels import bsmm as tb
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttfm
from repro_torch.models.plans import build_decode_plan as t_build_plan
from repro_torch.train import lm_train_plan

torch.set_num_threads(2)

KTOL = dict(rtol=1e-5, atol=1e-5)      # kernels
TOL = dict(rtol=1e-4, atol=1e-4)       # the model and the trainer
PROJ = ("up", "gate", "down")
MOE = dict(num_experts=8, top_k=2, d_ff_expert=256, num_shared_experts=1,
           d_ff_shared=256, first_moe_layer=1)
SMALL = dict(dtype="float32", n_layers=4, d_model=256, d_ff=256)
# the trainers under test: masked adamw, warmup 1 then cosine (as the
# llama retrain tests run it)
ADAPTER = dict(batch_size=2, seq_len=16, steps=2, peak_lr=1e-3, warmup=1)


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
    return dict(rcfg=rcfg, tcfg=tcfg, masks=masks, params_np=params_np,
                rparams=rmasks.apply_masks(rparams, masks))


def _tparams(s, masked=True):
    p = _bridge.params_from_numpy(s["params_np"], device="cpu")
    return _bridge.apply_masks(p, s["masks"]) if masked else p


def _ref_by_path(tree):
    return {rmasks.path_str(p): np.asarray(leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_by_path(tree):
    return {tmasks.path_str(p): _bridge.to_numpy(leaf) for p, leaf in
            _pytree.tree_flatten_with_path(tree)[0]}


def _assert_trees_close(port, ref, **tol):
    got, want = _port_by_path(port), _ref_by_path(ref)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


# ---------------------------------------------------------------------------
# 1. the batched dx and dw against jax.vjp of the vmapped plan_matmul
# ---------------------------------------------------------------------------
E, K, N = 3, 256, 384


def _batched_case(M):
    """E experts' operands with per-expert masks whose union leaves
    column tile 1 dead in every expert and tile (1, 0) live in the union
    but dead in expert 0 alone.  The cotangent is scaled by 1 / sqrt(M)
    so that dw (a sum over M rows) stays of unit scale, where f32 sums in
    another order agree to 1e-5."""
    rng = np.random.default_rng(M)
    bm = rng.random((E, K // 128, N // 128)) < 0.6
    bm[:, :, 1] = False                 # dead in the union
    bm[:, 1, 0] = True
    bm[0, 1, 0] = False                 # dead in expert 0 alone
    mask = np.repeat(np.repeat(bm, 128, -2), 128, -1)
    a = rng.standard_normal((E, M, K)).astype(np.float32)
    w = (rng.standard_normal((E, K, N)) * mask).astype(np.float32)
    g = (rng.standard_normal((E, M, N)) / np.sqrt(M)).astype(np.float32)
    return a, w, g, mask.any(axis=0)


@pytest.fixture(scope="module")
def batched_ref():
    """``jax.vjp`` of ``jax.vmap(plan_matmul)`` at each M, once."""
    out = {}
    for M in (5, 24, 136):
        a, w, g, union = _batched_case(M)
        rplan = r_make_plan(union, interpret=True)
        f = jax.vmap(lambda ae, we: r_plan_matmul(ae, we, rplan))
        y, vjp = jax.vjp(f, a, w)
        da, dw = vjp(jnp.asarray(g))
        out[M] = tuple(np.asarray(t) for t in (y, da, dw))
    return out


@pytest.mark.parametrize("M", [5, 24, 136])
@pytest.mark.parametrize("which", ["wrapper", "plain"])
def test_batched_dx_dw_match_vmapped_vjp(batched_ref, M, which):
    """At M = 136 the reference pads each expert's rows to 256; the port
    takes the ragged rows as they are."""
    a, w, g, union = _batched_case(M)
    _, want_da, want_dw = batched_ref[M]
    plan = tb.make_tile_plan(union)
    dx, dw = ((tb.bsmm_batched_dx, tb.bsmm_batched_dw) if which == "wrapper"
              else (tb.bsmm_batched_dx_plain, tb.bsmm_batched_dw_plain))
    ta, tw, tg = map(torch.from_numpy, (a, w, g))
    got_da = dx(tg, tw, plan)
    got_dw = dw(ta, tg, plan)
    assert got_da.shape == (E, M, K) and got_dw.shape == (E, K, N)
    np.testing.assert_allclose(got_da.numpy(), want_da, **KTOL)
    np.testing.assert_allclose(got_dw.numpy(), want_dw, **KTOL)
    # tiles dead in the union are exactly zero; the tile dead in expert 0
    # alone gets its (nonzero) grad there, as the reference's does
    assert not got_dw[:, :, 128:256].any()
    assert got_dw[0, 128:256, :128].abs().max() > 0


@pytest.mark.parametrize("M", [5, 136])
def test_batched_autograd_function_matches_jax_grad(batched_ref, M):
    a, w, g, union = _batched_case(M)
    want_y = batched_ref[M][0]
    rplan = r_make_plan(union, interpret=True)

    def rloss(a, w):
        y = jax.vmap(lambda ae, we: r_plan_matmul(ae, we, rplan))(a, w)
        return jnp.sum(y * g)

    want_da, want_dw = jax.grad(rloss, argnums=(0, 1))(a, w)
    ta = torch.from_numpy(a).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    y = tb.bsmm_batched_apply(ta, tw, tb.make_tile_plan(union))
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), want_y, **KTOL)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(want_da), **KTOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(want_dw), **KTOL)
    with torch.no_grad():               # serving: the forward alone
        assert tb.bsmm_batched_apply(ta, tw, tb.make_tile_plan(union)) \
            .grad_fn is None


def test_batched_split_rules_count_every_expert():
    """The batched dx and dw cut work only while the grid over ALL
    experts stays small: one expert's rule, with its grid times E."""
    plan = tb.make_tile_plan(np.ones((2048, 7168), np.float32))
    bf = torch.bfloat16
    assert tb.bsmm_dx_splits(100, 2048, 7168, bf, plan) == 4
    assert tb.bsmm_dx_splits(100, 2048, 7168, bf, plan, experts=2) == 3
    assert tb.bsmm_dx_splits(320, 2048, 7168, bf, plan, experts=32) == 1
    assert plan.route_and_splits("dx", 100, bf, 2) == ("wgmma", 3)
    assert plan.route_and_splits("dx", 40, bf, 2) == ("simt", 1)
    assert tb.bsmm_dw_splits(16, 2088, bf) == 2
    assert tb.bsmm_dw_splits(16, 2088, bf, experts=2) == 2
    assert tb.bsmm_dw_splits(16, 2088, bf, experts=9) == 1
    assert plan.route_and_splits("dw", 320, torch.float32, 32) == ("fma", 1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("E", [32, 2, 256])
@pytest.mark.parametrize("C", [320, 200, 100, 40])
def test_batched_forward_route_at_training_rows(C, E, dtype):
    """The batched forward (#1b) takes TMA + wgmma for bfloat16 from 64
    rows an expert and the CUDA-core walk otherwise at these rows (more
    than 32: no weight streaming); only the wgmma route splits, under
    the 2-D wgmma rule with its grid counted over all E experts (at the
    up/gate shape only E = 2 at 100 rows: 32 blocks, clusters of 3)."""
    bf = torch.bfloat16
    for K, N in ((7168, 2048), (2048, 7168)):
        plan = tb.make_tile_plan(np.ones((K, N), np.float32))
        want = "wgmma" if dtype == bf and C >= 64 else "simt"
        assert tb.bsmm_batched_route(C, N, dtype, E) == want
        S = 3 if (want, E, C, N) == ("wgmma", 2, 100, 2048) else 1
        assert tb.bsmm_batched_splits(C, N, dtype, plan, E) == S
        assert plan.route_and_splits("fwd", C, dtype, E) == (want, S)
        assert plan.route_and_splits("batched", C, dtype, E) == (want, S)
    assert set(tb.bsmm_batched.launches_by_route) == {"stream", "simt",
                                                      "wgmma"}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M", [8, 16, 20])
def test_batched_forward_streams_decode_rows(M, dtype):
    """Decode and MoE-prefill rows (at most 32 an expert) stream the
    weights where the grid of experts x column tiles x 8-row blocks fills
    the card's 132 SMs twice (256 experts), never split; two experts at
    the up/gate shape leave the grid narrow and take the CUDA-core walk.  "fwd" at one
    expert is the 2-D forward's rule."""
    for K, N in ((7168, 2048), (2048, 7168)):
        plan = tb.make_tile_plan(np.ones((K, N), np.float32))
        assert plan.route_and_splits("fwd", M, dtype, 256) == ("stream", 1)
        if N == 2048:                   # 2 x 16 x 3 blocks at most
            assert plan.route_and_splits("batched", M, dtype, 2) == (
                "simt", 1)
        assert plan.route_and_splits("fwd", M, dtype) == (
            tb.bsmm_route(M, K, N, dtype, plan),
            tb.bsmm_splits(M, K, N, dtype, plan))
    assert tb.bsmm_batched_route(33, 2048, dtype, 4096) == "simt"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_batched_stream_rule_counts_132_sms(dtype):
    """The stream threshold is twice the H100 SXM's 132 SMs of 8-row
    blocks, whatever card runs it (the route, and so the bits, depend on
    the shape alone), and one expert never streams."""
    assert tb._SMS == 132
    assert tb.bsmm_batched_route(8, 128, dtype, 264) == "stream"
    assert tb.bsmm_batched_route(8, 128, dtype, 263) == "simt"
    assert tb.bsmm_batched_route(32, 128, dtype, 66) == "stream"
    assert tb.bsmm_batched_route(32, 128, dtype, 65) == "simt"
    assert tb.bsmm_batched_route(8, 264 * 128, dtype, 1) == "simt"
    assert tb.bsmm_batched_route(8, 132 * 128, dtype, 2) == "stream"


def test_batched_grad_geometry_errors():
    plan = tb.make_tile_plan(np.ones((256, 128)))
    z = torch.zeros
    with pytest.raises(tb.GeometryError, match="3-D operands"):
        tb.bsmm_batched_dx(z(8, 128), z(256, 128), plan)
    with pytest.raises(tb.GeometryError, match="one expert count"):
        tb.bsmm_batched_dx(z(2, 8, 128), z(3, 256, 128), plan)
    with pytest.raises(tb.GeometryError, match="disagree"):
        tb.bsmm_batched_dw(z(2, 8, 256), z(2, 8, 256), plan)
    with pytest.raises(tb.GeometryError, match="at most 65535"):
        tb.batched_grid(65536, "bsmm_batched_dw")


# ---------------------------------------------------------------------------
# 2. moe_forward's gradients
# ---------------------------------------------------------------------------
def _moe_layer(s):
    rp = jax.tree.map(lambda a: a[0], s["rparams"]["segments"][1][0]["moe"])
    tp = _bridge.tree_index(_tparams(s)["segments"][1][0]["moe"], 0)
    mk = jax.tree.map(lambda a: a[0], s["masks"]["segments"][1][0]["moe"])
    return rp, tp, mk


def _moe_plans(mk):
    rplan = r_build_plan({"segments": [[{"moe": mk}]]},
                         interpret=True)[0][0][0]["moe"]
    tplan = t_build_plan({"segments": [[{"moe": mk}]]})[0][0][0]["moe"]
    return rplan, tplan


@pytest.mark.parametrize("with_plan", [False, True])
@pytest.mark.parametrize("case", ["plain", "drops"])
def test_moe_forward_grads_match_reference(setup, with_plan, case):
    """d(Σ y ⊙ c + aux) by x, the router, the experts and the shared
    expert; with ``drops`` the capacity drops routed pairs."""
    s = setup
    rp, tp, mk = _moe_layer(s)
    rmc, tmc = s["rcfg"].moe, s["tcfg"].moe
    if case == "drops":
        rmc = dataclasses.replace(rmc, capacity_factor=0.25)
        tmc = dataclasses.replace(tmc, capacity_factor=0.25)
    rplan, tplan = _moe_plans(mk) if with_plan else (None, None)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 24, 256)).astype(np.float32)
    c = rng.standard_normal((2, 24, 256)).astype(np.float32)

    def rloss(p, x):
        mo = rmoe.moe_forward(p, x, rmc, "silu", True, plan=rplan)
        return jnp.sum(mo.y * c) + mo.aux_loss

    want_p, want_x = jax.grad(rloss, argnums=(0, 1))(rp, jnp.asarray(x))
    tp = _bridge.tree_map(lambda t: t.clone().requires_grad_(True), tp)
    tx = torch.from_numpy(x).requires_grad_(True)
    mo = tmoe.moe_forward(tp, tx, tmc, "silu", True, plan=tplan)
    if case == "drops":
        assert float(mo.drop_fraction) > 0
    ((mo.y * torch.from_numpy(c)).sum() + mo.aux_loss).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_x), **TOL)
    _assert_trees_close(_bridge.tree_map(lambda t: t.grad, tp), want_p, **TOL)


# ---------------------------------------------------------------------------
# 3. the training forward and loss, with their gradients
# ---------------------------------------------------------------------------
def _batch(step=0):
    return SyntheticLM(256, ADAPTER["seq_len"], seed=0).batch(
        step, ADAPTER["batch_size"])


@pytest.fixture(scope="module")
def ref_loss(setup):
    """The reference's logits, aux, loss and parameter gradients, with
    and without the ticket's plan."""
    s = setup
    rb = {k: jnp.asarray(v) for k, v in _batch().items()}
    out = {}
    for with_plan in (False, True):
        plan = r_lm_train_plan(s["masks"], interpret=True)[0] \
            if with_plan else None
        logits, aux = rtfm.forward(s["rparams"], s["rcfg"], rb, plan=plan)
        (loss, met), grads = jax.value_and_grad(
            lambda p: rtfm.loss_fn(p, s["rcfg"], rb, plan=plan),
            has_aux=True)(s["rparams"])
        out[with_plan] = dict(logits=np.asarray(logits), aux=float(aux),
                              loss=float(loss), ce=float(met["ce"]),
                              grads=grads)
    return out


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("with_plan", [False, True])
def test_forward_loss_and_grads_match_reference(setup, ref_loss, with_plan,
                                                remat):
    s = setup
    want = ref_loss[with_plan]
    plan = lm_train_plan(s["masks"])[0] if with_plan else None
    tbatch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    params = _bridge.tree_map(lambda t: t.requires_grad_(True), _tparams(s))
    try:
        ttfm.set_remat(remat)
        with torch.no_grad():
            logits, aux = ttfm.forward(params, s["tcfg"], tbatch, plan=plan)
        loss, met = ttfm.loss_fn(params, s["tcfg"], tbatch, plan=plan)
        grads = torch.autograd.grad(loss, _bridge.tree_leaves(params))
    finally:
        ttfm.set_remat(True)
    np.testing.assert_allclose(logits.numpy(), want["logits"], **TOL)
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), want["aux"], **TOL)
    np.testing.assert_allclose(float(met["aux"].detach()), want["aux"],
                               **TOL)
    np.testing.assert_allclose(float(loss.detach()), want["loss"], **TOL)
    np.testing.assert_allclose(float(met["ce"].detach()), want["ce"], **TOL)
    tree = _pytree.tree_unflatten(list(grads),
                                  _pytree.tree_structure(params))
    _assert_trees_close(tree, want["grads"], **TOL)


# ---------------------------------------------------------------------------
# 4. the trainer end to end, and a session at the expert granularity
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ref_run(setup):
    """The reference's ``LMAdapter.make_trainer(params, masks)`` stepped
    twice."""
    ad = RLMAdapter(setup["rcfg"], use_bsmm=True, bsmm_interpret=True,
                    **ADAPTER)
    trainer = ad.make_trainer(setup["rparams"], setup["masks"])
    return [dict(metrics=trainer.run(1, log_every=0),
                 params=trainer.state.params) for _ in range(2)]


def _assert_pruned_zero(params, masks):
    got = _port_by_path(params)
    for path, m in tmasks.flat_mask_items(masks):
        assert not np.any(got[path][np.asarray(m) == 0]), path


def test_lm_adapter_trainer_matches_reference(setup, ref_run):
    """``LMAdapter.make_trainer(params, masks).run`` on the MLA + MoE
    model, one step at a time: the reference's losses and parameters
    after each; pruned coordinates exactly zero; every expert product
    planned (the dense FFN, the experts and the shared expert)."""
    s = setup
    ad = LMAdapter(s["tcfg"], device="cpu", **ADAPTER)
    trainer = ad.make_trainer(_tparams(s, masked=False), s["masks"])
    assert ad.last_plan_stats.routed == 3 * 3
    first = _bridge.to_numpy(_tparams(s))
    for want in ref_run:
        metrics = trainer.run(1)
        np.testing.assert_allclose(metrics["loss"], want["metrics"]["loss"],
                                   **TOL)
        np.testing.assert_allclose(metrics["aux"], want["metrics"]["aux"],
                                   **TOL)
        _assert_trees_close(trainer.state.params, want["params"], **TOL)
    _assert_pruned_zero(trainer.state.params, s["masks"])
    moved = max(float(np.abs(a - b).max()) for a, b in zip(
        _bridge.tree_leaves(_bridge.to_numpy(trainer.state.params)),
        _bridge.tree_leaves(first)))
    assert moved > 5e-4          # the steps really changed the weights


def test_deepseek_adapter_and_expert_session():
    """``make_adapter("deepseek-v3-671b")`` names the moe family's
    schedule; a tiny session at the expert granularity kills whole
    experts and keeps every pruned coordinate at zero."""
    full = make_adapter("deepseek-v3-671b", scale="full", device="cpu")
    assert isinstance(full, LMAdapter) and full.recipe == "moe-full"
    assert full.family == "moe"
    assert full.granularities == ("expert", "filter", "channel", "index")
    ad = make_adapter("deepseek-v3-671b", scale="tiny", device="cpu",
                      steps=2)
    assert ad.recipe is None and ad.cfg.moe.num_experts == 8
    sess = PruningSession(ad, PruneConfig(max_iters=1,
                                          accuracy_tolerance=10.0),
                          granularities=("expert",))
    res = sess.run()
    assert [e.accepted for e in res.history] == [True]
    assert res.history[0].sparsity_after > 0
    dead = 0
    seg = res.masks["segments"][1][0]["moe"]
    for key in PROJ:
        m = seg[key]
        per_expert = m.reshape(*m.shape[:2], -1)
        whole = (per_expert.amax(-1) == per_expert.amin(-1))
        assert bool(whole.all()), key       # an expert lives or dies whole
        dead += int((per_expert.amax(-1) == 0).sum())
    assert dead > 0
    _assert_pruned_zero(res.params, res.masks)
    assert all(torch.isfinite(t).all() for t in _bridge.tree_leaves(
        res.params))


# ---------------------------------------------------------------------------
# the batched CUDA kernels against their plain versions (skip without a card)
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,M", [(3, 40), (3, 136), (2, 200), (5, 320)])
def test_cuda_batched_dx_dw_match_plain(cuda, dtype, E, M):
    """Each wrapper launches once on its rule's route; ragged rows per
    expert (136, 200) must not read the next expert's rows."""
    rng = np.random.default_rng(M)
    K, N = 256, 384
    bm = rng.random((K // 128, N // 128)) < 0.6
    bm[:, 1] = False
    plan = tb.make_tile_plan(np.repeat(np.repeat(bm, 128, 0), 128, 1))
    g = torch.from_numpy(rng.standard_normal((E, M, N))).to(cuda, dtype)
    w = torch.from_numpy(rng.standard_normal((E, K, N)) / 16).to(cuda, dtype)
    x = torch.from_numpy(rng.standard_normal((E, M, K))).to(cuda, dtype)
    tol = dict(rtol=1e-2, atol=1e-1) if dtype == torch.bfloat16 \
        else dict(rtol=1e-4, atol=1e-4)
    for fn, plain, a, b, kind in (
            (tb.bsmm_batched_dx, tb.bsmm_batched_dx_plain, g, w, "dx"),
            (tb.bsmm_batched_dw, tb.bsmm_batched_dw_plain, x, g, "dw")):
        route, _ = plan.route_and_splits(kind, M, dtype, E)
        n0, r0 = fn.launches, fn.launches_by_route[route]
        got = fn(a, b, plan)
        assert fn.launches == n0 + 1 and fn.launches_by_route[route] == r0 + 1
        torch.testing.assert_close(got, plain(a, b, plan), **tol)
        assert torch.equal(got, fn(a, b, plan))
