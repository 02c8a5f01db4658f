"""The port's int8 QAT for LMs against the reference's.

Fixed-point storage (``quantize``, ``dequantize``, ``qmatmul``,
``quantize_tree``, ``tree_bytes``, ``QTensor.nbytes``) on numpy-seeded
leaves: q and scales bitwise, products at 1e-5.  The straight-through
fake pass bitwise in float32, within one bf16 ulp in bfloat16 (XLA on
the CPU may keep the difference ``wq - w`` in excess precision; torch
rounds after each op).  ``LMAdapter.make_trainer(masks,
quantize_bits=8)`` on a tiny llama (2 layers, every projection tiling at
128, float32, the kernels' plain versions on the CPU) against the
reference's trainer (Pallas in interpret mode) at 1e-4 in loss and
parameters over 3 steps.  Tiny ``dense-full`` and ``moe-full`` sessions,
each prune stage cut to one round of 2 retrain steps, from the same
initial weights: the same events, bitwise-equal masks, scores within
1e-4, and the quantize stage accepted at 8 bits in both packages (gate
tolerance 10: on synthetic data the gate is not what is under test).
The dense session's QAT ticket loads both ways across the packages and
``api.cli finetune`` runs on it.  Each reference run happens once, in a
module fixture.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree

import repro.api.registry  # noqa: F401  (registers the tuned recipes)
import repro_torch.configs as tcfgs
from repro.api import PruningSession as RSession
from repro.api import get_recipe as r_get_recipe
from repro.api import make_adapter as r_make_adapter
from repro.api.adapters import LMAdapter as RLMAdapter
from repro.configs import PruneConfig as RPruneConfig
from repro.configs import get_arch, scaled_down
from repro.core import lottery as rlot
from repro.core import masks as rmasks
from repro.core import quantize as rq
from repro.models import transformer as rtfm
from repro_torch import _bridge
from repro_torch.api import LMAdapter, PruningSession, cli, get_recipe
from repro_torch.api import make_adapter
from repro_torch.configs import PruneConfig
from repro_torch.core import lottery as tlot
from repro_torch.core import masks as tmasks
from repro_torch.core import quantize as tq

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)          # the model, trainer, scores
PROD_TOL = dict(rtol=1e-5, atol=1e-5)     # qmatmul
SMALL = dict(dtype="float32", n_layers=2, d_model=256, n_heads=4,
             n_kv_heads=2, head_dim=64, d_ff=512)
PROJ = ("wq", "wk", "wv", "wo", "up", "gate", "down")
ADAPTER = dict(batch_size=2, seq_len=16, steps=3, peak_lr=1e-3, warmup=1)
# a tiny session: 2 steps a train, one eval batch
SESSION = dict(steps=2, batch_size=2, seq_len=16, eval_batches=1, warmup=2)
GATE = 10.0


def _ref_by_path(tree):
    return {rmasks.path_str(p): np.asarray(leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_by_path(tree):
    return {tmasks.path_str(p): _bridge.to_numpy(leaf) for p, leaf in
            _pytree.tree_flatten_with_path(tree)[0]}


def _port_masks(tree):
    return {p: _bridge.to_numpy(m) for p, m in tmasks.flat_mask_items(tree)}


def _assert_trees_close(port, ref, **tol):
    got, want = _port_by_path(port), _ref_by_path(ref)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


# ---------------------------------------------------------------------------
# fixed-point storage
# ---------------------------------------------------------------------------
def _leaf(shape, seed, dead=0.3):
    """A numpy leaf with a share of exact zeros (masked weights)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32)
    return w * (rng.random(shape) >= dead)


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("shape", [(256, 384), (3, 128, 256)])
def test_quantize_dequantize_qmatmul_match_reference(bits, shape):
    """Per-(layer, column) scales over axis -2, q and scales bitwise,
    masked weights to exact 0, ``qmatmul`` at 1e-5, ``nbytes`` equal."""
    w = _leaf(shape, seed=bits)
    rqt = rq.quantize(jnp.asarray(w), bits)
    tqt = tq.quantize(torch.from_numpy(w), bits)
    np.testing.assert_array_equal(tqt.q.numpy(), np.asarray(rqt.q))
    np.testing.assert_array_equal(tqt.scale.numpy(), np.asarray(rqt.scale))
    assert tqt.q.dtype == (torch.int8 if bits == 8 else torch.int16)
    assert tqt.scale.shape == (*shape[:-2], 1, shape[-1])
    assert not tqt.q.numpy()[w == 0].any()
    np.testing.assert_array_equal(
        tq.dequantize(tqt, torch.float32).numpy(),
        np.asarray(rq.dequantize(rqt, jnp.float32)))
    assert tqt.nbytes == rqt.nbytes
    # qmatmul takes one (in, out) weight: the first layer's of a stack
    i = (0,) * (len(shape) - 2)
    tq2 = tq.QTensor(tqt.q[i], tqt.scale[i])
    rq2 = rq.QTensor(rqt.q[i], rqt.scale[i])
    x = np.random.default_rng(1).standard_normal(
        (8, shape[-2])).astype(np.float32)
    np.testing.assert_allclose(
        tq.qmatmul(torch.from_numpy(x), tq2).numpy(),
        np.asarray(rq.qmatmul(jnp.asarray(x), rq2)), **PROD_TOL)


@pytest.fixture(scope="module")
def setup():
    rcfg = scaled_down(get_arch("llama3.2-3b"), **SMALL)
    tcfg = tcfgs.scaled_down(tcfgs.get_arch("llama3.2-3b"), **SMALL)
    rparams = rtfm.init_params(jax.random.PRNGKey(0), rcfg)
    params_np = jax.tree.map(np.asarray, rparams)
    rng = np.random.default_rng(0)

    def mk(path, a):
        if str(path[-1].key) not in PROJ:
            return None
        *lead, K, N = a.shape
        bm = rng.random((*lead, K // 128, N // 128)) < 0.5
        bm[..., 0] = False
        return np.repeat(np.repeat(bm, 128, -2), 128, -1).astype(np.float32)

    masks = jax.tree_util.tree_map_with_path(mk, params_np)
    return dict(rcfg=rcfg, tcfg=tcfg, masks=masks, params_np=params_np,
                rparams=rparams)


def _tparams(s, masked=True):
    p = _bridge.params_from_numpy(s["params_np"], device="cpu")
    return _bridge.apply_masks(p, s["masks"]) if masked else p


@pytest.mark.parametrize("bits", [8, 16])
def test_quantize_tree_and_tree_bytes_match_reference(setup, bits):
    """Over the llama tree (``lm_prunable`` leaves, stacked across the
    layers), masked: every QTensor bitwise, the other leaves untouched,
    and the stored bytes equal — also of a bf16 copy of the tree."""
    s = setup
    rp = rmasks.apply_masks(s["rparams"], s["masks"])
    tp = _tparams(s)
    rtree = rq.quantize_tree(rp, rmasks.lm_prunable, bits)
    ttree = tq.quantize_tree(tp, tmasks.lm_prunable, bits)
    # a QTensor's fields: JAX names them, the port's walk numbers them
    rflat = {k.replace("/.q", "/0").replace("/.scale", "/1"): v
             for k, v in _ref_by_path(rtree).items()}
    tflat = {p: _bridge.to_numpy(v)
             for p, v in tmasks.tree_flatten_with_path(ttree)}
    assert sorted(tflat) == sorted(rflat)
    assert sum(isinstance(leaf, tq.QTensor) for leaf in
               _pytree.tree_leaves(ttree, is_leaf=lambda x: isinstance(
                   x, tq.QTensor))) == len(PROJ)
    for k, v in rflat.items():
        np.testing.assert_array_equal(tflat[k], v, err_msg=k)
    assert tq.tree_bytes(ttree) == rq.tree_bytes(rtree)
    assert tq.tree_bytes(tp) == rq.tree_bytes(rp)
    rb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), rp)
    tb = _bridge.tree_map(lambda t: t.to(torch.bfloat16), tp)
    assert tq.tree_bytes(tb) == rq.tree_bytes(rb) < rq.tree_bytes(rp)
    assert tq.tree_bytes(tq.quantize_tree(tb, tmasks.lm_prunable, bits)) \
        == rq.tree_bytes(rq.quantize_tree(rb, rmasks.lm_prunable, bits))


def test_fake_quantize_is_straight_through_and_chunks_alike(monkeypatch):
    """The fake pass keeps masked zeros, passes the gradient unchanged,
    records no f32 temporaries in the graph (its result's only node is
    the add), and gives the same bits when a stacked leaf is quantized
    in slices of its leading axis."""
    w = torch.from_numpy(_leaf((5, 128, 256), seed=3))
    want = rq.fake_quantize(jnp.asarray(w.numpy()), 8)
    whole = tq.fake_quantize(w, 8)
    np.testing.assert_array_equal(whole.numpy(), np.asarray(want))
    monkeypatch.setattr(tq, "_CHUNK_ELEMS", 2 * 128 * 256)
    assert len(tq._slices(w)) == 3
    np.testing.assert_array_equal(tq.fake_quantize(w, 8).numpy(),
                                  whole.numpy())
    leaf = w.clone().requires_grad_(True)
    out = tq.fake_quantize(leaf, 8)
    assert type(out.grad_fn).__name__ == "AddBackward0"
    assert not out.detach().numpy()[w.numpy() == 0].any()
    g = torch.randn_like(w)
    (gw,) = torch.autograd.grad(out, leaf, g)
    assert torch.equal(gw, g)


def test_fake_quantize_bf16_within_one_ulp():
    """bf16 leaves: the reference's XLA may skip the bf16 rounding
    between ``wq - w`` and ``w + …``; torch rounds after each op.  Held
    at one bf16 ulp of each weight (2^-7 relative), zeros exact."""
    w = _leaf((256, 384), seed=5)
    rw = jnp.asarray(w).astype(jnp.bfloat16)
    tw = torch.from_numpy(w).to(torch.bfloat16)
    want = np.asarray(rq.fake_quantize(rw, 8)).astype(np.float32)
    got = tq.fake_quantize(tw, 8).float().numpy()
    ulp = np.abs(want) * 2.0 ** -7
    assert np.all(np.abs(got - want) <= ulp)
    assert not got[w == 0].any()


# ---------------------------------------------------------------------------
# the QAT trainer
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ref_qat_run(setup):
    """The reference's ``make_trainer(params, masks, quantize_bits=8)``
    stepped three times, block-sparse (Pallas in interpret mode)."""
    ad = RLMAdapter(setup["rcfg"], use_bsmm=True, bsmm_interpret=True,
                    **ADAPTER)
    trainer = ad.make_trainer(setup["rparams"], setup["masks"],
                              quantize_bits=8)
    return [dict(metrics=trainer.run(1, log_every=0),
                 params=trainer.state.params) for _ in range(3)]


def test_qat_trainer_matches_reference(setup, ref_qat_run):
    s = setup
    ad = LMAdapter(s["tcfg"], device="cpu", use_bsmm=True, **ADAPTER)
    trainer = ad.make_trainer(_tparams(s, masked=False), s["masks"],
                              quantize_bits=8)
    assert ad.last_plan_stats.routed == len(PROJ)
    for want in ref_qat_run:
        metrics = trainer.run(1)
        np.testing.assert_allclose(metrics["loss"], want["metrics"]["loss"],
                                   **TOL)
        _assert_trees_close(trainer.state.params, want["params"], **TOL)
    got = _port_by_path(trainer.state.params)
    for path, m in tmasks.flat_mask_items(s["masks"]):
        assert not np.any(got[path][np.asarray(m) == 0]), path
    # the plain (non-QAT) loss differs: the fake pass really ran
    plain = LMAdapter(s["tcfg"], device="cpu", **ADAPTER).make_trainer(
        _tparams(s, masked=False), s["masks"]).run(1)
    assert plain["loss"] != ref_qat_run[0]["metrics"]["loss"]


# ---------------------------------------------------------------------------
# sessions through the quantize stage
# ---------------------------------------------------------------------------
def _cut(recipe):
    """One round of 2 retrain steps a prune stage, as ``chip_smoke``'s
    ``lm_session`` cuts the family recipe."""
    recipe = recipe.with_retrain_steps(2)
    return recipe.replace(stages=tuple(
        dataclasses.replace(st, max_rounds=1) if st.kind == "prune" else st
        for st in recipe.stages))


# (arch, recipe, the config's cut): dense-full on the registered tiny
# llama (what ``api.cli --scale tiny`` builds), moe-full on deepseek-v3
# tiny at 2 layers (one dense, one MoE layer)
SESSIONS = {"dense-full": ("llama3.2-3b", None),
            "moe-full": ("deepseek-v3-671b", 2)}


def _session_configs(recipe):
    arch, layers = SESSIONS[recipe]
    if layers is None:
        return arch, arch
    return (scaled_down(get_arch(arch), dtype="float32", n_layers=layers),
            tcfgs.scaled_down(tcfgs.get_arch(arch), dtype="float32",
                              n_layers=layers))


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    """Each recipe's session in both packages from the reference's
    initial weights; the reference's and the port's tickets exported."""
    out = {}
    for recipe in SESSIONS:
        rarch, tarch = _session_configs(recipe)
        radapter = r_make_adapter(rarch, scale="tiny", **SESSION)
        w0 = radapter.init_params(jax.random.PRNGKey(0))
        rsess = RSession(radapter, RPruneConfig(accuracy_tolerance=GATE),
                         recipe=_cut(r_get_recipe(recipe)))
        rres = rsess.run()
        tadapter = make_adapter(tarch, scale="tiny", device="cpu", **SESSION)
        tw0 = _bridge.params_from_numpy(jax.tree.map(np.asarray, w0),
                                        device="cpu")
        tadapter.init_params = lambda gen, w=tw0: w
        tsess = PruningSession(tadapter, PruneConfig(accuracy_tolerance=GATE),
                               recipe=_cut(get_recipe(recipe)))
        tres = tsess.run()
        d = tmp_path_factory.mktemp(recipe)
        rsess.export_ticket(str(d / "ref"))
        tsess.export_ticket(str(d / "port"))
        out[recipe] = dict(rsess=rsess, rres=rres, tsess=tsess, tres=tres,
                           w0=w0, dir=d)
    return out


@pytest.mark.parametrize("recipe", list(SESSIONS))
def test_session_through_quantize_matches_reference(sessions, recipe):
    s = sessions[recipe]
    rh, th = s["rres"].history, s["tres"].history
    assert [e.kind for e in th][-1] == "quantize"
    assert len(th) == len(rh) == len(s["tsess"].recipe.stages)
    for t, r in zip(th, rh):
        assert (t.iteration, t.kind, t.stage, t.stage_idx, t.granularity,
                t.accepted) == (r.iteration, r.kind, r.stage, r.stage_idx,
                                r.granularity, r.accepted)
        assert t.sparsity_before == r.sparsity_before
        assert t.sparsity_after == r.sparsity_after
        np.testing.assert_allclose(t.accuracy, r.accuracy, **TOL)
    q = th[-1]
    assert q.granularity == "int8" and q.accepted
    assert s["tsess"].quantize_bits == s["rsess"].quantize_bits == 8
    got, want = _port_masks(s["tres"].masks), _ref_by_path(s["rres"].masks)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert s["tres"].sparsity == s["rres"].sparsity > 0
    assert s["tsess"].ticket_meta()["quantize_bits"] == 8
    assert s["tsess"].hardware_report().weight_bytes() == \
        s["rsess"].hardware_report().weight_bytes()


def test_qat_ticket_loads_both_ways_and_finetunes(sessions, capsys):
    """The dense session's tickets: the reference's and the port's load
    in both packages to the same weights, masks and metadata
    (``quantize_bits`` 8); ``api.cli finetune`` (QAT, from the ticket's
    bits) and ``api.cli report`` run on the port's."""
    s = sessions["dense-full"]
    w0 = s["w0"]
    tw0 = _bridge.params_from_numpy(jax.tree.map(np.asarray, w0),
                                    device="cpu")
    rtmpl_m = rmasks.make_masks(w0, rmasks.lm_prunable)
    ttmpl_m = tmasks.make_masks(tw0, tmasks.lm_prunable)
    for src in ("ref", "port"):
        path = str(s["dir"] / src)
        assert tlot.ticket_meta(path) == rlot.ticket_meta(path)
        assert tlot.ticket_meta(path)["quantize_bits"] == 8
        tw, tm = tlot.import_ticket(path, tw0, ttmpl_m)
        rw, rm = rlot.import_ticket(path, w0, rtmpl_m)
        _assert_trees_close(tw, rw, rtol=0, atol=0)
        got, want = _port_masks(tm), _ref_by_path(rm)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    common = ["--arch", "llama3.2-3b", "--scale", "tiny", "--device", "cpu",
              "--ticket", str(s["dir"] / "port"), "--json"]
    capsys.readouterr()
    assert cli.main(["finetune", *common, "--steps", "2"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["event"] == "finetune" and out["quantize_bits"] == 8
    assert np.isfinite(out["loss"]) and np.isfinite(out["score"])
    assert cli.main(["report", *common]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["quantize_bits"] == 8
    assert rep["weight_bytes"]["quantized_bytes"] < \
        rep["weight_bytes"]["dense_bytes"]
