"""The port's CNN Algorithm-1 slice against the reference.

``repro_torch``'s CNN model, crossbar accounting, granularity
strategies, prune step, sessions, checkpoints and tickets run on the
CPU against live calls of ``repro`` on the same numpy inputs (the
reference's parameters bridged in through ``_bridge.params_from_numpy``).
Each test states its tolerance: the model at 1e-4 (float32, sums taken
in another order), numpy copies (strategies, crossbar, recipes) exactly.
"""
import dataclasses
import importlib
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import CNNAdapter as RCNNAdapter
from repro.api import FunctionAdapter as RFunctionAdapter
from repro.api import PruningSession as RSession
from repro.api import recipes as rrecipes
from repro.checkpoint import CheckpointManager as RCkpt
from repro.configs import CNNConfig as RCNNConfig
from repro.configs import ConvSpec as RConvSpec
from repro.configs import PruneConfig as RPruneConfig
from repro.configs import get_cnn as r_get_cnn
from repro.configs import scaled_down_cnn as r_scaled_down_cnn
from repro.core import crossbar as rxb
from repro.core import hardware as rhw
from repro.core import lottery as rlot
from repro.core import quantize as rq
from repro.core import scoring as rsc
from repro.core import strategies as rstr
from repro.core.algorithm import prune_step as r_prune_step
from repro.core.masks import cnn_conv_path as r_conv_path
from repro.core.masks import cnn_prunable as r_cnn_prunable
from repro.core.masks import make_masks as r_make_masks
from repro.core.masks import path_str as r_path_str
from repro.core.masks import sparsity_fraction as r_sparsity
from repro.data import SyntheticImages as RSyntheticImages
from repro.models import cnn as rcnn
from repro.train.plans import cnn_train_plan as r_cnn_train_plan
from repro_torch import _bridge
from repro_torch.api import (CNNAdapter, FunctionAdapter, LMAdapter,
                             PruningSession)
from repro_torch.api import make_adapter
from repro_torch.api import ServeUnsupported
from repro_torch.api import recipes as trecipes
from repro_torch.api.registry import get_family
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import CNNConfig, ConvSpec, PruneConfig, get_cnn
from repro_torch.configs import scaled_down_cnn
from repro_torch.core import crossbar as txb
from repro_torch.core import hardware as thw
from repro_torch.core import lottery as tlot
from repro_torch.core import masks as tmasks
from repro_torch.core import quantize as tq
from repro_torch.core import scoring as tsc
from repro_torch.core import strategies as tstr
from repro_torch.core.algorithm import prune_step as t_prune_step
from repro_torch.data import SyntheticImages
from repro_torch.models import cnn as tcnn
from repro_torch.optim import constant, sgd
from repro_torch.train import Trainer, cnn_train_plan

torch.set_num_threads(2)

# ``repro.core`` (and so ``repro_torch.core``) re-exports the function
# ``sparsity`` under the module's name
rsp = importlib.import_module("repro.core.sparsity")
tsp = importlib.import_module("repro_torch.core.sparsity")

ROOT = Path(__file__).resolve().parent.parent
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree):
    """{path: numpy} of a reference (JAX) pytree."""
    out = {}

    def visit(path, leaf):
        out[r_path_str(path)] = np.asarray(leaf)
        return leaf

    jax.tree_util.tree_map_with_path(visit, tree)
    return out


def _tflat(tree):
    """{path: numpy} of a port pytree (None leaves dropped)."""
    return {p: _bridge.to_numpy(v)
            for p, v in tmasks.tree_flatten_with_path(tree) if v is not None}


def _assert_trees_close(got, want, **tol):
    g, w = _tflat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], err_msg=k, **tol)


def _pair(name):
    """(reference config, port config) of a scaled-down registered CNN."""
    return (r_scaled_down_cnn(r_get_cnn(name)),
            scaled_down_cnn(get_cnn(name)))


def _model(name, seed=0):
    rcfg, tcfg = _pair(name)
    rparams, rstate = rcnn.init_params(jax.random.PRNGKey(seed), rcfg)
    tparams = _bridge.params_from_numpy(_np_tree(rparams), device="cpu")
    tstate = _bridge.params_from_numpy(_np_tree(rstate), device="cpu")
    return rcfg, tcfg, rparams, rstate, tparams, tstate


# ---------------------------------------------------------------------------
# configs and data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["vgg11", "vgg16", "vgg19", "resnet18",
                                  "scaled_down_cnn"])
def test_cnn_configs_match_reference(name):
    rc, tc = r_get_cnn(name), get_cnn(name)
    assert dataclasses.asdict(tc) == dataclasses.asdict(rc)
    assert tc.param_count() == rc.param_count()
    assert dataclasses.asdict(scaled_down_cnn(tc, max_channels=8)) == \
        dataclasses.asdict(r_scaled_down_cnn(rc, max_channels=8))
    if name == "vgg11":
        assert tc.param_count() == 9_222_848


def test_synthetic_images_bit_identical():
    for kw in ({}, {"seed": 3, "noise": 0.25, "image_size": 16}):
        a = SyntheticImages(**kw).batch(5, 7)
        b = RSyntheticImages(**kw).batch(5, 7)
        for k in ("images", "labels"):
            np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# the model: parity traps first (SAME padding, BatchNorm), then the
# whole forward, loss and gradients at 1e-4
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("size,k,stride", [(8, 3, 2), (7, 3, 2), (8, 1, 2),
                                           (9, 3, 1), (6, 1, 1)])
def test_conv2d_same_padding_matches_reference(size, k, stride):
    """XLA SAME pads a stride-2 3x3 conv on an even size by (0, 1)."""
    rng = np.random.default_rng(size * 10 + k)
    x = rng.standard_normal((2, size, size + 1, 3)).astype(np.float32)
    w = rng.standard_normal((k, k, 3, 5)).astype(np.float32)
    want = rcnn.conv2d(jnp.asarray(w), jnp.asarray(x), stride)
    got = tcnn.conv2d(torch.from_numpy(w), torch.from_numpy(x), stride)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_matches_reference(train):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((4, 5, 5, 6)) * 3 + 1).astype(np.float32)
    params = {"scale": rng.standard_normal(6).astype(np.float32),
              "bias": rng.standard_normal(6).astype(np.float32)}
    state = {"mean": rng.standard_normal(6).astype(np.float32),
             "var": rng.random(6).astype(np.float32) + 0.5}
    ry, rs = rcnn.batchnorm(jax.tree.map(jnp.asarray, params),
                            jax.tree.map(jnp.asarray, state),
                            jnp.asarray(x), train)
    ty, ts = tcnn.batchnorm(_bridge.params_from_numpy(params, device="cpu"),
                            _bridge.params_from_numpy(state, device="cpu"),
                            torch.from_numpy(x), train)
    np.testing.assert_allclose(ty.numpy(), np.asarray(ry), rtol=1e-5,
                               atol=1e-5)
    _assert_trees_close(ts, rs, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["vgg11", "resnet18"])
def test_forward_loss_and_grads_match_reference(name):
    """vgg11-tiny, and resnet18 scaled with its stride-2 stages and
    projection shortcuts: logits, BN state (train and eval), loss and
    every gradient at 1e-4."""
    rcfg, tcfg, rparams, rstate, tparams, tstate = _model(name)
    b = RSyntheticImages().batch(0, 4)
    rbatch = {k: jnp.asarray(v) for k, v in b.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in b.items()}

    def rloss(p):
        return rcnn.loss_fn(p, rstate, rcfg, rbatch, train=True)

    (rl, (rs, rlogits)), rg = jax.jit(jax.value_and_grad(
        rloss, has_aux=True))(rparams)
    leaves = _bridge.tree_leaves(tparams)
    req = [t.clone().requires_grad_(True) for t in leaves]
    tl, (ts, tlogits) = tcnn.loss_fn(_bridge.tree_unflatten(tparams, req),
                                     tstate, tcfg, tbatch, train=True)
    tg = _bridge.tree_unflatten(tparams, torch.autograd.grad(tl, req))
    np.testing.assert_allclose(tl.item(), float(rl), rtol=1e-5)
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(rlogits),
                               **MODEL_TOL)
    _assert_trees_close(ts, rs, **MODEL_TOL)
    _assert_trees_close(tg, rg, **MODEL_TOL)
    # eval mode reads the updated running stats and changes nothing
    re_logits, re_state = rcnn.forward(rparams, rs, rcfg, rbatch["images"])
    with torch.no_grad():
        te_logits, te_state = tcnn.forward(tparams, ts, tcfg,
                                           tbatch["images"])
    np.testing.assert_allclose(te_logits.numpy(), np.asarray(re_logits),
                               **MODEL_TOL)
    _assert_trees_close(te_state, re_state, **MODEL_TOL)
    acc_r = rcnn.accuracy(rparams, rs, rcfg, rbatch["images"],
                          rbatch["labels"])
    acc_t = tcnn.accuracy(tparams, ts, tcfg, tbatch["images"],
                          tbatch["labels"])
    assert acc_t.item() == pytest.approx(float(acc_r))


def test_fc_tiling_cnn_plan_matches_dense_and_reference():
    """A CNN whose GAP width tiles 128 routes its FC layer through the
    block-sparse plan: the same plan as the reference's, and loss and
    gradients equal to the dense path on pre-masked weights (1e-4)."""
    rcfg = RCNNConfig(name="fc-128", family="cnn",
                      convs=(RConvSpec(128),), fc=(256,), num_classes=10,
                      image_size=8)
    tcfg = CNNConfig(name="fc-128", family="cnn", convs=(ConvSpec(128),),
                     fc=(256,), num_classes=10, image_size=8)
    rng = np.random.default_rng(5)
    bm = rng.random((1, 2)) < 0.5
    bm[0, 0] = True
    m1 = np.kron(bm, np.ones((128, 128), np.float32)).astype(np.float32)
    rparams, rstate = rcnn.init_params(jax.random.PRNGKey(0), rcfg)
    pn = _np_tree(rparams)
    pn["fc"][0]["w"] = pn["fc"][0]["w"] * m1
    tparams = _bridge.params_from_numpy(pn, device="cpu")
    tstate = _bridge.params_from_numpy(_np_tree(rstate), device="cpu")
    masks = {"fc": [{"w": m1, "b": None}], "head": None}
    tplans, tstats = cnn_train_plan(masks)
    rplans, rstats = r_cnn_train_plan(masks)
    assert tstats.routed == rstats.routed == 1
    assert tplans["head"] is None
    np.testing.assert_array_equal(tplans["fc"][0].idx, rplans["fc"][0].idx)
    np.testing.assert_array_equal(tplans["fc"][0].counts,
                                  rplans["fc"][0].counts)
    b = RSyntheticImages(image_size=8).batch(1, 4)
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    out = {}
    for label, plans in (("plan", tplans), ("dense", None)):
        leaves = _bridge.tree_leaves(tparams)
        req = [t.clone().requires_grad_(True) for t in leaves]
        loss, _ = tcnn.loss_fn(_bridge.tree_unflatten(tparams, req), tstate,
                               tcfg, batch, train=True, plans=plans)
        grads = torch.autograd.grad(loss, req)
        out[label] = (loss.item(), _bridge.tree_unflatten(tparams, grads))
    np.testing.assert_allclose(out["plan"][0], out["dense"][0], rtol=1e-5)
    gp, gd = out["plan"][1], out["dense"][1]
    gp["fc"][0]["w"] = gp["fc"][0]["w"] * torch.from_numpy(m1)
    gd["fc"][0]["w"] = gd["fc"][0]["w"] * torch.from_numpy(m1)
    for a, c in zip(_bridge.tree_leaves(gp), _bridge.tree_leaves(gd)):
        torch.testing.assert_close(a, c, **MODEL_TOL)
    rl, _ = rcnn.loss_fn(jax.tree.map(jnp.asarray, pn), rstate, rcfg,
                         {k: jnp.asarray(v) for k, v in b.items()},
                         train=True, plans=rplans)
    np.testing.assert_allclose(out["plan"][0], float(rl), rtol=1e-5)


# ---------------------------------------------------------------------------
# numpy copies: strategies, scoring, prune_step, crossbar accounting
# ---------------------------------------------------------------------------
_LEAVES = {"conv": (np.zeros((3, 3, 16, 40)), True),
           "dense": (np.zeros((300, 192)), False),
           "stack": (np.zeros((2, 128, 256)), False)}


def test_strategy_registries_agree():
    assert tstr.available_strategies() == rstr.available_strategies()
    assert tstr.PAPER_SCHEDULE == rstr.PAPER_SCHEDULE


@pytest.mark.parametrize("gran", ["filter", "channel", "index", "ltp",
                                  "block", "cap", "xbar", "expert"])
@pytest.mark.parametrize("geom", [(128, 128), (64, 256)])
def test_every_strategy_gives_identical_groups_and_masks(gran, geom):
    rng = np.random.default_rng(7)
    for path, (shape_src, conv) in _LEAVES.items():
        path = "moe/up" if path == "stack" else path
        w = rng.standard_normal(shape_src.shape).astype(np.float32)
        mask = (rng.random(w.shape) < 0.8).astype(np.float32)
        kw = dict(conv=conv, block=32)
        rg = rstr.get_strategy(gran).score(
            path, w, mask, geom=rstr.TileGeometry(*geom), **kw)
        tg = tstr.get_strategy(gran).score(
            path, w, mask, geom=tstr.TileGeometry(*geom), **kw)
        for f in ("scores", "sizes", "alive"):
            np.testing.assert_array_equal(getattr(tg, f), getattr(rg, f))
        kill = rng.random(rg.scores.shape) < 0.3
        np.testing.assert_array_equal(tsc.zero_groups(mask, tg, kill),
                                      rsc.zero_groups(mask, rg, kill))


@pytest.mark.parametrize("gran", ["filter", "channel", "index", "ltp",
                                  "block", "cap", "xbar"])
def test_prune_step_on_a_cnn_matches_reference(gran):
    """The same weights and masks give the same new masks: global
    selection walks the leaves in the reference's order."""
    rcfg, tcfg, rparams, _, tparams, _ = _model("resnet18", seed=1)
    geom = rstr.TileGeometry(64, 128)
    rmasks = r_make_masks(rparams, r_cnn_prunable)
    rmasks = r_prune_step(rparams, rmasks, "filter", 0.2, r_conv_path,
                          geometry=geom)
    rnew = r_prune_step(rparams, rmasks, gran, 0.3, r_conv_path,
                        geometry=geom)
    tmasks_ = tmasks.tree_map_with_path(
        lambda p, m: None if m is None else torch.from_numpy(
            np.array(m)), _np_tree(rmasks))
    tnew = t_prune_step(tparams, tmasks_, gran, 0.3, tmasks.cnn_conv_path,
                        geometry=tstr.TileGeometry(64, 128))
    g, w = _tflat(tnew), _flat(rnew)
    assert sorted(g) == sorted(k for k in w)
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert tmasks.sparsity_fraction(tnew) == r_sparsity(rnew)


@pytest.mark.parametrize("xr,xc", [(128, 128), (64, 256)])
def test_xbar_stats_and_hardware_report_match_reference(xr, xc):
    rcfg, tcfg, rparams, _, tparams, _ = _model("resnet18", seed=2)
    rmasks = r_make_masks(rparams, r_cnn_prunable)
    rmasks = r_prune_step(rparams, rmasks, "channel", 0.4, r_conv_path)
    rmasks = r_prune_step(rparams, rmasks, "index", 0.3, r_conv_path)
    nm = _np_tree(rmasks)
    tm = tmasks.tree_map_with_path(
        lambda p, m: None if m is None else torch.from_numpy(np.array(m)), nm)
    for path, m in _flat(rmasks).items():
        conv = r_conv_path(path)
        mat = rxb.leaf_matrices(m, conv)[0][0] != 0
        assert dataclasses.asdict(txb.xbar_stats(mat, xr, xc)) == \
            dataclasses.asdict(rxb.xbar_stats(mat, xr, xc))
    vols_t = thw.cnn_activation_volumes(tcfg)
    vols_r = rhw.cnn_activation_volumes(rcfg)
    assert vols_t == vols_r
    rrep = rhw.analyze_masks(rmasks, r_conv_path, vols_r, xr, xc,
                             quant_bits=8)
    trep = thw.analyze_masks(tm, tmasks.cnn_conv_path, vols_t, xr, xc,
                             quant_bits=8)
    assert [l.path for l in trep.layers] == [l.path for l in rrep.layers]
    for a, b in zip(trep.layers, rrep.layers):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for f in ("cell_savings", "xbar_savings", "sparsity",
              "activation_savings", "xbars_needed_strict"):
        assert getattr(trep, f) == getattr(rrep, f), f
    assert trep.weight_bytes() == rrep.weight_bytes()
    assert trep.combined_xbar_savings() == rrep.combined_xbar_savings()
    assert tsp.summary(tm) == rsp.summary(rmasks)
    assert tsp.per_leaf_sparsity(tm) == rsp.per_leaf_sparsity(rmasks)


def test_fake_quantize_tree_matches_reference():
    """Straight-through int8/int16 fake quantization, exact: both round
    half to even and divide in float32."""
    _, _, rparams, _, tparams, _ = _model("vgg11", seed=3)
    for bits in (8, 16):
        want = rq.fake_quantize_tree(rparams, r_cnn_prunable, bits)
        got = tq.fake_quantize_tree(tparams, tmasks.cnn_prunable, bits)
        _assert_trees_close(got, want, rtol=0, atol=0)
    qt = tq.quantize(tparams["convs"][1]["w"], 8)
    rqt = rq.quantize(rparams["convs"][1]["w"], 8)
    np.testing.assert_array_equal(qt.q.numpy(), np.asarray(rqt.q))
    np.testing.assert_array_equal(qt.scale.numpy(), np.asarray(rqt.scale))


# ---------------------------------------------------------------------------
# sessions: scripted (FunctionAdapter) and CNNAdapter, against the
# reference's, plus resume
# ---------------------------------------------------------------------------
def _script_params(seed=0):
    r = np.random.RandomState(seed)
    return {"a": r.randn(3, 3, 4, 8).astype(np.float32),
            "b": r.randn(256, 128).astype(np.float32)}


def _scripted(pkg, params, cliff=0.45):
    """Deterministic adapter: accuracy collapses past ``cliff``
    sparsity (numpy closures, one per package)."""
    if pkg == "ref":
        return RFunctionAdapter(
            params=jax.tree.map(jnp.asarray, params),
            train_fn=lambda p, m: p,
            eval_fn=lambda p, m: 1.0 if r_sparsity(m) < cliff else 0.5,
            prunable=lambda p, l: l.ndim >= 2, conv_pred=lambda p: p == "a")
    return FunctionAdapter(
        params=_bridge.params_from_numpy(params, device="cpu"),
        train_fn=lambda p, m: p,
        eval_fn=lambda p, m: 1.0 if tmasks.sparsity_fraction(m) < cliff
        else 0.5,
        prunable=lambda p, l: l.ndim >= 2, conv_pred=lambda p: p == "a")


def _events(history):
    return [dataclasses.asdict(e) for e in history]


@pytest.mark.parametrize("recipe", [None, "paper-xbar", "ablation"])
def test_function_adapter_session_matches_reference(recipe):
    params = _script_params()
    cfg_kw = dict(prune_fraction=0.25, max_iters=20)
    rres = RSession(_scripted("ref", params), RPruneConfig(**cfg_kw),
                    recipe=recipe, baseline_accuracy=1.0).run()
    tres = PruningSession(_scripted("port", params), PruneConfig(**cfg_kw),
                          recipe=recipe, baseline_accuracy=1.0).run()
    assert _events(tres.history) == _events(rres.history)
    assert tres.recipe == rres.recipe
    _assert_trees_close(tres.masks, rres.masks, rtol=0, atol=0)
    _assert_trees_close(tres.params, rres.params, rtol=0, atol=0)


def test_session_resumes_to_identical_result(tmp_path):
    params = _script_params()
    cfg = PruneConfig(prune_fraction=0.25, max_iters=20)
    full = PruningSession(_scripted("port", params), cfg,
                          baseline_accuracy=1.0).run()

    class Preempted(Exception):
        pass

    def preempt(event):
        if event.iteration == 2:
            raise Preempted()

    with pytest.raises(Preempted):
        PruningSession(_scripted("port", params), cfg, baseline_accuracy=1.0,
                       ckpt_dir=str(tmp_path), callbacks=[preempt]).run()
    resumed = PruningSession(_scripted("port", params), cfg,
                             baseline_accuracy=1.0,
                             ckpt_dir=str(tmp_path)).run()
    assert _events(resumed.history) == _events(full.history)
    for a, b in zip(_bridge.tree_leaves(full.masks),
                    _bridge.tree_leaves(resumed.masks)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # the reference resumes the port's checkpoint: same on-disk format
    rres = RSession(_scripted("ref", params), RPruneConfig(
        prune_fraction=0.25, max_iters=20), baseline_accuracy=1.0,
        ckpt_dir=str(tmp_path)).run()
    assert _events(rres.history) == _events(full.history)


def test_cnn_adapter_session_matches_reference():
    """scaled_down_cnn, 2 rounds, from the same w_init and data: the
    same accept/undo sequence and granularities; sparsity within 1e-6
    and accuracies within 1/16 (one of the 16 held-out images) —
    training runs in another order of float32 sums in each package."""
    rcfg = r_get_cnn("scaled_down_cnn")
    rparams, rstate = rcnn.init_params(jax.random.PRNGKey(0), rcfg)
    tparams = _bridge.params_from_numpy(_np_tree(rparams), device="cpu")
    tstate = _bridge.params_from_numpy(_np_tree(rstate), device="cpu")
    kw = dict(steps=6, batch_size=8, eval_batches=1, eval_batch_size=16)

    class Bridged(CNNAdapter):
        def init_params(self, gen):
            self._bn0 = self._bn = tstate
            return tparams

    radapter = RCNNAdapter(rcfg, **kw)
    tadapter = Bridged(get_cnn("scaled_down_cnn"), device="cpu", **kw)
    assert tadapter.use_bsmm is False      # CPU: dense FC, like the reference
    rres = RSession(radapter, RPruneConfig(max_iters=2)).run()
    tres = PruningSession(tadapter, PruneConfig(max_iters=2)).run()
    assert len(tres.history) == len(rres.history) == 2
    for t, r in zip(tres.history, rres.history):
        assert (t.granularity, t.accepted, t.stage) == \
            (r.granularity, r.accepted, r.stage)
        assert t.sparsity_after == pytest.approx(r.sparsity_after, abs=1e-6)
        assert abs(t.accuracy - r.accuracy) <= 1 / 16
    assert np.isfinite(tadapter.last_metrics["loss"])


# ---------------------------------------------------------------------------
# checkpoints, Trainer resume, tickets across packages
# ---------------------------------------------------------------------------
def test_checkpoints_load_across_packages(tmp_path):
    tree = {"b": np.arange(6, dtype=np.float32).reshape(2, 3),
            "a": [np.int32(4), None, {"z": np.ones(3, np.float64)}]}
    CheckpointManager(str(tmp_path / "t")).save(3, _bridge.params_from_numpy(
        {"b": tree["b"]}, device="cpu") | {"a": tree["a"]})
    RCkpt(str(tmp_path / "r")).save(3, jax.tree.map(
        lambda x: x, tree, is_leaf=lambda x: x is None))
    for src in ("t", "r"):
        step, got = RCkpt(str(tmp_path / src)).restore(
            {"b": np.zeros((2, 3), np.float32),
             "a": [np.int32(0), None, {"z": np.zeros(3)}]})
        assert step == 3
        np.testing.assert_array_equal(got["b"], tree["b"])
        np.testing.assert_array_equal(got["a"][2]["z"], tree["a"][2]["z"])
        step, got = CheckpointManager(str(tmp_path / src)).restore(
            {"b": torch.zeros(2, 3), "a": [np.int32(0), None,
                                           {"z": np.zeros(3)}]})
        assert step == 3 and torch.is_tensor(got["b"])
        np.testing.assert_array_equal(got["b"].numpy(), tree["b"])
        assert int(got["a"][0]) == 4
    a = sorted(p.name for p in (tmp_path / "t" / "step_00000003").iterdir())
    b = sorted(p.name for p in (tmp_path / "r" / "step_00000003").iterdir())
    assert a == b


def test_trainer_checkpoint_save_and_resume(tmp_path):
    """Trainer(ckpt_dir=) saves params, optimizer state, step and aux;
    a new Trainer resumes at that step, and the reference's manager
    reads what it wrote."""
    params = {"w": torch.ones(4, 3)}
    data = ({"x": np.full((2, 4), float(i), np.float32)} for i in range(10))

    def loss_fn(p, state, batch):
        loss = (batch["x"] @ p["w"]).square().mean()
        return loss, ({"n": state["n"] + 1}, {})

    def trainer():
        return Trainer(loss_fn=loss_fn, optimizer=sgd(constant(0.01)),
                       params=params, data_iter=data,
                       ckpt_dir=str(tmp_path), ckpt_every=2,
                       aux_state={"n": torch.zeros(())}, device="cpu")

    first = trainer()
    first.run(3)
    assert first.state.step == 3
    again = trainer()
    assert again.state.step == 3 and again.state.aux["n"].item() == 3
    torch.testing.assert_close(again.state.params["w"],
                               first.state.params["w"])
    step, tree = RCkpt(str(tmp_path)).restore(
        {"params": {"w": np.zeros((4, 3), np.float32)},
         "opt_state": {"mu": {"w": np.zeros((4, 3), np.float32)},
                       "step": np.zeros((), np.int32)},
         "step": np.zeros((), np.int32), "aux": {"n": np.zeros(())}})
    assert step == 3 and int(tree["step"]) == 3
    np.testing.assert_allclose(tree["params"]["w"],
                               first.state.params["w"].numpy())
    np.testing.assert_allclose(tree["opt_state"]["mu"]["w"],
                               first.state.opt_state["mu"]["w"].numpy())


@pytest.mark.parametrize("async_ckpt", [True, False])
def test_trainer_keep_prunes_old_checkpoints(tmp_path, async_ckpt):
    """Trainer(ckpt_every=1, keep=1) leaves one committed step on disk,
    as the reference's Trainer does on the same run (synchronous: the
    reference's last periodic async save and its final blocking save of
    the same step race); ``donate`` is accepted (a no-op in the port)."""
    from repro import optim as ropt
    from repro.train.loop import Trainer as RTrainer

    def data():
        return ({"x": np.full((2, 4), float(i), np.float32)}
                for i in range(10))

    Trainer(loss_fn=lambda p, b: ((b["x"] @ p["w"]).square().mean(), {}),
            optimizer=sgd(constant(0.01)), params={"w": torch.ones(4, 3)},
            data_iter=data(), ckpt_dir=str(tmp_path / "t"), ckpt_every=1,
            keep=1, async_ckpt=async_ckpt, donate=False,
            device="cpu").run(3, log_every=0)
    RTrainer(loss_fn=lambda p, b: (jnp.square(b["x"] @ p["w"]).mean(), {}),
             optimizer=ropt.sgd(ropt.constant(0.01)),
             params={"w": jnp.ones((4, 3))}, data_iter=data(),
             ckpt_dir=str(tmp_path / "r"), ckpt_every=1, keep=1,
             async_ckpt=False, donate=False).run(3, log_every=0)
    got = sorted(p.name for p in (tmp_path / "t").iterdir())
    want = sorted(p.name for p in (tmp_path / "r").iterdir())
    assert got == want
    assert [n for n in got if n.startswith("step_")
            and not n.endswith(".COMMITTED")] == ["step_00000003"]


def test_tickets_load_across_packages(tmp_path):
    rcfg, tcfg, rparams, _, tparams, _ = _model("resnet18", seed=4)
    rmasks = r_prune_step(rparams, r_make_masks(rparams, r_cnn_prunable),
                          "filter", 0.3, r_conv_path)
    tm = tmasks.tree_map_with_path(
        lambda p, m: None if m is None else torch.from_numpy(
            np.array(m)), _np_tree(rmasks))
    meta = {"recipe": {"name": "x"}, "quantize_bits": 8}
    rlot.export_ticket(str(tmp_path / "r"), rlot.snapshot(rparams), rmasks,
                       meta=meta)
    tlot.export_ticket(str(tmp_path / "t"), tlot.snapshot(tparams), tm,
                       meta=meta)
    tmpl_m = tmasks.make_masks(tparams, tmasks.cnn_prunable)
    for src in ("r", "t"):
        w, m = tlot.import_ticket(str(tmp_path / src), tparams, tmpl_m)
        _assert_trees_close(w, rparams, rtol=0, atol=0)
        _assert_trees_close(m, rmasks, rtol=0, atol=0)
        rw, rm = rlot.import_ticket(str(tmp_path / src), rparams,
                                    r_make_masks(rparams, r_cnn_prunable))
        _assert_trees_close(tw := _bridge.params_from_numpy(
            _np_tree(rw), device="cpu"), rparams, rtol=0, atol=0)
        assert tw is not None
        _assert_trees_close(tmasks.tree_map_with_path(
            lambda p, x: None if x is None else torch.from_numpy(
                np.array(x)), _np_tree(rm)), rmasks, rtol=0, atol=0)
        assert tlot.ticket_meta(str(tmp_path / src)) == \
            rlot.ticket_meta(str(tmp_path / src)) == meta
    with np.load(tmp_path / "t" / "ticket.npz") as a, \
            np.load(tmp_path / "r" / "ticket.npz") as b:
        assert sorted(a.files) == sorted(b.files)
    rewound = tlot.rewind(tlot.snapshot(tparams), tm)
    for k, v in _tflat(rewound).items():
        assert np.isfinite(v).all(), k


def test_session_export_finetune_and_report(tmp_path):
    """The path a user runs after a session: report, export, re-import,
    finetune (tiny vgg11 on the CPU)."""
    ad = make_adapter("vgg11", scale="tiny", device="cpu")
    sess = PruningSession(ad, PruneConfig(max_iters=1,
                                          xbar_rows=64, xbar_cols=64))
    res = sess.run()
    rep = sess.hardware_report()
    assert rep.layers[0].stats.xbar_rows == 64
    assert 0.0 <= rep.xbar_savings <= 1.0
    sess.export_ticket(str(tmp_path))
    assert tlot.ticket_meta(str(tmp_path))["arch"] == "vgg11-smoke"
    w, m = tlot.import_ticket(str(tmp_path), sess.init_params, res.masks)
    _assert_trees_close(m, _np_masks(res.masks), rtol=0, atol=0)
    tuned = sess.finetune(steps=2)
    assert all(torch.isfinite(t).all() for t in _bridge.tree_leaves(tuned))
    # a CNN ticket has no serving path: the reference's structured refusal
    with pytest.raises(ServeUnsupported, match="no prefill/decode pair"):
        sess.serve_engine()


def _np_masks(masks):
    """A port mask tree as numpy (for ``_assert_trees_close``)."""
    return tmasks.tree_map_with_path(
        lambda p, m: None if m is None else _bridge.to_numpy(m), masks)


# ---------------------------------------------------------------------------
# recipes, registry, devices, imports
# ---------------------------------------------------------------------------
def test_recipes_match_reference():
    import repro.api.registry  # noqa: F401  (registers the tuned recipes)
    assert trecipes.available_recipes() == rrecipes.available_recipes()
    for name in trecipes.available_recipes():
        assert trecipes.get_recipe(name).to_dict() == \
            rrecipes.get_recipe(name).to_dict()
    shim = trecipes.from_granularities(["filter", "index"], rate=0.3)
    assert shim.to_dict() == rrecipes.from_granularities(
        ["filter", "index"], rate=0.3).to_dict()
    with pytest.raises(KeyError):
        trecipes.prune_stage("nope")


def test_registry_make_adapter():
    full = make_adapter("vgg11", scale="full", device="cpu", batch_size=128,
                        lr=0.1)
    assert isinstance(full, CNNAdapter) and full.recipe == "cnn-full"
    assert full.cfg.param_count() == 9_222_848 and full.batch_size == 128
    assert full.conv_pred("convs/0/w") and not full.conv_pred("head/w")
    tiny = make_adapter("resnet18", scale="tiny", device="cpu")
    assert tiny.recipe is None and tiny.steps == 6
    assert tiny.cfg.convs[5].stride == 2
    moe = make_adapter("deepseek-v3-671b", device="cpu")
    assert moe.family == "moe" and moe.recipe is None and moe.steps == 6
    assert moe.granularities[0] == "expert"
    assert get_family("hybrid").adapter_factory is LMAdapter
    assert get_family("ssm").adapter_factory is LMAdapter
    assert get_family("audio").adapter_factory.__name__ == "EncDecAdapter"
    with pytest.raises(KeyError):
        get_family("nope")
    with pytest.raises(KeyError):
        make_adapter("nope")


def test_cnn_entry_points_require_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_cnn("scaled_down_cnn")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CNNAdapter(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_adapter("vgg11")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcnn.init_params(torch.Generator(), cfg)
    assert CNNAdapter(cfg, device="cpu").device.type == "cpu"


def test_cnn_modules_import_neither_jax_nor_repro():
    code = (
        "import sys, repro_torch.api, repro_torch.models.cnn, "
        "repro_torch.core.algorithm, repro_torch.core.hardware, "
        "repro_torch.core.lottery, repro_torch.core.quantize, "
        "repro_torch.core.sparsity, repro_torch.checkpoint, "
        "repro_torch.kernels.tile_stats\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', "
        "'jaxlib', 'repro')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=str(ROOT),
                   env={"PYTHONPATH": "src"})
