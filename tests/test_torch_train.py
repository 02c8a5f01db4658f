"""The port's retraining slice against the reference's.

Same weights (the reference's ``init_params`` through the numpy bridge),
same crossbar ticket (numpy masks) and same synthetic batches go through
``repro`` (Pallas kernels in interpret mode) and ``repro_torch`` (plain
PyTorch versions on the CPU).  The config is llama3.2-3b scaled so that
every projection tiles at 128 (2 layers, d_model 256, d_ff 512, f32).
Model-level float32 parity is held at rtol = atol = 1e-4; optimizer and
schedule arithmetic at 1e-6.  One reference trainer run (module fixture)
serves both the step-by-step and the end-to-end comparison, so the
reference compiles its train step once.
"""
import dataclasses
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree

import repro_torch.configs as tcfgs
from repro import optim as ropt
from repro.api.adapters import LMAdapter as RLMAdapter
from repro.configs import get_arch, scaled_down
from repro.core import masks as rmasks
from repro.data.pipeline import DataPipeline as RDataPipeline
from repro.data.synthetic import SyntheticLM as RSyntheticLM
from repro.distributed import compression as rcomp
from repro.models import layers as rlayers
from repro.models import transformer as rtfm
from repro.train.loop import make_train_step as r_make_train_step
from repro.train.plans import lm_train_plan as r_lm_train_plan
from repro_torch import _bridge
from repro_torch import optim as topt
from repro_torch.api import LMAdapter
from repro_torch.core import masks as tmasks
from repro_torch.data import DataPipeline, SyntheticLM
from repro_torch.distributed import compression as tcomp
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttfm
from repro_torch.train import Trainer, init_opt_state, lm_train_plan, \
    make_train_step

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SMALL = dict(dtype="float32", n_layers=2, d_model=256, n_heads=4,
             n_kv_heads=2, head_dim=64, d_ff=512)
PROJ = ("wq", "wk", "wv", "wo", "up", "gate", "down")
TOL = dict(rtol=1e-4, atol=1e-4)
OPT_TOL = dict(rtol=1e-6, atol=1e-6)
# the trainers under test: 3 steps of masked adamw, warmup 1 then cosine.
# The rate keeps AdamW's near-sign updates of coordinates whose gradient
# is at rounding level (embedding rows, v ~ 1e-11) well inside the 1e-4
# parameter tolerance, while every live weight still moves by ~1e-3.
ADAPTER = dict(batch_size=2, seq_len=16, steps=3, peak_lr=1e-3, warmup=1)


def _ticket(params_np, seed=0, density=0.5):
    """One random 128x128 tile bitmap per projection and layer, column
    tile 0 dead."""
    rng = np.random.default_rng(seed)

    def mk(path, a):
        if str(path[-1].key) not in PROJ:
            return None
        *lead, K, N = a.shape
        bm = rng.random((*lead, K // 128, N // 128)) < density
        bm[..., 0] = False
        return np.repeat(np.repeat(bm, 128, -2), 128, -1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(mk, params_np)


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


@pytest.fixture(scope="module")
def setup():
    rcfg = scaled_down(get_arch("llama3.2-3b"), **SMALL)
    tcfg = tcfgs.scaled_down(tcfgs.get_arch("llama3.2-3b"), **SMALL)
    rparams = rtfm.init_params(jax.random.PRNGKey(0), rcfg)
    params_np = jax.tree.map(np.asarray, rparams)
    masks = _ticket(params_np)
    return dict(rcfg=rcfg, tcfg=tcfg, masks=masks, params_np=params_np,
                rparams=rparams)


def _tparams(s, masked=True):
    p = _bridge.params_from_numpy(s["params_np"], device="cpu")
    return _bridge.apply_masks(p, s["masks"]) if masked else p


@pytest.fixture(scope="module")
def ref_run(setup):
    """The reference's ``LMAdapter.make_trainer(params, masks)`` stepped
    three times, with params, moments and metrics after every step."""
    ad = RLMAdapter(setup["rcfg"], use_bsmm=True, bsmm_interpret=True,
                    **ADAPTER)
    trainer = ad.make_trainer(setup["rparams"], setup["masks"])
    steps = []
    for _ in range(3):
        metrics = trainer.run(1, log_every=0)
        opt = trainer.state.opt_state["_opt"]
        steps.append(dict(metrics=metrics, params=trainer.state.params,
                          m=opt["m"], v=opt["v"]))
    return steps


# ---------------------------------------------------------------------------
# forward and loss
# ---------------------------------------------------------------------------
def _batch(step=0):
    return SyntheticLM(256, ADAPTER["seq_len"], seed=0).batch(
        step, ADAPTER["batch_size"])


@pytest.mark.parametrize("with_plan", [False, True])
def test_forward_and_loss_match_reference(setup, with_plan):
    s = setup
    b = _batch()
    rplan = r_lm_train_plan(s["masks"], interpret=True)[0] if with_plan \
        else None
    tplan = lm_train_plan(s["masks"])[0] if with_plan else None
    rparams = rmasks.apply_masks(s["rparams"], s["masks"])
    rb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    rlogits, _ = rtfm.forward(rparams, s["rcfg"], rb, plan=rplan)
    tparams = _tparams(s)
    with torch.no_grad():
        tlogits, taux = ttfm.forward(tparams, s["tcfg"], tb, plan=tplan)
        tloss, tmet = ttfm.loss_fn(tparams, s["tcfg"], tb, plan=tplan)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(rlogits), **TOL)
    assert float(taux) == 0.0
    rloss, rmet = rtfm.loss_fn(rparams, s["rcfg"], rb, plan=rplan)
    np.testing.assert_allclose(float(tloss), float(rloss), **TOL)
    np.testing.assert_allclose(float(tmet["ce"]), float(rmet["ce"]), **TOL)


def test_softmax_cross_entropy_matches_reference():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 5, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, size=(3, 5)).astype(np.int32)
    mask = (rng.random((3, 5)) < 0.6).astype(np.float32)
    for m, z in ((None, 0.0), (mask, 0.0), (mask, 1e-3),
                 (np.zeros_like(mask), 0.0)):
        want = rlayers.softmax_cross_entropy(
            jnp.asarray(logits), jnp.asarray(labels),
            None if m is None else jnp.asarray(m), z_loss=z)
        got = tlayers.softmax_cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(labels),
            None if m is None else torch.from_numpy(m), z_loss=z)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_remat_keeps_loss_and_grads(setup):
    """Per-layer checkpointing recomputes the forward in the backward:
    same loss, same gradients."""
    s = setup
    tb = {k: torch.from_numpy(v) for k, v in _batch().items()}
    plan = lm_train_plan(s["masks"])[0]
    step = make_train_step(lambda p, b: ttfm.loss_fn(p, s["tcfg"], b,
                                                     plan=plan),
                           topt.sgd(topt.constant(0.1), momentum=0.0))
    outs = []
    try:
        for flag in (True, False):
            ttfm.set_remat(flag)
            params = _tparams(s)
            opt_state = init_opt_state(topt.sgd(topt.constant(0.1)), params)
            outs.append(step(params, opt_state, tb))
    finally:
        ttfm.set_remat(True)
    (p1, _, m1), (p2, _, m2) = outs
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-6)
    for a, b in zip(_bridge.tree_leaves(p1), _bridge.tree_leaves(p2)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# training steps and the slice end to end
# ---------------------------------------------------------------------------
def test_train_steps_match_reference(setup, ref_run):
    """``make_train_step`` with ``masked(adamw(warmup_cosine))`` through
    the plan: loss, params and both moments agree with the reference at
    every step; pruned coordinates stay exactly zero."""
    s = setup
    masks = s["masks"]
    plan = lm_train_plan(masks)[0]
    opt = topt.masked(topt.adamw(topt.warmup_cosine(
        ADAPTER["peak_lr"], 1, ADAPTER["steps"])), masks)
    step = make_train_step(
        lambda p, b: ttfm.loss_fn(p, s["tcfg"], b, plan=plan), opt)
    params = _tparams(s)
    opt_state = init_opt_state(opt, params)
    for i, want in enumerate(ref_run):
        tb = {k: torch.from_numpy(v) for k, v in _batch(i).items()}
        params, opt_state, metrics = step(params, opt_state, tb)
        np.testing.assert_allclose(float(metrics["loss"]),
                                   want["metrics"]["loss"], **TOL)
        _assert_trees_close(params, want["params"], **TOL)
        _assert_trees_close(opt_state["m"], want["m"], **TOL)
        _assert_trees_close(opt_state["v"], want["v"], rtol=1e-4, atol=1e-8)
    _assert_pruned_zero(params, masks)
    first = _bridge.to_numpy(_tparams(s))
    moved = max(float(np.abs(a - b).max()) for a, b in zip(
        _bridge.tree_leaves(_bridge.to_numpy(params)),
        _bridge.tree_leaves(first)))
    assert moved > 5e-4          # the steps really changed the weights


def _assert_pruned_zero(params, masks):
    got = _port_by_path(params)
    for path, m in tmasks.flat_mask_items(masks):
        assert not np.any(got[path][np.asarray(m) == 0]), path


def test_lm_adapter_trainer_matches_reference(setup, ref_run):
    """``LMAdapter.make_trainer(params, masks).run(3)`` end to end: the
    same final loss, ``sent_fraction`` and parameters as the
    reference's."""
    s = setup
    ad = LMAdapter(s["tcfg"], device="cpu", **ADAPTER)
    trainer = ad.make_trainer(_tparams(s, masked=False), s["masks"])
    assert ad.last_plan_stats.routed == len(PROJ)
    metrics = trainer.run(3)
    want = ref_run[-1]
    np.testing.assert_allclose(metrics["loss"], want["metrics"]["loss"], **TOL)
    # the reference's jitted step hands the count back as a float32
    assert metrics["sent_fraction"] == pytest.approx(
        want["metrics"]["sent_fraction"], rel=1e-7)
    _assert_trees_close(trainer.state.params, want["params"], **TOL)
    _assert_pruned_zero(trainer.state.params, s["masks"])


def test_lm_adapter_train_and_evaluate(setup):
    s = setup
    ad = LMAdapter(s["tcfg"], device="cpu", eval_batches=1, **ADAPTER)
    before = ad.evaluate(_tparams(s))
    params = ad.train(_tparams(s, masked=False), s["masks"], steps=2)
    assert np.isfinite(before) and np.isfinite(ad.evaluate(params))
    assert set(ad.last_comm_stats) == {"sent_fraction", "bytes_per_step"}
    assert 0 < ad.last_comm_stats["sent_fraction"] < 1
    _assert_pruned_zero(params, s["masks"])


def test_microbatch_and_aux_state_steps(setup):
    """The microbatched step (f32 accumulation over equal chunks) and the
    aux-state step against the reference's, on the same weights and
    batch; the aux-state step threads its state."""
    s = setup
    b = _batch()
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    rb = {k: jnp.asarray(v) for k, v in b.items()}
    rparams = rmasks.apply_masks(s["rparams"], s["masks"])

    def loss(p, b):
        return ttfm.loss_fn(p, s["tcfg"], b)

    def rloss(p, b):
        return rtfm.loss_fn(p, s["rcfg"], b)

    def aux(fn):
        def aux_loss(p, state, b):
            value, metrics = fn(p, b)
            return value, (state + 1, metrics)
        return aux_loss

    opt = topt.sgd(topt.constant(0.5), momentum=0.0)
    r_opt = ropt.sgd(ropt.constant(0.5), momentum=0.0)
    micro = make_train_step(loss, opt, microbatch=1)(
        _tparams(s), opt.init(_tparams(s)), tb)
    r_micro = r_make_train_step(rloss, r_opt, microbatch=1, donate=False)(
        rparams, r_opt.init(rparams), rb)
    np.testing.assert_allclose(float(micro[2]["loss"]),
                               float(r_micro[2]["loss"]), **TOL)
    _assert_trees_close(micro[0], r_micro[0], **TOL)

    p, _, state, metrics = make_train_step(aux(loss), opt,
                                           has_aux_state=True)(
        _tparams(s), opt.init(_tparams(s)), torch.tensor(3), tb)
    rp, _, rstate, rmetrics = r_make_train_step(
        aux(rloss), r_opt, has_aux_state=True, donate=False)(
        rparams, r_opt.init(rparams), jnp.asarray(3), rb)
    assert int(state) == int(rstate) == 4
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(rmetrics["loss"]), **TOL)
    _assert_trees_close(p, rp, **TOL)
    with pytest.raises(ValueError, match="aux state"):
        make_train_step(aux(loss), opt, microbatch=1, has_aux_state=True)


def test_trainer_straggler_hook_and_data_order(setup):
    s = setup
    seen = []
    batches = iter([{k: v for k, v in _batch(i).items()} for i in range(2)])
    trainer = Trainer(
        loss_fn=lambda p, b: ttfm.loss_fn(p, s["tcfg"], b),
        optimizer=topt.sgd(topt.constant(0.0)), params=_tparams(s),
        data_iter=batches, step_deadline_s=0.0,
        on_straggler=lambda step, dt: seen.append(step), device="cpu")
    out = trainer.run(2)
    assert seen == [0, 1] and trainer.state.step == 2
    assert set(out) == {"ce", "aux", "loss"}


# ---------------------------------------------------------------------------
# optimizers, schedules, data, compression, masks
# ---------------------------------------------------------------------------
def _rand_tree(rng, scale=1.0):
    return {"a": (rng.standard_normal((3, 4)) * scale).astype(np.float32),
            "segs": [{"w": (rng.standard_normal((2, 5, 6)) * scale
                            ).astype(np.float32),
                      "b": (rng.standard_normal((6,)) * scale
                            ).astype(np.float32)}]}


def _mask_tree(rng):
    return {"a": None, "segs": [{"w": (rng.random((2, 5, 6)) < 0.5)
                                 .astype(np.float32), "b": None}]}


_OPTS = {
    "sgd": lambda o, m: o.sgd(o.constant(0.1), momentum=0.9,
                              weight_decay=0.01),
    "sgd_nesterov": lambda o, m: o.sgd(o.exponential_epoch_decay(
        0.1, 0.5, 2), nesterov=True),
    "adamw": lambda o, m: o.adamw(o.warmup_cosine(1e-2, 2, 5)),
    "masked_adamw": lambda o, m: o.masked(o.adamw(o.cosine_decay(1e-2, 5)),
                                          m),
    "clipped_sgd": lambda o, m: o.with_gradient_clipping(
        o.sgd(o.constant(0.1)), 0.5),
}


@pytest.mark.parametrize("name", sorted(_OPTS))
def test_optimizers_match_reference(name):
    rng = np.random.default_rng(5)
    params = _rand_tree(rng)
    masks = _mask_tree(rng)
    grads = [_rand_tree(rng, 0.3) for _ in range(3)]
    ropt_ = _OPTS[name](ropt, masks)
    topt_ = _OPTS[name](topt, masks)
    rp = jax.tree.map(jnp.asarray, params)
    rs = ropt_.init(rp)
    tp = _bridge.params_from_numpy(params, device="cpu")
    ts = topt_.init(tp)
    for g in grads:
        rp, rs = ropt_.update(jax.tree.map(jnp.asarray, g), rs, rp)
        tp, ts = topt_.update(_bridge.params_from_numpy(g, device="cpu"), ts,
                              tp)
        _assert_trees_close(tp, rp, **OPT_TOL)
        _assert_trees_close(ts, rs, **OPT_TOL)


@pytest.mark.parametrize("name", ["adamw", "sgd"])
def test_optimizer_blocks_give_the_whole_leafs_bits(name, monkeypatch):
    """A leaf larger than ``_CHUNK`` is updated block by block (a 2-D
    table by rows, a stack by slices cut again): the same parameters and
    state, bit for bit, as one update of the whole leaf."""
    rng = np.random.default_rng(11)
    shapes = {"table": (37, 24), "stack": (3, 10, 16), "bias": (24,)}
    params = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              .bfloat16() for k, s in shapes.items()}
    grads = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             .bfloat16() for k, s in shapes.items()}
    make = {"adamw": lambda: topt.adamw(topt.constant(1e-2)),
            "sgd": lambda: topt.sgd(topt.constant(1e-2), momentum=0.9)}[name]
    outs = []
    for chunk in (1 << 26, 100):        # whole leaves, then blocks
        monkeypatch.setattr(topt.optimizers, "_CHUNK", chunk)
        opt = make()
        state = opt.init(params)
        p = params
        for _ in range(2):
            p, state = opt.update(grads, state, p)
        outs.append((p, state))
    (p1, s1), (p2, s2) = outs
    for a, b in zip(_bridge.tree_leaves((p1, s1)), _bridge.tree_leaves((p2, s2))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name,make", [
    ("constant", lambda o: o.constant(3e-4)),
    ("exponential_epoch_decay", lambda o: o.exponential_epoch_decay(
        0.1, 0.95, 3)),
    ("cosine_decay", lambda o: o.cosine_decay(1e-3, 7, 0.2)),
    ("warmup_cosine", lambda o: o.warmup_cosine(1e-3, 3, 9)),
])
def test_schedules_match_reference(name, make):
    rfn, tfn = make(ropt), make(topt)
    for step in range(10):
        want = float(rfn(jnp.asarray(step, jnp.int32)))
        got = float(tfn(torch.tensor(step, dtype=torch.int32)))
        np.testing.assert_allclose(got, want, err_msg=f"{name}@{step}",
                                   **OPT_TOL)


def test_synthetic_lm_batches_bit_identical():
    for vocab, seq, seed in ((256, 16, 0), (512, 33, 7)):
        for step in (0, 1, 17):
            want = RSyntheticLM(vocab, seq, seed).batch(step, 3)
            got = SyntheticLM(vocab, seq, seed).batch(step, 3)
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(got[k], want[k])
                assert got[k].dtype == want[k].dtype


@pytest.mark.parametrize("prefetch", [0, 2])
def test_data_pipeline_matches_reference(prefetch):
    fn = SyntheticLM(64, 8).batch
    want = RDataPipeline(lambda i: fn(i, 2), start_step=3, prefetch=0)
    got = DataPipeline(lambda i: fn(i, 2), start_step=3, prefetch=prefetch)
    try:
        for _ in range(4):
            a, b = next(got), next(want)
            np.testing.assert_array_equal(a["tokens"], b["tokens"])
        assert got.step == want.step == 7
    finally:
        got.close()


@pytest.mark.parametrize("kind,k_fraction", [("mask", 1.0), ("mask", 0.4),
                                             ("topk", 0.3)])
def test_compressors_match_reference(kind, k_fraction):
    rng = np.random.default_rng(6)
    params = _rand_tree(rng)
    masks = _mask_tree(rng)
    if kind == "mask":
        rc = rcomp.MaskAwareCompressor(masks, k_fraction)
        tc = tcomp.MaskAwareCompressor(masks, k_fraction)
    else:
        rc = rcomp.TopKCompressor(k_fraction)
        tc = tcomp.TopKCompressor(k_fraction)
    rres = rc.init(jax.tree.map(jnp.asarray, params))
    tres = tc.init(_bridge.params_from_numpy(params, device="cpu"))
    for _ in range(2):
        g = _rand_tree(rng)
        rg, rres, rst = rc.compress(jax.tree.map(jnp.asarray, g), rres)
        tg, tres, tst = tc.compress(_bridge.params_from_numpy(
            g, device="cpu"), tres)
        _assert_trees_close(tg, rg, **OPT_TOL)
        _assert_trees_close(tres, rres, **OPT_TOL)
        assert tst["sent_fraction"] == pytest.approx(rst["sent_fraction"],
                                                     rel=1e-12)


def test_masks_match_reference(setup):
    s = setup
    tparams = _tparams(s, masked=False)
    want = rmasks.make_masks(s["rparams"], rmasks.lm_prunable)
    got = tmasks.make_masks(tparams, tmasks.lm_prunable)
    assert sorted(p for p, _ in tmasks.flat_mask_items(got)) == \
        sorted(p for p, _ in rmasks.flat_mask_items(want))
    assert [p for p, _ in tmasks.flat_mask_items(s["masks"])] == \
        [p for p, _ in rmasks.flat_mask_items(s["masks"])]
    assert tmasks.sparsity(s["masks"]) == rmasks.sparsity(s["masks"])
    assert tmasks.sparsity_fraction(s["masks"]) == \
        rmasks.sparsity_fraction(s["masks"])
    tm = _bridge.params_from_numpy(s["masks"], device="cpu")
    assert tmasks.sparsity(tm) == rmasks.sparsity(s["masks"])
    _assert_trees_close(tmasks.mask_grads(tparams, s["masks"]),
                        rmasks.mask_grads(s["rparams"], s["masks"]),
                        rtol=0, atol=0)
    assert _bridge.apply_masks is tmasks.apply_masks
    assert _bridge.path_str is tmasks.path_str


# ---------------------------------------------------------------------------
# devices, and what is not yet ported
# ---------------------------------------------------------------------------
def test_entry_points_require_cuda_unless_cpu(setup, monkeypatch):
    s = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LMAdapter(s["tcfg"])
    kw = dict(loss_fn=lambda p, b: None, optimizer=topt.sgd(topt.constant(
        0.1)), params=_tparams(s), data_iter=iter([]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(**kw)
    assert Trainer(**kw, device="cpu").device.type == "cpu"
    assert LMAdapter(s["tcfg"], device="cpu").device.type == "cpu"


def test_not_yet_ported_paths_raise(setup):
    """Every block kind trains now (mLSTM and sLSTM against the
    reference: ``tests/test_torch_xlstm.py``); what ``transformer``
    refuses is an unknown block kind or norm, an encoder-decoder config
    (``models.encdec`` runs those) and an unknown remat policy."""
    s = setup
    with pytest.raises(ValueError, match="unknown remat policy"):
        ttfm.set_remat(True, "everything")
    assert ttfm.remat_enabled()
    mlstm = tcfgs.scaled_down(s["tcfg"], block_pattern=(tcfgs.MLSTM,),
                              rnn_width=128)
    ttfm.check_ported(mlstm)
    params = ttfm.init_params(torch.Generator(), mlstm, device="cpu")
    assert "cell" in params["segments"][0][0]["rnn"]
    assert "mlp" not in params["segments"][0][0]
    for bad, match in ((dataclasses.replace(mlstm, block_pattern=("x",)),
                        "unknown block kinds"),
                       (dataclasses.replace(mlstm, norm="batchnorm"),
                        "unknown norm"),
                       (tcfgs.scaled_down(tcfgs.get_arch("whisper-tiny")),
                        "models.encdec")):
        with pytest.raises(ValueError, match=match):
            ttfm.check_ported(bad)


def test_new_modules_import_neither_jax_nor_repro():
    code = (
        "import sys, repro_torch.api, repro_torch.train, repro_torch.optim, "
        "repro_torch.data, repro_torch.distributed.compression, "
        "repro_torch.core.masks, repro_torch.kernels.ops, "
        "repro_torch.kernels.ref\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', "
        "'jaxlib', 'repro')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=str(ROOT),
                   env={"PYTHONPATH": "src"})
