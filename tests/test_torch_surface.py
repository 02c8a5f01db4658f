"""The rest of the port's public surface against the reference's.

``structured_prune`` (bitwise masks), ``family_granularities``, FFN
packing (``pack_ffn`` 2-D and stacked, ``pack_lm_params``: weights
bitwise, packed logits within 1e-5 of the pruned ones, a packed FFN
within 1e-5 of its output scale), the ReRAM
execution model (``core.perf_model`` on vgg11's and resnet18's pruned
crossbar counts at 1e-12), ``core``'s re-exports and ``serve.ticket``,
``data.lm_batch``/``cifar_like_batch`` (bitwise), ``kernels.ref``'s
``expand_tile_mask`` (bitwise) and ``bsmm_ref`` (1e-5), the "dots"
remat policy (loss and gradients against "full" and the reference's at
1e-4), and the ``yi-6b`` and ``qwen2-72b`` configs scaled down (forward
and one train step at 1e-4).  Inputs come from numpy seeds or the
reference's ``init_params`` through the numpy bridge; float32
throughout.
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
import repro_torch.core as tcore
from repro import optim as ropt
from repro.api import structured_prune as r_structured_prune
from repro.api import registry as rreg
from repro.configs import get_arch, get_cnn, scaled_down
from repro.core import hardware as rhw
from repro.core import masks as rmasks
from repro.core import packing as rpack
from repro.core import perf_model as rpm
from repro.core.algorithm import prune_step as r_prune_step
from repro.data import synthetic as rsyn
from repro.kernels import ref as rref
from repro.models import cnn as rcnn
from repro.models import transformer as rtfm
from repro.train.loop import init_opt_state as r_init_opt_state
from repro.train.loop import make_train_step as r_make_train_step
from repro_torch import _bridge
from repro_torch import optim as topt
from repro_torch import serve as tserve
from repro_torch.api import registry as treg
from repro_torch.api import structured_prune
from repro_torch.core import hardware as thw
from repro_torch.core import masks as tmasks
from repro_torch.core import packing as tpack
from repro_torch.core import perf_model as tpm
from repro_torch.data import cifar_like_batch, lm_batch
from repro_torch.kernels import ref as tref
from repro_torch.models import transformer as ttfm
from repro_torch.serve import ticket as tticket
from repro_torch.train import init_opt_state, make_train_step

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-4, atol=1e-4)


def _ref_by_path(tree):
    return {rmasks.path_str(p): np.asarray(leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_by_path(tree):
    return {p: _bridge.to_numpy(v)
            for p, v in tmasks.tree_flatten_with_path(tree) if v is not None}


def _assert_trees_equal(port, ref, **tol):
    got, want = _port_by_path(port), _ref_by_path(ref)
    assert sorted(got) == sorted(want)
    for k in want:
        if tol:
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _llama(**kw):
    """(reference cfg, port cfg, reference params, port params) of a
    scaled-down llama3.2-3b (the reference's own tests' size)."""
    rcfg = scaled_down(get_arch("llama3.2-3b"), dtype="float32", **kw)
    tcfg = tcfgs.scaled_down(tcfgs.get_arch("llama3.2-3b"), dtype="float32",
                             **kw)
    rparams = rtfm.init_params(jax.random.PRNGKey(0), rcfg)
    tparams = _bridge.params_from_numpy(jax.tree.map(np.asarray, rparams),
                                        device="cpu")
    return rcfg, tcfg, rparams, tparams


# ---------------------------------------------------------------------------
# structured_prune and the registry
# ---------------------------------------------------------------------------
def test_structured_prune_matches_reference():
    """The schedule of the reference's own prefill test, bitwise."""
    schedule = [("xbar", 0.4), ("filter", 0.2)]
    _, _, rparams, tparams = _llama()
    want = r_structured_prune(rparams, schedule, prunable=rmasks.lm_prunable)
    got = structured_prune(tparams, schedule, prunable=tmasks.lm_prunable)
    _assert_trees_equal(got, want)
    assert 0 < tmasks.sparsity_fraction(got) < 1


def test_family_granularities_match_reference():
    """Every family the reference registers, the port registers too,
    with the same schedulable granularities (``expert`` only for moe)."""
    ported = treg.available_families()
    assert set(ported) == set(rreg.available_families()) == {
        "audio", "cnn", "dense", "hybrid", "moe", "ssm", "vlm"}
    for fam in ported:
        want = rreg.family_granularities(rreg.get_family(fam))
        got = treg.family_granularities(treg.get_family(fam))
        assert got == want, fam
        assert ("expert" in got) == (fam == "moe")


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------
def _ffn_case(lead, seed=0, d=32, ff=512, dead=400):
    """up, gate, down and their masks with ``dead`` whole columns of up
    and gate and rows of down killed per layer."""
    rng = np.random.RandomState(seed)
    up = rng.randn(*lead, d, ff).astype(np.float32)
    gate = rng.randn(*lead, d, ff).astype(np.float32)
    down = rng.randn(*lead, ff, d).astype(np.float32)
    m = np.ones((*lead, d, ff), np.float32)
    md = np.ones((*lead, ff, d), np.float32)
    for i in np.ndindex(*lead):
        cols = rng.choice(ff, size=dead - 37 * sum(i), replace=False)
        m[i][:, cols] = 0.0
        md[i][cols, :] = 0.0
    return up, gate, down, m, md


@pytest.mark.parametrize("lead", [(), (3,)])
def test_pack_ffn_matches_reference(lead):
    """2-D and stacked: the same ff', the same packed weights, and the
    packed FFN equal to the pruned one at 1e-5 of its output scale."""
    up, gate, down, m, md = _ffn_case(lead)
    want = rpack.pack_ffn(up, gate, down, m, m, md)
    t = [torch.from_numpy(a) for a in (up, gate, down, m, md)]
    got = tpack.pack_ffn(t[0], t[1], t[2], t[3], t[3], t[4])
    assert got[3] == want[3] < up.shape[-1]
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        tpack._live_columns(m != 0, m != 0, md != 0),
        rpack._live_columns(m != 0, m != 0, md != 0))
    x = torch.from_numpy(np.random.RandomState(1).randn(
        *lead, 4, up.shape[-2]).astype(np.float32))
    silu = torch.nn.functional.silu
    h_ref = (silu(x @ (t[1] * t[3])) * (x @ (t[0] * t[3]))) @ (t[2] * t[4])
    up_p, gate_p, down_p, _ = got
    h_pack = (silu(x @ gate_p) * (x @ up_p)) @ down_p
    # the products sum 512 and ff' terms: f32 order, 1e-5 of the scale
    scale = float(h_ref.abs().max())
    np.testing.assert_allclose(h_pack.numpy(), h_ref.numpy(), rtol=0,
                               atol=1e-5 * scale)


def _yi(**kw):
    rcfg = scaled_down(get_arch("yi-6b"), dtype="float32", **kw)
    tcfg = tcfgs.scaled_down(tcfgs.get_arch("yi-6b"), dtype="float32", **kw)
    rparams = rtfm.init_params(jax.random.PRNGKey(0), rcfg)
    tparams = _bridge.params_from_numpy(jax.tree.map(np.asarray, rparams),
                                        device="cpu")
    return rcfg, tcfg, rparams, tparams


def test_pack_lm_params_matches_reference():
    """The reference's packing test (yi-6b, d_ff 512, four 40 % filter
    rounds): the same packed width and weights, and the packed model's
    logits equal to the pruned model's at 1e-5."""
    rcfg, tcfg, rparams, tparams = _yi(d_ff=512)
    masks = rmasks.make_masks(rparams, rmasks.lm_prunable)
    for _ in range(4):
        masks = r_prune_step(rparams, masks, "filter", 0.4, lambda p: False)
    rpruned = rmasks.apply_masks(rparams, masks)
    rpacked, rcfg_p = rpack.pack_lm_params(rpruned, masks, rcfg)
    tmask = _bridge.params_from_numpy(jax.tree.map(np.asarray, masks),
                                      device="cpu")
    tpruned = tmasks.apply_masks(tparams, tmask)
    tpacked, tcfg_p = tpack.pack_lm_params(tpruned, tmask, tcfg)
    assert tcfg_p.d_ff == rcfg_p.d_ff < tcfg.d_ff
    assert tcfg_p.name == rcfg_p.name
    _assert_trees_equal(tpacked, rpacked)
    batch = {"tokens": torch.arange(64).reshape(2, 32) % 100}
    with torch.no_grad():
        want, _ = ttfm.forward(tpruned, tcfg, batch)
        got, _ = ttfm.forward(tpacked, tcfg_p, batch)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_pack_noop_when_dense():
    _, tcfg, _, tparams = _yi()
    masks = tmasks.make_masks(tparams, tmasks.lm_prunable)
    packed, cfg_p = tpack.pack_lm_params(tparams, masks, tcfg)
    assert packed is tparams and cfg_p is tcfg


# ---------------------------------------------------------------------------
# the ReRAM execution model
# ---------------------------------------------------------------------------
def _cnn_masks(cfg, seed):
    """Numpy masks of the published-width CNN: a share of whole filters
    (columns) and input channels (rows) of every leaf killed."""
    shapes = jax.eval_shape(lambda k: rcnn.init_params(k, cfg)[0],
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def mk(path, s):
        if not rmasks.cnn_prunable(rmasks.path_str(path), s):
            return None
        m = np.ones(s.shape, np.float32)
        m[..., rng.random(s.shape[-1]) < 0.4] = 0.0
        m[..., rng.random(s.shape[-2]) < 0.3, :] = 0.0
        return m

    return jax.tree_util.tree_map_with_path(mk, shapes)


@pytest.mark.parametrize("name", ["vgg11", "resnet18"])
def test_perf_model_matches_reference(name):
    """``conv_layer_perf`` from the hardware report's crossbar counts and
    the activation volumes, the waterfill, ``iso_area_speedup`` and
    ``iso_perf_xbars``, unpruned and pruned, at 1e-12."""
    rcfg, tcfg = get_cnn(name), tcfgs.get_cnn(name)
    rm = _cnn_masks(rcfg, seed=len(name))
    tm = _port_masks_of(rm)
    rvols, tvols = rhw.cnn_activation_volumes(rcfg), \
        thw.cnn_activation_volumes(tcfg)
    assert tvols == rvols
    rrep = rhw.analyze_masks(rm, rmasks.cnn_conv_path,
                             activation_volumes=rvols)
    trep = thw.analyze_masks(tm, tmasks.cnn_conv_path,
                             activation_volumes=tvols)
    layers = {}
    for pkg, pm, cfg, rep, vols in (("ref", rpm, rcfg, rrep, rvols),
                                    ("port", tpm, tcfg, trep, tvols)):
        layers[pkg] = [pm.conv_layer_perf(
            cfg, {lr.path: getattr(lr.stats, key) for lr in rep.layers},
            vols, act_cells_per_xbar=128 * 128)
            for key in ("n_xbars", "xbars_needed_packed")]
    for a, b in zip(layers["port"], layers["ref"]):
        assert [dataclasses.astuple(x) for x in a] == \
            [dataclasses.astuple(x) for x in b]
    (tu, tp), (ru, rp) = layers["port"], layers["ref"]
    for train in (True, False):
        w_t, w_r = tpm.waterfill(tp, train=train), rpm.waterfill(rp,
                                                                 train=train)
        np.testing.assert_allclose(w_t.cycles_per_image, w_r.cycles_per_image,
                                   rtol=1e-12)
        np.testing.assert_allclose(w_t.replication, w_r.replication,
                                   rtol=1e-12)
        assert w_t.time_per_image_s == pytest.approx(w_r.time_per_image_s,
                                                     rel=1e-12)
    s_t, s_r = tpm.iso_area_speedup(tu, tp), rpm.iso_area_speedup(ru, rp)
    np.testing.assert_allclose(s_t, s_r, rtol=1e-12)
    assert s_t > 1.0
    x_t, x_r = tpm.iso_perf_xbars(tu, tp), rpm.iso_perf_xbars(ru, rp)
    assert sorted(x_t) == sorted(x_r)
    for k in x_r:
        np.testing.assert_allclose(x_t[k], x_r[k], rtol=1e-12)
    assert tpm.TOTAL_XBARS == rpm.TOTAL_XBARS == 24576


def _port_masks_of(rmask_tree):
    return tmasks.tree_map_with_path(
        lambda p, m: None if m is None else torch.from_numpy(np.array(m)),
        jax.tree.map(np.asarray, rmask_tree))


# ---------------------------------------------------------------------------
# re-exports, data, oracles
# ---------------------------------------------------------------------------
def _reexports(init: pathlib.Path):
    """The names a package's ``__init__`` imports at its top (a
    re-exported name can be shadowed by a submodule of the same name,
    ``sparsity``, once that submodule is imported: read the source)."""
    import ast
    return sorted(a.asname or a.name
                  for node in ast.parse(init.read_text()).body
                  if isinstance(node, ast.ImportFrom) for a in node.names)


def test_core_and_serve_exports_match_reference():
    """``core`` re-exports the reference's 19 names (the algorithm's
    lazily: ``_bridge`` imports ``core.masks``); ``serve.ticket`` and
    ``serve`` the reference's shim names."""
    from repro_torch.core import algorithm as talg
    want = _reexports(ROOT / "src" / "repro" / "core" / "__init__.py")
    assert len(want) == 19
    got = sorted(_reexports(ROOT / "src" / "repro_torch" / "core" /
                            "__init__.py") + list(tcore._ALGORITHM))
    assert got == want
    for n in want:
        assert hasattr(tcore, n) and n in dir(tcore), n
    assert tcore.prune_step is talg.prune_step
    assert tcore.apply_masks is tmasks.apply_masks
    import repro.serve as rserve
    import repro.serve.ticket as rticket
    for n in ("GeometryError", "PlanStats", "build_decode_plan"):
        assert hasattr(rticket, n) and hasattr(tticket, n)
    for n in ("PlanStats", "build_decode_plan"):
        assert hasattr(rserve, n) and getattr(tserve, n) is \
            getattr(tticket, n)
    assert issubclass(tticket.GeometryError, ValueError)


@pytest.mark.parametrize("step", [0, 3])
def test_lm_and_cifar_batches_bit_identical(step):
    want = rsyn.lm_batch(97, 12, 4, step=step, seed=2)
    got = lm_batch(97, 12, 4, step=step, seed=2)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype
    want = rsyn.cifar_like_batch(5, step=step, seed=1)
    got = cifar_like_batch(5, step=step, seed=1)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("K,N,bk,bn", [(256, 384, 128, 128),
                                       (200, 300, 128, 128),
                                       (96, 64, 32, 16)])
def test_expand_tile_mask_and_bsmm_ref_match_reference(K, N, bk, bn):
    rng = np.random.default_rng(K + N)
    tm = (rng.random((-(-K // bk), -(-N // bn))) < 0.5).astype(np.float32)
    np.testing.assert_array_equal(
        tref.expand_tile_mask(torch.from_numpy(tm), bk, bn, K, N).numpy(),
        np.asarray(rref.expand_tile_mask(jnp.asarray(tm), bk, bn, K, N)))
    x = rng.standard_normal((7, K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32)
    got = tref.bsmm_ref(torch.from_numpy(x), torch.from_numpy(w), tm, bk, bn)
    want = rref.bsmm_ref(jnp.asarray(x), jnp.asarray(w), tm, bk, bn)
    assert got.dtype == torch.float32 and got.shape == (7, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the "dots" remat policy
# ---------------------------------------------------------------------------
def _grads_port(tparams, tcfg, batch):
    p = _bridge.tree_map(lambda t: t.detach().clone().requires_grad_(True),
                         tparams)
    loss, _ = ttfm.loss_fn(p, tcfg, batch)
    grads = torch.autograd.grad(loss, _bridge.tree_leaves(p))
    return float(loss.detach()), _pytree.tree_unflatten(
        list(grads), _pytree.tree_structure(p))


def test_dots_remat_matches_full_and_reference():
    rcfg, tcfg, rparams, tparams = _llama(n_layers=3)
    b = lm_batch(256, 16, 2)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    rb = {k: jnp.asarray(v) for k, v in b.items()}
    out = {}
    try:
        for policy in ("full", "dots"):
            ttfm.set_remat(True, policy)
            out[policy] = _grads_port(tparams, tcfg, tb)
        rtfm.set_remat(True, "dots")
        (rloss, _), rgrads = jax.value_and_grad(
            lambda p: rtfm.loss_fn(p, rcfg, rb), has_aux=True)(rparams)
    finally:
        ttfm.set_remat(True)
        rtfm.set_remat(True)
    (lf, gf), (ld, gd) = out["full"], out["dots"]
    np.testing.assert_allclose(ld, lf, **TOL)
    np.testing.assert_allclose(ld, float(rloss), **TOL)
    _assert_trees_equal(gd, rgrads, **TOL)
    for a, b in zip(_bridge.tree_leaves(gd), _bridge.tree_leaves(gf)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_dots_policy_saves_matmul_outputs_only():
    from torch.utils.checkpoint import CheckpointPolicy
    aten = torch.ops.aten
    assert ttfm._save_dots(None, aten.mm.default) == \
        CheckpointPolicy.MUST_SAVE
    assert ttfm._save_dots(None, aten.bmm.default) == \
        CheckpointPolicy.MUST_SAVE
    assert ttfm._save_dots(None, aten.mul.Tensor) == \
        CheckpointPolicy.PREFER_RECOMPUTE


# ---------------------------------------------------------------------------
# yi-6b and qwen2-72b
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["yi-6b", "qwen2-72b"])
def test_dense_configs_forward_and_train_step_match_reference(name):
    """The registered configs equal the reference's; scaled down (QKV
    bias in qwen2-72b, set to numpy noise so that it is exercised), the
    forward and one masked-SGD train step agree at 1e-4."""
    assert dataclasses.asdict(tcfgs.get_arch(name)) == \
        dataclasses.asdict(get_arch(name))
    rcfg = scaled_down(get_arch(name), dtype="float32", n_layers=2)
    tcfg = tcfgs.scaled_down(tcfgs.get_arch(name), dtype="float32",
                             n_layers=2)
    rng = np.random.default_rng(3)
    params_np = jax.tree_util.tree_map_with_path(
        lambda p, a: (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        if str(p[-1].key) in ("bq", "bk", "bv") else np.asarray(a),
        rtfm.init_params(jax.random.PRNGKey(1), rcfg))
    assert tcfg.qkv_bias == (name == "qwen2-72b")
    rparams = jax.tree.map(jnp.asarray, params_np)
    tparams = _bridge.params_from_numpy(params_np, device="cpu")
    b = lm_batch(256, 16, 2, seed=1)
    rb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    rlogits, _ = rtfm.forward(rparams, rcfg, rb)
    with torch.no_grad():
        tlogits, _ = ttfm.forward(tparams, tcfg, tb)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(rlogits), **TOL)
    rmask = rmasks.make_masks(rparams, rmasks.lm_prunable)
    tmask = tmasks.make_masks(tparams, tmasks.lm_prunable)
    ropt_ = ropt.masked(ropt.sgd(ropt.constant(0.1), momentum=0.0), rmask)
    topt_ = topt.masked(topt.sgd(topt.constant(0.1), momentum=0.0), tmask)
    rstep = r_make_train_step(lambda p, bb: rtfm.loss_fn(p, rcfg, bb), ropt_)
    tstep = make_train_step(lambda p, bb: ttfm.loss_fn(p, tcfg, bb), topt_)
    rp, _, rmet = rstep(rparams, r_init_opt_state(ropt_, rparams), rb)
    tp, _, tmet = tstep(tparams, init_opt_state(topt_, tparams), tb)
    np.testing.assert_allclose(float(tmet["loss"]), float(rmet["loss"]),
                               **TOL)
    _assert_trees_equal(tp, rp, **TOL)


@pytest.mark.parametrize("paged", [True, False])
def test_engine_logits_sink_sees_every_sampled_row(paged):
    """``ServeEngine.logits_sink`` gets (uid, the f32 row) of every
    token sampled, prefill's and decode's, in emission order: greedy
    tokens are the rows' argmax."""
    _, tcfg, _, tparams = _llama(n_layers=2)
    eng = tserve.ServeEngine(params=tparams, cfg=tcfg, batch_slots=2,
                             capacity=32, paged=paged, device="cpu")
    rows = {}
    eng.logits_sink = lambda uid, row: rows.setdefault(uid, []).append(
        row.copy())
    rng = np.random.default_rng(0)
    for uid, n in enumerate((5, 9, 3)):
        eng.submit(tserve.Request(uid=uid, prompt=rng.integers(
            1, 200, size=n).astype(np.int32), max_new_tokens=4))
    while not eng.idle:
        eng.step()
    done = {r.uid: r.tokens for r in eng._finished}
    assert sorted(rows) == sorted(done) == [0, 1, 2]
    for uid, toks in done.items():
        assert [int(np.argmax(r)) for r in rows[uid]] == toks
        assert all(r.dtype == np.float32 and r.shape == (tcfg.padded_vocab,)
                   for r in rows[uid])


def test_dropped_trainer_is_freed_without_a_cyclic_collection():
    """A session drops a trainer (its optimizer moments) every round:
    nothing in it may point back at it, or the moments stay alive until
    the cyclic collector runs."""
    import gc
    import weakref

    from repro_torch.api import LMAdapter
    _, tcfg, _, tparams = _llama(n_layers=2)
    masks = tmasks.make_masks(tparams, tmasks.lm_prunable)
    ad = LMAdapter(tcfg, device="cpu", batch_size=2, seq_len=8, steps=1)
    # a first step in the process may leave one-time state behind: warm up
    ad.make_trainer(tparams, masks).run(1)
    gc.collect()
    gc.disable()
    try:
        for bits in (None, 8):
            trainer = ad.make_trainer(tparams, masks, quantize_bits=bits)
            trainer.run(1)
            ref = weakref.ref(trainer)
            del trainer
            assert ref() is None, bits
    finally:
        gc.enable()


def test_new_modules_import_neither_jax_nor_repro():
    code = (
        "import sys, repro_torch.core, repro_torch.core.packing, "
        "repro_torch.core.perf_model, repro_torch.core.quantize, "
        "repro_torch.serve.ticket, repro_torch.data, repro_torch.kernels.ref, "
        "repro_torch.configs.yi_6b, repro_torch.configs.qwen2_72b\n"
        "from repro_torch.core import realprune\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', "
        "'jaxlib', 'repro')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=str(ROOT),
                   env={"PYTHONPATH": "src"})
