"""The port's entry points (``launch/{steps,train,serve}.py`` and the
shape cells of ``configs``) against the reference's.

The spec trees are compared exactly (path strings, shapes, dtypes) for
every arch × shape at full size; the port builds them on meta tensors,
so nothing is allocated.  ``build_step``'s three steps run on five
scaled archs (f32): the reference's jitted steps once each in a module
fixture, the port's on the reference's parameters carried across by
``_bridge.params_from_numpy``, held at rtol = atol = 1e-4.  Both
launchers' ``main`` run with ``--smoke --device cpu`` on the
reference's parameters against ``repro.launch.{train,serve}.main``.

The reference's launchers build their (1, 1) test mesh with
``jax.make_mesh``, whose axes default to ``Explicit`` on this tree's
jax; their sharding constraints need ``Auto`` axes (the unpatched
launchers raise), so the reference runs here on an ``Auto`` mesh of the
same shape.
"""
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

import repro.launch.serve as rserve
import repro.launch.train as rtrain
from repro import configs as rcfgs
from repro.core.masks import path_str as r_path_str
from repro.launch import steps as rsteps
from repro.models import encdec as rencdec
from repro.models import transformer as rtfm
from repro_torch import _bridge
from repro_torch import configs as tcfgs
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
STEP_ARCHS = ("llama3.2-3b", "deepseek-v3-671b", "recurrentgemma-2b",
              "whisper-tiny", "phi-3-vision-4.2b")
# the cells of the step parity: a 32-token train row and prefill
# capacity, 24 prompt tokens prefilled, then one decode step
SEQ, BATCH, PROMPT = 32, 2, 24


def _auto_mesh(data: int = 1, model: int = 1):
    return jax.make_mesh((data, model), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def _flat_port(tree):
    """[(JAX-style path string, leaf)]: dict keys sorted, sequences by
    index, NamedTuple fields as ``.name`` (JAX's ``GetAttrKey``)."""
    out = []

    def visit(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                visit(node[k], path + (str(k),))
        elif isinstance(node, tuple) and hasattr(node, "_fields"):
            for f, v in zip(node._fields, node):
                visit(v, path + ("." + f,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                visit(v, path + (str(i),))
        elif node is not None:
            out.append(("/".join(path), node))

    visit(tree, ())
    return out


def _flat_ref(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(r_path_str(p), leaf) for p, leaf in leaves]


def _sig_port(tree):
    return [(p, tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for p, t in _flat_port(tree)]


def _sig_ref(tree):
    return [(p, tuple(s.shape), str(s.dtype)) for p, s in _flat_ref(tree)]


def _np(t):
    return np.asarray(t.detach().cpu()) if torch.is_tensor(t) \
        else np.asarray(t)


def _assert_trees_close(port, ref, what):
    p, r = _flat_port(port), _flat_ref(ref)
    assert [k for k, _ in p] == [k for k, _ in r], what
    for (k, a), (_, b) in zip(p, r):
        np.testing.assert_allclose(_np(a), np.asarray(b), err_msg=f"{what} {k}",
                                   **TOL)


# ---------------------------------------------------------------------------
# configs: the shape cells and the analytic parameter counts
# ---------------------------------------------------------------------------
def test_shape_cells_match_reference():
    assert len(tcfgs.ALL_SHAPES) == len(rcfgs.ALL_SHAPES) == 4
    for t, r in zip(tcfgs.ALL_SHAPES, rcfgs.ALL_SHAPES):
        assert (t.name, t.seq_len, t.global_batch, t.kind, t.is_decode) \
            == (r.name, r.seq_len, r.global_batch, r.kind, r.is_decode)
        assert tcfgs.get_shape(t.name) == t
    assert (tcfgs.TRAIN_4K, tcfgs.PREFILL_32K, tcfgs.DECODE_32K,
            tcfgs.LONG_500K) == tcfgs.ALL_SHAPES
    with pytest.raises(KeyError, match="unknown shape"):
        tcfgs.get_shape("train_8k")
    assert not hasattr(tcfgs, "vmem_budget")


@pytest.mark.parametrize("arch", rcfgs.list_archs())
def test_param_counts_match_reference(arch):
    t, r = tcfgs.get_arch(arch), rcfgs.get_arch(arch)
    assert t.param_count() == r.param_count()
    assert t.active_param_count() == r.active_param_count()
    for i, kind in enumerate(r.blocks):
        assert t._block_params(kind, layer=i) == r._block_params(kind, layer=i)


# ---------------------------------------------------------------------------
# steps: the spec trees, exactly, for every arch x shape at full size
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", rcfgs.list_archs())
def test_spec_trees_match_reference(arch):
    t, r = tcfgs.get_arch(arch), rcfgs.get_arch(arch)
    tp, rp = tsteps.params_spec(t), rsteps.params_spec(r)
    assert _sig_port(tp) == _sig_ref(rp)
    assert _sig_port(tsteps.opt_state_spec(t, tp)) \
        == _sig_ref(rsteps.opt_state_spec(r, rp))
    for ts, rs in zip(tcfgs.ALL_SHAPES, rcfgs.ALL_SHAPES):
        assert tsteps.cache_capacity(t, ts) == rsteps.cache_capacity(r, rs)
        assert _sig_port(tsteps.input_specs(t, ts)) \
            == _sig_ref(rsteps.input_specs(r, rs)), ts.name
        assert _sig_port(tsteps.cache_specs(t, ts)) \
            == _sig_ref(rsteps.cache_specs(r, rs)), ts.name
        assert tsteps.cell_skip_reason(t, ts) == rsteps.cell_skip_reason(r, rs)


def test_specs_allocate_nothing_and_keep_cuda_strict():
    cfg = tcfgs.get_arch("deepseek-v3-671b")
    pspec = tsteps.params_spec(cfg)
    trees = [pspec, tsteps.opt_state_spec(cfg, pspec)]
    for shape in tcfgs.ALL_SHAPES:
        bundle = tsteps.build_step(cfg, shape)
        assert bundle.kind == shape.kind
        trees += [bundle.args, tsteps.input_specs(cfg, shape),
                  tsteps.cache_specs(cfg, shape)]
    leaves = [t for tree in trees for _, t in _flat_port(tree)]
    assert leaves and all(t.is_meta for t in leaves)
    assert sum(t.numel() for _, t in _flat_port(pspec)) > 6.7e11
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _bridge.resolve_device("cuda")
    reason = tsteps.cell_skip_reason(tcfgs.get_arch("llama3.2-3b"),
                                     tcfgs.LONG_500K)
    assert reason.startswith("full-attention arch")
    assert tsteps.cell_skip_reason(tcfgs.get_arch("recurrentgemma-2b"),
                                   tcfgs.LONG_500K) is None


# ---------------------------------------------------------------------------
# build_step: the three steps against the reference's jitted ones
# ---------------------------------------------------------------------------
def _inputs(cfg, kind, seed):
    """numpy inputs of a cell at SEQ (prefill: PROMPT tokens)."""
    rng = np.random.default_rng(seed)
    S = SEQ if kind == "train" else PROMPT
    p = cfg.num_patch_tokens
    toks = rng.integers(0, cfg.vocab_size, (BATCH, S - p)).astype(np.int32)
    out = {"tokens": toks}
    if kind == "train":
        out["labels"] = rng.integers(0, cfg.vocab_size, toks.shape
                                     ).astype(np.int32)
    if cfg.is_encoder_decoder:
        out["frames"] = rng.standard_normal(
            (BATCH, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    if p:
        out["patches"] = rng.standard_normal(
            (BATCH, p, cfg.d_model)).astype(np.float32)
    return out


def _cells():
    return (rcfgs.ShapeSpec("t", SEQ, BATCH, "train"),
            rcfgs.ShapeSpec("p", SEQ, BATCH, "prefill"),
            rcfgs.ShapeSpec("d", SEQ, BATCH, "decode"))


@pytest.fixture(scope="module")
def reference_steps():
    """Each arch's reference train, prefill and decode step, jitted and
    run once on numpy inputs."""
    out = {}
    for i, arch in enumerate(STEP_ARCHS):
        cfg = rcfgs.scaled_down(rcfgs.get_arch(arch), dtype="float32")
        init = rencdec.init_params if cfg.is_encoder_decoder \
            else rtfm.init_params
        params = jax.tree.map(np.asarray, init(jax.random.PRNGKey(i), cfg))
        train_c, pre_c, dec_c = _cells()
        train = rsteps.build_step(cfg, train_c)
        opt_state = rsteps.make_optimizer(cfg).init(params)
        batch = _inputs(cfg, "train", 10 + i)
        new_p, new_o, metrics = jax.jit(train.fn)(params, opt_state, batch)
        pre_in = _inputs(cfg, "prefill", 20 + i)
        logits, caches = jax.jit(rsteps.build_step(cfg, pre_c).fn)(
            params, pre_in)
        token = np.random.default_rng(30 + i).integers(
            0, cfg.vocab_size, (BATCH, 1)).astype(np.int32)
        dec_logits, dec_caches = jax.jit(rsteps.build_step(cfg, dec_c).fn)(
            params, caches, token)
        out[arch] = dict(
            params=params, batch=batch, pre_in=pre_in, token=token,
            new_params=new_p, new_opt=new_o,
            metrics={k: float(v) for k, v in metrics.items()},
            logits=logits, caches=caches, dec_logits=dec_logits,
            dec_caches=dec_caches)
    return out


def _tensors(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_build_step_matches_reference(arch, reference_steps):
    ref = reference_steps[arch]
    cfg = tcfgs.scaled_down(tcfgs.get_arch(arch), dtype="float32")
    train_c, pre_c, dec_c = (tcfgs.ShapeSpec(c.name, c.seq_len,
                                             c.global_batch, c.kind)
                             for c in _cells())
    params = _bridge.params_from_numpy(ref["params"], device="cpu")

    train = tsteps.build_step(cfg, train_c)
    assert train.kind == "train"
    opt_state = tsteps.make_optimizer(cfg).init(params)
    new_p, new_o, metrics = train.fn(params, opt_state, _tensors(ref["batch"]))
    assert set(metrics) == set(ref["metrics"])
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), v, err_msg=k, **TOL)
    _assert_trees_close(new_p, ref["new_params"], "new params")
    _assert_trees_close(new_o, ref["new_opt"], "new optimizer state")

    prefill = tsteps.build_step(cfg, pre_c)
    logits, caches = prefill.fn(params, _tensors(ref["pre_in"]))
    np.testing.assert_allclose(_np(logits), np.asarray(ref["logits"]), **TOL)
    _assert_trees_close(caches, ref["caches"], "prefill caches")

    decode = tsteps.build_step(cfg, dec_c)
    dec_logits, dec_caches = decode.fn(params, caches,
                                       torch.from_numpy(ref["token"]))
    np.testing.assert_allclose(_np(dec_logits), np.asarray(ref["dec_logits"]),
                               **TOL)
    _assert_trees_close(dec_caches, ref["dec_caches"], "decode caches")


# ---------------------------------------------------------------------------
# the launchers' main against the reference's
# ---------------------------------------------------------------------------
def _ref_smoke_params(arch):
    cfg = rcfgs.scaled_down(rcfgs.get_arch(arch), dtype="float32")
    init = rencdec.init_params if cfg.is_encoder_decoder \
        else rtfm.init_params
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), cfg))


def _run_reference(module, argv, monkeypatch):
    monkeypatch.setattr(module, "make_test_mesh", _auto_mesh)
    monkeypatch.setattr(sys, "argv", [module.__name__] + argv)
    module.main()


def test_reference_launcher_mesh_is_explicit():
    """Why the reference runs on ``_auto_mesh`` here: its own test mesh
    has ``Explicit`` axes on this jax."""
    from repro.launch.mesh import make_test_mesh
    assert set(make_test_mesh().axis_types) == {AxisType.Explicit}


def test_train_main_matches_reference(monkeypatch, capsys):
    argv = ["--smoke", "--steps", "3", "--batch", "2", "--seq", "16",
            "--lr", "1e-3"]
    seen = {}

    class Sup(rtrain.Supervisor):
        def run(self, n):
            seen["trainer"] = super().run(n)
            return seen["trainer"]

    monkeypatch.setattr(rtrain, "Supervisor", Sup)
    _run_reference(rtrain, argv, monkeypatch)
    ref_pipe = seen["trainer"].data_iter      # its prefetch thread stopped
    ref_pipe.close()
    ref_pipe._thread.join(timeout=10.0)
    ref_out = capsys.readouterr().out
    params = _ref_smoke_params("llama3.2-3b")
    monkeypatch.setattr(
        ttrain, "init_params",
        lambda cfg, device: _bridge.params_from_numpy(params, device=device))
    trainer = ttrain.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "done at step 3" in out and "done at step 3" in ref_out
    assert trainer.state.step == seen["trainer"].state.step == 3
    _assert_trees_close(trainer.state.params, seen["trainer"].state.params,
                        "trained params")
    assert not torch.distributed.is_initialized()


def test_train_main_resumes_from_checkpoint(tmp_path, capsys):
    argv = ["--smoke", "--batch", "2", "--seq", "16", "--device", "cpu",
            "--ckpt", str(tmp_path)]
    first = ttrain.main(argv + ["--steps", "2"])
    assert first.state.step == 2
    assert "done at step 2" in capsys.readouterr().out
    second = ttrain.main(argv + ["--steps", "4"])
    assert "done at step 4" in capsys.readouterr().out
    assert second.state.step == 4
    assert sorted(p.name for p in tmp_path.iterdir() if p.is_dir()) \
        == ["step_00000002", "step_00000004"]


_SERVED = re.compile(r"served (\d+) requests, (\d+) tokens in (\d+) decode "
                     r"steps \(occupancy (\d+)%, [\d.]+ tok/s, bsmm=(\w+)\)")


def _recording(module, monkeypatch):
    """``module.ServeEngine`` keeping every engine it builds."""
    engines, real = [], module.ServeEngine

    def build(**kw):
        engines.append(real(**kw))
        return engines[-1]

    monkeypatch.setattr(module, "ServeEngine", build)
    return engines


@pytest.mark.parametrize("pruned", ["0", "0.5"])
def test_serve_main_matches_reference(pruned, monkeypatch, capsys):
    argv = ["--arch", "llama3.2-3b", "--smoke", "--requests", "10",
            "--max-new", "4", "--pruned", pruned]
    ref_engines = _recording(rserve, monkeypatch)
    _run_reference(rserve, argv, monkeypatch)
    ref_out = capsys.readouterr().out
    params = _ref_smoke_params("llama3.2-3b")
    monkeypatch.setattr(
        tserve, "init_params",
        lambda cfg, device: _bridge.params_from_numpy(params, device=device))
    rep = tserve.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    ref_rep = ref_engines[0].report
    assert (rep.live_tiles, rep.total_tiles, rep.routed_matmuls) \
        == (ref_rep.live_tiles, ref_rep.total_tiles, ref_rep.routed_matmuls)
    ref_served, served = _SERVED.search(ref_out), _SERVED.search(out)
    assert ref_served and served, (ref_out, out)
    assert served.groups() == ref_served.groups()
    assert (rep.requests, rep.tokens_generated, rep.decode_steps) \
        == (10, 40, int(ref_served.group(3)))
    assert out.count("latency: ttft p50/p95") == 1
    sparsity = [line for line in out.splitlines() if "sparsity" in line]
    assert sparsity == [line for line in ref_out.splitlines()
                        if "sparsity" in line]
    assert bool(sparsity) == (pruned != "0")
    assert served.group(5) == ("on" if pruned != "0" else "off")


def test_serve_main_fleet_matches_reference(tmp_path, monkeypatch, capsys):
    argv = ["--arch", "llama3.2-3b", "--smoke", "--requests", "6",
            "--max-new", "3", "--engines", "2"]
    _run_reference(rserve, argv + ["--heartbeat-dir", str(tmp_path / "r")],
                   monkeypatch)
    ref_out = capsys.readouterr().out
    params = _ref_smoke_params("llama3.2-3b")
    monkeypatch.setattr(
        tserve, "init_params",
        lambda cfg, device: _bridge.params_from_numpy(params, device=device))
    rep = tserve.main(argv + ["--heartbeat-dir", str(tmp_path / "t"),
                              "--device", "cpu"])
    out = capsys.readouterr().out
    fleet = re.compile(r"fleet: (\d+)/(\d+) engines, (\d+) requests, (\d+) "
                       r"tokens \([\d.]+ tok/s, failovers (\d+), "
                       r"redispatched (\d+)\)")
    assert fleet.search(out).groups() == fleet.search(ref_out).groups() \
        == ("2", "2", "6", "18", "0", "0")
    assert (rep.engines, rep.requests, rep.tokens_generated) == (2, 6, 18)
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) \
        == ["engine0.hb", "engine1.hb"]


def test_serve_main_on_a_mesh_of_gloo_ranks(capsys):
    rep = tserve.main(["--arch", "llama3.2-3b", "--smoke", "--requests", "4",
                       "--max-new", "3", "--mesh", "1x2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert _SERVED.search(out).groups()[:3] == ("4", "12", str(rep.decode_steps))
    assert (rep.requests, rep.tokens_generated) == (4, 12)
    assert tserve.parse_mesh("2x4") == rserve.parse_mesh("2x4") == (2, 4)


def test_serve_refuses_an_encoder_decoder_arch():
    """The reference's launcher builds every arch through
    ``transformer.init_params``: whisper-tiny becomes a decoder-only stack
    of its widths (no encoder).  The port's transformer refuses it."""
    cfg = rcfgs.scaled_down(rcfgs.get_arch("whisper-tiny"), dtype="float32")
    tree = jax.eval_shape(lambda k: rtfm.init_params(k, cfg),
                          jax.ShapeDtypeStruct((2,), jnp.uint32))
    assert "segments" in tree and "enc" not in tree
    with pytest.raises(ValueError, match="encoder-decoder config"):
        tserve.main(["--arch", "whisper-tiny", "--smoke", "--device", "cpu"])
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("main", [ttrain.main, tserve.main],
                         ids=["train", "serve"])
def test_mains_raise_on_cuda_without_a_card(main):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--smoke", "--steps", "1"] if main is ttrain.main
             else ["--smoke", "--requests", "1"])


@pytest.mark.parametrize("arch,axes,what", [
    ("deepseek-v3-671b", {"data": 1, "model": 2}, "MLA attention"),
    ("recurrentgemma-2b", {"data": 1, "model": 2}, "recurrent blocks"),
    ("llama4-maverick-400b-a17b", {"data": 2, "model": 1}, "MoE aux loss")])
def test_train_main_full_config_on_ranks_raises(monkeypatch, arch, axes,
                                                what):
    """The production branch (more than one rank) builds its mesh and
    trains rank-local; the families it once refused (MLA and the
    recurrent blocks on a model axis, the MoE aux loss on a data axis)
    train now: ``main`` on gloo ranks, the production mesh's shape
    swapped for ``axes`` and the arch's config for a scaled one, takes
    its two steps and every rank ends with the same parameters."""
    from repro_torch.launch.mesh import run_ranks
    sys.path.insert(0, os.path.dirname(__file__))
    import _torch_ranks as ranks
    kw = dict(dtype="float32", n_layers=2)
    if arch == "deepseek-v3-671b":       # the rules' head guard at MLA's
        kw["head_dim"] = 16              # 24/16/16 head widths
    cfg = tcfgs.scaled_down(tcfgs.get_arch(arch), **kw)
    res = run_ranks(ranks.launcher_rank, axes["data"], axes["model"],
                    device="cpu", args=(arch, cfg))
    assert [r["step"] for r in res] == [2, 2], what
    assert np.array_equal(res[0]["norm"], res[1]["norm"])
    assert np.all(np.isfinite(res[0]["norm"]))
    assert res[0]["table_shape"][0] == cfg.padded_vocab // axes["model"]
    assert not torch.distributed.is_initialized()
