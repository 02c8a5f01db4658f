"""The port's serving slice against the reference's.

Same weights (the reference's ``init_params`` through the numpy bridge),
same crossbar ticket (numpy masks) and same requests go through
``repro`` (Pallas kernels in interpret mode) and ``repro_torch`` (plain
PyTorch versions on the CPU).  Prefill logits and caches agree to 1e-4
in float32; greedy and sampled token streams are identical.  The config
is llama3.2-3b scaled so that every projection tiles at 128.
"""
import ast
import json
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro_torch.configs as tcfgs
from repro.configs import get_arch, scaled_down
from repro.core.masks import apply_masks as r_apply_masks
from repro.models import transformer as rtfm
from repro.models.plans import build_decode_plan as r_build_plan
from repro.serve import Request as RRequest
from repro.serve import ServeEngine as RServeEngine
from repro.serve.engine import _default_buckets as r_default_buckets
from repro_torch import _bridge
from repro_torch.models import transformer as ttfm
from repro_torch.models.plans import build_decode_plan as t_build_plan
from repro_torch.serve import BlockPool, Request, ServeEngine, SubmitRejected
from repro_torch.serve.engine import _default_buckets

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SMALL = dict(dtype="float32", n_layers=2, d_model=256, n_heads=4,
             n_kv_heads=2, head_dim=64, d_ff=512)
PROJ = ("wq", "wk", "wv", "wo", "up", "gate", "down")
TOL = dict(rtol=1e-4, atol=1e-4)


def _ticket(params_np, seed=0, density=0.5):
    """One random 128x128 tile bitmap per projection and layer."""
    rng = np.random.default_rng(seed)

    def mk(path, a):
        if str(path[-1].key) not in PROJ:
            return None
        *lead, K, N = a.shape
        bm = rng.random((*lead, K // 128, N // 128)) < density
        bm[..., 0] = False                      # a dead column tile
        return np.repeat(np.repeat(bm, 128, -2), 128, -1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(mk, params_np)


@pytest.fixture(scope="module")
def slice_setup():
    rcfg = scaled_down(get_arch("llama3.2-3b"), **SMALL)
    tcfg = tcfgs.scaled_down(tcfgs.get_arch("llama3.2-3b"), **SMALL)
    rparams = rtfm.init_params(jax.random.PRNGKey(0), rcfg)
    params_np = jax.tree.map(np.asarray, rparams)
    masks = _ticket(params_np)
    return dict(rcfg=rcfg, tcfg=tcfg, masks=masks,
                rparams=r_apply_masks(rparams, masks),
                tparams=_bridge.apply_masks(
                    _bridge.params_from_numpy(params_np, device="cpu"), masks))


def _tokens(n, S, seed=3, vocab=512):
    toks = np.zeros((1, S), np.int32)
    toks[0, :n] = np.random.default_rng(seed).integers(1, vocab, size=n)
    return toks


# ---------------------------------------------------------------------------
# prefill and one paged decode step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("with_plan", [False, True])
@pytest.mark.parametrize("valid_len", [None, 11])
def test_prefill_matches_reference(slice_setup, with_plan, valid_len):
    s = slice_setup
    rplan = r_build_plan(s["masks"], interpret=True)[0] if with_plan else None
    tplan = t_build_plan(s["masks"])[0] if with_plan else None
    toks = _tokens(11 if valid_len else 16, 16)
    rl, rc = rtfm.prefill(s["rparams"], s["rcfg"],
                          {"tokens": jax.numpy.asarray(toks)}, 24,
                          valid_len=None if valid_len is None
                          else jax.numpy.asarray([valid_len]), plan=rplan)
    tl, tc = ttfm.prefill(s["tparams"], s["tcfg"],
                          {"tokens": torch.from_numpy(toks).long()}, 24,
                          valid_len=None if valid_len is None
                          else torch.tensor([valid_len]), plan=tplan)
    np.testing.assert_allclose(tl.numpy(), np.asarray(rl), **TOL)
    r_leaves = jax.tree.leaves(rc)
    t_leaves = _bridge.tree_leaves(_bridge.to_numpy(tc))
    assert len(r_leaves) == len(t_leaves) == 3
    for a, b in zip(r_leaves, t_leaves):
        np.testing.assert_allclose(b, np.asarray(a), **TOL)


def test_decode_step_paged_matches_reference(slice_setup):
    """Adopt a prefill into pool blocks, then one paged decode step over
    two rows (one live at 11 tokens, one idle on the scratch block)."""
    s = slice_setup
    rplan = r_build_plan(s["masks"], interpret=True)[0]
    tplan = t_build_plan(s["masks"])[0]
    toks = _tokens(11, 16)
    _, rdense = rtfm.prefill(s["rparams"], s["rcfg"],
                             {"tokens": jax.numpy.asarray(toks)}, 16,
                             valid_len=jax.numpy.asarray([11]), plan=rplan)
    _, tdense = ttfm.prefill(s["tparams"], s["tcfg"],
                             {"tokens": torch.from_numpy(toks).long()}, 16,
                             valid_len=torch.tensor([11]), plan=tplan)
    rpools = rtfm.adopt_prefill(s["rcfg"], rtfm.make_paged_caches(s["rcfg"], 4),
                                rdense, [2])
    tpools = ttfm.adopt_prefill(
        s["tcfg"], ttfm.make_paged_caches(s["tcfg"], 4, device="cpu"),
        tdense, [2])
    tables = np.asarray([[2, 0], [0, 0]], np.int32)
    lens = np.asarray([11, 0], np.int32)
    tok = np.asarray([[5], [7]], np.int32)
    rl, rpools = rtfm.decode_step_paged(s["rparams"], s["rcfg"], rpools,
                                        jax.numpy.asarray(tok), tables, lens,
                                        plan=rplan)
    tl, tpools = ttfm.decode_step_paged(
        s["tparams"], s["tcfg"], tpools, torch.from_numpy(tok).long(),
        torch.from_numpy(tables), torch.from_numpy(lens), plan=tplan)
    np.testing.assert_allclose(tl[0].numpy(), np.asarray(rl)[0], **TOL)
    r_leaves = jax.tree.leaves(rpools)
    t_leaves = _bridge.tree_leaves(_bridge.to_numpy(tpools))
    for a, b in zip(r_leaves, t_leaves):        # live block 2 only
        np.testing.assert_allclose(b[:, 2], np.asarray(a)[:, 2], **TOL)


def test_build_decode_plan_matches_reference(slice_setup):
    s = slice_setup
    rplan, rstats = r_build_plan(s["masks"], interpret=True)
    tplan, tstats = t_build_plan(s["masks"])
    assert (tstats.routed, tstats.live_tiles, tstats.total_tiles,
            tstats.by_layer) == (rstats.routed, rstats.live_tiles,
                                 rstats.total_tiles, rstats.by_layer)
    for group in ("attn", "mlp"):
        for key, p in rplan[0][0][group].items():
            np.testing.assert_array_equal(tplan[0][0][group][key].idx, p.idx)
    # tensor masks (e.g. on the card) give the same plan as numpy masks
    tmasks = jax.tree.map(torch.from_numpy, s["masks"])
    _, tstats2 = t_build_plan(tmasks)
    assert tstats2.by_layer == tstats.by_layer


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
def _ragged(cls, n=6, seed=1, max_new=6):
    rng = np.random.RandomState(seed)
    return [cls(uid=i, prompt=rng.randint(1, 512, size=rng.randint(4, 14)
                                          ).astype(np.int32),
                max_new_tokens=max_new)
            for i in range(n)]


def _run(eng, reqs):
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    assert all(r.done for r in done) and len(done) == len(reqs)
    return {r.uid: r.tokens for r in done}


@pytest.mark.parametrize("ticket,temperature", [(True, 0.0), (False, 0.0),
                                                (True, 0.8)])
def test_engine_streams_match_reference(slice_setup, ticket, temperature):
    """Ragged requests over 3 slots, capacity below one KV block: the
    port's token streams equal the reference's, greedy and sampled."""
    s = slice_setup
    masks = s["masks"] if ticket else None
    kw = dict(batch_slots=3, capacity=48, masks=masks,
              temperature=temperature, sample_seed=4)
    ref = RServeEngine(params=s["rparams"], cfg=s["rcfg"],
                       prefill_fn=rtfm.prefill, decode_fn=rtfm.decode_step,
                       **kw)
    want = _run(ref, _ragged(RRequest))
    eng = ServeEngine(params=s["tparams"], cfg=s["tcfg"], device="cpu", **kw)
    got = _run(eng, _ragged(Request))
    assert got == want
    rr, tr = ref.report, eng.report
    for f in ("requests", "prefills", "decode_steps", "tokens_generated",
              "slot_occupancy", "bsmm_enabled", "routed_matmuls",
              "live_tiles", "total_tiles", "kv_blocks", "kv_blocks_live",
              "kv_blocks_peak", "kv_block_bytes", "kv_bytes_per_token"):
        assert getattr(tr, f) == getattr(rr, f), f
    eng.generations[-1].pool.check()


def test_engine_crosses_block_boundary_and_waits_for_blocks(slice_setup):
    """A 126-token prompt decodes across the 128-token block edge; with
    a 3-block pool the second request waits until the first frees."""
    s = slice_setup
    prompts = [np.arange(1, 127, dtype=np.int32) % 500 + 1,
               np.arange(3, 60, dtype=np.int32)]
    kw = dict(batch_slots=2, capacity=64, kv_blocks=3)
    ref = RServeEngine(params=s["rparams"], cfg=s["rcfg"],
                       prefill_fn=rtfm.prefill, decode_fn=rtfm.decode_step,
                       **kw)
    want = _run(ref, [RRequest(uid=i, prompt=p, max_new_tokens=5)
                      for i, p in enumerate(prompts)])
    eng = ServeEngine(params=s["tparams"], cfg=s["tcfg"], device="cpu", **kw)
    got = _run(eng, [Request(uid=i, prompt=p, max_new_tokens=5)
                     for i, p in enumerate(prompts)])
    assert got == want
    assert eng.report.kv_blocks_peak == 2 and eng.kv_blocks_live == 0


def test_engine_eos_and_on_token(slice_setup):
    s = slice_setup
    seen = []
    eng = ServeEngine(params=s["tparams"], cfg=s["tcfg"], device="cpu",
                      batch_slots=2, capacity=32)
    first = _run(eng, [Request(uid=0, prompt=np.arange(1, 6, dtype=np.int32),
                               max_new_tokens=4)])[0]
    eng2 = ServeEngine(params=s["tparams"], cfg=s["tcfg"], device="cpu",
                       batch_slots=2, capacity=32)
    req = Request(uid=0, prompt=np.arange(1, 6, dtype=np.int32),
                  max_new_tokens=4, eos_id=first[1], on_token=seen.append)
    got = _run(eng2, [req])[0]
    assert got == first[:2] and seen == got and req.status == "done"


def test_submit_rejections(slice_setup):
    s = slice_setup
    eng = ServeEngine(params=s["tparams"], cfg=s["tcfg"], device="cpu",
                      batch_slots=1, capacity=16, kv_blocks=2, queue_limit=1)
    cases = [(Request(uid=1, prompt=np.zeros(0, np.int32)), "empty_prompt"),
             (Request(uid=2, prompt=np.ones(3, np.int32), max_new_tokens=0),
              "bad_budget"),
             (Request(uid=3, prompt=np.ones(120, np.int32),
                      max_new_tokens=9), "oversize")]
    for req, reason in cases:
        with pytest.raises(SubmitRejected) as e:
            eng.submit(req)
        assert e.value.reason == reason and not e.value.retryable
    eng.submit(Request(uid=4, prompt=np.ones(3, np.int32)))
    with pytest.raises(SubmitRejected) as e:
        eng.submit(Request(uid=5, prompt=np.ones(3, np.int32)))
    assert e.value.reason == "capacity" and e.value.retryable


def test_engine_deadline_expires_queued_request(slice_setup):
    s = slice_setup
    now = [0.0]
    eng = ServeEngine(params=s["tparams"], cfg=s["tcfg"], device="cpu",
                      batch_slots=1, capacity=32, clock=lambda: now[0])
    late = Request(uid=1, prompt=np.ones(3, np.int32), deadline_s=1.0)
    eng.submit(Request(uid=0, prompt=np.ones(3, np.int32), max_new_tokens=3))
    eng.submit(late)
    eng.step()
    now[0] = 5.0
    eng.run()
    assert late.status == "expired" and eng.report.deadline_misses == 1


def test_engine_requires_cuda_unless_cpu(slice_setup, monkeypatch):
    s = slice_setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(params=s["tparams"], cfg=s["tcfg"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttfm.init_params(torch.Generator(), s["tcfg"])
    params = ttfm.init_params(torch.Generator().manual_seed(0), s["tcfg"],
                              device="cpu")
    assert params["segments"][0][0]["attn"]["wq"].shape == (2, 256, 256)
    assert ServeEngine(params=params, cfg=s["tcfg"], device="cpu").paged


def test_not_yet_ported_paths_raise(slice_setup, capsys):
    """Nothing is left "not yet ported": the encoder-decoder places its
    heads on a model axis > 1 (``frame_adapter`` alone kept whole) and
    the MoE aux loss trains on a data axis > 1, global over the batch
    (meshes serve and train every family:
    ``tests/test_torch_mesh_families.py``).  Encoder frames are admitted
    (the frames lane: ``tests/test_torch_encdec.py``), MoE trains, and
    ``lint`` runs, ``--hlo`` too, which exits as the reference's does (0
    on a family with no serving prefill to trace:
    ``tests/test_torch_lint.py``)."""
    from repro_torch.api import cli
    from repro_torch.distributed import tensor_parallel as tpar
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import encdec, hooks

    model_mesh = AbstractMesh({"data": 1, "model": 2})  # rank 0, no group
    wcfg = tcfgs.scaled_down(tcfgs.get_arch("whisper-tiny"),
                             dtype="float32")
    wparams = encdec.init_params(torch.Generator().manual_seed(0), wcfg,
                                 device="cpu")
    sm = tpar.ShardedModel.from_full(wparams, wcfg,
                                     tpar.mesh_rules(model_mesh, wcfg))
    assert [p for p, _ in sm.whole] == ["frame_adapter"]
    assert (sm.cfg.n_heads, sm.cfg.n_kv_heads) == (wcfg.n_heads // 2,
                                                   wcfg.n_kv_heads // 2)
    assert sm.params["dec"]["xattn"]["wq"].shape[-1] == \
        wparams["dec"]["xattn"]["wq"].shape[-1] // 2
    eng = ServeEngine(params=wparams, cfg=wcfg, prefill_fn=encdec.prefill,
                      decode_fn=encdec.decode_step, batch_slots=2,
                      capacity=16, device="cpu")
    frames = np.zeros((wcfg.encoder_seq_len, wcfg.d_model), np.float32)
    req = Request(uid=0, prompt=np.ones(3, np.int32), max_new_tokens=2,
                  frames=frames)
    eng.submit(req)
    eng.run()
    assert req.status == "done" and req.tokens == eng.smoke_decode(
        np.ones(3, np.int32), 2, frames=frames)
    assert cli.main(["lint", "--arch", "vgg11", "--hlo", "--json",
                     "--device", "cpu"]) == cli.EXIT_OK
    out = json.loads(capsys.readouterr().out)
    assert out["arch"] == "vgg11" and out["summary"]["ok"]
    # MoE serves and trains: the training forward returns its aux loss
    moe_cfg = tcfgs.scaled_down(tcfgs.get_arch("llama3.2-3b"),
                                moe=tcfgs.MoEConfig(4, 2, 64))
    moe_params = ttfm.init_params(torch.Generator(), moe_cfg, device="cpu")
    logits, aux = ttfm.forward(moe_params, moe_cfg,
                               {"tokens": torch.zeros(1, 4, dtype=torch.long)})
    assert logits.shape == (1, 4, moe_cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all()) and float(aux) > 0

    # on a data axis the train loss's scope sums the aux loss's
    # statistics over the data ranks, and only there
    data_mesh = AbstractMesh({"data": 2, "model": 1})   # rank 0, no group
    sm = tpar.ShardedModel.from_full(moe_params, moe_cfg,
                                     tpar.mesh_rules(data_mesh, moe_cfg))
    assert callable(tpar.train_loss(sm))
    with sm.global_scope():
        assert hooks.moe_aux_sum() is not None and hooks.moe_groups() == 1
    with sm.scope():
        assert hooks.moe_aux_sum() is None and hooks.moe_groups() == 2
    assert hooks.moe_aux_sum() is None


@pytest.mark.parametrize("limit", [2, 9, 128, 640, 4096])
def test_default_buckets_match_reference(limit):
    assert _default_buckets(limit) == r_default_buckets(limit)


def test_block_pool_discipline():
    pool = BlockPool(5)
    pool.reserve(1, 2)
    pool.reserve(2, 2)
    assert not pool.can_reserve(1)
    a, b = pool.alloc(1), pool.alloc(2)
    assert 0 not in (a, b) and pool.live == 2
    pool.check()
    assert pool.release(1) == (a,)
    assert pool.available == 2
    pool.check()


# ---------------------------------------------------------------------------
# the port stands alone: no JAX, nothing of repro
# ---------------------------------------------------------------------------
def test_import_loads_neither_jax_nor_repro():
    code = (
        "import sys, repro_torch, repro_torch.serve, repro_torch._bridge, "
        "repro_torch.models.transformer, repro_torch.kernels._build, "
        "repro_torch.serve.frontend, repro_torch.serve.manager, "
        "repro_torch.serve.fleet, repro_torch.api.cli, "
        "repro_torch.distributed.fault_tolerance, repro_torch.models.encdec, "
        "repro_torch.models.recurrent, repro_torch.data, "
        "repro_torch.analysis, repro_torch.kernels.spec, "
        "repro_torch.launch.steps, repro_torch.launch.train, "
        "repro_torch.launch.serve, repro_torch.launch.dryrun, "
        "repro_torch.launch.hlo_analysis, repro_torch.launch.costs\n"
        "import glob, runpy\n"
        "examples = sorted(glob.glob('examples/torch_*.py'))\n"
        "assert len(examples) == 5, examples\n"
        "for path in examples:\n"
        "    runpy.run_path(path, run_name='example')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', "
        "'jaxlib', 'repro')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=str(ROOT),
                   env={"PYTHONPATH": "src"})


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_sources_import_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    examples = sorted((ROOT / "examples").glob("torch_*.py"))
    assert len(examples) == 5
    files += examples
    assert len(files) > 10
    assert {"steps.py", "train.py", "serve.py", "dryrun.py",
            "hlo_analysis.py", "costs.py"} <= {f.name for f in files}
    for f in files:
        roots = set(_imported_roots(f))
        assert not roots & {"jax", "jaxlib", "repro"}, f
