"""Distribution in the port: grouped MoE dispatch against the reference,
and meshes of two and four gloo ranks on the CPU.

Grouped MoE: ``repro_torch.models.moe.moe_forward(num_groups=,
capacity=)`` against ``repro.models.moe.moe_forward`` on the same numpy
inputs (f32, 1e-5; ``drop_fraction`` and the aux loss equal).

Meshes: ``launch.mesh.run_ranks`` spawns the ranks (a few seconds each
spawn, so each spawn runs many checks; the rank bodies are in
``tests/_torch_ranks.py``).  The sharded runs are held to the port's
single-device runs and to the reference's single-device engine, never
to the reference's multi-device oracles:

  * ``ServeEngine`` on (1, 2) and (2, 1) at the reference oracle's
    scenario (llama3.2-3b tiny, 3 prompts, 6 new tokens, dense and
    pruned, slot and paged KV): greedy streams equal to both
    single-device engines, logits within 1e-5 relative; the J208 audit
    clean;
  * a tile-aligned llama (d_model 512, 4 heads of 128, 2 kv heads, d_ff
    1024): every projection on a local plan, each kernel wrapper entered
    at the rank's local shapes;
  * engines on two meshes and a meshless one stepped in turns in one
    process;
  * MoE on (2, 1): the reference's grouped semantics (G = data shards at
    prefill, one group a shard at decode);
  * the (2, 2) tensor- and data-parallel loss against the single-device
    losses; the checkpoint it writes restored onto (1, 2) by
    ``elastic_restore`` (and read by the reference's ``load_pytree``);
  * ``compressed_psum`` and ``dp_allreduce_compressed`` against numpy;
    ``ShardedBatcher``'s rows; ``api.cli serve --mesh 1x2``.

One-rank and no-group cases run in process: ``make_test_mesh``'s
errors, ``elastic_restore`` and ``compressed_psum`` at one rank,
``Supervisor`` and ``SkipStraggler``.
"""
import json
import os
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro_torch.configs as tcfgs
from repro.api import structured_prune as r_structured_prune
from repro.checkpoint.manager import load_pytree as r_load_pytree
from repro.configs import MoEConfig as RMoEConfig
from repro.configs import PruneConfig, get_arch, scaled_down
from repro.core.masks import lm_prunable as r_lm_prunable
from repro.distributed.compression import \
    compressed_psum as r_compressed_psum
from repro.kernels.bsmm import make_tile_plan as r_make_tile_plan
from repro.models import hooks as r_hooks
from repro.models import moe as rmoe
from repro.models import transformer as rtfm
from repro.serve import Request as RRequest
from repro.serve import ServeEngine as RServeEngine
from repro_torch import _bridge
from repro_torch.api import cli
from repro_torch.api import structured_prune
from repro_torch.configs import PruneConfig as TPruneConfig
from repro_torch.core.masks import lm_prunable, tree_flatten_with_path
from repro_torch.distributed.compression import compressed_psum
from repro_torch.distributed.fault_tolerance import (SkipStraggler,
                                                     Supervisor,
                                                     elastic_restore)
from repro_torch.distributed.tensor_parallel import (ShardedModel,
                                                     mesh_rules,
                                                     sharded_loss)
from repro_torch.kernels.bsmm import make_tile_plan
from repro_torch.launch.mesh import (make_cpu_mesh, make_production_mesh,
                                     make_test_mesh, mesh_axes, parse_mesh,
                                     run_ranks)
from repro_torch.models import hooks
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttfm

sys.path.insert(0, os.path.dirname(__file__))
import _torch_ranks as ranks  # noqa: E402

torch.set_num_threads(2)
TOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _prompts(vocab, n=3, seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, size=rng.randint(4, 14)).astype(np.int32)
            for _ in range(n)]


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


# ---------------------------------------------------------------------------
# grouped MoE dispatch against the reference
# ---------------------------------------------------------------------------
MOE = dict(d=128, f=256, E=4, k=2)


def _moe_inputs(T, tied, seed=0):
    rng = np.random.RandomState(seed)
    d, f, E = MOE["d"], MOE["f"], MOE["E"]
    p = {"router": (np.zeros((d, E)) if tied
                    else rng.randn(d, E) * 0.3).astype(np.float32),
         "up": (rng.randn(E, d, f) * 0.1).astype(np.float32),
         "gate": (rng.randn(E, d, f) * 0.1).astype(np.float32),
         "down": (rng.randn(E, f, d) * 0.1).astype(np.float32)}
    # a ~50 % tile ticket shared by the experts' union plan
    masks = {}
    for key, (K, N) in (("up", (d, f)), ("gate", (d, f)), ("down", (f, d))):
        tiles = rng.rand(K // 128, N // 128) < 0.5
        tiles[0, 0] = True
        m = np.kron(tiles, np.ones((128, 128))).astype(np.float32)
        masks[key] = m
        p[key] = p[key] * m
    x = rng.randn(2, T // 2, d).astype(np.float32)
    return p, masks, x


@pytest.mark.parametrize("G,T,capacity,tied,with_plan", [
    (1, 32, None, False, False), (2, 32, 8, False, False),
    (4, 30, None, False, False), (2, 32, None, True, False),
    (1, 32, None, False, True), (2, 32, None, False, True),
    (4, 32, 16, False, True), (4, 30, None, True, True)])
def test_grouped_moe_matches_reference(G, T, capacity, tied, with_plan):
    moe_cfg = tcfgs.MoEConfig(MOE["E"], MOE["k"], MOE["f"])
    r_moe_cfg = RMoEConfig(MOE["E"], MOE["k"], MOE["f"])
    p, masks, x = _moe_inputs(T, tied)
    tplan = ({k: make_tile_plan(m) for k, m in masks.items()}
             if with_plan else None)
    rplan = ({k: r_make_tile_plan(m) for k, m in masks.items()}
             if with_plan else None)
    got = tmoe.moe_forward({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x), moe_cfg, "silu", True,
                           capacity=capacity, num_groups=G, plan=tplan)
    want = rmoe.moe_forward({k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(x), r_moe_cfg, "silu", True,
                            capacity=capacity, num_groups=G, plan=rplan)
    np.testing.assert_allclose(got.y.numpy(), np.asarray(want.y),
                               rtol=TOL, atol=TOL)
    assert float(got.drop_fraction) == float(want.drop_fraction)
    np.testing.assert_allclose(float(got.aux_loss), float(want.aux_loss),
                               rtol=1e-6)
    # the groups' own capacity: C from T/G tokens, as the formula says
    Gu = tmoe._num_groups(T, G)
    C = capacity or tmoe.expert_capacity(T // Gu, moe_cfg)
    assert Gu == rmoe._num_groups(T, G) and T % Gu == 0 and C % 8 == 0


def test_moe_groups_hook_defaults_and_scopes():
    assert hooks.moe_groups() == 1
    assert tmoe._num_groups(30, None) == 1
    hooks.set_moe_groups(4)
    try:
        assert tmoe._num_groups(30, None) == 3      # walks down to divide
        assert tmoe._num_groups(2, None) == 2
    finally:
        hooks.set_moe_groups(1)


# ---------------------------------------------------------------------------
# mesh runs
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Weights, tickets and every single-device run the mesh runs are
    held to (the reference's engine once per scenario), then the (2, 2)
    loss spawn, whose checkpoint the (1, 2) spawn restores."""
    rcfg = scaled_down(get_arch("llama3.2-3b"), dtype="float32")
    tcfg = ranks.tiny_llama()
    rparams = rtfm.init_params(jax.random.PRNGKey(0), rcfg)
    masks = _np(r_structured_prune(rparams, [("filter", 0.2)],
                                   prunable=r_lm_prunable, cfg=PruneConfig()))
    params_np = _np(rparams)
    prompts = _prompts(rcfg.vocab_size)
    ref, port = {}, {}
    tparams = _bridge.params_from_numpy(params_np, device="cpu")
    for paged in (False, True):
        for pruned in (False, True):
            m = masks if pruned else None
            eng = RServeEngine(params=rparams, cfg=rcfg,
                               prefill_fn=rtfm.prefill,
                               decode_fn=rtfm.decode_step, batch_slots=2,
                               capacity=48, paged=paged, masks=m)
            for i, p in enumerate(prompts):
                eng.submit(RRequest(uid=i, prompt=p, max_new_tokens=6))
            ref[(paged, pruned)] = {r.uid: list(r.tokens) for r in eng.run()}
            _, streams, rows = ranks.serve(tcfg, tparams, m, prompts,
                                           paged=paged)
            port[(paged, pruned)] = (streams, rows)

    # the tile-aligned variant: the port's own weights and ticket
    acfg = ranks.aligned_llama()
    aparams = ttfm.init_params(torch.Generator().manual_seed(3), acfg,
                               device="cpu")
    amasks = structured_prune(aparams, [("xbar", 0.5)],
                              prunable=lm_prunable, cfg=TPruneConfig())
    aparams = _bridge.apply_masks(aparams, amasks)
    aligned = {"params": _bridge.to_numpy(aparams),
               "masks": _bridge.to_numpy(amasks)}
    _, astreams, arows = ranks.serve(acfg, aparams, amasks, prompts)

    # MoE: the reference's grouped semantics on two data shards, which a
    # meshless engine shows with two groups installed
    mcfg = ranks.tiny_moe()
    rmcfg = scaled_down(get_arch("llama3.2-3b"), dtype="float32",
                        n_layers=2, moe=RMoEConfig(4, 2, 64))
    rmparams = rtfm.init_params(jax.random.PRNGKey(5), rmcfg)
    mparams = _bridge.params_from_numpy(_np(rmparams), device="cpu")
    mprompts = _prompts(rmcfg.vocab_size, n=4, seed=2)
    hooks.set_moe_groups(2)
    r_hooks.set_moe_groups(2)
    try:
        _, moe_port, _ = ranks.serve(mcfg, mparams, None, mprompts,
                                     paged=False)
        eng = RServeEngine(params=rmparams, cfg=rmcfg,
                           prefill_fn=rtfm.prefill,
                           decode_fn=rtfm.decode_step, batch_slots=2,
                           capacity=48, paged=False)
        for i, p in enumerate(mprompts):
            eng.submit(RRequest(uid=i, prompt=p, max_new_tokens=6))
        moe_ref = {r.uid: list(r.tokens) for r in eng.run()}
    finally:
        hooks.set_moe_groups(1)
        r_hooks.set_moe_groups(1)

    # the (2, 2) loss and the checkpoint it saves
    ycfg = scaled_down(get_arch("yi-6b"), dtype="float32", d_model=128,
                       n_heads=4, n_kv_heads=4, head_dim=32)
    yparams = _np(rtfm.init_params(jax.random.PRNGKey(0), ycfg))
    rng = np.random.RandomState(0)
    batch = {"tokens": rng.randint(0, ycfg.vocab_size, (8, 32)),
             "labels": rng.randint(0, ycfg.vocab_size, (8, 32))}
    r_loss = float(rtfm.loss_fn(jax.tree.map(jnp.asarray, yparams), ycfg,
                                jax.tree.map(jnp.asarray, batch))[0])
    ty = _bridge.params_from_numpy(yparams, device="cpu")
    t_loss = float(ttfm.loss_fn(ty, ranks.yi_loss_cfg(),
                                {k: torch.from_numpy(v)
                                 for k, v in batch.items()})[0])
    ckpt_dir = str(tmp_path_factory.mktemp("ckpt22"))
    loss22 = run_ranks(ranks.loss_rank, 2, 2, device="cpu",
                       args=(yparams, batch, ckpt_dir))
    grads = np.random.RandomState(9).randn(2, 40).astype(np.float32)
    ckpt = {"dir": ckpt_dir, "params": yparams, "batch": batch,
            "grads": grads}
    return SimpleNamespace(
        rcfg=rcfg, params_np=params_np, masks=masks, prompts=prompts,
        ref=ref, port=port, aligned=aligned, astreams=astreams,
        arows=arows, moe_np=_np(rmparams), mprompts=mprompts,
        moe_port=moe_port, moe_ref=moe_ref, yparams=yparams, ycfg=ycfg,
        batch=batch, r_loss=r_loss, t_loss=t_loss, loss22=loss22,
        ckpt=ckpt, grads=grads)


@pytest.fixture(scope="module")
def model_axis(setup):
    return run_ranks(ranks.model_axis_rank, 1, 2, device="cpu",
                     args=(setup.params_np, setup.masks, setup.prompts,
                           setup.aligned, setup.ckpt))


@pytest.fixture(scope="module")
def data_axis(setup):
    return run_ranks(ranks.data_axis_rank, 2, 1, device="cpu",
                     args=(setup.params_np, setup.masks, setup.prompts,
                           {"params": setup.moe_np,
                            "prompts": setup.mprompts},
                           setup.grads))


def _check_scenarios(setup, results, mesh):
    for key, want in setup.ref.items():
        streams, rows = setup.port[key]
        assert streams == want, (mesh, key)   # port == reference, meshless
        for res in results:
            got = res["scenarios"][key]
            assert got["streams"] == want, (mesh, key, res["rank"])
            for uid, r in rows.items():
                assert _rel(got["rows"][uid], r) < TOL, (mesh, key, uid)
            assert not [a for a in got["audit"] if a[1] == "error"]
            if mesh == "1x2":           # the model axis is live: clean
                assert got["audit"] == []


def test_engine_on_model_axis_matches_single_device(setup, model_axis):
    _check_scenarios(setup, model_axis, "1x2")
    sc = model_axis[0]["scenarios"]
    # dense: every block sharded; the pruned ticket's wq/wo shards would
    # cut a 128-tile, so the tiny attention stays whole (and is listed)
    assert sc[(True, False)]["whole"] == []
    whole = {p.split("/")[-1] for p, _ in sc[(True, True)]["whole"]}
    assert whole == {"wq", "wk", "wv", "wo"}


def test_engine_on_data_axis_matches_single_device(setup, data_axis):
    _check_scenarios(setup, data_axis, "2x1")
    for res in data_axis:
        assert res["scenarios"][(True, True)]["whole"] == []


def test_tile_aligned_projections_run_on_local_plans(setup, model_axis):
    for res in model_axis:
        a = res["aligned"]
        assert a["whole"] == [] and a["dense_fallback"] == 0
        assert a["streams"] == setup.astreams
        for uid, rows in setup.arows.items():
            assert _rel(a["rows"][uid], rows) < TOL
        ws = {w for name, _, w in a["seen"] if name.startswith("bsmm")}
        # d_model 512, Hq·hd 512 → 256, Hkv·hd 256 → 128, d_ff 1024 → 512
        assert ws == {(512, 256), (512, 128), (256, 512), (512, 512)}, ws
        assert len([s for s in a["seen"] if s[0].startswith("bsmm")]) \
            % 7 == 0                     # 7 projections a layer, all planned
        heads = {(name, q[-2], k) for name, q, k in a["seen"]
                 if name in ("flash_attention", "paged_attention")}
        assert {n for n, _, _ in heads} == {"flash_attention",
                                            "paged_attention"}
        assert {q for _, q, _ in heads} == {2}        # 4 q heads / 2 ranks
        assert all(k[-2] == 1 for _, _, k in heads)   # 2 kv heads / 2 ranks


def test_biases_on_the_model_axis(model_axis):
    """qwen2's q/k/v biases and an MLP's (seeded noise) cut to the
    rank's columns, the row-parallel bias added once: the (1, 2) engine
    serves its rank's own meshless streams and logits."""
    for res in model_axis:
        (want, want_rows), (got, rows) = res["biases"]
        assert got == want
        for uid, r in want_rows.items():
            assert _rel(rows[uid], r) < TOL


@pytest.mark.parametrize("paged", [False, True])
def test_kv_kept_whole_attends_local_q_heads(model_axis, paged):
    """3 kv heads do not divide over 2 ranks: the rules put wk/wv on
    their input dim, the engine keeps K/V (and their caches) whole and
    each rank attends its 3 of 6 q heads against the kv heads they map
    to; streams and logits are the rank's meshless engine's."""
    for res in model_axis:
        got = res["kv_whole"][paged]
        (want, want_rows), (streams, rows) = got["runs"]
        assert streams == want
        for uid, r in want_rows.items():
            assert _rel(rows[uid], r) < TOL
        assert got["heads"] == (3, 3)
        assert {p.split("/")[-1] for p, _ in got["whole"]} == {"wk", "wv"}


def test_two_meshes_coexist_in_one_process(setup, model_axis):
    want = setup.ref[(True, True)]
    for res in model_axis:
        assert res["coexist"] == [want, want, want]


def test_moe_engine_on_data_axis_takes_the_shards_groups(setup, data_axis):
    assert setup.moe_port == setup.moe_ref
    for res in data_axis:
        assert res["moe"] == setup.moe_ref


def test_sharded_loss_and_elastic_restore(setup, model_axis, tmp_path):
    assert abs(setup.t_loss - setup.r_loss) < 1e-4
    for res in setup.loss22:
        assert abs(res["loss"] - setup.t_loss) < TOL
        assert abs(res["loss"] - setup.r_loss) < 1e-4
        assert res["whole"] == [] and res["local_wo"] == (4, 64, 128)
    for res in model_axis:
        r = res["restored"]
        assert r["step"] == 7 and r["local_wq"] == (4, 128, 64)
        assert abs(r["loss"] - setup.loss22[0]["loss"]) < TOL
        # a pruned ticket's q/kv shards would cut 128-tiles: restored
        # whole, exactly where the engine's placement keeps them
        p = res["restored_pruned"]
        assert p["same"] and p["leaves"] > 0
        assert p["whole"] == p["full_whole"]
        assert {path.split("/")[-1] for path, _ in p["whole"]} \
            >= {"wq", "wo"}
        assert p["heads"] == (4, 4)
        assert abs(p["loss"] - setup.t_loss) < TOL
    # the checkpoint is the reference's format: its load_pytree reads it
    tmpl = {"params": jax.tree.map(jnp.asarray, setup.yparams),
            "step": np.zeros((), np.int64)}
    got = r_load_pytree(os.path.join(setup.ckpt["dir"], "step_00000007"),
                        tmpl)
    for a, b in zip(jax.tree.leaves(got["params"]),
                    jax.tree.leaves(setup.yparams)):
        np.testing.assert_array_equal(np.asarray(a), b)


def _topk_sum(gs, k):
    out = np.zeros_like(gs[0])
    for g in gs:
        idx = np.argsort(-np.abs(g), kind="stable")[:k]
        out[idx] += g[idx]
    return out


def test_compressed_allreduce_over_two_ranks(setup, model_axis, data_axis):
    want = _topk_sum(setup.grads, 5)
    for res in model_axis:
        np.testing.assert_allclose(res["psum"], want, rtol=1e-6)
    w = _topk_sum(setup.grads, 10)             # k = 0.25 · 40
    v = _topk_sum([g[:3] * 2.0 for g in setup.grads], 1)
    for res in data_axis:
        np.testing.assert_allclose(res["dp_grads"]["w"], w, rtol=1e-6)
        np.testing.assert_allclose(res["dp_grads"]["v"], v, rtol=1e-6)


def test_sharded_batcher_rows(data_axis):
    for res in data_axis:
        d = res["rank"]
        for step, b in enumerate(res["batches"]):
            full = np.arange(32).reshape(8, 4) + step
            np.testing.assert_array_equal(b["tokens"], full[4 * d:4 * d + 4])
            np.testing.assert_array_equal(b["odd"], np.arange(3))


def test_cli_serve_on_a_mesh_prints_the_meshless_tokens(capsys):
    argv = ["serve", "--arch", "llama3.2-3b", "--device", "cpu", "--scale",
            "tiny", "--requests", "3", "--max-new", "4", "--json"]
    assert cli.main(argv) == cli.EXIT_OK
    base = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert cli.main(argv + ["--mesh", "1x2"]) == cli.EXIT_OK
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["streams"] == base["streams"] and got["requests"] == 3


# ---------------------------------------------------------------------------
# one rank, no group
# ---------------------------------------------------------------------------
@pytest.fixture
def one_rank():
    """A one-rank gloo group in this process, torn down afterwards."""
    mesh = make_cpu_mesh()
    assert mesh_axes(mesh) == {"data": 1, "model": 1}
    yield mesh
    dist.destroy_process_group()


def test_make_test_mesh_needs_its_ranks_and_a_card():
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="run_ranks"):
        make_test_mesh(2, 1, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_test_mesh(1, 2, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_ranks(ranks.loss_rank, 1, 2, device="cuda")
    for multi_pod, n in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"needs {n} ranks"):
            make_production_mesh(multi_pod=multi_pod, device="cpu")
    assert parse_mesh("2X4") == (2, 4)
    for bad in ("2", "0x2", "axb"):
        with pytest.raises(ValueError, match="--mesh"):
            parse_mesh(bad)
    assert not dist.is_initialized()


def test_ranks_take_a_card_each_under_nccl(monkeypatch):
    """NCCL rank r drives the r-th card from the given device; gloo
    ranks share it; more NCCL ranks than cards are refused before any
    spawn, and the CLI's backend is gloo then."""
    import repro_torch.launch.mesh as mesh_mod
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cuda = torch.device
    assert [mesh_mod.rank_device("cuda", r, "nccl") for r in range(2)] \
        == [cuda("cuda", 0), cuda("cuda", 1)]
    assert mesh_mod.rank_device("cuda:1", 0, "nccl") == cuda("cuda", 1)
    assert {mesh_mod.rank_device("cuda", r, "gloo") for r in range(4)} \
        == {cuda("cuda", 0)}
    assert mesh_mod.rank_device("cpu", 3, "gloo") == cuda("cpu")
    assert [mesh_mod.spawn_backend(d, w) for d, w in (
        ("cuda", 2), ("cuda", 3), ("cuda:1", 2), ("cuda:1", 1),
        ("cpu", 1))] == ["nccl", "gloo", "gloo", "nccl", "gloo"]
    monkeypatch.setattr(mesh_mod, "resolve_device",
                        lambda d: cuda("cuda", 0))
    with pytest.raises(ValueError, match="3 ranks, 2 card"):
        run_ranks(ranks.loss_rank, 1, 3, device="cuda")
    with pytest.raises(ValueError, match="backend='gloo'"):
        run_ranks(ranks.loss_rank, 2, 2, device="cuda", backend="nccl")


def test_one_rank_mesh_elastic_restore_and_psum(setup, one_rank):
    with pytest.raises(ValueError, match="has 1"):
        make_test_mesh(1, 2, device="cpu")
    tmpl = {"params": _bridge.params_from_numpy(setup.yparams, device="cpu"),
            "step": np.zeros((), np.int64)}
    ycfg = ranks.yi_loss_cfg()
    step, tree = elastic_restore(setup.ckpt["dir"], tmpl, one_rank,
                                 cfg=ycfg)
    assert step == 7
    for (_, a), (_, b) in zip(tree_flatten_with_path(tree["params"]),
                              tree_flatten_with_path(tmpl["params"])):
        assert torch.equal(a, b)
    model = ShardedModel.from_local(tree["params"], tmpl["params"], ycfg,
                                    mesh_rules(one_rank, ycfg))
    assert model.tp is None
    assert abs(sharded_loss(model, setup.batch) - setup.t_loss) < TOL
    # one rank: the reference's compressed_psum over a one-shard axis
    g = setup.grads[0]
    want = jax.vmap(lambda x: r_compressed_psum(x, "i", 5),
                    axis_name="i")(jnp.asarray(g)[None])[0]
    got = compressed_psum(torch.from_numpy(g), one_rank.get_group("data"), 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# restart and straggler policies
# ---------------------------------------------------------------------------
class _FakeTrainer:
    """Resumes at the shared ``saved`` step; fails at ``fail_at`` while
    failures remain."""

    def __init__(self, box):
        self.box = box
        self.state = SimpleNamespace(step=box["saved"])

    def run(self, n):
        for _ in range(n):
            if self.box["failures"] and self.state.step == self.box["fail_at"]:
                self.box["failures"] -= 1
                raise RuntimeError("injected failure")
            self.state.step += 1
            self.box["saved"] = self.state.step   # checkpoint every step


def test_supervisor_restarts_and_gives_up():
    box = {"saved": 0, "fail_at": 3, "failures": 2}
    sup = Supervisor(lambda: _FakeTrainer(box), max_restarts=3)
    tr = sup.run(6)
    assert tr.state.step == 6 and sup.restarts == 2 and box["failures"] == 0
    # already done: no run at all
    assert Supervisor(lambda: _FakeTrainer(box)).run(6).state.step == 6
    box = {"saved": 0, "fail_at": 1, "failures": 10}
    sup = Supervisor(lambda: _FakeTrainer(box), max_restarts=2)
    with pytest.raises(RuntimeError, match="injected"):
        sup.run(4)
    assert sup.restarts == 3 and box["saved"] == 1


def test_skip_straggler_escalates_past_its_budget():
    hits = []
    pol = SkipStraggler(deadline_s=1.0, budget=2, window=10,
                        escalate=hits.append)
    pol(1, 2.0)
    pol(5, 2.0)
    assert hits == []
    pol(8, 2.0)                 # third slow step inside the window
    assert hits == [8]
    pol(9, 2.0)                 # the count started afresh
    pol(30, 2.0)                # step 9 left the window
    pol(31, 2.0)
    assert hits == [8]
    pol(32, 2.0)
    assert hits == [8, 32]
