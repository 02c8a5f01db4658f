"""The last families on a mesh against the reference's single device.

The rank-local model runs every family on a ``(data, model)`` mesh:
recurrentgemma's RG-LRU channel-parallel, xLSTM's mLSTM and sLSTM over
their heads, deepseek's MLA over its heads (the latent whole on every
rank) beside its experts, whisper's encoder, decoder and cross
attention over their heads, and the MoE aux loss global over a data
axis.  Float32 at a tiny scale (``scaled_down``; widths chosen so that
heads and blocks divide over a model axis of 2):

  * **Layout.**  For every family at full size, on (1, 2), (2, 1) and a
    (1, 16) ``AbstractMesh``: each leaf the rank-local model runs
    sharded is placed as the reference's ``ShardingRules.param_spec``
    places it, and the leaves kept whole are exactly the designed ones.
  * **Serving.**  On gloo ranks on (1, 2) and (2, 1), ``ServeEngine(
    mesh=)`` gives the reference's single-device ``ServeEngine`` greedy
    streams, and every logits row it samples is within 1e-5 relative of
    the reference's row (the reference's rows read off its
    ``_sample_row``, in the order both engines sample); whisper through
    its frames lane.  A recurrentgemma whose heads and blocks do not
    divide runs its kept-whole blocks.
  * **Training.**  Two masked AdamW steps on the mesh give the
    reference's single-device losses, first gradients and parameters on
    the same global batch at ``rtol = atol = 1e-5`` (the parameters as
    ``tests/test_torch_tp_train.py`` holds them); the MoE models on a
    data axis against the reference with one dispatch group a data
    rank, its aux loss global.  Replicated leaves are bitwise equal on
    every rank.
  * **Dry-run.**  One cell of each family that now runs on the
    production mesh traces OK and records its collectives.

Each mesh is spawned once for every family (the rank bodies live in
``tests/_torch_ranks.py``, which imports no JAX); each reference run
happens once, in a module fixture.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as RAbstractMesh

import repro_torch.configs as tcfgs
from repro import optim as ropt
from repro.configs import MoEConfig as RMoEConfig
from repro.configs import get_arch, scaled_down
from repro.core import masks as rmasks
from repro.distributed.sharding import ShardingRules as RRules
from repro.models import encdec as rencdec
from repro.models import hooks as rhooks
from repro.models import transformer as rtfm
from repro.serve import Request as RRequest
from repro.serve import ServeEngine as RServeEngine
from repro_torch.core.masks import tree_flatten_with_path
from repro_torch.distributed import tensor_parallel as tpar
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import hlo_analysis as tha
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import AbstractMesh, run_ranks

sys.path.insert(0, os.path.dirname(__file__))
import _torch_ranks as ranks  # noqa: E402

torch.set_num_threads(2)

TOL = 1e-5
TRAIN_TOL = dict(rtol=1e-5, atol=1e-5)
TINY = 1e-6             # |first gradient| below which Adam's sign is rounding
LR = 1e-4
B, S = 4, 16
MESHES = ((1, 2), (2, 1))

F32 = dict(dtype="float32")
CONFIGS = {
    # (R, R, A) x 2 stacked + R: the stacked conv's rules cut the repeats
    "recurrentgemma": ("recurrentgemma-2b", dict(F32, n_layers=7)),
    "xlstm": ("xlstm-125m", F32),
    # head_dim 16: the rules' head guard lands on MLA's 24/16/16 widths
    "deepseek": ("deepseek-v3-671b", dict(
        F32, n_layers=3, head_dim=16,
        moe=dict(num_experts=4, top_k=2, d_ff_expert=64,
                 num_shared_experts=1, d_ff_shared=64, first_moe_layer=1))),
    "whisper": ("whisper-tiny", F32),
    "llama4": ("llama4-maverick-400b-a17b", F32),
    # 5 heads and 5 RG-LRU blocks: neither divides over 2
    "recurrentgemma-5": ("recurrentgemma-2b", dict(
        F32, n_layers=4, d_model=160, n_heads=5, rnn_width=160)),
}
SERVED = ("recurrentgemma", "xlstm", "deepseek", "whisper")
TRAINED = ("recurrentgemma", "xlstm", "deepseek", "whisper", "llama4")
MOE_FAMILIES = ("deepseek", "llama4")


def _cfgs(name):
    arch, kw = CONFIGS[name]
    kw = dict(kw)
    moe = kw.pop("moe", None)
    rkw = dict(kw, moe=RMoEConfig(**moe)) if moe else kw
    tkw = dict(kw, moe=tcfgs.MoEConfig(**moe)) if moe else kw
    return (scaled_down(get_arch(arch), **rkw),
            tcfgs.scaled_down(tcfgs.get_arch(arch), **tkw))


def _rmod(cfg):
    return rencdec if cfg.is_encoder_decoder else rtfm


def _requests(cfg, seed):
    """Three requests on two slots (the third refills a slot mid-decode),
    two prompt lengths."""
    rng = np.random.default_rng(seed)
    out = []
    for uid, n in enumerate((6, 11, 6)):
        frames = (rng.standard_normal((cfg.encoder_seq_len, cfg.d_model))
                  .astype(np.float32) if cfg.is_encoder_decoder else None)
        out.append((uid, rng.integers(1, cfg.vocab_size, n).astype(np.int32),
                    5, frames))
    return out


def _ref_serve(rcfg, params, reqs, groups=1):
    """The reference's single-device engine (``groups`` MoE dispatch
    groups): streams and its sampled logits rows in order."""
    mod = _rmod(rcfg)
    eng = RServeEngine(params=params, cfg=rcfg, prefill_fn=mod.prefill,
                       decode_fn=mod.decode_step, batch_slots=2, capacity=48)
    rows = []
    sample = eng._sample_row

    def record(row, gen):
        rows.append(np.array(row, np.float32, copy=True))
        return sample(row, gen)
    eng._sample_row = record
    for uid, prompt, max_new, frames in reqs:
        eng.submit(RRequest(uid=uid, prompt=prompt, max_new_tokens=max_new,
                            frames=frames))
    rhooks.set_moe_groups(groups)
    try:
        return {r.uid: list(r.tokens) for r in eng.run()}, rows
    finally:
        rhooks.set_moe_groups(1)


def _masks(params_np, seed):
    """A random elementwise mask (3/4 kept) on every weight matrix but
    the embedding."""
    rng = np.random.default_rng(seed)

    def mk(path, a):
        if a.ndim < 2 or "table" in rmasks.path_str(path):
            return None
        return (rng.random(a.shape) < 0.75).astype(np.float32)

    return jax.tree_util.tree_map_with_path(mk, params_np)


def _batches(cfg):
    rng = np.random.default_rng(3)
    out = []
    for _ in range(2):
        mask = np.ones((B, S), np.float32)
        mask[: B // 2, S // 4:] = 0         # data shard 0 counts fewer
        b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S), np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, S), np.int32),
             "loss_mask": mask}
        if cfg.is_encoder_decoder:
            b["frames"] = rng.standard_normal(
                (B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def _by_path(tree):
    return {rmasks.path_str(p): np.asarray(leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _ref_train(rcfg, params_np, masks, batches, groups):
    """The reference's single-device step (``groups`` MoE dispatch
    groups): the first batch's loss and grads, then two steps' losses
    and the parameters after them."""
    mod = _rmod(rcfg)
    params = rmasks.apply_masks(jax.tree.map(jnp.asarray, params_np), masks)
    opt = ropt.masked(ropt.adamw(ropt.constant(LR)), masks)

    def loss(p, b):
        return mod.loss_fn(p, rcfg, b)

    jb = [jax.tree.map(jnp.asarray, b) for b in batches]
    rhooks.set_moe_groups(groups)
    try:
        # make_train_step's step, its gradient kept: one compile
        grad_fn = jax.jit(jax.value_and_grad(loss, has_aux=True))
        update = jax.jit(opt.update)
        p, st, losses, g0 = params, opt.init(params), [], None
        for b in jb:
            (lv, _), g = grad_fn(p, b)
            p, st = update(g, st, p)
            losses.append(float(lv))
            g0 = g if g0 is None else g0
    finally:
        rhooks.set_moe_groups(1)
    return dict(loss0=losses[0], grads=_by_path(g0), losses=losses,
                params=_by_path(p))


@pytest.fixture(scope="module")
def setup():
    out = {}
    for i, name in enumerate(CONFIGS):
        rcfg, tcfg = _cfgs(name)
        params_np = jax.tree.map(np.asarray, _rmod(rcfg).init_params(
            jax.random.PRNGKey(i), rcfg))
        case = dict(rcfg=rcfg, tcfg=tcfg, params=params_np)
        if name in SERVED or name == "recurrentgemma-5":
            case["requests"] = _requests(tcfg, seed=10 + i)
            case["serve"] = {
                d: _ref_serve(rcfg, jax.tree.map(jnp.asarray, params_np),
                              case["requests"], d)
                for d in ((1, 2) if name in MOE_FAMILIES else (1,))}
        if name in TRAINED:
            case["masks"] = _masks(params_np, seed=20 + i)
            case["batches"] = _batches(tcfg)
            case["train"] = {
                d: _ref_train(rcfg, params_np, case["masks"],
                              case["batches"], d)
                for d in ((1, 2) if name in MOE_FAMILIES else (1,))}
        out[name] = case
    return out


@pytest.fixture(scope="module")
def runs(setup):
    got = {}
    for d, m in MESHES:
        serve = [(n, setup[n]["tcfg"], setup[n]["params"],
                  setup[n]["requests"]) for n in SERVED]
        if (d, m) == (1, 2):
            n = "recurrentgemma-5"
            serve.append((n, setup[n]["tcfg"], setup[n]["params"],
                          setup[n]["requests"]))
        train = [(n, setup[n]["tcfg"], setup[n]["params"], setup[n]["masks"],
                  setup[n]["batches"]) for n in TRAINED]
        got[(d, m)] = run_ranks(ranks.families_rank, d, m, device="cpu",
                                args=(serve, train, LR))
    return got


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
SERVE_CASES = [(d, m, n) for d, m in MESHES for n in SERVED] + [
    (1, 2, "recurrentgemma-5")]


@pytest.mark.parametrize("d,m,name", SERVE_CASES)
def test_mesh_engine_serves_the_reference_streams(d, m, name, setup, runs):
    # an MoE engine dispatches one group a data rank: the reference with
    # as many groups
    want, want_rows = setup[name]["serve"][d if name in MOE_FAMILIES
                                            else 1]
    for res in runs[(d, m)]:
        got = res["serve"][name]
        assert got["streams"] == want, (res["rank"], got["streams"])
        assert len(got["rows"]) == len(want_rows)
        for (uid, row), ref in zip(got["rows"], want_rows):
            assert _rel(row, ref) < TOL, (res["rank"], uid)
        assert not [a for a in got["audit"] if a[1] == "error"]


@pytest.mark.parametrize("name", SERVED)
def test_model_axis_runs_the_local_heads(name, setup, runs):
    """On (1, 2) every family runs sharded (J208 clean, the local heads
    where attention shards) and keeps whole only what the design keeps
    whole at the tiny scale."""
    cfg = setup[name]["tcfg"]
    got = runs[(1, 2)][0]["serve"][name]
    assert got["audit"] == []
    whole = sorted(p for p, _ in got["whole"])
    want = {
        "recurrentgemma": ["segments/0/0/rnn/conv/w",
                           "segments/0/1/rnn/conv/w",
                           "segments/0/2/attn/wk", "segments/0/2/attn/wv"],
        "xlstm": ["segments/0/1/rnn/down", "segments/0/1/rnn/up"],
        "deepseek": ["segments/0/0/attn/w_dkv", "segments/0/0/attn/w_dq",
                     "segments/1/0/attn/w_dkv", "segments/1/0/attn/w_dq",
                     "segments/1/0/moe/shared/down",
                     "segments/1/0/moe/shared/gate",
                     "segments/1/0/moe/shared/up"],
        "whisper": ["frame_adapter"]}[name]
    assert whole == want
    heads = {"recurrentgemma": (cfg.n_heads // 2, cfg.n_kv_heads),
             "xlstm": (cfg.n_heads, cfg.n_kv_heads),
             "deepseek": (cfg.n_heads // 2, cfg.n_kv_heads // 2),
             "whisper": (cfg.n_heads // 2, cfg.n_kv_heads // 2)}[name]
    assert got["heads"] == heads


def test_blocks_that_do_not_divide_stay_whole(runs):
    """5 heads and 5 RG-LRU blocks on a model axis of 2: the rules still
    cut ``w_in``/``w_gate``/``w_out`` (and the attention's rows), so the
    blocks run whole on both ranks, listed; the MLP and the vocabulary
    shard."""
    got = runs[(1, 2)][0]["serve"]["recurrentgemma-5"]
    whole = {p for p, _ in got["whole"]}
    for pos in (0, 1):
        for leaf in ("w_in", "w_gate", "w_out", "conv/w"):
            assert f"segments/0/{pos}/rnn/{leaf}" in whole
    assert {f"segments/0/2/attn/{w}" for w in ("wq", "wo")} <= whole
    assert not {p for p in whole if "/mlp/" in p or "table" in p}
    assert got["heads"] == (5, 1)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
TRAIN_CASES = [(d, m, n) for d, m in MESHES for n in TRAINED]


@pytest.mark.parametrize("d,m,name", TRAIN_CASES)
def test_mesh_training_matches_single_device_reference(d, m, name, setup,
                                                       runs):
    case = setup[name]
    want = case["train"][d if name in MOE_FAMILIES else 1]
    got = runs[(d, m)][0]["train"][name]
    np.testing.assert_allclose(got["loss0"], want["loss0"], **TRAIN_TOL)
    assert sorted(got["grads"]) == sorted(want["grads"])
    for k, g in want["grads"].items():
        np.testing.assert_allclose(got["grads"][k], g, err_msg=k,
                                   **TRAIN_TOL)
    np.testing.assert_allclose(got["losses"], want["losses"], **TRAIN_TOL)
    for k, p in want["params"].items():
        firm = np.abs(want["grads"][k]) >= TINY
        np.testing.assert_allclose(got["params"][k][firm], p[firm],
                                   err_msg=k, **TRAIN_TOL)
        assert np.all(np.abs(got["params"][k] - p) <= 2 * LR * 2), k
    assert (got["sharded"] > 0) == (m > 1)
    if name in MOE_FAMILIES:
        assert got["aux0"] > 0
    for path, mk in rmasks.flat_mask_items(case["masks"]):
        assert not np.any(got["params"][path][np.asarray(mk) == 0]), path


@pytest.mark.parametrize("d,m,name", TRAIN_CASES)
def test_sharded_loss_matches_reference_loss_fn(d, m, name, setup, runs):
    """``sharded_loss`` of the first batch on every rank: the reference's
    ``loss_fn`` of the masked weights on the global batch (an MoE's aux
    loss global over it; the encoder-decoder's token loss)."""
    want = setup[name]["train"][d if name in MOE_FAMILIES else 1]["loss0"]
    for res in runs[(d, m)]:
        np.testing.assert_allclose(res["train"][name]["sharded_loss"], want,
                                   err_msg=str(res["rank"]), **TRAIN_TOL)


@pytest.mark.parametrize("d,m,name", TRAIN_CASES)
def test_replicated_leaves_stay_bitwise_equal(d, m, name, runs):
    per_rank = [r["train"][name] for r in runs[(d, m)]]
    assert per_rank[0]["replicated"]
    for r in per_rank[1:]:
        assert r["losses"] == per_rank[0]["losses"]
        for k, v in per_rank[0]["replicated"].items():
            assert np.array_equal(r["replicated"][k], v), k


# ---------------------------------------------------------------------------
# layout at full size, against the reference's rules
# ---------------------------------------------------------------------------
FULL = ("recurrentgemma-2b", "xlstm-125m", "deepseek-v3-671b",
        "whisper-tiny", "llama4-maverick-400b-a17b")
LAYOUT_MESHES = ({"data": 1, "model": 2}, {"data": 2, "model": 1},
                 {"data": 1, "model": 16})


def _designed_whole(arch, m):
    """The leaves the design keeps whole on a model axis of ``m`` (beyond
    the MoE shared expert's, whose rules' expert rule cuts its repeats
    axis)."""
    if m == 1:
        return set()
    rg_rnn = [f"segments/{s}/{p}/rnn/{leaf}"
              for s, p in ((0, 0), (0, 1), (1, 0), (2, 0))
              for leaf in ("w_in", "w_gate", "w_out")]
    return {
        ("recurrentgemma-2b", 2): {"segments/0/0/rnn/conv/w",
                                   "segments/0/1/rnn/conv/w",
                                   "segments/0/2/attn/wk",
                                   "segments/0/2/attn/wv"},
        ("recurrentgemma-2b", 16): set(rg_rnn) | {
            "segments/1/0/rnn/conv/w", "segments/2/0/rnn/conv/w"} | {
            f"segments/0/2/attn/{w}" for w in ("wq", "wk", "wv", "wo")},
        ("xlstm-125m", 2): {"segments/0/1/rnn/up", "segments/0/1/rnn/down"},
        ("xlstm-125m", 16): {f"segments/0/0/rnn/{leaf}" for leaf in (
            "up", "gate", "down", "cell/wi", "cell/wf")} | {
            f"segments/0/1/rnn/{leaf}" for leaf in (
                "up", "down", "cell/wi", "cell/wf", "cell/wz", "cell/wo")},
        ("deepseek-v3-671b", 2): {f"segments/{s}/0/attn/{w}" for s in (0, 1)
                                  for w in ("w_dq", "w_dkv")},
        ("deepseek-v3-671b", 16): {f"segments/{s}/0/attn/{w}"
                                   for s in (0, 1)
                                   for w in ("w_dq", "w_dkv")},
        ("whisper-tiny", 2): {"frame_adapter"},
        ("whisper-tiny", 16): {"frame_adapter"} | {
            f"{stack}/{a}/{w}" for stack, a in (("enc", "attn"),
                                                ("dec", "attn"),
                                                ("dec", "xattn"))
            for w in ("wq", "wk", "wv", "wo")},
        ("llama4-maverick-400b-a17b", 2): set(),
        ("llama4-maverick-400b-a17b", 16): {
            f"segments/0/{p}/attn/{w}" for p in range(4)
            for w in ("wq", "wk", "wv", "wo")},
    }[(arch, m)]


@pytest.mark.parametrize("arch", FULL)
@pytest.mark.parametrize("axes", LAYOUT_MESHES,
                         ids=lambda a: f"{a['data']}x{a['model']}")
def test_layout_places_leaves_as_the_reference_rules(arch, axes):
    cfg = tcfgs.get_arch(arch)
    rules = tpar.mesh_rules(AbstractMesh(axes), cfg)
    rrules = RRules(RAbstractMesh(tuple(axes.values()), tuple(axes)),
                    head_dim=cfg.head_dim_)
    pspec = tsteps.params_spec(cfg)
    shardings, whole = tpar.layout(pspec, cfg, rules)
    kept = {p: s for p, s in whole}
    for path, leaf in tree_flatten_with_path(pspec):
        want = tuple(rrules.param_spec(path, tuple(leaf.shape)))
        want = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                     for e in want)
        got = tpar._lookup(shardings, path).spec
        if path in kept:
            assert kept[path] == want and "model" in want, path
            assert got == tuple(None if e == "model" else e for e in want)
        else:
            assert got == want, path
    shared = {p for p in kept if "/moe/shared/" in p}
    assert set(kept) - shared == _designed_whole(arch, axes["model"])
    if axes["model"] == 1:
        assert tpar.local_config(cfg, 1, shardings) == cfg


# ---------------------------------------------------------------------------
# the dry-run's cells of the families that now run on the production mesh
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,shape,kernels", [
    ("deepseek-v3-671b", "prefill_32k", {"flash_attention": {"wgmma": 61}}),
    ("recurrentgemma-2b", "prefill_32k", {}),
    ("whisper-tiny", "prefill_32k", {"flash_attention": {"wgmma": 8}}),
    ("xlstm-125m", "decode_32k", {})])
def test_dryrun_cell_of_a_new_family_is_ok(arch, shape, kernels):
    rec = tdry.run_cell(arch, shape)
    assert rec["status"] == "OK", rec.get("error")
    assert rec["mesh"] == "16x16" and rec["kernels"] == kernels
    count = rec["collectives"]["count_by_kind"]
    assert count["all-reduce"] > 0 and count["all-gather"] > 0


@pytest.mark.parametrize("name", ["recurrentgemma", "xlstm"])
def test_dryrun_decode_caches_take_the_local_widths(name, setup):
    """A decode cell on (1, 2): rank 0's recurrent states at its local
    channels and heads (``cache_specs`` reads the local parameters), the
    step traced with the row-parallel outputs' all-reduces."""
    cfg = setup[name]["tcfg"]
    shape = tcfgs.ShapeSpec("decode_tiny", 32, 2, "decode")
    cell = tdry.local_cell(cfg, shape, {"data": 1, "model": 2})
    kind = {"recurrentgemma": tcfgs.RGLRU, "xlstm": tcfgs.MLSTM}[name]
    p = cell.args[0]["segments"][0][list(cfg.block_pattern).index(kind)]
    state = cell.args[1][0][list(cfg.block_pattern).index(kind)]
    if name == "recurrentgemma":
        assert state.h.shape[-1] == p["rnn"]["w_in"].shape[-1] \
            == cfg.rnn_width // 2
    else:
        assert state.C.shape[-3] == cfg.n_heads // 2
    tr, _ = tdry.trace_cell(cfg, shape, {"data": 1, "model": 2})
    count = tha.collective_bytes(tr).count_by_kind
    assert count["all-reduce"] > 0
