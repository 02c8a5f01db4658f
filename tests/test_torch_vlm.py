"""The port's vlm family (phi-3-vision: the patch prefix), llama4-maverick
(top-1 MoE every other layer, one shared expert, windows on three
layers in four), the registry and family predicates for every name,
paged decode (#6) at phi-3's head width 96, and the CLI's arch list —
against the reference.

Inputs are made with numpy from a seed and fed to ``repro`` (Pallas
kernels in interpret mode) and ``repro_torch`` (the kernels' plain
versions on the CPU).  Tolerances, float32 throughout: #6's plain
version 1e-5, models and their gradients 1e-4 (gradients relative to
each leaf's largest), a planned loss against the dense one on the same
masked weights 1e-5 (the reference's own bound); patch batches, token
streams, masks and registry entries are identical.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree

import repro_torch.configs as tcfgs
from repro.api.registry import get_family as r_get_family
from repro.api.registry import list_adaptable as r_list_adaptable
from repro.api.registry import make_adapter as r_make_adapter
from repro.configs import get_arch, list_archs, list_cnns, scaled_down
from repro.core import masks as rmasks
from repro.core.algorithm import prune_step as r_prune_step
from repro.kernels import paged_attention as rpa
from repro.models import transformer as rtfm
from repro.serve import Request as RRequest
from repro.serve import ServeEngine as RServeEngine
from repro.train.plans import lm_train_plan as r_lm_train_plan
from repro_torch import _bridge
from repro_torch.api import make_adapter
from repro_torch.api.registry import get_family, list_adaptable
from repro_torch.core import masks as tmasks
from repro_torch.kernels import bsmm as tbsmm
from repro_torch.kernels import paged_attention as tpa
from repro_torch.models import transformer as ttfm
from repro_torch.serve import Request, ServeEngine
from repro_torch.train import lm_train_plan

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
PROJ = ("wq", "wk", "wv", "wo", "up", "gate", "down")


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, want, **tol):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want), **(tol or TOL))


def _by_path(tree, port):
    if port:
        return {tmasks.path_str(p): _bridge.to_numpy(leaf) for p, leaf in
                _pytree.tree_flatten_with_path(tree)[0]}
    return {rmasks.path_str(p): np.asarray(leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _ticket(params_np, seed=0, density=0.6):
    """One random 128x128 tile bitmap per dense attention/MLP projection
    and layer, its first tile live and its last dead."""
    rng = _rng(seed)

    def mk(path, a):
        if str(path[-1].key) not in PROJ or "moe" in rmasks.path_str(path):
            return None
        *lead, K, N = a.shape
        bm = rng.random((*lead, K // 128, N // 128)) < density
        bm[..., 0, 0] = True
        bm[..., -1, -1] = False
        return np.repeat(np.repeat(bm, 128, -2), 128, -1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(mk, params_np)


# widths that tile at 128: every dense projection is planned
WIDE = dict(d_model=256, head_dim=64)


def _model(arch, masked=True, **small):
    rcfg = scaled_down(get_arch(arch), dtype="float32", **small)
    tcfg = tcfgs.scaled_down(tcfgs.get_arch(arch), dtype="float32", **small)
    rparams = rtfm.init_params(jax.random.PRNGKey(0), rcfg)
    params_np = jax.tree.map(np.asarray, rparams)
    masks = _ticket(params_np) if masked else None
    if masks is not None:
        params_np = jax.tree.map(lambda p, m: p if m is None else p * m,
                                 params_np, masks,
                                 is_leaf=lambda x: x is None)
    return dict(rcfg=rcfg, tcfg=tcfg, masks=masks,
                rparams=jax.tree.map(jnp.asarray, params_np),
                tparams=_bridge.params_from_numpy(params_np, device="cpu"))


@pytest.fixture(scope="module")
def vlm():
    return _model("phi-3-vision-4.2b", **WIDE)


def _vlm_batch(cfg, S=12, seed=3):
    rng = _rng(seed)
    toks = rng.integers(1, 500, size=(2, S + 1)).astype(np.int32)
    patches = rng.standard_normal(
        (2, cfg.num_patch_tokens, cfg.d_model)).astype(np.float32)
    return ({"tokens": jnp.asarray(toks[:, :-1]),
             "labels": jnp.asarray(toks[:, 1:]),
             "patches": jnp.asarray(patches)},
            {"tokens": torch.from_numpy(toks[:, :-1]).long(),
             "labels": torch.from_numpy(toks[:, 1:]).long(),
             "patches": torch.from_numpy(patches)})


# ---------------------------------------------------------------------------
# vlm: phi-3-vision's patch prefix
# ---------------------------------------------------------------------------
def test_vlm_tree_matches_reference(vlm):
    own = _by_path(ttfm.init_params(torch.Generator().manual_seed(0),
                                    vlm["tcfg"], device="cpu"), True)
    want = _by_path(vlm["rparams"], False)
    assert sorted(own) == sorted(want)
    assert all(own[k].shape == want[k].shape for k in want)
    assert own["patch_proj"].shape == (256, 256)
    assert ttfm.supports_paged_decode(vlm["tcfg"])
    assert not ttfm.supports_masked_prefill(vlm["tcfg"])


@pytest.mark.parametrize("with_plan", [False, True])
def test_vlm_forward_loss_and_grads_match_reference(vlm, with_plan):
    """16 patch embeddings through ``patch_proj`` ahead of 12 tokens:
    logits over all 28 positions, the loss over the text tail, and the
    gradients (``patch_proj``'s among them), dense and planned."""
    s = vlm
    rbatch, tbatch = _vlm_batch(s["tcfg"])
    rplan = r_lm_train_plan(s["masks"], interpret=True)[0] if with_plan \
        else None
    tplan = lm_train_plan(s["masks"])[0] if with_plan else None
    rl, rg = jax.jit(jax.value_and_grad(
        lambda p: rtfm.loss_fn(p, s["rcfg"], rbatch, plan=rplan)[0]))(
        s["rparams"])
    tp = _bridge.tree_map(lambda t: t.detach().requires_grad_(True),
                          s["tparams"])
    tl, _ = ttfm.loss_fn(tp, s["tcfg"], tbatch, plan=tplan)
    tg = torch.autograd.grad(tl, _bridge.tree_leaves(tp))
    np.testing.assert_allclose(float(tl.detach()), float(rl), **TOL)
    got = _by_path(_bridge.tree_unflatten(tp, list(tg)), True)
    want = _by_path(rg, False)
    assert sorted(got) == sorted(want)
    assert np.abs(want["patch_proj"]).max() > 0
    for k in want:
        scale = max(1.0, float(np.abs(want[k]).max()))
        np.testing.assert_allclose(got[k] / scale, want[k] / scale,
                                   err_msg=k, **TOL)
    with torch.no_grad():
        logits, _ = ttfm.forward(s["tparams"], s["tcfg"], tbatch, plan=tplan)
    assert logits.shape[1] == 16 + 12
    _close(logits, rtfm.forward(s["rparams"], s["rcfg"], rbatch,
                                plan=rplan)[0])
    # without patches the same model is a text-only LM
    with torch.no_grad():
        text, _ = ttfm.forward(s["tparams"], s["tcfg"],
                               {"tokens": tbatch["tokens"]})
    _close(text, rtfm.forward(s["rparams"], s["rcfg"],
                              {"tokens": rbatch["tokens"]})[0])


def test_vlm_adapter_patch_batches_equal_reference():
    ta = make_adapter("phi-3-vision-4.2b", device="cpu")
    ra = r_make_adapter("phi-3-vision-4.2b")
    assert ta.family == ra.family == "vlm"
    for step in (0, 7):
        got, want = ta._batch(step), ra._batch(step)
        assert sorted(got) == sorted(want) == ["labels", "patches", "tokens"]
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert ta._batch(0)["patches"].shape == (2, 16, 128)
    assert "patches" not in make_adapter("llama3.2-3b", device="cpu")._batch(0)


def test_vlm_engine_serves_text_prompts_like_reference(vlm):
    """Text-only prompts on the paged engine (exact-length prefill, #6's
    plain version), greedy streams equal the reference engine's."""
    s = vlm

    def reqs(cls):
        rng = _rng(7)
        return [cls(uid=i, prompt=rng.integers(1, 500, size=n).astype(
            np.int32), max_new_tokens=3) for i, n in enumerate((5, 9, 4))]

    reng = RServeEngine(params=s["rparams"], cfg=s["rcfg"],
                        prefill_fn=rtfm.prefill, decode_fn=rtfm.decode_step,
                        batch_slots=2, capacity=32)
    for r in reqs(RRequest):
        reng.submit(r)
    want = {r.uid: r.tokens for r in reng.run()}
    eng = ServeEngine(params=s["tparams"], cfg=s["tcfg"], batch_slots=2,
                      capacity=32, device="cpu")
    assert eng.paged
    for r in reqs(Request):
        eng.submit(r)
    assert {r.uid: r.tokens for r in eng.run()} == want


# ---------------------------------------------------------------------------
# llama4-maverick
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def llama4():
    return _model("llama4-maverick-400b-a17b", **WIDE)


def test_llama4_config_and_segments_match_reference(llama4):
    r, t = (get_arch("llama4-maverick-400b-a17b"),
            tcfgs.get_arch("llama4-maverick-400b-a17b"))
    assert dataclasses.asdict(r) == dataclasses.asdict(t)
    s = llama4
    sigs = [ttfm.layer_signature(s["tcfg"], i) for i in range(4)]
    assert sigs == [(tcfgs.LOCAL_ATTN, False), (tcfgs.LOCAL_ATTN, True),
                    (tcfgs.LOCAL_ATTN, False), (tcfgs.ATTN, True)]
    assert [(x.sigs, x.reps) for x in ttfm.segments_of(s["tcfg"])] == \
        [(x.sigs, x.reps) for x in rtfm.segments_of(s["rcfg"])]
    assert sorted(_by_path(s["tparams"], True)) == \
        sorted(_by_path(s["rparams"], False))


def test_llama4_forward_prefill_and_decode_match_reference(llama4):
    """The training forward over 24 tokens, then an exact-length prefill
    of 20 and four dense-slot decode steps, each against the
    reference's (planned: the ticket's attention and MLP tiles)."""
    s = llama4
    toks = _rng(5).integers(1, 500, size=(2, 24)).astype(np.int32)
    rplan = r_lm_train_plan(s["masks"], interpret=True)[0]
    tplan = lm_train_plan(s["masks"])[0]
    with torch.no_grad():
        tl, aux = ttfm.forward(s["tparams"], s["tcfg"],
                               {"tokens": torch.from_numpy(toks).long()},
                               plan=tplan)
    rl, raux = rtfm.forward(s["rparams"], s["rcfg"],
                            {"tokens": jnp.asarray(toks)}, plan=rplan)
    _close(tl, rl)
    _close(aux, raux)
    assert float(aux) > 0
    S, cap = 20, 32
    rl, rc = rtfm.prefill(s["rparams"], s["rcfg"],
                          {"tokens": jnp.asarray(toks[:, :S])}, cap,
                          plan=rplan)
    with torch.no_grad():
        tl, tc = ttfm.prefill(s["tparams"], s["tcfg"],
                              {"tokens": torch.from_numpy(toks[:, :S])}, cap,
                              plan=tplan)
        _close(tl, rl)
        for i in range(S, S + 4):
            tok = toks[:, i:i + 1]
            rl, rc = rtfm.decode_step(s["rparams"], s["rcfg"], rc,
                                      jnp.asarray(tok), plan=rplan)
            tl, tc = ttfm.decode_step(s["tparams"], s["tcfg"], tc,
                                      torch.from_numpy(tok), plan=tplan)
            _close(tl, rl)


def test_llama4_moe_plan_matches_dense_forward():
    """The reference's ``test_moe_plan_matches_dense_forward`` on the
    port: expert and shared widths of 128 so the experts tile, a ticket
    pruned by the reference (whole experts, then crossbar tiles), the
    planned loss equal to the dense one and to the reference's."""
    base = get_arch("llama4-maverick-400b-a17b")
    rcfg = scaled_down(base, dtype="float32")
    rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
        rcfg.moe, d_ff_expert=128, d_ff_shared=128))
    tcfg = tcfgs.scaled_down(tcfgs.get_arch(base.name), dtype="float32")
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, d_ff_expert=128, d_ff_shared=128))
    params = rtfm.init_params(jax.random.PRNGKey(0), rcfg)
    masks = rmasks.make_masks(params, rmasks.moe_prunable)
    masks = r_prune_step(params, masks, "expert", 0.3, lambda p: False)
    masks = r_prune_step(params, masks, "xbar", 0.2, lambda p: False)
    pruned = rmasks.apply_masks(params, masks)
    masks_np = jax.tree.map(np.asarray, masks)
    tparams = _bridge.params_from_numpy(jax.tree.map(np.asarray, pruned),
                                        device="cpu")
    plan, stats = lm_train_plan(masks_np)
    assert any(".moe" in label for label, *_ in stats.by_layer)
    assert stats.live_tiles < stats.total_tiles
    rplan = r_lm_train_plan(masks_np, interpret=True)[0]
    toks = np.ones((2, 16), np.int32)
    tb = {"tokens": torch.from_numpy(toks).long(),
          "labels": torch.from_numpy(toks).long()}
    rb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    with torch.no_grad():
        l_dense, _ = ttfm.loss_fn(tparams, tcfg, tb)
        l_plan, _ = ttfm.loss_fn(tparams, tcfg, tb, plan=plan)
    np.testing.assert_allclose(float(l_plan), float(l_dense), rtol=1e-5)
    np.testing.assert_allclose(
        float(l_plan), float(rtfm.loss_fn(pruned, rcfg, rb, plan=rplan)[0]),
        **TOL)


# ---------------------------------------------------------------------------
# the registry, every family's predicate and the CLI's list
# ---------------------------------------------------------------------------
def test_registry_names_and_configs_match_reference():
    assert list(tcfgs.list_archs()) == list(list_archs())
    assert list(tcfgs.list_cnns()) == list(list_cnns())
    assert list_adaptable() == r_list_adaptable()
    for name in list_archs():
        assert dataclasses.asdict(tcfgs.get_arch(name)) == \
            dataclasses.asdict(get_arch(name)), name


@pytest.mark.parametrize("name", r_list_adaptable())
def test_make_adapter_kind_matches_reference(name):
    ta = make_adapter(name, scale="tiny", device="cpu")
    ra = r_make_adapter(name, scale="tiny")
    assert type(ta).__name__ == type(ra).__name__
    assert ta.family == ra.family
    assert ta.granularities == ra.granularities
    t_spec, r_spec = get_family(ta.family), r_get_family(ra.family)
    assert (t_spec.serves, t_spec.recipe, t_spec.excluded_granularities,
            dict(t_spec.smoke_kwargs)) == \
        (r_spec.serves, r_spec.recipe, r_spec.excluded_granularities,
         dict(r_spec.smoke_kwargs))


PATHS = ("dec/xattn/wq", "dec/xattn/bq", "frame_adapter", "patch_proj",
         "segments/0/0/rnn/cell/wq/w", "segments/0/0/rnn/cell/bf",
         "segments/0/0/rnn/up", "segments/0/1/rnn/cell/ri/w",
         "segments/1/0/moe/router", "segments/1/0/moe/up",
         "segments/0/0/attn/wq", "segments/0/0/norm1/scale", "embed/table",
         "enc/mlp/up_b", "convs/0/w", "fc/0/b")


@pytest.mark.parametrize("family", ["dense", "moe", "hybrid", "ssm", "vlm",
                                    "audio", "cnn"])
def test_family_prunable_matches_reference_everywhere(family):
    for p in PATHS:
        for leaf in (np.zeros((4, 4)), np.zeros((4,)), np.zeros((2, 4, 4))):
            assert tmasks.family_prunable(family)(p, leaf) == \
                rmasks.family_prunable(family)(p, leaf), (family, p,
                                                          leaf.shape)
    assert get_family(family).prunable is tmasks.family_prunable(family)


def test_cli_lists_every_family_serving(capsys):
    from repro_torch.api import cli
    assert cli.main(["archs", "--json"]) == 0
    rows = {r["arch"]: r for r in map(json.loads,
                                      capsys.readouterr().out.splitlines())}
    assert sorted(rows) == sorted(r_list_adaptable())
    for name, family, adapter in (
            ("xlstm-125m", "ssm", "LMAdapter"),
            ("whisper-tiny", "audio", "EncDecAdapter"),
            ("phi-3-vision-4.2b", "vlm", "LMAdapter"),
            ("llama4-maverick-400b-a17b", "moe", "LMAdapter")):
        assert rows[name]["family"] == family
        assert rows[name]["adapter"] == adapter and rows[name]["serves"]
    assert not rows["vgg11"]["serves"]


# ---------------------------------------------------------------------------
# #6 at phi-3's head width
# ---------------------------------------------------------------------------
def _geo(Hq, Hkv, hd, dv):
    return tpa.PagedGeometry(B=8, Hq=Hq, hd=hd, Hkv=Hkv, T=128, NB=4, P=33,
                             dv=dv)


@pytest.mark.parametrize("elem", [2, 4])
def test_paged_kernel_geometry_takes_head_width_96(elem):
    """dv / 2 = 48 lanes do not divide the block's 256 threads: the
    widened contract takes it (5 token groups, 16 threads idle in the
    p @ v pass) and still refuses an odd or too wide dv."""
    for Hq, Hkv, hd, dv in ((32, 32, 96, 96), (24, 8, 128, 128),
                            (32, 32, 80, 80), (6, 6, 64, 64)):
        tpa._check_kernel_geometry(_geo(Hq, Hkv, hd, dv), elem)
    for hd, dv in ((96, 95), (96, 97)):
        with pytest.raises(tbsmm.GeometryError):
            tpa._check_kernel_geometry(_geo(32, 32, hd, dv), elem)
    with pytest.raises(tbsmm.GeometryError):
        tpa._check_kernel_geometry(_geo(32, 32, 96, 1024), elem)


def test_paged_plain_at_head_width_96_matches_reference():
    """phi-3's decode geometry (Hq = Hkv = 32, hd = dv = 96), ragged
    lengths over 128-token blocks, f32: the port's paged attention (its
    plain version on the CPU) against the reference's
    ``paged_attention_ref``."""
    rng = _rng(9)
    lens = np.array([1, 127, 128, 129, 300, 40], np.int32)
    B, P, NB, Hq, hd = len(lens), 16, 3, 32, 96
    q = rng.standard_normal((B, Hq, hd)).astype(np.float32)
    kp = rng.standard_normal((P, 128, Hq, hd)).astype(np.float32)
    vp = rng.standard_normal((P, 128, Hq, hd)).astype(np.float32)
    tables = rng.integers(1, P, size=(B, NB)).astype(np.int32)
    scale = hd ** -0.5
    want = rpa.paged_attention_ref(jnp.asarray(q), jnp.asarray(kp),
                                   jnp.asarray(vp), jnp.asarray(tables),
                                   jnp.asarray(lens), scale=scale)
    got = tpa.paged_attention(torch.from_numpy(q), torch.from_numpy(kp),
                              torch.from_numpy(vp), torch.from_numpy(tables),
                              torch.from_numpy(lens), scale=scale)
    assert got.shape == (B, Hq, 96)
    _close(got, want, rtol=1e-5, atol=1e-5)
