"""The port's audio family (the whisper-style encoder-decoder,
whisper-tiny) against the reference's: the model, its data, its
adapter, the engine's frames lane and tickets across the two packages.

Inputs are made with numpy from a seed and fed to ``repro`` and
``repro_torch`` alike.  On the CPU the port's serving prefill attends
through the flash kernel's plain version (the reference's through plain
jnp attention).  Tolerances, float32 throughout: sinusoidal positions
four float32 ulps of the largest angle (XLA's and torch's sin and exp
differ in the last bits), the model and its gradients 1e-4 (gradients
relative to each leaf's largest); synthetic batches, token streams, masks and ticket
weights are identical.  The scaled config is
``scaled_down(whisper-tiny)``: 2 encoder and 4 decoder layers, d_model
128, 4 heads of 32, 64 frames, vocab 512.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree

import repro_torch.configs as tcfgs
from repro.api.adapters import EncDecAdapter as REncDecAdapter
from repro.configs import get_arch, scaled_down
from repro.core import lottery as rlot
from repro.core import masks as rmasks
from repro.data.synthetic import SyntheticAudio as RSyntheticAudio
from repro.models import encdec as rencdec
from repro.models import layers as rlayers
from repro.serve import Request as RRequest
from repro.serve import ServeEngine as RServeEngine
from repro_torch import _bridge
from repro_torch.api import EncDecAdapter, make_adapter
from repro_torch.api.registry import get_family
from repro_torch.core import lottery as tlot
from repro_torch.core import masks as tmasks
from repro_torch.data import SyntheticAudio
from repro_torch.models import attention as tattn
from repro_torch.models import encdec as tencdec
from repro_torch.models import layers as tlayers
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.manager import load_ticket

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
SMALL = dict(dtype="float32")


def _close(got, want, **tol):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want), **(tol or TOL))


def _leaves(tree):
    """The port's leaves in the reference's (JAX's) order."""
    return [leaf for _, leaf in tmasks.tree_flatten_with_path(tree)]


def _by_path(tree, port):
    if port:
        return {tmasks.path_str(p): _bridge.to_numpy(leaf) for p, leaf in
                _pytree.tree_flatten_with_path(tree)[0]}
    return {rmasks.path_str(p): np.asarray(leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def model():
    rcfg = scaled_down(get_arch("whisper-tiny"), **SMALL)
    tcfg = tcfgs.scaled_down(tcfgs.get_arch("whisper-tiny"), **SMALL)
    rparams = rencdec.init_params(jax.random.PRNGKey(0), rcfg)
    # non-zero biases, so that every bias add is exercised
    rng = np.random.default_rng(0)
    params_np = jax.tree_util.tree_map_with_path(
        lambda p, a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
                      .astype(np.float32))
        if rmasks.path_str(p).split("/")[-1] in ("bq", "bk", "bv", "up_b",
                                                 "down_b")
        else np.asarray(a), rparams)
    return dict(rcfg=rcfg, tcfg=tcfg,
                rparams=jax.tree.map(jnp.asarray, params_np),
                params_np=params_np,
                tparams=_bridge.params_from_numpy(params_np, device="cpu"))


def _batch(cfg, S=12, B=2, seed=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, 500, size=(B, S + 1)).astype(np.int32)
    frames = (rng.standard_normal((B, cfg.encoder_seq_len, cfg.d_model))
              * 0.5).astype(np.float32)
    return {"frames": frames, "tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _rb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in b.items()}


# ---------------------------------------------------------------------------
# pieces, data and the tree
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S,d", [(7, 16), (64, 128), (1500, 384)])
def test_sinusoidal_positions_match_reference(S, d):
    """[sin, cos] concatenated (not interleaved), in float32, within four
    ulps of the largest angle (S - 1 radians)."""
    got = tlayers.sinusoidal_positions(S, d, torch.float32, "cpu")
    _close(got, rlayers.sinusoidal_positions(S, d), rtol=0,
           atol=4 * float(np.spacing(np.float32(S))))
    assert torch.equal(got[0, : d // 2], torch.zeros(d // 2))
    assert torch.equal(got[0, d // 2:], torch.ones(d - d // 2))


@pytest.mark.parametrize("step", [0, 5])
def test_synthetic_audio_batches_equal_reference(step):
    kw = dict(vocab_size=64, seq_len=12, n_frames=40, d_model=16, seed=2)
    want = RSyntheticAudio(**kw).batch(step, 3)
    got = SyntheticAudio(**kw).batch(step, 3)
    assert sorted(got) == sorted(want) == ["frames", "labels", "tokens"]
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_config_and_tree_match_reference(model):
    r, t = get_arch("whisper-tiny"), tcfgs.get_arch("whisper-tiny")
    for f in ("n_layers", "n_encoder_layers", "encoder_seq_len", "d_model",
              "n_heads", "d_ff", "vocab_size", "qkv_bias", "mlp_bias",
              "norm", "act", "tie_embeddings", "source"):
        assert getattr(r, f) == getattr(t, f), f
    own = _by_path(tencdec.init_params(torch.Generator().manual_seed(0),
                                       model["tcfg"], device="cpu"), True)
    want = _by_path(model["rparams"], False)
    assert sorted(own) == sorted(want)
    assert all(own[k].shape == want[k].shape for k in want)
    assert own["dec/xattn/wq"].shape[0] == model["tcfg"].n_layers


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def test_encode_and_forward_match_reference(model):
    s = model
    b = _batch(s["tcfg"])
    want = rencdec.encode(s["rparams"], s["rcfg"], jnp.asarray(b["frames"]))
    with torch.no_grad():
        _close(tencdec.encode(s["tparams"], s["tcfg"],
                              torch.from_numpy(b["frames"])), want)
        # the serving encoder: kernel #8's plain version on the CPU
        _close(tencdec.encode(s["tparams"], s["tcfg"],
                              torch.from_numpy(b["frames"]), flash=True),
               want)
        logits, aux = tencdec.forward(s["tparams"], s["tcfg"], _tb(b))
    rl, _ = rencdec.forward(s["rparams"], s["rcfg"], _rb(b))
    _close(logits, rl)
    assert float(aux) == 0.0


def test_loss_and_grads_match_reference(model):
    s = model
    b = _batch(s["tcfg"], S=10, seed=4)
    rl, rg = jax.jit(jax.value_and_grad(
        lambda p: rencdec.loss_fn(p, s["rcfg"], _rb(b))[0]))(s["rparams"])
    tp = _bridge.tree_map(lambda t: t.detach().requires_grad_(True),
                          s["tparams"])
    tl, metrics = tencdec.loss_fn(tp, s["tcfg"], _tb(b))
    tg = torch.autograd.grad(tl, _bridge.tree_leaves(tp))
    np.testing.assert_allclose(float(tl.detach()), float(rl), **TOL)
    assert float(metrics["aux"]) == 0.0
    got = _by_path(_bridge.tree_unflatten(tp, list(tg)), True)
    want = _by_path(rg, False)
    assert sorted(got) == sorted(want)
    for k in want:
        scale = max(1.0, float(np.abs(want[k]).max()))
        np.testing.assert_allclose(got[k] / scale, want[k] / scale,
                                   err_msg=k, **TOL)


def test_prefill_and_decode_match_reference(model):
    """prefill of 9 tokens into a cache of 16 rows, then four decode
    steps; the caches leaf for leaf (CrossKV made once, kept)."""
    s = model
    b = _batch(s["tcfg"], S=14, seed=5)
    S, cap = 9, 16
    pb = {"frames": b["frames"], "tokens": b["tokens"][:, :S]}
    rl, rc = rencdec.prefill(s["rparams"], s["rcfg"], _rb(pb), cap)
    with torch.no_grad():
        tl, tc = tencdec.prefill(s["tparams"], s["tcfg"], _tb(pb), cap)
    _close(tl, rl)
    assert isinstance(tc[0]["cross"], tencdec.CrossKV)
    assert isinstance(tc[0]["self"], tattn.KVCache)
    spec = tencdec.cache_spec(s["tcfg"], 2, cap)
    assert [tuple(t.shape) for t in _leaves(spec)] == \
        [tuple(t.shape) for t in _leaves(tc)]
    assert [tuple(t.shape) for t in jax.tree.leaves(
        rencdec.cache_spec(s["rcfg"], 2, cap))] == \
        [tuple(t.shape) for t in _leaves(spec)]
    with torch.no_grad():
        for i in range(S, S + 4):
            tok = b["tokens"][:, i:i + 1]
            rl, rc = rencdec.decode_step(s["rparams"], s["rcfg"], rc,
                                         jnp.asarray(tok))
            tl, tc = tencdec.decode_step(s["tparams"], s["tcfg"], tc,
                                         torch.from_numpy(tok).long())
            _close(tl, rl)
    for a, w in zip(_leaves(tc), jax.tree.leaves(rc)):
        _close(a, w)
    # the reference's caches cross the bridge and decode here
    tc2 = _bridge.params_from_numpy(jax.tree.map(np.asarray, rc),
                                    device="cpu")
    assert isinstance(tc2[0]["cross"], tencdec.CrossKV)
    tok = b["tokens"][:, S + 4:S + 5]
    rl, _ = rencdec.decode_step(s["rparams"], s["rcfg"], rc, jnp.asarray(tok))
    with torch.no_grad():
        tl, _ = tencdec.decode_step(s["tparams"], s["tcfg"], tc2,
                                    torch.from_numpy(tok).long())
    _close(tl, rl)


def test_cache_batch_axes_are_zero(model):
    spec = tencdec.cache_spec(model["tcfg"], 1, 8)
    axes = tencdec.cache_batch_axes(model["tcfg"], spec)
    assert set(_bridge.tree_leaves(axes)) == {0}
    assert len(_bridge.tree_leaves(axes)) == 5 * model["tcfg"].n_layers


def test_audio_prunable_matches_reference(model):
    r_pred = rmasks.family_prunable("audio")
    t_pred = get_family("audio").prunable
    paths = _by_path(model["rparams"], False)
    seen = {k for k, a in paths.items() if t_pred(k, a)}
    assert {"dec/xattn/wq", "dec/attn/wo", "enc/mlp/up", "dec/mlp/down"} \
        <= seen
    assert not {"frame_adapter", "embed/table", "dec/xattn/bq"} & seen
    for k, a in paths.items():
        assert t_pred(k, a) == r_pred(k, a) == tmasks.encdec_prunable(k, a), k


# ---------------------------------------------------------------------------
# the adapter, the frames lane and tickets
# ---------------------------------------------------------------------------
def _requests(cls, adapter, n=3):
    return [cls(uid=i, prompt=np.arange(1 + i, 5 + i, dtype=np.int32),
                max_new_tokens=4, frames=adapter.serve_frames(i))
            for i in range(n)]


def test_adapter_matches_reference(model):
    """make_adapter("whisper-tiny") is an EncDecAdapter on both sides:
    the same batches and serving frames, the same kwargs at tiny scale,
    the dense-full recipe at full scale."""
    ta = make_adapter("whisper-tiny", device="cpu")
    ra = REncDecAdapter(scaled_down(get_arch("whisper-tiny"), dtype="float32"),
                        batch_size=2, seq_len=12)
    assert isinstance(ta, EncDecAdapter) and ta.family == "audio"
    assert (ta.steps, ta.batch_size) == (4, 2) and ta.recipe is None
    for k, v in ra._batch(3).items():
        np.testing.assert_array_equal(ta._batch(3)[k].numpy(), np.asarray(v))
    np.testing.assert_array_equal(ta.serve_frames(7), ra.serve_frames(7))
    full = make_adapter("whisper-tiny", scale="full", device="cpu")
    assert full.recipe == "dense-full" and full.cfg.encoder_seq_len == 1500


def test_adapter_trains_a_ticket(model):
    """Two AdamW steps under masks: finite losses, pruned coordinates
    exactly zero, evaluate is the negative loss."""
    s = model
    adapter = EncDecAdapter(s["tcfg"], steps=2, batch_size=2, seq_len=8,
                            device="cpu")
    rng = np.random.default_rng(1)
    masks = tmasks.make_masks(s["tparams"], adapter.prunable)
    masks = _bridge.tree_map(
        lambda m: torch.as_tensor(rng.random(tuple(m.shape)) < 0.6,
                                  dtype=torch.float32), masks)
    out = adapter.train(s["tparams"], masks)
    assert np.isfinite(adapter.last_metrics["loss"])
    got, keep = _by_path(out, True), _by_path(masks, True)
    # enc: q/k/v/o, up, down; dec: those and the cross-attention's q/k/v/o
    assert len([k for k in keep if keep[k] is not None]) == 16
    for k, m in keep.items():
        if m is not None:
            assert not ((got[k] != 0) & (m == 0)).any(), k
    assert adapter.evaluate(out) < 0


def test_frames_lane_streams_match_reference(model):
    """The reference's frames-lane oracle on the same weights: its
    engine's greedy streams, and a token-by-token full forward, equal
    the port's engine's (2 slots, capacity 32, 3 requests)."""
    s = model
    ra = REncDecAdapter(s["rcfg"])
    reng = RServeEngine(params=s["rparams"], cfg=s["rcfg"],
                        prefill_fn=rencdec.prefill,
                        decode_fn=rencdec.decode_step, batch_slots=2,
                        capacity=32)
    for r in _requests(RRequest, ra):
        reng.submit(r)
    want = {r.uid: r.tokens for r in reng.run()}
    ta = EncDecAdapter(s["tcfg"], device="cpu")
    prefill_fn, decode_fn = ta.serve_fns()
    eng = ServeEngine(params=s["tparams"], cfg=s["tcfg"],
                      prefill_fn=prefill_fn, decode_fn=decode_fn,
                      batch_slots=2, capacity=32, device="cpu")
    assert not eng.paged
    for r in _requests(Request, ta):
        eng.submit(r)
    got = {r.uid: r.tokens for r in eng.run()}
    assert got == want and all(len(t) == 4 for t in got.values())
    caches = eng.generations[-1].slot_caches
    assert caches[0]["cross"].k.shape[:2] == (2, s["tcfg"].encoder_seq_len)
    assert caches[0]["self"].index.shape == (2,)
    for i in range(3):
        frames = jnp.asarray(ta.serve_frames(i)[None])
        ctx = list(np.arange(1 + i, 5 + i, dtype=np.int32))
        for _ in range(4):
            lg, _ = rencdec.forward(s["rparams"], s["rcfg"], {
                "frames": frames,
                "tokens": jnp.asarray(np.asarray(ctx, np.int32)[None])})
            ctx.append(int(jnp.argmax(lg[0, -1])))
        assert got[i] == ctx[4:]
        assert eng.smoke_decode(np.arange(1 + i, 5 + i), 4,
                                frames=ta.serve_frames(i)) == got[i]


def test_tickets_cross_packages(model, tmp_path):
    """A whisper ticket exported by either package loads in the other,
    weights and masks exactly."""
    s = model
    rng = np.random.default_rng(2)
    r_masks = rmasks.make_masks(s["rparams"], rmasks.encdec_prunable)
    r_masks = jax.tree.map(
        lambda m: jnp.asarray(rng.random(m.shape) < 0.5, jnp.float32),
        r_masks)
    t_masks = _bridge.params_from_numpy(jax.tree.map(np.asarray, r_masks),
                                        device="cpu")
    meta = {"arch": s["tcfg"].name}
    rlot.export_ticket(str(tmp_path / "r"), rlot.snapshot(s["rparams"]),
                       r_masks, meta=meta)
    tlot.export_ticket(str(tmp_path / "t"), tlot.snapshot(s["tparams"]),
                       t_masks, meta=meta)
    want_w = _by_path(rlot.rewind(s["rparams"], r_masks), False)
    want_m = _by_path(r_masks, False)
    for src in ("r", "t"):
        w, m, got_meta = load_ticket(str(tmp_path / src), s["tparams"],
                                     tmasks.encdec_prunable)
        assert got_meta["arch"] == s["tcfg"].name
        for tree, want in ((w, want_w), (m, want_m)):
            got = {k: v for k, v in _by_path(tree, True).items()
                   if v is not None}
            assert sorted(got) == sorted(k for k, v in want.items()
                                         if v is not None)
            for k in got:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        rw, rm = rlot.import_ticket(
            str(tmp_path / src), s["rparams"],
            rmasks.make_masks(s["rparams"], rmasks.encdec_prunable))
        for k, v in _by_path(rw, False).items():
            np.testing.assert_array_equal(v, _by_path(s["rparams"],
                                                      False)[k], err_msg=k)
        for k, v in _by_path(rm, False).items():
            np.testing.assert_array_equal(v, want_m[k], err_msg=k)


def test_cli_serves_whisper(capsys):
    """``serve --arch whisper-tiny`` runs the frames lane (every request
    carries ``serve_frames``), alone and on a fleet of two."""
    from repro_torch.api import cli
    for extra, event in (([], "serve"), (["--engines", "2"], "serve_fleet")):
        code = cli.main(["serve", "--arch", "whisper-tiny", "--scale",
                         "tiny", "--device", "cpu", "--requests", "2",
                         "--max-new", "3", "--json", *extra])
        out = [json.loads(line) for line in
               capsys.readouterr().out.splitlines() if line.strip()]
        assert code == 0 and out[0]["event"] == event
        assert out[0]["requests"] == 2 and out[0]["tokens"] == 6
