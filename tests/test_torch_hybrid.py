"""The port's hybrid slice (RG-LRU + sliding-window attention, the
recurrentgemma-2b family) and LayerNorm (command-r-35b) against the
reference's.

Inputs are made with numpy from a seed and fed to ``repro`` (Pallas
kernels in interpret mode, or their plain references) and
``repro_torch`` (plain PyTorch versions on the CPU) alike.  Tolerances,
float32 throughout: norms, attention and the RG-LRU pieces 1e-5 (the
same f32 arithmetic summed in other orders: JAX's associative scan
against the port's Hillis–Steele scan), the flash kernel's plain
version 2e-4 (the Pallas kernel's online softmax), models 1e-4 (many
layers of the above); token streams and masks are identical.  The
scaled configs tile at 128, so every attention and MLP projection —
the single 128-wide KV head included — is planned.
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
from repro.api import PruningSession as RSession
from repro.api.registry import make_adapter as r_make_adapter
from repro.configs import PruneConfig as RPruneConfig
from repro.configs import get_arch, scaled_down
from repro.core import masks as rmasks
from repro.core.masks import apply_masks as r_apply_masks
from repro.kernels import flash_attention as rfa
from repro.models import attention as rattn
from repro.models import layers as rlayers
from repro.models import recurrent as rrec
from repro.models import transformer as rtfm
from repro.models.plans import build_decode_plan as r_build_plan
from repro.serve import Request as RRequest
from repro.serve import ServeEngine as RServeEngine
from repro.train.plans import lm_train_plan as r_lm_train_plan
from repro_torch import _bridge
from repro_torch.api import LMAdapter, PruningSession, make_adapter
from repro_torch.api.registry import get_family
from repro_torch.configs import PruneConfig
from repro_torch.core import masks as tmasks
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import recurrent as trec
from repro_torch.models import transformer as ttfm
from repro_torch.models.plans import build_decode_plan as t_build_plan
from repro_torch.serve import Request, ServeEngine
from repro_torch.train import lm_train_plan

torch.set_num_threads(2)

PIECE = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
PROJ = ("wq", "wk", "wv", "wo", "up", "gate", "down", "w_in", "w_gate",
        "w_out")
# recurrentgemma-2b: (R, R, A) x 2 stacked and one single R (the full
# config's (R, R, A) x 8 + R + R), window 16, widths that tile at 128
HYBRID = dict(dtype="float32", n_layers=7, d_model=256, n_heads=2,
              n_kv_heads=1, head_dim=128, d_ff=256, rnn_width=256,
              local_window=16)
# command-r-35b: LayerNorm, GQA 4/2 x 64
COMMAND_R = dict(dtype="float32", n_layers=2, d_model=256, n_heads=4,
                 n_kv_heads=2, head_dim=64, d_ff=512)


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32, copy=True))


def _close(got, want, **tol):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want), **(tol or PIECE))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
def test_norms_match_reference(kind):
    rng = _rng(0)
    x = _f32(rng, 2, 5, 64, scale=3.0) + 1.5
    p = {"scale": _f32(rng, 64), "bias": _f32(rng, 64)}
    if kind == "rmsnorm":
        del p["bias"]
    rp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    _close(tlayers.apply_norm(kind, tp, _t(x)),
           rlayers.apply_norm(kind, rp, jnp.asarray(x)))
    if kind == "layernorm":
        _close(tlayers.layernorm(tp, _t(x)), rlayers.layernorm(rp, x))
        init = tlayers.norm_init(kind, 8, torch.float32, "cpu")
        assert sorted(init) == ["bias", "scale"]


# ---------------------------------------------------------------------------
# sliding-window attention and the windowed GQA block
# ---------------------------------------------------------------------------
W = 8


@pytest.mark.parametrize("S", [W - 3, W, 2 * W, 3 * W])
def test_sliding_window_attention_matches_reference(S):
    rng = _rng(S)
    q, k, v = _f32(rng, 2, S, 4, 16), _f32(rng, 2, S, 2, 16), \
        _f32(rng, 2, S, 2, 16)
    _close(tattn.sliding_window_attention(_t(q), _t(k), _t(v), window=W),
           rattn.sliding_window_attention(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), window=W))


def test_sliding_window_attention_refuses_ragged_chunks():
    q = torch.zeros(1, 2 * W + 1, 2, 8)
    with pytest.raises(ValueError, match="S % window"):
        tattn.sliding_window_attention(q, q, q, window=W)


GQA = dict(n_heads=4, n_kv_heads=2, head_dim=16, rope_theta=1e4)


def _gqa_params(seed=0, d=32):
    rng = _rng(seed)
    p = {"wq": _f32(rng, d, 64, scale=0.2), "wk": _f32(rng, d, 32, scale=0.2),
         "wv": _f32(rng, d, 32, scale=0.2), "wo": _f32(rng, 64, d, scale=0.2)}
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: _t(v) for k, v in p.items()})


def _kv(cache):
    return [np.asarray(cache.k), np.asarray(cache.v), np.asarray(cache.index)]


@pytest.mark.parametrize("S,capacity", [(5, 8), (8, 8), (16, 8), (24, 6),
                                        (5, 6)])
def test_windowed_gqa_matches_reference(S, capacity):
    """gqa_forward(window=), and at capacity <= window the ring cache of
    gqa_make_cache and three gqa_decode steps, row for row."""
    rp, tp = _gqa_params()
    rng = _rng(S)
    x = _f32(rng, 2, S + 3, 32)
    fw = slice(0, S)
    _close(tattn.gqa_forward(tp, _t(x[:, fw]), window=W, **GQA),
           rattn.gqa_forward(rp, jnp.asarray(x[:, fw]), window=W, **GQA))
    ro, rc = rattn.gqa_make_cache(rp, jnp.asarray(x[:, fw]),
                                  capacity=capacity, window=W, **GQA)
    to, tc = tattn.gqa_make_cache(tp, _t(x[:, fw]), capacity=capacity,
                                  window=W, **GQA)
    _close(to, ro)
    if S <= capacity:                # the reference's rows start at 0
        for a, b in zip(_kv(tc), _kv(rc)):
            _close(torch.as_tensor(a).float(), b.astype(np.float32))
        for i in range(3):
            xt = x[:, S + i:S + i + 1]
            ro, rc = rattn.gqa_decode(rp, rc, jnp.asarray(xt), window=W,
                                      **GQA)
            to, tc = tattn.gqa_decode(tp, tc, _t(xt), window=W, **GQA)
            _close(to, ro)


@pytest.mark.parametrize("S,capacity", [(5, 24), (16, 24), (8, 40),
                                        (16, 16)])
def test_ring_decode_matches_windowed_forward(S, capacity):
    """The port's ring at capacity > window (where the reference's own
    decode attends to the wrong keys) decodes what the reference's
    gqa_forward(window=) computes at each new position, past at least
    one wrap of the ring."""
    rp, tp = _gqa_params(1)
    steps = (-S) % W + W             # the whole sequence whole windows
    x = _f32(_rng(S + capacity), 1, S + steps, 32)
    want = np.asarray(rattn.gqa_forward(rp, jnp.asarray(x), window=W, **GQA))
    out, cache = tattn.gqa_make_cache(tp, _t(x[:, :S]), capacity=capacity,
                                      window=W, **GQA)
    assert cache.k.shape[1] == min(W, capacity)
    _close(out, want[:, :S])
    for i in range(steps):
        out, cache = tattn.gqa_decode(tp, cache, _t(x[:, S + i:S + i + 1]),
                                      window=W, **GQA)
        _close(out, want[:, S + i:S + i + 1])
    assert int(cache.index) == S + steps


@pytest.mark.parametrize("S", [8, 16])
def test_reference_windowed_decode_departs_past_the_window(S):
    """Why the port's ring departs from the reference: the reference's
    own decode agrees with its gqa_forward(window=) at capacity ==
    window and not at capacity 24 > window (it attends to keys outside
    the window; ROADMAP queue 3)."""
    rp, _ = _gqa_params(2)
    steps = 16
    x = _f32(_rng(S), 1, S + steps, 32)
    want = np.asarray(rattn.gqa_forward(rp, jnp.asarray(x), window=W, **GQA))
    err = {}
    for capacity in (W, 24):
        _, c = rattn.gqa_make_cache(rp, jnp.asarray(x[:, :S]),
                                    capacity=capacity, window=W, **GQA)
        err[capacity] = 0.0
        for i in range(steps):
            o, c = rattn.gqa_decode(rp, c, jnp.asarray(x[:, S + i:S + i + 1]),
                                    window=W, **GQA)
            err[capacity] = max(err[capacity], float(np.abs(
                np.asarray(o) - want[:, S + i:S + i + 1]).max()))
    assert err[W] < 1e-5 and err[24] > 0.1, err


# ---------------------------------------------------------------------------
# the RG-LRU block
# ---------------------------------------------------------------------------
def _rglru_params(d=32, w=32, heads=4, cw=4):
    rp = rrec.rglru_init(jax.random.PRNGKey(3), d, w, heads, cw)
    return rp, _bridge.params_from_numpy(jax.tree.map(np.asarray, rp),
                                         device="cpu")


@pytest.mark.parametrize("S", [1, 2, 64])
def test_rglru_pieces_match_reference(S):
    rp, tp = _rglru_params()
    rng = _rng(S)
    x = _f32(rng, 2, S, 32)
    jx = jnp.asarray(x)
    assert tp["lam"].dtype == torch.float32
    bf = _bridge.params_from_numpy(jax.tree.map(np.asarray, rp),
                                   device="cpu", dtype=torch.bfloat16)
    assert bf["lam"].dtype == torch.float32
    assert bf["w_in"].dtype == torch.bfloat16
    u = _f32(rng, 2, S, 32)
    _close(trec.conv1d_apply(tp["conv"], _t(u)),
           jax.jit(rrec.conv1d_apply)(rp["conv"], jnp.asarray(u)))
    _close(trec.blockdiag_apply(tp["rg"], _t(u)),
           jax.jit(rrec.blockdiag_apply)(rp["rg"], jnp.asarray(u)))
    for a, b in zip(trec._rglru_gates(tp, _t(u)),
                    jax.jit(rrec._rglru_gates)(rp, jnp.asarray(u))):
        _close(a, b)
    ty, ts = trec.rglru_make_cache(tp, _t(x))
    ry, rs = jax.jit(rrec.rglru_make_cache)(rp, jx)
    _close(trec.rglru_forward(tp, _t(x)), ry)     # the same forward
    _close(ty, ry)
    assert ts.conv.shape == rs.conv.shape == (2, 3, 32)
    r_step = jax.jit(rrec.rglru_step)
    _close(ts.h, rs.h)
    _close(ts.conv, rs.conv)
    for i in range(3):
        xt = _f32(rng, 2, 1, 32)
        ry, rs = r_step(rp, rs, jnp.asarray(xt))
        ty, ts = trec.rglru_step(tp, ts, _t(xt))
        _close(ty, ry)
        _close(ts.h, rs.h)
        _close(ts.conv, rs.conv)


def test_rglru_scan_is_differentiable_and_a_recurrence():
    """The Hillis–Steele scan equals the sequential recurrence, and its
    gradient equals the sequential one's."""
    rng = _rng(9)
    log_a = -torch.rand(2, 37, 5, dtype=torch.float64).requires_grad_(True)
    b = torch.from_numpy(rng.standard_normal((2, 37, 5))).requires_grad_(True)
    h = trec._linear_scan(log_a, b)
    seq, hs = torch.zeros(2, 5, dtype=torch.float64), []
    for t in range(37):
        seq = torch.exp(log_a[:, t]) * seq + b[:, t]
        hs.append(seq)
    want = torch.stack(hs, 1)
    torch.testing.assert_close(h, want, rtol=1e-12, atol=1e-12)
    g1 = torch.autograd.grad(h.sum(), (log_a, b))
    g2 = torch.autograd.grad(want.sum(), (log_a, b))
    for a, c in zip(g1, g2):
        torch.testing.assert_close(a, c, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# kernel #8's plain version at recurrentgemma's head width
# ---------------------------------------------------------------------------
def test_flash_plain_at_head_width_256_matches_pallas():
    rng = _rng(4)
    q, k, v = _f32(rng, 1, 128, 2, 256), _f32(rng, 1, 128, 1, 256), \
        _f32(rng, 1, 128, 1, 256)
    want = rfa.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                               causal=True, interpret=True)
    got = tfa.flash_attention(_t(q), _t(k), _t(v), causal=True)
    _close(got, want, rtol=2e-4, atol=2e-4)
    tfa.kernel_widths(256, 256)


# ---------------------------------------------------------------------------
# the scaled models
# ---------------------------------------------------------------------------
def _ticket(params_np, seed=0, density=0.5):
    """One random 128x128 tile bitmap per projection (the RG-LRU's too:
    masked, never planned) and layer, column tile 0 dead."""
    rng = _rng(seed)

    def mk(path, a):
        if str(path[-1].key) not in PROJ:
            return None
        *lead, K, N = a.shape
        bm = rng.random((*lead, K // 128, N // 128)) < density
        bm[..., 0] = False
        return np.repeat(np.repeat(bm, 128, -2), 128, -1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(mk, params_np)


def _model(arch, small):
    rcfg = scaled_down(get_arch(arch), **small)
    tcfg = tcfgs.scaled_down(tcfgs.get_arch(arch), **small)
    rparams = rtfm.init_params(jax.random.PRNGKey(0), rcfg)
    params_np = jax.tree.map(np.asarray, rparams)
    masks = _ticket(params_np)
    return dict(rcfg=rcfg, tcfg=tcfg, masks=masks,
                rparams=r_apply_masks(rparams, masks),
                tparams=_bridge.apply_masks(
                    _bridge.params_from_numpy(params_np, device="cpu"),
                    masks))


@pytest.fixture(scope="module")
def models():
    return {"hybrid": _model("recurrentgemma-2b", HYBRID),
            "command_r": _model("command-r-35b", COMMAND_R)}


def _by_path(tree, port):
    if port:
        return {tmasks.path_str(p): _bridge.to_numpy(leaf) for p, leaf in
                _pytree.tree_flatten_with_path(tree)[0]}
    return {rmasks.path_str(p): np.asarray(leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tokens(S, seed=3, B=2):
    return _rng(seed).integers(1, 512, size=(B, S)).astype(np.int32)


def test_configs_and_segments_match_reference(models):
    for arch in ("recurrentgemma-2b", "command-r-35b"):
        r, t = get_arch(arch), tcfgs.get_arch(arch)
        fields = [f.name for f in dataclasses.fields(t)
                  if f.name != "prune"]
        assert all(getattr(r, f) == getattr(t, f) for f in fields)
    for m in models.values():
        assert [(s.sigs, s.reps, s.first_layer)
                for s in ttfm.segments_of(m["tcfg"])] == \
            [(s.sigs, s.reps, s.first_layer)
             for s in rtfm.segments_of(m["rcfg"])]
    full = tcfgs.get_arch("recurrentgemma-2b")
    assert [(len(s.sigs), s.reps) for s in ttfm.segments_of(full)] == \
        [(3, 8), (1, 1), (1, 1)]
    got = _by_path(models["hybrid"]["tparams"], True)
    want = _by_path(models["hybrid"]["rparams"], False)
    assert sorted(got) == sorted(want)
    assert all(got[k].shape == want[k].shape for k in want)
    lam = [k for k in got if k.endswith("lam")]
    assert lam and all(got[k].dtype == np.float32 for k in lam)


@pytest.mark.parametrize("name", ["hybrid", "command_r"])
@pytest.mark.parametrize("with_plan", [False, True])
def test_forward_loss_and_grads_match_reference(models, name, with_plan):
    s = models[name]
    S = 32                                  # two windows of the hybrid
    toks = _tokens(S + 1)
    rbatch = {"tokens": jnp.asarray(toks[:, :-1]),
              "labels": jnp.asarray(toks[:, 1:])}
    tbatch = {"tokens": torch.from_numpy(toks[:, :-1]).long(),
              "labels": torch.from_numpy(toks[:, 1:]).long()}
    rplan = r_lm_train_plan(s["masks"], interpret=True)[0] if with_plan \
        else None
    tplan = lm_train_plan(s["masks"])[0] if with_plan else None
    if with_plan:
        entries = [e for seg in tplan for e in seg]
        assert any(e and "attn" in e for e in entries)
        assert all(e is None or "rnn" not in e for e in entries)

    def rloss(p):
        return rtfm.loss_fn(p, s["rcfg"], rbatch, plan=rplan)[0]

    rl, rg = jax.jit(jax.value_and_grad(rloss))(s["rparams"])
    tp = _bridge.tree_map(lambda t: t.detach().requires_grad_(True),
                          s["tparams"])
    tl, _ = ttfm.loss_fn(tp, s["tcfg"], tbatch, plan=tplan)
    tg = torch.autograd.grad(tl, _bridge.tree_leaves(tp))
    np.testing.assert_allclose(float(tl.detach()), float(rl), **TOL)
    got = _by_path(_bridge.tree_unflatten(tp, list(tg)), True)
    want = _by_path(rg, False)
    assert sorted(got) == sorted(want)
    for k in want:
        scale = max(1.0, float(np.abs(want[k]).max()))
        np.testing.assert_allclose(got[k] / scale, want[k] / scale,
                                   err_msg=k, **TOL)
    with torch.no_grad():
        logits, _ = ttfm.forward(s["tparams"], s["tcfg"], tbatch, plan=tplan)
    want = jax.jit(lambda p: rtfm.forward(p, s["rcfg"], rbatch,
                                          plan=rplan)[0])(s["rparams"])
    _close(logits, want, **TOL)


@pytest.mark.parametrize("name", ["hybrid", "command_r"])
@pytest.mark.parametrize("with_plan", [False, True])
def test_prefill_and_decode_match_reference(models, name, with_plan):
    """Exact-length prefill of 32 tokens (the hybrid: two windows, the
    two-chunk form) into a cache of capacity 40 (a ring of 16 rows on
    the hybrid's windowed layers, where the reference's 40-row cache
    holds the wrong keys — so its decode is held to its own forward,
    over 48 tokens: whole windows), then four decode steps."""
    s = models[name]
    rplan = r_build_plan(s["masks"], interpret=True)[0] if with_plan \
        else None
    tplan = t_build_plan(s["masks"])[0] if with_plan else None
    S, steps, cap = 32, 4, 40
    toks = _tokens(48)
    rl, _ = jax.jit(lambda p, t: rtfm.prefill(p, s["rcfg"], {"tokens": t},
                                              cap, plan=rplan))(
        s["rparams"], jnp.asarray(toks[:, :S]))
    with torch.no_grad():
        tl, tc = ttfm.prefill(s["tparams"], s["tcfg"],
                              {"tokens": torch.from_numpy(toks[:, :S])},
                              cap, plan=tplan)
    _close(tl, rl, **TOL)
    spec = ttfm.cache_spec(s["tcfg"], 2, cap)
    assert [tuple(t.shape) for t in _bridge.tree_leaves(spec)] == \
        [tuple(t.shape) for t in _bridge.tree_leaves(tc)]
    want = np.asarray(jax.jit(lambda p, t: rtfm.forward(
        p, s["rcfg"], {"tokens": t}, plan=rplan)[0])(s["rparams"],
                                                     jnp.asarray(toks)))
    with torch.no_grad():
        for i in range(steps):
            tok = torch.from_numpy(toks[:, S + i:S + i + 1])
            tl, tc = ttfm.decode_step(s["tparams"], s["tcfg"], tc, tok,
                                      plan=tplan)
            _close(tl, want[:, S + i:S + i + 1], **TOL)


@pytest.mark.parametrize("arch,small", [
    ("recurrentgemma-2b", HYBRID), ("command-r-35b", COMMAND_R),
    ("deepseek-v3-671b", dict(dtype="float32", n_layers=2))])
@pytest.mark.parametrize("capacity", [8, 40])
def test_cache_spec_matches_reference(arch, small, capacity):
    """Shapes and dtypes of every decode cache leaf: a window's ring of
    min(window, capacity) rows, RG-LRU states, KV and MLA caches."""
    want = jax.tree.leaves(rtfm.cache_spec(
        scaled_down(get_arch(arch), **small), 3, capacity))
    got = _bridge.tree_leaves(ttfm.cache_spec(
        tcfgs.scaled_down(tcfgs.get_arch(arch), **small), 3, capacity))
    assert [(tuple(t.shape), str(t.dtype).split(".")[-1]) for t in got] \
        == [(tuple(t.shape), str(t.dtype)) for t in want]


def test_hybrid_decode_after_reference_prefill(models):
    """At capacity <= window the reference's caches (ring KVCaches and
    RGLRUStates, through the numpy bridge) decode in the port to the
    reference's own decode logits."""
    s = models["hybrid"]
    S, cap = 12, 16
    toks = _tokens(S + 3, seed=5)
    _, rc = jax.jit(lambda p, t: rtfm.prefill(p, s["rcfg"], {"tokens": t},
                                              cap))(
        s["rparams"], jnp.asarray(toks[:, :S]))
    r_decode = jax.jit(lambda p, c, t: rtfm.decode_step(p, s["rcfg"], c, t))
    tc = _bridge.params_from_numpy(jax.tree.map(np.asarray, rc),
                                   device="cpu")
    assert isinstance(tc[0][0], trec.RGLRUState)
    assert isinstance(tc[0][2], tattn.KVCache)
    with torch.no_grad():
        for i in range(3):
            tok = toks[:, S + i:S + i + 1]
            rl, rc = r_decode(s["rparams"], rc, jnp.asarray(tok))
            tl, tc = ttfm.decode_step(s["tparams"], s["tcfg"], tc,
                                      torch.from_numpy(tok))
            _close(tl, rl, **TOL)


def test_hybrid_prefill_refuses_masked_rows(models):
    s = models["hybrid"]
    assert not ttfm.supports_masked_prefill(s["tcfg"])
    assert not ttfm.supports_paged_decode(s["tcfg"])
    with pytest.raises(ValueError, match="valid_len"):
        ttfm.prefill(s["tparams"], s["tcfg"],
                     {"tokens": torch.ones(1, 4, dtype=torch.long)}, 8,
                     valid_len=torch.tensor([3], dtype=torch.int32))


def test_hybrid_prunable_matches_reference(models):
    r_pred = rmasks.family_prunable("hybrid")
    t_pred = get_family("hybrid").prunable
    paths = _by_path(models["hybrid"]["rparams"], False)
    seen = {k.split("/")[-1] for k, a in paths.items() if t_pred(k, a)}
    assert {"w_in", "w_gate", "w_out", "wq", "up"} <= seen
    assert not {"lam", "scale", "table"} & seen
    for k, a in paths.items():
        assert t_pred(k, a) == r_pred(k, a) == tmasks.recurrent_prunable(
            k, a), k


# ---------------------------------------------------------------------------
# the engine and the adapter
# ---------------------------------------------------------------------------
def _requests(cls, lengths=(5, 9, 9, 5), max_new=6):
    rng = _rng(11)
    return [cls(uid=i, prompt=rng.integers(1, 500, size=n).astype(np.int32),
                max_new_tokens=max_new) for i, n in enumerate(lengths)]


@pytest.fixture(scope="module")
def engine_streams(models):
    """The reference engine's greedy streams on the hybrid ticket, run
    once: 3 dense slots at capacity 16 (= the window, where its decode
    is right)."""
    s = models["hybrid"]
    eng = RServeEngine(params=s["rparams"], cfg=s["rcfg"],
                       prefill_fn=rtfm.prefill, decode_fn=rtfm.decode_step,
                       batch_slots=3, capacity=16, masks=s["masks"])
    for r in _requests(RRequest):
        eng.submit(r)
    return {r.uid: r.tokens for r in eng.run()}


def test_hybrid_engine_streams_match_reference(models, engine_streams):
    s = models["hybrid"]
    eng = ServeEngine(params=s["tparams"], cfg=s["tcfg"], batch_slots=3,
                      capacity=16, masks=s["masks"], device="cpu")
    assert not eng.paged
    reqs = _requests(Request)
    for r in reqs:
        eng.submit(r)
    got = {r.uid: r.tokens for r in eng.run()}
    assert got == engine_streams
    caches = eng.generations[-1].slot_caches
    assert caches[0][0].h.shape == (2, 3, 256)         # (reps, slots, w)
    assert caches[0][0].h.dtype == torch.float32
    assert caches[0][2].k.shape[:3] == (2, 3, 16)
    with pytest.raises(ValueError, match="paged=True"):
        ServeEngine(params=s["tparams"], cfg=s["tcfg"], paged=True,
                    device="cpu")


def test_hybrid_engine_logits_match_teacher_forced_forward_f32(models):
    """The engine's logits rows (prefill's, then each decode step's) on
    dense slots against a teacher-forced ``forward`` over the prompt and
    the tokens fed back, in float32, past one window (the two-chunk
    prefill and the ring's wrap): within 1e-4 of each row's max |logit|,
    and the reference's ``forward`` on the same tokens too.  So the
    2.4–2.7e-2 the bf16 model shows on the card is rounding, not a
    departure of the engine's ring or recurrent state."""
    s = models["hybrid"]
    W = s["tcfg"].local_window
    eng = ServeEngine(params=s["tparams"], cfg=s["tcfg"], batch_slots=3,
                      capacity=64, masks=s["masks"], device="cpu")
    reqs = _requests(Request, lengths=(48, 9), max_new=8)
    rows = {r.uid: [] for r in reqs}
    eng.logits_sink = lambda uid, row: rows[uid].append(row.copy())
    for r in reqs:
        eng.submit(r)
    eng.run()
    for r in reqs:
        n = len(r.prompt)
        toks = np.concatenate([r.prompt, np.asarray(r.tokens[:-1])])
        toks = np.pad(toks, (0, -len(toks) % W))    # whole windows
        with torch.no_grad():
            lg, _ = ttfm.forward(s["tparams"], s["tcfg"], {
                "tokens": torch.as_tensor(toks[None].astype(np.int64))})
        want = lg[0, n - 1:n - 1 + len(r.tokens)].numpy()
        rlg, _ = rtfm.forward(s["rparams"], s["rcfg"],
                              {"tokens": jnp.asarray(toks[None])})
        rwant = np.asarray(rlg[0, n - 1:n - 1 + len(r.tokens)])
        got = np.stack(rows[r.uid])
        scale = np.abs(want).max(-1)
        assert np.all(np.abs(got - want).max(-1) <= 1e-4 * scale), r.uid
        assert np.all(np.abs(got - rwant).max(-1) <= 1e-4 * scale), r.uid


def test_hybrid_adapter_requires_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tcfgs.scaled_down(tcfgs.get_arch("recurrentgemma-2b"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_adapter("recurrentgemma-2b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttfm.init_params(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(params={}, cfg=cfg)
    assert LMAdapter(cfg, device="cpu").device.type == "cpu"


def test_hybrid_session_matches_reference():
    """make_adapter("recurrentgemma-2b", scale="tiny") through a
    PruningSession to its end, from the reference's initial weights:
    the same decisions, sparsities and masks."""
    kw = dict(steps=2)
    radapter = r_make_adapter("recurrentgemma-2b", scale="tiny", **kw)
    w0 = radapter.init_params(jax.random.PRNGKey(0))
    cfg = dict(max_iters=1, accuracy_tolerance=10.0)
    rres = RSession(radapter, RPruneConfig(**cfg)).run()
    tadapter = make_adapter("recurrentgemma-2b", scale="tiny", device="cpu",
                            **kw)
    assert tadapter.family == "hybrid" and tadapter.recipe is None
    tw0 = _bridge.params_from_numpy(jax.tree.map(np.asarray, w0),
                                    device="cpu")
    tadapter.init_params = lambda gen: tw0
    tres = PruningSession(tadapter, PruneConfig(**cfg)).run()
    assert [(e.granularity, e.accepted, e.sparsity_after)
            for e in tres.history] == \
        [(e.granularity, e.accepted, e.sparsity_after) for e in rres.history]
    got, want = _by_path(tres.masks, True), _by_path(rres.masks, False)
    got = {k: v for k, v in got.items() if v is not None}
    want = {k: v for k, v in want.items() if v is not None}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert tres.sparsity == rres.sparsity > 0
    full = make_adapter("recurrentgemma-2b", scale="full", device="cpu")
    assert full.recipe == "dense-full" and full.family == "hybrid"


def test_cli_serves_the_hybrid_family(capsys):
    """``serve --arch recurrentgemma-2b`` is no longer refused: the tiny
    config serves on dense slots."""
    from repro_torch.api import cli
    code = cli.main(["serve", "--arch", "recurrentgemma-2b", "--device",
                     "cpu", "--requests", "2", "--max-new", "2", "--json"])
    out = [json.loads(line) for line in capsys.readouterr().out.splitlines()
           if line.strip()]
    assert code == 0 and out[0]["event"] == "serve"
    assert out[0]["requests"] == 2 and out[0]["paged"] is False
