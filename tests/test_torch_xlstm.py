"""The port's ssm family (xLSTM: alternating mLSTM and sLSTM blocks,
xlstm-125m) against the reference's.

Inputs are made with numpy from a seed and fed to ``repro`` and
``repro_torch`` alike (the cells have no Pallas kernel).  Tolerances,
float32 throughout: the cells 1e-5 (the same f32 arithmetic, summed in
other orders), the port's chunkwise mLSTM against its own sequential
form 2e-4 (the reference's own bound for that identity), models and
their gradients 1e-4 (four layers of the above, gradients relative to
each leaf's largest); token streams are identical.  The scaled config is
``scaled_down(xlstm-125m)``: 4 layers (mLSTM, sLSTM) x 2 stacked, d_model
128, 4 heads, rnn_width 128.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree

import repro_torch.configs as tcfgs
from repro.configs import get_arch, scaled_down
from repro.core import masks as rmasks
from repro.models import recurrent as rrec
from repro.models import transformer as rtfm
from repro.serve import Request as RRequest
from repro.serve import ServeEngine as RServeEngine
from repro_torch import _bridge
from repro_torch.api.registry import get_family
from repro_torch.core import masks as tmasks
from repro_torch.models import recurrent as trec
from repro_torch.models import transformer as ttfm
from repro_torch.serve import Request, ServeEngine

torch.set_num_threads(2)

PIECE = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
B, W, H, D = 2, 32, 4, 16          # batch, cell width, heads, sLSTM input


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32, copy=True))


def _close(got, want, **tol):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want), **(tol or PIECE))


def _cell(init, *args):
    """A reference cell's parameters (numpy) and the port's copy."""
    p = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), *args))
    return (jax.tree.map(jnp.asarray, p),
            _bridge.params_from_numpy(p, device="cpu"))


def _mlstm_state(rng):
    """A carried (C, n, m) state as numpy: what a previous call left."""
    hd = W // H
    return (_f32(rng, B, H, hd, hd, scale=0.3), _f32(rng, B, H, hd, scale=0.3),
            _f32(rng, B, H))


def _close_state(got, want, **tol):
    for g, w in zip(got, want):
        _close(g, w, **tol)


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("carried", [False, True])
def test_mlstm_sequential_and_chunkwise_match_reference(carried):
    """mlstm_sequential over 13 tokens and mlstm_chunkwise over two
    chunks of 8, from the empty state or a carried one."""
    rp, tp = _cell(rrec.mlstm_cell_init, W, H)
    rng = _rng(1)
    u = _f32(rng, B, 16, W, scale=0.5)
    st = _mlstm_state(rng) if carried else None
    rst = rrec.MLSTMState(*map(jnp.asarray, st)) if carried else None
    tst = trec.MLSTMState(*map(_t, st)) if carried else None
    for fn, S, kw in (("mlstm_sequential", 13, {}),
                      ("mlstm_chunkwise", 16, {"chunk": 8})):
        rh, rs = getattr(rrec, fn)(rp, jnp.asarray(u[:, :S]), H, state=rst,
                                   **kw)
        th, ts = getattr(trec, fn)(tp, _t(u[:, :S]), H, state=tst, **kw)
        _close(th, rh)
        _close_state(ts, rs)


@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_mlstm_chunkwise_equals_its_sequential_form(chunk):
    """The port's own identity, as ``tests/test_recurrent.py`` holds the
    reference's: chunkwise == sequential, output and state; and a length
    that is not whole chunks runs the sequential form."""
    _, tp = _cell(rrec.mlstm_cell_init, W, H)
    u = _t(_f32(_rng(2), B, 64, W, scale=0.5))
    h_seq, st_seq = trec.mlstm_sequential(tp, u, H)
    h_chk, st_chk = trec.mlstm_chunkwise(tp, u, H, chunk=chunk)
    _close(h_chk, h_seq.numpy(), rtol=2e-4, atol=2e-4)
    _close_state(st_chk, [t.numpy() for t in st_seq], rtol=2e-4, atol=2e-4)
    h_odd, _ = trec.mlstm_chunkwise(tp, u[:, :chunk + 1], H, chunk=chunk)
    _close(h_odd, h_seq[:, :chunk + 1].numpy(), rtol=2e-4, atol=2e-4)


def test_mlstm_chunkwise_is_differentiable():
    """Gradients through the chunkwise form (cummax, the masked decay
    matrix) are finite and equal the sequential form's."""
    _, tp = _cell(rrec.mlstm_cell_init, W, H)
    u = _t(_f32(_rng(3), B, 16, W, scale=0.5))
    grads = []
    for fn in (lambda x: trec.mlstm_chunkwise(tp, x, H, chunk=8),
               lambda x: trec.mlstm_sequential(tp, x, H)):
        x = u.clone().requires_grad_(True)
        h, st = fn(x)
        (h.square().sum() + st.C.sum()).backward()
        grads.append(x.grad)
    assert bool(torch.isfinite(grads[0]).all())
    _close(grads[0], grads[1].numpy(), rtol=2e-4, atol=2e-4)


def test_mlstm_step_matches_reference_in_place():
    rp, tp = _cell(rrec.mlstm_cell_init, W, H)
    rng = _rng(4)
    st = _mlstm_state(rng)
    rst = rrec.MLSTMState(*map(jnp.asarray, st))
    tst = trec.MLSTMState(*map(_t, st))
    before = [t.data_ptr() for t in tst]
    for i in range(3):
        u = _f32(rng, B, 1, W, scale=0.5)
        rh, rst = rrec.mlstm_step(rp, rst, jnp.asarray(u), H)
        th, out = trec.mlstm_step(tp, tst, _t(u), H)
        assert out is tst and [t.data_ptr() for t in out] == before
        _close(th, rh)
        _close_state(tst, rst)


def test_slstm_forward_and_step_match_reference():
    """slstm_forward over 12 tokens from the empty state, then three
    slstm_step tokens on the state it left (written in place)."""
    rp, tp = _cell(rrec.slstm_cell_init, D, W, H)
    assert all(tp[f"b{g}"].dtype == torch.float32 for g in "ifzo")
    rng = _rng(5)
    x = _f32(rng, B, 15, D, scale=0.8)
    rh, rst = rrec.slstm_forward(rp, jnp.asarray(x[:, :12]))
    th, tst = trec.slstm_forward(tp, _t(x[:, :12]))
    _close(th, rh)
    _close_state(tst, rst)
    for i in range(12, 15):
        rh, rst = rrec.slstm_step(rp, rst, jnp.asarray(x[:, i:i + 1]))
        th, out = trec.slstm_step(tp, tst, _t(x[:, i:i + 1]))
        assert out is tst
        _close(th, rh)
        _close_state(tst, rst)
    fresh = trec.slstm_init_state(B, W, "cpu")
    assert len({t.data_ptr() for t in fresh}) == 4
    assert float(fresh.m.max()) == float(np.float32(-1e30))


def test_state_specs_match_reference():
    for r, t in ((rrec.mlstm_state_spec(3, H, 8), trec.mlstm_state_spec(
            3, H, 8)), (rrec.slstm_state_spec(3, W), trec.slstm_state_spec(
            3, W))):
        assert [(tuple(a.shape), str(a.dtype).split(".")[-1]) for a in t] \
            == [(tuple(a.shape), str(a.dtype)) for a in r]


# ---------------------------------------------------------------------------
# the scaled xlstm-125m model
# ---------------------------------------------------------------------------
SMALL = dict(dtype="float32")


@pytest.fixture(scope="module")
def model():
    rcfg = scaled_down(get_arch("xlstm-125m"), **SMALL)
    tcfg = tcfgs.scaled_down(tcfgs.get_arch("xlstm-125m"), **SMALL)
    rparams = rtfm.init_params(jax.random.PRNGKey(0), rcfg)
    params_np = jax.tree.map(np.asarray, rparams)
    return dict(rcfg=rcfg, tcfg=tcfg, rparams=rparams,
                tparams=_bridge.params_from_numpy(params_np, device="cpu"))


def _by_path(tree, port):
    if port:
        return {tmasks.path_str(p): _bridge.to_numpy(leaf) for p, leaf in
                _pytree.tree_flatten_with_path(tree)[0]}
    return {rmasks.path_str(p): np.asarray(leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tokens(S, seed=3, batch=2):
    return _rng(seed).integers(1, 512, size=(batch, S)).astype(np.int32)


def test_config_segments_and_tree_match_reference(model):
    r, t = get_arch("xlstm-125m"), tcfgs.get_arch("xlstm-125m")
    assert r == t or all(getattr(r, f) == getattr(t, f)
                         for f in ("name", "family", "n_layers", "d_model",
                                   "n_heads", "rnn_width", "vocab_size",
                                   "block_pattern", "norm", "source"))
    assert [(s.sigs, s.reps) for s in ttfm.segments_of(model["tcfg"])] == \
        [(s.sigs, s.reps) for s in rtfm.segments_of(model["rcfg"])] == \
        [(((tcfgs.MLSTM, False), (tcfgs.SLSTM, False)), 2)]
    gen = torch.Generator().manual_seed(0)
    own = _by_path(ttfm.init_params(gen, model["tcfg"], device="cpu"), True)
    want = _by_path(model["rparams"], False)
    assert sorted(own) == sorted(want)
    assert all(own[k].shape == want[k].shape and own[k].dtype == want[k].dtype
               for k in want)
    assert "segments/0/0/rnn/cell/wq/w" in own
    assert "segments/0/1/rnn/cell/rf/w" in own


@pytest.mark.parametrize("S", [20, 128])
def test_forward_loss_and_grads_match_reference(model, S):
    """S = 20 runs the sequential mLSTM, S = 128 one whole chunk (the
    chunkwise form), both under autograd with remat on."""
    s = model
    toks = _tokens(S + 1)
    rbatch = {"tokens": jnp.asarray(toks[:, :-1]),
              "labels": jnp.asarray(toks[:, 1:])}
    tbatch = {"tokens": torch.from_numpy(toks[:, :-1]).long(),
              "labels": torch.from_numpy(toks[:, 1:]).long()}
    rl, rg = jax.jit(jax.value_and_grad(
        lambda p: rtfm.loss_fn(p, s["rcfg"], rbatch)[0]))(s["rparams"])
    tp = _bridge.tree_map(lambda t: t.detach().requires_grad_(True),
                          s["tparams"])
    assert ttfm.remat_enabled()
    tl, _ = ttfm.loss_fn(tp, s["tcfg"], tbatch)
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
        logits, aux = ttfm.forward(s["tparams"], s["tcfg"], tbatch)
    assert float(aux) == 0.0
    want = jax.jit(lambda p: rtfm.forward(p, s["rcfg"], rbatch)[0])(
        s["rparams"])
    _close(logits, want, **TOL)


@pytest.mark.parametrize("S", [7, 128])
def test_prefill_and_decode_match_reference(model, S):
    s = model
    steps, cap = 4, S + 8
    toks = _tokens(S + steps, seed=S)
    rl, rc = jax.jit(lambda p, t: rtfm.prefill(p, s["rcfg"], {"tokens": t},
                                               cap))(
        s["rparams"], jnp.asarray(toks[:, :S]))
    with torch.no_grad():
        tl, tc = ttfm.prefill(s["tparams"], s["tcfg"],
                              {"tokens": torch.from_numpy(toks[:, :S])}, cap)
    _close(tl, rl, **TOL)
    spec = ttfm.cache_spec(s["tcfg"], 2, cap)
    assert [tuple(t.shape) for t in _bridge.tree_leaves(spec)] == \
        [tuple(t.shape) for t in _bridge.tree_leaves(tc)]
    assert isinstance(tc[0][0], trec.MLSTMState)
    assert isinstance(tc[0][1], trec.SLSTMState)
    r_decode = jax.jit(lambda p, c, t: rtfm.decode_step(p, s["rcfg"], c, t))
    with torch.no_grad():
        for i in range(steps):
            tok = toks[:, S + i:S + i + 1]
            rl, rc = r_decode(s["rparams"], rc, jnp.asarray(tok))
            tl, tc = ttfm.decode_step(s["tparams"], s["tcfg"], tc,
                                      torch.from_numpy(tok))
            _close(tl, rl, **TOL)
    for a, b in zip(_bridge.tree_leaves(tc), jax.tree.leaves(rc)):
        _close(a, b, **TOL)


def test_decode_after_reference_prefill(model):
    """The reference's MLSTMState/SLSTMState caches cross the numpy
    bridge and decode in the port to the reference's logits."""
    s = model
    toks = _tokens(12, seed=9)
    _, rc = rtfm.prefill(s["rparams"], s["rcfg"],
                         {"tokens": jnp.asarray(toks[:, :9])}, 16)
    tc = _bridge.params_from_numpy(jax.tree.map(np.asarray, rc),
                                   device="cpu")
    assert isinstance(tc[0][0], trec.MLSTMState)
    assert isinstance(tc[0][1], trec.SLSTMState)
    with torch.no_grad():
        for i in range(9, 12):
            tok = toks[:, i:i + 1]
            rl, rc = rtfm.decode_step(s["rparams"], s["rcfg"], rc,
                                      jnp.asarray(tok))
            tl, tc = ttfm.decode_step(s["tparams"], s["tcfg"], tc,
                                      torch.from_numpy(tok))
            _close(tl, rl, **TOL)


def test_cache_spec_matches_reference(model):
    want = jax.tree.leaves(rtfm.cache_spec(model["rcfg"], 3, 24))
    got = _bridge.tree_leaves(ttfm.cache_spec(model["tcfg"], 3, 24))
    assert [(tuple(t.shape), str(t.dtype).split(".")[-1]) for t in got] \
        == [(tuple(t.shape), str(t.dtype)) for t in want]


def test_ssm_prunable_matches_reference(model):
    r_pred = rmasks.family_prunable("ssm")
    t_pred = get_family("ssm").prunable
    paths = _by_path(model["rparams"], False)
    seen = {k.split("/", 3)[-1] for k, a in paths.items() if t_pred(k, a)}
    assert {"rnn/cell/wq/w", "rnn/up", "rnn/down", "rnn/cell/ri/w",
            "rnn/cell/wi"} <= seen
    assert not {"rnn/cell/bf", "rnn/cell/bi", "norm1/scale"} & seen
    for k, a in paths.items():
        assert t_pred(k, a) == r_pred(k, a) == tmasks.recurrent_prunable(
            k, a), k
    assert not ttfm.supports_masked_prefill(model["tcfg"])
    assert not ttfm.supports_paged_decode(model["tcfg"])


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
def _requests(cls, lengths=(5, 9, 16, 4), max_new=5):
    rng = _rng(11)
    return [cls(uid=i, prompt=rng.integers(1, 500, size=n).astype(np.int32),
                max_new_tokens=max_new) for i, n in enumerate(lengths)]


def test_engine_streams_match_reference(model):
    """Greedy streams of 4 requests on 3 dense slots (exact-length
    prefill, the recurrent states spliced into their lanes)."""
    s = model
    reng = RServeEngine(params=s["rparams"], cfg=s["rcfg"],
                        prefill_fn=rtfm.prefill, decode_fn=rtfm.decode_step,
                        batch_slots=3, capacity=32)
    for r in _requests(RRequest):
        reng.submit(r)
    want = {r.uid: r.tokens for r in reng.run()}
    eng = ServeEngine(params=s["tparams"], cfg=s["tcfg"], batch_slots=3,
                      capacity=32, device="cpu")
    assert not eng.paged
    for r in _requests(Request):
        eng.submit(r)
    got = {r.uid: r.tokens for r in eng.run()}
    assert got == want
    caches = eng.generations[-1].slot_caches
    assert caches[0][0].C.shape == (2, 3, H, 32, 32)   # (reps, slots, ...)
    assert caches[0][1].m.dtype == torch.float32
    assert eng.smoke_decode(_requests(Request)[2].prompt, 5) == want[2]
