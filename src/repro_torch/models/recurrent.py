"""Recurrent blocks: the RG-LRU (RecurrentGemma / Griffin, the recurrent
half of the ``hybrid`` family) and xLSTM's mLSTM and sLSTM cells (the
``ssm`` family).

A port of ``repro.models.recurrent``.  Every recurrence runs in float32
whatever the parameter dtype.

* RG-LRU: the block-diagonal gate projections, the causal depthwise
  conv1d with its decode state, and the real-gated linear recurrence
  ``h_t = a_t * h_{t-1} + b_t``, ``a_t = exp(log_a_t)``.  The reference
  computes the training forward and the prefill with
  ``jax.lax.associative_scan`` over the pairs (log_a, b); torch has none,
  so ``_linear_scan`` runs the same ``combine`` as a log-depth
  (Hillis–Steele) scan of plain, differentiable torch ops.
* mLSTM: the stabilised matrix memory (C, n, m), chunkwise-parallel
  (``mlstm_chunkwise``, chunks of 128; a length that is not a whole
  number of chunks runs the sequential form, as in the reference) and
  sequential (``mlstm_sequential``, the oracle and the decode step).
* sLSTM: exponential gating with a block-diagonal recurrence, a
  token-by-token loop (the reference's ``lax.scan``).

Decode is the O(1)-state step of each cell.  The cells have no Pallas
kernel in the reference, so eager torch is their whole port.  Their
projections are prunable but never planned (the reference's plan walker
routes only attention, MLP and MoE groups): they stay dense products on
the masked weights.  The decode steps (``rglru_step``, ``mlstm_step``,
``slstm_step``) update the state IN PLACE (the reference returns a new
one), as the port's other decode caches are.

On a mesh's model axis (``distributed.tensor_parallel``, installed in
``models.hooks``) a cell whose leaves are this rank's shards runs at
its local channels or heads, its state at the local width: the RG-LRU
channel-parallel (``w_out`` row-parallel), the mLSTM and sLSTM over
their local heads.  Every width is read from the parameters.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _mark
from repro_torch.models import hooks
from repro_torch.models.layers import xavier

_RGLRU_C = 8.0


# ---------------------------------------------------------------------------
# Block-diagonal (per-head) linear — the RG-LRU's recurrence and input gates
# ---------------------------------------------------------------------------
def blockdiag_init(gen, width: int, n_blocks: int, dtype, device):
    bs = width // n_blocks
    lim = math.sqrt(6.0 / (2 * bs))
    w = torch.empty((n_blocks, bs, bs), dtype=dtype, device=device)
    return {"w": w.uniform_(-lim, lim, generator=gen)}


def blockdiag_apply(params, x):
    """x: (..., width) -> (..., width), one matmul per block, in x's
    dtype (the reference promotes the weight to it)."""
    nb, bs, _ = params["w"].shape
    xs = x.reshape(*x.shape[:-1], nb, bs)
    ys = torch.einsum("...nb,nbc->...nc", xs, params["w"].to(x.dtype))
    return ys.reshape(*x.shape[:-1], nb * bs)


# ---------------------------------------------------------------------------
# Causal depthwise conv1d (width cw), with the last cw - 1 inputs as state
# ---------------------------------------------------------------------------
def conv1d_init(gen, width: int, cw: int, dtype, device):
    lim = math.sqrt(1.0 / cw)
    w = torch.empty((cw, width), dtype=dtype, device=device)
    return {"w": w.uniform_(-lim, lim, generator=gen)}


def conv1d_apply(params, u):
    """u: (B, S, w) causal depthwise conv, summed in u's dtype in the
    reference's tap order (the current input first)."""
    w = params["w"]
    cw, S = w.shape[0], u.shape[1]
    out = u * w[cw - 1]
    for j in range(1, cw):
        shifted = F.pad(u, (0, 0, j, 0))[:, :S]
        out = out + shifted * w[cw - 1 - j]
    return out


def conv1d_step(params, conv_state, u_t):
    """conv_state: (B, cw-1, w) the last inputs; u_t: (B, w).  Returns
    (y (B, w), the new state (B, cw-1, w))."""
    hist = torch.cat([conv_state, u_t[:, None, :]], dim=1)       # (B, cw, w)
    y = torch.einsum("bcw,cw->bw", hist, params["w"])
    return y, hist[:, 1:]


def _sharded(leaf):
    """The tensor-parallel context when ``leaf`` is this rank's shard
    (its cell runs at the local channels or heads), else None."""
    tp = hooks.tensor_parallel()
    return tp if tp is not None and tp.is_sharded(leaf) else None


# ===========================================================================
# RG-LRU (Griffin real-gated linear recurrent unit)
# ===========================================================================
class RGLRUState(NamedTuple):
    h: torch.Tensor          # (B, w) float32
    conv: torch.Tensor       # (B, cw-1, w) the parameter dtype


def rglru_init(gen, d_model: int, width: int, n_heads: int, cw: int, dtype,
               device):
    """Λ is drawn so that a = exp(-c·softplus(Λ)) lies in (0.9, 0.999) at
    r = 1 (softplus(Λ) = -log(a)/c), and stays float32 in any tree."""
    u = torch.rand((width,), generator=gen, device=device)
    a = 0.9 + u * (0.999 - 0.9)
    lam = torch.log(torch.expm1(-torch.log(a) / _RGLRU_C))
    return {
        "w_in": xavier(gen, (d_model, width), dtype, device),
        "w_gate": xavier(gen, (d_model, width), dtype, device),
        "w_out": xavier(gen, (width, d_model), dtype, device),
        "conv": conv1d_init(gen, width, cw, dtype, device),
        "rg": blockdiag_init(gen, width, n_heads, dtype, device),
        "ig": blockdiag_init(gen, width, n_heads, dtype, device),
        "lam": lam.float(),
    }


def _rglru_gates(params, u):
    """u: (..., w) f32 -> (log_a, gated input b), both f32."""
    r = torch.sigmoid(blockdiag_apply(params["rg"], u))
    i = torch.sigmoid(blockdiag_apply(params["ig"], u))
    log_a = -_RGLRU_C * F.softplus(params["lam"].float()) * r
    a2 = torch.exp(2.0 * log_a)
    b = torch.sqrt(torch.clamp(1.0 - a2, min=1e-9)) * (i * u)
    return log_a, b


def _linear_scan(log_a, b):
    """h_t = exp(log_a_t) h_{t-1} + b_t over axis 1 from h_{-1} = 0: the
    reference's ``associative_scan`` of ``combine((a1, b1), (a2, b2)) =
    (a1 + a2, exp(a2) b1 + b2)``, as a Hillis–Steele scan (each step
    combines every position with the one ``d`` before it, d = 1, 2, 4,
    ...).  Out of place, so autograd sees every step."""
    S = log_a.shape[1]
    a, h = log_a, b
    d = 1
    while d < S:
        h = torch.cat([h[:, :d], torch.exp(a[:, d:]) * h[:, :-d] + h[:, d:]],
                      dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] + a[:, d:]], dim=1)
        d *= 2
    return h


def _rglru_local(params, x):
    """(tp, params, x): on a rank's channel shard the context, the
    parameters with the replicated leaves it reads per channel (Λ, and
    a conv the layout kept whole) cut to the local channels, and ``x``
    through ``copy_in``; else (None, params, x)."""
    tp = _sharded(params["w_out"])
    if tp is None:
        return None, params, x
    conv = params["conv"]
    if not tp.is_sharded(conv["w"]):
        conv = {"w": tp.cut(conv["w"])}
    return (tp, dict(params, conv=conv, lam=tp.cut(params["lam"])),
            tp.copy_in(x))


def _rglru_out(tp, params, y):
    """The gated states' output projection (row-parallel on a shard)."""
    y = y @ params["w_out"]
    return y if tp is None else tp.all_reduce(y)


def _rglru_core(params, x):
    """(y, u_raw, h): the block's output, its pre-conv input and the
    recurrence's states."""
    tp, params, x = _rglru_local(params, x)
    gate = F.gelu(x @ params["w_gate"], approximate="tanh")
    u_raw = x @ params["w_in"]
    u = conv1d_apply(params["conv"], u_raw).float()
    log_a, b = _rglru_gates(params, u)
    h = _linear_scan(log_a, b)
    y = _rglru_out(tp, params, h.to(x.dtype) * gate)
    return y, u_raw, h


def rglru_forward(params, x):
    """x: (B, S, d) -> (B, S, d): conv, RG-LRU and the gelu-gated output."""
    return _rglru_core(params, x)[0]


def rglru_init_state(params, batch: int) -> RGLRUState:
    w = params["w_in"].shape[1]
    cw = params["conv"]["w"].shape[0]
    dev = params["w_in"].device
    return RGLRUState(
        h=torch.zeros((batch, w), dtype=torch.float32, device=dev),
        conv=torch.zeros((batch, cw - 1, w), dtype=params["w_in"].dtype,
                         device=dev))


def rglru_state_spec(batch: int, width: int, cw: int, dtype) -> RGLRUState:
    """Shape and dtype of one layer's decode state, as meta tensors."""
    return RGLRUState(
        h=torch.empty((batch, width), dtype=torch.float32, device="meta"),
        conv=torch.empty((batch, cw - 1, width), dtype=dtype, device="meta"))


def rglru_make_cache(params, x):
    """Prefill: (the forward over x, the state after its last token).
    The conv state is the last cw - 1 pre-conv inputs, left-padded with
    zeros when S < cw - 1."""
    y, u_raw, h = _rglru_core(params, x)
    cw = params["conv"]["w"].shape[0]
    conv = u_raw[:, -(cw - 1):, :]
    pad = (cw - 1) - conv.shape[1]
    if pad > 0:
        conv = F.pad(conv, (0, 0, pad, 0))
    return y, RGLRUState(h=h[:, -1].float().contiguous(),
                         conv=conv.contiguous())


def rglru_step(params, state: RGLRUState, x_t):
    """One decode token.  x_t: (B, 1, d) -> (y_t (B, 1, d), state); the
    state's ``h`` and ``conv`` are written IN PLACE."""
    tp, params, x_t = _rglru_local(params, x_t)
    xt = x_t[:, 0]
    gate = F.gelu(xt @ params["w_gate"], approximate="tanh")
    u = xt @ params["w_in"]
    u, conv = conv1d_step(params["conv"], state.conv, u)
    u = u.float()
    log_a, b = _rglru_gates(params, u)
    h = torch.exp(log_a) * state.h + b
    state.h.copy_(h)
    state.conv.copy_(conv)
    y = _rglru_out(tp, params, h.to(xt.dtype) * gate)
    return y[:, None, :], state


# ===========================================================================
# mLSTM (xLSTM matrix-memory cell), stabilised
# ===========================================================================
class MLSTMState(NamedTuple):
    C: torch.Tensor          # (B, H, dk, dv) float32
    n: torch.Tensor          # (B, H, dk) float32
    m: torch.Tensor          # (B, H) float32 stabiliser


def mlstm_cell_init(gen, width: int, n_heads: int, dtype, device):
    """Block-diagonal q/k/v, input and forget gate projections; the
    gate biases stay float32, the forget gates open (bias 3)."""
    return {
        "wq": blockdiag_init(gen, width, n_heads, dtype, device),
        "wk": blockdiag_init(gen, width, n_heads, dtype, device),
        "wv": blockdiag_init(gen, width, n_heads, dtype, device),
        "wi": xavier(gen, (width, n_heads), dtype, device),
        "wf": xavier(gen, (width, n_heads), dtype, device),
        "bi": torch.zeros((n_heads,), dtype=torch.float32, device=device),
        "bf": torch.full((n_heads,), 3.0, dtype=torch.float32,
                         device=device),
    }


def _mlstm_qkvif(params, u, n_heads):
    """u: (B, S, w) -> q, k, v (B, S, H, hd) and the gate logits li, lf
    (B, S, H), all float32.  q/k/v are the block-diagonal products in
    u's dtype (k scaled by 1/sqrt(hd) there), cast afterwards.  On a
    rank's head shard ``u`` holds the local heads' channels, and the
    gates gather all of it (``TensorParallel.gather_local``)."""
    B, S, w = u.shape
    hd = w // n_heads
    q = blockdiag_apply(params["wq"], u).reshape(B, S, n_heads, hd)
    k = blockdiag_apply(params["wk"], u).reshape(B, S, n_heads, hd)
    v = blockdiag_apply(params["wv"], u).reshape(B, S, n_heads, hd)
    bi, bf = params["bi"], params["bf"]
    tp = _sharded(params["wi"])
    if tp is not None:
        # a local head's gate logits read every channel of u
        u = tp.gather_local(u, -1)
        bi, bf = tp.cut(bi), tp.cut(bf)
    li = (u @ params["wi"]).float() + bi
    lf = F.logsigmoid((u @ params["wf"]).float() + bf)
    k = k / math.sqrt(hd)
    return q.float(), k.float(), v.float(), li, lf


def mlstm_init_state(batch: int, n_heads: int, hd: int,
                     device) -> MLSTMState:
    """Empty memory; the stabiliser starts at the finite -1e30."""
    f32 = dict(dtype=torch.float32, device=device)
    return MLSTMState(C=torch.zeros((batch, n_heads, hd, hd), **f32),
                      n=torch.zeros((batch, n_heads, hd), **f32),
                      m=torch.full((batch, n_heads), -1e30, **f32))


def mlstm_state_spec(batch: int, n_heads: int, hd: int) -> MLSTMState:
    """Shape and dtype of one layer's decode state, as meta tensors."""
    meta = dict(dtype=torch.float32, device="meta")
    return MLSTMState(C=torch.empty((batch, n_heads, hd, hd), **meta),
                      n=torch.empty((batch, n_heads, hd), **meta),
                      m=torch.empty((batch, n_heads), **meta))


def mlstm_sequential(params, u, n_heads, state: MLSTMState = None):
    """Step-by-step mLSTM, the oracle of the chunkwise form.  u: (B, S,
    w) -> (h (B, S, w) float32, the state after the last token)."""
    B, S, w = u.shape
    hd = w // n_heads
    q, k, v, li, lf = _mlstm_qkvif(params, u, n_heads)
    if state is None:
        state = mlstm_init_state(B, n_heads, hd, u.device)
    C, n, m = state
    hs = []
    for t in range(S):
        qt, kt, vt, lit, lft = q[:, t], k[:, t], v[:, t], li[:, t], lf[:, t]
        m_new = torch.maximum(lft + m, lit)
        fp = torch.exp(lft + m - m_new)[..., None]
        ip = torch.exp(lit - m_new)[..., None]
        C = fp[..., None] * C + ip[..., None] * (kt[..., :, None]
                                                 * vt[..., None, :])
        n = fp * n + ip * kt
        num = torch.einsum("bhk,bhkv->bhv", qt, C)
        den = torch.maximum(torch.einsum("bhk,bhk->bh", qt, n).abs(),
                            torch.exp(-m_new))[..., None]
        hs.append(num / den)
        m = m_new
    h = torch.stack(hs, dim=1).reshape(B, S, w)
    return h, MLSTMState(C, n, m)


def mlstm_chunkwise(params, u, n_heads, chunk: int = 128,
                    state: MLSTMState = None):
    """Chunkwise-parallel stabilised mLSTM, exact (held to
    ``mlstm_sequential``): within a chunk of L tokens the decays are
    cumulative sums b of the forget logits and the stabiliser the
    running max (``cummax``) of li - b; across chunks (C, n, m) carry
    over.  S not a multiple of ``chunk`` runs the sequential form."""
    B, S, w = u.shape
    hd = w // n_heads
    if S % chunk:
        return mlstm_sequential(params, u, n_heads, state)
    L = chunk
    q, k, v, li, lf = _mlstm_qkvif(params, u, n_heads)
    if state is None:
        state = mlstm_init_state(B, n_heads, hd, u.device)
    C, n, m = state
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))        # (B, H, S, hd)
    li, lf = li.transpose(1, 2), lf.transpose(1, 2)         # (B, H, S)
    tri = torch.ones((L, L), dtype=torch.bool, device=u.device).tril()
    # under a step trace the first chunk is recorded as all S / L
    h, (C, n, m) = _mark.alike_steps(_mlstm_chunk, S // L, 2, (tri,),
                                     (q, k, v, li, lf), (C, n, m))
    h = h.transpose(1, 2).reshape(B, S, w)
    return h, MLSTMState(C, n, m)


def _mlstm_chunk(consts, xs, carry):
    """One chunk of ``mlstm_chunkwise`` (``xs``: q/k/v (B, H, L, hd), the
    gate logits (B, H, L); ``consts``: the causal mask) from the carry
    (C, n, m): (h (B, H, L, hd), the carry into the next chunk)."""
    (tri,), (qt, kt, vt, lit, lft), (C, n, m) = consts, xs, carry
    b = torch.cumsum(lft, dim=-1)                       # inclusive decays
    G = b[..., -1:]
    m_intra = torch.cummax(lit - b, dim=-1).values + b
    m_inter = b + m[..., None]
    m_t = torch.maximum(m_inter, m_intra)               # (B, H, L)
    # the memory carried in from earlier chunks
    q_scaled = qt * torch.exp(m_inter - m_t)[..., None]
    num_inter = torch.einsum("bhlk,bhkv->bhlv", q_scaled, C)
    den_inter = torch.einsum("bhlk,bhk->bhl", q_scaled, n)
    # within the chunk: D[t, s] = exp(b_t - b_s + li_s - m_t), s <= t
    # (exp of the masked entries is exp(-inf) = 0, so no inf ever
    # meets the backward's zero cotangent)
    logD = (b[..., :, None] - b[..., None, :] + lit[..., None, :]
            - m_t[..., :, None])
    D = torch.exp(torch.where(tri, logD, float("-inf")))
    scores = torch.einsum("bhlk,bhsk->bhls", qt, kt) * D
    num = num_inter + torch.einsum("bhls,bhsv->bhlv", scores, vt)
    den = den_inter + scores.sum(dim=-1)
    h = num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None]
    # the carry into the next chunk
    m_next = torch.maximum(m + G[..., 0], (lit + G - b).amax(dim=-1))
    scale_old = torch.exp(m + G[..., 0] - m_next)[..., None, None]
    kw = kt * torch.exp(G - b + lit - m_next[..., None])[..., None]
    C = C * scale_old + torch.einsum("bhlk,bhlv->bhkv", kw, vt)
    n = n * scale_old[..., 0] + kw.sum(dim=2)
    return h, (C, n, m_next)


def _copy_state_(state, new):
    for dst, src in zip(state, new):
        dst.copy_(src)
    return state


def mlstm_step(params, state: MLSTMState, u_t, n_heads):
    """One decode token.  u_t: (B, 1, w) -> (h (B, 1, w), state); the
    state is written IN PLACE."""
    h, new = mlstm_sequential(params, u_t, n_heads, state)
    return h, _copy_state_(state, new)


# ===========================================================================
# sLSTM (xLSTM scalar cell: exponential gating, block-diagonal recurrence)
# ===========================================================================
class SLSTMState(NamedTuple):
    c: torch.Tensor          # (B, w) float32
    n: torch.Tensor
    h: torch.Tensor
    m: torch.Tensor


_SLSTM_GATES = ("i", "f", "z", "o")


def slstm_cell_init(gen, d_model: int, width: int, n_heads: int, dtype,
                    device):
    """Per gate g: input projection ``wg``, block-diagonal recurrence
    ``rg`` and a float32 bias ``bg`` (the forget gate's 3)."""
    p = {}
    for g in _SLSTM_GATES:
        p[f"w{g}"] = xavier(gen, (d_model, width), dtype, device)
        p[f"r{g}"] = blockdiag_init(gen, width, n_heads, dtype, device)
        p[f"b{g}"] = torch.full((width,), 3.0 if g == "f" else 0.0,
                                dtype=torch.float32, device=device)
    return p


def slstm_init_state(batch: int, width: int, device) -> SLSTMState:
    """Zero cell, normaliser and output (four tensors of their own, so
    that a step may write each in place); the stabiliser at -1e30."""
    def z():
        return torch.zeros((batch, width), dtype=torch.float32,
                           device=device)
    return SLSTMState(c=z(), n=z(), h=z(),
                      m=torch.full((batch, width), -1e30,
                                   dtype=torch.float32, device=device))


def slstm_state_spec(batch: int, width: int) -> SLSTMState:
    """Shape and dtype of one layer's decode state, as meta tensors."""
    def z():
        return torch.empty((batch, width), dtype=torch.float32,
                           device="meta")
    return SLSTMState(c=z(), n=z(), h=z(), m=z())


def _slstm_step(params, state: SLSTMState, xi, xf, xz, xo):
    """One token from its precomputed float32 input projections (B, w):
    (h, the new state)."""
    c, n, h, m = state
    li = xi + blockdiag_apply(params["ri"], h) + params["bi"]
    lf = F.logsigmoid(xf + blockdiag_apply(params["rf"], h) + params["bf"])
    z = torch.tanh(xz + blockdiag_apply(params["rz"], h) + params["bz"])
    o = torch.sigmoid(xo + blockdiag_apply(params["ro"], h) + params["bo"])
    m_new = torch.maximum(lf + m, li)
    fp = torch.exp(lf + m - m_new)
    ip = torch.exp(li - m_new)
    c = fp * c + ip * z
    n = torch.clamp(fp * n + ip, min=1e-6)
    h = o * (c / n)
    return h, SLSTMState(c=c, n=n, h=h, m=m_new)


def slstm_forward(params, x, state: SLSTMState = None):
    """x: (B, S, d) -> (h (B, S, w) float32, the state after the last
    token): the input projections at once, then a loop over time.  On a
    rank's head shard h and the state are the local heads' channels."""
    B, S, _ = x.shape
    w = params["wi"].shape[1]
    if state is None:
        state = slstm_init_state(B, w, x.device)
    tp = _sharded(params["wi"])
    if tp is None:
        proj = [(x @ params[f"w{g}"]).float() for g in _SLSTM_GATES]
    else:
        # the local heads' channels: wi/wf/wz column shards, wo (cut by
        # rows) summed and cut to them; the biases cut at use
        x = tp.copy_in(x)
        proj = [(x @ params[f"w{g}"]).float() for g in _SLSTM_GATES[:3]]
        proj.append(tp.row_local(x, params["wo"]).float())
        params = dict(params, **{f"b{g}": tp.cut(params[f"b{g}"])
                                 for g in _SLSTM_GATES})
    consts = ([params[f"r{g}"]["w"] for g in _SLSTM_GATES]
              + [params[f"b{g}"] for g in _SLSTM_GATES])
    # under a step trace the first token is recorded as all S
    h, state = _mark.alike_steps(_slstm_token, S, 1, consts, proj,
                                 tuple(state))
    return h, SLSTMState(*state)


def _slstm_token(consts, xs, carry):
    """``slstm_forward``'s step (``consts``: the four recurrent blocks'
    weights, then the four biases; ``xs``: one token's projections
    (B, 1, w)): (h (B, 1, w), the new state)."""
    p = {f"r{g}": {"w": r} for g, r in zip(_SLSTM_GATES, consts[:4])}
    p.update({f"b{g}": b for g, b in zip(_SLSTM_GATES, consts[4:])})
    h, new = _slstm_step(p, SLSTMState(*carry), *(x[:, 0] for x in xs))
    return h[:, None], tuple(new)


def slstm_step(params, state: SLSTMState, x_t):
    """One decode token.  x_t: (B, 1, d) -> (h (B, 1, w), state); the
    state is written IN PLACE."""
    h, new = slstm_forward(params, x_t, state)
    return h, _copy_state_(state, new)
