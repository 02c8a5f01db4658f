"""The RG-LRU block (RecurrentGemma / Griffin): the recurrent half of the
``hybrid`` family.

A port of the RG-LRU part of ``repro.models.recurrent``: the
block-diagonal gate projections, the causal depthwise conv1d with its
decode state, and the real-gated linear recurrence

    h_t = a_t * h_{t-1} + b_t,   a_t = exp(log_a_t)

run in float32 whatever the parameter dtype.  The reference computes
the training forward and the prefill with ``jax.lax.associative_scan``
over the pairs (log_a, b); torch has none, so ``_linear_scan`` runs the
same ``combine`` as a log-depth (Hillis–Steele) scan of plain,
differentiable torch ops.  Decode is the O(1)-state step.

The block has no Pallas kernel in the reference, so eager torch is its
whole port.  Its projections ``w_in``/``w_gate``/``w_out`` are prunable
but never planned (the reference's plan walker routes only attention,
MLP and MoE groups): they stay dense products on the masked weights.
``rglru_step`` updates the decode state IN PLACE (the reference returns
a new one), as the port's other decode caches are.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

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


def _rglru_core(params, x):
    """(y, u_raw, h): the block's output, its pre-conv input and the
    recurrence's states."""
    gate = F.gelu(x @ params["w_gate"], approximate="tanh")
    u_raw = x @ params["w_in"]
    u = conv1d_apply(params["conv"], u_raw).float()
    log_a, b = _rglru_gates(params, u)
    h = _linear_scan(log_a, b)
    y = (h.to(x.dtype) * gate) @ params["w_out"]
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
    xt = x_t[:, 0]
    gate = F.gelu(xt @ params["w_gate"], approximate="tanh")
    u = xt @ params["w_in"]
    u, conv = conv1d_step(params["conv"], state.conv, u)
    u = u.float()
    log_a, b = _rglru_gates(params, u)
    h = torch.exp(log_a) * state.h + b
    state.h.copy_(h)
    state.conv.copy_(conv)
    y = (h.to(xt.dtype) * gate) @ params["w_out"]
    return y[:, None, :], state
