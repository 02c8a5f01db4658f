"""Shared transformer layers: norms, MLPs, embeddings, rotary embeddings.

Plain functions over dict pytrees of tensors, keyed like the reference's
(``repro.models.layers``).  Norm and rotary math runs in float32 and is
cast back to the input dtype exactly where the reference casts; matmul
outputs stay in the compute dtype.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.bsmm import plan_matmul
from repro_torch.models import hooks

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def _dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# Initialisers (the reference draws with jax.random; values differ by
# design, distributions match)
# ---------------------------------------------------------------------------
def xavier(gen: torch.Generator, shape, dtype, device, in_axis=0, out_axis=-1):
    fan_in = shape[in_axis]
    fan_out = shape[out_axis]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape, dtype=dtype, device=device).uniform_(
        -limit, limit, generator=gen)


def normal_init(gen: torch.Generator, shape, dtype, device, stddev=0.02):
    return (torch.randn(shape, generator=gen, device=device)
            * stddev).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rmsnorm_init(d: int, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params, x, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def layernorm_init(d: int, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(params, x, eps: float = 1e-5):
    """The reference's LayerNorm: mean and biased variance over the last
    axis, scale and bias, all in float32, cast back at the end."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def norm_init(kind: str, d: int, dtype, device):
    return (rmsnorm_init(d, dtype, device) if kind == "rmsnorm"
            else layernorm_init(d, dtype, device))


def apply_norm(kind: str, params, x):
    return rmsnorm(params, x) if kind == "rmsnorm" else layernorm(params, x)


# ---------------------------------------------------------------------------
# MLP (gated SwiGLU / plain)
# ---------------------------------------------------------------------------
def mlp_init(gen, d_model: int, d_ff: int, gated: bool, bias: bool,
             dtype, device):
    p = {"up": xavier(gen, (d_model, d_ff), dtype, device),
         "down": xavier(gen, (d_ff, d_model), dtype, device)}
    if gated:
        p["gate"] = xavier(gen, (d_model, d_ff), dtype, device)
    if bias:
        p["up_b"] = torch.zeros((d_ff,), dtype=dtype, device=device)
        p["down_b"] = torch.zeros((d_model,), dtype=dtype, device=device)
    return p


def _act(name: str, x):
    """The reference's ``_act``: silu, or gelu in its tanh form (what
    ``jax.nn.gelu`` computes by default)."""
    if name == "silu":
        return torch.nn.functional.silu(x)
    if name == "gelu":
        return torch.nn.functional.gelu(x, approximate="tanh")
    raise ValueError(name)


def mlp(params, x, act: str = "silu", plan=None):
    """``plan`` routes up/gate/down through the block-sparse kernel; bias
    adds and the gate (or up) activation ride its fused epilogue.  Under
    a tensor-parallel context whose ``down`` is this rank's shard, up and
    gate are column-parallel and down row-parallel."""
    plan = plan or {}
    col = row = plan_matmul
    tp = hooks.tensor_parallel()
    if tp is not None and tp.is_sharded(params["down"]):
        col, row = tp.col, tp.row
        x = tp.copy_in(x)
    if "gate" in params:
        up = col(x, params["up"], plan.get("up"), bias=params.get("up_b"))
        h = col(x, params["gate"], plan.get("gate"), act=act) * up
    else:
        h = col(x, params["up"], plan.get("up"), bias=params.get("up_b"),
                act=act)
    return row(h, params["down"], plan.get("down"),
               bias=params.get("down_b"))


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------
def embed_init(gen, vocab: int, d: int, dtype, device):
    return {"table": normal_init(gen, (vocab, d), dtype, device)}


def embed(params, tokens):
    tp = hooks.tensor_parallel()
    if tp is not None and tp.is_sharded(params["table"]):
        return tp.embed(params["table"], tokens)
    return params["table"][tokens]


def unembed(params, x):
    """Project hidden states to logits (optionally with a tied table)."""
    tp = hooks.tensor_parallel()
    if tp is not None and tp.is_sharded(params["table"]):
        return tp.unembed(params["table"], x)
    return x @ params["table"].T


def sinusoidal_positions(seq_len: int, d: int, dtype, device):
    """(seq_len, d) positions: ``[sin, cos]`` of pos / 10000^(2i/d)
    concatenated (not interleaved), computed in float32 and cast."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos * torch.exp(-math.log(10000.0) * 2.0 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (split-half, not interleaved)
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float, device=None):
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x, positions, theta: float = 10_000.0):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, device=x.device)       # (hd/2,)
    ang = positions[..., :, None, None].float() * freqs        # (...,S,1,hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------
def softmax_cross_entropy(logits, labels, mask=None, z_loss: float = 0.0,
                          count=None):
    """Mean CE over valid positions; logits (..., V) in any dtype, labels
    of any integer dtype (``gather`` wants int64).  ``count`` (a tensor)
    replaces the denominator: a data-parallel mesh divides each rank's
    sum by the token count of the global batch."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * lse.square()
    if count is not None:
        if mask is not None:
            loss = loss * mask.float()
        return loss.sum() / count.clamp_min(1.0)
    if mask is not None:
        mask = mask.float()
        return (loss * mask).sum() / mask.sum().clamp_min(1.0)
    return loss.mean()
