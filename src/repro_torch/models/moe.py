"""Mixture-of-Experts FFN: top-k routing, grouped capacity dispatch,
batched expert compute, optional shared experts.

A port of ``repro.models.moe``, for serving and training.  Dispatch is
the reference's
sort-based capacity scheme with one dispatch group (the reference's
default with no mesh installed; the port has no mesh hook yet): the
(token, expert) pairs are sorted by expert, the first C per expert are
scattered into an (E, C, d) buffer, the experts run batched over that
buffer, and a scatter-add combines their outputs back into the tokens.

Tie orders follow the reference exactly: top-k comes from a stable
descending sort (``jax.lax.top_k`` breaks ties to the lower index) and
the dispatch sort is stable (``jnp.argsort`` is).  With a plan the
expert products run block-sparse through ``kernels.bsmm.bsmm_batched_apply``,
one launch per projection for all experts, forward and (with gradients
on) each of the backward's dx and dw.  The router, the aux loss and the
combine differentiate through plain autograd, as the reference's do
through XLA; the aux loss's ``density`` term (expert counts) carries no
gradient there either.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels.bsmm import bsmm_batched_apply
from repro_torch.models.layers import _act, mlp, mlp_init, xavier


class MoEOutput(NamedTuple):
    y: torch.Tensor
    aux_loss: torch.Tensor
    # fraction of routed pairs dropped by the capacity limit (diagnostic)
    drop_fraction: torch.Tensor


def moe_init(gen, d_model: int, moe, gated: bool, dtype, device):
    E, ff = moe.num_experts, moe.d_ff_expert
    p = {
        "router": xavier(gen, (d_model, E), dtype, device),
        "up": xavier(gen, (E, d_model, ff), dtype, device, in_axis=1,
                     out_axis=2),
        "down": xavier(gen, (E, ff, d_model), dtype, device, in_axis=1,
                       out_axis=2),
    }
    if gated:
        p["gate"] = xavier(gen, (E, d_model, ff), dtype, device, in_axis=1,
                           out_axis=2)
    if moe.num_shared_experts > 0:
        ff_s = (moe.d_ff_shared or ff) * moe.num_shared_experts
        p["shared"] = mlp_init(gen, d_model, ff_s, gated, False, dtype,
                               device)
    return p


def expert_capacity(tokens_per_group: int, moe) -> int:
    c = int(math.ceil(tokens_per_group * moe.top_k * moe.capacity_factor
                      / moe.num_experts))
    return max(8, -(-c // 8) * 8)  # round up to 8 for tiling


def _expert_matmul(a, w, plan, spec: str):
    """Per-expert matmul, optionally block-sparse.

    ``a``: (E, C, din); ``w``: (E, din, dout); ``plan``: one shared
    ``TilePlan`` built from the mask unioned over the expert axis
    (``models.plans``) — a tile is skipped only when it is dead in
    EVERY expert, which is exact because pruned weights are exact
    zeros.  With a plan, the C rows of each expert go through one
    batched kernel launch (and its backward through one batched dx and
    one batched dw launch); dense einsum when there is none.
    """
    if plan is None:
        return torch.einsum(spec, a, w)
    return bsmm_batched_apply(a, w, plan)


def _top_k(probs, k: int):
    """``jax.lax.top_k`` over the last axis: values in descending order,
    ties to the lower index (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_forward(params, x, moe, act: str, gated: bool,
                plan=None) -> MoEOutput:
    """x: (B, S, d) -> MoEOutput with y: (B, S, d).

    ``plan`` (from ``models.plans.build_decode_plan``): per-projection
    tile plans — keys ``up``/``gate``/``down`` for the stacked expert
    tensors and ``shared`` for the shared-expert MLP.
    """
    B, S, d = x.shape
    T = B * S
    k, E = moe.top_k, moe.num_experts
    C = expert_capacity(T, moe)
    dev = x.device

    xt = x.reshape(T, d)
    # the router product in the parameters' dtype, then f32
    logits = (xt @ params["router"]).float()                  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = _top_k(probs, k)                           # (T, k)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)

    # ---- aux load-balance loss (Switch/GShard form) ----
    density = torch.zeros((E,), dtype=torch.float32, device=dev).index_add_(
        0, top_e.reshape(-1), torch.ones(top_e.numel(), device=dev)) / T
    density_proxy = probs.mean(dim=0)
    aux = (density * density_proxy).sum() * E / k

    # ---- sort-based capacity dispatch ----
    e_flat = top_e.reshape(T * k)
    w_flat = top_w.reshape(T * k)
    tok_flat = torch.arange(T, device=dev).repeat_interleave(k)
    order = torch.argsort(e_flat, stable=True)                # (T·k,)
    e_s, tok_s, w_s = e_flat[order], tok_flat[order], w_flat[order]
    # expert counts from the sorted ids (no T×E one-hot)
    cum = torch.searchsorted(e_s, torch.arange(E + 1, device=dev))
    counts = cum[1:] - cum[:-1]
    starts = cum[:-1]
    pos_in_e = torch.arange(T * k, device=dev) - starts[e_s]
    keep = pos_in_e < C
    dest = torch.where(keep, e_s * C + pos_in_e, 0)
    drop_fraction = 1.0 - keep.float().mean()

    rows = xt[tok_s] * keep[:, None].to(x.dtype)
    # dropped pairs add zero rows into slot 0, as the reference's do
    buf = torch.zeros((E * C, d), dtype=x.dtype, device=dev) \
        .index_add_(0, dest, rows).reshape(E, C, d)

    # ---- batched expert compute ----
    plan = plan or {}
    up = _expert_matmul(buf, params["up"], plan.get("up"), "ecd,edf->ecf")
    if gated:
        h = _act(act, _expert_matmul(buf, params["gate"], plan.get("gate"),
                                     "ecd,edf->ecf")) * up
    else:
        h = _act(act, up)
    y_buf = _expert_matmul(h, params["down"], plan.get("down"),
                           "ecf,efd->ecd")

    # ---- combine: scatter FROM the expert buffer INTO tokens ----
    # slot s = e·C + pos holds sorted pair index starts[e] + pos
    e_of_slot = torch.arange(E * C, device=dev) // C
    pos_of_slot = torch.arange(E * C, device=dev) % C
    src = (starts[e_of_slot] + pos_of_slot).clamp_max(T * k - 1)
    valid = pos_of_slot < counts[e_of_slot]                   # (E·C,)
    slot_tok = torch.where(valid, tok_s[src], T)
    slot_w = torch.where(valid, w_s[src], 0.0)
    contrib = (y_buf.reshape(E * C, d)
               * slot_w[:, None].to(y_buf.dtype)).to(x.dtype)
    # the overflow row T takes the empty slots' zero rows
    out = torch.zeros((T + 1, d), dtype=x.dtype, device=dev) \
        .index_add_(0, slot_tok, contrib)[:T]

    if "shared" in params:
        out = out + mlp(params["shared"], xt, act, plan=plan.get("shared"))
    return MoEOutput(out.reshape(B, S, d), aux, drop_fraction)
