"""Mixture-of-Experts FFN: top-k routing, grouped capacity dispatch,
batched expert compute, optional shared experts.

A port of ``repro.models.moe``, for serving and training.  Dispatch is
the reference's sort-based capacity scheme computed per *group*
(GShard/Switch "local groups"): the T tokens split into G groups (G
defaults to ``hooks.moe_groups()``, the data-shard count a mesh
installs, and divides down until it divides T); each group sorts its
(token, expert) pairs by expert, keeps the first C per expert (C sized
from the group's tokens) and scatters them into its slice of a (G, E,
C, d) buffer; the experts run batched over that buffer and a
scatter-add combines their outputs back into each group's tokens.  The
aux loss and ``drop_fraction`` stay global.  On a mesh with a model
axis the experts are split over it (expert parallelism): each rank runs
its own experts' rows and the outputs are gathered over the experts.

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
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.bsmm import bsmm_batched_apply
from repro_torch.models import hooks
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


def _num_groups(T: int, requested: Optional[int]) -> int:
    g = requested if requested is not None else hooks.moe_groups()
    g = max(1, min(g, T))
    while T % g:
        g -= 1
    return g


def _expert_matmul(a, w, plan, spec: str):
    """Per-expert matmul, optionally block-sparse.

    ``a``: (E, R, din) — every group's C rows of an expert side by side
    (R = G·C: rows are independent, so folding the groups into the rows
    is exact); ``w``: (E, din, dout); ``plan``: one shared ``TilePlan``
    built from the mask unioned over the expert axis
    (``models.plans``) — a tile is skipped only when it is dead in
    EVERY expert, which is exact because pruned weights are exact
    zeros.  With a plan, the rows of every expert go through one
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


def _experts(params, buf, act: str, gated: bool, plan):
    """(E, R, d) expert rows → (E, R, d) outputs through up/gate/down.

    With a tensor-parallel context whose expert leaves are this rank's
    E/M experts, the rank runs its own slice of the rows and the
    outputs are gathered over the expert axis."""
    tp = hooks.tensor_parallel()
    local = tp is not None and tp.is_sharded(params["up"])
    if local:
        El = params["up"].shape[0]
        buf = buf[tp.rank * El:(tp.rank + 1) * El]
    up = _expert_matmul(buf, params["up"], plan.get("up"), "ecd,edf->ecf")
    if gated:
        h = _act(act, _expert_matmul(buf, params["gate"], plan.get("gate"),
                                     "ecd,edf->ecf")) * up
    else:
        h = _act(act, up)
    y = _expert_matmul(h, params["down"], plan.get("down"), "ecf,efd->ecd")
    return tp.all_gather(y, dim=0) if local else y


def moe_forward(params, x, moe, act: str, gated: bool,
                capacity: Optional[int] = None,
                num_groups: Optional[int] = None,
                plan=None) -> MoEOutput:
    """x: (B, S, d) -> MoEOutput with y: (B, S, d).

    ``num_groups`` (default: ``hooks.moe_groups()``) dispatch groups
    over the B·S tokens, ``capacity`` (default: ``expert_capacity`` of a
    group's tokens) rows per expert and group.  ``plan`` (from
    ``models.plans.build_decode_plan``): per-projection tile plans —
    keys ``up``/``gate``/``down`` for the stacked expert tensors and
    ``shared`` for the shared-expert MLP.
    """
    B, S, d = x.shape
    T = B * S
    k, E = moe.top_k, moe.num_experts
    G = _num_groups(T, num_groups)
    Tg = T // G
    C = capacity if capacity is not None else expert_capacity(Tg, moe)
    dev = x.device

    xt = x.reshape(G, Tg, d)
    # the router product in the parameters' dtype, then f32
    logits = (xt @ params["router"]).float()                  # (G, Tg, E)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = _top_k(probs, k)                           # (G, Tg, k)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)

    # ---- aux load-balance loss (Switch/GShard form, global) ----
    density = torch.zeros((E,), dtype=torch.float32, device=dev).index_add_(
        0, top_e.reshape(-1), torch.ones(top_e.numel(), device=dev)) / T
    density_proxy = probs.reshape(T, E).mean(dim=0)
    aux = (density * density_proxy).sum() * E / k

    # ---- per-group sort-based capacity dispatch ----
    e_flat = top_e.reshape(G, Tg * k)
    w_flat = top_w.reshape(G, Tg * k)
    tok_flat = torch.arange(Tg, device=dev).repeat_interleave(k) \
        .expand(G, Tg * k)
    order = torch.argsort(e_flat, dim=-1, stable=True)       # (G, Tg·k)
    e_s = e_flat.gather(-1, order)
    tok_s = tok_flat.gather(-1, order)
    w_s = w_flat.gather(-1, order)
    # per-group expert counts from the sorted ids (no T×E one-hot)
    bounds = torch.arange(E + 1, device=dev).expand(G, E + 1).contiguous()
    cum = torch.searchsorted(e_s.contiguous(), bounds)        # (G, E+1)
    counts = cum[:, 1:] - cum[:, :-1]
    starts = cum[:, :-1]
    pos_in_e = torch.arange(Tg * k, device=dev)[None] - starts.gather(-1, e_s)
    keep = pos_in_e < C
    dest = torch.where(keep, e_s * C + pos_in_e, 0)
    # XLA's mean: the sum times the reciprocal of the count
    drop_fraction = 1.0 - keep.float().sum() * (1.0 / keep.numel())

    rows = xt.gather(1, tok_s[..., None].expand(G, Tg * k, d)) \
        * keep[..., None].to(x.dtype)
    # dropped pairs add zero rows into their group's slot 0, as the
    # reference's do
    goff = torch.arange(G, device=dev)[:, None]
    buf = torch.zeros((G * E * C, d), dtype=x.dtype, device=dev) \
        .index_add_(0, (goff * (E * C) + dest).reshape(-1),
                    rows.reshape(G * Tg * k, d))

    # ---- batched expert compute: (G, E, C, d) folded to (E, G·C, d) ----
    a = buf.reshape(G, E, C, d).transpose(0, 1).reshape(E, G * C, d)
    y = _experts(params, a, act, gated, plan or {})
    y_buf = y.reshape(E, G, C, d).transpose(0, 1).reshape(G, E * C, d)

    # ---- combine: scatter FROM the expert buffer INTO tokens ----
    # slot s = e·C + pos holds sorted pair index starts[e] + pos
    e_of_slot = torch.arange(E * C, device=dev) // C
    pos_of_slot = torch.arange(E * C, device=dev) % C
    src = (starts[:, e_of_slot] + pos_of_slot[None]).clamp_max(Tg * k - 1)
    valid = pos_of_slot[None] < counts[:, e_of_slot]          # (G, E·C)
    slot_tok = torch.where(valid, tok_s.gather(-1, src), Tg)
    slot_w = torch.where(valid, w_s.gather(-1, src), 0.0)
    contrib = (y_buf * slot_w[..., None].to(y_buf.dtype)).to(x.dtype)
    # each group's overflow row Tg takes its empty slots' zero rows
    out = torch.zeros((G * (Tg + 1), d), dtype=x.dtype, device=dev) \
        .index_add_(0, (goff * (Tg + 1) + slot_tok).reshape(-1),
                    contrib.reshape(G * E * C, d)) \
        .reshape(G, Tg + 1, d)[:, :Tg]

    if "shared" in params:
        out = out + mlp(params["shared"], xt, act,
                        plan=(plan or {}).get("shared"))
    return MoEOutput(out.reshape(B, S, d), aux, drop_fraction)
