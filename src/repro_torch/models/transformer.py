"""Decoder-only LM assembly: training forward, prefill and paged decode.

A port of ``repro.models.transformer`` for every decoder-only
architecture of the reference: global attention — GQA (llama-style) or
MLA — with a dense or MoE FFN (deepseek, llama4), sliding-window
attention and RG-LRU blocks (the ``hybrid`` family, recurrentgemma),
mLSTM and sLSTM blocks (the ``ssm`` family, xLSTM) and the vlm stub's
patch prefix (phi-3-vision: precomputed patch embeddings through
``patch_proj``, prepended to the text), under RMSNorm or LayerNorm.  A
model is a list of *segments*; within a segment the per-layer
parameters are stacked on a leading repeats axis, and the reference's
``lax.scan`` over it becomes a loop here.  Encoder-decoder configs run
through ``models.encdec``.

Entry points: ``forward``/``loss_fn`` (training, full-sequence logits),
``prefill``, ``decode_step`` (dense per-slot caches) and
``decode_step_paged`` (serving; global attention only — windowed and
recurrent layers decode on dense slots).  Prefill attends through the
flash attention kernel; the training forward through plain torch.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._bridge import (resolve_device, tree_index, tree_leaves,
                                 tree_map, tree_stack, tree_unbind)
from repro_torch.configs.base import (ATTN, LOCAL_ATTN, MLSTM, RGLRU, SLSTM,
                                      ArchConfig)
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import recurrent as rec_lib
from repro_torch.models.layers import (_act, _dtype, apply_norm, embed,
                                       embed_init, mlp, mlp_init, norm_init,
                                       softmax_cross_entropy, unembed, xavier)

# Activation rematerialisation for the training forward: each layer
# runs under torch.utils.checkpoint, so its internals are recomputed in
# the backward instead of stored (the reference's jax.checkpoint around
# each scanned block).  Policy "full" recomputes everything; "dots"
# saves the outputs of aten's matmul ops (the reference's
# checkpoint_dots saves dot_general outputs) and recomputes the rest —
# compute↓ memory↑.  The bsmm kernels are ctypes launches inside
# autograd Functions, which a dispatcher policy cannot see: their
# outputs are recomputed, as the reference recomputes its pallas_calls.
_REMAT_TRAIN = True
_REMAT_POLICY = "full"
_REMAT_POLICIES = ("full", "dots")


def set_remat(flag: bool, policy: str = "full"):
    global _REMAT_TRAIN, _REMAT_POLICY
    if policy not in _REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}; known: "
                         f"{_REMAT_POLICIES}")
    _REMAT_TRAIN = flag
    _REMAT_POLICY = policy


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of "dots": keep matmul outputs."""
    from torch.utils.checkpoint import CheckpointPolicy
    aten = torch.ops.aten
    if op in (aten.mm.default, aten.bmm.default, aten.addmm.default,
              aten.baddbmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _checkpoint_kwargs() -> dict:
    if _REMAT_POLICY != "dots":
        return {}
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    return {"context_fn":
            lambda: create_selective_checkpoint_contexts(_save_dots)}


def remat_enabled() -> bool:
    """Whether the training forward checkpoints each layer."""
    return _REMAT_TRAIN


_KINDS = {ATTN, LOCAL_ATTN, RGLRU, MLSTM, SLSTM}
# the block kinds followed by the FFN half (xLSTM blocks carry their own
# up and down projections)
_FFN_KINDS = (ATTN, LOCAL_ATTN, RGLRU)
_NORMS = ("rmsnorm", "layernorm")


def check_ported(cfg: ArchConfig) -> None:
    """Raise ``ValueError`` unless this module runs cfg: a decoder-only
    model (encoder-decoder configs run through ``models.encdec``) of the
    known block kinds under RMSNorm or LayerNorm."""
    kinds = set(cfg.blocks)
    if not kinds <= _KINDS:
        raise ValueError(f"unknown block kinds {sorted(kinds - _KINDS)}")
    if cfg.norm not in _NORMS:
        raise ValueError(f"unknown norm {cfg.norm!r}")
    if cfg.is_encoder_decoder:
        raise ValueError(f"{cfg.name} is an encoder-decoder config: it "
                         "runs through repro_torch.models.encdec")


# ---------------------------------------------------------------------------
# Segmentation
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Segment:
    sigs: Tuple[Tuple[str, bool], ...]   # per-position (kind, is_moe)
    reps: int                            # how many times the pattern repeats
    first_layer: int                     # absolute index of first layer


def layer_signature(cfg: ArchConfig, i: int) -> Tuple[str, bool]:
    kind = cfg.blocks[i]
    is_moe = (cfg.moe is not None and cfg.d_ff > 0 and kind in _FFN_KINDS
              and cfg.moe.is_moe_layer(i))
    return (kind, is_moe)


def segments_of(cfg: ArchConfig) -> List[Segment]:
    sigs = [layer_signature(cfg, i) for i in range(cfg.n_layers)]
    segs: List[Segment] = []
    if cfg.block_pattern is not None:
        P = len(cfg.block_pattern)
        if cfg.moe is not None:
            P = P * cfg.moe.moe_every // math.gcd(P, cfg.moe.moe_every)
        reps = cfg.n_layers // P
        if reps >= 1 and all(sigs[i] == sigs[i % P] for i in range(reps * P)):
            segs.append(Segment(tuple(sigs[:P]), reps, 0))
            start = reps * P
        else:
            start = 0
        for i in range(start, cfg.n_layers):
            segs.append(Segment((sigs[i],), 1, i))
        return segs
    i = 0
    while i < cfg.n_layers:
        j = i
        while j < cfg.n_layers and sigs[j] == sigs[i]:
            j += 1
        segs.append(Segment((sigs[i],), j - i, i))
        i = j
    return segs


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------
def _layer_init(gen, cfg: ArchConfig, sig, dtype, device):
    kind, is_moe = sig
    d = cfg.d_model
    p = {"norm1": norm_init(cfg.norm, d, dtype, device)}
    if kind == RGLRU:
        p["rnn"] = rec_lib.rglru_init(gen, d, cfg.rnn_width or d, cfg.n_heads,
                                      cfg.conv1d_width, dtype, device)
    elif kind == MLSTM:
        w = cfg.rnn_width or 2 * d
        p["rnn"] = {
            "cell": rec_lib.mlstm_cell_init(gen, w, cfg.n_heads, dtype,
                                            device),
            "up": xavier(gen, (d, w), dtype, device),
            "gate": xavier(gen, (d, w), dtype, device),
            "down": xavier(gen, (w, d), dtype, device),
        }
    elif kind == SLSTM:
        # the post-cell gated MLP: up d -> 4d (gate and value halves),
        # down 2d -> d
        p["rnn"] = {
            "cell": rec_lib.slstm_cell_init(gen, d, d, cfg.n_heads, dtype,
                                            device),
            "up": xavier(gen, (d, 4 * d), dtype, device),
            "down": xavier(gen, (2 * d, d), dtype, device),
        }
    elif cfg.mla is not None:
        p["attn"] = attn_lib.mla_init(gen, d, cfg.n_heads, cfg.mla, dtype,
                                      device)
    else:
        p["attn"] = attn_lib.gqa_init(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                      cfg.head_dim_, cfg.qkv_bias, dtype,
                                      device)
    if cfg.d_ff > 0 and kind in _FFN_KINDS:
        p["norm2"] = norm_init(cfg.norm, d, dtype, device)
        if is_moe:
            p["moe"] = moe_lib.moe_init(gen, d, cfg.moe, cfg.gated_mlp,
                                        dtype, device)
        else:
            p["mlp"] = mlp_init(gen, d, cfg.d_ff, cfg.gated_mlp,
                                cfg.mlp_bias, dtype, device)
    return p


def init_params(gen: torch.Generator, cfg: ArchConfig, *, device="cuda"):
    """Full parameter pytree (embed, stacked segments, final norm, head
    and, for the vlm stub, ``patch_proj``), keyed like the reference's,
    drawn from ``gen`` (a generator on ``device``)."""
    check_ported(cfg)
    dev = resolve_device(device)
    dtype = _dtype(cfg.dtype)
    seg_params = []
    for seg in segments_of(cfg):
        P = len(seg.sigs)
        pos_trees = []
        for pos in range(P):
            layers = [_layer_init(gen, cfg, seg.sigs[pos], dtype, dev)
                      for _ in range(seg.reps)]
            pos_trees.append(layers[0] if seg.reps == 1
                             else tree_stack(layers))
            del layers
        seg_params.append(pos_trees)
    params = {
        "embed": embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype, dev),
        "final_norm": norm_init(cfg.norm, cfg.d_model, dtype, dev),
        "segments": seg_params,
    }
    if not cfg.tie_embeddings:
        params["unembed"] = {
            "table": xavier(gen, (cfg.padded_vocab, cfg.d_model), dtype, dev,
                            in_axis=1, out_axis=0)}
    if cfg.num_patch_tokens:
        # the vlm stub: a learned projection of precomputed patch embeds
        params["patch_proj"] = xavier(gen, (cfg.d_model, cfg.d_model), dtype,
                                      dev)
    return params


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------
def _apply_block(cfg: ArchConfig, sig, p, x, mode: str, cache, capacity,
                 valid_len=None, plan=None, paged=None):
    """Returns (x, aux, new_cache) — aux the MoE layer's load-balance
    loss, None for a dense FFN.  ``sig`` is the layer's (kind, is_moe);
    ``mode`` is "forward" (training), "prefill" or "decode"; ``paged``
    (tables, lens) carries the paged decode's block tables, and decode
    without it runs over dense per-slot caches."""
    kind = sig[0]
    if valid_len is not None and (kind != ATTN or mode != "prefill"):
        raise ValueError(
            f"valid_len is only supported for full-attention prefill, "
            f"got kind={kind!r} mode={mode!r}; use exact-length prefill "
            "for windowed/recurrent blocks")
    plan = plan or {}
    h = apply_norm(cfg.norm, p["norm1"], x)
    new_cache = None
    if kind == RGLRU:
        if mode == "forward":
            out = rec_lib.rglru_forward(p["rnn"], h)
        elif mode == "prefill":
            out, new_cache = rec_lib.rglru_make_cache(p["rnn"], h)
        else:
            out, new_cache = rec_lib.rglru_step(p["rnn"], cache, h)
        return (*_apply_ffn(cfg, p, x + out, plan), new_cache)
    if kind == MLSTM:
        rp = p["rnn"]
        # the cell's heads are its block-diagonal q's blocks (the local
        # heads on a rank's shard: up/gate columns, down row-parallel)
        heads = rp["cell"]["wq"]["w"].shape[-3]
        tp = rec_lib._sharded(rp["down"])
        if tp is not None:
            h = tp.copy_in(h)
        u = h @ rp["up"]
        g = h @ rp["gate"]
        if mode == "decode":
            hc, new_cache = rec_lib.mlstm_step(rp["cell"], cache, u, heads)
        else:
            hc, st = rec_lib.mlstm_chunkwise(rp["cell"], u, heads)
            new_cache = st if mode == "prefill" else None
        out = (hc.to(x.dtype) * _act("silu", g)) @ rp["down"]
        return x + (out if tp is None else tp.all_reduce(out)), None, \
            new_cache
    if kind == SLSTM:
        rp = p["rnn"]
        if mode == "decode":
            hc, new_cache = rec_lib.slstm_step(rp["cell"], cache, h)
        else:
            hc, st = rec_lib.slstm_forward(rp["cell"], h)
            new_cache = st if mode == "prefill" else None
        tp = rec_lib._sharded(rp["cell"]["wi"])
        if tp is not None:          # the local heads' channels, gathered
            hc = tp.all_gather(hc, -1)
        y = hc.to(x.dtype) @ rp["up"]
        half = y.shape[-1] // 2
        out = (_act("gelu", y[..., :half]) * y[..., half:]) @ rp["down"]
        return x + out, None, new_cache
    if cfg.mla is not None:
        kw = dict(n_heads=cfg.n_heads, mla=cfg.mla, rope_theta=cfg.rope_theta)
        if mode == "forward":
            out = attn_lib.mla_forward(p["attn"], h, **kw)
        elif mode == "prefill":
            out, new_cache = attn_lib.mla_make_cache(
                p["attn"], h, capacity=capacity, valid_len=valid_len, **kw)
        elif paged is not None:
            out, new_cache = attn_lib.mla_paged_decode(
                p["attn"], cache, h, tables=paged[0], lens=paged[1], **kw)
        else:
            out, new_cache = attn_lib.mla_decode(p["attn"], cache, h, **kw)
        return (*_apply_ffn(cfg, p, x + out, plan), new_cache)
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
              head_dim=cfg.head_dim_, rope_theta=cfg.rope_theta)
    window = cfg.local_window if kind == LOCAL_ATTN else None
    if mode == "forward":
        out = attn_lib.gqa_forward(p["attn"], h, window=window,
                                   plan=plan.get("attn"), **kw)
    elif mode == "prefill":
        out, new_cache = attn_lib.gqa_make_cache(
            p["attn"], h, capacity=capacity, window=window,
            valid_len=valid_len, plan=plan.get("attn"), **kw)
    elif paged is not None:
        out, new_cache = attn_lib.gqa_paged_decode(
            p["attn"], cache, h, tables=paged[0], lens=paged[1],
            plan=plan.get("attn"), **kw)
    else:
        out, new_cache = attn_lib.gqa_decode(
            p["attn"], cache, h, window=window, plan=plan.get("attn"), **kw)
    return (*_apply_ffn(cfg, p, x + out, plan), new_cache)


def _apply_ffn(cfg: ArchConfig, p, x, plan):
    """The block's second half, dense MLP or MoE: (x, aux), aux the MoE
    load-balance loss (None for a dense FFN)."""
    if cfg.d_ff <= 0:
        return x, None
    h2 = apply_norm(cfg.norm, p["norm2"], x)
    if "moe" in p:
        mo = moe_lib.moe_forward(p["moe"], h2, cfg.moe, cfg.act,
                                 cfg.gated_mlp, plan=plan.get("moe"))
        return x + mo.y, mo.aux_loss
    return x + mlp(p["mlp"], h2, cfg.act, plan=plan.get("mlp")), None


def _run_segments(cfg, params, x, mode, caches, capacity, valid_len=None,
                  plan=None, paged=None):
    """Loop over segments and, inside each, over the stacked repeats
    (the reference's ``lax.scan``).  Per-repeat parameters and pools are
    views into the stacked tensors, so in-place pool writes land there;
    prefill caches are stacked back onto the repeats axis.  The training
    forward unbinds each stacked leaf once (see ``tree_unbind``) and,
    with remat on, checkpoints every layer.  Returns (x, caches, the sum
    of the MoE layers' aux losses, None without MoE)."""
    new_caches = []
    total_aux = None
    remat = _REMAT_TRAIN and mode == "forward"
    for s_idx, (seg, pos_trees) in enumerate(zip(segments_of(cfg),
                                                 params["segments"])):
        seg_caches = caches[s_idx] if caches is not None else None
        seg_plan = plan[s_idx] if plan is not None else None
        unbound = (tree_unbind(pos_trees, seg.reps)
                   if mode == "forward" and seg.reps > 1 else None)
        per_rep = []
        for r in range(seg.reps):
            c_outs = []
            for pos in range(len(seg.sigs)):
                ptree = pos_trees[pos]
                c = seg_caches[pos] if seg_caches is not None else None
                if unbound is not None:
                    ptree = unbound[r][pos]
                elif seg.reps > 1:
                    ptree = tree_index(ptree, r)
                    c = tree_index(c, r) if c is not None else None
                pe = seg_plan[pos] if seg_plan is not None else None
                sig = seg.sigs[pos]
                if remat:
                    x, aux = checkpoint(_forward_block, cfg, sig, ptree, x,
                                        pe, use_reentrant=False,
                                        preserve_rng_state=False,
                                        **_checkpoint_kwargs())
                    c_new = None
                else:
                    x, aux, c_new = _apply_block(
                        cfg, sig, ptree, x, mode, c, capacity,
                        valid_len=valid_len, plan=pe, paged=paged)
                if aux is not None:
                    total_aux = aux if total_aux is None else total_aux + aux
                c_outs.append(c_new)
            per_rep.append(c_outs)
        if mode == "forward":
            continue
        if seg.reps == 1:
            new_caches.append(per_rep[0])
        elif mode == "prefill":
            new_caches.append(tree_stack(per_rep))
        else:                      # pools and caches were written in place
            new_caches.append(seg_caches)
    return x, (None if mode == "forward" else new_caches), total_aux


def _forward_block(cfg, sig, p, x, plan):
    """One training layer: (x, aux), what ``checkpoint`` recomputes."""
    return _apply_block(cfg, sig, p, x, "forward", None, None,
                        plan=plan)[:2]


def _embed_inputs(cfg: ArchConfig, params, batch):
    """The token embeddings, after the projected patch embeddings
    (``batch["patches"]`` (B, P, d)) where a vlm batch carries them."""
    x = embed(params["embed"], batch["tokens"])
    if cfg.num_patch_tokens and "patches" in batch:
        patches = batch["patches"].to(x.dtype) @ params["patch_proj"]
        x = torch.cat([patches, x], dim=1)
    return x


def forward(params, cfg: ArchConfig, batch, plan=None):
    """Training forward: full-sequence logits (B, S, V) and the sum of
    the MoE layers' aux losses (an f32 scalar, 0 without MoE).
    ``batch["tokens"]``: (B, S) integers, and for a vlm config
    optionally ``batch["patches"]`` (B, P, d_model), prepended (the
    logits then cover P + S positions).  ``plan`` (from
    ``train.plans.lm_train_plan``) routes the attention, MLP and expert
    projections through the block-sparse kernels, forward and backward
    (MLA's projections run dense, as the reference's do)."""
    check_ported(cfg)
    x = _embed_inputs(cfg, params, batch)
    x, _, aux = _run_segments(cfg, params, x, "forward", None, None,
                              plan=plan)
    x = apply_norm(cfg.norm, params["final_norm"], x)
    head = params.get("unembed", params["embed"])
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return unembed(head, x), aux


def loss_fn(params, cfg: ArchConfig, batch, aux_weight: float = 0.01,
            plan=None, count=None):
    """Mean next-token cross-entropy (over ``batch["loss_mask"]`` when
    given; with patches, over the text tail only) plus ``aux_weight`` ×
    the aux loss → (loss, metrics).  ``count`` divides the token-loss sum
    instead of this batch's own count (``softmax_cross_entropy``)."""
    logits, aux = forward(params, cfg, batch, plan=plan)
    labels = batch["labels"]
    if cfg.num_patch_tokens and "patches" in batch:
        logits = logits[:, -labels.shape[1]:]
    ce = softmax_cross_entropy(logits, labels, batch.get("loss_mask"),
                               count=count)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


def supports_masked_prefill(cfg: ArchConfig) -> bool:
    """True when ``prefill`` takes a per-row ``valid_len`` (every block
    global attention with a dense FFN, no patch prefix).  MoE routing
    computes expert capacity over all positions (pad tokens would shift
    which real tokens are dropped), so MoE prefills at exact length."""
    return (set(cfg.blocks) == {ATTN} and not cfg.num_patch_tokens
            and cfg.moe is None and not cfg.is_encoder_decoder)


def prefill(params, cfg: ArchConfig, batch, capacity: int, valid_len=None,
            plan=None):
    """Full-sequence prefill → (last-position logits (B,1,V), caches).

    With ``valid_len`` (B,) the tokens are right-padded and the logits
    are taken at each row's last valid position.  ``plan`` (from
    ``models.plans.build_decode_plan``) routes the attention and MLP
    projections through the block-sparse kernel.
    """
    check_ported(cfg)
    x = _embed_inputs(cfg, params, batch)
    none_caches = [[None for _ in seg.sigs] for seg in segments_of(cfg)]
    x, caches, _ = _run_segments(cfg, params, x, "prefill", none_caches,
                                 capacity, valid_len=valid_len, plan=plan)
    if valid_len is None:
        x_last = x[:, -1:]
    else:
        last = torch.as_tensor(valid_len, device=x.device).long() - 1
        x_last = x[torch.arange(x.shape[0], device=x.device), last][:, None]
    x_last = apply_norm(cfg.norm, params["final_norm"], x_last)
    head = params.get("unembed", params["embed"])
    return unembed(head, x_last), caches


def decode_step(params, cfg: ArchConfig, caches, token, plan=None):
    """Dense-slot decode step: token (B, 1) → (logits (B,1,V), caches).

    ``caches`` are prefill caches (or the engine's slot caches built
    from them): each layer writes the new token's K/V (or MLA latents)
    at its cache index and attends over the valid rows, IN PLACE.
    ``plan`` routes the projections through the block-sparse kernel."""
    check_ported(cfg)
    x = embed(params["embed"], token)
    x, caches, _ = _run_segments(cfg, params, x, "decode", caches, None,
                                 plan=plan)
    x = apply_norm(cfg.norm, params["final_norm"], x)
    head = params.get("unembed", params["embed"])
    return unembed(head, x), caches


def _block_cache_spec(cfg: ArchConfig, sig, batch: int, capacity: int,
                      dtype, rnn=None):
    """One layer's decode state: a KV (or MLA latent) cache of
    ``capacity`` rows, a window's ring of ``min(window, capacity)``
    rows, or an RG-LRU, mLSTM or sLSTM state (at the widths of the
    layer's ``rnn`` parameters where given: a rank's local ones)."""
    kind = sig[0]
    if kind == RGLRU:
        w = (rnn["w_in"].shape[-1] if rnn is not None
             else cfg.rnn_width or cfg.d_model)
        return rec_lib.rglru_state_spec(batch, w, cfg.conv1d_width, dtype)
    if kind == MLSTM:
        if rnn is not None:
            w, heads = rnn["up"].shape[-1], rnn["cell"]["wq"]["w"].shape[-3]
        else:
            w, heads = cfg.rnn_width or 2 * cfg.d_model, cfg.n_heads
        return rec_lib.mlstm_state_spec(batch, heads, w // heads)
    if kind == SLSTM:
        return rec_lib.slstm_state_spec(
            batch, rnn["cell"]["wi"].shape[-1] if rnn is not None
            else cfg.d_model)
    cap = capacity if kind == ATTN else min(cfg.local_window, capacity)
    if cfg.mla is not None:
        meta = dict(dtype=dtype, device="meta")
        return attn_lib.MLACache(
            torch.empty((batch, cap, cfg.mla.kv_lora_rank), **meta),
            torch.empty((batch, cap, cfg.mla.qk_rope_head_dim), **meta),
            torch.empty((), dtype=torch.int32, device="meta"))
    return attn_lib.gqa_cache_spec(batch, cap, cfg.n_kv_heads,
                                   cfg.head_dim_, dtype)


def cache_spec(cfg: ArchConfig, batch: int, capacity: int, params=None):
    """Meta-tensor pytree of the decode caches, mirroring
    params['segments'] (a leading reps axis on stacked segments): what
    ``prefill`` returns for a batch of ``batch`` at ``capacity``.  A
    recurrent state takes its widths from ``params`` where given (a
    rank's shards on a mesh)."""
    check_ported(cfg)
    dtype = _dtype(cfg.dtype)
    out = []
    for s_idx, seg in enumerate(segments_of(cfg)):
        pos_specs = []
        for pos, sig in enumerate(seg.sigs):
            rnn = (params["segments"][s_idx][pos].get("rnn")
                   if params is not None else None)
            s = _block_cache_spec(cfg, sig, batch, capacity, dtype, rnn)
            if seg.reps > 1:
                s = type(s)(*(t.expand(seg.reps, *t.shape) for t in s))
            pos_specs.append(s)
        out.append(pos_specs)
    return out


def cache_batch_axes(cfg: ArchConfig, caches):
    """Pytree of ints matching ``caches``: the batch axis of each leaf
    (1 in a stacked segment, whose leaves lead with the repeats axis, 0
    otherwise).  A scalar cache index has no batch axis yet (its ndim
    equals the axis); the engine appends one when it builds slot
    caches."""
    segs = segments_of(cfg)
    if len(segs) != len(caches):
        raise ValueError(f"cache structure has {len(caches)} segments, "
                         f"config implies {len(segs)}")
    return [tree_map(lambda _, a=1 if seg.reps > 1 else 0: a, seg_c)
            for seg, seg_c in zip(segs, caches)]


# ---------------------------------------------------------------------------
# Paged decode: shared block pools instead of per-slot dense caches
# ---------------------------------------------------------------------------
def supports_paged_decode(cfg: ArchConfig) -> bool:
    """True when ``decode_step_paged`` covers this architecture (every
    block global attention — GQA or MLA — not encoder-decoder)."""
    return set(cfg.blocks) == {ATTN} and not cfg.is_encoder_decoder


def paged_cache_spec(cfg: ArchConfig, num_blocks: int):
    """Meta-tensor pytree mirroring params['segments']: one block pool
    per attention layer (a ``PagedKVCache`` for GQA, a
    ``PagedLatentCache`` for MLA), a leading reps axis on stacked
    segments."""
    check_ported(cfg)
    dtype = _dtype(cfg.dtype)
    out = []
    for seg in segments_of(cfg):
        pos_specs = []
        for _sig in seg.sigs:
            if cfg.mla is not None:
                s = attn_lib.mla_paged_spec(num_blocks, cfg.mla, dtype)
            else:
                s = attn_lib.gqa_paged_spec(num_blocks, cfg.n_kv_heads,
                                            cfg.head_dim_, dtype)
            if seg.reps > 1:
                s = type(s)(*(t.expand(seg.reps, *t.shape) for t in s))
            pos_specs.append(s)
        out.append(pos_specs)
    return out


def make_paged_caches(cfg: ArchConfig, num_blocks: int, *, device):
    """Zero-initialised block pools (see ``paged_cache_spec``)."""
    dev = resolve_device(device)
    return [[type(spec)(*(torch.zeros(t.shape, dtype=t.dtype, device=dev)
                          for t in spec))
             for spec in seg] for seg in paged_cache_spec(cfg, num_blocks)]


def paged_cache_bytes(spec) -> int:
    """Bytes of every pool in a ``paged_cache_spec``."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(spec))


def adopt_prefill(cfg: ArchConfig, paged_caches, dense_caches, blocks):
    """Scatter one request's dense prefill caches (B=1, capacity == the
    padded prefill length S) into pool blocks, IN PLACE.  ``blocks``:
    ⌈S/BLOCK⌉ physical ids in logical order (ids past the real length
    may be the scratch block).  Returns ``paged_caches``."""
    segs = segments_of(cfg)
    if len(segs) != len(paged_caches) or len(segs) != len(dense_caches):
        raise ValueError("cache structure does not match config segments")
    adopt = (attn_lib.mla_paged_adopt if cfg.mla is not None
             else attn_lib.gqa_paged_adopt)
    for seg_p, seg_d in zip(paged_caches, dense_caches):
        for pc, dc in zip(seg_p, seg_d):
            # a stacked segment's leading reps axis rides along in the
            # adopt's ellipsis indexing
            adopt(pc, dc, blocks)
    return paged_caches


def decode_step_paged(params, cfg: ArchConfig, caches, token, tables, lens,
                      plan=None):
    """Paged decode step: token (B,1), ``tables`` (B, NB) and ``lens``
    (B,) int32 tensors → (logits (B,1,V), pools).  Each layer appends
    the new token's KV at ``tables[b, lens[b] // BLOCK]`` (in place) and
    attends over ``lens[b] + 1`` tokens through the paged kernel."""
    check_ported(cfg)
    x = embed(params["embed"], token)
    x, caches, _ = _run_segments(cfg, params, x, "decode", caches, None,
                                 plan=plan, paged=(tables, lens))
    x = apply_norm(cfg.norm, params["final_norm"], x)
    head = params.get("unembed", params["embed"])
    return unembed(head, x), caches
