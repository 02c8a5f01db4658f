"""Attention: grouped-query (GQA) and DeepSeek-style MLA — prefill, KV
caches, dense-slot decode and paged decode.

A port of ``repro.models.attention``: ``attend`` and
``causal_attention`` are plain torch with the reference's finite
``-1e30`` mask (scores and softmax in float32, outputs in the compute
dtype), as the reference's training attention is plain jnp; the
training forwards (``gqa_forward``, ``mla_forward``) use them.  Serving
prefill (``gqa_make_cache``, ``mla_make_cache``) attends through the
flash attention kernel (``kernels.flash_attention``, kernel #8), which
the reference wrote for its long-prefill cells.  Dense-slot decode
(``gqa_decode``, ``mla_decode``) is plain torch over per-slot caches,
as in the reference; paged decode reads the block pool through the CUDA
paged attention kernel — the GQA form for GQA, the fused-V form for
MLA's latent pool (absorbed decode: scores and values in the latent
space).

Sliding windows (the ``hybrid`` family's local attention): the training
forward runs the reference's two-chunk form (``sliding_window_attention``,
plain causal attention up to one window); a windowed prefill attends
through kernel #8 up to one window and through the two-chunk form past
it, as the reference computes it outside any Pallas kernel.  A windowed
layer's cache is a ring of ``min(window, capacity)`` rows: the token at
position p lives at row ``p % rows``, in prefill and in decode.  The
reference writes its prefill keys from row 0 and decodes at ``p %
capacity`` over ``min(p + 1, capacity)`` rows, which agrees with this
ring wherever ``capacity <= window`` and attends to the wrong keys past
it; the port follows the reference's own ``forward`` there.

On a mesh's model axis a rank whose projections are its shards attends
its local heads (GQA's q and K/V groups, MLA's heads over the whole
latent) and sums the output projection over the axis (``_out_proj``).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import bsmm
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import BLOCK_TOKENS, paged_attention
from repro_torch.models import hooks
from repro_torch.models.layers import apply_rope, rmsnorm, rmsnorm_init, xavier


def gqa_init(gen, d_model: int, n_heads: int, n_kv_heads: int, head_dim: int,
             qkv_bias: bool, dtype, device):
    p = {
        "wq": xavier(gen, (d_model, n_heads * head_dim), dtype, device),
        "wk": xavier(gen, (d_model, n_kv_heads * head_dim), dtype, device),
        "wv": xavier(gen, (d_model, n_kv_heads * head_dim), dtype, device),
        "wo": xavier(gen, (n_heads * head_dim, d_model), dtype, device),
    }
    if qkv_bias:
        p["bq"] = torch.zeros((n_heads * head_dim,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((n_kv_heads * head_dim,), dtype=dtype,
                              device=device)
        p["bv"] = torch.zeros((n_kv_heads * head_dim,), dtype=dtype,
                              device=device)
    return p


def attend(q, k, v, *, causal: bool, q_offset: int,
           scale: Optional[float] = None, kv_valid_len=None):
    """Exact attention for one query block against full keys.

    q: (B,Sq,Hq,hd)  k,v: (B,Sk,Hkv,hd).  ``kv_valid_len``: mask keys at
    or past this length — an int, or a (B,) tensor per row.
    """
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(B, Sq, Hkv, G, hd).float()
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    kpos = torch.arange(Sk, device=q.device)
    qpos = q_offset + torch.arange(Sq, device=q.device)
    mask = torch.ones((1, Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos[None, :] <= qpos[:, None])
    if kv_valid_len is not None:
        kvl = torch.as_tensor(kv_valid_len, device=q.device)
        if kvl.ndim == 0:
            mask = mask & (kpos < kvl)[None, None, :]
        else:
            mask = mask & (kpos[None, :] < kvl[:, None])[:, None, :]
    scores = torch.where(mask[:, None, None], scores, -1e30)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v.float())
    return out.reshape(B, Sq, Hq, v.shape[-1]).to(q.dtype)


def causal_attention(q, k, v, *, block_q: int = 512, q_offset: int = 0):
    """Causal self-attention in query blocks of ``block_q`` (exact; only
    one block's score matrix is live at a time)."""
    S = q.shape[1]
    if S <= block_q:
        return attend(q, k, v, causal=True, q_offset=q_offset)
    if S % block_q:
        raise ValueError(f"S={S} must be a multiple of block_q={block_q}")
    outs = [attend(q[:, i:i + block_q], k, v, causal=True,
                   q_offset=q_offset + i)
            for i in range(0, S, block_q)]
    return torch.cat(outs, dim=1)


def sliding_window_attention(q, k, v, *, window: int, q_offset: int = 0):
    """Exact sliding-window causal attention: token i sees keys in
    (i - window, i].  Plain causal attention when S <= window; past it
    the reference's two-chunk trick, which needs S % window == 0: each
    query chunk of ``window`` rows attends to its own key chunk and the
    one before (the first chunk's predecessor fully masked) under a
    relative-position mask.  Scores and softmax in float32, the output
    in q's dtype."""
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    if S <= window:
        return causal_attention(q, k, v, q_offset=q_offset)
    if S % window:
        raise ValueError(f"sliding-window attention over S={S} > window="
                         f"{window} needs S % window == 0")
    W, G = window, Hq // Hkv
    scale = 1.0 / math.sqrt(hd)
    qpos = torch.arange(W, device=q.device)
    kpos = torch.arange(-W, W, device=q.device)       # previous, own chunk
    d = qpos[:, None] - kpos[None, :]
    mask = (d >= 0) & (d < W)                         # (W, 2W)
    first = mask & (kpos >= 0)[None, :]
    kf, vf = k.float(), v.float()
    outs = []
    for c in range(S // W):
        lo = max(c - 1, 0) * W
        kc, vc = kf[:, lo:(c + 1) * W], vf[:, lo:(c + 1) * W]
        if c == 0:                   # the zero chunk before the first one
            kc = torch.cat([torch.zeros_like(kc), kc], dim=1)
            vc = torch.cat([torch.zeros_like(vc), vc], dim=1)
        qg = q[:, c * W:(c + 1) * W].float().reshape(B, W, Hkv, G, hd)
        sc = torch.einsum("bqkgd,bskd->bkgqs", qg, kc) * scale
        sc = torch.where(first if c == 0 else mask, sc, -1e30)
        w = torch.softmax(sc, dim=-1)
        o = torch.einsum("bkgqs,bskd->bqkgd", w, vc)
        outs.append(o.reshape(B, W, Hq, v.shape[-1]).to(q.dtype))
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# Prefill with a dense KV cache
# ---------------------------------------------------------------------------
class KVCache(NamedTuple):
    k: torch.Tensor          # (B, C, Hkv, hd)
    v: torch.Tensor          # (B, C, Hkv, hd)
    index: torch.Tensor      # () or (B,) int32 — tokens already written


def gqa_cache_spec(batch: int, capacity: int, n_kv_heads: int,
                   head_dim: int, dtype) -> KVCache:
    """Shape/dtype of one layer's dense cache, as meta tensors."""
    kv = torch.empty((batch, capacity, n_kv_heads, head_dim), dtype=dtype,
                     device="meta")
    return KVCache(k=kv, v=kv, index=torch.empty((), dtype=torch.int32,
                                                 device="meta"))


def _tensor_parallel(params):
    """The tensor-parallel context when this attention's projections are
    this rank's shards (its heads are the local ones), else None."""
    tp = hooks.tensor_parallel()
    return tp if tp is not None and tp.is_sharded(params["wo"]) else None


def _kv_whole(params):
    """The tensor-parallel context when this rank's q heads are local
    but K/V are kept whole (all kv heads on every model rank), else
    None: such a rank attends all Hq heads, its own among zeros."""
    tp = _tensor_parallel(params)
    return tp if tp is not None and not tp.is_sharded(params["wk"]) else None


def _attend_local(params, q, fn):
    """``fn(q)``'s attention over this rank's q heads (dim -2); with K/V
    kept whole, through all heads (``TensorParallel.pad_heads``), the
    local heads' outputs taken back."""
    tp = _kv_whole(params)
    if tp is None:
        return fn(q)
    return tp.local_heads(fn(tp.pad_heads(q)), q.shape[-2])


def _out_proj(params, out, plan):
    """The output projection of the attended heads: row-parallel (summed
    over the model axis) on a rank's shard."""
    tp = _tensor_parallel(params)
    mm = bsmm.plan_matmul if tp is None else tp.row
    return mm(out, params["wo"], (plan or {}).get("wo"))


def gqa_qkv(params, x, *, n_heads, n_kv_heads, head_dim, positions,
            rope_theta, plan=None):
    B, S, _ = x.shape
    plan = plan or {}
    tp = _tensor_parallel(params)
    kv_whole = tp is not None and not tp.is_sharded(params["wk"])
    xq = x if tp is None else tp.copy_in(x)
    xkv = x if kv_whole else xq
    q = bsmm.plan_matmul(xq, params["wq"], plan.get("wq"))
    k = bsmm.plan_matmul(xkv, params["wk"], plan.get("wk"))
    v = bsmm.plan_matmul(xkv, params["wv"], plan.get("wv"))
    if "bq" in params:
        bq, bk, bv = params["bq"], params["bk"], params["bv"]
        if tp is not None:          # replicated biases: the local heads'
            bq = tp.cols(tp.copy_in(bq))
            if not kv_whole:
                bk, bv = tp.cols(tp.copy_in(bk)), tp.cols(tp.copy_in(bv))
        q, k, v = q + bq, k + bk, v + bv
    if kv_whole:                    # every rank's heads read all of K/V
        k, v = tp.copy_in(k), tp.copy_in(v)
    q = q.reshape(B, S, n_heads, head_dim)
    k = k.reshape(B, S, n_kv_heads, head_dim)
    v = v.reshape(B, S, n_kv_heads, head_dim)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    return q, k, v


def gqa_forward(params, x, *, n_heads, n_kv_heads, head_dim, rope_theta,
                window: Optional[int] = None, block_q: int = 512,
                plan=None):
    """Training self-attention over a full sequence → projected output.

    ``window`` makes it sliding-window attention.  ``plan`` routes the
    q/k/v/o projections through the differentiable block-sparse product,
    so the retrain backward skips dead tiles too.
    """
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = gqa_qkv(params, x, n_heads=n_heads, n_kv_heads=n_kv_heads,
                      head_dim=head_dim, positions=positions,
                      rope_theta=rope_theta, plan=plan)
    if window is not None:
        out = _attend_local(params, q, lambda q: sliding_window_attention(
            q, k, v, window=window))
    else:
        out = _attend_local(params, q, lambda q: causal_attention(
            q, k, v, block_q=block_q))
    return _out_proj(params, out.reshape(B, S, n_heads * head_dim), plan)


def gqa_make_cache(params, x, *, n_heads, n_kv_heads, head_dim, rope_theta,
                   capacity: int, window: Optional[int] = None,
                   valid_len=None, plan=None):
    """Prefill: returns (attn_out_projected, KVCache).

    ``valid_len`` (B,) marks right-padded rows: the cache index starts
    at ``valid_len`` instead of S, and decode masks the pad keys above
    it.  With ``window`` the cache is a ring of ``min(window,
    capacity)`` rows holding the last of them at row ``position %
    rows``; attention runs through the flash kernel up to one window and
    the two-chunk form past it.  ``plan`` routes q/k/v/o through the
    block-sparse kernel.
    """
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = gqa_qkv(params, x, n_heads=n_heads, n_kv_heads=n_kv_heads,
                      head_dim=head_dim, positions=positions,
                      rope_theta=rope_theta, plan=plan)
    if valid_len is not None and (window is not None or S > capacity):
        raise ValueError("valid_len prefill needs full attention with "
                         f"S <= capacity, got S={S}, capacity={capacity}, "
                         f"window={window}")
    if window is not None and S > window:
        out = _attend_local(params, q, lambda q: sliding_window_attention(
            q, k, v, window=window))
    else:
        out = _attend_local(params, q, lambda q: flash_attention(
            q, k, v, causal=True))
    rows = capacity if window is None else min(window, capacity)
    keep = min(S, rows)
    kc = k.new_zeros((B, rows, *k.shape[2:]))
    vc = torch.zeros_like(kc)
    if window is None:                   # the last keep keys from row 0
        at = slice(0, keep)
    else:                                # each at row position % rows
        at = torch.arange(S - keep, S, device=x.device) % rows
    kc[:, at] = k[:, S - keep:]
    vc[:, at] = v[:, S - keep:]
    proj = _out_proj(params, out.reshape(B, S, n_heads * head_dim), plan)
    return proj, KVCache(kc, vc, _cache_index(valid_len, B, S, x.device))


def _cache_index(valid_len, B: int, S: int, device):
    """A prefill cache's index: S, or the (B,) valid lengths — a tensor
    of its own, since dense-slot decode advances it in place."""
    if valid_len is None:
        return torch.tensor(S, dtype=torch.int32, device=device)
    return torch.as_tensor(valid_len, device=device).to(
        torch.int32).reshape(B).clone()


def _decode_positions(index, B: int, capacity: int, ring: bool = False):
    """Dense-slot decode bookkeeping for cache index ``index`` (a scalar
    for a batch in lockstep, or (B,) per slot): the new token's rope
    positions (B, 1), the cache row it is written to (``ring``: position
    % capacity; else clamped to the last row past capacity, as the
    reference) and the valid lengths after the write."""
    pos = index.long()
    positions = pos[:, None] if pos.ndim == 1 else pos.expand(B, 1)
    slot = pos % capacity if ring else pos.clamp(max=capacity - 1)
    valid = (pos + 1).clamp(max=capacity)
    return positions, slot, valid


def _write_row(cache_t, slot, new):
    """cache_t (B, C, ...) row ``slot`` (scalar or per row (B,)) ←
    new (B, 1, ...), in place."""
    if slot.ndim == 1:
        cache_t[torch.arange(cache_t.shape[0], device=cache_t.device),
                slot] = new[:, 0]
    else:
        cache_t.index_copy_(1, slot.reshape(1), new)


def gqa_decode(params, cache: KVCache, x, *, n_heads, n_kv_heads, head_dim,
               rope_theta, window: Optional[int] = None, plan=None):
    """One dense-slot decode step.  x: (B, 1, d).

    ``cache.index`` is a scalar (the batch in lockstep) or (B,) (every
    slot at its own position); the new token's K/V go to that row of the
    cache (with ``window``, row ``position % rows`` of the ring) and
    attention runs over the valid rows of each slot (plain torch
    ``attend``, as the reference).  The cache's K, V and index are
    updated IN PLACE (the reference returns new arrays); ``plan`` routes
    q/k/v/o through the block-sparse kernel.
    """
    B, S, _ = x.shape
    if S != 1:
        raise ValueError(f"decode takes one token per row, got S={S}")
    positions, slot, valid = _decode_positions(
        cache.index, B, cache.k.shape[1], ring=window is not None)
    q, k, v = gqa_qkv(params, x, n_heads=n_heads, n_kv_heads=n_kv_heads,
                      head_dim=head_dim, positions=positions,
                      rope_theta=rope_theta, plan=plan)
    _write_row(cache.k, slot, k)
    _write_row(cache.v, slot, v)
    out = _attend_local(params, q, lambda q: attend(
        q, cache.k, cache.v, causal=False, q_offset=0, kv_valid_len=valid))
    cache.index.add_(1)
    proj = _out_proj(params, out.reshape(B, 1, n_heads * head_dim), plan)
    return proj, cache


# ---------------------------------------------------------------------------
# Paged KV cache: shared block pool + per-sequence block tables
# ---------------------------------------------------------------------------
class PagedKVCache(NamedTuple):
    """Pool-resident KV state for one attention layer; the engine owns
    the block tables and lengths and passes them into every call."""
    k_pool: torch.Tensor     # (P, BLOCK_TOKENS, Hkv, hd)
    v_pool: torch.Tensor     # (P, BLOCK_TOKENS, Hkv, hd)


def gqa_paged_spec(num_blocks: int, n_kv_heads: int, head_dim: int, dtype,
                   block: int = BLOCK_TOKENS) -> PagedKVCache:
    """Shape/dtype of one layer's pools, as meta tensors (no storage)."""
    spec = torch.empty((num_blocks, block, n_kv_heads, head_dim), dtype=dtype,
                       device="meta")
    return PagedKVCache(k_pool=spec, v_pool=spec)


def gqa_paged_adopt(paged: PagedKVCache, cache: KVCache, blocks):
    """Scatter one request's dense prefill cache into pool blocks.

    ``cache.k`` is (..., 1, S, Hkv, hd) and the pools (..., P, T, Hkv,
    hd), the same leading axes on both (a stacked segment's repeats);
    ``blocks`` lists ⌈S/T⌉ physical ids in logical order, ids past the
    real length being the scratch block.  Writes the pools IN PLACE
    (unlike the reference's functional update) and returns them.
    """
    kp, vp = paged.k_pool, paged.v_pool
    S = cache.k.shape[-3]
    T = kp.shape[-3]
    nb = len(blocks)
    if nb != -(-S // T):
        raise ValueError(f"adopt needs ceil({S}/{T}) block ids, got {nb}")
    for i, pid in enumerate(blocks):
        w = min(T, S - i * T)
        kp[..., int(pid), :w, :, :] = cache.k[..., 0, i * T:i * T + w, :, :]
        vp[..., int(pid), :w, :, :] = cache.v[..., 0, i * T:i * T + w, :, :]
    return paged


def gqa_paged_decode(params, cache: PagedKVCache, x, *, n_heads, n_kv_heads,
                     head_dim, rope_theta, tables, lens, plan=None):
    """One paged decode step.  x: (B, 1, d).

    ``tables`` (B, NB) int32 and ``lens`` (B,) int32 tensors: the new
    token lands at logical position ``lens[b]`` (its block must already
    be allocated; idle rows point at the scratch block) and attention
    runs over ``lens + 1`` tokens.  The pools are written IN PLACE.
    """
    B, S, _ = x.shape
    if S != 1:
        raise ValueError(f"paged decode takes one token per row, got S={S}")
    pos = lens.long()
    q, k, v = gqa_qkv(params, x, n_heads=n_heads, n_kv_heads=n_kv_heads,
                      head_dim=head_dim, positions=pos[:, None],
                      rope_theta=rope_theta, plan=plan)
    T = cache.k_pool.shape[1]
    blk = tables[torch.arange(B, device=x.device), pos // T].long()
    off = pos % T
    cache.k_pool[blk, off] = k[:, 0]
    cache.v_pool[blk, off] = v[:, 0]
    out = _attend_local(params, q[:, 0], lambda q: paged_attention(
        q.contiguous(), cache.k_pool, cache.v_pool, tables,
        (lens + 1).to(torch.int32), scale=1.0 / math.sqrt(head_dim)))
    proj = _out_proj(params, out.reshape(B, 1, n_heads * head_dim), plan)
    return proj, cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek multi-head latent attention)
# ---------------------------------------------------------------------------
def mla_init(gen, d_model: int, n_heads: int, mla, dtype, device):
    dn, dr, dv = mla.qk_nope_head_dim, mla.qk_rope_head_dim, mla.v_head_dim
    r = mla.kv_lora_rank
    return {
        "w_dq": xavier(gen, (d_model, mla.q_lora_rank), dtype, device),
        "q_norm": rmsnorm_init(mla.q_lora_rank, dtype, device),
        "w_uq": xavier(gen, (mla.q_lora_rank, n_heads * (dn + dr)), dtype,
                       device),
        "w_dkv": xavier(gen, (d_model, r + dr), dtype, device),
        "kv_norm": rmsnorm_init(r, dtype, device),
        "w_uk": xavier(gen, (r, n_heads * dn), dtype, device),
        "w_uv": xavier(gen, (r, n_heads * dv), dtype, device),
        "wo": xavier(gen, (n_heads * dv, d_model), dtype, device),
    }


class MLACache(NamedTuple):
    c_kv: torch.Tensor       # (B, C, kv_lora_rank)
    k_rope: torch.Tensor     # (B, C, qk_rope_head_dim)
    index: Optional[torch.Tensor]


def _mla_qkv_latent(params, x, mla, n_heads, rope_theta, positions):
    """Shared front end: per-head q (nope, rope), latent c_kv and the
    shared k_rope.  The MLA projections run dense: the reference builds
    no tile plan for them.  On a rank's head shard the down-projections
    and their norms run whole (every local head reads the latents) and
    ``w_uq`` makes the local heads."""
    B, S, _ = x.shape
    dn, dr = mla.qk_nope_head_dim, mla.qk_rope_head_dim
    r = mla.kv_lora_rank
    tp = _tensor_parallel(params)
    cq = rmsnorm(params["q_norm"], x @ params["w_dq"])
    if tp is not None:              # every local head reads all of it
        cq = tp.copy_in(cq)
    q = (cq @ params["w_uq"]).reshape(B, S, n_heads, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, rope_theta)
    dkv = x @ params["w_dkv"]                       # (B, S, r + dr)
    c_kv = rmsnorm(params["kv_norm"], dkv[..., :r])
    k_rope = apply_rope(dkv[..., r:][:, :, None, :], positions,
                        rope_theta)[:, :, 0, :]     # one shared rope head
    if tp is not None:
        c_kv, k_rope = tp.copy_in(c_kv), tp.copy_in(k_rope)
    return q_nope, q_rope, c_kv, k_rope


def _mla_attend(params, q_nope, q_rope, c_kv, k_rope, *, n_heads, mla,
                block_q: int, flash: bool):
    """Expand the latents to per-head K/V and attend causally: through
    the flash kernel (serving prefill, ``flash=True``) or the plain
    ``causal_attention`` (the training forward)."""
    B, S = c_kv.shape[:2]
    dn, dr, dv = mla.qk_nope_head_dim, mla.qk_rope_head_dim, mla.v_head_dim
    k_nope = (c_kv @ params["w_uk"]).reshape(B, S, n_heads, dn)
    v = (c_kv @ params["w_uv"]).reshape(B, S, n_heads, dv)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, n_heads, dr)],
                  dim=-1)
    # both scale by 1/sqrt(dn + dr), q's width: the MLA scale
    if flash:
        out = flash_attention(q, k.contiguous(), v, causal=True)
    else:
        out = causal_attention(q, k, v, block_q=block_q)
    return _out_proj(params, out.reshape(B, S, n_heads * dv), None)


def mla_forward(params, x, *, n_heads, mla, rope_theta, block_q: int = 512):
    """Prefill MLA over a full sequence: expand the latents to per-head
    K/V (q and k of width dn + dr, v of width dv) and attend."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv_latent(
        params, x, mla, n_heads, rope_theta, positions)
    return _mla_attend(params, q_nope, q_rope, c_kv, k_rope,
                       n_heads=n_heads, mla=mla, block_q=block_q,
                       flash=False)


def mla_make_cache(params, x, *, n_heads, mla, rope_theta, capacity: int,
                   block_q: int = 512, valid_len=None):
    """Prefill: returns (attn_out_projected, MLACache of the latents).
    The front end runs once (the reference runs it twice, with the same
    result)."""
    B, S, _ = x.shape
    if valid_len is not None and S > capacity:
        raise ValueError(f"valid_len prefill needs S <= capacity, "
                         f"got S={S}, capacity={capacity}")
    positions = torch.arange(S, device=x.device).expand(B, S)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv_latent(
        params, x, mla, n_heads, rope_theta, positions)
    out = _mla_attend(params, q_nope, q_rope, c_kv, k_rope,
                      n_heads=n_heads, mla=mla, block_q=block_q, flash=True)
    keep = min(S, capacity)
    cc = c_kv.new_zeros((B, capacity, mla.kv_lora_rank))
    kr = k_rope.new_zeros((B, capacity, mla.qk_rope_head_dim))
    cc[:, :keep] = c_kv[:, S - keep:]
    kr[:, :keep] = k_rope[:, S - keep:]
    return out, MLACache(cc, kr, _cache_index(valid_len, B, S, x.device))


def mla_decode(params, cache: MLACache, x, *, n_heads, mla, rope_theta):
    """Absorbed-form dense-slot MLA decode: scores and values in the
    latent space (plain torch, as the reference).  ``cache.index`` is a
    scalar or (B,) — see ``gqa_decode``; the cache is updated IN PLACE."""
    B, S, _ = x.shape
    if S != 1:
        raise ValueError(f"decode takes one token per row, got S={S}")
    dn, dr, dv = mla.qk_nope_head_dim, mla.qk_rope_head_dim, mla.v_head_dim
    r = mla.kv_lora_rank
    C = cache.c_kv.shape[1]
    positions, slot, valid = _decode_positions(cache.index, B, C)
    q_nope, q_rope, c_new, kr_new = _mla_qkv_latent(
        params, x, mla, n_heads, rope_theta, positions)
    _write_row(cache.c_kv, slot, c_new)
    _write_row(cache.k_rope, slot, kr_new)
    # absorb W_uk into q (f32 products, as the reference's
    # preferred_element_type=float32)
    w_uk = params["w_uk"].reshape(r, n_heads, dn)
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].float(), w_uk.float())
    cc, kr = cache.c_kv.float(), cache.k_rope.float()
    s_lat = torch.einsum("bhr,bsr->bhs", q_lat, cc)
    s_rope = torch.einsum("bhd,bsd->bhs", q_rope[:, 0].float(), kr)
    scores = (s_lat + s_rope) / math.sqrt(dn + dr)
    n_valid = valid[:, None, None] if valid.ndim == 1 else valid
    live = torch.arange(C, device=x.device)[None, None, :] < n_valid
    w = torch.softmax(torch.where(live, scores, -1e30), dim=-1)
    ctx_lat = torch.einsum("bhs,bsr->bhr", w, cc)
    w_uv = params["w_uv"].reshape(r, n_heads, dv)
    out = torch.einsum("bhr,rhd->bhd", ctx_lat, w_uv.float())
    out = out.reshape(B, 1, n_heads * dv).to(x.dtype)
    cache.index.add_(1)
    return _out_proj(params, out, None), cache


# ---------------------------------------------------------------------------
# Paged MLA: latent rows (c_kv ‖ k_rope) in a shared block pool
# ---------------------------------------------------------------------------
class PagedLatentCache(NamedTuple):
    """Paged absorbed-MLA state: one pool of latent rows per layer.

    Each token stores ``concat(c_kv, k_rope)`` — width ``r + dr`` — as a
    single "kv head"; the fused-V paged kernel reads the values as the
    first ``r`` lanes of each row."""
    pool: torch.Tensor       # (P, BLOCK_TOKENS, 1, kv_lora_rank + rope_dim)


def mla_paged_spec(num_blocks: int, mla, dtype,
                   block: int = BLOCK_TOKENS) -> PagedLatentCache:
    """Shape/dtype of one layer's latent pool, as a meta tensor."""
    width = mla.kv_lora_rank + mla.qk_rope_head_dim
    return PagedLatentCache(pool=torch.empty((num_blocks, block, 1, width),
                                             dtype=dtype, device="meta"))


def mla_paged_adopt(paged: PagedLatentCache, cache: MLACache, blocks):
    """Scatter one request's dense MLA prefill cache into pool blocks.

    ``cache.c_kv`` is (..., 1, S, r) and the pool (..., P, T, 1, r + dr),
    the same leading axes on both (a stacked segment's repeats).  Writes
    the pool IN PLACE (unlike the reference's functional update) and
    returns it."""
    pool = paged.pool
    S = cache.c_kv.shape[-2]
    T = pool.shape[-3]
    nb = len(blocks)
    if nb != -(-S // T):
        raise ValueError(f"adopt needs ceil({S}/{T}) block ids, got {nb}")
    rows = torch.cat([cache.c_kv[..., 0, :, :], cache.k_rope[..., 0, :, :]],
                     dim=-1)                        # (..., S, r + dr)
    for i, pid in enumerate(blocks):
        w = min(T, S - i * T)
        pool[..., int(pid), :w, 0, :] = rows[..., i * T:i * T + w, :]
    return paged


def mla_paged_decode(params, cache: PagedLatentCache, x, *, n_heads, mla,
                     rope_theta, tables, lens):
    """One paged absorbed-MLA decode step.  See ``gqa_paged_decode``.

    The new latent row ``concat(c_kv, k_rope)`` is written first; then
    ``q_eff = concat(q_nope · W_uk, q_rope)`` (f32, cast to the pool's
    dtype) attends over ``lens + 1`` latent rows through the fused-V
    kernel with the MLA scale ``1/sqrt(dn + dr)``, and ``W_uv`` lifts
    the latent context back to per-head values."""
    B, S, _ = x.shape
    if S != 1:
        raise ValueError(f"paged decode takes one token per row, got S={S}")
    dn, dr, dv = mla.qk_nope_head_dim, mla.qk_rope_head_dim, mla.v_head_dim
    r = mla.kv_lora_rank
    pos = lens.long()
    q_nope, q_rope, c_new, kr_new = _mla_qkv_latent(
        params, x, mla, n_heads, rope_theta, pos[:, None])
    pool = cache.pool
    T = pool.shape[1]
    blk = tables[torch.arange(B, device=x.device), pos // T].long()
    pool[blk, pos % T, 0] = torch.cat([c_new[:, 0], kr_new[:, 0]], dim=-1)
    # absorb W_uk into q (f32 products, as the reference's
    # preferred_element_type=float32)
    w_uk = params["w_uk"].reshape(r, n_heads, dn)
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].float(), w_uk.float())
    q_eff = torch.cat([q_lat, q_rope[:, 0].float()], dim=-1)   # (B, H, r+dr)
    ctx = paged_attention(q_eff.to(pool.dtype).contiguous(), pool, None,
                          tables, (lens + 1).to(torch.int32),
                          scale=1.0 / math.sqrt(dn + dr), v_dim=r)  # (B,H,r)
    w_uv = params["w_uv"].reshape(r, n_heads, dv)
    out = torch.einsum("bhr,rhd->bhd", ctx.float(), w_uv.float())
    out = out.reshape(B, 1, n_heads * dv).to(x.dtype)
    return _out_proj(params, out, None), cache
