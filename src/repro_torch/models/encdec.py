"""Whisper-style encoder-decoder backbone (the ``audio`` family).

A port of ``repro.models.encdec``.  The audio front end (two conv1d +
GELU in real Whisper) is a stub, as in the reference: the inputs are
precomputed mel-frame embeddings (batch, frames, d_model), and a learned
linear ``frame_adapter`` stands in for the conv stack.  Encoder:
non-causal self-attention with sinusoidal positions added after the
adapter.  Decoder: causal self-attention with rotary positions (the
KV cache index supplies them in decode), then cross-attention to the
encoder output, then the MLP.  The per-layer parameters are stacked on
a leading layer axis under ``enc`` and ``dec``, keyed like the
reference's.

Serving: ``prefill`` encodes the frames, makes each decoder layer's
cross K/V once and prefills the decoder prompt; ``decode_step``
consumes (the self-attention KV cache, the kept cross K/V) and updates
the KV cache IN PLACE.  On the card the serving encoder attends through
the flash attention kernel (``kernels.flash_attention``, non-causal)
and the decoder prefill through it too (``gqa_make_cache``, causal);
cross-attention, the training forward and dense-slot decode are plain
torch, as the reference's attention is there.  There is no tile plan:
the reference's plan walker finds no ``segments`` in this tree, so a
ticket serves dense on its masked weights.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch._bridge import resolve_device, tree_index, tree_map, tree_stack
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import (_dtype, apply_norm, embed, embed_init,
                                       mlp, mlp_init, norm_init,
                                       sinusoidal_positions,
                                       softmax_cross_entropy, unembed, xavier)


class CrossKV(NamedTuple):
    k: torch.Tensor          # (B, T_enc, Hkv, hd)
    v: torch.Tensor


def _enc_layer_init(gen, cfg, dtype, device):
    return {
        "norm1": norm_init(cfg.norm, cfg.d_model, dtype, device),
        "attn": attn_lib.gqa_init(gen, cfg.d_model, cfg.n_heads,
                                  cfg.n_kv_heads, cfg.head_dim_,
                                  cfg.qkv_bias, dtype, device),
        "norm2": norm_init(cfg.norm, cfg.d_model, dtype, device),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp,
                        cfg.mlp_bias, dtype, device),
    }


def _dec_layer_init(gen, cfg, dtype, device):
    p = _enc_layer_init(gen, cfg, dtype, device)
    p["norm_x"] = norm_init(cfg.norm, cfg.d_model, dtype, device)
    p["xattn"] = attn_lib.gqa_init(gen, cfg.d_model, cfg.n_heads,
                                   cfg.n_kv_heads, cfg.head_dim_,
                                   cfg.qkv_bias, dtype, device)
    return p


def init_params(gen: torch.Generator, cfg: ArchConfig, *, device="cuda"):
    """The parameter pytree (frame adapter, tied embedding, stacked
    encoder and decoder layers, the two final norms), drawn from
    ``gen`` (a generator on ``device``)."""
    dev = resolve_device(device)
    dtype = _dtype(cfg.dtype)
    enc = [_enc_layer_init(gen, cfg, dtype, dev)
           for _ in range(cfg.n_encoder_layers)]
    dec = [_dec_layer_init(gen, cfg, dtype, dev) for _ in range(cfg.n_layers)]
    return {
        "frame_adapter": xavier(gen, (cfg.d_model, cfg.d_model), dtype, dev),
        "embed": embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype, dev),
        "enc": tree_stack(enc),
        "dec": tree_stack(dec),
        "enc_norm": norm_init(cfg.norm, cfg.d_model, dtype, dev),
        "final_norm": norm_init(cfg.norm, cfg.d_model, dtype, dev),
    }


def _proj(p, x, w, b, heads, cfg):
    """x @ p[w] (+ p[b] where the config has QKV biases), split into
    (B, S, heads, hd).  On a rank's head shard (``x`` through
    ``copy_in``) the bias is cut to the local heads."""
    y = x @ p[w]
    if b in p:
        tp = attn_lib._tensor_parallel(p)
        y = y + (p[b] if tp is None else tp.cut(p[b]))
    return y.reshape(*x.shape[:2], heads, cfg.head_dim_)


def _copy_in(p, x):
    """``x`` as the input of a rank's head shard (copy-to-model), else
    itself."""
    tp = attn_lib._tensor_parallel(p)
    return x if tp is None else tp.copy_in(x)


def _attn_kw(cfg):
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.head_dim_, rope_theta=cfg.rope_theta)


def _mha_full(p, x, cfg, causal: bool, flash: bool = False):
    """Causal (the decoder's, with rope) or bidirectional (the
    encoder's, no positions) self-attention over a whole sequence;
    ``flash`` attends the bidirectional form through kernel #8."""
    if causal:
        return attn_lib.gqa_forward(p, x, **_attn_kw(cfg))
    B, S, _ = x.shape
    x = _copy_in(p, x)
    q = _proj(p, x, "wq", "bq", cfg.n_heads, cfg)
    k = _proj(p, x, "wk", "bk", cfg.n_kv_heads, cfg)
    v = _proj(p, x, "wv", "bv", cfg.n_kv_heads, cfg)
    if flash:
        out = flash_attention(q, k, v, causal=False)
    else:
        out = attn_lib.attend(q, k, v, causal=False, q_offset=0)
    return attn_lib._out_proj(p, out.reshape(B, S, -1), None)


def _cross_kv(p, enc_out, cfg) -> CrossKV:
    enc_out = _copy_in(p, enc_out)
    return CrossKV(_proj(p, enc_out, "wk", "bk", cfg.n_kv_heads, cfg),
                   _proj(p, enc_out, "wv", "bv", cfg.n_kv_heads, cfg))


def _cross_attend(p, x, ckv: CrossKV, cfg):
    B, S, _ = x.shape
    q = _proj(p, _copy_in(p, x), "wq", "bq", cfg.n_heads, cfg)
    out = attn_lib.attend(q, ckv.k, ckv.v, causal=False, q_offset=0)
    return attn_lib._out_proj(p, out.reshape(B, S, -1), None)


def encode(params, cfg: ArchConfig, frames, *, flash: bool = False):
    """frames: (B, T, d_model) stub embeddings → the encoder output
    (B, T, d_model).  ``flash`` (serving) attends through kernel #8."""
    x = frames.to(params["frame_adapter"].dtype) @ params["frame_adapter"]
    x = x + sinusoidal_positions(x.shape[1], cfg.d_model, x.dtype,
                                 x.device)[None]
    for i in range(cfg.n_encoder_layers):
        p = tree_index(params["enc"], i)
        h = apply_norm(cfg.norm, p["norm1"], x)
        x = x + _mha_full(p["attn"], h, cfg, causal=False, flash=flash)
        h = apply_norm(cfg.norm, p["norm2"], x)
        x = x + mlp(p["mlp"], h, cfg.act)
    return apply_norm(cfg.norm, params["enc_norm"], x)


def _decoder(params, cfg, tokens, enc_out, mode, caches=None, capacity=None):
    """The decoder over ``tokens``: mode "forward" (training), "prefill"
    (a KV cache of ``capacity`` rows and each layer's cross K/V) or
    "decode" (one token against ``caches``).  Returns (logits, caches;
    None in "forward")."""
    x = embed(params["embed"], tokens)
    new_caches = []
    for i in range(cfg.n_layers):
        p = tree_index(params["dec"], i)
        h = apply_norm(cfg.norm, p["norm1"], x)
        if mode == "forward":
            x = x + _mha_full(p["attn"], h, cfg, causal=True)
        elif mode == "prefill":
            out, kv = attn_lib.gqa_make_cache(p["attn"], h,
                                              capacity=capacity,
                                              **_attn_kw(cfg))
            x = x + out
        else:
            out, kv = attn_lib.gqa_decode(p["attn"], caches[i]["self"], h,
                                          **_attn_kw(cfg))
            x = x + out
        h = apply_norm(cfg.norm, p["norm_x"], x)
        ckv = (caches[i]["cross"] if mode == "decode"
               else _cross_kv(p["xattn"], enc_out, cfg))
        x = x + _cross_attend(p["xattn"], h, ckv, cfg)
        h = apply_norm(cfg.norm, p["norm2"], x)
        x = x + mlp(p["mlp"], h, cfg.act)
        if mode != "forward":
            new_caches.append({"self": kv, "cross": ckv})
    x = apply_norm(cfg.norm, params["final_norm"], x)
    return unembed(params["embed"], x), (new_caches or None)


def forward(params, cfg: ArchConfig, batch):
    """batch: frames (B, T, d), tokens (B, S) → (decoder logits (B, S,
    V), a zero aux loss)."""
    enc_out = encode(params, cfg, batch["frames"])
    logits, _ = _decoder(params, cfg, batch["tokens"], enc_out, "forward")
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def loss_fn(params, cfg: ArchConfig, batch, aux_weight: float = 0.0,
            count=None):
    """Mean next-token cross-entropy of the decoder → (loss, metrics).
    ``count`` divides the token-loss sum instead of this batch's own
    count (``softmax_cross_entropy``: a data axis's global count)."""
    logits, aux = forward(params, cfg, batch)
    ce = softmax_cross_entropy(logits, batch["labels"],
                               batch.get("loss_mask"), count=count)
    return ce, {"ce": ce, "aux": aux}


def prefill(params, cfg: ArchConfig, batch, capacity: int):
    """batch: frames (B, T, d), tokens (B, S) → (last-position logits
    (B, 1, V), per-layer ``{"self": KVCache, "cross": CrossKV}``)."""
    enc_out = encode(params, cfg, batch["frames"], flash=True)
    logits, caches = _decoder(params, cfg, batch["tokens"], enc_out,
                              "prefill", capacity=capacity)
    return logits[:, -1:], caches


def decode_step(params, cfg: ArchConfig, caches, token):
    """token (B, 1) → (logits (B, 1, V), caches); each layer's KV cache
    takes the new token's K/V in place."""
    return _decoder(params, cfg, token, None, "decode", caches=caches)


def cache_spec(cfg: ArchConfig, batch: int, capacity: int):
    """Meta-tensor pytree of the decode caches: per decoder layer a KV
    cache of ``capacity`` rows and the cross K/V over the encoder's
    ``encoder_seq_len`` frames."""
    dtype = _dtype(cfg.dtype)
    cross = torch.empty((batch, cfg.encoder_seq_len, cfg.n_kv_heads,
                         cfg.head_dim_), dtype=dtype, device="meta")
    return [{"self": attn_lib.gqa_cache_spec(batch, capacity, cfg.n_kv_heads,
                                             cfg.head_dim_, dtype),
             "cross": CrossKV(k=cross, v=cross)}
            for _ in range(cfg.n_layers)]


def cache_batch_axes(cfg: ArchConfig, caches):
    """Pytree of ints matching ``caches``: every leaf's batch axis is 0
    (the layers are a list, not a stacked axis; a scalar cache index has
    none yet, and the engine appends one)."""
    return tree_map(lambda _: 0, caches)
