"""Analytic per-layer flops and the scan correction κ (a port of
``repro.launch.costs``).

The reference's ``compiled.cost_analysis()`` visits each while-loop body
ONCE, and its models scan over layers, so its raw flops, bytes and
collective bytes undercount by roughly the scan trip count.  It
corrects them by the per-cell factor

    κ = (Σ_s reps_s·F_s + F_rest) / (Σ_s F_s + F_rest)

from analytic per-segment forward-flop weights F_s (matmul + attention
terms; MoE counted at *active* expert flops).  The same κ is applied to
bytes and collective bytes.

The port keeps the reference's loop over layers as a loop over views,
and its step trace (``launch.hlo_analysis``) records every layer, so κ
is 1 for the port's own records (``launch.dryrun`` writes ``"kappa":
1.0``).  The analytic weights and κ are kept, equal to the reference's
for every arch × shape, so that ``corrected_roofline`` reads a
reference dry-run record as the reference does.
"""
from __future__ import annotations

from typing import List, Tuple

from repro_torch.configs.base import (ATTN, LOCAL_ATTN, MLSTM, RGLRU, SLSTM,
                                      ArchConfig, ShapeSpec)
from repro_torch.models.transformer import segments_of


def _attn_ctx(cfg: ArchConfig, kind: str, shape: ShapeSpec) -> float:
    """Mean attended context length per query token."""
    S = shape.seq_len
    if shape.kind == "decode":
        ctx = float(S)
    else:
        ctx = S / 2.0
    if kind == LOCAL_ATTN and cfg.local_window:
        ctx = min(ctx, float(cfg.local_window))
    return ctx


def block_flops_per_token(cfg: ArchConfig, sig, shape: ShapeSpec) -> float:
    """Analytic forward flops per token for one block."""
    kind, is_moe = sig
    d, hd = cfg.d_model, cfg.head_dim_
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    mat = 0.0
    if kind in (ATTN, LOCAL_ATTN):
        if cfg.mla is not None:
            m = cfg.mla
            dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
            mat += d * m.q_lora_rank + m.q_lora_rank * nq * (dn + dr)
            mat += d * (m.kv_lora_rank + dr)
            mat += m.kv_lora_rank * nq * (dn + dv)
            mat += nq * dv * d
            qk_dim, v_dim = dn + dr, dv
        else:
            mat += d * nq * hd + 2 * d * nkv * hd + nq * hd * d
            qk_dim, v_dim = hd, hd
        ctx = _attn_ctx(cfg, kind, shape)
        mat += ctx * nq * (qk_dim + v_dim)       # scores + weighted values
    elif kind == RGLRU:
        w = cfg.rnn_width or d
        mat += 2 * d * w + w * d                 # in/gate/out projections
        mat += 2 * w * (w // max(cfg.n_heads, 1))  # block-diag gates
    elif kind == MLSTM:
        w = cfg.rnn_width or 2 * d
        mat += 2 * d * w + w * d
        mat += 3 * w * (w // max(cfg.n_heads, 1))
        mat += 2 * (w // max(cfg.n_heads, 1)) ** 2 * max(cfg.n_heads, 1)
    elif kind == SLSTM:
        mat += 4 * d * d + 4 * d * (d // max(cfg.n_heads, 1))
        mat += 4 * d * d + 2 * d * d             # post gated MLP
    if cfg.d_ff > 0 and kind in (ATTN, LOCAL_ATTN, RGLRU):
        mlt = 3 if cfg.gated_mlp else 2
        if is_moe and cfg.moe is not None:
            m = cfg.moe
            mat += d * m.num_experts             # router
            active = m.top_k + m.num_shared_experts
            mat += active * mlt * d * m.d_ff_expert
        else:
            mat += mlt * d * cfg.d_ff
    return 2.0 * mat


def segment_flop_weights(cfg: ArchConfig, shape: ShapeSpec
                         ) -> Tuple[List[Tuple[float, int]], float]:
    """([(body_flops, reps)], rest_flops) — absolute fwd flops per step."""
    B, S = shape.global_batch, shape.seq_len
    n_tokens = B * (1 if shape.kind == "decode" else S)
    if cfg.is_encoder_decoder:
        # encoder: one scanned segment over n_encoder_layers
        enc_sig = (ATTN, False)
        enc_tokens = B * cfg.encoder_seq_len
        enc_body = block_flops_per_token(cfg, enc_sig, shape) * enc_tokens
        segs = [(enc_body, cfg.n_encoder_layers)]
        # decoder is a Python loop (unrolled — counted correctly): rest
        dec = block_flops_per_token(cfg, enc_sig, shape) * n_tokens * 1.7
        rest = dec * cfg.n_layers
        rest += 2.0 * cfg.d_model * cfg.padded_vocab * (
            n_tokens if shape.kind != "prefill" else B)
        return segs, rest
    segs = []
    for seg in segments_of(cfg):
        body = sum(block_flops_per_token(cfg, sig, shape) for sig in seg.sigs)
        segs.append((body * n_tokens, seg.reps))
    head_tokens = n_tokens if shape.kind != "prefill" else B
    rest = 2.0 * cfg.d_model * cfg.padded_vocab * head_tokens
    return segs, rest


def scan_correction(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """κ ≥ 1: multiply raw cost_analysis totals by this."""
    segs, rest = segment_flop_weights(cfg, shape)
    counted = sum(f for f, _ in segs) + rest
    true = sum(f * r for f, r in segs) + rest
    return true / max(counted, 1.0)


def corrected_roofline(rec: dict, cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """Apply κ to a dry-run record's raw roofline dict (returns a copy),
    with the port's H100 peaks.  κ is ``rec["kappa"]`` when the record
    carries one (the port's dry-run writes 1.0: its trace counts every
    layer), else ``scan_correction`` (a reference record: XLA counted
    each scanned body once).  So a reference record read here gives the
    reference's flops, bytes and κ, and a port record comes back as
    it is."""
    from repro_torch.launch.hlo_analysis import HBM_BW, NET_BW, PEAK_FLOPS
    kappa = rec["kappa"] if "kappa" in rec else scan_correction(cfg, shape)
    r = dict(rec)
    for k_src, k_dst in (("flops", "flops"), ("bytes", "bytes"),
                         ("collective_bytes", "collective_bytes")):
        r[k_dst] = rec[k_src] * kappa
    r["kappa"] = kappa
    r["compute_s"] = r["flops"] / PEAK_FLOPS
    r["memory_s"] = r["bytes"] / HBM_BW
    r["collective_s"] = r["collective_bytes"] / NET_BW
    terms = {"compute": r["compute_s"], "memory": r["memory_s"],
             "collective": r["collective_s"]}
    r["bottleneck"] = max(terms, key=terms.get)
    step = max(terms.values())
    n = rec.get("n_chips", 256)
    if rec.get("model_flops"):
        r["useful_flops_ratio"] = rec["model_flops"] / (r["flops"] * n)
        r["mfu"] = rec["model_flops"] / (step * n * PEAK_FLOPS) if step else 0
    return r
