"""Step functions and input specs for every (architecture × shape) cell
(a port of ``repro.launch.steps``).

``input_specs(cfg, shape)`` returns meta-tensor stand-ins for every
model input (the shapes and dtypes, no storage).  ``params_spec`` and
``opt_state_spec`` stand in for the reference's ``jax.eval_shape``: the
initialiser runs under ``FakeTensorMode`` and every leaf comes back as
a meta tensor, so deepseek-v3-671b's spec at full size allocates
nothing.  ``build_step`` returns the step function plus the meta
argument trees:

  * train   — (params, opt_state, batch)   → (params, opt_state, metrics)
  * prefill — (params, batch)              → (last-logits, caches)
  * decode  — (params, caches, token)      → (logits, caches)

The steps run eagerly on the device their arguments live on; the
train step is ``train.loop.make_train_step`` over the model's
``loss_fn`` (its optimizer state updates in place), and decode writes
the caches in place, as the reference's donated buffers would be.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch._bridge import tree_map
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models import encdec
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import _dtype
from repro_torch.optim import Optimizer, adamw, constant
from repro_torch.train.loop import make_train_step


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _meta(t):
    return _sds(t.shape, t.dtype) if torch.is_tensor(t) else t


def _abstract(fn, *args):
    """``fn(*args)`` with no storage: run under ``FakeTensorMode`` and
    return every tensor leaf as a meta tensor (``jax.eval_shape``)."""
    with FakeTensorMode():
        out = fn(*args)
    return tree_map(_meta, out)


def model_module(cfg: ArchConfig):
    """The model module that runs ``cfg``: ``encdec`` or ``transformer``."""
    return encdec if cfg.is_encoder_decoder else tfm


def cache_capacity(cfg: ArchConfig, shape: ShapeSpec) -> int:
    return int(shape.seq_len)


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Meta-tensor stand-ins for the model inputs of one cell."""
    B, S = shape.global_batch, shape.seq_len
    dt = _dtype(cfg.dtype)
    i32 = torch.int32
    if shape.kind == "train":
        if cfg.is_encoder_decoder:
            return {
                "frames": _sds((B, cfg.encoder_seq_len, cfg.d_model), dt),
                "tokens": _sds((B, S), i32),
                "labels": _sds((B, S), i32),
            }
        if cfg.num_patch_tokens:
            p = cfg.num_patch_tokens
            return {
                "tokens": _sds((B, S - p), i32),
                "patches": _sds((B, p, cfg.d_model), dt),
                "labels": _sds((B, S - p), i32),
            }
        return {"tokens": _sds((B, S), i32), "labels": _sds((B, S), i32)}
    if shape.kind == "prefill":
        if cfg.is_encoder_decoder:
            return {
                "frames": _sds((B, cfg.encoder_seq_len, cfg.d_model), dt),
                "tokens": _sds((B, S), i32),
            }
        if cfg.num_patch_tokens:
            p = cfg.num_patch_tokens
            return {"tokens": _sds((B, S - p), i32),
                    "patches": _sds((B, p, cfg.d_model), dt)}
        return {"tokens": _sds((B, S), i32)}
    # decode: one new token; caches provided separately
    return {"tokens": _sds((B, 1), i32)}


def params_spec(cfg: ArchConfig):
    """Parameter meta tensors (no allocation)."""
    init = model_module(cfg).init_params
    return _abstract(lambda: init(torch.Generator(), cfg, device="cpu"))


def cache_specs(cfg: ArchConfig, shape: ShapeSpec, params=None):
    """The decode caches of ``shape``; ``params`` (a rank's shards) gives
    a decoder-only model's recurrent states their local widths."""
    cap = cache_capacity(cfg, shape)
    if cfg.is_encoder_decoder or params is None:
        return model_module(cfg).cache_spec(cfg, shape.global_batch, cap)
    return model_module(cfg).cache_spec(cfg, shape.global_batch, cap,
                                        params=params)


@dataclass
class StepBundle:
    fn: Any                 # the step function
    args: Tuple             # meta-tensor trees, positional
    kind: str


def make_optimizer(cfg: ArchConfig) -> Optimizer:
    return adamw(constant(1e-4))


def opt_state_spec(cfg: ArchConfig, pspec):
    return _abstract(make_optimizer(cfg).init, pspec)


def build_step(cfg: ArchConfig, shape: ShapeSpec) -> StepBundle:
    mod = model_module(cfg)
    if shape.kind == "train":
        train_step = make_train_step(lambda p, b: mod.loss_fn(p, cfg, b),
                                     make_optimizer(cfg))
        pspec = params_spec(cfg)
        return StepBundle(train_step,
                          (pspec, opt_state_spec(cfg, pspec),
                           input_specs(cfg, shape)), "train")
    if shape.kind == "prefill":
        cap = cache_capacity(cfg, shape)

        @torch.no_grad()
        def prefill_step(params, batch):
            return mod.prefill(params, cfg, batch, cap)

        return StepBundle(prefill_step,
                          (params_spec(cfg), input_specs(cfg, shape)),
                          "prefill")

    @torch.no_grad()
    def decode_step(params, caches, token):
        return mod.decode_step(params, cfg, caches, token)

    return StepBundle(decode_step,
                      (params_spec(cfg), cache_specs(cfg, shape),
                       input_specs(cfg, shape)["tokens"]), "decode")


# ---------------------------------------------------------------------
# Cell skip logic (assignment rules; reasons recorded in the dry-run)
# ---------------------------------------------------------------------
def cell_skip_reason(cfg: ArchConfig, shape: ShapeSpec) -> Optional[str]:
    if shape.name == "long_500k" and not cfg.subquadratic:
        return ("full-attention arch: 500k dense-KV decode is "
                "sub-quadratic-only per assignment (see DESIGN.md)")
    return None
