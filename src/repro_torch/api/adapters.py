"""Model adapters: init/train/eval/prunability behind one protocol (port
of ``repro.api.adapters``; ``LMAdapter`` only — ``CNNAdapter``,
``EncDecAdapter`` and ``FunctionAdapter`` come with their slices).

Algorithm 1 is model-agnostic: the only model-specific pieces are how
to initialise parameters, train them under a mask, score them, and
decide which leaves are prunable.  ``LMAdapter`` builds its retraining
on ``train.loop.Trainer``: with masks, every routed projection's
forward, dx and dw run through the block-sparse kernels.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch._bridge import resolve_device, tree_leaves, tree_map
from repro_torch.core.masks import apply_masks, lm_prunable
from repro_torch.data import DataPipeline, SyntheticLM
from repro_torch.distributed.compression import MaskAwareCompressor
from repro_torch.models.plans import PlanStats
from repro_torch.optim import adamw, constant, masked, warmup_cosine
from repro_torch.train import Trainer, lm_train_plan


class ModelAdapter:
    """Protocol: everything a pruning session needs from a model.

    ``train``/``evaluate`` take ``masks=None`` for the dense model.
    ``evaluate`` returns a scalar where HIGHER IS BETTER (adapters for
    likelihood models return negative loss).
    """

    cfg: Any = None
    family: str = "custom"
    prunable_pred: Optional[Callable[[str, Any], bool]] = None

    def init_params(self, gen):
        raise NotImplementedError

    def train(self, params, masks=None, steps: Optional[int] = None, *,
              quantize_bits: Optional[int] = None):
        raise NotImplementedError

    def evaluate(self, params, masks=None) -> float:
        raise NotImplementedError

    def prunable(self, path: str, leaf) -> bool:
        if self.prunable_pred is None:
            raise NotImplementedError(
                f"{type(self).__name__} has no prunable_pred")
        return self.prunable_pred(path, leaf)


class LMAdapter(ModelAdapter):
    """Decoder-only transformers (the ported all-GQA dense family).

    ``evaluate`` returns NEGATIVE mean cross-entropy on held-out batches.
    ``use_bsmm``: retrain under masks through the block-sparse kernels
    (attention q/k/v/o and MLP, forward and backward); ``None`` means
    on whenever masks are given — on the CPU that runs the kernels'
    plain versions.  ``device`` defaults to "cuda" and raises without a
    card unless given "cpu".
    """

    family = "dense"

    def __init__(self, cfg, *, data=None, steps: int = 100,
                 batch_size: int = 8, seq_len: int = 128,
                 peak_lr: float = 3e-4, warmup: int = 20,
                 eval_batches: int = 2, microbatch: Optional[int] = None,
                 remat: bool = False, log_every: int = 0,
                 step_deadline_s: Optional[float] = None,
                 use_bsmm: Optional[bool] = None, device="cuda"):
        from repro_torch.models import transformer as tfm
        tfm.check_trainable(cfg)
        self._tfm = tfm
        self.cfg = cfg
        self.device = resolve_device(device)
        self.family = getattr(cfg, "family", "dense")
        self.prunable_pred = lm_prunable
        self.data = data or SyntheticLM(
            vocab_size=min(int(cfg.vocab_size), 256), seq_len=seq_len,
            seed=0)
        self.steps = steps
        self.batch_size = batch_size
        self.peak_lr, self.warmup = peak_lr, warmup
        self.eval_batches = eval_batches
        self.microbatch, self.remat = microbatch, remat
        self.log_every = log_every
        self.step_deadline_s = step_deadline_s
        self.use_bsmm = use_bsmm
        self.last_plan_stats = PlanStats()
        self.last_metrics: Dict[str, float] = {}
        self.last_comm_stats: Dict[str, float] = {}

    # -- protocol ----------------------------------------------------------
    def init_params(self, gen: torch.Generator):
        """Parameters drawn from ``gen`` (a generator on the adapter's
        device)."""
        return self._tfm.init_params(gen, self.cfg, device=self.device)

    def _batch(self, step):
        b = self.data.batch(step, self.batch_size)
        return {"tokens": torch.as_tensor(b["tokens"], device=self.device),
                "labels": torch.as_tensor(b["labels"], device=self.device)}

    def make_trainer(self, params, masks=None, *, steps: Optional[int] = None,
                     start_step: int = 0, ckpt_dir: Optional[str] = None,
                     learning_rate: Optional[float] = None,
                     quantize_bits: Optional[int] = None) -> Trainer:
        """A fully wired Trainer for these weights.

        With ``masks`` (and ``use_bsmm``), the train step closes over a
        block-sparse plan derived from the CURRENT masks: the forward and
        both backward products of every routed projection skip dead
        128×128 tiles.  Masks move to the device once, here.
        """
        if quantize_bits is not None:
            raise NotImplementedError("quantization-aware retraining is not "
                                      "yet ported to repro_torch")
        steps = steps or self.steps
        sched = (constant(learning_rate) if learning_rate is not None
                 else warmup_cosine(self.peak_lr,
                                    min(self.warmup, max(steps // 2, 1)),
                                    steps))
        opt = adamw(sched)
        compressor = None
        if masks is not None:
            masks = tree_map(lambda m: torch.as_tensor(m, device=self.device),
                             masks)
            opt = masked(opt, masks)
            params = apply_masks(params, masks)
            # only live coordinates would go on the wire: the masked
            # optimizer zeroes pruned grads anyway, so this is neutral
            compressor = MaskAwareCompressor(masks)
        use_bsmm = masks is not None if self.use_bsmm is None \
            else self.use_bsmm
        plan, self.last_plan_stats = (
            lm_train_plan(masks) if masks is not None and use_bsmm
            else (None, PlanStats()))
        cfg, tfm = self.cfg, self._tfm

        def loss(p, batch):
            return tfm.loss_fn(p, cfg, batch, plan=plan)

        return Trainer(
            loss_fn=loss, optimizer=opt, params=params,
            data_iter=DataPipeline(self._batch, start_step=start_step,
                                   prefetch=0),
            ckpt_dir=ckpt_dir, microbatch=self.microbatch, remat=self.remat,
            step_deadline_s=self.step_deadline_s, compressor=compressor,
            device=self.device)

    def train(self, params, masks=None, steps=None, *, start_step: int = 0,
              ckpt_dir: Optional[str] = None,
              learning_rate: Optional[float] = None,
              quantize_bits: Optional[int] = None):
        trainer = self.make_trainer(params, masks, steps=steps,
                                    start_step=start_step, ckpt_dir=ckpt_dir,
                                    learning_rate=learning_rate,
                                    quantize_bits=quantize_bits)
        self.last_metrics = trainer.run(steps or self.steps,
                                        log_every=self.log_every)
        self.last_comm_stats = {}
        if "sent_fraction" in self.last_metrics:
            sf = float(self.last_metrics["sent_fraction"])
            total = sum(int(t.numel()) for t in tree_leaves(params))
            self.last_comm_stats = {
                "sent_fraction": sf,
                "bytes_per_step": int(round(sf * total)) * 4,
            }
        return trainer.state.params

    def evaluate(self, params, masks=None) -> float:
        losses = []
        with torch.no_grad():
            for i in range(self.eval_batches):
                loss, _ = self._tfm.loss_fn(params, self.cfg,
                                            self._batch(10_000 + i))
                losses.append(float(loss))
        return -float(np.mean(losses))
