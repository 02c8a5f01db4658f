"""Model adapters: init/train/eval/prunability/serving behind one
protocol (port of ``repro.api.adapters``).

Algorithm 1 is model-agnostic: the only model-specific pieces are how
to initialise parameters, train them under a mask, score them, and
decide which leaves are prunable.  The family-specific pieces —
prunability predicate, conv-path predicate, granularity schedule,
recipe — are data on the adapter, set by ``api.registry.make_adapter``.

``CNNAdapter``, ``LMAdapter`` and ``EncDecAdapter`` build their
retraining on ``train.loop.Trainer``: with masks, every routed product
(the CNN's FC layers and head when they tile at 128; every planned LM
projection) runs forward, dx and dw through the block-sparse kernels.  ``FunctionAdapter``
wraps plain closures.  Entry points take ``device=`` (default "cuda",
raising without a card unless given "cpu").
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._bridge import resolve_device, tree_leaves, tree_map
from repro_torch.core.masks import (apply_masks, cnn_conv_path, cnn_prunable,
                                    encdec_prunable, lm_prunable)
from repro_torch.core.quantize import fake_quantize_tree
from repro_torch.data import (DataPipeline, SyntheticAudio, SyntheticImages,
                              SyntheticLM)
from repro_torch.distributed.compression import MaskAwareCompressor
from repro_torch.models.plans import PlanStats
from repro_torch.optim import (adamw, constant, exponential_epoch_decay,
                               masked, sgd, warmup_cosine)
from repro_torch.train import Trainer, cnn_train_plan, lm_train_plan


class ServeUnsupported(NotImplementedError):
    """An adapter whose family has no ServeEngine path.

    Structured (arch/family/reason) so callers — the CLI ``serve``
    subcommand in particular — can report *why* per architecture
    instead of surfacing a bare traceback.
    """

    def __init__(self, arch: str, family: str, reason: str):
        self.arch = arch
        self.family = family
        self.reason = reason
        super().__init__(f"{arch} ({family}): serving unsupported — "
                         f"{reason}")


class ModelAdapter:
    """Protocol: everything a pruning session needs from a model.

    ``train``/``evaluate`` take ``masks=None`` for the dense model.
    ``evaluate`` returns a scalar where HIGHER IS BETTER (accuracy for
    classifiers; adapters for likelihood models return negative loss).

    ``prunable_pred`` / ``conv_path_pred`` / ``granularities`` /
    ``recipe`` are the per-family registry data; subclasses set
    defaults and ``make_adapter`` overrides them from the family entry.
    ``train`` accepts ``quantize_bits``: when set, the step
    fake-quantizes the prunable weights (straight-through) — the
    ``quantize`` recipe stage.
    """

    cfg: Any = None
    family: str = "custom"
    # None → the session falls back to PruneConfig.granularities
    granularities: Optional[Sequence[str]] = None
    # family-tuned Recipe (or registered recipe name); None → schedule
    recipe: Optional[Any] = None
    prunable_pred: Optional[Callable[[str, Any], bool]] = None
    conv_path_pred: Optional[Callable[[str], bool]] = None

    def init_params(self, gen):
        raise NotImplementedError

    def train(self, params, masks=None, steps: Optional[int] = None, *,
              quantize_bits: Optional[int] = None):
        raise NotImplementedError

    def _qat(self, quantize_bits: Optional[int]):
        """Loss-input transform for quantization-aware retraining."""
        if quantize_bits is None:
            return lambda p: p
        return lambda p: fake_quantize_tree(p, self.prunable, quantize_bits)

    def evaluate(self, params, masks=None) -> float:
        raise NotImplementedError

    def prunable(self, path: str, leaf) -> bool:
        if self.prunable_pred is None:
            raise NotImplementedError(
                f"{type(self).__name__} has no prunable_pred")
        return self.prunable_pred(path, leaf)

    def conv_pred(self, path: str) -> bool:
        return bool(self.conv_path_pred(path)) if self.conv_path_pred \
            else False

    def serve_fns(self) -> Tuple[Callable, Callable]:
        """(prefill_fn, decode_fn) for the ServeEngine handoff."""
        cfg_name = getattr(self.cfg, "name", "<unknown>")
        raise ServeUnsupported(
            cfg_name, self.family,
            f"{type(self).__name__} exposes no prefill/decode pair")


@dataclasses.dataclass
class FunctionAdapter(ModelAdapter):
    """Wrap plain closures — the bridge for ``core.algorithm.realprune``
    callers and for scripted, deterministic tests."""

    params: Any = None
    train_fn: Callable = None           # (params, masks) -> params
    eval_fn: Callable = None            # (params, masks) -> float
    prunable: Callable = None           # (path, leaf) -> bool
    conv_pred: Callable = None          # (path) -> bool
    cfg: Any = None

    def init_params(self, gen):
        return tree_map(lambda x: x, self.params)

    def train(self, params, masks=None, steps=None, *, quantize_bits=None):
        # scripted closures predate QAT; bits are accepted and ignored
        return self.train_fn(params, masks)

    def evaluate(self, params, masks=None) -> float:
        return float(self.eval_fn(params, masks))


def _to_device(masks, device):
    return tree_map(lambda m: torch.as_tensor(m, device=device), masks)


class CNNAdapter(ModelAdapter):
    """CNN (VGG/ResNet family) on image batches, trained via ``Trainer``
    with SGD + momentum and the paper's per-epoch LR decay.

    BatchNorm statistics thread through the Trainer's aux-state channel;
    each ``train`` call restarts them from initialisation (every prune
    iteration retrains the rewound ticket from scratch, paper line 3).

    ``use_bsmm``: when retraining under masks, the FC/head products go
    through the block-sparse kernels with a plan rebuilt from the
    CURRENT masks on every ``train`` call (shapes that don't tile 128
    stay dense).  ``None`` (default) turns it on when ``device`` is
    CUDA; on the CPU the kernels' plain versions would run, which is a
    correctness path, not a fast one.
    """

    family = "cnn"

    def __init__(self, cfg, *, data=None, steps: int = 80,
                 batch_size: int = 64, lr: float = 0.05,
                 lr_decay: float = 0.95, decay_every: Optional[int] = None,
                 eval_batches: int = 3, eval_batch_size: int = 128,
                 momentum: float = 0.9, log_every: int = 0,
                 use_bsmm: Optional[bool] = None, device="cuda"):
        from repro_torch.models import cnn as cnn_lib
        self._cnn = cnn_lib
        self.cfg = cfg
        self.device = resolve_device(device)
        self.prunable_pred = cnn_prunable
        self.conv_path_pred = cnn_conv_path
        self.data = data or SyntheticImages(image_size=cfg.image_size,
                                            noise=0.25)
        self.steps = steps
        self.batch_size = batch_size
        self.lr, self.lr_decay = lr, lr_decay
        self.decay_every = decay_every
        self.eval_batches = eval_batches
        self.eval_batch_size = eval_batch_size
        self.momentum = momentum
        self.log_every = log_every
        self.use_bsmm = (self.device.type == "cuda" if use_bsmm is None
                         else use_bsmm)
        self.last_plan_stats = PlanStats()
        self.last_metrics: Dict[str, float] = {}
        self._bn0 = None
        self._bn = None

    # -- protocol ----------------------------------------------------------
    def init_params(self, gen: torch.Generator):
        """Parameters drawn from ``gen`` (a generator on the adapter's
        device); the BN state starts from its initial value."""
        params, bn = self._cnn.init_params(gen, self.cfg, device=self.device)
        self._bn0 = bn
        self._bn = bn
        return params

    def _batch(self, step, size):
        b = self.data.batch(step, size)
        return {"images": torch.as_tensor(b["images"], device=self.device),
                "labels": torch.as_tensor(b["labels"], device=self.device)}

    def train(self, params, masks=None, steps=None, *, quantize_bits=None):
        if self._bn0 is None:
            raise RuntimeError("call init_params before train")
        steps = steps or self.steps
        sched = exponential_epoch_decay(
            self.lr, self.lr_decay, self.decay_every or max(steps // 2, 1))
        opt = sgd(sched, momentum=self.momentum)
        if masks is not None:
            masks = _to_device(masks, self.device)
            opt = masked(opt, masks)
            params = apply_masks(params, masks)
        plans, self.last_plan_stats = (
            cnn_train_plan(masks) if masks is not None and self.use_bsmm
            else (None, PlanStats()))
        qat = self._qat(quantize_bits)
        cfg, cnn = self.cfg, self._cnn

        def loss(p, state, batch):
            l, (new_state, _) = cnn.loss_fn(qat(p), state, cfg, batch,
                                            train=True, plans=plans)
            return l, (new_state, {})

        trainer = Trainer(
            loss_fn=loss, optimizer=opt, params=params,
            data_iter=DataPipeline(
                lambda s: self.data.batch(s, self.batch_size), prefetch=0),
            aux_state=self._bn0, device=self.device)
        self.last_metrics = trainer.run(steps, log_every=self.log_every)
        self._bn = trainer.state.aux
        return trainer.state.params

    def evaluate(self, params, masks=None) -> float:
        accs = []
        with torch.no_grad():
            for i in range(self.eval_batches):
                b = self._batch(10_000 + i, self.eval_batch_size)
                accs.append(float(self._cnn.accuracy(
                    params, self._bn, self.cfg, b["images"], b["labels"])))
        return float(np.mean(accs))


class LMAdapter(ModelAdapter):
    """Decoder-only transformers of global attention, GQA or MLA, with
    dense or MoE FFNs (the dense and moe families), of RG-LRU and
    sliding-window attention blocks (the hybrid family), of mLSTM and
    sLSTM blocks (the ssm family) and with a patch prefix (the vlm
    family: every batch carries ``patches``, and serving takes
    text-only prompts, as the reference's does).

    ``evaluate`` returns NEGATIVE mean cross-entropy on held-out batches;
    the training loss adds 0.01 x the MoE aux loss, as the reference's.
    ``use_bsmm``: retrain under masks through the block-sparse kernels
    (GQA q/k/v/o, MLP and shared-expert up/gate/down through the 2-D
    kernels, the stacked experts through the batched ones, forward and
    backward; MLA's projections and the router stay dense, as in the
    reference); ``None`` means on whenever masks are given — on the CPU
    that runs the kernels' plain versions.  ``device`` defaults to
    "cuda" and raises without a card unless given "cpu".
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
        tfm.check_ported(cfg)
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

    def _patches(self, step: int, size: int) -> np.ndarray:
        """Deterministic patch-prefix embeddings (size, P, d_model) for a
        vlm config, a pure function of the step like the synthetic data
        sources."""
        rng = np.random.RandomState((1_000_003 * step + 11) % (2 ** 31 - 1))
        return rng.randn(size, self.cfg.num_patch_tokens,
                         self.cfg.d_model).astype(np.float32)

    def _batch(self, step):
        b = self.data.batch(step, self.batch_size)
        out = {"tokens": torch.as_tensor(b["tokens"], device=self.device),
               "labels": torch.as_tensor(b["labels"], device=self.device)}
        if self.cfg.num_patch_tokens:
            out["patches"] = torch.as_tensor(
                self._patches(step, self.batch_size), device=self.device)
        return out

    def make_trainer(self, params, masks=None, *, steps: Optional[int] = None,
                     start_step: int = 0, ckpt_dir: Optional[str] = None,
                     learning_rate: Optional[float] = None,
                     quantize_bits: Optional[int] = None) -> Trainer:
        """A fully wired Trainer for these weights.

        With ``masks`` (and ``use_bsmm``), the train step closes over a
        block-sparse plan derived from the CURRENT masks: the forward and
        both backward products of every routed projection skip dead
        128×128 tiles.  Masks move to the device once, here.  With
        ``quantize_bits`` the loss sees the fake-quantized prunable
        weights (straight-through), so those products run on the
        fixed-point values.
        """
        steps = steps or self.steps
        sched = (constant(learning_rate) if learning_rate is not None
                 else warmup_cosine(self.peak_lr,
                                    min(self.warmup, max(steps // 2, 1)),
                                    steps))
        opt = adamw(sched)
        compressor = None
        if masks is not None:
            masks = _to_device(masks, self.device)
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
        qat = self._qat(quantize_bits)

        def loss(p, batch):
            return tfm.loss_fn(qat(p), cfg, batch, plan=plan)

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

    def serve_fns(self):
        # vlm configs serve text-only prompts: the engine's prompts are
        # tokens, and the transformer treats patches as an optional key
        return self._tfm.prefill, self._tfm.decode_step

    def evaluate(self, params, masks=None) -> float:
        losses = []
        with torch.no_grad():
            for i in range(self.eval_batches):
                loss, _ = self._tfm.loss_fn(params, self.cfg,
                                            self._batch(10_000 + i))
                losses.append(float(loss))
        return -float(np.mean(losses))


class EncDecAdapter(ModelAdapter):
    """Whisper-style encoder-decoder (the audio family) on synthetic
    mel-frame / transcript pairs (``SyntheticAudio``), trained through
    ``Trainer`` with AdamW.

    ``evaluate`` returns NEGATIVE decoder cross-entropy (higher is
    better).  Prunability covers encoder/decoder self-attention, MLPs
    and the decoder's cross-attention (``encdec_prunable``); the model
    has no tile plan, so a ticket retrains and serves dense on its
    masked weights, as in the reference.  Serving takes the engine's
    frames lane: a ``Request`` carries its encoder frames
    (``serve_frames``) beside the decoder prompt.  ``device`` defaults
    to "cuda" and raises without a card unless given "cpu".
    """

    family = "audio"

    def __init__(self, cfg, *, data=None, steps: int = 60,
                 batch_size: int = 4, seq_len: int = 32,
                 peak_lr: float = 3e-4, warmup: int = 10,
                 eval_batches: int = 2, log_every: int = 0, device="cuda"):
        from repro_torch.models import encdec
        self._mod = encdec
        self.cfg = cfg
        self.device = resolve_device(device)
        self.family = getattr(cfg, "family", "audio")
        self.prunable_pred = encdec_prunable
        self.data = data or SyntheticAudio(
            vocab_size=min(int(cfg.vocab_size), 256), seq_len=seq_len,
            n_frames=int(cfg.encoder_seq_len), d_model=int(cfg.d_model),
            seed=0)
        self.steps = steps
        self.batch_size = batch_size
        self.peak_lr, self.warmup = peak_lr, warmup
        self.eval_batches = eval_batches
        self.log_every = log_every
        self.last_plan_stats = PlanStats()
        self.last_metrics: Dict[str, float] = {}

    # -- protocol ----------------------------------------------------------
    def init_params(self, gen: torch.Generator):
        """Parameters drawn from ``gen`` (a generator on the adapter's
        device)."""
        return self._mod.init_params(gen, self.cfg, device=self.device)

    def _batch(self, step):
        b = self.data.batch(step, self.batch_size)
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in b.items()}

    def train(self, params, masks=None, steps=None, *, quantize_bits=None):
        steps = steps or self.steps
        sched = warmup_cosine(self.peak_lr,
                              min(self.warmup, max(steps // 2, 1)), steps)
        opt = adamw(sched)
        if masks is not None:
            masks = _to_device(masks, self.device)
            opt = masked(opt, masks)
            params = apply_masks(params, masks)
        qat = self._qat(quantize_bits)
        cfg, mod = self.cfg, self._mod

        def loss(p, batch):
            return mod.loss_fn(qat(p), cfg, batch)

        trainer = Trainer(
            loss_fn=loss, optimizer=opt, params=params,
            data_iter=DataPipeline(self._batch, prefetch=0),
            device=self.device)
        self.last_metrics = trainer.run(steps, log_every=self.log_every)
        return trainer.state.params

    def evaluate(self, params, masks=None) -> float:
        losses = []
        with torch.no_grad():
            for i in range(self.eval_batches):
                loss, _ = self._mod.loss_fn(params, self.cfg,
                                            self._batch(10_000 + i))
                losses.append(float(loss))
        return -float(np.mean(losses))

    def serve_fns(self):
        # requests with frames take the engine's enc-dec prefill lane
        # ({"tokens", "frames"}, exact length); the decoder's step has
        # the LM signature
        return self._mod.prefill, self._mod.decode_step

    def serve_frames(self, uid: int = 0) -> np.ndarray:
        """Deterministic synthetic encoder frames (T_enc, d_model) for
        one request: the serving-side analogue of ``SyntheticAudio``."""
        rng = np.random.RandomState(uid)
        return rng.randn(self.cfg.encoder_seq_len,
                         self.cfg.d_model).astype(np.float32) * 0.1
