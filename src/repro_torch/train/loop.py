"""Training loop: the masked train step, microbatching, remat, and a
host-side Trainer (port of ``repro.train.loop``).

The train step keeps the reference's functional signature
``(params, opt_state, batch) -> (params, opt_state, metrics)``.
Gradients come from ``torch.autograd.grad`` over the flattened
parameter leaves, so a retrain through a tile plan runs the block-sparse
backward kernels.  PyTorch runs eagerly: there is no ``jit``, and the
reference's buffer donation becomes the optimizers' in-place state
update (``optim.optimizers``).

``Trainer`` adds the operational layer: auto-resume from the newest
committed checkpoint (``checkpoint.CheckpointManager``, the reference's
on-disk format), periodic saves, deterministic data, a straggler
deadline and hook.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._bridge import (resolve_device, tree_leaves, tree_map,
                                 tree_unflatten)
from repro_torch.checkpoint import CheckpointManager
from repro_torch.optim import Optimizer

log = logging.getLogger("train")


@dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int = 0
    aux: Any = None                  # non-gradient model state (e.g. BN stats)


def _detach(tree):
    return tree_map(lambda t: t.detach() if torch.is_tensor(t) else t, tree)


def _value_and_grad(fn: Callable, params, *args):
    """(loss, aux, grads) of ``fn(params, *args) -> (loss, aux)``; grads
    mirror ``params`` (zeros where a leaf does not reach the loss)."""
    leaves = tree_leaves(params)
    req = [t.detach().requires_grad_(True) for t in leaves]
    with torch.enable_grad():
        loss, aux = fn(tree_unflatten(params, req), *args)
        grads = torch.autograd.grad(loss, req, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    return loss.detach(), _detach(aux), tree_unflatten(params, grads)


def make_train_step(loss_fn: Callable, optimizer: Optimizer,
                    microbatch: Optional[int] = None,
                    remat: bool = False,
                    compressor=None,
                    has_aux_state: bool = False):
    """Build a train step.

    loss_fn: (params, batch) -> (loss, metrics_dict)
    microbatch: if set, split the batch's leading axis into chunks and
        accumulate f32 gradients over them.
    remat: run loss_fn under ``torch.utils.checkpoint`` (activation
        rematerialisation).
    compressor: optional gradient compressor (``TopKCompressor`` /
        ``MaskAwareCompressor``); its error-feedback residual is threaded
        through opt_state under the key "_compress_residual".
    has_aux_state: the model threads non-gradient state through the
        step.  loss_fn then has signature (params, state, batch) ->
        (loss, (new_state, metrics)) and the step is (params, opt_state,
        state, batch) -> (params, opt_state, new_state, metrics).
    """
    lf = loss_fn
    if remat:
        def lf(*args):
            return checkpoint(loss_fn, *args, use_reentrant=False,
                              preserve_rng_state=False)
    if has_aux_state:
        if microbatch is not None or compressor is not None:
            raise ValueError("aux state is not supported together with "
                             "microbatching or gradient compression")

        def aux_step_fn(params, opt_state, state, batch):
            loss, (new_state, metrics), grads = _value_and_grad(
                lf, params, state, batch)
            with torch.no_grad():
                new_params, new_opt = optimizer.update(grads, opt_state,
                                                       params)
            metrics = dict(metrics)
            metrics["loss"] = loss
            return new_params, new_opt, new_state, metrics

        return aux_step_fn

    def step_fn(params, opt_state, batch):
        if compressor is not None:
            opt_state, residual = (opt_state["_opt"],
                                   opt_state["_compress_residual"])
        if microbatch is None:
            loss, metrics, grads = _value_and_grad(lf, params, batch)
        else:
            n = tree_leaves(batch)[0].shape[0] // microbatch
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in tree_leaves(params)]
            loss = None
            for i in range(n):
                chunk = tree_map(
                    lambda x: x[i * microbatch:(i + 1) * microbatch], batch)
                part, _, g = _value_and_grad(lf, params, chunk)
                for a, gi in zip(acc, tree_leaves(g)):
                    a.add_(gi)
                loss = part.float() if loss is None else loss + part
            grads = tree_unflatten(params, [a / n for a in acc])
            loss = loss / n
            metrics = {}
        metrics = dict(metrics)
        with torch.no_grad():
            if compressor is not None:
                grads, residual, cstats = compressor.compress(grads, residual)
                metrics["sent_fraction"] = cstats["sent_fraction"]
            new_params, new_opt = optimizer.update(grads, opt_state, params)
        if compressor is not None:
            new_opt = {"_opt": new_opt, "_compress_residual": residual}
        metrics["loss"] = loss
        return new_params, new_opt, metrics

    return step_fn


def init_opt_state(optimizer: Optimizer, params, compressor=None):
    """Optimizer state, wrapping the compressor residual when present."""
    state = optimizer.init(params)
    if compressor is not None:
        return {"_opt": state, "_compress_residual": compressor.init(params)}
    return state


class Trainer:
    """Operational wrapper: resume → train → checkpoint → (survive).

    ``data_iter`` yields dicts of arrays or tensors; each batch is moved
    to ``device`` (default "cuda": without a card it raises unless given
    ``device="cpu"``).  With ``ckpt_dir`` the trainer resumes from the
    newest committed checkpoint there, saves every ``ckpt_every`` steps
    and at the end of ``run`` (params, optimizer state, step, and the
    aux state when there is one), keeping the newest ``keep`` committed
    steps; ``async_ckpt`` writes them on a background thread.
    ``donate`` is accepted for the reference's signature and changes
    nothing: the port's optimizer already updates the parameters in
    place, which is what donating the buffers buys the reference."""

    def __init__(self, *, loss_fn, optimizer: Optimizer, params,
                 data_iter, ckpt_dir: Optional[str] = None,
                 ckpt_every: int = 100, keep: int = 3,
                 async_ckpt: bool = True,
                 microbatch: Optional[int] = None, remat: bool = False,
                 compressor=None,
                 aux_state=None,
                 donate: bool = True,
                 step_deadline_s: Optional[float] = None,
                 on_straggler: Optional[Callable[[int, float], None]] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self._has_aux = aux_state is not None
        self.step_fn = make_train_step(loss_fn, optimizer,
                                       microbatch=microbatch, remat=remat,
                                       compressor=compressor,
                                       has_aux_state=self._has_aux)
        self.optimizer = optimizer
        self.data_iter = data_iter
        self.ckpt = (CheckpointManager(ckpt_dir, keep=keep,
                                       async_save=async_ckpt)
                     if ckpt_dir else None)
        self.ckpt_every = ckpt_every
        self.state = TrainState(
            params, init_opt_state(optimizer, params, compressor), 0,
            aux_state)
        self.step_deadline_s = step_deadline_s
        # the default handler must not hold ``self``: a cycle would keep a
        # dropped trainer (its optimizer moments) alive until a cyclic
        # collection, gigabytes a round in a pruning session
        self.on_straggler = on_straggler or (
            lambda step, dt, deadline=step_deadline_s: log.warning(
                "straggler: step %d took %.2fs (deadline %.2fs)", step, dt,
                deadline))
        self._maybe_resume()

    def _maybe_resume(self):
        if self.ckpt is None:
            return
        tmpl = {"params": self.state.params,
                "opt_state": self.state.opt_state,
                "step": np.zeros((), np.int32)}
        if self._has_aux:
            tmpl["aux"] = self.state.aux
        step, tree = self.ckpt.restore(tmpl)
        if step is not None:
            self.state = TrainState(tree["params"], tree["opt_state"],
                                    int(tree["step"]),
                                    tree.get("aux", self.state.aux))
            log.info("resumed from checkpoint at step %d", self.state.step)

    def save(self, blocking: bool = False):
        if self.ckpt is None:
            return
        tree = {"params": self.state.params,
                "opt_state": self.state.opt_state,
                "step": np.asarray(self.state.step, np.int32)}
        if self._has_aux:
            tree["aux"] = self.state.aux
        self.ckpt.save(self.state.step, tree, blocking=blocking)

    def _batch(self):
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in next(self.data_iter).items()}

    def run(self, num_steps: int, log_every: int = 50) -> Dict[str, float]:
        metrics = {}
        target = self.state.step + num_steps
        while self.state.step < target:
            batch = self._batch()
            t0 = time.perf_counter()
            if self._has_aux:
                params, opt_state, aux, metrics = self.step_fn(
                    self.state.params, self.state.opt_state,
                    self.state.aux, batch)
            else:
                params, opt_state, metrics = self.step_fn(
                    self.state.params, self.state.opt_state, batch)
                aux = self.state.aux
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            if self.step_deadline_s is not None and dt > self.step_deadline_s:
                self.on_straggler(self.state.step, dt)
            self.state = TrainState(params, opt_state, self.state.step + 1,
                                    aux)
            if self.ckpt is not None and self.state.step % self.ckpt_every == 0:
                self.save()
            if log_every and self.state.step % log_every == 0:
                log.info("step %d loss %.4f (%.3fs)", self.state.step,
                         float(metrics["loss"]), dt)
        if self.ckpt is not None:
            self.save(blocking=True)
            self.ckpt.wait()
        return {k: float(v) for k, v in metrics.items()}
