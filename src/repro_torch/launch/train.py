"""Production training launcher (a port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b \\
        [--smoke] [--steps N] [--ckpt DIR] [--zero1] [--device cuda]

The stack is the reference's: ``SyntheticLM`` data through a
prefetching ``DataPipeline``, AdamW under a warmup-cosine schedule, a
``Trainer`` with async checkpoints every 50 steps, a 60 s step
deadline and ``SkipStraggler``, under ``Supervisor(max_restarts=3)``,
with ``ShardingRules`` installed for the mesh.

Which config runs where (the reference picks the reduced f32 config
under ``--smoke`` or on a one-device host, its CPU container, and the
full config on a pod):

  * ``--smoke`` → ``scaled_down(..., dtype="float32")`` on a (1, 1)
    mesh, on ``--device`` (``--device cpu`` runs the plain versions).
  * otherwise → the full config.  In a single process it runs on a
    (1, 1) mesh on the card: one H100 holds llama3.2-3b whole, so this
    is the reference's production branch on one card.  When the
    process group has the production mesh's ranks (``torchrun
    --nproc-per-node 256``, 512 with ``--multi-pod``) it builds
    ``make_production_mesh`` and trains rank-local: each rank holds its
    shards (``ShardedModel``), takes its data rows of every batch, runs
    the tensor-parallel forward and backward (Megatron's conjugate
    collectives) and sums the gradients over the data axes before the
    update (``distributed.tensor_parallel.train_loss`` and
    ``data_grad_sum``), every family on either axis.  ``python -m
    repro_torch.launch.dryrun`` traces this branch's step on rank 0.

``--zero1`` on the production mesh cuts the optimizer state over
``data`` (ZeRO-1: ``train.loop.make_train_step(zero1=True)``); with one
rank there is no data axis and it changes nothing (the reference's
launcher does not read it).  Pipeline parallelism is not used, as in
the reference.
"""
from __future__ import annotations

import argparse
import logging
import os
from typing import List, Optional

import torch
import torch.distributed as dist

from repro_torch._bridge import resolve_device
from repro_torch.data import DataPipeline, SyntheticLM
from repro_torch.distributed import sharding
from repro_torch.distributed.fault_tolerance import SkipStraggler, Supervisor
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.distributed.tensor_parallel import (ShardedModel,
                                                     data_rows, mesh_rules,
                                                     train_loss)
from repro_torch.launch.mesh import launcher_mesh
from repro_torch.launch.steps import model_module
from repro_torch.models.layers import _dtype
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.train import Trainer


def init_params(cfg, device):
    """The launcher's parameters: seed 0, drawn on ``device``."""
    gen = torch.Generator(device=device).manual_seed(0)
    return model_module(cfg).init_params(gen, cfg, device=device)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    return ap


def main(argv: Optional[List[str]] = None):
    """Train and print ``done at step N``; returns the trainer."""
    args = parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    dev = resolve_device(args.device)
    with launcher_mesh(args.arch, args.smoke, multi_pod=args.multi_pod,
                       device=dev) as (cfg, mesh, multi):
        rules = mesh_rules(mesh, cfg) if multi else ShardingRules(mesh)
        sharding.install(rules)
        mod = model_module(cfg)
        params = init_params(cfg, dev)
        sharded = None
        if multi:
            sharded = ShardedModel.from_full(params, cfg, rules)
            params, loss_fn = sharded.params, train_loss(sharded)
        else:
            def loss_fn(p, b):
                return mod.loss_fn(p, cfg, b)
        gen = SyntheticLM(vocab_size=min(cfg.vocab_size, 1024),
                          seq_len=args.seq)
        # the reference's f32 zeros promote a bf16 model to f32; the
        # port's matmuls take one dtype, so the frames take the model's
        frames = (args.batch, cfg.encoder_seq_len, cfg.d_model)

        def batch_fn(step):
            b = gen.batch(step, args.batch)
            out = {"tokens": b["tokens"], "labels": b["labels"]}
            if cfg.is_encoder_decoder:
                out["frames"] = torch.zeros(frames, dtype=_dtype(cfg.dtype))
            return data_rows(out, rules) if multi else out

        pipes = []          # every trainer's prefetch thread, stopped at the end

        ckpt = args.ckpt
        if multi and ckpt:              # one directory a rank's shards
            ckpt = os.path.join(ckpt, f"rank{dist.get_rank()}")

        def make_trainer():
            pipes.append(DataPipeline(batch_fn, prefetch=2))
            return Trainer(
                loss_fn=loss_fn,
                optimizer=adamw(warmup_cosine(args.lr, 20, args.steps)),
                params=params,
                data_iter=pipes[-1],
                ckpt_dir=ckpt, ckpt_every=50, async_ckpt=True,
                step_deadline_s=60.0,
                on_straggler=SkipStraggler(deadline_s=60.0),
                sharded=sharded, zero1=args.zero1 and multi,
                device=dev)

        sup = Supervisor(make_trainer=make_trainer, max_restarts=3)
        try:
            trainer = sup.run(args.steps)
        finally:
            for pipe in pipes:
                pipe.close()
    print(f"done at step {trainer.state.step}")
    return trainer


if __name__ == "__main__":
    main()
