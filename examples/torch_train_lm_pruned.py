"""End-to-end run on the PyTorch port: train a ~100M-parameter LM
for a few hundred steps with the full production stack — a
registry-built adapter (``repro_torch.api.make_adapter``) over
``Trainer`` (checkpoint/resume/straggler policy), masked optimizer —
then apply crossbar-aware (tile) pruning via
``repro_torch.api.structured_prune`` and continue training the ticket.

    PYTHONPATH=src python examples/torch_train_lm_pruned.py \
        [--steps 200] [--prune-steps 100] [--ckpt /tmp/lm_ckpt] \
        [--device cpu]

The model is the xlstm-125m architecture scaled to ~100M params with a
small vocab; the same script runs any --arch.  ``--device`` defaults
to ``cuda``.  CLI parity: ``python -m repro_torch.api prune --arch
xlstm-125m --scale tiny``.
"""
import argparse
import sys
sys.path.insert(0, "src")

import torch

from repro_torch._bridge import tree_leaves
from repro_torch.api import get_recipe, make_adapter, structured_prune
from repro_torch.configs import PruneConfig, get_arch, scaled_down
from repro_torch.core.hardware import analyze_masks
from repro_torch.core.masks import apply_masks, sparsity_fraction
from repro_torch.data import SyntheticLM


def build(arch: str):
    base = get_arch(arch)
    # ~100M params: d_model 1024, 12 layers, vocab 8192
    cfg = scaled_down(base, d_model=1024, n_layers=min(base.n_layers, 12),
                      n_heads=8, n_kv_heads=min(base.n_kv_heads, 4) or 4,
                      d_ff=3072 if base.d_ff else 0, head_dim=128,
                      vocab_size=8192, rnn_width=2048 if base.rnn_width
                      else None, dtype="float32")
    return cfg


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--prune-steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default="/tmp/lm_pruned_ckpt")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args()

    cfg = build(args.arch)
    # make_adapter accepts a pre-scaled config instance: the family
    # registry still picks the adapter class and prunability data, so
    # this script needs no per-family branching (works for --arch
    # yi-6b, deepseek-v3-671b, recurrentgemma-2b, ...)
    adapter = make_adapter(cfg, data=SyntheticLM(vocab_size=256,
                                                 seq_len=args.seq, seed=0),
                           steps=args.steps, batch_size=args.batch,
                           peak_lr=3e-4, warmup=20, log_every=25,
                           step_deadline_s=30.0, device=args.device)
    params = adapter.init_params(
        torch.Generator(device=adapter.device).manual_seed(0))
    n = sum(x.numel() for x in tree_leaves(params))
    print(f"== {cfg.name}: {n / 1e6:.1f}M params, "
          f"{args.steps} steps @ B={args.batch} S={args.seq} ==")

    trained = adapter.train(params, None, ckpt_dir=args.ckpt)
    print(f"dense phase done: loss {adapter.last_metrics['loss']:.4f} "
          f"(resumable checkpoints in {args.ckpt})")

    # ---- crossbar-aware pruning of the trained LM ----
    # the one-shot schedule is read off the registered "paper" recipe —
    # recipes are the single source of truth for prune programs, even
    # when (as here) the accuracy gate is skipped for a fixed schedule
    prune_cfg = PruneConfig()
    schedule = [(s.granularity, 0.2)
                for s in get_recipe("paper").stages if s.kind == "prune"]
    masks = structured_prune(trained, schedule,
                             prunable=adapter.prunable, cfg=prune_cfg)
    print(f"tile-pruned to sparsity {sparsity_fraction(masks):.1%} "
          f"({'→'.join(g for g, _ in schedule)}, crossbar-aware)")

    # lottery rewind to the dense-phase start, retrain the ticket
    pruned = apply_masks(trained, masks)
    adapter.train(pruned, masks, steps=args.prune_steps,
                  start_step=args.steps, learning_rate=1e-4)
    print(f"pruned fine-tune: loss {adapter.last_metrics['loss']:.4f}")

    # hardware view of the pruned LM at the config's crossbar geometry
    rep = analyze_masks(masks, adapter.conv_pred,
                        xbar_rows=prune_cfg.xbar_rows,
                        xbar_cols=prune_cfg.xbar_cols)
    print(f"crossbars: {rep.xbars_needed}/{rep.xbars_unpruned} "
          f"(-{rep.xbar_savings:.1%}); cell savings {rep.cell_savings:.1%}")


if __name__ == "__main__":
    main()
