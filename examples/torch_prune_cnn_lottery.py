"""Paper pipeline on the PyTorch port at configurable scale: ReaLPrune a
ResNet-18-family CNN on CIFAR-like data, export the winning ticket, and
verify the ticket trains from scratch with no accuracy loss (paper
§V.B) — all through the ``repro_torch.api`` session layer.

    PYTHONPATH=src python examples/torch_prune_cnn_lottery.py [--full] \
        [--device cpu]

Default: the resnet18 config scaled down by the family registry
(``make_adapter(..., scale="tiny")`` — same block structure, capped
channels).  ``--full``: the real resnet18 config, which also picks up
the family's tuned staged recipe (``cnn-full``: paper schedule + int8
QAT) from the registry.  ``--recipe`` overrides with any registered
recipe name or a recipe .json path.  ``--device`` defaults to ``cuda``.

CLI parity — the same run from the shell:

    python -m repro_torch.api prune --arch resnet18 --scale tiny \
        --recipe paper-quant --rounds 10 --ticket /tmp/realprune_ticket
"""
import argparse
import sys
sys.path.insert(0, "src")

from repro_torch.api import PruningSession, make_adapter
from repro_torch.configs import PruneConfig
from repro_torch.core import lottery
from repro_torch.core.hardware import cnn_activation_volumes


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--arch", default="resnet18")
    ap.add_argument("--steps", type=int, default=None,
                    help="retrain steps per round (default 120; when "
                         "set explicitly it also overrides the "
                         "recipe's per-stage budgets)")
    ap.add_argument("--recipe", default=None,
                    help="staged prune program (name from `python -m "
                         "repro_torch.api recipes` or a .json path); "
                         "default: the family schedule at --scale tiny, "
                         "the tuned cnn-full recipe at --full")
    ap.add_argument("--ticket-dir", default="/tmp/realprune_ticket")
    ap.add_argument("--ckpt", default=None,
                    help="session checkpoint dir (resume a killed run)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args()

    # the family registry picks the adapter class, prunability
    # predicates, and prune recipe/schedule for us — this script works
    # for ANY registered CNN (and, family aside, any arch at all)
    adapter = make_adapter(
        args.arch, scale="full" if args.full else "tiny",
        steps=args.steps or 120, batch_size=128,     # paper: batch size 128
        lr=0.1, lr_decay=0.95,                       # paper: LR .1, -5%/epoch
        eval_batches=4, eval_batch_size=256, device=args.device)
    cfg = adapter.cfg

    print(f"== ReaLPrune lottery pipeline: {cfg.name} ==")
    session = PruningSession(
        adapter, PruneConfig(prune_fraction=0.25, max_iters=10,
                             accuracy_tolerance=0.02),
        recipe=args.recipe, ckpt_dir=args.ckpt)
    if args.steps:
        # an explicit --steps wins over per-stage retrain budgets,
        # whether the recipe came from --recipe or the family registry
        session.recipe = session.recipe.with_retrain_steps(args.steps)
    print(f"recipe: {session.recipe.name} "
          f"({' -> '.join(s.name for s in session.recipe.stages)})")
    res = session.run()
    print(f"winning-ticket sparsity: {res.sparsity:.3f}"
          + (f" (int{session.quantize_bits} QAT accepted)"
             if session.quantize_bits else ""))

    # export/import the ticket (paper §V.C: prune once, reuse forever)
    session.export_ticket(args.ticket_dir)
    w_back, m_back = lottery.import_ticket(args.ticket_dir,
                                           session.init_params, res.masks)
    print(f"ticket exported to {args.ticket_dir} and re-imported")

    # train the ticket from scratch — no accuracy loss vs baseline
    baseline_params = adapter.train(session.init_params, None)
    base_acc = adapter.evaluate(baseline_params)
    ticket_params = adapter.train(lottery.rewind(w_back, m_back), m_back)
    ticket_acc = adapter.evaluate(ticket_params, m_back)
    print(f"baseline acc {base_acc:.3f} | ticket acc {ticket_acc:.3f} "
          f"(sparsity {res.sparsity:.1%})")

    rep = session.hardware_report(
        activation_volumes=cnn_activation_volumes(cfg))
    print(f"hardware: cell savings {rep.cell_savings:.1%}, "
          f"crossbars {rep.xbars_needed}/{rep.xbars_unpruned} "
          f"(-{rep.xbar_savings:.1%})")


if __name__ == "__main__":
    main()
