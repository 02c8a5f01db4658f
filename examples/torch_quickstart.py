"""Quickstart on the PyTorch port: ReaLPrune a small CNN and inspect the
hardware savings.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Runs the full Algorithm 1 loop (train → crossbar-aware prune → accuracy
gate → lottery rewind) through the ``repro_torch.api`` session layer on
a small CNN with synthetic CIFAR-like data, then reports sparsity,
crossbar savings, ReRAM training speedup, and the block-sparse
kernels' tile savings for the resulting masks.  ``--device`` defaults
to ``cuda``; ``cpu`` runs the kernels' plain versions.
"""
import argparse
import sys
sys.path.insert(0, "src")

import numpy as np

from repro_torch.api import CNNAdapter, PruningSession
from repro_torch.configs import CNNConfig, ConvSpec, PruneConfig
from repro_torch.core import perf_model as pm
from repro_torch.core.crossbar import conv_to_matrix
from repro_torch.core.hardware import cnn_activation_volumes
from repro_torch.core.masks import tree_flatten_with_path
from repro_torch.data import SyntheticImages
from repro_torch.kernels.ops import tile_density

CFG = CNNConfig(
    name="quickstart-cnn", family="cnn",
    convs=(ConvSpec(32, pool=True), ConvSpec(64, pool=True), ConvSpec(64)),
    fc=(), num_classes=10, image_size=16)


def show(e):
    print(f"  iter {e.iteration:2d} [{e.granularity:7s}] "
          f"sparsity {e.sparsity_before:.2f}→{e.sparsity_after:.2f} "
          f"acc {e.accuracy:.3f} {'keep' if e.accepted else 'undo'}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args()

    print("== ReaLPrune quickstart ==")
    adapter = CNNAdapter(CFG, data=SyntheticImages(image_size=16, noise=0.25),
                         steps=80, batch_size=64, lr=0.05, lr_decay=0.95,
                         decay_every=40, eval_batches=3, device=args.device)
    session = PruningSession(
        adapter, PruneConfig(prune_fraction=0.15, max_iters=12,
                             accuracy_tolerance=0.02),
        callbacks=[show])
    res = session.run()
    print(f"final sparsity: {res.sparsity:.3f}")

    rep = session.hardware_report(
        activation_volumes=cnn_activation_volumes(CFG))
    print(f"crossbar cell savings: {rep.cell_savings:.3f}  "
          f"crossbars: {rep.xbars_needed}/{rep.xbars_unpruned} "
          f"(-{rep.xbar_savings:.1%})  "
          f"activation savings: {rep.activation_savings:.3f}")

    vols = cnn_activation_volumes(CFG)
    unpruned = pm.conv_layer_perf(
        CFG, {l.path: l.stats.n_xbars for l in rep.layers}, vols,
        act_cells_per_xbar=session.geometry.cells)
    pruned = pm.conv_layer_perf(
        CFG, {l.path: l.stats.xbars_needed_packed for l in rep.layers}, vols,
        act_cells_per_xbar=session.geometry.cells)
    print(f"ReRAM iso-area training speedup: "
          f"{pm.iso_area_speedup(unpruned, pruned):.2f}x")

    # the card's view: tile savings the block-sparse kernels skip
    masks = dict(tree_flatten_with_path(res.masks))
    for pth in ("convs/2/w",):
        leaf = np.asarray(masks[pth].cpu())
        dens = tile_density(conv_to_matrix(leaf),
                            session.geometry.rows, session.geometry.cols)
        print(f"bsmm tile density for {pth}: {dens:.2f} "
              f"(block-sparse compute saving {1 - dens:.1%})")


if __name__ == "__main__":
    main()
