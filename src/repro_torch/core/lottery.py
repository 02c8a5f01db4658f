"""Lottery-ticket utilities: rewind snapshots and winning-ticket export
(port of ``repro.core.lottery``).

The winning ticket is (w_initial, masks).  ``export_ticket`` /
``import_ticket`` serialise it in the reference's layout — one
``ticket.npz`` holding ``w:<path>`` and ``m:<path>`` arrays plus a
``ticket.json`` of metadata — so a ticket pruned by either package
loads in the other (``np.load`` reads stored and deflated members
alike).  The reference writes ``str(treedef)`` of a JAX
treedef into ``ticket.json``; the port writes its list of mask paths
there instead.  Neither package reads that field back: loading fills
the caller's templates by path.
"""
from __future__ import annotations

import json
import os
import zipfile

import numpy as np
import torch

from repro_torch._bridge import to_numpy, tree_map
from repro_torch.core.masks import (apply_masks, tree_flatten_with_path,
                                    tree_map_with_path)


def snapshot(params):
    """Host-side numpy copy of w_initial (t = 0)."""
    return tree_map(lambda x: np.array(to_numpy(x), copy=True), params)


def rewind(w_init, masks):
    """Winning-ticket weights: w_initial ⊙ mask (numpy snapshots come
    back as CPU tensors)."""
    return apply_masks(tree_map(torch.as_tensor, w_init), masks)


def export_ticket(path: str, w_init, masks, meta=None):
    """Serialise (w_init, masks) plus optional JSON metadata (e.g. the
    resolved prune recipe, quantization bits), read back by
    ``ticket_meta``.

    Masks are deflated (they compress tenfold or more); weights are
    stored as they are: random float data barely compresses, and
    deflating it takes minutes for a full-width LM."""
    os.makedirs(path, exist_ok=True)
    with zipfile.ZipFile(os.path.join(path, "ticket.npz"), "w",
                         allowZip64=True) as zf:
        for prefix, tree in (("w", w_init), ("m", masks)):
            for p, leaf in tree_flatten_with_path(tree):
                if leaf is None:
                    continue
                info = zipfile.ZipInfo(f"{prefix}:{p}.npy")
                info.compress_type = (zipfile.ZIP_DEFLATED if prefix == "m"
                                      else zipfile.ZIP_STORED)
                with zf.open(info, "w", force_zip64=True) as f:
                    np.lib.format.write_array(f, to_numpy(leaf),
                                              allow_pickle=False)
    treedef = [p for p, _ in tree_flatten_with_path(masks)]
    with open(os.path.join(path, "ticket.json"), "w") as f:
        json.dump({"treedef": f"repro_torch mask paths {treedef}",
                   "meta": meta or {}}, f)


def ticket_meta(path: str) -> dict:
    """Metadata embedded at export time ({} for pre-metadata tickets)."""
    fname = os.path.join(path, "ticket.json")
    if not os.path.exists(fname):
        return {}
    with open(fname) as f:
        return json.load(f).get("meta", {}) or {}


def import_ticket(path: str, params_template, masks_template):
    """Load a ticket into pytrees shaped like the given templates.

    A tensor template leaf comes back as a tensor of its dtype on its
    device; a numpy leaf as the stored array; a leaf the ticket lacks
    stays as the template has it."""
    data = np.load(os.path.join(path, "ticket.npz"))

    def load(prefix, template):
        def f(p, leaf):
            key = f"{prefix}:{p}"
            if leaf is None or key not in data:
                return leaf
            arr = data[key]
            if torch.is_tensor(leaf):
                return torch.as_tensor(arr).to(device=leaf.device,
                                               dtype=leaf.dtype)
            return arr
        return tree_map_with_path(f, template)

    return load("w", params_template), load("m", masks_template)
