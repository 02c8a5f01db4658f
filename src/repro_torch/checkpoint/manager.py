"""Atomic checkpointing (port of ``repro.checkpoint.manager``, same
on-disk format, so either package restores the other's checkpoints).

Layout (one directory per step):

    ckpt_dir/
      step_000123/
        manifest.json        # leaf path → file map + dtype/shape
        leaf_00000.npy ...   # one file per leaf, in the reference's order
      step_000123.COMMITTED  # atomic commit marker (rename-last)
      LATEST                 # text file holding the newest committed step

A checkpoint is visible only after its COMMITTED marker exists, so a
writer that crashes leaves at most a garbage step_* directory, never a
torn "latest".  ``restore`` fills a template by leaf path: a tensor
template leaf comes back as a tensor of its dtype on its device (the
port stores bfloat16 leaves as float32, which is exact), a numpy
template leaf as the stored array.  Async mode serialises on a
background thread once the leaves are on the host.

On a mesh, ``restore(..., shardings=)`` reads each leaf as the full
array and places this rank's shard of it (``distributed.sharding.
place``), and ``save(..., shardings=)`` gathers each sharded leaf back
to its full array and writes it from rank 0 alone, so the on-disk
format stays the reference's whatever mesh wrote it.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch._bridge import to_numpy, tree_map
from repro_torch.core.masks import tree_flatten_with_path, tree_map_with_path
from repro_torch.distributed.sharding import (LeafSharding, gather_full,
                                              place)


def pack_json(obj) -> np.ndarray:
    """JSON-serializable object → uint8 leaf for checkpoint pytrees
    (variable-length session state rides the array-only format as UTF-8
    bytes; the restore template is any uint8 array)."""
    return np.frombuffer(json.dumps(obj).encode("utf-8"), np.uint8).copy()


def unpack_json(arr, default=None):
    """Inverse of ``pack_json``; ``default`` for empty/absent leaves."""
    data = np.asarray(to_numpy(arr), np.uint8).tobytes()
    if not data:
        return default
    return json.loads(data.decode("utf-8"))


def save_pytree(tree, directory: str):
    """Write one pytree to ``directory`` (no commit semantics)."""
    os.makedirs(directory, exist_ok=True)
    manifest = {"leaves": [], "version": 1}
    for i, (path, leaf) in enumerate(tree_flatten_with_path(tree)):
        entry = {"path": path, "index": i}
        if leaf is None:
            entry["none"] = True
        else:
            arr = np.asarray(to_numpy(leaf))
            fname = f"leaf_{i:05d}.npy"
            np.save(os.path.join(directory, fname), arr)
            entry.update({"file": fname, "dtype": str(arr.dtype),
                          "shape": list(arr.shape)})
        manifest["leaves"].append(entry)
    with open(os.path.join(directory, "manifest.json"), "w") as f:
        json.dump(manifest, f)


def _shardings_by_path(shardings) -> dict:
    """{leaf path: LeafSharding} of a shardings pytree (None: {})."""
    out = {}
    if shardings is not None:
        for p, sh in tree_flatten_with_path(shardings):
            if isinstance(sh, LeafSharding):
                out[p] = sh
    return out


def load_pytree(directory: str, template, shardings=None):
    """Load into the structure of ``template`` (leaves the checkpoint
    lacks keep the template's value); ``shardings`` (a pytree of
    ``LeafSharding`` or None per leaf) places each listed leaf's
    rank-local shard."""
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    flat_sh = _shardings_by_path(shardings)

    def fill(p, leaf):
        e = by_path.get(p)
        if e is None or e.get("none"):
            return leaf
        arr = np.load(os.path.join(directory, e["file"]))
        if torch.is_tensor(leaf):
            out = torch.as_tensor(arr)
            if p in flat_sh:
                out = place(out, flat_sh[p])
            return out.to(device=leaf.device, dtype=leaf.dtype)
        return arr

    return tree_map_with_path(fill, template)


def gather_pytree(tree, shardings):
    """Each leaf sharded by its ``LeafSharding`` gathered back to the
    full array (every rank of the mesh takes part)."""
    flat_sh = _shardings_by_path(shardings)
    return tree_map_with_path(
        lambda p, l: gather_full(l, flat_sh[p]) if p in flat_sh else l, tree)


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3, async_save: bool = False):
        self.root = root
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(root, exist_ok=True)

    # -- paths ------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:08d}")

    def _marker(self, step: int) -> str:
        return self._step_dir(step) + ".COMMITTED"

    # -- save -------------------------------------------------------------
    def save(self, step: int, tree, blocking: Optional[bool] = None,
             shardings=None):
        """Checkpoint ``tree`` at ``step`` (atomically).  ``shardings``
        (the tree's ``LeafSharding`` pytree): every rank calls, the
        sharded leaves are gathered, rank 0 writes (blocking) and the
        ranks meet at a barrier once it is committed."""
        if shardings is not None:
            full = gather_pytree(tree, shardings)
            if dist.get_rank() == 0:
                self.save(step, full, blocking=True)
            dist.barrier()
            return
        host_tree = tree_map(lambda x: np.array(to_numpy(x), copy=True), tree)
        # one write at a time: a blocking save of the step an async save
        # is still writing would race it on the same temporary directory
        self.wait()
        if self.async_save and not (blocking or False):
            self._thread = threading.Thread(
                target=self._write, args=(step, host_tree), daemon=True)
            self._thread.start()
        else:
            self._write(step, host_tree)

    def _write(self, step: int, host_tree):
        d = self._step_dir(step)
        tmp = d + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        save_pytree(host_tree, tmp)
        if os.path.exists(d):
            shutil.rmtree(d)
        os.rename(tmp, d)
        with open(self._marker(step), "w") as f:
            f.write(str(time.time()))
        with open(os.path.join(self.root, "LATEST.tmp"), "w") as f:
            f.write(str(step))
        os.replace(os.path.join(self.root, "LATEST.tmp"),
                   os.path.join(self.root, "LATEST"))
        self._gc()

    def wait(self):
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()

    # -- restore ----------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        committed = []
        for name in os.listdir(self.root):
            m = re.fullmatch(r"step_(\d+)\.COMMITTED", name)
            if m and os.path.isdir(self._step_dir(int(m.group(1)))):
                committed.append(int(m.group(1)))
        return max(committed) if committed else None

    def restore(self, template, step: Optional[int] = None, shardings=None):
        """Load the newest committed checkpoint (or ``step``) into the
        template's structure, each leaf ``shardings`` lists as this
        rank's shard; returns (step, tree) or (None, template)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None, template
        return step, load_pytree(self._step_dir(step), template, shardings)

    # -- retention ---------------------------------------------------------
    def _gc(self):
        steps = []
        for name in os.listdir(self.root):
            m = re.fullmatch(r"step_(\d+)\.COMMITTED", name)
            if m:
                steps.append(int(m.group(1)))
        for s in sorted(steps)[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
            try:
                os.remove(self._marker(s))
            except OSError:
                pass
