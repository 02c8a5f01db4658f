"""Sharding rules: logical-axis assignment with divisibility fallbacks (a
port of ``repro.distributed.sharding``; the spec math is the
reference's, letter for letter).

Parallelism layout:
  * DP  — batch over ('pod', 'data')
  * TP  — projections column/row-parallel over 'model'
  * EP  — MoE expert axis over 'model'
  * SP  — decode KV caches sequence-sharded over 'model' when head
          counts don't divide

A spec is a tuple with one entry per tensor dim: a mesh-axis name, a
tuple of names, or ``None`` (replicated), as ``PartitionSpec`` reads.
A ``*_shardings`` result pairs each leaf with a ``LeafSharding``: the
mesh, the spec and the ``torch.distributed.tensor`` placements it means
(``Shard(d)`` or ``Replicate()`` per mesh dim) — the port's counterpart
of ``NamedSharding``.  ``place`` cuts a full tensor to this rank's shard
of a ``LeafSharding``.

Every rule degrades gracefully: a dimension is sharded only when the
mesh axis divides it, so the same code runs on (16, 16), (2, 16, 16)
and a one-rank mesh (all specs replicated).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.masks import tree_map_with_path
from repro_torch.launch.mesh import mesh_axes

try:                                        # torch >= 2.4
    from torch.distributed.tensor import Replicate, Shard
except ImportError:                         # pragma: no cover - older torch
    from torch.distributed._tensor import Replicate, Shard

Spec = Tuple[Any, ...]

# param-name classes (last path component)
_COL_PARALLEL = {"wq", "wk", "wv", "up", "gate", "w_in", "w_gate",
                 "w_uq", "w_uk", "w_uv", "wi", "wf", "wz",
                 "frame_adapter", "patch_proj"}
_ROW_PARALLEL = {"wo", "down", "w_out"}
_VOCAB_PARALLEL = {"table"}
_REPLICATED = {"router", "lam", "bi", "bf", "bq", "bk", "bv", "bz", "bo",
               "scale", "bias", "up_b", "down_b", "b"}


def _last_key(path: str) -> str:
    return path.split("/")[-1]


def _spec(entries) -> Spec:
    """A spec as ``PartitionSpec`` normalises it: a one-name tuple entry
    reads as the name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


# attention projections whose sharded dim is n_heads*head_dim — a shard
# narrower than head_dim splits a head across ranks, which the repo
# never allows
_HEAD_COL = {"wq", "wk", "wv", "w_uq", "w_uk", "w_uv"}
_HEAD_ROW = {"wo"}


@dataclass(frozen=True)
class LeafSharding:
    """One leaf's placement: the mesh, its spec, and per mesh dim a
    ``Shard(tensor dim)`` or ``Replicate()`` (a pytree leaf: not a
    tuple, so tree walks stop at it)."""
    mesh: Any
    spec: Spec
    placements: Tuple[Any, ...]


def spec_placements(mesh, spec: Spec) -> Tuple[Any, ...]:
    """The placements a spec means on ``mesh``: mesh dim ``a`` is
    ``Shard(d)`` when tensor dim ``d``'s entry names ``a`` (alone or in
    a tuple), else ``Replicate()``."""
    out = []
    for name in mesh_axes(mesh):
        dim = None
        for d, entry in enumerate(spec):
            names = entry if isinstance(entry, tuple) else (entry,)
            if name in names:
                dim = d
        out.append(Shard(dim) if dim is not None else Replicate())
    return tuple(out)


def _mesh_coords(mesh) -> Tuple[int, ...]:
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not part of the mesh")
    return tuple(coord)


def place(full, sharding: Optional[LeafSharding], *,
          contiguous: bool = True):
    """This rank's shard of ``full`` (a tensor or a numpy array) under
    ``sharding`` (None: the whole of it), a contiguous copy unless
    ``contiguous=False`` (a view).  Dims sharded over several mesh axes
    split in mesh-dim order (the outer axis first), as ``NamedSharding``
    lays them out."""
    if sharding is None:
        return full
    sizes = list(mesh_axes(sharding.mesh).values())
    coords = _mesh_coords(sharding.mesh)
    parts = {}                      # tensor dim -> (index, count)
    for md, pl in enumerate(sharding.placements):
        if isinstance(pl, Shard):
            i, n = parts.get(pl.dim, (0, 1))
            parts[pl.dim] = (i * sizes[md] + coords[md], n * sizes[md])
    if not parts:
        return full
    cut = [slice(None)] * full.ndim
    for d, (i, n) in parts.items():
        size = full.shape[d]
        if size % n:
            raise ValueError(f"dim {d} of {tuple(full.shape)} does not "
                             f"split {n} ways")
        cut[d] = slice(i * (size // n), (i + 1) * (size // n))
    out = full[tuple(cut)]
    if not contiguous:
        return out
    return (np.ascontiguousarray(out) if isinstance(out, np.ndarray)
            else out.contiguous())


def gather_full(local: torch.Tensor, sharding: LeafSharding) -> torch.Tensor:
    """The inverse of ``place``: this rank's shard gathered over every
    mesh dim that shards it (the inner axis first), so each rank gets
    the full tensor."""
    from repro_torch.distributed.tensor_parallel import collective
    names = list(mesh_axes(sharding.mesh))
    out = local
    for md in reversed(range(len(names))):
        pl = sharding.placements[md]
        if isinstance(pl, Shard) and mesh_axes(sharding.mesh)[names[md]] > 1:
            out = collective("all_gather", out.contiguous(),
                             sharding.mesh.get_group(names[md]), dim=pl.dim)
    return out


@dataclass
class ShardingRules:
    mesh: Any
    head_dim: Optional[int] = None

    def __post_init__(self):
        axes = mesh_axes(self.mesh)
        names = tuple(axes)
        self.axis_sizes = axes
        self.dp_axes = tuple(a for a in ("pod", "data") if a in names)
        self.tp_axis = "model" if "model" in names else None
        self.tp_size = axes[self.tp_axis] if self.tp_axis else 1
        self.dp_size = int(np.prod([axes[a] for a in self.dp_axes])) or 1

    # ------------------------------------------------------------------
    def _tp_if(self, dim: int):
        """'model' iff the axis exists and divides dim."""
        if self.tp_axis and dim % self.tp_size == 0 and dim >= self.tp_size:
            return self.tp_axis
        return None

    def _tp_if_heads(self, dim: int):
        """'model' iff it divides dim AND shards land on head boundaries
        (no-op guard when ``head_dim`` is unknown)."""
        ax = self._tp_if(dim)
        if ax and self.head_dim \
                and (dim // self.tp_size) % self.head_dim != 0:
            return None
        return ax

    def _dp_if(self, dim: int):
        if self.dp_axes and dim % self.dp_size == 0:
            return self.dp_axes
        return None

    def leaf_sharding(self, spec) -> LeafSharding:
        """The ``LeafSharding`` a spec means on this mesh."""
        spec = tuple(spec)
        return LeafSharding(self.mesh, spec,
                            spec_placements(self.mesh, spec))

    # ------------------------------------------------------------------
    def param_spec(self, path: str, shape: Tuple[int, ...]) -> Spec:
        """Spec for one parameter leaf (stacked dims included)."""
        name = _last_key(path)
        nd = len(shape)
        if nd == 0:
            return ()
        # (the reference indexes dim -3 of a 2-D shared-expert leaf of
        # an unstacked MoE layer and raises; the port gives it the MLP
        # rules below instead)
        is_moe = "/moe/" in path and name in ("up", "gate", "down") \
            and nd >= 3
        if is_moe:
            # (…, E, d, f): expert-parallel over model
            spec = [None] * nd
            spec[-3] = self._tp_if(shape[-3])
            return tuple(spec)
        if name in _VOCAB_PARALLEL and nd >= 2:
            spec = [None] * nd
            spec[-2] = self._tp_if(shape[-2])     # vocab dim of (V, d)
            return tuple(spec)
        if name in _REPLICATED or nd == 1:
            return (None,) * nd
        if name in _COL_PARALLEL:
            tp = self._tp_if_heads if name in _HEAD_COL else self._tp_if
            spec = [None] * nd
            spec[-1] = tp(shape[-1])
            if spec[-1] is None and nd >= 2:
                spec[-2] = self._tp_if(shape[-2])
            return tuple(spec)
        if name in _ROW_PARALLEL:
            tp = self._tp_if_heads if name in _HEAD_ROW else self._tp_if
            spec = [None] * nd
            spec[-2] = tp(shape[-2])
            if spec[-2] is None:
                spec[-1] = self._tp_if(shape[-1])
            return tuple(spec)
        if name == "w" and nd >= 3:
            # block-diagonal (…, nb, bs, bs): shard the block axis
            spec = [None] * nd
            spec[-3] = self._tp_if(shape[-3])
            return tuple(spec)
        if nd >= 2:
            # default: try column-parallel
            spec = [None] * nd
            spec[-1] = self._tp_if(shape[-1])
            return tuple(spec)
        return (None,) * nd

    def params_shardings(self, params_tree):
        """``LeafSharding`` pytree for a (shape-)pytree of parameters."""
        def mk(path, leaf):
            if leaf is None:
                return None
            return self.leaf_sharding(self.param_spec(path, tuple(leaf.shape)))

        return tree_map_with_path(mk, params_tree)

    # ------------------------------------------------------------------
    def opt_state_shardings(self, opt_tree, zero1: bool = True):
        """ZeRO-1: optimizer moments additionally sharded over 'data'.

        Each m/v leaf keeps its parameter's TP spec and gets the 'data'
        axis on the first remaining divisible dim (often the stack
        dim)."""
        data_ax = "data" if "data" in self.axis_sizes else None
        dsize = self.axis_sizes.get("data", 1) if data_ax else 1

        def mk(path, leaf):
            if leaf is None:
                return None
            shape = tuple(leaf.shape)
            spec = list(self.param_spec(path, shape))
            if zero1 and data_ax and path.split("/")[0] in ("m", "v", "mu"):
                for i, (dim, s) in enumerate(zip(shape, spec)):
                    if s is None and dim % dsize == 0 and dim >= dsize:
                        spec[i] = data_ax
                        break
            return self.leaf_sharding(spec)

        return tree_map_with_path(mk, opt_tree)

    # ------------------------------------------------------------------
    def batch_spec(self, shape: Tuple[int, ...]) -> Spec:
        """Inputs: batch over DP axes, rest replicated."""
        if not shape:
            return ()
        return _spec((self._dp_if(shape[0]),) + (None,) * (len(shape) - 1))

    def batch_shardings(self, batch_tree):
        return tree_map_with_path(
            lambda _, l: self.leaf_sharding(self.batch_spec(tuple(l.shape))),
            batch_tree)

    # ------------------------------------------------------------------
    def cache_spec(self, path: str, shape: Tuple[int, ...]) -> Spec:
        """KV caches / recurrent states (stacked: leading reps dim).

        dim0 may be the stack (reps) — the batch is the first of the
        first two dims with a DP-shardable size; one more dim goes on
        model: heads (dim -2 of k/v) when divisible, else the
        capacity/sequence dim (never head_dim)."""
        nd = len(shape)
        if nd == 0:
            return ()
        spec: list = [None] * nd
        for bdim in range(min(2, nd)):
            if self._dp_if(shape[bdim]) is not None:
                spec[bdim] = self._dp_if(shape[bdim])
                break
        else:
            bdim = -1
        if self.tp_axis:
            for cand in (nd - 2, nd - 3):
                if 0 <= cand < nd and spec[cand] is None \
                        and cand != bdim \
                        and shape[cand] % self.tp_size == 0 \
                        and shape[cand] >= self.tp_size:
                    spec[cand] = self.tp_axis
                    break
        return _spec(spec)

    def cache_shardings(self, cache_tree):
        def mk(path, leaf):
            if leaf is None:
                return None
            return self.leaf_sharding(self.cache_spec(path, tuple(leaf.shape)))

        return tree_map_with_path(mk, cache_tree)

    # ------------------------------------------------------------------
    def plan_spec(self, name: str, shape: Tuple[int, ...]) -> Spec:
        """Spec for one TilePlan index array: the forward ``idx``/
        ``counts`` (one row per N tile) and the transposed ``idx_t``/
        ``counts_t`` (one row per K tile) shard axis 0 over 'model' when
        it divides; the flat live-tile coordinates stay replicated."""
        if not shape:
            return ()
        spec = [None] * len(shape)
        if name in ("idx", "counts", "idx_t", "counts_t"):
            spec[0] = self._tp_if(shape[0])
        return tuple(spec)

    def shard_plan(self, plan_tree):
        """Every TilePlan's index arrays cut to this rank's rows of their
        ``plan_spec`` (a dict per plan; None leaves pass through)."""
        from repro_torch.kernels.bsmm import TilePlan
        fields = ("idx", "counts", "idx_t", "counts_t", "kk", "nn")

        def cut(tp):
            out = {}
            for f in fields:
                arr = getattr(tp, f, None)
                if arr is None:
                    continue
                sh = self.leaf_sharding(self.plan_spec(f, np.shape(arr)))
                out[f] = place(torch.as_tensor(np.asarray(arr)), sh).numpy()
            return out

        def walk(node):
            if isinstance(node, TilePlan):
                return cut(node)
            if isinstance(node, dict):
                return {k: walk(v) for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return type(node)(walk(v) for v in node)
            return node

        return walk(plan_tree)


_INSTALLED: Optional[ShardingRules] = None


def install(rules: Optional[ShardingRules]):
    """Activate MoE grouping (None → reset).  The reference also points
    ``hooks.constrain`` at its activation constraints; rank-local SPMD
    has no global array to constrain (``models.hooks``)."""
    global _INSTALLED
    from repro_torch.models import hooks

    _INSTALLED = rules
    hooks.set_moe_groups(1 if rules is None else rules.dp_size)


def installed() -> Optional[ShardingRules]:
    """The rules currently installed (so scoped installers — the
    sharded ``ServeEngine`` — can save and restore around a call)."""
    return _INSTALLED
