"""Dispatch auditor: run a hot path once, audit every aten op it issues.

The counterpart of ``repro.analysis.jaxpr_audit``.  The reference traces
its jitted closures abstractly (``jax.make_jaxpr``) and walks the
equation graph; an eager port has no trace, so ``audit_closure`` runs the
closure once for real, at the small shapes the lint builds, under a
``TorchDispatchMode`` that sees every aten op below autograd (the
backward of a train step included).  It looks for the failure modes
that do not crash but silently forfeit the sparsity a plan paid for:

* a dense ``aten.mm``/``addmm``/``bmm``/``baddbmm`` whose second
  operand's last two dims are a (K, N) shape only plan-covered weights
  have (J201) — the router fell back to dense for a projection it was
  supposed to skip tiles on;
* no kernel wrapper entered at all while a plan covers projections of
  the path (J205);
* float64 outputs (J202); host round trips — ``.item()``/``int(t)``
  (``aten._local_scalar_dense``), ops whose output shape depends on the
  data, and on CUDA a copy to the host (J203); a closure that raised
  (J204).

Kernel bodies are opaque, as ``pallas_call`` bodies are to the
reference: every public kernel wrapper marks its body
(``kernels._mark``), on the CPU too, where the plain version's dense
``aten.mm`` on the weights is the kernel's own work, and the ops issued
inside a marked body are not examined.

J206/J207 read the reference's compiled HLO; the port reads its
counterpart, the step trace (``launch.hlo_analysis.StepTrace``):
``audit_traced`` runs a closure on fake copies of its arguments under a
trace and ``audit_trace`` checks the trace — an f64 anywhere in its
census, kernel bodies included, is J206 (J202 does not look inside a
kernel body), and collective traffic is reported as J207.  J208 checks
a mesh-backed engine's parameter placements (``LeafSharding``s and
their ``torch.distributed.tensor`` placements, where the reference
checks ``NamedSharding``s).  Rule codes J201–J208; see
``analysis.findings.RULES``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.analysis.findings import Finding, error, info, warning
from repro_torch.kernels import _mark

_aten = torch.ops.aten
#: dense products and the argument that holds the weight
_DENSE_PRODUCTS = {_aten.mm: 1, _aten.addmm: 2, _aten.bmm: 1,
                   _aten.baddbmm: 2}
#: ops whose output shape depends on the data: the host must wait
_DATA_SHAPED = {_aten.nonzero, _aten.masked_select, _aten._unique2,
                _aten.unique_dim, _aten.unique_consecutive, _aten.bincount}
#: overloads of the same kind (repeat_interleave by a tensor of repeats)
_DATA_SHAPED_OVERLOADS = {_aten.repeat_interleave.Tensor,
                          _aten.repeat_interleave.self_Tensor}
_HOST_READ = {_aten._local_scalar_dense}
_COPIES = {_aten._to_copy, _aten.copy_}


def collect_covered(plan_tree) -> Dict[Tuple[int, int], str]:
    """{(K, N) weight shape: plan path} for every TilePlan in a tree.

    A plan built by ``make_tile_plan`` covers a (K, N) weight where
    K = len(counts_t)·tile and N = len(counts)·tile; any dense product
    against that exact shape in a hot path is a routing miss.  Later
    duplicates keep the first label."""
    from repro_torch.analysis.invariants import _walk_plan_leaves
    covered: Dict[Tuple[int, int], str] = {}
    for path, plan in _walk_plan_leaves(plan_tree):
        if plan.counts_t is None:
            continue
        K = int(plan.counts_t.shape[0]) * plan.tile
        N = int(plan.counts.shape[0]) * plan.tile
        covered.setdefault((K, N), path)
    return covered


def unambiguous_covered(plan_tree, params) -> Dict[Tuple[int, int], str]:
    """``collect_covered`` minus shapes that non-routed weights share.

    A dense product is identified by its weight operand's (K, N) alone,
    so a shape is a reliable routing-miss signature only when EVERY
    weight of that shape is plan-covered: if more ≥2-D param leaves
    carry a covered (…, K, N) shape than the plan routes, the shape is
    ambiguous and is not audited.  Stacked leaves (segments, experts)
    count once, like their union-reduced plan."""
    from repro_torch.analysis.invariants import _walk_plan_leaves
    from repro_torch.core.masks import tree_flatten_with_path
    covered: Dict[Tuple[int, int], str] = {}
    plan_counts: Dict[Tuple[int, int], int] = {}
    for path, plan in _walk_plan_leaves(plan_tree):
        if plan.counts_t is None:
            continue
        s = (int(plan.counts_t.shape[0]) * plan.tile,
             int(plan.counts.shape[0]) * plan.tile)
        covered.setdefault(s, path)
        plan_counts[s] = plan_counts.get(s, 0) + 1
    leaf_counts: Dict[Tuple[int, int], int] = {}
    for _, leaf in tree_flatten_with_path(params):
        if getattr(leaf, "ndim", 0) >= 2:
            s = tuple(int(d) for d in leaf.shape[-2:])
            leaf_counts[s] = leaf_counts.get(s, 0) + 1
    return {s: label for s, label in covered.items()
            if leaf_counts.get(s, 0) <= plan_counts[s]}


class _Recorder(TorchDispatchMode):
    """Records, outside marked kernel bodies, what the J rules read."""

    def __init__(self, covered):
        super().__init__()
        self.covered = covered or {}
        self.dense_hits: Dict[Tuple[int, int], int] = {}
        self.events: List[Tuple[str, str]] = []   # (code, op) in order
        self._seen = set()

    def _note(self, code: str, op: str) -> None:
        key = code if code == "J202" else (code, op)
        if key not in self._seen:
            self._seen.add(key)
            self.events.append((code, op))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _mark.depth > 0:              # a kernel body: opaque
            return out
        packet = func.overloadpacket
        name = packet.__name__
        if (packet in _HOST_READ or packet in _DATA_SHAPED
                or func in _DATA_SHAPED_OVERLOADS):
            self._note("J203", name)
        elif packet in _COPIES and _to_host(func, args, kwargs, out):
            self._note("J203", name)
        arg = _DENSE_PRODUCTS.get(packet)
        if arg is not None and self.covered and len(args) > arg:
            shape = tuple(int(d) for d in args[arg].shape[-2:])
            if shape in self.covered:
                self.dense_hits[shape] = self.dense_hits.get(shape, 0) + 1
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.dtype == torch.float64:
                self._note("J202", name)
                break
        return out


def _to_host(func, args, kwargs, out) -> bool:
    """A copy whose source lies on the card and whose result on the
    host."""
    src = args[1] if func.overloadpacket is _aten.copy_ else args[0]
    dst = args[0] if func.overloadpacket is _aten.copy_ else out
    return (isinstance(src, torch.Tensor) and isinstance(dst, torch.Tensor)
            and src.device.type == "cuda" and dst.device.type == "cpu")


def audit_closure(fn: Callable, args: Iterable[Any] = (), *,
                  covered: Optional[Dict[Tuple[int, int], str]] = None,
                  where: str = "closure",
                  kwargs: Optional[dict] = None) -> List[Finding]:
    """Run ``fn(*args)`` once under the recording mode and audit it.

    ``covered`` maps plan-covered weight shapes to labels
    (``unambiguous_covered``); None or empty skips the routing rules
    (J201/J205).  The closure runs as called: a train step differentiates
    inside it, serving closures run under ``torch.inference_mode()``
    themselves.  Returns the findings; what the closure returned is
    dropped."""
    findings: List[Finding] = []
    rec = _Recorder(covered)
    entered = _mark.entered
    try:
        with rec:
            fn(*args, **(kwargs or {}))
    except Exception as e:  # a failing closure is itself a finding
        findings.append(error(
            "J204", where,
            f"the closure raised when run: {type(e).__name__}: {e}"))
        return findings
    for code, op in rec.events:
        if code == "J203":
            findings.append(warning(
                "J203", where,
                f"host round trip {op!r} in the closure — every step "
                f"waits for the card (.item()/int() of a tensor, a "
                f"data-shaped op, or a copy to the host)"))
        else:
            findings.append(warning(
                "J202", where,
                f"float64 value produced by {op!r} — accidental f64 "
                f"promotion doubles bytes moved on the hot path "
                f"(check python-float and numpy-default constants)"))
    for shape, n in sorted(rec.dense_hits.items()):
        findings.append(error(
            "J201", where,
            f"dense matmul on weight shape {shape} ({n}x) — a TilePlan "
            f"covers this projection ({covered[shape]}); the "
            f"block-sparse route was bypassed"))
    if covered and _mark.entered == entered:
        findings.append(error(
            "J205", where,
            f"plan covers {len(covered)} projection shape(s) but the "
            f"closure entered no kernel wrapper — block-sparse routing is "
            f"disabled for this whole path"))
    return findings


def audit_engine_sharding(engine, *, where: str = "engine") -> List[Finding]:
    """J208: a ``ServeEngine`` on a >1-rank mesh whose parameters never
    got a placement.

    A mesh engine places every parameter leaf by the sharding rules
    (each generation's ``sharded.shardings``: a ``LeafSharding`` per
    leaf).  None at all is an error — every rank would hold and run
    the whole model.  Placements that are all ``Replicate()`` (no mesh
    axis in any spec) are a warning — legal for degenerate configs,
    almost certainly a divisibility bug at real scale."""
    from repro_torch.core.masks import tree_flatten_with_path
    from repro_torch.distributed.sharding import LeafSharding, Shard
    from repro_torch.launch.mesh import mesh_axes

    findings: List[Finding] = []
    mesh = getattr(engine, "mesh", None)
    if mesh is None:
        return findings
    size = getattr(mesh, "size", None)    # DeviceMesh.size() or an int
    if callable(size):
        size = size()
    if size is None:
        size = 1
        for n in mesh_axes(mesh).values():
            size *= n
    if size <= 1:
        return findings
    for g in engine.generations:
        gwhere = f"{where}/gen{g.gid}"
        sm = getattr(g, "sharded", None)
        placed = ([] if sm is None else
                  [sh for _, sh in tree_flatten_with_path(sm.shardings)
                   if isinstance(sh, LeafSharding)])
        if not placed:
            n = sum(1 for _, l in tree_flatten_with_path(g.params)
                    if l is not None)
            findings.append(error(
                "J208", gwhere,
                f"engine mesh has {size} ranks but none of the {n} param "
                f"leaves carries a placement — every rank holds and runs "
                f"the whole model"))
            continue
        if not any(isinstance(p, Shard) for sh in placed
                   for p in sh.placements):
            findings.append(warning(
                "J208", gwhere,
                f"all {len(placed)} placed param leaves are Replicate() on "
                f"a {size}-rank mesh — no dimension divided (shape/mesh "
                f"mismatch?)"))
    return findings


def audit_traced(fn: Callable, args: Iterable[Any] = (), *,
                 where: str = "traced",
                 kwargs: Optional[dict] = None) -> List[Finding]:
    """Trace ``fn(*args)`` on fake copies of its arguments
    (``launch.hlo_analysis.StepTrace``) and cross-check the trace (the
    counterpart of ``audit_compiled``).  Nothing runs: kernel wrappers
    record their launches and collectives their traffic.  Under an
    installed tensor-parallel context (a mesh engine's scope) the fake
    copies of its shards are bound as the shards for the trace."""
    from repro_torch.launch.hlo_analysis import StepTrace
    from repro_torch.models import hooks

    tp = hooks.tensor_parallel()
    shards = list(tp._sharded.values()) if tp is not None else []
    try:
        with StepTrace() as tr:
            fargs = tr.fake(list(args))
            fkw = tr.fake(dict(kwargs or {}))
            if tp is not None:
                tp.bind(tr.fake(shards))
            try:
                fn(*fargs, **fkw)
            finally:
                if tp is not None:
                    tp.bind(shards)
    except Exception as e:
        return [error("J204", where,
                      f"could not trace the closure: {type(e).__name__}: "
                      f"{e}")]
    return audit_trace(tr, where=where)


def audit_trace(trace, *, where: str = "trace") -> List[Finding]:
    """The J206/J207 checks on a step trace (the counterpart of
    ``audit_hlo_text``)."""
    from repro_torch.launch.hlo_analysis import collective_bytes, dtype_census

    findings: List[Finding] = []
    census = dtype_census(trace)
    if census.get("f64"):
        findings.append(warning(
            "J206", where,
            f"optimized HLO contains {census['f64']} f64 shape(s) — an "
            f"x64 promotion survived compilation"))
    coll = collective_bytes(trace)
    if coll.total_bytes:
        findings.append(info(
            "J207", where,
            f"compiled module moves {coll.total_bytes} collective "
            f"bytes: " +
            ", ".join(f"{k}×{coll.count_by_kind[k]}"
                      for k in sorted(coll.bytes_by_kind))))
    return findings
