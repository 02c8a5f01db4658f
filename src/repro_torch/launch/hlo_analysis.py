"""The step trace and its roofline terms (the counterpart of
``repro.launch.hlo_analysis``).

The reference reads XLA's compiled program: ``cost_analysis()`` for
flops and bytes, the optimised HLO text for its collectives and dtypes.
The port has no compiled program.  Its artifact is the op stream of one
step on one rank, recorded by ``StepTrace`` on fake tensors (no storage,
no card; ``cuda`` fakes are made without one):

  * every aten op below autograd (the backward included), with its
    output shapes and dtypes, its flops by ``torch.utils.flop_counter``'s
    formulas, and its bytes: its inputs plus its output, since an eager
    step fuses nothing.  An op that returns a view moves 0 bytes; a
    gather reads what it writes, and an in-place scatter moves its
    values, not the tensor it writes into;
  * every kernel wrapper call (the wrappers' fake branches), with its
    route and split count by the real wrapper's rule and the launch's
    ``core.perf_model.KernelCost``.  The ops a wrapper issues inside its
    body (``kernels._mark.depth`` above 0) are not counted again, but
    their dtypes enter the census;
  * every collective (``distributed.tensor_parallel.collective``), by
    kind, output bytes per participant (the reference's proxy) and group
    size;
  * the peak of live storage bytes, from a finalizer on each storage.

The fakes are ``cuda`` tensors where torch is built with CUDA (no card
is needed).  A CPU-only build cannot run every op on a ``cuda`` fake
(an index raises "not linked with support for cuda devices"), so there
the trace makes ``cpu`` fakes (``trace_device``): the op stream is the
same, since the model code takes no branch on the device and the kernel
wrappers' fake branches record the card's route on any device.

What has no counterpart: ``_shape_bytes`` (there is no HLO text to
parse) and ``while_trip_counts`` (no loop body is counted once: the
port's loop over layers is a Python loop, and every layer is recorded).

The roofline constants are an H100 SXM5 80GB's, in this one place:
989e12 bf16 dense flop/s and 3.35e12 B/s of HBM.  ``NET_BW`` is an
assumption that no run has measured: 50e9 B/s a GPU, one NDR 400 Gb/s
port, which a 16-wide model axis crosses between two 8-GPU NVLink
nodes.
"""
from __future__ import annotations

import contextlib
import time
import weakref
from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import _mark

CARD = "NVIDIA H100 SXM5 80GB"
PEAK_FLOPS = 989e12          # bf16 dense flop/s, one card
HBM_BW = 3.35e12             # B/s, one card
NET_BW = 50e9                # B/s a GPU across nodes (assumed, not measured)

#: torch dtypes by the HLO names the reference's census keys use
_HLO_DTYPE = {torch.float64: "f64", torch.float32: "f32",
              torch.float16: "f16", torch.bfloat16: "bf16",
              torch.int64: "s64", torch.int32: "s32", torch.int16: "s16",
              torch.int8: "s8", torch.uint8: "u8", torch.bool: "pred",
              torch.complex64: "c64", torch.complex128: "c128"}

_aten = torch.ops.aten
#: allocations that write nothing, and views the schema does not mark
_NO_TRAFFIC = {_aten.empty, _aten.empty_like, _aten.empty_strided,
               _aten.new_empty, _aten.new_empty_strided, _aten._unsafe_view,
               _aten.lift_fresh}
#: reads only the rows it writes (plus its indices)
_GATHERS = {_aten.index, _aten.embedding, _aten.gather, _aten.index_select}
#: writes its values into a tensor it does not read whole
_SCATTERS = {_aten.index_put_, _aten.index_put, _aten.scatter_,
             _aten.index_copy_, _aten.index_add_, _aten.scatter_add_,
             _aten._index_put_impl_}


def trace_device() -> torch.device:
    """The device of a trace's fakes: ``cuda`` where torch is built with
    CUDA, else ``cpu`` (see the module)."""
    return torch.device("cuda" if torch.version.cuda else "cpu")


def active() -> Optional["StepTrace"]:
    """The ``StepTrace`` being recorded, or None."""
    return _mark.trace


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree, out=None) -> List[torch.Tensor]:
    """The tensors of an op's arguments or outputs (lists, tuples and
    dicts of them: faster than a general pytree walk, once an op)."""
    if out is None:
        out = []
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _tensors(v, out)
    elif isinstance(tree, dict):
        for v in tree.values():
            _tensors(v, out)
    return out


@dataclass
class KernelRecord:
    name: str                    # the wrapper
    route: str                   # the CUDA route its rule gives
    splits: int
    cost: Any                    # core.perf_model.KernelCost
    dtypes: tuple


@dataclass
class CollectiveRecord:
    kind: str                    # the reference's names: all-reduce, ...
    bytes: int                   # output bytes per participant
    group_size: int
    dtype: str


class _Recorder(TorchDispatchMode):
    def __init__(self, trace: "StepTrace"):
        super().__init__()
        self.trace = trace

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.trace._op(func, args, kwargs, out)
        return out


class StepTrace:
    """Record one step's op stream on fake tensors (see the module).

    ``with StepTrace() as tr:`` enters a ``FakeTensorMode`` and the
    recorder; ``tr.fake(tree)`` makes the step's arguments (their bytes
    are the trace's argument bytes), then the step runs as it would on
    the card.  Only one trace is active at a time."""

    def __init__(self, device=None):
        self.device = (torch.device(device) if device is not None
                       else trace_device())
        #: (op, output shapes, output dtypes, flops, bytes) at depth 0
        self.ops: List[tuple] = []
        self.kernels: List[KernelRecord] = []
        self.collectives: List[CollectiveRecord] = []
        #: dtypes of every op output, kernel bodies included
        self.body_dtypes: Counter = Counter()
        self.argument_bytes = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self.host_s = 0.0
        self._live: Dict[int, int] = {}
        self._quiet = False
        self._fake_mode: Optional[FakeTensorMode] = None

    # -- context ---------------------------------------------------------
    def __enter__(self) -> "StepTrace":
        if _mark.trace is not None:
            raise RuntimeError("a StepTrace is already active")
        self._fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
        self._fake_mode.__enter__()
        self._rec = _Recorder(self)
        self._rec.__enter__()
        _mark.trace = self
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.host_s += time.perf_counter() - self._t0
        _mark.trace = None
        self._rec.__exit__(*exc)
        self._fake_mode.__exit__(*exc)
        return False

    # -- arguments -------------------------------------------------------
    def fake(self, tree, device=None):
        """``tree`` with every tensor leaf a fake: a meta leaf (a spec) as
        a contiguous buffer of its shape and dtype on ``device`` (default:
        the trace's), a real leaf as itself on its own device (strides and
        aliasing kept).  Their storages are the trace's arguments."""
        dev = torch.device(device) if device is not None else self.device
        seen = set()

        def mk(t):
            if not isinstance(t, torch.Tensor):
                return t
            if isinstance(t, FakeTensor):
                f = t
            elif t.device.type == "meta":      # a spec: a whole buffer
                f = torch.empty(tuple(t.shape), dtype=t.dtype, device=dev)
            else:
                f = self._fake_mode.from_tensor(t)
            key = self._track(f)
            if key not in seen:
                seen.add(key)
                self.argument_bytes += f.untyped_storage().nbytes()
            return f

        self._quiet = True
        try:
            return tree_map(mk, tree)
        finally:
            self._quiet = False

    # -- recording -------------------------------------------------------
    def _free(self, key: int, n: int) -> None:
        if self._live.pop(key, None) is not None:
            self.live_bytes -= n

    def _track(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        key = st._cdata
        if key not in self._live:
            n = st.nbytes()
            self._live[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key, n)
        return key

    def _op(self, func, args, kwargs, out) -> None:
        outs = _tensors(out)
        for t in outs:
            self._track(t)
            self.body_dtypes[t.dtype] += 1
        if self._quiet or _mark.depth > 0:
            return
        packet = func.overloadpacket
        flops = 0
        formula = flop_registry.get(packet)
        if formula is not None:
            flops = int(formula(*args, **kwargs, out_val=out))
        ins = _tensors((args, kwargs))
        if not outs or func.is_view or packet in _NO_TRAFFIC:
            nbytes = 0
        elif packet in _GATHERS:
            nbytes = 2 * sum(map(_nbytes, outs)) + sum(
                _nbytes(t) for t in ins[1:])
        elif packet in _SCATTERS:
            nbytes = 2 * sum(_nbytes(t) for t in ins[1:])
        else:
            nbytes = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        self.ops.append((packet.__name__, tuple(tuple(t.shape) for t in outs),
                         tuple(_HLO_DTYPE.get(t.dtype, str(t.dtype))
                               for t in outs), flops, nbytes))

    @contextlib.contextmanager
    def repeated(self, n: int):
        """Record the ops, kernel launches and collectives issued inside as
        ``n`` times over (a loop whose ``n`` iterations are alike runs one
        of them: ``kernels._mark.alike_steps``)."""
        marks = (len(self.ops), len(self.kernels), len(self.collectives))
        try:
            yield
        finally:
            for rec, i in zip((self.ops, self.kernels, self.collectives),
                              marks):
                rec.extend(rec[i:] * (n - 1))

    def record_kernel(self, name: str, route: str, splits: int, cost,
                      *tensors) -> None:
        """One kernel launch a wrapper's fake branch stands for."""
        self.kernels.append(KernelRecord(
            name, route, int(splits), cost,
            tuple(_HLO_DTYPE.get(t.dtype, str(t.dtype))
                  for t in tensors if isinstance(t, torch.Tensor))))

    def collective(self, op: str, t: torch.Tensor, group, **kw):
        """Record ``collective(op, t, group)`` and return its fake result
        (``all_reduce``/``broadcast``: ``t`` itself, in place;
        ``all_gather``: the concatenation's shape; ``reduce_scatter``:
        this rank's part of ``dim``)."""
        n = int(group.size())
        kind = {"all_reduce": "all-reduce", "all_gather": "all-gather",
                "reduce_scatter": "reduce-scatter",
                "broadcast": "broadcast"}.get(op)
        if kind is None:
            raise ValueError(f"unknown collective {op!r}")
        out = t
        if op in ("all_gather", "reduce_scatter"):
            dim = kw.get("dim", 0) % t.ndim
            shape = list(t.shape)
            if op == "all_gather":
                shape[dim] *= n
            else:
                if shape[dim] % n:
                    raise ValueError(f"reduce_scatter: dim {dim} of "
                                     f"{tuple(t.shape)} does not split {n} "
                                     "ways")
                shape[dim] //= n
            out = t.new_empty(shape)
        self.collectives.append(CollectiveRecord(
            kind, _nbytes(out), n, _HLO_DTYPE.get(t.dtype, str(t.dtype))))
        return out

    # -- totals ----------------------------------------------------------
    @property
    def flops(self) -> float:
        return float(sum(o[3] for o in self.ops)
                     + sum(k.cost.flops for k in self.kernels))

    @property
    def bytes_accessed(self) -> float:
        return float(sum(o[4] for o in self.ops)
                     + sum(k.cost.hbm_bytes for k in self.kernels))

    def launches(self) -> Dict[str, Dict[str, int]]:
        """{wrapper: {route: launches}}."""
        out: Dict[str, Dict[str, int]] = {}
        for k in self.kernels:
            by = out.setdefault(k.name, {})
            by[k.route] = by.get(k.route, 0) + 1
        return out


def dtype_census(trace: StepTrace) -> Dict[str, int]:
    """Occurrences of each dtype (by its HLO name) among the trace's op
    outputs, kernel bodies included, and its kernel launches' operands
    and outputs (``hlo_dtype_census``'s counterpart: an ``f64`` entry is
    rule J206)."""
    census: Dict[str, int] = {}
    for dt, n in trace.body_dtypes.items():
        key = _HLO_DTYPE.get(dt, str(dt))
        census[key] = census.get(key, 0) + n
    for k in trace.kernels:
        for key in k.dtypes:
            census[key] = census.get(key, 0) + 1
    return census


@dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, int] = field(default_factory=dict)
    count_by_kind: Dict[str, int] = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    def add(self, kind: str, nbytes: int):
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0) + nbytes
        self.count_by_kind[kind] = self.count_by_kind.get(kind, 0) + 1


def collective_bytes(trace: StepTrace) -> CollectiveStats:
    """Output bytes per participant of every collective the step issued,
    by kind."""
    stats = CollectiveStats()
    for c in trace.collectives:
        stats.add(c.kind, c.bytes)
    return stats


@dataclass
class RooflineTerms:
    """All inputs are PER-RANK quantities: the trace is one rank's step,
    so each term divides by one card's peak.  ``model_flops`` is global
    and gets divided by n_chips for the useful-flops ratio."""
    flops: float                 # per-rank flops
    bytes_accessed: float        # per-rank HBM bytes
    collective_b: float          # per-rank collective bytes (output proxy)
    n_chips: int
    model_flops: float = 0.0     # global analytic model flops

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_b / NET_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step time = max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (global traced flops) — remat/redundancy waste."""
        if not self.flops:
            return 0.0
        return self.model_flops / (self.flops * self.n_chips)

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilisation at the roofline step time."""
        t = self.step_time_s
        if t <= 0:
            return 0.0
        return self.model_flops / (t * self.n_chips * PEAK_FLOPS)

    def as_dict(self) -> Dict:
        return {
            "flops": self.flops, "bytes": self.bytes_accessed,
            "collective_bytes": self.collective_b,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu": self.mfu, "n_chips": self.n_chips,
        }


def roofline_from_trace(trace: StepTrace, n_chips: int,
                        model_flops: float = 0.0) -> RooflineTerms:
    """The roofline terms of one rank's traced step."""
    return RooflineTerms(flops=trace.flops,
                         bytes_accessed=trace.bytes_accessed,
                         collective_b=float(collective_bytes(trace)
                                            .total_bytes),
                         n_chips=n_chips, model_flops=model_flops)
