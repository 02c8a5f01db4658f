"""Mesh construction and the local rank spawner (a port of
``repro.launch.mesh``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with axes
``("data", "model")`` (``("pod", "data", "model")`` for the multi-pod
production mesh) over an initialised process group with one rank per
mesh position.  Nothing here touches the process group at import time.

Backends: ``nccl`` on ``cuda`` and ``gloo`` on ``cpu``.  Under NCCL
each spawned rank drives its own card (rank r the r-th from the given
device); NCCL refuses two ranks on one card, so ranks that share a card
pass ``backend="gloo"`` (``spawn_backend`` picks it when there are
fewer cards than ranks; their collectives stage through host memory,
see ``distributed.tensor_parallel.collective``).  A gloo mesh is recorded
with device type ``cpu`` whatever device the tensors live on: the port
uses the mesh for its process groups and placements, never for DTensor
storage.

``run_ranks`` starts one process per mesh position on this host (the
``spawn`` start method), builds the mesh in each and calls ``fn(mesh,
*args)`` there; the tests and ``chip_smoke.py`` share it.
``run_printing_rank0`` runs a command that prints on such ranks and
prints rank 0's output: the ``--mesh DxM`` of the CLI and of
``launch.serve`` go through it.
"""
from __future__ import annotations

import contextlib
import datetime
import io
import os
import queue as _queue
import shutil
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch._bridge import resolve_device

AXES = ("data", "model")


def _backend_for(device: torch.device, backend: Optional[str]) -> str:
    return backend or ("nccl" if device.type == "cuda" else "gloo")


def spawn_backend(device, world: int) -> str:
    """``nccl`` when each of ``world`` ranks on ``device`` can drive a
    card of its own, else ``gloo`` (the CPU, or ranks sharing cards)."""
    dev = torch.device(device)
    if dev.type == "cuda" and (dev.index or 0) + world \
            <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device, rank: int, backend: str) -> torch.device:
    """The device rank ``rank`` drives: under NCCL its own card (the
    ``rank``-th from ``device``'s index), under gloo ``device`` itself
    (index 0 by default), which the ranks share."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", (dev.index or 0)
                        + (rank if backend == "nccl" else 0))


def _check_cards(dev: torch.device, world: int, backend: str) -> None:
    if dev.type == "cuda" and backend == "nccl":
        have = torch.cuda.device_count() - (dev.index or 0)
        if world > have:
            raise ValueError(
                f"NCCL needs a card a rank: {world} ranks, {have} card(s) "
                f"from {dev}; pass backend='gloo' to share cards")


def _launch_hint(n: int) -> str:
    return (f"start {n} ranks with repro_torch.launch.mesh.run_ranks(fn, "
            f"data, model, device=...) or `torchrun --nproc-per-node {n}`")


def _ensure_group(world: int, device: torch.device, backend: str) -> None:
    """An initialised default group of exactly ``world`` ranks; a
    one-rank group is started here over an in-process store."""
    if dist.is_available() and dist.is_initialized():
        have = dist.get_world_size()
        if have < world:
            raise ValueError(f"mesh needs {world} ranks, the process group "
                             f"has {have}; {_launch_hint(world)}")
        if have != world:
            raise ValueError(f"mesh of {world} ranks over a process group "
                             f"of {have}: build it from a group of its size")
        return
    if world != 1:
        raise ValueError(f"mesh needs {world} ranks, found no process "
                         f"group; {_launch_hint(world)}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def _mesh(shape: Sequence[int], names: Sequence[str], device: torch.device,
          backend: str):
    from torch.distributed.device_mesh import init_device_mesh
    _ensure_group(int(torch.tensor(shape).prod()), device, backend)
    kind = "cuda" if backend == "nccl" else "cpu"
    return init_device_mesh(kind, tuple(shape), mesh_dim_names=tuple(names))


def make_test_mesh(data: int = 1, model: int = 1, *, device="cuda",
                   backend: Optional[str] = None):
    """(data, model) mesh over the current process group (one rank per
    position).  ``(1, 1)`` starts a one-rank group itself when none is
    initialised; larger meshes need their ranks launched first
    (``run_ranks``) and raise ``ValueError`` otherwise, as the
    reference raises with too few devices.  ``device="cuda"`` without a
    card raises: nothing drops to the CPU."""
    dev = resolve_device(device)
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1, got {data}x{model}")
    return _mesh((data, model), AXES, dev, _backend_for(dev, backend))


def make_cpu_mesh():
    """Trivial 1-rank mesh on the CPU (keeps the same code path)."""
    return make_test_mesh(1, 1, device="cpu")


def make_production_mesh(*, multi_pod: bool = False, device="cuda",
                         backend: Optional[str] = None):
    """Single pod: (data=16, model=16) over 256 ranks.  Multi-pod:
    (pod=2, data=16, model=16) over 512.  Raises unless the process
    group has exactly that many ranks."""
    dev = resolve_device(device)
    axes = production_shape(multi_pod)
    return _mesh(tuple(axes.values()), tuple(axes), dev,
                 _backend_for(dev, backend))


class AbstractGroup:
    """A process group on paper: an axis of an ``AbstractMesh``, its size
    and nothing to communicate over (``size()`` as a ProcessGroup)."""

    def __init__(self, axis: str, size: int):
        self.axis = axis
        self._size = int(size)

    def size(self) -> int:
        return self._size

    def __repr__(self) -> str:
        return f"AbstractGroup({self.axis!r}, {self._size})"


class AbstractMesh:
    """The production mesh as one rank sees it, with no process group:
    axis names, sizes, this rank's coordinate and a group per axis that
    exists only on paper.  The dry-run traces rank 0 of it
    (``launch.dryrun``); a collective over its groups can only be
    recorded by a ``StepTrace``."""

    def __init__(self, shape: dict, coord: Optional[Sequence[int]] = None):
        self.axis_names = tuple(shape)
        self.shape = {a: int(n) for a, n in shape.items()}
        self._coord = tuple(coord) if coord is not None \
            else (0,) * len(self.axis_names)
        self._groups = {a: AbstractGroup(a, n) for a, n in self.shape.items()}

    def get_coordinate(self):
        return self._coord

    def get_group(self, axis: str) -> AbstractGroup:
        return self._groups[axis]

    def get_local_rank(self, axis: str) -> int:
        return self._coord[self.axis_names.index(axis)]

    def get_rank(self) -> int:
        r = 0
        for a, c in zip(self.axis_names, self._coord):
            r = r * self.shape[a] + c
        return r

    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n


def production_shape(multi_pod: bool = False) -> dict:
    """{axis: size} of the production mesh: (data=16, model=16), or
    (pod=2, data=16, model=16)."""
    return ({"pod": 2, "data": 16, "model": 16} if multi_pod
            else {"data": 16, "model": 16})


def mesh_axes(mesh) -> dict:
    """{axis name: size} of a DeviceMesh or of a duck-typed mesh with
    ``axis_names`` and a ``shape`` dict (the spec tests' fake)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def choose_config(arch: str, smoke: bool):
    """The launchers' config: (config, multi-rank).  The reduced f32
    config under ``--smoke``, else the full one; multi-rank when a
    process group of more than one rank is running (the production
    mesh's branch)."""
    from repro_torch.configs import get_arch, scaled_down

    if smoke:
        return scaled_down(get_arch(arch), dtype="float32"), False
    multi = dist.is_available() and dist.is_initialized() \
        and dist.get_world_size() > 1
    return get_arch(arch), multi


@contextlib.contextmanager
def launcher_mesh(arch: str, smoke: bool, *, multi_pod: bool, device):
    """(config, mesh, multi-rank) of ``launch.train`` and
    ``launch.serve``: ``choose_config``'s config on the production mesh
    when multi-rank, else on a (1, 1) mesh on ``device``.  The process
    group it starts (a one-rank group, when none ran) is torn down and
    the sharding rules installed before are restored on exit, so that a
    launcher's ``main`` can be called in process (also the excepthook
    that starting a group installs: it prefixes every later traceback
    with the rank)."""
    from repro_torch.distributed import sharding

    cfg, multi = choose_config(arch, smoke)
    owned = not (dist.is_available() and dist.is_initialized())
    prev, hook = sharding.installed(), sys.excepthook
    mesh = (make_production_mesh(multi_pod=multi_pod, device=device)
            if multi else make_test_mesh(device=device))
    try:
        yield cfg, mesh, multi
    finally:
        sharding.install(prev)
        if owned and dist.is_initialized():
            dist.destroy_process_group()
            sys.excepthook = hook


def parse_mesh(text: str):
    """"DxM" → (D, M) (the CLI's ``--mesh``)."""
    try:
        d, m = (int(v) for v in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh wants DxM (e.g. 1x2), got {text!r}")
    if d < 1 or m < 1:
        raise ValueError(f"--mesh axes must be >= 1, got {text!r}")
    return d, m


# ---------------------------------------------------------------------------
# The local spawner
# ---------------------------------------------------------------------------
def _rank_main(fn, rank, world, data, model, device, backend, init, args,
               out, timeout_s):
    try:
        be = _backend_for(torch.device(device), backend)
        dev = rank_device(device, rank, be)
        if dev.type == "cpu":
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        else:
            torch.cuda.set_device(dev)
        dist.init_process_group(
            be, init_method=init, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            mesh = make_test_mesh(data, model, device=dev, backend=be)
            res = fn(mesh, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, res))
    except BaseException:           # reported to the parent, then exit
        out.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable[..., Any], data: int, model: int, *,
              device="cuda", backend: Optional[str] = None,
              args: Sequence[Any] = (), timeout_s: float = 600.0
              ) -> List[Any]:
    """Run ``fn(mesh, *args)`` on ``data·model`` local ranks (spawned
    processes over a file store in a fresh temporary directory) and
    return the per-rank results, rank 0 first.  ``fn`` and its
    arguments and results must pickle.  A rank that raises, or one that
    has not finished after ``timeout_s``, fails the whole run: every
    rank is stopped and the first traceback raised.  NCCL ranks (the
    default on ``cuda``) need a card each and raise ``ValueError``
    before spawning otherwise."""
    dev = resolve_device(device)    # no card: raise before spawning
    world = data * model
    _check_cards(dev, world, _backend_for(dev, backend))
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    init = "file://" + os.path.join(tmp, "store")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, data, model, str(device),
                               backend, init, tuple(args), out, timeout_s),
                         daemon=True)
             for r in range(world)]
    results: dict = {}
    errors: List[str] = []
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while len(results) + len(errors) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                errors.append(f"timed out after {timeout_s} s with "
                              f"{world - len(results)} rank(s) unfinished")
                break
            try:
                rank, ok, res = out.get(timeout=min(left, 1.0))
            except _queue.Empty:
                dead = [p for p in procs if not p.is_alive()
                        and p.exitcode not in (0, None)]
                if dead and out.empty():
                    errors.append(f"rank process exited with code "
                                  f"{dead[0].exitcode} before reporting")
                    break
                continue
            if ok:
                results[rank] = res
            else:
                errors.append(f"rank {rank}:\n{res}")
                break
    finally:
        for p in procs:
            if p.pid is None:           # never started
                continue
            p.join(timeout=5 if not errors else 0.5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        out.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if errors:
        raise RuntimeError("run_ranks failed: " + errors[0])
    return [results[r] for r in range(world)]


def _captured(mesh, fn, args):
    """One rank of ``run_printing_rank0``: ``fn(mesh, *args)`` with its
    standard output captured (rank 0's kept, the others' dropped)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn(mesh, *args)
    return res, buf.getvalue() if mesh.get_rank() == 0 else ""


def run_printing_rank0(fn: Callable[..., Any], data: int, model: int, *,
                       device="cuda", args: Sequence[Any] = ()) -> Any:
    """``run_ranks(fn, data, model)`` on the backend ``spawn_backend``
    picks, each rank's standard output captured; rank 0's output is
    printed here when the ranks end, and rank 0's result returned."""
    outs = run_ranks(_captured, data, model, device=device,
                     backend=spawn_backend(device, data * model),
                     args=(fn, tuple(args)))
    res, text = outs[0]
    sys.stdout.write(text)
    sys.stdout.flush()
    return res
