"""Production serving launcher (a port of ``repro.launch.serve``: the
control plane over the batched engine).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --smoke \\
        [--requests N] [--pruned FRAC] [--deadline S] [--heartbeat-dir D] \\
        [--engines N] [--mesh DxM] [--device cuda]

Requests are admitted through ``serve.frontend.ServeFrontend``: a
bounded intake queue backs onto the engine's capacity check, deadlines
cancel expired slots mid-decode, and (with ``--heartbeat-dir``) the
engine's per-tick heartbeat gates admission when the decode loop
wedges.  ``--engines N`` fronts N engines with a ``FleetRouter``
(least-loaded dispatch + heartbeat failover).  ``--pruned F`` prunes
crossbar-aware in three steps (filter, channel, index) of
``1 - (1 - F) ** (1/3)`` each, and the engines decode through the
ticket's tile plans.

Which config runs where is ``launch.mesh.launcher_mesh``'s choice, as
in ``launch.train``: ``--smoke`` the reduced f32 config on a (1, 1)
mesh, otherwise the full config — on the card in a single process, on
the production mesh when the process group has its ranks.  ``--mesh DxM`` runs the reduced config on D·M
local ranks (``launch.mesh.run_printing_rank0``: gloo on ``--device
cpu``), each engine sharded over the (data, model) mesh; rank 0 prints.

Like the reference's launcher, this one builds every arch through
``models.transformer``; an encoder-decoder config (whisper-tiny) is
refused there with a ``ValueError`` (the reference builds a decoder-only
stack from its widths and serves that; ``python -m repro_torch.api
serve`` serves it with its encoder).
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from repro_torch._bridge import resolve_device
from repro_torch.configs import get_arch, scaled_down
from repro_torch.core import algorithm as alg
from repro_torch.core.masks import (apply_masks, lm_prunable, make_masks,
                                    sparsity_fraction)
from repro_torch.distributed.fault_tolerance import HeartbeatMonitor
from repro_torch.launch.mesh import (launcher_mesh, parse_mesh,
                                     run_printing_rank0)
from repro_torch.models import transformer as tfm
from repro_torch.serve import FleetRouter, ServeEngine, ServeFrontend

__all__ = ["main", "parse_mesh", "serve"]


def init_params(cfg, device):
    """The launcher's parameters: seed 0, through ``models.transformer``
    for every arch (as the reference's launcher builds them)."""
    gen = torch.Generator(device=device).manual_seed(0)
    return tfm.init_params(gen, cfg, device=device)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--pruned", type=float, default=0.0)
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-request deadline in seconds (expired "
                         "requests free their slot mid-decode)")
    ap.add_argument("--heartbeat-dir", default=None,
                    help="HeartbeatMonitor root for decode-loop liveness")
    ap.add_argument("--engines", type=int, default=1,
                    help="fleet size (FleetRouter over N engines)")
    ap.add_argument("--mesh", default=None,
                    help="per-engine DxM mesh, e.g. 1x2: D*M local ranks")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    return ap


def serve(args, cfg, mesh, device):
    """Prune (``--pruned``), then serve ``--requests`` prompts through
    one engine behind a ``ServeFrontend`` or a fleet of ``--engines``;
    prints the reference's report lines and returns the engine's
    ``ServeReport`` (the fleet's ``FleetReport``)."""
    params = init_params(cfg, device)
    masks = None
    if args.pruned > 0:
        masks = make_masks(params, lm_prunable)
        per_step = 1 - (1 - args.pruned) ** (1 / 3)
        for gran in ("filter", "channel", "index"):
            masks = alg.prune_step(params, masks, gran, per_step,
                                   lambda p: False)
        params = apply_masks(params, masks)
        print(f"serving at {sparsity_fraction(masks):.1%} sparsity "
              f"(crossbar-aware)")

    monitor = (HeartbeatMonitor(args.heartbeat_dir, deadline_s=30.0)
               if args.heartbeat_dir else None)

    def make_engine(heartbeat=None, worker="engine"):
        return ServeEngine(params=params, cfg=cfg,
                           prefill_fn=tfm.prefill,
                           decode_fn=tfm.decode_step,
                           batch_slots=8, capacity=256, masks=masks,
                           heartbeat=heartbeat, heartbeat_worker=worker,
                           mesh=mesh, device=device)

    rng = np.random.RandomState(0)
    if args.engines > 1:
        router = FleetRouter([make_engine() for _ in range(args.engines)],
                             monitor=monitor)
        for i in range(args.requests):
            router.submit(
                rng.randint(0, 200, rng.randint(4, 32)).astype(np.int32),
                uid=i, max_new_tokens=args.max_new,
                deadline_s=args.deadline)
        router.drain()
        rep = router.report
        print(f"fleet: {rep.live_engines}/{rep.engines} engines, "
              f"{rep.requests} requests, {rep.tokens_generated} tokens "
              f"({rep.tokens_per_s:.1f} tok/s, "
              f"failovers {rep.failovers}, "
              f"redispatched {rep.redispatched})")
        print(f"latency: ttft p50/p95 {rep.ttft_p50 * 1e3:.1f}/"
              f"{rep.ttft_p95 * 1e3:.1f}ms | per-request tok/s p50/p95 "
              f"{rep.tps_p50:.1f}/{rep.tps_p95:.1f} | "
              f"deadline misses {rep.deadline_misses}")
        return rep

    engine = make_engine(heartbeat=monitor)
    frontend = ServeFrontend(engine)
    for i in range(args.requests):
        frontend.submit(
            rng.randint(0, 200, rng.randint(4, 32)).astype(np.int32),
            uid=i, max_new_tokens=args.max_new,
            deadline_s=args.deadline)
    frontend.drain()
    rep = engine.report
    print(f"served {rep.requests} requests, {rep.tokens_generated} tokens "
          f"in {rep.decode_steps} decode steps "
          f"(occupancy {rep.slot_occupancy:.0%}, "
          f"{rep.tokens_per_s:.1f} tok/s, "
          f"bsmm={'on' if rep.bsmm_enabled else 'off'})")
    print(f"latency: ttft p50/p95 {rep.ttft_p50 * 1e3:.1f}/"
          f"{rep.ttft_p95 * 1e3:.1f}ms | per-request tok/s p50/p95 "
          f"{rep.tps_p50:.1f}/{rep.tps_p95:.1f} | "
          f"deadline misses {rep.deadline_misses}")
    return rep


def _mesh_rank(mesh, argd: dict):
    """One rank of ``--mesh``: the reduced config's engine on ``mesh``,
    on the device the spawner gave this rank."""
    args = argparse.Namespace(**argd)
    cfg = scaled_down(get_arch(args.arch), dtype="float32")
    return serve(args, cfg, mesh, resolve_device(args.device))


def main(argv: Optional[List[str]] = None):
    """Serve and print the report lines; returns the report (rank 0's
    under ``--mesh``)."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)       # no card: raise before spawning
    if args.mesh:
        d, m = parse_mesh(args.mesh)
        return run_printing_rank0(_mesh_rank, d, m, device=args.device,
                                  args=(vars(args),))
    with launcher_mesh(args.arch, args.smoke, multi_pod=args.multi_pod,
                       device=dev) as (cfg, mesh, _):
        return serve(args, cfg, mesh, dev)


if __name__ == "__main__":
    main()
