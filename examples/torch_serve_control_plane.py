"""Serving control-plane demo on the PyTorch port: streaming,
deadlines, zero-drain swap.

    PYTHONPATH=src python examples/torch_serve_control_plane.py \
        [--arch yi-6b] [--device cpu]

The full lifecycle on one tiny model:

1. Prune TWO tickets at different rates and export them (they embed
   the recipe + arch metadata the ticket manager verifies).
2. Register both with ``TicketManager`` — each gets an accuracy
   fingerprint (greedy smoke-decode of a fixed probe).
3. Serve streaming requests through ``ServeFrontend`` (per-token
   callbacks, bounded admission queue, one request with a deadline).
4. Mid-decode, hot-swap ticket B into the live engine: in-flight
   requests finish bit-identical to a no-swap oracle, and the next
   admitted request decodes under B's tile plans — the skipped-tile
   fraction shift is printed as proof.

``--device`` defaults to ``cuda``.
"""
import argparse
import sys
import tempfile
sys.path.insert(0, "src")

import numpy as np
import torch

from repro_torch.api import structured_prune
from repro_torch.api.registry import make_adapter
from repro_torch.configs import PruneConfig
from repro_torch.core import lottery
from repro_torch.serve import Request, ServeFrontend, TicketManager


def export_ticket(adapter, params, stages, path):
    masks = structured_prune(params, stages, prunable=adapter.prunable,
                             cfg=PruneConfig())
    lottery.export_ticket(path, lottery.snapshot(params), masks,
                          meta={"arch": adapter.cfg.name,
                                "recipe": {"name": "demo"},
                                "quantize_bits": None})
    return masks


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args()

    adapter = make_adapter(args.arch, scale="tiny", device=args.device)
    params = adapter.init_params(
        torch.Generator(device=adapter.device).manual_seed(0))
    tmp = tempfile.mkdtemp(prefix="tickets-")
    export_ticket(adapter, params, [("filter", 0.2)], f"{tmp}/a")
    export_ticket(adapter, params, [("xbar", 0.4), ("filter", 0.3)],
                  f"{tmp}/b")

    manager = TicketManager.from_adapter(adapter)
    rec_a = manager.register("a", f"{tmp}/a")
    rec_b = manager.register("b", f"{tmp}/b")
    print(f"registered tickets: a (fp={rec_a.fingerprint[:3]}...), "
          f"b (fp={rec_b.fingerprint[:3]}...)")

    mk = lambda: [Request(uid=i,
                          prompt=np.arange(1 + i, 9 + i, dtype=np.int32),
                          max_new_tokens=args.max_new) for i in range(3)]

    # oracle: the same traffic served entirely on ticket A
    oracle_eng = manager.make_engine("a", batch_slots=4, capacity=96)
    for r in mk():
        oracle_eng.submit(r)
    oracle = {r.uid: list(r.tokens) for r in oracle_eng.run()}
    skip_a = oracle_eng.report.skipped_tile_fraction

    # live: same traffic, streaming, swap to B mid-decode
    engine = manager.make_engine("a", batch_slots=4, capacity=96)
    frontend = ServeFrontend(engine)
    for r in mk():
        r.on_token = (lambda uid: lambda t:
                      print(f"  stream uid={uid}: {t}"))(r.uid)
        frontend.submit(request=r)
    frontend.pump(3)                       # requests now mid-decode
    ev = manager.swap(frontend, "b")
    print(f"swap(b): accepted={ev.accepted} gen={ev.gid} "
          f"skipped tiles {skip_a:.0%} -> {ev.skipped_tile_fraction:.0%}")

    # a post-swap admission (with a deadline) decodes under B's plans
    probe = frontend.submit(np.arange(2, 10, dtype=np.int32), uid=99,
                            max_new_tokens=args.max_new, deadline_s=60.0)
    frontend.drain()

    done = {r.uid: r for r in frontend.finished}
    match = all(done[u].tokens == oracle[u] for u in oracle)
    print(f"in-flight outputs bit-identical to no-swap oracle: {match}")
    print(f"probe request served on generation "
          f"{probe.request.generation} (ticket b)")
    rep = engine.report
    print(f"report: {rep.requests} requests | ttft p50 "
          f"{rep.ttft_p50 * 1e3:.1f}ms | tok/s p50 {rep.tps_p50:.1f} | "
          f"deadline misses {rep.deadline_misses} | swaps {rep.swaps}")
    if not (match and ev.accepted and probe.request.generation == ev.gid):
        raise SystemExit("zero-drain hot-swap demo FAILED")
    print("zero-drain hot-swap demo OK")


if __name__ == "__main__":
    main()
