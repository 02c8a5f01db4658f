"""Continuous-batching serving demo on the PyTorch port: a pruned
(ticket) LM behind ``ServeEngine`` with block-sparse decode.

    PYTHONPATH=src python examples/torch_serve_pruned.py [--arch yi-6b] \
        [--temperature 0.8] [--no-bsmm] [--device cpu]

Builds a reduced config of the chosen architecture, prunes it
crossbar-aware through ``repro_torch.api.structured_prune``, and serves
a queue of mixed-length, mixed-budget requests.  The engine prefills
each request padded to a length bucket (masked, so padding never
contaminates attention), refills slots mid-decode the moment a request
finishes, and routes the decode projections through the block-sparse
kernel using the tile bitmap derived from the ticket's masks — then
prints the throughput report (tokens/s, slot occupancy, skipped-tile
fraction).  ``--device`` defaults to ``cuda``.
"""
import argparse
import sys
sys.path.insert(0, "src")

import numpy as np
import torch

from repro_torch.api import LMAdapter, structured_prune
from repro_torch.configs import PruneConfig, get_arch, scaled_down
from repro_torch.core.masks import apply_masks, lm_prunable, sparsity_fraction
from repro_torch.serve import Request, ServeEngine


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; >0 = temperature sampling")
    ap.add_argument("--sample-seed", type=int, default=0)
    ap.add_argument("--no-bsmm", action="store_true",
                    help="decode dense even though masks are available")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args()

    cfg = scaled_down(get_arch(args.arch), dtype="float32")
    adapter = LMAdapter(cfg, device=args.device)
    params = adapter.init_params(
        torch.Generator(device=adapter.device).manual_seed(0))

    # prune the serving weights (tile/crossbar-aware)
    masks = structured_prune(params, [("filter", 0.2), ("index", 0.2)],
                             prunable=lm_prunable, cfg=PruneConfig())
    params = apply_masks(params, masks)
    print(f"serving {cfg.name} at {sparsity_fraction(masks):.1%} sparsity")

    prefill_fn, decode_fn = adapter.serve_fns()
    engine = ServeEngine(params=params, cfg=cfg, prefill_fn=prefill_fn,
                         decode_fn=decode_fn, batch_slots=4, capacity=128,
                         temperature=args.temperature,   # <=0 → greedy
                         sample_seed=args.sample_seed,
                         masks=None if args.no_bsmm else masks,
                         device=adapter.device)
    rng_np = np.random.RandomState(0)
    for i in range(args.requests):
        prompt = rng_np.randint(0, 200, size=rng_np.randint(4, 24))
        # mixed budgets: short and long requests share slots; the
        # scheduler refills a slot the moment its request finishes
        engine.submit(Request(uid=i, prompt=prompt.astype(np.int32),
                              max_new_tokens=max(2, (i % 3 + 1)
                                                 * args.max_new // 3)))
    done = engine.run()
    for r in sorted(done, key=lambda r: r.uid)[:6]:
        print(f"req {r.uid:02d}: prompt[{len(r.prompt):2d} toks] → "
              f"{r.tokens}")
    rep = engine.report
    mode = ("greedy" if args.temperature <= 0
            else f"T={args.temperature:.2f}")
    print(f"served {rep.requests} requests ({mode}) | "
          f"{rep.tokens_generated} tokens in {rep.decode_steps} decode "
          f"steps | occupancy {rep.slot_occupancy:.0%} | "
          f"{rep.tokens_per_s:.1f} tok/s")
    if rep.bsmm_enabled:
        print(f"bsmm decode: {rep.routed_matmuls} projections routed, "
              f"{rep.live_tiles}/{rep.total_tiles} tiles live "
              f"({rep.skipped_tile_fraction:.0%} skipped)")
    else:
        print("bsmm decode: off (dense)")


if __name__ == "__main__":
    main()
