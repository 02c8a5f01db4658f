"""``python -m repro_torch.api`` — prune / finetune / report / serve (a
port of ``repro.api.cli``).

One CLI over the session layer: every name in ``configs.list_archs() +
list_cnns()`` resolves through the family registry to an adapter (the
families this port has: CNNs and dense LMs), so the same subcommands
drive both.  Every subcommand that builds a model takes ``--device``
(default ``cuda``; ``--device cpu`` runs the kernels' plain versions).

    python -m repro_torch.api archs
    python -m repro_torch.api recipes
    python -m repro_torch.api prune --arch vgg11 --scale tiny --rounds 1
    python -m repro_torch.api report   --arch vgg11 --ticket t/
    python -m repro_torch.api finetune --arch vgg11 --ticket t/ --steps 20
    python -m repro_torch.api serve    --arch llama3.2-3b --requests 4
    python -m repro_torch.api serve --arch llama3.2-3b --engines 2 --json
    python -m repro_torch.api serve-daemon --arch llama3.2-3b --ticket t/
    python -m repro_torch.api swap --arch llama3.2-3b --ticket a/ \\
        --candidate b/

``--recipe`` runs a staged prune program (a registered name from
``recipes`` or a path to a recipe ``.json``); without it the legacy
flat granularity schedule applies.  ``--json`` switches event output
to one JSON object per line (machine-readable: round events carry the
stage name/index and kind, sparsity, accuracy, and the bsmm live-tile
fraction) for scripting and bench harnesses.

    python -m repro_torch.api lint --all --kernels --device cpu --json

``serve`` and ``serve-daemon`` take ``--mesh DxM``: the command runs
on D·M local ranks (``launch.mesh.run_ranks``; gloo on ``--device cpu``;
on ``cuda`` NCCL with a card a rank, or gloo when the ranks outnumber
the cards and share them), every rank driving its own copy of the engine on a
(data, model) mesh, and rank 0's output is printed when the ranks end
(the daemon reads its whole script — or stdin — before it starts).

Exit codes: 0 success; 1 ``lint`` found an error; 2 structured refusal
(e.g. ``serve`` on a family with no serving path — reported, not a
traceback).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import List, Optional

import numpy as np
import torch

from repro_torch.serve.manager import TicketMismatch

EXIT_OK = 0
EXIT_UNSUPPORTED = 2


def _emit(obj: dict, as_json: bool, human: str):
    if as_json:
        print(json.dumps(obj), flush=True)
    else:
        print(human, flush=True)


def _hardware_dict(rep) -> dict:
    return {
        "cell_sparsity": rep.sparsity,
        "cell_savings": rep.cell_savings,
        "xbars_unpruned": rep.xbars_unpruned,
        "xbars_needed": rep.xbars_needed,
        "xbar_savings": rep.xbar_savings,
    }


def _generator(adapter, seed: int) -> torch.Generator:
    """The generator ``init_params`` draws from, on the adapter's device."""
    return torch.Generator(device=adapter.device).manual_seed(seed)


def _load_ticket(adapter, path: str, seed: int):
    """Ticket dir → (rewound params, masks) shaped like the adapter.

    Delegates to ``serve.manager.load_ticket``, which validates the
    stored mask keys/shapes against the adapter's template first
    (``import_ticket`` silently skips mismatched keys, which would
    otherwise surface as a deep traceback much later) and raises
    ``TicketMismatch`` on disagreement.
    """
    from repro_torch.serve.manager import load_ticket

    params = adapter.init_params(_generator(adapter, seed))
    rewound, masks, _meta = load_ticket(
        path, params, adapter.prunable,
        arch_name=getattr(adapter.cfg, "name", "?"))
    return rewound, masks


def _ticket_mismatch(args, e) -> int:
    _emit({"event": "ticket_mismatch", "arch": args.arch,
           "ticket": args.ticket, "reason": str(e)},
          args.json, f"error: {e}")
    return EXIT_UNSUPPORTED


def _add_common(p: argparse.ArgumentParser, ticket_required: bool = False):
    p.add_argument("--arch", required=True,
                   help="any name from `python -m repro_torch.api archs`")
    p.add_argument("--scale", default="tiny", choices=("tiny", "full"),
                   help="tiny: reduced config + seconds-scale training "
                        "budget; full: the registered config")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the kernels' plain "
                        "versions)")
    p.add_argument("--json", action="store_true",
                   help="one JSON object per event line")
    if ticket_required:
        p.add_argument("--ticket", required=True,
                       help="ticket directory from `prune --ticket`")


def cmd_archs(args) -> int:
    from repro_torch.api.registry import list_adaptable, resolve_config

    rows = []
    for name in list_adaptable():
        cfg, spec = resolve_config(name)
        rows.append({"arch": name, "family": spec.family,
                     "adapter": spec.adapter_factory.__name__,
                     "granularities": list(spec.granularities or ()),
                     "recipe": spec.recipe,
                     "serves": spec.serves})
    if args.json:
        for r in rows:
            print(json.dumps(r))
    else:
        for r in rows:
            grans = ",".join(r["granularities"]) or "(paper schedule)"
            print(f"{r['arch']:28s} {r['family']:7s} "
                  f"{r['adapter']:14s} "
                  f"grans={grans} recipe={r['recipe']} "
                  f"serves={r['serves']}")
    return EXIT_OK


def cmd_prune(args) -> int:
    from repro_torch.api.registry import make_adapter
    from repro_torch.api.session import PruningSession
    from repro_torch.configs import PruneConfig

    adapter = make_adapter(args.arch, scale=args.scale, device=args.device,
                           **({"steps": args.steps} if args.steps else {}))
    cfg = PruneConfig(prune_fraction=args.fraction, max_iters=args.rounds,
                      accuracy_tolerance=args.tolerance)
    grans = args.granularity.split(",") if args.granularity else None

    def on_event(e):
        stats = getattr(adapter, "last_plan_stats", None)
        live = (1.0 - stats.skipped_tile_fraction
                if stats is not None and stats.routed else None)
        verdict = ("keep" if e.accepted else
                   "scored" if e.kind == "ablate" else "undo")
        _emit({"event": "round", "arch": args.arch,
               "iteration": e.iteration, "stage": e.stage,
               "stage_idx": e.stage_idx, "kind": e.kind,
               "granularity": e.granularity,
               "sparsity_before": e.sparsity_before,
               "sparsity_after": e.sparsity_after,
               "accuracy": e.accuracy, "accepted": e.accepted,
               "live_tile_fraction": live,
               "comm_sent_fraction": e.comm_sent_fraction,
               "comm_bytes_per_step": e.comm_bytes_per_step},
              args.json,
              f"round {e.iteration} [{e.stage}] sparsity "
              f"{e.sparsity_before:.3f}->{e.sparsity_after:.3f} "
              f"acc {e.accuracy:.4f} ({verdict})")

    session = PruningSession(adapter, cfg, recipe=args.recipe,
                             granularities=grans,
                             seed=args.seed, ckpt_dir=args.ckpt,
                             callbacks=[on_event])
    if args.steps:
        # an explicit --steps wins over per-stage retrain budgets no
        # matter where the recipe came from (--recipe, the family
        # registry at --scale full, or cfg) — smoke runs stay cheap
        session.recipe = session.recipe.with_retrain_steps(args.steps)
    res = session.run()
    if args.ticket:
        session.export_ticket(args.ticket)
    rep = session.hardware_report()
    _emit({"event": "result", "arch": args.arch,
           "sparsity": res.sparsity, "iterations": len(res.history),
           "recipe": session.recipe.name,
           "stages": [s.name for s in session.recipe.stages],
           "granularities": session.grans,
           "quantize_bits": session.quantize_bits,
           "weight_bytes": rep.weight_bytes(),
           "ticket": args.ticket, **_hardware_dict(rep)},
          args.json,
          f"{args.arch}: sparsity {res.sparsity:.1%} after "
          f"{len(res.history)} rounds of recipe "
          f"'{session.recipe.name}' | crossbars "
          f"{rep.xbars_needed}/{rep.xbars_unpruned} "
          f"(-{rep.xbar_savings:.1%}), cell savings {rep.cell_savings:.1%}"
          + (f" | int{session.quantize_bits} QAT accepted"
             if session.quantize_bits else "")
          + (f" | ticket -> {args.ticket}" if args.ticket else ""))
    return EXIT_OK


def cmd_recipes(args) -> int:
    from repro_torch.api.recipes import available_recipes, get_recipe
    from repro_torch.api.registry import available_families, get_family

    tuned_by = {}
    for fam in available_families():
        name = get_family(fam).recipe
        if name:
            tuned_by.setdefault(name, []).append(fam)
    for name in available_recipes():
        r = get_recipe(name)
        row = {"recipe": name,
               "stages": [s.name for s in r.stages],
               "families": tuned_by.get(name, []),
               "description": r.description}
        _emit(row, args.json,
              f"{name:14s} {' -> '.join(row['stages'])}"
              + (f"  [tuned: {','.join(row['families'])}]"
                 if row["families"] else ""))
    return EXIT_OK


def cmd_lint(args) -> int:
    """Static sparsity lint; exits 1 on any error-severity finding, 2 on
    a structured refusal (an unknown rule code, no target)."""
    from repro_torch.analysis import lint_arch, lint_kernels
    from repro_torch.api.registry import list_adaptable

    if args.explain is not None:
        from repro_torch.analysis.findings import RULES, explain
        code = args.explain.upper()
        if code not in RULES:
            _emit({"error": "unknown rule", "code": code,
                   "known": sorted(RULES)}, args.json,
                  f"unknown rule {code}; known: "
                  f"{', '.join(sorted(RULES))}")
            return EXIT_UNSUPPORTED
        rule = RULES[code]
        _emit({"code": rule.code, "family": rule.family,
               "title": rule.title, "doc": rule.doc}, args.json,
              explain(code))
        return EXIT_OK

    if not (args.all or args.arch or args.kernels):
        print("lint: one of --arch, --all, --kernels, or --explain "
              "is required")
        return EXIT_UNSUPPORTED

    any_error = False
    # the kernel audit (K3xx) is part of the full gate: on by default
    # for --all, opt-in alongside --arch, standalone via bare --kernels
    if args.kernels or args.all:
        rep = lint_kernels()
        any_error = not rep.ok
        summary = rep.summary()
        _emit({"arch": "kernels", **rep.to_dict()}, args.json,
              f"{'kernels':28s} findings={summary['findings']} "
              f"errors={summary['error']} "
              f"warnings={summary['warning']} "
              f"{'OK' if rep.ok else 'FAIL'}")
        if not args.json:
            for f in rep.findings:
                print(f"  {f}")

    names = (list_adaptable() if args.all
             else [args.arch] if args.arch else [])
    for name in names:
        rep = lint_arch(name, recipe=args.recipe, scale=args.scale,
                        seed=args.seed, hlo=args.hlo, device=args.device)
        any_error = any_error or not rep.ok
        summary = rep.summary()
        _emit({"arch": name, **rep.to_dict()}, args.json,
              f"{name:28s} findings={summary['findings']} "
              f"errors={summary['error']} "
              f"warnings={summary['warning']} "
              f"{'OK' if rep.ok else 'FAIL'}")
        if not args.json:
            for f in rep.findings:
                print(f"  {f}")
    return 1 if any_error else EXIT_OK


def cmd_finetune(args) -> int:
    from repro_torch.api.registry import make_adapter
    from repro_torch.core.lottery import ticket_meta

    adapter = make_adapter(args.arch, scale=args.scale, device=args.device,
                           **({"steps": args.steps} if args.steps else {}))
    try:
        params, masks = _load_ticket(adapter, args.ticket, args.seed)
    except TicketMismatch as e:
        return _ticket_mismatch(args, e)
    # tickets from a recipe with an accepted quantize stage fine-tune
    # quantization-aware — the embedded metadata carries the bits
    bits = ticket_meta(args.ticket).get("quantize_bits")
    trained = adapter.train(params, masks, args.steps, quantize_bits=bits)
    score = adapter.evaluate(trained, masks)
    metrics = getattr(adapter, "last_metrics", {})
    _emit({"event": "finetune", "arch": args.arch, "ticket": args.ticket,
           "steps": args.steps, "score": score,
           "quantize_bits": bits,
           "loss": metrics.get("loss")},
          args.json,
          f"{args.arch}: ticket fine-tuned {args.steps or 'default'} "
          f"steps, eval score {score:.4f}"
          + (f", loss {metrics['loss']:.4f}" if "loss" in metrics else "")
          + (f" (int{bits} QAT)" if bits else ""))
    return EXIT_OK


def cmd_report(args) -> int:
    from repro_torch.api.registry import make_adapter
    from repro_torch.core.hardware import analyze_masks
    from repro_torch.core.lottery import ticket_meta
    from repro_torch.core.masks import sparsity_fraction

    adapter = make_adapter(args.arch, scale=args.scale, device=args.device)
    try:
        _, masks = _load_ticket(adapter, args.ticket, args.seed)
    except TicketMismatch as e:
        return _ticket_mismatch(args, e)
    pc = adapter.cfg.prune
    meta = ticket_meta(args.ticket)
    bits = meta.get("quantize_bits")
    rep = analyze_masks(masks, adapter.conv_pred,
                        xbar_rows=pc.xbar_rows, xbar_cols=pc.xbar_cols,
                        quant_bits=bits,
                        dtype=getattr(adapter.cfg, "dtype", None))
    bytes_d = rep.weight_bytes()
    recipe = meta.get("recipe") or {}
    human_bytes = ""
    if bits:
        human_bytes = (f" | int{bits} weights "
                       f"{bytes_d['quantized_bytes'] / 1e6:.2f}MB "
                       f"(dense {bytes_d['dense_bytes'] / 1e6:.2f}MB)")
    _emit({"event": "report", "arch": args.arch, "ticket": args.ticket,
           "mask_sparsity": sparsity_fraction(masks),
           "xbar_rows": pc.xbar_rows, "xbar_cols": pc.xbar_cols,
           "recipe": recipe.get("name"),
           "quantize_bits": bits,
           "weight_bytes": bytes_d,
           **_hardware_dict(rep)},
          args.json,
          f"{args.arch}: ticket sparsity {sparsity_fraction(masks):.1%} | "
          f"{pc.xbar_rows}x{pc.xbar_cols} crossbars "
          f"{rep.xbars_needed}/{rep.xbars_unpruned} "
          f"(-{rep.xbar_savings:.1%}) | cell savings {rep.cell_savings:.1%}"
          + human_bytes)
    return EXIT_OK


def _report_dict(rep) -> dict:
    """ServeReport → JSON payload (the --json serving surface)."""
    return {"requests": rep.requests, "tokens": rep.tokens_generated,
            "decode_steps": rep.decode_steps,
            "slot_occupancy": rep.slot_occupancy,
            "tokens_per_s": rep.tokens_per_s,
            "bsmm": rep.bsmm_enabled,
            "skipped_tile_fraction": rep.skipped_tile_fraction,
            "ttft_p50_ms": rep.ttft_p50 * 1e3,
            "ttft_p95_ms": rep.ttft_p95 * 1e3,
            "tps_p50": rep.tps_p50, "tps_p95": rep.tps_p95,
            "deadline_misses": rep.deadline_misses,
            "swaps": rep.swaps,
            "paged": rep.paged,
            "kv_blocks": rep.kv_blocks,
            "kv_blocks_live": rep.kv_blocks_live,
            "kv_blocks_peak": rep.kv_blocks_peak,
            "kv_block_bytes": rep.kv_block_bytes,
            "kv_bytes_per_token": rep.kv_bytes_per_token}


def _fleet_report_dict(rep) -> dict:
    """FleetReport → JSON payload (merged + per-engine)."""
    return {"engines": rep.engines, "live_engines": rep.live_engines,
            "requests": rep.requests, "tokens": rep.tokens_generated,
            "failovers": rep.failovers, "redispatched": rep.redispatched,
            "swaps": rep.swaps, "tokens_per_s": rep.tokens_per_s,
            "ttft_p50_ms": rep.ttft_p50 * 1e3,
            "ttft_p95_ms": rep.ttft_p95 * 1e3,
            "tps_p50": rep.tps_p50, "tps_p95": rep.tps_p95,
            "deadline_misses": rep.deadline_misses,
            "per_engine": [_report_dict(p) for p in rep.per_engine]}


def _latency_line(rep) -> str:
    return (f"ttft p50/p95 {rep.ttft_p50 * 1e3:.1f}/"
            f"{rep.ttft_p95 * 1e3:.1f}ms | per-request tok/s p50/p95 "
            f"{rep.tps_p50:.1f}/{rep.tps_p95:.1f} | "
            f"deadline misses {rep.deadline_misses}")


def _serve_setup(args):
    """Shared serve-verb boot: adapter + (prefill, decode) or a
    structured refusal.  Returns (adapter, fns | None, exit_code)."""
    from repro_torch.api.adapters import ServeUnsupported
    from repro_torch.api.registry import make_adapter

    adapter = make_adapter(args.arch, scale=args.scale, device=args.device)
    try:
        fns = adapter.serve_fns()
    except ServeUnsupported as e:
        _emit({"event": "serve_unsupported", "arch": e.arch,
               "family": e.family, "reason": e.reason},
              args.json,
              f"serve: {e.arch} ({e.family} family) has no serving path "
              f"— {e.reason}")
        return adapter, None, EXIT_UNSUPPORTED
    return adapter, fns, EXIT_OK


def _on_mesh(args) -> int:
    """Run ``args.fn`` on the D·M local ranks of ``--mesh DxM`` and
    print rank 0's output; the daemon's ops are read here first (a
    spawned rank has no stdin) and handed to every rank as a script."""
    from repro_torch.launch.mesh import parse_mesh, run_printing_rank0
    d, m = parse_mesh(args.mesh)
    argd = {k: v for k, v in vars(args).items() if k != "fn"}
    tmp = None
    if args.fn is cmd_serve_daemon and not args.script:
        fd, tmp = tempfile.mkstemp(suffix=".ops")
        with os.fdopen(fd, "w") as f:
            f.write(sys.stdin.read())
        argd["script"] = tmp
    try:
        return run_printing_rank0(_mesh_rank, d, m, device=args.device,
                                  args=(args.fn.__name__, argd))
    finally:
        if tmp is not None:
            os.remove(tmp)


def _mesh_rank(mesh, cmd: str, argd: dict) -> int:
    """One rank of ``_on_mesh``: the command on ``mesh``."""
    args = argparse.Namespace(**{**argd, "mesh": None, "mesh_obj": mesh})
    return globals()[cmd](args)


def _request_frames(adapter, uid: int):
    """Per-request encoder frames for enc-dec families (None for LMs)."""
    if getattr(adapter.cfg, "is_encoder_decoder", False):
        return adapter.serve_frames(uid)
    return None


def cmd_serve(args) -> int:
    from repro_torch.serve import Request, ServeEngine

    if args.mesh:
        return _on_mesh(args)
    adapter, fns, code = _serve_setup(args)
    if fns is None:
        return code
    prefill_fn, decode_fn = fns

    if args.ticket:
        try:
            params, masks = _load_ticket(adapter, args.ticket, args.seed)
        except TicketMismatch as e:
            return _ticket_mismatch(args, e)
    else:
        params = adapter.init_params(_generator(adapter, args.seed))
        masks = None

    def mk_engine():
        return ServeEngine(params=params, cfg=adapter.cfg,
                           prefill_fn=prefill_fn, decode_fn=decode_fn,
                           batch_slots=args.slots, capacity=args.capacity,
                           temperature=args.temperature, masks=masks,
                           mesh=getattr(args, "mesh_obj", None),
                           device=adapter.device)

    rng = np.random.RandomState(args.seed)
    if args.engines > 1:
        from repro_torch.serve import FleetRouter
        router = FleetRouter([mk_engine() for _ in range(args.engines)])
        for i in range(args.requests):
            plen = (args.prompt_len if args.prompt_len
                    else rng.randint(4, 16))
            prompt = rng.randint(0, 200, size=plen)
            router.submit(prompt.astype(np.int32), uid=i,
                          max_new_tokens=args.max_new,
                          frames=_request_frames(adapter, i))
        router.drain()
        rep = router.report
        _emit({"event": "serve_fleet", "arch": args.arch,
               **_fleet_report_dict(rep)},
              args.json,
              f"{args.arch}: fleet of {rep.engines} served "
              f"{rep.requests} requests, {rep.tokens_generated} tokens "
              f"| {rep.tokens_per_s:.1f} tok/s | {_latency_line(rep)}")
        return EXIT_OK
    engine = mk_engine()
    for i in range(args.requests):
        plen = args.prompt_len if args.prompt_len else rng.randint(4, 16)
        prompt = rng.randint(0, 200, size=plen)
        engine.submit(Request(uid=i, prompt=prompt.astype(np.int32),
                              max_new_tokens=args.max_new,
                              frames=_request_frames(adapter, i)))
    done = engine.run()
    rep = engine.report
    _emit({"event": "serve", "arch": args.arch, **_report_dict(rep),
           "streams": {str(r.uid): [int(t) for t in r.tokens]
                       for r in sorted(done, key=lambda r: r.uid)}},
          args.json,
          f"{args.arch}: served {rep.requests} requests, "
          f"{rep.tokens_generated} tokens in {rep.decode_steps} decode "
          f"steps | occupancy {rep.slot_occupancy:.0%} | "
          f"{rep.tokens_per_s:.1f} tok/s | {_latency_line(rep)} | "
          + (f"bsmm on ({rep.skipped_tile_fraction:.0%} tiles skipped)"
             if rep.bsmm_enabled else "bsmm off (dense)"))
    return EXIT_OK


def cmd_serve_daemon(args) -> int:
    """Line-protocol control-plane daemon.

    Reads one JSON op per line (stdin or ``--script``)::

        {"op": "request", "prompt": [1,2,3], "max_new_tokens": 8,
         "deadline_s": 2.0}              # admit
        {"op": "pump", "steps": 4}       # advance the scheduler
        {"op": "swap", "name": "b", "ticket": "/path/to/ticket"}
        {"op": "kill", "engine": 1}      # fleet only: fail an engine,
                                         # re-dispatch its requests
        {"op": "status"}                 # health + live report
        {"op": "drain"}                  # serve everything queued
        {"op": "shutdown"}               # drain and exit 0

    Emits one event per line: ``ready``, ``admitted``/``rejected``,
    ``token`` (streaming, as each token is sampled), ``done``,
    ``swap``/``swap_rejected``, ``status``, and a final ``report`` +
    ``shutdown``.  EOF behaves like ``shutdown``.
    """
    from repro_torch.distributed.fault_tolerance import HeartbeatMonitor
    from repro_torch.serve import (ServeEngine, ServeFrontend,
                                   SubmitRejected, TicketError,
                                   TicketManager)

    if args.mesh:
        return _on_mesh(args)
    adapter, fns, code = _serve_setup(args)
    if fns is None:
        return code
    prefill_fn, decode_fn = fns

    manager = TicketManager.from_adapter(adapter, seed=args.seed)
    if args.ticket:
        try:
            rec = manager.register("boot", args.ticket)
        except TicketError as e:
            _emit({"event": "ticket_rejected", "ticket": args.ticket,
                   "reason": e.reason, "detail": str(e)},
                  args.json, f"error: {e}")
            return EXIT_UNSUPPORTED
        params, masks = rec.params, rec.masks
        manager.active = "boot"
    else:
        params = adapter.init_params(_generator(adapter, args.seed))
        masks = None
    heartbeat = (HeartbeatMonitor(args.heartbeat_dir,
                                  deadline_s=args.heartbeat_deadline)
                 if args.heartbeat_dir else None)
    fleet = args.engines > 1

    def mk_engine(hb=None):
        return ServeEngine(params=params, cfg=adapter.cfg,
                           prefill_fn=prefill_fn, decode_fn=decode_fn,
                           batch_slots=args.slots,
                           capacity=args.capacity,
                           temperature=args.temperature, masks=masks,
                           heartbeat=hb, mesh=getattr(args, "mesh_obj", None),
                           device=adapter.device)

    if fleet:
        from repro_torch.serve import FleetRouter
        router = FleetRouter([mk_engine() for _ in range(args.engines)],
                             monitor=heartbeat, max_queue=args.max_queue)
        front, engine = router, router.frontends[0].engine
    else:
        engine = mk_engine(hb=heartbeat)
        router = None
        front = ServeFrontend(engine, max_queue=args.max_queue)
    rng = np.random.RandomState(args.seed)
    next_uid = [0]

    def mk_cb(uid):
        def cb(tok):
            _emit({"event": "token", "uid": uid, "token": int(tok)},
                  args.json, f"  token uid={uid}: {tok}")
        return cb

    def emit_done(done):
        for r in done:
            _emit({"event": "done", "uid": r.uid, "status": r.status,
                   "generation": r.generation,
                   "tokens": [int(t) for t in r.tokens],
                   "ttft_ms": None if r.ttft is None else r.ttft * 1e3},
                  args.json,
                  f"  done uid={r.uid} [{r.status}] gen={r.generation} "
                  f"tokens={r.tokens}")

    _emit({"event": "ready", "arch": args.arch, "ticket": args.ticket,
           "slots": args.slots, "engines": args.engines,
           "bsmm": engine.report.bsmm_enabled,
           "generation": engine.current_generation},
          args.json,
          f"daemon ready: {args.arch} slots={args.slots} "
          f"engines={args.engines} "
          + (f"ticket={args.ticket}" if args.ticket else "(unpruned)"))

    stream = open(args.script) if args.script else sys.stdin
    try:
        for line in stream:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            try:
                cmd = json.loads(line)
            except json.JSONDecodeError as e:
                _emit({"event": "error", "reason": f"bad json: {e}"},
                      args.json, f"error: bad json: {e}")
                continue
            op = cmd.get("op")
            if op == "request":
                uid = int(cmd.get("uid", next_uid[0]))
                next_uid[0] = max(next_uid[0], uid) + 1
                prompt = cmd.get("prompt")
                if prompt is None:
                    prompt = rng.randint(
                        1, 200, size=int(cmd.get("prompt_len", 8)))
                try:
                    handle = front.submit(
                        np.asarray(prompt, np.int32), uid=uid,
                        max_new_tokens=int(cmd.get("max_new_tokens",
                                                   args.max_new)),
                        deadline_s=cmd.get("deadline_s"),
                        frames=_request_frames(adapter, uid),
                        on_token=mk_cb(uid))
                except SubmitRejected as e:
                    _emit({"event": "rejected", "uid": uid,
                           "reason": e.reason, "detail": str(e)},
                          args.json,
                          f"rejected uid={uid}: [{e.reason}] {e}")
                else:
                    _emit({"event": "admitted", "uid": uid,
                           "state": handle.status},
                          args.json,
                          f"admitted uid={uid} ({handle.status})")
            elif op == "pump":
                emit_done(front.pump(int(cmd.get("steps", 1))))
            elif op == "drain":
                emit_done(front.drain())
            elif op == "kill":
                if router is None:
                    _emit({"event": "error",
                           "reason": "kill needs --engines > 1"},
                          args.json, "error: kill needs --engines > 1")
                else:
                    idx = int(cmd.get("engine", 0))
                    recs = router.kill(idx)
                    _emit({"event": "killed", "engine": idx,
                           "live": sorted(router.live),
                           "redispatched": len(recs)},
                          args.json,
                          f"killed engine {idx}: {len(recs)} requests "
                          f"re-dispatched, live={sorted(router.live)}")
            elif op == "swap":
                name = cmd.get("name") or cmd.get("ticket")
                try:
                    if name not in manager.tickets:
                        manager.register(name, cmd["ticket"])
                    ev = manager.swap(front, name)
                    skipped = (
                        (ev.events[-1].skipped_tile_fraction
                         if ev.events else 0.0)
                        if router is not None
                        else ev.skipped_tile_fraction)
                    payload = {"event": "swap", "ticket": name,
                               "accepted": ev.accepted,
                               "generation": ev.gid, "reason": ev.reason,
                               "skipped_tile_fraction": skipped}
                    if router is not None:
                        payload["engines"] = len(ev.events)
                        payload["rolled_back"] = ev.rolled_back
                    _emit(payload, args.json,
                          f"swap {name}: "
                          + ("accepted" if ev.accepted
                             else f"REJECTED — {ev.reason}")
                          + f" (gen {ev.gid}, skipped tiles "
                            f"{skipped:.0%})")
                except (TicketError, KeyError) as e:
                    _emit({"event": "swap_rejected", "ticket": name,
                           "reason": getattr(e, "reason", "bad_request"),
                           "detail": str(e)},
                          args.json, f"swap rejected: {e}")
            elif op == "status":
                if router is not None:
                    rep = router.report
                    _emit({"event": "status",
                           "active_ticket": manager.active,
                           "waiting": sum(len(fe.waiting)
                                          for fe in router.frontends),
                           **_fleet_report_dict(rep)},
                          args.json,
                          f"status: {rep.live_engines}/{rep.engines} "
                          f"engines live | failovers {rep.failovers} | "
                          f"{_latency_line(rep)}")
                else:
                    rep = engine.report
                    _emit({"event": "status",
                           "healthy": engine.health.healthy,
                           "health_reason": engine.health.reason,
                           "active_ticket": manager.active,
                           "generation": engine.current_generation,
                           "waiting": len(front.waiting),
                           **_report_dict(rep)},
                          args.json,
                          f"status: healthy={engine.health.healthy} "
                          f"gen={engine.current_generation} "
                          f"waiting={len(front.waiting)} | "
                          f"{_latency_line(rep)}")
            elif op == "shutdown":
                break
            else:
                _emit({"event": "error", "reason": f"unknown op {op!r}"},
                      args.json, f"error: unknown op {op!r}")
    finally:
        if stream is not sys.stdin:
            stream.close()
    emit_done(front.drain())
    if router is not None:
        rep = router.report
        _emit({"event": "report", **_fleet_report_dict(rep)}, args.json,
              f"fleet served {rep.requests} requests, "
              f"{rep.tokens_generated} tokens | failovers "
              f"{rep.failovers} (redispatched {rep.redispatched}) | "
              f"{_latency_line(rep)} | swaps {rep.swaps}")
    else:
        rep = engine.report
        _emit({"event": "report", **_report_dict(rep)}, args.json,
              f"served {rep.requests} requests, {rep.tokens_generated} "
              f"tokens | {_latency_line(rep)} | swaps {rep.swaps}")
    _emit({"event": "shutdown"}, args.json, "daemon shutdown clean")
    return EXIT_OK


def cmd_swap(args) -> int:
    """Zero-drain hot-swap preflight: serve live traffic on the running
    ticket, swap the candidate in MID-DECODE, and prove (a) in-flight
    outputs are bit-identical to a swap-free oracle and (b) the next
    admitted request decodes under the candidate's tile plans."""
    from repro_torch.serve import (Request, ServeFrontend, TicketError,
                                   TicketManager)

    adapter, fns, code = _serve_setup(args)
    if fns is None:
        return code

    manager = TicketManager.from_adapter(adapter, seed=args.seed)
    try:
        manager.register("current", args.ticket)
        manager.register("candidate", args.candidate)
    except TicketError as e:
        _emit({"event": "ticket_rejected", "reason": e.reason,
               "detail": str(e)}, args.json, f"error: {e}")
        return EXIT_UNSUPPORTED

    def mk_requests():
        return [Request(uid=i,
                        prompt=np.random.RandomState(1000 + i).randint(
                            1, 200, size=8).astype(np.int32),
                        max_new_tokens=args.max_new,
                        frames=_request_frames(adapter, i))
                for i in range(args.requests)]

    kw = dict(batch_slots=args.slots, capacity=args.capacity)
    # oracle: identical traffic served to completion, no swap
    oracle_eng = manager.make_engine("current", **kw)
    for r in mk_requests():
        oracle_eng.submit(r)
    oracle = {r.uid: list(r.tokens) for r in oracle_eng.run()}
    old_skip = oracle_eng.report.skipped_tile_fraction

    # live: same traffic, candidate swapped in mid-decode
    engine = manager.make_engine("current", **kw)
    frontend = ServeFrontend(engine)
    for r in mk_requests():
        frontend.submit(request=r)
    frontend.pump(args.swap_after)
    ev = manager.swap(frontend, "candidate")
    probe = Request(uid=10_000,
                    prompt=np.random.RandomState(77).randint(
                        1, 200, size=8).astype(np.int32),
                    max_new_tokens=args.max_new,
                    frames=_request_frames(adapter, 10_000))
    frontend.submit(request=probe)
    frontend.drain()

    done = {r.uid: r for r in frontend.finished}
    in_flight = [u for u in oracle if done[u].generation == 0]
    match = all(done[u].tokens == oracle[u] for u in in_flight)
    new_skip = engine.report.skipped_tile_fraction
    ok = ev.accepted and match
    rep = engine.report
    _emit({"event": "swap_check", "arch": args.arch,
           "accepted": ev.accepted, "reason": ev.reason,
           "in_flight_match": match, "in_flight": len(in_flight),
           "probe_generation": probe.generation,
           "old_skipped_tile_fraction": old_skip,
           "new_skipped_tile_fraction": new_skip,
           **_report_dict(rep)},
          args.json,
          f"swap {'OK' if ok else 'FAILED'}: "
          f"{len(in_flight)} in-flight requests "
          f"{'bit-identical' if match else 'DIVERGED'} vs no-swap "
          f"oracle; probe served on gen {probe.generation}; skipped "
          f"tiles {old_skip:.0%} -> {new_skip:.0%} | "
          f"{_latency_line(rep)}")
    return EXIT_OK if ok else EXIT_UNSUPPORTED


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.api",
        description="Prune, fine-tune, report, and serve any registered "
                    "architecture through the repro_torch.api session "
                    "layer.")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("archs", help="list registered archs and families")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_archs)

    p = sub.add_parser("recipes",
                       help="list registered prune recipes (staged "
                            "programs) and which families they tune")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_recipes)


    p = sub.add_parser("lint",
                       help="static sparsity lint: recipe programs, "
                            "tile plans, serving state, the hot paths' "
                            "dispatched ops and the kernels' launch "
                            "geometry; exits 1 on any error finding")
    g = p.add_mutually_exclusive_group(required=False)
    g.add_argument("--arch", default=None,
                   help="any name from `python -m repro_torch.api archs`")
    g.add_argument("--all", action="store_true",
                   help="lint every registered arch (implies --kernels)")
    g.add_argument("--explain", default=None, metavar="CODE",
                   help="print the registry entry for one rule code "
                        "(e.g. --explain K301) and exit")
    p.add_argument("--kernels", action="store_true",
                   help="audit the kernels' launch geometry (K3xx)")
    p.add_argument("--recipe", default=None,
                   help="recipe to lint instead of the family default: "
                        "a registered name or a path to a recipe .json")
    p.add_argument("--scale", default="tiny", choices=("tiny", "full"),
                   help="config scale the masks/plans/audited closures "
                        "are built at (tiny: CPU-seconds per arch)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--hlo", action="store_true",
                   help="the reference's compiled-HLO cross-check, on the "
                        "serving prefill's step trace (J206/J207)")
    p.add_argument("--json", action="store_true",
                   help="one JSON report object per arch line")
    p.add_argument("--device", default="cuda",
                   help="where the audited closures run (default cuda; "
                        "cpu runs the kernels' plain versions)")
    p.set_defaults(fn=cmd_lint)

    p = sub.add_parser("prune", help="run a prune recipe (PruningSession)")
    _add_common(p)
    p.add_argument("--recipe", default=None,
                   help="staged prune program: a name from "
                        "`python -m repro_torch.api recipes` or a path to a "
                        "recipe .json (wins over --granularity)")
    p.add_argument("--rounds", type=int, default=3,
                   help="global prune-round budget "
                        "(PruneConfig.max_iters)")
    p.add_argument("--fraction", type=float, default=0.25,
                   help="fraction of remaining weights pruned per round "
                        "(flat schedules; recipes carry per-stage rates)")
    p.add_argument("--tolerance", type=float, default=0.02,
                   help="allowed accuracy drop vs baseline (nats for LMs)")
    p.add_argument("--granularity", default=None,
                   help="comma list overriding the family schedule, "
                        "e.g. expert,filter,index")
    p.add_argument("--steps", type=int, default=None,
                   help="train steps per round (adapter default if unset)")
    p.add_argument("--ticket", default=None,
                   help="export the winning ticket to this directory")
    p.add_argument("--ckpt", default=None,
                   help="session checkpoint dir (resume a killed run)")
    p.set_defaults(fn=cmd_prune)

    p = sub.add_parser("finetune",
                       help="continue training an exported ticket")
    _add_common(p, ticket_required=True)
    p.add_argument("--steps", type=int, default=None)
    p.set_defaults(fn=cmd_finetune)

    p = sub.add_parser("report",
                       help="crossbar accounting of an exported ticket")
    _add_common(p, ticket_required=True)
    p.set_defaults(fn=cmd_report)

    p = sub.add_parser("serve", help="serve an LM through ServeEngine")
    _add_common(p)
    p.add_argument("--ticket", default=None,
                   help="serve this pruned ticket (block-sparse decode)")
    p.add_argument("--requests", type=int, default=4)
    p.add_argument("--max-new", type=int, default=8)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--capacity", type=int, default=128)
    p.add_argument("--prompt-len", type=int, default=None,
                   help="fixed prompt length (default: random 4-15); "
                        "paged engines admit lengths past --capacity")
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--engines", type=int, default=1,
                   help="fleet size: front N engines with a FleetRouter "
                        "(least-loaded dispatch)")
    p.add_argument("--mesh", default=None,
                   help="serve on a DxM (data x model) mesh of D*M local "
                        "ranks (gloo on --device cpu; on cuda NCCL with "
                        "a card a rank, else gloo on shared cards)")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("serve-daemon",
                       help="control-plane daemon: one JSON op per stdin "
                            "line (request/pump/swap/status/shutdown), "
                            "streaming token events out")
    _add_common(p)
    p.add_argument("--ticket", default=None,
                   help="boot serving this pruned ticket")
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--capacity", type=int, default=128)
    p.add_argument("--max-new", type=int, default=8,
                   help="default token budget for ops that omit it")
    p.add_argument("--max-queue", type=int, default=64,
                   help="front-end wait-queue bound (admission control)")
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--heartbeat-dir", default=None,
                   help="HeartbeatMonitor root: engine ticks beat here "
                        "and stale beats close the admission gate")
    p.add_argument("--heartbeat-deadline", type=float, default=30.0)
    p.add_argument("--engines", type=int, default=1,
                   help="fleet size: FleetRouter over N engines with "
                        "heartbeat failover; adds the kill op "
                        '({"op": "kill", "engine": 1})')
    p.add_argument("--mesh", default=None,
                   help="serve on a DxM (data x model) mesh of D*M local "
                        "ranks; the ops are read in full first")
    p.add_argument("--script", default=None,
                   help="read ops from this file instead of stdin")
    p.set_defaults(fn=cmd_serve_daemon)

    p = sub.add_parser("swap",
                       help="zero-drain hot-swap preflight: candidate "
                            "ticket vs running ticket on live traffic")
    _add_common(p, ticket_required=True)
    p.add_argument("--candidate", required=True,
                   help="candidate ticket directory to swap in")
    p.add_argument("--requests", type=int, default=3,
                   help="in-flight requests during the swap "
                        "(keep <= --slots for a full in-flight check)")
    p.add_argument("--max-new", type=int, default=8)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--capacity", type=int, default=128)
    p.add_argument("--swap-after", type=int, default=2,
                   help="scheduler ticks before the swap lands")
    p.set_defaults(fn=cmd_swap)
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
