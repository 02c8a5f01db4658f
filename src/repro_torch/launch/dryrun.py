"""The multi-pod dry-run (a port of ``repro.launch.dryrun``).

For every (architecture × input shape) cell:
  1. build rank 0's view of the production mesh, (16, 16) or, with
     ``--multi-pod``, (2, 16, 16): an ``AbstractMesh`` with no process
     group;
  2. cut the full config's meta parameters, optimizer state (over
     ``data`` as well under ``zero1``), batch rows and caches to rank
     0's shards (``ShardingRules``, ``tensor_parallel.layout``,
     ``local_config``) — no allocation;
  3. run the step ``launch.train`` / ``launch.serve`` would run on that
     rank (the tensor-parallel train step, prefill or decode) on fake
     ``cuda`` tensors under ``hlo_analysis.StepTrace``: every aten op,
     kernel launch and collective is recorded, nothing runs and no card
     is needed.  Sharding, collective, memory and data-dependent-shape
     bugs surface here;
  4. record memory, roofline terms, collective bytes and the kernel
     launches into a JSON cache.

The record keeps the reference's keys.  ``compile_s`` holds the trace's
host seconds (there is no compile); ``memory`` holds rank 0's local
arguments (``argument_size_in_bytes``), its step's outputs, the trace's
peak of live storage minus its arguments (``temp_size_in_bytes``) and
their sum (``total_bytes_per_device``); ``roofline`` carries ``kappa:
1.0`` (the trace counts every layer, ``launch.costs``).  One key is
added: ``kernels``, ``{wrapper: {route: launches}}``.  A cell that hits
a data-dependent shape under fake tensors, or a family the rank-local
model does not run on a model axis, records FAIL with the error.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out results.json]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch._bridge import tree_leaves
from repro_torch.configs import ALL_SHAPES, get_arch, get_shape, list_archs
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.distributed import sharding
from repro_torch.distributed import tensor_parallel as tpar
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.hlo_analysis import (StepTrace, collective_bytes,
                                             roofline_from_trace)
from repro_torch.launch.mesh import AbstractMesh, production_shape


def model_flops_estimate(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (fwd-only), N = active params
    excluding vocab embeddings, D = tokens processed by the step."""
    n_active = cfg.active_param_count()
    n_embed = cfg.padded_vocab * cfg.d_model * (1 if cfg.tie_embeddings
                                                else 2)
    n = max(n_active - n_embed, 1)
    if shape.kind == "train":
        d = shape.global_batch * shape.seq_len
        return 6.0 * n * d
    if shape.kind == "prefill":
        d = shape.global_batch * shape.seq_len
        return 2.0 * n * d
    d = shape.global_batch * 1
    return 2.0 * n * d


def apply_variant(cfg, opts: Dict[str, Any]):
    """Config transforms for perf-iteration variants.

    ``pruned=<frac>`` — structural ReaLPrune overlay: crossbar-aware
    column pruning of FFN/expert matrices packs to a narrower matmul
    (the 'freed crossbar columns reused' semantics), so the variant
    lowers with d_ff scaled by (1-frac), padded to 256 lanes.
    ``remat=<policy>`` sets the training forward's remat policy;
    ``capacity=<f>`` the MoE capacity factor; ``zero1`` shards the
    optimizer moments over ``data`` (``run_cell``).
    """
    import dataclasses as dc
    if opts.get("remat"):
        from repro_torch.models import transformer as _tfm
        _tfm.set_remat(True, policy=str(opts["remat"]))
    if opts.get("capacity") and cfg.moe is not None:
        cfg = dc.replace(cfg, moe=dc.replace(
            cfg.moe, capacity_factor=float(opts["capacity"])))
    if opts.get("pruned"):
        frac = float(opts["pruned"])
        keep = 1.0 - frac

        def pad256(x):
            return max(256, int(x * keep + 255) // 256 * 256)
        changes = {}
        if cfg.d_ff > 0:
            changes["d_ff"] = pad256(cfg.d_ff)
        if cfg.moe is not None:
            changes["moe"] = dc.replace(cfg.moe,
                                        d_ff_expert=pad256(cfg.moe.d_ff_expert),
                                        d_ff_shared=pad256(cfg.moe.d_ff_shared)
                                        if cfg.moe.d_ff_shared else 0)
        if cfg.rnn_width:
            changes["rnn_width"] = pad256(cfg.rnn_width)
        cfg = dc.replace(cfg, **changes)
    return cfg


# ---------------------------------------------------------------------------
# Rank 0's step
# ---------------------------------------------------------------------------
def _local_rows(shape: ShapeSpec, rules) -> ShapeSpec:
    """The cell as one data rank runs it: its rows of the global batch
    (``batch_spec``: split over the data axes when they divide it)."""
    B = shape.global_batch
    rows = B // rules.dp_size if rules._dp_if(B) is not None else B
    return dataclasses.replace(shape, global_batch=rows)


@dataclasses.dataclass
class LocalCell:
    """Rank 0's cell: its local config, cell, rules, shardings and the
    meta argument trees of its step."""
    cfg: ArchConfig             # the local config (local heads)
    shape: ShapeSpec            # the local rows
    rules: Any
    shardings: Any
    whole: list
    args: tuple


def local_cell(cfg: ArchConfig, shape: ShapeSpec, axes: Dict[str, int], *,
               zero1: bool = False,
               prefill_tokens: Optional[int] = None) -> LocalCell:
    """Rank 0's meta arguments of ``cfg`` × ``shape`` on a mesh of
    ``axes`` ({axis: size}).  ``prefill_tokens`` feeds a prefill fewer
    tokens than its capacity (the cache keeps ``shape.seq_len`` rows)."""
    mesh = AbstractMesh(axes)
    rules = tpar.mesh_rules(mesh, cfg)
    pspec = steps_lib.params_spec(cfg)
    shardings, whole = tpar.layout(pspec, cfg, rules)
    params = tpar.localize(pspec, shardings)
    lcfg = tpar.local_config(cfg, rules.tp_size, shardings)
    lshape = _local_rows(shape, rules)
    if shape.kind == "train":
        held = params
        if zero1:           # the optimizer state of this data rank's parts
            held = tpar.Zero1(tpar.ShardedModel._build(
                params, cfg, rules, shardings, whole)).part(params)
        args = (params, steps_lib.opt_state_spec(cfg, held),
                steps_lib.input_specs(lcfg, lshape))
    elif shape.kind == "prefill":
        batch = steps_lib.input_specs(lcfg, lshape)
        if prefill_tokens is not None:
            batch = dict(batch, tokens=steps_lib._sds(
                (lshape.global_batch, prefill_tokens), torch.int32))
        args = (params, batch)
    else:
        args = (params, steps_lib.cache_specs(lcfg, lshape, params),
                steps_lib.input_specs(lcfg, lshape)["tokens"])
    return LocalCell(lcfg, lshape, rules, shardings, whole, args)


def trace_cell(cfg: ArchConfig, shape: ShapeSpec, axes: Dict[str, int], *,
               zero1: bool = False, prefill_tokens: Optional[int] = None):
    """Trace rank 0's step of ``cfg`` × ``shape`` on a mesh of ``axes``:
    (StepTrace, output bytes)."""
    cell = local_cell(cfg, shape, axes, zero1=zero1,
                      prefill_tokens=prefill_tokens)
    mod = steps_lib.model_module(cell.cfg)
    rules = cell.rules
    with StepTrace() as tr:
        args = tr.fake(cell.args)
        model = tpar.ShardedModel._build(args[0], cfg, rules,
                                         cell.shardings, cell.whole)
        if shape.kind == "train":
            from repro_torch.train.loop import make_train_step
            fn = make_train_step(tpar.train_loss(model),
                                 steps_lib.make_optimizer(cfg),
                                 sharded=model, zero1=zero1)
            out = fn(*args)
        else:
            with torch.no_grad(), model.scope(groups=1):
                if shape.kind == "prefill":
                    out = mod.prefill(args[0], cell.cfg, args[1],
                                      steps_lib.cache_capacity(cfg, shape))
                else:
                    out = mod.decode_step(args[0], cell.cfg, args[1], args[2])
        seen, out_bytes = set(), 0
        for t in tree_leaves(out):
            if torch.is_tensor(t):
                st = t.untyped_storage()
                if st._cdata not in seen:
                    seen.add(st._cdata)
                    out_bytes += st.nbytes()
        del out, args, model
    return tr, out_bytes


def memory_dict(tr: StepTrace, out_bytes: int) -> Dict[str, int]:
    arg = int(tr.argument_bytes)
    temp = int(tr.peak_bytes) - arg
    return {"argument_size_in_bytes": arg,
            "output_size_in_bytes": int(out_bytes),
            "temp_size_in_bytes": temp,
            "total_bytes_per_device": arg + temp}


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             opt_flags: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    opts = opt_flags or {}
    cfg = apply_variant(get_arch(arch), opts)
    shape = get_shape(shape_name)
    skip = steps_lib.cell_skip_reason(cfg, shape)
    variant = ",".join(f"{k}={v}" for k, v in sorted(opts.items()))
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "kind": shape.kind,
    }
    if variant:
        rec["variant"] = variant
    if skip:
        rec["status"] = "SKIP"
        rec["reason"] = skip
        return rec

    axes = production_shape(multi_pod)
    n_chips = 1
    for n in axes.values():
        n_chips *= n
    prev = sharding.installed()
    try:
        tr, out_bytes = trace_cell(cfg, shape, axes,
                                   zero1=bool(opts.get("zero1")))
        terms = roofline_from_trace(
            tr, n_chips, model_flops=model_flops_estimate(cfg, shape))
        coll = collective_bytes(tr)
        roof = terms.as_dict()
        roof["kappa"] = 1.0
        rec.update({
            "status": "OK",
            "compile_s": round(tr.host_s, 1),
            "n_chips": n_chips,
            "memory": memory_dict(tr, out_bytes),
            "roofline": roof,
            "collectives": {
                "bytes_by_kind": coll.bytes_by_kind,
                "count_by_kind": coll.count_by_kind,
            },
            "kernels": tr.launches(),
        })
    except Exception as e:  # noqa: BLE001 — recorded, not swallowed silently
        rec["status"] = "FAIL"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    finally:
        sharding.install(prev)
        from repro_torch.models import transformer as _tfm
        _tfm.set_remat(True, policy="full")
    return rec


def cell_line(rec: Dict[str, Any]) -> str:
    """The ``[OK]``/``[SKIP]``/``[FAIL]`` line ``main`` prints a cell."""
    status = rec["status"]
    if status == "OK":
        r = rec["roofline"]
        extra = (f"compute={r['compute_s']:.2e}s "
                 f"memory={r['memory_s']:.2e}s "
                 f"coll={r['collective_s']:.2e}s "
                 f"bound={r['bottleneck']} "
                 f"mem/dev={rec['memory']['total_bytes_per_device']/2**30:.2f}GiB "
                 f"compile={rec['compile_s']}s")
    elif status == "FAIL":
        extra = rec["error"][:200]
    else:
        extra = rec["reason"][:80]
    return f"[{status}] {rec['arch']} × {rec['shape']} × {rec['mesh']}  {extra}"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="dryrun_results.json")
    ap.add_argument("--append", action="store_true",
                    help="merge into an existing results file")
    ap.add_argument("--opt", default="",
                    help="perf-variant flags, e.g. 'zero1' or 'pruned=0.5'"
                         " or 'zero1,pruned=0.9'")
    args = ap.parse_args(argv)
    opt_flags = {}
    for tok in args.opt.split(","):
        if not tok:
            continue
        if "=" in tok:
            k, v = tok.split("=", 1)
            opt_flags[k] = v
        else:
            opt_flags[tok] = True

    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = ([s.name for s in ALL_SHAPES] if (args.all or not args.shape)
              else [args.shape])
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    results = []
    if args.append and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results
            if r.get("status") == "OK"}
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                key = (arch, shape, "2x16x16" if mp else "16x16")
                if key in done and not opt_flags:
                    continue
                rec = run_cell(arch, shape, multi_pod=mp,
                               opt_flags=opt_flags)
                print(cell_line(rec), flush=True)
                results = [r for r in results
                           if (r["arch"], r["shape"], r["mesh"]) != key]
                results.append(rec)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
    n_ok = sum(1 for r in results if r["status"] == "OK")
    n_skip = sum(1 for r in results if r["status"] == "SKIP")
    n_fail = sum(1 for r in results if r["status"] == "FAIL")
    print(f"\n{n_ok} OK, {n_skip} SKIP, {n_fail} FAIL → {args.out}")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
