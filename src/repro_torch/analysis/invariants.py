"""Invariant verifier: the sparsity data structures, re-derived (port
of ``repro.analysis.invariants``).

Every check recomputes its invariant from an independent definition —
the mask's tile bitmap, the crossbar cell accounting identities — and
compares against the structure under test, so drift in ANY of the
builders (``make_tile_plan``, ``build_decode_plan``, ``xbar_stats``,
the engine's generation bookkeeping) surfaces as a structured finding
rather than as silently-wrong serving math.  Plans, stats and pools are
the port's own (``kernels.bsmm.TilePlan``, ``models.plans``,
``core.crossbar``, ``serve.paging``); mask leaves may be numpy arrays or
tensors on any device.

Rule codes P101–P116; see ``analysis.findings.RULES``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

import torch

from repro_torch.analysis.findings import Finding, error
from repro_torch.kernels.bsmm import GeometryError, TilePlan, tile_bitmap
from repro_torch.models.plans import (_ATTN_KEYS, _EXPERT_KEYS, _MLP_KEYS,
                                      PlanStats, _union_mask,
                                      build_decode_plan)


def _check_half(idx: np.ndarray, counts: np.ndarray, cap: int,
                other_t: int, bitmap: np.ndarray, transposed: bool,
                where: str, findings: List[Finding]) -> None:
    """One direction of a plan (forward or transposed) vs the bitmap.

    ``bitmap`` is oriented (Kt, Nt) for the forward half and (Nt, Kt)
    for the transposed half, so in both cases ``idx[j]`` lists live row
    indices of bitmap column j.
    """
    side = "idx_t/counts_t" if transposed else "idx/counts"
    codes = {"bounds": "P101", "counts": "P102", "set": "P103",
             "cap": "P104"}
    if transposed:
        # transpose disagreements all report under the transpose rule
        codes = {k: "P105" for k in codes}
    n_cols, n_rows = bitmap.shape[1], bitmap.shape[0]
    if idx.shape[0] != n_cols or counts.shape[0] != n_cols:
        findings.append(error(
            codes["bounds"], where,
            f"{side}: lengths {idx.shape[0]}/{counts.shape[0]} != "
            f"{n_cols} tile columns"))
        return
    if idx.shape[1] != cap:
        findings.append(error(
            codes["bounds"], where,
            f"{side}: idx width {idx.shape[1]} != declared max {cap}"))
        return
    if idx.size and (idx.min() < 0 or idx.max() >= n_rows):
        findings.append(error(
            codes["bounds"], where,
            f"{side}: tile index out of bounds [0, {n_rows}): "
            f"min={int(idx.min())} max={int(idx.max())}"))
        return
    want_counts = (bitmap != 0).sum(axis=0).astype(np.int64)
    if int(want_counts.max(initial=0)) > cap:
        findings.append(error(
            codes["cap"], where,
            f"{side}: declared max {cap} < densest column "
            f"{int(want_counts.max())} — live tiles would be dropped"))
        return
    if not np.array_equal(counts.astype(np.int64), want_counts):
        bad = int(np.flatnonzero(counts.astype(np.int64)
                                 != want_counts)[0])
        findings.append(error(
            codes["counts"], where,
            f"{side}: counts disagree with the mask bitmap (first at "
            f"tile column {bad}: plan={int(counts[bad])} "
            f"mask={int(want_counts[bad])})"))
        return
    for j in range(n_cols):
        got = set(int(v) for v in idx[j, :int(counts[j])])
        want = set(int(v) for v in np.flatnonzero(bitmap[:, j] != 0))
        if got != want:
            findings.append(error(
                codes["set"], where,
                f"{side}: live set of tile column {j} disagrees with "
                f"the mask (plan-only={sorted(got - want)}, "
                f"mask-only={sorted(want - got)})"))
            return


def verify_tile_plan(plan: TilePlan, mask=None, *,
                     where: str = "plan") -> List[Finding]:
    """One ``TilePlan`` vs its source elementwise mask.

    Without a mask only the internal structure is checked (bounds,
    widths, accounting); with the mask every component — forward half,
    transposed half, flat coords, live/total counts — is compared to a
    freshly reduced tile bitmap.
    """
    findings: List[Finding] = []
    idx = np.asarray(plan.idx)
    counts = np.asarray(plan.counts)
    Nt = counts.shape[0]
    if plan.counts_t is None or plan.idx_t is None or plan.kk is None:
        findings.append(error(
            "P101", where,
            "plan lacks backward metadata (idx_t/counts_t/kk/nn) — "
            "built by something other than make_tile_plan?"))
        return findings
    Kt = np.asarray(plan.counts_t).shape[0]

    if mask is not None:
        m2 = _union_mask(mask)
        if m2 is None:
            findings.append(error(
                "P108", where,
                f"mask is not 2-D-reducible (ndim={np.ndim(mask)}) but "
                f"a plan exists for it"))
            return findings
        K, N = m2.shape
        if K % plan.tile or N % plan.tile or \
                K // plan.tile != Kt or N // plan.tile != Nt:
            findings.append(error(
                "P108", where,
                f"mask {m2.shape} does not match the plan's geometry "
                f"({Kt}x{Nt} tiles of {plan.tile})"))
            return findings
        bitmap = tile_bitmap(m2, plan.tile, plan.tile)
    else:
        bitmap = None

    if bitmap is None:
        # structure-only: derive a bitmap from the forward half so the
        # transposed half and flat coords can still be cross-checked
        bitmap = np.zeros((Kt, Nt), np.int32)
        ok = idx.ndim == 2 and idx.shape[0] == Nt and \
            counts.shape[0] == Nt and \
            (not idx.size or (idx.min() >= 0 and idx.max() < Kt))
        if not ok:
            findings.append(error(
                "P101", where,
                f"idx/counts malformed: idx{idx.shape} counts"
                f"{counts.shape} for {Kt}x{Nt} tiles"))
            return findings
        for j in range(Nt):
            c = int(counts[j])
            if c > idx.shape[1]:
                findings.append(error(
                    "P104", where,
                    f"counts[{j}]={c} exceeds idx width "
                    f"{idx.shape[1]} (kmax={plan.kmax})"))
                return findings
            bitmap[idx[j, :c], j] = 1

    _check_half(idx, counts, plan.kmax, Kt, bitmap, False, where,
                findings)
    _check_half(np.asarray(plan.idx_t), np.asarray(plan.counts_t),
                plan.nmax, Nt, bitmap.T, True, where, findings)

    kk = np.asarray(plan.kk)
    nn = np.asarray(plan.nn)
    want_kk, want_nn = np.nonzero(bitmap)
    if not (np.array_equal(np.sort(kk * Nt + nn),
                           np.sort(want_kk * Nt + want_nn))):
        findings.append(error(
            "P106", where,
            f"flat live-tile coords (kk/nn) disagree with the bitmap: "
            f"{kk.shape[0]} listed vs {want_kk.shape[0]} live tiles"))
    live = int((bitmap != 0).sum())
    if plan.live_tiles != live or plan.total_tiles != bitmap.size:
        findings.append(error(
            "P107", where,
            f"tile accounting: plan says {plan.live_tiles}/"
            f"{plan.total_tiles}, bitmap says {live}/{bitmap.size}"))
    return findings


def _plans_equal(a: TilePlan, b: TilePlan) -> bool:
    if a.tile != b.tile or a.kmax != b.kmax or a.nmax != b.nmax or \
            a.live_tiles != b.live_tiles or a.total_tiles != b.total_tiles:
        return False
    pairs = ((a.idx, b.idx), (a.counts, b.counts), (a.idx_t, b.idx_t),
             (a.counts_t, b.counts_t), (a.kk, b.kk), (a.nn, b.nn))
    return all((x is None) == (y is None) and
               (x is None or np.array_equal(x, y)) for x, y in pairs)


def _walk_plan_leaves(plan, prefix: str = ""):
    """Yield (path, TilePlan) over the nested decode-plan structure."""
    if plan is None:
        return
    if isinstance(plan, TilePlan):
        yield prefix, plan
        return
    if isinstance(plan, dict):
        for k, v in plan.items():
            yield from _walk_plan_leaves(v, f"{prefix}.{k}" if prefix
                                         else str(k))
        return
    if isinstance(plan, (list, tuple)):
        for i, v in enumerate(plan):
            yield from _walk_plan_leaves(v, f"{prefix}[{i}]" if prefix
                                         else f"[{i}]")


def verify_decode_plan(masks, plan, stats: Optional[PlanStats] = None, *,
                       tile: Optional[int] = None,
                       where: str = "decode_plan") -> List[Finding]:
    """A built decode plan vs the masks' tile reduction.

    Rebuilds the plan from the masks with the same walker and demands
    structural identity: every entry present in both, every ``TilePlan``
    bit-identical (P109), and the recorded ``PlanStats`` totals in
    agreement (P110).  Each present leaf is additionally verified
    against its union mask with ``verify_tile_plan`` — defence in depth
    against a walker bug that corrupts both sides identically in
    structure but not against the mask itself.
    """
    findings: List[Finding] = []
    kw = {} if tile is None else {"tile": tile}
    try:
        want_plan, want_stats = build_decode_plan(masks, **kw)
    except GeometryError as e:
        return [error("P108", where, str(e))]

    got = dict(_walk_plan_leaves(plan))
    want = dict(_walk_plan_leaves(want_plan))
    for path in sorted(set(want) - set(got)):
        findings.append(error(
            "P109", f"{where}/{path}",
            "mask has a routable projection here but the plan has no "
            "entry — the matmul will silently run dense"))
    for path in sorted(set(got) - set(want)):
        findings.append(error(
            "P109", f"{where}/{path}",
            "plan has an entry the masks do not motivate — stale plan "
            "from different masks?"))
    for path in sorted(set(got) & set(want)):
        if not _plans_equal(got[path], want[path]):
            findings.append(error(
                "P109", f"{where}/{path}",
                "plan entry differs from the masks' tile reduction "
                "(stale or corrupted plan)"))

    # leaf-level verification against the union masks themselves
    for path, leaf_mask in _iter_mask_projections(masks):
        if path in got:
            findings.extend(verify_tile_plan(
                got[path], leaf_mask, where=f"{where}/{path}"))

    if stats is not None:
        agg_live = sum(p.live_tiles for p in got.values())
        agg_total = sum(p.total_tiles for p in got.values())
        if (stats.live_tiles, stats.total_tiles,
                stats.routed) != (agg_live, agg_total, len(got)):
            findings.append(error(
                "P110", where,
                f"PlanStats says routed={stats.routed} live="
                f"{stats.live_tiles}/{stats.total_tiles}; the plan's "
                f"leaves sum to routed={len(got)} live={agg_live}/"
                f"{agg_total}"))
    return findings


def _iter_mask_projections(masks):
    """Yield (plan-path, mask-leaf) for every routable projection, in
    the same path syntax ``_walk_plan_leaves`` produces."""
    if not isinstance(masks, dict) or "segments" not in masks:
        return
    for s_idx, pos_trees in enumerate(masks["segments"]):
        for pos, ptree in enumerate(pos_trees):
            if not isinstance(ptree, dict):
                continue
            attn = ptree.get("attn")
            if isinstance(attn, dict) and "wq" in attn:
                for k in _ATTN_KEYS:
                    if attn.get(k) is not None:
                        yield f"[{s_idx}][{pos}].attn.{k}", attn[k]
            mlp = ptree.get("mlp")
            if isinstance(mlp, dict):
                for k in _MLP_KEYS:
                    if mlp.get(k) is not None:
                        yield f"[{s_idx}][{pos}].mlp.{k}", mlp[k]
            moe = ptree.get("moe")
            if isinstance(moe, dict):
                for k in _EXPERT_KEYS:
                    if moe.get(k) is not None:
                        yield f"[{s_idx}][{pos}].moe.{k}", moe[k]
                shared = moe.get("shared")
                if isinstance(shared, dict):
                    for k in _MLP_KEYS:
                        if shared.get(k) is not None:
                            yield (f"[{s_idx}][{pos}].moe.shared.{k}",
                                   shared[k])


def verify_xbar_stats(st, mask_matrix: np.ndarray, *,
                      where: str = "xbar") -> List[Finding]:
    """``XbarStats`` cell-accounting identities vs the mask matrix.

    The identities hold by construction when ``xbar_stats`` is healthy;
    the point is to catch drift between the two independent accounting
    routes (per-block saved/live cells vs whole-matrix nonzeros)."""
    findings: List[Finding] = []
    m = np.asarray(mask_matrix) != 0
    R, C = m.shape
    xr, xc = st.xbar_rows, st.xbar_cols
    n_r = -(-R // xr)
    n_c = -(-C // xc)
    checks = [
        ("n_xbars", st.n_xbars, n_r * n_c),
        ("total_cells", st.total_cells, R * C),
        ("nonzero_cells", st.nonzero_cells, int(m.sum())),
        ("saved+live", st.saved_cells + st.live_area, R * C),
        ("strict+free",
         st.xbars_needed_strict + st.xbars_fully_free, st.n_xbars),
        ("packed", st.xbars_needed_packed, -(-st.live_area // (xr * xc))),
    ]
    for name, got, want in checks:
        if int(got) != int(want):
            findings.append(error(
                "P111", where,
                f"XbarStats {name}: {int(got)} != expected "
                f"{int(want)} for mask {m.shape} at {xr}x{xc}"))
    if not (0 <= st.xbars_needed_packed <= st.xbars_needed_strict
            <= st.n_xbars):
        findings.append(error(
            "P111", where,
            f"XbarStats ordering violated: "
            f"packed={st.xbars_needed_packed} "
            f"strict={st.xbars_needed_strict} total={st.n_xbars}"))
    # every kept weight sits in a live row AND a live column, so the
    # live area can never undercount the nonzeros
    if st.nonzero_cells > st.live_area:
        findings.append(error(
            "P111", where,
            f"XbarStats live_area={st.live_area} < nonzero_cells="
            f"{st.nonzero_cells} — live rows/cols dropped kept weights"))
    return findings


def verify_mask_accounting(masks, conv_pred=None, *, rows: int,
                           cols: int, where: str = "masks",
                           max_leaves: Optional[int] = None
                           ) -> List[Finding]:
    """Recompute ``xbar_stats`` for every prunable mask leaf and check
    the accounting identities (P111).

    Walks the mask pytree in the reference's leaf order
    (``core.masks.tree_flatten_with_path``): each non-None leaf is unrolled with ``leaf_matrices`` (conv leaves
    per ``conv_pred``) and every matrix of the batch gets its own stats
    pass.  ``max_leaves`` caps work on big trees (lint runs at tiny
    scale, so usually unbounded)."""
    from repro_torch.core.crossbar import leaf_matrices, xbar_stats
    from repro_torch.core.masks import tree_flatten_with_path
    findings: List[Finding] = []
    budget = max_leaves
    for p, leaf in tree_flatten_with_path(masks):
        if leaf is None:
            continue
        if budget is not None:
            if budget <= 0:
                break
            budget -= 1
        raw = (leaf.detach().cpu().numpy() if torch.is_tensor(leaf)
               else np.asarray(leaf))
        conv = bool(conv_pred(p)) if conv_pred is not None else False
        try:
            mats, _ = leaf_matrices(raw, conv)
        except (ValueError, AssertionError):
            continue  # non-matrix leaf (bias, scalar gate) — no cells
        for b in range(mats.shape[0]):
            m2 = mats[b] != 0
            lw = f"{where}/{p}" if mats.shape[0] == 1 \
                else f"{where}/{p}[{b}]"
            findings.extend(verify_xbar_stats(
                xbar_stats(m2, rows, cols), m2, where=lw))
    return findings


def verify_engine(engine, *, where: str = "engine") -> List[Finding]:
    """Cross-generation consistency inside a (possibly swapped)
    ``ServeEngine``: distinct gids, every generation's plan identical
    to the tile reduction of its own masks, and the engine report's
    skipped-tile fraction agreeing with the newest generation (P112).
    Paged engines additionally get the block-pool/table checks
    (P113/P115) via ``verify_paged_engine``.
    """
    findings: List[Finding] = []
    gens = engine.generations
    gids = [g.gid for g in gens]
    if len(set(gids)) != len(gids):
        findings.append(error(
            "P112", where,
            f"duplicate generation ids: {gids}"))
    for g in gens:
        gwhere = f"{where}/gen{g.gid}"
        if g.masks is None:
            if g.plan is not None:
                findings.append(error(
                    "P112", gwhere,
                    "generation has a tile plan but no masks"))
            continue
        if g.plan is None:
            # legal: use_bsmm=False or masks without routable structure
            continue
        sub = verify_decode_plan(g.masks, g.plan, g.plan_stats,
                                 where=gwhere)
        findings.extend(
            error("P112", f.where, f"[{f.code}] {f.msg}") for f in sub)
    if gens and gens[-1].plan is not None:
        rep = engine.report
        want = gens[-1].plan_stats.skipped_tile_fraction
        if abs(rep.skipped_tile_fraction - want) > 1e-9:
            findings.append(error(
                "P112", where,
                f"report.skipped_tile_fraction="
                f"{rep.skipped_tile_fraction:.6f} disagrees with the "
                f"newest generation's {want:.6f}"))
    if getattr(engine, "paged", False):
        findings.extend(verify_paged_engine(engine, where=where))
    return findings


# ---------------------------------------------------------------------------
# Paged KV cache: block pools, block tables, logical reconstruction
# ---------------------------------------------------------------------------
def verify_block_pool(pool, *, where: str = "pool") -> List[Finding]:
    """``BlockPool`` accounting (P115), re-derived from its raw state.

    Runs the pool's own ``check()`` (double-tracking, leaks) and then
    independently recomputes the balance identity
    ``free + live + scratch == capacity`` and the reservation bound, so
    drift in either the allocator or its self-check surfaces here.
    """
    from repro_torch.serve.paging import PoolError
    findings: List[Finding] = []
    try:
        pool.check()
    except PoolError as e:
        findings.append(error("P115", where, str(e)))
        return findings
    free = len(pool._free)
    total = free + pool.live + len(pool.reserved_ids)
    if total != pool.num_blocks:
        findings.append(error(
            "P115", where,
            f"free({free}) + live({pool.live}) + "
            f"scratch({len(pool.reserved_ids)}) = {total} != capacity "
            f"{pool.num_blocks}"))
    if pool.outstanding > free:
        findings.append(error(
            "P115", where,
            f"outstanding reservations ({pool.outstanding}) exceed the "
            f"free list ({free}) — a guaranteed alloc would fail"))
    if pool.available != free - pool.outstanding:
        findings.append(error(
            "P115", where,
            f"available={pool.available} != free({free}) - "
            f"outstanding({pool.outstanding})"))
    return findings


def verify_block_tables(pool, tables, lens, slot_nblocks, uids, *,
                        block_tokens: int,
                        where: str = "tables") -> List[Finding]:
    """Block tables vs pool ownership (P113).

    For every active slot: the row's live prefix must list exactly the
    blocks the pool says that request owns, in logical order, with no
    block referenced by two slots, no scratch/out-of-range id used as a
    live block, the block count matching ``ceil(len / BLOCK)``, and the
    dead tail parked on the scratch block.  Inactive slots must be
    fully reset.
    """
    findings: List[Finding] = []
    tables = np.asarray(tables)
    lens = np.asarray(lens)
    nbs = np.asarray(slot_nblocks)
    scratch = set(pool.reserved_ids)
    seen: Dict[int, int] = {}
    for s, uid in enumerate(uids):
        sw = f"{where}/slot{s}"
        row = tables[s]
        if uid is None:
            if int(nbs[s]) or int(lens[s]) or \
                    any(int(v) not in scratch for v in row):
                findings.append(error(
                    "P113", sw,
                    "inactive slot still holds table state "
                    f"(nblocks={int(nbs[s])} len={int(lens[s])})"))
            continue
        n, nb = int(lens[s]), int(nbs[s])
        want_nb = -(-n // block_tokens)
        if nb != want_nb:
            findings.append(error(
                "P113", sw,
                f"uid {uid}: {nb} blocks held for {n} tokens "
                f"(want ceil({n}/{block_tokens}) = {want_nb})"))
            continue
        live = [int(v) for v in row[:nb]]
        bad = [v for v in live
               if v in scratch or not 0 <= v < pool.num_blocks]
        if bad:
            findings.append(error(
                "P113", sw,
                f"uid {uid}: live entries reference scratch/out-of-"
                f"range blocks {bad}"))
            continue
        if list(pool.owned(uid)) != live:
            findings.append(error(
                "P113", sw,
                f"uid {uid}: table row {live} disagrees with pool "
                f"ownership {list(pool.owned(uid))}"))
            continue
        for v in live:
            if v in seen:
                findings.append(error(
                    "P113", sw,
                    f"block {v} referenced by slot {seen[v]} and "
                    f"slot {s}"))
            seen[v] = s
        if any(int(v) not in scratch for v in row[nb:]):
            findings.append(error(
                "P113", sw,
                f"uid {uid}: dead table entries past block {nb} are "
                f"not parked on the scratch block"))
    return findings


def verify_paged_reconstruction(paged_caches, dense_caches, blocks,
                                length: int, *,
                                where: str = "paged") -> List[Finding]:
    """Logical-order reconstruction vs the dense oracle (P114).

    ``dense_caches`` is a single request's exact ``prefill`` output
    (B=1, tensors on any device); ``blocks`` its adopted physical block
    ids in logical order.
    Gathering every layer's pool rows through ``blocks`` and trimming to
    ``length`` must reproduce the dense cache bit-for-bit — adopt and
    append are pure copies, so any tolerance would hide an indexing bug.
    """
    findings: List[Finding] = []
    blocks = [int(b) for b in np.asarray(blocks).reshape(-1)]

    def check(pool, want, path):
        stacked = pool.ndim == 5                 # leading scan-reps axis
        pools = pool if stacked else pool[None]
        wants = want if stacked else want[None]
        idx = torch.as_tensor(blocks, dtype=torch.long, device=pool.device)
        for r in range(pools.shape[0]):
            rows = pools[r].index_select(0, idx)          # (nb, T, H, d)
            got = rows.reshape(-1, *rows.shape[2:])[:length]
            oracle = wants[r][0, :length].to(device=got.device,
                                              dtype=got.dtype)
            if got.shape != oracle.shape or not torch.equal(got, oracle):
                diff = float((got.float() - oracle.float()).abs().max()) \
                    if got.shape == oracle.shape else float("nan")
                rp = f"{path}[rep{r}]" if stacked else path
                findings.append(error(
                    "P114", f"{where}/{rp}",
                    f"gathered pool rows != dense oracle over "
                    f"{length} tokens (max |diff| = {diff})"))
                return

    for si, (seg_p, seg_d) in enumerate(zip(paged_caches, dense_caches)):
        for pi, (pc, dc) in enumerate(zip(seg_p, seg_d)):
            path = f"seg{si}.{pi}"
            if hasattr(pc, "k_pool"):            # GQA
                check(pc.k_pool, dc.k, f"{path}.k")
                check(pc.v_pool, dc.v, f"{path}.v")
            else:                                # absorbed MLA
                # the pool stores concat(c_kv, k_rope) as one "kv head"
                want = torch.cat([dc.c_kv, dc.k_rope.to(dc.c_kv.dtype)],
                                 dim=-1)[..., None, :]
                check(pc.pool, want, path)
    return findings


def verify_paged_engine(engine, *, where: str = "engine") -> List[Finding]:
    """Pool + table consistency across every generation of a paged
    ``ServeEngine`` (P113/P115) — including generations parked by a
    hot-swap, whose draining requests still own blocks.
    """
    from repro_torch.kernels.paged_attention import BLOCK_TOKENS
    findings: List[Finding] = []
    for g in engine.generations:
        if getattr(g, "pool", None) is None:
            continue
        gwhere = f"{where}/gen{g.gid}"
        findings.extend(verify_block_pool(g.pool, where=f"{gwhere}/pool"))
        uids = [None if r is None else r.uid for r in g.slot_reqs]
        findings.extend(verify_block_tables(
            g.pool, g.tables, g.lens, g.slot_nblocks, uids,
            block_tokens=BLOCK_TOKENS, where=f"{gwhere}/tables"))
    return findings


# ---------------------------------------------------------------------------
# Fleet accounting: each uid finishes once, merged totals balance
# ---------------------------------------------------------------------------
def verify_fleet(router, *, where: str = "fleet") -> List[Finding]:
    """``FleetRouter`` accounting identities (P116), re-derived from the
    logical records and per-engine reports.

    A failover moves a request between engines: the invariants below
    say the move is loss- and duplication-free — every submitted uid
    reaches a terminal state in exactly one engine (once the router is
    idle), and the merged report's totals equal the per-engine sums
    (every token was generated by exactly one engine; every finish was
    booked by exactly one engine).  Live engines additionally get the
    cross-generation checks (P112/P113/P115) via ``verify_engine``.
    """
    findings: List[Finding] = []
    rep = router.report

    # each uid finishes at most once (exactly once when drained)
    seen: Dict[Any, int] = {}
    for rec in router.finished:
        seen[rec.uid] = seen.get(rec.uid, 0) + 1
    for uid, n in seen.items():
        if n > 1:
            findings.append(error(
                "P116", f"{where}/uid{uid}",
                f"request finished {n} times across engines"))
    for rec in router.finished:
        if not rec.done:
            findings.append(error(
                "P116", f"{where}/uid{rec.uid}",
                f"finished list holds a non-terminal record "
                f"(status={rec.status!r})"))
    if router.idle:
        rejected = {rec.uid for rec in router.rejected}
        lost = [uid for uid, rec in router.records.items()
                if not rec.done and uid not in rejected
                and uid not in seen]
        if lost:
            findings.append(error(
                "P116", where,
                f"router is idle but {len(lost)} submitted uid(s) never "
                f"finished (lost in dispatch/failover): {lost[:8]}"))

    # merged totals == per-engine sums
    per = rep.per_engine
    eng_tokens = sum(p.tokens_generated for p in per)
    if eng_tokens != rep.tokens_generated:
        findings.append(error(
            "P116", where,
            f"merged tokens_generated={rep.tokens_generated} but the "
            f"engines generated {eng_tokens} (a token was double-booked "
            f"or dropped)"))
    eng_requests = sum(p.requests for p in per)
    if eng_requests != len(router.finished):
        findings.append(error(
            "P116", where,
            f"engines finished {eng_requests} requests but the router "
            f"booked {len(router.finished)} logical finishes (a request "
            f"finished in zero or multiple engines)"))
    if rep.requests != len(router.finished):
        findings.append(error(
            "P116", where,
            f"report.requests={rep.requests} disagrees with the "
            f"finished list ({len(router.finished)})"))

    for i, fe in enumerate(router.frontends):
        if i in router.live:
            findings.extend(
                verify_engine(fe.engine, where=f"{where}/engine{i}"))
    return findings
