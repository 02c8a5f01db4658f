"""Static CUDA launch verifier (rules K300–K306; port of
``repro.analysis.kernel_audit``).

Every launch of the port's kernels is described by a ``LaunchSpec``
(``kernels.spec``), built from the wrappers' own route and split rules:
grid, threads, cluster, shared memory, and block by block the output
rectangles it finally writes and the operand rectangles it reads.
``audit_kernel_spec`` enumerates it exhaustively (the cases are a few
hundred blocks; the checks are host numpy):

  K300  spec malformed — grid/cluster/threads/blocks/rectangles
        inconsistent; the other rules are skipped.
  K301  final-writer coverage exact — split pieces meet in a workspace
        (the group's block written once) or a cluster (each rank its
        rows, within one cluster), and every element of the output's
        region is written exactly once, none outside it.
  K302  every read inside its operand, every block-table entry (dead
        ones too) a valid pool block.
  K303  per output block, the rectangles its blocks read over all
        pieces equal the live set derived independently from the truth
        source (the mask's tile bitmap, block lists + lengths, causal
        structure).
  K304  accumulators, partials and softmax state are float32.
  K305  dynamic shared memory within the 232,448 bytes an H100 block
        may take (``kernels.spec.SMEM_LIMIT``) and at most 1024 threads.
  K306  passes/flops/bytes enumerated from the spec equal the H100
        ``core.perf_model.KernelCost`` of the same launch.

``default_cases()`` holds one small concrete launch for each route a
main path launches (the kernel table's Launches column), at least one
split case of #1, #3 and #4; ``audit_kernels()`` runs them all and is
what ``lint --kernels`` invokes.  On the card ``chip_smoke.py`` launches
every case's kernel and holds it to its spec.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis.findings import Finding, error
from repro_torch.kernels.spec import MEETS, SMEM_LIMIT, LaunchSpec, Rect

#: truth for K303: operand -> output block (cls) -> rectangles it reads
ExpectedReads = Dict[str, Dict[Tuple[int, ...], List[Rect]]]
_MAX_EXAMPLES = 3


@dataclass(frozen=True)
class AuditCase:
    """One concrete launch, its independent liveness truth (K303) and
    the cost model's prediction (K306); either may be None."""
    name: str
    spec: LaunchSpec
    expected_reads: Optional[ExpectedReads] = None
    cost: Optional[object] = None           # core.perf_model.KernelCost
    # what chip_smoke.py launches the case with (shapes, plan, tables)
    inputs: Optional[dict] = None


def _fmt(items: List) -> str:
    shown = ", ".join(map(str, items[:_MAX_EXAMPLES]))
    more = len(items) - _MAX_EXAMPLES
    return shown + (f", … +{more} more" if more > 0 else "")


def _rect_ok(r) -> bool:
    return (len(r) == 4 and all(isinstance(v, (int, np.integer)) for v in r)
            and r[0] <= r[1] and r[2] <= r[3])


def _check_structure(spec: LaunchSpec, where: str) -> List[Finding]:
    bad: List[str] = []
    if len(spec.grid) != 3 or any(g <= 0 for g in spec.grid):
        bad.append(f"grid {spec.grid} is not three positive extents")
    if len(spec.cluster) != 3 or any(c <= 0 for c in spec.cluster):
        bad.append(f"cluster {spec.cluster} is not three positive extents")
    elif len(spec.grid) == 3 and any(
            g % c for g, c in zip(spec.grid, spec.cluster)):
        bad.append(f"cluster {spec.cluster} does not divide grid "
                   f"{spec.grid}")
    if spec.threads <= 0:
        bad.append(f"non-positive threads {spec.threads}")
    if spec.meet not in MEETS:
        bad.append(f"unknown meeting kind {spec.meet!r}")
    if spec.output not in spec.operands:
        bad.append(f"output {spec.output!r} is not a declared operand")
    elif tuple(spec.region.shape) != tuple(spec.operands[spec.output]):
        bad.append(f"region {spec.region.shape} != output extent "
                   f"{spec.operands[spec.output]}")
    if bad:
        return [error("K300", where, "; ".join(bad))]
    coords = [b.coord for b in spec.blocks]
    want = set(itertools.product(*(range(g) for g in spec.grid)))
    got = set(coords)
    if len(coords) != len(got) or got != want:
        missing = sorted(want - got)
        extra = sorted(got - want)
        bad.append(f"blocks do not enumerate the grid once ({len(coords)} "
                   f"records for {len(want)} blocks; missing "
                   f"{_fmt(missing)}; outside {_fmt(extra)})")
    for b in spec.blocks:
        if any(not _rect_ok(r) for r in b.writes) or any(
                op not in spec.operands or not _rect_ok(r)
                for op, r in b.reads):
            bad.append(f"block {b.coord}: a malformed rectangle or an "
                       f"unknown operand")
            break
    return [error("K300", where, "; ".join(bad))] if bad else []


def _merged(rects) -> List[Rect]:
    """Canonical form of a multiset of rectangles: sorted, rows that
    continue one another over the same columns joined."""
    out: List[List[int]] = []
    for r in sorted((c0, c1, r0, r1) for r0, r1, c0, c1 in rects):
        c0, c1, r0, r1 = r
        if out and out[-1][0] == c0 and out[-1][1] == c1 \
                and out[-1][3] == r0:
            out[-1][3] = r1
        else:
            out.append([c0, c1, r0, r1])
    return [(r0, r1, c0, c1) for c0, c1, r0, r1 in out]


def _in(rect, extent) -> bool:
    r0, r1, c0, c1 = rect
    return 0 <= r0 <= r1 <= extent[0] and 0 <= c0 <= c1 <= extent[1]


def enumerate_cost(spec: LaunchSpec) -> Tuple[int, float, float]:
    """(passes, flops, bytes) of a spec, block by block: working blocks,
    their flops, their reads, the region written once and the f32
    partials stored and read back."""
    work = spec.working()
    rd = sum((r[1] - r[0]) * (r[3] - r[2]) * spec.itemsize[op]
             for b in work for op, r in b.reads)
    out = int(spec.region.sum()) * spec.itemsize[spec.output]
    part = 2 * sum(b.partial_bytes for b in work)
    return (len(work), float(sum(b.flops for b in work)),
            float(rd + out + part))


def audit_kernel_spec(spec: LaunchSpec, *,
                      expected_reads: Optional[ExpectedReads] = None,
                      cost=None, where: str = "") -> List[Finding]:
    """Run K300–K306 against one concrete ``LaunchSpec``."""
    where = where or f"kernels/{spec.name}"
    findings = _check_structure(spec, where)
    if findings:
        return findings          # geometry unusable; later rules would lie
    work = spec.working()

    # -- K302: reads and table entries in bounds -------------------------
    out_of = [(b.coord, op, r) for b in work for op, r in b.reads
              if not _in(r, spec.operands[op])]
    out_of += [(b.coord, spec.output, r) for b in work for r in b.writes
               if not _in(r, spec.operands[spec.output])]
    if out_of:
        findings.append(error(
            "K302", where,
            f"{len(out_of)} rectangle(s) leave their operand (block, "
            f"operand, rect): {_fmt(out_of)}"))
    if spec.table is not None:
        t = np.asarray(spec.table)
        bad = np.argwhere((t < 0) | (t >= spec.pool_blocks))
        if bad.size:
            findings.append(error(
                "K302", where,
                f"block-table entries outside the {spec.pool_blocks}-block "
                f"pool at (sequence, logical block) "
                f"{_fmt([tuple(map(int, x)) for x in bad])} — dead entries "
                f"must point at the scratch block"))

    # -- K301: exactly one final writer per element ----------------------
    count = np.zeros(spec.region.shape, np.int32)
    groups: Dict[Tuple, List] = {}
    split_cluster = []
    for b in work:
        if b.meets is not None:
            groups.setdefault(b.meets, []).append(b)
    counted = set()
    for b in work:
        if b.meets is not None and spec.meet == "workspace":
            if b.meets in counted:
                continue
            counted.add(b.meets)
            members = groups[b.meets]
            if any(m.writes != members[0].writes for m in members):
                findings.append(error(
                    "K301", where,
                    f"pieces of {b.meets} that meet in a workspace name "
                    f"different final rectangles"))
        for r0, r1, c0, c1 in b.writes:
            if _in((r0, r1, c0, c1), spec.region.shape):
                count[r0:r1, c0:c1] += 1
    if spec.meet == "cluster":
        cl = np.asarray(spec.cluster)
        for key, members in groups.items():
            homes = {tuple(np.asarray(m.coord) // cl) for m in members}
            if len(homes) > 1:
                split_cluster.append(key)
    if split_cluster:
        findings.append(error(
            "K301", where,
            f"pieces that meet in a cluster span clusters: "
            f"{_fmt(split_cluster)}"))
    missing = np.argwhere(spec.region & (count == 0))
    multi = np.argwhere(count > 1)
    outside = np.argwhere(~spec.region & (count > 0))
    parts = []
    if missing.size:
        parts.append(f"{len(missing)} of {int(spec.region.sum())} elements "
                     f"never written (e.g. {_fmt([tuple(map(int, x)) for x in missing])})")
    if multi.size:
        parts.append(f"{len(multi)} written more than once (e.g. "
                     f"{_fmt([tuple(map(int, x)) for x in multi])})")
    if outside.size:
        parts.append(f"{len(outside)} written outside the region (e.g. "
                     f"{_fmt([tuple(map(int, x)) for x in outside])})")
    if parts:
        findings.append(error("K301", where,
                              f"{spec.output}: " + "; ".join(parts)))

    # -- K303: reads per output block == the truth's live set ------------
    if expected_reads:
        for op, truth in expected_reads.items():
            if op not in spec.operands:
                findings.append(error(
                    "K303", where,
                    f"liveness truth names unknown operand {op!r}"))
                continue
            got: Dict[Tuple, List[Rect]] = {}
            for b in work:
                for o, r in b.reads:
                    if o == op:
                        got.setdefault(b.cls, []).append(r)
            bad_cls = []
            for cls in sorted(set(truth) | set(got)):
                want = _merged(truth.get(cls, []))
                have = _merged(got.get(cls, []))
                if want != have:
                    bad_cls.append((cls, want, have))
            if bad_cls:
                cls, want, have = bad_cls[0]
                findings.append(error(
                    "K303", where,
                    f"{op}: reads disagree with the live set for "
                    f"{len(bad_cls)} output block(s); e.g. {cls}: live="
                    f"{want} read={have} — extra reads stream dead tiles "
                    f"or rows past a length, missing ones drop live work"))

    # -- K304: f32 accumulation ------------------------------------------
    for what, dt in (("accumulator", spec.acc_dtype),
                     ("partial/softmax state", spec.state_dtype)):
        if dt != "float32":
            findings.append(error(
                "K304", where,
                f"{what} is {dt}, must be float32 — low-precision "
                f"accumulation breaks the kernels' exactness contract"))

    # -- K305: the H100's shared memory per block ------------------------
    if spec.smem > SMEM_LIMIT or spec.threads > 1024:
        findings.append(error(
            "K305", where,
            f"a block asks for {spec.smem} B of dynamic shared memory and "
            f"{spec.threads} threads; an H100 block may take {SMEM_LIMIT} B "
            f"and 1024 threads"))

    # -- K306: enumerated cost == the H100 cost model --------------------
    if cost is not None:
        got = enumerate_cost(spec)
        want = (int(cost.passes), float(cost.flops), float(cost.hbm_bytes))
        if got != want:
            findings.append(error(
                "K306", where,
                f"spec enumeration (passes={got[0]}, flops={got[1]:.0f}, "
                f"bytes={got[2]:.0f}) disagrees with the cost model "
                f"(passes={want[0]}, flops={want[1]:.0f}, "
                f"bytes={want[2]:.0f}) — launch specs and "
                f"core.perf_model have diverged"))
    return findings


def audit_case(case: AuditCase, *, where: str = "") -> List[Finding]:
    return audit_kernel_spec(case.spec, expected_reads=case.expected_reads,
                             cost=case.cost,
                             where=where or f"kernels/{case.name}")


# ---------------------------------------------------------------------------
# Canonical cases: one small concrete launch per route a main path
# launches, with liveness truth derived from first principles (the
# bitmap, the block lists and lengths the tables are built from, causal
# structure), NOT from the plan arrays the kernels read.
# ---------------------------------------------------------------------------
#: (Kt, Nt) tile bitmap: dead tiles in both directions and an all-dead
#: column tile; its columns hold up to 6 live tiles, so the forward
#: splits
BITMAP = np.array([[1, 0, 0],
                   [0, 1, 0],
                   [1, 1, 0],
                   [1, 0, 0],
                   [0, 1, 0],
                   [1, 1, 0],
                   [1, 1, 0],
                   [1, 1, 0]], np.int32)


def bitmap_mask(bitmap: np.ndarray, tile: int = 128) -> np.ndarray:
    return np.repeat(np.repeat(bitmap, tile, 0), tile, 1).astype(np.float32)


def _walk_truth(bitmap, *, E, M, spec, trans) -> ExpectedReads:
    """The weight rectangles each output block of a forward-shaped walk
    (fwd / batched fwd: ``trans`` False; dx: True) must read: the
    bitmap's live tiles of its column (dx: of its K row), read at the
    block's columns."""
    T = 128
    K = bitmap.shape[0] * T
    cols = {b.cls: b.writes[0][3] - b.writes[0][2]
            for b in spec.blocks if b.works and b.writes}
    truth: Dict[Tuple, List[Rect]] = {}
    for (e, mb, cb), BN in cols.items():
        n0 = cb * BN
        t = n0 // T
        if trans:
            rects = [(e * K + n0, e * K + n0 + BN, int(n) * T,
                      (int(n) + 1) * T) for n in np.flatnonzero(bitmap[t])]
        else:
            rects = [(e * K + int(k) * T, e * K + (int(k) + 1) * T, n0,
                      n0 + BN) for k in np.flatnonzero(bitmap[:, t])]
        truth[(e, mb, cb)] = rects
    return {"w": truth}


def _bsmm_cases() -> List[AuditCase]:
    from repro_torch.core import perf_model as pm
    from repro_torch.kernels import spec as ks
    from repro_torch.kernels.bsmm import make_tile_plan

    bf, f32 = torch.bfloat16, torch.float32
    plan = make_tile_plan(bitmap_mask(BITMAP), strict=True)
    plan_t = make_tile_plan(bitmap_mask(BITMAP.T), strict=True)
    cases = []
    for M, dt, epi in ((8, bf, False), (128, bf, False), (64, f32, False),
                       (8, f32, True), (128, bf, True), (64, f32, True)):
        spec = ks.bsmm_fwd_spec(plan, M, dt, epilogue=epi)
        cases.append(AuditCase(
            f"{spec.name}_{spec.route}_m{M}_{str(dt)[6:]}", spec,
            _walk_truth(BITMAP, E=1, M=M, spec=spec, trans=False),
            pm.bsmm_fwd_cost(plan, M, dt),
            {"kind": "fwd", "bitmap": BITMAP, "M": M, "dtype": dt,
             "epilogue": epi}))
    for M, dt in ((128, bf), (64, f32)):
        spec = ks.bsmm_dx_spec(plan_t, M, dt)
        cases.append(AuditCase(
            f"bsmm_dx_{spec.route}_m{M}_{str(dt)[6:]}", spec,
            _walk_truth(BITMAP.T, E=1, M=M, spec=spec, trans=True),
            pm.bsmm_dx_cost(plan_t, M, dt),
            {"kind": "dx", "bitmap": BITMAP.T, "M": M, "dtype": dt}))
    for M, dt in ((2048, bf), (1024, f32)):
        spec = ks.bsmm_dw_spec(plan, M, dt)
        cases.append(AuditCase(
            f"bsmm_dw_{spec.route}_m{M}_{str(dt)[6:]}", spec,
            _dw_truth(BITMAP, E=1, M=M, spec=spec),
            pm.bsmm_dw_cost(plan, M, dt),
            {"kind": "dw", "bitmap": BITMAP, "M": M, "dtype": dt}))
    # the expert-batched forms: #1b streams at decode rows over a grid
    # that fills the card twice, runs wgmma at training rows; #3b, #4b
    for E, M in ((88, 8), (2, 64)):
        spec = ks.bsmm_batched_spec(plan, E, M, bf)
        cases.append(AuditCase(
            f"bsmm_batched_{spec.route}_e{E}_m{M}", spec,
            _walk_truth(BITMAP, E=E, M=M, spec=spec, trans=False),
            pm.bsmm_batched_cost(plan, E, M, bf),
            {"kind": "batched", "bitmap": BITMAP, "M": M, "E": E,
             "dtype": bf}))
    spec = ks.bsmm_dx_spec(plan_t, 64, bf, E=2)
    cases.append(AuditCase(
        f"bsmm_batched_dx_{spec.route}_e2_m64", spec,
        _walk_truth(BITMAP.T, E=2, M=64, spec=spec, trans=True),
        pm.bsmm_dx_cost(plan_t, 64, bf, E=2),
        {"kind": "batched_dx", "bitmap": BITMAP.T, "M": 64, "E": 2,
         "dtype": bf}))
    spec = ks.bsmm_dw_spec(plan, 64, bf, E=2)
    cases.append(AuditCase(
        f"bsmm_batched_dw_{spec.route}_e2_m64", spec,
        _dw_truth(BITMAP, E=2, M=64, spec=spec),
        pm.bsmm_dw_cost(plan, 64, bf, E=2),
        {"kind": "batched_dw", "bitmap": BITMAP, "M": 64, "E": 2,
         "dtype": bf}))
    return cases


def _dw_truth(bitmap, *, E, M, spec) -> ExpectedReads:
    """dw's blocks serve the bitmap's live tiles; each tile's blocks read
    all M rows of x's K-tile column and of g's N-tile column.  Classes
    are (expert, l) in row-major order of the live tiles."""
    T = 128
    kk, nn = np.nonzero(bitmap)
    x: Dict[Tuple, List[Rect]] = {}
    g: Dict[Tuple, List[Rect]] = {}
    for e in range(E):
        for l, (k, n) in enumerate(zip(kk, nn)):
            x[(e, l)] = [(e * M, e * M + M, int(k) * T, (int(k) + 1) * T)]
            g[(e, l)] = [(e * M, e * M + M, int(n) * T, (int(n) + 1) * T)]
    return {"x": x, "g": g}


def paged_case(route: str):
    """(geometry, tables, lengths, block lists, dtype, fused) of #6
    (``route`` "gqa") and #7's two routes ("wgmma", "simt")."""
    from repro_torch.kernels.paged_attention import (BLOCK_TOKENS,
                                                     PagedGeometry)
    T = BLOCK_TOKENS
    blocks = [[1, 2], [3]]                  # the truth the tables come from
    lengths = [T + 2, 7]
    NB, P, B = 3, 5, 2
    if route == "gqa":
        geo = PagedGeometry(B=B, Hq=4, hd=64, Hkv=2, T=T, NB=NB, P=P, dv=64)
        dt, fused = torch.bfloat16, False
    elif route == "wgmma":
        geo = PagedGeometry(B=B, Hq=64, hd=576, Hkv=1, T=T, NB=NB, P=P,
                            dv=512)
        dt, fused = torch.bfloat16, True
    else:
        geo = PagedGeometry(B=B, Hq=4, hd=64, Hkv=1, T=T, NB=NB, P=P, dv=32)
        dt, fused = torch.float32, True
    tables = np.zeros((B, NB), np.int32)    # dead entries: scratch block 0
    for b, blks in enumerate(blocks):
        tables[b, :len(blks)] = blks
    return geo, tables, lengths, blocks, dt, fused


def _paged_cases() -> List[AuditCase]:
    from repro_torch.core import perf_model as pm
    from repro_torch.kernels import spec as ks

    cases = []
    for route in ("gqa", "wgmma", "simt"):
        geo, tables, lengths, blocks, dt, fused = paged_case(route)
        spec = ks.paged_attention_spec(geo, tables, lengths, dt,
                                       fused=fused)
        ngb = spec.grid[0] // geo.Hkv
        truth: ExpectedReads = {"k_pool": {}}
        if not fused:
            truth["v_pool"] = {}
        for x in range(spec.grid[0]):
            h = x // ngb
            for b in range(geo.B):
                k_r, v_r = [], []
                for j, p in enumerate(blocks[b]):
                    live = min(geo.T, lengths[b] - j * geo.T)
                    rows = geo.T if spec.route == "wgmma" else live
                    k_r.append((p * geo.T, p * geo.T + rows, h * geo.hd,
                                (h + 1) * geo.hd))
                    v_r.append((p * geo.T, p * geo.T + rows, h * geo.dv,
                                (h + 1) * geo.dv))
                truth["k_pool"][(x, b)] = k_r
                if not fused:
                    truth["v_pool"][(x, b)] = v_r
        name = "paged_attention_gqa" if route == "gqa" else \
            f"paged_attention_mla_{spec.route}"
        cases.append(AuditCase(
            name, spec, truth,
            pm.paged_decode_cost(lengths, hq=geo.Hq, hkv=geo.Hkv,
                                 hd=geo.hd, dv=geo.dv, block_tokens=geo.T,
                                 route=spec.route, fused=fused, dtype=dt),
            {"kind": "paged", "route": route}))
    return cases


FLASH = dict(B=1, S=300, Hq=2, Hkv=1, hd=64, dv=64)


def _flash_cases() -> List[AuditCase]:
    from repro_torch.core import perf_model as pm
    from repro_torch.kernels import spec as ks

    cases = []
    g = FLASH
    for dt in (torch.bfloat16, torch.float32):
        spec = ks.flash_attention_spec(g["B"], g["S"], g["Hq"], g["Hkv"],
                                       g["hd"], g["dv"], dt, causal=True)
        BQ = 128 if spec.route == "wgmma" else 64
        BK = ks.flash_wgmma_geometry(g["hd"], g["dv"])[0] \
            if spec.route == "wgmma" else 64
        G = g["Hq"] // g["Hkv"]
        truth: Dict[Tuple, List[Rect]] = {}
        for b in range(g["B"]):
            for h in range(g["Hq"]):
                kh = h // G
                for qt in range(spec.grid[0]):
                    # causal: keys up to the block's last query row
                    last = min((qt + 1) * BQ, g["S"]) - 1
                    truth[(b, h, qt)] = [
                        (b * g["S"] + j * BK,
                         b * g["S"] + min((j + 1) * BK, g["S"]),
                         kh * g["hd"], (kh + 1) * g["hd"])
                        for j in range(last // BK + 1)]
        cases.append(AuditCase(
            f"flash_attention_{spec.route}", spec, {"k": truth},
            pm.flash_cost(batch=g["B"], seq=g["S"], hq=g["Hq"],
                          hkv=g["Hkv"], hd=g["hd"], dv=g["dv"], bq=BQ,
                          bk=BK, causal=True, dtype=dt),
            {"kind": "flash", "dtype": dt}))
    return cases


def default_cases() -> List[AuditCase]:
    """The canonical small concrete launches: every route a main path
    launches.  #5 and #9 carry no liveness truth or cost (their work is
    data-dependent or not a product), so K303 and K306 skip them, as in
    the reference."""
    from repro_torch.kernels import spec as ks

    cases = _bsmm_cases()
    cases.extend(_paged_cases())
    cases.extend(_flash_cases())
    for M, dt in ((8, torch.bfloat16), (256, torch.bfloat16),
                  (64, torch.float32)):
        spec = ks.masked_matmul_spec(M, 384, 256, dt, dt)
        cases.append(AuditCase(
            f"masked_matmul_{spec.route}_m{M}", spec, None, None,
            {"kind": "masked", "M": M, "K": 384, "N": 256, "dtype": dt}))
    cases.append(AuditCase(
        "tile_stats", ks.tile_stats_spec(320, 256), None, None,
        {"kind": "tile_stats", "K": 320, "N": 256}))
    return cases


def audit_kernels(cases: Optional[Sequence[AuditCase]] = None
                  ) -> List[Finding]:
    """K300–K306 over every canonical case — the ``lint --kernels``
    entry point."""
    out: List[Finding] = []
    for case in (cases if cases is not None else default_cases()):
        out.extend(audit_case(case))
    return out
