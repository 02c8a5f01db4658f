"""The port's CUDA launch audit (K300–K306) against its own kernels' host
rules and the reference's Pallas specs.

Every default case audits clean; each spec's route and split count equal
the wrapper's route functions; the weight tiles read per output column
equal the reference ``KernelSpec``'s gathers for the same bitmap; K306's
flops equal the reference ``KernelCost``'s at the same plan and rows;
and each of K300–K306 is proven by a seeded defect on the port's specs.
Host numpy only: the card holds each case to its kernel in
``chip_smoke.py``'s lint phase.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.kernels import bsmm as rbsmm
from repro.core import perf_model as rpm
from repro_torch.analysis import RULES, audit_case, audit_kernels
from repro_torch.analysis.kernel_audit import (BITMAP, AuditCase,
                                               bitmap_mask, default_cases,
                                               enumerate_cost)
from repro_torch.core import perf_model as pm
from repro_torch.kernels import bsmm as kb
from repro_torch.kernels import spec as ks
from repro_torch.kernels.bsmm import make_tile_plan

TESTED = set()
bf, f32 = torch.bfloat16, torch.float32


def assert_code(findings, code):
    TESTED.add(code)
    got = {f.code for f in findings}
    assert code in got, f"expected {code} in {got}: {findings}"
    assert all(f.severity == "error" for f in findings if f.code == code)


@pytest.fixture(scope="module")
def cases():
    return {c.name: c for c in default_cases()}


@pytest.fixture(scope="module")
def plan():
    return make_tile_plan(bitmap_mask(BITMAP), strict=True)


def _case(cases, prefix):
    return next(c for n, c in cases.items() if n.startswith(prefix))


def _swap(spec, **kw):
    return dataclasses.replace(spec, **kw)


def _replace_block(spec, i, **kw):
    blocks = list(spec.blocks)
    blocks[i] = dataclasses.replace(blocks[i], **kw)
    return _swap(spec, blocks=tuple(blocks))


# ---------------------------------------------------------------------------
# the clean path, and the specs' agreement with the wrappers' rules
# ---------------------------------------------------------------------------
def test_default_cases_audit_clean(cases):
    assert audit_kernels() == []
    for c in cases.values():
        assert audit_case(c) == [], c.name


def test_every_main_path_route_has_a_case(cases):
    got = {(c.spec.kernel, c.spec.route) for c in cases.values()}
    want = {("#1", r) for r in ("stream", "wgmma", "fma")} | \
        {("#2", r) for r in ("stream", "wgmma", "fma")} | \
        {("#3", "wgmma"), ("#3", "simt"), ("#4", "wgmma"), ("#4", "fma"),
         ("#1b", "stream"), ("#1b", "wgmma"), ("#3b", "wgmma"),
         ("#4b", "wgmma"), ("#5", "stream"), ("#5", "wgmma"),
         ("#5", "fma"), ("#6", "simt"), ("#7", "wgmma"), ("#7", "simt"),
         ("#8", "wgmma"), ("#8", "simt"), ("#9", "simt")}
    assert got == want
    for k in ("#1", "#3", "#4"):
        assert any(c.spec.kernel == k and c.spec.splits > 1
                   for c in cases.values()), k
    # #5 and #9 carry no liveness truth and no cost, as in the reference
    for c in cases.values():
        has = c.spec.kernel not in ("#5", "#9")
        assert (c.expected_reads is not None) == has
        assert (c.cost is not None) == has


def test_spec_routes_and_splits_are_the_wrappers(cases, plan):
    plan_t = make_tile_plan(bitmap_mask(BITMAP.T), strict=True)
    for c in cases.values():
        s, i = c.spec, c.inputs
        if i["kind"] in ("fwd",):
            K, N = BITMAP.shape[0] * 128, BITMAP.shape[1] * 128
            assert s.route == kb.bsmm_route(i["M"], K, N, i["dtype"], plan)
            assert s.splits == kb.bsmm_splits(i["M"], K, N, i["dtype"], plan)
        elif i["kind"] in ("dx", "batched_dx"):
            E = i.get("E", 1)
            K, N = BITMAP.shape[1] * 128, BITMAP.shape[0] * 128
            assert s.route == kb.bsmm_dx_route(i["M"], i["dtype"])
            assert s.splits == kb.bsmm_dx_splits(i["M"], K, N, i["dtype"],
                                                 plan_t, E)
        elif i["kind"] in ("dw", "batched_dw"):
            E = i.get("E", 1)
            assert s.route == kb.bsmm_dw_route(i["dtype"])
            assert s.splits == kb.bsmm_dw_splits(plan.live_tiles, i["M"],
                                                 i["dtype"], E)
        elif i["kind"] == "batched":
            N = BITMAP.shape[1] * 128
            assert s.route == kb.bsmm_batched_route(i["M"], N, i["dtype"],
                                                    i["E"])
            assert s.splits == kb.bsmm_batched_splits(i["M"], N, i["dtype"],
                                                      plan, i["E"])
        elif i["kind"] == "masked":
            assert s.route == kb.masked_route(i["M"], i["K"], i["N"],
                                              i["dtype"])
            want = 1 if s.route == "wgmma" else len(
                kb.masked_splits(i["M"], i["K"], i["N"]))
            assert s.splits == want


def test_paged_and_flash_geometry_is_the_wrappers(cases):
    from repro_torch.analysis.kernel_audit import paged_case
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import paged_attention as kp
    for route, name in (("gqa", "paged_attention_gqa"),
                        ("wgmma", "paged_attention_mla_wgmma"),
                        ("simt", "paged_attention_mla_simt")):
        geo, tables, lengths, blocks, dt, fused = paged_case(route)
        spec = cases[name].spec
        want = kp.fused_route(geo, dt) if fused else "simt"
        assert spec.route == want
        kp._check_kernel_geometry(geo, 2 if dt == bf else 4, fused=fused,
                                  route=want)
        assert (spec.grid[1], spec.grid[2]) == (geo.B, geo.NB)
    assert cases["paged_attention_mla_wgmma"].spec.smem == \
        kp.fused_wgmma_smem_bytes(576)
    for dt, name in ((bf, "flash_attention_wgmma"),
                     (f32, "flash_attention_simt")):
        assert cases[name].spec.route == kf._ROUTES[dt]


def _ref_w_gathers(spec, cls_axes):
    """{class: sorted w tile coords} of a reference KernelSpec's
    unguarded cells (its ``pl.when`` mirror)."""
    w = next(b for b in spec.inputs if b.name == "w")
    out = {}
    for c in np.ndindex(*spec.grid):
        if spec.guard is not None and not spec.guard(*c, *spec.scalars):
            continue
        coord = tuple(int(v) for v in w.index_map(*c, *spec.scalars))
        out.setdefault(tuple(c[a] for a in cls_axes), []).append(coord)
    return {k: sorted(v) for k, v in out.items()}


def _port_w_tiles(spec, col_of):
    """{output tile: sorted w tile coords read over all its blocks}."""
    out = {}
    for b in spec.working():
        for op, (r0, r1, c0, c1) in b.reads:
            if op == "w":
                out.setdefault(col_of(b), set()).add((r0 // 128, c0 // 128))
    return {k: sorted(v) for k, v in out.items()}


@pytest.mark.parametrize("M,dtype", [(8, bf), (128, bf), (64, f32)])
def test_forward_reads_equal_reference_gathers(M, dtype, plan):
    rplan = rbsmm.make_tile_plan(bitmap_mask(BITMAP), tile=128,
                                 interpret=True)
    K, N = BITMAP.shape[0] * 128, BITMAP.shape[1] * 128
    ref = rbsmm.bsmm_fwd_spec(rplan.idx, rplan.counts, rplan.kmax, M=128,
                              K=K, N=N, bm=128, bk=128, bn=128)
    want = {j: v for (i, j), v in _ref_w_gathers(ref, (0, 1)).items()}
    spec = ks.bsmm_fwd_spec(plan, M, dtype)
    got = _port_w_tiles(spec, lambda b: b.writes[0][2] // 128)
    assert got == {j: v for j, v in want.items() if v}


def test_dx_reads_equal_reference_gathers():
    plan_t = make_tile_plan(bitmap_mask(BITMAP.T), strict=True)
    rplan = rbsmm.make_tile_plan(bitmap_mask(BITMAP.T), tile=128,
                                 interpret=True)
    K, N = BITMAP.shape[1] * 128, BITMAP.shape[0] * 128
    ref = rbsmm.bsmm_dx_spec(rplan.idx_t, rplan.counts_t, rplan.nmax, M=128,
                             K=K, N=N, bm=128, tile=128)
    want = {k: v for (i, k), v in _ref_w_gathers(ref, (0, 1)).items()}
    for M, dt in ((128, bf), (64, f32)):
        spec = ks.bsmm_dx_spec(plan_t, M, dt)
        got = _port_w_tiles(spec, lambda b: b.writes[0][2] // 128)
        assert got == {k: v for k, v in want.items() if v}


def test_k306_flops_equal_reference_cost(plan):
    rplan = rbsmm.make_tile_plan(bitmap_mask(BITMAP), tile=128,
                                 interpret=True)
    for M in (128, 256):
        assert pm.bsmm_fwd_cost(plan, M, bf).flops == \
            rpm.bsmm_fwd_cost(rplan, M, bm=128).flops
        assert pm.bsmm_dx_cost(plan, M, bf).flops == \
            rpm.bsmm_dx_cost(rplan, M, bm=128).flops
    for M in (2048, 4096):
        assert pm.bsmm_dw_cost(plan, M, bf).flops == \
            rpm.bsmm_dw_cost(rplan, M, bm=128).flops


def test_enumeration_equals_cost_model_on_every_case(cases):
    for c in cases.values():
        if c.cost is not None:
            got = enumerate_cost(c.spec)
            assert got == (c.cost.passes, c.cost.flops, c.cost.hbm_bytes), \
                c.name


def test_shared_memory_figures_fit(cases):
    # the wgmma rings: 3 stages two blocks an SM, 6 alone (bsmm.cu Ring)
    assert ks.ring_smem(1) == 6 * 32768 + 96 + 1024
    assert ks.ring_smem(1000) == 3 * 32768 + 48 + 1024
    # the flash instantiations all fit (the .cu static_asserts)
    for (hc, dc) in ks._FLASH_BK:
        assert ks.flash_wgmma_geometry(64 * hc, 64 * dc)[1] <= ks.SMEM_LIMIT
    assert ks.flash_f32_smem(256, 256) == 222208     # the wrapper's doc


# ---------------------------------------------------------------------------
# seeded defects: K300-K306
# ---------------------------------------------------------------------------
def test_k300_malformed_specs(cases):
    spec = _case(cases, "bsmm_wgmma").spec
    assert_code(audit_case(AuditCase("x", _swap(spec, grid=(0, 3, 3)))),
                "K300")
    assert_code(audit_case(AuditCase("x", _swap(spec, cluster=(1, 1, 2)))),
                "K300")
    dup = _swap(spec, blocks=spec.blocks + spec.blocks[:1])
    assert_code(audit_case(AuditCase("x", dup)), "K300")
    assert_code(audit_case(AuditCase("x", _swap(spec, meet="atomics"))),
                "K300")
    bad = _replace_block(spec, 0, reads=(("nope", (0, 1, 0, 1)),))
    assert_code(audit_case(AuditCase("x", bad)), "K300")


def test_k301_skipped_and_double_writes(cases):
    spec = _case(cases, "bsmm_stream").spec
    cls = spec.blocks[0].cls
    # no piece of one output block writes it: its elements are skipped
    blocks = tuple(dataclasses.replace(b, writes=()) if b.cls == cls else b
                   for b in spec.blocks)
    assert_code(audit_case(AuditCase("x", _swap(spec, blocks=blocks))),
                "K301")
    # pieces that meet in a workspace naming different rectangles
    i = next(n for n, b in enumerate(spec.blocks) if b.works and b.meets)
    r0, r1, c0, c1 = spec.blocks[i].writes[0]
    assert_code(audit_case(AuditCase("x", _replace_block(
        spec, i, writes=((r0, r1, c0, c1 - 2),)))), "K301")
    # a cluster rank writing its neighbour's rows: written twice
    wg = _case(cases, "bsmm_wgmma").spec
    j = next(n for n, b in enumerate(wg.blocks) if b.coord[2] == 1)
    k = next(n for n, b in enumerate(wg.blocks) if b.coord[2] == 0
             and b.cls == wg.blocks[j].cls)
    assert_code(audit_case(AuditCase(
        "x", _replace_block(wg, j, writes=wg.blocks[k].writes))), "K301")
    # dw: a dead tile written
    dw = _case(cases, "bsmm_dw_wgmma").spec
    assert_code(audit_case(AuditCase("x", _replace_block(
        dw, 0, writes=((0, 128, 128, 256),)))), "K301")
    # pieces that meet in a cluster placed in two clusters
    assert_code(audit_case(AuditCase("x", _swap(wg, cluster=(1, 1, 1)))),
                "K301")


def test_k302_out_of_bounds_reads_and_tables(cases, plan):
    bad_plan = dataclasses.replace(plan, idx=np.where(
        np.asarray(plan.idx) == 7, 8, plan.idx).astype(np.int32))
    spec = ks.bsmm_fwd_spec(bad_plan, 128, bf)
    assert_code(audit_case(AuditCase("x", spec)), "K302")
    c = _case(cases, "paged_attention_gqa")
    table = np.asarray(c.spec.table).copy()
    table[1, 2] = c.spec.pool_blocks          # a dead entry past the pool
    assert_code(audit_case(AuditCase("x", _swap(c.spec, table=table))),
                "K302")


def test_k303_loose_and_tight_liveness(cases, plan):
    c = _case(cases, "bsmm_wgmma")
    # a plan whose list names a dead tile: reads stream it
    idx = np.asarray(plan.idx).copy()
    idx[0, 0] = 1                             # tile (1, 0) is dead
    stale = dataclasses.replace(plan, idx=idx)
    assert_code(audit_case(dataclasses.replace(
        c, spec=ks.bsmm_fwd_spec(stale, 128, bf), cost=None)), "K303")
    # a list cut short: live work dropped
    counts = np.asarray(plan.counts).copy()
    counts[1] -= 1
    short = dataclasses.replace(plan, counts=counts)
    assert_code(audit_case(dataclasses.replace(
        c, spec=ks.bsmm_fwd_spec(short, 128, bf), cost=None)), "K303")
    # paged: a block past the length read
    p = _case(cases, "paged_attention_gqa")
    lengths = [129, 7 + 128]                  # sequence 1 reads block 0
    spec = ks.paged_attention_spec(*_geo_tables(p), lengths, bf)
    assert_code(audit_case(dataclasses.replace(p, spec=spec, cost=None)),
                "K303")
    # flash: a causal block reading past its last query
    f = _case(cases, "flash_attention_simt")
    spec = ks.flash_attention_spec(1, 300, 2, 1, 64, 64, f32, causal=False)
    assert_code(audit_case(dataclasses.replace(f, spec=spec, cost=None)),
                "K303")


def _geo_tables(case):
    from repro_torch.analysis.kernel_audit import paged_case
    geo, tables, *_ = paged_case("gqa")
    return geo, tables


def test_k304_low_precision_accumulation(cases):
    spec = _case(cases, "bsmm_wgmma").spec
    assert_code(audit_case(AuditCase("x", _swap(spec,
                                                acc_dtype="bfloat16"))),
                "K304")
    fl = _case(cases, "flash_attention_wgmma").spec
    assert_code(audit_case(AuditCase("x", _swap(fl,
                                                state_dtype="float16"))),
                "K304")


def test_k305_shared_memory_over_the_h100(cases):
    spec = _case(cases, "flash_attention_wgmma").spec
    assert_code(audit_case(AuditCase(
        "x", _swap(spec, smem=ks.SMEM_LIMIT + 1))), "K305")
    assert audit_case(AuditCase("x", _swap(spec, smem=ks.SMEM_LIMIT))) == []


def test_k306_tampered_and_stale_costs(cases, plan):
    c = _case(cases, "bsmm_dx_wgmma")
    bad = dataclasses.replace(c.cost, flops=c.cost.flops + 1)
    assert_code(audit_case(dataclasses.replace(c, cost=bad)), "K306")
    c = _case(cases, "bsmm_wgmma")
    other = make_tile_plan(bitmap_mask(np.ones_like(BITMAP)), strict=True)
    assert_code(audit_case(dataclasses.replace(
        c, cost=pm.bsmm_fwd_cost(other, 128, bf))), "K306")


# keep last: every K code has a seeded-defect test above; the R/P/J
# codes are exercised by tests/test_torch_lint.py
def test_every_k_rule_code_is_exercised():
    assert TESTED == {c for c in RULES if c.startswith("K")}
