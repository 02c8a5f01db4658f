"""The port's sparsity lint against the reference's (``repro.analysis``).

Same registry; the recipe lint's findings equal the reference's for every
recipe and family; every P rule planted on plans, pools, engines and
fleets built from the same numpy masks in both packages gives the same
code; the J rules' seeded-defect closure pairs agree (J202 and J203 are
port-only: the reference's versions need ``jax.experimental.enable_x64``,
which jax 0.9.0 no longer has); ``lint_arch`` reports equal the
reference's arch by arch (the reference run once, in a module fixture);
the CLI's exit codes; the kernel wrappers' body marks.  A final test
demands every R/P/J code the port emits is exercised here (the K codes
are in ``tests/test_torch_kernel_audit.py``).
"""
import copy
import dataclasses
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.analysis as ra
from repro.api.recipes import available_recipes as r_recipes
from repro.api.registry import available_families as r_families
from repro.api.registry import get_family as r_get_family
from repro.kernels.bsmm import make_tile_plan as r_make_tile_plan
from repro.models.plans import build_decode_plan as r_build_decode_plan
from repro_torch import analysis as ta
from repro_torch.api import cli
from repro_torch.api.recipes import Recipe, prune_stage, quantize_stage
from repro_torch.api.registry import get_family
from repro_torch.core.crossbar import xbar_stats
from repro_torch.kernels import _mark
from repro_torch.kernels.bsmm import make_tile_plan
from repro_torch.models.plans import PlanStats, build_decode_plan

TESTED = set()


def codes_of(findings):
    return {f.code for f in findings}


def assert_code(findings, code, severity=None):
    TESTED.add(code)
    got = codes_of(findings)
    assert code in got, f"expected {code} in {got}: {findings}"
    if severity:
        assert any(f.severity == severity for f in findings
                   if f.code == code)


def triples(findings):
    return sorted((f.code, f.where, f.severity) for f in findings)


@pytest.fixture(scope="module")
def mask():
    rng = np.random.default_rng(0)
    m = (rng.random((256, 384)) < 0.4).astype(np.float32)
    m[:128, :128] = 0
    m[128:, 256:] = 0
    return m


@pytest.fixture(scope="module")
def plans(mask):
    return make_tile_plan(mask), r_make_tile_plan(mask, interpret=True)


@pytest.fixture(scope="module")
def lm_masks(mask):
    rng = np.random.default_rng(1)
    m2 = (rng.random((384, 256)) < 0.5).astype(np.float32)
    m2[:128, :] = 0
    return {"segments": [[{"mlp": {"up": mask, "down": m2}}]]}


def _replace(plan, **kw):
    """A changed copy of either package's TilePlan."""
    if hasattr(plan, "_replace"):
        return plan._replace(**kw)
    return dataclasses.replace(plan, **kw)


# ---------------------------------------------------------------------------
# registry and findings model
# ---------------------------------------------------------------------------
def test_registry_matches_reference():
    assert list(ta.RULES) == list(ra.RULES)
    for code, rule in ta.RULES.items():
        assert rule.title == ra.RULES[code].title, code
    assert ta.SEVERITIES == ra.SEVERITIES
    assert ta.RULES["J201"].family == "dispatch auditor"
    assert ta.RULES["K305"].family == ra.RULES["K305"].family
    # the port documents itself, not Pallas
    assert "232,448" in ta.explain("K305")
    for code in ta.NEVER_EMITTED:
        assert "never emitted" in ta.RULES[code].doc


def test_finding_and_report_model():
    with pytest.raises(ValueError):
        ta.Finding("error", "X999", "here", "nope")
    with pytest.raises(ValueError):
        ta.Finding("fatal", "P101", "here", "nope")
    with pytest.raises(KeyError):
        ta.explain("Z1")
    r = ta.Report()
    r.add(ta.Finding("error", "P101", "a", "m"))
    r.add(ta.Finding("warning", "R005", "b", "m"))
    assert not r.ok and len(r.errors) == 1 and len(r.warnings) == 1
    loaded = json.loads(r.to_json())
    assert loaded["summary"]["error"] == 1
    assert ta.rules_markdown() == ra.rules_markdown()


# ---------------------------------------------------------------------------
# recipe linter: R001-R009
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("family", sorted(r_families()))
def test_recipe_lint_matches_reference_for_every_recipe(family):
    for name in r_recipes():
        got = ta.lint_recipe_for_family(name, get_family(family),
                                        where_prefix=f"{family}/")
        want = ra.lint_recipe_for_family(name, r_get_family(family),
                                         where_prefix=f"{family}/")
        assert triples(got) == triples(want), (family, name)


GRANS = ("filter", "channel", "index")
# each defect built from a package's own recipes module
_RECIPE_DEFECTS = {
    "R001": lambda R, P, Q: "no-such-recipe-xyz",
    "R002": lambda R, P, Q: R(name="r", stages=(P("expert", rate=0.2),)),
    "R003": lambda R, P, Q: R(name="r", stages=(
        P("filter", rate=0.3, target_sparsity=0.9),
        P("index", rate=0.3, target_sparsity=0.5))),
    "R004": lambda R, P, Q: R(name="r", stages=(
        P("filter", rate=0.3, retrain_steps=0),)),
    "R005": lambda R, P, Q: R(name="r", stages=(
        Q(8), P("filter", rate=0.3))),
    "R006": lambda R, P, Q: R(name="r", stages=(
        P("filter", rate=0.3), Q(8), P("index", rate=0.3))),
    "R007": lambda R, P, Q: R(name="r", stages=(
        P("filter", rate=0.1, max_rounds=2, target_sparsity=0.99),)),
    "R008": lambda R, P, Q: R(name="r", stages=(
        P("filter", rate=0.3), P("filter", rate=0.2))),
    "R009": lambda R, P, Q: R(name="r", stages=(Q(8),)),
}


@pytest.mark.parametrize("code", sorted(_RECIPE_DEFECTS))
def test_recipe_defect_matches_reference(code):
    from repro.api import recipes as rr
    make = _RECIPE_DEFECTS[code]
    got = ta.lint_recipe(make(Recipe, prune_stage, quantize_stage),
                         allowed_granularities=GRANS, family="cnn")
    want = ra.lint_recipe(make(rr.Recipe, rr.prune_stage, rr.quantize_stage),
                          allowed_granularities=GRANS, family="cnn")
    assert_code(got, code)
    assert triples(got) == triples(want)


# ---------------------------------------------------------------------------
# invariant verifier: P101-P116, the same numpy masks in both packages
# ---------------------------------------------------------------------------
def _dead_row(plan):
    j = int(np.argmin(np.asarray(plan.counts)))
    c = int(np.asarray(plan.counts)[j])
    idx = np.asarray(plan.idx).copy()
    dead = set(range(idx.shape[1])) - set(int(v) for v in idx[j, :c])
    idx[j, 0] = sorted(dead)[0]
    return idx


_PLAN_DEFECTS = {
    "P101": lambda p: _replace(p, idx=np.full_like(np.asarray(p.idx), 99)),
    "P102": lambda p: _replace(p, counts=np.where(
        np.arange(len(p.counts)) == 0, np.maximum(np.asarray(p.counts) - 1,
                                                  0), np.asarray(p.counts))
        .astype(np.int32)),
    "P103": lambda p: _replace(p, idx=_dead_row(p)),
    "P104": lambda p: _replace(
        p, idx=np.asarray(p.idx)[:, :int(np.asarray(p.counts).max()) - 1],
        kmax=int(np.asarray(p.counts).max()) - 1),
    "P105": lambda p: _replace(p, counts_t=np.asarray(p.counts_t) + np.eye(
        1, len(p.counts_t), dtype=np.int32)[0]),
    "P106": lambda p: _replace(
        p, kk=np.concatenate([[0], np.asarray(p.kk)[1:]]).astype(np.int32),
        nn=np.concatenate([[0], np.asarray(p.nn)[1:]]).astype(np.int32)),
    "P107": lambda p: _replace(p, live_tiles=p.live_tiles + 1),
}


@pytest.mark.parametrize("code", sorted(_PLAN_DEFECTS))
def test_plan_defect_matches_reference(code, plans, mask):
    tp, rp = plans
    assert ta.verify_tile_plan(tp, mask) == []
    assert ta.verify_tile_plan(tp) == []
    got = ta.verify_tile_plan(_PLAN_DEFECTS[code](tp), mask)
    want = ra.verify_tile_plan(_PLAN_DEFECTS[code](rp), mask)
    assert_code(got, code, "error")
    assert triples(got) == triples(want)


def test_p108_geometry_matches_reference(plans):
    tp, rp = plans
    wrong = np.ones((128, 384), np.float32)
    got, want = ta.verify_tile_plan(tp, wrong), ra.verify_tile_plan(rp, wrong)
    assert_code(got, "P108", "error")
    assert triples(got) == triples(want)


def test_p109_p110_decode_plan_matches_reference(lm_masks):
    tplan, tstats = build_decode_plan(lm_masks)
    rplan, rstats = r_build_decode_plan(lm_masks, interpret=True)
    assert ta.verify_decode_plan(lm_masks, tplan, tstats) == []
    tmasks = jax.tree.map(torch.from_numpy, lm_masks)
    assert ta.verify_decode_plan(tmasks, tplan, tstats) == []   # tensors
    for mutate in ("missing", "stale"):
        t, r = copy.deepcopy(tplan), copy.deepcopy(rplan)
        for p in (t, r):
            if mutate == "missing":
                del p[0][0]["mlp"]["up"]
            else:
                p[0][0]["mlp"]["up"] = p[0][0]["mlp"]["down"]
        got = ta.verify_decode_plan(lm_masks, t)
        assert_code(got, "P109", "error")
        assert triples(got) == triples(ra.verify_decode_plan(lm_masks, r))
    bad_t = PlanStats(routed=tstats.routed, live_tiles=tstats.live_tiles + 1,
                      total_tiles=tstats.total_tiles)
    got = ta.verify_decode_plan(lm_masks, tplan, bad_t)
    assert_code(got, "P110", "error")
    from repro.models.plans import PlanStats as RPlanStats
    bad_r = RPlanStats(routed=rstats.routed, live_tiles=rstats.live_tiles + 1,
                       total_tiles=rstats.total_tiles)
    assert triples(got) == triples(ra.verify_decode_plan(lm_masks, rplan,
                                                         bad_r))


def test_p111_xbar_stats_matches_reference(mask):
    from repro.core.crossbar import xbar_stats as r_xbar_stats
    st, rst = xbar_stats(mask != 0, 128, 128), r_xbar_stats(mask != 0, 128,
                                                            128)
    assert ta.verify_xbar_stats(st, mask) == []
    st.nonzero_cells += 3
    rst.nonzero_cells += 3
    got = ta.verify_xbar_stats(st, mask)
    assert_code(got, "P111", "error")
    assert triples(got) == triples(ra.verify_xbar_stats(rst, mask))
    rng = np.random.default_rng(2)
    masks = {"convs": [{"w": (rng.random((3, 3, 8, 16)) < 0.5)
                        .astype(np.float32)}], "fc": {"w": mask}, "b": None}
    conv = lambda p: p.startswith("convs")
    assert ta.verify_mask_accounting(masks, conv, rows=128, cols=128) == []
    tm = {"convs": [{"w": torch.from_numpy(masks["convs"][0]["w"])}],
          "fc": {"w": torch.from_numpy(mask)}, "b": None}
    assert ta.verify_mask_accounting(tm, conv, rows=128, cols=128) == []


def test_p112_engine_consistency_matches_reference(lm_masks):
    for verify, build in ((ta.verify_engine, build_decode_plan),
                          (ra.verify_engine, lambda m: r_build_decode_plan(
                              m, interpret=True))):
        plan, stats = build(lm_masks)
        g0 = SimpleNamespace(gid=0, masks=None, plan=None, plan_stats=None)
        dup = SimpleNamespace(gid=0, masks=None, plan=None, plan_stats=None)
        rep = SimpleNamespace(
            skipped_tile_fraction=stats.skipped_tile_fraction)
        findings = verify(SimpleNamespace(generations=(g0, dup), report=None))
        orphan = SimpleNamespace(gid=1, masks=None, plan=plan,
                                 plan_stats=stats)
        findings += verify(SimpleNamespace(generations=(g0, orphan),
                                           report=rep))
        stale = copy.deepcopy(plan)
        stale[0][0]["mlp"]["up"] = stale[0][0]["mlp"]["down"]
        bad = SimpleNamespace(gid=2, masks=lm_masks, plan=stale,
                              plan_stats=stats)
        findings += verify(SimpleNamespace(generations=(bad,), report=rep))
        if verify is ta.verify_engine:
            got = findings
        else:
            want = findings
    assert_code(got, "P112", "error")
    assert triples(got) == triples(want)


def test_engine_generation_keeps_its_masks(lm_masks):
    """The port's generations carry their masks (P112 needs them), and a
    live engine's generations verify clean, dense and paged."""
    import repro_torch.configs as tcfgs
    from repro_torch.core.masks import apply_masks, lm_prunable, make_masks
    from repro_torch.models import transformer as ttfm
    from repro_torch.serve import ServeEngine
    cfg = tcfgs.scaled_down(tcfgs.get_arch("llama3.2-3b"), n_layers=2)
    params = ttfm.init_params(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    masks = make_masks(params, lm_prunable)
    for paged in (True, False):
        eng = ServeEngine(params=apply_masks(params, masks), cfg=cfg,
                          masks=masks, batch_slots=2, capacity=32,
                          paged=paged, device="cpu")
        assert eng.generations[0].masks is masks
        eng.swap(eng.params, masks)
        assert ta.verify_engine(eng) == []
        assert len(eng.generations) == 2


def test_p113_p115_pool_and_tables_match_reference():
    from repro.serve import BlockPool as RBlockPool
    from repro_torch.serve import BlockPool
    T = 128
    results = []
    for pkg, Pool in ((ta, BlockPool), (ra, RBlockPool)):
        out = []
        pool = Pool(6)
        pool.reserve(1, 2)
        pool.alloc(1)
        assert pkg.verify_block_pool(pool) == []
        pool._owned[1].append(pool._free[-1])        # double-tracked
        out += pkg.verify_block_pool(pool)
        pool2 = Pool(6)
        pool2._free.pop()                            # leaked
        out += pkg.verify_block_pool(pool2)
        pool = Pool(8)
        pool.reserve(7, 3)
        b0, b1 = pool.alloc(7), pool.alloc(7)
        tables = np.zeros((2, 4), np.int32)
        tables[0, :2] = [b0, b1]
        lens = np.array([T + 5, 0], np.int32)
        nbs = np.array([2, 0], np.int64)
        kw = dict(block_tokens=T)
        assert pkg.verify_block_tables(pool, tables, lens, nbs, [7, None],
                                       **kw) == []
        bad = tables.copy()
        bad[0, :2] = [b1, b0]                        # logical order broken
        out += pkg.verify_block_tables(pool, bad, lens, nbs, [7, None], **kw)
        tail = tables.copy()
        tail[0, 3] = 5                               # dead entry off scratch
        out += pkg.verify_block_tables(pool, tail, lens, nbs, [7, None],
                                       **kw)
        results.append(out)
    assert_code(results[0], "P113", "error")
    assert_code(results[0], "P115", "error")
    assert triples(results[0]) == triples(results[1])


def test_p114_paged_reconstruction_matches_reference():
    from repro.models import attention as rattn
    from repro_torch.models import attention as tattn
    rng = np.random.default_rng(3)
    T = tattn.BLOCK_TOKENS
    H, d, S = 2, 4, T + 3
    k = rng.random((1, S, H, d)).astype(np.float32)
    v = rng.random((1, S, H, d)).astype(np.float32)
    dense = [[tattn.KVCache(torch.from_numpy(k), torch.from_numpy(v),
                            torch.tensor(S))]]
    empty = tattn.PagedKVCache(torch.zeros((4, T, H, d)),
                               torch.zeros((4, T, H, d)))
    adopted = [[tattn.gqa_paged_adopt(empty, dense[0][0], [1, 2])]]
    assert ta.verify_paged_reconstruction(adopted, dense, [1, 2], S) == []
    got = ta.verify_paged_reconstruction(adopted, dense, [2, 1], S)
    assert_code(got, "P114", "error")
    rdense = [[rattn.KVCache(jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(S, jnp.int32))]]
    rempty = rattn.PagedKVCache(jnp.zeros((4, T, H, d)),
                                jnp.zeros((4, T, H, d)))
    radopted = [[rattn.gqa_paged_adopt(rempty, rdense[0][0],
                                       jnp.asarray([1, 2], jnp.int32))]]
    assert triples(got) == triples(ra.verify_paged_reconstruction(
        radopted, rdense, [2, 1], S))


def test_p116_fleet_accounting_matches_reference():
    from repro.serve import FleetRecord as RRecord
    from repro.serve import FleetReport as RReport
    from repro_torch.serve import FleetRecord, FleetReport

    results = []
    for pkg, Rec, Rep in ((ta, FleetRecord, FleetReport),
                          (ra, RRecord, RReport)):
        def rec(uid, toks, status="done"):
            r = Rec(uid=uid, prompt=np.zeros(2, np.int32),
                    max_new_tokens=4, seq=uid)
            r.tokens = list(toks)
            r.status = status
            return r

        def router(finished, records, per, tokens):
            return SimpleNamespace(
                finished=finished, records=records, rejected=[], idle=True,
                live=set(), frontends=[],
                report=Rep(engines=len(per), live_engines=len(per),
                           requests=len(finished), tokens_generated=tokens,
                           per_engine=per))

        a, b = rec(0, [1, 2]), rec(1, [3])
        per = [SimpleNamespace(tokens_generated=2, requests=1),
               SimpleNamespace(tokens_generated=1, requests=1)]
        assert pkg.verify_fleet(router([a, b], {0: a, 1: b}, per, 3)) == []
        out = pkg.verify_fleet(router([a, a, b], {0: a, 1: b}, per, 3))
        lost = rec(2, [], status="running")
        out += pkg.verify_fleet(router([a, b], {0: a, 1: b, 2: lost}, per, 3))
        inflated = [SimpleNamespace(tokens_generated=2, requests=1),
                    SimpleNamespace(tokens_generated=2, requests=1)]
        out += pkg.verify_fleet(router([a, b], {0: a, 1: b}, inflated, 3))
        results.append(out)
    assert_code(results[0], "P116", "error")
    assert triples(results[0]) == triples(results[1])


# ---------------------------------------------------------------------------
# dispatch auditor: J201-J208
# ---------------------------------------------------------------------------
def _ref_audit(fn, shape, covered=None):
    return ra.audit_closure(jax.jit(fn), [jax.ShapeDtypeStruct(
        shape, jnp.float32)], covered=covered)


def test_j201_dense_matmul_on_covered_shape_matches_reference(plans, mask):
    tp, rp = plans
    covered = ta.collect_covered({"mlp": {"up": tp}})
    assert covered == ra.collect_covered({"mlp": {"up": rp}})
    w = torch.from_numpy(mask)
    got = ta.audit_closure(lambda x: x @ w, [torch.ones(4, 256)],
                           covered=covered)
    assert_code(got, "J201", "error")
    want = _ref_audit(lambda x: x @ jnp.asarray(mask), (4, 256), covered)
    assert triples(got) == triples(want)
    # the backward of a dense product is caught too (addmm, bmm forms)
    wg = w.clone().requires_grad_(True)
    got = ta.audit_closure(lambda x: torch.autograd.grad(
        (x[None] @ wg[None]).sum(), wg), [torch.ones(4, 256)],
        covered=covered)
    assert_code(got, "J201", "error")


def test_routed_closure_is_clean(plans, mask):
    """The kernel wrappers' plain versions multiply densely, inside their
    marked bodies: a routed closure, forward and backward, is clean."""
    from repro_torch.kernels.bsmm import plan_matmul
    tp, _ = plans
    covered = ta.collect_covered({"mlp": {"up": tp}})
    w = torch.from_numpy(mask).requires_grad_(True)

    def step(x):
        y = plan_matmul(x, w, tp, act="silu")
        torch.autograd.grad(y.sum(), w)

    assert ta.audit_closure(step, [torch.ones(4, 256)],
                            covered=covered) == []


def test_j202_float64_value_port_only():
    got = ta.audit_closure(lambda x: x.double() * 2.0, [torch.ones(4)])
    assert_code(got, "J202", "warning")
    assert ta.audit_closure(lambda x: x * 2.0, [torch.ones(4)]) == []


def test_j203_host_round_trip_port_only():
    for fn in (lambda x: x.sum().item(), lambda x: int(x.sum()),
               lambda x: torch.nonzero(x)):
        got = ta.audit_closure(fn, [torch.ones(4)])
        assert_code(got, "J203", "warning")
        assert len(got) == 1


def test_j204_closure_that_raises_matches_reference():
    def bad(x):
        raise ValueError("seeded")
    got = ta.audit_closure(bad, [torch.ones(4)])
    assert_code(got, "J204", "error")
    assert triples(got) == triples(_ref_audit(bad, (4,)))


def test_j205_no_kernel_at_all_matches_reference(plans):
    tp, rp = plans
    covered = ta.collect_covered({"up": tp})
    got = ta.audit_closure(lambda x: x * 2 + 1, [torch.ones(4, 256)],
                           covered=covered)
    assert_code(got, "J205", "error")
    assert "J201" not in codes_of(got)
    want = _ref_audit(lambda x: x * 2 + 1, (4, 256),
                      ra.collect_covered({"up": rp}))
    assert triples(got) == triples(want)


def test_j208_single_device_engine_is_silent():
    assert ta.audit_engine_sharding(SimpleNamespace(mesh=None)) == []
    assert ta.audit_engine_sharding(SimpleNamespace(
        mesh=SimpleNamespace(size=1))) == []


def test_unambiguous_covered_matches_reference(plans):
    tp, rp = plans
    for params in ({"w": np.zeros((256, 384), np.float32)},
                   {"w": np.zeros((256, 384), np.float32),
                    "other": np.zeros((256, 384), np.float32)}):
        tparams = jax.tree.map(torch.from_numpy, params)
        assert ta.unambiguous_covered({"up": tp}, tparams) == \
            ra.unambiguous_covered({"up": rp}, params)


# ---------------------------------------------------------------------------
# the kernel wrappers' marks: one entry a call, no launch, same result
# ---------------------------------------------------------------------------
def _wrapper_calls():
    from repro_torch.kernels import bsmm as kb
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.tile_stats import tile_stats
    g = torch.Generator().manual_seed(0)
    m = np.ones((256, 256), np.float32)
    m[:128, :128] = 0
    plan = kb.make_tile_plan(m)
    x = torch.randn(8, 256, generator=g)
    w = torch.randn(256, 256, generator=g)
    a = torch.randn(2, 8, 256, generator=g)
    wb = torch.randn(2, 256, 256, generator=g)
    q = torch.randn(1, 2, 64, generator=g)
    pool = torch.randn(2, 128, 1, 64, generator=g)
    tb = torch.tensor([[1]], dtype=torch.int32)
    ln = torch.tensor([5], dtype=torch.int32)
    fq = torch.randn(1, 16, 2, 64, generator=g)
    return {
        "bsmm": lambda: kb.bsmm(x, w, plan),
        "bsmm_epilogue": lambda: kb.bsmm_epilogue(x, w, plan, None, "silu"),
        "bsmm_batched": lambda: kb.bsmm_batched(a, wb, plan),
        "bsmm_dx": lambda: kb.bsmm_dx(x, w, plan),
        "bsmm_dw": lambda: kb.bsmm_dw(x, x, plan),
        "bsmm_batched_dx": lambda: kb.bsmm_batched_dx(a, wb, plan),
        "bsmm_batched_dw": lambda: kb.bsmm_batched_dw(a, a, plan),
        "masked_matmul": lambda: kb.masked_matmul(x, w, torch.from_numpy(m),
                                                  bm=8),
        "paged_attention": lambda: paged_attention(
            q, pool, pool, tb, ln, scale=0.125),
        "flash_attention": lambda: flash_attention(fq, fq, fq),
        "tile_stats": lambda: tile_stats(w),
    }


@pytest.mark.parametrize("name", sorted(_wrapper_calls()))
def test_wrapper_mark_costs_no_launch(name):
    import repro_torch.kernels.bsmm as kb
    import repro_torch.kernels.flash_attention as kf
    import repro_torch.kernels.paged_attention as kp
    import repro_torch.kernels.tile_stats as kt
    fn = getattr(kb, name, None) or getattr(kf, name, None) or \
        getattr(kp, name, None) or getattr(kt, name)
    assert fn.__wrapped__ is not None          # marked
    before = (fn.launches, getattr(fn, "fused_launches", 0))
    entered = _mark.entered
    out = _wrapper_calls()[name]()
    assert _mark.entered == entered + 1 and _mark.depth == 0
    assert (fn.launches, getattr(fn, "fused_launches", 0)) == before
    assert all(torch.isfinite(t).all() for t in
               (out if isinstance(out, tuple) else (out,)))
    # a raising call leaves no depth behind
    with pytest.raises(Exception):
        fn(torch.ones(3), torch.ones(3), None) if name != "tile_stats" \
            else fn(torch.ones(3))
    assert _mark.depth == 0


# ---------------------------------------------------------------------------
# lint_arch end to end, the CLI
# ---------------------------------------------------------------------------
E2E = ("llama3.2-3b", "deepseek-v3-671b", "recurrentgemma-2b",
       "xlstm-125m", "whisper-tiny", "phi-3-vision-4.2b", "vgg11",
       "resnet18")


@pytest.fixture(scope="module")
def ref_reports():
    return {name: ra.lint_arch(name) for name in E2E}


@pytest.mark.parametrize("name", E2E)
def test_lint_arch_matches_reference(name, ref_reports):
    got = ta.lint_arch(name, device="cpu")
    assert triples(got.findings) == triples(ref_reports[name].findings)
    assert got.ok


def test_lint_arch_audits_each_serving_closure():
    """Every closure of a paged serving arch enters the kernels, P114
    adopts a real prefill, and --hlo is refused."""
    import contextlib
    seen = {}

    @contextlib.contextmanager
    def probe(where):
        e = _mark.entered
        yield
        seen[where.split("/", 1)[1]] = _mark.entered - e

    rep = ta.lint_arch("llama3.2-3b", device="cpu", probe=probe)
    assert rep.ok
    assert set(seen) == {"train_step", "prefill", "decode", "decode_paged"}
    assert all(n > 0 for n in seen.values()), seen
    with pytest.raises(NotImplementedError, match="hlo_analysis"):
        ta.lint_arch("vgg11", hlo=True, device="cpu")


def test_cli_lint_all_kernels_cpu(capsys):
    from repro_torch.api.registry import list_adaptable
    assert cli.main(["lint", "--all", "--kernels", "--device", "cpu",
                     "--json"]) == cli.EXIT_OK
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert [l["arch"] for l in lines] == ["kernels", *list_adaptable()]
    assert len(lines) == 16
    assert all(l["summary"]["ok"] and not l["findings"] for l in lines)


def test_cli_lint_explain_and_refusals(capsys):
    assert cli.main(["lint", "--explain", "k301", "--json"]) == cli.EXIT_OK
    out = json.loads(capsys.readouterr().out)
    assert out["code"] == "K301" and out["title"] == ra.RULES["K301"].title
    assert cli.main(["lint", "--explain", "Z999", "--json"]) == \
        cli.EXIT_UNSUPPORTED
    out = json.loads(capsys.readouterr().out)
    assert out["error"] == "unknown rule" and out["known"] == sorted(ra.RULES)
    assert cli.main(["lint", "--arch", "vgg11", "--hlo", "--json"]) == \
        cli.EXIT_UNSUPPORTED
    out = json.loads(capsys.readouterr().out)
    assert out["event"] == "not_yet_ported" and "hlo" in out["what"]
    assert cli.main(["lint"]) == cli.EXIT_UNSUPPORTED
    capsys.readouterr()


def test_cli_lint_fails_on_error_findings(monkeypatch, capsys):
    import repro_torch.analysis as analysis_mod

    def bad_lint(name, **kw):
        r = ta.Report()
        r.add(ta.Finding("error", "P101", f"{name}/x", "seeded"))
        return r

    monkeypatch.setattr(analysis_mod, "lint_arch", bad_lint)
    assert cli.main(["lint", "--arch", "vgg11", "--device", "cpu",
                     "--json"]) == 1
    capsys.readouterr()


def test_j208_engine_sharding_placements():
    """J208 on a mesh engine's placements: none at all is an error, all
    Replicate() a warning, a sharded leaf clean; a meshless or one-rank
    engine has nothing to check.  (A real (1, 2) engine audits clean in
    ``tests/test_torch_distributed.py``.)"""
    from repro_torch.distributed.sharding import LeafSharding, Replicate, Shard

    class FakeMesh:
        def __init__(self, **axes):
            self.axis_names, self.shape = tuple(axes), dict(axes)

    mesh = FakeMesh(data=1, model=2)
    w = torch.ones(4, 4)

    def engine(placements, m=mesh):
        sharded = (None if placements is None else SimpleNamespace(
            shardings={"w": LeafSharding(m, (None, None), placements)}))
        gen = SimpleNamespace(gid=0, params={"w": w}, sharded=sharded)
        return SimpleNamespace(mesh=m, generations=[gen])

    got = ta.audit_engine_sharding(engine(None))
    assert_code(got, "J208", "error")
    got = ta.audit_engine_sharding(engine((Replicate(), Replicate())))
    assert_code(got, "J208", "warning")
    assert ta.audit_engine_sharding(engine((Replicate(), Shard(1)))) == []
    assert ta.audit_engine_sharding(engine(None, FakeMesh(data=1,
                                                          model=1))) == []
    assert ta.audit_engine_sharding(SimpleNamespace(mesh=None)) == []


# keep last: every R/P/J code the port emits has a seeded-defect test
# above; the K codes are exercised by tests/test_torch_kernel_audit.py
def test_every_emitted_rule_code_is_exercised():
    # what the port never emits, and why (each rule's doc says so too)
    never = {
        "J204 (closure not jitted)": "an eager port has no jit: only the "
                                     "'closure raised' meaning is emitted",
        "J206": "no compiled artifact: lint --hlo exits 2",
        "J207": "no compiled artifact: lint --hlo exits 2",
    }
    assert {k for k in never if " " not in k} == set(ta.NEVER_EMITTED)
    assert "never emitted" in ta.RULES["J204"].doc
    expected = {c for c in ta.RULES if c[0] in "RPJ"} - set(ta.NEVER_EMITTED)
    assert TESTED == expected, f"untested: {sorted(expected - TESTED)}"
