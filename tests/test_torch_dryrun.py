"""The dry-run and its cost tools against the reference's
(``repro.launch.{dryrun,costs,hlo_analysis}``).

The analytic pieces (model flops, the per-segment flop weights, the
scan correction κ, the variants' config transforms) equal the
reference's exactly for every arch × shape; ``corrected_roofline`` reads
a reference record as the reference does, with the port's peaks.  The
step trace counts a dense product's flops exactly, records each kernel
wrapper's fake launch with the route and ``KernelCost`` the real rule
gives (no launch counter moves), and refuses a fake operand with no
trace active.  On an abstract (2, 2) mesh rank 0's arguments are the
layout's local shards and its collectives are the closed form of a tiny
llama's; at full size ``python -m repro_torch.launch.dryrun --arch
llama3.2-3b`` writes the reference's record keys on 16×16.
"""
import json
import math
import os

import numpy as np
import pytest
import torch

import repro_torch.configs as tcfgs
from repro_torch.core import perf_model as pm
from repro_torch.kernels import bsmm as kb
from repro_torch.kernels import flash_attention as kf
from repro_torch.launch import costs as tcosts
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import hlo_analysis as tha
from repro_torch.launch import steps as tsteps


@pytest.fixture(scope="module")
def ref():
    """The reference's dry-run module, imported without letting its
    512-device ``XLA_FLAGS`` reach a JAX backend started later in this
    process."""
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import costs as rcosts
        from repro.launch import dryrun as rdry
        from repro.launch import hlo_analysis as rha
        from repro.launch import steps as rsteps
        from repro.configs import get_arch, get_shape
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return dict(costs=rcosts, dryrun=rdry, ha=rha, steps=rsteps,
                get_arch=get_arch, get_shape=get_shape)


CELLS = [(a, s.name) for a in tcfgs.list_archs() for s in tcfgs.ALL_SHAPES]


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_analytic_costs_equal_reference(arch, shape, ref):
    tc, ts = tcfgs.get_arch(arch), tcfgs.get_shape(shape)
    rc, rs = ref["get_arch"](arch), ref["get_shape"](shape)
    assert _rel(tdry.model_flops_estimate(tc, ts),
                ref["dryrun"].model_flops_estimate(rc, rs)) <= 1e-12
    assert _rel(tcosts.scan_correction(tc, ts),
                ref["costs"].scan_correction(rc, rs)) <= 1e-12
    segs, rest = tcosts.segment_flop_weights(tc, ts)
    rsegs, rrest = ref["costs"].segment_flop_weights(rc, rs)
    assert [r for _, r in segs] == [r for _, r in rsegs]
    for (f, _), (g, _) in zip(segs, rsegs):
        assert _rel(f, g) <= 1e-12
    assert _rel(rest, rrest) <= 1e-12
    assert tsteps.cell_skip_reason(tc, ts) == \
        ref["steps"].cell_skip_reason(rc, rs)


VARIANTS = ({}, {"pruned": "0.5"}, {"pruned": "0.9"}, {"capacity": "2.0"},
            {"remat": "dots"}, {"zero1": True, "pruned": "0.75"})


def _fields(cfg):
    moe = cfg.moe
    return (cfg.d_ff, cfg.rnn_width, None if moe is None else (
        moe.d_ff_expert, moe.d_ff_shared, moe.capacity_factor))


@pytest.mark.parametrize("opts", VARIANTS, ids=lambda o: json.dumps(o))
def test_apply_variant_equals_reference(opts, ref):
    from repro.models import transformer as rtfm
    from repro_torch.models import transformer as ttfm
    try:
        for arch in tcfgs.list_archs():
            got = tdry.apply_variant(tcfgs.get_arch(arch), dict(opts))
            want = ref["dryrun"].apply_variant(ref["get_arch"](arch),
                                               dict(opts))
            assert _fields(got) == _fields(want), arch
        if "remat" in opts:
            assert ttfm._REMAT_POLICY == "dots" == rtfm._REMAT_POLICY
    finally:
        ttfm.set_remat(True, policy="full")
        rtfm.set_remat(True, policy="full")


def _ref_record():
    return {"flops": 3.0e14, "bytes": 2.0e12, "collective_bytes": 4.0e10,
            "n_chips": 256, "model_flops": 5.0e16, "bottleneck": "memory"}


@pytest.mark.parametrize("arch,shape", [("llama3.2-3b", "train_4k"),
                                        ("recurrentgemma-2b", "long_500k"),
                                        ("deepseek-v3-671b", "prefill_32k")])
def test_corrected_roofline_reads_reference_records(arch, shape, ref):
    rec = _ref_record()
    got = tcosts.corrected_roofline(rec, tcfgs.get_arch(arch),
                                    tcfgs.get_shape(shape))
    want = ref["costs"].corrected_roofline(rec, ref["get_arch"](arch),
                                           ref["get_shape"](shape))
    for k in ("flops", "bytes", "collective_bytes", "kappa"):
        assert _rel(got[k], want[k]) <= 1e-12, k
    rha = ref["ha"]
    for k, peak, rpeak in (("compute_s", tha.PEAK_FLOPS, rha.PEAK_FLOPS),
                           ("memory_s", tha.HBM_BW, rha.HBM_BW),
                           ("collective_s", tha.NET_BW, rha.ICI_BW)):
        assert _rel(got[k], want[k] * rpeak / peak) <= 1e-12, k
    # a port record carries kappa 1.0: the correction is the identity
    port = dict(tha.RooflineTerms(3.0e14, 2.0e12, 4.0e10, 256,
                                  5.0e16).as_dict(), kappa=1.0)
    again = tcosts.corrected_roofline(port, tcfgs.get_arch(arch),
                                      tcfgs.get_shape(shape))
    for k, v in port.items():
        if isinstance(v, float):
            assert _rel(again[k], v) <= 1e-12, k
        else:
            assert again[k] == v, k


# ---------------------------------------------------------------------------
# the step trace
# ---------------------------------------------------------------------------
def test_trace_counts_a_dense_product_exactly():
    M, K, N = 12, 40, 24
    specs = [torch.empty(M, K, device="meta"), torch.empty(K, N, device="meta")]
    with tha.StepTrace() as tr:
        x, w = tr.fake(specs)
        y = x @ w
        assert isinstance(y, torch.Tensor) and y.shape == (M, N)
        y.t()                                   # a view: no traffic
    assert tr.flops == 2 * M * K * N
    mm = [o for o in tr.ops if o[3]]
    assert len(mm) == 1 and mm[0][4] == 4 * (M * K + K * N + M * N)
    assert all(o[4] == 0 for o in tr.ops if o[0] == "t")
    assert tr.argument_bytes == 4 * (M * K + K * N)
    assert tr.peak_bytes == 4 * (M * K + K * N + M * N)
    assert tha.dtype_census(tr)["f32"] >= 1
    assert tha.active() is None


def _plan(K, N, seed=0):
    rng = np.random.default_rng(seed)
    bm = rng.random((K // 128, N // 128)) < 0.5
    bm[0, 0] = True
    return kb.make_tile_plan(np.repeat(np.repeat(bm, 128, 0), 128, 1)
                             .astype(np.float32))


def _launch_counts():
    return (kb.bsmm.launches, dict(kb.bsmm.launches_by_route),
            kb.bsmm_dx.launches, kf.flash_attention.launches)


@pytest.mark.parametrize("M", [8, 300])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fake_launches_record_the_real_rule(M, dtype):
    K, N = 384, 512
    plan = _plan(K, N)
    before = _launch_counts()
    specs = [torch.empty(s, dtype=dtype, device="meta") for s in
             ((M, K), (K, N), (M, N), (1, 300, 8, 128), (1, 300, 2, 128))]
    with tha.StepTrace(device="cuda") as tr:
        x, w, g, q, kv = tr.fake(specs)
        assert x.device.type == "cuda"
        y = kb.bsmm(x, w, plan)
        dx = kb.bsmm_dx(g, w, plan)
        o = kf.flash_attention(q, kv, kv)
    assert (y.shape, dx.shape, o.shape) == ((M, N), (M, K), (1, 300, 8, 128))
    assert _launch_counts() == before
    fwd, bwd, fl = tr.kernels
    assert (fwd.name, fwd.route, fwd.splits) == (
        "bsmm", *plan.route_and_splits("fwd", M, dtype))
    assert fwd.cost == pm.bsmm_fwd_cost(plan, M, dtype)
    assert (bwd.name, bwd.route, bwd.splits) == (
        "bsmm_dx", *plan.route_and_splits("dx", M, dtype))
    assert bwd.cost == pm.bsmm_dx_cost(plan, M, dtype)
    route = "wgmma" if dtype == torch.bfloat16 else "simt"
    bq, bk = (128, 128) if route == "wgmma" else (64, 64)
    assert (fl.name, fl.route) == ("flash_attention", route)
    assert fl.cost == pm.flash_cost(batch=1, seq=300, hq=8, hkv=2, hd=128,
                                    dv=128, bq=bq, bk=bk, causal=True,
                                    dtype=dtype)
    assert tr.flops == fwd.cost.flops + bwd.cost.flops + fl.cost.flops
    assert tr.launches() == {"bsmm": {fwd.route: 1},
                             "bsmm_dx": {bwd.route: 1},
                             "flash_attention": {route: 1}}


def test_fake_masked_and_tile_stats_costs():
    specs = [torch.empty(s, device="meta")
             for s in ((8, 256), (256, 384), (256, 384))]
    with tha.StepTrace() as tr:
        x, w, m = tr.fake(specs)
        kb.masked_matmul(x, w, m, bm=8)
        from repro_torch.kernels.tile_stats import tile_stats
        live, sums = tile_stats(w)
    assert (live.shape, live.dtype) == ((2, 3), torch.int32)
    mm, ts = tr.kernels
    assert mm.route == kb.masked_route(8, 256, 384, torch.float32)
    assert mm.cost == pm.masked_matmul_cost(8, 256, 384, torch.float32,
                                            torch.float32)
    assert ts.cost == pm.tile_stats_cost(256, 384, torch.float32)


def test_fake_operand_without_a_trace_raises():
    from torch._subclasses.fake_tensor import FakeTensorMode
    plan = _plan(256, 256)
    with FakeTensorMode():
        x = torch.empty(8, 256, device="cuda")
        w = torch.empty(256, 256, device="cuda")
    with pytest.raises(RuntimeError, match="no StepTrace"):
        kb.bsmm(x, w, plan)
    from repro_torch.distributed.tensor_parallel import collective
    with pytest.raises(RuntimeError, match="no StepTrace"):
        collective("all_reduce", x, None)


# ---------------------------------------------------------------------------
# rank 0 of an abstract mesh
# ---------------------------------------------------------------------------
TINY = dict(dtype="float32", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            head_dim=16, d_ff=128, vocab_size=512)


def _bytes(tree):
    from repro_torch._bridge import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if torch.is_tensor(t))


def test_rank_local_arguments_and_collectives_closed_form():
    from repro_torch.distributed import tensor_parallel as tpar
    from repro_torch.launch.mesh import AbstractMesh
    cfg = tcfgs.scaled_down(tcfgs.get_arch("llama3.2-3b"), **TINY)
    shape = tcfgs.ShapeSpec("prefill_tiny", 32, 8, "prefill")
    axes = {"data": 2, "model": 2}
    tr, out_bytes = tdry.trace_cell(cfg, shape, axes)
    # the layout's local shards, and this data rank's 4 rows of tokens
    mesh = AbstractMesh(axes)
    pspec = tsteps.params_spec(cfg)
    shardings, whole = tpar.layout(pspec, cfg, tpar.mesh_rules(mesh, cfg))
    assert whole == []
    local = tpar.localize(pspec, shardings)
    assert tr.argument_bytes == _bytes(local) + 4 * 32 * 4
    assert tr.argument_bytes < _bytes(pspec)
    mem = tdry.memory_dict(tr, out_bytes)
    assert mem["total_bytes_per_device"] == tr.peak_bytes
    # one all-reduce a row-parallel product (wo, down) and one for the
    # vocab-parallel lookup, of (4, 32, d) f32; one all-gather of the
    # last position's logits (4, 1, V)
    rows = 4 * 32 * cfg.d_model * 4
    coll = tha.collective_bytes(tr)
    assert coll.count_by_kind == {"all-reduce": 2 * cfg.n_layers + 1,
                                  "all-gather": 1}
    assert coll.bytes_by_kind == {
        "all-reduce": (2 * cfg.n_layers + 1) * rows,
        "all-gather": 4 * cfg.padded_vocab * 4}
    assert all(c.group_size == 2 for c in tr.collectives)


def test_train_cell_on_a_mesh_and_zero1():
    """Rank 0's train step on an abstract (2, 2) mesh: the backward's
    collectives (copy-to-model all-reduces) and the gradients' sum over
    data; ZeRO-1 keeps a data rank's part of the moments and moves the
    gradients and parameters by reduce-scatter and all-gather."""
    cfg = tcfgs.scaled_down(tcfgs.get_arch("llama3.2-3b"), **TINY)
    shape = tcfgs.ShapeSpec("train_tiny", 16, 8, "train")
    axes = {"data": 2, "model": 2}
    tr, _ = tdry.trace_cell(cfg, shape, axes)
    z1, _ = tdry.trace_cell(cfg, shape, axes, zero1=True)
    c, cz = tha.collective_bytes(tr), tha.collective_bytes(z1)
    assert c.count_by_kind["all-reduce"] > 4 * cfg.n_layers
    assert "reduce-scatter" not in c.count_by_kind
    assert cz.count_by_kind["reduce-scatter"] >= 1
    assert z1.argument_bytes < tr.argument_bytes
    assert math.isfinite(tr.flops) and tr.flops > 0


def test_dryrun_main_writes_reference_records(tmp_path, capsys, ref,
                                             monkeypatch):
    out = tmp_path / "dryrun_results.json"
    assert tdry.main(["--arch", "llama3.2-3b", "--out", str(out)]) == 0
    recs = {r["shape"]: r for r in json.loads(out.read_text())}
    assert sorted(recs) == sorted(s.name for s in tcfgs.ALL_SHAPES)
    keys = {"arch", "shape", "mesh", "kind", "status", "compile_s",
            "n_chips", "memory", "roofline", "collectives", "kernels"}
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        r = recs[name]
        assert r["status"] == "OK" and set(r) == keys, r.get("error")
        assert r["mesh"] == "16x16" and r["n_chips"] == 256
        assert r["roofline"]["kappa"] == 1.0
        assert set(r["roofline"]) == set(tha.RooflineTerms(
            1, 1, 1, 1).as_dict()) | {"kappa"}
        assert set(r["memory"]) == {"argument_size_in_bytes",
                                    "output_size_in_bytes",
                                    "temp_size_in_bytes",
                                    "total_bytes_per_device"}
        assert r["collectives"]["count_by_kind"]["all-reduce"] > 0
    assert recs["prefill_32k"]["kernels"] == {
        "flash_attention": {"wgmma": 28}}
    skip = recs["long_500k"]
    assert skip["status"] == "SKIP" and skip["reason"] == \
        ref["steps"].cell_skip_reason(ref["get_arch"]("llama3.2-3b"),
                                      ref["get_shape"]("long_500k"))
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("[OK] llama3.2-3b × train_4k × 16x16  ")
    assert lines[-1].startswith("3 OK, 1 SKIP, 0 FAIL")
    # a cell whose trace raises records FAIL with the error (every family
    # runs on the production mesh now: one is made to raise here)
    def refuse(*a, **k):
        raise NotImplementedError("MLA attention: refused for the test")
    monkeypatch.setattr(tdry.tpar, "local_config", refuse)
    mla = tdry.run_cell("deepseek-v3-671b", "prefill_32k")
    assert mla["status"] == "FAIL" and "MLA" in mla["error"]
    assert "NotImplementedError" in mla["error"] and mla["traceback"]
    assert tdry.cell_line(mla).startswith("[FAIL] deepseek-v3-671b")
