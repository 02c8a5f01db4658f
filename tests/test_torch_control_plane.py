"""The port's serving control plane against the reference's.

Same weights (the reference's ``init_params`` through the numpy bridge),
same crossbar tickets (the reference's ``structured_prune`` masks,
exported by its ``lottery``) and same requests go through ``repro``
(Pallas kernels in interpret mode) and ``repro_torch`` (plain PyTorch
versions on the CPU): dense-slot decode, hot-swap generations and
rollback, the front-end, the ticket manager, the fleet router and the
command line.  Greedy and sampled token streams are identical to the
reference's; the reference runs once per scenario (module fixture) and
the port's cases are held to its streams.  The config is llama3.2-3b
scaled down (2 layers, d_model 128, float32), as the reference's own
control-plane tests scale it.
"""
import json
import shutil
import time

import jax
import numpy as np
import pytest
import torch

import repro_torch.configs as tcfgs
from repro.api import structured_prune
from repro.configs import PruneConfig, get_arch, scaled_down
from repro.core import lottery as rlottery
from repro.core.masks import apply_masks as r_apply_masks
from repro.core.masks import lm_prunable as r_lm_prunable
from repro.models import transformer as rtfm
from repro.serve import Request as RRequest
from repro.serve import ServeEngine as RServeEngine
from repro.serve import TicketManager as RTicketManager
from repro_torch import _bridge
from repro_torch.api import cli
from repro_torch.core.masks import lm_prunable
from repro_torch.distributed.fault_tolerance import HeartbeatMonitor
from repro_torch.models import transformer as ttfm
from repro_torch.serve import (FleetRouter, Request, ServeEngine,
                               ServeFrontend, SubmitRejected, TicketError,
                               TicketManager, TicketMismatch)
from repro_torch.serve.manager import SwapEvent

torch.set_num_threads(2)

CAP = 96
SMALL = dict(dtype="float32", n_layers=2)
PROBE = 6          # fingerprint probe tokens


def _prompt(i):
    return np.arange(1 + i, 9 + i, dtype=np.int32)


def _reqs(cls, n, budget):
    return [cls(uid=i, prompt=_prompt(i), max_new_tokens=budget)
            for i in range(n)]


def _ragged(cls, n=6, seed=1, max_new=6):
    rng = np.random.RandomState(seed)
    return [cls(uid=i, prompt=rng.randint(1, 512, size=rng.randint(4, 14)
                                          ).astype(np.int32),
                max_new_tokens=max_new)
            for i in range(n)]


def _served(eng, reqs):
    for r in reqs:
        eng.submit(r)
    return {r.uid: list(r.tokens) for r in eng.run()}


@pytest.fixture(scope="module")
def cp(tmp_path_factory):
    """Configs, weights, two tickets on disk, and every reference stream
    the port's cases are held to (one reference run per scenario)."""
    rcfg = scaled_down(get_arch("llama3.2-3b"), **SMALL)
    tcfg = tcfgs.scaled_down(tcfgs.get_arch("llama3.2-3b"), **SMALL)
    rparams = rtfm.init_params(jax.random.PRNGKey(0), rcfg)
    masks = {"a": structured_prune(rparams, [("filter", 0.2)],
                                   prunable=r_lm_prunable,
                                   cfg=PruneConfig()),
             "b": structured_prune(rparams, [("xbar", 0.4), ("filter", 0.3)],
                                   prunable=r_lm_prunable,
                                   cfg=PruneConfig())}
    masks = {k: jax.tree.map(np.asarray, m) for k, m in masks.items()}
    params_np = jax.tree.map(np.asarray, rparams)
    root = tmp_path_factory.mktemp("tickets")
    meta = {"arch": rcfg.name, "recipe": {"name": "paper"},
            "quantize_bits": None}
    for name, m in masks.items():
        rlottery.export_ticket(str(root / name), params_np, m, meta=meta)

    def reng(params, m=None, slots=4, **kw):
        return RServeEngine(params=params, cfg=rcfg, prefill_fn=rtfm.prefill,
                            decode_fn=rtfm.decode_step, batch_slots=slots,
                            capacity=CAP, masks=m, **kw)

    ra = r_apply_masks(rparams, masks["a"])
    rb = r_apply_masks(rparams, masks["b"])
    ref = {}
    eng = reng(ra, masks["a"])
    ref["a_streams"] = _served(eng, _reqs(RRequest, 4, 8))
    ref["a_skip"] = eng.report.skipped_tile_fraction
    eng = reng(rb, masks["b"])
    ref["b_probe"] = _served(eng, [RRequest(uid=99, prompt=_prompt(1),
                                            max_new_tokens=6)])[99]
    ref["b_skip"] = eng.report.skipped_tile_fraction
    # dense-slot engine, ragged requests over 3 slots, greedy and sampled
    for temp in (0.0, 0.8):
        eng = reng(ra, masks["a"], slots=3, paged=False, temperature=temp,
                   sample_seed=4)
        ref[("dense", temp)] = _served(eng, _ragged(RRequest))
    # the unpruned model's greedy streams (fleet and front-end cases)
    eng = reng(rparams)
    ref["plain"] = {i: eng.smoke_decode(_prompt(i), 12)
                    for i in (0, 1, 2, 3, 4, 5, 9)}
    mgr = RTicketManager(cfg=rcfg, params_template=rparams,
                         prunable=r_lm_prunable, prefill_fn=rtfm.prefill,
                         decode_fn=rtfm.decode_step, probe_tokens=PROBE)
    ref["fingerprints"] = {n: mgr.register(n, str(root / n)).fingerprint
                           for n in masks}
    tparams = _bridge.params_from_numpy(params_np, device="cpu")
    return dict(rcfg=rcfg, tcfg=tcfg, rparams=rparams, masks=masks,
                tparams=tparams, root=root, ref=ref,
                pa=_bridge.apply_masks(tparams, masks["a"]),
                pb=_bridge.apply_masks(tparams, masks["b"]))


def _engine(cp, params=None, masks=None, slots=4, **kw):
    return ServeEngine(params=cp["tparams"] if params is None else params,
                       cfg=cp["tcfg"], batch_slots=slots, capacity=CAP,
                       masks=masks, device="cpu", **kw)


def _manager(cp, **kw):
    return TicketManager(cfg=cp["tcfg"], params_template=cp["tparams"],
                         prunable=lm_prunable, prefill_fn=ttfm.prefill,
                         decode_fn=ttfm.decode_step, probe_tokens=PROBE,
                         device="cpu", **kw)


def _plain(cp, i, n):
    return cp["ref"]["plain"][i][:n]


# ---------------------------------------------------------------------------
# dense-slot decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("valid_len", [None, 11])
def test_decode_step_matches_reference(cp, valid_len):
    """Prefill into a dense cache, then two dense decode steps (per-slot
    index with a masked prefill, a scalar one without)."""
    masks = cp["masks"]["a"]
    from repro.models.plans import build_decode_plan as r_plan
    from repro_torch.models.plans import build_decode_plan as t_plan
    rplan, tplan = r_plan(masks, interpret=True)[0], t_plan(masks)[0]
    rp = r_apply_masks(cp["rparams"], masks)
    toks = np.zeros((1, 16), np.int32)
    toks[0, :11] = np.arange(3, 14)
    kw_r = {} if valid_len is None else {"valid_len": jax.numpy.asarray([11])}
    kw_t = {} if valid_len is None else {"valid_len": torch.tensor([11])}
    _, rc = rtfm.prefill(rp, cp["rcfg"], {"tokens": jax.numpy.asarray(toks)},
                         24, plan=rplan, **kw_r)
    _, tc = ttfm.prefill(cp["pa"], cp["tcfg"],
                         {"tokens": torch.from_numpy(toks).long()}, 24,
                         plan=tplan, **kw_t)
    for tok in (5, 7):
        rl, rc = rtfm.decode_step(rp, cp["rcfg"], rc,
                                  jax.numpy.asarray([[tok]]), plan=rplan)
        with torch.inference_mode():
            tl, tc = ttfm.decode_step(cp["pa"], cp["tcfg"], tc,
                                      torch.tensor([[tok]]), plan=tplan)
        np.testing.assert_allclose(tl.numpy(), np.asarray(rl), rtol=1e-4,
                                   atol=1e-4)
    for a, b in zip(jax.tree.leaves(rc),
                    _bridge.tree_leaves(_bridge.to_numpy(tc))):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_dense_slot_engine_streams_match_reference(cp, temperature):
    eng = _engine(cp, cp["pa"], cp["masks"]["a"], slots=3, paged=False,
                  temperature=temperature, sample_seed=4)
    assert not eng.paged and eng.report.kv_blocks == 0
    assert _served(eng, _ragged(Request)) == cp["ref"][("dense", temperature)]


def test_oversized_request_rejected(cp):
    """Dense slots keep the static capacity limit; paged admission
    stretches it to (kv_blocks - 1) * BLOCK."""
    eng = _engine(cp, paged=False)
    with pytest.raises(SubmitRejected, match="capacity") as e:
        eng.submit(Request(uid=0, prompt=np.arange(CAP - 3, dtype=np.int32),
                           max_new_tokens=4))
    assert e.value.reason == "oversize"
    eng.submit(Request(uid=1, prompt=np.arange(CAP - 4, dtype=np.int32),
                       max_new_tokens=4))
    eng = _engine(cp)
    assert eng.paged and eng.max_context > CAP
    eng.submit(Request(uid=2, prompt=np.arange(CAP - 3, dtype=np.int32),
                       max_new_tokens=4))
    with pytest.raises(SubmitRejected, match="paged KV limit"):
        eng.submit(Request(uid=3, prompt=np.arange(eng.max_context,
                                                   dtype=np.int32) % 100,
                           max_new_tokens=4))


# ---------------------------------------------------------------------------
# admission, streaming, deadlines
# ---------------------------------------------------------------------------
def test_submit_rejections_carry_machine_readable_reasons(cp):
    eng = _engine(cp, queue_limit=1)
    cases = [(Request(uid=0, prompt=np.zeros((0,), np.int32)),
              "empty_prompt"),
             (Request(uid=1, prompt=np.arange(4, dtype=np.int32),
                      max_new_tokens=0), "bad_budget"),
             (Request(uid=2, prompt=np.arange(eng.max_context,
                                              dtype=np.int32) % 64,
                      max_new_tokens=4), "oversize")]
    for req, reason in cases:
        with pytest.raises(SubmitRejected) as e:
            eng.submit(req)
        assert e.value.reason == reason and not e.value.retryable
    eng.submit(Request(uid=3, prompt=_prompt(0), max_new_tokens=2))
    with pytest.raises(SubmitRejected) as e:       # bounded intake queue
        eng.submit(Request(uid=4, prompt=_prompt(0), max_new_tokens=2))
    assert e.value.reason == "capacity" and e.value.retryable
    eng.set_health(False, "wedged decode loop")
    with pytest.raises(SubmitRejected) as e:
        eng.submit(Request(uid=5, prompt=_prompt(0)))
    assert e.value.reason == "unhealthy"
    assert len(eng.queue) == 1


def test_frontend_parks_only_capacity_and_drains_fifo(cp):
    eng = _engine(cp, slots=1, queue_limit=1)
    fe = ServeFrontend(eng, max_queue=3)
    handles = [fe.submit(request=r) for r in _reqs(Request, 4, 3)]
    assert [h.status for h in handles] == \
        ["queued", "waiting", "waiting", "waiting"]
    with pytest.raises(SubmitRejected) as e:
        fe.submit(np.zeros((0,), np.int32))
    assert e.value.reason == "empty_prompt"
    with pytest.raises(SubmitRejected) as e:
        fe.submit(_prompt(0), uid=9)
    assert e.value.reason == "capacity"
    fe.drain()
    assert [r.uid for r in fe.finished] == [0, 1, 2, 3]          # FIFO
    assert {r.uid: r.tokens for r in fe.finished} == \
        {i: _plain(cp, i, 3) for i in range(4)}


def test_stream_handle_yields_each_token_once(cp):
    fe = ServeFrontend(_engine(cp, slots=2))
    seen = []
    h = fe.submit(_prompt(0), max_new_tokens=5, on_token=seen.append)
    streamed = list(h)
    assert streamed == h.request.tokens == seen == _plain(cp, 0, 5)
    assert h.status == "done"


def test_deadline_expiry_frees_slot_and_later_requests_unaffected(cp):
    t = {"now": 0.0}
    eng = _engine(cp, slots=1, clock=lambda: t["now"])
    fe = ServeFrontend(eng)
    doomed = fe.submit(_prompt(0), max_new_tokens=50, deadline_s=5.0)
    fe.pump(2)
    assert doomed.status == "active" and 0 < len(doomed.tokens) < 50
    t["now"] = 10.0                      # past the deadline mid-decode
    fe.pump(1)
    assert doomed.status == "expired" and doomed.request.done
    assert eng.report.deadline_misses == 1
    after = fe.submit(_prompt(1), uid=7, max_new_tokens=4)
    fe.drain()
    assert after.status == "done" and after.tokens == _plain(cp, 1, 4)


def test_deadline_expiry_in_wait_queue_counts_as_miss(cp):
    t = {"now": 0.0}
    eng = _engine(cp, slots=1, queue_limit=1, clock=lambda: t["now"])
    fe = ServeFrontend(eng)
    fe.submit(request=Request(uid=0, prompt=_prompt(0), max_new_tokens=3))
    waiting = fe.submit(_prompt(0), uid=1, max_new_tokens=3, deadline_s=2.0)
    assert waiting.status == "waiting"
    t["now"] = 5.0
    fe.drain()
    assert waiting.status == "expired" and waiting.tokens == []
    assert eng.report.deadline_misses == 1
    assert [r.uid for r in fe.finished if r.status == "done"] == [0]


def test_stale_heartbeat_closes_admission_and_recovers(cp, tmp_path):
    hb = HeartbeatMonitor(str(tmp_path / "hb"), deadline_s=0.05)
    eng = _engine(cp, slots=2, heartbeat=hb)
    fe = ServeFrontend(eng)
    fe.submit(_prompt(0), max_new_tokens=2)
    fe.drain()                            # the engine ticked: a beat
    assert hb.age("engine") is not None
    time.sleep(0.12)                      # the decode loop "wedges"
    with pytest.raises(SubmitRejected) as e:
        fe.submit(_prompt(0), uid=5)
    assert e.value.reason == "unhealthy" and not eng.health.healthy
    eng.step()                            # the loop resumes: a fresh beat
    h = fe.submit(_prompt(0), uid=6, max_new_tokens=3)
    assert eng.health.healthy
    fe.drain()
    assert h.status == "done" and h.tokens == _plain(cp, 0, 3)


# ---------------------------------------------------------------------------
# hot-swap generations
# ---------------------------------------------------------------------------
def test_hot_swap_zero_drain_equivalence(cp):
    """Swap ticket B in with four requests mid-decode: they finish on A
    exactly as the reference's swap-free run, the next admission runs on
    B as the reference's B-only engine, and the plan stats follow."""
    eng = _engine(cp, cp["pa"], cp["masks"]["a"])
    for r in _reqs(Request, 4, 8):
        eng.submit(r)
    for _ in range(3):
        eng.step()
    gid = eng.swap(cp["pb"], masks=cp["masks"]["b"])
    probe = Request(uid=99, prompt=_prompt(1), max_new_tokens=6)
    eng.submit(probe)
    done = {r.uid: r for r in eng.run()}
    for uid, toks in cp["ref"]["a_streams"].items():
        assert done[uid].generation == 0 and done[uid].tokens == toks
    assert probe.generation == gid and probe.tokens == cp["ref"]["b_probe"]
    rep = eng.report
    assert rep.swaps == 1 and rep.skipped_tile_fraction == cp["ref"]["b_skip"]
    assert cp["ref"]["a_skip"] != cp["ref"]["b_skip"]
    assert len(eng.generations) == 1       # generation A drained, retired
    eng.generations[-1].pool.check()


@pytest.mark.parametrize("paged", [True, False])
def test_rollback_restores_previous_generation(cp, paged):
    eng = _engine(cp, cp["pa"], cp["masks"]["a"], paged=paged)
    before = eng.smoke_decode(_prompt(0), 4)
    assert before == cp["ref"]["a_streams"][0][:4]
    gid = eng.swap(cp["pb"], masks=cp["masks"]["b"])
    eng.rollback(gid)
    assert eng.current_generation == 0 and eng.report.swaps == 0
    assert eng.smoke_decode(_prompt(0), 4) == before
    gid = eng.swap(cp["pb"], masks=cp["masks"]["b"])
    eng.submit(Request(uid=0, prompt=_prompt(0), max_new_tokens=2))
    eng.step()
    with pytest.raises(RuntimeError, match="served"):
        eng.rollback(gid)


# ---------------------------------------------------------------------------
# ticket manager
# ---------------------------------------------------------------------------
def test_manager_fingerprints_match_reference_and_swap_verifies(cp):
    mgr = _manager(cp)
    recs = {n: mgr.register(n, str(cp["root"] / n)) for n in ("a", "b")}
    assert {n: r.fingerprint for n, r in recs.items()} == \
        cp["ref"]["fingerprints"]
    assert recs["a"].recipe_name == "paper"
    assert recs["a"].fingerprint != recs["b"].fingerprint
    eng = mgr.make_engine("a", batch_slots=2, capacity=CAP)
    for r in _reqs(Request, 2, 6):
        eng.submit(r)
    eng.step()                            # traffic in flight
    ev = mgr.swap(eng, "b")
    assert ev.accepted and ev.reason == "ok" and mgr.active == "b"
    assert eng.current_generation == ev.gid
    done = {r.uid: r.tokens for r in eng.run()}
    assert done == {u: t[:6] for u, t in cp["ref"]["a_streams"].items()
                    if u < 2}


def test_manager_rejects_arch_recipe_and_shape_mismatch(cp, tmp_path):
    params_np = _bridge.to_numpy(cp["tparams"])
    rlottery.export_ticket(str(tmp_path / "other"), params_np,
                           cp["masks"]["a"],
                           meta={"arch": "some-other-arch",
                                 "recipe": {"name": "paper"}})
    mgr = _manager(cp)
    with pytest.raises(TicketError) as e:
        mgr.register("other", str(tmp_path / "other"))
    assert e.value.reason == "arch_mismatch"
    with pytest.raises(TicketError) as e:
        _manager(cp, expect_recipe="paper-quant").register(
            "a", str(cp["root"] / "a"))
    assert e.value.reason == "recipe_mismatch"
    shutil.copytree(str(cp["root"] / "a"), str(tmp_path / "bad"))
    data = dict(np.load(str(tmp_path / "bad" / "ticket.npz")))
    key = next(k for k in data if k.startswith("m:"))
    data[key] = data[key][..., :-1]
    np.savez_compressed(str(tmp_path / "bad" / "ticket.npz"), **data)
    with pytest.raises(TicketMismatch) as e:
        mgr.register("bad", str(tmp_path / "bad"))
    assert e.value.reason == "shape_mismatch"
    mgr.register("a", str(cp["root"] / "a"))
    eng = mgr.make_engine("a", batch_slots=2, capacity=CAP)
    with pytest.raises(TicketError) as e:
        mgr.swap(eng, "nope")
    assert e.value.reason == "unknown_ticket"


def test_manager_rolls_back_on_fingerprint_mismatch(cp):
    mgr = _manager(cp)
    mgr.register("a", str(cp["root"] / "a"))
    rec_b = mgr.register("b", str(cp["root"] / "b"))
    rec_b.fingerprint = tuple(t + 1 for t in rec_b.fingerprint)   # corrupt
    eng = mgr.make_engine("a", batch_slots=2, capacity=CAP)
    for r in _reqs(Request, 2, 6):
        eng.submit(r)
    eng.step()
    ev = mgr.swap(eng, "b")
    assert not ev.accepted and "rolled back" in ev.reason
    assert ev.observed != ev.expected and mgr.active == "a"
    assert eng.current_generation == 0 and eng.report.swaps == 0
    assert {r.uid: r.tokens for r in eng.run()} == \
        {u: t[:6] for u, t in cp["ref"]["a_streams"].items() if u < 2}


# ---------------------------------------------------------------------------
# fleet
# ---------------------------------------------------------------------------
def _fleet(cp, n=2, slots=2, **kw):
    return [_engine(cp, slots=slots, **kw) for _ in range(n)]


def _check_accounting(router):
    """Every uid finished exactly once; merged totals are the engines'."""
    uids = [r.uid for r in router.finished]
    assert len(uids) == len(set(uids)) == len(router.records)
    rep = router.report
    assert rep.tokens_generated == sum(len(r.tokens)
                                       for r in router.records.values())
    assert rep.deadline_misses == sum(p.deadline_misses
                                      for p in rep.per_engine)


@pytest.mark.parametrize("engines", [1, 2])
def test_fleet_dispatch_matches_reference_streams(cp, engines):
    """Least-loaded dispatch alternates engines; a one-engine fleet, and
    a two-engine one, serve the reference's per-prompt streams."""
    router = FleetRouter(_fleet(cp, engines))
    recs = [router.submit(_prompt(i), uid=i, max_new_tokens=8)
            for i in range(4)]
    assert [r.engine for r in recs] == [i % engines for i in range(4)]
    router.drain()
    assert {r.uid: r.tokens for r in router.finished} == \
        {i: _plain(cp, i, 8) for i in range(4)}
    _check_accounting(router)
    assert router.report.tokens_per_s > 0
    assert 0 < router.dispatch_s < router.step_s


def test_failover_oracle_matches_never_failed_fleet(cp):
    router = FleetRouter(_fleet(cp))
    for i in range(6):
        router.submit(_prompt(i), uid=i, max_new_tokens=8)
    router.pump(3)                        # engine 0 is mid-decode
    moved = router.kill(0)
    assert moved and any(r.tokens for r in moved)
    router.drain()
    assert {r.uid: r.tokens for r in router.finished} == \
        {i: _plain(cp, i, 8) for i in range(6)}
    rep = router.report
    assert rep.failovers == 1 and rep.redispatched == len(moved)
    assert all(r.redispatches == 1 for r in moved) and router.live == {1}
    _check_accounting(router)


def test_heartbeat_failover_and_flap_readmission(cp, tmp_path):
    t = [0.0]
    clock = lambda: t[0]                  # noqa: E731
    monitor = HeartbeatMonitor(root=str(tmp_path / "hb"), deadline_s=5.0,
                               clock=clock)
    router = FleetRouter(_fleet(cp, clock=clock), monitor=monitor)
    for i in range(4):
        router.submit(_prompt(i), uid=i, max_new_tokens=12)
    router.pump(1)                        # both engines beat at t=0
    t[0] = 6.0                            # engine0 wedges; engine1 beats
    monitor.beat("engine1")
    router.pump(1)
    assert router.live == {1} and router.report.failovers == 1
    t[0] = 7.0                            # engine0's beats resume
    monitor.beat("engine0")
    router.pump(1)
    assert router.live == {0, 1}
    rec = router.submit(_prompt(9), uid=9, max_new_tokens=4)
    assert rec.engine == 0
    router.drain()
    assert all(r.status == "done" for r in router.finished)
    want = {i: _plain(cp, i, 12) for i in range(4)}
    want[9] = _plain(cp, 9, 4)
    assert {r.uid: r.tokens for r in router.finished} == want
    _check_accounting(router)


@pytest.mark.parametrize("late_failure", [False, True])
def test_fleet_swap_is_all_or_nothing(cp, monkeypatch, late_failure):
    mgr = _manager(cp)
    mgr.register("a", str(cp["root"] / "a"))
    router = FleetRouter(_fleet(cp))
    if late_failure:
        orig = TicketManager._swap_engine

        def flaky(self, engine, name, rec, engine_idx=None):
            ev = orig(self, engine, name, rec, engine_idx=engine_idx)
            if engine_idx == 1 and ev.accepted:
                engine.rollback(ev.gid)
                return SwapEvent(ticket=name, gid=ev.gid, accepted=False,
                                 reason="injected verification failure",
                                 engine=engine_idx)
            return ev

        monkeypatch.setattr(TicketManager, "_swap_engine", flaky)
    ev = mgr.swap(router, "a")
    assert [e.engine for e in ev.events] == [0, 1]
    if late_failure:
        assert not ev.accepted and ev.rolled_back == 1
        assert "rolled back" in ev.reason and mgr.active is None
    else:
        assert ev.accepted and ev.rolled_back == 0 and mgr.active == "a"
    for fe in router.frontends:           # the fleet never splits
        assert len(fe.engine.generations) == (1 if late_failure else 2)
    for i in range(2):
        router.submit(_prompt(i), uid=i, max_new_tokens=4)
    router.drain()
    want = (_plain(cp, i, 4) if late_failure
            else cp["ref"]["a_streams"][i][:4] for i in range(2))
    assert [r.tokens for r in sorted(router.finished,
                                     key=lambda r: r.uid)] == list(want)
    _check_accounting(router)


# ---------------------------------------------------------------------------
# the command line (python -m repro_torch.api ... --device cpu)
# ---------------------------------------------------------------------------
def _cli(capsys, argv):
    code = cli.main(argv)
    return code, [json.loads(line) for line in
                  capsys.readouterr().out.splitlines() if line.strip()]


def test_cli_archs_and_refusals(capsys):
    code, rows = _cli(capsys, ["archs", "--json"])
    by_arch = {r["arch"]: r for r in rows}
    assert code == 0 and by_arch["llama3.2-3b"]["serves"] is True
    assert by_arch["vgg11"]["serves"] is False
    ds = by_arch["deepseek-v3-671b"]
    assert (ds["adapter"], ds["family"], ds["recipe"], ds["serves"]) == \
        ("LMAdapter", "moe", "moe-full", True)
    assert ds["granularities"] == ["expert", "filter", "channel", "index"]
    code, out = _cli(capsys, ["serve", "--arch", "vgg11", "--device", "cpu",
                              "--json"])
    assert code == cli.EXIT_UNSUPPORTED
    assert out[0]["event"] == "serve_unsupported" and out[0]["family"] == "cnn"


def test_cli_lm_prune_finetune_serve_roundtrip(tmp_path, capsys):
    ticket = str(tmp_path / "lm_ticket")
    common = ["--arch", "llama3.2-3b", "--scale", "tiny", "--device", "cpu",
              "--json"]
    code, events = _cli(capsys, ["prune", *common, "--rounds", "1",
                                 "--tolerance", "1e9", "--steps", "2",
                                 "--ticket", ticket])
    assert code == 0 and events[-1]["event"] == "result"
    assert events[0]["accuracy"] < 0                  # -CE score
    code, out = _cli(capsys, ["finetune", *common, "--ticket", ticket,
                              "--steps", "2"])
    assert code == 0 and out[0]["event"] == "finetune"
    code, out = _cli(capsys, ["serve", *common, "--ticket", ticket,
                              "--requests", "2", "--max-new", "3",
                              "--engines", "2"])
    assert code == 0 and out[0]["event"] == "serve_fleet"
    assert out[0]["requests"] == 2 and out[0]["tokens"] == 6
    assert all(p["bsmm"] for p in out[0]["per_engine"])


def test_cli_ticket_mismatch_reports_not_tracebacks(cp, capsys):
    """A ticket of the 2-layer test config is refused by the CLI's
    4-layer tiny config: a structured event and exit code 2."""
    code, out = _cli(capsys, ["serve", "--arch", "llama3.2-3b",
                              "--device", "cpu", "--ticket",
                              str(cp["root"] / "a"), "--json"])
    assert code == cli.EXIT_UNSUPPORTED
    assert out[0]["event"] == "ticket_mismatch" and "arch" in out[0]["reason"]


def test_cli_daemon_and_swap_match_reference(tmp_path, capsys):
    """serve-daemon (fleet of 2: requests, a kill, a verified swap) and
    swap on the tiny config's tickets give the reference CLI's streams."""
    from repro.api import cli as rcli
    from repro.api.registry import make_adapter as r_make_adapter
    from repro.core import lottery as rl
    ad = r_make_adapter("llama3.2-3b", scale="tiny")
    params = jax.tree.map(np.asarray, ad.init_params(jax.random.PRNGKey(0)))
    for name, schedule in (("a", [("filter", 0.2)]),
                           ("b", [("xbar", 0.4), ("filter", 0.3)])):
        m = structured_prune(params, schedule, prunable=r_lm_prunable,
                             cfg=PruneConfig())
        rl.export_ticket(str(tmp_path / name), params,
                         jax.tree.map(np.asarray, m),
                         meta={"arch": ad.cfg.name})
    ops = [{"op": "request", "uid": i, "prompt": _prompt(i).tolist(),
            "max_new_tokens": 6} for i in range(4)]
    ops += [{"op": "pump", "steps": 2}, {"op": "kill", "engine": 0},
            {"op": "swap", "name": "b", "ticket": str(tmp_path / "b")},
            {"op": "request", "uid": 7, "prompt": _prompt(7).tolist(),
             "max_new_tokens": 4}, {"op": "drain"}, {"op": "shutdown"}]
    script = tmp_path / "ops.jsonl"
    script.write_text("\n".join(json.dumps(o) for o in ops))
    argv = ["serve-daemon", "--arch", "llama3.2-3b", "--ticket",
            str(tmp_path / "a"), "--engines", "2", "--slots", "2",
            "--script", str(script), "--json"]

    def done(events):
        return {e["uid"]: (e["tokens"], e["generation"]) for e in events
                if e["event"] == "done"}

    code, got = _cli(capsys, argv + ["--device", "cpu"])
    assert code == 0
    assert rcli.main(argv) == 0
    want = [json.loads(line) for line in
            capsys.readouterr().out.splitlines() if line.strip()]
    assert done(got) == done(want) and len(done(got)) == 5
    swap = [e for e in got if e["event"] == "swap"][0]
    assert swap["accepted"] and swap["engines"] == 1
    code, out = _cli(capsys, ["swap", "--arch", "llama3.2-3b", "--ticket",
                              str(tmp_path / "a"), "--candidate",
                              str(tmp_path / "b"), "--device", "cpu",
                              "--json"])
    assert code == 0 and out[0]["accepted"] and out[0]["in_flight_match"]
    assert out[0]["probe_generation"] == 1
