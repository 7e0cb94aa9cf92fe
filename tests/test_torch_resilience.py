"""The port's fault injection (``repro_torch.resilience``) against the
reference's (``repro.resilience``) on the CPU, exactly: seeded chaos
schedules, and a ``FaultInjector`` run of ``gpt2-moe-smoke`` through both
engines under ``simulate`` (the same fired events, shed / reject ledger,
dead devices, penalty log and tokens); then the always-on rungs on the
port alone: a planner crash falls back and keeps serving, corrupted
telemetry is rejected, and device failures mask the routing.
"""
import dataclasses

import numpy as np
import pytest

import repro.resilience as jres
from repro.runtime.engine import EngineConfig as JEngineConfig
from repro.runtime.engine import ServingEngine as JServingEngine
from repro.runtime.engine import simulate as j_simulate
from repro_torch import resilience as res
from repro_torch.runtime.engine import (EngineConfig, ServingEngine,
                                        simulate, summarize_results)
from repro_torch.runtime.server import LayerStats
from repro_torch.sched import AdaptiveScheduler, ControllerConfig
from repro_torch.sched.telemetry import TelemetryBus

from _torch_pair import server_pair, tokens_of


def as_tuples(schedule):
    return [dataclasses.astuple(f) for f in schedule.faults]


@pytest.mark.parametrize("seed", [0, 11, 12])
def test_chaos_schedule_equals_the_references(seed):
    kw = dict(seed=seed, n_steps=50, n_devices=8, n_layers=4, n_faults=6)
    got, want = res.chaos_schedule(**kw), jres.chaos_schedule(**kw)
    assert as_tuples(got) == as_tuples(want)
    assert got == res.chaos_schedule(**kw)
    assert res.FAULT_KINDS == jres.FAULT_KINDS
    f = res.Fault("straggler", step=5, duration=3, device=2)
    assert [f.active_at(s) for s in range(3, 10)] == \
        [jres.Fault("straggler", step=5, duration=3,
                    device=2).active_at(s) for s in range(3, 10)]


def schedule(pkg):
    return pkg.FaultSchedule([
        pkg.Fault("device_failure", 2, duration=-1, device=1),
        pkg.Fault("overload", 3, n_requests=8),
        pkg.Fault("telemetry", 4, duration=2),
        pkg.Fault("planner_crash", 5, duration=1),
        pkg.Fault("straggler", 6, duration=2, device=2, magnitude=3.0)])


def chaos_run(pkg, srv, eng_cls, ecfg_cls, sim, vocab, scheduler=None):
    inj = pkg.FaultInjector(schedule(pkg), resilience=True, rng_seed=5,
                            vocab_size=vocab, burst_seq_len=8)
    eng = eng_cls(srv, ecfg_cls(max_batch_tokens=64, max_queue=4,
                                deadline_s=0.5),
                  scheduler=scheduler,
                  service_model=lambda stats, n: 1e-3 * n,
                  fault_injector=inj)
    rng = np.random.RandomState(9)
    trace = [(rng.randint(0, vocab, (10,)), 0.02 * i) for i in range(6)]
    results = sim(eng, trace, time_scale=0.0, max_new_tokens=4,
                  retry_backoff_s=0.01)
    return eng, inj, results


@pytest.mark.parametrize("autoscale", [False, True])
def test_fault_injector_run_equals_the_references(autoscale):
    """Every fault kind on both engines (with and without the autoscaler):
    the same fired events and steps, shed / reject ledger, dead devices,
    penalty log, virtual completion times and tokens."""
    cfg, jsrv, srv = server_pair(capacity_factor=16.0)
    jsch = sch = None
    if autoscale:
        import repro.sched as jsched
        ccfg = dict(interval=1, min_observations=1)
        jsch = jsched.AdaptiveScheduler(jsrv, jsched.ControllerConfig(**ccfg))
        sch = AdaptiveScheduler(srv, ControllerConfig(**ccfg))
    jeng, jinj, want = chaos_run(jres, jsrv, JServingEngine, JEngineConfig,
                                 j_simulate, cfg.vocab_size, jsch)
    eng, inj, got = chaos_run(res, srv, ServingEngine, EngineConfig,
                              simulate, cfg.vocab_size, sch)
    assert tokens_of(got) == tokens_of(want)
    assert [(r.rid, r.completion) for r in got] == \
        [(r.rid, r.completion) for r in want]
    assert [dataclasses.astuple(s) for s in eng.shed_records] == \
        [dataclasses.astuple(s) for s in jeng.shed_records]
    assert inj.report() == jinj.report()
    assert inj.penalty_log == jinj.penalty_log
    assert inj.events == {"device_failure": 1, "overload": 1,
                          "telemetry": 1, "planner_crash": 1,
                          "straggler": 1}
    assert srv.dead_devices == jsrv.dead_devices == {1}
    assert srv.degrade_stats == jsrv.degrade_stats
    if autoscale:
        assert sch.bus.errors == jsch.bus.errors
        assert sch.report()["swaps"] == jsch.report()["swaps"]
    m = summarize_results(got, engine=eng)
    offered = 6 + inj.injected
    assert offered == len(got) + m["shed_deadline"] + m["shed_rejected"]


def test_planner_crash_falls_back_and_keeps_serving():
    cfg, _, srv = server_pair()

    def hook(what, layer):
        raise res.PlannerCrash(f"injected ({what}, {layer})")

    srv.fault_hook = hook
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 16))
    logits, stats = srv.serve_batch(toks)[:2]
    assert np.isfinite(np.asarray(logits)).all()
    assert len(stats) == cfg.n_moe_layers
    assert srv.degrade_stats["planner_errors"] == cfg.n_moe_layers


def test_telemetry_bus_rejects_corrupted_stats():
    def stat(pop):
        return LayerStats(layer=0, est_pop=pop, actual_pop=pop,
                          finetuned=False, est_accurate=True,
                          plan_reused=False, device_load=np.ones(4) / 4,
                          n_tokens=8)
    bus = TelemetryBus()
    bus.observe_step([stat(np.array([.4, .3, .2, .1]))], n_tokens=8)
    bus.observe_step([stat(np.array([np.nan, .3, .2, .1]))], n_tokens=8)
    bus.observe_step([stat(np.array([-.5, .3, .2, .1]))], n_tokens=8)
    assert bus.errors == {"telemetry_rejected": 2}
    assert np.isfinite(bus.popularity(0)).all()


def test_failed_device_gets_no_load_and_revives():
    """After ``fail_devices({1})`` no realized load lands on device 1, in
    the port as in the reference; ``revive_devices`` returns it to the
    pool (plans re-expand onto it at the next re-plan), and both servers
    realize the same per-device loads through the whole sequence."""
    cfg, jsrv, srv = server_pair(capacity_factor=16.0)
    rng = np.random.RandomState(3)
    batches = [rng.randint(0, cfg.vocab_size, (4, 16)) for _ in range(3)]
    loads = []
    for server in (jsrv, srv):
        run = [server.serve_batch(batches[0])[1]]
        server.fail_devices({1})
        run.append(server.serve_batch(batches[1])[1])
        assert all(float(np.asarray(s.device_load)[1]) == 0.0
                   for s in run[-1])
        server.revive_devices({1})
        assert server.dead_devices == set()
        run.append(server.serve_batch(batches[2])[1])
        loads.append([np.asarray(s.device_load) for st in run for s in st])
    for got, want in zip(loads[1], loads[0]):
        np.testing.assert_allclose(got, want, atol=1e-6)
