"""The port's serving control loop (``repro_torch.sched``) against the
reference's (``repro.sched``) on the CPU, exactly: seeded traces bit for
bit, replica targets, the telemetry bus's EWMAs and drift on one stream of
``LayerStats``, the controller's swap sequence and plans, and an
``AdaptiveScheduler`` run of ``gpt2-moe-smoke`` through both engines under
``simulate`` (same swaps, same tokens), plus the reference's plan swap in
the middle of decoding, through the port's engine.

Everything compared here is host-side numpy fed the same numbers, so it
is held exactly; the served tokens come from float32 models on the same
converted weights, whose argmax agrees.
"""
import dataclasses

import numpy as np
import pytest

import repro.sched as jsched
from repro.runtime.engine import EngineConfig as JEngineConfig
from repro.runtime.engine import ServingEngine as JServingEngine
from repro.runtime.engine import simulate as j_simulate
from repro.runtime.server import LayerStats as JLayerStats
from repro_torch import sched
from repro_torch.runtime.engine import (EngineConfig, ServingEngine,
                                        simulate)
from repro_torch.runtime.server import LayerStats

from _torch_pair import plan_arrays, server_pair, tokens_of

KINDS = ("stationary", "drifting_zipf", "flash_crowd", "diurnal")


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("kind", KINDS)
def test_traces_equal_the_references_bit_for_bit(kind, seed):
    spec = dict(kind=kind, n_requests=40, seq=12, seed=seed)
    want = jsched.generate_trace(jsched.TraceSpec(**spec), 256)
    got = sched.generate_trace(sched.TraceSpec(**spec), 256)
    assert len(got) == len(want) == 40
    for (gt, ga), (wt, wa) in zip(got, want):
        assert gt.dtype == wt.dtype and np.array_equal(gt, wt)
        assert ga == wa


def test_named_scenarios_equal_the_references():
    assert sched.SCENARIOS == {k: sched.TraceSpec(**vars(v))
                               for k, v in jsched.SCENARIOS.items()}
    for name in jsched.SCENARIOS:
        want = jsched.get_trace(name, 128, n_requests=12, seed=3)
        got = sched.get_trace(name, 128, n_requests=12, seed=3)
        assert all(np.array_equal(g[0], w[0]) and g[1] == w[1]
                   for g, w in zip(got, want))
    with pytest.raises(ValueError, match="unknown workload kind"):
        sched.TraceSpec(kind="nope")


@pytest.mark.parametrize("case", range(6))
def test_replica_targets_equal_the_references(case):
    rng = np.random.RandomState(case)
    e = (4, 8, 16)[case % 3]
    pop = rng.dirichlet(np.full(e, 0.3))
    kw = dict(n_devices=e, drift_rate=float(rng.rand()),
              headroom=(0.2, 1.0)[case % 2], budget=e * (2 + case % 3),
              fill=(1.0, 0.7)[case % 2], floor=case % 3)
    got = sched.replica_targets(pop, **kw)
    want = jsched.replica_targets(pop, **kw)
    assert got.tolist() == want.tolist()


def stat_stream(n_steps=40, e=8, n_dev=4, seed=5):
    """(reference stats, port stats) per step: a drifting popularity with
    tiny decode batches mixed in and a NaN snapshot (rejected by both)."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n_steps):
        pop = rng.dirichlet(np.full(e, 0.5)) * (1 + (i > 20) * np.arange(e))
        toks = int(rng.choice([2, 64, 200]))
        if i == 13:
            pop = pop.copy()
            pop[2] = np.nan
        load = rng.rand(n_dev)
        rep = rng.rand(2 * n_dev)
        fields = dict(layer=i % 2, est_pop=pop, actual_pop=pop,
                      finetuned=bool(i % 3 == 0), est_accurate=True,
                      plan_reused=bool(i % 4 == 0), device_load=load,
                      n_tokens=toks, replica_load=rep)
        out.append(([JLayerStats(**fields)], [LayerStats(**fields)], toks))
    return out


def test_bus_ewmas_and_drift_equal_the_references():
    cfg = dict(alpha=0.3, top_k=2, bytes_per_token=128.0)
    jbus = jsched.TelemetryBus(jsched.TelemetryConfig(**cfg))
    bus = sched.TelemetryBus(sched.TelemetryConfig(**cfg))
    for jst, st, toks in stat_stream():
        jbus.observe_step(jst, toks)
        bus.observe_step(st, toks)
    assert bus.errors == jbus.errors == {"telemetry_rejected": 1}
    assert bus.snapshot() == jbus.snapshot()
    for li in (0, 1):
        np.testing.assert_array_equal(bus.popularity(li),
                                      jbus.popularity(li))
        np.testing.assert_array_equal(bus.popularity_envelope(li, 1.5),
                                      jbus.popularity_envelope(li, 1.5))
        assert bus.drift_rate(li) == jbus.drift_rate(li)


def test_controller_swaps_and_plans_equal_the_references():
    """A drifting trace's token histogram as each step's popularity: the
    same evaluations, swaps (at the same steps), migrations and plans."""
    def run(pkg, stats_cls):
        spec = pkg.TraceSpec(kind="drifting_zipf", n_requests=40, seq=16,
                             seed=9, drift_period=0.5)
        ctl = pkg.AutoscaleController(4, max_pack=2, cfg=pkg.ControllerConfig(
            interval=2, min_observations=1, hysteresis=0.02,
            migration_weight=0.01))
        bus = pkg.TelemetryBus(pkg.TelemetryConfig(alpha=0.4))
        events, plans = [], []
        for i, (tokens, _) in enumerate(pkg.generate_trace(spec, 64), 1):
            pop = np.bincount(tokens % 4, minlength=4).astype(np.float64)
            pop /= pop.sum()
            bus.observe_step([stats_cls(0, pop, pop, False, True, False,
                                        device_load=pop, n_tokens=16)], 16)
            changed = ctl.step(bus, i)
            if changed:
                events.append((i, ctl.swaps, ctl.bootstraps,
                               ctl.pop_migration()))
                plans.append(plan_arrays(changed[0]))
        return events, plans, ctl.evaluations, ctl.churn_per_100_steps
    got = run(sched, LayerStats)
    want = run(jsched, JLayerStats)
    assert got == want
    assert got[0][-1][1] > 0                     # it did swap


def test_autoscaled_simulate_equals_the_references():
    """``AdaptiveScheduler`` (interval 1, no hysteresis) on both engines
    over the same drifting trace: the same swaps and bootstraps, the same
    published plans and the same generated tokens."""
    cfg, jsrv, srv = server_pair(capacity_factor=16.0)
    ccfg = dict(interval=1, min_swap_interval=1, min_observations=1,
                hysteresis=0.0, migration_weight=0.0)
    jsch = jsched.AdaptiveScheduler(jsrv, jsched.ControllerConfig(**ccfg))
    sch = sched.AdaptiveScheduler(srv, sched.ControllerConfig(**ccfg))
    ecfg = dict(max_batch_tokens=64, max_batch_requests=4)
    jeng = JServingEngine(jsrv, JEngineConfig(**ecfg), scheduler=jsch)
    eng = ServingEngine(srv, EngineConfig(**ecfg), scheduler=sch)
    tr = sched.get_trace("drift_fast", cfg.vocab_size, n_requests=8, seq=10,
                         seed=4)
    want = j_simulate(jeng, tr, time_scale=0.0, max_new_tokens=4)
    got = simulate(eng, tr, time_scale=0.0, max_new_tokens=4)
    assert tokens_of(got) == tokens_of(want)
    rep, jrep = sch.report(), jsch.report()
    for key in ("steps", "swaps", "bootstraps", "evaluations"):
        assert rep[key] == jrep[key], key
    assert rep["bootstraps"] == cfg.n_moe_layers
    assert sorted(srv._plan_override) == sorted(jsrv._plan_override)
    for li, plan in srv._plan_override.items():
        assert plan_arrays(plan) == plan_arrays(jsrv._plan_override[li])
    assert sch.controller.migrated_slots == jsch.controller.migrated_slots


def test_plan_swap_mid_decode_is_transparent():
    """The reference's ``test_engine_plan_swap_mid_decode_is_transparent``
    through the port's engine: controller swaps between micro-batches
    while requests decode leave every generated token as the static run
    makes it (plans move experts, not math), and the overridden layers
    skip the phase-2 fine-tune."""
    cfg, _, ref_srv = server_pair(capacity_factor=16.0)
    rng = np.random.RandomState(31)
    prompts = [rng.randint(0, cfg.vocab_size, (10,)) for _ in range(3)]
    ref_eng = ServingEngine(ref_srv, EngineConfig(max_batch_tokens=64))
    for p in prompts:
        ref_eng.submit(p, arrival=0.0, max_new_tokens=6)
    ref = tokens_of(ref_eng.run())

    _, _, srv = server_pair(capacity_factor=16.0)
    sch = sched.AdaptiveScheduler(srv, sched.ControllerConfig(
        interval=1, min_swap_interval=1, min_observations=1,
        hysteresis=0.0, migration_weight=0.0))
    eng = ServingEngine(srv, EngineConfig(max_batch_tokens=64),
                        scheduler=sch)
    for p in prompts:
        eng.submit(p, arrival=0.0, max_new_tokens=6)
    results, swapped_mid_decode = [], False
    while eng.has_work():
        before = sch.controller.swaps + sch.controller.bootstraps
        results.extend(eng.step(now=0.0))
        if eng.active() and \
                sch.controller.swaps + sch.controller.bootstraps > before:
            swapped_mid_decode = True
    assert swapped_mid_decode and srv._plan_override
    assert tokens_of(results) == ref
    post = list(eng.layer_stats)[-4 * cfg.n_moe_layers:]
    assert not any(s.finetuned for s in post)


def test_scheduler_models_the_bytes_of_a_bf16_server():
    """The bus's modeled a2a bytes a token are d_model times the compute
    dtype's size: 2 for a bf16 config (numpy has no bfloat16 dtype to
    ask, which the full-size configs use)."""
    import dataclasses
    cfg, _, srv = server_pair()
    assert cfg.dtype == "float32"
    sch = sched.AdaptiveScheduler(srv)
    assert sch.bus.cfg.bytes_per_token == 4.0 * cfg.d_model
    srv.cfg = dataclasses.replace(cfg, dtype="bfloat16")
    sch = sched.AdaptiveScheduler(srv)
    assert sch.bus.cfg.bytes_per_token == 2.0 * cfg.d_model
    assert sch.bus.cfg.top_k == srv.scfg.top_k
