"""Serving driver of the port: profile expert-selection paths, then serve a
request trace through the continuous-batching engine with Lina's
two-phase popularity scheduling, on one card or an expert-parallel mesh.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-moe \\
        --requests 8 --seq 64 --max-new-tokens 8 [--device cuda|cpu] \\
        [--workload drift] [--autoscale] [--mesh DxE] [--n-microops 4] \\
        [--pipeline-ffn] [--trace-dir D] [--profile-steps N]

Flags follow ``repro.launch.serve``.  ``--workload`` picks a
``repro_torch.sched.workloads`` scenario (drifting Zipf topic mixture,
flash crowd, diurnal tide, ...) instead of the stationary Poisson trace;
``--autoscale`` attaches the telemetry-driven controller
(``repro_torch.sched``), so per-layer placement adapts to the traffic
between micro-batches.  ``--profile-steps N`` captures engine steps 2 ..
N + 1 with ``torch.profiler`` (``obs.StepProfiler``; its Chrome trace goes
under ``--trace-dir`` when given) and prints the device time by kernel.
``--device`` defaults to ``cuda`` and raises without a card; ``--device
cpu`` runs the kernels' plain versions.

``--mesh DxE`` serves on D x E ranks (``launch.mesh``: data x model, the
experts split over E), as ``launch.train`` does: under ``torchrun`` each
process joins the job's group; otherwise, for D * E > 1, it spawns
D * E local ranks (gloo with ``--device cpu``, NCCL with one GPU a rank,
raising when the machine has too few GPUs), and at ``1x1`` it runs
in-process on a one-rank group.  ``--mesh DxExT`` adds a `tp` axis: the
server reads whole experts (the reference's ``P(EP_AXIS, None, None)``),
so its T ranks of a `model` index serve the same rows.  Every rank serves
the same trace (``runtime.engine``); rank 0 prints.

``--n-microops`` and ``--pipeline-ffn`` only keep the reference's command
lines working: they reach the ``lina=False`` profiling forward alone, as there.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.devices import resolve_device
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import lm as lm_mod
from repro_torch.obs import ObsContext, StepProfiler
from repro_torch.runtime.engine import (EngineConfig, ServingEngine, simulate,
                                        summarize_results)
from repro_torch.runtime.server import (MoEServer, ServerConfig,
                                        profile_from_training)
from repro_torch.sched import (SCENARIOS, AdaptiveScheduler,
                               ControllerConfig, get_trace)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--requests", type=int, default=20,
                    help="number of requests in the Poisson trace")
    ap.add_argument("--rate", type=float, default=20.0,
                    help="mean arrival rate (requests per virtual second)")
    ap.add_argument("--profile-batches", type=int, default=5)
    ap.add_argument("--batch-tokens", type=int, default=256,
                    help="engine micro-batch token budget")
    ap.add_argument("--batch-requests", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--max-new-tokens", type=int, default=8,
                    help="tokens to generate per request via incremental "
                         "decode (0 = score-only prefill)")
    ap.add_argument("--path-len", type=int, default=3)
    ap.add_argument("--policy", default="lina", choices=["lina", "uniform"])
    ap.add_argument("--compute-backend", default=None,
                    choices=["auto", "xla", "pallas"],
                    help="MoE compute backend: 'auto'/'pallas' = the CUDA "
                         "kernels (plain versions for CPU tensors), 'xla' = "
                         "the plain tensor path; default keeps the arch "
                         "config")
    ap.add_argument("--no-plan-cache", action="store_true",
                    help="ablation: re-plan every layer of every batch")
    ap.add_argument("--shortcut", dest="shortcut", default=None,
                    action="store_true",
                    help="allocate the dense shortcut (ScMoE) branch and add "
                         "it beside every MoE layer")
    ap.add_argument("--no-shortcut", dest="shortcut", action="store_false")
    ap.add_argument("--n-microops", type=int, default=None,
                    help="kept for the reference's command lines (see the "
                         "module doc)")
    ap.add_argument("--pipeline-ffn", dest="pipeline_ffn", default=None,
                    action="store_true",
                    help="kept for the reference's command lines")
    ap.add_argument("--no-pipeline-ffn", dest="pipeline_ffn",
                    action="store_false")
    ap.add_argument("--workload", default=None, choices=sorted(SCENARIOS),
                    help="trace scenario (repro_torch.sched.workloads); "
                         "default is a stationary Poisson trace")
    ap.add_argument("--autoscale", action="store_true",
                    help="attach the telemetry-driven autoscaling "
                         "controller (repro_torch.sched): per-layer plans "
                         "adapt to traffic between micro-batches")
    ap.add_argument("--autoscale-interval", type=int, default=4,
                    help="engine steps between controller evaluations")
    ap.add_argument("--hysteresis", type=float, default=0.1,
                    help="min relative transfer-balance improvement "
                         "before the controller swaps a live plan")
    ap.add_argument("--headroom", type=float, default=0.2,
                    help="drift-rate -> replica-hedge gain")
    ap.add_argument("--profile-steps", type=int, default=0,
                    help="capture engine steps 2 .. N + 1 with "
                         "torch.profiler and print device time by kernel")
    ap.add_argument("--mesh", default=None,
                    help="data x model (x tp) mesh DxE or DxExT, e.g. 2x2 "
                         "(see the module "
                         "doc)")
    ap.add_argument("--warmup", action="store_true",
                    help="build and launch every kernel before serving")
    ap.add_argument("--trace-dir", default=None,
                    help="enable span tracing and export trace.json, "
                         "spans.json, metrics.prom/.json here")
    ap.add_argument("--metrics-out", default=None,
                    help="write a Prometheus-text metrics snapshot here")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def run(argv=None) -> dict:
    """Profile, build the server and engine, replay the trace.  Returns
    {"summary", "engine", "results", "obs", "args", "mesh", "scheduler",
    "profiler"}."""
    args = parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(args.arch)
    if not cfg.moe.enabled:
        raise ValueError("the serve driver targets MoE archs")
    moe_over = {k: v for k, v in (
        ("compute_backend", args.compute_backend),
        ("n_microops", args.n_microops),
        ("pipeline_ffn", args.pipeline_ffn),
        ("shortcut", args.shortcut)) if v is not None}
    if moe_over:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **moe_over))
    mesh = None
    if args.mesh:
        mesh = mesh_mod.make_mesh(mesh_mod.parse_mesh(args.mesh),
                                  device=args.device)
        dev = mesh.device
    else:
        dev = resolve_device(args.device)
    lead = mesh is None or mesh.rank == 0

    def say(msg):
        if lead:
            print(msg, flush=True)
    say(f"moe knobs: n_microops={cfg.moe.n_microops} "
        f"pipeline_ffn={cfg.moe.pipeline_ffn} shortcut={cfg.moe.shortcut} "
        f"compute_backend={cfg.moe.compute_backend} device={dev}"
        + (f" mesh={args.mesh}" if mesh is not None else ""))
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params = lm_mod.init_params(cfg, gen, device=dev)
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                global_batch=4, seed=args.seed))

    say("profiling expert-selection paths ...")
    prof = profile_from_training(
        cfg, params, (ds.batch(i) for i in range(args.profile_batches)),
        path_len=args.path_len, device=dev, mesh=mesh)

    obs = ObsContext.enabled() if args.trace_dir else ObsContext.disabled()
    server = MoEServer(cfg, params, prof,
                       ServerConfig(path_len=args.path_len,
                                    schedule_policy=args.policy,
                                    plan_cache=not args.no_plan_cache),
                       obs=obs, device=dev, mesh=mesh)
    del params
    scheduler = None
    if args.autoscale:
        scheduler = AdaptiveScheduler(
            server, ControllerConfig(interval=args.autoscale_interval,
                                     hysteresis=args.hysteresis,
                                     headroom=args.headroom))
    engine = ServingEngine(server,
                           EngineConfig(max_batch_tokens=args.batch_tokens,
                                        max_batch_requests=args.batch_requests),
                           scheduler=scheduler)
    if args.warmup:
        say("warming up (building and launching every kernel) ...")
        n = engine.warmup(seqs=(args.seq,),
                          max_new_tokens=args.max_new_tokens)
        say(f"warm-up ran {n} calls")

    if args.workload is not None:
        trace = get_trace(args.workload, cfg.vocab_size,
                          n_requests=args.requests, seq=args.seq,
                          rate_hz=args.rate, seed=1000 + args.seed)
        shape = args.workload
    else:
        rng = np.random.RandomState(1000 + args.seed)
        t, trace = 0.0, []
        for _ in range(args.requests):
            t += rng.exponential(1.0 / args.rate)
            trace.append((rng.randint(0, cfg.vocab_size, (args.seq,)), t))
        shape = "stationary-poisson"
    profiler = None
    if args.profile_steps:
        profiler = StepProfiler(args.trace_dir, start=2,
                                steps=args.profile_steps)
        step = engine.step

        def profiled_step(*a, **kw):
            profiler.on_step(engine.step_idx + 1)
            return step(*a, **kw)
        engine.step = profiled_step
    say(f"serving {args.requests} requests ({shape}, rate {args.rate}/s, "
        f"{args.max_new_tokens} new tokens each) ...")
    with torch.inference_mode():
        results = simulate(engine, trace, max_new_tokens=args.max_new_tokens)
    if profiler is not None:
        profiler.close()
    return {"summary": summarize_results(results), "engine": engine,
            "results": results, "obs": obs, "args": args, "mesh": mesh,
            "scheduler": scheduler, "profiler": profiler}


def main(argv=None, _child: bool = False):
    args = parse_args(argv)
    if mesh_mod.spawn_ranks(main, argv, args.mesh, args.device, _child):
        return 0
    out = run(argv)
    m, engine, args, obs = out["summary"], out["engine"], out["args"], \
        out["obs"]
    if out["mesh"] is not None and out["mesh"].rank != 0:
        return 0
    stats = engine.layer_stats
    loads = np.stack([s.device_load for s in stats])
    print(f"policy={args.policy}  completed {m['n']} requests")
    print(f"latency p50 {m['latency_p50']*1e3:.1f} ms  "
          f"p95 {m['latency_p95']*1e3:.1f} ms")
    if args.max_new_tokens:
        print(f"TTFT p50 {m['ttft_p50']*1e3:.1f} ms  "
              f"p95 {m['ttft_p95']*1e3:.1f} ms")
        print(f"TPOT p50 {m['tpot_p50']*1e3:.1f} ms  "
              f"p95 {m['tpot_p95']*1e3:.1f} ms  "
              f"({m['gen_tok_s']:.1f} gen tok/s)")
    print(f"plan reuse {engine.plan_reuse_rate:.1%}  "
          f"fine-tune rate {engine.finetune_rate:.1%}  "
          f"estimation accuracy "
          f"{np.mean([s.est_accurate for s in stats]):.1%}")
    print(f"device load imbalance (max/mean): "
          f"{(loads.max(1) / np.maximum(loads.mean(1), 1e-9)).mean():.2f}x")
    scheduler = out["scheduler"]
    if scheduler is not None:
        rep = scheduler.report()
        print(f"autoscaler: {rep['swaps']} swaps (+{rep['bootstraps']} "
              f"bootstraps) over {rep['steps']} steps "
              f"({rep['churn_per_100_steps']:.1f} swaps/100 steps), "
              f"{scheduler.controller.migrated_slots} expert stacks moved")
    if out["profiler"] is not None:
        times = out["profiler"].kernel_times()
        print(f"profiled engine steps 2-{1 + args.profile_steps}: device "
              f"time by kernel (us): " + (", ".join(
                  f"{k} {v:.1f}" for k, v in list(times.items())[:12])
                  or "no device activity (no card)"))
    if args.trace_dir:
        paths = obs.export(args.trace_dir)
        print(f"trace artifacts: {paths['trace']} (open in "
              f"ui.perfetto.dev), {paths['spans']}, {paths['prom']}")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            f.write(obs.metrics.to_prometheus())
        print(f"metrics snapshot: {args.metrics_out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
