"""Serving driver of the port: profile expert-selection paths, then serve a
Poisson request trace through the continuous-batching engine with Lina's
two-phase popularity scheduling, on one card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-moe \\
        --requests 8 --seq 64 --max-new-tokens 8 [--device cuda|cpu]

Flags follow ``repro.launch.serve``, less those of code not ported yet:
``--workload`` and ``--autoscale`` (the reference's ``sched/`` package) and
``--n-microops`` / ``--pipeline-ffn`` (the all-to-all micro-op pipeline of
``core/microop``, which has nothing to overlap at expert parallelism 1).  ``--device``
defaults to ``cuda`` and raises without a card; ``--device cpu`` runs the
kernels' plain versions.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.devices import resolve_device
from repro_torch.models import lm as lm_mod
from repro_torch.obs import ObsContext
from repro_torch.runtime.engine import (EngineConfig, ServingEngine, simulate,
                                        summarize_results)
from repro_torch.runtime.server import (MoEServer, ServerConfig,
                                        profile_from_training)


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
    {"summary", "engine", "results", "obs", "args"}."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(args.arch)
    if not cfg.moe.enabled:
        raise ValueError("the serve driver targets MoE archs")
    moe_over = {k: v for k, v in (
        ("compute_backend", args.compute_backend),
        ("shortcut", args.shortcut)) if v is not None}
    if moe_over:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **moe_over))
    print(f"moe knobs: shortcut={cfg.moe.shortcut} "
          f"compute_backend={cfg.moe.compute_backend} device={dev}",
          flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params = lm_mod.init_params(cfg, gen, device=dev)
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                global_batch=4, seed=args.seed))

    print("profiling expert-selection paths ...", flush=True)
    prof = profile_from_training(
        cfg, params, (ds.batch(i) for i in range(args.profile_batches)),
        path_len=args.path_len, device=dev)

    obs = ObsContext.enabled() if args.trace_dir else ObsContext.disabled()
    server = MoEServer(cfg, params, prof,
                       ServerConfig(path_len=args.path_len,
                                    schedule_policy=args.policy,
                                    plan_cache=not args.no_plan_cache),
                       obs=obs, device=dev)
    engine = ServingEngine(server,
                           EngineConfig(max_batch_tokens=args.batch_tokens,
                                        max_batch_requests=args.batch_requests))
    if args.warmup:
        print("warming up (building and launching every kernel) ...",
              flush=True)
        n = engine.warmup(seqs=(args.seq,),
                          max_new_tokens=args.max_new_tokens)
        print(f"warm-up ran {n} calls", flush=True)

    rng = np.random.RandomState(1000 + args.seed)
    t, trace = 0.0, []
    for _ in range(args.requests):
        t += rng.exponential(1.0 / args.rate)
        trace.append((rng.randint(0, cfg.vocab_size, (args.seq,)), t))
    print(f"serving {args.requests} requests (stationary-poisson, rate "
          f"{args.rate}/s, {args.max_new_tokens} new tokens each) ...",
          flush=True)
    with torch.inference_mode():
        results = simulate(engine, trace, max_new_tokens=args.max_new_tokens)
    return {"summary": summarize_results(results), "engine": engine,
            "results": results, "obs": obs, "args": args}


def main(argv=None):
    out = run(argv)
    m, engine, args, obs = out["summary"], out["engine"], out["args"], \
        out["obs"]
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
