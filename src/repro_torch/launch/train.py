"""Training driver of the port, on one card or an expert-parallel mesh.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-moe \\
        [--steps 50 --batch 8 --seq 1024] [--device cuda|cpu] \\
        [--mesh DxE | DxExT] [--schedule priority+partition+pipeline] \\
        [--grad-compression bf16|int8_ef] [--n-microops 4] [--no-lina] \\
        [--profile-dir D]

Flags follow ``repro.launch.train``.  ``--device`` defaults to ``cuda`` and
raises without a card; ``--device cpu`` runs the kernels' plain versions.
``--dispatch-backend`` defaults to ``pallas`` (the dispatch / combine
kernels), so with the arch's ``compute_backend`` "auto" every MoE op runs
its kernel.

``--mesh DxE`` trains on D x E ranks (``launch.mesh``: data x model),
every leaf stored as the reference's specs place it (``launch.sharding``:
FSDP over `data`, tensor parallel and the experts over `model`);
``--mesh DxExT`` adds the `tp` axis (the experts' hidden dims sliced over
T ranks, ``launch.mesh.arch_mesh``).  Under ``torchrun`` each process
joins the job's group; otherwise, for a mesh of more than one rank, the
driver spawns one local rank a mesh position (gloo
with ``--device cpu``, NCCL with one GPU a rank, raising when the machine
has too few GPUs), and at ``1x1`` it runs in-process on a one-rank group.
Rank 0 prints and writes the metrics and the trace.

``--profile-dir D`` is the port's ``--jax-profile-dir``: a
``torch.profiler`` capture of steps 2..5 (``obs.StepProfiler``; with a
card its device activity too) written to D as a Chrome trace (under
``D/rank<r>`` on a mesh of more than one rank), which holds the
program's ranges (``obs.REGIONS``; the trainer's spans among them where
``--trace-dir`` records them).  Rank 0 prints the device time by
kernel, the device time a captured step by range and phase
(``obs.region_split``: forward, remat recompute, backward; what no range
claims as unranged), and the counts of the captured steps
(``obs.counting``: the MoE layers' routed and kept (token, choice) pairs,
and the share dropped).  A capture that fails to start or to stop is
printed and training goes on without it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import traceback

import torch

from repro_torch.configs import get_config
from repro_torch.data import DataConfig
from repro_torch.launch import mesh as mesh_mod
from repro_torch.obs import ObsContext, StepProfiler
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.reduce import DEFAULT_PARTITION_BYTES, SCHEDULES
from repro_torch.runtime.trainer import (Trainer, TrainerConfig,
                                         default_ckpt_dir)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compute-backend", default=None,
                    choices=["auto", "xla", "pallas"],
                    help="MoE compute backend: 'auto'/'pallas' = the CUDA "
                         "kernels (plain versions for CPU tensors), 'xla' = "
                         "the plain tensor path; default keeps the arch "
                         "config")
    ap.add_argument("--dispatch-backend", default="pallas",
                    choices=["einsum", "scatter", "pallas"],
                    help="token dispatch/combine backend "
                         "(core.dispatch.BACKENDS)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint root (default: repro_torch_ckpt under "
                         "the temporary directory)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-out", default=None,
                    help="write the per-step metrics log (JSON rows)")
    ap.add_argument("--trace-dir", default=None,
                    help="enable span tracing and export trace.json / "
                         "spans.json / metrics.prom / metrics.json here")
    ap.add_argument("--no-lina", action="store_true",
                    help="one all-to-all, the whole FFN, one all-to-all "
                         "(no micro-ops)")
    ap.add_argument("--schedule", default="implicit",
                    choices=("implicit",) + SCHEDULES,
                    help="gradient-reduction schedule (optim.reduce."
                         "SCHEDULES); 'implicit' is one unordered "
                         "all-reduce with a mesh, none without")
    ap.add_argument("--partition-bytes", type=float,
                    default=DEFAULT_PARTITION_BYTES,
                    help="micro-op size for the partitioned schedules")
    ap.add_argument("--grad-compression", default=None,
                    choices=["bf16", "int8_ef"],
                    help="compress the gradient reduction (bf16 cast or "
                         "int8 with error feedback)")
    ap.add_argument("--n-microops", type=int, default=None,
                    help="a2a tensor-partition count (MoEConfig.n_microops)"
                         "; a count that does not divide the capacity "
                         "resolves to its largest divisor below")
    ap.add_argument("--pipeline-ffn", dest="pipeline_ffn", default=None,
                    action="store_true",
                    help="pipeline expert FFN with a2a micro-ops (Fig. 8b)")
    ap.add_argument("--no-pipeline-ffn", dest="pipeline_ffn",
                    action="store_false",
                    help="one a2a, the whole FFN, one a2a")
    ap.add_argument("--shortcut", dest="shortcut", default=None,
                    action="store_true",
                    help="ScMoE shortcut: the dense branch runs under the "
                         "dispatch a2a, summed into the combine")
    ap.add_argument("--no-shortcut", dest="shortcut", action="store_false",
                    help="disable the shortcut even if the arch enables it")
    ap.add_argument("--mesh", default=None,
                    help="data x model (x tp) mesh DxE or DxExT, e.g. 2x2 "
                         "(see the module doc)")
    ap.add_argument("--profile-dir", default=None,
                    help="capture a torch.profiler trace of steps 2..5 "
                         "into this directory (see the module doc)")
    return ap.parse_args(argv)


def configs(args) -> tuple:
    """Parsed flags -> (model config, DataConfig, AdamWConfig,
    TrainerConfig)."""
    cfg = get_config(args.arch)
    if args.compute_backend is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, compute_backend=args.compute_backend))
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch, seed=args.seed)
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(args.steps // 10, 1),
                          state_dtype=cfg.opt_state_dtype)
    tcfg = TrainerConfig(steps=args.steps,
                         ckpt_dir=args.ckpt_dir or default_ckpt_dir(),
                         ckpt_every=args.ckpt_every, lina=not args.no_lina,
                         microbatches=args.microbatches, seed=args.seed,
                         schedule=None if args.schedule == "implicit"
                         else args.schedule,
                         partition_bytes=args.partition_bytes,
                         grad_compression=args.grad_compression,
                         dispatch_backend=args.dispatch_backend,
                         n_microops=args.n_microops,
                         pipeline_ffn=args.pipeline_ffn,
                         shortcut=args.shortcut, device=args.device)
    return cfg, data_cfg, opt_cfg, tcfg


def run(argv=None) -> dict:
    """Build and run the trainer (on this rank).  Returns {"trainer",
    "state", "obs", "args"}."""
    args = parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, data_cfg, opt_cfg, tcfg = configs(args)
    mesh = None
    if args.mesh:
        mesh = mesh_mod.make_mesh(mesh_mod.parse_mesh(args.mesh),
                                  device=args.device)
    obs = ObsContext.enabled() if args.trace_dir else ObsContext.disabled()
    trainer = Trainer(cfg, data_cfg, opt_cfg, tcfg, mesh=mesh, obs=obs)
    lead = mesh is None or mesh.rank == 0
    profiler = None
    if args.profile_dir:
        logdir = args.profile_dir if mesh is None or mesh.world == 1 else \
            os.path.join(args.profile_dir, f"rank{mesh.rank}")
        profiler = StepProfiler(logdir, start=2, steps=3)

    def profile(step=None):
        """Drive the capture (close it without ``step``); a failure is
        printed and ends it."""
        nonlocal profiler
        try:
            if step is None:
                profiler.close()
            else:
                profiler.on_step(step)
        except Exception as e:       # the capture only: training goes on
            print(f"profiler: the capture failed at step {step}: {e!r}",
                  flush=True)
            traceback.print_exc()
            profiler = None

    def log(step, m):
        if profiler is not None:
            profile(step)
        if lead and step % tcfg.log_every == 0:
            print(f"step {step:5d}  loss {m['loss']:.4f}  "
                  f"aux {m['aux_loss']:.4f}  gnorm {m['grad_norm']:.3f}",
                  flush=True)

    state = trainer.run(on_step=log)
    if profiler is not None:
        profile()
    if profiler is not None and lead:
        path = profiler.session.path
        times = profiler.kernel_times()
        print(f"profile: {path or 'no capture (fewer than 3 steps)'}; "
              + (", ".join(f"{k} {v / 1e3:.3f} ms" for k, v in
                           list(times.items())[:8])
                 or "no device activity"), flush=True)
        print_capture(profiler)
    return {"trainer": trainer, "state": state, "obs": obs, "args": args}


def print_capture(profiler: StepProfiler) -> None:
    """The capture's device time a step by range (forward / recompute /
    backward ms) and its counts."""
    n = max(profiler.captured, 1)
    split = profiler.session.region_split()
    if split.get("device_s"):
        ranges = sorted(split["regions"].items(),
                        key=lambda kv: -sum(kv[1].values()))
        parts = [name + " " + " / ".join(f"{v * 1e3 / n:.3f}"
                                         for v in ph.values())
                 for name, ph in ranges]
        print(f"profile: device ms a step by range (forward / recompute / "
              f"backward): {', '.join(parts)}; unranged "
              f"{split['unranged_s'] * 1e3 / n:.3f} of "
              f"{split['device_s'] * 1e3 / n:.3f}", flush=True)
    counts = profiler.session.counts
    routed = counts.get("moe.routed_pairs", 0)
    dropped = "" if not routed else \
        f"; dropped {100 * (1 - counts['moe.kept_pairs'] / routed):.3f}%"
    print("profile: counts of the captured steps: "
          + (", ".join(f"{k} {v}" for k, v in counts.items()) or "none")
          + dropped, flush=True)


def main(argv=None, _child: bool = False):
    args = parse_args(argv)
    if mesh_mod.spawn_ranks(main, argv, args.mesh, args.device, _child):
        return 0
    out = run(argv)
    trainer, args, obs = out["trainer"], out["args"], out["obs"]
    if trainer.rank != 0:
        return 0
    if trainer.packing_decision:
        print(f"expert packing: {trainer.packing_decision}")
    if args.metrics_out:
        os.makedirs(os.path.dirname(args.metrics_out) or ".", exist_ok=True)
        with open(args.metrics_out, "w") as f:
            json.dump(trainer.metrics_log, f)
    if args.trace_dir:
        paths = obs.export(args.trace_dir)
        print(f"trace artifacts: {paths['trace']}, {paths['spans']}, "
              f"{paths['prom']}")
    log = trainer.metrics_log
    if log:
        print(f"loss {log[0]['loss']:.4f} -> {log[-1]['loss']:.4f} over "
              f"{len(log)} steps")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
