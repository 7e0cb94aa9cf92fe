"""Training driver of the port, on one card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-moe \\
        [--steps 50 --batch 8 --seq 1024] [--device cuda|cpu]

Flags follow ``repro.launch.train``.  ``--device`` defaults to ``cuda`` and
raises without a card; ``--device cpu`` runs the kernels' plain versions.
``--dispatch-backend`` defaults to ``pallas`` (the dispatch / combine
kernels), so with the arch's ``compute_backend`` "auto" every MoE op runs
its kernel.  The reference's ``--schedule`` (other than ``implicit``),
``--grad-compression``, ``--n-microops``, ``--[no-]pipeline-ffn``,
``--[no-]shortcut`` and ``--mesh`` need expert parallelism over NCCL
(ROADMAP: "expert parallelism and the §4 schedule") and raise
``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch

from repro_torch.configs import get_config
from repro_torch.data import DataConfig
from repro_torch.launch.steps import EXPERT_PARALLELISM
from repro_torch.obs import ObsContext
from repro_torch.optim.adamw import AdamWConfig
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
    # the reference's expert-parallel flags: accepted so that using them
    # fails loudly instead of being ignored
    ap.add_argument("--schedule", default="implicit")
    ap.add_argument("--grad-compression", default=None)
    ap.add_argument("--n-microops", type=int, default=None)
    ap.add_argument("--pipeline-ffn", dest="pipeline_ffn", default=None,
                    action="store_true")
    ap.add_argument("--no-pipeline-ffn", dest="pipeline_ffn",
                    action="store_false")
    ap.add_argument("--shortcut", dest="shortcut", default=None,
                    action="store_true")
    ap.add_argument("--no-shortcut", dest="shortcut", action="store_false")
    ap.add_argument("--mesh", default=None)
    args = ap.parse_args(argv)
    for flag, unset in (("schedule", "implicit"), ("grad_compression", None),
                        ("n_microops", None), ("pipeline_ffn", None),
                        ("shortcut", None), ("mesh", None)):
        if getattr(args, flag) != unset:
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} {EXPERT_PARALLELISM}")
    return args


def run(argv=None) -> dict:
    """Build and run the trainer.  Returns {"trainer", "state", "obs",
    "args"}."""
    args = parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
                         ckpt_every=args.ckpt_every,
                         microbatches=args.microbatches, seed=args.seed,
                         dispatch_backend=args.dispatch_backend,
                         device=args.device)
    obs = ObsContext.enabled() if args.trace_dir else ObsContext.disabled()
    trainer = Trainer(cfg, data_cfg, opt_cfg, tcfg, obs=obs)

    def log(step, m):
        if step % tcfg.log_every == 0:
            print(f"step {step:5d}  loss {m['loss']:.4f}  "
                  f"aux {m['aux_loss']:.4f}  gnorm {m['grad_norm']:.3f}",
                  flush=True)

    state = trainer.run(on_step=log)
    return {"trainer": trainer, "state": state, "obs": obs, "args": args}


def main(argv=None):
    out = run(argv)
    trainer, args, obs = out["trainer"], out["args"], out["obs"]
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
