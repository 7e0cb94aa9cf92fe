"""Fault-tolerant training loop of the port on one card (the reference's
``src/repro/runtime/trainer.py``):

  * checkpoint/restart: atomic keep-k checkpoints; on start the Trainer
    resumes from the latest checkpoint and, because the data pipeline is
    step-indexed, replays the exact batch sequence (bitwise resume where
    the card's arithmetic is deterministic);
  * failure injection: ``fail_at_step`` raises mid-run;
  * straggler watchdog: a step slower than ``straggler_factor`` times the
    rolling median is logged;
  * non-finite guard: a step whose metrics come back NaN/inf is skipped
    (params and optimizer state keep their pre-step values), and
    ``max_bad_steps`` consecutive bad steps roll back to the newest
    verified checkpoint; ``nan_at_steps`` injects such steps;
  * expert packing (paper §6.1): after ``pack_warmup`` steps the analytic
    model (``core.packing`` on the H100) picks experts-per-device.

The reference's gradient-reduction schedule, compression and overlap
knobs (``schedule``, ``grad_compression``, ``n_microops``,
``pipeline_ffn``, ``shortcut``) need expert parallelism (ROADMAP: "expert
parallelism and the §4 schedule") and are not fields here.

Spans (``obs``): ``train.step`` > ``data.batch``, ``fwd_bwd``,
``checkpoint``; counters ``trainer_steps_total``,
``trainer_skipped_steps_total``, ``trainer_rollbacks_total``,
``trainer_straggler_events_total`` and the ``trainer_step_s`` histogram.
The ``fwd_bwd`` stopwatch ends after the card has finished: the metrics
are read to the host inside it.
"""
from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.packing import choose_packing
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.devices import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import lm as lm_mod
from repro_torch.obs import ObsContext
from repro_torch.optim.adamw import AdamWConfig, init_opt_state


def default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_dir: str = field(default_factory=default_ckpt_dir)
    ckpt_every: int = 50
    keep: int = 3
    log_every: int = 10
    microbatches: int = 1
    # token dispatch/combine backend (core.dispatch.BACKENDS): "pallas"
    # (the kernels), "scatter" or "einsum" (plain tensor code)
    dispatch_backend: str = "pallas"
    fail_at_step: Optional[int] = None       # failure injection (tests)
    straggler_factor: float = 3.0
    pack_warmup: int = 10                    # paper: packing decided at step 10
    seed: int = 0
    # non-finite guard: skip steps with NaN/inf metrics; roll back to the
    # newest checkpoint after this many CONSECUTIVE bad steps (0 = off)
    max_bad_steps: int = 3
    nan_at_steps: tuple = ()                 # fault injection
    device: str = "cuda"


class Trainer:
    def __init__(self, model_cfg, data_cfg: DataConfig, opt_cfg: AdamWConfig,
                 cfg: TrainerConfig, obs: Optional[ObsContext] = None):
        self.device = resolve_device(cfg.device)
        self.obs = obs or ObsContext.disabled()
        self.model_cfg = model_cfg
        self.data_cfg = data_cfg
        self.opt_cfg = opt_cfg
        self.cfg = cfg
        self.ckpt = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep)
        self.dataset = SyntheticLM(data_cfg)
        self.step_fn = make_train_step(
            model_cfg, opt_cfg, dispatch_backend=cfg.dispatch_backend,
            microbatches=cfg.microbatches)
        self.metrics_log: list = []
        self.straggler_events: list = []
        self.checkpoint_log: list = []       # {"step", "bytes", "seconds"}
        self.packing_decision = None
        self.skipped_steps: list = []
        self.rollbacks = 0

    def init_state(self) -> dict:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.cfg.seed)
        params = lm_mod.init_params(self.model_cfg, gen, device=self.device)
        return {"params": params,
                "opt_state": init_opt_state(params, self.opt_cfg)}

    def _batch(self, step: int) -> dict:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.dataset.batch(step).items()}

    def run(self, on_step: Optional[Callable] = None) -> dict:
        state = self.init_state()
        start, restored = self.ckpt.restore_latest(state)
        if restored is not None:
            state = restored
        start_step = start if restored is not None else 0

        times: list = []
        consec_bad = 0
        tr = self.obs.tracer
        met = self.obs.metrics
        for step in range(start_step, self.cfg.steps):
            if self.cfg.fail_at_step is not None and \
                    step == self.cfg.fail_at_step:
                raise RuntimeError(f"injected failure at step {step}")
            with tr.span("train.step", step=step) as ssp:
                with tr.span("data.batch"):
                    batch = self._batch(step)
                with tr.timed("fwd_bwd") as sw:
                    params, opt_state, m = self.step_fn(
                        state["params"], state["opt_state"], batch)
                    m = {k: float(v) for k, v in m.items()}   # waits
                if step in (self.cfg.nan_at_steps or ()):
                    m = dict(m, loss=float("nan"))   # injected divergence
                dt = sw.dt
                met.counter("trainer_steps_total").inc()
                met.histogram("trainer_step_s").observe(dt)
                if self.cfg.max_bad_steps and \
                        not all(np.isfinite(v) for v in m.values()):
                    self.skipped_steps.append(step)
                    self.metrics_log.append({"step": step, **m, "dt": dt,
                                             "skipped": True})
                    met.counter("trainer_skipped_steps_total").inc()
                    ssp.set(skipped=True)
                    consec_bad += 1
                    if consec_bad >= self.cfg.max_bad_steps:
                        _, rb_state = self.ckpt.restore_latest(state)
                        if rb_state is not None:
                            state = rb_state
                            self.rollbacks += 1
                            met.counter("trainer_rollbacks_total").inc()
                            ssp.set(rollback=True)
                        consec_bad = 0
                    continue     # params/opt_state keep pre-step values
                consec_bad = 0
                state = {"params": params, "opt_state": opt_state}
                times.append(dt)
                med = float(np.median(times[-20:]))
                if len(times) > 5 and dt > self.cfg.straggler_factor * med:
                    self.straggler_events.append({"step": step, "dt": dt,
                                                  "median": med})
                    met.counter("trainer_straggler_events_total").inc()
                self.metrics_log.append({"step": step, **m, "dt": dt})
                if step == self.cfg.pack_warmup and \
                        self.model_cfg.moe.enabled:
                    self._decide_packing()
                if on_step:
                    on_step(step, m)
                if (step + 1) % self.cfg.ckpt_every == 0 or \
                        step + 1 == self.cfg.steps:
                    with tr.timed("checkpoint", step=step + 1) as cw:
                        self.ckpt.save(step + 1, state)
                    self.checkpoint_log.append(
                        {"step": step + 1, "bytes": self.ckpt.last_save_bytes,
                         "seconds": cw.dt})
        return state

    def _decide_packing(self):
        mc = self.model_cfg
        # the expert-parallel group this trainer runs: one rank (the
        # reference likewise takes the EP size of its mesh, 1 on a 1x1 one)
        ep = 1
        tokens = (self.data_cfg.global_batch * self.data_cfg.seq_len
                  // max(ep, 1) // max(mc.moe.n_microops, 1))
        self.packing_decision = choose_packing(
            max(tokens, 1), mc.d_model, mc.moe.d_ff or mc.d_ff,
            mc.moe.n_experts, ep,
            ffn_mult=3 if mc.ffn_type == "swiglu" else 2)
