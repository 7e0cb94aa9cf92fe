"""Fault-tolerant training loop of the port, on one card or one rank of
an expert-parallel mesh (the reference's ``src/repro/runtime/trainer.py``):

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
    model (``core.packing`` on the H100) picks experts-per-device for the
    mesh's expert-parallel size.

With a ``mesh`` (``launch.mesh``) every leaf is stored as the reference's
specs place it (``launch.sharding.param_specs``: FSDP over `data`, tensor
parallel over `model` and `tp`, the experts over `model`), the AdamW
moments likewise: every rank initialises the same full params from the
seed and keeps its shards (``convert.shard_params``), and reads the B / dp
rows of its `data` index of each step's global batch (the same rows on its
model-parallel ranks; the whole batch where B does not split).  Lina's
knobs (``lina``, ``schedule``, ``partition_bytes``, ``grad_compression``,
and ``n_microops`` / ``pipeline_ffn`` / ``shortcut`` applied onto the model
config) reach the step (``launch.steps``).  A checkpoint stays one tree:
rank 0 writes the full params and optimizer state, gathered by the specs,
and every rank restores the full tree and takes its shards, so a run saved
on one mesh resumes on another or on none (the reference's elastic
resharding).  The int8 residuals (``reduce_state``) differ per rank and
are saved as a ``[world, ...]`` stack; a resume at another world size
zeroes them and logs it.

Spans (``obs``): ``train.step`` > ``data.batch``, ``fwd_bwd``,
``checkpoint``, the first two with ``schedule=``; counters
``trainer_steps_total``, ``trainer_skipped_steps_total``,
``trainer_rollbacks_total``, ``trainer_straggler_events_total`` and the
``trainer_step_s`` histogram.  While a ``torch.profiler`` session records,
each recorded span is also a range of its name, and the step opens the
layer ranges of ``obs.REGIONS`` within ``fwd_bwd`` (``lm.cast``,
``lm.embed``, ``lm.stack``, ``lm.attention``, ``lm.moe``, ``lm.ffn``,
``lm.rwkv``, ``lm.hybrid``, ``lm.loss``, ``optim.reduce``,
``optim.update``); inside an ``obs.counting()`` block its MoE layers
count ``moe.routed_pairs`` and ``moe.kept_pairs``.
The ``fwd_bwd`` stopwatch ends after the card has finished: the metrics
are read to the host inside it.
"""
from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass, field, replace
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.convert import block_index, shard_params, unshard_params
from repro_torch.core.packing import choose_packing
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.devices import resolve_device
from repro_torch.launch import sharding as shard_mod
from repro_torch.launch.mesh import ep_size
from repro_torch.launch.steps import make_train_step
from repro_torch.models import lm as lm_mod
from repro_torch.obs import ObsContext
from repro_torch.optim import reduce as reduce_mod
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.tree import tree_map


def default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_dir: str = field(default_factory=default_ckpt_dir)
    ckpt_every: int = 50
    keep: int = 3
    log_every: int = 10
    lina: bool = True
    microbatches: int = 1
    # Lina §4 gradient-reduction schedule (optim.reduce.SCHEDULES); None
    # keeps the implicit reduction (with a mesh: one unordered all-reduce)
    schedule: Optional[str] = None
    partition_bytes: float = reduce_mod.DEFAULT_PARTITION_BYTES
    grad_compression: Optional[str] = None   # None | "bf16" | "int8_ef"
    # token dispatch/combine backend (core.dispatch.BACKENDS): "pallas"
    # (the kernels), "scatter" or "einsum" (plain tensor code)
    dispatch_backend: str = "pallas"
    # overlap knobs (None = keep the model config's), applied onto
    # model_cfg.moe at construction
    n_microops: Optional[int] = None
    pipeline_ffn: Optional[bool] = None
    shortcut: Optional[bool] = None
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
                 cfg: TrainerConfig, mesh=None,
                 obs: Optional[ObsContext] = None):
        self.device = mesh.device if mesh is not None \
            else resolve_device(cfg.device)
        self.obs = obs or ObsContext.disabled()
        moe_over = {k: v for k, v in (("n_microops", cfg.n_microops),
                                      ("pipeline_ffn", cfg.pipeline_ffn),
                                      ("shortcut", cfg.shortcut))
                    if v is not None}
        if moe_over:
            model_cfg = replace(model_cfg,
                                moe=replace(model_cfg.moe, **moe_over))
        self.model_cfg = model_cfg
        self.data_cfg = data_cfg
        self.opt_cfg = opt_cfg
        self.cfg = cfg
        self.mesh = mesh
        self.world = mesh.world if mesh is not None else 1
        self.rank = mesh.rank if mesh is not None else 0
        self.layout = None
        # the rows a rank reads: its block over the layout's batch axes
        self.row_index, self.row_split = 0, 1
        if mesh is not None:
            self.layout = shard_mod.layout_for(
                model_cfg, mesh, lm_mod.init_params(model_cfg, None,
                                                    device="meta"),
                "train", global_batch=data_cfg.global_batch)
            self.row_index, self.row_split = block_index(
                mesh, self.layout.batch_axes)
        self.ckpt = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep)
        self.dataset = SyntheticLM(data_cfg)
        self.stateful_reduce = cfg.grad_compression == "int8_ef"
        self.step_fn = make_train_step(
            model_cfg, opt_cfg, layout=self.layout, lina=cfg.lina,
            dispatch_backend=cfg.dispatch_backend,
            microbatches=cfg.microbatches, schedule=cfg.schedule,
            partition_bytes=cfg.partition_bytes,
            grad_compression=cfg.grad_compression)
        self.metrics_log: list = []
        self.straggler_events: list = []
        self.checkpoint_log: list = []       # {"step", "bytes", "seconds"}
        self.packing_decision = None
        self.skipped_steps: list = []
        self.rollbacks = 0
        self.reset_log: list = []            # leaves a restore zeroed

    def _full_state(self) -> dict:
        """The whole model's state as rank 0 saves it (full shapes)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.cfg.seed)
        params = lm_mod.init_params(self.model_cfg, gen, device=self.device)
        state = {"params": params,
                 "opt_state": init_opt_state(params, self.opt_cfg)}
        if self.stateful_reduce:
            rs = reduce_mod.init_reduce_state(
                self._cut(params), reduce_mod.ReduceConfig(
                    schedule=self.cfg.schedule,
                    partition_bytes=self.cfg.partition_bytes,
                    compression=self.cfg.grad_compression))
            if self.mesh is not None:       # one residual a rank
                rs = tree_map(lambda r: r.expand(self.world, *r.shape)
                              .contiguous(), rs)
            state["reduce_state"] = rs
        return state

    def _specs(self, tree):
        """The spec tree of ``tree`` (params or an ``OptState``), None
        without a mesh."""
        if self.layout is None:
            return None
        if hasattr(tree, "m"):
            return shard_mod.opt_state_specs(self.layout.specs)
        return self.layout.specs

    def _cut(self, tree):
        return shard_params(tree, self.mesh, self._specs(tree))

    def _shard(self, full: dict) -> dict:
        """This rank's part of a full state."""
        if self.mesh is None:
            return full
        st = {"params": self._cut(full["params"]),
              "opt_state": self._cut(full["opt_state"])}
        if "reduce_state" in full:
            st["reduce_state"] = tree_map(lambda r: r[self.rank].clone(),
                                          full["reduce_state"])
        return st

    def _gather(self, state: dict) -> dict:
        """The full state from every rank's shard (every rank calls it)."""
        if self.mesh is None:
            return state
        full = {k: unshard_params(state[k], self.mesh, self._specs(state[k]))
                for k in ("params", "opt_state")}
        if "reduce_state" in state:
            def stack(r):
                out = r.new_empty((self.world, *r.shape))
                self.mesh.all_gather(out, r.contiguous()[None],
                                     self.mesh.world_group)
                return out
            full["reduce_state"] = tree_map(stack, state["reduce_state"])
        return full

    def init_state(self) -> dict:
        return self._shard(self._full_state())

    def _save(self, step: int, state: dict) -> None:
        full = self._gather(state)
        if self.rank == 0:
            self.ckpt.save(step, full)
        if self.mesh is not None:
            self.mesh.barrier()

    def _restore(self, like: dict):
        """(step, this rank's state) of the newest checkpoint that
        verifies, or (None, None).  ``like``: a full state (its shapes and
        devices)."""
        step, full = self.ckpt.restore_latest(like,
                                              reset_ok=("reduce_state",))
        if full is None:
            return None, None
        if self.ckpt.last_reset:
            self.reset_log.append({"step": step,
                                   "leaves": list(self.ckpt.last_reset)})
            print(f"trainer: restored step {step}: the int8 residuals were "
                  f"saved for another world size; {len(self.ckpt.last_reset)}"
                  f" residual leaves start from zero at world {self.world}",
                  flush=True)
        return step, self._shard(full)

    def _batch(self, step: int) -> dict:
        b = self.data_cfg.global_batch // self.row_split
        i = self.row_index
        return {k: torch.from_numpy(v[i * b:(i + 1) * b]).to(self.device)
                for k, v in self.dataset.batch(step).items()}

    def run(self, on_step: Optional[Callable] = None) -> dict:
        full = self._full_state()
        start, restored = self._restore(full)
        state = restored if restored is not None else self._shard(full)
        del full
        start_step = start if restored is not None else 0
        sched = self.cfg.schedule or "implicit"

        times: list = []
        consec_bad = 0
        tr = self.obs.tracer
        met = self.obs.metrics
        for step in range(start_step, self.cfg.steps):
            if self.cfg.fail_at_step is not None and \
                    step == self.cfg.fail_at_step:
                raise RuntimeError(f"injected failure at step {step}")
            with tr.span("train.step", step=step, schedule=sched) as ssp:
                with tr.span("data.batch"):
                    batch = self._batch(step)
                with tr.timed("fwd_bwd", schedule=sched) as sw:
                    if self.stateful_reduce:
                        params, opt_state, m, rstate = self.step_fn(
                            state["params"], state["opt_state"], batch,
                            state["reduce_state"])
                    else:
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
                        _, rb_state = self._restore(
                            state if self.mesh is None
                            else self._full_state())
                        if rb_state is not None:
                            state = rb_state
                            self.rollbacks += 1
                            met.counter("trainer_rollbacks_total").inc()
                            ssp.set(rollback=True)
                        consec_bad = 0
                    continue     # params/opt_state keep pre-step values
                consec_bad = 0
                state = {"params": params, "opt_state": opt_state}
                if self.stateful_reduce:
                    state["reduce_state"] = rstate
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
                        self._save(step + 1, state)
                    self.checkpoint_log.append(
                        {"step": step + 1, "bytes": self.ckpt.last_save_bytes,
                         "seconds": cw.dt})
        return state

    def _decide_packing(self):
        mc = self.model_cfg
        # the expert-parallel group this trainer runs, as the reference
        # takes it from its mesh (one rank without a mesh)
        ep = ep_size(self.mesh)
        tokens = (self.data_cfg.global_batch * self.data_cfg.seq_len
                  // max(ep, 1) // max(mc.moe.n_microops, 1))
        self.packing_decision = choose_packing(
            max(tokens, 1), mc.d_model, mc.moe.d_ff or mc.d_ff,
            mc.moe.n_experts, ep,
            ffn_mult=3 if mc.ffn_type == "swiglu" else 2)
