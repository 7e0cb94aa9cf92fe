"""Two-phase MoE serving runtime (paper §5/§6.2), in PyTorch, on one card
or an expert-parallel mesh.

Per MoE layer the server:
  phase 1: estimates the layer's expert popularity from each token's
           sample path (PathProfile Ψ lookup), and reuses the layer's
           cached PlacementPlan while the estimate's top-2k set still
           matches the popularity the plan was built from (PlanCache);
  gate:    runs the gating network and pulls the top-1 ids to the host
           (the host planner needs them: one device->host copy per layer);
  phase 2: on a top-2k deviation between estimate and gate, re-plans from
           the actual popularity (the blocking fine-tune) and refreshes
           the cache;
  dispatch: runs ``core.serving.serve_moe_layer`` under the final plan —
           weighted replica split, packed experts, and on a mesh the
           all-to-all to the slot owners — through the kernels on a CUDA
           tensor.

Entry points: ``serve_batch`` (full sequence, no cache), ``prefill_batch``
(full sequence + KV cache), ``decode_batch`` (one token per request against
the cache).  Logits come back as float32 numpy arrays, so every call ends
after the card has finished (the engine's service-time stopwatch relies on
that).

On a mesh (``launch.mesh``) every rank runs the same server on the same
requests: attention, gating and the planner are replicated, and only the
MoE dispatch is sharded (this rank's experts, from the full params every
rank builds).  The ranks' host decisions must agree or they would issue
different collectives: the phase-2 watchdog's stopwatch is the max over
the world, and each new plan's tables are checked equal across the ranks
once (``PlanMismatch`` otherwise).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.convert import shard_params
from repro_torch.launch import sharding as shard_mod
from repro_torch.core import axes
from repro_torch.core.gating import capacity
from repro_torch.core.placement import (PlacementPlan, PlanCache,
                                        identity_plan, needs_finetune,
                                        plan_from_replicas, plan_placement,
                                        route_weights)
from repro_torch.core.popularity import PathProfile
from repro_torch.core.serving import (PlanArrays, dp_shard_count,
                                      fetch_hosted, mask_dead_route_weights,
                                      replica_token_counts, serve_moe_layer,
                                      slot_capacity)
from repro_torch.devices import resolve_device
from repro_torch.kernels.ops import kernel_route
from repro_torch.kernels.ref import first_max_topk
from repro_torch.models import lm as lm_mod
from repro_torch.models.attention import KVCache, attention, decode_attention
from repro_torch.models.layers import rms_norm
from repro_torch.models.lm import LMCache, tree_idx
from repro_torch.tree import tree_map
from repro_torch.obs import ObsContext


@dataclass
class ServerConfig:
    top_k: int = 1                 # paper: top-1 gating at inference
    path_len: int = 3
    max_pack: int = 4
    n_devices: int = 0             # 0 => n_experts (paper: 1 expert/device)
    use_estimation: bool = True    # ablation: False = schedule after gating
    use_finetuning: bool = True    # ablation: False = never fine-tune
    schedule_policy: str = "lina"  # lina | uniform (DeepSpeed baseline)
    plan_cache: bool = True        # reuse plans across batches until drift
    route_mode: str = "weighted"   # weighted (§5 histogram split) |
    #                                round_robin (positional ablation)
    phase2_timeout_s: float = 0.0  # watchdog: a phase-2 re-plan slower than
    #                                this suppresses further fine-tunes for
    #                                ``phase2_backoff`` plan calls (0 = off)
    phase2_backoff: int = 8


@dataclass
class LayerStats:
    layer: int
    est_pop: np.ndarray
    actual_pop: np.ndarray
    finetuned: bool
    est_accurate: bool
    plan_reused: bool              # plan came from the cache (no re-plan)
    device_load: np.ndarray        # token share per device (actual workload)
    n_tokens: int = 0              # valid tokens this layer dispatched
    replica_load: Optional[np.ndarray] = None
    #                                [n_slots] realized valid-token count per
    #                                (device, sub-slot) after replica routing


class ServeResult(NamedTuple):
    logits: np.ndarray             # [B, V] last-valid-token logits
    stats: List[LayerStats]
    path_ids: np.ndarray           # [B, S] final rolling path state


class PrefillResult(NamedTuple):
    logits: np.ndarray             # [B, V] last-valid-token logits
    stats: List[LayerStats]
    path_ids: np.ndarray           # [B, S] final rolling path state
    cache: LMCache                 # KV cache sized to cache_len, pos=lengths


class DecodeResult(NamedTuple):
    logits: np.ndarray             # [B, V] next-token logits
    stats: List[LayerStats]
    path_state: np.ndarray         # [B] rolling path state after this token
    cache: LMCache                 # updated KV cache, pos advanced by 1


def _host(t) -> np.ndarray:
    """Device tensor -> host numpy (bf16 widened to float32, exactly)."""
    t = t.detach()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.cpu().numpy()


class PlanMismatch(RuntimeError):
    """The ranks of a mesh hold different plans for a layer."""


def agree_max(mesh, value: float) -> float:
    """``value``'s max over every rank of ``mesh`` (itself without one)."""
    if mesh is None or mesh.world == 1:
        return value
    t = torch.tensor([value], dtype=torch.float64, device=mesh.device)
    mesh.all_reduce(t, mesh.world_group, op="max")
    return float(t.item())


def _plan_checksum(plan: PlacementPlan) -> np.ndarray:
    """[3] int64: a position-weighted sum of each of slot_expert,
    replica_of and n_replicas (entries are >= -1)."""
    out = []
    for a in (plan.slot_expert, plan.replica_of, plan.n_replicas):
        a = np.asarray(a, np.int64).reshape(-1)
        out.append(int(((a + 2) * np.arange(1, a.size + 1)).sum()))
    return np.asarray(out, np.int64)


class MoEServer:
    def __init__(self, cfg: ModelConfig, params, profile: PathProfile,
                 scfg: Optional[ServerConfig] = None,
                 obs: Optional[ObsContext] = None, device="cuda", mesh=None):
        """``params``: the full model (every rank builds it from the seed);
        with ``mesh`` the server keeps this rank's experts and runs on the
        mesh's device."""
        if not cfg.moe.enabled:
            raise ValueError("MoEServer serves MoE architectures")
        scfg = scfg or ServerConfig()
        self.mesh = mesh
        self.device = mesh.device if mesh is not None \
            else resolve_device(device)
        self.cfg = cfg
        params = tree_map(lambda a: a.to(self.device), params)
        self.params = shard_params(params, mesh,
                                   None if mesh is None else
                                   shard_mod.expert_specs(mesh, params))
        self.profile = profile
        self.scfg = scfg
        self.obs = obs or ObsContext.disabled()
        self.n_dev = scfg.n_devices or cfg.moe.n_experts
        self.every = cfg.moe.every
        self.plan_cache = PlanCache(top_k=scfg.top_k) if scfg.plan_cache \
            else None
        # weights are static across requests: cast once, slice layer groups
        # once, keep the unembed matrix resident
        self._cparams = lm_mod.cast_for_compute(cfg, self.params)
        self._w_unembed = lm_mod.unembed_weight(self._cparams)
        self._dtype = lm_mod.DTYPES[cfg.dtype]
        self._gp_cache: dict = {}
        self._plan_arrays: dict = {}
        self._hosted_of: dict = {}
        self._plan_override: dict = {}
        self._override_fresh: set = set()
        # devices masked out of planning and routing; fault_hook, when set,
        # is called as fault_hook("plan", layer) before each primary plan
        # build (the injection point of planner-crash faults)
        self.dead_devices: set = set()
        self.fault_hook = None
        self.degrade_stats: dict = {"planner_errors": 0, "phase2_timeouts": 0,
                                    "emergency_replans": 0}
        self._phase2_suppress = 0

    # --- controller-published plans ----------------------------------------
    def publish_plans(self, plans: dict) -> None:
        """Install per-layer plans ({layer: PlacementPlan}) from the next
        micro-batch on; in-flight decode state is untouched."""
        self._plan_override.update(plans)
        self._override_fresh.update(plans.keys())

    # --- graceful degradation ----------------------------------------------
    def fail_devices(self, devices) -> None:
        """Mask failed devices out of routing and planning, without touching
        in-flight decode state: zero their replicas' route weights, drop
        cached plans that use them, emergency-rebuild published plans that
        left an expert with no surviving replica."""
        devs = {int(d) for d in devices if 0 <= d < self.n_dev}
        if not devs - self.dead_devices:
            return
        self.dead_devices |= devs
        self._plan_arrays.clear()
        if self.plan_cache is not None:
            self.plan_cache.invalidate_devices(self.dead_devices)
        rebuilt = {}
        for li, plan in self._plan_override.items():
            if self._plan_orphaned(plan):
                rebuilt[li] = plan_from_replicas(
                    plan.popularity, plan.n_replicas, self.n_dev,
                    max_pack=self.scfg.max_pack,
                    rep_width=plan.replica_of.shape[1], prev=plan,
                    dead_devices=self.dead_devices)
        if rebuilt:
            self.degrade_stats["emergency_replans"] += len(rebuilt)
            self.obs.metrics.counter(
                "server_degrade_total",
                kind="emergency_replan").inc(len(rebuilt))
            self.publish_plans(rebuilt)

    def revive_devices(self, devices) -> None:
        """Return repaired devices to the pool; plans re-expand onto them at
        the next re-plan (cache drift / controller cadence)."""
        self.dead_devices -= {int(d) for d in devices}
        self._plan_arrays.clear()

    def _plan_orphaned(self, plan: PlacementPlan) -> bool:
        if not self.dead_devices:
            return False
        ro = np.asarray(plan.replica_of)
        live = (np.arange(ro.shape[1])[None, :]
                < np.clip(plan.n_replicas, 1, ro.shape[1])[:, None]) \
            & (ro >= 0)
        on_dead = np.zeros(ro.shape, bool)
        dev = np.where(live, ro // plan.max_pack, -1)
        for d in self.dead_devices:
            on_dead |= dev == d
        return bool((live & ~on_dead).sum(1).min() == 0)

    def warmup(self, *, seqs=(), rows=(1,), min_replicas_grid=(1, 2),
               max_new_tokens: int = 8) -> int:
        """Build and launch every kernel once before traffic: a prefill (+
        one decode step) at each prompt length in ``seqs`` and the dispatch
        at each (row bucket, min_replicas, table width) combination.  Plan
        cache contents/stats and published plans are restored.  Returns the
        number of warm-up calls."""
        cache = self.plan_cache
        saved_cache = (dict(cache._plans),
                       dataclasses.replace(cache.stats)) \
            if cache is not None else None
        saved_ov = (dict(self._plan_override), set(self._override_fresh))
        n = 0
        try:
            for s in seqs:
                pre = self.prefill_batch(np.zeros((1, int(s)), np.int64),
                                         cache_len=int(s) + max_new_tokens)
                n += 1
                if max_new_tokens:
                    self.decode_batch(np.zeros((1,), np.int64), pre.cache,
                                      np.zeros((1,), np.int64))
                    n += 1
            n += self._warmup_dispatch(rows, min_replicas_grid)
        finally:
            if saved_cache is not None:
                cache._plans.clear()
                cache._plans.update(saved_cache[0])
                cache.stats = saved_cache[1]
            self._plan_override = saved_ov[0]
            self._override_fresh = saved_ov[1]
        return n

    def _warmup_dispatch(self, rows, min_replicas_grid) -> int:
        cfg = self.cfg
        gp = self._group_params(0)
        combos = set()
        for n_valid in sorted(set(int(r) for r in rows)):
            bucket = 1 << (n_valid - 1).bit_length()
            cap = self._valid_capacity(n_valid, bucket)
            for r in min_replicas_grid:
                r = max(1, int(min(r, (self.n_dev * self.scfg.max_pack)
                                   // cfg.moe.n_experts, self.n_dev)))
                for width in {self.n_dev, self.scfg.max_pack}:
                    combos.add((bucket, cap, r, width))
        for bucket, cap, r, width in sorted(combos):
            plan = plan_from_replicas(
                np.full((cfg.moe.n_experts,), 1.0 / cfg.moe.n_experts),
                np.full((cfg.moe.n_experts,), r, np.int64),
                self.n_dev, max_pack=self.scfg.max_pack, rep_width=width)
            h2 = torch.zeros((bucket, cfg.d_model), dtype=self._dtype,
                             device=self.device)
            self._dispatch(gp.moe, h2, self._plan_device(plan),
                           int(plan.n_replicas.min()), cap)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return len(combos)

    # --- layer pieces -------------------------------------------------------
    def _attn(self, gp, j, x):
        """Full-sequence attention block; also returns this layer's K/V.
        The kernel route (``kernel_route``: ``compute_backend`` "auto" or
        "pallas") runs the flash-attention kernel, the plain route ("xla")
        the plain attention."""
        h = rms_norm(x, gp.ln1[j], self.cfg.norm_eps)
        y, kv = attention(tree_idx(gp.attn, j), h, self.cfg,
                          use_kernel=kernel_route(self.cfg))
        return x + y, kv.k, kv.v

    def _attn_dec(self, gp, j, x, k, v, pos):
        """One-token attention block against the KV cache."""
        h = rms_norm(x, gp.ln1[j], self.cfg.norm_eps)
        y, kv = decode_attention(tree_idx(gp.attn, j), h, KVCache(k, v), pos,
                                 self.cfg)
        return x + y, kv.k, kv.v

    def _gate(self, router, h2):
        logits = h2 @ router
        probs = torch.softmax(logits.float(), dim=-1)
        _, idx = first_max_topk(probs, self.scfg.top_k)
        return probs, idx

    def _dispatch(self, moe_p, h2, plan: PlanArrays, min_replicas: int,
                  cap: int, hosted=None):
        """The MoE layer under the final plan (``serve_moe_layer``, on the
        mesh when there is one; ``hosted``: the plan's fetched experts)."""
        y, _, _ = serve_moe_layer(h2, moe_p, self.cfg.moe, plan,
                                  ffn_type=self.cfg.ffn_type,
                                  top_k=self.scfg.top_k,
                                  min_replicas=min_replicas,
                                  cap_override=cap,
                                  route_mode=self.scfg.route_mode,
                                  mesh=self.mesh, hosted=hosted)
        return y

    def _valid_capacity(self, n_valid: int, n_total: int) -> int:
        """Per-expert gating capacity of one token shard, sized from the
        *valid* token count so batch padding rows cannot change real
        tokens' dispatch (pad rows sort after real rows; with capacity
        fixed they can only be dropped)."""
        shards = dp_shard_count(self.mesh, n_total)
        return capacity(-(-n_valid // shards), self.cfg.moe.n_experts,
                        self.scfg.top_k, self.cfg.moe.capacity_factor)

    # --- planning ----------------------------------------------------------
    def _plan_layer(self, li: int, est: np.ndarray, actual: np.ndarray):
        """Phase 1 (cache-aware) + phase 2.  Returns
        (plan, finetuned, accurate, reused)."""
        cfg, scfg = self.cfg, self.scfg
        met = self.obs.metrics
        accurate = not needs_finetune(est, actual, scfg.top_k)
        override = self._plan_override.get(li)
        if override is not None:
            fresh = li in self._override_fresh
            self._override_fresh.discard(li)
            met.counter("server_plan_lookup_total", result="override").inc()
            return override, False, accurate, not fresh
        if scfg.schedule_policy == "uniform":
            uniform = np.full((cfg.moe.n_experts,),
                              1.0 / cfg.moe.n_experts, np.float32)
            if self.plan_cache is not None:
                with self.obs.tracer.span("plan.lookup", layer=li):
                    cached = self.plan_cache.lookup(li, uniform)
                if cached is not None:
                    met.counter("server_plan_lookup_total",
                                result="hit").inc()
                    return cached, False, accurate, True
            met.counter("server_plan_lookup_total", result="miss").inc()
            plan = identity_plan(cfg.moe.n_experts, self.n_dev,
                                 scfg.max_pack)
            if self.plan_cache is not None:
                self.plan_cache.store(li, plan)
            return plan, False, accurate, False

        suppressed = self._phase2_suppress > 0
        if suppressed:
            self._phase2_suppress -= 1
        if not scfg.use_estimation:
            basis, phase2 = actual, False
        elif scfg.use_finetuning and not accurate and not suppressed:
            basis, phase2 = actual, True
        else:
            basis, phase2 = est, False
        plan = None
        reused = False
        if self.plan_cache is not None:
            with self.obs.tracer.span("plan.lookup", layer=li):
                plan = self.plan_cache.lookup(li, basis)
            reused = plan is not None
        met.counter("server_plan_lookup_total",
                    result="hit" if reused else "miss").inc()
        finetuned = phase2 and not reused
        if plan is None:
            plan = self._build_plan(li, basis, est, phase2)
            if self.plan_cache is not None:
                self.plan_cache.store(li, plan)
        return plan, finetuned, accurate, reused

    def _build_plan(self, li: int, basis: np.ndarray, est: np.ndarray,
                    phase2: bool) -> PlacementPlan:
        """Plan build under the phase-2 watchdog: a planner exception falls
        back to the phase-1 estimate, then the masked uniform layout; a
        phase-2 build slower than ``phase2_timeout_s`` suppresses further
        fine-tunes for ``phase2_backoff`` plan calls."""
        scfg = self.scfg
        met = self.obs.metrics
        sw = self.obs.tracer.timed(
            "phase2.finetune" if phase2 else "plan.build", layer=li)
        try:
            with sw:
                if self.fault_hook is not None:
                    self.fault_hook("plan", li)
                plan = plan_placement(basis, self.n_dev, scfg.max_pack,
                                      dead_devices=self.dead_devices)
        except Exception:
            self.degrade_stats["planner_errors"] += 1
            met.counter("server_degrade_total", kind="planner_error").inc()
            self._phase2_suppress = max(self._phase2_suppress,
                                        scfg.phase2_backoff)
            try:
                return plan_placement(est, self.n_dev, scfg.max_pack,
                                      dead_devices=self.dead_devices)
            except Exception:
                e = self.cfg.moe.n_experts
                return plan_from_replicas(
                    np.full((e,), 1.0 / e), np.ones((e,), np.int64),
                    self.n_dev, max_pack=scfg.max_pack,
                    dead_devices=self.dead_devices)
        # the ranks' stopwatches differ; one slow rank decides for all
        if phase2 and scfg.phase2_timeout_s > 0 and \
                agree_max(self.mesh, sw.dt) > scfg.phase2_timeout_s:
            self.degrade_stats["phase2_timeouts"] += 1
            met.counter("server_degrade_total", kind="phase2_timeout").inc()
            self._phase2_suppress = scfg.phase2_backoff
        return plan

    # --- the shared per-layer two-phase core -------------------------------
    def _serve_moe(self, li: int, gp, h2, valid: np.ndarray,
                   path_ids: np.ndarray, has_state: bool):
        """Phase-1 estimate -> PlanCache lookup -> gate -> phase-2 on drift
        -> plan-honoring dispatch, for one MoE layer.  h2: [T, d]; valid:
        [T] bool; path_ids: [T].  Returns (y [T, d], top1 [T], stats)."""
        cfg, scfg = self.cfg, self.scfg
        tr = self.obs.tracer
        with tr.span("server.layer", layer=li) as lsp:
            with tr.span("phase1.estimate"):
                override = self._plan_override.get(li)
                if override is not None:
                    est = np.asarray(override.popularity, np.float32)
                elif scfg.schedule_policy == "uniform" or \
                        not scfg.use_estimation or \
                        (li < scfg.path_len and not has_state):
                    est = np.full((cfg.moe.n_experts,),
                                  1.0 / cfg.moe.n_experts, np.float32)
                else:
                    est = self.profile.estimate_popularity(
                        li, path_ids[valid] if valid.any() else path_ids)

            with tr.span("gate"):
                _, idx = self._gate(gp.moe.router, h2)
                idx_host = idx.cpu().numpy()          # device -> host sync
                top1 = idx_host[:, 0]
                actual = np.bincount(top1, weights=valid.astype(np.float64),
                                     minlength=cfg.moe.n_experts)
                actual = actual / max(actual.sum(), 1.0)

            plan, finetuned, accurate, reused = self._plan_layer(li, est,
                                                                 actual)

            with tr.span("dispatch"):
                n_total = h2.shape[0]
                cap = self._valid_capacity(int(valid.sum()), n_total)
                min_rep = int(plan.n_replicas.min())
                _, dev_plan, host_plan = self._plan_entry(plan, li)
                y = self._dispatch(gp.moe, h2, dev_plan, min_rep, cap,
                                   self._hosted(plan, li, gp.moe))
                # host mirror of the replica split (telemetry)
                rep_load = replica_token_counts(
                    idx_host, host_plan, cap, slot_capacity(cap, min_rep),
                    valid=valid, dp_shards=dp_shard_count(self.mesh, n_total),
                    route_mode=scfg.route_mode)
            lsp.set(finetuned=finetuned, reused=reused, accurate=accurate)

        met = self.obs.metrics
        met.counter("server_layers_served_total").inc()
        if finetuned:
            met.counter("server_phase2_finetunes_total").inc()
        stat = LayerStats(li, np.asarray(est), np.asarray(actual), finetuned,
                          accurate, reused,
                          plan.device_load(actual.astype(np.float32)),
                          n_tokens=int(valid.sum()),
                          replica_load=rep_load)
        return y, top1, stat

    def _plan_host_rw(self, plan: PlacementPlan) -> np.ndarray:
        host_rw = route_weights(plan)
        if self.dead_devices:
            host_rw = np.asarray(mask_dead_route_weights(
                host_rw, plan.replica_of, plan.max_pack,
                self.dead_devices), np.float32)
        return host_rw

    def _plan_entry(self, plan: PlacementPlan, layer=None):
        """(plan, device PlanArrays, host PlanArrays), cached per plan
        object: the host->device upload and the route-weight IPF happen
        once per (layer, popularity regime); so does, on a mesh, the check
        that every rank holds this plan."""
        ent = self._plan_arrays.get(id(plan))
        if ent is None or ent[0] is not plan:
            if len(self._plan_arrays) > 256:
                self._plan_arrays.clear()
            self._check_plan_agrees(plan, layer)
            host_rw = self._plan_host_rw(plan)

            def t(a):
                return torch.as_tensor(np.asarray(a), device=self.device)
            dev = PlanArrays(t(plan.slot_expert).int(),
                             t(plan.replica_of).int(),
                             t(plan.n_replicas).int(), t(host_rw).float())
            host = PlanArrays(plan.slot_expert, plan.replica_of,
                              plan.n_replicas, host_rw)
            ent = (plan, dev, host)
            self._plan_arrays[id(plan)] = ent
        return ent

    def _check_plan_agrees(self, plan: PlacementPlan, layer) -> None:
        """Raise ``PlanMismatch`` unless every rank of the mesh holds the
        same tables (one all-reduce of the checksums and their negation
        under MAX: the max and the min)."""
        if self.mesh is None or self.mesh.world == 1:
            return
        c = torch.as_tensor(_plan_checksum(plan), device=self.device)
        both = torch.cat([c, -c])
        self.mesh.all_reduce(both, self.mesh.world_group, op="max")
        hi, lo = both[:3], -both[3:]
        if not torch.equal(hi, lo):
            raise PlanMismatch(
                f"rank {self.mesh.rank}: the ranks hold different plans for "
                f"MoE layer {layer if layer is not None else '(warm-up)'}")

    def _hosted(self, plan: PlacementPlan, li: int, moe_p):
        """Layer ``li``'s hosted experts under ``plan`` on this rank; None
        where the layer reads the weights in place (no mesh, ep 1).  The
        weights are static while serving, so a layer's stack is fetched
        when its plan changes and kept for that plan only: one stack a
        layer at most."""
        if self.mesh is None or self.mesh.size(axes.EP_AXIS) == 1:
            return None
        ent = self._hosted_of.get(li)
        if ent is None or ent[0] is not plan:
            ent = (plan, fetch_hosted(moe_p, self._plan_device(plan),
                                      self.mesh))
            self._hosted_of[li] = ent
        return ent[1]

    def _plan_device(self, plan: PlacementPlan) -> PlanArrays:
        return self._plan_entry(plan)[1]

    def _group_params(self, g):
        gp = self._gp_cache.get(g)
        if gp is None:
            gp = tree_idx(self._cparams.stack, g)
            self._gp_cache[g] = gp
        return gp

    # --- serving loop -------------------------------------------------------
    def serve_batch(self, tokens: np.ndarray, lengths=None,
                    path_init: Optional[np.ndarray] = None) -> ServeResult:
        """One (micro-)batch through the full model, no cache.  tokens
        [B, S] (rows may be right-padded); lengths: [B] valid counts;
        path_init: [B, S] rolling path-ID state carried from earlier."""
        logits, stats, path_ids, _ = self._forward(tokens, lengths, path_init,
                                                   cache_len=0)
        return ServeResult(logits, stats, path_ids)

    def prefill_batch(self, tokens: np.ndarray, lengths=None,
                      path_init: Optional[np.ndarray] = None,
                      cache_len: Optional[int] = None) -> PrefillResult:
        """serve_batch + KV-cache capture sized to ``cache_len`` (>= S;
        prompt_len + max_new_tokens); the cache's ``pos`` is each row's
        valid length."""
        s = np.asarray(tokens).shape[1]
        cache_len = max(cache_len or s, s)
        if self.cfg.sliding_window and cache_len > self.cfg.sliding_window:
            raise NotImplementedError(
                "incremental decode does not support sliding-window "
                f"contexts beyond the window ({cache_len} > "
                f"{self.cfg.sliding_window})")
        logits, stats, path_ids, cache = self._forward(
            tokens, lengths, path_init, cache_len=cache_len)
        return PrefillResult(logits, stats, path_ids, cache)

    def _walk_stack(self, x, *, attn, valid, path_ids, has_state, shape):
        """The group/layer walk shared by prefill and decode: attention
        (``attn(gp, j, x) -> (x, k_j, v_j)``), dense FFN sublayers, and the
        two-phase MoE core.  Returns (x, stats, path_ids, ks, vs)."""
        cfg = self.cfg
        b, s = shape
        t = b * s
        d = x.shape[-1]
        stats: List[LayerStats] = []
        ks, vs = [], []
        moe_layer_idx = 0
        for g in range(cfg.n_layers // self.every):
            gp = self._group_params(g)
            ks_g, vs_g = [], []
            for j in range(self.every):
                x, k_j, v_j = attn(gp, j, x)
                if k_j is not None:
                    ks_g.append(k_j)
                    vs_g.append(v_j)
                h = rms_norm(x, gp.ln2[j], cfg.norm_eps)
                if j != self.every - 1:
                    x = x + lm_mod._ffn_apply(tree_idx(gp.ffn, j), h,
                                              cfg.ffn_type)
                    continue
                y, top1, stat = self._serve_moe(moe_layer_idx, gp,
                                                h.reshape(t, d), valid,
                                                path_ids, has_state=has_state)
                moe_y = y.reshape(b, s, d)
                if gp.shared is not None:
                    moe_y = moe_y + lm_mod._ffn_apply(gp.shared, h,
                                                      cfg.ffn_type)
                x = x + moe_y
                stats.append(stat)
                path_ids = (path_ids * cfg.moe.n_experts + top1) \
                    % self.profile.n_buckets
                moe_layer_idx += 1
            if ks_g:
                ks.append(torch.stack(ks_g))
                vs.append(torch.stack(vs_g))
        return x, stats, path_ids, ks, vs

    def _embed(self, tokens: np.ndarray):
        ids = torch.as_tensor(np.asarray(tokens, np.int64),
                              device=self.device)
        return self._cparams.embed[ids].to(self._dtype)

    def _forward(self, tokens, lengths, path_init, *, cache_len: int):
        """Full-sequence forward; captures an LMCache when cache_len > 0."""
        cfg = self.cfg
        tokens = np.asarray(tokens)
        b, s = tokens.shape
        if lengths is None:
            lengths = np.full((b,), s, np.int64)
        lengths = np.asarray(lengths, np.int64)
        x = self._embed(tokens)
        valid = (np.arange(s)[None, :] < lengths[:, None]).reshape(b * s)
        path_ids = np.zeros((b * s,), np.int64) if path_init is None \
            else np.asarray(path_init, np.int64).reshape(b * s)

        def attn(gp, j, x):
            x, k_j, v_j = self._attn(gp, j, x)
            if not cache_len:
                return x, None, None
            pad = cache_len - s
            if pad:
                k_j = F.pad(k_j, (0, 0, 0, 0, 0, pad))
                v_j = F.pad(v_j, (0, 0, 0, 0, 0, pad))
            return x, k_j, v_j

        x, stats, path_ids, ks, vs = self._walk_stack(
            x, attn=attn, valid=valid, path_ids=path_ids,
            has_state=False, shape=(b, s))
        x = rms_norm(x, self._cparams.final_norm, cfg.norm_eps)
        last = torch.as_tensor(np.maximum(lengths - 1, 0), device=self.device)
        x_last = x[torch.arange(b, device=self.device), last]
        logits = _host(x_last @ self._w_unembed)
        cache = None
        if cache_len:
            kv = KVCache(torch.stack(ks), torch.stack(vs))
            cache = LMCache(kv=kv, mamba=None, rwkv=None,
                            pos=torch.as_tensor(lengths, dtype=torch.int32,
                                                device=self.device))
        return logits, stats, path_ids.reshape(b, s), cache

    def decode_batch(self, tokens, cache: LMCache, path_state,
                     valid=None) -> DecodeResult:
        """One incremental decode step: ONE token per in-flight request.
        tokens: [B]; cache: from prefill_batch / decode_batch (kv [G, every,
        B, S_cap, KV, hd], pos [B]); path_state: [B] rolling path state;
        valid: [B] bool, False rows are batch padding."""
        cfg = self.cfg
        tokens = np.asarray(tokens).reshape(-1)
        b = tokens.shape[0]
        valid = np.ones((b,), bool) if valid is None \
            else np.asarray(valid, bool)
        path_ids = np.asarray(path_state, np.int64).reshape(b).copy()
        x = self._embed(tokens)[:, None]                         # [B, 1, d]
        pos = cache.pos
        group = [0]   # layer-group cursor for the attn closure

        def attn(gp, j, x):
            g = group[0]
            x, k_j, v_j = self._attn_dec(gp, j, x, cache.kv.k[g, j],
                                         cache.kv.v[g, j], pos)
            if j == self.every - 1:
                group[0] += 1
            return x, k_j, v_j

        x, stats, path_ids, ks, vs = self._walk_stack(
            x, attn=attn, valid=valid, path_ids=path_ids,
            has_state=True, shape=(b, 1))
        x = rms_norm(x, self._cparams.final_norm, cfg.norm_eps)
        logits = _host(x[:, 0] @ self._w_unembed)
        new_cache = LMCache(kv=KVCache(torch.stack(ks), torch.stack(vs)),
                            mamba=None, rwkv=None, pos=pos + 1)
        return DecodeResult(logits, stats, path_ids, new_cache)


def profile_from_training(cfg: ModelConfig, params, batches,
                          path_len: int = 3, device="cuda",
                          mesh=None) -> PathProfile:
    """Profiling stage (§5.2): replay data through the model, collect
    per-layer top-1 expert choices, accumulate Ψ tables.  The replay is
    the training stack's forward with ``lina=False`` (``lm.run_stack``,
    plain attention, no loss).  With ``mesh`` (``params`` the full model,
    as ``MoEServer`` takes it) every rank replays the whole batch, the
    MoE layers expert parallel on the reference's token shard, so every
    rank gets the same profile."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    prof = PathProfile(n_layers=cfg.n_moe_layers,
                       n_experts=cfg.moe.n_experts, path_len=path_len)
    params = tree_map(lambda a: a.to(dev), params)
    layout = None if mesh is None else \
        shard_mod.expert_layout(mesh, params, "prefill")
    p = lm_mod.cast_for_compute(cfg, shard_params(
        params, mesh, None if layout is None else layout.specs))
    with torch.inference_mode():
        for batch in batches:
            tokens = torch.as_tensor(np.asarray(batch["tokens"]), device=dev)
            x = p.embed[tokens.long()].to(lm_mod.DTYPES[cfg.dtype])
            choices = lm_mod.run_stack(cfg, p.stack, x, lina=False,
                                       layout=layout)[2]
            prof.profile_batch(choices.cpu().numpy())
    return prof
