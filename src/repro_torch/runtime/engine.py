"""Continuous-batching front end for the two-phase MoE server (§5/§6.2),
ported to PyTorch (host-side logic as in the reference).

Requests enter a FIFO queue with arrival timestamps and a
``max_new_tokens`` generation budget, then move through a lifecycle:

    queued -> prefill -> decoding -> done

Each engine step forms a micro-batch under a shared token budget that MIXES
the two phases: in-flight decodes cost one token each and are admitted
first (they are the latency-bound regime Lina's §5 targets), and the
remaining budget admits newly queued prefills FCFS.  Prefills run through
``MoEServer.prefill_batch`` — the plan-honoring distributed dispatch with a
cross-batch PlanCache — which returns last-token logits plus a KV cache;
the engine then parks each generating request in a *decode slot* that
persists its per-request KV cache and rolling path-ID state across steps,
and subsequent steps drive ``MoEServer.decode_batch`` one token at a time.
A request with ``max_new_tokens == 0`` completes at prefill with its
last-prompt logits (score-only mode).

Gating capacity is sized from *valid* tokens (see
``MoEServer._valid_capacity``), so bucket padding never changes a real
request's dispatch.  Each request's rolling path-ID state is kept (bounded)
after completion: submitting a follow-up with ``prev_rid`` seeds the next
request's popularity estimation from where the last one left off.  States
of still-active (mid-decode) requests are pinned and never evicted.

Latency accounting supports both wall-clock serving (``submit`` stamps
arrivals from the engine clock) and open-loop trace replay (``simulate``):
virtual arrival times drive queueing delay while the measured wall time of
each step drives service time.  On a server with a multi-rank mesh every
rank runs the same engine on the same trace; a step's service time is the
max over the ranks (what one SPMD step that waits on every device
measures), so every rank stamps the same completions.  Wall-clock serving
there needs a request router and raises.  Per-request TTFT (time of the first
generated token) and completion times support time-per-output-token
reporting.
"""
from __future__ import annotations

import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.attention import KVCache
from repro_torch.models.lm import LMCache
from repro_torch.obs import ObsContext
from repro_torch.obs.tracer import Span
from repro_torch.runtime.server import LayerStats, MoEServer, agree_max


@dataclass
class EngineConfig:
    max_batch_tokens: int = 1024   # token budget per micro-batch
    max_batch_requests: int = 16   # row cap per micro-batch (each phase)
    pad_to_pow2: bool = True       # bucket batch rows to powers of two
    state_cache: int = 4096        # completed path states kept for follow-ups
    stats_window: int = 4096       # LayerStats retained for metrics
    # admission control: overload degrades to explicit
    # rejections / deadline sheds instead of unbounded queueing latency
    max_queue: int = 0             # queue-depth cap; submit returns -1 when
    #                                full (0 = unbounded, legacy behavior)
    deadline_s: float = 0.0        # shed queued (never mid-decode) requests
    #                                older than this at step start (0 = off)


@dataclass(frozen=True)
class ShedRecord:
    """One explicitly refused request — the accounting that distinguishes
    load shedding from silent loss (chaos suite invariant: every offered
    request is completed or lands here)."""
    rid: int                       # -1: rejected before an id was assigned
    arrival: float
    time: float                    # when the engine gave up on it
    reason: str                    # "deadline" | "rejected"


@dataclass
class Request:
    rid: int
    tokens: np.ndarray                       # [S] token ids
    arrival: float                           # queue-entry timestamp
    path_state: Optional[np.ndarray] = None  # [S] rolling path ids
    max_new_tokens: int = 0                  # 0 => score-only (no decode)


@dataclass
class DecodeSlot:
    """Per-request state persisted across decode steps: the KV cache slice
    owned by this request plus its rolling path-ID state.  While the decode
    batch's membership is stable the engine keeps the whole *batched* cache
    resident and slots only hold a (batch, row) reference; the per-request
    slice is materialized lazily when the batch has to be rebuilt."""
    rid: int
    arrival: float
    prompt_len: int
    max_new_tokens: int
    cap: int                                 # cache capacity (time slots)
    kv_k: object                             # [G, every, S_cap, KV, hd]|None
    kv_v: object
    pos: int                                 # next cache slot / abs position
    path_scalar: int                         # most recent token's path hash
    path_history: List[int]                  # per-token rolling states
    gen_tokens: List[int]                    # generated token ids
    ttft: float                              # completion time of first token
    batch_ref: Optional[object] = None       # LMCache holding this row
    batch_row: int = 0

    def materialize(self):
        """Own KV slice, pulling it out of the batched cache if needed."""
        if self.batch_ref is not None:
            kv = self.batch_ref.kv
            self.kv_k = kv.k[:, :, self.batch_row, :self.cap]
            self.kv_v = kv.v[:, :, self.batch_row, :self.cap]
            self.batch_ref = None
        return self.kv_k, self.kv_v


@dataclass
class RequestResult:
    rid: int
    logits: np.ndarray                       # [V] logits of the last step
    arrival: float
    completion: float
    n_tokens: int                            # prompt length
    tokens: Optional[np.ndarray] = None      # generated ids (None: score-only)
    ttft: Optional[float] = None             # first-token completion time

    @property
    def latency(self) -> float:
        return self.completion - self.arrival

    @property
    def n_generated(self) -> int:
        return 0 if self.tokens is None else int(len(self.tokens))

    @property
    def ttft_latency(self) -> Optional[float]:
        return None if self.ttft is None else self.ttft - self.arrival

    @property
    def tpot(self) -> Optional[float]:
        """Time per output token over the decode phase (excludes prefill)."""
        if self.ttft is None or self.n_generated < 2:
            return None
        return (self.completion - self.ttft) / (self.n_generated - 1)


class ServingEngine:
    """Queue -> prefill/decode micro-batches -> plan-cached dispatch."""

    def __init__(self, server: MoEServer, ecfg: Optional[EngineConfig] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 scheduler=None,
                 service_model: Optional[Callable] = None,
                 fault_injector=None,
                 obs: Optional[ObsContext] = None):
        """``scheduler`` is a ``repro_torch.sched.AdaptiveScheduler``: after
        each micro-batch the engine feeds it the step's LayerStats and
        served token count, and controller-published plans take effect from
        the next micro-batch (decode state survives the swap).

        ``service_model`` maps (step LayerStats list, n_tokens) -> modeled
        seconds of distributed service time added on top of the measured
        wall time in virtual-clock replay (``step(now=...)``), where
        per-device load imbalance, invisible to one card's wall time, slows
        the step.  Ignored in wall-clock mode.

        ``fault_injector`` is a ``repro_torch.resilience.FaultInjector``:
        called at each step start (fault firing) and between the step's
        stats and the scheduler (telemetry corruption).

        ``obs`` is a ``repro_torch.obs.ObsContext``.  The serving stack
        shares ONE context: passing it here also installs it on the server;
        omitting it inherits the server's."""
        self.server = server
        if obs is not None:
            self.obs = obs
            server.obs = obs
            # a scheduler built before this engine captured the server's
            # previous registry: re-point its bus at the shared one
            bus = getattr(scheduler, "bus", None)
            if bus is not None and bus.metrics is not None:
                bus.metrics = obs.metrics
        else:
            self.obs = getattr(server, "obs", None) or ObsContext.disabled()
        # open request-lifecycle spans by rid (tracer enabled only)
        self._req_spans: Dict[int, Span] = {}
        self.ecfg = ecfg or EngineConfig()
        self.clock = clock
        self.step_idx = 0
        self.n_submitted = 0
        self.n_rejected = 0
        self.shed_records: List[ShedRecord] = []
        self._step_stats: List[LayerStats] = []
        self._queue: Deque[Request] = deque()
        self._active: "OrderedDict[int, DecodeSlot]" = OrderedDict()
        self._path_states: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self._next_rid = 0
        self.layer_stats: Deque[LayerStats] = deque(
            maxlen=self.ecfg.stats_window)
        self.scheduler = scheduler
        self.service_model = service_model
        self.fault_injector = fault_injector
        if fault_injector is not None:
            fault_injector.attach(self)
        self._finetunes = 0
        self._layers_served = 0
        self.last_step_end: Optional[float] = None   # stamp of the last step
        # (rids, LMCache) of the last decode batch: reused verbatim while
        # the batch membership is unchanged, so steady-state decoding does
        # not re-pad/re-stack every request's cache each token
        self._dec_batch: Optional[tuple] = None

    # --- queueing -----------------------------------------------------------
    def submit(self, tokens, arrival: Optional[float] = None,
               prev_rid: Optional[int] = None,
               max_new_tokens: int = 0) -> int:
        """Enqueue one request; returns its id.  ``prev_rid`` names an
        earlier request of the same stream: the new request seeds its
        rolling path-ID state from that request's final state.
        ``max_new_tokens > 0`` turns the request into a generation request
        that decodes incrementally through the KV cache after prefill.

        With ``EngineConfig.max_queue`` set, a full queue REJECTS the
        request: returns -1 (no id is consumed) and counts it in
        ``n_rejected`` — explicit backpressure the caller can retry on
        (see ``simulate``'s retry-with-backoff client)."""
        if self.ecfg.max_queue and len(self._queue) >= self.ecfg.max_queue:
            self.n_rejected += 1
            self.obs.metrics.counter("engine_requests_rejected_total").inc()
            return -1
        tokens = np.asarray(tokens).reshape(-1)
        rid = self._next_rid
        self._next_rid += 1
        self.n_submitted += 1
        self.obs.metrics.counter("engine_requests_offered_total").inc()
        state = None if prev_rid is None else self.request_path_state(prev_rid)
        req = Request(rid, tokens,
                      self.clock() if arrival is None else arrival,
                      path_state=state, max_new_tokens=int(max_new_tokens))
        self._queue.append(req)
        tr = self.obs.tracer
        if tr.enabled:
            root = tr.begin("request", start=req.arrival, rid=rid,
                            n_tokens=int(tokens.shape[0]),
                            max_new_tokens=int(max_new_tokens))
            root.begin_child("queued", req.arrival)
            self._req_spans[rid] = root
        return rid

    def record_shed(self, rid: int, arrival: float, time: float,
                    reason: str) -> None:
        self.shed_records.append(ShedRecord(rid, arrival, time, reason))
        met = self.obs.metrics
        met.counter("engine_requests_shed_total", reason=reason).inc()
        if rid < 0:
            # a give-up after retries never got an id, so it was never
            # counted at submit — count it here to keep the ledger closed:
            # offered == completed + shed
            met.counter("engine_requests_offered_total").inc()
        root = self._req_spans.pop(rid, None)
        if root is not None:
            for c in root.children:          # close the open queued phase
                if c.name == "queued" and c.end != c.end:
                    c.end_at(time)
            root.end_at(time, outcome=f"shed:{reason}")

    def _shed_expired(self, now: float) -> None:
        """Deadline-based load shedding: drop QUEUED requests whose wait
        already exceeds ``deadline_s`` (mid-decode requests are never shed
        — their slot state is paid for).  Every drop is recorded, never
        silent."""
        dl = self.ecfg.deadline_s
        if not dl:
            return
        kept: Deque[Request] = deque()
        for req in self._queue:
            if now - req.arrival > dl:
                self.record_shed(req.rid, req.arrival, now, "deadline")
            else:
                kept.append(req)
        self._queue = kept

    def pending(self) -> int:
        return len(self._queue)

    def active(self) -> int:
        return len(self._active)

    def has_work(self) -> bool:
        return bool(self._queue or self._active)

    def request_path_state(self, rid: int) -> Optional[np.ndarray]:
        for req in self._queue:             # still waiting: pre-step state
            if req.rid == rid:
                return req.path_state
        slot = self._active.get(rid)        # mid-decode: state so far
        if slot is not None:
            return np.asarray(slot.path_history, np.int64)
        return self._path_states.get(rid)

    # --- micro-batch formation ---------------------------------------------
    def _form_microbatch(self, budget: Optional[int] = None,
                         gen_slots: Optional[int] = None) -> List[Request]:
        """FCFS under the token budget; always admits the queue head so an
        over-budget single request still makes progress (unless decodes
        already consumed the whole budget: ``budget <= 0``).  Generating
        requests are additionally admitted only while free decode slots
        remain (``gen_slots``, default ``max_batch_requests - active``) —
        the continuous-batching backpressure that bounds the in-flight KV
        working set; FCFS order is preserved, so a blocked generating head
        also holds back later arrivals."""
        ecfg = self.ecfg
        batch: List[Request] = []
        budget = ecfg.max_batch_tokens if budget is None else budget
        if gen_slots is None:
            gen_slots = max(0, ecfg.max_batch_requests - len(self._active))
        admit_head = budget > 0
        while self._queue and len(batch) < ecfg.max_batch_requests:
            nxt = self._queue[0]
            cost = nxt.tokens.shape[0]
            if cost > budget and not (admit_head and not batch):
                break
            if nxt.max_new_tokens > 1:
                if gen_slots <= 0:
                    break               # no decode slot free: FCFS waits
                gen_slots -= 1
            batch.append(self._queue.popleft())
            budget -= cost
        return batch

    @staticmethod
    def _bucket_rows(n: int) -> int:
        return 1 << (n - 1).bit_length()

    def _remember_state(self, rid: int, state: np.ndarray) -> None:
        self._path_states[rid] = np.asarray(state)
        self._path_states.move_to_end(rid)
        excess = len(self._path_states) - self.ecfg.state_cache
        if excess <= 0:
            return
        for old in list(self._path_states):
            if excess <= 0:
                break
            if old in self._active:          # never drop mid-decode state
                continue
            del self._path_states[old]
            excess -= 1

    # --- serving ------------------------------------------------------------
    def step(self, now: Optional[float] = None, time_scale: float = 1.0
             ) -> List[RequestResult]:
        """Serve one micro-batch: all in-flight decodes (one token each,
        admitted first) plus newly queued prefills under the remaining
        token budget.  Returns requests completed this step (possibly
        empty while generation is in flight).  With ``now`` given,
        completions are stamped ``now + wall_service * time_scale``
        (virtual-clock replay); otherwise from the engine clock."""
        ecfg = self.ecfg
        mesh = self.server.mesh
        if now is None and mesh is not None and mesh.world > 1:
            raise NotImplementedError(
                "wall-clock serving on a multi-rank mesh needs a request "
                "router that feeds every rank the same requests; replay a "
                "trace with simulate()")
        self.step_idx += 1
        t_now = self.clock() if now is None else now
        if self.fault_injector is not None:
            # faults fire before batch formation: an overload burst's
            # requests are admissible this step, a device failure degrades
            # this step's routing
            self.fault_injector.on_step(self, t_now)
        self._shed_expired(t_now)
        decodes = list(self._active.values())[:ecfg.max_batch_requests]
        decodes = decodes[:ecfg.max_batch_tokens]
        prefills = self._form_microbatch(
            budget=ecfg.max_batch_tokens - len(decodes))
        if not decodes and not prefills:
            self.last_step_end = None
            return []

        self._step_stats = []
        tr = self.obs.tracer
        # Three measured service phases (the TTFT decomposition): time spent
        # behind the decode batch is queueing, the prefill forward is
        # prefill, and slot insertion / first-token argmax is insert.  The
        # stopwatches always run (their sum is the service-time stamp);
        # span recording rides on the explicit-timestamp layout below so
        # spans land on the SAME clock as completions (virtual in replay).
        with tr.timed("decode", record=False) as sw_dec:
            dec_res = self._run_decodes(decodes) if decodes else None
        with tr.timed("prefill", record=False) as sw_pre:
            pre_parts = self._run_prefills(prefills) if prefills else []
        n_tokens = len(decodes) + sum(r.tokens.shape[0] for r in prefills)
        extra = 0.0
        if now is not None and self.service_model is not None:
            extra = float(self.service_model(self._step_stats, n_tokens))

        # Finish with a NaN placeholder stamp while the insert phase is
        # still being measured (its wall time is part of the service that
        # determines the stamp), then patch every stamp minted this step.
        pending = float("nan")
        out: List[RequestResult] = []
        with tr.timed("insert", record=False) as sw_ins:
            if dec_res is not None:
                out.extend(self._finish_decodes(decodes, dec_res, pending))
            for group, res in pre_parts:
                out.extend(self._finish_prefills(group, res, pending))
        # on a mesh the step ends when its slowest rank does: every rank
        # stamps that, so the virtual clock, admission and shedding agree
        service = agree_max(mesh, sw_dec.dt + sw_pre.dt + sw_ins.dt)
        if now is None:
            completion = self.clock()
        else:
            completion = now + service * time_scale + extra
        self.last_step_end = completion
        for r in out:
            r.completion = completion
            if r.ttft is not None and r.ttft != r.ttft:
                r.ttft = completion          # first token minted this step
        for slot in self._active.values():
            if slot.ttft != slot.ttft:
                slot.ttft = completion
        scale = 1.0 if now is None else time_scale
        self._observe_step(t_now, completion, scale, extra,
                           (sw_dec.dt, sw_pre.dt), decodes, pre_parts, out)
        if self.scheduler is not None:
            # between micro-batches: feed telemetry, maybe publish plans —
            # they apply from the NEXT step, never mid-batch.  The injector
            # corrupts the observed stats here (telemetry faults poison the
            # control loop's view, not the actual serving math).
            stats = self._step_stats
            if self.fault_injector is not None:
                stats = self.fault_injector.filter_stats(stats)
            self.scheduler.after_step(stats, n_tokens)
        return out

    # --- observability ------------------------------------------------------
    def _observe_step(self, t_now, completion, scale, extra, walls,
                      decodes, pre_parts, out) -> None:
        """Publish the step into the obs context: registry metrics always,
        span trees only when the tracer is enabled.  Phase boundaries are
        laid out on the completion clock (virtual during replay):
        ``[t_now, t_dec_end, t_pre_end, completion]`` — so for a request
        prefilled this step, queue + prefill + insert == TTFT exactly."""
        wall_dec, wall_pre = walls
        t_dec_end = t_now + wall_dec * scale
        t_pre_end = t_dec_end + wall_pre * scale + extra
        met = self.obs.metrics
        met.counter("engine_steps_total").inc()
        met.histogram("engine_step_service_s").observe(completion - t_now)
        if decodes:
            # TPOT by decode occupancy: the decode phase advances every
            # in-flight request one token, so its duration IS this step's
            # time-per-output-token at that occupancy
            occ = self._bucket_rows(len(decodes))
            met.histogram("engine_decode_step_s",
                          occupancy=str(occ)).observe(t_dec_end - t_now)
        prefilled = [r for group, _res in pre_parts for r in group]
        for r in prefilled:
            if r.max_new_tokens >= 1:
                met.histogram("engine_ttft_s").observe(completion - r.arrival)
                met.histogram("engine_ttft_queue_s").observe(
                    t_dec_end - r.arrival)
                met.histogram("engine_ttft_prefill_s").observe(
                    t_pre_end - t_dec_end)
                met.histogram("engine_ttft_insert_s").observe(
                    completion - t_pre_end)
        for r in out:
            if r.tpot is not None:
                met.histogram("engine_tpot_s").observe(r.tpot)
        if out:
            met.counter("engine_requests_completed_total").inc(len(out))
        if self.obs.tracer.enabled:
            self._trace_step(t_now, t_dec_end, t_pre_end, completion,
                             decodes, prefilled, out)

    def _trace_step(self, t_now, t_dec_end, t_pre_end, completion,
                    decodes, prefilled, out) -> None:
        """Span trees for one step: an ``engine.step`` root with the three
        phase children, plus per-request lifecycle updates (decode-step
        ticks, the queued→prefill→insert TTFT decomposition, completion)."""
        tr = self.obs.tracer
        sp = tr.add("engine.step", t_now, completion, step=self.step_idx,
                    decodes=len(decodes), prefills=len(prefilled))
        sp.child("decode", t_now, t_dec_end, n=len(decodes))
        sp.child("prefill", t_dec_end, t_pre_end, n=len(prefilled))
        sp.child("insert", t_pre_end, completion)
        for slot in decodes:
            root = self._req_spans.get(slot.rid)
            if root is not None:
                root.child("decode_step", t_now, t_dec_end,
                           step=self.step_idx)
        for r in prefilled:
            root = self._req_spans.get(r.rid)
            if root is None:
                continue
            for c in root.children:
                if c.name == "queued" and c.end != c.end:
                    c.end_at(t_dec_end)
            root.child("prefill", t_dec_end, t_pre_end)
            root.child("insert", t_pre_end, completion)
            root.set(queue_s=t_dec_end - root.start,
                     prefill_s=t_pre_end - t_dec_end,
                     insert_s=completion - t_pre_end)
            if r.max_new_tokens >= 1:
                root.set(ttft_s=completion - root.start)
        for r in out:
            root = self._req_spans.pop(r.rid, None)
            if root is not None:
                root.end_at(completion, outcome="done")

    # --- decode phase -------------------------------------------------------
    def _run_decodes(self, slots: List[DecodeSlot]):
        rids = tuple(s.rid for s in slots)
        if self._dec_batch is not None and self._dec_batch[0] == rids:
            cache = self._dec_batch[1]       # pos already advanced inside
            b = cache.kv.k.shape[2]
        else:
            b_real = len(slots)
            b = self._bucket_rows(b_real) if self.ecfg.pad_to_pow2 else b_real
            s_max = max(s.cap for s in slots)

            def pad_kv(a, cap):
                if cap < s_max:
                    a = F.pad(a, (0, 0, 0, 0, 0, s_max - cap))
                return a

            ks, vs = [], []
            for s in slots:
                k, v = s.materialize()
                ks.append(pad_kv(k, s.cap))
                vs.append(pad_kv(v, s.cap))
            for _ in range(b - b_real):
                ks.append(torch.zeros_like(ks[0]))
                vs.append(torch.zeros_like(vs[0]))
            kv = KVCache(torch.stack(ks, dim=2), torch.stack(vs, dim=2))
            pos = np.zeros((b,), np.int32)
            for i, s in enumerate(slots):
                pos[i] = s.pos
            cache = LMCache(kv=kv, mamba=None, rwkv=None,
                            pos=torch.as_tensor(pos, device=kv.k.device))
        tokens = np.zeros((b,), np.int64)
        path = np.zeros((b,), np.int64)
        valid = np.zeros((b,), bool)
        for i, s in enumerate(slots):
            tokens[i] = s.gen_tokens[-1]
            path[i] = s.path_scalar
            valid[i] = True
        res = self.server.decode_batch(tokens, cache, path, valid=valid)
        self._record_stats(res.stats)
        self._dec_batch = (rids, res.cache)
        return res

    def _finish_decodes(self, slots, res, completion) -> List[RequestResult]:
        out = []
        done = False
        for i, slot in enumerate(slots):
            nxt = int(np.argmax(res.logits[i]))
            slot.gen_tokens.append(nxt)
            slot.path_scalar = int(res.path_state[i])
            slot.path_history.append(slot.path_scalar)
            slot.pos += 1
            slot.kv_k = slot.kv_v = None     # row lives in the batched cache
            slot.batch_ref = res.cache
            slot.batch_row = i
            if len(slot.gen_tokens) >= slot.max_new_tokens:
                out.append(self._complete_slot(slot, res.logits[i],
                                               completion))
                done = True
        if done:                 # membership changes: next step re-stacks
            self._dec_batch = None
        return out

    def _complete_slot(self, slot: DecodeSlot, logits,
                       completion: float) -> RequestResult:
        del self._active[slot.rid]
        self._remember_state(slot.rid,
                             np.asarray(slot.path_history, np.int64))
        return RequestResult(slot.rid, np.asarray(logits), slot.arrival,
                             completion, slot.prompt_len,
                             tokens=np.asarray(slot.gen_tokens, np.int64),
                             ttft=slot.ttft)

    # --- prefill phase ------------------------------------------------------
    def _assemble(self, batch: List[Request]):
        b_real = len(batch)
        b = self._bucket_rows(b_real) if self.ecfg.pad_to_pow2 else b_real
        s = max(r.tokens.shape[0] for r in batch)
        tokens = np.zeros((b, s), np.int64)
        lengths = np.zeros((b,), np.int64)
        path_init = np.zeros((b, s), np.int64)
        for i, r in enumerate(batch):
            n = r.tokens.shape[0]
            tokens[i, :n] = r.tokens
            lengths[i] = n
            if r.path_state is not None:
                m = min(n, r.path_state.shape[0])
                path_init[i, :m] = r.path_state[:m]
        return tokens, lengths, path_init

    def _run_prefills(self, batch: List[Request]):
        """Score-only rows (max_new_tokens <= 1: no decode cache needed)
        and generating rows run as separate forwards, so a long score-only
        prompt never inflates — or, under a sliding window, invalidates —
        the generating rows' cache allocation.  Returns (group, result)
        pairs."""
        gen = [r for r in batch if r.max_new_tokens > 1]
        score = [r for r in batch if r.max_new_tokens <= 1]
        parts = []
        if score:
            tokens, lengths, path_init = self._assemble(score)
            res = self.server.serve_batch(tokens, lengths=lengths,
                                          path_init=path_init)
            self._record_stats(res.stats)
            parts.append((score, res))
        if gen:
            tokens, lengths, path_init = self._assemble(gen)
            cache_len = max(r.tokens.shape[0] + r.max_new_tokens for r in gen)
            res = self.server.prefill_batch(tokens, lengths=lengths,
                                            path_init=path_init,
                                            cache_len=cache_len)
            self._record_stats(res.stats)
            parts.append((gen, res))
        return parts

    def _finish_prefills(self, batch, res,
                         completion) -> List[RequestResult]:
        out = []
        for i, r in enumerate(batch):
            n = r.tokens.shape[0]
            path_row = np.asarray(res.path_ids[i, :n])
            if r.max_new_tokens <= 0:
                self._remember_state(r.rid, path_row.copy())
                out.append(RequestResult(r.rid, res.logits[i], r.arrival,
                                         completion, n))
                continue
            first = int(np.argmax(res.logits[i]))
            if r.max_new_tokens == 1:
                self._remember_state(r.rid, path_row.copy())
                out.append(RequestResult(
                    r.rid, res.logits[i], r.arrival, completion, n,
                    tokens=np.asarray([first], np.int64), ttft=completion))
                continue
            cap = n + r.max_new_tokens
            slot = DecodeSlot(
                rid=r.rid, arrival=r.arrival, prompt_len=n,
                max_new_tokens=r.max_new_tokens, cap=cap,
                kv_k=None, kv_v=None,
                pos=n, path_scalar=int(path_row[-1]),
                path_history=[int(p) for p in path_row],
                gen_tokens=[first], ttft=completion,
                batch_ref=res.cache, batch_row=i)
            self._active[r.rid] = slot
            # pin the prompt's path state so follow-ups submitted while the
            # stream is still decoding can branch from it
            self._remember_state(r.rid, path_row.copy())
        return out

    def _record_stats(self, stats) -> None:
        self.layer_stats.extend(stats)
        self._step_stats.extend(stats)
        self._finetunes += sum(s.finetuned for s in stats)
        self._layers_served += len(stats)

    # --- warm-up ------------------------------------------------------------
    def warmup(self, seqs=(), max_new_tokens: int = 8,
               min_replicas_grid=(1, 2)) -> int:
        """Build and launch every kernel before traffic arrives: full
        prefill + decode at each prompt length in ``seqs`` and the
        plan-honoring dispatch over every decode row bucket up to
        ``max_batch_requests`` x ``min_replicas_grid``.  Returns the number
        of warm-up calls."""
        rows = range(1, self.ecfg.max_batch_requests + 1)
        return self.server.warmup(seqs=seqs, rows=rows,
                                  min_replicas_grid=min_replicas_grid,
                                  max_new_tokens=max_new_tokens)

    def run(self) -> List[RequestResult]:
        """Drain queue AND in-flight generation in wall-clock mode."""
        results: List[RequestResult] = []
        while self.has_work():
            results.extend(self.step())
        return results

    # --- metrics ------------------------------------------------------------
    @property
    def plan_reuse_rate(self) -> float:
        cache = self.server.plan_cache
        return cache.stats.reuse_rate if cache is not None else 0.0

    @property
    def finetune_rate(self) -> float:
        return self._finetunes / self._layers_served \
            if self._layers_served else 0.0


def summarize_results(results: List[RequestResult],
                      engine: Optional[ServingEngine] = None) -> dict:
    """Latency / TTFT / time-per-output-token percentiles (seconds) and
    decode throughput over a completed result set — the one summarization
    shared by the serve driver, the example, and the traffic benchmark.
    Pass ``engine`` to also surface its admission-control ledger (shed /
    rejected counts)."""
    lat = np.array([r.latency for r in results])
    ttft = np.array([r.ttft_latency for r in results
                     if r.ttft_latency is not None])
    tpot = np.array([r.tpot for r in results if r.tpot is not None])
    n_gen = sum(r.n_generated for r in results)
    span = (max(r.completion for r in results) -
            min(r.arrival for r in results)) if results else 0.0
    pct = lambda a, q: float(np.percentile(a, q)) if a.size else float("nan")
    out = {
        "n": len(results),
        "latency_p50": pct(lat, 50), "latency_p95": pct(lat, 95),
        "ttft_p50": pct(ttft, 50), "ttft_p95": pct(ttft, 95),
        "tpot_p50": pct(tpot, 50), "tpot_p95": pct(tpot, 95),
        "gen_tokens": n_gen,
        "gen_tok_s": n_gen / span if span > 0 else 0.0,
    }
    if engine is not None:
        shed = engine.shed_records
        out["shed_deadline"] = sum(s.reason == "deadline" for s in shed)
        out["shed_rejected"] = sum(s.reason == "rejected" for s in shed)
        out["rejected_submits"] = engine.n_rejected
        out["submitted"] = engine.n_submitted
    return out


def simulate(engine: ServingEngine, requests, time_scale: float = 1.0,
             max_new_tokens: int = 0, retry_backoff_s: float = 0.0,
             max_retries: int = 3,
             on_step: Optional[Callable] = None) -> List[RequestResult]:
    """Open-loop trace replay: ``requests`` is an iterable of
    (tokens, arrival_time) virtual-time pairs.  Queueing delay comes from
    the virtual clock; service time is the measured wall time of each step
    scaled by ``time_scale``.  With ``max_new_tokens > 0`` every request
    generates that many tokens through the incremental-decode path, and a
    request's latency spans prefill + all its decode steps.  Returns
    per-request results whose ``latency`` mixes both — the standard
    open-loop p50/p95 methodology.

    With ``retry_backoff_s`` set the client half of admission control
    engages: a rejected submit (queue full, -1) is re-attempted at
    ``arrival + backoff * 2^attempt`` up to ``max_retries`` times, after
    which the give-up is recorded on the engine's shed ledger — offered
    traffic is always accounted completed, shed, or rejected, never lost.
    ``on_step(engine, vclock, done)`` is called after every engine step
    (chaos-benchmark probe for per-step recovery tracking)."""
    trace = [(np.asarray(tok).reshape(-1), float(at), 0)
             for tok, at in requests]
    trace.sort(key=lambda p: p[1])
    pending = deque(trace)
    vclock = 0.0
    results: List[RequestResult] = []
    while pending or engine.has_work():
        if pending and not engine.has_work():
            vclock = max(vclock, pending[0][1])     # idle until next arrival
        retries = []
        while pending and pending[0][1] <= vclock:
            tok, at, attempt = pending.popleft()
            rid = engine.submit(tok, arrival=at, max_new_tokens=max_new_tokens)
            if rid >= 0:
                continue
            if retry_backoff_s > 0 and attempt < max_retries:
                retries.append((tok, at + retry_backoff_s * 2 ** attempt,
                                attempt + 1))
            else:
                engine.record_shed(-1, at, vclock, "rejected")
        if retries:
            pending.extend(retries)
            pending = deque(sorted(pending, key=lambda p: p[1]))
        done = engine.step(now=vclock, time_scale=time_scale)
        if engine.last_step_end is not None:
            vclock = max(vclock, engine.last_step_end)  # one stamp per batch
        elif pending:
            vclock = max(vclock, pending[0][1])     # nothing ran: skip ahead
        results.extend(done)
        if on_step is not None:
            on_step(engine, vclock, done)
    return results
