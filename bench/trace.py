"""The traced run's capture: one ``torch.profiler`` session (CPU and CUDA
activity) over a few steady steps, checked before any device metric is
read from it, and the records the per-layer metrics read.

``Instrument`` wraps entry points of the program in ``record_function``
ranges named ``bench.<entry>`` and notes each call's work (from its
shapes, by ``yardstick.roofline``); it is installed in traced runs only.
A kernel belongs to a range when the CPU event that launched it lies
inside that range (the profiler's parent links); an entry's roofline
reads the device time of its own kernels, which no other entry launches.
``Capture`` opens the
session, discards a warm-up cycle (a session can lose the first events
it traces), and after the active steps keeps the session only when each
of the port's kernels shows as many events as its wrappers' launch
counters rose and the device's busy time fits in the window; else it
raises ``CaptureLost`` and the run reports no device metric.
"""
from __future__ import annotations

import time
from collections import defaultdict

from bench.yardstick import kernels as K
from bench.yardstick import roofline as R

# autograd nodes of the MoE layer's own Functions (their backward kernels)
MOE_BACKWARD = ("_GroupedFFNBackward", "_TopkGatingBackward",
                "_DispatchBackward", "_CombineBackward",
                "_ExpertParallelBackward")


class CaptureLost(RuntimeError):
    """No session saw the kernel events the launch counters witness."""


class Instrument:
    """Ranges and work records around the program's entry points, for
    the life of the ``with`` block (restored after it)."""

    def __init__(self):
        self.calls = defaultdict(list)     # entry -> [bound ms or record]
        self._saved = []

    def _patch(self, owner, attr, make):
        orig = getattr(owner, attr)
        self._saved.append((owner, attr, orig))
        setattr(owner, attr, make(orig))

    def __enter__(self):
        import torch
        from repro_torch.core import moe as moe_mod
        from repro_torch.kernels import ops
        from repro_torch.models import attention as attn_mod
        from repro_torch.models import lm as lm_mod
        from repro_torch.runtime import server as server_mod
        rf = torch.profiler.record_function
        calls = self.calls

        def gmm(orig):
            def grouped_matmul(a, b):
                e, m, k = a.shape
                calls["grouped_matmul"].append(R.grouped_matmul_ms(
                    e, m, b.shape[2], k, a.element_size(), b.element_size()))
                with rf("bench.grouped_matmul"):
                    return orig(a, b)
            return grouped_matmul

        def ffn(orig):
            def grouped_ffn(x, wi, wu, wo, *, ffn_type="swiglu",
                            group_expert=None, group_rows=None):
                calls["grouped_ffn"].append(
                    (tuple(x.shape), wi.shape[-1], ffn_type,
                     None if group_expert is None else group_expert.clone(),
                     None if group_rows is None else group_rows.clone()))
                with rf("bench.grouped_ffn"):
                    return orig(x, wi, wu, wo, ffn_type=ffn_type,
                                group_expert=group_expert,
                                group_rows=group_rows)
            return grouped_ffn

        def flash(orig):
            def flash_attention_op(q, k, v, causal=True, window=0):
                b, s, h, hd = q.shape
                calls["flash_attention"].append(R.flash_attention_ms(
                    b, s, h, k.shape[2], hd, causal, window))
                with rf("bench.flash_attention"):
                    return orig(q, k, v, causal=causal, window=window)
            return flash_attention_op

        def ranged(name):
            def make(orig):
                def inner(*a, **kw):
                    with rf(name):
                        return orig(*a, **kw)
                return inner
            return make

        self._patch(ops, "grouped_matmul", gmm)
        self._patch(moe_mod, "grouped_matmul", gmm)
        self._patch(ops, "grouped_ffn", ffn)
        self._patch(attn_mod, "flash_attention_op", flash)
        self._patch(lm_mod, "moe_layer", ranged("bench.moe_layer"))
        self._patch(server_mod.MoEServer, "_serve_moe",
                    ranged("bench.server_layer"))
        return self

    def __exit__(self, *exc):
        for owner, attr, orig in reversed(self._saved):
            setattr(owner, attr, orig)
        self._saved.clear()


def ffn_bound_ms(rec) -> float:
    """Least time of one recorded ``grouped_ffn`` call (rows past each
    group's count and empty groups are not computed)."""
    import torch
    (g, t, d), f, act, ge, gr = rec
    keep = torch.ones((g, t), dtype=torch.bool, device="cpu")
    rows = torch.arange(t)[None, :]
    if gr is not None:
        keep &= rows < gr.cpu()[:, None]
    n_exp = g
    if ge is not None:
        ge = ge.cpu()
        keep &= (ge >= 0)[:, None]
        n_exp = int(torch.unique(ge[ge >= 0]).numel())
    return R.grouped_ffn_ms(g, t, d, f, act, int(keep.sum()), n_exp)


class Capture:
    """One profiler session: ``start()``, one warm-up step, ``arm()``, the
    active steps, ``stop()`` -> the record the metrics read."""

    def __init__(self, instrument: Instrument):
        self.ins = instrument
        self.prof = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, schedule
        torch.cuda.synchronize()
        self.prof = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
        self.prof.__enter__()

    def arm(self):
        import torch
        from repro_torch.kernels import COUNTERS
        torch.cuda.synchronize()
        self.prof.step()
        self.ins.calls.clear()
        self.before = {n: c.count for n, c in COUNTERS.items()}
        self.t0 = time.perf_counter()

    def stop(self, steps: int) -> dict:
        import torch
        from repro_torch.kernels import COUNTERS
        torch.cuda.synchronize()
        window = time.perf_counter() - self.t0
        launched = {n: c.count - self.before.get(n, 0)
                    for n, c in COUNTERS.items()
                    if c.count != self.before.get(n, 0)}
        self.prof.step()
        self.prof.__exit__(None, None, None)
        try:
            return analyze(self.prof.events(), launched, window, steps,
                           self.ins.calls)
        finally:
            self.prof = None


def _unwitnessed(counts: dict, launched: dict) -> dict:
    """{what: (events seen, launches witnessed)} where they differ: for
    each wrapper that launched, its own kernels' events over their
    launches a call (``topk_positions`` launches one of two kernels); for
    a kernel of several wrappers, its events; a port kernel seen without
    a launch is lost too."""
    own = K.KERNEL_OWNERS
    out = {}
    for w, n in launched.items():
        ks = [k for k, o in own.items() if set(o) == {w}]
        seen = sum(counts.get(k, 0) / own[k][w] for k in ks)
        if ks and seen != n:
            out[w] = (seen, n)
    for k, o in own.items():
        want = sum(launched.get(w, 0) * m for w, m in o.items())
        if (len(o) > 1 or not want) and counts.get(k, 0) != want:
            out[k] = (counts.get(k, 0), want)
    return out


def _is_range(name: str) -> bool:
    return name.startswith("bench.") or name.startswith("ProfilerStep")


def analyze(events, launched: dict, window_s: float, steps: int,
            calls: dict) -> dict:
    """The record of one session (see the module doc); raises
    ``CaptureLost`` when it fails its checks."""
    from torch.autograd import DeviceType
    dev, cpu = [], []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) or _is_range(e.name):
                continue
            dev.append(e)
        elif e.device_type == DeviceType.CPU:
            cpu.append(e)
    if not dev:
        raise CaptureLost("the session saw no device activity")
    counts = defaultdict(int)
    for e in dev:
        counts[K.short(e.name)] += 1
    lost = _unwitnessed(counts, launched)
    if lost:
        raise CaptureLost(f"kernel events against launch counters: {lost}")
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, merged = 0.0, []
    for s, t in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged) / 1e6
    if not 0 < busy <= window_s:
        raise CaptureLost(f"busy {busy} s outside the window {window_s} s")
    by_name = defaultdict(float)
    by_kind = defaultdict(float)
    for e in dev:
        dt = (e.time_range.end - e.time_range.start) / 1e6
        by_name[K.short(e.name)] += dt
        by_kind[K.kind(e.name)] += dt
    # kernels launched inside each range kind (innermost bench range; the
    # MoE layer's backward nodes count as the layer)
    inside = defaultdict(float)
    for e in cpu:
        ks = [k for k in e.kernels if not _is_range(k.name)]
        if not ks:
            continue
        dur = sum(k.duration for k in ks) / 1e6
        seen = set()
        p = e
        while p is not None:
            key = p.name[len("bench."):] if p.name.startswith("bench.") \
                else "moe_layer" if any(b in p.name for b in MOE_BACKWARD) \
                else None
            if key is not None and key not in seen:
                seen.add(key)
                inside[key] += dur
            p = p.cpu_parent
    # an entry's device time: its own kernels, which only it launches
    # (their events equal its launches, checked above)
    entries = {}
    for name, recs in calls.items():
        bound = sum(ffn_bound_ms(r) for r in recs) if name == "grouped_ffn" \
            else sum(recs)
        own = [k for k, o in K.KERNEL_OWNERS.items() if set(o) == {name}]
        entries[name] = {"calls": len(recs), "bound_s": bound / 1e3,
                         "device_s": sum(by_name.get(k, 0.0) for k in own)}
    gaps = _idle_gaps(merged, cpu)
    return {"steps": steps, "window_s": window_s, "busy_s": busy,
            "by_kind_s": dict(by_kind), "inside_s": dict(inside),
            "entries": entries,
            "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
            "idle_gaps": gaps}


def _idle_gaps(merged: list, cpu: list, longest: int = 200) -> list:
    """The ``longest`` idle stretches of the device, summed by what the
    host was doing at their middle (the deepest CPU event there)."""
    import numpy as np
    gaps = sorted(((b - a, a, b) for (_, a), (b, _) in
                   zip(merged, merged[1:])), reverse=True)[:longest]
    if not gaps or not cpu:
        return []
    starts = np.array([e.time_range.start for e in cpu])
    ends = np.array([e.time_range.end for e in cpu])
    depth = np.zeros(len(cpu), dtype=np.int64)
    for i, e in enumerate(cpu):
        p = e.cpu_parent
        while p is not None:
            depth[i] += 1
            p = p.cpu_parent
    by = defaultdict(float)
    for length, a, b in gaps:
        mid = (a + b) / 2
        hit = np.nonzero((starts <= mid) & (ends >= mid))[0]
        name = cpu[hit[np.argmax(depth[hit])]].name if hit.size else \
            "host: no profiled op"
        by[name] += length / 1e6
    return sorted(by.items(), key=lambda kv: -kv[1])[:10]
