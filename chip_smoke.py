#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phase 0  prints the card (``nvidia-smi`` name and power limit) and builds
         the CUDA kernels from ``src/repro_torch/kernels/csrc`` (timed).
Phase 1  holds each of the six serve-path kernels against its plain PyTorch
         version on the card, at the serve path's shapes (gpt2-moe: D=768,
         E=16, F=3072, 64 slots; prefill T<=256 slot_cap 24, decode T=8
         slot_cap 8, profiling k=2 and G=16 x 48 rows), and times the
         kernel and its plain version per call with CUDA events and the
         kernel alone with torch.profiler.  No single PyTorch call computes
         any of the six functions, so ``library_ms`` is null.
Phase 2  zeroes the launch counters, serves 8 requests x 8 new tokens of
         gpt2-moe at full width through ``repro_torch.launch.serve``,
         fails if any kernel was never launched, checks the output, and
         prints the server's host spans and the card's busy share of a
         prefill and a decode step.  It then replays every MoE layer call
         of a kernel-route prefill and decode step through the plain route
         on the same input, plan, cap and slot_cap, and runs the whole
         model both ways, counting per layer the gate ids that differ and
         holding each against the bf16 margin.

Prints one ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``.  Any failure raises (non-zero exit).
Imports nothing of the JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

REPLACES = {
    "topk_gating_fused": "src/repro/kernels/topk_gating.py:83",
    "topk_positions": "src/repro/kernels/topk_gating.py:145",
    "dispatch_rows": "src/repro/kernels/dispatch.py:147",
    "combine_rows": "src/repro/kernels/dispatch.py:206",
    "weighted_route": "src/repro/kernels/dispatch.py:273",
    "grouped_ffn": "src/repro/kernels/moe_ffn.py:73",
}
SOURCE = {
    "topk_gating_fused": "src/repro_torch/kernels/csrc/topk_gating.cu",
    "topk_positions": "src/repro_torch/kernels/csrc/topk_gating.cu",
    "dispatch_rows": "src/repro_torch/kernels/csrc/dispatch.cu",
    "combine_rows": "src/repro_torch/kernels/csrc/dispatch.cu",
    "weighted_route": "src/repro_torch/kernels/csrc/dispatch.cu",
    "grouped_ffn": "src/repro_torch/kernels/csrc/moe_ffn.cu",
}

# gpt2-moe serve-path geometry (configs/paper_models.py, ServerConfig and
# the serve driver's defaults)
D, E, F, N_SLOTS, MAX_PACK = 768, 16, 3072, 64, 4


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(fn, iters: int = 20) -> float:
    """Mean kernel time per call on the card (torch.profiler kernel events,
    no host time), over ``iters`` calls after one warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.self_device_time_total for e in kern) / iters / 1e3


def bound_ms(n_bytes: float, n_ops: float, hw) -> tuple:
    """Least time for the work on this card: max(bytes / HBM rate, ops /
    peak rate for the operands' type); returns (ms, "bytes"|"operations")."""
    tb = n_bytes / hw.hbm_bw * 1e3
    to = n_ops / hw.peak_flops * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# ---------------------------------------------------------------------------
# phase 1: each kernel against its plain version at the path's shapes
# ---------------------------------------------------------------------------

def _route_inputs(t: int, k: int, cap: int, slot_cap: int, gen, dev,
                  short: bool = False):
    """Realistic serve metadata: gate ids of t tokens, their priority
    positions, a plan of 64 slots with 1..4 replicas per expert and integer
    replica weights that cover each expert's kept tokens, or, with
    ``short``, fall one token short per replica, so the route drops the
    positions past each expert's total."""
    import torch
    from repro_torch.kernels import ref
    idx = torch.randint(0, E, (t, k), generator=gen, device=dev,
                        dtype=torch.int32)
    pos = ref.ref_topk_positions(idx, E)
    kept = torch.where(pos < cap, idx, torch.full_like(idx, -1))
    counts = torch.bincount(kept[kept >= 0].long(), minlength=E)
    perm = torch.randperm(N_SLOTS, generator=gen, device=dev)
    n_rep = torch.randint(1, MAX_PACK + 1, (E,), generator=gen, device=dev)
    slot_of = torch.full((E, MAX_PACK), -1, dtype=torch.int32, device=dev)
    w_int = torch.zeros((E, MAX_PACK), dtype=torch.int32, device=dev)
    for e in range(E):
        r = int(n_rep[e])
        slot_of[e, :r] = perm[e * MAX_PACK:e * MAX_PACK + r].int()
        share = -(-int(counts[e]) // r)
        w_int[e, :r] = max(min(share, slot_cap) - short, 0)
    cum = torch.cumsum(w_int, dim=1).int()
    return kept, pos, cum, slot_of


def phase1(dev, hw) -> dict:
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.dispatch import (combine_rows, dispatch_rows,
                                              invert_slots, weighted_route)
    from repro_torch.kernels.moe_ffn import grouped_ffn
    from repro_torch.kernels.topk_gating import (topk_gating_fused,
                                                 topk_positions)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    bf = torch.bfloat16
    rows = {}

    def record(name, case, err, kernel, plain_fn, nbytes, nops, iters=50):
        ms = time_ms(kernel, iters)
        plain = time_ms(plain_fn, iters)
        dms = device_ms(kernel)
        b, by = bound_ms(nbytes, nops, hw)
        print(f"  {name:18s} {case:8s} err {err:.3e}  kernel {ms:.4f} ms "
              f"(device {dms:.4f})  plain {plain:.4f} ms  bound {b:.6f} ms "
              f"({by})", flush=True)
        cur = rows.get(name)
        if cur is None or case == "prefill":
            # the prefill shape stands for the kernel in the summary line
            rows[name] = dict(case=case, ms=ms, device_ms=dms, plain_ms=plain,
                              library_ms=None, bound_ms=b, bound_by=by,
                              max_abs_err=max(err, cur["max_abs_err"])
                              if cur else err)
        else:
            cur["max_abs_err"] = max(cur["max_abs_err"], err)

    # -- gating: serve prefill / decode (k=1), profiling (k=2) -------------
    router = (torch.randn(D, E, generator=gen, device=dev) * D ** -0.5).to(bf)
    for case, t, k in (("prefill", 256, 1), ("decode", 8, 1),
                       ("profile", 256, 2)):
        x = torch.randn(t, D, generator=gen, device=dev).to(bf)
        idx, w, probs = topk_gating_fused(x, k, router=router)
        ridx, rw, rprobs = ref.ref_topk_gating(x @ router, k)
        torch.cuda.synchronize()
        perr = (probs - rprobs).abs().max().item()
        srt = torch.sort(rprobs, dim=-1, descending=True).values
        margin = (srt[:, :k] - srt[:, 1:k + 1]).min(dim=-1).values
        clear = margin > 1e-3
        n_tie = int((~clear).sum())
        if perr > 1e-3:
            raise AssertionError(f"gating {case}: probs err {perr}")
        if not torch.equal(idx[clear], ridx[clear]):
            raise AssertionError(f"gating {case}: expert ids differ")
        werr = (w - rw)[clear].abs().max().item() if clear.any() else 0.0
        if werr > 1e-3:
            raise AssertionError(f"gating {case}: weights err {werr}")
        print(f"  gating {case}: {n_tie} of {t} rows within the 1e-3 "
              f"top-k margin", flush=True)
        record("topk_gating_fused", case, perr,
               lambda: topk_gating_fused(x, k, router=router),
               lambda: ref.ref_topk_gating(x @ router, k),
               t * D * 2 + D * E * 2 + t * k * 8 + t * E * 4, 2 * t * D * E)

    # -- positions ----------------------------------------------------------
    for case, t, k in (("prefill", 256, 1), ("decode", 8, 1),
                       ("profile", 256, 2)):
        ids = torch.randint(-1, E, (t, k), generator=gen, device=dev,
                            dtype=torch.int32)
        got = topk_positions(ids, E)
        want = ref.ref_topk_positions(ids, E)
        if not torch.equal(got, want):
            raise AssertionError(f"topk_positions {case}: mismatch")
        record("topk_positions", case, 0.0, lambda: topk_positions(ids, E),
               lambda: ref.ref_topk_positions(ids, E), t * k * 8, 0)

    # -- route / dispatch / combine at the serve shapes ---------------------
    for case, t, cap, slot_cap, short in (("prefill", 256, 24, 24, False),
                                          ("decode", 8, 8, 8, False),
                                          ("drop", 256, 24, 24, True)):
        k = 1
        kept, pos, cum, slot_of = _route_inputs(t, k, cap, slot_cap, gen,
                                                dev, short)
        got = weighted_route(kept, pos, cum, slot_of, slot_cap)
        want = ref.ref_weighted_route(kept, pos, cum, slot_of, slot_cap)
        if not torch.equal(got, want):
            raise AssertionError(f"weighted_route {case}: mismatch")
        n_short = int(((kept >= 0) & (got < 0)).sum())
        print(f"  weighted_route {case}: {n_short} kept choices past their "
              f"expert's total weight, dropped", flush=True)
        if short and n_short == 0:
            raise AssertionError("weighted_route drop case dropped nothing")
        record("weighted_route", case, 0.0,
               lambda: weighted_route(kept, pos, cum, slot_of, slot_cap),
               lambda: ref.ref_weighted_route(kept, pos, cum, slot_of,
                                              slot_cap),
               t * k * 4 * 3 + cum.numel() * 8, 0)

        rows_ = got
        n_rows = N_SLOTS * slot_cap
        src, _ = invert_slots(rows_, n_rows)
        x = torch.randn(t, D, generator=gen, device=dev).to(bf)
        buf = dispatch_rows(x, src)
        if not torch.equal(buf, ref.ref_dispatch_rows(x, src)):
            raise AssertionError(f"dispatch_rows {case}: mismatch")
        n_kept = int((src >= 0).sum())
        record("dispatch_rows", case, 0.0, lambda: dispatch_rows(x, src),
               lambda: ref.ref_dispatch_rows(x, src),
               n_kept * D * 2 + n_rows * 4 + n_rows * D * 2, 0)

        y_buf = torch.randn(n_rows, D, generator=gen, device=dev).to(bf)
        wts = torch.rand(t, k, generator=gen, device=dev)
        y = combine_rows(y_buf, rows_, wts)
        yr = ref.ref_combine_rows(y_buf, rows_, wts).float()
        ulp = torch.where(yr != 0, torch.exp2(torch.floor(torch.log2(
            yr.abs())) - 7), torch.full_like(yr, 2.0 ** -133))
        cerr = (y.float() - yr).abs()
        if bool((cerr > ulp).any()):
            raise AssertionError(f"combine_rows {case}: beyond 1 bf16 ulp")
        n_used = int((rows_ >= 0).sum())
        record("combine_rows", case, cerr.max().item(),
               lambda: combine_rows(y_buf, rows_, wts),
               lambda: ref.ref_combine_rows(y_buf, rows_, wts),
               n_used * D * 2 + t * k * 8 + t * D * 2, 2 * n_used * D)

    # -- grouped FFN: serve prefill / decode, profiling (gelu, the path's
    # activation) and a small swiglu case (the kernel's other epilogue) ----
    for case, g, t, act in (("prefill", N_SLOTS, 24, "gelu"),
                            ("decode", N_SLOTS, 8, "gelu"),
                            ("profile", E, 48, "gelu"),
                            ("swiglu", 4, 16, "swiglu")):
        x = torch.randn(g, t, D, generator=gen, device=dev).to(bf)
        wi, wu = ((torch.randn(g, D, F, generator=gen, device=dev)
                   * D ** -0.5).to(bf) for _ in range(2))
        wu = wu if act == "swiglu" else None
        wo = (torch.randn(g, F, D, generator=gen, device=dev)
              * F ** -0.5).to(bf)
        got = grouped_ffn(x, wi, wu, wo, ffn_type=act)
        want = ref.ref_grouped_ffn(
            x.float(), wi.float(), None if wu is None else wu.float(),
            wo.float(), act)
        torch.cuda.synchronize()
        err = (got.float() - want).abs().max().item()
        rel = err / want.abs().max().item()
        if not rel <= 2e-2:
            raise AssertionError(f"grouped_ffn {case}: max rel err {rel}")
        print(f"  grouped_ffn {case}: max rel err {rel:.3e}", flush=True)
        n_w = 3 if wu is not None else 2
        record("grouped_ffn", case, err,
               lambda: grouped_ffn(x, wi, wu, wo, ffn_type=act),
               lambda: ref.ref_grouped_ffn(x, wi, wu, wo, act),
               (2 * g * t * D + n_w * g * D * F) * 2,
               2 * n_w * g * t * D * F, iters=20)
        del wi, wu, wo
    return rows


# ---------------------------------------------------------------------------
# phase 2: the serve path end to end
# ---------------------------------------------------------------------------

def device_busy(srv, toks) -> None:
    """Device busy share of one prefill and one decode step of the served
    model: kernel time summed by torch.profiler over the host wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    pre = srv.prefill_batch(toks, cache_len=40)
    for name, step in (
            ("prefill", lambda: srv.prefill_batch(toks, cache_len=40)),
            ("decode", lambda: srv.decode_batch(
                pre.logits.argmax(-1), pre.cache, pre.path_ids[:, -1]))):
        step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # kernel events only: an operator's row repeats its kernels' time
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_us = sum(e.self_device_time_total for e in kern)
        print(f"phase 2 {name} step: wall {wall * 1e3:.3f} ms, device busy "
              f"{dev_us / 1e3:.3f} ms "
              f"({100 * dev_us / 1e6 / wall:.1f}% of wall), "
              f"{sum(e.count for e in kern)} kernels", flush=True)
        for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"    {e.self_device_time_total / 1e3:9.3f} ms  "
                  f"x{e.count:<5d} {e.key[:90]}", flush=True)


# bf16 holds 8 significant bits: a rounding moves a value by at most half
# of 2**-7 of its size.  Two routes that round the same logit differently
# disagree by up to one such unit each, two logits per comparison.
BF16_LOGIT_MARGIN = 2.0 ** -6
PROB_MARGIN = 1e-3     # phase 1's gating tolerance: probs and top-k margin
FFN_REL = 2e-2         # phase 1's grouped_ffn tolerance
DRIFT_REL = 2e-2       # hidden-state drift allowed where no gate flipped


@contextlib.contextmanager
def tap_layers(log: list):
    """Record every ``serve_moe_layer`` call the server makes, with its
    arguments and its outputs, in ``log``."""
    from repro_torch.runtime import server as server_mod
    real = server_mod.serve_moe_layer

    def tapped(x, params, cfg, plan, **kw):
        out = real(x, params, cfg, plan, **kw)
        log.append((x, params, cfg, plan, kw, out))
        return out
    server_mod.serve_moe_layer = tapped
    try:
        yield log
    finally:
        server_mod.serve_moe_layer = real


def _flip_margin(probs, k: int):
    """Gap between the k-th and (k+1)-th largest router probability."""
    import torch
    srt = torch.sort(probs, dim=-1, descending=True).values
    return srt[:, k - 1] - srt[:, k]


def replay_plain(calls, what: str) -> None:
    """Each recorded kernel-route layer call again through the plain route,
    on the same input, plan, cap, slot_cap and route mode.  Gate ids may
    differ only where the top-k probability margin is within PROB_MARGIN;
    every token whose expert no flip touched must be kept or dropped alike
    and agree within FFN_REL."""
    import torch
    from repro_torch.core.serving import serve_moe_layer, slot_capacity
    report = []
    for li, (x, params, mcfg, plan, kw, (yk, ik, pk)) in enumerate(calls):
        yp, ip, pp = serve_moe_layer(
            x, params, dataclasses.replace(mcfg, compute_backend="xla"), plan,
            **kw)
        k = ik.shape[1]
        perr = (pk - pp).abs().max().item()
        flip = (ik != ip).any(-1)
        wide = flip & (_flip_margin(pp, k) > PROB_MARGIN)
        touched = torch.cat([ik[flip].reshape(-1), ip[flip].reshape(-1)])
        alike = ~(torch.isin(ik.long(), touched.long())
                  | torch.isin(ip.long(), touched.long())).any(-1)
        dk, dp = (yk == 0).all(-1), (yp == 0).all(-1)
        rel = ((yk.float() - yp.float())[alike].abs().max()
               / yp.float().abs().max()).item() if alike.any() else 0.0
        cap = kw["cap_override"]
        report.append(f"L{li}:{int(flip.sum())}f/{int(dp.sum())}d/"
                      f"{rel:.1e}")
        if perr > PROB_MARGIN or wide.any() or \
                not torch.equal(dk[alike], dp[alike]) or not rel <= FFN_REL:
            raise AssertionError(
                f"{what} layer {li} (T={x.shape[0]}, cap {cap}, slot_cap "
                f"{slot_capacity(cap, kw['min_replicas'])}): kernel route "
                f"disagrees with the plain route: probs err {perr:.3e}, "
                f"{int(wide.sum())} flips beyond the margin, max rel err "
                f"{rel:.3e}")
    x, _, _, _, kw, _ = calls[0]
    print(f"phase 2: {what}, each MoE layer's kernel route replayed through "
          f"the plain route (T={x.shape[0]}, cap {kw['cap_override']}, "
          f"slot_cap {slot_capacity(kw['cap_override'], kw['min_replicas'])} "
          f"at layer 0; per layer flips f / drops d / max rel err): "
          f"{' '.join(report)}", flush=True)


def compare_routes(srv, toks) -> None:
    """The served model's kernel route against its plain route.

    Layer by layer: every MoE call of one kernel-route prefill and decode
    step is replayed through the plain route (``replay_plain``).  Whole
    model: one prefill both ways, with the same weights and profile.  A
    token is *clean* at a layer while no gate flip and no drop difference
    has happened at or before it in its row (attention is causal); a
    clean token's MoE input must agree within DRIFT_REL, and a gate id may
    differ at a clean token only where the plain route's fp32 logit gap is
    within what that drift and bf16 rounding allow."""
    import numpy as np
    import torch
    from repro_torch.runtime.server import MoEServer
    cfg = srv.cfg
    b, s = toks.shape
    kcalls, dcalls, pcalls = [], [], []
    with torch.inference_mode():
        with tap_layers(kcalls):
            pre = srv.prefill_batch(toks, cache_len=s + 8)
        with tap_layers(dcalls):
            srv.decode_batch(pre.logits.argmax(-1), pre.cache,
                             pre.path_ids[:, -1])
        replay_plain(kcalls, "prefill")
        replay_plain(dcalls, "decode step")

        plain_cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, compute_backend="xla"))
        plain = MoEServer(plain_cfg, srv.params, srv.profile, srv.scfg,
                          device=srv.device)
        with tap_layers(pcalls):
            lp_last = plain.prefill_batch(toks, cache_len=s + 8).logits
    lk_last = pre.logits
    if not (np.isfinite(lk_last).all() and lk_last.shape == lp_last.shape):
        raise AssertionError("kernel-route prefill logits not finite")

    dirty = torch.zeros(b, s, dtype=torch.bool, device=srv.device)
    report, worst = [], 0.0
    for li, (kc, pc) in enumerate(zip(kcalls, pcalls)):
        xk, xp = kc[0].float(), pc[0].float()
        (yk, ik, _), (yp, ip, _) = kc[5], pc[5]
        clean = ~dirty.reshape(-1)
        drift = (xk - xp).norm(dim=-1) / xp.norm(dim=-1)
        if clean.any():
            worst = max(worst, drift[clean].max().item())
        if clean.any() and drift[clean].max().item() > DRIFT_REL:
            raise AssertionError(
                f"whole model layer {li}: clean tokens drifted "
                f"{drift[clean].max().item():.3e} > {DRIFT_REL}")
        flip = (ik != ip).any(-1)
        drop = (yk == 0).all(-1) != (yp == 0).all(-1)
        router = kc[1].router.float()
        lp = xp @ router
        a, c = ip[:, 0].long(), ik[:, 0].long()
        t = torch.arange(lp.shape[0], device=lp.device)
        gap = lp[t, a] - lp[t, c]
        allow = DRIFT_REL * xp.norm(dim=-1) \
            * (router[:, a] - router[:, c]).norm(dim=0) \
            + BF16_LOGIT_MARGIN * torch.maximum(lp[t, a].abs(),
                                                 lp[t, c].abs())
        wide = flip & clean & (gap > allow)
        if wide.any():
            raise AssertionError(
                f"whole model layer {li}: {int(wide.sum())} clean-token gate "
                f"flips beyond the bf16 margin (max gap "
                f"{gap[wide].max().item():.3e})")
        report.append(f"L{li}:{int((flip & clean).sum())}c+"
                      f"{int((flip & ~clean).sum())}")
        event = (flip | drop).reshape(b, s)
        dirty |= torch.cummax(event.int(), dim=1).values.bool()
    clean_rows = ~dirty.any(1).cpu().numpy()
    cos = (lk_last * lp_last).sum(1) / (np.linalg.norm(lk_last, axis=1)
                                         * np.linalg.norm(lp_last, axis=1))
    print(f"phase 2: whole model, kernel vs plain route prefill "
          f"({b} x {s} tokens): gate ids that differ per layer, at clean + "
          f"at already-diverged tokens: {' '.join(report)}; max clean drift "
          f"{worst:.3e} (limit {DRIFT_REL}); rows with no flip "
          f"{int(clean_rows.sum())} of {b}; last-token logits cosine per row "
          f"{np.round(cos, 6).tolist()}, argmax agreement "
          f"{float((lk_last.argmax(1) == lp_last.argmax(1)).mean()):.2f}",
          flush=True)
    if clean_rows.any() and cos[clean_rows].min() < 1 - DRIFT_REL:
        raise AssertionError("a row with no gate flip disagrees at the "
                             "logits")


def phase2(dev) -> dict:
    import numpy as np
    import torch
    from repro_torch.kernels import COUNTERS, reset_counters
    from repro_torch.launch import serve

    argv = ["--arch", "gpt2-moe", "--requests", "8", "--seq", "64",
            "--max-new-tokens", "8", "--device", str(dev),
            "--trace-dir", str(ROOT / "build" / "serve_trace")]
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counters()
    t0 = time.perf_counter()
    out = serve.run(argv)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = {n: c.count for n, c in COUNTERS.items()}
    print(f"phase 2: served in {wall:.2f} s wall (profiling included); "
          f"peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB", flush=True)
    print("phase 2 launches: " + json.dumps(launches), flush=True)
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the serve path: "
                             f"{missing}")

    m, engine, results = out["summary"], out["engine"], out["results"]
    cfg = engine.server.cfg
    if m["n"] != 8 or m["gen_tokens"] != 64:
        raise AssertionError(f"expected 8 requests x 8 tokens, got {m}")
    for r in results:
        if not np.isfinite(r.logits).all() or r.logits.shape != \
                (cfg.vocab_size,):
            raise AssertionError(f"request {r.rid}: bad logits")
        if r.tokens.shape != (8,) or r.tokens.min() < 0 or \
                r.tokens.max() >= cfg.vocab_size:
            raise AssertionError(f"request {r.rid}: bad tokens")
    print(f"phase 2: latency p50 {m['latency_p50'] * 1e3:.3f} ms p95 "
          f"{m['latency_p95'] * 1e3:.3f} ms  TTFT p50 "
          f"{m['ttft_p50'] * 1e3:.3f} ms p95 {m['ttft_p95'] * 1e3:.3f} ms  "
          f"TPOT p50 {m['tpot_p50'] * 1e3:.3f} ms p95 "
          f"{m['tpot_p95'] * 1e3:.3f} ms  {m['gen_tok_s']:.3f} gen tok/s  "
          f"plan reuse {engine.plan_reuse_rate:.4f}  fine-tune rate "
          f"{engine.finetune_rate:.4f}", flush=True)

    # where the host wall time of a served layer goes (server spans; the
    # "gate" span holds the device->host copy that waits for the card)
    spans = {}
    for root in out["obs"].tracer.roots:
        for sp in root.walk():
            if sp.name in ("server.layer", "phase1.estimate", "gate",
                           "plan.lookup", "plan.build", "phase2.finetune",
                           "dispatch"):
                n, tot = spans.get(sp.name, (0, 0.0))
                spans[sp.name] = (n + 1, tot + sp.duration)
    print("phase 2 host spans (count, total ms): " + json.dumps(
        {k: [n, round(t * 1e3, 3)] for k, (n, t) in spans.items()}),
        flush=True)

    srv = engine.server
    rng = np.random.RandomState(7)
    toks = rng.randint(0, cfg.vocab_size, (4, 32))
    device_busy(srv, toks)

    compare_routes(srv, toks)
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: the port (src/repro_torch) is missing",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import H100
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    smi = smi_line()
    print(f"phase 0: {smi}", flush=True)
    print(f"phase 0: torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    dt = _build.build_all()
    print(f"phase 0: built {len(_build.SOURCES)} kernel sources in "
          f"{dt:.2f} s", flush=True)
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)

    print("phase 1: kernels against their plain versions", flush=True)
    rows = phase1(dev, H100)
    launches = phase2(dev)

    kernels = []
    for name in REPLACES:
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
