#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phase 0  prints the card (``nvidia-smi`` name and power limit) and builds
         the seven CUDA kernel sources of ``src/repro_torch/kernels/csrc``
         (one ``nvcc`` each, started together; timed).
Phase 1  holds each of the six serve-path kernels against its plain PyTorch
         version on the card, at the serve path's shapes (gpt2-moe: D=768,
         E=16, F=3072, 64 slots; prefill T<=256 slot_cap 24, decode T=8
         slot_cap 8, profiling k=2 and G=16 x 48 rows), and times the
         kernel and its plain version per call with CUDA events and the
         kernel alone with torch.profiler.  No single PyTorch call computes
         any of the six functions, so ``library_ms`` is null, except that
         ``grouped_ffn`` is timed beside the bf16 einsum-act-einsum
         composition (several calls, a yardstick).  ``grouped_ffn`` also
         runs with the serve path's slot -> expert index (weights read in
         place) and each slot's routed rows (the rest skipped): gpt2-moe's
         serve prefill and decode (16 experts in 64 slots), mixtral-8x22b's
         prefill (2048 tokens top-2 into 32 slots of 640 rows, ~128 a slot)
         and decode (4 x 2), swiglu at d 6144 / F 16384, and slots of -1 and
         of 0 rows; each case within 2e-2 of max |plain|, repeated bitwise,
         zeros past each count.  It holds
         ``flash_attention`` against ``ref_attention`` at seven shapes
         (a, b: gpt2-moe's prefill 4 x 64 and 8 x 1024, 12 heads, hd 64,
         causal; c, d: mixtral-8x22b's 1 x 2048 and 1 x 6144, 48 / 8 heads,
         hd 128, causal, window 4096; e: bert-large-moe's 8 x 512, 16 heads,
         hd 64, bidirectional; f: zamba2-1.2b's shared block, 4 x 2048, 32
         heads, hd 64, causal; g: a ragged 2 x 1000, 48 / 8 heads, hd 128,
         window 256), norm-wise, each call repeated bitwise, timed beside
         ``scaled_dot_product_attention`` (the yardstick only).
Phase 2  zeroes the launch counters, serves 8 requests x 8 new tokens of
         gpt2-moe at full width through ``repro_torch.launch.serve``,
         fails if any kernel was never launched, checks the output, and
         prints the server's host spans and the card's busy share of a
         prefill and a decode step.  It then replays every MoE layer call
         of a kernel-route prefill and decode step through the plain route
         on the same input, plan, cap and slot_cap, and runs the whole
         model both ways, counting per layer the gate ids that differ and
         holding each against the bf16 margin.

Phase 3  trains gpt2-moe on the card.  A layer check holds one MoE
         layer's forward and gradients (x, router, wi, wo) on the kernel
         route against the plain route at full width.  The main run zeroes
         the counters and trains gpt2-moe at full width and depth through
         ``repro_torch.launch.train`` (kernel route, batch 8 x seq 1024, 12
         steps, packing decided at step 10): every training kernel must
         launch, every loss be finite and the last below the first; it
         prints step time, tokens/s, peak memory, the card's busy share of
         a step, the checkpoint's bytes and seconds and the packing
         decision.  A resume check at full width and 2 layers holds 4
         straight steps bitwise against 2 + injected failure + restart + 2,
         under ``torch.use_deterministic_algorithms``.
Phase 1 also holds the kernels at gpt2-moe training's shapes (8192 tokens,
top-2, E=16, C=1288): gating at k=2, ``dispatch_rows`` with a per-row scale
(combine's backward), ``combine_rows`` with unit weights (dispatch's
backward), ``grouped_ffn`` at [16, 1288, 768], and ``grouped_matmul`` (the
FFN backward's GEMM) at the five backward GEMM shapes (D=768, F=3072),
timed beside ``torch.bmm``, each repeated bitwise; then at all 16 dtype x
layout mixes on ragged shapes (E = 3, M and K 1288-1289, N 200-201; and
E = 1, M < 64), K = 0 (zeros) and an operand that breaks the TMA's 16-byte
rule (refused).
Phase 4  serves mixtral-8x22b at full width (d 6144, 48 / 8 heads, hd 128,
         8 swiglu experts of 16384, window 4096) and depth 2 through the
         port's ``MoEServer`` and ``ServingEngine`` (defaults, kernel route):
         profiling on 3 batches of 2 x 2048, 4 requests of 2048 prompt
         tokens x 16 new tokens, 2 score-only requests of 6144 tokens (past
         the window).  Counters zeroed just before, read just after; every
         serve-path kernel and ``flash_attention`` must launch.  It prints
         TTFT, TPOT, tokens/s, peak memory and the card's busy share, replays
         a prefill and a decode step layer by layer through the plain route,
         and runs a 6144-token prompt through both routes (flash attention
         against the query-blocked plain attention).

Phase 1 also holds the two recurrences at the serve shapes of phases 5 and
6, norm-wise within 1e-4: ``rwkv6_wkv`` against ``ref_rwkv6`` at 4 x 2048,
32 heads of 64 with a random non-zero bonus u, at the decode shape (T = 1)
from a random state, and split in two calls that carry the state;
``ssd_scan`` against ``ref_ssd`` at 4 x 2048, 64 heads, P = N = 64 (x, B
and C strided slices of one projection), at a ragged T = 2000 and split in
two calls.  Neither function has a PyTorch call that computes it, so their
``library_ms`` is null.
Phase 5  serves rwkv6-1.6b (24 RWKV6 layers, d 2048) at full width and
         depth, random weights from a seed, through ``models.lm``'s
         ``forward_prefill`` (4 x 2048 tokens), ``init_cache`` and
         ``decode_step`` (a 64-token prompt fed one token at a time, then
         32 greedy tokens).  Counters zeroed just before, read just after:
         ``rwkv6_wkv`` must launch 24 times per prefill and per decode step.
         It prints prefill wall time, decode step p50 / p95, generated
         tokens/s, peak memory and the card's busy share of a prefill and
         of a decode step.  It replays one prefill and one decode step
         layer by layer: every ``rwkv6_wkv`` call is run again through
         ``ref_rwkv6`` on the very tensors the model passed it (y and the
         final state norm-wise within 1e-4).  Then the plain route in
         float32 on the same master weights must show decode-matches-
         prefill at the prompt's end, and the kernel route's logits
         (prefill of 64 and of 4 x 512 tokens, decode at the prompt's end)
         must drift from it no further than the plain route in bf16 does.
Phase 6  does the same for zamba2-1.2b (38 Mamba2 layers, the shared
         attention block after every 6th): ``ssd_scan`` 38 and
         ``flash_attention`` 6 launches per prefill, each replayed against
         ``ref_ssd`` (1e-4) and ``ref_attention`` (1e-2); its decode steps
         run the plain ``mamba_decode`` and ``decode_attention``.

Prints one ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``.  Any failure raises (non-zero exit).
Imports nothing of the JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
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
    "grouped_matmul": "src/repro/kernels/moe_ffn.py:128",
    "flash_attention": "src/repro/kernels/flash_attention.py:87",
    "rwkv6_wkv": "src/repro/kernels/rwkv6.py:53",
    "ssd_scan": "src/repro/kernels/ssd.py:76",
}
SOURCE = {
    "topk_gating_fused": "src/repro_torch/kernels/csrc/topk_gating.cu",
    "topk_positions": "src/repro_torch/kernels/csrc/topk_gating.cu",
    "dispatch_rows": "src/repro_torch/kernels/csrc/dispatch.cu",
    "combine_rows": "src/repro_torch/kernels/csrc/dispatch.cu",
    "weighted_route": "src/repro_torch/kernels/csrc/dispatch.cu",
    "grouped_ffn": "src/repro_torch/kernels/csrc/moe_ffn.cu",
    "grouped_matmul": "src/repro_torch/kernels/csrc/grouped_matmul.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "rwkv6_wkv": "src/repro_torch/kernels/csrc/rwkv6.cu",
    "ssd_scan": "src/repro_torch/kernels/csrc/ssd.cu",
}
# every other kernel runs in training (its attention is plain: the flash
# kernel has no backward)
SERVE_ONLY = {"weighted_route", "flash_attention"}
TRAIN_ONLY = {"grouped_matmul"}     # the FFN backward
# the recurrences of the RWKV6 and Mamba2 families (phases 5 and 6 only)
RECURRENT = {"rwkv6_wkv", "ssd_scan"}

# gpt2-moe serve-path geometry (configs/paper_models.py, ServerConfig and
# the serve driver's defaults)
D, E, F, N_SLOTS, MAX_PACK = 768, 16, 3072, 64, 4
# gpt2-moe training: 8 x 1024 tokens, top-2, capacity factor 1.25
T_TRAIN, K_TRAIN = 8192, 2
C_TRAIN = 1288          # core.gating.capacity(8192, 16, 2, 1.25)


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
    # a profiling session now and then records no kernel event at all (seen
    # on a 2.7 us kernel): profile again rather than report zero time
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0:
            return us / iters / 1e3
    raise RuntimeError("torch.profiler recorded no kernel time in 3 tries")


# dense tensor-core peak of the H100 SXM for TF32 operands (NVIDIA's data
# sheet): half the bf16 rate in HardwareConfig.peak_flops
TF32_FLOPS = 495e12


def bound_ms(n_bytes: float, n_ops: float, hw, peak=None) -> tuple:
    """Least time for the work on this card: max(bytes / HBM rate, ops /
    peak rate for the operands' type, bf16 unless ``peak`` says otherwise);
    returns (ms, "bytes"|"operations")."""
    tb = n_bytes / hw.hbm_bw * 1e3
    to = n_ops / (peak or hw.peak_flops) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# ---------------------------------------------------------------------------
# phase 1: each kernel against its plain version at the path's shapes
# ---------------------------------------------------------------------------

def _route_inputs(t: int, k: int, cap: int, slot_cap: int, gen, dev,
                  short: bool = False, n_exp: int = E,
                  n_slots: int = N_SLOTS, replicas: int = 0):
    """Realistic serve metadata: gate ids of t tokens, their priority
    positions, a plan of ``n_slots`` slots with 1..4 replicas per expert
    (``replicas`` each, if not 0; the slots no expert takes stay empty) and
    integer replica weights that cover each expert's kept tokens, or, with
    ``short``, fall one token short per replica, so the route drops the
    positions past each expert's total."""
    import torch
    from repro_torch.kernels import ref
    idx = torch.randint(0, n_exp, (t, k), generator=gen, device=dev,
                        dtype=torch.int32)
    pos = ref.ref_topk_positions(idx, n_exp)
    kept = torch.where(pos < cap, idx, torch.full_like(idx, -1))
    counts = torch.bincount(kept[kept >= 0].long(), minlength=n_exp)
    perm = torch.randperm(n_slots, generator=gen, device=dev)
    n_rep = torch.randint(1, MAX_PACK + 1, (n_exp,), generator=gen,
                          device=dev)
    if replicas:
        n_rep.fill_(replicas)
    slot_of = torch.full((n_exp, MAX_PACK), -1, dtype=torch.int32,
                         device=dev)
    w_int = torch.zeros((n_exp, MAX_PACK), dtype=torch.int32, device=dev)
    for e in range(n_exp):
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

    def record(name, case, err, kernel, plain_fn, nbytes, nops, iters=50,
               library_fn=None):
        ms = time_ms(kernel, iters)
        plain = time_ms(plain_fn, iters)
        lib = time_ms(library_fn, iters) if library_fn else None
        dms = device_ms(kernel)
        b, by = bound_ms(nbytes, nops, hw)
        print(f"  {name:18s} {case:8s} err {err:.3e}  kernel {ms:.4f} ms "
              f"(device {dms:.4f})  plain {plain:.4f} ms  "
              + (f"library {lib:.4f} ms  " if lib is not None else "")
              + f"bound {b:.6f} ms ({by})", flush=True)
        cur = rows.get(name)
        if cur is None or case == "prefill":
            # the prefill shape stands for the kernel in the summary line
            rows[name] = dict(case=case, ms=ms, device_ms=dms, plain_ms=plain,
                              library_ms=lib, bound_ms=b, bound_by=by,
                              max_abs_err=max(err, cur["max_abs_err"])
                              if cur else err)
        else:
            cur["max_abs_err"] = max(cur["max_abs_err"], err)

    # -- gating: serve prefill / decode (k=1), profiling (k=2), training ---
    router = (torch.randn(D, E, generator=gen, device=dev) * D ** -0.5).to(bf)
    for case, t, k in (("prefill", 256, 1), ("decode", 8, 1),
                       ("profile", 256, 2), ("train", T_TRAIN, K_TRAIN)):
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

    # -- dispatch / combine at the training shape, as the backward calls
    # them: 8192 tokens top-2 into E x C rows, ids skewed so the busiest
    # experts pass C and drop tokens; dispatch with the gate weight as the
    # per-row scale (combine's backward), combine with unit weights
    # (dispatch's backward) --------------------------------------------------
    t, k, n_rows = T_TRAIN, K_TRAIN, E * C_TRAIN
    skew = torch.linspace(1.0, 3.0, E, device=dev).expand(t, E).contiguous()
    ids = torch.multinomial(skew, k, generator=gen).int()
    pos = ref.ref_topk_positions(ids, E)
    rows_ = torch.where(pos < C_TRAIN, ids * C_TRAIN + pos,
                        torch.full_like(ids, -1)).int()
    src, src_k = invert_slots(rows_, n_rows)
    wts = torch.rand(t, k, generator=gen, device=dev)
    pick = torch.clamp(src * k + src_k, min=0).long()
    scale = torch.where(src >= 0, wts.reshape(-1)[pick],
                        torch.zeros_like(wts.reshape(-1)[pick])).contiguous()
    dy = torch.randn(t, D, generator=gen, device=dev).to(bf)
    n_kept, n_drop = int((src >= 0).sum()), int((rows_ < 0).sum())
    print(f"  dispatch/combine train: {n_drop} of {t * k} choices past "
          f"capacity {C_TRAIN}, dropped", flush=True)
    if n_drop == 0:
        raise AssertionError("training dispatch case dropped nothing")
    buf = dispatch_rows(dy, src, scale)
    if not torch.equal(buf, ref.ref_dispatch_rows(dy, src, scale)):
        raise AssertionError("dispatch_rows train (scaled): mismatch")
    record("dispatch_rows", "train", 0.0,
           lambda: dispatch_rows(dy, src, scale),
           lambda: ref.ref_dispatch_rows(dy, src, scale),
           n_kept * D * 2 + n_rows * 8 + n_rows * D * 2, n_kept * D)

    ones = torch.ones(t, k, device=dev)
    y_buf = torch.randn(n_rows, D, generator=gen, device=dev).to(bf)
    y = combine_rows(y_buf, rows_, ones)
    yr = ref.ref_combine_rows(y_buf, rows_, ones).float()
    ulp = torch.where(yr != 0, torch.exp2(torch.floor(torch.log2(
        yr.abs())) - 7), torch.full_like(yr, 2.0 ** -133))
    cerr = (y.float() - yr).abs()
    if bool((cerr > ulp).any()):
        raise AssertionError("combine_rows train (unit weights): beyond 1 "
                             "bf16 ulp")
    record("combine_rows", "train", cerr.max().item(),
           lambda: combine_rows(y_buf, rows_, ones),
           lambda: ref.ref_combine_rows(y_buf, rows_, ones),
           n_kept * D * 2 + t * k * 8 + t * D * 2, 2 * n_kept * D)
    del buf, y_buf, y, yr, dy

    phase1_grouped_ffn(dev, hw, gen, record)
    rows["grouped_matmul"] = phase1_grouped_matmul(dev, hw, gen)
    rows["flash_attention"] = phase1_flash(dev, hw, gen)
    rows.update(phase1_recurrences(dev, hw, gen))
    return rows


# grouped_ffn at the paths' shapes: (case, groups, rows a group, D, F,
# activation, route, timed iterations).  route None: no index, group g is
# expert g, every row counts; (experts, tokens, top-k, replicas): the serve
# path's in-place hosted weights, slots filled by the weighted route
# (replicas 0: 1..4 an expert at random, the other slots empty); "empty":
# slots of -1 and of 0 rows.  The first five as before: gpt2-moe's serve
# prefill and decode, profiling and training (C = 1288) and a small swiglu
# case; then gpt2-moe's serve prefill and decode with 16 experts in 64
# slots, mixtral-8x22b's (8 swiglu experts of 16384 at d 6144 in 32 slots
# of 640 rows: a 2048-token prefill top-2, ~128 rows a slot, and a decode
# of 4 x 2), and the empty slots
MIX_D, MIX_F, MIX_E, MIX_SLOTS = 6144, 16384, 8, 32
FFN_CASES = (("prefill", N_SLOTS, 24, D, F, "gelu", None, 20),
             ("decode", N_SLOTS, 8, D, F, "gelu", None, 20),
             ("profile", E, 48, D, F, "gelu", None, 20),
             ("train", E, C_TRAIN, D, F, "gelu", None, 20),
             ("swiglu", 4, 16, D, F, "swiglu", None, 20),
             ("serve prefill", N_SLOTS, 24, D, F, "gelu", (E, 256, 1, 0),
              20),
             ("serve decode", N_SLOTS, 8, D, F, "gelu", (E, 8, 1, 0), 20),
             ("mixtral prefill", MIX_SLOTS, 640, MIX_D, MIX_F, "swiglu",
              (MIX_E, 2048, 2, MAX_PACK), 10),
             ("mixtral decode", MIX_SLOTS, 8, MIX_D, MIX_F, "swiglu",
              (MIX_E, 4, 2, MAX_PACK), 10),
             ("empty slot", 4, 200, 512, 1024, "swiglu", "empty", 20))


def ffn_fp32(x, wi, wu, wo, act, group_expert=None, group_rows=None):
    """The plain grouped FFN in fp32 from the bf16 inputs, one group at a
    time (no fp32 copy of every hosted expert's weights)."""
    import torch
    from repro_torch.kernels import ref
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for g in range(x.shape[0]):
        e = g if group_expert is None else int(group_expert[g])
        n = x.shape[1] if group_rows is None else int(group_rows[g])
        if e < 0 or n <= 0:
            continue
        xg = x[g, :n].float()
        h = xg @ wi[e].float()
        h = torch.nn.functional.silu(h) * (xg @ wu[e].float()) \
            if act == "swiglu" else ref.gelu(h)
        out[g, :n] = h @ wo[e].float()
    return out


def ffn_case(g, t, d, f, act, route, gen, dev, weights):
    """Inputs of one grouped_ffn case: (x, wi, wu, wo, group_expert,
    group_rows), x zero past each group's rows as the dispatch leaves it.
    ``weights`` keeps the last case's weights for the next of that shape."""
    import torch
    from repro_torch.core.gating import capacity
    from repro_torch.core.serving import slot_rows
    from repro_torch.kernels import ref
    from repro_torch.kernels.dispatch import invert_slots, weighted_route
    bf = torch.bfloat16
    n_w = route[0] if isinstance(route, tuple) else 3 if route else g
    key = (n_w, d, f, act)
    if key not in weights:
        weights.clear()
        torch.cuda.empty_cache()

        def w(rows, cols):
            return torch.cat([(torch.randn(1, rows, cols, generator=gen,
                                           device=dev) * rows ** -0.5).to(bf)
                              for _ in range(n_w)])
        weights[key] = (w(d, f), w(d, f) if act == "swiglu" else None,
                        w(f, d))
    wi, wu, wo = weights[key]
    if route is None:
        return (torch.randn(g, t, d, generator=gen, device=dev).to(bf), wi,
                wu, wo, None, None)
    if route == "empty":   # slots: expert 2, empty (-1), 0 rows, 77 rows
        ge = torch.tensor([2, -1, 0, 1], dtype=torch.int32, device=dev)
        gr = torch.tensor([t, 150, 0, 77], dtype=torch.int32, device=dev)
    else:
        n_exp, n_tok, k, reps = route
        kept, pos, cum, slot_of = _route_inputs(
            n_tok, k, capacity(n_tok, n_exp, k, 1.25), t, gen, dev,
            n_exp=n_exp, n_slots=g, replicas=reps)
        rows_ = weighted_route(kept, pos, cum, slot_of, t)
        src, _ = invert_slots(rows_, g * t)
        tok = torch.randn(n_tok, d, generator=gen, device=dev).to(bf)
        ge = torch.full((g,), -1, dtype=torch.int32, device=dev)
        for e in range(n_exp):
            ge[slot_of[e][slot_of[e] >= 0].long()] = e
        return (ref.ref_dispatch_rows(tok, src).reshape(g, t, d), wi, wu, wo,
                ge, slot_rows(rows_, g, t))
    x = torch.randn(g, t, d, generator=gen, device=dev).to(bf)
    x = torch.where(torch.arange(t, device=dev)[None, :, None]
                    < gr[:, None, None], x, torch.zeros_like(x))
    return x, wi, wu, wo, ge, gr


def phase1_grouped_ffn(dev, hw, gen, record) -> None:
    """grouped_ffn at FFN_CASES against its fp32 plain version (max abs
    error over max |plain| within FFN_REL), each call repeated bitwise, the
    rows past each count and the empty slots exact zeros; timed beside the
    plain version (gather, bf16 einsum-act-einsum, mask) and the bf16
    einsum-act-einsum composition on weights gathered beforehand, the
    yardstick (no single PyTorch call computes the FFN).  Bound: the bytes
    of x's counted rows, the output and each hosted expert's weights once,
    and the counted rows' operations; the bound with each slot's weights
    read once (what the gather moved) is printed beside it."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.moe_ffn import grouped_ffn
    weights = {}
    for case, g, t, d, f, act, route, iters in FFN_CASES:
        x, wi, wu, wo, ge, gr = ffn_case(g, t, d, f, act, route, gen, dev,
                                         weights)
        kw = dict(ffn_type=act, group_expert=ge, group_rows=gr)
        got = grouped_ffn(x, wi, wu, wo, **kw)
        again = grouped_ffn(x, wi, wu, wo, **kw)
        want = ffn_fp32(x, wi, wu, wo, act, ge, gr)
        torch.cuda.synchronize()
        err = (got.float() - want).abs().max().item()
        rel = err / want.abs().max().item()
        keep = torch.ones((g, t), dtype=torch.bool, device=dev)
        if gr is not None:
            keep &= torch.arange(t, device=dev)[None, :] < gr[:, None]
        if ge is not None:
            keep &= (ge >= 0)[:, None]
        n_rows = int(keep.sum())
        if not rel <= FFN_REL:
            raise AssertionError(f"grouped_ffn {case}: max rel err {rel}")
        if not torch.equal(got, again):
            raise AssertionError(f"grouped_ffn {case}: a repeat differs")
        if bool(got[~keep].any()):
            raise AssertionError(f"grouped_ffn {case}: rows past the count "
                                 f"or of an empty slot are not zero")
        n_w = 3 if act == "swiglu" else 2
        hosted = g if ge is None else int(torch.unique(ge[ge >= 0]).numel())
        slots = g if ge is None else int((ge >= 0).sum())
        w_bytes = n_w * d * f * 2
        io_bytes = (n_rows * d + g * t * d) * 2
        n_ops = 2 * n_w * n_rows * d * f
        b_slot, by_slot = bound_ms(io_bytes + slots * w_bytes, n_ops, hw)
        print(f"  grouped_ffn {case}: [{g}, {t}, {d}] x F {f} {act}, "
              f"{n_rows} counted rows, {hosted} experts in {slots} slots; "
              f"max rel err {rel:.3e}, repeat bitwise; weights "
              f"{hosted * w_bytes / 1e6:.1f} MB once an expert, "
              f"{slots * w_bytes / 1e6:.1f} MB once a slot (bound "
              f"{b_slot:.4f} ms, {by_slot})", flush=True)
        sel = torch.clamp(ge, min=0).long() if ge is not None else None
        wg = [None if a is None or sel is None else a[sel]
              for a in (wi, wu, wo)]
        record("grouped_ffn", case, err,
               lambda: grouped_ffn(x, wi, wu, wo, **kw),
               lambda: ref.ref_grouped_ffn(x, wi, wu, wo, act, ge, gr),
               io_bytes + hosted * w_bytes, n_ops, iters=iters,
               library_fn=lambda: ref.ref_grouped_ffn(
                   x, *(wi, wu, wo) if sel is None else wg, act))
        del x, got, again, want, wg
    weights.clear()
    torch.cuda.empty_cache()


# tolerances of grouped_matmul against its fp32 plain version (allow_tf32
# off), as max abs error over max |plain|: two bf16 operands multiply
# exactly and sum in fp32 (only the summation order differs); an fp32
# operand is rounded to TF32's 10-bit mantissa, a relative error of up to
# 2**-11 per operand, which random-sign sums keep near that size
MM_REL = {"bf16": 1e-5, "tf32": 2e-3}


def mm_case_shape(a_t: bool, b_t: bool, small: bool = False) -> tuple:
    """(E, M, N, K) of one layout mix: each dimension that is some operand's
    contiguous one takes a multiple of 8 values (16 bytes of bf16 or fp32)
    that no tile divides, every other dimension an odd ragged size;
    ``small`` gives M < 64 and E = 1."""
    m = (40 if a_t else 37) if small else (1288 if a_t else 1289)
    k_contig = not a_t or b_t
    k = (200 if k_contig else 201) if small else (1288 if k_contig else 1289)
    n = 201 if b_t else 200
    return (1, m, n, k) if small else (3, m, n, k)


def mm_operands(e, m, n, k, a_bf16, b_bf16, a_t, b_t, gen, dev):
    """Random operands of one mix, a transposed operand as the transpose
    view of its row-major array."""
    import torch
    bf = torch.bfloat16

    def rnd(shape, is_bf, t):
        x = torch.randn(*shape, generator=gen, device=dev).to(
            bf if is_bf else torch.float32)
        return x.transpose(1, 2).contiguous().transpose(1, 2) if t else x
    return rnd((e, m, k), a_bf16, a_t), rnd((e, k, n), b_bf16, b_t)


def phase1_grouped_matmul(dev, hw, gen) -> dict:
    """grouped_matmul at the five GEMMs of one gpt2-moe layer's FFN
    backward (ops._GroupedFFN.backward): h = x @ wi (recompute), da = dy @
    wo.T, dwo = act.T @ dy, dx = dh @ wi.T, dwi = x.T @ dh, transposes read
    in place; each repeated and held bitwise equal to its first result.
    A depth sweep of h and da (K = 768 and 3072) splits their time into
    the mainloop's steady rate and a fixed cost of the tiles.  Then every
    dtype x layout mix (16) at a ragged shape and at M < 64 with
    E = 1, K = 0 (zeros), and one operand that breaks the TMA's 16-byte
    rule (must raise).  Returns the summary row: times, bounds and library
    times summed over the five (one layer's backward), the worst error."""
    import itertools
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.moe_ffn import grouped_matmul, mm_plan
    bf = torch.bfloat16

    def rnd(*shape, dt=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(dt)

    def held(name, a, b):
        """kernel vs plain version: (result, max abs err, rel err, kind)."""
        got = grouped_matmul(a, b)
        want = ref.ref_grouped_matmul(a, b)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        rel = err / max(want.abs().max().item(), 1e-30)
        kind = "bf16" if a.dtype == b.dtype == bf else "tf32"
        if not rel <= MM_REL[kind]:
            raise AssertionError(f"grouped_matmul {name}: max rel err {rel} "
                                 f"> {MM_REL[kind]}")
        return got, err, rel, kind

    x = rnd(E, C_TRAIN, D, dt=bf)
    wi = rnd(E, D, F, dt=bf, scale=D ** -0.5)
    wo = rnd(E, F, D, dt=bf, scale=F ** -0.5)
    dy = rnd(E, C_TRAIN, D, scale=1e-4)
    act = rnd(E, C_TRAIN, F)
    dh = rnd(E, C_TRAIN, F, scale=1e-4)
    cases = (("h", x, wi), ("da", dy, wo.transpose(1, 2)),
             ("dwo", act.transpose(1, 2), dy),
             ("dx", dh, wi.transpose(1, 2)), ("dwi", x.transpose(1, 2), dh))
    tot = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, library_ms=0.0,
               bound_ms=0.0, max_abs_err=0.0)
    bys = {"bytes": 0.0, "operations": 0.0}   # bound ms by limiting side
    for name, a, b in cases:
        got, err, rel, kind = held(name, a, b)
        again = grouped_matmul(a, b)
        if not torch.equal(got, again):
            raise AssertionError(f"grouped_matmul {name}: a repeat is not "
                                 f"bitwise equal")
        e, m, k = a.shape
        n = b.shape[2]
        ms = time_ms(lambda: grouped_matmul(a, b), 20)
        dms = device_ms(lambda: grouped_matmul(a, b), 10)
        plain = time_ms(lambda: ref.ref_grouped_matmul(a, b), 20)
        # library yardstick: torch.bmm on operands of one type (bf16, or
        # fp32 at TF32, the kernel's own arithmetic); casts made beforehand
        a2, b2 = (a, b) if kind == "bf16" else (a.float(), b.float())
        torch.backends.cuda.matmul.allow_tf32 = kind == "tf32"
        lib = time_ms(lambda: torch.bmm(a2, b2), 20)
        torch.backends.cuda.matmul.allow_tf32 = False
        nbytes = a.numel() * a.element_size() + b.numel() * b.element_size() \
            + e * m * n * 4
        bnd, by = bound_ms(nbytes, 2 * e * m * n * k, hw,
                           peak=None if kind == "bf16" else TF32_FLOPS)
        bys[by] += bnd
        print(f"  grouped_matmul     {name:4s} [{e},{m},{k}]x[{e},{k},{n}] "
              f"{kind}: rel err {rel:.3e} (limit {MM_REL[kind]}), repeat "
              f"bitwise equal  kernel {ms:.4f} ms (device {dms:.4f}, "
              f"{2 * e * m * n * k / dms / 1e9:.1f} TFLOP/s, "
              f"{100 * bnd / dms:.1f}% of bound)  plain {plain:.4f} ms  "
              f"torch.bmm {lib:.4f} ms  bound {bnd:.4f} ms ({by})",
              flush=True)
        for key, v in (("ms", ms), ("device_ms", dms), ("plain_ms", plain),
                       ("library_ms", lib), ("bound_ms", bnd)):
            tot[key] += v
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        del got, again, a2, b2
    print(f"  grouped_matmul, one layer's backward (5 GEMMs): kernel "
          f"{tot['ms']:.4f} ms (device {tot['device_ms']:.4f})  plain "
          f"{tot['plain_ms']:.4f} ms  torch.bmm {tot['library_ms']:.4f} ms  "
          f"bound {tot['bound_ms']:.4f} ms", flush=True)
    del x, wi, wo, dy, act, dh, cases

    # depth sweep of h and da at K = 768 and 3072: the slope between the two
    # is the mainloop's steady rate, what is left at K = 768 the fixed cost
    # of the tiles (pipeline fill, epilogue)
    for name, a_bf16 in (("h", True), ("da", False)):
        t = {}
        for k in (D, 4 * D):
            a = rnd(E, C_TRAIN, k, dt=bf if a_bf16 else torch.float32)
            b = rnd(E, k, F, dt=bf) if a_bf16 else \
                rnd(E, F, k, dt=bf).transpose(1, 2)
            t[k] = device_ms(lambda: grouped_matmul(a, b), 10)
            del a, b
        slope = (t[4 * D] - t[D]) / (3 * D)
        print(f"  grouped_matmul depth sweep {name}: device {t[D]:.4f} ms at "
              f"K {D}, {t[4 * D]:.4f} ms at K {4 * D}: steady "
              f"{2 * E * C_TRAIN * F / slope / 1e9:.1f} TFLOP/s, fixed "
              f"{t[D] - slope * D:.4f} ms", flush=True)

    # every dtype x layout mix at a ragged shape, and at M < 64 with E = 1
    worst = {"bf16": 0.0, "tf32": 0.0}
    for a_bf16, b_bf16, a_t, b_t in itertools.product((True, False),
                                                      repeat=4):
        plan = mm_plan(a_bf16, b_bf16, a_t, b_t)
        for small in (False, True):
            e, m, n, k = mm_case_shape(a_t, b_t, small)
            a, b = mm_operands(e, m, n, k, a_bf16, b_bf16, a_t, b_t, gen,
                               dev)
            tag = (f"{'bf16' if a_bf16 else 'fp32'}{'ᵀ' if a_t else ''} . "
                   f"{'bf16' if b_bf16 else 'fp32'}{'ᵀ' if b_t else ''} "
                   f"[{e},{m},{k}]x[{e},{k},{n}]")
            _, err, rel, kind = held(tag, a, b)
            worst[kind] = max(worst[kind], rel)
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
        print(f"  grouped_matmul mix {tag.split(' [')[0]:15s} ({plan.kernel} "
              f"kernel, kinds {plan.a_kind}/{plan.b_kind}): held at "
              f"{mm_case_shape(a_t, b_t)} and "
              f"{mm_case_shape(a_t, b_t, True)}", flush=True)
    print(f"  grouped_matmul, 16 mixes x 2 shapes: worst rel err bf16 "
          f"{worst['bf16']:.3e} (limit {MM_REL['bf16']}), tf32 "
          f"{worst['tf32']:.3e} (limit {MM_REL['tf32']})", flush=True)

    # K = 0 writes zeros; an operand whose rows are not a multiple of 16
    # bytes (K = 12 bf16 values, 24 bytes) is refused
    z = grouped_matmul(torch.ones(2, 5, 0, device=dev),
                       torch.ones(2, 0, 8, device=dev))
    torch.cuda.synchronize()
    if tuple(z.shape) != (2, 5, 8) or bool(z.any()):
        raise AssertionError("grouped_matmul K = 0 did not write zeros")
    try:
        grouped_matmul(torch.ones(2, 5, 12, device=dev, dtype=bf),
                       torch.ones(2, 12, 8, device=dev, dtype=bf))
    except ValueError as err:
        print(f"  grouped_matmul K = 0: zeros; 24-byte rows refused: {err}",
              flush=True)
    else:
        raise AssertionError("grouped_matmul took rows of 24 bytes")
    return dict(tot, case="layer backward (5 GEMMs)",
                bound_by=max(bys, key=lambda b: bys[b]))


# flash_attention against ref_attention: (name, B, S, H, KV, hd, causal,
# window, timed iterations).  gpt2-moe's serve prefill and a GPT-2 context;
# mixtral-8x22b within its 4096 window and past it (phase 4's score-only
# prompts); bert-large-moe's bidirectional attention (the server's kernel
# route for that model); zamba2-1.2b's shared attention block at its 4 x
# 2048 prefill (phase 6); a ragged S with GQA and a window that cuts
FLASH_CASES = (("a gpt2 prefill", 4, 64, 12, 12, 64, True, 0, 50),
               ("b gpt2 1024", 8, 1024, 12, 12, 64, True, 0, 20),
               ("c mixtral 2048", 1, 2048, 48, 8, 128, True, 4096, 20),
               ("d mixtral 6144", 1, 6144, 48, 8, 128, True, 4096, 10),
               ("e bert non-causal", 8, 512, 16, 16, 64, False, 0, 20),
               ("f zamba2 shared", 4, 2048, 32, 32, 64, True, 0, 10),
               ("g ragged gqa", 2, 1000, 48, 8, 128, True, 256, 20))
FLASH_ROW_CASE = "d mixtral 6144"     # the kernels line's row
# norm-wise ||kernel - plain|| / ||plain||: the kernel rounds P to bf16
# before P.V (2**-9 relative per element) and its output to bf16
FLASH_REL = 1e-2


def unmasked_pairs(s: int, causal: bool, window: int) -> int:
    """(query, key) pairs of one head that the mask keeps."""
    import numpy as np
    i = np.arange(s, dtype=np.int64)
    hi = i + 1 if causal else np.full_like(i, s)
    lo = np.maximum(i - window + 1, 0) if window else np.zeros_like(i)
    return int((hi - lo).sum())


def plain_attention(q, k, v, causal: bool, window: int):
    """ref_attention, over one KV head's query heads at a time past 2048
    tokens, so its fp32 [S, S] logits fit."""
    import torch
    from repro_torch.kernels import ref
    s, h, kv = q.shape[1], q.shape[2], k.shape[2]
    if s <= 2048:
        return ref.ref_attention(q, k, v, causal=causal, window=window)
    rep = h // kv
    return torch.cat([ref.ref_attention(
        q[:, :, j * rep:(j + 1) * rep], k[:, :, j:j + 1], v[:, :, j:j + 1],
        causal=causal, window=window) for j in range(kv)], dim=2)


def phase1_flash(dev, hw, gen) -> dict:
    """flash_attention at FLASH_CASES against its plain version, each call
    repeated bitwise; timed beside torch's scaled_dot_product_attention
    (enable_gqa; is_causal, or an explicit mask where the window cuts).
    Returns the summary row of FLASH_ROW_CASE (phase 4's 6144-token prompt),
    with the largest error of all cases."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    bf = torch.bfloat16
    row, worst = None, 0.0
    for name, b, s, h, kv, hd, causal, window, iters in FLASH_CASES:
        q = torch.randn(b, s, h, hd, generator=gen, device=dev).to(bf)
        k, v = (torch.randn(b, s, kv, hd, generator=gen, device=dev).to(bf)
                for _ in range(2))
        with torch.inference_mode():
            got = flash_attention(q, k, v, causal=causal, window=window)
            again = flash_attention(q, k, v, causal=causal, window=window)
            want = plain_attention(q, k, v, causal, window).float()
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"flash_attention {name}: a repeat is "
                                     f"not bitwise equal")
            del again
            diff = got.float() - want
            err = diff.abs().max().item()
            rel = (diff.norm() / want.norm()).item()
            del diff
            if not (torch.isfinite(got).all() and rel <= FLASH_REL):
                raise AssertionError(f"flash_attention {name}: norm-wise rel "
                                     f"err {rel} > {FLASH_REL}")
            ms = time_ms(lambda: flash_attention(q, k, v, causal=causal,
                                                 window=window), iters, 3)
            dms = device_ms(lambda: flash_attention(
                q, k, v, causal=causal, window=window), min(iters, 10))
            plain = time_ms(lambda: plain_attention(q, k, v, causal, window),
                            min(iters, 10), 2)
            # the yardstick: one PyTorch call, [B, H, S, hd] views
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            mask = None
            if window and window < s:
                i = torch.arange(s, device=dev)
                mask = (i[None, :] > i[:, None] - window) & \
                    ((i[None, :] <= i[:, None]) if causal else True)

            def sdpa():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask,
                    is_causal=causal and mask is None, enable_gqa=True)
            lib_rel = ((sdpa().transpose(1, 2).float() - want).norm()
                       / want.norm()).item()
            lib = time_ms(sdpa, iters, 3)
            del got, want
        pairs = unmasked_pairs(s, causal, window)
        nbytes = 2 * (2 * b * s * h * hd + 2 * b * s * kv * hd)
        bnd, by = bound_ms(nbytes, 4 * hd * pairs * h * b, hw)
        worst = max(worst, err)
        print(f"  flash_attention    {name}: B{b} S{s} H{h}/{kv} hd{hd} "
              f"causal={causal} window={window}: max abs err {err:.3e}, "
              f"norm-wise {rel:.3e} (limit {FLASH_REL}), repeat bitwise  "
              f"kernel {ms:.4f} ms (device {dms:.4f}, "
              f"{4 * hd * pairs * h * b / dms / 1e9:.1f} TFLOP/s, "
              f"{100 * bnd / dms:.1f}% of the bound)  plain {plain:.4f} ms  "
              f"sdpa {lib:.4f} ms (norm-wise {lib_rel:.3e})  bound "
              f"{bnd:.4f} ms ({by}; {pairs} pairs a head)", flush=True)
        if name == FLASH_ROW_CASE:
            row = dict(case=name, ms=ms, device_ms=dms, plain_ms=plain,
                       library_ms=lib, bound_ms=bnd, bound_by=by)
        del q, k, v, qt, kt, vt, mask
    return dict(row, max_abs_err=worst)


# fp32 arithmetic outside the tensor cores (NVIDIA's H100 SXM data sheet):
# the rate the WKV and SSD kernels compute at
FP32_FLOPS = 67e12
# norm-wise ||kernel - plain|| / ||plain|| of the two recurrences: both
# compute in fp32 from the same bf16 inputs, summing in other orders (and
# the SSD kernel in its chunked form)
REC_REL = 1e-4
# the rwkv6-1.6b / zamba2-1.2b serve shapes: B, T, H, hd; B, T, H, P, N
WKV_SHAPE = (4, 2048, 32, 64)
SSD_SHAPE = (4, 2048, 64, 64, 64)


def rel_err(got, want) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def wkv_cost(b, t, h, hd, s_in: bool = False, s_out: bool = False):
    """(bytes, operations) of one WKV call: r, k, v bf16 and w, y fp32 read
    or written once, u, the state in and out if present; per step of a
    head 5 hd^2 (y and the state update) + 6 hd (exp, the bonus sum, v
    times it)."""
    nbytes = b * t * h * hd * (3 * 2 + 4 + 4) + h * hd * 4 \
        + (s_in + s_out) * b * h * hd * hd * 4
    return nbytes, b * h * t * (5 * hd * hd + 6 * hd)


def ssd_cost(b, t, h, p, n, s_in: bool = False, s_out: bool = False,
             q: int = 128):
    """(bytes, operations) of one SSD scan: x, dt, B, C bf16 read once, y
    fp32 written once, a_log and D, the state in and out if present.  Per
    chunk of nv rows: the lower triangle of C B^T (2N), once per batch row,
    because B and C are shared by every head; then per head its decay and
    dt (3) and M x (2P), C h^T with the decay and D skip (2N + 4 per
    element of y), the state update (2N + 1 per element of x) and the
    state's decay (2PN)."""
    nbytes = b * t * (h * p * 2 + h * 2 + 2 * n * 2 + h * p * 4) + 2 * h * 4 \
        + (s_in + s_out) * b * h * p * n * 4
    ops = 0
    for t0 in range(0, t, q):
        nv = min(q, t - t0)
        tri = nv * (nv + 1) // 2
        ops += tri * 2 * n + h * (tri * (3 + 2 * p) + nv * p * (4 * n + 5)
                                  + 2 * p * n)
    return nbytes, b * ops


def add_costs(*costs) -> tuple:
    return tuple(sum(c[i] for c in costs) for i in range(2))


def phase1_recurrences(dev, hw, gen) -> dict:
    """rwkv6_wkv and ssd_scan against ref_rwkv6 / ref_ssd on the card, at
    the serve shapes of rwkv6-1.6b and zamba2-1.2b: WKV at the prefill shape
    with a random non-zero bonus u (the models start it at zero), at the
    decode shape (T = 1) from a random state, and split in two calls that
    carry the state; SSD at the prefill shape with x, B and C sliced in
    place from one projection, at a ragged T and split in two calls.
    Returns each kernel's summary row (the prefill case)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.rwkv6 import rwkv6_wkv
    from repro_torch.kernels.ssd import ssd_scan
    bf = torch.bfloat16
    rows = {}

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def report(name, case, errs, kernel, plain, nbytes, nops, iters=20,
               tf32=False):
        err = max(v for k, v in errs.items() if k != "max_abs")
        if not err <= REC_REL:
            raise AssertionError(f"{name} {case}: norm-wise rel err {errs} > "
                                 f"{REC_REL}")
        ms = time_ms(kernel, iters, 3)
        dms = device_ms(kernel, min(iters, 10))
        pms = time_ms(plain, 2, 1)
        bnd, by = bound_ms(nbytes, nops, hw, peak=FP32_FLOPS)
        extra = ""
        if tf32:
            b32, by32 = bound_ms(nbytes, nops, hw, peak=TF32_FLOPS)
            extra = f"; at TF32 {b32:.4f} ms ({by32})"
        print(f"  {name:18s} {case:8s} norm-wise rel err "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f" (limit {REC_REL})  kernel {ms:.4f} ms (device {dms:.4f}, "
              f"{nops / dms / 1e9:.2f} TFLOP/s)  plain {pms:.4f} ms  bound "
              f"{bnd:.4f} ms ({by}, fp32 peak{extra}; {nbytes} bytes, "
              f"{nops} operations)", flush=True)
        row = dict(case=case, ms=ms, device_ms=dms, plain_ms=pms,
                   library_ms=None, bound_ms=bnd, bound_by=by,
                   max_abs_err=errs["max_abs"])
        cur = rows.get(name)
        if cur is None:
            rows[name] = row
        else:
            cur["max_abs_err"] = max(cur["max_abs_err"], errs["max_abs"])

    with torch.inference_mode():
        # -- rwkv6_wkv: the model's value ranges (unit r, k, v; decays near
        # exp(-exp(-2)) = 0.87), a random bonus u
        b, t, h, hd = WKV_SHAPE
        r, k, v = (rnd(b, t, h, hd).to(bf) for _ in range(3))
        w = -torch.exp(rnd(b, t, h, hd, scale=0.5) - 2.0)
        u = rnd(h, hd, scale=0.5)
        y = rwkv6_wkv(r, k, v, w, u)
        want = ref.ref_rwkv6(r, k, v, w, u)
        errs = {"y": rel_err(y, want),
                "max_abs": (y - want).abs().max().item()}
        report("rwkv6_wkv", "prefill", errs,
               lambda: rwkv6_wkv(r, k, v, w, u),
               lambda: ref.ref_rwkv6(r, k, v, w, u),
               *wkv_cost(b, t, h, hd))
        # the split: two calls carrying the state against one call
        cut = 1000
        halves = [tuple(a[:, sl].contiguous() for a in (r, k, v, w))
                  for sl in (slice(0, cut), slice(cut, t))]

        def split_run(fn):
            y1, s1 = fn(*halves[0], u, return_state=True)
            y2, s2 = fn(*halves[1], u, s0=s1, return_state=True)
            return torch.cat([y1, y2], dim=1), s2

        split, s2 = split_run(rwkv6_wkv)
        y_all, s_all = rwkv6_wkv(r, k, v, w, u, return_state=True)
        _, s_ref = ref.ref_rwkv6(r, k, v, w, u, return_state=True)
        errs = {"y vs one call": rel_err(split, y_all),
                "state vs one call": rel_err(s2, s_all),
                "y vs plain": rel_err(split, want),
                "state vs plain": rel_err(s2, s_ref),
                "max_abs": max((split - want).abs().max().item(),
                               (s2 - s_ref).abs().max().item())}
        report("rwkv6_wkv", f"split@{cut}", errs,
               lambda: split_run(rwkv6_wkv), lambda: split_run(ref.ref_rwkv6),
               *add_costs(wkv_cost(b, cut, h, hd, s_out=True),
                          wkv_cost(b, t - cut, h, hd, True, True)), iters=5)
        del r, k, v, w, y, want, halves, split, y_all
        # decode: one step from a random state
        r1, k1, v1 = (rnd(b, 1, h, hd).to(bf) for _ in range(3))
        w1 = -torch.exp(rnd(b, 1, h, hd, scale=0.5) - 2.0)
        s0 = rnd(b, h, hd, hd, scale=2.0)
        y, st = rwkv6_wkv(r1, k1, v1, w1, u, s0=s0, return_state=True)
        wy, ws = ref.ref_rwkv6(r1, k1, v1, w1, u, s0=s0, return_state=True)
        errs = {"y": rel_err(y, wy), "state": rel_err(st, ws),
                "max_abs": max((y - wy).abs().max().item(),
                               (st - ws).abs().max().item())}
        report("rwkv6_wkv", "decode", errs,
               lambda: rwkv6_wkv(r1, k1, v1, w1, u, s0=s0,
                                 return_state=True),
               lambda: ref.ref_rwkv6(r1, k1, v1, w1, u, s0=s0,
                                     return_state=True),
               *wkv_cost(b, 1, h, hd, True, True), iters=50)

        # -- ssd_scan: x, B and C sliced from one [B, T, H*P + 2N] tensor as
        # the model's convolved projection; zamba2's a_log, unit D
        b, t, h, p, n = SSD_SHAPE
        a_log = torch.log(torch.linspace(1.0, 16.0, h, device=dev))
        d_skip = torch.ones(h, device=dev)
        for case, tt in (("prefill", t), ("ragged", 2000)):
            xbc = rnd(b, tt, h * p + 2 * n).to(bf)
            x = xbc[..., :h * p].reshape(b, tt, h, p)
            bb, cc = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
            dt = rnd(b, tt, h).to(bf)
            y = ssd_scan(x, dt, a_log, bb, cc, d_skip)
            want = ref.ref_ssd(x, dt, a_log, bb, cc, d_skip)
            if not torch.isfinite(y).all():
                raise AssertionError(f"ssd_scan {case}: non-finite output")
            errs = {"y": rel_err(y, want),
                    "max_abs": (y - want).abs().max().item()}
            report("ssd_scan", case, errs,
                   lambda: ssd_scan(x, dt, a_log, bb, cc, d_skip),
                   lambda: ref.ref_ssd(x, dt, a_log, bb, cc, d_skip),
                   *ssd_cost(b, tt, h, p, n), tf32=True)
        # the split (at T = 2000, mid-chunk): two calls carrying the state,
        # the strided slices passed as they are
        cut = 1000

        def ssd_split(fn):
            y1, h1 = fn(x[:, :cut], dt[:, :cut], a_log, bb[:, :cut],
                        cc[:, :cut], d_skip, return_state=True)
            y2, h2 = fn(x[:, cut:], dt[:, cut:], a_log, bb[:, cut:],
                        cc[:, cut:], d_skip, h0=h1, return_state=True)
            return torch.cat([y1, y2], dim=1), h2

        split, h2 = ssd_split(ssd_scan)
        _, h_ref = ref.ref_ssd(x, dt, a_log, bb, cc, d_skip,
                               return_state=True)
        errs = {"y vs plain": rel_err(split, want),
                "state vs plain": rel_err(h2, h_ref),
                "max_abs": max((split - want).abs().max().item(),
                               (h2 - h_ref).abs().max().item())}
        report("ssd_scan", f"split@{cut}", errs,
               lambda: ssd_split(ssd_scan), lambda: ssd_split(ref.ref_ssd),
               *add_costs(ssd_cost(b, cut, h, p, n, s_out=True),
                          ssd_cost(b, 2000 - cut, h, p, n, True, True)),
               iters=5, tf32=True)
    return rows


# ---------------------------------------------------------------------------
# phase 2: the serve path end to end
# ---------------------------------------------------------------------------

def profile_busy(step, what: str) -> float:
    """Run ``step`` once more (after one unprofiled run) under
    torch.profiler; print its host wall time, the card's busy time (kernel
    time summed) and share, and the top kernels.  Returns the busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
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
    print(f"{what}: wall {wall * 1e3:.3f} ms, device busy "
          f"{dev_us / 1e3:.3f} ms "
          f"({100 * dev_us / 1e6 / wall:.1f}% of wall), "
          f"{sum(e.count for e in kern)} kernels", flush=True)
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms  "
              f"x{e.count:<5d} {e.key[:90]}", flush=True)
    return dev_us / 1e6 / wall


def device_busy(srv, toks, tag: str = "phase 2",
                cache_len: int = 40) -> None:
    """Device busy share of one prefill and one decode step of the served
    model: kernel time summed by torch.profiler over the host wall time."""
    pre = srv.prefill_batch(toks, cache_len=cache_len)
    for name, step in (
            ("prefill", lambda: srv.prefill_batch(toks, cache_len=cache_len)),
            ("decode", lambda: srv.decode_batch(
                pre.logits.argmax(-1), pre.cache, pre.path_ids[:, -1]))):
        profile_busy(step, f"{tag} {name} step")


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


def ulp_margins(logits, probs, k: int):
    """Margins for two routes whose bf16 router logits may each land one
    ulp apart (both round an fp32 sum of D products to bf16, in different
    orders).  With logit j moved by d_j, |d_j| <= u_j (its bf16 ulp),
    probability i moves by p_i (d_i - sum_j p_j d_j), so at most
    p_i (u_i (1 - p_i) + sum_{j != i} p_j u_j); the gap between the k-th and
    (k+1)-th largest probabilities moves by at most the sum of their two
    bounds.  ``logits`` and ``probs`` [T, E] are the plain route's.
    Returns (PROB_MARGIN + the bound [T, E], PROB_MARGIN + the gap's bound
    [T], the gap [T])."""
    import torch
    z, p = logits.float(), probs.float()
    u = torch.exp2(torch.floor(torch.log2(z.abs().clamp_min(2.0 ** -126)))
                   - 7)
    pu = p * u
    dp = p * (u * (1 - p) + pu.sum(-1, keepdim=True) - pu)
    srt, order = torch.sort(p, dim=-1, descending=True)
    pair = dp.gather(-1, order[:, k - 1:k + 1]).sum(-1)
    return PROB_MARGIN + dp, PROB_MARGIN + pair, srt[:, k - 1] - srt[:, k]


def replay_plain(calls, what: str, tag: str = "phase 2") -> None:
    """Each recorded kernel-route layer call again through the plain route,
    on the same input, plan, cap, slot_cap and route mode.  Each router
    probability must agree within its ``ulp_margins`` bound (PROB_MARGIN
    plus what one-ulp shifts of the token's bf16 logits allow that expert)
    and gate ids may differ only where the plain route's top-k gap is
    within the gap's bound; every token whose expert no flip touched must
    be kept or dropped alike and agree within FFN_REL.  Mixtral's logits
    (D=6144, |logit| up to ~4) need the ulp terms, and so did gpt2-moe's
    once: one logit of 1.92 one ulp (2**-7) apart moved its probability
    (0.22) by 1.35e-3."""
    import torch
    from repro_torch.core.serving import serve_moe_layer, slot_capacity
    report = []
    for li, (x, params, mcfg, plan, kw, (yk, ik, pk)) in enumerate(calls):
        yp, ip, pp = serve_moe_layer(
            x, params, dataclasses.replace(mcfg, compute_backend="xla"), plan,
            **kw)
        k = ik.shape[1]
        ptol, gtol, gap = ulp_margins(x @ params.router, pp, k)
        perr_e = (pk.float() - pp.float()).abs()
        perr = perr_e.max().item()
        share = (perr_e / ptol).max().item()
        beyond = (perr_e > ptol).any(-1)
        flip = (ik != ip).any(-1)
        wide = flip & (gap > gtol)
        touched = torch.cat([ik[flip].reshape(-1), ip[flip].reshape(-1)])
        alike = ~(torch.isin(ik.long(), touched.long())
                  | torch.isin(ip.long(), touched.long())).any(-1)
        dk, dp = (yk == 0).all(-1), (yp == 0).all(-1)
        rel = ((yk.float() - yp.float())[alike].abs().max()
               / yp.float().abs().max()).item() if alike.any() else 0.0
        cap = kw["cap_override"]
        report.append(f"L{li}:{int(flip.sum())}f/{int(dp.sum())}d/"
                      f"{rel:.1e}/p{perr:.1e}/m{share:.2f}")
        if beyond.any() or wide.any() or \
                not torch.equal(dk[alike], dp[alike]) or not rel <= FFN_REL:
            raise AssertionError(
                f"{what} layer {li} (T={x.shape[0]}, cap {cap}, slot_cap "
                f"{slot_capacity(cap, kw['min_replicas'])}): kernel route "
                f"disagrees with the plain route: probs err {perr:.3e} "
                f"({int(beyond.sum())} tokens beyond their margin, largest "
                f"share of a margin {share:.2f}), "
                f"{int(wide.sum())} flips beyond the margin, max rel err "
                f"{rel:.3e}")
    x, _, _, _, kw, _ = calls[0]
    print(f"{tag}: {what}, each MoE layer's kernel route replayed through "
          f"the plain route (T={x.shape[0]}, cap {kw['cap_override']}, "
          f"slot_cap {slot_capacity(kw['cap_override'], kw['min_replicas'])} "
          f"at layer 0; per layer flips f / drops d / max rel err / max "
          f"probs err / largest share of an expert's margin): "
          f"{' '.join(report)}", flush=True)


def replay_prefill_decode(srv, toks, tag: str = "phase 2"):
    """One kernel-route prefill (cache_len S + 8) and decode step of
    ``srv``, every MoE layer call of each replayed through the plain route
    (``replay_plain``).  Returns (prefill result, its tapped layer calls)."""
    import torch
    s = toks.shape[1]
    kcalls, dcalls = [], []
    with torch.inference_mode():
        with tap_layers(kcalls):
            pre = srv.prefill_batch(toks, cache_len=s + 8)
        with tap_layers(dcalls):
            srv.decode_batch(pre.logits.argmax(-1), pre.cache,
                             pre.path_ids[:, -1])
        replay_plain(kcalls, "prefill", tag)
        replay_plain(dcalls, "decode step", tag)
    return pre, kcalls


def compare_whole(kcalls, pcalls, shape, device, what: str,
                  tag: str = "phase 2"):
    """The whole model's kernel route against its plain route on the same
    tokens, from the two runs' tapped MoE layer calls.  A token is *clean*
    at a layer while no gate flip and no drop difference has happened at or
    before it in its row (attention is causal); a clean token's MoE input
    must agree within DRIFT_REL, and a gate id may differ at a clean token
    only where the plain route's fp32 logit gap is within what that drift
    and bf16 rounding allow.  Returns ([B] rows with no event, [B] rows
    whose last token flipped no gate)."""
    import torch
    b, s = shape
    dirty = torch.zeros(b, s, dtype=torch.bool, device=device)
    own = torch.zeros(b, s, dtype=torch.bool, device=device)
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
                f"{what} layer {li}: clean tokens drifted "
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
                f"{what} layer {li}: {int(wide.sum())} clean-token gate "
                f"flips beyond the bf16 margin (max gap "
                f"{gap[wide].max().item():.3e})")
        report.append(f"L{li}:{int((flip & clean).sum())}c+"
                      f"{int((flip & ~clean).sum())}")
        event = (flip | drop).reshape(b, s)
        own |= event
        dirty |= torch.cummax(event.int(), dim=1).values.bool()
        del xk, xp, drift, lp
    print(f"{tag}: {what} ({b} x {s} tokens): gate ids that differ per "
          f"layer, at clean + at already-diverged tokens: {' '.join(report)};"
          f" max clean drift {worst:.3e} (limit {DRIFT_REL})", flush=True)
    return ~dirty.any(1).cpu().numpy(), ~own[:, -1].cpu().numpy()


def compare_routes(srv, toks) -> None:
    """The served model's kernel route against its plain route: every MoE
    call of one kernel-route prefill and decode step replayed through the
    plain route (``replay_prefill_decode``), and one prefill of the whole
    model both ways, with the same weights and profile
    (``compare_whole``); a row with no gate flip must agree at the
    last-token logits."""
    import numpy as np
    import torch
    from repro_torch.runtime.server import MoEServer
    cfg = srv.cfg
    b, s = toks.shape
    pre, kcalls = replay_prefill_decode(srv, toks)
    pcalls = []
    with torch.inference_mode():
        plain_cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, compute_backend="xla"))
        plain = MoEServer(plain_cfg, srv.params, srv.profile, srv.scfg,
                          device=srv.device)
        with tap_layers(pcalls):
            lp_last = plain.prefill_batch(toks, cache_len=s + 8).logits
    lk_last = pre.logits
    if not (np.isfinite(lk_last).all() and lk_last.shape == lp_last.shape):
        raise AssertionError("kernel-route prefill logits not finite")
    clean_rows, _ = compare_whole(kcalls, pcalls, (b, s), srv.device,
                                  "whole model, kernel vs plain route prefill")
    cos = (lk_last * lp_last).sum(1) / (np.linalg.norm(lk_last, axis=1)
                                         * np.linalg.norm(lp_last, axis=1))
    print(f"phase 2: rows with no flip {int(clean_rows.sum())} of {b}; "
          f"last-token logits cosine per row {np.round(cos, 6).tolist()}, "
          f"argmax agreement "
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
    missing = [n for n, c in launches.items()
               if c == 0 and n not in TRAIN_ONLY | RECURRENT]
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


# ---------------------------------------------------------------------------
# phase 4: mixtral-8x22b served at full width
# ---------------------------------------------------------------------------

MIX_LAYERS = 2           # depth cut: 2.504 B parameters a layer
MIX_GEN = (4, 2048, 16)  # requests, prompt tokens, new tokens (in the window)
MIX_SCORE = (2, 6144)    # score-only requests, prompt tokens (past it)
LOGIT_REL = 2e-2         # norm-wise, last-token logits, kernel vs plain


@contextlib.contextmanager
def plain_route(srv):
    """``srv`` on the plain route ("xla": plain attention, plain MoE ops)
    for the duration, sharing its bf16 weights (a second server would cast
    the 21.6 GB of fp32 masters again)."""
    cfg = srv.cfg
    srv.cfg = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, compute_backend="xla"))
    try:
        yield srv
    finally:
        srv.cfg = cfg


def phase4(dev) -> dict:
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import COUNTERS, reset_counters
    from repro_torch.models import lm as lm_mod
    from repro_torch.runtime.engine import (ServingEngine, simulate,
                                            summarize_results)
    from repro_torch.runtime.server import (MoEServer, ServerConfig,
                                            profile_from_training)
    from repro_torch.tree import tree_leaves
    cfg = dataclasses.replace(get_config("mixtral-8x22b"), n_layers=MIX_LAYERS)
    n_gen, gen_len, new_tok = MIX_GEN
    n_score, score_len = MIX_SCORE
    gc.collect()                  # the earlier phases' tensors
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = lm_mod.init_params(cfg, gen, device=dev)
    n_params = sum(p.numel() for p in tree_leaves(params))
    torch.cuda.synchronize(dev)
    print(f"phase 4: {cfg.name} at depth {cfg.n_layers} (d {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, hd {cfg.head_dim}, "
          f"{cfg.moe.n_experts} {cfg.ffn_type} experts of {cfg.moe.d_ff}, "
          f"vocab {cfg.vocab_size}, window {cfg.sliding_window}): "
          f"{n_params} params, initialised in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=gen_len,
                                global_batch=2, seed=0))
    rng = np.random.RandomState(11)
    gen_trace = [(rng.randint(0, cfg.vocab_size, (gen_len,)), 0.05 * i)
                 for i in range(n_gen)]
    score_trace = [(rng.randint(0, cfg.vocab_size, (score_len,)), 0.05 * i)
                   for i in range(n_score)]

    reset_counters()
    t0 = time.perf_counter()
    prof = profile_from_training(
        cfg, params, (ds.batch(i) for i in range(3)), device=dev)
    srv = MoEServer(cfg, params, prof, ServerConfig(), device=dev)
    engine = ServingEngine(srv)
    with torch.inference_mode():
        gen_res = simulate(engine, gen_trace, max_new_tokens=new_tok)
        score_res = simulate(engine, score_trace, max_new_tokens=0)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = {n: c.count for n, c in COUNTERS.items()}
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"phase 4: profiled and served in {wall:.2f} s wall; peak device "
          f"memory {peak:.2f} GiB", flush=True)
    print("phase 4 launches: " + json.dumps(launches), flush=True)
    missing = [n for n, c in launches.items()
               if c == 0 and n not in TRAIN_ONLY | RECURRENT]
    if missing:
        raise AssertionError(f"kernels never launched serving {cfg.name}: "
                             f"{missing}")

    for r in gen_res + score_res:
        if not np.isfinite(r.logits).all() or r.logits.shape != \
                (cfg.vocab_size,):
            raise AssertionError(f"request {r.rid}: bad logits")
    for r in gen_res:
        if r.tokens is None or r.tokens.shape != (new_tok,) or \
                r.tokens.min() < 0 or r.tokens.max() >= cfg.vocab_size:
            raise AssertionError(f"request {r.rid}: bad tokens")
    if len(gen_res) != n_gen or len(score_res) != n_score or \
            any(r.tokens is not None for r in score_res):
        raise AssertionError("phase 4: requests missing")
    m = summarize_results(gen_res)
    ms = summarize_results(score_res)
    print(f"phase 4: {n_gen} requests x {gen_len} prompt + {new_tok} new "
          f"tokens: TTFT p50 {m['ttft_p50'] * 1e3:.3f} ms p95 "
          f"{m['ttft_p95'] * 1e3:.3f} ms  TPOT p50 {m['tpot_p50'] * 1e3:.3f} "
          f"ms p95 {m['tpot_p95'] * 1e3:.3f} ms  {m['gen_tok_s']:.3f} gen "
          f"tok/s  latency p50 {m['latency_p50'] * 1e3:.3f} ms; {n_score} "
          f"score-only x {score_len}: latency p50 "
          f"{ms['latency_p50'] * 1e3:.3f} ms p95 "
          f"{ms['latency_p95'] * 1e3:.3f} ms; plan reuse "
          f"{engine.plan_reuse_rate:.4f}  fine-tune rate "
          f"{engine.finetune_rate:.4f}", flush=True)

    toks = np.random.RandomState(7).randint(0, cfg.vocab_size, (2, gen_len))
    device_busy(srv, toks, "phase 4", cache_len=gen_len + 8)
    replay_prefill_decode(srv, toks, "phase 4")

    # a score-only prompt past the window through both routes: flash (the
    # window branch) against the query-blocked plain attention
    long = np.random.RandomState(8).randint(0, cfg.vocab_size,
                                            (1, score_len))
    kcalls, pcalls = [], []
    with torch.inference_mode():
        with tap_layers(kcalls):
            lk = srv.serve_batch(long).logits
        with plain_route(srv), tap_layers(pcalls):
            lp = srv.serve_batch(long).logits
    if not (np.isfinite(lk).all() and lk.shape == lp.shape):
        raise AssertionError("phase 4: kernel-route logits not finite")
    _, last_clean = compare_whole(
        kcalls, pcalls, long.shape, dev,
        "whole model, kernel vs plain route, score-only past the window",
        "phase 4")
    del kcalls, pcalls
    rel = np.linalg.norm(lk - lp, axis=1) / np.linalg.norm(lp, axis=1)
    print(f"phase 4: last-token logits, norm-wise rel err per row "
          f"{[float(f'{r:.3e}') for r in rel]} (limit {LOGIT_REL}; held "
          f"where the last token flipped no gate: {last_clean.tolist()}), "
          f"argmax agreement {float((lk.argmax(1) == lp.argmax(1)).mean()):.2f}",
          flush=True)
    if (rel[last_clean] > LOGIT_REL).any():
        raise AssertionError(f"phase 4: kernel-route logits disagree with the "
                             f"plain route: {rel}")
    return launches


# ---------------------------------------------------------------------------
# phases 5 and 6: rwkv6-1.6b and zamba2-1.2b served at full width and depth
# ---------------------------------------------------------------------------

SERVE_PROMPT = (4, 2048)   # prompts x tokens of the kernel-route prefill
PLAIN_PROMPT = (4, 512)    # the plain route's prefill (its loops are slow)
DECODE_PROMPT, DECODE_NEW = 64, 32
# Accuracy is held against the plain route in float32 on the same fp32
# master weights.  There, decode after DECODE_PROMPT one-token steps must
# match forward_prefill of the same tokens (the reference's
# decode-matches-prefill) to FP32_DECODE_REL, norm-wise.  In bf16 these
# random-weight models drift from float32 by far more than any kernel
# error (rwkv6 ~0.2 norm-wise at depth 24; the reference's own bf16 drifts
# as much: tests/test_torch_{rwkv,zamba}.py::test_bf16_drift_is_the_
# references), so each kernel-route result (prefill of the prompt and of
# PLAIN_PROMPT, decode at the prompt's end) must stay within DRIFT_RATIO
# times the bf16 plain route's own drift from float32, row by row.
FP32_DECODE_REL = 1e-4
DRIFT_RATIO = 1.25
# kernel launches per prefill / per decode step of each model
RECURRENT_PATHS = {
    "rwkv6-1.6b": ({"rwkv6_wkv": 24}, {"rwkv6_wkv": 24}),
    "zamba2-1.2b": ({"ssd_scan": 38, "flash_attention": 6}, {}),
}


def replay_hooks(arch: str) -> list:
    """(module, op name, kernel, plain version, limit) of each kernel op
    the model of ``arch`` calls on the kernel route."""
    from repro_torch.kernels import ref
    from repro_torch.models import attention, rwkv, ssm
    if arch.startswith("rwkv6"):
        return [(rwkv, "rwkv6_op", "rwkv6_wkv", ref.ref_rwkv6, REC_REL)]
    return [(ssm, "ssd_op", "ssd_scan", ref.ref_ssd, REC_REL),
            (attention, "flash_attention_op", "flash_attention",
             plain_attention, FLASH_REL)]


def replay_kernel_calls(tag: str, what: str, run, hooks: list,
                        want: dict) -> None:
    """Run ``run()`` (one kernel-route prefill or decode step) with every
    kernel op of ``hooks`` wrapped: the op runs as on the path, then its
    plain version on the very tensors the model passed it, and each output
    (y, and the final state where there is one) is held norm-wise to the
    op's limit.  Each kernel must be called ``want[kernel]`` times."""
    errs = {kernel: [] for _, _, kernel, _, _ in hooks}
    saved = []

    def wrap(mod, name, kernel, plain):
        real = getattr(mod, name)

        def op(*args, **kw):
            out = real(*args, **kw)
            ref_out = plain(*args, **kw)
            pairs = zip(out, ref_out) if isinstance(out, tuple) \
                else [(out, ref_out)]
            errs[kernel].append(max(
                (o.float() - r.float()).norm().item()
                / max(r.float().norm().item(), 1e-30) for o, r in pairs))
            return out
        saved.append((mod, name, real))
        setattr(mod, name, op)

    try:
        for mod, name, kernel, plain, _ in hooks:
            wrap(mod, name, kernel, plain)
        run()
    finally:
        for mod, name, real in saved:
            setattr(mod, name, real)
    for _, name, kernel, _, limit in hooks:
        e = errs[kernel]
        if len(e) != want.get(kernel, 0):
            raise AssertionError(f"{tag} {what}: {name} called {len(e)} "
                                 f"times, expected {want.get(kernel, 0)}")
        worst = max(e)
        print(f"{tag} {what}, every {name} call replayed through its plain "
              f"version on the model's own tensors: {len(e)} calls, "
              f"norm-wise rel err max {worst:.3e} (limit {limit}), per "
              f"call {[float(f'{x:.2e}') for x in e]}", flush=True)
        if not worst <= limit:
            raise AssertionError(f"{tag} {what}: {kernel} disagrees with its"
                                 f" plain version: {worst} > {limit}")


def row_rel(got, want):
    """Norm-wise relative error of each row of two [B, V] logit arrays."""
    got, want = got.float(), want.float()
    return ((got - want).norm(dim=1) / want.norm(dim=1)).tolist()


def phase_recurrent(dev, arch: str, tag: str) -> dict:
    """``arch`` at full width and depth, random weights from a seed, on the
    card, through the port's model entry points (``models.lm``): counters
    zeroed, ``forward_prefill`` of 4 x 2048 prompt tokens, then
    ``init_cache`` + ``decode_step`` over a 64-token prompt fed one token
    at a time and 32 greedy new tokens; counters read, and each kernel's
    launches held to the path's count per prefill and per decode step.
    Then (not counted) the card's busy share of a prefill and of a decode
    step, every kernel call of one prefill and one decode step replayed
    through its plain version (``replay_kernel_calls``), and accuracy
    against the plain route ("xla": the kernels' plain
    versions, plain attention) in float32: its decode-matches-prefill at
    the prompt's end (FP32_DECODE_REL), and the kernel route's prefill (64
    and PLAIN_PROMPT tokens) and decode logits within DRIFT_RATIO of the
    bf16 plain route's drift from it.  The bf16 compute copy of the
    weights is cast once and passed to every bf16 call."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import COUNTERS, reset_counters
    from repro_torch.models import lm
    from repro_torch.tree import tree_leaves
    cfg = get_config(arch)
    per_prefill, per_step = RECURRENT_PATHS[arch]
    gc.collect()                  # the earlier phases' tensors
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, gen, device=dev)
    cparams = lm.cast_for_compute(cfg, params)
    n_params = sum(p.numel() for p in tree_leaves(params))
    torch.cuda.synchronize(dev)
    print(f"{tag}: {cfg.name} at full depth ({cfg.n_layers} layers, d "
          f"{cfg.d_model}, {cfg.ssm}, pattern {cfg.layer_pattern or 'none'},"
          f" vocab {cfg.vocab_size}): {n_params} params, fp32 masters + the "
          f"bf16 copy initialised in {time.perf_counter() - t0:.2f} s",
          flush=True)
    b, s = SERVE_PROMPT
    rng = np.random.RandomState(5)
    toks = torch.as_tensor(rng.randint(0, cfg.vocab_size, (b, s)),
                           device=dev)
    prompt = toks[:, :DECODE_PROMPT]
    n_steps = DECODE_PROMPT + DECODE_NEW

    def prefill(c, t):
        return lm.forward_prefill(c, cparams, {"tokens": t}).logits

    with torch.inference_mode():
        prefill(cfg, prompt)                          # warm-up
        torch.cuda.synchronize(dev)
        reset_counters()
        t0 = time.perf_counter()
        logits = prefill(cfg, toks)
        torch.cuda.synchronize(dev)
        pre_wall = time.perf_counter() - t0
        pre_launch = {n: c.count for n, c in COUNTERS.items()}
        cache = lm.init_cache(cfg, b, n_steps, lm.DTYPES[cfg.dtype],
                              device=dev)
        step_s, new_tokens = [], []
        at_prompt = None
        tok = prompt[:, 0]
        for i in range(n_steps):
            t1 = time.perf_counter()
            step_logits, cache, _ = lm.decode_step(cfg, cparams, cache, tok)
            nxt = step_logits.argmax(-1)
            torch.cuda.synchronize(dev)
            step_s.append(time.perf_counter() - t1)
            if i + 1 == DECODE_PROMPT:
                at_prompt = step_logits.float()
            if i + 1 < DECODE_PROMPT:
                tok = prompt[:, i + 1]
            else:
                tok = nxt
                if len(new_tokens) < DECODE_NEW:
                    new_tokens.append(nxt)
        launches = {n: c.count for n, c in COUNTERS.items()}
        peak = torch.cuda.max_memory_allocated(dev) / 2**30

        print(f"{tag} launches (prefill + {n_steps} decode steps): "
              + json.dumps(launches), flush=True)
        for name, n in launches.items():
            want_pre = per_prefill.get(name, 0)
            want_all = want_pre + n_steps * per_step.get(name, 0)
            if pre_launch[name] != want_pre or n != want_all:
                raise AssertionError(
                    f"{tag}: {name} launched {pre_launch[name]} times in the "
                    f"prefill and {n - pre_launch[name]} in {n_steps} decode "
                    f"steps, expected {want_pre} and {want_all - want_pre}")
        gen_toks = torch.stack(new_tokens, dim=1)
        if not (torch.isfinite(logits).all() and logits.shape ==
                (b, cfg.vocab_size) and torch.isfinite(at_prompt).all()):
            raise AssertionError(f"{tag}: logits not finite / mis-shaped")
        if gen_toks.shape != (b, DECODE_NEW) or gen_toks.min() < 0 or \
                gen_toks.max() >= cfg.vocab_size:
            raise AssertionError(f"{tag}: bad generated tokens")
        st = np.array(step_s) * 1e3
        gen_s = float(np.sum(step_s[DECODE_PROMPT:]))
        print(f"{tag}: prefill {b} x {s} tokens in {pre_wall * 1e3:.3f} ms "
              f"wall ({b * s / pre_wall:.1f} tokens/s); decode step (batch "
              f"{b}) p50 {np.percentile(st, 50):.3f} ms p95 "
              f"{np.percentile(st, 95):.3f} ms over {n_steps} steps; "
              f"{b * DECODE_NEW / gen_s:.3f} generated tokens/s; peak device "
              f"memory {peak:.2f} GiB", flush=True)

        profile_busy(lambda: prefill(cfg, toks),
                     f"{tag} prefill {b} x {s} under the profiler")
        profile_busy(lambda: lm.decode_step(cfg, cparams, cache, tok),
                     f"{tag} decode step under the profiler")

        # every kernel call of one prefill and one decode step (from the
        # state after the decode run) against its plain version, layer by
        # layer, on the tensors the model passes it
        hooks = replay_hooks(arch)
        replay_kernel_calls(tag, f"prefill {b} x {s}",
                            lambda: prefill(cfg, toks), hooks, per_prefill)
        if per_step:
            replay_kernel_calls(
                tag, "decode step",
                lambda: lm.decode_step(cfg, cparams, cache, tok), hooks,
                per_step)

        # the plain route, bf16 and float32, against the kernel route
        plain_cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, compute_backend="xla"))
        f32_cfg = dataclasses.replace(plain_cfg, dtype="float32")
        pb, ps = PLAIN_PROMPT
        short = toks[:pb, :ps]
        routes = {"kernel bf16": (cfg, cparams),
                  "plain bf16": (plain_cfg, cparams),
                  "plain fp32": (f32_cfg, params)}
        got, walls = {}, {}
        for name, (c, pp) in routes.items():
            dcache = lm.init_cache(c, b, DECODE_PROMPT, lm.DTYPES[c.dtype],
                                   device=dev)
            for i in range(DECODE_PROMPT):
                dec, dcache, _ = lm.decode_step(c, pp, dcache, prompt[:, i])
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            long_pre = lm.forward_prefill(c, pp, {"tokens": short}).logits
            torch.cuda.synchronize(dev)
            walls[name] = time.perf_counter() - t0
            got[name] = {
                f"prefill@{DECODE_PROMPT}": lm.forward_prefill(
                    c, pp, {"tokens": prompt}).logits.float(),
                f"decode@{DECODE_PROMPT}": dec.float(),
                f"prefill@{ps}": long_pre.float()}
            del dcache
        if not all(torch.isfinite(v).all() for g in got.values()
                   for v in g.values()):
            raise AssertionError(f"{tag}: non-finite logits")

        def fmt(rel):
            return [float(f"{r:.3e}") for r in rel]
        pre_key = f"prefill@{DECODE_PROMPT}"
        dec_key = f"decode@{DECODE_PROMPT}"
        for name in routes:
            rel = row_rel(got[name][dec_key], got[name][pre_key])
            print(f"{tag}: {name}: decode logits after {DECODE_PROMPT} "
                  f"one-token steps vs forward_prefill of the {DECODE_PROMPT}"
                  f" tokens, norm-wise per row {fmt(rel)}"
                  + (f" (limit {FP32_DECODE_REL})" if name == "plain fp32"
                     else " (not held: bf16)"), flush=True)
        rel = row_rel(got["plain fp32"][dec_key], got["plain fp32"][pre_key])
        if max(rel) > FP32_DECODE_REL:
            raise AssertionError(f"{tag}: decode does not match prefill")
        truth = got["plain fp32"]
        for what in truth:
            rk = row_rel(got["kernel bf16"][what], truth[what])
            rp = row_rel(got["plain bf16"][what], truth[what])
            lk, lp = got["kernel bf16"][what], got["plain bf16"][what]
            agree = float((lk.argmax(1) == lp.argmax(1)).float().mean())
            print(f"{tag}: {what} vs the fp32 plain route, norm-wise per "
                  f"row: kernel route {fmt(rk)}, plain bf16 route {fmt(rp)} "
                  f"(limit {DRIFT_RATIO} x the plain route's); kernel vs "
                  f"plain bf16 {fmt(row_rel(lk, lp))}, argmax agreement "
                  f"{agree:.2f}", flush=True)
            if any(k > DRIFT_RATIO * p for k, p in zip(rk, rp)):
                raise AssertionError(f"{tag}: {what}: the kernel route drifts"
                                     f" further from float32 than the plain "
                                     f"bf16 route")
        print(f"{tag}: prefill of {pb} x {ps} tokens, wall: " + ", ".join(
            f"{n} {w * 1e3:.3f} ms" for n, w in walls.items()), flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 3: training
# ---------------------------------------------------------------------------

# norm-wise relative error ||kernel - plain|| / ||plain|| allowed for each
# gradient of the layer check: the plain route computes in bf16 (h, the
# activations and every product rounded to 8 bits, 2**-8 = 3.9e-3 each),
# the kernel route keeps the backward in fp32 / TF32; a few such roundings
# in a chain
GRAD_REL = 2e-2
TRAIN_ARGV = ["--arch", "gpt2-moe", "--steps", "12", "--batch", "8", "--seq",
              "1024", "--ckpt-every", "100"]


def phase3_layer(dev) -> None:
    """One gpt2-moe MoE layer at the training shape (8 x 1024 tokens, bf16)
    on the kernel route (gating, positions, dispatch, grouped FFN, combine
    kernels; backward through grouped_matmul, combine and dispatch) against
    the plain route (einsum / scatter), same input and weights.  A gate id
    that differs between the routes (a near-tie in bf16) changes the
    buffers of the two experts it touches, so outputs and gradients are
    held on the tokens and experts no flip touched; the router gradient,
    a sum over every token, only when no gate flipped.  More than 8 flips
    (0.1% of the tokens) or fewer than 90% of tokens untouched fails."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.moe import MoEParams, moe_layer
    cfg = get_config("gpt2-moe")
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    bf = torch.bfloat16
    x = torch.randn(8, 1024, D, generator=gen, device=dev).to(bf)
    router = (torch.randn(D, E, generator=gen, device=dev)
              * D ** -0.5).to(bf)
    wi = (torch.randn(E, D, F, generator=gen, device=dev) * D ** -0.5).to(bf)
    wo = (torch.randn(E, F, D, generator=gen, device=dev) * F ** -0.5).to(bf)
    ct = torch.randn(8, 1024, D, generator=gen, device=dev)

    def run(backend, dispatch_backend):
        leaves = [a.detach().requires_grad_() for a in (x, router, wi, wo)]
        mcfg = dataclasses.replace(cfg.moe, compute_backend=backend)
        out = moe_layer(leaves[0], MoEParams(leaves[1], leaves[2], None,
                                             leaves[3]), mcfg,
                        ffn_type=cfg.ffn_type,
                        dispatch_backend=dispatch_backend)
        grads = torch.autograd.grad((out.y.float() * ct).sum(), leaves)
        return out, [g.float() for g in grads]

    ko, kg = run("pallas", "pallas")
    po, pg = run("xla", "scatter")
    torch.cuda.synchronize()
    ik, ip = ko.expert_idx, po.expert_idx
    flip = (ik != ip).any(-1)
    touched = torch.unique(torch.cat([ik[flip].reshape(-1),
                                      ip[flip].reshape(-1)]))
    alike = ~(torch.isin(ik, touched) | torch.isin(ip, touched)).any(-1)
    experts = ~torch.isin(torch.arange(E, device=dev), touched)

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    checks = {
        "y": rel(ko.y.reshape(-1, D)[alike].float(),
                 po.y.reshape(-1, D)[alike].float()),
        "dx": rel(kg[0].reshape(-1, D)[alike], pg[0].reshape(-1, D)[alike]),
        "dwi": rel(kg[2][experts], pg[2][experts]),
        "dwo": rel(kg[3][experts], pg[3][experts]),
    }
    if not flip.any():
        checks["drouter"] = rel(kg[1], pg[1])
    print(f"phase 3 layer check (8 x 1024 tokens, cap {C_TRAIN}): "
          f"{int(flip.sum())} gate flips touching {touched.numel()} experts; "
          f"norm-wise rel err kernel vs plain route: " + ", ".join(
              f"{k} {v:.3e}" for k, v in checks.items())
          + f" (limit {GRAD_REL})", flush=True)
    bad = {k: v for k, v in checks.items() if not v <= GRAD_REL}
    if bad or int(flip.sum()) > 8 or not alike.float().mean() > 0.9:
        raise AssertionError(f"layer check: kernel route disagrees with the "
                             f"plain route: {bad}, {int(flip.sum())} flips")


def phase3_train(dev) -> dict:
    """gpt2-moe at full width and depth through launch.train, kernel
    route, counters zeroed just before and read just after."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import COUNTERS, reset_counters
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves
    ck = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    try:
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counters()
        t0 = time.perf_counter()
        out = train.run(TRAIN_ARGV + ["--ckpt-dir", ck, "--device",
                                      str(dev)])
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        launches = {n: c.count for n, c in COUNTERS.items()}
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        tr, state = out["trainer"], out["state"]
        log = tr.metrics_log
        print("phase 3 launches: " + json.dumps(launches), flush=True)
        missing = [n for n, c in launches.items()
                   if c == 0 and n not in SERVE_ONLY | RECURRENT]
        if missing:
            raise AssertionError(f"kernels never launched in training: "
                                 f"{missing}")
        losses = [r["loss"] for r in log]
        if len(log) != 12 or any(r.get("skipped") for r in log):
            raise AssertionError(f"expected 12 committed steps, got {log}")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"non-finite loss: {losses}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"loss did not fall: {losses}")
        if tr.packing_decision is None:
            raise AssertionError("the packing decision was not made")
        cfg = tr.model_cfg
        n_params = sum(p.numel() for p in tree_leaves(state["params"]))
        dts = [r["dt"] for r in log]
        med = float(np.median(dts[1:]))
        tokens = tr.data_cfg.global_batch * tr.data_cfg.seq_len
        ck_log = tr.checkpoint_log[-1]
        print(f"phase 3: trained {cfg.name} ({cfg.n_layers} layers, "
              f"{n_params} params) {len(log)} steps of {tokens} tokens in "
              f"{wall:.2f} s wall; losses "
              f"{[round(v, 6) for v in losses]}; grad norms "
              f"{[round(r['grad_norm'], 4) for r in log]}", flush=True)
        print(f"phase 3: step time (fwd_bwd stopwatch) first {dts[0]:.4f} s, "
              f"median of steps 1-11 {med:.4f} s (min {min(dts[1:]):.4f}, "
              f"max {max(dts[1:]):.4f}); {tokens / med:.1f} tokens/s; peak "
              f"device memory {peak:.2f} GiB; checkpoint "
              f"{ck_log['bytes']} bytes in {ck_log['seconds']:.3f} s; "
              f"packing {tr.packing_decision}", flush=True)

        # the card's busy share of one more step (not counted above)
        batch = tr._batch(12)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            _, _, m = tr.step_fn(state["params"], state["opt_state"], batch)
            float(m["loss"])
            pwall = time.perf_counter() - t1
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
        print(f"phase 3 step under the profiler: wall {pwall * 1e3:.3f} ms, "
              f"device busy {dev_ms:.3f} ms = {100 * dev_ms / 1e3 / med:.1f}% "
              f"of the median step ({100 * dev_ms / 1e3 / pwall:.1f}% of "
              f"the profiled wall), {sum(e.count for e in kern)} kernels",
              flush=True)
        for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:12]:
            print(f"    {e.self_device_time_total / 1e3:9.3f} ms  "
                  f"x{e.count:<5d} {e.key[:90]}", flush=True)
        # grouped_matmul's kernels (csrc/grouped_matmul.cu), wherever they rank
        for e in kern:
            if "gmm_" in e.key:
                print(f"  phase 3 grouped_matmul kernel: "
                      f"{e.self_device_time_total / 1e3:.3f} ms x{e.count} "
                      f"{e.key[:90]}", flush=True)
        return launches
    finally:
        shutil.rmtree(ck, ignore_errors=True)


def phase3_resume(dev) -> None:
    """4 straight steps against 2 + injected failure + restart + 2, bitwise,
    at full width and 2 layers, with deterministic algorithms on."""
    import shutil
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.tree import tree_items
    cfg = dataclasses.replace(get_config("gpt2-moe"), n_layers=2)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=1024,
                      global_batch=8)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    root = tempfile.mkdtemp(prefix="repro_torch_resume_")

    def trainer(name, **kw):
        return Trainer(cfg, dcfg, ocfg, TrainerConfig(
            steps=4, ckpt_every=2, ckpt_dir=f"{root}/{name}", device=str(dev),
            **kw))
    torch.use_deterministic_algorithms(True)
    try:
        straight = trainer("a")
        want = straight.run()
        failing = trainer("b", fail_at_step=2)
        try:
            failing.run()
        except RuntimeError as e:
            if "injected failure at step 2" not in str(e):
                raise
        else:
            raise AssertionError("the injected failure did not fire")
        resumed = trainer("b")
        got = resumed.run()
        torch.cuda.synchronize(dev)
        differ = [k for (k, a), (_, b) in zip(tree_items(got),
                                              tree_items(want))
                  if not torch.equal(a, b)]
        la = [r["loss"] for r in straight.metrics_log]
        lb = [r["loss"] for r in failing.metrics_log + resumed.metrics_log]
        print(f"phase 3 resume (2 layers, full width): straight losses {la}, "
              f"2 + restart + 2 losses {lb}; {len(differ)} of "
              f"{len(tree_items(got))} state leaves differ", flush=True)
        if differ or la != lb:
            raise AssertionError(f"resume is not bitwise: {differ[:8]}")
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(root, ignore_errors=True)


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
    # deterministic cuBLAS for phase 3's bitwise resume check (read when
    # cuBLAS starts, so set before any work on the card: phases 1 and 2 run
    # under it too)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
            if any(w in line for w in ("registers", "spill",
                                       "Performance Loss")):
                print(f"  ptxas {name}: {line.strip()}", flush=True)

    print("phase 1: kernels against their plain versions", flush=True)
    rows = phase1(dev, H100)
    serve = phase2(dev)
    phase3_layer(dev)
    train_launches = phase3_train(dev)
    phase3_resume(dev)
    mixtral = phase4(dev)
    rwkv = phase_recurrent(dev, "rwkv6-1.6b", "phase 5")
    zamba = phase_recurrent(dev, "zamba2-1.2b", "phase 6")

    kernels = []
    for name in REPLACES:
        r = rows[name]
        paths = {"serve": serve[name], "train": train_launches[name],
                 "mixtral": mixtral[name], "rwkv": rwkv[name],
                 "zamba": zamba[name]}
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": sum(paths.values()),
            **{f"launches_{p}": n for p, n in paths.items()},
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
