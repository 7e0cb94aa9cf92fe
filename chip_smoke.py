#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --phases 1r,5 [--src DIR]
    python3 chip_smoke.py --phases 1m [--src DIR]
    python3 chip_smoke.py --phases 3,7
    python3 chip_smoke.py --phases 2,8
    python3 chip_smoke.py --phases 9,10
    python3 chip_smoke.py --phases 11,12
    python3 chip_smoke.py --phases 1r,13
    python3 chip_smoke.py --phases 14
    python3 chip_smoke.py --phases 15

With no arguments every phase runs, as below.  ``--phases`` runs phase 0
and a subset (``1r``: phase 1's two recurrences alone; ``1m``: its five
MoE routing kernels alone; no kernels line unless every phase runs);
``--src`` drives the port under another tree's ``src`` (e.g. a parent
commit unpacked under the git-ignored ``build/``) so that two versions can
be timed on the same card (a gating case that tree's wrapper refuses is
then printed and skipped).

Phase 0  prints the card (``nvidia-smi`` name and power limit) and builds
         the eleven CUDA sources of ``src/repro_torch/kernels/csrc`` (one
         ``nvcc`` each, started together; timed).
Phase 1  first times the launch floor: ``csrc/launch_floor.cu``'s empty
         kernel (one block of 32 threads, no memory traffic, no TPU
         kernel), as every kernel is timed, printed on its own line; each
         kernel line then gives the floor and the kernel's device time as
         a share of max(bound, floor).  It holds each of the six
         serve-path kernels against its plain PyTorch version on the
         card, at the serve path's shapes (gpt2-moe: D=768,
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
         and decode (4 x 2), swiglu at d 6144 / F 16384, slots of -1 and
         of 0 rows, llama4-maverick's serve prefill at 512 slots
         (``kMaxGroups``: 128 experts x 4, the routed rows of a 4 x 2048
         top-1 prefill, swiglu d 5120 / f 8192, 32 GB of weights read in
         place; the plain version gathers slot block by slot block,
         ``ffn_plain``, and the composition is not timed) and 513 slots
         (the index-order walk, f 1024); each case within 2e-2 of max
         |plain|, repeated bitwise, zeros past each count.  It holds
         ``flash_attention`` against ``ref_attention`` at twelve shapes
         (a, b: gpt2-moe's prefill 4 x 64 and 8 x 1024, 12 heads, hd 64,
         causal; c, d: mixtral-8x22b's 1 x 2048 and 1 x 6144, 48 / 8 heads,
         hd 128, causal, window 4096; e: bert-large-moe's 8 x 512, 16 heads,
         hd 64, bidirectional; f: zamba2-1.2b's shared block, 4 x 2048, 32
         heads, hd 64, causal; g: a ragged 2 x 1000, 48 / 8 heads, hd 128,
         window 256; h, i: llama4-maverick's 40 / 8 and granite-34b's MQA
         48 / 1, 1 x 2048, hd 128, causal; j: hubert-xlarge's 4 x 2048,
         16 heads, hd 80, bidirectional (the hd-80 instance); k: hd 80,
         2 x 1000, 16 / 4 heads, causal, window 256; l: llava-next-34b's
         4 x 2048, 56 / 8 heads, hd 128, causal), norm-wise, each call
         repeated bitwise, timed beside
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
         a step (and the device time of the kernels under the combine
         backward, the ``_CombineBackward`` node, with and without the
         remat recompute it triggers, beside the dispatch kernel's
         total), the checkpoint's bytes and seconds and the packing
         decision, and the losses in ``float.hex`` (the layer check prints
         a digest of its kernel route's bits) so that two trees' runs can
         be held bitwise equal.  A resume check at full width and 2 layers
         holds 4 straight steps bitwise against 2 + injected failure +
         restart + 2, under ``torch.use_deterministic_algorithms``.
Phase 1's gating cases (GATING_CASES) add mixtral-8x22b's router (2048 x
6144, E 8, top-2), llama4-maverick's width (2048 x 5120, E 128, top-1), 4
experts (the router staged by threads: a row of 8 bytes is no TMA
stride) and three exact-tie cases (a third of x's rows zero, the rest
one-hot, router columns duplicated in pairs), each call repeated bitwise.
Gating is held to ``ref_topk_gating`` on the exactly rounded logits
(``rounded_logits``: float64 sums rounded to bf16): probabilities within
1e-3, plus what a flipped rounding moves them where the kernel's fp32 sum
may land across a bf16 rounding boundary (``shift_bounds``); ids on the
rows clear of the top-k margin (on every row of the tie cases); weights
likewise.  ``topk_positions`` (POSITIONS_CASES) also runs at the training
shape (8192 x 2), Mixtral's prefill (8192 x 2, E 8), llama4's width (2048
x 1, E 128), E 256, every id one expert (12000 x 2) and 65,536 x 1 (a
second walk a CTA), each bitwise against its plain version and on repeat,
with the cluster it launches; ``weighted_route`` also at Mixtral's prefill
(4096 x 2, E 8, 4 replicas in 32 slots).
Phase 1 also holds the kernels at gpt2-moe training's shapes (8192 tokens,
top-2, E=16, C=1288): gating at k=2, ``dispatch_rows`` unscaled (the
forward), with a per-row scale, and with the scale and ``dot=`` (combine's
backward: out bitwise, each rowdot within 1e-5 of sum |dot * x| of the
plain version's, the largest ratio printed), ``combine_rows`` with unit
weights (dispatch's backward), the combine backward alone (device time a
call), then ``dispatch_rows`` and ``combine_rows``
again with 128 MiB (over twice L2) written before each timed call (cold
L2, beside the warm time), ``grouped_ffn`` at [16, 1288, 768], and ``grouped_matmul`` (the
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
6, norm-wise within 1e-4: ``rwkv6_wkv`` against ``ref_rwkv6`` (WKV_CASES)
at 4 x 2048, 32 heads of 64 with a random non-zero bonus u, at a ragged
T = 2000, as a single 1 x 2048 request, from a random s0 (the final state
held too), under a strong (-5 to -20 a step) and a weak (~ -1e-4) decay,
split in two calls that carry the state, and at the decode shape (T = 1)
from a random state, each call repeated bitwise, its bound at the bf16
tensor-core peak (the step loop's at fp32);
``ssd_scan`` against ``ref_ssd`` at 4 x 2048, 64 heads, P = N = 64 (x, B
and C strided slices of one projection), at a ragged T = 2000, as a single
1 x 2048 request, from a random h0 (the final state held too), under a
strong decay (softplus(dt) ~ 6.25: dt a ~ -100 a step), and split in two
calls, each call repeated bitwise; its bound at the bf16 tensor-core peak,
the fp32 one printed beside it.  Neither function has a PyTorch call that
computes it, so their ``library_ms`` is null.  Then their backward
kernels (``BACKWARD``: they replace no TPU kernel) against
``ref_rwkv6_bwd`` / ``ref_ssd_bwd``, every gradient norm-wise within 1e-4
and every call repeated bitwise: ``rwkv6_wkv_bwd`` (WKV_BWD_CASES) at
rwkv6-1.6b's training shape 4 x 2048 x 32 heads, a ragged T = 2000, T = 40
(the forward's step-loop regime), and from a random s0 with a cotangent on
the final state under a strong and a weak decay; ``ssd_scan_bwd``
(SSD_BWD_CASES) at zamba2-1.2b's 4 x 2048 x 64 heads with x, B and C
sliced in place, a ragged T = 2000, and from a random h0 with a
cotangent under A = 16 in every head (where the reference's chunked form
overflows) and under a strong decay (softplus(dt) ~ 6.25: dt a ~ -100 a
step).  Each is timed with CUDA events and torch.profiler beside its
bound (bf16 peak, the fp32 one beside) and, at the training shape, its
plain version, with each CUDA kernel's share of a call's device time on
a line of its own; no PyTorch call computes either.  Last,
``csrc/mma_forms.cu`` (a yardstick: no TPU kernel, no counter) times a
64 x 64 x 64 product of a bf16 pair on mma.sync, on mma.sync over its
causal half (bounds tested at run time, or known when compiled) and on
wgmma at ``ssd_bwd_grad_kernel``'s grid and occupancy, each form first
held against the plain product, and prints the gradient kernel's product
mix on each form.
Phase 5  serves rwkv6-1.6b (24 RWKV6 layers, d 2048) at full width and
         depth, random weights from a seed, through ``models.lm``'s
         ``forward_prefill`` (4 x 2048 tokens), ``init_cache`` and
         ``decode_step`` (a 64-token prompt fed one token at a time, then
         32 greedy tokens).  Counters zeroed just before, read just after:
         ``rwkv6_wkv`` must launch 24 times per prefill and per decode step.
         It prints prefill wall time, decode step p50 / p95, generated
         tokens/s, peak memory and the card's busy share of a prefill and
         of a decode step, with the WKV kernels' device time in each.  It replays one prefill and one decode step
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

Phase 7  drives expert parallelism and Lina's §4 schedule on a one-rank
         NCCL mesh (``--mesh 1x1``: the all-to-all a self-exchange, the
         all-reduce over one rank; this machine has one GPU, so no
         multi-GPU number is taken).  It prints each communicator's
         stream priority (the `model` group's high), holds gpt2-moe's MoE
         layer at the training shape on the mesh (``lina`` with 4
         micro-ops, and ``lina=False``) against ``mesh=None`` (ids equal;
         y and the gradients norm-wise within 1e-5, the bitwise status
         printed), trains at full width and depth 2 for 4 steps without a
         mesh and with each of the five schedules and with bf16 and
         int8_ef compression (the five schedules' losses bitwise equal),
         then, counters zeroed just before and read just after, 12 steps
         of priority+partition+pipeline with 2 microbatches at full depth
         through ``launch.train``'s flags.  For each run it prints the
         step median, the losses in ``float.hex``, and one more step
         under the profiler: its NCCL kernels' device time and an ordering
         check (each all-reduce after the last all-to-all before it ended:
         by NCCL kernels where NCCL launched both kinds, else by the CUDA
         events the mesh records on the compute stream; which one is
         printed).  At depth 12 it also drives 5 of phase 3's 12 steps
         (its LR schedule) on the mesh with one microbatch and without a
         mesh with two: at world size 1 the mesh's steps must be the
         single-rank steps bit for bit (the first 5 losses of phase 3 and
         of the 2-microbatch run, in ``float.hex``); it prints the step
         medians, busy and NCCL time beside phase 3's, and the loss gap.

Phase 8  serves on a one-rank NCCL mesh (``--mesh 1x1``; no multi-GPU
         number is taken).  gpt2-moe at full width and depth is served by
         a ``MoEServer`` on the mesh and one without a mesh, the same
         weights and profile, on the same fixed batches (``serve_batch``,
         ``prefill_batch`` and 8 ``decode_batch`` steps of 4 x 64 tokens):
         logits, path ids and generated tokens bitwise equal.  Counters
         zeroed just before and read just after, phase 2's trace is served
         through ``launch.serve --mesh 1x1``: every serve kernel must
         launch and every request complete with finite logits; its TTFT
         and TPOT p50 print beside phase 2's.  A decode step of each server
         prints its host wall time, the host time of the layer's exchanges,
         and under the profiler its busy and NCCL device time.  Then the
         transformer branch of ``models.lm`` through ``launch.steps``
         (stacked plan, fsdp): a 4 x 64 prefill and 8 decode steps on the
         mesh bitwise against ``mesh=None``, and the kernel route against
         the plain route by ``compare_whole`` (phase 2's limits).

Phase 9  serves llama4-maverick-400b-a17b at full width (d 5120, 40 / 8
         heads, hd 128, 128 swiglu experts of 8192, top-1, a shared
         expert, vocab 202,048, bf16 parameters) and depth 2 (a dense block
         and an MoE block: 18.7 B parameters, 34.8 GiB) through
         ``MoEServer`` and ``ServingEngine`` at ``ServerConfig`` defaults
         (512 slots), kernel route: profiling on 2 batches of 2 x 2048, 4
         requests of 2048 prompt tokens x 16 new tokens.  Counters zeroed
         just before, read just after; every serve-path kernel and
         ``flash_attention`` must launch.  It prints TTFT, TPOT, tokens/s,
         peak memory while initialising and while serving, the server's
         host spans, each kernel's launches in a prefill and a decode
         step, the card's busy share of each, and replays the MoE layer
         call of a prefill and a decode step through the plain route on
         the same input, plan, cap and slot_cap (as phase 2), the plain
         FFN run slot block by slot block (``plain_ffn_by_slot_block``:
         gathering all 512 slots' weights would take 129 GB).
Phase 10 serves the four dense configs (no MoE: a dense FFN in every block)
         at full width as phases 5 and 6 do: qwen3-8b (qk_norm, 32 / 8
         heads) and qwen1.5-0.5b (MHA at hd 64, QKV bias, tied embeddings)
         at full depth, qwen2-72b (64 / 8, QKV bias) and granite-34b (MQA
         48 / 1, gelu) cut to 8 layers.  ``flash_attention`` must launch
         once a layer a prefill, and every call is replayed against
         ``ref_attention`` (1e-2); decode attention is plain.  Then the
         plain route in float32 shows decode-matches-prefill and the kernel
         route drifts from it no further than the bf16 plain route does.

Phase 11 serves the two modality frontends as phase 10 serves the dense
         configs: llava-next-34b at full width (d 7168, 56 / 8 heads, hd
         128, swiglu 20480, vocab 64000) cut to 8 layers, its prefill 576
         synthetic patch embeddings (``patch_proj``) + 1472 tokens = 4 x
         2048 positions, its decode token-only; hubert-xlarge at full width
         and depth (48 layers, d 1280, 16 heads of hd 80, bidirectional),
         its encoder forward over 4 x 2048 synthetic frames of 512 (no
         decode).  ``flash_attention`` must launch once a layer a prefill
         and every call is replayed against ``ref_attention`` (1e-2); then
         the plain route in float32 and bf16 against the kernel route.
Phase 12 drives the serving control loop on gpt2-moe at full width and
         depth (kernel route; counters zeroed just before, read just
         after): (a) an ``AdaptiveScheduler`` (interval 1, no hysteresis,
         capacity factor 16) publishing plans while 4 requests decode must
         give the static run's greedy tokens; (b) ``fail_devices({1})``
         after the second decode step must give the fault-free tokens and
         leave no realized load on placement device 1; (c)
         ``launch.serve --workload drift --autoscale --trace-dir D`` (two
         engine steps under ``obs.StepProfiler``, whose kernels it prints)
         and ``python -m repro_torch.obs validate --trace-dir D`` (exit 0),
         TTFT / TPOT p50, swaps, churn and load imbalance printed beside
         the same trace served without ``--autoscale``.

Phase 13 trains the RWKV6 and hybrid Mamba2 families: (a) rwkv6-1.6b and
         zamba2-1.2b at full width and depth through
         ``repro_torch.launch.train`` (4 x 2048 tokens a step, 6 steps,
         remat on), counters zeroed just before and read just after: the
         recurrence kernel must launch twice a layer a step (the forward
         and the remat recompute) and its backward once, and nothing
         else (the shared block's attention is plain in training); every
         loss and grad norm finite.  It prints the step time (median after
         the first), tokens/s, peak memory, the checkpoint, and one more
         step under the profiler: busy share, top kernels and the
         recurrence kernels' device time.  (b) Each at depth 2 (zamba2's
         pattern cut to one Mamba2 layer and a tap) on the kernel route
         against the plain route (``compute_backend="xla"``: the plain
         recurrences under autograd) from one seed for 3 steps of 2 x
         2048 tokens: step 1's
         loss within 1e-4 and grad norm within 1e-3, later steps within
         1e-2.  (c) rwkv6-1.6b at depth 2: 4 straight steps against 2 +
         injected failure + restart + 2, bitwise.

Phase 14 holds the launch tooling and the static checker against the
         card: (a) every edge case of ``repro_torch.analysis.kernels``'
         registry (small shapes at each kernel's contract boundaries): an
         accepted one launches (its counter moves), holds to its plain
         version at phase 1's tolerance for that kernel, and its meta
         route's output shapes and dtypes are the card's; a refused one
         raises before its counter moves.  (b) ``repro_torch.launch.sweep``
         (every assigned config x four shapes x 16x16, 2x16x16, dry runs on
         ``meta``) on the host's CPU, in the background, one line a cell.
         (e) A second ``warmup`` of the gpt2-moe engine builds no kernel,
         loads no library and adds no allocator segment
         (``analysis.retrace.no_retrace``).  (c) For gpt2-moe's training
         step (8 x 1024), mixtral-8x22b's prefill at depth 2 (4 x 2048) and
         rwkv6-1.6b's training step (4 x 2048), the dry run's predicted
         peak against ``max_memory_allocated`` on the same program
         (``launch.dryrun.step_program``), within 10%; (d) their analytic
         FLOPs over the measured step time (median of 3) as a share of 989
         TFLOP/s.

Phase 15 holds the dense sharding (``launch.sharding``: every leaf stored
         as the reference's specs place it, FSDP gathers, tensor-parallel
         all-reduces, the vocab-parallel loss, the sequence-sharded decode
         cache): (a) on a (1, 1, 1) (data, model, tp) and a (1, 1) NCCL
         mesh, gpt2-moe's 5 training steps (8 x 1024; losses, and the
         params and AdamW state by sha256) and a served prefill (4 x 64)
         and 8 decode steps, and qwen3-8b at depth 4's prefill and 8
         decode steps, against no mesh: bitwise, or within 1e-6 relative
         where a difference is by design (each result printed with which);
         then gpt2-moe's training steps and qwen3-8b's prefill and decode
         again with Megatron sequence parallelism on
         (``cfg.seq_parallel``): the model-parallel group has one rank,
         so nothing is split and each must be bitwise;
         (b) rank 0 of four production cells at full width on the card
         through a ``MirrorMesh`` (each collective filled with what a
         world of ranks holding this rank's tensors returns: rank 0's
         program and allocations, not its values): qwen3-8b train_4k (16
         x 4096 on the rank, remat, AdamW; 16 x 16) twice, with sequence
         parallelism off (the trainer's path: every tensor-parallel
         all-reduce over the 16-rank model group, forward and backward)
         and on (the dry run's default: the carry 256 tokens a rank
         between layers), qwen2-72b train_4k with it on at depth
         MIRROR_72B_DEPTH (the dry run's full-depth peak printed beside),
         qwen2-72b prefill_32k
         (2 x 32768, TP-only residency, flash at 4 local heads; 16 x 16),
         mixtral-8x22b prefill_32k at depth 2 on (16, 8, 2): the dry run's
         peak (``meta``, a ``RecordingMesh``) against
         ``max_memory_allocated`` within 2%, the recorded collectives
         (kind, axis, group size, dtype, bytes) equal to the dry run's, the
         step's wall time (median after the first of 3) and busy share,
         a finite loss or logits of the expected shape (the mirror's
         backward multiplies a cotangent by n at each all-reduce, so its
         gradients may overflow: printed, not held);
         (c) the sweep's counts (phase 14's, sequence parallelism on, the
         dry run's default): ok, skip, fitting, each cell that does not
         fit; (d) wall-clock serving on a one-rank NCCL mesh: gpt2-moe at
         full width, WALL_REQUESTS requests submitted on rank 0 and
         drained by ``ServingEngine.run()`` (the request router:
         ``Mesh.broadcast`` at each step) give the tokens of ``simulate``
         replaying them on the same server, and the broadcasts are
         recorded.  Counters zeroed before each sharded run and
         summed after it (``launches_sharded``): rows 1-8 of REPLACES must
         launch.  Each part prints its seconds.

Prints one ``{"kernels": [...]}`` line (twelve kernels: the ten of
``REPLACES`` and the two of ``BACKWARD``, with ``"replaces": null`` and
``"backward_of"``) and, last,
``{"ok": true, "device": {...}}``.  Any failure raises (non-zero exit).
Imports nothing of the JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import hashlib
import json
import math
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
    "rwkv6_wkv_bwd": "src/repro_torch/kernels/csrc/rwkv6_bwd.cu",
    "ssd_scan_bwd": "src/repro_torch/kernels/csrc/ssd_bwd.cu",
}
# each CUDA kernel of the sources (its __global__ name) -> the wrappers
# whose launch counters witness its launches in ``device_split``, with the
# launches a call of their C entry (at most; grouped_ffn's two GEMMs).  The
# yardsticks' kernels have no counter: one launch a call of their entry.
KERNEL_OWNERS = {
    "gating_kernel": {"topk_gating_fused": 1},
    "positions_kernel": {"topk_positions": 1},
    "positions_solo_kernel": {"topk_positions": 1},
    "dispatch_kernel": {"dispatch_rows": 1},
    "combine_kernel": {"combine_rows": 1},
    "route_kernel": {"weighted_route": 1},
    "ffn_gemm_kernel": {"grouped_ffn": 2},
    "gmm_bf16_kernel": {"grouped_matmul": 1},
    "gmm_tf32_kernel": {"grouped_matmul": 1},
    "flash_kernel": {"flash_attention": 1},
    "wkv_step_kernel": {"rwkv6_wkv": 1},
    "wkv_chunk_kernel": {"rwkv6_wkv": 1},
    "ssd_kernel": {"ssd_scan": 1},
    "wkv_bwd_chunk_kernel": {"rwkv6_wkv_bwd": 1},
    "wkv_bwd_grad_kernel": {"rwkv6_wkv_bwd": 1},
    "wkv_bwd_sum_kernel": {"rwkv6_wkv_bwd": 1},
    "ssd_bwd_chunk_kernel": {"ssd_scan_bwd": 1},
    "ssd_bwd_grad_kernel": {"ssd_scan_bwd": 1},
    "ssd_bwd_sum_kernel": {"ssd_scan_bwd": 1},
    "chunk_state_kernel": {"rwkv6_wkv_bwd": 1, "ssd_scan_bwd": 1},
    "empty_kernel": {},
    "mma_forms_kernel": {},
}
# the kernels that replace no TPU kernel: the backward of a forward kernel
# of REPLACES (the reference's Pallas kernels of the recurrences have no
# VJP; it trains them through jax.grad of its jnp forms)
BACKWARD = {"rwkv6_wkv_bwd": "rwkv6_wkv", "ssd_scan_bwd": "ssd_scan"}
# every other kernel runs in training (its attention is plain: the flash
# kernel has no backward)
SERVE_ONLY = {"weighted_route", "flash_attention"}
TRAIN_ONLY = {"grouped_matmul"}     # the FFN backward
# the recurrences of the RWKV6 and Mamba2 families and their backward
# (phases 5, 6 and 13 only)
RECURRENT = {"rwkv6_wkv", "ssd_scan", "rwkv6_wkv_bwd", "ssd_scan_bwd"}

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


class EventsLost(RuntimeError):
    """No profiling session saw every kernel event the launch counters
    witness, and none saw more."""


def device_ms(fn, iters: int = 20) -> float:
    """Mean kernel time per call on the card (torch.profiler kernel events,
    no host time), over ``iters`` calls after one warm-up.  Where every
    profiling session lost events (``EventsLost``), the calls' CUDA-event
    time instead (host gaps between launches included), said so."""
    try:
        return sum(device_split(fn, iters).values())
    except EventsLost as e:
        ms = time_ms(fn, iters)
        print(f"  device_ms: {e}: CUDA-event time {ms:.4f} ms a call "
              f"instead", flush=True)
        return ms


def device_split(fn, iters: int = 20, tries: int = 6) -> dict:
    """Mean device time per call of each CUDA kernel that ``fn`` launches
    (torch.profiler kernel events, by kernel name without its arguments and
    namespace), after one warm-up; a call that launches several kernels
    (a wrapper of passes) shows each one's share.

    A profiling session loses kernel events: all of them now and then (seen
    on a 2.7 us kernel), or the first kernel it traces (seen as 4 events of
    a wrapper's first kernel in 5 calls, its other three at 5), and its
    counts have been seen to differ between sessions by a whole number of
    events a call.  So each session starts with a warm-up cycle of one
    call, whose events are dropped, and is kept only when every kernel has
    a whole number of events a call and each of the port's kernels
    (``KERNEL_OWNERS``) has as many events as its wrappers' launch counters
    rose in those ``iters`` calls, times its launches a wrapper call (a
    yardstick's: ``iters``), every wrapper that launched showing one of its
    kernels; else the session's counts and the witness are printed and the
    card profiled again, raising after ``tries`` sessions: ``EventsLost``
    where no session saw more events of a kernel than witnessed (a kernel
    launched more often than its wrapper counts is a fault)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    from repro_torch.kernels import COUNTERS
    fn()
    torch.cuda.synchronize()
    over = False
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            before = {n: c.count for n, c in COUNTERS.items()}
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            prof.step()
        launched = {n: c.count - before[n] for n, c in COUNTERS.items()
                    if c.count != before[n]}
        out: dict = {}
        counts: dict = {}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                name = e.key.replace("(anonymous namespace)::", "").split(
                    "(")[0].split("<")[0].split("::")[-1].split()[-1]
                out[name] = out.get(name, 0.0) + \
                    e.self_device_time_total / iters / 1e3
                counts[name] = counts.get(name, 0) + e.count
        want = {k: sum(launched.get(w, 0) * n
                       for w, n in KERNEL_OWNERS[k].items())
                if KERNEL_OWNERS[k] else iters
                for k in counts if k in KERNEL_OWNERS}
        shown = {w for k in want for w in KERNEL_OWNERS[k]}
        if counts and all(n % iters == 0 for n in counts.values()) and \
                all(counts[k] == n for k, n in want.items()) and \
                set(launched) <= shown:
            return out
        over = over or any(counts[k] > n for k, n in want.items())
        print(f"  device_split: a session dropped: kernel events {counts}, "
              f"wrapper launches {launched}", flush=True)
    raise (RuntimeError if over else EventsLost)(
        f"torch.profiler: none of {tries} sessions saw the kernel counts "
        f"that the launch counters witness")


# the launch floor: csrc/launch_floor.cu's empty kernel (one block of 32
# threads, no memory traffic) timed in phase 1 as every kernel is; empty
# where the driven tree has no such kernel
FLOOR: dict = {}


def phase1_floor(dev) -> None:
    """Times the empty kernel with ``time_ms`` and ``device_ms``, exactly
    as ``record`` times a kernel, into FLOOR, and prints it."""
    from repro_torch.kernels import _build
    if not hasattr(_build, "launch_floor"):
        print("phase 1: launch floor: this tree has no empty kernel",
              flush=True)
        return

    def fn():
        _build.launch_floor(dev)
    ms = time_ms(fn)
    FLOOR.update(ms=ms, device_ms=device_ms(fn))
    print(f"phase 1: launch floor (empty kernel, 1 block x 32 threads): "
          f"kernel {ms:.4f} ms (device {FLOOR['device_ms']:.4f})",
          flush=True)


def vs_floor(dms: float, bound: float) -> str:
    """The floor and a kernel's device time as a share of max(bound,
    floor): a kernel "reaches half its bound" at 50% of that."""
    if not FLOOR:
        return ""
    top = max(bound, FLOOR["device_ms"])
    return (f"  floor {FLOOR['device_ms']:.4f} ms: "
            f"{100 * top / dms:.1f}% of max(bound, floor)")


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


def make_recorder(hw, rows: dict):
    """A function that times a kernel, its plain version and (where one
    PyTorch call computes the same function) that call, prints a line and
    keeps the kernel's summary row (its prefill case) in ``rows``."""
    def record(name, case, err, kernel, plain_fn, nbytes, nops, iters=50,
               library_fn=None, library_ms=None):
        ms = time_ms(kernel, iters)
        plain = time_ms(plain_fn, iters)
        lib = time_ms(library_fn, iters) if library_fn else library_ms
        dms = device_ms(kernel)
        b, by = bound_ms(nbytes, nops, hw)
        print(f"  {name:18s} {case:8s} err {err:.3e}  kernel {ms:.4f} ms "
              f"(device {dms:.4f})  plain {plain:.4f} ms  "
              + (f"library {lib:.4f} ms  " if lib is not None else "")
              + f"bound {b:.6f} ms ({by})" + vs_floor(dms, b), flush=True)
        cur = rows.get(name)
        if cur is None or case == "prefill":
            # the prefill shape stands for the kernel in the summary line
            rows[name] = dict(case=case, ms=ms, device_ms=dms, plain_ms=plain,
                              library_ms=lib, bound_ms=b, bound_by=by,
                              max_abs_err=max(err, cur["max_abs_err"])
                              if cur else err)
        else:
            cur["max_abs_err"] = max(cur["max_abs_err"], err)
    return record


def phase1(dev, hw) -> dict:
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = {}
    record = make_recorder(hw, rows)
    phase1_moe(dev, gen, record)
    phase1_grouped_ffn(dev, hw, gen, record)
    rows["grouped_matmul"] = phase1_grouped_matmul(dev, hw, gen)
    rows["flash_attention"] = phase1_flash(dev, hw, gen)
    rows.update(phase1_recurrences(dev, hw, gen))
    rows.update(phase1_recurrence_grads(dev, hw, gen))
    return rows


# topk_gating_fused's cases: (case, tokens, D, E, k, x and router).  The
# serve path's prefill / decode (k 1), profiling (k 2) and training (8192
# tokens, k 2) at gpt2-moe's width; mixtral-8x22b's router (d 6144, 8
# experts, top-2) on a 2048-token prefill; llama4-maverick's width (d 5120,
# 128 experts, top-1); 4 experts (a router row of 8 bytes, which TMA cannot
# take: the thread-staged path); and exact ties ("tie"): a third of the
# rows of x zero, the rest one-hot (so each logit is a router entry,
# rounded nowhere), router columns duplicated in pairs, held id for id on
# every row.
GATING_CASES = (("prefill", 256, D, E, 1, "randn"),
                ("decode", 8, D, E, 1, "randn"),
                ("profile", 256, D, E, 2, "randn"),
                ("train", T_TRAIN, D, E, K_TRAIN, "randn"),
                ("mixtral", 2048, 6144, 8, 2, "randn"),
                ("llama4", 2048, 5120, 128, 1, "randn"),
                ("e4", T_TRAIN, D, 4, 2, "randn"),
                ("tie", 1000, D, E, 2, "tie"),
                ("tie e4", 1000, D, 4, 2, "tie"),
                ("tie e128", 1000, 5120, 128, 2, "tie"))


def gating_inputs(t, d, e, kind, gen, dev):
    import torch
    bf = torch.bfloat16
    if kind == "randn":
        x = torch.randn(t, d, generator=gen, device=dev).to(bf)
        router = (torch.randn(d, e, generator=gen, device=dev)
                  * d ** -0.5).to(bf)
        return x, router
    half = torch.randn(d, (e + 1) // 2, generator=gen, device=dev)
    router = half.repeat_interleave(2, dim=1)[:, :e].contiguous().to(bf)
    x = torch.zeros(t, d, device=dev)
    rows = torch.arange(t, device=dev)
    hot = rows % 3 != 0
    col = torch.randint(0, d, (t,), generator=gen, device=dev)
    sign = torch.where(rows % 2 == 0, 1.0, -2.0)   # powers of 2: exact
    x[rows[hot], col[hot]] = sign[hot]
    return x.to(bf), router


# topk_positions' cases: (case, tokens, k, E, ids).  gpt2-moe's serve
# prefill, decode and profiling and its training shape (8192 x 2: 16
# chunks of 1024 entries); Mixtral's prefill (8192 x 2, E 8); llama4's
# width (2048 x 1, E 128); E 256; every id one expert (12000 x 2: 24
# chunks, two a CTA); 65,536 x 1 (64 chunks: a second walk a CTA).  "rand":
# ids in [-1, E); "one": all E / 2
POSITIONS_CASES = (("prefill", 256, 1, E, "rand"),
                   ("decode", 8, 1, E, "rand"),
                   ("profile", 256, 2, E, "rand"),
                   ("train", T_TRAIN, K_TRAIN, E, "rand"),
                   ("mixtral", 8192, 2, 8, "rand"),
                   ("llama4", 2048, 1, 128, "rand"),
                   ("e256", T_TRAIN, K_TRAIN, 256, "rand"),
                   ("skew", 12000, 2, E, "one"),
                   ("65536", 65536, 1, E, "rand"))


def phase1_moe(dev, gen, record, strict: bool = True) -> None:
    """The five MoE routing kernels against their plain versions at the
    serve and training shapes, each call repeated bitwise.  With
    ``strict`` False (another tree's port, through ``--src``) a gating
    case that tree's wrapper refuses is printed and skipped."""
    import torch
    from repro_torch.core.gating import capacity
    from repro_torch.kernels import ref
    from repro_torch.kernels.dispatch import (combine_rows, dispatch_rows,
                                              invert_slots, weighted_route)
    from repro_torch.kernels.topk_gating import (topk_gating_fused,
                                                 topk_positions)
    bf = torch.bfloat16

    # -- gating ------------------------------------------------------------
    for case, t, d, e, k, kind in GATING_CASES:
        x, router = gating_inputs(t, d, e, kind, gen, dev)
        try:
            idx, w, probs = topk_gating_fused(x, k, router=router)
        except ValueError as err:
            if strict:
                raise
            print(f"  gating {case}: refused by this tree ({err})",
                  flush=True)
            continue
        again = topk_gating_fused(x, k, router=router)
        if not all(torch.equal(a, b) for a, b in zip(again, (idx, w, probs))):
            raise AssertionError(f"gating {case}: repeat not bitwise")
        perr = check_gating(case, x, router, k, (idx, w, probs),
                            tie=kind == "tie")
        record("topk_gating_fused", case, perr,
               lambda: topk_gating_fused(x, k, router=router),
               lambda: ref.ref_topk_gating(x @ router, k),
               t * d * 2 + d * e * 2 + t * k * 8 + t * e * 4, 2 * t * d * e)
        del x, router, idx, w, probs, again

    # -- positions (POSITIONS_CASES) --------------------------------------
    try:
        from repro_torch.kernels.topk_gating import positions_plan
    except ImportError:         # a tree from before the cluster kernel
        positions_plan = None
    for case, t, k, e, kind in POSITIONS_CASES:
        ids = (torch.randint(-1, e, (t, k), generator=gen, device=dev,
                             dtype=torch.int32) if kind == "rand"
               else torch.full((t, k), e // 2, dtype=torch.int32,
                               device=dev))
        got = topk_positions(ids, e)
        want = ref.ref_topk_positions(ids, e)
        if not torch.equal(got, want):
            raise AssertionError(f"topk_positions {case}: mismatch")
        if not torch.equal(topk_positions(ids, e), got):
            raise AssertionError(f"topk_positions {case}: repeat not "
                                 f"bitwise")
        if positions_plan is not None:
            g, span, walk = positions_plan(t * k)
            print(f"  topk_positions {case}: {t} x {k}, E {e}, {kind}: "
                  f"bitwise, repeat bitwise; {g} CTA(s) of {span} "
                  f"chunk(s) of 1024, {walk}", flush=True)
        record("topk_positions", case, 0.0, lambda: topk_positions(ids, e),
               lambda: ref.ref_topk_positions(ids, e), t * k * 8, 0)

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
        if not torch.equal(dispatch_rows(x, src), buf):
            raise AssertionError(f"dispatch_rows {case}: repeat not bitwise")
        n_kept = int((src >= 0).sum())
        record("dispatch_rows", case, 0.0, lambda: dispatch_rows(x, src),
               lambda: ref.ref_dispatch_rows(x, src),
               n_kept * D * 2 + n_rows * 4 + n_rows * D * 2, 0)

        y_buf = torch.randn(n_rows, D, generator=gen, device=dev).to(bf)
        wts = torch.rand(t, k, generator=gen, device=dev)
        y = combine_rows(y_buf, rows_, wts)
        if not torch.equal(combine_rows(y_buf, rows_, wts), y):
            raise AssertionError(f"combine_rows {case}: repeat not bitwise")
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

    # -- weighted_route at Mixtral's prefill: 4096 tokens top-2 over 8
    # experts of 4 replicas each in 32 slots, slot_cap the capacity ---------
    t, k = 4096, 2
    cap = capacity(t, MIX_E, k, 1.25)
    kept, pos, cum, slot_of = _route_inputs(t, k, cap, cap, gen, dev,
                                            n_exp=MIX_E, n_slots=MIX_SLOTS,
                                            replicas=MAX_PACK)
    got = weighted_route(kept, pos, cum, slot_of, cap)
    if not torch.equal(got, ref.ref_weighted_route(kept, pos, cum, slot_of,
                                                   cap)):
        raise AssertionError("weighted_route mixtral: mismatch")
    if not torch.equal(weighted_route(kept, pos, cum, slot_of, cap), got):
        raise AssertionError("weighted_route mixtral: repeat not bitwise")
    print(f"  weighted_route mixtral: {t} x {k}, E {MIX_E} x {MAX_PACK} "
          f"replicas in {MIX_SLOTS} slots of {cap}: bitwise, repeat "
          f"bitwise; {int((got >= 0).sum())} of {t * k} choices routed",
          flush=True)
    record("weighted_route", "mixtral", 0.0,
           lambda: weighted_route(kept, pos, cum, slot_of, cap),
           lambda: ref.ref_weighted_route(kept, pos, cum, slot_of, cap),
           t * k * 4 * 3 + cum.numel() * 8, 0)

    # -- dispatch / combine at the training shape, as the step calls them:
    # 8192 tokens top-2 into E x C rows, ids skewed so the busiest experts
    # pass C and drop tokens; dispatch unscaled (the forward and its remat
    # recompute, 24 of a step's 36 launches), with the gate weight as the
    # per-row scale, and with it and the saved slot buffer as ``dot``
    # (combine's backward), combine with unit weights (dispatch's
    # backward); then dispatch and combine again with L2 flushed before
    # each timed call ---------------------------------------------------------
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
    for case, sc in (("train", scale), ("train copy", None)):
        buf = dispatch_rows(dy, src, sc)
        if not torch.equal(buf, ref.ref_dispatch_rows(dy, src, sc)):
            raise AssertionError(f"dispatch_rows {case}: mismatch")
        if not torch.equal(dispatch_rows(dy, src, sc), buf):
            raise AssertionError(f"dispatch_rows {case}: repeat not bitwise")
        record("dispatch_rows", case, 0.0,
               lambda: dispatch_rows(dy, src, sc),
               lambda: ref.ref_dispatch_rows(dy, src, sc),
               n_kept * D * 2 + n_rows * (4 if sc is None else 8)
               + n_rows * D * 2, 0 if sc is None else n_kept * D)

    slots = torch.randn(n_rows, D, generator=gen, device=dev).to(bf)
    dot_ok = dispatch_dot_case(dy, src, scale, slots, n_kept, record,
                               strict)

    ones = torch.ones(t, k, device=dev)
    y = combine_rows(slots, rows_, ones)
    if not torch.equal(combine_rows(slots, rows_, ones), y):
        raise AssertionError("combine_rows train: repeat not bitwise")
    yr = ref.ref_combine_rows(slots, rows_, ones).float()
    ulp = torch.where(yr != 0, torch.exp2(torch.floor(torch.log2(
        yr.abs())) - 7), torch.full_like(yr, 2.0 ** -133))
    cerr = (y.float() - yr).abs()
    if bool((cerr > ulp).any()):
        raise AssertionError("combine_rows train (unit weights): beyond 1 "
                             "bf16 ulp")
    record("combine_rows", "train", cerr.max().item(),
           lambda: combine_rows(slots, rows_, ones),
           lambda: ref.ref_combine_rows(slots, rows_, ones),
           n_kept * D * 2 + t * k * 8 + t * D * 2, 2 * n_kept * D)

    # the combine backward alone, as one training layer runs it (the
    # _Combine node: invert_slots, the scale gather, the dispatch pass and
    # the gate weights' gradient), by device time a call
    from repro_torch.kernels import ops
    leaves = (slots.detach().requires_grad_(), wts.detach().requires_grad_())
    y_comb = ops.combine_op(leaves[0], rows_, leaves[1])
    bwd_ms = device_ms(lambda: torch.autograd.grad(y_comb, leaves, dy,
                                                   retain_graph=True))
    print(f"  combine backward train (the _Combine node alone, {n_rows} "
          f"slot rows, {t} x {k}): device {bwd_ms:.4f} ms a call", flush=True)
    del y_comb, leaves

    cold = [("dispatch_rows", "train", "dispatch_kernel",
             lambda: dispatch_rows(dy, src, scale)),
            ("dispatch_rows", "train copy", "dispatch_kernel",
             lambda: dispatch_rows(dy, src)),
            ("combine_rows", "train", "combine_kernel",
             lambda: combine_rows(slots, rows_, ones))]
    if dot_ok:
        cold.insert(2, ("dispatch_rows", "train dot", "dispatch_kernel",
                        lambda: dispatch_rows(dy, src, scale, dot=slots)))
    flush = torch.empty(L2_FLUSH_BYTES // 4, device=dev)
    for name, case, tag, fn in cold:
        ms, dms = cold_ms(fn, tag, flush)
        print(f"  {name:18s} {case:10s} cold L2 ({L2_FLUSH_BYTES >> 20} MiB "
              f"written before each call): kernel {ms:.4f} ms (device "
              f"{dms:.4f})", flush=True)
    del buf, y, yr, dy, slots, flush


def dispatch_dot_case(x, src, scale, slots, n_kept, record,
                      strict: bool) -> bool:
    """``dispatch_rows`` with the scale and ``dot`` (combine's backward at
    the training shape): out bitwise the plain version's, each rowdot[r]
    within DOT_REL of sum_c |dot[r,c] * x[src[r],c]| of the plain
    version's (exact 0 on empty rows), both repeated bitwise.  Returns
    False where another tree's wrapper has no ``dot`` (``strict`` False)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.dispatch import dispatch_rows
    try:
        out, rowdot = dispatch_rows(x, src, scale, dot=slots)
    except TypeError as err:
        if strict:
            raise
        print(f"  dispatch_rows train dot: refused by this tree ({err})",
              flush=True)
        return False
    want, want_dot = ref.ref_dispatch_rows(x, src, scale, dot=slots)
    if not torch.equal(out, want):
        raise AssertionError("dispatch_rows train dot: out mismatch")
    again = dispatch_rows(x, src, scale, dot=slots)
    if not (torch.equal(again[0], out) and torch.equal(again[1], rowdot)):
        raise AssertionError("dispatch_rows train dot: repeat not bitwise")
    kept = src >= 0
    mag = (slots.float() * x[torch.clamp(src, min=0).long()].float()) \
        .abs().sum(-1)
    err = (rowdot - want_dot).abs()
    if bool((rowdot[~kept] != 0).any()):
        raise AssertionError("dispatch_rows train dot: rowdot of an empty "
                             "row is not 0")
    ratio = (err[kept] / mag[kept].clamp(min=1e-30)).max().item()
    print(f"  dispatch_rows train dot: out bitwise, repeat bitwise; rowdot "
          f"largest |err| / sum|dot * x| {ratio:.3e} (limit {DOT_REL:g}), "
          f"max |err| {err.max().item():.3e}", flush=True)
    if not ratio <= DOT_REL:
        raise AssertionError(f"dispatch_rows train dot: rowdot off by "
                             f"{ratio:.3e} of sum|dot * x|")
    n_rows, d = slots.shape
    record("dispatch_rows", "train dot", err.max().item(),
           lambda: dispatch_rows(x, src, scale, dot=slots),
           lambda: ref.ref_dispatch_rows(x, src, scale, dot=slots),
           2 * n_kept * d * 2 + n_rows * 12 + n_rows * d * 2,
           3 * n_kept * d)
    return True


# rowdot's limit, relative to sum_c |dot[r,c] * x[src[r],c]|: fp32 sums of
# up to a few thousand products in two orders differ by some 1e-6 of it
DOT_REL = 1e-5
# bytes written between cold-L2 timed calls: over twice the 50 MB L2
L2_FLUSH_BYTES = 128 << 20


def cold_ms(fn, tag: str, flush, iters: int = 20, tries: int = 6) -> tuple:
    """Per-call time of ``fn`` with ``flush`` (over twice L2) written before
    each call, outside the timed pair: (ms by CUDA events around the call
    alone, device ms of the kernels whose name holds ``tag``).  A profiling
    session can lose kernel events (``device_split``): each opens with a
    warm-up cycle and is kept when it holds a whole number of ``tag``
    launches a call, else profile again, and raise after ``tries``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    pairs = []
    for i in range(iters):
        flush.fill_(float(i))
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    ms = sum(a.elapsed_time(b) for a, b in pairs) / iters
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            flush.fill_(0.0)
            fn()
            torch.cuda.synchronize()
            prof.step()
            for i in range(iters):
                flush.fill_(float(i))
                fn()
            torch.cuda.synchronize()
            prof.step()
        hits = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and tag in e.key]
        n = sum(e.count for e in hits)
        if n and n % iters == 0:
            return ms, sum(e.self_device_time_total for e in hits) / n / 1e3
    raise RuntimeError(f"torch.profiler recorded no whole number of {tag} "
                       f"launches a call in {tries} sessions")


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
# of 4 x 2), and the empty slots; then llama4-maverick's serve prefill at a
# default ServerConfig's 512 slots (128 experts x max_pack 4: csrc/
# moe_ffn.cu's kMaxGroups, the last count its sorted walk takes), every
# expert in 4 slots, the routed rows of a 4 x 2048-token top-1 prefill (cap
# 88, slot_cap 22), swiglu d 5120 / f 8192, weights read in place (32 GB);
# and the same at 513 slots (one empty: the index-order walk) at f 1024;
# then rank 0 of mixtral-8x22b on its arch_mesh (16, 8, 2): train_4k's
# expert-sliced call (its one local expert's f / tp = 8192 columns, one
# of 4 micro-op chunks of the received capacity rows, every row counted),
# and prefill_32k's (the serve layer reads whole experts: its 2 hosted
# experts in place, each slot's rows those the 8 `model` ranks route to it
# from their copies of the 2 x 32768 tokens, top-2 over 8 experts, kept
# at capacity factor 1.25: route ("rows", tokens, k, experts, senders))
MIX_D, MIX_F, MIX_E, MIX_SLOTS = 6144, 16384, 8, 32
L4_D, L4_F, L4_E, L4_SLOTS, L4_SLOT_CAP = 5120, 8192, 128, 512, 22
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
             ("empty slot", 4, 200, 512, 1024, "swiglu", "empty", 20),
             ("llama4 prefill", L4_SLOTS, L4_SLOT_CAP, L4_D, L4_F, "swiglu",
              (L4_E, 8192, 1, MAX_PACK), 5),
             ("llama4 513", L4_SLOTS + 1, L4_SLOT_CAP, L4_D, 1024, "swiglu",
              (L4_E, 8192, 1, MAX_PACK), 10),
             ("mixtral tp train", 1, 5136, MIX_D, MIX_F // 2, "swiglu", None,
              10),
             ("mixtral rank-0 prefill", 2, 163904, MIX_D, MIX_F, "swiglu",
              ("rows", 65536, 2, MIX_E, 8), 3))
# the plain version gathers each slot's weights: past this many bytes it
# goes slot block by slot block (llama4's 512 slots would gather 129 GB)
GATHER_MAX = 8 << 30


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


def gather_block(*weights) -> int:
    """Slots whose gathered expert weights (``weights``: [E, ...] stacks,
    None skipped) fit in GATHER_MAX bytes."""
    per_slot = sum(w[0].numel() * w.element_size()
                   for w in weights if w is not None)
    return max(1, GATHER_MAX // per_slot)


def ffn_plain(x, wi, wu, wo, act, group_expert, group_rows):
    """``ref_grouped_ffn`` over blocks of slots whose gathered weights stay
    within GATHER_MAX bytes: the same function (a slot's rows meet only its
    own expert's weights), with at most one block's weights gathered."""
    import torch
    from repro_torch.kernels import ref
    g, n = x.shape[0], gather_block(wi, wu, wo)
    if group_expert is None or g <= n:
        return ref.ref_grouped_ffn(x, wi, wu, wo, act, group_expert,
                                   group_rows)
    return torch.cat([ref.ref_grouped_ffn(
        x[i:i + n], wi, wu, wo, act, group_expert[i:i + n],
        None if group_rows is None else group_rows[i:i + n])
        for i in range(0, g, n)])


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
    rows_of = isinstance(route, tuple) and route[0] == "rows"
    n_w = g if rows_of else route[0] if isinstance(route, tuple) else \
        3 if route else g
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
    elif rows_of:          # slot g hosts expert g, its senders' kept rows
        _, n_tok, k, n_exp, senders = route
        idx = torch.randint(0, n_exp, (n_tok, k), generator=gen, device=dev,
                            dtype=torch.int32)
        pos = ref.ref_topk_positions(idx, n_exp)
        kept = idx[pos < capacity(n_tok, n_exp, k, 1.25)]
        counts = torch.bincount(kept.long(), minlength=n_exp)
        ge = torch.arange(g, dtype=torch.int32, device=dev)
        gr = torch.clamp(senders * counts[:g], max=t).int()
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


def library_by_blocks(x, wi, wu, wo, act, sel, iters: int) -> float:
    """The bf16 composition (einsum, act, einsum) over blocks of slots
    whose gathered weights fit in GATHER_MAX bytes, each block's weights
    gathered before its timing: the sum of the blocks' times (ms)."""
    from repro_torch.kernels import ref
    n = gather_block(wi, wu, wo)
    total, blocks = 0.0, 0
    for i in range(0, x.shape[0], n):
        wb = [None if a is None else a[sel[i:i + n]] for a in (wi, wu, wo)]
        xb = x[i:i + n]
        total += time_ms(lambda: ref.ref_grouped_ffn(xb, *wb, act), iters)
        blocks += 1
        del wb
    print(f"  grouped_ffn library: {blocks} blocks of up to {n} slots, "
          f"{total:.4f} ms summed", flush=True)
    return total


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
        # the yardstick's weights gathered beforehand, where they fit; else
        # (llama4) block by block as the plain version runs, each block's
        # weights gathered before its timing, the blocks' times summed
        fits = sel is None or slots <= gather_block(wi, wu, wo)
        wg = [None if a is None or sel is None or not fits else a[sel]
              for a in (wi, wu, wo)]
        lib_blocks = None if fits else \
            library_by_blocks(x, wi, wu, wo, act, sel, iters)
        record("grouped_ffn", case, err,
               lambda: grouped_ffn(x, wi, wu, wo, **kw),
               lambda: ffn_plain(x, wi, wu, wo, act, ge, gr),
               io_bytes + hosted * w_bytes, n_ops, iters=iters,
               library_fn=(lambda: ref.ref_grouped_ffn(
                   x, *(wi, wu, wo) if sel is None else wg, act))
               if fits else None, library_ms=lib_blocks)
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
              f"torch.bmm {lib:.4f} ms  bound {bnd:.4f} ms ({by})"
              + vs_floor(dms, bnd), flush=True)
        for key, v in (("ms", ms), ("device_ms", dms), ("plain_ms", plain),
                       ("library_ms", lib), ("bound_ms", bnd)):
            tot[key] += v
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        del got, again, a2, b2
    print(f"  grouped_matmul, one layer's backward (5 GEMMs): kernel "
          f"{tot['ms']:.4f} ms (device {tot['device_ms']:.4f})  plain "
          f"{tot['plain_ms']:.4f} ms  torch.bmm {tot['library_ms']:.4f} ms  "
          f"bound {tot['bound_ms']:.4f} ms"
          + vs_floor(tot["device_ms"], tot["bound_ms"]), flush=True)
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
# 2048 prefill (phase 6); a ragged S with GQA and a window that cuts;
# llama4's and granite's head groups; hubert-xlarge's bidirectional
# encoder at head dim 80 (phase 11), and hd 80 causal, ragged, GQA and
# windowed; llava-next-34b's 56 / 8 heads (a GQA group of 7) at its 4 x
# 2048 prefill (phase 11); rank 0 of qwen2-72b's prefill_32k on 16 x 16
# (phase 15 (b)): 2 x 32768 tokens, its 4 of the 64 q heads against the
# one kv head they read
FLASH_CASES = (("a gpt2 prefill", 4, 64, 12, 12, 64, True, 0, 50),
               ("b gpt2 1024", 8, 1024, 12, 12, 64, True, 0, 20),
               ("c mixtral 2048", 1, 2048, 48, 8, 128, True, 4096, 20),
               ("d mixtral 6144", 1, 6144, 48, 8, 128, True, 4096, 10),
               ("e bert non-causal", 8, 512, 16, 16, 64, False, 0, 20),
               ("f zamba2 shared", 4, 2048, 32, 32, 64, True, 0, 10),
               ("g ragged gqa", 2, 1000, 48, 8, 128, True, 256, 20),
               ("h llama4 40/8", 1, 2048, 40, 8, 128, True, 0, 20),
               ("i granite mqa 48/1", 1, 2048, 48, 1, 128, True, 0, 20),
               ("j hubert hd80", 4, 2048, 16, 16, 80, False, 0, 20),
               ("k hd80 causal window", 2, 1000, 16, 4, 80, True, 256, 20),
               ("l llava 56/8", 4, 2048, 56, 8, 128, True, 0, 10),
               ("m qwen2-72b rank 0 4/1", 2, 32768, 4, 1, 128, True, 0, 5))
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
    tokens, so its fp32 [S, S] logits fit; past 8192, the blockwise plain
    path of ``models.attention`` (fp32 logits of 1024 queries at a
    time)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.models.attention import _sdpa_blockwise
    s, h, kv = q.shape[1], q.shape[2], k.shape[2]
    if s <= 2048:
        return ref.ref_attention(q, k, v, causal=causal, window=window)
    if s > 8192:
        return _sdpa_blockwise(q, k, v, causal=causal, window=window)
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
              f"{bnd:.4f} ms ({by}; {pairs} pairs a head)"
              + vs_floor(dms, bnd), flush=True)
        if name == FLASH_ROW_CASE:
            row = dict(case=name, ms=ms, device_ms=dms, plain_ms=plain,
                       library_ms=lib, bound_ms=bnd, bound_by=by)
        del q, k, v, qt, kt, vt, mask
    return dict(row, max_abs_err=worst)


# fp32 arithmetic outside the tensor cores (NVIDIA's H100 SXM data sheet):
# the rate of the WKV step loop (T < 64), and the recurrences' second bound
FP32_FLOPS = 67e12
# norm-wise ||kernel - plain|| / ||plain|| of the two recurrences: both
# compute in fp32 sums from the same bf16 inputs, in other orders, in their
# chunked forms, with the operands that are not bf16 (SSD: M, h, cw B; WKV:
# the scaled r and k, the scores, S) as bf16 hi / lo pairs
REC_REL = 1e-4
# the rwkv6-1.6b / zamba2-1.2b serve shapes: B, T, H, hd; B, T, H, P, N
WKV_SHAPE = (4, 2048, 32, 64)
SSD_SHAPE = (4, 2048, 64, 64, 64)
# rwkv6_wkv's phase-1 cases at rwkv6-1.6b's 32 heads: (case, B, T, decay,
# random s0 and the final state).  Decays (wkv_decay): "model" the seeded
# model's -exp(-2 + N(0, 0.5^2)) ~ -0.135 a step; "strong" -5 to -20 a step
# (a trained RWKV6 reaches several units; e^(+cumsum w) of a chunk
# overflows); "weak" ~ -1e-4 a step (S grows over the sequence)
WKV_CASES = (("prefill", 4, 2048, "model", False),
             ("ragged", 4, 2000, "model", False),
             ("single", 1, 2048, "model", False),
             ("s0", 4, 2048, "model", True),
             ("strong decay", 4, 2000, "strong", True),
             ("weak decay", 4, 2048, "weak", True))
# ssd_scan's phase-1 cases at zamba2-1.2b's 64 heads: (case, B, T, dt
# scale, dt shift, random h0 and the final state).  "strong decay":
# softplus(dt) ~ 6.25, so dt a reaches ~ -100 a step at a = -16 and exp(L_t
# - L_s) overflows above the diagonal
SSD_CASES = (("prefill", 4, 2048, 1.0, 0.0, False),
             ("ragged", 4, 2000, 1.0, 0.0, False),
             ("single", 1, 2048, 1.0, 0.0, False),
             ("h0", 4, 2048, 1.0, 0.0, True),
             ("strong decay", 4, 2000, 0.2, 6.25, True))


def wkv_decay(kind: str, z):
    """A log decay from the standard normal ``z`` (WKV_CASES)."""
    import torch
    if kind == "model":
        return -torch.exp(z * 0.5 - 2.0)
    if kind == "strong":
        return -(12.5 + 7.5 * torch.tanh(z))
    return -1e-4 * (1.0 + 0.5 * torch.tanh(z))


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
    the serve shapes of rwkv6-1.6b and zamba2-1.2b: WKV (WKV_CASES) with a
    random non-zero bonus u (the models start it at zero) at the prefill
    shape, at a ragged T, as one 1 x 2048 request, from a random s0 (the
    final state held too), under a strong and a weak decay, split in two
    calls that carry the state, and at the decode shape (T = 1) from a
    random state; SSD (SSD_CASES) with x, B and C sliced in place from
    one projection at the prefill shape, at a ragged T, as one 1 x 2048
    request, from a random h0 (the final state held too), under a strong
    decay, and split in two calls; every call repeated bitwise.
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
               peak=FP32_FLOPS):
        """Hold the case to REC_REL, time it and print it; the bound at
        ``peak`` (the rate of the kernel's arithmetic), and at fp32 beside
        it where that differs."""
        err = max(v for k, v in errs.items() if k != "max_abs")
        if not err <= REC_REL:
            raise AssertionError(f"{name} {case}: norm-wise rel err {errs} > "
                                 f"{REC_REL}")
        ms = time_ms(kernel, iters, 3)
        dms = device_ms(kernel, min(iters, 10))
        pms = time_ms(plain, 2, 1)
        bnd, by = bound_ms(nbytes, nops, hw, peak=peak)
        rate, extra = "fp32", ""
        if peak != FP32_FLOPS:
            b32, by32 = bound_ms(nbytes, nops, hw, peak=FP32_FLOPS)
            rate, extra = "bf16", f"; at fp32 {b32:.4f} ms ({by32})"
        print(f"  {name:18s} {case:8s} norm-wise rel err "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f" (limit {REC_REL})  kernel {ms:.4f} ms (device {dms:.4f}, "
              f"{nops / dms / 1e9:.2f} TFLOP/s, {nbytes / dms / 1e9:.2f} "
              f"TB/s, {bnd / dms:.1%} of the bound)  plain {pms:.4f} ms  "
              f"bound {bnd:.4f} ms ({by}, {rate} peak{extra}; {nbytes} "
              f"bytes, {nops} operations)" + vs_floor(dms, bnd), flush=True)
        row = dict(case=case, ms=ms, device_ms=dms, plain_ms=pms,
                   library_ms=None, bound_ms=bnd, bound_by=by,
                   max_abs_err=errs["max_abs"])
        cur = rows.get(name)
        if cur is None:
            rows[name] = row
        else:
            cur["max_abs_err"] = max(cur["max_abs_err"], errs["max_abs"])

    with torch.inference_mode():
        # -- rwkv6_wkv (WKV_CASES): the model's value ranges (unit r, k, v;
        # decays near exp(-exp(-2)) = 0.87), a random bonus u; each call run
        # twice and held bitwise.  From T = 64 the kernel's products run on
        # the bf16 tensor cores: their bound at the bf16 peak (wkv_cost
        # counts the function's operations once), the fp32 one beside it
        _, _, h, hd = WKV_SHAPE
        u = rnd(h, hd, scale=0.5)

        def wkv_twice(case, *args, **kw):
            got = rwkv6_wkv(*args, **kw)
            again = rwkv6_wkv(*args, **kw)
            got, again = ((g,) if not isinstance(g, tuple) else g
                          for g in (got, again))
            if not all(torch.equal(g, a) for g, a in zip(got, again)):
                raise AssertionError(f"rwkv6_wkv {case}: a repeat differs")
            if not all(torch.isfinite(g).all() for g in got):
                raise AssertionError(f"rwkv6_wkv {case}: non-finite output")
            return got

        for case, b, t, decay, with_s0 in WKV_CASES:
            r, k, v = (rnd(b, t, h, hd).to(bf) for _ in range(3))
            w = wkv_decay(decay, rnd(b, t, h, hd))
            s0 = rnd(b, h, hd, hd, scale=2.0) if with_s0 else None
            if case == "prefill":
                whole = (r, k, v, w)

            def run(fn, r=r, k=k, v=v, w=w, s0=s0, with_s0=with_s0):
                return fn(r, k, v, w, u, s0=s0, return_state=with_s0)

            got = wkv_twice(case, r, k, v, w, u, s0=s0,
                            return_state=with_s0)
            want = run(ref.ref_rwkv6)
            want = want if with_s0 else (want,)
            errs = {k_: rel_err(g, w_) for k_, g, w_ in zip(("y", "state"),
                                                             got, want)}
            errs["max_abs"] = max((g - w_).abs().max().item()
                                  for g, w_ in zip(got, want))
            report("rwkv6_wkv", case, errs, lambda run=run: run(rwkv6_wkv),
                   lambda run=run: run(ref.ref_rwkv6),
                   *wkv_cost(b, t, h, hd, with_s0, with_s0),
                   peak=hw.peak_flops)
            del got, want
        # the split: two calls carrying the state against one call
        r, k, v, w = whole
        b, t = r.shape[:2]
        cut = 1000
        halves = [tuple(a[:, sl].contiguous() for a in (r, k, v, w))
                  for sl in (slice(0, cut), slice(cut, t))]

        def split_run(fn):
            y1, s1 = fn(*halves[0], u, return_state=True)
            y2, s2 = fn(*halves[1], u, s0=s1, return_state=True)
            return torch.cat([y1, y2], dim=1), s2

        split, s2 = split_run(rwkv6_wkv)
        split2, s22 = split_run(rwkv6_wkv)
        if not (torch.equal(split, split2) and torch.equal(s2, s22)):
            raise AssertionError(f"rwkv6_wkv split@{cut}: a repeat differs")
        y_all, s_all = wkv_twice("prefill", r, k, v, w, u, return_state=True)
        want, s_ref = ref.ref_rwkv6(r, k, v, w, u, return_state=True)
        errs = {"y vs one call": rel_err(split, y_all),
                "state vs one call": rel_err(s2, s_all),
                "y vs plain": rel_err(split, want),
                "state vs plain": rel_err(s2, s_ref),
                "max_abs": max((split - want).abs().max().item(),
                               (s2 - s_ref).abs().max().item())}
        report("rwkv6_wkv", f"split@{cut}", errs,
               lambda: split_run(rwkv6_wkv), lambda: split_run(ref.ref_rwkv6),
               *add_costs(wkv_cost(b, cut, h, hd, s_out=True),
                          wkv_cost(b, t - cut, h, hd, True, True)), iters=5,
               peak=hw.peak_flops)
        del whole, r, k, v, w, halves, split, split2, y_all, want
        # decode: one step from a random state (the step loop, fp32)
        r1, k1, v1 = (rnd(b, 1, h, hd).to(bf) for _ in range(3))
        w1 = wkv_decay("model", rnd(b, 1, h, hd))
        s0 = rnd(b, h, hd, hd, scale=2.0)
        y, st = wkv_twice("decode", r1, k1, v1, w1, u, s0=s0,
                          return_state=True)
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
        # the model's convolved projection; zamba2's a_log, unit D.  Each
        # case is run twice and must repeat bitwise; the bound is at the
        # bf16 tensor-core peak (the kernel's products; ssd_cost counts the
        # function's operations once, not the hi / lo pairs)
        _, _, h, p, n = SSD_SHAPE
        a_log = torch.log(torch.linspace(1.0, 16.0, h, device=dev))
        d_skip = torch.ones(h, device=dev)
        inputs = {}
        for case, b, t, scale, shift, with_h0 in SSD_CASES:
            xbc = rnd(b, t, h * p + 2 * n).to(bf)
            x = xbc[..., :h * p].reshape(b, t, h, p)
            bb, cc = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
            dt = (rnd(b, t, h, scale=scale) + shift).to(bf)
            h0 = rnd(b, h, p, n) if with_h0 else None
            inputs[case] = (x, dt, bb, cc)

            def run(fn, x=x, dt=dt, bb=bb, cc=cc, h0=h0, with_h0=with_h0):
                return fn(x, dt, a_log, bb, cc, d_skip, h0=h0,
                          return_state=with_h0)

            got = run(ssd_scan)
            again = run(ssd_scan)
            want = run(ref.ref_ssd)
            if not with_h0:
                got, again, want = (got,), (again,), (want,)
            if not all(torch.equal(g, a) for g, a in zip(got, again)):
                raise AssertionError(f"ssd_scan {case}: a repeat differs")
            if not all(torch.isfinite(g).all() for g in got):
                raise AssertionError(f"ssd_scan {case}: non-finite output")
            errs = {k: rel_err(g, w) for k, g, w in zip(("y", "state"), got,
                                                        want)}
            errs["max_abs"] = max((g - w).abs().max().item()
                                  for g, w in zip(got, want))
            report("ssd_scan", case, errs, lambda run=run: run(ssd_scan),
                   lambda run=run: run(ref.ref_ssd),
                   *ssd_cost(b, t, h, p, n, with_h0, with_h0),
                   peak=hw.peak_flops)
            del got, again, want
        # the split (at T = 2000, mid-chunk): two calls carrying the state,
        # the strided slices passed as they are
        x, dt, bb, cc = inputs["ragged"]
        b, t = x.shape[:2]
        cut = 1000

        def ssd_split(fn):
            y1, h1 = fn(x[:, :cut], dt[:, :cut], a_log, bb[:, :cut],
                        cc[:, :cut], d_skip, return_state=True)
            y2, h2 = fn(x[:, cut:], dt[:, cut:], a_log, bb[:, cut:],
                        cc[:, cut:], d_skip, h0=h1, return_state=True)
            return torch.cat([y1, y2], dim=1), h2

        split, h2 = ssd_split(ssd_scan)
        split2, h22 = ssd_split(ssd_scan)
        if not (torch.equal(split, split2) and torch.equal(h2, h22)):
            raise AssertionError(f"ssd_scan split@{cut}: a repeat differs")
        want, h_ref = ref.ref_ssd(x, dt, a_log, bb, cc, d_skip,
                                  return_state=True)
        errs = {"y vs plain": rel_err(split, want),
                "state vs plain": rel_err(h2, h_ref),
                "max_abs": max((split - want).abs().max().item(),
                               (h2 - h_ref).abs().max().item())}
        report("ssd_scan", f"split@{cut}", errs,
               lambda: ssd_split(ssd_scan), lambda: ssd_split(ref.ref_ssd),
               *add_costs(ssd_cost(b, cut, h, p, n, s_out=True),
                          ssd_cost(b, t - cut, h, p, n, True, True)),
               iters=5, peak=hw.peak_flops)
    return rows


# the backward kernels' phase-1 cases.  WKV at rwkv6-1.6b's 32 heads: (case,
# B, T, decay, random s0 and a final-state cotangent): the training shape,
# a ragged T, T < 64 (where the forward runs its step loop), and from a
# random s0 with a cotangent on the final state under a strong and a weak
# decay (wkv_decay)
WKV_BWD_CASES = (("train", 4, 2048, "model", False),
                 ("ragged", 4, 2000, "model", False),
                 ("short", 4, 40, "model", False),
                 ("s0 strong", 4, 2000, "strong", True),
                 ("s0 weak", 4, 2048, "weak", True))
# SSD at zamba2-1.2b's 64 heads, x, B and C sliced in place from one
# projection: (case, B, T, A of every head (None: the model's linspace(1,
# 16)), dt scale, dt shift, random h0 and a final-state cotangent).  At A =
# 16 the reference's chunked form overflows (its gradient is NaN); "strong"
# is the forward's strong decay (SSD_CASES): softplus(dt) ~ 6.25, dt a ~
# -100 a step at a = -16
SSD_BWD_CASES = (("train", 4, 2048, None, 1.0, 0.0, False),
                 ("ragged", 4, 2000, None, 1.0, 0.0, False),
                 ("h0 A=16", 4, 2048, 16.0, 1.0, 0.0, True),
                 ("strong", 4, 2048, None, 0.2, 6.25, True))


def wkv_bwd_cost(b, t, h, hd, states: bool = False) -> tuple:
    """(bytes, operations) of one WKV backward: r, k, v bf16, w and dy
    fp32 read once; dr, dk, dv, dw fp32 written once; u and du; with
    ``states`` s0 and the final state's cotangent read and ds0 written.
    Per step of a head 14 hd^2 (the state's update, S dy, G v, G^T k,
    S .* G and the cotangent's update) + 10 hd."""
    nbytes = b * t * h * hd * (3 * 2 + 4 + 4 + 4 * 4) + 2 * h * hd * 4 \
        + states * 3 * b * h * hd * hd * 4
    return nbytes, b * h * t * (14 * hd * hd + 10 * hd)


def ssd_bwd_cost(b, t, h, p, n, states: bool = False) -> tuple:
    """(bytes, operations) of one SSD backward: x, dt, B, C bf16 and dy
    fp32 read once; dx, ddt, dB, dC fp32 written once; a_log, D and their
    gradients; with ``states`` h0 and the final state's cotangent read and
    dh0 written.  Per step of a head 14 P N (the state's update, G += dy
    C^T, G B, <G, h>, h^T dy, G^T x and the cotangent's decay) + 8 P."""
    nbytes = b * t * (h * p * 2 + h * 2 + 2 * n * 2 + h * p * 4
                      + h * p * 4 + h * 4 + 2 * n * 4) + 4 * h * 4 \
        + states * 3 * b * h * p * n * 4
    return nbytes, b * h * t * (14 * p * n + 8 * p)


def phase1_recurrence_grads(dev, hw, gen) -> dict:
    """rwkv6_wkv_bwd and ssd_scan_bwd against ref_rwkv6_bwd / ref_ssd_bwd
    on the card at WKV_BWD_CASES and SSD_BWD_CASES, every gradient held
    norm-wise to REC_REL, every call repeated bitwise; timed with CUDA
    events and torch.profiler, the plain version timed at the training
    shape.  Returns each kernel's summary row (the training shape)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6 as rwkv6_mod
    from repro_torch.kernels import ssd as ssd_mod
    if not hasattr(rwkv6_mod, "rwkv6_wkv_bwd"):
        print("phase 1: this tree has no backward kernels of the "
              "recurrences", flush=True)
        return {}
    rwkv6_wkv_bwd, ssd_scan_bwd = rwkv6_mod.rwkv6_wkv_bwd, \
        ssd_mod.ssd_scan_bwd
    bf = torch.bfloat16
    rows = {}

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def check(name, case, names, kernel, plain, cost):
        got = kernel()
        again = kernel()
        if not all(torch.equal(g, a) for g, a in zip(got, again)):
            raise AssertionError(f"{name} {case}: a repeat differs")
        if not all(torch.isfinite(g).all() for g in got):
            raise AssertionError(f"{name} {case}: non-finite gradient")
        want = plain()
        errs = {n: rel_err(g, w) for n, g, w in zip(names, got, want)
                if w is not None}
        max_abs = max((g - w).abs().max().item()
                      for g, w in zip(got, want) if w is not None)
        del got, again, want
        if not max(errs.values()) <= REC_REL:
            raise AssertionError(f"{name} {case}: norm-wise rel err {errs} "
                                 f"> {REC_REL}")
        ms = time_ms(kernel, 5, 1)
        split = device_split(kernel, 5)
        dms = sum(split.values())
        nbytes, nops = cost
        bnd, by = bound_ms(nbytes, nops, hw)
        b32, by32 = bound_ms(nbytes, nops, hw, peak=FP32_FLOPS)
        pms = time_ms(plain, 1, 0) if case == "train" else None
        print(f"  {name:18s} {case:10s} norm-wise rel err "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f" (limit {REC_REL}), max abs {max_abs:.3e}  kernel "
              f"{ms:.4f} ms (device {dms:.4f}, {nbytes / dms / 1e9:.2f} TB/s"
              f", {nops / dms / 1e9:.2f} TFLOP/s, {bnd / dms:.1%} of the "
              f"bound)  plain " + (f"{pms:.4f} ms" if pms else "not timed")
              + f"  bound {bnd:.4f} ms ({by}, bf16 peak; at fp32 "
              f"{b32:.4f} ms ({by32}); {nbytes} bytes, {nops} operations)"
              + vs_floor(dms, bnd), flush=True)
        if case == "train":
            print(f"  {name:18s} {case:10s} device time by CUDA kernel: "
                  + ", ".join(f"{k} {v:.4f} ms ({v / sum(split.values()):.1%})"
                              for k, v in split.items()), flush=True)
            rows[name] = dict(case=case, ms=ms, device_ms=dms, plain_ms=pms,
                              library_ms=None, bound_ms=bnd, bound_by=by,
                              max_abs_err=max_abs)
        else:
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                            max_abs)

    _, _, h, hd = WKV_SHAPE
    u = rnd(h, hd, scale=0.5)
    for case, b, t, decay, states in WKV_BWD_CASES:
        r, k, v = (rnd(b, t, h, hd).to(bf) for _ in range(3))
        w = wkv_decay(decay, rnd(b, t, h, hd))
        dy = rnd(b, t, h, hd)
        s0 = rnd(b, h, hd, hd, scale=2.0) if states else None
        ds_t = rnd(b, h, hd, hd) if states else None
        args = (r, k, v, w, u, s0, dy, ds_t)
        names = ("dr", "dk", "dv", "dw", "du", "ds0")

        def kern(args=args, states=states):
            out = rwkv6_wkv_bwd(*args)
            return out if states else out[:5]

        def plain(args=args, states=states):
            out = ref.ref_rwkv6_bwd(*args)
            return out if states else out[:5]
        check("rwkv6_wkv_bwd", case, names, kern, plain,
              wkv_bwd_cost(b, t, h, hd, states))
        del r, k, v, w, dy, s0, ds_t, args
    _, _, h, p, n = SSD_SHAPE
    d_skip = torch.ones(h, device=dev)
    for case, b, t, a_top, dt_scale, dt_shift, states in SSD_BWD_CASES:
        a_log = torch.log(torch.linspace(1.0, 16.0, h, device=dev)) \
            if a_top is None else torch.full((h,), math.log(a_top),
                                             device=dev)
        xbc = rnd(b, t, h * p + 2 * n).to(bf)
        x = xbc[..., :h * p].reshape(b, t, h, p)
        bb, cc = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
        dt = (rnd(b, t, h) * dt_scale + dt_shift).to(bf)
        dy = rnd(b, t, h, p)
        h0 = rnd(b, h, p, n) if states else None
        dh_t = rnd(b, h, p, n) if states else None
        args = (x, dt, a_log, bb, cc, d_skip, h0, dy, dh_t)
        names = ("dx", "ddt", "da_log", "db", "dc", "dd", "dh0")

        def kern(args=args, states=states):
            out = ssd_scan_bwd(*args)
            return out if states else out[:6]

        def plain(args=args, states=states):
            out = ref.ref_ssd_bwd(*args)
            return out if states else out[:6]
        check("ssd_scan_bwd", case, names, kern, plain,
              ssd_bwd_cost(b, t, h, p, n, states))
        del xbc, x, bb, cc, dt, dy, h0, dh_t, args
    phase1_mma_forms(dev, gen)
    return rows


# the gradient kernel's products a head, in 64 x 64 x 64 products of a bf16
# pair by bf16 (csrc/ssd_bwd.cu's ssd_bwd_grad_kernel): over the causal half
# DX, dS B, DX^T, dS^T C (one each) and M^T dy (1.5: pair by pair); whole
# dy h (1.5), B G^T and x G (one each)
GRAD_CAUSAL, GRAD_WHOLE = 5.5, 3.5


def phase1_mma_forms(dev, gen) -> None:
    """csrc/mma_forms.cu's four forms of a 64 x 64 x 64 product (an fp32 A
    as its bf16 pair in registers, a bf16 B in shared memory): mma.sync
    over every column tile (0), mma.sync over the causal half (the two
    orientations by turns), its bounds tested at run time as
    ssd_bwd_grad_kernel does (1) or known when compiled (3), wgmma_rs over
    the whole product (2).  Each is held against the plain product
    norm-wise within REC_REL (one block, two turns), then timed by device
    time at ssd_bwd_grad_kernel's grid and occupancy at the training shape:
    1024 blocks (32 chunks x 8 head groups x 4) of 128 threads, two an SM,
    each block forming the 8 heads' 8 (GRAD_CAUSAL + GRAD_WHOLE) = 72
    products.  Prints each form's time and the gradient kernel's product
    mix on mma.sync (its causal share on form 1, or 3) against the same
    products on wgmma (all whole)."""
    import torch
    from repro_torch.kernels import _build
    if "mma_forms" not in _build.SOURCES:
        print("  mma forms: this tree has no csrc/mma_forms.cu", flush=True)
        return
    lib = _build.lib("mma_forms")
    a = torch.randn(64, 64, generator=gen, device=dev)
    b = torch.randn(64, 64, generator=gen, device=dev).to(torch.bfloat16)
    out = torch.empty(64, 64, device=dev)

    def run(form, blocks, reps):
        _build.check(lib.mma_forms(_build.ptr(a), _build.ptr(b),
                                   _build.ptr(out), form, blocks, reps,
                                   _build.stream(a)), "mma_forms")
    plain = a.double() @ b.double()
    # two turns: every form but the causal one sums each product twice; the
    # causal one's turn 0 reaches the column tiles jj <= w of warp w's rows,
    # turn 1 those with jj >= w
    w = torch.arange(64, device=dev) // 16
    reach = (w[None, :] <= w[:, None]).double() + \
        (w[None, :] >= w[:, None]).double()
    errs = {}
    for form, times in ((0, 2.0), (1, reach), (2, 2.0), (3, reach)):
        run(form, 1, 2)
        errs[form] = rel_err(out.double(), plain * times)
    if not max(errs.values()) <= REC_REL:
        raise AssertionError(f"mma_forms: norm-wise rel err {errs} > "
                             f"{REC_REL}")
    blocks, reps = 32 * 8 * 4, int(8 * (GRAD_CAUSAL + GRAD_WHOLE))
    ms = {form: device_ms(lambda form=form: run(form, blocks, reps), 5)
          for form in range(4)}
    flops = blocks * reps * 2 * 64 ** 3 * 2
    def mix(causal):
        return (GRAD_CAUSAL * ms[causal] + GRAD_WHOLE * ms[0]) / \
            (GRAD_CAUSAL + GRAD_WHOLE)
    print(f"  mma forms (csrc/mma_forms.cu, {blocks} blocks x {reps} "
          f"64 x 64 x 64 products of a bf16 pair, two blocks an SM): "
          f"mma.sync {ms[0]:.4f} ms ({flops / ms[0] / 1e9:.1f} TFLOP/s), "
          f"causal half {ms[1]:.4f} ms (bounds known when compiled "
          f"{ms[3]:.4f}), wgmma_rs {ms[2]:.4f} ms "
          f"({flops / ms[2] / 1e9:.1f} TFLOP/s); ssd_bwd_grad_kernel's "
          f"product mix ({GRAD_CAUSAL} causal + {GRAD_WHOLE} whole a head) "
          f"on mma.sync {mix(1):.4f} ms ({mix(3):.4f}), on wgmma "
          f"{ms[2]:.4f} ms; norm-wise rel err "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f" (limit {REC_REL})", flush=True)


# ---------------------------------------------------------------------------
# phase 2: the serve path end to end
# ---------------------------------------------------------------------------

def profile_busy(step, what: str, watch: str = "") -> float:
    """Run ``step`` once more (after one unprofiled run) under
    torch.profiler; print its host wall time, the card's busy time (kernel
    time summed) and share, the top kernels and, with ``watch``, the time
    and launches of the kernels whose name holds it.  Returns the busy
    share."""
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
    if watch:
        hits = [e for e in kern if watch in e.key]
        us = sum(e.self_device_time_total for e in hits)
        print(f"    {watch} kernels: {us / 1e3:.3f} ms device over "
              f"{sum(e.count for e in hits)} launches "
              f"({100 * us / max(dev_us, 1e-9):.1f}% of busy)", flush=True)
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
def tap_layers(log: list, module=None):
    """Record every ``serve_moe_layer`` call the server makes (or, with
    ``module``, that module makes), with its arguments, its outputs and
    its routing's per-choice drop mask [T, k], in ``log``."""
    from repro_torch.core import serving
    if module is None:
        from repro_torch.runtime import server as module
    real, real_route = module.serve_moe_layer, serving._route

    def tapped(x, params, cfg, plan, **kw):
        seen = []

        def route(*a, **k):
            out = real_route(*a, **k)
            seen.append(out[2])
            return out
        serving._route = route
        try:
            out = real(x, params, cfg, plan, **kw)
        finally:
            serving._route = real_route
        log.append((x, params, cfg, plan, kw, out, seen[0]))
        return out
    module.serve_moe_layer = tapped
    try:
        yield log
    finally:
        module.serve_moe_layer = real


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
    z = logits.float()
    u = torch.exp2(torch.floor(torch.log2(z.abs().clamp_min(2.0 ** -126)))
                   - 7)
    dp, pair, gap = shift_bounds(probs.float(), u, k)
    return PROB_MARGIN + dp, PROB_MARGIN + pair, gap


def shift_bounds(p, u, k: int):
    """First-order bounds for probabilities p [T, E] whose logits move by at
    most u [T, E] each: (the bound on each probability [T, E], on the gap
    between the k-th and (k+1)-th largest [T], that gap [T]); with k = E
    the gap is +inf."""
    import torch
    pu = p * u
    dp = p * (u * (1 - p) + pu.sum(-1, keepdim=True) - pu)
    if k >= p.shape[-1]:
        inf = torch.full(p.shape[:-1], float("inf"), device=p.device)
        return dp, torch.zeros_like(inf), inf
    srt, order = torch.sort(p, dim=-1, descending=True)
    pair = dp.gather(-1, order[:, k - 1:k + 1]).sum(-1)
    return dp, pair, srt[:, k - 1] - srt[:, k]


def rounded_logits(x, router):
    """The router logits of a bf16 product as the exact sum rounded to bf16
    (float64 sums: the bf16 products are exact, and D terms lose nothing
    near a bf16 ulp), and each logit's flip: the bf16 step across the
    nearest rounding boundary where the kernel's fp32 sum may land on its
    other side, else 0.  The kernel adds the products in k16 steps in
    ascending k, over the whole of D or, split over 2-8 CTAs, over
    contiguous ranges of steps whose sums it adds in order.  Each addition
    is taken to err by at most four fp32 ulps (2^-22) of the largest
    partial sum of any of those orders (or of a step's absolute sum), so
    the sum errs by at most D / 16 + 12 times that.  Returns (logits
    [T, E] bf16, flips [T, E] f32)."""
    import torch
    import torch.nn.functional as F
    t, d = x.shape
    nk = -(-d // 16)
    xs = F.pad(x.double(), (0, nk * 16 - d)).view(t, nk, 16).transpose(0, 1)
    rs = F.pad(router.double(), (0, 0, 0, nk * 16 - d)).view(nk, 16, -1)
    chunk = torch.bmm(xs, rs)                           # [nk, T, E]
    big = torch.bmm(xs.abs(), rs.abs()).amax(0)
    for splits in (1, 2, 4, 8):
        steps = -(-nk // 4)                             # 64-deep stages
        if splits > steps:
            break
        parts = []
        for r in range(splits):
            lo = r * steps // splits * 4
            hi = min((r + 1) * steps // splits * 4, nk)
            big = torch.maximum(big, chunk[lo:hi].cumsum(0).abs().amax(0))
            parts.append(chunk[lo:hi].sum(0))
        big = torch.maximum(big, torch.stack(parts).cumsum(0).abs()
                            .amax(0))
    z = chunk.sum(0)
    del chunk
    reach = (nk + 12) * 2.0 ** -22 * big
    zb = z.to(torch.bfloat16)
    zd = zb.double()
    bits = zb.view(torch.int16)
    away = (bits + 1).view(torch.bfloat16).double()     # one step from 0
    toward = (bits - 1).view(torch.bfloat16).double()
    dist = torch.minimum((z - (zd + away) / 2).abs(),
                         (z - (zd + toward) / 2).abs())
    flip = torch.where((dist <= reach) & (zd != 0), (away - zd).abs(),
                       torch.zeros_like(zd))
    return zb, flip.float()


def check_gating(case, x, router, k, got, tie=False) -> float:
    """Hold one gating call (idx, w, probs) against ``ref_topk_gating`` on
    the exactly rounded logits: probabilities within PROB_MARGIN, plus, on
    a logit that an fp32 sum may round the other way, what that flip moves
    them (``shift_bounds``); ids on the rows whose top-k gap clears
    PROB_MARGIN and that bound (with ``tie``: on every row); weights within
    PROB_MARGIN and their flips' bound there.  Returns the largest
    probability error."""
    import torch
    from repro_torch.kernels import ref
    idx, w, probs = got
    zb, flip = rounded_logits(x, router)
    ridx, rw, rprobs = ref.ref_topk_gating(zb, k)
    dp, pair, gap = shift_bounds(rprobs, flip, k)
    perr = (probs - rprobs).abs()
    over = perr - PROB_MARGIN - dp
    if bool((over > 0).any()):
        raise AssertionError(f"gating {case}: probs err {perr.max().item()}"
                             f" ({int((over > 0).sum())} beyond the bound)")
    clear = torch.ones_like(gap, dtype=torch.bool) if tie \
        else gap > PROB_MARGIN + pair
    if not torch.equal(idx[clear], ridx[clear]):
        raise AssertionError(f"gating {case}: expert ids differ")
    fs = flip.gather(-1, ridx.long())
    wu = rw * fs
    dw = rw * (fs * (1 - rw) + wu.sum(-1, keepdim=True) - wu)
    if bool(((w - rw).abs() - PROB_MARGIN - dw)[clear].gt(0).any()):
        raise AssertionError(f"gating {case}: weights err "
                             f"{(w - rw)[clear].abs().max().item()}")
    t, e = probs.shape
    print(f"  gating {case} ({t} x {x.shape[1]}, E {e}, k {k}): "
          f"{t - int(clear.sum())} of {t} rows within the top-k margin"
          + (" (ids held on all)" if tie else "")
          + f"; {int((flip > 0).sum())} of {t * e} logits within an fp32 "
          f"sum's reach of a bf16 rounding boundary; max probs err "
          f"{perr.max().item():.3e}", flush=True)
    return perr.max().item()


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
    for li, (x, params, mcfg, plan, kw, (yk, ik, pk), _) in \
            enumerate(calls):
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
    x, _, _, _, kw, _, _ = calls[0]
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
    flipped = torch.zeros(b, s, dtype=torch.bool, device=device)
    report, worst, worst_drop = [], 0.0, 0.0
    for li, (kc, pc) in enumerate(zip(kcalls, pcalls)):
        xk, xp = kc[0].float(), pc[0].float()
        ik, ip = kc[5][1], pc[5][1]
        clean = ~dirty.reshape(-1)
        drift = (xk - xp).norm(dim=-1) / xp.norm(dim=-1)
        if clean.any():
            worst = max(worst, drift[clean].max().item())
        by_drop = (dirty & ~flipped).reshape(-1)
        if by_drop.any():
            worst_drop = max(worst_drop, drift[by_drop].max().item())
        if clean.any() and drift[clean].max().item() > DRIFT_REL:
            raise AssertionError(
                f"{what} layer {li}: clean tokens drifted "
                f"{drift[clean].max().item():.3e} > {DRIFT_REL}")
        flip = (ik != ip).any(-1)
        drop = (kc[6] != pc[6]).any(-1)
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
                      f"{int((flip & ~clean).sum())}"
                      f"/{int((drop & ~flip & clean).sum())}d")
        event = (flip | drop).reshape(b, s)
        own |= event
        dirty |= torch.cummax(event.int(), dim=1).values.bool()
        flipped |= torch.cummax(flip.reshape(b, s).int(), dim=1).values \
            .bool()
        del xk, xp, drift, lp
    print(f"{tag}: {what} ({b} x {s} tokens): gate ids that differ per "
          f"layer, at clean + at already-diverged tokens / clean tokens whose "
          f"drops alone differ: {' '.join(report)};"
          f" max clean drift {worst:.3e} (limit {DRIFT_REL}); max drift "
          f"where only drops differed before {worst_drop:.3e}", flush=True)
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


def print_spans(tracer, tag: str) -> None:
    """Where the host wall time of the served layers went: each server
    span's count and total ms (the "gate" span holds the device->host copy
    that waits for the card)."""
    spans = {}
    for root in tracer.roots:
        for sp in root.walk():
            if sp.name in ("server.layer", "phase1.estimate", "gate",
                           "plan.lookup", "plan.build", "phase2.finetune",
                           "dispatch"):
                n, tot = spans.get(sp.name, (0, 0.0))
                spans[sp.name] = (n + 1, tot + sp.duration)
    print(f"{tag} host spans (count, total ms): " + json.dumps(
        {k: [n, round(t * 1e3, 3)] for k, (n, t) in spans.items()}),
        flush=True)


# phase 2's summary, kept for phase 8's comparison
PHASE2: dict = {}
SERVE_ARGV = ["--arch", "gpt2-moe", "--requests", "8", "--seq", "64",
              "--max-new-tokens", "8"]


def phase2(dev) -> dict:
    import numpy as np
    import torch
    from repro_torch.kernels import COUNTERS, reset_counters
    from repro_torch.launch import serve

    argv = SERVE_ARGV + ["--device", str(dev),
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
    PHASE2.update(m)
    print(f"phase 2: latency p50 {m['latency_p50'] * 1e3:.3f} ms p95 "
          f"{m['latency_p95'] * 1e3:.3f} ms  TTFT p50 "
          f"{m['ttft_p50'] * 1e3:.3f} ms p95 {m['ttft_p95'] * 1e3:.3f} ms  "
          f"TPOT p50 {m['tpot_p50'] * 1e3:.3f} ms p95 "
          f"{m['tpot_p95'] * 1e3:.3f} ms  {m['gen_tok_s']:.3f} gen tok/s  "
          f"plan reuse {engine.plan_reuse_rate:.4f}  fine-tune rate "
          f"{engine.finetune_rate:.4f}", flush=True)

    print_spans(out["obs"].tracer, "phase 2")

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
# phase 9: llama4-maverick served at full width
# ---------------------------------------------------------------------------

L4_LAYERS = 2              # depth cut: one dense block and one MoE block
L4_PROFILE = (2, 2, 2048)  # profiling batches, rows, tokens
L4_GEN = (4, 2048, 16)     # requests, prompt tokens, new tokens


@contextlib.contextmanager
def plain_ffn_by_slot_block():
    """For the duration, the plain route's expert FFN
    (``core.serving._ffn_in_place``) runs over blocks of slots whose
    gathered weights stay within GATHER_MAX, as ``ffn_plain`` does: the
    same function (a slot's rows meet only its hosted expert's weights;
    the blocks are cut on the slot dim and put back in order), with at most
    one block's weights gathered.  At llama4's 512 slots the whole gather
    would be 3 x 512 x 5120 x 8192 x 2 B = 129 GB.  The kernel route is
    untouched."""
    import torch
    from repro_torch.core import serving
    real = serving._ffn_in_place

    def blocked(params, toks, hosted, group_rows, ffn_type, backend):
        if backend == "pallas":
            return real(params, toks, hosted, group_rows, ffn_type, backend)
        n = gather_block(params.wi, params.wu, params.wo)
        return torch.cat([real(params, toks[i:i + n], hosted[i:i + n], None,
                               ffn_type, backend)
                          for i in range(0, hosted.shape[0], n)])
    serving._ffn_in_place = blocked
    try:
        yield
    finally:
        serving._ffn_in_place = real


def phase9(dev) -> dict:
    """llama4-maverick-400b-a17b at full width and depth 2 (a dense block
    and an MoE block of 128 experts, top-1, with the shared expert; bf16
    parameters), random weights from a seed, served through the port's
    ``MoEServer`` and ``ServingEngine`` at ``ServerConfig`` defaults (512
    slots) on the kernel route: profiling on L4_PROFILE, then L4_GEN
    requests.  Counters zeroed just before and read just after: every
    serve-path kernel and ``flash_attention`` must launch.  Prints TTFT,
    TPOT, tokens/s, peak memory (while initialising, and while serving),
    the server's host spans, each kernel's launches in a prefill and a
    decode step, the card's busy share of each, and replays the MoE layer call of a prefill and a decode
    step through the plain route on the same input, plan, cap and
    slot_cap, its FFN slot block by slot block
    (``plain_ffn_by_slot_block``)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import COUNTERS, reset_counters
    from repro_torch.models import lm as lm_mod
    from repro_torch.obs import ObsContext
    from repro_torch.runtime.engine import (ServingEngine, simulate,
                                            summarize_results)
    from repro_torch.runtime.server import (MoEServer, ServerConfig,
                                            profile_from_training)
    from repro_torch.tree import tree_leaves
    t_start = time.perf_counter()
    cfg = dataclasses.replace(get_config("llama4-maverick-400b-a17b"),
                              n_layers=L4_LAYERS)
    n_prof, rows, seq = L4_PROFILE
    n_gen, gen_len, new_tok = L4_GEN
    gc.collect()                  # the earlier phases' tensors
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = lm_mod.init_params(cfg, gen, device=dev)
    n_params = sum(p.numel() for p in tree_leaves(params))
    torch.cuda.synchronize(dev)
    print(f"phase 9: {cfg.name} at depth {cfg.n_layers} (a dense block of "
          f"{cfg.d_ff} and an MoE block: d {cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads, hd {cfg.head_dim}, "
          f"{cfg.moe.n_experts} {cfg.ffn_type} experts of {cfg.moe.d_ff}, "
          f"top-{cfg.moe.top_k}, shared expert {cfg.moe.shared_expert}, "
          f"vocab {cfg.vocab_size}, {cfg.param_dtype}): {n_params} params "
          f"({torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB), "
          f"initialised in {time.perf_counter() - t0:.2f} s; peak device "
          f"memory while initialising "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB",
          flush=True)
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                global_batch=rows, seed=0))
    rng = np.random.RandomState(13)
    trace = [(rng.randint(0, cfg.vocab_size, (gen_len,)), 0.05 * i)
             for i in range(n_gen)]
    obs = ObsContext.enabled()

    torch.cuda.reset_peak_memory_stats(dev)
    reset_counters()
    t0 = time.perf_counter()
    prof = profile_from_training(
        cfg, params, (ds.batch(i) for i in range(n_prof)), device=dev)
    t_prof = time.perf_counter() - t0
    srv = MoEServer(cfg, params, prof, ServerConfig(), obs=obs, device=dev)
    del params
    engine = ServingEngine(srv)
    with torch.inference_mode():
        res = simulate(engine, trace, max_new_tokens=new_tok)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = {n: c.count for n, c in COUNTERS.items()}
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    n_slots = len(engine.layer_stats[-1].replica_load)
    print(f"phase 9: profiled ({n_prof} x {rows} x {seq} tokens, "
          f"{t_prof:.2f} s) and served on {srv.n_dev} devices x "
          f"{srv.scfg.max_pack} = {n_slots} slots in {wall:.2f} s wall; "
          f"peak device memory {peak:.2f} GiB", flush=True)
    print("phase 9 launches: " + json.dumps(launches), flush=True)
    if n_slots != cfg.moe.n_experts * ServerConfig().max_pack:
        raise AssertionError(f"phase 9: {n_slots} slots")
    missing = [n for n, c in launches.items()
               if c == 0 and n not in TRAIN_ONLY | RECURRENT]
    if missing:
        raise AssertionError(f"kernels never launched serving {cfg.name}: "
                             f"{missing}")
    for r in res:
        if not np.isfinite(r.logits).all() or r.logits.shape != \
                (cfg.vocab_size,):
            raise AssertionError(f"request {r.rid}: bad logits")
        if r.tokens is None or r.tokens.shape != (new_tok,) or \
                r.tokens.min() < 0 or r.tokens.max() >= cfg.vocab_size:
            raise AssertionError(f"request {r.rid}: bad tokens")
    if len(res) != n_gen:
        raise AssertionError("phase 9: requests missing")
    m = summarize_results(res)
    print(f"phase 9: {n_gen} requests x {gen_len} prompt + {new_tok} new "
          f"tokens: TTFT p50 {m['ttft_p50'] * 1e3:.3f} ms p95 "
          f"{m['ttft_p95'] * 1e3:.3f} ms  TPOT p50 {m['tpot_p50'] * 1e3:.3f} "
          f"ms p95 {m['tpot_p95'] * 1e3:.3f} ms  {m['gen_tok_s']:.3f} gen "
          f"tok/s  latency p50 {m['latency_p50'] * 1e3:.3f} ms; plan reuse "
          f"{engine.plan_reuse_rate:.4f}  fine-tune rate "
          f"{engine.finetune_rate:.4f}", flush=True)
    print_spans(obs.tracer, "phase 9")

    toks = np.random.RandomState(7).randint(0, cfg.vocab_size, (2, gen_len))
    # each kernel's launches in one prefill and one decode step (not the
    # counted run's)
    def launched():
        return {n: c.count for n, c in COUNTERS.items() if c.count}
    with torch.inference_mode():
        reset_counters()
        pre = srv.prefill_batch(toks, cache_len=gen_len + 8)
        per_prefill = launched()
        reset_counters()
        srv.decode_batch(pre.logits.argmax(-1), pre.cache,
                         pre.path_ids[:, -1])
        per_step = launched()
    print(f"phase 9 launches a prefill of 2 x {gen_len} / a decode step: "
          f"{json.dumps(per_prefill)} / {json.dumps(per_step)}", flush=True)
    device_busy(srv, toks, "phase 9", cache_len=gen_len + 8)
    with plain_ffn_by_slot_block():
        replay_prefill_decode(srv, toks, "phase 9")
    print(f"phase 9: {time.perf_counter() - t_start:.1f} s", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phases 5, 6 and 10: rwkv6-1.6b, zamba2-1.2b and the dense configs served
# at full width through the model entry points
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
# phase 10's dense configs, and the depth each is served at (None: full;
# qwen2-72b's 80 layers and granite-34b's 88 cut to 8, ~19 GB and ~7 GB of
# bf16 weights beside their fp32 masters)
DENSE_DEPTH = {"qwen3-8b": None, "qwen1.5-0.5b": None, "qwen2-72b": 8,
               "granite-34b": 8}
# phase 11's frontends: llava-next-34b's 60 layers cut to 8 (5.38 B
# parameters with patch_proj, ~32 GB as fp32 masters + the bf16 copy),
# hubert-xlarge at full depth (48 layers, 0.945 B)
FRONTEND_DEPTH = {"llava-next-34b": 8, "hubert-xlarge": None}
# kernel launches per prefill / per decode step of each model (a dense
# model's decode attention is the plain decode_attention)
MODEL_PATHS = {
    "rwkv6-1.6b": ({"rwkv6_wkv": 24}, {"rwkv6_wkv": 24}),
    "zamba2-1.2b": ({"ssd_scan": 38, "flash_attention": 6}, {}),
    "qwen3-8b": ({"flash_attention": 36}, {}),
    "qwen1.5-0.5b": ({"flash_attention": 24}, {}),
    "qwen2-72b": ({"flash_attention": 8}, {}),
    "granite-34b": ({"flash_attention": 8}, {}),
    "llava-next-34b": ({"flash_attention": 8}, {}),
    "hubert-xlarge": ({"flash_attention": 48}, {}),
}
# the kernel whose device time a profile picks out (csrc/rwkv6.cu's chunked
# and step-loop kernels; csrc/ssd.cu's; csrc/flash_attention.cu's)
WATCH_KERNEL = {"rwkv6-1.6b": "wkv_", "zamba2-1.2b": "ssd_kernel",
                **{arch: "flash_kernel"
                   for arch in (*DENSE_DEPTH, *FRONTEND_DEPTH)}}


def replay_hooks(arch: str) -> list:
    """(module, op name, kernel, plain version, limit) of each kernel op
    the model of ``arch`` calls on the kernel route."""
    from repro_torch.kernels import ref
    from repro_torch.models import attention, rwkv, ssm
    flash = (attention, "flash_attention_op", "flash_attention",
             plain_attention, FLASH_REL)
    if arch.startswith("rwkv6"):
        return [(rwkv, "rwkv6_op", "rwkv6_wkv", ref.ref_rwkv6, REC_REL)]
    if arch in DENSE_DEPTH or arch in FRONTEND_DEPTH:
        return [flash]
    return [(ssm, "ssd_op", "ssd_scan", ref.ref_ssd, REC_REL), flash]


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


def served_inputs(cfg, dev, rng):
    """(inputs(rows, n, prefix) -> the ``forward_prefill`` batch of ``rows``
    requests of ``n`` positions past the prefix, the decode prompt tokens
    [B, DECODE_PROMPT] or None, the text positions of the main prefill).
    A token model's batch is ``tokens``; hubert's (``audio_stub``) is
    ``frames`` [B, n, FRAME_DIM] of synthetic features; llava's
    (``vision_stub``) is ``tokens`` after ``patches`` [B, 576, d] of
    synthetic patch embeddings (``prefix`` False: no patches, so that the
    token-only decode can be held to the prefill)."""
    import numpy as np
    import torch
    from repro_torch.models import lm
    b, s = SERVE_PROMPT
    if cfg.frontend == "audio_stub":
        frames = torch.as_tensor(
            rng.randn(b, s, lm.FRAME_DIM).astype(np.float32), device=dev)
        return (lambda rows, n, prefix=True:
                {"frames": frames[:rows, :n]}), None, s
    toks = torch.as_tensor(rng.randint(0, cfg.vocab_size, (b, s)),
                           device=dev)
    if cfg.frontend != "vision_stub":
        return (lambda rows, n, prefix=True:
                {"tokens": toks[:rows, :n]}), toks[:, :DECODE_PROMPT], s
    patches = torch.randn(b, cfg.n_patches, cfg.d_model, device=dev,
                          generator=torch.Generator(device=dev)
                          .manual_seed(6))

    def inputs(rows, n, prefix=True):
        return {"tokens": toks[:rows, :n],
                "patches": patches[:rows, :cfg.n_patches if prefix else 0]}
    return inputs, toks[:, :DECODE_PROMPT], s - cfg.n_patches


def phase_served(dev, arch: str, tag: str, depth=None) -> dict:
    """``arch`` at full width and depth (``depth`` layers if given), random
    weights from a seed, on the card, through the port's model entry
    points (``models.lm``): counters
    zeroed, ``forward_prefill`` of 4 x 2048 prompt positions (llava: 576
    synthetic patches + 1472 tokens; hubert: 2048 synthetic frames), then
    ``init_cache`` + ``decode_step`` over a 64-token prompt fed one token
    at a time and 32 greedy new tokens (none for hubert, an encoder);
    counters read, and each kernel's
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
    if depth:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    per_prefill, per_step = MODEL_PATHS[arch]
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
    layout = f"{cfg.ssm}, pattern {cfg.layer_pattern or 'none'}" \
        if cfg.ssm.enabled else \
        (f"{cfg.n_heads}/{cfg.n_kv_heads} heads, hd "
         f"{cfg.resolved_head_dim}, {cfg.ffn_type} FFN of {cfg.d_ff}, "
         f"qk_norm {cfg.qk_norm}, qkv_bias {cfg.qkv_bias}, tied "
         f"{cfg.tie_embeddings}")
    print(f"{tag}: {cfg.name} at "
          + (f"depth {depth} (cut)" if depth else "full depth")
          + f" ({cfg.n_layers} layers, d {cfg.d_model}, {layout}, vocab "
          f"{cfg.vocab_size}): {n_params} params, fp32 masters + the bf16 "
          f"copy initialised in {time.perf_counter() - t0:.2f} s", flush=True)
    b, s = SERVE_PROMPT
    rng = np.random.RandomState(5)
    inputs, prompt, n_text = served_inputs(cfg, dev, rng)
    full = inputs(b, n_text)
    n_steps = DECODE_PROMPT + DECODE_NEW if prompt is not None else 0

    def prefill(c, batch, pp=None):
        return lm.forward_prefill(c, cparams if pp is None else pp,
                                  batch).logits

    with torch.inference_mode():
        prefill(cfg, inputs(b, DECODE_PROMPT))        # warm-up
        torch.cuda.synchronize(dev)
        reset_counters()
        t0 = time.perf_counter()
        logits = prefill(cfg, full)
        torch.cuda.synchronize(dev)
        pre_wall = time.perf_counter() - t0
        pre_launch = {n: c.count for n, c in COUNTERS.items()}
        step_s, new_tokens = [], []
        at_prompt = logits
        if n_steps:
            cache = lm.init_cache(cfg, b, n_steps, lm.DTYPES[cfg.dtype],
                                  device=dev)
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
        if not (torch.isfinite(logits).all() and logits.shape ==
                (b, cfg.vocab_size) and torch.isfinite(at_prompt).all()):
            raise AssertionError(f"{tag}: logits not finite / mis-shaped")
        what = f"{b} x {s} positions" + (
            f" ({cfg.n_patches} patches + {n_text} tokens)"
            if cfg.frontend == "vision_stub" else
            f" (frames of {lm.FRAME_DIM})" if cfg.frontend == "audio_stub"
            else "")
        print(f"{tag}: prefill {what} in {pre_wall * 1e3:.3f} ms wall "
              f"({b * s / pre_wall:.1f} positions/s); peak device memory "
              f"{peak:.2f} GiB", flush=True)
        if n_steps:
            gen_toks = torch.stack(new_tokens, dim=1)
            if gen_toks.shape != (b, DECODE_NEW) or gen_toks.min() < 0 or \
                    gen_toks.max() >= cfg.vocab_size:
                raise AssertionError(f"{tag}: bad generated tokens")
            st = np.array(step_s) * 1e3
            gen_s = float(np.sum(step_s[DECODE_PROMPT:]))
            print(f"{tag}: decode step (batch {b}) p50 "
                  f"{np.percentile(st, 50):.3f} ms p95 "
                  f"{np.percentile(st, 95):.3f} ms over {n_steps} steps; "
                  f"{b * DECODE_NEW / gen_s:.3f} generated tokens/s",
                  flush=True)
        else:
            print(f"{tag}: {cfg.name} is an encoder (causal=False): no "
                  f"decode", flush=True)

        profile_busy(lambda: prefill(cfg, full),
                     f"{tag} prefill {b} x {s} under the profiler",
                     WATCH_KERNEL[arch])
        if n_steps:
            profile_busy(lambda: lm.decode_step(cfg, cparams, cache, tok),
                         f"{tag} decode step under the profiler",
                         WATCH_KERNEL[arch])

        # every kernel call of one prefill and one decode step (from the
        # state after the decode run) against its plain version, layer by
        # layer, on the tensors the model passes it
        hooks = replay_hooks(arch)
        replay_kernel_calls(tag, f"prefill {b} x {s}",
                            lambda: prefill(cfg, full), hooks, per_prefill)
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
        routes = {"kernel bf16": (cfg, cparams),
                  "plain bf16": (plain_cfg, cparams),
                  "plain fp32": (f32_cfg, params)}
        got, walls = {}, {}
        pre_key = f"prefill@{DECODE_PROMPT}"
        dec_key = f"decode@{DECODE_PROMPT}"
        for name, (c, pp) in routes.items():
            got[name] = {pre_key: prefill(c, inputs(b, DECODE_PROMPT, False),
                                          pp).float()}
            if n_steps:
                dcache = lm.init_cache(c, b, DECODE_PROMPT,
                                       lm.DTYPES[c.dtype], device=dev)
                for i in range(DECODE_PROMPT):
                    dec, dcache, _ = lm.decode_step(c, pp, dcache,
                                                    prompt[:, i])
                got[name][dec_key] = dec.float()
                del dcache
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            long_pre = prefill(c, inputs(pb, ps), pp)
            torch.cuda.synchronize(dev)
            walls[name] = time.perf_counter() - t0
            got[name][f"prefill@{ps}"] = long_pre.float()
        if not all(torch.isfinite(v).all() for g in got.values()
                   for v in g.values()):
            raise AssertionError(f"{tag}: non-finite logits")

        def fmt(rel):
            return [float(f"{r:.3e}") for r in rel]
        for name in routes if n_steps else ():
            rel = row_rel(got[name][dec_key], got[name][pre_key])
            print(f"{tag}: {name}: decode logits after {DECODE_PROMPT} "
                  f"one-token steps vs forward_prefill of the {DECODE_PROMPT}"
                  f" tokens, norm-wise per row {fmt(rel)}"
                  + (f" (limit {FP32_DECODE_REL})" if name == "plain fp32"
                     else " (not held: bf16)"), flush=True)
        if n_steps:
            rel = row_rel(got["plain fp32"][dec_key],
                          got["plain fp32"][pre_key])
            if max(rel) > FP32_DECODE_REL:
                raise AssertionError(f"{tag}: decode does not match "
                                     f"prefill")
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
        print(f"{tag}: prefill of {pb} x {ps} positions"
              + (f" after {cfg.n_patches} patches"
                 if cfg.frontend == "vision_stub" else "")
              + ", wall: " + ", ".join(
            f"{n} {w * 1e3:.3f} ms" for n, w in walls.items()), flush=True)
    return launches


def phase10(dev) -> dict:
    """The four dense configs served at full width (DENSE_DEPTH: two at
    full depth, two cut to 8 layers), each by ``phase_served``: a 4 x 2048
    prefill whose every ``flash_attention`` call (one a layer) is replayed
    against its plain version, the decode steps, and the plain route in
    float32 and bf16 against the kernel route.  Returns the launches
    summed over the four."""
    t_start = time.perf_counter()
    launches = {}
    for arch, depth in DENSE_DEPTH.items():
        t0 = time.perf_counter()
        for name, n in phase_served(dev, arch, "phase 10", depth).items():
            launches[name] = launches.get(name, 0) + n
        print(f"phase 10: {arch}: {time.perf_counter() - t0:.1f} s",
              flush=True)
    print(f"phase 10: {time.perf_counter() - t_start:.1f} s", flush=True)
    return launches


def phase11(dev) -> dict:
    """The two modality frontends served at full width (FRONTEND_DEPTH:
    llava-next-34b cut to 8 layers, hubert-xlarge at full depth), each by
    ``phase_served``: llava's prefill of 576 synthetic patches + 1472
    tokens (flash at 56 / 8 heads, hd 128, causal) and its token-only
    decode; hubert's encoder forward over 2048 synthetic frames (flash at
    hd 80, bidirectional), no decode; every flash call of a prefill
    replayed against its plain version, and the plain route in float32 and
    bf16 against the kernel route.  Returns the launches summed."""
    t_start = time.perf_counter()
    launches = {}
    for arch, depth in FRONTEND_DEPTH.items():
        t0 = time.perf_counter()
        for name, n in phase_served(dev, arch, "phase 11", depth).items():
            launches[name] = launches.get(name, 0) + n
        print(f"phase 11: {arch}: {time.perf_counter() - t0:.1f} s",
              flush=True)
    print(f"phase 11: {time.perf_counter() - t_start:.1f} s", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 12: the serving control loop (sched / resilience / obs) on gpt2-moe
# ---------------------------------------------------------------------------

CTRL_PROMPTS = (4, 48, 8)     # requests, prompt tokens, new tokens
CTRL_ARGV = ["--arch", "gpt2-moe", "--requests", "16", "--seq", "64",
             "--max-new-tokens", "8", "--workload", "drift"]


def ctrl_server(dev, cfg, params):
    """A ``MoEServer`` of gpt2-moe on ``params`` with an empty path profile
    (path length 2, the lina policy), as the reference's engine tests."""
    from repro_torch.core.popularity import PathProfile
    from repro_torch.runtime.server import MoEServer, ServerConfig
    prof = PathProfile(n_layers=cfg.n_moe_layers,
                       n_experts=cfg.moe.n_experts, path_len=2)
    return MoEServer(cfg, params, prof,
                     ServerConfig(path_len=2, schedule_policy="lina"),
                     device=dev)


def ctrl_run(srv, prompts, new: int, scheduler=None, on_step=None):
    """Serve ``prompts`` through a ``ServingEngine`` on the virtual clock
    (``now=0``), one ``step`` at a time, calling ``on_step(engine)`` after
    each; returns ({rid: generated tokens}, engine)."""
    from repro_torch.runtime.engine import EngineConfig, ServingEngine
    eng = ServingEngine(srv, EngineConfig(max_batch_tokens=256),
                        scheduler=scheduler)
    for p in prompts:
        eng.submit(p, arrival=0.0, max_new_tokens=new)
    results = []
    while eng.has_work():
        results.extend(eng.step(now=0.0))
        if on_step is not None:
            on_step(eng)
    return {r.rid: r.tokens.tolist() for r in results}, eng


def phase12_swaps(dev, cfg, params, prompts, new, static) -> None:
    """(a) An ``AdaptiveScheduler`` (interval 1, no hysteresis, no
    migration weight) publishing plans between micro-batches while the
    requests decode: the greedy tokens must be the static run's."""
    from repro_torch.sched import AdaptiveScheduler, ControllerConfig
    srv = ctrl_server(dev, cfg, params)
    sch = AdaptiveScheduler(srv, ControllerConfig(
        interval=1, min_swap_interval=1, min_observations=1,
        hysteresis=0.0, migration_weight=0.0))
    seen = {"published": 0, "mid_decode": 0, "swaps_mid_decode": 0}

    def watch(eng):
        ctl = sch.controller
        published = ctl.swaps + ctl.bootstraps
        if eng.active() and published > seen["published"]:
            seen["mid_decode"] += published - seen["published"]
            seen["swaps_mid_decode"] += ctl.swaps - seen.get("swaps", 0)
        seen["published"], seen["swaps"] = published, ctl.swaps
    got, eng = ctrl_run(srv, prompts, new, sch, watch)
    rep = sch.report()
    print(f"phase 12 (a): {rep['swaps']} swaps + {rep['bootstraps']} "
          f"bootstraps over {rep['steps']} engine steps; plans published "
          f"while requests decoded: {seen['mid_decode']} "
          f"({seen['swaps_mid_decode']} of them swaps of a live plan); "
          f"{len(srv._plan_override)} layers under controller plans; "
          f"tokens equal to the static run: {got == static}", flush=True)
    if not seen["mid_decode"] or not srv._plan_override:
        raise AssertionError("phase 12 (a): no plan was published while "
                             "requests decoded")
    if got != static:
        raise AssertionError(f"phase 12 (a): plan swaps changed the tokens:"
                             f" static {static}, scheduled {got}")
    post = list(eng.layer_stats)[-cfg.n_moe_layers:]
    if any(s.finetuned for s in post):
        raise AssertionError("phase 12 (a): a controller-owned layer ran "
                             "the phase-2 fine-tune")


def phase12_failure(dev, cfg, params, prompts, new, static) -> None:
    """(b) ``fail_devices({1})`` after the second decode step: the tokens
    must be the fault-free run's, and no realized load may land on
    placement device 1 afterwards."""
    import numpy as np
    srv = ctrl_server(dev, cfg, params)
    mark = {}

    def fail(eng):
        if eng.step_idx == 3 and eng.active():
            srv.fail_devices({1})
            mark["stats"] = len(eng.layer_stats)
    got, eng = ctrl_run(srv, prompts, new, on_step=fail)
    after = list(eng.layer_stats)[mark["stats"]:]
    on_dead = max(float(np.asarray(s.device_load)[1]) for s in after)
    print(f"phase 12 (b): device 1 failed after engine step 3 (mid "
          f"decode): {len(after)} layer stats after it, largest token share"
          f" on device 1 {on_dead}; degrade stats {srv.degrade_stats}; "
          f"tokens equal to the fault-free run: {got == static}",
          flush=True)
    if not after or on_dead != 0.0:
        raise AssertionError("phase 12 (b): load landed on the failed "
                             "device")
    if got != static:
        raise AssertionError(f"phase 12 (b): the failure changed the "
                             f"tokens: fault-free {static}, faulted {got}")


def imbalance(engine) -> float:
    """Mean over the served layer stats of max / mean device token share
    (the serve driver's load-imbalance line)."""
    import numpy as np
    loads = np.stack([s.device_load for s in engine.layer_stats])
    return float((loads.max(1) / np.maximum(loads.mean(1), 1e-9)).mean())


def phase12_driver(dev, src: Path) -> None:
    """(c) ``launch.serve`` on a drifting trace with ``--autoscale`` (the
    first such run's span trace exported, two of its engine steps under
    ``StepProfiler``), then ``python -m repro_torch.obs validate`` on the
    export (exit 0 or the phase fails), beside the same trace without
    ``--autoscale``: static, autoscaled, autoscaled, static, so that
    neither side is always the first on the card."""
    from repro_torch.launch import serve
    trace_dir = ROOT / "build" / "ctrl_trace"
    traced = ["--trace-dir", str(trace_dir), "--profile-steps", "2"]
    prof = None
    for i, name in enumerate(("static", "autoscaled", "autoscaled",
                              "static")):
        extra = ["--autoscale"] if name == "autoscaled" else []
        out = serve.run(CTRL_ARGV + ["--device", str(dev)] + extra
                        + (traced if i == 1 else []))
        m, eng, sch = out["summary"], out["engine"], out["scheduler"]
        if m["n"] != 16 or m["gen_tokens"] != 16 * 8:
            raise AssertionError(f"phase 12 (c) {name}: {m}")
        if i == 1:
            out["obs"].export(str(trace_dir))     # as serve.main does
            prof = out["profiler"]
        rep = sch.report() if sch is not None else None
        print(f"phase 12 (c) {name} ({i + 1} of 4): TTFT p50 "
              f"{m['ttft_p50'] * 1e3:.3f} ms  TPOT p50 "
              f"{m['tpot_p50'] * 1e3:.3f} ms  {m['gen_tok_s']:.3f} gen "
              f"tok/s  load imbalance {imbalance(eng):.4f}x  plan reuse "
              f"{eng.plan_reuse_rate:.4f}  fine-tune rate "
              f"{eng.finetune_rate:.4f}"
              + (f"  swaps {rep['swaps']} (+{rep['bootstraps']} "
                 f"bootstraps) over {rep['steps']} steps, churn "
                 f"{rep['churn_per_100_steps']:.3f} swaps / 100 steps, "
                 f"{sch.controller.migrated_slots} expert stacks moved"
                 if rep else ""), flush=True)
    times = prof.kernel_times()
    if not prof.session.cuda or not times:
        raise AssertionError("phase 12 (c): the StepProfiler capture saw "
                             "no device activity")
    print(f"phase 12 (c): StepProfiler capture of engine steps 2-3 "
          f"({prof.session.path}): {len(times)} kernels, device us: "
          + ", ".join(f"{k[:60]} {v:.1f}" for k, v in
                      list(times.items())[:10]), flush=True)
    env = dict(os.environ, PYTHONPATH=str(src))
    val = subprocess.run([sys.executable, "-m", "repro_torch.obs",
                          "validate", "--trace-dir", str(trace_dir),
                          "--require-requests", "16"], env=env,
                         capture_output=True, text=True, timeout=300)
    print(f"phase 12 (c): python -m repro_torch.obs validate: exit "
          f"{val.returncode}: {val.stdout.strip()[-400:]}", flush=True)
    if val.returncode != 0:
        raise AssertionError(f"phase 12 (c): the validator failed: "
                             f"{val.stdout} {val.stderr}")


def phase12(dev, src: Path) -> dict:
    """The serving control loop on gpt2-moe at full width and depth, kernel
    route (counters zeroed just before, read just after): (a) plan swaps
    mid-decode, (b) a device failure mid-decode, (c) the serve driver with
    ``--workload drift --autoscale`` and the trace validator.  Returns the
    launches."""
    import dataclasses as dc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import COUNTERS, reset_counters
    from repro_torch.models import lm
    t_start = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("gpt2-moe")
    # capacity factor 16: no token is dropped, so the tokens cannot depend
    # on which plan's capacity a token met
    cfg = dc.replace(cfg, moe=dc.replace(cfg.moe, capacity_factor=16.0))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = lm.init_params(cfg, gen, device=dev)
    n, length, new = CTRL_PROMPTS
    rng = np.random.RandomState(31)
    prompts = [rng.randint(0, cfg.vocab_size, (length,)) for _ in range(n)]
    reset_counters()
    with torch.inference_mode():
        static, _ = ctrl_run(ctrl_server(dev, cfg, params), prompts, new)
        print(f"phase 12: static run: {n} requests of {length} tokens x "
              f"{new} new tokens, capacity factor 16", flush=True)
        phase12_swaps(dev, cfg, params, prompts, new, static)
        phase12_failure(dev, cfg, params, prompts, new, static)
    del params
    phase12_driver(dev, src)
    torch.cuda.synchronize(dev)
    launches = {k: c.count for k, c in COUNTERS.items()}
    print("phase 12 launches: " + json.dumps(launches), flush=True)
    missing = [k for k, c in launches.items()
               if c == 0 and k not in TRAIN_ONLY | RECURRENT]
    if missing:
        raise AssertionError(f"phase 12: kernels never launched on the "
                             f"control loop's path: {missing}")
    print(f"phase 12: {time.perf_counter() - t_start:.1f} s", flush=True)
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
    # the kernel route's bits, to hold two trees' runs equal
    digest = hashlib.sha256()
    for a in (ko.expert_idx, ko.y, *kg):
        digest.update(a.detach().reshape(-1).view(torch.uint8).cpu()
                      .numpy().tobytes())
    print(f"phase 3 layer check digest (kernel route ids, y, dx, drouter, "
          f"dwi, dwo): sha256 {digest.hexdigest()[:32]}", flush=True)
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
        print("phase 3 losses bitwise (float.hex): "
              + " ".join(float(v).hex() for v in losses), flush=True)
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
        PHASE3.update(losses=losses, median=med, busy=dev_ms)
        print(f"phase 3 step under the profiler: wall {pwall * 1e3:.3f} ms, "
              f"device busy {dev_ms:.3f} ms = {100 * dev_ms / 1e3 / med:.1f}% "
              f"of the median step ({100 * dev_ms / 1e3 / pwall:.1f}% of "
              f"the profiled wall), {sum(e.count for e in kern)} kernels",
              flush=True)
        for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:12]:
            print(f"    {e.self_device_time_total / 1e3:9.3f} ms  "
                  f"x{e.count:<5d} {e.key[:90]}", flush=True)
        # the port's kernels of grouped_matmul, gating and row moves,
        # wherever they rank
        for e in kern:
            for tag, wrapper in WATCH_TRAIN.items():
                if tag in e.key:
                    print(f"  phase 3 {wrapper} kernel: "
                          f"{e.self_device_time_total / 1e3:.3f} ms "
                          f"x{e.count} {e.key[:90]}", flush=True)
        combine_backward(prof, kern)
        return launches
    finally:
        shutil.rmtree(ck, ignore_errors=True)


def combine_backward(prof, kern) -> None:
    """Prints the device time a step of the kernels launched under the
    combine backward (the ``_Combine`` autograd node, ``_CombineBackward``
    in the profile) and of its own part, beside the dispatch kernel's
    total over the step.  Under remat the node's first read of its saved
    tensors recomputes the layer group's forward (its CPU children up to
    the recomputed ``_Combine``); its own part is what follows, and the
    dispatch kernel its body launches directly."""
    def under(e):
        yield from e.kernels
        for c in e.cpu_children:
            yield from under(c)
    nodes = [e for e in prof.events() if e.name == "_CombineBackward"]
    every, own = [], []
    for e in nodes:
        kids = sorted(e.cpu_children, key=lambda c: c.time_range.start)
        fwd = [c.time_range.end for c in kids if c.name == "_Combine"]
        cut = max(fwd, default=float("-inf"))
        every += list(under(e))
        own += [k for c in kids if c.time_range.start >= cut
                for k in under(c)]
        own += [k for k in e.kernels if "dispatch_kernel" in k.name]
    disp = [k for k in own if "dispatch_kernel" in k.name]
    total = [e for e in kern if "dispatch_kernel" in e.key]

    def ms(ks):
        return sum(k.duration for k in ks) / 1e3
    print(f"phase 3 combine backward (_CombineBackward x{len(nodes)}): "
          f"{ms(every):.3f} ms device a step over {len(every)} kernels, "
          f"the remat recompute included; its own part {ms(own):.3f} ms "
          f"over {len(own)} kernels, of it dispatch_kernel {ms(disp):.3f} "
          f"ms x{len(disp)}; dispatch_kernel in the whole step "
          f"{sum(e.self_device_time_total for e in total) / 1e3:.3f} ms "
          f"x{sum(e.count for e in total)}", flush=True)


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


# ---------------------------------------------------------------------------
# phase 13: training the RWKV6 and hybrid Mamba2 families
# ---------------------------------------------------------------------------

# rwkv6-1.6b and zamba2-1.2b at full width and depth through launch.train:
# 4 x 2048 tokens a step, 6 steps, remat on (the configs' default)
REC_TRAIN_ARGV = ["--steps", "6", "--batch", "4", "--seq", "2048",
                  "--ckpt-every", "100"]
# each family's recurrence kernel and its backward; under remat a layer's
# forward runs twice a step (the forward and the recompute), its backward
# once
REC_TRAIN_KERNELS = {"rwkv6-1.6b": ("rwkv6_wkv", "rwkv6_wkv_bwd"),
                     "zamba2-1.2b": ("ssd_scan", "ssd_scan_bwd")}
# (b): depth 2, the kernel route against the plain route from one seed for
# 3 steps of 2 x 2048 tokens (the plain route's Python loops over T take
# ~27 s at 4 x 2048): step 1's loss within 1e-4 and grad norm within 1e-3
# (relative); the later steps' gaps printed and held under 1e-2
ROUTE_STEPS = 3
ROUTE_BATCH = 2
ROUTE_LOSS_REL, ROUTE_GN_REL, ROUTE_LATER_REL = 1e-4, 1e-3, 1e-2


def depth_cut(cfg, n: int):
    """``cfg`` at ``n`` layers; a hybrid's pattern cut to n - 1 Mamba2
    layers and a tap, so the shared block runs."""
    pattern = cfg.layer_pattern[:n - 1] + "*" if cfg.layer_pattern else ""
    return dataclasses.replace(cfg, n_layers=n, layer_pattern=pattern)


def phase13_train(dev, arch: str) -> dict:
    """One family at full width and depth through ``launch.train``,
    counters zeroed just before and read just after: every loss and grad
    norm finite, the recurrence kernel launched twice a layer a step and
    its backward once, nothing else; step time, tokens/s, peak memory, the
    checkpoint, and one more step under the profiler (busy share, top
    kernels, the recurrence kernels' device time)."""
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
        out = train.run(["--arch", arch, *REC_TRAIN_ARGV, "--ckpt-dir", ck,
                         "--device", str(dev)])
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        launches = {n: c.count for n, c in COUNTERS.items()}
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        tr, state = out["trainer"], out["state"]
        cfg, log = tr.model_cfg, tr.metrics_log
        steps = len(log)
        fwd, bwd = REC_TRAIN_KERNELS[arch]
        want = {fwd: 2 * cfg.n_layers * steps, bwd: cfg.n_layers * steps}
        print(f"phase 13 {arch} launches ({steps} steps): "
              + json.dumps({n: c for n, c in launches.items() if c})
              + f"; a step: {fwd} {launches[fwd] / max(steps, 1):g}, {bwd} "
              f"{launches[bwd] / max(steps, 1):g}", flush=True)
        if steps != 6 or any(r.get("skipped") for r in log):
            raise AssertionError(f"{arch}: expected 6 committed steps, got "
                                 f"{log}")
        if {n: c for n, c in launches.items() if c} != want:
            raise AssertionError(f"{arch}: launches {launches}, expected "
                                 f"{want} and no other kernel")
        losses = [r["loss"] for r in log]
        norms = [r["grad_norm"] for r in log]
        if not (all(np.isfinite(losses)) and all(np.isfinite(norms))):
            raise AssertionError(f"{arch}: non-finite loss or grad norm: "
                                 f"{losses}, {norms}")
        n_params = sum(p.numel() for p in tree_leaves(state["params"]))
        dts = [r["dt"] for r in log]
        med = float(np.median(dts[1:]))
        tokens = tr.data_cfg.global_batch * tr.data_cfg.seq_len
        ck_log = tr.checkpoint_log[-1]
        print(f"phase 13 {arch}: trained {cfg.n_layers} layers, {n_params} "
              f"params, {steps} steps of {tokens} tokens in {wall:.2f} s "
              f"wall; losses {[round(v, 6) for v in losses]}; grad norms "
              f"{[round(v, 4) for v in norms]}", flush=True)
        print(f"phase 13 {arch}: step time (fwd_bwd stopwatch) first "
              f"{dts[0]:.4f} s, median of steps 1-{steps - 1} {med:.4f} s "
              f"(min {min(dts[1:]):.4f}, max {max(dts[1:]):.4f}); "
              f"{tokens / med:.1f} tokens/s; peak device memory {peak:.2f} "
              f"GiB; checkpoint {ck_log['bytes']} bytes in "
              f"{ck_log['seconds']:.3f} s", flush=True)
        batch = tr._batch(steps)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            _, _, m = tr.step_fn(state["params"], state["opt_state"], batch)
            float(m["loss"])
            pwall = time.perf_counter() - t1
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
        print(f"phase 13 {arch} step under the profiler: wall "
              f"{pwall * 1e3:.3f} ms, device busy {dev_ms:.3f} ms = "
              f"{100 * dev_ms / 1e3 / med:.1f}% of the median step "
              f"({100 * dev_ms / 1e3 / pwall:.1f}% of the profiled wall), "
              f"{sum(e.count for e in kern)} kernels", flush=True)
        for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:12]:
            print(f"    {e.self_device_time_total / 1e3:9.3f} ms  "
                  f"x{e.count:<5d} {e.key[:90]}", flush=True)
        for tag in ("wkv_", "ssd_", "chunk_state_kernel"):
            hits = [e for e in kern if tag in e.key]
            for e in hits:
                print(f"  phase 13 {arch} {e.key[:60]}: "
                      f"{e.self_device_time_total / 1e3:.3f} ms x{e.count} "
                      f"({e.self_device_time_total / max(e.count, 1) / 1e3:.4f}"
                      f" ms a launch)", flush=True)
        return launches
    finally:
        shutil.rmtree(ck, ignore_errors=True)


def phase13_routes(dev, arch: str) -> None:
    """(b): ``arch`` at full width and depth 2 (``depth_cut``), the kernel
    route against the plain route (``compute_backend="xla"``: the plain
    recurrences under autograd) from one seed, ROUTE_BATCH x 2048 tokens, 3
    steps of ``launch.steps.make_train_step``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    cfg = depth_cut(get_config(arch), 2)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=2048,
                                  global_batch=ROUTE_BATCH, seed=0))
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=ROUTE_STEPS)
    runs = {}
    for route in ("pallas", "xla"):
        c = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, compute_backend=route))
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = lm.init_params(c, gen, device=dev)
        st = init_opt_state(params, ocfg)
        step = make_train_step(c, ocfg)
        t0 = time.perf_counter()
        got = []
        for i in range(ROUTE_STEPS):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in data.batch(i).items()}
            params, st, m = step(params, st, batch)
            got.append((float(m["loss"]), float(m["grad_norm"])))
        runs[route] = got
        print(f"phase 13 {arch} depth 2 ({cfg.layer_pattern or 'rwkv'}) "
              f"{route} route: losses {[l for l, _ in got]}, grad norms "
              f"{[g for _, g in got]} in {time.perf_counter() - t0:.2f} s",
              flush=True)
        del params, st, step
        gc.collect()
        torch.cuda.empty_cache()
    gaps = [(abs(k[0] - p[0]) / abs(p[0]), abs(k[1] - p[1]) / abs(p[1]))
            for k, p in zip(runs["pallas"], runs["xla"])]
    print(f"phase 13 {arch} depth 2: kernel vs plain route, relative gaps "
          f"(loss, grad norm) a step {gaps} (limits step 1 "
          f"{ROUTE_LOSS_REL} / {ROUTE_GN_REL}, later {ROUTE_LATER_REL})",
          flush=True)
    if not (gaps[0][0] <= ROUTE_LOSS_REL and gaps[0][1] <= ROUTE_GN_REL
            and all(g <= ROUTE_LATER_REL for gap in gaps[1:] for g in gap)):
        raise AssertionError(f"{arch}: the kernel route disagrees with the "
                             f"plain route: {gaps}")


def phase13_resume(dev) -> None:
    """(c): rwkv6-1.6b at full width and depth 2, 4 x 2048 tokens: 4
    straight steps against 2 + injected failure + restart + 2, bitwise,
    with deterministic algorithms on (as ``phase3_resume``)."""
    import shutil
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.tree import tree_items
    cfg = depth_cut(get_config("rwkv6-1.6b"), 2)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=2048,
                      global_batch=4)
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
        print(f"phase 13 resume (rwkv6-1.6b, 2 layers, full width): "
              f"straight losses {la}, 2 + restart + 2 losses {lb}; "
              f"{len(differ)} of {len(tree_items(got))} state leaves differ",
              flush=True)
        if differ or la != lb:
            raise AssertionError(f"resume is not bitwise: {differ[:8]}")
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(root, ignore_errors=True)


def phase13(dev) -> dict:
    """Training rwkv6-1.6b and zamba2-1.2b: (a) each at full width and
    depth through launch.train, (b) each at depth 2 on the kernel
    route against the plain route, (c) rwkv6's bitwise resume.  Returns
    the launches of (a), both models' summed."""
    import torch
    t0 = time.perf_counter()
    launches = {}
    for arch in REC_TRAIN_KERNELS:
        for n, c in phase13_train(dev, arch).items():
            launches[n] = launches.get(n, 0) + c
        gc.collect()
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    for arch in REC_TRAIN_KERNELS:
        phase13_routes(dev, arch)
    t2 = time.perf_counter()
    phase13_resume(dev)
    print(f"phase 13 took {time.perf_counter() - t0:.1f} s: (a) "
          f"{t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, (c) "
          f"{time.perf_counter() - t2:.1f} s", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 7: expert parallelism and Lina's §4 schedule at world size 1
# ---------------------------------------------------------------------------

# norm-wise ||mesh - no mesh|| / ||no mesh|| allowed for each gradient of
# phase 7's layer check: the mesh path runs the same kernels on the same
# rows, in 4 capacity chunks (the backward's dgrad too), and each weight
# gradient is one fp32 sum over the rows, in their order at ep 1
EP_GRAD_REL = 1e-5
EP_SCHEDULES = ("baseline", "priority", "fixed", "priority+partition",
                "priority+partition+pipeline")
# phase 3's step, kept for phase 7's comparison
PHASE3: dict = {}


def phase7_mesh(dev):
    """The one-rank NCCL mesh (1 x 1) and its communicators' priorities."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((1, 1), device=str(dev))
    least, greatest = torch.cuda.Stream.priority_range()
    print(f"phase 7: {mesh}; communicator high-priority stream flags "
          f"(ProcessGroupNCCL options read back) "
          f"{json.dumps(mesh.stream_priorities())}; CUDA stream priorities "
          f"{least} (least) .. {greatest} (greatest)", flush=True)
    if mesh.stream_priorities() != {"data": False, "model": True}:
        raise AssertionError("the model group's communicator must take the "
                             "high-priority stream, the data group's not")
    return mesh


def phase7_layer(dev, mesh) -> None:
    """gpt2-moe's MoE layer at the training shape (8 x 1024 tokens, E 16,
    top-2, C 1288, kernel route, bf16) on the 1 x 1 mesh, ``lina`` with 4
    micro-ops and ``lina=False``, against ``mesh=None``: the same ids, y
    and gradients (x, router, wi, wo) within EP_GRAD_REL norm-wise."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.moe import MoEParams, moe_layer
    cfg = get_config("gpt2-moe")
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    bf = torch.bfloat16
    x = torch.randn(8, 1024, D, generator=gen, device=dev).to(bf)
    router = (torch.randn(D, E, generator=gen, device=dev)
              * D ** -0.5).to(bf)
    wi = (torch.randn(E, D, F, generator=gen, device=dev) * D ** -0.5).to(bf)
    wo = (torch.randn(E, F, D, generator=gen, device=dev) * F ** -0.5).to(bf)
    ct = torch.randn(8, 1024, D, generator=gen, device=dev)
    mcfg = dataclasses.replace(cfg.moe, compute_backend="pallas",
                               n_microops=4)

    def run(m, lina):
        leaves = [a.detach().requires_grad_() for a in (x, router, wi, wo)]
        out = moe_layer(leaves[0], MoEParams(leaves[1], leaves[2], None,
                                             leaves[3]), mcfg,
                        ffn_type=cfg.ffn_type, dispatch_backend="pallas",
                        mesh=m, lina=lina)
        grads = torch.autograd.grad((out.y.float() * ct).sum(), leaves)
        return out, [g.float() for g in grads]

    base, bg = run(None, True)
    for tag, lina in (("lina, 4 micro-ops", True), ("lina=False", False)):
        out, g = run(mesh, lina)
        torch.cuda.synchronize()
        ids = torch.equal(out.expert_idx, base.expert_idx)
        y_err = (out.y.float() - base.y.float()).abs().max().item()
        rel = {n: ((a.float() - b.float()).norm() / b.float().norm()).item()
               for n, a, b in zip(("y", "dx", "drouter", "dwi", "dwo"),
                                  [out.y, *g], [base.y, *bg])}
        bits = {n: torch.equal(a, b) for n, a, b in
                zip(rel, [out.y, *g], [base.y, *bg])}
        print(f"phase 7 layer check ({tag}, 1 x 1 mesh against no mesh, 8 x "
              f"1024 tokens, cap {C_TRAIN}): ids equal {ids}; bitwise "
              f"{json.dumps(bits)}; y max abs err {y_err:.3e}; norm-wise rel "
              f"err " + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
              + f" (limit {EP_GRAD_REL})", flush=True)
        if not ids or any(not v <= EP_GRAD_REL for v in rel.values()):
            raise AssertionError(f"phase 7 layer check ({tag}) disagrees "
                                 f"with the single-rank layer: {rel}")


def nccl_split(prof):
    """(device ms of NCCL kernels, their names and counts, memcpy ms) of a
    profile."""
    import torch
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    nccl = [e for e in kern if "nccl" in e.key.lower()]
    copies = [e for e in kern if "memcpy" in e.key.lower()]
    ms = sum(e.self_device_time_total for e in nccl) / 1e3
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    return ms, {e.key[:60]: e.count for e in nccl}, \
        sum(e.self_device_time_total for e in copies) / 1e3, busy


def ordering(prof, mesh, microbatches: int) -> str:
    """Each all-reduce of the profiled step after the last backward
    all-to-all before it ended: by NCCL kernels where NCCL launched both
    kinds, else by the events the mesh recorded on the compute stream
    (an all-to-all's after its wait, a reduction's before its first
    chunk is issued)."""
    import torch
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "nccl" in e.name.lower()]
    red = [k for k in kernels if "allreduce" in k.name.lower()]
    a2a = [k for k in kernels if k not in red]
    if red and a2a and microbatches == 1:
        first = min(k.time_range.start for k in red)
        last = max(k.time_range.end for k in a2a)
        if first < last:
            raise AssertionError(f"an all-reduce kernel started {last - first}"
                                 f" us before the last all-to-all ended")
        return (f"by NCCL kernels: first all-reduce starts "
                f"{first - last:.1f} us after the last all-to-all ends "
                f"({len(a2a)} all-to-all, {len(red)} all-reduce kernels)")
    tl = mesh.timeline
    t0 = tl[0][1]
    times = [(kind, t0.elapsed_time(ev)) for kind, ev in tl]
    gaps = []
    for i, (kind, t) in enumerate(times):
        if kind != "reduce":
            continue
        before = [u for k, u in times[:i] if k == "a2a"]
        if not before:
            raise AssertionError("a reduction issued before any all-to-all")
        gaps.append(t - max(before))
    if not gaps or min(gaps) < 0:
        raise AssertionError(f"a reduction issued before the all-to-all it "
                             f"must follow: gaps {gaps}")
    return (f"by events (NCCL launched {len(a2a)} all-to-all and "
            f"{len(red)} all-reduce kernels): {len(gaps)} reductions, each "
            f"issued {min(gaps) * 1e3:.1f}-{max(gaps) * 1e3:.1f} us after "
            f"the last all-to-all before it completed, "
            f"{sum(k == 'a2a' for k, _ in times)} all-to-all events")


def ep_sections(n: int, backward: bool) -> list:
    """The marks one pipelined expert-parallel section of n chunks leaves
    on the mesh's timeline (``core.microop.pipelined_expert_ffn``): sent,
    waited for ("a2a"), returned, and in the backward the weight
    gradients' "tail" before the return exchanges are waited for."""
    seq = ["send"]
    for k in range(n):
        seq += (["send"] if k + 1 < n else []) + ["a2a", "return"]
    return seq + (["tail"] if backward else []) + ["a2a"] * n


def pipeline_order(mesh, n: int, backwards: int, strict: bool) -> str:
    """Raise unless the profiled step's timeline (its reductions aside) is
    a run of whole pipelined sections of n chunks in issue order: dy's
    chunk k+1 sent before chunk k's dgrad and waited for after it, chunk
    k's dx returned before chunk k+1's dgrad, the weight gradients after
    the last dx is sent and before any is waited for; ``backwards``
    backward sections (the MoE layers times the microbatches).  Not
    ``strict`` (another tree at ``--src``), a timeline with no "send"
    mark is reported as unmarked."""
    kinds = [k for k, _ in mesh.timeline if k != "reduce"]
    if not strict and "send" not in kinds:
        return "not marked by the tree at --src"
    fwd = bwd = i = 0
    while i < len(kinds):
        for backward in (True, False):
            want = ep_sections(n, backward)
            if kinds[i:i + len(want)] == want:
                break
        else:
            raise AssertionError(
                f"the expert pipeline's issue order is broken at mark {i} "
                f"of {len(kinds)}: {kinds[i:i + 4 * n + 4]}")
        fwd, bwd, i = fwd + (not backward), bwd + backward, i + len(want)
    if bwd != backwards:
        raise AssertionError(f"{bwd} backward sections of the expert "
                             f"pipeline, not {backwards}")
    return (f"{fwd} forward and {bwd} backward sections of {n} chunks, each "
            f"in issue order")


def backward_overlap(prof, n: int) -> str:
    """From the profiled step's device kernels: how many of the backward's
    inner return exchanges (chunk k's dx, k < n - 1) start before chunk
    k+1's dgrad kernels end, and the microseconds they overlap.  A layer's
    backward is the run of ``grouped_matmul`` kernels opened by its one
    bf16 x bf16 launch (the recompute of h over the whole buffer; gelu):
    h, then da and dx of each chunk, then dwo and dwi.  Chunk k's dx
    exchange is the first NCCL all-to-all kernel to start after its dx
    GEMM ends.  Layers whose kernels the profiler lost are left out."""
    import torch
    ev = sorted((e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA),
                key=lambda e: e.time_range.start)
    a2a = [e for e in ev if "nccl" in e.name.lower()
           and "allreduce" not in e.name.lower()]
    groups = []
    for e in ev:
        if "gmm_bf16" in e.name:
            groups.append([e])
        elif "gmm_" in e.name and groups:
            groups[-1].append(e)
    layers = [g for g in groups if len(g) == 3 + 2 * n]
    hits, inside, us = 0, 0, 0.0
    for g in layers:
        for k in range(n - 1):
            t = g[2 + 2 * k].time_range.end
            x = next((a for a in a2a if a.time_range.start >= t), None)
            w0, w1 = g[3 + 2 * k].time_range.start, g[4 + 2 * k].time_range.end
            if x is not None and x.time_range.start < w1:
                hits += 1
                o = min(x.time_range.end, w1) - max(x.time_range.start, w0)
                inside += o > 0
                us += max(0.0, o)
    return (f"{hits} of {len(layers) * (n - 1)} inner return exchanges start "
            f"before the next chunk's dgrad kernels end, {inside} of them "
            f"while those kernels run, {us:.1f} us overlapped "
            f"({len(layers)} of {len(groups)} layer backwards whole in the "
            f"profile, {len(a2a)} NCCL all-to-all kernels)")


def phase7_run(dev, mesh, tag, argv, n_layers=None, run=False, steps=None,
               strict=True):
    """One training run from the driver's flags (``n_layers`` cuts the
    depth): with ``run`` through ``Trainer.run`` (checkpoint included),
    else its step function driven from the seeded state for ``steps``
    (default the flags' ``--steps``, which also set the LR schedule; no
    checkpoint); then one more step under the profiler.
    Prints and returns the steps' losses, the step median (steps after
    the first), busy and NCCL device time and the ordering check."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.gating import capacity
    from repro_torch.core.microop import resolve_chunk_count
    from repro_torch.kernels import COUNTERS
    from repro_torch.launch import train
    from repro_torch.runtime.trainer import Trainer
    ck = tempfile.mkdtemp(prefix="repro_torch_ep_")
    try:
        args = train.parse_args(argv + ["--ckpt-dir", ck, "--device",
                                        str(dev)])
        cfg, dcfg, ocfg, tcfg = train.configs(args)
        if n_layers:
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
        tr = Trainer(cfg, dcfg, ocfg, tcfg,
                     mesh=mesh if args.mesh else None)

        def step(state, i):
            extra = (state["reduce_state"],) if tr.stateful_reduce else ()
            out = tr.step_fn(state["params"], state["opt_state"],
                             tr._batch(i), *extra)
            loss = float(out[2]["loss"])                     # waits
            new = {"params": out[0], "opt_state": out[1]}
            if tr.stateful_reduce:
                new["reduce_state"] = out[3]
            return new, loss

        if run:
            state = tr.run()
            losses = [r["loss"] for r in tr.metrics_log]
            dts = [r["dt"] for r in tr.metrics_log]
        else:
            state, losses, dts = tr.init_state(), [], []
            for i in range(steps or tcfg.steps):
                t0 = time.perf_counter()
                state, loss = step(state, i)
                dts.append(time.perf_counter() - t0)
                losses.append(loss)
        torch.cuda.synchronize(dev)
        if len(losses) != (steps or tcfg.steps) or \
                not all(np.isfinite(losses)) or \
                not losses[-1] < losses[0]:
            raise AssertionError(f"phase 7 {tag}: {losses}")
        row = {"tag": tag, "losses": losses,
               "median": float(np.median(dts[1:]))}
        if tr.mesh is not None:
            tr.mesh.timeline = []
        gmm = COUNTERS["grouped_matmul"].count
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(state, len(losses))
            pwall = time.perf_counter() - t0
        row["gmm"] = COUNTERS["grouped_matmul"].count - gmm
        nccl_ms, names, copy_ms, busy = nccl_split(prof)
        row.update(nccl_ms=nccl_ms, busy=busy)
        msg = f"; grouped_matmul launches {row['gmm']}"
        if tr.mesh is not None:
            n = resolve_chunk_count(capacity(
                args.batch // tcfg.microbatches * args.seq, cfg.moe.n_experts,
                cfg.moe.top_k, cfg.moe.capacity_factor), cfg.moe.n_microops)
            msg += ("; ordering " + ordering(prof, tr.mesh, tcfg.microbatches)
                    + "; pipeline " + pipeline_order(
                        tr.mesh, n, cfg.n_layers * tcfg.microbatches, strict)
                    + "; backward overlap " + backward_overlap(prof, n))
            tr.mesh.timeline = None
        if tr.mesh is not None and not n_layers:
            kern = [e for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA]
            for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:10]:
                print(f"  phase 7 {tag} kernel: "
                      f"{e.self_device_time_total / 1e3:9.3f} ms x{e.count:<5d} "
                      f"{e.key[:80]}", flush=True)
        print(f"phase 7 {tag}: step median {row['median']:.4f} s (steps "
              f"1-{len(dts) - 1}; min {min(dts[1:]):.4f}, max "
              f"{max(dts[1:]):.4f}); profiled step wall {pwall * 1e3:.1f} "
              f"ms, busy {busy:.3f} ms, NCCL kernels {nccl_ms:.3f} ms "
              f"{json.dumps(names)}, memcpy {copy_ms:.3f} ms{msg}; losses "
              f"(float.hex) " + " ".join(float(v).hex() for v in losses),
              flush=True)
        return row
    finally:
        shutil.rmtree(ck, ignore_errors=True)


def phase7(dev, strict: bool = True) -> dict:
    """Expert parallelism and the §4 schedule on a one-rank NCCL mesh:
    the communicators' priorities, the layer check, the five schedules
    and two compressions at full width and depth 2 (4 steps each, beside
    the same steps without a mesh), at depth 12 the 1 x 1 mesh with 4
    micro-ops beside phase 3 (one microbatch) and 2 microbatches without
    a mesh, then 12 steps of priority+partition+pipeline with 2
    microbatches through ``Trainer.run``, counters zeroed just before and
    read just after (every training kernel must launch); the mesh's steps
    held bitwise to the single-rank ones."""
    import gc
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import COUNTERS, reset_counters
    t_start = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    mesh = phase7_mesh(dev)
    phase7_layer(dev, mesh)
    train = functools.partial(phase7_run, strict=strict)
    base = ["--arch", "gpt2-moe", "--steps", "4", "--batch", "8", "--seq",
            "1024", "--ckpt-every", "100"]
    ep = ["--mesh", "1x1", "--n-microops", "4"]
    none = train(dev, mesh, "depth 2, no mesh", base, n_layers=2)
    rows = [train(dev, mesh, f"depth 2, {s}", base + ep + [
        "--schedule", s], n_layers=2) for s in EP_SCHEDULES]
    for comp in ("bf16", "int8_ef"):
        rows.append(train(dev, mesh, f"depth 2, priority+partition, "
                          f"{comp}", base + ep + [
                              "--schedule", "priority+partition",
                              "--grad-compression", comp], n_layers=2))
    same = {tuple(r["losses"]) for r in rows[:len(EP_SCHEDULES)]}
    gap = max(abs(a - b) for r in rows for a, b in zip(r["losses"],
                                                       none["losses"]))
    print(f"phase 7 depth 2: step median without a mesh {none['median']:.4f}"
          f" s; on the 1 x 1 mesh with 4 micro-ops "
          + ", ".join(f"{r['tag'][9:]} {r['median']:.4f}" for r in rows)
          + f" s; the five schedules' losses bitwise equal {len(same) == 1};"
          f" largest loss gap to the steps without a mesh {gap:.3e}",
          flush=True)
    if len(same) != 1:
        raise AssertionError("the schedules reduce over one rank: their "
                             "losses must be bitwise equal")
    # 5 of the 12 steps phase 3 runs (the same LR schedule)
    mesh1 = train(dev, mesh, "depth 12, 1 x 1 mesh, implicit",
                  TRAIN_ARGV[:] + ep, steps=5)
    mb2 = train(dev, mesh, "depth 12, no mesh, 2 microbatches",
                TRAIN_ARGV[:] + ["--microbatches", "2"], steps=5)
    reset_counters()
    full = train(dev, mesh, "depth 12, priority+partition+pipeline, 2 "
                 "microbatches", TRAIN_ARGV[:] + ep + [
                     "--schedule", "priority+partition+pipeline",
                     "--microbatches", "2"], run=True)
    launches = {n: c.count for n, c in COUNTERS.items()}
    print("phase 7 launches: " + json.dumps(launches), flush=True)
    missing = [n for n, c in launches.items()
               if c == 0 and n not in SERVE_ONLY | RECURRENT]
    if missing:
        raise AssertionError(f"kernels never launched in phase 7: {missing}")
    print(f"phase 7 depth 12: grouped_matmul launches a step on the 1 x 1 "
          f"mesh {mesh1['gmm']} (1 microbatch), {full['gmm']} (2 "
          f"microbatches); without a mesh {mb2['gmm']} (2 microbatches)",
          flush=True)
    print(f"phase 7 depth 12: step median on the 1 x 1 mesh with 4 "
          f"micro-ops (implicit reduction, 1 microbatch) "
          f"{mesh1['median']:.4f} s, busy {mesh1['busy']:.3f} ms; "
          f"priority+partition+pipeline with 2 microbatches "
          f"{full['median']:.4f} s, busy {full['busy']:.3f} ms, NCCL "
          f"{full['nccl_ms']:.3f} ms, against 2 microbatches without a mesh "
          f"{mb2['median']:.4f} s, busy {mb2['busy']:.3f} ms", flush=True)
    # at world size 1 the exchanges copy and the all-reduce adds nothing:
    # the mesh's steps must be the single-rank steps bit for bit
    same_mb2 = full["losses"][:5] == mb2["losses"]
    same_mb1 = PHASE3.get("losses", [])[:5] == mesh1["losses"]
    print(f"phase 7 depth 12: losses bitwise the single-rank steps' (first "
          f"5): 2 microbatches {same_mb2}; 1 microbatch against phase 3 "
          f"{same_mb1 if PHASE3 else 'not run'}", flush=True)
    if not same_mb2 or PHASE3 and not same_mb1:
        raise AssertionError("the 1 x 1 mesh's training steps differ from "
                             "the single-rank steps")
    if PHASE3:
        gaps = [abs(a - b) for a, b in zip(full["losses"], PHASE3["losses"])]
        i = int(np.argmax(gaps))
        print(f"phase 7 depth 12 against phase 3 (no mesh, 1 microbatch: "
              f"step median {PHASE3['median']:.4f} s, busy "
              f"{PHASE3['busy']:.3f} ms): the mesh's step "
              f"{mesh1['median'] / PHASE3['median']:.3f}x, busy "
              f"{mesh1['busy'] / PHASE3['busy']:.3f}x; loss gap of the "
              f"2-microbatch run to phase 3 largest {gaps[i]:.3e} (step {i}:"
              f" {full['losses'][i]:.6f} against {PHASE3['losses'][i]:.6f}),"
              f" at the end {gaps[-1]:.3e}", flush=True)
    dist.destroy_process_group()
    print(f"phase 7: {time.perf_counter() - t_start:.1f} s", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 8: serving on a one-rank NCCL mesh
# ---------------------------------------------------------------------------

SERVE_EP_STEPS = 8       # decode steps of the fixed batches and the steps


def fixed_batches(srv, toks, steps: int) -> list:
    """``serve_batch``, ``prefill_batch`` (cache_len S + steps) and
    ``steps`` greedy ``decode_batch`` steps of ``srv`` on ``toks``: every
    logits array, path-id array and the generated tokens, named."""
    import numpy as np
    s = toks.shape[1]
    r = srv.serve_batch(toks)
    out = [("serve logits", r.logits), ("serve path ids", r.path_ids)]
    pre = srv.prefill_batch(toks, cache_len=s + steps)
    out += [("prefill logits", pre.logits),
            ("prefill path ids", pre.path_ids)]
    cache, state, nxt = pre.cache, pre.path_ids[:, -1], \
        pre.logits.argmax(-1)
    gen = []
    for i in range(steps):
        d = srv.decode_batch(nxt, cache, state)
        out += [(f"decode {i} logits", d.logits),
                (f"decode {i} path state", d.path_state)]
        cache, state, nxt = d.cache, d.path_state, d.logits.argmax(-1)
        gen.append(nxt)
    return out + [("generated tokens", np.stack(gen, 1))]


def decode_costs(servers: dict, toks, reps: int = 5) -> dict:
    """A decode step of each server after a prefill of ``toks``, ``reps``
    times in turns (the order flipped each round): its host wall time and
    the host time spent in the serve layer's exchanges
    (``core.serving.exchange``, timed around each call), medians; then one
    more step of each under torch.profiler: busy and NCCL kernels' device
    time."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import serving as serving_mod
    steps = {}
    for tag, srv in servers.items():
        pre = srv.prefill_batch(toks, cache_len=toks.shape[1] + 8)

        def step(srv=srv, pre=pre):
            srv.decode_batch(pre.logits.argmax(-1), pre.cache,
                             pre.path_ids[:, -1])
            torch.cuda.synchronize()
        step()
        steps[tag] = step
    real, spent = serving_mod.exchange, [0.0, 0]

    def timed(x, mesh):
        t0 = time.perf_counter()
        out = real(x, mesh)
        spent[0] += time.perf_counter() - t0
        spent[1] += 1
        return out
    walls = {tag: [] for tag in steps}
    exch = {tag: [] for tag in steps}
    serving_mod.exchange = timed
    try:
        for r in range(reps):
            for tag in (list(steps) if r % 2 == 0 else list(steps)[::-1]):
                spent[:] = [0.0, 0]
                t0 = time.perf_counter()
                steps[tag]()
                walls[tag].append(time.perf_counter() - t0)
                exch[tag].append((spent[0], spent[1]))
    finally:
        serving_mod.exchange = real
    out = {}
    for tag, step in steps.items():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step()
        nccl_ms, names, copy_ms, busy = nccl_split(prof)
        wall = float(np.median(walls[tag]))
        ex = float(np.median([e for e, _ in exch[tag]]))
        out[tag] = {"wall": wall, "exchange": ex, "nccl_ms": nccl_ms,
                    "busy": busy}
        print(f"phase 8 decode step ({tag}): host wall median "
              f"{wall * 1e3:.3f} ms of {reps} (min "
              f"{min(walls[tag]) * 1e3:.3f}, max "
              f"{max(walls[tag]) * 1e3:.3f}), of it {exch[tag][0][1]} "
              f"exchanges {ex * 1e3:.3f} ms; under the profiler busy "
              f"{busy:.3f} ms, NCCL kernels {nccl_ms:.3f} ms "
              f"{json.dumps(names)}, memcpy {copy_ms:.3f} ms", flush=True)
    return out


def phase8_fixed(dev, mesh):
    """gpt2-moe at full width and depth profiled and served by a
    ``MoEServer`` on the 1 x 1 mesh and one without a mesh (the same
    weights; the two profiles must be bitwise equal) on the same fixed
    batches: every logits array, path id and generated token bitwise
    equal.  Returns (the server without a mesh, the mesh
    server, the fp32 master weights, the batch's tokens)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import lm
    from repro_torch.runtime.server import MoEServer, profile_from_training
    cfg = get_config("gpt2-moe")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = lm.init_params(cfg, gen, device=dev)
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                global_batch=4, seed=0))
    prof = profile_from_training(cfg, params,
                                 (ds.batch(i) for i in range(5)), device=dev)
    prof_ep = profile_from_training(cfg, params,
                                    (ds.batch(i) for i in range(5)),
                                    mesh=mesh)
    same_prof = np.array_equal(prof.counts, prof_ep.counts)
    print(f"phase 8 profile (5 x 4 x 64 tokens): the 1 x 1 mesh's Psi "
          f"tables bitwise those without a mesh {same_prof}", flush=True)
    if not same_prof:
        raise AssertionError("phase 8: the 1 x 1 mesh's profile differs "
                             "from the profile without a mesh")
    plain = MoEServer(cfg, params, prof, device=dev)
    ep = MoEServer(cfg, params, prof_ep, mesh=mesh)
    toks = np.random.RandomState(11).randint(0, cfg.vocab_size, (4, 64))
    with torch.inference_mode():
        a = fixed_batches(plain, toks, SERVE_EP_STEPS)
        b = fixed_batches(ep, toks, SERVE_EP_STEPS)
    differ = [n for (n, x), (_, y) in zip(a, b) if not np.array_equal(x, y)]
    finite = all(np.isfinite(x).all() for n, x in a if "logits" in n)
    print(f"phase 8 fixed batches (gpt2-moe, 12 layers, d 768, E 16; 4 x 64"
          f" tokens: serve_batch, prefill_batch, {SERVE_EP_STEPS} decode "
          f"steps): 1 x 1 mesh against no mesh, {len(a)} arrays, bitwise "
          f"equal {not differ}{'' if not differ else ' ' + str(differ)}; "
          f"logits finite {finite}; generated "
          f"{a[-1][1].tolist()}", flush=True)
    if differ or not finite:
        raise AssertionError(f"phase 8: the 1 x 1 mesh server differs from "
                             f"the server without a mesh: {differ}")
    return plain, ep, params, toks


def by_layer(calls, n_layers: int) -> list:
    """Tapped decode-step calls (step-major, a call a layer) -> one call a
    layer over [B * steps] tokens in (row, step) order, the layout
    ``compare_whole`` reads as B rows of ``steps`` causal positions."""
    import torch
    out = []
    for li in range(n_layers):
        cs = calls[li::n_layers]

        def cat(get):
            return torch.stack([get(c) for c in cs], 1).flatten(0, 1)
        x = cat(lambda c: c[0])
        y, ids, probs = (cat(lambda c, i=i: c[5][i]) for i in range(3))
        _, params, mcfg, plan, kw, _, _ = cs[0]
        out.append((x, params, mcfg, plan, kw, (y, ids, probs),
                    cat(lambda c: c[6])))
    return out


def phase8_steps(dev, mesh, params) -> None:
    """The transformer branch of ``models.lm`` through ``launch.steps``
    at full width and depth under a stacked plan (a placement plan a MoE
    layer over the server's 16 logical devices) and the config's top-k:
    a 4 x 64 prefill and
    SERVE_EP_STEPS decode steps (the prompt fed a token at a time from
    ``init_cache``) on the 1 x 1 mesh against ``mesh=None``, bitwise; and
    the kernel route against the plain route with ``compare_whole``
    (clean tokens within DRIFT_REL, gate flips within the bf16 margin)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.convert import shard_params
    from repro_torch.core.placement import plan_placement
    from repro_torch.core.serving import stack_plan_arrays
    from repro_torch.launch.sharding import expert_layout
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import lm
    cfg = get_config("gpt2-moe")
    rng = np.random.RandomState(5)
    plan = stack_plan_arrays(
        [plan_placement(rng.dirichlet(np.full(E, 0.5)), E, MAX_PACK)
         for _ in range(cfg.n_moe_layers)], device=dev)
    toks = torch.as_tensor(rng.randint(0, cfg.vocab_size, (4, 64)),
                           device=dev)

    def run(m, c):
        lt = None if m is None else \
            expert_layout(m, params, "prefill", fsdp=True)
        ps = shard_params(params, m, None if lt is None else lt.specs)
        pre = make_prefill_step(c, lt, serve_plan=plan)
        dec = make_decode_step(c, lt, serve_plan=plan)
        pcalls, dcalls, steps = [], [], []
        with torch.inference_mode():
            t0 = time.perf_counter()
            with tap_layers(pcalls, lm):
                logits = pre(ps, {"tokens": toks})
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            cache = lm.init_cache(c, 4, 64 + SERVE_EP_STEPS, device=dev)
            with tap_layers(dcalls, lm):
                for i in range(SERVE_EP_STEPS):
                    lg, cache, ex = dec(ps, cache, toks[:, i])
                    steps.append((lg, ex))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        return {"logits": logits, "steps": steps, "pcalls": pcalls,
                "dcalls": dcalls, "prefill_s": t1 - t0,
                "decode_s": (t2 - t1) / SERVE_EP_STEPS}

    base = run(None, cfg)
    on = run(mesh, cfg)
    same = torch.equal(base["logits"], on["logits"]) and all(
        torch.equal(a, b) and torch.equal(x, y) for (a, x), (b, y) in
        zip(base["steps"], on["steps"]))
    finite = bool(torch.isfinite(base["logits"]).all())
    print(f"phase 8 steps (gpt2-moe, stacked plan of 12 placement plans "
          f"over 16 logical devices, top-{cfg.moe.top_k}, fsdp): prefill 4 x 64 "
          f"{base['prefill_s'] * 1e3:.3f} ms without a mesh, "
          f"{on['prefill_s'] * 1e3:.3f} ms on the 1 x 1 mesh; decode step "
          f"{base['decode_s'] * 1e3:.3f} / {on['decode_s'] * 1e3:.3f} ms; "
          f"logits, expert choices of {SERVE_EP_STEPS} decode steps and "
          f"the prefill bitwise equal {same}; finite {finite}", flush=True)
    if not same or not finite:
        raise AssertionError("phase 8: the transformer branch on the 1 x 1 "
                             "mesh differs from mesh=None")
    plain = run(None, dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, compute_backend="xla")))
    compare_whole(base["pcalls"], plain["pcalls"], (4, 64), dev,
                  "transformer branch prefill, kernel vs plain route",
                  tag="phase 8")
    compare_whole(by_layer(base["dcalls"], cfg.n_moe_layers),
                  by_layer(plain["dcalls"], cfg.n_moe_layers),
                  (4, SERVE_EP_STEPS), dev,
                  "transformer branch decode steps, kernel vs plain route",
                  tag="phase 8")


def phase8(dev) -> dict:
    """Serving on a one-rank NCCL mesh (the all-to-alls self-exchanges;
    this machine has one GPU, so no multi-GPU number is taken): the fixed
    batches bitwise against the server without a mesh, phase 2's trace
    through ``launch.serve --mesh 1x1`` (counters zeroed just before, read
    just after: every serve kernel must launch, every request complete
    with finite logits; TTFT and TPOT beside phase 2's), a decode step's
    exchange cost, and the transformer branch's steps."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import COUNTERS, reset_counters
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_mesh
    t_start = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    mesh = make_mesh((1, 1), device=str(dev))
    print(f"phase 8: {mesh}", flush=True)
    plain, ep, params, toks = phase8_fixed(dev, mesh)
    vocab = plain.cfg.vocab_size
    dtoks = np.random.RandomState(7).randint(0, vocab, (4, 32))
    with torch.inference_mode():
        cost = decode_costs({"no mesh": plain, "1 x 1 mesh": ep}, dtoks)
    a, b = cost["no mesh"], cost["1 x 1 mesh"]
    print(f"phase 8: the 1 x 1 mesh's decode step (the same weights, "
          f"profile and plans) costs {(b['wall'] - a['wall']) * 1e3:.3f} ms "
          f"more host wall ({b['wall'] / a['wall']:.3f}x), its exchanges "
          f"{b['exchange'] * 1e3:.3f} ms of host time and "
          f"{b['nccl_ms']:.3f} ms of NCCL device time; busy "
          f"{b['busy']:.3f} against {a['busy']:.3f} ms", flush=True)
    del plain, ep
    gc.collect()
    reset_counters()
    t0 = time.perf_counter()
    out = serve.run(SERVE_ARGV + ["--device", str(dev), "--mesh", "1x1",
                                  "--trace-dir",
                                  str(ROOT / "build" / "serve_ep_trace")])
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = {n: c.count for n, c in COUNTERS.items()}
    print("phase 8 launches: " + json.dumps(launches), flush=True)
    missing = [n for n, c in launches.items()
               if c == 0 and n not in TRAIN_ONLY | RECURRENT]
    if missing:
        raise AssertionError(f"kernels never launched on the mesh's serve "
                             f"path: {missing}")
    m, results = out["summary"], out["results"]
    if m["n"] != 8 or m["gen_tokens"] != 64 or not all(
            np.isfinite(r.logits).all() and r.logits.shape == (vocab,)
            for r in results):
        raise AssertionError(f"phase 8: expected 8 requests x 8 tokens with "
                             f"finite logits, got {m}")
    p2 = (f"phase 2's TTFT p50 {PHASE2['ttft_p50'] * 1e3:.3f} ms, TPOT p50 "
          f"{PHASE2['tpot_p50'] * 1e3:.3f} ms" if PHASE2
          else "phase 2 not run")
    print(f"phase 8: launch.serve --mesh 1x1 served in {wall:.2f} s wall "
          f"(profiling included): TTFT p50 {m['ttft_p50'] * 1e3:.3f} ms, "
          f"TPOT p50 {m['tpot_p50'] * 1e3:.3f} ms ({p2}); "
          f"{m['gen_tok_s']:.3f} gen tok/s", flush=True)
    del out
    gc.collect()
    phase8_steps(dev, mesh, params)
    dist.destroy_process_group()
    print(f"phase 8: {time.perf_counter() - t_start:.1f} s", flush=True)
    return launches


# phase 14 (c): the dry run's peak against the card's on the same program,
# (arch, step, batch, sequence, depth or None for the config's own)
PEAK_CASES = (("gpt2-moe", "train", 8, 1024, None),
              ("mixtral-8x22b", "prefill", 4, 2048, 2),
              ("rwkv6-1.6b", "train", 4, 2048, None))
PEAK_REL = 0.10          # predicted against measured peak
MFU_REPS = 3             # timed steps after the measured one


def _leaves(out):
    import torch
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _leaves(o)] \
        if isinstance(out, (tuple, list)) else []


def edge_holds(name: str, case: str, got, args, kwargs) -> float:
    """Hold one accepted edge case's kernel output to its plain version
    at phase 1's tolerance for that kernel; returns the error."""
    import torch
    from repro_torch.analysis.kernels import REGISTRY, wrapper_of
    from repro_torch.kernels import ref
    tag = f"phase 14 {name} {case}"
    if name == "topk_gating_fused":
        return check_gating(tag, args[0], kwargs["router"], args[1], got)
    if name == "grouped_ffn":
        want = ffn_fp32(*args, kwargs["ffn_type"], kwargs.get("group_expert"),
                        kwargs.get("group_rows"))
        err = ((got.float() - want).abs().max() / want.abs().max()).item()
        lim = FFN_REL
    elif name == "grouped_matmul":
        want = ref.ref_grouped_matmul(args[0].float(), args[1].float())
        bf = all(a.dtype == torch.bfloat16 for a in args)
        err = ((got - want).abs().max() / want.abs().max()).item()
        lim = MM_REL["bf16" if bf else "tf32"]
    else:
        def cpu(t):
            return t.cpu() if isinstance(t, torch.Tensor) else t
        want = _leaves(wrapper_of(REGISTRY[name])(
            *map(cpu, args), **{k: cpu(v) for k, v in kwargs.items()}))
        gots = [t.cpu() for t in _leaves(got)]
        if name in ("topk_positions", "weighted_route"):
            err, lim = float(not torch.equal(gots[0], want[0])), 0.0
        elif name == "dispatch_rows":
            x, src, dot = args[0].cpu(), args[1].cpu(), kwargs["dot"].cpu()
            xs = x.float()[src.clamp(min=0).long()] * (src >= 0)[:, None]
            scale = (dot.float() * xs).abs().sum(-1)
            over = (gots[1] - want[1]).abs() - DOT_REL * scale
            err = float(not torch.equal(gots[0], want[0])) + \
                max(0.0, over.max().item())
            lim = 0.0
        elif name == "combine_rows":
            yr = want[0].float()
            ulp = torch.where(yr != 0, torch.exp2(torch.floor(torch.log2(
                yr.abs())) - 7), torch.full_like(yr, 2.0 ** -133))
            err = max(0.0, ((gots[0].float() - yr).abs() - ulp).max().item())
            lim = 0.0
        elif name == "flash_attention":
            err, lim = rel_err(gots[0], want[0]), FLASH_REL
        else:                               # the recurrences
            err = max(rel_err(g, w) for g, w in zip(gots, want))
            lim = REC_REL
    if not err <= lim:
        raise AssertionError(f"{tag}: error {err:.3e} over {lim}")
    return err


def phase14_contracts(dev) -> None:
    """(a) Each registry entry's edge cases on the card: an accepted one
    launches (its counter moves) and holds to its plain version, and the
    meta route's output shapes and dtypes are the card's; a refused one
    raises before its counter moves."""
    import torch
    from repro_torch.analysis.kernels import REGISTRY, wrapper_of
    from repro_torch.kernels import COUNTERS
    from repro_torch.kernels._build import KernelRefused
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    n_ok = n_refused = 0
    for name, entry in REGISTRY.items():
        fn, counter = wrapper_of(entry), COUNTERS[name]
        for ec in entry.edges:
            args, kwargs = ec.build(dev, gen)
            before = counter.count
            if not ec.accepted:
                try:
                    fn(*args, **kwargs)
                except KernelRefused as e:
                    if counter.count != before:
                        raise AssertionError(f"phase 14 {name} {ec.name}: "
                                             f"counted a refused launch")
                    print(f"  phase 14 {name:18s} {ec.name}: refused "
                          f"({type(e).__name__}: {str(e)[:70]})", flush=True)
                    n_refused += 1
                    continue
                raise AssertionError(f"phase 14 {name} {ec.name}: the card "
                                     f"took a case the contract refuses")
            got = fn(*args, **kwargs)
            torch.cuda.synchronize()
            if counter.count <= before:
                raise AssertionError(f"phase 14 {name} {ec.name}: no launch")
            margs, mkw = ec.build("meta", None)
            meta = _leaves(fn(*margs, **mkw))
            shapes = [(tuple(t.shape), t.dtype) for t in _leaves(got)]
            if [(tuple(t.shape), t.dtype) for t in meta] != shapes:
                raise AssertionError(f"phase 14 {name} {ec.name}: meta "
                                     f"route {meta} against {shapes}")
            err = edge_holds(name, ec.name, got, args, kwargs)
            print(f"  phase 14 {name:18s} {ec.name}: launched, err "
                  f"{err:.3e}, meta shapes and dtypes held", flush=True)
            n_ok += 1
            del got, args, kwargs
    print(f"phase 14 (a): {n_ok} accepted edge cases launched and held, "
          f"{n_refused} refused before a launch", flush=True)


def phase14_sweep_start(src: Path):
    """(b) The dry-run sweep (every assigned config x the four shapes x
    16x16, 2x16x16) on the host's CPU, in the background; returns (the
    process, the JSONL path)."""
    import tempfile
    out = Path(tempfile.mkdtemp(prefix="repro_torch_sweep_")) / "cells.jsonl"
    env = dict(os.environ, PYTHONPATH=str(src), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.sweep", "--out", str(out),
         "--jobs", str(os.cpu_count() or 8), "--timeout", "600"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, out


def phase14_sweep_finish(proc, out: Path) -> dict:
    """Wait for the sweep; print one line a cell (status, rank 0's peak,
    fits, FLOPs, wire bytes by kind); raise on a cell in error."""
    import shutil
    try:
        log, _ = proc.communicate(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    cells = [json.loads(line) for line in out.read_text().splitlines()]
    shutil.rmtree(out.parent, ignore_errors=True)
    if proc.returncode != 0 or any(c["status"] == "error" for c in cells):
        raise AssertionError("phase 14 sweep failed:\n" + log[-3000:])
    for c in cells:
        head = f"  sweep {c['arch']:26s} {c['shape']:12s} {c['mesh']:8s}"
        if c["status"] != "ok":
            print(f"{head} skip: {c['reason'][:90]}", flush=True)
            continue
        m, co = c["memory_analysis"], c["collectives"]
        wire = {k: f"{v / 1e9:.3f}" for k, v in co["wire_bytes"].items()}
        print(f"{head} ok peak {m['peak_bytes_estimate'] / 1e9:.2f} GB "
              f"fits {c['fits']} flops {c['analytic_flops_global']:.3e} "
              f"wire GB {wire}", flush=True)
    n_ok = sum(c["status"] == "ok" for c in cells)
    print(f"phase 14 (b): {len(cells)} cells, {n_ok} ok, {len(cells) - n_ok}"
          f" skipped, {sum(bool(c.get('fits')) for c in cells)} fit in "
          f"80 GB", flush=True)
    return {(c["arch"], c["shape"], c["mesh"]): c for c in cells}


def phase14_peaks(dev) -> None:
    """(c) The dry run's predicted peak against the card's
    ``max_memory_allocated`` on the same program (``launch.dryrun``'s
    ``step_program``), within PEAK_REL; (d) the analytic FLOPs over the
    measured step time as a share of the bf16 peak."""
    import numpy as np
    import torch
    from repro_torch.configs import H100, ShapeConfig, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.analytic import analytic_cost
    for arch, kind, b, s, depth in PEAK_CASES:
        cfg = get_config(arch)
        if depth:
            cfg = depth_cut(cfg, depth)
        step, args = dryrun.step_program(cfg, kind, b, s, device="meta")
        pred = dryrun.meta_peak(step, args)["peak_bytes_estimate"]
        del step, args
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        step, args = dryrun.step_program(cfg, kind, b, s, device=dev)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out = step(*args)
        torch.cuda.synchronize(dev)
        meas = torch.cuda.max_memory_allocated(dev) - base
        del out
        gap = (pred - meas) / meas
        dts = []
        for _ in range(MFU_REPS):
            t0 = time.perf_counter()
            out = step(*args)
            torch.cuda.synchronize(dev)
            dts.append(time.perf_counter() - t0)
            del out
        dt = float(np.median(dts))
        ana = analytic_cost(cfg, ShapeConfig(kind, s, b, kind))
        tokens = b * s
        model = (6 if kind == "train" else 2) * cfg.active_param_count() \
            * tokens
        print(f"phase 14 (c) {arch} {kind} {b} x {s}, {cfg.n_layers} layers:"
              f" predicted peak {pred} bytes ({pred / 2**30:.2f} GiB), "
              f"measured {meas} ({meas / 2**30:.2f} GiB), gap "
              f"{100 * gap:+.2f}%", flush=True)
        print(f"phase 14 (d) {arch} {kind}: step {dt:.4f} s (median of "
              f"{MFU_REPS}: {[round(x, 4) for x in dts]}); analytic "
              f"{ana.flops_global:.4e} FLOPs = {ana.flops_global / dt / 1e12:.1f}"
              f" TFLOP/s = {100 * ana.flops_global / dt / H100.peak_flops:.2f}"
              f"% of {H100.peak_flops / 1e12:.0f}; model (6ND / 2ND) "
              f"{100 * model / dt / H100.peak_flops:.2f}%", flush=True)
        del step, args
        gc.collect()
        torch.cuda.empty_cache()
        if not abs(gap) <= PEAK_REL:
            raise AssertionError(f"phase 14 (c) {arch}: predicted peak "
                                 f"{pred} against measured {meas} "
                                 f"({100 * gap:+.2f}%)")


def phase14_retrace(dev) -> None:
    """(e) A second ``warmup`` of the gpt2-moe engine at an identical grid
    builds no kernel, loads no library and adds no allocator segment."""
    import torch
    from repro_torch.analysis.retrace import no_retrace
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.runtime.engine import EngineConfig, ServingEngine
    cfg = get_config("gpt2-moe")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = lm.init_params(cfg, gen, device=dev)
    eng = ServingEngine(ctrl_server(dev, cfg, params),
                        EngineConfig(max_batch_tokens=256))
    n = eng.warmup(seqs=(64,), max_new_tokens=8)
    torch.cuda.synchronize(dev)
    with no_retrace("the second warm-up") as rep:
        again = eng.warmup(seqs=(64,), max_new_tokens=8)
        torch.cuda.synchronize(dev)
    print(f"phase 14 (e): warm-up {n} calls, again {again}: builds "
          f"{rep.builds}, library loads {rep.loads}, new allocator segments "
          f"{rep.segments}", flush=True)
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()


def phase14(dev, src: Path) -> dict:
    """The launch tooling and the static checker on the card: (a) the
    kernels' contract edge cases, (b) the dry-run sweep on the host's CPU
    (in the background meanwhile), (e) no re-trace in a second engine
    warm-up, then (c) the dry run's peaks against the card's and (d) the
    analytic FLOPs over the measured steps."""
    t0 = time.perf_counter()

    def lap(what: str) -> None:
        print(f"phase 14: {what} by {time.perf_counter() - t0:.1f} s",
              flush=True)
    proc, out = phase14_sweep_start(src)
    try:
        phase14_contracts(dev)
        lap("(a)")
        phase14_retrace(dev)
        lap("(e)")
    except BaseException:
        proc.kill()
        proc.wait()
        raise
    cells = phase14_sweep_finish(proc, out)
    lap("(b)")
    phase14_peaks(dev)
    lap("(c), (d): done")
    return cells


# phase 15 (a): the dense-sharded path at world size 1 against no mesh
WORLD1_TRAIN = (8, 1024, 5)      # gpt2-moe: batch, sequence, steps
WORLD1_SERVE = (4, 64, 8)        # prefill batch x prompt, decode steps
WORLD1_REL = 1e-6                # a by-design difference, where one shows
# phase 15 (b): rank 0 of a production cell on one card through a
# MirrorMesh: (arch, step, shape, depth or None for the config's own,
# steps run, the CUDA kernel whose device time the profile prints,
# Megatron sequence parallelism)
MIRROR_72B_DEPTH = 8
MIRROR_CASES = (("qwen3-8b", "train", "train_4k", None, 3, "", False),
                ("qwen3-8b", "train", "train_4k", None, 3, "", True),
                ("qwen2-72b", "train", "train_4k", MIRROR_72B_DEPTH, 3, "",
                 True),
                ("qwen2-72b", "prefill", "prefill_32k", None, 3,
                 "flash_kernel", False),
                ("mixtral-8x22b", "prefill", "prefill_32k", 2, 3,
                 "ffn_gemm_kernel", False))
# phase 15 (d): gpt2-moe requests, prompt tokens, tokens each generates
WALL_REQUESTS = (6, 48, 8)
MIRROR_PEAK_REL = 0.02
# the kernels on the sharded path (the recurrences' stacks are FSDP only
# and run in phases 5, 6 and 13)
SHARDED_PATH = set(REPLACES) - {"rwkv6_wkv", "ssd_scan"}


def _held(tag: str, what: str, got, want, rows: list,
          bitwise: bool = False) -> None:
    """Append (what, bitwise, max relative gap) for tensors ``got`` and
    ``want`` (lists); raise past WORLD1_REL, or, with ``bitwise``, unless
    bitwise."""
    import torch
    bit = all(torch.equal(a, b) for a, b in zip(got, want))
    rel = max(float((a.float() - b.float()).abs().max()
                    / b.float().abs().max().clamp(min=1e-30))
              for a, b in zip(got, want))
    rows.append((what, bit, rel))
    print(f"phase 15 (a) {tag} {what}: bitwise {bit}, max relative gap "
          f"{rel:.3e}", flush=True)
    if not rel <= WORLD1_REL or (bitwise and not bit):
        raise AssertionError(f"phase 15 (a) {tag} {what}: {rel:.3e} (past "
                             f"{WORLD1_REL}, or not bitwise where it must "
                             f"be)")


def phase15_world1(dev, launches: dict) -> None:
    """(a) A (1, 1, 1) (data, model, tp) and a (1, 1) NCCL mesh with the
    dense-sharded path on (``launch.sharding``'s specs through
    ``layout``): gpt2-moe's 5 training steps and a served prefill and 8
    decode steps (its identity plan), qwen3-8b at depth 4's prefill and 8
    decode steps, against no mesh; then the training steps and qwen3-8b's
    steps with sequence parallelism on, bitwise (the group has one rank,
    so nothing is split).  Counters zeroed before each mesh run and added
    to ``launches`` after it."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.convert import shard_params
    from repro_torch.kernels import COUNTERS, reset_counters
    from repro_torch.launch import sharding as S
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import (make_decode_step,
                                          make_prefill_step,
                                          make_serve_plan, make_train_step)
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.tree import tree_leaves
    meshes = [("(1, 1, 1)", make_mesh((1, 1, 1), device=str(dev))),
              ("(1, 1)", make_mesh((1, 1), device=str(dev)))]
    rows: list = []

    def count():
        for n, c in COUNTERS.items():
            launches[n] = launches.get(n, 0) + c.count

    b, s, n_steps = WORLD1_TRAIN
    cfg = get_config("gpt2-moe")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = lm.init_params(cfg, gen, device=dev)
    batches = [{"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                        generator=gen, device=dev),
                "labels": torch.randint(0, cfg.vocab_size, (b, s),
                                        generator=gen, device=dev)}
               for _ in range(n_steps)]
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=n_steps,
                       state_dtype=cfg.opt_state_dtype)

    def train(mesh, c=cfg):
        layout = None if mesh is None else S.layout_for(
            c, mesh, params, "train", global_batch=b)
        p = params if mesh is None else shard_params(params, mesh,
                                                     layout.specs)
        opt = init_opt_state(p, ocfg)
        step = make_train_step(c, ocfg, dispatch_backend="pallas",
                               layout=layout)
        losses = []
        for batch in batches:
            p, opt, m = step(p, opt, batch)
            losses.append(m["loss"])
        torch.cuda.synchronize(dev)
        return losses, p, opt

    def serve(c, ps, mesh):
        bb, ss, n_dec = WORLD1_SERVE
        layout = None
        toks = torch.randint(0, c.vocab_size, (bb, ss),
                             generator=torch.Generator(device=dev)
                             .manual_seed(1), device=dev)
        cache = lm.init_cache(c, bb, ss + n_dec, device=dev)
        if mesh is not None:
            layout = S.layout_for(c, mesh, ps, "prefill", global_batch=bb,
                                  cache=cache)
            ps = shard_params(ps, mesh, layout.specs)
            cache = shard_params(cache, mesh, layout.cache_specs)
        plan = make_serve_plan(c, mesh, device=dev)
        pre = make_prefill_step(c, layout, serve_plan=plan)
        dec = make_decode_step(c, layout, serve_plan=plan)
        out = []
        with torch.inference_mode():
            out.append(pre(ps, {"tokens": toks}))
            for i in range(n_dec):
                lg, cache, ex = dec(ps, cache, toks[:, i])
                out.append(lg)
                if ex is not None:
                    out.append(ex)
        torch.cuda.synchronize(dev)
        return out

    base_train = train(None)
    served = lm.cast_for_compute(cfg, params)
    base_serve = serve(cfg, served, None)
    for tag, mesh in meshes:
        reset_counters()
        got = train(mesh)
        count()
        _held(tag, f"gpt2-moe {n_steps} training steps' losses", got[0],
              base_train[0], rows)
        _held(tag, f"gpt2-moe params and AdamW state after {n_steps} steps",
              tree_leaves(got[1:]), tree_leaves(base_train[1:]), rows)
        del got
        reset_counters()
        got = serve(cfg, served, mesh)
        count()
        _held(tag, "gpt2-moe prefill and 8 decode steps (logits, expert "
              "choices)", got, base_serve, rows)
    t_sp = time.perf_counter()
    sp_cfg = dataclasses.replace(cfg, seq_parallel=True)
    for tag, mesh in meshes:
        reset_counters()
        got = train(mesh, sp_cfg)
        count()
        _held(tag + " SP", f"gpt2-moe {n_steps} training steps' losses",
              got[0], base_train[0], rows, bitwise=True)
        _held(tag + " SP", f"gpt2-moe params and AdamW state after "
              f"{n_steps} steps", tree_leaves(got[1:]),
              tree_leaves(base_train[1:]), rows, bitwise=True)
        del got
    sp_s = time.perf_counter() - t_sp
    del params, served, base_serve, base_train
    gc.collect()
    torch.cuda.empty_cache()
    qcfg = depth_cut(get_config("qwen3-8b"), 4)
    qp = lm.cast_for_compute(qcfg, lm.init_params(
        qcfg, torch.Generator(device=dev).manual_seed(0), device=dev))
    base = serve(qcfg, qp, None)
    for tag, mesh in meshes:
        reset_counters()
        got = serve(qcfg, qp, mesh)
        count()
        _held(tag, "qwen3-8b (4 layers) prefill and 8 decode steps", got,
              base, rows)
    t_sp = time.perf_counter()
    for tag, mesh in meshes:
        reset_counters()
        got = serve(dataclasses.replace(qcfg, seq_parallel=True), qp, mesh)
        count()
        _held(tag + " SP", "qwen3-8b (4 layers) prefill and 8 decode "
              "steps", got, base, rows, bitwise=True)
    sp_s += time.perf_counter() - t_sp
    print(f"phase 15 (a): the sequence-parallel runs took {sp_s:.1f} s",
          flush=True)
    del qp, base
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 15 (a): {sum(r[1] for r in rows)} of {len(rows)} results "
          f"bitwise; not bitwise: "
          f"{[r[0] for r in rows if not r[1]] or 'none'}", flush=True)


def _by_kind(records) -> dict:
    out: dict = {}
    for r in records:
        k = (r.kind, r.axis)
        n, nb = out.get(k, (0, 0))
        out[k] = (n + 1, nb + r.nbytes)
    return out


def phase15_mirror(dev, launches: dict) -> None:
    """(b) Rank 0 of each MIRROR_CASES cell at full width on the card
    through a ``MirrorMesh`` of the cell's ``arch_mesh``: the dry run's
    peak and records (the same ``step_program`` on ``meta`` with a
    ``RecordingMesh``) against ``max_memory_allocated`` and the mirror's
    records, the step's wall time (median after the first) and busy
    share, a finite output of the expected shape.  A case cut in depth
    also prints the dry run's peak at the config's full depth."""
    import numpy as np
    import torch
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels import COUNTERS, reset_counters
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MirrorMesh, arch_mesh
    print("phase 15 (b): a MirrorMesh fills each collective with what a "
          "world of ranks holding this rank's tensors returns: the values "
          "are not rank 0's in the real model; what runs and allocates "
          "is", flush=True)
    for arch, kind, sname, depth, n_steps, watch, sp in MIRROR_CASES:
        t_case = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), seq_parallel=sp)
        full_peak = None
        if depth:
            full_peak = dryrun.run_cell(
                arch, sname, seq_parallel=sp, verbose=False)[
                "memory_analysis"]["peak_bytes_estimate"]
            cfg = depth_cut(cfg, depth)
        shape = SHAPES[sname]
        rec = arch_mesh(cfg)
        b, s = dryrun.cell_shape(cfg, shape, rec)
        step, args = dryrun.step_program(cfg, kind, b, s, mesh=rec,
                                         global_batch=shape.global_batch)
        rec.records.clear()
        pred = dryrun.meta_peak(step, args)["peak_bytes_estimate"]
        want = list(rec.records)
        del step, args
        gc.collect()
        torch.cuda.empty_cache()
        mm = MirrorMesh(rec.shape, rec.axis_names, device=dev)
        base = torch.cuda.memory_allocated(dev)
        step, args = dryrun.step_program(cfg, kind, b, s, mesh=mm,
                                         device=dev,
                                         global_batch=shape.global_batch)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        mm.records.clear()
        reset_counters()
        t0 = time.perf_counter()
        out = step(*args)
        torch.cuda.synchronize(dev)
        dts = [time.perf_counter() - t0]
        for n, c in COUNTERS.items():
            launches[n] = launches.get(n, 0) + c.count
        meas = torch.cuda.max_memory_allocated(dev) - base
        got = list(mm.records)
        if kind == "train":
            # every timed step's loss and gradient norm finite (each runs
            # from the same weights and batch)
            def finite(o):
                return bool(torch.isfinite(o[2]["loss"]) and
                            torch.isfinite(o[2]["grad_norm"]))
            ok = finite(out)
            what = f"loss {float(out[2]['loss']):.6f}, grad norm " \
                f"{float(out[2]['grad_norm']):.6e}"
        else:
            ok = tuple(out.shape) == (b, cfg.vocab_size) and bool(
                torch.isfinite(out.float()).all())
            what = f"logits {tuple(out.shape)}"
        del out
        for _ in range(n_steps - 1):
            t0 = time.perf_counter()
            out = step(*args)
            torch.cuda.synchronize(dev)
            dts.append(time.perf_counter() - t0)
            if kind == "train":
                ok = ok and finite(out)
                what += f"; {float(out[2]['grad_norm']):.6e}"
            del out
        busy = profile_busy(lambda: step(*args),
                            f"phase 15 (b) {arch} {kind} {b} x {s}", watch)
        if watch == "flash_kernel":
            from repro_torch.configs import H100
            # this rank's heads: its 1 / 16 of the q heads, the kv heads
            # they read (models.attention.tp_weights)
            hd, n = cfg.resolved_head_dim, 16
            hl = cfg.n_heads // n
            kvl = cfg.n_kv_heads // n if cfg.n_kv_heads % n == 0 else \
                max(1, hl * cfg.n_kv_heads // cfg.n_heads)
            pairs = unmasked_pairs(s, cfg.causal, cfg.sliding_window)
            bnd, by = bound_ms(2 * (2 * b * s * hl * hd + 2 * b * s * kvl
                                    * hd), 4 * hd * pairs * hl * b, H100)
            print(f"phase 15 (b) {arch}: flash_attention at the local "
                  f"shape B{b} S{s} H{hl}/{kvl} hd{hd} causal: bound "
                  f"{bnd:.4f} ms a call ({by})", flush=True)
        gap = (pred - meas) / meas
        same = got == want
        print(f"phase 15 (b) {arch} {sname} on {rec.shape} "
              f"{rec.axis_names}, rank 0: {b} x {s}, {cfg.n_layers} layers,"
              f" sequence parallel {sp}:"
              f" predicted peak {pred} bytes ({pred / 2**30:.2f} GiB), "
              f"measured {meas} ({meas / 2**30:.2f} GiB), gap "
              f"{100 * gap:+.3f}%; step {float(np.median(dts[1:])):.4f} s "
              f"(median after the first; all {[round(x, 4) for x in dts]})"
              f", busy {100 * busy:.1f}%; {what}, finite {ok}", flush=True)
        mine, theirs = _by_kind(got), _by_kind(want)
        for k in sorted(set(mine) | set(theirs)):
            print(f"    {k[0]:15s} {k[1]:9s} card {mine.get(k, (0, 0))} "
                  f"dry run {theirs.get(k, (0, 0))} (count, bytes)",
                  flush=True)
        print(f"phase 15 (b) {arch}: {len(got)} collectives recorded, the "
              f"dry run's {len(want)}: equal {same}", flush=True)
        if full_peak is not None:
            print(f"phase 15 (b) {arch} {sname}: the dry run's peak at the "
                  f"full depth, {get_config(arch).n_layers} layers, "
                  f"{full_peak} bytes ({full_peak / 1e9:.2f} GB, fits 80 GB "
                  f"{full_peak <= 80e9}), beside this depth's {pred} "
                  f"predicted and {meas} measured", flush=True)
        print(f"phase 15 (b) {arch} {kind}: {time.perf_counter() - t_case:.1f}"
              f" s", flush=True)
        del step, args, mm
        gc.collect()
        torch.cuda.empty_cache()
        if not (abs(gap) <= MIRROR_PEAK_REL and same and ok):
            raise AssertionError(f"phase 15 (b) {arch}: gap {gap:+.4f}, "
                                 f"records equal {same}, output ok {ok}")


def phase15_sweep(src: Path, cells) -> None:
    """(c) The sweep's counts (phase 14's cells, or a sweep of its own):
    ok, skip, fitting; every cell that does not fit with its peak."""
    if cells is None:
        proc, out = phase14_sweep_start(src)
        cells = phase14_sweep_finish(proc, out)
    cs = list(cells.values())
    ok = [c for c in cs if c["status"] == "ok"]
    fit = [c for c in ok if c["fits"]]
    sp = sorted({c.get("seq_parallel") for c in ok}, key=str)
    print(f"phase 15 (c): {len(cs)} cells, {len(ok)} ok, "
          f"{len(cs) - len(ok)} skip, {len(fit)} fit in 80 GB (sequence "
          f"parallel {sp})", flush=True)
    for c in ok:
        if not c["fits"]:
            print(f"    does not fit: {c['arch']} {c['shape']} {c['mesh']}"
                  f" {c['memory_analysis']['peak_bytes_estimate'] / 1e9:.2f}"
                  f" GB", flush=True)
    bad = [c for c in cs if c["status"] == "skip" and (
        "expert slicing" in c["reason"] or "does not split" in c["reason"])]
    if bad:
        raise AssertionError(f"phase 15 (c): cells skipped for the "
                             f"sharding: {bad}")


def phase15_wallclock(dev, launches: dict) -> None:
    """(d) Wall-clock serving on a one-rank NCCL mesh: gpt2-moe at full
    width served by a ``MoEServer`` on the (1, 1) mesh; WALL_REQUESTS
    requests submitted on rank 0 and drained by ``ServingEngine.run()``
    (each step opens with rank 0's clock, its new requests and whether
    work remains, broadcast through ``Mesh.broadcast``) against
    ``simulate`` replaying them on the same server: the same tokens, the
    broadcasts recorded.  Counters zeroed before the wall-clock run and
    added to ``launches`` after it."""
    from collections import Counter

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import COUNTERS, reset_counters
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.runtime.engine import (EngineConfig, ServingEngine,
                                            simulate)
    from repro_torch.runtime.server import MoEServer, profile_from_training
    t0 = time.perf_counter()
    n_req, n_tok, new = WALL_REQUESTS
    mesh = make_mesh((1, 1), device=str(dev))
    cfg = get_config("gpt2-moe")
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                global_batch=4, seed=0))
    prof = profile_from_training(cfg, params,
                                 (ds.batch(i) for i in range(3)), mesh=mesh)
    srv = MoEServer(cfg, params, prof, mesh=mesh)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, cfg.vocab_size, n_tok) for _ in range(n_req)]
    ecfg = EngineConfig(max_batch_tokens=128, max_batch_requests=4)
    with torch.inference_mode():
        eng = ServingEngine(srv, ecfg)
        for p in prompts:
            eng.submit(p, max_new_tokens=new)
        mesh.records = []
        reset_counters()
        t_run = time.perf_counter()
        wall = eng.run()
        torch.cuda.synchronize(dev)
        t_run = time.perf_counter() - t_run
        for n, c in COUNTERS.items():
            launches[n] = launches.get(n, 0) + c.count
        kinds = Counter(r.kind for r in mesh.records)
        mesh.records = None
        rep = simulate(ServingEngine(srv, ecfg), [(p, 0.0) for p in prompts],
                       max_new_tokens=new)
    wall = sorted(wall, key=lambda r: r.rid)
    rep = sorted(rep, key=lambda r: r.rid)
    same = [r.rid for r in wall] == [r.rid for r in rep] == \
        list(range(n_req)) and all(
            a.tokens.tolist() == b.tokens.tolist() for a, b in zip(wall, rep))
    logits_bit = all(np.array_equal(a.logits, b.logits)
                     for a, b in zip(wall, rep))
    lat = [r.latency for r in wall]
    print(f"phase 15 (d) wall-clock serving on {mesh}: gpt2-moe, {n_req} "
          f"requests of {n_tok} tokens, {new} new each, {eng.step_idx} "
          f"engine steps in {t_run:.3f} s (latency p50 "
          f"{float(np.median(lat)):.4f} s); the tokens of simulate "
          f"{same}, its logits bitwise {logits_bit}; collectives "
          f"{dict(kinds)}; {time.perf_counter() - t0:.1f} s", flush=True)
    del eng, srv, params, prof
    gc.collect()
    torch.cuda.empty_cache()
    if not same or not kinds.get("broadcast"):
        raise AssertionError(f"phase 15 (d): tokens as simulate's {same}, "
                             f"broadcasts {kinds.get('broadcast', 0)}")


def phase15(dev, src: Path, cells=None) -> dict:
    """The dense sharding (``launch.sharding``): (a) world size 1 against
    no mesh, (b) rank 0 of four production cells through a
    ``MirrorMesh``, (c) the sweep's counts, (d) wall-clock serving on a
    one-rank mesh.  Returns the launches of the sharded runs; every kernel
    of SHARDED_PATH must have launched."""
    t0 = time.perf_counter()
    launches: dict = {}
    phase15_world1(dev, launches)
    print(f"phase 15: (a) by {time.perf_counter() - t0:.1f} s", flush=True)
    phase15_mirror(dev, launches)
    print(f"phase 15: (b) by {time.perf_counter() - t0:.1f} s", flush=True)
    phase15_sweep(src, cells)
    print(f"phase 15: (c) by {time.perf_counter() - t0:.1f} s", flush=True)
    phase15_wallclock(dev, launches)
    print(f"phase 15: (d) by {time.perf_counter() - t0:.1f} s", flush=True)
    print("phase 15 launches: " + json.dumps(launches), flush=True)
    missing = sorted(n for n in SHARDED_PATH if not launches.get(n))
    if missing:
        raise AssertionError(f"phase 15: kernels never launched on the "
                             f"sharded path: {missing}")
    print(f"phase 15: {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


PHASES = ("1", "2", "3", "4", "5", "6", "7", "8", "9", "10", "11", "12",
          "13", "14", "15")
# phase 3's profile: a part of a CUDA kernel's name -> its wrapper
WATCH_TRAIN = {"gmm_": "grouped_matmul", "gating_kernel": "topk_gating_fused",
               "positions_kernel": "topk_positions",
               "dispatch_kernel": "dispatch_rows",
               "combine_kernel": "combine_rows"}


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="On-card smoke test of the "
                                 "PyTorch port; with no arguments every "
                                 "phase, as the module docstring says.")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma list of the phases to run after phase 0 "
                    "(1-15; 1r: phase 1's two recurrences alone; 1m: its "
                    "five MoE routing kernels alone); the "
                    "kernels line is printed only when all run")
    ap.add_argument("--src", default=str(SRC),
                    help="the directory whose repro_torch is driven (another"
                    " tree's src, to time it on the same card)")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    if not set(phases) <= set(PHASES) | {"1r", "1m"}:
        ap.error(f"--phases: {args.phases}")
    src = Path(args.src).resolve()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port ({src / 'repro_torch'}) is missing",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    # deterministic cuBLAS for phase 3's bitwise resume check (read when
    # cuBLAS starts, so set before any work on the card: phases 1 and 2 run
    # under it too)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import H100
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    # the context and allocator up before any phase (a subset without
    # phase 1 starts with phase 2's memory-stat reset)
    torch.zeros((), device=dev)
    smi = smi_line()
    print(f"phase 0: {smi}", flush=True)
    print(f"phase 0: torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}; the port from {src}", flush=True)
    dt = _build.build_all()
    print(f"phase 0: built {len(_build.SOURCES)} kernel sources in "
          f"{dt:.2f} s", flush=True)
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill",
                                       "Performance Loss")):
                print(f"  ptxas {name}: {line.strip()}", flush=True)

    rows = {}
    if {"1", "1r", "1m"} & set(phases):
        phase1_floor(dev)
    if "1" in phases:
        print("phase 1: kernels against their plain versions", flush=True)
        rows = phase1(dev, H100)
    elif "1r" in phases:
        print("phase 1: the recurrences against their plain versions",
              flush=True)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        rows = phase1_recurrences(dev, H100, gen)
        rows.update(phase1_recurrence_grads(dev, H100, gen))
    if "1m" in phases:
        print("phase 1: the MoE routing kernels against their plain "
              "versions", flush=True)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        phase1_moe(dev, gen, make_recorder(H100, {}),
                   strict=src == SRC.resolve())
    serve = phase2(dev) if "2" in phases else None
    if "3" in phases:
        phase3_layer(dev)
        train_launches = phase3_train(dev)
        phase3_resume(dev)
    mixtral = phase4(dev) if "4" in phases else None
    rwkv = phase_served(dev, "rwkv6-1.6b", "phase 5") \
        if "5" in phases else None
    zamba = phase_served(dev, "zamba2-1.2b", "phase 6") \
        if "6" in phases else None
    ep_train = phase7(dev, strict=src == SRC.resolve()) \
        if "7" in phases else None
    serve_ep = phase8(dev) if "8" in phases else None
    llama4 = phase9(dev) if "9" in phases else None
    dense = phase10(dev) if "10" in phases else None
    frontends = phase11(dev) if "11" in phases else None
    control = phase12(dev, src) if "12" in phases else None
    train_rec = phase13(dev) if "13" in phases else None
    cells = phase14(dev, src) if "14" in phases else None
    sharded = phase15(dev, src, cells) if "15" in phases else None

    print(smi, flush=True)
    if set(phases) == set(PHASES):
        kernels = []
        for name in (*REPLACES, *BACKWARD):
            r = rows[name]
            paths = {"serve": serve[name], "train": train_launches[name],
                     "mixtral": mixtral[name], "rwkv": rwkv[name],
                     "zamba": zamba[name], "ep_train": ep_train[name],
                     "serve_ep": serve_ep[name], "llama4": llama4[name],
                     "dense": dense[name], "frontends": frontends[name],
                     "control": control[name],
                     "train_recurrent": train_rec[name],
                     "sharded": sharded.get(name, 0)}
            origin = {"replaces": REPLACES[name]} if name in REPLACES \
                else {"replaces": None, "backward_of": BACKWARD[name]}
            kernels.append({
                "name": name, "route": "cuda", "source": SOURCE[name],
                **origin, "launches": sum(paths.values()),
                **{f"launches_{p}": n for p, n in paths.items()},
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "device_ms": r["device_ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                "floor_ms": FLOOR["ms"],
                "floor_device_ms": FLOOR["device_ms"]})
        print(json.dumps({"kernels": kernels}), flush=True)
    else:
        print(f"phases run: 0, {', '.join(phases)} (no kernels line)",
              flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
