"""Least time of a kernel's work on one H100: a frozen copy of
``chip_smoke.py::bound_ms`` and of its byte and operation counts for
``grouped_matmul``, ``grouped_ffn`` and ``flash_attention``
(``unmasked_pairs`` included).  The work is counted from a call's shapes,
whatever kernel implements it; each input byte read once, each output
byte written once."""
from __future__ import annotations

import numpy as np

HBM_BYTES_S = 3.35e12          # NVIDIA H100 SXM data sheet
BF16_FLOPS = 989e12            # dense tensor-core rates
TF32_FLOPS = 495e12


def bound_ms(n_bytes: float, n_ops: float, peak: float = BF16_FLOPS):
    """max(bytes / HBM rate, ops / peak) in ms, and which bounds it."""
    tb = n_bytes / HBM_BYTES_S * 1e3
    to = n_ops / peak * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def grouped_matmul_ms(e: int, m: int, n: int, k: int, a_item: int,
                      b_item: int) -> float:
    """a [E, M, K] x b [E, K, N] -> fp32 [E, M, N]; the bf16 peak when
    both operands are bf16, else TF32's."""
    nbytes = e * m * k * a_item + e * k * n * b_item + e * m * n * 4
    peak = BF16_FLOPS if a_item == 2 and b_item == 2 else TF32_FLOPS
    return bound_ms(nbytes, 2 * e * m * n * k, peak)[0]


def grouped_ffn_ms(g: int, t: int, d: int, f: int, act: str, n_rows: int,
                   n_experts: int) -> float:
    """x [G, T, D] through ``n_experts`` distinct experts' weights (bf16),
    ``n_rows`` rows computed; the whole [G, T, D] output written."""
    n_w = 3 if act == "swiglu" else 2
    io_bytes = (n_rows * d + g * t * d) * 2
    w_bytes = n_w * d * f * 2
    return bound_ms(io_bytes + n_experts * w_bytes,
                    2 * n_w * n_rows * d * f)[0]


def unmasked_pairs(s: int, causal: bool, window: int) -> int:
    """(query, key) pairs of one head that the mask keeps."""
    i = np.arange(s, dtype=np.int64)
    hi = i + 1 if causal else np.full_like(i, s)
    lo = np.maximum(i - window + 1, 0) if window else np.zeros_like(i)
    return int((hi - lo).sum())


def flash_attention_ms(b: int, s: int, h: int, kv: int, hd: int,
                       causal: bool, window: int) -> float:
    nbytes = 2 * (2 * b * s * h * hd + 2 * b * s * kv * hd)
    return bound_ms(nbytes, 4 * hd * unmasked_pairs(s, causal, window)
                    * h * b)[0]
