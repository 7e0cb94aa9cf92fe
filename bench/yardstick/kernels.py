"""Kernel names as the profiler reports them: a frozen copy of
``chip_smoke.py``'s ``KERNEL_OWNERS`` (each of the port's CUDA kernels ->
the wrappers whose launch counters witness it, with its launches a
wrapper call), the name normalisation of ``chip_smoke.device_split``,
and the classes the per-layer metrics sum."""
from __future__ import annotations

import re

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
}

# library matrix products (cuBLAS, cuBLASLt, CUTLASS inside them)
GEMM = re.compile(r"gemm|xmma|cutlass|nvjet|cublas|Kernel2|splitK|"
                  r"^sm\d\d_|^ampere_|^volta_|^turing_", re.IGNORECASE)
COLLECTIVE = re.compile(r"nccl", re.IGNORECASE)


def short(name: str) -> str:
    """A kernel's name without arguments, templates and namespace."""
    return name.replace("(anonymous namespace)::", "").split("(")[0] \
        .split("<")[0].split("::")[-1].split()[-1] if name.strip() else name


def kind(name: str) -> str:
    """"port", "gemm", "collective" or "elementwise" (every other device
    operation: PyTorch's elementwise, reduction, copy and cast kernels,
    memcpy and memset)."""
    s = short(name)
    if s in KERNEL_OWNERS:
        return "port"
    if COLLECTIVE.search(name):
        return "collective"
    if GEMM.search(s) or GEMM.search(name):
        return "gemm"
    return "elementwise"
