"""Hand-written Hopper kernels of the serve path (CUDA C++ under ``csrc/``,
built at first use by ``_build``), their plain PyTorch versions (``ref``)
and the op layer the models call (``ops``).

``COUNTERS`` maps each kernel's name to its launch counter;
``reset_counters()`` sets them all to 0.
"""
from repro_torch.kernels._build import COUNTERS, reset_counters
from repro_torch.kernels import dispatch, moe_ffn, topk_gating  # noqa: F401 (registers counters)

__all__ = ["COUNTERS", "reset_counters"]
