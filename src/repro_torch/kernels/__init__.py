"""Hand-written Hopper kernels of the serve and training paths (CUDA C++
under ``csrc/``, built at first use by ``_build``), their plain PyTorch
versions (``ref``) and the op layer the models call, with the backward of
each MoE op (``ops``), the prefill attention (``flash_attention_op``) and
the RWKV6 / Mamba2 recurrences (``rwkv6_op``, ``ssd_op``: differentiable,
each through a backward kernel of its own).

``COUNTERS`` maps each kernel's name to its launch counter;
``reset_counters()`` sets them all to 0.
"""
from repro_torch.kernels._build import COUNTERS, reset_counters
from repro_torch.kernels import (dispatch, flash_attention, moe_ffn,  # noqa: F401 (registers counters)
                                 rwkv6, ssd, topk_gating)
from repro_torch.kernels.ops import flash_attention_op, rwkv6_op, ssd_op

__all__ = ["COUNTERS", "reset_counters", "flash_attention_op", "rwkv6_op",
           "ssd_op"]
