"""Architecture registry of the port: ``get_config(name)`` / ``--arch <id>``.

Holds the paper's §7.1 models and ``mixtral-8x22b`` (GQA, sliding-window
attention, swiglu experts), the MoE families the port serves and trains,
and ``rwkv6-1.6b`` (attention-free RWKV6) and ``zamba2-1.2b`` (Mamba2 with
a shared attention block), which it serves through ``models.lm``'s
``forward_prefill`` / ``decode_step``; the other architectures of the
reference registry arrive with their model families.
"""
from repro_torch.configs.base import (
    ModelConfig, MoEConfig, SSMConfig, ShapeConfig, HardwareConfig,
    SHAPES, TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K, V5E, H100,
    applicable_shapes, skip_reason,
)
from repro_torch.configs.mixtral_8x22b import CONFIG as MIXTRAL_8X22B
from repro_torch.configs.rwkv6_1_6b import CONFIG as RWKV6_1_6B
from repro_torch.configs.zamba2_1_2b import CONFIG as ZAMBA2_1_2B
from repro_torch.configs.paper_models import (
    TRANSFORMER_XL, GPT2_MOE, BERT2GPT2, BERT_LARGE, with_experts,
)

PAPER = [TRANSFORMER_XL, GPT2_MOE, BERT2GPT2, BERT_LARGE]
# of the reference's ASSIGNED architectures
PORTED = [MIXTRAL_8X22B, ZAMBA2_1_2B, RWKV6_1_6B]

REGISTRY = {c.name: c for c in PORTED + PAPER}


def get_config(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return get_config(name[: -len("-smoke")]).smoke()
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(REGISTRY)}") from None


def list_archs() -> list:
    return [c.name for c in PORTED + PAPER]
