"""Architecture registry of the port: ``get_config(name)`` / ``--arch <id>``.

Holds the paper's §7.1 models, the family this slice serves; the other
architectures of the reference registry arrive with their model families.
"""
from repro_torch.configs.base import (
    ModelConfig, MoEConfig, SSMConfig, ShapeConfig, HardwareConfig,
    SHAPES, TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K, V5E, H100,
    applicable_shapes, skip_reason,
)
from repro_torch.configs.paper_models import (
    TRANSFORMER_XL, GPT2_MOE, BERT2GPT2, BERT_LARGE, with_experts,
)

PAPER = [TRANSFORMER_XL, GPT2_MOE, BERT2GPT2, BERT_LARGE]

REGISTRY = {c.name: c for c in PAPER}


def get_config(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return get_config(name[: -len("-smoke")]).smoke()
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(REGISTRY)}") from None


def list_archs() -> list:
    return [c.name for c in PAPER]
