"""Architecture registry of the port: ``get_config(name)`` / ``--arch <id>``.

Holds every architecture of the reference registry, in its order: the
assigned ten and the paper's §7.1 models.  The transformer family (dense
and MoE, llama4-maverick's interleaved MoE with a shared expert included)
is served and trained; ``rwkv6-1.6b`` (attention-free RWKV6) and
``zamba2-1.2b`` (Mamba2 with a shared attention block) are served through
``models.lm``'s ``forward_prefill`` / ``decode_step`` and trained through
``forward_train``.  ``llava-next-34b`` (a prefix of projected patch
embeddings before the tokens) and ``hubert-xlarge`` (an encoder over
projected audio frames, no decode) go through the same entry points
(``models.lm.embed_inputs``).
"""
from repro_torch.configs.base import (
    ModelConfig, MoEConfig, SSMConfig, ShapeConfig, HardwareConfig,
    SHAPES, TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K, V5E, H100,
    applicable_shapes, skip_reason,
)

from repro_torch.configs.granite_34b import CONFIG as GRANITE_34B
from repro_torch.configs.qwen3_8b import CONFIG as QWEN3_8B
from repro_torch.configs.qwen1_5_0_5b import CONFIG as QWEN1_5_0_5B
from repro_torch.configs.qwen2_72b import CONFIG as QWEN2_72B
from repro_torch.configs.llava_next_34b import CONFIG as LLAVA_NEXT_34B
from repro_torch.configs.llama4_maverick_400b_a17b import (
    CONFIG as LLAMA4_MAVERICK)
from repro_torch.configs.mixtral_8x22b import CONFIG as MIXTRAL_8X22B
from repro_torch.configs.zamba2_1_2b import CONFIG as ZAMBA2_1_2B
from repro_torch.configs.rwkv6_1_6b import CONFIG as RWKV6_1_6B
from repro_torch.configs.hubert_xlarge import CONFIG as HUBERT_XLARGE
from repro_torch.configs.paper_models import (
    TRANSFORMER_XL, GPT2_MOE, BERT2GPT2, BERT_LARGE, with_experts,
)

ASSIGNED = [
    GRANITE_34B, QWEN3_8B, QWEN1_5_0_5B, QWEN2_72B, LLAVA_NEXT_34B,
    LLAMA4_MAVERICK, MIXTRAL_8X22B, ZAMBA2_1_2B, RWKV6_1_6B, HUBERT_XLARGE,
]
PAPER = [TRANSFORMER_XL, GPT2_MOE, BERT2GPT2, BERT_LARGE]

REGISTRY = {c.name: c for c in ASSIGNED + PAPER}


def get_config(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return get_config(name[: -len("-smoke")]).smoke()
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(REGISTRY)}") from None


def list_archs() -> list:
    return [c.name for c in ASSIGNED]
