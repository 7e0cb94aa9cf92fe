"""zamba2-1.2b — hybrid Mamba2 + shared attention blocks. [arXiv:2411.15242; hf]

38 Mamba2 layers; every 6th layer additionally runs a SHARED (single weight
set) attention+MLP block ('*' in the pattern).  ssm_state=64.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

# 38 layers: mamba everywhere, shared-attn tap every 6th layer.
_PATTERN = "".join("*" if (i + 1) % 6 == 0 else "M" for i in range(38))

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,              # shared block uses MHA
    d_ff=8192,
    vocab_size=32000,
    layer_pattern=_PATTERN,
    ssm=SSMConfig(d_state=64, expand=2, head_dim=64, chunk=128),
    tie_embeddings=True,
    notes="Zamba2: Mamba2 backbone + one shared attention block reused "
          "periodically; sub-quadratic => long_500k applies.",
)
