"""rwkv6-1.6b — Finch: attention-free, data-dependent decay. [arXiv:2404.05892; unverified]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=0,                  # attention-free
    n_kv_heads=0,
    d_ff=7168,
    vocab_size=65536,
    ssm=SSMConfig(d_state=64, expand=1, head_dim=64, chunk=64),
    notes="RWKV6 time-mix (data-dependent decay w) + channel-mix; "
          "O(1) state per token => long_500k applies.",
)
