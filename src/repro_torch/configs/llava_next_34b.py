"""llava-next-34b — VLM; dense LM backbone + vision-stub frontend.

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified] — backbone only; the
anyres vision tower is a STUB: input_specs() provides precomputed patch
embeddings (B, n_patches, d_model) prepended to the text tokens.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    frontend="vision_stub",
    n_patches=576,              # 24x24 anyres base grid
    notes="LLaVA-NeXT-34B backbone (Yi-34B-like); anyres tiling stubbed.",
)
