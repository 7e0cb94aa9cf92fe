"""hubert-xlarge — encoder-only audio transformer. [arXiv:2106.07447; unverified]

Backbone only: the conv waveform frontend is a STUB; input_specs() provides
precomputed frame embeddings (B, n_frames, d_model).  Encoder-only => no
decode shapes.  Training objective: masked-unit prediction over 504 units.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,              # MHA
    d_ff=5120,
    vocab_size=504,             # k-means target units
    ffn_type="gelu",
    causal=False,               # bidirectional encoder
    frontend="audio_stub",
    notes="Same backbone family as wav2vec2; conv frontend stubbed.",
)
