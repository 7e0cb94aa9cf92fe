"""Config system: model/shape/mesh/run dataclasses shared by every layer.

Every assigned architecture is expressed as a ``ModelConfig``; the dry-run,
trainer, server, benchmarks and tests all consume the same object.  Reduced
("smoke") variants are derived mechanically so smoke tests always exercise the
same code path as the full config.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional, Sequence

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-Experts sub-config (Lina's subject matter)."""

    n_experts: int = 0
    top_k: int = 0
    d_ff: int = 0                 # expert hidden size
    every: int = 1                # MoE layer every `every`-th block
    shared_expert: bool = False   # llama4-style always-on shared expert
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    # Lina knobs
    n_microops: int = 4           # a2a tensor-partition count (micro-ops)
    pipeline_ffn: bool = True     # pipeline expert FFN with a2a micro-ops
    # ScMoE-style shortcut connection: the dense (shared-expert) branch is
    # computed *inside* the MoE shard body, ordered under the dispatch-a2a
    # shadow, and summed into the combine.  Requires shared weights (the
    # model allocates them when shortcut is set, like shared_expert).
    shortcut: bool = False
    experts_per_device: int = 1   # expert packing degree (power of two)
    # compute backend for the MoE hot paths (gating / grouped FFN / the
    # serving slot compute): "pallas" routes through the kernels.ops module,
    # "xla" keeps the plain tensor path, "auto" picks the kernels (the
    # plain version still runs for a CPU tensor; kernels.ops.resolve_backend).
    compute_backend: str = "auto"

    @property
    def enabled(self) -> bool:
        return self.n_experts > 0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2/RWKV6 state-space sub-config."""

    d_state: int = 0
    expand: int = 2
    head_dim: int = 64
    chunk: int = 128              # chunked-scan block length

    @property
    def enabled(self) -> bool:
        return self.d_state > 0


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                  # 0 => attention-free
    n_kv_heads: int
    d_ff: int                     # dense FFN hidden size
    vocab_size: int

    head_dim: int = 0             # 0 => d_model // n_heads
    ffn_type: str = "swiglu"      # swiglu | gelu
    qk_norm: bool = False
    qkv_bias: bool = False
    sliding_window: int = 0       # 0 => full attention
    rope_theta: float = 10_000.0
    causal: bool = True           # False => encoder-only (no decode shapes)
    tie_embeddings: bool = False
    norm_eps: float = 1e-5

    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)

    # layer pattern for hybrids: 'M' mamba2, 'A' attention, '*' attention
    # with *shared* weights (zamba2); empty => uniform attention stack.
    layer_pattern: str = ""

    # modality frontend: none | vision_stub | audio_stub.  Stub frontends
    # receive precomputed patch/frame embeddings via input_specs().
    frontend: str = "none"
    n_patches: int = 0            # vision stub: patches prepended to the text

    dtype: str = "bfloat16"
    param_dtype: str = "float32"  # optimizer-master dtype
    opt_state_dtype: str = "float32"
    remat: bool = True
    # sequence parallelism: shard the inter-block activations (and the saved
    # scan carry) over `model` — Megatron-SP; OFF for the paper-faithful
    # baseline, toggled in §Perf hillclimbs.
    seq_parallel: bool = False
    # tensor parallelism over `model`; False = pure DP/FSDP across all mesh
    # axes (the right choice for small models — §Perf hillclimb)
    tensor_parallel: bool = True

    notes: str = ""

    # -- derived -----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def attention_free(self) -> bool:
        return self.n_heads == 0

    @property
    def n_moe_layers(self) -> int:
        if not self.moe.enabled:
            return 0
        return self.n_layers // self.moe.every

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks), for roofline."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        total = emb
        ffn_mult = 3 if self.ffn_type == "swiglu" else 2
        attn = (self.n_heads * hd * d) * 2 + (self.n_kv_heads * hd * d) * 2
        n_attn_layers = self.n_layers
        if self.layer_pattern:
            pat = self._resolved_pattern()
            n_attn_layers = pat.count("A")
            shared = 1 if "*" in pat else 0
            n_mamba = pat.count("M") + pat.count("*") if self.ssm.enabled else 0
            # zamba2: '*' layers are mamba layers that also run the shared block
            n_mamba = pat.count("M") + pat.count("*")
            d_in = d * self.ssm.expand
            per_mamba = d * (2 * d_in + 2 * self.ssm.d_state) + d_in * d + 3 * d_in
            total += n_mamba * per_mamba
            total += shared * (attn + ffn_mult * d * f)
            total += n_attn_layers * (attn + ffn_mult * d * f)
        elif self.attention_free and self.ssm.enabled:
            # rwkv6: time-mix (~5 d^2 square mats + decay MLPs) + channel mix
            total += self.n_layers * (5 * d * d + 2 * d * f + d * f)
        else:
            total += n_attn_layers * attn
            n_moe = self.n_moe_layers
            n_dense = self.n_layers - n_moe
            total += n_dense * ffn_mult * d * f
            if self.moe.enabled:
                e_f = self.moe.d_ff or f
                per_expert = ffn_mult * d * e_f
                total += n_moe * self.moe.n_experts * per_expert
                if self.moe.shared_expert or self.moe.shortcut:
                    total += n_moe * per_expert
        return int(total)

    def active_param_count(self) -> int:
        """Activated params per token (MoE: only top_k experts count)."""
        if not self.moe.enabled:
            return self.param_count()
        full = self.param_count()
        e_f = self.moe.d_ff or self.d_ff
        ffn_mult = 3 if self.ffn_type == "swiglu" else 2
        per_expert = ffn_mult * self.d_model * e_f
        inactive = self.n_moe_layers * (self.moe.n_experts - self.moe.top_k) * per_expert
        return int(full - inactive)

    def _resolved_pattern(self) -> str:
        return self.layer_pattern

    def smoke(self) -> "ModelConfig":
        """Mechanically reduced config of the same family for CPU tests."""
        moe = self.moe
        if moe.enabled:
            moe = replace(moe, n_experts=min(moe.n_experts, 4),
                          top_k=min(moe.top_k, 2),
                          d_ff=min(moe.d_ff or 64, 64))
        ssm = self.ssm
        if ssm.enabled:
            ssm = replace(ssm, d_state=min(ssm.d_state, 16), head_dim=16,
                          chunk=16)
        n_layers = min(self.n_layers, 4 if not self.layer_pattern else 7)
        pat = self.layer_pattern[:n_layers] if self.layer_pattern else ""
        if pat and "*" not in pat and "*" in self.layer_pattern:
            pat = pat[:-1] + "*"
        n_heads = min(self.n_heads, 4) if self.n_heads else 0
        n_kv = min(self.n_kv_heads, n_heads) if n_heads else 0
        if self.n_kv_heads == self.n_heads:
            n_kv = n_heads  # keep MHA archs MHA
        elif self.n_kv_heads == 1:
            n_kv = 1        # keep MQA archs MQA
        return replace(
            self, name=self.name + "-smoke", n_layers=n_layers,
            d_model=64, n_heads=n_heads, n_kv_heads=n_kv,
            head_dim=16 if self.n_heads else 0,
            d_ff=128, vocab_size=min(self.vocab_size, 512),
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else 0,
            moe=moe, ssm=ssm, layer_pattern=pat,
            n_patches=min(self.n_patches, 8) if self.n_patches else 0,
            dtype="float32", param_dtype="float32", remat=False,
        )


# ---------------------------------------------------------------------------
# Input shapes (assigned per-arch shape set)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str        # train | prefill | decode | long_decode


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "long_decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def applicable_shapes(cfg: ModelConfig) -> list:
    """Shape cells that are well-defined for this arch (others are recorded
    as skips — see DESIGN.md §Arch-applicability)."""
    out = [TRAIN_4K, PREFILL_32K]
    if cfg.causal:
        out.append(DECODE_32K)
        subquadratic = (
            cfg.attention_free
            or bool(cfg.layer_pattern)          # hybrid: attn is periodic/shared
            or (cfg.sliding_window > 0)
        )
        if subquadratic:
            out.append(LONG_500K)
    return out


def skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    if shape.kind in ("decode", "long_decode") and not cfg.causal:
        return "encoder-only arch: no autoregressive decode step"
    if shape.kind == "long_decode":
        subq = cfg.attention_free or bool(cfg.layer_pattern) or cfg.sliding_window > 0
        if not subq:
            return "pure full attention: 512k KV cache is quadratic-cost; skipped per spec"
    return None


# ---------------------------------------------------------------------------
# Hardware model (TPU v5e) — used by the roofline analysis and benchmarks
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HardwareConfig:
    name: str = "tpu-v5e"
    peak_flops: float = 197e12       # bf16 FLOP/s per chip
    hbm_bw: float = 819e9            # bytes/s per chip
    ici_bw: float = 50e9             # bytes/s per link
    ici_links: int = 4               # links per chip on a 2D torus (x+/-, y+/-)
    hbm_bytes: float = 16e9          # v5e HBM capacity
    vmem_bytes: float = 128 * 2**20  # ~128MB VMEM
    # achieved-FLOPs factor used ONLY by the timeline simulator
    # (benchmarks/) to match measured step times; the roofline terms always
    # use peak.  A100 value calibrated so the baseline a2a fraction matches
    # the paper's Table 1 (~0.35); see EXPERIMENTS.md §Benchmarks.
    sim_efficiency: float = 0.5


V5E = HardwareConfig()

# The paper's testbed: 4x A100-40GB per node, 100Gbps InfiniBand.  The
# all-to-all/allreduce bottleneck lives on the NIC: 12.5 GB/s per node
# shared by 4 GPUs => ~3.1 GB/s effective per GPU.  Used by the benchmark
# harness to validate the reproduction against the paper's own numbers
# before reporting the v5e-adapted ones (DESIGN.md §2).
A100_IB = HardwareConfig(
    name="a100-100gbIB",
    peak_flops=312e12,
    hbm_bw=1555e9,
    ici_bw=3.125e9,
    ici_links=1,
    hbm_bytes=40e9,
    vmem_bytes=40 * 2**20,
    sim_efficiency=0.04,
)

# One NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, 700 W limit): the
# port's target.  ``peak_flops`` is the bf16 tensor-core rate, ``ici_bw``
# NVLink's 450 GB/s each way, ``vmem_bytes`` the shared memory one block may
# use.  ``chip_smoke.py`` computes each kernel's bound from these numbers.
H100 = HardwareConfig(
    name="h100-sxm",
    peak_flops=989e12,
    hbm_bw=3.35e12,
    ici_bw=450e9,
    ici_links=1,
    hbm_bytes=80e9,
    vmem_bytes=232_448,
)
