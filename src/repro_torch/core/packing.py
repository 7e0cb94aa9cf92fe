"""Lina §4.2 expert packing: choose experts-per-device (powers of two) so
the expert-FFN micro-op time matches the all-to-all micro-op time.

A copy of the reference's analytic model (``src/repro/core/packing.py``)
on the port's hardware: the default is the ``H100`` HardwareConfig (bf16
tensor-core peak, NVLink bandwidth), not the TPU v5e.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import H100, HardwareConfig


@dataclass(frozen=True)
class PackingDecision:
    experts_per_device: int
    ffn_us: float          # one FFN micro-op, per packed device
    a2a_us: float          # one a2a micro-op
    pipeline_efficiency: float


def ffn_microop_time(tokens: int, d_model: int, d_ff: int, ffn_mult: int,
                     hw: HardwareConfig = H100) -> float:
    """us to run the expert FFN on `tokens` tokens (dense GEMM at the
    card's peak times ``hw.sim_efficiency``)."""
    flops = 2 * tokens * d_model * d_ff * ffn_mult
    return flops / (hw.peak_flops * hw.sim_efficiency) * 1e6


def a2a_microop_time(tokens: int, d_model: int, ep: int, bytes_per: int = 2,
                     hw: HardwareConfig = H100) -> float:
    """us for the dispatch a2a micro-op: each device sends (ep-1)/ep of its
    buffer over ``hw.ici_links`` links of ``hw.ici_bw``."""
    b = tokens * d_model * bytes_per
    eff = b * (ep - 1) / max(ep, 1)
    return eff / (hw.ici_links * hw.ici_bw) * 1e6


def choose_packing(tokens_per_microop: int, d_model: int, d_ff: int,
                   n_experts: int, ep: int, ffn_mult: int = 3,
                   max_pack: int = 8, hw: HardwareConfig = H100
                   ) -> PackingDecision:
    """Paper's policy: start at 1 expert/device, double until the FFN
    micro-op time exceeds the a2a micro-op time."""
    def ep_of(pack: int) -> int:
        return max(n_experts // pack, 1)

    def times(pack: int):
        f = ffn_microop_time(tokens_per_microop * pack, d_model, d_ff,
                             ffn_mult, hw=hw)
        a = a2a_microop_time(tokens_per_microop * pack, d_model, ep_of(pack),
                             hw=hw)
        return f, a

    pack = 1
    ffn, a2a = times(pack)
    while pack * 2 <= max_pack and ep_of(pack) > 1:
        pack *= 2
        ffn, a2a = times(pack)
        if ffn > a2a:
            break
    eff = min(ffn / a2a, 1.0) if a2a > 0 else 1.0
    return PackingDecision(pack, ffn, a2a, eff)
