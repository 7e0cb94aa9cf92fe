"""Model FLOPs of a training step (``yardstick.flops``: 6ND + attention,
recomputation not counted) over the mean step time of the run's own
untraced window, as a share of the cards' bf16 dense peak (989 TFLOP/s
each)."""
from bench.yardstick.flops import H100_BF16_FLOPS


def read(rec):
    return 100.0 * rec["step_flops"] / rec["window_step_s"] \
        / (H100_BF16_FLOPS * rec["chips"])
