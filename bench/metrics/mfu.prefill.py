"""Model FLOPs of the prompts served in the captured engine steps
(``yardstick.flops``: 2ND + attention a prompt, padding not counted)
over the captured window's seconds, as a share of the cards' bf16 dense
peak (989 TFLOP/s each)."""
from bench.yardstick.flops import H100_BF16_FLOPS


def read(rec):
    return 100.0 * rec["flops"] / rec["window_s"] \
        / (H100_BF16_FLOPS * rec["chips"])
