"""The share of the captured window in which no operation ran on the
device (rank 0's card)."""


def read(rec):
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
