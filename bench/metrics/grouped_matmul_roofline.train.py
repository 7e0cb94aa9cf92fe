"""``kernels.moe_ffn.grouped_matmul``: the least time of every captured
call's work (``yardstick.roofline``: bytes at 3.35 TB/s or operations at
the peak of its operands, bf16 or TF32) over the device time of its own
kernels, which no other entry launches."""


def read(rec):
    e = rec["entries"].get("grouped_matmul")
    if not e or not e["calls"] or e["device_s"] <= 0:
        return None
    return 100.0 * e["bound_s"] / e["device_s"]
