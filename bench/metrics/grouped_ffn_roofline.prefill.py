"""``kernels.moe_ffn.grouped_ffn``: the least time of every captured
call's work (``yardstick.roofline``: the rows routed to each slot, each
hosted expert's weights read once, the whole output written; bytes at
3.35 TB/s or operations at the bf16 peak) over the device time of its
own kernel, which no other entry launches."""


def read(rec):
    e = rec["entries"].get("grouped_ffn")
    if not e or not e["calls"] or e["device_s"] <= 0:
        return None
    return 100.0 * e["bound_s"] / e["device_s"]
