"""``models.attention``'s ``flash_attention_op``: the least time of every
captured call's work (``yardstick.roofline``: q, k, v read and the
output written once, 4 hd operations an unmasked (query, key) pair a
head; bytes at 3.35 TB/s or operations at the bf16 peak) over the device
time of its own kernel, which no other entry launches."""


def read(rec):
    e = rec["entries"].get("flash_attention")
    if not e or not e["calls"] or e["device_s"] <= 0:
        return None
    return 100.0 * e["bound_s"] / e["device_s"]
