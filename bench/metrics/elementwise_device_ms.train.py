"""Device time a training step of the operations that are neither the
port's kernels, nor a library matrix product, nor a collective:
PyTorch's elementwise, reduction, copy and cast kernels, memcpy and
memset (``yardstick.kernels.kind``)."""


def read(rec):
    s = rec["by_kind_s"].get("elementwise")
    return None if not s else 1e3 * s / rec["steps"]
