"""Device time a training step of the kernels launched inside the MoE
layer's calls (``core.moe.moe_layer``: forward and remat recompute) and
inside the backward of its own autograd Functions (gating, dispatch,
combine, the grouped FFN); PyTorch's backward of its other operations is
not counted."""


def read(rec):
    s = rec["inside_s"].get("moe_layer")
    return None if not s else 1e3 * s / rec["steps"]
