"""Where the port runs: entry points default to the card and never fall
back to the CPU on their own."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``"cuda"`` (the default of every entry point), ``"cuda:N"`` or
    ``"cpu"`` -> torch.device.  Asking for the card without one raises;
    the CPU runs the kernels' plain versions only when asked for."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' "
                               "(--device cpu) to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use cuda or cpu")
    return dev
