"""The reference's parameters -> the port's.

``from_reference`` takes the JAX package's ``LMParams`` of the transformer
family as a tree of numpy arrays (``jax.tree.map(np.asarray, params)``:
the NamedTuples keep their field names) and returns the port's
``LMParams`` with the same numbers, so both packages compute the same
function.  It reads fields by name and imports nothing of the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.moe import MoEParams
from repro_torch.models.attention import AttnParams
from repro_torch.models.lm import FFNParams, GroupParams, LMParams


def _t(a, device):
    if a is None:
        return None
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _ffn(p, device):
    if p is None:
        return None
    return FFNParams(_t(p.w_in, device), _t(p.w_up, device),
                     _t(p.w_out, device))


def from_reference(np_params, device="cpu") -> LMParams:
    """Reference ``LMParams`` (numpy leaves, transformer family) -> port
    ``LMParams`` on ``device``."""
    st = np_params.stack
    if not hasattr(st, "attn"):
        raise NotImplementedError("only the transformer family is ported")
    for name in ("patch_proj", "frame_proj", "mask_emb"):
        if getattr(np_params, name, None) is not None:
            raise NotImplementedError(f"{name}: modality frontends are not "
                                      f"ported")
    a = st.attn
    attn = AttnParams(*(_t(getattr(a, f), device) for f in AttnParams._fields))
    moe = None
    if st.moe is not None:
        moe = MoEParams(_t(st.moe.router, device), _t(st.moe.wi, device),
                        _t(st.moe.wu, device), _t(st.moe.wo, device))
    stack = GroupParams(attn, _t(st.ln1, device), _t(st.ln2, device),
                        _ffn(st.ffn, device), moe, _ffn(st.shared, device))
    return LMParams(_t(np_params.embed, device), stack,
                    _t(np_params.final_norm, device),
                    _t(np_params.lm_head, device))
