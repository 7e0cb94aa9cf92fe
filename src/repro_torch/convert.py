"""The reference's parameters <-> the port's.

``from_reference`` takes the JAX package's ``LMParams`` as a tree of numpy
arrays (``jax.tree.map(np.asarray, params)``: the NamedTuples keep their
field names) with a transformer, hybrid (``HybridParams``) or RWKV
(``RWKVStack``) stack, and returns the port's ``LMParams`` with the same
numbers, so both packages compute the same function.  ``to_reference``
goes back: the port's params (or decode cache) into a numpy tree of the
structure of a reference tree the caller passes, so two trained models can
be compared leaf by leaf.  Both read fields by name and import
nothing of the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.moe import MoEParams
from repro_torch.devices import resolve_device
from repro_torch.models.attention import AttnParams
from repro_torch.models.lm import (FFNParams, GroupParams, HybridParams,
                                   LMParams, RWKVStack)
from repro_torch.models.rwkv import RWKVParams
from repro_torch.models.ssm import MambaParams


def _t(a, device):
    if a is None:
        return None
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _ffn(p, device):
    if p is None:
        return None
    return FFNParams(_t(p.w_in, device), _t(p.w_up, device),
                     _t(p.w_out, device))


def _named(cls, p, device):
    """``cls`` with each field read by name from ``p``."""
    return cls(*(_t(getattr(p, f), device) for f in cls._fields))


def _stack(st, device):
    if hasattr(st, "mamba"):                               # hybrid (zamba2)
        return HybridParams(
            _named(MambaParams, st.mamba, device), _t(st.ln_m, device),
            _named(AttnParams, st.shared_attn, device),
            _ffn(st.shared_ffn, device), _t(st.ln_s1, device),
            _t(st.ln_s2, device))
    if hasattr(st, "blocks"):                              # rwkv6
        return RWKVStack(_named(RWKVParams, st.blocks, device),
                         _t(st.ln1, device), _t(st.ln2, device))
    moe = None
    if st.moe is not None:
        moe = MoEParams(_t(st.moe.router, device), _t(st.moe.wi, device),
                        _t(st.moe.wu, device), _t(st.moe.wo, device))
    return GroupParams(_named(AttnParams, st.attn, device),
                       _t(st.ln1, device), _t(st.ln2, device),
                       _ffn(st.ffn, device), moe, _ffn(st.shared, device))


def from_reference(np_params, device="cuda") -> LMParams:
    """Reference ``LMParams`` (numpy leaves; transformer, hybrid or RWKV
    stack) -> port ``LMParams`` on ``device`` (the card by default; raises
    without one)."""
    device = resolve_device(device)
    for name in ("patch_proj", "frame_proj", "mask_emb"):
        if getattr(np_params, name, None) is not None:
            raise NotImplementedError(f"{name}: modality frontends are not "
                                      f"ported")
    stack = _stack(np_params.stack, device)
    return LMParams(_t(np_params.embed, device), stack,
                    _t(np_params.final_norm, device),
                    _t(np_params.lm_head, device))


def to_reference(params, like):
    """Port params (any tree of tensors: ``LMParams``, ``OptState`` moments)
    -> numpy arrays in the structure of ``like``, a reference tree with the
    same field names (its leaves only give the structure).  A bf16 leaf
    comes back as float32."""
    if like is None:
        return None
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(to_reference(getattr(params, f, None),
                                         getattr(like, f))
                            for f in like._fields))
    if params is None:
        raise ValueError("the port has no leaf where the reference has one")
    t = params.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
