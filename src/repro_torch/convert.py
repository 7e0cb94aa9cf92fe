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

``shard_params`` cuts a full tree (params, or an ``OptState``'s moments)
down to one rank's part of an expert-parallel mesh, and
``unshard_params`` gathers it back over the mesh's groups (the
checkpoint's inverse).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import axes
from repro_torch.core.moe import EXPERT_FIELDS, MoEParams, all_gather_rows
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
    stack; the frontends' ``patch_proj``, ``frame_proj`` and ``mask_emb``
    where the config has them) -> port ``LMParams`` on ``device`` (the card
    by default; raises without one)."""
    device = resolve_device(device)
    stack = _stack(np_params.stack, device)
    return LMParams(_t(np_params.embed, device),
                    _t(getattr(np_params, "patch_proj", None), device),
                    _t(getattr(np_params, "frame_proj", None), device),
                    _t(getattr(np_params, "mask_emb", None), device), stack,
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


def _map_experts(tree, fn):
    """``tree`` with each expert leaf w of a ``MoEParams`` replaced by
    fn(field name, w); other leaves kept."""
    if isinstance(tree, MoEParams):
        return MoEParams(*(fn(f, w) if f in EXPERT_FIELDS and w is not None
                           else w for f, w in zip(tree._fields, tree)))
    if isinstance(tree, dict):
        return {k: _map_experts(tree[k], fn) for k in sorted(tree)}
    if isinstance(tree, tuple):
        parts = [_map_experts(t, fn) for t in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") \
            else tuple(parts)
    return tree


def _hidden_dim(field: str, w) -> int:
    # wi / wu [.., E, d, f], wo [.., E, f, d]
    return w.dim() - (2 if field == "wo" else 1)


def shard_params(params, mesh, fsdp: bool = False):
    """This rank's part of a full tree: expert leaves cut to its E / ep
    experts (the `model` index picks them) and, with ``fsdp``, to 1 / dp
    of their hidden dim (the `data` index); every other leaf whole."""
    if mesh is None:
        return params
    ep, m = mesh.size(axes.EP_AXIS), mesh.index(axes.EP_AXIS)
    dp, d = mesh.size(axes.DATA), mesh.index(axes.DATA)

    def cut(field, w):
        e_dim = w.dim() - 3
        if w.shape[e_dim] % ep:
            raise ValueError(f"{w.shape[e_dim]} experts do not split over "
                             f"ep {ep}")
        w = w.chunk(ep, dim=e_dim)[m]
        if fsdp:
            h = _hidden_dim(field, w)
            if w.shape[h] % dp:
                raise ValueError(f"hidden dim {w.shape[h]} does not split "
                                 f"over dp {dp}")
            w = w.chunk(dp, dim=h)[d]
        # a copy of its own, so that the full tree can be freed (a slice
        # that happens to be contiguous would keep it alive)
        return w.clone(memory_format=torch.contiguous_format)
    if ep == 1 and not fsdp:
        return params
    return _map_experts(params, cut)


def _gather(w, group, dim):
    n = dist.get_world_size(group)
    wm = w.movedim(dim, 0).contiguous()
    out = wm.new_empty((n * wm.shape[0], *wm.shape[1:]))
    all_gather_rows(out, wm, group)
    return out.movedim(0, dim).contiguous()


def unshard_params(params, mesh, fsdp: bool = False):
    """The inverse of ``shard_params``: expert leaves gathered over the
    mesh's `model` group (and the data-parallel group with ``fsdp``).
    Every rank of the mesh calls it."""
    if mesh is None:
        return params

    def full(field, w):
        if fsdp:
            w = _gather(w, mesh.dp_group, _hidden_dim(field, w))
        return _gather(w, mesh.group(axes.EP_AXIS), w.dim() - 3)
    return _map_experts(params, full)
