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

``shard_params`` cuts a full tree (params, or an ``OptState``) down to
one rank's part of a mesh, and ``unshard_params`` gathers it back over the
mesh's groups (the checkpoint's inverse), every leaf by its spec in a
``core.axes.Spec`` tree of the same structure (``launch.sharding``'s).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.collectives import axis_groups, gather_group
from repro_torch.core.moe import MoEParams
from repro_torch.devices import resolve_device
from repro_torch.models.attention import AttnParams
from repro_torch.models.lm import (FFNParams, GroupParams, HybridParams,
                                   LMParams, RWKVStack)
from repro_torch.models.rwkv import RWKVParams
from repro_torch.models.ssm import MambaParams
from repro_torch.tree import tree_map


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


def block_index(mesh, names) -> tuple:
    """(this rank's block, the block count) of a dim split over the axes
    ``names`` (major first)."""
    idx, n = 0, 1
    for a in names:
        idx = idx * mesh.size(a) + mesh.index(a)
        n *= mesh.size(a)
    return idx, n


def shard_leaf(w, mesh, spec):
    """This rank's block of ``w`` by ``spec``: a copy of its own where a
    dim is cut, else ``w`` itself."""
    whole = w
    for i in range(w.dim()):
        idx, n = block_index(mesh, spec.axes_of(i))
        if n == 1:
            continue
        if w.shape[i] % n:
            raise ValueError(f"dim {i} of {tuple(w.shape)} does not split "
                             f"over {spec.axes_of(i)} ({n} ranks)")
        blk = w.shape[i] // n
        w = w.narrow(i, idx * blk, blk)
    return w if w is whole else w.clone(memory_format=torch.contiguous_format)


def unshard_leaf(w, mesh, spec):
    """The whole of a leaf stored by ``spec``, gathered over the mesh's
    groups (every rank calls it)."""
    for i in range(w.dim()):
        for group in axis_groups(mesh, spec.axes_of(i)):
            w = gather_group(w, mesh, group, i)
    return w


def shard_params(params, mesh, specs):
    """This rank's part of a full tree: each leaf cut by its spec in
    ``specs`` (a ``core.axes.Spec`` tree of the same structure); the
    whole tree without a mesh."""
    if mesh is None:
        return params
    return tree_map(lambda w, s: shard_leaf(w, mesh, s), params, specs)


def unshard_params(params, mesh, specs):
    """The inverse of ``shard_params``: each leaf gathered over the axes
    of its spec.  Every rank of the mesh calls it."""
    if mesh is None:
        return params
    return tree_map(lambda w, s: unshard_leaf(w, mesh, s), params, specs)
