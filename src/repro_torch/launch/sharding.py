"""Sharding rules: the placement of every leaf of the params, the optimizer
state, the batch and the decode cache over a mesh (the reference's
``src/repro/launch/sharding.py``), as ``core.axes.Spec`` trees: FSDP over
(`pod`, `data`), tensor / expert parallel over `model` (and `tp`).

Rules, rule for rule as the reference's:
  column-parallel weights  [..., d, f]  -> (..., dp, mp)
  row-parallel weights     [..., f, d]  -> (..., mp, dp)
  experts                  [E, d, f]    -> (model, None, hid), hid = dp,
                                           or (tp,) + dp where `tp` exists
  embeddings               [V, d]       -> (mp, None)     (vocab-sharded)
  lm_head                  [d, V]       -> (dp, mp)
  SSM / RWKV stacks                     -> FSDP only (no TP)
With ``cfg.tensor_parallel`` False every axis is a data / FSDP axis.
``safe_spec`` drops the axes of a dim they do not divide (56 heads of 128
on a 16-way axis divide as columns; a vocab of 50257 divides nothing), as
the reference's ``models/layers.py::safe_spec``; the stored shards
(``convert.shard_params``) and the steps read the safe trees.

``expert_specs`` is the expert-parallel placement alone: the experts
over `model` (with ``fsdp`` their hidden dim over the data axes too),
every other leaf whole.  The serving engine (``runtime.server``) holds
its weights so, with the whole batch on every rank.

``Layout`` is a placement as the entry points read it (``models.lm``'s
``layout=``): ``layout_for`` builds the reference's, ``expert_layout``
the expert-parallel one.

The functions take any mesh with ``axis_names`` and ``shape``: the port's
``launch.mesh.Mesh`` (whose `pod` is folded into `data`), or a
``RecordingMesh`` over the reference's (pod, data, model) names.
"""
from __future__ import annotations

import copy
import math

from repro_torch.convert import block_index
from repro_torch.core import axes
from repro_torch.core.axes import Spec
from repro_torch.core.collectives import (all_reduce_grad, gather_axes,
                                          gather_grad, reduce_scatter_grad)
from repro_torch.core.moe import EXPERT_FIELDS, MoEParams
from repro_torch.models.attention import AttnParams, KVCache
from repro_torch.models.lm import (FFNParams, GroupParams, HybridParams,
                                   LMCache, LMParams, RWKVStack)
from repro_torch.models.rwkv import RWKVParams, RWKVState
from repro_torch.models.ssm import MambaParams, MambaState
from repro_torch.optim.adamw import OptState
from repro_torch.tree import tree_map

SERVE_FSDP_BUDGET = 10e9      # bf16 bytes a rank may hold without FSDP


def axis_size(mesh, names) -> int:
    """The product of the sizes of ``names`` (a name or a tuple) on
    ``mesh`` (1 for None)."""
    if names is None:
        return 1
    if isinstance(names, str):
        names = (names,)
    sizes = axes.axis_sizes(mesh)
    return math.prod(sizes.get(a, 1) for a in names)


def safe_spec(mesh, spec: Spec, shape) -> Spec:
    """Drop the axes of each dim they do not divide, so that no shard is
    padded (the reference's ``safe_spec``)."""
    out = []
    for i, dim in enumerate(shape):
        e = spec.entry(i)
        if e is not None and dim % axis_size(mesh, e):
            e = None
        out.append(e)
    return Spec(*out)


def safe_specs(mesh, spec_tree, value_tree):
    """``safe_spec`` over a tree: each leaf's spec against its shape (a
    leaf with no spec is replicated)."""
    return tree_map(lambda v, s: safe_spec(mesh, s or Spec(), v.shape),
                    value_tree, spec_tree)


def _dp(mesh) -> tuple:
    return axes.dp_axes(mesh)


def _tp(mesh) -> tuple:
    return axes.mp_axes(mesh)


def _attn_specs(dp, tp, lead) -> AttnParams:
    n = (None,) * lead
    return AttnParams(
        wq=Spec(*n, dp, tp), wk=Spec(*n, dp, tp), wv=Spec(*n, dp, tp),
        wo=Spec(*n, tp, dp),
        bq=Spec(*n, tp), bk=Spec(*n, tp), bv=Spec(*n, tp),
        q_norm=Spec(*n, None), k_norm=Spec(*n, None))


def _ffn_specs(dp, tp, lead) -> FFNParams:
    n = (None,) * lead
    return FFNParams(w_in=Spec(*n, dp, tp), w_up=Spec(*n, dp, tp),
                     w_out=Spec(*n, tp, dp))


def _prune(specs, params):
    """``specs`` where ``params`` has a leaf, None where it has none."""
    return tree_map(lambda p, s: s, params, specs)


def param_specs(cfg, mesh, params: LMParams) -> LMParams:
    """The ``Spec`` tree of ``params`` (full shapes) on ``mesh``, before
    ``safe_spec``."""
    if not cfg.tensor_parallel:
        dp = _dp(mesh) + _tp(mesh)
        tp = None
    else:
        dp = _dp(mesh)
        tp = _tp(mesh)

    st = params.stack
    if isinstance(st, HybridParams):
        stack = HybridParams(
            mamba=MambaParams(
                in_proj=Spec(None, dp, None), conv_w=Spec(None, None, None),
                conv_b=Spec(None, None), a_log=Spec(None, None),
                d_skip=Spec(None, None), dt_bias=Spec(None, None),
                norm=Spec(None, None), out_proj=Spec(None, dp, None)),
            ln_m=Spec(None, None), shared_attn=_attn_specs(dp, tp, 0),
            shared_ffn=_ffn_specs(dp, tp, 0), ln_s1=Spec(None),
            ln_s2=Spec(None))
    elif isinstance(st, RWKVStack):
        blk = RWKVParams(
            mu=Spec(None, None, None), w0=Spec(None, None),
            w_a=Spec(None, dp, None), w_b=Spec(None, None, None),
            wk=Spec(None, dp, None), wv=Spec(None, dp, None),
            wr=Spec(None, dp, None), wg=Spec(None, dp, None),
            u=Spec(None, None), wo=Spec(None, dp, None),
            ln_x=Spec(None, None), mu_c=Spec(None, None, None),
            ck=Spec(None, dp, None), cv=Spec(None, dp, None),
            cr=Spec(None, dp, None))
        stack = RWKVStack(blocks=blk, ln1=Spec(None, None),
                          ln2=Spec(None, None))
    else:
        hid = ((axes.TP,) + dp) if axes.TP in mesh.axis_names else dp
        # without tensor parallelism dp holds `model`, the experts' own
        # split, and `tp`: the reference's spec then names an axis twice,
        # which JAX refuses (its dp-only MoE cells do not compile); here
        # the hidden dim keeps each other axis once
        hid = tuple(dict.fromkeys(a for a in hid if a != axes.EP_AXIS))
        stack = GroupParams(
            attn=_attn_specs(dp, tp, 2),
            ln1=Spec(None, None, None), ln2=Spec(None, None, None),
            ffn=_ffn_specs(dp, tp, 2) if st.ffn is not None else None,
            moe=MoEParams(
                router=Spec(None, dp, None),
                wi=Spec(None, axes.EP_AXIS, None, hid),
                wu=Spec(None, axes.EP_AXIS, None, hid),
                wo=Spec(None, axes.EP_AXIS, hid, None),
            ) if st.moe is not None else None,
            shared=_ffn_specs(dp, tp, 1) if st.shared is not None else None)

    return _prune(LMParams(
        embed=Spec(tp if tp else dp, None),
        patch_proj=Spec(None, None), frame_proj=Spec(None, None),
        mask_emb=Spec(None), stack=stack, final_norm=Spec(None),
        lm_head=Spec(dp, tp)), params)


def opt_state_specs(param_spec_tree) -> OptState:
    """AdamW's moments placed as the params; the step replicated."""
    return OptState(step=Spec(), m=param_spec_tree, v=param_spec_tree)


def _mp_ranks(mesh) -> int:
    return axis_size(mesh, axes.MP_AXES)


def serve_uses_fsdp(cfg, mesh, budget_bytes: float = SERVE_FSDP_BUDGET
                    ) -> bool:
    """Whether serving keeps the training specs: bf16 weights over the
    model-parallel ranks pass ``budget_bytes``."""
    return 2.0 * cfg.param_count() / _mp_ranks(mesh) > budget_bytes


def serve_param_specs(cfg, mesh, params: LMParams,
                      budget_bytes: float = SERVE_FSDP_BUDGET) -> LMParams:
    """Serving shards weights over the model / tp axes only (replicated
    over the data axes) where that fits ``budget_bytes`` a rank; else
    (llama4, qwen2-72b at 16 ranks...) the training specs."""
    specs = param_specs(cfg, mesh, params)
    if serve_uses_fsdp(cfg, mesh, budget_bytes):
        return specs
    dp_names = set(axes.DP_AXES)

    def strip(spec):
        out = []
        for e in spec:
            if isinstance(e, tuple):
                kept = tuple(a for a in e if a not in dp_names)
                out.append(kept or None)
            else:
                out.append(None if e in dp_names else e)
        return Spec(*out)
    return tree_map(strip, specs)


def batch_split(mesh, global_batch: int) -> bool:
    """Whether a batch of ``global_batch`` rows splits over the data
    axes (else every rank holds it whole)."""
    return global_batch % axis_size(mesh, _dp(mesh)) == 0


def batch_specs(cfg, mesh, shape) -> dict:
    """The step batch's specs: rows over the data axes where they split,
    replicated over the model-parallel ones."""
    bs = _dp(mesh) if batch_split(mesh, shape.global_batch) else None
    out = {}
    if cfg.frontend == "audio_stub":
        out["frames"] = Spec(bs, None, None)
        if shape.kind == "train":
            out["labels"] = Spec(bs, None)
    else:
        out["tokens"] = Spec(bs, None)
        if shape.kind == "train":
            out["labels"] = Spec(bs, None)
        if cfg.frontend == "vision_stub":
            out["patches"] = Spec(bs, None, None)
    return out


CACHE_SPLITS = ("seq", "kv", "batch")


def cache_specs(cfg, mesh, cache: LMCache, split: str = "seq") -> LMCache:
    """The decode cache: batch over the data axes (where it splits), the
    KV cache's sequence over the model-parallel axes (decode attention
    then runs sequence-parallel, ``models.attention.decode_attention``).
    ``split`` takes the reference's dry-run variants of the KV cache
    (``src/repro/launch/dryrun.py:96-117``): "kv" (``kv_split``, on
    ``launch.mesh.kv_split_mesh``) its sequence over `tp` and its kv heads
    over `model`; "batch" (``cache_batch_only``) its rows alone split."""
    if split not in CACHE_SPLITS:
        raise ValueError(f"cache split {split!r}: one of {CACHE_SPLITS}")
    dp = _dp(mesh)
    bs = dp if batch_split(mesh, cache.pos.shape[0]) else None
    kv = mamba = rwkv = None
    if cache.kv is not None:
        lead = cache.kv.k.dim() - 4
        seq, heads = {"seq": (_tp(mesh), None), "kv": (axes.TP, axes.MODEL),
                      "batch": (None, None)}[split]
        kv = KVCache(*(Spec(*(None,) * lead, bs, seq, heads, None)
                       for _ in range(2)))
    if cache.mamba is not None:
        mamba = MambaState(h=Spec(None, bs, None, None, None),
                           conv=Spec(None, bs, None, None))
    if cache.rwkv is not None:
        rwkv = RWKVState(s=Spec(None, bs, None, None, None),
                         x_tm=Spec(None, bs, None),
                         x_cm=Spec(None, bs, None))
    return LMCache(kv, mamba, rwkv, Spec(bs))


class Layout:
    """A model's placement over a mesh, as the entry points read it
    (``models.lm``'s ``layout=``): the mesh, the ``core.axes.Spec`` tree
    of the stored params, the axes the step's batch rows are split over
    (major first; () for the whole batch on every rank) and the decode
    cache's spec tree, where there is one.

    ``gather`` is FSDP: a leaf's dims split over the data axes (every
    axis but the experts' `model` without ``cfg.tensor_parallel``) are
    all-gathered when its layer runs (autograd: the gradient is
    reduce-scattered back), which leaves each dim split over the
    model-parallel axes at most: that is tensor parallelism, over
    ``mp`` (the `model` and `tp` axes' group) of ``n`` ranks, this rank
    ``i``.  A split over a group of one rank moves nothing.

    ``for_sequence`` gives the view a Megatron sequence-parallel stack
    runs under (``cfg.seq_parallel``, the reference's carry constraint
    ``P(dp, tp_axes, None)`` in ``models/lm.py``; ``sp`` True): the
    carry is then rank i's slice [B, S / n, d] of the sequence.  The
    layers read the carry through three methods, which on a layout
    without SP are today's tensor parallelism: ``whole_seq`` gathers the
    slice whole before attention and a tensor-parallel FFN (its backward
    a reduce-scatter), ``reduce_out`` reduce-scatters their partial
    outputs back to the slice in place of ``reduce_mp``'s all-reduce (its
    backward an all-gather) and cuts a whole output to it, as
    ``own_seq`` does.  ``base`` is the layout without SP."""

    def __init__(self, mesh, specs, *, tensor_parallel: bool = True,
                 batch_axes: tuple = (), cache_specs=None):
        self.mesh, self.specs = mesh, specs
        self.batch_axes, self.cache_specs = tuple(batch_axes), cache_specs
        self.mp = mesh.mp_group
        self.n = mesh.group_size(self.mp)
        self.i = mesh.group_index(self.mp)
        self.fsdp_axes = set(axes.dp_axes(mesh))
        if not tensor_parallel:
            self.fsdp_axes |= set(axes.mp_axes(mesh))
        self.sp, self.base = False, self

    def _gather_leaf(self, w, spec, keep=()):
        for d in range(w.dim()):
            if d in keep:
                continue
            names = spec.axes_of(d)
            k = len(names)
            while k and names[k - 1] in self.fsdp_axes:
                k -= 1
            if any(a in self.fsdp_axes for a in names[:k]):
                raise NotImplementedError(
                    f"dim {d} of {spec}: the data axes must be the minor "
                    f"part of a split")
            fs = names[k:]
            if fs and math.prod(self.mesh.size(a) for a in fs) > 1:
                w = gather_axes(w, self.mesh, fs, d)
        return w

    def gather(self, tree, spec_tree, lead: int = 0):
        """``tree`` (this rank's stored leaves, their specs ``spec_tree``
        less ``lead`` leading dims) with every FSDP split gathered."""
        if tree is None:
            return None
        if isinstance(tree, MoEParams):       # experts stay over `model`
            return MoEParams(*(
                None if w is None else self._gather_leaf(
                    w, s.drop(lead), keep=(w.dim() - 3,)
                    if f in EXPERT_FIELDS else ())
                for f, w, s in zip(tree._fields, tree, spec_tree)))
        if isinstance(tree, tuple):
            parts = [self.gather(t, s, lead) for t, s in zip(tree, spec_tree)]
            return type(tree)(*parts) if hasattr(tree, "_fields") \
                else tuple(parts)
        return self._gather_leaf(tree, spec_tree.drop(lead))

    def gather_mp(self, w, dim: int):
        """``w``'s model-parallel split along ``dim`` gathered whole
        (autograd)."""
        return gather_grad(w, self.mesh, self.mp, dim)

    def reduce_mp(self, y):
        """A row-parallel product's partial sum ``y`` summed over the
        model-parallel group (autograd)."""
        return all_reduce_grad(y, self.mesh, self.mp)

    def for_sequence(self, s: int) -> "Layout":
        """The Megatron-SP view of this layout for a sequence of ``s``
        tokens (see the class doc), where it splits: a group of more than
        one rank, ``s`` tiling it (the reference's ``safe_spec``) and the
        same rows on every rank of it (a layout whose rows are split over
        `model` has no common sequence to split); else this layout."""
        if self.n == 1 or s % self.n or \
                set(axes.mp_axes(self.mesh)) & set(self.batch_axes):
            return self
        view = copy.copy(self)
        view.sp = True
        return view

    def whole_seq(self, x):
        """x [B, S, ...] whole along the sequence: under SP the group's
        slices [B, S / n, ...] gathered (autograd: the gradient
        reduce-scattered), else x itself."""
        return gather_grad(x, self.mesh, self.mp, 1) if self.sp else x

    def own_seq(self, x):
        """This rank's part of a whole x [B, S, ...]: under SP its
        sequence slice, else x itself."""
        if not self.sp:
            return x
        k = x.shape[1] // self.n
        return x.narrow(1, self.i * k, k)

    def reduce_out(self, y, partial: bool = True):
        """A layer's output y [B, S, ...] on the whole sequence as the
        carry holds it: a row-parallel partial sum (``partial``) summed
        over the model-parallel group, under SP reduce-scattered to this
        rank's slice (autograd: the gradient all-gathered), else
        all-reduced (``reduce_mp``); a whole y ``own_seq``'s part."""
        if not partial:
            return self.own_seq(y)
        if self.sp:
            return reduce_scatter_grad(y, self.mesh, self.mp, 1)
        return self.reduce_mp(y)


def layout_for(cfg, mesh, params: LMParams, kind: str = "train", *,
               global_batch: int | None = None, cache: LMCache = None,
               cache_split: str = "seq") -> Layout:
    """The reference's ``Layout`` of a ``kind`` step ("train", "prefill",
    "decode") on ``mesh``: ``param_specs`` (training) or
    ``serve_param_specs``, after ``safe_spec`` against ``params``' full
    shapes (``meta`` tensors do), the batch's rows over the data axes
    where a batch of ``global_batch`` rows splits there (None: it does)
    and, with the full ``cache``, its ``cache_specs`` (``cache_split``
    its variant)."""
    rule = param_specs if kind == "train" else serve_param_specs
    specs = safe_specs(mesh, rule(cfg, mesh, params), params)
    cspecs = None if cache is None else safe_specs(
        mesh, cache_specs(cfg, mesh, cache, cache_split), cache)
    split = True if global_batch is None else batch_split(mesh, global_batch)
    return Layout(mesh, specs, tensor_parallel=cfg.tensor_parallel,
                  batch_axes=_dp(mesh) if split else (), cache_specs=cspecs)


def expert_specs(mesh, tree, fsdp: bool = False):
    """The expert-parallel placement of ``tree`` (params, gradients or an
    ``OptState``; any nesting of tuples and dicts): each expert leaf of a
    ``MoEParams`` [.., E, d, f] / [.., E, f, d] split over `model` on E
    and, with ``fsdp``, over the data axes on its hidden dim; every other
    leaf whole."""
    hid = _dp(mesh) if fsdp else None
    if tree is None:
        return None
    if isinstance(tree, MoEParams):
        def one(f, w):
            if f not in EXPERT_FIELDS:
                return Spec()
            lead = (None,) * (w.dim() - 3)
            if f == "wo":
                return Spec(*lead, axes.EP_AXIS, hid, None)
            return Spec(*lead, axes.EP_AXIS, None, hid)
        return MoEParams(*(None if w is None else one(f, w)
                           for f, w in zip(tree._fields, tree)))
    if isinstance(tree, dict):
        return {k: expert_specs(mesh, v, fsdp) for k, v in tree.items()}
    if isinstance(tree, tuple):
        parts = [expert_specs(mesh, t, fsdp) for t in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") \
            else tuple(parts)
    return Spec()


def expert_layout(mesh, params, kind: str = "train",
                  fsdp: bool = False) -> Layout:
    """The expert-parallel ``Layout`` (``expert_specs``) of a ``kind``
    step: a training batch's rows over `data` and `model` (each rank its
    B / (dp * ep) rows), a serve step's whole batch on every rank (its MoE
    layers cut their own token shard)."""
    rows = () if kind != "train" else tuple(
        a for a in mesh.axis_names if a in (axes.DATA, axes.EP_AXIS))
    return Layout(mesh, expert_specs(mesh, params, fsdp), batch_axes=rows)


def local_rows(tree, mesh, global_batch: int, dim: int = 0):
    """This rank's rows of a batch tree (``batch_specs``: the rows over
    the data axes where they split, else the whole)."""
    if not batch_split(mesh, global_batch):
        return tree
    i, n = block_index(mesh, _dp(mesh))
    blk = global_batch // n
    return tree_map(lambda t: t.narrow(dim, i * blk, blk), tree)


def local_shape(mesh, shape, spec) -> tuple:
    """The shape of this rank's block of a leaf of ``shape``."""
    return tuple(n // axis_size(mesh, spec.axes_of(i))
                 for i, n in enumerate(shape))


def local_zeros(tree, mesh, specs, device):
    """Zeros of this rank's block shapes of ``tree`` (full shapes,
    ``meta`` will do) on ``device``, in its dtypes."""
    import torch
    return tree_map(lambda t, s: torch.zeros(
        local_shape(mesh, t.shape, s), dtype=t.dtype, device=device),
        tree, specs)


ONES = {"ln1", "ln2", "final_norm", "q_norm", "k_norm"}
ZEROS = {"bq", "bk", "bv"}


def init_shards(cfg, full: LMParams, mesh, specs, gen, device) -> LMParams:
    """Random shards drawn at this rank's block shapes of ``full`` (a tree
    of full shapes: ``meta`` will do), without the whole model: norms
    ones, biases zeros, every other leaf N(0, 1 / fan_in) of its full
    shape (the embedding's fan-in is d), as ``lm.init_params``' rules.
    Not any rank's block of ``init_params``' draws: for running rank 0's
    program where the whole model does not fit, through a ``MirrorMesh``,
    whose every rank holds these shards.  There the k model-parallel
    ranks' partial sums of a dim (a row-parallel weight's fan-in, the
    embedding's vocab) are k equal terms, which add k times where k
    independent ones add sqrt(k) times (and a looked-up row is held by
    one rank), so such a leaf is drawn at 1 / sqrt(k) of its scale (the
    embedding at 1 / k): the world of equal ranks then keeps the real
    model's activation scale, and its gradients stay finite.  The
    transformer family only."""
    import torch
    from repro_torch.models.layers import dense_init
    from repro_torch.tree import tree_items, tree_leaves, tree_unflatten_like
    if not isinstance(full.stack, GroupParams):
        raise NotImplementedError(f"{cfg.name}: init_shards draws the "
                                  f"transformer family's leaves only")
    dtype = full.embed.dtype
    out = []
    for (path, t), s in zip(tree_items(full), tree_leaves(specs)):
        shape = local_shape(mesh, t.shape, s)
        name = path.rsplit("/", 1)[-1]
        if name in ONES:
            out.append(torch.ones(shape, dtype=dtype, device=device))
        elif name in ZEROS:
            out.append(torch.zeros(shape, dtype=dtype, device=device))
        else:
            axis = -1 if name == "embed" else -2
            w = dense_init(gen, shape, axis, dtype=dtype, device=device)
            w.mul_((shape[axis] / t.shape[axis]) ** 0.5)
            summed = 0 if name == "embed" else t.dim() - 2
            k = axis_size(mesh, tuple(a for a in s.axes_of(summed)
                                      if a in axes.MP_AXES))
            out.append(w.div_(k if name == "embed" else k ** 0.5))
    return tree_unflatten_like(full, out)
