"""Lina §4 gradient reduction over process groups (the reference's
``src/repro/optim/reduce.py``).

The paper's training-side rule is *all-to-all goes first*: the gradient
all-reduce that runs beside the backward all-to-all yields to it (Figs.
5 / 7), and both are tensor-partitioned into uniform micro-ops (Fig. 8).
Here the reduction waits on the backward all-to-all's completion event
(``backward_a2a_token``) before it issues, and the `model` group's NCCL
stream has the higher priority (``launch.mesh``).

Five schedules, as the reference's:

  ``baseline``                      one all-reduce of the whole flattened
                                    gradient vector, no wait (Fig. 7a).
  ``priority``                      the same single op, issued after the
                                    backward all-to-all's event (Fig. 7b).
  ``fixed``                         Fig. 7c: deferred past the backward
                                    all-to-alls; in issue order this is the
                                    same single ordered op as ``priority``,
                                    as in the reference.
  ``priority+partition``            uniform chunks of ``partition_bytes``,
                                    each issued async after the event and
                                    queued on one stream (Fig. 8a).
  ``priority+partition+pipeline``   the chunked reduce of each microbatch
                                    issued before the next microbatch's
                                    forward and backward
                                    (``launch.steps.make_train_step``;
                                    per call the same as the one above).

Compression (``optim.compression``) wraps the chunked reduce: ``bf16``
all-reduces a bf16 payload; ``int8_ef`` quantizes with an error-feedback
residual carried across steps (``ReduceState``), sums the integers in
int32 (so the group's summands cannot overflow) and dequantizes.  The
ranks' gradients differ, so the int8 grid's scale is shared first: the
maximum of the ranks' scales, by a small ``all_reduce(MAX)``; with
replicated gradients that is the reference's arithmetic.

Which group reduces which gradient.  Every leaf is stored as its
``core.axes.Spec`` says (``launch.sharding``: the reference's specs, or
the expert-parallel placement ``expert_specs``).  Every collective of the
step's forward has its adjoint in the backward (an all-gather's is a
reduce-scatter, a sum all-reduce's a sum all-reduce, an all-to-all's the
inverse all-to-all), so a rank's autograd gradient of its shard is that of
the sum of every rank's loss L_r over the ranks that hold it, and the
global loss is the ranks' mean, L = (1 / W) sum_r L_r.  A leaf is then
summed over the axes its spec does not name (the ranks holding the same
shard) and divided by W:
  * a replicated leaf (a norm; with ``expert_specs`` every dense leaf) is
    summed over the world: the mean over the world group;
  * an expert leaf of rank (d, m) over `model`: the backward all-to-all
    brought the gradients of every rank (d, m') of its `model` group, and
    rank (d', m) holds the same experts: the mean over the data-parallel
    group, divided by ep;
  * a tensor-parallel leaf is summed over the data axes, the router and
    an FSDP-only leaf over `model` and `tp`;
  * a leaf split over every axis (FSDP experts and tensor-parallel
    weights: the FSDP gather's reduce-scatter summed it over `data`)
    takes no collective here and is divided by W.

``mesh=None`` reduces over nothing (a one-rank group): values pass
through, with compression's rounding.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from types import SimpleNamespace
from typing import NamedTuple, Optional

import torch

from repro_torch.core import axes, microop
from repro_torch.optim.compression import (Int8State, compress_int8_ef,
                                           init_int8_state, int8_scales)
from repro_torch.tree import tree_leaves, tree_unflatten_like

SCHEDULES = ("baseline", "priority", "fixed", "priority+partition",
             "priority+partition+pipeline")
COMPRESSIONS = (None, "bf16", "int8_ef")

# Fig. 15: 30MB micro-ops sit in the flat bottom of the partition-size sweep
DEFAULT_PARTITION_BYTES = 30e6


@dataclass(frozen=True)
class ReduceConfig:
    schedule: str = "baseline"
    partition_bytes: float = DEFAULT_PARTITION_BYTES
    compression: Optional[str] = None     # None | "bf16" | "int8_ef"

    def __post_init__(self):
        if self.schedule not in SCHEDULES:
            raise ValueError(f"unknown schedule {self.schedule!r}; "
                             f"expected one of {SCHEDULES}")
        if self.compression not in COMPRESSIONS:
            raise ValueError(f"unknown compression {self.compression!r}; "
                             f"expected one of {COMPRESSIONS}")

    @property
    def ordered(self) -> bool:
        return self.schedule != "baseline"

    @property
    def partitioned(self) -> bool:
        return "partition" in self.schedule


class ReduceState(NamedTuple):
    """Cross-step reducer state (the int8-EF residual)."""
    int8: Optional[Int8State]


def init_reduce_state(params, cfg: ReduceConfig) -> Optional[ReduceState]:
    """Per-parameter reducer state, or None when the reducer is stateless."""
    if cfg.compression == "int8_ef":
        return ReduceState(init_int8_state(params))
    return None


def n_chunks_for_bytes(grads, partition_bytes: float) -> int:
    """Uniform micro-op count for the flattened gradient vector (§4.2: no
    gradient-boundary bucketing, pure tensor partitioning)."""
    total = sum(l.numel() * l.element_size() for l in tree_leaves(grads))
    return max(1, math.ceil(total / max(float(partition_bytes), 1.0)))


def reduce_axes(mesh) -> tuple:
    """The data-parallel mesh axes the expert gradients reduce over."""
    return axes.dp_axes(mesh)


def _reduce_shard(grads, int8_state, after, *, group, cfg: ReduceConfig,
                  n_chunks: int, mesh=None):
    """Start the reduction (mean) of the tree ``grads`` over ``group``
    under ``cfg``.  Returns (a pending reduction whose ``wait()`` gives
    the reduced tree, the new int8 state)."""
    tok = after if cfg.ordered else None
    size = mesh.group_size(group) if group is not None else 1

    def run(tree, mean, finish):
        pend = microop.prioritized_chunked_reduce(
            tree, group, n_chunks, after=tok, mean=mean, mesh=mesh,
            async_op=True)
        return SimpleNamespace(wait=lambda: finish(pend.wait()))

    if cfg.compression == "bf16":
        g16 = tuple(g.to(torch.bfloat16) for g in tree_leaves(grads))
        return run(g16, True, lambda red: tree_unflatten_like(
            grads, [r.to(g.dtype) for r, g in
                    zip(red, tree_leaves(grads))])), int8_state
    if cfg.compression == "int8_ef":
        scales = int8_scales(grads, int8_state)
        if group is not None and scales:
            sc = torch.stack(scales)
            if tok is not None:
                torch.cuda.current_stream().wait_event(tok)
            mesh.all_reduce(sc, group, op="max")
            scales = list(sc.unbind())
        (qs, scales), new_state = compress_int8_ef(grads, int8_state,
                                                   scales)
        q32 = tuple(q.to(torch.int32) for q in tree_leaves(qs))
        return run(q32, False, lambda red: tree_unflatten_like(
            grads, [(s.float() * sc / size).to(g.dtype) for s, sc, g in
                    zip(red, scales, tree_leaves(grads))])), new_state
    return run(grads, True, lambda red: red), int8_state


def replica_axes(mesh, spec) -> tuple:
    """The axes of ``mesh`` that ``spec`` does not split: the ranks along
    them hold the same shard."""
    named = spec.names()
    return tuple(a for a in mesh.axis_names if a not in named)


def reduce_plan(mesh, grads, cfg: ReduceConfig, specs=None) -> list:
    """[(leaf indices, group, divisor, chunk count)]: how
    ``reduce_gradients`` splits ``grads`` (see the module doc): the leaves
    with the same replica axes in their ``specs`` summed (a mean, times the
    group's size) over their group and divided by W.  A group of None
    takes no collective."""
    leaves = tree_leaves(grads)
    if mesh is None:
        parts = [(list(range(len(leaves))), None, 1)]
    else:
        sp = tree_leaves(specs)
        if len(sp) != len(leaves):
            raise ValueError("the spec tree does not match the gradient "
                             "tree")
        by = {}
        for i, s in enumerate(sp):
            by.setdefault(replica_axes(mesh, s), []).append(i)
        parts = []
        for names, idx in by.items():
            group = mesh.group_for(names)
            n = 1 if group is None else mesh.group_size(group)
            parts.append((idx, group, mesh.world // n))
    out = []
    for idx, group, div in parts:
        if not idx:
            continue
        sub = tuple(leaves[i] for i in idx)
        n = n_chunks_for_bytes(sub, cfg.partition_bytes) \
            if cfg.partitioned else 1
        out.append((idx, group, div, n))
    return out


def reduce_gradients(mesh, grads, cfg: ReduceConfig, *, after=None,
                     state: Optional[ReduceState] = None,
                     async_op: bool = False, specs=None):
    """Lina's gradient reduction of this rank's ``grads``.

    mesh:   the training mesh (``launch.mesh.Mesh``), or None (one rank).
    after:  the backward all-to-all's completion event
            (``backward_a2a_token``), or None: nothing to wait for;
            ignored by ``baseline``.
    state:  ``ReduceState`` for int8-EF, else None.
    specs:  the leaves' ``Spec`` tree (with a mesh).

    Returns (reduced grads, new state); with ``async_op`` the first is a
    pending reduction whose ``wait()`` gives them."""
    int8_state = state.int8 if (state is not None and
                                cfg.compression == "int8_ef") else None
    if cfg.compression == "int8_ef" and int8_state is None:
        raise ValueError("schedule with int8_ef compression needs a "
                         "ReduceState (see init_reduce_state)")
    leaves = tree_leaves(grads)
    res = tree_leaves(int8_state.residual) if int8_state is not None \
        else None
    pends, new_res = [], list(res) if res is not None else None
    for idx, group, div, n in reduce_plan(mesh, grads, cfg, specs):
        sub = tuple(leaves[i] for i in idx)
        sub_state = Int8State(tuple(res[i] for i in idx)) \
            if res is not None else None
        if group is None and mesh is not None:
            # shards split over every axis: summed over the world already
            pend = SimpleNamespace(wait=lambda sub=sub: sub)
        else:
            pend, st = _reduce_shard(sub, sub_state, after, group=group,
                                     cfg=cfg, n_chunks=n, mesh=mesh)
            if st is not None:
                for i, r in zip(idx, tree_leaves(st.residual)):
                    new_res[i] = r
        pends.append((idx, div, pend))

    def finish():
        out = list(leaves)
        for idx, div, pend in pends:
            for i, r in zip(idx, tree_leaves(pend.wait())):
                out[i] = r / div if div != 1 else r
        return tree_unflatten_like(grads, out)

    new_state = state
    if int8_state is not None:
        new_state = ReduceState(Int8State(tree_unflatten_like(
            int8_state.residual, new_res)))
    if async_op:
        return SimpleNamespace(wait=finish), new_state
    return finish(), new_state


def backward_a2a_token(mesh):
    """The event the reduction waits on: the mesh's newest all-to-all,
    ordered on the compute stream (after a backward, the last backward
    all-to-all), or None: nothing to wait for (no mesh, the CPU, or no
    exchange yet)."""
    return None if mesh is None else mesh.a2a_event
