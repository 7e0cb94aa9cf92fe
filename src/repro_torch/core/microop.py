"""Lina §4 on process groups: tensor partitioning into micro-ops, the
a2a <-> expert-FFN pipeline, and the prioritised gradient reduction
(the reference's ``src/repro/core/microop.py``).

  * ``exchange`` — blocks of dim 0 to the ranks of the mesh's `model`
    group (``Mesh.all_to_all``), the serve layer's all-to-all;
  * ``all_to_all_ec`` / ``all_to_all_ec_inverse`` — the expert-parallel
    exchange over the mesh's `model` group (``Mesh.all_to_all``),
    one ``torch.autograd.Function`` whose backward is the inverse exchange;
  * ``chunked_all_to_all``   — the exchange split along the capacity dim
    into uniform micro-ops;
  * ``pipelined_expert_ffn`` — chunk k's expert FFN runs on the compute
    stream while chunk k+1's dispatch all-to-all is in flight, and chunk
    k's return all-to-all is issued right behind it (Fig. 8b);
  * ``prioritized_chunked_reduce`` — the gradient all-reduce as uniform
    chunks of the flattened gradient vector, each issued async on the
    data-parallel group (Fig. 8a).

Ordering.  The reference orders collectives with a zero-valued token and
``optimization_barrier``.  Here the order is issue order plus CUDA stream
waits: a collective issued with ``async_op=True`` runs on its group's NCCL
stream, which waits at issue for the work already queued on the current
(compute) stream, and ``work.wait()`` makes the compute stream wait for the
collective.  The gradient reduction waits on ``Mesh.a2a_event``, recorded
on the compute stream after the newest all-to-all's ``work.wait()``, before
it issues its first chunk; so its all-reduce cannot start before the last
backward all-to-all has ended.  The chunks of one reduction queue on one
group's stream and run in issue order, one after another.  The `model`
group's stream has the higher priority (``launch.mesh``).  On gloo every
wait blocks the host; the values are the same.

The exchanges are differentiable on their own (the Function's backward
is the inverse exchange, waited for at once).  The MoE layer instead runs
``pipelined_expert_ffn`` inside one autograd node
(``core.moe._ExpertParallel``), whose backward is the same pipeline run on
dy: dy's exchange of chunk k+1 is in flight while chunk k's row-local
backward (dgrad) runs, chunk k's dx goes back right behind it, and the
weight gradients, one product over every chunk's rows, run under the last
return exchanges.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core import axes
from repro_torch.tree import tree_leaves, tree_unflatten_like


def _exchange(x: torch.Tensor, mesh, async_op: bool = False):
    """Blocks of x's dim 0 (one per `model` rank): block j goes to rank j;
    received block j came from rank j.  Returns (out, work or None)."""
    x = x.contiguous()
    out = torch.empty_like(x)
    work = mesh.all_to_all(out, x, mesh.group(axes.EP_AXIS),
                           async_op=async_op)
    return out, work


def exchange(x: torch.Tensor, mesh) -> torch.Tensor:
    """``_exchange`` waited for, without autograd (the serve layer's
    all-to-all to slot owners and back)."""
    return _exchange(x, mesh)[0]


class _AllToAll(torch.autograd.Function):
    """The exchange of ``_exchange``: it is its own adjoint (rank j's
    received block i is rank i's sent block j), so the backward is the
    same exchange of the gradient, waited for at once."""

    @staticmethod
    def forward(ctx, x, mesh, pending):
        ctx.mesh = mesh
        out, work = _exchange(x, mesh, async_op=pending is not None)
        if pending is not None:
            pending.append(work)
        else:
            mesh.mark("a2a")
        return out

    @staticmethod
    def backward(ctx, g):
        out, _ = _exchange(g, ctx.mesh)
        ctx.mesh.mark("a2a")
        return out, None, None


class Pending:
    """An async exchange's output and its work handle: ``wait()`` orders
    the collective before the compute stream's next work and returns the
    output."""

    def __init__(self, out, work, mesh):
        self.out, self.work, self.mesh = out, work, mesh

    def wait(self) -> torch.Tensor:
        if self.work is not None:
            self.work.wait()
            self.work = None
            self.mesh.mark("a2a")
        return self.out


def _a2a(x4, mesh, async_op: bool):
    if not async_op:
        return _AllToAll.apply(x4, mesh, None)
    works: list = []
    out = _AllToAll.apply(x4, mesh, works)
    return Pending(out, works[0], mesh)


def all_to_all_ec(buf: torch.Tensor, mesh, *, async_op: bool = False):
    """Expert-parallel exchange: local [E, C, d] -> [ep * E_local, C, d],
    the leading dim (source rank, local expert).  With ep ranks in the
    `model` group and E = ep * E_local, rank i sends rows
    [j*E_local, (j+1)*E_local) to rank j and receives the rows destined to
    its own experts from everyone.  ``async_op`` returns a ``Pending``."""
    ep = mesh.size(axes.EP_AXIS)
    e, c, d = buf.shape
    if e % ep:
        raise ValueError(f"experts {e} not divisible by ep {ep}")
    out = _a2a(buf.reshape(ep, e // ep, c, d), mesh, async_op)
    if async_op:
        out.out = out.out.reshape(e, c, d)
        return out
    return out.reshape(e, c, d)


def all_to_all_ec_inverse(buf: torch.Tensor, mesh, n_experts: int, *,
                          async_op: bool = False):
    """Inverse exchange: [ep * E_local, C, d] -> [E, C, d] back at the
    source."""
    ep = mesh.size(axes.EP_AXIS)
    ec, c, d = buf.shape
    out = _a2a(buf.reshape(ep, ec // ep, c, d), mesh, async_op)
    if async_op:
        out.out = out.out.reshape(n_experts, c, d)
        return out
    return out.reshape(n_experts, c, d)


def resolve_chunk_count(capacity: int, n_chunks: int) -> int:
    """Largest divisor of ``capacity`` that is <= ``n_chunks``.

    The paper's micro-ops are uniform, so the capacity dim must split
    evenly.  A requested count that does not divide C is resolved to the
    largest valid divisor; callers surface the chosen count."""
    capacity = int(capacity)
    n = max(1, min(int(n_chunks), capacity))
    while capacity % n:
        n -= 1
    return n


def chunked_all_to_all(buf: torch.Tensor, mesh, n_chunks: int,
                       inverse: bool = False, n_experts: int = 0) -> list:
    """[E, C, d] split along C into uniform a2a micro-ops; returns the list
    of exchanged chunks (its length is the resolved chunk count)."""
    n_chunks = resolve_chunk_count(buf.shape[1], n_chunks)
    pieces = torch.split(buf, buf.shape[1] // n_chunks, dim=1)
    if inverse:
        return [all_to_all_ec_inverse(p, mesh, n_experts) for p in pieces]
    return [all_to_all_ec(p, mesh) for p in pieces]


def pipelined_expert_ffn(buf: torch.Tensor, expert_fn: Callable, mesh,
                         n_chunks: int, n_experts: int,
                         pipeline: bool = True,
                         shadow: Optional[Callable] = None,
                         tail: Optional[Callable] = None) -> tuple:
    """Fig. 8b as a software pipeline on the compute and `model` streams.

    buf:        local dispatch buffers [E, C, d] (E = global expert count).
    expert_fn:  (rows [ep * E_local, c, d], start) -> same shape: the local
                experts on the received rows of capacity rows
                [start, start + c) of every source.
    shadow:     a callable run on the compute stream while chunk 0's
                dispatch is in flight (the ScMoE shortcut branch; in the
                backward, the recompute of h).
    tail:       a callable run on the compute stream once the last return
                all-to-all is issued, before any is waited for (in the
                backward, the weight gradients).
    Returns (combined local buffers [E, C, d], shadow's result or None,
    tail's result or None).

    Per iteration the issue order is the reference's

        dispatch-a2a(k+1)  ->  expert_fn(k)  ->  combine-a2a(k)

    and each exchange is waited for only where its result is consumed.
    With ``pipeline=False``: one a2a, the whole FFN, one a2a.  The mesh's
    timeline (``Mesh.mark``) notes each dispatch issued ("send"), each
    wait ("a2a"), each return issued ("return") and the tail ("tail")."""
    if not pipeline:
        n_chunks = 1
    n_chunks = resolve_chunk_count(buf.shape[1], n_chunks)
    c = buf.shape[1] // n_chunks
    pieces = torch.split(buf, c, dim=1)
    recv = all_to_all_ec(pieces[0], mesh, async_op=True)
    mesh.mark("send")
    side = shadow() if shadow is not None else None
    back = []
    for k in range(n_chunks):
        nxt = None
        if k + 1 < n_chunks:
            nxt = all_to_all_ec(pieces[k + 1], mesh, async_op=True)
            mesh.mark("send")
        out_k = expert_fn(recv.wait(), k * c)
        back.append(all_to_all_ec_inverse(out_k, mesh, n_experts,
                                          async_op=True))
        mesh.mark("return")
        recv = nxt
    after = None
    if tail is not None:
        mesh.mark("tail")
        after = tail()
    back = [p.wait() for p in back]
    combined = torch.cat(back, dim=1) if len(back) > 1 else back[0]
    return combined, side, after


# ---------------------------------------------------------------------------
# prioritized gradient reduction (backward path)
# ---------------------------------------------------------------------------

def flatten_tree(tree) -> tuple:
    """Leaves of ``tree`` -> (one flat vector, spec for ``unflatten_tree``).
    The leaves share one dtype."""
    leaves = tree_leaves(tree)
    shapes = [tuple(l.shape) for l in leaves]
    flat = torch.cat([l.reshape(-1) for l in leaves]) if leaves \
        else torch.zeros((0,))
    return flat, (tree, shapes)


def unflatten_tree(flat: torch.Tensor, spec):
    like, shapes = spec
    leaves, off = [], 0
    for shp in shapes:
        n = 1
        for s in shp:
            n *= s
        leaves.append(flat[off:off + n].reshape(shp))
        off += n
    return tree_unflatten_like(like, leaves)


class PendingReduce:
    """A chunked all-reduce in flight: ``wait()`` waits for every chunk
    and returns the reduced tree."""

    def __init__(self, works, flat, n, spec, denom):
        self.works, self.flat, self.n = works, flat, n
        self.spec, self.denom = spec, denom

    def wait(self):
        for w in self.works:
            w.wait()
        self.works = []
        red = self.flat[:self.n]
        if self.denom != 1:
            red = red / self.denom
        return unflatten_tree(red, self.spec)


def prioritized_chunked_reduce(grads, group, n_chunks: int, *,
                               after=None, mean: bool = True, mesh=None,
                               async_op: bool = False):
    """The all-reduce of ``grads`` over ``group`` as ``n_chunks`` uniform
    chunks of the flattened (zero-padded) vector, each issued async.  With
    ``after`` (a CUDA event) the compute stream waits on it first, so the
    first chunk cannot start before it.  ``mean`` divides by the group's
    size.  ``group`` is one of ``mesh``'s; None reduces over nothing
    (values pass through, as a one-rank group).  Returns the reduced tree, or with ``async_op`` a
    ``PendingReduce``."""
    flat, spec = flatten_tree(grads)
    n = flat.numel()
    size = mesh.group_size(group) if group is not None else 1
    if n == 0:
        pend = PendingReduce([], flat, 0, spec, 1)
        return pend if async_op else pend.wait()
    n_chunks = max(1, min(int(n_chunks), n))
    pad = (-n) % n_chunks
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    if after is not None:
        torch.cuda.current_stream().wait_event(after)
    works = []
    if group is not None:
        mesh.mark("reduce")
        for ch in torch.split(flat, flat.numel() // n_chunks):
            works.append(mesh.all_reduce(ch, group, async_op=True))
    pend = PendingReduce(works, flat, n, spec, size if mean else 1)
    return pend if async_op else pend.wait()
