"""Process-group meshes: the port's counterpart of the reference's
``jax.make_mesh`` (``src/repro/launch/mesh.py``).

A ``Mesh`` is one rank's view of a ``(data, model)`` or ``(data, model,
tp)`` grid of ranks: its coordinates, a process group per axis, the
`model` and `tp` axes' group together (``mp_group``, the tensor-parallel
collectives' group: the reference's ``mp_axes``) and the world group.
Ranks are laid out row-major, rank = (d * ep + m) * tp + t, as
``jax.make_mesh`` orders devices.

Lina's §4 priority is a property of the communicators here: the `model`
(expert-parallel) group's NCCL communicator runs on a high-priority CUDA
stream and the `data` one at normal priority, so an all-to-all and a
gradient all-reduce that are in flight together share the card's SMs in
the all-to-all's favour.  The reference, with no streams to set, emulates
that with program order (its ``core/microop.py`` barriers).  gloo has no
streams; its groups take no options.

``init_distributed`` joins the job's group (``torchrun``'s environment, or
an explicit ``init_method``) or starts a one-rank group; NCCL on the card,
gloo on the CPU.  ``spawn_ranks`` is ``launch.train`` and
``launch.serve``'s ``--mesh DxE`` / ``DxExT``: under ``torchrun`` nothing
(each process joins the job's group), else for a mesh of more than one
rank it starts its ranks locally, each running the command's ``main``.
Nothing falls back: a mesh that needs more GPUs than the machine has
raises, and so does a failed NCCL init.

Every collective of the port goes through one ``Mesh`` method a kind
(``all_to_all``, ``all_reduce``, ``all_gather``, ``reduce_scatter``,
``broadcast``, ``barrier``).  With ``records`` a list, each call appends
a ``Record`` (kind, axis, group size, dtype, bytes) before it issues.  A
``RecordingMesh`` is rank 0 of a mesh of any shape with stand-in groups:
it records every collective and issues none, on ``meta`` tensors (the
dry run, ``launch.dryrun``); ``make_production_mesh`` gives the
reference's 16 x 16 and 2 x 16 x 16 meshes as recording meshes, and
``arch_mesh`` the reference's re-view of them for an arch whose experts do
not fill the `model` axis.  A ``MirrorMesh`` is a recording mesh whose
collectives also fill their results with what a world of ranks that all
hold this rank's tensors would return, so that rank 0 of a large mesh runs
its whole step on one card (``chip_smoke.py`` phase 15); there a
broadcast leaves its tensor as it is.
"""
from __future__ import annotations

import math
import os
import tempfile
from typing import Callable, NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.core import axes
from repro_torch.devices import resolve_device


def _local_device(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def init_distributed(device="cuda", init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> torch.device:
    """Join (or start) the default process group; returns this rank's
    device.  With ``init_method`` (and ``rank``, ``world_size``) it
    rendezvouses there; else under ``torchrun`` (``WORLD_SIZE`` set) it
    reads the environment; else it starts a one-rank group in-process."""
    dev = _local_device(device)
    if dist.is_initialized():
        return dev
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if init_method is not None:
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size)
    elif "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return dev


def _lines(shape, axis: int) -> list:
    """The rank lists along ``axis`` of a row-major grid of ``shape``: one
    list per coordinate of the other axes, in row-major order."""
    strides = [math.prod(shape[i + 1:]) for i in range(len(shape))]
    others = [i for i in range(len(shape)) if i != axis]
    out = []
    for flat in range(math.prod(shape[i] for i in others)):
        base, rem = 0, flat
        for i in reversed(others):
            base += (rem % shape[i]) * strides[i]
            rem //= shape[i]
        out.append([base + j * strides[axis] for j in range(shape[axis])])
    return sorted(out)


def _blocks(shape, idx) -> list:
    """The rank lists of the sub-grids spanned by the axes ``idx`` (the
    other axes fixed), each in row-major order."""
    if len(idx) == 1:
        return _lines(shape, idx[0])
    strides = [math.prod(shape[i + 1:]) for i in range(len(shape))]
    groups = {}
    for r in range(math.prod(shape)):
        key = tuple((r // strides[i]) % shape[i] for i in range(len(shape))
                    if i not in idx)
        groups.setdefault(key, []).append(r)
    return sorted(groups.values())


def _nccl_options(high_priority: bool):
    opts = dist.ProcessGroupNCCL.Options()
    opts.is_high_priority_stream = high_priority
    return opts


WORLD = "world"       # a record's axis for the world group

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class Record(NamedTuple):
    """One collective as issued: its kind (the reference's HLO op names,
    ``launch.hlo_analysis``), the group's axis (or ``WORLD``), the group's
    size, the dtype and the byte size of its result (the gathered tensor
    of an all-gather, the scattered block of a reduce-scatter)."""
    kind: str
    axis: str
    group_size: int
    dtype: str
    nbytes: int


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class Mesh:
    """One rank's view of the process-group grid (see the module doc).

    ``a2a_event`` is a CUDA event recorded on the compute stream once the
    newest all-to-all's result is ordered before it (None on the CPU, or
    before any exchange): the "backward all-to-all done" marker the
    gradient reduction waits on.  With ``timeline`` a list, every
    collective of ``core.microop`` appends (kind, timed event) pairs to it
    (kinds "a2a" and "reduce"), and so does each step of its expert
    pipeline ("send", "return", "tail"), for ordering checks: the event
    is None off the card, where only the order is kept."""

    def __init__(self, shape, axis_names, device: torch.device):
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        self.device = device
        self.backend = dist.get_backend()
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        strides = [math.prod(self.shape[i + 1:])
                   for i in range(len(self.shape))]
        self.coords = {a: (self.rank // st) % n for a, st, n in
                       zip(self.axis_names, strides, self.shape)}
        self.groups = {}
        # every rank creates every group, in the same order
        for i, a in enumerate(self.axis_names):
            for ranks in _lines(self.shape, i):
                kw = {}
                if self.backend == "nccl":
                    kw["pg_options"] = _nccl_options(a == axes.EP_AXIS)
                g = dist.new_group(ranks, **kw)
                if self.rank in ranks:
                    self.groups[a] = g
        self._mp = None
        if axes.TP in self.axis_names:
            idx = [self.axis_names.index(a) for a in axes.MP_AXES]
            for ranks in _blocks(self.shape, idx):
                g = dist.new_group(ranks)
                if self.rank in ranks:
                    self._mp = g
        self.world_group = dist.group.WORLD
        self.a2a_event = None
        self.timeline = None
        self.records = None

    def size(self, axis: str) -> int:
        return axes.axis_sizes(self).get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        return self.groups[axis]

    @property
    def dp_group(self):
        """The data-parallel group (`pod` is folded into `data`)."""
        return self.group_for(axes.dp_axes(self))

    @property
    def mp_group(self):
        """The tensor-parallel group: `model`, with `tp` where the mesh
        has it (ranks `model`-major)."""
        return self.group_for(axes.mp_axes(self))

    def group_for(self, names):
        """The group spanning the axes ``names`` (a name or a tuple, the
        first major): one axis's group, `model` and `tp` together, or the
        world; None for no axis.  Another set of axes has no group here
        and raises."""
        names = (names,) if isinstance(names, str) else tuple(names)
        names = tuple(a for a in names if a in self.axis_names)
        if not names:
            return None
        if len(names) == 1:
            return self.groups[names[0]]
        if names == tuple(self.axis_names):
            return self.world_group
        if names == axes.MP_AXES and self._mp is not None:
            return self._mp
        raise NotImplementedError(f"no group of {self!r} spans {names}")

    def group_size(self, group) -> int:
        return group.size()

    def group_index(self, group) -> int:
        """This rank's index in ``group`` (row-major over its axes)."""
        if group is self.world_group:
            return self.rank
        if group is self._mp:
            t = self.size(axes.TP)
            return self.index(axes.MODEL) * t + self.index(axes.TP)
        return self.index(self.axis_of(group))

    def axis_of(self, group) -> str:
        """The mesh axis ``group`` spans (``WORLD`` for the world group,
        ``axes.MP_GROUP`` for `model` and `tp` together)."""
        if group is self.world_group:
            return WORLD
        if group is self._mp and group is not None:
            return axes.MP_GROUP
        for a, g in self.groups.items():
            if g is group:
                return a
        raise ValueError(f"{group!r} is not a group of {self!r}")

    # -- collectives: the one path of the port's real and recorded ones --

    def _record(self, kind: str, group, t) -> None:
        if self.records is not None:
            self.records.append(Record(
                kind, self.axis_of(group), self.group_size(group),
                str(t.dtype).replace("torch.", ""), _nbytes(t)))

    def _issue(self, fn: Callable):
        return fn()

    def all_to_all(self, out, x, group, *, async_op: bool = False):
        """Blocks of ``x``'s dim 0 to the group's ranks, into ``out``."""
        self._record("all-to-all", group, out)
        return self._issue(lambda: dist.all_to_all_single(
            out, x, group=group, async_op=async_op))

    def all_reduce(self, t, group, *, op: str = "sum",
                   async_op: bool = False):
        """``t`` reduced in place over ``group`` (``op`` "sum" or "max")."""
        self._record("all-reduce", group, t)
        return self._issue(lambda: dist.all_reduce(
            t, op=_OPS[op], group=group, async_op=async_op))

    def all_gather(self, out, x, group) -> None:
        """``out`` [n * x0, ...] = the group's ``x`` [x0, ...] in rank
        order (``all_gather_single``, named ``all_gather_into_tensor``
        before)."""
        self._record("all-gather", group, out)
        fn = getattr(dist, "all_gather_single", None) or \
            dist.all_gather_into_tensor
        self._issue(lambda: fn(out, x, group=group))

    def reduce_scatter(self, out, x, group) -> None:
        """``out`` [x0 / n, ...] = this rank's block of the group's summed
        ``x`` (``reduce_scatter_single``, ``reduce_scatter_tensor``
        before)."""
        self._record("reduce-scatter", group, out)
        fn = getattr(dist, "reduce_scatter_single", None) or \
            dist.reduce_scatter_tensor
        self._issue(lambda: fn(out, x, group=group))

    def broadcast(self, t, src: int, group) -> None:
        """``t`` replaced in place by the tensor of the group's rank
        ``src`` (its index in ``group``): the serving engine's request
        router (``runtime.engine``)."""
        self._record("broadcast", group, t)

        def run():
            root = src if group is self.world_group else \
                dist.get_global_rank(group, src)
            return dist.broadcast(t, src=root, group=group)
        self._issue(run)

    def barrier(self) -> None:
        if self.records is not None:
            self.records.append(Record("barrier", WORLD, self.world,
                                       "none", 0))
        self._issue(dist.barrier)

    def mark(self, kind: str) -> None:
        """Record that the compute stream has reached ``kind``: "a2a", a
        collective ordered before its next work, or a step of
        ``core.microop`` (see the class doc)."""
        if kind != "a2a" and self.timeline is None:
            return
        ev = None
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=self.timeline is not None)
            ev.record()
            if kind == "a2a":
                self.a2a_event = ev
        if self.timeline is not None:
            self.timeline.append((kind, ev))

    def stream_priorities(self) -> dict:
        """{axis: (is_high_priority_stream as the communicator's options
        read back, or None on gloo)}."""
        out = {}
        for a, g in self.groups.items():
            if self.backend != "nccl":
                out[a] = None
                continue
            backend = g._get_backend(self.device)
            out[a] = bool(backend.options.is_high_priority_stream)
        return out

    def __repr__(self):
        dims = "x".join(str(s) for s in self.shape)
        return (f"Mesh({dims} {self.axis_names}, rank {self.rank} at "
                f"{self.coords}, {self.backend})")


def make_mesh(shape, axis_names=None, device="cuda"):
    """The ``Mesh`` of ``shape`` over ``axis_names`` (default
    ``mesh_axes(shape)``) for this rank, joining or starting the default
    group first (``init_distributed``).  The
    world must hold exactly prod(shape) ranks; on the card, one GPU each.
    Every rank calls it (it creates the groups); a process makes one mesh
    and passes it on."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    dev = resolve_device(device)
    if dev.type == "cuda":
        gpus = torch.cuda.device_count()
        if n > gpus:
            raise RuntimeError(f"a {'x'.join(map(str, shape))} mesh needs "
                               f"{n} GPUs; this machine has {gpus}")
    dev = init_distributed(device)
    if dist.get_world_size() != n:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {n} "
                         f"ranks; the process group has "
                         f"{dist.get_world_size()}")
    return Mesh(shape, axis_names or mesh_axes(shape), dev)


class StandInGroup:
    """A recording mesh's process group: its axis and size, nothing to
    talk to."""

    def __init__(self, axis: str, size: int):
        self.axis, self._size = axis, int(size)

    def size(self) -> int:
        return self._size

    def __repr__(self):
        return f"StandInGroup({self.axis}, {self._size})"


class _Done:
    """The work handle of a recorded collective: nothing to wait for (a
    blocking one's is returned too, and its caller drops it)."""

    def wait(self) -> None:
        return None


class RecordingMesh(Mesh):
    """Rank 0 of a ``shape`` mesh over ``axis_names``, seen from one
    process with no process group: each group is a ``StandInGroup``,
    each collective is recorded in ``records`` and issues nothing (its
    output is the tensor the caller allocated, on ``meta`` in the dry
    run).  The same ``Mesh`` methods as a real mesh's, so a step issues
    the same calls on both."""

    def __init__(self, shape, axis_names=None, device="meta",
                 rank: int = 0):
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names or mesh_axes(self.shape))
        self.device = torch.device(device)
        self.backend = "record"
        self.world = math.prod(self.shape)
        self.rank = int(rank)
        strides = [math.prod(self.shape[i + 1:])
                   for i in range(len(self.shape))]
        self.coords = {a: (self.rank // st) % n for a, st, n in
                       zip(self.axis_names, strides, self.shape)}
        self.groups = {a: StandInGroup(a, n)
                       for a, n in zip(self.axis_names, self.shape)}
        self._mp = StandInGroup(axes.MP_GROUP, math.prod(
            self.groups[a].size() for a in axes.MP_AXES)) \
            if axes.TP in self.axis_names else None
        self.world_group = StandInGroup(WORLD, self.world)
        self.a2a_event = None
        self.timeline = None
        self.records = []

    def _issue(self, fn: Callable):
        return _Done()

    def __repr__(self):
        dims = "x".join(str(s) for s in self.shape)
        return (f"RecordingMesh({dims} {self.axis_names}, rank {self.rank}, "
                f"{self.device})")


class MirrorMesh(RecordingMesh):
    """A ``RecordingMesh`` whose collectives also compute: each fills its
    result with what the collective returns when every rank of the group
    holds this rank's tensor (an all-gather tiles the input n times, a sum
    all-reduce multiplies it by n and a max one keeps it, a reduce-scatter
    gives n times this rank's block, an all-to-all this rank's block n
    times, a broadcast keeps it: ``RecordingMesh.broadcast``), in place
    and with no allocation beyond a recording mesh's.  Those are the values of a world whose ranks all hold equal shards, not
    rank 0's values in a real world; what it runs and allocates is rank
    0's, so the dry run's peak and records can be held against a card."""

    def __init__(self, shape, axis_names=None, device="cuda",
                 rank: int = 0):
        super().__init__(shape, axis_names, device=device, rank=rank)

    def all_to_all(self, out, x, group, *, async_op: bool = False):
        self._record("all-to-all", group, out)
        n, i = self.group_size(group), self.group_index(group)
        blk = x.shape[0] // n
        out.view(n, blk, *x.shape[1:]).copy_(x[i * blk:(i + 1) * blk][None])
        return _Done()

    def all_reduce(self, t, group, *, op: str = "sum",
                   async_op: bool = False):
        self._record("all-reduce", group, t)
        if op == "sum":
            t.mul_(self.group_size(group))
        return _Done()

    def all_gather(self, out, x, group) -> None:
        self._record("all-gather", group, out)
        out.view(self.group_size(group), *x.shape).copy_(x[None])

    def reduce_scatter(self, out, x, group) -> None:
        self._record("reduce-scatter", group, out)
        n, i = self.group_size(group), self.group_index(group)
        blk = out.shape[0]
        out.copy_(x[i * blk:(i + 1) * blk]).mul_(n)

    def __repr__(self):
        dims = "x".join(str(s) for s in self.shape)
        return (f"MirrorMesh({dims} {self.axis_names}, rank {self.rank}, "
                f"{self.device})")


def make_production_mesh(multi_pod: bool = False, device="meta"):
    """The reference's production mesh as a ``RecordingMesh``: 16 x 16
    (data, model), or with ``multi_pod`` 32 x 16, its `pod` axis of 2
    folded into `data`.  The reference's gradient reduction spans (pod,
    data) as one group (``core.axes.DP_AXES``), so every group here has
    the size of the reference's: the data-parallel group 32 ranks, the
    `model` group 16."""
    return RecordingMesh((32 if multi_pod else 16, 16),
                         (axes.DATA, axes.MODEL), device=device)


def arch_mesh(cfg, multi_pod: bool = False, device="meta"):
    """The production mesh re-viewed for ``cfg``, as the reference's
    ``arch_mesh``: where the expert count is below 16 and divides it, the
    16-way `model` axis splits into (`model` = E, `tp` = 16 / E), so the
    all-to-all runs over E ranks and each expert's hidden dim is sliced
    over `tp` (DeepSpeed-MoE expert slicing): mixtral-8x22b's 8 experts
    give (16, 8, 2), or (32, 8, 2) with `pod` folded into `data`.  Ranks
    keep their order.  Otherwise ``make_production_mesh``."""
    e = cfg.moe.n_experts if cfg.moe.enabled else 0
    if not e or 16 % e or e >= 16:
        return make_production_mesh(multi_pod, device=device)
    return RecordingMesh((32 if multi_pod else 16, e, 16 // e),
                         (axes.DATA, axes.MODEL, axes.TP), device=device)


def kv_split_mesh(cfg, multi_pod: bool = False, device="meta"):
    """The production mesh re-viewed for the reference's ``kv_split``
    decode variant (``src/repro/launch/dryrun.py:66-78``): where the kv
    heads divide 16, the 16-way `model` axis splits into (`model` = kv
    heads, `tp` = 16 / kv heads), so that the KV cache's kv heads split
    over `model` and its sequence over `tp`
    (``launch.sharding.cache_specs``' "kv"); None where they do not
    divide.  Ranks keep their order."""
    kvh = cfg.n_kv_heads
    if not kvh or 16 % kvh:
        return None
    return RecordingMesh((32 if multi_pod else 16, kvh, 16 // kvh),
                         (axes.DATA, axes.MODEL, axes.TP), device=device)


def mesh_axes(shape) -> tuple:
    """The axis names of a mesh of ``shape``: (data, model), or (data,
    model, tp) for three sizes."""
    return (axes.DATA, axes.MODEL, axes.TP)[:len(shape)]


def parse_mesh(spec: str) -> tuple:
    """"DxE" -> (D, E); "DxExT" -> (D, E, T) (`tp` expert slicing)."""
    try:
        sizes = tuple(int(v) for v in spec.lower().split("x"))
    except ValueError as e:
        raise ValueError(f"--mesh {spec!r}: expected DxE or DxExT, e.g. "
                         f"2x2 or 1x2x2") from e
    if len(sizes) not in (2, 3):
        raise ValueError(f"--mesh {spec!r}: expected DxE or DxExT")
    if min(sizes) < 1:
        raise ValueError(f"--mesh {spec!r}: sizes must be >= 1")
    return sizes


def dp_size(mesh) -> int:
    sizes = axes.axis_sizes(mesh)
    return sizes.get(axes.POD, 1) * sizes.get(axes.DATA, 1)


def ep_size(mesh) -> int:
    return axes.axis_sizes(mesh).get(axes.MODEL, 1)


def tp_axes(mesh):
    """The tensor-parallel axes: `model` plus `tp` when present."""
    return axes.mp_axes(mesh)


def _spawned(rank, main, argv, world, init_method, device):
    """One spawned rank: join the group, then run ``main``."""
    if device == "cpu":              # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    init_distributed(f"cuda:{rank}" if device == "cuda" else device,
                     init_method=init_method, rank=rank, world_size=world)
    try:
        main(argv, _child=True)
    finally:
        dist.destroy_process_group()


def spawn_ranks(main: Callable, argv, mesh_spec: Optional[str], device,
                child: bool = False) -> bool:
    """Start the local ranks of ``--mesh mesh_spec`` when the command must
    (see the module doc): each runs ``main(argv, _child=True)`` after
    joining a group of D * E (* T) ranks (gloo on the CPU, NCCL with one GPU a
    rank; too few GPUs raise).  Returns whether it spawned (the caller's
    process then has nothing left to do)."""
    if not mesh_spec or child or "WORLD_SIZE" in os.environ:
        return False
    n = math.prod(parse_mesh(mesh_spec))
    if n == 1:
        return False
    spawn(main, argv, n, str(device))
    return True


def spawn(main: Callable, argv, world: int, device: str) -> None:
    """Run ``main(argv, _child=True)`` on ``world`` local ranks."""
    import torch.multiprocessing as mp
    if device.startswith("cuda"):
        gpus = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if world > gpus:
            raise RuntimeError(f"--mesh needs {world} GPUs; this machine has "
                               f"{gpus}")
        device = "cuda"
    tmp = tempfile.mkdtemp(prefix="repro_torch_rdzv_")
    mp.spawn(_spawned, args=(main, argv, world, f"file://{tmp}/rdzv",
                             device), nprocs=world, join=True)
