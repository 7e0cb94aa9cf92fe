"""Mesh-axis names and roles (a copy of the reference's
``src/repro/core/axes.py``), read off the port's process-group mesh
(``launch.mesh.Mesh``), and ``Spec``, the port's ``PartitionSpec``.

Axis roles:
  POD    outer data-parallel axis across pods (multi-pod meshes only)
  DATA   data-parallel / FSDP axis
  MODEL  expert-parallel axis (the MoE all-to-all runs here) and tensor
         parallel
  TP     expert-slicing tensor-parallel split of MODEL (archs whose expert
         count does not fill the 16-way model axis: ``launch.mesh.arch_mesh``)

The tensor-parallel collectives run over MODEL and TP together, one group
(``Mesh.mp_group``, recorded under ``MP_GROUP``).
"""
from __future__ import annotations

POD = "pod"
DATA = "data"
MODEL = "model"
TP = "tp"

# the full vocabulary, in mesh-major order
MESH_AXES = (POD, DATA, MODEL, TP)

# role aliases used across core/optim/launch
EP_AXIS = MODEL            # expert-parallel: dispatch/combine a2a axis
DP_AXES = (POD, DATA)      # data-parallel axes (gradient reduction)
MP_AXES = (MODEL, TP)      # model-parallel axes (weight sharding)

# a record's axis for the group of MODEL and TP together
MP_GROUP = MODEL + "+" + TP


def axis_sizes(mesh) -> dict:
    """{axis name: size} for ``mesh`` (empty for None)."""
    if mesh is None:
        return {}
    return dict(zip(mesh.axis_names, mesh.shape))


def dp_axes(mesh) -> tuple:
    """The data-parallel axes present on ``mesh`` (() for None)."""
    if mesh is None:
        return ()
    return DP_AXES if POD in mesh.axis_names else (DATA,)


def mp_axes(mesh) -> tuple:
    """The model/tensor-parallel axes present on ``mesh``."""
    if mesh is None:
        return (MODEL,)
    return MP_AXES if TP in mesh.axis_names else (MODEL,)


def _entry(e):
    """A spec entry in normal form: None, an axis name, or a tuple of two
    or more names (a 1-tuple is its name, an empty one None)."""
    if e is None or isinstance(e, str):
        return e
    e = tuple(e)
    if not e:
        return None
    return e[0] if len(e) == 1 else e


class Spec:
    """The placement of one array over a mesh, the port's
    ``jax.sharding.PartitionSpec``: one entry per leading dim (missing
    trailing entries are None), each None (whole), an axis name or a
    tuple of names (the dim split over their product, the first name
    major).  Not a tuple, so that the port's tree functions
    (``repro_torch.tree``) take a spec for a leaf."""

    __slots__ = ("dims",)

    def __init__(self, *dims):
        self.dims = tuple(_entry(d) for d in dims)

    def entry(self, i: int):
        return self.dims[i] if i < len(self.dims) else None

    def axes_of(self, i: int) -> tuple:
        """The axes dim ``i`` is split over, major first (() if whole)."""
        e = self.entry(i)
        return () if e is None else ((e,) if isinstance(e, str) else e)

    def names(self) -> set:
        """Every axis the spec splits a dim over."""
        return {a for i in range(len(self.dims)) for a in self.axes_of(i)}

    def drop(self, n: int = 1) -> "Spec":
        """The spec of a slice that indexes away the first ``n`` dims."""
        return Spec(*self.dims[n:])

    def __iter__(self):
        return iter(self.dims)

    def __len__(self):
        return len(self.dims)

    def __eq__(self, other):
        if not isinstance(other, Spec):
            return NotImplemented
        n = max(len(self.dims), len(other.dims))
        return all(self.entry(i) == other.entry(i) for i in range(n))

    def __hash__(self):
        dims = list(self.dims)
        while dims and dims[-1] is None:
            dims.pop()
        return hash(tuple(dims))

    def __repr__(self):
        return f"Spec{self.dims!r}"
