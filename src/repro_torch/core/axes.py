"""Mesh-axis names and roles (a copy of the reference's
``src/repro/core/axes.py``), read off the port's process-group mesh
(``launch.mesh.Mesh``).

Axis roles:
  POD    outer data-parallel axis across pods (multi-pod meshes only)
  DATA   data-parallel / FSDP axis
  MODEL  expert-parallel axis (the MoE all-to-all runs here)
  TP     expert-slicing tensor-parallel split of MODEL (not ported)
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
