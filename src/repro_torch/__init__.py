"""PyTorch + CUDA port of the Lina MoE system for one NVIDIA H100.

Mirrors the JAX reference package ``repro`` module for module (``configs``,
``kernels``, ``core``, ``models``, ``obs``, ``data``, ``runtime``,
``launch``); every Pallas kernel on the ported path is a CUDA C++ kernel
for ``sm_90a`` under ``kernels/csrc/``.  Imports torch, numpy and the
standard library only.
"""
