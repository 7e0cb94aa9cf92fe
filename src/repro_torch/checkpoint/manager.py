"""Fault-tolerant checkpointing of parameter trees (the reference's
``src/repro/checkpoint/manager.py``, on torch tensors):

  * atomic: written into ``<dir>.tmp`` and renamed, so a killed job never
    leaves a half checkpoint that a restart would read;
  * checksummed: the manifest records a CRC32 per array, verified on load,
    so a torn or bit-rotted write is detected (``CorruptCheckpointError``);
    ``restore_latest`` falls back to the newest step that verifies;
  * keep-last-k garbage collection and latest-step discovery;
  * resettable subtrees: leaves under a ``reset_ok`` prefix (the trainer's
    per-rank int8 residuals, saved as a ``[world, ...]`` stack) that are
    missing or shaped for another world size restore as zeros, and the
    manager lists them in ``last_reset``.

Leaves go to host numpy in their logical layout, one ``.npy`` file each
(one leaf in host memory at a time; the reference packs them into one
``.npz``).  numpy has no bf16, so a bf16 leaf is stored as its uint16 bit
pattern and the manifest keeps the true dtype.  Paths follow
``repro_torch.tree.tree_items`` (field names joined by "/").
"""
from __future__ import annotations

import json
import os
import re
import shutil
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import tree_items, tree_unflatten_like


class CorruptCheckpointError(ValueError):
    """A checkpoint failed checksum/shape verification on load."""


_BITS = {torch.bfloat16: np.uint16}
_DTYPES = {str(d).replace("torch.", ""): d for d in
           (torch.float32, torch.bfloat16, torch.float16, torch.int32,
            torch.int64, torch.uint8, torch.bool)}


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8)) \
        & 0xFFFFFFFF


def _to_host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype in _BITS:
        return t.view(torch.int16).numpy().view(_BITS[t.dtype])
    return t.numpy()


def _from_host(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    want = _DTYPES[dtype]
    if want in _BITS:
        return torch.from_numpy(arr.view(np.int16)).view(want).to(device)
    return torch.from_numpy(arr).to(device)


def save_pytree(tree, directory: str) -> int:
    """Atomic save; returns the bytes of array data written."""
    tmp = directory + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest, n_bytes = [], 0
    for i, (key, leaf) in enumerate(tree_items(tree)):
        arr = _to_host(leaf)
        name = f"a{i}.npy"
        np.save(os.path.join(tmp, name), arr)
        n_bytes += arr.nbytes
        manifest.append({"key": key, "name": name,
                         "dtype": str(leaf.dtype).replace("torch.", ""),
                         "shape": list(arr.shape), "crc32": _crc(arr)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(directory):
        shutil.rmtree(directory)
    os.replace(tmp, directory)
    return n_bytes


def load_pytree(directory: str, like, verify: bool = True,
                reset_ok: tuple = (), reset: list | None = None):
    """Restore into the structure of ``like``, each leaf on the device of
    ``like``'s leaf.  With ``verify`` every array's CRC32 is checked
    against the manifest; a mismatch, a missing or unreadable array raises
    ``CorruptCheckpointError``.  A leaf whose path starts with a prefix in
    ``reset_ok`` and that the checkpoint lacks or holds in another shape
    comes back as zeros, its path appended to ``reset``."""
    try:
        with open(os.path.join(directory, "manifest.json")) as f:
            manifest = {m["key"]: m for m in json.load(f)}
    except (OSError, ValueError, KeyError) as e:
        raise CorruptCheckpointError(f"{directory}: unreadable ({e})") from e
    leaves = []
    for key, leaf in tree_items(like):
        m = manifest.get(key)
        if any(key.startswith(p) for p in reset_ok) and (
                m is None or tuple(m["shape"]) != tuple(leaf.shape)):
            leaves.append(torch.zeros_like(leaf))
            if reset is not None:
                reset.append(key)
            continue
        if m is None:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        try:
            arr = np.load(os.path.join(directory, m["name"]))
        except (OSError, ValueError) as e:
            raise CorruptCheckpointError(
                f"{directory}: missing/unreadable array {key!r}") from e
        if verify and _crc(arr) != m["crc32"]:
            raise CorruptCheckpointError(
                f"{directory}: checksum mismatch on {key!r}")
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} "
                             f"vs model {tuple(leaf.shape)}")
        leaves.append(_from_host(arr, m["dtype"], leaf.device))
    return tree_unflatten_like(like, leaves)


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        self.corrupt_steps: list = []   # steps restore_latest skipped
        self.last_save_bytes = 0
        self.last_reset: list = []      # leaves the last restore zeroed
        os.makedirs(root, exist_ok=True)

    def _dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:08d}")

    def steps(self):
        out = []
        for d in os.listdir(self.root):
            m = re.fullmatch(r"step_(\d+)", d)
            if m and os.path.exists(os.path.join(self.root, d,
                                                 "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def save(self, step: int, state: Any):
        self.last_save_bytes = save_pytree(state, self._dir(step))
        for old in self.steps()[: -self.keep]:
            shutil.rmtree(self._dir(old), ignore_errors=True)

    def restore(self, step: int, like: Any, verify: bool = True,
                reset_ok: tuple = ()):
        self.last_reset = []
        return load_pytree(self._dir(step), like, verify=verify,
                           reset_ok=reset_ok, reset=self.last_reset)

    def restore_latest(self, like: Any, reset_ok: tuple = ()):
        """Restore the newest step that verifies, walking past corrupted
        checkpoints (recorded in ``corrupt_steps``).  Returns (None, None)
        when nothing loads."""
        for s in reversed(self.steps()):
            try:
                return s, self.restore(s, like, reset_ok=reset_ok)
            except CorruptCheckpointError:
                self.corrupt_steps.append(s)
        return None, None
