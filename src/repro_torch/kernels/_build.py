"""Build, load and count the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own with
``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
-Xcompiler -fPIC`` into ``kernels/build/lib<name>.<hash>.so`` (the hash
covers the source, every ``csrc/*.cuh`` header and the flags, so an edited
source or header is rebuilt), loaded
with ``ctypes``.  All sources build at the first kernel call, one ``nvcc``
process each, started together.  Nothing is built or loaded at import: the
CPU tests import every module.

Every C entry point returns ``cudaGetLastError()`` after its launches;
``check`` raises if it is not 0.  Each kernel wrapper owns a
``LaunchCounter`` that it bumps exactly where it launches its kernel.
``launch_floor`` launches ``csrc/launch_floor.cu``'s empty kernel, the
yardstick a small kernel's time is judged by; it replaces no TPU kernel
and has no counter.  Neither does ``csrc/mma_forms.cu``, the yardstick of
the two tensor-core forms (mma.sync, wgmma) at the recurrences' backward
shapes, which ``chip_smoke.py`` times through ``lib("mma_forms")``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("topk_gating", "dispatch", "moe_ffn", "grouped_matmul",
           "flash_attention", "rwkv6", "ssd", "rwkv6_bwd", "ssd_bwd",
           "launch_floor", "mma_forms")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: dict = {}
BUILD_LOG: dict = {}          # source name -> nvcc / ptxas output
# sources compiled and libraries loaded by this process (what
# ``analysis.retrace.no_retrace`` counts: the port's re-trace stalls)
STATS = {"builds": 0, "loads": 0}

# ctypes argument kinds: a pointer or stream is c_void_p (a bare Python int
# would be passed as a 32-bit int and cut), every size is c_int, a stride
# in elements c_longlong
P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {
    "topk_gating": {
        "topk_gating": (P, P, I, I, I, I, P, P, P, P),
        "topk_positions": (P, I, I, I, P, P),
        "topk_positions_plan": (I, P),
    },
    "dispatch": {
        "dispatch_rows": (P, P, P, P, I, I, I, P, P, P),
        "combine_rows": (P, P, P, I, I, I, I, P, P),
        "weighted_route": (P, P, P, P, I, I, I, I, P, P),
    },
    "moe_ffn": {
        "grouped_ffn": (P, P, P, P, P, P, P, P, I, I, I, I, I, I, P),
    },
    "grouped_matmul": {
        "grouped_matmul": (P, P, P, I, I, I, I, I, I, P),
    },
    "flash_attention": {
        "flash_attention": (P, P, P, P, I, I, I, I, I, I, I, P),
    },
    "rwkv6": {
        "rwkv6_wkv": (P, P, P, P, P, P, P, P, I, I, I, I, P),
    },
    "ssd": {
        "ssd_scan": (P, P, P, P, P, P, P, P, P, I, I, I, I, I,
                     L, L, L, L, L, L, L, L, P),
    },
    "rwkv6_bwd": {
        "rwkv6_wkv_bwd": (P,) * 17 + (I, I, I, I, P),
    },
    "ssd_bwd": {
        "ssd_scan_bwd": (P,) * 20 + (I,) * 5 + (L,) * 8 + (P,),
    },
    "launch_floor": {
        "launch_floor": (P,),
    },
    "mma_forms": {
        "mma_forms": (P, P, P, I, I, I, P),
    },
}


class LaunchCounter:
    """Kernel launches of one wrapper (the plain CPU version never counts)."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        COUNTERS[name] = self

    def inc(self) -> None:
        self.count += 1

    def reset(self) -> None:
        self.count = 0


COUNTERS: dict = {}


def reset_counters() -> None:
    for c in COUNTERS.values():
        c.reset()


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):     # included by any source
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}.{h.hexdigest()[:12]}.so"


def build_all() -> float:
    """Compile every out-of-date source, all ``nvcc`` processes at once.
    Returns the wall seconds spent (0 when everything was built)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in SOURCES if not _lib_path(n).exists()]
    t0 = time.perf_counter()
    procs = {}
    nvcc = nvcc_path() if todo else None
    for name in todo:
        out = _lib_path(name)
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
        STATS["builds"] += 1
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def lib(name: str):
    """The loaded library of ``csrc/<name>.cu`` (builds every source on the
    first call), with argtypes/restype declared for each entry point."""
    handle = _LIBS.get(name)
    if handle is None:
        build_all()
        handle = ctypes.CDLL(str(_lib_path(name)))
        STATS["loads"] += 1
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(handle, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _LIBS[name] = handle
    return handle


class KernelRefused(ValueError, TypeError):
    """A kernel's contract refuses its inputs: a shape, dtype, stride or
    alignment that the kernel does not take.  Only the ``contract_<kernel>``
    functions and the rules they call raise it, so a caller can tell a
    refusal from a fault of its own.  It is a ValueError and a TypeError,
    as the refusals were before it."""


def check(status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")


def on_cpu(*tensors) -> bool:
    """True if every tensor lies on the CPU (the wrapper then runs its plain
    version), False if every one lies on one CUDA device (it launches the
    kernel) or every one on ``meta`` (the meta route: the wrapper runs the
    kernel's contract and allocates its outputs and scratch there, and
    launches nothing).  Any other placement raises."""
    devs = {t.device for t in tensors if t is not None}
    kinds = {d.type for d in devs}
    if kinds == {"cpu"}:
        return True
    if kinds in ({"cuda"}, {"meta"}) and len(devs) == 1:
        return False
    raise ValueError(f"kernel inputs must all lie on the CPU or all on one "
                     f"CUDA device (or all on meta, the dry run's), got "
                     f"{sorted(str(d) for d in devs)}")


def addr(t) -> int:
    """The base address that a kernel's 16-byte rules read: ``data_ptr()``
    on the card; on ``meta``, where it is 0, ``storage_offset() *
    itemsize`` (a fresh allocation is aligned on both), so a misaligned
    view is refused on both."""
    if t.device.type == "meta":
        return t.storage_offset() * t.element_size()
    return t.data_ptr()


def stream(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t):
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


BF16 = (torch.bfloat16,)   # the one activation type the kernels take


def require(t, name: str, dtypes, ndim: int) -> None:
    """Raise unless ``t`` has one of ``dtypes``, ``ndim`` dims and is
    contiguous — what every kernel here takes."""
    if t.dtype not in dtypes:
        raise KernelRefused(f"{name}: dtype {t.dtype} not in {list(dtypes)}")
    if t.dim() != ndim:
        raise KernelRefused(f"{name}: expected {ndim} dims, got "
                            f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise KernelRefused(f"{name}: must be contiguous")


def aligned16(t):
    """``t`` itself when its base address is a multiple of 16 bytes (or it
    is None), else a fresh copy: for an fp32 operand that a kernel loads in
    16-byte vectors and that may arrive as a view at any offset."""
    if t is None or addr(t) % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def launch_floor(device) -> None:
    """One launch of the empty kernel (one block of 32 threads, no memory
    traffic) on ``device``'s current stream."""
    s = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
    check(lib("launch_floor").launch_floor(s), "launch_floor")
