"""Numpy models of Hopper's 128-byte swizzle and of what ``wgmma`` reads
through a shared-memory descriptor, shared by the layout tests of the
TMA + ``wgmma`` kernels (``test_torch_grouped_matmul.py``,
``test_torch_flash_layout.py``).  Shared memory is an element array indexed
by byte address // element size."""
import numpy as np


def sw128(addr):
    """The 128-byte swizzle on a byte address (TMA and wgmma alike): bits
    [4, 7) XOR bits [7, 10)."""
    return addr ^ (((addr >> 7) & 7) << 4)


def read_kmajor(smem, es, start, rows, kw, sbo=1024):
    """What wgmma reads through a K-major 128-byte-swizzle descriptor:
    [rows, kw]; row r at 128 (r % 8) + sbo (r // 8), k at es * k."""
    r, k = np.meshgrid(np.arange(rows), np.arange(kw), indexing="ij")
    addr = start + (r % 8) * 128 + (r // 8) * sbo + k * es
    return smem[sw128(addr) // es]


def read_mnmajor(smem, es, start, mn, kw, lbo, sbo=1024):
    """What wgmma reads through an M/N-major 128-byte-swizzle descriptor:
    [mn, kw]; 128-byte rows along M/N, 64-wide blocks ``lbo`` apart, k
    rows 128 bytes apart in 8-row groups ``sbo`` apart."""
    w = 128 // es
    x, k = np.meshgrid(np.arange(mn), np.arange(kw), indexing="ij")
    addr = start + (x % w) * es + (x // w) * lbo + (k % 8) * 128 \
        + (k // 8) * sbo
    return smem[sw128(addr) // es]
