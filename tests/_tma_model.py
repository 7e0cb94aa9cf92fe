"""Numpy models of Hopper's 128-byte swizzle and of what ``wgmma`` reads
through a shared-memory descriptor, shared by the layout tests of the
TMA + ``wgmma`` kernels (``test_torch_grouped_matmul.py``,
``test_torch_flash_layout.py``, ``test_torch_ffn_layout.py``).  Shared memory is an element array indexed
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


def tma_box(smem, es, dst, glob, c0, c1, box0, box1, swizzle):
    """TMA load of a {box0 (inner), box1} box at (c0, c1) of the 2-D array
    ``glob`` [outer, inner] into the byte-addressed ``smem`` (an element
    array indexed by address // es) at ``dst``; out of bounds reads 0."""
    j, i = np.meshgrid(np.arange(box1), np.arange(box0), indexing="ij")
    gi, gj = c0 + i, c1 + j
    inb = (gi < glob.shape[1]) & (gj < glob.shape[0])
    vals = np.where(inb, glob[np.minimum(gj, glob.shape[0] - 1),
                              np.minimum(gi, glob.shape[1] - 1)], 0.0)
    off = (j * box0 + i) * es
    if swizzle:
        assert box0 * es == 128 and dst % 1024 == 0
        off = sw128(off)
    smem[(dst + off) // es] = vals


def tma_store_box(glob, smem, es, src, c0, c1, box0, box1):
    """TMA store of a {box0, box1} box, 128-byte swizzled in ``smem`` at
    ``src``, to (c0, c1) of the 2-D array ``glob`` [outer, inner]; the
    elements out of bounds are not written."""
    assert box0 * es == 128 and src % 1024 == 0
    j, i = np.meshgrid(np.arange(box1), np.arange(box0), indexing="ij")
    gi, gj = c0 + i, c1 + j
    inb = (gi < glob.shape[1]) & (gj < glob.shape[0])
    vals = smem[(src + sw128((j * box0 + i) * es)) // es]
    glob[gj[inb], gi[inb]] = vals[inb]
