"""Pass 1 — the launch contracts of the port's Hopper kernels.

Hybrid AST + registry, as the reference's pass 1
(``src/repro/analysis/kernels.py``) is for its Pallas kernels:

* The **inventory** lists every ``lib("<source>").<entry>(...)`` call
  under ``src/repro_torch/kernels/`` (module, enclosing function, source,
  entry) and every ``extern "C"`` entry of ``csrc/*.cu``.  A launch site
  or entry with no registry entry is an ``unregistered-kernel``; a
  registry entry whose site or C entry is gone, or whose edge cases
  (below) no longer get the verdict the registry states, is a
  ``site-mismatch`` (the registry is stale).  ``launch_floor`` and
  ``mma_forms`` are yardsticks, not kernels (``YARDSTICKS``), and
  ``topk_positions_plan`` a query (``QUERIES``).

* The **registry** has one entry for each kernel of ``chip_smoke.py``'s
  ``REPLACES`` and ``BACKWARD`` (twelve).  Each names its contract
  function (``kernels.<module>.contract_<kernel>``: the one source of the
  kernel's refusals, each a ``KernelRefused``, which the card's route and
  the meta route run too), the shared-memory quantities its source must
  hold against a limit, its launch grids, and edge cases: small shapes at
  the contract's boundaries, accepted or refused (``chip_smoke.py``
  phase 14 launches the accepted ones on the card against their plain
  versions and checks that the refused ones raise before a launch).

Each entry's contract is evaluated at shape cases built from

  - the paper models at scales 1 and 4 (``build_cases``, the reference's),
    for the MoE kernels; flash attention at scale 1 (the models' own
    head dims);
  - the ten assigned configs at their own widths, with rank 0's share of
    ``train_4k``, ``prefill_32k`` and ``decode_32k`` on the 16 x 16
    production mesh: the calls that ``launch.dryrun``'s step makes on
    ``meta``, recorded at the contracts (``record_cases``), at depth 2
    (a layer's shapes do not depend on the depth).  mixtral-8x22b's 8
    experts do not split over the 16-way `model` axis (expert slicing is
    not ported), so its cases are one rank's.

Findings:

  - ``refused-shape``: a case on whose path a kernel's contract refuses
    (the dry run then cannot run that cell on the card);
  - ``smem-over-budget``: a kernel's shared memory that its source does
    not hold against a limit with a ``static_assert`` (nvcc is the one
    check of the bytes), or a limit constant over the card's:
    ``kSmemMax`` over ``H100.vmem_bytes`` (232,448 bytes, a block's
    dynamic shared memory), ``kStaticSmemMax`` over 48 KiB (static
    ``__shared__`` tables);
  - ``grid-over-limit``: a grid's y or z over 65,535 or x over 2^31 - 1;
    a size the wrapper passes to the C entry as an int (every dim, and
    ``weighted_route``'s T * k) over 2^31 - 1 (the kernels' flat offsets
    are 64-bit; their counts are not); ``grouped_ffn`` past
    ``moe_ffn.MAX_GROUPS`` (``kMaxGroups``) groups (a warning: its walk
    then runs in index order).
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Callable

import torch

from repro_torch.analysis.findings import Finding
from repro_torch.configs import ASSIGNED, H100, SHAPES, skip_reason
from repro_torch.configs.base import MoEConfig
from repro_torch.configs.paper_models import (BERT2GPT2, BERT_LARGE, GPT2_MOE,
                                              TRANSFORMER_XL)
from repro_torch.core.gating import capacity
from repro_torch.kernels import (dispatch, flash_attention, moe_ffn, rwkv6,
                                 ssd, topk_gating)
from repro_torch.kernels._build import KernelRefused

PAPER_MODELS = (TRANSFORMER_XL, GPT2_MOE, BERT2GPT2, BERT_LARGE)
BASE_TOKENS = 4096       # the reference's: global tokens at scale 1
PIPELINE_MICROOPS = MoEConfig().n_microops
CONFIG_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
CASE_DEPTH = 2

GRID_YZ_MAX = 65_535
GRID_X_MAX = 2**31 - 1
INT32_MAX = 2**31 - 1
STATIC_SMEM_MAX = 48 * 1024

KERNELS_REL = "src/repro_torch/kernels"
YARDSTICKS = {"launch_floor": "launch_floor", "mma_forms": "mma_forms"}
QUERIES = {"topk_positions_plan": "topk_gating"}


# ---------------------------------------------------------------- shapes --

@dataclasses.dataclass(frozen=True)
class ShapeCase:
    """One paper-model evaluation point (the reference's fields)."""
    name: str
    T: int     # tokens entering the MoE layer
    D: int     # model width
    F: int     # expert FFN width
    E: int     # experts
    K: int     # top-k
    C: int     # per-expert capacity (core.gating.capacity)
    R: int     # dispatch rows = E * C
    H: int     # attention heads
    HD: int    # head dim


def build_cases(scales=(1, 4)) -> list:
    cases = []
    for cfg in PAPER_MODELS:
        for s in scales:
            d = max(128, cfg.d_model // s)
            f = max(128, (cfg.moe.d_ff or cfg.d_ff) // s)
            t = max(256, BASE_TOKENS // s)
            c = capacity(t, cfg.moe.n_experts, cfg.moe.top_k,
                         cfg.moe.capacity_factor)
            cases.append(ShapeCase(
                name=f"{cfg.name}/s{s}", T=t, D=d, F=f,
                E=cfg.moe.n_experts, K=cfg.moe.top_k, C=c,
                R=cfg.moe.n_experts * c, H=cfg.n_heads,
                HD=max(8, d // cfg.n_heads)))
    return cases


@dataclasses.dataclass
class Case:
    """A kernel's contract arguments at one evaluation point."""
    kernel: str
    name: str          # e.g. "gpt2-moe/s1" or "qwen3-8b/prefill_32k"
    args: tuple
    kwargs: dict = dataclasses.field(default_factory=dict)


def _m(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _i32(*shape):
    return _m(*shape, dtype=torch.int32)


def _f32(*shape):
    return _m(*shape, dtype=torch.float32)


def paper_cases(scales=(1, 4)) -> list:
    """The MoE kernels' (and, at scale 1, flash's) contract arguments at
    ``build_cases``' shapes: one layer's training call of each, gating
    to the FFN's backward, as the single-rank layer makes them."""
    out = []
    for c in build_cases(scales):
        n = c.name
        ch = c.C // _chunks(c.C)
        out += [
            Case("topk_gating_fused", n, (_m(c.T, c.D), _m(c.D, c.E), c.K)),
            Case("topk_positions", n, (_i32(c.T, c.K), c.E)),
            Case("dispatch_rows", n, (_m(c.T, c.D), _i32(c.R), _f32(c.R),
                                      _m(c.R, c.D))),
            Case("combine_rows", n, (_m(c.R, c.D), _i32(c.T, c.K),
                                     _f32(c.T, c.K))),
            Case("weighted_route", n, (_i32(c.T, c.K), _i32(c.T, c.K),
                                       _i32(c.E, 2), _i32(c.E, 2))),
            Case("grouped_ffn", n, (_m(c.E, ch, c.D), _m(c.E, c.D, c.F),
                                    None, _m(c.E, c.F, c.D), "gelu", None,
                                    _i32(c.E))),
            Case("grouped_matmul", n, (_m(c.E, c.C, c.D).transpose(1, 2),
                                       _f32(c.E, c.C, c.F))),
        ]
        if n.endswith("/s1"):
            cfg = next(m for m in PAPER_MODELS if n.startswith(m.name))
            hd = cfg.resolved_head_dim
            q = _m(1, 2048, cfg.n_heads, hd)
            out.append(Case("flash_attention", n, (q, q, q, 0)))
    return out


def _chunks(cap: int) -> int:
    from repro_torch.core.microop import resolve_chunk_count
    return resolve_chunk_count(cap, PIPELINE_MICROOPS)


# ----------------------------------------------------- recorded cases -----

_CONTRACTS = {
    "topk_gating_fused": (topk_gating, "contract_topk_gating"),
    "topk_positions": (topk_gating, "contract_topk_positions"),
    "dispatch_rows": (dispatch, "contract_dispatch_rows"),
    "combine_rows": (dispatch, "contract_combine_rows"),
    "weighted_route": (dispatch, "contract_weighted_route"),
    "grouped_ffn": (moe_ffn, "contract_grouped_ffn"),
    "grouped_matmul": (moe_ffn, "contract_grouped_matmul"),
    "flash_attention": (flash_attention, "contract_flash_attention"),
    "rwkv6_wkv": (rwkv6, "contract_rwkv6_wkv"),
    "rwkv6_wkv_bwd": (rwkv6, "contract_rwkv6_wkv_bwd"),
    "ssd_scan": (ssd, "contract_ssd_scan"),
    "ssd_scan_bwd": (ssd, "contract_ssd_scan_bwd"),
}


def _spec(a):
    if isinstance(a, torch.Tensor):
        return ("T", tuple(a.shape), str(a.dtype), tuple(a.stride()),
                a.storage_offset())
    return a


class _Recorder:
    """Patches every contract function so that each call is kept as a
    ``Case`` and a refusal does not stop the step (the meta route then
    allocates the outputs as usual)."""

    def __init__(self):
        self.cases: list = []
        self.name = ""
        self._keys: set = set()
        self._saved: dict = {}

    def __enter__(self):
        for kernel, (mod, fn) in _CONTRACTS.items():
            real = getattr(mod, fn)
            self._saved[(mod, fn)] = real
            setattr(mod, fn, self._wrap(kernel, real))
        return self

    def __exit__(self, *exc):
        for (mod, fn), real in self._saved.items():
            setattr(mod, fn, real)

    def _wrap(self, kernel, real):
        def contract(*args, **kwargs):
            key = (kernel, self.name, tuple(map(_spec, args)),
                   tuple(sorted((k, _spec(v)) for k, v in kwargs.items())))
            if key not in self._keys:
                self._keys.add(key)
                self.cases.append(Case(kernel, self.name, args, kwargs))
            try:
                return real(*args, **kwargs)
            except KernelRefused:
                return ((0, 0),) * 3       # what contract_ssd_scan returns
        return contract


_RECORDED: dict = {}


def record_cases(configs=None, shapes=CONFIG_SHAPES,
                 depth: int = CASE_DEPTH) -> list:
    """The contract calls of rank 0's step of each config x shape on
    ``meta`` (``launch.dryrun.step_program``) at ``depth`` layers, on the
    16 x 16 production mesh as ``launch.mesh.arch_mesh`` views it for the
    config (the dense-sharded step's local shapes).  Kept per process: the
    code they come from does not change while it runs."""
    configs = ASSIGNED if configs is None else configs
    key = (tuple(c.name for c in configs), tuple(shapes), depth)
    if key not in _RECORDED:
        _RECORDED[key] = _record(configs, shapes, depth)
    return list(_RECORDED[key])


def _record(configs, shapes, depth: int) -> list:
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import arch_mesh
    with _Recorder() as rec:
        for cfg in configs:
            pattern = cfg.layer_pattern[:depth - 1] + "*" \
                if cfg.layer_pattern else ""
            cut = dataclasses.replace(cfg, n_layers=depth,
                                      layer_pattern=pattern)
            for sname in shapes:
                shape = SHAPES[sname]
                if skip_reason(cfg, shape):
                    continue
                mesh = arch_mesh(cfg)
                b, s = dryrun.cell_shape(cfg, shape, mesh)
                kind = "decode" if shape.kind == "long_decode" \
                    else shape.kind
                rec.name = f"{cfg.name}/{sname}"
                step, args = dryrun.step_program(
                    cut, kind, b, s, mesh=mesh,
                    global_batch=shape.global_batch)
                step(*args)
    return rec.cases


# ------------------------------------------------------------ edge cases --

@dataclasses.dataclass
class EdgeCase:
    """A small call at a boundary of a kernel's contract: ``build(device,
    gen)`` -> (args, kwargs) of the kernel's wrapper; ``accepted`` says
    whether the kernel takes it."""
    name: str
    build: Callable
    accepted: bool


def _rand(shape, device, gen, dtype=torch.bfloat16, scale=1.0):
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    return (torch.randn(shape, generator=gen, device=device) * scale).to(
        dtype)


def _shifted(shape, device, gen, dtype=torch.bfloat16, elems: int = 1):
    """A contiguous view whose base is ``elems`` elements past an aligned
    allocation's (misaligned for the 16-byte rules)."""
    n = 1
    for s in shape:
        n *= s
    base = _rand((n + elems,), device, gen, dtype)
    return base[elems:].view(*shape)


def _ids(shape, hi, device):
    """Ids in [0, hi), the same on every device (drawn on the CPU)."""
    if torch.device(device).type == "meta":
        return torch.zeros(shape, dtype=torch.int32, device=device)
    g = torch.Generator().manual_seed(7919 * hi + shape[0])
    return torch.randint(0, max(hi, 1), shape, generator=g).to(
        torch.int32).to(device)


def _gating(t, d, e, k, shift=0):
    def build(dev, gen):
        x = _shifted((t, d), dev, gen, elems=shift) if shift else \
            _rand((t, d), dev, gen)
        return (x, k), {"router": _rand((d, e), dev, gen, scale=d**-0.5)}
    return build


def _positions(t, k, e):
    def build(dev, gen):
        return (_ids((t, k), e, dev), e), {}
    return build


def _slot_rows(t, r, dev):
    """src_tok [r]: each token once, then empty rows (-1)."""
    src = torch.full((r,), -1, dtype=torch.int32)
    src[:min(t, r)] = torch.arange(min(t, r), dtype=torch.int32)
    return src.to(dev)


def _dispatch(t, d, r, shift=0, dot=True):
    def build(dev, gen):
        x = _shifted((t, d), dev, gen, elems=shift) if shift else \
            _rand((t, d), dev, gen)
        kw = {"dot": _rand((r, d), dev, gen)} if dot else {}
        return (x, _slot_rows(t, r, dev),
                _rand((r,), dev, gen, torch.float32)), kw
    return build


def _combine(r, t, k, d, shift=0):
    def build(dev, gen):
        buf = _shifted((r, d), dev, gen, elems=shift) if shift else \
            _rand((r, d), dev, gen)
        rows = torch.arange(t * k, dtype=torch.int32).reshape(t, k) % r
        rows[0, 0] = -1
        return (buf, rows.to(dev),
                _rand((t, k), dev, gen, torch.float32)), {}
    return build


def _route(t, k, e, reps, bad=False):
    def build(dev, gen):
        idx = torch.arange(t * k, dtype=torch.int32).reshape(t, k) % e
        pos = torch.arange(t * k, dtype=torch.int32).reshape(t, k) // e
        cum = torch.arange(1, reps + 1, dtype=torch.int32).repeat(e, 1)
        slot = torch.arange(e * reps, dtype=torch.int32).reshape(e, reps)
        if bad:
            pos = pos[:, :1].contiguous()
        return (idx.to(dev), pos.to(dev), cum.to(dev), slot.to(dev), 64), {}
    return build


def _ffn(g, t, d, f, act="gelu", shift=0, expert=False):
    def build(dev, gen):
        e = g
        wi = _shifted((e, d, f), dev, gen, elems=shift) if shift else \
            _rand((e, d, f), dev, gen, scale=d**-0.5)
        wu = _rand((e, d, f), dev, gen, scale=d**-0.5) \
            if act == "swiglu" else None
        kw = {"ffn_type": act,
              "group_rows": torch.tensor([t, t // 2] * (g // 2) + [t] *
                                         (g % 2), dtype=torch.int32
                                         ).to(dev)}
        if expert:
            kw["group_expert"] = torch.tensor(
                [(i * 3) % e if i % 4 else -1 for i in range(g)],
                dtype=torch.int32).to(dev)
        return (_rand((g, t, d), dev, gen), wi, wu,
                _rand((e, f, d), dev, gen, scale=f**-0.5)), kw
    return build


def _gmm(e, m, n, k, a_dt=torch.bfloat16, b_dt=torch.bfloat16,
         a_t=False, shift=0):
    def build(dev, gen):
        if a_t:
            a = _rand((e, k, m), dev, gen, a_dt).transpose(1, 2)
        elif shift:
            a = _shifted((e, m, k), dev, gen, a_dt, elems=shift)
        else:
            a = _rand((e, m, k), dev, gen, a_dt)
        return (a, _rand((e, k, n), dev, gen, b_dt)), {}
    return build


def _flash(b, s, h, kvh, hd, causal=True, window=0, skv=None, shift=0):
    def build(dev, gen):
        q = _shifted((b, s, h, hd), dev, gen, elems=shift) if shift else \
            _rand((b, s, h, hd), dev, gen)
        kv = [_rand((b, skv or s, kvh, hd), dev, gen) for _ in range(2)]
        return (q, *kv), {"causal": causal, "window": window}
    return build


def _wkv_inputs(b, t, h, hd, dev, gen, shift=0):
    r = _shifted((b, t, h, hd), dev, gen, elems=shift) if shift else \
        _rand((b, t, h, hd), dev, gen)
    k, v = (_rand((b, t, h, hd), dev, gen) for _ in range(2))
    if torch.device(dev).type == "meta":
        w = _f32(b, t, h, hd)
    else:
        w = -torch.exp(torch.randn((b, t, h, hd), generator=gen,
                                   device=dev) * 0.5 - 1.0)
    u = _rand((h, hd), dev, gen, torch.float32, 0.1)
    return r, k, v, w, u


def _wkv(b, t, h, hd, shift=0, state=False):
    def build(dev, gen):
        r, k, v, w, u = _wkv_inputs(b, t, h, hd, dev, gen, shift)
        kw = {"s0": _rand((b, h, hd, hd), dev, gen, torch.float32, 0.1),
              "return_state": True} if state else {}
        return (r, k, v, w, u), kw
    return build


def _wkv_bwd(b, t, h, hd, shift=0):
    def build(dev, gen):
        r, k, v, w, u = _wkv_inputs(b, t, h, hd, dev, gen, shift)
        return (r, k, v, w, u, None,
                _rand((b, t, h, hd), dev, gen, torch.float32), None), {}
    return build


def _ssd_inputs(b, t, h, p, n, dev, gen, pad=0):
    """x, dt, B, C as slices of one projection row [.., h p + 2 n + h],
    as the model passes them, its length rounded up to 8 elements (16
    bytes); ``pad`` more elements break the 16-byte time stride."""
    row = -(-(h * p + 2 * n + h) // 8) * 8 + pad
    proj = _rand((b, t, row), dev, gen)
    x = proj[..., :h * p].unflatten(-1, (h, p))
    bb = proj[..., h * p:h * p + n]
    cc = proj[..., h * p + n:h * p + 2 * n]
    dt = proj[..., h * p + 2 * n:h * p + 2 * n + h]
    a_log = torch.log(torch.linspace(1.0, 4.0, h)).to(dev) \
        if torch.device(dev).type != "meta" else _f32(h)
    d = _rand((h,), dev, gen, torch.float32)
    return x, dt, a_log, bb, cc, d


def _ssd(b, t, h, p, n, pad=0):
    def build(dev, gen):
        return _ssd_inputs(b, t, h, p, n, dev, gen, pad), {}
    return build


def _ssd_bwd(b, t, h, p, n):
    def build(dev, gen):
        x, dt, a_log, bb, cc, d = _ssd_inputs(b, t, h, p, n, dev, gen)
        return (x, dt, a_log, bb, cc, d, None,
                _rand((b, t, h, p), dev, gen, torch.float32), None), {}
    return build


# ------------------------------------------------------------- registry ---

@dataclasses.dataclass
class KernelEntry:
    name: str               # the kernel (chip_smoke.py's kernels line)
    module: str             # kernels/<module>.py of its wrapper
    qualname: str           # the wrapper holding the launch site
    source: str             # csrc/<source>.cu
    entry: str              # its extern "C" entry
    contract: str           # the contract function in ``module``
    smem: tuple             # (C expression, its limit's constant), ...
    grids: Callable         # Case -> [(label, (x, y, z))]
    edges: tuple            # EdgeCase, ...


# what each kernel's source holds against a limit with a static_assert
_RING = (("kSmem", "kSmemMax"),)
_BYTES = (("kBytes", "kSmemMax"),)
_GMM_RINGS = (("kBfSmem", "kSmemMax"), ("kTfSmem", "kSmemMax"))
_BWD_STRUCTS = (("sizeof(ChunkSmem)", "kSmemMax"),
                ("sizeof(GradSmem)", "kSmemMax"))
_POS_TABLES = (("kPosSmem", "kStaticSmemMax"),)
SMEM_LIMITS = {"kSmemMax": H100.vmem_bytes,
               "kStaticSmemMax": STATIC_SMEM_MAX}


def _one_d(blocks_of):
    def grids(case):
        return [("x", (blocks_of(case), 1, 1))]
    return grids


def _bwd_grid(chunk, heads_per_block=1):
    def grids(case):
        b, t, h = case.args[0].shape[:3]
        return [("chunks x heads x batch",
                 (-(-t // chunk), -(-h // heads_per_block), b))]
    return grids


def _persistent(case):
    return []


REGISTRY = {e.name: e for e in (
    KernelEntry(
        "topk_gating_fused", "topk_gating.py", "topk_gating_fused",
        "topk_gating", "topk_gating", "contract_topk_gating", _RING,
        _one_d(lambda c: -(-c.args[0].shape[0] // 64) * 8),
        (EdgeCase("E 256 k 4 D 8", _gating(64, 8, 256, 4), True),
         EdgeCase("E 3 (router by threads)", _gating(70, 64, 3, 2), True),
         EdgeCase("E 257", _gating(64, 64, 257, 2), False),
         EdgeCase("k 5", _gating(64, 64, 16, 5), False),
         EdgeCase("D 12", _gating(64, 12, 16, 2), False),
         EdgeCase("x 2 bytes off 16", _gating(64, 64, 16, 2, shift=1),
                  False))),
    KernelEntry(
        "topk_positions", "topk_gating.py", "topk_positions", "topk_gating",
        "topk_positions", "contract_topk_positions", _POS_TABLES,
        _one_d(lambda c: 16),
        (EdgeCase("1024 entries, one CTA", _positions(1024, 1, 256), True),
         EdgeCase("1025 entries, a cluster", _positions(1025, 1, 8), True),
         EdgeCase("E 257", _positions(64, 2, 257), False),
         EdgeCase("E 0", _positions(64, 2, 0), False))),
    KernelEntry(
        "dispatch_rows", "dispatch.py", "dispatch_rows", "dispatch",
        "dispatch_rows", "contract_dispatch_rows", (),
        _one_d(lambda c: -(-c.args[1].shape[0] // 4)),
        (EdgeCase("D 8 with dot", _dispatch(24, 8, 32), True),
         EdgeCase("D 12", _dispatch(24, 12, 32, dot=False), False),
         EdgeCase("x 2 bytes off 16", _dispatch(24, 64, 32, shift=1),
                  False))),
    KernelEntry(
        "combine_rows", "dispatch.py", "combine_rows", "dispatch",
        "combine_rows", "contract_combine_rows", (),
        _one_d(lambda c: -(-c.args[1].shape[0] // 8)),
        (EdgeCase("D 8, a dropped choice", _combine(32, 20, 2, 8), True),
         EdgeCase("D 4", _combine(32, 20, 2, 4), False),
         EdgeCase("buf 8 bytes off 16", _combine(32, 20, 2, 64, shift=4),
                  False))),
    KernelEntry(
        "weighted_route", "dispatch.py", "weighted_route", "dispatch",
        "weighted_route", "contract_weighted_route", (),
        _one_d(lambda c: -(-c.args[0].numel() // 256)),
        (EdgeCase("E 8, 3 replicas", _route(40, 2, 8, 3), True),
         EdgeCase("position [T, 1] for [T, 2]", _route(40, 2, 8, 3,
                                                       bad=True), False))),
    KernelEntry(
        "grouped_ffn", "moe_ffn.py", "grouped_ffn", "moe_ffn",
        "grouped_ffn", "contract_grouped_ffn", _RING, _persistent,
        (EdgeCase("gelu, ragged rows", _ffn(2, 72, 64, 128), True),
         EdgeCase("swiglu, experts in place", _ffn(4, 64, 64, 64,
                                                   "swiglu", expert=True),
                  True),
         EdgeCase("D 96", _ffn(2, 64, 96, 128), False),
         EdgeCase("wi 2 bytes off 16", _ffn(2, 64, 64, 128, shift=1),
                  False))),
    KernelEntry(
        "grouped_matmul", "moe_ffn.py", "grouped_matmul", "grouped_matmul",
        "grouped_matmul", "contract_grouped_matmul", _GMM_RINGS, _persistent,
        (EdgeCase("bf16 ragged", _gmm(2, 72, 40, 24), True),
         EdgeCase("fp32 x bf16, a transposed", _gmm(
             2, 64, 32, 16, torch.float32, a_t=True), True),
         EdgeCase("bf16 K 4 (8 bytes)", _gmm(2, 16, 16, 4), False),
         EdgeCase("a 2 bytes off 16", _gmm(2, 16, 16, 16, shift=1),
                  False))),
    KernelEntry(
        "flash_attention", "flash_attention.py", "flash_attention",
        "flash_attention", "flash_attention", "contract_flash_attention",
        _BYTES, _persistent,
        (EdgeCase("hd 64 causal GQA", _flash(1, 200, 4, 2, 64), True),
         EdgeCase("hd 80 bidirectional", _flash(1, 130, 2, 2, 80, False),
                  True),
         EdgeCase("hd 128 window 64", _flash(1, 256, 2, 1, 128,
                                             window=64), True),
         EdgeCase("hd 96", _flash(1, 64, 2, 2, 96), False),
         EdgeCase("Sq 64, Skv 128", _flash(1, 64, 2, 2, 64, skv=128),
                  False),
         EdgeCase("q 2 bytes off 16", _flash(1, 64, 2, 2, 64, shift=1),
                  False))),
    KernelEntry(
        "rwkv6_wkv", "rwkv6.py", "rwkv6_wkv", "rwkv6", "rwkv6_wkv",
        "contract_rwkv6_wkv", _BYTES, _one_d(
            lambda c: c.args[0].shape[0] * c.args[0].shape[2]),
        (EdgeCase("T 64 (chunked, TMA)", _wkv(1, 64, 2, 64), True),
         EdgeCase("T 70 from a state", _wkv(1, 70, 2, 64, state=True),
                   True),
         EdgeCase("T 8 misaligned r (step loop)", _wkv(1, 8, 2, 64,
                                                       shift=1), True),
         EdgeCase("T 64 misaligned r", _wkv(1, 64, 2, 64, shift=1), False),
         EdgeCase("hd 32", _wkv(1, 64, 2, 32), False))),
    KernelEntry(
        "rwkv6_wkv_bwd", "rwkv6.py", "rwkv6_wkv_bwd", "rwkv6_bwd",
        "rwkv6_wkv_bwd", "contract_rwkv6_wkv_bwd", _BWD_STRUCTS,
        _bwd_grid(rwkv6.BWD_CHUNK),
        (EdgeCase("T 66", _wkv_bwd(1, 66, 2, 64), True),
         EdgeCase("hd 32", _wkv_bwd(1, 64, 2, 32), False),
         EdgeCase("r 2 bytes off 16", _wkv_bwd(1, 64, 2, 64, shift=1),
                  False))),
    KernelEntry(
        "ssd_scan", "ssd.py", "ssd_scan", "ssd", "ssd_scan",
        "contract_ssd_scan", _BYTES, _one_d(
            lambda c: c.args[0].shape[0] * c.args[0].shape[2]),
        (EdgeCase("T 200, slices of a projection", _ssd(1, 200, 2, 64, 64),
                  True),
         EdgeCase("P 32", _ssd(1, 128, 2, 32, 64), False),
         EdgeCase("time stride 2 bytes off 16", _ssd(1, 128, 2, 64, 64,
                                                     pad=1), False))),
    KernelEntry(
        "ssd_scan_bwd", "ssd.py", "ssd_scan_bwd", "ssd_bwd", "ssd_scan_bwd",
        "contract_ssd_scan_bwd", _BWD_STRUCTS,
        _bwd_grid(ssd.BWD_CHUNK, ssd.BWD_HEADS),
        (EdgeCase("T 65, 9 heads", _ssd_bwd(1, 65, 9, 64, 64), True),
         EdgeCase("N 32", _ssd_bwd(1, 64, 2, 64, 32), False))),
)}


def contract_of(entry: KernelEntry) -> Callable:
    mod, fn = _CONTRACTS[entry.name]
    return getattr(mod, fn)


def edge_contract_args(entry: KernelEntry, args, kwargs) -> tuple:
    """A wrapper call's (args, kwargs) -> its contract's arguments."""
    if entry.name == "topk_gating_fused":
        return (args[0], kwargs["router"], args[1]), {}
    if entry.name == "grouped_ffn":
        return (*args, kwargs.get("ffn_type", "swiglu"),
                kwargs.get("group_expert"), kwargs.get("group_rows")), {}
    if entry.name == "flash_attention":
        return args, {"window": kwargs.get("window", 0)}
    if entry.name == "rwkv6_wkv":
        return (*args, kwargs.get("s0")), {}
    if entry.name == "weighted_route":
        return args[:4], {}
    if entry.name == "dispatch_rows":
        return (*args, kwargs.get("dot")), {}
    return args, kwargs


def wrapper_of(entry: KernelEntry) -> Callable:
    mod, _ = _CONTRACTS[entry.name]
    return getattr(mod, entry.qualname)


# ------------------------------------------------------------- inventory --

@dataclasses.dataclass
class LaunchSite:
    module: str          # repo-relative posix path
    qualname: str        # the enclosing function
    source: str          # lib("<source>")
    entry: str           # .<entry>(...)
    lineno: int


class _SiteVisitor(ast.NodeVisitor):
    def __init__(self, module: str):
        self.module = module
        self.stack: list = []
        self.sites: list = []

    def visit_FunctionDef(self, node):
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Call(self, node):
        f = node.func
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Call) \
                and isinstance(f.value.func, ast.Name) \
                and f.value.func.id == "lib" and f.value.args \
                and isinstance(f.value.args[0], ast.Constant):
            self.sites.append(LaunchSite(
                self.module, self.stack[-1] if self.stack else "<module>",
                f.value.args[0].value, f.attr, node.lineno))
        self.generic_visit(node)


def iter_launch_sites(kernels_dir: str, rel_prefix: str = KERNELS_REL
                      ) -> list:
    sites = []
    for fname in sorted(os.listdir(kernels_dir)):
        if not fname.endswith(".py"):
            continue
        path = os.path.join(kernels_dir, fname)
        with open(path) as fh:
            tree = ast.parse(fh.read(), filename=path)
        v = _SiteVisitor(f"{rel_prefix}/{fname}" if rel_prefix else fname)
        v.visit(tree)
        sites.extend(v.sites)
    return sites


_EXTERN = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(')


def iter_c_entries(csrc_dir: str) -> list:
    """[(source stem, entry, line)] of every ``extern "C"`` function."""
    out = []
    for fname in sorted(os.listdir(csrc_dir)):
        if not fname.endswith(".cu"):
            continue
        with open(os.path.join(csrc_dir, fname)) as fh:
            text = fh.read()
        for m in _EXTERN.finditer(text):
            out.append((fname[:-3], m.group(1),
                        text.count("\n", 0, m.start()) + 1))
    return out


# ---------------------------------------------------------------- checks --

def check_smem(entry: KernelEntry, text: str, module: str) -> list:
    """Each of the entry's shared-memory quantities must be held against
    its limit by a ``static_assert`` in the source (nvcc is the one check
    of the bytes), and the limit's constant must be within the card's."""
    findings = []
    flat = re.sub(r"\s+", " ", text)
    for what, limit in entry.smem:
        m = re.search(rf"constexpr int {limit} = (\d+);", flat)
        if m is None or int(m.group(1)) > SMEM_LIMITS[limit]:
            findings.append(Finding(
                "smem-over-budget", module, entry.qualname, limit,
                f"{entry.name}: {entry.source}.cu sets no {limit} within "
                f"{SMEM_LIMITS[limit]} bytes"))
        if f"static_assert({what} <= {limit}," not in flat:
            findings.append(Finding(
                "smem-over-budget", module, entry.qualname, what,
                f"{entry.name}: {entry.source}.cu does not hold {what} "
                f"against {limit} (static_assert({what} <= {limit}, ...))"))
    return findings


def check_case(entry: KernelEntry, case: Case, module: str) -> list:
    findings = []
    try:
        contract_of(entry)(*case.args, **case.kwargs)
    except KernelRefused as e:
        findings.append(Finding(
            "refused-shape", module, entry.qualname, case.name,
            f"{entry.name} refuses {case.name}: {e}"))
    for label, (x, y, z) in entry.grids(case):
        if y > GRID_YZ_MAX or z > GRID_YZ_MAX or x > GRID_X_MAX:
            findings.append(Finding(
                "grid-over-limit", module, entry.qualname,
                f"grid:{case.name}",
                f"{entry.name} at {case.name}: grid {label} = ({x}, {y}, "
                f"{z}) over ({GRID_X_MAX}, {GRID_YZ_MAX}, {GRID_YZ_MAX})"))
    tensors = [a for a in (*case.args, *case.kwargs.values())
               if isinstance(a, torch.Tensor)]
    ints = [max(a.shape) for a in tensors if a.dim()]
    if entry.name == "weighted_route":
        ints.append(case.args[0].numel())
    if max(ints, default=0) > INT32_MAX:
        findings.append(Finding(
            "grid-over-limit", module, entry.qualname,
            f"int32:{case.name}",
            f"{entry.name} at {case.name}: a size of {max(ints)} passed to "
            f"the C entry as an int"))
    if entry.name == "grouped_ffn" and \
            case.args[0].shape[0] > moe_ffn.MAX_GROUPS:
        findings.append(Finding(
            "grid-over-limit", module, entry.qualname,
            f"kMaxGroups:{case.name}",
            f"grouped_ffn at {case.name}: {case.args[0].shape[0]} groups "
            f"past kMaxGroups ({moe_ffn.MAX_GROUPS}): the walk runs "
            f"in index order", severity="warning"))
    return findings


def check_edges(entry: KernelEntry, module: str) -> list:
    """Each edge case's verdict on ``meta`` against the registry's."""
    findings = []
    for ec in entry.edges:
        args, kwargs = ec.build("meta", None)
        cargs, ckw = edge_contract_args(entry, args, kwargs)
        try:
            contract_of(entry)(*cargs, **ckw)
            took = True
        except KernelRefused:
            took = False
        if took != ec.accepted:
            findings.append(Finding(
                "site-mismatch", module, entry.qualname, f"edge:{ec.name}",
                f"{entry.name}: the contract {'takes' if took else 'refuses'}"
                f" the edge case {ec.name!r}, which the registry says it "
                f"{'takes' if ec.accepted else 'refuses'} — the registry is "
                f"stale"))
    return findings


def analyze_kernels(kernels_dir: str, *, registry: dict | None = None,
                    rel_prefix: str = KERNELS_REL, scales=(1, 4),
                    cases: list | None = None) -> list:
    """Run pass 1: inventory x registry at every case -> findings.
    ``cases`` defaults to ``paper_cases(scales) + record_cases()``."""
    registry = REGISTRY if registry is None else registry
    sites = iter_launch_sites(kernels_dir, rel_prefix)
    csrc_dir = os.path.join(kernels_dir, "csrc")
    entries = iter_c_entries(csrc_dir)
    findings: list = []
    seen: set = set()

    def add(fs):
        for f in fs:
            if f.fingerprint not in seen:
                seen.add(f.fingerprint)
                findings.append(f)

    known = {(e.module, e.qualname, e.source, e.entry)
             for e in registry.values()}
    others = {(src, ent) for ent, src in {**YARDSTICKS, **QUERIES}.items()}
    known_entries = {(e.source, e.entry) for e in registry.values()} | others
    for s in sites:
        if (os.path.basename(s.module), s.qualname, s.source, s.entry) in \
                known or (s.source, s.entry) in others:
            continue
        add([Finding(
            "unregistered-kernel", s.module, s.qualname,
            f"{s.source}.{s.entry}",
            f"lib({s.source!r}).{s.entry} in {s.qualname} ({s.module}:"
            f"{s.lineno}) has no entry in repro_torch.analysis.kernels."
            f"REGISTRY: declare its contract, shared memory, grids and "
            f"edge cases", lineno=s.lineno)])
    for source, ent, line in entries:
        if (source, ent) not in known_entries:
            add([Finding(
                "unregistered-kernel", f"{rel_prefix}/csrc/{source}.cu",
                ent, f"{source}.{ent}",
                f'extern "C" {ent} ({source}.cu:{line}) is no registered '
                f"kernel, yardstick or query", lineno=line)])
    cases = paper_cases(scales) + record_cases() if cases is None else cases
    for name, entry in registry.items():
        module = f"{rel_prefix}/{entry.module}"
        site = [s for s in sites if os.path.basename(s.module) ==
                entry.module and s.qualname == entry.qualname]
        if not site or (site[0].source, site[0].entry) != \
                (entry.source, entry.entry) or \
                (entry.source, entry.entry) not in \
                {(a, b) for a, b, _ in entries}:
            add([Finding(
                "site-mismatch", module, entry.qualname, "site",
                f"registry entry {name} ({entry.module}:{entry.qualname} -> "
                f"lib({entry.source!r}).{entry.entry}) matches no launch "
                f"site and C entry: the registry is stale")])
            continue
        add(check_edges(entry, module))
        with open(os.path.join(csrc_dir, f"{entry.source}.cu")) as fh:
            add(check_smem(entry, fh.read(), module))
        for case in cases:
            if case.kernel == name:
                add(check_case(entry, case, module))
    return findings
