"""The program's ranges and counts (``repro_torch.obs``) on the CPU:
``region`` is ``NOOP`` with no profiler session; under a CPU profiler a
train step of a tiny MoE config shows each layer range (again in the remat
recompute, inside a backward node) and every backward node with a
sequence number maps to a range; ``region_split`` on synthetic captures
(each kernel to one range, the sums whole); the MoE layer's routed and
kept (token, choice) pairs, equal with and without remat and to a direct
``kept_counts`` sum; a recording Tracer's spans as ranges; and
``REGIONS`` as the one list of the names the program opens."""
import ast
import dataclasses
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import profile

from _torch_threads import share_cores
from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.core import gating as G
from repro_torch.core import moe as moe_mod
from repro_torch.launch.steps import make_train_step
from repro_torch.models import lm
from repro_torch.obs import counters
from repro_torch.obs import profiler as P
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.tree import tree_map

share_cores()

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def setup(arch="gpt2-moe-smoke", remat=True, backend="auto", seq=16,
          dtype="float32"):
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, remat=remat, dtype=dtype,
                              moe=dataclasses.replace(
                                  cfg.moe, compute_backend=backend))
    gen = torch.Generator().manual_seed(0)
    params = lm.init_params(cfg, gen, device="cpu")
    tok = torch.randint(0, cfg.vocab_size, (2, seq + 1), generator=gen)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    return cfg, params, batch


def test_region_is_noop_without_a_session():
    assert obs.region("lm.moe") is obs.NOOP
    assert obs.region("not.a.range") is obs.NOOP      # not checked then
    with profile() as p:
        assert obs.region("lm.moe") is not obs.NOOP
        with pytest.raises(ValueError, match="not a range"):
            obs.region("not.a.range")
        with obs.region("lm.loss"):
            torch.ones(2) + 1
    assert "lm.loss" in {e.name for e in p.events()}
    assert obs.region("lm.moe") is obs.NOOP
    assert len(set(obs.REGIONS)) == len(obs.REGIONS)


def test_a_recording_tracer_opens_the_range_of_each_span():
    on, off = obs.Tracer(enabled=True), obs.Tracer(enabled=False)
    with profile() as p:
        with on.span("train.step"):
            with on.timed("fwd_bwd"):
                torch.ones(2) * 2
        with on.timed("decode", record=False):  # records nothing
            pass
        with off.span("data.batch") as sp:
            sp.set(skipped=True)
        with off.timed("checkpoint"):
            pass
    names = [e.name for e in p.events()]
    assert names.count("train.step") == names.count("fwd_bwd") == 1
    assert not {"decode", "data.batch", "checkpoint"} & set(names)
    assert [r.name for r in on.roots] == ["train.step"]
    assert [c.name for c in on.roots[0].children] == ["fwd_bwd"]


def _ranges(events):
    """{range: (outside a backward node, inside one)} of a capture."""
    out = {}
    for e in events:
        if e.name in obs.REGIONS:
            p, inside = e.cpu_parent, False
            while p is not None:
                inside |= p.name.startswith(P.BACKWARD_NODE)
                p = p.cpu_parent
            f, b = out.get(e.name, (0, 0))
            out[e.name] = (f + (not inside), b + inside)
    return out


@pytest.mark.parametrize("remat", [True, False])
def test_a_train_step_shows_each_range_and_every_node_maps(remat):
    # bf16 compute, so that the fp32 masters' cast has a backward
    cfg, params, batch = setup(remat=remat, dtype="bfloat16")
    step = make_train_step(cfg)
    opt = init_opt_state(params, AdamWConfig(state_dtype=cfg.opt_state_dtype))
    step(params, opt, batch)                    # the first call's set-up
    with profile() as p:
        step(params, opt, batch)
    ev = p.events()
    got = _ranges(ev)
    n = cfg.n_layers
    want = {"lm.cast": (1, 0), "lm.embed": (1, 0), "lm.loss": (1, 0),
            "optim.update": (1, 0), "lm.stack": (2 * n, 0),
            "lm.attention": (n, n if remat else 0),
            "lm.moe": (n, n if remat else 0)}
    assert got == want
    of = P.attribution(ev)
    nodes = [e for e in ev if e.name.startswith(P.BACKWARD_NODE)
             and e.sequence_nr >= 0]
    assert nodes
    mapped = [of(e) for e in nodes]
    assert all(m is not None and m[1] == "backward" for m in mapped), \
        [e.name for e, m in zip(nodes, mapped) if m is None]
    assert {m[0] for m in mapped} == {"lm.cast", "lm.embed", "lm.stack",
                                      "lm.attention", "lm.moe", "lm.loss"}
    # the ops inside a range inside a backward node are its recompute
    ops = {of(e) for e in ev if e.name.startswith("aten::")}
    for r in ("lm.attention", "lm.moe"):
        assert (r, "forward") in ops and (r, "backward") in ops
        assert ((r, "recompute") in ops) == remat


@pytest.mark.parametrize("arch,rng", [("rwkv6-1.6b-smoke", "lm.rwkv"),
                                      ("zamba2-1.2b-smoke", "lm.hybrid")])
def test_the_recurrent_stacks_range_each_layer(arch, rng):
    cfg, params, batch = setup(arch, remat=True, seq=8)
    ps = tree_map(lambda t: t.detach().requires_grad_(), params)
    with profile() as p:
        out = lm.forward_train(cfg, ps, batch)
        out.loss.backward()
    got = _ranges(p.events())
    assert got[rng] == (cfg.n_layers, cfg.n_layers)
    assert got["lm.loss"] == (1, 0) and "lm.moe" not in got


def _direct_kept(cfg, params, batch, remat):
    """(routed, kept) pairs of one forward, from the gating's own
    results (``kept_counts`` summed), forward calls only."""
    seen = []
    orig = moe_mod.router_top_k_gating

    def gating(*a, **kw):
        g = orig(*a, **kw)
        if torch._C._current_graph_task_id() == -1:
            seen.append(g)
        return g
    moe_mod.router_top_k_gating = gating
    try:
        lm.forward_train(dataclasses.replace(cfg, remat=remat), params,
                         batch)
    finally:
        moe_mod.router_top_k_gating = orig
    e = cfg.moe.n_experts
    return (sum(g.expert_idx.numel() for g in seen),
            sum(int(G.kept_counts(g, e).sum()) for g in seen))


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_kept_and_routed_pairs_with_and_without_remat(backend):
    cfg, params, batch = setup(remat=False, backend=backend)
    # a tight capacity so that some pairs are dropped
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.5))
    ps = tree_map(lambda t: t.detach().requires_grad_(), params)
    totals = []
    for remat in (False, True):
        with obs.counting() as c:
            out = lm.forward_train(dataclasses.replace(cfg, remat=remat),
                                   ps, batch)
            out.loss.backward()
        totals.append(c.totals)
    routed, kept = _direct_kept(cfg, params, batch, False)
    want = {"moe.routed_pairs": routed, "moe.kept_pairs": kept}
    assert totals == [want, want]
    assert routed == 2 * 16 * cfg.moe.top_k * cfg.n_layers
    assert 0 < kept < routed


def test_counting_is_one_block_and_off_outside_it():
    assert not counters.active()
    with obs.counting() as c:
        assert counters.active()
        with pytest.raises(RuntimeError, match="open already"):
            obs.counting().__enter__()
        counters.add("moe.routed_pairs", 3)
        counters.add("moe.routed_pairs", torch.tensor(4))
        with pytest.raises(ValueError):
            counters.add("moe.other", 1)
        x = torch.ones(2, requires_grad=True)

        class Probe(torch.autograd.Function):
            @staticmethod
            def forward(ctx, t):
                return t * 1

            @staticmethod
            def backward(ctx, g):
                seen.append(counters.active())
                return g
        seen = []
        Probe.apply(x).sum().backward()
        assert seen == [False]              # a backward does not count
    assert c.totals == {"moe.routed_pairs": 7}
    assert not counters.active()


class _Ev:
    """A profiler event: CPU (with its kernels) or device."""

    def __init__(self, name, parent=None, kernels=(), seq=-1, thread=1,
                 fwd_thread=0, dev=False, start=0.0, dur=0.0, ann=False):
        self.name = name
        self.device_type = DeviceType.CUDA if dev else DeviceType.CPU
        self.cpu_parent = parent
        self.kernels = [SimpleNamespace(name=k, duration=d)
                        for k, d in kernels]
        self.sequence_nr, self.thread, self.fwd_thread = seq, thread, \
            fwd_thread
        self.time_range = SimpleNamespace(start=start, end=start + dur)
        self.is_user_annotation = ann


def _dev(*kernels):
    return [_Ev(k, dev=True, start=10.0 * i, dur=d)
            for i, (k, d) in enumerate(kernels)]


def test_region_split_gives_each_kernel_to_one_range():
    step = _Ev("ProfilerStep#1", ann=True)
    attn = _Ev("lm.attention", step, ann=True)
    mm = _Ev("aten::mm", attn, [("gemm", 4.0)], seq=7)
    loss = _Ev("lm.loss", step, ann=True)
    ce = _Ev("aten::log_softmax", loss, [("softmax", 3.0)], seq=9)
    # the backward of the attention's mm, linked by (sequence_nr, thread)
    node = _Ev(P.BACKWARD_NODE + "MmBackward0", seq=7, thread=2,
               fwd_thread=1)
    bmm = _Ev("aten::mm", _Ev("MmBackward0", node), [("gemm", 5.0)],
              thread=2)
    # the combine's node runs the group's recompute: its ranges claim it
    comb = _Ev(P.BACKWARD_NODE + "_CombineBackward", seq=11, thread=2,
               fwd_thread=1)
    re_attn = _Ev("lm.attention", comb, ann=True, thread=2)
    re_mm = _Ev("aten::mm", re_attn, [("gemm", 4.0)], seq=3, thread=2)
    moe = _Ev("lm.moe", step, ann=True)
    fwd_comb = _Ev("_Combine", moe, seq=11)
    comb_k = _Ev("aten::index_add_", comb, [("combine_bwd", 2.0)], thread=2)
    # a node with no sequence link, and a kernel under no range
    acc = _Ev(P.BACKWARD_NODE + "torch::autograd::AccumulateGrad",
              thread=2)
    acc_k = _Ev("aten::add_", acc, [("add", 1.0)], thread=2)
    seed = _Ev("aten::ones_like", step, [("fill", 0.5)])
    dev = _dev(("gemm", 4.0), ("softmax", 3.0), ("gemm", 5.0),
               ("gemm", 4.0), ("combine_bwd", 2.0), ("add", 1.0),
               ("fill", 0.5))
    # the ranges' own device annotations are not kernels
    dev += [_Ev("lm.attention", dev=True, dur=9.0, ann=True),
            _Ev("ProfilerStep#1", dev=True, dur=30.0, ann=True)]
    events = [step, attn, mm, loss, ce, node, bmm, comb, re_attn, re_mm,
              moe, fwd_comb, comb_k, acc, acc_k, seed] + dev
    got = P.region_split(events)
    z = dict.fromkeys(P.PHASES, 0.0)
    assert got["regions"] == {
        "lm.attention": dict(z, forward=4e-6, recompute=4e-6,
                             backward=5e-6),
        "lm.loss": dict(z, forward=3e-6),
        "lm.moe": dict(z, backward=2e-6)}
    assert got["device_s"] == pytest.approx(19.5e-6)
    assert got["unranged_s"] == pytest.approx(1.5e-6)
    ranged = sum(sum(v.values()) for v in got["regions"].values())
    assert ranged + got["unranged_s"] == pytest.approx(got["device_s"])


def test_a_node_without_a_link_is_unranged():
    node = _Ev(P.BACKWARD_NODE + "AddBackward0", seq=5, thread=2,
               fwd_thread=1)
    k = _Ev("aten::add", node, [("add", 2.0)], thread=2)
    fwd = _Ev("aten::add", _Ev("lm.moe"), seq=5, thread=3)   # other thread
    got = P.region_split([node, k, fwd] + _dev(("add", 2.0)))
    assert got["regions"] == {}
    assert got["unranged_s"] == pytest.approx(2e-6)


def test_regions_is_the_one_list_of_range_names():
    """Every name the source passes to ``region`` or to a span or a
    recording stopwatch of the Tracer is one of ``REGIONS``, and every
    one of ``REGIONS`` is written in the source outside the list."""
    opened, written = set(), set()
    for f in SRC.rglob("*.py"):
        tree = ast.parse(f.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and \
                    isinstance(node.value, str) and f.name != "tracer.py":
                written.add(node.value)
            if not (isinstance(node, ast.Call) and node.args):
                continue
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else \
                getattr(fn, "id", None)
            quiet = any(k.arg == "record" and isinstance(k.value, ast.Constant)
                        and k.value.value is False for k in node.keywords)
            if name in ("region", "span", "timed") and not quiet:
                a = node.args[0]
                cands = [a.body, a.orelse] if isinstance(a, ast.IfExp) \
                    else [a]
                opened |= {c.value for c in cands
                           if isinstance(c, ast.Constant)}
    assert opened <= set(obs.REGIONS), sorted(opened - set(obs.REGIONS))
    assert set(obs.REGIONS) <= written, sorted(set(obs.REGIONS) - written)
    assert set(obs.REGIONS) <= opened, sorted(set(obs.REGIONS) - opened)
