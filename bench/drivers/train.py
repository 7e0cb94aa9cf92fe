"""Training cells: the port's train step as ``runtime.trainer.Trainer``
builds it (``Trainer.step_fn``, from ``launch.steps.make_train_step``),
fed the benchmark's batches, one step after another as the trainer runs
them (each step's metrics read to the host).

Set-up makes the weights and the batches from the seed, builds the one
trainer whose step the window drives, and drives it through its first
three steps on distinct rows: they warm every shape and give the
program's readings (each step's loss; after step 1 each leaf's gradient
as the optimizer got it, from its first moment; after step 3 each
leaf's change; each step's expert choices, layer by layer, as the MoE
layer's gating returned them).  The window then steps on until
``seconds`` have passed.  Once it has closed, the program's state is
freed and the float32 reference follows the same three steps from the
same weights, routed by the program's expert choices, each judged by the
reference's own router logits (``reference.transformer.Routing``).
"""
from __future__ import annotations

import contextlib
import gc
import math
import os
import statistics
import sys
import tempfile
import time

from bench import harness as H
from bench import trace as T
from bench.reference import transformer as ref
from bench.yardstick import flops as FL
from bench.yardstick import traffic as TR
from bench.yardstick import weights as WT

SETUP_STEPS = 3
TRACE_STEPS = 3


def opt_config(cell: H.Cell):
    from repro_torch.optim.adamw import AdamWConfig
    o = cell.workload["optimizer"]
    return AdamWConfig(lr=o["lr"], betas=tuple(o["betas"]), eps=o["eps"],
                       weight_decay=o["weight_decay"],
                       grad_clip=o["grad_clip"],
                       warmup_steps=o["warmup_steps"],
                       total_steps=o["total_steps"],
                       state_dtype=cell.model["opt_state_dtype"])


def build(cell: H.Cell, seed: int, device: str):
    """(the trainer's step with metrics read to the host, params, opt
    state, batches on the device, weights)."""
    import torch
    from repro_torch.data import DataConfig
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    m, mix = cell.model, cell.traffic
    cfg = H.port_config(m, cell.config["port_config"])
    dev = torch.device(device)
    W = WT.make(m, seed, dev)
    params = H.program_params(cfg, W)
    opt_cfg = opt_config(cell)
    trainer = Trainer(cfg, DataConfig(vocab_size=m["vocab_size"],
                                      seq_len=mix["seq"],
                                      global_batch=mix["batch"]),
                      opt_cfg, TrainerConfig(
                          device=device, ckpt_dir=os.path.join(
                              tempfile.gettempdir(), "bench_train_ckpt")))
    step_fn = trainer.step_fn

    def step(p, o, b):
        p, o, met = step_fn(p, o, b)
        return p, o, {k: float(v) for k, v in met.items()}       # waits
    host = TR.train_batches(m["vocab_size"], mix, seed,
                            SETUP_STEPS + cell.workload["window_batches"])
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
               for b in host]
    return step, params, init_opt_state(params, opt_cfg), batches, W


def leaf_norms(tree, scale: float = 1.0) -> dict:
    return {H.bench_name(p): float(t.float().norm()) * scale
            for p, t in H.named_leaves(tree)}


@contextlib.contextmanager
def recorded_routes(out: list):
    """Each call of the MoE layer's gating appends the expert choices it
    returned ([T, k]) to ``out``, for the life of the block."""
    from repro_torch.core import moe as moe_mod
    orig = moe_mod.router_top_k_gating

    def gating(*a, **kw):
        g = orig(*a, **kw)
        out.append(g.expert_idx.detach().clone())
        return g
    moe_mod.router_top_k_gating = gating
    try:
        yield
    finally:
        moe_mod.router_top_k_gating = orig


def setup_readings(step, params, opt_state, batches, b1: float,
                   n_layers: int):
    """Steps 1-3 on ``batches[:3]``: (params, opt state, readings).  A
    step's expert choices are its first ``n_layers`` gating calls (the
    forward; under remat the backward calls it again)."""
    p0 = dict(H.named_leaves(params))
    losses, grad, routes = [], None, []
    for i in range(SETUP_STEPS):
        calls = []
        with recorded_routes(calls):
            params, opt_state, met = step(params, opt_state, batches[i])
        routes.append(calls[:n_layers])
        losses.append(met["loss"])
        if i == 0:              # the first moment is (1 - b1) g after one
            grad = leaf_norms(opt_state.m, 1.0 / (1.0 - b1))
            first = {H.bench_name(p): (t.float() / (1.0 - b1)).cpu()
                     for p, t in H.named_leaves(opt_state.m)}
    change = {H.bench_name(p): float((t.float() - p0[p].float()).norm())
              for p, t in H.named_leaves(params)}
    return params, opt_state, {"loss": losses, "grad_norm": grad,
                               "change_norm": change, "first_grad": first,
                               "routes": routes}


def reference_readings(cell: H.Cell, seed: int, batches, device: str,
                       prec: str = "fp32", routes=None) -> dict:
    """The reference's three steps from the same weights and batches,
    routed by ``routes`` (a step's list of a layer's choices) where
    given, else by its own choices, which it returns."""
    import torch
    ref.no_tf32()
    W = WT.make(cell.model, seed, torch.device(device))
    P = {k: v.detach().clone().requires_grad_() for k, v in W.items()}
    adam = ref.AdamW(P, cell.workload["optimizer"])
    pr = ref.Prec(prec)
    losses, grad, chosen, gap, flips = [], None, [], 0.0, 0
    for i, b in enumerate(batches[:SETUP_STEPS]):
        rt = ref.Routing(None if routes is None else routes[i])
        loss = ref.train_loss(P, b, cell.model, pr, rt)
        g = dict(zip(P, torch.autograd.grad(loss, list(P.values()))))
        clipped = adam.update(P, g)
        losses.append(float(loss.detach()))
        if i == 0:
            grad = {k: float(c.norm()) for k, c in clipped.items()}
            first = clipped
        chosen.append([rt.chosen[l] for l in sorted(rt.chosen)])
        gap, flips = max(gap, rt.gap), flips + rt.flips
        del g, clipped
    change = {k: float((P[k].detach() - W[k]).norm()) for k in P}
    return {"loss": losses, "grad_norm": grad, "change_norm": change,
            "first_grad": first, "routes": chosen, "route_gap": gap,
            "route_flips": flips}


def grad_errors(prog: dict, want: dict) -> dict:
    """Each leaf's error of the first gradient element by element: the
    norm of the difference over the larger of the reference's norm of
    that leaf and of the median leaf, over the leaves the reference's
    gradient moves (at least a thousandth of the median leaf's)."""
    g_ref = want["grad_norm"]
    g_med = statistics.median(g_ref.values())
    dev = next(iter(want["first_grad"].values())).device
    return {k: float((prog["first_grad"][k].to(dev)
                      - want["first_grad"][k]).norm()) / max(v, g_med)
            for k, v in g_ref.items() if v >= g_med / 1000}


def compare(prog: dict, want: dict) -> dict:
    """The numbers compared, ``want`` being the reference routed by the
    choices of ``prog``: the widest gap of a choice below the reference's
    own ranking (router logits); the worst step's loss gap over the
    reference's loss; the worst leaf's gap of gradient norms, and of
    change norms over the leaves the reference's gradient moves (at
    least a thousandth of the median leaf's), each over the larger of
    the reference's norm of that leaf and of the median leaf; and the
    worst and the median leaf's error of the first gradient element by
    element (``grad_errors``), which random rounding moves where norms
    and means average it away."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"],
                                                   want["loss"]))
    g_ref = want["grad_norm"]
    g_med = statistics.median(g_ref.values())
    grad = max(abs(prog["grad_norm"][k] - v) / max(v, g_med)
               for k, v in g_ref.items())
    moved = [k for k, v in g_ref.items() if v >= g_med / 1000]
    d_ref = want["change_norm"]
    d_med = statistics.median(d_ref[k] for k in moved)
    change = max(abs(prog["change_norm"][k] - d_ref[k]) / max(d_ref[k], d_med)
                 for k in moved)
    err = grad_errors(prog, want)
    return {"route_gap": want["route_gap"], "loss_gap": loss,
            "grad_gap": grad, "change_gap": change,
            "grad_err_max": max(err.values()),
            "grad_err_median": statistics.median(err.values())}


def run(cell: H.Cell, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda") -> dict:
    import torch
    cuda = device == "cuda"
    t_built = time.perf_counter()
    step, params, opt_state, batches, W = build(cell, seed, device)
    b1 = cell.workload["optimizer"]["betas"][0]
    t_steps = time.perf_counter()
    params, opt_state, prog = setup_readings(step, params, opt_state,
                                             batches, b1,
                                             cell.model["n_layers"])
    del W
    print(f"train: set-up {t_built - t_start:.1f} s to the driver (imports),"
          f" {t_steps - t_built:.1f} s weights, batches and trainer, "
          f"{time.perf_counter() - t_steps:.1f} s three steps (kernel build "
          f"or load included)", file=sys.stderr)
    mix = cell.traffic
    tokens = mix["batch"] * mix["seq"]
    cyc = batches[SETUP_STEPS:]
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    n = failed = 0
    while True:
        params, opt_state, met = step(params, opt_state, cyc[n % len(cyc)])
        n += 1
        failed += not math.isfinite(met["loss"])
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    rec = None
    if trace:
        rec = _capture(step, params, opt_state, cyc)
        if rec is not None:
            rec["step_flops"] = FL.step_flops(cell.model, "train",
                                              mix["batch"], mix["seq"])
            rec["window_step_s"] = elapsed / n
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    del params, opt_state, step, cyc
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    want = reference_readings(cell, seed, batches, device,
                              routes=prog.pop("routes"))
    checks = H.Checks()
    limits = cell.workload["limits"]
    got = compare(prog, want)
    for k, v in got.items():
        if k in limits:
            checks.add(k, v, limits[k])
    return {"attempted": n, "failed": failed,
            "e2e": {"tokens_per_s": n * tokens / elapsed,
                    "setup_s": setup_s},
            "checks": checks, "rec": rec, "memory_peak_bytes": peak,
            "readings": got}


def _capture(step, params, opt_state, cyc, tries: int = 3):
    import torch
    rf = torch.profiler.record_function
    with T.Instrument() as ins:
        for _ in range(tries):
            cap = T.Capture(ins)
            cap.start()
            params, opt_state, _ = step(params, opt_state, cyc[0])
            cap.arm()
            for j in range(TRACE_STEPS):
                with rf("bench.train_step"):
                    params, opt_state, _ = step(params, opt_state,
                                                cyc[(j + 1) % len(cyc)])
            try:
                return cap.stop(TRACE_STEPS)
            except T.CaptureLost as e:
                print(f"trace: session dropped: {e}", file=sys.stderr)
    return None
