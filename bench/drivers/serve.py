"""Serving cells: open-loop requests into ``runtime.engine.ServingEngine``
over ``runtime.server.MoEServer`` (Lina's two-phase policy), each
request submitted at its due time and stamped from it, one engine step
after another as requests come due.

Set-up makes the weights from the seed, builds the popularity profile
from the same traffic (``runtime.server.profile_from_training``), the
server and the engine, and serves a warm-up burst of the traffic's own
shapes plus the largest batch the engine can form from it.  The window
submits requests as they come due for ``seconds``, then drains what was
due (at most ``drain_s`` more); a request unserved by then has failed.

``correct``: once the window has closed and the program is freed, the
float32 reference recomputes the batches of a sample of engine steps
drawn from the seed, the step that served the longest prompt among them,
as the engine forms them (rows in arrival order, right-padded to the
longest, empty rows up to a power of two, capacity from the valid
tokens), and reads by how much each
served token's logit lies below the reference's best.  The batches
themselves are the engine's: which requests shared a step is read off
the steps' outputs and checked against the engine's batching rules.
"""
from __future__ import annotations

import gc
import sys
import time

import numpy as np

from bench import harness as H
from bench import trace as T
from bench.reference import transformer as ref
from bench.yardstick import flops as FL
from bench.yardstick import tails
from bench.yardstick import traffic as TR
from bench.yardstick import weights as WT

TRACE_STEPS = 4


def build(cell: H.Cell, seed: int, device: str, trace: bool):
    """(engine, server) with the weights of ``seed``."""
    import torch
    from repro_torch.obs import ObsContext
    from repro_torch.runtime.engine import EngineConfig, ServingEngine
    from repro_torch.runtime.server import (MoEServer, ServerConfig,
                                            profile_from_training)
    m, w, mix = cell.model, cell.workload, cell.traffic
    cfg = H.port_config(m, cell.config["port_config"])
    dev = torch.device(device)
    W = WT.make(m, seed, dev)
    params = H.program_params(cfg, W)
    del W
    src = TR.mixture(m["vocab_size"], mix, seed)
    g = TR.rng(seed, 5)
    pb = w["profile"]
    prof_batches = [{"tokens": src.draw(g, pb["batch"] * pb["seq"])
                     .reshape(pb["batch"], pb["seq"])}
                    for _ in range(pb["batches"])]
    sc = w["server"]
    prof = profile_from_training(cfg, params, prof_batches,
                                 path_len=sc["path_len"], device=dev)
    obs = ObsContext.enabled() if trace else ObsContext.disabled()
    server = MoEServer(cfg, params, prof,
                       ServerConfig(top_k=sc["top_k"], path_len=sc["path_len"],
                                    schedule_policy=sc["policy"]),
                       obs=obs, device=dev)
    ec = w["engine"]
    engine = ServingEngine(server, EngineConfig(
        max_batch_tokens=ec["max_batch_tokens"],
        max_batch_requests=ec["max_batch_requests"]))
    return engine, server


def warm_up(engine, cell: H.Cell, seed: int) -> None:
    """The largest batch the engine forms from this traffic (the longest
    prompt beside prompts filling the token budget, rows to the bucket of
    ``max_batch_requests``) through the server's entry, then a burst of
    the traffic's own requests through the engine."""
    mix, ec = cell.traffic, cell.workload["engine"]
    p = mix["prompt"]
    rows, budget = ec["max_batch_requests"], ec["max_batch_tokens"]
    lens = [p["max_len"]]
    rest = budget - p["max_len"]
    while len(lens) < rows // 2 + 1 and rest >= p["min_len"]:
        n = min(rest, max(p["min_len"], rest // (rows // 2)))
        lens.append(n)
        rest -= n
    bucket = 1 << (len(lens) - 1).bit_length()
    toks = np.zeros((bucket, p["max_len"]), np.int64)
    lengths = np.zeros((bucket,), np.int64)
    lengths[:len(lens)] = lens
    engine.server.serve_batch(toks, lengths=lengths)
    burst = TR.serve_requests(cell.model["vocab_size"], mix, seed ^ 0x5A5A,
                              cell.workload["rate"],
                              cell.workload["warmup_seconds"])
    for tok, _ in burst:
        engine.submit(tok, arrival=time.perf_counter(), max_new_tokens=1)
    while engine.has_work():
        engine.step()


def sync(device: str) -> None:
    import torch
    if device == "cuda":
        torch.cuda.synchronize()


def serve_window(engine, reqs: list, seconds: float, drain_s: float,
                 on_step=None, device: str = "cuda"):
    """Submit each request at its due time, step while work waits.
    Returns (t0, due [abs s], done {i: first token s}, served token {i},
    steps [[i, ...] in row order], drain end)."""
    idx_of = {}
    done, token, steps = {}, {}, []
    sync(device)
    t0 = time.perf_counter()
    due = [t0 + t for _, t in reqs]
    deadline = t0 + seconds + drain_s
    i = 0
    while True:
        now = time.perf_counter()
        while i < len(reqs) and due[i] <= now:
            rid = engine.submit(reqs[i][0], arrival=due[i], max_new_tokens=1)
            idx_of[rid] = i
            i += 1
        if engine.has_work():
            out = engine.step()
            if out:
                steps.append([idx_of[r.rid] for r in out])
                for r in out:
                    done[idx_of[r.rid]] = r.ttft
                    token[idx_of[r.rid]] = int(r.tokens[0])
                if on_step is not None:
                    on_step(len(steps))
        elif i < len(reqs):
            time.sleep(max(0.0, min(due[i] - now, 0.005)))
        else:
            break
        if time.perf_counter() > deadline:
            break
    return t0, due, done, token, steps, time.perf_counter()


def batch_rule_breaks(steps: list, reqs: list, ec: dict) -> int:
    """Steps whose rows break the engine's rules: arrival order, at most
    ``max_batch_requests`` rows, the token budget unless one row."""
    bad = 0
    for rows in steps:
        n_tok = sum(len(reqs[i][0]) for i in rows)
        bad += (rows != sorted(rows) or len(rows) > ec["max_batch_requests"]
                or (len(rows) > 1 and n_tok > ec["max_batch_tokens"]))
    return bad


def sample_steps(steps: list, reqs: list, seed: int, n: int) -> list:
    """Indices of engine steps drawn from the seed, the step that served
    the longest prompt first, until they hold ``n`` requests or more."""
    longest = max((i for rows in steps for i in rows),
                  key=lambda i: len(reqs[i][0]))
    first = next(j for j, rows in enumerate(steps) if longest in rows)
    order = [first] + [int(j) for j in TR.rng(seed, 6).permutation(
        len(steps)) if j != first]
    out, held = [], 0
    for j in order:
        if held >= n:
            break
        out.append(j)
        held += len(steps[j])
    return sorted(out)


def reference_gaps(cell: H.Cell, seed: int, reqs: list, token: dict,
                   steps: list, chosen: list, device: str,
                   precs=("fp32",)) -> dict:
    """{prec: [(request index, gap)]}: for each served request of the
    chosen steps, the float32 reference's best logit less its logit of
    the served token; for another precision, less its float32 logit of
    the token that precision puts first."""
    import torch
    ref.no_tf32()
    dev = torch.device(device)
    m = cell.model
    top_k = cell.workload["server"]["top_k"]
    W = WT.make(m, seed, dev)
    out = {p: [] for p in precs}
    with torch.no_grad():
        for j in chosen:
            rows = steps[j]
            lens = [len(reqs[i][0]) for i in rows]
            bucket = 1 << (len(rows) - 1).bit_length()
            toks = torch.zeros((bucket, max(lens)), dtype=torch.long,
                               device=dev)
            for r, i in enumerate(rows):
                toks[r, :lens[r]] = torch.as_tensor(reqs[i][0], device=dev)
            lengths = torch.zeros(bucket, dtype=torch.long, device=dev)
            lengths[:len(rows)] = torch.as_tensor(lens, device=dev)
            base = ref.prefill_last_logits(W, m, toks, lengths, top_k,
                                           ref.Prec("fp32"))
            best = base.max(-1).values
            for p in precs:
                if p == "fp32":
                    pick = torch.as_tensor([token[i] for i in rows],
                                           device=dev)
                else:
                    pick = ref.prefill_last_logits(
                        W, m, toks, lengths, top_k, ref.Prec(p)).argmax(-1)
                gap = best - base.gather(1, pick[:, None])[:, 0]
                out[p] += list(zip(rows, gap.tolist()))
    return out


def run(cell: H.Cell, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda") -> dict:
    import torch
    # the host path runs small CPU tensor ops each layer: few threads
    # keep its timing steady (one process, few threads)
    threads = torch.get_num_threads()
    torch.set_num_threads(cell.workload["host_threads"])
    try:
        return _run(cell, seed, seconds, trace, t_start, device)
    finally:
        torch.set_num_threads(threads)


def _run(cell: H.Cell, seed: int, seconds: float, trace: bool,
         t_start: float, device: str) -> dict:
    import torch
    w, m = cell.workload, cell.model
    engine, server = build(cell, seed, device, trace)
    warm_up(engine, cell, seed)
    reqs = TR.serve_requests(m["vocab_size"], cell.traffic, seed, w["rate"],
                             seconds)
    cap = {"rec": None, "tries": 0}
    ins = T.Instrument() if trace else None
    rf = torch.profiler.record_function

    start = {}

    def on_step(n):
        """Capture ``TRACE_STEPS`` engine steps once 40% of the window has
        passed (later tries after a lost session); reading a session stalls
        the engine, so nothing after the first capture is read."""
        now = time.perf_counter()
        start.setdefault("t", now)
        if not trace or cap["rec"] is not None or cap["tries"] >= 3:
            return
        if "obj" not in cap:
            if now - start["t"] >= 0.4 * seconds:
                cap["obj"] = T.Capture(ins)
                cap["obj"].start()
                cap["at"] = n
        elif n == cap["at"] + 1:
            cap["obj"].arm()
            cap["from"] = n
        elif n == cap["at"] + 1 + TRACE_STEPS:
            cap["tries"] += 1
            try:
                cap["rec"] = cap["obj"].stop(TRACE_STEPS)
                cap["steps"] = (cap["from"], n)
                cap["t"] = (cap["obj"].t0, cap["obj"].t0
                            + cap["rec"]["window_s"])
            except T.CaptureLost as e:
                print(f"trace: session dropped: {e}", file=sys.stderr)
                del cap["obj"]
    if ins is not None:
        ins.__enter__()
        step = engine.step

        def ranged_step(*a, **kw):
            with rf("bench.engine_step"):
                return step(*a, **kw)
        engine.step = ranged_step
    try:
        t0, due, done, token, steps, end = serve_window(
            engine, reqs, seconds, w["drain_s"], on_step, device)
    finally:
        if ins is not None:
            ins.__exit__(None, None, None)
    setup_s = t0 - t_start
    lat = tails.latencies([d - t0 for d in due],
                          {i: v - t0 for i, v in done.items()}, end - t0)
    n_tok = [sum(len(reqs[i][0]) for i in rows) for rows in steps]
    in_window = sum(len(reqs[i][0]) for i, t in done.items()
                    if t <= t0 + seconds) / seconds
    worst = int(np.argmax(lat)) if len(lat) else 0
    print(f"serve: {len(steps)} steps, {np.mean(n_tok) if n_tok else 0:.0f} "
          f"prompt tokens a step; ttft p50 "
          f"{tails.percentile(lat, 50) * 1e3:.1f} ms, p95 "
          f"{tails.percentile(lat, 95) * 1e3:.1f}, max "
          f"{lat.max() * 1e3 if len(lat) else 0:.1f} (due at "
          f"{reqs[worst][1] if reqs else 0:.2f} s); over 200 ms "
          f"{int((lat > 0.2).sum())} of {len(lat)}; {in_window:.1f} prompt "
          f"tokens/s completed in the window", file=sys.stderr)
    rec = cap["rec"]
    if rec is not None:
        a, b = cap["steps"]
        served = [i for rows in steps[a:b] for i in rows]
        rec["flops"] = sum(FL.step_flops(m, "prefill", 1, len(reqs[i][0]))
                           for i in served)
        rec["server_layer_s"] = _span_seconds(server.obs.tracer,
                                              "server.layer", *cap["t"])
        rec["batch_tokens_mean"] = float(np.mean(n_tok[:b]))
    cuda = device == "cuda"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    del engine, server
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = H.Checks()
    limits = w["limits"]
    checks.add("unserved", len(reqs) - len(done), 0)
    checks.add("batch_rule_breaks", batch_rule_breaks(steps, reqs,
                                                      w["engine"]), 0)
    gaps, chosen = [], []
    if steps:
        chosen = sample_steps(steps, reqs, seed, w["check_requests"])
        gaps = [g for _, g in reference_gaps(cell, seed, reqs, token, steps,
                                             chosen, device)["fp32"]]
    for k, v in gap_numbers(gaps).items():
        if k in limits:
            checks.add(k, v, limits[k])
    return {"attempted": len(reqs), "failed": len(reqs) - len(done),
            "e2e": {"ttft_p95_ms": tails.percentile(lat, 95) * 1e3,
                    "tokens_per_s": in_window,
                    "setup_s": setup_s},
            "checks": checks, "rec": rec, "memory_peak_bytes": peak,
            "readings": {"gaps": gaps, "n_compared": len(gaps),
                         "steps": len(steps),
                         "batch_tokens_mean": float(np.mean(n_tok))
                         if n_tok else 0.0,
                         "ttft_p50_ms": tails.percentile(lat, 50) * 1e3},
            "window": {"reqs": reqs, "token": token, "steps": steps,
                       "chosen": chosen}}


def gap_numbers(gaps: list) -> dict:
    """What is read off the served tokens' gaps: the widest, the 90th
    percentile (numpy's linear), the mean; none compared is a failure."""
    if not gaps:
        return {k: float("inf") for k in ("served_gap_max",
                                           "served_gap_p90",
                                           "served_gap_mean")}
    g = np.asarray(gaps, dtype=np.float64)
    return {"served_gap_max": float(g.max()),
            "served_gap_p90": float(np.percentile(g, 90)),
            "served_gap_mean": float(g.mean())}


def _span_seconds(tracer, name: str, t0: float, t1: float) -> float:
    tot = 0.0
    stack = list(tracer.roots)
    while stack:
        sp = stack.pop()
        if sp.name == name and t0 <= sp.start <= t1:
            tot += sp.duration
        stack.extend(sp.children)
    return tot
