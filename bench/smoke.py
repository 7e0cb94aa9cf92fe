"""The cells at a size a CPU test run holds: the same files with every
width and count cut (``SMOKE``), the program on its plain route, the
weights and batches made as the benchmark makes them.  For the tests in
this directory only; the benchmark's runs use the cells' own files."""
from __future__ import annotations

import copy

from bench import harness as H

SMOKE_MODEL = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
               "head_dim": 16, "d_ff": 128, "vocab_size": 512}
SMOKE_MOE = {"n_experts": 4, "d_ff": 128}
SMOKE_TOKENS = {"topics": 4, "pool": 64}


def smoke_cell(name: str, dtype: str = "bfloat16") -> H.Cell:
    """The cell ``name`` cut to the test size, computing in ``dtype``."""
    c = copy.deepcopy(H.cell(name))
    m = c.config["model"]
    m["dtype"] = dtype
    kv = SMOKE_MODEL["n_kv_heads"] if m["n_kv_heads"] != m["n_heads"] \
        else SMOKE_MODEL["n_heads"]
    m.update(SMOKE_MODEL, n_kv_heads=kv)
    if m.get("sliding_window"):
        m["sliding_window"] = 48
    m["moe"].update(SMOKE_MOE)
    t = c.traffic
    t["tokens"].update(SMOKE_TOKENS)
    if "batch" in t:
        t.update(batch=4, seq=32)
    if "prompt" in t:
        t["prompt"].update(median=24, min_len=8, max_len=48)
    w = c.workload
    if w["mode"] == "train":
        w["window_batches"] = 2
    else:
        w.update(rate=200.0, warmup_seconds=0.05, drain_s=30.0,
                 check_requests=16,
                 profile={"batches": 1, "batch": 2, "seq": 16},
                 engine={"max_batch_tokens": 96, "max_batch_requests": 4})
    return c
