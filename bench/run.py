"""Run one cell of the benchmark once and print its result as the last
line of standard output:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell's file (``bench/workloads/<cell>.json``) names its configuration,
traffic mix, mode and end-to-end metrics; the mode's driver
(``bench/drivers/<mode>.py``) runs it.  ``--trace 0`` reports the cell's
end-to-end metrics; ``--trace 1`` its per-layer metrics, each read by
``bench/metrics/<metric>.py`` from one checked profiler capture.  The
numbers compared to decide ``correct`` are printed beside their limits
as the last lines of standard error and, under ``checks``, as the last
key of the result.

It exits non-zero and prints no result when the card or the cards the
cell asks for are missing, when the program's package is absent, and
when ``jax``, ``jaxlib``, ``flax`` or ``repro`` is loaded once the window
has closed.  Kernel builds stay in the checkout
(``src/repro_torch/kernels/build/``, ``bench/.cache/``).
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg: str, code: int = 2):
    print(f"bench: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(code)


def metric_reader(name: str):
    path = ROOT / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(man: dict, cell: str, trace: bool) -> list:
    """The metrics of ``cell`` in BENCHMARK.json: end-to-end ones, or with
    ``trace`` the per-layer ones."""
    e2e = [m for m in man["end_to_end"]
           if cell in m.get("workloads", [w["name"] for w in
                                          man["workloads"]])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if cell in m.get("workloads", [])
            or ("workloads" not in m and m["moves"] in moved)]


def assemble(man: dict, cell, out: dict, trace: bool, kind: str,
             chips: int):
    """The result line's object from a driver's outcome (None for a traced
    run without a checked capture)."""
    metrics = {}
    device = {"platform": "gpu", "kind": kind, "count": chips,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    names = cell_metrics(man, cell.name, trace)
    breakdown = None
    if not trace:
        keys = cell.workload["end_to_end"]
        for m in names:
            metrics[m["name"]] = {"value": out["e2e"][keys[m["name"]]],
                                  "unit": m["unit"]}
    else:
        rec = out["rec"]
        if rec is None:
            return None
        rec = dict(rec, chips=chips, model=cell.model, traffic=cell.traffic)
        for m in names:
            v = metric_reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device.update(busy_s=rec["busy_s"], window_s=rec["window_s"])
        breakdown = {"device_ops": [[k, v] for k, v in rec["device_ops"]],
                     "idle_gaps": [[k, v] for k, v in rec["idle_gaps"]]}
    result = {"correct": out["checks"].ok, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = out["checks"].items
    return result


def main(argv=None) -> int:
    args = parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(ROOT / "bench" / ".cache" / "triton"))
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail("the program's package src/repro_torch is not in this checkout")
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from bench import harness as H
    man = H.manifest()
    entry = next((w for w in man["workloads"] if w["name"] == args.workload),
                 None)
    if entry is None:
        fail(f"no cell {args.workload!r} in BENCHMARK.json")
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    if torch.cuda.device_count() < entry["chips"]:
        fail(f"the cell asks for {entry['chips']} cards, "
             f"{torch.cuda.device_count()} present")
    cell = H.cell(args.workload)
    print(f"bench: {args.workload} seed {args.seed} on {H.smi()}",
          file=sys.stderr, flush=True)
    driver = importlib.import_module(f"bench.drivers.{cell.workload['mode']}")
    out = driver.run(cell, args.seed, args.seconds, bool(args.trace),
                     T_START)
    bad = H.forbidden_modules()
    if bad:
        fail(f"modules loaded that the benchmark may not load: {bad}", 3)
    result = assemble(man, cell, out, bool(args.trace),
                      torch.cuda.get_device_name(0), entry["chips"])
    if result is None:
        fail("no profiler session passed its checks: no device metric is "
             "reported", 4)
    checks = out["checks"]
    for line in checks.lines():
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
