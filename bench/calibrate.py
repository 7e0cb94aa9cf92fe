"""The readings that the limits of ``correct`` are set from, at a cell's
own size, many seeds in one process (the benchmark's runs do not run
this):

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--seconds 6]

For each seed it prints one JSON line: the program's numbers against the
float32 reference (the lower reading), and on the control seeds the
controls' (the reference computing in the precision below the
configuration's bf16, fp8; for training int8 too) and the bf16
witness's (the reference computing in bf16: what that rounding alone
does), on the fault seeds those of ``faults.py``'s faults that the cell
can have.  In training each of them is judged by the float32 reference
routed by its own expert choices, as the benchmark's runs judge the
program, and the three leaves with the widest element-wise gradient
error are named.  A serving cell serves ``--seconds`` of its traffic at
its rate for each seed; the altered token is read off the same run (its
answer moved to the next id, as the fault plants it).
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from bench import faults as F  # noqa: E402
from bench import harness as H  # noqa: E402


def _free(device: str) -> None:
    import torch
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()


def _plain(readings: dict) -> dict:
    return {k: v for k, v in readings.items()
            if k not in ("first_grad", "routes")}


CONTROLS = {"int8": "control_int8", "fp8": "control_fp8",
            "bf16": "bf16_witness"}


def train_seed(cell, seed: int, control: bool, faults: bool,
               device: str, precs=("fp8", "bf16", "int8")) -> dict:
    from bench.drivers import train as D
    b1 = cell.workload["optimizer"]["betas"][0]

    def program():
        step, params, opt, batches, W = D.build(cell, seed, device)
        del W
        out = D.setup_readings(step, params, opt, batches, b1,
                               cell.model["n_layers"])[2]
        return out, batches

    def judged(got):
        want = D.reference_readings(cell, seed, batches, device,
                                    routes=got["routes"])
        err = D.grad_errors(got, want)
        out = dict(D.compare(got, want), route_flips=want["route_flips"],
                   worst_leaves=sorted(err, key=err.get)[-3:])
        return out, want
    prog, batches = program()
    _free(device)
    row = {}
    row["program"], want = judged(prog)
    row["readings"] = {"program": _plain(prog), "reference": _plain(want)}
    del want
    _free(device)
    if control:
        for prec in precs:
            got = D.reference_readings(cell, seed, batches, device, prec=prec)
            _free(device)
            row[CONTROLS[prec]] = judged(got)[0]
            del got
            _free(device)
    if faults:
        for kind in ("half_batch", "unchanged_state"):
            with F.planted(kind):
                got, _ = program()
            _free(device)
            row[kind] = judged(got)[0]
            del got
            _free(device)
    return row


def serve_seed(cell, seed: int, seconds: float, control: bool, faults: bool,
               device: str) -> dict:
    """The served-token gaps of the program, and on control seeds those of
    the reference at fp8 (the control) and at bf16 (the witness of what
    bf16 rounding alone does), each as a sorted list."""
    from bench.drivers import serve as D
    out = D.run(cell, seed, seconds, False, time.perf_counter(), device)
    wd = out["window"]
    row = {"program": sorted(out["readings"]["gaps"]),
           "setup_s": out["e2e"]["setup_s"],
           "ttft_p95_ms": out["e2e"]["ttft_p95_ms"],
           "steps": out["readings"]["steps"]}
    v = cell.model["vocab_size"]
    picks = {}
    if control:
        picks["control"] = ("fp8", wd["token"])
        picks["bf16_witness"] = ("bf16", wd["token"])
    if faults:
        picks["altered_token"] = ("fp32", {i: (t + 1) % v for i, t in
                                           wd["token"].items()})
    for name, (prec, token) in picks.items():
        row[name] = sorted(x for _, x in D.reference_gaps(
            cell, seed, wd["reqs"], token, wd["steps"], wd["chosen"], device,
            precs=(prec,))[prec])
        _free(device)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = H.cell(args.workload)
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    ctl, flt = set(ints(args.control_seeds)), set(ints(args.fault_seeds))
    print(f"calibrate: {args.workload} on {H.smi()}", flush=True)
    for seed in ints(args.seeds):
        t = time.perf_counter()
        if cell.workload["mode"] == "train":
            row = train_seed(cell, seed, seed in ctl, seed in flt,
                             args.device)
        else:
            row = serve_seed(cell, seed, args.seconds, seed in ctl,
                             seed in flt, args.device)
        row.update(seed=seed, seconds=time.perf_counter() - t)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
