"""Dry-run sweep: every assigned arch x the four shapes x (16x16, 2x16x16),
the port's counterpart of the reference's ``src/repro/launch/sweep.py``.

Each cell runs ``launch.dryrun.run_cell`` in a process of its own, forked
from this one after it imported the port (a crashed cell must not kill
the sweep; the fork spares each cell the ~3 s of importing torch), at
most ``--jobs`` at a time, the training cells first (the longest); cells
the dry run would skip are written without one.  Results append to a
JSONL file, one line a cell; cells already there are not run again, so
the sweep is resumable.

    PYTHONPATH=src python -m repro_torch.launch.sweep \\
        --out results/dryrun_torch/cells.jsonl [--jobs 8]
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time
import traceback

from repro_torch.configs import ASSIGNED, SHAPES, get_config, skip_reason
from repro_torch.launch import dryrun

SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def all_cells():
    for cfg in ASSIGNED:
        for shape_name in SHAPE_NAMES:
            for multi_pod in (False, True):
                yield cfg.name, shape_name, multi_pod


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def cell_key(arch, shape, multi_pod):
    return f"{arch}|{shape}|{mesh_name(multi_pod)}"


def load_done(path):
    done = {}
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                done[cell_key(r["arch"], r["shape"],
                              r["mesh"] == "2x16x16")] = r["status"]
    return done


def static_skip(arch: str, shape: str, multi_pod: bool):
    """The skip reason known without running the cell, or None."""
    return skip_reason(get_config(arch), SHAPES[shape])


def append(out: str, row: dict) -> None:
    """One JSON line, in one write (cells finish in any order)."""
    fd = os.open(out, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
    try:
        os.write(fd, (json.dumps(row) + "\n").encode())
    finally:
        os.close(fd)


def _fork(arch, shape, mp, out) -> int:
    pid = os.fork()
    if pid:
        return pid
    code = 1
    try:
        res = dryrun.run_cell(arch, shape, mp, verbose=False)
        append(out, res)
        code = int(res["status"] == "error")
    except BaseException:
        append(out, {"arch": arch, "shape": shape, "mesh": mesh_name(mp),
                     "status": "error",
                     "error": traceback.format_exc()[-2000:]})
    finally:
        os._exit(code)


def run_cells(cells, out: str, jobs: int, timeout: float) -> int:
    """Run ``cells`` (arch, shape, multi_pod) in forked processes, ``jobs``
    at a time; print a line as each ends.  Returns the cells in error."""
    todo, running, failed = list(cells), {}, 0
    while todo or running:
        while todo and len(running) < max(1, jobs):
            cell = todo.pop(0)
            running[_fork(*cell, out)] = (cell, time.time())
        time.sleep(0.05)
        for pid, (cell, t0) in list(running.items()):
            arch, shape, mp = cell
            head = f"{arch} x {shape} {mesh_name(mp)}"
            done, status = os.waitpid(pid, os.WNOHANG)
            dt = time.time() - t0
            if not done and dt > timeout:
                os.kill(pid, signal.SIGKILL)
                os.waitpid(pid, 0)
                append(out, {"arch": arch, "shape": shape,
                             "mesh": mesh_name(mp), "status": "error",
                             "error": "timeout"})
                print(f"TIMEOUT {head}", flush=True)
                failed += 1
            elif done:
                code = os.waitstatus_to_exitcode(status)
                if code < 0:           # a signal: the child wrote nothing
                    append(out, {"arch": arch, "shape": shape,
                                 "mesh": mesh_name(mp), "status": "error",
                                 "error": f"signal {-code}"})
                failed += code != 0
                print(f"{'OK' if code == 0 else 'ERROR'} {head} "
                      f"({dt:.1f}s)", flush=True)
            else:
                continue
            del running[pid]
    return failed


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.sweep")
    ap.add_argument("--out", default="results/dryrun_torch/cells.jsonl")
    ap.add_argument("--timeout", type=int, default=1800)
    ap.add_argument("--only-arch", default=None)
    ap.add_argument("--retry-failed", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at a time")
    args = ap.parse_args(argv)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    done = load_done(args.out)
    cells = [c for c in all_cells() if args.only_arch in (None, c[0])]
    todo = [c for c in cells
            if cell_key(*c) not in done
            or (args.retry_failed and done[cell_key(*c)] == "error")]
    print(f"{len(cells)} cells, {len(cells) - len(todo)} done, "
          f"{len(todo)} to run", flush=True)

    runs = []
    for arch, shape, mp in todo:
        reason = static_skip(arch, shape, mp)
        if reason:
            append(args.out, {"arch": arch, "shape": shape,
                              "mesh": mesh_name(mp), "status": "skip",
                              "reason": reason})
            print(f"SKIP {arch} x {shape} {mesh_name(mp)}: {reason}",
                  flush=True)
        else:
            runs.append((arch, shape, mp))
    runs.sort(key=lambda c: c[1] != "train_4k")     # the longest first
    return 1 if run_cells(runs, args.out, args.jobs, args.timeout) else 0


if __name__ == "__main__":
    sys.exit(main())
