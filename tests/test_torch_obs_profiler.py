"""The port's ``obs.profiler`` and ``python -m repro_torch.obs validate`` on
the CPU: the ``torch.profiler`` session here (host activity only, no
device time) and the validator's exit codes on a port serve run's export:
0 as written, 2 once ``spans.json`` is corrupted.
"""
import json
import subprocess
import sys
from pathlib import Path

from repro_torch.obs import StepProfiler, trace_session
from repro_torch.obs.__main__ import main as validate_main

ROOT = Path(__file__).resolve().parents[1]


def test_trace_session_records_the_host_here(tmp_path):
    """Without a card the session records host activity only: active while
    open, no device time, a Chrome trace written under ``logdir``."""
    import torch
    with trace_session(str(tmp_path)) as s:
        assert s.active and not s.cuda
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert not s.active and s.kernel_times() == {}
    assert Path(s.path).exists()
    prof = StepProfiler(None, start=2, steps=2)
    for step in range(1, 6):
        prof.on_step(step)
        assert prof.active == (2 <= step < 4)
    prof.close()
    assert trace_session(None, enabled=False).__enter__().active is False


def serve_export(out):
    """The port's serve driver on the CPU, traced, exported under out."""
    from repro_torch.launch import serve
    assert serve.main(["--arch", "gpt2-moe-smoke", "--device", "cpu",
                       "--requests", "4", "--seq", "12",
                       "--max-new-tokens", "3", "--profile-batches", "1",
                       "--workload", "drift", "--autoscale",
                       "--autoscale-interval", "1", "--profile-steps", "2",
                       "--trace-dir", str(out)]) == 0


def test_validate_passes_a_port_export_and_fails_a_corrupted_one(tmp_path,
                                                                  capsys):
    serve_export(tmp_path)
    out = capsys.readouterr().out
    assert "autoscaler:" in out and "completed 4 requests" in out
    # the StepProfiler window ran (steps 2-3) and wrote its Chrome trace;
    # no card here, so no device time
    assert "engine steps 2-3: device time by kernel (us): no device " \
        "activity (no card)" in out
    assert (tmp_path / "profile_0.trace.json").exists()
    assert validate_main(["validate", "--trace-dir", str(tmp_path),
                          "--require-requests", "4"]) == 0
    assert "4 request TTFT decompositions" in capsys.readouterr().out
    # the module runs as ``python -m repro_torch.obs`` too
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", "validate",
         "--trace-dir", str(tmp_path)], capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        timeout=120)
    assert cli.returncode == 0, cli.stdout + cli.stderr
    # a request whose TTFT no longer equals its phases
    spans_path = tmp_path / "spans.json"
    doc = json.loads(spans_path.read_text())
    req = next(s for s in doc["spans"] if s["name"] == "request"
               and "ttft_s" in s.get("attrs", {}))
    req["attrs"]["ttft_s"] += 1.0
    spans_path.write_text(json.dumps(doc))
    assert validate_main(["validate", "--trace-dir", str(tmp_path)]) == 2
    assert "VIOLATION" in capsys.readouterr().out
    # an empty trace: no Chrome trace, no metrics, no requests
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "spans.json").write_text('{"spans": []}')
    assert validate_main(["validate", "--trace-dir", str(empty),
                          "--require-requests", "1"]) == 2
