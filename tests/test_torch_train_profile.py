"""``launch.train --profile-dir`` (the port's counterpart of the
reference's ``--jax-profile-dir``) on the CPU: a short run writes a
``torch.profiler`` Chrome trace of steps 2..5 and prints where it is; a
capture that fails is printed, not swallowed, and training goes on."""
import json

from repro_torch.launch import train
from repro_torch.obs import profiler as prof_mod

ARGS = ["--arch", "gpt2-moe-smoke", "--steps", "6", "--batch", "2",
        "--seq", "16", "--device", "cpu"]


def test_a_short_run_writes_a_trace(tmp_path, capsys):
    out = tmp_path / "prof"
    assert train.main(ARGS + ["--ckpt-dir", str(tmp_path / "ck"),
                              "--profile-dir", str(out)]) == 0
    traces = sorted(out.glob("*.trace.json"))
    assert [t.name for t in traces] == ["profile_0.trace.json"]
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    said = capsys.readouterr().out
    assert f"profile: {traces[0]}" in said and "no device activity" in said


def test_a_failed_capture_is_printed_and_training_goes_on(
        tmp_path, capsys, monkeypatch):
    def fail(self):
        raise RuntimeError("the profiler did not start")
    monkeypatch.setattr(prof_mod.trace_session, "__enter__", fail)
    assert train.main(ARGS + ["--ckpt-dir", str(tmp_path / "ck"),
                              "--profile-dir", str(tmp_path / "p")]) == 0
    said = capsys.readouterr().out
    assert "profiler: the capture failed at step 2" in said
    assert "the profiler did not start" in said
    assert "loss" in said and not (tmp_path / "p").exists()
