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


def test_the_capture_holds_the_ranges_and_prints_the_counts(tmp_path,
                                                            capsys):
    """The captured steps run inside a counting block: the MoE layers'
    routed (token, choice) pairs are T x k a layer a step; the Chrome
    trace holds the program's ranges (the trainer's spans too, where
    ``--trace-dir`` records them)."""
    out = tmp_path / "prof"
    assert train.main(ARGS + ["--ckpt-dir", str(tmp_path / "ck"),
                              "--profile-dir", str(out),
                              "--trace-dir", str(tmp_path / "tr")]) == 0
    said = capsys.readouterr().out
    routed = 3 * 2 * 16 * 2 * 4          # steps x T x k x layers
    line = next(ln for ln in said.splitlines()
                if ln.startswith("profile: counts of the captured steps"))
    assert f"moe.routed_pairs {routed}," in line and "dropped" in line
    kept = int(line.split("moe.kept_pairs ")[1].split(";")[0])
    assert 0 < kept <= routed
    trace = json.loads((out / "profile_0.trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"train.step", "fwd_bwd", "lm.embed", "lm.stack", "lm.attention",
            "lm.moe", "lm.loss", "optim.update"} <= names
