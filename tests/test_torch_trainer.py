"""The port's ``Trainer`` and ``launch.train`` on the CPU at smoke size
(``gpt2-moe-smoke``, batch 4 x seq 32, the kernel route's plain versions):
bitwise resume after an injected failure, the non-finite guard's skip and
rollback, CRC-checked checkpoints with fallback, the packing decision, the
straggler log, the spans and counters, and the CLI.

Resume is checked bitwise (the CPU's arithmetic is deterministic); the
packing model against the reference's on the same hardware numbers
exactly.
"""
import json
import os
import time

import numpy as np
import pytest
import torch

from repro.configs import V5E as J_V5E
from repro.core.packing import choose_packing as j_choose_packing
from repro_torch.checkpoint import (CheckpointManager, CorruptCheckpointError,
                                    load_pytree)
from repro_torch.configs import V5E, get_config
from repro_torch.core.packing import choose_packing
from repro_torch.data import DataConfig
from repro_torch.launch import train
from repro_torch.obs import ObsContext
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.tree import tree_leaves
from _torch_threads import share_cores

share_cores()


def make_trainer(ckpt_dir, obs=None, **kw):
    cfg = get_config("gpt2-moe-smoke")
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    steps = kw.pop("steps", 4)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=steps)
    tcfg = TrainerConfig(steps=steps, ckpt_dir=str(ckpt_dir), device="cpu",
                         **kw)
    return Trainer(cfg, dcfg, ocfg, tcfg, obs=obs)


def assert_bitwise(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb) > 10
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def test_resume_after_failure_is_bitwise(tmp_path):
    straight = make_trainer(tmp_path / "a", ckpt_every=2)
    want = straight.run()
    failing = make_trainer(tmp_path / "b", ckpt_every=2, fail_at_step=3)
    with pytest.raises(RuntimeError, match="injected failure at step 3"):
        failing.run()
    assert failing.ckpt.latest_step() == 2
    resumed = make_trainer(tmp_path / "b", ckpt_every=2)
    got = resumed.run()
    assert [r["step"] for r in resumed.metrics_log] == [2, 3]
    assert [r["loss"] for r in resumed.metrics_log] == \
        [r["loss"] for r in straight.metrics_log[2:]]
    assert_bitwise(got, want)
    assert [c["step"] for c in resumed.checkpoint_log] == [4]
    assert resumed.checkpoint_log[0]["bytes"] > 0


def test_nan_steps_are_skipped_then_rolled_back(tmp_path):
    tr = make_trainer(tmp_path, steps=7, ckpt_every=2,
                      nan_at_steps=(3, 4, 5), max_bad_steps=3)
    state = tr.run()
    assert tr.skipped_steps == [3, 4, 5]
    assert tr.rollbacks == 1
    skipped = [r for r in tr.metrics_log if r.get("skipped")]
    assert [r["step"] for r in skipped] == [3, 4, 5]
    assert all(np.isnan(r["loss"]) for r in skipped)
    assert tr.obs.metrics.counter("trainer_skipped_steps_total").value == 3
    assert tr.obs.metrics.counter("trainer_rollbacks_total").value == 1
    assert all(torch.isfinite(x).all() for x in tree_leaves(state["params"]))
    # the one step after the rollback ran on the step-2 checkpoint (the
    # state after steps 0 and 1) with step 6's batch
    ref = make_trainer(tmp_path / "ref", steps=7)
    st = ref.init_state()
    for s in (0, 1, 6):
        p, o, _ = ref.step_fn(st["params"], st["opt_state"], ref._batch(s))
        st = {"params": p, "opt_state": o}
    assert_bitwise(state, st)


def test_single_nan_step_keeps_the_pre_step_state(tmp_path):
    a = make_trainer(tmp_path / "a", steps=3, nan_at_steps=(1,))
    sa = a.run()
    assert a.skipped_steps == [1] and a.rollbacks == 0
    # skipping step 1 keeps the state step 0 produced: the same as a run
    # whose step 1 hands its inputs back unchanged
    b = make_trainer(tmp_path / "b", steps=3)
    b.step_fn = _once_skipped(b.step_fn, skip=1)
    sb = b.run()
    assert_bitwise(sa["params"], sb["params"])


def _once_skipped(step_fn, skip):
    """A step function that returns its inputs unchanged on call ``skip``
    (0-based), as the guard leaves them."""
    calls = {"n": 0}

    def fn(params, opt_state, batch):
        i = calls["n"]
        calls["n"] += 1
        out = step_fn(params, opt_state, batch)
        if i == skip:
            return params, opt_state, out[2]
        return out
    return fn


def test_fail_at_step_raises(tmp_path):
    with pytest.raises(RuntimeError, match="injected failure at step 0"):
        make_trainer(tmp_path, fail_at_step=0).run()


def test_corrupt_checkpoint_is_caught_and_skipped(tmp_path):
    tree = {"w": torch.randn(4, 3), "h": torch.randn(5).bfloat16(),
            "step": torch.tensor(7, dtype=torch.int32)}
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        mgr.save(s, {k: v + s if k != "step" else v for k, v in tree.items()})
    assert mgr.steps() == [2, 3]                     # keep-k
    back = load_pytree(os.path.join(str(tmp_path), "step_00000003"), tree)
    assert back["h"].dtype == torch.bfloat16
    assert torch.equal(back["h"], tree["h"] + 3)
    assert torch.equal(back["step"], tree["step"])
    # flip one byte of an array's data in the newest checkpoint
    d = os.path.join(str(tmp_path), "step_00000003")
    manifest = json.load(open(os.path.join(d, "manifest.json")))
    name = [m["name"] for m in manifest if m["key"] == "w"][0]
    raw = bytearray(open(os.path.join(d, name), "rb").read())
    raw[-1] ^= 0xFF
    open(os.path.join(d, name), "wb").write(bytes(raw))
    with pytest.raises(CorruptCheckpointError, match="checksum"):
        mgr.restore(3, tree)
    step, got = mgr.restore_latest(tree)
    assert step == 2 and mgr.corrupt_steps == [3]
    assert torch.equal(got["w"], tree["w"] + 2)
    # an unreadable checkpoint is corrupt too
    os.remove(os.path.join(str(tmp_path), "step_00000002", name))
    assert mgr.restore_latest(tree) == (None, None)


def test_packing_decision_is_made_and_matches_reference(tmp_path):
    tr = make_trainer(tmp_path, steps=3, pack_warmup=1)
    tr.run()
    mc, dc = tr.model_cfg, tr.data_cfg
    tokens = dc.global_batch * dc.seq_len // mc.moe.n_microops
    assert tr.packing_decision == choose_packing(
        tokens, mc.d_model, mc.moe.d_ff, mc.moe.n_experts, 1, ffn_mult=2)
    assert tr.packing_decision.experts_per_device >= 1
    # the analytic model is the reference's: same numbers on the same card
    for args in ((1024, 768, 3072, 16, 16, 2), (64, 64, 64, 4, 4, 3)):
        got = choose_packing(*args[:5], ffn_mult=args[5], hw=V5E)
        want = j_choose_packing(*args[:5], ffn_mult=args[5], hw=J_V5E)
        assert got.experts_per_device == want.experts_per_device
        np.testing.assert_allclose(
            [got.ffn_us, got.a2a_us, got.pipeline_efficiency],
            [want.ffn_us, want.a2a_us, want.pipeline_efficiency], rtol=1e-12)


def test_straggler_log_records_a_slow_step(tmp_path):
    tr = make_trainer(tmp_path, steps=8, ckpt_every=100)
    real = tr.step_fn

    def slow_at_6(params, opt_state, batch):
        out = real(params, opt_state, batch)
        if tr.metrics_log and tr.metrics_log[-1]["step"] == 5:
            time.sleep(max(20 * tr.metrics_log[-1]["dt"], 0.5))
        return out
    tr.step_fn = slow_at_6
    tr.run()
    assert 6 in [e["step"] for e in tr.straggler_events]
    for ev in tr.straggler_events:
        assert set(ev) == {"step", "dt", "median"}
        assert ev["dt"] > tr.cfg.straggler_factor * ev["median"]
    assert tr.obs.metrics.counter("trainer_straggler_events_total").value \
        == len(tr.straggler_events)


def test_spans_and_counters(tmp_path):
    obs = ObsContext.enabled()
    tr = make_trainer(tmp_path, obs=obs, steps=3, ckpt_every=100)
    tr.run()
    roots = obs.tracer.roots
    assert [r.name for r in roots] == ["train.step"] * 3
    assert [c.name for c in roots[0].children] == ["data.batch", "fwd_bwd"]
    assert [c.name for c in roots[-1].children] == \
        ["data.batch", "fwd_bwd", "checkpoint"]
    fb = roots[1].find("fwd_bwd")[0]
    assert fb.end - fb.start == pytest.approx(tr.metrics_log[1]["dt"])
    assert obs.metrics.counter("trainer_steps_total").value == 3


def test_train_driver_runs_on_the_cpu_when_asked(tmp_path, capsys):
    assert train.main(["--arch", "gpt2-moe-smoke", "--steps", "12",
                       "--batch", "4", "--seq", "32", "--device", "cpu",
                       "--ckpt-dir", str(tmp_path / "ck"),
                       "--metrics-out", str(tmp_path / "m.json")]) == 0
    out = capsys.readouterr().out
    assert "expert packing" in out and "over 12 steps" in out
    assert len(json.load(open(tmp_path / "m.json"))) == 12


# each expert-parallel flag of the driver, and where it lands
FLAG_CASES = {
    "schedule": (["--schedule", "priority"],
                 lambda t, tr: t.schedule == "priority"
                 and tr.obs.tracer.roots[0].attrs["schedule"] == "priority"),
    "grad_compression": (["--schedule", "priority+partition",
                          "--grad-compression", "int8_ef"],
                         lambda t, tr: t.grad_compression == "int8_ef"
                         and tr.stateful_reduce),
    "n_microops": (["--n-microops", "2"],
                   lambda t, tr: tr.model_cfg.moe.n_microops == 2),
    "pipeline_ffn": (["--no-pipeline-ffn"],
                     lambda t, tr: t.pipeline_ffn is False
                     and tr.model_cfg.moe.pipeline_ffn is False),
    "shortcut": (["--shortcut"],
                 lambda t, tr: tr.model_cfg.moe.shortcut is True),
    "lina": (["--no-lina"], lambda t, tr: t.lina is False),
}


@pytest.mark.parametrize("name", list(FLAG_CASES))
def test_train_driver_flag_reaches_the_trainer(name, tmp_path):
    flags, check = FLAG_CASES[name]
    args = train.parse_args(["--arch", "gpt2-moe-smoke", "--device", "cpu",
                             "--steps", "1", "--batch", "4", "--seq", "16",
                             "--ckpt-dir", str(tmp_path), *flags])
    cfg, dcfg, ocfg, tcfg = train.configs(args)
    tr = Trainer(cfg, dcfg, ocfg, tcfg, obs=ObsContext.enabled())
    state = tr.run()
    assert len(tr.metrics_log) == 1 and np.isfinite(tr.metrics_log[0]["loss"])
    assert check(tcfg, tr), name
    assert ("reduce_state" in state) == tr.stateful_reduce


def test_train_driver_spawns_a_rank_for_each_mesh_cell(monkeypatch):
    calls = []
    monkeypatch.setattr(train.mesh_mod, "spawn", lambda *a: calls.append(a))
    argv = ["--arch", "gpt2-moe-smoke", "--device", "cpu", "--mesh", "2x2"]
    assert train.main(argv) == 0
    assert calls == [(train.main, argv, 4, "cpu")]


def test_serve_micro_op_flags_reach_the_config_not_the_profile(
        capsys):
    """``--n-microops`` and ``--pipeline-ffn`` / ``--no-pipeline-ffn`` set
    ``cfg.moe`` and print in the knob line; the profiling forward runs
    with ``lina=False`` (as the reference's), so its profile does not
    move."""
    from repro_torch.launch import serve
    argv = ["--arch", "gpt2-moe-smoke", "--device", "cpu", "--requests",
            "2", "--seq", "8", "--max-new-tokens", "1", "--profile-batches",
            "2"]
    base = serve.run(argv)["engine"].server
    for flags, n, pipe in ((["--n-microops", "2", "--pipeline-ffn"], 2,
                            True),
                           (["--n-microops", "3", "--no-pipeline-ffn"], 3,
                            False)):
        capsys.readouterr()
        srv = serve.run(argv + flags)["engine"].server
        assert (srv.cfg.moe.n_microops, srv.cfg.moe.pipeline_ffn) == (n, pipe)
        assert f"moe knobs: n_microops={n} pipeline_ffn={pipe} " in \
            capsys.readouterr().out
        np.testing.assert_array_equal(srv.profile.counts,
                                      base.profile.counts)
