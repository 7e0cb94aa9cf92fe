"""The port's expert-parallel training (``launch.steps`` with a mesh, the
``Trainer`` and ``launch.train --mesh``) on ``gpt2-moe-smoke`` at 2x2, on
spawned gloo ranks.

The reference's ``make_train_step`` and ``Trainer`` on a mesh do not run
under the installed JAX (its own ``test_train_step_schedules_match_\
baseline_on_dp_mesh`` fails), so these hold the port against itself and
against the single-rank step:

  * each schedule's params after 2 steps (2 microbatches) within 1e-5 of
    ``baseline``'s; bf16 and int8_ef within 5e-3 (the reference test's
    limits);
  * at capacity factor E (no token dropped) and aux weight 0, the 4-rank
    step's reduced gradients within 1e-5 of the single-rank step's on the
    whole batch, also with remat (the all-to-alls recomputed in the
    backward) and the ScMoE shortcut, and with ``fsdp``; every rank's
    global gradient norm within 1e-5 of the single-rank one: a wrong
    expert-parallel factor in the reduction fails it;
  * the ``Trainer`` at 2x2: a resume after an injected failure bitwise
    equal to an unbroken run, and a 2x2 checkpoint restored at 1x1 (its
    per-rank int8 residuals zeroed and logged);
  * the driver: ``--mesh 2x2 --device cpu`` spawns 4 ranks, trains and
    checkpoints, and its checkpoint resumes at ``--mesh 1x1``;
  * on a 1x1 mesh the steps are bitwise the single-rank steps.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from _torch_ranks import (_local_batch, full_params, grads_body,
                          grads_config, one_rank_body, restore_1x1_body,
                          resume_body, run_ranks, schedules_body)
from repro_torch.launch import train
from repro_torch.launch.steps import make_train_step
from repro_torch.optim.reduce import SCHEDULES
from repro_torch.tree import tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMBOS = [(s, None) for s in SCHEDULES] + \
    [("priority+partition", "bf16"), ("priority+partition+pipeline",
                                      "int8_ef")]


@pytest.fixture(scope="module")
def schedules(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_sched")
    return run_ranks(schedules_body, 4, tmp, COMBOS, 2, 2)


@pytest.mark.parametrize("combo", COMBOS[1:], ids=lambda c: f"{c[0]}-{c[1]}")
def test_schedule_matches_baseline_after_two_steps(schedules, combo):
    base = schedules[0][("baseline", None)]["params"]
    got = schedules[0][combo]["params"]
    tol = 1e-5 if combo[1] is None else 5e-3
    assert len(got) == len(base) > 10
    for g, b in zip(got, base):
        np.testing.assert_allclose(g, b, atol=tol, rtol=0)
    # every rank logs the same (global) loss, and it is finite
    losses = {tuple(r[combo]["losses"]) for r in schedules}
    assert len(losses) == 1 and np.isfinite(losses.pop()).all()


@pytest.mark.parametrize("remat,fsdp", [(False, False), (True, False),
                                        (False, True)],
                         ids=["plain", "remat-shortcut", "fsdp"])
def test_two_by_two_gradients_match_the_single_rank_step(tmp_path, remat,
                                                         fsdp):
    got = run_ranks(grads_body, 4, tmp_path, remat, fsdp)
    cfg = grads_config(remat)
    step = make_train_step(cfg, dispatch_backend="pallas")
    want, loss, _, _ = step.reduced_grads(full_params(cfg),
                                          _local_batch(cfg, 0, None))
    want = [w.numpy() for w in tree_leaves(want)]
    assert {round(r["loss"], 5) for r in got} == {round(float(loss), 5)}
    norm = np.sqrt(sum(np.sum(np.square(w, dtype=np.float64))
                       for w in want))
    for r in got:                       # every rank's global norm
        assert r["norm"] == pytest.approx(norm, rel=1e-5)
    assert len(got[0]["grads"]) == len(want) > 10
    for g, w in zip(got[0]["grads"], want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)


def test_trainer_resume_at_2x2_is_bitwise_and_restores_at_1x1(tmp_path):
    got = run_ranks(resume_body, 4, tmp_path, str(tmp_path))
    for r in got:
        assert r["straight"] == r["resumed"]
        assert len(r["want"]) == len(r["got"]) > 10
        for a, b in zip(r["want"], r["got"]):
            np.testing.assert_array_equal(a, b)
    assert got[0]["knobs"][0] == 2               # n_microops reached the cfg
    # the 2x2 checkpoint, restored on one rank, is the saved full tree
    one = run_ranks(restore_1x1_body, 1, tmp_path, str(tmp_path / "a"))[0]
    ck = tmp_path / "a" / "step_00000004"
    manifest = json.load(open(ck / "manifest.json"))
    n = 0
    for m in manifest:
        saved = np.load(ck / m["name"])
        if m["key"].startswith("reduce_state"):
            assert saved.shape[0] == 4           # one residual a rank
            continue
        np.testing.assert_array_equal(one["state"][m["key"]], saved)
        n += 1
    assert n > 20
    assert one["reset"] and one["reset"][0]["step"] == 4
    assert all(not v.any() for k, v in one["state"].items()
               if k.startswith("reduce_state"))


def test_train_driver_runs_a_2x2_mesh_and_resumes_at_1x1(tmp_path, capsys):
    argv = ["--arch", "gpt2-moe-smoke", "--device", "cpu", "--mesh", "2x2",
            "--schedule", "priority+partition+pipeline", "--microbatches",
            "2", "--grad-compression", "int8_ef", "--steps", "4", "--batch",
            "8", "--seq", "32", "--ckpt-dir", str(tmp_path / "ck"),
            "--ckpt-every", "2"]
    assert train.main(argv) == 0
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_00000002",
                                                   "step_00000004"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    one = [a if a != "2x2" else "1x1" for a in argv]
    one[one.index("--steps") + 1] = "6"
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        *one], env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "restored step 4" in p.stdout and "over 2 steps" in p.stdout
    assert "step_00000006" in os.listdir(tmp_path / "ck")


@pytest.mark.parametrize("flags", [
    ["--n-microops", "4"],
    ["--n-microops", "3", "--schedule", "priority+partition+pipeline",
     "--partition-bytes", "4096"]], ids=["implicit", "ppp"])
def test_one_rank_mesh_steps_are_the_single_rank_steps(tmp_path, flags):
    """At world size 1 the exchanges copy and the all-reduce adds nothing,
    and the expert section's backward runs on the whole buffer: 4 steps
    (2 microbatches) on a 1x1 gloo mesh are bitwise the single-rank
    steps, micro-ops and chunked reduction included."""
    (la, pa), (lb, pb) = run_ranks(one_rank_body, 1, tmp_path, flags)[0]
    assert la == lb
    for a, b in zip(pa, pb):
        np.testing.assert_array_equal(a, b)
