"""Megatron sequence parallelism (``cfg.seq_parallel`` on a
``launch.sharding.Layout``) on gloo ranks, against the same layout with
the flag off, the port with no mesh and the reference, at float32.

One spawn of 4 ranks (``_torch_ranks.sp_body``) runs the cases of
``test_torch_tp.py`` (qwen3-8b-smoke with 2 kv heads: GQA whose kv heads
split; granite-34b-smoke: MQA; qwen3-8b-smoke with 3 heads, which do not
split over 2 ranks; a sliding window of 4; mixtral-8x22b-smoke on (1, 2, 2)
with its experts sliced over `tp`), the gqa case under remat (the carry's
slices saved, the gathers and scatters recomputed) and without tensor
parallelism (``--dp-only``), llama4's shared expert, the ScMoE shortcut
(gpt2-moe's, and mixtral's with its `tp` sum deferred to a reduce-scatter
of the layer's output), and the two frontends (llava's patches, hubert's
frames) with the flag on and off: the loss,
every reduced gradient gathered whole and the global norm of a train step,
and the prefill logits.  The no-mesh side is held to the reference's
forward here, as ``test_torch_tp.py`` holds it.  The reference's
``make_prefill_step`` with ``seq_parallel=True`` runs on a CPU mesh of 8
forced host devices (``repro.launch.mesh.make_mesh``), so the prefill
logits are also held to it directly, in one subprocess; its train step
does not run under the installed JAX (ROADMAP), so the gradients are held
to its forward through the no-mesh port.  Losses within 1e-5, gradients, the norm
and the logits within 1e-4.

Also: the records of the stack's collectives over `model` (reduce-scatters
and all-gathers in place of all-reduces), a sequence of 15 tokens, which
does not tile the 2-rank group and so stays unsplit (records and values
bitwise SP-off's), the hybrid and RWKV stacks bitwise unchanged by the
flag (the reference's ignore it), and a mutation of the reduce-scatter's
backward (its all-gather dropped) that misses the gradients.

The dry run's two decode variants on the same ranks: ``kv_split`` on
(1, 2, 2) (its 2 kv heads over `model`, the 8 slots over `tp`; also with
a window of 4 whose ring wraps across the `tp` ranks) and
``cache_batch_only`` on (2, 2): six decode steps' logits against the
no-mesh step within 1e-4, each rank holding its block of the cache.
"""
import functools
import json
import os
import subprocess
import sys
import textwrap
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_threads import share_cores
from _torch_ranks import (DECODE_SLOTS, DECODE_VARIANTS, SP_BATCH, SP_CASES,
                          full_params, run_ranks, sp_batch, sp_body,
                          sp_config)
from repro.configs import get_config as j_get_config
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.convert import to_reference

share_cores()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-4, rtol=1e-4)
LOSS = dict(atol=1e-5, rtol=1e-5)
NAMES = [c[0] for c in SP_CASES]
B, S = SP_BATCH

REF = """
import json, sys, dataclasses
import numpy as np, jax, jax.numpy as jnp
sys.path.insert(0, sys.argv[3])
from _torch_ranks import SP_CASES, full_params, sp_batch, sp_config
from repro.configs import get_config
from repro.core import axes
from repro.launch import steps
from repro.launch.mesh import make_mesh, mesh_context
from repro.models import lm
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import to_reference
out = {}
for name, arch, shape, over in SP_CASES:
    cfg = sp_config(t_get_config, arch, over)
    jcfg = dataclasses.replace(sp_config(get_config, arch, over),
                               seq_parallel=True)
    like = jax.eval_shape(lambda k: lm.init_params(jcfg, k),
                          jax.random.PRNGKey(0))
    jp = jax.tree.map(jnp.asarray, to_reference(full_params(cfg), like))
    names = (axes.DATA, axes.MODEL, axes.TP)[:len(shape)]
    mesh = make_mesh(shape, names)
    batch = {k: jnp.asarray(v.numpy()) for k, v in sp_batch(
        cfg, int(sys.argv[1]), int(sys.argv[2])).items() if k != "labels"}
    with mesh_context(mesh):
        step = jax.jit(steps.make_prefill_step(
            jcfg, mesh, serve_plan=steps.make_serve_plan(jcfg, mesh)))
        out[name] = np.asarray(step(jp, batch)).tolist()
json.dump(out, sys.stdout)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(every rank's ``sp_body`` results, {case: the reference's SP
    prefill logits on its CPU mesh}); the reference's subprocess runs
    beside the ranks."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"))
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REF), str(B), str(S),
         os.path.join(ROOT, "tests")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        got = run_ranks(sp_body, 4, tmp_path_factory.mktemp("sp"))
        out, err = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, err[-3000:]
    return got, {k: np.asarray(v, np.float32)
                 for k, v in json.loads(out).items()}


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


@pytest.fixture(scope="module")
def ref_prefill(runs):
    return runs[1]


@functools.lru_cache(maxsize=None)
def reference(name):
    """(reference config, the port's, the reference's params: the port's
    seed-0 params, the case's batch as the reference's arrays)."""
    _, arch, shape, over = next(c for c in SP_CASES if c[0] == name)
    jcfg, cfg = (sp_config(g, arch, over) for g in (j_get_config,
                                                    get_config))
    like = jax.eval_shape(lambda k: jlm.init_params(jcfg, k),
                          jax.random.PRNGKey(0))
    jp = to_reference(full_params(cfg), like)
    batch = {k: jnp.asarray(v.numpy()) for k, v in sp_batch(cfg, B,
                                                           S).items()}
    return jcfg, cfg, jax.tree.map(jnp.asarray, jp), batch


def _counts(records, axis):
    return Counter(r[0] for r in records if r[1] == axis)


@pytest.mark.parametrize("name", NAMES)
def test_train_step_matches_sp_off_and_no_mesh(ranks, name):
    out = [r[name] for r in ranks]
    jcfg, cfg, jp, batch = reference(name)
    want = jlm.forward_train(None, jcfg, jp, batch, lina=False)
    r0 = out[0]
    np.testing.assert_allclose(r0["want_loss"], float(want.loss), **LOSS)
    for r in out:
        np.testing.assert_allclose(r["on"]["loss"], r0["want_loss"], **LOSS)
        np.testing.assert_allclose(r["on"]["loss"], r["off"]["loss"],
                                   **LOSS)
        np.testing.assert_allclose(r["on"]["norm"], r["off"]["norm"], **TOL)
    on, off = r0["on"]["grads"], r0["off"]["grads"]
    assert len(on) == len(off) == len(r0["want"])
    for i, (g, h, w) in enumerate(zip(on, off, r0["want"])):
        assert g.shape == w.shape, i
        np.testing.assert_allclose(g, w, err_msg=f"leaf {i}", **TOL)
        np.testing.assert_allclose(g, h, err_msg=f"leaf {i}", **TOL)
    norm = float(np.sqrt(sum(float(np.sum(np.square(w.astype(np.float64))))
                             for w in r0["want"])))
    np.testing.assert_allclose(r0["on"]["norm"], norm, **TOL)


@pytest.mark.parametrize("name", NAMES)
def test_prefill_matches_sp_off_and_the_references_sp_prefill(
        ranks, ref_prefill, name):
    out = [r[name] for r in ranks]
    jcfg, cfg, jp, batch = reference(name)
    batch = {k: v for k, v in batch.items() if k != "labels"}
    want = np.asarray(jlm.forward_prefill(None, jcfg, jp, batch).logits)
    ref_sp = ref_prefill[name]
    np.testing.assert_allclose(ref_sp, want, **TOL)
    for r in out:
        rows = r["on"]["rows"]
        np.testing.assert_allclose(r["on"]["prefill"], ref_sp[rows], **TOL)
        np.testing.assert_allclose(r["on"]["prefill"], r["off"]["prefill"],
                                   **TOL)


def test_the_stacks_all_reduces_become_reduce_scatters_and_gathers(ranks):
    """gqa on (2, 2): every sublayer's weights split over `model`.  The
    prefill's all-reduces over `model` (attention, FFN, the embedding)
    are each a reduce-scatter under SP, and as many all-gathers are added
    (before attention and the FFN, and of the last rows); in the train
    step the all-reduces that go are the reduce-scatters that come, and
    every reduce-scatter over `model` has its all-gather."""
    r0 = ranks[0]["gqa"]
    on, off = (_counts(r0[k]["prefill_records"], "model")
               for k in ("on", "off"))
    assert off["all-reduce"] > 0 and on["all-reduce"] == 0
    assert on["reduce-scatter"] == off["all-reduce"]
    assert on["all-gather"] == off["all-gather"] + off["all-reduce"]
    on, off = (_counts(r0[k]["train_records"], "model")
               for k in ("on", "off"))
    assert off["reduce-scatter"] == 0 and on["reduce-scatter"] > 0
    assert off["all-reduce"] - on["all-reduce"] == on["reduce-scatter"]
    assert on["all-gather"] - off["all-gather"] == on["reduce-scatter"]
    # expert slicing: the `tp` ranks' slices gathered into the `model`
    # token shard, the stack's collectives over (`model`, `tp`)
    mix = ranks[0]["mixtral"]
    on, off = (_counts(mix[k]["prefill_records"], "model+tp")
               for k in ("on", "off"))
    assert on["all-reduce"] == 0
    assert on["reduce-scatter"] == off["all-reduce"] > 0
    tp_on, tp_off = (_counts(mix[k]["train_records"], "tp")
                     for k in ("on", "off"))
    assert tp_on["all-gather"] > 0 and tp_off["all-reduce"] > 0
    # the layer's `tp` sum a reduce-scatter of y, not an all-reduce of the
    # FFN's output rows (and, in the backward, of their gradient)
    assert tp_on["all-reduce"] == 0 and tp_on["reduce-scatter"] > 0


def test_a_sequence_that_does_not_tile_the_group_stays_unsplit(ranks):
    for r in ranks:
        on, off = r["untiled"][True], r["untiled"][False]
        assert on["train_records"] == off["train_records"]
        assert on["prefill_records"] == off["prefill_records"]
        assert on["loss"] == off["loss"] and on["norm"] == off["norm"]
        for g, h in zip(on["grads"], off["grads"]):
            np.testing.assert_array_equal(g, h)
        np.testing.assert_array_equal(on["prefill"], off["prefill"])


@pytest.mark.parametrize("arch", ["zamba2-1.2b-smoke", "rwkv6-1.6b-smoke"])
def test_the_hybrid_and_rwkv_stacks_ignore_the_flag(ranks, arch):
    for r in ranks:
        on, off = r[arch][True], r[arch][False]
        assert on["train_records"] == off["train_records"]
        assert on["loss"] == off["loss"] and on["norm"] == off["norm"]
        for g, h in zip(on["grads"], off["grads"]):
            np.testing.assert_array_equal(g, h)
        np.testing.assert_array_equal(on["prefill"], off["prefill"])


def test_dropping_the_reduce_scatters_backward_gather_misses(ranks):
    """The gqa case with the reduce-scatter's backward replaced by the
    local adjoint of a slice (this rank's block, zeros elsewhere): the
    forward is unchanged, and the gradients miss the no-mesh ones."""
    r0 = ranks[0]
    mut, good = r0["mutant"], r0["gqa"]
    np.testing.assert_allclose(mut["loss"], good["on"]["loss"], **LOSS)
    gaps = [float(np.abs(g - w).max())
            for g, w in zip(mut["grads"], good["want"])]
    assert max(gaps) > 1e-2, gaps


@pytest.mark.parametrize("name,shape,split,over", DECODE_VARIANTS,
                         ids=[v[0] for v in DECODE_VARIANTS])
def test_the_dry_runs_decode_variants_match_no_mesh(ranks, name, shape,
                                                    split, over):
    want = ranks[0][name]["want"]
    window = over.get("sliding_window", 0)
    slots = min(DECODE_SLOTS, window or DECODE_SLOTS)
    for r in ranks:
        got = r[name]
        for t, (g, w) in enumerate(zip(got["logits"], want)):
            np.testing.assert_allclose(g, w[got["rows"]], err_msg=f"step {t}",
                                       **TOL)
        b, s, kv = got["cache_shape"][2:5]
        assert b == len(got["rows"])
        if split == "kv":       # slots over `tp`, kv heads over `model`
            assert (s, kv) == (slots // shape[2], over["n_kv_heads"] //
                               shape[1])
        else:                   # rows alone split
            assert (s, kv) == (slots, over["n_kv_heads"])
