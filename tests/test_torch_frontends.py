"""The two modality frontends of the port against the reference's on the
CPU: llava-next-34b's vision stub (patch embeddings through
``patch_proj``, prepended to the text) and hubert-xlarge's audio stub
(frames through ``frame_proj``, every ``MASK_EVERY``-th frame masked with
``mask_emb`` in training; an encoder with no decode), at their ``-smoke``
configs, in float32, the same weights through ``from_reference`` and the
same seeded numpy inputs.

Tolerances: embeddings within atol = rtol = 1e-5, losses within rtol 1e-5
and prefill logits within atol 1e-4 (float32; XLA and PyTorch sum in
other orders).  ``from_reference`` is exact.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.convert import from_reference, to_reference
from repro_torch.models import lm
from repro_torch.tree import tree_leaves, tree_map

TOL = dict(atol=1e-5, rtol=1e-5)
ARCHS = ("llava-next-34b-smoke", "hubert-xlarge-smoke")
B, S = 2, 26             # 26 frames: two masked (positions 12 and 25)


def models(name, mask_emb: bool = True):
    """(reference cfg, reference params, port cfg, port params); hubert's
    mask embedding drawn non-zero (its init is zeros) so that masking
    shows."""
    jcfg = jconfigs.get_config(name)
    jp = jax.tree.map(np.asarray, jlm.init_params(jcfg, jax.random.PRNGKey(3)))
    if mask_emb and jp.mask_emb is not None:
        rng = np.random.RandomState(11)
        jp = jp._replace(mask_emb=rng.randn(*jp.mask_emb.shape)
                         .astype(np.float32))
    return jcfg, jp, get_config(name), from_reference(jp, device="cpu")


def batch(cfg, seed=0):
    """Seeded numpy inputs of one training batch for ``cfg``."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.frontend == "audio_stub":
        return {"frames": rng.randn(B, S, lm.FRAME_DIM).astype(np.float32),
                "labels": labels}
    return {"tokens": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "patches": rng.randn(B, cfg.n_patches, cfg.d_model)
            .astype(np.float32), "labels": labels}


def to_torch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def serve_part(b):
    return {k: v for k, v in b.items() if k != "labels"}


@pytest.mark.parametrize("name", ARCHS)
def test_embed_inputs_matches_reference(name):
    jcfg, jp, cfg, p = models(name)
    b = batch(cfg)
    kw = serve_part(b)
    mask = None
    if cfg.frontend == "audio_stub":
        mask = np.random.RandomState(1).rand(B, S) < 0.3
        kw["mask"] = mask
    want = jlm.embed_inputs(jcfg, jlm.cast_for_compute(jcfg, jp), **kw)
    got = lm.embed_inputs(cfg, lm.cast_for_compute(cfg, p),
                          **{k: torch.as_tensor(v) for k, v in kw.items()})
    n_pre = cfg.n_patches if cfg.frontend == "vision_stub" else 0
    assert tuple(got.shape) == (B, n_pre + S, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_embed_inputs_promotes_as_jax_does():
    """fp32 frames against a bf16 ``frame_proj``: JAX multiplies in fp32
    and casts to the compute dtype; the port does the same (torch alone
    would refuse the mix)."""
    _, jp, cfg, p = models("hubert-xlarge-smoke")
    frames = np.random.RandomState(2).randn(B, S, lm.FRAME_DIM) \
        .astype(np.float32)
    jcfg16 = dataclasses.replace(
        jconfigs.get_config("hubert-xlarge-smoke"), dtype="bfloat16")
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    want = jlm.embed_inputs(jcfg16, jlm.cast_for_compute(jcfg16, jp),
                            frames=frames)
    got = lm.embed_inputs(cfg16, lm.cast_for_compute(cfg16, p),
                          frames=torch.as_tensor(frames))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(np.float32)),
                               atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("name", ARCHS)
def test_forward_train_loss_matches_reference(name):
    jcfg, jp, cfg, p = models(name)
    b = batch(cfg)
    want = jlm.forward_train(None, jcfg, jp, b)
    got = lm.forward_train(cfg, p, to_torch(b))
    np.testing.assert_allclose(float(got.loss), float(want.loss), rtol=1e-5)
    assert got.expert_choices is None          # dense backbones


@pytest.mark.parametrize("name", ARCHS)
def test_forward_prefill_logits_match_reference(name):
    jcfg, jp, cfg, p = models(name)
    b = serve_part(batch(cfg))
    want = jlm.forward_prefill(None, jcfg, jp, b).logits
    got = lm.forward_prefill(cfg, p, to_torch(b)).logits
    assert tuple(got.shape) == (B, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_hubert_masks_every_13th_frame():
    """The training mask is the reference's: positions with pos % 13 ==
    12, on every row; the loss is taken there only (labels elsewhere do
    not move it) and masking moves it (mask_emb non-zero)."""
    assert lm.MASK_EVERY == jlm.MASK_EVERY == 13
    mask = lm.frame_mask((B, 40), "cpu").numpy()
    assert mask.shape == (B, 40)
    assert [i for i in range(40) if mask[0, i]] == [12, 25, 38]
    assert (mask == mask[:1]).all()
    _, jp, cfg, p = models("hubert-xlarge-smoke")
    b = to_torch(batch(cfg))
    loss = float(lm.forward_train(cfg, p, b).loss)
    other = dict(b, labels=b["labels"].clone())
    keep = torch.as_tensor(lm.frame_mask((B, S), "cpu"))
    other["labels"][~keep] = (other["labels"][~keep] + 1) % cfg.vocab_size
    assert float(lm.forward_train(cfg, p, other).loss) == loss
    zero = p._replace(mask_emb=torch.zeros_like(p.mask_emb))
    assert float(lm.forward_train(cfg, zero, b).loss) != loss


def test_llava_patch_prefix_changes_the_logits():
    """The text's last-position logits depend on the patches before it
    (causal attention reaches back over the prefix), and the patch
    positions carry no loss: changing the prefix moves the logits."""
    _, _, cfg, p = models("llava-next-34b-smoke")
    b = to_torch(serve_part(batch(cfg)))
    base = lm.forward_prefill(cfg, p, b).logits
    other = dict(b, patches=b["patches"] + 1.0)
    moved = lm.forward_prefill(cfg, p, other).logits
    assert not torch.allclose(base, moved, atol=1e-4)
    empty = dict(b, patches=b["patches"][:, :0])
    text_only = lm.forward_prefill(cfg, p, empty).logits
    assert not torch.allclose(base, text_only, atol=1e-4)


def test_llava_decodes_text_tokens_after_an_empty_prefix():
    """llava's decode is token-only, as the reference's: one-token steps
    over a prompt reach the logits of a prefill with no patches."""
    _, _, cfg, p = models("llava-next-34b-smoke")
    toks = torch.as_tensor(batch(cfg)["tokens"][:, :8])
    want = lm.forward_prefill(
        cfg, p, {"tokens": toks,
                 "patches": torch.zeros((B, 0, cfg.d_model))}).logits
    cache = lm.init_cache(cfg, B, 8, dtype=torch.float32, device="cpu")
    for i in range(8):
        logits, cache, _ = lm.decode_step(cfg, p, cache, toks[:, i])
    np.testing.assert_allclose(logits.numpy(), want.numpy(), atol=1e-4,
                               rtol=1e-4)


def test_hubert_has_no_decode():
    _, _, cfg, p = models("hubert-xlarge-smoke")
    msg = "bidirectional encoder has no autoregressive decode step"
    with pytest.raises(NotImplementedError, match=msg):
        lm.init_cache(cfg, B, 8, device="cpu")
    llava = get_config("llava-next-34b-smoke")
    cache = lm.init_cache(llava, B, 8, device="cpu")
    with pytest.raises(NotImplementedError, match=msg):
        lm.decode_step(cfg, p, cache, torch.zeros(B, dtype=torch.long))


@pytest.mark.parametrize("name", list(jconfigs.REGISTRY))
def test_from_reference_takes_every_config(name):
    """All 14 registry configs convert (at their smoke sizes), leaf for
    leaf, the frontends' projections included, and back."""
    jcfg = jconfigs.get_config(name + "-smoke")
    jp = jax.tree.map(np.asarray, jlm.init_params(jcfg,
                                                  jax.random.PRNGKey(0)))
    p = from_reference(jp, device="cpu")
    lm._check_family(get_config(name + "-smoke"))
    back = to_reference(p, jp)
    want, got = jax.tree_util.tree_leaves(jp), jax.tree_util.tree_leaves(back)
    assert len(got) == len(want) == len(tree_leaves(p))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    for field in ("patch_proj", "frame_proj", "mask_emb"):
        assert (getattr(p, field) is None) == (getattr(jp, field) is None)


@pytest.mark.parametrize("name", ARCHS)
def test_port_autograd_gives_finite_gradients(name):
    """The port's own backward through either frontend: every parameter
    the loss reaches gets a finite gradient, the frontend's projection a
    non-zero one."""
    _, _, cfg, p = models(name)
    p = tree_map(lambda a: a.detach().clone().requires_grad_(True), p)
    loss = lm.forward_train(cfg, p, to_torch(batch(cfg))).loss
    loss.backward()
    grads = [t.grad for t in tree_leaves(p) if t.grad is not None]
    assert len(grads) >= len(tree_leaves(p)) - 1   # the unused embed (hubert)
    assert all(torch.isfinite(g).all() for g in grads)
    proj = p.patch_proj if cfg.frontend == "vision_stub" else p.frame_proj
    assert proj.grad is not None and float(proj.grad.abs().max()) > 0
    if cfg.frontend == "audio_stub":
        assert float(p.mask_emb.grad.abs().max()) > 0
