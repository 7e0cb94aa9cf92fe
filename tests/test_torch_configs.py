"""The port's architecture registry against the reference's: every config of
the reference's ``REGISTRY`` (the ten assigned architectures and the
paper's four models) equal field by field, ``MoEConfig`` and ``SSMConfig``
included, at full size and as its ``-smoke`` variant; ``ASSIGNED``,
``PAPER`` and ``list_archs()`` in the reference's order; and the model
entry points' refusal of the two modality frontends the port does not
have, by the ROADMAP item that will port them.
"""
import dataclasses

import pytest
import torch

from repro import configs as jconfigs
from repro_torch import configs
from repro_torch.models import lm

NAMES = list(jconfigs.REGISTRY)


def test_registry_holds_every_reference_config():
    assert len(NAMES) == 14
    assert list(configs.REGISTRY) == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_config_matches_reference(name):
    want, got = jconfigs.get_config(name), configs.get_config(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()
    assert [s.name for s in configs.applicable_shapes(got)] == \
        [s.name for s in jconfigs.applicable_shapes(want)]


@pytest.mark.parametrize("name", NAMES)
def test_smoke_config_matches_reference(name):
    want = jconfigs.get_config(name + "-smoke")
    got = configs.get_config(name + "-smoke")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()


def test_lists_match_reference():
    assert [c.name for c in configs.ASSIGNED] == \
        [c.name for c in jconfigs.ASSIGNED]
    assert [c.name for c in configs.PAPER] == \
        [c.name for c in jconfigs.PAPER]
    assert configs.list_archs() == jconfigs.list_archs()
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("no-such-arch")


@pytest.mark.parametrize("name", ["llava-next-34b", "hubert-xlarge"])
def test_modality_frontends_are_refused_by_their_roadmap_item(name):
    cfg = configs.get_config(name + "-smoke")
    assert cfg.frontend in ("vision_stub", "audio_stub")
    msg = f"{cfg.frontend} frontend is not ported .*the modality frontends"
    with pytest.raises(NotImplementedError, match=msg):
        lm.init_params(cfg, torch.Generator(), device="cpu")
    with pytest.raises(NotImplementedError, match=msg):
        lm.init_cache(cfg, 1, 8, device="cpu")


def test_serve_driver_refuses_dense_archs():
    """The serve driver targets MoE archs, as the reference's does; the
    dense configs are served through ``models.lm``'s entry points."""
    from repro_torch.launch import serve
    with pytest.raises(ValueError, match="targets MoE archs"):
        serve.run(["--arch", "qwen3-8b-smoke", "--device", "cpu"])
