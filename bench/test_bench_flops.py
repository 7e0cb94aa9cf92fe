"""The frozen FLOP count equals ``launch/analytic.py``'s at the cells'
shapes (and at every registry config's train and prefill shapes)."""
import dataclasses

import pytest

from bench import harness as H
from bench.yardstick import flops as FL


def _model(cfg) -> dict:
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
         if f.name not in ("moe", "ssm")}
    d["moe"] = dataclasses.asdict(cfg.moe)
    d["ssm"] = dataclasses.asdict(cfg.ssm)
    return d


def _analytic(cfg, kind, b, s):
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.analytic import analytic_cost
    return analytic_cost(cfg, ShapeConfig("x", s, b, kind)).flops_global


CASES = [("gpt2-moe", "train", 16, 1024), ("mixtral-8x22b", "prefill", 1, 256),
         ("mixtral-8x22b", "prefill", 1, 1536),
         ("mixtral-8x22b", "prefill", 1, 4096)]


@pytest.mark.parametrize("name,kind,b,s", CASES)
def test_cells_match_analytic(name, kind, b, s):
    f = H.load("configs", name)
    cfg = H.port_config(f["model"], f["port_config"])
    assert FL.step_flops(f["model"], kind, b, s) == _analytic(cfg, kind, b, s)


def _registry():
    from repro_torch.configs import REGISTRY
    return sorted(REGISTRY)


@pytest.mark.parametrize("arch", _registry())
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_registry_matches_analytic(arch, kind):
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    assert FL.step_flops(_model(cfg), kind, 2, 4096) == \
        _analytic(cfg, kind, 2, 4096)
