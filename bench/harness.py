"""What every driver shares: the cell's files, the port's configuration
built from a configuration file, the weights in the program's tree and
the numbers compared to decide ``correct``."""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
SRC = ROOT / "src"
# what may not be loaded in the process that prints a result: compared by
# the whole top-level name, since the port's name begins with the last
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load(kind: str, name: str) -> dict:
    with open(BENCH / kind / f"{name}.json") as f:
        return json.load(f)


def manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict

    @property
    def model(self) -> dict:
        return self.config["model"]


def cell(name: str) -> Cell:
    w = load("workloads", name)
    return Cell(name, w, load("configs", w["config"]),
                load("traffic", w["traffic"]))


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def port_config(model: dict, port_name: str):
    """The port's ``ModelConfig`` named ``port_name`` with every field of
    ``model`` set as the file states it (``moe`` field by field); raises
    on a field the port lacks."""
    from repro_torch.configs import get_config
    cfg = get_config(port_name)
    top = {k: v for k, v in model.items() if k != "moe"}
    for k in top:
        if not hasattr(cfg, k):
            raise KeyError(f"the port's config has no field {k!r}")
    moe = model.get("moe")
    if moe is not None:
        for k in moe:
            if not hasattr(cfg.moe, k):
                raise KeyError(f"the port's MoE config has no field {k!r}")
        top["moe"] = dataclasses.replace(cfg.moe, **moe)
    return dataclasses.replace(cfg, **top)


def named_leaves(tree, prefix: str = ""):
    """(path, tensor) of a NamedTuple tree's leaves, None leaves skipped."""
    import torch
    if tree is None:
        return
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
        return
    for f in tree._fields:
        yield from named_leaves(getattr(tree, f),
                                f"{prefix}.{f}" if prefix else f)


def bench_name(path: str) -> str:
    """A program leaf path -> the benchmark's weight name."""
    return path[len("stack."):] if path.startswith("stack.") else path


def program_params(cfg, W: dict):
    """The program's ``LMParams`` holding the benchmark's weights ``W``
    (the same tensors): the tree of the port's ``init_params`` on
    ``meta``, every leaf taken from ``W`` by name and shape."""
    from repro_torch.models import lm as lm_mod
    tree = lm_mod.init_params(cfg, None, device="meta")
    used = set()

    def fill(t, prefix):
        import torch
        if t is None:
            return None
        if isinstance(t, torch.Tensor):
            name = bench_name(prefix)
            w = W[name]
            if tuple(w.shape) != tuple(t.shape):
                raise ValueError(f"{name}: weights {tuple(w.shape)} against "
                                 f"the program's {tuple(t.shape)}")
            used.add(name)
            return w
        return type(t)(*(fill(getattr(t, f), f"{prefix}.{f}" if prefix
                              else f) for f in t._fields))
    out = fill(tree, "")
    if used != set(W):
        raise ValueError(f"weights the program does not hold: "
                         f"{sorted(set(W) - used)}")
    return out


def smi() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else \
            "nvidia-smi: no output"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


class Checks:
    """The numbers compared to decide ``correct``, each beside its limit
    (a number is sound at or under its limit)."""

    def __init__(self):
        self.items: dict = {}

    def add(self, name: str, value: float, limit: float) -> None:
        """A value that is not finite is recorded as 1e300 (it fails)."""
        v = float(value)
        self.items[name] = {"value": v if math.isfinite(v) else 1e300,
                            "limit": float(limit)}

    @property
    def ok(self) -> bool:
        return bool(self.items) and all(
            v["value"] <= v["limit"] for v in self.items.values())

    def lines(self) -> list:
        return [f"check {k}: {v['value']!r} limit {v['limit']!r} "
                f"{'ok' if v['value'] <= v['limit'] else 'FAIL'}"
                for k, v in self.items.items()]
