"""The port stands alone: no module of ``repro_torch`` (nor ``chip_smoke.py``)
imports JAX or the JAX package, and the entry points run on the card unless
the caller asks for the CPU."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
need = {"repro_torch.core.axes", "repro_torch.core.microop",
        "repro_torch.launch.mesh", "repro_torch.optim.reduce",
        "repro_torch.optim.compression", "repro_torch.core.serving",
        "repro_torch.runtime.server", "repro_torch.runtime.engine",
        "repro_torch.launch.serve", "repro_torch.launch.steps",
        "repro_torch.models.lm"}
missing = sorted(need - set(names))
print(len(names), bad, missing)
sys.exit(1 if bad or missing or len(names) < 20 else 0)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC)
    return env


def test_every_port_module_imports_without_jax_or_the_reference():
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_source_line_imports_jax_or_the_reference():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)")
    files = sorted((SRC / "repro_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]
    hits = [f"{f}:{i}" for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if pat.match(line)]
    assert not hits, hits


def test_serve_entry_point_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "gpt2-moe-smoke", "--requests", "1"])


def test_train_entry_points_default_to_the_card_and_raise_without_one(
        tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.convert import from_reference
    from repro_torch.data import DataConfig
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.tree import tree_map
    cfg = get_config("gpt2-moe-smoke")
    no_card = pytest.raises(RuntimeError, match="CUDA is not available")
    with no_card:
        train.main(["--arch", "gpt2-moe-smoke", "--steps", "1",
                    "--ckpt-dir", str(tmp_path)])
    with no_card:
        Trainer(cfg, DataConfig(vocab_size=cfg.vocab_size, seq_len=8,
                                global_batch=2), AdamWConfig(),
                TrainerConfig(ckpt_dir=str(tmp_path)))
    with no_card:
        lm.init_params(cfg, torch.Generator())
    params = lm.init_params(cfg, torch.Generator(), device="cpu")
    with no_card:
        from_reference(tree_map(np.asarray, params))


def test_chip_smoke_fails_without_a_card_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         env=_env(), capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_serve_driver_runs_on_the_cpu_when_asked(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", "gpt2-moe-smoke", "--requests", "3",
                       "--seq", "16", "--max-new-tokens", "3",
                       "--profile-batches", "1", "--device", "cpu",
                       "--warmup"]) == 0
    out = capsys.readouterr().out
    assert "completed 3 requests" in out and "TPOT p50" in out
    assert "warm-up ran" in out
