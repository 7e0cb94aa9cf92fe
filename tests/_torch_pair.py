"""A reference server and a port server on the same weights: the shared
set-up of the control-loop tests (``test_torch_sched.py``,
``test_torch_resilience.py``).

``gpt2-moe-smoke`` in float32, the reference's params converted with
``from_reference``, an empty path profile of path length 2 and the
``lina`` policy in both, as the reference's own engine tests build theirs.
"""
import dataclasses

import jax
import numpy as np

from repro.configs import get_config as j_get_config
from repro.core.popularity import PathProfile as JPathProfile
from repro.models import lm as jlm
from repro.runtime.server import MoEServer as JMoEServer
from repro.runtime.server import ServerConfig as JServerConfig
from repro_torch.configs import get_config
from repro_torch.convert import from_reference
from repro_torch.core.popularity import PathProfile
from repro_torch.runtime.server import MoEServer, ServerConfig


def server_pair(capacity_factor=None, seed: int = 0):
    """(port cfg, reference server, port server)."""
    jcfg, cfg = j_get_config("gpt2-moe-smoke"), get_config("gpt2-moe-smoke")
    if capacity_factor is not None:
        jcfg, cfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=capacity_factor)) for c in (jcfg, cfg))
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    params = from_reference(jax.tree.map(np.asarray, jparams), device="cpu")
    kw = dict(n_layers=cfg.n_moe_layers, n_experts=cfg.moe.n_experts,
              path_len=2)
    scfg = dict(path_len=2, schedule_policy="lina")
    jsrv = JMoEServer(jcfg, jparams, JPathProfile(**kw), JServerConfig(**scfg))
    srv = MoEServer(cfg, params, PathProfile(**kw), ServerConfig(**scfg),
                    device="cpu")
    return cfg, jsrv, srv


def tokens_of(results):
    """{rid: generated tokens as a list, or None (score-only)}."""
    return {r.rid: (None if r.tokens is None else np.asarray(r.tokens)
                    .tolist()) for r in results}


def plan_arrays(plan):
    """A ``PlacementPlan``'s tables as plain lists, to compare two
    packages' plans field by field."""
    return {f: np.asarray(getattr(plan, f)).tolist()
            for f in ("slot_expert", "replica_of", "n_replicas")}
