"""Deterministic synthetic LM data pipeline.

A copy of the reference's ``DataConfig`` / ``SyntheticLM`` (numpy), so the
port's profiling batches are bitwise the reference's: deterministic per
(seed, step, host-shard).

The token stream is a mixture of Zipf-distributed unigrams with a Markov
flavor so that (a) CE loss decreases meaningfully when training and (b) MoE
gating sees *structured*, non-uniform tokens — which is what makes expert
popularity skewed at inference (paper §2.2, Fig. 6).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    n_hosts: int = 1
    host_id: int = 0


class SyntheticLM:
    """Deterministic structured token stream."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.RandomState(cfg.seed)
        v = cfg.vocab_size
        # fixed Zipf unigram distribution + a sparse "bigram successor" map
        ranks = np.arange(1, v + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self.unigram = p / p.sum()
        self.successor = rng.randint(0, v, size=(v,), dtype=np.int64)

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        per_host = cfg.global_batch // cfg.n_hosts
        rng = np.random.RandomState(
            (cfg.seed * 1_000_003 + step * 613 + cfg.host_id) % (2 ** 31 - 1))
        b, s = per_host, cfg.seq_len
        toks = rng.choice(cfg.vocab_size, size=(b, s + 1), p=self.unigram)
        # Markov structure: with p=0.5 the next token is the fixed successor
        follow = rng.rand(b, s) < 0.5
        toks[:, 1:][follow] = self.successor[toks[:, :-1][follow]]
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}
