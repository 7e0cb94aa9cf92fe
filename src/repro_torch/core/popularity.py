"""Lina §5.2: token-level expert-selection patterns -> expert popularity
estimation ahead of the gating network.

The paper profiles, per *sample path* j (the sequence of experts a token
selected in layers i-l..i), the next-layer selection distribution Ψ_j^{i+1},
then at inference estimates layer i+1's popularity from each token's path
(Eq. 1).  We store Ψ as fixed-size hashed-path tables (exact when E^l fits
the bucket count; graceful collision degradation otherwise) instead of the
paper's per-device ``unordered_map`` — bounded memory, fixed shapes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


def rolling_path_id(path_id, expert, n_experts: int, path_len: int,
                    n_buckets: int):
    """Update the rolling path hash with the expert chosen at this layer.

    path_id' = (path_id * E + e) mod B.  With B >= E^l this is an exact
    encoding of the last-l path (the modulus only folds older history).
    """
    return (path_id * n_experts + expert) % n_buckets


def exact_buckets(n_experts: int, path_len: int, cap: int = 1 << 16) -> int:
    """Bucket count: exact path space if it fits, else capped."""
    return int(min(n_experts ** path_len, cap))


@dataclass
class PathProfile:
    """Profiled Ψ tables: counts[layer, bucket, expert]."""

    n_layers: int
    n_experts: int
    path_len: int = 3
    n_buckets: int = 0
    counts: np.ndarray = field(default=None)  # [L, B, E] float32

    def __post_init__(self):
        if not self.n_buckets:
            self.n_buckets = exact_buckets(self.n_experts, self.path_len)
        if self.counts is None:
            self.counts = np.zeros(
                (self.n_layers, self.n_buckets, self.n_experts), np.float32)

    # -- profiling stage (run while/after training, §5.2) ------------------
    def update(self, layer: int, path_ids: np.ndarray, experts: np.ndarray):
        """Accumulate: tokens with path ``path_ids`` chose ``experts`` (top-1)
        at ``layer``.  path_ids/experts: [T] int."""
        np.add.at(self.counts[layer], (np.asarray(path_ids),
                                       np.asarray(experts)), 1.0)

    def profile_batch(self, expert_choices: np.ndarray):
        """expert_choices: [n_layers, T] top-1 expert per token per layer.
        Replays the rolling hash exactly as inference will."""
        n_layers, t = expert_choices.shape
        path = np.zeros((t,), np.int64)
        for i in range(n_layers):
            if i >= self.path_len:   # need l layers of history (paper: start
                self.update(i, path, expert_choices[i])   # from l-th layer)
            path = (path * self.n_experts + expert_choices[i]) % self.n_buckets

    # -- inference stage ----------------------------------------------------
    smoothing: float = 4.0

    def distribution(self, layer: int, path_ids) -> np.ndarray:
        """Ψ lookup: [T] path ids -> [T, E] next-layer distributions.

        Add-α smoothing toward the layer marginal: sparsely-observed paths
        interpolate to the marginal instead of over-trusting a handful of
        counts (longer paths => exponentially more buckets; without this the
        paper's 'longer path = better' trend inverts at small profile sizes)."""
        c = self.counts[layer]                              # [B, E]
        rows = c[np.asarray(path_ids)]                      # [T, E]
        row_tot = rows.sum(-1, keepdims=True)
        marginal = c.sum(0)
        marg_tot = marginal.sum()
        if marg_tot == 0:
            marginal = np.full((self.n_experts,), 1.0 / self.n_experts)
        else:
            marginal = marginal / marg_tot
        a = self.smoothing
        out = (rows + a * marginal[None, :]) / (row_tot + a)
        return out.astype(np.float32)

    def estimate_popularity(self, layer: int, path_ids) -> np.ndarray:
        """Eq. 1 aggregation: mean over tokens of per-path top-k-masked
        distributions -> [E] popularity (sums to ~1)."""
        dist = self.distribution(layer, path_ids)           # [T, E]
        pop = dist.mean(0)
        s = pop.sum()
        return pop / s if s > 0 else np.full((self.n_experts,),
                                             1.0 / self.n_experts)

    def save(self, path: str):
        np.savez_compressed(path, counts=self.counts,
                            meta=np.array([self.n_layers, self.n_experts,
                                           self.path_len, self.n_buckets]))

    @classmethod
    def load(cls, path: str) -> "PathProfile":
        z = np.load(path)
        l, e, pl, b = [int(v) for v in z["meta"]]
        return cls(n_layers=l, n_experts=e, path_len=pl, n_buckets=b,
                   counts=z["counts"])


def top2k_sets_match(est_pop: np.ndarray, actual_pop: np.ndarray,
                     k: int) -> bool:
    """The §5.2 top-2k check, the repo's single implementation: True iff the
    top-2k estimated experts equal the top-2k actual experts (as *sets*;
    'comparing the overall top-2k experts').  Shared by the phase-2
    fine-tune trigger (``placement.needs_finetune``), the accuracy metric,
    and plan-cache invalidation."""
    kk = min(2 * k, est_pop.shape[-1])
    est = set(np.argsort(-est_pop)[:kk].tolist())
    act = set(np.argsort(-actual_pop)[:kk].tolist())
    return est == act


def estimation_accuracy(est_pop: np.ndarray, actual_pop: np.ndarray,
                        k: int) -> bool:
    """Accuracy metric (Fig. 19 / Table 5): alias of the §5.2 check."""
    return top2k_sets_match(est_pop, actual_pop, k)
