"""The benchmark's traffic generator: a frozen copy of the stationary
topic-mixture Zipf token source of ``repro_torch/sched/workloads.py``
(``_mixture_weights`` at phase 0, ``_token_probs``), plus the request
sizes and arrival gaps of a serving mix.

The vocabulary is split into ``topics`` disjoint pools of ``pool`` tokens
(a seeded permutation), each pool Zipf-ranked with exponent ``zipf_a``;
a token is drawn from the mixture whose weights are a von-Mises bump of
sharpness ``kappa`` over the topic ring.  Routing then sees skewed,
text-like token ids.

Prompt sizes and arrival gaps come from a fixed base seed, in the same
order for every run, so every seed offers the same work at the same
times; the run's seed draws the token ids (and the weights).
"""
from __future__ import annotations

import numpy as np

BASE_SEED = 20240417


def rng(seed: int, stream: int = 0) -> np.random.Generator:
    """A generator for ``seed`` (any whole number) and a stream id."""
    return np.random.default_rng([int(seed) % (1 << 63), int(stream)])


class TopicMixture:
    """Stationary topic-mixture Zipf token ids over ``vocab``."""

    def __init__(self, vocab: int, *, topics: int, pool: int, zipf_a: float,
                 kappa: float, seed: int):
        perm = rng(seed, 1).permutation(vocab)
        pool = min(pool, max(1, vocab // max(topics, 1)))
        ranks = np.arange(1, pool + 1, dtype=np.float64) ** -zipf_a
        ranks /= ranks.sum()
        k = np.arange(topics)
        w = np.exp(kappa * np.cos(2.0 * np.pi * (0.0 - k / topics)))
        w = w / w.sum()
        self.ids = np.concatenate([perm[(j * pool + np.arange(pool)) % vocab]
                                   for j in range(topics)])
        p = np.concatenate([wj * ranks for wj in w])
        self.cdf = np.cumsum(p / p.sum())
        self.cdf[-1] = 1.0

    def draw(self, g: np.random.Generator, n: int) -> np.ndarray:
        """``n`` token ids (int64)."""
        return self.ids[np.searchsorted(self.cdf, g.random(n), side="right")]


def mixture(vocab: int, mix: dict, seed: int) -> TopicMixture:
    t = mix["tokens"]
    return TopicMixture(vocab, topics=t["topics"], pool=t["pool"],
                        zipf_a=t["zipf_a"], kappa=t["kappa"], seed=seed)


def train_batches(vocab: int, mix: dict, seed: int, n: int) -> list:
    """``n`` batches {"tokens", "labels"} int32 [B, S] of distinct rows:
    next-token labels of one stream of B x (S + 1) ids a batch."""
    b, s = mix["batch"], mix["seq"]
    src = mixture(vocab, mix, seed)
    g = rng(seed, 2)
    out = []
    for _ in range(n):
        t = src.draw(g, b * (s + 1)).reshape(b, s + 1)
        out.append({"tokens": t[:, :-1].astype(np.int32),
                    "labels": t[:, 1:].astype(np.int32)})
    return out


def serve_requests(vocab: int, mix: dict, seed: int, rate: float,
                   seconds: float) -> list:
    """Open-loop requests [(tokens int64 [L], due seconds from the start)]
    for ``seconds`` at ``rate`` a second: prompt lengths lognormal (median
    ``median``, sigma ``sigma``) clipped to [``min_len``, ``max_len``] and
    exponential gaps, both from the base seed; token ids from ``seed``."""
    p = mix["prompt"]
    n = int(np.ceil(rate * seconds * 1.25)) + 8
    lens = np.clip(np.round(rng(BASE_SEED, 3).lognormal(
        np.log(p["median"]), p["sigma"], n)), p["min_len"],
        p["max_len"]).astype(np.int64)
    due = np.cumsum(rng(BASE_SEED, 4).exponential(1.0 / rate, n))
    g = rng(seed, 4)
    src = mixture(vocab, mix, seed)
    return [(src.draw(g, int(n_tok)), float(t))
            for n_tok, t in zip(lens, due) if t < seconds]
