"""Trace-driven workload engine: seeded, replayable request streams whose
expert popularity MOVES — the traffic the static benchmark can't express.

The repo's smoke models route by token content (random embeddings + a
skewed router), so *which vocabulary a request draws from* determines which
experts get hot.  Drift is modeled the way content popularity actually
moves — as a TOPIC MIXTURE with slowly-varying weights: the vocabulary is
split into ``topics`` disjoint token pools, each with a fixed internal Zipf
ranking (a topic's #1 token stays its #1 token), and request tokens are
drawn from the mixture whose weights rotate over ``drift_period``.  The
expert-popularity distribution therefore drifts smoothly and *learnably*
(yesterday's hot topic fades while the next rises), rather than re-rolling
per request — popularity noise at request granularity is white noise no
scheduler can beat, and models nothing real.

  stationary      fixed mixture weights, Poisson arrivals — the static
                  regime;
  drifting_zipf   the mixture weights rotate continuously (one full cycle
                  over the topics per ``drift_period`` virtual seconds), so
                  the hot-expert set migrates under the server;
  flash_crowd     stationary background, then a burst window where the
                  arrival rate multiplies and every request draws from a
                  tiny far-away pool — an abrupt popularity flip plus a
                  load spike;
  diurnal         the arrival rate swings sinusoidally over the trace while
                  the mixture rotates slowly — the daily tide.

``generate_trace(spec, vocab_size)`` is a pure function of its arguments:
the same seed replays the identical (tokens, arrival) stream, so controller
experiments are reproducible end-to-end.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

KINDS = ("stationary", "drifting_zipf", "flash_crowd", "diurnal")


@dataclass(frozen=True)
class TraceSpec:
    kind: str = "drifting_zipf"
    n_requests: int = 64
    seq: int = 32
    rate_hz: float = 20.0        # mean arrival rate (requests / virtual s)
    seed: int = 0
    zipf_a: float = 1.3          # skew of token ranks within a topic pool
    pool: int = 16               # tokens per topic pool
    topics: int = 4              # topic pools in the mixture
    kappa: float = 3.0           # mixture sharpness (higher = one topic hot)
    drift_period: float = 2.0    # virtual s per full mixture rotation
    flash_start: float = 0.4     # burst start, fraction of nominal duration
    flash_dur: float = 0.25      # burst length, fraction of nominal duration
    flash_mult: float = 4.0      # arrival-rate multiplier inside the burst
    flash_pool: int = 4          # burst pool size (tiny => sharp flip)
    diurnal_amp: float = 0.8     # rate swing amplitude, fraction of rate_hz

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown workload kind {self.kind!r}; "
                             f"expected one of {KINDS}")

    @property
    def duration(self) -> float:
        """Nominal trace duration in virtual seconds."""
        return self.n_requests / self.rate_hz


def _in_flash(spec: TraceSpec, t: float) -> bool:
    d = spec.duration
    return spec.kind == "flash_crowd" and \
        spec.flash_start * d <= t < (spec.flash_start + spec.flash_dur) * d


def _rate(spec: TraceSpec, t: float) -> float:
    if spec.kind == "flash_crowd":
        return spec.rate_hz * (spec.flash_mult if _in_flash(spec, t) else 1.0)
    if spec.kind == "diurnal":
        return spec.rate_hz * (1.0 + spec.diurnal_amp *
                               np.sin(2.0 * np.pi * t / spec.duration))
    return spec.rate_hz


def _mixture_weights(spec: TraceSpec, t: float) -> np.ndarray:
    """Topic weights at virtual time ``t``: a von-Mises-style bump rotating
    over the topic ring; ``kappa`` sets how dominant the hot topic is."""
    k = np.arange(spec.topics)
    if spec.kind == "drifting_zipf":
        phase = t / spec.drift_period
    elif spec.kind == "diurnal":
        phase = t / (2.0 * spec.drift_period)     # slower tide
    else:
        phase = 0.0
    w = np.exp(spec.kappa * np.cos(2.0 * np.pi * (phase - k / spec.topics)))
    return w / w.sum()


def _token_probs(spec: TraceSpec, t: float, vocab: int,
                 perm: np.ndarray):
    """(candidate token ids, per-token probabilities) at time ``t``."""
    if _in_flash(spec, t):
        fp = min(spec.flash_pool, vocab)
        return perm[(vocab // 2 + np.arange(fp)) % vocab], \
            np.full((fp,), 1.0 / fp)
    pool = min(spec.pool, max(1, vocab // max(spec.topics, 1)))
    ranks = np.arange(1, pool + 1, dtype=np.float64) ** -spec.zipf_a
    ranks /= ranks.sum()
    weights = _mixture_weights(spec, t)
    ids = np.concatenate([perm[(k * pool + np.arange(pool)) % vocab]
                          for k in range(spec.topics)])
    p = np.concatenate([w * ranks for w in weights])
    return ids, p / p.sum()


def generate_trace(spec: TraceSpec, vocab_size: int
                   ) -> List[Tuple[np.ndarray, float]]:
    """Seeded open-loop trace: [(tokens [seq] int64, arrival_s)], sorted by
    arrival.  Feed straight into ``runtime.engine.simulate``."""
    rng = np.random.RandomState(spec.seed)
    perm = rng.permutation(vocab_size)
    trace: List[Tuple[np.ndarray, float]] = []
    t = 0.0
    for _ in range(spec.n_requests):
        t += rng.exponential(1.0 / max(_rate(spec, t), 1e-9))
        ids, p = _token_probs(spec, t, vocab_size, perm)
        tokens = ids[rng.choice(ids.shape[0], spec.seq, p=p)]
        trace.append((tokens.astype(np.int64), t))
    return trace


# Named scenarios the serve driver and the chip smoke share; the two
# ``drift*`` entries drift at two speeds (the flash crowd drifts abruptly,
# the zipf window continuously).
SCENARIOS = {
    "stationary": TraceSpec(kind="stationary"),
    "drift": TraceSpec(kind="drifting_zipf", drift_period=2.0),
    "drift_fast": TraceSpec(kind="drifting_zipf", drift_period=0.8),
    "flash": TraceSpec(kind="flash_crowd"),
    "diurnal": TraceSpec(kind="diurnal"),
}


def get_spec(name: str, **overrides) -> TraceSpec:
    """A named scenario's spec with field overrides applied (seed,
    n_requests, seq, rate_hz, ...) — the one way drivers instantiate
    scenarios, so override handling cannot diverge between them."""
    spec = SCENARIOS[name]
    return dataclasses.replace(spec, **overrides) if overrides else spec


def get_trace(name: str, vocab_size: int, **overrides
              ) -> List[Tuple[np.ndarray, float]]:
    """``generate_trace(get_spec(name, **overrides), vocab_size)``."""
    return generate_trace(get_spec(name, **overrides), vocab_size)
