"""Deterministic synthetic LM data pipeline.

A copy of the reference's ``DataConfig`` / ``SyntheticLM`` (numpy),
``make_batch_iterator`` and ``Prefetcher``, so the port's batches are
bitwise the reference's: deterministic per (seed, step, host-shard).

The token stream is a mixture of Zipf-distributed unigrams with a Markov
flavor so that (a) CE loss decreases meaningfully when training and (b) MoE
gating sees *structured*, non-uniform tokens — which is what makes expert
popularity skewed at inference (paper §2.2, Fig. 6).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator

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


def make_batch_iterator(cfg: DataConfig, start_step: int = 0) -> Iterator[dict]:
    ds = SyntheticLM(cfg)
    step = start_step
    while True:
        yield ds.batch(step)
        step += 1


class Prefetcher:
    """Bounded-queue background prefetch (straggler decoupling)."""

    def __init__(self, it: Iterator[dict], depth: int = 2):
        self._it = it
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                if self._stop.is_set():
                    return
                self._q.put(item)
        finally:
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
