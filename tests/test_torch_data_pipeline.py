"""``data/pipeline.py``'s batch iterator and prefetcher against the
reference's: the same batches, bit for bit, from any start step and host
shard, in order through the prefetch queue."""
from __future__ import annotations

import itertools

import numpy as np
import pytest

from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import Prefetcher as JPrefetcher
from repro.data.pipeline import make_batch_iterator as j_iterator
from repro_torch.data.pipeline import (DataConfig, Prefetcher,
                                       make_batch_iterator)


def _same(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("kw", [
    dict(vocab_size=512, seq_len=16, global_batch=4),
    dict(vocab_size=1000, seq_len=33, global_batch=6, seed=7, n_hosts=2,
         host_id=1),
    dict(vocab_size=64, seq_len=8, global_batch=3, zipf_a=1.5)])
@pytest.mark.parametrize("start", [0, 5])
def test_batch_iterator_is_the_references(kw, start):
    got = itertools.islice(make_batch_iterator(DataConfig(**kw), start), 4)
    want = itertools.islice(j_iterator(JDataConfig(**kw), start), 4)
    for a, b in zip(got, want, strict=True):
        _same(a, b)


@pytest.mark.parametrize("depth", [1, 3])
def test_prefetcher_is_the_references(depth):
    kw = dict(vocab_size=256, seq_len=12, global_batch=2, seed=3)
    got = Prefetcher(itertools.islice(
        make_batch_iterator(DataConfig(**kw)), 6), depth=depth)
    want = JPrefetcher(itertools.islice(
        j_iterator(JDataConfig(**kw)), 6), depth=depth)
    a, b = list(got), list(want)
    assert len(a) == len(b) == 6
    for x, y in zip(a, b):
        _same(x, y)


def test_prefetcher_close_stops_an_endless_stream():
    pf = Prefetcher(make_batch_iterator(DataConfig(64, 4, 2)), depth=2)
    first = next(pf)
    assert first["tokens"].shape == (2, 4)
    pf.close()
    pf._thread.join(timeout=10)
    assert not pf._thread.is_alive()
