"""The tail arithmetic: numpy's linear percentile over every request due,
an unserved request counted as failed and as later than every served
one; and the traffic's sizes, the same set under every seed."""
import numpy as np

from bench.yardstick import tails
from bench.yardstick import traffic as TR


def test_percentile_is_numpys():
    v = np.random.default_rng(3).exponential(size=101)
    for q in (50, 95, 99):
        assert tails.percentile(v, q) == float(np.percentile(v, q))


def test_unserved_counts_last():
    due = [0.0, 0.1, 0.2, 5.0]
    done = {0: 0.5, 1: 4.0, 3: 5.2}          # request 2 never served
    lat = tails.latencies(due, done, drain_end=3.5)
    assert lat[2] >= max(lat[0], lat[1], lat[3])
    assert lat[2] == max(3.5 - 0.2, 4.0 - 0.1)
    assert np.allclose(lat[[0, 1, 3]], [0.5, 3.9, 0.2])
    assert tails.percentile(lat, 100) == lat[2]


def test_unserved_sets_the_tail():
    due = list(np.arange(20) * 0.1)
    done = {i: t + 0.05 for i, t in enumerate(due)}
    base = tails.percentile(tails.latencies(due, done, 10.0), 95)
    del done[7], done[9]
    worse = tails.percentile(tails.latencies(due, done, 10.0), 95)
    assert worse > base and worse > 1.0


def test_every_seed_offers_the_same_work():
    mix = {"prompt": {"median": 100, "sigma": 0.6, "min_len": 20,
                      "max_len": 400},
           "tokens": {"topics": 4, "pool": 64, "zipf_a": 1.1, "kappa": 2.0}}
    a = TR.serve_requests(512, mix, 1, 50.0, 100.0)
    b = TR.serve_requests(512, mix, 2**31 + 5, 50.0, 100.0)
    assert [(len(t), d) for t, d in a] == [(len(t), d) for t, d in b]
    assert all(20 <= len(t) <= 400 for t, _ in a)
    assert any(not np.array_equal(x[0], y[0]) for x, y in zip(a, b))
    again = TR.serve_requests(512, mix, 1, 50.0, 100.0)
    assert all(np.array_equal(x[0], y[0]) and x[1] == y[1]
               for x, y in zip(a, again))
