"""The serving check's sample, kept while the window runs: drawn from the
seed, uniform over the answered requests, the largest among them, and
nothing else held."""

import numpy as np

from portbench.drivers.serve import Sample


def _fill(seed, n=300, size=12, sizes=None, answered=lambda k: True):
    sizes = np.arange(1, 41) if sizes is None else sizes
    s = Sample(size, sizes, seed)
    for k in range(n):
        if answered(k):
            s.offer(k, np.full((1, 1), float(k)))
    return s.answers()


def test_the_same_seed_keeps_the_same_answers_and_another_seed_others():
    a, b, c = _fill(2**31 + 5), _fill(2**31 + 5), _fill(2**31 + 6)
    assert list(a) == list(b)
    assert list(a) != list(c)
    assert all(a[k][0, 0] == k for k in a)


def test_the_sample_holds_its_size_and_the_first_of_the_largest_requests():
    sizes = np.array([5, 9, 3, 9, 1, 2, 7, 4])
    got = _fill(11, n=50, size=6, sizes=sizes)
    assert 1 in got  # the first request of 9 rows
    assert len(got) in (6, 7)
    assert all(0 <= k < 50 for k in got)


def test_only_answered_requests_are_kept():
    got = _fill(7, answered=lambda k: k % 3 != 0)
    assert got and all(k % 3 != 0 for k in got)


def test_every_request_is_kept_about_equally_often():
    n, size, seeds = 60, 6, 3000
    counts = np.zeros(n)
    flat = np.ones(n, dtype=np.int64)  # one size: request 0 is always kept as the largest
    for seed in range(seeds):
        for k in _fill(seed, n=n, size=size, sizes=flat):
            counts[k] += 1
    expected = seeds * size / n
    assert np.all(np.abs(counts[1:] - expected) < 0.25 * expected), counts
