"""The one generator: deterministic by seed, the same work for every seed
in another order, any whole number a seed."""

import numpy as np
import pytest
import torch

from harness import seeds
from harness.traffic import (balanced_order, nearest_rank, open_loop,
                             quantiles, train_tokens)

MIX = {"arrivals": "poisson", "rate": 6.0, "prompt_tokens": [2048, 16384], "answer_tokens": [8, 32]}
TRAIN = {"batch": 2, "seq": 64, "distinct_batches": 5}
BIG = [0, 1, 2**31 + 12345, 2**64 + 7, -3]


@pytest.mark.parametrize("seed", BIG)
def test_open_loop_repeats_by_seed(seed):
    a, b = open_loop(MIX, 151936, seed, 30), open_loop(MIX, 151936, seed, 30)
    assert [(r.uid, r.due_s, r.max_new) for r in a] == \
        [(r.uid, r.due_s, r.max_new) for r in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))


def test_open_loop_same_work_other_order():
    a, b = open_loop(MIX, 151936, 11, 30), open_loop(MIX, 151936, 12, 30)
    assert len(a) == len(b) == 180
    assert sorted(len(r.prompt) for r in a) == sorted(len(r.prompt) for r in b)
    assert sorted(r.max_new for r in a) == sorted(r.max_new for r in b)
    gaps = [np.diff([r.due_s for r in x] + [0]) for x in (a, b)]
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in b]
    assert not np.array_equal(a[0].prompt[:64], b[0].prompt[:64])
    assert np.isclose(a[-1].due_s + 1 / 6.0, 30, rtol=0.1)
    assert sorted(np.round(gaps[0][:-1], 9)) != [] and len(gaps[1]) == 180


def test_open_loop_sizes_follow_the_mix():
    reqs = open_loop(MIX, 1000, 3, 50)
    plen = np.array([len(r.prompt) for r in reqs])
    assert plen.min() >= 2048 and plen.max() <= 16384
    # log-uniform: the median prompt is the geometric mean of the ends
    assert abs(np.median(plen) / np.sqrt(2048 * 16384) - 1) < 0.02
    assert {r.max_new for r in reqs} == set(range(8, 33))
    assert all(r.prompt.dtype == np.int32 and r.prompt.max() < 1000
               for r in reqs)
    gaps = np.diff([r.due_s for r in reqs])
    assert abs(gaps.mean() * 6.0 - 1) < 0.05


@pytest.mark.parametrize("seed", BIG)
def test_train_tokens_repeat_by_seed(seed):
    a = train_tokens(TRAIN, 512, seed, "cpu")
    assert torch.equal(a, train_tokens(TRAIN, 512, seed, "cpu"))
    assert a.shape == (5, 2, 65) and int(a.max()) < 512
    rows = a.reshape(10, 65)
    assert len({tuple(r.tolist()) for r in rows}) == 10   # every row differs
    assert not torch.equal(a, train_tokens(TRAIN, 512, seed + 1, "cpu"))


def test_streams_differ_and_fit_63_bits():
    got = {seeds.stream(s, n) for s in BIG for n in ("weights", "tokens")}
    assert len(got) == 2 * len(BIG)
    assert all(0 <= v < 2**63 for v in got)


def test_nearest_rank():
    v = list(range(1, 11))
    assert nearest_rank(v, 90) == 9 and nearest_rank(v, 100) == 10
    assert nearest_rank(v + [float("inf")] * 2, 90) == float("inf")
    assert np.allclose(quantiles(4), [0.125, 0.375, 0.625, 0.875])


def test_balanced_order():
    rng = np.random.default_rng(0)
    v = np.arange(100)
    out = balanced_order(v, rng)
    assert sorted(out) == list(v)
    for b in range(10):       # one from each tenth in every block of ten
        assert sorted(out[10 * b:10 * b + 10] // 10) == list(range(10))
    assert not np.array_equal(out, balanced_order(v, rng))
    odd = balanced_order(np.arange(23), np.random.default_rng(1))
    assert sorted(odd) == list(range(23))
    reqs = open_loop(MIX, 1000, 5, 50)
    plen = np.array([len(r.prompt) for r in reqs])
    longest = plen >= np.quantile(plen, 0.9)
    assert max(np.diff(np.flatnonzero(longest))) <= 19


def test_unknown_arrivals_raise():
    with pytest.raises(ValueError, match="unknown arrivals 'burst'"):
        open_loop(dict(MIX, arrivals="burst"), 1000, 5, 10)
    with pytest.raises(KeyError):
        open_loop({k: v for k, v in MIX.items() if k != "arrivals"},
                  1000, 5, 10)
