"""The one generator of every traffic mix: its parameters come from
``bench/traffic/<name>.json``; what it draws comes from ``--seed``.

Every seed gets the same sizes and the same gaps between arrivals, in an
order of its own: a mix's sizes are the quantiles of its distribution at
(i + 1/2) / n, so the work of a run does not change with the seed, only
its order and its token ids.  The order is balanced (``balanced_order``):
each run of ``STRATA`` consecutive requests holds one size from each
tenth of the distribution, so no seed bunches the longest prompts or the
shortest gaps together and a tail reads the same work from seed to seed.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from . import seeds


def train_tokens(traffic: dict, vocab: int, seed: int, device):
    """(batches, batch, seq + 1) token ids, every row its own, drawn on
    the device: step i reads ids [:, :-1] and predicts [:, 1:]."""
    import torch
    gen = torch.Generator(device=device).manual_seed(
        seeds.stream(seed, "tokens"))
    return torch.randint(0, vocab, (traffic["distinct_batches"],
                                    traffic["batch"], traffic["seq"] + 1),
                         generator=gen, device=device)


STRATA = 10


def balanced_order(values: np.ndarray, rng, strata: int = STRATA):
    """``values`` (sorted) in an order drawn from ``rng`` in which each
    block of ``strata`` consecutive entries takes one value from each of
    ``strata`` equal slices of the sorted list, in a random order."""
    slices = [rng.permutation(part) for part in
              np.array_split(np.asarray(values), min(strata, len(values)))]
    out = []
    for b in range(max(len(part) for part in slices)):
        block = [part[b] for part in slices if b < len(part)]
        out.extend(rng.permutation(block))
    return np.asarray(out)


def quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def _log_uniform(lo: int, hi: int, q) -> np.ndarray:
    return np.rint(np.exp(np.log(lo) + q * (np.log(hi) - np.log(lo)))
                   ).astype(np.int64)


def _uniform_int(lo: int, hi: int, q) -> np.ndarray:
    return lo + np.floor(q * (hi - lo + 1)).astype(np.int64)


@dataclass
class Request:
    uid: str
    due_s: float            # seconds after the window opens
    prompt: np.ndarray      # int32 token ids
    max_new: int


# the gaps between arrivals, by the quantiles q of their distribution
ARRIVALS = {
    "poisson": lambda q, rate: -np.log1p(-q) / rate,   # exponential gaps
}


def open_loop(traffic: dict, vocab: int, seed: int,
              seconds: float) -> list[Request]:
    """Requests due over ``seconds`` at ``rate`` a second: the gaps are
    the quantiles of the ``arrivals`` distribution (``ARRIVALS``), prompt
    lengths log-uniform over ``prompt_tokens``, answer lengths uniform
    over ``answer_tokens``; each list put in a balanced order drawn from
    the seed on its own, every prompt's ids drawn from it."""
    arrivals = traffic["arrivals"]
    if arrivals not in ARRIVALS:
        raise ValueError(f"unknown arrivals {arrivals!r}; have "
                         f"{sorted(ARRIVALS)}")
    rate = float(traffic["rate"])
    n = max(1, int(round(rate * seconds)))
    q = quantiles(n)
    order = np.random.default_rng(seeds.stream(seed, "order"))
    gaps, plen, alen = (balanced_order(a, order) for a in (
        ARRIVALS[arrivals](q, rate),
        _log_uniform(*traffic["prompt_tokens"], q),
        _uniform_int(*traffic["answer_tokens"], q)))
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    ids = np.random.default_rng(seeds.stream(seed, "tokens"))
    return [Request(f"r{i}", float(due[i]),
                    ids.integers(0, vocab, int(plen[i]), dtype=np.int32),
                    int(alen[i])) for i in range(n)]


def nearest_rank(values, p: float) -> float:
    """The ``p``-th percentile by nearest rank: the smallest value with at
    least p% of the values at or below it (inf stands for a missing
    one)."""
    v = sorted(values)
    return v[max(0, math.ceil(p / 100 * len(v)) - 1)]
