"""Deterministic sharded synthetic LM data pipeline.

Each host generates only its own shard of the global batch (no cross-host
traffic), deterministically from (seed, step, host_id) — so the pipeline is
*restartable at any step* (checkpoint resume needs no data-state file) and
*reshardable* (a host picks up any shard range after elastic rescaling or
straggler reassignment).

The token stream is a noisy order-2 Markov chain over the vocab, giving a
learnable structure (loss decreases below log(V)) without any dataset file.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class TokenPipeline:
    vocab: int
    seq_len: int
    global_batch: int
    n_hosts: int = 1
    host_id: int = 0
    seed: int = 0
    noise: float = 0.15

    def __post_init__(self):
        assert self.global_batch % self.n_hosts == 0
        self.host_batch = self.global_batch // self.n_hosts
        # fixed per-seed Markov transition "ruleset": next = perm[cur] with
        # occasional jumps; cheap to evaluate without a VxV matrix.
        rng = np.random.default_rng(self.seed)
        self._perm1 = rng.permutation(self.vocab)
        self._perm2 = rng.permutation(self.vocab)

    def _gen(self, rows: np.ndarray, step: int) -> np.ndarray:
        """rows: global row indices; deterministic in (seed, step, row) —
        per-ROW rng streams, so any host generating any subset of rows
        produces exactly the rows the full-batch generator would."""
        n = len(rows)
        start = (rows * 2654435761 + step * 97) % self.vocab
        toks = np.empty((n, self.seq_len + 1), np.int64)
        toks[:, 0] = start
        jumps = np.empty((n, self.seq_len), bool)
        rand_tok = np.empty((n, self.seq_len), np.int64)
        use2 = np.empty((n, self.seq_len), bool)
        for i, row in enumerate(rows):
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, step, int(row)]))
            jumps[i] = rng.random(self.seq_len) < self.noise
            rand_tok[i] = rng.integers(0, self.vocab, self.seq_len)
            use2[i] = rng.random(self.seq_len) < 0.5
        for t in range(self.seq_len):
            cur = toks[:, t]
            nxt = np.where(use2[:, t], self._perm2[cur], self._perm1[cur])
            toks[:, t + 1] = np.where(jumps[:, t], rand_tok[:, t], nxt)
        return toks

    def host_rows(self) -> np.ndarray:
        lo = self.host_id * self.host_batch
        return np.arange(lo, lo + self.host_batch)

    def batch_at(self, step: int) -> dict:
        """The host-local shard of the global batch for ``step``."""
        toks = self._gen(self.host_rows(), step)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
