"""Seeds of the streams a run draws from ``--seed``: each stream (the
weights, the tokens, the order of the traffic) has its own, so one never
shifts another.  Any whole number is a seed, negative or past 64 bits."""

from __future__ import annotations

import numpy as np


def stream(seed: int, name: str) -> int:
    """A 63-bit seed for the stream ``name`` of ``seed``."""
    words = [int(x) for x in np.frombuffer(name.encode(), np.uint8)]
    mag = abs(int(seed))
    parts = [int(seed < 0)] + [(mag >> s) & 0xFFFFFFFF
                               for s in range(0, max(mag.bit_length(), 1), 32)]
    ss = np.random.SeedSequence(parts + [0xBE7C] + words)
    return int(ss.generate_state(2, np.uint64)[0] >> np.uint64(1))
