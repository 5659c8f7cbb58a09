"""Deterministic synthetic token stream (a copy of the JAX package's
``data/synthetic.py``; numpy only).

Step-indexed PRNG: batch(step) is a pure function, so a restarted/elastic
run consumes exactly the same data from any step — the property the
fault-tolerance tests pin down (bit-identical resume).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticTokens:
    vocab_size: int
    seq_len: int
    batch: int
    seed: int = 0

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        toks = rng.integers(
            0, self.vocab_size, size=(self.batch, self.seq_len + 1), dtype=np.int32
        )
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
