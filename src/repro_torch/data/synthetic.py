"""Deterministic synthetic token streams (port of the LM half of
``repro.data.synthetic``, numpy only, bit-identical batches).

Stateless: batch = f(seed, step), so a restart at step k reproduces the
exact stream.  ``SyntheticImages`` and ``SyntheticAudio`` come with
their slices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np


@dataclass(frozen=True)
class SyntheticLM:
    """Token streams with learnable n-gram structure: a fixed random
    transition table T gives the next token from the previous two, plus
    ε-noise."""
    vocab_size: int
    seq_len: int
    seed: int = 0
    order: int = 2
    noise: float = 0.05

    def _table(self):
        rng = np.random.RandomState(self.seed)
        return rng.randint(0, self.vocab_size,
                           size=(self.vocab_size, self.vocab_size))

    def batch(self, step: int, batch_size: int) -> Dict[str, np.ndarray]:
        """Markov stream: t_{i+1} = T[t_{i-1}, t_i] with ε-noise."""
        T = self._table()
        rng = np.random.RandomState((self.seed * 1_000_003 + step)
                                    % (2 ** 31 - 1))
        toks = np.zeros((batch_size, self.seq_len + 1), np.int32)
        toks[:, 0] = rng.randint(0, self.vocab_size, batch_size)
        toks[:, 1] = rng.randint(0, self.vocab_size, batch_size)
        for i in range(2, self.seq_len + 1):
            nxt = T[toks[:, i - 2], toks[:, i - 1]]
            flip = rng.rand(batch_size) < self.noise
            nxt = np.where(flip, rng.randint(0, self.vocab_size, batch_size),
                           nxt)
            toks[:, i] = nxt
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

