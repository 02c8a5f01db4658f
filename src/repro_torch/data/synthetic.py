"""Deterministic synthetic datasets (port of ``repro.data.synthetic``
without the audio set; numpy only, bit-identical batches).

Stateless: batch = f(seed, step), so a restart at step k reproduces the
exact stream.

SyntheticLM     — token streams with learnable n-gram structure.
SyntheticImages — CIFAR-like 32×32×3 images: the class is which of 10
                  fixed random pattern templates is embedded (plus
                  noise), so accuracy is meaningful.
``lm_batch`` and ``cifar_like_batch`` are one-call shortcuts to them.
``SyntheticAudio`` comes with the encoder-decoder slice.
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



@dataclass(frozen=True)
class SyntheticImages:
    num_classes: int = 10
    image_size: int = 32
    channels: int = 3
    seed: int = 0
    noise: float = 0.3

    def _templates(self) -> np.ndarray:
        rng = np.random.RandomState(self.seed)
        return rng.randn(self.num_classes, self.image_size, self.image_size,
                         self.channels).astype(np.float32)

    def batch(self, step: int, batch_size: int) -> Dict[str, np.ndarray]:
        tmpl = self._templates()
        rng = np.random.RandomState((self.seed * 1_000_003 + step + 7)
                                    % (2 ** 31 - 1))
        labels = rng.randint(0, self.num_classes, batch_size)
        imgs = tmpl[labels] + self.noise * rng.randn(
            batch_size, self.image_size, self.image_size,
            self.channels).astype(np.float32)
        return {"images": imgs.astype(np.float32),
                "labels": labels.astype(np.int32)}


def lm_batch(vocab: int, seq_len: int, batch: int, step: int = 0,
             seed: int = 0) -> Dict[str, np.ndarray]:
    return SyntheticLM(vocab, seq_len, seed).batch(step, batch)


def cifar_like_batch(batch: int, step: int = 0, seed: int = 0
                     ) -> Dict[str, np.ndarray]:
    return SyntheticImages(seed=seed).batch(step, batch)
