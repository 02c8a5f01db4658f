"""Deterministic synthetic datasets (port of ``repro.data.synthetic``;
numpy only, bit-identical batches).

Stateless: batch = f(seed, step), so a restart at step k reproduces the
exact stream.

SyntheticLM     — token streams with learnable n-gram structure.
SyntheticImages — CIFAR-like 32×32×3 images: the class is which of 10
                  fixed random pattern templates is embedded (plus
                  noise), so accuracy is meaningful.
SyntheticAudio  — mel-frame / transcript pairs for the whisper-style
                  encoder-decoder stub.
``lm_batch`` and ``cifar_like_batch`` are one-call shortcuts to them.
"""
from __future__ import annotations

import functools
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


@functools.lru_cache(maxsize=8)
def _audio_codebook(seed: int, vocab: int, d_model: int) -> np.ndarray:
    """Token → frame-embedding codebook; a pure function of its key, so
    its randn is paid once per key."""
    rng = np.random.RandomState(seed + 17)
    return rng.randn(vocab, d_model).astype(np.float32)


@dataclass(frozen=True)
class SyntheticAudio:
    """Mel-frame / transcript pairs: frames are deterministic per (seed,
    step) noise whose leading rows encode the target tokens through a
    fixed random codebook, so cross-attention has signal to learn from;
    the tokens are ``SyntheticLM``'s Markov stream."""
    vocab_size: int
    seq_len: int
    n_frames: int
    d_model: int
    seed: int = 0
    noise: float = 0.1

    def batch(self, step: int, batch_size: int) -> Dict[str, np.ndarray]:
        b = SyntheticLM(self.vocab_size, self.seq_len, self.seed).batch(
            step, batch_size)
        rng = np.random.RandomState((self.seed * 999_983 + step + 3)
                                    % (2 ** 31 - 1))
        frames = self.noise * rng.randn(
            batch_size, self.n_frames, self.d_model).astype(np.float32)
        code = _audio_codebook(self.seed, self.vocab_size, self.d_model)
        n = min(self.n_frames, self.seq_len)
        frames[:, :n] += code[b["labels"][:, :n]]
        return {"frames": frames, "tokens": b["tokens"],
                "labels": b["labels"]}


def lm_batch(vocab: int, seq_len: int, batch: int, step: int = 0,
             seed: int = 0) -> Dict[str, np.ndarray]:
    return SyntheticLM(vocab, seq_len, seed).batch(step, batch)


def cifar_like_batch(batch: int, step: int = 0, seed: int = 0
                     ) -> Dict[str, np.ndarray]:
    return SyntheticImages(seed=seed).batch(step, batch)
