"""Deterministic synthetic token streams.

The same order-1 Markov source with motif insertions as the JAX package's
``repro/data/synthetic.py``, drawn with the same numpy generators, so a
given ``(vocab, seed)`` yields the same prompts in both packages, and
:func:`token_batches` the same training batches for every step.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device

__all__ = ["SyntheticLM", "token_batches", "make_calibration"]


@dataclasses.dataclass
class SyntheticLM:
    """Order-1 Markov token source with motif insertions (deterministic)."""

    vocab: int
    seed: int = 0
    n_motifs: int = 64
    motif_len: int = 8

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = self.vocab
        self.n_succ = min(32, v)
        self.succ = rng.integers(0, v, size=(v, self.n_succ), dtype=np.int32)
        self.succ_p = rng.dirichlet(np.ones(self.n_succ) * 0.5, size=v).astype(
            np.float32
        )
        self.motifs = rng.integers(
            0, v, size=(self.n_motifs, self.motif_len), dtype=np.int32
        )

    def sample(self, rng: np.random.Generator, batch: int, seq: int) -> np.ndarray:
        out = np.empty((batch, seq), dtype=np.int32)
        tok = rng.integers(0, self.vocab, size=batch).astype(np.int32)
        for t in range(seq):
            u = rng.random(batch)
            cdf = np.cumsum(self.succ_p[tok], axis=-1)
            idx = (u[:, None] > cdf).sum(-1).clip(0, self.n_succ - 1)
            tok = self.succ[tok, idx]
            out[:, t] = tok
        n_splice = max(1, seq // (4 * self.motif_len))
        for b in range(batch):
            for _ in range(n_splice):
                m = rng.integers(0, self.n_motifs)
                p = rng.integers(0, max(1, seq - self.motif_len))
                out[b, p : p + self.motif_len] = self.motifs[m]
        return out


def token_batches(vocab: int, global_batch: int, seq_len: int, *,
                  seed: int = 0, start_step: int = 0,
                  device=DEFAULT_DEVICE) -> Iterator[dict]:
    """Deterministic ``(seed, step) -> batch`` stream: ``{"tokens",
    "targets"}``, (global_batch, seq_len) int32 tensors on ``device``, the
    targets the tokens shifted by one.  A batch depends only on ``(seed,
    step)`` (its generator is seeded ``(seed << 20) ^ step``), so a run
    resumed at ``start_step`` replays the stream exactly."""
    device = resolve_device(device)
    src = SyntheticLM(vocab, seed)
    step = start_step
    while True:
        rng = np.random.default_rng((seed << 20) ^ step)
        toks = torch.from_numpy(src.sample(rng, global_batch, seq_len + 1))
        toks = toks.to(device)
        yield {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        step += 1


def make_calibration(vocab: int, *, n_segments: int = 128,
                     seg_len: int = 2048, seed: int = 1234,
                     source_seed: int = 0) -> np.ndarray:
    """(n_segments, seg_len) int32 token segments: ``source_seed`` picks the
    Markov source, ``seed`` the samples."""
    src = SyntheticLM(vocab, source_seed)
    return src.sample(np.random.default_rng(seed), n_segments, seg_len)
