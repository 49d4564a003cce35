"""Synthetic datasets for the offline container.

* ``synthetic_classification`` — a mixture-of-Gaussians classification task
  (stands in for CIFAR/SVHN in FL benchmarks; learnable, non-trivial, with
  real class structure so Dirichlet label skew is meaningful).
* ``synthetic_lm_tokens`` — Zipf-distributed token streams with a planted
  bigram structure (so LM training shows measurable CE decrease).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def synthetic_classification(n: int, n_classes: int, dim: int,
                             rng: np.random.Generator,
                             noise: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    centers = rng.normal(0.0, 2.0, (n_classes, dim))
    labels = rng.integers(0, n_classes, n)
    x = centers[labels] + rng.normal(0.0, noise, (n, dim))
    return x.astype(np.float32), labels.astype(np.int32)


def synthetic_lm_tokens(n_seqs: int, seq_len: int, vocab: int,
                        rng: np.random.Generator) -> np.ndarray:
    """Zipf unigram + deterministic planted bigraph: token t+1 depends on t
    with prob 0.5 via a fixed permutation (learnable structure)."""
    ranks = np.arange(1, vocab + 1)
    probs = 1.0 / ranks
    probs /= probs.sum()
    perm = rng.permutation(vocab)
    toks = np.empty((n_seqs, seq_len), np.int32)
    toks[:, 0] = rng.choice(vocab, n_seqs, p=probs)
    for t in range(1, seq_len):
        follow = rng.random(n_seqs) < 0.5
        fresh = rng.choice(vocab, n_seqs, p=probs)
        toks[:, t] = np.where(follow, perm[toks[:, t - 1]], fresh)
    return toks


def lm_batch(tokens: np.ndarray):
    """Next-token prediction batch dict from a [B, S+1] token block."""
    return {"tokens": tokens[:, :-1].astype(np.int32),
            "labels": tokens[:, 1:].astype(np.int32)}
