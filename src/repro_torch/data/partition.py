"""Dirichlet label-skew partitioning (paper §5.1, following Li et al. 2021).

Each client i receives a proportion ``p_{k,i}`` of class k's samples with
``p_k ~ Dir(beta)``. beta=0.1 -> severe heterogeneity, beta=0.5 -> moderate.
"""
from __future__ import annotations

from typing import List

import numpy as np


def dirichlet_partition(labels: np.ndarray, n_clients: int, beta: float,
                        rng: np.random.Generator,
                        min_size: int = 2) -> List[np.ndarray]:
    """Returns per-client index arrays covering all samples exactly once."""
    n_classes = int(labels.max()) + 1
    while True:
        idx_by_client: List[List[int]] = [[] for _ in range(n_clients)]
        for k in range(n_classes):
            idx_k = np.where(labels == k)[0]
            rng.shuffle(idx_k)
            props = rng.dirichlet(np.full(n_clients, beta))
            cuts = (np.cumsum(props)[:-1] * len(idx_k)).astype(int)
            for c, part in enumerate(np.split(idx_k, cuts)):
                idx_by_client[c].extend(part.tolist())
        sizes = [len(ix) for ix in idx_by_client]
        if min(sizes) >= min_size:
            break
    return [np.array(sorted(ix)) for ix in idx_by_client]


def client_label_histogram(labels: np.ndarray,
                           parts: List[np.ndarray]) -> np.ndarray:
    """[n_clients, n_classes] counts — the paper's Fig. 5 heat map data."""
    n_classes = int(labels.max()) + 1
    return np.stack([np.bincount(labels[ix], minlength=n_classes)
                     for ix in parts])


def data_fractions(parts: List[np.ndarray]) -> np.ndarray:
    sizes = np.array([len(ix) for ix in parts], np.float64)
    return sizes / sizes.sum()
