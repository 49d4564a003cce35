"""Client data pipeline: per-client shard iterators with deterministic
shuffling, epoch semantics (paper's E local epochs), and drop-last batching.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np


@dataclass
class ClientDataset:
    x: np.ndarray
    y: np.ndarray

    def __len__(self) -> int:
        return len(self.y)

    def epoch_batches(self, batch_size: int, rng: np.random.Generator
                      ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        order = rng.permutation(len(self.y))
        for i in range(0, len(order) - batch_size + 1, batch_size):
            sel = order[i: i + batch_size]
            yield self.x[sel], self.y[sel]

    def fixed_batch_indices(self, batch_size: int, n_batches: int,
                            rng: np.random.Generator) -> np.ndarray:
        """Local sample indices [n_batches * bs] for ``fixed_batches``
        (cycling if needed). Split out so the scanned simulation can feed the
        *indices* to an in-jit gather — it consumes the exact same rng draws
        as materializing the batches on host, so the two paths stay on one
        seeded stream."""
        need = n_batches * batch_size
        reps = int(np.ceil(need / max(len(self.y), 1)))
        order = np.concatenate([rng.permutation(len(self.y)) for _ in range(reps)])
        return order[:need]

    def fixed_batches(self, batch_size: int, n_batches: int,
                      rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
        """[n_batches, bs, ...] stacked batches (cycling if needed) — the
        shape used by the vmapped mesh-parallel FL round."""
        sel = self.fixed_batch_indices(batch_size, n_batches, rng)
        xs = self.x[sel].reshape(n_batches, batch_size, *self.x.shape[1:])
        ys = self.y[sel].reshape(n_batches, batch_size, *self.y.shape[1:])
        return xs, ys


def build_client_datasets(x: np.ndarray, y: np.ndarray,
                          parts: List[np.ndarray]) -> List[ClientDataset]:
    return [ClientDataset(x[ix], y[ix]) for ix in parts]
