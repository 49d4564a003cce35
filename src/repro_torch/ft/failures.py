"""Failure injection and elastic cohorts for FL rounds (torch port of
``repro.ft.failures``).

Node (client) failures during a round surface as missing updates; the server
aggregates the survivors with renormalized coefficients. The host injector
is pure numpy, copied draw for draw from the reference so seeded failure
schedules match; ``survivors_traced`` is the in-program draw of
``simulation.run_fl_traced``, from a ``torch.Generator`` (its own stream).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch


def survivors_traced(generator: torch.Generator, n_clients: int,
                     p_fail: float) -> torch.Tensor:
    """Device twin of ``FailureInjector.survivors`` for the in-program
    sampling of ``simulation.run_fl_traced``: iid per-round survival draws
    from ``generator`` (on its device; no host round trip, so a CUDA graph
    captures it); if the whole cohort would die, one uniformly chosen client
    is revived — the host injector's never-lose-everyone guarantee.
    Returns bool [n_clients]."""
    dev = generator.device
    alive = torch.rand(n_clients, generator=generator, device=dev) >= p_fail
    pick = torch.randint(0, n_clients, (1,), generator=generator,
                         device=dev)
    revived = torch.zeros(n_clients, dtype=torch.bool, device=dev)
    revived.index_fill_(0, pick, True)
    return alive | (~alive.any() & revived)


_U64 = (1 << 64) - 1


def counter_uniform(seed: int, round_idx: int, ids: np.ndarray) -> np.ndarray:
    """Vectorized counter-based uniform draw on [0, 1) keyed on
    ``(seed, round, id)`` — the population-scale survivor stream.

    PINNED CONVENTION (v1 — changing any constant below changes every
    sparse-failure trajectory): the key is
    ``id * PHI ^ rot(round * M1) ^ rot(seed * M2)`` in u64, run through the
    splitmix64 finalizer, top 53 bits scaled by 2^-53."""
    phi = np.uint64(0x9E3779B97F4A7C15)
    m1, m2 = np.uint64(0xBF58476D1CE4E5B9), np.uint64(0x94D049BB133111EB)
    x = np.asarray(ids, dtype=np.uint64) * phi
    x ^= np.uint64((round_idx * 0xBF58476D1CE4E5B9) & _U64)
    x ^= np.uint64((seed * 0x94D049BB133111EB) & _U64)
    # splitmix64 finalizer (Steele et al.) — full-avalanche mix
    x ^= x >> np.uint64(30)
    x *= m1
    x ^= x >> np.uint64(27)
    x *= m2
    x ^= x >> np.uint64(31)
    return (x >> np.uint64(11)).astype(np.float64) * (2.0 ** -53)


@dataclass
class FailureInjector:
    """Deterministic failure schedule for tests/sims: client i fails in round
    r with probability p (per-round, iid), or at explicit (round, client)."""
    p_fail: float = 0.0
    scheduled: Optional[Sequence] = None   # [(round, client), ...]
    seed: int = 0

    def survivors(self, round_idx: int, n_clients: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 100_003 + round_idx)
        alive = rng.random(n_clients) >= self.p_fail
        if self.scheduled:
            for r, c in self.scheduled:
                if r == round_idx and c < n_clients:
                    alive[c] = False
        if not alive.any():      # never lose the whole cohort
            alive[int(rng.integers(n_clients))] = True
        return alive

    def survivors_at(self, round_idx: int, ids: np.ndarray) -> np.ndarray:
        """Population-scale survivor draw: per-client Bernoulli keyed on
        (seed, round, client id), computed only for the sampled cohort
        (O(C)). Its own deterministic stream, not bit-parity with
        ``survivors``. If every sampled client dies, the first is revived."""
        ids = np.asarray(ids)
        alive = counter_uniform(self.seed, round_idx, ids) >= self.p_fail
        if self.scheduled:
            for r, c in self.scheduled:
                if r == round_idx:
                    alive[ids == c] = False
        if not alive.any():
            alive[0] = True
        return alive


@dataclass
class ElasticPool:
    """Client pool that can grow/shrink between rounds (elastic scaling).
    Selection always samples from the currently-registered set."""
    n_registered: int

    def scale(self, delta: int) -> None:
        self.n_registered = max(1, self.n_registered + delta)

    def sample(self, frac: float, rng: np.random.Generator) -> np.ndarray:
        n_sel = max(1, int(round(self.n_registered * frac)))
        return rng.choice(self.n_registered, size=n_sel, replace=False)
