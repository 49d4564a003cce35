"""Straggler mitigation for FL rounds (host part of ``repro.ft.straggler``).

BCRS already equalizes *communication* time; compute stragglers are handled
by over-selection + deadline: select (1+rho)·C·N clients, aggregate the first
C·N arrivals. Late updates are dropped. Pure numpy, identical to the
reference so seeded cohorts match.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class StragglerPolicy:
    over_selection: float = 0.25     # rho
    deadline_factor: float = 1.5     # x median round time -> hard deadline


def over_select(n_target: int, policy: StragglerPolicy) -> int:
    return int(np.ceil(n_target * (1.0 + policy.over_selection)))


def arrivals(times: Sequence[float], n_target: int,
             policy: StragglerPolicy) -> Tuple[np.ndarray, float]:
    """Given per-client round completion times, pick the aggregation set:
    first ``n_target`` arrivals, capped by the deadline
    (``deadline_factor`` x the median completion time). A client past the
    deadline is excluded even when fewer than ``n_target`` have arrived —
    except the very fastest one, which is always taken so the round can
    never go empty. Returns (bool mask over clients, effective round
    duration)."""
    t = np.asarray(times)
    order = np.argsort(t, kind="stable")
    deadline = policy.deadline_factor * float(np.median(t))
    chosen = np.zeros(len(t), bool)
    took = 0
    for i in order:
        if took >= n_target:
            break
        if took > 0 and t[i] > deadline:
            break          # deadline cut; the took>0 guard keeps >= 1 client
        chosen[i] = True
        took += 1
    dur = float(t[chosen].max()) if chosen.any() else 0.0
    return chosen, dur
