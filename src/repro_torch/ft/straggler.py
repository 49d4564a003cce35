"""Straggler mitigation for FL rounds (torch port of
``repro.ft.straggler``).

BCRS already equalizes *communication* time; compute stragglers are handled
by over-selection + deadline: select (1+rho)·C·N clients, aggregate the first
C·N arrivals, renormalize coefficients over the arrived set. Late updates are
dropped. The host functions are pure numpy, identical to the reference so
seeded cohorts match; the ``*_traced`` twins run on the device for the
in-program sampling of ``simulation.run_fl_traced``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


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


def _nanmedian_midpoint(t: torch.Tensor) -> torch.Tensor:
    """``jnp.nanmedian`` of a 1-D f32 tensor, bit for bit: NaNs sort last,
    the two middle finite-count order statistics are averaged as
    ``(lo + hi) * 0.5`` (JAX's "midpoint"; ``torch.nanmedian`` returns the
    lower one instead). No host round trip: the indices stay on the
    device."""
    srt = torch.sort(t).values                  # NaN sorts last
    count = (~torch.isnan(t)).sum().reshape(1)
    last = (count - 1).clamp_min(0)             # all-NaN: both read row 0
    lo, hi = last // 2, (count // 2).minimum(last)
    return ((srt.index_select(0, lo) + srt.index_select(0, hi))
            * 0.5).reshape(())


def arrival_mask_traced(times: torch.Tensor, n_target: int,
                        policy: Optional[StragglerPolicy] = None
                        ) -> torch.Tensor:
    """Device twin of ``arrivals``: pick the ``n_target`` fastest
    finishers, capped — when a ``policy`` is given — by the same deadline as
    the host path (``deadline_factor`` x the median over the *finite*
    completion times, with the never-empty guard on the fastest finisher).
    Clients whose completion time is +inf (already failed) never arrive.
    Returns a bool mask over the cohort axis."""
    t = times.to(torch.float32)
    order = torch.argsort(t, stable=True)
    rank = torch.empty_like(order).scatter_(
        0, order, torch.arange(t.shape[0], device=t.device))
    finite = torch.isfinite(t)
    mask = (rank < n_target) & finite
    if policy is not None:
        med = _nanmedian_midpoint(torch.where(finite, t,
                                              torch.full_like(t, np.nan)))
        deadline = policy.deadline_factor * med
        mask &= (t <= deadline) | (rank == 0)
    return mask


def _sum_in_order(v: torch.Tensor) -> torch.Tensor:
    """Sum of a short 1-D tensor, client by client from the first: the
    order of the reference's sum over a cohort (``Tensor.sum`` adds in
    another order from five elements on, on either device)."""
    total = v[0]
    for i in range(1, v.shape[0]):
        total = total + v[i]
    return total


def renormalize_coefficients_traced(coeffs: torch.Tensor,
                                    arrived: torch.Tensor) -> torch.Tensor:
    """Device twin of ``renormalize_coefficients`` (``torch.where`` in
    place of the host branch, so it runs inside a captured round)."""
    c = coeffs.to(torch.float32)
    out = torch.where(arrived, c, torch.zeros_like(c))
    s_all, s_in = _sum_in_order(c), _sum_in_order(out)
    scale = torch.where(s_in > 0, s_all / s_in.clamp_min(1e-12),
                        torch.ones_like(s_in))
    return out * scale


def renormalize_coefficients(coeffs: np.ndarray, arrived: np.ndarray
                             ) -> np.ndarray:
    """Keep arrived clients' relative weights; zero the rest; rescale so the
    total server step magnitude is preserved (elastic cohort resize)."""
    out = np.where(arrived, coeffs, 0.0)
    s_all, s_in = coeffs.sum(), out.sum()
    if s_in > 0:
        out *= s_all / s_in
    return out
