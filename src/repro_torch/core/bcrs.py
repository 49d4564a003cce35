"""Bandwidth-aware Compression Ratio Scheduling (paper Alg. 2 + Eq. 6).

Given per-client links (bandwidth B_i, latency L_i) and an update of V bytes,
the slowest client's post-compression time under the default ratio CR* sets
the benchmark T_bench; every other client's CR is raised to finish at the
same moment:  CR_i = (T_bench - L_i) * B_i / (2 V).

Client-averaging coefficients (Eq. 6):
    p'_i = f_i / max(f_i, Norm(CR_i)) * alpha
The paper leaves Norm() unspecified; we default to sum-normalization
(same scale as the data fractions f_i) and expose the hook.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class ClientLink:
    bandwidth_bps: float     # bits per second
    latency_s: float


def comm_time(v_bytes: float, link: ClientLink, cr: float) -> float:
    """Paper cost model (Alg. 2 line 7): T = L + 2 * V * CR / B.

    V in *bits* on the wire; the 2x covers the sparse-format index overhead
    (int32 index + f32 value per retained parameter at fp32 -> 2x values).
    """
    v_bits = 8.0 * v_bytes
    return link.latency_s + 2.0 * v_bits * cr / link.bandwidth_bps


def comm_time_batch(v_bytes: float, bandwidths_bps: np.ndarray,
                    latencies_s: np.ndarray, crs) -> np.ndarray:
    """Vectorized ``comm_time`` over link arrays (population-scale cohort
    planning). Elementwise float64 with the same operation order as the
    scalar form, so ``comm_time_batch(v, bw, lat, cr)[i]`` is bit-identical
    to ``comm_time(v, ClientLink(bw[i], lat[i]), cr_i)`` — the host-side
    planners can vectorize without perturbing committed golden times."""
    bw = np.asarray(bandwidths_bps, np.float64)
    lat = np.asarray(latencies_s, np.float64)
    v_bits = 8.0 * v_bytes
    return lat + 2.0 * v_bits * np.asarray(crs, np.float64) / bw


def schedule_crs(links: Sequence[ClientLink], v_bytes: float, cr_star: float,
                 cr_max: float = 1.0) -> np.ndarray:
    """Alg. 2: equalize upload completion times at the slowest client's pace."""
    times = np.array([comm_time(v_bytes, l, cr_star) for l in links])
    t_bench = float(times.max())
    v_bits = 8.0 * v_bytes
    crs = np.array([(t_bench - l.latency_s) * l.bandwidth_bps / (2.0 * v_bits)
                    for l in links])
    return np.clip(crs, cr_star, cr_max)


def norm_sum(crs: np.ndarray) -> np.ndarray:
    s = crs.sum()
    return crs / s if s > 0 else crs


def client_coefficients(data_fracs: np.ndarray, crs: np.ndarray, alpha: float,
                        norm: Callable[[np.ndarray], np.ndarray] = norm_sum
                        ) -> np.ndarray:
    """Eq. 6: p'_i = f_i / max(f_i, Norm(CR_i)) * alpha (capped at alpha)."""
    ncr = norm(crs)
    return data_fracs / np.maximum(data_fracs, ncr) * alpha


def staleness_discount(weights: np.ndarray, staleness: np.ndarray,
                       alpha: float) -> np.ndarray:
    """FedBuff-style staleness discount on averaging coefficients:
    ``w_i / (1 + s_i)^alpha`` where ``s_i`` is how many server versions
    elapsed between the client's dispatch and its merge. Lives next to the
    Eq. 6 coefficient math because it composes with it: the async buffered
    engine feeds BCRS/data coefficients through this before the merge.
    ``alpha = 0`` is the identity (discount disabled); larger alpha
    downweights stale updates harder. Monotone non-increasing in staleness
    for alpha >= 0 (asserted in tests/test_async_engine.py)."""
    w = np.asarray(weights, np.float64)
    s = np.asarray(staleness, np.float64)
    return w / np.power(1.0 + s, alpha)


@dataclass
class BCRSSchedule:
    crs: np.ndarray           # per-client compression ratio
    coefficients: np.ndarray  # per-client averaging coefficient p'_i
    t_bench: float            # equalized round upload time (seconds)


def make_schedule(links: Sequence[ClientLink], data_fracs: np.ndarray,
                  v_bytes: float, cr_star: float, alpha: float,
                  cr_max: float = 1.0) -> BCRSSchedule:
    crs = schedule_crs(links, v_bytes, cr_star, cr_max)
    coef = client_coefficients(np.asarray(data_fracs, np.float64), crs, alpha)
    t_bench = max(comm_time(v_bytes, l, cr_star) for l in links)
    return BCRSSchedule(crs=crs, coefficients=coef, t_bench=t_bench)


# ------------------------------------------------------- vectorized (R rounds)
def schedule_crs_batch(bandwidths_bps: np.ndarray, latencies_s: np.ndarray,
                       v_bytes: float, cr_star: float, cr_max: float = 1.0,
                       active: np.ndarray | None = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Alg. 2 vectorized over rounds: stacked [R, C] link arrays -> CRs.

    Per-round drivers used to call ``make_schedule`` once per round inside
    the training loop; the scanned mesh driver precomputes every round's
    schedule as xs arrays, so the whole R-round CR plan is one numpy
    broadcast here. ``active`` masks padded cohort slots out of the
    benchmark-time max (their crs are still filled elementwise; callers gate
    them with the same mask). Elementwise arithmetic and reduction order
    match the scalar ``schedule_crs`` exactly, so a row of this equals
    ``schedule_crs`` over that round's selected links bit-for-bit.

    Returns (crs [R, C], t_bench [R]).
    """
    bw = np.asarray(bandwidths_bps, np.float64)
    lat = np.asarray(latencies_s, np.float64)
    v_bits = 8.0 * v_bytes
    times = lat + 2.0 * v_bits * cr_star / bw
    if active is not None:
        times = np.where(active, times, -np.inf)
    t_bench = times.max(axis=-1, keepdims=True)
    crs = (t_bench - lat) * bw / (2.0 * v_bits)
    return np.clip(crs, cr_star, cr_max), t_bench[..., 0]


def make_schedule_batch(bandwidths_bps: np.ndarray, latencies_s: np.ndarray,
                        data_fracs: np.ndarray, v_bytes: float,
                        cr_star: float, alpha: float, cr_max: float = 1.0,
                        active: np.ndarray | None = None,
                        norm: Callable[[np.ndarray], np.ndarray] = norm_sum
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized ``make_schedule`` over R rounds of (possibly padded)
    cohorts. All inputs [R, C]; ``active`` marks real cohort slots (padded
    slots must carry harmless bw/lat placeholders — their crs/coefficients
    come back as 0). Row r is bit-exact with
    ``make_schedule(links_r, fracs_r, ...)`` over that round's active prefix
    (the Eq. 6 normalization runs on exactly the active slice).

    Returns (crs [R, C], coefficients [R, C], t_bench [R]).
    """
    fr = np.asarray(data_fracs, np.float64)
    crs, t_bench = schedule_crs_batch(bandwidths_bps, latencies_s, v_bytes,
                                      cr_star, cr_max, active=active)
    coeffs = np.zeros_like(crs)
    for r in range(crs.shape[0]):
        sel = (slice(None) if active is None
               else np.flatnonzero(active[r]))
        coeffs[r, sel] = client_coefficients(fr[r, sel], crs[r, sel],
                                             alpha, norm)
    if active is not None:
        crs = np.where(active, crs, 0.0)
    return crs, coeffs, t_bench


def pod_link_schedule(dcn_bandwidths_gbps: Sequence[float], v_bytes: float,
                      cr_star: float, latency_s: float = 1e-3,
                      cr_max: float = 0.5) -> np.ndarray:
    """Hierarchical (beyond-paper) variant: per-pod DCN links get CRs from the
    same Alg. 2 schedule — slow pods compress harder, fast pods send more."""
    links = [ClientLink(b * 1e9 * 8, latency_s) for b in dcn_bandwidths_gbps]
    return schedule_crs(links, v_bytes, cr_star, cr_max)
