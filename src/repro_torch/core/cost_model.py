"""Round-time accounting for the simulated FL network (paper §5.2).

Clients get normally-distributed bandwidth (mean 1 Mbit/s, sd 0.2) and
uniform latency in [50ms, 200ms]. Three accumulated metrics match the paper:
Actual / Max (straggler) / Min communication time per round.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.bcrs import ClientLink, comm_time


@dataclass(frozen=True)
class LinkArrays:
    """Column-major link table: the population-scale twin of a
    ``List[ClientLink]``. Keeps bandwidth/latency as float64 arrays so
    cohort planning indexes O(C) numpy slices (``bandwidth_bps[ids]``)
    instead of touching P Python objects, while ``links[i]`` still yields a
    ``ClientLink`` for the per-client accounting paths."""
    bandwidth_bps: np.ndarray
    latency_s: np.ndarray

    def __len__(self) -> int:
        return self.bandwidth_bps.shape[0]

    def __getitem__(self, i) -> ClientLink:
        return ClientLink(bandwidth_bps=float(self.bandwidth_bps[i]),
                          latency_s=float(self.latency_s[i]))

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def take(self, ids) -> "LinkArrays":
        return LinkArrays(self.bandwidth_bps[ids], self.latency_s[ids])


def sample_link_arrays(n: int, rng: np.random.Generator,
                       bw_mean_mbps: float = 1.0, bw_sd_mbps: float = 0.2,
                       lat_lo: float = 0.05, lat_hi: float = 0.2
                       ) -> LinkArrays:
    """Array-form ``sample_links``: identical rng draws, identical values
    (``sample_links(n, rng)[i] == sample_link_arrays(n, rng)[i]`` for equal
    generator states), but O(1) Python objects for P up to 10^6."""
    bw = np.maximum(rng.normal(bw_mean_mbps, bw_sd_mbps, n), 0.05) * 1e6
    lat = rng.uniform(lat_lo, lat_hi, n)
    return LinkArrays(bandwidth_bps=bw, latency_s=lat)


def sample_links(n: int, rng: np.random.Generator,
                 bw_mean_mbps: float = 1.0, bw_sd_mbps: float = 0.2,
                 lat_lo: float = 0.05, lat_hi: float = 0.2) -> List[ClientLink]:
    la = sample_link_arrays(n, rng, bw_mean_mbps, bw_sd_mbps, lat_lo, lat_hi)
    return list(la)


@dataclass
class RoundTime:
    actual: float       # equalized/actual upload duration this round
    max: float          # straggler (slowest client) duration
    min: float          # fastest client duration


@dataclass
class TimeAccumulator:
    actual: float = 0.0
    max: float = 0.0
    min: float = 0.0
    per_round: List[RoundTime] = field(default_factory=list)

    def add(self, rt: RoundTime) -> None:
        self.actual += rt.actual
        self.max += rt.max
        self.min += rt.min
        self.per_round.append(rt)


def round_times(links: Sequence[ClientLink], v_bytes: float,
                crs: Sequence[float]) -> RoundTime:
    """Per-round times given each client's CR (uniform CR -> pass a constant
    list; BCRS -> the scheduled list, whose times are ~equal by design)."""
    ts = [comm_time(v_bytes, l, c) for l, c in zip(links, crs)]
    return RoundTime(actual=float(np.max(ts)), max=float(np.max(ts)),
                     min=float(np.min(ts)))


def uncompressed_round(links: Sequence[ClientLink], v_bytes: float) -> RoundTime:
    # dense transmission: no index overhead -> T = L + V/B
    ts = [l.latency_s + 8.0 * v_bytes / l.bandwidth_bps for l in links]
    return RoundTime(actual=float(np.max(ts)), max=float(np.max(ts)),
                     min=float(np.min(ts)))


# ------------------------------------------------------ fault-tolerant uploads
@dataclass(frozen=True)
class RetryPolicy:
    """Retry discipline for a single client upload in the async engine.

    An attempt that fails mid-transfer is resumed from its byte offset after
    an exponential backoff (``backoff_s * backoff_factor**(attempt-1)``), so
    the payload crosses the wire exactly once no matter how many attempts it
    takes — only the per-attempt latency and the backoff sleeps are re-paid.
    ``timeout_s`` is a hard wall-clock deadline measured from dispatch;
    ``max_attempts`` caps the retries. Either bound aborts the upload."""
    max_attempts: int = 3
    backoff_s: float = 0.5
    backoff_factor: float = 2.0
    timeout_s: float = float("inf")


def upload_time_with_retries(link: ClientLink, v_bytes: float, cr: float,
                             fail_fracs: Sequence[float],
                             policy: RetryPolicy) -> "UploadOutcome":
    """Resolve one upload's full timeline given its failure draw.

    ``fail_fracs[j]`` is the fraction of the *remaining* payload transferred
    before attempt ``j+1`` failed; attempts beyond ``len(fail_fracs)`` run
    clean. With resume-from-offset the transfer term ``2*V_bits*cr/B`` is
    paid once total, split across attempts; latency is paid per attempt and
    backoff between attempts. The outcome is clipped against
    ``policy.timeout_s`` (timed out mid-flight) and ``policy.max_attempts``
    (aborted after the last failure's backoff is NOT waited out)."""
    v_bits = 8.0 * v_bytes
    transfer_s = 2.0 * v_bits * cr / link.bandwidth_bps
    t = 0.0
    progress = 0.0            # fraction of the payload already delivered
    for attempt in range(1, policy.max_attempts + 1):
        remaining_s = (1.0 - progress) * transfer_s
        if attempt <= len(fail_fracs):
            frac = float(fail_fracs[attempt - 1])
            t_fail = t + link.latency_s + frac * remaining_s
            progress += frac * (1.0 - progress)
            if t_fail >= policy.timeout_s:
                return UploadOutcome(arrived=False, t_resolve=policy.timeout_s,
                                     attempts=attempt, progress=progress,
                                     timed_out=True)
            if attempt == policy.max_attempts:
                return UploadOutcome(arrived=False, t_resolve=t_fail,
                                     attempts=attempt, progress=progress,
                                     timed_out=False)
            t = t_fail + policy.backoff_s * policy.backoff_factor ** (attempt - 1)
            if t >= policy.timeout_s:
                return UploadOutcome(arrived=False, t_resolve=policy.timeout_s,
                                     attempts=attempt, progress=progress,
                                     timed_out=True)
        else:
            t_done = t + link.latency_s + remaining_s
            if t_done > policy.timeout_s:
                return UploadOutcome(arrived=False, t_resolve=policy.timeout_s,
                                     attempts=attempt, progress=progress,
                                     timed_out=True)
            return UploadOutcome(arrived=True, t_resolve=t_done,
                                 attempts=attempt, progress=1.0,
                                 timed_out=False)
    # unreachable: the loop always returns by attempt == max_attempts
    raise AssertionError("retry loop fell through")  # pragma: no cover


@dataclass(frozen=True)
class UploadOutcome:
    """Resolved timeline of one upload: did it land, when, after how many
    attempts, and how much of the payload made it across the wire."""
    arrived: bool
    t_resolve: float          # seconds after dispatch
    attempts: int
    progress: float           # delivered payload fraction in [0, 1]
    timed_out: bool
