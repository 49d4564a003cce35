"""Event-driven arrival process for the async buffered-aggregation engine
(torch port of ``repro.ft.arrivals``; pure numpy, no tensors).

Each dispatched upload resolves through the retry-aware cost model
(``core.cost_model.upload_time_with_retries``): it can fail mid-transfer
(resume-from-offset retry after exponential backoff), run out of attempts,
or hit its wall-clock deadline — all decided by a counter-based failure
draw keyed on ``(seed, tag, dispatch_counter)``, so the entire event stream
is a pure function of the seed and the dispatch order. The tags and the
draws are the reference's, so the same seed gives the same stream bit for
bit. That also makes it checkpointable: persisting the in-flight records
plus the dispatch counter reproduces the exact same future, which the
crash-safe async engine relies on for bit-exact restarts.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.bcrs import ClientLink
from repro_torch.core.cost_model import (RetryPolicy, UploadOutcome,
                                         upload_time_with_retries)

# rng-stream tags for counter-based draws; pinned — changing them changes
# every seeded async trajectory
FAILURE_TAG = 7_919     # per-dispatch failure/fraction draws
BATCH_TAG = 15_73       # per-dispatch local-batch index draws (engine side)


@dataclass(frozen=True)
class UploadEvent:
    """One in-flight upload, fully resolved at dispatch time. ``uid`` is the
    dispatch counter value — the key for both rng streams and the engine's
    in-flight update store."""
    uid: int
    client: int
    version: int              # server version the client trained against
    t_dispatch: float
    t_resolve: float          # absolute time the upload lands or dies
    arrived: bool
    attempts: int
    progress: float
    timed_out: bool


def failure_fracs(seed: int, uid: int, p_fail: float,
                  max_attempts: int) -> List[float]:
    """Counter-based failure draw for one dispatch: per attempt, one uniform
    decides failure (``u < p_fail``) and a second gives the fraction of the
    remaining payload delivered before the cut. Stops at the first clean
    attempt. Deterministic in ``(seed, uid)`` alone."""
    rng = np.random.default_rng((seed, FAILURE_TAG, uid))
    fracs: List[float] = []
    for _ in range(max_attempts):
        u, frac = rng.random(), rng.random()
        if u >= p_fail:
            break
        fracs.append(frac)
    return fracs


@dataclass
class ArrivalProcess:
    """Priority queue of in-flight uploads with deterministic resolution.

    ``dispatch`` draws the upload's whole timeline immediately (failures,
    retries, timeout) and pushes it on the heap; ``pop`` returns events in
    virtual-time order. State is (pending events, dispatch counter) — both
    round-trip through ``state()`` / ``load_state()`` as plain arrays for
    the checkpointer."""
    seed: int
    p_fail: float = 0.0
    retry: RetryPolicy = field(default_factory=RetryPolicy)
    _heap: List[Tuple[float, int, UploadEvent]] = field(default_factory=list)
    counter: int = 0

    def dispatch(self, client: int, version: int, now: float,
                 link: ClientLink, v_bytes: float, cr: float) -> UploadEvent:
        uid = self.counter
        self.counter += 1
        fracs = failure_fracs(self.seed, uid, self.p_fail,
                              self.retry.max_attempts)
        out: UploadOutcome = upload_time_with_retries(link, v_bytes, cr,
                                                      fracs, self.retry)
        ev = UploadEvent(uid=uid, client=client, version=version,
                         t_dispatch=now, t_resolve=now + out.t_resolve,
                         arrived=out.arrived, attempts=out.attempts,
                         progress=out.progress, timed_out=out.timed_out)
        heapq.heappush(self._heap, (ev.t_resolve, uid, ev))
        return ev

    def peek_time(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None

    def pop(self) -> UploadEvent:
        return heapq.heappop(self._heap)[2]

    def __len__(self) -> int:
        return len(self._heap)

    def in_flight(self) -> List[UploadEvent]:
        """Pending events in heap order (deterministic: keyed by (t, uid))."""
        return [ev for _, _, ev in sorted(self._heap)]

    def busy_clients(self) -> set:
        """Clients with an upload in flight — the engine's busy-set rebuild
        on restore (a client is busy from dispatch until abort or flush)."""
        return {ev.client for _, _, ev in self._heap}

    # ---------------------------------------------------------- checkpointing
    def state(self) -> Dict[str, np.ndarray]:
        """Arrays of the pending events (sorted by (t_resolve, uid)) plus the
        dispatch counter — everything needed to reproduce the future."""
        evs = self.in_flight()
        return {
            "uid": np.array([e.uid for e in evs], np.int64),
            "client": np.array([e.client for e in evs], np.int64),
            "version": np.array([e.version for e in evs], np.int64),
            "t_dispatch": np.array([e.t_dispatch for e in evs], np.float64),
            "t_resolve": np.array([e.t_resolve for e in evs], np.float64),
            "arrived": np.array([e.arrived for e in evs], bool),
            "attempts": np.array([e.attempts for e in evs], np.int64),
            "progress": np.array([e.progress for e in evs], np.float64),
            "timed_out": np.array([e.timed_out for e in evs], bool),
            "counter": np.array([self.counter], np.int64),
        }

    def load_state(self, s: Dict[str, np.ndarray]) -> None:
        self.counter = int(np.asarray(s["counter"])[0])
        self._heap = []
        for i in range(len(np.asarray(s["uid"]))):
            ev = UploadEvent(
                uid=int(s["uid"][i]), client=int(s["client"][i]),
                version=int(s["version"][i]),
                t_dispatch=float(s["t_dispatch"][i]),
                t_resolve=float(s["t_resolve"][i]),
                arrived=bool(s["arrived"][i]),
                attempts=int(s["attempts"][i]),
                progress=float(s["progress"][i]),
                timed_out=bool(s["timed_out"][i]))
            heapq.heappush(self._heap, (ev.t_resolve, ev.uid, ev))
