"""FedBuff-style asynchronous buffered-aggregation engine
(``run_fl(engine="async")``; torch port of ``repro.fed.async_engine``).

Clients train against whatever server version is current when they are
dispatched; their updates stream back through a fault-tolerant arrival
process (``ft.arrivals``: mid-transfer failures, resume-from-offset retries,
exponential backoff, per-upload deadlines) into a K-slot buffer. When the
buffer fills — or stalls past a deadline and flushes partially — the server
merges it through ``engine.aggregate_updates`` (on the card the two kernels
``threshold_find`` + ``fused_merge`` under a global Top-K strategy), with
staleness-discounted coefficients ``w_i / (1 + s_i)^alpha``.

Batched dispatch: dispatches are recorded as PENDING and trained lazily in
*waves* — one batched local-SGD call for every buffer member at flush time
(plus forced retirements at version-ring evictions and checkpoint saves).
Each member trains against the server version it was dispatched at,
gathered from a device ring of retained versions. The masked trainer's
padded rows are exact no-ops, so a wave is bit-equal to per-upload
dispatch (``async_batch_dispatch=False``, waves of one) as long as a
member's arithmetic does not depend on the wave's width. On the card
batched matmuls and reductions pick their kernels by the batch count, so
every wave trains at one static width, ``wave_bucket(max(K, M))``
(``wave_width``); the reference's power-of-two buckets are kept as
telemetry (``wave_sizes``, ``wave_buckets_used``). A real model's wave
(``fl_train --engine async``, ``make_model_wave_train_step``) trains its
members one at a time, so no member's bits depend on the wave.

Per-client EF residuals live in a dense ``[P + 1, n]`` host array
(``async_dense_store``; sentinel row P, the pop_scan convention) or, by
default, in the sparse out-of-core ``population.ClientStateStore`` in the
strategy's ``residual_layout``, gathered and scattered only for the flushed
members and densified / sparsified on the device.

Crash safety: params, the residual store, buffer contents, in-flight
uploads (their updates and retry timelines) and the dispatch counters are
checkpointed through the port's checkpointer at flush boundaries (pending
dispatches are trained first, so the layout does not depend on the
dispatch mode; the sparse store snapshots chunk by chunk beside the main
file). All randomness is counter-based
(``np.random.default_rng((seed, tag, counter))``), so restoring the
counters reproduces the exact future: a restarted run is bit-identical to
an uninterrupted one.

Degenerate configuration = synchronous parity anchor: with arrivals forced
synchronous (``async_sync_arrivals``), buffer = cohort and zero staleness,
the engine replays the scan engines' host plans through the same train and
merge ops at the scan's slot shapes and reproduces ``scan`` (``pop_scan``
for per-client-EF strategies) bit for bit.
"""
from __future__ import annotations

import collections
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import checkpointer as ckpt_mod
from repro_torch.core import bcrs as bcrs_mod
from repro_torch.core import cost_model
from repro_torch.device import synchronize
from repro_torch.fed import engine as engine_mod
from repro_torch.fed import population as pop_mod
from repro_torch.ft.arrivals import BATCH_TAG, ArrivalProcess
from repro_torch.ft.straggler import renormalize_coefficients

#: ("async_train" | "async_merge", strategy) -> programs built (the
#: reference's trace counters: one merge a run, one train program a run)
BUILD_COUNTS: collections.Counter = collections.Counter()

#: rng-stream tag for free-client selection draws (pinned; keyed on the
#: dispatch counter, so selection needs no extra checkpoint state)
SELECT_TAG = 27_449


def wave_bucket(w: int) -> int:
    """Pad-to-bucket width for a wave of ``w`` members: the next power of
    two, so wave shapes come from a set of ``log2(max(K, M)) + 1``."""
    return 1 << max(0, int(w - 1).bit_length())


def min_version_ring(concurrency: int, buffer_k: int) -> int:
    """Config-time floor on the version-ring depth: 1 when every in-flight
    upload can land in the very next flush (``M <= K``), else 2 (by
    pigeonhole, uploads of the previous version are still in flight after
    any flush). Deeper staleness is handled at run time by forced
    retirement."""
    return 1 if concurrency <= buffer_k else 2


# ----------------------------------------------------------------- programs
class AsyncTrainStep:
    """Local training for C slots from one flat model: ``step(flat, x) ->
    [C, n]`` stacked flat client deltas. The round body's first half (the
    same trainer on the same shapes), used by the sync-arrivals parity
    anchor; the event loop trains through ``WaveTrainStep``."""

    def __init__(self, fn: Callable, strategy: str):
        self._fn = fn
        self.strategy = strategy

    def __call__(self, flat, x):
        return self._fn(flat, x)


def make_async_train_step(loss_fn: Callable, params_template, *, lr: float,
                          make_batches: Callable,
                          strategy: str = "") -> AsyncTrainStep:
    unflatten = engine_mod.make_unflatten(params_template)
    local_train = engine_mod.make_masked_local_trainer(loss_fn, lr)
    BUILD_COUNTS[("async_train", strategy)] += 1

    def train(flat, x):
        deltas, _losses = local_train(unflatten(flat), make_batches(x),
                                      x["step_mask"])
        return engine_mod.flatten_client_trees(deltas)

    return AsyncTrainStep(train, strategy)


class WaveTrainStep:
    """Wave training: a ring of retained versions [V, n] + a padded wave
    plan -> stacked flat deltas [Wb, n]. Each member starts from ITS
    dispatch-time version, gathered by ring slot (``x["ver_idx"]``), so one
    call replaces Wb per-upload dispatches while every member trains
    against the params it would have seen eagerly."""

    def __init__(self, fn: Callable, strategy: str):
        self._fn = fn
        self.strategy = strategy

    def __call__(self, ring, x):
        return self._fn(ring, x)


def make_wave_train_step(loss_fn: Callable, params_template, *, lr: float,
                         make_batches: Callable,
                         strategy: str = "") -> WaveTrainStep:
    unflatten = engine_mod.make_unflatten(params_template)
    local_train = engine_mod.make_masked_local_trainer(loss_fn, lr)
    BUILD_COUNTS[("async_train", strategy)] += 1

    def train(ring, x):
        flat_w = ring.index_select(0, x["ver_idx"])       # [Wb, n], a copy
        deltas, _losses = local_train(unflatten(flat_w),
                                      make_batches(x), x["step_mask"],
                                      stacked=True)
        return engine_mod.flatten_client_trees(deltas)

    return WaveTrainStep(train, strategy)


def make_model_wave_train_step(loss_fn: Callable, params_template, *,
                               lr: float, make_batches: Callable,
                               strategy: str = "") -> WaveTrainStep:
    """Wave training for a real model (``fl_train --engine async``): a
    ring of retained flat versions [V, n] + a padded wave plan -> a list of
    the real members' flat f32 deltas [n], in wave order (the first
    ``x["members"]`` rows of the plan; the padding is not trained).

    Members train one at a time through ``make_model_local_trainer``
    (``Model.loss_fn`` takes one client's batch), each from its own ring
    row unflattened to the params' own dtypes, so a member's delta depends
    on its own version, batches and mask alone: the reference's vmapped
    wave gives each member the same delta whatever the wave holds."""
    unflatten = engine_mod.make_unflatten(params_template)
    local_train = engine_mod.make_model_local_trainer(loss_fn, lr)
    BUILD_COUNTS[("async_train", strategy)] += 1

    def train(ring, x):
        batches = make_batches(x)
        out = []
        for j in range(x["members"]):
            params = unflatten(ring[int(x["ver_idx"][j])])
            deltas, _losses = local_train(
                params, {k: b[j:j + 1] for k, b in batches.items()},
                x["step_mask"][j:j + 1])
            del params
            out.append(engine_mod.flatten_client_trees(deltas)[0])
        return out

    return WaveTrainStep(train, strategy)


class AsyncMergeStep:
    """The buffer merge: K buffered flat updates + staleness-discounted
    weights + per-slot EF residuals -> the server update (``flat`` updated
    in place) + new residuals. ``layout`` names the residual format at its
    boundary: "rows" (dense [K, n]), "topk_complement" (``(idx, val)`` pairs
    densified on entry and sparsified on exit, the population store's
    format) or None (no EF)."""

    def __init__(self, fn: Callable, spec, layout: Optional[str],
                 width: int):
        self._fn = fn
        self.spec = spec
        self.layout = layout
        self.width = width

    def __call__(self, flat, residuals, x):
        return self._fn(flat, residuals, x)


def make_async_merge_step(acfg, *, eta: float = 1.0,
                          residual_layout: str = "rows", width: int = 0,
                          device="cuda") -> AsyncMergeStep:
    spec = engine_mod.spec_for(acfg, device)
    ef = spec.needs_residuals
    layout = residual_layout if ef else None
    if layout == "topk_complement" and width <= 0:
        raise ValueError(
            f"{spec.strategy} persists residuals as topk_complement pairs — "
            "make_async_merge_step needs width > 0 (n - k_min)")
    BUILD_COUNTS[("async_merge", spec.strategy)] += 1

    def merge(flat, residuals, x):
        if layout == "topk_complement":
            res_rows = engine_mod.densify_rows(*residuals, flat.shape[0])
        else:
            res_rows = residuals if ef else None
        agg, new_rows = engine_mod.aggregate_updates(
            spec, x["updates"], x["weights"], x["ks"],
            residuals=res_rows, active=x["active"])
        flat.sub_(eta * agg)          # in place, as the round body does
        out = {"flat": flat, "residuals": new_rows if ef else residuals,
               "overflow": torch.zeros((), dtype=torch.bool,
                                       device=flat.device)}
        if layout == "topk_complement":
            idx, val, out["overflow"] = engine_mod.sparsify_rows(new_rows,
                                                                 width)
            out["residuals"] = (idx, val)
        return out

    return AsyncMergeStep(merge, spec, layout, width)


# -------------------------------------------------------- flush weighting
def flush_weights(member_ids, member_staleness, pending_ids,
                  pending_staleness, *, buffer_k: int, alpha: float,
                  coeff_table: Optional[np.ndarray] = None,
                  fracs_all: Optional[np.ndarray] = None) -> np.ndarray:
    """Final merge coefficients for the ``m`` filled buffer slots.

    Every slot gets the staleness-discounted coefficient of its (actual or
    expected) occupant: filled slots their buffered client, unfilled slots
    the next in-flight uploads the buffer was waiting for when it stalled.
    ``renormalize_coefficients`` then folds the missing slots' mass onto
    the arrived ones, so a partial flush takes the step magnitude the full
    buffer would have; a full flush passes the discounted coefficients
    through. ``coeff_table`` (whole-population Eq. 6 coefficients) serves
    bcrs-weighted strategies; otherwise data fractions are normalized over
    the slots' occupants."""
    ids = np.concatenate([np.asarray(member_ids, np.int64),
                          np.asarray(pending_ids, np.int64)])[:buffer_k]
    stal = np.concatenate([np.asarray(member_staleness, np.float64),
                           np.asarray(pending_staleness, np.float64)
                           ])[:buffer_k]
    if coeff_table is not None:
        base = np.asarray(coeff_table, np.float64)[ids]
    else:
        fr = np.asarray(fracs_all, np.float64)[ids]
        base = fr / fr.sum()
    disc = bcrs_mod.staleness_discount(base, stal, alpha)
    coeffs_k = np.zeros((buffer_k,), np.float64)
    coeffs_k[: len(ids)] = disc
    arrived = np.zeros((buffer_k,), bool)
    m = len(np.asarray(member_ids))
    arrived[:m] = True
    return renormalize_coefficients(coeffs_k, arrived)[:m]


# ------------------------------------------------------- event-driven loop
class BufferedAsyncLoop:
    """The FedBuff event loop, generic over the model: drivers supply
    ``batch_plan(client, uid) -> {name: np row}`` (one client's local-batch
    plan, no leading axis; its randomness keyed on ``(seed, BATCH_TAG,
    uid)`` so restarts replay it), a ``wave_train`` program consuming
    stacked plan rows, and ``on_flush(flush_idx, flat, rt)``. The loop owns
    dispatch, the arrival process, the buffer, staleness weighting, the EF
    residual store and checkpointing.

    Virtual time: ``dispatch`` resolves each upload's retry timeline at
    once; events pop in time order; a flush happens when the buffer fills
    or — with a stall deadline — when the deadline passes with the buffer
    partly full. In-flight concurrency is topped up to M after every event;
    a client is busy from dispatch until its upload aborts or its buffered
    update is flushed, so no client has two updates in the pipeline.

    Training is lazy by default (``batch_dispatch``): pending members train
    in one wave when the buffer flushes, when their version is about to
    leave the ring (forced retirement) or when a checkpoint saves;
    ``batch_dispatch=False`` trains each dispatch as a wave of one. Every
    wave is padded to ``wave_width = wave_bucket(max(K, M))`` (see the
    module docstring).

    ``flat0`` (``run``) is updated in place at every flush; the version
    ring, the updates and the merge live on its device. ``residual_store``:
    None -> dense ``[P + 1, n]`` host array for EF strategies; a
    ``population.ClientStateStore`` -> rows in its layout, which must match
    ``merge.layout``."""

    def __init__(self, *, n_clients: int, n_params: int, buffer_k: int,
                 concurrency: int, target_flushes: int, seed: int,
                 alpha: float, stall_s: float,
                 p_fail: float, retry: cost_model.RetryPolicy,
                 links, v_bytes: float, cr_eff_all: np.ndarray,
                 ks_all: np.ndarray, coeff_table: Optional[np.ndarray],
                 fracs_all: np.ndarray, merge: AsyncMergeStep,
                 wave_train: WaveTrainStep,
                 batch_plan: Callable[[int, int], Dict[str, np.ndarray]],
                 on_flush: Callable, batch_dispatch: bool = True,
                 version_ring: int = 8,
                 residual_store=None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 0,
                 extra_state: Optional[Callable[[], dict]] = None,
                 load_extra: Optional[Callable[[dict], None]] = None):
        if buffer_k > n_clients:
            raise ValueError(f"async buffer K={buffer_k} exceeds the "
                             f"client population {n_clients}")
        need = min_version_ring(concurrency, buffer_k)
        if version_ring < need:
            raise ValueError(
                f"async version ring depth {version_ring} is below the "
                f"observable staleness bound {need} for M={concurrency} "
                f"in-flight over a K={buffer_k} buffer")
        self.n, self.n_params = n_clients, n_params
        self.k, self.m_conc = buffer_k, concurrency
        self.target = target_flushes
        self.seed, self.alpha, self.stall_s = seed, alpha, stall_s
        self.links, self.v_bytes = links, v_bytes
        self.cr_eff_all = np.asarray(cr_eff_all, np.float64)
        self.ks_all = np.asarray(ks_all, np.int32)
        self.coeff_table = coeff_table
        self.fracs_all = np.asarray(fracs_all, np.float64)
        self.merge = merge
        self.ef = merge.spec.needs_residuals
        self.wave_train, self.batch_plan = wave_train, batch_plan
        self.batch_dispatch = batch_dispatch
        self.wave_width = wave_bucket(max(buffer_k, concurrency))
        self.on_flush = on_flush
        self.ckpt_dir, self.ckpt_every = checkpoint_dir, checkpoint_every
        self.extra_state = extra_state or (lambda: {})
        self.load_extra = load_extra or (lambda d: None)

        if self.ef and residual_store is None:
            residual_store = np.zeros((n_clients + 1, n_params), np.float32)
        self.store = residual_store if self.ef else None
        self.dense_store = isinstance(self.store, np.ndarray)
        if self.ef and not self.dense_store:
            # store layout "dense" crosses the merge boundary as "rows"
            want = ("topk_complement"
                    if self.store.layout == "topk_complement" else "rows")
            if merge.layout != want:
                raise ValueError(
                    f"merge program speaks residual layout {merge.layout!r} "
                    f"but the client store persists {self.store.layout!r}")
        elif self.ef and merge.layout != "rows":
            raise ValueError(
                f"merge program speaks residual layout {merge.layout!r} but "
                "the dense [P + 1, n] store only carries \"rows\" — pass a "
                "population.ClientStateStore as residual_store")

        self.proc = ArrivalProcess(seed=seed, p_fail=p_fail, retry=retry)
        self.flat: Optional[torch.Tensor] = None
        self.device: Optional[torch.device] = None
        self.buffer: List[dict] = []
        #: uid -> (client, version): dispatched but not yet trained
        self.pending: "collections.OrderedDict[int, tuple]" = \
            collections.OrderedDict()
        #: uid -> [n] tensor on the device: trained updates awaiting flush
        #: (or abort)
        self.inflight_updates: Dict[int, torch.Tensor] = {}
        #: clients with an update in the pipeline (O(M + K) entries)
        self.busy: set = set()
        self.version = 0
        self.flushes = 0
        self.now = 0.0
        self.t_prev_flush = 0.0
        self.stall_t = float("inf")
        # ---- version retention ring, on the device at ``run`` -----------
        self.ring_depth = version_ring
        self.ring: Optional[torch.Tensor] = None
        self.ring_ver = np.full((version_ring,), -1, np.int64)
        # ---- telemetry ----------------------------------------------------
        self.train_calls = 0          # calls of the train program
        self.train_rows = 0           # client updates computed
        self.wave_sizes: List[int] = []
        self.wave_buckets_used: set = set()
        self.forced_retires = 0       # waves forced by ring eviction
        self.aborted_untrained = 0    # aborted uploads never trained (lazy)
        self.peak_round_state_bytes = 0

    # ------------------------------------------------------------ dispatch
    def _dispatch(self, client: int) -> None:
        ev = self.proc.dispatch(client, self.version, self.now,
                                self.links[client], self.v_bytes,
                                float(self.cr_eff_all[client]))
        self.pending[ev.uid] = (client, self.version)
        self.busy.add(client)
        if not self.batch_dispatch:
            self._materialize([ev.uid])

    def _top_up(self) -> None:
        while len(self.proc) < self.m_conc:
            if len(self.busy) >= self.n:
                return
            # rejection-sample the busy set (|busy| <= M + K << P), keyed on
            # the dispatch counter so the draws replay exactly on restore
            rng = np.random.default_rng(
                (self.seed, SELECT_TAG, self.proc.counter))
            while True:
                client = int(rng.integers(self.n))
                if client not in self.busy:
                    break
            self._dispatch(client)

    # ------------------------------------------------- wave materialization
    def _materialize(self, uids) -> None:
        """Train the pending entries in ``uids`` as ONE padded wave (uid
        order: each member's batches key on its own uid and its params come
        from its own version's ring slot)."""
        uids = sorted(u for u in uids if u in self.pending)
        if not uids:
            return
        members = [(u, *self.pending.pop(u)) for u in uids]
        w = len(members)
        width = self.wave_width
        plans = [self.batch_plan(c, u) for u, c, _v in members]
        x: Dict[str, torch.Tensor] = {}
        for key, row0 in plans[0].items():
            row0 = np.asarray(row0)
            buf = np.zeros((width,) + row0.shape, row0.dtype)
            for j, p in enumerate(plans):
                buf[j] = p[key]
            x[key] = torch.as_tensor(buf, device=self.device)
        ver_idx = np.zeros((width,), np.int64)
        for j, (_u, _c, v) in enumerate(members):
            slot = v % self.ring_depth
            if self.ring_ver[slot] != v:
                raise RuntimeError(
                    f"version {v} left the retention ring before its wave "
                    "materialized (forced retirement should prevent this)")
            ver_idx[j] = slot
        x["ver_idx"] = torch.as_tensor(ver_idx, device=self.device)
        x["members"] = w             # the real rows lead, the padding follows
        out = self.wave_train(self.ring, x)
        for j, (u, _c, _v) in enumerate(members):
            # a row of a stacked wave is a view, which would keep the whole
            # padded wave resident: copy it; a list's rows are their own
            self.inflight_updates[u] = (out[j].clone()
                                        if isinstance(out, torch.Tensor)
                                        else out[j])
        self.train_calls += 1
        self.train_rows += w
        self.wave_sizes.append(w)
        self.wave_buckets_used.add(wave_bucket(w))
        self._note_state()

    def _advance_version(self) -> None:
        """Retire the new server version into the ring. If the slot being
        overwritten still holds a version some pending dispatch trained
        against, that wave trains NOW (forced retirement)."""
        self.version += 1
        slot = self.version % self.ring_depth
        evicted = int(self.ring_ver[slot])
        if evicted >= 0:
            stale = [u for u, (_c, v) in self.pending.items()
                     if v == evicted]
            if stale:
                self.forced_retires += 1
                self._materialize(stale)
        # a copy: the merge updates the live model in place
        self.ring[slot].copy_(self.flat)
        self.ring_ver[slot] = self.version

    def _note_state(self) -> None:
        """Peak round-state telemetry: ring + trained updates + store
        residency (+ the [K, n] flush staging buffer, counted at flush)."""
        b = _nbytes(self.ring)
        b += sum(_nbytes(u) for u in self.inflight_updates.values())
        if self.ef:
            b += (self.store.nbytes if self.dense_store
                  else self.store.resident_bytes())
        self.peak_round_state_bytes = max(self.peak_round_state_bytes, b)

    # --------------------------------------------------------------- flush
    def _flush(self, t_flush: float) -> None:
        m = len(self.buffer)
        self._materialize([b["uid"] for b in self.buffer])
        ids = np.array([b["client"] for b in self.buffer], np.int64)
        stal = self.version - np.array([b["version"] for b in self.buffer],
                                       np.int64)
        pend = self.proc.in_flight()[: self.k - m]
        w = flush_weights(
            ids, stal, [e.client for e in pend],
            [self.version - e.version for e in pend],
            buffer_k=self.k, alpha=self.alpha,
            coeff_table=self.coeff_table, fracs_all=self.fracs_all)
        dev = self.device
        updates = torch.zeros((self.k, self.n_params), dtype=torch.float32,
                              device=dev)
        for j, b in enumerate(self.buffer):
            updates[j] = self.inflight_updates.pop(b["uid"])
        wpad = np.zeros((self.k,), np.float32)
        kpad = np.ones((self.k,), np.int32)
        act = np.zeros((self.k,), bool)
        wpad[:m], kpad[:m], act[:m] = w, self.ks_all[ids], True
        out = self.merge(self.flat, self._gather_residuals(ids),
                         {"updates": updates,
                          "weights": torch.as_tensor(wpad, device=dev),
                          "ks": torch.as_tensor(kpad, device=dev),
                          "active": torch.as_tensor(act, device=dev)})
        if self.ef:
            if (self.merge.layout == "topk_complement"
                    and bool(out["overflow"])):
                raise RuntimeError(
                    f"flush {self.flushes}: EF residual outgrew the sparse "
                    f"width {self.merge.width} — the schedule emitted a k "
                    "below the width's k_min")
            self._scatter_residuals(ids, out["residuals"], m)
        dur = [b["t_arrive"] - b["t_dispatch"] for b in self.buffer]
        rt = cost_model.RoundTime(actual=t_flush - self.t_prev_flush,
                                  max=float(np.max(dur)),
                                  min=float(np.min(dur)))
        self.busy.difference_update(int(c) for c in ids)
        self.buffer.clear()
        self.t_prev_flush = t_flush
        self.stall_t = float("inf")
        self.peak_round_state_bytes = max(
            self.peak_round_state_bytes,
            _nbytes(self.ring) + _nbytes(updates))
        self.on_flush(self.flushes, self.flat, rt)
        self._advance_version()
        self.flushes += 1
        self._note_state()

    def _gather_residuals(self, ids: np.ndarray):
        """Buffer members' residuals, padded to the K static slots, in the
        merge's layout, on the device. Dense mode gathers by sentinel-padded
        row ids (row P is never written, so padded slots read zeros); store
        mode gathers the real members and zero-pads — the same values."""
        dev = self.device
        if not self.ef:
            return torch.zeros((0,), dtype=torch.float32, device=dev)
        if self.dense_store:
            ids_pad = np.full((self.k,), self.n, np.int64)
            ids_pad[: len(ids)] = ids
            return torch.as_tensor(self.store[ids_pad], device=dev)
        padded = pop_mod.padded_rows(self.store.gather(ids), self.k, dev)
        return (tuple(padded) if self.merge.layout == "topk_complement"
                else padded[0])

    def _scatter_residuals(self, ids: np.ndarray, res_out, m: int) -> None:
        if self.dense_store:
            self.store[ids] = res_out[:m].cpu().numpy()
        else:
            arrays = res_out if isinstance(res_out, tuple) else (res_out,)
            self.store.scatter(ids, tuple(a[:m].cpu().numpy()
                                          for a in arrays))

    # ------------------------------------------------------- checkpointing
    # Large f32 tensors ride in the checkpoint TREE; every scalar, timestamp
    # and counter rides in ``extra`` (MessagePack floats are exact float64)
    _EV_COLS = ("uid", "client", "version", "t_dispatch", "t_resolve",
                "arrived", "attempts", "progress", "timed_out")

    def _ckpt_like(self) -> dict:
        return {
            "flat": torch.zeros((self.n_params,), dtype=torch.float32,
                                device=self.device),
            "residuals": (np.zeros_like(self.store) if self.dense_store
                          else np.zeros((0,), np.float32)),
            "buf_updates": np.zeros((self.k, self.n_params), np.float32),
            "if_updates": np.zeros((self.m_conc, self.n_params),
                                   np.float32),
        }

    def _save(self) -> None:
        # train every pending dispatch first, so the in-flight update
        # tensor is complete whatever the dispatch mode
        self._materialize(list(self.pending))
        tree = self._ckpt_like()
        tree["flat"] = self.flat          # written out at once, in save
        if self.ef and self.dense_store:
            tree["residuals"] = self.store
        st = self.proc.state()
        uids = [int(u) for u in st["uid"]]
        for j, b in enumerate(self.buffer):
            tree["buf_updates"][j] = \
                self.inflight_updates[int(b["uid"])].cpu().numpy()
        for j, uid in enumerate(uids):
            tree["if_updates"][j] = self.inflight_updates[uid].cpu().numpy()
        extra = {
            "counter": self.proc.counter, "version": self.version,
            "flushes": self.flushes, "now": self.now,
            "t_prev_flush": self.t_prev_flush,
            "stall_t": None if np.isinf(self.stall_t) else self.stall_t,
            "buffer": [[int(b["client"]), int(b["version"]), int(b["uid"]),
                        float(b["t_arrive"]), float(b["t_dispatch"])]
                       for b in self.buffer],
            "inflight": {col: [c.item() for c in st[col]]
                         for col in self._EV_COLS},
        }
        if self.ef and not self.dense_store:
            extra["client_store"] = self.store.save(self.ckpt_dir,
                                                    self.flushes)
        extra.update(self.extra_state())
        ckpt_mod.save(self.ckpt_dir, self.flushes, tree, extra=extra)
        if self.ef and not self.dense_store:
            # retention just ran on the step files; drop the client-store
            # snapshots whose step it pruned
            pop_mod.prune_client_snapshots(
                self.ckpt_dir, ckpt_mod.list_steps(self.ckpt_dir))

    def _restore(self) -> bool:
        if not self.ckpt_dir or not ckpt_mod.list_steps(self.ckpt_dir):
            return False
        tree, step, extra = ckpt_mod.restore_latest_valid(
            self.ckpt_dir, self._ckpt_like())
        # into the caller's buffer: the live model keeps its identity
        self.flat.copy_(tree["flat"])
        if self.ef and self.dense_store:
            # a copy: the store is scattered into on every flush
            self.store = tree["residuals"].numpy().copy()
        elif self.ef:
            man = extra["client_store"]
            if (man["layout"], man["width"]) != (self.store.layout,
                                                 self.store.width):
                raise ValueError(
                    f"client-store snapshot persists layout "
                    f"{man['layout']!r} width {man['width']} but this run "
                    f"expects {self.store.layout!r}/{self.store.width} — "
                    "the strategy or schedule changed across the restart")
            self.store = pop_mod.ClientStateStore.restore(
                self.ckpt_dir, step, man,
                max_resident_chunks=self.store.max_resident_chunks,
                spill_dir=self.store.spill_dir)
        self.buffer = [
            {"client": c, "version": v, "uid": u, "t_arrive": ta,
             "t_dispatch": td}
            for c, v, u, ta, td in extra["buffer"]]
        inflight = extra["inflight"]
        dtypes = {"uid": np.int64, "client": np.int64, "version": np.int64,
                  "t_dispatch": np.float64, "t_resolve": np.float64,
                  "arrived": bool, "attempts": np.int64,
                  "progress": np.float64, "timed_out": bool}
        state = {col: np.asarray(inflight[col], dtypes[col])
                 for col in self._EV_COLS}
        state["counter"] = np.array([extra["counter"]], np.int64)
        self.proc.load_state(state)
        self.pending.clear()
        if_updates = tree["if_updates"].to(self.device)
        buf_updates = tree["buf_updates"].to(self.device)
        self.inflight_updates = {int(uid): if_updates[j].clone()
                                 for j, uid in enumerate(inflight["uid"])}
        for j, b in enumerate(self.buffer):
            self.inflight_updates[int(b["uid"])] = buf_updates[j].clone()
        self.version, self.flushes = extra["version"], extra["flushes"]
        self.now = extra["now"]
        self.t_prev_flush = extra["t_prev_flush"]
        self.stall_t = (float("inf") if extra["stall_t"] is None
                        else extra["stall_t"])
        self.busy = {b["client"] for b in self.buffer}
        self.busy |= self.proc.busy_clients()
        # pending is empty after a restore (the save trained it), so
        # retaining only the current version reproduces the exact future
        self.ring.zero_()
        self.ring_ver[:] = -1
        slot = self.version % self.ring_depth
        self.ring[slot].copy_(self.flat)
        self.ring_ver[slot] = self.version
        self.load_extra(extra)
        return True

    # ----------------------------------------------------------- main loop
    def run(self, flat0: torch.Tensor,
            stop_after: Optional[int] = None) -> torch.Tensor:
        """Drive the loop to ``target_flushes`` (or ``stop_after``, a crash
        at a flush boundary), updating ``flat0`` in place. Resumes from the
        newest intact checkpoint when one exists. Returns ``flat0``."""
        self.flat = flat0
        self.device = flat0.device
        self.ring = torch.zeros((self.ring_depth, self.n_params),
                                dtype=torch.float32, device=self.device)
        if not self._restore():
            self.ring[0].copy_(self.flat)
            self.ring_ver[0] = self.version
        # top-up is idempotent at full concurrency; after a restore it
        # replays the dispatches the original run made right after the
        # checkpointed flush (counter-keyed draws -> identical events)
        self._top_up()
        # no-progress guard: uploads that can NEVER arrive (e.g. a timeout
        # below every link's latency) would otherwise redispatch forever
        aborts_in_a_row, abort_limit = 0, 1000 * max(self.m_conc, 8)
        while self.flushes < self.target:
            if stop_after is not None and self.flushes >= stop_after:
                return self.flat
            t_next = self.proc.peek_time()
            if self.buffer and (t_next is None or self.stall_t < t_next):
                # stall deadline passed (or nothing else can ever arrive):
                # flush partially with renormalized coefficients
                t = self.now if t_next is None and np.isinf(self.stall_t) \
                    else self.stall_t
                self.now = max(self.now, t)
                self._flush(self.now)
                self._after_flush()
                self._top_up()
                continue
            if t_next is None:
                break        # nothing in flight, nothing buffered
            ev = self.proc.pop()
            self.now = ev.t_resolve
            if ev.arrived:
                aborts_in_a_row = 0
                self.buffer.append({
                    "client": ev.client, "version": ev.version,
                    "uid": ev.uid, "t_arrive": ev.t_resolve,
                    "t_dispatch": ev.t_dispatch})
                if len(self.buffer) == 1:
                    self.stall_t = self.now + self.stall_s
                if len(self.buffer) >= self.k:
                    self._flush(self.now)
                    self._after_flush()
            else:
                # upload aborted (retries exhausted or deadline hit): if
                # still pending it was never trained; EF is untouched
                # either way (residuals only change on merge)
                if ev.uid in self.pending:
                    self.pending.pop(ev.uid)
                    self.aborted_untrained += 1
                else:
                    self.inflight_updates.pop(ev.uid)
                self.busy.discard(ev.client)
                aborts_in_a_row += 1
                if aborts_in_a_row > abort_limit:
                    raise RuntimeError(
                        f"{abort_limit} consecutive upload aborts without "
                        "one arrival — the failure/timeout config admits "
                        "no progress (is async_upload_timeout_s below the "
                        "links' latencies?)")
            self._top_up()
        return self.flat

    def _after_flush(self) -> None:
        if (self.ckpt_dir and self.ckpt_every
                and self.flushes % self.ckpt_every == 0):
            self._save()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# ------------------------------------------------------ simulation driver
def validate_async_config(sim, n_clients: Optional[int] = None) -> None:
    """Config-time validation of the ``async_*`` knobs, before any loop
    state exists: the buffer must fit the population, and the version ring
    must clear the observable staleness bound (``min_version_ring``) for
    the effective concurrency."""
    from repro_torch.fed import simulation as sim_mod
    n = sim.n_clients if n_clients is None else n_clients
    n_sel = sim_mod.cohort_slots(n, sim.participation)
    k_buf = sim.async_buffer_k or n_sel
    if k_buf > n:
        raise ValueError(f"async buffer K={k_buf} exceeds the client "
                         f"population {n}")
    m_conc = sim.async_concurrency or max(1, min(2 * k_buf, n - k_buf))
    need = min_version_ring(m_conc, k_buf)
    if sim.async_version_ring < need:
        raise ValueError(
            f"async_version_ring={sim.async_version_ring} is below the "
            f"observable staleness bound {need} for M={m_conc} in-flight "
            f"over a K={k_buf} buffer — deepen the ring (depth 2 suffices "
            "for any M > K; forced retirement covers deeper staleness)")
    if sim.async_store_resident and not sim.async_store_spill:
        raise ValueError("async_store_resident bounds the sparse store's "
                         "resident chunks — set async_store_spill to the "
                         "directory evicted chunks spill into")


def run_async_sim(sim, acfg, rng, clients, parts, fracs_all, links, server,
                  steps_by_client, s_max, x_train, y_train, x_test, y_test,
                  failure, straggler, checkpoint_dir: Optional[str] = None,
                  checkpoint_every: int = 0,
                  stop_after: Optional[int] = None):
    """``run_fl(engine="async")`` body, on the server's device. Two modes:

    * ``sim.async_sync_arrivals``: the parity anchor — replays the shared
      host round plans (``_plan_rounds``, the sync engines' rng stream)
      through the train + merge programs with zero staleness, at the scan
      engines' slot shapes: ``scan``'s trajectory bit for bit (``pop_scan``'s
      for EF strategies, whose per-client residuals this engine shares).
    * general: the event-driven FedBuff loop; ``sim.rounds`` counts buffer
      flushes. ``failure`` / ``straggler`` are subsumed by the arrival
      process (slow links arrive late, uploads fail, retry and abort per
      ``async_p_fail_upload``). EF residuals default to the sparse
      ``ClientStateStore`` (``sim.async_dense_store`` for the dense
      ``[P + 1, n]`` reference); dispatches batch into waves unless
      ``sim.async_batch_dispatch`` is off.
    """
    from repro_torch.core import aggregation as agg_mod
    from repro_torch.fed import simulation as sim_mod

    validate_async_config(sim)
    result = sim_mod.FLSimResult()
    dev = server.device
    n, n_params, v_bytes = sim.n_clients, server.n_params, server.v_bytes
    strat, ef, bs = acfg.strat, acfg.strat.needs_residuals, sim.batch_size
    n_sel = sim_mod.cohort_slots(n, sim.participation)
    x_all = torch.as_tensor(x_train, device=dev)
    y_all = torch.as_tensor(y_train, device=dev, dtype=torch.int64)
    xt = torch.as_tensor(x_test, device=dev)
    yt = torch.as_tensor(y_test, device=dev, dtype=torch.int64)
    gather_batches = sim_mod._gather_batches(x_all, y_all)

    if sim.async_sync_arrivals:
        train = make_async_train_step(
            sim_mod.mlp_loss, server.params, lr=sim.lr,
            make_batches=gather_batches, strategy=acfg.strategy)
        merge = make_async_merge_step(acfg, eta=server.eta, device=dev)
        return _run_sync_parity(sim, acfg, rng, clients, parts, fracs_all,
                                links, server, steps_by_client, s_max,
                                failure, straggler, train, merge, xt, yt,
                                result)

    # -------------------------------------------------- general async mode
    k_buf = sim.async_buffer_k or n_sel
    m_conc = sim.async_concurrency or max(1, min(2 * k_buf, n - k_buf))
    fracs_norm = np.asarray(fracs_all, np.float64)
    fracs_norm = fracs_norm / fracs_norm.sum()
    crs_all, coeffs_all, _info = agg_mod.round_schedule(
        acfg, n, fracs_norm, links, v_bytes)
    ks_all = agg_mod.ks_for_schedule(n_params, crs_all, acfg)
    # dense wire formats return a scalar 1.0 — broadcast to per-client
    cr_eff_all = np.broadcast_to(np.asarray(
        strat.wire.cr_eff(np.asarray(crs_all, np.float64), n_params),
        np.float64), (n,))
    retry = cost_model.RetryPolicy(
        max_attempts=sim.async_max_attempts, backoff_s=sim.async_backoff_s,
        backoff_factor=sim.async_backoff_factor,
        timeout_s=sim.async_upload_timeout_s)

    store = None
    if ef and not sim.async_dense_store:
        layout = strat.residual_layout
        width = (pop_mod.residual_width(n_params, int(ks_all.min()))
                 if layout == "topk_complement" else 0)
        store = pop_mod.ClientStateStore(
            n, n_params, layout=layout, width=width,
            chunk_clients=min(sim.async_store_chunk, n),
            max_resident_chunks=sim.async_store_resident or None,
            spill_dir=sim.async_store_spill or None)
        merge = make_async_merge_step(
            acfg, eta=server.eta,
            residual_layout=("topk_complement"
                             if layout == "topk_complement" else "rows"),
            width=width, device=dev)
    else:
        merge = make_async_merge_step(acfg, eta=server.eta, device=dev)

    wave_train = make_wave_train_step(
        sim_mod.mlp_loss, server.params, lr=sim.lr,
        make_batches=gather_batches, strategy=acfg.strategy)

    def batch_plan(client: int, uid: int) -> Dict[str, np.ndarray]:
        rng_b = np.random.default_rng((sim.seed, BATCH_TAG, uid))
        steps = int(steps_by_client[client])
        local = clients[client].fixed_batch_indices(bs, steps, rng_b)
        idx = np.zeros((s_max, bs), np.int32)
        idx[:steps] = parts[client][local].reshape(steps, bs)
        smask = np.zeros((s_max,), bool)
        smask[:steps] = True
        return {"sample_idx": idx, "step_mask": smask}

    def on_flush(flush_idx: int, flat, rt: cost_model.RoundTime) -> None:
        server.times.add(rt)
        result.executed_rounds.append(flush_idx)
        if sim_mod._is_eval_round(sim, flush_idx):
            acc = sim_mod.mlp_accuracy(server._unravel(flat), xt, yt)
            result.accuracies.append((flush_idx, acc))

    def extra_state() -> dict:
        return {"accuracies": [[int(r), float(a)]
                               for r, a in result.accuracies],
                "executed_rounds": [int(r) for r in result.executed_rounds],
                "times": [[float(t.actual), float(t.max), float(t.min)]
                          for t in server.times.per_round]}

    def load_extra(extra: dict) -> None:
        result.accuracies = [(int(r), float(a))
                             for r, a in extra["accuracies"]]
        result.executed_rounds = list(extra["executed_rounds"])
        for a, mx, mn in extra["times"]:
            server.times.add(cost_model.RoundTime(a, mx, mn))

    loop = BufferedAsyncLoop(
        n_clients=n, n_params=n_params, buffer_k=k_buf, concurrency=m_conc,
        target_flushes=sim.rounds, seed=sim.seed, alpha=sim.async_alpha,
        stall_s=sim.async_stall_s, p_fail=sim.async_p_fail_upload,
        retry=retry, links=links, v_bytes=v_bytes, cr_eff_all=cr_eff_all,
        ks_all=ks_all,
        coeff_table=(coeffs_all if strat.weighting == "bcrs" else None),
        fracs_all=fracs_all, merge=merge, wave_train=wave_train,
        batch_plan=batch_plan, on_flush=on_flush,
        batch_dispatch=sim.async_batch_dispatch,
        version_ring=sim.async_version_ring,
        residual_store=store,
        checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
        extra_state=extra_state, load_extra=load_extra)
    t0 = time.perf_counter()
    loop.run(server.flat, stop_after=stop_after)
    synchronize(dev)
    wall = time.perf_counter() - t0

    result.times = server.times
    result.final_accuracy = (result.accuracies[-1][1]
                             if result.accuracies else 0.0)
    nf = max(len(result.executed_rounds), 1)
    result.wall_per_round = [wall / nf] * len(result.executed_rounds)
    if ef:
        result.final_residuals = (loop.store[:n].copy() if loop.dense_store
                                  else loop.store.dump_dense())
    result.async_loop = loop
    return result


def _run_sync_parity(sim, acfg, rng, clients, parts, fracs_all, links,
                     server, steps_by_client, s_max, failure, straggler,
                     train, merge, xt, yt, result):
    """Degenerate-async parity mode: synchronous arrivals, buffer = cohort,
    staleness 0 (the discount is the identity at s=0 for any alpha). Trains
    and merges at the ``cohort_slots`` slot shapes the scan engines use."""
    from repro_torch.fed import simulation as sim_mod
    dev = server.device
    n, n_params, bs = sim.n_clients, server.n_params, sim.batch_size
    n_sel = sim_mod.cohort_slots(n, sim.participation)
    ef = acfg.strat.needs_residuals

    plans = sim_mod._plan_rounds(sim, acfg, rng, clients, parts, fracs_all,
                                 links, server, steps_by_client, s_max,
                                 failure, straggler, False)
    if not plans:
        result.times = server.times
        return result
    store = (np.zeros((n + 1, n_params), np.float32) if ef
             else np.zeros((0,), np.float32))
    for rnd, selected, weights, ks, _ko, idx in plans:
        t0 = time.perf_counter()
        c_r = len(selected)
        x = {k: torch.as_tensor(v, device=dev) for k, v in sim_mod._slot_plan(
            n_sel, s_max, bs, selected, weights, ks, idx,
            steps_by_client).items()}
        updates = train(server.flat, x)
        ids_pad = np.full((n_sel,), n, np.int64)
        ids_pad[:c_r] = selected
        res_rows = (torch.as_tensor(store[ids_pad], device=dev) if ef
                    else torch.zeros((0,), dtype=torch.float32, device=dev))
        out = merge(server.flat, res_rows,
                    {"updates": updates, "weights": x["weights"],
                     "ks": x["ks"], "active": x["active"]})
        if ef:
            store[selected] = out["residuals"][:c_r].cpu().numpy()
        synchronize(dev)
        result.wall_per_round.append(time.perf_counter() - t0)
        result.executed_rounds.append(rnd)
        if sim_mod._is_eval_round(sim, rnd):
            result.accuracies.append(
                (rnd, sim_mod.mlp_accuracy(server.params, xt, yt)))

    result.times = server.times
    result.final_accuracy = (result.accuracies[-1][1]
                             if result.accuracies else 0.0)
    if ef:
        result.final_residuals = store[:n].copy()
    return result
