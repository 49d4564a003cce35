"""Population-scale FL: streaming cohorts over an out-of-core client store
(torch port of ``repro.fed.population``).

Splits "registered" from "participating":

  * ``Population``       — the registry: per-client data weight, bandwidth
                           profile (``cost_model.LinkArrays``) and a non-IID
                           skew seed, O(P) numpy built once; every per-round
                           read is an O(C) slice.
  * ``ClientStateStore`` — durable per-client EF state in the strategy's
                           declared ``residual_layout``: "topk_complement"
                           ``(idx32, f32)`` pairs of static width
                           ``n - k_min``, or dense rows (codec strategies).
                           Chunked; chunks spill to disk through the port's
                           checkpointer (one file per chunk, byte for byte
                           the reference store's), so populations beyond
                           host RAM stream through a bounded LRU window.
                           Host numpy, as in the reference.
  * ``run_population_rounds`` — the streaming-cohort driver: each round
                           samples a C-slot cohort from P (O(C)), gathers
                           just those clients' state into the static slots,
                           runs the ONE round program
                           (``round_step.make_population_round_step``:
                           densify on entry, sparsify on exit, on the
                           device) and scatters the updated rows back. A
                           round's cost is O(C), independent of P.

The dense reference for all of this is ``engine.make_sim_scan(...,
population=P)`` (the "pop_scan" engine): bit-equal to the store path.
"""
from __future__ import annotations

import collections
import os
import shutil
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.core import cost_model

_LAYOUTS = ("topk_complement", "dense")


# ---------------------------------------------------------------- registry
@dataclass(frozen=True)
class Population:
    """Registered client population: everything the host planner needs to
    sample and price a cohort, held as O(P) numpy columns."""
    weights: np.ndarray            # data weights, sum to 1 [P] f64
    links: cost_model.LinkArrays   # bandwidth/latency columns [P]
    skew_seeds: np.ndarray         # per-client non-IID seed [P] i64

    @property
    def n_clients(self) -> int:
        return self.weights.shape[0]


def make_population(n_clients: int, seed: int = 0, *,
                    weight_sigma: float = 0.5) -> Population:
    """Sample a population registry (the reference's draws, in its order):
    log-normal data weights, the paper's link model in array form, and
    integer skew seeds for each client's synthetic label bias."""
    rng = np.random.default_rng(seed)
    w = rng.lognormal(mean=0.0, sigma=weight_sigma, size=n_clients)
    links = cost_model.sample_link_arrays(n_clients, rng)
    skew = rng.integers(0, np.iinfo(np.int32).max, size=n_clients)
    return Population(weights=w / w.sum(), links=links,
                      skew_seeds=skew.astype(np.int64))


def sample_cohort(rng: np.random.Generator, n_clients: int,
                  cohort: int) -> np.ndarray:
    """Draw a C-slot cohort from P registered clients without replacement,
    O(C). Uniform: data weights enter the averaging coefficients, not the
    sampling distribution."""
    return rng.choice(n_clients, size=min(cohort, n_clients), replace=False)


def residual_width(n_params: int, k_min: int) -> int:
    """Static pair width of the "topk_complement" layout: a pure Top-K EF
    residual has at most ``n - k`` nonzeros, so the smallest retained count
    of the plan bounds every row; at least 1 so the arrays keep a shape."""
    return max(1, int(n_params) - int(k_min))


# ----------------------------------------------------------- chunked store
class ClientStateStore:
    """Out-of-core per-client EF residual store: P rows in the strategy's
    wire layout, ``chunk_clients`` rows a chunk, at most
    ``max_resident_chunks`` chunks in host RAM (the rest one checkpointer
    file a chunk under ``spill_dir``). Never allocates anything O(P x n):
    only touched chunks exist, and a client that never participated
    gathers implicit zeros.

    ``gather(ids)`` / ``scatter(ids, arrays)`` move the real cohort's rows
    between the store and the static slots. ``save`` / ``restore`` snapshot
    the whole store bit for bit for restarts (resident chunks written
    fresh, on-disk chunks copied file by file); a restored store treats the
    snapshot as a read-only base and later evictions write to ``spill_dir``
    only.
    """

    def __init__(self, n_clients: int, n_coords: int, *,
                 layout: str = "topk_complement", width: int = 0,
                 chunk_clients: int = 256,
                 max_resident_chunks: Optional[int] = None,
                 spill_dir: Optional[str] = None,
                 base_dir: Optional[str] = None,
                 base_chunks: Iterable[int] = ()):
        if layout not in _LAYOUTS:
            raise ValueError(f"unknown residual layout {layout!r} "
                             f"(one of {_LAYOUTS})")
        if layout == "topk_complement" and width <= 0:
            raise ValueError("topk_complement store needs width > 0 "
                             "(use population.residual_width)")
        if max_resident_chunks is not None:
            if spill_dir is None:
                raise ValueError("bounding resident chunks needs a "
                                 "spill_dir to evict into")
            if max_resident_chunks < 1:
                raise ValueError("max_resident_chunks must be >= 1")
        if spill_dir is not None and spill_dir == base_dir:
            raise ValueError("spill_dir must differ from the read-only "
                             "restore base_dir")
        self.n_clients = int(n_clients)
        self.n_coords = int(n_coords)
        self.layout = layout
        self.width = int(width) if layout == "topk_complement" else n_coords
        self.chunk_clients = int(min(chunk_clients, n_clients))
        self.max_resident_chunks = max_resident_chunks
        self.spill_dir = spill_dir
        #: chunk id -> directory holding its newest on-disk file
        self._disk: Dict[int, str] = {int(c): base_dir for c in base_chunks}
        #: chunk id -> {"arrays": {...}, "dirty": bool} in LRU order
        self._chunks: "collections.OrderedDict[int, dict]" = \
            collections.OrderedDict()
        self._resident_bytes = 0
        self.peak_resident_bytes = 0
        self.gather_seconds = 0.0
        self.scatter_seconds = 0.0
        self.chunk_loads = 0
        self.chunk_spills = 0

    # -- chunk plumbing --------------------------------------------------
    def _rows_of(self, cid: int) -> int:
        lo = cid * self.chunk_clients
        return min(self.chunk_clients, self.n_clients - lo)

    def _blank(self, cid: int) -> Dict[str, np.ndarray]:
        m = self._rows_of(cid)
        if self.layout == "topk_complement":
            return {"idx": np.zeros((m, self.width), np.int32),
                    "val": np.zeros((m, self.width), np.float32)}
        return {"val": np.zeros((m, self.n_coords), np.float32)}

    @staticmethod
    def _nbytes(arrays: Dict[str, np.ndarray]) -> int:
        return sum(a.nbytes for a in arrays.values())

    def _load(self, cid: int) -> Dict[str, np.ndarray]:
        """Make chunk ``cid`` resident (LRU-touched) and return its arrays."""
        entry = self._chunks.get(cid)
        if entry is not None:
            self._chunks.move_to_end(cid)
            return entry["arrays"]
        if cid in self._disk:
            tree, _, _ = ckpt.restore(self._disk[cid], self._blank(cid),
                                      step=cid)
            # copies: chunks are scattered into in place
            arrays = {k: v.numpy().copy() for k, v in tree.items()}
            self.chunk_loads += 1
        else:
            arrays = self._blank(cid)
        self._chunks[cid] = {"arrays": arrays, "dirty": False}
        self._resident_bytes += self._nbytes(arrays)
        self.peak_resident_bytes = max(self.peak_resident_bytes,
                                       self._resident_bytes)
        self._evict()
        return arrays

    def _evict(self) -> None:
        if self.max_resident_chunks is None:
            return
        while len(self._chunks) > self.max_resident_chunks:
            cid, entry = self._chunks.popitem(last=False)
            self._resident_bytes -= self._nbytes(entry["arrays"])
            if entry["dirty"] or cid not in self._disk:
                ckpt.save(self.spill_dir, cid, entry["arrays"], keep=None)
                self._disk[cid] = self.spill_dir
                self.chunk_spills += 1

    def _known_chunks(self) -> List[int]:
        return sorted(set(self._chunks) | set(self._disk))

    # -- cohort I/O ------------------------------------------------------
    def gather(self, ids) -> Tuple[np.ndarray, ...]:
        """Rows for the cohort ``ids`` in the store's wire layout:
        ``(idx [C, W] int32, val [C, W] f32)`` for "topk_complement",
        ``(rows [C, n] f32,)`` for "dense"."""
        t0 = time.perf_counter()
        ids = np.asarray(ids, np.int64)
        out = self._blank_rows(len(ids))
        for cid, sel in self._by_chunk(ids):
            arrays = self._load(cid)
            rows = ids[sel] - cid * self.chunk_clients
            for k, o in zip(self._keys(), out):
                o[sel] = arrays[k][rows]
        self.gather_seconds += time.perf_counter() - t0
        return out

    def scatter(self, ids, arrays: Tuple[np.ndarray, ...]) -> None:
        """Write the cohort's updated rows back (the inverse of ``gather``,
        the same layout-ordered tuple); touched chunks become dirty."""
        t0 = time.perf_counter()
        ids = np.asarray(ids, np.int64)
        arrays = tuple(np.asarray(a) for a in arrays)
        for cid, sel in self._by_chunk(ids):
            chunk = self._load(cid)
            rows = ids[sel] - cid * self.chunk_clients
            for k, a in zip(self._keys(), arrays):
                chunk[k][rows] = a[sel]
            self._chunks[cid]["dirty"] = True
        self.scatter_seconds += time.perf_counter() - t0

    def _keys(self) -> Tuple[str, ...]:
        return (("idx", "val") if self.layout == "topk_complement"
                else ("val",))

    def _blank_rows(self, c: int) -> Tuple[np.ndarray, ...]:
        if self.layout == "topk_complement":
            return (np.zeros((c, self.width), np.int32),
                    np.zeros((c, self.width), np.float32))
        return (np.zeros((c, self.n_coords), np.float32),)

    def _by_chunk(self, ids: np.ndarray):
        cids = ids // self.chunk_clients
        order = np.argsort(cids, kind="stable")
        for cid in np.unique(cids):
            yield int(cid), order[cids[order] == cid]

    # -- persistence -----------------------------------------------------
    def resident_bytes(self) -> int:
        return self._resident_bytes

    def manifest(self) -> dict:
        """Layout metadata a driver embeds in its checkpoint ``extra`` so
        ``restore`` can rebuild the store without guessing shapes."""
        return {"layout": self.layout, "width": self.width,
                "n_clients": self.n_clients, "n_coords": self.n_coords,
                "chunk_clients": self.chunk_clients,
                "chunks": self._known_chunks()}

    def save(self, ckpt_dir: str, step: int) -> dict:
        """Snapshot every touched chunk under
        ``<ckpt_dir>/clients_step_<step>/`` and return the manifest.
        Untouched chunks are implicit zeros and cost nothing."""
        snap = client_snapshot_dir(ckpt_dir, step)
        os.makedirs(snap, exist_ok=True)
        for cid in self._known_chunks():
            entry = self._chunks.get(cid)
            if entry is not None:
                ckpt.save(snap, cid, entry["arrays"], keep=None)
            else:
                shutil.copyfile(
                    os.path.join(self._disk[cid], f"step_{cid}.msgpack"),
                    os.path.join(snap, f"step_{cid}.msgpack"))
        # chunks read from an older snapshot (a restore's base) read from
        # this one from now on: retention may prune the older one, and the
        # new one holds the same bytes
        for cid, where in self._disk.items():
            if where != self.spill_dir:
                self._disk[cid] = snap
        return self.manifest()

    @classmethod
    def restore(cls, ckpt_dir: str, step: int, manifest: dict, *,
                chunk_clients: Optional[int] = None,
                max_resident_chunks: Optional[int] = None,
                spill_dir: Optional[str] = None) -> "ClientStateStore":
        """Rebuild a store from a ``save`` snapshot, lazily: no chunk is
        read until a cohort touches it. The snapshot stays read-only."""
        if chunk_clients is not None and \
                chunk_clients != manifest["chunk_clients"]:
            raise ValueError(
                f"snapshot was chunked {manifest['chunk_clients']} "
                f"clients/chunk; cannot restore at {chunk_clients}")
        return cls(manifest["n_clients"], manifest["n_coords"],
                   layout=manifest["layout"], width=manifest["width"],
                   chunk_clients=manifest["chunk_clients"],
                   max_resident_chunks=max_resident_chunks,
                   spill_dir=spill_dir,
                   base_dir=client_snapshot_dir(ckpt_dir, step),
                   base_chunks=manifest["chunks"])

    def dump_dense(self) -> np.ndarray:
        """The FULL ``[P, n]`` residual matrix — for parity checks at small
        P only."""
        rows = np.zeros((self.n_clients, self.n_coords), np.float32)
        for cid in self._known_chunks():
            arrays = self._load(cid)
            lo = cid * self.chunk_clients
            m = self._rows_of(cid)
            if self.layout == "dense":
                rows[lo:lo + m] = arrays["val"]
            else:
                np.add.at(rows[lo:lo + m],
                          (np.arange(m)[:, None], arrays["idx"]),
                          arrays["val"])
        return rows


def padded_rows(arrays: Tuple[np.ndarray, ...], slots: int,
                device) -> List[torch.Tensor]:
    """A ``gather``'s rows for the real cohort, zero-padded to ``slots``
    static slots and put on ``device`` (a padded slot holds what a client
    that never participated holds)."""
    out = []
    for a in arrays:
        buf = np.zeros((slots,) + a.shape[1:], a.dtype)
        buf[: len(a)] = a
        out.append(torch.as_tensor(buf, device=device))
    return out


def client_snapshot_dir(ckpt_dir: str, step: int) -> str:
    """Per-step client-store snapshot directory (beside the driver's
    ``step_<step>.msgpack`` file, so retention can prune both)."""
    return os.path.join(ckpt_dir, f"clients_step_{step}")


def prune_client_snapshots(ckpt_dir: str, keep_steps: Iterable[int]) -> None:
    """Drop the ``clients_step_*`` snapshot directories whose step the main
    checkpoint retention already pruned."""
    keep = set(int(s) for s in keep_steps)
    if not os.path.isdir(ckpt_dir):
        return
    for name in os.listdir(ckpt_dir):
        if name.startswith("clients_step_"):
            try:
                step = int(name[len("clients_step_"):])
            except ValueError:
                continue
            if step not in keep:
                shutil.rmtree(os.path.join(ckpt_dir, name),
                              ignore_errors=True)


# ----------------------------------------------------- streaming-cohort run
@dataclass
class PopulationRunConfig:
    """Streaming-cohort driver knobs (synthetic per-client data made on the
    fly from each client's skew seed)."""
    cohort: int = 16
    rounds: int = 6
    local_steps: int = 2
    batch_size: int = 8
    dim: int = 64
    hidden: int = 64
    n_classes: int = 10
    lr: float = 0.05
    seed: int = 0


@dataclass
class PopulationRunResult:
    losses: List[float] = field(default_factory=list)
    wall_per_round: List[float] = field(default_factory=list)
    comm_actual_s: float = 0.0
    gather_seconds: float = 0.0
    scatter_seconds: float = 0.0
    peak_state_bytes: int = 0
    final_flat: Optional[np.ndarray] = None


def _client_batches(cfg: PopulationRunConfig, means: np.ndarray,
                    skew_seed: int, rnd: int) -> Tuple[np.ndarray, np.ndarray]:
    """One client's [S, B] synthetic batches for round ``rnd``: Gaussian
    features around per-class means, labels biased to the client's skew
    classes, deterministic in (skew_seed, round)."""
    rng = np.random.default_rng((int(skew_seed), rnd))
    half = max(1, cfg.n_classes // 2)
    y = (int(skew_seed) + rng.integers(0, half,
                                       (cfg.local_steps, cfg.batch_size))) \
        % cfg.n_classes
    x = rng.standard_normal(
        (cfg.local_steps, cfg.batch_size, cfg.dim)).astype(np.float32)
    return x + means[y], y.astype(np.int32)


def run_population_rounds(pop: Population, cfg: PopulationRunConfig, *,
                          acfg=None, step=None,
                          store: Optional[ClientStateStore] = None,
                          chunk_clients: int = 32,
                          max_resident_chunks: Optional[int] = None,
                          spill_dir: Optional[str] = None,
                          device="cuda", init_params=None
                          ) -> Tuple[PopulationRunResult, object,
                                     Optional[ClientStateStore]]:
    """Run ``cfg.rounds`` streaming-cohort rounds against ``pop`` on
    ``device`` ("cuda" by default; without CUDA this raises — pass
    ``device="cpu"`` for the CPU).

    Every per-round quantity is O(C): the cohort draw, the state
    gather/scatter, the BCRS schedule over the cohort's links, the comm-time
    accounting and the synthetic batches. Pass ``step`` (a
    ``PopulationRoundStep`` from an earlier call) to reuse one round program
    across population sizes. ``init_params`` starts from given weights
    (e.g. the reference's) instead of the port's seeded ``mlp_init``.

    Returns (result, step, store) so callers can chain sweeps.
    """
    from repro_torch import convert
    from repro_torch.core import aggregation as agg_mod
    from repro_torch.core.compression import flatten_tree, k_for_ratio
    from repro_torch.device import resolve_device
    from repro_torch.fed import round_step as rs_mod
    from repro_torch.fed import simulation as sim_mod

    dev = resolve_device(device)
    if acfg is None:
        acfg = agg_mod.AggregationConfig(strategy="eftopk", cr=0.1)
    model_rng = np.random.default_rng(cfg.seed)
    means = (0.5 * model_rng.standard_normal(
        (cfg.n_classes, cfg.dim))).astype(np.float32)
    if init_params is None:
        params = sim_mod.mlp_init(torch.Generator().manual_seed(cfg.seed),
                                  cfg.dim, cfg.n_classes, hidden=cfg.hidden,
                                  device=dev)
    else:
        params = convert.params_to_torch(init_params, dev)
    flat = flatten_tree(params)
    n_params = int(flat.shape[0])
    v_bytes = 4.0 * n_params
    c_slots = min(cfg.cohort, pop.n_clients)
    strat = acfg.strat
    ef = strat.needs_residuals

    if step is None:
        # width from the schedule's floor: every retained count the plan can
        # emit is >= k_for_ratio(n, cr_star), so n - that bounds every row
        width = residual_width(n_params, k_for_ratio(n_params, acfg.cr))
        step = rs_mod.make_population_round_step(
            sim_mod.mlp_loss, params, lr=cfg.lr, acfg=acfg, width=width,
            device=dev)
    if ef and store is None:
        store = ClientStateStore(
            pop.n_clients, n_params, layout=strat.residual_layout,
            width=step.width or n_params, chunk_clients=chunk_clients,
            max_resident_chunks=max_resident_chunks, spill_dir=spill_dir)

    smask = torch.ones((c_slots, cfg.local_steps), dtype=torch.bool,
                       device=dev)
    active = torch.ones((c_slots,), dtype=torch.bool, device=dev)
    result = PopulationRunResult()
    res_dev = step.init_residuals(c_slots, n_params)
    for rnd in range(cfg.rounds):
        t0 = time.perf_counter()
        rng = np.random.default_rng((cfg.seed, rnd))
        ids = sample_cohort(rng, pop.n_clients, c_slots)
        fr = pop.weights[ids]
        fr = fr / fr.sum()
        links_sel = [pop.links[c] for c in ids]          # O(C)
        crs, weights, _info = agg_mod.round_schedule(acfg, len(ids), fr,
                                                     links_sel, v_bytes)
        ks = agg_mod.ks_for_schedule(n_params, crs, acfg)
        if strat.wire.dense:
            rt = cost_model.uncompressed_round(links_sel, v_bytes)
        else:
            rt = cost_model.round_times(
                links_sel, v_bytes, strat.wire.cr_eff(crs, n_params))
        result.comm_actual_s += rt.actual

        xs, ys = zip(*(_client_batches(cfg, means, pop.skew_seeds[c], rnd)
                       for c in ids))
        x = {"step_mask": smask, "active": active,
             "weights": torch.as_tensor(np.asarray(weights, np.float32),
                                        device=dev),
             "ks": torch.as_tensor(np.asarray(ks, np.int32), device=dev),
             "batches": {"x": torch.as_tensor(np.stack(xs), device=dev),
                         "y": torch.as_tensor(np.stack(ys), device=dev,
                                              dtype=torch.int64)}}
        if ef:
            gathered = [torch.as_tensor(a, device=dev)
                        for a in store.gather(ids)]
            res_dev = (tuple(gathered) if step.layout == "topk_complement"
                       else gathered[0])
        out = step(flat, res_dev, x)
        if ef:
            if bool(out["overflow"]):
                raise RuntimeError(
                    f"round {rnd}: EF residual outgrew the sparse width "
                    f"{step.width} — plan emitted a k below the width's "
                    "k_min")
            res_dev = out["residuals"]
            new = (res_dev if isinstance(res_dev, tuple) else (res_dev,))
            store.scatter(ids, tuple(a.cpu().numpy() for a in new))
        result.losses.append(float(out["loss"]))      # waits for the round
        result.wall_per_round.append(time.perf_counter() - t0)

    result.final_flat = flat.cpu().numpy().copy()
    if store is not None:
        result.gather_seconds = store.gather_seconds
        result.scatter_seconds = store.scatter_seconds
        result.peak_state_bytes = store.peak_resident_bytes
    return result, step, store
