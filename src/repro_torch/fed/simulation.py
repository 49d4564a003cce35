"""End-to-end FL simulation harness (torch port of ``repro.fed.simulation``:
``engine="fused" | "legacy" | "scan" | "pop_scan"`` and ``run_fl_traced``).

Same protocol as the reference on the same synthetic Dirichlet-partitioned
data: for each round, sample C·N clients -> E local epochs of SGD on the
simulation MLP -> compress -> aggregate -> time accounting. The host numpy
rng is consumed in the reference's order (data, partition, links, then per
round: cohort, batches), so datasets, cohorts and batches are identical to
``repro``'s for the same seed. Only the model's initial weights differ: the
reference draws them from ``jax.random``, the port from its own seeded
``torch.Generator`` — pass ``init_params`` (e.g. the reference's, through
``repro_torch.convert``) to start from the same weights.

The scan engines plan every round on the host first (``_plan_rounds``, the
same rng calls as the fused loop), then run the whole trajectory through
``engine.make_sim_scan``: on the card one captured CUDA graph of the round,
replayed once a round. ``run_fl_traced`` draws its plans inside the round
from a ``torch.Generator`` instead (its own stream).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core import aggregation as agg_mod
from repro_torch.core import bcrs as bcrs_mod
from repro_torch.core import cost_model
from repro_torch.core.compression import flatten_tree, topk_compress
from repro_torch.core.opwa import overlap_counts
from repro_torch.data import (build_client_datasets, data_fractions,
                              dirichlet_partition, synthetic_classification)
from repro_torch.device import resolve_device, synchronize
from repro_torch.fed import engine as engine_mod
from repro_torch.fed.client import make_local_trainer
from repro_torch.fed.server import FLServer
from repro_torch.ft import (FailureInjector, StragglerPolicy, arrivals,
                            over_select)
from repro_torch.ft.failures import survivors_traced
from repro_torch.ft.straggler import (arrival_mask_traced,
                                      renormalize_coefficients_traced)


# --------------------------------------------------------------- small model
def mlp_init(generator: torch.Generator, dim: int, n_classes: int,
             hidden: int = 128, device="cuda") -> Dict[str, torch.Tensor]:
    """The reference's init scheme (normal weights scaled by 1/sqrt(fan-in),
    zero biases) drawn from a CPU ``torch.Generator`` (a different stream
    from ``jax.random``) and placed on ``device``."""
    device = resolve_device(device)
    s1, s2 = 1 / np.sqrt(dim), 1 / np.sqrt(hidden)

    def normal(shape, scale):
        w = torch.randn(shape, generator=generator, dtype=torch.float32)
        return (w * np.float32(scale)).to(device)

    return {
        "w1": normal((dim, hidden), s1),
        "b1": torch.zeros((hidden,), device=device),
        "w2": normal((hidden, hidden), s2),
        "b2": torch.zeros((hidden,), device=device),
        "w3": normal((hidden, n_classes), s2),
        "b3": torch.zeros((n_classes,), device=device),
    }


def _logits(params, x):
    """MLP forward for unbatched params [d, h] on x [..., B, d], or for
    client-stacked params [C, d, h] on x [C, B, d] (``torch.bmm``)."""
    if params["w1"].dim() == 3:
        h = torch.relu(torch.bmm(x, params["w1"]) + params["b1"][:, None])
        h = torch.relu(torch.bmm(h, params["w2"]) + params["b2"][:, None])
        return torch.bmm(h, params["w3"]) + params["b3"][:, None]
    h = torch.relu(x @ params["w1"] + params["b1"])
    h = torch.relu(h @ params["w2"] + params["b2"])
    return h @ params["w3"] + params["b3"]


def mlp_loss(params, batch):
    """Mean cross-entropy per client: params [C, ...], batch x [C, B, d],
    y [C, B] -> (losses [C], logits [C, B, K]); for one client's unbatched
    params and x [B, d], y [B] -> (loss [], logits [B, K])."""
    logits = _logits(params, batch["x"])
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, batch["y"].to(torch.int64).unsqueeze(-1))
    return nll.squeeze(-1).mean(dim=-1), logits


@torch.no_grad()
def mlp_accuracy(params, x, y) -> float:
    logits = _logits(params, x)
    return float((logits.argmax(dim=-1) == y).to(torch.float32).mean())


# ------------------------------------------------------------------- harness
@dataclass
class FLSimConfig:
    """The reference's ``FLSimConfig``: the same fields, defaults and order
    (the simulation MLP at its full width: dim 256, hidden 256, 20 classes,
    136,724 parameters)."""
    n_clients: int = 10
    participation: float = 0.5        # C
    rounds: int = 40
    local_epochs: int = 1             # E
    batch_size: int = 64
    lr: float = 0.03                  # eta (local)
    beta: float = 0.1                 # Dirichlet heterogeneity
    n_train: int = 3000
    n_test: int = 1000
    n_classes: int = 20
    dim: int = 256
    hidden: int = 256
    noise: float = 3.0
    seed: int = 0
    eval_every: int = 5
    #: cap every client's local step count at this quantile of the
    #: per-client step distribution (1.0 = off); changes the trajectory
    step_cap_quantile: float = 1.0
    # ------------------------- engine="async" (FedBuff buffered) knobs ----
    #: merge buffer size K (0 -> the synchronous cohort size C·N); in async
    #: mode ``rounds`` counts buffer flushes
    async_buffer_k: int = 0
    #: in-flight upload concurrency M (0 -> min(2K, N - K))
    async_concurrency: int = 0
    #: staleness-discount exponent: w_i / (1 + s_i)^alpha (0 disables)
    async_alpha: float = 0.5
    #: partial-flush stall deadline (virtual seconds after the FIRST
    #: arrival into an empty buffer; inf = only flush when full)
    async_stall_s: float = float("inf")
    #: parity mode: replay the synchronous host round plans through the
    #: async train/merge programs (zero staleness by construction)
    async_sync_arrivals: bool = False
    #: per-attempt mid-transfer upload failure probability; failed attempts
    #: resume from their byte offset after exponential backoff
    async_p_fail_upload: float = 0.0
    async_max_attempts: int = 3
    async_backoff_s: float = 0.5
    async_backoff_factor: float = 2.0
    #: hard deadline per upload (virtual seconds since dispatch)
    async_upload_timeout_s: float = float("inf")
    #: batched dispatch: train pending dispatches in waves at flush /
    #: ring-eviction / checkpoint time, bit-equal to per-upload dispatch
    #: (False), the sequential baseline
    async_batch_dispatch: bool = True
    #: retained-parameter-version ring depth V for wave training (>=
    #: ``async_engine.min_version_ring``)
    async_version_ring: int = 8
    #: the dense [P + 1, n] EF residual store instead of the sparse
    #: ``population.ClientStateStore`` in the strategy's residual layout
    async_dense_store: bool = False
    #: sparse-store chunking: clients per chunk
    async_store_chunk: int = 256
    #: sparse-store LRU bound: max resident chunks (0 = unbounded; bounding
    #: requires ``async_store_spill``)
    async_store_resident: int = 0
    #: directory evicted sparse-store chunks spill into ("" = none)
    async_store_spill: str = ""
    # ------------------------------------------- link population shape ----
    link_bw_mean_mbps: float = 1.0
    link_bw_sd_mbps: float = 0.2


@dataclass
class FLSimResult:
    accuracies: List[Tuple[int, float]] = field(default_factory=list)
    times: Optional[cost_model.TimeAccumulator] = None
    overlap_hist: Optional[np.ndarray] = None
    final_accuracy: float = 0.0
    wall_per_round: List[float] = field(default_factory=list)
    executed_rounds: List[int] = field(default_factory=list)
    losses: List[float] = field(default_factory=list)
    #: final EF residuals [C, n] (EF strategies only; [P, n] per client
    #: for the population engines and the async engine)
    final_residuals: Optional[np.ndarray] = None
    #: engine="async" only: the finished ``BufferedAsyncLoop``
    async_loop: Optional[object] = None

    def time_to_accuracy(self, target: float) -> Optional[float]:
        """Accumulated actual comm time up to AND INCLUDING the round whose
        evaluation first hits ``target`` (None if never reached)."""
        if self.times is None:
            return None
        per_round = self.times.per_round
        rounds_of = (self.executed_rounds
                     if len(self.executed_rounds) == len(per_round)
                     else list(range(len(per_round))))
        cum = 0.0
        i = 0
        for r, acc in self.accuracies:
            while i < len(per_round) and rounds_of[i] <= r:
                cum += per_round[i].actual
                i += 1
            if acc >= target:
                return cum
        return None


# ------------------------------------------------------------- shared setup
def _setup_sim(sim: FLSimConfig, acfg: agg_mod.AggregationConfig,
               device="cuda", init_params=None):
    """Seeded experiment setup. Consumes the host rng exactly as the
    reference does (data, then partition, then links) so datasets and links
    are identical. ``init_params`` (dict of arrays or tensors) replaces the
    port's own seeded init. Returns (rng, clients, parts, fracs_all, splits,
    server)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(sim.seed)
    x, y = synthetic_classification(sim.n_train + sim.n_test, sim.n_classes,
                                    sim.dim, rng, noise=sim.noise)
    x_train, y_train = x[: sim.n_train], y[: sim.n_train]
    x_test, y_test = x[sim.n_train:], y[sim.n_train:]
    parts = dirichlet_partition(y_train, sim.n_clients, sim.beta, rng,
                                min_size=sim.batch_size)
    clients = build_client_datasets(x_train, y_train, parts)
    fracs_all = data_fractions(parts)
    if init_params is None:
        gen = torch.Generator().manual_seed(sim.seed)
        params = mlp_init(gen, sim.dim, sim.n_classes, hidden=sim.hidden,
                          device=dev)
    else:
        params = convert.params_to_torch(init_params, dev)
    links = cost_model.sample_links(sim.n_clients, rng,
                                    bw_mean_mbps=sim.link_bw_mean_mbps,
                                    bw_sd_mbps=sim.link_bw_sd_mbps)
    server = FLServer(params=params, acfg=acfg, eta=1.0, links=links)
    return (rng, clients, parts, fracs_all,
            (x_train, y_train, x_test, y_test), server)


# ----------------------------------------------------------- host-side plan
def _client_steps(ds, sim: FLSimConfig) -> int:
    return max(1, (len(ds) // sim.batch_size)) * sim.local_epochs


def _steps_by_client(clients, sim: FLSimConfig) -> np.ndarray:
    """Per-client local step counts with the optional quantile cap."""
    steps = np.array([_client_steps(ds, sim) for ds in clients], np.int64)
    if sim.step_cap_quantile < 1.0:
        cap = max(1, int(np.ceil(
            np.quantile(steps, sim.step_cap_quantile))))
        steps = np.minimum(steps, cap)
    return steps


def planned_client_steps(sim: FLSimConfig) -> np.ndarray:
    """Per-client local step counts (cap applied) for ``sim``'s seeded
    dataset — the partition every engine trains on, rebuilt through
    ``_setup_sim`` (on the CPU: only the host partition is read)."""
    _, clients, *_ = _setup_sim(sim, agg_mod.AggregationConfig(), "cpu")
    return _steps_by_client(clients, sim)


def cohort_slots(n_clients: int, participation: float) -> int:
    """Target cohort size C·N (the reference's rounding rule)."""
    return max(1, int(round(n_clients * participation)))


def _link_columns(links, ids) -> Tuple[np.ndarray, np.ndarray]:
    """(bandwidth_bps, latency_s) float64 columns for the given client ids:
    an O(C) slice of a ``cost_model.LinkArrays`` (population scale), or an
    O(C) comprehension over ``ClientLink`` objects; the same values
    either way."""
    if isinstance(links, cost_model.LinkArrays):
        return links.bandwidth_bps[ids], links.latency_s[ids]
    return (np.array([links[c].bandwidth_bps for c in ids], np.float64),
            np.array([links[c].latency_s for c in ids], np.float64))


def plan_cohort(rnd: int, rng, *, n_clients: int, participation: float,
                fracs_all, links, v_bytes, acfg,
                failure: Optional[FailureInjector] = None,
                straggler: Optional[StragglerPolicy] = None,
                cohort: Optional[int] = None,
                sparse_failures: bool = False):
    """One round's cohort: selection -> failure survivors -> straggler
    arrivals -> renormalized data fractions, consuming the host rng in the
    reference's order. Returns (selected, fr) or None when the whole cohort
    died (the round is skipped).

    Population scale: ``cohort`` fixes the target size directly (instead of
    ``round(P * participation)``), and ``sparse_failures=True`` draws
    survivors per sampled id (``FailureInjector.survivors_at``, O(C)) rather
    than the dense ``[P]`` vector — its own seeded stream, which revives a
    cohort member when all die, so the round is never skipped."""
    n_sel = cohort if cohort is not None \
        else cohort_slots(n_clients, participation)
    n_draw = over_select(n_sel, straggler) if straggler is not None else n_sel
    n_draw = min(n_draw, n_clients)
    selected = rng.choice(n_clients, n_draw, replace=False)
    if failure is not None:
        if sparse_failures:
            selected = selected[failure.survivors_at(rnd, selected)]
        else:
            alive = failure.survivors(rnd, n_clients)
            selected = selected[alive[selected]]
        if len(selected) == 0:
            return None
    if straggler is not None and len(selected) > n_sel:
        # completion times from the paper cost model at the configured CR,
        # priced through the strategy's wire format (comm_time_batch is
        # elementwise bit-identical to the scalar loop)
        cr_eff = acfg.strat.wire.cr_eff(acfg.cr, int(v_bytes // 4))
        bw, lat = _link_columns(links, selected)
        t = bcrs_mod.comm_time_batch(v_bytes, bw, lat, cr_eff)
        chosen, _ = arrivals(t, n_sel, straggler)
        selected = selected[chosen]
    fr = fracs_all[selected]
    fr = fr / fr.sum()
    return selected, fr


def _stack_client_batches(clients, selected, sim: FLSimConfig,
                          steps_by_client, s_max: int, rng,
                          slots: Optional[int] = None
                          ) -> Tuple[dict, np.ndarray]:
    """Draw each selected client's batches (the reference's rng calls, in
    cohort order), zero-pad to ``s_max`` steps, stack to [slots, S, ...] +
    mask [slots, S] (``slots`` defaults to the cohort's size). Padded steps,
    and the slots past the cohort, are exact no-ops in the trainer."""
    slots = len(selected) if slots is None else slots
    xs_all, ys_all = [], []
    mask = np.zeros((slots, s_max), bool)
    for j, c in enumerate(selected):
        ds = clients[c]
        steps = int(steps_by_client[c])
        xs, ys = ds.fixed_batches(sim.batch_size, steps, rng)
        if steps < s_max:
            xs = np.concatenate(
                [xs, np.zeros((s_max - steps,) + xs.shape[1:], xs.dtype)])
            ys = np.concatenate(
                [ys, np.zeros((s_max - steps,) + ys.shape[1:], ys.dtype)])
        xs_all.append(xs)
        ys_all.append(ys)
        mask[j, :steps] = True
    for _ in range(slots - len(selected)):
        xs_all.append(np.zeros_like(xs_all[0]))
        ys_all.append(np.zeros_like(ys_all[0]))
    batches = {"x": np.stack(xs_all), "y": np.stack(ys_all)}
    return batches, mask


def _is_eval_round(sim: FLSimConfig, rnd: int) -> bool:
    """The eval cadence: every ``eval_every`` rounds and the last round."""
    return rnd % sim.eval_every == 0 or rnd == sim.rounds - 1


def _eval_plan(sim: FLSimConfig, rnds) -> Tuple[np.ndarray, np.ndarray]:
    """(eval_write bool [len(rnds)], eval_slot int32 [len(rnds)]) for the
    given executed round numbers — the scan engines' snapshot schedule."""
    write = np.array([_is_eval_round(sim, r) for r in rnds], bool)
    slot = np.zeros((len(write),), np.int32)
    slot[write] = np.arange(int(write.sum()), dtype=np.int32)
    return write, slot


def _overlap_hist(counts: np.ndarray, cohort_size: int) -> np.ndarray:
    """Fig. 4 binning: histogram of the nonzero degrees of overlap, padded
    to cohort_size+1 bins (degree 0 dropped)."""
    counts = np.asarray(counts)
    return np.bincount(counts[counts > 0], minlength=cohort_size + 1)


# ------------------------------------------------------------------ run_fl
def _legacy_round(server: FLServer, local_train, clients, selected, fr,
                  sim: FLSimConfig, steps_by_client, rng, dev,
                  want_overlap: bool) -> dict:
    """One legacy round: each selected client trains on its own batches,
    drawn here in cohort order (the reference's rng order), then
    ``FLServer.round``. The Fig. 4 round adds the overlap counts of the
    clients' exact global Top-K masks."""
    deltas, losses = [], []
    for c in selected:
        xs, ys = clients[c].fixed_batches(sim.batch_size,
                                          int(steps_by_client[c]), rng)
        delta, loss = local_train(
            server.params, {"x": torch.as_tensor(xs, device=dev),
                            "y": torch.as_tensor(ys, device=dev,
                                                 dtype=torch.int64)})
        deltas.append(delta)
        losses.append(loss)
    info = server.round(deltas, fr, selected)
    info["loss"] = torch.stack(losses).mean()
    if want_overlap:
        crs = info.get("crs", np.full(len(deltas), server.acfg.cr))
        masks = torch.stack([topk_compress(flatten_tree(d), float(cr)).mask
                             for d, cr in zip(deltas, crs)])
        info["overlap_counts"] = overlap_counts(masks)
    return info


def run_fl(sim: FLSimConfig, acfg: agg_mod.AggregationConfig,
           failure: Optional[FailureInjector] = None,
           collect_overlap: bool = False, fused: bool = True,
           engine: Optional[str] = None,
           straggler: Optional[StragglerPolicy] = None,
           checkpoint_dir: Optional[str] = None, checkpoint_every: int = 0,
           stop_after: Optional[int] = None, *,
           device="cuda", init_params=None) -> FLSimResult:
    """Run the simulation on ``device`` ("cuda" by default; without CUDA
    this raises — pass ``device="cpu"`` for the CPU). The arguments up to
    ``stop_after`` are the reference's, in its order: ``engine`` selects
    the round engine and, when None, falls back to the ``fused`` bool
    ("fused" / "legacy"). "fused" runs one ``fed.round_step`` program per
    round, the next round's batches staged while it runs; "legacy" runs
    per-client local SGD and the per-client compression loop of
    ``FLServer.round``, batches drawn as each client trains, never ahead,
    so the shared rng keeps the reference's order. An unknown engine raises
    ``ValueError``.
    ``init_params`` starts from given weights instead of the port's seeded
    init. ``FLSimResult.losses`` holds each round's mean over the cohort of
    the clients' last local losses (fused, legacy and the scan and
    population engines).

    "scan" plans every round on the host (the fused loop's rng calls, in
    its order) and runs the trajectory as one program
    (``engine.make_sim_scan``; on the card a captured CUDA graph of the
    round, replayed once a round), bit-equal to "fused"; "pop_scan" does the
    same with per-client EF residuals in a dense ``[P + 1, n]`` carry
    (``sim.n_clients`` is the population P), which survive cohort
    resizes. "population" runs the same plans one eager round at a time
    through ``round_step.make_population_round_step``, its EF residuals in
    a sparse out-of-core ``population.ClientStateStore``: bit-equal to
    "pop_scan".

    "async" is the FedBuff-style buffered engine (``fed.async_engine``):
    ``sim.rounds`` counts buffer flushes, the ``sim.async_*`` knobs shape
    the buffer and the arrival process, and ``checkpoint_dir`` /
    ``checkpoint_every`` (flushes) persist its whole state at flush
    boundaries — a rerun with the same config resumes bit for bit from the
    newest intact checkpoint. ``stop_after`` stops after that many flushes
    (a crash at a flush boundary). Every other engine refuses the three."""
    if engine is None:
        engine = "fused" if fused else "legacy"
    if engine not in ("legacy", "fused", "scan", "pop_scan", "population",
                      "async"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine != "async" and (checkpoint_dir is not None
                              or stop_after is not None):
        raise ValueError("checkpoint_dir / stop_after are engine='async' "
                         "features (the sync checkpointing entry point is "
                         "launch.fl_train)")
    dev = resolve_device(device)
    (rng, clients, parts, fracs_all,
     (x_train, y_train, x_test, y_test), server) = _setup_sim(
        sim, acfg, dev, init_params)
    links = server.links
    steps_by_client = _steps_by_client(clients, sim)
    s_max = int(steps_by_client.max())
    if engine in ("scan", "pop_scan"):
        return _run_scan(sim, acfg, rng, clients, parts, fracs_all, links,
                         server, steps_by_client, s_max, x_train, y_train,
                         x_test, y_test, failure, straggler, collect_overlap,
                         per_client_ef=(engine == "pop_scan"))
    if engine == "async":
        if collect_overlap:
            raise ValueError("the async engine does not carry the Fig. 4 "
                             "overlap instrumentation — use engine='scan'")
        from repro_torch.fed.async_engine import run_async_sim
        return run_async_sim(sim, acfg, rng, clients, parts, fracs_all,
                             links, server, steps_by_client, s_max, x_train,
                             y_train, x_test, y_test, failure, straggler,
                             checkpoint_dir=checkpoint_dir,
                             checkpoint_every=checkpoint_every,
                             stop_after=stop_after)
    if engine == "population":
        if collect_overlap:
            raise ValueError("the population engine does not carry the "
                             "Fig. 4 overlap instrumentation — use "
                             "engine='scan' or 'pop_scan'")
        return _run_population(sim, acfg, rng, clients, parts, fracs_all,
                               links, server, steps_by_client, s_max,
                               x_train, y_train, x_test, y_test, failure,
                               straggler)
    if engine == "fused":
        server.init_fused(mlp_loss, sim.lr, collect_overlap=collect_overlap)
    else:
        local_train = make_local_trainer(mlp_loss, sim.lr)
    xt = torch.as_tensor(x_test, device=dev)
    yt = torch.as_tensor(y_test, device=dev, dtype=torch.int64)

    result = FLSimResult()
    overlap_hists = []

    def round_stream():
        """Per-round plans. For the fused engine the stacked client batches
        are staged to the device here: the consumer pulls round r+1 right
        after dispatching round r, so the host draws and copies the next
        batches while the device still runs the current round
        (double-buffered staging). The legacy engine draws its batches in
        the consumer, so nothing is drawn ahead."""
        for rnd in range(sim.rounds):
            plan = plan_cohort(rnd, rng, n_clients=sim.n_clients,
                               participation=sim.participation,
                               fracs_all=fracs_all, links=links,
                               v_bytes=server.v_bytes, acfg=acfg,
                               failure=failure, straggler=straggler)
            if plan is None:
                continue
            selected, fr = plan
            staged = None
            if engine == "fused":
                # padded to the static slot count: the scan engines' shapes
                batches, mask = _stack_client_batches(
                    clients, selected, sim, steps_by_client, s_max, rng,
                    cohort_slots(sim.n_clients, sim.participation))
                staged = ({"x": torch.as_tensor(batches["x"], device=dev),
                           "y": torch.as_tensor(batches["y"], device=dev,
                                                dtype=torch.int64)},
                          torch.as_tensor(mask, device=dev))
            yield rnd, selected, fr, staged

    stream = round_stream()
    item = next(stream, None)
    while item is not None:
        rnd, selected, fr, staged = item
        t0 = time.perf_counter()
        is_overlap_round = collect_overlap and rnd == sim.rounds // 2
        if engine == "fused":
            batches, step_mask = staged
            info = server.round_fused(batches, step_mask, fr, selected,
                                      want_overlap=is_overlap_round)
        else:
            info = _legacy_round(server, local_train, clients, selected, fr,
                                 sim, steps_by_client, rng, dev,
                                 is_overlap_round)
        item = next(stream, None)      # fused: stage the next round meanwhile
        if is_overlap_round:
            overlap_hists.append(_overlap_hist(
                info["overlap_counts"].cpu().numpy(), len(selected)))
        synchronize(dev)
        result.wall_per_round.append(time.perf_counter() - t0)
        result.executed_rounds.append(rnd)
        result.losses.append(float(info["loss"]))
        if _is_eval_round(sim, rnd):
            result.accuracies.append(
                (rnd, mlp_accuracy(server.params, xt, yt)))

    result.times = server.times
    result.final_accuracy = (result.accuracies[-1][1]
                             if result.accuracies else 0.0)
    if acfg.strat.needs_residuals and server.residuals is not None:
        # the last executed round's live cohort (fused: slots past it pad)
        live = len(selected)
        result.final_residuals = server.residuals[:live].cpu().numpy()
    if overlap_hists:
        result.overlap_hist = overlap_hists[0]
    return result


# ------------------------------------------------------- shared round plans
def _plan_rounds(sim, acfg, rng, clients, parts, fracs_all, links, server,
                 steps_by_client, s_max, failure, straggler,
                 collect_overlap) -> list:
    """Precompute every executed round's plan on the host, consuming the rng
    exactly as the fused loop does (``plan_cohort``, then each client's
    batch draw in cohort order: ``fixed_batch_indices`` is the draw that
    ``fixed_batches`` wraps): cohort -> BCRS schedule -> retained counts ->
    batch sample indices into the training set, with comm time accounted
    into ``server.times`` as it goes.

    Returns [(rnd, selected, weights, ks, ks_overlap, idx)]."""
    n_params, v_bytes = server.n_params, server.v_bytes
    bs = sim.batch_size
    plans = []
    for rnd in range(sim.rounds):
        plan = plan_cohort(rnd, rng, n_clients=sim.n_clients,
                           participation=sim.participation,
                           fracs_all=fracs_all, links=links,
                           v_bytes=v_bytes, acfg=acfg, failure=failure,
                           straggler=straggler)
        if plan is None:
            continue
        selected, fr = plan
        c_r = len(selected)
        links_sel = [links[i] for i in selected]
        crs, weights, info = agg_mod.round_schedule(acfg, c_r, fr, links_sel,
                                                    v_bytes)
        ks = agg_mod.ks_for_schedule(n_params, crs, acfg)
        ks_overlap = (agg_mod.overlap_ks(acfg, info, c_r, n_params)
                      if collect_overlap and rnd == sim.rounds // 2
                      else None)
        idx = np.zeros((c_r, s_max * bs), np.int32)
        for j, c in enumerate(selected):
            steps = int(steps_by_client[c])
            local = clients[c].fixed_batch_indices(bs, steps, rng)
            idx[j, : steps * bs] = parts[c][local]
        server._account_time(dict(info), links_sel)
        plans.append((rnd, selected, weights, ks, ks_overlap, idx))
    return plans


def _gather_batches(x_all: torch.Tensor, y_all: torch.Tensor):
    """``make_batches`` for the scan engines: a plan's [C, S, B] sample
    indices -> the batches, gathered on the device from the training set
    held there once."""
    def gather(p):
        idx = p["sample_idx"]
        flat_idx = idx.reshape(-1)
        return {"x": x_all.index_select(0, flat_idx).view(
                    *idx.shape, x_all.shape[-1]),
                "y": y_all.index_select(0, flat_idx).view(idx.shape)}
    return gather


def _snapshot_accuracy(server: FLServer, snap: torch.Tensor, xt, yt) -> float:
    """Accuracy of an eval snapshot, read from a fresh copy so its leaves
    sit at the offsets the server's own buffer gives them."""
    return mlp_accuracy(server._unravel(snap.clone()), xt, yt)


# -------------------------------------------------------------- scan engine
def _run_scan(sim, acfg, rng, clients, parts, fracs_all, links, server,
              steps_by_client, s_max, x_train, y_train, x_test, y_test,
              failure, straggler, collect_overlap,
              per_client_ef: bool = False) -> FLSimResult:
    """Whole-simulation engine: plan every round on the host (the fused
    loop's rng stream), stack the schedules and batch sample indices as
    [R, ...] plan rows, run them through one ``make_sim_scan`` program,
    then evaluate the eval-round snapshots.

    ``per_client_ef`` switches to the "pop_scan" carry: EF residuals in a
    dense ``[P + 1, n]`` per-client matrix (row P the padded-slot
    sentinel, checked to stay zero), slot-gathered and scattered by the
    cohort ids every round; no reset on cohort resizes."""
    dev = server.device
    n_sel = cohort_slots(sim.n_clients, sim.participation)
    n_params = server.n_params
    bs = sim.batch_size
    ef = acfg.strat.needs_residuals

    plans = _plan_rounds(sim, acfg, rng, clients, parts, fracs_all, links,
                         server, steps_by_client, s_max, failure, straggler,
                         collect_overlap)
    result = FLSimResult()
    if not plans:
        result.times = server.times
        return result

    # ------------------------------------------------- stack xs [R, C, ...]
    r_exec, c_max = len(plans), n_sel
    xs: Dict[str, np.ndarray] = {
        "sample_idx": np.zeros((r_exec, c_max, s_max, bs), np.int32),
        "step_mask": np.zeros((r_exec, c_max, s_max), bool),
        "active": np.zeros((r_exec, c_max), bool),
        "weights": np.zeros((r_exec, c_max), np.float32),
        "ks": np.ones((r_exec, c_max), np.int32),
    }
    if ef and not per_client_ef:
        xs["reset_ef"] = np.zeros((r_exec,), bool)
    if ef and per_client_ef:
        # slot -> client id; padded slots point at the sentinel row P
        xs["cohort"] = np.full((r_exec, c_max), sim.n_clients, np.int32)
    if collect_overlap:
        xs["ks_overlap"] = np.ones((r_exec, c_max), np.int32)
        xs["overlap_round"] = np.zeros((r_exec,), bool)
    xs["eval_write"], xs["eval_slot"] = _eval_plan(sim,
                                                   [p[0] for p in plans])
    n_evals = int(xs["eval_write"].sum())
    prev_c = None
    for i, (rnd, selected, weights, ks, ks_overlap, idx) in enumerate(plans):
        c_r = len(selected)
        xs["sample_idx"][i, :c_r] = idx.reshape(c_r, s_max, bs)
        for j, c in enumerate(selected):
            xs["step_mask"][i, j, : int(steps_by_client[c])] = True
        xs["active"][i, :c_r] = True
        xs["weights"][i, :c_r] = weights
        xs["ks"][i, :c_r] = ks
        if ef and per_client_ef:
            xs["cohort"][i, :c_r] = selected
        elif ef:
            # the fused server's rule: residuals reset whenever the cohort
            # size changes between consecutive executed rounds
            xs["reset_ef"][i] = prev_c is not None and c_r != prev_c
        if ks_overlap is not None:
            xs["ks_overlap"][i, :c_r] = ks_overlap
            xs["overlap_round"][i] = True
        prev_c = c_r

    # ------------------------------------------------ one program, R rounds
    x_all = torch.as_tensor(x_train, device=dev)
    y_all = torch.as_tensor(y_train, device=dev, dtype=torch.int64)
    sim_fn = engine_mod.make_sim_scan(
        mlp_loss, server.params, lr=sim.lr, acfg=acfg, eta=server.eta,
        with_overlap=collect_overlap,
        make_batches=_gather_batches(x_all, y_all),
        population=sim.n_clients if per_client_ef else None, device=dev)
    res_rows = (sim.n_clients + 1) if per_client_ef else c_max
    residuals0 = torch.zeros((res_rows, n_params) if ef else (0,),
                             dtype=torch.float32, device=dev)
    evals0 = torch.zeros((max(n_evals, 1), n_params), dtype=torch.float32,
                         device=dev)
    # capture (the reference's compile) is a one-off, outside the timing
    program = sim_fn.compile(server.flat, residuals0, evals0, xs)
    synchronize(dev)
    t_exec0 = time.perf_counter()
    out = program()
    synchronize(dev)
    wall = time.perf_counter() - t_exec0

    # --------------------------------------------------------- host post
    xt = torch.as_tensor(x_test, device=dev)
    yt = torch.as_tensor(y_test, device=dev, dtype=torch.int64)
    for i, (rnd, *_rest) in enumerate(plans):
        if xs["eval_write"][i]:
            snap = out["evals"][int(xs["eval_slot"][i])]
            result.accuracies.append(
                (rnd, _snapshot_accuracy(server, snap, xt, yt)))
    result.executed_rounds = [p[0] for p in plans]
    result.wall_per_round = [wall / r_exec] * r_exec
    result.losses = out["ys"]["loss"].cpu().tolist()
    result.times = server.times
    result.final_accuracy = (result.accuracies[-1][1]
                             if result.accuracies else 0.0)
    if ef and per_client_ef:
        if bool(out["residuals"][sim.n_clients].any()):
            raise RuntimeError("pop_scan: the sentinel residual row is "
                               "not zero")
        result.final_residuals = out["residuals"][: sim.n_clients].cpu() \
            .numpy()
    elif ef:
        server.residuals = out["residuals"][: len(plans[-1][1])]
        result.final_residuals = server.residuals.cpu().numpy()
    if collect_overlap:
        for i, (rnd, selected, *_rest) in enumerate(plans):
            if rnd == sim.rounds // 2:
                result.overlap_hist = _overlap_hist(
                    out["ys"]["overlap_counts"][i].cpu().numpy(),
                    len(selected))
    return result


# -------------------------------------------------------- population engine
def _slot_plan(n_sel: int, s_max: int, bs: int, selected, weights, ks, idx,
               steps_by_client) -> Dict[str, np.ndarray]:
    """One round's plan row padded to the ``n_sel`` static slots — the row
    ``_run_scan`` stacks for that round (inactive slots: no steps, weight
    0, k 1)."""
    c_r = len(selected)
    x = {"sample_idx": np.zeros((n_sel, s_max, bs), np.int32),
         "step_mask": np.zeros((n_sel, s_max), bool),
         "active": np.zeros((n_sel,), bool),
         "weights": np.zeros((n_sel,), np.float32),
         "ks": np.ones((n_sel,), np.int32)}
    x["sample_idx"][:c_r] = idx.reshape(c_r, s_max, bs)
    for j, c in enumerate(selected):
        x["step_mask"][j, : int(steps_by_client[c])] = True
    x["active"][:c_r] = True
    x["weights"][:c_r] = weights
    x["ks"][:c_r] = ks
    return x


def _run_population(sim, acfg, rng, clients, parts, fracs_all, links, server,
                    steps_by_client, s_max, x_train, y_train, x_test, y_test,
                    failure, straggler) -> FLSimResult:
    """Streaming-cohort engine over the sparse out-of-core client store:
    the scan engines' host plan (one rng stream), then one eager round a
    plan through ``make_population_round_step``, its EF residuals gathered
    from and scattered back to a ``population.ClientStateStore`` in the
    strategy's layout. The same slots, plan rows, batch gathers and round
    body as ``pop_scan``, and a lossless residual codec: bit-equal to it.
    Round state is O(C x n) on the device and O(P x width) on the host
    (chunked, spillable), never ``[P, n]`` dense."""
    from repro_torch.fed import population as pop_mod
    from repro_torch.fed import round_step as rs_mod

    dev = server.device
    n_sel = cohort_slots(sim.n_clients, sim.participation)
    n_params = server.n_params
    bs = sim.batch_size
    strat = acfg.strat
    ef = strat.needs_residuals

    plans = _plan_rounds(sim, acfg, rng, clients, parts, fracs_all, links,
                         server, steps_by_client, s_max, failure, straggler,
                         False)
    result = FLSimResult()
    if not plans:
        result.times = server.times
        return result

    x_all = torch.as_tensor(x_train, device=dev)
    y_all = torch.as_tensor(y_train, device=dev, dtype=torch.int64)
    width = 0
    if ef and strat.residual_layout == "topk_complement":
        width = pop_mod.residual_width(
            n_params, min(int(np.min(p[3])) for p in plans))
    step = rs_mod.make_population_round_step(
        mlp_loss, server.params, lr=sim.lr, acfg=acfg, eta=server.eta,
        width=width, make_batches=_gather_batches(x_all, y_all), device=dev)
    store = None
    if ef:
        store = pop_mod.ClientStateStore(
            sim.n_clients, n_params, layout=strat.residual_layout,
            width=max(width, 1), chunk_clients=min(256, sim.n_clients))

    res_dev = step.init_residuals(n_sel, n_params)
    xt = torch.as_tensor(x_test, device=dev)
    yt = torch.as_tensor(y_test, device=dev, dtype=torch.int64)
    for rnd, selected, weights, ks, _ks_overlap, idx in plans:
        t0 = time.perf_counter()
        c_r = len(selected)
        x = {k: torch.as_tensor(v, device=dev) for k, v in _slot_plan(
            n_sel, s_max, bs, selected, weights, ks, idx,
            steps_by_client).items()}
        if ef:
            # the real cohort's rows, zero-padded to the static slots (a
            # padded slot holds what pop_scan's sentinel row holds)
            bufs = pop_mod.padded_rows(store.gather(selected), n_sel, dev)
            res_dev = (tuple(bufs) if step.layout == "topk_complement"
                       else bufs[0])
        out = step(server.flat, res_dev, x)
        if ef:
            if bool(out["overflow"]):
                raise RuntimeError(
                    f"round {rnd}: EF residual outgrew sparse width "
                    f"{step.width}")
            new = out["residuals"]
            new = new if isinstance(new, tuple) else (new,)
            store.scatter(selected, tuple(a[:c_r].cpu().numpy()
                                          for a in new))
        result.losses.append(float(out["loss"]))      # waits for the round
        result.wall_per_round.append(time.perf_counter() - t0)
        result.executed_rounds.append(rnd)
        if _is_eval_round(sim, rnd):
            result.accuracies.append(
                (rnd, mlp_accuracy(server.params, xt, yt)))

    result.times = server.times
    result.final_accuracy = (result.accuracies[-1][1]
                             if result.accuracies else 0.0)
    if ef:
        # the per-client [P, n] matrix (parity with pop_scan); a small-P
        # engine — the large-P entry point is population.run_population_rounds
        result.final_residuals = store.dump_dense()
    return result


# ----------------------------------------------------- traced-sampling scan
def run_fl_traced(sim: FLSimConfig, acfg: agg_mod.AggregationConfig,
                  p_fail: float = 0.0,
                  straggler: Optional[StragglerPolicy] = None, *,
                  device="cuda", init_params=None) -> FLSimResult:
    """The scan engine with its sampling inside the round: cohort
    permutation, failure survival, straggler arrival deadlines and batch
    index draws all come from one ``torch.Generator`` on ``device``
    (seeded with ``sim.seed``; registered with the captured graph on the
    card, so each replay draws anew). Its own stream, not ``jax.random``'s
    and not the host engines', so it is held by what it must do (learn,
    survive failures and stragglers, one build), not bit for bit.

    The host's per-round work is none: the BCRS schedule is computed once
    over the full client set (links are round-invariant) and gathered per
    cohort in the round, coefficients renormalized over the arrivals
    (``renormalize_coefficients_traced``). Each round's sampled cohort and
    arrivals come back in ``ys``, so comm time is accounted over exactly
    the participating clients, as the host engines account theirs."""
    dev = resolve_device(device)
    (_rng, clients, parts, fracs_all,
     (x_train, y_train, x_test, y_test), server) = _setup_sim(
        sim, acfg, dev, init_params)
    links = server.links
    gen = torch.Generator(device=dev)
    gen.manual_seed(sim.seed)
    fracs_all = np.asarray(fracs_all, np.float64)
    n_params, v_bytes = server.n_params, server.v_bytes
    n, bs = sim.n_clients, sim.batch_size
    steps_by_client = _steps_by_client(clients, sim)
    s_max = int(steps_by_client.max())
    n_sel = cohort_slots(n, sim.participation)
    n_draw = min(over_select(n_sel, straggler) if straggler else n_sel, n)

    # round-invariant per-client tables (links don't change, so the BCRS
    # schedule over the FULL client set is computable once on the host)
    crs_all, coeffs_all, info = agg_mod.round_schedule(
        acfg, n, fracs_all / fracs_all.sum(), links, v_bytes)
    ks_all = agg_mod.ks_for_schedule(n_params, crs_all, acfg)
    cr_eff = acfg.strat.wire.cr_eff(acfg.cr, n_params)
    times_all = np.array([bcrs_mod.comm_time(v_bytes, l, cr_eff)
                          for l in links], np.float32)
    lens = np.array([len(ds) for ds in clients], np.int64)
    table = np.zeros((n, int(lens.max())), np.int32)
    for c, p in enumerate(parts):
        table[c, : len(p)] = p
    smask_all = np.arange(s_max)[None, :] < steps_by_client[:, None]

    def on_dev(a, dtype=None):
        return torch.as_tensor(a, device=dev, dtype=dtype)

    coeffs_d = on_dev(np.asarray(coeffs_all, np.float32))
    ks_d, times_d = on_dev(ks_all, torch.int32), on_dev(times_all)
    lens_d, table_d = on_dev(lens), on_dev(table, torch.int64)
    smask_d = on_dev(smask_all)
    inf = torch.full((n_draw,), float("inf"), device=dev)
    weighted_by_coeffs = acfg.strat.weighting == "bcrs"

    def plan_fn(_row):
        cohort = torch.rand(n, generator=gen, device=dev).argsort()[:n_draw]
        active = survivors_traced(gen, n, p_fail).index_select(0, cohort)
        if straggler is not None:
            t = torch.where(active, times_d.index_select(0, cohort), inf)
            active = arrival_mask_traced(t, n_sel, straggler)
        coeffs = coeffs_d.index_select(0, cohort)
        if weighted_by_coeffs:
            w = renormalize_coefficients_traced(coeffs, active)
        else:
            w = torch.where(active, coeffs, torch.zeros_like(coeffs))
            w = w / w.sum().clamp_min(1e-12)
        lens_c = lens_d.index_select(0, cohort)[:, None]
        u = torch.rand((n_draw, s_max * bs), generator=gen, device=dev)
        local = torch.minimum((u * lens_c).to(torch.int64), lens_c - 1)
        idx = table_d.index_select(0, cohort).gather(1, local)
        return {"sample_idx": idx.view(n_draw, s_max, bs),
                "step_mask": smask_d.index_select(0, cohort),
                "active": active, "weights": w,
                "ks": ks_d.index_select(0, cohort),
                # surfaced to the host so comm time is accounted over the
                # clients that actually participated, like the host engines
                "ys_extra": {"cohort": cohort, "arrived": active}}

    x_all = on_dev(x_train)
    y_all = on_dev(y_train, torch.int64)
    sim_fn = engine_mod.make_sim_scan(
        mlp_loss, server.params, lr=sim.lr, acfg=acfg, eta=server.eta,
        make_batches=_gather_batches(x_all, y_all), plan_fn=plan_fn,
        device=dev, generator=gen)
    ef = acfg.strat.needs_residuals
    residuals0 = torch.zeros((n_draw, n_params) if ef else (0,),
                             dtype=torch.float32, device=dev)
    eval_write, eval_slot = _eval_plan(sim, range(sim.rounds))
    evals0 = torch.zeros((max(int(eval_write.sum()), 1), n_params),
                         dtype=torch.float32, device=dev)
    program = sim_fn.compile(server.flat, residuals0, evals0,
                             {"eval_write": eval_write,
                              "eval_slot": eval_slot})
    synchronize(dev)
    t0 = time.perf_counter()
    out = program()
    synchronize(dev)
    wall = time.perf_counter() - t0

    result = FLSimResult()
    cohorts = out["ys"]["cohort"].cpu().numpy()
    arrived = out["ys"]["arrived"].cpu().numpy()
    xt = torch.as_tensor(x_test, device=dev)
    yt = torch.as_tensor(y_test, device=dev, dtype=torch.int64)
    for rnd in range(sim.rounds):
        # comm time over the clients that participated; a round whose whole
        # sampled cohort died contributes nothing, as a skipped host round
        sel = cohorts[rnd][arrived[rnd]]
        if sel.size:
            info_r = {"strategy": acfg.strategy}
            if "crs" in info:
                info_r["crs"] = np.asarray(crs_all)[sel]
            server._account_time(info_r, [links[c] for c in sel])
            result.executed_rounds.append(rnd)
        if eval_write[rnd]:
            snap = out["evals"][int(eval_slot[rnd])]
            result.accuracies.append(
                (rnd, _snapshot_accuracy(server, snap, xt, yt)))
    result.wall_per_round = ([wall / len(result.executed_rounds)]
                             * len(result.executed_rounds)
                             if result.executed_rounds else [])
    result.losses = out["ys"]["loss"].cpu().tolist()
    result.times = server.times
    result.final_accuracy = (result.accuracies[-1][1]
                             if result.accuracies else 0.0)
    if ef:
        result.final_residuals = out["residuals"].cpu().numpy()
    return result
