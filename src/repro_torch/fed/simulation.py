"""End-to-end FL simulation harness (torch port of ``repro.fed.simulation``,
``engine="fused"``).

Same protocol as the reference on the same synthetic Dirichlet-partitioned
data: for each round, sample C·N clients -> E local epochs of SGD on the
simulation MLP -> compress -> aggregate -> time accounting. The host numpy
rng is consumed in the reference's order (data, partition, links, then per
round: cohort, batches), so datasets, cohorts and batches are identical to
``repro``'s for the same seed. Only the model's initial weights differ: the
reference draws them from ``jax.random``, the port from its own seeded
``torch.Generator`` — pass ``init_params`` (e.g. the reference's, through
``repro_torch.convert``) to start from the same weights.
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
from repro_torch.data import (build_client_datasets, data_fractions,
                              dirichlet_partition, synthetic_classification)
from repro_torch.device import resolve_device, synchronize
from repro_torch.fed.server import FLServer
from repro_torch.ft import (FailureInjector, StragglerPolicy, arrivals,
                            over_select)


# --------------------------------------------------------------- small model
def mlp_init(generator: torch.Generator, dim: int, n_classes: int,
             hidden: int = 128, device="cpu") -> Dict[str, torch.Tensor]:
    """The reference's init scheme (normal weights scaled by 1/sqrt(fan-in),
    zero biases) drawn from a ``torch.Generator`` (a different stream from
    ``jax.random``)."""
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
    y [C, B] -> (losses [C], logits [C, B, K])."""
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
    """The reference's ``FLSimConfig`` fields that the fused engine reads,
    with the same defaults (the simulation MLP at its full width: dim 256,
    hidden 256, 20 classes, 136,724 parameters)."""
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
    #: final EF residuals [C, n] (EF strategies only)
    final_residuals: Optional[np.ndarray] = None

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


def cohort_slots(n_clients: int, participation: float) -> int:
    """Target cohort size C·N (the reference's rounding rule)."""
    return max(1, int(round(n_clients * participation)))


def plan_cohort(rnd: int, rng, *, n_clients: int, participation: float,
                fracs_all, links, v_bytes, acfg,
                failure: Optional[FailureInjector] = None,
                straggler: Optional[StragglerPolicy] = None):
    """One round's cohort: selection -> failure survivors -> straggler
    arrivals -> renormalized data fractions, consuming the host rng in the
    reference's order. Returns (selected, fr) or None when the whole cohort
    died (the round is skipped)."""
    n_sel = cohort_slots(n_clients, participation)
    n_draw = over_select(n_sel, straggler) if straggler is not None else n_sel
    n_draw = min(n_draw, n_clients)
    selected = rng.choice(n_clients, n_draw, replace=False)
    if failure is not None:
        alive = failure.survivors(rnd, n_clients)
        selected = selected[alive[selected]]
        if len(selected) == 0:
            return None
    if straggler is not None and len(selected) > n_sel:
        # completion times from the paper cost model at the configured CR,
        # priced through the strategy's wire format (comm_time_batch is
        # elementwise bit-identical to the scalar loop)
        cr_eff = acfg.strat.wire.cr_eff(acfg.cr, int(v_bytes // 4))
        bw = np.array([links[c].bandwidth_bps for c in selected], np.float64)
        lat = np.array([links[c].latency_s for c in selected], np.float64)
        t = bcrs_mod.comm_time_batch(v_bytes, bw, lat, cr_eff)
        chosen, _ = arrivals(t, n_sel, straggler)
        selected = selected[chosen]
    fr = fracs_all[selected]
    fr = fr / fr.sum()
    return selected, fr


def _stack_client_batches(clients, selected, sim: FLSimConfig,
                          steps_by_client, s_max: int, rng
                          ) -> Tuple[dict, np.ndarray]:
    """Draw each selected client's batches (the reference's rng calls, in
    cohort order), zero-pad to ``s_max`` steps, stack to [C, S, ...] + mask
    [C, S]. Padded steps are exact no-ops in the trainer."""
    xs_all, ys_all = [], []
    mask = np.zeros((len(selected), s_max), bool)
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
    batches = {"x": np.stack(xs_all), "y": np.stack(ys_all)}
    return batches, mask


def _is_eval_round(sim: FLSimConfig, rnd: int) -> bool:
    """The eval cadence: every ``eval_every`` rounds and the last round."""
    return rnd % sim.eval_every == 0 or rnd == sim.rounds - 1


def _overlap_hist(counts: np.ndarray, cohort_size: int) -> np.ndarray:
    """Fig. 4 binning: histogram of the nonzero degrees of overlap, padded
    to cohort_size+1 bins (degree 0 dropped)."""
    counts = np.asarray(counts)
    return np.bincount(counts[counts > 0], minlength=cohort_size + 1)


# ------------------------------------------------------------------ run_fl
def run_fl(sim: FLSimConfig, acfg: agg_mod.AggregationConfig,
           failure: Optional[FailureInjector] = None,
           collect_overlap: bool = False, engine: str = "fused",
           straggler: Optional[StragglerPolicy] = None,
           device="cuda", init_params=None) -> FLSimResult:
    """Run the simulation with the fused round engine (one
    ``fed.round_step`` program per round) on ``device`` ("cuda" by default;
    without CUDA this raises — pass ``device="cpu"`` for the CPU).
    ``init_params`` starts from given weights instead of the port's seeded
    init. The other engines of the reference are not ported yet."""
    if engine != "fused":
        raise NotImplementedError(
            f"engine={engine!r} is not ported yet: only 'fused' is. The "
            "legacy engine is ROADMAP queue 1 item 4, 'scan' item 5, "
            "'pop_scan'/'population' item 6, 'async' item 7")
    dev = resolve_device(device)
    (rng, clients, parts, fracs_all,
     (x_train, y_train, x_test, y_test), server) = _setup_sim(
        sim, acfg, dev, init_params)
    links = server.links
    steps_by_client = _steps_by_client(clients, sim)
    s_max = int(steps_by_client.max())
    server.init_fused(mlp_loss, sim.lr, collect_overlap=collect_overlap)
    xt = torch.as_tensor(x_test, device=dev)
    yt = torch.as_tensor(y_test, device=dev, dtype=torch.int64)

    result = FLSimResult()
    overlap_hists = []

    def round_stream():
        """Per-round plans with the stacked client batches staged to the
        device. The consumer pulls round r+1 right after dispatching round
        r, so the host draws and copies the next batches while the device
        still runs the current round (double-buffered staging)."""
        for rnd in range(sim.rounds):
            plan = plan_cohort(rnd, rng, n_clients=sim.n_clients,
                               participation=sim.participation,
                               fracs_all=fracs_all, links=links,
                               v_bytes=server.v_bytes, acfg=acfg,
                               failure=failure, straggler=straggler)
            if plan is None:
                continue
            selected, fr = plan
            batches, mask = _stack_client_batches(
                clients, selected, sim, steps_by_client, s_max, rng)
            staged = ({"x": torch.as_tensor(batches["x"], device=dev),
                       "y": torch.as_tensor(batches["y"], device=dev,
                                            dtype=torch.int64)},
                      torch.as_tensor(mask, device=dev))
            yield rnd, selected, fr, staged

    stream = round_stream()
    item = next(stream, None)
    while item is not None:
        rnd, selected, fr, (batches, step_mask) = item
        t0 = time.perf_counter()
        is_overlap_round = collect_overlap and rnd == sim.rounds // 2
        info = server.round_fused(batches, step_mask, fr, selected,
                                  want_overlap=is_overlap_round)
        item = next(stream, None)      # stage the next round meanwhile
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
        result.final_residuals = server.residuals.cpu().numpy()
    if overlap_hists:
        result.overlap_hist = overlap_hists[0]
    return result
