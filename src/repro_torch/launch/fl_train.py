"""Federated training of real models (torch port of
``repro.launch.fl_train``, the ``--engine round`` path): clients trained
one after another on the card, the BCRS per-round CR schedule, OPWA
aggregation, EF residuals carried per leaf, failure/straggler-aware cohorts
and checkpoint/restart.

Everything the host decides per round — the cohort (``fed.simulation.
plan_cohort``, the planner the simulation engines use), failure survivors,
straggler arrivals and the BCRS schedule (``core.bcrs.make_schedule_batch``,
one call for all rounds) — is planned before training as padded ``[R, C]``
arrays, as the reference does. Each executed round is one call of
``fed.mesh_round.make_mesh_round_step``: every leaf merged through
``threshold_find`` + ``fused_merge`` on the card. Params and EF residuals
are checkpointed every ``checkpoint_every`` rounds (4 when only a
directory is given) and at the end.

Synthetic client batches come from round-indexed rng streams, so a resumed
run consumes the same data as an uninterrupted one.

Not ported yet, each raising ``NotImplementedError`` naming its ROADMAP
item (queue 1): ``engine="scan"`` (the reference's default: the rounds as
one compiled program, item 1b), ``population > 0`` (item 1c) and
``engine="async"`` (item 1d).

    PYTHONPATH=src python -m repro_torch.launch.fl_train --engine round \\
        --arch stablelm-1.6b [--reduced --device cpu] --rounds 3
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import bcrs as bcrs_mod
from repro_torch.core import cost_model
from repro_torch.core import strategies as strat_mod
from repro_torch.core.aggregation import AggregationConfig
from repro_torch.data import synthetic_lm_tokens
from repro_torch.device import resolve_device, synchronize
from repro_torch.fed import engine as engine_mod
from repro_torch.fed.mesh_round import make_mesh_round_step
from repro_torch.fed.simulation import _link_columns, cohort_slots, plan_cohort
from repro_torch.ft import FailureInjector, StragglerPolicy
from repro_torch.models import Model

#: default cadence when a checkpoint dir is set without --checkpoint-every
DEFAULT_CHECKPOINT_EVERY = 4

_NOT_PORTED = {
    "scan": "engine='scan' (the rounds as one program: ROADMAP queue 1, "
            "item 1b, the mesh scan) is not ported yet; pass "
            "engine='round'",
    "async": "engine='async' (ROADMAP queue 1, item 1d) is not ported yet; "
             "pass engine='round'",
    "population": "population > 0 (streaming cohorts over a client store: "
                  "ROADMAP queue 1, item 1c) is not ported yet",
}


@dataclass
class FLTrainConfig:
    """Everything a run needs (the CLI below is a thin veneer). The
    reference's fields and defaults, plus ``device``; the ``async_*`` knobs
    and ``cohort`` come with the async engine and the population mode
    (ROADMAP queue 1, items 1c and 1d)."""
    arch: str = "stablelm-1.6b"
    rounds: int = 10
    clients: int = 8
    participation: float = 1.0
    local_steps: int = 2
    batch: int = 4
    seq: int = 128
    strategy: str = "bcrs_opwa"
    cr: float = 0.05
    alpha: float = 1.0
    gamma: float = 3.0
    overlap_d: int = 1          # OPWA required degree of overlap D
    lr: float = 5e-2
    eta: float = 1.0
    reduced: bool = False
    fail_prob: float = 0.0
    over_selection: float = 0.0  # rho > 0 enables straggler over-selection
    checkpoint_dir: str = ""
    checkpoint_every: int = 0    # rounds per checkpoint; 0 = every 4
    engine: str = "scan"         # "scan" | "round" | "async"
    population: int = 0          # > 0: streaming cohorts (not ported)
    use_kernel: object = "auto"
    seed: int = 0
    verbose: bool = True
    device: str = "cuda"

    def __post_init__(self):
        strat_mod.get(self.strategy)   # config-time error, names listed

    @property
    def c_slots(self) -> int:
        """Static cohort slot count every padded plan array is sized with."""
        return cohort_slots(self.clients, self.participation)


@dataclass
class RoundPlan:
    """Host-precomputed per-round arrays for the executed rounds, padded to
    ``c_max`` cohort slots (active marks the real prefix); ``rounds`` holds
    the executed round numbers (rounds whose whole cohort died are
    absent)."""
    rounds: List[int]
    selected: np.ndarray     # [T, C] i32, -1 at padded slots
    active: np.ndarray       # [T, C] bool
    weights: np.ndarray      # [T, C] f32 (0 at padded slots)
    crs: np.ndarray          # [T, C] f32 (comm/compression ratio per client)
    step_mask: np.ndarray    # [T, C, S] bool


def _build_plan(cfg: FLTrainConfig, rng, fracs_all, links, v_bytes,
                acfg: AggregationConfig,
                failure: Optional[FailureInjector],
                straggler: Optional[StragglerPolicy]) -> RoundPlan:
    """Plan every round before training starts: cohorts through the shared
    ``plan_cohort`` (one rng stream, consumed in round order, so a restart
    rebuilds the same plan), then the BCRS schedule for all rounds in one
    ``make_schedule_batch`` call — the reference's host arithmetic."""
    c_max = cfg.c_slots
    plans = []
    for rnd in range(cfg.rounds):
        p = plan_cohort(rnd, rng, n_clients=cfg.clients,
                        participation=cfg.participation, fracs_all=fracs_all,
                        links=links, v_bytes=v_bytes, acfg=acfg,
                        failure=failure, straggler=straggler)
        if p is not None:
            plans.append((rnd, *p))
    t = len(plans)
    selected = np.full((t, c_max), -1, np.int32)
    active = np.zeros((t, c_max), bool)
    fr_pad = np.zeros((t, c_max), np.float64)
    # harmless placeholders at padded slots (they never reach the schedule
    # max or the merge: active gates them everywhere)
    bw = np.ones((t, c_max), np.float64)
    lat = np.zeros((t, c_max), np.float64)
    for i, (rnd, sel, fr) in enumerate(plans):
        c_r = len(sel)
        selected[i, :c_r] = sel
        active[i, :c_r] = True
        fr_pad[i, :c_r] = fr
        bw[i, :c_r], lat[i, :c_r] = _link_columns(links, sel)

    strat = strat_mod.get(cfg.strategy)
    if strat.weighting == "bcrs":
        crs, coeffs, _ = bcrs_mod.make_schedule_batch(
            bw, lat, fr_pad, v_bytes, cfg.cr, cfg.alpha, active=active)
        weights = coeffs.astype(np.float32)
        crs = crs.astype(np.float32)
    else:
        weights = fr_pad.astype(np.float32)
        # plan.crs are SELECTION ratios (they feed k_for_ratio_traced in the
        # round body); wire pricing is applied at accounting time
        cr_sel = cfg.cr if strat.compresses else 1.0
        crs = np.where(active, np.float32(cr_sel), np.float32(0.0))

    step_mask = np.zeros((t, c_max, cfg.local_steps), bool)
    step_mask[active] = True
    return RoundPlan(rounds=[p[0] for p in plans], selected=selected,
                     active=active, weights=weights, crs=crs,
                     step_mask=step_mask)


def _round_batches(cfg: FLTrainConfig, vocab: int, rnd: int,
                   c_max: int) -> Dict[str, np.ndarray]:
    """Synthetic LM batches for one round, drawn from a round-indexed rng
    stream — independent of resume point and of which earlier rounds were
    skipped, so checkpoint/restart consumes bit-identical data."""
    r = np.random.default_rng((cfg.seed, 104_729, rnd))
    toks = synthetic_lm_tokens(
        c_max * cfg.local_steps * cfg.batch, cfg.seq + 1, vocab, r).reshape(
            c_max, cfg.local_steps, cfg.batch, cfg.seq + 1)
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


def _on(device, a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def run(cfg: FLTrainConfig, init_params=None) -> dict:
    """Train per ``cfg``; returns {params, residuals, losses,
    executed_rounds, wall_per_round, chunk_rounds, times, resumed_from}.

    ``init_params`` (optional): the starting params as a nested dict of
    arrays (e.g. the reference's ``Model.init``, carried across by
    ``convert.model_params_to_torch``); by default ``Model.init(cfg.seed)``
    draws them on the device."""
    if cfg.population > 0:
        raise NotImplementedError(_NOT_PORTED["population"])
    if cfg.engine in _NOT_PORTED:
        raise NotImplementedError(_NOT_PORTED[cfg.engine])
    if cfg.engine != "round":
        raise ValueError(f"unknown engine {cfg.engine!r}")
    dev = resolve_device(cfg.device)
    model_cfg = get_config(cfg.arch)
    if cfg.reduced:
        model_cfg = model_cfg.reduced()
    model = Model(model_cfg, device=dev)
    rng = np.random.default_rng(cfg.seed)
    params = (model.init(cfg.seed) if init_params is None
              else convert.model_params_to_torch(init_params, device=dev))
    n_flat = sum(int(p.numel()) for _, p in engine_mod.tree_items(params))
    v_bytes = 4.0 * n_flat
    c_max = cfg.c_slots
    strat = strat_mod.get(cfg.strategy)
    ef = strat.needs_residuals

    acfg = AggregationConfig(strategy=cfg.strategy, cr=cfg.cr,
                             alpha=cfg.alpha, gamma=cfg.gamma,
                             overlap_d=cfg.overlap_d,
                             use_kernel=cfg.use_kernel)
    links = cost_model.sample_links(cfg.clients, rng)
    fracs_all = np.full(cfg.clients, 1.0 / cfg.clients)
    failure = (FailureInjector(p_fail=cfg.fail_prob, seed=cfg.seed)
               if cfg.fail_prob > 0 else None)
    straggler = (StragglerPolicy(over_selection=cfg.over_selection)
                 if cfg.over_selection > 0 else None)
    plan = _build_plan(cfg, rng, fracs_all, links, v_bytes, acfg,
                       failure, straggler)
    times = cost_model.TimeAccumulator()

    residuals = (engine_mod.init_mesh_residuals(params, c_max) if ef
                 else torch.zeros((0,), dtype=torch.float32, device=dev))
    start, resumed_from = 0, None
    if cfg.checkpoint_dir and ckpt.latest_step(cfg.checkpoint_dir) is not None:
        like = {"params": params, "residuals": residuals}
        try:
            # strict=False: a residual-free checkpoint (e.g. strategy
            # switched to eftopk) resumes with fresh residuals
            tree, start, _extra = ckpt.restore(cfg.checkpoint_dir, like,
                                               strict=False)
            params, residuals = tree["params"], tree["residuals"]
        except ckpt.LayoutMismatch:
            # legacy layout: the bare params tree at the top level (a
            # shape-drifted leaf raises plain ValueError above and must NOT
            # reach this fallback)
            params, start, _extra = ckpt.restore(cfg.checkpoint_dir, params)
        resumed_from = start
        if cfg.verbose:
            print(f"[fl] resumed from round {start}")

    todo = [i for i, rnd in enumerate(plan.rounds) if rnd >= start]
    every = cfg.checkpoint_every or DEFAULT_CHECKPOINT_EVERY

    losses: List[float] = []
    wall_per_round: List[float] = []
    chunk_rounds: List[int] = []

    def save(next_round: int) -> None:
        if cfg.checkpoint_dir:
            tree = {"params": params, "residuals": residuals}
            ckpt.save(cfg.checkpoint_dir, next_round, tree,
                      extra={"arch": cfg.arch, "strategy": cfg.strategy})

    def account_and_log(i: int, loss: float, wall: float) -> None:
        rnd = plan.rounds[i]
        sel = plan.selected[i][plan.active[i]]
        links_sel = [links[c] for c in sel]
        # selection CRs priced through the declared wire format
        crs_wire = strat.wire.cr_eff(plan.crs[i][plan.active[i]], n_flat)
        times.add(cost_model.round_times(links_sel, v_bytes, crs_wire))
        losses.append(loss)
        wall_per_round.append(wall)
        if cfg.verbose:
            crs_act = plan.crs[i][plan.active[i]]
            print(f"[fl] round {rnd} loss {loss:.4f} "
                  f"cohort {len(sel)}/{cfg.clients} "
                  f"round_time {times.per_round[-1].actual:.2f}s "
                  f"CRs [{crs_act.min():.3f},{crs_act.max():.3f}] "
                  f"wall {wall:.3f}s")

    step = make_mesh_round_step(model.loss_fn, lr_local=cfg.lr,
                                strategy=cfg.strategy, eta=cfg.eta,
                                gamma=cfg.gamma, overlap_d=cfg.overlap_d,
                                use_kernel=cfg.use_kernel)
    for pos, i in enumerate(todo):
        batches = {k: _on(dev, v) for k, v in _round_batches(
            cfg, model_cfg.vocab_size, plan.rounds[i], c_max).items()}
        synchronize(dev)
        t0 = time.perf_counter()
        params, res, loss = step(
            params, residuals if ef else None, batches,
            _on(dev, plan.step_mask[i]), _on(dev, plan.weights[i]),
            _on(dev, plan.crs[i]), _on(dev, plan.active[i]))
        loss = float(loss)          # waits for the round
        synchronize(dev)
        wall = time.perf_counter() - t0
        if ef:
            residuals = res
        del batches
        account_and_log(i, loss, wall)
        chunk_rounds.append(1)
        if (pos + 1) % every == 0 or pos == len(todo) - 1:
            save(plan.rounds[i] + 1)

    if cfg.verbose:
        print(f"[fl] done; accumulated comm time {times.actual:.1f}s "
              f"(straggler-free min would be {times.min:.1f}s)")
    return {"params": params, "residuals": residuals, "losses": losses,
            "executed_rounds": [plan.rounds[i] for i in todo],
            "wall_per_round": wall_per_round, "chunk_rounds": chunk_rounds,
            "times": times, "resumed_from": resumed_from}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="stablelm-1.6b")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--participation", type=float, default=1.0)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--strategy", choices=strat_mod.names(),
                    default="bcrs_opwa")
    ap.add_argument("--cr", type=float, default=0.05)
    ap.add_argument("--alpha", type=float, default=1.0)
    ap.add_argument("--gamma", type=float, default=3.0)
    ap.add_argument("--overlap-d", type=int, default=1,
                    help="OPWA required degree of overlap D")
    ap.add_argument("--lr", type=float, default=5e-2)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--fail-prob", type=float, default=0.0)
    ap.add_argument("--over-selection", type=float, default=0.0,
                    help="straggler over-selection rho (0 disables)")
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="rounds per checkpoint (0 = at the end, or every "
                         f"{DEFAULT_CHECKPOINT_EVERY} with a directory)")
    ap.add_argument("--engine", choices=("scan", "round", "async"),
                    default="scan",
                    help="only 'round' is ported; 'scan' (the reference's "
                         "default) and 'async' raise NotImplementedError")
    ap.add_argument("--population", type=int, default=0,
                    help="registered client count P (not ported: > 0 "
                         "raises NotImplementedError)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    run(FLTrainConfig(
        arch=args.arch, rounds=args.rounds, clients=args.clients,
        participation=args.participation, local_steps=args.local_steps,
        batch=args.batch, seq=args.seq, strategy=args.strategy, cr=args.cr,
        alpha=args.alpha, gamma=args.gamma, overlap_d=args.overlap_d,
        lr=args.lr, reduced=args.reduced, fail_prob=args.fail_prob,
        over_selection=args.over_selection,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every, engine=args.engine,
        population=args.population, seed=args.seed,
        device=args.device))


if __name__ == "__main__":
    main()
