"""Federated training of real models (torch port of
``repro.launch.fl_train``): clients trained one after another on the card,
the BCRS per-round CR schedule, OPWA aggregation, EF residuals carried per
leaf, failure/straggler-aware cohorts and checkpoint/restart.

Everything the host decides per round — the cohort (``fed.simulation.
plan_cohort``, the planner the simulation engines use), failure survivors,
straggler arrivals and the BCRS schedule (``core.bcrs.make_schedule_batch``,
one call for all rounds) — is planned before training as padded ``[R, C]``
arrays, as the reference does. Every leaf of every round is merged through
``threshold_find`` + ``fused_merge`` on the card. Three engines:

  * ``scan`` (the default): ``fed.engine.make_mesh_sim_scan``, the rounds
    in chunks of ``checkpoint_every`` (4 with only a directory, else up to
    ``MAX_CHUNK_ROUNDS``), each chunk's plan rows on the device; on the
    card the first round runs eagerly and the round is captured once a run
    as a CUDA graph, replayed for every later round of every chunk; params
    and EF residuals checkpointed at every chunk boundary. A round's
    ``wall_per_round`` is its chunk's replay wall over the chunk's replays,
    the capture excluded; the eager round keeps its own wall;
  * ``round``: one ``fed.mesh_round.make_mesh_round_step`` call a round,
    the scan's bit-parity reference;
  * ``async``: FedBuff buffered training through
    ``fed.async_engine.BufferedAsyncLoop`` in flat parameter space
    (``rounds`` counts buffer flushes).

``population > 0`` streams cohorts of ``cohort`` slots over P registered
clients, per-client EF residuals in a ``fed.population.ClientStateStore``
(one ``mesh_round.make_population_round_step`` call a round).

Synthetic client batches come from round- (or dispatch-) indexed rng
streams, so a resumed run consumes the same data as an uninterrupted one.

    PYTHONPATH=src python -m repro_torch.launch.fl_train \\
        --arch stablelm-1.6b [--reduced --device cpu] --rounds 3 \\
        [--engine scan|round|async] [--population P --cohort C]
"""
from __future__ import annotations

import argparse
import os
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
from repro_torch.fed import mesh_round as mesh_mod
from repro_torch.fed import population as pop_mod
from repro_torch.fed.mesh_round import make_mesh_round_step
from repro_torch.fed.simulation import _link_columns, cohort_slots, plan_cohort
from repro_torch.ft import FailureInjector, StragglerPolicy
from repro_torch.models import Model

#: default cadence when a checkpoint dir is set without --checkpoint-every
DEFAULT_CHECKPOINT_EVERY = 4
#: scan chunk cap without a checkpoint cadence: each chunk's batches sit on
#: the device as plan rows, so an uncapped chunk would grow with the run
MAX_CHUNK_ROUNDS = 32


@dataclass
class FLTrainConfig:
    """Everything a run needs (the CLI below is a thin veneer): the
    reference's fields and defaults, plus ``device``."""
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
    checkpoint_every: int = 0    # rounds per scan chunk; 0 = auto-capped
    engine: str = "scan"         # "scan" | "round" | "async"
    # ----------------- engine="async" (FedBuff buffered) knobs -----------
    async_buffer_k: int = 0      # 0 -> the cohort slot count
    async_concurrency: int = 0   # 0 -> min(2K, clients - K)
    async_alpha: float = 0.5     # staleness-discount exponent
    async_stall_s: float = float("inf")   # partial-flush deadline
    async_p_fail: float = 0.0    # per-attempt mid-transfer failure prob
    async_timeout_s: float = float("inf")
    async_version_ring: int = 8  # retained-version ring depth V (waves)
    async_batch_dispatch: bool = True   # False = per-dispatch baseline
    async_store_chunk: int = 4096       # sparse-store clients per chunk
    population: int = 0          # > 0: streaming-cohort mode over P clients
    cohort: int = 0              # cohort slots C (population mode; 0 ->
                                 # --clients is reused as the cohort size)
    use_kernel: object = "auto"
    seed: int = 0
    verbose: bool = True
    device: str = "cuda"

    def __post_init__(self):
        strat_mod.get(self.strategy)   # config-time error, names listed
        if self.population > 0:
            if self.cohort <= 0:
                self.cohort = self.clients
            if self.cohort > self.population:
                raise ValueError(
                    f"cohort {self.cohort} exceeds population "
                    f"{self.population}")

    @property
    def n_registered(self) -> int:
        """Registered client count: the population in streaming mode, the
        (dense-state) client count otherwise."""
        return self.population if self.population > 0 else self.clients

    @property
    def c_slots(self) -> int:
        """Static cohort slot count every padded plan array is sized with."""
        if self.population > 0:
            return self.cohort
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
    ``make_schedule_batch`` call — the reference's host arithmetic. In
    population mode the cohort is the absolute ``cfg.cohort``, survivors
    are drawn per sampled id and the links are O(C) ``LinkArrays`` slices,
    so the plan is O(rounds x C) whatever P is."""
    pop_mode = cfg.population > 0
    c_max = cfg.c_slots
    plans = []
    for rnd in range(cfg.rounds):
        p = plan_cohort(rnd, rng, n_clients=cfg.n_registered,
                        participation=cfg.participation, fracs_all=fracs_all,
                        links=links, v_bytes=v_bytes, acfg=acfg,
                        failure=failure, straggler=straggler,
                        cohort=cfg.cohort if pop_mode else None,
                        sparse_failures=pop_mode)
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


def _stack_batches(cfg: FLTrainConfig, vocab: int, rounds: List[int],
                   c_max: int) -> Dict[str, np.ndarray]:
    per = [_round_batches(cfg, vocab, rnd, c_max) for rnd in rounds]
    return {k: np.stack([b[k] for b in per]) for k in per[0]}


def _on(device, a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _chunk_rounds(cfg: FLTrainConfig, n_todo: int) -> int:
    """Rounds per scan chunk (and per checkpoint of the round and
    population engines):
    ``checkpoint_every``, else the default cadence with a directory, else
    the whole run up to ``MAX_CHUNK_ROUNDS``."""
    if cfg.checkpoint_every > 0:
        return cfg.checkpoint_every
    if cfg.checkpoint_dir:
        return DEFAULT_CHECKPOINT_EVERY
    return min(max(n_todo, 1), MAX_CHUNK_ROUNDS)


def run(cfg: FLTrainConfig, init_params=None) -> dict:
    """Train per ``cfg``; returns {params, residuals, losses,
    executed_rounds, wall_per_round, chunk_rounds, times, resumed_from}
    (population mode adds ``store``, async ``async_loop``).

    ``init_params`` (optional): the starting params as a nested dict of
    arrays (e.g. the reference's ``Model.init``, carried across by
    ``convert.model_params_to_torch``); by default ``Model.init(cfg.seed)``
    draws them on the device."""
    if cfg.engine not in ("scan", "round", "async"):
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
    if cfg.population > 0:
        # registry columns, not P Python objects: every per-round read
        # downstream is an O(C) slice
        links = cost_model.sample_link_arrays(cfg.population, rng)
    else:
        links = cost_model.sample_links(cfg.clients, rng)
    fracs_all = np.full(cfg.n_registered, 1.0 / cfg.n_registered)
    failure = (FailureInjector(p_fail=cfg.fail_prob, seed=cfg.seed)
               if cfg.fail_prob > 0 else None)
    straggler = (StragglerPolicy(over_selection=cfg.over_selection)
                 if cfg.over_selection > 0 else None)
    if cfg.engine == "async":
        return _run_async(cfg, model, model_cfg, params, links, strat,
                          acfg, fracs_all, n_flat, v_bytes)
    plan = _build_plan(cfg, rng, fracs_all, links, v_bytes, acfg,
                       failure, straggler)
    times = cost_model.TimeAccumulator()
    if cfg.population > 0:
        return _run_population(cfg, model, model_cfg, params, plan, links,
                               strat, n_flat, v_bytes, times)

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
    chunk = _chunk_rounds(cfg, len(todo))

    losses: List[float] = []
    wall_per_round: List[float] = []
    chunk_rounds: List[int] = []
    kw = dict(strategy=cfg.strategy, eta=cfg.eta, gamma=cfg.gamma,
              overlap_d=cfg.overlap_d, use_kernel=cfg.use_kernel)

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

    program, capture_s = None, 0.0
    if cfg.engine == "scan":
        sim = engine_mod.make_mesh_sim_scan(model.loss_fn, params,
                                            lr=cfg.lr, **kw)
        pos = 0
        while pos < len(todo):
            idx = todo[pos:pos + chunk]
            xs = {"batches": _stack_batches(cfg, model_cfg.vocab_size,
                                            [plan.rounds[i] for i in idx],
                                            c_max),
                  "step_mask": plan.step_mask[idx],
                  "active": plan.active[idx],
                  "weights": plan.weights[idx],
                  "crs": plan.crs[idx]}
            # one program a run: the first chunk (the longest) sizes its
            # plan-row buffers, later chunks are copied into them
            if program is None:
                program = sim.compile(params, residuals, xs)
            else:
                program.load(xs)
            synchronize(dev)
            t0 = time.perf_counter()
            res_c = program()
            loss_c = res_c["ys"]["loss"].tolist()   # waits for the chunk
            synchronize(dev)
            # the capture is excluded, as the reference excludes compile
            wall = time.perf_counter() - t0 - program.capture_s
            walls = [wall / len(idx)] * len(idx)
            if program.capture_s:
                # the run's first round ran eagerly before the capture: it
                # keeps its own wall, the chunk's replays share the rest
                n_rep = len(idx) - 1
                rest = (wall - program.eager_s) / max(n_rep, 1)
                walls = [program.eager_s] + [rest] * n_rep
            capture_s += program.capture_s
            params, residuals = res_c["params"], res_c["residuals"]
            for j, i in enumerate(idx):
                account_and_log(i, loss_c[j], walls[j])
            chunk_rounds.append(len(idx))
            save(plan.rounds[idx[-1]] + 1)
            pos += len(idx)
    else:
        step = make_mesh_round_step(model.loss_fn, lr_local=cfg.lr, **kw)
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
            if (pos + 1) % chunk == 0 or pos == len(todo) - 1:
                save(plan.rounds[i] + 1)

    out = {"params": params, "residuals": residuals, "losses": losses,
           "executed_rounds": [plan.rounds[i] for i in todo],
           "wall_per_round": wall_per_round, "chunk_rounds": chunk_rounds,
           "times": times, "resumed_from": resumed_from}
    if program is not None:
        # what the capture cost and what a replay launches, apart from
        # wall_per_round (whose first entry is the eager round's on the card)
        out["scan"] = {
            "capture_s": capture_s, "eager_round_s": program.eager_s,
            "launches_per_replay": {w.__name__: n for w, n in
                                    program.launches_per_replay.items()}}
    if cfg.verbose:
        print(f"[fl] done; accumulated comm time {times.actual:.1f}s "
              f"(straggler-free min would be {times.min:.1f}s)")
    return out


def _run_async(cfg: FLTrainConfig, model, model_cfg, params, links, strat,
               acfg: AggregationConfig, fracs_all, n_flat: int,
               v_bytes: float) -> dict:
    """FedBuff-style async buffered training on the real model: the
    simulation's ``fed.async_engine`` loop in flat parameter space, with
    dispatch-indexed synthetic LM batches (restart-invariant, like the sync
    engines' round-indexed streams). ``cfg.rounds`` counts buffer flushes;
    the loop's state (params, per-client EF store, buffer, in-flight
    uploads) persists through ``cfg.checkpoint_dir`` and a rerun resumes
    bit for bit.

    The params ravel as ``ravel_pytree`` does (``core.compression.
    ravel_tree``): stablelm's bf16 matrices and f32 norms give an f32
    vector, an all-bf16 tree a bf16 one. The server's merge promotes the
    vector to f32, as the reference's ``flat - eta * agg`` does, so the
    loop carries an f32 copy; the version ring is f32 (the reference's
    host ring), and each wave member trains from its ring row cast to the
    params' own dtypes (``async_engine.make_model_wave_train_step``). With
    ``cfg.population > 0`` cohorts are drawn over P registered clients and
    EF residuals live in a sparse out-of-core ``ClientStateStore``."""
    from repro_torch.core import aggregation as agg_mod
    from repro_torch.core.compression import k_for_ratio, ravel_tree
    from repro_torch.fed import async_engine as async_mod

    flat0, unravel = ravel_tree(params)
    dev = flat0.device
    times = cost_model.TimeAccumulator()
    n_reg = cfg.n_registered
    k_buf = cfg.async_buffer_k or cfg.c_slots
    m_conc = cfg.async_concurrency or max(1, min(2 * k_buf, n_reg - k_buf))
    fracs_norm = np.asarray(fracs_all, np.float64)
    fracs_norm = fracs_norm / fracs_norm.sum()
    if strat.weighting == "bcrs" and isinstance(links,
                                                cost_model.LinkArrays):
        # population mode: the vectorized whole-population schedule (no P
        # Python ClientLink objects)
        crs_b, coeffs_b, _ = bcrs_mod.make_schedule_batch(
            links.bandwidth_bps[None], links.latency_s[None],
            fracs_norm[None], v_bytes, cfg.cr, cfg.alpha)
        crs_all, coeffs_all = crs_b[0], coeffs_b[0]
    else:
        crs_all, coeffs_all, _info = agg_mod.round_schedule(
            acfg, n_reg, fracs_norm, links, v_bytes)
    crs_arr = np.asarray(crs_all, np.float64)
    if strat.compresses and np.all(crs_arr == crs_arr.flat[0]):
        # uniform schedule (data weighting): one k, not P k_for_ratio calls
        ks_all = np.full((n_reg,),
                         k_for_ratio(n_flat, float(crs_arr.flat[0])),
                         np.int32)
    else:
        ks_all = agg_mod.ks_for_schedule(n_flat, crs_all, acfg)
    cr_eff_all = np.broadcast_to(np.asarray(
        strat.wire.cr_eff(crs_arr, n_flat), np.float64), (n_reg,))

    ef = strat.needs_residuals
    store = None
    if ef and cfg.population > 0:
        layout = strat.residual_layout
        width = (pop_mod.residual_width(n_flat, int(ks_all.min()))
                 if layout == "topk_complement" else 0)
        store = pop_mod.ClientStateStore(
            n_reg, n_flat, layout=layout, width=width,
            chunk_clients=min(cfg.async_store_chunk, n_reg))
        merge = async_mod.make_async_merge_step(
            acfg, eta=cfg.eta,
            residual_layout=("topk_complement"
                             if layout == "topk_complement" else "rows"),
            width=width, device=dev)
    else:
        merge = async_mod.make_async_merge_step(acfg, eta=cfg.eta,
                                                device=dev)

    wave_train = async_mod.make_model_wave_train_step(
        model.loss_fn, params, lr=cfg.lr,
        make_batches=lambda x: {"tokens": x["tokens"],
                                "labels": x["labels"]},
        strategy=cfg.strategy)
    smask_row = np.ones((cfg.local_steps,), bool)

    def batch_plan(client: int, uid: int) -> Dict[str, np.ndarray]:
        r = np.random.default_rng((cfg.seed, async_mod.BATCH_TAG, uid))
        toks = synthetic_lm_tokens(
            cfg.local_steps * cfg.batch, cfg.seq + 1, model_cfg.vocab_size,
            r).reshape(cfg.local_steps, cfg.batch, cfg.seq + 1)
        return {"tokens": toks[..., :-1], "labels": toks[..., 1:],
                "step_mask": smask_row}

    def on_flush(flush_idx: int, flat, rt: cost_model.RoundTime) -> None:
        times.add(rt)
        if cfg.verbose:
            print(f"[fl] flush {flush_idx} buffer {k_buf} "
                  f"interval {rt.actual:.2f}s slowest_upload {rt.max:.2f}s")

    def extra_state() -> dict:
        return {"times": [[float(t.actual), float(t.max), float(t.min)]
                          for t in times.per_round]}

    def load_extra(extra: dict) -> None:
        for a, mx, mn in extra.get("times", []):
            times.add(cost_model.RoundTime(a, mx, mn))

    ckpt_every = (cfg.checkpoint_every
                  or (DEFAULT_CHECKPOINT_EVERY if cfg.checkpoint_dir else 0))
    loop = async_mod.BufferedAsyncLoop(
        n_clients=n_reg, n_params=n_flat, buffer_k=k_buf,
        concurrency=m_conc, target_flushes=cfg.rounds, seed=cfg.seed,
        alpha=cfg.async_alpha, stall_s=cfg.async_stall_s,
        p_fail=cfg.async_p_fail,
        retry=cost_model.RetryPolicy(timeout_s=cfg.async_timeout_s),
        links=links, v_bytes=v_bytes, cr_eff_all=cr_eff_all, ks_all=ks_all,
        coeff_table=(coeffs_all if strat.weighting == "bcrs" else None),
        fracs_all=fracs_all, merge=merge, wave_train=wave_train,
        batch_plan=batch_plan, on_flush=on_flush,
        batch_dispatch=cfg.async_batch_dispatch,
        version_ring=cfg.async_version_ring, residual_store=store,
        checkpoint_dir=cfg.checkpoint_dir or None,
        checkpoint_every=ckpt_every, extra_state=extra_state,
        load_extra=load_extra)
    # the merge's promotion to f32 happens once, up front: the loop updates
    # its vector in place
    flat = flat0 if flat0.dtype == torch.float32 else flat0.float()
    del params
    flat = loop.run(flat)
    if cfg.verbose:
        print(f"[fl] done; accumulated virtual wall {times.actual:.1f}s "
              f"over {loop.flushes} flushes "
              f"({loop.train_calls} train dispatches / "
              f"{loop.train_rows} client updates)")
    # a vector no flush touched keeps its raveled dtype, as the reference's
    return {"params": unravel(flat if loop.flushes else flat0),
            "residuals": loop.store, "losses": [],
            "executed_rounds": list(range(loop.flushes)),
            "wall_per_round": [], "chunk_rounds": [], "times": times,
            "resumed_from": None, "async_loop": loop}


def _run_population(cfg: FLTrainConfig, model, model_cfg, params, plan,
                    links, strat, n_flat: int, v_bytes: float,
                    times) -> dict:
    """Streaming-cohort training over a population far larger than the
    cohort: per-client EF residuals live in a ``population.ClientStateStore``
    (sparse ``(idx32, f32)`` pairs for "topk_complement" strategies, chunked
    rows for "dense" ones) instead of a resident per-slot carry, and each
    round gathers the sampled cohort's rows into one
    ``mesh_round.make_population_round_step`` call and scatters the updated
    rows back. Round state is O(C x n + touched chunks), never O(P x n).

    Checkpoints hold ``{"params"}`` plus a client-store snapshot a step
    (``clients_step_<N>/`` beside ``step_<N>.msgpack``, pruned with the
    main retention), so a resumed run is bit-exact with an uninterrupted
    one, every client's residual included."""
    ef = strat.needs_residuals
    layout = strat.residual_layout if ef else None
    c_max = cfg.c_slots
    dev = engine_mod.tree_items(params)[0][1].device
    if layout == "topk_complement":
        # every retained count the plan can emit bounds the residual nnz
        cr_min = (float(plan.crs[plan.active].min())
                  if plan.active.any() else cfg.cr)
        width = mesh_mod.mesh_residual_width(params, cr_min)
    else:
        width = 0

    store: Optional[pop_mod.ClientStateStore] = None
    start, resumed_from = 0, None
    if cfg.checkpoint_dir and ckpt.latest_step(cfg.checkpoint_dir) is not None:
        tree, start, extra = ckpt.restore(cfg.checkpoint_dir,
                                          {"params": params}, strict=False)
        params = tree["params"]
        man = (extra or {}).get("client_store")
        if ef and man is not None:
            if layout == "topk_complement" and man["width"] != width:
                raise ValueError(
                    f"client-store snapshot has sparse width {man['width']} "
                    f"but the rebuilt plan needs {width} — the plan (rounds/"
                    "cr/seed) changed across the restart")
            store = pop_mod.ClientStateStore.restore(
                cfg.checkpoint_dir, start, man,
                spill_dir=os.path.join(cfg.checkpoint_dir, "client_spill"))
        resumed_from = start
        if cfg.verbose:
            print(f"[fl] resumed from round {start} "
                  f"(population {cfg.population})")
    if ef and store is None:
        store = pop_mod.ClientStateStore(
            cfg.population, n_flat, layout=layout, width=width,
            chunk_clients=min(4096, cfg.population))

    step = mesh_mod.make_population_round_step(
        model.loss_fn, params, lr_local=cfg.lr, eta=cfg.eta,
        strategy=cfg.strategy, gamma=cfg.gamma, overlap_d=cfg.overlap_d,
        use_kernel=cfg.use_kernel, width=width)

    def save(next_round: int) -> None:
        if not cfg.checkpoint_dir:
            return
        extra = {"arch": cfg.arch, "strategy": cfg.strategy,
                 "population": cfg.population}
        if store is not None:
            extra["client_store"] = store.save(cfg.checkpoint_dir,
                                               next_round)
        ckpt.save(cfg.checkpoint_dir, next_round, {"params": params},
                  extra=extra)
        if store is not None:
            # retention just ran on the step files; drop the client
            # snapshots whose step it pruned
            pop_mod.prune_client_snapshots(
                cfg.checkpoint_dir, ckpt.list_steps(cfg.checkpoint_dir))

    todo = [i for i, rnd in enumerate(plan.rounds) if rnd >= start]
    chunk = _chunk_rounds(cfg, len(todo))
    losses: List[float] = []
    wall_per_round: List[float] = []
    zero_wire = torch.zeros((0,), dtype=torch.float32, device=dev)
    for pos, i in enumerate(todo):
        sel = plan.selected[i][plan.active[i]]
        c_r = len(sel)
        batches = {k: _on(dev, v) for k, v in _round_batches(
            cfg, model_cfg.vocab_size, plan.rounds[i], c_max).items()}
        if ef:
            # zero-padded to the static slots
            bufs = pop_mod.padded_rows(store.gather(sel), c_max, dev)
            wire = tuple(bufs) if layout == "topk_complement" else bufs[0]
        else:
            wire = zero_wire
        synchronize(dev)
        t0 = time.perf_counter()
        params, wire, loss, overflow = step(
            params, wire, batches, _on(dev, plan.step_mask[i]),
            _on(dev, plan.weights[i]), _on(dev, plan.crs[i]),
            _on(dev, plan.active[i]))
        loss = float(loss)          # waits for the round
        synchronize(dev)
        wall = time.perf_counter() - t0
        del batches
        if ef:
            if bool(overflow):
                raise RuntimeError(
                    f"round {plan.rounds[i]}: EF residual outgrew the "
                    f"sparse width {width}")
            arrays = wire if isinstance(wire, tuple) else (wire,)
            store.scatter(sel, tuple(a[:c_r].cpu().numpy() for a in arrays))
        links_sel = [links[c] for c in sel]
        crs_wire = strat.wire.cr_eff(plan.crs[i][plan.active[i]], n_flat)
        times.add(cost_model.round_times(links_sel, v_bytes, crs_wire))
        losses.append(loss)
        wall_per_round.append(wall)
        if cfg.verbose:
            print(f"[fl] round {plan.rounds[i]} loss {loss:.4f} "
                  f"cohort {c_r}/{cfg.population} "
                  f"round_time {times.per_round[-1].actual:.2f}s "
                  f"wall {wall:.3f}s")
        if (pos + 1) % chunk == 0 or pos == len(todo) - 1:
            save(plan.rounds[i] + 1)

    if cfg.verbose:
        print(f"[fl] done; accumulated comm time {times.actual:.1f}s "
              f"(straggler-free min would be {times.min:.1f}s)")
    return {"params": params, "residuals": store, "losses": losses,
            "executed_rounds": [plan.rounds[i] for i in todo],
            "wall_per_round": wall_per_round,
            "chunk_rounds": [1] * len(todo), "times": times,
            "resumed_from": resumed_from, "store": store}


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
                    help="rounds per scan chunk / checkpoint cadence "
                         "(0 = auto chunking, checkpoint at chunk ends)")
    ap.add_argument("--engine", choices=("scan", "round", "async"),
                    default="scan")
    ap.add_argument("--async-buffer-k", type=int, default=0,
                    help="async merge buffer size K (0 = cohort slots)")
    ap.add_argument("--async-concurrency", type=int, default=0,
                    help="async in-flight dispatches M (0 = min(2K, N-K))")
    ap.add_argument("--async-alpha", type=float, default=0.5,
                    help="staleness-discount exponent")
    ap.add_argument("--async-stall", type=float, default=float("inf"),
                    help="partial-flush stall deadline in seconds")
    ap.add_argument("--async-p-fail", type=float, default=0.0,
                    help="per-attempt mid-transfer upload failure prob")
    ap.add_argument("--async-timeout", type=float, default=float("inf"),
                    help="per-upload hard deadline in seconds")
    ap.add_argument("--async-version-ring", type=int, default=8,
                    help="retained-parameter-version ring depth V for "
                         "batched wave dispatch")
    ap.add_argument("--async-sequential-dispatch", action="store_true",
                    help="disable batched wave dispatch (one wave per "
                         "upload)")
    ap.add_argument("--population", type=int, default=0,
                    help="registered client count P for streaming-cohort "
                         "mode (0 = dense-state mode over --clients)")
    ap.add_argument("--cohort", type=int, default=0,
                    help="cohort slots C in population mode "
                         "(0 = reuse --clients)")
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
        population=args.population, cohort=args.cohort,
        async_buffer_k=args.async_buffer_k,
        async_concurrency=args.async_concurrency,
        async_alpha=args.async_alpha, async_stall_s=args.async_stall,
        async_p_fail=args.async_p_fail, async_timeout_s=args.async_timeout,
        async_version_ring=args.async_version_ring,
        async_batch_dispatch=not args.async_sequential_dispatch,
        seed=args.seed, device=args.device))


if __name__ == "__main__":
    main()
