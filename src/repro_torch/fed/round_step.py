"""Fused FL round and the population round (torch port of
``repro.fed.round_step``: ``make_round_step``,
``make_population_round_step``).

One call runs the whole round on the device: local SGD for the cohort at
once (``engine.make_masked_local_trainer``), traced-k compression, EF,
codec, the OPWA merge (the two Hopper kernels when kernels are on) and the
server update — ``engine.make_round_body``, the body the scan engines
replay too. Per-round scalars (CRs, Eq. 6 coefficients, retained counts)
stay host-scheduled numpy and enter as tensors.

PyTorch runs eagerly, so there is no trace to count; ``BUILD_COUNTS`` counts
how many round programs were built per (strategy, with_overlap) — and per
("population", strategy) — the counterpart of the reference's
``TRACE_COUNTS``: a simulation builds each once, however many rounds it
runs.
"""
from __future__ import annotations

import collections
from typing import Callable

import torch

from repro_torch.core import aggregation as agg_mod
from repro_torch.fed import engine

#: (strategy, with_overlap) | ("population", strategy) -> number of round
#: programs built
BUILD_COUNTS: collections.Counter = collections.Counter()


class FusedRoundStep:
    """The fused round program of ``make_round_step`` (build telemetry lives
    in the module-level ``BUILD_COUNTS``)."""

    def __init__(self, fn: Callable, strategy: str, with_overlap: bool):
        self._fn = fn
        self.strategy = strategy
        self.with_overlap = with_overlap

    def __call__(self, flat, residuals, batches, step_mask, weights, ks,
                 ks_overlap, active=None):
        return self._fn(flat, residuals, batches, step_mask, weights, ks,
                        ks_overlap, active)


def make_round_step(loss_fn: Callable, params_template, *, lr: float,
                    acfg: agg_mod.AggregationConfig, eta: float = 1.0,
                    with_overlap: bool = False,
                    device="cuda") -> FusedRoundStep:
    """Build the fused round program for ``device``.

    Returned step signature::

        step(flat [n] f32,            # global model, ravel order; UPDATED
                                      # IN PLACE (w <- w - eta*agg)
             residuals [C, n] | None, # EF state (EF strategies); UPDATED
                                      # IN PLACE
             batches,                 # dict of [C, S, ...] stacked batches
             step_mask [C, S] bool,   # padded-step validity
             weights [C] f32,         # data fracs or Eq. 6 coefficients
             ks [C] int,              # retained count per client
             ks_overlap [C] int,      # Fig. 4 top-k counts (overlap variant)
             active=None)             # bool [C]: padded cohort slots (all
                                      # live when None)
        -> {"flat", "residuals", "loss"[, "overlap_counts"]}
    """
    spec = engine.spec_for(acfg, device)
    body = engine.make_round_body(loss_fn, params_template, lr=lr,
                                  spec=spec, eta=eta)
    BUILD_COUNTS[(spec.strategy, with_overlap)] += 1

    def step(flat, residuals, batches, step_mask, weights, ks, ks_overlap,
             active=None):
        if active is None:
            active = torch.ones(step_mask.shape[0], dtype=torch.bool,
                                device=step_mask.device)
        plan = {"batches": batches, "step_mask": step_mask,
                "weights": weights, "ks": ks, "ks_overlap": ks_overlap,
                "active": active}
        # in place: the server's flat buffer is the model, and the params it
        # hands out are views of it; nothing else holds the old values
        ys = body(flat, residuals, plan, with_overlap)
        return {"flat": flat, "residuals": residuals, **ys}

    return FusedRoundStep(step, spec.strategy, with_overlap)


# -------------------------------------------- population slot-gather round
class PopulationRoundStep:
    """The population round of ``make_population_round_step``: the
    slot-gather adapter between a ``population.ClientStateStore`` and the
    shared round body. Residuals cross it in the store's wire layout
    (``(idx, val)`` pairs for "topk_complement", full rows for "dense"),
    densified and sparsified on the device."""

    def __init__(self, fn: Callable, spec, layout, width: int,
                 device: torch.device):
        self._fn = fn
        self.spec = spec
        self.strategy = spec.strategy
        self.layout = layout       # None when the strategy carries no EF
        self.width = width         # sparse pair width (topk_complement only)
        self.device = device

    def __call__(self, flat, residuals, x):
        return self._fn(flat, residuals, x)

    def init_residuals(self, cohort: int, n: int):
        """Zero residual buffers in this step's wire layout (what a client
        that never participated gathers from the store)."""
        dev = self.device
        if self.layout is None:
            return torch.zeros((0,), dtype=torch.float32, device=dev)
        if self.layout == "topk_complement":
            return (torch.zeros((cohort, self.width), dtype=torch.int32,
                                device=dev),
                    torch.zeros((cohort, self.width), dtype=torch.float32,
                                device=dev))
        return torch.zeros((cohort, n), dtype=torch.float32, device=dev)


def make_population_round_step(loss_fn: Callable, params_template, *,
                               lr: float, acfg: agg_mod.AggregationConfig,
                               eta: float = 1.0, width: int = 0,
                               make_batches: Callable = None,
                               device="cuda") -> PopulationRoundStep:
    """Build the population (streaming-cohort) round for ``device``.

    The round is ``engine.make_round_body``, the body ``pop_scan`` replays
    (the same ops on the same ``[C, ...]`` slot shapes), but EF residuals
    arrive in the client store's layout and leave the same way::

        step(flat [n] f32,                 # UPDATED IN PLACE
             residuals,                    # topk_complement: (idx [C, W]
                                           #   int32, val [C, W] f32);
                                           # dense: [C, n] f32, UPDATED IN
                                           #   PLACE; no EF: [0] f32
             x: {"step_mask" [C, S] bool, "active" [C] bool,
                 "weights" [C] f32 (0 at inactive slots), "ks" [C] int,
                 + what ``make_batches`` reads (default "batches")})
        -> {"flat", "residuals" (the same layout), "loss", "overflow"}

    ``width`` is the static pair width of "topk_complement" strategies
    (``population.residual_width``: n - k_min). ``overflow`` (bool scalar)
    is True iff a row's residual outgrew the width; callers check it, the
    step never truncates. Inactive slots come back with their residuals
    unchanged, so the host scatters only the real cohort prefix.
    """
    spec = engine.spec_for(acfg, device)
    body = engine.make_round_body(loss_fn, params_template, lr=lr,
                                  spec=spec, eta=eta,
                                  make_batches=make_batches)
    ef = spec.needs_residuals
    layout = spec.strat.residual_layout if ef else None
    if layout == "topk_complement" and width <= 0:
        raise ValueError(
            f"{spec.strategy} persists residuals as topk_complement pairs — "
            "make_population_round_step needs width > 0 (n - k_min)")
    BUILD_COUNTS[("population", spec.strategy)] += 1

    def step(flat, residuals, x):
        # the body writes the new residuals into ``rows`` in place
        rows = (engine.densify_rows(*residuals, flat.shape[0])
                if layout == "topk_complement" else residuals)
        ys = body(flat, rows, x, False)
        out = {"flat": flat, "loss": ys["loss"], "residuals": residuals,
               "overflow": torch.zeros((), dtype=torch.bool,
                                       device=flat.device)}
        if layout == "topk_complement":
            idx, val, out["overflow"] = engine.sparsify_rows(rows, width)
            out["residuals"] = (idx, val)
        return out

    return PopulationRoundStep(step, spec, layout, width,
                               torch.device(device))
