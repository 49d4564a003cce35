"""Fused FL round (torch port of ``repro.fed.round_step.make_round_step``).

One call runs the whole round on the device: local SGD for the cohort at
once (``engine.make_masked_local_trainer``), traced-k compression, EF,
codec, the OPWA merge (the two Hopper kernels when kernels are on) and the
server update — ``engine.make_round_body``, the body the scan engines
replay too. Per-round scalars (CRs, Eq. 6 coefficients, retained counts)
stay host-scheduled numpy and enter as tensors.

PyTorch runs eagerly, so there is no trace to count; ``BUILD_COUNTS`` counts
how many round programs were built per (strategy, with_overlap), the
counterpart of the reference's ``TRACE_COUNTS``: a simulation builds each
once, however many rounds it runs.
"""
from __future__ import annotations

import collections
from typing import Callable

import torch

from repro_torch.core import aggregation as agg_mod
from repro_torch.fed import engine

#: (strategy, with_overlap) -> number of round programs built
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
