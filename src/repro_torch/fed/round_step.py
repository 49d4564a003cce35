"""Fused FL round (torch port of ``repro.fed.round_step.make_round_step``).

One call runs the whole round on the device: local SGD for the cohort at
once (``engine.make_masked_local_trainer``), traced-k compression, EF,
codec, the OPWA merge (the two Hopper kernels when kernels are on) and the
server update. Per-round scalars (CRs, Eq. 6 coefficients, retained counts)
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
from repro_torch.core import compression as comp
from repro_torch.core import opwa as opwa_mod
from repro_torch.fed import engine

#: (strategy, with_overlap) -> number of round programs built
BUILD_COUNTS: collections.Counter = collections.Counter()


def make_round_step(loss_fn: Callable, params_template, *, lr: float,
                    acfg: agg_mod.AggregationConfig, eta: float = 1.0,
                    with_overlap: bool = False, device="cuda") -> Callable:
    """Build the fused round program for ``device``.

    Returned step signature::

        step(flat [n] f32,            # global model, ravel order; UPDATED
                                      # IN PLACE (w <- w - eta*agg)
             residuals [C, n] | None, # EF state (EF strategies)
             batches,                 # dict of [C, S, ...] stacked batches
             step_mask [C, S] bool,   # padded-step validity
             weights [C] f32,         # data fracs or Eq. 6 coefficients
             ks [C] int,              # retained count per client
             ks_overlap [C] int)      # Fig. 4 top-k counts (overlap variant)
        -> {"flat", "residuals", "loss"[, "overlap_counts"]}
    """
    spec = engine.spec_for(acfg, device)
    unflatten = engine.make_unflatten(params_template)
    local_train = engine.make_masked_local_trainer(loss_fn, lr)
    BUILD_COUNTS[(spec.strategy, with_overlap)] += 1

    def step(flat, residuals, batches, step_mask, weights, ks, ks_overlap):
        deltas, losses = local_train(unflatten(flat), batches, step_mask)
        updates = engine.flatten_client_trees(deltas)   # [C, n] f32
        agg, new_res = engine.aggregate_updates(
            spec, updates, weights, ks, residuals=residuals)
        # in place: the server's flat buffer is the model, and the params it
        # hands out are views of it; nothing else holds the old values
        flat.sub_(eta * agg)
        out = {"flat": flat, "residuals": new_res, "loss": losses.mean()}
        if with_overlap:
            # Fig. 4 instrumentation: global top-k masks on the RAW deltas
            masks_o = comp.topk_compress_batch(
                updates, ks_overlap, use_kernel=spec.use_kernel).mask
            out["overlap_counts"] = opwa_mod.overlap_counts(masks_o)
        return out

    return step
