"""The real-model FL round (torch port of ``repro.fed.mesh_round``): local
SGD for the cohort, per-leaf traced-k compression with EF residuals, the
OPWA / weighted merge and the server update, leaf by leaf.

``make_round_body`` assembles ONE round from the per-leaf substrate of
``fed.engine`` (``make_model_local_trainer`` + ``compress_merge_leaf``;
every selection has ``core.compression.topk_compress_dynamic``'s semantics,
and on CUDA tensors under ``use_kernel="auto"`` each leaf goes through the
Hopper kernels ``threshold_find`` + ``fused_merge`` on a ``[C, leaf_n]``
view). ``make_mesh_round_step`` is one round a call, the reference's
``fl_train --engine round`` path and the bit-parity reference of the mesh
scan (``engine.make_mesh_sim_scan``: on the card one captured CUDA graph
of the body a round); ``make_population_round_step`` runs the body on EF
residuals in the client store's wire layout (``fl_train --population``);
``make_fl_round_step`` is the single-round convenience surface over the
same body.

The port runs on one card, so the reference's TP layout and sharding
constraints have no counterpart: a leaf keeps its natural ``[*shape]``
layout (a stacked ``[L, ...]`` layer leaf included) and selection runs over
the whole leaf per client. Per-leaf retained counts come from the shared
``k_for_ratio_traced`` rule, so the host scheduler and the round agree.
"""
from __future__ import annotations

import collections
from typing import Callable

import numpy as np
import torch

from repro_torch.core import compression as comp
from repro_torch.core import opwa as opwa_mod
from repro_torch.core import strategies as strat_mod
from repro_torch.dist import sharding as shd
from repro_torch.fed.engine import (compress_merge_leaf, densify_rows,
                                    flatten_client_trees,
                                    make_model_local_trainer, make_unflatten,
                                    sparsify_rows, tree_from_items,
                                    tree_items)

#: (strategy,) -> round steps built by ``make_mesh_round_step``, and
#: ("population", strategy) -> those built by ``make_population_round_step``
#: (the reference counts traces of its jitted steps: one per step, however
#: many rounds it runs). The mesh scan's captures are counted in
#: ``engine.TRACE_COUNTS``.
TRACE_COUNTS: collections.Counter = collections.Counter()


def make_round_body(loss_fn: Callable, *, lr_local: float = 1e-2,
                    eta: float = 1.0, strategy: str = "bcrs_opwa",
                    gamma: float = 5.0, overlap_d: int = 1,
                    use_kernel="auto", inplace: bool = False,
                    skip_masked: bool = True) -> Callable:
    """One real-model FL round.

    Returns ``body(params, residuals, batches, step_mask, coeffs, crs,
    active) -> (new_params, new_residuals, loss)``:

      params      nested dict of tensors (leaves keep their dtypes);
      residuals   per-leaf EF dict ([C, *leaf] f32) — required iff the
                  registered strategy carries EF, None otherwise;
      batches     dict of [C, S, ...] tensors (C cohort slots);
      step_mask   bool [C, S] — padded local steps are exact no-ops;
      coeffs      f32 [C] merge weights, 0 at padded slots;
      crs         f32 [C] per-client compression ratios (per-leaf retained
                  counts are ``k_for_ratio_traced(leaf_n, crs)``);
      active      optional bool [C] — padded cohort slots contribute
                  nothing to the merge, the overlap counts, the loss or the
                  residual update. None means every slot is real.

    The server update is ``(p.f32 - eta * agg).astype(p.dtype)`` per leaf.
    With ``inplace`` the params' and residuals' tensors are overwritten and
    returned (the reference donates them); otherwise new tensors come back.
    ``skip_masked`` picks the local trainer's route
    (``engine.make_model_local_trainer``): masked steps skipped on the host,
    or, for a CUDA graph, every step run and its result discarded where
    masked; the two give the same bits. Leaves are merged one at a time
    and each leaf's deltas are freed once merged, so a round holds the C
    deltas, one leaf's f32 view and the merge's outputs. The loss is the
    active-masked mean of each client's last real local step's pre-update
    loss. Under the multi-card layout (DTensor params: the ``fl_round``
    cell of ``launch.specs``) each leaf's C deltas are brought whole to
    every rank before its merge (the kernels take raw pointers, and a
    client's Top-K is a selection over the whole leaf;
    ``sharding.leaf_whole``), and the update goes back to the param's
    layout."""
    strat = strat_mod.get(strategy)   # config-time error, names listed
    ef = strat.needs_residuals
    compress = strat.compresses
    opwa = strat.overlap_weighted
    value_codec = strat.value_codec
    kernel_codec = strat.kernel_codec
    local_train = make_model_local_trainer(loss_fn, lr_local,
                                           skip_masked=skip_masked)

    def merge_leaf(dl, res, w, crs, active):
        if not compress:
            dl32 = dl.to(torch.float32)
            if active is not None:
                dl32 = dl32 * active.reshape((-1,) + (1,) * (dl32.dim() - 1))
            return opwa_mod.weighted_sum(w, dl32), res
        n = dl[0].numel()
        ks = comp.k_for_ratio_traced(n, crs)
        return compress_merge_leaf(
            dl, w, ks, gamma=gamma, overlap_d=overlap_d, opwa=opwa,
            use_kernel=use_kernel, residuals=res, active=active,
            value_codec=value_codec, kernel_codec=kernel_codec)

    def body(params, residuals, batches, step_mask, coeffs, crs, active):
        with shd.layout_context(params):
            return _body(params, residuals, batches, step_mask,
                         shd.full(coeffs), shd.full(crs), active)

    def _body(params, residuals, batches, step_mask, coeffs, crs, active):
        if ef and residuals is None:
            raise ValueError(f"{strategy} needs per-leaf residuals")
        deltas, losses = local_train(params, batches, step_mask)
        dev = losses.device
        w = coeffs.to(device=dev, dtype=torch.float32)
        crs = crs.to(device=dev)
        if active is not None:
            active = active.to(device=dev, dtype=torch.bool)
            w = torch.where(active, w, torch.zeros_like(w))
        p_items = tree_items(params)
        d_items = [d for _, d in tree_items(deltas)]
        r_items = ([r for _, r in tree_items(residuals)] if ef
                   else [None] * len(p_items))
        del deltas
        new_p, new_r = [], []
        for i, (path, p) in enumerate(p_items):
            dl, d_items[i] = d_items[i], None   # freed once merged
            # under the layout the leaf is merged whole (sharding.leaf_whole)
            agg, res = shd.leaf_whole(
                lambda d, r: merge_leaf(d, r, w, crs, active),
                (dl, r_items[i]), (p, r_items[i]))
            del dl
            upd = (p.to(torch.float32) - eta * agg).to(p.dtype)
            del agg
            if inplace:
                p.copy_(upd)
                upd = p
                if ef:
                    r_items[i].copy_(res)
                    res = r_items[i]
            new_p.append((path, upd))
            new_r.append((path, res))
        new_params = tree_from_items(new_p)
        new_res = tree_from_items(new_r) if ef else residuals
        if active is None:
            loss = torch.mean(losses)
        else:
            n_act = active.to(torch.int32).sum().clamp_min(1)
            loss = torch.where(active, losses,
                               torch.zeros_like(losses)).sum() / n_act
        return new_params, new_res, loss

    return body


def make_mesh_round_step(loss_fn: Callable, *, lr_local: float = 1e-2,
                         eta: float = 1.0, strategy: str = "bcrs_opwa",
                         gamma: float = 5.0, overlap_d: int = 1,
                         use_kernel="auto", donate: bool = True) -> Callable:
    """One round a call over ``make_round_body`` — the ``fl_train --engine
    round`` path: ``step(params, residuals, batches, step_mask, coeffs,
    crs, active) -> (params, residuals, loss)``. The params' and
    residuals' tensors are updated in place and returned (the reference
    donates them; at full width a second copy of the EF state would not
    fit); ``donate=False`` leaves the inputs untouched for callers that
    reuse them, e.g. parity tests. Building a step counts one in
    ``TRACE_COUNTS[(strategy,)]``."""
    body = make_round_body(loss_fn, lr_local=lr_local, eta=eta,
                           strategy=strategy, gamma=gamma,
                           overlap_d=overlap_d, use_kernel=use_kernel,
                           inplace=donate)
    TRACE_COUNTS[(strategy,)] += 1

    return body


def mesh_residual_width(params_template, cr_min: float) -> int:
    """Sparse-pair width for the population step's EF residuals: the
    per-leaf Top-K keeps at least ``k_for_ratio_traced(leaf_n, cr)``
    elements of every leaf, so a client's whole-model residual has at most
    ``sum_l (leaf_n - k_l)`` nonzeros at the plan's smallest cr. The device
    rounds k in f32 where the host would in f64, so each leaf's bound is
    slacked by one survivor (the reference's rule, a few spare columns)."""
    n_total, k_total = 0, 0
    for _, leaf in tree_items(params_template):
        ln = int(leaf.numel())
        n_total += ln
        k_total += max(1, min(ln, int(np.floor(ln * cr_min)) - 1))
    return max(1, n_total - k_total)


def make_population_round_step(loss_fn: Callable, params_template, *,
                               lr_local: float = 1e-2, eta: float = 1.0,
                               strategy: str = "bcrs_opwa",
                               gamma: float = 5.0, overlap_d: int = 1,
                               use_kernel="auto", width: int = 0,
                               donate: bool = True) -> Callable:
    """``make_round_body`` with the EF residuals in the client store's wire
    layout instead of a resident per-leaf carry (the per-leaf twin of
    ``round_step.make_population_round_step``)::

        step(params, res_wire, batches, step_mask, coeffs, crs, active)
          -> (new_params, new_res_wire, loss, overflow)

    ``res_wire`` is ``(idx [C, W] int32, val [C, W] f32)`` for
    "topk_complement" strategies (``width`` from ``mesh_residual_width``),
    a dense ``[C, n]`` f32 matrix for "dense"-layout EF strategies, and a
    ``[0]`` placeholder without EF (passed through). The rows are densified
    to ``[C, n]``, viewed per leaf as ``[C, *leaf]``, run through the
    body, then flattened and sparsified again; ``overflow`` (bool scalar)
    is True iff a row outgrew the width. With ``donate`` the params and
    the densified rows are updated in place. Building a step counts one in
    ``TRACE_COUNTS[("population", strategy)]``."""
    strat = strat_mod.get(strategy)
    ef = strat.needs_residuals
    layout = strat.residual_layout if ef else None
    if layout == "topk_complement" and width <= 0:
        raise ValueError(f"{strategy}: topk_complement wire layout needs "
                         "width > 0 (use mesh_residual_width)")
    body = make_round_body(loss_fn, lr_local=lr_local, eta=eta,
                           strategy=strategy, gamma=gamma,
                           overlap_d=overlap_d, use_kernel=use_kernel,
                           inplace=donate)
    items = tree_items(params_template)
    unflatten_rows = make_unflatten(tree_from_items(
        (path, torch.empty(leaf.shape, dtype=torch.float32, device="meta"))
        for path, leaf in items))
    n_total = sum(int(leaf.numel()) for _, leaf in items)
    TRACE_COUNTS[("population", strategy)] += 1

    def step(params, res_wire, batches, step_mask, coeffs, crs, active):
        rows = (densify_rows(*res_wire, n_total)
                if layout == "topk_complement" else res_wire)
        res_tree = unflatten_rows(rows) if ef else None
        new_params, new_res_tree, loss = body(
            params, res_tree, batches, step_mask, coeffs, crs, active)
        overflow = torch.zeros((), dtype=torch.bool, device=loss.device)
        if layout == "topk_complement":
            idx, val, overflow = sparsify_rows(
                flatten_client_trees(new_res_tree), width)
            new_wire = (idx, val)
        elif ef:
            new_wire = flatten_client_trees(new_res_tree)
        else:
            new_wire = res_wire
        return new_params, new_wire, loss, overflow

    return step


def make_fl_round_step(model, *, lr_local: float = 1e-2, eta: float = 1.0,
                       gamma: float = 5.0, overlap_d: int = 1,
                       compress: bool = True, use_kernel="auto") -> Callable:
    """``fl_round(params, client_batches, coeffs, crs) -> (new_params,
    loss)`` — the single-round convenience surface (full cohort, every
    step, no EF) over ``make_round_body``: bcrs_opwa when ``compress``,
    fedavg otherwise. client_batches: dict of [C, n_steps, ...]; coeffs
    [C] BCRS p'_i; crs [C] f32 per-client compression ratios."""
    body = make_round_body(model.loss_fn, lr_local=lr_local, eta=eta,
                           strategy="bcrs_opwa" if compress else "fedavg",
                           gamma=gamma, overlap_d=overlap_d,
                           use_kernel=use_kernel)

    def fl_round(params, client_batches, coeffs, crs):
        first = next(iter(client_batches.values()))
        c, s = first.shape[:2]
        step_mask = torch.ones((c, s), dtype=torch.bool)
        new_params, _, loss = body(params, None, client_batches, step_mask,
                                   coeffs, crs, None)
        return new_params, loss

    return fl_round
