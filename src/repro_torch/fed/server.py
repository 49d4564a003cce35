"""FL server (torch port of ``repro.fed.server``).

Holds the global model as one flat f32 buffer on the device (``params`` are
views into it), the per-client EF residuals, and the time accumulator. Two
round paths share that state and the host BCRS schedule:

  * ``round`` — the legacy eager engine: flattens per-client deltas,
    compresses them client by client (``aggregation.aggregate`` with
    ``use_loop=True``; the ``block_topk`` and ``overlap_combine`` kernels on
    the card) and applies ``w <- w - eta * agg``;
  * ``round_fused`` — one ``fed.round_step`` program for the whole round.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import aggregation as agg_mod
from repro_torch.core import bcrs as bcrs_mod
from repro_torch.core import cost_model
from repro_torch.core import strategies as strat_mod
from repro_torch.core.compression import flatten_tree
from repro_torch.fed.engine import make_unflatten


@dataclass
class FLServer:
    params: Dict[str, torch.Tensor]     # global model (views into the flat)
    acfg: agg_mod.AggregationConfig
    eta: float = 1.0                    # server learning rate on the update
    links: Optional[List[bcrs_mod.ClientLink]] = None
    times: cost_model.TimeAccumulator = field(
        default_factory=cost_model.TimeAccumulator)
    residuals: Optional[torch.Tensor] = None

    def __post_init__(self):
        self._unravel = make_unflatten(self.params)
        self.flat = flatten_tree(self.params)      # a fresh f32 buffer
        self.device = self.flat.device
        self.params = self._unravel(self.flat)
        self.n_params = int(self.flat.shape[0])
        self.v_bytes = float(self.n_params * 4)   # fp32 update bytes
        self._fused_step = None
        self._fused_step_overlap = None
        self._live = None     # the live cohort size of the last fused round

    # ------------------------------------------------------------------
    def _selected_links(self, selected):
        return ([self.links[i] for i in selected]
                if self.links is not None else None)

    def _account_time(self, info: dict, links) -> None:
        """Paper §5.2 metrics. The strategy's wire format prices the
        uploads: dense formats take ``uncompressed_round``; sparse formats
        map their schedule CRs through ``wire.cr_eff``."""
        if links is None:
            return
        wire = strat_mod.get(self.acfg.strategy).wire
        if wire.dense:
            rt = cost_model.uncompressed_round(links, self.v_bytes)
        else:
            crs = info.get("crs", np.ones(len(links)))
            rt = cost_model.round_times(links, self.v_bytes,
                                        wire.cr_eff(crs, self.n_params))
        self.times.add(rt)
        info["round_time"] = rt

    # ------------------------------------------------------------------
    def round(self, client_deltas: List[Dict[str, torch.Tensor]],
              data_fracs: np.ndarray, selected: np.ndarray) -> dict:
        """One legacy round: ``client_deltas`` is a list of per-client
        delta dicts (w_t - w_i), ``selected`` the client indices (for the
        link lookup). Residuals reset whenever the cohort size changes."""
        flat_updates = torch.stack([flatten_tree(d) for d in client_deltas])
        links = self._selected_links(selected)
        residuals = None
        if self.acfg.strat.needs_residuals:
            if (self.residuals is None
                    or self.residuals.shape[0] != flat_updates.shape[0]):
                self.residuals = torch.zeros_like(flat_updates)
            residuals = self.residuals
        agg, info, new_res = agg_mod.aggregate(
            flat_updates, data_fracs, self.acfg, links=links,
            v_bytes=self.v_bytes, residuals=residuals, use_loop=True)
        if self.acfg.strat.needs_residuals:
            self.residuals = new_res
        # in place, so self.params (views of self.flat) follow
        self.flat.sub_(self.eta * agg)
        self._account_time(info, links)
        return info

    # ------------------------------------------------------------------
    def init_fused(self, loss_fn: Callable, lr: float,
                   collect_overlap: bool = False) -> None:
        """Builds the fused round program (plus the Fig. 4 overlap
        variant on demand)."""
        from repro_torch.fed import round_step as rs
        self._fused_step = rs.make_round_step(
            loss_fn, self.params, lr=lr, acfg=self.acfg, eta=self.eta,
            device=self.device)
        if collect_overlap:
            self._fused_step_overlap = rs.make_round_step(
                loss_fn, self.params, lr=lr, acfg=self.acfg, eta=self.eta,
                with_overlap=True, device=self.device)

    def round_fused(self, batches, step_mask, data_fracs: np.ndarray,
                    selected: np.ndarray, want_overlap: bool = False) -> dict:
        """One fused round: ``batches`` is a dict of [C, S, ...] stacked
        client batches, ``step_mask`` [C, S] marks real local steps. C may
        exceed the live cohort ``selected``: the slots past it are padding
        (every step masked) that takes no part in the round — the scan
        engines' slot layout, so both engines run the same shapes. EF
        residuals live in a [C, n] buffer, reset whenever the live cohort's
        size changes (the reference's rule)."""
        if self._fused_step is None:
            raise RuntimeError("call init_fused(loss_fn, lr) first")
        slots, k = int(step_mask.shape[0]), len(selected)
        links = self._selected_links(selected)
        crs, weights, info = agg_mod.round_schedule(
            self.acfg, k, data_fracs, links, self.v_bytes)

        def slotted(values, fill, dtype):
            out = np.full((slots,), fill, dtype)
            out[:k] = values
            return torch.as_tensor(out, device=self.device)

        ks = slotted(agg_mod.ks_for_schedule(self.n_params, crs, self.acfg),
                     1, np.int32)
        if want_overlap:
            if self._fused_step_overlap is None:
                raise RuntimeError(
                    "round_fused(want_overlap=True) needs "
                    "init_fused(..., collect_overlap=True)")
            ks_overlap = slotted(
                agg_mod.overlap_ks(self.acfg, info, k, self.n_params), 1,
                np.int32)
        else:
            ks_overlap = ks    # ignored by the non-instrumented step

        residuals = None
        if self.acfg.strat.needs_residuals:
            if (self.residuals is None or self._live != k
                    or self.residuals.shape[0] != slots):
                self.residuals = torch.zeros((slots, self.n_params),
                                             dtype=torch.float32,
                                             device=self.device)
            residuals = self.residuals
        self._live = k

        step = self._fused_step_overlap if want_overlap else self._fused_step
        # the step updates self.flat (w <- w - eta*agg) and the residuals in
        # place, so self.params, which are views of the flat, follow
        out = step(self.flat, residuals, batches, step_mask,
                   slotted(weights, 0.0, np.float32), ks, ks_overlap,
                   slotted(True, False, bool))
        info["loss"] = out["loss"]
        if "overlap_counts" in out:
            info["overlap_counts"] = out["overlap_counts"]
        self._account_time(info, links)
        return info
