"""FL server for the fused round (torch port of ``repro.fed.server``).

Holds the global model as one flat f32 buffer on the device (``params`` are
views into it), the per-client EF residuals, and the time accumulator. Each
``round_fused`` runs one ``fed.round_step`` program. The reference's legacy
eager ``round`` is not ported yet (ROADMAP queue 1 item 4).
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
        client batches, ``step_mask`` [C, S] marks real local steps."""
        if self._fused_step is None:
            raise RuntimeError("call init_fused(loss_fn, lr) first")
        k = int(step_mask.shape[0])
        links = self._selected_links(selected)
        crs, weights, info = agg_mod.round_schedule(
            self.acfg, k, data_fracs, links, self.v_bytes)
        ks = torch.as_tensor(agg_mod.ks_for_schedule(self.n_params, crs,
                                                     self.acfg),
                             device=self.device)
        if want_overlap:
            if self._fused_step_overlap is None:
                raise RuntimeError(
                    "round_fused(want_overlap=True) needs "
                    "init_fused(..., collect_overlap=True)")
            ks_overlap = torch.as_tensor(
                agg_mod.overlap_ks(self.acfg, info, k, self.n_params),
                device=self.device)
        else:
            ks_overlap = ks    # ignored by the non-instrumented step

        residuals = None
        if self.acfg.strat.needs_residuals:
            # reset whenever the cohort size changes (the reference's rule)
            if self.residuals is None or self.residuals.shape[0] != k:
                self.residuals = torch.zeros((k, self.n_params),
                                             dtype=torch.float32,
                                             device=self.device)
            residuals = self.residuals

        step = self._fused_step_overlap if want_overlap else self._fused_step
        w = torch.as_tensor(np.asarray(weights, np.float32),
                            device=self.device)
        # the step updates self.flat in place (w <- w - eta*agg), so
        # self.params, which are views of it, follow without a copy
        out = step(self.flat, residuals, batches, step_mask, w, ks,
                   ks_overlap)
        if self.acfg.strat.needs_residuals:
            self.residuals = out["residuals"]
        info["loss"] = out["loss"]
        if "overlap_counts" in out:
            info["overlap_counts"] = out["overlap_counts"]
        self._account_time(info, links)
        return info
