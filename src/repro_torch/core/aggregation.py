"""Server aggregation config and the host-side per-round schedule (torch port
of ``repro.core.aggregation``; the reference's block Top-K fields wait for
the blockwise compressor's port).

The schedule (BCRS CRs, Eq. 6 coefficients, retained counts) is host f64
numpy, copied op for op from the reference so it is bit-identical; it
dispatches on registry capabilities and never matches strategy names.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from repro_torch.core import bcrs as bcrs_mod
from repro_torch.core import compression as comp
from repro_torch.core import strategies as strat_mod


@dataclass
class AggregationConfig:
    strategy: str = "fedavg"       # any name in core.strategies.names()
    cr: float = 0.1                # default/uniform compression ratio CR*
    alpha: float = 1.0             # server lr inside coefficients (Eq. 6)
    gamma: float = 5.0             # OPWA enlarge rate
    overlap_d: int = 1             # OPWA required degree of overlap
    use_kernel: object = "auto"    # Hopper kernels: True | False | "auto"

    def __post_init__(self):
        strat_mod.get(self.strategy)   # config-time error, names listed

    @property
    def strat(self) -> strat_mod.Strategy:
        """The registered capability record for ``strategy``."""
        return strat_mod.get(self.strategy)


# ------------------------------------------------------------- host schedule
def round_schedule(acfg: AggregationConfig, k: int, data_fracs: np.ndarray,
                   links=None, v_bytes: float = 0.0
                   ) -> Tuple[np.ndarray, np.ndarray, dict]:
    """Host-side per-round schedule: (crs [k], agg weights [k], info).

    Non-compressing strategies get all-ones CRs with data-fraction weights
    (and no "crs" info key, so time accounting takes the dense route);
    "data"-weighted compressors get the uniform CR*; "bcrs"-weighted ones
    get the bandwidth schedule's CRs and Eq. 6 coefficients.
    """
    strat = acfg.strat
    info: dict = {"strategy": acfg.strategy}
    f = np.asarray(data_fracs, np.float64)
    if not strat.compresses:
        return np.ones((k,)), f, info
    if strat.weighting == "data":
        crs = np.full((k,), acfg.cr)
        info["crs"] = crs
        return crs, f, info
    if links is None or v_bytes <= 0:
        raise ValueError("BCRS needs link models and v_bytes > 0")
    sched = bcrs_mod.make_schedule(links, f, v_bytes, acfg.cr, acfg.alpha)
    info["crs"] = sched.crs
    info["coefficients"] = sched.coefficients
    info["t_bench"] = sched.t_bench
    return sched.crs, sched.coefficients, info


def ks_for_schedule(n: int, crs: np.ndarray, acfg: AggregationConfig
                    ) -> np.ndarray:
    """Per-client retained counts for the traced-k compressors, on host in
    f64 (the reference's ``k_for_ratio`` per client)."""
    return np.asarray([comp.k_for_ratio(n, float(c)) for c in crs], np.int32)


def overlap_ks(acfg: AggregationConfig, info: dict, k: int, n: int
               ) -> np.ndarray:
    """Per-client GLOBAL top-k counts for the Fig. 4 overlap instrumentation:
    schedule CRs when the strategy has them, else the configured CR*."""
    crs_overlap = info.get("crs", np.full(k, acfg.cr))
    return np.asarray([comp.k_for_ratio(n, float(c)) for c in crs_overlap],
                      np.int32)
