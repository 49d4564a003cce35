"""Server aggregation (paper Alg. 1; torch port of ``repro.core.aggregation``):
the config, the host-side per-round schedule, client compression (the
per-client static-CR loop and the batched traced-k path) and the eager
``aggregate`` of the legacy engine.

The schedule (BCRS CRs, Eq. 6 coefficients, retained counts) is host f64
numpy, copied op for op from the reference so it is bit-identical. Everything
dispatches on registry capabilities and never matches strategy names.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import bcrs as bcrs_mod
from repro_torch.core import compression as comp
from repro_torch.core import opwa as opwa_mod
from repro_torch.core import strategies as strat_mod


@dataclass
class AggregationConfig:
    strategy: str = "fedavg"       # any name in core.strategies.names()
    cr: float = 0.1                # default/uniform compression ratio CR*
    alpha: float = 1.0             # server lr inside coefficients (Eq. 6)
    gamma: float = 5.0             # OPWA enlarge rate
    overlap_d: int = 1             # OPWA required degree of overlap
    block_topk: bool = False       # per-block Top-K instead of global
    block_size: int = 8192
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
    f64 (the reference's ``k_for_ratio`` per client; block mode: k per block
    of ``block_size``)."""
    base = acfg.block_size if acfg.block_topk else n
    return np.asarray([comp.k_for_ratio(base, float(c)) for c in crs],
                      np.int32)


def overlap_ks(acfg: AggregationConfig, info: dict, k: int, n: int
               ) -> np.ndarray:
    """Per-client GLOBAL top-k counts for the Fig. 4 overlap instrumentation:
    schedule CRs when the strategy has them, else the configured CR*."""
    crs_overlap = info.get("crs", np.full(k, acfg.cr))
    return np.asarray([comp.k_for_ratio(n, float(c)) for c in crs_overlap],
                      np.int32)


# ------------------------------------------------------- client compression
def _compress_fn(acfg: AggregationConfig):
    """Static-CR compressor ``(u [n], cr) -> Compressed`` of the per-client
    loop: block Top-K (its kernel on CUDA tensors under "auto") or exact
    global Top-K, then the strategy's value codec on a ``[1, n]`` view."""
    if acfg.block_topk:
        def base(u, cr):
            return comp.block_topk_compress(u, cr, block=acfg.block_size,
                                            use_kernel=acfg.use_kernel)
    else:
        base = comp.topk_compress
    codec = acfg.strat.value_codec
    if codec is None:
        return base

    def fn(u, cr):
        c = base(u, cr)
        # the codec contract is batched ([C, ...] leading client axis)
        return comp.Compressed(codec(c.values[None], c.mask[None])[0],
                               c.mask)

    return fn


def _compress_batch(updates: torch.Tensor, ks: torch.Tensor,
                    residuals: Optional[torch.Tensor], block: Optional[int],
                    codec=None):
    """Batched traced-k compression (global, or per block of ``block``),
    with EF when ``residuals`` are given -> (values, masks, new_res)."""
    if block is None:
        fn = comp.topk_compress_batch
    else:
        def fn(u, k_):
            return comp.block_topk_compress_batch(u, k_, block=block)
    if codec is not None:
        base = fn

        def fn(u, k_):
            c = base(u, k_)
            return comp.Compressed(codec(c.values, c.mask), c.mask)
    if residuals is None:
        c = fn(updates, ks)
        return c.values, c.mask, None
    c, new_res = comp.ef_compress_batch(residuals, updates, ks,
                                        compress_batch=fn)
    return c.values, c.mask, new_res


def compress_clients(updates: torch.Tensor, crs: np.ndarray,
                     acfg: AggregationConfig,
                     residuals: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor,
                                Optional[torch.Tensor]]:
    """updates [K, n] -> (values [K, n], masks [K, n], new_residuals), at
    per-client traced counts. Block Top-K on the kernel route keeps the
    per-client loop (the ``block_topk`` kernel takes a static k)."""
    if acfg.block_topk and comp.resolve_use_kernel(acfg.use_kernel,
                                                   updates.device):
        return compress_clients_loop(updates, crs, acfg, residuals)
    ks = torch.as_tensor(ks_for_schedule(updates.shape[1], crs, acfg),
                         device=updates.device)
    block = acfg.block_size if acfg.block_topk else None
    return _compress_batch(updates, ks, residuals, block,
                           acfg.strat.value_codec)


def compress_clients_loop(updates: torch.Tensor, crs: np.ndarray,
                          acfg: AggregationConfig,
                          residuals: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     Optional[torch.Tensor]]:
    """The legacy per-client loop of static-CR compressors: the route to
    the ``block_topk`` kernel, once per client."""
    fn = _compress_fn(acfg)
    vals, masks, new_res = [], [], []
    for i in range(updates.shape[0]):
        if residuals is not None:
            c, r = comp.ef_compress(residuals[i], updates[i], float(crs[i]),
                                    compress=fn)
            new_res.append(r)
        else:
            c = fn(updates[i], float(crs[i]))
        vals.append(c.values)
        masks.append(c.mask)
    return (torch.stack(vals), torch.stack(masks),
            torch.stack(new_res) if residuals is not None else None)


# ------------------------------------------------------------- eager rounds
def aggregate(updates: torch.Tensor, data_fracs: np.ndarray,
              acfg: AggregationConfig, links=None, v_bytes: float = 0.0,
              residuals: Optional[torch.Tensor] = None,
              use_loop: bool = False
              ) -> Tuple[torch.Tensor, dict, Optional[torch.Tensor]]:
    """One server aggregation of flat client updates [K, n] -> (agg [n],
    info, new_residuals). ``use_loop=True`` compresses through the
    per-client static-CR loop (the legacy engine); the default is the
    batched traced-k path. OPWA strategies merge through
    ``opwa_aggregate`` (the ``overlap_combine`` kernel on CUDA tensors
    under "auto")."""
    strat = acfg.strat
    k = updates.shape[0]
    crs, weights, info = round_schedule(acfg, k, data_fracs, links, v_bytes)
    coeffs = torch.as_tensor(np.asarray(weights, np.float32),
                             device=updates.device)
    if not strat.compresses:
        return opwa_mod.weighted_sum(coeffs, updates), info, None
    compress = compress_clients_loop if use_loop else compress_clients
    res = residuals if strat.needs_residuals else None
    vals, masks, new_res = compress(updates, crs, acfg, res)
    if strat.overlap_weighted:
        agg = opwa_mod.opwa_aggregate(vals, masks, coeffs, acfg.gamma,
                                      acfg.overlap_d,
                                      use_kernel=acfg.use_kernel)
    else:
        agg = opwa_mod.weighted_sum(coeffs, vals)
    return agg, info, new_res
