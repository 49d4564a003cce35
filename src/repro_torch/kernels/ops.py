"""Flat-space wrappers over the two kernels of the main path (torch port of
``repro.kernels.ops.topk_thresholds`` / ``megakernel_aggregate``).

The kernels mask their ragged edge themselves, so no padding happens here.
Each wrapper goes to the Hopper kernels for CUDA tensors and to their plain
twins for CPU tensors (``threshold_find`` / ``fused_merge`` decide by device).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.strategies import CODEC_LEVELS, quantization_scale
from repro_torch.kernels.fused_merge import fused_merge
from repro_torch.kernels.threshold_find import threshold_find


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def topk_thresholds(updates: torch.Tensor, ks: torch.Tensor,
                    residuals: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[C, n] updates + [C] retained counts -> exact per-client k-th-|.|
    bit-pattern thresholds int32 [C] (of ``residuals + updates`` when
    residuals are given). The Top-K mask is ``bits(|x|) >= thresholds``."""
    ks = ks.to(device=updates.device, dtype=torch.int32).contiguous()
    return threshold_find(_f32(updates), ks,
                          _f32(residuals) if residuals is not None else None)


def megakernel_aggregate(updates: torch.Tensor, ks: torch.Tensor,
                         weights: torch.Tensor,
                         residuals: Optional[torch.Tensor] = None,
                         active: Optional[torch.Tensor] = None, *,
                         opwa: bool = False, gamma: float = 1.0, d: int = 1,
                         codec: str = "none"
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Whole flat-space client merge through the two kernels:
    ``threshold_find`` then ``fused_merge``.

    updates [C, n] f32; ks [C] int; weights [C] f32; residuals optional
    [C, n] (EF arithmetic and the new-residual output); active optional bool
    [C] (padded-cohort gating); codec "none" | "int8" | "int4" (requires
    residuals). The codec scale is the row absmax that ``threshold_find``
    emits, put through the same ``quantization_scale`` as the value codec.

    Returns (agg [n] f32, new_residuals [C, n] | None).
    """
    dev = updates.device
    x = _f32(updates)
    e = _f32(residuals) if residuals is not None else None
    ks = ks.to(device=dev, dtype=torch.int32).contiguous()
    if codec == "none":
        th = threshold_find(x, ks, e)
        scales = None
    else:
        th, absmax = threshold_find(x, ks, e, emit_scale=True)
        scales = quantization_scale(absmax, CODEC_LEVELS[codec]).contiguous()
    act = (active.to(device=dev, dtype=torch.float32).contiguous()
           if active is not None else None)
    out = fused_merge(x, th, _f32(weights.to(dev)), e, act, opwa=opwa,
                      gamma=gamma, d=d, codec=codec, scales=scales)
    if residuals is None:
        return out, None
    return out
