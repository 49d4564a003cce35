"""Overlap-aware Parameter Weighted Averaging (paper §4.3, Alg. 3) — torch
port of ``repro.core.opwa``.

Degree of overlap of parameter j = number of selected clients whose
sparsified update retained index j. Indices with overlap in (0, D] get their
aggregated update scaled by the enlarge rate gamma; everything else by 1.
"""
from __future__ import annotations

from typing import Optional

import torch


def overlap_counts(masks: torch.Tensor) -> torch.Tensor:
    """masks: bool/int [K, n] (K clients) -> int32 counts [n]."""
    return masks.to(torch.int32).sum(dim=0, dtype=torch.int32)


def opwa_mask(counts: torch.Tensor, gamma: float, d: int = 1) -> torch.Tensor:
    """M[j] = gamma if 0 < counts[j] <= D else 1 (f32 [n])."""
    amplify = (counts > 0) & (counts <= d)
    one = torch.ones((), dtype=torch.float32, device=counts.device)
    return torch.where(amplify, one * float(gamma), one)


def weighted_sum(coeffs: torch.Tensor, updates: torch.Tensor) -> torch.Tensor:
    """``sum_k coeffs[k] * updates[k]`` over the client axis (the
    reference's ``einsum("k,kn->n")``), in float32."""
    return torch.einsum("k,kn->n", coeffs.to(torch.float32),
                        updates.to(torch.float32))


def opwa_aggregate(updates: torch.Tensor, masks: torch.Tensor,
                   coeffs: torch.Tensor, gamma: float,
                   d: int = 1) -> torch.Tensor:
    """OPWA aggregation of dense-masked client updates [K, n] with their
    masks and coefficients p'_i [K]: ``M ⊙ Σ_i p'_i u_i`` [n]."""
    m = opwa_mask(overlap_counts(masks), gamma, d)
    return m * weighted_sum(coeffs, updates)


def opwa_aggregate_traced_k(updates: torch.Tensor, ks: torch.Tensor,
                            coeffs: torch.Tensor, gamma: float, d: int = 1,
                            active: Optional[torch.Tensor] = None,
                            use_kernel: bool = False) -> torch.Tensor:
    """OPWA aggregation fused with traced-k Top-K selection (the paper's
    BCRS+OPWA hot path): updates [K, n] RAW flat client updates, ks [K]
    retained counts. Kernel route: ``threshold_find`` + ``fused_merge``
    (Hopper kernels on CUDA tensors, their twins on CPU tensors). Plain
    route: ``topk_compress_batch`` + ``opwa_aggregate``. ``active`` gates
    padded cohort rows out of the merge and the overlap counts."""
    if use_kernel:
        from repro_torch.kernels import ops as kops
        agg, _ = kops.megakernel_aggregate(
            updates, ks, coeffs, active=active, opwa=True,
            gamma=float(gamma), d=int(d))
        return agg
    from repro_torch.core.compression import topk_compress_batch
    c = topk_compress_batch(updates, ks)
    vals, mask = c.values, c.mask
    if active is not None:
        vals = vals * active[:, None]
        mask = mask & active[:, None]
    return opwa_aggregate(vals, mask, coeffs, gamma, d)
