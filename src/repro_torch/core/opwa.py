"""Overlap-aware Parameter Weighted Averaging (paper §4.3, Alg. 3) — torch
port of ``repro.core.opwa``.

Degree of overlap of parameter j = number of selected clients whose
sparsified update retained index j. Indices with overlap in (0, D] get their
aggregated update scaled by the enlarge rate gamma; everything else by 1.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.compression import resolve_use_kernel


def overlap_counts(masks: torch.Tensor) -> torch.Tensor:
    """masks: bool/int [K, n] (K clients) -> int32 counts [n]."""
    return masks.to(torch.int32).sum(dim=0, dtype=torch.int32)


def opwa_mask(counts: torch.Tensor, gamma: float, d: int = 1) -> torch.Tensor:
    """M[j] = gamma if 0 < counts[j] <= D else 1 (f32 [n])."""
    amplify = (counts > 0) & (counts <= d)
    one = torch.ones((), dtype=torch.float32, device=counts.device)
    return torch.where(amplify, one * float(gamma), one)


def weighted_sum(coeffs: torch.Tensor, updates: torch.Tensor) -> torch.Tensor:
    """``sum_k coeffs[k] * updates[k]`` over the client axis of
    ``[K, *shape]`` updates, in float32: the reference's
    ``einsum("k,kn->n")`` on flat ``[K, n]``, its ``tensordot`` over the
    first axis on any other rank."""
    c, u = coeffs.to(torch.float32), updates.to(torch.float32)
    if u.dim() == 2:
        return torch.einsum("k,kn->n", c, u)
    return torch.tensordot(c, u, dims=([0], [0]))


def overlap_histogram(masks: torch.Tensor,
                      k_max: Optional[int] = None) -> torch.Tensor:
    """Counts-of-counts for the paper's Fig. 4 (degree-of-overlap
    distribution): int32 [k_max + 1], degree d at index d. Degrees above
    ``k_max`` (default: the number of clients) are dropped, as
    ``jnp.bincount(length=)`` drops them; ``torch.bincount(minlength=)``
    keeps them, so the result is cut to length."""
    counts = overlap_counts(masks)
    k_max = k_max or masks.shape[0]
    hist = torch.bincount(counts.reshape(-1).to(torch.int64),
                          minlength=k_max + 1)
    return hist[: k_max + 1].to(torch.int32)


def opwa_aggregate(updates: torch.Tensor, masks: torch.Tensor,
                   coeffs: torch.Tensor, gamma: float, d: int = 1,
                   use_kernel="auto") -> torch.Tensor:
    """OPWA aggregation of dense-masked client updates [K, *shape] with
    their masks and coefficients p'_i [K]: ``M ⊙ Σ_i p'_i u_i`` [*shape]
    (rank-agnostic, as the reference). With ``use_kernel`` resolved true for
    the updates' device, flat ``[K, n]`` inputs go through the
    ``overlap_combine`` kernel (one pass)."""
    if resolve_use_kernel(use_kernel, updates.device) and updates.dim() == 2:
        from repro_torch.kernels import ops as kops
        return kops.overlap_combine(updates, masks, coeffs, gamma, d)
    m = opwa_mask(overlap_counts(masks), gamma, d)
    return m * weighted_sum(coeffs, updates)


def opwa_aggregate_traced_k(updates: torch.Tensor, ks: torch.Tensor,
                            coeffs: torch.Tensor, gamma: float, d: int = 1,
                            active: Optional[torch.Tensor] = None,
                            use_kernel="auto") -> torch.Tensor:
    """OPWA aggregation fused with traced-k Top-K selection (the paper's
    BCRS+OPWA hot path): updates [K, n] RAW flat client updates, ks [K]
    retained counts. Kernel route: ``threshold_find`` + ``fused_merge``
    (Hopper kernels on CUDA tensors, their twins on CPU tensors). Plain
    route: ``topk_compress_batch`` + ``opwa_aggregate``. ``use_kernel``:
    "auto" takes the kernel route for CUDA tensors and the plain route for
    CPU tensors; True the kernel route (the twins on CPU tensors); False the
    plain route. ``active`` gates padded cohort rows out of the merge and
    the overlap counts."""
    if (updates.device.type == "cuda" if use_kernel == "auto"
            else use_kernel):
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
    return opwa_aggregate(vals, mask, coeffs, gamma, d, use_kernel=False)


def bcrs_aggregate(updates: torch.Tensor, coeffs: torch.Tensor
                   ) -> torch.Tensor:
    """BCRS-only aggregation (uniform parameter weights): the Eq. 6
    weighted sum of flat client updates [K, n] -> [n] f32."""
    return weighted_sum(coeffs, updates)
