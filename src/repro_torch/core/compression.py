"""Update compressors (torch port of ``repro.core.compression``): exact
traced-k Top-K by bit-pattern bisection, its batched and error-feedback
forms, and the flat <-> dict-of-tensor helpers.

The dense-masked representation (values kept, others zero + bool mask) is
the reference's. Bit patterns of ``|x|`` are compared on the ``int32`` view:
``abs`` clears the sign bit, so every pattern is a non-negative int32 and
orders exactly like the magnitudes (and like the reference's uint32 view).
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch


class Compressed(NamedTuple):
    values: torch.Tensor   # dense masked [..., n]
    mask: torch.Tensor     # bool [..., n]


# ---------------------------------------------------------------- tree utils
def flatten_tree(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """dict of tensors -> flat f32 [n] in sorted-key order — the order
    ``jax.tree.flatten`` gives a dict (``ravel_pytree``), so flat vectors,
    masks and thresholds line up coordinate for coordinate with the
    reference (the MLP ravels as b1, b2, b3, w1, w2, w3)."""
    return torch.cat([tree[k].reshape(-1).to(torch.float32)
                      for k in sorted(tree)])


def k_for_ratio(n: int, cr: float) -> int:
    """Host-side retained count for compression ratio ``cr`` over ``n``
    parameters: round(n·cr) clamped to [1, n] (Python ``round`` in f64, CR=1
    keeps everything exactly) — the reference's rule, unchanged."""
    return max(1, min(n, int(round(n * cr))))


def resolve_use_kernel(flag, device) -> bool:
    """``use_kernel`` tri-state, decided by the device the tensors live on:
    "auto" -> the Hopper kernels for CUDA tensors, the plain PyTorch path for
    CPU tensors; True -> the kernels, which exist only on CUDA (raises for a
    CPU device — it never quietly means the plain path); False -> the plain
    path."""
    dev = torch.device(device)
    if flag == "auto":
        return dev.type == "cuda"
    if flag is True and dev.type != "cuda":
        raise ValueError(
            "use_kernel=True needs CUDA tensors (the Hopper kernels); got "
            f"device {dev} — use 'auto' or False for the plain path")
    return bool(flag)


def magnitude_bits(x: torch.Tensor) -> torch.Tensor:
    """f32 bit pattern of ``|x|`` as non-negative int32."""
    return torch.abs(x.to(torch.float32)).view(torch.int32)


# ------------------------------------------------------------------- top-k
def topk_compress_dynamic(u: torch.Tensor, k) -> Compressed:
    """Top-K of each row of ``u`` [..., n] at per-row retained counts ``k``
    ([...], or a scalar): the reference's 32-halving bisection on the f32
    bit pattern of |u|. The mask is the exact ``|u| >= k-th largest``
    selection (ties kept). ``lo``/``hi`` live in int64: ``max + 1``
    overflows int32 when a row holds a NaN with a full payload."""
    bits = magnitude_bits(u).to(torch.int64)
    k = torch.as_tensor(k, device=u.device).to(torch.int64)
    hi = bits.amax(dim=-1) + 1       # invariant: count(bits >= hi) < k
    lo = torch.zeros_like(hi)        # invariant: count(bits >= lo) >= k
    for _ in range(32):
        mid = lo + ((hi - lo) >> 1)
        cnt = (bits >= mid.unsqueeze(-1)).sum(dim=-1)
        pred = cnt >= k
        lo, hi = torch.where(pred, mid, lo), torch.where(pred, hi, mid)
    mask = bits >= lo.unsqueeze(-1)
    return Compressed(torch.where(mask, u, torch.zeros_like(u)), mask)


def topk_compress_batch(updates: torch.Tensor, ks: torch.Tensor,
                        use_kernel: bool = False) -> Compressed:
    """Per-row traced-k Top-K: updates [C, n], ks int [C].
    ``use_kernel=True`` finds the thresholds through ``threshold_find``
    (the Hopper kernel for CUDA tensors, its plain twin for CPU tensors) and
    applies them in one more pass — the same masks and values."""
    if use_kernel:
        from repro_torch.kernels import ops as kops
        th = kops.topk_thresholds(updates, ks)
        mask = magnitude_bits(updates) >= th[:, None]
        return Compressed(torch.where(mask, updates,
                                      torch.zeros_like(updates)), mask)
    return topk_compress_dynamic(updates, ks)


def ef_compress_batch(residuals: torch.Tensor, updates: torch.Tensor,
                      ks: torch.Tensor,
                      compress_batch: Callable = topk_compress_batch
                      ) -> Tuple[Compressed, torch.Tensor]:
    """Batched EF-TopK: ``corrected = residuals + updates`` is compressed,
    ``corrected - sent`` becomes the new residual (the reference's
    arithmetic, elementwise bit-exact)."""
    corrected = residuals + updates
    comp = compress_batch(corrected, ks)
    return comp, corrected - comp.values
