"""Update compressors (torch port of ``repro.core.compression``): exact
global Top-K, block Top-K (exact per block, or the ``block_topk`` kernel),
exact traced-k Top-K by bit-pattern bisection, their batched and
error-feedback forms, Rand-K and stochastic quantization (drawn from a
``torch.Generator``: their own stream, not ``jax.random``'s), the
``to_sparse`` / ``from_sparse`` wire format, and the flat <-> dict-of-tensor
helpers.

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


def _sorted_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in _sorted_leaves(tree[k], prefix + (k,))]
    return [(prefix, tree)]


def ravel_tree(tree) -> Tuple[torch.Tensor, Callable]:
    """Nested dict of tensors -> ``(flat [n], unravel)``, the contract of
    ``jax.flatten_util.ravel_pytree`` (the reference's ``flatten_tree``):
    leaves in sorted-key order at every level, cast to their promoted
    dtype, so an all-bf16 tree gives a bf16 vector and a tree that mixes
    bf16 and f32 an f32 one. With one leaf dtype ``unravel`` keeps the
    dtype of the vector it is given; with several it takes only the
    promoted dtype and casts each leaf back to its own."""
    leaves = _sorted_leaves(tree)
    dtypes = [leaf.dtype for _, leaf in leaves]
    to = dtypes[0]
    for dt in dtypes[1:]:
        to = torch.promote_types(to, dt)
    uniform = all(dt == to for dt in dtypes)
    flat = torch.cat([leaf.reshape(-1).to(to) for _, leaf in leaves])
    specs = [(path, tuple(leaf.shape), leaf.numel(), leaf.dtype)
             for path, leaf in leaves]

    def unravel(vec: torch.Tensor):
        if not uniform and vec.dtype != to:
            raise TypeError(f"unravel function given array of dtype "
                            f"{vec.dtype} but expected dtype {to}")
        out: Dict = {}
        off = 0
        for path, shape, size, dtype in specs:
            leaf = vec[off:off + size].reshape(shape)
            off += size
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = leaf if uniform else leaf.to(dtype)
        return out

    return flat, unravel


def k_for_ratio(n: int, cr: float) -> int:
    """Host-side retained count for compression ratio ``cr`` over ``n``
    parameters: round(n·cr) clamped to [1, n] (Python ``round`` in f64, CR=1
    keeps everything exactly) — the reference's rule, unchanged."""
    return max(1, min(n, int(round(n * cr))))


def k_for_ratio_traced(n: int, crs: torch.Tensor) -> torch.Tensor:
    """Device twin of ``k_for_ratio`` for per-client CRs held in a tensor:
    crs (any shape) -> int32 retained counts by the same
    clip(round(cr·n), 1, n) rule, rounded in f32 (half to even, as
    ``jnp.round``) where the host rounds in f64 — the reference's traced
    twin, op for op."""
    return torch.clamp(torch.round(crs.to(torch.float32) * n)
                       .to(torch.int32), 1, n)


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
def _flushed_magnitude(u: torch.Tensor) -> torch.Tensor:
    """``|u|`` in f32 with denormals read as zero. The reference's exact
    routes compare ``|u| >= threshold`` on platforms that treat denormal
    operands as zero (XLA on the CPU, the TPU); flushing the magnitudes
    first gives the same masks (an all-denormal row keeps everything)."""
    mag = torch.abs(u.to(torch.float32))
    return torch.where(mag < torch.finfo(torch.float32).tiny,
                       torch.zeros_like(mag), mag)


def _topk_mask(mag: torch.Tensor, k: int) -> torch.Tensor:
    """Exact per-row Top-K mask of ``mag`` [..., n]: ``mag >= k-th
    largest`` (ties kept; a NaN counts as the largest, as in
    ``lax.top_k``, and is itself never kept)."""
    thresh = torch.topk(mag, k, dim=-1).values[..., -1:]
    return mag >= thresh


def topk_compress(u: torch.Tensor, cr: float) -> Compressed:
    """Exact global magnitude Top-K of a flat ``u`` [n] at the static ratio
    ``cr`` (ties kept)."""
    mask = _topk_mask(_flushed_magnitude(u), k_for_ratio(u.shape[0], cr))
    return Compressed(torch.where(mask, u, torch.zeros_like(u)), mask)


def block_topk_compress(u: torch.Tensor, cr: float, block: int = 8192,
                        use_kernel="auto") -> Compressed:
    """Per-block magnitude Top-K of a flat ``u`` [n]: zero-padded to a block
    multiple, each ``block``-wide tile keeps its top ``k_for_ratio(block,
    cr)``. The kernel route (``use_kernel`` resolved for ``u``'s device) is
    ``ops.block_topk`` — the reference kernel's value bisection, which
    differs from this exact selection only on NaN, inf, or a dynamic range
    above 2^40 inside one block."""
    if resolve_use_kernel(use_kernel, u.device):
        from repro_torch.kernels import ops as kops
        return kops.block_topk(u, cr, block=block)
    n = u.shape[0]
    ub = torch.nn.functional.pad(u, (0, (-n) % block)).reshape(-1, block)
    mask = _topk_mask(_flushed_magnitude(ub), k_for_ratio(block, cr))
    vals = torch.where(mask, ub, torch.zeros_like(ub))
    return Compressed(vals.reshape(-1)[:n], mask.reshape(-1)[:n])


def topk_compress_dynamic(u: torch.Tensor, k, n_iters: int = 32
                          ) -> Compressed:
    """Top-K of each row of ``u`` [..., n] at per-row retained counts ``k``
    ([...], or a scalar): the reference's bisection on the f32 bit pattern
    of |u|, ``n_iters`` halvings (32 pin the exact threshold). The mask is
    then the exact ``|u| >= k-th largest`` selection (ties kept). ``lo`` and
    ``hi`` live in int64, since ``max + 1`` overflows int32 when a row holds
    a NaN with a full payload; the patterns stay int32 (``abs`` clears the
    sign bit), and every ``mid`` lies below ``hi <= 2^31``, so it compares
    against them in int32 exactly."""
    bits = magnitude_bits(u)
    k = torch.as_tensor(k, device=u.device).to(torch.int64)
    hi = bits.amax(dim=-1).to(torch.int64) + 1   # count(bits >= hi) < k
    lo = torch.zeros_like(hi)                    # count(bits >= lo) >= k
    for _ in range(n_iters):
        mid = lo + ((hi - lo) >> 1)
        cnt = (bits >= mid.to(torch.int32).unsqueeze(-1)).sum(dim=-1)
        pred = cnt >= k
        lo, hi = torch.where(pred, mid, lo), torch.where(pred, hi, mid)
    mask = bits >= lo.to(torch.int32).unsqueeze(-1)
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


def block_topk_compress_batch(updates: torch.Tensor, ks_block: torch.Tensor,
                              block: int = 8192) -> Compressed:
    """Per-row blockwise Top-K at traced counts: client ``i`` keeps its top
    ``ks_block[i]`` entries of every ``block``-wide tile of its zero-padded
    row (the exact bisection of ``topk_compress_dynamic``)."""
    c, n = updates.shape
    ub = torch.nn.functional.pad(updates, (0, (-n) % block)).reshape(
        c, -1, block)
    ks = torch.as_tensor(ks_block, device=updates.device).reshape(c, 1)
    comp = topk_compress_dynamic(ub, ks.expand(c, ub.shape[1]))
    return Compressed(comp.values.reshape(c, -1)[:, :n],
                      comp.mask.reshape(c, -1)[:, :n])


def randk_compress(u: torch.Tensor, cr: float,
                   generator: torch.Generator) -> Compressed:
    """Unbiased Rand-K of a flat ``u`` [n]: ``k_for_ratio(n, cr)`` distinct
    coordinates drawn uniformly from ``generator`` (the order of a uniform
    draw's argsort), kept and rescaled by n/k."""
    n = u.shape[0]
    k = k_for_ratio(n, cr)
    idx = torch.rand(n, generator=generator,
                     device=generator.device).argsort()[:k].to(u.device)
    mask = torch.zeros(n, dtype=torch.bool, device=u.device)
    mask.index_fill_(0, idx, True)
    return Compressed(torch.where(mask, u * (n / k), torch.zeros_like(u)),
                      mask)


def quantize_stochastic(u: torch.Tensor, bits: int,
                        generator: torch.Generator) -> torch.Tensor:
    """QSGD-style stochastic uniform quantization (dense; no mask): each
    entry rounds up to the next grid point of ``max|u| / (2^(bits-1) - 1)``
    with probability equal to its distance from the one below, so
    ``E[q] = u``."""
    levels = 2 ** (bits - 1) - 1
    scale = torch.abs(u).max() / levels
    scaled = u / torch.clamp(scale, min=1e-12)
    lower = torch.floor(scaled)
    p = scaled - lower
    rnd = torch.rand(u.shape, generator=generator,
                     device=generator.device).to(u.device)
    q = lower + (rnd < p).to(u.dtype)
    return q * scale


def ef_compress_batch(residuals: torch.Tensor, updates: torch.Tensor,
                      ks: torch.Tensor,
                      compress_batch: Callable = topk_compress_batch,
                      use_kernel: bool = False
                      ) -> Tuple[Compressed, torch.Tensor]:
    """Batched EF-TopK: ``corrected = residuals + updates`` is compressed,
    ``corrected - sent`` becomes the new residual (the reference's
    arithmetic, elementwise bit-exact). ``use_kernel=True`` (global Top-K
    only) finds the thresholds of ``residuals + updates`` through
    ``threshold_find`` (the Hopper kernel for CUDA tensors, its plain twin
    for CPU tensors), as ``topk_compress_batch(use_kernel=True)`` does;
    combining it with another ``compress_batch`` raises, as in the
    reference, instead of quietly switching the selection."""
    if use_kernel:
        if compress_batch is not topk_compress_batch:
            raise ValueError(
                "ef_compress_batch(use_kernel=True) implements global Top-K "
                "selection only — it cannot honor a custom compress_batch "
                f"({getattr(compress_batch, '__name__', compress_batch)}); "
                "pass use_kernel=False for block/other compressors")
        from repro_torch.kernels import ops as kops
        th = kops.topk_thresholds(updates, ks, residuals=residuals)
        corrected = residuals + updates
        mask = magnitude_bits(corrected) >= th[:, None]
        vals = torch.where(mask, corrected, torch.zeros_like(corrected))
        return Compressed(vals, mask), corrected - vals
    corrected = residuals + updates
    comp = compress_batch(corrected, ks)
    return comp, corrected - comp.values


def ef_compress(residual: torch.Tensor, u: torch.Tensor, cr: float,
                compress: Callable = topk_compress
                ) -> Tuple[Compressed, torch.Tensor]:
    """EF-TopK (EFSGD) for one client: compress ``residual + u`` at ``cr``
    and keep what was not sent. Returns (compressed, new_residual)."""
    corrected = residual + u
    comp = compress(corrected, cr)
    return comp, corrected - comp.values


# ------------------------------------------------------------ sparse format
def to_sparse(comp: Compressed, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense-masked -> (indices int32 [k], values [k]) wire format, largest
    magnitude first, ties by the lower index (``lax.top_k``'s order: a
    stable descending sort, since ``torch.topk`` promises no tie order).
    Entries beyond the retained count are index -1, value 0."""
    mag = torch.where(comp.mask, torch.abs(comp.values.to(torch.float32)),
                      torch.full_like(comp.values, -1.0,
                                      dtype=torch.float32))
    idx = torch.sort(mag, descending=True, stable=True).indices[:k]
    valid = comp.mask[idx]
    vals = comp.values[idx] * valid.to(comp.values.dtype)
    neg = torch.full_like(idx, -1)
    return torch.where(valid, idx, neg).to(torch.int32), vals


def from_sparse(indices: torch.Tensor, values: torch.Tensor,
                n: int) -> torch.Tensor:
    """(indices, values) -> dense [n]; index -1 entries dropped (they add
    0 at index 0, as the reference's scatter-add does)."""
    keep = indices >= 0
    safe = torch.where(keep, indices, torch.zeros_like(indices)).long()
    contrib = torch.where(keep, values, torch.zeros_like(values))
    return torch.zeros((n,), dtype=values.dtype,
                       device=values.device).index_add_(0, safe, contrib)


COMPRESSORS = {
    "topk": topk_compress,
    "blocktopk": block_topk_compress,
}
