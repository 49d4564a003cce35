"""block_topk: per-row magnitude Top-K of ``[nb, block]`` by value bisection.

Port of ``repro.kernels.block_topk.block_topk_pallas``. Each row finds its
threshold by 40 halvings of ``[0, rowmax]`` in f32 (``mid = 0.5*(lo+hi)``,
keep ``mid`` as ``lo`` while at least k magnitudes reach it), then keeps
``|x| >= lo``: values ``where(mask, x, 0)`` and an int8 mask.

This is the reference KERNEL's selection, which is not exact Top-K: a NaN
makes the row max NaN and keeps every non-NaN element, an ``inf`` keeps the
whole row unless k = 1, and a k-th magnitude below ``rowmax * 2^-40`` keeps
the whole row, zeros included. The exact per-block selection is the plain
route of ``core.compression.block_topk_compress``. Denormals are flushed in
the selection (magnitudes and every ``mid``) as the reference's platforms
flush them in arithmetic.

Two implementations of one result:

  * ``block_topk_cuda``: the hand-written Hopper kernel
    (``csrc/block_topk.cu`` with ``csrc/block_select.cuh``), one CTA a row.
    A step's count reaches k exactly when the k-th largest magnitude m_k
    reaches ``mid``, so the kernel finds m_k by an exact radix select
    (4 digit passes over the 31-bit pattern) and then runs the 40 steps as
    a scalar recurrence on ``(hi, m_k)``: the same ``lo``, bit for bit.
    Rows of up to ``MAX_BLOCK`` elements are held in registers (one read
    of the row); longer ones are re-read from device memory in each pass
    (5 reads a row);
  * ``block_topk_plain``: the plain PyTorch twin, the reference's 40 f32
    counting steps on whole rows. The CPU tests hold it to the Pallas
    kernel; ``chip_smoke.py`` holds the kernel to it bit for bit.

``radix_kth_plain`` and ``select_threshold_from_kth`` repeat the kernel's
route in PyTorch, for the tests only.

``block_topk`` picks by the tensor's device: the twin for CPU tensors, the
kernel for CUDA tensors (it launches or raises — there is no fallback).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

N_ITERS = 40
#: longest row the Hopper kernels hold in registers (16 elements a thread,
#: 1024 threads); longer rows take their wide path, which re-reads the row
#: in each digit pass
MAX_BLOCK = 16384
#: the kernels' radix digits, most significant first: (shift, bits) of the
#: 31-bit magnitude pattern
DIGITS = ((23, 8), (15, 8), (7, 8), (0, 7))
FLT_MIN = torch.finfo(torch.float32).tiny


def flush_denormals(x: torch.Tensor) -> torch.Tensor:
    """Denormals -> zero of the same sign, as DAZ/FTZ platforms read and
    write them (the reference's XLA on the CPU and the TPU)."""
    return torch.where(x.abs() < FLT_MIN, torch.copysign(
        torch.zeros((), dtype=x.dtype, device=x.device), x), x)


def select_threshold(mag: torch.Tensor, k: int) -> torch.Tensor:
    """The 40-step value bisection on flushed magnitudes ``mag``
    [rows, block] -> ``lo`` [rows, 1]; the mask is ``mag >= lo``."""
    hi = mag.amax(dim=1, keepdim=True)       # NaN propagates, as jnp.max
    lo = torch.zeros_like(hi)
    for _ in range(N_ITERS):
        mid = flush_denormals(0.5 * (lo + hi))
        pred = (mag >= mid).sum(dim=1, keepdim=True) >= k
        lo, hi = torch.where(pred, mid, lo), torch.where(pred, hi, mid)
    return lo


def radix_kth_plain(mag: torch.Tensor, k: int) -> torch.Tensor:
    """The kernels' radix select in PyTorch (tests only): the k-th largest
    int32 pattern of the flushed magnitudes ``mag`` [rows, block] -> [rows, 1]
    int32, one histogram a digit over the elements that carry the prefix
    chosen so far."""
    keys = mag.contiguous().view(torch.int32)
    rows = keys.shape[0]
    prefix = torch.zeros(rows, 1, dtype=torch.int32, device=keys.device)
    rank = torch.full((rows, 1), k, dtype=torch.int32, device=keys.device)
    for shift, bits in DIGITS:
        match = (keys >> (shift + bits)) == prefix
        digit = ((keys >> shift) & ((1 << bits) - 1)).long()
        hist = torch.zeros(rows, 1 << bits, dtype=torch.int32,
                           device=keys.device)
        hist.scatter_add_(1, digit, match.to(torch.int32))
        # count from each bin to the top; non-increasing in the bin
        suffix = hist.flip(1).cumsum(1, dtype=torch.int32).flip(1)
        b = (suffix >= rank).sum(1, keepdim=True) - 1
        rank = rank - (suffix.gather(1, b) - hist.gather(1, b))
        prefix = (prefix << bits) | b.to(torch.int32)
    return prefix


def select_threshold_from_kth(mag: torch.Tensor, k: int) -> torch.Tensor:
    """The kernels' route to ``select_threshold``'s ``lo`` (tests only): m_k
    by ``radix_kth_plain``, then the 40 steps with pred ``m_k >= mid``."""
    hi = mag.amax(dim=1, keepdim=True)       # NaN propagates, as jnp.max
    mk = radix_kth_plain(mag, k).view(torch.float32)
    lo = torch.zeros_like(hi)
    for _ in range(N_ITERS):
        mid = flush_denormals(0.5 * (lo + hi))
        pred = mk >= mid
        lo, hi = torch.where(pred, mid, lo), torch.where(pred, hi, mid)
    return lo


def block_topk_plain(x2d: torch.Tensor, k: int):
    """Plain PyTorch twin of the kernel (any device). Same arguments and
    results as ``block_topk``."""
    mag = flush_denormals(x2d.abs())
    mask = mag >= select_threshold(mag, k)
    return (torch.where(mask, x2d, torch.zeros_like(x2d)),
            mask.to(torch.int8))


def check_rows(name: str, x2d: torch.Tensor, k: int) -> None:
    """What the row kernels take: contiguous f32 ``[nb, block]`` on CUDA
    with 1 <= k <= block (any block below 2^31)."""
    if (x2d.device.type != "cuda" or x2d.dim() != 2
            or x2d.dtype != torch.float32 or not x2d.is_contiguous()
            or x2d.shape[0] == 0):
        raise ValueError(f"{name}: rows must be a contiguous f32 [nb, block] "
                         "CUDA tensor")
    block = x2d.shape[1]
    if not 1 <= block < 2 ** 31:
        raise ValueError(f"{name}: block {block} outside [1, 2^31)")
    if not 1 <= k <= block:
        raise ValueError(f"{name}: k={k} outside [1, {block}]")


@functools.cache
def _block_topk_lib():
    fn = build.library("block_topk").block_topk_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def block_topk_cuda(x2d: torch.Tensor, k: int):
    """Launch the Hopper kernel on a CUDA tensor (raises on anything the
    kernel does not take)."""
    check_rows("block_topk_cuda", x2d, k)
    fn = _block_topk_lib()
    vals = torch.empty_like(x2d)
    mask = torch.empty(x2d.shape, dtype=torch.int8, device=x2d.device)
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        err = fn(x2d.data_ptr(), vals.data_ptr(), mask.data_ptr(),
                 x2d.shape[0], x2d.shape[1], int(k), stream)
    build.check(err, "block_topk")
    build.count_launch(block_topk)
    return vals, mask


def block_topk(x2d: torch.Tensor, k: int):
    """x2d: [nb, block] f32 rows; k: retained count per row.

    Returns ``(values f32 [nb, block], mask int8 [nb, block])``. CPU
    tensors take the plain twin; CUDA tensors launch the kernel (counted in
    ``block_topk.launches``)."""
    if x2d.device.type == "cpu":
        return block_topk_plain(x2d, k)
    return block_topk_cuda(x2d, k)


#: kernel launches (one per call that reaches the Hopper kernel)
block_topk.launches = 0
