"""ef_update: the fused error-feedback step on ``[nb, block]`` rows.

Port of ``repro.kernels.ef_update.ef_update_pallas``::

    corrected = e + g
    mask      = block Top-K of |corrected|  (block_topk's value bisection)
    send      = where(mask, corrected, 0)
    residual' = corrected - send

The add reads denormal operands as zero and writes a denormal sum as zero,
as the reference's platforms do, so the results match it bit for bit on
every input (``block_topk`` says the same of the selection).

``ef_update_cuda`` is the hand-written Hopper kernel (``csrc/ef_update.cu``,
sharing ``csrc/block_select.cuh`` with ``block_topk``: an exact radix select
of the k-th magnitude, then the 40 bisection steps as a scalar recurrence,
bit for bit the reference's ``lo``); ``ef_update_plain`` is its plain
PyTorch twin, the reference's 40 counting steps. ``ef_update`` picks by the
tensor's device: the twin for CPU tensors, the kernel for CUDA tensors.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.block_topk import (check_rows, flush_denormals,
                                            select_threshold)


def ef_update_plain(g2d: torch.Tensor, e2d: torch.Tensor, k: int):
    """Plain PyTorch twin of the kernel (any device). Same arguments and
    results as ``ef_update``."""
    corrected = flush_denormals(flush_denormals(e2d) + flush_denormals(g2d))
    mag = corrected.abs()
    mask = mag >= select_threshold(mag, k)
    send = torch.where(mask, corrected, torch.zeros_like(corrected))
    return send, corrected - send


@functools.cache
def _ef_update_lib():
    fn = build.library("ef_update").ef_update_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ef_update_cuda(g2d: torch.Tensor, e2d: torch.Tensor, k: int):
    """Launch the Hopper kernel on CUDA tensors (raises on anything the
    kernel does not take)."""
    check_rows("ef_update_cuda", g2d, k)
    if (e2d.device != g2d.device or e2d.dtype != torch.float32
            or e2d.shape != g2d.shape or not e2d.is_contiguous()):
        raise ValueError("ef_update_cuda: e2d must match g2d")
    fn = _ef_update_lib()
    send = torch.empty_like(g2d)
    res = torch.empty_like(g2d)
    with torch.cuda.device(g2d.device):
        stream = torch.cuda.current_stream(g2d.device).cuda_stream
        err = fn(g2d.data_ptr(), e2d.data_ptr(), send.data_ptr(),
                 res.data_ptr(), g2d.shape[0], g2d.shape[1], int(k), stream)
    build.check(err, "ef_update")
    build.count_launch(ef_update)
    return send, res


def ef_update(g2d: torch.Tensor, e2d: torch.Tensor, k: int):
    """g2d, e2d: [nb, block] f32 (update and EF residual); k: retained count
    per row.

    Returns ``(send, residual')``, both f32 [nb, block]. CPU tensors take
    the plain twin; CUDA tensors launch the kernel (counted in
    ``ef_update.launches``)."""
    if g2d.device.type == "cpu":
        return ef_update_plain(g2d, e2d, k)
    return ef_update_cuda(g2d, e2d, k)


#: kernel launches (one per call that reaches the Hopper kernel)
ef_update.launches = 0
