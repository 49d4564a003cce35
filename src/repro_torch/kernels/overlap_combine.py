"""overlap_combine: the OPWA merge of precomputed sparse client updates.

Port of ``repro.kernels.overlap_combine.overlap_combine_pallas``. For
dense-masked values ``vals`` [K, n], their masks [K, n] and coefficients
[K]::

    counts = sum_k masks_k              (as int32)
    out    = M * sum_k coeffs_k * vals_k,   M = gamma where 0 < counts <= d

``overlap_combine_cuda`` is the hand-written Hopper kernel
(``csrc/overlap_combine.cu``); ``overlap_combine_plain`` is its plain
PyTorch twin, whose client sum is a Python loop over rows in order 0..K-1
from +0.0 — the kernel's order and start — so the two agree bit for bit.
``overlap_combine`` picks by the tensor's device: the twin for CPU tensors,
the kernel for CUDA tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build


def overlap_combine_plain(vals: torch.Tensor, masks: torch.Tensor,
                          coeffs: torch.Tensor, gamma: float,
                          d: int) -> torch.Tensor:
    """Plain PyTorch twin of the kernel (any device). Same arguments and
    result as ``overlap_combine``."""
    acc = torch.zeros_like(vals[0])
    for c in range(vals.shape[0]):       # fixed order 0..K-1, as the kernel
        acc = acc + vals[c] * coeffs[c]
    counts = masks.to(torch.int32).sum(dim=0, dtype=torch.int32)
    amplify = (counts > 0) & (counts <= d)
    one = torch.ones((), dtype=torch.float32, device=vals.device)
    return torch.where(amplify, one * float(gamma), one) * acc


def _overlap_combine_lib():
    fn = build.library("overlap_combine").overlap_combine_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def overlap_combine_cuda(vals: torch.Tensor, masks: torch.Tensor,
                         coeffs: torch.Tensor, gamma: float,
                         d: int) -> torch.Tensor:
    """Launch the Hopper kernel on CUDA tensors (raises on anything the
    kernel does not take)."""
    if (vals.device.type != "cuda" or vals.dim() != 2
            or vals.dtype != torch.float32 or not vals.is_contiguous()
            or 0 in vals.shape):
        raise ValueError("overlap_combine_cuda: vals must be a contiguous "
                         "f32 [K, n] CUDA tensor")
    k, n = vals.shape
    if (masks.device != vals.device or masks.dtype != torch.int8
            or masks.shape != vals.shape or not masks.is_contiguous()):
        raise ValueError("overlap_combine_cuda: masks must be contiguous "
                         f"int8 [{k}, {n}] on {vals.device}")
    if (coeffs.device != vals.device or coeffs.dtype != torch.float32
            or coeffs.numel() != k or not coeffs.is_contiguous()):
        raise ValueError("overlap_combine_cuda: coeffs must be contiguous "
                         f"f32 [{k}] on {vals.device}")
    fn = _overlap_combine_lib()
    out = torch.empty((n,), dtype=torch.float32, device=vals.device)
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        err = fn(vals.data_ptr(), masks.data_ptr(), coeffs.data_ptr(),
                 out.data_ptr(), n, k, float(gamma), int(d), stream)
    build.check(err, "overlap_combine")
    build.count_launch(overlap_combine)
    return out


def overlap_combine(vals: torch.Tensor, masks: torch.Tensor,
                    coeffs: torch.Tensor, gamma: float,
                    d: int) -> torch.Tensor:
    """vals: [K, n] f32 dense-masked updates; masks: [K, n] int8; coeffs:
    [K] f32; OPWA enlarge rate ``gamma`` for overlap degrees in (0, d].

    Returns the merged update [n] f32. CPU tensors take the plain twin; CUDA
    tensors launch the kernel (counted in ``overlap_combine.launches``)."""
    if vals.device.type == "cpu":
        return overlap_combine_plain(vals, masks, coeffs, gamma, d)
    return overlap_combine_cuda(vals, masks, coeffs, gamma, d)


#: kernel launches (one per call that reaches the Hopper kernel)
overlap_combine.launches = 0
