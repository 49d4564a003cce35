"""fused_merge: the client-update hot path in one pass over [C, n].

Port of ``repro.kernels.fused_merge.fused_merge_pallas``. Given per-client
threshold bit patterns (from ``threshold_find``) it computes, in the
reference's order (fused_merge.py:86-109)::

    corrected = e + x                              (EF configs)
    mask      = bits(|corrected|) >= threshold     (ties kept)
    send      = where(mask, corrected, 0)
    send      = symmetric_dequantize(send, scale)  (codec "int8" / "int4")
    residual' = corrected - send                   (EF configs; BEFORE gating)
    residual' = e where the row is inactive
    send      = send * active;  mask &= active > 0.5
    agg       = M * sum_c w_c * send_c,   M = gamma where 0 < counts <= D

``fused_merge_cuda`` is the hand-written Hopper kernel
(``csrc/fused_merge.cu``); ``fused_merge_plain`` is its plain PyTorch twin,
whose client sum is a Python loop over rows in order 0..C-1 — the order the
kernel uses — so the two agree bit for bit. ``fused_merge`` picks by the
tensor's device: the twin for CPU tensors, the kernel for CUDA tensors.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.compression import magnitude_bits
from repro_torch.core.strategies import CODEC_LEVELS, symmetric_dequantize
from repro_torch.kernels import build


def merge_masks(x: torch.Tensor, thresholds: torch.Tensor,
                e: Optional[torch.Tensor] = None,
                active: Optional[torch.Tensor] = None):
    """``(corrected, mask, gated mask, overlap counts int32 [n])`` — the
    selection half of the twin, exposed so the tests can hold masks and
    counts to the reference."""
    corrected = e + x if e is not None else x
    mask = magnitude_bits(corrected) >= thresholds.reshape(-1, 1)
    gated = mask if active is None else mask & (active.reshape(-1, 1) > 0.5)
    return corrected, mask, gated, gated.to(torch.int32).sum(
        dim=0, dtype=torch.int32)


def fused_merge_plain(x: torch.Tensor, thresholds: torch.Tensor,
                      weights: torch.Tensor,
                      e: Optional[torch.Tensor] = None,
                      active: Optional[torch.Tensor] = None, *,
                      opwa: bool = False, gamma: float = 1.0, d: int = 1,
                      codec: str = "none",
                      scales: Optional[torch.Tensor] = None):
    """Plain PyTorch twin of the kernel (any device). Same arguments and
    results as ``fused_merge``."""
    corrected, mask, gated, counts = merge_masks(x, thresholds, e, active)
    vals = torch.where(mask, corrected, torch.zeros_like(corrected))
    if codec != "none":
        vals = symmetric_dequantize(vals, scales.reshape(-1, 1),
                                    CODEC_LEVELS[codec])
    new_res = None
    if e is not None:
        new_res = corrected - vals
        if active is not None:
            new_res = torch.where(active.reshape(-1, 1) > 0.5, new_res, e)
    if active is not None:
        vals = vals * active.reshape(-1, 1).to(torch.float32)
    w = weights.to(torch.float32).reshape(-1)
    acc = torch.zeros_like(vals[0])
    for c in range(vals.shape[0]):       # fixed order 0..C-1, as the kernel
        acc = acc + w[c] * vals[c]
    if opwa:
        amplify = (counts > 0) & (counts <= d)
        one = torch.ones((), dtype=torch.float32, device=x.device)
        acc = torch.where(amplify, one * float(gamma), one) * acc
    return acc if e is None else (acc, new_res)


def _fused_merge_lib():
    lib = build.library("fused_merge")
    fn = lib.fused_merge_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_codec(codec: str, scales, e) -> None:
    if codec == "none":
        return
    if codec not in CODEC_LEVELS:
        raise ValueError(f"unknown codec {codec!r}")
    if scales is None or e is None:
        raise ValueError("a codec needs per-client scales and EF residuals "
                         "(EF absorbs the quantization error)")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return t.data_ptr() if t is not None else None


def _column(name: str, t: Optional[torch.Tensor], c: int, dtype,
            device) -> Optional[torch.Tensor]:
    if t is None:
        return None
    if (t.device != device or t.dtype != dtype or t.numel() != c
            or not t.is_contiguous()):
        raise ValueError(f"fused_merge: {name} must be contiguous {dtype} "
                         f"[{c}] on {device}")
    return t


def fused_merge_cuda(x: torch.Tensor, thresholds: torch.Tensor,
                     weights: torch.Tensor,
                     e: Optional[torch.Tensor] = None,
                     active: Optional[torch.Tensor] = None, *,
                     opwa: bool = False, gamma: float = 1.0, d: int = 1,
                     codec: str = "none",
                     scales: Optional[torch.Tensor] = None):
    """Launch the Hopper kernel on CUDA tensors (raises on anything the
    kernel does not take)."""
    if (x.device.type != "cuda" or x.dim() != 2 or x.dtype != torch.float32
            or not x.is_contiguous() or x.shape[1] == 0):
        raise ValueError("fused_merge_cuda: x must be a contiguous f32 "
                         "[C, n] CUDA tensor")
    c, n = x.shape
    dev = x.device
    if e is not None and (e.device != dev or e.dtype != torch.float32
                          or e.shape != x.shape or not e.is_contiguous()):
        raise ValueError("fused_merge_cuda: e must match x")
    _column("thresholds", thresholds, c, torch.int32, dev)
    _column("weights", weights, c, torch.float32, dev)
    _column("active", active, c, torch.float32, dev)
    _check_codec(codec, scales, e)
    levels = 0.0
    if codec != "none":
        levels = CODEC_LEVELS[codec]
        _column("scales", scales, c, torch.float32, dev)
    fn = _fused_merge_lib()
    agg = torch.empty((n,), dtype=torch.float32, device=dev)
    res = torch.empty_like(x) if e is not None else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), _ptr(e), thresholds.data_ptr(),
                 weights.data_ptr(), _ptr(scales) if levels else None,
                 _ptr(active), agg.data_ptr(), _ptr(res), n, c, int(opwa),
                 float(gamma), int(d), float(levels), stream)
    build.check(err, "fused_merge")
    fused_merge.launches += 1
    return agg if e is None else (agg, res)


def fused_merge(x: torch.Tensor, thresholds: torch.Tensor,
                weights: torch.Tensor, e: Optional[torch.Tensor] = None,
                active: Optional[torch.Tensor] = None, *,
                opwa: bool = False, gamma: float = 1.0, d: int = 1,
                codec: str = "none", scales: Optional[torch.Tensor] = None):
    """x: [C, n] f32 updates; thresholds: int32 [C] (from
    ``threshold_find``); weights: f32 [C]; e: optional EF residuals [C, n];
    active: optional f32 [C] row gate (exactly 1.0 / 0.0); codec "int8" /
    "int4" with per-client ``scales`` f32 [C] (requires EF: the residual
    absorbs the quantization error).

    Returns agg [n] f32, or ``(agg, residual' [C, n])`` with ``e``. CPU
    tensors take the plain twin; CUDA tensors launch the kernel (counted in
    ``fused_merge.launches``)."""
    _check_codec(codec, scales, e)
    kw = dict(opwa=opwa, gamma=gamma, d=d, codec=codec, scales=scales)
    if x.device.type == "cpu":
        return fused_merge_plain(x, thresholds, weights, e, active, **kw)
    return fused_merge_cuda(x, thresholds, weights, e, active, **kw)


#: kernel launches (one per call that reaches the Hopper kernel)
fused_merge.launches = 0
