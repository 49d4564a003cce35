"""threshold_find: exact per-client k-th-largest magnitude at runtime k.

Port of ``repro.kernels.threshold_find.threshold_find_pallas``. For x [C, n]
(or the EF ``corrected = e + x``) and retained counts ks [C], returns the
k-th-largest f32 bit pattern of ``|.|`` per row: the exact Top-K mask is
``bits(|x|) >= threshold`` (ties kept), equal to the 32-halving reference
bisection for every k in [1, n]. With ``emit_scale`` it also returns the row
absmax, which feeds the int8/int4 codec scale.

The k-th-largest pattern is a single well-defined value, so two exact
searches give the same bits:

  * ``threshold_find_cuda``: the hand-written Hopper kernel
    (``csrc/threshold_find.cu``) — an exact radix select on the 31-bit
    pattern in three passes of 11, 11 and 9 bits, each a histogram whose
    blocks add integer counts atomically (a deterministic result); the last
    pass reads the second's compacted candidates, or x again when the
    chosen bin holds more than n/8 of a row; 4 launches a call, counting
    the memset of its scratch, and 2 reads of x for a client, 3 when its
    bin is that large (the kernel reports which, see ``reads_log`` below);
  * ``threshold_find_plain``: the plain PyTorch twin, the reference's
    16-ary search (8 sweeps of 15 candidate boundaries ``lo + j*step``) on
    whole rows. The CPU tests hold it to the Pallas kernel; ``chip_smoke.py``
    holds the kernel to it bit for bit.

``threshold_find`` picks by the tensor's device: the twin for CPU tensors,
the kernel for CUDA tensors (it launches or raises — there is no fallback).
While ``threshold_find.reads_log`` is a list, each kernel call appends to it
a [C] int32 CUDA tensor of the reads of x each client took (2 or 3), as the
kernel wrote them; it is None, and nothing is recorded, otherwise.
Thresholds come back as int32: every threshold is below 2^31 because
``abs`` clears the sign bit.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.compression import magnitude_bits
from repro_torch.kernels import build

WAYS = 16
SWEEPS = 8
#: initial boundary spacing: the 2^31 span of |f32| patterns in WAYS buckets
STEP0 = (1 << 31) // WAYS


def sweep_step(s: int) -> int:
    """Boundary spacing of sweep ``s`` (width 2^31 / 16^s, floored at 1)."""
    return max(STEP0 >> (4 * s), 1)


def threshold_find_plain(x: torch.Tensor, ks: torch.Tensor,
                         e: Optional[torch.Tensor] = None,
                         emit_scale: bool = False):
    """Plain PyTorch twin of the kernel (any device). Same arguments and
    results as ``threshold_find``."""
    corrected = e + x if e is not None else x
    bits = magnitude_bits(corrected).to(torch.int64)
    k = ks.to(torch.int64).reshape(-1, 1)
    lo = torch.zeros_like(k)
    j = torch.arange(1, WAYS, device=x.device, dtype=torch.int64)
    for s in range(SWEEPS):
        step = sweep_step(s)
        cnt = torch.stack([(bits >= lo + jj * step).sum(dim=1)
                           for jj in range(1, WAYS)], dim=1)   # [C, 15]
        jsel = torch.where(cnt >= k, j, torch.zeros_like(j)).amax(dim=1,
                                                                  keepdim=True)
        lo = lo + jsel * step
    th = lo[:, 0].to(torch.int32)
    if not emit_scale:
        return th
    absmax = bits.amax(dim=1).to(torch.int32).view(torch.float32)
    return th, absmax


def _threshold_find_lib():
    lib = build.library("threshold_find")
    fn = lib.threshold_find_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    scratch = lib.threshold_find_scratch_ints
    scratch.argtypes = [ctypes.c_int]
    scratch.restype = ctypes.c_longlong
    cand = lib.threshold_find_cand_ints
    cand.argtypes = [ctypes.c_int, ctypes.c_longlong]
    cand.restype = ctypes.c_longlong
    return fn, scratch, cand


def _check_rows(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if (t.device != like.device or t.dtype != torch.float32
            or t.shape != like.shape or not t.is_contiguous()):
        raise ValueError(f"threshold_find: {name} must be a contiguous f32 "
                         f"tensor of shape {tuple(like.shape)} on {like.device}")


def threshold_find_cuda(x: torch.Tensor, ks: torch.Tensor,
                        e: Optional[torch.Tensor] = None,
                        emit_scale: bool = False):
    """Launch the Hopper kernel on CUDA tensors (raises on anything the
    kernel does not take)."""
    if x.device.type != "cuda" or x.dim() != 2 or x.shape[1] == 0:
        raise ValueError("threshold_find_cuda: x must be a [C, n] CUDA tensor")
    _check_rows("x", x, x)
    if e is not None:
        _check_rows("e", e, x)
    c, n = x.shape
    if (ks.device != x.device or ks.dtype != torch.int32
            or ks.numel() != c or not ks.is_contiguous()):
        raise ValueError("threshold_find_cuda: ks must be contiguous int32 "
                         f"[{c}] on {x.device}")
    if not 1 <= c <= 65535:
        raise ValueError(f"threshold_find_cuda: C={c} outside [1, 65535]")
    fn, scratch_ints, cand_ints = _threshold_find_lib()
    th = torch.empty((c,), dtype=torch.int32, device=x.device)
    absmax = (torch.empty((c,), dtype=torch.float32, device=x.device)
              if emit_scale else None)
    scratch = torch.empty((scratch_ints(c),), dtype=torch.int32,
                          device=x.device)
    cand = torch.empty((cand_ints(c, n),), dtype=torch.int32,
                       device=x.device)
    log = threshold_find.reads_log
    reads = (torch.empty((c,), dtype=torch.int32, device=x.device)
             if log is not None else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), e.data_ptr() if e is not None else None,
                 ks.data_ptr(), th.data_ptr(),
                 absmax.data_ptr() if emit_scale else None,
                 reads.data_ptr() if reads is not None else None,
                 scratch.data_ptr(), cand.data_ptr(), n, c, stream)
    build.check(err, "threshold_find")
    build.count_launch(threshold_find)
    if log is not None:
        log.append(reads)
    return (th, absmax) if emit_scale else th


def threshold_find(x: torch.Tensor, ks: torch.Tensor,
                   e: Optional[torch.Tensor] = None, *,
                   emit_scale: bool = False):
    """x: [C, n] f32; ks: [C] int retained counts (1 <= k <= n); e: optional
    EF residuals [C, n] — thresholds are then those of ``e + x``.

    Returns thresholds int32 [C], or ``(thresholds, absmax f32 [C])`` with
    ``emit_scale``. CPU tensors take the plain twin; CUDA tensors launch the
    kernel (counted in ``threshold_find.launches``)."""
    if x.device.type == "cpu":
        return threshold_find_plain(x, ks, e, emit_scale)
    return threshold_find_cuda(x, ks, e, emit_scale)


#: kernel launches (one per call that reaches the Hopper kernel)
threshold_find.launches = 0
#: None, or a list that collects each kernel call's reads of x per client
threshold_find.reads_log = None
