"""flash_attention: causal (or full) forward attention with online softmax
over heads-flattened ``[BH, S, D]`` tensors.

Port of ``repro.kernels.flash_attention.flash_attention_pallas``. Per query
row, over blocks of ``blk_k`` keys: ``q`` is cast to f32 and scaled by
``1/sqrt(D)`` BEFORE the dot product; scores where ``q_pos < k_pos`` become
-1e30 (causal, positions aligned at the top left when Sq != Sk); the running
max ``m``, denominator ``l`` and accumulator ``acc`` are f32; the output is
``acc / max(l, 1e-30)`` in q's dtype.

Two implementations:

  * ``flash_attention_cuda``: the hand-written Hopper kernel
    (``csrc/flash_attention.cu``), one CTA per (bh, 64-query tile), f32 on
    the CUDA cores;
  * ``flash_attention_plain``: the plain PyTorch twin, the same blockwise
    online softmax vectorised over BH and the query rows. The CPU tests hold
    it to the Pallas kernel; ``chip_smoke.py`` holds the kernel to it.

The kernel sums in another order than the twin (its own key tiles, its own
dot-product order), so the two agree within a stated bound, not bit for bit:
f32 outputs within ``B = (D + Sk) * 2^-24 * max|v|`` plus 4 ULP of
``max|v|``; bf16 outputs within that plus one bf16 ULP, as each side rounds
its own f32 result (and the bf16 kernel's output is the f32 kernel's on the
upcast inputs, rounded).

``flash_attention`` picks by the tensor's device: the twin for CPU tensors,
the kernel for CUDA tensors (it launches or raises — there is no fallback).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
#: head dims the kernel is built for
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, blk_q: int = 128,
                          blk_k: int = 128) -> torch.Tensor:
    """Plain PyTorch twin (any device). Same arguments and result as
    ``flash_attention``."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    assert sq % blk_q == 0 and sk % blk_k == 0
    scale = 1.0 / (d ** 0.5)
    qf = q.float() * scale
    q_pos = torch.arange(sq, device=q.device)[:, None]
    m = torch.full((bh, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((bh, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((bh, sq, d), dtype=torch.float32, device=q.device)
    for i in range(sk // blk_k):
        kb = k[:, i * blk_k:(i + 1) * blk_k].float()
        vb = v[:, i * blk_k:(i + 1) * blk_k].float()
        s = qf @ kb.transpose(1, 2)                      # [BH, Sq, blk_k]
        if causal:
            k_pos = i * blk_k + torch.arange(blk_k, device=q.device)[None, :]
            s = torch.where(q_pos >= k_pos, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + p @ vb
        m = m_new
    return (acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 blk_q: int, blk_k: int) -> None:
    """What the kernel takes: contiguous, 16-byte aligned ``[BH, S, D]``
    CUDA tensors of one dtype (f32 or bf16), D in HEAD_DIMS, k and v of one
    shape, Sq and Sk multiples of the blocks (the reference's assertion)."""
    if q.device.type != "cuda" or q.dim() != 3 or q.dtype not in DTYPES:
        raise ValueError("flash_attention_cuda: q must be a [BH, Sq, D] f32 "
                         "or bf16 CUDA tensor")
    bh, sq, d = q.shape
    for name, t in (("k", k), ("v", v)):
        if (t.device != q.device or t.dtype != q.dtype or t.dim() != 3
                or t.shape[0] != bh or t.shape[2] != d
                or t.shape != k.shape):
            raise ValueError(f"flash_attention_cuda: {name} must be "
                             f"[{bh}, Sk, {d}] {q.dtype} on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention_cuda: {name} must be "
                             "contiguous and 16-byte aligned")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head dim {d} not in "
                         f"{HEAD_DIMS}")
    sk = k.shape[1]
    if bh == 0 or sq == 0 or sk == 0 or sq % blk_q or sk % blk_k:
        raise ValueError(f"flash_attention_cuda: Sq={sq}, Sk={sk} must be "
                         f"positive multiples of blk_q={blk_q}, "
                         f"blk_k={blk_k} (ops.flash_attention pads)")


def _flash_lib():
    fn = build.library("flash_attention").flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, blk_q: int = 128,
                         blk_k: int = 128) -> torch.Tensor:
    """Launch the Hopper kernel on CUDA tensors (raises on anything the
    kernel does not take). ``blk_q``/``blk_k`` only fix the divisibility the
    reference asserts; the kernel tiles by its own 64 x 64."""
    check_inputs(q, k, v, blk_q, blk_k)
    bh, sq, d = q.shape
    fn = _flash_lib()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 bh, sq, k.shape[1], d, DTYPES[q.dtype], int(bool(causal)),
                 1.0 / (d ** 0.5), stream)
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    *, causal: bool = True, blk_q: int = 128,
                    blk_k: int = 128) -> torch.Tensor:
    """q: [BH, Sq, D]; k, v: [BH, Sk, D] (heads pre-flattened), f32 or
    bf16; Sq % blk_q == 0 and Sk % blk_k == 0 (pad in ``ops``).

    Returns [BH, Sq, D] in q's dtype. CPU tensors take the plain twin; CUDA
    tensors launch the kernel (counted in ``flash_attention.launches``)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, blk_q=blk_q,
                                     blk_k=blk_k)
    return flash_attention_cuda(q, k, v, causal=causal, blk_q=blk_q,
                                blk_k=blk_k)


#: kernel launches (one per call that reaches the Hopper kernel)
flash_attention.launches = 0
