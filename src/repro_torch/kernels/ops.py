"""Wrappers over the Hopper kernels (torch port of ``repro.kernels.ops``):
the flat-space ``block_topk``, ``overlap_combine``, ``topk_thresholds``,
``megakernel_aggregate`` and ``ef_topk_update``, and the model-layout
``flash_attention``.

The kernels mask their ragged edge themselves, so the only padding here is
the reference's zero-padding of a flat vector to a multiple of ``block``
(block selection counts those zeros); rows are never padded. Each wrapper
goes to the Hopper kernels for CUDA tensors and to their plain twins for CPU
tensors (the kernel modules decide by device).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.compression import Compressed, k_for_ratio
from repro_torch.core.strategies import CODEC_LEVELS, quantization_scale
from repro_torch.kernels.block_topk import block_topk as block_topk_rows
from repro_torch.kernels.ef_update import ef_update
from repro_torch.kernels.flash_attention import \
    flash_attention as flash_attention_bh
from repro_torch.kernels.fused_merge import fused_merge
from repro_torch.kernels.overlap_combine import \
    overlap_combine as overlap_combine_rows
from repro_torch.kernels.threshold_find import threshold_find


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def _blocks(u: torch.Tensor, block: int) -> torch.Tensor:
    """Flat [n] -> [nb, block] f32 rows, zero-padded to a block multiple."""
    u = _f32(u.reshape(-1))
    pad = (-u.shape[0]) % block
    if pad:
        u = torch.nn.functional.pad(u, (0, pad))
    return u.view(-1, block)


def block_topk(u: torch.Tensor, cr: float, block: int = 8192) -> Compressed:
    """Flat vector -> block Top-K ``Compressed`` through the ``block_topk``
    kernel: each ``block``-wide tile keeps ``k_for_ratio(block, cr)``
    entries by the kernel's value bisection (ties kept). The values come
    back in ``u``'s dtype, as the reference's."""
    n = u.numel()
    vals, mask = block_topk_rows(_blocks(u, block), k_for_ratio(block, cr))
    return Compressed(vals.reshape(-1)[:n].to(u.dtype),
                      mask.reshape(-1)[:n] != 0)


def overlap_combine(vals: torch.Tensor, masks: torch.Tensor,
                    coeffs: torch.Tensor, gamma: float, d: int
                    ) -> torch.Tensor:
    """[K, n] masked updates + [K, n] masks + [K] coeffs -> the
    OPWA-aggregated [n] through the ``overlap_combine`` kernel."""
    m = masks.contiguous()
    m = m.view(torch.int8) if m.dtype == torch.bool else m.to(torch.int8)
    return overlap_combine_rows(_f32(vals), m, _f32(coeffs.to(vals.device)),
                                float(gamma), int(d))


def topk_thresholds(updates: torch.Tensor, ks: torch.Tensor,
                    residuals: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[C, n] updates + [C] retained counts -> exact per-client k-th-|.|
    bit-pattern thresholds int32 [C] (of ``residuals + updates`` when
    residuals are given). The Top-K mask is ``bits(|x|) >= thresholds``."""
    ks = ks.to(device=updates.device, dtype=torch.int32).contiguous()
    return threshold_find(_f32(updates), ks,
                          _f32(residuals) if residuals is not None else None)


def megakernel_aggregate(updates: torch.Tensor, ks: torch.Tensor,
                         weights: torch.Tensor,
                         residuals: Optional[torch.Tensor] = None,
                         active: Optional[torch.Tensor] = None, *,
                         opwa: bool = False, gamma: float = 1.0, d: int = 1,
                         codec: str = "none"
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Whole flat-space client merge through the two kernels:
    ``threshold_find`` then ``fused_merge``.

    updates [C, n] f32; ks [C] int; weights [C] f32; residuals optional
    [C, n] (EF arithmetic and the new-residual output); active optional bool
    [C] (padded-cohort gating); codec "none" | "int8" | "int4" (requires
    residuals). The codec scale is the row absmax that ``threshold_find``
    emits, put through the same ``quantization_scale`` as the value codec.

    Returns (agg [n] f32, new_residuals [C, n] | None).
    """
    dev = updates.device
    x = _f32(updates)
    e = _f32(residuals) if residuals is not None else None
    ks = ks.to(device=dev, dtype=torch.int32).contiguous()
    if codec == "none":
        th = threshold_find(x, ks, e)
        scales = None
    else:
        th, absmax = threshold_find(x, ks, e, emit_scale=True)
        scales = quantization_scale(absmax, CODEC_LEVELS[codec]).contiguous()
    act = (active.to(device=dev, dtype=torch.float32).contiguous()
           if active is not None else None)
    out = fused_merge(x, th, _f32(weights.to(dev)), e, act, opwa=opwa,
                      gamma=gamma, d=d, codec=codec, scales=scales)
    if residuals is None:
        return out, None
    return out


def ef_topk_update(g: torch.Tensor, residual: torch.Tensor, cr: float,
                   block: int = 8192):
    """Fused EF step on flat vectors through the ``ef_update`` kernel ->
    ``(send [n], new_residual [n])``, per ``block``-wide tile at
    ``k_for_ratio(block, cr)``."""
    n = g.numel()
    send, res = ef_update(_blocks(g, block), _blocks(residual, block),
                          k_for_ratio(block, cr))
    return send.reshape(-1)[:n], res.reshape(-1)[:n]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, blk_q: int = 128,
                    blk_k: int = 128) -> torch.Tensor:
    """Model-layout wrapper: q [B,S,H,D], k/v [B,S,H,D] (equal heads; GQA
    callers broadcast kv first). Pads Sq/Sk to block multiples with zeros
    and slices the output back, as the reference does: padded keys sit at
    positions >= Sk, which the causal mask hides from every query position
    below Sk (query positions >= Sk, when Sq > Sk, do see them)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    qt = q.transpose(1, 2).reshape(b * h, sq, d)
    kt = k.transpose(1, 2).reshape(b * h, sk, d)
    vt = v.transpose(1, 2).reshape(b * h, sk, d)
    pq, pk = (-sq) % blk_q, (-sk) % blk_k
    if pq:
        qt = torch.nn.functional.pad(qt, (0, 0, 0, pq))
    if pk:
        # non-causal callers must pad Sk themselves
        assert causal, "non-causal flash with Sk % blk_k != 0 unsupported"
        kt = torch.nn.functional.pad(kt, (0, 0, 0, pk))
        vt = torch.nn.functional.pad(vt, (0, 0, 0, pk))
    out = flash_attention_bh(qt.contiguous(), kt.contiguous(),
                             vt.contiguous(), causal=causal, blk_q=blk_q,
                             blk_k=blk_k)
    return out[:, :sq].reshape(b, h, sq, d).transpose(1, 2)
