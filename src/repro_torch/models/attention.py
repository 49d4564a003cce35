"""Attention: GQA/MHA with causal / sliding-window masks, q-chunked for long
sequences, plus single-token decode against a KV cache.

Port of ``repro.models.attention`` (the self-attention parts the dense
family needs). The layouts are the reference's: activations ``[B, S, H, D]``,
caches ``[B, S, Hkv, D]``, and query head ``i`` reads kv head
``i // (H / Hkv)``. The port runs on one card, so the reference's sharding
constraints have no counterpart here.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.models.layers import apply_rope, dense_init, mm

NEG_INF = -1e9


def _scale(d: int) -> float:
    """1/sqrt(d) rounded as the reference computes it (f32 sqrt, f32
    divide), on the host: a device scalar made from a Python number is a
    host-to-device copy, which would hold the host at every layer."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))


# ---------------------------------------------------------------- params
def init_attention(gen: torch.Generator, d_model: int, n_heads: int,
                   n_kv_heads: int, head_dim: int, dtype,
                   qkv_bias: bool = False):
    p = {
        "wq": dense_init(gen, d_model, (d_model, n_heads * head_dim), dtype),
        "wk": dense_init(gen, d_model, (d_model, n_kv_heads * head_dim), dtype),
        "wv": dense_init(gen, d_model, (d_model, n_kv_heads * head_dim), dtype),
        "wo": dense_init(gen, n_heads * head_dim,
                         (n_heads * head_dim, d_model), dtype),
    }
    if qkv_bias:
        dev = gen.device
        p["bq"] = torch.zeros((n_heads * head_dim,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((n_kv_heads * head_dim,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((n_kv_heads * head_dim,), dtype=dtype, device=dev)
    return p


def qkv_proj(p, x: torch.Tensor, n_heads: int, n_kv_heads: int,
             head_dim: int):
    """x: [B, S, d] -> q [B,S,H,D], k/v [B,S,Hkv,D]."""
    b, s, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(b, s, n_heads, head_dim),
            k.reshape(b, s, n_kv_heads, head_dim),
            v.reshape(b, s, n_kv_heads, head_dim))


# ---------------------------------------------------------------- core attend
def _mask(q_pos, k_pos, causal: bool, window: Optional[int]):
    """q_pos: [Sq], k_pos: [Sk] -> bool [Sq, Sk] (True = attend)."""
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        m &= q_pos[:, None] - k_pos[None, :] < window
    return m


def _attend_block(q, k, v, mask, scale):
    """q [B,Sq,H,Dqk]; k [B,Sk,Hkv,Dqk]; v [B,Sk,Hkv,Dv] (Dv may differ).

    Scores and softmax in f32 (for bf16 inputs, the f32 products of bf16
    values are exact, as the reference's f32-accumulated dot); the
    probabilities are cast back to the input dtype for the PV product."""
    b, sq, h, d = q.shape
    hkv, dv = k.shape[2], v.shape[-1]
    g = h // hkv
    qg = q.reshape(b, sq, hkv, g, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w.to(q.dtype), v)
    return out.reshape(b, sq, h, dv).to(q.dtype)


def attend(q, k, v, *, causal: bool = True, window: Optional[int] = None,
           q_offset: int = 0, chunk: int = 512) -> torch.Tensor:
    """Full attention, q-chunked when Sq > chunk to bound score memory.

    q: [B,Sq,H,D]; k,v: [B,Sk,Hkv,D]. Chunks of ``chunk`` queries (256 when
    Sk >= 16384); Sq is zero-padded to a chunk multiple and sliced back.
    """
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if sk >= 16384:  # long-context prefill: smaller q-chunks bound the
        chunk = min(chunk, 256)  # [B,H,chunk,Sk] score tiles
    scale = _scale(d)
    q_pos_all = q_offset + torch.arange(sq, device=q.device)
    k_pos = torch.arange(sk, device=q.device)
    if sq <= chunk:
        return _attend_block(q, k, v, _mask(q_pos_all, k_pos, causal, window),
                             scale)

    pad = (-sq) % chunk
    if pad:  # non-divisible Sq: pad queries, slice back
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad))
    n_chunks = (sq + pad) // chunk
    outs = []
    for idx in range(n_chunks):
        qc = q[:, idx * chunk:(idx + 1) * chunk]
        q_pos = q_offset + idx * chunk + torch.arange(chunk, device=q.device)
        outs.append(_attend_block(qc, k, v,
                                  _mask(q_pos, k_pos, causal, window), scale))
    out = torch.cat(outs, dim=1)
    return out[:, :sq] if pad else out


def decode_attend(q, k_cache, v_cache, pos, *, window: Optional[int] = None):
    """Single-token decode. q: [B,H,D]; caches [B,S,Hkv,D]; pos: scalar int.
    Scores, softmax and the weighted sum in f32."""
    b, h, d = q.shape
    s, hkv, dv = k_cache.shape[1], k_cache.shape[2], v_cache.shape[-1]
    g = h // hkv
    scale = _scale(d)
    qg = q.reshape(b, hkv, g, d)
    scores = torch.einsum("bhgd,bkhd->bhgk", qg.float(),
                          k_cache.float()) * scale
    k_pos = torch.arange(s, device=q.device)
    valid = k_pos <= pos
    if window is not None:
        valid &= k_pos > pos - window
    scores = torch.where(valid, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", w, v_cache.float())
    return out.reshape(b, h, dv).to(q.dtype)


# ---------------------------------------------------------------- module-level
def self_attention(p, x, *, cfg, positions, causal=True, window=None,
                   rope=True, chunk=512):
    """Pre-projected full self-attention for prefill. x: [B,S,d]."""
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q, k, v = qkv_proj(p, x, h, hkv, hd)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    out = attend(q, k, v, causal=causal, window=window, chunk=chunk)
    return mm(out.reshape(x.shape[0], x.shape[1], h * hd), p["wo"])


def decode_self_attention(p, x, k_cache, v_cache, pos, *, cfg, window=None,
                          rope=True):
    """One-token self-attn with cache update.

    x: [B,d]; caches [B,S,Hkv,D]. Returns (out [B,d], k_cache, v_cache).
    RoPE is applied at write time for k (absolute positions). The caches are
    written IN PLACE at ``pos`` (the reference's functional
    ``dynamic_update_slice`` returns new arrays); the same tensors are
    returned, so a caller may use either.
    """
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    b = x.shape[0]
    q, k, v = qkv_proj(p, x[:, None, :], h, hkv, hd)
    if rope:
        posa = torch.full((1,), int(pos), device=x.device)
        q = apply_rope(q, posa, cfg.rope_theta)
        k = apply_rope(k, posa, cfg.rope_theta)
    k_cache[:, pos] = k[:, 0].to(k_cache.dtype)
    v_cache[:, pos] = v[:, 0].to(v_cache.dtype)
    out = decode_attend(q[:, 0], k_cache, v_cache, pos, window=window)
    return out.reshape(b, h * hd) @ p["wo"], k_cache, v_cache
