"""Attention: GQA/MHA with causal / sliding-window / bidirectional / cross
variants, q-chunked for long sequences, plus single-token decode against a
KV cache.

Port of ``repro.models.attention`` (self- and cross-attention). The
layouts are the reference's: activations ``[B, S, H, D]``, caches ``[B, S,
Hkv, D]``, and query head ``i`` reads kv head ``i // (H / Hkv)``. Under
sharding rules ``self_attention`` pins q's heads to the model axis, as the
reference does (``dist.sharding.constrain``; the identity without rules).
On DTensors (the multi-card layout) ``attend`` runs on each rank's shard
of the batch and the heads (``_attend_sharded``): attention is independent
across both, and its einsums flatten two sharded dims, which DTensor
cannot do without a gather.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.dist.sharding import constrain, is_dtensor
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
    """x: [B, S, d] -> q [B,S,H,D], k/v [B,S,Hkv,D]. Under rules each
    projection is laid out with its heads over the model axis before its
    bias is added (a projection whose contraction is sharded is a partial
    sum, which DTensor cannot add to a sharded bias)."""
    b, s, _ = x.shape
    q, k, v = (constrain(x @ p[w], ("batch", None, "heads"))
               for w in ("wq", "wk", "wv"))
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
    if is_dtensor(q):
        return _attend_sharded(q, k, v, causal=causal, window=window,
                               q_offset=q_offset, chunk=chunk)
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


def _attend_sharded(q, k, v, **kw):
    """``attend`` on DTensors: q, k and v laid out ``("batch", None,
    "heads", None)`` (the heads replicated instead when the model axis
    does not divide both H and Hkv, so that each rank keeps whole query
    groups), then ``attend`` on every rank's own shard (``local_map``),
    the output laid out as q."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    spec = ("batch", None, "heads", None)
    q, k, v = (constrain(t, spec) for t in (q, k, v))
    mesh = q.device_mesh
    plc = list(q.placements)
    for i, pl in enumerate(plc):
        n = mesh.size(i)
        if pl.is_shard(2) and (q.shape[2] % n or k.shape[2] % n):
            plc[i] = Replicate()
    plc = tuple(plc)
    q, k, v = (t.redistribute(mesh, plc) for t in (q, k, v))
    one = list(plc)             # one tensor's placements (a list)
    fn = local_map(functools.partial(attend, **kw), out_placements=one,
                   in_placements=(one, one, one), device_mesh=mesh)
    return fn(q, k, v)


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
    """Pre-projected full self-attention for prefill. x: [B,S,d]. Under
    rules q is head-sharded over the model axis (``constrain``)."""
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q, k, v = qkv_proj(p, x, h, hkv, hd)
    q = constrain(q, ("batch", None, "heads", None))
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    out = attend(q, k, v, causal=causal, window=window, chunk=chunk)
    return mm(out.reshape(x.shape[0], x.shape[1], h * hd), p["wo"])


def cross_attention(p, x, memory, *, cfg, chunk=512):
    """x: [B,Sq,d] attends to memory [B,Sk,d]; no mask, no rope."""
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    b, sq, _ = x.shape
    sk = memory.shape[1]
    q = (x @ p["wq"]).reshape(b, sq, h, hd)
    k = (memory @ p["wk"]).reshape(b, sk, hkv, hd)
    v = (memory @ p["wv"]).reshape(b, sk, hkv, hd)
    out = attend(q, k, v, causal=False, window=None, chunk=chunk)
    return mm(out.reshape(b, sq, h * hd), p["wo"])


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


def decode_cross_attention(p, x, ck_cache, cv_cache, *, cfg):
    """One-token cross-attn against precomputed memory K and V
    ``[B, S, Hkv, D]``, every position valid (``pos = S - 1``). x: [B,d]."""
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    b = x.shape[0]
    q = (x @ p["wq"]).reshape(b, h, hd)
    s = ck_cache.shape[1]
    out = decode_attend(q, ck_cache, cv_cache, s - 1, window=None)
    return out.reshape(b, h * hd) @ p["wo"]
