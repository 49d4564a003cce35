"""Multi-head Latent Attention (DeepSeek-V2/V3).

Port of ``repro.models.mla``. Training and prefill use the expanded form:
the latent ``c`` [B, S, kv_lora_rank] is expanded into per-head keys
(``c @ wk_b`` beside a rope key shared by every head) and values (``c @
wv_b``), then ``attention.attend`` with Dqk = nope + rope != Dv. Decode uses
the absorbed form against the compressed cache (``c_kv`` [B, S, 512] and
``k_rope`` [B, S, 64] a token at full width, the point of MLA for
serving): ``wk_b`` folded into the query and ``wv_b`` into the output, its
products in f32. The two are the same function; they differ in where they
round.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.attention import NEG_INF, _scale, attend
from repro_torch.models.layers import apply_rope, dense_init, rms_norm


def init_mla(gen: torch.Generator, d_model: int, n_heads: int, m, dtype):
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    dev = gen.device
    return {
        "wq_a": dense_init(gen, d_model, (d_model, m.q_lora_rank), dtype),
        "q_norm": torch.ones((m.q_lora_rank,), dtype=torch.float32,
                             device=dev),
        "wq_b": dense_init(gen, m.q_lora_rank,
                           (m.q_lora_rank, n_heads * qk), dtype),
        "wkv_a": dense_init(gen, d_model,
                            (d_model, m.kv_lora_rank + m.qk_rope_head_dim),
                            dtype),
        "kv_norm": torch.ones((m.kv_lora_rank,), dtype=torch.float32,
                              device=dev),
        "wk_b": dense_init(gen, m.kv_lora_rank,
                           (m.kv_lora_rank, n_heads * m.qk_nope_head_dim),
                           dtype),
        "wv_b": dense_init(gen, m.kv_lora_rank,
                           (m.kv_lora_rank, n_heads * m.v_head_dim), dtype),
        "wo": dense_init(gen, n_heads * m.v_head_dim,
                         (n_heads * m.v_head_dim, d_model), dtype),
    }


def _project_q(p, x, n_heads, m, theta, positions):
    """x: [B, S, d] -> (q_nope [B, S, H, dn], q_rope [B, S, H, dr], RoPE
    applied), through the normed low-rank query."""
    b, s = x.shape[0], x.shape[1]
    dn, dr = m.qk_nope_head_dim, m.qk_rope_head_dim
    cq = rms_norm(x @ p["wq_a"], p["q_norm"])
    q = (cq @ p["wq_b"]).reshape(b, s, n_heads, dn + dr)
    return q[..., :dn], apply_rope(q[..., dn:], positions, theta)


def _project_kv_latent(p, x, m, theta, positions):
    """x: [B, S, d] -> (the normed latent c [B, S, kv_lora_rank], the rope
    key [B, S, dr], one head shared by all)."""
    ckv = x @ p["wkv_a"]
    c = rms_norm(ckv[..., :m.kv_lora_rank], p["kv_norm"])
    k_rope = apply_rope(ckv[..., m.kv_lora_rank:][..., None, :], positions,
                        theta)[..., 0, :]
    return c, k_rope


def apply_mla(p, x: torch.Tensor, *, n_heads: int, m, theta: float,
              positions, chunk: int = 512) -> torch.Tensor:
    """Training / prefill, the expanded form. x: [B, S, d]."""
    b, s, _ = x.shape
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    q_nope, q_rope = _project_q(p, x, n_heads, m, theta, positions)
    c, k_rope = _project_kv_latent(p, x, m, theta, positions)
    k_nope = (c @ p["wk_b"]).reshape(b, s, n_heads, dn)
    v = (c @ p["wv_b"]).reshape(b, s, n_heads, dv)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, n_heads, dr)],
                  dim=-1)
    out = attend(q, k, v, causal=True, chunk=chunk)
    return out.reshape(b, s, n_heads * dv) @ p["wo"]


def init_mla_cache(batch: int, seq: int, m, dtype=torch.bfloat16,
                   device=None):
    return {
        "c_kv": torch.zeros((batch, seq, m.kv_lora_rank), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros((batch, seq, m.qk_rope_head_dim), dtype=dtype,
                              device=device),
    }


def decode_mla(p, x: torch.Tensor, cache, pos, *, n_heads: int, m,
               theta: float) -> Tuple[torch.Tensor, dict]:
    """One-token decode, the absorbed form, against the latent cache.
    x: [B, d]. The new latent and rope key are written IN PLACE at ``pos``
    into ``cache``'s ``c_kv`` / ``k_rope`` [B, S, .] (the reference returns
    updated copies); the same dict is returned. The query is folded
    through ``wk_b`` into the latent's space and the attended latent
    through ``wv_b``, every product in f32; the scale is ``1 / sqrt(dn +
    dr)`` rounded in f32 (``attention._scale``, the expanded form's), as
    the reference's."""
    b = x.shape[0]
    dn, dr, dv, dc = (m.qk_nope_head_dim, m.qk_rope_head_dim,
                      m.v_head_dim, m.kv_lora_rank)
    f32 = torch.float32
    posa = torch.full((1,), int(pos), device=x.device)
    q_nope, q_rope = _project_q(p, x[:, None, :], n_heads, m, theta, posa)
    c_new, k_rope_new = _project_kv_latent(p, x[:, None, :], m, theta, posa)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    c_kv[:, pos] = c_new[:, 0].to(c_kv.dtype)
    k_rope[:, pos] = k_rope_new[:, 0].to(k_rope.dtype)
    ckv = c_kv.to(f32)
    wk_b = p["wk_b"].reshape(dc, n_heads, dn).to(f32)
    q_c = torch.einsum("bhn,chn->bhc", q_nope[:, 0].to(f32), wk_b)
    scores = (torch.einsum("bhc,bsc->bhs", q_c, ckv)
              + torch.einsum("bhr,bsr->bhs", q_rope[:, 0].to(f32),
                             k_rope.to(f32)))
    scores = scores * _scale(dn + dr)
    valid = torch.arange(c_kv.shape[1], device=x.device) <= pos
    w = torch.softmax(torch.where(valid, scores, NEG_INF), dim=-1)
    ctx_c = torch.einsum("bhs,bsc->bhc", w, ckv)
    wv_b = p["wv_b"].reshape(dc, n_heads, dv).to(f32)
    ctx = torch.einsum("bhc,chv->bhv", ctx_c, wv_b)
    out = ctx.reshape(b, n_heads * dv).to(x.dtype) @ p["wo"]
    return out, cache
