"""RWKV-6 (Finch) blocks: the data-dependent-decay time-mix through chunked
GLA in its vector-decay mode with the bonus u, and the squared-ReLU
channel-mix, with the 5-way data-dependent token shift (ddlerp) and the
per-channel decay LoRA of arXiv:2404.05892.

Port of ``repro.models.rwkv6``. Dtypes follow the reference: the ddlerp
stays in the params' dtype, the log-decay and the wkv state are f32, and
the cached previous tokens (``tm_x``, ``cm_x``) are f32.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.gla import chunked_gla, gla_decode
from repro_torch.models.layers import dense_init, group_norm_heads

MAA_RANK = 32


def init_time_mix(gen: torch.Generator, d_model: int, rwkv_cfg, dtype):
    c = d_model
    f32 = dict(dtype=torch.float32, device=gen.device)
    lora = rwkv_cfg.decay_lora
    return {
        "mu_x": torch.zeros((c,), **f32),
        # static lerp weights for w, k, v, r, g
        "mu": torch.zeros((5, c), **f32),
        "maa_w1": dense_init(gen, c, (c, 5 * MAA_RANK), dtype),
        "maa_w2": dense_init(gen, MAA_RANK, (5, MAA_RANK, c), dtype),
        "decay_base": torch.full((c,), -6.0, **f32),   # omega
        "decay_w1": dense_init(gen, c, (c, lora), dtype),
        "decay_w2": dense_init(gen, lora, (lora, c), dtype),
        "bonus_u": torch.zeros((c,), **f32),
        "wr": dense_init(gen, c, (c, c), dtype),
        "wk": dense_init(gen, c, (c, c), dtype),
        "wv": dense_init(gen, c, (c, c), dtype),
        "wg": dense_init(gen, c, (c, c), dtype),
        "wo": dense_init(gen, c, (c, c), dtype),
        "ln_scale": torch.ones((c,), **f32),
        "ln_bias": torch.zeros((c,), **f32),
    }


def init_channel_mix(gen: torch.Generator, d_model: int, d_ff: int, dtype):
    f32 = dict(dtype=torch.float32, device=gen.device)
    return {
        "mu_k": torch.zeros((d_model,), **f32),
        "mu_r": torch.zeros((d_model,), **f32),
        "wk": dense_init(gen, d_model, (d_model, d_ff), dtype),
        "wv": dense_init(gen, d_ff, (d_ff, d_model), dtype),
        "wr": dense_init(gen, d_model, (d_model, d_model), dtype),
    }


def _shift(x: torch.Tensor) -> torch.Tensor:
    """Token shift: x[t] -> x[t-1] (zeros at t=0). x: [B,S,C]."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1, :]


def _ddlerp(p, x: torch.Tensor, sx: torch.Tensor):
    """Data-dependent 5-way lerp -> [xw, xk, xv, xr, xg]. sx = shift(x) - x.
    The f32 mixing weights are cast to x's dtype first, as the reference
    does, so the whole lerp stays in x's dtype."""
    xxx = x + sx * p["mu_x"].to(x.dtype)
    mm = torch.tanh(xxx @ p["maa_w1"])                              # [B,S,5R]
    b, s, _ = mm.shape
    mm = mm.reshape(b, s, 5, MAA_RANK)
    mus = torch.einsum("bsfr,frc->fbsc", mm, p["maa_w2"].to(mm.dtype))
    return [x + sx * (p["mu"][i].to(x.dtype) + mus[i].to(x.dtype))
            for i in range(5)]


def _decay(p, xw: torch.Tensor) -> torch.Tensor:
    """Per-channel log-decay g <= 0, in f32: w = exp(-exp(omega + lora(xw)))."""
    lora = torch.tanh(xw @ p["decay_w1"]) @ p["decay_w2"]
    return -torch.exp(p["decay_base"] + lora.float())


def _heads(x, n_heads, hs):
    b = x.shape[0]
    s = x.shape[1] if x.dim() == 3 else 1
    return x.reshape(b, s, n_heads, hs).transpose(1, 2)


def wkv_inputs(p, x: torch.Tensor, *, n_heads: int, rwkv_cfg):
    """Prefill's WKV inputs to chunked GLA from x: [B,S,C]: (r, k, v
    [B,H,S,hs], the per-channel log-decay g (f32), the bonus u [H,hs], the
    silu gate [B,S,C])."""
    hs = rwkv_cfg.head_size
    sx = _shift(x) - x
    xw, xk, xv, xr, xg = _ddlerp(p, x, sx)
    g_log = _decay(p, xw)                                           # [B,S,C]
    r = _heads(xr @ p["wr"], n_heads, hs)
    k = _heads(xk @ p["wk"], n_heads, hs)
    v = _heads(xv @ p["wv"], n_heads, hs)
    gate = F.silu(xg @ p["wg"])
    g = _heads(g_log, n_heads, hs)
    u = p["bonus_u"].reshape(n_heads, hs)
    return r, k, v, g, u, gate


def apply_time_mix(p, x: torch.Tensor, *, n_heads: int, rwkv_cfg,
                   chunk=None) -> torch.Tensor:
    """Prefill WKV. x: [B,S,C] -> [B,S,C]."""
    b, s, c = x.shape
    r, k, v, g, u, gate = wkv_inputs(p, x, n_heads=n_heads,
                                     rwkv_cfg=rwkv_cfg)
    o, _ = chunked_gla(r, k, v, g, u=u, chunk=chunk or rwkv_cfg.chunk,
                       inclusive=False)
    o = o.transpose(1, 2).reshape(b, s, c).to(x.dtype)
    o = group_norm_heads(o, p["ln_scale"], p["ln_bias"], n_heads)
    return (o * gate) @ p["wo"]


def apply_channel_mix(p, x: torch.Tensor) -> torch.Tensor:
    sx = _shift(x) - x
    xk = x + sx * p["mu_k"].to(x.dtype)
    xr = x + sx * p["mu_r"].to(x.dtype)
    h = torch.square(torch.relu(xk @ p["wk"]))
    return torch.sigmoid(xr @ p["wr"]) * (h @ p["wv"])


def init_rwkv_cache(batch: int, d_model: int, n_heads: int, rwkv_cfg,
                    device="cpu"):
    hs = rwkv_cfg.head_size
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "tm_x": torch.zeros((batch, d_model), **f32),  # prev token (time-mix)
        "cm_x": torch.zeros((batch, d_model), **f32),  # prev token (channel-mix)
        "wkv": torch.zeros((batch, n_heads, hs, hs), **f32),
    }


def decode_time_mix(p, x: torch.Tensor, cache, *, n_heads: int, rwkv_cfg
                    ) -> Tuple[torch.Tensor, dict]:
    """One-token recurrent WKV. x: [B,C]. Returns (out [B,C], cache), with
    ``tm_x`` and ``wkv`` written IN PLACE (the reference returns a new
    cache), so ``cache`` may be a layer's view of a stacked cache."""
    b, c = x.shape
    hs = rwkv_cfg.head_size
    sx = cache["tm_x"].to(x.dtype) - x
    xw, xk, xv, xr, xg = _ddlerp(p, x[:, None, :], sx[:, None, :])
    g_log = _decay(p, xw)[:, 0]                                     # [B,C]
    r = (xr[:, 0] @ p["wr"]).reshape(b, n_heads, hs)
    k = (xk[:, 0] @ p["wk"]).reshape(b, n_heads, hs)
    v = (xv[:, 0] @ p["wv"]).reshape(b, n_heads, hs)
    gate = F.silu(xg[:, 0] @ p["wg"])
    g = g_log.reshape(b, n_heads, hs)
    u = p["bonus_u"].reshape(n_heads, hs)
    o, wkv = gla_decode(r, k, v, g, cache["wkv"], u=u, inclusive=False)
    cache["wkv"].copy_(wkv)
    cache["tm_x"].copy_(x)
    o = o.reshape(b, c).to(x.dtype)
    o = group_norm_heads(o, p["ln_scale"], p["ln_bias"], n_heads)
    return (o * gate) @ p["wo"], cache


def decode_channel_mix(p, x: torch.Tensor, cache
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token channel-mix. x: [B,C]. Returns (out [B,C], the new
    ``cm_x``), which is ``cache["cm_x"]``, written IN PLACE."""
    sx = cache["cm_x"].to(x.dtype) - x
    xk = x + sx * p["mu_k"].to(x.dtype)
    xr = x + sx * p["mu_r"].to(x.dtype)
    h = torch.square(torch.relu(xk @ p["wk"]))
    out = torch.sigmoid(xr @ p["wr"]) * (h @ p["wv"])
    cache["cm_x"].copy_(x)
    return out, cache["cm_x"]
