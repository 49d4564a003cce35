"""The SSM branch of hymba's blocks: a Mamba-2 / SSD-style selective state
space, computed by chunked GLA in its scalar-decay, inclusive mode (state
size 16).

Port of ``repro.models.mamba``. Dtypes follow the reference: the prefill
conv runs in the params' dtype (each tap rounded), the decode conv in f32
over an f32 history, rounded once after ``silu``; the SSM state is f32.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.gla import chunked_gla, gla_decode
from repro_torch.models.layers import dense_init, rms_norm

CONV_WIDTH = 4


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, which is ``logaddexp(x, 0)``:
    ``max(x, 0) + log1p(exp(-|x|))`` (``F.softplus`` switches to ``x``
    above a threshold instead)."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))


def init_ssm(gen: torch.Generator, d_model: int, ssm_cfg, dtype):
    di = ssm_cfg.expand * d_model
    nh = di // ssm_cfg.head_dim
    n = ssm_cfg.state_size
    dev = gen.device
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        # z (gate, di) | x (di) | B (n) | C (n) | dt (nh)
        "in_proj": dense_init(gen, d_model, (d_model, 2 * di + 2 * n + nh),
                              dtype),
        "conv_w": (torch.randn((CONV_WIDTH, di + 2 * n), generator=gen, **f32)
                   * 0.1).to(dtype),
        "conv_b": torch.zeros((di + 2 * n,), dtype=dtype, device=dev),
        "a_log": torch.zeros((nh,), **f32),           # A = -exp(a_log)
        "dt_bias": torch.full((nh,), -2.0, **f32),
        "d_skip": torch.ones((nh,), **f32),
        "norm_scale": torch.ones((di,), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, di, (di, d_model), dtype),
    }


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor,
                           b: torch.Tensor) -> torch.Tensor:
    """x: [B,S,C]; w: [W,C]. y[t] = sum_k w[k] * x[t - (W-1) + k] + b, in
    x's dtype."""
    out = torch.zeros_like(x)
    for k in range(CONV_WIDTH):
        shift = CONV_WIDTH - 1 - k
        xk = F.pad(x, (0, 0, shift, 0))[:, : x.shape[1], :]
        out = out + xk * w[k]
    return F.silu(out + b)


def _split_proj(proj, d_model, ssm_cfg):
    di = ssm_cfg.expand * d_model
    n = ssm_cfg.state_size
    nh = di // ssm_cfg.head_dim
    z = proj[..., :di]
    xbc = proj[..., di: 2 * di + 2 * n]
    dt_raw = proj[..., 2 * di + 2 * n:]
    return z, xbc, dt_raw, di, n, nh


def ssd_inputs(p, x: torch.Tensor, *, d_model: int, ssm_cfg):
    """Prefill's SSD inputs to chunked GLA from x: [B,S,d]: (q = C,
    k = B shared across heads, v = dt * x (f32), g = dt * A (f32, per
    head), xh = the conv'd x [B,S,nh,hd], the gate z)."""
    bsz, s, _ = x.shape
    z, xbc, dt_raw, di, n, nh = _split_proj(x @ p["in_proj"], d_model, ssm_cfg)
    xbc = _causal_depthwise_conv(xbc, p["conv_w"], p["conv_b"])
    xs = xbc[..., :di]
    bmat = xbc[..., di: di + n]
    cmat = xbc[..., di + n:]
    dt = softplus(dt_raw.float() + p["dt_bias"])                     # [B,S,nh]
    a = -torch.exp(p["a_log"])                                       # [nh]
    g = (dt * a).transpose(1, 2)                                     # [B,nh,S]
    k = bmat[:, None, :, :].expand(bsz, nh, s, n)
    q = cmat[:, None, :, :].expand(bsz, nh, s, n)
    xh = xs.reshape(bsz, s, nh, ssm_cfg.head_dim)
    v = (xh * dt[..., None]).transpose(1, 2)                         # f32
    return q, k, v, g, xh, z


def apply_ssm(p, x: torch.Tensor, *, d_model: int, ssm_cfg) -> torch.Tensor:
    """Prefill SSM branch. x: [B,S,d] -> [B,S,d]."""
    bsz, s, _ = x.shape
    di = ssm_cfg.expand * d_model
    q, k, v, g, xh, z = ssd_inputs(p, x, d_model=d_model, ssm_cfg=ssm_cfg)
    o, _ = chunked_gla(q, k, v, g, chunk=ssm_cfg.chunk, inclusive=True)
    o = o + p["d_skip"][None, :, None, None] * xh.transpose(1, 2)
    o = o.transpose(1, 2).reshape(bsz, s, di).to(x.dtype)
    o = rms_norm(o * F.silu(z), p["norm_scale"])
    return o @ p["out_proj"]


def init_ssm_cache(batch: int, d_model: int, ssm_cfg, dtype=torch.float32,
                   device="cpu"):
    di = ssm_cfg.expand * d_model
    nh = di // ssm_cfg.head_dim
    n = ssm_cfg.state_size
    return {
        "conv": torch.zeros((batch, CONV_WIDTH - 1, di + 2 * n), dtype=dtype,
                            device=device),
        "state": torch.zeros((batch, nh, n, ssm_cfg.head_dim),
                             dtype=torch.float32, device=device),
    }


def decode_ssm(p, x: torch.Tensor, cache, *, d_model: int, ssm_cfg
               ) -> Tuple[torch.Tensor, dict]:
    """One-token SSM step. x: [B,d]. Returns (out [B,d], cache): the conv
    history and the state are written IN PLACE (the reference returns a new
    cache), so ``cache`` may be a layer's view of a stacked cache."""
    bsz = x.shape[0]
    hd = ssm_cfg.head_dim
    z, xbc, dt_raw, di, n, nh = _split_proj(x @ p["in_proj"], d_model, ssm_cfg)
    # conv over [history, current], in the promoted dtype (f32 history)
    conv = cache["conv"]
    hdt = torch.promote_types(conv.dtype, xbc.dtype)
    hist = torch.cat([conv.to(hdt), xbc[:, None, :].to(hdt)], dim=1)  # [B,W,C]
    y = torch.einsum("bwc,wc->bc", hist.float(), p["conv_w"].float()) \
        + p["conv_b"].float()
    xbc_c = F.silu(y).to(x.dtype)
    conv.copy_(hist[:, 1:, :])
    xs = xbc_c[..., :di]
    bmat = xbc_c[..., di: di + n]
    cmat = xbc_c[..., di + n:]
    dt = softplus(dt_raw.float() + p["dt_bias"])                     # [B,nh]
    a = -torch.exp(p["a_log"])
    g = dt * a                                                       # [B,nh]
    k = bmat[:, None, :].expand(bsz, nh, n)
    q = cmat[:, None, :].expand(bsz, nh, n)
    xh = xs.reshape(bsz, nh, hd)
    v = xh * dt[..., None]
    o, state = gla_decode(q, k, v, g, cache["state"], inclusive=True)
    cache["state"].copy_(state)
    o = o + p["d_skip"][None, :, None] * xh
    o = o.reshape(bsz, di).to(x.dtype)
    o = rms_norm(o * F.silu(z), p["norm_scale"])
    return o @ p["out_proj"], cache
