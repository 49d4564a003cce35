"""Core layers of the dense model: norms, MLP, embedding, RoPE.

Port of what the dense forward and decode need from
``repro.models.layers``. Params are plain nested dicts of tensors;
layer-stacked groups carry a leading ``[L, ...]`` axis that the model walks
with a Python loop. Initialisers draw from an explicit ``torch.Generator``
and put the tensors on that generator's device.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


# ---------------------------------------------------------------- init helpers
def dense_init(gen: torch.Generator, fan_in: int, shape, dtype) -> torch.Tensor:
    scale = 1.0 / math.sqrt(max(fan_in, 1))
    return (torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32) * scale).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32) * 0.02).to(dtype)


# ---------------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMS norm computed in f32, cast back to ``x``'s dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


# ----------------------------------------------------------------- matmul
def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matmul whose result has the operands' dtype: bf16 x bf16 gives bf16
    accumulated in f32 and rounded once, as the reference's
    ``preferred_element_type=bf16`` dot. PyTorch's bf16 matmul accumulates
    in f32; ``repro_torch`` pins cuBLAS's bf16 split-K reduction off, so
    the one rounding is the last."""
    return a @ b


# ----------------------------------------------------------------------- mlp
def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, act: str, dtype):
    p = {"w_up": dense_init(gen, d_model, (d_model, d_ff), dtype),
         "w_down": dense_init(gen, d_ff, (d_ff, d_model), dtype)}
    if act == "swiglu":
        p["w_gate"] = dense_init(gen, d_model, (d_model, d_ff), dtype)
    return p


def apply_mlp(p, x: torch.Tensor, act: str) -> torch.Tensor:
    up = x @ p["w_up"]
    if act == "swiglu":
        h = F.silu(x @ p["w_gate"]) * up
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(up, approximate="tanh")
    return mm(h, p["w_down"])


# ----------------------------------------------------------------------- rope
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Half-rotation RoPE. x: [..., S, H, D] or [..., H, D]; positions
    broadcastable to the S axis (or scalar for single-token decode).
    Angles, cos and sin in f32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                    # [d/2]
    positions = torch.as_tensor(positions, device=x.device)
    angles = positions[..., None].float() * freqs             # [..., S, d/2]
    if x.dim() == angles.dim() + 2:                           # add head axis
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------ embedding
def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Token embedding lookup (the reference's single-device ``take``)."""
    return table[tokens]


def pad_vocab(vocab: int, multiple: int = 512) -> int:
    return ((vocab + multiple - 1) // multiple) * multiple
