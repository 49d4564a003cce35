"""Core layers: norms, MLP, embedding, RoPE, the loss.

Port of what the dense, hybrid and ssm families' forward, decode and
training need from ``repro.models.layers``. Params are plain nested dicts of tensors;
layer-stacked groups carry a leading ``[L, ...]`` axis that the model walks
with a Python loop. Initialisers draw from an explicit ``torch.Generator``
and put the tensors on that generator's device.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import constrain, get_rules, whole_dim


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
    """RMS norm computed in f32, cast back to ``x``'s dtype (on a DTensor
    sharded on the normed dim, that dim gathered first: ``whole_dim``)."""
    xf = whole_dim(x).float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Layer norm computed in f32, cast back to ``x``'s dtype (the normed
    dim gathered first on a DTensor, as ``rms_norm``)."""
    xf = whole_dim(x).float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def group_norm_heads(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     n_heads: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over each head's channels (RWKV's wkv output norm), in f32,
    cast back to ``x``'s dtype. x: [..., C]."""
    shp = x.shape
    xh = x.reshape(shp[:-1] + (n_heads, shp[-1] // n_heads)).float()
    mu = torch.mean(xh, dim=-1, keepdim=True)
    var = torch.mean((xh - mu) ** 2, dim=-1, keepdim=True)
    xh = (xh - mu) * torch.rsqrt(var + eps)
    out = xh.reshape(shp) * scale.float() + bias.float()
    return out.to(x.dtype)


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
    """Token embedding lookup: the reference's single-device ``take``, and
    under sharding rules its one-hot contraction (``embed_onehot``), which
    a sharded table contracts shard by shard."""
    if get_rules() is None:
        return table[tokens]
    return embed_onehot(table, tokens)


def embed_onehot(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Token embedding as the reference's one-hot contraction (its route
    under mesh rules, ``einsum("...v,vd->...d", one_hot, table)``): the
    same rows as ``embed_lookup`` (one nonzero term a sum), but its
    backward is a matmul, which the card runs in the same order every run.
    The gather's backward accumulates repeated tokens with atomics on CUDA,
    in an order that may change from run to run. Training uses this one.
    Under rules the one-hot's vocab dim is laid out as the table's
    (``constrain``), so the contraction stays shard-local."""
    vocab = torch.arange(table.shape[0], device=tokens.device,
                         dtype=tokens.dtype)
    onehot = (tokens[..., None] == vocab).to(table.dtype)
    onehot = constrain(onehot, ("batch",) + (None,) * (onehot.dim() - 2)
                       + ("vocab",))
    return onehot @ table


# ----------------------------------------------------------------------- loss
def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_logical: int) -> torch.Tensor:
    """Mean next-token CE over vocab-padded logits: f32 logits, padded
    columns masked to -1e9 before the logsumexp, the label logit picked by
    an iota compare, as the reference computes it. On a DTensor the vocab
    dim is gathered first (``whole_dim``): the logsumexp and the label
    pick reduce over it."""
    v_pad = logits.shape[-1]
    lf = whole_dim(logits).to(torch.float32)
    cols = torch.arange(v_pad, device=logits.device)
    if v_pad != vocab_logical:
        lf = torch.where(cols < vocab_logical, lf, -1e9)
    lse = torch.logsumexp(lf, dim=-1)
    onehot = labels[..., None] == cols.to(labels.dtype)
    label_logit = torch.where(onehot, lf, 0.0).sum(dim=-1)
    return torch.mean(lse - label_logit)


def pad_vocab(vocab: int, multiple: int = 512) -> int:
    return ((vocab + multiple - 1) // multiple) * multiple
