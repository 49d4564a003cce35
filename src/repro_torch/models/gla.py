"""Chunked gated linear attention: RWKV-6's WKV recurrence and the SSD
(Mamba-2) selective scan of hymba's SSM branch.

Port of ``repro.models.gla``. Recurrence (per batch b, head h; Dk the key
dim, Dv the value dim):

    S_t = diag(exp(g_t)) S_{t-1} + k_t ⊗ v_t          (g_t <= 0)
    o_t = r_t · S_{t-1} + (r_t · (u ⊙ k_t)) v_t        [rwkv mode, bonus u]
    o_t = r_t · S_t                                    [ssd mode, inclusive]

The chunked algorithm factors decay products as exp of *differences* of
cumulative log-decay, which are <= 0 within a chunk once the masked region
is clamped, so f32 needs no range tricks. Vector (per-channel) decay builds
an explicit ``[c, c, Dk]`` log-space tensor; scalar (per-head) decay a
``[c, c]`` decay matrix beside one matmul. Everything is computed in f32.
Serving walks the chunks with a Python loop; nothing here keeps what a
backward pass would need (the vector chunk works in place on its pairwise
tensor).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _causal_mask(c: int, inclusive: bool, device) -> torch.Tensor:
    i = torch.arange(c, device=device)
    return (i[:, None] >= i[None, :]) if inclusive else (i[:, None] > i[None, :])


def _bonus(r, u, k):
    """The rwkv bonus ``einsum("...d,hd,...d->...", r, u, k)``: the current
    token's own contribution. r, k: [B, H, c, Dk]; u: [H, Dk]."""
    return (r * u[None, :, None, :] * k).sum(-1)


def _chunk_vector(r, k, v, g, u, s0, inclusive: bool):
    """One chunk, per-channel decay. r, k, g: [B,H,c,Dk]; v: [B,H,c,Dv];
    u: [H,Dk] or None; s0: [B,H,Dk,Dv]."""
    c = r.shape[2]
    cin = torch.cumsum(g, dim=2)                      # inclusive cumsum
    qdec = cin if inclusive else cin - g              # decay on the queries
    # inter-chunk: (r ⊙ exp(qdec)) · S0
    o = torch.matmul(r * torch.exp(qdec), s0)
    # intra-chunk pairwise: A[i,j] = sum_d r[i,d] k[j,d] exp(qdec[i,d]-cin[j,d]).
    # One [B,H,c,c,Dk] tensor, worked in place: the mask before exp keeps the
    # j > i region at exp(<= 0) (it is zeroed below), where exp of a positive
    # difference would overflow to inf and inf * 0 give NaN.
    w = qdec[:, :, :, None, :] - cin[:, :, None, :, :]
    w.clamp_(max=0.0).exp_()
    w.mul_(r[:, :, :, None, :]).mul_(k[:, :, None, :, :])
    scores = w.sum(-1)
    del w
    scores = torch.where(_causal_mask(c, inclusive, r.device), scores, 0.0)
    o = o + torch.matmul(scores, v)
    if u is not None:  # rwkv bonus: the current token contributes through u
        o = o + _bonus(r, u, k)[..., None] * v
    # S' = diag(exp(cin_last)) S0 + sum_j exp(cin_last - cin_j) k_j ⊗ v_j
    cl = cin[:, :, -1:, :]                            # [B,H,1,Dk]
    k_dec = k * torch.exp(cl - cin)
    s1 = torch.exp(cl[:, :, 0, :, None]) * s0 + torch.matmul(
        k_dec.transpose(-1, -2), v)
    return o, s1


def _chunk_scalar(r, k, v, g, u, s0, inclusive: bool):
    """One chunk, per-head scalar decay. g: [B,H,c]; u: [H,Dk] or None."""
    c = r.shape[2]
    cin = torch.cumsum(g, dim=2)
    qdec = cin if inclusive else cin - g
    o = torch.matmul(r * torch.exp(qdec)[..., None], s0)
    dmat = torch.exp(torch.clamp(qdec[:, :, :, None] - cin[:, :, None, :],
                                 max=0.0))
    scores = torch.matmul(r, k.transpose(-1, -2)) * dmat
    scores = torch.where(_causal_mask(c, inclusive, r.device), scores, 0.0)
    o = o + torch.matmul(scores, v)
    if u is not None:  # bonus: the current token weighted by u
        o = o + _bonus(r, u, k)[..., None] * v
    cl = cin[:, :, -1:]
    k_dec = k * torch.exp(cl - cin)[..., None]
    s1 = torch.exp(cl)[..., None] * s0 + torch.matmul(k_dec.transpose(-1, -2),
                                                      v)
    return o, s1


def chunked_gla(r, k, v, g, *, u: Optional[torch.Tensor] = None,
                chunk: int = 64, inclusive: bool = False,
                initial_state: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequence-parallel gated linear attention.

    r, k: [B, H, T, Dk]; v: [B, H, T, Dv];
    g: log-decay, [B, H, T, Dk] (vector) or [B, H, T] (scalar), g <= 0.
    u: [H, Dk] rwkv bonus. inclusive=True -> SSD semantics.
    Returns (o [B, H, T, Dv], final_state [B, H, Dk, Dv]), in f32. T must
    be a multiple of ``chunk``, as the reference asserts.
    """
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    scalar = g.dim() == 3
    r, k, v, g = r.float(), k.float(), v.float(), g.float()
    if u is not None:
        u = u.float()
    if initial_state is None:
        s = torch.zeros((b, h, dk, dv), dtype=torch.float32, device=r.device)
    else:
        s = initial_state.float()
    assert t % chunk == 0, f"T={t} not divisible by chunk={chunk}"
    body = _chunk_scalar if scalar else _chunk_vector
    outs = []
    for lo in range(0, t, chunk):
        sl = slice(lo, lo + chunk)
        o, s = body(r[:, :, sl], k[:, :, sl], v[:, :, sl], g[:, :, sl], u, s,
                    inclusive)
        outs.append(o)
    return torch.cat(outs, dim=2), s


def _step(r, k, v, g, state, u, inclusive: bool):
    """One step of the recurrence in the inputs' own dtype."""
    decay = torch.exp(g)
    if g.dim() == 2:  # scalar per head
        decay = decay[..., None]
    kv = k[..., :, None] * v[..., None, :]
    if inclusive:
        state = decay[..., None] * state + kv
        o = torch.einsum("bhd,bhde->bhe", r, state)
    else:
        eff = state + u[None, :, :, None] * kv if u is not None else state
        o = torch.einsum("bhd,bhde->bhe", r, eff)
        state = decay[..., None] * state + kv
    return o, state


def gla_decode(r, k, v, g, state, *, u: Optional[torch.Tensor] = None,
               inclusive: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token recurrent step. r, k, g: [B,H,Dk] (g scalar: [B,H]);
    v: [B,H,Dv]; state: [B,H,Dk,Dv]. Returns (o [B,H,Dv], new_state), in
    f32; the state passed in is not written."""
    return _step(r.float(), k.float(), v.float(), g.float(), state.float(),
                 None if u is None else u.float(), inclusive)


def reference_recurrence(r, k, v, g, *, u=None, inclusive=False,
                         initial_state=None):
    """O(T) sequential oracle for tests. Same shapes as ``chunked_gla``."""
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    s = (torch.zeros((b, h, dk, dv), dtype=torch.float32, device=r.device)
         if initial_state is None else initial_state.float())
    outs = []
    for i in range(t):
        o, s = gla_decode(r[:, :, i], k[:, :, i], v[:, :, i], g[:, :, i], s,
                          u=u, inclusive=inclusive)
        outs.append(o)
    return torch.stack(outs, dim=2), s


def summation_bound(r, k, v, g, *, chunk: int, u=None, inclusive=False,
                    initial_state=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-element bounds on how far two f32 evaluations of the recurrence
    (chunked or stepped, in any summation order) may lie apart:
    ``(chunk + Dk + 8) * 2^-24 * A``, with A the same recurrence run in f64
    on ``|r|, |k|, |v|`` (and ``|u|``, ``|initial_state|``) under the same
    decays. Every term of A is then nonnegative, so A is the sum of the
    magnitudes of the products that make each output, and the bound counts
    a ``chunk``-term intra-chunk sum, a ``Dk``-term product with the
    carried state and 8 more roundings, each at most 2^-24 of that sum. It
    leaves out the rounding of the cumulative log-decays, whose error grows
    with the chunk's ``sum |g|`` (G): a strong decay (G in the hundreds)
    needs ``2 (chunk + 1) * 2^-24 * G * A`` more. Returns the bounds on
    (o [B,H,T,Dv], final_state [B,H,Dk,Dv])."""
    b, h, t, dk = r.shape
    a64 = lambda x: x.double().abs()
    s = (torch.zeros((b, h, dk, v.shape[-1]), dtype=torch.float64,
                     device=r.device)
         if initial_state is None else a64(initial_state))
    ra, ka, va, gd = a64(r), a64(k), a64(v), g.double()
    ua = None if u is None else a64(u)
    outs = []
    for i in range(t):
        o, s = _step(ra[:, :, i], ka[:, :, i], va[:, :, i], gd[:, :, i], s,
                     ua, inclusive)
        outs.append(o)
    scale = (chunk + dk + 8) * 2.0 ** -24
    return torch.stack(outs, dim=2) * scale, s * scale
