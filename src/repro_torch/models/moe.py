"""Routed MoE with capacity-based dispatch into a dense ``[E, C, d]``
buffer.

Port of ``repro.models.moe``. Each token's router logits are
``x.f32 @ router`` (f32), its top-k experts those of the softmax, its
gates those k probabilities renormalised. A token's position in an
expert's buffer comes from ``_dispatch_positions``: the k routing slots in
order, each a one-hot cumsum over the tokens plus a per-expert count
carried from the slot before, so slot order and token order decide which
tokens an expert of capacity C keeps. A (token, slot) past its expert's
capacity is dropped: its gate is zeroed and it reads back nothing. Every
expert's FFN runs on its whole buffer as one batched product (static
shapes: a fixed capacity, fixed k, no host read, so the forward and
backward can be captured in a CUDA graph), and the shared experts are a
plain dense branch. The aux load-balancing term is Switch / GShard's, ``E *
sum(mean(probs) * mean(one_hot(top-1)))``.

Under sharding rules the tokens route per data shard, as the reference's
do: ``n_shards`` is the rules' batch size (1 when ``T`` does not divide
into shards of at least ``top_k`` tokens), capacity is counted per shard
and each shard dispatches into its own ``[E, C, d]`` buffer, the buffers
and the expert outputs laid out ``("batch", "experts", ...)``
(``dist.sharding.constrain``). Without rules there is one shard.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import constrain, get_rules
from repro_torch.models.layers import dense_init


def init_moe(gen: torch.Generator, d_model: int, mo, dtype):
    """The router (f32 ``[d, E]``), the experts' ``[E, d, d_e]`` /
    ``[E, d_e, d]`` stacks and, with ``n_shared``, the shared experts as
    one dense SwiGLU of width ``n_shared * (d_shared or d_expert)``."""
    e = mo.n_experts
    p = {
        "router": dense_init(gen, d_model, (d_model, e), torch.float32),
        "w_gate": dense_init(gen, d_model, (e, d_model, mo.d_expert), dtype),
        "w_up": dense_init(gen, d_model, (e, d_model, mo.d_expert), dtype),
        "w_down": dense_init(gen, mo.d_expert, (e, mo.d_expert, d_model),
                             dtype),
    }
    if mo.n_shared:
        ds = (mo.d_shared or mo.d_expert) * mo.n_shared
        p["shared"] = {
            "w_gate": dense_init(gen, d_model, (d_model, ds), dtype),
            "w_up": dense_init(gen, d_model, (d_model, ds), dtype),
            "w_down": dense_init(gen, ds, (ds, d_model), dtype),
        }
    return p


def capacity(mo, n_tokens: int) -> int:
    """Slots an expert keeps for ``n_tokens`` routed tokens:
    ``max(int(capacity_factor * T * k / E), k)``, the reference's."""
    return max(int(mo.capacity_factor * n_tokens * mo.top_k
                   / mo.n_experts), mo.top_k)


def _dispatch_positions(expert_idx: torch.Tensor, n_experts: int,
                        capacity: int):
    """expert_idx: [T, k] -> (positions [T, k] int32, keep [T, k]).

    Slot-sequential running count, as the reference's scan: for each of
    the k routing slots, a [T, E] one-hot cumsum over the tokens gives
    each token's rank in its expert, and a per-expert count carried from
    the earlier slots is added to it."""
    t, k = expert_idx.shape
    experts = torch.arange(n_experts, device=expert_idx.device)
    counts = torch.zeros(n_experts, dtype=torch.int32,
                         device=expert_idx.device)
    cols = []
    for j in range(k):
        idx = expert_idx[:, j]
        onehot = (idx[:, None] == experts).to(torch.int32)      # [T, E]
        ranks = torch.cumsum(onehot, 0, dtype=torch.int32) - 1
        cols.append(ranks.gather(1, idx[:, None])[:, 0] + counts[idx])
        counts = counts + onehot.sum(0, dtype=torch.int32)
    pos = torch.stack(cols, 1)
    return pos, pos < capacity


def route(p, xt: torch.Tensor, mo):
    """The router on tokens [T, d]: (probs [T, E] f32, gates [T, k] f32
    renormalised over the k, expert indices [T, k] in descending order of
    probability)."""
    logits = xt.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, mo.top_k, dim=-1)
    return probs, gate_vals / gate_vals.sum(-1, keepdim=True), expert_idx


def _local_moe(p, xt: torch.Tensor, mo, capacity: int):
    """One shard's routing and dispatch. xt: [T, d] -> (disp [E, C, d],
    combine [T, k] in x's dtype, expert indices [T, k], positions [T, k]
    with the dropped ones at C - 1, keep [T, k], aux).

    The buffer is filled as the reference's ``disp.at[ei, pi].add(xr *
    keep)``: a dropped (token, slot) adds its zeroed row into its expert's
    last slot, onto the kept row there or onto zeros. Only zeros ever land
    on a slot twice, and adding a zero leaves a value's bits as they are,
    so the add's order (atomics on the card) cannot change the result; its
    backward is a gather."""
    t, d = xt.shape
    e, k = mo.n_experts, mo.top_k
    probs, gate_vals, expert_idx = route(p, xt, mo)
    pos, keep = _dispatch_positions(expert_idx, e, capacity)
    pi = torch.where(keep, pos, capacity - 1)
    flat = (expert_idx * capacity + pi).reshape(-1)
    xr = (xt[:, None, :] * keep[..., None].to(xt.dtype)).reshape(t * k, d)
    disp = xt.new_zeros((e * capacity, d)).index_add(0, flat, xr)
    combine = (gate_vals * keep).to(xt.dtype)
    me = probs.mean(0)
    top1 = (expert_idx[:, :1] == torch.arange(e, device=xt.device))
    aux = e * torch.sum(me * top1.float().mean(0))
    return (disp.view(e, capacity, d), combine, expert_idx, pi, keep, aux)


def dropped_tokens(p, x: torch.Tensor, mo) -> int:
    """How many (token, slot) pairs ``apply_moe`` drops on x [B, S, d]:
    its routing on the same tokens at the same capacity (reads the count
    on the host)."""
    xt = x.reshape(-1, x.shape[-1])
    _, _, expert_idx = route(p, xt, mo)
    _, keep = _dispatch_positions(expert_idx, mo.n_experts,
                                  capacity(mo, xt.shape[0]))
    return int((~keep).sum())


def n_shards(mo, n_tokens: int) -> int:
    """Shards ``apply_moe`` routes ``n_tokens`` in: the installed rules'
    batch size, or 1 without rules, without a sharded batch, or when the
    tokens do not split into shards of at least ``top_k``."""
    rules = get_rules()
    if rules is None or not rules.shard_batch:
        return 1
    n = rules.batch_size()
    if n_tokens % n or n_tokens // n < mo.top_k:
        return 1
    return n


def apply_moe(p, x: torch.Tensor, *, mo, act: str = "swiglu"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (out [B, S, d], aux f32 scalar: the shards' mean),
    routed per shard (the module docstring). The expert products emit x's
    dtype, as the reference's ``preferred_element_type=x.dtype`` does for
    bf16; each token's k expert outputs are read back from its shard's
    slots (a dropped one from its expert's last slot, times a gate of 0)
    and summed weighted by the gates."""
    b, s, d = x.shape
    t = b * s
    ns = n_shards(mo, t)
    tl = t // ns
    cap = capacity(mo, tl)
    xt = constrain(x.reshape(ns, tl, d), ("batch", None, None))
    shards = [_local_moe(p, xt[i], mo, cap) for i in range(ns)]
    e, k = mo.n_experts, mo.top_k
    if ns == 1:
        disp = shards[0][0]                              # [E, C, d]
    else:
        disp = constrain(torch.stack([sh[0] for sh in shards]),
                         ("batch", "experts", None, None))
        disp = disp.transpose(0, 1).reshape(e, ns * cap, d)
    up = torch.bmm(disp, p["w_up"])
    if act == "swiglu":
        h = F.silu(torch.bmm(disp, p["w_gate"])) * up
    else:
        h = F.gelu(up, approximate="tanh")
    y = torch.bmm(h, p["w_down"])                   # [E, ns * C, d]
    outs = []
    if ns > 1:
        y = constrain(y.view(e, ns, cap, d).transpose(0, 1),
                      ("batch", "experts", None, None))
    for i, (_, combine, ei, pi, _, _) in enumerate(shards):
        ys = y if ns == 1 else y[i]
        yk = ys.reshape(-1, d).index_select(0, (ei * cap + pi).reshape(-1))
        outs.append(torch.bmm(combine[:, None, :], yk.view(tl, k, d)))
    if ns == 1:
        out, aux = outs[0].view(b, s, d), shards[0][5]
    else:
        out = constrain(torch.stack(outs).view(ns, tl, d),
                        ("batch", None, None)).reshape(b, s, d)
        aux = torch.mean(torch.stack([sh[5] for sh in shards]))
    if "shared" in p:
        sh = p["shared"]
        xt = x.reshape(t, d)
        su = xt @ sh["w_up"]
        if act == "swiglu":
            hh = F.silu(xt @ sh["w_gate"]) * su
        else:
            hh = F.gelu(su, approximate="tanh")
        out = out + (hh @ sh["w_down"]).view(b, s, d)
    return out, aux
