"""Optimizers over trees of tensors (torch port of ``repro.optim.optimizers``):
SGD, momentum-SGD, AdamW, global-norm clipping.

Trees are nested dicts of tensors (``repro_torch.tree``). State structures
are the reference's, so a checkpoint of ``(params, opt_state)`` crosses
packages: ``()`` for sgd, a tree of f32 zeros for momentum, and
``{"m", "v", "t"}`` for adamw with ``t`` an int32 scalar tensor.

Rounding follows the reference op for op. JAX's Python-float constants are
weakly typed: they take the other operand's dtype before the op, so every
scalar here becomes a 0-d tensor of that dtype first (``lr`` rounded to bf16
for a bf16 param; ``1 - b1`` computed as a Python double, then rounded to
f32). Those constants are made on the device once and cached, so an update
copies nothing from the host. Updates are out of place: the inputs are left
as they were.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.tree import tree_from_items, tree_items, tree_leaves


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]  # (grads, state, params)


@functools.lru_cache(maxsize=None)
def _constant(x: float, dtype: torch.dtype, device: torch.device
              ) -> torch.Tensor:
    return torch.full((), x, dtype=dtype, device=device)


def _scalar(x: float, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """A weakly typed constant: ``x`` rounded to ``dtype`` (``like``'s by
    default) as a 0-d tensor on ``like``'s device. Read only."""
    return _constant(x, dtype or like.dtype, like.device)


def _map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    others = [tree_leaves(r) for r in rest]
    return tree_from_items(
        (path, fn(x, *(o[i] for o in others)))
        for i, (path, x) in enumerate(tree_items(tree)))


def sgd(lr: float) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params):
        return _map(lambda p, g: p - _scalar(lr, p) * g.to(p.dtype),
                    params, grads), state

    return Optimizer(init, update)


def momentum(lr: float, beta: float = 0.9) -> Optimizer:
    f32 = torch.float32

    def init(params):
        return _map(lambda p: torch.zeros(p.shape, dtype=f32,
                                          device=p.device), params)

    def update(grads, state, params):
        new_m = _map(lambda m, g: _scalar(beta, m) * m + g.to(f32),
                     state, grads)
        new_p = _map(lambda p, m: p - _scalar(lr, p) * m.to(p.dtype),
                     params, new_m)
        return new_p, new_m

    return Optimizer(init, update)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    f32 = torch.float32

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=f32, device=p.device)
        dev = tree_leaves(params)[0].device
        return {"m": _map(zeros, params), "v": _map(zeros, params),
                "t": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, state, params):
        t = state["t"] + 1
        tf = t.to(f32)
        # 1 - b ** t: an f32 power of the f32-rounded constant
        bc1 = 1.0 - torch.pow(_scalar(b1, tf), tf)
        bc2 = 1.0 - torch.pow(_scalar(b2, tf), tf)

        def upd(p, g, m, v):
            gf = g.to(f32)
            m2 = _scalar(b1, m) * m + _scalar(1 - b1, m) * gf
            v2 = _scalar(b2, v) * v + _scalar(1 - b2, v) * gf * gf
            step = (_scalar(lr, m2) * (m2 / bc1)
                    / (torch.sqrt(v2 / bc2) + _scalar(eps, v2)))
            if weight_decay:
                step = step + _scalar(lr * weight_decay, step) * p.to(f32)
            return (p.to(f32) - step).to(p.dtype), m2, v2

        paths = [path for path, _ in tree_items(params)]
        out = [upd(*leaves) for leaves in zip(
            tree_leaves(params), tree_leaves(grads), tree_leaves(state["m"]),
            tree_leaves(state["v"]))]
        new_p, new_m, new_v = (tree_from_items(zip(paths, col))
                               for col in zip(*out))
        return new_p, {"m": new_m, "v": new_v, "t": t}

    return Optimizer(init, update)


def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` so their global L2 norm is at most ``max_norm``;
    returns (clipped grads, the norm). Squares are summed in f32 leaf by
    leaf, and the leaves' sums added in the reference's leaf order."""
    flats = [torch.sum(g.to(torch.float32) ** 2) for g in tree_leaves(grads)]
    norm = torch.sqrt(sum(flats))
    # max_norm / x as one f32 division (a Python float on the left of a
    # tensor would take its reciprocal, then multiply)
    scale = torch.minimum(_scalar(1.0, norm),
                          torch.div(_scalar(max_norm, norm),
                                    norm + _scalar(1e-12, norm)))
    return _map(lambda g: g * scale.to(g.dtype), grads), norm


def make_optimizer(name: str, lr: float, weight_decay: float = 0.0) -> Optimizer:
    if name == "sgd":
        return sgd(lr)
    if name == "momentum":
        return momentum(lr)
    if name == "adamw":
        return adamw(lr, weight_decay=weight_decay)
    raise ValueError(f"unknown optimizer {name!r}")

