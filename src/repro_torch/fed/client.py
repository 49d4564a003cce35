"""FL client of the legacy engine (torch port of ``repro.fed.client``): E
local epochs of plain SGD on one client, update = w_t - w_local (paper
Alg. 1 LocalTraining). Model-agnostic: any ``loss_fn(params, batch) ->
(loss, aux)`` on a dict of tensors.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch


def make_local_trainer(loss_fn: Callable, lr: float):
    """``local_train(params, batches) -> (delta, last_loss)``.

    ``batches`` is a dict of tensors with a leading ``[n_steps, ...]`` axis
    (E epochs already flattened into steps). Each step is
    ``p <- p - lr * grad`` with autograd, and its loss is taken AFTER the
    update, on the same batch — the reference's order (it evaluates every
    step's and keeps the last; only the last is evaluated here). Returns
    the delta dict ``params - final`` and that loss (a 0-d tensor).
    """
    def local_train(params: Dict[str, torch.Tensor],
                    batches: Dict[str, torch.Tensor]
                    ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        n_steps = next(iter(batches.values())).shape[0]
        cur = {k: v.detach() for k, v in params.items()}
        for s in range(n_steps):
            batch = {k: b[s] for k, b in batches.items()}
            live = {k: v.requires_grad_(True) for k, v in cur.items()}
            grads = torch.autograd.grad(loss_fn(live, batch)[0],
                                        list(live.values()))
            with torch.no_grad():
                cur = {k: p.detach() - lr * g
                       for (k, p), g in zip(live.items(), grads)}
        with torch.no_grad():
            loss = loss_fn(cur, batch)[0]
            delta = {k: params[k] - cur[k] for k in cur}
        return delta, loss

    return local_train
