"""Train steps (torch port of ``repro.dist.grad_sync``): dense
data-parallel steps and the hierarchical BCRS/OPWA compressed pod sync (the
paper's technique applied to multi-pod data parallelism).

``make_train_step`` is the plain ``(params, opt_state, batch) -> (params,
opt_state, metrics)`` step with optional gradient-accumulation
microbatching and explicit grad shardings: under the multi-card layout
(``dist.sharding``: params and batch as DTensors) the accumulated
gradients are redistributed to ``grad_shardings`` before the optimizer
update, as the reference pins them (FSDP: grads land on the param layout).

``make_compressed_train_step`` splits the global batch over ``n_pods``
virtual pods, gives every pod its own gradient, and replaces the dense
all-reduce with the paper's compressed exchange: per-pod error-feedback
Top-K at the BCRS-scheduled ratios (``pod_crs``, clipped to the ``wire_cr``
budget; ``core.bcrs.pod_link_schedule`` produces them from heterogeneous
links), merged with overlap-weighted averaging (coords kept by <=
``overlap_d`` pods are amplified by ``gamma``). Compression, EF and the
merge run through ``fed.engine.compress_merge_leaf``, the pipeline the FL
round uses: on CUDA tensors under ``use_kernel="auto"`` each leaf of at
least ``min_leaf_size`` elements goes through ``threshold_find`` +
``fused_merge`` on a ``[n_pods, leaf_n]`` f32 view. At ``wire_cr=1.0``
every pod keeps everything and the step reproduces ``make_train_step``.

The reference vmaps the gradient over pods; here the pods run one after
another, each from ``Model.loss_fn`` on its ``[B/n_pods, S]`` slice, and
each pod's gradient lands in a preallocated ``[n_pods, *leaf]`` buffer in
the param's dtype (the dtype JAX gives the cotangent). A pod's gradient
depends on its own slice alone, so it is the one the vmap gives that pod.
Leaves are merged one at a time and their pod gradients freed once merged.

Under the layout each pod's gradient is pinned to its param's layout as
it comes, and each leaf's ``[n_pods, leaf_n]`` pod gradients and EF
residuals are brought whole (``full_tensor()``) before
``compress_merge_leaf`` (``sharding.leaf_whole``): the kernels take raw
pointers, and a pod's Top-K threshold is a selection over the whole leaf
(GSPMD gathers an opaque custom call's operands the same way). The merged
update and the new residuals go back to the leaf's layout. Without the
layout ``leaf_whole`` calls the same merge on the plain tensors.

Error-feedback residuals live in the optimizer state: init with
``init_compressed_state(opt, params, n_pods=N)`` and the step threads
``{"opt": <inner>, "ef": <[n_pods, ...] f32 residuals>}``; the residuals
are updated in place and returned (the reference donates them; at full
width a second copy would not fit). A bare ``opt.init`` state is also
accepted: residuals start at zero and are dropped on return, so the state
keeps its structure.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from repro_torch.core import compression as comp
from repro_torch.core import strategies as strat_mod
from repro_torch.dist import sharding as shd
from repro_torch.fed.engine import compress_merge_leaf
from repro_torch.tree import tree_from_items, tree_items

Metrics = Dict[str, torch.Tensor]


def loss_and_grads(loss_fn: Callable, params, batch
                   ) -> Tuple[torch.Tensor, Metrics, List[torch.Tensor]]:
    """``loss_fn(params, batch) -> (loss, metrics)`` and its gradient:
    (loss, metrics, one gradient per leaf of ``tree_items(params)`` in the
    param's dtype; zeros for a leaf the loss does not use)."""
    items = tree_items(params)
    live = [p.detach().requires_grad_(True) for _, p in items]
    with shd.layout_context(params):
        loss, metrics = loss_fn(tree_from_items(
            zip([k for k, _ in items], live)), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for (_, p), g in zip(items, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def _rows(batch: dict, lo: int, hi: int) -> dict:
    return {k: v[lo:hi] for k, v in batch.items()}


def _batch_size(batch: dict) -> int:
    return int(tree_items(batch)[0][1].shape[0])


# ------------------------------------------------------------------ dense step
def make_train_step(model, opt, *, n_micro: int = 1,
                    grad_shardings=None) -> Callable:
    """Dense DP train step. ``n_micro`` > 1 runs fwd+bwd over microbatches
    in order (bounded activation memory), accumulating grads in f32 as
    ``acc + g.f32 / n_micro`` and loss and metrics as ``acc + v / n_micro``,
    the reference's scan. ``grad_shardings``: a :class:`sharding.P` tree
    matching params (each stacked leaf realised as ``Model.stacked_dims``
    says, ``sharding.stack_placements``) or a tree of DTensor placements;
    DTensor gradients are redistributed to it before the update, plain
    ones (one device holds all of them) pass as they are."""
    f32 = torch.float32

    def step(params, opt_state, batch):
        with shd.layout_context(params):
            return _step(params, opt_state, batch)

    def _step(params, opt_state, batch):
        items = tree_items(params)
        if n_micro == 1:
            loss, metrics, grads = loss_and_grads(model.loss_fn, params,
                                                  batch)
        else:
            b = _batch_size(batch)
            if b % n_micro:
                raise ValueError(
                    f"global batch {b} not divisible by n_micro={n_micro}")
            mb = b // n_micro
            grads = [torch.zeros_like(p, dtype=f32) for _, p in items]
            loss, metrics = None, None
            for i in range(n_micro):
                l, m, g = loss_and_grads(model.loss_fn, params,
                                         _rows(batch, i * mb, (i + 1) * mb))
                for acc, gg in zip(grads, g):
                    acc.add_(gg.to(f32) / n_micro)
                del g
                if loss is None:
                    loss = torch.zeros(l.shape, dtype=f32, device=l.device)
                    metrics = {k: torch.zeros(v.shape, dtype=f32,
                                              device=v.device)
                               for k, v in m.items()}
                loss = loss + l / n_micro
                metrics = {k: a + m[k] / n_micro for k, a in metrics.items()}
        if grad_shardings is not None:
            grads = shd.pin(items, grads, grad_shardings,
                            getattr(model, "stacked_dims", None))
        new_params, new_state = opt.update(
            tree_from_items(zip([k for k, _ in items], grads)), opt_state,
            params)
        out = dict(metrics)
        out["loss"] = loss
        return new_params, new_state, out

    return step


# ------------------------------------------------------ compressed-state init
def _zero_ef(params, n_pods: int):
    return tree_from_items((path, shd.zeros_lead(p, n_pods))
                           for path, p in tree_items(params))


def init_compressed_state(opt, params, *, n_pods: int):
    """Optimizer state + per-pod f32 error-feedback residuals."""
    return {"opt": opt.init(params), "ef": _zero_ef(params, n_pods)}


def _is_wrapped(opt_state) -> bool:
    return (isinstance(opt_state, dict) and len(opt_state) == 2
            and "opt" in opt_state and "ef" in opt_state)


def pod_gradients(loss_fn: Callable, params, batch, n_pods: int
                  ) -> Tuple[List[torch.Tensor], torch.Tensor, Metrics]:
    """Each pod's gradient on its ``[B/n_pods, ...]`` slice of ``batch``,
    one pod at a time: (one ``[n_pods, *leaf]`` buffer per leaf of
    ``tree_items(params)`` in the param's dtype, losses f32 [n_pods],
    metrics {name: [n_pods]}). Under the layout a leaf's entry is a
    DTensor, each pod's gradient laid out as its param."""
    items = tree_items(params)
    bp = _batch_size(batch) // n_pods
    laid_out = shd.is_dtensor(items[0][1])
    bufs = [[] if laid_out else torch.empty(
        (n_pods,) + tuple(p.shape), dtype=p.dtype, device=p.device)
        for _, p in items]
    losses, metrics = [], []
    for i in range(n_pods):
        l, m, g = loss_and_grads(loss_fn, params,
                                 _rows(batch, i * bp, (i + 1) * bp))
        for buf, gg, (_, p) in zip(bufs, g, items):
            if laid_out:
                buf.append(gg.redistribute(p.device_mesh, p.placements))
            else:
                buf[i].copy_(gg)
        del g
        losses.append(shd.full(l).to(torch.float32))
        metrics.append({k: shd.full(v) for k, v in m.items()})
    if laid_out:
        bufs = [torch.stack(b) for b in bufs]
    return (bufs, torch.stack(losses),
            {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]})


# ------------------------------------------------------------- compressed step
def make_compressed_train_step(model, opt, *, n_pods: int,
                               wire_cr: float = 0.05, gamma: float = 1.0,
                               min_leaf_size: int = 4096, overlap_d: int = 1,
                               use_kernel="auto",
                               strategy: str = "bcrs_opwa") -> Callable:
    """Returns ``step(params, opt_state, batch, pod_crs, pod_coeffs)``.

    pod_crs: f32 [n_pods] BCRS compression ratios; pod_coeffs: f32
    [n_pods] averaging coefficients p'_i (1/n_pods reproduces the dense
    mean). Leaves smaller than ``min_leaf_size`` are exchanged dense (an f32
    ``tensordot`` with the coefficients, no EF).

    ``strategy`` names a registered compressing strategy; its capabilities
    pick the merge (``overlap_weighted`` -> OPWA vs the plain coefficient
    sum) and the optional ``value_codec`` (``qtopk``'s int8 quantizer: EF
    absorbs its error). Codec strategies take the kernel route only where
    they registered a ``kernel_codec`` (``fused_merge``'s codec stage).
    ``use_kernel``: "auto" (the kernels for CUDA tensors, the plain path
    for CPU tensors), True or False, as ``compress_merge_leaf`` takes it.
    Pod sync always runs error feedback: residuals are structural in the
    wrapped optimizer state."""
    if n_pods < 2:
        # with a single pod every kept coordinate has overlap 1 <= overlap_d,
        # so OPWA would silently scale all gradients by gamma (an LR change,
        # not a sync strategy) — use make_train_step instead
        raise ValueError(f"n_pods must be >= 2, got {n_pods}")
    strat = strat_mod.get(strategy)
    if not strat.compresses:
        raise ValueError(
            f"strategy {strategy!r} does not compress; use make_train_step "
            f"for dense sync")
    opwa = strat.overlap_weighted
    value_codec = strat.value_codec
    kernel_codec = strat.kernel_codec

    def step(params, opt_state, batch, pod_crs, pod_coeffs):
        with shd.layout_context(params):
            return _step(params, opt_state, batch, pod_crs, pod_coeffs)

    def _step(params, opt_state, batch, pod_crs, pod_coeffs):
        b = _batch_size(batch)
        if b % n_pods:
            raise ValueError(
                f"global batch {b} not divisible by n_pods={n_pods}")
        wrapped = _is_wrapped(opt_state)
        if wrapped:
            lead = tree_items(opt_state["ef"])[0][1].shape[0]
            if lead != n_pods:
                raise ValueError(
                    f"opt_state carries EF residuals for {lead} pods but the "
                    f"step was built with n_pods={n_pods} (checkpoint / "
                    f"--compressed-pods mismatch)")
        inner = opt_state["opt"] if wrapped else opt_state
        ef = opt_state["ef"] if wrapped else _zero_ef(params, n_pods)

        pods, losses, metrics = pod_gradients(model.loss_fn, params, batch,
                                              n_pods)
        dev = losses.device
        crs = torch.clamp(shd.full(pod_crs).to(device=dev,
                                                dtype=torch.float32),
                          0.0, wire_cr)
        coeffs = shd.full(pod_coeffs).to(device=dev, dtype=torch.float32)

        def merge(g, e):
            """One leaf's whole pod gradients [n_pods, *leaf] and residuals
            -> (its aggregate, its new residuals; None for a dense leaf)."""
            n = g[0].numel()
            gf = g.reshape(n_pods, n).to(torch.float32)
            if n < min_leaf_size:             # dense exchange, no EF
                return (torch.tensordot(coeffs, gf, dims=([0], [0]))
                        .reshape(g.shape[1:]), None)
            agg, new_e = compress_merge_leaf(
                gf, coeffs, comp.k_for_ratio_traced(n, crs), gamma=gamma,
                overlap_d=overlap_d, opwa=opwa, use_kernel=use_kernel,
                residuals=e.reshape(n_pods, n), value_codec=value_codec,
                kernel_codec=kernel_codec)
            return agg.reshape(g.shape[1:]), new_e.reshape(e.shape)

        agg_items = []
        for i, ((path, p), (_, e)) in enumerate(zip(tree_items(params),
                                                    tree_items(ef))):
            g, pods[i] = pods[i], None        # freed once merged
            # under the layout the leaf is merged whole (sharding.leaf_whole)
            agg, new_e = shd.leaf_whole(merge, (g, e), (p, e))
            del g
            if new_e is not None:
                if shd.is_dtensor(e):
                    e, new_e = e.to_local(), new_e.to_local()
                e.copy_(new_e)
            agg_items.append((path, agg))

        new_params, new_inner = opt.update(tree_from_items(agg_items),
                                           inner, params)
        out = {k: torch.mean(v) for k, v in metrics.items()}
        out["loss"] = torch.mean(losses)
        out["wire_cr"] = torch.mean(crs)
        new_state = ({"opt": new_inner, "ef": ef} if wrapped
                     else new_inner)
        return new_params, new_state, out

    return step
