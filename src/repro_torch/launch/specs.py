"""Per-cell step builders (torch port of ``repro.launch.specs``).

``build_cell(arch, shape, mesh, step)`` installs the cell's sharding rules
and returns the step, its abstract inputs and the in / out specs. The
abstract inputs are ``meta`` tensors (``Model.abstract_params`` for the
params): shapes and dtypes with no allocation, the counterpart of the
reference's ``jax.eval_shape`` / ``ShapeDtypeStruct``, so a cell of any
arch at full size, deepseek's and kimi's included, is built on any host.
The specs are :class:`dist.sharding.P` trees.

Step selection by shape kind: train -> train_step, prefill -> prefill,
decode/long_decode -> serve_step. ``fl_round`` builds the mesh-parallel FL
round (the paper's technique) for any train-shape cell;
``train_compressed`` the hierarchical compressed-pod-sync step.

A cell runs as the reference's ``jax.jit(cell.fn, in_shardings=...)``
does: build it on a ``DeviceMesh`` (``launch.mesh.device_mesh``), lay the
concrete inputs out with ``dist.sharding.place`` (``n_stack=
Model.stacked_dims`` for params), then call ``cell.fn``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.dist import sharding as shd
from repro_torch.dist.grad_sync import (make_compressed_train_step,
                                        make_train_step)
from repro_torch.fed.mesh_round import make_fl_round_step
from repro_torch.models import Model
from repro_torch.optim import make_optimizer
from repro_torch.tree import tree_items

P = shd.P


def _abstract(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


class Cell(NamedTuple):
    fn: Any
    args: Tuple
    in_shardings: Tuple
    out_shardings: Any
    donate_argnums: Tuple[int, ...]
    meta: Dict[str, Any]


def batch_abstract(cfg: ModelConfig, shape: ShapeConfig
                   ) -> Dict[str, torch.Tensor]:
    b, s = shape.global_batch, shape.seq_len
    out = {"tokens": _abstract((b, s), torch.int32),
           "labels": _abstract((b, s), torch.int32)}
    if cfg.family == "encdec":
        out["frames"] = _abstract((b, s, cfg.d_model), torch.bfloat16)
    if cfg.family == "vlm":
        v = cfg.vision
        out["patches"] = _abstract((b, v.n_patches, v.d_vision),
                                   torch.bfloat16)
    return out


def depth_variants(cfg: ModelConfig):
    """Two reduced-depth configs for cost extrapolation (cost is linear in
    the scanned unit count m: cost(m) = top + m*body). Returns ((ovr_a,
    m_a), (ovr_b, m_b), m_full)."""
    if cfg.family == "vlm":
        v = cfg.vision
        per = cfg.n_layers // v.n_cross_layers
        return (({"n_layers": per,
                  "vision": dataclasses.replace(v, n_cross_layers=1)}, 1),
                ({"n_layers": 2 * per,
                  "vision": dataclasses.replace(v, n_cross_layers=2)}, 2),
                v.n_cross_layers)
    if cfg.family == "encdec":
        e = cfg.encdec
        return (({"n_layers": 2,
                  "encdec": dataclasses.replace(e, n_enc_layers=2)}, 2),
                ({"n_layers": 4,
                  "encdec": dataclasses.replace(e, n_enc_layers=4)}, 4),
                cfg.n_layers)
    if cfg.family == "moe":
        fd = cfg.moe.first_dense_layers
        return (({"n_layers": fd + 1}, 1), ({"n_layers": fd + 3}, 3),
                cfg.n_layers - fd)
    if cfg.family == "hybrid":
        return (({"n_layers": 2, "global_layers": (0,)}, 2),
                ({"n_layers": 4, "global_layers": (0,)}, 4), cfg.n_layers)
    return (({"n_layers": 2}, 2), ({"n_layers": 4}, 4), cfg.n_layers)


def choose_n_micro(cfg: ModelConfig, shape: ShapeConfig, mesh) -> int:
    """Gradient-accumulation factor bounding activation memory: target
    per-device tokens per microbatch (tighter for FSDP archs, whose memory
    is dominated by params and grads)."""
    msh = shd.mesh_axes(mesh)
    n_batch = msh.get("pod", 1) * msh.get("data", 1)
    b_loc = max(shape.global_batch // n_batch, 1)
    tokens_per_dev = b_loc * shape.seq_len
    fsdp = cfg.n_params() >= cfg.fsdp_threshold
    target = 4096 if fsdp else 16384
    if cfg.family == "hybrid":   # parallel attn+SSM branches double the
        target = 8192            # per-token activation footprint
    if cfg.family == "moe" and fsdp:
        # FSDP expert-weight gathers repeat per microbatch: fewer, larger
        # microbatches trade activation memory for gather traffic
        target = 8192
    n_micro = 1
    while (tokens_per_dev // n_micro > target
           and n_micro * 2 <= shape.global_batch
           and shape.global_batch % (n_micro * 2) == 0):
        n_micro *= 2
    return n_micro


def _metric_specs(cfg: ModelConfig, extra=()) -> Dict[str, P]:
    """A step's metrics, each replicated: ``ce`` and ``loss``, the moe
    family's ``aux``, an MTP head's ``mtp``, and ``extra``."""
    names = ["ce", "loss", *extra]
    if cfg.moe is not None:
        names.append("aux")
    if cfg.mtp_depth:
        names.append("mtp")
    return {k: P() for k in names}


def build_cell(arch: str, shape_name: str, mesh, step: str = "auto",
               *, optimizer: str = "sgd", lr: float = 1e-2,
               fl_local_steps: int = 2, compressed_cr: float = 0.01,
               overrides: Optional[dict] = None,
               n_micro: Optional[int] = None, device="cuda") -> Cell:
    """The cell's step, abstract inputs and specs on ``mesh`` (abstract or
    a ``DeviceMesh``), with its rules installed. ``device``: the model's
    (the step's tensors live there when it runs)."""
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    rules = shd.make_rules(cfg, shape, mesh)
    shd.set_rules(rules)
    model = Model(cfg, device=device)
    params_abs = model.abstract_params()
    pspecs = shd.param_specs(cfg, params_abs)

    if step == "auto":
        step = {"train": "train", "prefill": "prefill",
                "decode": "serve", "long_decode": "serve"}[shape.kind]

    meta = {"arch": arch, "shape": shape_name, "step": step,
            "n_params": cfg.n_params(), "n_active": cfg.n_active_params(),
            "n_devices": math.prod(shd.mesh_axes(mesh).values()),
            "cfg": cfg}

    if step in ("train", "train_compressed"):
        opt = make_optimizer(optimizer, lr)
        opt_abs = opt.init(params_abs)
        ospecs = (_opt_specs_like(opt_abs, pspecs)
                  if tree_items(opt_abs) else opt_abs)
        batch_abs = batch_abstract(cfg, shape)
        bspecs = shd.batch_specs(cfg, batch_abs)
        if step == "train":
            nm = (n_micro if n_micro is not None
                  else choose_n_micro(cfg, shape, mesh))
            meta["n_micro"] = nm
            meta["cost_multiplier"] = nm
            fn = make_train_step(model, opt, n_micro=nm,
                                 grad_shardings=pspecs)
            return Cell(fn, (params_abs, opt_abs, batch_abs),
                        (pspecs, ospecs, bspecs),
                        (pspecs, ospecs, _metric_specs(cfg)), (0, 1), meta)
        n_pods = max(shd.mesh_axes(mesh).get("pod", 1), 2)
        # single-pod: compress across 2 data halves (same machinery)
        fn = make_compressed_train_step(model, opt, n_pods=n_pods,
                                        wire_cr=compressed_cr, gamma=2.0)
        crs_abs = _abstract((n_pods,), torch.float32)
        coef_abs = _abstract((n_pods,), torch.float32)
        return Cell(fn, (params_abs, opt_abs, batch_abs, crs_abs, coef_abs),
                    (pspecs, ospecs, bspecs, P(), P()),
                    (pspecs, ospecs, _metric_specs(cfg, ("wire_cr",))),
                    (0, 1), meta)

    if step == "prefill":
        batch_abs = batch_abstract(cfg, shape)
        bspecs = shd.batch_specs(cfg, batch_abs)

        def fn(params, batch):
            with shd.layout_context(params), torch.no_grad():
                return model.prefill(params, batch)[0]

        return Cell(fn, (params_abs, batch_abs), (pspecs, bspecs),
                    rules.logical(("batch", "vocab")), (), meta)

    if step == "serve":
        b = shape.global_batch
        cache_abs = model.abstract_cache(b, shape.seq_len, torch.bfloat16)
        cspecs = shd.cache_specs(cfg, cache_abs)
        tok_abs = _abstract((b,), torch.int32)
        pos_abs = _abstract((), torch.int32)

        def fn(params, cache, tokens, pos):
            with shd.layout_context(params), torch.no_grad():
                return model.decode_step(params, cache, tokens, pos)

        return Cell(fn, (params_abs, cache_abs, tok_abs, pos_abs),
                    (pspecs, cspecs, rules.logical(("batch",)), P()),
                    (rules.logical(("batch", "vocab")), cspecs), (1,), meta)

    if step == "fl_round":
        n_clients = rules.batch_size()
        # cap the per-client batch: one client maps to one data slice, so
        # its whole local batch lands on that slice's devices
        bs = min(max(shape.global_batch // n_clients, 1), 4)
        lead = (n_clients, fl_local_steps, bs)
        cb = {"tokens": _abstract(lead + (shape.seq_len,), torch.int32),
              "labels": _abstract(lead + (shape.seq_len,), torch.int32)}
        if cfg.family == "encdec":
            cb["frames"] = _abstract(lead + (shape.seq_len, cfg.d_model),
                                     torch.bfloat16)
        if cfg.family == "vlm":
            v = cfg.vision
            cb["patches"] = _abstract(lead + (v.n_patches, v.d_vision),
                                      torch.bfloat16)
        cbspec = shd.map_shapes(
            lambda s: P(*((rules.batch_axes,) + (None,) * (len(s) - 1))),
            cb)
        coef_abs = _abstract((n_clients,), torch.float32)
        crs_abs = _abstract((n_clients,), torch.float32)
        fn = make_fl_round_step(model, lr_local=lr)
        meta["n_clients"] = n_clients
        meta["cost_multiplier"] = fl_local_steps
        return Cell(fn, (params_abs, cb, coef_abs, crs_abs),
                    (pspecs, cbspec, P(), P()), (pspecs, P()), (0,), meta)

    raise ValueError(f"unknown step {step!r}")


def _opt_specs_like(opt_abs, pspecs):
    """Optimizer-state specs mirroring param specs (momentum/adam trees)."""
    if isinstance(opt_abs, dict) and "m" in opt_abs:   # adamw
        return {"m": pspecs, "v": pspecs, "t": P()}
    return pspecs                                       # momentum


def init_params(cell: Cell, seed: int, device_mesh, device=None):
    """The cell's params drawn from ``seed`` straight into their layout on
    ``device_mesh`` (``Model.init`` with a ``sharding.Placer``): every rank
    draws the same stream and keeps its share, a layer at a time."""
    mesh_dev = shd._mesh_device(device_mesh)
    model = Model(cell.meta["cfg"], device=device or mesh_dev)
    placer = shd.Placer(cell.args[0], cell.in_shardings[0], device_mesh,
                        Model.stacked_dims, device=device)
    return model.init(seed, placer=placer)


def place_args(cell: Cell, args, device_mesh, device=None) -> tuple:
    """Concrete inputs (the same values on every rank) laid out as the
    cell's ``in_shardings`` (``sharding.place``; stacked param leaves as
    ``Model.stacked_dims`` says). A DTensor tree passes as it is."""
    out = []
    for a, spec in zip(args, cell.in_shardings):
        leaves = tree_items(a)
        if not leaves or shd.is_dtensor(leaves[0][1]):
            out.append(a)
        else:
            out.append(shd.place(a, spec, device_mesh,
                                 n_stack=Model.stacked_dims, device=device))
    return tuple(out)
