"""Centralised training (torch port of ``repro.launch.train``): the
dense data-parallel step, or with ``--compressed-pods N`` the hierarchical
BCRS/OPWA gradient sync over N virtual pods (the paper's technique applied
to multi-pod data parallelism; ``dist.grad_sync``), every leaf of at least
4096 elements merged through ``threshold_find`` + ``fused_merge`` on the
card.

The host side is the reference's: the per-pod CRs from
``core.bcrs.pod_link_schedule`` in f64 over virtual links of 100 / (i + 1)
Gbit/s, and one ``synthetic_lm_tokens`` batch a step from one
``np.random.default_rng(seed)`` stream. Checkpoints of ``(params,
opt_state)`` are in the reference's on-disk format, and a run resumes
from the newest one. On resume the port draws (and drops) the batches of
the steps already done, so a resumed run consumes the data an
uninterrupted one would; the reference restarts its stream at the first
batch (ROADMAP §3, R4). The encdec batches also hold ``frames`` [B, S,
d_model] and the vlm batches ``patches`` [B, n_patches, d_vision], f32
normals drawn from the same stream right after each step's tokens, as the
reference draws them.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
        [--reduced --device cpu] --steps 100 --batch 8 --seq 256 \\
        [--compressed-pods 4 --wire-cr 0.05] [--checkpoint-dir ckpt/]
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.bcrs import pod_link_schedule
from repro_torch.data import synthetic_lm_tokens
from repro_torch.device import resolve_device, synchronize
from repro_torch.dist.grad_sync import (init_compressed_state,
                                        make_compressed_train_step,
                                        make_train_step)
from repro_torch.models import Model
from repro_torch.optim import make_optimizer
from repro_torch.tree import tree_items

#: the OPWA amplification the reference's ``launch.train`` uses
GAMMA = 2.0


@dataclass
class TrainConfig:
    """Everything a run needs (the CLI below is a thin veneer): the
    reference's flags and defaults, plus ``device``."""
    arch: str = "stablelm-1.6b"
    steps: int = 50
    batch: int = 8
    seq: int = 256
    lr: float = 1e-2
    optimizer: str = "sgd"
    reduced: bool = False
    compressed_pods: int = 0     # N >= 2: BCRS sync across N virtual pods
    wire_cr: float = 0.05
    checkpoint_dir: str = ""
    checkpoint_every: int = 20
    seed: int = 0
    device: str = "cuda"


def _draw(cfg: TrainConfig, model_cfg, rng) -> dict:
    """One step's batch as numpy, drawn from ``rng`` in the reference's
    order: the tokens, then the encdec family's frames or the vlm family's
    patches (f64 normals, cast to f32)."""
    toks = synthetic_lm_tokens(cfg.batch, cfg.seq + 1, model_cfg.vocab_size,
                               rng)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if model_cfg.family == "encdec":
        out["frames"] = rng.normal(0, 1, (cfg.batch, cfg.seq,
                                          model_cfg.d_model))
    if model_cfg.family == "vlm":
        v = model_cfg.vision
        out["patches"] = rng.normal(0, 1, (cfg.batch, v.n_patches,
                                           v.d_vision))
    return out


def _batch(cfg: TrainConfig, model_cfg, rng, dev) -> dict:
    out = {}
    for k, a in _draw(cfg, model_cfg, rng).items():
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return out


def run(cfg: TrainConfig, init_params=None) -> dict:
    """Train per ``cfg``; returns {params, opt_state, losses (one a step
    run), steps_run, wall_per_step (host seconds, each step ending in a
    synchronize), resumed_from, pod_crs (f64, compressed runs)}.

    ``init_params`` (optional): the starting params as a nested dict of
    arrays (e.g. the reference's ``Model.init``, carried across by
    ``convert.model_params_to_torch``); by default ``Model.init(cfg.seed)``
    draws them on the device."""
    dev = resolve_device(cfg.device)
    model_cfg = get_config(cfg.arch)
    if cfg.reduced:
        model_cfg = model_cfg.reduced()
    model = Model(model_cfg, device=dev)
    rng = np.random.default_rng(cfg.seed)
    opt = make_optimizer(cfg.optimizer, cfg.lr)

    params = (model.init(cfg.seed) if init_params is None
              else convert.model_params_to_torch(init_params, device=dev))
    # compressed sync carries per-pod error-feedback residuals in opt_state
    opt_state = (init_compressed_state(opt, params,
                                       n_pods=cfg.compressed_pods)
                 if cfg.compressed_pods else opt.init(params))
    start_step, resumed_from = 0, None
    if cfg.checkpoint_dir and ckpt.latest_step(cfg.checkpoint_dir) is not None:
        try:
            (params, opt_state), start_step, _extra = ckpt.restore(
                cfg.checkpoint_dir, (params, opt_state))
        except KeyError as e:
            raise SystemExit(
                f"[train] checkpoint in {cfg.checkpoint_dir} does not match "
                f"the current optimizer-state structure (missing {e}); it was "
                f"likely written with a different --compressed-pods / "
                f"--optimizer setting") from e
        resumed_from = start_step
        print(f"[train] resumed from step {start_step}")

    pod_crs = None
    if cfg.compressed_pods:
        n_pods = cfg.compressed_pods
        step_fn = make_compressed_train_step(
            model, opt, n_pods=n_pods, wire_cr=cfg.wire_cr, gamma=GAMMA)
        # heterogeneous virtual DCN links -> BCRS per-pod CRs
        n_flat = sum(int(p.numel()) for _, p in tree_items(params))
        pod_crs = pod_link_schedule([100.0 / (i + 1) for i in range(n_pods)],
                                    v_bytes=4 * n_flat,
                                    cr_star=cfg.wire_cr / 2,
                                    cr_max=cfg.wire_cr)
        crs_t = torch.from_numpy(np.asarray(pod_crs, np.float32)).to(dev)
        coeffs_t = torch.full((n_pods,), 1.0 / n_pods, dtype=torch.float32,
                              device=dev)
        print(f"[train] compressed pod sync: CRs={np.round(pod_crs, 4)}")
    else:
        step_fn = make_train_step(model, opt)

    for _ in range(start_step):
        # the batches of the steps already done (see the module docstring)
        _draw(cfg, model_cfg, rng)
    losses: List[float] = []
    walls: List[float] = []
    t0 = time.time()
    for step in range(start_step, cfg.steps):
        batch = _batch(cfg, model_cfg, rng, dev)
        synchronize(dev)
        ts = time.perf_counter()
        if cfg.compressed_pods:
            params, opt_state, metrics = step_fn(params, opt_state, batch,
                                                 crs_t, coeffs_t)
        else:
            params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])      # waits for the step
        synchronize(dev)
        walls.append(time.perf_counter() - ts)
        losses.append(loss)
        del batch, metrics
        if step % 10 == 0 or step == cfg.steps - 1:
            print(f"[train] step {step} loss {loss:.4f} "
                  f"({time.time() - t0:.1f}s)")
        if (cfg.checkpoint_dir and cfg.checkpoint_every
                and (step + 1) % cfg.checkpoint_every == 0):
            ckpt.save(cfg.checkpoint_dir, step + 1, (params, opt_state),
                      extra={"arch": cfg.arch})
    print("[train] done")
    return {"params": params, "opt_state": opt_state, "losses": losses,
            "steps_run": list(range(start_step, cfg.steps)),
            "wall_per_step": walls, "resumed_from": resumed_from,
            "pod_crs": pod_crs}


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="stablelm-1.6b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--optimizer", default="sgd",
                    choices=["sgd", "momentum", "adamw"])
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--compressed-pods", type=int, default=0,
                    help="N>=2: hierarchical BCRS sync across N virtual pods")
    ap.add_argument("--wire-cr", type=float, default=0.05)
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.compressed_pods and not args.compressed_pods >= 2:
        ap.error(f"--compressed-pods must be >= 2 (got {args.compressed_pods})")
    run(TrainConfig(
        arch=args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
        lr=args.lr, optimizer=args.optimizer, reduced=args.reduced,
        compressed_pods=args.compressed_pods, wire_cr=args.wire_cr,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every, seed=args.seed,
        device=args.device))


if __name__ == "__main__":
    main()
