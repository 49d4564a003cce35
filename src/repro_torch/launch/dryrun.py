"""Multi-pod dry run (torch port of ``repro.launch.dryrun``): build every
(architecture x input shape) cell on the production meshes and record
its per-device memory, cost, collectives and roofline terms, with no card.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Writes one JSON per cell under ``<out>/<mesh>/<arch>__<shape>[__step].json``
(``pod1``: the 16 x 16 mesh of 256 ranks; ``pod2``: 2 x 16 x 16, 512), with
the reference's record keys.

A cell runs once, for rank 0, on fake tensors. A fake process group of
the mesh's size (``init_process_group("fake", ...)``, no peers and no
transport) realises the mesh as a CPU ``DeviceMesh``; ``specs.build_cell``
builds the step on it; every input leaf becomes a DTensor whose local
piece is a fake tensor of the shape rank 0 holds (nothing is allocated and
no whole leaf is made, then cut); the step runs under ``FakeTensorMode``
and ``roofline.op_cost.OpCounter``, which counts rank 0's dot FLOPs,
bytes, collectives and live memory. The process group is destroyed and
the previous sharding rules restored after each cell; importing this
module changes nothing.

Record keys, as the reference's, with the port's meaning where it differs:

  * ``memory``: ``argument_bytes`` (rank 0's shares of the inputs),
    ``output_bytes`` (of the outputs), ``temp_bytes`` (the step's peak of
    live bytes above the arguments, the outputs live at that moment
    included), ``alias_bytes`` (outputs that reuse an argument's storage:
    the serve step's caches, written in place; the optimizers work out of
    place, so a train step's new params and state are fresh and alias
    nothing), ``per_device_bytes`` = arguments + temp (the step's peak),
    and ``fits_80gb``: the peak below the card's memory
    (``analysis.DEVICE_MEMORY_BYTES``) in place of the reference's
    ``fits_16gib``;
  * ``lower_s``: building the step and laying out its inputs;
    ``compile_s``: the counted fake run; ``hlo_analysis_s``: the roofline
    arithmetic (no HLO exists here);
  * ``cost`` and ``roofline``: ``OpCounter``'s counts and
    ``analysis.Roofline`` under the H100's constants; ``n_collectives`` is
    the number of collectives that ran (the reference writes -1).

A cell that raises is recorded with ``ok: false`` and its error, and
``main`` exits non-zero when any cell failed. Run it as its own process.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from typing import Optional, Union

from repro_torch.configs import ARCH_IDS, SHAPES, applicability, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.roofline import analysis as roofline

POD_SIZE = 256


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """A fake process group of ``world_size`` ranks, this process rank 0,
    destroyed on exit. Collectives on it move nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("dryrun: a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def fake_inputs(args, in_shardings, device_mesh, n_stack, fake_mode):
    """The cell's abstract inputs as DTensors on ``device_mesh`` whose
    local pieces are this rank's shares, made empty under ``fake_mode`` at
    their local shapes; no whole leaf is made. (The shapes are worked out
    before the mode is entered: DTensor's arithmetic for them reads
    tensors.)"""
    import torch
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from repro_torch.dist import sharding as shd
    from repro_torch.tree import tree_from_items, tree_items
    geom = []
    for tree, specs in zip(args, in_shardings):
        spec_of = dict(shd.tree_items_p(specs))
        leaves = []
        for path, x in tree_items(tree):
            shape = tuple(x.shape)
            spec = spec_of.get(path, spec_of.get((), shd.P()))
            plc = shd.stack_placements(spec, shape, device_mesh,
                                       n_stack(path))
            local, _ = compute_local_shape_and_global_offset(
                shape, device_mesh, plc)
            leaves.append((path, shape, tuple(local), plc, x.dtype))
        geom.append(leaves)
    out = []
    with fake_mode:
        for leaves in geom:
            out.append(tree_from_items(
                (path, shd.from_local(torch.empty(local, dtype=dtype),
                                      device_mesh, plc, shape))
                for path, shape, local, plc, dtype in leaves))
    return tuple(out)


def _local_storages(tree):
    import torch
    from torch.utils._pytree import tree_leaves
    out = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            local = getattr(t, "_local_tensor", t)
            st = local.untyped_storage()
            out.setdefault(st._cdata, local.numel() * local.element_size())
    return out


def count_cell(arch: str, shape: Union[str, ShapeConfig], mesh,
               step: str = "auto", overrides: Optional[dict] = None,
               n_micro: Optional[int] = None) -> dict:
    """Build the cell on a fake process group of ``mesh``'s size and run
    it once for rank 0 on fake inputs under an ``OpCounter``. Returns
    ``{"cell", "counter", "memory", "lower_s", "compile_s"}``."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.launch.specs import build_cell
    from repro_torch.models import Model
    from repro_torch.roofline.op_cost import OpCounter
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    pod_size = POD_SIZE if "pod" in mesh.axis_names else None
    prev_rules = shd.get_rules()
    with fake_process_group(mesh.size):
        try:
            t0 = time.perf_counter()
            dm = device_mesh(mesh, "cpu")
            cell = build_cell(arch, shape, dm, step, overrides=overrides,
                              n_micro=n_micro, device="cpu")
            fake = FakeTensorMode(allow_non_fake_inputs=True)
            counter = OpCounter(pod_size, fake)
            args = fake_inputs(cell.args, cell.in_shardings, dm,
                               Model.stacked_dims, fake)
            if cell.meta["step"] == "serve":
                # decode reads its position on the host: the last of the
                # cache's, one new token against a cache of seq_len
                pos = torch.tensor(shape.seq_len - 1, dtype=torch.int32)
                args = args[:3] + (shd.from_local(
                    pos, dm, shd.placements(shd.P(), dm), ()),)
            t_lower = time.perf_counter() - t0
            with fake:
                with counter:
                    counter.track_args(args)
                    out = cell.fn(*args)
                t_run = time.perf_counter() - t0 - t_lower
                arg_st = _local_storages(args)
                out_st = _local_storages(out)
                del out, args
        finally:
            shd.set_rules(prev_rules)
    output = sum(out_st.values())
    alias = sum(nb for key, nb in out_st.items() if key in arg_st)
    per_dev = counter.arg_bytes + counter.temp_bytes
    memory = {
        "argument_bytes": counter.arg_bytes,
        "output_bytes": output,
        "temp_bytes": counter.temp_bytes,
        "alias_bytes": alias,
        "per_device_bytes": per_dev,
        "per_device_gib": round(per_dev / 2**30, 3),
        "fits_80gb": per_dev < roofline.DEVICE_MEMORY_BYTES,
        "allocs_at_peak": counter.allocs_at_peak,
    }
    return {"cell": cell, "counter": counter, "memory": memory,
            "lower_s": t_lower, "compile_s": t_run}


def run_cell(arch: str, shape_name: Union[str, ShapeConfig], mesh,
             mesh_tag: str, step: str = "auto",
             out_dir: str = "experiments/dryrun", verbose: bool = True,
             overrides=None) -> dict:
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    shape_name = shape.name
    cfg = get_config(arch)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_tag, "step": step}
    ok, reason = applicability(cfg, shape)
    if not ok:
        rec.update(skipped=True, reason=reason)
        _write(rec, out_dir, mesh_tag, arch, shape_name, step)
        if verbose:
            print(f"[skip] {arch} × {shape_name} ({mesh_tag}): {reason}")
        return rec
    try:
        res = count_cell(arch, shape, mesh, step, overrides)
        cell, counter = res["cell"], res["counter"]
        t1 = time.perf_counter()
        mflops = roofline.model_flops(cell.meta["cfg"], shape)
        rf = roofline.analyze(counter, mesh.size, mflops)
        t_analysis = time.perf_counter() - t1
        rec.update(
            skipped=False, step=cell.meta["step"],
            n_params=cell.meta["n_params"], n_active=cell.meta["n_active"],
            n_micro=cell.meta.get("n_micro"),
            lower_s=round(res["lower_s"], 2),
            compile_s=round(res["compile_s"], 2),
            hlo_analysis_s=round(t_analysis, 2),
            memory=res["memory"],
            cost={"flops_per_device": float(counter.flops),
                  "bytes_per_device": float(counter.bytes)},
            model_flops_global=mflops,
            roofline=rf.to_dict(),
        )
        if verbose:
            mem = rec["memory"]
            print(f"[ok]   {arch} × {shape_name} ({mesh_tag}, {rec['step']}): "
                  f"{mem['per_device_gib']} GiB/dev "
                  f"(fits={mem['fits_80gb']}), "
                  f"dom={rf.dominant}, frac={rf.compute_fraction:.3f}, "
                  f"build {res['lower_s']:.1f}s run {res['compile_s']:.1f}s")
    except Exception as e:  # a failing cell is a bug — record it loudly
        rec.update(skipped=False, ok=False, error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        if verbose:
            print(f"[FAIL] {arch} × {shape_name} ({mesh_tag}): "
                  f"{type(e).__name__}: {e}")
    rec.setdefault("ok", "error" not in rec)
    _write(rec, out_dir, mesh_tag, arch, shape_name, step)
    return rec


def _write(rec, out_dir, mesh_tag, arch, shape_name, step):
    d = os.path.join(out_dir, mesh_tag)
    os.makedirs(d, exist_ok=True)
    suffix = "" if step == "auto" else f"__{step}"
    path = os.path.join(d, f"{arch}__{shape_name}{suffix}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--step", default="auto",
                    choices=["auto", "train", "train_compressed", "prefill",
                             "serve", "fl_round"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)

    meshes = []
    if args.mesh in ("single", "both"):
        meshes.append(("pod1", make_production_mesh(multi_pod=False)))
    if args.mesh in ("multi", "both"):
        meshes.append(("pod2", make_production_mesh(multi_pod=True)))

    archs = ARCH_IDS if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]

    n_fail = 0
    for tag, mesh in meshes:
        for arch in archs:
            for shape in shapes:
                rec = run_cell(arch, shape, mesh, tag, args.step, args.out)
                if not rec.get("skipped") and not rec.get("ok", True):
                    n_fail += 1
    if n_fail:
        raise SystemExit(f"{n_fail} cells FAILED")
    print("all requested cells passed")


if __name__ == "__main__":
    main()
