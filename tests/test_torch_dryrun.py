"""The port's dry run (``repro_torch.launch.dryrun``) on the production
meshes, on fake process groups of 256 and 512 ranks.

One test drives a child process (a fake process group is a process-wide
setting; each cell makes and destroys its own). It runs ``run_cell`` for
one arch per family, each cut in depth (``chip_smoke.cut_config``: dense
and encdec at 2 layers, ssm at 1, hybrid at 2, moe at one dense layer and
one MoE layer, vlm at one group) at its full width, on small shapes
(train B 32 x S 128, prefill 32 x 128, decode 128 against a 128-token
cache), for every step kind on the single-pod mesh (16 x 16) and for
``train``, ``train_compressed``, ``fl_round`` and ``prefill`` on the
two-pod mesh (2 x 16 x 16), every family but ssm. The two-pod ``serve``
cells and ssm's two-pod cells are left to ``--all``: there DTensor's
redistribution planner (torch 2.13 plans shards of one dim over two mesh
axes by a graph search) takes ~5 minutes or more a cell. Each record is
written to a temporary directory, and the test checks:

  * every cell's record keys, the reference's, and its JSON file at
    ``<out>/<mesh>/<arch>__<shape>__<step>.json``;
  * a cell that ran: ``ok``, per-device memory, cost and roofline under
    the H100's constants, FLOPs counted (its dots) and its peak at least
    its arguments;
  * each cell the port's layout cannot run yet (ROADMAP §3, F7-F10): ``ok``
    false with the error DTensor or the model raised, as the dry run must
    record it;
  * a planted failure (an unknown step kind) recorded as ``ok: false``
    with its error and traceback, and ``main`` exiting non-zero when a
    cell fails.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ARCHS = {"dense": "stablelm-1.6b", "moe": "deepseek-v3-671b",
         "ssm": "rwkv6-1.6b", "hybrid": "hymba-1.5b",
         "encdec": "whisper-medium", "vlm": "llama-3.2-vision-11b"}
STEPS = ("train", "train_compressed", "fl_round", "prefill", "serve")
MULTI_STEPS = ("train", "train_compressed", "fl_round", "prefill")
MULTI_FAMILIES = ("dense", "moe", "hybrid", "encdec", "vlm")

# the port's open layout faults on the production meshes (ROADMAP §3)
F7 = "Cannot unflatten unevenly sharded tensor"        # heads vs 16 ranks
F8_SINGLE = "Cannot flatten unevenly sharded tensor"    # fl_round's batch
F8_MULTI = "would remove or reshape sharded dimension"
F9 = "is invalid for input of size"                     # pods on the pod axis
F10 = "AssertionError"                                  # encdec decode's pos


def expected(family: str, mesh: str, step: str):
    """None when the cell runs, else a fragment of its recorded error."""
    if step == "fl_round":
        return F8_SINGLE if mesh == "pod1" else F8_MULTI
    if family in ("hybrid", "vlm"):
        if mesh == "pod2" and step == "train_compressed":
            return F9
        return F7
    if mesh == "pod2" and step == "train_compressed":
        return F9
    if step == "serve" and family == "ssm":
        return F7
    if step == "serve" and family == "encdec":
        return F10
    return None


CHILD = textwrap.dedent("""
    import dataclasses, json, sys, time
    sys.path.insert(0, {root!r})
    import torch
    torch.set_num_threads(1)
    from chip_smoke import cut_config
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    out = sys.argv[1]
    archs = json.loads(sys.argv[2])
    shapes = {{"train": ShapeConfig("train_t", 128, 32, "train"),
               "prefill": ShapeConfig("prefill_t", 128, 32, "prefill"),
               "decode": ShapeConfig("decode_t", 128, 128, "decode")}}
    kind = {{"train": "train", "train_compressed": "train",
             "fl_round": "train", "prefill": "prefill", "serve": "decode"}}

    def overrides(arch):
        cfg = get_config(arch)
        if cfg.family == "moe":
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, first_dense_layers=1))
            n = 2
        elif cfg.family == "vlm":
            n = cfg.n_layers // cfg.vision.n_cross_layers
        else:
            n = 1 if cfg.family == "ssm" else 2
        cut = cut_config(cfg, n)
        return {{f.name: getattr(cut, f.name)
                 for f in dataclasses.fields(cut) if f.name != "name"}}

    recs = []
    for tag, multi, steps, families in (
            ("pod1", False, {steps!r}, list(archs)),
            ("pod2", True, {multi_steps!r}, {multi_families!r})):
        mesh = make_production_mesh(multi_pod=multi)
        for family in families:
            arch = archs[family]
            for step in steps:
                t0 = time.perf_counter()
                rec = dryrun.run_cell(arch, shapes[kind[step]], mesh, tag,
                                      step, out, verbose=False,
                                      overrides=overrides(arch))
                rec["family"] = family
                rec["wall_s"] = time.perf_counter() - t0
                recs.append(rec)
    # a planted failure: a step kind build_cell does not know
    planted = dryrun.run_cell("stablelm-1.6b", shapes["train"],
                              make_production_mesh(), "pod1", "train_x",
                              out, verbose=False,
                              overrides={{"n_layers": 1}})
    # main exits non-zero when a cell fails
    real = dryrun.run_cell
    dryrun.run_cell = lambda *a, **k: dict(skipped=False, ok=False)
    try:
        dryrun.main(["--arch", "stablelm-1.6b", "--shape", "train_4k",
                     "--out", out])
        exit_msg = None
    except SystemExit as e:
        exit_msg = str(e)
    dryrun.run_cell = real
    import torch.distributed as dist
    json.dump(dict(recs=recs, planted=planted, exit_msg=exit_msg,
                   pg_left=dist.is_initialized()),
              open(out + "/result.json", "w"), default=str)
""")

RECORD_KEYS = {"arch", "shape", "mesh", "step", "skipped", "ok"}
RAN_KEYS = {"n_params", "n_active", "n_micro", "lower_s", "compile_s",
            "hlo_analysis_s", "memory", "cost", "model_flops_global",
            "roofline"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
               "per_device_bytes", "per_device_gib", "fits_80gb"}
ROOFLINE_KEYS = {"compute_s", "memory_s", "collective_s", "dominant",
                 "step_time_s", "compute_fraction", "hbm_fraction",
                 "model_flops_ratio", "flops_per_device", "bytes_per_device",
                 "wire_bytes_per_device", "coll_by_kind", "n_collectives"}


def test_dryrun_cells_on_the_production_meshes(tmp_path):
    from repro_torch.roofline import analysis as ta
    script = tmp_path / "child.py"
    script.write_text(CHILD.format(root=ROOT, steps=STEPS,
                                   multi_steps=MULTI_STEPS,
                                   multi_families=MULTI_FAMILIES))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src")] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p]))
    out = tmp_path / "out"
    r = subprocess.run([sys.executable, str(script), str(out),
                        json.dumps(ARCHS)], capture_output=True, text=True,
                       env=env, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    res = json.loads((out / "result.json").read_text())
    assert res["pg_left"] is False
    recs = res["recs"]
    assert len(recs) == (len(ARCHS) * len(STEPS)
                         + len(MULTI_FAMILIES) * len(MULTI_STEPS))
    ran = 0
    for rec in recs:
        where = f"{rec['arch']} {rec['mesh']} {rec['step']}"
        assert RECORD_KEYS <= set(rec), where
        path = out / rec["mesh"] / f"{rec['arch']}__{rec['shape']}__" \
            f"{rec['step']}.json"
        on_disk = json.loads(path.read_text())
        assert on_disk["ok"] == rec["ok"] and on_disk["mesh"] == rec["mesh"]
        want = expected(rec["family"], rec["mesh"], rec["step"])
        if want is None:
            assert rec["ok"] is True, (where, rec.get("error"))
            assert RAN_KEYS <= set(rec), where
            mem, rf = rec["memory"], rec["roofline"]
            assert MEMORY_KEYS <= set(mem), where
            assert ROOFLINE_KEYS == set(rf), where
            assert mem["per_device_bytes"] == (mem["argument_bytes"]
                                               + mem["temp_bytes"])
            assert mem["fits_80gb"] == (mem["per_device_bytes"]
                                        < ta.DEVICE_MEMORY_BYTES)
            assert mem["argument_bytes"] > 0 and mem["temp_bytes"] > 0
            assert rec["cost"]["flops_per_device"] > 0, where
            assert rf["flops_per_device"] == rec["cost"]["flops_per_device"]
            assert rf["compute_s"] == rf["flops_per_device"] / ta.PEAK_FLOPS
            assert rf["memory_s"] == rf["bytes_per_device"] / ta.HBM_BW
            n_dev = 256 if rec["mesh"] == "pod1" else 512
            assert rf["model_flops_ratio"] == pytest.approx(
                rec["model_flops_global"] / (rf["flops_per_device"] * n_dev))
            if rec["step"] == "serve":     # the caches, written in place
                assert mem["alias_bytes"] > 0
            else:                          # out of place: fresh outputs
                assert mem["alias_bytes"] == 0
            if rec["mesh"] == "pod2":      # the pod axis: groups of 2 cross
                assert any(k.startswith("dcn/") for k in rf["coll_by_kind"]) \
                    or rec["step"] == "prefill", where
            ran += 1
        else:
            assert rec["ok"] is False, where
            assert want in rec["error"], (where, rec["error"][:300])
            assert "traceback" in rec
    assert ran >= 12
    planted = res["planted"]
    assert planted["ok"] is False and planted["skipped"] is False
    assert planted["error"].startswith("ValueError: unknown step")
    assert "Traceback" in planted["traceback"]
    assert (out / "pod1" / "stablelm-1.6b__train_t__train_x.json").exists()
    assert res["exit_msg"] == "1 cells FAILED"
