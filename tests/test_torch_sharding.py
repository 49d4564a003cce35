"""Port parity of the multi-card layout's pure parts: ``repro_torch.dist.
sharding``, ``repro_torch.launch.{mesh,specs}`` against ``repro.dist.
sharding`` and ``repro.launch.specs`` computed live, with no devices.

What is held (exactly, entry for entry; a one-name tuple equals the name,
as JAX's ``PartitionSpec`` compares them):
  * ``param_specs``, ``batch_specs`` and ``cache_specs`` for every arch x
    every shape x both production meshes: the reference's on
    ``jax.eval_shape(Model.init)`` / ``init_cache`` against the port's on
    ``Model.abstract_params`` / ``abstract_cache`` (meta tensors), both
    against the port's abstract mesh (the reference's spec functions read
    only ``axis_names`` and ``shape``);
  * the production meshes; ``make_rules``'s batch axes for odd global
    batches; ``Rules.logical`` on unknown names; ``use_rules`` restoring;
  * ``constrain`` returning its argument itself without rules, on a rank
    mismatch, and for a plain tensor under rules;
  * ``choose_n_micro``, ``depth_variants`` and ``batch_abstract``;
  * ``placements`` on a one-process CPU ``DeviceMesh`` (gloo);
  * ``build_cell`` for each step: abstract inputs on ``meta`` with the
    shapes and dtypes of the reference's cell (built on a
    ``jax.sharding.AbstractMesh``), its meta counts, specs equal to the
    spec functions'.
"""
import dataclasses
import functools
import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as PJ

from repro.configs import ARCH_IDS, SHAPES
from repro.configs import get_config as get_config_j
from repro.dist import sharding as shd_j
from repro.launch import specs as specs_j
from repro.models import Model as ModelJ
from repro_torch.configs import SHAPES as SHAPES_T
from repro_torch.configs import get_config as get_config_t
from repro_torch.dist import sharding as shd_t
from repro_torch.launch import mesh as mesh_t
from repro_torch.launch import specs as specs_t
from repro_torch.models import Model as ModelT
from repro_torch.tree import tree_items

MESHES = {"pod": mesh_t.make_production_mesh(),
          "multi_pod": mesh_t.make_production_mesh(multi_pod=True)}


@pytest.fixture(autouse=True)
def _no_rules():
    """Every test starts and ends without installed rules."""
    shd_t.set_rules(None)
    shd_j.set_rules(None)
    yield
    shd_t.set_rules(None)
    shd_j.set_rules(None)


def _norm(entry):
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        return entry[0] if len(entry) == 1 else entry
    return entry


def _specs_j(tree):
    return [tuple(_norm(e) for e in sp) for sp in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, PJ))]


def _specs_t(tree):
    return [tuple(_norm(e) for e in sp)
            for _, sp in shd_t.tree_items_p(tree)]


@functools.lru_cache(maxsize=None)
def _params_abs(arch):
    pj = jax.eval_shape(ModelJ(get_config_j(arch)).init,
                        jax.random.PRNGKey(0))
    pt = ModelT(get_config_t(arch), device="cpu").abstract_params()
    return pj, pt


def _cache_abs(arch, shape):
    cfg_j = get_config_j(arch)
    b, s = shape.global_batch, shape.seq_len
    cj = jax.eval_shape(lambda: ModelJ(cfg_j).init_cache(b, s,
                                                         jnp.bfloat16))
    ct = ModelT(get_config_t(arch), device="cpu").abstract_cache(
        b, s, torch.bfloat16)
    return cj, ct


def _shapes_agree(tj, tt):
    lj = jax.tree.leaves(tj)
    lt = [x for _, x in tree_items(tt)]
    assert [tuple(x.shape) for x in lj] == [tuple(x.shape) for x in lt]
    assert [np.dtype(x.dtype).name for x in lj] == \
        [str(x.dtype).replace("torch.", "") for x in lt]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_trees_match_the_reference(arch, shape_name, mesh_name):
    mesh = MESHES[mesh_name]
    cfg_j, cfg_t = get_config_j(arch), get_config_t(arch)
    shape_j, shape_t = SHAPES[shape_name], SHAPES_T[shape_name]
    pj, pt = _params_abs(arch)
    _shapes_agree(pj, pt)
    cj, ct = _cache_abs(arch, shape_j)
    _shapes_agree(cj, ct)
    bj = specs_j.batch_abstract(cfg_j, shape_j)
    bt = specs_t.batch_abstract(cfg_t, shape_t)
    _shapes_agree(bj, bt)
    with shd_j.use_rules(shd_j.make_rules(cfg_j, shape_j, mesh)):
        want = [_specs_j(shd_j.param_specs(cfg_j, pj)),
                _specs_j(shd_j.batch_specs(cfg_j, bj)),
                _specs_j(shd_j.cache_specs(cfg_j, cj))]
    with shd_t.use_rules(shd_t.make_rules(cfg_t, shape_t, mesh)):
        got = [_specs_t(shd_t.param_specs(cfg_t, pt)),
               _specs_t(shd_t.batch_specs(cfg_t, bt)),
               _specs_t(shd_t.cache_specs(cfg_t, ct))]
    assert got == want
    # the model axis shards something in every arch's params
    assert any("model" in sp for sp in got[0])


def test_production_meshes():
    m1, m2 = MESHES["pod"], MESHES["multi_pod"]
    assert (m1.axis_names, m1.shape, m1.size) == (
        ("data", "model"), {"data": 16, "model": 16}, 256)
    assert (m2.axis_names, m2.shape, m2.size) == (
        ("pod", "data", "model"), {"pod": 2, "data": 16, "model": 16}, 512)
    m3 = mesh_t.make_mesh_from_spec((8, 32, 16), ("pod", "data", "model"))
    assert m3.size == 4096 and list(m3.shape) == ["pod", "data", "model"]
    with pytest.raises(ValueError):
        mesh_t.make_mesh_from_spec((2, 2), ("data",))


@pytest.mark.parametrize("gb", [1, 2, 3, 16, 24, 32, 48, 512])
def test_make_rules_drops_batch_axes_for_odd_batches(gb):
    cfg_j, cfg_t = get_config_j("yi-9b"), get_config_t("yi-9b")
    shape_j = dataclasses.replace(SHAPES["train_4k"], global_batch=gb)
    shape_t = dataclasses.replace(SHAPES_T["train_4k"], global_batch=gb)
    for mesh in MESHES.values():
        rj = shd_j.make_rules(cfg_j, shape_j, mesh)
        rt = shd_t.make_rules(cfg_t, shape_t, mesh)
        assert rt.batch_axes == rj.batch_axes
        assert rt.shard_batch == rj.shard_batch
        assert rt.fsdp == rj.fsdp
        assert rt.axes == rj.axes
        assert rt.batch_size() == rj.batch_size()
        for spec in [("batch", "seq", "embed"), ("batch", "vocab"),
                     ("act_d",), ("batch", None, "heads", None)]:
            assert _specs_t([rt.logical(spec)]) == _specs_j(
                [rj.logical(spec)])


def test_logical_unknown_names_replicate():
    cfg = get_config_t("yi-9b")
    rules = shd_t.make_rules(cfg, SHAPES_T["train_4k"], MESHES["pod"])
    assert rules.logical(("batch", "no_such_axis", None)) == shd_t.P(
        ("data",), None, None)
    rj = shd_j.make_rules(get_config_j("yi-9b"), SHAPES["train_4k"],
                          MESHES["pod"])
    assert _specs_t([rules.logical(("batch", "no_such_axis"))]) == \
        _specs_j([rj.logical(("batch", "no_such_axis"))])


def test_use_rules_restores():
    cfg = get_config_t("stablelm-1.6b")
    outer = shd_t.make_rules(cfg, SHAPES_T["train_4k"], MESHES["pod"])
    inner = shd_t.make_rules(cfg, SHAPES_T["train_4k"],
                             MESHES["multi_pod"])
    assert shd_t.get_rules() is None
    with shd_t.use_rules(outer):
        assert shd_t.get_rules() is outer
        with shd_t.use_rules(inner):
            assert shd_t.get_rules() is inner
        assert shd_t.get_rules() is outer
    assert shd_t.get_rules() is None


def test_constrain_returns_its_argument():
    x = torch.ones(2, 3)
    assert shd_t.constrain(x, ("batch", "embed")) is x
    cfg = get_config_t("stablelm-1.6b")
    with shd_t.use_rules(shd_t.make_rules(cfg, SHAPES_T["train_4k"],
                                          MESHES["pod"])):
        y = torch.ones(2, 3, 4)
        assert shd_t.constrain(y, ("batch",)) is y          # rank mismatch
        assert shd_t.constrain(y, ("batch", None, "act_d")) is y  # plain


@pytest.mark.parametrize("shape_name", list(SHAPES))
def test_choose_n_micro_and_depth_variants_match(shape_name):
    for arch in ARCH_IDS:
        cfg_j, cfg_t = get_config_j(arch), get_config_t(arch)
        for mesh in MESHES.values():
            assert specs_t.choose_n_micro(
                cfg_t, SHAPES_T[shape_name], mesh) == specs_j.choose_n_micro(
                    cfg_j, SHAPES[shape_name], mesh)
        vj, vt = specs_j.depth_variants(cfg_j), specs_t.depth_variants(cfg_t)
        assert vt[1:][-1] == vj[-1]
        for (oj, mj), (ot, mt) in zip(vj[:2], vt[:2]):
            assert mt == mj and set(ot) == set(oj)
            for k in oj:
                a, b = oj[k], ot[k]
                if dataclasses.is_dataclass(a):
                    a, b = dataclasses.asdict(a), dataclasses.asdict(b)
                assert a == b, (arch, k)
            # the cut configs count the same parameters in both packages
            assert dataclasses.replace(cfg_t, **ot).n_params() == \
                dataclasses.replace(cfg_j, **oj).n_params()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_placements_on_a_device_mesh():
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard
    os.environ.update(MASTER_ADDR="localhost",
                      MASTER_PORT=str(_free_port()))
    dist.init_process_group("gloo", rank=0, world_size=1)
    try:
        dm = mesh_t.device_mesh(mesh_t.make_mesh_from_spec(
            (1, 1, 1), ("pod", "data", "model")), "cpu")
        P = shd_t.P
        assert shd_t.placements(P(("pod", "data"), None, "model"), dm) == (
            Shard(0), Shard(0), Shard(2))
        assert shd_t.placements(P(None, "data"), dm) == (
            Replicate(), Shard(1), Replicate())
        assert shd_t.placements(P(), dm) == (Replicate(),) * 3
        with pytest.raises(ValueError, match="order"):
            shd_t.placements(P(("data", "pod")), dm)
        with pytest.raises(ValueError, match="twice"):
            shd_t.placements(P("data", "data"), dm)
        with pytest.raises(ValueError, match="not in"):
            shd_t.placements(P("expert"), dm)
        # a stack dim's axes move to the first later dim they divide, or
        # are replicated when there is none
        assert shd_t.stack_placements(P(("data",), None, "model"),
                                      (2, 6, 8), dm, 1) == (
            Replicate(), Shard(1), Shard(2))
        assert shd_t.stack_placements(P(("data",), "model"), (4, 8), dm,
                                      1) == (Replicate(), Replicate(),
                                             Shard(1))
        with pytest.raises(ValueError, match="needs 4"):
            mesh_t.device_mesh(mesh_t.make_mesh_from_spec(
                (2, 2), ("data", "model")), "cpu")
        # a DeviceMesh makes the same rules as the abstract mesh
        cfg = get_config_t("qwen2.5-32b")
        rd = shd_t.make_rules(cfg, SHAPES_T["train_4k"], dm)
        ra = shd_t.make_rules(cfg, SHAPES_T["train_4k"],
                              mesh_t.make_mesh_from_spec(
                                  (1, 1, 1), ("pod", "data", "model")))
        assert (rd.axes, rd.batch_axes, rd.fsdp) == (
            ra.axes, ra.batch_axes, ra.fsdp)
    finally:
        dist.destroy_process_group()


def test_leaf_whole_and_its_hook():
    import torch
    import torch.distributed as dist
    os.environ.update(MASTER_ADDR="localhost",
                      MASTER_PORT=str(_free_port()))
    dist.init_process_group("gloo", rank=0, world_size=1)
    try:
        dm = mesh_t.device_mesh(mesh_t.make_mesh_from_spec(
            (1, 1), ("data", "model")), "cpu")
        g = torch.arange(12.0).reshape(3, 4)
        e = torch.ones(3, 4)
        placed = shd_t.place({"g": g, "e": e},
                             {"g": shd_t.P(None, "model"), "e": shd_t.P()},
                             dm)
        gd, ed = placed["g"], placed["e"]

        def fn(a, b):
            return a * 2, a + b

        # plain tensors: fn itself, a hook or not
        calls = []
        prev = shd_t.set_leaf_whole_hook(
            lambda *args: calls.append(args) or ["hooked"])
        try:
            outs = shd_t.leaf_whole(fn, (g, e), (g, e))
            assert torch.equal(outs[0], g * 2) and not calls
            # DTensors go to the hook with what leaf_whole was given
            assert shd_t.leaf_whole(fn, (gd, ed), (gd, None)) == ["hooked"]
            assert calls[0][0] is fn and calls[0][1] == (gd, ed)
        finally:
            assert shd_t.set_leaf_whole_hook(prev) is not None
        assert prev is None
        # no hook: every rank gathers, runs fn, lays outputs out as asked
        a, b = shd_t.leaf_whole(fn, (gd, ed), (gd, None))
        assert shd_t.is_dtensor(a) and a.placements == gd.placements
        assert torch.equal(a.full_tensor(), g * 2)
        assert not shd_t.is_dtensor(b) and torch.equal(b, g + e)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("step", ["train", "train_compressed", "prefill",
                                  "serve", "fl_round"])
def test_build_cell_abstract_inputs(step):
    mesh = MESHES["multi_pod"]
    shape = {"prefill": "prefill_32k", "serve": "decode_32k"}.get(
        step, "train_4k")
    cj = specs_j.build_cell("llama-3.2-vision-11b", shape,
                            jax.sharding.AbstractMesh(mesh.axis_sizes,
                                                      mesh.axis_names), step)
    cell = specs_t.build_cell("llama-3.2-vision-11b", shape, mesh, step,
                              device="cpu")
    assert cell.meta["step"] == step
    assert cell.meta["n_devices"] == 512
    assert all(x.device.type == "meta" for a in cell.args
               for _, x in tree_items(a))
    assert len(cell.args) == len(cj.args)
    for aj, at in zip(cj.args, cell.args):
        _shapes_agree(aj, at)
    rules = shd_t.get_rules()
    assert rules is not None and rules.batch_axes == ("pod", "data")
    assert _specs_t(cell.in_shardings[0]) == _specs_t(
        shd_t.param_specs(cell.meta["cfg"], cell.args[0]))
    for key in ("n_micro", "n_clients", "cost_multiplier"):
        assert cell.meta.get(key) == cj.meta.get(key)
