"""The multi-card layout run on four ranks, against the reference on four
devices and against the port's single process.

One test drives two child processes, each writing ``.npz`` files to
``tmp_path``:
  * the reference, with ``XLA_FLAGS=--xla_force_host_platform_device_count
    =4`` (as ``repro.launch.dryrun`` sets it): its ``Model.init`` params,
    the dense sgd step jitted under the sharding rules of a (data 2,
    model 2) CPU mesh, and ``apply_moe`` under the rules of a (data 4,
    model 1) mesh, which routes in 4 shards, with each shard's routing;
  * the port on 4 ``gloo`` CPU ranks (``torch.multiprocessing``), DTensor's
    collectives routed through c10d's (``chip_smoke.sync_functional_
    collectives``, as its ranks that share a card run them): a (2, 2)
    ``DeviceMesh``, the reference's params carried across
    (``convert.model_params_to_torch``) and laid out by
    ``launch.specs.place_args``, the ``train`` cell of
    ``launch.specs.build_cell``, then the ``train_compressed`` cell (2 pods,
    wire_cr 0.05) with each pod's gradient gathered whole beside it.

The model is qwen2.5-32b's ``reduced()`` config widened so that its leaves
pass ``param_specs``'s ``2**16`` and its query groups are qwen's 5 heads
to a kv head: d 512, 10 / 2 heads of 32, d_ff 1024, vocab 1024, f32, ``fsdp_threshold=0`` in both packages (FSDP on: the
stacks' layer dim is sharded over ``data`` in the specs), B = 8, S = 16.

What is held, and how closely (U = 2^-24):
  * the dense step: the loss within ``1e-5`` relative, and every new
    param within ``lr * 6U * sqrt(K) * max|g| + 2U * max|p|`` (``K`` the
    sum of the backward's reduction lengths, its roundings counted as a
    root-sum-square walk as ``chip_smoke.layout_f32_bound`` counts them),
    the port's four ranks against the reference's four devices and
    against the port's single process (the same step, summed in another
    order across ranks); the single process's step with one gradient
    rounded to bf16, or with a quarter of it zeroed, fails it;
  * ``launch.specs.init_params`` (the seeded draw cut to each rank's
    share a layer at a time): the single process's ``Model.init``, bit
    for bit;
  * the compressed step: every new param and EF residual bit for bit
    against ``compress_merge_leaf`` and the sgd update run in this
    process on the gathered pod gradients (the layout changes where the
    merge's inputs come from, not the merge);
  * ``apply_moe`` at ``n_shards`` 4 (deepseek ``reduced()``, 256 tokens,
    capacity 64 a shard, dropping at a capacity factor of 0.5): the
    inputs route clear of near-ties (``tests/test_torch_moe.py``'s
    margin), then every shard's expert indices, positions and ``keep`` bit
    for bit, and the output within ``K * U * max|y|``; the port's routes
    under rules on an abstract (4, 1) mesh, so its tensors are plain.
"""
import dataclasses
import json
import math
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[1]
U = 2.0 ** -24
LR = 0.05
B, S = 8, 16
WIRE_CR = 0.05
OVR = dict(d_model=512, n_heads=10, n_kv_heads=2, head_dim=32, d_ff=1024,
           vocab_size=1024, fsdp_threshold=0)
MOE_T, MOE_CF = 256, 0.5


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _nest(flat):
    out = {}
    for key, v in flat.items():
        node = out
        parts = key.split("/")
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = v
    return out


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [p for k in tree for p in _paths(tree[k], prefix + (k,))]
    return [prefix]


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _batch_np():
    toks = np.random.default_rng(0).integers(0, OVR["vocab_size"],
                                             (B, S + 1))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def _moe_x(d):
    return np.random.default_rng(5).normal(
        size=(4, MOE_T // 4, d)).astype(np.float32)


# ----------------------------------------------------------- the reference
def _reference(out: pathlib.Path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as PJ

    from repro.configs import get_config
    from repro.configs.base import ShapeConfig
    from repro.dist import grad_sync, sharding as shd
    from repro.launch.mesh import make_mesh_from_spec
    from repro.models import Model
    from repro.models import moe
    from repro.optim import make_optimizer

    assert jax.device_count() == 4
    cfg = dataclasses.replace(get_config("qwen2.5-32b").reduced(), **OVR)
    model = Model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    np.savez(out / "params.npz", **{k: np.asarray(v) for k, v in
                                    _flat(jax.tree.map(np.asarray,
                                                       params)).items()})
    mesh = make_mesh_from_spec((2, 2), ("data", "model"))
    shd.set_rules(shd.make_rules(cfg, ShapeConfig("t", S, B, "train"), mesh))
    named = lambda t: jax.tree.map(lambda sp: NamedSharding(mesh, sp), t,
                                   is_leaf=lambda x: isinstance(x, PJ))
    pshard = named(shd.param_specs(cfg, params))
    batch = {k: jnp.asarray(v) for k, v in _batch_np().items()}
    bshard = named(shd.batch_specs(cfg, batch))
    fn = grad_sync.make_train_step(model, make_optimizer("sgd", LR),
                                   grad_shardings=pshard)
    new_p, _, m = jax.jit(fn, in_shardings=(pshard, (), bshard))(
        params, (), batch)
    np.savez(out / "ref_dense.npz", loss=np.asarray(m["loss"]),
             **{k: np.asarray(v) for k, v in _flat(new_p).items()})

    dcfg = get_config("deepseek-v3-671b").reduced()
    mo = dataclasses.replace(dcfg.moe, capacity_factor=MOE_CF)
    p = moe.init_moe(jax.random.PRNGKey(3), d_model=dcfg.d_model, mo=mo,
                     dtype=jnp.float32)
    x = jnp.asarray(_moe_x(dcfg.d_model))
    mesh4 = make_mesh_from_spec((4, 1), ("data", "model"))
    shd.set_rules(shd.make_rules(dcfg, ShapeConfig("t", MOE_T // 4, 4,
                                                   "train"), mesh4))
    y, aux = jax.jit(lambda p, x: moe.apply_moe(p, x, mo=mo, act="swiglu"))(
        p, x)
    cap = max(int(mo.capacity_factor * (MOE_T // 4) * mo.top_k
                  / mo.n_experts), mo.top_k)
    _, _, ei, pi, _ = jax.vmap(lambda xs: moe._local_moe(
        p, xs, mo, "swiglu", cap))(x.reshape(4, MOE_T // 4, -1))
    keep = jax.vmap(lambda e: moe._dispatch_positions(
        e, mo.n_experts, cap)[1])(ei)
    np.savez(out / "ref_moe.npz", y=np.asarray(y), aux=np.asarray(aux),
             ei=np.asarray(ei), pi=np.asarray(pi), keep=np.asarray(keep),
             cap=cap, **{"p/" + k: np.asarray(v)
                         for k, v in _flat(jax.tree.map(np.asarray,
                                                        p)).items()})


# ------------------------------------------------------------------ the port
def _port_rank(rank, world, port, out):
    import torch
    import torch.distributed as dist

    from repro_torch import convert
    from repro_torch.dist import grad_sync, sharding as shd
    from repro_torch.launch import mesh as mesh_t, specs
    from repro_torch.optim import make_optimizer

    sys.path.insert(0, str(REPO))
    from chip_smoke import sync_functional_collectives

    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port))
    dist.init_process_group("gloo", rank=rank, world_size=world)
    # DTensor's collectives through c10d's, as ranks sharing a card run
    sync_functional_collectives("cpu")
    dm = mesh_t.device_mesh(mesh_t.make_mesh_from_spec(
        (2, 2), ("data", "model")), "cpu")
    params = convert.model_params_to_torch(
        _nest(dict(np.load(out / "params.npz"))), device="cpu")
    # the cell's config is the reduced, widened one, field for field
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("qwen2.5-32b").reduced(), **OVR)
    ovr = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    batch = {k: torch.from_numpy(v) for k, v in _batch_np().items()}
    cell = specs.build_cell("qwen2.5-32b", "train_4k", dm, "train", lr=LR,
                            overrides=ovr, n_micro=1, device="cpu")
    pp, _, bb = specs.place_args(cell, (params, (), batch), dm)
    new_p, _, m = cell.fn(pp, (), bb)
    dense = {k: shd.full(v).numpy() for k, v in _flat(new_p).items()}
    dense["loss"] = shd.full(m["loss"]).numpy()
    dense["placements"] = np.array(json.dumps(
        {k: repr(v.placements) for k, v in _flat(pp).items()}))

    cell = specs.build_cell("qwen2.5-32b", "train_4k", dm,
                            "train_compressed", lr=LR, overrides=ovr,
                            compressed_cr=WIRE_CR, device="cpu")
    opt = make_optimizer("sgd", LR)
    state = grad_sync.init_compressed_state(opt, pp, n_pods=2)
    crs = torch.tensor([WIRE_CR, WIRE_CR / 2], dtype=torch.float32)
    coeffs = torch.tensor([0.5, 0.5], dtype=torch.float32)
    from repro_torch.models import Model
    pods, _, _ = grad_sync.pod_gradients(
        Model(cell.meta["cfg"], device="cpu").loss_fn, pp, bb, 2)
    gathered = {k: shd.full(g).numpy() for k, g in zip(_flat(params), pods)}
    del pods
    new_p2, st2, m2 = cell.fn(pp, state, bb, crs, coeffs)
    comp = {"p/" + k: shd.full(v).numpy() for k, v in _flat(new_p2).items()}
    comp.update({"ef/" + k: shd.full(v).numpy()
                 for k, v in _flat(st2["ef"]).items()})
    comp.update({"g/" + k: v for k, v in gathered.items()})
    comp["loss"] = shd.full(m2["loss"]).numpy()
    # the params drawn straight into their layout, a layer at a time, are
    # the single process's draw
    placed = specs.init_params(cell, 7, dm)
    whole = Model(cfg, device="cpu").init(7)
    dense["placed_init_same_bits"] = np.array(all(
        torch.equal(shd.full(_get(placed, k)), _get(whole, k))
        for k in _paths(whole)))
    if rank == 0:
        np.savez(out / "port_dense.npz", **dense)
        np.savez(out / "port_comp.npz", **comp)
    dist.barrier()
    dist.destroy_process_group()


def _port(out: pathlib.Path):
    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_port_rank, args=(4, port, out), nprocs=4)


# ------------------------------------------------------------------ the test
def _run(role, out, extra_env):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu", **extra_env)
    proc = subprocess.run([sys.executable, __file__, role, str(out)],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]


def _k(cfg, b):
    return cfg.n_layers * (b * S + cfg.d_model + cfg.d_ff + S) \
        + cfg.vocab_size


def test_layout_on_four_ranks(tmp_path):
    import torch

    from repro_torch import convert
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.core import compression as comp
    from repro_torch.dist import grad_sync, sharding as shd
    from repro_torch.fed.engine import compress_merge_leaf
    from repro_torch.launch import mesh as mesh_t
    from repro_torch.models import Model, moe
    from repro_torch.optim import make_optimizer

    torch.set_num_threads(1)
    _run("reference", tmp_path, {
        "XLA_FLAGS": "--xla_force_host_platform_device_count=4"})
    _run("port", tmp_path, {})
    params_np = _nest(dict(np.load(tmp_path / "params.npz")))
    ref = dict(np.load(tmp_path / "ref_dense.npz"))
    got = dict(np.load(tmp_path / "port_dense.npz"))

    # the single process: the same step on the same params, no rules
    cfg = dataclasses.replace(get_config("qwen2.5-32b").reduced(), **OVR)
    model = Model(cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch_np().items()}
    params = convert.model_params_to_torch(params_np, device="cpu")
    one_p, _, one_m = grad_sync.make_train_step(
        model, make_optimizer("sgd", LR))(params, (), batch)
    one = {k: v.numpy() for k, v in _flat(one_p).items()}
    _, _, grads = grad_sync.loss_and_grads(model.loss_fn, params, batch)
    grads = dict(zip(_flat(params), grads))
    gmax = {k: float(g.abs().max()) for k, g in grads.items()}

    # the layout sharded what the specs shard: the stacks' data axis moved
    assert bool(got["placed_init_same_bits"])
    plc = json.loads(str(got["placements"]))
    assert plc["layers/mlp/w_up"] == "(Shard(dim=1), Shard(dim=2))"
    assert plc["embed/w"] == "(Shard(dim=1), Shard(dim=0))"
    k = _k(cfg, B)
    for want, name in ((ref["loss"], "ref"), (float(one_m["loss"]), "one")):
        assert abs(float(got["loss"]) - float(want)) <= 1e-5 * abs(
            float(want)), name
    tol = 6 * U * math.sqrt(k)
    for key, p0 in _flat(params_np).items():
        bound = LR * tol * gmax[key] + 2 * U * np.abs(p0).max()
        for want, name in ((ref[key], "ref"), (one[key], "one")):
            diff = np.abs(got[key].astype(np.float64) - want).max()
            assert diff <= bound, (key, name, diff, bound)
    # the bound sees a gradient rounded to bf16 and a lost shard of one
    key = "layers/mlp/w_up"
    g = grads[key]
    p0 = _flat(params_np)[key]
    bound = LR * tol * gmax[key] + 2 * U * np.abs(p0).max()
    zeroed = g.clone()
    zeroed.reshape(-1)[:g.numel() // 4] = 0
    for bad in (g.to(torch.bfloat16).float(), zeroed):
        faulty = (torch.from_numpy(p0) - torch.full((), LR) * bad).numpy()
        assert np.abs(got[key].astype(np.float64) - faulty).max() > bound

    # the compressed step: the merge of the gathered pod gradients
    c = dict(np.load(tmp_path / "port_comp.npz"))
    crs = torch.tensor([WIRE_CR, WIRE_CR / 2])
    coeffs = torch.tensor([0.5, 0.5])
    for key, p0 in _flat(params_np).items():
        g = torch.from_numpy(c["g/" + key])
        n = p0.size
        gf = g.reshape(2, n).to(torch.float32)
        if n < 4096:
            agg = torch.tensordot(coeffs, gf, dims=([0], [0]))
            np.testing.assert_array_equal(c["ef/" + key], 0.0)
        else:
            ks = comp.k_for_ratio_traced(n, torch.clamp(crs, 0.0, WIRE_CR))
            agg, new_e = compress_merge_leaf(
                gf, coeffs, ks, gamma=2.0, overlap_d=1, opwa=True,
                use_kernel="auto", residuals=torch.zeros(2, n))
            np.testing.assert_array_equal(
                c["ef/" + key], new_e.reshape((2,) + p0.shape).numpy())
        p = torch.from_numpy(p0)
        upd = p - torch.full((), LR, dtype=p.dtype) * agg.reshape(
            p0.shape).to(p.dtype)
        np.testing.assert_array_equal(c["p/" + key], upd.numpy())
    assert np.isfinite(c["loss"])

    # apply_moe in 4 shards: the reference under a (4, 1) mesh, the port
    # under rules on an abstract (4, 1) mesh
    r = dict(np.load(tmp_path / "ref_moe.npz"))
    dcfg = get_config("deepseek-v3-671b").reduced()
    mo = dataclasses.replace(dcfg.moe, capacity_factor=MOE_CF)
    p_np = _nest({k[2:]: v for k, v in r.items() if k.startswith("p/")})
    pt = convert.model_params_to_torch(p_np, device="cpu")
    x = _moe_x(dcfg.d_model)
    xt = torch.from_numpy(x)
    d = dcfg.d_model
    xs = x.reshape(-1, d).astype(np.float64)
    w = p_np["router"].astype(np.float64)
    top = -np.sort(-(xs @ w), axis=1)
    margin = top[:, mo.top_k - 1] - top[:, mo.top_k]
    rbound = d * U * (np.abs(xs)[:, :, None] * np.abs(w)[None]).sum(1).max(1)
    assert (margin / rbound).min() > 1, "inputs route clear of near-ties"
    rules = shd.make_rules(dcfg, dataclasses.replace(
        SHAPES["train_4k"], global_batch=4), mesh_t.make_mesh_from_spec(
            (4, 1), ("data", "model")))
    with shd.use_rules(rules):
        assert moe.n_shards(mo, MOE_T) == 4
        y, aux = moe.apply_moe(pt, xt, mo=mo, act="swiglu")
    cap = moe.capacity(mo, MOE_T // 4)
    assert cap == int(r["cap"])
    keeps = []
    for i in range(4):
        _, _, ei, pi, keep, _ = moe._local_moe(
            pt, xt.reshape(4, MOE_T // 4, d)[i], mo, cap)
        np.testing.assert_array_equal(ei.numpy(), r["ei"][i])
        np.testing.assert_array_equal(pi.numpy(), r["pi"][i])
        np.testing.assert_array_equal(keep.numpy(), r["keep"][i])
        keeps.append(keep)
    assert not torch.stack(keeps).all(), "a capacity factor of 0.5 drops"
    kk = d + mo.n_experts + 2 * mo.top_k + 2 * (d + mo.d_expert)
    ymax = np.abs(r["y"]).max()
    assert np.abs(y.numpy() - r["y"]).max() <= kk * U * ymax
    assert abs(float(aux) - float(r["aux"])) <= (kk + MOE_T) * U * abs(
        float(r["aux"]))
    # one shard routes otherwise: its capacity and drops differ
    y1, _ = moe.apply_moe(pt, xt, mo=mo, act="swiglu")
    assert not torch.equal(y1, y)


if __name__ == "__main__":
    role, out = sys.argv[1], pathlib.Path(sys.argv[2])
    sys.path.insert(0, str(REPO / "src"))
    {"reference": _reference, "port": _port}[role](out)
