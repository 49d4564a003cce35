"""Port parity, ``fl_train --engine async`` (FedBuff buffered training of
the real model through ``fed.async_engine.BufferedAsyncLoop``), on the CPU
against ``repro.launch.fl_train._run_async`` computed live, at reduced
stablelm-1.6b (2 layers, d_model 64, vocab 256).

What is held, and how closely:
  * ``core.compression.ravel_tree`` against ``jax.flatten_util.
    ravel_pytree``: the flat vector bit for bit and its dtype (bf16 for an
    all-bf16 tree, f32 for a tree mixing bf16 and f32, as the model's
    matrices and norms do), and the dtypes ``unravel`` gives back;
  * the async run's host side bit for bit: flushes, train calls, client
    updates, wave sizes and the virtual comm times, for fedavg, bcrs_opwa
    and eftopk over a sparse population store;
  * fedavg's final params (no selection, so no near-ties) within a stated
    bound, and every leaf's dtype the reference's, on the f32 reduced
    config and on a bf16 one (the reduced config with ``dtype="bfloat16"``:
    bf16 matrices, f32 norms). f32: ``F·S·(4·2^-24·max|p| + K·2^-24·
    max|p - p0|)`` per leaf (``F`` flushes, ``S`` local steps, ``K`` the
    backward's reduction lengths, ``tests/test_torch_fl_train.py``); bf16:
    ``(F·S + 1)`` bf16 ULPs of the leaf's largest magnitude (each local
    step's bf16 rounding may land one ULP apart, and the f32 server vector
    is rounded once more into the leaf's dtype). Compressive runs (bcrs_opwa,
    and eftopk over the population store) are held after their FIRST
    flush, as ``tests/test_torch_fl_train.py`` holds one round: the
    flush's ks, weights and active slots bit for bit, each member's delta
    within the delta bound, and the new vector and the members' new
    residuals within the round bound away from near-ties (a Top-K
    near-tie can take another element, and the runs then part there);
  * within the port, a crash and resume bit for bit with the sparse store.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.configs import get_config as get_config_j
from repro.fed import async_engine as async_j
from repro.launch import fl_train as fl_j
from repro.models.transformer import Model as ModelJ
from repro_torch.configs import get_config as get_config_t
from repro_torch.core.compression import ravel_tree
from repro_torch.fed import async_engine as async_t
from repro_torch.fed import engine as engine_t
from repro_torch.launch import fl_train as fl_t

torch.set_num_threads(1)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
BASE = dict(arch="stablelm-1.6b", reduced=True, clients=6, local_steps=2,
            batch=2, seq=16, lr=0.05, seed=3, verbose=False, engine="async",
            rounds=3, async_buffer_k=2, async_concurrency=3,
            async_version_ring=2)
U = 2.0 ** -24


def _tree(rng, dtypes):
    """A nested tree, one leaf per dtype given, f32 draws cast."""
    shapes = [(3, 4), (5,), (2, 2, 3)]
    return {"a": {"w": rng.normal(size=shapes[0]).astype(dtypes[0])},
            "b": rng.normal(size=shapes[1]).astype(dtypes[1]),
            "c": {"k": rng.normal(size=shapes[2]).astype(dtypes[2])}}


@pytest.mark.parametrize("kind", ["f32", "bf16", "mixed"])
def test_ravel_tree_matches_ravel_pytree(kind):
    bf = jnp.bfloat16
    dts = {"f32": [np.float32] * 3, "bf16": [bf] * 3,
           "mixed": [bf, np.float32, bf]}[kind]
    tree = _tree(np.random.default_rng(1), dts)
    flat_j, unravel_j = ravel_pytree(jax.tree.map(jnp.asarray, tree))
    tree_t = jax.tree.map(
        lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(
            torch.bfloat16 if a.dtype == bf else torch.float32), tree)
    flat_t, unravel_t = ravel_tree(tree_t)
    assert str(flat_t.dtype).split(".")[1] == str(flat_j.dtype)
    np.testing.assert_array_equal(flat_t.float().numpy(),
                                  np.asarray(flat_j, np.float32))
    for vec_j, vec_t in ((flat_j, flat_t),
                         (flat_j.astype(jnp.float32), flat_t.float())):
        try:
            back_j = unravel_j(vec_j)
        except TypeError:
            with pytest.raises(TypeError):
                unravel_t(vec_t)
            continue
        back_t = unravel_t(vec_t)
        for a, (_, b) in zip(jax.tree.leaves(back_j),
                             engine_t.tree_items(back_t)):
            assert str(b.dtype).split(".")[1] == str(a.dtype)
            np.testing.assert_array_equal(b.float().numpy(),
                                          np.asarray(a, np.float32))


class _Reduced:
    """A config whose ``reduced()`` is the given one (to run fl_train on a
    bf16 reduced model)."""

    def __init__(self, cfg):
        self.cfg = cfg

    def reduced(self):
        return self.cfg


def _configs(dtype):
    cj = get_config_j("stablelm-1.6b").reduced()
    ct = get_config_t("stablelm-1.6b").reduced()
    if dtype == "bf16":
        cj = dataclasses.replace(cj, dtype="bfloat16")
        ct = dataclasses.replace(ct, dtype="bfloat16")
    return cj, ct


def _runs(monkeypatch, dtype, **kw):
    cj, ct = _configs(dtype)
    monkeypatch.setattr(fl_j, "get_config", lambda arch: _Reduced(cj))
    monkeypatch.setattr(fl_t, "get_config", lambda arch: _Reduced(ct))
    init = jax.tree.map(np.asarray, ModelJ(cj).init(
        jax.random.PRNGKey(BASE["seed"])))
    rj = fl_j.run(fl_j.FLTrainConfig(**{**BASE, **kw}))
    rt = fl_t.run(fl_t.FLTrainConfig(**{**BASE, "device": "cpu", **kw}),
                  init_params=init)
    return init, rj, rt, cj


def _same_host_side(rj, rt):
    lj, lt = rj["async_loop"], rt["async_loop"]
    assert rt["executed_rounds"] == rj["executed_rounds"]
    assert lt.flushes == lj.flushes == BASE["rounds"]
    assert (lt.train_calls, lt.train_rows, lt.wave_sizes,
            lt.forced_retires, lt.aborted_untrained) == \
        (lj.train_calls, lj.train_rows, lj.wave_sizes, lj.forced_retires,
         lj.aborted_untrained)
    assert [t.actual for t in rt["times"].per_round] == \
        [t.actual for t in rj["times"].per_round]


def _dtype_name(t):
    return str(t.dtype).split(".")[1]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fedavg_against_the_reference(monkeypatch, dtype):
    init, rj, rt, cj = _runs(monkeypatch, dtype, strategy="fedavg")
    _same_host_side(rj, rt)
    f, s = BASE["rounds"], BASE["local_steps"]
    k = cj.n_layers * (BASE["batch"] * BASE["seq"] + cj.d_model + cj.d_ff
                       + BASE["seq"]) + cj.vocab_size
    moved = 0.0
    for a, (_, b), p0 in zip(jax.tree.leaves(rj["params"]),
                             engine_t.tree_items(rt["params"]),
                             jax.tree.leaves(init)):
        assert _dtype_name(b) == str(a.dtype)
        a = np.asarray(a, np.float64)
        p0 = np.asarray(p0, np.float64)
        diff = np.abs(b.double().numpy() - a).max()
        top = np.abs(a).max()
        if dtype == "f32":
            bound = f * s * (4 * U * top + k * U * np.abs(a - p0).max())
        else:
            bound = (f * s + 1) * 2.0 ** (np.floor(np.log2(top)) - 7)
        assert diff <= bound
        moved = max(moved, np.abs(a - p0).max())
    assert moved > 0


def _record_first_merge(monkeypatch, mod, to_np):
    """Wrap ``mod.make_async_merge_step`` so that the first flush's merge
    inputs (``updates``, ``weights``, ``ks``, ``active``, the vector
    before it as ``flat_in``) and outputs (``flat``, and the sparse
    residual pairs as ``res``) are kept as numpy copies."""
    rec = {}
    make = mod.make_async_merge_step

    def wrapped(*args, **kw):
        step = make(*args, **kw)
        fn = step._fn

        def merge(flat, residuals, x):
            first = not rec
            if first:
                rec.update({k: to_np(v) for k, v in x.items()})
                rec["flat_in"] = to_np(flat)
            out = fn(flat, residuals, x)
            if first:
                rec["flat"] = to_np(out["flat"])
                if step.layout == "topk_complement":
                    rec["res"] = [to_np(t) for t in out["residuals"]]
            return out

        step._fn = merge
        return step

    monkeypatch.setattr(mod, "make_async_merge_step", wrapped)
    return rec


def _dense(pairs, n):
    idx, val = (torch.from_numpy(np.ascontiguousarray(a)) for a in pairs)
    return engine_t.densify_rows(idx, val, n).double().numpy()


def _first_flush_within_bounds(mj, mt, init, cj, strategy):
    """The first flush, the port's against the reference's: its host side
    (ks, weights, active) and the vector before it bit for bit; each
    member's delta within the delta bound ``S·(K·2^-24·max|d| + 4·2^-24·
    (max|p| + max|d|))`` of its leaf (``tests/test_torch_fl_train.py``);
    the new vector (and, with EF, the members' new residuals) within the
    round bound of that test, away from the elements where some member's
    delta lies within twice the delta bound of its k-th magnitude."""
    for key in ("ks", "weights", "active", "flat_in"):
        np.testing.assert_array_equal(mt[key], mj[key])
    act = mj["active"]
    d_j = mj["updates"][act].astype(np.float64)
    d_t = mt["updates"][act].astype(np.float64)
    ks, w = mj["ks"][act], mj["weights"][act].astype(np.float64)
    c, n = d_j.shape
    p0 = mj["flat_in"].astype(np.float64)
    sizes = [a.size for a in jax.tree.leaves(init)]
    starts = np.cumsum([0] + sizes[:-1])
    kred = cj.n_layers * (BASE["batch"] * BASE["seq"] + cj.d_model
                          + cj.d_ff + BASE["seq"]) + cj.vocab_size
    dmax = np.maximum.reduceat(np.abs(d_j).max(0), starts)
    pmax = np.maximum.reduceat(np.abs(p0), starts)
    tol = np.repeat(BASE["local_steps"] * (kred * U * dmax
                                           + 4 * U * (pmax + dmax)), sizes)
    assert (np.abs(d_t - d_j) <= tol).all()
    mag = np.abs(d_j)
    kth = -np.sort(-mag, axis=1)[np.arange(c), ks - 1]
    keep = ~(np.abs(mag - kth[:, None]) <= 2 * tol).any(0)
    assert keep.mean() >= 0.9
    cfg = fl_t.FLTrainConfig(**BASE)
    gamma = cfg.gamma if strategy == "bcrs_opwa" else 1.0
    wx = np.abs(w[:, None] * d_j).sum(0)
    bound = (cfg.eta * gamma * (2 * c * U * wx + w.sum() * tol)
             + 2 * U * np.repeat(pmax, sizes))
    diff = np.abs(mt["flat"].astype(np.float64) - mj["flat"])
    assert (diff[keep] <= bound[keep]).all()
    assert (mj["flat"] != mj["flat_in"])[keep].any()
    if "res" in mj:
        r_j, r_t = _dense(mj["res"], n)[act], _dense(mt["res"], n)[act]
        assert (np.abs(r_t - r_j)[:, keep] <= tol[keep]).all()
        assert (r_j[:, keep] != 0).any()


@pytest.mark.parametrize("strategy,extra", [
    ("bcrs_opwa", {}), ("eftopk", dict(population=10, cohort=2))],
    ids=["bcrs_opwa", "eftopk-population"])
def test_compressive_runs_against_the_reference(monkeypatch, strategy,
                                                extra):
    cj, _ = _configs("f32")
    init = jax.tree.map(np.asarray, ModelJ(cj).init(
        jax.random.PRNGKey(BASE["seed"])))
    kw = dict(strategy=strategy, **extra)
    mj = _record_first_merge(monkeypatch, async_j, np.array)
    mt = _record_first_merge(monkeypatch, async_t,
                             lambda t: t.detach().cpu().numpy().copy())
    rj = fl_j.run(fl_j.FLTrainConfig(**{**BASE, **kw}))
    rt = fl_t.run(fl_t.FLTrainConfig(**{**BASE, "device": "cpu", **kw}),
                  init_params=init)
    _same_host_side(rj, rt)
    _first_flush_within_bounds(mj, mt, init, cj, strategy)
    for a, (_, b) in zip(jax.tree.leaves(rj["params"]),
                         engine_t.tree_items(rt["params"])):
        assert _dtype_name(b) == str(a.dtype) and tuple(b.shape) == a.shape
        assert torch.isfinite(b).all()
    if extra:
        assert rt["residuals"].manifest() == rj["residuals"].manifest()
        assert rt["residuals"].dump_dense().any()


def test_restart_bit_exact_with_the_sparse_store(tmp_path):
    kw = dict(BASE, strategy="eftopk", population=10, cohort=2,
              checkpoint_every=1, device="cpu", rounds=4)
    full = fl_t.run(fl_t.FLTrainConfig(checkpoint_dir=str(tmp_path / "a"),
                                       **kw))
    d = str(tmp_path / "b")
    part = fl_t.run(fl_t.FLTrainConfig(checkpoint_dir=d, **{**kw,
                                                             "rounds": 2}))
    assert part["async_loop"].flushes == 2
    resumed = fl_t.run(fl_t.FLTrainConfig(checkpoint_dir=d, **kw))
    assert resumed["async_loop"].flushes == 4
    for (_, a), (_, b) in zip(engine_t.tree_items(full["params"]),
                              engine_t.tree_items(resumed["params"])):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    dense = full["residuals"].dump_dense()
    assert np.array_equal(dense.view(np.uint32),
                          resumed["residuals"].dump_dense().view(np.uint32))
    assert dense.any()
    assert [t.actual for t in full["times"].per_round] == \
        [t.actual for t in resumed["times"].per_round]


def test_cli_async_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.fl_train", "--reduced",
         "--device", "cpu", "--engine", "async", "--rounds", "2",
         "--clients", "6", "--batch", "2", "--seq", "16",
         "--async-buffer-k", "2", "--async-concurrency", "3",
         "--async-version-ring", "2", "--async-p-fail", "0.2"],
        capture_output=True, text=True, env=env, timeout=600, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "[fl] done" in proc.stdout
    assert proc.stdout.count("[fl] flush ") == 2
