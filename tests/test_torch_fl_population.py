"""Port parity, ``fl_train --population`` (streaming cohorts over a client
store) and its per-leaf population step, on the CPU against ``repro``
computed live.

What is held, and how closely:
  * ``mesh_round.mesh_residual_width`` equal to the reference's, on the
    reduced model's params and a small tree, at several crs;
  * ``mesh_round.make_population_round_step`` against the port's own
    ``make_mesh_round_step`` on the same inputs, bit for bit: params, loss
    and the densified residual rows (mirroring
    ``tests/test_population.py::TestMeshPopulationStep``), and its width
    check;
  * ``fl_train`` in population mode against the reference's: executed
    rounds, cohorts and comm times bit for bit, losses within ``1e-4``
    relative (``tests/test_torch_fl_train.py``'s tolerance);
  * within the port, a kill-and-resume bit for bit: params, losses and
    every client's residual in the sparse store (mirroring
    ``tests/test_population.py::TestFLTrainPopulation``); the config
    validation, and every config field and default the reference's.
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

from repro.configs import get_config as get_config_j
from repro.fed import mesh_round as mesh_j
from repro.launch import fl_train as fl_j
from repro.models.transformer import Model as ModelJ
from repro_torch.core import strategies as strat_t
from repro_torch.fed import engine as engine_t
from repro_torch.fed import mesh_round as mesh_t
from repro_torch.launch import fl_train as fl_t

torch.set_num_threads(1)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
POP = dict(arch="stablelm-1.6b", reduced=True, clients=2, local_steps=1,
           batch=2, seq=16, lr=0.05, seed=0, verbose=False,
           population=24, cohort=3, fail_prob=0.25, checkpoint_every=2)


def _small_tree(rng):
    return {"w1": rng.normal(size=(6, 5)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32),
            "w2": rng.normal(size=(5, 3)).astype(np.float32)}


def _reduced_init(seed):
    cfg = get_config_j("stablelm-1.6b").reduced()
    return jax.tree.map(np.asarray, ModelJ(cfg).init(
        jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("cr_min", [0.01, 0.05, 0.25, 0.5])
def test_mesh_residual_width_equals_the_reference(cr_min):
    for tree in (_small_tree(np.random.default_rng(0)), _reduced_init(1)):
        want = mesh_j.mesh_residual_width(
            jax.tree.map(jnp.asarray, tree), cr_min)
        got = mesh_t.mesh_residual_width(
            jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree),
            cr_min)
        assert got == want


def _loss_fn(p, batch):
    x, y = batch["x"], batch["y"]
    h = torch.tanh(x @ p["w1"] + p["b"])
    logits = h @ p["w2"]
    ll = torch.log_softmax(logits, -1).gather(-1, y[:, None])[:, 0]
    return -ll.mean(), None


@pytest.mark.parametrize("strategy", ["eftopk", "qtopk", "bcrs_opwa",
                                      "fedavg"])
def test_population_step_equals_the_mesh_round_step(strategy):
    rng = np.random.default_rng(0)
    params = {k: torch.from_numpy(v)
              for k, v in _small_tree(rng).items()}
    n_total = sum(v.numel() for v in params.values())
    c, s, b = 4, 3, 8
    batches = {"x": torch.from_numpy(
        rng.normal(size=(c, s, b, 6)).astype(np.float32)),
        "y": torch.from_numpy(rng.integers(0, 3, size=(c, s, b)))}
    step_mask = torch.from_numpy(np.array(
        [[1, 1, 1], [1, 1, 0], [1, 0, 0], [0, 0, 0]], bool))
    coeffs = torch.tensor([0.4, 0.3, 0.3, 0.0])
    crs = torch.tensor([0.3, 0.5, 0.25, 0.3])
    active = torch.tensor([True, True, True, False])
    width = mesh_t.mesh_residual_width(params, 0.25)
    strat = strat_t.get(strategy)
    ef = strat.needs_residuals
    layout = strat.residual_layout if ef else None
    ref = mesh_t.make_mesh_round_step(_loss_fn, strategy=strategy,
                                      lr_local=0.05, use_kernel=False,
                                      donate=False)
    pop = mesh_t.make_population_round_step(
        _loss_fn, params, strategy=strategy, lr_local=0.05,
        use_kernel=False, width=width, donate=False)
    if ef:
        rows = np.zeros((c, n_total), np.float32)
        for i in range(c):
            at = rng.choice(n_total, width // 2, replace=False)
            rows[i, at] = rng.normal(size=width // 2)
        rows = torch.from_numpy(rows)
        res_tree = engine_t.make_unflatten(params)(rows.clone())
        if layout == "topk_complement":
            idx, val, ov = engine_t.sparsify_rows(rows, width)
            assert not bool(ov)
            wire = (idx, val)
        else:
            wire = rows.clone()
    else:
        res_tree, wire = None, torch.zeros((0,))
    p_ref, r_ref, l_ref = ref(params, res_tree, batches, step_mask, coeffs,
                              crs, active)
    p_pop, w_pop, l_pop, ov = pop(params, wire, batches, step_mask, coeffs,
                                  crs, active)
    assert not bool(ov)
    for k in params:
        assert torch.equal(p_ref[k], p_pop[k])
    assert float(l_ref) == float(l_pop)
    if ef:
        rows_ref = engine_t.flatten_client_trees(r_ref)
        rows_pop = (engine_t.densify_rows(*w_pop, n_total)
                    if layout == "topk_complement" else w_pop)
        assert torch.equal(rows_ref, rows_pop)
        assert rows_ref.any()


def test_population_step_needs_a_width_for_sparse_residuals():
    with pytest.raises(ValueError, match="width"):
        mesh_t.make_population_round_step(
            lambda p, b: (p["w"].sum(), None), {"w": torch.zeros(4)},
            strategy="eftopk", width=0)


@pytest.mark.parametrize("strategy", ["eftopk", "bcrs_opwa"])
def test_population_run_against_the_reference(strategy):
    kw = dict(POP, rounds=4, strategy=strategy)
    rj = fl_j.run(fl_j.FLTrainConfig(**kw))
    rt = fl_t.run(fl_t.FLTrainConfig(device="cpu", **kw),
                  init_params=_reduced_init(0))
    assert rt["executed_rounds"] == rj["executed_rounds"]
    assert [t.actual for t in rt["times"].per_round] == \
        [t.actual for t in rj["times"].per_round]
    np.testing.assert_allclose(rt["losses"], rj["losses"], rtol=1e-4)
    assert (rt["store"] is None) == (rj["store"] is None)
    if rj["store"] is not None:
        assert rt["store"].manifest() == rj["store"].manifest()


def test_population_restart_bit_exact_including_the_sparse_store(tmp_path):
    kw = dict(POP, strategy="eftopk", device="cpu")
    full = fl_t.run(fl_t.FLTrainConfig(rounds=4,
                                       checkpoint_dir=str(tmp_path / "a"),
                                       **kw))
    d = str(tmp_path / "b")
    fl_t.run(fl_t.FLTrainConfig(rounds=2, checkpoint_dir=d, **kw))
    resumed = fl_t.run(fl_t.FLTrainConfig(rounds=4, checkpoint_dir=d, **kw))
    assert resumed["resumed_from"] == 2
    for (_, a), (_, b) in zip(engine_t.tree_items(full["params"]),
                              engine_t.tree_items(resumed["params"])):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert full["losses"][2:] == resumed["losses"]
    dense = full["store"].dump_dense()
    assert np.array_equal(dense.view(np.uint32),
                          resumed["store"].dump_dense().view(np.uint32))
    assert dense.any()


def test_config_validation():
    with pytest.raises(ValueError, match="cohort"):
        fl_t.FLTrainConfig(population=4, cohort=8)
    cfg = fl_t.FLTrainConfig(population=100, clients=5)
    assert cfg.cohort == 5 and cfg.c_slots == 5
    assert cfg.n_registered == 100
    dense = fl_t.FLTrainConfig(clients=6, participation=0.5)
    assert dense.n_registered == 6 and dense.c_slots == 3


def test_config_fields_and_defaults_are_the_reference_s():
    """The reference's fields and defaults (the default engine "scan"
    included), plus the port's ``device``."""
    fj = {f.name: f.default for f in dataclasses.fields(fl_j.FLTrainConfig)}
    ft = {f.name: f.default for f in dataclasses.fields(fl_t.FLTrainConfig)}
    assert ft.pop("device") == "cuda"
    assert ft == fj
    assert fl_t.FLTrainConfig().engine == "scan"


def test_cli_population_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.fl_train", "--reduced",
         "--device", "cpu", "--rounds", "2", "--clients", "3", "--batch",
         "2", "--seq", "16", "--strategy", "eftopk", "--population", "50",
         "--cohort", "3", "--engine", "round"],
        capture_output=True, text=True, env=env, timeout=600, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "[fl] done" in proc.stdout
    assert "cohort 3/50" in proc.stdout
