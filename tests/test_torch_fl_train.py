"""Port parity, the real-model FL entry point ``repro_torch.launch.fl_train``
(``--engine round``) on the CPU against ``repro.launch.fl_train`` at
the ``BASE`` config of ``tests/test_mesh_scan.py``'s fl_train tests (reduced
stablelm-1.6b: 2 layers, d_model 64, vocab 256), the starting params the
reference's ``Model.init`` carried across by ``convert``.

What is held, and how closely:
  * the plan (executed rounds, cohorts, active slots, Eq. 6 weights, CRs,
    step masks) and the comm-time accounting: bit for bit (the same host
    numpy on the same rng stream);
  * fedavg over 3 rounds: every param leaf within ``R * (4 * 2^-24 *
    max|p| + K * 2^-24 * max|p - p0|)`` of the reference's — per round the
    merged update is within the gradient bound ``K * 2^-24`` (``K`` the
    sum of the backward reduction lengths, ``tests/test_torch_mesh.py``)
    of its own size, plus the rounding of the update on each side;
  * compressive strategies over 3 rounds: losses within ``1e-4``
    relative (the reduced model's loss tolerance). Raw params are never
    compared across rounds: a Top-K threshold can take another element
    when the deltas differ by ULPs (a near-tie), and the runs then part at
    that element. Params are held after ONE round, away from the elements
    where some client's delta lies within twice the delta bound of its
    k-th magnitude, by the round bound of ``tests/test_torch_mesh.py``;
  * within the port: a restart (3 rounds, then resume to 6) equal to 6
    rounds bit for bit, EF residuals included; the reference's legacy
    params-only checkpoint layout resumes; a foreign structure and a
    drifted shape are refused. The other engines are held in
    ``tests/test_torch_{mesh_scan,fl_population,fl_async}.py``.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as get_config_j
from repro.core import compression as comp_j
from repro.fed import engine as engine_j
from repro.launch import fl_train as fl_j
from repro.models.transformer import Model as ModelJ
from repro_torch import checkpoint as ckpt_t
from repro_torch.core import cost_model as cost_t
from repro_torch.core.aggregation import AggregationConfig as AcfgT
from repro_torch.fed import engine as engine_t
from repro_torch.ft import FailureInjector as FailT
from repro_torch.ft import StragglerPolicy as StragT
from repro_torch.launch import fl_train as fl_t

torch.set_num_threads(1)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
BASE = dict(arch="stablelm-1.6b", reduced=True, clients=4, local_steps=1,
            batch=2, seq=16, cr=0.1, seed=5, verbose=False)
FAULTS = dict(fail_prob=0.25, over_selection=0.5, participation=0.75)
U = 2.0 ** -24


def _init():
    cfg = get_config_j(BASE["arch"]).reduced()
    return jax.tree.map(np.asarray, ModelJ(cfg).init(
        jax.random.PRNGKey(BASE["seed"])))


def _k():
    cfg = get_config_j(BASE["arch"]).reduced()
    b, s = BASE["batch"], BASE["seq"]
    return cfg.n_layers * (b * s + cfg.d_model + cfg.d_ff + s) \
        + cfg.vocab_size


def _run_j(**kw):
    return fl_j.run(fl_j.FLTrainConfig(**{**BASE, "engine": "round", **kw}))


def _run_t(init=None, **kw):
    return fl_t.run(fl_t.FLTrainConfig(**{**BASE, "engine": "round",
                                          "device": "cpu", **kw}),
                    init_params=init)


def _leaves_t(tree):
    return [t.numpy() for _, t in engine_t.tree_items(tree)]


def _leaves_j(tree):
    return [np.asarray(a) for a in jax.tree.leaves(tree)]


def _plan(mod, cfg, acfg, fail, strag, links_fn):
    rng = np.random.default_rng(cfg.seed)
    links = links_fn(cfg.clients, rng)
    v_bytes = 4.0 * 1000
    fracs = np.full(cfg.clients, 1.0 / cfg.clients)
    return mod._build_plan(cfg, rng, fracs, links, v_bytes, acfg, fail,
                           strag)


@pytest.mark.parametrize("strategy", ["bcrs_opwa", "eftopk", "fedavg"])
def test_plan_bit_equal(strategy):
    from repro.core.aggregation import AggregationConfig as AcfgJ
    from repro.core import cost_model as cost_j
    from repro.ft import FailureInjector as FailJ
    from repro.ft import StragglerPolicy as StragJ
    kw = dict(BASE, rounds=8, strategy=strategy, **FAULTS)
    cj, ct = fl_j.FLTrainConfig(**kw), fl_t.FLTrainConfig(**kw)
    pj = _plan(fl_j, cj, AcfgJ(strategy=strategy, cr=cj.cr),
               FailJ(p_fail=cj.fail_prob, seed=cj.seed),
               StragJ(over_selection=cj.over_selection),
               cost_j.sample_links)
    pt = _plan(fl_t, ct, AcfgT(strategy=strategy, cr=ct.cr),
               FailT(p_fail=ct.fail_prob, seed=ct.seed),
               StragT(over_selection=ct.over_selection),
               cost_t.sample_links)
    assert pt.rounds == pj.rounds and len(pt.rounds) >= 4
    for field in ("selected", "active", "weights", "crs", "step_mask"):
        a, b = getattr(pt, field), getattr(pj, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert (~pj.active).any()             # padded slots are exercised


def test_fedavg_whole_run():
    init = _init()
    rj = _run_j(rounds=3, strategy="fedavg", **FAULTS)
    rt = _run_t(init, rounds=3, strategy="fedavg", **FAULTS)
    assert rt["executed_rounds"] == rj["executed_rounds"]
    assert [t.actual for t in rt["times"].per_round] == \
        [t.actual for t in rj["times"].per_round]
    np.testing.assert_allclose(rt["losses"], rj["losses"], rtol=1e-4)
    r = len(rj["executed_rounds"])
    for a, b, p0 in zip(_leaves_t(rt["params"]), _leaves_j(rj["params"]),
                        _leaves_j(init)):
        bound = r * (4 * U * np.abs(b).max()
                     + _k() * U * np.abs(b - p0).max())
        assert np.abs(a.astype(np.float64) - b).max() <= bound


@pytest.mark.parametrize("strategy", ["bcrs_opwa", "eftopk", "topk"])
def test_compressive_run_losses(strategy):
    init = _init()
    rj = _run_j(rounds=3, strategy=strategy, **FAULTS)
    rt = _run_t(init, rounds=3, strategy=strategy, **FAULTS)
    assert rt["executed_rounds"] == rj["executed_rounds"]
    assert [t.actual for t in rt["times"].per_round] == \
        [t.actual for t in rj["times"].per_round]
    np.testing.assert_allclose(rt["losses"], rj["losses"], rtol=1e-4)
    assert all(np.isfinite(rt["losses"]))


@pytest.mark.parametrize("strategy", ["bcrs_opwa", "eftopk"])
def test_one_round_params_away_from_near_ties(strategy):
    """One round (no faults: every slot real): the reference's own deltas
    give each leaf's k-th magnitude per client; the new params (and EF
    residuals) are held where no client lies within twice the delta bound
    of it."""
    init = _init()
    kw = dict(rounds=1, strategy=strategy)
    rj = _run_j(**kw)
    rt = _run_t(init, **kw)
    cfg = fl_j.FLTrainConfig(**{**BASE, "engine": "round", **kw})
    model = ModelJ(get_config_j(cfg.arch).reduced())
    rng = np.random.default_rng(cfg.seed)
    from repro.core import cost_model as cost_j
    from repro.core.aggregation import AggregationConfig as AcfgJ
    links = cost_j.sample_links(cfg.clients, rng)
    n_flat = sum(a.size for a in _leaves_j(init))
    plan = fl_j._build_plan(cfg, rng, np.full(cfg.clients, 0.25), links,
                            4.0 * n_flat, AcfgJ(strategy=strategy,
                                                cr=cfg.cr), None, None)
    batches = fl_j._round_batches(cfg, model.cfg.vocab_size, 0,
                                  cfg.c_slots)
    local = engine_j.make_masked_local_trainer(model.loss_fn, cfg.lr)
    pj = jax.tree.map(jnp.asarray, init)
    dj, _ = jax.vmap(local, in_axes=(None, 0, 0))(
        pj, jax.tree.map(jnp.asarray, batches),
        jnp.asarray(plan.step_mask[0]))
    w = np.asarray(plan.weights[0], np.float64)
    gamma = cfg.gamma if strategy == "bcrs_opwa" else 1.0
    c = len(w)
    ef = strategy == "eftopk"
    none = [None] * len(_leaves_j(init))
    res_t = _leaves_t(rt["residuals"]) if ef else none
    res_j = _leaves_j(rj["residuals"]) if ef else none
    checked = 0
    for a, b, p0, d, r_t, r_j in zip(_leaves_t(rt["params"]),
                                     _leaves_j(rj["params"]),
                                     _leaves_j(init), _leaves_j(dj),
                                     res_t, res_j):
        d = d.astype(np.float64)
        tol = cfg.local_steps * (_k() * U * np.abs(d).max()
                                 + 4 * U * (np.abs(p0).max()
                                            + np.abs(d).max()))
        ks = np.asarray(comp_j.k_for_ratio_traced(p0.size,
                                                  jnp.asarray(plan.crs[0])))
        mag = np.abs(d.reshape(c, -1))
        kth = -np.sort(-mag, axis=1)[np.arange(c), ks - 1]
        keep = ~(np.abs(mag - kth[:, None]) <= 2 * tol).any(0)
        keep = keep.reshape(p0.shape)
        wx = np.abs(w.reshape((-1,) + (1,) * p0.ndim) * d).sum(0)
        bound = (cfg.eta * gamma * (2 * c * U * wx + w.sum() * tol)
                 + 2 * U * np.abs(p0).max())
        diff = np.abs(a.astype(np.float64) - b)
        assert (diff[keep] <= bound[keep]).all()
        if ef:
            assert (np.abs(r_t - r_j)[:, keep] <= tol).all()
        if (kth > 2 * tol).all():
            # not vacuous: a leaf whose k-th magnitudes are clear of zero
            # (the embedding's rows of absent tokens are exact zeros, tied
            # at a zero k-th) loses few elements to near-ties
            assert keep.mean() >= 0.9
            checked += 1
    assert checked >= 10
    assert abs(rt["losses"][0] - rj["losses"][0]) <= 1e-4 * rj["losses"][0]


# ------------------------------------------------- within the port: restart
def test_restart_bit_exact_with_residuals(tmp_path):
    kw = dict(strategy="eftopk", fail_prob=0.2, checkpoint_every=2)
    full = _run_t(rounds=6, **kw)
    part = _run_t(rounds=3, checkpoint_dir=str(tmp_path), **kw)
    assert part["resumed_from"] is None
    resumed = _run_t(rounds=6, checkpoint_dir=str(tmp_path), **kw)
    assert resumed["resumed_from"] == 3
    assert (part["executed_rounds"] + resumed["executed_rounds"]
            == full["executed_rounds"])
    for a, b in zip(_leaves_t(full["params"]), _leaves_t(resumed["params"])):
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))
    for a, b in zip(_leaves_t(full["residuals"]),
                    _leaves_t(resumed["residuals"])):
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))
    assert part["losses"] + resumed["losses"] == full["losses"]


def test_resumes_legacy_params_only_checkpoint(tmp_path):
    ref = _run_t(rounds=2, strategy="bcrs_opwa")
    ckpt_t.save(str(tmp_path), 2, ref["params"])   # legacy layout
    resumed = _run_t(rounds=2, strategy="bcrs_opwa",
                     checkpoint_dir=str(tmp_path))
    assert resumed["resumed_from"] == 2
    assert resumed["executed_rounds"] == []
    for a, b in zip(_leaves_t(ref["params"]), _leaves_t(resumed["params"])):
        np.testing.assert_array_equal(a, b)


def test_restore_refuses_a_foreign_structure_and_a_shape_drift(tmp_path):
    foreign, drift = str(tmp_path / "foreign"), str(tmp_path / "drift")
    ckpt_t.save(foreign, 2, {"foo": np.zeros((3,), np.float32)})
    with pytest.raises(ckpt_t.LayoutMismatch, match="no leaves"):
        ckpt_t.restore(foreign, {"bar": np.zeros((3,), np.float32)},
                       strict=False)
    # an EF checkpoint saved for 4 cohort slots, resumed with 3: the
    # residuals' shapes drift, and the run refuses it before any round
    _run_t(rounds=1, strategy="eftopk", checkpoint_dir=drift)
    with pytest.raises(ValueError, match="shape"):
        _run_t(rounds=2, strategy="eftopk", checkpoint_dir=drift,
               clients=3)


def test_cli_round_engine_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.fl_train", "--engine",
         "round", "--reduced", "--device", "cpu", "--rounds", "2",
         "--clients", "4", "--batch", "2", "--seq", "16", "--fail-prob",
         "0.3"], capture_output=True, text=True, env=env, timeout=600,
        cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "[fl] done" in proc.stdout
    assert proc.stdout.count("[fl] round ") >= 1
