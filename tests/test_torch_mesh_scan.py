"""Port parity, the mesh scan: ``repro_torch.fed.engine.make_mesh_sim_scan``
and ``repro_torch.launch.fl_train --engine scan`` (the reference's default
engine) on the CPU, at the ``BASE`` config of ``tests/test_mesh_scan.py``'s
fl_train tests (reduced stablelm-1.6b: 2 layers, d_model 64, vocab 256).

What is held, and how closely:
  * within the port, bit for bit: the scan against the round engine under
    faults (padded slots, masked steps, dead rounds) for bcrs_opwa, eftopk
    and fedavg, over 5 rounds in chunks of 2, 2 and 1: params, EF
    residuals and losses; the scan's trainer route (every step run, masked
    ones discarded) against the skipping route; an all-inactive round
    leaves params and residuals untouched; one program a run however many
    chunks it loads; a chunked, checkpointed scan restarts bit for bit,
    and a scan cut and resumed under ``fail_prob`` 0.3 equals the round
    engine's uninterrupted run;
  * against ``repro``'s scan computed live: executed rounds and comm
    times bit for bit, losses within ``1e-4`` relative (the tolerance of
    ``tests/test_torch_fl_train.py``; raw params of compressive runs are
    never compared across rounds: a Top-K near-tie can take another
    element when the deltas differ by ULPs).
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as get_config_j
from repro.launch import fl_train as fl_j
from repro.models.transformer import Model as ModelJ
from repro_torch.fed import engine as engine_t
from repro_torch.launch import fl_train as fl_t

torch.set_num_threads(1)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
BASE = dict(arch="stablelm-1.6b", reduced=True, clients=4, local_steps=1,
            batch=2, seq=16, cr=0.1, seed=5, verbose=False)
FAULTS = dict(fail_prob=0.25, over_selection=0.5, participation=0.75)


def _run_t(init=None, **kw):
    return fl_t.run(fl_t.FLTrainConfig(**{**BASE, "device": "cpu", **kw}),
                    init_params=init)


def _leaves(tree):
    return [t for _, t in engine_t.tree_items(tree)]


def _bits_equal(a, b):
    return all(torch.equal(x.view(torch.int32) if x.dtype == torch.float32
                           else x, y.view(torch.int32)
                           if y.dtype == torch.float32 else y)
               for x, y in zip(_leaves(a), _leaves(b)))


@pytest.mark.parametrize("strategy", ["bcrs_opwa", "eftopk", "fedavg"])
def test_scan_matches_round_engine_under_faults(strategy):
    kw = dict(rounds=5, strategy=strategy, checkpoint_every=2, **FAULTS)
    key = ("mesh_scan", strategy)
    before = engine_t.TRACE_COUNTS[key]
    scan = _run_t(engine="scan", **kw)
    assert engine_t.TRACE_COUNTS[key] - before == 1
    assert scan["chunk_rounds"] == [2, 2, 1]
    loop = _run_t(engine="round", **kw)
    assert scan["executed_rounds"] == loop["executed_rounds"]
    assert scan["losses"] == loop["losses"]
    assert _bits_equal(scan["params"], loop["params"])
    if strategy == "eftopk":
        assert _bits_equal(scan["residuals"], loop["residuals"])
        assert any(bool(r.any()) for r in _leaves(scan["residuals"]))
    n_flat = sum(t.numel() for t in _leaves(scan["params"]))
    assert (~_plan(kw, n_flat).active).any()   # padded slots in the scan


def _plan(kw, n_flat):
    from repro_torch.core import cost_model as cost_t
    from repro_torch.core.aggregation import AggregationConfig as AcfgT
    from repro_torch.ft import FailureInjector, StragglerPolicy
    cfg = fl_t.FLTrainConfig(**{**BASE, "device": "cpu", **kw})
    rng = np.random.default_rng(cfg.seed)
    links = cost_t.sample_links(cfg.clients, rng)
    return fl_t._build_plan(
        cfg, rng, np.full(cfg.clients, 1 / cfg.clients), links,
        4.0 * n_flat, AcfgT(strategy=cfg.strategy, cr=cfg.cr),
        FailureInjector(p_fail=cfg.fail_prob, seed=cfg.seed)
        if cfg.fail_prob > 0 else None,
        StragglerPolicy(over_selection=cfg.over_selection)
        if cfg.over_selection > 0 else None)


def _toy():
    """A small real-shaped problem for the program itself: the reduced
    model's params and loss, 3 rounds of plan rows, 3 slots x 2 steps with
    ragged steps and padded slots."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    model = Model(get_config("stablelm-1.6b").reduced(), device="cpu")
    params = model.init(3)
    rng = np.random.default_rng(7)
    t, c, s, b, seq = 3, 3, 2, 2, 8
    toks = rng.integers(0, model.cfg.vocab_size, (t, c, s, b, seq + 1))
    step_mask = np.zeros((t, c, s), bool)
    active = np.zeros((t, c), bool)
    weights = np.zeros((t, c), np.float32)
    for r, c_r in enumerate((3, 2, 1)):
        active[r, :c_r] = True
        step_mask[r, :c_r, :] = True
        step_mask[r, 0, 1] = False            # a ragged client
        weights[r, :c_r] = rng.dirichlet(np.ones(c_r))
    xs = {"batches": {"tokens": toks[..., :-1].astype(np.int32),
                      "labels": toks[..., 1:].astype(np.int32)},
          "step_mask": step_mask, "active": active, "weights": weights,
          "crs": rng.uniform(0.05, 0.6, (t, c)).astype(np.float32)}
    return model, params, xs


def _clone(tree):
    return engine_t.tree_from_items((p, v.clone())
                                    for p, v in engine_t.tree_items(tree))


def test_trainer_routes_agree_bit_for_bit():
    """``skip_masked=False`` (every step run, masked ones discarded, as a
    CUDA graph needs) gives the skipping route's deltas and losses, a
    client with no real step giving +0 deltas."""
    model, params, xs = _toy()
    batches = {k: torch.from_numpy(v[0]) for k, v in xs["batches"].items()}
    mask = torch.from_numpy(xs["step_mask"][0])
    mask[2] = False                                  # a client with none
    skip = engine_t.make_model_local_trainer(model.loss_fn, 0.05)
    every = engine_t.make_model_local_trainer(model.loss_fn, 0.05,
                                              skip_masked=False)
    d1, l1 = skip(params, batches, mask)
    d2, l2 = every(params, batches, mask)
    assert torch.equal(l1, l2) and float(l1[2]) == 0.0
    assert _bits_equal(d1, d2)
    for d in _leaves(d2):
        assert not torch.signbit(d[2]).any() and not d[2].any()


def test_inactive_round_leaves_the_carry_untouched():
    """A round whose cohort is all padding is a no-op on the params AND the
    residuals: the scan over rounds 0, dead, 2 ends where rounds 0, 2 do."""
    model, params, xs = _toy()
    dead = {k: (v.copy() if k in ("active", "weights") else v)
            for k, v in xs.items()}
    dead["active"][1] = False
    dead["weights"][1] = 0.0
    sim = engine_t.make_mesh_sim_scan(model.loss_fn, params, lr=0.05,
                                      strategy="eftopk")
    res0 = engine_t.init_mesh_residuals(params, 3)
    out = sim(_clone(params), _clone(res0), dead)
    two = {k: ({kk: vv[[0, 2]] for kk, vv in v.items()} if k == "batches"
               else v[[0, 2]]) for k, v in xs.items()}
    out2 = sim(_clone(params), _clone(res0), two)
    assert _bits_equal(out["params"], out2["params"])
    assert _bits_equal(out["residuals"], out2["residuals"])
    loss = out["ys"]["loss"]
    assert loss.shape == (3,) and float(loss[1]) == 0.0
    assert torch.equal(loss[[0, 2]], out2["ys"]["loss"])


def test_one_program_a_run_and_chunks_loaded_into_it():
    """One ``compile`` a run: later chunks (shorter ones too) are loaded
    into the same program and give the rounds run one chunk at a time in
    a fresh program; a chunk longer than the program's is refused."""
    model, params, xs = _toy()
    sim = engine_t.make_mesh_sim_scan(model.loss_fn, params, lr=0.05,
                                      strategy="bcrs_opwa")
    key = ("mesh_scan", "bcrs_opwa")
    before = engine_t.TRACE_COUNTS[key]
    p = _clone(params)
    res = torch.zeros((0,))

    def rows(lo, hi):
        return {k: ({kk: vv[lo:hi] for kk, vv in v.items()}
                    if k == "batches" else v[lo:hi]) for k, v in xs.items()}

    prog = sim.compile(p, res, rows(0, 2))
    l01 = prog()["ys"]["loss"].clone()
    prog.load(rows(2, 3))
    l2 = prog()["ys"]["loss"].clone()
    assert engine_t.TRACE_COUNTS[key] - before == 1
    with pytest.raises(ValueError, match="exceeds"):
        prog.load(xs)
    whole = sim(_clone(params), res, xs)
    assert _bits_equal(p, whole["params"])
    assert torch.equal(torch.cat([l01, l2]), whole["ys"]["loss"])


def test_chunked_scan_restarts_bit_for_bit(tmp_path):
    kw = dict(engine="scan", strategy="eftopk", fail_prob=0.2,
              checkpoint_every=2)
    full = _run_t(rounds=6, **kw)
    part = _run_t(rounds=3, checkpoint_dir=str(tmp_path), **kw)
    assert part["resumed_from"] is None and part["chunk_rounds"] == [2, 1]
    resumed = _run_t(rounds=6, checkpoint_dir=str(tmp_path), **kw)
    assert resumed["resumed_from"] == 3
    assert (part["executed_rounds"] + resumed["executed_rounds"]
            == full["executed_rounds"])
    assert _bits_equal(full["params"], resumed["params"])
    assert _bits_equal(full["residuals"], resumed["residuals"])
    assert part["losses"] + resumed["losses"] == full["losses"]


def test_resumed_scan_matches_the_round_engine_at_fail_0_3(tmp_path):
    """The scan cut after 3 rounds and resumed to 6 (chunks of 2) gives the
    round engine's uninterrupted 6 rounds under ``fail_prob`` 0.3: params,
    EF residuals and losses bit for bit."""
    kw = dict(strategy="eftopk", fail_prob=0.3, checkpoint_every=2)
    loop = _run_t(engine="round", rounds=6, **kw)
    part = _run_t(engine="scan", rounds=3, checkpoint_dir=str(tmp_path),
                  **kw)
    resumed = _run_t(engine="scan", rounds=6, checkpoint_dir=str(tmp_path),
                     **kw)
    assert resumed["resumed_from"] == 3
    assert resumed["chunk_rounds"] == [2, 1]
    assert (part["executed_rounds"] + resumed["executed_rounds"]
            == loop["executed_rounds"])
    assert part["losses"] + resumed["losses"] == loop["losses"]
    assert _bits_equal(resumed["params"], loop["params"])
    assert _bits_equal(resumed["residuals"], loop["residuals"])
    n_flat = sum(t.numel() for t in _leaves(loop["params"]))
    assert (~_plan(dict(rounds=6, **kw), n_flat).active).any()


def test_chunking_follows_the_reference():
    """Chunks of ``checkpoint_every``, else 4 with a directory, else the
    run up to 32 rounds; ``wall_per_round`` one entry a round."""
    assert fl_t.MAX_CHUNK_ROUNDS == fl_j.MAX_CHUNK_ROUNDS
    assert fl_t.DEFAULT_CHECKPOINT_EVERY == fl_j.DEFAULT_CHECKPOINT_EVERY
    out = _run_t(engine="scan", rounds=5, strategy="fedavg")
    assert out["chunk_rounds"] == [5]
    assert len(out["wall_per_round"]) == 5
    assert all(w > 0 for w in out["wall_per_round"])
    cfg = fl_t.FLTrainConfig(**{**BASE, "device": "cpu"})
    assert fl_t._chunk_rounds(cfg, 50) == 32
    cfg.checkpoint_dir = "somewhere"
    assert fl_t._chunk_rounds(cfg, 50) == 4


def _init():
    cfg = get_config_j(BASE["arch"]).reduced()
    return jax.tree.map(np.asarray, ModelJ(cfg).init(
        jax.random.PRNGKey(BASE["seed"])))


@pytest.mark.parametrize("strategy", ["bcrs_opwa", "eftopk", "fedavg"])
def test_scan_losses_against_the_reference_scan(strategy):
    kw = dict(rounds=4, strategy=strategy, checkpoint_every=3, **FAULTS)
    rj = fl_j.run(fl_j.FLTrainConfig(**{**BASE, "engine": "scan", **kw}))
    rt = _run_t(_init(), engine="scan", **kw)
    assert rt["executed_rounds"] == rj["executed_rounds"]
    assert rt["chunk_rounds"] == rj["chunk_rounds"]
    assert [t.actual for t in rt["times"].per_round] == \
        [t.actual for t in rj["times"].per_round]
    np.testing.assert_allclose(rt["losses"], rj["losses"], rtol=1e-4)


def test_cli_scan_engine_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.fl_train", "--reduced",
         "--device", "cpu", "--rounds", "3", "--clients", "4", "--batch",
         "2", "--seq", "16", "--fail-prob", "0.3", "--checkpoint-every",
         "2"], capture_output=True, text=True, env=env, timeout=600,
        cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "[fl] done" in proc.stdout
    assert proc.stdout.count("[fl] round ") >= 1
