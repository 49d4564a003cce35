"""Port parity, the legacy engine and the block Top-K route as a whole:
``fed/client.make_local_trainer``, ``FLServer.round`` and
``run_fl(engine="legacy" | "fused", block_topk=True)`` — ``repro_torch`` on
the CPU against ``repro`` on the same inputs.

Tolerances and why: cohorts and batches come from the same numpy rng draws
and are held equal; local SGD runs PyTorch's matmuls against XLA's dot,
whose f32 sums differ in order, so deltas and losses are held to rtol 1e-4
/ atol 1e-6; EF residuals of identical deltas are bit for bit, and the model
after each server round is held to the sum of the rounds' client-sum
reordering bounds (2*C*2^-24*gamma*sum_c|w_c v_c|) plus one f32 rounding of
the update per round; whole runs drift by those roundings, so accuracies are
held within 0.05 absolute over 5 rounds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as agg_j
from repro.core import cost_model as cm_j
from repro.data.pipeline import ClientDataset as ClientDatasetJ
from repro.fed import client as client_j
from repro.fed import server as server_j
from repro.fed import simulation as sim_j
from repro_torch import convert
from repro_torch.core import aggregation as agg_t
from repro_torch.core import cost_model as cm_t
from repro_torch.data.pipeline import ClientDataset as ClientDatasetT
from repro_torch.fed import client as client_t
from repro_torch.fed import server as server_t
from repro_torch.fed import simulation as sim_t

torch.set_num_threads(1)

SMALL = dict(dim=32, hidden=32, n_classes=5, n_clients=6, n_train=600,
             n_test=200, batch_size=32)


def _u32(a):
    return np.asarray(a).view(np.uint32)


def _np_tree(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _jax_params(sim):
    return sim_j.mlp_init(jax.random.PRNGKey(sim.seed), sim.dim,
                          sim.n_classes, hidden=sim.hidden)


# ------------------------------------------------------------ local SGD
class TestLocalTrainer:
    def test_vs_reference(self):
        sim = sim_j.FLSimConfig(**SMALL)
        params = _jax_params(sim)
        rng = np.random.default_rng(0)
        xs = rng.normal(size=(4, sim.batch_size, sim.dim)).astype(np.float32)
        ys = rng.integers(0, sim.n_classes, size=(4, sim.batch_size))
        delta_j, loss_j = jax.jit(client_j.make_local_trainer(
            sim_j.mlp_loss, sim.lr))(params, {"x": jnp.asarray(xs),
                                              "y": jnp.asarray(ys)})
        delta_t, loss_t = client_t.make_local_trainer(sim_t.mlp_loss,
                                                      sim.lr)(
            convert.params_to_torch(_np_tree(params), "cpu"),
            {"x": torch.from_numpy(xs), "y": torch.from_numpy(ys)})
        assert set(delta_t) == set(delta_j)
        for k in delta_j:
            np.testing.assert_allclose(delta_t[k].numpy(),
                                       np.asarray(delta_j[k]),
                                       rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-4,
                                   atol=1e-6)


# ------------------------------------------------------------ server round
def _deltas(params, c, seed):
    """``c`` client delta dicts shaped like ``params``, from numpy."""
    rng = np.random.default_rng(seed)
    return [{k: (0.01 * rng.normal(size=np.shape(v))).astype(np.float32)
             for k, v in params.items()} for _ in range(c)]


class TestServerRound:
    @pytest.mark.parametrize("block_topk", [False, True])
    @pytest.mark.parametrize("strategy", ["bcrs_opwa", "eftopk"])
    def test_three_rounds_vs_reference(self, strategy, block_topk):
        sim = sim_j.FLSimConfig(**SMALL)
        params = _np_tree(_jax_params(sim))
        kw = dict(strategy=strategy, block_topk=block_topk, block_size=512)
        acfg_j = agg_j.AggregationConfig(**kw)
        links = cm_j.sample_links(sim.n_clients, np.random.default_rng(1))
        srv_j = server_j.FLServer(params={k: jnp.asarray(v)
                                          for k, v in params.items()},
                                  acfg=acfg_j, links=links)
        srv_t = server_t.FLServer(
            params=convert.params_to_torch(params, "cpu"),
            acfg=agg_t.AggregationConfig(**kw),
            links=cm_t.sample_links(sim.n_clients, np.random.default_rng(1)))
        selected = np.array([0, 2, 3, 5])
        fr = np.array([0.1, 0.2, 0.3, 0.4])
        bound = np.zeros(srv_t.n_params)
        for rnd in range(3):
            deltas = _deltas(params, len(selected), rnd)
            res_before = (np.zeros((len(selected), srv_t.n_params),
                                   np.float32) if srv_j._residuals is None
                          else np.asarray(srv_j._residuals))
            info_j = srv_j.round([{k: jnp.asarray(v) for k, v in d.items()}
                                  for d in deltas], fr, selected)
            info_t = srv_t.round([{k: torch.from_numpy(v)
                                   for k, v in d.items()} for d in deltas],
                                 fr, selected)
            np.testing.assert_array_equal(info_t["crs"], info_j["crs"])
            assert info_t["round_time"].actual == info_j["round_time"].actual
            if acfg_j.strat.needs_residuals:
                np.testing.assert_array_equal(
                    _u32(srv_t.residuals.numpy()),
                    _u32(np.asarray(srv_j._residuals)))
            # what was merged, |sent| <= |corrected|, bounds this round's
            # client-sum reordering; one more rounding of w - agg per round
            flat = np.stack([np.concatenate([d[k].ravel()
                                             for k in sorted(d)])
                             for d in deltas])
            if acfg_j.strat.needs_residuals:
                flat = flat + res_before
            _, w, _ = agg_j.round_schedule(acfg_j, len(selected), fr,
                                           [links[i] for i in selected],
                                           srv_j.v_bytes)
            gamma = acfg_j.gamma if acfg_j.strat.overlap_weighted else 1.0
            bound += 2 * len(w) * 2.0 ** -24 * gamma * np.abs(
                np.asarray(w, np.float64)[:, None] * flat).sum(0)
            flat_j = np.asarray(srv_j._flat, np.float64)
            bound += 2.0 ** -24 * np.abs(flat_j)
            diff = np.abs(srv_t.flat.numpy().astype(np.float64) - flat_j)
            assert (diff <= bound).all(), float((diff - bound).max())

    def test_residuals_reset_on_cohort_change(self):
        sim = sim_j.FLSimConfig(**SMALL)
        params = _np_tree(_jax_params(sim))
        srv = server_t.FLServer(
            params=convert.params_to_torch(params, "cpu"),
            acfg=agg_t.AggregationConfig(strategy="eftopk"))
        srv.round([{k: torch.from_numpy(v) for k, v in d.items()}
                   for d in _deltas(params, 3, 0)], np.full(3, 1 / 3),
                  np.arange(3))
        assert srv.residuals.shape[0] == 3
        srv.round([{k: torch.from_numpy(v) for k, v in d.items()}
                   for d in _deltas(params, 2, 1)], np.full(2, 0.5),
                  np.arange(2))
        assert srv.residuals.shape[0] == 2


# ------------------------------------------------------------ whole runs
def _record_draws(monkeypatch):
    """Record every cohort and every batch-index draw on both sides."""
    draws = {"j": [], "t": []}
    for side, cls in (("j", ClientDatasetJ), ("t", ClientDatasetT)):
        orig = cls.fixed_batch_indices

        def wrapped(self, bs, n_batches, rng, _orig=orig, _side=side):
            sel = _orig(self, bs, n_batches, rng)
            draws[_side].append(("batch", len(self), sel.tolist()))
            return sel

        monkeypatch.setattr(cls, "fixed_batch_indices", wrapped)
    orig_j, orig_t = sim_j._plan_cohort, sim_t.plan_cohort

    def plan_j(*a, **kw):
        plan = orig_j(*a, **kw)
        draws["j"].append(("cohort", None if plan is None
                           else plan[0].tolist()))
        return plan

    def plan_t(*a, **kw):
        plan = orig_t(*a, **kw)
        draws["t"].append(("cohort", None if plan is None
                           else plan[0].tolist()))
        return plan

    monkeypatch.setattr(sim_j, "_plan_cohort", plan_j)
    monkeypatch.setattr(sim_t, "plan_cohort", plan_t)
    return draws


class TestRunFL:
    @pytest.mark.parametrize("engine", ["legacy", "fused"])
    @pytest.mark.parametrize("strategy", ["bcrs_opwa", "eftopk", "qtopk"])
    def test_block_topk_trajectory_vs_reference(self, monkeypatch, engine,
                                                strategy):
        draws = _record_draws(monkeypatch)
        cfg = dict(SMALL, rounds=5, eval_every=2)
        sj, st = sim_j.FLSimConfig(**cfg), sim_t.FLSimConfig(**cfg)
        kw = dict(strategy=strategy, block_topk=True, block_size=512)
        rj = sim_j.run_fl(sj, agg_j.AggregationConfig(**kw), engine=engine)
        rt = sim_t.run_fl(st, agg_t.AggregationConfig(**kw), engine=engine,
                          device="cpu", init_params=_np_tree(_jax_params(sj)))
        assert draws["t"] == draws["j"] and len(draws["j"]) > 5
        assert rt.executed_rounds == rj.executed_rounds
        assert [r for r, _ in rt.accuracies] == [r for r, _ in rj.accuracies]
        for (_, a_t), (_, a_j) in zip(rt.accuracies, rj.accuracies):
            assert abs(a_t - a_j) <= 0.05
        assert [p.actual for p in rt.times.per_round] == \
            [p.actual for p in rj.times.per_round]
        assert len(rt.losses) == len(rt.executed_rounds)
        assert all(np.isfinite(rt.losses))

    def test_legacy_global_topk_vs_reference(self):
        cfg = dict(SMALL, rounds=3, eval_every=1)
        sj, st = sim_j.FLSimConfig(**cfg), sim_t.FLSimConfig(**cfg)
        rj = sim_j.run_fl(sj, agg_j.AggregationConfig(strategy="bcrs"),
                          engine="legacy")
        rt = sim_t.run_fl(st, agg_t.AggregationConfig(strategy="bcrs"),
                          engine="legacy", device="cpu",
                          init_params=_np_tree(_jax_params(sj)))
        for (_, a_t), (_, a_j) in zip(rt.accuracies, rj.accuracies):
            assert abs(a_t - a_j) <= 0.05

    def test_legacy_overlap_histogram_vs_reference(self):
        """The legacy Fig. 4 round (exact global Top-K masks of the raw
        deltas). Selections can flip only where a delta sits on a client's
        threshold within the local-SGD rounding."""
        cfg = dict(SMALL, rounds=3, eval_every=2)
        sj, st = sim_j.FLSimConfig(**cfg), sim_t.FLSimConfig(**cfg)
        kw = dict(strategy="bcrs_opwa", block_topk=True, block_size=512)
        rj = sim_j.run_fl(sj, agg_j.AggregationConfig(**kw),
                          engine="legacy", collect_overlap=True)
        rt = sim_t.run_fl(st, agg_t.AggregationConfig(**kw), engine="legacy",
                          device="cpu", collect_overlap=True,
                          init_params=_np_tree(_jax_params(sj)))
        assert rt.overlap_hist.shape == rj.overlap_hist.shape
        assert np.abs(rt.overlap_hist - rj.overlap_hist).sum() <= \
            0.01 * rj.overlap_hist.sum()

    def test_legacy_default_device_raises_without_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present: the default device works")
        with pytest.raises(RuntimeError, match="cuda"):
            sim_t.run_fl(sim_t.FLSimConfig(**SMALL, rounds=1),
                         agg_t.AggregationConfig(strategy="bcrs_opwa",
                                                 block_topk=True),
                         engine="legacy")

    def test_legacy_use_kernel_true_on_cpu_raises(self):
        with pytest.raises(ValueError, match="CUDA"):
            sim_t.run_fl(sim_t.FLSimConfig(**SMALL, rounds=1),
                         agg_t.AggregationConfig(strategy="bcrs_opwa",
                                                 block_topk=True,
                                                 use_kernel=True),
                         engine="legacy", device="cpu")

    def test_cpu_default_helpers_raise_without_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present: the default device works")
        with pytest.raises(RuntimeError, match="cuda"):
            convert.params_to_torch({"w": np.ones(3)})
        with pytest.raises(RuntimeError, match="cuda"):
            sim_t.mlp_init(torch.Generator().manual_seed(0), 4, 2, hidden=4)
