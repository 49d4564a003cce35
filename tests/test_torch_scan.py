"""Port parity, the whole-simulation engines: ``run_fl(engine="scan" |
"pop_scan")``, ``run_fl_traced``, ``engine.make_sim_scan`` and the device
twins of the fault-tolerance draws, on the CPU.

Tolerances and why:
  * port ``scan`` against port ``fused``: the same host plan, the same
    kernels' plain versions and the same per-client arithmetic, so the
    trajectories are held BIT FOR BIT (accuracies, comm times, executed
    rounds, EF residuals, the Fig. 4 histogram) — the reference's own
    contract between its two engines (``tests/test_sim_scan.py``);
  * port ``scan`` / ``pop_scan`` against the JAX package's, from the
    reference's initial weights: local SGD sums in another order, so whole
    runs are held as ``tests/test_torch_slice.py`` holds them — executed
    rounds and comm times equal, accuracies within 0.05 absolute;
  * ``run_fl_traced`` draws from a ``torch.Generator`` (its own stream, not
    ``jax.random``'s): held by what the reference's tests ask of it (it
    learns, survives failures and stragglers, builds once), with thresholds
    well above chance (0.2 for 5 classes);
  * the fault-tolerance twins and ``renormalize_coefficients`` are held bit
    for bit against the reference on the same inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as agg_j
from repro.fed import simulation as sim_j
from repro.ft import ElasticPool as ElasticPoolJ
from repro.ft import FailureInjector as FailureInjectorJ
from repro.ft import StragglerPolicy as StragglerPolicyJ
from repro.ft import renormalize_coefficients as renorm_j
from repro.ft.straggler import arrival_mask_traced as arrival_mask_j
from repro.ft.straggler import \
    renormalize_coefficients_traced as renorm_traced_j
from repro_torch.core import aggregation as agg_t
from repro_torch.fed import engine as engine_t
from repro_torch.fed import round_step as rs_t
from repro_torch.fed import simulation as sim_t
from repro_torch.ft import ElasticPool as ElasticPoolT
from repro_torch.ft import FailureInjector as FailureInjectorT
from repro_torch.ft import StragglerPolicy as StragglerPolicyT
from repro_torch.ft import renormalize_coefficients as renorm_t
from repro_torch.ft.failures import survivors_traced
from repro_torch.ft.straggler import _nanmedian_midpoint
from repro_torch.ft.straggler import arrival_mask_traced as arrival_mask_t
from repro_torch.ft.straggler import \
    renormalize_coefficients_traced as renorm_traced_t

torch.set_num_threads(1)

SMALL = dict(dim=32, hidden=32, n_classes=5, n_clients=6, n_train=600,
             n_test=200, batch_size=32, rounds=8, eval_every=2, seed=3)


def _accs(res):
    return [a for _, a in res.accuracies]


def _u32(a):
    return np.asarray(a).view(np.uint32)


def _run(engine, strategy, **kw):
    acfg = agg_t.AggregationConfig(strategy=strategy, cr=0.05,
                                   block_topk=kw.pop("block_topk", False))
    cfg = sim_t.FLSimConfig(**{**SMALL, **kw.pop("sim", {})})
    return sim_t.run_fl(cfg, acfg, engine=engine, device="cpu", **kw)


def _cohort_sizes(strategy, failure):
    """Each executed round's cohort size, from the host plan the scan
    engine draws (the fused loop's rng calls)."""
    cfg = sim_t.FLSimConfig(**SMALL)
    acfg = agg_t.AggregationConfig(strategy=strategy, cr=0.05)
    rng, clients, parts, fracs, _, server = sim_t._setup_sim(cfg, acfg,
                                                             "cpu")
    steps = sim_t._steps_by_client(clients, cfg)
    plans = sim_t._plan_rounds(cfg, acfg, rng, clients, parts, fracs,
                               server.links, server, steps,
                               int(steps.max()), failure, None, False)
    return [len(p[1]) for p in plans]


def _assert_same_run(scan, fused):
    assert scan.executed_rounds == fused.executed_rounds
    assert _accs(scan) == _accs(fused)
    assert [p.actual for p in scan.times.per_round] == \
        [p.actual for p in fused.times.per_round]
    assert scan.times.actual == fused.times.actual
    if fused.final_residuals is not None:
        np.testing.assert_array_equal(_u32(scan.final_residuals),
                                      _u32(fused.final_residuals))


# ------------------------------------------------------- scan == fused
class TestScanParity:
    """engine="scan" and engine="fused" consume the identical host rng
    stream, so their trajectories must match BIT FOR BIT."""

    @pytest.mark.parametrize("strategy,block", [
        ("fedavg", False), ("topk", False), ("eftopk", False),
        ("bcrs", False), ("bcrs_opwa", False), ("qtopk", False),
        ("bcrs_opwa", True)])
    def test_bitwise_accuracy_time_residuals(self, strategy, block):
        _assert_same_run(_run("scan", strategy, block_topk=block),
                         _run("fused", strategy, block_topk=block))

    @pytest.mark.parametrize("strategy", ["bcrs", "eftopk"])
    def test_failure_injection(self, strategy):
        """Dead clients become zero-weight padded slots; the EF
        reset-on-resize bookkeeping lines up with the fused server's."""
        fail = dict(failure=FailureInjectorT(p_fail=0.3, seed=1))
        sizes = _cohort_sizes(strategy, fail["failure"])
        assert len(set(sizes)) > 1 and min(sizes) < 3   # padded slots
        _assert_same_run(_run("scan", strategy, **fail),
                         _run("fused", strategy, **fail))

    def test_straggler_policy(self):
        pol = dict(straggler=StragglerPolicyT(over_selection=0.5))
        _assert_same_run(_run("scan", "bcrs_opwa", **pol),
                         _run("fused", "bcrs_opwa", **pol))

    def test_step_cap_quantile(self):
        cap = dict(sim=dict(step_cap_quantile=0.5))
        _assert_same_run(_run("scan", "bcrs_opwa", **cap),
                         _run("fused", "bcrs_opwa", **cap))

    def test_overlap_histogram(self):
        scan = _run("scan", "topk", collect_overlap=True)
        fused = _run("fused", "topk", collect_overlap=True)
        assert scan.overlap_hist.sum() > 0
        np.testing.assert_array_equal(scan.overlap_hist, fused.overlap_hist)
        _assert_same_run(scan, fused)


# ------------------------------------------------- scan vs the reference
class TestScanVsReference:
    @pytest.mark.parametrize("engine,strategy", [
        ("scan", "bcrs_opwa"), ("scan", "eftopk"), ("pop_scan", "eftopk")])
    def test_trajectory(self, engine, strategy):
        cfg = dict(SMALL)
        sj, st = sim_j.FLSimConfig(**cfg), sim_t.FLSimConfig(**cfg)
        init = {k: np.asarray(v) for k, v in sim_j.mlp_init(
            jax.random.PRNGKey(sj.seed), sj.dim, sj.n_classes,
            hidden=sj.hidden).items()}
        inj_j = FailureInjectorJ(p_fail=0.3, seed=1)
        inj_t = FailureInjectorT(p_fail=0.3, seed=1)
        rj = sim_j.run_fl(sj, agg_j.AggregationConfig(strategy=strategy),
                          failure=inj_j, engine=engine)
        rt = sim_t.run_fl(st, agg_t.AggregationConfig(strategy=strategy),
                          failure=inj_t, engine=engine, device="cpu",
                          init_params=init)
        assert rt.executed_rounds == rj.executed_rounds
        assert [r for r, _ in rt.accuracies] == [r for r, _ in rj.accuracies]
        for a_t, a_j in zip(_accs(rt), _accs(rj)):
            assert abs(a_t - a_j) <= 0.05
        assert [p.actual for p in rt.times.per_round] == \
            [p.actual for p in rj.times.per_round]
        if engine == "pop_scan":
            assert rt.final_residuals.shape == rj.final_residuals.shape \
                == (sj.n_clients, rt.final_residuals.shape[1])


# --------------------------------------------------------- the program
class TestSimScanContracts:
    def _builds(self):
        return sum(engine_t.BUILD_COUNTS.values())

    @pytest.mark.parametrize("rounds,n_clients", [(3, 8), (12, 8), (4, 12)])
    def test_one_build_per_simulation(self, rounds, n_clients):
        before = self._builds()
        _run("scan", "bcrs_opwa",
             sim=dict(rounds=rounds, n_clients=n_clients, eval_every=100))
        assert self._builds() - before == 1
        assert engine_t.CAPTURE_COUNTS[("sim_scan", "bcrs_opwa",
                                        False)] == 0   # no graph on the CPU

    def _program_inputs(self, r=6, c=2, s=1, b=4, population=None):
        params = sim_t.mlp_init(torch.Generator().manual_seed(0), 8, 3,
                                hidden=8, device="cpu")
        flat = engine_t.flatten_client_trees(
            {k: v.unsqueeze(0) for k, v in params.items()})[0].clone()
        rng = np.random.default_rng(1)
        xs = {"batches": {
                  "x": rng.normal(size=(r, c, s, b, 8)).astype(np.float32),
                  "y": rng.integers(0, 3, (r, c, s, b))},
              "step_mask": np.ones((r, c, s), bool),
              "active": np.ones((r, c), bool),
              "weights": np.full((r, c), 0.5, np.float32),
              "ks": np.full((r, c), 5, np.int32),
              "eval_write": np.array([False, False, True, False, False,
                                      True]),
              "eval_slot": np.array([0, 0, 0, 0, 0, 1], np.int32)}
        if population is not None:
            xs["active"][:, 1] = False              # slot 1 padded
            xs["cohort"] = np.stack([rng.permutation(population)[:c]
                                     for _ in range(r)]).astype(np.int32)
            xs["cohort"][:, 1] = population         # -> the sentinel row
        return params, flat, xs

    def _make(self, params, strategy, population=None):
        return engine_t.make_sim_scan(
            sim_t.mlp_loss, params, lr=0.1,
            acfg=agg_t.AggregationConfig(strategy=strategy, cr=0.5),
            make_batches=lambda p: {"x": p["batches"]["x"],
                                    "y": p["batches"]["y"]},
            population=population, device="cpu")

    def test_eval_buffer_is_o_evals_not_o_rounds(self):
        """The snapshots land in an [E, n] buffer (the reference's
        ``tests/test_sim_scan.py`` shape), never the model every round."""
        params, flat, xs = self._program_inputs()
        xs = {**xs, "batches": {k: torch.as_tensor(v)
                                for k, v in xs["batches"].items()}}
        sim = self._make(params, "topk")
        n = flat.shape[0]
        out = sim(flat, torch.zeros((0,)), torch.zeros((2, n)), xs)
        assert out["flat"] is flat                  # updated in place
        assert out["evals"].shape == (2, n)
        assert set(out["ys"]) == {"loss"} and out["ys"]["loss"].shape == (6,)
        np.testing.assert_array_equal(out["evals"][1].numpy(),
                                      out["flat"].numpy())
        assert out["evals"][0].ne(out["evals"][1]).any()

    def test_pop_scan_sentinel_row_stays_zero(self):
        p = 5
        params, flat, xs = self._program_inputs(population=p)
        xs = {**xs, "batches": {k: torch.as_tensor(v)
                                for k, v in xs["batches"].items()}}
        sim = self._make(params, "eftopk", population=p)
        n = flat.shape[0]
        res = torch.zeros((p + 1, n))
        out = sim(flat, res, torch.zeros((2, n)), xs)
        assert not out["residuals"][p].any()
        touched = np.unique(xs["cohort"][:, 0])
        assert out["residuals"][touched].ne(0).any(dim=1).all()


# --------------------------------------------------------------- traced
class TestTraced:
    def test_learns_and_builds_once(self):
        before = sum(engine_t.BUILD_COUNTS.values())
        res = sim_t.run_fl_traced(
            sim_t.FLSimConfig(**SMALL),
            agg_t.AggregationConfig(strategy="bcrs_opwa", cr=0.05),
            device="cpu")
        assert sum(engine_t.BUILD_COUNTS.values()) - before == 1
        assert len(res.executed_rounds) == SMALL["rounds"]
        assert res.final_accuracy > 0.6
        assert res.final_accuracy > res.accuracies[0][1]

    def test_survives_failures_and_stragglers(self):
        res = sim_t.run_fl_traced(
            sim_t.FLSimConfig(**SMALL),
            agg_t.AggregationConfig(strategy="eftopk", cr=0.05),
            p_fail=0.3, straggler=StragglerPolicyT(over_selection=0.5),
            device="cpu")
        assert res.final_accuracy > 0.35
        assert res.final_residuals is not None
        assert np.isfinite(res.final_residuals).all()
        assert res.executed_rounds


# --------------------------------------------------- fault-tolerance twins
class TestFtTwins:
    @pytest.mark.parametrize("seed", range(4))
    def test_survivors_traced_guarantee(self, seed):
        g = torch.Generator().manual_seed(seed)
        assert bool(survivors_traced(g, 16, 0.0).all())
        # p_fail=1 would kill everyone; exactly one client is revived
        assert int(survivors_traced(g, 16, 1.0).sum()) == 1

    @pytest.mark.parametrize("n", [4, 5, 7, 8])
    def test_nanmedian_is_jnp_nanmedian(self, n):
        rng = np.random.default_rng(n)
        for _ in range(20):
            t = rng.exponential(size=n).astype(np.float32)
            t[rng.random(n) < 0.3] = np.nan
            got = _nanmedian_midpoint(torch.from_numpy(t))
            want = jnp.nanmedian(jnp.asarray(t))
            assert _u32(got.numpy()) == _u32(want)

    @pytest.mark.parametrize("n,n_target", [(4, 3), (5, 3), (6, 4), (7, 5),
                                            (8, 5)])
    @pytest.mark.parametrize("with_policy", [False, True])
    def test_arrival_mask_traced(self, n, n_target, with_policy):
        """Even and odd cohorts (an even count of finite times averages the
        two middle ones), failed clients at +inf, deadline cuts."""
        rng = np.random.default_rng(10 * n + n_target)
        for _ in range(20):
            t = rng.exponential(size=n).astype(np.float32)
            t[rng.random(n) < 0.25] = np.inf
            t[rng.random(n) < 0.2] = 4.0 * t.min()     # a late straggler
            kw = ({"policy": StragglerPolicyJ(over_selection=0.5)}
                  if with_policy else {})
            want = np.asarray(arrival_mask_j(jnp.asarray(t), n_target, **kw))
            kw = ({"policy": StragglerPolicyT(over_selection=0.5)}
                  if with_policy else {})
            got = arrival_mask_t(torch.from_numpy(t), n_target, **kw)
            np.testing.assert_array_equal(got.numpy(), want)

    @pytest.mark.parametrize("n", [3, 4, 5, 8])
    def test_renormalize_coefficients(self, n):
        rng = np.random.default_rng(n)
        for _ in range(10):
            coeffs = rng.uniform(0.05, 1.0, n)
            arrived = rng.random(n) < 0.6
            np.testing.assert_array_equal(renorm_t(coeffs, arrived),
                                          renorm_j(coeffs, arrived))
            c32 = coeffs.astype(np.float32)
            got = renorm_traced_t(torch.from_numpy(c32),
                                  torch.from_numpy(arrived))
            want = renorm_traced_j(jnp.asarray(c32), jnp.asarray(arrived))
            np.testing.assert_array_equal(_u32(got.numpy()), _u32(want))

    def test_elastic_pool_draws(self):
        pool_j, pool_t = ElasticPoolJ(10), ElasticPoolT(10)
        rng_j, rng_t = np.random.default_rng(0), np.random.default_rng(0)
        for delta in (3, -5, -20, 7):
            pool_j.scale(delta)
            pool_t.scale(delta)
            assert pool_t.n_registered == pool_j.n_registered
            np.testing.assert_array_equal(pool_t.sample(0.4, rng_t),
                                          pool_j.sample(0.4, rng_j))


class TestFusedRoundStep:
    def test_make_round_step_returns_the_wrapper(self):
        params = sim_t.mlp_init(torch.Generator().manual_seed(0), 8, 3,
                                hidden=8, device="cpu")
        step = rs_t.make_round_step(
            sim_t.mlp_loss, params, lr=0.1,
            acfg=agg_t.AggregationConfig(strategy="eftopk"),
            with_overlap=True, device="cpu")
        assert isinstance(step, rs_t.FusedRoundStep)
        assert step.strategy == "eftopk" and step.with_overlap


def test_planned_client_steps_match_the_reference():
    cfg = {**SMALL, "step_cap_quantile": 0.5}
    np.testing.assert_array_equal(
        sim_t.planned_client_steps(sim_t.FLSimConfig(**cfg)),
        sim_j.planned_client_steps(sim_j.FLSimConfig(**cfg)))


def test_eval_plan_matches_the_reference():
    sim = sim_j.FLSimConfig(**SMALL)
    rnds = [0, 1, 2, 4, 5, 7]
    for a, b in zip(sim_t._eval_plan(sim_t.FLSimConfig(**SMALL), rnds),
                    sim_j._eval_plan(sim, rnds)):
        np.testing.assert_array_equal(a, b)
