"""Port parity, the slice as a whole: the seeded setup, one fused round, the
flat-space aggregation for every built-in, and short ``run_fl`` trajectories
— ``repro_torch`` on the CPU against ``repro`` on the same inputs.

Tolerances and why: datasets, cohorts and batches come from the same numpy
rng draws and match exactly; local SGD runs ``torch.bmm`` against XLA's dot,
whose f32 sums differ in order, so deltas are held to rtol 1e-4 / atol 1e-6;
aggregation of identical deltas holds EF residuals bit for bit and agg to the
client-sum reordering bound 2*C*2^-24*gamma*sum_c|w_c v_c|; whole runs drift
by those roundings, so accuracies are held within 0.05 absolute.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as agg_j
from repro.fed import engine as engine_j
from repro.fed import round_step as rs_j
from repro.fed import simulation as sim_j
from repro.ft import FailureInjector as FailureInjectorJ
from repro.ft import StragglerPolicy as StragglerPolicyJ
from repro_torch import convert
from repro_torch.core import aggregation as agg_t
from repro_torch.fed import engine as engine_t
from repro_torch.fed import round_step as rs_t
from repro_torch.fed import simulation as sim_t
from repro_torch.ft import FailureInjector as FailureInjectorT
from repro_torch.ft import StragglerPolicy as StragglerPolicyT

torch.set_num_threads(1)

BUILTINS = ("fedavg", "topk", "eftopk", "bcrs", "bcrs_opwa", "qtopk",
            "bitmask_topk", "int4")
SMALL = dict(dim=32, hidden=32, n_classes=5, n_clients=6, n_train=600,
             n_test=200, batch_size=32)


def _u32(a):
    return np.asarray(a).view(np.uint32)


def _pair(**kw):
    cfg = {**SMALL, **kw}
    return sim_j.FLSimConfig(**cfg), sim_t.FLSimConfig(**cfg)


def _jax_params(sim):
    return sim_j.mlp_init(jax.random.PRNGKey(sim.seed), sim.dim,
                          sim.n_classes, hidden=sim.hidden)


def _np_tree(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


# ------------------------------------------------------------ setup
class TestSetup:
    def test_datasets_cohorts_batches_identical(self):
        """Same seed -> same data, partition, links, and the same cohorts
        and batches round after round (failures and stragglers on)."""
        sj, st = _pair()
        acfg_j = agg_j.AggregationConfig(strategy="bcrs_opwa")
        acfg_t = agg_t.AggregationConfig(strategy="bcrs_opwa")
        rng_j, cl_j, parts_j, fr_j, split_j, server_j = sim_j._setup_sim(
            sj, acfg_j)
        rng_t, cl_t, parts_t, fr_t, split_t, server_t = sim_t._setup_sim(
            st, acfg_t, "cpu", init_params=_np_tree(server_j.params))
        for a, b in zip(split_j, split_t):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(parts_j, parts_t):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(fr_j, fr_t)
        assert [(l.bandwidth_bps, l.latency_s) for l in server_j.links] == \
            [(l.bandwidth_bps, l.latency_s) for l in server_t.links]
        assert server_t.n_params == server_j.n_params
        np.testing.assert_array_equal(server_t.flat.numpy(),
                                      np.asarray(server_j._flat))
        steps = sim_t._steps_by_client(cl_t, st)
        np.testing.assert_array_equal(steps, sim_j._steps_by_client(cl_j, sj))
        fail_j, fail_t = FailureInjectorJ(0.3, seed=2), FailureInjectorT(
            0.3, seed=2)
        strag_j, strag_t = StragglerPolicyJ(), StragglerPolicyT()
        for rnd in range(4):
            pj = sim_j._plan_cohort(rnd, rng_j, sj, fr_j, server_j.links,
                                    server_j.v_bytes, acfg_j, fail_j, strag_j)
            pt = sim_t.plan_cohort(
                rnd, rng_t, n_clients=st.n_clients,
                participation=st.participation, fracs_all=fr_t,
                links=server_t.links, v_bytes=server_t.v_bytes, acfg=acfg_t,
                failure=fail_t, straggler=strag_t)
            assert (pj is None) == (pt is None)
            if pj is None:
                continue
            np.testing.assert_array_equal(pj[0], pt[0])
            np.testing.assert_array_equal(pj[1], pt[1])
            bj, mj = sim_j._stack_client_batches(cl_j, pj[0], sj, steps,
                                                 int(steps.max()), rng_j)
            bt, mt = sim_t._stack_client_batches(cl_t, pt[0], st, steps,
                                                 int(steps.max()), rng_t)
            np.testing.assert_array_equal(mj, mt)
            for k in bj:
                np.testing.assert_array_equal(bj[k], bt[k])


# ------------------------------------------------------------ one round
def _round_inputs(strategy):
    sj, st = _pair()
    acfg_j = agg_j.AggregationConfig(strategy=strategy)
    rng, clients, _, fracs, _, server = sim_j._setup_sim(sj, acfg_j)
    steps = sim_j._steps_by_client(clients, sj)
    sel, fr = sim_j._plan_cohort(0, rng, sj, fracs, server.links,
                                 server.v_bytes, acfg_j, None, None)
    batches, mask = sim_j._stack_client_batches(clients, sel, sj, steps,
                                                int(steps.max()), rng)
    links = [server.links[i] for i in sel]
    crs, weights, _ = agg_j.round_schedule(acfg_j, len(sel), fr, links,
                                           server.v_bytes)
    ks = agg_j.ks_for_schedule(server.n_params, crs, acfg_j)
    return sj, st, server, batches, mask, np.asarray(weights, np.float32), ks


class TestRound:
    def test_local_deltas_from_reference_params(self):
        sj, st, server, batches, mask, _, _ = _round_inputs("bcrs_opwa")
        params_j = server.params
        train_j = engine_j.make_masked_local_trainer(sim_j.mlp_loss, sj.lr)
        deltas_j, loss_j = jax.vmap(train_j, in_axes=(None, 0, 0))(
            params_j, {k: jnp.asarray(v) for k, v in batches.items()},
            jnp.asarray(mask))
        params_t = convert.params_to_torch(_np_tree(params_j), "cpu")
        train_t = engine_t.make_masked_local_trainer(sim_t.mlp_loss, st.lr)
        deltas_t, loss_t = train_t(
            params_t, {"x": torch.from_numpy(batches["x"]),
                       "y": torch.from_numpy(batches["y"]).long()},
            torch.from_numpy(mask))
        np.testing.assert_allclose(
            engine_t.flatten_client_trees(deltas_t).numpy(),
            np.asarray(engine_j.flatten_client_trees(deltas_j)),
            rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(loss_t.numpy(), np.asarray(loss_j),
                                   rtol=1e-4, atol=1e-6)

    @pytest.mark.parametrize("strategy", ["bcrs_opwa", "eftopk"])
    def test_round_step(self, strategy):
        """One make_round_step round from the reference's initial params:
        the updated model agrees within the local-SGD tolerance."""
        sj, st, server, batches, mask, w, ks = _round_inputs(strategy)
        acfg_j = agg_j.AggregationConfig(strategy=strategy)
        acfg_t = agg_t.AggregationConfig(strategy=strategy)
        c, n = mask.shape[0], server.n_params
        step_j = rs_j.make_round_step(sim_j.mlp_loss, server.params,
                                      lr=sj.lr, acfg=acfg_j)
        res_j = jnp.zeros((c, n)) if acfg_j.strat.needs_residuals else None
        flat0 = np.asarray(server._flat)
        out_j = step_j(jnp.asarray(flat0), res_j,
                       {k: jnp.asarray(v) for k, v in batches.items()},
                       jnp.asarray(mask), jnp.asarray(w), jnp.asarray(ks),
                       jnp.asarray(ks))
        params_t = convert.params_to_torch(_np_tree(server.params), "cpu")
        before = dict(rs_t.BUILD_COUNTS)
        step_t = rs_t.make_round_step(sim_t.mlp_loss, params_t, lr=st.lr,
                                      acfg=acfg_t, device="cpu")
        assert rs_t.BUILD_COUNTS[(strategy, False)] == \
            before.get((strategy, False), 0) + 1
        res_t = torch.zeros((c, n)) if acfg_t.strat.needs_residuals else None
        flat_t = torch.from_numpy(flat0.copy())
        out_t = step_t(flat_t, res_t,
                       {"x": torch.from_numpy(batches["x"]),
                        "y": torch.from_numpy(batches["y"]).long()},
                       torch.from_numpy(mask), torch.from_numpy(w),
                       torch.from_numpy(ks), torch.from_numpy(ks))
        assert out_t["flat"] is flat_t          # updated in place
        np.testing.assert_allclose(flat_t.numpy(), np.asarray(out_j["flat"]),
                                   rtol=1e-4, atol=1e-6)


# ------------------------------------------------------------ aggregation
@pytest.fixture(scope="module")
def reference_deltas():
    """The reference's own deltas for one bcrs cohort (what both sides
    aggregate), with EF residuals, weights and ks."""
    sj, _, server, batches, mask, w, ks = _round_inputs("bcrs_opwa")
    train_j = engine_j.make_masked_local_trainer(sim_j.mlp_loss, sj.lr)
    deltas, _ = jax.vmap(train_j, in_axes=(None, 0, 0))(
        server.params, {k: jnp.asarray(v) for k, v in batches.items()},
        jnp.asarray(mask))
    upd = np.array(engine_j.flatten_client_trees(deltas))
    rng = np.random.default_rng(0)
    res = (0.3 * upd.std() * rng.normal(size=upd.shape)).astype(np.float32)
    return upd, res, w, ks


class TestAggregateUpdates:
    @pytest.mark.parametrize("route", ["plain", "twin"])
    @pytest.mark.parametrize("strategy", BUILTINS)
    def test_vs_reference(self, reference_deltas, strategy, route):
        upd, res, w, ks = reference_deltas
        spec_j = engine_j.ClientUpdateSpec(strategy=strategy, use_kernel=False)
        # "twin": the kernel route, which on CPU tensors runs the twins
        spec_t = engine_t.ClientUpdateSpec(strategy=strategy,
                                           use_kernel=(route == "twin"))
        r = res if spec_j.needs_residuals else None
        agg_jx, nr_j = engine_j.aggregate_updates(
            spec_j, jnp.asarray(upd), jnp.asarray(w), jnp.asarray(ks),
            residuals=None if r is None else jnp.asarray(r))
        agg_tt, nr_t = engine_t.aggregate_updates(
            spec_t, torch.from_numpy(upd), torch.from_numpy(w),
            torch.from_numpy(ks),
            residuals=None if r is None else torch.from_numpy(r))
        if r is not None:
            np.testing.assert_array_equal(_u32(nr_t.numpy()),
                                          _u32(np.asarray(nr_j)))
        sent = (upd + r if r is not None else upd) - \
            (np.asarray(nr_j) if r is not None else 0.0)
        if r is None and spec_j.strat.compresses:
            sent = np.asarray(engine_j.compress_batch_fn(spec_j)(
                jnp.asarray(upd), jnp.asarray(ks)).values)
        gamma = spec_j.gamma if spec_j.strat.overlap_weighted else 1.0
        bound = 2 * len(w) * 2.0 ** -24 * gamma * np.abs(
            w[:, None].astype(np.float64) * sent).sum(0)
        diff = np.abs(agg_tt.numpy().astype(np.float64)
                      - np.asarray(agg_jx, np.float64))
        assert (diff <= bound).all(), float((diff - bound).max())


# ------------------------------------------------------------ whole runs
class TestRunFL:
    @pytest.mark.parametrize("strategy", ["bcrs_opwa", "eftopk"])
    def test_trajectory_vs_reference(self, strategy):
        sj, st = _pair(rounds=5, eval_every=2)
        init = _np_tree(_jax_params(sj))
        rj = sim_j.run_fl(sj, agg_j.AggregationConfig(strategy=strategy),
                          engine="fused")
        before = dict(rs_t.BUILD_COUNTS)
        rt = sim_t.run_fl(st, agg_t.AggregationConfig(strategy=strategy),
                          engine="fused", device="cpu", init_params=init)
        assert rs_t.BUILD_COUNTS[(strategy, False)] == \
            before.get((strategy, False), 0) + 1     # one build per run
        assert [r for r, _ in rt.accuracies] == [r for r, _ in rj.accuracies]
        for (_, a_t), (_, a_j) in zip(rt.accuracies, rj.accuracies):
            assert abs(a_t - a_j) <= 0.05
        assert rt.executed_rounds == rj.executed_rounds
        assert [p.actual for p in rt.times.per_round] == \
            [p.actual for p in rj.times.per_round]

    def test_overlap_histogram_vs_reference(self):
        """The Fig. 4 variant: the overlap round's histogram of degrees of
        overlap. Selections can flip only where a delta sits on a client's
        threshold within the local-SGD rounding, so the two histograms may
        differ by a few coordinates out of thousands."""
        sj, st = _pair(rounds=3, eval_every=2)
        init = _np_tree(_jax_params(sj))
        rj = sim_j.run_fl(sj, agg_j.AggregationConfig(strategy="bcrs_opwa"),
                          engine="fused", collect_overlap=True)
        rt = sim_t.run_fl(st, agg_t.AggregationConfig(strategy="bcrs_opwa"),
                          device="cpu", init_params=init,
                          collect_overlap=True)
        assert rt.overlap_hist.shape == rj.overlap_hist.shape
        assert np.abs(rt.overlap_hist - rj.overlap_hist).sum() <= \
            0.01 * rj.overlap_hist.sum()

    def test_seeded_init_has_the_reference_layout(self):
        sim, _ = _pair()
        p_t = sim_t.mlp_init(torch.Generator().manual_seed(0), sim.dim,
                             sim.n_classes, hidden=sim.hidden, device="cpu")
        p_j = _jax_params(sim)
        assert {k: tuple(v.shape) for k, v in p_t.items()} == \
            {k: tuple(v.shape) for k, v in p_j.items()}
        for k in ("b1", "b2", "b3"):
            assert not p_t[k].any()
        assert abs(float(p_t["w1"].std()) * np.sqrt(sim.dim) - 1.0) < 0.1

    def test_default_device_raises_without_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present: the default device works")
        with pytest.raises(RuntimeError, match="cuda"):
            sim_t.run_fl(sim_t.FLSimConfig(**SMALL, rounds=1),
                         agg_t.AggregationConfig(strategy="bcrs_opwa"))

    def test_use_kernel_true_on_cpu_raises(self):
        with pytest.raises(ValueError, match="CUDA"):
            sim_t.run_fl(sim_t.FLSimConfig(**SMALL, rounds=1),
                         agg_t.AggregationConfig(strategy="topk",
                                                 use_kernel=True),
                         device="cpu")

    @pytest.mark.parametrize("engine", ["population", "async"])
    def test_every_engine_runs_a_round_on_the_cpu(self, engine):
        """No engine of ``run_fl`` is left unported: the population and
        async engines run a round (a flush) on the CPU when asked."""
        res = sim_t.run_fl(sim_t.FLSimConfig(**SMALL, rounds=1),
                           agg_t.AggregationConfig(strategy="eftopk"),
                           engine=engine, device="cpu")
        assert res.executed_rounds == [0]
        assert len(res.times.per_round) == 1
        assert np.isfinite(res.final_residuals).all()
        assert res.final_residuals.shape[0] == SMALL["n_clients"]
