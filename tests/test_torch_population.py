"""Port parity, population scale: ``repro_torch.fed.population``,
``round_step.make_population_round_step``, ``run_fl(engine="population")``
and ``plan_cohort``'s population mode, on the CPU, against ``repro``'s
computed live in the same test.

Tolerances and why:
  * the sparse row codec, the client store (gather / scatter, spill,
    save / restore, its files on disk), the O(C) planning primitives and
    the registry draws are host numpy or exact selections: held BIT FOR
    BIT, files byte for byte;
  * the port's "population" engine against its own "pop_scan": the same
    host plan, slots, batch gathers and round body, and a lossless residual
    codec, so the trajectories are held BIT FOR BIT (accuracies, losses,
    comm times, every client's final residual row);
  * the port against the JAX package's engines, from the reference's
    initial weights: local SGD sums in another order, so whole runs are held
    as ``tests/test_torch_scan.py`` holds them — executed rounds and comm
    times equal, accuracies within 0.05 absolute; ``run_population_rounds``
    (no evaluation) has its comm time equal and its losses within 1e-3
    relative (the per-step rounding of two summation orders, compounded
    over a few rounds, stays orders of magnitude below it; a wrong cohort,
    batch or schedule moves a loss by percents).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as agg_j
from repro.core import cost_model as cost_j
from repro.core import strategies as strat_j
from repro.fed import engine as engine_j
from repro.fed import population as pop_j
from repro.fed import simulation as sim_j
from repro.ft import FailureInjector as FailureInjectorJ
from repro.ft import StragglerPolicy as StragglerPolicyJ
from repro_torch.core import aggregation as agg_t
from repro_torch.core import cost_model as cost_t
from repro_torch.fed import engine as engine_t
from repro_torch.fed import population as pop_t
from repro_torch.fed import round_step as rs_t
from repro_torch.fed import simulation as sim_t
from repro_torch.ft import FailureInjector as FailureInjectorT
from repro_torch.ft import StragglerPolicy as StragglerPolicyT

torch.set_num_threads(1)

EF_STRATEGIES = tuple(n for n in strat_j.names()
                      if strat_j.get(n).carry == "ef")
SMALL = dict(dim=32, hidden=32, n_classes=5, n_clients=12, participation=0.4,
             n_train=900, n_test=200, batch_size=32, rounds=8, eval_every=2,
             seed=3)


def _u32(a):
    return np.asarray(a).view(np.uint32)


def _accs(res):
    return [a for _, a in res.accuracies]


def _sparse_rows(rng, c, n, width):
    """Rows with at most ``width`` nonzeros, exact ties and signed zeros."""
    rows = np.zeros((c, n), np.float32)
    for i in range(c):
        nnz = int(rng.integers(0, width + 1))
        cols = rng.choice(n, size=nnz, replace=False)
        vals = rng.normal(size=nnz).astype(np.float32)
        if nnz > 2:
            vals[1] = vals[0]
        rows[i, cols] = vals
    rows[0, -1] = -0.0
    return rows


def _wire(rows, width, layout):
    if layout == "dense":
        return (rows,)
    idx, val, ov = engine_t.sparsify_rows(torch.from_numpy(rows), width)
    assert not bool(ov)
    return idx.numpy(), val.numpy()


# ------------------------------------------------------------ row codec
class TestRowCodec:
    @pytest.mark.parametrize("seed", range(6))
    def test_sparsify_densify_match_the_reference(self, seed):
        rng = np.random.default_rng(seed)
        c, n = int(rng.integers(1, 6)), int(rng.integers(4, 64))
        width = int(rng.integers(1, n + 1))
        rows = _sparse_rows(rng, c, n, width)
        it, vt, ot = engine_t.sparsify_rows(torch.from_numpy(rows), width)
        ij, vj, oj = engine_j.sparsify_rows(jnp.asarray(rows), width)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(_u32(vt.numpy()), _u32(vj))
        assert bool(ot) == bool(oj) is False
        back = engine_t.densify_rows(it, vt, n).numpy()
        np.testing.assert_array_equal(
            _u32(back), _u32(engine_j.densify_rows(ij, vj, n)))
        np.testing.assert_array_equal(back, rows)

    @pytest.mark.parametrize("seed", range(2))
    def test_overflow_flagged_as_the_reference(self, seed):
        rng = np.random.default_rng(100 + seed)
        n = int(rng.integers(8, 48))
        width = int(rng.integers(1, n - 1))
        rows = np.zeros((2, n), np.float32)
        cols = rng.choice(n, size=width + 1, replace=False)
        rows[0, cols] = rng.normal(size=width + 1).astype(np.float32)
        assert bool(engine_t.sparsify_rows(torch.from_numpy(rows),
                                           width)[2])
        assert bool(engine_j.sparsify_rows(jnp.asarray(rows), width)[2])

    @pytest.mark.parametrize("strategy", EF_STRATEGIES)
    def test_store_round_trip_per_strategy(self, strategy):
        """Whatever layout a carry="ef" strategy declares, scatter then
        gather is the identity, and the port's store holds what the
        reference's holds."""
        layout = strat_j.get(strategy).residual_layout
        rng = np.random.default_rng(3)
        n, width, p = 32, 12, 40
        ids = np.array([0, 6, 7, 13, 39])
        rows = (_sparse_rows(rng, len(ids), n, width)
                if layout == "topk_complement"
                else rng.normal(size=(len(ids), n)).astype(np.float32))
        wire = _wire(rows, width, layout)
        st = pop_t.ClientStateStore(p, n, layout=layout, width=width,
                                    chunk_clients=7)
        sj = pop_j.ClientStateStore(p, n, layout=layout, width=width,
                                    chunk_clients=7)
        st.scatter(ids, wire)
        sj.scatter(ids, wire)
        for a, b, c in zip(wire, st.gather(ids), sj.gather(ids)):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(b, c)
        dense = st.dump_dense()
        np.testing.assert_array_equal(dense, sj.dump_dense())
        np.testing.assert_array_equal(dense[ids], rows)
        assert not dense[np.setdiff1d(np.arange(p), ids)].any()
        assert st.manifest() == sj.manifest()


# --------------------------------------------------- store spill, restart
class TestStoreSpillRestart:
    def _fill(self, stores, rng, p, n):
        mirror = np.zeros((p, n), np.float32)
        for lo in range(0, p, 10):
            ids = np.arange(lo, min(lo + 10, p))
            rows = rng.normal(size=(len(ids), n)).astype(np.float32)
            for store in stores:
                store.scatter(ids, (rows,))
            mirror[ids] = rows
        return mirror

    def test_spill_window_bounded_and_lossless(self, tmp_path):
        p, n = 64, 16
        store = pop_t.ClientStateStore(
            p, n, layout="dense", chunk_clients=8, max_resident_chunks=2,
            spill_dir=str(tmp_path / "spill"))
        mirror = self._fill([store], np.random.default_rng(0), p, n)
        assert store.chunk_spills > 0
        assert store.resident_bytes() <= 2 * 8 * n * 4
        np.testing.assert_array_equal(store.dump_dense(), mirror)

    def test_spill_files_byte_identical_to_the_reference(self, tmp_path):
        """The same scatters into both packages' bounded stores spill the
        same chunks to byte-identical files."""
        p, n = 64, 16
        kw = dict(layout="dense", chunk_clients=8, max_resident_chunks=2)
        st = pop_t.ClientStateStore(p, n, spill_dir=str(tmp_path / "t"),
                                    **kw)
        sj = pop_j.ClientStateStore(p, n, spill_dir=str(tmp_path / "j"),
                                    **kw)
        self._fill([st, sj], np.random.default_rng(1), p, n)
        names = sorted(os.listdir(tmp_path / "t"))
        assert names and names == sorted(os.listdir(tmp_path / "j"))
        for name in names:
            assert (tmp_path / "t" / name).read_bytes() == \
                (tmp_path / "j" / name).read_bytes()
        assert (st.chunk_spills, st.peak_resident_bytes) == \
            (sj.chunk_spills, sj.peak_resident_bytes)

    def test_save_restore_bit_exact_then_divergeable(self, tmp_path):
        p, n, width = 50, 24, 9
        rng = np.random.default_rng(1)
        store = pop_t.ClientStateStore(p, n, layout="topk_complement",
                                       width=width, chunk_clients=6)
        ids = np.array([0, 5, 6, 17, 49])
        store.scatter(ids, _wire(_sparse_rows(rng, len(ids), n, width),
                                 width, "topk_complement"))
        manifest = store.save(str(tmp_path), 4)
        before = store.dump_dense()
        restored = pop_t.ClientStateStore.restore(
            str(tmp_path), 4, manifest, spill_dir=str(tmp_path / "spill"))
        np.testing.assert_array_equal(restored.dump_dense(), before)
        restored.scatter(np.array([5, 6]), _wire(
            _sparse_rows(rng, 2, n, width), width, "topk_complement"))
        again = pop_t.ClientStateStore.restore(
            str(tmp_path), 4, manifest, spill_dir=str(tmp_path / "spill2"))
        np.testing.assert_array_equal(again.dump_dense(), before)

    @pytest.mark.parametrize("layout", ["topk_complement", "dense"])
    def test_snapshots_byte_identical_and_cross_restorable(self, tmp_path,
                                                           layout):
        """Each package's snapshot holds the same files byte for byte, and
        each restores the other's."""
        p, n, width = 30, 20, 8
        rng = np.random.default_rng(5)
        ids = np.array([1, 2, 11, 29])
        rows = (_sparse_rows(rng, len(ids), n, width)
                if layout == "topk_complement"
                else rng.normal(size=(len(ids), n)).astype(np.float32))
        wire = _wire(rows, width, layout)
        stores = {}
        for tag, mod in (("t", pop_t), ("j", pop_j)):
            store = mod.ClientStateStore(p, n, layout=layout, width=width,
                                         chunk_clients=4)
            store.scatter(ids, wire)
            stores[tag] = (store, store.save(str(tmp_path / tag), 3))
        snap_t = pop_t.client_snapshot_dir(str(tmp_path / "t"), 3)
        snap_j = pop_j.client_snapshot_dir(str(tmp_path / "j"), 3)
        assert sorted(os.listdir(snap_t)) == sorted(os.listdir(snap_j))
        for name in os.listdir(snap_t):
            with open(os.path.join(snap_t, name), "rb") as a, \
                    open(os.path.join(snap_j, name), "rb") as b:
                assert a.read() == b.read()
        assert stores["t"][1] == stores["j"][1]
        dense = stores["t"][0].dump_dense()
        from_j = pop_t.ClientStateStore.restore(str(tmp_path / "j"), 3,
                                                stores["j"][1])
        from_t = pop_j.ClientStateStore.restore(str(tmp_path / "t"), 3,
                                                stores["t"][1])
        np.testing.assert_array_equal(from_j.dump_dense(), dense)
        np.testing.assert_array_equal(from_t.dump_dense(), dense)

    def test_restore_refuses_rechunk(self, tmp_path):
        store = pop_t.ClientStateStore(20, 8, layout="dense",
                                       chunk_clients=4)
        store.scatter(np.array([3]), (np.ones((1, 8), np.float32),))
        man = store.save(str(tmp_path), 0)
        with pytest.raises(ValueError, match="chunked"):
            pop_t.ClientStateStore.restore(str(tmp_path), 0, man,
                                           chunk_clients=8)

    def test_snapshot_pruning_follows_retention(self, tmp_path):
        store = pop_t.ClientStateStore(12, 8, layout="dense",
                                       chunk_clients=4)
        store.scatter(np.array([1]), (np.ones((1, 8), np.float32),))
        for step in (2, 4, 6):
            store.save(str(tmp_path), step)
        pop_t.prune_client_snapshots(str(tmp_path), keep_steps=[4, 6])
        kept = sorted(d for d in os.listdir(str(tmp_path))
                      if d.startswith("clients_step_"))
        assert kept == ["clients_step_4", "clients_step_6"]

    def test_restored_store_outlives_the_pruning_of_its_base(self,
                                                             tmp_path):
        """A restored store reads its chunks lazily from the snapshot it
        came from; once it has saved a newer snapshot, retention may prune
        the old one and every chunk still reads back."""
        p, n = 24, 8
        store = pop_t.ClientStateStore(p, n, layout="dense",
                                       chunk_clients=4)
        mirror = self._fill([store], np.random.default_rng(2), p, n)
        man = store.save(str(tmp_path), 1)
        restored = pop_t.ClientStateStore.restore(str(tmp_path), 1, man)
        restored.save(str(tmp_path), 2)
        pop_t.prune_client_snapshots(str(tmp_path), keep_steps=[2])
        assert not os.path.exists(pop_t.client_snapshot_dir(str(tmp_path),
                                                            1))
        np.testing.assert_array_equal(restored.dump_dense(), mirror)


# ------------------------------------------------------ O(C) host planning
class TestHostPlanning:
    def test_registry_matches_the_reference(self):
        pt, pj = pop_t.make_population(500, seed=4), \
            pop_j.make_population(500, seed=4)
        np.testing.assert_array_equal(pt.weights, pj.weights)
        np.testing.assert_array_equal(pt.skew_seeds, pj.skew_seeds)
        np.testing.assert_array_equal(pt.links.bandwidth_bps,
                                      pj.links.bandwidth_bps)
        np.testing.assert_array_equal(pt.links.latency_s, pj.links.latency_s)
        assert pt.n_clients == 500

    @pytest.mark.parametrize("p,c", [(1_000_000, 16), (8, 16), (100, 100)])
    def test_sample_cohort_matches_the_reference(self, p, c):
        got = pop_t.sample_cohort(np.random.default_rng(7), p, c)
        np.testing.assert_array_equal(
            got, pop_j.sample_cohort(np.random.default_rng(7), p, c))
        assert len(np.unique(got)) == len(got) == min(p, c)

    def test_residual_width(self):
        for n, k in ((100, 10), (100, 100), (5, 0)):
            assert pop_t.residual_width(n, k) == pop_j.residual_width(n, k)

    def test_link_columns_match_the_reference(self):
        arrays_t = cost_t.sample_link_arrays(40, np.random.default_rng(3))
        arrays_j = cost_j.sample_link_arrays(40, np.random.default_rng(3))
        ids = np.array([3, 0, 39, 7])
        for links_t, links_j in ((arrays_t, arrays_j),
                                 (list(arrays_t), list(arrays_j))):
            for a, b in zip(sim_t._link_columns(links_t, ids),
                            sim_j._link_columns(links_j, ids)):
                np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("sparse", [False, True])
    @pytest.mark.parametrize("straggle", [False, True])
    def test_plan_cohort_matches_the_reference(self, sparse, straggle):
        """``cohort=`` and ``sparse_failures=`` pick the reference's clients
        round after round, with and without stragglers; a cohort all of
        whose members die is revived in sparse mode."""
        p = 5000 if sparse else 60
        links_t = cost_t.sample_link_arrays(p, np.random.default_rng(0))
        links_j = cost_j.sample_link_arrays(p, np.random.default_rng(0))
        fracs = np.random.default_rng(1).dirichlet(np.ones(p))
        rng_t, rng_j = np.random.default_rng(8), np.random.default_rng(8)
        for rnd in range(6):
            p_fail = 1.0 if rnd == 5 else 0.3
            out = []
            for mod, agg, inj, pol, links, rng in (
                    (sim_t, agg_t, FailureInjectorT, StragglerPolicyT,
                     links_t, rng_t),
                    (sim_j, agg_j, FailureInjectorJ, StragglerPolicyJ,
                     links_j, rng_j)):
                out.append(mod.plan_cohort(
                    rnd, rng, n_clients=p, participation=0.1,
                    fracs_all=fracs, links=links, v_bytes=4e4,
                    acfg=agg.AggregationConfig(strategy="eftopk", cr=0.2),
                    failure=inj(p_fail=p_fail, seed=1),
                    straggler=(pol(over_selection=0.5) if straggle
                               else None),
                    cohort=12 if sparse else None,
                    sparse_failures=sparse))
            if out[1] is None:
                assert out[0] is None
                continue
            np.testing.assert_array_equal(out[0][0], out[1][0])
            np.testing.assert_array_equal(out[0][1], out[1][1])
            if sparse and rnd == 5:
                assert len(out[0][0]) == 1            # the revived member


# --------------------------------------------------- the population engine
def _run(engine, strategy, **kw):
    acfg = agg_t.AggregationConfig(strategy=strategy, cr=0.05)
    return sim_t.run_fl(sim_t.FLSimConfig(**SMALL), acfg, engine=engine,
                        device="cpu", **kw)


class TestPopulationEngine:
    @pytest.mark.parametrize("strategy,fail", [
        ("eftopk", False), ("eftopk", True), ("qtopk", False),
        ("bcrs_opwa", False)])
    def test_bit_equal_to_pop_scan(self, strategy, fail):
        """The store path against the dense ``[P + 1, n]`` carry, with and
        without EF, with failures (padded slots): every client's final
        residual row bit for bit."""
        kw = ({"failure": FailureInjectorT(p_fail=0.3, seed=1)} if fail
              else {})
        pop = _run("population", strategy, **kw)
        ref = _run("pop_scan", strategy, **kw)
        assert pop.executed_rounds == ref.executed_rounds
        assert _accs(pop) == _accs(ref) and pop.losses == ref.losses
        assert [(t.actual, t.max, t.min) for t in pop.times.per_round] == \
            [(t.actual, t.max, t.min) for t in ref.times.per_round]
        if ref.final_residuals is None:
            assert pop.final_residuals is None
        else:
            assert pop.final_residuals.shape[0] == SMALL["n_clients"]
            np.testing.assert_array_equal(_u32(pop.final_residuals),
                                          _u32(ref.final_residuals))
            assert ref.final_residuals.any()

    def test_refuses_overlap_collection(self):
        with pytest.raises(ValueError, match="overlap"):
            _run("population", "eftopk", collect_overlap=True)

    def test_one_round_program_a_simulation(self):
        before = rs_t.BUILD_COUNTS[("population", "qtopk")]
        _run("population", "qtopk")
        assert rs_t.BUILD_COUNTS[("population", "qtopk")] - before == 1

    def test_round_step_wire_layouts(self):
        params = sim_t.mlp_init(torch.Generator().manual_seed(0), 8, 3,
                                hidden=8, device="cpu")
        kw = dict(lr=0.1, device="cpu")
        with pytest.raises(ValueError, match="width"):
            rs_t.make_population_round_step(
                sim_t.mlp_loss, params,
                acfg=agg_t.AggregationConfig(strategy="eftopk"), **kw)
        sparse = rs_t.make_population_round_step(
            sim_t.mlp_loss, params, width=7,
            acfg=agg_t.AggregationConfig(strategy="eftopk"), **kw)
        idx, val = sparse.init_residuals(4, 131)
        assert idx.dtype == torch.int32 and val.shape == (4, 7)
        dense = rs_t.make_population_round_step(
            sim_t.mlp_loss, params,
            acfg=agg_t.AggregationConfig(strategy="qtopk"), **kw)
        assert dense.layout == "dense"
        assert dense.init_residuals(4, 131).shape == (4, 131)
        none = rs_t.make_population_round_step(
            sim_t.mlp_loss, params,
            acfg=agg_t.AggregationConfig(strategy="fedavg"), **kw)
        assert none.layout is None and none.init_residuals(4, 131).numel() \
            == 0

    def test_overflow_is_flagged_not_truncated(self):
        """A width below what the plan's k leaves: the step reports the
        overflow instead of cutting the residual."""
        params = sim_t.mlp_init(torch.Generator().manual_seed(0), 8, 3,
                                hidden=8, device="cpu")
        step = rs_t.make_population_round_step(
            sim_t.mlp_loss, params, lr=0.1, width=2, device="cpu",
            acfg=agg_t.AggregationConfig(strategy="eftopk"))
        n = sum(v.numel() for v in params.values())
        flat = engine_t.flatten_client_trees(
            {k: v.unsqueeze(0) for k, v in params.items()})[0].clone()
        rng = np.random.default_rng(0)
        x = {"step_mask": torch.ones(2, 1, dtype=torch.bool),
             "active": torch.ones(2, dtype=torch.bool),
             "weights": torch.full((2,), 0.5), "ks": torch.full((2,), 3),
             "batches": {"x": torch.from_numpy(
                 rng.normal(size=(2, 1, 4, 8)).astype(np.float32)),
                 "y": torch.from_numpy(rng.integers(0, 3, (2, 1, 4)))}}
        out = step(flat, step.init_residuals(2, n), x)
        assert bool(out["overflow"])

    def test_trajectory_against_the_reference(self):
        """From the reference's initial weights, with failures: executed
        rounds and comm times equal, accuracies within 0.05."""
        sj, st = sim_j.FLSimConfig(**SMALL), sim_t.FLSimConfig(**SMALL)
        init = {k: np.asarray(v) for k, v in sim_j.mlp_init(
            jax.random.PRNGKey(sj.seed), sj.dim, sj.n_classes,
            hidden=sj.hidden).items()}
        rj = sim_j.run_fl(sj, agg_j.AggregationConfig(strategy="eftopk"),
                          failure=FailureInjectorJ(p_fail=0.3, seed=1),
                          engine="population")
        rt = sim_t.run_fl(st, agg_t.AggregationConfig(strategy="eftopk"),
                          failure=FailureInjectorT(p_fail=0.3, seed=1),
                          engine="population", device="cpu",
                          init_params=init)
        assert rt.executed_rounds == rj.executed_rounds
        assert [r for r, _ in rt.accuracies] == [r for r, _ in rj.accuracies]
        for a_t, a_j in zip(_accs(rt), _accs(rj)):
            assert abs(a_t - a_j) <= 0.05
        assert [p.actual for p in rt.times.per_round] == \
            [p.actual for p in rj.times.per_round]
        assert rt.final_residuals.shape == rj.final_residuals.shape


# ------------------------------------------------- streaming-cohort driver
class TestRunPopulationRounds:
    CFG = dict(cohort=6, rounds=4, dim=16, hidden=16, n_classes=5, seed=5)

    def test_store_residency_flat_from_1e3_to_1e6(self, tmp_path):
        """One round program across P = 10^3 and 10^6 and the same peak
        state bytes: the store's window bounds the state, not P."""
        acfg = agg_t.AggregationConfig(strategy="eftopk", cr=0.2)
        cfg = pop_t.PopulationRunConfig(**self.CFG)
        builds = rs_t.BUILD_COUNTS[("population", "eftopk")]
        peaks, step = {}, None
        for p in (1_000, 1_000_000):
            res, step, store = pop_t.run_population_rounds(
                pop_t.make_population(p, seed=5), cfg, acfg=acfg, step=step,
                chunk_clients=1, max_resident_chunks=8,
                spill_dir=str(tmp_path / f"spill_{p}"), device="cpu")
            peaks[p] = res.peak_state_bytes
            assert store.chunk_spills > 0
            assert np.isfinite(res.losses).all()
        assert rs_t.BUILD_COUNTS[("population", "eftopk")] - builds == 1
        assert peaks[1_000] == peaks[1_000_000] > 0

    def test_against_the_reference(self):
        acfg_kw = dict(strategy="eftopk", cr=0.2)
        pop_kw = dict(n_clients=300, seed=5)
        cfg_j = pop_j.PopulationRunConfig(**self.CFG)
        init = {k: np.asarray(v) for k, v in sim_j.mlp_init(
            jax.random.PRNGKey(cfg_j.seed), cfg_j.dim, cfg_j.n_classes,
            hidden=cfg_j.hidden).items()}
        rj, _, _ = pop_j.run_population_rounds(
            pop_j.make_population(**pop_kw), cfg_j,
            acfg=agg_j.AggregationConfig(**acfg_kw), chunk_clients=8)
        rt, _, store = pop_t.run_population_rounds(
            pop_t.make_population(**pop_kw),
            pop_t.PopulationRunConfig(**self.CFG),
            acfg=agg_t.AggregationConfig(**acfg_kw), chunk_clients=8,
            device="cpu", init_params=init)
        assert rt.comm_actual_s == rj.comm_actual_s
        np.testing.assert_allclose(rt.losses, rj.losses, rtol=1e-3)
        assert store.dump_dense().any()
        assert rt.final_flat.shape == np.asarray(rj.final_flat).shape


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        pop_t.run_population_rounds(pop_t.make_population(20),
                                    pop_t.PopulationRunConfig(rounds=1))
