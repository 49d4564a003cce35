"""Port parity, the async engine: ``repro_torch.ft.arrivals``,
``repro_torch.fed.async_engine`` and ``run_fl(engine="async")``, on the
CPU, against ``repro``'s computed live in the same test.

Tolerances and why:
  * the arrival process, the failure draws, the flush weights, the wave
    buckets, the ring floor and the config validation are host numpy and
    Python: held EXACTLY (event streams, float64 timelines, error
    messages);
  * the port's async engine against the port's own engines: the sync
    anchor runs the scan engines' plans through the same trainer and merge
    at their slot shapes, waves run members whose arithmetic does not
    depend on the wave (on the CPU), and restarts restore every piece of
    state — all held BIT FOR BIT (params, residuals, virtual times,
    accuracies, dispatch counters);
  * the port against the JAX package's engine, from the reference's
    initial weights: the event stream (which clients, when, dispatch
    counters, flush sizes, virtual times) does not depend on the model and
    is held exactly; accuracies drift with local SGD's summation order and
    are held within 0.05 absolute, as ``tests/test_torch_scan.py`` holds
    whole runs.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import aggregation as agg_j
from repro.core import cost_model as cost_j
from repro.fed import async_engine as ae_j
from repro.fed import simulation as sim_j
from repro.ft.arrivals import ArrivalProcess as ArrivalProcessJ
from repro.ft.arrivals import failure_fracs as failure_fracs_j
from repro_torch.core import aggregation as agg_t
from repro_torch.core import cost_model as cost_t
from repro_torch.core.bcrs import ClientLink
from repro_torch.core.compression import k_for_ratio
from repro_torch.fed import async_engine as ae_t
from repro_torch.fed import population as pop_t
from repro_torch.fed import simulation as sim_t
from repro_torch.ft import arrivals as arr_t_fn
from repro_torch.ft import straggler as straggler_t
from repro_torch.ft.arrivals import (BATCH_TAG, FAILURE_TAG,
                                     ArrivalProcess)
from repro_torch.ft.arrivals import failure_fracs as failure_fracs_t

torch.set_num_threads(1)

FAST = dict(rounds=6, n_train=1600, n_test=500, eval_every=2, seed=3,
            dim=32, hidden=32, n_classes=5)
ASYNC = dict(async_buffer_k=4, async_p_fail_upload=0.3,
             async_upload_timeout_s=60.0)


def _accs(res):
    return [a for _, a in res.accuracies]


def _times(res):
    return [(t.actual, t.max, t.min) for t in res.times.per_round]


def _run(strategy, cr=0.05, **kw):
    ckpt = {k: kw.pop(k) for k in ("checkpoint_dir", "checkpoint_every",
                                   "stop_after") if k in kw}
    return sim_t.run_fl(sim_t.FLSimConfig(**{**FAST, **kw}),
                        agg_t.AggregationConfig(strategy=strategy, cr=cr),
                        engine="async", device="cpu", **ckpt)


def _same(a, b, residuals=True):
    assert a.executed_rounds == b.executed_rounds
    assert _accs(a) == _accs(b)
    assert _times(a) == _times(b)
    if residuals and b.final_residuals is not None:
        np.testing.assert_array_equal(a.final_residuals.view(np.uint32),
                                      b.final_residuals.view(np.uint32))


# ------------------------------------------------------- arrival process
def _links(rng, n):
    return [ClientLink(bandwidth_bps=float(rng.uniform(2e6, 3e7)),
                       latency_s=float(rng.uniform(0.001, 0.04)))
            for _ in range(n)]


class TestArrivals:
    def test_tags_and_exports_match_the_reference(self):
        from repro.ft import arrivals as ref_mod_attr
        from repro.ft.arrivals import BATCH_TAG as bt_j
        from repro.ft.arrivals import FAILURE_TAG as ft_j
        assert (BATCH_TAG, FAILURE_TAG) == (bt_j, ft_j)
        # the package attribute is the straggler function, as in repro.ft
        assert arr_t_fn is straggler_t.arrivals
        assert callable(ref_mod_attr)

    @pytest.mark.parametrize("p_fail,attempts", [(0.0, 3), (0.6, 4),
                                                 (1.0, 2)])
    def test_failure_fracs_match_the_reference(self, p_fail, attempts):
        for uid in range(60):
            assert failure_fracs_t(9, uid, p_fail, attempts) == \
                failure_fracs_j(9, uid, p_fail, attempts)

    @pytest.mark.parametrize("p_fail,timeout", [(0.4, float("inf")),
                                                (0.6, 0.05)])
    def test_event_stream_matches_the_reference(self, p_fail, timeout):
        """The same dispatches give the same events, popped in the same
        order, with the same float64 timelines."""
        rng = np.random.default_rng(0)
        links = _links(rng, 8)
        pt = ArrivalProcess(seed=5, p_fail=p_fail, retry=cost_t.RetryPolicy(
            max_attempts=3, timeout_s=timeout))
        pj = ArrivalProcessJ(seed=5, p_fail=p_fail,
                             retry=cost_j.RetryPolicy(max_attempts=3,
                                                      timeout_s=timeout))
        for i in range(24):
            c = int(rng.integers(8))
            et = pt.dispatch(c, i // 4, 0.1 * i, links[c], 4e5, 0.05)
            ej = pj.dispatch(c, i // 4, 0.1 * i, links[c], 4e5, 0.05)
            assert et.__dict__ == ej.__dict__
            if i % 3 == 2:
                assert pt.pop().__dict__ == pj.pop().__dict__
        assert [e.__dict__ for e in pt.in_flight()] == \
            [e.__dict__ for e in pj.in_flight()]
        st, sj = pt.state(), pj.state()
        assert sorted(st) == sorted(sj)
        for key in st:
            np.testing.assert_array_equal(st[key], sj[key])
        assert pt.busy_clients() == pj.busy_clients()

    def test_state_round_trip_reproduces_the_future(self):
        rng = np.random.default_rng(2)
        proc = ArrivalProcess(seed=7, p_fail=0.5)
        for i, link in enumerate(_links(rng, 6)):
            proc.dispatch(i, 0, 0.0, link, 4e5, 0.05)
        proc.pop(), proc.pop()
        clone = ArrivalProcess(seed=7, p_fail=0.5)
        clone.load_state(proc.state())
        assert clone.counter == proc.counter
        link = _links(np.random.default_rng(3), 1)[0]
        proc.dispatch(7, 1, 1.0, link, 4e5, 0.05)
        clone.dispatch(7, 1, 1.0, link, 4e5, 0.05)
        while len(proc):
            assert proc.pop() == clone.pop()
        assert not len(clone)


# ------------------------------------------------------- weights, buckets
class TestHostRules:
    @pytest.mark.parametrize("seed", range(4))
    def test_flush_weights_match_the_reference(self, seed):
        rng = np.random.default_rng(seed)
        p, k = 12, 5
        table = rng.uniform(0.05, 1.0, p)
        fracs = rng.dirichlet(np.ones(p))
        for m in range(1, k + 1):
            ids = rng.choice(p, m, replace=False)
            stal = rng.integers(0, 4, m).astype(float)
            pend = rng.choice(p, k - m, replace=False)
            pstal = rng.integers(0, 4, k - m).astype(float)
            for kw in ({"coeff_table": table}, {"fracs_all": fracs}):
                got = ae_t.flush_weights(ids, stal, pend, pstal, buffer_k=k,
                                         alpha=0.5, **kw)
                want = ae_j.flush_weights(ids, stal, pend, pstal,
                                          buffer_k=k, alpha=0.5, **kw)
                np.testing.assert_array_equal(got, want)

    def test_wave_bucket_and_ring_floor_match_the_reference(self):
        for w in range(1, 70):
            assert ae_t.wave_bucket(w) == ae_j.wave_bucket(w)
        for m in range(1, 20):
            for k in range(1, 12):
                assert ae_t.min_version_ring(m, k) == \
                    ae_j.min_version_ring(m, k)

    @pytest.mark.parametrize("bad", [
        dict(async_buffer_k=11),
        dict(async_buffer_k=4, async_concurrency=6, async_version_ring=1),
        dict(async_store_resident=2)])
    def test_config_errors_match_the_reference(self, bad):
        cfg = {**FAST, **bad}
        with pytest.raises(ValueError) as et:
            ae_t.validate_async_config(sim_t.FLSimConfig(**cfg))
        with pytest.raises(ValueError) as ej:
            ae_j.validate_async_config(sim_j.FLSimConfig(**cfg))
        assert str(et.value) == str(ej.value)

    def test_run_fl_refuses_what_the_reference_refuses(self):
        with pytest.raises(ValueError, match="exceeds"):
            _run("fedavg", async_buffer_k=11)
        with pytest.raises(ValueError, match="overlap"):
            sim_t.run_fl(sim_t.FLSimConfig(**FAST),
                         agg_t.AggregationConfig(strategy="fedavg"),
                         engine="async", collect_overlap=True, device="cpu")
        with pytest.raises(ValueError, match="async"):
            sim_t.run_fl(sim_t.FLSimConfig(**FAST),
                         agg_t.AggregationConfig(strategy="fedavg"),
                         engine="scan", checkpoint_dir="unused",
                         device="cpu")

    def test_config_fields_match_the_reference(self):
        """The sixteen async knobs (and every other field) with the
        reference's names, defaults and order."""
        import dataclasses
        ft = [(f.name, f.default) for f in
              dataclasses.fields(sim_t.FLSimConfig)]
        fj = [(f.name, f.default) for f in
              dataclasses.fields(sim_j.FLSimConfig)]
        assert ft == fj
        assert sum(name.startswith("async_") for name, _ in ft) == 16


# ---------------------------------------------------------- sync anchor
class TestSyncAnchor:
    @pytest.mark.parametrize("strategy,ref", [("bcrs_opwa", "scan"),
                                              ("eftopk", "pop_scan"),
                                              ("qtopk", "pop_scan")])
    def test_bit_equal_to_the_scan_engines(self, strategy, ref):
        acfg = agg_t.AggregationConfig(strategy=strategy, cr=0.05)
        anchor = _run(strategy, async_sync_arrivals=True)
        scan = sim_t.run_fl(sim_t.FLSimConfig(**FAST), acfg, engine=ref,
                            device="cpu")
        _same(anchor, scan)
        assert anchor.final_residuals is None or \
            anchor.final_residuals.any()


# ------------------------------------------------------ batched dispatch
class TestBatchedDispatch:
    @pytest.mark.parametrize("strategy", ["bcrs_opwa", "eftopk", "qtopk"])
    def test_bit_equal_to_sequential(self, strategy):
        """Waves are pure scheduling: params, residuals, accuracies and
        flush times equal the per-upload baseline bit for bit, in fewer
        train calls; one merge and one train program a run."""
        before = dict(ae_t.BUILD_COUNTS)
        b = _run(strategy, **ASYNC)
        built = {k: v - before.get(k, 0)
                 for k, v in ae_t.BUILD_COUNTS.items()
                 if v != before.get(k, 0)}
        assert built == {("async_merge", strategy): 1,
                         ("async_train", strategy): 1}
        s = _run(strategy, **ASYNC, async_batch_dispatch=False)
        _same(b, s)
        assert torch.equal(b.async_loop.flat.view(torch.int32),
                           s.async_loop.flat.view(torch.int32))
        lb, ls = b.async_loop, s.async_loop
        assert lb.train_calls < ls.train_calls == ls.train_rows
        assert ls.wave_buckets_used == {1}
        assert lb.wave_width == ls.wave_width == ae_t.wave_bucket(
            max(lb.k, lb.m_conc))
        assert all(w == ae_t.wave_bucket(w) for w in lb.wave_buckets_used)

    def test_static_wave_width_changes_no_bit(self):
        """A member's delta in a wave padded to the static width equals, bit
        for bit, its delta in a wave of the reference's power-of-two bucket
        (the CPU's arithmetic does not depend on the batch count)."""
        params = sim_t.mlp_init(torch.Generator().manual_seed(11), 16, 5,
                                hidden=16, device="cpu")
        n = sum(v.numel() for v in params.values())
        rng = np.random.default_rng(5)
        wide, steps, bs = 32, 2, 4
        x = {"x": torch.from_numpy(rng.normal(size=(wide, steps, bs, 16))
                                   .astype(np.float32)),
             "y": torch.from_numpy(rng.integers(0, 5, (wide, steps, bs))),
             "step_mask": torch.from_numpy(rng.random((wide, steps)) < 0.8),
             "ver_idx": torch.from_numpy(rng.integers(0, 3, wide))}
        ring = torch.from_numpy((0.05 * rng.normal(size=(3, n)))
                                .astype(np.float32))
        train = ae_t.make_wave_train_step(
            sim_t.mlp_loss, params, lr=0.1,
            make_batches=lambda b: {"x": b["x"], "y": b["y"]})

        def wave(w, width):
            return train(ring, {k: torch.cat([v[:w], torch.zeros(
                (width - w,) + v.shape[1:], dtype=v.dtype)])
                for k, v in x.items()})[:w]

        for w in (1, 3, 5, 8, 13):
            np.testing.assert_array_equal(
                wave(w, wide).numpy().view(np.uint32),
                wave(w, ae_t.wave_bucket(w)).numpy().view(np.uint32))

    def test_every_wave_trains_at_the_static_width(self):
        """Stall-forced partial flushes give waves of several sizes; each
        trains at ``wave_bucket(max(K, M))`` rows, and the telemetry keeps
        the reference's buckets."""
        widths = []
        loop = _drive_loop(64, 8, 16, 4, sparse=False, stall_s=0.02,
                           on_wave=widths.append)[0]
        assert loop.wave_width == ae_t.wave_bucket(16) == 16
        assert widths == [16] * loop.train_calls
        assert len(set(loop.wave_sizes)) > 1
        assert loop.wave_buckets_used == {ae_t.wave_bucket(w)
                                          for w in loop.wave_sizes}


# ----------------------------------------- the loop, sparse against dense
def _drive_loop(p, k_buf, m_conc, flushes, *, sparse, stall_s, spill=None,
                chunk=256, resident=None, on_wave=None):
    """``BufferedAsyncLoop`` driven directly with a tiny MLP (run_fl's
    dataset partition is O(P) host setup, irrelevant to the loop)."""
    acfg = agg_t.AggregationConfig(strategy="eftopk", cr=0.1)
    pop = pop_t.make_population(p, seed=11)
    params = sim_t.mlp_init(torch.Generator().manual_seed(11), 16, 5,
                            hidden=16, device="cpu")
    flat0 = torch.cat([params[k].reshape(-1) for k in sorted(params)])
    n = int(flat0.shape[0])
    data_rng = np.random.default_rng(4)
    x_all = torch.from_numpy(data_rng.normal(size=(256, 16))
                             .astype(np.float32))
    y_all = torch.from_numpy(data_rng.integers(0, 5, 256))
    k = k_for_ratio(n, acfg.cr)
    width = pop_t.residual_width(n, k)
    if sparse:
        store = pop_t.ClientStateStore(
            p, n, layout="topk_complement", width=width,
            chunk_clients=chunk, max_resident_chunks=resident,
            spill_dir=spill)
        merge = ae_t.make_async_merge_step(
            acfg, residual_layout="topk_complement", width=width,
            device="cpu")
    else:
        store, merge = None, ae_t.make_async_merge_step(acfg, device="cpu")
    wave_train = ae_t.make_wave_train_step(
        sim_t.mlp_loss, params, lr=0.1,
        make_batches=sim_t._gather_batches(x_all, y_all), strategy="eftopk")
    if on_wave is not None:
        inner = wave_train

        def wave_train(ring, x):
            on_wave(int(x["ver_idx"].shape[0]))
            return inner(ring, x)

    def batch_plan(client, uid):
        r = np.random.default_rng((11, BATCH_TAG, uid))
        return {"sample_idx": r.integers(256, size=(2, 4)).astype(np.int32),
                "step_mask": np.ones((2,), bool)}

    rts, sizes = [], []
    loop = ae_t.BufferedAsyncLoop(
        n_clients=p, n_params=n, buffer_k=k_buf, concurrency=m_conc,
        target_flushes=flushes, seed=11, alpha=0.5, stall_s=stall_s,
        p_fail=0.5,
        retry=cost_t.RetryPolicy(max_attempts=2, timeout_s=0.3),
        links=pop.links, v_bytes=4.0 * n,
        cr_eff_all=np.full(p, acfg.cr), ks_all=np.full(p, k, np.int32),
        coeff_table=None, fracs_all=pop.weights, merge=merge,
        wave_train=wave_train, batch_plan=batch_plan, residual_store=store,
        on_flush=lambda i, f, rt: rts.append((rt.actual, rt.max, rt.min)))
    flush = loop._flush

    def counted_flush(t):
        sizes.append(len(loop.buffer))
        flush(t)

    loop._flush = counted_flush
    loop.run(flat0.clone())
    return loop, rts, sizes


class TestSparseStoreLoop:
    def test_sparse_store_equals_dense_store(self):
        """P = 4096 over a K = 16 buffer with upload failures and
        stall-forced partial flushes: the sparse out-of-core store's run
        is bit-equal to the dense [P + 1, n] store's — params, the whole
        residual matrix and every flush's times."""
        p, k = 4096, 16
        dl, drts, dsizes = _drive_loop(p, k, 32, 8, sparse=False,
                                       stall_s=0.02)
        sl, srts, ssizes = _drive_loop(p, k, 32, 8, sparse=True,
                                       stall_s=0.02, chunk=64)
        assert dsizes == ssizes and drts == srts
        assert torch.equal(dl.flat, sl.flat)
        np.testing.assert_array_equal(sl.store.dump_dense(), dl.store[:p])
        assert min(dsizes) < k              # a partial (stall) flush
        assert dl.aborted_untrained > 0     # lazy mode skipped aborts


# --------------------------------------------------------- crash restart
class TestCrashRestart:
    @pytest.mark.parametrize("strategy,store", [
        ("bcrs_opwa", "none"), ("eftopk", "dense"), ("eftopk", "sparse"),
        ("qtopk", "sparse")])
    def test_restart_is_bit_exact(self, strategy, store, tmp_path):
        """Checkpoint every 2 flushes, crash after flush 3, resume: params,
        residuals, times, accuracies, buffer and dispatch counter equal the
        uninterrupted run's."""
        kw = dict(ASYNC)
        if store == "dense":
            kw["async_dense_store"] = True
        full = _run(strategy, **kw)
        ckpt = str(tmp_path / "ckpt")
        _run(strategy, **kw, checkpoint_dir=ckpt, checkpoint_every=2,
             stop_after=3)
        res = _run(strategy, **kw, checkpoint_dir=ckpt, checkpoint_every=2)
        _same(res, full)
        assert torch.equal(res.async_loop.flat, full.async_loop.flat)
        assert res.async_loop.proc.counter == full.async_loop.proc.counter
        assert [(b["client"], b["uid"]) for b in res.async_loop.buffer] == \
            [(b["client"], b["uid"]) for b in full.async_loop.buffer]

    def test_restart_with_the_sparse_store_spilled(self, tmp_path):
        """A 2-chunk window spilling to disk, 10 flushes, a crash after
        flush 5 and a resume from flush 4: the later checkpoints' retention
        prunes the snapshot the resumed store came from, and the run still
        finishes bit-equal to the uninterrupted one."""
        kw = dict(ASYNC, rounds=10, async_store_chunk=2,
                  async_store_resident=2,
                  async_store_spill=str(tmp_path / "spill"))
        full = _run("eftopk", **kw)
        assert full.async_loop.store.chunk_spills > 0
        ckpt = str(tmp_path / "ckpt")
        _run("eftopk", **kw, checkpoint_dir=ckpt, checkpoint_every=2,
             stop_after=5)
        res = _run("eftopk", **kw, checkpoint_dir=ckpt, checkpoint_every=2)
        _same(res, full)
        assert torch.equal(res.async_loop.flat, full.async_loop.flat)


# --------------------------------------------------- against the reference
class TestAgainstTheReference:
    def _init(self):
        sj = sim_j.FLSimConfig(**FAST)
        return {k: np.asarray(v) for k, v in sim_j.mlp_init(
            jax.random.PRNGKey(sj.seed), sj.dim, sj.n_classes,
            hidden=sj.hidden).items()}

    @pytest.mark.parametrize("strategy,extra", [
        ("eftopk", dict(ASYNC, async_stall_s=0.3)),
        ("bcrs_opwa", dict(ASYNC, async_sync_arrivals=True))])
    def test_whole_run(self, strategy, extra):
        """From the reference's initial weights: executed flushes, virtual
        and comm times and the dispatch order equal; accuracies within
        0.05."""
        cfg = {**FAST, **extra}
        rj = sim_j.run_fl(sim_j.FLSimConfig(**cfg),
                          agg_j.AggregationConfig(strategy=strategy,
                                                  cr=0.05),
                          engine="async")
        rt = sim_t.run_fl(sim_t.FLSimConfig(**cfg),
                          agg_t.AggregationConfig(strategy=strategy,
                                                  cr=0.05),
                          engine="async", device="cpu",
                          init_params=self._init())
        assert rt.executed_rounds == rj.executed_rounds
        assert _times(rt) == [(t.actual, t.max, t.min)
                              for t in rj.times.per_round]
        assert [r for r, _ in rt.accuracies] == [r for r, _ in rj.accuracies]
        for a_t, a_j in zip(_accs(rt), [a for _, a in rj.accuracies]):
            assert abs(a_t - a_j) <= 0.05
        if rj.async_loop is not None:
            lt, lj = rt.async_loop, rj.async_loop
            assert lt.proc.counter == lj.proc.counter
            assert lt.wave_sizes == lj.wave_sizes
            assert lt.aborted_untrained == lj.aborted_untrained
            assert [(b["client"], b["uid"]) for b in lt.buffer] == \
                [(b["client"], b["uid"]) for b in lj.buffer]
            assert [e.__dict__ for e in lt.proc.in_flight()] == \
                [e.__dict__ for e in lj.proc.in_flight()]
