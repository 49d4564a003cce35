"""Port parity at the places where the port's interface had drifted from the
reference's, each held against the reference computed live in the same
test (F1 to F6):

* F1 ``run_fl`` takes the reference's ``fused`` flag and ``engine=None``,
  and raises ``ValueError`` on an unknown engine;
* F2 ``opwa_aggregate`` and ``weighted_sum`` take ``[K, *shape]`` leaves;
* F3 ``ops.block_topk`` returns values in the input's dtype;
* F4 block Top-K takes rows wider than the register path's 16384;
* F5 ``opwa_aggregate_traced_k`` defaults to ``use_kernel="auto"``;
* F6 the ``fed`` and ``data`` packages export the reference's names that
  are ported, ``ef_compress_batch`` takes ``use_kernel=`` (and refuses a
  non-global compressor with it), ``COMPRESSORS`` exists, and
  ``topk_compress_dynamic`` takes ``n_iters=``.

Tolerances and why: selections, masks and values are bit for bit (both
sides run the same selection on the same f32 patterns); sums over clients
add the same f32 terms in another order than XLA, so they are held to
``2*K*2^-24*gamma*sum_k|c_k v_k|`` per element; whole runs drift by those
roundings through local SGD, so accuracies are held within 0.05 absolute
over 3 rounds, as in ``tests/test_torch_legacy.py``.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as agg_j
from repro.core import compression as comp_j
from repro.core import opwa as opwa_j
from repro.fed import simulation as sim_j
from repro.kernels import ops as ops_j
from repro_torch.core import aggregation as agg_t
from repro_torch.core import compression as comp_t
from repro_torch.core import opwa as opwa_t
from repro_torch.fed import simulation as sim_t
from repro_torch.kernels import ops as ops_t

torch.set_num_threads(1)

SMALL = dict(dim=32, hidden=32, n_classes=5, n_clients=6, n_train=600,
             n_test=200, batch_size=32, rounds=3, eval_every=1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def _assert_sum_close(got, want, coeffs, vals, gamma):
    """|d| <= 2*K*2^-24*gamma*sum_k |c_k v_k| per element: the same f32
    products summed in two orders."""
    terms = np.abs(np.asarray(coeffs, np.float64).reshape(
        (-1,) + (1,) * (np.ndim(vals) - 1)) * np.asarray(vals, np.float64))
    bound = 2 * terms.shape[0] * 2.0 ** -24 * gamma * terms.sum(0)
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert diff.shape == bound.shape
    assert (diff <= bound).all(), float((diff - bound).max())


# ---------------------------------------------------------------- F1
class TestF1RunFLEngineSelection:
    @pytest.mark.parametrize("fused", [False, True])
    def test_f1_fused_flag_vs_reference(self, fused):
        """``fused`` in the reference's 5th position picks the engine when
        ``engine`` is None: False runs the legacy engine, True the fused."""
        sj, st = sim_j.FLSimConfig(**SMALL), sim_t.FLSimConfig(**SMALL)
        init = {k: np.asarray(v) for k, v in sim_j.mlp_init(
            jax.random.PRNGKey(sj.seed), sj.dim, sj.n_classes,
            hidden=sj.hidden).items()}
        acfg = dict(strategy="bcrs_opwa")
        rj = sim_j.run_fl(sj, agg_j.AggregationConfig(**acfg), None, False,
                          fused)
        rt = sim_t.run_fl(st, agg_t.AggregationConfig(**acfg), None, False,
                          fused, device="cpu", init_params=init)
        same = sim_t.run_fl(st, agg_t.AggregationConfig(**acfg),
                            engine="fused" if fused else "legacy",
                            device="cpu", init_params=init)
        assert rt.accuracies == same.accuracies
        assert rt.losses == same.losses
        assert rt.executed_rounds == rj.executed_rounds
        assert [r for r, _ in rt.accuracies] == [r for r, _ in rj.accuracies]
        for (_, a_t), (_, a_j) in zip(rt.accuracies, rj.accuracies):
            assert abs(a_t - a_j) <= 0.05
        assert [p.actual for p in rt.times.per_round] == \
            [p.actual for p in rj.times.per_round]

    def test_f1_unknown_engine_raises_value_error(self):
        for run, mod, extra in ((sim_j.run_fl, agg_j, {}),
                                (sim_t.run_fl, agg_t, {"device": "cpu"})):
            with pytest.raises(ValueError, match="unknown engine"):
                run(sim_j.FLSimConfig(**SMALL) if mod is agg_j
                    else sim_t.FLSimConfig(**SMALL),
                    mod.AggregationConfig(), engine="warp", **extra)
        params = list(inspect.signature(sim_t.run_fl).parameters)
        ref = list(inspect.signature(sim_j.run_fl).parameters)
        assert params[:len(ref)] == ref
        assert params[len(ref):] == ["device", "init_params"]


# ---------------------------------------------------------------- F2
@pytest.mark.parametrize("shape", [(3, 8, 5), (4, 2, 3, 7)])
def test_f2_opwa_aggregate_rank_agnostic(shape):
    rng = np.random.default_rng(len(shape))
    k = shape[0]
    masks = rng.random(shape) < 0.4
    vals = (rng.normal(size=shape) * masks).astype(np.float32)
    coeffs = rng.uniform(0.1, 1.0, k).astype(np.float32)
    want = np.asarray(opwa_j.opwa_aggregate(
        jnp.asarray(vals), jnp.asarray(masks), jnp.asarray(coeffs), 5.0, 1))
    got = opwa_t.opwa_aggregate(_t(vals), _t(masks), _t(coeffs), 5.0, 1)
    assert tuple(got.shape) == shape[1:] == want.shape
    _assert_sum_close(got.numpy(), want, coeffs, vals, 5.0)
    plain = opwa_t.weighted_sum(_t(coeffs), _t(vals))
    _assert_sum_close(plain.numpy(), np.tensordot(coeffs, vals, axes=(0, 0)),
                      coeffs, vals, 1.0)


# ---------------------------------------------------------------- F3
def test_f3_block_topk_values_keep_input_dtype():
    rng = np.random.default_rng(3)
    u = rng.normal(size=1500).astype(np.float32)
    u[:40] = u[0]                                   # ties
    ub = torch.from_numpy(u).to(torch.bfloat16)
    uj = jnp.asarray(ub.float().numpy()).astype(jnp.bfloat16)
    want = ops_j.block_topk(uj, 0.1, block=512)
    got = ops_t.block_topk(ub, 0.1, block=512)
    assert got.values.dtype == torch.bfloat16
    assert want.values.dtype == jnp.bfloat16
    np.testing.assert_array_equal(_bits(got.values.view(torch.int16)),
                                  _bits(np.asarray(want.values)))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))


# ---------------------------------------------------------------- F4
@pytest.mark.parametrize("route", ["plain", "twin"])
def test_f4_block_wider_than_register_rows(route):
    """block = 32768: the exact plain route against the reference's, and
    the kernel's twin (``ops.block_topk`` on CPU tensors) against the
    reference's Pallas kernel in interpret mode."""
    block, n = 32768, 70_001
    rng = np.random.default_rng(4)
    u = rng.normal(size=n).astype(np.float32)
    u[100:2000] = u[100]                            # ties across k
    u[40_000:40_100] *= np.float32(1e-40)           # denormals
    if route == "plain":
        want = comp_j.block_topk_compress(jnp.asarray(u), 0.1, block=block,
                                          use_kernel=False)
        got = comp_t.block_topk_compress(_t(u), 0.1, block=block,
                                         use_kernel=False)
    else:
        want = ops_j.block_topk(jnp.asarray(u), 0.1, block=block)
        got = ops_t.block_topk(_t(u), 0.1, block=block)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(_bits(got.values.numpy()),
                                  _bits(np.asarray(want.values)))
    assert int(got.mask.sum()) >= 3 * round(0.1 * block) - 1


# ---------------------------------------------------------------- F5
def test_f5_traced_k_default_is_auto():
    assert inspect.signature(opwa_t.opwa_aggregate_traced_k).parameters[
        "use_kernel"].default == "auto" == inspect.signature(
        opwa_j.opwa_aggregate_traced_k).parameters["use_kernel"].default
    rng = np.random.default_rng(5)
    c, n = 4, 1024
    u = rng.normal(size=(c, n)).astype(np.float32)
    ks = np.array([1, 100, 1024, 37], np.int32)
    w = rng.uniform(0.1, 1, c).astype(np.float32)
    want = opwa_j.opwa_aggregate_traced_k(jnp.asarray(u), jnp.asarray(ks),
                                          jnp.asarray(w), 5.0, 1)
    got = opwa_t.opwa_aggregate_traced_k(_t(u), _t(ks), _t(w), 5.0, 1)
    plain = opwa_t.opwa_aggregate_traced_k(_t(u), _t(ks), _t(w), 5.0, 1,
                                           use_kernel=False)
    assert torch.equal(got, plain)       # "auto" on CPU tensors is plain
    vals = np.asarray(jax.vmap(comp_j.topk_compress_dynamic)(
        jnp.asarray(u), jnp.asarray(ks)).values)
    _assert_sum_close(got.numpy(), want, w, vals, 5.0)


# ---------------------------------------------------------------- F6
#: the reference's ``repro.fed`` exports that wait for the mesh scan
#: (ROADMAP queue 1, item 1b)
FED_NOT_PORTED = {"make_mesh_sim_scan", "MeshSimScan"}


def test_f6_fed_package_exports_the_ported_names():
    import repro.fed as fed_j
    import repro_torch.fed as fed_t
    assert set(fed_t.__all__) == set(fed_j.__all__) - FED_NOT_PORTED
    for name in fed_t.__all__:
        assert callable(getattr(fed_t, name)), name
    for name in ("compress_merge_leaf", "init_mesh_residuals",
                 "make_mesh_round_step", "make_fl_round_step"):
        assert list(inspect.signature(getattr(fed_t, name)).parameters)[
            :len(inspect.signature(getattr(fed_j, name)).parameters)] == \
            list(inspect.signature(getattr(fed_j, name)).parameters), name


def test_f6_data_package_exports_match_the_reference():
    import repro.data as data_j
    import repro_torch.data as data_t
    assert set(data_t.__all__) == set(data_j.__all__)
    toks_j = data_j.synthetic_lm_tokens(6, 17, 50, np.random.default_rng(6))
    toks_t = data_t.synthetic_lm_tokens(6, 17, 50, np.random.default_rng(6))
    np.testing.assert_array_equal(toks_t, toks_j)
    bj, bt = data_j.lm_batch(toks_j), data_t.lm_batch(toks_t)
    assert set(bj) == set(bt)
    for k in bj:
        np.testing.assert_array_equal(bt[k], bj[k])
        assert bt[k].dtype == bj[k].dtype
    labels = np.random.default_rng(7).integers(0, 5, 200)
    parts = data_j.dirichlet_partition(labels, 4, 0.5,
                                       np.random.default_rng(8))
    np.testing.assert_array_equal(
        data_t.client_label_histogram(labels, parts),
        data_j.client_label_histogram(labels, parts))


def test_f6_ef_compress_batch_kernel_route():
    """``use_kernel=True``: thresholds of ``residuals + updates`` from the
    kernel (its twin on CPU tensors) against the reference's Pallas kernel
    in interpret mode and both plain routes — masks, values and residuals
    bit for bit."""
    rng = np.random.default_rng(10)
    c, n = 5, 3333
    u = rng.normal(size=(c, n)).astype(np.float32)
    e = (0.3 * rng.normal(size=(c, n))).astype(np.float32)
    u[1, :500] = u[1, 0]                             # ties
    ks = np.array([1, 20, 3333, 700, 99], np.int32)
    outs = [comp_j.ef_compress_batch(jnp.asarray(e), jnp.asarray(u),
                                     jnp.asarray(ks), use_kernel=uk)
            for uk in (False, True)]
    outs += [comp_t.ef_compress_batch(_t(e), _t(u), _t(ks), use_kernel=uk)
             for uk in (False, True)]
    want_c, want_r = outs[0]
    for got_c, got_r in outs[1:]:
        np.testing.assert_array_equal(np.asarray(got_c.mask),
                                      np.asarray(want_c.mask))
        np.testing.assert_array_equal(_bits(np.asarray(got_c.values)),
                                      _bits(np.asarray(want_c.values)))
        np.testing.assert_array_equal(_bits(np.asarray(got_r)),
                                      _bits(np.asarray(want_r)))


def test_f6_ef_kernel_route_rejects_custom_compressor():
    rng = np.random.default_rng(11)
    u = rng.normal(size=(3, 1024)).astype(np.float32)
    e = np.zeros_like(u)
    ks = np.array([10, 20, 30], np.int32)
    with pytest.raises(ValueError, match="global Top-K"):
        comp_j.ef_compress_batch(
            jnp.asarray(e), jnp.asarray(u), jnp.asarray(ks),
            compress_batch=comp_j.block_topk_compress_batch, use_kernel=True)
    with pytest.raises(ValueError, match="global Top-K"):
        comp_t.ef_compress_batch(
            _t(e), _t(u), _t(ks),
            compress_batch=comp_t.block_topk_compress_batch, use_kernel=True)


@pytest.mark.parametrize("name", ["topk", "blocktopk"])
def test_f6_compressors_registry(name):
    assert set(comp_t.COMPRESSORS) == set(comp_j.COMPRESSORS)
    rng = np.random.default_rng(12)
    u = rng.normal(size=20_000).astype(np.float32)
    u[:300] = u[0]                                   # ties
    kw = {"use_kernel": False} if name == "blocktopk" else {}
    want = comp_j.COMPRESSORS[name](jnp.asarray(u), 0.05, **kw)
    got = comp_t.COMPRESSORS[name](_t(u), 0.05, **kw)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(_bits(got.values.numpy()),
                                  _bits(np.asarray(want.values)))


@pytest.mark.parametrize("n_iters", [1, 4, 9, 16, 31, 32])
def test_f6_topk_compress_dynamic_n_iters(n_iters):
    """A bisection cut short keeps the reference's ``lo`` after ``n_iters``
    halvings: the same (superset) mask, bit for bit."""
    rng = np.random.default_rng(13)
    u = rng.normal(size=4097).astype(np.float32)
    u[:64] = u[0]                                    # ties
    u[100] = np.float32(np.nan)
    for k in (1, 64, 1000, 4097):
        want = comp_j.topk_compress_dynamic(jnp.asarray(u), k,
                                            n_iters=n_iters)
        got = comp_t.topk_compress_dynamic(_t(u), k, n_iters=n_iters)
        np.testing.assert_array_equal(got.mask.numpy(),
                                      np.asarray(want.mask))
        np.testing.assert_array_equal(_bits(got.values.numpy()),
                                      _bits(np.asarray(want.values)))
