"""Port parity, host and core layer: ``repro_torch.core`` / ``data`` / ``ft``
against the JAX package on the same numpy inputs.

Integer and selection quantities (schedules, ks, masks, counts, scales) and
elementwise f32 outputs are held bit for bit; the client-axis sums are held
to the reordering bound of f32 summation (see ``_assert_sum_close``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.core import aggregation as agg_j
from repro.core import compression as comp_j
from repro.core import cost_model as cm_j
from repro.core import opwa as opwa_j
from repro.core import strategies as strat_j
from repro.ft import FailureInjector as FailureInjectorJ
from repro.ft import StragglerPolicy as StragglerPolicyJ
from repro.ft import arrivals as arrivals_j
from repro_torch.core import aggregation as agg_t
from repro_torch.core import compression as comp_t
from repro_torch.core import cost_model as cm_t
from repro_torch.core import opwa as opwa_t
from repro_torch.core import strategies as strat_t
from repro_torch.ft import FailureInjector as FailureInjectorT
from repro_torch.ft import StragglerPolicy as StragglerPolicyT
from repro_torch.ft import arrivals as arrivals_t

torch.set_num_threads(1)

BUILTINS = ("fedavg", "topk", "eftopk", "bcrs", "bcrs_opwa", "qtopk",
            "bitmask_topk", "int4")


def _t(a):
    return torch.from_numpy(np.array(a))


def _u32(a):
    return np.asarray(a).view(np.uint32)


def _assert_sum_close(got, want, terms, gamma=1.0):
    """Client sums: |got - want| <= 2 * C * 2^-24 * gamma * sum_c |w_c v_c|
    per coordinate. The two sides add the same f32 terms in different
    orders (the port in client order, XLA's dot in its own), and each
    reordering moves the result by at most C roundings of the running sum,
    each bounded by 2^-24 of sum |terms|; OPWA then scales by gamma."""
    terms = np.asarray(terms, np.float64)
    bound = 2 * terms.shape[0] * 2.0 ** -24 * gamma * np.abs(terms).sum(0)
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert (diff <= bound).all(), float((diff - bound).max())


def _edge_rows(c, n, seed):
    """Updates with an all-zero row, ties, a denormal row and a huge row."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(c, n)).astype(np.float32)
    u[0] = 0.0
    u[1, : n // 2] = u[1, 0]
    u[2] *= np.float32(1e-40)
    u[3] *= np.float32(1e30)
    return u


# ------------------------------------------------------------ schedules
class TestSchedule:
    @pytest.mark.parametrize("strategy", BUILTINS)
    def test_round_schedule_bitwise(self, strategy):
        rng = np.random.default_rng(11)
        k, n = 7, 136_724
        links = cm_t.sample_links(k, rng)
        fr = rng.dirichlet(np.ones(k))
        v = 4.0 * n
        crs_j, w_j, info_j = agg_j.round_schedule(
            agg_j.AggregationConfig(strategy=strategy), k, fr,
            cm_j.sample_links(k, np.random.default_rng(11)), v)
        crs_t, w_t, info_t = agg_t.round_schedule(
            agg_t.AggregationConfig(strategy=strategy), k, fr, links, v)
        np.testing.assert_array_equal(np.asarray(crs_t, np.float64)
                                      .view(np.uint64),
                                      np.asarray(crs_j, np.float64)
                                      .view(np.uint64))
        np.testing.assert_array_equal(np.asarray(w_t, np.float64)
                                      .view(np.uint64),
                                      np.asarray(w_j, np.float64)
                                      .view(np.uint64))
        assert sorted(info_t) == sorted(info_j)
        acfg_j = agg_j.AggregationConfig(strategy=strategy)
        acfg_t = agg_t.AggregationConfig(strategy=strategy)
        np.testing.assert_array_equal(agg_t.ks_for_schedule(n, crs_t, acfg_t),
                                      agg_j.ks_for_schedule(n, crs_j, acfg_j))
        np.testing.assert_array_equal(agg_t.overlap_ks(acfg_t, info_t, k, n),
                                      agg_j.overlap_ks(acfg_j, info_j, k, n))

    def test_k_for_ratio_identical(self):
        for n in (1, 7, 1000, 136_724):
            for cr in (0.0, 0.005, 0.01, 0.1, 0.5, 0.999, 1.0):
                assert comp_t.k_for_ratio(n, cr) == comp_j.k_for_ratio(n, cr)

    def test_wire_pricing_identical(self):
        assert strat_t.names() == strat_j.names()
        crs = np.array([0.01, 0.1, 0.37, 1.0])
        for name in BUILTINS:
            wt, wj = strat_t.get(name).wire, strat_j.get(name).wire
            assert dataclasses.astuple(wt) == dataclasses.astuple(wj)
            np.testing.assert_array_equal(wt.cr_eff(crs, 136_724),
                                          wj.cr_eff(crs, 136_724))
            assert wt.bytes_on_wire(136_724, 1367) == \
                wj.bytes_on_wire(136_724, 1367)

    def test_round_times_identical(self):
        rng = np.random.default_rng(3)
        links = cm_t.sample_links(9, rng)
        crs = rng.uniform(0.01, 1.0, 9)
        rt_t = cm_t.round_times(links, 5e5, crs)
        rt_j = cm_j.round_times(cm_j.sample_links(9, np.random.default_rng(3)),
                                5e5, crs)
        assert (rt_t.actual, rt_t.max, rt_t.min) == \
            (rt_j.actual, rt_j.max, rt_j.min)

    def test_registry_validation_matches(self):
        with pytest.raises(ValueError, match="requires carry='ef'"):
            strat_t.register(strat_t.Strategy(
                name="x", value_codec=strat_t.int8_symmetric_codec,
                megakernel=False))
        with pytest.raises(ValueError, match="registered: fedavg"):
            strat_t.get("nope")
        with pytest.raises(ValueError, match="unknown strategy 'nope'"):
            agg_t.AggregationConfig(strategy="nope")


# ------------------------------------------------------------ fault tolerance
class TestHostFaultTolerance:
    def test_failures_identical(self):
        ft, fj = FailureInjectorT(p_fail=0.4, seed=5), \
            FailureInjectorJ(p_fail=0.4, seed=5)
        for r in range(6):
            np.testing.assert_array_equal(ft.survivors(r, 20),
                                          fj.survivors(r, 20))
            ids = np.arange(3, 40, 3)
            np.testing.assert_array_equal(ft.survivors_at(r, ids),
                                          fj.survivors_at(r, ids))

    def test_arrivals_identical(self):
        t = np.random.default_rng(2).exponential(1.0, 12)
        a_t = arrivals_t(t, 8, StragglerPolicyT(deadline_factor=1.2))
        a_j = arrivals_j(t, 8, StragglerPolicyJ(deadline_factor=1.2))
        np.testing.assert_array_equal(a_t[0], a_j[0])
        assert a_t[1] == a_j[1]


# ------------------------------------------------------------ codec
class TestCodec:
    @pytest.mark.parametrize("mantissa_bits", [16, 20])
    def test_round_mantissa_vs_reduce_precision(self, mantissa_bits):
        """Every kind of f32 pattern: random bits (denormals, NaNs and infs
        included), zeros, the largest finite values."""
        rng = np.random.default_rng(mantissa_bits)
        a = rng.integers(0, 2 ** 32, 50_000, dtype=np.uint64) \
            .astype(np.uint32).view(np.float32)
        a = np.concatenate([a, np.array([0.0, -0.0, 1e-45, 3e-39, 1.17e-38,
                                         3.4028235e38, -3.4028235e38,
                                         np.inf, -np.inf], np.float32)])
        want = np.asarray(lax.reduce_precision(jnp.asarray(a), 8,
                                               mantissa_bits))
        got = strat_t.round_mantissa(_t(a), mantissa_bits).numpy()
        nan = np.isnan(want)
        np.testing.assert_array_equal(np.isnan(got), nan)
        np.testing.assert_array_equal(_u32(got)[~nan], _u32(want)[~nan])

    @pytest.mark.parametrize("codec", ["int8", "int4"])
    def test_quantization_scale_bitwise(self, codec):
        """Random magnitudes over the whole f32 range, zeros, denormals
        (flushed to scale 0 as the reference's platforms do) and large."""
        levels = strat_t.CODEC_LEVELS[codec]
        rng = np.random.default_rng(7)
        a = np.abs(rng.integers(0, 2 ** 32, 50_000, dtype=np.uint64)
                   .astype(np.uint32).view(np.float32))
        a = a[np.isfinite(a)]
        a = np.concatenate([a, rng.uniform(0, 3, 1000).astype(np.float32),
                            np.array([0.0, 1e-45, 3e-39, 1.17e-38, 1.18e-38,
                                      1.5e-36, 3.4028235e38], np.float32)])
        want = np.asarray(strat_j.quantization_scale(jnp.asarray(a), levels))
        got = strat_t.quantization_scale(_t(a), levels).numpy()
        np.testing.assert_array_equal(_u32(got), _u32(want))

    @pytest.mark.parametrize("codec", ["int8", "int4"])
    def test_symmetric_codec_bitwise(self, codec):
        """Random rows, an all-zero row, and values exactly on half grid
        steps (round half to even on both sides)."""
        levels = strat_t.CODEC_LEVELS[codec]
        rng = np.random.default_rng(1)
        v = rng.normal(size=(5, 333)).astype(np.float32)
        v[0] = 0.0
        v[1, :20] = (np.arange(20) + 0.5).astype(np.float32)
        scale = np.asarray(strat_j.quantization_scale(
            jnp.max(jnp.abs(jnp.asarray(v)), axis=1, keepdims=True), levels))
        want = np.asarray(strat_j.symmetric_dequantize(
            jnp.asarray(v), jnp.asarray(scale), levels))
        got = strat_t.symmetric_dequantize(_t(v), _t(scale), levels).numpy()
        np.testing.assert_array_equal(_u32(got), _u32(want))
        fn_j = {"int8": strat_j.int8_symmetric_codec,
                "int4": strat_j.int4_symmetric_codec}[codec]
        fn_t = {"int8": strat_t.int8_symmetric_codec,
                "int4": strat_t.int4_symmetric_codec}[codec]
        np.testing.assert_array_equal(
            _u32(fn_t(_t(v), None).numpy()),
            _u32(np.asarray(fn_j(jnp.asarray(v), None))))


# ------------------------------------------------------------ top-k
class TestTopK:
    @pytest.mark.parametrize("n", [512, 1001])
    def test_dynamic_masks_bitwise(self, n):
        u = _edge_rows(6, n, n)
        ks = np.array([5, n, 13, 1, n // 2, 1], np.int32)
        want = jax.vmap(comp_j.topk_compress_dynamic)(jnp.asarray(u),
                                                      jnp.asarray(ks))
        got = comp_t.topk_compress_batch(_t(u), _t(ks))
        np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
        np.testing.assert_array_equal(_u32(got.values.numpy()),
                                      _u32(np.asarray(want.values)))
        # the kernel route (the threshold_find twin on CPU) picks the same
        twin = comp_t.topk_compress_batch(_t(u), _t(ks), use_kernel=True)
        np.testing.assert_array_equal(twin.mask.numpy(), np.asarray(want.mask))

    def test_single_row_and_nan_row(self):
        u = np.random.default_rng(0).normal(size=(64,)).astype(np.float32)
        for k in (1, 7, 64):
            want = comp_j.topk_compress_dynamic(jnp.asarray(u), k)
            got = comp_t.topk_compress_dynamic(_t(u), k)
            np.testing.assert_array_equal(got.mask.numpy(),
                                          np.asarray(want.mask))
        u[3] = np.float32(np.nan)      # max + 1 overflows int32: lo/hi int64
        want = comp_j.topk_compress_dynamic(jnp.asarray(u), 5)
        got = comp_t.topk_compress_dynamic(_t(u), 5)
        np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))

    def test_ef_compress_batch_bitwise(self):
        rng = np.random.default_rng(4)
        u = rng.normal(size=(4, 700)).astype(np.float32)
        e = (0.3 * rng.normal(size=(4, 700))).astype(np.float32)
        ks = np.array([1, 70, 350, 700], np.int32)
        cj, rj = comp_j.ef_compress_batch(jnp.asarray(e), jnp.asarray(u),
                                          jnp.asarray(ks))
        ct, rt = comp_t.ef_compress_batch(_t(e), _t(u), _t(ks))
        np.testing.assert_array_equal(ct.mask.numpy(), np.asarray(cj.mask))
        np.testing.assert_array_equal(_u32(rt.numpy()), _u32(np.asarray(rj)))

    def test_use_kernel_resolution(self):
        assert comp_t.resolve_use_kernel("auto", "cpu") is False
        assert comp_t.resolve_use_kernel(False, "cpu") is False
        with pytest.raises(ValueError, match="CUDA"):
            comp_t.resolve_use_kernel(True, "cpu")

    def test_flatten_tree_sorted_key_order(self):
        tree = {"w1": np.arange(6, dtype=np.float32).reshape(2, 3),
                "b1": np.array([10.0, 11.0], np.float32),
                "a": np.array([-1.0], np.float32)}
        want, _ = comp_j.flatten_tree({k: jnp.asarray(v)
                                       for k, v in tree.items()})
        got = comp_t.flatten_tree({k: _t(v) for k, v in tree.items()})
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------ OPWA
class TestOPWA:
    def test_counts_mask_aggregate(self):
        rng = np.random.default_rng(9)
        c, n = 5, 2048
        u = rng.normal(size=(c, n)).astype(np.float32)
        ks = np.array([20, 200, 2000, 1, 1024], np.int32)
        w = rng.uniform(0.1, 1, c).astype(np.float32)
        comp = jax.vmap(comp_j.topk_compress_dynamic)(jnp.asarray(u),
                                                      jnp.asarray(ks))
        vals, mask = np.asarray(comp.values), np.asarray(comp.mask)
        counts_j = np.asarray(opwa_j.overlap_counts(jnp.asarray(mask)))
        counts_t = opwa_t.overlap_counts(_t(mask)).numpy()
        np.testing.assert_array_equal(counts_t, counts_j)
        for d in (1, 2):
            np.testing.assert_array_equal(
                opwa_t.opwa_mask(_t(counts_j), 5.0, d).numpy(),
                np.asarray(opwa_j.opwa_mask(jnp.asarray(counts_j), 5.0, d)))
        agg_j_ = opwa_j.opwa_aggregate(jnp.asarray(vals), jnp.asarray(mask),
                                       jnp.asarray(w), 5.0, 1,
                                       use_kernel=False)
        agg_t_ = opwa_t.opwa_aggregate(_t(vals), _t(mask), _t(w), 5.0, 1)
        _assert_sum_close(agg_t_.numpy(), agg_j_, w[:, None] * vals, 5.0)

    @pytest.mark.parametrize("route", ["plain", "twin"])
    def test_traced_k_with_active(self, route):
        rng = np.random.default_rng(10)
        c, n = 6, 1536
        u = rng.normal(size=(c, n)).astype(np.float32)
        u[-1] = 0.0                         # a padded cohort slot
        ks = np.array([15, 150, 1500, 1, 768, 1], np.int32)
        w = rng.uniform(0.1, 1, c).astype(np.float32)
        w[-1] = 0.0
        active = np.array([1, 1, 1, 1, 1, 0], bool)
        want = opwa_j.opwa_aggregate_traced_k(
            jnp.asarray(u), jnp.asarray(ks), jnp.asarray(w), 5.0, 1,
            active=jnp.asarray(active), use_kernel=False)
        got = opwa_t.opwa_aggregate_traced_k(
            _t(u), _t(ks), _t(w), 5.0, 1, active=_t(active),
            use_kernel=(route == "twin"))
        vals = np.asarray(jax.vmap(comp_j.topk_compress_dynamic)(
            jnp.asarray(u), jnp.asarray(ks)).values) * active[:, None]
        _assert_sum_close(got.numpy(), want, w[:, None] * vals, 5.0)
