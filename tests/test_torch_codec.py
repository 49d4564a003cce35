"""Port parity, the remaining compressors and the sparse row codec:
``to_sparse`` / ``from_sparse``, ``overlap_histogram``, ``bcrs_aggregate``,
``k_for_ratio_traced``, ``engine.sparsify_rows`` / ``densify_rows`` against
the JAX package on the same numpy inputs, and ``randk_compress`` /
``quantize_stochastic``, which draw from a ``torch.Generator`` (not
``jax.random``'s stream), checked statistically at a fixed seed.

Tolerances and why: indices, masks, counts and the row codec are integer or
selection quantities, held bit for bit (ties included: ``lax.top_k`` takes
the lower index first); ``bcrs_aggregate`` is an f32 sum over clients,
held to the reordering bound ``2*C*2^-24*sum_c|w_c v_c|``. The statistical
checks use six standard deviations of the CLT at the stated trial count.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as comp_j
from repro.core import opwa as opwa_j
from repro.fed import engine as engine_j
from repro_torch.core import compression as comp_t
from repro_torch.core import opwa as opwa_t
from repro_torch.fed import engine as engine_t

torch.set_num_threads(1)

TINY = np.float32(np.finfo(np.float32).tiny)


def _u32(a):
    return np.asarray(a).view(np.uint32)


def _tied_case(n=257, seed=0):
    """A dense-masked vector whose kept magnitudes repeat (ties across the
    k-th), signs mixed, some kept values exactly zero."""
    rng = np.random.default_rng(seed)
    vals = rng.choice([0.5, 1.0, 2.0, 0.0], size=n).astype(np.float32)
    vals *= rng.choice([-1.0, 1.0], size=n).astype(np.float32)
    mask = rng.random(n) < 0.4
    vals = np.where(mask, vals, 0.0).astype(np.float32)
    return vals, mask


class TestSparseFormat:
    @pytest.mark.parametrize("k", [1, 17, 64, 103, 257])
    def test_to_sparse_with_ties(self, k):
        vals, mask = _tied_case()
        i_j, v_j = comp_j.to_sparse(
            comp_j.Compressed(jnp.asarray(vals), jnp.asarray(mask)), k)
        i_t, v_t = comp_t.to_sparse(
            comp_t.Compressed(torch.from_numpy(vals), torch.from_numpy(mask)),
            k)
        assert i_t.dtype == torch.int32
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
        np.testing.assert_array_equal(_u32(v_t.numpy()), _u32(v_j))

    @pytest.mark.parametrize("k", [17, 257])
    def test_from_sparse_round_trip(self, k):
        vals, mask = _tied_case(seed=1)
        i_j, v_j = comp_j.to_sparse(
            comp_j.Compressed(jnp.asarray(vals), jnp.asarray(mask)), k)
        d_j = comp_j.from_sparse(i_j, v_j, vals.shape[0])
        d_t = comp_t.from_sparse(torch.from_numpy(np.array(i_j)),
                                 torch.from_numpy(np.array(v_j)),
                                 vals.shape[0])
        np.testing.assert_array_equal(_u32(d_t.numpy()), _u32(d_j))
        if k >= mask.sum():           # every kept entry fits: lossless
            np.testing.assert_array_equal(d_t.numpy(), vals)


class TestOverlap:
    @pytest.mark.parametrize("k_max", [None, 2, 3, 9])
    def test_overlap_histogram(self, k_max):
        rng = np.random.default_rng(2)
        masks = rng.random((6, 4099)) < 0.5
        h_j = opwa_j.overlap_histogram(jnp.asarray(masks), k_max)
        h_t = opwa_t.overlap_histogram(torch.from_numpy(masks), k_max)
        assert h_t.dtype == torch.int32
        np.testing.assert_array_equal(h_t.numpy(), np.asarray(h_j))

    def test_bcrs_aggregate_within_bound(self):
        rng = np.random.default_rng(3)
        u = rng.normal(size=(5, 3001)).astype(np.float32)
        w = rng.uniform(0.05, 1.0, 5).astype(np.float32)
        a_j = np.asarray(opwa_j.bcrs_aggregate(jnp.asarray(u),
                                               jnp.asarray(w)), np.float64)
        a_t = opwa_t.bcrs_aggregate(torch.from_numpy(u),
                                    torch.from_numpy(w)).numpy()
        bound = 2 * 5 * 2.0 ** -24 * np.abs(
            w[:, None].astype(np.float64) * u).sum(0)
        assert (np.abs(a_t - a_j) <= bound).all()


class TestKForRatioTraced:
    def test_bit_equal(self):
        rng = np.random.default_rng(4)
        crs = np.concatenate([rng.uniform(0.0, 1.0, 200),
                              [0.0, 1.0, 0.5, 1e-9, 0.25, 0.125]]
                             ).astype(np.float32)
        for n in (1, 7, 1000, 136_724):
            k_j = comp_j.k_for_ratio_traced(n, jnp.asarray(crs))
            k_t = comp_t.k_for_ratio_traced(n, torch.from_numpy(crs))
            assert k_t.dtype == torch.int32
            np.testing.assert_array_equal(k_t.numpy(), np.asarray(k_j))


class TestRowCodec:
    def _rows(self):
        """Residual rows with exact zeros, denormals (which the reference's
        platform reads as zero), a negative zero and a NaN."""
        rng = np.random.default_rng(5)
        rows = rng.normal(size=(4, 512)).astype(np.float32)
        rows[rng.random(rows.shape) < 0.6] = 0.0
        rows[0, 3] = TINY / 4           # denormal
        rows[1, 10] = -TINY / 2         # negative denormal
        rows[2, 7] = -0.0
        rows[3, 100] = np.nan
        rows[3, 200] = TINY             # the smallest normal stays
        return rows

    @pytest.mark.parametrize("width", [160, 260, 512])
    def test_sparsify_vs_reference(self, width):
        rows = self._rows()
        i_j, v_j, o_j = engine_j.sparsify_rows(jnp.asarray(rows), width)
        i_t, v_t, o_t = engine_t.sparsify_rows(torch.from_numpy(rows), width)
        assert i_t.dtype == torch.int32
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
        np.testing.assert_array_equal(_u32(v_t.numpy()), _u32(v_j))
        assert bool(o_t) == bool(o_j)

    def test_overflow_flag(self):
        rows = self._rows()
        nnz = int((np.abs(np.nan_to_num(rows, nan=1.0)) >= TINY)
                  .sum(1).max())
        assert bool(engine_t.sparsify_rows(torch.from_numpy(rows),
                                           nnz - 1)[2])
        assert not bool(engine_t.sparsify_rows(torch.from_numpy(rows),
                                               nnz)[2])

    @pytest.mark.parametrize("width", [260, 512])
    def test_round_trip_vs_reference(self, width):
        rows = self._rows()
        i_j, v_j, _ = engine_j.sparsify_rows(jnp.asarray(rows), width)
        d_j = engine_j.densify_rows(i_j, v_j, rows.shape[1])
        i_t, v_t, o_t = engine_t.sparsify_rows(torch.from_numpy(rows), width)
        d_t = engine_t.densify_rows(i_t, v_t, rows.shape[1])
        assert not bool(o_t)
        np.testing.assert_array_equal(_u32(d_t.numpy()), _u32(d_j))
        # lossless up to the flush: normals (and the NaN) come back exactly
        keep = ~(np.abs(rows) < TINY)
        np.testing.assert_array_equal(_u32(d_t.numpy()[keep]),
                                      _u32(rows[keep]))


class TestStochastic:
    """Their own ``torch.Generator`` stream: exact structural facts plus
    CLT checks at six standard deviations over ``T`` seeded trials."""
    T = 2000

    def test_randk_keeps_k_scaled(self):
        g = torch.Generator().manual_seed(0)
        u = torch.from_numpy(np.random.default_rng(6).normal(size=64)
                             .astype(np.float32))
        cr = 0.25
        k = comp_t.k_for_ratio(64, cr)
        hits = np.zeros(64)
        for _ in range(self.T):
            c = comp_t.randk_compress(u, cr, g)
            m = c.mask.numpy()
            assert m.sum() == k
            np.testing.assert_array_equal(
                c.values.numpy()[m], (u * (64 / k)).numpy()[m])
            assert not c.values.numpy()[~m].any()
            hits += m
        p = k / 64
        sigma = np.sqrt(self.T * p * (1 - p))
        assert np.abs(hits - self.T * p).max() <= 6 * sigma

    @pytest.mark.parametrize("bits", [2, 4, 8])
    def test_quantize_stochastic_unbiased(self, bits):
        g = torch.Generator().manual_seed(1)
        u = torch.from_numpy(np.random.default_rng(7).normal(size=128)
                             .astype(np.float32))
        levels = 2 ** (bits - 1) - 1
        scale = float(u.abs().max()) / levels
        total = np.zeros(128, np.float64)
        for _ in range(self.T):
            q = comp_t.quantize_stochastic(u, bits, g).numpy()
            grid = q / np.float32(scale)
            assert np.abs(grid - np.round(grid)).max() < 1e-3
            assert np.abs(np.round(grid)).max() <= levels
            total += q
        # each draw lies within one grid step of u: variance <= scale^2/4
        err = np.abs(total / self.T - u.numpy())
        assert err.max() <= 6 * (scale / 2) / np.sqrt(self.T)
