"""Port parity, the block Top-K route: the plain twins of the three Hopper
kernels of that route (``block_topk``, ``ef_update``, ``overlap_combine``)
against the Pallas kernels in interpret mode, and the port's plain block
compressors and eager aggregation against the reference's plain routes.

Tolerances and why: the twins run the kernels' op sequences (the same 40 f32
bisection steps, denormals flushed as the reference's platforms flush them),
so values, masks, ``send`` and ``residual'`` are held bit for bit, on edge
rows too (zeros, ties, a huge row, NaN, inf, a 1e-15-under-1.0 row, a
denormal row, a row whose bisection passes through denormal mids, k = 1 and
k = block). Masks, values and residuals of the plain compressors are bit
for bit as well. Sums over clients add the same f32 terms in another order
than XLA, so they are held to ``2*K*2^-24*gamma*sum_k|c_k v_k|`` per
element.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as agg_j
from repro.core import compression as comp_j
from repro.core import cost_model as cm_j
from repro.core import opwa as opwa_j
from repro.kernels import ops as ops_j
from repro.kernels.block_topk import block_topk_pallas
from repro.kernels.ef_update import ef_update_pallas
from repro.kernels.overlap_combine import TILE_N, overlap_combine_pallas
from repro_torch.core import aggregation as agg_t
from repro_torch.core import compression as comp_t
from repro_torch.core import cost_model as cm_t
from repro_torch.kernels import block_topk as bt
from repro_torch.kernels import ef_update as eu
from repro_torch.kernels import ops as ops_t
from repro_torch.kernels import overlap_combine as oc

torch.set_num_threads(1)

BUILTINS = ("fedavg", "topk", "eftopk", "bcrs", "bcrs_opwa", "qtopk",
            "bitmask_topk", "int4")
COMPRESSING = BUILTINS[1:]              # fedavg sends dense updates


def _t(a):
    return torch.from_numpy(np.array(a))


def _u32(a):
    return np.asarray(a).view(np.uint32)


def _assert_bits(got, want):
    np.testing.assert_array_equal(_u32(np.asarray(got, np.float32)),
                                  _u32(np.asarray(want, np.float32)))


def _assert_sum_close(got, want, coeffs, vals, gamma):
    """|d| <= 2*K*2^-24*gamma*sum_k |c_k v_k| per element: the same f32
    products summed in two orders (client loop vs XLA's reduction)."""
    terms = np.abs(np.asarray(coeffs, np.float64)[:, None]
                   * np.asarray(vals, np.float64))
    bound = 2 * terms.shape[0] * 2.0 ** -24 * gamma * terms.sum(0)
    diff = np.abs(np.asarray(got, np.float64).ravel()
                  - np.asarray(want, np.float64).ravel())
    assert (diff <= bound).all(), float((diff - bound).max())


def _edge_rows(block, seed):
    """8 rows of ``block`` f32 that separate a value bisection from exact
    Top-K and stress denormal flushing."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(8, block)).astype(np.float32)
    x[0] = 0.0                                   # all zeros
    x[1, : block // 2] = x[1, 0]                 # ties
    x[2] *= np.float32(1e30)                     # huge
    x[3, 5] = np.nan                             # NaN: rowmax NaN
    x[4, 7] = np.inf                             # inf
    x[5] = 0.0                                   # k-th below rowmax*2^-40
    x[5, 0], x[5, 1:21] = 1.0, 1e-15
    x[6] *= np.float32(1e-40)                    # all denormal
    x[7] = 0.0                                   # mids fall to denormals
    x[7, :20] = 2e-38
    return x


def _random_rows(nb, block, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(nb, block)).astype(np.float32)
    x[0, : block // 3] *= np.float32(1e-40)      # mixed normal / denormal
    x[1] = np.clip(x[1], -3, 3) * np.float32(1e38)   # lo + hi overflows
    return x


ROWS = [("edges", 256), ("edges", 512), ("random", 256), ("random", 512)]


def _rows(kind, block):
    return (_edge_rows(block, block) if kind == "edges"
            else _random_rows(8, block, block + 1))


# ------------------------------------------------------------ block_topk
class TestBlockTopkTwin:
    @pytest.mark.parametrize("kind,block", ROWS)
    @pytest.mark.parametrize("kfrac", [0.0, 0.1, 0.5, 1.0])
    def test_vs_pallas(self, kind, block, kfrac):
        x = _rows(kind, block)
        k = max(1, round(kfrac * block))          # k = 1 ... k = block
        vj, mj = block_topk_pallas(jnp.asarray(x), k, interpret=True)
        vt, mt = bt.block_topk(_t(x), k)
        assert vt.dtype == torch.float32 and mt.dtype == torch.int8
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
        _assert_bits(vt.numpy(), vj)

    def test_edge_rows_keep_the_kernels_counts(self):
        """The value bisection, not exact Top-K: at k = 10 of 256 a NaN row
        keeps its 255 non-NaN entries, an inf row and a row whose k-th
        magnitude is below rowmax*2^-40 keep everything, zeros included."""
        _, mt = bt.block_topk(_t(_edge_rows(256, 0)), 10)
        kept = mt.numpy().sum(axis=1)
        assert kept[3] == 255 and kept[4] == 256 and kept[5] == 256
        assert kept[0] == 256 and kept[6] == 256 and kept[7] == 256

    @pytest.mark.parametrize("n,block,cr", [(1001, 256, 0.1),
                                            (5000, 512, 0.05),
                                            (300, 256, 1.0)])
    def test_ragged_flat_through_ops(self, n, block, cr):
        """A flat n that is no block multiple: both wrappers zero-pad the
        vector (the JAX one also pads rows to 8, the port does not)."""
        rng = np.random.default_rng(n)
        u = rng.normal(size=n).astype(np.float32)
        u[:7] = 0.0
        cj = ops_j.block_topk(jnp.asarray(u), cr, block=block)
        ct = ops_t.block_topk(_t(u), cr, block=block)
        np.testing.assert_array_equal(ct.mask.numpy(), np.asarray(cj.mask))
        _assert_bits(ct.values.numpy(), cj.values)

    def test_cuda_entry_point_refuses_cpu_tensors(self):
        with pytest.raises(ValueError, match="CUDA"):
            bt.block_topk_cuda(torch.ones(2, 256), 3)

    def test_cpu_tensors_take_the_twin(self):
        before = bt.block_topk.launches
        ops_t.block_topk(torch.ones(1000), 0.1, block=256)
        assert bt.block_topk.launches == before


# ------------------------------------------------------------- ef_update
class TestEfUpdateTwin:
    @pytest.mark.parametrize("kind,block", ROWS)
    @pytest.mark.parametrize("kfrac", [0.0, 0.1, 1.0])
    def test_vs_pallas(self, kind, block, kfrac):
        g = _rows(kind, block)
        rng = np.random.default_rng(block)
        e = (0.3 * rng.normal(size=g.shape)).astype(np.float32)
        e[0] = -g[0]                                # exact cancellation
        e[6] = 0.0                                  # denormal g, zero e
        e[7, :20] = -1.5e-38                        # normal sum -> denormal
        e[2, :10] = np.float32(1e-40)               # denormal e, huge g
        k = max(1, round(kfrac * block))
        sj, rj = ef_update_pallas(jnp.asarray(g), jnp.asarray(e), k,
                                  interpret=True)
        st, rt = eu.ef_update(_t(g), _t(e), k)
        _assert_bits(st.numpy(), sj)
        _assert_bits(rt.numpy(), rj)

    @pytest.mark.parametrize("n,block,cr", [(1001, 256, 0.1),
                                            (2048, 512, 0.05)])
    def test_ragged_flat_through_ops(self, n, block, cr):
        rng = np.random.default_rng(n)
        g = rng.normal(size=n).astype(np.float32)
        e = (0.5 * rng.normal(size=n)).astype(np.float32)
        sj, rj = ops_j.ef_topk_update(jnp.asarray(g), jnp.asarray(e), cr,
                                      block=block)
        st, rt = ops_t.ef_topk_update(_t(g), _t(e), cr, block=block)
        assert st.shape == (n,) and rt.shape == (n,)
        _assert_bits(st.numpy(), sj)
        _assert_bits(rt.numpy(), rj)

    def test_cuda_entry_point_refuses_cpu_tensors(self):
        with pytest.raises(ValueError, match="CUDA"):
            eu.ef_update_cuda(torch.ones(2, 256), torch.ones(2, 256), 3)


# ------------------------------------------------------- overlap_combine
def _combine_case(k, n, seed):
    rng = np.random.default_rng(seed)
    density = rng.uniform(0.05, 0.6, size=(k, 1))
    masks = (rng.uniform(size=(k, n)) < density).astype(np.int8)
    vals = (rng.normal(size=(k, n)) * masks).astype(np.float32)
    vals[0, :3] = -0.0                             # signed zeros
    coeffs = rng.uniform(0.05, 1.0, size=k).astype(np.float32)
    return vals, masks, coeffs


class TestOverlapCombineTwin:
    @pytest.mark.parametrize("k", [3, 5, 8])
    @pytest.mark.parametrize("n", [TILE_N, 1001, 3 * TILE_N + 17])
    @pytest.mark.parametrize("gamma", [1.0, 5.0])
    @pytest.mark.parametrize("d", [1, 2])
    def test_vs_pallas(self, k, n, gamma, d):
        vals, masks, coeffs = _combine_case(k, n, k * n)
        pad = (-n) % TILE_N
        out_j = overlap_combine_pallas(
            jnp.asarray(np.pad(vals, ((0, 0), (0, pad)))),
            jnp.asarray(np.pad(masks, ((0, 0), (0, pad)))),
            jnp.asarray(coeffs), gamma, d, interpret=True)[0, :n]
        out_t = oc.overlap_combine(_t(vals), _t(masks), _t(coeffs), gamma, d)
        _assert_sum_close(out_t.numpy(), out_j, coeffs, vals, gamma)
        # the overlap counts exactly: the enlarged columns are those of the
        # reference's counts, and the sum is the gamma = 1 sum scaled there
        counts = np.asarray(opwa_j.overlap_counts(jnp.asarray(masks)))
        amplify = (counts > 0) & (counts <= d)
        base = oc.overlap_combine(_t(vals), _t(masks), _t(coeffs), 1.0, d)
        want = np.where(amplify, np.float32(gamma),
                        np.float32(1.0)) * base.numpy()
        _assert_bits(out_t.numpy(), want)

    def test_ops_takes_bool_masks(self):
        vals, masks, coeffs = _combine_case(4, 999, 3)
        out_j = ops_j.overlap_combine(jnp.asarray(vals),
                                      jnp.asarray(masks > 0),
                                      jnp.asarray(coeffs), 5.0, 1)
        out_t = ops_t.overlap_combine(_t(vals), _t(masks > 0), _t(coeffs),
                                      5.0, 1)
        _assert_sum_close(out_t.numpy(), out_j, coeffs, vals, 5.0)

    def test_cuda_entry_point_refuses_cpu_tensors(self):
        with pytest.raises(ValueError, match="CUDA"):
            oc.overlap_combine_cuda(torch.ones(2, 8),
                                    torch.ones(2, 8, dtype=torch.int8),
                                    torch.ones(2), 5.0, 1)


# ------------------------------------------------ plain block compressors
class TestPlainCompressors:
    @pytest.mark.parametrize("block", [256, 2048, 8192])
    @pytest.mark.parametrize("cr", [0.01, 0.1, 1.0])
    def test_block_topk_compress(self, block, cr):
        rng = np.random.default_rng(block)
        u = rng.normal(size=10_001).astype(np.float32)
        u[100:400] = u[100]                          # ties
        cj = comp_j.block_topk_compress(jnp.asarray(u), cr, block=block,
                                        use_kernel=False)
        ct = comp_t.block_topk_compress(_t(u), cr, block=block,
                                        use_kernel=False)
        np.testing.assert_array_equal(ct.mask.numpy(), np.asarray(cj.mask))
        _assert_bits(ct.values.numpy(), cj.values)

    def test_block_topk_compress_edge_rows(self):
        """The exact route on the edge rows: a NaN counts as the largest
        and is never kept, an all-denormal block keeps everything."""
        u = _edge_rows(256, 1).reshape(-1)
        cj = comp_j.block_topk_compress(jnp.asarray(u), 10 / 256, block=256,
                                        use_kernel=False)
        ct = comp_t.block_topk_compress(_t(u), 10 / 256, block=256,
                                        use_kernel=False)
        np.testing.assert_array_equal(ct.mask.numpy(), np.asarray(cj.mask))
        _assert_bits(ct.values.numpy(), cj.values)
        kept = ct.mask.numpy().reshape(8, 256).sum(axis=1)
        assert kept[3] == 9 and kept[4] == 10 and kept[6] == 256

    @pytest.mark.parametrize("block", [256, 2048, 8192])
    def test_block_topk_compress_batch(self, block):
        rng = np.random.default_rng(block + 5)
        u = rng.normal(size=(4, 9001)).astype(np.float32)
        u[0] = 0.0
        ks = np.array([1, max(1, block // 10), block // 2, block], np.int32)
        cj = comp_j.block_topk_compress_batch(jnp.asarray(u),
                                              jnp.asarray(ks), block=block)
        ct = comp_t.block_topk_compress_batch(_t(u), _t(ks), block=block)
        np.testing.assert_array_equal(ct.mask.numpy(), np.asarray(cj.mask))
        _assert_bits(ct.values.numpy(), cj.values)

    @pytest.mark.parametrize("cr", [0.001, 0.1, 1.0])
    def test_topk_and_ef_compress(self, cr):
        rng = np.random.default_rng(7)
        u = rng.normal(size=5000).astype(np.float32)
        r = (0.3 * rng.normal(size=5000)).astype(np.float32)
        cj = comp_j.topk_compress(jnp.asarray(u), cr)
        ct = comp_t.topk_compress(_t(u), cr)
        np.testing.assert_array_equal(ct.mask.numpy(), np.asarray(cj.mask))
        _assert_bits(ct.values.numpy(), cj.values)
        (ej, rj), (et, rt) = (comp_j.ef_compress(jnp.asarray(r),
                                                 jnp.asarray(u), cr),
                              comp_t.ef_compress(_t(r), _t(u), cr))
        np.testing.assert_array_equal(et.mask.numpy(), np.asarray(ej.mask))
        _assert_bits(et.values.numpy(), ej.values)
        _assert_bits(rt.numpy(), rj)

    def test_ks_for_schedule_block_base(self):
        crs = np.array([0.013, 0.1, 0.5, 1.0])
        for blk in (False, True):
            kw = dict(strategy="bcrs", block_topk=blk, block_size=2048)
            np.testing.assert_array_equal(
                agg_t.ks_for_schedule(9001, crs, agg_t.AggregationConfig(
                    **kw)),
                agg_j.ks_for_schedule(9001, crs, agg_j.AggregationConfig(
                    **kw)))


# --------------------------------------------- client compression + merge
@pytest.fixture(scope="module")
def client_updates():
    rng = np.random.default_rng(11)
    c, n = 5, 9001
    u = rng.normal(size=(c, n)).astype(np.float32)
    u[1] *= np.float32(1e-3)
    r = (0.3 * rng.normal(size=(c, n))).astype(np.float32)
    fracs = rng.uniform(0.5, 1.5, size=c)
    fracs /= fracs.sum()
    return u, r, fracs


def _links(c):
    return (cm_j.sample_links(c, np.random.default_rng(3)),
            cm_t.sample_links(c, np.random.default_rng(3)))


def _acfgs(strategy, block):
    kw = dict(strategy=strategy, block_topk=True, block_size=block,
              use_kernel=False)
    return agg_j.AggregationConfig(**kw), agg_t.AggregationConfig(**kw)


class TestClientCompression:
    @pytest.mark.parametrize("use_loop", [False, True])
    @pytest.mark.parametrize("block", [256, 2048, 8192])
    @pytest.mark.parametrize("strategy", COMPRESSING)
    def test_compress_clients(self, client_updates, strategy, block,
                              use_loop):
        u, r, _ = client_updates
        aj, at = _acfgs(strategy, block)
        crs = np.array([0.01, 0.05, 0.1, 0.3, 1.0])
        res = r if aj.strat.needs_residuals else None
        fj = agg_j.compress_clients_loop if use_loop else \
            agg_j.compress_clients
        ft = agg_t.compress_clients_loop if use_loop else \
            agg_t.compress_clients
        vj, mj, nj = fj(jnp.asarray(u), crs, aj,
                        None if res is None else jnp.asarray(res))
        vt, mt, nt = ft(_t(u), crs, at, None if res is None else _t(res))
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
        _assert_bits(vt.numpy(), vj)
        if res is None:
            assert nj is None and nt is None
        else:
            _assert_bits(nt.numpy(), nj)

    @pytest.mark.parametrize("use_loop", [False, True])
    @pytest.mark.parametrize("block", [256, 2048, 8192])
    @pytest.mark.parametrize("strategy", BUILTINS)
    def test_aggregate(self, client_updates, strategy, block, use_loop):
        u, r, fracs = client_updates
        aj, at = _acfgs(strategy, block)
        lj, lt = _links(len(fracs))
        v_bytes = float(u.shape[1] * 4)
        res = r if aj.strat.needs_residuals else None
        agg_jx, info_j, nj = agg_j.aggregate(
            jnp.asarray(u), fracs, aj, links=lj, v_bytes=v_bytes,
            residuals=None if res is None else jnp.asarray(res),
            use_loop=use_loop)
        agg_tt, info_t, nt = agg_t.aggregate(
            _t(u), fracs, at, links=lt, v_bytes=v_bytes,
            residuals=None if res is None else _t(res), use_loop=use_loop)
        assert set(info_t) == set(info_j)
        if "crs" in info_j:
            np.testing.assert_array_equal(info_t["crs"], info_j["crs"])
        if res is not None:
            _assert_bits(nt.numpy(), nj)
        _, weights, _ = agg_j.round_schedule(aj, len(fracs), fracs, lj,
                                             v_bytes)
        if aj.strat.compresses:
            vals = np.asarray(agg_j.compress_clients_loop(
                jnp.asarray(u), info_j.get("crs", np.ones(len(fracs))), aj,
                None if res is None else jnp.asarray(res))[0])
        else:
            vals = u
        gamma = aj.gamma if aj.strat.overlap_weighted else 1.0
        _assert_sum_close(agg_tt.numpy(), agg_jx,
                          np.asarray(weights, np.float32), vals, gamma)

    def test_kernel_route_on_cpu_raises(self, client_updates):
        u, _, _ = client_updates
        acfg = agg_t.AggregationConfig(strategy="topk", block_topk=True,
                                       block_size=256, use_kernel=True)
        with pytest.raises(ValueError, match="CUDA"):
            agg_t.compress_clients_loop(_t(u), np.full(5, 0.1), acfg)
