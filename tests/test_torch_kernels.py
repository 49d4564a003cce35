"""Port parity, kernel layer: the plain twins of the two Hopper kernels
(``repro_torch.kernels``) against the Pallas kernels run in interpret mode.

Thresholds, absmax, masks, overlap counts and ``residual'`` are held bit
for bit; agg to the reordering bound of the client sum (the twin adds the
clients in order 0..C-1, the Pallas kernel through a dot_general). The
Hopper kernels themselves run only on the card: tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import opwa as opwa_j
from repro.core.strategies import quantization_scale as quantization_scale_j
from repro.core.strategies import \
    symmetric_dequantize as symmetric_dequantize_j
from repro.kernels import ops as ops_j
from repro.kernels import ref as ref_j
from repro.kernels.fused_merge import fused_merge_pallas
from repro.kernels.threshold_find import threshold_find_pallas
from repro_torch.core.strategies import CODEC_LEVELS
from repro_torch.kernels import fused_merge as fm
from repro_torch.kernels import ops as ops_t
from repro_torch.kernels import threshold_find as tf

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _u32(a):
    return np.asarray(a).view(np.uint32)


def _case(c, n, seed):
    """Updates with an all-zero row, ties, a denormal row, a huge row; ks
    from 1 to n; merge weights; an ``active`` column with padded slots."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(c, n)).astype(np.float32)
    e = (0.3 * rng.normal(size=(c, n))).astype(np.float32)
    u[0] = 0.0
    e[0] = 0.0
    u[1, : n // 2] = u[1, 0]
    u[2] *= np.float32(1e-40)
    u[3] *= np.float32(1e30)
    ks = rng.integers(1, n + 1, c).astype(np.int32)
    ks[1], ks[-1] = n, 1
    w = rng.uniform(0.1, 1.0, c).astype(np.float32)
    w /= w.sum()
    active = np.ones(c, np.float32)
    active[-2:] = 0.0
    return u, e, ks, w, active


def _assert_agg(got, want, w, vals, gamma):
    """|d| <= 2*C*2^-24*gamma*sum_c |w_c v_c|: the same f32 products summed
    in two orders (client loop vs XLA dot_general)."""
    terms = np.abs(w[:, None].astype(np.float64) * np.asarray(vals, np.float64))
    bound = 2 * len(w) * 2.0 ** -24 * gamma * terms.sum(0)
    diff = np.abs(np.asarray(got, np.float64).ravel()
                  - np.asarray(want, np.float64).ravel())
    assert (diff <= bound).all(), float((diff - bound).max())


# ------------------------------------------------------------ threshold_find
class TestThresholdFindTwin:
    @pytest.mark.parametrize("c,n", [(6, 512), (5, 512 * 3)])
    @pytest.mark.parametrize("ef", [False, True])
    def test_vs_pallas(self, c, n, ef):
        u, e, ks, _, _ = _case(c, n, c * 1000 + n)
        ee = e if ef else None
        th_j, am_j = threshold_find_pallas(
            jnp.asarray(u), jnp.asarray(ks).reshape(c, 1),
            None if ee is None else jnp.asarray(ee), emit_scale=True,
            interpret=True)
        th_t, am_t = tf.threshold_find(_t(u), _t(ks),
                                       None if ee is None else _t(ee),
                                       emit_scale=True)
        np.testing.assert_array_equal(th_t.numpy().astype(np.int64),
                                      np.asarray(th_j)[:, 0].astype(np.int64))
        # absmax: bit for bit on rows of normal numbers; the denormal row's
        # max is flushed to 0 by XLA on the CPU and kept by PyTorch, and the
        # codec scale of either is 0 (see test_torch_core)
        normal = np.ones(c, bool)
        normal[2] = ef
        np.testing.assert_array_equal(_u32(am_t.numpy())[normal],
                                      _u32(np.asarray(am_j)[:, 0])[normal])
        np.testing.assert_array_equal(
            _u32(quantization_scale_j(jnp.asarray(am_j)[:, 0], 127.0)),
            _u32(ops_t.quantization_scale(am_t, 127.0).numpy()))

    @pytest.mark.parametrize("k", [1, 2, 511, 512])
    def test_k_edges(self, k):
        u, _, _, _, _ = _case(4, 512, k)
        ks = np.full(4, k, np.int32)
        th_j = threshold_find_pallas(jnp.asarray(u),
                                     jnp.asarray(ks).reshape(4, 1),
                                     interpret=True)
        th_t = tf.threshold_find(_t(u), _t(ks))
        np.testing.assert_array_equal(th_t.numpy(), np.asarray(th_j)[:, 0])

    @pytest.mark.parametrize("n", [7, 1001])
    def test_ragged_widths(self, n):
        """Widths that are no multiple of any tile: the JAX wrapper pads
        with zeros, the twin (like the Hopper kernel) masks the edge."""
        u, e, ks, _, _ = _case(5, n, n)
        for ee in (None, e):
            th_j = ops_j.topk_thresholds(
                jnp.asarray(u), jnp.asarray(ks),
                residuals=None if ee is None else jnp.asarray(ee))
            th_t = ops_t.topk_thresholds(_t(u), _t(ks),
                                         None if ee is None else _t(ee))
            np.testing.assert_array_equal(th_t.numpy(), np.asarray(th_j))


# ------------------------------------------------------------ fused_merge
VARIANTS = [(ef, opwa, act, codec)
            for ef in (False, True) for opwa in (False, True)
            for act in (False, True)
            for codec in (("none", "int8", "int4") if ef else ("none",))]


def _merge_both(u, e, ks, w, active, ef, opwa, act, codec):
    c, n = u.shape
    ee = e if ef else None
    th = np.asarray(ops_j.topk_thresholds(
        jnp.asarray(u), jnp.asarray(ks),
        residuals=None if ee is None else jnp.asarray(ee))).reshape(c, 1)
    corrected = (e + u) if ef else u
    absmax = np.abs(corrected).max(axis=1)
    sc = (np.asarray(quantization_scale_j(jnp.asarray(absmax),
                                          CODEC_LEVELS[codec]))
          if codec != "none" else None)
    kw = dict(opwa=opwa, gamma=5.0, d=1, codec=codec)
    out_j = fused_merge_pallas(
        jnp.asarray(u), jnp.asarray(th), jnp.asarray(w).reshape(c, 1),
        None if ee is None else jnp.asarray(ee),
        jnp.asarray(active).reshape(c, 1) if act else None,
        scales=None if sc is None else jnp.asarray(sc).reshape(c, 1),
        interpret=True, **kw)
    out_t = fm.fused_merge(
        _t(u), _t(th[:, 0].astype(np.int32)), _t(w),
        None if ee is None else _t(ee), _t(active) if act else None,
        scales=None if sc is None else _t(sc), **kw)
    return th, out_j, out_t


class TestFusedMergeTwin:
    @pytest.mark.parametrize("ef,opwa,act,codec", VARIANTS)
    def test_vs_pallas(self, ef, opwa, act, codec):
        u, e, ks, w, active = _case(6, 1024, 17)
        th, out_j, out_t = _merge_both(u, e, ks, w, active, ef, opwa, act,
                                       codec)
        agg_j, agg_t = (out_j, out_t) if not ef else (out_j[0], out_t[0])
        if ef:
            np.testing.assert_array_equal(_u32(out_t[1].numpy()),
                                          _u32(np.asarray(out_j[1])))
        # masks and counts: the twin's selection against the reference's
        # own threshold oracle and overlap counts
        corrected = (e + u) if ef else u
        th_ref = np.asarray(ref_j.threshold_find_ref(
            jnp.asarray(u), jnp.asarray(ks), jnp.asarray(e) if ef else None))
        ref_mask = _u32(np.abs(corrected)) >= th_ref
        ref_gated = ref_mask & (active[:, None] > 0.5) if act else ref_mask
        _, mask, gated, counts = fm.merge_masks(
            _t(u), _t(th[:, 0].astype(np.int32)), _t(e) if ef else None,
            _t(active) if act else None)
        np.testing.assert_array_equal(mask.numpy(), ref_mask)
        np.testing.assert_array_equal(gated.numpy(), ref_gated)
        np.testing.assert_array_equal(
            counts.numpy(), np.asarray(opwa_j.overlap_counts(
                jnp.asarray(ref_gated))))
        sent = np.where(ref_mask, corrected, np.float32(0.0))
        if codec != "none":
            sc = quantization_scale_j(jnp.max(jnp.abs(jnp.asarray(corrected)),
                                              axis=1, keepdims=True),
                                      CODEC_LEVELS[codec])
            sent = np.asarray(symmetric_dequantize_j(
                jnp.asarray(sent), sc, CODEC_LEVELS[codec]))
        if act:
            sent = sent * active[:, None]
        _assert_agg(agg_t.numpy(), agg_j, w, sent, 5.0 if opwa else 1.0)

    @pytest.mark.parametrize("n", [1001, 4094])
    def test_ragged_and_even_widths(self, n):
        """residual' bit for bit at odd ragged and even widths, EF + int8 +
        OPWA + active padding (the JAX wrapper pads, the twin masks)."""
        u, e, ks, w, active = _case(5, n, n)
        agg_j, res_j = ops_j.megakernel_aggregate(
            jnp.asarray(u), jnp.asarray(ks), jnp.asarray(w),
            residuals=jnp.asarray(e), active=jnp.asarray(active > 0.5),
            opwa=True, gamma=5.0, d=1, codec="int8")
        agg_t, res_t = ops_t.megakernel_aggregate(
            _t(u), _t(ks), _t(w), residuals=_t(e), active=_t(active > 0.5),
            opwa=True, gamma=5.0, d=1, codec="int8")
        np.testing.assert_array_equal(_u32(res_t.numpy()),
                                      _u32(np.asarray(res_j)))
        corrected = e + u
        th = np.asarray(ops_j.topk_thresholds(
            jnp.asarray(u), jnp.asarray(ks), residuals=jnp.asarray(e)))
        sent = np.where(_u32(np.abs(corrected)) >= th[:, None], corrected,
                        0.0) * active[:, None]
        _assert_agg(agg_t.numpy(), agg_j, w, sent, 5.0)

    def test_codec_needs_ef(self):
        u, _, ks, w, _ = _case(4, 64, 1)
        th = tf.threshold_find(_t(u), _t(ks))
        with pytest.raises(ValueError, match="EF"):
            fm.fused_merge(_t(u), th, _t(w), codec="int8",
                           scales=torch.ones(4))


# ------------------------------------------------------------ dispatch
class TestDispatch:
    def test_cpu_tensors_take_the_twin(self):
        u, e, ks, w, _ = _case(4, 256, 2)
        before = (tf.threshold_find.launches, fm.fused_merge.launches)
        agg, res = ops_t.megakernel_aggregate(_t(u), _t(ks), _t(w),
                                              residuals=_t(e))
        assert agg.shape == (256,) and res.shape == (4, 256)
        assert (tf.threshold_find.launches, fm.fused_merge.launches) == before

    def test_cuda_entry_points_refuse_cpu_tensors(self):
        u, _, ks, w, _ = _case(4, 256, 3)
        with pytest.raises(ValueError, match="CUDA"):
            tf.threshold_find_cuda(_t(u), _t(ks))
        with pytest.raises(ValueError, match="CUDA"):
            fm.fused_merge_cuda(_t(u), _t(ks), _t(w))
