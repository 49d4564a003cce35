"""Port parity, flash attention: the plain twin of the Hopper kernel
(``kernels/flash_attention.flash_attention_plain``) and the model-layout
entry point ``kernels/ops.flash_attention`` against the Pallas kernel
(interpret mode: ``flash_attention_pallas`` directly and through the
reference's ``ops.flash_attention``) and the one-shot
``ref.flash_attention_ref``, on the CPU, at the shapes of the reference's
own flash tests. The kernel itself runs only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances and why. The twin runs the Pallas kernel's op sequence (q scaled
before the dot product, -1e30 mask, blockwise online softmax,
``acc / max(l, 1e-30)``); XLA and PyTorch sum the two block products in
other orders, a relative error of order sqrt(n) * 2^-24 for n <= 384
terms, ~1e-7 at outputs of scale ~1:
  * f32: the reference's own ``atol = rtol = 2e-6``
    (``tests/test_kernels.py``);
  * bf16: each side rounds its own f32 result once, so one bf16 ULP of the
    larger magnitude, plus the f32 ``2e-6`` for outputs near zero, where the
    f32 difference exceeds a bf16 ULP of the value;
  * the entry point against the model's chunked ``attend``: the reference's
    ``1e-5`` (``test_matches_model_attend``), and block shapes against each
    other ``1e-5`` (``test_block_shape_invariance``);
  * the f32 kernel's stated bound ``f32_twin_bound`` (derived in
    ``csrc/flash_attention.cu``, computed per element in f64 from the
    inputs): the twin against an f64 numpy sum and against the Pallas
    kernel within it (plus one bf16 ULP of the larger in bf16), and a twin
    with one key tile of 64 left out outside it.
"""
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ops_j
from repro.kernels import ref as ref_j
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models.attention import attend as attend_j
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as ops_t
from repro_torch.models.attention import attend as attend_t

torch.set_num_threads(1)

DTYPES = [jnp.float32, jnp.bfloat16]
TORCH_DTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
F32_TOL = 2e-6


def _qkv(seed, shape_q, shape_kv=None, dtype=jnp.float32):
    """numpy normals rounded to ``dtype``, as (jax, torch) pairs."""
    rng = np.random.default_rng(seed)
    shape_kv = shape_kv or shape_q
    out = []
    for shape in (shape_q, shape_kv, shape_kv):
        a = jnp.asarray(rng.normal(size=shape).astype(np.float32), dtype)
        t = torch.from_numpy(np.array(a.astype(jnp.float32))).to(
            TORCH_DTYPE[dtype])
        out.append((a, t))
    return out


def _close(got, want):
    """f32: atol = rtol = 2e-6; bf16: one bf16 ULP of the larger magnitude
    plus 2e-6."""
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    assert g.shape == w.shape
    if got.dtype == torch.float32:
        np.testing.assert_allclose(g, w, atol=F32_TOL, rtol=F32_TOL)
        return
    mag = np.maximum(np.maximum(np.abs(g), np.abs(w)), 2.0 ** -126)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    d = np.abs(g - w)
    assert (d <= ulp + F32_TOL).all(), float(np.max(d / (ulp + F32_TOL)))


def _flat(x, b, h, s, d):
    return x.transpose(0, 2, 1, 3).reshape(b * h, s, d)


# the reference's TestFlashAttention.test_vs_ref shapes: (b, h, sq, sk, d);
# 100 is the ragged (padded) case, 128 x 384 the top-left causal Sq != Sk
REF_SHAPES = [(2, 3, 128, 128, 64), (1, 2, 256, 256, 32),
              (1, 2, 100, 100, 64), (1, 1, 128, 384, 64)]


@pytest.mark.parametrize("shape", REF_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_entry_point_vs_reference(shape, dtype):
    b, h, sq, sk, d = shape
    (qj, qt), (kj, kt), (vj, vt) = _qkv(0, (b, sq, h, d), (b, sk, h, d),
                                        dtype)
    got = ops_t.flash_attention(qt, kt, vt, causal=True)
    assert got.dtype == TORCH_DTYPE[dtype] and got.shape == (b, sq, h, d)
    # the Pallas kernel (interpret mode) through the reference entry point
    _close(got, ops_j.flash_attention(qj, kj, vj, causal=True))
    # and the one-shot reference, as the reference's own test holds it
    r = ref_j.flash_attention_ref(_flat(qj, b, h, sq, d),
                                  _flat(kj, b, h, sk, d),
                                  _flat(vj, b, h, sk, d), True)
    _close(got, r.reshape(b, h, sq, d).transpose(0, 2, 1, 3))


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_twin_vs_pallas_kernel(causal, dtype):
    """The twin on [BH, S, D] against flash_attention_pallas directly, with
    blocks smaller than S (several online-softmax steps), Sq != Sk and
    D = 128."""
    (qj, qt), (kj, kt), (vj, vt) = _qkv(1, (3, 128, 128), (3, 192, 128),
                                        dtype)
    got = fa.flash_attention_plain(qt, kt, vt, causal=causal, blk_q=64,
                                   blk_k=64)
    want = flash_attention_pallas(qj, kj, vj, causal=causal, blk_q=64,
                                  blk_k=64, interpret=True)
    _close(got, want)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_twin_vs_one_shot_reference(causal, dtype):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(2, (2, 256, 64), dtype=dtype)
    got = fa.flash_attention_plain(qt, kt, vt, causal=causal)
    _close(got, ref_j.flash_attention_ref(qj, kj, vj, causal))


def test_matches_model_attend():
    """Flash entry point == the model's chunked attention path (the port's
    and the reference's)."""
    (qj, qt), (kj, kt), (vj, vt) = _qkv(3, (1, 128, 2, 64))
    f = ops_t.flash_attention(qt, kt, vt, causal=True, blk_q=64, blk_k=64)
    a = attend_t(qt, kt, vt, causal=True, chunk=64)
    np.testing.assert_allclose(a.numpy(), f.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(attend_j(qj, kj, vj, causal=True, chunk=64)), f.numpy(),
        atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("blocks", [(64, 64), (128, 64), (64, 128)])
def test_block_shape_invariance(blocks):
    bq, bk = blocks
    (_, qt), (_, kt), (_, vt) = _qkv(4, (1, 256, 2, 32))
    a = ops_t.flash_attention(qt, kt, vt, blk_q=bq, blk_k=bk)
    b = ops_t.flash_attention(qt, kt, vt, blk_q=128, blk_k=128)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)


def test_ragged_sq_above_sk():
    """Sq > Sk with Sk ragged: query positions >= Sk see the zero-padded
    keys, in the reference and (held to it, not fixed) in the port."""
    (qj, qt), (kj, kt), (vj, vt) = _qkv(5, (1, 200, 2, 32), (1, 100, 2, 32))
    got = ops_t.flash_attention(qt, kt, vt, causal=True)
    _close(got, ops_j.flash_attention(qj, kj, vj, causal=True))
    # a query row at position >= Sk averages in zero values: the output
    # differs from attention over the 100 real keys alone
    real = attend_t(qt[:, 150:151], kt, vt, causal=False)
    assert not torch.allclose(got[:, 150:151], real, atol=1e-3)


def test_non_causal_needs_sk_a_block_multiple():
    (qj, qt), (kj, kt), (vj, vt) = _qkv(6, (1, 64, 1, 16), (1, 100, 1, 16))
    with pytest.raises(AssertionError):
        ops_j.flash_attention(qj, kj, vj, causal=False)
    with pytest.raises(AssertionError):
        ops_t.flash_attention(qt, kt, vt, causal=False)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_non_causal_entry_point(dtype):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(7, (1, 256, 2, 64), dtype=dtype)
    got = ops_t.flash_attention(qt, kt, vt, causal=False)
    _close(got, ops_j.flash_attention(qj, kj, vj, causal=False))


def test_cpu_tensors_take_the_twin_and_count_nothing():
    (_, qt), (_, kt), (_, vt) = _qkv(8, (2, 128, 16))
    before = fa.flash_attention.launches
    got = fa.flash_attention(qt, kt, vt)
    assert fa.flash_attention.launches == before
    assert torch.equal(got, fa.flash_attention_plain(qt, kt, vt))


def test_kernel_wrapper_refuses_cpu_tensors():
    (_, qt), (_, kt), (_, vt) = _qkv(9, (2, 128, 16))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(qt, kt, vt)


def test_kernels_list_names_flash_attention():
    assert "flash_attention" in build.KERNELS
    assert (build.CSRC / "flash_attention.cu").exists()


# ------------------------------------------------ the f32 kernel's bound
def _f64_attention(q, k, v, causal):
    """The function in f64 numpy from the same f32 inputs: q scaled in f32
    (as both f32 evaluations scale it), then an exact softmax, 256 query
    rows at a time."""
    d = q.shape[-1]
    qs = (q.float() * (1.0 / d ** 0.5)).double().numpy()
    kd, vd = k.double().numpy(), v.double().numpy()
    sq, sk = qs.shape[1], kd.shape[1]
    out = np.empty(qs.shape)
    for r0 in range(0, sq, 256):
        s = qs[:, r0:r0 + 256] @ kd.transpose(0, 2, 1)
        if causal:
            rows = np.arange(r0, min(sq, r0 + 256))[:, None]
            s = np.where(rows >= np.arange(sk)[None, :], s, -np.inf)
        w = np.exp(s - s.max(axis=-1, keepdims=True))
        out[:, r0:r0 + 256] = (w @ vd) / w.sum(axis=-1, keepdims=True)
    return out


def _twin_skipping_tile():
    """``chip_smoke.f32_twin_without_key_tile``: the twin with one key tile
    of 64 left out, the fault the card run plants too."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.f32_twin_without_key_tile


def _within(got, want, bound):
    """|got - want| <= bound (f32), + one bf16 ULP of the larger (bf16);
    returns (ok, the largest |d| / limit)."""
    g = got.double()
    w = (want.double() if isinstance(want, torch.Tensor)
         else torch.from_numpy(np.array(want, dtype=np.float64)))
    diff = (g - w).abs()
    limit = bound.clone()
    if got.dtype == torch.bfloat16:
        _, e = torch.frexp(torch.maximum(g.abs(), w.abs()).float())
        limit = limit + torch.pow(2.0, (e - 8).double())
    return bool((diff <= limit).all()), float((diff / limit).max())


def _seeded(seed, shape_q, shape_kv, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dtype)
            for s in (shape_q, shape_kv, shape_kv)]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_twin_within_f32_bound_of_f64_sum(causal, dtype):
    """[2, 4096, 64]: the twin (tiles of 128) against the f64 sum within
    ``f32_twin_bound``: its own error is at most half of it."""
    q, k, v = _seeded(10, (2, 4096, 64), (2, 4096, 64), dtype)
    bound = fa.f32_twin_bound(q, k, v, causal=causal)
    ok, share = _within(fa.flash_attention_plain(q, k, v, causal=causal),
                        _f64_attention(q, k, v, causal), bound)
    assert ok, share


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_dropped_key_tile_fails_f32_bound(causal):
    """A twin that leaves out one key tile of 64 (keys 2048..2111 of 4096)
    lies outside ``f32_twin_bound`` of the f64 sum."""
    q, k, v = _seeded(11, (2, 4096, 64), (2, 4096, 64))
    bound = fa.f32_twin_bound(q, k, v, causal=causal)
    bad = _twin_skipping_tile()(q, k, v, 32, causal)
    ok, share = _within(bad, _f64_attention(q, k, v, causal), bound)
    assert not ok and share > 10, share


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("d", [16, 32, 128])
def test_twin_within_f32_bound_of_pallas(causal, d):
    """The twin (tiles of 128) against the Pallas kernel in interpret mode
    (tiles of 64, as the card kernel's) within ``f32_twin_bound``."""
    q, k, v = _seeded(12 + d, (2, 256, d), (2, 256, d))
    want = flash_attention_pallas(*(jnp.asarray(t.numpy()) for t in
                                     (q, k, v)), causal=causal, blk_q=64,
                                  blk_k=64, interpret=True)
    bound = fa.f32_twin_bound(q, k, v, causal=causal)
    ok, share = _within(fa.flash_attention_plain(q, k, v, causal=causal),
                        np.asarray(want), bound)
    assert ok, share


def test_f32_bound_ragged_tiles():
    """Sq 200 x Sk 300 causal, the twin in one tile of each (blk_k 300, not
    a multiple of 64: the twin's changes and tile starts are bounded
    apart from the kernel's) against the f64 sum."""
    q, k, v = _seeded(13, (3, 200, 32), (3, 300, 32))
    bound = fa.f32_twin_bound(q, k, v, causal=True, blk_k=300)
    got = fa.flash_attention_plain(q, k, v, causal=True, blk_q=200,
                                   blk_k=300)
    ok, share = _within(got, _f64_attention(q, k, v, True), bound)
    assert ok, share
