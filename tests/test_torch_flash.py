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
    other ``1e-5`` (``test_block_shape_invariance``).
"""
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
