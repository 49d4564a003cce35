"""Port parity, the wgmma route of flash attention: its plain twin
(``kernels/flash_attention.flash_attention_wgmma_plain``, bf16 with P
rounded to bf16 before the PV product, as the tensor cores need it) against
the Pallas kernel in interpret mode and against the f32 twin on the upcast
inputs, on the CPU at reduced shapes. The kernel itself runs only on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerance and why: the twin rounds each probability to bf16 where the
reference keeps it in f32, a relative change of at most 2^-8 per weight,
and sums in another order; ``wgmma_twin_and_bound(both_round=False)``
carries that to the output from the twin's own weights
(``csrc/flash_attention_wgmma.cu`` derives it: a convex combination whose
weights move by delta_j moves by at most sum_j w_j delta_j |v_j - o|, plus
the f32 summation terms), and each side rounds its own output to bf16, one
bf16 ULP of the larger magnitude on top. With ``both_round=True`` (the
kernel's side also rounds P) the bound counts only the keys whose bf16
rounding can differ; it must hold for any side that rounds P, here one in
f64, and must reject an output that lacks one key tile.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa

torch.set_num_threads(1)


def _qkv(seed, bh, sq, sk, d):
    """numpy normals rounded to bf16, as (jax, torch) pairs."""
    rng = np.random.default_rng(seed)
    out = []
    for s in (sq, sk, sk):
        a = jnp.asarray(rng.normal(size=(bh, s, d)).astype(np.float32),
                        jnp.bfloat16)
        out.append((a, torch.from_numpy(np.array(a.astype(jnp.float32))).to(
            torch.bfloat16)))
    return out


def _ratio(got, want, bound):
    """The worst ratio of |got - want| to bound + one bf16 ULP of the
    larger magnitude."""
    g, w = got.double(), want.double()
    mag = torch.maximum(g.abs(), w.abs())
    _, e = torch.frexp(mag.clamp_min(2.0 ** -126))
    ulp = torch.pow(2.0, (e - 8).double())
    return float(((g - w).abs() / (bound + ulp)).max())


def _within(got, want, bound):
    ratio = _ratio(got, want, bound)
    assert ratio <= 1.0, ratio
    return ratio


def _f64_side(q, k, v, causal, skip_tile=None):
    """Another output of the wgmma route's arithmetic: scores, softmax and
    sums in f64, P rounded to bf16 per key tile of the kernel's
    (``fa.wgmma_bk(D)``) as the kernel rounds it; with ``skip_tile``, the
    key tile holding key 64 * skip_tile is left out (a faulty kernel)."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    bk = fa.wgmma_bk(d)
    s = (q.double() @ k.double().transpose(1, 2)) / d ** 0.5
    if causal:
        keep = torch.arange(sq)[:, None] >= torch.arange(sk)[None, :]
        s = torch.where(keep, s, -1e30)
    m = torch.full((bh, sq), -1e30, dtype=torch.float64)
    l = torch.zeros((bh, sq), dtype=torch.float64)
    acc = torch.zeros((bh, sq, d), dtype=torch.float64)
    for k0 in range(0, sk, bk):
        if skip_tile is not None and k0 <= 64 * skip_tile < k0 + bk:
            continue
        st = s[:, :, k0:k0 + bk]
        m_new = torch.maximum(m, st.amax(dim=-1))
        p = torch.exp(st - m_new[..., None]).float().to(
            torch.bfloat16).double()
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + p @ v[:, k0:k0 + bk].double()
        m = m_new
    return (acc / l[..., None]).to(torch.bfloat16)


# (bh, sq, sk, d): the serve head dim, yi-9b's, Sq != Sk at the top left,
# several key tiles of 64 and query rows past one tile of 128
SHAPES = [(2, 128, 128, 64), (1, 256, 256, 64), (2, 128, 192, 128),
          (1, 128, 384, 64)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_wgmma_twin_vs_pallas_kernel(shape, causal):
    bh, sq, sk, d = shape
    (qj, qt), (kj, kt), (vj, vt) = _qkv(sum(shape), bh, sq, sk, d)
    got, bound = fa.wgmma_twin_and_bound(qt, kt, vt, causal=causal,
                                         both_round=False)
    assert got.dtype == torch.bfloat16 and got.shape == (bh, sq, d)
    want = flash_attention_pallas(qj, kj, vj, causal=causal, blk_q=128,
                                  blk_k=64, interpret=True)
    want = torch.from_numpy(np.array(jnp.asarray(want, jnp.float32)))
    _within(got.float(), want, bound)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_wgmma_twin_vs_f32_twin(causal):
    """The check ``chip_smoke.py`` makes on the card, here on the CPU: the
    wgmma twin against the f32 twin on the exact upcasts."""
    (_, qt), (_, kt), (_, vt) = _qkv(11, 2, 256, 256, 128)
    got, bound = fa.wgmma_twin_and_bound(qt, kt, vt, causal=causal,
                                         both_round=False)
    want = fa.flash_attention_plain(qt.float(), kt.float(), vt.float(),
                                    causal=causal)
    _within(got.float(), want, bound)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_wgmma_bound_holds_for_another_side_that_rounds_p(shape, causal):
    """The bound the kernel is held to, against a side that rounds P as
    the kernel does but sums exactly: it must hold, flips and all."""
    bh, sq, sk, d = shape
    (_, qt), (_, kt), (_, vt) = _qkv(100 + sum(shape), bh, sq, sk, d)
    twin, bound = fa.wgmma_twin_and_bound(qt, kt, vt, causal=causal)
    assert torch.equal(twin, fa.flash_attention_wgmma_plain(
        qt, kt, vt, causal=causal))
    _within(_f64_side(qt, kt, vt, causal), twin, bound)


@pytest.mark.parametrize("d", [64, 128])
def test_wgmma_bound_rejects_a_dropped_key_tile(d):
    """A kernel that skips one middle key tile (the one holding key 512 of
    1024) fails the check, in the rows past that tile only."""
    (_, qt), (_, kt), (_, vt) = _qkv(200 + d, 1, 1024, 1024, d)
    twin, bound = fa.wgmma_twin_and_bound(qt, kt, vt)
    bad = _f64_side(qt, kt, vt, True, skip_tile=8)
    assert _ratio(bad[:, 576:], twin[:, 576:], bound[:, 576:]) > 4.0
    _within(bad[:, :512], twin[:, :512], bound[:, :512])


def test_wgmma_twin_rounds_p():
    """The twin is not the f32 twin rounded: P's rounding shows."""
    (_, qt), (_, kt), (_, vt) = _qkv(12, 2, 128, 128, 64)
    got = fa.flash_attention_wgmma_plain(qt, kt, vt)
    f32 = fa.flash_attention_plain(qt.float(), kt.float(), vt.float())
    assert not torch.equal(got, f32.to(torch.bfloat16))


def test_cpu_dispatch():
    """CPU tensors: the entry point keeps the reference-order twin for bf16
    too, no launch is counted, and the wgmma kernel's wrapper refuses
    them."""
    (_, qt), (_, kt), (_, vt) = _qkv(13, 2, 128, 128, 64)
    before = (fa.flash_attention.launches,
              fa.flash_attention_wgmma_cuda.launches)
    assert torch.equal(fa.flash_attention(qt, kt, vt),
                       fa.flash_attention_plain(qt, kt, vt))
    assert (fa.flash_attention.launches,
            fa.flash_attention_wgmma_cuda.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_wgmma_cuda(qt, kt, vt)


@pytest.mark.parametrize("dtype,d,sq,sk,want", [
    (torch.bfloat16, 64, 128, 128, True),
    (torch.bfloat16, 128, 256, 192, True),
    (torch.bfloat16, 32, 128, 128, False),      # head dim: present kernel
    (torch.float32, 64, 128, 128, False),       # f32: present kernel
    (torch.bfloat16, 64, 64, 128, False),       # Sq below a query tile
])
def test_routing_rule(dtype, d, sq, sk, want):
    q = torch.zeros(1, sq, d, dtype=dtype)
    k = torch.zeros(1, sk, d, dtype=dtype)
    assert fa.takes_wgmma(q, k) is want


def test_kernels_list_names_the_wgmma_route():
    assert "flash_attention_wgmma" in build.KERNELS
    assert (build.CSRC / "flash_attention_wgmma.cu").exists()
