"""The port's Hopper kernels on the card: each FL kernel bit for bit
against its plain twin, ``flash_attention`` within its summation-order bound
of its twin (plus one bf16 ULP in bf16), the device-based dispatch of the
wrappers, and short ``run_fl`` runs (fused and legacy engines) and a short
reduced-model serve through the kernels' paths.

Every test here carries the ``cuda`` marker and skips without a CUDA card
(the kernels are CUDA C++; there is no interpret mode). This file imports
neither ``jax`` nor ``repro``, so it also runs where only PyTorch is
installed: ``python -m pytest -q tests/test_torch_cuda.py`` on the card.
"""
import math

import pytest
import torch

from repro_torch.core.aggregation import AggregationConfig
from repro_torch.core.strategies import CODEC_LEVELS, quantization_scale
from repro_torch.fed.engine import ClientUpdateSpec, aggregate_updates
from repro_torch.fed.simulation import FLSimConfig, run_fl
from repro_torch.kernels import block_topk as bt
from repro_torch.kernels import ef_update as eu
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_merge as fm
from repro_torch.kernels import ops
from repro_torch.kernels import overlap_combine as oc
from repro_torch.kernels import threshold_find as tf

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper card (the kernels are CUDA C++ "
                    "and have no interpret mode)")
    return torch.device("cuda")


def _case(c, n, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(c, n, device=device, generator=g)
    e = 0.3 * torch.randn(c, n, device=device, generator=g)
    x[0] = 0.0
    x[1, : n // 2] = x[1, 0]
    ks = torch.randint(1, n + 1, (c,), device=device, generator=g,
                       dtype=torch.int32)
    ks[1], ks[-1] = n, 1
    w = torch.rand(c, device=device, generator=g) + 0.1
    active = torch.ones(c, device=device)
    active[-1] = 0.0
    return x, e, ks, w, active


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("c,n", [(5, 136_724), (3, 1001)])
@pytest.mark.parametrize("ef", [False, True])
def test_kernels_bitwise_vs_twins(card, c, n, ef):
    x, e, ks, w, active = _case(c, n, card)
    ee = e if ef else None
    th, am = tf.threshold_find(x, ks, ee, emit_scale=True)
    tp, ap = tf.threshold_find_plain(x, ks, ee, emit_scale=True)
    assert torch.equal(th, tp) and _same_bits(am, ap)
    for opwa in (False, True):
        for act in (None, active):
            for codec in (("none", "int8", "int4") if ef else ("none",)):
                sc = (quantization_scale(am, CODEC_LEVELS[codec])
                      if codec != "none" else None)
                kw = dict(opwa=opwa, gamma=5.0, codec=codec, scales=sc)
                got = fm.fused_merge(x, th, w, ee, act, **kw)
                want = fm.fused_merge_plain(x, th, w, ee, act, **kw)
                pairs = zip(got, want) if ef else [(got, want)]
                assert all(_same_bits(a, b) for a, b in pairs)


def test_wrappers_launch_and_count(card):
    x, e, ks, w, _ = _case(4, 4096, card)
    t0, f0 = tf.threshold_find.launches, fm.fused_merge.launches
    agg, res = ops.megakernel_aggregate(x, ks, w, residuals=e, codec="int8")
    torch.cuda.synchronize()
    assert agg.is_cuda and res.shape == x.shape
    assert (tf.threshold_find.launches, fm.fused_merge.launches) == \
        (t0 + 1, f0 + 1)


def test_auto_routes_cuda_tensors_to_the_kernels(card):
    x, e, ks, w, _ = _case(4, 4096, card)
    spec = ClientUpdateSpec(strategy="eftopk", use_kernel=True)
    f0 = fm.fused_merge.launches
    agg_k, res_k = aggregate_updates(spec, x, w, ks, residuals=e)
    assert fm.fused_merge.launches == f0 + 1
    plain = ClientUpdateSpec(strategy="eftopk", use_kernel=False)
    agg_p, res_p = aggregate_updates(plain, x.cpu(), w.cpu(), ks.cpu(),
                                     residuals=e.cpu())
    assert _same_bits(res_k.cpu(), res_p)
    torch.testing.assert_close(agg_k.cpu(), agg_p, rtol=1e-5, atol=1e-6)


def test_short_run_fl_on_the_card(card):
    t0 = tf.threshold_find.launches
    res = run_fl(FLSimConfig(rounds=2, dim=32, hidden=32, n_classes=5),
                 AggregationConfig(strategy="bcrs_opwa"))
    assert tf.threshold_find.launches == t0 + 2
    assert all(math.isfinite(a) for _, a in res.accuracies)


def _rows(nb, block, device, seed=0):
    """Rows with a zero row, ties, NaN, inf and a denormal row."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(nb, block, device=device, generator=g)
    x[0] = 0.0
    x[1, : block // 2] = x[1, 0]
    x[2, 3] = float("nan")
    x[3, 4] = float("inf")
    x[4] *= 1e-40
    return x


@pytest.mark.parametrize("nb,block", [(17, 8192), (5, 1000), (6, 16384)])
def test_block_kernels_bitwise_vs_twins(card, nb, block):
    x = _rows(nb, block, card)
    e = 0.3 * _rows(nb, block, card, seed=1).nan_to_num(0.0, 0.0, 0.0)
    for k in (1, max(1, block // 10), block):
        v, m = bt.block_topk(x, k)
        pv, pm = bt.block_topk_plain(x, k)
        assert _same_bits(v, pv) and torch.equal(m, pm)
        s, r = eu.ef_update(x, e, k)
        ps, pr = eu.ef_update_plain(x, e, k)
        assert _same_bits(s, ps) and _same_bits(r, pr)


def test_block_kernels_refuse_rows_above_the_limit(card):
    with pytest.raises(ValueError, match="block"):
        bt.block_topk(torch.ones(2, bt.MAX_BLOCK + 1, device=card), 3)


@pytest.mark.parametrize("c,n", [(5, 136_724), (3, 1001)])
def test_overlap_combine_bitwise_vs_twin(card, c, n):
    g = torch.Generator(device=card).manual_seed(c)
    masks = torch.rand(c, n, device=card, generator=g) < 0.3
    vals = torch.randn(c, n, device=card, generator=g) * masks
    coeffs = torch.rand(c, device=card, generator=g) + 0.1
    for gamma, d in ((5.0, 1), (1.0, 2)):
        o0 = oc.overlap_combine.launches
        got = ops.overlap_combine(vals, masks, coeffs, gamma, d)
        assert oc.overlap_combine.launches == o0 + 1
        want = oc.overlap_combine_plain(vals, masks.to(torch.int8), coeffs,
                                        gamma, d)
        assert _same_bits(got, want)


def test_short_legacy_run_fl_on_the_card(card):
    b0, o0 = bt.block_topk.launches, oc.overlap_combine.launches
    res = run_fl(FLSimConfig(rounds=2, dim=32, hidden=32, n_classes=5),
                 AggregationConfig(strategy="bcrs_opwa", block_topk=True),
                 engine="legacy")
    assert bt.block_topk.launches == b0 + 2 * 5     # 5 clients a round
    assert oc.overlap_combine.launches == o0 + 2
    assert all(math.isfinite(a) for _, a in res.accuracies)
    assert all(math.isfinite(v) for v in res.losses)


def _flash_close(got, want, v):
    """Within B = (D + Sk + 8) * 2^-24 * max|v| (the summation-order bound);
    bf16 within B plus one bf16 ULP (each side rounds its own f32 sum)."""
    diff = (got.double() - want.double()).abs()
    bound = (got.shape[-1] + v.shape[1] + 8) * 2.0 ** -24 * \
        float(v.float().abs().max())
    if got.dtype == torch.float32:
        return float(diff.max()) <= bound
    _, e = torch.frexp(torch.maximum(got.float().abs(), want.float().abs()))
    return bool((diff <= torch.pow(2.0, (e - 8).double()) + bound).all())


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_vs_twin(card, d, dtype, causal):
    g = torch.Generator(device=card).manual_seed(d)
    q = torch.randn(3, 256, d, device=card, generator=g).to(dtype)
    k = torch.randn(3, 384, d, device=card, generator=g).to(dtype)
    v = torch.randn(3, 384, d, device=card, generator=g).to(dtype)
    f0 = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=causal)
    assert fa.flash_attention.launches == f0 + 1
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and _flash_close(got, want, v)
    if dtype == torch.bfloat16:       # the f32 arithmetic on exact upcasts
        up = fa.flash_attention(q.float(), k.float(), v.float(),
                                causal=causal)
        assert torch.equal(got, up.to(torch.bfloat16))


def test_flash_entry_point_ragged_and_gqa(card):
    g = torch.Generator(device=card).manual_seed(0)
    q = torch.randn(2, 1000, 8, 64, device=card, generator=g)
    kv = torch.randn(2, 2, 1000, 2, 64, device=card, generator=g)
    k, v = (t.repeat_interleave(4, dim=2) for t in kv)
    got = ops.flash_attention(q, k, v)
    want = ops.flash_attention(q.cpu(), k.cpu(), v.cpu())   # the twin
    assert got.shape == q.shape
    assert _flash_close(got, want.to(card), v)


def test_flash_refuses_what_the_kernel_does_not_take(card):
    x = torch.randn(2, 128, 48, device=card)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(x, x, x)
    y = torch.randn(2, 128, 64, device=card)
    with pytest.raises(ValueError, match="multiples"):
        fa.flash_attention(y, y[:, :100].contiguous(), y[:, :100].contiguous())


def test_short_reduced_serve_on_the_card(card):
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import Model
    model = Model(get_config("qwen2.5-14b").reduced())
    params = model.init(0)
    prompt = torch.randint(0, 256, (2, 8), device=card)
    res = generate(model, params, prompt, 4, torch.float32)
    assert res["tokens"].shape == (2, 4)
    assert bool(torch.isfinite(res["logits"]).all())
    pf, _ = model.prefill(params, {"tokens": prompt})
    torch.testing.assert_close(pf, res["prompt_logits"], rtol=1e-4,
                               atol=1e-4)
