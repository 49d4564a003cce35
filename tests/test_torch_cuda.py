"""The port's Hopper kernels on the card: each kernel bit for bit against
its plain twin, the device-based dispatch of the wrappers, and a short
``run_fl`` through the kernels.

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
from repro_torch.kernels import fused_merge as fm
from repro_torch.kernels import ops
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
