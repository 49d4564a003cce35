"""The port's Hopper kernels on the card: each FL kernel bit for bit
against its plain twin (``threshold_find`` and the block kernels also on
adversarial rows, the block kernels also on rows wider than their register
path), the present
``flash_attention`` kernel within its summation-order bound of its twin
(plus one bf16 ULP in bf16), the bf16 wgmma kernel within the bound of
``wgmma_twin_and_bound`` of its twin, the device-based dispatch of the
wrappers (bf16 to the wgmma kernel), and short ``run_fl`` runs (fused, legacy
and scan engines: scan replays one captured CUDA graph a round, bit-equal to
fused; the population engine bit-equal to pop_scan; the async sync anchor
bit-equal to scan / pop_scan; async batched dispatch bit-equal to
sequential) and a short reduced-model serve through the kernels' paths.

Every test here carries the ``cuda`` marker and skips without a CUDA card
(the kernels are CUDA C++; there is no interpret mode). This file imports
neither ``jax`` nor ``repro``, so it also runs where only PyTorch is
installed: ``python -m pytest -q tests/test_torch_cuda.py`` on the card.
"""
import importlib.util
import math
import pathlib

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


def _adversarial_rows():
    """``chip_smoke.adversarial_rows``: the rows the card run checks too."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.adversarial_rows


adversarial_rows = _adversarial_rows()

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
    # the one limit left on a row: k may not exceed its length (rows above
    # MAX_BLOCK take the wide path, test_block_kernels_wide_rows)
    with pytest.raises(ValueError, match="k=5"):
        bt.block_topk(torch.ones(2, 4, device=card), 5)
    with pytest.raises(ValueError, match="k=5"):
        eu.ef_update(torch.ones(2, 4, device=card),
                     torch.ones(2, 4, device=card), 5)


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


@pytest.mark.parametrize("strategy,block", [("bcrs_opwa", False),
                                            ("eftopk", False),
                                            ("bcrs_opwa", True)])
def test_short_scan_run_fl_on_the_card(card, strategy, block):
    """The scan engine's replays run the kernels (counted a replay) and
    give the fused engine's trajectory bit for bit."""
    from repro_torch.fed import engine
    from repro_torch.ft import FailureInjector
    acfg = AggregationConfig(strategy=strategy, block_topk=block)
    sim = FLSimConfig(rounds=4, dim=32, hidden=32, n_classes=5, eval_every=1)
    kw = dict(failure=FailureInjector(p_fail=0.3, seed=1))
    caps = sum(engine.CAPTURE_COUNTS.values())
    m0 = (oc.overlap_combine if block else fm.fused_merge).launches
    scan = run_fl(sim, acfg, engine="scan", **kw)
    assert sum(engine.CAPTURE_COUNTS.values()) == caps + 1
    rounds = len(scan.executed_rounds)
    assert (oc.overlap_combine if block else fm.fused_merge).launches == \
        m0 + rounds + engine.WARMUP
    fused = run_fl(sim, acfg, engine="fused", **kw)
    assert scan.executed_rounds == fused.executed_rounds
    assert scan.accuracies == fused.accuracies
    assert scan.times.actual == fused.times.actual
    if fused.final_residuals is not None:
        assert (scan.final_residuals.view("u4")
                == fused.final_residuals.view("u4")).all()


_SMALL_SIM = dict(dim=32, hidden=32, n_classes=5, rounds=4, eval_every=1)


def _same_trajectory(a, b):
    assert a.executed_rounds == b.executed_rounds
    assert a.accuracies == b.accuracies
    assert [t.actual for t in a.times.per_round] == \
        [t.actual for t in b.times.per_round]
    if b.final_residuals is not None:
        assert (a.final_residuals.view("u4")
                == b.final_residuals.view("u4")).all()


@pytest.mark.parametrize("strategy", ["eftopk", "qtopk"])
def test_population_equals_pop_scan_on_the_card(card, strategy):
    """The population engine's eager rounds run the kernels once a round
    and give pop_scan's replayed trajectory bit for bit, residuals
    included."""
    acfg = AggregationConfig(strategy=strategy)
    t0 = tf.threshold_find.launches
    pop = run_fl(FLSimConfig(**_SMALL_SIM), acfg, engine="population")
    assert tf.threshold_find.launches == t0 + len(pop.executed_rounds)
    _same_trajectory(pop, run_fl(FLSimConfig(**_SMALL_SIM), acfg,
                                 engine="pop_scan"))


@pytest.mark.parametrize("strategy,ref", [("bcrs_opwa", "scan"),
                                          ("eftopk", "pop_scan")])
def test_async_sync_anchor_on_the_card(card, strategy, ref):
    acfg = AggregationConfig(strategy=strategy)
    m0 = fm.fused_merge.launches
    res = run_fl(FLSimConfig(**_SMALL_SIM, async_sync_arrivals=True), acfg,
                 engine="async")
    assert fm.fused_merge.launches == m0 + len(res.executed_rounds)
    _same_trajectory(res, run_fl(FLSimConfig(**_SMALL_SIM), acfg,
                                 engine=ref))


def test_async_batched_equals_sequential_on_the_card(card):
    """The general loop at the bench's dispatch shape (P = 64, K = 8,
    M = 32) at a reduced width: every wave at one static width, batched
    dispatch bit-equal to per-upload dispatch in fewer train calls."""
    base = dict(rounds=4, n_clients=64, participation=0.125, batch_size=8,
                beta=5.0, n_train=2048, n_test=400, eval_every=2, seed=3,
                dim=32, hidden=32, n_classes=5, async_buffer_k=8,
                async_concurrency=32, async_p_fail_upload=0.1,
                async_upload_timeout_s=600.0)
    acfg = AggregationConfig(strategy="eftopk", cr=0.05)
    b = run_fl(FLSimConfig(**base), acfg, engine="async")
    s = run_fl(FLSimConfig(**base, async_batch_dispatch=False), acfg,
               engine="async")
    _same_trajectory(b, s)
    assert _same_bits(b.async_loop.flat, s.async_loop.flat)
    assert b.async_loop.wave_width == s.async_loop.wave_width == 32
    assert b.async_loop.train_calls < s.async_loop.train_calls


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
    # the present kernel (bf16 at D 64 / 128 reaches it only directly: the
    # entry point sends those to the wgmma kernel)
    f0 = fa.flash_attention.launches
    got = fa.flash_attention_cuda(q, k, v, causal=causal)
    assert fa.flash_attention.launches == f0 + 1
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and _flash_close(got, want, v)
    if dtype == torch.bfloat16:       # the f32 arithmetic on exact upcasts
        up = fa.flash_attention_cuda(q.float(), k.float(), v.float(),
                                     causal=causal)
        assert torch.equal(got, up.to(torch.bfloat16))


def _wgmma_close(got, want, bound):
    """Within the bound of ``wgmma_twin_and_bound`` plus one bf16 ULP of
    the larger magnitude."""
    diff = (got.double() - want.double()).abs()
    mag = torch.maximum(got.double().abs(), want.double().abs())
    _, e = torch.frexp(mag.float())
    return bool((diff <= bound + torch.pow(2.0, (e - 8).double())).all())


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_wgmma_vs_twin(card, d, causal):
    g = torch.Generator(device=card).manual_seed(d + causal)
    q, k, v = (torch.randn(3, s, d, device=card, generator=g).to(
        torch.bfloat16) for s in (256, 384, 384))
    w0 = fa.flash_attention_wgmma_cuda.launches
    got = fa.flash_attention_wgmma_cuda(q, k, v, causal=causal)
    assert fa.flash_attention_wgmma_cuda.launches == w0 + 1
    want, bound = fa.wgmma_twin_and_bound(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert _wgmma_close(got, want, bound)
    f32 = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                   causal=causal)
    twin, bound1 = fa.wgmma_twin_and_bound(q, k, v, causal=causal,
                                           both_round=False)
    assert _wgmma_close(twin, f32, bound1)


def test_flash_wgmma_ragged_entry_point(card):
    """Sq 700 x Sk 1000 through ops.flash_attention (padded to 768 x 1024
    there): the wgmma kernel's rows, within the bound of its twin."""
    g = torch.Generator(device=card).manual_seed(7)
    q = torch.randn(1, 700, 2, 64, device=card, generator=g).bfloat16()
    k, v = (torch.randn(1, 1000, 2, 64, device=card, generator=g).bfloat16()
            for _ in range(2))
    w0 = fa.flash_attention_wgmma_cuda.launches
    got = ops.flash_attention(q, k, v)
    assert fa.flash_attention_wgmma_cuda.launches == w0 + 1

    def flat(x, s):
        t = x.transpose(1, 2).reshape(2, x.shape[1], 64)
        return torch.nn.functional.pad(t, (0, 0, 0, s - x.shape[1]))

    qb, kb, vb = flat(q, 768), flat(k, 1024), flat(v, 1024)
    want, bound = fa.wgmma_twin_and_bound(qb, kb, vb)
    torch.cuda.synchronize()
    assert got.shape == q.shape
    got = flat(got, 768)           # [BH, Sq, D], zero rows past 700
    assert _wgmma_close(got[:, :700], want[:, :700], bound[:, :700])


@pytest.mark.parametrize("d", [64, 128])
def test_flash_bf16_reaches_the_wgmma_kernel(card, d):
    x = torch.randn(1, 256, 4, d, device=card).bfloat16()
    f0 = fa.flash_attention.launches
    w0 = fa.flash_attention_wgmma_cuda.launches
    ops.flash_attention(x, x, x)
    assert (fa.flash_attention.launches,
            fa.flash_attention_wgmma_cuda.launches) == (f0, w0 + 1)
    ops.flash_attention(x.float(), x.float(), x.float())
    assert (fa.flash_attention.launches,
            fa.flash_attention_wgmma_cuda.launches) == (f0 + 1, w0 + 1)


def test_threshold_find_adversarial_rows(card):
    """Rows that stress the radix select, thresholds and absmax bit for bit
    against the twin: every k of a row of ties, zeros, all equal, denormal,
    NaN, +-inf, ties at the k-th value, n % 4 != 0, unaligned rows, C = 1
    and C = 32."""
    g = torch.Generator(device=card).manual_seed(3)
    row = torch.randint(-3, 4, (64,), device=card, generator=g).float() * 0.5
    cases = [(row.repeat(64, 1).contiguous(), None,
              torch.arange(1, 65, device=card, dtype=torch.int32))]
    c, n = 32, 1023
    x = torch.randn(c, n, device=card, generator=g)
    x[0], x[1] = 0.0, 1.5
    x[2] *= 1e-40
    x[3, ::7] = float("nan")
    x[4, ::5], x[4, 1::5] = float("inf"), float("-inf")
    x[5, :600] = x[5, 0]
    x[6] = float("nan")
    ks = torch.randint(1, n + 1, (c,), device=card, generator=g,
                       dtype=torch.int32)
    ks[0], ks[1], ks[5], ks[-1] = 1, n, 300, n
    e = 0.3 * torch.randn(c, n, device=card, generator=g)
    cases += [(x, None, ks), (x, e, ks)]
    buf = torch.randn(3 * 512 + 1, device=card, generator=g)
    cases.append((buf[1:].view(3, 512), None,
                  torch.tensor([1, 100, 512], device=card, dtype=torch.int32)))
    cases.append((torch.tensor([[-2.5]], device=card), None,
                  torch.tensor([1], device=card, dtype=torch.int32)))
    for x, e, ks in cases:
        th, am = tf.threshold_find(x, ks, e, emit_scale=True)
        tp, ap = tf.threshold_find_plain(x, ks, e, emit_scale=True)
        assert torch.equal(th, tp) and _same_bits(am, ap)


def test_threshold_find_reads_of_x(card):
    """Both branches of the last pass, bit for bit: a client whose chosen
    bin is small reads its compacted candidates (2 reads of x), one whose
    bin holds more than n/8 (a row mostly zero, k in the zeros) reads x
    again (3); the kernel reports which."""
    g = torch.Generator(device=card).manual_seed(4)
    c, n = 4, 1 << 20
    x = torch.randn(c, n, device=card, generator=g)
    x[1, : n * 9 // 10] = 0.0
    x[2, : n * 9 // 10] = 0.0
    ks = torch.tensor([n // 10, n // 2, n // 50, 1], device=card,
                      dtype=torch.int32)
    tf.threshold_find.reads_log = []
    try:
        th = tf.threshold_find(x, ks)
        log = tf.threshold_find.reads_log
    finally:
        tf.threshold_find.reads_log = None
    assert torch.equal(th, tf.threshold_find_plain(x, ks))
    assert len(log) == 1 and log[0].tolist() == [2, 3, 2, 2]


def test_block_kernels_wide_rows(card):
    """block = 32768, above the register path: the wide path, bit for bit
    against the twins."""
    x = _rows(8, 32768, card)
    e = 0.3 * _rows(8, 32768, card, seed=1).nan_to_num(0.0, 0.0, 0.0)
    b0, e0 = bt.block_topk.launches, eu.ef_update.launches
    for k in (1, 3277, 32768):
        v, m = bt.block_topk(x, k)
        pv, pm = bt.block_topk_plain(x, k)
        assert _same_bits(v, pv) and torch.equal(m, pm)
        s, r = eu.ef_update(x, e, k)
        ps, pr = eu.ef_update_plain(x, e, k)
        assert _same_bits(s, ps) and _same_bits(r, pr)
    assert (bt.block_topk.launches, eu.ef_update.launches) == (b0 + 3, e0 + 3)
    u = x.reshape(-1)[:70_001].nan_to_num(0.0, 0.0, 0.0)
    got = ops.block_topk(u, 0.1, block=32768)
    want = ops.block_topk(u.cpu(), 0.1, block=32768)
    assert torch.equal(got.mask.cpu(), want.mask)
    assert _same_bits(got.values.cpu(), want.values)


@pytest.mark.parametrize("block", [1000, 1001, 8192, 16384, 32768, 65536])
def test_block_kernels_adversarial_rows(card, block):
    """chip_smoke.adversarial_rows (one hot first digit, last-digit
    neighbours at the k-th, patterns one ULP apart, ties across the k-th,
    NaN, inf, denormals) on every route: registers with float4 access
    (1000, 8192, 16384) and without (1001), and the wide path, which
    re-reads the row from device memory (32768, 65536): bit for bit against
    the twins."""
    for k in (1, max(1, block // 10), block):
        x = torch.from_numpy(adversarial_rows(block, k, block + k))
        x = x.to(card)
        e = 0.3 * _rows(16, block, card, seed=k).nan_to_num(0.0, 0.0, 0.0)
        v, m = bt.block_topk(x, k)
        pv, pm = bt.block_topk_plain(x, k)
        assert _same_bits(v, pv) and torch.equal(m, pm), k
        s, r = eu.ef_update(x, e, k)
        ps, pr = eu.ef_update_plain(x, e, k)
        assert _same_bits(s, ps) and _same_bits(r, pr), k


def test_block_kernels_unaligned_rows(card):
    """Rows 4 bytes past a 16-byte boundary take the scalar register
    path: bit for bit against the twins."""
    x = _rows(8, 8193, card).reshape(-1)[1:65537].view(8, 8192)
    e = x.flip(0).nan_to_num(0.0, 0.0, 0.0)
    v, m = bt.block_topk(x, 819)
    pv, pm = bt.block_topk_plain(x, 819)
    assert _same_bits(v, pv) and torch.equal(m, pm)
    s, r = eu.ef_update(x, e, 819)
    ps, pr = eu.ef_update_plain(x, e, 819)
    assert _same_bits(s, ps) and _same_bits(r, pr)


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


# ------------------------------------------------ real-model FL round
@pytest.mark.parametrize("strategy", ["bcrs_opwa", "eftopk", "qtopk",
                                      "int4"])
def test_compress_merge_leaf_kernel_route(card, strategy):
    """``compress_merge_leaf`` on a 3-d leaf with a padded slot: the kernel
    route (``threshold_find`` + ``fused_merge``, one launch each) against
    the plain route on the same CUDA tensors — residuals bit for bit, agg
    within the client-sum reordering bound."""
    from repro_torch.core import compression as comp
    from repro_torch.core.strategies import get
    from repro_torch.fed.engine import compress_merge_leaf
    strat = get(strategy)
    g = torch.Generator(device=card).manual_seed(3)
    c, shape = 5, (3, 70, 41)
    u = torch.randn((c,) + shape, device=card, generator=g)
    u[-1] = 0.0
    res = (0.3 * torch.randn((c,) + shape, device=card, generator=g)
           if strat.needs_residuals else None)
    w = torch.rand(c, device=card, generator=g) + 0.1
    active = torch.ones(c, dtype=torch.bool, device=card)
    active[-1] = False
    ks = comp.k_for_ratio_traced(
        u[0].numel(), torch.tensor([0.05, 0.3, 1.0, 0.01, 0.1],
                                   device=card))
    kw = dict(gamma=3.0, opwa=strat.overlap_weighted, residuals=res,
              active=active, value_codec=strat.value_codec,
              kernel_codec=strat.kernel_codec)
    tf.threshold_find.launches = fm.fused_merge.launches = 0
    agg_k, res_k = compress_merge_leaf(u, w, ks, use_kernel="auto", **kw)
    assert tf.threshold_find.launches == fm.fused_merge.launches == 1
    agg_p, res_p = compress_merge_leaf(u, w, ks, use_kernel=False, **kw)
    assert tf.threshold_find.launches == fm.fused_merge.launches == 1
    if res is not None:
        assert torch.equal(res_k.view(torch.int32), res_p.view(torch.int32))
    x = (u + res) if res is not None else u
    mask = comp.topk_compress_dynamic(x.reshape(c, -1), ks).mask
    vals = torch.where(mask, x.reshape(c, -1), 0.0) * active[:, None]
    gamma = 3.0 if strat.overlap_weighted else 1.0
    bound = 2 * c * 2.0 ** -24 * gamma * (
        torch.where(active, w, 0.0)[:, None].double()
        * vals.double()).abs().sum(0)
    if strat.value_codec is not None:
        bound = bound * 2        # the dequantized values are within 2x |x|
    diff = (agg_k.double() - agg_p.double()).abs().reshape(-1)
    assert bool((diff <= bound).all())


def test_fl_train_round_engine_reduced_on_the_card(card, tmp_path):
    """``fl_train.run(engine="round")`` at ``reduced()`` size on the card:
    each kernel launched leaves x rounds, finite losses, and a restart (2
    rounds, then resume to 4) equal to 4 rounds bit for bit."""
    from repro_torch.fed.engine import tree_items
    from repro_torch.launch import fl_train as fl
    kw = dict(arch="stablelm-1.6b", reduced=True, clients=4, local_steps=2,
              batch=2, seq=16, strategy="eftopk", engine="round",
              checkpoint_every=2, device="cuda", verbose=False)
    tf.threshold_find.launches = fm.fused_merge.launches = 0
    full = fl.run(fl.FLTrainConfig(rounds=4, **kw))
    leaves = len(tree_items(full["params"]))
    assert tf.threshold_find.launches == fm.fused_merge.launches == 4 * leaves
    assert all(math.isfinite(v) for v in full["losses"])
    fl.run(fl.FLTrainConfig(rounds=2, checkpoint_dir=str(tmp_path), **kw))
    resumed = fl.run(fl.FLTrainConfig(rounds=4, checkpoint_dir=str(tmp_path),
                                      **kw))
    assert resumed["resumed_from"] == 2
    for key in ("params", "residuals"):
        for (_, a), (_, b) in zip(tree_items(full[key]),
                                  tree_items(resumed[key])):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))


# ------------------------------------------------ centralised training
@pytest.mark.parametrize("n_pods", [2, 4])
def test_compressed_train_step_kernel_route(card, n_pods):
    """``make_compressed_train_step`` at ``reduced()`` size on the card:
    each leaf of at least 4096 elements launches ``threshold_find`` and
    ``fused_merge`` once; its ``[n_pods, leaf]`` pod gradients through
    the kernel and the plain route of ``compress_merge_leaf`` select the
    same elements (EF residuals bit for bit) and merge within the
    client-sum bound ``2*C*2^-24*gamma*sum|w v|``; the whole step by both
    routes gives the same EF residuals bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.core import compression as comp
    from repro_torch.dist import grad_sync as gs
    from repro_torch.fed.engine import compress_merge_leaf, tree_items
    from repro_torch.models import Model
    from repro_torch.optim import make_optimizer
    model = Model(get_config("stablelm-1.6b").reduced(), device=card)
    params = model.init(0)
    g = torch.Generator(device=card).manual_seed(5)
    toks = torch.randint(0, model.cfg.vocab_size, (4, 33), device=card,
                         generator=g)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    crs = torch.linspace(0.05, 0.02, n_pods, device=card)
    w = torch.full((n_pods,), 1.0 / n_pods, device=card)
    pods, _, _ = gs.pod_gradients(model.loss_fn, params, batch, n_pods)
    compressed = 0
    for (_, p), u in zip(tree_items(params), pods):
        n = p.numel()
        if n < 4096:
            continue
        compressed += 1
        u2 = u.reshape(n_pods, n)
        res = 0.1 * torch.randn(u2.shape, device=card, generator=g)
        ks = comp.k_for_ratio_traced(n, crs)
        kw = dict(gamma=2.0, opwa=True, residuals=res)
        tf.threshold_find.launches = fm.fused_merge.launches = 0
        agg_k, res_k = compress_merge_leaf(u2, w, ks, use_kernel="auto",
                                           **kw)
        assert tf.threshold_find.launches == fm.fused_merge.launches == 1
        agg_p, res_p = compress_merge_leaf(u2, w, ks, use_kernel=False,
                                           **kw)
        assert torch.equal(res_k.view(torch.int32), res_p.view(torch.int32))
        x = u2 + res
        vals = torch.where(comp.topk_compress_dynamic(x, ks).mask, x, 0.0)
        bound = 2 * n_pods * 2.0 ** -24 * 2.0 * (
            w[:, None].double() * vals.double()).abs().sum(0)
        assert bool(((agg_k.double() - agg_p.double()).abs()
                     <= bound).all())
    assert compressed >= 8
    opt = make_optimizer("sgd", 1e-2)
    out = {}
    for route in ("auto", False):
        step = gs.make_compressed_train_step(model, opt, n_pods=n_pods,
                                             wire_cr=0.05, gamma=2.0,
                                             use_kernel=route)
        state = gs.init_compressed_state(opt, params, n_pods=n_pods)
        tf.threshold_find.launches = fm.fused_merge.launches = 0
        _, state, m = step(params, state, batch, crs, w)
        launched = (tf.threshold_find.launches, fm.fused_merge.launches)
        assert launched == ((compressed, compressed) if route == "auto"
                            else (0, 0))
        assert math.isfinite(float(m["loss"]))
        out[route] = state["ef"]
    for (_, a), (_, b) in zip(tree_items(out["auto"]),
                              tree_items(out[False])):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.fixture
def card_group(card):
    """A one-rank NCCL process group on the card (what one card allows of
    the multi-card layout); destroyed after the test."""
    import socket

    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        yield card
    finally:
        dist.destroy_process_group()


def test_place_then_full_tensor_on_the_card(card_group):
    """``sharding.place`` lays a bf16 and an f32 leaf out on a (1, 1)
    CUDA mesh, stacked leaves realised by ``stack_placements``;
    ``full_tensor()`` gives the source's bits back on the card."""
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import mesh as mesh_t
    dm = mesh_t.device_mesh(mesh_t.make_mesh_from_spec(
        (1, 1), ("data", "model")), "cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    tree = {"w": torch.randn(4, 64, 96, generator=g, device="cuda").to(
                torch.bfloat16),
            "b": torch.randn(96, generator=g, device="cuda")}
    specs = {"w": shd.P("data", None, "model"), "b": shd.P()}
    placed = shd.place(tree, specs, dm, n_stack=lambda p: 1 if p == ("w",)
                       else 0)
    assert placed["w"].device.type == "cuda"
    for k in tree:
        assert shd.is_dtensor(placed[k])
        assert torch.equal(placed[k].full_tensor(), tree[k])


def test_constrain_redistributes_a_cuda_dtensor(card_group):
    """Under rules on a realised CUDA mesh ``constrain`` returns the
    DTensor laid out as its spec (the same values); a plain tensor comes
    back itself."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import mesh as mesh_t
    dm = mesh_t.device_mesh(mesh_t.make_mesh_from_spec(
        (1, 1), ("data", "model")), "cuda")
    x = torch.randn(2, 8, 16, device="cuda")
    d = distribute_tensor(x, dm, [Replicate(), Replicate()])
    rules = shd.make_rules(get_config("qwen2.5-32b"), SHAPES["train_4k"], dm)
    with shd.use_rules(rules):
        y = shd.constrain(d, ("batch", None, "act_d"))
        assert y.placements == (Shard(0), Shard(2))
        assert torch.equal(y.full_tensor(), x)
        assert shd.constrain(x, ("batch", None, "act_d")) is x
