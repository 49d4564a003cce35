"""Port parity, the block kernels' selection: the route the Hopper kernels
``block_topk`` and ``ef_update`` take (``csrc/block_select.cuh``), repeated
in PyTorch, against the reference's 40-step value bisection.

The kernels find the k-th largest flushed magnitude m_k by a radix select
(4 digit passes over the 31-bit pattern) and then run the 40 bisection
steps as a scalar recurrence with pred ``m_k >= mid``. Here
``radix_kth_plain`` runs those digit passes with torch histograms and is
held to ``torch.topk`` on the int32 patterns; ``select_threshold_from_kth``
(the radix select, then the recurrence) is held bit for bit to the twin's
``select_threshold`` and, through the outputs, to ``block_topk_pallas`` and
``ef_update_pallas`` in interpret mode (blocks 8192 and 32768: the Pallas
kernels need block % 128 == 0; blocks 1 and 1000 are held to the twin).
Every comparison is exact: the selection is integer counting and the
recurrence is the reference's own f32 op sequence.

The rows are ``chip_smoke.adversarial_rows``: zeros, ties, huge, NaN,
+-inf, the k-th below rowmax*2^-40, denormal rows and halves, signed zeros,
ties across the k-th, patterns one ULP apart across 1.0, last-digit
neighbours, one hot first digit; k = 1, the default ratio's k and k = block.
"""
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.block_topk import block_topk_pallas
from repro.kernels.ef_update import ef_update_pallas
from repro_torch.core.compression import k_for_ratio
from repro_torch.kernels import block_topk as bt


def _adversarial_rows():
    """``chip_smoke.adversarial_rows``: the rows the card run checks too."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.adversarial_rows


adversarial_rows = _adversarial_rows()

torch.set_num_threads(1)

CR = 0.1                                  # AggregationConfig.cr default
BLOCKS = (1, 1000, 8192, 32768)
KS = ("one", "ratio", "block")


def _k(block, which):
    return {"one": 1, "ratio": k_for_ratio(block, CR), "block": block}[which]


def _case(block, which):
    k = _k(block, which)
    x = adversarial_rows(block, k, seed=block + k)
    return x, k


def _mag(x):
    return bt.flush_denormals(torch.from_numpy(x).abs())


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("which", KS)
@pytest.mark.parametrize("block", BLOCKS)
def test_radix_kth_is_the_kth_pattern(block, which):
    x, k = _case(block, which)
    mag = _mag(x)
    want = torch.topk(mag.view(torch.int32), k, dim=1).values[:, -1:]
    assert torch.equal(bt.radix_kth_plain(mag, k), want)


@pytest.mark.parametrize("which", KS)
@pytest.mark.parametrize("block", BLOCKS)
def test_from_kth_equals_the_bisection(block, which):
    x, k = _case(block, which)
    mag = _mag(x)
    got = bt.select_threshold_from_kth(mag, k)
    want = bt.select_threshold(mag, k)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want.numpy()))


@pytest.mark.parametrize("which", KS)
@pytest.mark.parametrize("block", (8192, 32768))
def test_block_topk_outputs_vs_pallas(block, which):
    x, k = _case(block, which)
    xt = torch.from_numpy(x)
    mag = _mag(x)
    mask = mag >= bt.select_threshold_from_kth(mag, k)
    vals = torch.where(mask, xt, torch.zeros_like(xt))
    vj, mj = block_topk_pallas(jnp.asarray(x), k, interpret=True)
    np.testing.assert_array_equal(mask.to(torch.int8).numpy(), np.asarray(mj))
    np.testing.assert_array_equal(_bits(vals.numpy()), _bits(vj))
    vt, mt = bt.block_topk(xt, k)                 # the twin, the same bits
    assert torch.equal(mt, mask.to(torch.int8))
    np.testing.assert_array_equal(_bits(vt.numpy()), _bits(vj))


@pytest.mark.parametrize("which", KS)
@pytest.mark.parametrize("block", (8192, 32768))
def test_ef_update_outputs_vs_pallas(block, which):
    g, k = _case(block, which)
    rng = np.random.default_rng(block)
    e = (0.3 * rng.normal(size=g.shape)).astype(np.float32)
    e[0] = -g[0]                                  # exact cancellation
    e[8, :20] = 1e-40                             # denormal residuals
    corrected = bt.flush_denormals(
        bt.flush_denormals(torch.from_numpy(e))
        + bt.flush_denormals(torch.from_numpy(g)))
    mag = corrected.abs()
    mask = mag >= bt.select_threshold_from_kth(mag, k)
    send = torch.where(mask, corrected, torch.zeros_like(corrected))
    sj, rj = ef_update_pallas(jnp.asarray(g), jnp.asarray(e), k,
                              interpret=True)
    np.testing.assert_array_equal(_bits(send.numpy()), _bits(sj))
    np.testing.assert_array_equal(_bits((corrected - send).numpy()),
                                  _bits(rj))


def test_rows_make_every_digit_decide():
    """The adversarial rows do what they are for: at the default ratio's k
    the ULP rows and the last-digit neighbours hold other patterns that
    share every digit of m_k but the last, and the hot row's patterns all
    share m_k's first digit."""
    block = 8192
    x, k = _case(block, "ratio")
    kth = bt.radix_kth_plain(_mag(x), k)[:, 0].numpy().astype(np.int64)
    pats = _mag(x).view(torch.int32).numpy().astype(np.int64)
    for row in (11, 12, 15):
        same = (pats[row] >> 7) == (kth[row] >> 7)
        assert (same & (pats[row] != kth[row])).any(), row
    assert ((pats[13] >> 23) == (kth[13] >> 23)).all()
    # one ULP apart across 1.0: the k-th is above 1.0, the row's least below
    assert kth[11] > 0x3F800000 > pats[11].min()
