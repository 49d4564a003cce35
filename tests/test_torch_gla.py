"""Port parity, chunked gated linear attention: ``repro_torch.models.gla``
on the CPU against ``repro.models.gla`` on the same seeded numpy inputs.

Every case runs in f32, in all four modes of the recurrence (scalar or
vector decay, inclusive or exclusive; the rwkv bonus ``u`` in the
vector-exclusive mode), with and without an initial state, over 1-3 chunks.

Tolerance, one bound throughout: ``(c + Dk + 8) * 2^-24 * A`` per element
(``gla.summation_bound``), with A the same recurrence in f64 on ``|r|,
|k|, |v|`` (``|u|``, ``|s0|``) under the same decays. Every term of A is
nonnegative, so A is the sum of the magnitudes of the products behind each
output, and two f32 evaluations that differ only in summation order (a
c-term intra-chunk sum, a Dk-term product with the carried state, a few
roundings of the decays) stay within that many half-ULPs of it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import gla as gla_j
from repro_torch.models import gla as gla_t

torch.set_num_threads(1)

B, H, DK, DV, CHUNK = 2, 3, 16, 8, 16
#: (scalar decay, inclusive, bonus u)
MODES = {"scalar-inclusive": (True, True, False),
         "scalar-exclusive": (True, False, False),
         "vector-inclusive": (False, True, False),
         "vector-exclusive-u": (False, False, True)}


def _inputs(seed, n_chunks, scalar, with_u, with_state, g_scale=1.0):
    rng = np.random.default_rng(seed)
    t = n_chunks * CHUNK
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    gshape = (B, H, t) if scalar else (B, H, t, DK)
    # log-decays <= 0 spread over about two decades
    g = (-np.exp(rng.normal(-1.0, 1.0, size=gshape)) * g_scale
         ).astype(np.float32)
    return dict(r=f(B, H, t, DK), k=f(B, H, t, DK), v=f(B, H, t, DV), g=g,
                u=f(H, DK) if with_u else None,
                s0=f(B, H, DK, DV) if with_state else None)


def _torch(x):
    return None if x is None else torch.from_numpy(np.array(x, np.float32))


def _jax(x):
    return None if x is None else jnp.asarray(x)


def _within(got, want, bound):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    bound = np.asarray(bound, np.float64)
    assert np.isfinite(got).all()
    excess = np.abs(got - want) - bound
    assert (excess <= 0).all(), float(np.max(excess))


def _bounds(x, inclusive, chunk=CHUNK):
    return gla_t.summation_bound(
        _torch(x["r"]), _torch(x["k"]), _torch(x["v"]), _torch(x["g"]),
        chunk=chunk, u=_torch(x["u"]), inclusive=inclusive,
        initial_state=_torch(x["s0"]))


@pytest.mark.parametrize("n_chunks", [1, 2, 3])
@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "s0"])
@pytest.mark.parametrize("mode", list(MODES))
def test_chunked_gla_against_the_reference(mode, with_state, n_chunks):
    """The port's chunked form against the reference's chunked form and its
    O(T) recurrence: outputs and final state."""
    scalar, inclusive, with_u = MODES[mode]
    x = _inputs(10 * n_chunks + with_state, n_chunks, scalar, with_u,
                with_state)
    o_t, s_t = gla_t.chunked_gla(
        _torch(x["r"]), _torch(x["k"]), _torch(x["v"]), _torch(x["g"]),
        u=_torch(x["u"]), chunk=CHUNK, inclusive=inclusive,
        initial_state=_torch(x["s0"]))
    assert o_t.dtype == torch.float32 and o_t.shape == (B, H, n_chunks *
                                                        CHUNK, DV)
    jx = {k: _jax(v) for k, v in x.items()}
    o_c, s_c = gla_j.chunked_gla(jx["r"], jx["k"], jx["v"], jx["g"],
                                 u=jx["u"], chunk=CHUNK, inclusive=inclusive,
                                 initial_state=jx["s0"])
    o_r, s_r = gla_j.reference_recurrence(jx["r"], jx["k"], jx["v"], jx["g"],
                                          u=jx["u"], inclusive=inclusive,
                                          initial_state=jx["s0"])
    bo, bs = _bounds(x, inclusive)
    for o_ref, s_ref in ((o_c, s_c), (o_r, s_r)):
        _within(o_t, o_ref, bo)
        _within(s_t, s_ref, bs)


@pytest.mark.parametrize("mode", list(MODES))
def test_reference_recurrence_against_the_reference(mode):
    scalar, inclusive, with_u = MODES[mode]
    x = _inputs(40, 2, scalar, with_u, True)
    o_t, s_t = gla_t.reference_recurrence(
        _torch(x["r"]), _torch(x["k"]), _torch(x["v"]), _torch(x["g"]),
        u=_torch(x["u"]), inclusive=inclusive, initial_state=_torch(x["s0"]))
    jx = {k: _jax(v) for k, v in x.items()}
    o_r, s_r = gla_j.reference_recurrence(jx["r"], jx["k"], jx["v"], jx["g"],
                                          u=jx["u"], inclusive=inclusive,
                                          initial_state=jx["s0"])
    bo, bs = _bounds(x, inclusive)
    _within(o_t, o_r, bo)
    _within(s_t, s_r, bs)


@pytest.mark.parametrize("mode", list(MODES))
def test_gla_decode_against_the_reference(mode):
    """One step from a random state: a Dk-term product and the state
    update, within ``(1 + Dk + 8) * 2^-24 * A``."""
    scalar, inclusive, with_u = MODES[mode]
    x = _inputs(50, 1, scalar, with_u, True)
    one = {k: (v[:, :, :1] if k in "rkvg" else v) for k, v in x.items()}
    step = lambda a: a[:, :, 0]
    o_t, s_t = gla_t.gla_decode(
        step(_torch(one["r"])), step(_torch(one["k"])),
        step(_torch(one["v"])), step(_torch(one["g"])), _torch(one["s0"]),
        u=_torch(one["u"]), inclusive=inclusive)
    o_j, s_j = gla_j.gla_decode(
        step(_jax(one["r"])), step(_jax(one["k"])), step(_jax(one["v"])),
        step(_jax(one["g"])), _jax(one["s0"]), u=_jax(one["u"]),
        inclusive=inclusive)
    bo, bs = _bounds(one, inclusive, chunk=1)
    _within(o_t, o_j, bo[:, :, 0])
    _within(s_t, s_j, bs)


def test_gla_decode_leaves_the_state_alone():
    x = _inputs(51, 1, False, True, True)
    s0 = _torch(x["s0"])
    keep = s0.clone()
    gla_t.gla_decode(_torch(x["r"])[:, :, 0], _torch(x["k"])[:, :, 0],
                     _torch(x["v"])[:, :, 0], _torch(x["g"])[:, :, 0], s0,
                     u=_torch(x["u"]))
    assert torch.equal(s0, keep)


@pytest.mark.parametrize("scalar", [False, True], ids=["vector", "scalar"])
def test_strong_decay_stays_finite(scalar):
    """rwkv-style strong decay (g near -10): the masked region is clamped
    before exp, so nothing overflows (all the reference's own test asks),
    and the result still agrees with the reference's recurrence. Here the
    chunk's cumulative log-decay reaches G = 160, and its f32 rounding,
    which the summation bound does not count, dominates: each weight
    exp(qdec_i - cin_j) is the exp of a difference of two c-term sums of
    |g|, each rounded to within (c + 1) * 2^-24 * G, so the weights, and
    the terms of A, carry a relative error of up to 2 (c + 1) * 2^-24 * G
    on top."""
    x = _inputs(60, 3, scalar, not scalar, True)
    x["g"] = np.full_like(x["g"], -10.0) + np.float32(0.01) * x["g"]
    inclusive = scalar
    o_t, s_t = gla_t.chunked_gla(
        _torch(x["r"]), _torch(x["k"]), _torch(x["v"]), _torch(x["g"]),
        u=_torch(x["u"]), chunk=CHUNK, inclusive=inclusive,
        initial_state=_torch(x["s0"]))
    assert torch.isfinite(o_t).all() and torch.isfinite(s_t).all()
    jx = {k: _jax(v) for k, v in x.items()}
    o_r, s_r = gla_j.reference_recurrence(jx["r"], jx["k"], jx["v"], jx["g"],
                                          u=jx["u"], inclusive=inclusive,
                                          initial_state=jx["s0"])
    bo, bs = _bounds(x, inclusive)
    big_g = float(np.abs(x["g"]).reshape(B, H, 3, CHUNK, -1).sum(3).max())
    extra = 2 * (CHUNK + 1) * 2.0 ** -24 * big_g / ((CHUNK + DK + 8) *
                                                     2.0 ** -24)
    _within(o_t, o_r, bo * (1 + extra))
    _within(s_t, s_r, bs * (1 + extra))


def test_chunked_gla_needs_whole_chunks():
    x = _inputs(70, 1, False, False, False)
    r = _torch(x["r"])[:, :, :12]
    with pytest.raises(AssertionError, match="not divisible by chunk"):
        gla_t.chunked_gla(r, r, _torch(x["v"])[:, :, :12],
                          _torch(x["g"])[:, :, :12], chunk=CHUNK)


@pytest.mark.parametrize("mode", list(MODES))
def test_summation_bound_is_the_abs_recurrence(mode):
    """The bound's A, from an independent f64 loop in numpy."""
    scalar, inclusive, with_u = MODES[mode]
    x = _inputs(80, 1, scalar, with_u, True)
    bo, bs = _bounds(x, inclusive)
    r, k, v = (np.abs(x[n]).astype(np.float64) for n in "rkv")
    u = None if x["u"] is None else np.abs(x["u"]).astype(np.float64)
    s = np.abs(x["s0"]).astype(np.float64)
    g = x["g"].astype(np.float64)
    outs = []
    for t in range(r.shape[2]):
        dec = np.exp(g[:, :, t])
        dec = dec[..., None, None] if scalar else dec[..., :, None]
        kv = k[:, :, t, :, None] * v[:, :, t, None, :]
        if inclusive:
            s = dec * s + kv
            outs.append(np.einsum("bhd,bhde->bhe", r[:, :, t], s))
        else:
            eff = s + (u[None, :, :, None] * kv if u is not None else 0.0)
            outs.append(np.einsum("bhd,bhde->bhe", r[:, :, t], eff))
            s = dec * s + kv
    scale = (CHUNK + DK + 8) * 2.0 ** -24
    np.testing.assert_allclose(bo.numpy(), np.stack(outs, 2) * scale,
                               rtol=1e-12, atol=0)
    np.testing.assert_allclose(bs.numpy(), s * scale, rtol=1e-12, atol=0)


def test_a_skipped_chunk_carry_fails_the_bound():
    """The bound is tight enough to see a fault: dropping the state carried
    into the second chunk moves the outputs far outside it."""
    x = _inputs(90, 2, False, True, False)
    r, k, v, g = (_torch(x[n]) for n in "rkvg")
    u = _torch(x["u"])
    o1, _ = gla_t.chunked_gla(r[:, :, :CHUNK], k[:, :, :CHUNK],
                              v[:, :, :CHUNK], g[:, :, :CHUNK], u=u,
                              chunk=CHUNK)
    o2, _ = gla_t.chunked_gla(r[:, :, CHUNK:], k[:, :, CHUNK:],
                              v[:, :, CHUNK:], g[:, :, CHUNK:], u=u,
                              chunk=CHUNK)
    faulty = torch.cat([o1, o2], dim=2)
    o_r, _ = gla_j.reference_recurrence(*(_jax(x[n]) for n in "rkvg"),
                                        u=_jax(x["u"]))
    bo, _ = _bounds(x, False)
    with pytest.raises(AssertionError):
        _within(faulty, o_r, bo)
