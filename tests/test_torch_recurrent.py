"""Port parity, the recurrent families' layers: ``layers.{layer_norm,
group_norm_heads}``, hymba's SSM branch (``models.mamba``) and RWKV-6's
time-mix and channel-mix (``models.rwkv6``), with their decode caches —
``repro_torch`` on the CPU against ``repro`` on the same inputs.

Params are the reference's own initialisers (a ``jax.random`` key), carried
across as numpy, with the leaves the initialisers set to constants (the
lerp weights, the decay base, the bonus, the conv bias, the SSM's A, dt
bias and skip, the norms' biases) redrawn from seeded numpy so that every
term is exercised. Sizes are ``reduced()``-like (d_model 64, 2-3 GLA
chunks of 16).

Tolerances and why. Both sides compute in f32 with the same op sequence
and differ only in summation order, an error of order sqrt(n) * 2^-24 of
the result's scale for an n-term sum:
  * the norms and softplus (elementwise, or a mean over <= 64): ``1e-6``;
  * one branch (projections of <= 128 terms, a chunked GLA whose outputs
    carry ``c + Dk`` roundings, a norm, the output projection; outputs of
    scale ~1): ``2e-5``, as one attention or MLP call in
    ``tests/test_torch_models.py``;
  * decode caches: the conv history and ``tm_x`` / ``cm_x`` are copies of
    an input (``1e-6``); the recurrent states sum t steps of products
    (``1e-5`` relative to their largest magnitude);
  * bf16 norms: one bf16 ULP at the compared magnitude; the bf16 conv
    (whose roundings the reference may fuse away) 6 ULPs of the sum of
    its terms' magnitudes, as counted at the test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as get_config_j
from repro.models import layers as layers_j
from repro.models import mamba as mamba_j
from repro.models import rwkv6 as rwkv_j
from repro_torch.configs import get_config
from repro_torch.models import layers as layers_t
from repro_torch.models import mamba as mamba_t
from repro_torch.models import rwkv6 as rwkv_t

torch.set_num_threads(1)

HYMBA = get_config("hymba-1.5b").reduced()
RWKV = get_config("rwkv6-1.6b").reduced()
B = 2


def _rand(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)
            ).astype(np.float32)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a, np.float32))
    return t.to(dtype) if dtype is not None else t


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _close_scaled(got, want, rel):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _bf16_close(got, want):
    """Within one bf16 ULP of the larger magnitude (2^-7 below 2)."""
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.maximum(np.abs(g),
                                                         np.abs(w)),
                                              2.0 ** -126))) - 7)
    assert (np.abs(g - w) <= ulp).all(), float(np.max(np.abs(g - w) / ulp))


def _both(tree):
    """numpy tree -> (torch tree, jax tree)."""
    if isinstance(tree, dict):
        pairs = {k: _both(v) for k, v in tree.items()}
        return ({k: v[0] for k, v in pairs.items()},
                {k: v[1] for k, v in pairs.items()})
    return _t(tree), jnp.asarray(tree)


def _redraw(tree, names, seed):
    """Replace the constant-initialised leaves ``names`` with seeded draws
    of their shape (scale 0.5)."""
    out = dict(tree)
    for i, name in enumerate(names):
        out[name] = _rand(seed + i, *np.shape(tree[name]), scale=0.5)
    return out


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))


# ------------------------------------------------------------------ norms
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_layer_norm(dtype):
    x, s, b = _rand(0, 3, 5, 64, scale=2.0) + 0.5, _rand(1, 64) + 1.0, \
        _rand(2, 64)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    got = layers_t.layer_norm(_t(x, tdt), _t(s), _t(b), 1e-5)
    want = layers_j.layer_norm(jnp.asarray(x, dtype), jnp.asarray(s),
                               jnp.asarray(b), 1e-5)
    assert got.dtype == tdt
    if dtype == jnp.float32:
        _close(got, want, 1e-6)
    else:
        _bf16_close(got, want)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_group_norm_heads(dtype):
    x, s, b = _rand(3, 2, 7, 64, scale=3.0), _rand(4, 64) + 1.0, _rand(5, 64)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    got = layers_t.group_norm_heads(_t(x, tdt), _t(s), _t(b), 4)
    want = layers_j.group_norm_heads(jnp.asarray(x, dtype), jnp.asarray(s),
                                     jnp.asarray(b), 4)
    assert got.dtype == tdt and got.shape == x.shape
    if dtype == jnp.float32:
        _close(got, want, 1e-6)
    else:
        _bf16_close(got, want)


def test_softplus_is_logaddexp():
    x = np.concatenate([_rand(6, 200, scale=5.0),
                        np.array([-100.0, -30.0, -1e-3, 0.0, 1e-3, 19.0,
                                  20.0, 21.0, 30.0, 100.0], np.float32)])
    got = mamba_t.softplus(_t(x))
    want = jax.nn.softplus(jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


# -------------------------------------------------------------- ssm branch
def _ssm_params(seed):
    cfg = HYMBA
    p = jax.tree.map(np.asarray, mamba_j.init_ssm(
        jax.random.PRNGKey(seed), cfg.d_model, cfg.ssm, jnp.float32))
    p = _redraw(p, ("conv_b", "a_log", "dt_bias", "d_skip"), 100 + seed)
    p["dt_bias"] = p["dt_bias"] - 1.0
    p["norm_scale"] = p["norm_scale"] + 1.0
    return p


def test_init_ssm_layout_matches_the_reference():
    cfg = HYMBA
    for dtype, jdt in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
        got = mamba_t.init_ssm(torch.Generator().manual_seed(0),
                               cfg.d_model, cfg.ssm, dtype)
        ref = jax.eval_shape(lambda k: mamba_j.init_ssm(
            k, cfg.d_model, cfg.ssm, jdt), jax.random.PRNGKey(0))
        assert _shapes(got) == jax.tree.map(
            lambda a: (tuple(a.shape), str(a.dtype)), ref)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_causal_depthwise_conv(dtype):
    c = 40
    x, w, b = _rand(7, B, 9, c), _rand(8, mamba_t.CONV_WIDTH, c), \
        _rand(9, c)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    got = mamba_t._causal_depthwise_conv(_t(x, tdt), _t(w, tdt), _t(b, tdt))
    want = mamba_j._causal_depthwise_conv(*(jnp.asarray(a, dtype)
                                            for a in (x, w, b)))
    assert got.dtype == tdt
    if dtype == jnp.float32:
        _close(got, want, 1e-6)
        return
    # bf16: the port rounds each of the 4 tap products, 3 partial sums, the
    # bias add and silu (9 half-ULPs of at most M = sum |x w| + |b|, silu's
    # slope below 1.1), the reference may fuse them and round once (one
    # ULP): within 6 ULPs of M.
    xb, wb, bb = (np.asarray(_t(a, tdt).float()) for a in (x, w, b))
    pad = np.pad(np.abs(xb), ((0, 0), (mamba_t.CONV_WIDTH - 1, 0), (0, 0)))
    m = sum(pad[:, k: k + xb.shape[1]] * np.abs(wb[k])
            for k in range(mamba_t.CONV_WIDTH)) + np.abs(bb)
    ulp = np.exp2(np.floor(np.log2(np.maximum(m, 2.0 ** -126))) - 7)
    diff = np.abs(got.float().numpy() - np.asarray(want, np.float32))
    assert (diff <= 6 * ulp).all(), float(np.max(diff / ulp))


@pytest.mark.parametrize("seq", [16, 48])
def test_apply_ssm(seq):
    cfg = HYMBA
    pt, pj = _both(_ssm_params(1))
    x = _rand(10, B, seq, cfg.d_model)
    got = mamba_t.apply_ssm(pt, _t(x), d_model=cfg.d_model, ssm_cfg=cfg.ssm)
    want = mamba_j.apply_ssm(pj, jnp.asarray(x), d_model=cfg.d_model,
                             ssm_cfg=get_config_j("hymba-1.5b").reduced().ssm)
    assert got.shape == (B, seq, cfg.d_model)
    _close(got, want, 2e-5)


def test_decode_ssm_steps_and_cache():
    """Six steps from a zero cache: outputs against the reference's, the
    cache written in place and equal to the reference's new cache."""
    cfg = HYMBA
    ssm_j = get_config_j("hymba-1.5b").reduced().ssm
    pt, pj = _both(_ssm_params(2))
    cache_t = mamba_t.init_ssm_cache(B, cfg.d_model, cfg.ssm)
    cache_j = mamba_j.init_ssm_cache(B, cfg.d_model, ssm_j)
    assert _shapes(cache_t) == jax.tree.map(
        lambda a: (tuple(a.shape), str(a.dtype)), cache_j)
    conv, state = cache_t["conv"], cache_t["state"]
    for step in range(6):
        x = _rand(20 + step, B, cfg.d_model)
        got, cache_t = mamba_t.decode_ssm(pt, _t(x), cache_t,
                                          d_model=cfg.d_model,
                                          ssm_cfg=cfg.ssm)
        want, cache_j = mamba_j.decode_ssm(pj, jnp.asarray(x), cache_j,
                                           d_model=cfg.d_model,
                                           ssm_cfg=ssm_j)
        _close(got, want, 2e-5)
    assert cache_t["conv"] is conv and cache_t["state"] is state
    _close(conv, cache_j["conv"], 1e-6)
    _close_scaled(state, cache_j["state"], 1e-5)


def test_apply_ssm_equals_stepped_decode():
    """Within the port: the chunked prefill branch over 32 tokens against
    32 decode steps (f32 throughout, so only summation order differs)."""
    cfg = HYMBA
    pt, _ = _both(_ssm_params(3))
    x = _t(_rand(30, B, 32, cfg.d_model))
    full = mamba_t.apply_ssm(pt, x, d_model=cfg.d_model, ssm_cfg=cfg.ssm)
    cache = mamba_t.init_ssm_cache(B, cfg.d_model, cfg.ssm)
    steps = [mamba_t.decode_ssm(pt, x[:, i], cache, d_model=cfg.d_model,
                                ssm_cfg=cfg.ssm)[0] for i in range(32)]
    _close(torch.stack(steps, 1), full, 2e-5)


# --------------------------------------------------------------- rwkv6
def _tm_params(seed):
    cfg = RWKV
    p = jax.tree.map(np.asarray, rwkv_j.init_time_mix(
        jax.random.PRNGKey(seed), cfg.d_model, cfg.rwkv, jnp.float32))
    p = _redraw(p, ("mu_x", "mu", "bonus_u", "ln_bias"), 200 + seed)
    p["decay_base"] = p["decay_base"] + _rand(210 + seed, cfg.d_model)
    p["ln_scale"] = p["ln_scale"] + _rand(220 + seed, cfg.d_model,
                                          scale=0.2)
    return p


def _cm_params(seed):
    cfg = RWKV
    p = jax.tree.map(np.asarray, rwkv_j.init_channel_mix(
        jax.random.PRNGKey(seed), cfg.d_model, cfg.d_ff, jnp.float32))
    return _redraw(p, ("mu_k", "mu_r"), 300 + seed)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_rwkv_init_layout_matches_the_reference(dtype):
    cfg = RWKV
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    gen = torch.Generator().manual_seed(0)
    got = {"tm": rwkv_t.init_time_mix(gen, cfg.d_model, cfg.rwkv, dtype),
           "cm": rwkv_t.init_channel_mix(gen, cfg.d_model, cfg.d_ff, dtype)}
    ref = jax.eval_shape(lambda k: {
        "tm": rwkv_j.init_time_mix(k, cfg.d_model, cfg.rwkv, jdt),
        "cm": rwkv_j.init_channel_mix(k, cfg.d_model, cfg.d_ff, jdt)},
        jax.random.PRNGKey(0))
    assert _shapes(got) == jax.tree.map(
        lambda a: (tuple(a.shape), str(a.dtype)), ref)


def test_shift_ddlerp_and_decay():
    cfg = RWKV
    pt, pj = _both(_tm_params(1))
    x = _rand(40, B, 7, cfg.d_model)
    np.testing.assert_array_equal(rwkv_t._shift(_t(x)).numpy(),
                                  np.asarray(rwkv_j._shift(jnp.asarray(x))))
    sx = np.asarray(rwkv_j._shift(jnp.asarray(x))) - x
    got = rwkv_t._ddlerp(pt, _t(x), _t(sx))
    want = rwkv_j._ddlerp(pj, jnp.asarray(x), jnp.asarray(sx))
    assert len(got) == 5
    for a, b in zip(got, want):
        _close(a, b, 1e-5)
    g = rwkv_t._decay(pt, got[0])
    assert g.dtype == torch.float32 and bool((g <= 0).all())
    _close(g, rwkv_j._decay(pj, want[0]), 1e-5)


@pytest.mark.parametrize("seq", [16, 48])
def test_apply_time_mix(seq):
    cfg = RWKV
    pt, pj = _both(_tm_params(2))
    x = _rand(50, B, seq, cfg.d_model)
    got = rwkv_t.apply_time_mix(pt, _t(x), n_heads=cfg.n_heads,
                                rwkv_cfg=cfg.rwkv)
    want = rwkv_j.apply_time_mix(pj, jnp.asarray(x), n_heads=cfg.n_heads,
                                 rwkv_cfg=get_config_j(
                                     "rwkv6-1.6b").reduced().rwkv)
    assert got.shape == (B, seq, cfg.d_model)
    _close(got, want, 2e-5)


def test_apply_channel_mix():
    cfg = RWKV
    pt, pj = _both(_cm_params(1))
    x = _rand(60, B, 9, cfg.d_model)
    _close(rwkv_t.apply_channel_mix(pt, _t(x)),
           rwkv_j.apply_channel_mix(pj, jnp.asarray(x)), 2e-5)


def test_decode_time_and_channel_mix_steps_and_cache():
    """Six steps of both mixes from a zero cache, as ``_decode_rwkv`` runs
    them: outputs against the reference's, the cache written in place and
    equal to the reference's new cache."""
    cfg = RWKV
    rcfg_j = get_config_j("rwkv6-1.6b").reduced().rwkv
    tmt, tmj = _both(_tm_params(3))
    cmt, cmj = _both(_cm_params(3))
    cache_t = rwkv_t.init_rwkv_cache(B, cfg.d_model, cfg.n_heads, cfg.rwkv)
    cache_j = rwkv_j.init_rwkv_cache(B, cfg.d_model, cfg.n_heads, rcfg_j)
    assert _shapes(cache_t) == jax.tree.map(
        lambda a: (tuple(a.shape), str(a.dtype)), cache_j)
    held = dict(cache_t)
    for step in range(6):
        x = _rand(70 + step, B, cfg.d_model)
        got, cache_t = rwkv_t.decode_time_mix(tmt, _t(x), cache_t,
                                              n_heads=cfg.n_heads,
                                              rwkv_cfg=cfg.rwkv)
        want, c_tm = rwkv_j.decode_time_mix(tmj, jnp.asarray(x), cache_j,
                                            n_heads=cfg.n_heads,
                                            rwkv_cfg=rcfg_j)
        _close(got, want, 2e-5)
        y = _rand(80 + step, B, cfg.d_model)
        got, cm_x = rwkv_t.decode_channel_mix(cmt, _t(y), cache_t)
        want, cm_j = rwkv_j.decode_channel_mix(cmj, jnp.asarray(y), c_tm)
        _close(got, want, 2e-5)
        assert cm_x is held["cm_x"]
        cache_j = {"tm_x": c_tm["tm_x"], "cm_x": cm_j, "wkv": c_tm["wkv"]}
    assert all(cache_t[k] is held[k] for k in held)
    _close(cache_t["tm_x"], cache_j["tm_x"], 1e-6)
    _close(cache_t["cm_x"], cache_j["cm_x"], 1e-6)
    _close_scaled(cache_t["wkv"], cache_j["wkv"], 1e-5)


def test_apply_time_mix_equals_stepped_decode():
    """Within the port: chunked prefill over 32 tokens against 32 decode
    steps of the time-mix (f32 throughout)."""
    cfg = RWKV
    pt, _ = _both(_tm_params(4))
    x = _t(_rand(90, B, 32, cfg.d_model))
    full = rwkv_t.apply_time_mix(pt, x, n_heads=cfg.n_heads,
                                 rwkv_cfg=cfg.rwkv)
    cache = rwkv_t.init_rwkv_cache(B, cfg.d_model, cfg.n_heads, cfg.rwkv)
    steps = [rwkv_t.decode_time_mix(pt, x[:, i], cache, n_heads=cfg.n_heads,
                                    rwkv_cfg=cfg.rwkv)[0] for i in range(32)]
    _close(torch.stack(steps, 1), full, 2e-5)



# ------------------------------------------------------------------- bf16
# The models run in bf16 on the card; here each mixed-dtype step is held to
# the reference's dtypes, and its values within 6 * 2^-8 * sqrt(R) * rms
# of the reference's output, R the bf16 roundings of the step at which the
# two packages may land on neighbouring values (XLA may fuse some away).
def _bf16_params(tree, init_j):
    """``tree`` (f32 numpy) with each leaf cast to the dtype the
    reference's bf16 initialiser ``init_j(key, dtype)`` gives it -> (torch
    tree, jax tree), the bf16 leaves bit for bit alike."""
    layout = jax.eval_shape(lambda k: init_j(k, jnp.bfloat16),
                            jax.random.PRNGKey(0))

    def cast(t, lay):
        if isinstance(t, dict):
            pairs = {k: cast(t[k], lay[k]) for k in t}
            return ({k: v[0] for k, v in pairs.items()},
                    {k: v[1] for k, v in pairs.items()})
        a = jnp.asarray(t, lay.dtype)
        return torch.from_numpy(np.array(a, np.float32)).to(
            torch.bfloat16 if lay.dtype == jnp.bfloat16 else
            torch.float32), a
    return cast(tree, layout)


def _bf16_within(got, want, r, dtype):
    """got's dtype is ``dtype`` (the reference's), and max |got - want| <=
    6 * 2^-8 * sqrt(r) * rms(want)."""
    assert str(got.dtype).replace("torch.", "") == str(want.dtype) == dtype
    w = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    err = np.abs(got.double().numpy() - w).max()
    tol = 6.0 * 2.0 ** -8 * np.sqrt(r) * np.sqrt((w * w).mean())
    assert err <= tol, (err, tol)


def _record_gla(monkeypatch, module, log):
    """Wrap ``module``'s ``chunked_gla`` and ``gla_decode`` to log the
    dtypes of the arrays each call is handed."""
    for name in ("chunked_gla", "gla_decode"):
        def wrapped(*args, _fn=getattr(module, name), _name=name, **kw):
            arrays = list(args) + [kw[k] for k in sorted(kw)
                                   if hasattr(kw[k], "dtype")]
            log.append((_name, [str(a.dtype).replace("torch.", "")
                                for a in arrays]))
            return _fn(*args, **kw)
        monkeypatch.setattr(module, name, wrapped)


def _ssm_bf16():
    cfg = HYMBA
    return _bf16_params(_ssm_params(5), lambda k, dt: mamba_j.init_ssm(
        k, cfg.d_model, cfg.ssm, dt))


def _tm_bf16():
    cfg = RWKV
    return _bf16_params(_tm_params(5), lambda k, dt: rwkv_j.init_time_mix(
        k, cfg.d_model, cfg.rwkv, dt))


def test_ddlerp_and_decay_bf16():
    """``_ddlerp`` stays in bf16 (R = 8: the mu_x product and sum, maa_w1,
    tanh, maa_w2, mu + mus, the sx product, the sum); ``_decay`` is f32,
    its log(-g) - omega (the LoRA, R = 3: two products and tanh) within
    the bound of the LoRA's rms."""
    cfg = RWKV
    pt, pj = _tm_bf16()
    x = jnp.asarray(_rand(41, B, 7, cfg.d_model), jnp.bfloat16)
    sx = rwkv_j._shift(x) - x
    xt, sxt = (torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
               for a in (x, sx))
    got, want = rwkv_t._ddlerp(pt, xt, sxt), rwkv_j._ddlerp(pj, x, sx)
    for a, b in zip(got, want):
        _bf16_within(a, b, 8, "bfloat16")
    g_t, g_j = rwkv_t._decay(pt, got[0]), rwkv_j._decay(pj, want[0])
    base = np.asarray(pj["decay_base"], np.float64)
    lora_j = np.log(-np.asarray(g_j, np.float64)) - base
    lora_t = (torch.log(-g_t.double()) - torch.from_numpy(base)).float()
    _bf16_within(lora_t, jnp.asarray(lora_j, jnp.float32), 3, "float32")
    assert g_t.dtype == torch.float32 and str(g_j.dtype) == "float32"


def test_apply_ssm_bf16(monkeypatch):
    """The SSM branch in bf16 (R = 15, the branch's count in
    ``PREFILL_ROUNDINGS``): bf16 out, and the GLA handed q, k in bf16 and
    v = xs * dt, g in f32, as the reference hands them."""
    cfg = HYMBA
    pt, pj = _ssm_bf16()
    x = jnp.asarray(_rand(11, B, 32, cfg.d_model), jnp.bfloat16)
    log_t, log_j = [], []
    _record_gla(monkeypatch, mamba_t, log_t)
    _record_gla(monkeypatch, mamba_j, log_j)
    got = mamba_t.apply_ssm(pt, torch.from_numpy(
        np.asarray(x, np.float32)).bfloat16(), d_model=cfg.d_model,
        ssm_cfg=cfg.ssm)
    want = mamba_j.apply_ssm(pj, x, d_model=cfg.d_model,
                             ssm_cfg=get_config_j("hymba-1.5b").reduced().ssm)
    assert log_t == log_j and log_t[0][1][2:4] == ["float32", "float32"]
    _bf16_within(got, want, 15, "bfloat16")


class _ConvLog:
    """A proxy of a module's array namespace (``torch`` in the port,
    ``jnp`` in the reference) that logs the dtypes of what each
    ``einsum`` is handed and of what each concatenation returns (the conv
    history), and passes everything else through."""

    def __init__(self, ns, log):
        self._ns, self._log = ns, log

    def __getattr__(self, name):
        return getattr(self._ns, name)

    def _dt(self, a):
        return str(a.dtype).replace("torch.", "")

    def einsum(self, spec, *ops):
        self._log.append(("einsum", spec, [self._dt(a) for a in ops]))
        return self._ns.einsum(spec, *ops)

    def _concat(self, name, arrays, *args, **kw):
        out = getattr(self._ns, name)(arrays, *args, **kw)
        self._log.append(("history", self._dt(out)))
        return out

    def cat(self, arrays, *args, **kw):
        return self._concat("cat", arrays, *args, **kw)

    def concatenate(self, arrays, *args, **kw):
        return self._concat("concatenate", arrays, *args, **kw)


def test_decode_ssm_bf16(monkeypatch):
    """Six bf16 steps from a zero cache: outputs (R = 15), the f32 conv
    history and state, the dtypes handed to ``gla_decode``, and the dtypes
    of the conv history and of the conv's ``einsum`` operands (f32 in the
    reference: a conv run in bf16 would fit the bf16 bounds), against the
    reference's."""
    cfg = HYMBA
    ssm_j = get_config_j("hymba-1.5b").reduced().ssm
    pt, pj = _ssm_bf16()
    cache_t = mamba_t.init_ssm_cache(B, cfg.d_model, cfg.ssm)
    cache_j = mamba_j.init_ssm_cache(B, cfg.d_model, ssm_j)
    log_t, log_j = [], []
    _record_gla(monkeypatch, mamba_t, log_t)
    _record_gla(monkeypatch, mamba_j, log_j)
    conv_t, conv_j = [], []
    monkeypatch.setattr(mamba_t, "torch", _ConvLog(torch, conv_t))
    monkeypatch.setattr(mamba_j, "jnp", _ConvLog(jnp, conv_j))
    for step in range(6):
        x = jnp.asarray(_rand(25 + step, B, cfg.d_model), jnp.bfloat16)
        got, cache_t = mamba_t.decode_ssm(
            pt, torch.from_numpy(np.asarray(x, np.float32)).bfloat16(),
            cache_t, d_model=cfg.d_model, ssm_cfg=cfg.ssm)
        want, cache_j = mamba_j.decode_ssm(pj, x, cache_j,
                                           d_model=cfg.d_model,
                                           ssm_cfg=ssm_j)
        _bf16_within(got, want, 15, "bfloat16")
    assert log_t == log_j
    assert conv_t == conv_j and conv_t[:2] == [
        ("history", "float32"),
        ("einsum", "bwc,wc->bc", ["float32", "float32"])], conv_t[:2]
    assert len(conv_t) == 12
    _bf16_within(cache_t["conv"], cache_j["conv"], 15, "float32")
    _bf16_within(cache_t["state"], cache_j["state"], 15, "float32")


def test_apply_time_mix_bf16(monkeypatch):
    """The time-mix in bf16 (R = 35, its count in ``PREFILL_ROUNDINGS``),
    the GLA handed r, k, v in bf16 and g in f32 as the reference hands
    them; the channel-mix (R = 13) beside it."""
    cfg = RWKV
    pt, pj = _tm_bf16()
    x = jnp.asarray(_rand(51, B, 32, cfg.d_model), jnp.bfloat16)
    xt = torch.from_numpy(np.asarray(x, np.float32)).bfloat16()
    log_t, log_j = [], []
    _record_gla(monkeypatch, rwkv_t, log_t)
    _record_gla(monkeypatch, rwkv_j, log_j)
    got = rwkv_t.apply_time_mix(pt, xt, n_heads=cfg.n_heads,
                                rwkv_cfg=cfg.rwkv)
    want = rwkv_j.apply_time_mix(pj, x, n_heads=cfg.n_heads,
                                 rwkv_cfg=get_config_j(
                                     "rwkv6-1.6b").reduced().rwkv)
    assert log_t == log_j and log_t[0][1][3] == "float32"
    _bf16_within(got, want, 35, "bfloat16")
    cmt, cmj = _bf16_params(_cm_params(5), lambda k, dt: (
        rwkv_j.init_channel_mix(k, cfg.d_model, cfg.d_ff, dt)))
    _bf16_within(rwkv_t.apply_channel_mix(cmt, xt),
                 rwkv_j.apply_channel_mix(cmj, x), 13, "bfloat16")


def test_decode_time_and_channel_mix_bf16(monkeypatch):
    """Six bf16 steps of both mixes from a zero cache: outputs, the f32
    token shifts and wkv state, and the dtypes handed to ``gla_decode``,
    against the reference's."""
    cfg = RWKV
    rcfg_j = get_config_j("rwkv6-1.6b").reduced().rwkv
    tmt, tmj = _tm_bf16()
    cmt, cmj = _bf16_params(_cm_params(6), lambda k, dt: (
        rwkv_j.init_channel_mix(k, cfg.d_model, cfg.d_ff, dt)))
    cache_t = rwkv_t.init_rwkv_cache(B, cfg.d_model, cfg.n_heads, cfg.rwkv)
    cache_j = rwkv_j.init_rwkv_cache(B, cfg.d_model, cfg.n_heads, rcfg_j)
    log_t, log_j = [], []
    _record_gla(monkeypatch, rwkv_t, log_t)
    _record_gla(monkeypatch, rwkv_j, log_j)
    bf = lambda a: torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
    for step in range(6):
        x = jnp.asarray(_rand(75 + step, B, cfg.d_model), jnp.bfloat16)
        got, cache_t = rwkv_t.decode_time_mix(tmt, bf(x), cache_t,
                                              n_heads=cfg.n_heads,
                                              rwkv_cfg=cfg.rwkv)
        want, c_tm = rwkv_j.decode_time_mix(tmj, x, cache_j,
                                            n_heads=cfg.n_heads,
                                            rwkv_cfg=rcfg_j)
        _bf16_within(got, want, 35, "bfloat16")
        y = jnp.asarray(_rand(85 + step, B, cfg.d_model), jnp.bfloat16)
        got, _ = rwkv_t.decode_channel_mix(cmt, bf(y), cache_t)
        want, cm_j = rwkv_j.decode_channel_mix(cmj, y, c_tm)
        _bf16_within(got, want, 13, "bfloat16")
        cache_j = {"tm_x": c_tm["tm_x"], "cm_x": cm_j, "wkv": c_tm["wkv"]}
    assert log_t == log_j
    for name in ("tm_x", "cm_x", "wkv"):
        _bf16_within(cache_t[name], cache_j[name], 35, "float32")
