"""Port parity, the moe family's layers: routed MoE (``models.moe``) and
Multi-head Latent Attention (``models.mla``) — ``repro_torch`` on the CPU
against ``repro`` on the same inputs.

Inputs are seeded numpy draws handed to both packages; params are the
reference's initialisers' draws carried across, the norm scales redrawn
as ``1 + 0.2 N`` so that a swap of two of them shows. Sizes are small
(d_model 64, 4-16 experts of width 32, 4 heads).

Tolerances and why:
  * routing is a selection: expert indices, dispatch positions and
    ``keep`` bit for bit, and the inputs are checked to route clear of
    near-ties: every token's k-th router logit exceeds its (k+1)-th by more
    than the router's f32 rounding, ``d * 2^-24 * sum_i |x_i w_i|`` (the
    worst case of a d-term f32 dot product summed in another order), so
    that both packages must pick the same experts;
  * f32 values: ``K * 2^-24 * max|y|``, K the sum of the contraction
    lengths on the value's path (each a sum XLA and PyTorch may take in
    another order, a rounding of relative 2^-24 at each of at most K
    steps): the router (d), the softmax (E), the gate renormalisation (k),
    the expert products (d, d_e, then k), the shared branch (d, d_s); for
    MLA the latent and query projections (d, the ranks), the heads' dot
    products (dn + dr), the softmax and weighted sum (S each) and the
    output projection (H * dv);
  * bf16 values: ``6 * 2^-8 * sqrt(R) * rms(y)``, R the bf16 roundings on
    the path at which the two packages may land on neighbouring values (a
    relative 2^-8 each, independent, six standard deviations), as
    ``tests/test_torch_models.py``'s bf16 bounds: the MoE's up, gate,
    silu, gated product, down and combine, the shared branch's five and
    the add (R = 12); MLA's R = 14 (``MLA_ROUNDINGS``);
  * the port's absorbed MLA decode against its own expanded prefill, f32:
    the same function summed in other orders, within the f32 bound above
    with K over both paths' contractions; the bound rejects a decode whose
    rope key is left zero.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MLAConfig as MLAConfigJ
from repro.configs.base import MoEConfig as MoEConfigJ
from repro.models import mla as mla_j
from repro.models import moe as moe_j
from repro_torch import convert
from repro_torch.configs.base import MLAConfig, MoEConfig
from repro_torch.models import mla as mla_t
from repro_torch.models import moe as moe_t

torch.set_num_threads(1)

U, U16 = 2.0 ** -24, 2.0 ** -8
D = 64
MOE_ROUNDINGS = 12
MLA_ROUNDINGS = 14
#: (experts, top-k, capacity factor, shared experts)
MOE_CASES = {"reduced": (4, 2, 2.0, 1), "no-shared": (4, 2, 2.0, 0),
             "drops": (8, 2, 0.5, 1), "wide": (16, 4, 1.25, 1)}
MLA = dict(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
           qk_rope_head_dim=8, v_head_dim=16)
HEADS, THETA = 4, 10000.0


def _rand(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)
            ).astype(np.float32)


def _mo(case, pkg):
    e, k, cf, shared = MOE_CASES[case]
    cls = MoEConfigJ if pkg == "jax" else MoEConfig
    return cls(n_experts=e, top_k=k, d_expert=32, n_shared=shared,
               d_shared=32, capacity_factor=cf)


@functools.lru_cache(maxsize=None)
def _moe_params(case, dtype, seed=0):
    """The reference's ``init_moe`` as numpy, in ``dtype`` (the
    reference's functions run under ``jax.jit`` here: the same ops,
    compiled once)."""
    dt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    init = jax.jit(functools.partial(moe_j.init_moe, d_model=D,
                                     mo=_mo(case, "jax"), dtype=dt))
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed)))


def _both(params_np):
    return (jax.tree.map(jnp.asarray, params_np),
            convert.model_params_to_torch(params_np, device="cpu"))


def _x(seed, shape, dtype):
    x = _rand(seed, *shape)
    xj = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16"
                               else jnp.float32)
    return xj, convert.model_params_to_torch({"x": np.asarray(xj)},
                                             device="cpu")["x"]


def _router_clear(p_np, x, k):
    """Every token's k-th router logit clear of its (k+1)-th by more than
    the router's f32 rounding ``d * 2^-24 * sum_i |x_i w_i|`` (largest
    over the experts); returns the smallest margin over that bound."""
    xt = np.asarray(jnp.asarray(x, jnp.float32), np.float64).reshape(-1, D)
    w = np.asarray(p_np["router"], np.float64)
    logits = xt @ w
    top = -np.sort(-logits, axis=1)
    margin = top[:, k - 1] - top[:, k]
    bound = D * U * (np.abs(xt)[:, :, None] * np.abs(w)[None]).sum(1).max(1)
    return float((margin / bound).min())


def _f32_tol(k, y):
    return k * U * float(np.abs(np.asarray(y, np.float64)).max())


def _bf16_tol(r, y):
    y = np.asarray(jnp.asarray(y, jnp.float32), np.float64)
    return 6 * U16 * math.sqrt(r) * float(np.sqrt((y * y).mean()))


def _diff(got, want):
    return float(np.abs(got.double().numpy() - np.asarray(
        jnp.asarray(want, jnp.float32), np.float64)).max())


def _moe_k(mo, t):
    """K of the MoE's output: the router (d), the softmax (E), the gate
    renormalisation (k), the expert products (d, d_e) and the combine
    (k), the shared branch (d, d_s)."""
    return D + mo.n_experts + 2 * mo.top_k + 2 * (D + mo.d_expert)


# -------------------------------------------------------------- dispatch
@pytest.mark.parametrize("t,e,k,cf", [(16, 4, 2, 2.0), (64, 8, 2, 0.5),
                                      (37, 16, 4, 0.5), (512, 64, 8, 1.25)])
def test_dispatch_positions_bit_for_bit(t, e, k, cf):
    """Positions and ``keep`` bit for bit from the same expert indices
    (each token's k distinct experts, skewed towards low indices so that
    some experts overflow), drops included: a capacity factor of 0.5
    drops on both sides (the skew drops some at 1.25 too)."""
    rng = np.random.default_rng(t + e)
    score = rng.normal(size=(t, e)) - 0.3 * np.arange(e)
    idx = np.argsort(-score, axis=1)[:, :k].astype(np.int32)
    cap = max(int(cf * t * k / e), k)
    pj, kj = moe_j._dispatch_positions(jnp.asarray(idx), e, cap)
    pt, kt = moe_t._dispatch_positions(torch.from_numpy(idx).long(), e, cap)
    assert pt.dtype == torch.int32
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    if cf < 1:
        assert not kt.all(), "a capacity factor of 0.5 drops"


def test_capacity_is_the_reference_formula():
    for case in MOE_CASES:
        mo = _mo(case, "torch")
        for t in (1, 2, 4, 12, 64, 8192):
            want = max(int(mo.capacity_factor * t * mo.top_k
                           / mo.n_experts), mo.top_k)
            assert moe_t.capacity(mo, t) == want


# ------------------------------------------------------------- _local_moe
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_local_moe_against_the_reference(case):
    """One shard's routing on the same tokens: expert indices, positions
    (the dropped at C - 1) and ``keep`` bit for bit, gates, aux and the
    dispatch buffer within the f32 bound."""
    mo_j, mo_t = _mo(case, "jax"), _mo(case, "torch")
    p_np = _moe_params(case, "float32")
    pj, pt = _both(p_np)
    xj, xt = _x(1, (48, D), "float32")
    assert _router_clear(p_np, xj, mo_t.top_k) > 1
    cap = moe_t.capacity(mo_t, 48)
    dj, cj, ej, pij, auxj = jax.jit(functools.partial(
        moe_j._local_moe, mo=mo_j, act="swiglu", capacity=cap))(pj, xj)
    dt, ct, et, pit, keep, auxt = moe_t._local_moe(pt, xt, mo_t, cap)
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    np.testing.assert_array_equal(pit.numpy(), np.asarray(pij))
    _, kj = moe_j._dispatch_positions(ej, mo_j.n_experts, cap)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(kj))
    if mo_t.capacity_factor < 1:
        assert not keep.all(), "a capacity factor of 0.5 drops"
    k = _moe_k(mo_t, 48)
    assert _diff(ct, cj) <= _f32_tol(k, cj)
    assert _diff(auxt, auxj) <= _f32_tol(k + 48, auxj)
    assert _diff(dt, dj) == 0.0              # rows copied, zeros added
    # the dropped count as the port's helper reports it
    assert moe_t.dropped_tokens(pt, xt[None], mo_t) == int((~keep).sum())


# -------------------------------------------------------------- apply_moe
def _apply_j(mo_j):
    return jax.jit(functools.partial(moe_j.apply_moe, mo=mo_j, act="swiglu"))


def _apply(case, dtype, seed=2, shape=(2, 24)):
    mo_j, mo_t = _mo(case, "jax"), _mo(case, "torch")
    p_np = _moe_params(case, dtype)
    pj, pt = _both(p_np)
    xj, xt = _x(seed, shape + (D,), dtype)
    assert _router_clear(p_np, xj, mo_t.top_k) > 1
    yj, aj = _apply_j(mo_j)(pj, xj)
    yt, at = moe_t.apply_moe(pt, xt, mo=mo_t, act="swiglu")
    return mo_t, (yj, aj), (yt, at), (pj, pt, xj, xt)


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_apply_moe_f32(case):
    mo, (yj, aj), (yt, at), _ = _apply(case, "float32")
    assert yt.dtype == torch.float32 and yt.shape == (2, 24, D)
    assert at.dtype == torch.float32 and at.shape == ()
    k = _moe_k(mo, 48)
    assert _diff(yt, yj) <= _f32_tol(k, yj)
    assert _diff(at, aj) <= _f32_tol(k + 48, aj)


@pytest.mark.parametrize("case", ["reduced", "no-shared", "drops"])
def test_apply_moe_bf16(case):
    """bf16 in, bf16 out (the expert products emit bf16), aux f32."""
    mo, (yj, aj), (yt, at), _ = _apply(case, "bfloat16")
    assert yt.dtype == torch.bfloat16 and at.dtype == torch.float32
    assert _diff(yt, yj) <= _bf16_tol(MOE_ROUNDINGS, yj)
    assert _diff(at, aj) <= _f32_tol(_moe_k(mo, 48) + 48, aj)


@pytest.mark.parametrize("case", ["reduced", "drops"])
def test_apply_moe_grads_f32(case):
    """A seeded cotangent on the output plus the aux: the gradient of x
    and of every param against ``jax.grad`` (dropped tokens get none
    through the experts, on both sides)."""
    mo, _, _, (pj, pt, xj, xt) = _apply(case, "float32")
    mo_j = _mo(case, "jax")
    ct = _rand(9, 2, 24, D)

    def loss_j(p, x):
        y, a = moe_j.apply_moe(p, x, mo=mo_j, act="swiglu")
        return jnp.sum(y * ct) + 3.0 * a

    gj = jax.jit(jax.grad(loss_j, argnums=(0, 1)))(pj, xj)
    leaves = [(k, v.requires_grad_(True)) for k, v in
              sorted(_flat(pt).items())] + [("x", xt.requires_grad_(True))]
    y, a = moe_t.apply_moe(pt, xt, mo=mo, act="swiglu")
    loss = torch.sum(y * torch.from_numpy(ct)) + 3.0 * a
    grads = torch.autograd.grad(loss, [v for _, v in leaves])
    want = dict(_flat(gj[0]), x=gj[1])
    k = _moe_k(mo, 48) + 48                 # weight grads sum over tokens
    for (name, _), g in zip(leaves, grads):
        assert _diff(g, want[name]) <= _f32_tol(k, want[name]), name


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def test_moe_backward_is_deterministic_with_drops():
    """Forced drops (their zeroed rows added into their experts' last
    slots): two backward passes give the same bits."""
    mo, _, _, (_, pt, _, xt) = _apply("drops", "float32")
    runs = []
    for _ in range(2):
        x = xt.clone().requires_grad_(True)
        y, a = moe_t.apply_moe(pt, x, mo=mo, act="swiglu")
        runs.append(torch.autograd.grad(y.sum() + a, x)[0])
    assert torch.equal(runs[0], runs[1])


# -------------------------------------------------------------------- MLA
@functools.lru_cache(maxsize=None)
def _mla_params(dtype, seed=4):
    dt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    init = jax.jit(functools.partial(mla_j.init_mla, d_model=D,
                                     n_heads=HEADS, m=MLAConfigJ(**MLA),
                                     dtype=dt))
    p = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed)))
    for i, name in enumerate(("q_norm", "kv_norm")):
        p[name] = (1.0 + _rand(40 + i, *p[name].shape, scale=0.2))
    return p


def _mla_k(s):
    """K of MLA's output: the projections (d, q_lora, kv_lora), the heads'
    dot products (dn + dr), the softmax and the weighted sum (S each),
    the absorbed decode's folds (dn, kv_lora) and the output (H * dv)."""
    m = MLA
    return (D + m["q_lora_rank"] + 2 * m["kv_lora_rank"]
            + 2 * m["qk_nope_head_dim"] + m["qk_rope_head_dim"] + 2 * s
            + HEADS * m["v_head_dim"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mla_against_the_reference(dtype):
    pj, pt = _both(_mla_params(dtype))
    xj, xt = _x(5, (2, 12, D), dtype)
    pos = np.arange(12)
    yj = jax.jit(functools.partial(
        mla_j.apply_mla, n_heads=HEADS, m=MLAConfigJ(**MLA), theta=THETA))(
        pj, xj, positions=jnp.asarray(pos))
    yt = mla_t.apply_mla(pt, xt, n_heads=HEADS, m=MLAConfig(**MLA),
                         theta=THETA, positions=torch.from_numpy(pos))
    assert yt.dtype == xt.dtype and yt.shape == (2, 12, D)
    tol = (_f32_tol(_mla_k(12), yj) if dtype == "float32"
           else _bf16_tol(MLA_ROUNDINGS, yj))
    assert _diff(yt, yj) <= tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_mla_against_the_reference(dtype):
    """One absorbed decode step at position 7 of a cache of 10 whose first
    7 entries are seeded: the output and both cache leaves (the new entry
    written in place, the rest untouched)."""
    pj, pt = _both(_mla_params(dtype))
    xj, xt = _x(6, (2, D), dtype)
    cache_np = {"c_kv": _rand(7, 2, 10, 16), "k_rope": _rand(8, 2, 10, 8)}
    for leaf in cache_np.values():
        leaf[:, 7:] = 0.0
    cj = jax.tree.map(lambda a: jnp.asarray(a).astype(xj.dtype), cache_np)
    ct = convert.model_params_to_torch(jax.tree.map(np.asarray, cj),
                                       device="cpu")
    before = {k: v.clone() for k, v in ct.items()}
    yj, newj = jax.jit(functools.partial(
        mla_j.decode_mla, n_heads=HEADS, m=MLAConfigJ(**MLA), theta=THETA))(
        pj, xj, cj, 7)
    yt, newt = mla_t.decode_mla(pt, xt, ct, 7, n_heads=HEADS,
                                m=MLAConfig(**MLA), theta=THETA)
    assert newt is ct and yt.dtype == xt.dtype
    f32 = dtype == "float32"
    tol = _f32_tol(_mla_k(10), yj) if f32 else _bf16_tol(MLA_ROUNDINGS, yj)
    assert _diff(yt, yj) <= tol
    for name in ("c_kv", "k_rope"):
        got, want = newt[name], newj[name]
        keep = [i for i in range(10) if i != 7]
        assert torch.equal(got[:, keep], before[name][:, keep])
        tol = (_f32_tol(D + 8, want) if f32
               else _bf16_tol(4, want))          # wkv_a, norm, rope, cast
        assert _diff(got[:, 7], want[:, 7]) <= tol, name


def _stepped_mla(pt, xt, dtype, rope_fault=False):
    """The port's absorbed decode over every position of xt [B, S, d] on
    an f32 cache; with ``rope_fault`` the new rope key is never written."""
    b, s, _ = xt.shape
    m = MLAConfig(**MLA)
    cache = mla_t.init_mla_cache(b, s, m, torch.float32)
    outs = []
    for pos in range(s):
        if rope_fault:
            saved = cache["k_rope"].clone()
        y, _ = mla_t.decode_mla(pt, xt[:, pos], cache, pos, n_heads=HEADS,
                                m=m, theta=THETA)
        if rope_fault:
            cache["k_rope"].copy_(saved)
        outs.append(y)
    return torch.stack(outs, 1)


def test_absorbed_decode_matches_the_expanded_prefill():
    """f32: the port's stepped absorbed decode against its own expanded
    ``apply_mla`` at every position, within the f32 bound over both
    paths' contractions; a decode that leaves the rope key zero fails
    it."""
    _, pt = _both(_mla_params("float32", seed=11))
    x = torch.from_numpy(_rand(12, 2, 16, D))
    with torch.no_grad():
        want = mla_t.apply_mla(pt, x, n_heads=HEADS, m=MLAConfig(**MLA),
                               theta=THETA, positions=torch.arange(16))
        got = _stepped_mla(pt, x, "float32")
        bad = _stepped_mla(pt, x, "float32", rope_fault=True)
    tol = _f32_tol(2 * _mla_k(16), want.numpy())
    assert float((got - want).abs().max()) <= tol
    assert float((bad - want).abs().max()) > 100 * tol
