"""Port parity, the dense model stack: configs, layers, attention, the
``Model``'s prefill and KV-cache decode, the params converter and the serve
CLI — ``repro_torch`` on the CPU against ``repro`` on the same inputs.

Inputs are seeded numpy draws handed to both packages; model params are the
reference's ``Model.init`` carried across by ``convert.model_params_to_torch``.
Every size is reduced (2-4 layers, d_model <= 256, vocab <= 2048).

Tolerances and why. Both sides compute in f32 with the same op sequence;
XLA and PyTorch differ only in the order they sum a dot product, a mean or
a softmax, an error of order sqrt(n) * 2^-24 of the result's scale for an
n-term sum (n <= 256 here, so ~1e-6):
  * elementwise work: ``1e-6`` for the norm; ``1e-5`` for RoPE, whose
    angles (up to 40 rad here) carry 40 * 2^-24 ~ 2.4e-6 of argument
    rounding into cos and sin, computed by each package's own routine;
  * one attention or MLP call (a few sums of <= 256 terms, outputs of scale
    ~1): ``2e-5``;
  * a reduced model's logits (two layers and the vocab projection, logits
    of scale ~1, a few dozen sums deep): ``1e-4``; its KV cache ``1e-5``;
  * bf16 outputs: one bf16 ULP at the compared magnitude (``2^-7`` at
    magnitudes below 2), as each side rounds its own f32 result once;
  * greedy tokens agree wherever the reference's top-2 logit margin exceeds
    twice the logit tolerance (a nearer pair may legitimately swap); both
    sides are then fed the reference's token, so a tie cannot derail the
    rest of the sequence;
  * bf16 ``prefill`` against the stepped decode, within one package: the
    rounding-count bound ``6 * 2^-8 * sqrt(L * R) * rms(logits)`` that
    ``chip_smoke.py`` holds the full-width models to, with R the bf16
    roundings a layer at which the two paths may land on neighbouring
    values: 17 for the dense family, 35 for hybrid, 48 for ssm (counted at
    ``PREFILL_ROUNDINGS``); the same bound holds the bf16 recurrent models
    to the reference's;
  * f32 ``prefill`` against the stepped decode, within one package:
    ``6 * 2^-24 * sqrt(L * R * K) * rms(logits)``, K = d_ff, each of the R
    sites now up to sqrt(K) f32 roundings of a sum taken in another order;
  * the recurrent families (hymba, rwkv6) use the same logit tolerance:
    their extra f32 work (a chunked GLA of c + Dk roundings a term, c = 16)
    sits at the same depth of sums. Their states sum up to 40 steps of
    products and are compared at ``1e-5`` of their largest magnitude.
"""
import dataclasses
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as SHAPES_J
from repro.configs import get_config as get_config_j
from repro.models import attention as attn_j
from repro.models import layers as layers_j
from repro.models.transformer import Model as ModelJ
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch import serve
from repro_torch.models import Model
from repro_torch.models import attention as attn_t
from repro_torch.models import layers as layers_t
from repro_torch.tree import tree_from_items, tree_items

torch.set_num_threads(1)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
DENSE = ("stablelm-1.6b", "yi-9b", "qwen2.5-14b")
RECURRENT = ("hymba-1.5b", "rwkv6-1.6b")
CROSS = ("whisper-medium", "llama-3.2-vision-11b")
MOE = ("deepseek-v3-671b", "kimi-k2-1t-a32b")
#: vlm's cross gates, set non-zero on both sides: at the reference's init
#: (zeros) every cross block is the identity
VLM_GATES = {"gate_attn": 0.7, "gate_mlp": -0.4}
LOGIT_TOL = 1e-4


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


def _bf16_close(got, want):
    """Within one bf16 ULP of the larger magnitude (2^-7 below 2)."""
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.maximum(np.abs(g),
                                                         np.abs(w)),
                                              2.0 ** -126))) - 7)
    assert (np.abs(g - w) <= ulp).all(), float(np.max(np.abs(g - w) / ulp))


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_match_the_reference(arch):
    full, full_j = get_config(arch), get_config_j(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(full_j)
    assert dataclasses.asdict(full.reduced()) == \
        dataclasses.asdict(full_j.reduced())
    assert full.n_params() == full_j.n_params()
    assert full.n_active_params() == full_j.n_active_params()
    assert full.resolved_head_dim == full_j.resolved_head_dim


def test_shapes_match_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in SHAPES_J.items()}


def test_stablelm_full_width_is_the_published_config():
    cfg = get_config("stablelm-1.6b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size, cfg.dtype) == \
        (24, 2048, 32, 32, 64, 5632, 100352, "bfloat16")
    assert 1.6e9 < cfg.n_params() < 1.7e9


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_rms_norm(dtype):
    x, s = _rand(0, 3, 5, 64), _rand(1, 64) + 1.0
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    got = layers_t.rms_norm(_t(x, tdt), _t(s), 1e-5)
    want = layers_j.rms_norm(jnp.asarray(x, dtype), jnp.asarray(s), 1e-5)
    assert got.dtype == tdt
    if dtype == jnp.float32:
        _close(got, want, 1e-6)
    else:
        _bf16_close(got, want)


@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_apply_rope_sequence_positions(theta):
    x = _rand(2, 2, 9, 4, 16, scale=2.0)                # [B, S, H, D]
    pos = np.arange(9) + 3
    got = layers_t.apply_rope(_t(x), torch.as_tensor(pos), theta)
    want = layers_j.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    _close(got, want, 1e-5)


def test_apply_rope_scalar_position():
    x = _rand(3, 2, 4, 16)                               # [B, H, D]: decode
    got = layers_t.apply_rope(_t(x), torch.tensor(37), 10000.0)
    want = layers_j.apply_rope(jnp.asarray(x), jnp.asarray(37), 10000.0)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_apply_mlp(act):
    x = _rand(4, 2, 5, 64)
    p = {"w_up": _rand(5, 64, 128, scale=0.125),
         "w_down": _rand(6, 128, 64, scale=0.09)}
    if act == "swiglu":
        p["w_gate"] = _rand(7, 64, 128, scale=0.125)
    got = layers_t.apply_mlp({k: _t(v) for k, v in p.items()}, _t(x), act)
    want = layers_j.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), act)
    _close(got, want, 2e-5)


def test_mm_bf16_rounds_once():
    """bf16 x bf16 -> bf16, accumulated in f32 and rounded once: within
    one bf16 ULP of the reference's bf16-out dot."""
    a, b = _rand(8, 6, 64), _rand(9, 64, 32, scale=0.125)
    got = layers_t.mm(_t(a, torch.bfloat16), _t(b, torch.bfloat16))
    want = layers_j.mm(jnp.asarray(a, jnp.bfloat16),
                       jnp.asarray(b, jnp.bfloat16))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _bf16_close(got, want)


def test_embed_lookup():
    table = _rand(10, 256, 16)
    toks = np.array([[0, 5, 255], [7, 7, 1]])
    np.testing.assert_array_equal(
        layers_t.embed_lookup(_t(table), torch.as_tensor(toks)).numpy(),
        np.asarray(layers_j.embed_lookup(jnp.asarray(table),
                                         jnp.asarray(toks))))


@pytest.mark.parametrize("multiple", [None, 256])
def test_pad_vocab(multiple):
    kw = {} if multiple is None else {"multiple": multiple}
    for v in (1, 256, 257, 511, 512, 513, 100352, 151_000):
        assert layers_t.pad_vocab(v, **kw) == layers_j.pad_vocab(v, **kw)


# --------------------------------------------------------------- attention
ATTEND_CASES = [
    # (b, sq, sk, h, hkv, d, chunk, causal, window)
    (2, 16, 16, 4, 4, 16, 512, True, None),     # Sq <= chunk
    (1, 40, 40, 4, 4, 16, 16, True, None),      # Sq > chunk, padded to 48
    (2, 24, 24, 8, 2, 16, 8, True, None),       # GQA, chunked
    (1, 12, 20, 4, 2, 32, 512, False, None),    # bidirectional, Sq != Sk
    (1, 40, 40, 4, 2, 16, 16, True, 7),         # sliding window, chunked
]


@pytest.mark.parametrize("case", ATTEND_CASES, ids=str)
def test_attend(case):
    b, sq, sk, h, hkv, d, chunk, causal, window = case
    q, k, v = (_rand(11, b, sq, h, d), _rand(12, b, sk, hkv, d),
               _rand(13, b, sk, hkv, d))
    got = attn_t.attend(_t(q), _t(k), _t(v), causal=causal, window=window,
                        chunk=chunk)
    want = attn_j.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal, window=window, chunk=chunk)
    assert got.shape == (b, sq, h, d)
    _close(got, want, 2e-5)


def test_attend_bf16():
    q, k, v = (_rand(14, 1, 40, 4, 16), _rand(15, 1, 40, 2, 16),
               _rand(16, 1, 40, 2, 16))
    got = attn_t.attend(*(_t(a, torch.bfloat16) for a in (q, k, v)),
                        chunk=16)
    want = attn_j.attend(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                         chunk=16)
    assert got.dtype == torch.bfloat16
    _bf16_close(got, want)


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("pos", [0, 7])
def test_decode_attend(window, pos):
    """Slots past ``pos`` hold stale nonzero entries (as after a longer
    earlier sequence): both packages mask them to -1e9 before the softmax,
    so they add exactly zero."""
    q, kc, vc = (_rand(17, 2, 8, 16), _rand(18, 2, 12, 2, 16),
                 _rand(19, 2, 12, 2, 16))
    got = attn_t.decode_attend(_t(q), _t(kc), _t(vc), pos, window=window)
    want = attn_j.decode_attend(jnp.asarray(q), jnp.asarray(kc),
                                jnp.asarray(vc), pos, window=window)
    _close(got, want, 2e-5)
    # the stale slots do not matter: zeroing them changes nothing
    kz, vz = _t(kc), _t(vc)
    kz[:, pos + 1:] = 0
    vz[:, pos + 1:] = 0
    torch.testing.assert_close(
        attn_t.decode_attend(_t(q), kz, vz, pos, window=window), got,
        rtol=0, atol=0)


def _attn_params(cfg, seed):
    d, h, hkv, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                     cfg.resolved_head_dim)
    p = {"wq": _rand(seed, d, h * hd, scale=d ** -0.5),
         "wk": _rand(seed + 1, d, hkv * hd, scale=d ** -0.5),
         "wv": _rand(seed + 2, d, hkv * hd, scale=d ** -0.5),
         "wo": _rand(seed + 3, h * hd, d, scale=(h * hd) ** -0.5)}
    if cfg.qkv_bias:
        p.update(bq=_rand(seed + 4, h * hd, scale=0.1),
                 bk=_rand(seed + 5, hkv * hd, scale=0.1),
                 bv=_rand(seed + 6, hkv * hd, scale=0.1))
    return p


def test_dense_archs_cover_gqa_and_qkv_bias():
    cfgs = {a: get_config(a).reduced() for a in DENSE}
    assert cfgs["yi-9b"].n_kv_heads < cfgs["yi-9b"].n_heads
    assert cfgs["qwen2.5-14b"].qkv_bias
    assert cfgs["stablelm-1.6b"].n_kv_heads == cfgs["stablelm-1.6b"].n_heads


@pytest.mark.parametrize("arch", DENSE)
def test_self_attention(arch):
    cfg = get_config(arch).reduced()
    p = _attn_params(cfg, 20)
    x = _rand(30, 2, 11, cfg.d_model)
    pos = np.arange(11)
    got = attn_t.self_attention({k: _t(v) for k, v in p.items()}, _t(x),
                                cfg=cfg, positions=torch.as_tensor(pos),
                                chunk=4)
    want = attn_j.self_attention({k: jnp.asarray(v) for k, v in p.items()},
                                 jnp.asarray(x),
                                 cfg=get_config_j(arch).reduced(),
                                 positions=jnp.asarray(pos), chunk=4)
    _close(got, want, 2e-5)


@pytest.mark.parametrize("arch", DENSE)
def test_decode_self_attention(arch):
    cfg = get_config(arch).reduced()
    p = _attn_params(cfg, 40)
    shape = (2, 9, cfg.n_kv_heads, cfg.resolved_head_dim)
    kc, vc = _rand(50, *shape), _rand(51, *shape)
    x = _rand(52, 2, cfg.d_model)
    kt, vt = _t(kc), _t(vc)
    got, kt2, vt2 = attn_t.decode_self_attention(
        {k: _t(v) for k, v in p.items()}, _t(x), kt, vt, 5, cfg=cfg)
    want, kj, vj = attn_j.decode_self_attention(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        jnp.asarray(kc), jnp.asarray(vc), 5,
        cfg=get_config_j(arch).reduced())
    _close(got, want, 2e-5)
    assert kt2 is kt and vt2 is vt                 # written in place
    _close(kt, kj, 1e-5)
    _close(vt, vj, 1e-5)


# ------------------------------------------------------------------- model
def _redraw_constants(tree, seed=100):
    """Every float leaf of more than one element that the reference
    initialises to a constant c (norm scales and biases, the SSM's conv
    bias, A, dt bias and skip, RWKV's lerp weights, decay base and bonus)
    redrawn as c + 0.2 N (norm scales and skips, c = 1) or c + 0.5 N, in
    its dtype, so that every term they gate, and every swap of two such
    leaves, shows in the outputs."""
    out = {}
    for i, name in enumerate(sorted(tree)):
        leaf = tree[name]
        if isinstance(leaf, dict):
            out[name] = _redraw_constants(leaf, seed + 100 * (i + 1))
            continue
        flat = np.asarray(leaf, np.float32).ravel()
        if leaf.size > 1 and (flat == flat[0]).all():
            scale = 0.2 if flat[0] == 1.0 else 0.5
            leaf = (flat[0] + _rand(seed + i, *leaf.shape, scale=scale)
                    ).astype(leaf.dtype)
        out[name] = leaf
    return out


def _reference_params(cfg_j, seed):
    """The reference's init as numpy (what crosses to the port), biases
    made nonzero so the qkv_bias branch is exercised, for the recurrent
    and moe families every constant leaf redrawn (``_redraw_constants``),
    and vlm's cross gates set to ``VLM_GATES``."""
    params = jax.tree.map(np.asarray, ModelJ(cfg_j).init(
        jax.random.PRNGKey(seed)))
    if cfg_j.family == "vlm":
        cross = params["groups"]["cross"]
        for name, value in VLM_GATES.items():
            cross[name] = np.full(cross[name].shape, value, np.float32)
        return params
    attn = params.get("layers", {}).get("attn", {})
    for i, name in enumerate(("bq", "bk", "bv")):
        if name in attn:
            attn[name] = _rand(60 + i, *attn[name].shape, scale=0.1)
    if cfg_j.family in ("hybrid", "ssm", "moe"):
        params = _redraw_constants(params)
    return params


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _margin(logits, vocab):
    top2 = np.sort(np.asarray(logits, np.float32)[:, :vocab], axis=-1)
    return top2[:, -1] - top2[:, -2]


MODEL_CASES = {
    "stablelm-1.6b": {},
    "yi-9b": {},
    "qwen2.5-14b": {},
    "qwen2.5-32b": {},
    # the dense family's sliding window with a global layer (the reference
    # honours cfg.window per layer; no shipped dense config sets it)
    "stablelm-1.6b-window": {"window": 3, "global_layers": (1,)},
    # the recurrent families: a prompt of 32 (two GLA chunks of 16; the
    # reduced hybrid's window of 8 bites in its one windowed layer)
    "hymba-1.5b": {},
    "rwkv6-1.6b": {},
    # the cross-attention families: prefill with 10 frames (whisper) or
    # the config's 8 patches (vlm, gates non-zero); decode over zero cross
    # caches, as the reference serves them
    "whisper-medium": {},
    "llama-3.2-vision-11b": {},
    # the moe family: MLA with its latent-cache decode (deepseek) and GQA
    # (kimi), a dense block then a MoE block; prefill routes 12 tokens at
    # capacity 12 and decode 2 at capacity 2, so neither drops a token
    "deepseek-v3-671b": {},
    "kimi-k2-1t-a32b": {},
}


def _cross_inputs(cfg, b, seed=8):
    """The prefill batch's frames [B, 10, d] (encdec) or patches [B,
    n_patches, d_vision] (vlm) from seeded numpy; {} for other families."""
    if cfg.family == "encdec":
        return {"frames": _rand(seed, b, 10, cfg.d_model)}
    if cfg.family == "vlm":
        v = cfg.vision
        return {"patches": _rand(seed, b, v.n_patches, v.d_vision)}
    return {}


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_model_prefill_and_greedy_decode(case):
    arch = case.replace("-window", "")
    over = MODEL_CASES[case]
    cfg_j = dataclasses.replace(get_config_j(arch).reduced(), **over)
    cfg_t = dataclasses.replace(get_config(arch).reduced(), **over)
    params_np = _reference_params(cfg_j, 3)
    model_j, model_t = ModelJ(cfg_j), Model(cfg_t, device="cpu")
    params_t = convert.model_params_to_torch(params_np, device="cpu")
    params_j = jax.tree.map(jnp.asarray, params_np)
    b, gen = 2, 5
    prompt_len = 32 if arch in RECURRENT else 6
    prompt = np.random.default_rng(4).integers(0, cfg_j.vocab_size,
                                               (b, prompt_len))

    extra = _cross_inputs(cfg_j, b)
    want, _ = model_j.prefill(params_j, dict(
        {k: jnp.asarray(v) for k, v in extra.items()},
        tokens=jnp.asarray(prompt)))
    got, cache_none = model_t.prefill(params_t, dict(
        {k: torch.from_numpy(v) for k, v in extra.items()},
        tokens=torch.as_tensor(prompt)))
    assert cache_none is None and got.shape == (b, model_t.v_pad)
    _close(got, want, LOGIT_TOL)

    cache_j = model_j.init_cache(b, prompt_len + gen, jnp.float32)
    cache_t = model_t.init_cache(b, prompt_len + gen, torch.float32)
    step_j = jax.jit(model_j.decode_step)
    for pos in range(prompt_len):
        lj, cache_j = step_j(params_j, cache_j,
                             jnp.asarray(prompt[:, pos], jnp.int32),
                             jnp.int32(pos))
        lt, cache_t = model_t.decode_step(params_t, cache_t,
                                          torch.as_tensor(prompt[:, pos]),
                                          pos)
        _close(lt, lj, LOGIT_TOL)
    if not extra:
        # the last prompt step is the prefill (the cross families' decode
        # reads zero cross caches: tests/test_torch_cross.py fills them)
        _close(lt, got, LOGIT_TOL)
    for i in range(gen):
        tj = np.asarray(jnp.argmax(lj[:, :cfg_j.vocab_size], -1))
        tt = torch.argmax(lt[:, :cfg_j.vocab_size], -1).numpy()
        clear = _margin(lj, cfg_j.vocab_size) > 2 * LOGIT_TOL
        np.testing.assert_array_equal(tt[clear], tj[clear])
        lj, cache_j = step_j(params_j, cache_j, jnp.asarray(tj, jnp.int32),
                             jnp.int32(prompt_len + i))
        lt, cache_t = model_t.decode_step(params_t, cache_t,
                                          torch.from_numpy(tj.copy()),
                                          prompt_len + i)
        _close(lt, lj, LOGIT_TOL)
    flat_t, flat_j = _flat(cache_t), _flat(cache_j)
    assert set(flat_t) == set(flat_j)
    for name, leaf in flat_t.items():
        ref = np.asarray(flat_j[name])
        assert tuple(leaf.shape) == ref.shape
        assert str(leaf.dtype).replace("torch.", "") == str(ref.dtype)
        if name[-1] in ("state", "wkv"):     # recurrent sums of products
            err = float(np.abs(leaf.numpy() - ref).max())
            assert err <= 1e-5 * float(np.abs(ref).max()), name
        else:
            _close(leaf, ref, 1e-5)


def _bf16_tolerance(n_layers, logits, r=17):
    """6 * 2^-8 * sqrt(L * R) * rms(logits): R roundings to bf16 a layer
    (17 for the dense family) at which prefill and decode may land on
    neighbouring values (relative rms <= 2^-8 each), independent, carried
    to the logits at gain ~1; the largest of the compared logits stays
    within 6 of that rms."""
    rms = float(logits.float().pow(2).mean().sqrt())
    return 6.0 * 2.0 ** -8 * math.sqrt(n_layers * r) * rms


#: bf16 roundings a layer at which prefill and the stepped decode may land
#: on neighbouring values (``chip_smoke.py`` holds the full-width models to
#: the same counts). dense 17: two norms, q, k, v, RoPE on q and k, the
#: attention probabilities and output, wo, two residual adds, up, gate,
#: silu, the gated product, down. hybrid 35: those 17; the SSM branch's
#: in_proj, its prefill conv (4 tap products, 3 partial sums, the bias add,
#: silu: 9, which decode computes in f32 and rounds once), the f32 output's
#: cast, silu(z), the gated product, its rms_norm, out_proj (15); the two
#: output norms and their sum (3). ssm 48: time-mix 35 (ln1, shift - x,
#: the mu_x product and sum, maa_w1, tanh, maa_w2, five lerps of three
#: roundings each, the decay LoRA's two products and tanh, r, k, v, g,
#: silu, the wkv output's cast, the group norm, the gated product, wo, the
#: residual add), channel-mix 13 (ln2, shift - x, two products and two
#: sums of the lerps, wk, the square, wv, wr, sigmoid, the product, the
#: residual add).
PREFILL_ROUNDINGS = {"dense": 17, "hybrid": 35, "ssm": 48}


def _recurrent_4layer(arch, dtype):
    """A 4-layer recurrent model at d_model 256 and head size 64 (the
    reduced chunk of 16), with its params from seed 5."""
    base = get_config(arch).reduced()
    over = dict(n_layers=4, d_model=256, n_heads=4, head_dim=64, d_ff=704,
                vocab_size=2048, dtype=dtype)
    if base.rwkv is not None:
        over["rwkv"] = dataclasses.replace(base.rwkv, head_size=64)
    else:
        over["ssm"] = dataclasses.replace(base.ssm, head_dim=64)
    model = Model(dataclasses.replace(base, **over), device="cpu")
    return model, model.init(5)


@pytest.mark.parametrize("arch", RECURRENT)
def test_bf16_recurrent_prefill_matches_stepped_decode(arch):
    """As ``test_bf16_prefill_matches_stepped_decode``, for the recurrent
    families at 4 layers, d_model 256, head size 64 and a 64-token prompt
    (four GLA chunks of 16), within ``6 * 2^-8 * sqrt(L * R) *
    rms(logits)`` at the family's own R."""
    model, params = _recurrent_4layer(arch, "bfloat16")
    cfg = model.cfg
    prompt = torch.as_tensor(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 64)))
    res = serve.generate(model, params, prompt, 2)
    pf, _ = model.prefill(params, {"tokens": prompt})
    assert pf.dtype == torch.bfloat16 and res["tokens"].shape == (2, 2)
    dec = res["prompt_logits"][:, :cfg.vocab_size].float()
    pre = pf[:, :cfg.vocab_size].float()
    tol = _bf16_tolerance(cfg.n_layers, dec, PREFILL_ROUNDINGS[cfg.family])
    assert float((pre - dec).abs().max()) <= tol


@pytest.mark.parametrize("arch", RECURRENT)
def test_f32_recurrent_prefill_matches_stepped_decode(arch):
    """The bf16 params of the 4-layer model upcast to f32 (the same
    weights), an f32 cache: ``prefill`` against the stepped decode within
    ``6 * 2^-24 * sqrt(L * R * K) * rms(logits)``, K = d_ff, the bound
    ``chip_smoke.py`` holds the full-width models to (the paths differ only
    in summation order, up to sqrt(K) f32 roundings at each of R sites a
    layer)."""
    model, params = _recurrent_4layer(arch, "bfloat16")
    cfg = model.cfg
    p32 = tree_from_items([(k, t.float()) for k, t in tree_items(params)])
    prompt = torch.as_tensor(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 64)))
    res = serve.generate(model, p32, prompt, 1, torch.float32)
    pf, _ = model.prefill(p32, {"tokens": prompt})
    dec = res["prompt_logits"][:, :cfg.vocab_size]
    pre = pf[:, :cfg.vocab_size]
    assert dec.dtype == pre.dtype == torch.float32
    rms = float(dec.pow(2).mean().sqrt())
    tol = 6.0 * 2.0 ** -24 * math.sqrt(
        cfg.n_layers * PREFILL_ROUNDINGS[cfg.family] * cfg.d_ff) * rms
    assert float((pre - dec).abs().max()) <= tol


@pytest.mark.parametrize("arch", RECURRENT)
def test_bf16_recurrent_model_matches_the_reference(arch):
    """The reduced model in bf16, the reference's params carried across:
    ``prefill`` and 32 stepped ``decode_step``s on a bf16 cache against the
    reference's, the caches leaf by leaf with their dtypes. Each package
    rounds its own bf16 results and XLA may fuse some roundings away, so
    the two may land on neighbouring bf16 values at each of the family's
    R sites a layer: within ``6 * 2^-8 * sqrt(L * R) * rms`` of the logits
    (or of a cache leaf, for the leaf)."""
    cfg_j = dataclasses.replace(get_config_j(arch).reduced(),
                                dtype="bfloat16")
    cfg_t = dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16")
    params_np = _reference_params(cfg_j, 3)
    model_j, model_t = ModelJ(cfg_j), Model(cfg_t, device="cpu")
    params_t = convert.model_params_to_torch(params_np, device="cpu")
    params_j = jax.tree.map(jnp.asarray, params_np)
    r = PREFILL_ROUNDINGS[cfg_t.family]
    b, prompt_len = 2, 32
    prompt = np.random.default_rng(4).integers(0, cfg_j.vocab_size,
                                               (b, prompt_len))

    def within(got, want):
        want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
        got = got.double().numpy()
        tol = _bf16_tolerance(cfg_t.n_layers, torch.from_numpy(want), r)
        assert np.abs(got - want).max() <= tol, (np.abs(got - want).max(),
                                                 tol)

    want, _ = model_j.prefill(params_j, {"tokens": jnp.asarray(prompt)})
    got, _ = model_t.prefill(params_t, {"tokens": torch.as_tensor(prompt)})
    assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    within(got, want)

    cache_j = model_j.init_cache(b, prompt_len, jnp.bfloat16)
    cache_t = model_t.init_cache(b, prompt_len, torch.bfloat16)
    step_j = jax.jit(model_j.decode_step)
    for pos in range(prompt_len):
        lj, cache_j = step_j(params_j, cache_j,
                             jnp.asarray(prompt[:, pos], jnp.int32),
                             jnp.int32(pos))
        lt, cache_t = model_t.decode_step(params_t, cache_t,
                                          torch.as_tensor(prompt[:, pos]),
                                          pos)
        assert lt.dtype == torch.bfloat16
        within(lt, lj)
    flat_t, flat_j = _flat(cache_t), _flat(cache_j)
    assert set(flat_t) == set(flat_j)
    for name, leaf in flat_t.items():
        ref = flat_j[name]
        assert tuple(leaf.shape) == ref.shape, name
        assert str(leaf.dtype).replace("torch.", "") == str(ref.dtype), name
        within(leaf, ref)


def test_bf16_prefill_matches_stepped_decode():
    """Within one package, bf16: ``prefill``'s last-token logits against the
    decode logits after stepping the same prompt through ``generate``."""
    cfg = dataclasses.replace(
        get_config("stablelm-1.6b").reduced(), n_layers=4, d_model=256,
        n_heads=4, n_kv_heads=4, head_dim=64, d_ff=704, vocab_size=2048,
        dtype="bfloat16")
    model = Model(cfg, device="cpu")
    params = model.init(5)
    prompt = torch.as_tensor(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 24)))
    res = serve.generate(model, params, prompt, 2)
    pf, _ = model.prefill(params, {"tokens": prompt})
    assert pf.dtype == torch.bfloat16 and res["tokens"].shape == (2, 2)
    dec = res["prompt_logits"][:, :cfg.vocab_size].float()
    pre = pf[:, :cfg.vocab_size].float()
    tol = _bf16_tolerance(cfg.n_layers, dec)
    assert float((pre - dec).abs().max()) <= tol


def test_model_init_layout_matches_the_reference():
    arch = "qwen2.5-14b"
    ref = jax.eval_shape(ModelJ(get_config_j(arch).reduced()).init,
                         jax.random.PRNGKey(0))
    got = Model(get_config(arch).reduced(), device="cpu").init(0)

    def flat(tree, prefix=()):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                out.update(flat(v, prefix + (k,)))
            return out
        return {prefix: (tuple(tree.shape),
                         str(tree.dtype).replace("torch.", ""))}

    assert flat(got) == flat(ref)


def test_model_init_is_seeded():
    m = Model(get_config("stablelm-1.6b").reduced(), device="cpu")
    a, b, c = m.init(1), m.init(1), m.init(2)
    assert torch.equal(a["layers"]["mlp"]["w_up"], b["layers"]["mlp"]["w_up"])
    assert not torch.equal(a["embed"]["w"], c["embed"]["w"])


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_init_layout_matches_the_reference(arch):
    got = Model(get_config(arch).reduced(), device="cpu").init(0)
    ref = jax.eval_shape(ModelJ(get_config_j(arch).reduced()).init,
                         jax.random.PRNGKey(0))
    shape = lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", ""))
    assert {k: shape(v) for k, v in _flat(got).items()} == \
        {k: shape(v) for k, v in _flat(ref).items()}


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_trees_cross_bit_for_bit_in_bf16(arch):
    cfg_j = dataclasses.replace(get_config_j(arch).reduced(),
                                dtype="bfloat16")
    params_np = _reference_params(cfg_j, 7)
    got = _flat(convert.model_params_to_torch(params_np, device="cpu"))
    want = _flat(params_np)
    assert set(got) == set(want)
    n_bf16 = 0
    for name, leaf in got.items():
        ref = np.ascontiguousarray(want[name])
        assert tuple(leaf.shape) == ref.shape
        if ref.dtype.name == "bfloat16":
            n_bf16 += 1
            assert leaf.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                leaf.view(torch.int16).numpy().view(np.uint16),
                ref.view(np.uint16))
        else:
            assert leaf.dtype == torch.float32
            np.testing.assert_array_equal(leaf.numpy().view(np.uint32),
                                          ref.view(np.uint32))
    assert n_bf16 > 5


def test_recurrent_prefill_needs_whole_chunks():
    """As the reference: a prompt that is not a multiple of the GLA chunk
    (16 at reduced size) is refused, not padded."""
    model = Model(get_config("rwkv6-1.6b").reduced(), device="cpu")
    with pytest.raises(AssertionError, match="not divisible by chunk"):
        model.prefill(model.init(0),
                      {"tokens": torch.zeros((1, 6), dtype=torch.long)})


def test_other_families_raise_not_implemented():
    """A family the port does not run is refused when the model is built."""
    cfg = dataclasses.replace(get_config("stablelm-1.6b").reduced(),
                              family="retnet")
    with pytest.raises(NotImplementedError, match="family 'retnet'"):
        Model(cfg, device="cpu")


# ----------------------------------------------------------------- convert
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_model_params_round_trip_bitwise(dtype):
    tree = {"z": {"w": jnp.asarray(_rand(70, 3, 4, 5), dtype)},
            "n": jnp.asarray(_rand(71, 7), dtype),
            "cache": {"k": jnp.asarray(_rand(72, 2, 1, 3, 2, 4), dtype)}}
    np_tree = jax.tree.map(np.asarray, tree)
    got = convert.model_params_to_torch(np_tree, device="cpu")
    assert list(got) == ["cache", "n", "z"]             # sorted keys
    width = {jnp.float32: (np.uint32, torch.int32),
             jnp.bfloat16: (np.uint16, torch.int16)}[dtype]
    for leaf, ref in ((got["z"]["w"], np_tree["z"]["w"]),
                      (got["n"], np_tree["n"]),
                      (got["cache"]["k"], np_tree["cache"]["k"])):
        assert leaf.dtype == (torch.float32 if dtype == jnp.float32
                              else torch.bfloat16)
        assert tuple(leaf.shape) == ref.shape
        np.testing.assert_array_equal(
            leaf.view(width[1]).numpy().view(width[0]),
            np.ascontiguousarray(ref).view(width[0]))


def test_model_params_cast_keeps_integer_leaves():
    tree = {"w": _rand(73, 4, 3), "i": np.arange(5, dtype=np.int32)}
    got = convert.model_params_to_torch(tree, torch.bfloat16, device="cpu")
    assert got["w"].dtype == torch.bfloat16
    assert got["i"].dtype == torch.int32
    torch.testing.assert_close(got["w"], _t(tree["w"], torch.bfloat16),
                               rtol=0, atol=0)


# ------------------------------------------------------------ device rules
def test_model_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        Model(get_config("stablelm-1.6b").reduced())
    with pytest.raises(RuntimeError, match="cuda"):
        convert.model_params_to_torch({"w": _rand(74, 2)})


@pytest.mark.parametrize("arch", RECURRENT)
def test_serve_main_recurrent_on_the_cpu(arch, monkeypatch, capsys):
    """The serve CLI's ``main`` in this process (the file's one subprocess
    test runs stablelm): ``--arch`` of a recurrent family, reduced, on the
    CPU."""
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", arch, "--reduced", "--device", "cpu", "--batch",
        "2", "--prompt-len", "5", "--gen", "3"])
    serve.main()
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[serve]")]
    assert len(lines) == 2
    assert f"arch={arch} batch=2 prefill 5 tok" in lines[0]
    assert "generated 3 tok" in lines[0]


def test_serve_main_defaults_to_the_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    monkeypatch.setattr(sys, "argv", ["serve", "--reduced", "--batch", "1",
                                      "--prompt-len", "2", "--gen", "2"])
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main()


# ------------------------------------------------------------------- serve
def test_serve_cli_on_the_cpu(tmp_path):
    """The one subprocess test: the CLI end to end at a reduced config,
    run from a scratch directory, writing no bytecode. The time limit only
    guards against a hang."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1", PYTHONDONTWRITEBYTECODE="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "stablelm-1.6b", "--reduced", "--device", "cpu", "--batch", "1",
         "--prompt-len", "4", "--gen", "4"],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=900)
    assert proc.returncode == 0, proc.stderr
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("[serve]")]
    assert len(lines) == 2
    assert "arch=stablelm-1.6b batch=1 prefill 4 tok" in lines[0]
    assert "generated 4 tok" in lines[0]
    assert lines[1].startswith("[serve] sample tokens: [")
