"""Port parity, serving the cross-attention families: ``sinusoidal_pos``,
``attention.cross_attention`` / ``decode_cross_attention``, the encdec
(whisper-medium) and vlm (llama-3.2-vision-11b) models' init, prefill and
decode, and the serve CLI — ``repro_torch`` on the CPU against ``repro``
on the same inputs.

Inputs are seeded numpy draws handed to both packages; model params are
the reference's ``Model.init`` carried across by
``convert.model_params_to_torch``, with vlm's cross gates set non-zero
(``VLM_GATES``, as ``tests/test_torch_models.py`` sets them): at their initial zeros every cross
block is the identity and any cross-attention would pass. Every size is
``reduced()`` (2 layers, d_model 64; vlm: 1 group of 2 self blocks and a
cross block over 8 patches; whisper: 2 encoder layers).

Tolerances and why:
  * ``sinusoidal_pos``: per entry ``2·pos·div·2^-23 + 2^-23``. The two
    packages' ``exp`` may differ by one ulp in ``div`` (at most
    ``div·2^-23``), which the position carries; the two products
    ``pos·div`` then round apart by at most one ulp of the argument (at
    most ``pos·div·2^-23``); ``sin`` and ``cos`` of one argument differ by
    at most two half ulps of a result below 1 (``2^-23``), and both have
    slope at most 1;
  * one attention call in f32: ``2e-5`` (``tests/test_torch_models.py``);
    in bf16 ``6·2^-8·sqrt(R)·rms(out)``, R the bf16 roundings at which the
    two packages may land on neighbouring values (``cross_attention``: q,
    k, v, the probabilities, the output and wo, 6; the decode form: q, the
    output and wo, 3), the form of that file's bf16 bounds;
  * a model's logits in f32: ``1e-4``; in bf16 ``6·2^-8·sqrt(L·R)·rms``
    with R a block's roundings (``CROSS_ROUNDINGS``);
  * the port's decode over cross caches filled from the memory against
    its own prefill, in f32: ``6·2^-24·sqrt(L·R·K)·rms(logits)``, K the
    longest contraction (d_ff, the memory's length, the prompt), the
    bound ``chip_smoke.py`` holds the full-width models to; a zeroed
    memory and a cache filled from the wrong layers must fail it.
"""
import dataclasses
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as get_config_j
from repro.models import attention as attn_j
from repro.models.transformer import Model as ModelJ
from repro.models.transformer import sinusoidal_pos as sinusoidal_pos_j
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import Model
from repro_torch.models import attention as attn_t
from repro_torch.models.transformer import sinusoidal_pos

torch.set_num_threads(1)

ARCHS = ("whisper-medium", "llama-3.2-vision-11b")
VLM_GATES = {"gate_attn": 0.7, "gate_mlp": -0.4}
U, U16 = 2.0 ** -24, 2.0 ** -8
#: bf16 (or f32-summation) sites a block at which prefill and decode, or
#: the two packages, may land on neighbouring values. encdec's decoder
#: block 21: ln1, q, k, v, the probabilities, the attention output, wo,
#: the residual add (8); lnx and the same seven for the cross-attention
#: (8); ln2, up, gelu, down, the residual add (5). vlm 17 a block: a self
#: block is the dense family's 17 (two norms, q, k, v, RoPE on q and k,
#: the probabilities, the output, wo, two residual adds, up, gate, silu,
#: the gated product, down); a cross block ln1, q, k, v, the
#: probabilities, the output, wo, the gate's product, the residual add,
#: ln2, up, gate, silu, the gated product, down, the gate's product, the
#: residual add (17). The encoder's block (13: no cross-attention) runs
#: on the same inputs on both paths of a prefill-vs-decode check.
CROSS_ROUNDINGS = {"encdec": 21, "vlm": 17}
ENCODER_ROUNDINGS = 13


def _rand(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)
            ).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _params_np(cfg_j, seed=3):
    params = jax.tree.map(np.asarray, ModelJ(cfg_j).init(
        jax.random.PRNGKey(seed)))
    if cfg_j.family == "vlm":
        cross = params["groups"]["cross"]
        for name, value in VLM_GATES.items():
            cross[name] = np.full(cross[name].shape, value, np.float32)
    return params


def _memory_inputs(cfg, b, seed=8, n_frames=10):
    """frames [B, n_frames, d] (encdec) or patches [B, n_patches,
    d_vision] (vlm)."""
    if cfg.family == "encdec":
        return {"frames": _rand(seed, b, n_frames, cfg.d_model)}
    v = cfg.vision
    return {"patches": _rand(seed, b, v.n_patches, v.d_vision)}


def _n_blocks(cfg):
    """Decoder-side blocks: encdec's decoder layers, vlm's self and cross
    blocks."""
    if cfg.family == "vlm":
        return cfg.n_layers + cfg.vision.n_cross_layers
    return cfg.n_layers


# ------------------------------------------------------------ positions
SINUSOID_CASES = [(1500, 1024, 0), (448, 1024, 0), (1, 1024, 447),
                  (1, 1024, 1499), (32, 64, 0), (7, 64, 5)]


def _sinusoid_bound(seq, d, offset):
    pos = offset + np.arange(seq, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float64)
                 * (-np.log(10000.0) / d))
    b = 2 * pos * div * 2.0 ** -23 + 2.0 ** -23
    return np.repeat(b, 2, axis=1)          # sin and cos share the argument


@pytest.mark.parametrize("seq,d,offset", SINUSOID_CASES)
def test_sinusoidal_pos_within_its_counted_bound(seq, d, offset):
    got = sinusoidal_pos(seq, d, offset=offset)
    want = np.asarray(sinusoidal_pos_j(seq, d, offset), np.float64)
    assert got.dtype == torch.float32 and tuple(got.shape) == (seq, d)
    diff = np.abs(got.double().numpy() - want)
    assert (diff <= _sinusoid_bound(seq, d, offset)).all(), diff.max()


@pytest.mark.parametrize("fault", ["offset", "swapped"])
def test_sinusoidal_bound_rejects_a_planted_fault(fault):
    """The bound can fail: positions one step late, or sin and cos
    swapped, are far outside it."""
    seq, d = 448, 1024
    got = sinusoidal_pos(seq, d, offset=1 if fault == "offset" else 0)
    if fault == "swapped":
        got = got.reshape(seq, d // 2, 2).flip(-1).reshape(seq, d)
    want = np.asarray(sinusoidal_pos_j(seq, d, 0), np.float64)
    diff = np.abs(got.double().numpy() - want)
    assert not (diff <= _sinusoid_bound(seq, d, 0)).all()


def test_decode_offset_is_the_prefill_row():
    """encdec's decode adds ``sinusoidal_pos(1, d, offset=pos)``, prefill
    row ``pos`` of the table: the same bits."""
    table = sinusoidal_pos(448, 1024)
    for pos in (0, 1, 127, 447):
        row = sinusoidal_pos(1, 1024, offset=pos)[0]
        assert torch.equal(row.view(torch.int32), table[pos].view(torch.int32))


# ------------------------------------------------------------ attention
def _attn_case(arch, seed):
    cfg_j = get_config_j(arch).reduced()
    cfg = get_config(arch).reduced()
    hd = cfg.resolved_head_dim
    p = {"wq": _rand(seed, cfg.d_model, cfg.n_heads * hd, scale=0.125),
         "wk": _rand(seed + 1, cfg.d_model, cfg.n_kv_heads * hd, scale=0.125),
         "wv": _rand(seed + 2, cfg.d_model, cfg.n_kv_heads * hd, scale=0.125),
         "wo": _rand(seed + 3, cfg.n_heads * hd, cfg.d_model, scale=0.125)}
    return cfg_j, cfg, p


def _bf16_bound(out_ref, r):
    rms = float(np.sqrt(np.mean(np.square(out_ref))))
    return 6.0 * U16 * math.sqrt(r) * rms


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS, ids=["mha", "gqa"])
def test_cross_attention(arch, dtype):
    """x [2, 9, d] attends to memory [2, 13, d] (no mask, no RoPE;
    whisper's MHA, the vlm's GQA of 4 query heads on 2 kv heads)."""
    cfg_j, cfg, p = _attn_case(arch, 20)
    assert (cfg.n_kv_heads == cfg.n_heads) == (arch == "whisper-medium")
    x, mem = _rand(24, 2, 9, cfg.d_model), _rand(25, 2, 13, cfg.d_model)
    dt_t, dt_j = getattr(torch, dtype), getattr(jnp, dtype)
    got = attn_t.cross_attention(
        {k: torch.from_numpy(v).to(dt_t) for k, v in p.items()},
        torch.from_numpy(x).to(dt_t), torch.from_numpy(mem).to(dt_t),
        cfg=cfg)
    want = attn_j.cross_attention(
        {k: jnp.asarray(v, dt_j) for k, v in p.items()},
        jnp.asarray(x, dt_j), jnp.asarray(mem, dt_j), cfg=cfg_j)
    assert got.dtype == dt_t and str(want.dtype) == dtype
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    if dtype == "float32":
        _close(got, want, 2e-5)
    else:
        diff = np.abs(got.double().numpy() - want).max()
        assert diff <= _bf16_bound(want, 6), diff


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS, ids=["mha", "gqa"])
def test_decode_cross_attention(arch, dtype):
    """One token against filled cross caches [2, 13, Hkv, D]: every
    position attended, as the reference's ``pos = S - 1``."""
    cfg_j, cfg, p = _attn_case(arch, 30)
    hd = cfg.resolved_head_dim
    x = _rand(34, 2, cfg.d_model)
    ck, cv = (_rand(35 + i, 2, 13, cfg.n_kv_heads, hd) for i in range(2))
    dt_t, dt_j = getattr(torch, dtype), getattr(jnp, dtype)
    tt = lambda a: torch.from_numpy(a).to(dt_t)
    got = attn_t.decode_cross_attention(
        {k: tt(v) for k, v in p.items()}, tt(x), tt(ck), tt(cv), cfg=cfg)
    want = attn_j.decode_cross_attention(
        {k: jnp.asarray(v, dt_j) for k, v in p.items()},
        jnp.asarray(x, dt_j), jnp.asarray(ck, dt_j), jnp.asarray(cv, dt_j),
        cfg=cfg_j)
    assert got.dtype == dt_t and str(want.dtype) == dtype
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    if dtype == "float32":
        _close(got, want, 2e-5)
    else:
        diff = np.abs(got.double().numpy() - want).max()
        assert diff <= _bf16_bound(want, 3), diff
    # the last key counts: dropping it moves the output
    short = attn_t.decode_cross_attention(
        {k: tt(v) for k, v in p.items()}, tt(x), tt(ck)[:, :-1],
        tt(cv)[:, :-1], cfg=cfg)
    assert not torch.equal(short, got)


# ---------------------------------------------------------------- model
@pytest.mark.parametrize("arch", ARCHS)
def test_init_layout_matches_the_reference(arch):
    got = Model(get_config(arch).reduced(), device="cpu").init(0)
    ref = jax.eval_shape(ModelJ(get_config_j(arch).reduced()).init,
                         jax.random.PRNGKey(0))
    shape = lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", ""))
    assert {k: shape(v) for k, v in _flat(got).items()} == \
        {k: shape(v) for k, v in _flat(ref).items()}
    top = {"whisper-medium": "encoder", "llama-3.2-vision-11b": "groups"}
    assert top[arch] in got


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_layout_matches_the_reference(arch):
    cache = Model(get_config(arch).reduced(), device="cpu").init_cache(
        2, 12, torch.bfloat16)
    ref = ModelJ(get_config_j(arch).reduced()).init_cache(2, 12,
                                                           jnp.bfloat16)
    shape = lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", ""))
    assert {k: shape(v) for k, v in _flat(cache).items()} == \
        {k: shape(v) for k, v in _flat(ref).items()}
    for name, leaf in _flat(cache).items():
        assert not leaf.any(), name
        # each layer (group) its own storage: a write to one stays in it
        assert leaf.is_contiguous() and leaf.stride(0) > 0, name


@pytest.mark.parametrize("arch", ARCHS)
def test_trees_cross_bit_for_bit_in_bf16(arch):
    """``convert.model_params_to_torch`` carries the ``encoder`` and
    ``groups`` nests (vlm's ``[G, per, ...]`` self blocks, its 0-d gates
    a group) with their shapes and dtypes, bit for bit."""
    cfg_j = dataclasses.replace(get_config_j(arch).reduced(),
                                dtype="bfloat16")
    params_np = _params_np(cfg_j, 7)
    got = _flat(convert.model_params_to_torch(params_np, device="cpu"))
    want = _flat(params_np)
    assert set(got) == set(want)
    nest = ("encoder", "layers") if arch == "whisper-medium" else (
        "groups", "self")
    assert any(k[:2] == nest for k in got)
    for name, leaf in got.items():
        ref = np.ascontiguousarray(want[name])
        assert tuple(leaf.shape) == ref.shape, name
        bits = (np.uint16, torch.int16) if ref.dtype.name == "bfloat16" \
            else (np.uint32, torch.int32)
        assert leaf.dtype == (torch.bfloat16 if bits[0] == np.uint16
                              else torch.float32), name
        np.testing.assert_array_equal(
            leaf.view(bits[1]).numpy().view(bits[0]), ref.view(bits[0]))


def _bf16_within(got, want, sites):
    """Within ``6·2^-8·sqrt(sites)·rms(want)``, ``sites`` the L·R count."""
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    rms = np.sqrt(np.mean(np.square(want)))
    tol = 6.0 * U16 * math.sqrt(sites) * rms
    diff = np.abs(got.double().numpy() - want).max()
    assert diff <= tol, (diff, tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_model_matches_the_reference(arch):
    """The reduced model in bf16: ``prefill`` (with frames or patches) and
    8 stepped ``decode_step``s over a zero cross cache against the
    reference's, within ``6·2^-8·sqrt(L·R)·rms``, prefill's L·R with the
    encoder's layers at ``ENCODER_ROUNDINGS``."""
    cfg_j = dataclasses.replace(get_config_j(arch).reduced(),
                                dtype="bfloat16")
    cfg_t = dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16")
    params_np = _params_np(cfg_j)
    model_j, model_t = ModelJ(cfg_j), Model(cfg_t, device="cpu")
    params_t = convert.model_params_to_torch(params_np, device="cpu")
    params_j = jax.tree.map(jnp.asarray, params_np)
    r = CROSS_ROUNDINGS[cfg_t.family]
    blocks = _n_blocks(cfg_t)
    b, prompt_len = 2, 8
    prompt = np.random.default_rng(4).integers(0, cfg_j.vocab_size,
                                               (b, prompt_len))
    extra = _memory_inputs(cfg_t, b)
    want, _ = model_j.prefill(params_j, dict(
        {k: jnp.asarray(v) for k, v in extra.items()},
        tokens=jnp.asarray(prompt)))
    got, _ = model_t.prefill(params_t, dict(
        {k: torch.from_numpy(v) for k, v in extra.items()},
        tokens=torch.as_tensor(prompt)))
    assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    enc = cfg_t.encdec.n_enc_layers if cfg_t.encdec else 0
    _bf16_within(got, want, blocks * r + enc * ENCODER_ROUNDINGS)

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
        _bf16_within(lt, lj, blocks * r)
    flat_j = _flat(cache_j)
    for name, leaf in _flat(cache_t).items():
        assert tuple(leaf.shape) == flat_j[name].shape, name
        if name[-1] in ("ck", "cv"):       # never written: zeros
            assert not leaf.any() and not np.asarray(flat_j[name]).any()
        else:
            _bf16_within(leaf, flat_j[name], blocks * r)


# ------------------------------------------------ filled cross caches
def fill_cross_caches(model, params, cache, memory_inputs):
    """The cross caches a served request would need, filled here (nothing
    in either package fills them): whisper's ``ck`` / ``cv`` of decoder
    layer i from ``_encode``'s memory through that layer's ``xattn.wk`` /
    ``wv``; the vlm's of group g from the projected patches through group
    g's cross block. Returns the cache with ``ck`` / ``cv`` replaced by
    ``[L or G, B, S_mem, Hkv, D]`` tensors."""
    cfg = model.cfg
    with torch.no_grad():
        if cfg.family == "encdec":
            memory = model._encode(params, memory_inputs["frames"])
            xattn = params["layers"]["xattn"]
        else:
            memory = (memory_inputs["patches"].to(model.dtype)
                      @ params["vis_proj"])
            xattn = params["groups"]["cross"]["xattn"]
        b, s = memory.shape[:2]
        shape = (b, s, cfg.n_kv_heads, cfg.resolved_head_dim)
        kv = {name: torch.stack([(memory @ w).reshape(shape)
                                 for w in xattn[name]]).to(cache["k"].dtype)
              for name in ("wk", "wv")}
    return dict(cache, ck=kv["wk"], cv=kv["wv"])


def f32_prefill_bound(cfg, logits, mem_len, prompt_len):
    """``6·2^-24·sqrt(L·R·K)·rms(logits)``: R sites a block (the encoder
    runs on the same inputs on both paths), each up to sqrt(K) f32
    roundings of a sum taken in another order, K the longest contraction
    (d_ff, the memory's length, the prompt)."""
    k = max(cfg.d_ff, mem_len, prompt_len)
    rms = float(logits.double().pow(2).mean().sqrt())
    return 6.0 * U * math.sqrt(
        _n_blocks(cfg) * CROSS_ROUNDINGS[cfg.family] * k) * rms


def _filled_decode(arch, fault=None):
    """The port's f32 prefill and its stepped decode over filled cross
    caches (``fault``: "zeroed" memory, or the caches of the "rolled"
    layers / groups); returns (prefill logits, decode logits, bound)."""
    base = get_config(arch).reduced()
    over = {}
    if base.family == "vlm":
        # two groups, so that a cache from the wrong group shows
        over = dict(n_layers=4, vision=dataclasses.replace(
            base.vision, n_cross_layers=2))
    cfg = dataclasses.replace(base, **over)
    model = Model(cfg, device="cpu")
    params_np = _params_np(dataclasses.replace(
        get_config_j(arch).reduced(), **over))
    params = convert.model_params_to_torch(params_np, device="cpu")
    b, prompt_len = 2, 12
    prompt = torch.as_tensor(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (b, prompt_len)))
    mem = {k: torch.from_numpy(v) for k, v in
           _memory_inputs(cfg, b, n_frames=20).items()}
    with torch.no_grad():
        pf, _ = model.prefill(params, dict(mem, tokens=prompt))
    cache = fill_cross_caches(
        model, params, model.init_cache(b, prompt_len, torch.float32), mem)
    if fault == "zeroed":                 # memory @ wk of a zero memory
        cache["ck"].zero_()
        cache["cv"].zero_()
    if fault == "rolled":
        cache["ck"] = cache["ck"].roll(1, 0)
        cache["cv"] = cache["cv"].roll(1, 0)
    # generate steps its own zero cache (as served); the filled one here
    res = serve.generate(model, params, prompt, 1, torch.float32)
    with torch.no_grad():
        for pos in range(prompt_len):
            dec, cache = model.decode_step(params, cache, prompt[:, pos],
                                           pos)
    mem_len = cache["ck"].shape[2]
    pre, dec = pf[:, :cfg.vocab_size], dec[:, :cfg.vocab_size]
    return pre, dec, f32_prefill_bound(cfg, dec, mem_len, prompt_len), res


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_over_filled_cross_caches_equals_prefill(arch):
    pre, dec, tol, res = _filled_decode(arch)
    assert pre.dtype == dec.dtype == torch.float32
    diff = float((pre - dec).abs().max())
    assert diff <= tol, (diff, tol)
    # and decode over zero cross caches (as served) is not the prefill
    zero = res["prompt_logits"][:, :pre.shape[1]]
    assert float((pre - zero).abs().max()) > 100 * tol


@pytest.mark.parametrize("fault", ["zeroed", "rolled"])
@pytest.mark.parametrize("arch", ARCHS)
def test_filled_cache_bound_rejects_a_planted_fault(arch, fault):
    """A zeroed memory, or each layer's (group's) cross cache taken from
    another layer, fails the bound."""
    pre, dec, tol, _ = _filled_decode(arch, fault)
    assert float((pre - dec).abs().max()) > tol


# ----------------------------------------------------------------- serve
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_on_the_cpu(arch, monkeypatch, capsys):
    """The serve CLI's ``main`` in this process: reduced, on the CPU, no
    frames or patches (as the reference serves these families)."""
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", arch, "--reduced", "--device", "cpu", "--batch",
        "2", "--prompt-len", "5", "--gen", "3"])
    serve.main()
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[serve]")]
    assert len(lines) == 2
    assert f"arch={arch} batch=2 prefill 5 tok" in lines[0]
    assert "generated 3 tok" in lines[0]
