"""Port parity, training the recurrent families: autograd through
``models.gla.chunked_gla`` (its chunks checkpointed), ``Model._backbone``
under ``cfg.remat`` and ``Model.loss_fn`` for hymba-1.5b (hybrid) and
rwkv6-1.6b (ssm), then ``launch.train`` and ``launch.fl_train`` on them —
``repro_torch`` on the CPU against ``repro`` on the same inputs.

Params are the reference's ``Model.init`` carried across by ``convert``,
with every leaf the reference sets to a constant redrawn from seeded numpy
(as ``tests/test_torch_models.py`` does), at ``reduced()`` size (2 layers,
d_model 64, GLA chunk 16), B = 2 x S = 32 tokens (two chunks), f32 unless
stated.

Tolerances and why:
  * a loss: ``1e-4`` relative (the reduced model's loss tolerance,
    ``tests/test_torch_mesh.py``);
  * gradients, per leaf: ``K * 2^-24 * max|g|``, K the sum of the
    reduction lengths on the backward path (``_k_grad``, each term beside
    what it counts): every term of a gradient is a sum of at most that many
    f32 products, summed in another order than XLA's;
  * ``chunked_gla``'s gradients, per input: ``K_gla * 2^-24 * max|g|``
    with ``K_gla = c + Dk + Dv + T + c + 8`` (the intra-chunk pair sum, the
    key and value contractions, the state's gradient carried back over
    every later position, the cumsum's backward and 8 more roundings);
  * bf16 gradients, per leaf: ``6 * 2^-8 * sqrt(K16) * max|g|``, K16 the
    bf16 roundings on the backward path (``_k16``): R a layer in the
    forward (``tests/test_torch_models.py``'s ``PREFILL_ROUNDINGS``) and
    two in the backward for each, at which the two packages may land on
    neighbouring values. Independent roundings add in quadrature, so their
    count enters under a root, with six standard deviations, as the bf16
    bounds of ``tests/test_torch_models.py``; that makes 0.34 / 0.40 of
    max|g| (hymba / rwkv6), and a leaf's gradient halved or zeroed fails
    it (``test_bf16_grad_bound_rejects_a_planted_fault``). The dtypes each
    side hands ``chunked_gla`` and each ``einsum`` of the recurrent
    modules are required equal, since a promotion moves values by less
    than any bound can see. The loss within twice the logits' bound of
    that file, ``6 * 2^-8 * sqrt(L * R) * rms(logits)`` (the CE's
    derivative in the logits sums to at most 2 in absolute value);
  * within the port, bit for bit: the three ``remat`` modes, and the
    out-of-place vector chunk against the in-place one;
  * whole runs: per-step / per-round losses within ``1e-4`` relative;
    params after one FL round away from Top-K near-ties, as
    ``tests/test_torch_fl_train.py``; the mesh scan against the round
    engine bit for bit.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as get_config_j
from repro.core import compression as comp_j
from repro.data import synthetic_lm_tokens as tokens_j
from repro.dist import grad_sync as gs_j
from repro.fed import engine as engine_j
from repro.launch import fl_train as fl_j
from repro.models import gla as gla_j
from repro.models import layers as layers_j
from repro.models import mamba as mamba_j
from repro.models import rwkv6 as rwkv_j
from repro.models.transformer import Model as ModelJ
from repro.optim import make_optimizer as make_opt_j
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.dist.grad_sync import loss_and_grads
from repro_torch.fed import engine as engine_t
from repro_torch.launch import fl_train as fl_t
from repro_torch.launch import train as train_t
from repro_torch.models import Model
from repro_torch.models import gla as gla_t
from repro_torch.models import mamba as mamba_t
from repro_torch.models import rwkv6 as rwkv_t
from repro_torch.models import transformer as tr_t

torch.set_num_threads(1)

ARCHS = ("hymba-1.5b", "rwkv6-1.6b")
B, S = 2, 32
U = 2.0 ** -24
U16 = 2.0 ** -8
#: bf16 roundings a layer in the forward, ``tests/test_torch_models.py``'s
#: PREFILL_ROUNDINGS
FWD_ROUNDINGS = {"hybrid": 35, "ssm": 48}


def _rand(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)
            ).astype(np.float32)


def _redraw_constants(tree, seed=100):
    """Every float leaf of more than one element that the reference
    initialises to a constant c redrawn as c + 0.2 N (c = 1) or c + 0.5 N,
    so that every term it gates shows in the gradients."""
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


def _pair(arch, dtype="float32", remat="none", seed=3):
    """(reference model, port model, reference params, port params) from
    the same numpy tree."""
    cj = dataclasses.replace(get_config_j(arch).reduced(), dtype=dtype,
                             remat=remat)
    ct = dataclasses.replace(get_config(arch).reduced(), dtype=dtype,
                             remat=remat)
    params = _redraw_constants(jax.tree.map(np.asarray, ModelJ(cj).init(
        jax.random.PRNGKey(seed))))
    return (ModelJ(cj), Model(ct, device="cpu"),
            jax.tree.map(jnp.asarray, params),
            convert.model_params_to_torch(params, device="cpu"))


def _batch(vocab, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, vocab, (B, S + 1)).astype(np.int32)
    return ({"tokens": jnp.asarray(toks[:, :-1]),
             "labels": jnp.asarray(toks[:, 1:])},
            {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])})


def _grads_j(model, params, batch):
    (loss, _), g = jax.value_and_grad(lambda p: model.loss_fn(p, batch),
                                      has_aux=True)(params)
    return float(loss), [np.asarray(jnp.asarray(a, jnp.float32), np.float64)
                         for a in jax.tree.leaves(g)]


def _k_grad(cfg, b, s):
    """The gradient bound's K: the reduction lengths on the backward path
    of a reduced recurrent model (``tests/test_torch_mesh.py``'s dense K
    with each family's own terms)."""
    d, t = cfg.d_model, s
    per_layer = b * s + d + cfg.d_ff           # weight grads; d_model, d_ff
    if cfg.family == "hybrid":
        ssm = cfg.ssm
        di, n = ssm.expand * d, ssm.state_size
        nh = di // ssm.head_dim
        per_layer += (
            s                                  # attention over the keys
            + (2 * di + 2 * n + nh)            # in_proj's output width
            + di                               # the branch's rms norm
            + mamba_t.CONV_WIDTH               # the conv's taps
            + nh                               # B, C shared over heads
            + ssm.chunk + n + ssm.head_dim     # GLA: pairs, Dk, Dv
            + t + ssm.chunk)                   # state carried back; cumsum
    else:
        rw = cfg.rwkv
        hs = rw.head_size
        per_layer += (
            5 * rwkv_t.MAA_RANK + rwkv_t.MAA_RANK  # maa_w1 / maa_w2
            + 5                                # x read by five lerps
            + rw.decay_lora                    # the decay LoRA
            + hs                               # the per-head group norm
            + rw.chunk + hs + hs               # GLA: pairs, Dk, Dv
            + t + rw.chunk)                    # state carried back; cumsum
    return cfg.n_layers * per_layer + cfg.vocab_size


def _k16(cfg):
    """bf16 roundings on the backward path: R a layer in the forward and
    two in the backward for each (an op's cotangent for each of at most
    two bf16 operands), and the head (the logits' product: 1 + 2) and the
    embedding (1)."""
    return cfg.n_layers * 3 * FWD_ROUNDINGS[cfg.family] + 4


def _over_bound(got, want, tol_of):
    """(path, max |got - want|, bound) of every leaf past ``tol_of(max
    |want|)``."""
    assert len(got) == len(want)
    out = []
    for (path, g), a in zip(got, want):
        bound = tol_of(np.abs(a).max())
        diff = np.abs(g.double().numpy() - a).max()
        if not diff <= bound:
            out.append((path, diff, bound))
    return out


def _assert_grads(got, want, tol_of):
    bad = _over_bound(got, want, tol_of)
    assert not bad, bad


def _items_grads(model, params, batch):
    loss, _, grads = loss_and_grads(model.loss_fn, params, batch)
    return loss, [(p, g) for (p, _), g in zip(
        engine_t.tree_items(params), grads)]


# -------------------------------------------------------- loss and grads
@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_against_the_reference(arch, remat):
    """``Model.loss_fn`` and every leaf's gradient against
    ``jax.value_and_grad`` of the reference's, the reference at the same
    ``remat``; rwkv6's ``final_norm_b`` (read by nothing) is zeros on
    both sides."""
    mj, mt, pj, pt = _pair(arch, remat=remat)
    bj, bt = _batch(mt.cfg.vocab_size)
    lj, gj = _grads_j(mj, pj, bj)
    lt, gt = _items_grads(mt, pt, bt)
    assert abs(float(lt) - lj) <= 1e-4 * abs(lj)
    k = _k_grad(mt.cfg, B, S)
    _assert_grads(gt, gj, lambda m: k * U * m)
    if arch == "rwkv6-1.6b":
        fb = dict(gt)[("final_norm_b",)]
        assert fb.shape == (mt.cfg.d_model,) and not fb.any()


class _DtypeLog:
    """A proxy of a module's array namespace (``torch`` in the port,
    ``jnp`` in the reference) that logs the dtypes of what each ``einsum``
    is handed, and passes everything else through."""

    def __init__(self, ns, log):
        self._ns, self._log = ns, log

    def __getattr__(self, name):
        return getattr(self._ns, name)

    def einsum(self, spec, *ops):
        self._log.append(("einsum", spec, [_dt(a) for a in ops]))
        return self._ns.einsum(spec, *ops)


def _dt(a):
    return str(a.dtype).replace("torch.", "")


def _log_dtypes(mp, module, ns_name, log):
    """Log the dtypes ``module`` hands ``chunked_gla`` and its ``einsum``."""
    fn = module.chunked_gla

    def logged(*args, **kw):
        log.append(("chunked_gla", [_dt(a) for a in list(args) + [
            kw[k] for k in sorted(kw) if hasattr(kw[k], "dtype")]]))
        return fn(*args, **kw)
    mp.setattr(module, "chunked_gla", logged)
    mp.setattr(module, ns_name, _DtypeLog(getattr(module, ns_name), log))


@functools.lru_cache(maxsize=None)
def _bf16_run(arch):
    """One bf16 loss and gradient on each side (reduced, remat "none"),
    the dtypes each side's SSM and RWKV modules hand ``chunked_gla`` and
    ``einsum`` logged, and the bounds of the module docstring."""
    mj, mt, pj, pt = _pair(arch, dtype="bfloat16")
    cfg = mt.cfg
    bj, bt = _batch(cfg.vocab_size)
    log_t, log_j = [], []
    with pytest.MonkeyPatch.context() as mp:
        for mod_t, mod_j in ((mamba_t, mamba_j), (rwkv_t, rwkv_j)):
            _log_dtypes(mp, mod_t, "torch", log_t)
            _log_dtypes(mp, mod_j, "jnp", log_j)
        lj, gj = _grads_j(mj, pj, bj)
        lt, gt = _items_grads(mt, pt, bt)
    x, _ = mj._backbone(pj, layers_j.embed_lookup(pj["embed"]["w"],
                                                  bj["tokens"]),
                        jnp.arange(S))
    logits = np.asarray(jnp.asarray(layers_j.rms_norm(
        x, pj["final_norm"], cfg.norm_eps) @ pj["lm_head"]["w"],
        jnp.float32), np.float64)[..., :cfg.vocab_size]
    rms = np.sqrt((logits * logits).mean())
    k16 = _k16(cfg)
    return dict(
        lt=float(lt), lj=lj, gt=gt, gj=gj, log_t=log_t, log_j=log_j,
        dtypes=[(path, g.dtype, p.dtype) for (path, g), (_, p) in zip(
            gt, engine_t.tree_items(pt))],
        loss_tol=2 * 6.0 * U16 * math.sqrt(
            cfg.n_layers * FWD_ROUNDINGS[cfg.family]) * rms,
        tol_of=lambda m: 6.0 * U16 * math.sqrt(k16) * m)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_loss_and_grads_against_the_reference(arch):
    """bf16 loss and every leaf's gradient against the reference's within
    the module docstring's bounds, gradients in the params' dtype, and the
    same dtypes handed to ``chunked_gla`` and ``einsum`` on both sides
    (each layer's GLA; rwkv6's ``_ddlerp`` einsum)."""
    run = _bf16_run(arch)
    assert abs(run["lt"] - run["lj"]) <= run["loss_tol"], (
        run["lt"], run["lj"], run["loss_tol"])
    for path, g_dtype, p_dtype in run["dtypes"]:
        assert g_dtype == p_dtype, path
    # the reference scans its layers, tracing one layer's body once; the
    # port runs each layer's
    n_layers = get_config(arch).reduced().n_layers
    assert run["log_t"] == run["log_j"] * n_layers, (run["log_t"],
                                                    run["log_j"])
    assert [e[0] for e in run["log_j"]] == (
        ["einsum", "chunked_gla"] if arch == "rwkv6-1.6b"
        else ["chunked_gla"])
    _assert_grads(run["gt"], run["gj"], run["tol_of"])


@pytest.mark.parametrize("fault", ["halved", "zeroed"])
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_grad_bound_rejects_a_planted_fault(arch, fault):
    """The bf16 gradient bound can fail: one leaf's port gradient halved
    (or zeroed), the others as computed, fails the comparison at that
    leaf and nowhere else, for every leaf with a nonzero gradient."""
    run = _bf16_run(arch)
    gt, gj, tol_of = run["gt"], run["gj"], run["tol_of"]
    planted = 0
    for i, ((path, g), a) in enumerate(zip(gt, gj)):
        if not np.abs(a).max():
            continue                   # rwkv6's final_norm_b: all zeros
        bad = list(gt)
        bad[i] = (path, g * 0.5 if fault == "halved" else torch.zeros_like(g))
        assert [p for p, _, _ in _over_bound(bad, gj, tol_of)] == [path]
        planted += 1
    assert planted == len(gt) - (arch == "rwkv6-1.6b")


# ---------------------------------------------------- remat within the port
def _count_calls(monkeypatch, obj, name, counts):
    fn = getattr(obj, name)

    def counted(*a, **kw):
        counts[name] = counts.get(name, 0) + 1
        return fn(*a, **kw)
    monkeypatch.setattr(obj, name, counted)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS + ("stablelm-1.6b",))
def test_remat_modes_bit_for_bit(monkeypatch, arch, dtype):
    """"none", "full" and "dots": the same loss and every gradient bit for
    bit, and each mode does what it says: "full" runs each block's forward
    again in the backward, "dots" keeps the ``aten.mm`` outputs (and
    recomputes the rest), "none" runs each block once."""
    base = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    params = Model(base, device="cpu").init(0)
    _, bt = _batch(base.vocab_size)
    block = "_rwkv_block_fwd" if base.family == "ssm" else "_block_fwd"
    outs = {}
    for mode in ("none", "full", "dots"):
        counts = {}
        _count_calls(monkeypatch, Model, block, counts)
        _count_calls(monkeypatch, tr_t, "_save_mm", counts)
        model = Model(dataclasses.replace(base, remat=mode), device="cpu")
        outs[mode] = _items_grads(model, params, bt)
        monkeypatch.undo()
        runs = counts[block] // base.n_layers
        assert runs * base.n_layers == counts[block]
        assert runs == {"none": 1, "full": 2, "dots": 2}[mode], mode
        assert (counts.get("_save_mm", 0) > 0) == (mode == "dots"), mode
    lo, go = outs["none"]
    for mode in ("full", "dots"):
        loss, grads = outs[mode]
        assert torch.equal(loss, lo), mode
        for (path, a), (_, b) in zip(grads, go):
            assert a.dtype == b.dtype and torch.equal(a, b), (mode, path)


def test_serving_runs_no_checkpoint(monkeypatch):
    """With grad mode off (``prefill``, ``decode_step``) no block and no
    chunk is checkpointed, whatever ``cfg.remat`` says."""
    model = Model(dataclasses.replace(get_config("rwkv6-1.6b").reduced(),
                                      remat="full"), device="cpu")
    params = model.init(0)
    calls = []
    for mod in (tr_t, gla_t):
        monkeypatch.setattr(mod, "checkpoint",
                            lambda *a, **kw: calls.append(1))
    with torch.no_grad():
        logits, _ = model.prefill(params, {"tokens": torch.zeros(
            (1, 32), dtype=torch.long)})
    assert not calls and torch.isfinite(logits).all()


# ------------------------------------------------------------ chunked GLA
H, DK, DV, CHUNK = 3, 16, 8, 16
#: (scalar decay, inclusive, bonus u)
MODES = {"scalar-inclusive": (True, True, False),
         "scalar-exclusive": (True, False, False),
         "vector-inclusive": (False, True, False),
         "vector-exclusive-u": (False, False, True)}


def _gla_inputs(seed, n_chunks, scalar, with_u):
    rng = np.random.default_rng(seed)
    t = n_chunks * CHUNK
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    gshape = (B, H, t) if scalar else (B, H, t, DK)
    x = dict(r=f(B, H, t, DK), k=f(B, H, t, DK), v=f(B, H, t, DV),
             g=(-np.exp(rng.normal(-1.0, 1.0, size=gshape))).astype(
                 np.float32),
             u=f(H, DK) if with_u else None, s0=f(B, H, DK, DV))
    return {k: v for k, v in x.items() if v is not None}, f(B, H, t, DV), \
        f(B, H, DK, DV)


def _gla_loss(mod, x, do, ds, inclusive, lib):
    o, s = mod.chunked_gla(x["r"], x["k"], x["v"], x["g"], u=x.get("u"),
                           chunk=CHUNK, inclusive=inclusive,
                           initial_state=x["s0"])
    return lib.sum(o * do) + lib.sum(s * ds)


@pytest.mark.parametrize("mode", list(MODES))
def test_chunked_gla_grads_against_the_reference(monkeypatch, mode):
    """A random cotangent on (o, final state) over 3 chunks: every input's
    gradient against ``jax.grad`` of the reference's ``chunked_gla``; the
    backward recomputes each chunk (the checkpoint)."""
    scalar, inclusive, with_u = MODES[mode]
    x, do, ds = _gla_inputs(11, 3, scalar, with_u)
    names = sorted(x)
    gj = jax.grad(lambda *a: _gla_loss(
        gla_j, dict(zip(names, a)), do, ds, inclusive, jnp),
        argnums=tuple(range(len(names))))(*(jnp.asarray(x[n])
                                            for n in names))
    counts = {}
    body = "_chunk_scalar" if scalar else "_pairwise"
    _count_calls(monkeypatch, gla_t, body, counts)
    live = [torch.from_numpy(x[n]).requires_grad_(True) for n in names]
    loss = _gla_loss(gla_t, dict(zip(names, live)), torch.from_numpy(do),
                     torch.from_numpy(ds), inclusive, torch)
    assert counts[body] == 3
    gt = torch.autograd.grad(loss, live)
    assert counts[body] == 6
    t = 3 * CHUNK
    k_gla = CHUNK + DK + DV + t + CHUNK + 8
    _assert_grads(list(zip(names, gt)),
                  [np.asarray(a, np.float64) for a in gj],
                  lambda m: k_gla * U * m)


def _pairwise_in_place(r, k, qdec, cin):
    """``gla._pairwise``'s ops in the same order, worked in place on one
    [B,H,c,c,Dk] tensor."""
    w = qdec[:, :, :, None, :] - cin[:, :, None, :, :]
    w.clamp_(max=0.0).exp_()
    w.mul_(r[:, :, :, None, :]).mul_(k[:, :, None, :, :])
    return w.sum(-1)


@pytest.mark.parametrize("inclusive", [False, True],
                         ids=["exclusive-u", "inclusive"])
def test_out_of_place_chunk_equals_in_place(monkeypatch, inclusive):
    """The vector chunk with its out-of-place pairwise body against the
    same ops worked in place: the same outputs and state bit for bit, and
    ``chunked_gla`` the same bits with and without a gradient."""
    x, _, _ = _gla_inputs(12, 2, False, not inclusive)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    sl = slice(0, CHUNK)
    args = (t["r"][:, :, sl], t["k"][:, :, sl], t["v"][:, :, sl],
            t["g"][:, :, sl], t.get("u"), t["s0"], inclusive)
    o1, s1 = gla_t._chunk_vector(*args)
    with monkeypatch.context() as mp:
        mp.setattr(gla_t, "_pairwise", _pairwise_in_place)
        o2, s2 = gla_t._chunk_vector(*args)
    assert torch.equal(o1, o2) and torch.equal(s1, s2)
    kw = dict(u=t.get("u"), chunk=CHUNK, inclusive=inclusive,
              initial_state=t["s0"])
    with torch.no_grad():
        o_s, s_s = gla_t.chunked_gla(t["r"], t["k"], t["v"], t["g"], **kw)
    o_g, s_g = gla_t.chunked_gla(t["r"].requires_grad_(True), t["k"],
                                 t["v"], t["g"], **kw)
    assert torch.equal(o_s, o_g.detach()) and torch.equal(s_s,
                                                          s_g.detach())


# --------------------------------------------------------- whole runs
def _reference_train_losses(arch, steps):
    """The reference's ``launch.train`` loop (dense sgd, lr 1e-2) from its
    own ``Model.init``."""
    cfg = get_config_j(arch).reduced()
    model = ModelJ(cfg)
    rng = np.random.default_rng(0)
    opt = make_opt_j("sgd", 1e-2)
    params = model.init(jax.random.PRNGKey(0))
    state = opt.init(params)
    step = jax.jit(gs_j.make_train_step(model, opt))
    losses = []
    for _ in range(steps):
        toks = tokens_j(B, S + 1, cfg.vocab_size, rng)
        params, state, m = step(params, state, {
            "tokens": jnp.asarray(toks[:, :-1]),
            "labels": jnp.asarray(toks[:, 1:])})
        losses.append(float(m["loss"]))
    return losses, params


def test_train_rwkv6_losses_against_the_reference_loop():
    arch = "rwkv6-1.6b"
    want, _ = _reference_train_losses(arch, 3)
    init = jax.tree.map(np.asarray, ModelJ(get_config_j(arch).reduced())
                        .init(jax.random.PRNGKey(0)))
    res = train_t.run(train_t.TrainConfig(
        arch=arch, reduced=True, steps=3, batch=B, seq=S, device="cpu"),
        init_params=init)
    assert res["steps_run"] == [0, 1, 2]
    np.testing.assert_allclose(res["losses"], want, rtol=1e-4)
    fb = res["params"]["final_norm_b"]
    assert not fb.any()               # a zero gradient: never moves


FL = dict(arch="hymba-1.5b", reduced=True, clients=4, local_steps=1,
          batch=2, seq=S, cr=0.1, seed=5, verbose=False)
FAULTS = dict(fail_prob=0.25, over_selection=0.5, participation=0.75)


def _fl_init():
    return jax.tree.map(np.asarray, ModelJ(get_config_j(FL["arch"])
                                           .reduced()).init(
        jax.random.PRNGKey(FL["seed"])))


def _fl_t(init=None, **kw):
    return fl_t.run(fl_t.FLTrainConfig(**{**FL, "device": "cpu", **kw}),
                    init_params=init)


def test_fl_train_hymba_losses_against_the_reference():
    kw = dict(engine="round", rounds=3, strategy="bcrs_opwa", **FAULTS)
    rj = fl_j.run(fl_j.FLTrainConfig(**{**FL, **kw}))
    rt = _fl_t(_fl_init(), **kw)
    assert rt["executed_rounds"] == rj["executed_rounds"]
    np.testing.assert_allclose(rt["losses"], rj["losses"], rtol=1e-4)
    assert all(np.isfinite(rt["losses"]))


def test_fl_train_hymba_one_round_params_away_from_near_ties():
    """One bcrs_opwa round, every slot real: the new params held where no
    client's delta lies within twice the delta bound of its k-th
    magnitude (``tests/test_torch_fl_train.py``), by the round bound of
    ``tests/test_torch_mesh.py`` with this family's K."""
    from repro.core import cost_model as cost_j
    from repro.core.aggregation import AggregationConfig as AcfgJ
    init = _fl_init()
    kw = dict(engine="round", rounds=1, strategy="bcrs_opwa")
    rj = fl_j.run(fl_j.FLTrainConfig(**{**FL, **kw}))
    rt = _fl_t(init, **kw)
    cfg = fl_j.FLTrainConfig(**{**FL, **kw})
    model = ModelJ(get_config_j(cfg.arch).reduced())
    rng = np.random.default_rng(cfg.seed)
    links = cost_j.sample_links(cfg.clients, rng)
    leaves0 = [np.asarray(a) for a in jax.tree.leaves(init)]
    n_flat = sum(a.size for a in leaves0)
    plan = fl_j._build_plan(cfg, rng, np.full(cfg.clients, 0.25), links,
                            4.0 * n_flat, AcfgJ(strategy=cfg.strategy,
                                                cr=cfg.cr), None, None)
    batches = fl_j._round_batches(cfg, model.cfg.vocab_size, 0,
                                  cfg.c_slots)
    local = engine_j.make_masked_local_trainer(model.loss_fn, cfg.lr)
    dj, _ = jax.vmap(local, in_axes=(None, 0, 0))(
        jax.tree.map(jnp.asarray, init), jax.tree.map(jnp.asarray, batches),
        jnp.asarray(plan.step_mask[0]))
    w = np.asarray(plan.weights[0], np.float64)
    c, k = len(w), _k_grad(get_config(FL["arch"]).reduced(), FL["batch"],
                           FL["seq"])
    checked = 0
    for (path, a), b, p0, d in zip(
            engine_t.tree_items(rt["params"]),
            [np.asarray(x) for x in jax.tree.leaves(rj["params"])],
            leaves0, [np.asarray(x, np.float64)
                      for x in jax.tree.leaves(dj)]):
        tol = cfg.local_steps * (k * U * np.abs(d).max() + 4 * U * (
            np.abs(p0).max() + np.abs(d).max()))
        ks = np.asarray(comp_j.k_for_ratio_traced(p0.size,
                                                  jnp.asarray(plan.crs[0])))
        mag = np.abs(d.reshape(c, -1))
        kth = -np.sort(-mag, axis=1)[np.arange(c), ks - 1]
        keep = (~(np.abs(mag - kth[:, None]) <= 2 * tol).any(0)).reshape(
            p0.shape)
        wx = np.abs(w.reshape((-1,) + (1,) * p0.ndim) * d).sum(0)
        bound = (cfg.eta * cfg.gamma * (2 * c * U * wx + w.sum() * tol)
                 + 2 * U * np.abs(p0).max())
        diff = np.abs(a.numpy().astype(np.float64) - b)
        assert (diff[keep] <= bound[keep]).all(), path
        if p0.size >= 256 and (kth > 2 * tol).all():
            # not vacuous: a leaf of a few hundred elements or more whose
            # k-th magnitudes are clear of zero loses few to near-ties
            assert keep.mean() >= 0.9, path
            checked += 1
    assert checked >= 10
    assert abs(rt["losses"][0] - rj["losses"][0]) <= 1e-4 * rj["losses"][0]


def test_fl_train_hymba_scan_equals_the_round_engine():
    """The mesh scan (one program a run, the checkpointed backward inside
    the round body) against the round engine, bit for bit: params, losses
    and executed rounds, under faults, in chunks of 2 and 1."""
    kw = dict(rounds=3, strategy="bcrs_opwa", checkpoint_every=2, **FAULTS)
    key = ("mesh_scan", "bcrs_opwa")
    before = engine_t.TRACE_COUNTS[key]
    scan = _fl_t(engine="scan", **kw)
    assert engine_t.TRACE_COUNTS[key] - before == 1
    assert scan["chunk_rounds"] == [2, 1]
    loop = _fl_t(engine="round", **kw)
    assert scan["executed_rounds"] == loop["executed_rounds"]
    assert scan["losses"] == loop["losses"]
    for (path, a), (_, b) in zip(engine_t.tree_items(scan["params"]),
                                 engine_t.tree_items(loop["params"])):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), path
