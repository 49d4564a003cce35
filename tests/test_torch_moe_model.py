"""Port parity, the moe family's model: ``Model`` for deepseek-v3-671b (MLA,
a dense block then a MoE block, the MTP head) and kimi-k2-1t-a32b (GQA,
the same without MTP) — init, ``loss_fn`` (ce, aux, mtp) and its
gradients, prefill with dropped tokens, ``launch.train``, ``launch.fl_train``
and ``launch.serve`` — ``repro_torch`` on the CPU against ``repro`` on
the same inputs.

Params are the reference's ``Model.init`` carried across by ``convert``,
every leaf the reference sets to a constant redrawn from seeded numpy (as
``tests/test_torch_models.py`` does), at ``reduced()`` size (2 layers,
d_model 64, 4 experts of width 32, top-2), B = 2 x S = 32 tokens, f32
unless stated. Prefill and greedy decode against the reference are
``tests/test_torch_models.py``'s ``MODEL_CASES``.

Tolerances and why:
  * routing is a selection, so every comparison below first requires
    each token of each MoE layer to route clear of near-ties
    (``_routing_clear``): its k-th router logit above its (k+1)-th by more
    than twice what can move a logit between the packages, the two layer
    inputs' difference through the router plus the f32 router's
    worst-case rounding ``d * 2^-24 * sum_i |x_i w_i|``;
  * a loss and its terms: ``1e-4`` relative (the reduced model's loss
    tolerance, ``tests/test_torch_mesh.py``);
  * gradients, per leaf: ``K * 2^-24 * max|g|``, K the sum of the
    reduction lengths on the backward path (``_k_grad``, each term beside
    what it counts);
  * bf16 gradients, per leaf: ``6 * 2^-8 * sqrt(K16) * max|g|``, K16 the
    bf16 roundings on the backward path (``_k16``: R a block in the
    forward, ``FWD_ROUNDINGS``, and two in the backward for each), as
    ``tests/test_torch_recurrent_train.py``; that makes 0.35 / 0.26 of
    max|g| (deepseek / kimi), and a leaf's gradient halved or zeroed
    fails it (``test_bf16_grad_bound_rejects_a_planted_fault``); the loss
    within twice ``6 * 2^-8 * sqrt(sum R) * rms(logits)``;
  * within the port, bit for bit: the three ``remat`` modes, and the mesh
    scan against the round engine;
  * whole runs: per-step / per-round losses within ``1e-4`` relative.
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
from repro.core.bcrs import pod_link_schedule as pod_link_schedule_j
from repro.data import synthetic_lm_tokens as tokens_j
from repro.dist import grad_sync as gs_j
from repro.launch import fl_train as fl_j
from repro.models import attention as attn_j
from repro.models import layers as layers_j
from repro.models import mla as mla_j
from repro.models import moe as moe_j
from repro.models.transformer import Model as ModelJ
from repro.optim import make_optimizer as make_opt_j
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.dist.grad_sync import loss_and_grads
from repro_torch.fed import engine as engine_t
from repro_torch.launch import fl_train as fl_t
from repro_torch.launch import serve as serve_t
from repro_torch.launch import train as train_t
from repro_torch.models import Model
from repro_torch.models import moe as moe_t
from repro_torch.tree import tree_items

torch.set_num_threads(1)

ARCHS = ("deepseek-v3-671b", "kimi-k2-1t-a32b")
B, S = 2, 32
U = 2.0 ** -24
U16 = 2.0 ** -8
#: bf16 roundings a block in the forward at which the two packages may
#: land on neighbouring values. MLA 14 (ln1, wq_a, q_norm, wq_b, RoPE on
#: q, wkv_a, kv_norm, RoPE on the key, wk_b, wv_b, the probabilities, the
#: attention output, wo, the residual add); GQA 10 (ln1, q, k, v, RoPE on
#: q and k, the probabilities, the output, wo, the residual add); an MLP
#: 7 (ln2, up, gate, silu, the gated product, down, the residual add); a
#: MoE 14 (ln2, the experts' up, gate, silu, gated product and down, the
#: combine, the shared branch's five, its add, the residual add; the f32
#: router and the dispatch copy round nothing); MTP's head 3 (its two
#: norms and ``proj``) before its dense block.
ATTN_ROUNDINGS = {"deepseek-v3-671b": 14, "kimi-k2-1t-a32b": 10}
MLP_ROUNDINGS, MOE_ROUNDINGS, MTP_ROUNDINGS = 7, 14, 3


def _rand(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)
            ).astype(np.float32)


def _redraw_constants(tree, seed=100):
    """Every float leaf of more than one element that the reference
    initialises to a constant c (the norm scales) redrawn as c + 0.2 N
    (c = 1) or c + 0.5 N, so that every term it gates shows."""
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


def _cfgs(arch, dtype="float32", remat="none", **over):
    cj = dataclasses.replace(get_config_j(arch).reduced(), dtype=dtype,
                             remat=remat, **over)
    ct = dataclasses.replace(get_config(arch).reduced(), dtype=dtype,
                             remat=remat, **over)
    return cj, ct


@functools.lru_cache(maxsize=None)
def _params_np(arch, dtype="float32", seed=3):
    cj, _ = _cfgs(arch, dtype)
    init = jax.jit(ModelJ(cj).init)
    return _redraw_constants(jax.tree.map(np.asarray,
                                          init(jax.random.PRNGKey(seed))))


def _pair(arch, dtype="float32", remat="none", seed=3, **over):
    """(reference model, port model, reference params, port params) from
    the same numpy tree."""
    cj, ct = _cfgs(arch, dtype, remat, **over)
    params = _params_np(arch, dtype, seed)
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
    (loss, metrics), g = jax.jit(jax.value_and_grad(
        lambda p: model.loss_fn(p, batch), has_aux=True))(params)
    return float(loss), {k: float(v) for k, v in metrics.items()}, [
        np.asarray(jnp.asarray(a, jnp.float32), np.float64)
        for a in jax.tree.leaves(g)]


def _items_grads(model, params, batch):
    loss, metrics, grads = loss_and_grads(model.loss_fn, params, batch)
    return loss, metrics, [(p, g) for (p, _), g in zip(
        engine_t.tree_items(params), grads)]


def _moe_inputs(model, params, tokens):
    """Each MoE layer's input (``ln2``'s output) and params in the port's
    forward over ``tokens``."""
    seen = []
    real = moe_t.apply_moe

    def spy(p, x, **kw):
        seen.append((p, x))
        return real(p, x, **kw)

    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(moe_t, "apply_moe", spy)
        model.prefill(params, {"tokens": tokens})
    return seen


@functools.lru_cache(maxsize=None)
def _moe_inputs_fn(cfg):
    """A compiled function of (params, tokens) giving the reference's MoE
    layers' inputs (``ln2``'s output) at config ``cfg``: its blocks in
    order, each MoE block's first half from the reference's own
    functions."""
    model = ModelJ(cfg)
    eps = cfg.norm_eps

    def run(params, tokens):
        x = layers_j.embed_lookup(params["embed"]["w"], tokens)
        pos = jnp.arange(tokens.shape[1])
        nd, outs = cfg.moe.first_dense_layers, []
        for i in range(nd):
            p = jax.tree.map(lambda a: a[i], params["dense_layers"])
            x = model._block_fwd(p, x, pos, None)[0]
        for i in range(cfg.n_layers - nd):
            p = jax.tree.map(lambda a: a[i], params["moe_layers"])
            h = layers_j.rms_norm(x, p["ln1"], eps)
            if cfg.mla is not None:
                a = mla_j.apply_mla(p["attn"], h, n_heads=cfg.n_heads,
                                    m=cfg.mla, theta=cfg.rope_theta,
                                    positions=pos)
            else:
                a = attn_j.self_attention(p["attn"], h, cfg=cfg,
                                          positions=pos, causal=True)
            outs.append(layers_j.rms_norm(x + a, p["ln2"], eps))
            x = model._block_fwd(p, x, pos, None)[0]
        return outs

    return jax.jit(run)


def _routing(mj, pj, mt, pt, tokens_t):
    """Both packages' routing on their own MoE layer inputs over
    ``tokens_t``, every token of every MoE layer (the MTP block is dense):
    (the smallest ratio of a top-k margin to twice what can move a logit
    between the packages, ``sum_i |x_i - x'_i| |w_i| + d * 2^-24 * sum_i
    |x_i w_i|`` at its largest over the experts: the two inputs'
    difference through the router and the f32 router's worst-case
    rounding; the ratios of the tokens whose expert sets differ). Above
    1, both packages must pick the same experts."""
    k = mt.cfg.moe.top_k
    ours = _moe_inputs(mt, pt, tokens_t)
    theirs = _moe_inputs_fn(mj.cfg)(pj, jnp.asarray(tokens_t.numpy()))
    assert len(ours) == len(theirs) > 0
    worst, flipped = np.inf, []
    for (p, x), xj in zip(ours, theirs):
        d = x.shape[-1]
        xt = x.double().reshape(-1, d).numpy()
        xr = np.asarray(jnp.asarray(xj, jnp.float32), np.float64).reshape(
            -1, d)
        w = p["router"].double().numpy()
        lt, lr = xt @ w, xr @ w
        top = -np.sort(-lt, axis=1)
        move = np.abs(xt - xr) @ np.abs(w) + d * U * (np.abs(xt) @ np.abs(w))
        ratio = (top[:, k - 1] - top[:, k]) / (2 * move.max(1))
        worst = min(worst, float(ratio.min()))
        sets_t = np.sort(np.argsort(-lt, axis=1)[:, :k], axis=1)
        sets_r = np.sort(np.argsort(-lr, axis=1)[:, :k], axis=1)
        flipped += ratio[(sets_t != sets_r).any(1)].tolist()
    return worst, flipped


def _k_grad(cfg, b, s):
    """The gradient bound's K: the reduction lengths on the backward path
    of a reduced moe model."""
    d, mo = cfg.d_model, cfg.moe
    if cfg.mla is not None:
        m = cfg.mla
        attn = (m.q_lora_rank + m.kv_lora_rank      # the low-rank products
                + m.qk_nope_head_dim + m.qk_rope_head_dim  # q . k
                + s                                  # over the keys
                + cfg.n_heads * m.v_head_dim)        # wo's input width
    else:
        attn = s + cfg.n_heads * cfg.resolved_head_dim
    per = b * s + d + attn                           # weight grads; d_model
    moe_ffn = (mo.n_experts + 2 * mo.top_k           # softmax, gates
               + mo.d_expert                         # an expert's width
               + (mo.d_shared or mo.d_expert) * mo.n_shared)
    nd = mo.first_dense_layers
    k = nd * (per + cfg.d_ff) + (cfg.n_layers - nd) * (per + moe_ffn)
    if cfg.mtp_depth:
        k += per + cfg.d_ff + 2 * d                  # the block, proj
    return k + cfg.vocab_size


def _sum_r(arch, cfg):
    """The forward's bf16 roundings summed over the blocks (``sum R``)."""
    a, nd = ATTN_ROUNDINGS[arch], cfg.moe.first_dense_layers
    r = nd * (a + MLP_ROUNDINGS) + (cfg.n_layers - nd) * (a + MOE_ROUNDINGS)
    if cfg.mtp_depth:
        r += MTP_ROUNDINGS + a + MLP_ROUNDINGS
    return r


def _k16(arch, cfg):
    """bf16 roundings on the backward path: each forward one and two in
    the backward, plus the head (1 + 2) and the embedding (1)."""
    return 3 * _sum_r(arch, cfg) + 4


def _over_bound(got, want, tol_of):
    assert len(got) == len(want)
    out = []
    for (path, g), a in zip(got, want):
        bound = tol_of(np.abs(a).max())
        diff = np.abs(g.double().numpy() - a).max()
        if not diff <= bound:
            out.append((path, diff, bound))
    return out


# ----------------------------------------------------------------- build
@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_models_build(arch):
    """``Model(get_config(arch))`` at full width builds (nothing is
    allocated until ``init``)."""
    model = Model(get_config(arch), device="cpu")
    assert model.cfg.moe.n_experts in (256, 384)
    assert (model.cfg.mla is not None) == (arch == "deepseek-v3-671b")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_and_cache_layouts_match_the_reference(arch):
    """The port's own init and ``init_cache`` give the reference's trees:
    the same paths, shapes and dtypes (the f32 router among bf16 expert
    stacks; deepseek's ``{"mla": {"c_kv", "k_rope"}}`` for every layer,
    kimi's ``{"k", "v"}``), and a one-layer stack is not a copy."""
    cj, ct = _cfgs(arch, "bfloat16")
    shapes_j = jax.eval_shape(ModelJ(cj).init, jax.random.PRNGKey(0))
    model = Model(ct, device="cpu")
    params = model.init(0)
    want = {tuple(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(shapes_j)}
    got = dict(tree_items(params))
    assert set(got) == set(want)
    for path, leaf in got.items():
        assert tuple(leaf.shape) == want[path].shape, path
        assert str(leaf.dtype).replace("torch.", "") == str(
            want[path].dtype), path
    assert params["moe_layers"]["moe"]["router"].dtype == torch.float32
    cache_j = jax.eval_shape(lambda: ModelJ(cj).init_cache(2, 8))
    cache_t = model.init_cache(2, 8)
    flat_j = {tuple(str(getattr(k, "key", k)) for k in path): leaf
              for path, leaf in jax.tree_util.tree_leaves_with_path(cache_j)}
    flat_t = dict(tree_items(cache_t))
    assert set(flat_t) == set(flat_j)
    for path, leaf in flat_t.items():
        assert tuple(leaf.shape) == flat_j[path].shape, path
        assert not leaf.any()


# -------------------------------------------------------- loss and grads
@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_against_the_reference(arch, remat):
    """``Model.loss_fn`` (ce, aux and, for deepseek, mtp) and every leaf's
    gradient against ``jax.value_and_grad`` of the reference's, the
    reference at the same ``remat``."""
    mj, mt, pj, pt = _pair(arch, remat=remat)
    bj, bt = _batch(mt.cfg.vocab_size)
    k = _k_grad(mt.cfg, B, S)
    assert _routing(mj, pj, mt, pt, bt["tokens"])[0] > 1
    lj, metrics_j, gj = _grads_j(mj, pj, bj)
    lt, metrics_t, gt = _items_grads(mt, pt, bt)
    want = {"ce", "aux"} | ({"mtp"} if mt.cfg.mtp_depth else set())
    assert set(metrics_t) == set(metrics_j) == want
    assert abs(float(lt) - lj) <= 1e-4 * abs(lj)
    for name in want:
        assert abs(float(metrics_t[name]) - metrics_j[name]) <= \
            1e-4 * abs(metrics_j[name]), name
    bad = _over_bound(gt, gj, lambda m: k * U * m)
    assert not bad, bad


def test_dropped_tokens_against_the_reference():
    """deepseek at a capacity factor of 0.5: both packages keep and drop
    the same (token, slot) pairs, bit for bit, each on its own layer
    input; the port's routing helper counts the drops; the prefill logits
    agree."""
    arch = "deepseek-v3-671b"
    cj, ct = (dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, capacity_factor=0.5)) for c in _cfgs(arch))
    _, _, pj, pt = _pair(arch)
    mj, mt, mo = ModelJ(cj), Model(ct, device="cpu"), ct.moe
    bj, bt = _batch(mt.cfg.vocab_size, seed=1)
    assert _routing(mj, pj, mt, pt, bt["tokens"])[0] > 1
    dropped = []
    real = moe_t.apply_moe

    def counting(p, x, **kw):
        dropped.append(moe_t.dropped_tokens(p, x, kw["mo"]))
        return real(p, x, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(moe_t, "apply_moe", counting)
        with torch.no_grad():
            got, _ = mt.prefill(pt, {"tokens": bt["tokens"]})
    want, _ = jax.jit(mj.prefill)(pj, {"tokens": bj["tokens"]})
    assert len(dropped) == 1 and dropped[0] > 0
    (p, x), = _moe_inputs(mt, pt, bt["tokens"])
    xj, = _moe_inputs_fn(mj.cfg)(pj, bj["tokens"])
    pm = jax.tree.map(lambda a: a[0], pj["moe_layers"])["moe"]
    cap = moe_t.capacity(mo, B * S)
    _, _, ei, _, _ = moe_j._local_moe(pm, xj.reshape(B * S, -1), cj.moe,
                                      "swiglu", cap)
    _, keep_j = moe_j._dispatch_positions(ei, mo.n_experts, cap)
    keep = moe_t._local_moe(p, x.reshape(B * S, -1), mo, cap)[4]
    np.testing.assert_array_equal(keep.numpy(), np.asarray(keep_j))
    assert dropped[0] == int((~keep).sum())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@functools.lru_cache(maxsize=None)
def _bf16_run(arch):
    """One bf16 loss and gradient on each side (reduced, remat "none") and
    the bounds of the module docstring."""
    mj, mt, pj, pt = _pair(arch, dtype="bfloat16")
    cfg = mt.cfg
    bj, bt = _batch(cfg.vocab_size)
    worst, flipped = _routing(mj, pj, mt, pt, bt["tokens"])
    lj, _, gj = _grads_j(mj, pj, bj)
    lt, _, gt = _items_grads(mt, pt, bt)
    x = jax.jit(lambda p, t: mj._backbone(p, layers_j.embed_lookup(
        p["embed"]["w"], t), jnp.arange(S))[0])(pj, bj["tokens"])
    logits = np.asarray(jnp.asarray(layers_j.rms_norm(
        x, pj["final_norm"], cfg.norm_eps) @ pj["lm_head"]["w"],
        jnp.float32), np.float64)[..., :cfg.vocab_size]
    rms = np.sqrt((logits * logits).mean())
    k16 = _k16(arch, cfg)
    return dict(
        worst=worst, flipped=flipped, lt=float(lt), lj=lj, gt=gt, gj=gj,
        dtypes=[(path, g.dtype, p.dtype) for (path, g), (_, p) in zip(
            gt, engine_t.tree_items(pt))],
        loss_tol=2 * 6.0 * U16 * math.sqrt(_sum_r(arch, cfg)) * rms,
        tol_of=lambda m: 6.0 * U16 * math.sqrt(k16) * m)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_loss_and_grads_against_the_reference(arch):
    """bf16 loss and every leaf's gradient against the reference's within
    the module docstring's bounds, gradients in the params' dtype (the
    router's f32). The two packages' bf16 layer inputs differ by ULPs, so
    a token within that of a tie may route to other experts on each side
    (deepseek: 1 of the 64 here): every such token is one the bound
    ``_routing`` counts allows to (ratio <= 1), and they are at most 2."""
    run = _bf16_run(arch)
    assert all(r <= 1 for r in run["flipped"]) and len(run["flipped"]) <= 2
    assert abs(run["lt"] - run["lj"]) <= run["loss_tol"], (
        run["lt"], run["lj"], run["loss_tol"])
    for path, g_dtype, p_dtype in run["dtypes"]:
        assert g_dtype == p_dtype, path
    bad = _over_bound(run["gt"], run["gj"], run["tol_of"])
    assert not bad, bad


@pytest.mark.parametrize("fault", ["halved", "zeroed"])
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_grad_bound_rejects_a_planted_fault(arch, fault):
    """The bf16 bound is not vacuous: one leaf's gradient halved or zeroed
    fails it on that leaf and nowhere else, for every leaf."""
    run = _bf16_run(arch)
    gt, gj, tol_of = run["gt"], run["gj"], run["tol_of"]
    for i, ((path, g), a) in enumerate(zip(gt, gj)):
        assert np.abs(a).max() > 0, path
        bad = list(gt)
        bad[i] = (path, g * 0.5 if fault == "halved" else torch.zeros_like(g))
        assert [p for p, _, _ in _over_bound(bad, gj, tol_of)] == [path]


# ---------------------------------------------------- remat within the port
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_modes_bit_for_bit(monkeypatch, arch, dtype):
    """"none", "full" and "dots": the same loss, aux, mtp and every
    gradient bit for bit; each backbone block runs once a pass with
    "none" and twice with the others (the MTP block is never
    checkpointed: one more call in every mode)."""
    base = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    params = Model(base, device="cpu").init(0)
    _, bt = _batch(base.vocab_size)
    mtp = 1 if base.mtp_depth else 0
    outs = {}
    for mode in ("none", "full", "dots"):
        counts = {}
        fn = Model._block_fwd

        def counted(*a, **kw):
            counts["n"] = counts.get("n", 0) + 1
            return fn(*a, **kw)
        monkeypatch.setattr(Model, "_block_fwd", counted)
        model = Model(dataclasses.replace(base, remat=mode), device="cpu")
        outs[mode] = _items_grads(model, params, bt)
        monkeypatch.undo()
        runs = 1 if mode == "none" else 2
        assert counts["n"] == runs * base.n_layers + mtp, (mode, counts)
    lo, mo_, go = outs["none"]
    for mode in ("full", "dots"):
        loss, metrics, grads = outs[mode]
        assert torch.equal(loss, lo), mode
        assert all(torch.equal(metrics[k], mo_[k]) for k in mo_), mode
        for (path, a), (_, b) in zip(grads, go):
            assert a.dtype == b.dtype and torch.equal(a, b), (mode, path)


# --------------------------------------------------------- launch.train
TRAIN = dict(reduced=True, batch=4, seq=32, seed=0)


def _reference_losses(arch, init, steps, pods=0, wire_cr=0.1):
    """The reference's ``launch.train`` loop (``src/repro/launch/
    train.py``: sgd, lr 1e-2) from ``init``."""
    cfg = get_config_j(arch).reduced()
    model = ModelJ(cfg)
    rng = np.random.default_rng(TRAIN["seed"])
    opt = make_opt_j("sgd", 1e-2)
    params = jax.tree.map(jnp.asarray, init)
    state = (gs_j.init_compressed_state(opt, params, n_pods=pods)
             if pods else opt.init(params))
    if pods:
        step_fn = jax.jit(gs_j.make_compressed_train_step(
            model, opt, n_pods=pods, wire_cr=wire_cr, gamma=2.0))
        n_flat = sum(int(np.prod(l.shape)) for l in jax.tree.leaves(params))
        crs = pod_link_schedule_j([100.0 / (i + 1) for i in range(pods)],
                                  v_bytes=4 * n_flat, cr_star=wire_cr / 2,
                                  cr_max=wire_cr)
        args = (jnp.asarray(crs, jnp.float32),
                jnp.full((pods,), 1.0 / pods, jnp.float32))
    else:
        step_fn, args = jax.jit(gs_j.make_train_step(model, opt)), ()
    b, s = TRAIN["batch"], TRAIN["seq"]
    losses = []
    for _ in range(steps):
        toks = tokens_j(b, s + 1, cfg.vocab_size, rng)
        params, state, m = step_fn(params, state, {
            "tokens": jnp.asarray(toks[:, :-1]),
            "labels": jnp.asarray(toks[:, 1:])}, *args)
        losses.append(float(m["loss"]))
    return losses


@pytest.mark.parametrize("pods", [0, 2], ids=["dense", "2 pods"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_losses_against_the_reference_loop(arch, pods):
    """``launch.train`` (sgd; ``--compressed-pods 2 --wire-cr 0.1``) from
    the reference's init: the losses of 3 steps; with pods, EF residuals
    nonzero on the compressed leaves (the expert stacks among them) and
    exactly 0 on the router, which is exchanged dense."""
    init = jax.tree.map(np.asarray, jax.jit(ModelJ(
        get_config_j(arch).reduced()).init)(jax.random.PRNGKey(0)))
    want = _reference_losses(arch, init, 3, pods=pods)
    kw = dict(compressed_pods=pods, wire_cr=0.1) if pods else {}
    res = train_t.run(train_t.TrainConfig(
        **{**TRAIN, "arch": arch, "device": "cpu", "steps": 3, **kw}),
        init_params=init)
    assert res["steps_run"] == [0, 1, 2]
    np.testing.assert_allclose(res["losses"], want, rtol=1e-4)
    if pods:
        ef = dict(tree_items(res["opt_state"]["ef"]))
        assert ef[("moe_layers", "moe", "w_up")].any()
        assert not ef[("moe_layers", "moe", "router")].any()


# ------------------------------------------------------------- fl_train
FL = dict(arch="deepseek-v3-671b", reduced=True, clients=4, local_steps=1,
          batch=2, seq=S, cr=0.1, seed=5, verbose=False)
FAULTS = dict(fail_prob=0.25, over_selection=0.5, participation=0.75)


def _fl_t(init=None, **kw):
    return fl_t.run(fl_t.FLTrainConfig(**{**FL, "device": "cpu", **kw}),
                    init_params=init)


FL_KW = dict(rounds=3, strategy="bcrs_opwa", **FAULTS)


@functools.lru_cache(maxsize=None)
def _fl_runs():
    """The reference's ``fl_train`` (its default engine, the mesh scan)
    and the port's round engine and mesh scan (chunks of 2 and 1) from
    the reference's init, with a captured-program count."""
    rj = fl_j.run(fl_j.FLTrainConfig(**{**FL, **FL_KW}))
    init = jax.tree.map(np.asarray, jax.jit(ModelJ(
        get_config_j(FL["arch"]).reduced()).init)(
        jax.random.PRNGKey(FL["seed"])))
    key = ("mesh_scan", "bcrs_opwa")
    before = engine_t.TRACE_COUNTS[key]
    scan = _fl_t(init, engine="scan", checkpoint_every=2, **FL_KW)
    programs = engine_t.TRACE_COUNTS[key] - before
    loop = _fl_t(init, engine="round", **FL_KW)
    return rj, {"scan": scan, "round": loop}, programs


@pytest.mark.parametrize("engine", ["round", "scan"])
def test_fl_train_losses_against_the_reference(engine):
    """``fl_train --arch deepseek-v3-671b --reduced`` (bcrs_opwa, faults)
    through the round engine and the mesh scan: executed rounds and the
    losses of each round against the reference's run."""
    rj, runs, _ = _fl_runs()
    rt = runs[engine]
    assert rt["executed_rounds"] == rj["executed_rounds"]
    np.testing.assert_allclose(rt["losses"], rj["losses"], rtol=1e-4)


def test_fl_train_scan_equals_the_round_engine():
    """The mesh scan (one program a run, the MoE's routing, dispatch and
    gather inside the round body) against the round engine, bit for
    bit: params, losses and executed rounds, under faults, in chunks of 2
    and 1."""
    _, runs, programs = _fl_runs()
    scan, loop = runs["scan"], runs["round"]
    assert programs == 1 and scan["chunk_rounds"] == [2, 1]
    assert scan["executed_rounds"] == loop["executed_rounds"]
    assert scan["losses"] == loop["losses"]
    for (path, a), (_, b) in zip(tree_items(scan["params"]),
                                 tree_items(loop["params"])):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), path


# ---------------------------------------------------------------- serve
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_on_the_cpu(arch, monkeypatch, capsys):
    """``launch.serve`` at ``--reduced --device cpu``: greedy tokens from
    the prompt stepped through the decode (MLA's latent cache for
    deepseek), finite logits."""
    monkeypatch.setattr("sys.argv", [
        "serve", "--arch", arch, "--reduced", "--device", "cpu",
        "--batch", "2", "--prompt-len", "6", "--gen", "4"])
    serve_t.main()
    out = capsys.readouterr().out
    assert f"arch={arch}" in out and "sample tokens" in out
