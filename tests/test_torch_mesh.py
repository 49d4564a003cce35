"""Port parity, the real-model FL round: ``layers.cross_entropy``,
``Model.loss_fn`` for the dense family, the model trainer
(``engine.make_model_local_trainer``), ``engine.compress_merge_leaf``,
``engine.init_mesh_residuals`` and ``fed.mesh_round`` — ``repro_torch`` on
the CPU against ``repro`` on the same inputs (seeded numpy; model params
are the reference's ``Model.init`` carried across by ``convert``; reduced
configs only: 2 layers, d_model 64, vocab 256).

Tolerances and why:
  * cross-entropy on the same logits: ``1e-6`` relative (one logsumexp and
    one mean of a few dozen terms, in f32);
  * a reduced model's loss: ``1e-4`` relative, as its logits are held in
    ``tests/test_torch_models.py``;
  * gradients, per leaf: ``K * 2^-24 * max|g|`` with ``K`` the sum of the
    reduction lengths on the backward path (the vocab for the softmax, and
    per layer the token count B*S for the weight grads, d_model and d_ff
    for the activation grads, S for attention) — every term of a gradient
    is a sum of at most that many f32 products, summed in another order
    than XLA's;
  * deltas of ``S`` local steps, per leaf: ``S * (K * 2^-24 * max|d| +
    2^-22 * (max|p| + max|d|))``: a step is ``p - lr*g``, the gradient
    within the bound above (``lr*g`` scales like ``d``), plus one rounding
    of ``lr*g`` and one of the subtraction on each side;
  * selections, masks, retained counts and EF residuals on identical
    inputs: bit for bit; merged aggregates ``2*C*2^-24*gamma*sum_c|w_c v_c|``
    per element (the same f32 products summed in another order);
  * a round from the same params (the deltas now differ within their
    bound): elements where some active client's corrected value lies
    within twice the delta bound of its k-th magnitude are excluded (the
    selection may flip there: a near-tie); elsewhere the new params within
    ``eta*gamma*(2*C*2^-24*sum_c|w_c x_c| + sum_c|w_c|*delta_bound) +
    2^-23*max|p|`` and the EF residuals within the delta bound.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as get_config_j
from repro.core import compression as comp_j
from repro.core import strategies as strat_j
from repro.fed import engine as engine_j
from repro.fed import mesh_round as mesh_j
from repro.models import layers as layers_j
from repro.models.transformer import Model as ModelJ
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import compression as comp_t
from repro_torch.core import strategies as strat_t
from repro_torch.fed import engine as engine_t
from repro_torch.fed import mesh_round as mesh_t
from repro_torch.models import Model
from repro_torch.models import layers as layers_t

torch.set_num_threads(1)

DENSE = ("stablelm-1.6b", "yi-9b", "qwen2.5-14b")
STRATEGIES = ("fedavg", "topk", "bcrs", "bcrs_opwa", "eftopk")
U = 2.0 ** -24


def _t(a):
    return torch.from_numpy(np.array(a))


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def _leaves(tree):
    return [np.asarray(leaf) for leaf in jax.tree.leaves(tree)]


def _k_model(cfg, b, s):
    """Sum of the reduction lengths on the backward path of a reduced
    model (the grad bound's K)."""
    return cfg.n_layers * (b * s + cfg.d_model + cfg.d_ff + s) \
        + cfg.vocab_size


def _delta_tol(p, d, steps, k):
    p, d = np.abs(np.asarray(p, np.float64)), np.abs(np.asarray(d,
                                                                np.float64))
    return steps * (k * U * d.max() + 4 * U * (p.max() + d.max()))


def _model_pair(arch, seed=3):
    cj = get_config_j(arch).reduced()
    mj, mt = ModelJ(cj), Model(get_config(arch).reduced(), device="cpu")
    pj = mj.init(jax.random.PRNGKey(seed))
    pt = convert.model_params_to_torch(jax.tree.map(np.asarray, pj),
                                       device="cpu")
    return cj, mj, mt, pj, pt


def _tokens(vocab, *shape, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, vocab, shape[:-1] + (shape[-1] + 1,)).astype(np.int32)
    return toks[..., :-1], toks[..., 1:]


# ------------------------------------------------------------ loss and grads
@pytest.mark.parametrize("v_pad,vocab", [(256, 256), (512, 300)])
def test_cross_entropy(v_pad, vocab):
    rng = np.random.default_rng(v_pad)
    logits = (3 * rng.normal(size=(2, 9, v_pad))).astype(np.float32)
    labels = rng.integers(0, vocab, (2, 9)).astype(np.int32)
    want = float(layers_j.cross_entropy(jnp.asarray(logits),
                                        jnp.asarray(labels), vocab))
    got = float(layers_t.cross_entropy(_t(logits), _t(labels), vocab))
    assert abs(got - want) <= 1e-6 * abs(want)
    # bf16 logits are cast to f32 first, as in the reference
    lb = _t(logits).to(torch.bfloat16)
    got_b = float(layers_t.cross_entropy(lb, _t(labels), vocab))
    want_b = float(layers_j.cross_entropy(
        jnp.asarray(lb.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(labels), vocab))
    assert abs(got_b - want_b) <= 1e-6 * abs(want_b)


def test_onehot_embedding_equals_the_gather():
    rng = np.random.default_rng(1)
    table = _t(rng.normal(size=(50, 8)).astype(np.float32))
    toks = _t(rng.integers(0, 50, (3, 7)).astype(np.int32))
    assert torch.equal(layers_t.embed_onehot(table, toks),
                       layers_t.embed_lookup(table, toks.long()))


@pytest.mark.parametrize("arch", DENSE)
def test_loss_fn_and_grads(arch):
    cj, mj, mt, pj, pt = _model_pair(arch)
    b, s = 2, 16
    toks, labels = _tokens(cj.vocab_size, b, s)
    bj = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    bt = {"tokens": _t(toks), "labels": _t(labels)}
    (lj, mets_j), gj = jax.value_and_grad(
        lambda p: mj.loss_fn(p, bj), has_aux=True)(pj)
    items = engine_t.tree_items(pt)
    live = [t.requires_grad_(True) for _, t in items]
    lt, mets_t = mt.loss_fn(
        engine_t.tree_from_items(zip([k for k, _ in items], live)), bt)
    gt = torch.autograd.grad(lt, live)
    assert set(mets_t) == set(mets_j) == {"ce"}
    assert abs(float(lt.detach()) - float(lj)) <= 1e-4 * abs(float(lj))
    k = _k_model(cj, b, s)
    gjl = _leaves(gj)
    assert len(gjl) == len(gt)
    for (path, _), a, g in zip(items, gjl, gt):
        bound = k * U * np.abs(a).max()
        diff = np.abs(g.numpy().astype(np.float64) - a).max()
        assert diff <= bound, (path, diff, bound)


# ------------------------------------------------------------- the trainer
def _linear_loss_j(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    err = pred - batch["t"]
    return jnp.mean(err * err), pred


def _linear_loss_t(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    err = pred - batch["t"]
    return torch.mean(err * err), pred


def _linear_case(seed=0, c=3, s=2, b=4, dim=12, out=5):
    """The linear model of ``tests/test_mesh_scan.py``: params, one round's
    batches with ragged steps, a padded cohort slot and per-client CRs."""
    rng = np.random.default_rng(seed)
    params = {"w": rng.normal(size=(dim, out)).astype(np.float32),
              "b": rng.normal(size=(out,)).astype(np.float32)}
    active = np.zeros(c, bool)
    active[:c - 1] = True
    step_mask = np.zeros((c, s), bool)
    step_mask[0] = True
    step_mask[1, :1] = True
    weights = np.where(active, rng.dirichlet(np.ones(c)), 0).astype(
        np.float32)
    batches = {"x": rng.normal(size=(c, s, b, dim)).astype(np.float32),
               "t": rng.normal(size=(c, s, b, out)).astype(np.float32)}
    crs = rng.uniform(0.05, 0.9, size=c).astype(np.float32)
    return params, batches, step_mask, weights, crs, active, b * out + dim


def _deltas_j(loss_j, pj, batches, step_mask, lr):
    local = engine_j.make_masked_local_trainer(loss_j, lr)
    return jax.vmap(local, in_axes=(None, 0, 0))(
        pj, jax.tree.map(jnp.asarray, batches), jnp.asarray(step_mask))


def _assert_deltas(dt, lt, dj, lj, pj, steps, k):
    for path_a, a, p in zip(engine_t.tree_items(dt), _leaves(dj),
                            _leaves(pj)):
        tol = _delta_tol(p, a, steps, k)
        diff = np.abs(path_a[1].numpy().astype(np.float64) - a).max()
        assert diff <= tol, (path_a[0], diff, tol)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5,
                               atol=0)


def test_trainer_linear_ragged_steps():
    p, batches, step_mask, *_ , k = _linear_case(seed=4)
    lr = 1e-2
    dj, lj = _deltas_j(_linear_loss_j, jax.tree.map(jnp.asarray, p),
                       batches, step_mask, lr)
    train = engine_t.make_model_local_trainer(_linear_loss_t, lr)
    dt, lt = train({k_: _t(v) for k_, v in p.items()},
                   {k_: _t(v) for k_, v in batches.items()}, _t(step_mask))
    _assert_deltas(dt, lt, dj, lj, p, step_mask.shape[1], k)
    # a slot with no real step: an exact zero delta and loss
    assert not dt["w"][2].any() and float(lt[2]) == 0.0 == float(lj[2])


def test_trainer_model_ragged_steps():
    cj, mj, mt, pj, pt = _model_pair("stablelm-1.6b", seed=7)
    c, s, b, sl = 3, 2, 2, 16
    toks, labels = _tokens(cj.vocab_size, c, s, b, sl, seed=5)
    step_mask = np.array([[True, True], [True, False], [False, False]])
    lr = 5e-2
    dj, lj = _deltas_j(mj.loss_fn, pj, {"tokens": toks, "labels": labels},
                       step_mask, lr)
    train = engine_t.make_model_local_trainer(mt.loss_fn, lr)
    dt, lt = train(pt, {"tokens": _t(toks), "labels": _t(labels)},
                   _t(step_mask))
    _assert_deltas(dt, lt, dj, lj, pj, s, _k_model(cj, b, sl))
    for _, d in engine_t.tree_items(dt):
        assert not d[2].any()


# ------------------------------------------------------ compress_merge_leaf
def _leaf_case(seed, c=5, shape=(6, 37)):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(c,) + shape).astype(np.float32)
    u[1, 0, :20] = u[1, 0, 0]                     # ties across the k-th
    u[2] *= np.float32(1e-3)
    res = (0.3 * rng.normal(size=(c,) + shape)).astype(np.float32)
    w = rng.uniform(0.1, 1.0, c).astype(np.float32)
    n = int(np.prod(shape))
    crs = np.array([0.05, 0.5, 1.0, 0.2, 0.01][:c], np.float32)
    active = np.ones(c, bool)
    active[-1] = False
    u[-1] = 0.0                                   # a padded slot
    return u, res, w, crs, active, n


def _agg_bound(w, vals, gamma):
    terms = np.abs(np.asarray(w, np.float64).reshape(
        (-1,) + (1,) * (vals.ndim - 1)) * np.asarray(vals, np.float64))
    return 2 * terms.shape[0] * U * gamma * terms.sum(0)


@pytest.mark.parametrize("strategy",
                         ["topk", "bcrs", "bcrs_opwa", "eftopk", "qtopk",
                          "int4"])
@pytest.mark.parametrize("shape", [(6, 37), (2, 4, 33)])
def test_compress_merge_leaf(strategy, shape):
    """The port's plain route (``"auto"`` on CPU tensors) and its kernel
    route (the kernels' twins on CPU tensors) against the reference's
    plain route and its Pallas route in interpret mode, on identical
    inputs."""
    u, res, w, crs, active, n = _leaf_case(len(shape) * 7 + len(strategy),
                                           shape=shape)
    sj = strat_j.get(strategy)
    ef = sj.needs_residuals
    gamma = 3.0
    ks_j = comp_j.k_for_ratio_traced(n, jnp.asarray(crs))
    ks_t = comp_t.k_for_ratio_traced(n, _t(crs))
    np.testing.assert_array_equal(ks_t.numpy(), np.asarray(ks_j))
    kw_j = dict(gamma=gamma, overlap_d=1, opwa=sj.overlap_weighted,
                residuals=jnp.asarray(res) if ef else None,
                active=jnp.asarray(active), value_codec=sj.value_codec,
                kernel_codec=sj.kernel_codec)
    stt = strat_t.get(strategy)
    kw_t = dict(gamma=gamma, overlap_d=1, opwa=stt.overlap_weighted,
                residuals=_t(res) if ef else None, active=_t(active),
                value_codec=stt.value_codec, kernel_codec=stt.kernel_codec)
    refs = [engine_j.compress_merge_leaf(jnp.asarray(u), jnp.asarray(w),
                                         ks_j, use_kernel=uk, **kw_j)
            for uk in (False, True)]
    ports = [engine_t.compress_merge_leaf(_t(u), _t(w), ks_t,
                                          use_kernel="auto", **kw_t)]
    w_act = np.where(active, w, 0).astype(np.float32)
    ports.append(engine_t._merge_leaf_kernels(
        _t(u), _t(w_act), ks_t, gamma=gamma, overlap_d=1,
        opwa=stt.overlap_weighted, residuals=kw_t["residuals"],
        active=_t(active), kernel_codec=stt.kernel_codec))
    # the selection inside the plain route, bit for bit
    x = u + res if ef else u
    mask_j = np.asarray(jax.vmap(comp_j.topk_compress_dynamic)(
        jnp.asarray(x), ks_j).mask)
    mask_t = comp_t.topk_compress_dynamic(
        _t(x).reshape(len(u), -1), ks_t).mask.reshape(x.shape).numpy()
    np.testing.assert_array_equal(mask_t, mask_j)
    vals = np.where(mask_j, x, 0) * active.reshape((-1,) + (1,) * len(shape))
    if sj.value_codec is not None:
        vals = np.asarray(sj.value_codec(jnp.asarray(np.where(mask_j, x, 0)),
                                         jnp.asarray(mask_j)))
        vals = vals * active.reshape((-1,) + (1,) * len(shape))
    bound = _agg_bound(w_act, vals, gamma if sj.overlap_weighted else 1.0)
    for agg_j, res_j in refs:
        for agg_t, res_t in ports:
            assert tuple(agg_t.shape) == shape
            diff = np.abs(agg_t.numpy().astype(np.float64)
                          - np.asarray(agg_j, np.float64))
            assert (diff <= bound).all(), float((diff - bound).max())
            if ef:
                np.testing.assert_array_equal(_bits(res_t.numpy()),
                                              _bits(np.asarray(res_j)))
            else:
                assert res_t is None and res_j is None


def test_init_mesh_residuals():
    _, _, _, pj, pt = _model_pair("stablelm-1.6b")
    rj = engine_j.init_mesh_residuals(pj, 3)
    rt = engine_t.init_mesh_residuals(pt, 3)
    got = engine_t.tree_items(rt)
    want = jax.tree_util.tree_leaves_with_path(rj)
    assert len(got) == len(want)
    for (path, t), (_, a) in zip(got, want):
        assert tuple(t.shape) == a.shape and t.dtype == torch.float32
        assert not t.any()


# ------------------------------------------------------------ round steps
def _near_ties(x, ks, tol, active):
    """True where some active client's |x| lies within ``tol`` of its
    k-th largest magnitude: the selection may flip there."""
    c = x.shape[0]
    mag = np.abs(x.reshape(c, -1).astype(np.float64))
    kth = -np.sort(-mag, axis=1)[np.arange(c), np.asarray(ks) - 1]
    near = (np.abs(mag - kth[:, None]) <= tol) & active[:, None]
    return near.any(0).reshape(x.shape[1:])


def _hold_round(strategy, new_t, res_t, loss_t, new_j, res_j, loss_j, pj,
                dj, w, crs, active, steps, k, eta=1.0, gamma=3.0):
    """The new params (and EF residuals) of one round from the same params,
    away from near-ties, within the bounds of the module docstring."""
    sj = strat_j.get(strategy)
    g = gamma if sj.overlap_weighted else 1.0
    w_act = np.where(active, w, 0).astype(np.float64)
    c = len(w)
    res_items = (engine_t.tree_items(res_t) if sj.needs_residuals
                 else [None] * len(_leaves(pj)))
    for (path, pt_new), a_new, p0, d, r_t, r_j in zip(
            engine_t.tree_items(new_t), _leaves(new_j), _leaves(pj),
            _leaves(dj), res_items,
            _leaves(res_j) if sj.needs_residuals else res_items):
        tol = _delta_tol(p0, d, steps, k)
        x = d.astype(np.float64)
        keep = np.ones(p0.shape, bool)
        if sj.compresses:
            ks = np.asarray(comp_j.k_for_ratio_traced(p0.size,
                                                      jnp.asarray(crs)))
            keep = ~_near_ties(x.astype(np.float32), ks, 2 * tol, active)
        wx = np.abs(w_act.reshape((-1,) + (1,) * p0.ndim) * x).sum(0)
        bound = (eta * g * (2 * c * U * wx + w_act.sum() * tol)
                 + 2 * U * np.abs(p0).max())
        diff = np.abs(pt_new.numpy().astype(np.float64) - a_new)
        assert (diff[keep] <= bound[keep]).all(), (path, strategy)
        if r_t is not None:
            rd = np.abs(r_t[1].numpy().astype(np.float64) - r_j)
            assert (rd[:, keep] <= tol).all(), (path, "residual")
    assert abs(float(loss_t) - float(loss_j)) <= 1e-5 * abs(float(loss_j))


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_mesh_round_step_linear(strategy):
    p, batches, step_mask, w, crs, active, k = _linear_case(seed=9)
    pj = jax.tree.map(jnp.asarray, p)
    ef = strat_j.get(strategy).needs_residuals
    step_j = mesh_j.make_mesh_round_step(_linear_loss_j, lr_local=1e-2,
                                         strategy=strategy, gamma=3.0,
                                         donate=False)
    res0_j = engine_j.init_mesh_residuals(pj, 3) if ef else None
    new_j, res_j, loss_j = step_j(pj, res0_j,
                                  jax.tree.map(jnp.asarray, batches),
                                  jnp.asarray(step_mask), jnp.asarray(w),
                                  jnp.asarray(crs), jnp.asarray(active))
    before = mesh_t.TRACE_COUNTS[(strategy,)]
    step_t = mesh_t.make_mesh_round_step(_linear_loss_t, lr_local=1e-2,
                                         strategy=strategy, gamma=3.0,
                                         donate=False)
    assert mesh_t.TRACE_COUNTS[(strategy,)] - before == 1
    pt = {k_: _t(v) for k_, v in p.items()}
    res0_t = engine_t.init_mesh_residuals(pt, 3) if ef else None
    args = ({k_: _t(v) for k_, v in batches.items()}, _t(step_mask), _t(w),
            _t(crs), _t(active))
    new_t, res_t, loss_t = step_t(pt, res0_t, *args)
    dj, _ = _deltas_j(_linear_loss_j, pj, batches, step_mask, 1e-2)
    _hold_round(strategy, new_t, res_t, loss_t, new_j, res_j, loss_j, pj,
                dj, w, crs, active, step_mask.shape[1], k)
    # the inputs are untouched; donating gives the same bits in place
    np.testing.assert_array_equal(pt["w"].numpy(), p["w"])
    step_d = mesh_t.make_mesh_round_step(_linear_loss_t, lr_local=1e-2,
                                         strategy=strategy, gamma=3.0)
    pd = {k_: v.clone() for k_, v in pt.items()}
    rd = engine_t.init_mesh_residuals(pd, 3) if ef else None
    out_d, res_d, loss_d = step_d(pd, rd, *args)
    for key in pt:
        assert out_d[key] is pd[key]
        assert torch.equal(out_d[key], new_t[key])
    if ef:
        assert res_d["w"] is rd["w"] and torch.equal(res_d["w"],
                                                     res_t["w"])
    assert float(loss_d) == float(loss_t)


@pytest.mark.parametrize("compress", [False, True])
def test_fl_round_step_reduced_stablelm(compress):
    cj, mj, mt, pj, pt = _model_pair("stablelm-1.6b", seed=11)
    c, s, b, sl = 3, 2, 2, 16
    toks, labels = _tokens(cj.vocab_size, c, s, b, sl, seed=6)
    w = np.array([0.5, 0.3, 0.2], np.float32)
    crs = np.array([0.05, 0.2, 0.5], np.float32)
    lr = 5e-2
    fl_j = mesh_j.make_fl_round_step(mj, lr_local=lr, gamma=3.0,
                                     compress=compress)
    new_j, loss_j = fl_j(pj, {"tokens": jnp.asarray(toks),
                              "labels": jnp.asarray(labels)},
                         jnp.asarray(w), jnp.asarray(crs))
    fl_t = mesh_t.make_fl_round_step(mt, lr_local=lr, gamma=3.0,
                                     compress=compress)
    new_t, loss_t = fl_t(pt, {"tokens": _t(toks), "labels": _t(labels)},
                         _t(w), _t(crs))
    dj, _ = _deltas_j(mj.loss_fn, pj, {"tokens": toks, "labels": labels},
                      np.ones((c, s), bool), lr)
    strategy = "bcrs_opwa" if compress else "fedavg"
    _hold_round(strategy, new_t, None, loss_t, new_j, None, loss_j, pj, dj,
                w, crs, np.ones(c, bool), s, _k_model(cj, b, sl))
