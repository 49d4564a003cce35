"""Port parity, ``repro_torch.optim`` against ``repro.optim`` computed live
on the same seeded numpy inputs.

What is held, and how closely:
  * sgd, momentum and adamw (with and without weight decay) for ``T = 6``
    steps on a tree of an f32 matrix, an f32 vector and a bf16 matrix, the
    gradients given (seeded, independent of the params). The state's
    structure is the reference's (``()``; a tree of f32 zeros; ``{"m",
    "v", "t"}`` with ``t`` int32) and ``t`` exact. Each step starts both
    sides from the reference's params and state, so a step's error does
    not hide in the run's, and is held element by element:
      - f32 state leaves within ``ulp(|s|) + 4 * 2^-24 * (|s_prev| +
        |g|^q)`` (q = 2 for adamw's v, else 1), the size of the terms they
        sum: XLA may contract a multiply and an add into one fma;
      - bf16 leaves bit for bit wherever that state agrees bit for bit
        (sgd has none: everywhere), else within one ulp of their own
        element. Both sides compute each bf16 op in f32 and round its
        result to bf16 once (sgd, momentum: ``lr`` rounded to bf16, ``lr *
        g``, ``p - u``), or run adamw's step in f32 and round ``p - step``
        once, so the same values round to the same bits. An ulp bound
        alone would pass an ``lr`` left unrounded: that moves ``u`` by under
        half an ulp of ``u``. The bf16 params are at the models' initial
        scale (0.02), where a step moves them by many ulps;
      - f32 param leaves within ``ulp(|p|) + 16 * 2^-24 * |u|`` of their
        own element (``u`` the reference's update of it);
  * the same check rejects an optimizer whose bf16 arithmetic is wrong:
    ``lr`` not rounded to bf16 first, the bf16 update skipped, its sign
    flipped;
  * ``clip_by_global_norm``: the norm within the summation-order bound
    ``(N + L) * 2^-24`` of itself (N the largest leaf, L the leaf count: a
    sequential sum's bound, which covers any order), the clipped grads
    within two roundings of their size plus that bound on the scale;
  * the schedules: equal, float for float, at every step of a run;
  * ``make_optimizer``'s names and its ``ValueError``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as opt_j
from repro.optim import schedules as sch_j
from repro_torch import optim as optim_t
from repro_torch.optim import optimizers as opt_t
from repro_torch.optim import schedules as sch_t
from repro_torch.tree import tree_items

torch.set_num_threads(1)

T = 6
U = 2.0 ** -24
SHAPES = {"w": (48, 33), "b": (70,), "h": (40, 24)}
BF16 = ("h",)               # the bf16 leaf (stablelm's matrices are bf16)
INIT_SCALE = {"h": 0.02}    # the models' initial weights (layers.py)


def _tree(rng, scale=1.0):
    return {k: (scale * rng.normal(size=s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _params(rng):
    return {k: (v * INIT_SCALE.get(k, 1.0)).astype(np.float32)
            for k, v in _tree(rng).items()}


def _to_j(tree):
    return {k: jnp.asarray(v).astype(jnp.bfloat16 if k in BF16
                                     else jnp.float32)
            for k, v in tree.items()}


def _to_t(tree):
    return {k: torch.from_numpy(v).to(torch.bfloat16 if k in BF16
                                      else torch.float32)
            for k, v in tree.items()}


def _j_to_t(x):
    """A jax array as the torch tensor of the same dtype and bits."""
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(x.astype(jnp.float32))).to(
            torch.bfloat16)
    return torch.from_numpy(np.array(x))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32), np.float64)


def _ulp(x, bf16: bool):
    """One ulp of |x| in f32 or bf16 (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - (7 if bf16 else 23))


OPTIMIZERS = [("sgd", dict(lr=0.05)), ("momentum", dict(lr=0.05)),
              ("adamw", dict(lr=1e-2)),
              ("adamw", dict(lr=1e-2, weight_decay=0.1))]
IDS = ["sgd", "momentum", "adamw", "adamw_wd"]


def _mismatches(name, kw, update_t=None):
    """Runs ``T`` steps of the reference, each step also through the port
    (``update_t``, the port's ``update`` by default) from the reference's
    params and state; returns ``(step, leaf)`` for every param or state
    leaf outside its bound (module docstring)."""
    rng = np.random.default_rng(7)
    p0 = _params(rng)
    grads = [_tree(rng, 0.1) for _ in range(T)]
    oj = getattr(opt_j, name)(**kw)
    ot = getattr(opt_t, name)(**kw)
    update_t = update_t or ot.update
    pj = _to_j(p0)
    sj = oj.init(pj)
    st = ot.init(_to_t(p0))
    # the state's structure is the reference's (a tensor is a leaf to jax)
    assert jax.tree.structure(st) == jax.tree.structure(sj)
    update_j = jax.jit(oj.update)
    bad = []
    for i in range(T):
        pt = {k: _j_to_t(v) for k, v in pj.items()}
        st = jax.tree.map(_j_to_t, sj)
        pj2, sj2 = update_j(_to_j(grads[i]), sj, pj)
        pt2, st2 = update_t(_to_t(grads[i]), st, pt)
        assert jax.tree.structure(st2) == jax.tree.structure(sj2)
        # the f32 state this step writes (momentum's m; adamw's m, v)
        agree = {k: np.ones(s, bool) for k, s in SHAPES.items()}
        prev = dict(tree_items(st))
        for (path, a), (_, b) in zip(tree_items(st2),
                                     tree_items(jax.tree.map(_j_to_t, sj2))):
            if not a.dim():
                continue                                  # adamw's t
            assert a.dtype == torch.float32
            k, a, b = path[-1], _np(a), _np(b)
            power = 2 if path[0] == "v" else 1            # v sums g * g
            tol = _ulp(b, False) + 4 * U * (np.abs(_np(prev[path]))
                                            + np.abs(grads[i][k]) ** power)
            if not (np.abs(a - b) <= tol).all():
                bad.append((i, path))
            agree[k] &= a == b
        for k in SHAPES:
            assert pt2[k].dtype == (torch.bfloat16 if k in BF16
                                    else torch.float32)
            a, b = _np(pt2[k]), _np(pj2[k])
            if k in BF16:
                ok = (np.array_equal(a[agree[k]], b[agree[k]])
                      and (np.abs(a - b) <= _ulp(b, True))[~agree[k]].all())
            else:
                tol = _ulp(b, False) + 16 * U * np.abs(b - _np(pj[k]))
                ok = (np.abs(a - b) <= tol).all()
            if not ok:
                bad.append((i, k))
        if name == "adamw":
            assert st2["t"].dtype == torch.int32 and st2["t"].dim() == 0
            assert int(st2["t"]) == int(sj2["t"]) == i + 1
        if name == "sgd":
            assert st2 == () and sj2 == ()
        pj, sj = pj2, sj2
    return bad


@pytest.mark.parametrize("name,kw", OPTIMIZERS, ids=IDS)
def test_optimizer_against_the_reference(name, kw):
    assert _mismatches(name, kw) == []


def _sgd_lr_unrounded(lr):
    # lr a Python float: torch multiplies in f32 by the unrounded value
    return lambda grads, state, params: ({
        k: p - lr * grads[k].to(p.dtype) for k, p in params.items()}, state)


def _bf16_untouched(name, kw):
    inner = getattr(opt_t, name)(**kw).update

    def update(grads, state, params):
        new_p, new_s = inner(grads, state, params)
        return {k: params[k] if k in BF16 else v
                for k, v in new_p.items()}, new_s
    return update


def _bf16_sign_flipped(name, kw):
    inner = getattr(opt_t, name)(**kw).update

    def update(grads, state, params):
        new_p, new_s = inner(grads, state, params)
        return {k: 2 * params[k] - v if k in BF16 else v
                for k, v in new_p.items()}, new_s
    return update


WRONG = {"sgd_lr_unrounded": ("sgd", lambda kw: _sgd_lr_unrounded(kw["lr"])),
         "sgd_bf16_untouched": ("sgd", lambda kw: _bf16_untouched("sgd", kw)),
         "momentum_bf16_sign": ("momentum",
                                lambda kw: _bf16_sign_flipped("momentum", kw)),
         "adamw_bf16_untouched": ("adamw",
                                  lambda kw: _bf16_untouched("adamw", kw))}


@pytest.mark.parametrize("wrong", sorted(WRONG))
def test_the_check_rejects_wrong_bf16_arithmetic(wrong):
    name, make = WRONG[wrong]
    kw = dict(OPTIMIZERS)[name]
    bad = _mismatches(name, kw, make(kw))
    # every step of the bf16 leaf is caught, and nothing else is
    assert bad == [(i, "h") for i in range(T)]


def test_updates_leave_their_inputs_untouched():
    rng = np.random.default_rng(1)
    p, g = _to_t(_params(rng)), _to_t(_tree(rng, 0.1))
    before = {k: v.clone() for k, v in p.items()}
    for name, kw in OPTIMIZERS:
        o = getattr(opt_t, name)(**kw)
        s = o.init(p)
        o.update(g, s, p)
    assert all(torch.equal(p[k], before[k]) for k in p)


@pytest.mark.parametrize("max_norm", [0.5, 1e4])
def test_clip_by_global_norm(max_norm):
    rng = np.random.default_rng(3)
    g = _tree(rng, 0.3)
    cj, nj = jax.jit(lambda t: opt_j.clip_by_global_norm(t, max_norm))(
        _to_j(g))
    ct, nt = opt_t.clip_by_global_norm(_to_t(g), max_norm)
    nj, nt = float(nj), float(nt)
    n_max = max(int(np.prod(s)) for s in SHAPES.values())
    norm_tol = (n_max + len(SHAPES)) * U * nj
    assert abs(nt - nj) <= norm_tol
    scale = min(1.0, max_norm / nj)
    scale_tol = scale * (norm_tol / nj + 4 * U)
    for k in SHAPES:
        a, b = _np(ct[k]), _np(cj[k])
        assert ct[k].dtype == (torch.bfloat16 if k in BF16
                               else torch.float32)
        tol = (np.abs(g[k]) * scale_tol
               + 2 * _ulp(np.abs(b), k in BF16))
        assert (np.abs(a - b) <= tol).all(), k
    if max_norm > nj:
        # below the limit the scale is exactly 1
        for k in SHAPES:
            np.testing.assert_array_equal(_np(ct[k]), _np(_to_t(g)[k]))


def test_schedules_equal_at_every_step():
    for step in range(0, 400):
        assert sch_t.constant(0.3)(step) == sch_j.constant(0.3)(step)
        for warmup, total, frac in ((0, 100, 0.1), (10, 300, 0.0),
                                    (50, 50, 0.2)):
            a = sch_t.cosine(1e-2, warmup, total, frac)(step)
            b = sch_j.cosine(1e-2, warmup, total, frac)(step)
            assert a == b and type(a) is type(b)


def test_make_optimizer_names_and_error():
    for name in ("sgd", "momentum", "adamw"):
        assert isinstance(optim_t.make_optimizer(name, 0.1),
                          optim_t.Optimizer)
    with pytest.raises(ValueError) as ej:
        opt_j.make_optimizer("lion", 0.1)
    with pytest.raises(ValueError) as et:
        optim_t.make_optimizer("lion", 0.1)
    assert str(et.value) == str(ej.value)
    assert optim_t.__all__ == __import__("repro.optim",
                                         fromlist=["x"]).__all__
    assert optim_t.Optimizer._fields == opt_j.Optimizer._fields
