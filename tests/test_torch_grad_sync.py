"""Port parity, ``repro_torch.dist.grad_sync`` against ``repro.dist.grad_sync``
computed live (``tests/test_dist.py``'s ``TestTrainStep`` and
``TestCompressedStep``, held against the reference), on reduced
stablelm-1.6b (2 layers, d_model 64, vocab 256, f32), the reference's
``Model.init`` carried across by ``convert``, a seeded ``[4, 32]`` batch.

What is held, and how closely (U = 2^-24):
  * a pod's or the batch's gradient, per leaf: ``K * U * max|g|`` (``K``
    the sum of the backward's reduction lengths, ``tests/test_torch_mesh.py``);
  * the dense sgd step, full batch and ``n_micro=2``: params within
    ``lr * K * U * max|g| + 2U * max|p|`` of the reference's, the loss
    within ``1e-5`` relative; ``n_micro=2`` against the full batch at the
    reference's own tolerances (``tests/test_dist.py``);
  * ``wire_cr=1``: every pod keeps everything, the EF residuals stay
    exactly 0, and the step equals the dense step over the same slices
    (``n_micro = n_pods``: the pods' gradients are its microbatches') within
    the client-sum bound: params within ``lr * 2*C*U*sum_c|w_c g_c| +
    ulp(p)``, the loss within ``2U`` of itself; and the dense full-batch
    step at the reference's tolerances;
  * one compressed step at cr 0.05 (BCRS pod CRs of two virtual links) for
    bcrs_opwa, bcrs and qtopk: the pod CRs bit for bit (host f64) and every
    leaf's ``ks`` exact; params and EF residuals, away from the elements
    where some pod's gradient lies within twice its bound of the pod's
    k-th magnitude (a near-tie may select another element), within
    ``lr*gamma*(2*C*U*sum_c|w_c g_c| + sum_c w_c*tol) + 2U*max|p|`` and
    ``tol`` (plus one quantization level, ``absmax/127``, under qtopk's int8
    codec); the loss within ``1e-5`` relative;
  * the bare and wrapped state structures, and every error message.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as get_config_j
from repro.core import bcrs as bcrs_j
from repro.core import compression as comp_j
from repro.dist import grad_sync as gs_j
from repro.models import Model as ModelJ
from repro.optim import make_optimizer as make_opt_j
from repro_torch import convert
from repro_torch.configs import get_config as get_config_t
from repro_torch.core import bcrs as bcrs_t
from repro_torch.core import compression as comp_t
from repro_torch.dist import grad_sync as gs_t
from repro_torch.models import Model as ModelT
from repro_torch.optim import make_optimizer as make_opt_t
from repro_torch.tree import tree_items

torch.set_num_threads(1)

ARCH = "stablelm-1.6b"
B, S = 4, 32
U = 2.0 ** -24
GAMMA = 2.0


@pytest.fixture(scope="module")
def setup():
    cfg = get_config_j(ARCH).reduced()
    mj = ModelJ(cfg)
    params_np = jax.tree.map(np.asarray, mj.init(jax.random.PRNGKey(0)))
    mt = ModelT(get_config_t(ARCH).reduced(), device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S + 1))
    batch_np = {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}
    return cfg, mj, mt, params_np, batch_np


def _pj(params_np):
    return jax.tree.map(jnp.asarray, params_np)


def _pt(params_np):
    return convert.model_params_to_torch(params_np, device="cpu")


def _bj(batch_np):
    return {k: jnp.asarray(v) for k, v in batch_np.items()}


def _bt(batch_np):
    return {k: torch.from_numpy(v) for k, v in batch_np.items()}


def _leaves_t(tree):
    return [t.detach().double().numpy() for _, t in tree_items(tree)]


def _leaves_j(tree):
    return [np.asarray(a, np.float64) for a in jax.tree.leaves(tree)]


def _k(cfg, b):
    """Sum of the backward's reduction lengths (the gradient bound's K)."""
    return cfg.n_layers * (b * S + cfg.d_model + cfg.d_ff + S) \
        + cfg.vocab_size


def _grads_j(mj, params_np, batch_np, n):
    """The reference's gradients of ``n`` equal slices, [n, *leaf] each."""
    gf = jax.value_and_grad(mj.loss_fn, has_aux=True)
    pb = {k: jnp.asarray(v.reshape((n, B // n) + v.shape[1:]))
          for k, v in batch_np.items()}
    _, g = jax.vmap(gf, in_axes=(None, 0))(_pj(params_np), pb)
    return _leaves_j(g)


def _ulp32(x):
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 23)


# ------------------------------------------------------------- dense step
class TestTrainStep:
    def test_loss_decreases(self, setup):
        cfg, _, mt, params_np, batch_np = setup
        opt = make_opt_t("sgd", 0.1)
        step = gs_t.make_train_step(mt, opt)
        params, batch = _pt(params_np), _bt(batch_np)
        state, losses = opt.init(params), []
        for _ in range(5):
            params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
        assert losses[-1] < losses[0]
        assert np.isfinite(losses).all()

    @pytest.mark.parametrize("n_micro", [1, 2])
    def test_dense_step_against_the_reference(self, setup, n_micro):
        cfg, mj, mt, params_np, batch_np = setup
        lr = 0.05
        pj, _, mj_out = jax.jit(gs_j.make_train_step(
            mj, make_opt_j("sgd", lr), n_micro=n_micro))(
                _pj(params_np), (), _bj(batch_np))
        pt, st, mt_out = gs_t.make_train_step(
            mt, make_opt_t("sgd", lr), n_micro=n_micro)(
                _pt(params_np), (), _bt(batch_np))
        assert st == ()
        assert set(mt_out) == set(mj_out) == {"ce", "loss"}
        assert abs(float(mt_out["loss"]) - float(mj_out["loss"])) <= \
            1e-5 * float(mj_out["loss"])
        g = _grads_j(mj, params_np, batch_np, 1)
        k = _k(cfg, B // n_micro)
        for a, b, p0, gg in zip(_leaves_t(pt), _leaves_j(pj),
                                _leaves_j(params_np), g):
            bound = lr * k * U * np.abs(gg).max() + 2 * U * np.abs(p0).max()
            assert np.abs(a - b).max() <= bound

    def test_n_micro_matches_full_batch(self, setup):
        """``tests/test_dist.py``'s check, at its tolerances, in the port."""
        _, _, mt, params_np, batch_np = setup
        opt = make_opt_t("sgd", 0.05)
        p1, _, m1 = gs_t.make_train_step(mt, opt)(
            _pt(params_np), (), _bt(batch_np))
        p2, _, m2 = gs_t.make_train_step(mt, opt, n_micro=2)(
            _pt(params_np), (), _bt(batch_np))
        assert float(m2["loss"]) == pytest.approx(float(m1["loss"]),
                                                  rel=1e-5)
        for a, b in zip(_leaves_t(p1), _leaves_t(p2)):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)

    def test_grad_shardings_raise(self, setup):
        _, _, mt, _, _ = setup
        with pytest.raises(NotImplementedError, match="multi-card"):
            gs_t.make_train_step(mt, make_opt_t("sgd", 0.1),
                                 grad_shardings={"embed": None})

    def test_batch_not_divisible_by_n_micro_raises(self, setup):
        _, _, mt, params_np, batch_np = setup
        step = gs_t.make_train_step(mt, make_opt_t("sgd", 0.1), n_micro=3)
        with pytest.raises(ValueError, match="not divisible"):
            step(_pt(params_np), (), _bt(batch_np))


# --------------------------------------------------------- compressed step
def _pod_crs(mod, params_np, cr):
    n_flat = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(params_np))
    return mod.pod_link_schedule([100.0, 50.0], v_bytes=4 * n_flat,
                                 cr_star=cr / 2, cr_max=cr)


class TestCompressedStep:
    def test_wire_cr_one_matches_dense(self, setup):
        """cr=1.0 keeps every coordinate: the compressed step is the dense
        one (strict generalization), EF residuals stay exactly zero."""
        cfg, mj, mt, params_np, batch_np = setup
        n_pods, lr = 2, 0.05
        opt = make_opt_t("sgd", lr)
        comp = gs_t.make_compressed_train_step(
            mt, opt, n_pods=n_pods, wire_cr=1.0, gamma=3.0)
        params = _pt(params_np)
        state = gs_t.init_compressed_state(opt, params, n_pods=n_pods)
        crs = torch.ones((n_pods,))
        coeffs = torch.full((n_pods,), 1.0 / n_pods)
        p2, s2, m2 = comp(params, state, _bt(batch_np), crs, coeffs)
        assert max(float(e.abs().max())
                   for _, e in tree_items(s2["ef"])) == 0.0
        p_micro, _, m_micro = gs_t.make_train_step(mt, opt, n_micro=n_pods)(
            _pt(params_np), (), _bt(batch_np))
        assert abs(float(m2["loss"]) - float(m_micro["loss"])) <= \
            2 * U * abs(float(m_micro["loss"]))
        pods, _, _ = gs_t.pod_gradients(mt.loss_fn, _pt(params_np),
                                        _bt(batch_np), n_pods)
        for a, b, g in zip(_leaves_t(p2), _leaves_t(p_micro), pods):
            wg = (g.double().abs() / n_pods).sum(0).numpy()
            bound = lr * 2 * n_pods * U * wg + _ulp32(np.maximum(
                np.abs(a), np.abs(b)))
            assert (np.abs(a - b) <= bound).all()
        p1, _, m1 = gs_t.make_train_step(mt, opt)(_pt(params_np), (),
                                                  _bt(batch_np))
        assert float(m2["loss"]) == pytest.approx(float(m1["loss"]),
                                                  rel=1e-5)
        for a, b in zip(_leaves_t(p1), _leaves_t(p2)):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)

    def test_wire_cr_one_against_the_reference(self, setup):
        cfg, mj, mt, params_np, batch_np = setup
        n_pods, lr = 2, 0.05
        crs = np.ones((n_pods,), np.float32)
        coeffs = np.full((n_pods,), 1.0 / n_pods, np.float32)
        oj, ot = make_opt_j("sgd", lr), make_opt_t("sgd", lr)
        pj, sj, _ = jax.jit(gs_j.make_compressed_train_step(
            mj, oj, n_pods=n_pods, wire_cr=1.0, gamma=3.0,
            use_kernel=False))(
                _pj(params_np), gs_j.init_compressed_state(
                    oj, _pj(params_np), n_pods=n_pods), _bj(batch_np),
                jnp.asarray(crs), jnp.asarray(coeffs))
        params = _pt(params_np)
        pt, st, _ = gs_t.make_compressed_train_step(
            mt, ot, n_pods=n_pods, wire_cr=1.0, gamma=3.0)(
                params, gs_t.init_compressed_state(ot, params,
                                                   n_pods=n_pods),
                _bt(batch_np), torch.from_numpy(crs),
                torch.from_numpy(coeffs))
        g = _grads_j(mj, params_np, batch_np, n_pods)
        k = _k(cfg, B // n_pods)
        for a, b, p0, gg in zip(_leaves_t(pt), _leaves_j(pj),
                                _leaves_j(params_np), g):
            tol = k * U * np.abs(gg).max()
            wg = (np.abs(gg) / n_pods).sum(0)
            bound = lr * (2 * n_pods * U * wg + tol) + 2 * U * np.abs(p0).max()
            assert (np.abs(a - b) <= bound).all()
        assert all((e == 0).all() for e in _leaves_t(st["ef"]))
        assert all((np.asarray(e) == 0).all() for e in jax.tree.leaves(
            sj["ef"]))

    @pytest.mark.parametrize("strategy", ["bcrs_opwa", "bcrs", "qtopk"])
    def test_one_step_against_the_reference(self, setup, strategy):
        cfg, mj, mt, params_np, batch_np = setup
        n_pods, lr, cr = 2, 0.05, 0.05
        crs_j = _pod_crs(bcrs_j, params_np, cr)
        crs_t = _pod_crs(bcrs_t, params_np, cr)
        assert crs_t.dtype == crs_j.dtype == np.float64
        assert np.array_equal(crs_t, crs_j) and crs_t[0] != crs_t[1]
        crs = np.asarray(crs_j, np.float32)
        coeffs = np.full((n_pods,), 1.0 / n_pods, np.float32)
        oj, ot = make_opt_j("sgd", lr), make_opt_t("sgd", lr)
        pj, sj, mj_out = jax.jit(gs_j.make_compressed_train_step(
            mj, oj, n_pods=n_pods, wire_cr=cr, gamma=GAMMA,
            use_kernel=False, strategy=strategy))(
                _pj(params_np), gs_j.init_compressed_state(
                    oj, _pj(params_np), n_pods=n_pods), _bj(batch_np),
                jnp.asarray(crs), jnp.asarray(coeffs))
        params = _pt(params_np)
        pt, st, mt_out = gs_t.make_compressed_train_step(
            mt, ot, n_pods=n_pods, wire_cr=cr, gamma=GAMMA,
            strategy=strategy)(
                params, gs_t.init_compressed_state(ot, params,
                                                   n_pods=n_pods),
                _bt(batch_np), torch.from_numpy(crs),
                torch.from_numpy(coeffs))
        assert set(mt_out) == set(mj_out) == {"ce", "loss", "wire_cr"}
        assert abs(float(mt_out["loss"]) - float(mj_out["loss"])) <= \
            1e-5 * float(mj_out["loss"])
        assert float(mt_out["wire_cr"]) == float(mj_out["wire_cr"])

        gamma = GAMMA if strategy == "bcrs_opwa" else 1.0
        codec = strategy == "qtopk"
        g = _grads_j(mj, params_np, batch_np, n_pods)
        k = _k(cfg, B // n_pods)
        crs_clip = np.clip(crs, 0.0, np.float32(cr))
        checked = compressed = 0
        for a, b, p0, gg, e_t, e_j in zip(
                _leaves_t(pt), _leaves_j(pj), _leaves_j(params_np), g,
                _leaves_t(st["ef"]), _leaves_j(sj["ef"])):
            n = p0.size
            tol = k * U * np.abs(gg).max()
            wg = (np.abs(gg) * coeffs.reshape((-1,) + (1,) * p0.ndim)
                  ).sum(0)
            if n < 4096:                      # dense exchange, no EF
                assert (e_t == 0).all() and (e_j == 0).all()
                bound = lr * (2 * n_pods * U * wg + tol) \
                    + 2 * U * np.abs(p0).max()
                assert (np.abs(a - b) <= bound).all()
                continue
            compressed += 1
            ks_t = comp_t.k_for_ratio_traced(n, torch.from_numpy(crs_clip))
            ks_j = comp_j.k_for_ratio_traced(n, jnp.asarray(crs_clip))
            assert np.array_equal(ks_t.numpy(), np.asarray(ks_j))
            ks = ks_t.numpy()
            mag = np.abs(gg.reshape(n_pods, -1))
            kth = -np.sort(-mag, axis=1)[np.arange(n_pods), ks - 1]
            keep = ~(np.abs(mag - kth[:, None]) <= 2 * tol).any(0)
            keep = keep.reshape(p0.shape)
            level = (mag.max(1) / 127 * (1 + 1e-6) if codec
                     else np.zeros(n_pods))
            bound = (lr * gamma * (2 * n_pods * U * wg + coeffs.sum() * tol
                                   + (coeffs * level).sum())
                     + 2 * U * np.abs(p0).max())
            assert (np.abs(a - b)[keep] <= bound[keep]).all()
            ef_bound = (tol + level).reshape((-1,) + (1,) * p0.ndim)
            assert (np.abs(e_t - e_j)[:, keep]
                    <= np.broadcast_to(ef_bound, e_t.shape)[:, keep]).all()
            if (kth > 2 * tol).all():
                assert keep.mean() >= 0.9
                checked += 1
        assert compressed >= 8 and checked >= 6
        assert max(float(np.abs(e).max()) for e in _leaves_t(st["ef"])) > 0

    def test_ef_residual_carried_and_loss_finite(self, setup):
        _, _, mt, params_np, batch_np = setup
        n_pods = 2
        opt = make_opt_t("sgd", 0.05)
        step = gs_t.make_compressed_train_step(mt, opt, n_pods=n_pods,
                                               wire_cr=0.05, gamma=2.0)
        params = _pt(params_np)
        state = gs_t.init_compressed_state(opt, params, n_pods=n_pods)
        crs = torch.full((n_pods,), 0.05)
        coeffs = torch.full((n_pods,), 1.0 / n_pods)
        for _ in range(3):
            params, state, m = step(params, state, _bt(batch_np), crs,
                                    coeffs)
            assert np.isfinite(float(m["loss"]))
        assert max(float(e.abs().max())
                   for _, e in tree_items(state["ef"])) > 0.0

    @pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
    def test_state_structures_are_the_reference(self, setup, optimizer):
        """The wrapped state and a bare ``opt.init`` state come back with
        the reference's structure (the bare one without EF)."""
        _, mj, mt, params_np, batch_np = setup
        n_pods = 2
        oj, ot = make_opt_j(optimizer, 0.1), make_opt_t(optimizer, 0.1)
        wrapped_j = gs_j.init_compressed_state(oj, _pj(params_np),
                                               n_pods=n_pods)
        params = _pt(params_np)
        wrapped_t = gs_t.init_compressed_state(ot, params, n_pods=n_pods)
        assert jax.tree.structure(wrapped_t) == jax.tree.structure(wrapped_j)
        assert [tuple(x.shape) for x in jax.tree.leaves(wrapped_t)] == \
            [tuple(x.shape) for x in jax.tree.leaves(wrapped_j)]
        assert gs_t._is_wrapped(wrapped_t) and gs_j._is_wrapped(wrapped_j)
        bare = ot.init(params)
        assert not gs_t._is_wrapped(bare)
        step = gs_t.make_compressed_train_step(mt, ot, n_pods=n_pods,
                                               wire_cr=0.1)
        crs = torch.full((n_pods,), 0.1)
        coeffs = torch.full((n_pods,), 0.5)
        _, new_state, m = step(params, bare, _bt(batch_np), crs, coeffs)
        assert jax.tree.structure(new_state) == jax.tree.structure(
            oj.init(_pj(params_np)))
        assert np.isfinite(float(m["loss"]))
        _, new_wrapped, _ = step(params, wrapped_t, _bt(batch_np), crs,
                                 coeffs)
        assert jax.tree.structure(new_wrapped) == \
            jax.tree.structure(wrapped_j)

    def test_error_messages_are_the_reference(self, setup):
        _, mj, mt, params_np, batch_np = setup
        oj, ot = make_opt_j("sgd", 0.1), make_opt_t("sgd", 0.1)

        def messages(build_j, build_t):
            with pytest.raises(ValueError) as ej:
                build_j()
            with pytest.raises(ValueError) as et:
                build_t()
            return str(et.value), str(ej.value)

        a, b = messages(
            lambda: gs_j.make_compressed_train_step(mj, oj, n_pods=1),
            lambda: gs_t.make_compressed_train_step(mt, ot, n_pods=1))
        assert a == b and "n_pods must be >= 2" in a
        a, b = messages(
            lambda: gs_j.make_compressed_train_step(mj, oj, n_pods=2,
                                                    strategy="fedavg"),
            lambda: gs_t.make_compressed_train_step(mt, ot, n_pods=2,
                                                    strategy="fedavg"))
        assert a == b and "does not compress" in a
        ones3 = np.full((3,), 1 / 3, np.float32)
        a, b = messages(
            lambda: gs_j.make_compressed_train_step(
                mj, oj, n_pods=3, wire_cr=0.1, use_kernel=False)(
                    _pj(params_np), (), _bj(batch_np), jnp.asarray(ones3),
                    jnp.asarray(ones3)),
            lambda: gs_t.make_compressed_train_step(
                mt, ot, n_pods=3, wire_cr=0.1)(
                    _pt(params_np), (), _bt(batch_np),
                    torch.from_numpy(ones3), torch.from_numpy(ones3)))
        assert a == b and "not divisible" in a
        # EF for 4 pods handed to a step built for 2 (the batch of 4
        # divides both)
        halves = np.full((2,), 0.5, np.float32)
        a, b = messages(
            lambda: gs_j.make_compressed_train_step(
                mj, oj, n_pods=2, wire_cr=0.1, use_kernel=False)(
                    _pj(params_np), gs_j.init_compressed_state(
                        oj, _pj(params_np), n_pods=4), _bj(batch_np),
                    jnp.asarray(halves), jnp.asarray(halves)),
            lambda: gs_t.make_compressed_train_step(
                mt, ot, n_pods=2, wire_cr=0.1)(
                    _pt(params_np), gs_t.init_compressed_state(
                        ot, _pt(params_np), n_pods=4), _bt(batch_np),
                    torch.from_numpy(halves), torch.from_numpy(halves)))
        assert a == b and "EF residuals for 4 pods" in a
