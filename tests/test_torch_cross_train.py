"""Port parity, training the cross-attention families: ``Model.loss_fn``
for whisper-medium (encdec: the encoder over ``batch["frames"]``, decoder
blocks with cross-attention) and llama-3.2-vision-11b (vlm: gated cross
blocks over the projected ``batch["patches"]``), every block under
``cfg.remat``, then ``launch.train`` on both and ``launch.fl_train``'s
refusal of them — ``repro_torch`` on the CPU against ``repro`` on the same
inputs.

Params are the reference's ``Model.init`` carried across by ``convert``,
with vlm's cross gates set non-zero on both sides (``VLM_GATES``): at the
reference's zeros every cross block is the identity and its ``xattn`` and
MLP get zero gradients, which any port would match. Sizes are
``reduced()`` (2 layers, d_model 64; whisper 2 encoder layers over 20
frames; vlm one group of 2 self blocks and a cross block over 8 patches),
B = 2 x S = 32 tokens, f32 unless stated.

Tolerances and why (the forms of ``tests/test_torch_recurrent_train.py``):
  * a loss: ``1e-4`` relative;
  * gradients, per leaf: ``K * 2^-24 * max|g|``, K the sum of the
    reduction lengths on the backward path (``_k_grad``, each term beside
    what it counts);
  * bf16 gradients, per leaf: ``6 * 2^-8 * sqrt(K16) * max|g|``, K16 the
    bf16 roundings on the backward path (``_k16``: R a block in the
    forward, ``tests/test_torch_cross.py``'s counts, and two in the
    backward for each); a leaf's gradient halved or zeroed fails it
    (``test_bf16_grad_bound_rejects_a_planted_fault``). The loss within
    twice the logits' bound ``6 * 2^-8 * sqrt(L * R) * rms(logits)``;
  * within the port, bit for bit: the three ``remat`` modes;
  * whole ``launch.train`` runs: per-step losses within ``1e-4`` relative
    of the reference's loop; a resumed run bit for bit the uninterrupted
    one.
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
from repro.models import layers as layers_j
from repro.models.transformer import Model as ModelJ
from repro.optim import make_optimizer as make_opt_j
from repro_torch import checkpoint as ckpt_t
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.dist.grad_sync import loss_and_grads
from repro_torch.launch import fl_train as fl_t
from repro_torch.launch import train as train_t
from repro_torch.models import Model
from repro_torch.tree import tree_items, tree_leaves

torch.set_num_threads(1)

ARCHS = ("whisper-medium", "llama-3.2-vision-11b")
VLM_GATES = {"gate_attn": 0.7, "gate_mlp": -0.4}
B, S, FRAMES = 2, 32, 20
U = 2.0 ** -24
U16 = 2.0 ** -8
#: bf16 roundings a block in the forward (``tests/test_torch_cross.py``):
#: encdec's decoder block, vlm's self and cross blocks, and the encoder's
#: block
FWD_ROUNDINGS = {"encdec": 21, "vlm": 17}
ENCODER_ROUNDINGS = 13


def _rand(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)
            ).astype(np.float32)


def _init_np(cfg_j, seed=3):
    """The reference's init as numpy, vlm's gates set to ``VLM_GATES``."""
    params = jax.tree.map(np.asarray, ModelJ(cfg_j).init(
        jax.random.PRNGKey(seed)))
    if cfg_j.family == "vlm":
        cross = params["groups"]["cross"]
        for name, value in VLM_GATES.items():
            cross[name] = np.full(cross[name].shape, value, np.float32)
    return params


def _pair(arch, dtype="float32", remat="none", seed=3):
    """(reference model, port model, reference params, port params) from
    the same numpy tree."""
    cj = dataclasses.replace(get_config_j(arch).reduced(), dtype=dtype,
                             remat=remat)
    ct = dataclasses.replace(get_config(arch).reduced(), dtype=dtype,
                             remat=remat)
    params = _init_np(cj, seed)
    return (ModelJ(cj), Model(ct, device="cpu"),
            jax.tree.map(jnp.asarray, params),
            convert.model_params_to_torch(params, device="cpu"))


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "encdec":
        out["frames"] = rng.normal(size=(B, FRAMES, cfg.d_model)).astype(
            np.float32)
    else:
        v = cfg.vision
        out["patches"] = rng.normal(size=(B, v.n_patches, v.d_vision)
                                    ).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in out.items()})


def _grads_j(model, params, batch):
    (loss, _), g = jax.value_and_grad(lambda p: model.loss_fn(p, batch),
                                      has_aux=True)(params)
    return float(loss), [np.asarray(jnp.asarray(a, jnp.float32), np.float64)
                         for a in jax.tree.leaves(g)]


def _k_grad(cfg, b, s):
    """The gradient bound's K: the reduction lengths on the backward path
    of a reduced cross-attention model."""
    d, f = cfg.d_model, cfg.d_ff
    if cfg.family == "encdec":
        enc = cfg.encdec.n_enc_layers * (
            b * FRAMES                 # weight grads over the frames
            + d + f                    # activation grads: d_model, d_ff
            + FRAMES)                  # bidirectional attention
        dec = cfg.n_layers * (
            b * s + b * FRAMES         # weights over tokens; xattn k / v
            + 2 * d + f                # self and cross d_model, d_ff
            + s + FRAMES)              # causal keys; the memory's keys
        memory = cfg.n_layers * 2 * d  # the memory's grad from each wk, wv
        return enc + dec + memory + cfg.vocab_size
    v = cfg.vision
    g, n = v.n_cross_layers, v.n_patches
    selfs = cfg.n_layers * (b * s + d + f + s)
    cross = g * (b * s + b * n         # weights over tokens; k / v
                 + 2 * d + f + n)      # d_model, d_ff; the patches' keys
    vis = b * n + g * 2 * d            # vis_proj; vis's grad from k, v
    gates = b * s * d                  # a gate's grad sums every element
    return selfs + cross + vis + gates + cfg.vocab_size


def _k16(cfg):
    """bf16 roundings on the backward path: R a block in the forward and
    two in the backward for each, the head (1 + 2), the embedding (1) and
    the frames' cast with the positions' add, or the patches' projection
    (3)."""
    r = FWD_ROUNDINGS[cfg.family]
    if cfg.family == "encdec":
        fwd = cfg.n_layers * r + cfg.encdec.n_enc_layers * ENCODER_ROUNDINGS
    else:
        fwd = (cfg.n_layers + cfg.vision.n_cross_layers) * r
    return 3 * fwd + 4 + 3


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
    return loss, [(p, g) for (p, _), g in zip(tree_items(params), grads)]


# -------------------------------------------------------- loss and grads
@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_against_the_reference(arch, remat):
    """``Model.loss_fn`` and every leaf's gradient against
    ``jax.value_and_grad`` of the reference's, the reference at the same
    ``remat``; every leaf's gradient is nonzero (vlm's cross blocks and
    gates included)."""
    mj, mt, pj, pt = _pair(arch, remat=remat)
    bj, bt = _batch(mt.cfg)
    lj, gj = _grads_j(mj, pj, bj)
    lt, gt = _items_grads(mt, pt, bt)
    assert abs(float(lt) - lj) <= 1e-4 * abs(lj)
    k = _k_grad(mt.cfg, B, S)
    _assert_grads(gt, gj, lambda m: k * U * m)
    assert all(bool(g.any()) for _, g in gt), [p for p, g in gt
                                               if not g.any()]


@functools.lru_cache(maxsize=None)
def _bf16_run(arch):
    """One bf16 loss and gradient on each side (reduced, remat "none")
    and the bounds of the module docstring."""
    mj, mt, pj, pt = _pair(arch, dtype="bfloat16")
    cfg = mt.cfg
    bj, bt = _batch(cfg)
    lj, gj = _grads_j(mj, pj, bj)
    lt, gt = _items_grads(mt, pt, bt)
    emb = layers_j.embed_lookup(pj["embed"]["w"], bj["tokens"])
    if cfg.family == "encdec":
        from repro.models.transformer import sinusoidal_pos
        memory = mj._encode(pj, bj["frames"])
        x = emb + sinusoidal_pos(S, cfg.d_model).astype(emb.dtype)
        for i in range(cfg.n_layers):
            x = mj._encdec_block_fwd(jax.tree.map(lambda a: a[i],
                                                  pj["layers"]),
                                     x, memory, jnp.arange(S))
        blocks = cfg.n_layers
    else:
        vis = bj["patches"].astype(jnp.bfloat16) @ pj["vis_proj"]
        x, _ = mj._backbone_vlm(pj, emb, vis, jnp.arange(S))
        blocks = cfg.n_layers + cfg.vision.n_cross_layers
    logits = np.asarray(jnp.asarray(layers_j.rms_norm(
        x, pj["final_norm"], cfg.norm_eps) @ pj["lm_head"]["w"],
        jnp.float32), np.float64)[..., :cfg.vocab_size]
    rms = np.sqrt((logits * logits).mean())
    k16 = _k16(cfg)
    return dict(
        lt=float(lt), lj=lj, gt=gt, gj=gj,
        dtypes=[(path, g.dtype, p.dtype) for (path, g), (_, p) in zip(
            gt, tree_items(pt))],
        loss_tol=2 * 6.0 * U16 * math.sqrt(
            blocks * FWD_ROUNDINGS[cfg.family]) * rms,
        tol_of=lambda m: 6.0 * U16 * math.sqrt(k16) * m)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_loss_and_grads_against_the_reference(arch):
    """bf16 loss and every leaf's gradient against the reference's within
    the module docstring's bounds, gradients in the params' dtype."""
    run = _bf16_run(arch)
    assert abs(run["lt"] - run["lj"]) <= run["loss_tol"], (
        run["lt"], run["lj"], run["loss_tol"])
    for path, g_dtype, p_dtype in run["dtypes"]:
        assert g_dtype == p_dtype, path
    _assert_grads(run["gt"], run["gj"], run["tol_of"])


@pytest.mark.parametrize("fault", ["halved", "zeroed"])
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_grad_bound_rejects_a_planted_fault(arch, fault):
    """The bf16 gradient bound can fail: one leaf's port gradient halved
    (or zeroed), the others as computed, fails the comparison at that
    leaf and nowhere else, for every leaf."""
    run = _bf16_run(arch)
    gt, gj, tol_of = run["gt"], run["gj"], run["tol_of"]
    for i, ((path, g), a) in enumerate(zip(gt, gj)):
        assert np.abs(a).max() > 0, path
        bad = list(gt)
        bad[i] = (path, g * 0.5 if fault == "halved" else torch.zeros_like(g))
        assert [p for p, _, _ in _over_bound(bad, gj, tol_of)] == [path]


# ---------------------------------------------------- remat within the port
BLOCKS = {"whisper-medium": ("_enc_block_fwd", "_encdec_block_fwd"),
          "llama-3.2-vision-11b": ("_block_fwd", "_cross_block_fwd")}


def _count_calls(monkeypatch, obj, name, counts):
    fn = getattr(obj, name)

    def counted(*a, **kw):
        counts[name] = counts.get(name, 0) + 1
        return fn(*a, **kw)
    monkeypatch.setattr(obj, name, counted)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_modes_bit_for_bit(monkeypatch, arch, dtype):
    """"none", "full" and "dots": the same loss and every gradient bit for
    bit, and every block of each kind (encoder and decoder, self and
    cross) runs once a pass with "none" and twice with the others (the
    recompute in the backward)."""
    _, mt, _, params = _pair(arch, dtype=dtype)
    base = mt.cfg
    _, bt = _batch(base)
    n = {"_enc_block_fwd": getattr(base.encdec, "n_enc_layers", 0),
         "_encdec_block_fwd": base.n_layers, "_block_fwd": base.n_layers,
         "_cross_block_fwd": getattr(base.vision, "n_cross_layers", 0)}
    outs = {}
    for mode in ("none", "full", "dots"):
        counts = {}
        for name in BLOCKS[arch]:
            _count_calls(monkeypatch, Model, name, counts)
        model = Model(dataclasses.replace(base, remat=mode), device="cpu")
        outs[mode] = _items_grads(model, params, bt)
        monkeypatch.undo()
        for name in BLOCKS[arch]:
            assert counts[name] == n[name] * (1 if mode == "none" else 2), (
                mode, name, counts)
    lo, go = outs["none"]
    for mode in ("full", "dots"):
        loss, grads = outs[mode]
        assert torch.equal(loss, lo), mode
        for (path, a), (_, b) in zip(grads, go):
            assert a.dtype == b.dtype and torch.equal(a, b), (mode, path)


# --------------------------------------------------------- launch.train
BASE = dict(reduced=True, batch=4, seq=32, seed=0)


def _reference_losses(arch, init, steps, pods=0, wire_cr=0.05):
    """The reference's ``launch.train`` loop (``src/repro/launch/
    train.py``: sgd, lr 1e-2, the frames or patches drawn from the same
    rng after each step's tokens) from ``init``."""
    cfg = get_config_j(arch).reduced()
    model = ModelJ(cfg)
    rng = np.random.default_rng(BASE["seed"])
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
    b, s = BASE["batch"], BASE["seq"]
    losses = []
    for _ in range(steps):
        toks = tokens_j(b, s + 1, cfg.vocab_size, rng)
        batch = {"tokens": jnp.asarray(toks[:, :-1]),
                 "labels": jnp.asarray(toks[:, 1:])}
        if cfg.family == "encdec":
            batch["frames"] = jnp.asarray(
                rng.normal(0, 1, (b, s, cfg.d_model)), jnp.float32)
        if cfg.family == "vlm":
            v = cfg.vision
            batch["patches"] = jnp.asarray(
                rng.normal(0, 1, (b, v.n_patches, v.d_vision)), jnp.float32)
        params, state, m = step_fn(params, state, batch, *args)
        losses.append(float(m["loss"]))
    return losses


def _run_t(arch, init=None, **kw):
    return train_t.run(train_t.TrainConfig(
        **{**BASE, "arch": arch, "device": "cpu", **kw}), init_params=init)


@pytest.mark.parametrize("pods", [0, 2], ids=["dense", "2 pods"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_losses_against_the_reference_loop(arch, pods):
    init = _init_np(get_config_j(arch).reduced(), seed=0)
    want = _reference_losses(arch, init, 3, pods=pods, wire_cr=0.1)
    kw = dict(compressed_pods=pods, wire_cr=0.1) if pods else {}
    res = _run_t(arch, init, steps=3, **kw)
    assert res["steps_run"] == [0, 1, 2]
    np.testing.assert_allclose(res["losses"], want, rtol=1e-4)
    if pods:
        assert max(float(e.abs().max()) for e in
                   tree_leaves(res["opt_state"]["ef"])) > 0


def _same_tree(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    bits = lambda t: t.view(torch.int16 if t.dtype == torch.bfloat16
                            else torch.int32) if t.is_floating_point() else t
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(bits(x), bits(y))
        for x, y in zip(la, lb))


@pytest.mark.parametrize("arch", ARCHS)
def test_restart_bit_for_bit(tmp_path, arch):
    """6 steps at once against 4 with a checkpoint at 3, resumed to 6: the
    resumed run draws (and drops) the tokens and the frames or patches of
    the steps already done, so it trains on the same data, bit for bit."""
    kw = dict(compressed_pods=2, wire_cr=0.1) \
        if arch == "llama-3.2-vision-11b" else {}
    full = _run_t(arch, steps=6, **kw)
    d = str(tmp_path)
    part = _run_t(arch, steps=4, checkpoint_dir=d, checkpoint_every=3, **kw)
    assert ckpt_t.latest_step(d) == 3
    resumed = _run_t(arch, steps=6, checkpoint_dir=d, checkpoint_every=3,
                     **kw)
    assert resumed["resumed_from"] == 3 and resumed["steps_run"] == [3, 4, 5]
    assert part["losses"][:3] + resumed["losses"] == full["losses"]
    assert _same_tree(full["params"], resumed["params"])
    assert _same_tree(full["opt_state"], resumed["opt_state"])


def test_batches_draw_in_the_reference_order():
    """``train._batch`` consumes the rng as the reference's loop does: the
    tokens, then the frames (f64 normals rounded to f32)."""
    cfg = get_config("whisper-medium").reduced()
    tc = train_t.TrainConfig(arch=cfg.name, batch=3, seq=8, device="cpu")
    got = train_t._batch(tc, cfg, np.random.default_rng(5), "cpu")
    rng = np.random.default_rng(5)
    toks = tokens_j(3, 9, cfg.vocab_size, rng)
    frames = np.asarray(jnp.asarray(rng.normal(0, 1, (3, 8, cfg.d_model)),
                                    jnp.float32))
    np.testing.assert_array_equal(got["tokens"].numpy(), toks[:, :-1])
    np.testing.assert_array_equal(got["labels"].numpy(), toks[:, 1:])
    assert got["frames"].dtype == torch.float32
    np.testing.assert_array_equal(got["frames"].numpy(), frames)


# ------------------------------------------------------------- fl_train
@pytest.mark.parametrize("arch,missing", [("whisper-medium", "frames"),
                                          ("llama-3.2-vision-11b",
                                           "patches")])
def test_fl_train_refuses_the_cross_families(arch, missing):
    """The reference's ``fl_train`` builds no frames or patches and stops
    with ``KeyError``; the port refuses the arch at its start, naming what
    is missing, from ``run`` and from the CLI."""
    with pytest.raises(KeyError, match=missing):
        fl_j.run(fl_j.FLTrainConfig(arch=arch, reduced=True, rounds=1,
                                    clients=2, batch=2, seq=16,
                                    engine="round"))
    with pytest.raises(ValueError, match=f"no '{missing}'"):
        fl_t.run(fl_t.FLTrainConfig(arch=arch, reduced=True, rounds=1,
                                    device="cpu"))
    with pytest.raises(SystemExit):
        fl_t.main(["--arch", arch, "--reduced", "--device", "cpu"])
