"""Port parity, centralised training through ``repro_torch.launch.train``
on the CPU against ``repro.launch.train`` at reduced stablelm-1.6b (2
layers, d_model 64, vocab 256, f32), batch 4 x 32 tokens.

What is held, and how closely:
  * per-step losses against the reference's loop (its ``main``'s: the same
    ``np.random.default_rng(seed)`` batch stream, the pod CRs of
    ``pod_link_schedule``, jitted steps) from the reference's ``Model.init``
    carried across by ``convert``: dense sgd and adamw over 4 steps, and
    the compressed bcrs_opwa pod sync (2 pods, wire cr 0.1) over 3, each
    within ``1e-4`` relative (the reduced model's loss tolerance,
    ``tests/test_torch_fl_train.py``: the gradients agree within their
    summation-order bound, and a Top-K near-tie could part two runs'
    selections, so params are not compared across steps);
  * within the port: a run stopped after its step-3 checkpoint and resumed
    to 6 steps equals 6 uninterrupted steps bit for bit (params, optimizer
    state, EF residuals, losses), for dense adamw and the compressed step;
  * a checkpoint the reference wrote (adamw, compressed, 2 pods) restores
    in the port and resumes with the reference's losses (same bound); a
    checkpoint of another optimizer state ends in the reference's
    ``SystemExit`` message;
  * both CLIs print ``[train] done``; the port's, rerun with more steps on
    its checkpoint directory, prints ``[train] resumed from step 6``.
"""
import io
import os
import subprocess
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as get_config_j
from repro.core.bcrs import pod_link_schedule as pod_link_schedule_j
from repro.data import synthetic_lm_tokens as tokens_j
from repro.dist import grad_sync as gs_j
from repro.launch import train as train_j
from repro.models import Model as ModelJ
from repro.optim import make_optimizer as make_opt_j
from repro_torch import checkpoint as ckpt_t
from repro_torch.launch import train as train_t
from repro_torch.tree import tree_items, tree_leaves

torch.set_num_threads(1)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
BASE = dict(arch="stablelm-1.6b", reduced=True, batch=4, seq=32, seed=0,
            device="cpu")
CLI = ["--reduced", "--batch", "4", "--seq", "32"]


def _init():
    cfg = get_config_j(BASE["arch"]).reduced()
    return jax.tree.map(np.asarray, ModelJ(cfg).init(
        jax.random.PRNGKey(BASE["seed"])))


def _reference_losses(steps, optimizer="sgd", lr=1e-2, pods=0,
                      wire_cr=0.05):
    """The reference's loop (``repro.launch.train.main``) from its
    own ``Model.init``, returning each step's loss."""
    cfg = get_config_j(BASE["arch"]).reduced()
    model = ModelJ(cfg)
    rng = np.random.default_rng(BASE["seed"])
    opt = make_opt_j(optimizer, lr)
    params = jax.tree.map(jnp.asarray, _init())
    opt_state = (gs_j.init_compressed_state(opt, params, n_pods=pods)
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
    losses = []
    for _ in range(steps):
        toks = tokens_j(BASE["batch"], BASE["seq"] + 1, cfg.vocab_size, rng)
        batch = {"tokens": jnp.asarray(toks[:, :-1]),
                 "labels": jnp.asarray(toks[:, 1:])}
        params, opt_state, m = step_fn(params, opt_state, batch, *args)
        losses.append(float(m["loss"]))
    return losses


def _run_t(init=None, **kw):
    return train_t.run(train_t.TrainConfig(**{**BASE, **kw}),
                       init_params=init)


def _bits(t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu()
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return (a.view(view[a.dtype]) if a.dtype in view else a).numpy()


def _same_tree(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and np.array_equal(_bits(x), _bits(y))
        for x, y in zip(la, lb))


CASES = {"dense sgd": (dict(steps=4), dict()),
         "dense adamw": (dict(steps=4, optimizer="adamw"),
                         dict(optimizer="adamw")),
         "compressed bcrs_opwa": (
             dict(steps=3, compressed_pods=2, wire_cr=0.1),
             dict(pods=2, wire_cr=0.1))}


@pytest.mark.parametrize("case", list(CASES))
def test_losses_against_the_reference_loop(case):
    kw_t, kw_j = CASES[case]
    res = _run_t(_init(), **kw_t)
    want = _reference_losses(kw_t["steps"], **kw_j)
    assert res["steps_run"] == list(range(kw_t["steps"]))
    assert res["resumed_from"] is None
    np.testing.assert_allclose(res["losses"], want, rtol=1e-4)
    assert all(np.isfinite(res["losses"]))
    if "compressed_pods" in kw_t:
        crs = pod_link_schedule_j([100.0, 50.0], v_bytes=4 * sum(
            a.size for a in jax.tree.leaves(_init())), cr_star=0.05,
            cr_max=0.1)
        assert np.array_equal(res["pod_crs"], crs)
        assert max(float(e.abs().max()) for _, e in
                   tree_items(res["opt_state"]["ef"])) > 0


@pytest.mark.parametrize("kw", [dict(optimizer="adamw"),
                                dict(compressed_pods=2, wire_cr=0.1)],
                         ids=["dense_adamw", "compressed"])
def test_restart_bit_for_bit(tmp_path, kw):
    full = _run_t(steps=6, **kw)
    d = str(tmp_path)
    part = _run_t(steps=4, checkpoint_dir=d, checkpoint_every=3, **kw)
    assert ckpt_t.latest_step(d) == 3      # step 4's state was lost
    resumed = _run_t(steps=6, checkpoint_dir=d, checkpoint_every=3, **kw)
    assert part["resumed_from"] is None and resumed["resumed_from"] == 3
    assert resumed["steps_run"] == [3, 4, 5]
    assert part["losses"][:3] + resumed["losses"] == full["losses"]
    assert _same_tree(full["params"], resumed["params"])
    assert _same_tree(full["opt_state"], resumed["opt_state"])
    if "compressed_pods" in kw:
        assert max(float(e.abs().max()) for _, e in
                   tree_items(full["opt_state"]["ef"])) > 0
    else:
        assert int(resumed["opt_state"]["t"]) == 6


def test_reference_checkpoint_resumes_in_the_port(tmp_path, monkeypatch):
    d = str(tmp_path / "ref")
    argv = ["train"] + CLI + ["--steps", "3", "--optimizer", "adamw",
                              "--compressed-pods", "2", "--wire-cr", "0.1",
                              "--checkpoint-dir", d, "--checkpoint-every",
                              "3"]
    monkeypatch.setattr(sys, "argv", argv)
    out = io.StringIO()
    with redirect_stdout(out):
        train_j.main()
    assert "[train] done" in out.getvalue()
    assert ckpt_t.latest_step(d) == 3
    res = _run_t(steps=5, optimizer="adamw", compressed_pods=2, wire_cr=0.1,
                 checkpoint_dir=d, checkpoint_every=3)
    assert res["resumed_from"] == 3 and res["steps_run"] == [3, 4]
    assert int(res["opt_state"]["opt"]["t"]) == 5
    want = _reference_losses(5, optimizer="adamw", pods=2, wire_cr=0.1)
    np.testing.assert_allclose(res["losses"], want[3:], rtol=1e-4)
    # a dense adamw run cannot take this compressed state: the
    # reference's message, word for word
    monkeypatch.setattr(sys, "argv", argv[:argv.index("--compressed-pods")]
                        + ["--checkpoint-dir", d])
    with pytest.raises(SystemExit) as ej:
        train_j.main()
    with pytest.raises(SystemExit) as et:
        _run_t(steps=5, optimizer="adamw", checkpoint_dir=d)
    assert str(et.value) == str(ej.value)
    assert "does not match the current optimizer-state structure" in \
        str(et.value)


def test_cli_prints_done_and_resumes(tmp_path, capsys):
    d = str(tmp_path / "ck")
    args = CLI + ["--device", "cpu", "--steps", "6", "--compressed-pods",
                  "2", "--wire-cr", "0.1", "--checkpoint-dir", d,
                  "--checkpoint-every", "3"]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train"] + args,
        capture_output=True, text=True, env=env, timeout=600, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "[train] done" in proc.stdout
    assert "[train] compressed pod sync: CRs=[0.1  0.05]" in proc.stdout
    assert ckpt_t.latest_step(d) == 6
    args[args.index("6")] = "9"
    train_t.main(args)
    out = capsys.readouterr().out
    assert "[train] resumed from step 6" in out and "[train] done" in out
    assert "[train] step 8 loss" in out
    with pytest.raises(SystemExit):
        train_t.main(CLI + ["--device", "cpu", "--compressed-pods", "1"])


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        train_t.run(train_t.TrainConfig(reduced=True, steps=1, batch=2,
                                        seq=8))
    with pytest.raises(RuntimeError, match="cuda"):
        train_t.main(CLI + ["--steps", "1"])


def test_one_pod_is_refused():
    with pytest.raises(ValueError, match="n_pods must be >= 2"):
        _run_t(steps=1, compressed_pods=1)
