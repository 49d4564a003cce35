"""Port parity, checkpointing: ``repro_torch.checkpoint`` against
``repro.checkpoint`` on the same trees, and its own MessagePack codec
against the ``msgpack`` package the reference writes with.

Everything here is exact: a file the port writes is byte-identical to the
reference's for the same tree (f32, i32, bool and bf16 leaves), each package
restores the other's file bit for bit, and the codec's bytes equal
``msgpack.packb(obj, use_bin_type=True)``.
"""
import os
import warnings

import jax
import jax.numpy as jnp
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as ck_j
from repro_torch.checkpoint import checkpointer as ck_t
from repro_torch.checkpoint import codec

torch.set_num_threads(1)

EXTRA = {"round": 3, "name": "x" * 40, "lr": 0.03, "neg": -100_000,
         "history": [1, 2, None, True], "big": 2 ** 40, "nested": {"a": []}}


def _tree_np(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.normal(size=(3, 4)).astype(np.float32),
                       "b": np.arange(5, dtype=np.int32)},
            "mask": rng.random(7) > 0.5,
            "bf": rng.normal(size=(2, 3)).astype(ml_dtypes.bfloat16),
            "seq": [np.full((2,), 1.5, np.float32),
                    np.zeros((0,), np.float32)]}


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(t):
    """A leaf's raw bytes (tensor or array), for bitwise comparison."""
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.cpu().numpy().tobytes()
    return np.asarray(t).tobytes()


def _pair(seed=0):
    tree = _tree_np(seed)
    return jax.tree.map(jnp.asarray, tree), jax.tree.map(_to_torch, tree)


def _leaves_t(tree):
    return [leaf for _, leaf in ck_t._leaves(tree)]


class TestFormat:
    def test_file_byte_identical(self, tmp_path):
        tree_j, tree_t = _pair()
        p_j = ck_j.save(str(tmp_path / "j"), 7, tree_j, extra=EXTRA)
        p_t = ck_t.save(str(tmp_path / "t"), 7, tree_t, extra=EXTRA)
        assert os.path.basename(p_j) == os.path.basename(p_t)
        with open(p_j, "rb") as f_j, open(p_t, "rb") as f_t:
            assert f_j.read() == f_t.read()

    def test_port_restores_reference_file(self, tmp_path):
        tree_j, tree_t = _pair()
        ck_j.save(str(tmp_path), 4, tree_j, extra=EXTRA)
        like = jax.tree.map(torch.zeros_like, tree_t)
        got, step, extra = ck_t.restore(str(tmp_path), like)
        assert step == 4 and extra == EXTRA
        assert isinstance(got["seq"], list)
        for a, b in zip(_leaves_t(got), _leaves_t(tree_t)):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert _bits(a) == _bits(b)

    def test_reference_restores_port_file(self, tmp_path):
        tree_j, tree_t = _pair()
        ck_t.save(str(tmp_path), 5, tree_t, extra=EXTRA)
        got, step, extra = ck_j.restore(str(tmp_path), tree_j)
        assert step == 5 and extra == EXTRA
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree_j)):
            assert a.dtype == b.dtype and _bits(a) == _bits(b)


class TestRestore:
    def test_retention_and_latest(self, tmp_path):
        _, tree_t = _pair()
        for step in range(5):
            ck_t.save(str(tmp_path), step, tree_t, keep=3)
        assert ck_t.list_steps(str(tmp_path)) == [2, 3, 4]
        assert ck_t.latest_step(str(tmp_path)) == 4
        assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]

    @pytest.mark.parametrize("damage", ["truncate", "garble"])
    def test_restore_latest_valid_skips_corrupt(self, tmp_path, damage):
        _, tree_t = _pair()
        _, newer = _pair(seed=1)
        ck_t.save(str(tmp_path), 1, tree_t)
        path = ck_t.save(str(tmp_path), 2, newer)
        raw = open(path, "rb").read()
        if damage == "truncate":
            raw = raw[: len(raw) // 2]
        else:
            mid = len(raw) // 2
            raw = raw[:mid] + bytes(b ^ 0xFF for b in raw[mid:mid + 16]) \
                + raw[mid + 16:]
        with open(path, "wb") as f:
            f.write(raw)
        with pytest.raises(IOError):
            ck_t._load_validated(path)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got, step, _ = ck_t.restore_latest_valid(str(tmp_path), tree_t)
        assert step == 1
        assert any("corrupt" in str(w.message) for w in caught)
        for a, b in zip(_leaves_t(got), _leaves_t(tree_t)):
            assert _bits(a) == _bits(b)

    def test_layout_mismatch_and_shape_drift(self, tmp_path):
        _, tree_t = _pair()
        ck_t.save(str(tmp_path), 1, tree_t)
        with pytest.raises(ck_t.LayoutMismatch):
            ck_t.restore(str(tmp_path), {"other": torch.zeros(3)},
                         strict=False)
        drift = dict(tree_t, mask=torch.zeros(8, dtype=torch.bool))
        with pytest.raises(ValueError, match="config mismatch"):
            ck_t.restore(str(tmp_path), drift, strict=False)
        # a missing leaf keeps its like value under strict=False
        fresh = torch.full((4,), 2.0)
        got, _, _ = ck_t.restore(str(tmp_path), dict(tree_t, new=fresh),
                                 strict=False)
        assert got["new"] is fresh
        with pytest.raises(KeyError):
            ck_t.restore(str(tmp_path), dict(tree_t, new=fresh))

    def test_no_checkpoint_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            ck_t.restore(str(tmp_path), {"a": torch.zeros(1)})
        with pytest.raises(FileNotFoundError):
            ck_t.restore_latest_valid(str(tmp_path), {"a": torch.zeros(1)})


class TestCodec:
    OBJECTS = [
        None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2 ** 32,
        2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31 - 1,
        -2 ** 63, 0.0, -1.5, 1e300, float("inf"), "", "é" * 31, "x" * 32,
        "y" * 255, "z" * 256, "w" * 70000, b"", b"x" * 255, b"y" * 256,
        b"z" * 70000, [], list(range(15)), list(range(16)),
        list(range(70000)), {}, {str(i): i for i in range(15)},
        {str(i): i for i in range(16)},
        {"a": [1, {"b": b"\x00\x01", "c": [None, 2.5]}]},
    ]

    @pytest.mark.parametrize("obj", OBJECTS,
                             ids=[f"o{i}" for i in range(len(OBJECTS))])
    def test_bytes_equal_msgpack(self, obj):
        packed = msgpack.packb(obj, use_bin_type=True)
        assert codec.packb(obj) == packed
        assert codec.unpackb(packed) == msgpack.unpackb(packed, raw=False)

    def test_rejects_damage(self):
        good = codec.packb({"k": b"abc"})
        for bad in (good[:-1], good + b"\x00", b"\xc1"):
            with pytest.raises(ValueError):
                codec.unpackb(bad)
