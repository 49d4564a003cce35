"""Atomic, restartable checkpointing for trees of tensors (torch port of
``repro.checkpoint.checkpointer``, same on-disk format).

Format: one MessagePack file per step holding {path -> (dtype, shape, raw
bytes)} plus metadata and a CRC32 integrity digest, byte for byte what the
reference writes for the same tree, so each package restores the other's
files. MessagePack comes from the port's own codec (``checkpoint.codec``),
not the ``msgpack`` package. Writes go to a temp file and are
``os.replace``d into place (atomic on POSIX), so a crash mid-write never
corrupts the latest checkpoint. Retention keeps the newest K steps.

A tree is a tensor, a numpy array or a Python scalar (a leaf), or a dict,
list or tuple of trees; leaf paths join dict keys (sorted, as
``jax.tree_util`` orders them) and sequence indices with "/". bfloat16
leaves are written as the reference writes them: dtype "bfloat16", raw
little-endian bytes.
"""
from __future__ import annotations

import os
import re
import warnings
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import codec

_CKPT_RE = re.compile(r"^step_(\d+)\.msgpack$")


class LayoutMismatch(ValueError):
    """A ``strict=False`` restore found NO leaf of the requested structure
    in the checkpoint — the tree layouts are unrelated. Distinct from the
    plain ``ValueError`` a shape-drifted leaf raises, so callers can fall
    back on layout changes without masking genuine config mismatches."""


def _leaves(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """[(path, leaf)] in the reference's order: dict keys sorted, sequence
    items in order, nested paths joined by "/"; None holds no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += _leaves(tree[key], prefix + (str(key),))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, item in enumerate(tree):
            out += _leaves(item, prefix + (str(i),))
        return out
    return [("/".join(prefix), tree)]


def _rebuild(tree, values):
    """``tree``'s structure with its leaves taken in order from the
    iterator ``values``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {key: _rebuild(tree[key], values) for key in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(item, values) for item in tree)
    return next(values)


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(contiguous array, the reference's dtype string); bfloat16 as its
    16-bit patterns."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        a = t.numpy()
    else:
        a = np.ascontiguousarray(np.asarray(leaf))
    return a, a.dtype.str


def _from_record(rec: dict, device) -> torch.Tensor:
    if rec["dtype"] == "bfloat16":
        a = np.frombuffer(rec["data"], dtype="<i2").reshape(rec["shape"])
        t = torch.from_numpy(a.copy()).view(torch.bfloat16)
    else:
        a = np.frombuffer(rec["data"], dtype=np.dtype(rec["dtype"]))
        t = torch.from_numpy(a.reshape(rec["shape"]).copy())
    return t.to(device)


def _device(leaf) -> torch.device:
    return (leaf.device if isinstance(leaf, torch.Tensor)
            else torch.device("cpu"))


def save(ckpt_dir: str, step: int, tree, extra: Optional[dict] = None,
         keep: Optional[int] = 3) -> str:
    """Write ``step_<step>.msgpack`` atomically. ``keep`` retains the newest
    K steps; ``keep=None`` keeps every file."""
    os.makedirs(ckpt_dir, exist_ok=True)
    leaves = dict(_leaves(tree))
    payload: Dict[str, Any] = {"step": step, "extra": extra or {},
                               "leaves": {}}
    crc = 0
    for key in sorted(leaves):
        a, dtype = _to_numpy(leaves[key])
        raw = a.tobytes()
        crc = zlib.crc32(raw, crc)
        payload["leaves"][key] = {"dtype": dtype, "shape": list(a.shape),
                                  "data": raw}
    payload["crc32"] = crc
    final = os.path.join(ckpt_dir, f"step_{step}.msgpack")
    tmp = final + ".tmp"
    with open(tmp, "wb") as f:
        f.write(codec.packb(payload))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)
    _apply_retention(ckpt_dir, keep)
    return final


def _apply_retention(ckpt_dir: str, keep: Optional[int]) -> None:
    if keep is None:
        return
    for s in list_steps(ckpt_dir)[:-keep]:
        try:
            os.remove(os.path.join(ckpt_dir, f"step_{s}.msgpack"))
        except OSError:
            pass


def list_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        m = _CKPT_RE.match(name)
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def _load_validated(path: str) -> Dict[str, Any]:
    """Read and integrity-check one checkpoint file. Every way a file can
    be broken on disk — truncated, garbled, wrong structure, failing the
    CRC32 digest — surfaces as one ``IOError``, so ``restore_latest_valid``
    tells "this file is corrupt" from "this file disagrees with your
    config" (``ValueError`` / ``LayoutMismatch``, never masked)."""
    try:
        with open(path, "rb") as f:
            payload = codec.unpackb(f.read())
        if (not isinstance(payload, dict) or "crc32" not in payload
                or "leaves" not in payload or "step" not in payload):
            raise IOError(f"checkpoint {path} has a malformed payload")
        crc = 0
        for key in sorted(payload["leaves"]):
            crc = zlib.crc32(payload["leaves"][key]["data"], crc)
        if crc != payload["crc32"]:
            raise IOError(f"checkpoint {path} failed CRC32 integrity check")
    except IOError:
        raise
    except Exception as e:   # codec errors on truncated/garbled data
        raise IOError(f"checkpoint {path} is unreadable: {e}") from e
    return payload


def restore_latest_valid(ckpt_dir: str, like, strict: bool = True
                         ) -> Tuple[Any, int, dict]:
    """``restore`` that skips corrupt files: walk the steps newest-first
    and restore the newest that passes validation, warning about each one
    skipped. Raises ``FileNotFoundError`` only when no intact checkpoint
    exists; config mismatches (``ValueError`` / ``LayoutMismatch``) still
    propagate."""
    steps = list_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    for step in reversed(steps):
        path = os.path.join(ckpt_dir, f"step_{step}.msgpack")
        try:
            _load_validated(path)
        except IOError as e:
            warnings.warn(f"skipping corrupt checkpoint {path}: {e}",
                          RuntimeWarning, stacklevel=2)
            continue
        return restore(ckpt_dir, like, step=step, strict=strict)
    raise FileNotFoundError(
        f"all {len(steps)} checkpoints in {ckpt_dir} failed integrity "
        f"validation")


def restore(ckpt_dir: str, like, step: Optional[int] = None,
            strict: bool = True) -> Tuple[Any, int, dict]:
    """Restore into the structure of ``like``: returns (tree, step, extra),
    each leaf a tensor on the device of ``like``'s leaf (the CPU for a
    numpy or scalar leaf). Verifies the CRC32 digest; raises on corruption.

    ``strict=False`` keeps a leaf's ``like`` value when the checkpoint has
    no entry for it. A checkpoint that shares NO leaf with ``like`` still
    raises (:class:`LayoutMismatch`), and a leaf that matches by key but
    not by shape raises a plain ``ValueError`` (config drift, never a
    fallback case)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step}.msgpack")
    payload = _load_validated(path)
    leaves = _leaves(like)
    out = []
    matched = 0
    for key, leaf in leaves:
        if not strict and key not in payload["leaves"]:
            out.append(leaf if isinstance(leaf, torch.Tensor)
                       else torch.as_tensor(np.asarray(leaf)))
            continue
        matched += 1
        rec = payload["leaves"][key]
        if not strict and tuple(rec["shape"]) != tuple(np.shape(leaf)):
            raise ValueError(
                f"checkpoint leaf {key!r} has shape {tuple(rec['shape'])} "
                f"but the requested structure expects "
                f"{tuple(np.shape(leaf))} — config mismatch "
                f"(e.g. cohort/pod count changed between save and resume)")
        out.append(_from_record(rec, _device(leaf)))
    if leaves and matched == 0:
        raise LayoutMismatch(
            f"checkpoint {path} shares no leaves with the requested "
            f"structure (checkpoint keys like "
            f"{sorted(payload['leaves'])[:3]}…) — tree layout mismatch, "
            f"not a partial restore")
    return _rebuild(like, iter(out)), payload["step"], payload["extra"]
