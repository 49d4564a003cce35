"""Weights carried across from the JAX package.

``params_to_torch``: a flat params pytree given as a dict of numpy arrays
(``{k: np.asarray(v) for k, v in params.items()}``) becomes the port's dict
of float32 tensors on a device. ``model_params_to_torch``: a model's nested
params tree (or a KV cache) keeps its keys, nesting, stacked ``[L, ...]``
layout and dtypes."""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device


def params_to_torch(params: Mapping, device="cuda") -> Dict[str, torch.Tensor]:
    """dict of arrays (numpy, or anything ``np.asarray`` takes, or tensors)
    -> dict of contiguous f32 tensors on ``device`` (the card unless the
    caller asks for the CPU), same keys and shapes."""
    device = resolve_device(device)
    out = {}
    for key, value in params.items():
        if isinstance(value, torch.Tensor):
            t = value.detach().to(device=device, dtype=torch.float32)
        else:
            t = torch.from_numpy(np.array(value, np.float32)).to(device)
        out[key] = t.contiguous().clone()
    return out


def _leaf_to_torch(value, device: torch.device, dtype) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        t = value.detach().clone()
    else:
        a = np.ascontiguousarray(np.asarray(value))
        if a.dtype.name == "bfloat16":
            # ml_dtypes.bfloat16 (how JAX hands bf16 to numpy) is not a dtype
            # torch.from_numpy takes: carry the 16-bit patterns across
            t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a.copy())
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device).contiguous()


def model_params_to_torch(params_np: Any, dtype=None, device="cuda") -> Any:
    """Nested dict of arrays (a reference model's params or KV cache, as
    numpy or anything ``np.asarray`` takes) -> the same nesting of tensors
    on ``device`` (the card unless the caller asks for the CPU), keys in
    sorted order. Shapes, the stacked ``[L, ...]`` layer layout and dtypes
    are kept, bf16 bit for bit; with ``dtype``, floating leaves are cast to
    it after crossing."""
    device = resolve_device(device)

    def go(node):
        if isinstance(node, Mapping):
            return {k: go(node[k]) for k in sorted(node)}
        return _leaf_to_torch(node, device, dtype)

    return go(params_np)
