"""Weights carried across from the JAX package: a params pytree given as a
dict of numpy arrays (``{k: np.asarray(v) for k, v in params.items()}``)
becomes the port's dict of float32 tensors on a device."""
from __future__ import annotations

from typing import Dict, Mapping

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

