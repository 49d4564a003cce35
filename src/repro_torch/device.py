"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``"cuda"`` (the entry points' default) or ``"cpu"`` -> torch.device.

    A CUDA request on a machine without CUDA raises: the port never carries
    on silently on the CPU — the CPU runs only when the caller asks for it.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: device 'cuda' requested but torch.cuda.is_available() "
            "is False — pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu', got {dev}")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for queued device work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
