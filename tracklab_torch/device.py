"""Device resolution for the port's entry points.

Entry points default to ``cuda``. Asking for ``cuda`` on a machine without
a card raises: the port never carries on quietly on the CPU. Tests pass
``device="cpu"`` explicitly.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``. Raises if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tracklab_torch: device 'cuda' requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path")
    return dev
