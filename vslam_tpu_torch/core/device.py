"""The device an entry point runs on."""

from __future__ import annotations

import torch

__all__ = ["resolve"]


def resolve(device=None) -> torch.device:
    """``device`` as named, else CUDA: the port's entry points run on the
    card unless the caller asks for another device. There is no CPU
    fallback; without CUDA, a tensor made on the result raises."""
    return torch.device("cuda" if device is None else device)
