"""Default-device resolution for the PyTorch/CUDA port.

Every entry point of the port runs on the card unless the caller asks
for the CPU by name. Where there is no card and the caller did not ask
for the CPU, the entry point raises: the port never falls back to the
CPU on its own, so a run that was meant for the card cannot quietly
measure the CPU instead.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None):
    """``device`` (None, a string or a :class:`torch.device`) -> a
    :class:`torch.device`. None means ``cuda``; a CUDA device with no
    card present raises :class:`RuntimeError`."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    return dev
