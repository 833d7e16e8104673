"""Device resolution for the port's entry points.

The port runs on the GPU. An entry point given no device runs on
``cuda`` and raises when there is none: it never falls back to the
CPU on its own. ``device="cpu"`` is an explicit request (the tests
use it) and selects the plain PyTorch versions of the kernels.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The torch device an entry point runs on.

    None means ``cuda``; a CUDA device that is not available raises
    RuntimeError; ``"cpu"`` is honoured as given. Other device types
    are refused, since the port has kernels only for CUDA and plain
    versions only for the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on the GPU "
                "by default -- pass device='cpu' to run the plain "
                "PyTorch versions on the CPU"
            )
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")


def cuda_skip_reason() -> Optional[str]:
    """None when a CUDA device is usable, else the reason to skip a
    test that needs the card. Call it inside a test or fixture, never
    while a module is imported."""
    if not torch.cuda.is_available():
        return "needs a CUDA device (torch.cuda.is_available() is False)"
    return None
