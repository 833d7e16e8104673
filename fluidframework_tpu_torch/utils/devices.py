"""Device resolution for the port's entry points.

The port runs on the GPU. An entry point given no device runs on
``cuda`` and raises when there is none: it never falls back to the
CPU on its own. ``device="cpu"`` is an explicit request (the tests
use it) and selects the plain PyTorch versions of the kernels.

`visible_devices` and `parity_skip_reason` are the counterparts of
fluidframework_tpu/utils/devices.py:55 and :65. The reference's
`forced_host_device_env` and `run_forced_host_subprocess` exist to get
virtual devices before the first jax import; a mesh of N entries
(`parallel.mesh.make_docs_mesh`) needs no subprocess, so they have no
counterpart here.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple, Union

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


def visible_devices() -> Tuple[str, int]:
    """``("cuda", number of cards)`` where CUDA is available, else
    ``("cpu", number of cores)``."""
    if torch.cuda.is_available():
        return "cuda", torch.cuda.device_count()
    return "cpu", os.cpu_count() or 1


def parity_skip_reason(n_entries: int) -> Optional[str]:
    """None when aggregate throughput scaling over `n_entries` mesh
    entries can be measured honestly here; else the reason it cannot.

    Honest means each entry has a card of its own, or, where there is
    no CUDA, a core of its own.
    N entries on fewer cards share their SMs, and N CPU entries on
    fewer cores time-slice them: such a run checks correctness, and
    its throughput is not a scaling figure."""
    platform, count = visible_devices()
    if count >= n_entries:
        return None
    unit = "card" if platform == "cuda" else "core"
    return (
        f"{n_entries} mesh entries on {count} {unit}"
        f"{'s' if count != 1 else ''}: the entries share "
        f"{'its SMs' if count == 1 and unit == 'card' else 'them'}, so "
        f"the run checks correctness and its throughput is not a "
        f"multi-device scaling figure"
    )
