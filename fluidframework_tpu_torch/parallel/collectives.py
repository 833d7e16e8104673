"""Collectives over the entries of a single-controller mesh.

The counterparts of ``jax.lax.all_gather``, ``pmin``, ``pmax`` and the
per-bit OR of error words that the JAX package runs inside
``shard_map`` (fluidframework_tpu/parallel/mesh.py:116-121,
seqshard.py:189-261 and :435). Each takes one tensor per mesh entry
and returns the result on the first entry's device.
They use device-to-device copies and torch ops only: no host sync, so
a replay that calls them per op never waits for the card.

An error word is reduced bit by bit over bits 0..30, as the reference
does (some collective backends lack an integer OR-reduce); bit 31
never carries an ``ERR_*`` flag.
"""

from __future__ import annotations

from typing import Sequence

import torch

ERROR_BITS = 31  # the reference's `jnp.arange(31)`


def all_gather(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The entries' tensors stacked along a new leading axis (entry
    order), on the first entry's device."""
    if not parts:
        raise ValueError("a collective needs one tensor per mesh entry")
    dst = parts[0].device
    return torch.stack([p.to(dst, non_blocking=True) for p in parts])


def pmin(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The elementwise minimum over the entries."""
    return torch.amin(all_gather(parts), 0)


def pmax(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The elementwise maximum over the entries."""
    return torch.amax(all_gather(parts), 0)


def error_bits(words: torch.Tensor) -> torch.Tensor:
    """int32[31]: bit b is 1 where any of `words` has bit b set (one
    entry's local reduction)."""
    bits = torch.arange(ERROR_BITS, dtype=torch.int32, device=words.device)
    flat = words.reshape(-1, 1).to(torch.int32)
    return torch.amax((flat >> bits) & 1, 0)


def por(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The OR of every error word of every entry, as an int32 scalar:
    each entry's `error_bits`, their `pmax`, and the bits summed back
    into one word."""
    bits = pmax([error_bits(p) for p in parts])
    shift = torch.arange(ERROR_BITS, dtype=torch.int32, device=bits.device)
    return torch.sum(bits << shift, dtype=torch.int32)
