"""Stable binary partition of table columns (the fold's packing step).

Counterpart of `_pack_partition` in fluidframework_tpu/ops/zamboni.py
(line 129). The JAX version is built from log-shift masked rolls
because a gather is slow on the TPU; here the destination of every row
comes straight from two int32 prefix sums and one scatter moves all
columns. The result is bit-identical: both place kept rows at the
front and dropped rows at the back, each group in its original order.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch


def pack_partition(
    drop: torch.Tensor, cols: Union[torch.Tensor, Sequence[torch.Tensor]]
) -> torch.Tensor:
    """Stable binary partition of ``cols`` (a [C, W] stack, or C
    tensors of [W]) by the bool mask ``drop``: rows with drop False
    pack to the front, dropped rows to the back, both in order.
    Returns the packed [C, W] stack. No host sync."""
    stack = cols if isinstance(cols, torch.Tensor) else torch.stack(
        list(cols), 0
    )
    di = drop.to(torch.int32)
    keep = 1 - di
    keep_rank = torch.cumsum(keep, 0, dtype=torch.int32) - keep
    drop_rank = torch.cumsum(di, 0, dtype=torch.int32) - di
    n_keep = torch.sum(keep, dtype=torch.int32)
    dest = torch.where(drop, n_keep + drop_rank, keep_rank)
    out = torch.empty_like(stack)
    out.index_copy_(1, dest.to(torch.int64), stack)
    return out
