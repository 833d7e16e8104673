"""Merge-tree op encoding shared by the port's kernels.

The constants, `raise_kernel_errors` and the op batch layout are
copied from fluidframework_tpu/ops/mergetree_kernel.py (lines 58-72,
89 and 122); `OpBatch` is a dataclass of int32 tensors in place of
the JAX NamedTuple. The row-model scan itself is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import torch

from ..protocol.constants import INT32_MAX

# Sentinels (int32 table encoding).
NOT_REMOVED = INT32_MAX  # rem_seq value for live segments
PROP_ABSENT = -1  # props cell: key not set on this segment
PROP_DELETE = -2  # op value: delete the key (reference: null prop value)
NO_KEY = -1  # op key slot unused

# Op type codes (match protocol.mergetree_ops.MergeTreeDeltaType).
OP_INSERT = 0
OP_REMOVE = 1
OP_ANNOTATE = 2
OP_NOOP = 3

# Error bit flags accumulated in a table's error word.
ERR_CAPACITY = 1  # table overflow
ERR_BAD_POS = 2  # op position beyond visible length
ERR_REMOVERS = 4  # more concurrent removers than KR slots


@dataclass
class OpBatch:
    """A chunk of sequenced ops in ascending sequence-number order."""

    op_type: torch.Tensor  # int32[B]
    pos1: torch.Tensor  # int32[B] insert pos / range start
    pos2: torch.Tensor  # int32[B] range end (exclusive)
    seq: torch.Tensor  # int32[B]
    ref_seq: torch.Tensor  # int32[B]
    client: torch.Tensor  # int32[B]
    buf_start: torch.Tensor  # int32[B] arena offset of inserted text
    ins_len: torch.Tensor  # int32[B]
    prop_keys: torch.Tensor  # int32[B, PK] (NO_KEY padding)
    prop_vals: torch.Tensor  # int32[B, PK]

    def slice(self, lo: int, hi: int) -> "OpBatch":
        """Ops [lo, hi) as views (no copy, no device sync)."""
        return OpBatch(*(getattr(self, f.name)[lo:hi] for f in fields(self)))

    def to(self, device) -> "OpBatch":
        return OpBatch(
            *(getattr(self, f.name).to(device) for f in fields(self))
        )


def raise_kernel_errors(error: int) -> None:
    """Raise if any ERR_* bit is set in an error-flag word."""
    problems = []
    if error & ERR_CAPACITY:
        problems.append("segment table capacity overflow")
    if error & ERR_BAD_POS:
        problems.append("op position beyond visible length")
    if error & ERR_REMOVERS:
        problems.append("removing-client slots exhausted")
    if problems:
        raise RuntimeError("kernel error: " + "; ".join(problems))
