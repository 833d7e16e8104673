#!/usr/bin/env python3
"""Torch ops a sequence-sharded replay dispatches per op, by op kind.

    python3 tools/seqshard_ops.py [--ops 256] [--shards 1 8]

Counts the ATen ops that `parallel.seqshard.sequence_sharded_replay`
dispatches (a `TorchDispatchMode` around the replay) on CPU entries,
which run the masked form the card runs (every shard does the masked
work of every op), over the dry run's sequence-sharded
stream (seed 991, 8 clients, window 64, initial length 16). Each op
the count includes is one kernel launch on the card, so this is the
replay's launches per op; it is a count, not a time. Prints one JSON
line per shard count.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ops", type=int, default=256)
    ap.add_argument("--shards", type=int, nargs="+", default=[1, 8])
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    from torch.utils._python_dispatch import TorchDispatchMode

    from fluidframework_tpu_torch.ops.mergetree_kernel import (
        OP_ANNOTATE, OP_INSERT, OP_REMOVE,
    )
    from fluidframework_tpu_torch.parallel import seqshard as tss
    from fluidframework_tpu_torch.parallel.dryrun import KK, KR, _lagged_stream
    from fluidframework_tpu_torch.parallel.mesh import make_docs_mesh

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    stream = _lagged_stream(args.ops, seed=991)
    kinds = np.asarray(stream.op_type)
    for n in args.shards:
        mesh = make_docs_mesh(n, "cpu", axis="seq")
        replay = tss.sequence_sharded_replay(mesh, 2048, KR, KK)
        per_kind = {}
        for name, code in (("insert", OP_INSERT), ("remove", OP_REMOVE),
                           ("annotate", OP_ANNOTATE)):
            sel = kinds == code
            if not sel.any():
                continue
            ops = {k: np.asarray(getattr(stream, k), np.int32)
                   for k in tss.OP_FIELDS}
            # The other kinds become no-ops: only this kind dispatches.
            ops["op_type"] = np.where(sel, code, 3).astype(np.int32)
            bounds = np.linspace(0, 16, n + 1).astype(int)
            states = [tss.make_shard_state(int(bounds[d + 1] - bounds[d]),
                                           2048, KR, KK, "cpu")
                      for d in range(n)]
            c = Count()
            with c:
                replay(states, ops)
            per_kind[name] = round(c.n / int(sel.sum()), 1)
        print(json.dumps({"shards": n, "ops": args.ops,
                          "torch_ops_per_op": per_kind,
                          "mix": {k: int(v) for k, v in zip(
                              ("insert", "remove", "annotate"),
                              np.bincount(kinds, minlength=3)[:3])}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
