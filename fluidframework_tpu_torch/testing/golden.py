"""The headline stream and the digests GOLDEN.json pins for it.

GOLDEN.json, at the repository root, names the seed-7 lagged
SharedString stream by its generator parameters and pins the state
digest of the whole stream and of every 100k-op prefix (the native
engine's stage digests). The stages are prefixes of the full stream:
the generator draws whole arrays, so a shorter generated stream is not
a prefix of a longer one. `headline_stream` generates the full stream
once, `stream_prefix` cuts a stage from it, and `golden_digest` gives
the digest a replay of that prefix must reach.

A replay of many documents (`chip_smoke.py`, `tools/torch_replay_profile.py
--docs`) takes the headline prefix as document 0 and, as the others,
`lagged_stream` of the `DOC_SEEDS`: 32 distinct streams, tiled over
more documents.
"""

from __future__ import annotations

import json
import os
from dataclasses import fields
from typing import Optional

from .synthetic import ColumnarStream, generate_lagged_stream

GOLDEN_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "GOLDEN.json",
)


# The other documents' seeds: 31 streams + the headline, 32 distinct.
DOC_SEEDS = tuple(range(101, 132))


def load_golden() -> dict:
    with open(GOLDEN_PATH) as f:
        return json.load(f)


def golden_digest(golden: dict, n_ops: int) -> Optional[str]:
    """The pinned digest of the first `n_ops` ops: the full digest at
    the stream's length, else the stage digest (None off the stages)."""
    if n_ops == golden["params"]["n_ops"]:
        return golden["digest"]
    return golden["chain"]["native_stage_digests"].get(str(n_ops))


def headline_stream(golden: dict) -> ColumnarStream:
    """The whole stream GOLDEN.json was computed on."""
    p = golden["params"]
    return generate_lagged_stream(
        p["n_ops"], n_clients=p["n_clients"], seed=p["seed"],
        window=p["window"], initial_len=p["initial_len"],
    )


def stream_prefix(stream: ColumnarStream, n_ops: int) -> ColumnarStream:
    """The first `n_ops` ops (views), sharing the whole text buffer."""
    return ColumnarStream(**{
        f.name: getattr(stream, f.name) if f.name == "text"
        else getattr(stream, f.name)[:n_ops]
        for f in fields(stream)
    })


def lagged_stream(seed: int, n_ops: int, params: dict) -> ColumnarStream:
    """A lagged stream of `n_ops` ops with the headline's generator
    `params` (GOLDEN.json's) and another seed. Module-level, so that a
    spawn worker process can run it."""
    return generate_lagged_stream(
        n_ops, n_clients=params["n_clients"], seed=seed,
        window=params["window"], initial_len=params["initial_len"])
