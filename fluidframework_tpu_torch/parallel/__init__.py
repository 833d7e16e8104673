"""The multi-device layer: meshes of torch devices and sharded replays.

Counterpart of fluidframework_tpu/parallel/. The reference scales by
documents (one sequencer pool's slots split over chips, many documents
per chip with a fleet MSN min-reduce) and, for one oversized document,
by sequence range (SURVEY.md §2.6). The JAX package runs these as
``shard_map`` programs over a ``jax.sharding.Mesh``; the port runs them
on a single-controller mesh (`mesh.DocsMesh`): one process drives every
entry's one-card kernels on that entry's stream and reduces across
entries with `collectives`. N entries on one card run the same code as
N cards; only the entries' devices differ. `dryrun.dryrun_multichip`
drives every path of the layer.
"""

from .device_plane import (
    PLANE_ENV,
    DevicePlane,
    parse_plane_spec,
    plane_column_of,
    resolve_plane,
    shared_plane,
)
from .mesh import (
    DocsMesh,
    Sharded,
    make_docs_mesh,
    shard_tables,
    shared_docs_mesh,
    sharded_apply_docs,
    sharded_overlay_replay,
    sharded_overlay_replay_multi,
    sharded_pipeline_step,
)
from .seqshard import run_sequence_sharded, sequence_sharded_replay
from .seqshard_ref import SeqShardedOverlay

__all__ = [
    "PLANE_ENV",
    "DevicePlane",
    "DocsMesh",
    "SeqShardedOverlay",
    "Sharded",
    "make_docs_mesh",
    "parse_plane_spec",
    "plane_column_of",
    "resolve_plane",
    "run_sequence_sharded",
    "sequence_sharded_replay",
    "shard_tables",
    "shared_docs_mesh",
    "shared_plane",
    "sharded_apply_docs",
    "sharded_overlay_replay",
    "sharded_overlay_replay_multi",
    "sharded_pipeline_step",
]
