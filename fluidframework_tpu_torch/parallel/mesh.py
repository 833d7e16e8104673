"""Document-sharded execution over a single-controller mesh of torch
devices.

Counterpart of fluidframework_tpu/parallel/mesh.py. Documents are
embarrassingly parallel (the reference partitions its topics by
document id and runs one deli sequencer per partition), so every
per-document array gets a leading docs axis laid out over the mesh,
each entry runs the one-card kernels on its documents, and the only
traffic between entries is small reductions (the fleet MSN as a min,
error words as a per-bit OR: `parallel.collectives`).

The JAX package compiles this with ``shard_map`` over a
``jax.sharding.Mesh``; here one process holds the mesh and drives every
entry itself:

- a `DocsMesh` is an ordered tuple of ``torch.device`` entries and an
  axis name. ``make_docs_mesh(n)`` lays n entries round-robin over the
  visible cards, so one H100 holds n entries of ``cuda:0`` (the
  counterpart of JAX's forced virtual host devices); ``device="cpu"``
  gives n CPU entries (the tests). With no CUDA and no explicit
  ``"cpu"`` it raises: there is no silent fall-back to the CPU.
- placement is a list of per-entry slabs (`Sharded`): the leading docs
  axis split into ``size`` equal slabs, each copied to its entry
  (`DocsMesh.shard`); `DocsMesh.gather` concatenates them back on the
  first entry. A docs axis that is not a multiple of the size raises,
  as ``shard_map`` does.
- each CUDA entry works on a CUDA stream of its own, so that N
  entries on one card overlap as N cards do (on an H100 nearly all the
  kernel time of 4 entries runs beside another entry's, now that a
  replay chunk is two launches an entry: PERF.md section 5). `DocsMesh.parallel` makes every
  entry's stream wait for the caller's stream on entry and the
  caller's streams wait for every entry's on exit, and entry work runs
  only inside it (`DocsMesh.on`): a tensor made on one stream is read
  on another only across one of those waits, which is also what keeps
  the caching allocator from handing a block to one stream while
  another still reads it.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import fields, is_dataclass
from typing import Any, List, Optional, Sequence

import torch

from ..ops.mergetree_kernel import apply_op_batch_docs
from ..ops.overlay import replay_chunk_step
from ..utils.devices import DeviceLike, resolve_device
from . import collectives

__all__ = [
    "DocsMesh",
    "Sharded",
    "make_docs_mesh",
    "shared_docs_mesh",
    "shard_tables",
    "sharded_overlay_replay",
    "sharded_overlay_replay_multi",
    "sharded_pipeline_step",
]


class Sharded(tuple):
    """One value placed on a mesh: its per-entry slabs, in entry order."""


def _parts(x):
    """(field values, rebuild) for a dataclass or NamedTuple of
    tensors; None for a tensor."""
    if is_dataclass(x):
        names = [f.name for f in fields(x)]
        return [getattr(x, n) for n in names], lambda vals: type(x)(*vals)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return list(x), lambda vals: type(x)(*vals)
    return None


class DocsMesh:
    """An ordered tuple of torch devices (the entries) and an axis name.

    Two meshes with the same entries and axis are equal and hash alike,
    so caches keyed on a mesh (`ops.sequencer_kernel
    .sharded_sequence_fn`) hit across pools; `shared_docs_mesh` hands
    out one object per key, which also shares the entries' streams."""

    def __init__(self, entries: Sequence[DeviceLike], axis: str = "docs"):
        self.entries = tuple(torch.device(e) for e in entries)
        if not self.entries:
            raise ValueError("a mesh needs at least one entry")
        kinds = {e.type for e in self.entries}
        if len(kinds) != 1 or not kinds <= {"cuda", "cpu"}:
            raise ValueError(f"mesh entries must be all CUDA or all CPU "
                             f"devices: {self.entries}")
        self.axis = axis
        self._streams: Optional[List[torch.cuda.Stream]] = None

    # ------------------------------------------------------------ surface

    @property
    def size(self) -> int:
        return len(self.entries)

    @property
    def platform(self) -> str:
        return self.entries[0].type

    @property
    def cards(self) -> tuple:
        """The distinct devices under the entries, in entry order."""
        return tuple(dict.fromkeys(self.entries))

    def describe(self) -> dict:
        return {
            "axis": self.axis,
            "size": self.size,
            "platform": self.platform,
            "entries": [str(e) for e in self.entries],
            "cards": [str(c) for c in self.cards],
        }

    def __eq__(self, other) -> bool:
        return (isinstance(other, DocsMesh) and self.entries == other.entries
                and self.axis == other.axis)

    def __hash__(self) -> int:
        return hash((self.entries, self.axis))

    def __repr__(self) -> str:
        return (f"DocsMesh({self.size} x {self.axis!r} over "
                f"{[str(c) for c in self.cards]})")

    # ------------------------------------------------------------ streams

    def _entry_streams(self) -> List[torch.cuda.Stream]:
        if self._streams is None:
            self._streams = [torch.cuda.Stream(device=e)
                             for e in self.entries]
        return self._streams

    @contextlib.contextmanager
    def parallel(self):
        """Fork the entries' streams from the callers' streams and join
        them back at exit. Entry work goes inside, under `on`. A no-op
        on CPU entries."""
        if self.platform != "cuda":
            yield
            return
        callers = {c: torch.cuda.current_stream(c) for c in self.cards}
        streams = self._entry_streams()
        for e, s in zip(self.entries, streams):
            s.wait_stream(callers[e])
        try:
            yield
        finally:
            for caller in callers.values():
                for s in streams:
                    caller.wait_stream(s)

    def on(self, i: int):
        """Entry i's stream as the current one (inside `parallel`)."""
        if self.platform != "cuda":
            return contextlib.nullcontext()
        return torch.cuda.stream(self._entry_streams()[i])

    # ---------------------------------------------------------- placement

    def _split(self, t: torch.Tensor, dim: int, i: int) -> torch.Tensor:
        n = t.shape[dim]
        if n % self.size:
            raise ValueError(
                f"the {self.axis} axis has {n} entries, not a multiple of "
                f"the mesh's {self.size}")
        k = n // self.size
        return t.narrow(dim, i * k, k).to(self.entries[i], copy=True)

    def shard(self, x: Any, dim: int = 0) -> Sharded:
        """Place `x` (a tensor, or a dataclass / NamedTuple of tensors
        sharing the docs axis `dim`) on the mesh: one slab of each
        field per entry, copied on the entry's stream. A `Sharded`
        value passes through."""
        if isinstance(x, Sharded):
            if len(x) != self.size:
                raise ValueError(f"{len(x)} slabs for a mesh of "
                                 f"{self.size} entries")
            return x
        parts = _parts(x)
        slabs = []
        with self.parallel():
            for i in range(self.size):
                with self.on(i):
                    if parts is None:
                        slabs.append(self._split(torch.as_tensor(x), dim, i))
                    else:
                        vals, rebuild = parts
                        slabs.append(rebuild(
                            [self._split(v, dim, i) for v in vals]))
        return Sharded(slabs)

    def gather(self, slabs: Sequence[Any], dim: int = 0) -> Any:
        """The slabs concatenated along `dim` on the first entry (call
        after the entries' work is joined)."""
        dst = self.entries[0]
        parts = _parts(slabs[0])
        if parts is None:
            return torch.cat([s.to(dst, non_blocking=True) for s in slabs],
                             dim)
        _, rebuild = parts
        cols = zip(*(_parts(s)[0] for s in slabs))
        return rebuild([torch.cat([c.to(dst, non_blocking=True)
                                   for c in col], dim) for col in cols])


def make_docs_mesh(n: Optional[int] = None, device: DeviceLike = None,
                   axis: str = "docs") -> DocsMesh:
    """A mesh of `n` entries. `device` None means CUDA (raising where
    there is none): the entries go round-robin over the visible cards
    (n defaults to their count); a CUDA device with an index puts every
    entry on that card. ``device="cpu"`` gives n CPU entries (n defaults
    to the core count)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        n = count if n is None else int(n)
        entries = ([torch.device("cuda", i % count) for i in range(n)]
                   if dev.index is None else [dev] * n)
    else:
        n = (os.cpu_count() or 1) if n is None else int(n)
        entries = [dev] * n
    if n < 1:
        raise ValueError(f"a mesh needs at least one entry, got {n}")
    return DocsMesh(entries, axis)


_MESH_CACHE: dict = {}


def shared_docs_mesh(n: Optional[int] = None, device: DeviceLike = None,
                     axis: str = "docs") -> DocsMesh:
    """The process-wide cached form of `make_docs_mesh`: every caller
    asking for the same (n, device, axis) shares one mesh object (and
    its streams)."""
    key = (n, str(resolve_device(device)) if device is not None else None,
           axis)
    mesh = _MESH_CACHE.get(key)
    if mesh is None:
        mesh = _MESH_CACHE[key] = make_docs_mesh(n, device, axis)
    return mesh


def shard_tables(tables: Any, mesh: DocsMesh) -> Sharded:
    """Place a stacked table (leading docs axis) on the mesh."""
    return mesh.shard(tables)


def sharded_overlay_replay(mesh: DocsMesh, chunk: int):
    """The one-document-per-entry form of `sharded_overlay_replay_multi`
    (pass a docs axis equal to ``mesh.size``)."""
    return sharded_overlay_replay_multi(mesh, chunk)


def sharded_overlay_replay_multi(mesh: DocsMesh, chunk: int):
    """The overlay replay of many documents per entry.

    Returns ``step(tables, ops, logs, counts, msns) -> (tables, logs,
    counts, cursors, gmsn, gerr)`` over the docs form of
    `core.overlay_replay.stack_replicas` (tables and logs ``[D, ...]``,
    counts ``[D, n_chunks]``, ops ``[n_chunks, D, B]``, msns
    ``[n_chunks, D]``); D may be any multiple of ``mesh.size``. Each
    entry runs its D / N documents through the docs form of
    `ops.overlay.replay_fused`: per chunk, one launch of kernel A with
    D / N blocks and one fold, the entries interleaved chunk by chunk
    on their own streams. The JAX package runs each device's documents
    one after another (``lax.map``); the per-document results are the
    same. Then the fleet reduces: ``gmsn`` is the min of the final
    applied MSNs, ``gerr`` the per-bit OR of the error words. The
    outputs are concatenated on the first entry, as `replay_docs`
    returns them, so `restore_shard` reads any document out."""

    def step(tables, ops, logs, counts, msns):
        t_s = mesh.shard(tables)
        o_s = mesh.shard(ops, dim=1)
        l_s = mesh.shard(logs)
        c_s = mesh.shard(counts)
        m_s = mesh.shard(msns, dim=1)
        n_chunks = m_s[0].shape[0]
        with mesh.parallel():
            state = []
            for i in range(mesh.size):
                with mesh.on(i):
                    cursor = torch.zeros(c_s[i].shape[0], dtype=torch.int32,
                                         device=mesh.entries[i])
                    state.append((t_s[i], l_s[i], c_s[i], cursor))
            for ci in range(n_chunks):
                for i in range(mesh.size):
                    with mesh.on(i):
                        t, lg, cnt, cur = state[i]
                        state[i] = replay_chunk_step(
                            t, o_s[i], ci * chunk, chunk, m_s[i][ci], lg,
                            cnt, cur, ci)
            local_msn = []
            for i in range(mesh.size):
                with mesh.on(i):
                    local_msn.append(torch.min(m_s[i][-1]))
        gmsn = collectives.pmin(local_msn)
        gerr = collectives.por([s[0].error for s in state])
        return (mesh.gather([s[0] for s in state]),
                mesh.gather([s[1] for s in state]),
                mesh.gather([s[2] for s in state]),
                mesh.gather([s[3] for s in state]), gmsn, gerr)

    return step


def sharded_apply_docs(mesh: DocsMesh):
    """`apply_op_batch_docs` over the mesh.

    Returns ``step(tables, ops) -> tables``: each entry applies its
    slab of documents' chunks on its own stream (one launch of the scan
    kernel, ``csrc/mergetree_scan.cu``, per entry on the card; the plain
    version on the CPU); the outputs are gathered on the first entry.
    Tables and ops carry a leading docs axis, a multiple of
    ``mesh.size``."""

    def step(tables, ops):
        t_s = mesh.shard(tables)
        o_s = mesh.shard(ops)
        outs = []
        with mesh.parallel():
            for i in range(mesh.size):
                with mesh.on(i):
                    outs.append(apply_op_batch_docs(t_s[i], o_s[i]))
        return mesh.gather(outs)

    return step


def sharded_pipeline_step(mesh: DocsMesh):
    """One multi-document tick of the row model over the mesh.

    Returns ``step(tables, ops, doc_min_seqs) -> (tables, global_min_seq,
    error)``: `sharded_apply_docs`, then the fleet reduces the min of
    `doc_min_seqs` and the per-bit OR of the error words."""
    apply = sharded_apply_docs(mesh)

    def step(tables, ops, doc_min_seqs):
        out = apply(tables, ops)
        mins = [torch.min(m) for m in mesh.shard(doc_min_seqs)]
        return out, collectives.pmin(mins), collectives.por([out.error])

    return step
