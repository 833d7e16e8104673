"""Device-placement plane: one ``docs x model`` grid of mesh entries
serving the sequencer and the summarizer's folds.

Counterpart of fluidframework_tpu/parallel/device_plane.py. A
`DevicePlane` owns one process-wide grid of entries over the axes
``('docs', 'model')`` and hands each tenant a typed slice of it:

- **sequencer**: `seq_mesh(column)` is a 1-D ``docs`` `DocsMesh` over
  one model column of the grid (`server.deli_kernel.SeqPool` takes it
  as it takes any docs mesh). One partition is one worker is one mesh
  slice: worker k orders its documents on column ``k % model``.
- **summarizer folds**: `fold_sharding` lays a stacked fold's leading
  doc axis over the whole plane, docs-major (`fold_spec` names the
  axes it tiles).

The entries go round-robin over the visible cards, as
`parallel.mesh.make_docs_mesh` lays them, so a 2x2 plane on one H100 is
four entries of ``cuda:0``; ``device="cpu"`` gives CPU entries (the
tests); with no CUDA and no explicit ``"cpu"`` a plane raises. Specs
are strings (``"2x2"`` = 2 docs x 2 model), so they ride argv and the
environment (`PLANE_ENV`) into farm children.

The reference's `table_sharding` (:146) shards a stacked table's rows
over ``model``. The port's hand kernels take whole tables, so it has no
counterpart yet: it waits for a row-split scan, a scan kernel that works
on a share of a table's rows (ROADMAP.md Queue 1 item 3, Queue 2 item 1).
"""

from __future__ import annotations

import os
import zlib
from typing import Optional, Sequence, Tuple, Union

import torch

from ..utils.devices import DeviceLike
from .mesh import DocsMesh, make_docs_mesh

__all__ = [
    "PLANE_ENV",
    "DevicePlane",
    "parse_plane_spec",
    "plane_column_of",
    "resolve_plane",
    "shared_plane",
]

# Process-wide plane spec (the supervisor child_env seam): "DxM".
PLANE_ENV = "FLUID_DEVICE_PLANE"


def parse_plane_spec(spec: Union[str, Tuple[int, int]]) -> Tuple[int, int]:
    """``"2x2"`` / ``(2, 2)`` -> (docs, model). Loud on nonsense: a
    mis-parsed plane must not silently fall back to one device."""
    if isinstance(spec, tuple):
        d, m = spec
    else:
        parts = str(spec).lower().replace("*", "x").split("x")
        if len(parts) != 2:
            raise ValueError(
                f"device-plane spec {spec!r} is not 'DOCSxMODEL' "
                f"(e.g. '2x2', '4x2')"
            )
        d, m = parts
    d, m = int(d), int(m)
    if d < 1 or m < 1:
        raise ValueError(f"device-plane axes must be >= 1: {spec!r}")
    return d, m


class DevicePlane:
    """One ``('docs', 'model')`` grid of entries and its typed slices.

    Build planes through `shared_plane` / `resolve_plane`, so every
    pool, role and bench in a process shares one plane object (and the
    `sharded_sequence_fn` cache keyed on its column meshes)."""

    def __init__(self, docs: int, model: int,
                 devices: Optional[Sequence[DeviceLike]] = None,
                 device: DeviceLike = None):
        self.docs = int(docs)
        self.model = int(model)
        n = self.docs * self.model
        if devices is None:
            entries = make_docs_mesh(n, device).entries
        else:
            entries = tuple(torch.device(d) for d in devices)
            if len(entries) < n:
                raise ValueError(
                    f"device plane {self.docs}x{self.model} needs {n} "
                    f"entries; {len(entries)} given")
        # Docs-major: entry (d, m) is entries[d * model + m].
        self.entries = tuple(entries[:n])
        self._seq_meshes: dict = {}
        self._fold_mesh: Optional[DocsMesh] = None

    # ------------------------------------------------------------- slices

    @property
    def size(self) -> int:
        return self.docs * self.model

    def grid(self, d: int, m: int) -> torch.device:
        """The entry at docs row d, model column m."""
        return self.entries[d * self.model + m]

    def seq_mesh(self, column: int = 0) -> DocsMesh:
        """The sequencer's slice: a 1-D ``docs`` mesh over model column
        ``column % model``, cached per column (one mesh object, one set
        of streams)."""
        col = int(column) % self.model
        mesh = self._seq_meshes.get(col)
        if mesh is None:
            mesh = self._seq_meshes[col] = DocsMesh(
                [self.grid(d, col) for d in range(self.docs)], "docs")
        return mesh

    def fold_spec(self) -> Tuple[str, str]:
        """The axes a stacked fold's leading doc axis tiles: the whole
        plane, docs-major."""
        return ("docs", "model")

    def fold_sharding(self) -> DocsMesh:
        """The placement of a stacked fold's doc axis: a mesh over every
        entry of the plane in docs-major order, so K stacked documents
        spread over the whole pool."""
        if self._fold_mesh is None:
            self._fold_mesh = DocsMesh(self.entries, "docs,model")
        return self._fold_mesh

    def doc_sharding(self) -> DocsMesh:
        """The placement of stacked per-document 1-D values ([K])."""
        return self.fold_sharding()

    # ------------------------------------------------------------ surface

    def spec(self) -> str:
        return f"{self.docs}x{self.model}"

    def describe(self) -> dict:
        return {
            "docs": self.docs,
            "model": self.model,
            "devices": int(self.size),
            "platform": self.entries[0].type,
            "cards": [str(c) for c in dict.fromkeys(self.entries)],
        }

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"DevicePlane({self.spec()!r})"


_PLANE_CACHE: dict = {}


def shared_plane(docs: int, model: int,
                 device: DeviceLike = None) -> DevicePlane:
    """The process-wide cached plane for (docs, model, device): every
    caller shares one plane object."""
    key = (int(docs), int(model),
           None if device is None else str(torch.device(device)))
    plane = _PLANE_CACHE.get(key)
    if plane is None:
        plane = _PLANE_CACHE[key] = DevicePlane(key[0], key[1],
                                                device=device)
    return plane


def resolve_plane(
    plane: Union[None, str, Tuple[int, int], DevicePlane],
    env: bool = False, device: DeviceLike = None,
) -> Optional[DevicePlane]:
    """The resolver every ``device_plane=`` parameter funnels through:
    a DevicePlane passes through, specs resolve through the shared
    cache (on `device`), None consults `PLANE_ENV` when ``env=True``
    (farm children inherit the supervisor's plane)."""
    if plane is None and env:
        plane = os.environ.get(PLANE_ENV) or None
    if plane is None:
        return None
    if isinstance(plane, DevicePlane):
        return plane
    return shared_plane(*parse_plane_spec(plane), device=device)


def plane_column_of(key, model: int) -> int:
    """The model column of a partition or worker key: ints go
    round-robin, strings by crc32 (the fabric's stable doc hash), so one
    partition keeps one mesh slice across restarts."""
    if isinstance(key, int):
        return key % max(1, model)
    return zlib.crc32(str(key).encode()) % max(1, model)
