"""Content-addressed summary/blob store.

Copied from fluidframework_tpu/server/castore.py: `_PyStore` (:27) and
`ContentAddressedStore` (:104) with the Python backend only. The
summary service opens its store with ``prefer_native=False``
(`summarizer.open_summary_store`), so the reference's C++ store is not
ported: ``prefer_native=True`` raises instead of falling back. The
GC surface (`list_blobs`, `sweep_tmp`, `delete_blob`) comes with the
retention role (ROADMAP.md Queue 1 item 4).

Summaries and attachment blobs are immutable blobs addressed by the
SHA-256 of their bytes, with named refs pointing at each document's
latest summary. The durable layout is the reference's, so a store
directory written by either package is read by the other:
``objects/<key[:2]>/<key>`` blob files and an fsynced ``refs.log``
journal.
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, List, Optional

__all__ = ["ContentAddressedStore"]


class _PyStore:
    """In-memory or disk-backed store (objects/<h[0:2]>/<hash> blob
    files + fsynced refs.log journal)."""

    def __init__(self, directory: Optional[str] = None):
        self._blobs: Dict[str, bytes] = {}
        self._refs: Dict[str, str] = {}
        self._dir = directory
        self._refs_f = None
        if directory:
            os.makedirs(os.path.join(directory, "objects"), exist_ok=True)
            refs_path = os.path.join(directory, "refs.log")
            if os.path.exists(refs_path):
                with open(refs_path) as f:
                    for line in f:
                        parts = line.split()
                        if len(parts) == 2:
                            self._refs[parts[0]] = parts[1]

    def _blob_path(self, key: str) -> str:
        return os.path.join(self._dir, "objects", key[:2], key)

    def put(self, content) -> str:
        if isinstance(content, str):
            content = content.encode()
        key = hashlib.sha256(content).hexdigest()
        self._blobs[key] = content
        if self._dir:
            path = self._blob_path(key)
            if not os.path.exists(path):
                os.makedirs(os.path.dirname(path), exist_ok=True)
                tmp = f"{path}.tmp.{os.getpid()}"
                with open(tmp, "wb") as f:
                    f.write(content)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)
        return key

    def get(self, key: str) -> bytes:
        if key in self._blobs:
            return self._blobs[key]
        if self._dir:
            path = self._blob_path(key)
            if os.path.exists(path):
                with open(path, "rb") as f:
                    data = f.read()
                self._blobs[key] = data
                return data
        raise KeyError(key)

    def contains(self, key: str) -> bool:
        if key in self._blobs:
            return True
        return bool(self._dir) and os.path.exists(self._blob_path(key))

    def set_ref(self, name: str, key: str) -> None:
        if not self.contains(key):
            raise KeyError(f"unknown blob {key}")
        self._refs[name] = key
        if self._dir:
            if self._refs_f is None:
                self._refs_f = open(
                    os.path.join(self._dir, "refs.log"), "a"
                )
            self._refs_f.write(f"{name} {key}\n")
            self._refs_f.flush()
            os.fsync(self._refs_f.fileno())  # ref update = durability point

    def get_ref(self, name: str) -> Optional[str]:
        return self._refs.get(name)

    def list_refs(self) -> List[str]:
        return sorted(self._refs)


class ContentAddressedStore:
    """The store's facade, on the Python backend."""

    def __init__(self, prefer_native: bool = False,
                 directory: Optional[str] = None):
        """`directory` switches on DURABLE mode: blobs as
        content-addressed object files, refs in an fsynced append-only
        journal, state surviving process restart. ``prefer_native=True``
        raises ValueError: the native store is not ported."""
        if prefer_native:
            raise ValueError(
                "ContentAddressedStore(prefer_native=True): the native "
                "store is not ported; the port's store is the Python "
                "backend (prefer_native=False)")
        self.backend = "python"
        self.directory = directory
        self._impl = _PyStore(directory)

    def put(self, content) -> str:
        """Store `content`, returning its hash key. In durable mode the
        blob file's mtime is refreshed even when the content-addressed
        write was skipped (file already on disk): the retention GC's
        epoch-pin floor compares blob mtimes, so a deduplicated re-put
        must look as fresh as a first put or a recovery re-put of a
        not-yet-referenced blob could be swept before its manifest
        lands. If a concurrent sweep unlinks the file between the
        backend's existence check and the stamp, the put is retried."""
        key = self._impl.put(content)
        if self.directory:
            path = os.path.join(self.directory, "objects", key[:2], key)
            for attempt in range(5):
                try:
                    os.utime(path)
                    break
                except OSError:
                    if attempt == 4:
                        raise
                    self._impl.put(content)
        return key

    def get(self, key: str) -> bytes:
        return self._impl.get(key)

    def contains(self, key: str) -> bool:
        return self._impl.contains(key)

    def set_ref(self, name: str, key: str) -> None:
        self._impl.set_ref(name, key)

    def get_ref(self, name: str) -> Optional[str]:
        return self._impl.get_ref(name)

    def list_refs(self) -> List[str]:
        return self._impl.list_refs()
