"""Historian: the caching tier in front of summary storage.

Copied whole from fluidframework_tpu/server/historian.py
(`HistorianCache`, :22), on the port's metrics registry.

Mirrors the reference's historian service (server/historian, a Redis-
backed caching REST proxy in front of gitrest): content-addressed
blobs are IMMUTABLE, so they cache forever under an LRU budget; refs
(mutable head pointers) cache with explicit invalidation on writes
through this tier and a TTL against out-of-band writers. It wraps any
store with the put/get/contains/set_ref/get_ref/list_refs contract of
`server.castore.ContentAddressedStore`.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple


class HistorianCache:
    """LRU blob cache + TTL ref cache over a backing store.

    `blob_budget_bytes` bounds cached blob payloads (immutable:
    eviction only, never invalidation); `ref_ttl` bounds staleness for
    refs written by OTHER processes (writes through this historian
    invalidate immediately)."""

    def __init__(self, backing, blob_budget_bytes: int = 64 * 1024 * 1024,
                 ref_ttl: float = 1.0, name: str = "default"):
        """`name` labels this cache's metrics series (several
        historians in one process — e.g. a summary store next to a
        test fixture — must not fold into one gauge)."""
        self.backing = backing
        self.blob_budget = blob_budget_bytes
        self.ref_ttl = ref_ttl
        self._blobs: "OrderedDict[str, bytes]" = OrderedDict()
        self._blob_bytes = 0
        self._refs: Dict[str, Tuple[float, Optional[str]]] = {}
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        from ..utils.metrics import get_registry

        m = get_registry()
        self._m_bytes = m.gauge("historian_blob_bytes", cache=name)
        self._m_blobs = m.gauge("historian_blobs", cache=name)
        self._m_hits = m.counter("historian_hits_total", cache=name)
        self._m_misses = m.counter("historian_misses_total", cache=name)
        self._m_evictions = m.counter(
            "historian_evictions_total", cache=name
        )

    # ------------------------------------------------------------- blobs

    def put(self, content) -> str:
        key = self.backing.put(content)
        if isinstance(content, str):
            content = content.encode()
        with self._lock:
            self._admit(key, bytes(content))
        return key

    def get(self, key: str) -> bytes:
        with self._lock:
            data = self._blobs.get(key)
            if data is not None:
                self._blobs.move_to_end(key)
                self.hits += 1
                self._m_hits.inc()
                return data
            self.misses += 1
            self._m_misses.inc()
        data = self.backing.get(key)
        with self._lock:
            self._admit(key, data)
        return data

    def contains(self, key: str) -> bool:
        with self._lock:
            if key in self._blobs:
                return True
        return self.backing.contains(key)

    def _admit(self, key: str, data: bytes) -> None:
        if key in self._blobs:
            self._blobs.move_to_end(key)
            return
        if len(data) > self.blob_budget:
            return  # never cache a blob bigger than the whole budget
        self._blobs[key] = data
        self._blob_bytes += len(data)
        while self._blob_bytes > self.blob_budget:
            _, old = self._blobs.popitem(last=False)
            self._blob_bytes -= len(old)
            self._m_evictions.inc()
        self._m_bytes.set(self._blob_bytes)
        self._m_blobs.set(len(self._blobs))

    # -------------------------------------------------------------- refs

    def set_ref(self, name: str, key: str) -> None:
        self.backing.set_ref(name, key)
        with self._lock:
            self._refs[name] = (time.monotonic(), key)

    def get_ref(self, name: str) -> Optional[str]:
        with self._lock:
            hit = self._refs.get(name)
            if hit is not None and time.monotonic() - hit[0] < self.ref_ttl:
                self.hits += 1
                self._m_hits.inc()
                return hit[1]
            self.misses += 1
            self._m_misses.inc()
        val = self.backing.get_ref(name)
        with self._lock:
            self._refs[name] = (time.monotonic(), val)
        return val

    def list_refs(self) -> List[str]:
        return self.backing.list_refs()  # enumeration stays authoritative

    # ------------------------------------------------------------- stats

    def stats(self) -> dict:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "cached_blobs": len(self._blobs),
                "cached_bytes": self._blob_bytes,
                "cached_refs": len(self._refs),
            }
