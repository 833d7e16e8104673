"""The port's summary store, historian cache and GC pins against the JAX
package's.

- a store directory written by either package is read by the other
  (blobs, refs), and both write the same files byte for byte;
- `put` of a blob already on disk refreshes its mtime, in both;
- the historian's hits, misses and LRU evictions match the JAX cache's
  over the same calls;
- pin files written by either package give the other's
  `live_pin_floor` the same floor, stale pins are ignored by both, and
  a cleared pin is gone for both;
- ``prefer_native=True`` raises in the port (no native store, and no
  quiet fallback to the Python one).
"""

import json
import os

import pytest

from fluidframework_tpu.server import retention as jret
from fluidframework_tpu.server.castore import \
    ContentAddressedStore as JaxStore
from fluidframework_tpu.server.historian import HistorianCache as JaxCache
from fluidframework_tpu_torch.server import retention as tret
from fluidframework_tpu_torch.server.castore import ContentAddressedStore
from fluidframework_tpu_torch.server.historian import HistorianCache

BLOBS = [b"", b"alpha", "unicode é中".encode(),
         json.dumps({"rows": [["ab", -1, -3, None, None, None]]},
                    sort_keys=True, separators=(",", ":")).encode(),
         bytes(range(256)) * 64]


def _make(pkg, d):
    if pkg == "jax":
        return JaxStore(prefer_native=False, directory=d)
    return ContentAddressedStore(directory=d)


def _files(d):
    out = {}
    for root, _dirs, names in os.walk(d):
        for n in names:
            p = os.path.join(root, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, d)] = f.read()
    return out


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_store_directory_read_across_packages(tmp_path, writer, reader):
    d = str(tmp_path / "store")
    w = _make(writer, d)
    keys = [w.put(b) for b in BLOBS]
    assert keys[1] == w.put("alpha")  # str content hashes its utf-8
    w.set_ref("doc0", keys[1])
    w.set_ref("doc1", keys[3])
    w.set_ref("doc0", keys[4])
    r = _make(reader, d)
    assert [r.get(k) for k in keys] == BLOBS
    assert all(r.contains(k) for k in keys)
    assert not r.contains("0" * 64)
    with pytest.raises(KeyError):
        r.get("0" * 64)
    assert r.list_refs() == ["doc0", "doc1"]
    assert r.get_ref("doc0") == keys[4] and r.get_ref("doc1") == keys[3]
    with pytest.raises(KeyError):
        r.set_ref("doc2", "f" * 64)  # unknown blob


def test_store_files_identical(tmp_path):
    stores = {}
    for pkg in ("jax", "port"):
        s = _make(pkg, str(tmp_path / pkg))
        for b in BLOBS:
            s.put(b)
        s.set_ref("d", s.put(BLOBS[2]))
        stores[pkg] = _files(str(tmp_path / pkg))
    assert stores["jax"] == stores["port"]
    assert "refs.log" in stores["port"] and len(stores["port"]) == 6


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_put_refreshes_mtime(tmp_path, pkg):
    d = str(tmp_path / "store")
    s = _make(pkg, d)
    key = s.put(b"payload")
    path = os.path.join(d, "objects", key[:2], key)
    os.utime(path, (1_000_000.0, 1_000_000.0))
    assert os.stat(path).st_mtime == 1_000_000.0
    assert s.put(b"payload") == key  # deduplicated re-put
    assert os.stat(path).st_mtime > 1_000_000.0
    # a re-put of a file swept behind the store's back rewrites it
    os.unlink(path)
    assert _make(pkg, d).put(b"payload") == key and os.path.exists(path)


def test_memory_store_and_native_refusal():
    s = ContentAddressedStore()
    k = s.put(b"x")
    assert s.get(k) == b"x" and s.backend == "python"
    assert k == JaxStore(prefer_native=False).put(b"x")
    with pytest.raises(ValueError, match="native store is not ported"):
        ContentAddressedStore(prefer_native=True)


def test_historian_matches_jax(tmp_path):
    caches = {}
    for pkg, cls in (("jax", JaxCache), ("port", HistorianCache)):
        backing = _make(pkg, str(tmp_path / pkg))
        c = cls(backing, blob_budget_bytes=20_000, name=f"t-{pkg}")
        keys = [c.put(b) for b in BLOBS[:4]]
        got = [c.get(k) for k in keys + keys[::-1]]
        big = c.put(BLOBS[4])  # larger than the budget: never cached
        got.append(c.get(big))
        c.set_ref("r", keys[0])
        refs = [c.get_ref("r"), c.get_ref("nope"), c.list_refs(),
                c.contains(big), c.contains("0" * 64)]
        caches[pkg] = (got, refs, c.stats())
    assert caches["jax"] == caches["port"]
    assert caches["port"][2]["misses"] >= 1


def test_historian_evicts_like_jax(tmp_path):
    stats = {}
    for pkg, cls in (("jax", JaxCache), ("port", HistorianCache)):
        c = cls(_make(pkg, None), blob_budget_bytes=12, name=f"e-{pkg}")
        keys = [c.put(bytes([i]) * 5) for i in range(4)]
        for k in keys:
            c.get(k)
        stats[pkg] = c.stats()
    assert stats["jax"] == stats["port"]
    assert stats["port"]["cached_blobs"] == 2


@pytest.mark.parametrize("writer,reader", [(jret, tret), (tret, jret)])
def test_pins_agree_across_packages(tmp_path, writer, reader):
    shared = str(tmp_path)
    assert reader.live_pin_floor(shared) is None
    t1 = writer.write_pin(shared, "summarizer", 1000.5)
    t2 = writer.write_pin(shared, "summarizer-p1", 2000.25)
    assert (t1, t2) == (1000.5, 2000.25)
    assert reader.live_pin_floor(shared) == 1000.5
    # a heartbeat keeps the floor
    writer.write_pin(shared, "summarizer", 1000.5)
    assert reader.live_pin_floor(shared) == 1000.5
    # a stale pin (its file not rewritten for PIN_TTL_S) is ignored
    old = os.path.join(shared, "store", "pins", "summarizer.json")
    stale = os.stat(old).st_mtime - reader.PIN_TTL_S - 5
    os.utime(old, (stale, stale))
    assert reader.live_pin_floor(shared) == 2000.25
    reader.clear_pin(shared, "summarizer-p1")
    assert writer.live_pin_floor(shared) is None
    writer.clear_pin(shared, "never-written")  # clearing nothing is fine
    assert tret.PIN_TTL_S == jret.PIN_TTL_S


def test_pin_files_identical(tmp_path):
    for mod in (jret, tret):
        mod.write_pin(str(tmp_path / mod.__name__), "summarizer", 12.75)
    files = [_files(str(tmp_path / mod.__name__)) for mod in (jret, tret)]
    assert files[0] == files[1]
    assert list(files[1]) == [os.path.join("store", "pins",
                                           "summarizer.json")]
