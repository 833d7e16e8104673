"""The port's file topics, leases and checkpoints
(`fluidframework_tpu_torch.server.queue` / `columnar_log`) against the
JAX package's, over one directory, exactly.

A topic written by either package (JSON lines or columnar frames) reads
the same through the other's readers: `read_entries`, the tail readers'
`poll` and `poll_batches` record offsets. A torn tail is invisible to
both and sealed by the next append of either; a stale fence is refused
with `FencedError` by both. `LeaseManager` and `FencedCheckpointStore`
interoperate: acquire, renew, expire, take over, and a stale-fence save
refused.
"""

import time

import pytest

from fluidframework_tpu.server import columnar_log as jcl
from fluidframework_tpu.server import queue as jq
from fluidframework_tpu_torch.protocol import record_batch as trb
from fluidframework_tpu_torch.server import columnar_log as tcl
from fluidframework_tpu_torch.server import queue as tq
from fluidframework_tpu_torch.testing.deli_streams import (
    gen_boxcar_wire,
    gen_wire_traffic,
)

PKGS = {"torch": (tq, tcl), "jax": (jq, jcl)}


def _traffic():
    return gen_wire_traffic(1, ops=6) + gen_boxcar_wire(2, ops=5)


def _offsets_batches(reader, cap):
    """Every unit `poll_batches` hands out: (kind, first offset, count)."""
    out = []
    while True:
        units = reader.poll_batches(cap)
        if not units:
            return out
        for u in units:
            out.append((u[0], u[1], u[2].n if u[0] == "batch" else 1))


def _poll_all(reader, cap):
    out = []
    while True:
        got = reader.poll(cap)
        if not got:
            return out
        out.extend(got)


@pytest.mark.parametrize("fmt", ["json", "columnar"])
@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_topic_written_by_one_reads_the_same_in_the_other(fmt, writer,
                                                          tmp_path):
    recs = _traffic()
    path = str(tmp_path / "topics" / "t.jsonl")
    wq, wcl = PKGS[writer]
    topic = wcl.make_topic(path, fmt)
    for i, lo in enumerate(range(0, len(recs), 11)):
        topic.append_many(recs[lo:lo + 11], fence=3, owner="w")
        if i == 2:
            topic.append_many([], fence=3, owner="w")  # empty append
    views = {}
    for name, (q, cl) in PKGS.items():
        t = cl.make_topic(path, fmt)
        entries, nxt = t.read_entries(0)
        mid, _ = t.read_entries(17)
        reader = cl.make_tail_reader(t, 0)
        polled = _poll_all(reader, 7)
        views[name] = (entries, nxt, mid, polled, reader.next_line)
        assert [r for _, r in entries] == recs
        assert [o for o, _ in polled] == list(range(len(recs)))
        if fmt == "columnar":
            # the columnar reader's frame units and their offsets
            views[name] += (_offsets_batches(
                cl.ColumnarTailReader(cl.ColumnarFileTopic(path), 5), 20),)
    assert views["torch"] == views["jax"]
    if fmt == "json":
        # columnar readers parse JSON lines: the upgrade direction
        for name, (q, cl) in PKGS.items():
            entries, _ = cl.ColumnarFileTopic(path).read_entries(0)
            assert [r for _, r in entries] == recs


@pytest.mark.parametrize("fmt", ["json", "columnar"])
@pytest.mark.parametrize("sealer", ["torch", "jax"])
def test_torn_tail_invisible_then_sealed(fmt, sealer, tmp_path):
    recs = _traffic()
    path = str(tmp_path / "t.jsonl")
    writer = "jax" if sealer == "torch" else "torch"
    PKGS[writer][1].make_topic(path, fmt).append_many(recs[:20], fence=1,
                                                      owner="a")
    PKGS[writer][1].make_topic(path, fmt).append_many(recs[20:40], fence=1,
                                                      owner="a")
    # a crash mid-append: a partial third append is on disk
    if fmt == "columnar":
        torn = trb.encode_batch(recs[40:45], fence=1, owner="a")[:-9]
    else:
        torn = b'{"kind": "join", "doc": "doc0", "cli'
    with open(path, "ab") as f:
        f.write(torn)
    for q, cl in PKGS.values():
        entries, nxt = cl.make_topic(path, fmt).read_entries(0)
        assert ([r for _, r in entries], nxt) == (recs[:40], 40)
        reader = cl.make_tail_reader(cl.make_topic(path, fmt), 0)
        assert [r for _, r in _poll_all(reader, 100)] == recs[:40]
    # the next append of the other package seals the torn tail: the
    # partial frame is cut away, the partial line stays as one counted
    # junk line
    PKGS[sealer][1].make_topic(path, fmt).append_many(recs[40:50], fence=1,
                                                      owner="a")
    views = []
    for q, cl in PKGS.values():
        entries, nxt = cl.make_topic(path, fmt).read_entries(0)
        views.append((entries, nxt))
        assert [r for _, r in entries] == recs[:50]
        assert nxt == (50 if fmt == "columnar" else 51)
    assert views[0] == views[1]


@pytest.mark.parametrize("fmt", ["json", "columnar"])
def test_stale_fence_refused_by_both(fmt, tmp_path):
    path = str(tmp_path / "t.jsonl")
    tcl.make_topic(path, fmt).append_many([{"a": 1}], fence=5, owner="o5")
    jcl.make_topic(path, fmt).append_many([{"a": 2}], fence=5, owner="o5")
    for pkg, (q, cl) in PKGS.items():
        topic = cl.make_topic(path, fmt)
        with pytest.raises(q.FencedError):
            topic.append_many([{"zombie": pkg}], fence=4, owner="o4")
        with pytest.raises(q.FencedError):  # same fence, other owner
            topic.append_many([{"zombie": pkg}], fence=5, owner="x")
    jcl.make_topic(path, fmt).append_many([{"a": 3}], fence=6, owner="o6")
    with pytest.raises(tq.FencedError):
        tcl.make_topic(path, fmt).append_many([{"z": 1}], fence=5,
                                              owner="o5")
    for q, cl in PKGS.values():
        entries, _ = cl.make_topic(path, fmt).read_entries(0)
        assert [r for _, r in entries] == [{"a": 1}, {"a": 2}, {"a": 3}]
        assert cl.make_topic(path, fmt).latest_fence() == (6, "o6")


@pytest.mark.parametrize("first", ["torch", "jax"])
def test_lease_manager_takeover_across_packages(first, tmp_path):
    second = "jax" if first == "torch" else "torch"
    d = str(tmp_path / "leases")
    a = PKGS[first][0].LeaseManager(d, "owner-a", ttl_s=0.3,
                                    claim_ttl_s=0.25)
    b = PKGS[second][0].LeaseManager(d, "owner-b", ttl_s=0.3,
                                     claim_ttl_s=0.25)
    fa = a.try_acquire("deli")
    assert fa is not None
    assert b.try_acquire("deli") is None  # live foreign lease
    assert a.renew("deli")
    assert b.owner_of("deli") == a.owner_of("deli") == "owner-a"
    assert a.try_acquire("deli") == fa  # re-acquire by the holder
    time.sleep(0.45)  # the lease expires
    fb = b.try_acquire("deli")
    assert fb is not None and fb > fa
    assert not a.renew("deli")  # deposed
    assert a.lease_info("deli")["owner"] == "owner-b"
    assert a.lease_info("deli")["fence"] == fb
    b.release("deli")
    fa2 = a.try_acquire("deli")  # released: taken at once, fence up
    assert fa2 is not None and fa2 > fb


@pytest.mark.parametrize("first", ["torch", "jax"])
def test_checkpoint_store_across_packages(first, tmp_path):
    second = "jax" if first == "torch" else "torch"
    d = str(tmp_path / "checkpoints")
    s1 = PKGS[first][0].FencedCheckpointStore(d)
    s2 = PKGS[second][0].FencedCheckpointStore(d)
    state = {"offset": 7, "state": {"doc0": {"seq": 3}}}
    s1.save("deli", state, fence=3, owner="o3")
    assert s2.load("deli")["state"] == state
    assert s2.load("deli") == s1.load("deli")
    with pytest.raises(PKGS[second][0].FencedError):
        s2.save("deli", {"offset": 0}, fence=2, owner="o2")
    with pytest.raises(PKGS[second][0].FencedError):
        s2.save("deli", {"offset": 0}, fence=3, owner="x")
    s2.save("deli", {"offset": 9, "state": None}, fence=4, owner="o4")
    assert s1.load("deli")["state"] == {"offset": 9, "state": None}
    with pytest.raises(PKGS[first][0].FencedError):
        s1.save("deli", state, fence=3, owner="o3")
    assert s1.load("deli") == s2.load("deli")
    assert s1.load("missing") is None and s2.load("missing") is None
