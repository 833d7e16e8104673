"""The port's catch-up readers against the JAX package's, on the same
directories.

- `tail_records_reverse` (columnar) and `_tail_records_reverse` (JSONL)
  give the JAX scans' records: bounded by a base and an ``upto``, past
  a torn tail (a frame or a line without its newline is never read),
  with a stale or missing sidecar, and over a JSON-era prefix (None:
  the caller walks forward);
- `SummaryIndex.nearest` answers as the JAX index over a role's
  manifests;
- `read_catchup` gives the JAX reader's manifest, blob and tail: with
  ``byteOff`` (a stepped role) and without (the bench drive), with a
  ``byteTopic`` that names another topic, through the forward walk
  when the columnar scan cannot anchor, and raises LookupError below a
  truncated base;
- `SummaryReplica` boots and `state_digest`s equal the JAX replica's,
  for merge-tree and generic documents, cold and from a summary;
- the port's config10 loop (`testing/catchup_streams.run_catchup`) on
  the CPU at a small size.
"""

import json
import os
import shutil
import time

import pytest
import torch

from fluidframework_tpu.server import summarizer as jsum
from fluidframework_tpu.server.columnar_log import (
    ColumnarFileTopic as JaxColumnarTopic,
)
from fluidframework_tpu.server.columnar_log import (
    make_topic as jax_make_topic,
)
from fluidframework_tpu.server.columnar_log import (
    tail_records_reverse as jax_tail_reverse,
)
from fluidframework_tpu.testing.deli_bench import _drive_summarizer
from fluidframework_tpu_torch.protocol import record_batch as trb
from fluidframework_tpu_torch.server import summarizer as tsum
from fluidframework_tpu_torch.server.columnar_log import (
    ColumnarFileTopic,
    make_topic,
    tail_records_reverse,
)
from fluidframework_tpu_torch.testing.catchup_streams import (
    catchup_summary_ops,
    run_catchup,
    write_deltas,
)
from fluidframework_tpu_torch.testing.fold_streams import (
    build_mergetree_stream,
)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seq_op(doc, seq):
    return {"kind": "op", "doc": doc, "seq": seq, "msn": 0,
            "client": 1, "clientSeq": seq, "refSeq": 0, "type": "op",
            "contents": {"s": seq}, "inOff": seq}


def _grow_log(topic, frames, per_frame=20, start=(0, 0)):
    sa, sb = start
    for i in range(frames):
        batch = []
        for j in range(per_frame):
            if (i + j) % 2 == 0:
                sa += 1
                batch.append(_seq_op("A", sa))
            else:
                sb += 1
                batch.append(_seq_op("B", sb))
        topic.append_many(batch)
    return sa, sb


def _both_columnar(path, doc, base, upto, stop_at=None):
    got = tail_records_reverse(ColumnarFileTopic(path), doc, base, upto,
                               stop_at=stop_at)
    want = jax_tail_reverse(JaxColumnarTopic(path), doc, base, upto,
                            stop_at=stop_at)
    assert got == want
    return got


# ------------------------------------------------------------ reverse scans


def test_columnar_reverse_matches_jax(tmp_path):
    path = str(tmp_path / "d.jsonl")
    t = ColumnarFileTopic(path)
    sa, sb = _grow_log(t, 60)
    ops = _both_columnar(path, "A", sa - 15, None)
    assert [r["seq"] for r in ops] == list(range(sa - 14, sa + 1))
    assert _both_columnar(path, "B", 0, None) == [
        r for _, r in t.read_entries(0)[0] if r.get("doc") == "B"]
    got = _both_columnar(path, "A", sa - 10, sa - 5)
    assert [r["seq"] for r in got] == list(range(sa - 9, sa - 4))
    # a stop_at floor at a frame boundary halfway down
    data = open(path, "rb").read()
    pos = 0
    for _ in range(30):
        _, pos, _ = trb.decode_batch(data, pos)
    below = _both_columnar(path, "A", 0, None, stop_at=pos)
    assert below and below[0]["seq"] > 1 and below[-1]["seq"] == sa


def test_columnar_reverse_torn_and_sidecars(tmp_path):
    path = str(tmp_path / "d.jsonl")
    t = ColumnarFileTopic(path)
    sa, _ = _grow_log(t, 30)
    want = _both_columnar(path, "A", sa - 12, None)
    with open(path, "ab") as f:  # a frame in flight
        f.write(trb.encode_batch([_seq_op("A", sa + 1)], fence=1,
                                 owner="w")[:-7])
    assert _both_columnar(path, "A", sa - 12, None) == want
    # stale-low sidecar: the forward suffix parse covers the gap
    data = open(path, "rb").read()
    _, end, _ = trb.decode_batch(data, 0)
    with open(path + ".clen", "w") as f:
        json.dump({"len": end}, f)
    assert _both_columnar(path, "A", sa - 12, None) == want
    os.remove(path + ".clen")  # no sidecar: None, the caller walks forward
    assert _both_columnar(path, "A", 0, None) is None


def test_columnar_reverse_json_prefix(tmp_path):
    path = str(tmp_path / "m.jsonl")
    with open(path, "w") as f:
        for s in range(1, 6):
            f.write(json.dumps(_seq_op("A", s)) + "\n")
    sa, _ = _grow_log(ColumnarFileTopic(path), 10, start=(5, 0))
    ops = _both_columnar(path, "A", sa - 5, None)
    assert [r["seq"] for r in ops] == list(range(sa - 4, sa + 1))
    assert _both_columnar(path, "A", 0, None) is None


def test_json_reverse_matches_jax_and_ignores_torn_line(tmp_path):
    path = str(tmp_path / "d.jsonl")
    topic = make_topic(path, "json")
    sa, sb = _grow_log(topic, 40)
    data = open(path, "rb").read()
    mid = data.index(b"\n", len(data) // 2) + 1  # a line boundary
    cases = [("A", sa - 7, None, None), ("B", 0, None, None),
             ("A", sa - 30, sa - 3, None), ("A", 0, None, mid),
             ("B", sb - 5, None, mid + 5)]  # a floor inside a line
    want = [jsum._tail_records_reverse(path, *c) for c in cases]
    assert [tsum._tail_records_reverse(path, *c) for c in cases] == want
    assert [r["seq"] for r in want[0]] == list(range(sa - 6, sa + 1))
    with open(path, "ab") as f:  # a line without its newline
        f.write(json.dumps(_seq_op("A", sa + 1)).encode()[:-1])
    assert [tsum._tail_records_reverse(path, *c) for c in cases] == want
    for tail, seqs in ((b"}", [sa]), (b"\n", [sa, sa + 1])):
        with open(path, "ab") as f:  # complete, then with its newline
            f.write(tail)
        got = tsum._tail_records_reverse(path, "A", sa - 1, None)
        assert got == jsum._tail_records_reverse(path, "A", sa - 1, None)
        assert [r["seq"] for r in got] == seqs
    assert tsum._tail_records_reverse(str(tmp_path / "none"), "A", 0,
                                      None) == []


# ------------------------------------------------------------ the readers


def _jax_stepped(shared, fmt, summary_ops):
    role = jsum.SummarizerRole(shared, owner="t", ttl_s=3600.0, batch=97,
                               log_format=fmt, summary_ops=summary_ops,
                               fold_backend="kernel")
    while role.step():
        pass
    return role


@pytest.fixture(scope="module")
def summarized(tmp_path_factory):
    """A 500-op document (seed 4) and a generic one, interleaved and
    summarized by the JAX role, per format: stepped (``byteOff`` set)
    and by the bench drive (``byteOff`` None)."""
    root = tmp_path_factory.mktemp("summarized")
    mt = build_mergetree_stream(500, n_clients=3, seed=4)
    gen = [dict(r, doc="g", contents={"v": i} if r["type"] == "op"
                else r["contents"]) for i, r in enumerate(
        build_mergetree_stream(150, n_clients=2, seed=5))]
    recs = []
    for i in range(max(len(mt), len(gen))):
        recs += [r[i] for r in (mt, gen) if i < len(r)]
    dirs = {}
    for fmt in ("json", "columnar"):
        for how in ("stepped", "drive"):
            shared = str(root / f"{fmt}-{how}")
            write_deltas(shared, recs, fmt, frame=64)
            if how == "stepped":
                _jax_stepped(shared, fmt, 60)
            else:
                _drive_summarizer(shared, fmt, 60, batch=128)
            dirs[(fmt, how)] = shared
    return {"records": recs, "mt": mt, "gen": gen, "dirs": dirs}


def _copy(src, dst):
    """A summarized directory, without the roles' doorbell FIFOs."""
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("*.bells"))


def _catchups(shared, fmt, doc, seq=None, deltas_topic="deltas"):
    got = tsum.read_catchup(shared, doc, fmt, seq=seq,
                            deltas_topic=deltas_topic)
    want = jsum.read_catchup(shared, doc, fmt, seq=seq,
                             deltas_topic=deltas_topic)
    assert got == want
    return got


@pytest.mark.parametrize("fmt", ["json", "columnar"])
@pytest.mark.parametrize("how", ["stepped", "drive"])
def test_index_and_catchup_match_jax(summarized, fmt, how):
    shared = summarized["dirs"][(fmt, how)]
    tidx = tsum.SummaryIndex(shared, fmt)
    jidx = jsum.SummaryIndex(shared, fmt)
    assert tidx.poll() == jidx.poll() > 0
    assert tidx.manifests == jidx.manifests
    mans = tidx.manifests["doc0"]
    offs = [m["byteOff"] for m in mans]
    assert all(isinstance(o, int) for o in offs) == (how == "stepped")
    for seq in (None, 1, mans[0]["seq"] - 1, mans[0]["seq"],
                mans[2]["seq"] + 3, 10 ** 9):
        for doc in ("doc0", "g", "nope"):
            assert tidx.nearest(doc, seq) == jidx.nearest(doc, seq)
    for doc in ("doc0", "g"):
        for seq in (None, mans[1]["seq"] + 7, 5):
            cu = _catchups(shared, fmt, doc, seq)
            assert (cu["manifest"] is None) == (seq == 5)


@pytest.mark.parametrize("fmt", ["json", "columnar"])
def test_catchup_byte_topic_mismatch(summarized, fmt, tmp_path):
    """A manifest stamped against ``deltas`` read against another
    topic: the byteOff floor is not used, both readers scan unbounded
    and agree."""
    src = summarized["dirs"][(fmt, "stepped")]
    shared = str(tmp_path / "s")
    _copy(src, shared)
    topics = os.path.join(shared, "topics")
    for name in os.listdir(topics):
        if name.startswith("deltas.jsonl"):
            os.replace(os.path.join(topics, name), os.path.join(
                topics, name.replace("deltas", "deltas-x", 1)))
    cu = _catchups(shared, fmt, "doc0", deltas_topic="deltas-x")
    assert cu["manifest"]["byteTopic"] == "deltas" and cu["ops"]


def test_catchup_forward_fallback(summarized, tmp_path):
    """Without the committed-length sidecar the columnar scan cannot
    anchor: both readers walk forward from the manifest's ``off``."""
    src = summarized["dirs"][("columnar", "stepped")]
    shared = str(tmp_path / "s")
    _copy(src, shared)
    want = _catchups(shared, "columnar", "doc0")
    os.remove(os.path.join(shared, "topics", "deltas.jsonl.clen"))
    got = _catchups(shared, "columnar", "doc0")
    assert got == want and got["ops"]


def test_catchup_below_truncated_base_raises(summarized, tmp_path):
    src = summarized["dirs"][("columnar", "stepped")]
    shared = str(tmp_path / "s")
    _copy(src, shared)
    first = tsum.SummaryIndex(shared, "columnar")
    first.poll()
    man = first.manifests["doc0"][0]
    ColumnarFileTopic(os.path.join(shared, "topics", "deltas.jsonl")) \
        .truncate_prefix(man["off"])
    for mod in (tsum, jsum):
        with pytest.raises(LookupError, match="retention horizon"):
            mod.read_catchup(shared, "doc0", "columnar",
                             seq=man["seq"] - 1)
    # at or above the first summary the join still answers, identically
    _catchups(shared, "columnar", "doc0", seq=man["seq"] + 1)


@pytest.mark.parametrize("fmt", ["json", "columnar"])
def test_replica_digests_match_jax(summarized, fmt):
    shared = summarized["dirs"][(fmt, "stepped")]
    for doc, recs in (("doc0", summarized["mt"]),
                      ("g", summarized["gen"])):
        cu = tsum.read_catchup(shared, doc, fmt)
        tboot = tsum.SummaryReplica(cu["blob"], device="cpu")
        tboot.apply_records(cu["ops"])
        jboot = jsum.SummaryReplica(cu["blob"])
        jboot.apply_records(cu["ops"])
        tcold = tsum.SummaryReplica(None, device="cpu")
        tcold.apply_records(recs)
        assert tboot.state_digest() == jboot.state_digest() \
            == tcold.state_digest()
        assert tboot.form == ("mergetree" if doc == "doc0" else "ops")
    # a cold boot whose first records are joins only, then one op
    joins = summarized["mt"][:3]
    for n in (2, 3, 4):
        t = tsum.SummaryReplica(None, device="cpu")
        j = jsum.SummaryReplica(None)
        assert t.apply_records(summarized["mt"][:n]) == \
            j.apply_records(summarized["mt"][:n])
        assert t.state_digest() == j.state_digest()
        assert (t.form is None) == (n <= len(joins))
    with pytest.raises(ValueError, match="unknown summary form"):
        tsum.SummaryReplica({"form": "x", "seq": 1, "msn": 0},
                            device="cpu")


# ------------------------------------------------------------ the loop


def test_catchup_loop_on_cpu(tmp_path):
    """config10's loop (`run_catchup`) at a small size on the CPU: the
    summary join and the full replay agree at each length, the
    manifests are the JAX role's, and the cadence clamp is the
    reference's."""
    assert catchup_summary_ops(2000, 10_000) == 2000
    assert catchup_summary_ops(2000, 400) == 100
    t0 = time.perf_counter()
    res = run_catchup((300, 600), summary_ops=2000, log_format="columnar",
                      device="cpu", fold_backend="overlay", warm=False,
                      work_dir=str(tmp_path / "port"))
    assert time.perf_counter() - t0 < 300
    assert res["summary_ops"] == 75
    stream = build_mergetree_stream(600, n_clients=4)
    for r in res["runs"]:
        shared = str(tmp_path / f"jax{r['log_len']}")
        write_deltas(shared, stream[: 4 + r["log_len"]], "columnar")
        _drive_summarizer(shared, "columnar", 75)
        topic = jax_make_topic(os.path.join(shared, "topics",
                                            "summaries.jsonl"), "columnar")
        assert r["manifests"] == list(topic.read_from(0))
        assert r["summaries"] == len(r["manifests"]) == (
            4 + r["log_len"]) // 75
        assert r["launches"]["role"] == {"scan": 0, "overlay": 0}
        cold = jsum.SummaryReplica(None)
        cold.apply_records(stream[: 4 + r["log_len"]])
        assert r["digest"] == cold.state_digest()
    assert res["join_flatness"] > 0
