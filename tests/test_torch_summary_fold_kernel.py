"""The summary fold's ``kernel`` backend: the port vs the JAX role.

- `SummaryFolder(fold_backend="kernel", device="cpu")` and the JAX
  `SummarizerRole` (its ``kernel`` backend, driven over a deltas topic
  as tests/test_torch_summary_fold.py drives it) take the same records;
  manifests ``(doc, seq, handle, count, form)`` and blob bytes must be
  equal: one merge-tree document, a mixed stream, and the freezes (an
  undecodable op, a kernel error flag, a prop-key overflow);
- the port's two backends give the same manifests and blobs;
- `run_fold_sweep(backend="kernel")` over fold_golden.json's first 4
  documents reaches every emission's digest, with the launches it
  counts at least the chunks of the longest document;
- `compare_fold_backends` finds both backends equal and refuses a
  difference.
"""

import os

import pytest
import torch

from fluidframework_tpu.server.columnar_log import make_tail_reader, make_topic
from fluidframework_tpu.server.summarizer import SummarizerRole
from fluidframework_tpu.testing.deli_bench import build_mergetree_stream
from fluidframework_tpu_torch.server import summary_fold
from fluidframework_tpu_torch.server.summary_fold import SummaryFolder
from fluidframework_tpu_torch.testing import fold_streams


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _drive_role(shared, recs, summary_ops):
    os.makedirs(os.path.join(shared, "topics"), exist_ok=True)
    deltas = make_topic(os.path.join(shared, "topics", "deltas.jsonl"),
                        "json")
    deltas.append_many(recs)
    role = SummarizerRole(shared, owner="t-summ", ttl_s=3600.0,
                          log_format="json", summary_ops=summary_ops,
                          fold_backend="kernel")
    role.fence = 1
    reader = make_tail_reader(deltas)
    manifests = []
    while True:
        entries = reader.poll(4096)
        if not entries:
            break
        out = []
        for line_idx, rec in entries:
            role.process(line_idx, rec, out)
        role.flush_batch(out)
        if out:
            role.out_topic.append_many(out, fence=1, owner="t-summ")
            manifests.extend(out)
        role.offset = reader.next_line
    return role, manifests


def _drive_folder(recs, summary_ops, backend="kernel"):
    folder = SummaryFolder(summary_ops=summary_ops, device="cpu",
                           fold_backend=backend)
    for rec in recs:
        folder.process(rec)
    return folder, folder.flush()


def _key(ms):
    return [(m["doc"], m["seq"], m["handle"], m["count"], m["form"])
            for m in ms]


def _compare(tmp_path, recs, summary_ops):
    role, mr = _drive_role(str(tmp_path), recs, summary_ops)
    folder, mf = _drive_folder(recs, summary_ops)
    assert len(mr) > 0 and _key(mf) == _key(mr)
    for m, r in zip(mf, mr):
        assert m["msn"] == r["msn"] and m["bytes"] == r["bytes"]
        assert folder.blobs[m["handle"]] == role.store.get(r["handle"])
    return folder, mf


def _interleave(*streams):
    out = []
    for i in range(max(len(s) for s in streams)):
        out.extend(s[i] for s in streams if i < len(s))
    return out


def test_kernel_backend_matches_role_handles(tmp_path):
    recs = build_mergetree_stream(700, n_clients=4, seed=60)
    folder, mf = _compare(tmp_path, recs, 128)
    assert [m["count"] for m in mf] == [128, 256, 384, 512, 640]
    assert folder.fold_backend == "kernel" and not folder.frozen


def test_kernel_backend_mixed_stream_matches_role(tmp_path):
    mt = build_mergetree_stream(90, n_clients=3, seed=61, doc="mt")
    generic = [{"kind": "op", "doc": "gen", "seq": i + 1,
                "msn": max(0, i - 4), "client": 1 + i % 2,
                "clientSeq": i, "refSeq": i,
                "type": "op" if i % 5 else "noop",
                "contents": {"key": f"k{i % 3}", "value": i}}
               for i in range(70)]
    mt2 = build_mergetree_stream(60, n_clients=2, seed=62, doc="mt2")
    folder, mf = _compare(tmp_path, _interleave(mt, generic, mt2), 16)
    forms = {m["doc"]: m["form"] for m in mf}
    assert forms == {"mt": "mergetree", "gen": "ops", "mt2": "mergetree"}


def test_kernel_backend_freezes_like_role(tmp_path, capsys):
    """An undecodable op, an op past the document's end (ERR_BAD_POS,
    raised by the serialization) and a ninth property key (the encoder's
    overflow) each freeze their document in both; the others go on."""
    bad = build_mergetree_stream(120, n_clients=3, seed=63, doc="bad")
    bad[70] = dict(bad[70], contents={"type": 7, "pos1": 0})
    far = build_mergetree_stream(100, n_clients=3, seed=65, doc="far")
    far[50] = dict(far[50], contents={"type": 0, "pos1": 10_000,
                                      "seg": "far"})
    keys = build_mergetree_stream(100, n_clients=3, seed=66, doc="keys")
    for i in range(9):
        keys[40 + i] = dict(keys[40 + i], contents={
            "type": 2, "pos1": 0, "pos2": 1, "props": {f"key{i}": i}})
    good = build_mergetree_stream(120, n_clients=3, seed=64, doc="good")
    folder, mf = _compare(tmp_path, _interleave(bad, far, keys, good), 32)
    assert sorted(folder.frozen) == ["bad", "far", "keys"]
    assert "position beyond visible length" in folder.frozen["far"]
    assert [m["count"] for m in mf if m["doc"] == "good"] == [32, 64, 96]
    assert "froze far" in capsys.readouterr().out


def test_kernel_and_overlay_backends_emit_the_same_blobs():
    recs = _interleave(
        build_mergetree_stream(400, n_clients=4, seed=67, doc="a"),
        build_mergetree_stream(300, n_clients=4, seed=68, doc="b"))
    fk, mk = _drive_folder(recs, 96, "kernel")
    fo, mo = _drive_folder(recs, 96, "overlay")
    assert _key(mk) == _key(mo) and len(mk) == 7
    assert fk.blobs == fo.blobs
    assert SummaryFolder(device="cpu").fold_backend == "overlay"
    with pytest.raises(ValueError, match="fold_backend"):
        SummaryFolder(device="cpu", fold_backend="scan")


def test_kernel_fold_sweep_meets_fold_golden():
    golden = fold_streams.load_fold_golden()
    streams = fold_streams.golden_streams(golden, 4)
    want = {d["doc"]: d["rows_sha256"] for d in golden["docs"]}
    out = fold_streams.run_fold_sweep(
        streams, golden["params"]["summary_ops"], "cpu", backend="kernel")
    assert out["digests"] == {d: want[d] for d in streams}
    caps = set()
    for r in out["rounds"]:
        assert r["emissions"] == 4 and r["device_ms"] is None
        assert r["chunks"] >= r["steps"] >= 1
        caps |= {g["capacity"] for g in r["groups"]}
    # Tables grow 512 -> 1024 -> 2048 over the emissions.
    assert caps == {512, 1024, 2048}


def test_compare_fold_backends(monkeypatch):
    golden = fold_streams.load_fold_golden()
    streams = {d: recs[:800] for d, recs in
               fold_streams.golden_streams(golden, 2).items()}
    out = fold_streams.compare_fold_backends(streams, 375, "cpu")
    assert out["kernel"]["digests"] == out["overlay"]["digests"]
    assert out["fold_backend_speedup"] > 0
    real = summary_fold._canonical_rows

    def drift(rep, msn):
        rows = real(rep, msn)
        rows[-1][0] += "z"  # one more character at the document's end
        return rows

    monkeypatch.setattr(summary_fold, "_canonical_rows", drift)
    with pytest.raises(AssertionError, match="fold backends differ"):
        fold_streams.compare_fold_backends(streams, 375, "cpu")
