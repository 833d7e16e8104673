"""The port's `SummaryFolder` vs the JAX summary role.

The JAX `SummarizerRole` (kernel fold backend, driven over a deltas
topic as tests/test_device_plane.py:437-489 drives it) and the port's
`SummaryFolder` (``device="cpu"``) take the same sequenced records.
Their manifests ``(doc, seq, handle, count, form)`` and blob bytes must
be equal:

- one merge-tree document, several emissions;
- a mixed stream: a merge-tree document, a generic ("ops" form)
  document, and one whose cadence point falls while it has only joins
  (skipped by both);
- an undecodable op freezes its document in both, and the other
  documents go on emitting; so does a kernel error flag.
"""

import os

import pytest
import torch

from fluidframework_tpu.server.columnar_log import make_tail_reader, make_topic
from fluidframework_tpu.server.summarizer import SummarizerRole
from fluidframework_tpu.testing.deli_bench import build_mergetree_stream
from fluidframework_tpu_torch.server.summary_fold import (
    DEFAULT_SUMMARY_OPS,
    SummaryFolder,
)


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


def _drive_folder(recs, summary_ops):
    folder = SummaryFolder(summary_ops=summary_ops, device="cpu")
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
    assert set(folder.blobs) == {m["handle"] for m in mf}
    return folder, mf


def test_summary_folder_matches_role_handles(tmp_path):
    recs = build_mergetree_stream(260, n_clients=4, seed=60)
    folder, mf = _compare(tmp_path, recs, 64)
    assert [m["count"] for m in mf] == [64, 128, 192, 256]
    assert {m["form"] for m in mf} == {"mergetree"} and not folder.frozen
    assert SummaryFolder(device="cpu").summary_ops == DEFAULT_SUMMARY_OPS


def _interleave(*streams):
    out = []
    for i in range(max(len(s) for s in streams)):
        out.extend(s[i] for s in streams if i < len(s))
    return out


def test_summary_folder_mixed_stream_matches_role(tmp_path):
    mt = build_mergetree_stream(90, n_clients=3, seed=61, doc="mt")
    generic = [{"kind": "op", "doc": "gen", "seq": i + 1,
                "msn": max(0, i - 4), "client": 1 + i % 2,
                "clientSeq": i, "refSeq": i,
                "type": "op" if i % 5 else "noop",
                "contents": {"key": f"k{i % 3}", "value": i}}
               for i in range(70)]
    late = [{"kind": "op", "doc": "late", "seq": i + 1, "msn": 0,
             "client": i + 1, "clientSeq": 0, "refSeq": i, "type": "join",
             "contents": i + 1} for i in range(20)]
    late += build_mergetree_stream(40, n_clients=2, seed=62,
                                   doc="late")[2:]
    for i, r in enumerate(late[20:]):
        r["seq"], r["refSeq"] = 21 + i, 20 + i
    junk = [{"kind": "nack", "doc": "mt"}, "not a record", {"kind": "op"}]
    recs = _interleave(mt, generic, late) + junk
    folder, mf = _compare(tmp_path, recs, 16)
    forms = {m["doc"]: m["form"] for m in mf}
    assert forms == {"mt": "mergetree", "gen": "ops", "late": "mergetree"}
    # The first cadence point of "late" (count 16) fell on joins only.
    assert [m["count"] for m in mf if m["doc"] == "late"] == [32, 48]


def test_undecodable_op_freezes_like_role(tmp_path, capsys):
    bad = build_mergetree_stream(120, n_clients=3, seed=63, doc="bad")
    bad[70] = dict(bad[70], contents={"type": 7, "pos1": 0})
    good = build_mergetree_stream(120, n_clients=3, seed=64, doc="good")
    folder, mf = _compare(tmp_path, _interleave(bad, good), 32)
    assert [m["count"] for m in mf if m["doc"] == "bad"] == [32, 64]
    assert [m["count"] for m in mf if m["doc"] == "good"] == [32, 64, 96]
    assert list(folder.frozen) == ["bad"]
    assert "froze bad" in capsys.readouterr().out


def test_kernel_error_freezes_like_role(tmp_path, capsys):
    """An op past the document's end flags ERR_BAD_POS in the fold; the
    serialization raises and the document freezes, in both."""
    bad = build_mergetree_stream(100, n_clients=3, seed=65, doc="bad")
    bad[50] = dict(bad[50], contents={"type": 0, "pos1": 10_000,
                                      "seg": "far"})
    folder, mf = _compare(tmp_path, bad, 25)
    assert [m["count"] for m in mf] == [25, 50]
    assert "position beyond visible length" in folder.frozen["bad"]
    assert "froze bad" in capsys.readouterr().out


def test_summary_folder_refuses_bad_cadence():
    with pytest.raises(ValueError, match="summary_ops"):
        SummaryFolder(summary_ops=0, device="cpu")
