"""The port's `SummarizerRole` against the JAX package's.

On the CPU (``device="cpu"``: the plain versions of kernel A and the
scan), over JSON and columnar topics, the tolerance exact (bytes):

- **differential**: the port's role on each fold backend and the JAX
  role (kernel backend), stepped through the fenced lease loop over the
  same deltas: the ``summaries`` topic, every blob file and the
  checkpoint are byte for byte the same, for two merge-tree streams
  (seeds 3 and 11), a generic ("ops" form) document and three
  documents interleaved so that they fold stacked;
- **recovery**: a restart mid-stream re-emits identical summaries; a
  torn manifest append is re-emitted, once; an undecodable op freezes
  its document; a cadence point reached with only joins is skipped;
- **handover**: a JAX role's checkpoint and lease taken over by the
  port's role, and the other way round, end as an uninterrupted run;
- **raw submissions** through the port's `KernelDeliRole` and then the
  port's summarizer give the JAX pair's handles;
- the GC pin is live while a round's blobs are put and gone once its
  manifests are appended; the instruments carry the reference's names;
- **refusals**: an unknown backend, a cadence below 1, a device-plane
  spec that does not parse, and `serve_role` / `main` options the
  summarizer does not take.
"""

import json
import os
import time

import pytest
import torch

from fluidframework_tpu.server import summarizer as jsum
from fluidframework_tpu.server.supervisor import DeliRole as JaxDeliRole
from fluidframework_tpu.utils import metrics as jmetrics
from fluidframework_tpu_torch.server import retention as tret
from fluidframework_tpu_torch.server import supervisor as tsup
from fluidframework_tpu_torch.server.columnar_log import (
    make_tail_reader,
    make_topic,
)
from fluidframework_tpu_torch.server.deli_kernel import KernelDeliRole
from fluidframework_tpu_torch.server.summarizer import (
    PLANE_ENV,
    SummarizerRole,
    SummaryIndex,
    SummaryReplica,
    open_summary_store,
    read_catchup,
)
from fluidframework_tpu_torch.server.supervisor import partitioned_role_class
from fluidframework_tpu_torch.testing.catchup_streams import (
    drive_summarizer,
    manifests_of,
    write_deltas,
)
from fluidframework_tpu_torch.testing.fold_streams import (
    build_mergetree_stream,
)
from fluidframework_tpu_torch.utils import metrics as tmetrics

TTL = 0.6


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def generic_records(doc, n_ops=60, n_clients=3, seed=1):
    """Sequenced records with opaque contents (the "ops" form)."""
    import random

    rng = random.Random(seed)
    recs, seq = [], 0
    for c in range(1, n_clients + 1):
        seq += 1
        recs.append({"kind": "op", "doc": doc, "seq": seq, "msn": 0,
                     "client": c, "clientSeq": 0, "refSeq": seq - 1,
                     "type": "join", "contents": c})
    cseq = {c: 0 for c in range(1, n_clients + 1)}
    for i in range(n_ops):
        c = rng.randint(1, n_clients)
        seq += 1
        cseq[c] += 1
        recs.append({"kind": "op", "doc": doc, "seq": seq,
                     "msn": max(0, seq - 8), "client": c,
                     "clientSeq": cseq[c], "refSeq": seq - 1, "type": "op",
                     "contents": {"v": rng.randint(0, 999), "i": i}})
    return recs


def interleave(*streams):
    out = []
    for i in range(max(len(s) for s in streams)):
        out += [s[i] for s in streams if i < len(s)]
    return out


STREAMS = {
    "seed3": (lambda: build_mergetree_stream(220, n_clients=4, seed=3), 50),
    "seed11": (lambda: build_mergetree_stream(220, n_clients=3, seed=11),
               64),
    "ops": (lambda: generic_records("gdoc", n_ops=90), 20),
    "stacked": (lambda: interleave(*(
        build_mergetree_stream(70, n_clients=2, seed=s, doc=f"d{s}")
        for s in (5, 6, 7))), 24),
}


def _role(pkg, shared, fmt, summary_ops, owner="t", backend="kernel",
          ttl=3600.0, **kw):
    if pkg == "jax":
        return jsum.SummarizerRole(shared, owner=owner, ttl_s=ttl, batch=64,
                                   ckpt_interval_s=0.0, log_format=fmt,
                                   summary_ops=summary_ops,
                                   fold_backend="kernel", **kw)
    return SummarizerRole(shared, owner=owner, ttl_s=ttl, batch=64,
                          ckpt_interval_s=0.0, log_format=fmt,
                          summary_ops=summary_ops, fold_backend=backend,
                          device="cpu", **kw)


def _drain(role, until=None, max_steps=10_000):
    for _ in range(max_steps):
        moved = role.step(idle_sleep=0.005)
        if until is not None and role.offset >= until:
            return role
        if until is None and role.fence is not None and not moved:
            return role
    raise AssertionError("the role never drained its input")


def _files(shared):
    """The summary service's durable bytes: the manifest topic, every
    blob file and the checkpoint (loaded)."""
    out = {}
    for sub in ("topics", "store"):
        for root, _dirs, names in os.walk(os.path.join(shared, sub)):
            for n in names:
                p = os.path.join(root, n)
                rel = os.path.relpath(p, shared)
                if rel.startswith(os.path.join("topics", "deltas")) or \
                        ".bell" in rel:
                    continue
                with open(p, "rb") as f:
                    out[rel] = f.read()
    with open(os.path.join(shared, "checkpoints",
                           "summarizer.ckpt.json")) as f:
        out["checkpoint"] = json.load(f)
    return out


def _keys(shared, fmt="json"):
    return [(m["doc"], m["seq"], m["handle"]) for m in
            manifests_of(shared, fmt)]


# ---------------------------------------------------------- differential


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax-role")
    out = {}
    for name, (make, ops) in STREAMS.items():
        for fmt in ("json", "columnar"):
            shared = str(root / f"{name}-{fmt}")
            write_deltas(shared, make(), fmt, frame=50)
            _drain(_role("jax", shared, fmt, ops))
            out[(name, fmt)] = _files(shared)
    return out


@pytest.mark.parametrize("backend", ["kernel", "overlay"])
@pytest.mark.parametrize("fmt", ["json", "columnar"])
@pytest.mark.parametrize("name", list(STREAMS))
def test_role_matches_jax_role(jax_runs, tmp_path, name, fmt, backend):
    make, ops = STREAMS[name]
    shared = str(tmp_path)
    write_deltas(shared, make(), fmt, frame=50)
    role = _role("port", shared, fmt, ops, backend=backend)
    stacked0 = role._m_stacked.value
    _drain(role)
    got, want = _files(shared), jax_runs[(name, fmt)]
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == want[k], k
    mans = manifests_of(shared, fmt)
    assert len(mans) >= 3
    assert all(isinstance(m["byteOff"], int) for m in mans)
    assert {m["form"] for m in mans} == (
        {"ops"} if name == "ops" else {"mergetree"})
    if name == "stacked":
        assert role._m_stacked.value > stacked0
    assert not os.listdir(os.path.join(shared, "store", "pins"))


# ---------------------------------------------------------- recovery


@pytest.mark.parametrize("backend", ["kernel", "overlay"])
def test_restart_mid_stream_reemits_identical_summaries(tmp_path, backend):
    recs = build_mergetree_stream(200, n_clients=3, seed=9)
    ref = str(tmp_path / "ref")
    write_deltas(ref, recs, "json")
    drive_summarizer(ref, "json", 16, batch=512, device="cpu",
                     fold_backend=backend)
    cut = str(tmp_path / "cut")
    write_deltas(cut, recs, "json")
    _drain(_role("port", cut, "json", 16, owner="g1", backend=backend,
                 ttl=TTL), until=len(recs) // 2)
    time.sleep(TTL + 0.2)  # the dead owner's lease runs out
    second = _drain(_role("port", cut, "json", 16, owner="g2",
                          backend=backend, ttl=TTL))
    assert second.fence == 2
    assert _keys(cut) == _keys(ref) and len(_keys(ref)) == len(recs) // 16


def test_torn_manifest_append_reemitted(tmp_path):
    recs = build_mergetree_stream(150, n_clients=3, seed=13)
    shared = str(tmp_path)
    write_deltas(shared, recs, "json")
    _drain(_role("port", shared, "json", 16, owner="g1", ttl=TTL,
                 backend="overlay"))
    full = _keys(shared)
    path = os.path.join(shared, "topics", "summaries.jsonl")
    with open(path, "rb") as f:
        data = f.read()
    cut = data[:-1].rfind(b"\n") + 1
    with open(path, "wb") as f:
        f.write(data[:cut + 3])  # a torn, newline-less remnant
    assert _keys(shared) == full[:-1]
    os.remove(os.path.join(shared, "checkpoints", "summarizer.ckpt.json"))
    time.sleep(TTL + 0.2)
    _drain(_role("port", shared, "json", 16, owner="g2", ttl=TTL,
                 backend="overlay"))
    assert _keys(shared) == full


@pytest.mark.parametrize("backend", ["kernel", "overlay"])
def test_freeze_on_undecodable_op(tmp_path, backend):
    recs = build_mergetree_stream(90, n_clients=3, seed=21)
    bad_at = 40
    last = recs[bad_at - 1]
    poisoned = recs[:bad_at] + [
        {**last, "seq": last["seq"] + 1,
         "contents": {"type": 42, "weird": True}}] + [
        {**r, "seq": r["seq"] + 1} for r in recs[bad_at:]]
    shared = {p: str(tmp_path / p) for p in ("port", "jax")}
    for d in shared.values():
        write_deltas(d, poisoned, "json")
    run = drive_summarizer(shared["port"], "json", 16, device="cpu",
                           fold_backend=backend)
    jsum_role = jsum.SummarizerRole(shared["jax"], owner="j", ttl_s=3600.0,
                                    summary_ops=16, fold_backend="kernel")
    jsum_role.fence = 1
    reader = make_tail_reader(make_topic(os.path.join(
        shared["jax"], "topics", "deltas.jsonl"), "json"))
    out = []
    for li, rec in reader.poll():
        jsum_role.process(li, rec, out)
    jsum_role.flush_batch(out)
    mans = manifests_of(shared["port"], "json")
    assert mans and all(m["seq"] <= bad_at for m in mans)
    assert [(m["seq"], m["handle"]) for m in mans] == [
        (m["seq"], m["handle"]) for m in out]
    assert list(run["role"].frozen) == ["doc0"]
    blob = json.loads(open_summary_store(shared["port"]).get(
        mans[-1]["handle"]).decode())
    rep = SummaryReplica(blob, device="cpu")
    rep.apply_records([r for r in recs if mans[-1]["seq"] < r["seq"]
                       <= bad_at])
    cold = SummaryReplica(None, device="cpu")
    cold.apply_records(recs[:bad_at])
    assert rep.state_digest() == cold.state_digest()


def test_undecided_cadence_point_skipped(tmp_path):
    n_joins, n = 6, 4
    base, seq = [], 0
    for c in range(1, n_joins + 1):
        seq += 1
        base.append({"kind": "op", "doc": "j", "seq": seq, "msn": 0,
                     "client": c, "clientSeq": 0, "refSeq": seq - 1,
                     "type": "join", "contents": c})
    ops = []
    for i in range(1, 11):
        seq += 1
        ops.append({"kind": "op", "doc": "j", "seq": seq,
                    "msn": max(0, seq - 4), "client": 1, "clientSeq": i,
                    "refSeq": seq - 1, "type": "op", "contents": {"i": i}})
    records = base + ops
    for variant, batches in (("one_pump", [records]),
                             ("split_pump", [base, ops])):
        d = str(tmp_path / variant)
        write_deltas(d, records, "json")
        role = SummarizerRole(d, owner="t", ttl_s=3600.0, summary_ops=n,
                              device="cpu")
        role.fence = 1
        li = 0
        for chunk in batches:
            out = []
            for rec in chunk:
                role.process(li, rec, out)
                li += 1
            role.flush_batch(out)
            if out:
                role.out_topic.append_many(out, fence=1, owner="t")
        mans = manifests_of(d, "json")
        assert [m["count"] for m in mans] == [8, 12, 16], (variant, mans)
        store = open_summary_store(d)
        for m in mans:
            blob = json.loads(store.get(m["handle"]).decode())
            assert blob["form"] == "ops" and len(blob["records"]) == \
                m["count"]
        cu = read_catchup(d, "j", "json", store=store)
        boot = SummaryReplica(cu["blob"], device="cpu")
        boot.apply_records(cu["ops"])
        cold = SummaryReplica(None, device="cpu")
        cold.apply_records(records)
        assert boot.state_digest() == cold.state_digest()


# ---------------------------------------------------------- handover


@pytest.mark.parametrize("fmt", ["json", "columnar"])
@pytest.mark.parametrize("first", ["jax", "port"])
def test_handover_across_packages(tmp_path, first, fmt):
    recs = build_mergetree_stream(190, n_clients=3, seed=17)
    ref = str(tmp_path / "ref")
    write_deltas(ref, recs, fmt)
    _drain(_role("jax", ref, fmt, 30))
    shared = str(tmp_path / "handover")
    write_deltas(shared, recs, fmt)
    second = "port" if first == "jax" else "jax"
    _drain(_role(first, shared, fmt, 30, owner="a", ttl=TTL,
                 backend="overlay"), until=len(recs) // 3)
    time.sleep(TTL + 0.2)
    role = _drain(_role(second, shared, fmt, 30, owner="b", ttl=TTL,
                        backend="overlay"))
    assert role.fence == 2
    got = [(m["doc"], m["seq"], m["handle"], m["off"]) for m in
           manifests_of(shared, fmt)]
    want = [(m["doc"], m["seq"], m["handle"], m["off"]) for m in
            manifests_of(ref, fmt)]
    assert got == want and len(want) == len(recs) // 30
    assert _files(shared)["checkpoint"]["state"] == \
        _files(ref)["checkpoint"]["state"]


# ---------------------------------------------------------- raw submissions


@pytest.mark.parametrize("fmt", ["json", "columnar"])
def test_summaries_identical_across_deli_packages(tmp_path, fmt):
    """Raw merge-tree submissions through the port's kernel deli and
    summarizer, and through the JAX scalar deli and summarizer: the
    same manifests, handles included."""
    import random
    import string

    rng = random.Random(31)
    raws = [{"kind": "join", "doc": "x", "client": 1}]
    length = 0
    for i in range(60):
        if length == 0 or rng.random() < 0.6:
            pos = rng.randint(0, length)
            text = "".join(rng.choices(string.ascii_lowercase,
                                       k=rng.randint(1, 5)))
            contents = {"type": 0, "pos1": pos, "seg": text}
            length += len(text)
        else:
            a = rng.randint(0, length - 1)
            b = min(length, a + rng.randint(1, 4))
            contents = {"type": 1, "pos1": a, "pos2": b}
            length -= b - a
        raws.append({"kind": "op", "doc": "x", "client": 1,
                     "clientSeq": i + 1, "refSeq": i,
                     "contents": contents})
    got = {}
    for pkg in ("port", "jax"):
        d = str(tmp_path / pkg)
        os.makedirs(os.path.join(d, "topics"))
        make_topic(os.path.join(d, "topics", "rawdeltas.jsonl"),
                   fmt).append_many(raws)
        if pkg == "port":
            deli = KernelDeliRole(d, owner="d", ttl_s=3600.0,
                                  log_format=fmt, device="cpu")
        else:
            deli = JaxDeliRole(d, owner="d", ttl_s=3600.0, log_format=fmt)
        while deli.step():
            pass
        summ = _role(pkg, d, fmt, 16, backend="overlay")
        _drain(summ)
        got[pkg] = _keys(d, fmt)
    assert got["port"] == got["jax"] and len(got["port"]) == 61 // 16


# ---------------------------------------------------------- pins, metrics


def test_gc_pin_live_while_blobs_are_put(tmp_path):
    recs = build_mergetree_stream(100, n_clients=2, seed=2)
    shared = str(tmp_path)
    write_deltas(shared, recs, "json")
    role = _role("port", shared, "json", 25, backend="overlay")
    floors = []
    put = role.store.put

    def checked(payload):
        floors.append((tret.live_pin_floor(shared),
                       jsum_floor(shared)))
        return put(payload)

    role.store.put = checked
    _drain(role)
    assert len(floors) == len(recs) // 25
    assert all(a is not None and a == b for a, b in floors)
    assert tret.live_pin_floor(shared) is None  # cleared after the append


def jsum_floor(shared):
    from fluidframework_tpu.server.retention import live_pin_floor

    return live_pin_floor(shared)


def test_instruments_carry_the_reference_names(tmp_path):
    treg, jreg = tmetrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    prev_t, prev_j = tmetrics.set_registry(treg), jmetrics.set_registry(jreg)
    try:
        SummarizerRole(str(tmp_path / "p"), owner="p", device="cpu",
                       fold_backend="overlay")
        jsum.SummarizerRole(str(tmp_path / "j"), owner="j",
                            fold_backend="kernel").fold_backend()
    finally:
        tmetrics.set_registry(prev_t)
        jmetrics.set_registry(prev_j)

    def names(snap):
        return sorted({(kind, e["name"]) for kind in snap
                       for e in snap[kind]
                       if e["labels"].get("role") == "summarizer"})

    assert names(treg.snapshot()) == names(jreg.snapshot())
    counters = {e["name"]: e["value"] for e in treg.snapshot()["counters"]}
    assert counters["summary_fold_backend_fallbacks_total"] == 0
    assert counters["summary_plane_folds_total"] == 0
    gauges = [e for e in treg.snapshot()["gauges"]
              if e["name"] == "summary_fold_backend"]
    assert [g["labels"]["backend"] for g in gauges] == ["overlay"]


def test_partitioned_summarizer(tmp_path):
    recs = build_mergetree_stream(60, n_clients=2, seed=8, doc="p1doc")
    shared = str(tmp_path)
    os.makedirs(os.path.join(shared, "topics"))
    make_topic(os.path.join(shared, "topics", "deltas-p1.jsonl"),
               "json").append_many(recs)
    cls = partitioned_role_class(SummarizerRole, 1)
    role = cls(shared, owner="t", ttl_s=3600.0, summary_ops=20,
               device="cpu")
    assert (role.name, role.in_topic_name, role.out_topic_name) == (
        "summarizer-p1", "deltas-p1", "summaries-p1")
    _drain(role)
    idx = SummaryIndex(shared, partitions=2)
    assert idx.poll() == len(recs) // 20
    cu = read_catchup(shared, "p1doc", index=idx, deltas_topic="deltas-p1")
    boot = SummaryReplica(cu["blob"], device="cpu")
    boot.apply_records(cu["ops"])
    cold = SummaryReplica(None, device="cpu")
    cold.apply_records(recs)
    assert boot.state_digest() == cold.state_digest()
    assert cu["manifest"]["byteTopic"] == "deltas-p1"


# ---------------------------------------------------------- refusals


def test_refusals(tmp_path, monkeypatch):
    shared = str(tmp_path / "farm")
    for kw, match in (({"fold_backend": "pallas"}, "not in"),
                      ({"summary_ops": -1}, ">= 1")):
        with pytest.raises(ValueError, match=match):
            SummarizerRole(shared, owner="x", device="cpu", **kw)
    monkeypatch.setenv("FLUID_FOLD_BACKEND", "pallas")
    with pytest.raises(ValueError, match="FLUID_FOLD_BACKEND"):
        SummarizerRole(shared, owner="x", device="cpu")
    monkeypatch.delenv("FLUID_FOLD_BACKEND")
    with pytest.raises(TypeError):
        SummarizerRole(shared, owner="x", device="cpu", fold_interpret=True)
    # The device plane is taken now (tests/test_torch_summary_plane.py);
    # the reference's refusal of a plane for a role that has none stays.
    with pytest.raises(ValueError, match="device_plane"):
        tsup.serve_role(shared, "scriptorium", "x", device_plane="2x2",
                        device="cpu")
    for kw in ({"summary_ops": 8}, {"fold_backend": "kernel"}):
        with pytest.raises(ValueError, match="summarizer knob"):
            tsup.serve_role(shared, "deli", "x", device="cpu", **kw)
    for bad in (["--fold-backend", "pallas"], ["--summary-ops", "x"]):
        with pytest.raises(SystemExit):
            tsup.main(["--role", "summarizer", "--dir", shared] + bad)
    assert not os.path.exists(shared)  # refused before any file
    role = SummarizerRole(shared, owner="x", device="cpu")
    assert role.fold_backend() == "kernel" and role.summary_ops == 256
    monkeypatch.setenv("FLUID_SUMMARY_OPS", "12")
    monkeypatch.setenv("FLUID_FOLD_BACKEND", "overlay")
    role = SummarizerRole(shared, owner="y", device="cpu")
    assert (role.fold_backend(), role.summary_ops) == ("overlay", 12)
    monkeypatch.setenv(PLANE_ENV, "2y2")  # resolved at the first fold
    role = SummarizerRole(shared, owner="z", device="cpu")
    with pytest.raises(ValueError, match="DOCSxMODEL"):
        role.device_plane()


def test_restore_unwraps_the_old_checkpoint_shape(tmp_path):
    role = SummarizerRole(str(tmp_path), owner="x", device="cpu")
    fold = {"seq": 3, "msn": 1, "count": 3, "engine": "ops",
            "window": [], "records": [], "base": 0, "base_msn": 0,
            "rows": [], "last": None}
    role.restore_state({"docs": {"a": fold}})
    assert role.snapshot_state() == {"a": fold}
    role.restore_state({"a": fold})
    assert role.snapshot_state() == {"a": fold}
    role.restore_state(None)
    assert role.snapshot_state() == {}
