"""The port's supervised deli (`KernelDeliRole(device="cpu")`) against
the JAX package's `KernelDeliRole` and scalar `DeliRole`, exactly.

The reference's role tests (tests/test_deli_kernel.py: the
resubmission differential, the recovery gap replay, boxcar wire
records, columnar ingest, the partially durable boxcar recovery), each
held three ways; then snapshots restored across the packages both
ways, a crash of one package's role taken over by the other's over one
shared directory (JSON and columnar topics), the first pump of
BASELINE config 5, both ingest plans (`_plan_op_run` on long op runs,
the per-record plan on short ones), the role's refusals, and the
port's `main` as a child process SIGKILLed mid-stream and taken over by
a second one. Records are compared without the nack ``reason`` (its
text is for humans), as the reference's tests do.
"""

import os
import signal
import subprocess
import sys
import time

import pytest
import torch

from fluidframework_tpu.server.deli_kernel import (
    KernelDeliRole as JaxKernelRole,
)
from fluidframework_tpu.server.supervisor import DeliRole
from fluidframework_tpu_torch.server import supervisor as tsup
from fluidframework_tpu_torch.server.columnar_log import make_topic
from fluidframework_tpu_torch.server.deli_kernel import KernelDeliRole
from fluidframework_tpu_torch.server.queue import SharedFileTopic
from fluidframework_tpu_torch.testing.deli_streams import (
    build_pipeline_workload,
    canonical_role_record as strip_reason,
    gen_boxcar_wire,
    gen_wire_traffic,
    write_raw_topic,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(shared, owner="t", **kw):
    return KernelDeliRole(shared, owner=owner, ttl_s=3600.0, device="cpu",
                          **kw)


def _jax(shared, owner="j", **kw):
    return JaxKernelRole(shared, owner=owner, ttl_s=3600.0, **kw)


def _scalar(shared, owner="s", **kw):
    return DeliRole(shared, owner=owner, ttl_s=3600.0, **kw)


def _oracle(tmp_path, recs):
    """The scalar role's output over `recs` in one batch."""
    s = _scalar(str(tmp_path / "oracle"), owner="o")
    out = []
    for i, r in enumerate(recs):
        s.process(i, r, out)
    s.flush_batch(out)
    return [strip_reason(r) for r in out]


def _feed(role, recs, every):
    """`process` every record, flushing every `every` records."""
    out = []
    for i, r in enumerate(recs):
        role.process(i, r, out)
        if i % every == every - 1:
            role.flush_batch(out)
    role.flush_batch(out)
    return out


def _drain(role, limit=10_000):
    for _ in range(limit):
        if not role.step():
            return
    raise AssertionError("the role did not drain its input")


def _snap_view(snap):
    return {d: (s["seq"], s["min_seq"],
                {str(c): (v["ref_seq"], v["client_seq"])
                 for c, v in s["clients"].items()})
            for d, s in snap.items()}


def _deltas(shared, fmt):
    return [strip_reason(r) for r in make_topic(
        os.path.join(shared, "topics", "deltas.jsonl"), fmt).read_from(0)]


# ---------------------------------------------------------------------------
# the reference's role tests, three ways
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 5])
def test_role_differential_with_resubmissions(seed, tmp_path):
    recs = gen_wire_traffic(seed)
    want = _oracle(tmp_path, recs)
    port = _port(str(tmp_path / "t"))
    got = _feed(port, recs, 23)  # many micro-batches
    jax = _jax(str(tmp_path / "j"))
    assert [strip_reason(r) for r in got] == want
    assert [strip_reason(r) for r in _feed(jax, recs, 23)] == want
    # inOff bookkeeping (the exactly-once recovery key) is per record
    assert all("inOff" in r for r in got)
    scalar = _scalar(str(tmp_path / "s"))
    _feed(scalar, recs, len(recs))
    s1, s2, s3 = (scalar.snapshot_state(), port.snapshot_state(),
                  jax.snapshot_state())
    assert _snap_view(s1) == _snap_view(s2) == _snap_view(s3)


@pytest.mark.parametrize("impl", ["port", "jax"])
def test_role_recovery_gap_replay(impl, tmp_path):
    """The exactly-once crash window: outputs durable past the
    checkpoint must not re-stamp after a restart."""
    shared = str(tmp_path)
    recs = gen_wire_traffic(7, docs=2, clients=2, ops=8)
    SharedFileTopic(str(tmp_path / "topics" / "rawdeltas.jsonl")
                    ).append_many(recs)
    make = _port if impl == "port" else _jax
    role = make(shared, owner="k1", batch=16)
    for _ in range(3):  # the first step acquires the lease and recovers
        role.step()
    deltas = SharedFileTopic(str(tmp_path / "topics" / "deltas.jsonl"))
    assert deltas.read_from(0), "no durable outputs before the crash?"
    role.leases.release("deli")  # the "crashed" owner's lease lapses
    role2 = make(shared, owner="k2", batch=16)
    _drain(role2)
    got = [strip_reason(r) for r in deltas.read_from(0)
           if isinstance(r, dict) and r.get("kind") in ("op", "nack")]
    assert got == _oracle(tmp_path, recs)


@pytest.mark.parametrize("seed", [0, 3])
def test_boxcar_wire_records_scalar_vs_kernel(seed, tmp_path):
    recs = gen_boxcar_wire(seed)
    want = _oracle(tmp_path, recs)
    assert [strip_reason(r) for r in
            _feed(_port(str(tmp_path / "t")), recs, 11)] == want
    assert [strip_reason(r) for r in
            _feed(_jax(str(tmp_path / "j")), recs, 11)] == want
    assert any(r["kind"] == "nack" for r in want), "no boxcar aborts hit"


@pytest.mark.parametrize("seed", [0, 5])
def test_columnar_ingest_matches_json_roles(seed, tmp_path):
    """Whole RecordBatch frames over a columnar topic (blob
    pass-through, columnar emission) give the scalar role's stream:
    boxcars, resubmissions, junk records and unknown clients; the
    short op runs take the per-record plan."""
    recs = gen_wire_traffic(seed, ops=8) + gen_boxcar_wire(seed + 1)
    want = _oracle(tmp_path, recs)
    outs = {}
    for name, make in (("port", _port), ("jax", _jax)):
        shared = str(tmp_path / name)
        raw = make_topic(os.path.join(shared, "topics", "rawdeltas.jsonl"),
                         "columnar")
        for lo in range(0, len(recs), 13):  # many frames per step
            raw.append_many(recs[lo:lo + 13])
        role = make(shared, batch=29, log_format="columnar")
        _drain(role)
        outs[name] = _deltas(shared, "columnar")
        if name == "port":
            assert role.planned == {"run": 0, "record": len(recs)}
    assert outs["port"] == outs["jax"] == want


@pytest.mark.parametrize("impl", ["port", "jax", "scalar"])
def test_recovery_completes_partially_durable_boxcar_outputs(impl,
                                                             tmp_path):
    """A wire boxcar emits several outputs for one input offset; a crash
    mid-append can leave only a durable prefix of them. Recovery
    re-emits exactly the missing tail: no duplicates, no skipped seqs."""
    shared = str(tmp_path)
    recs = [
        {"kind": "join", "doc": "d", "client": 1},
        {"kind": "boxcar", "doc": "d", "client": 1, "ops": [
            {"clientSeq": i + 1, "refSeq": 0, "contents": {"i": i}}
            for i in range(4)
        ]},
        {"kind": "op", "doc": "d", "client": 1, "clientSeq": 5,
         "refSeq": 0, "contents": {"i": 99}},
    ]
    raw = SharedFileTopic(str(tmp_path / "topics" / "rawdeltas.jsonl"))
    raw.append_many(recs[:2])
    make = {"port": _port, "jax": _jax, "scalar": _scalar}[impl]
    r1 = make(shared, owner="g1", batch=16)
    _drain(r1)
    deltas = SharedFileTopic(str(tmp_path / "topics" / "deltas.jsonl"))
    assert len(deltas.read_from(0)) == 5  # join + 4 boxcar ops
    # The crash: the topic clipped to a prefix of the boxcar's outputs
    # (join + 2 of its 4 ops durable), the checkpoint before them.
    with open(deltas.path, "rb") as f:
        lines = f.read().splitlines(keepends=True)
    with open(deltas.path, "wb") as f:
        f.write(b"".join(lines[:3]))
    r1.ckpt.save("deli", {"offset": 0, "state": None}, fence=r1.fence,
                 owner=r1.owner)
    r1.leases.release("deli")
    raw.append_many(recs[2:])  # more traffic after the crash
    # the successor is always the port's role
    r2 = _port(shared, owner="g2", batch=16)
    _drain(r2)
    got = [strip_reason(r) for r in deltas.read_from(0)]
    assert got == _oracle(tmp_path, recs)
    assert [r["seq"] for r in got] == list(range(1, 7))


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("other", ["jax", "scalar"])
@pytest.mark.parametrize("direction", ["port_to_other", "other_to_port"])
def test_snapshot_restores_across_packages(other, direction, tmp_path):
    """Half the stream through one role, its snapshot restored into the
    other package's role, the rest through that one: the continued
    stream equals the scalar oracle's, and so do the final snapshots."""
    recs = gen_wire_traffic(11, ops=10) + gen_boxcar_wire(12)
    want = _oracle(tmp_path, recs)
    half = len(recs) // 2
    make_other = _jax if other == "jax" else _scalar
    if direction == "port_to_other":
        first, second = _port(str(tmp_path / "a")), \
            make_other(str(tmp_path / "b"))
    else:
        first, second = make_other(str(tmp_path / "a")), \
            _port(str(tmp_path / "b"))
    out = []
    for i, r in enumerate(recs[:half]):
        first.process(i, r, out)
    first.flush_batch(out)
    second.restore_state(first.snapshot_state())
    for i, r in enumerate(recs[half:], start=half):
        second.process(i, r, out)
    second.flush_batch(out)
    assert [strip_reason(r) for r in out] == want
    whole = _scalar(str(tmp_path / "c"))
    _feed(whole, recs, len(recs))
    assert _snap_view(second.snapshot_state()) == \
        _snap_view(whole.snapshot_state())


@pytest.mark.parametrize("ckpt", [0.0, 3600.0])
@pytest.mark.parametrize("fmt", ["json", "columnar"])
@pytest.mark.parametrize("first", ["jax", "port"])
def test_handover_across_packages(first, fmt, ckpt, tmp_path):
    """One package's role "crashes" after 3 steps over a shared
    directory (lease released); the other package's role takes the
    lease, recovers from the same lease, checkpoint and topic files,
    and finishes. With `ckpt` 0 the first role checkpointed every step
    (the successor restores its checkpoint); with 3600 it never did
    (the successor replays the gap silently). The deltas equal the
    scalar oracle's, each seq once."""
    shared = str(tmp_path / "farm")
    recs = gen_wire_traffic(21, docs=3, clients=3, ops=12) + \
        gen_boxcar_wire(22)
    write_raw_topic(shared, recs, 17, fmt)
    mk1, mk2 = (_jax, _port) if first == "jax" else (_port, _jax)
    r1 = mk1(shared, owner="g1", batch=20, log_format=fmt,
             ckpt_interval_s=ckpt)
    for _ in range(3):
        r1.step()
    assert (r1.ckpt.load("deli") is not None) == (ckpt == 0.0)
    assert _deltas(shared, fmt), "no durable outputs before the crash"
    r1.leases.release("deli")
    r2 = mk2(shared, owner="g2", batch=20, log_format=fmt)
    _drain(r2)
    assert r2.fence > r1.fence
    got = _deltas(shared, fmt)
    assert got == _oracle(tmp_path, recs)
    assert len({(r["doc"], r["seq"]) for r in got if r["kind"] == "op"}) \
        == sum(r["kind"] == "op" for r in got)


def test_config5_first_pump_matches_scalar(tmp_path):
    """The first pump of BASELINE config 5 (16,384 records of 10,000
    documents x 64 clients, each client's join right before its op):
    one frame through the port's role on a columnar topic equals the
    JAX scalar role's output. Every op run is 1 long, so every record
    takes the per-record plan."""
    recs = build_pipeline_workload(10_000, 64, 1, seed=5, limit=16384)
    outs = {}
    for name in ("port", "scalar"):
        shared = str(tmp_path / name)
        write_raw_topic(shared, recs, 16384, "columnar")
        role = (_port if name == "port" else _scalar)(
            shared, batch=16384, log_format="columnar")
        _drain(role)
        outs[name] = _deltas(shared, "columnar")
        if name == "port":
            assert role.planned == {"run": 0, "record": 16384}
            assert role.core.pool.chunks == 1
    assert len(outs["port"]) == 16384
    assert outs["port"] == outs["scalar"]


@pytest.mark.parametrize("fmt", ["json", "columnar"])
def test_long_op_runs_take_plan_op_run(fmt, tmp_path):
    """Joins first, then long runs of plain ops with resubmissions and a
    few nacks (clientSeq gaps, an unknown client, a future refSeq)
    inside them: over a columnar topic `_plan_op_run` takes the runs
    and `_emit_run` splits accepted spans around the nacked records."""
    recs = gen_wire_traffic(31, docs=4, clients=4, ops=30)
    ops = [i for i, r in enumerate(recs) if r.get("kind") == "op"]
    for k, i in enumerate(ops[40:160:23]):
        bad = dict(recs[i])
        if k % 3 == 0:
            bad["clientSeq"] += 5
        elif k % 3 == 1:
            bad["client"] = 99
        else:
            bad["refSeq"] = 10_000
        recs.insert(i + 1, bad)
    want = _oracle(tmp_path, recs)
    assert sum(r["kind"] == "nack" for r in want) >= 4
    shared = str(tmp_path / "t")
    write_raw_topic(shared, recs, 256, fmt)
    role = _port(shared, batch=1024, log_format=fmt)
    _drain(role)
    assert _deltas(shared, fmt) == want
    if fmt == "columnar":
        assert role.planned["run"] > 300
    else:  # JSON records one by one; `process` drops the junk record
        assert role.planned == {"run": 0, "record": len(recs) - 1}
    jshared = str(tmp_path / "j")
    write_raw_topic(jshared, recs, 256, fmt)
    _drain(_jax(jshared, batch=1024, log_format=fmt))
    assert _deltas(jshared, fmt) == want


def test_role_refusals(tmp_path):
    """A mesh that is not a `DocsMesh`, ``deli_devices`` with a
    ``device_plane`` (in process and through the supervisor's device
    seams), a plane for the scalar deli and the roles the port does not
    serve raise ValueError (the last naming the ROADMAP.md item), before
    any file is made."""
    for kw, match in (({"mesh": object()}, "DocsMesh"),
                      ({"deli_devices": 2, "device_plane": "2x2"},
                       "exclusive")):
        with pytest.raises(ValueError, match=match):
            KernelDeliRole(str(tmp_path), owner="x", device="cpu", **kw)
    for role, impl in (("retention", "kernel"), ("scribe", "kernel"),
                       ("deli", "scalar")):
        with pytest.raises(ValueError, match="Queue 1 item 4"):
            tsup.serve_role(str(tmp_path), role, "x", deli_impl=impl,
                            device="cpu")
    with pytest.raises(ValueError, match="exclusive"):
        tsup.main(["--role", "deli", "--impl", "kernel", "--dir",
                   str(tmp_path), "--device", "cpu", "--deli-devices", "2",
                   "--device-plane", "2x2"])
    with pytest.raises(ValueError, match="device_plane"):
        tsup.serve_role(str(tmp_path), "deli", "x", deli_impl="scalar",
                        device_plane="2x2", device="cpu")
    with pytest.raises(SystemExit):
        tsup.main(["--role", "deli", "--dir", str(tmp_path),
                   "--log-format", "parquet"])
    assert not os.path.exists(tmp_path / "hb")  # refused before any file


# ---------------------------------------------------------------------------
# the child-process entry under SIGKILL
# ---------------------------------------------------------------------------


def _spawn(shared, owner, log):
    code = ("import sys; sys.path.insert(0, %r); "
            "from fluidframework_tpu_torch.server.supervisor import main; "
            "main()" % ROOT)
    return subprocess.Popen(
        [sys.executable, "-c", code, "--role", "deli", "--impl", "kernel",
         "--dir", shared, "--owner", owner, "--device", "cpu",
         "--log-format", "columnar", "--ttl", "1.0", "--batch", "8",
         "--ckpt-interval", "0.05"],
        stdout=log, stderr=subprocess.STDOUT, cwd=ROOT,
        env=dict(os.environ, OMP_NUM_THREADS="1"),
    )


def test_main_sigkilled_then_taken_over(tmp_path):
    """The port's `main` as a supervised child: SIGKILL it once outputs
    are durable, append more traffic, start a new owner; it waits out
    the lease TTL, recovers and finishes. The deltas equal the oracle's,
    with no duplicate or skipped seq. The test has its own deadline."""
    deadline = time.monotonic() + 120.0
    shared = str(tmp_path / "farm")
    recs = gen_wire_traffic(41, docs=4, clients=3, ops=25) + \
        gen_boxcar_wire(42, ops=8)
    cut = len(recs) // 2
    raw = write_raw_topic(shared, recs[:cut], 8, "columnar")
    want = _oracle(tmp_path, recs)
    deltas_path = os.path.join(shared, "topics", "deltas.jsonl")
    procs = []
    try:
        with open(tmp_path / "child.log", "w") as log:
            p1 = _spawn(shared, "g1", log)
            procs.append(p1)
            while not (os.path.exists(deltas_path)
                       and _deltas(shared, "columnar")):
                assert p1.poll() is None, open(tmp_path / "child.log").read()
                assert time.monotonic() < deadline, "no durable outputs"
                time.sleep(0.02)
            p1.send_signal(signal.SIGKILL)
            p1.wait(timeout=30)
            killed_at = len(_deltas(shared, "columnar"))
            make_topic(raw, "columnar").append_many(recs[cut:])
            p2 = _spawn(shared, "g2", log)
            procs.append(p2)
            while len(_deltas(shared, "columnar")) < len(want):
                assert p2.poll() is None, open(tmp_path / "child.log").read()
                assert time.monotonic() < deadline, (
                    f"the successor did not finish: "
                    f"{len(_deltas(shared, 'columnar'))} of {len(want)}")
                time.sleep(0.05)
            time.sleep(0.3)  # a duplicate append would land by now
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    got = _deltas(shared, "columnar")
    assert killed_at > 0
    assert got == want
    for doc in {r["doc"] for r in got}:
        seqs = [r["seq"] for r in got if r["doc"] == doc and
                r["kind"] == "op"]
        assert seqs == list(range(1, len(seqs) + 1))
    log_text = open(tmp_path / "child.log").read()
    assert "READY deli g1" in log_text and "READY deli g2" in log_text


# ---------------------------------------------------------------------------
# instruments
# ---------------------------------------------------------------------------


def test_pool_and_role_instruments_match_the_reference(tmp_path):
    """The deli's instruments count the same events in both packages:
    the pool's grows, evictions by policy, cold residents and column
    reclaims, the core's nacks and dedup skips, the role's records and
    checkpoint writes, over the same traffic (a resident budget that
    forces evictions, client churn, boxcar aborts, resubmissions)."""
    from fluidframework_tpu.server.deli_kernel import (
        KernelDeliLambda as JaxLambda,
    )
    from fluidframework_tpu.server.log import MessageLog as JaxLog
    from fluidframework_tpu.utils import metrics as jm
    from fluidframework_tpu_torch.server.deli_kernel import KernelDeliLambda
    from fluidframework_tpu_torch.server.log import MessageLog
    from fluidframework_tpu_torch.testing.deli_streams import (
        churn_raws,
        gen_raw_traffic,
    )
    from fluidframework_tpu_torch.utils import metrics as tm

    names = ("deli_pool_grows_total", "deli_pool_evictions_total",
             "deli_pool_evictions_by_policy_total",
             "deli_pool_col_reclaims_total", "deli_pool_compactions_total",
             "deli_pool_cold_resident_docs", "deli_pool_resident_docs",
             "deli_pool_doc_slots", "deli_pool_client_cols",
             "deli_nacks_total", "deli_dedup_skips_total",
             "deli_pump_records", "role_records_total",
             "role_pump_records")

    def run(pkg_metrics, make_lambda, make_log, make_role):
        reg = pkg_metrics.MetricsRegistry()
        prev = pkg_metrics.set_registry(reg)
        try:
            for recs in (gen_raw_traffic(3, n=500, docs=9),
                         churn_raws(3, 40, seed=1)):
                log = make_log()
                log.topic("rawdeltas").append_many(recs)
                deli = make_lambda(log)
                while deli.pump():
                    pass
                deli.checkpoint()
            shared = str(tmp_path / pkg_metrics.__name__)
            wire = gen_wire_traffic(2, docs=4, ops=10) + gen_boxcar_wire(4)
            write_raw_topic(shared, wire, 16, "columnar")
            _drain(make_role(shared))
            snap = reg.snapshot()
        finally:
            pkg_metrics.set_registry(prev)
        out = {}
        for kind, items in snap.items():
            for m in items:
                if m["name"] in names:
                    key = (kind, m["name"],
                           tuple(sorted(m["labels"].items())))
                    out[key] = m.get("value", m.get("counts"))
        return out

    kw = dict(max_pump=5, max_cols=8, n_docs=4, max_resident=4)
    got = run(tm, lambda log: KernelDeliLambda(log, device="cpu", **kw),
              MessageLog, lambda d: _port(d, batch=32,
                                          log_format="columnar"))
    want = run(jm, lambda log: JaxLambda(log, **kw), JaxLog,
               lambda d: _jax(d, batch=32, log_format="columnar"))
    assert got == want
    policies = {dict(k[2]).get("policy"): v for k, v in got.items()
                if k[1] == "deli_pool_evictions_by_policy_total"}
    assert policies["msn_cold"] + policies["lru"] == \
        got[("counters", "deli_pool_evictions_total", ())] > 0
    assert got[("counters", "deli_nacks_total", (("impl", "kernel"),))] > 0
    assert got[("counters", "deli_dedup_skips_total",
                (("impl", "kernel"),))] > 0
    assert got[("counters", "deli_pool_col_reclaims_total", ())] > 0
