"""Differential tests: the port's row-model scan vs the JAX package's.

The same int32 inputs go through the JAX scan (`apply_op_batch_jit`,
`apply_op_batch_docs_jit`) and the port's plain PyTorch version
(`apply_op_batch_ref`, `apply_op_batch_docs_ref`) on the CPU. Tolerance
0: everything is int32. Results are compared on ``n_rows``, ``error``
and rows ``[:min(n_rows, C)]`` (rows above are scratch; ``n_rows`` may
pass C once ``ERR_CAPACITY`` is set, as in the reference):

- the batches the JAX `KernelReplica` builds on the farm cases of
  tests/test_kernel_vs_oracle.py, each held against the JAX output it
  produced;
- config15 fold chunks (3000-op streams from 4 clients, chunks of 128,
  KR 4, KK 8, PK 4) at C 512, 1024 and 2048, from an empty table and
  from a document booted at a later round;
- D = 4 stacked tables with different n_rows through the docs form;
- the edge chunks of `testing/scan_edges.py` at C 64, 1024 and 16384
  (the kernel's global layout), and what each of them is named for;
- the kernel's block geometry and layouts (no capacity ceiling; only
  a chunk's ops that do not fit in shared memory raise), and the
  stacked `interop` converters both ways.
"""

import jax
import numpy as np
import pytest
import torch

import fluidframework_tpu.core.kernel_replica as jkr
from fluidframework_tpu.ops import mergetree_kernel as jmk
from fluidframework_tpu.server import summarizer as jsumm
from fluidframework_tpu.testing.deli_bench import build_mergetree_stream
from fluidframework_tpu.testing.farm import FarmConfig, run_sharedstring_farm
from fluidframework_tpu_torch import interop
from fluidframework_tpu_torch.ops import mergetree_kernel as tmk
from fluidframework_tpu_torch.ops.mergetree_scan import (
    SMEM_OPTIN,
    scan_geometry,
)
from fluidframework_tpu_torch.testing.scan_edges import scan_edge_chunks

COLS = ("buf_start", "length", "ins_seq", "ins_client", "rem_seq",
        "rem_clients", "props")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _jax_apply(table, ops, docs=False):
    """The JAX scan on copies of numpy inputs (it donates its table)."""
    fn = jmk.apply_op_batch_docs_jit if docs else jmk.apply_op_batch_jit
    jt = jmk.SegmentTable(**{k: np.array(v) for k, v in dict(table).items()})
    jo = jmk.OpBatch(**{k: np.array(v) for k, v in dict(ops).items()})
    return _np(fn(jt, jo))


def _port_apply(table, ops, docs=False):
    fn = tmk.apply_op_batch_docs_ref if docs else tmk.apply_op_batch_ref
    return fn(interop.segment_table_from_numpy(dict(table), "cpu"),
              interop.opbatch_from_numpy(dict(ops), "cpu"))


def _host(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _assert_same(got, want, label=""):
    n = int(want.n_rows)
    assert int(got.n_rows) == n, label
    assert int(got.error) == int(want.error), label
    m = min(n, np.shape(want.length)[-1])
    for f in COLS:
        assert np.array_equal(_host(getattr(got, f))[:m],
                              _host(getattr(want, f))[:m]), (label, f)


# ----------------------------------------------------------------------
# the KernelReplica batches of tests/test_kernel_vs_oracle.py

FARM_CASES = {
    **{f"small{s}": (FarmConfig(num_clients=3, rounds=8,
                                ops_per_client_per_round=3, seed=s),
                     dict(chunk_size=16, capacity=256))
       for s in range(6)},
    **{f"more_clients{s}": (FarmConfig(num_clients=8, rounds=6,
                                       ops_per_client_per_round=4,
                                       seed=500 + s),
                            dict(chunk_size=64, capacity=512, n_removers=8))
       for s in range(3)},
    "insert_heavy": (FarmConfig(num_clients=4, rounds=10,
                                ops_per_client_per_round=5, seed=11,
                                insert_weight=0.85, remove_weight=0.1,
                                annotate_weight=0.05, initial_text=""),
                     dict(chunk_size=32, capacity=512)),
    "remove_heavy": (FarmConfig(
        num_clients=4, rounds=10, ops_per_client_per_round=4, seed=12,
        insert_weight=0.35, remove_weight=0.55, annotate_weight=0.1,
        initial_text="the quick brown fox jumps over the lazy dog"),
        dict(chunk_size=32, capacity=512)),
    "tiny_chunks": (FarmConfig(num_clients=3, rounds=4,
                               ops_per_client_per_round=2, seed=3),
                    dict(chunk_size=1, capacity=256)),
    "compaction": (FarmConfig(num_clients=4, rounds=12,
                              ops_per_client_per_round=4, seed=77),
                   dict(chunk_size=16, capacity=128, compact_watermark=0.3)),
}


@pytest.mark.parametrize("name", sorted(FARM_CASES))
def test_scan_matches_jax_on_replica_batches(name, monkeypatch):
    cfg, kw = FARM_CASES[name]
    pairs = []
    real = jkr.apply_op_batch_jit

    def record(table, batch):
        tn, bn = _np(table), _np(batch)
        out = real(table, batch)
        pairs.append((tn, bn, _np(out)))
        return out

    monkeypatch.setattr(jkr, "apply_op_batch_jit", record)
    farm = run_sharedstring_farm(cfg)
    rep = jkr.KernelReplica(initial=cfg.initial_text, **kw)
    rep.apply_messages(farm.stream)
    assert rep.get_text() == farm.final_text and pairs
    for k, (tn, bn, want) in enumerate(pairs):
        _assert_same(_port_apply(tn._asdict(), bn._asdict()), want,
                     f"{name} batch {k}")


# ----------------------------------------------------------------------
# config15 fold chunks

FOLD_OPS, FOLD_CLIENTS, FOLD_STEP = 3000, 4, 375


def _fold_rep(seed: int, rnd: int):
    """The JAX kernel backend's replica of a config15 document booted
    from its canonical rows after `rnd` rounds, with round `rnd`'s
    records encoded (not yet applied)."""
    recs = build_mergetree_stream(FOLD_OPS, n_clients=FOLD_CLIENTS,
                                  seed=seed)
    rows, msn = [], 0
    for r in range(rnd + 1):
        rep = jsumm._boot_mergetree(rows, msn)
        take = recs[r * FOLD_STEP:(r + 1) * FOLD_STEP]
        jsumm._encode_fold(rep, take)
        msn = max(msn, max(x["msn"] for x in take))
        if r == rnd:
            return rep
        jsumm._fold_jobs([(rep, take)])
        rows = jsumm._canonical_rows(rep, msn)


@pytest.mark.parametrize("capacity,rnd", [(512, 0), (1024, 0), (2048, 0),
                                          (1024, 3), (2048, 6)])
def test_scan_matches_jax_on_fold_chunks(capacity, rnd):
    rep = _fold_rep(40 + rnd, rnd)
    assert rep.capacity <= capacity
    table = _np(jmk.grow_table(rep.table, rep.capacity, capacity))
    for k in range(3):
        batch = _np(rep._build_batch(rep._encoded[k * 128:(k + 1) * 128]))
        want = _jax_apply(table._asdict(), batch._asdict())
        _assert_same(_port_apply(table._asdict(), batch._asdict()), want,
                     f"C {capacity} round {rnd} chunk {k}")
        assert int(want.error) == 0
        table = want


def test_scan_docs_form_matches_jax_on_four_documents():
    reps = [_fold_rep(40 + d, d) for d in range(4)]
    C = 2048
    tables = [_np(jmk.grow_table(r.table, r.capacity, C)) for r in reps]
    assert len({int(t.n_rows) for t in tables}) == 4
    stack = lambda *xs: np.stack(xs)  # noqa: E731
    for k in range(2):
        batches = [_np(r._build_batch(r._encoded[k * 128:(k + 1) * 128]))
                   for r in reps]
        st = jax.tree_util.tree_map(stack, *tables)
        sb = jax.tree_util.tree_map(stack, *batches)
        want = _jax_apply(st._asdict(), sb._asdict(), docs=True)
        got = _port_apply(st._asdict(), sb._asdict(), docs=True)
        for d in range(4):
            wd = jax.tree_util.tree_map(lambda a, d=d: a[d], want)
            _assert_same(got.doc(d), wd, f"chunk {k} doc {d}")
            _assert_same(_port_apply(tables[d]._asdict(),
                                     batches[d]._asdict()), wd,
                         f"chunk {k} doc {d} alone")
        tables = [jax.tree_util.tree_map(lambda a, d=d: a[d], want)
                  for d in range(4)]


# ----------------------------------------------------------------------
# edge chunks

EDGE_GEOMETRIES = ((64, 4, 8, 4, 16), (1024, 4, 8, 4, 16),
                   (16384, 4, 8, 4, 16))


@pytest.mark.parametrize("C,KR,KK,PK,B", EDGE_GEOMETRIES)
def test_scan_matches_jax_on_edge_chunks(C, KR, KK, PK, B):
    cases = scan_edge_chunks(C, KR, KK, PK, B)
    flags = 0
    for case in cases:
        want = _jax_apply(case["table"], case["ops"])
        _assert_same(_port_apply(case["table"], case["ops"]), want,
                     case["label"])
        flags |= int(want.error)
    assert flags == tmk.ERR_CAPACITY | tmk.ERR_BAD_POS | tmk.ERR_REMOVERS


def test_scan_edge_chunks_hold_their_semantics():
    """What the edge chunks show, read from the JAX scan: a full table
    grows n_rows past C and flags ERR_CAPACITY, a NOOP chunk leaves a
    table alone (but flags one already past C), repeated insert keys
    keep the last slot and a negative key counts from the end once; an
    insert inside a row lands between its head and its tail; a range op
    inside one row or across two covers exactly the pieces between its
    cuts, none with pos2 below pos1, and no row of zero visibility or
    tombstone; inserts land at 0 and at the visible total; the tables
    near C and the live-row cases grow as their ops open rows."""
    C = 64
    cases = {c["label"]: c for c in scan_edge_chunks(C, 4, 8, 4, 16)}
    out = {k: _jax_apply(c["table"], c["ops"]) for k, c in cases.items()}
    assert int(out["full table: insert at the end"].n_rows) == 65
    assert int(out["full table: split of the last row"].n_rows) == 66
    assert int(out["full table: insert at the end"].error) == tmk.ERR_CAPACITY
    noop = cases["all-NOOP padding"]
    _assert_same(out["all-NOOP padding"], _np(jmk.SegmentTable(
        **noop["table"])), "noop")
    past = out["n_rows past the capacity, error 0: NOOP chunk"]
    assert int(past.error) == tmk.ERR_CAPACITY and int(past.n_rows) == 67
    keys = out["repeated, negative and out-of-range keys on inserts"]
    rows = {int(s): keys.props[i].tolist()
            for i, s in enumerate(keys.ins_seq[:int(keys.n_rows)])}
    assert rows[74] == [-1, 6, -1, 8, -1, -1, -1, -1]
    assert rows[75] == [-1, -1, 9, -1, -1, -1, -1, -1]
    assert rows[76] == [4, -1, -1, -1, -1, 1, -1, 3]
    assert rows[77] == [4, -1, -1, -1, -1, -1, -1, -1]
    assert int(out["a remover row with no free slot"].error) == \
        tmk.ERR_REMOVERS

    def live(label):
        t = out[label]
        n = int(t.n_rows)
        return n, {f: np.asarray(getattr(t, f))[:n] for f in COLS}

    removed = int(jmk.NOT_REMOVED)
    # The first insert splits row 1 (2..3) at 3: head, new row, tail.
    n, t = live("an insert strictly inside a row")
    assert n == 16 and t["ins_seq"][:4].tolist() == [1, 2, 74, 2]
    assert t["length"][1:4].tolist() == [1, 3, 1] and t["buf_start"][3] == 3
    # Rows of 6: the annotate cuts row 3 at 19 and 22, the remove row 1
    # at 7 and 10; only the middle pieces are touched.
    n, t = live("a remove and an annotate inside one row")
    assert n == 12 and (t["rem_seq"] != removed).nonzero()[0].tolist() == [2]
    assert t["buf_start"][2] == 7 and t["length"][1:4].tolist() == [1, 3, 2]
    assert (t["props"][:, 0] == 5).nonzero()[0].tolist() == [6]
    assert t["length"][5:8].tolist() == [1, 3, 2]
    n, t = live("a remove and an annotate across adjacent rows")
    assert n == 12 and (t["rem_seq"] == 75).nonzero()[0].tolist() == [2, 3]
    assert t["buf_start"][2:4].tolist() == [9, 12]
    assert (t["props"][:, 1] == 6).nonzero()[0].tolist() == [8, 9]
    n, t = live("range ops with pos2 below pos1")
    assert n == 12 and (t["rem_seq"] == removed).all()
    assert (t["props"] == -1).all() and int(t["length"].sum()) == 48
    n, t = live("a range op across rows of zero visibility and tombstones")
    hidden = np.isin(t["ins_seq"], (100, 101))
    assert hidden.sum() == 2 and (t["rem_seq"][hidden] == removed).all()
    assert (t["props"][hidden] == -1).all()
    assert (t["rem_seq"] == 20).sum() == 2
    assert (t["rem_clients"][t["rem_seq"] == 20, 0] == 2).all()
    assert (t["rem_seq"] == 200).sum() == 4
    n, t = live("inserts at 0 and at the visible total")
    assert n == 13 and t["ins_seq"][0] == 74
    assert t["ins_seq"][11:].tolist() == [75, 76]
    for k in (3, 2, 1):
        w = out[f"n = C - {k}: one pass, then step by step"]
        assert int(w.n_rows) == C - k + 7
        assert int(w.error) & tmk.ERR_CAPACITY
    for n0 in (31, 32, 33):
        w = out[f"{n0} live rows"]
        assert int(w.n_rows) == n0 + 8 and int(w.error) == 0
    grown = out["a chunk that grows its table across a warp's rows"]
    assert int(grown.n_rows) == 44 and int(grown.error) == 0


# ----------------------------------------------------------------------
# the kernel's geometry and the stacked converters


def test_scan_geometry_and_ceiling():
    """The layouts: everything in shared memory at the fold's shapes,
    the props half global at KernelReplica's C 4096 / B 512, the hot
    columns in shared memory wherever they fit beside the ops (C 8192
    and 8193) and in global memory above, with no capacity ceiling;
    only a chunk's ops that do not fit in shared memory raise."""
    for C in (64, 512, 1024, 2048):
        g = scan_geometry(C, 128, 4, 4, 8)
        assert g.threads == 512
        assert (g.hot, g.removers, g.props) == ("shared",) * 3
        assert g.layout == 7 and g.smem <= SMEM_OPTIN
    g = scan_geometry(4096, 512, 4, 4, 8)
    assert (g.hot, g.removers, g.props) == ("shared", "shared", "global")
    for C, B in ((8192, 128), (8192, 512), (8193, 128)):
        g = scan_geometry(C, B, 4, 4, 8)
        assert (g.hot, g.removers, g.props) == ("shared", "global", "global")
        assert g.layout == 1 and g.smem <= SMEM_OPTIN
    for C, B in ((16384, 128), (16384, 512), (1 << 20, 128)):
        g = scan_geometry(C, B, 4, 4, 8)
        assert (g.hot, g.threads) == ("global", 512)
        assert g.smem <= SMEM_OPTIN
    assert scan_geometry(16384, 128, 4, 4, 8).layout == 0
    assert scan_geometry(9000, 512, 4, 4, 8).removers == "shared"
    with pytest.raises(ValueError, match="shared bytes"):
        scan_geometry(2048, 4096, 4)


def test_interop_stacked_tables_and_batches_round_trip():
    reps = [_fold_rep(40 + d, 0) for d in range(3)]
    stack = lambda *xs: np.stack(xs)  # noqa: E731
    st = jax.tree_util.tree_map(stack, *[_np(r.table) for r in reps])
    sb = jax.tree_util.tree_map(
        stack, *[_np(r._build_batch(r._encoded[:128])) for r in reps])
    pt = interop.segment_table_from_numpy(st, "cpu")
    pb = interop.opbatch_from_numpy(sb._asdict(), "cpu")
    assert tuple(pt.rem_clients.shape) == (3, 512, 4)
    assert tuple(pb.prop_keys.shape) == (3, 128, 4)
    back_t = interop.segment_table_to_numpy(pt)
    back_b = interop.opbatch_to_numpy(pb)
    for k, v in st._asdict().items():
        assert np.array_equal(back_t[k], v) and back_t[k].dtype == np.int32
    for k, v in sb._asdict().items():
        assert np.array_equal(back_b[k], v)
    jmk.SegmentTable(**back_t)
    jmk.OpBatch(**back_b)
