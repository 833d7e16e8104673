"""The port's row-model zamboni vs the JAX package's `zamboni_device`.

The same int32 tables go through the JAX `zamboni_device` and the port's
plain version `zamboni_device_ref` on the CPU; tolerance 0, on every
field of the whole table (rows at and above ``n_rows`` hold the fills),
``n_rows`` and ``error``:

- the tables that the JAX scan replica leaves with no host compaction
  (the stream of tests/test_columnar_replay.py:114-133), at its last
  MSN, at MSN 0 and at an MSN in between;
- the edge tables of `testing/zamboni_edges.py` (no live row, every row
  dropped, one run, breaks of contiguity, props and settledness,
  ``n_rows`` above C, the kernel's tile edges, random tables) at KR 4
  and 8.

The kernel's own source, ``csrc/zamboni.cu``, runs on the host through
`testing/zamboni_host_emu.py` (g++, an OS thread per CUDA thread) and
is held to the plain version on the same edge tables. Last, the port's
counterpart of `test_zamboni_device_semantics`: after its scan
replica, `zamboni_device` keeps the text and does not add rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidframework_tpu.core.columnar_replay import ColumnarReplica as JReplica
from fluidframework_tpu.ops.mergetree_kernel import SegmentTable as JTable
from fluidframework_tpu.ops.zamboni import zamboni_device as j_zamboni
from fluidframework_tpu.testing.synthetic import generate_stream
from fluidframework_tpu_torch import interop
from fluidframework_tpu_torch.core.columnar_replay import ColumnarReplica
from fluidframework_tpu_torch.ops.zamboni import (
    zamboni_device,
    zamboni_device_ref,
)
from fluidframework_tpu_torch.testing import zamboni_host_emu
from fluidframework_tpu_torch.testing.zamboni_edges import zamboni_edge_tables

FIELDS = ("n_rows", "error", "buf_start", "length", "ins_seq", "ins_client",
          "rem_seq", "rem_clients", "props")
INITIAL = 16
# (C, KR, KK) of the edge tables: one tile, and 2 and 3 tiles of the
# kernel (run starts, drops and runs across tile edges).
SHAPES = ((64, 4, 8), (1024, 8, 8), (2048, 4, 8), (3072, 8, 4))
EDGES = [(shape, i, c["label"]) for shape in SHAPES
         for i, c in enumerate(zamboni_edge_tables(*shape))]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax(table: dict, min_seq: int) -> dict:
    out = j_zamboni(JTable(**{k: jnp.asarray(v) for k, v in table.items()}),
                    jnp.int32(min_seq))
    return {k: np.asarray(v) for k, v in out._asdict().items()}


def _port(table: dict, min_seq: int, fn=zamboni_device_ref) -> dict:
    return interop.segment_table_to_numpy(
        fn(interop.segment_table_from_numpy(table, "cpu"), min_seq))


def _assert_equal(got: dict, want: dict, label: str) -> None:
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], want[f],
                                      err_msg=f"{label}: {f}")


@pytest.fixture(scope="module")
def scan_replica():
    """The JAX scan replica of tests/test_columnar_replay.py:114 (no host
    compaction: tombstones and split pieces stay)."""
    stream = generate_stream(400, n_clients=6, seed=3, window=16,
                             initial_len=INITIAL)
    rep = JReplica(stream, initial_len=INITIAL, chunk_size=64,
                   capacity=1024, compact_watermark=1.1, engine="scan")
    rep.replay()
    rep.check_errors()
    assert rep.compactions == 0
    return stream, rep


@pytest.mark.parametrize("which", ["last", "zero", "between"])
def test_scan_replica_table_matches_jax(scan_replica, which):
    _, rep = scan_replica
    table = {k: np.asarray(v) for k, v in rep.table._asdict().items()}
    msn = {"last": rep._applied_min_seq, "zero": 0,
           "between": rep._applied_min_seq // 2}[which]
    want = _jax(table, msn)
    if which != "zero":
        assert int(want["n_rows"]) < int(table["n_rows"])
    _assert_equal(_port(table, msn), want, which)


@pytest.mark.parametrize("shape,index,label", EDGES,
                         ids=[f"C{s[0]}-KR{s[1]}-{i}" for s, i, _ in EDGES])
def test_edge_tables_match_jax(shape, index, label):
    case = zamboni_edge_tables(*shape)[index]
    want = _jax(case["table"], case["min_seq"])
    _assert_equal(_port(case["table"], case["min_seq"]), want, label)
    # The dispatcher takes a CPU table to the same plain version.
    _assert_equal(_port(case["table"], case["min_seq"], zamboni_device),
                  want, label)


def test_edge_tables_are_what_they_are_named_for():
    """The cases produce the outcome their labels promise (against
    JAX), so that a weakened case cannot pass unnoticed."""
    C = 3072
    out = {c["label"]: (int(c["table"]["n_rows"]),
                        int(_jax(c["table"], c["min_seq"])["n_rows"]))
           for c in zamboni_edge_tables(C, 8, 4)}
    assert out["no live row"] == (0, 0)
    assert out["every row dropped"][1] == 0
    assert out["one contiguous settled run"][1] == 1
    assert out["a tile dropped inside one run"][1] == 1
    assert out["n_rows above C"][0] > C
    assert out["a run across dropped tiles"][1] == 3
    for label in ("settled neighbours not contiguous",
                  "props differ in one key", "removed above the MSN",
                  "inserted above the MSN"):
        n_in, n_out = out[label]
        assert 1 < n_out < n_in, label
    assert out["MSN 0"][1] == out["MSN 0"][0]


@pytest.mark.parametrize("shape,index,label", EDGES,
                         ids=[f"C{s[0]}-KR{s[1]}-{i}" for s, i, _ in EDGES])
def test_kernel_source_on_the_host_matches_plain(shape, index, label):
    case = zamboni_edge_tables(*shape)[index]
    want = _port(case["table"], case["min_seq"])
    got = _port(case["table"], case["min_seq"], zamboni_host_emu.run)
    _assert_equal(got, want, label)


def test_kernel_source_on_the_host_scan_replica(scan_replica):
    _, rep = scan_replica
    table = {k: np.asarray(v) for k, v in rep.table._asdict().items()}
    msn = rep._applied_min_seq
    _assert_equal(_port(table, msn, zamboni_host_emu.run), _jax(table, msn),
                  "scan replica")


def test_zamboni_device_semantics(scan_replica):
    """The port's scan replica (no host compaction), then
    `zamboni_device`: the text is unchanged and no row is added."""
    stream, jrep = scan_replica
    rep = ColumnarReplica(interop.stream_from_numpy(stream),
                          initial_len=INITIAL, chunk_size=64, capacity=1024,
                          compact_watermark=1.1, engine="scan", device="cpu")
    rep.replay()
    rep.check_errors()
    assert rep.compactions == 0
    before = rep.get_text()
    assert before == jrep.get_text()
    rows_before = int(rep.table.n_rows)
    rep.table = zamboni_device(rep.table, rep._applied_min_seq)
    assert rep.get_text() == before
    assert int(rep.table.n_rows) < rows_before
