"""The chunk path's compaction: the port vs the JAX `compact_gather_text`.

The same int32 tables and text arrays go through the JAX
`compact_gather_text` and the port's plain version
`compact_gather_text_ref` on the CPU; tolerance 0, on every field of
the whole table (rows at and above ``n_rows`` hold the fills),
``n_rows``, ``error`` and the whole new arena:

- the edge cases of `testing/compaction_edges.py` (nothing / everything
  dropped, ``n_rows`` past C, spans in both regions and in neither,
  runs across the kernel's tile edges, props that differ in one key,
  runs that the zamboni's contiguity test would split, int32 length
  sums near the wrap, more kept rows than a gather block stages);
- seeded random tables;
- every compaction's inputs of the port's chunk-path replay on the CPU
  (recorded from `ColumnarReplica.replay`).

The kernel's own source, ``csrc/zamboni.cu`` (its ``compaction_launch``
entry), runs on the host through `testing/zamboni_host_emu.py` (g++, an
OS thread per CUDA thread) and is held to the plain version on the same
tables, with the MSN passed by value and by pointer. Last, the
dispatcher takes no other device and never falls back.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidframework_tpu.ops.mergetree_kernel import SegmentTable as JTable
from fluidframework_tpu.ops.zamboni import (
    compact_gather_text as j_compact,
    zamboni_device as j_zamboni,
)
from fluidframework_tpu_torch import interop
from fluidframework_tpu_torch.core import columnar_replay as cr
from fluidframework_tpu_torch.ops import zamboni as tz
from fluidframework_tpu_torch.ops import zamboni_kernel as tzk
from fluidframework_tpu_torch.ops.mergetree_kernel import make_table
from fluidframework_tpu_torch.testing import zamboni_host_emu
from fluidframework_tpu_torch.testing.compaction_edges import (
    compaction_edge_cases,
    random_case,
)
from fluidframework_tpu_torch.testing.synthetic import generate_lagged_stream

FIELDS = ("n_rows", "error", "buf_start", "length", "ins_seq", "ins_client",
          "rem_seq", "rem_clients", "props")
# (C, KR, KK): one tile; two tiles; six tiles with more kept rows in one
# gather block than it stages.
SHAPES = ((64, 4, 8), (1024, 8, 8), (3072, 4, 4))
EDGES = [(shape, i, c["label"]) for shape in SHAPES
         for i, c in enumerate(compaction_edge_cases(*shape))]
EDGE_IDS = [f"C{s[0]}-{i}" for s, i, _ in EDGES]
SEEDED = [((C, KR, KK), seed) for C, KR, KK in ((256, 4, 8), (1500, 8, 2))
          for seed in (21, 22, 23)]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax(case: dict) -> tuple:
    out, arena = j_compact(
        JTable(**{k: jnp.asarray(v) for k, v in case["table"].items()}),
        jnp.int32(case["min_seq"]), jnp.asarray(case["doc_arena"]),
        jnp.asarray(case["stream_text"]))
    return ({k: np.asarray(v) for k, v in out._asdict().items()},
            np.asarray(arena))


def _port(case: dict, fn=tz.compact_gather_text_ref, **kw) -> tuple:
    out, arena = fn(interop.segment_table_from_numpy(case["table"], "cpu"),
                    case["min_seq"], torch.from_numpy(case["doc_arena"]),
                    torch.from_numpy(case["stream_text"]), **kw)
    return interop.segment_table_to_numpy(out), arena.numpy()


def _assert_equal(got: tuple, want: tuple, label: str) -> None:
    for f in FIELDS:
        np.testing.assert_array_equal(got[0][f], want[0][f],
                                      err_msg=f"{label}: {f}")
    np.testing.assert_array_equal(got[1], want[1],
                                  err_msg=f"{label}: the arena")


def _edge(shape, index) -> dict:
    return compaction_edge_cases(*shape)[index]


@pytest.fixture(scope="module")
def replay_cases():
    """Every compaction's inputs of the port's chunk-path replay on the
    CPU (a lagged stream, chunks of 64, a compaction every 4 chunks)."""
    stream = generate_lagged_stream(1024, n_clients=16, seed=5, window=256,
                                    initial_len=32)
    cases = []

    def record(table, min_seq, doc_arena, stream_text):
        cases.append({
            "label": f"replay compaction {len(cases)}",
            "table": interop.segment_table_to_numpy(table),
            "min_seq": int(min_seq), "doc_arena": doc_arena.numpy().copy(),
            "stream_text": stream_text.numpy().copy()})
        return tz.compact_gather_text_ref(table, min_seq, doc_arena,
                                          stream_text)

    mp = pytest.MonkeyPatch()
    mp.setattr(cr, "compact_gather_text", record)
    try:
        rep = cr.ColumnarReplica(stream, initial_len=32, chunk_size=64,
                                 capacity=1024, n_removers=8, device="cpu")
        rep.replay()
        rep.check_errors()
    finally:
        mp.undo()
    assert len(cases) == rep.compactions == 4
    return cases


@pytest.mark.parametrize("shape,index,label", EDGES, ids=EDGE_IDS)
def test_edge_cases_match_jax(shape, index, label):
    case = _edge(shape, index)
    want = _jax(case)
    _assert_equal(_port(case), want, label)
    # The dispatcher takes a CPU table to the same plain version.
    _assert_equal(_port(case, tz.compact_gather_text), want, label)


@pytest.mark.parametrize("shape,seed", SEEDED,
                         ids=[f"C{s[0]}-seed{d}" for s, d in SEEDED])
def test_seeded_tables_match_jax(shape, seed):
    C = shape[0]
    case = random_case(*shape, C - 7, seed, 8 * C, 5 * C)
    _assert_equal(_port(case), _jax(case), f"seed {seed}")


def test_replay_compactions_match_jax(replay_cases):
    for case in replay_cases:
        _assert_equal(_port(case), _jax(case), case["label"])


def test_edge_cases_are_what_they_are_named_for():
    """The cases produce the outcome their labels promise (against
    JAX), so that a weakened case cannot pass unnoticed."""
    C, KR, KK = 3072, 4, 4
    out = {}
    for c in compaction_edge_cases(C, KR, KK):
        table, arena = _jax(c)
        zam = j_zamboni(JTable(**{k: jnp.asarray(v)
                                  for k, v in c["table"].items()}),
                        jnp.int32(c["min_seq"]))
        out[c["label"]] = (int(c["table"]["n_rows"]), int(table["n_rows"]),
                           int(zam.n_rows), table, arena, c)
    assert out["no live row"][1] == 0
    assert out["everything dropped"][1] == 0
    assert not out["everything dropped"][4].any()
    assert out["n_rows past C"][0] > C
    for label in ("nothing dropped", "random 6", "random 7",
                  "spans in both regions and in neither"):
        n_in, n_out, _, _, arena, c = out[label]
        assert 1 < n_out < n_in, label
        assert arena.any() and not arena.all(), label
    assert out["MSN 0"][1] == out["MSN 0"][0]  # nothing drops or settles
    # Maximal coalescing merges what the contiguity test splits.
    n_in, n_out, n_zam = out["settled, not contiguous: one run"][:3]
    assert n_out == 1 and n_zam == n_in
    n_in, n_out, n_zam = out["props differ in one key"][:3]
    assert 1 < n_out < n_zam == n_in
    _, n_out, _, table, _, c = out["length sums near the int32 wrap"]
    assert n_out == 1
    assert int(table["length"][0]) > (1 << 31) - 10
    assert int(c["table"]["length"].astype(np.int64).sum()) < 1 << 31
    assert out["a run across the tile edges, dropped at them"][1] == 1
    assert out["a tile dropped inside one run"][1] == 1
    n_in, n_out = out["run starts at the tile edges"][:2]
    assert n_out > 1
    n_in, n_out = out["more kept rows than a gather block stages"][:2]
    assert n_out == n_in == C > 2048


@pytest.mark.parametrize("shape,index,label", EDGES, ids=EDGE_IDS)
def test_kernel_source_on_the_host_matches_plain(shape, index, label):
    case = _edge(shape, index)
    want = _port(case)
    got = _port(case, zamboni_host_emu.run_compaction,
                by_pointer=index % 2 == 1)
    _assert_equal(got, want, label)


@pytest.mark.parametrize("shape,seed", SEEDED,
                         ids=[f"C{s[0]}-seed{d}" for s, d in SEEDED])
def test_kernel_source_on_the_host_seeded(shape, seed):
    C = shape[0]
    case = random_case(*shape, C - 7, seed, 8 * C, 5 * C)
    _assert_equal(_port(case, zamboni_host_emu.run_compaction), _port(case),
                  f"seed {seed}")


def test_kernel_source_on_the_host_replay(replay_cases):
    for case in replay_cases:
        _assert_equal(_port(case, zamboni_host_emu.run_compaction),
                      _port(case), case["label"])


def test_zamboni_source_msn_by_pointer():
    """The zamboni's entry with the MSN on the card (a pointer) gives
    what the MSN by value gives."""
    case = random_case(1024, 8, 8, 1000, 31, 9000, 7000)
    t = interop.segment_table_from_numpy(case["table"], "cpu")
    want = interop.segment_table_to_numpy(tz.zamboni_device_ref(t, 1000))
    for by_pointer in (False, True):
        got = interop.segment_table_to_numpy(
            zamboni_host_emu.run(t, 1000, by_pointer=by_pointer))
        for f in FIELDS:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def test_compaction_no_silent_cpu_fallback(monkeypatch):
    """`compact_gather_text` sends a CPU table only to the plain
    version, another device never reaches it, and the CUDA wrapper
    refuses CPU tensors without launching."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without CUDA")

    def boom(*a, **k):
        raise AssertionError("the plain version ran")

    table = make_table(1024, 4, 8, device="cpu")
    arena = torch.zeros(4096, dtype=torch.int32)
    text = torch.zeros(2048, dtype=torch.int32)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tzk.compaction_kernel(table, 0, arena, text)
    assert tzk.compaction_kernel.launches == 0
    monkeypatch.setattr(tz, "compact_gather_text_ref", boom)
    with pytest.raises(ValueError, match="unsupported device"):
        tz.compact_gather_text(table.to("meta"), 0, arena.to("meta"),
                               text.to("meta"))
    with pytest.raises(AssertionError, match="the plain version ran"):
        tz.compact_gather_text(table, 0, arena, text)
    assert tzk.compaction_kernel.launches == 0
