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
  sums near the wrap, every row a run of one character; runs
  across tiles that keep nothing, a run over five tiles, a last live
  tile that keeps nothing, a row longer than several blocks' worth of
  elements, total text lengths 0 and A, ``n_rows`` at the int32 max);
- seeded random tables;
- every compaction's inputs of the port's chunk-path replay on the CPU
  (recorded from `ColumnarReplica.replay`).

The kernel's own source, ``csrc/zamboni.cu`` (its ``compaction_launch``
entry), runs on the host through `testing/zamboni_host_emu.py` (g++, an
OS thread per CUDA thread) and is held to the plain version on the same
tables, with the MSN passed by value and by pointer; with its blocks
run in reverse blockIdx order and all at once (the tiles' order comes
from the kernel's ticket, and blocks at once spin on each other's
statuses); with no inclusive prefix published, so that every look-back
combines aggregates back to the first tile (over windows of 32 tiles at
C 20480, across runs of tiles that keep nothing); and over two and more
calls on one scratch. Last, the dispatcher takes no other device and
never falls back.
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
    MSN,
    compaction_edge_cases,
    random_case,
    settled_run,
    text_edge_cases,
    wide_prop_cases,
)
from fluidframework_tpu_torch.testing.synthetic import generate_lagged_stream

FIELDS = ("n_rows", "error", "buf_start", "length", "ins_seq", "ins_client",
          "rem_seq", "rem_clients", "props")
# (C, KR, KK): one tile; two tiles; six tiles (the look-back's cases).
SHAPES = ((64, 4, 8), (1024, 8, 8), (3072, 4, 4))
TEXT = 100  # the index of text_edge_cases' first case among the edges
EDGES = [(shape, i, c["label"]) for shape in SHAPES
         for i, c in enumerate(compaction_edge_cases(*shape))] + [
    (shape, TEXT + i, c["label"]) for shape in SHAPES
    for i, c in enumerate(text_edge_cases(*shape))]
EDGE_IDS = [f"C{s[0]}-{i}" if i < TEXT else f"C{s[0]}-text{i - TEXT}"
            for s, i, _ in EDGES]
ORDER_SHAPE = SHAPES[2]
ORDER_EDGES = [e for e in EDGES if e[0] == ORDER_SHAPE]
WIDE = (20480, 4, 4)  # 40 tiles: look-backs over more than 32
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
    if index >= TEXT:
        return text_edge_cases(*shape)[index - TEXT]
    return compaction_edge_cases(*shape)[index]


def _wide_cases() -> list:
    """C 20480: one run across 35 tiles that keep nothing, and two
    runs split after them."""
    C, KR, KK = WIDE
    A, S = 4196 + 8 * C, 6 * C + 50
    tile = tzk.TILE
    one = settled_run(C, KR, KK, C - 9, 40, A, S)
    one["table"]["rem_seq"][2 * tile - 3:37 * tile + 2] = MSN
    two = settled_run(C, KR, KK, C - 9, 41, A, S)
    two["table"]["rem_seq"][2 * tile - 3:37 * tile + 2] = MSN
    two["table"]["props"][37 * tile + 2:, KK - 1] = 9
    one["label"], two["label"] = "35 empty tiles in a run", "and two runs"
    return [one, two]


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
    n_in, n_out = out["every row a run of one character"][:2]
    assert n_out == n_in == C > 2048


def test_lookback_and_text_cases_are_what_they_are_named_for():
    """The look-back's and the text's cases produce the outcome their
    labels promise (against JAX)."""
    C, KR, KK = ORDER_SHAPE
    tile = tzk.TILE
    out = {}
    for c in compaction_edge_cases(C, KR, KK) + text_edge_cases(C, KR, KK):
        table, arena = _jax(c)
        out[c["label"]] = (c, table, arena)
    for label, runs in (("three empty tiles inside one run", 1),
                        ("three empty tiles between two runs", 2)):
        c, table, _ = out[label]
        live = c["table"]["rem_seq"] == np.int32(2147483647)
        assert not live[tile:4 * tile].any() and live[4 * tile], label
        assert int(table["n_rows"]) == runs, label
    c, table, _ = out["a run from one tile to four tiles later"]
    runs = int(table["n_rows"])
    assert runs == (tile - 5) + 1 + (C - 5 * tile - 4)
    assert int(table["length"][tile - 5]) == int(
        c["table"]["length"][tile - 5:5 * tile + 4].sum())
    c, table, _ = out["the last live tile keeps nothing"]
    n = int(c["table"]["n_rows"])
    assert n // tile == 4 and n % tile
    assert (c["table"]["rem_seq"][4 * tile:n] <= MSN).all()
    assert 0 < int(table["n_rows"]) < n
    c, table, arena = out[
        "one kept row longer than several blocks' worth of elements"]
    assert int(c["table"]["length"][2]) > 4 * tzk.TEXT_CAP
    assert int(table["length"].astype(np.int64).sum()) == arena.shape[0]
    assert arena.all()
    c, table, arena = out["total text length 0"]
    assert int(table["n_rows"]) > 0 and not table["length"].any()
    assert not arena.any() and c["doc_arena"].any()
    c, table, arena = out["total text length exactly A"]
    assert int(table["length"].astype(np.int64).sum()) == arena.shape[0]
    assert arena.all()
    c, table, _ = out["n_rows at the int32 maximum"]
    assert int(c["table"]["n_rows"]) == (1 << 31) - 1
    assert int(table["n_rows"]) > 1


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


ORDER_IDS = [i for i, e in zip(EDGE_IDS, EDGES) if e[0] == ORDER_SHAPE]


@pytest.mark.parametrize("order", ["reverse", "at once"])
@pytest.mark.parametrize("shape,index,label", ORDER_EDGES, ids=ORDER_IDS)
def test_kernel_source_block_order(shape, index, label, order):
    """The emulated blocks in reverse blockIdx order, and all at once:
    the same result, since the kernel orders its tiles by ticket."""
    case = _edge(shape, index)
    _assert_equal(_port(case, zamboni_host_emu.run_compaction, order=order,
                        by_pointer=order == "reverse"),
                  _port(case), label)


@pytest.mark.parametrize("order", ["in order", "at once"])
@pytest.mark.parametrize("shape,index,label", ORDER_EDGES, ids=ORDER_IDS)
def test_kernel_source_aggregates_only(shape, index, label, order):
    """With no inclusive prefix published, every look-back combines the
    aggregates of all the tiles before it: the combine is associative
    over any split into windows and over tiles that keep nothing."""
    case = _edge(shape, index)
    _assert_equal(_port(case, zamboni_host_emu.run_compaction, order=order,
                        aggregates_only=True),
                  _port(case), label)


WIDE_MODES = {"prefixes": {}, "aggregates only": {"aggregates_only": True},
              "at once": {"order": "at once"}}


@pytest.mark.parametrize("mode", list(WIDE_MODES))
def test_kernel_source_wide_lookback(mode):
    """40 tiles, 35 of them keeping nothing inside one run (and before
    a split): look-backs over more than one window of 32 tiles (combined
    window by window, junctions across the windows' edges)."""
    kw = WIDE_MODES[mode]
    for case in _wide_cases():
        want = _port(case)
        assert int(want[0]["n_rows"]) == (
            1 if case["label"].startswith("35") else 2)
        _assert_equal(_port(case, zamboni_host_emu.run_compaction, **kw),
                      want, case["label"])


def test_kernel_source_calls_on_one_scratch():
    """Calls in a row on one scratch, each with another table (and the
    MSN by value, then by pointer), blocks all at once: no call reads the
    statuses the call before left, and each leaves the ticket and done
    counters at 0."""
    shape = ORDER_SHAPE
    scratch = zamboni_host_emu.CompactionScratch(shape[0])
    labels = ("random 6", "three empty tiles between two runs",
              "no live row", "a run from one tile to four tiles later",
              "random 6")
    by_label = {c["label"]: c for c in compaction_edge_cases(*shape)}
    for i, label in enumerate(labels):
        case = by_label[label]
        _assert_equal(_port(case, zamboni_host_emu.run_compaction,
                            scratch=scratch, order="at once",
                            by_pointer=i % 2 == 1),
                      _port(case), f"call {i}: {label}")
        assert scratch.epoch == i + 1
        assert not scratch.ints[:tzk.COUNTER_INTS].any()


def test_compaction_epochs():
    """The epochs a scratch's calls pass: 1 first, never 0, and
    another than the last call's across the wrap."""
    assert tzk.next_epoch(0) == 1
    assert tzk.next_epoch(5) == 6
    assert tzk.next_epoch(tzk.EPOCHS - 1) == 1
    assert tzk.compaction_scratch_ints(1024) == 32 + 16 * 2


@pytest.mark.parametrize("kk", [16, tzk.COMPACTION_MAX_KK])
def test_kernel_source_wide_props(kk):
    """Prop keys whose staged props take a block past 48 KB of shared
    memory (the launch opts in to more), up to the most the wrapper
    takes: equal to the plain version and to the JAX function."""
    assert tzk.compaction_smem(kk) > 48 * 1024
    for case in wide_prop_cases(1024, 4, kk):
        want = _port(case)
        _assert_equal(want, _jax(case), case["label"] + " (JAX)")
        _assert_equal(_port(case, zamboni_host_emu.run_compaction), want,
                      case["label"])


def test_compaction_prop_key_limit():
    """The wrapper's mirror of a block's shared memory equals the
    source's at every KK; the wrapper takes KK up to what a block may
    opt in to and raises past it, and the C entry refuses it too."""
    for kk in range(0, 130):
        assert zamboni_host_emu.compaction_smem_bytes(kk) == (
            tzk.compaction_smem(kk)), kk
    top = tzk.COMPACTION_MAX_KK
    assert tzk.compaction_smem(top) <= tzk.SMEM_OPT_IN < (
        tzk.compaction_smem(top + 1))
    tzk.CompactionKernel.check_kk(top)
    with pytest.raises(ValueError, match="prop keys"):
        tzk.CompactionKernel.check_kk(top + 1)
    case = random_case(64, 4, top + 1, 50, 27, 600, 400)
    with pytest.raises(RuntimeError, match="refused"):
        _port(case, zamboni_host_emu.run_compaction)


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
