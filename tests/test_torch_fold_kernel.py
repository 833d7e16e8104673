"""The overlay fold kernel (``csrc/overlay_fold.cu``) and its plain
version vs the JAX package's `fold_device` and `replay_chunk_step`.

On the CPU, tolerance 0 (int32):

- the kernel's own source runs on the host through
  `testing/fold_host_emu.py` (g++, an OS thread per CUDA thread, the
  CTAs of a cluster at once: the tiles and segments, the warp scans,
  the cluster's exchange over distributed shared memory, the maps and
  runs, the clamped append) and is held to `fold_device_ref`
  on the whole output table, the whole ``[W, 5+KK]`` record block and
  n_rec; both are held to the JAX `fold_device` on the same table,
  document by document;
- the append form: the emulation against `fold_append_ref` (the plain
  form of `replay_chunk_step`'s fold and log step) on the whole log,
  counts and the cursor, at cursors that fit and that lie past the
  log's capacity (the start clamps);
- shapes W 1024 and 2048 x KR 1, 4, 24 x KK 1, 8 x D 1, 3 on random
  tables; the edge tables of `testing/fold_edges.py` (the tile-boundary
  cases among them); the tables a lagged stream's replay leaves after
  each of its first chunks; each at the cluster size the wrapper picks
  and at G = 1, 2, 4 and 8 forced (the ``_per_cluster`` tests), and
  some with tiles forced into several segments;
- the port's `replay_chunk_step` (plain kernel A, then the plain fold
  and append, and the same with the emulated fold) against the JAX
  `replay_chunk_step` (Pallas in interpret mode) chunk by chunk:
  ``log[:cursor]``, counts and the cursor (rows past ``n_rows`` of
  kernel A's output are scratch on either side, so the records of the
  dead rows are not held there, as in tests/test_torch_overlay_replay.py);
- the dispatchers: a CPU table goes to the plain versions, a device
  the port does not take raises.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidframework_tpu.ops import overlay_pallas as jov
from fluidframework_tpu.ops.mergetree_kernel import OpBatch as JOpBatch
from fluidframework_tpu.testing import synthetic as jsyn
from fluidframework_tpu_torch import interop
from fluidframework_tpu_torch.core.overlay_replay import OverlayDeviceReplica
from fluidframework_tpu_torch.ops import overlay as tov
from fluidframework_tpu_torch.testing import fold_host_emu
from fluidframework_tpu_torch.testing.fold_edges import edge_cases, random_table

FIELDS = ("n_rows", "anchor", "buf_start", "length", "ins_seq", "ins_client",
          "rem_seq", "rem_clients", "props", "settled_len", "error")
SHAPES = [(W, KR, KK, D) for W in (1024, 2048) for KR in (1, 4, 24)
          for KK in (1, 8) for D in (1, 3)]
EDGES = [c.name for c in edge_cases()]
CLUSTERS = [1, 2, 4, 8]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lead(table: tov.OverlayTable):
    return tuple(table.length.shape[:-1])


def _assert_tables_equal(got: tov.OverlayTable, want: tov.OverlayTable,
                         what: str) -> None:
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f"{what}: {f}"


def _jax_fold(table: dict, msn) -> tuple:
    """The JAX `fold_device` of every document of a numpy table (a
    leading [D] axis or none): (table fields, records, n_rec), stacked
    as the input is."""
    stacked = np.ndim(table["n_rows"]) == 1
    docs = ([{k: v[d] for k, v in table.items()}
             for d in range(len(table["n_rows"]))] if stacked else [table])
    msns = np.broadcast_to(np.asarray(msn, np.int32), (len(docs),))
    outs = []
    for doc, m in zip(docs, msns):
        t, rec, n = jov.fold_device(
            jov.OverlayTable(**{k: jnp.asarray(v) for k, v in doc.items()}),
            jnp.int32(m))
        outs.append(({f: np.asarray(getattr(t, f)) for f in FIELDS},
                     np.asarray(rec), np.asarray(n)))
    if not stacked:
        return outs[0]
    return ({f: np.stack([o[0][f] for o in outs]) for f in FIELDS},
            np.stack([o[1] for o in outs]), np.stack([o[2] for o in outs]))


def _msn_arg(msn):
    return torch.from_numpy(np.asarray(msn, np.int32)) if np.ndim(msn) \
        else int(msn)


def _hold_fold(table_np: dict, msn, what: str, cluster=None,
               segment=None) -> None:
    """Emulated kernel == plain version == JAX, whole outputs; the
    kernel in clusters of `cluster` CTAs staging `segment` rows at once
    (None: the wrapper's choice)."""
    table = interop.table_from_numpy(table_np, "cpu")
    want = tov.fold_device_ref(table, _msn_arg(msn))
    got = fold_host_emu.run(table, _msn_arg(msn), cluster, segment)
    _assert_tables_equal(got[0], want[0], what)
    assert torch.equal(got[1], want[1]), f"{what}: records"
    assert torch.equal(got[2], want[2]), f"{what}: n_rec"
    jt, jrec, jn = _jax_fold(table_np, msn)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(want[0], f).numpy(), jt[f],
                                      err_msg=f"{what}: {f} vs JAX")
    np.testing.assert_array_equal(want[1].numpy(), jrec,
                                  err_msg=f"{what}: records vs JAX")
    np.testing.assert_array_equal(want[2].numpy(), jn,
                                  err_msg=f"{what}: n_rec vs JAX")
    # The dispatcher sends a CPU table to the plain version.
    _assert_tables_equal(tov.fold_device(table, _msn_arg(msn))[0], want[0],
                         what)


def _hold_append(table_np: dict, msn, cursor, cap: int, what: str,
                 epoch: int = 2, n_epochs: int = 5, cluster=None,
                 segment=None) -> None:
    """Emulated append == plain append, on the whole log, counts and
    cursor; neither writes the input table."""
    def emulated(*args):
        return fold_host_emu.run_append(*args, cluster=cluster,
                                        segment=segment)

    table = interop.table_from_numpy(table_np, "cpu")
    lead = _lead(table)
    KK = table.props.shape[-1]
    rng = np.random.default_rng(cap)
    log0 = torch.from_numpy(
        rng.integers(-50, 50, lead + (cap, 5 + KK)).astype(np.int32))
    counts0 = torch.from_numpy(
        rng.integers(0, 9, lead + (n_epochs,)).astype(np.int32))
    cur = torch.from_numpy(np.broadcast_to(
        np.asarray(cursor, np.int32), lead).copy())
    before = {f: getattr(table, f).clone() for f in FIELDS}
    logs, counts, outs = [], [], []
    for fn in (tov.fold_append_ref, emulated, tov.fold_append):
        log, cnt = log0.clone(), counts0.clone()
        outs.append(fn(table, _msn_arg(msn), log, cnt, cur, epoch))
        logs.append(log)
        counts.append(cnt)
    for i in (1, 2):
        _assert_tables_equal(outs[i][0], outs[0][0], what)
        assert torch.equal(outs[i][1], outs[0][1]), f"{what}: cursor"
        assert torch.equal(logs[i], logs[0]), f"{what}: log"
        assert torch.equal(counts[i], counts[0]), f"{what}: counts"
    for f in FIELDS:
        assert torch.equal(getattr(table, f), before[f]), f"{what}: {f} written"
    # Only the clamped block and counts[epoch] changed.
    n_rec = tov.fold_device_ref(table, _msn_arg(msn))[2]
    assert torch.equal(counts[0].select(-1, epoch), n_rec)
    assert torch.equal(outs[0][1], cur + n_rec)


@pytest.mark.parametrize("W,KR,KK,D", SHAPES)
def test_random_tables(W, KR, KK, D):
    rng = np.random.default_rng(1000 * W + 10 * KR + KK + D)
    t = random_table(rng, W, KR, KK, D=None if D == 1 else D)
    msn = 50 if D == 1 else np.asarray([10, 50, 90], np.int32)
    _hold_fold(t, msn, f"W{W} KR{KR} KK{KK} D{D}")
    cap = W + 300
    for cursor in (200, cap):  # fits; past the top, so the start clamps
        _hold_append(t, msn, cursor, cap, f"W{W} D{D} cursor {cursor}")


@pytest.mark.parametrize("G", CLUSTERS)
@pytest.mark.parametrize("W,KR,KK,D", SHAPES)
def test_random_tables_per_cluster(W, KR, KK, D, G):
    """`test_random_tables` with the cluster size forced to each G."""
    rng = np.random.default_rng(1000 * W + 10 * KR + KK + D)
    t = random_table(rng, W, KR, KK, D=None if D == 1 else D)
    msn = 50 if D == 1 else np.asarray([10, 50, 90], np.int32)
    _hold_fold(t, msn, f"W{W} KR{KR} KK{KK} D{D} G{G}", cluster=G)
    cap = W + 300
    for cursor in (200, cap):
        _hold_append(t, msn, cursor, cap, f"W{W} D{D} G{G} cursor {cursor}",
                     cluster=G)


@pytest.mark.parametrize("name", EDGES)
@pytest.mark.parametrize("W", [1024, 2048])
def test_edge_tables(name, W):
    case = next(c for c in edge_cases(W, 4, 8, seed=W) if c.name == name)
    _hold_fold(case.table, case.msn, f"{name} W{W}")
    _hold_append(case.table, case.msn, case.cursor, case.cap,
                 f"{name} W{W} append")


@pytest.mark.parametrize("G", CLUSTERS)
@pytest.mark.parametrize("name", EDGES)
@pytest.mark.parametrize("W", [1024, 2048])
def test_edge_tables_per_cluster(name, W, G):
    """`test_edge_tables` with the cluster size forced to each G (the
    tile-boundary cases among them)."""
    case = next(c for c in edge_cases(W, 4, 8, seed=W) if c.name == name)
    _hold_fold(case.table, case.msn, f"{name} W{W} G{G}", cluster=G)
    _hold_append(case.table, case.msn, case.cursor, case.cap,
                 f"{name} W{W} G{G} append", cluster=G)


@pytest.mark.parametrize("segment", [64, 100, 256])
@pytest.mark.parametrize("G", [1, 2, 8])
@pytest.mark.parametrize("name", ["every_row_live", "int32_wraparound",
                                  "docs_msn_per_document",
                                  "w_not_divided_by_cluster",
                                  "folding_rows_in_last_tile_only"])
def test_segmented_tiles(name, G, segment):
    """Tiles staged in several segments (forced short here; the wrapper
    takes more than one only above 8 x 4096 rows): each segment staged
    twice, its partial ranks carried from the segments before it."""
    case = next(c for c in edge_cases(1024, 4, 8, seed=3) if c.name == name)
    what = f"{name} G{G} segment {segment}"
    _hold_fold(case.table, case.msn, what, cluster=G, segment=segment)
    _hold_append(case.table, case.msn, case.cursor, case.cap,
                 f"{what} append", cluster=G, segment=segment)


def test_wrapper_geometry():
    """The cluster size and segment the wrapper picks: the largest
    power of two up to 8 with D G <= 132 SMs and 128 rows a CTA, then
    larger where a tile would not fit one segment (4096 rows, fewer
    where the props fill shared memory); forced sizes outside the
    kernel's range raise."""
    picks = {(D, W): tov.fold_cluster(D, W, 8) for D in (1, 4, 8, 32, 132)
             for W in (1024, 2048, 8192)}
    assert [picks[D, 2048] for D in (1, 4, 8, 32, 132)] == [8, 8, 8, 4, 1]
    assert picks[1, 1024] == 8 and picks[132, 8192] == 4
    assert tov.fold_cluster(1, 200, 8) == 1
    assert tov.fold_cluster(1, 256, 8) == 2
    assert tov.fold_cluster(132, 40000, 8) == 8
    assert tov.fold_cluster(66, 2048, 8) == 2
    assert tov.fold_cluster(16, 2048, 8, sms=64) == 4
    assert tov.fold_cluster(132, 4096, 1) == 1
    assert tov.fold_max_segment(8) == 3416
    assert tov.fold_max_segment(1) == 4096
    geo = tov.OverlayFoldKernel.geometry
    assert geo(1, 2048, 8) == (8, 256)
    assert geo(132, 2048, 8) == (1, 2048)
    assert geo(1, 1000, 8) == (4, 252)
    assert geo(1, 1000, 8, cluster=8) == (8, 128)
    assert geo(132, 40000, 8) == (8, 3416)
    assert geo(1, 2048, 8, cluster=1, segment=101) == (1, 104)
    assert geo(1, 9, 8, cluster=8) == (8, 4)
    for bad in (dict(cluster=3), dict(cluster=16), dict(segment=0),
                dict(segment=3417)):
        with pytest.raises(ValueError):
            geo(1, 2048, 8, **bad)


GEOM = dict(initial_len=64, chunk_size=128, window=1024, n_removers=8)


@pytest.fixture(scope="module")
def lagged():
    return jsyn.generate_lagged_stream(1024, n_clients=64, seed=5,
                                       window=512, initial_len=64)


def _hold_replay_tables(lagged, cluster=None) -> None:
    rep = OverlayDeviceReplica(interop.stream_from_numpy(lagged),
                               device="cpu", **GEOM)
    rep.prepare()
    table = rep.table
    for ci in range(rep.n_chunks):
        ops = rep._dev.slice(ci * rep.chunk_size, (ci + 1) * rep.chunk_size)
        table = tov.overlay_apply_chunk(table, ops)
        msn = int(rep._msn_by_chunk[ci])
        _hold_fold(interop.table_to_numpy(table), msn, f"chunk {ci}",
                   cluster=cluster)
        table = tov.fold_device_ref(table, msn)[0]
    assert int(table.n_rows) > 0


def test_replay_tables(lagged):
    """The tables a lagged replay leaves after kernel A, chunk by chunk:
    the emulated fold == the plain fold == JAX on each."""
    _hold_replay_tables(lagged)


@pytest.mark.parametrize("G", CLUSTERS)
def test_replay_tables_per_cluster(lagged, G):
    """`test_replay_tables` with the cluster size forced to each G."""
    _hold_replay_tables(lagged, cluster=G)


def test_replay_steps_match_jax(lagged):
    """`replay_chunk_step` on the CPU (plain kernel A and fold) and
    the same steps with the emulated fold against the JAX
    `replay_chunk_step`, chunk by chunk, from a log whose capacity
    makes the last steps clamp."""
    rep = OverlayDeviceReplica(interop.stream_from_numpy(lagged),
                               device="cpu", **GEOM)
    rep.prepare()
    W, KK, chunk = rep.window, rep.n_prop_keys, rep.chunk_size
    n_chunks = rep.n_chunks
    jops = JOpBatch(**{k: jnp.asarray(v) for k, v in
                       interop.opbatch_to_numpy(rep._dev).items()})
    jt = jov.OverlayTable(**{k: jnp.asarray(v) for k, v in
                             interop.table_to_numpy(rep.table).items()})
    cap = W + 256
    jlog = jnp.zeros((cap, 5 + KK), jnp.int32)
    jcounts = jnp.zeros(n_chunks, jnp.int32)
    jcur = jnp.int32(0)
    states = []
    for _ in range(2):  # the plain fold; the emulated fold
        states.append([rep.table, torch.zeros((cap, 5 + KK), dtype=torch.int32),
                       torch.zeros(n_chunks, dtype=torch.int32),
                       torch.zeros((), dtype=torch.int32)])
    for ci in range(n_chunks):
        msn = rep._msn_by_chunk[ci]
        jt, jlog, jcounts, jcur = jov.replay_chunk_step(
            jt, jops, ci * chunk, chunk, jnp.int32(int(msn)), jlog, jcounts,
            jcur, ci, True)
        t, log, counts, cur = states[0]
        states[0] = list(tov.replay_chunk_step(
            t, rep._dev, ci * chunk, chunk, msn, log, counts, cur, ci))
        t, log, counts, cur = states[1]
        t = tov.overlay_apply_chunk(
            t, rep._dev.slice(ci * chunk, (ci + 1) * chunk))
        t, cur = fold_host_emu.run_append(t, msn, log, counts, cur, ci)
        states[1] = [t, log, counts, cur]
        c = int(jcur)
        clamped = c > cap - W
        for t, log, counts, cur in states:
            assert int(cur) == c, ci
            np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
            if not clamped:  # log[:cursor] holds folding rows only
                np.testing.assert_array_equal(log[:c].numpy(),
                                              np.asarray(jlog[:c]))
            n = int(t.n_rows)
            for f in ("anchor", "buf_start", "length", "ins_seq",
                      "ins_client", "rem_seq", "rem_clients", "props"):
                np.testing.assert_array_equal(
                    getattr(t, f)[:n].numpy(), np.asarray(getattr(jt, f))[:n],
                    err_msg=f"chunk {ci}: {f}")
            assert int(t.settled_len) == int(jt.settled_len)
        assert torch.equal(states[1][1], states[0][1]), ci
        assert torch.equal(states[1][3], states[0][3]), ci
    assert int(jcur) > cap - W  # the last steps clamped


def test_dispatch_refuses_other_devices():
    t = tov.make_overlay_table(1024, device="cpu")
    meta = tov.OverlayTable(*(x.to("meta") for x in (
        getattr(t, f) for f in FIELDS)))
    with pytest.raises(ValueError, match="unsupported device"):
        tov.fold_device(meta, 0)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tov.overlay_fold_kernel(t, 0)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tov.overlay_fold_kernel.append(
            t, 0, torch.zeros((1024, 13), dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32),
            torch.zeros((), dtype=torch.int32), 0)
    assert tov.overlay_fold_kernel.launches == 0
