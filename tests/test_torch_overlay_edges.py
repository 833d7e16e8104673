"""The overlay edge chunks: the port's plain version vs the JAX kernel.

Each chunk of `testing/overlay_edges.py` (split inserts at row 0 and at
the top of the window, gap loops of many steps and one that overflows
the window mid-loop, split halves whose removers and props diverge,
every remover slot taken, more than a window of rows created and
dropped, ops that fill every prop slot) goes through
`overlay_pallas.overlay_apply_chunk` in interpret mode and through
`overlay_apply_chunk_ref` on the CPU. Tolerance 0 on
n_rows, error and rows [:n_rows] of every column: everything is int32.
The CUDA kernel is held to the plain version on the same chunks in
tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidframework_tpu.ops import overlay_pallas as jov
from fluidframework_tpu.ops.mergetree_kernel import OpBatch as JOpBatch
from fluidframework_tpu_torch import interop
from fluidframework_tpu_torch.ops import overlay as tov
from fluidframework_tpu_torch.ops.mergetree_kernel import (
    ERR_CAPACITY,
    ERR_REMOVERS,
    PROP_DELETE,
)
from fluidframework_tpu_torch.testing.overlay_edges import overlay_edge_chunks

W, KR, KK, PK, B = 1024, 6, 8, 1, 64
CASES = {c["name"]: c for c in overlay_edge_chunks(W, KR, KK, PK, B)}
COLUMNS = ("anchor", "buf_start", "length", "ins_seq", "ins_client",
           "rem_seq", "rem_clients", "props")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_out(case):
    jt = jov.OverlayTable(**{k: jnp.asarray(v) for k, v in case["table"].items()})
    jops = JOpBatch(**{k: jnp.asarray(v) for k, v in case["ops"].items()})
    out = jov.overlay_apply_chunk(jt, jops, True)
    return {f: np.asarray(getattr(out, f)) for f in COLUMNS + ("n_rows", "error")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_edge_chunk_matches_pallas(name):
    case = CASES[name]
    want = _jax_out(case)
    got = interop.table_to_numpy(tov.overlay_apply_chunk_ref(
        interop.table_from_numpy(case["table"], device="cpu"),
        interop.opbatch_from_numpy(case["ops"], device="cpu")))
    n = int(want["n_rows"])
    assert int(got["n_rows"]) == n
    assert int(got["error"]) == int(want["error"])
    m = min(n, W)
    for f in COLUMNS:
        np.testing.assert_array_equal(got[f][:m], want[f][:m], err_msg=f)


def test_edge_chunks_reach_their_edges():
    """The chunks do what their names say on the plain version: the
    overflowing ones flag ERR_CAPACITY, the full remover row flags
    ERR_REMOVERS, the gap loops add their rows, and the recycling
    chunk creates and drops more rows than the window holds."""
    out = {}
    for name, case in CASES.items():
        t = tov.overlay_apply_chunk_ref(
            interop.table_from_numpy(case["table"], device="cpu"),
            interop.opbatch_from_numpy(case["ops"], device="cpu"))
        out[name] = (int(case["table"]["n_rows"]), int(t.n_rows), int(t.error))
    for name in ("split_insert_top", "split_insert_last_row",
                 "gap_loop_overflows"):
        assert out[name][2] == ERR_CAPACITY, name
    # The second half's positions shift as its rows fall off the window.
    assert out["recycle_more_than_W"][2] & ERR_CAPACITY
    assert out["removers_full"][2] == ERR_REMOVERS
    for name in ("split_insert_row0", "gap_loop_13_steps",
                 "split_halves_diverge", "prop_slots_full"):
        assert out[name][2] == 0, name
    n_in, n_out, _ = out["gap_loop_13_steps"]
    assert n_out - n_in >= 8 + 4
    n_in, n_out, _ = out["recycle_more_than_W"]
    assert (n_out - n_in) + (n_out - W) > W  # created + dropped


@pytest.mark.parametrize("pk", [2, 4])
def test_prop_slots_chunk_matches_pallas(pk):
    """The chunk whose ops fill every prop slot, at PK slots: the plain
    version equals the JAX kernel exactly, and at PK 4 the result shows
    each slot's effect (the later of two slots of one key wins on an
    insert, a delete in a later slot tombstones span rows)."""
    case = {c["name"]: c for c in overlay_edge_chunks(W, KR, KK, pk, B)}[
        "prop_slots_full"]
    want = _jax_out(case)
    got = interop.table_to_numpy(tov.overlay_apply_chunk_ref(
        interop.table_from_numpy(case["table"], device="cpu"),
        interop.opbatch_from_numpy(case["ops"], device="cpu")))
    n = int(want["n_rows"])
    assert (int(got["n_rows"]), int(got["error"])) == (n, int(want["error"]))
    for f in COLUMNS:
        np.testing.assert_array_equal(got[f][:n], want[f][:n], err_msg=f)
    if pk == 4:
        seen = set(got["props"][:n].ravel().tolist())
        assert {13, 12, 43, PROP_DELETE} <= seen and 11 not in seen


@pytest.mark.parametrize("window,KR,KK,R,KRP", [
    (1024, 24, 8, 1, 32), (2048, 24, 8, 2, 32), (4096, 24, 8, 4, 32),
    (2048, 6, 8, 2, 16), (2048, 5, 0, 2, 8), (1024, 40, 24, 1, 64)])
def test_kernel_geometry(window, KR, KK, R, KRP):
    assert tov.kernel_geometry(window, KR, KK) == (R, KRP)


@pytest.mark.parametrize("args", [
    (0, 24, 8),        # no rows
    (1536, 24, 8),     # not a multiple of 1024
    (2048, 0, 8),      # no remover slot
    (2048, 1000, 25),  # heap row wider than the block's 1024 threads
])
def test_kernel_geometry_raises(args):
    with pytest.raises(ValueError):
        tov.kernel_geometry(*args)
