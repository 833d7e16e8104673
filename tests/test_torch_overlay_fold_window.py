"""The port's summary fold as its window grows, vs the JAX overlay fold.

A live `OverlayFoldReplica` (``device="cpu"``: the kernel's plain
version) and the JAX one (the Pallas kernel in interpret mode) take the
same two fold rounds without a reboot; the pending rows grow the
window 1024 -> 2048 -> 3072 (`_ensure_window`, the port's
`ops.overlay.pad_window`). Tables, settled state and canonical rows
are compared exactly after each round; `pad_window` keeps every
column's sentinel as `_ensure_window` does.
"""

import numpy as np
import pytest
import torch

from fluidframework_tpu.core import overlay_fold as jfold
from fluidframework_tpu.server.summarizer import _encode_fold as jax_encode_fold
from fluidframework_tpu.testing.deli_bench import build_mergetree_stream
from fluidframework_tpu_torch import interop
from fluidframework_tpu_torch.core.overlay_fold import (
    boot_overlay,
    fold_jobs_overlay,
)
from fluidframework_tpu_torch.ops.overlay import pad_window
from fluidframework_tpu_torch.server.summary_fold import _encode_fold

TABLE_FIELDS = ("anchor", "buf_start", "length", "ins_seq", "ins_client",
                "rem_seq", "rem_clients", "props")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_growing_window_matches_jax_overlay_fold():
    """One live replica, two fold rounds without a reboot: the window
    grows 1024 -> 2048 -> 3072 (`_ensure_window` from the pending
    rows), and tables, settled state and rows equal the JAX overlay
    fold's after each round."""
    recs = build_mergetree_stream(726, n_clients=4, seed=21)
    port = boot_overlay([], 0, device="cpu")
    jax_rep = jfold.boot_overlay([], 0, interpret=True)
    windows = [port.window]
    for lo, hi in ((0, 250), (250, 730)):
        _encode_fold(port, recs[lo:hi])
        jax_encode_fold(jax_rep, recs[lo:hi])
        fold_jobs_overlay([(port, None)])
        jfold.fold_jobs_overlay([(jax_rep, None)], interpret=True)
        assert port.window == jax_rep.window
        windows.append(port.window)
        got = interop.table_to_numpy(port.table)
        m = int(got["n_rows"])
        assert m == int(jax_rep.table.n_rows)
        for f in TABLE_FIELDS:
            np.testing.assert_array_equal(
                got[f][:m], np.asarray(getattr(jax_rep.table, f))[:m])
        for f in ("settled_len", "error"):
            assert int(got[f]) == int(getattr(jax_rep.table, f))
        for a, b in ((port.settled_t, jax_rep.settled_t),
                     (port.settled_p, jax_rep.settled_p),
                     (port.settled_a, jax_rep.settled_a)):
            np.testing.assert_array_equal(a, b)
    assert windows == [1024, 2048, 3072]
    msn = max(r["msn"] for r in recs)
    assert port.canonical_rows(msn) == jax_rep.canonical_rows(msn)


def test_pad_window_keeps_sentinels_like_ensure_window():
    recs = build_mergetree_stream(40, n_clients=3, seed=5)
    port = boot_overlay([], 0, device="cpu")
    jax_rep = jfold.boot_overlay([], 0, interpret=True)
    _encode_fold(port, recs)
    jax_encode_fold(jax_rep, recs)
    fold_jobs_overlay([(port, None)])
    jfold.fold_jobs_overlay([(jax_rep, None)], interpret=True)
    port.table = pad_window(port.table, 3072)
    jax_rep._ensure_window(3000)
    got = interop.table_to_numpy(port.table)
    for f in got:
        np.testing.assert_array_equal(
            got[f], np.asarray(getattr(jax_rep.table, f)), err_msg=f)
    with pytest.raises(ValueError, match="multiple of 1024"):
        pad_window(port.table, 2048)
    with pytest.raises(ValueError, match="multiple of 1024"):
        pad_window(port.table, 5000)
