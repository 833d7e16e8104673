"""tree_golden.json stays the reference's answer, and the port meets it.

`fluidframework_tpu_torch/testing/tree_golden.json` (written by
tools/tree_golden.py with the JAX package's `rebase_ops_columnar`) pins
the digests and counts of BASELINE config 4's rebase (100,000 pending
ops over a 64-op trunk window, seed 4); the card is held to it without
JAX. Here, on the CPU, config 4 is recomputed by the JAX package and by
the port's `rebase_ops_columnar(device="cpu")` (`run_config4`): both
must give the file's digests and counts, so the file cannot drift from
the reference.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from fluidframework_tpu.tree.rebase_kernel import rebase_ops_columnar
from fluidframework_tpu_torch.testing import tree_streams as ts


@pytest.fixture(scope="module")
def golden():
    return ts.load_tree_golden()


def _check(golden, out):
    for key, digest in ts.digests(*out).items():
        assert digest == golden[f"{key}_sha256"], key
    assert ts.rebase_counts(*out) == {
        k: golden[k] for k in ("flagged", "native_splits", "muted")}


def test_golden_parameters(golden):
    p = golden["params"]
    assert (p["pending_ops"], p["window"], p["seed"], p["scale"]) == \
        (100_000, 64, 4, 1.0)
    ops, base = ts.config4_inputs()
    assert ops.shape == (100_000, 4) and base.shape == (64, 4)
    assert ops.dtype == base.dtype == np.int32
    for key in ("rebased_sha256", "spares_sha256", "flagged_sha256"):
        assert len(golden[key]) == 64
    # config 4 flags a handful of ops for the scalar path
    assert 0 < golden["flagged"] < 100


def test_config4_draw_is_the_tools(monkeypatch):
    """The port's `config4_inputs` draws what the reference's tool
    (tools/bench_configs.py `config4_tree_rebase`, at BC_SCALE 1) hands
    to `rebase_ops_columnar`: the tool runs with that call captured and
    its timing runner stubbed out."""
    import fluidframework_tpu.tree.rebase_kernel as jrk
    import fluidframework_tpu.utils.benchmark as jbench

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "bench_configs.py")
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    spec = importlib.util.spec_from_file_location("_bench_configs", path)
    bc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bc)
    monkeypatch.setattr(bc, "SCALE", 1.0)
    seen = []

    def capture(ops, base):
        seen.append((ops.copy(), base.copy()))
        n = ops.shape[0]
        return (np.zeros((n, 4), np.int32), np.zeros((n, 3), np.int32),
                np.zeros(n, bool))

    def run_once(workload, **kw):
        workload()
        return {"mean": 1.0}

    monkeypatch.setattr(jrk, "rebase_ops_columnar", capture)
    monkeypatch.setattr(jbench, "run_benchmark", run_once)
    bc.config4_tree_rebase()
    assert len(seen) == 1
    ops, base = ts.config4_inputs()
    for got, want in zip(seen[0], (ops, base)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("impl", ["jax", "port_cpu"])
def test_config4_meets_the_golden(golden, impl):
    if impl == "jax":
        _check(golden, rebase_ops_columnar(*ts.config4_inputs()))
        return
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        run = ts.run_config4("cpu")
    finally:
        torch.set_num_threads(threads)
    _check(golden, run["outputs"])
    assert run["digests"] == {k: golden[f"{k}_sha256"]
                              for k in ("rebased", "spares", "flagged")}
    assert set(run["stage_seconds"]) == {"upload", "launch", "read",
                                         "sequentialize"}
    assert run["op_rebases_per_sec"] > 0
    assert (run["pending_ops"], run["window"]) == (100_000, 64)


def test_array_digest_sees_dtype_and_shape():
    a = np.arange(6, dtype=np.int32)
    assert ts.array_digest(a) != ts.array_digest(a.reshape(2, 3))
    assert ts.array_digest(a) != ts.array_digest(a.astype(np.int64))
    assert ts.array_digest(a) == ts.array_digest(a.copy())
