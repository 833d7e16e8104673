"""`fluidframework_tpu_torch/testing/summary_role_golden.json` against
config10's workload, the JAX package and the port on the CPU.

The golden file comes from the JAX `SummarizerRole` and readers over
config10's whole catch-up sweep (`tools/summary_role_golden.py`, ~11
minutes on three CPU cores); the card's smoke (phase 29) gates every
length on it. Here, at a size the CPU takes in seconds: its parameters
are config10's (`run_catchup_bench`'s defaults and cadence clamp, the
stream's generator defaults), and the first summary's prefix (2000 ops
and the joins), through the JAX role as the tool drives it and through
the port's role on both fold backends, gives the golden's first
manifest on both topic formats, and the two cold replays one digest.
"""

import inspect
import json
import os

import pytest
import torch

from fluidframework_tpu.server.summarizer import (
    SummaryReplica as JaxReplica,
)
from fluidframework_tpu.testing import deli_bench
from fluidframework_tpu_torch.server.summarizer import SummaryReplica
from fluidframework_tpu_torch.testing import catchup_streams as cs
from fluidframework_tpu_torch.testing.fold_streams import (
    build_mergetree_stream,
)

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "fluidframework_tpu_torch", "testing",
    "summary_role_golden.json")
TOOL = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools", "summary_role_golden.py")


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def tool():
    import importlib.util

    spec = importlib.util.spec_from_file_location("summary_role_golden",
                                                  TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _defaults(fn):
    return {k: v.default for k, v in inspect.signature(fn).parameters.items()
            if v.default is not inspect.Parameter.empty}


def test_golden_params_are_config10(golden):
    p = golden["params"]
    bench = _defaults(deli_bench.run_catchup_bench)
    gen = _defaults(deli_bench.build_mergetree_stream)
    assert tuple(p["log_lengths"]) == bench["log_lengths"] == cs.LOG_LENGTHS
    assert p["n_clients"] == bench["n_clients"] == cs.N_CLIENTS
    # the bench's clamp leaves the cadence at full scale
    assert p["summary_ops"] == bench["summary_ops"] == cs.SUMMARY_OPS == \
        cs.catchup_summary_ops(bench["summary_ops"], p["log_lengths"][0])
    assert (p["seed"], p["window"], p["target_len"]) == (
        gen["seed"], gen["window"], gen["target_len"])
    assert _defaults(deli_bench._drive_summarizer)["batch"] == p["batch"]
    assert (p["fold_backend"], p["formats"]) == ("kernel",
                                                 ["json", "columnar"])
    for fmt in p["formats"]:
        for L in p["log_lengths"]:
            r = golden["runs"][fmt][str(L)]
            mans = r["manifests"]
            assert len(mans) == (L + p["n_clients"]) // p["summary_ops"]
            assert [m["count"] for m in mans] == [
                p["summary_ops"] * (i + 1) for i in range(len(mans))]
            assert r["summary_seq"] == mans[-1]["seq"]
            assert r["tail_ops"] == L + p["n_clients"] - mans[-1]["count"]
            assert all(m["byteOff"] is None and m["byteTopic"] == "deltas"
                       for m in mans)
        # the shorter lengths' manifests are the longest's prefix
        full = golden["runs"][fmt][str(p["log_lengths"][-1])]["manifests"]
        for L in p["log_lengths"]:
            mans = golden["runs"][fmt][str(L)]["manifests"]
            assert mans == full[:len(mans)]
    assert golden["runs"]["json"] == golden["runs"]["columnar"]
    # the port's stream copy is the reference's, record for record
    n = p["summary_ops"]
    assert build_mergetree_stream(n, n_clients=p["n_clients"]) == \
        deli_bench.build_mergetree_stream(n, n_clients=p["n_clients"])


@pytest.fixture(scope="module")
def prefix(golden):
    p = golden["params"]
    return build_mergetree_stream(
        p["summary_ops"], n_clients=p["n_clients"], seed=p["seed"],
        window=p["window"], target_len=p["target_len"])


@pytest.mark.parametrize("fmt", ["json", "columnar"])
def test_jax_prefix_meets_golden(golden, tool, prefix, fmt, tmp_path):
    """The tool's JAX path on the first summary's prefix."""
    got = tool.summarize(str(tmp_path), prefix, fmt)
    first = golden["runs"][fmt][str(golden["params"]["log_lengths"][0])]
    assert got == first["manifests"][:1]


@pytest.mark.parametrize("backend", ["kernel", "overlay"])
@pytest.mark.parametrize("fmt", ["json", "columnar"])
def test_port_prefix_meets_golden(golden, prefix, fmt, backend, tmp_path):
    p = golden["params"]
    cs.write_deltas(str(tmp_path), prefix, fmt, frame=p["append"])
    run = cs.drive_summarizer(str(tmp_path), fmt, p["summary_ops"],
                              batch=p["batch"], device="cpu",
                              fold_backend=backend)
    first = golden["runs"][fmt][str(p["log_lengths"][0])]
    assert cs.manifests_of(str(tmp_path), fmt) == first["manifests"][:1]
    assert run["summaries"] == 1 and run["records"] == len(prefix)


def test_prefix_replays_agree(prefix):
    port = SummaryReplica(None, device="cpu")
    port.apply_records(prefix)
    jax = JaxReplica(None)
    jax.apply_records(prefix)
    assert port.state_digest() == jax.state_digest()
