"""`fluidframework_tpu_torch/testing/deli_role_golden.json` against the
port's role on the CPU and against the JAX package.

The golden file comes from the JAX scalar `DeliRole` over all 1,280,000
records of BASELINE config 5 (`tools/deli_role_golden.py`, ~90 s here);
the card's smoke (phase 28) gates the whole run on it. Here, at a size
the CPU takes in seconds: its parameters are the workload's, and the
first 4 pumps (65,536 records) through the port's `KernelDeliRole`
(device="cpu", batch 16384) on columnar and on JSON topics, and through
the JAX scalar role, give its prefix digest and counts.
"""

import json
import os

import pytest
import torch

from fluidframework_tpu.server.supervisor import DeliRole
from fluidframework_tpu.testing.deli_bench import (
    build_pipeline_workload as jax_workload,
)
from fluidframework_tpu_torch.server.columnar_log import make_tail_reader, \
    make_topic
from fluidframework_tpu_torch.server.deli_kernel import KernelDeliRole
from fluidframework_tpu_torch.testing.deli_streams import (
    RoleDigest,
    build_pipeline_workload,
    write_raw_topic,
)

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "fluidframework_tpu_torch", "testing",
    "deli_role_golden.json")


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prefix(golden):
    p = golden["params"]
    return build_pipeline_workload(
        p["n_docs"], p["n_clients"], p["ops_per_client"], seed=p["seed"],
        limit=p["prefix_pumps"] * p["frame"])


def _digest(shared, fmt, cut):
    dg = RoleDigest(prefix_off=cut)
    reader = make_tail_reader(make_topic(
        os.path.join(shared, "topics", "deltas.jsonl"), fmt), 0)
    while True:
        got = reader.poll(16384)
        if not got:
            return dg
        dg.update(r for _, r in got)


def test_golden_params_are_the_workloads(golden):
    p = golden["params"]
    assert (p["n_docs"], p["n_clients"], p["ops_per_client"], p["seed"],
            p["batch"], p["frame"]) == (10_000, 64, 1, 5, 16384, 16384)
    assert p["records"] == 10_000 * 64 * 2
    assert p["steps"] == -(-p["records"] // p["frame"])
    assert golden["counts"] == {"ops": 640_000, "joins": 640_000,
                                "leaves": 0, "nacks": 0}
    # the port's workload copy is the reference's, record for record
    cut = p["prefix_pumps"] * p["frame"]
    assert build_pipeline_workload(p["n_docs"], p["n_clients"],
                                   p["ops_per_client"], seed=p["seed"],
                                   limit=cut) == \
        jax_workload(p["n_docs"], p["n_clients"],
                     p["ops_per_client"], seed=p["seed"])[:cut]


@pytest.mark.parametrize("impl,fmt", [("port", "columnar"), ("port", "json"),
                                      ("scalar", "columnar")])
def test_prefix_meets_golden(golden, impl, fmt, tmp_path):
    p = golden["params"]
    recs = _prefix(golden)
    cut = len(recs)
    shared = str(tmp_path)
    write_raw_topic(shared, recs, p["frame"], fmt)
    if impl == "port":
        role = KernelDeliRole(shared, owner="t", ttl_s=3600.0,
                              batch=p["batch"], log_format=fmt, device="cpu")
    else:
        role = DeliRole(shared, owner="s", ttl_s=3600.0, batch=p["batch"],
                        log_format=fmt)
    while role.step():
        pass
    dg = _digest(shared, fmt, cut)
    assert dg.hexdigest() == dg.prefix_hexdigest() == golden["prefix_sha256"]
    assert dg.counts == {"ops": cut // 2, "joins": cut // 2, "leaves": 0,
                         "nacks": 0}
    if impl == "port":
        assert role.core.pool.chunks == p["prefix_pumps"]
        assert role.planned == {"run": 0, "record": cut}
