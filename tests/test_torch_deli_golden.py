"""deli_golden.json stays the reference's answer, and the port meets it.

`fluidframework_tpu_torch/testing/deli_golden.json` (written by
tools/deli_golden.py with the JAX package's scalar `DeliLambda`) pins
the digests of BASELINE config 5's stream (10,000 documents x 64
clients x 1 op, pumps of 16384 records); the card is held to it
without JAX. Here, on the CPU, the first 4 pumps (65,536 records)
are recomputed with the JAX scalar deli and with the port's
`KernelDeliLambda(device="cpu")`: both must give the file's
``pump4_sha256``, so the file cannot drift from the reference.
"""

import json
import os

import pytest
import torch

import fluidframework_tpu_torch.testing as port_testing
from fluidframework_tpu.server.lambdas import DeliLambda
from fluidframework_tpu.server.log import MessageLog as JaxLog
from fluidframework_tpu_torch.server.deli_kernel import KernelDeliLambda
from fluidframework_tpu_torch.server.log import MessageLog
from fluidframework_tpu_torch.testing.deli_streams import (
    StreamDigest,
    build_pipeline_workload,
    to_inproc,
)

GOLDEN = os.path.join(os.path.dirname(port_testing.__file__),
                      "deli_golden.json")


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def prefix(golden):
    p = golden["params"]
    n = p["prefix_pumps"] * p["max_pump"]
    return to_inproc(build_pipeline_workload(
        p["n_docs"], p["n_clients"], p["ops_per_client"], seed=p["seed"],
        limit=n))


def test_golden_parameters(golden):
    p = golden["params"]
    assert (p["n_docs"], p["n_clients"], p["ops_per_client"]) == \
        (10_000, 64, 1)
    assert (p["records"], p["max_pump"], p["pumps"]) == \
        (1_280_000, 16384, 79)
    assert golden["stamps"] == 1_280_000 and golden["nacks"] == 0
    for key in ("deltas_sha256", "checkpoint_sha256", "pump4_sha256"):
        assert len(golden[key]) == 64


@pytest.mark.parametrize("impl", ["jax_scalar", "port_cpu"])
def test_first_four_pumps_meet_the_golden(golden, prefix, impl):
    p = golden["params"]
    if impl == "jax_scalar":
        log = JaxLog()
        deli = DeliLambda(log, max_pump=p["max_pump"])
    else:
        log = MessageLog()
        deli = KernelDeliLambda(log, max_pump=p["max_pump"], device="cpu")
    log.topic("rawdeltas").append_many(prefix)
    pumps = 0
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        while deli.pump():
            pumps += 1
    finally:
        torch.set_num_threads(threads)
    assert pumps == p["prefix_pumps"]
    digest = StreamDigest().update(log.topic("deltas").read(0))
    assert (digest.stamps, digest.nacks) == (len(prefix), 0)
    assert digest.hexdigest() == golden["pump4_sha256"]
    if impl == "port_cpu":
        pool = deli.core.pool
        assert (pool.n_docs, pool.chunks, pool.max_cols_seen) == \
            (16384, 4, 8)
