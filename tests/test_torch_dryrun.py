"""The port's multi-device dry run on 8 CPU entries.

`parallel.dryrun.dryrun_multichip` runs every section of the
reference's ``__graft_entry__._dryrun_impl`` (one document per entry,
four per entry chained behind the sequencer, one document
sequence-sharded over every entry, the row model's pipeline step) and
asserts each digest equal to its single-entry run. Here it runs at
scale 0.25 on ``device="cpu"``; the sequence-sharded section's digest
is also held against the JAX package's single-document engine on the
same stream.
"""

import pytest
import torch

from fluidframework_tpu.ops.overlay_ref import OverlayReplica
from fluidframework_tpu.testing.digest import state_digest as jax_digest
from fluidframework_tpu.testing.synthetic import generate_lagged_stream
from fluidframework_tpu_torch.parallel import dryrun


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_dryrun_8_cpu_entries_scale_quarter():
    report = dryrun.dryrun_multichip(8, device="cpu", scale=0.25)
    assert report["entries"] == 8
    assert report["mesh"]["size"] == 8 and report["mesh"]["cards"] == ["cpu"]
    one, multi = report["one_doc"], report["multi_doc"]
    assert (one["docs"], one["ops"], one["chunks"]) == (8, 256, 2)
    assert (multi["docs"], multi["ops"], multi["chunks"]) == (32, 128, 1)
    for sec in (one, multi, report["pipeline"]):
        assert sec["gerr"] == 0
        # Plain versions on the CPU: no wrapper launches a kernel.
        assert set(sec["launches"].values()) == {0}
    assert report["pipeline"]["docs"] == 16
    seq = report["seqshard"]
    assert seq["gerr"] == 0 and seq["ops"] == 64
    stream = generate_lagged_stream(64, n_clients=8, seed=991, window=64,
                                    initial_len=16)
    ref = OverlayReplica(stream, initial_len=16, fold_interval=1 << 30,
                         n_removers=dryrun.KR)
    ref.replay()
    assert seq["digest"] == jax_digest(ref.annotated_spans())


def test_dryrun_needs_cuda_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun_multichip(2)
