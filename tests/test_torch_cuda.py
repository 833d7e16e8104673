"""The overlay CUDA kernel against its plain PyTorch version, on the card.

Marked ``cuda``: on a host without a CUDA device every test here skips
with the reason. On the GPU run them with

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

(``--noconftest``: the repository's conftest imports JAX, which the
GPU host need not have; this file imports only the port.)
"""

import pytest
import torch

from fluidframework_tpu_torch.core.overlay_replay import OverlayDeviceReplica
from fluidframework_tpu_torch.ops import overlay as tov
from fluidframework_tpu_torch.testing.digest import state_digest
from fluidframework_tpu_torch.testing.synthetic import generate_lagged_stream
from fluidframework_tpu_torch.utils.devices import cuda_skip_reason

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    reason = cuda_skip_reason()
    if reason:
        pytest.skip(reason)
    return torch.device("cuda")


def _stream():
    return generate_lagged_stream(3000, n_clients=64, seed=5, window=512,
                                  initial_len=64)


@pytest.mark.parametrize("window,n_removers", [(1024, 8), (2048, 24),
                                               (4096, 4)])
def test_kernel_matches_plain_per_chunk(cuda, window, n_removers):
    rep = OverlayDeviceReplica(_stream(), initial_len=64, chunk_size=256,
                               window=window, n_removers=n_removers,
                               device=cuda)
    rep.prepare()
    table = rep.table
    for ci in range(rep.n_chunks):
        ops = rep._dev.slice(ci * 256, (ci + 1) * 256)
        got = tov.overlay_chunk_kernel(table, ops)
        want = tov.overlay_apply_chunk_ref(table, ops)
        m = int(want.n_rows)
        assert int(got.n_rows) == m and int(got.error) == int(want.error)
        for f in ("anchor", "buf_start", "length", "ins_seq", "ins_client",
                  "rem_seq", "rem_clients", "props"):
            assert torch.equal(getattr(got, f)[:m], getattr(want, f)[:m]), f
        table, _, _ = tov.fold_device(got, rep._msn_by_chunk[ci])


def test_cuda_replay_matches_cpu_replay(cuda):
    stream = _stream()
    kw = dict(initial_len=64, chunk_size=256, window=2048, n_removers=24)
    gpu = OverlayDeviceReplica(stream, device=cuda, **kw)
    before = tov.overlay_chunk_kernel.launches
    gpu.replay()
    assert tov.overlay_chunk_kernel.launches - before == gpu.n_chunks
    cpu = OverlayDeviceReplica(stream, device="cpu", **kw)
    cpu.replay()
    assert int(gpu.cursor) == int(cpu.cursor)
    assert state_digest(gpu.annotated_spans()) == state_digest(
        cpu.annotated_spans())
