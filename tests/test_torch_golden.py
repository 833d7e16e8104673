"""The port's GOLDEN.json helpers and its op-segment upload.

`fluidframework_tpu_torch.testing.golden` against GOLDEN.json and the
JAX package's stream generator, and `ColumnarReplica.op_segment`
padding a range longer than one segment to whole segments.
"""

import json

import numpy as np
import pytest

from fluidframework_tpu.testing.synthetic import generate_lagged_stream
from fluidframework_tpu_torch import interop
from fluidframework_tpu_torch.core import columnar_replay
from fluidframework_tpu_torch.ops.mergetree_kernel import (
    NO_CLIENT,
    NO_KEY,
    OP_NOOP,
    PROP_ABSENT,
)
from fluidframework_tpu_torch.testing import golden as g
from fluidframework_tpu_torch.testing.synthetic import ColumnarStream


def test_golden_file_and_digests():
    data = g.load_golden()
    with open(g.GOLDEN_PATH) as f:
        assert data == json.load(f)
    n = data["params"]["n_ops"]
    stages = data["chain"]["native_stage_digests"]
    assert g.golden_digest(data, n) == data["digest"]
    assert g.golden_digest(data, 100_000) == stages["100000"]
    assert g.golden_digest(data, 12_345) is None


@pytest.mark.parametrize("n_ops", [0, 37, 500])
def test_stream_prefix(n_ops):
    full = interop.stream_from_numpy(generate_lagged_stream(
        500, n_clients=16, seed=3, window=64, initial_len=8))
    pre = g.stream_prefix(full, n_ops)
    assert isinstance(pre, ColumnarStream) and len(pre) == n_ops
    assert pre.text is full.text
    for f in ("op_type", "pos1", "pos2", "seq", "ref_seq", "client",
              "buf_start", "ins_len", "prop_key", "prop_val", "min_seq"):
        np.testing.assert_array_equal(getattr(pre, f),
                                      getattr(full, f)[:n_ops], err_msg=f)


def test_op_segment_pads_to_whole_segments(monkeypatch):
    monkeypatch.setattr(columnar_replay, "SEG_OPS", 256)
    stream = interop.stream_from_numpy(generate_lagged_stream(
        700, n_clients=16, seed=4, window=64, initial_len=8))
    rep = columnar_replay.ColumnarReplica(
        stream, initial_len=8, chunk_size=128, capacity=1024, device="cpu")
    ops = rep.op_segment(100, 700)
    assert ops.op_type.shape == (768,)
    assert ops.prop_keys.shape == (768, 1)
    np.testing.assert_array_equal(ops.op_type[:600].numpy(),
                                  stream.op_type[100:700])
    np.testing.assert_array_equal(
        ops.buf_start[:600].numpy(),
        stream.buf_start[100:700] + columnar_replay.STREAM_BASE)
    for col, fill in ((ops.op_type, OP_NOOP), (ops.client, NO_CLIENT),
                      (ops.prop_keys[:, 0], NO_KEY),
                      (ops.prop_vals[:, 0], PROP_ABSENT), (ops.pos1, 0)):
        assert bool((col[600:] == fill).all())
