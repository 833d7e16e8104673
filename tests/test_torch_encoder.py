"""The port's host op encoder and protocol copies vs the JAX package.

Same inputs through both packages, compared exactly:

- `op_from_json` / `op_to_json` round trips (and their refusals);
- `encode_op` rows, arena and interner state, including an insert and
  an annotate with more than PK prop pairs, a `GroupOp`, a prop
  delete (``None``), and the `TypeError` on an item segment;
- `PropInterner` ids, `decode_row` and the overflow `ValueError`;
- `MessageType` and `SequencedMessage` field for field.
"""

import dataclasses

import numpy as np
import pytest

from fluidframework_tpu.core import kernel_replica as jkr
from fluidframework_tpu.protocol import mergetree_ops as jops
from fluidframework_tpu.protocol import messages as jmsg
from fluidframework_tpu_torch.core import kernel_replica as tkr
from fluidframework_tpu_torch.protocol import mergetree_ops as tops
from fluidframework_tpu_torch.protocol import messages as tmsg

WIRE_OPS = [
    {"type": 0, "pos1": 0, "seg": "hello"},
    {"type": 0, "pos1": 3, "seg": "xy", "props": {"bold": True}},
    {"type": 0, "pos1": 1, "seg": {"marker": 1}},
    {"type": 0, "pos1": 2, "seg": [1, 2, 3], "props": {"k": 1}},
    {"type": 1, "pos1": 1, "pos2": 4},
    {"type": 2, "pos1": 0, "pos2": 5, "props": {"color": "red",
                                               "size": None}},
    {"type": 3, "ops": [
        {"type": 0, "pos1": 0, "seg": "a"},
        {"type": 3, "ops": [{"type": 1, "pos1": 0, "pos2": 1}]},
        {"type": 2, "pos1": 0, "pos2": 1, "props": {"x": [1, {"y": 2}]}},
    ]},
]


@pytest.mark.parametrize("wire", WIRE_OPS)
def test_op_json_round_trip_matches_jax(wire):
    t = tops.op_from_json(wire)
    j = jops.op_from_json(wire)
    assert type(t).__name__ == type(j).__name__
    assert tops.op_to_json(t) == jops.op_to_json(j)
    assert tops.op_from_json(tops.op_to_json(t)) == t
    assert int(t.type) == int(j.type)


@pytest.mark.parametrize("wire,exc", [
    ({"type": 9, "pos1": 0}, ValueError),
    ({"type": 1, "pos1": 0}, KeyError),
    ({"type": 2, "pos1": 0, "pos2": 1}, KeyError),
    ({"pos1": 0}, KeyError),
])
def test_op_from_json_refusals_match_jax(wire, exc):
    with pytest.raises(exc):
        jops.op_from_json(wire)
    with pytest.raises(exc):
        tops.op_from_json(wire)


def test_op_to_json_unknown_op():
    with pytest.raises(TypeError):
        tops.op_to_json(object())


def test_message_copies_match_jax():
    assert [(m.name, m.value) for m in tmsg.MessageType] == [
        (m.name, m.value) for m in jmsg.MessageType]
    tf = [(f.name, repr(f.default)) for f in
          dataclasses.fields(tmsg.SequencedMessage)]
    jf = [(f.name, repr(f.default)) for f in
          dataclasses.fields(jmsg.SequencedMessage)]
    assert tf == jf


# Sequenced ops for the encoder, with more prop pairs than PK = 4 in
# an insert (9) and an annotate (6), deletes among them.
WIDE_INSERT = {"type": 0, "pos1": 0, "seg": "abcdefgh",
               "props": {f"k{i}": (None if i == 4 else i) for i in range(9)}}
WIDE_ANNOTATE = {"type": 2, "pos1": 1, "pos2": 6,
                 "props": {f"k{i}": ("v" if i % 2 else None)
                           for i in range(6)}}
ENCODE_OPS = [
    {"type": 0, "pos1": 0, "seg": "hello world"},
    WIDE_INSERT,
    {"type": 1, "pos1": 2, "pos2": 5},
    WIDE_ANNOTATE,
    {"type": 2, "pos1": 0, "pos2": 3, "props": {"k1": None}},
    {"type": 3, "ops": [
        {"type": 0, "pos1": 4, "seg": "zz", "props": {"k2": {"a": 1}}},
        {"type": 1, "pos1": 0, "pos2": 1},
        {"type": 2, "pos1": 1, "pos2": 3, "props": {"k3": [1, 2]}},
    ]},
    {"type": 0, "pos1": 2, "seg": "q", "props": {"k0": 7, "k5": "x"}},
]


def _encode_all(pkg_ops, pkg_msg, pkg_kr, wires, pk):
    state = pkg_kr.EncoderState(pkg_kr.TextArena(""),
                                pkg_kr.PropInterner(12), pk)
    for i, wire in enumerate(wires):
        op = pkg_ops.op_from_json(wire)
        msg = pkg_msg.SequencedMessage(
            10 + i, 3 + i, 1 + i % 3, i, 9 + i, pkg_msg.MessageType.OP, op)
        pkg_kr.encode_op(state, op, msg)
    return state


@pytest.mark.parametrize("pk", [1, 2, 4])
def test_encode_op_rows_match_jax(pk):
    t = _encode_all(tops, tmsg, tkr, ENCODE_OPS, pk)
    j = _encode_all(jops, jmsg, jkr, ENCODE_OPS, pk)
    assert t._encoded == j._encoded
    assert t._pending_rows_bound == j._pending_rows_bound
    assert t.arena.snapshot() == j.arena.snapshot()
    assert len(t.arena) == len(j.arena)
    assert t.props.key_ids == j.props.key_ids
    assert t.props.values == j.props.values
    # The wide ops split: the insert into one insert row + follow-up
    # annotate rows over exactly the inserted range.
    types = [r[0] for r in t._encoded]
    assert len(t._encoded) > len(ENCODE_OPS)
    assert all(len(r[8]) <= pk for r in t._encoded)
    assert -2 in [v for r in t._encoded for v in r[9]]  # PROP_DELETE
    assert types.count(0) == 4


def test_encode_item_segment_raises_like_jax():
    wire = {"type": 0, "pos1": 0, "seg": {"marker": 1}}
    with pytest.raises(TypeError):
        _encode_all(jops, jmsg, jkr, [wire], 4)
    with pytest.raises(TypeError):
        _encode_all(tops, tmsg, tkr, [wire], 4)


def test_encode_unknown_op_raises():
    state = tkr.EncoderState(tkr.TextArena(""), tkr.PropInterner(4), 4)
    msg = tmsg.SequencedMessage(1, 0, 1, 0, 0)
    with pytest.raises(TypeError, match="unknown op"):
        tkr.encode_op(state, object(), msg)


def test_prop_interner_matches_jax():
    values = [1, "x", None, [1, 2], {"b": 1, "a": 2}, {"a": 2, "b": 1},
              1.5, True, "x", 1]
    ti, ji = tkr.PropInterner(5), jkr.PropInterner(5)
    for k, v in zip("abcdeabcde", values):
        assert ti.key_id(k) == ji.key_id(k)
        assert ti.value_id(v) == ji.value_id(v)
    assert ti.values == ji.values and ti.key_ids == ji.key_ids
    rng = np.random.default_rng(3)
    for _ in range(20):
        row = rng.integers(-1, len(ti.values), size=5).astype(np.int32)
        assert ti.decode_row(row) == ji.decode_row(row)
    assert ti.decode_row(np.full(5, -1, np.int32)) is None
    for interner in (ti, ji):
        with pytest.raises(ValueError, match="more than 5 distinct"):
            interner.key_id("f")


def test_text_arena_matches_jax():
    ta, ja = tkr.TextArena("ab"), jkr.TextArena("ab")
    for s in ("", "cd", "é€😀", "x"):
        assert ta.append(s) == ja.append(s)
    assert ta.snapshot() == ja.snapshot() and len(ta) == len(ja)
    assert tkr.TextArena().snapshot() == jkr.TextArena().snapshot() == ""
