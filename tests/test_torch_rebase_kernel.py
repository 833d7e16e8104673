"""The port's batched rebase against the JAX package's, on the CPU.

The same inputs (numpy, from seeds) go through the JAX
`fluidframework_tpu.tree.rebase_kernel` and the port's
`fluidframework_tpu_torch.tree.rebase_kernel`, tolerance 0:

- the helpers `_attach_gap`, `_gap_over` and `_remove_over_rm` on grids
  of small values;
- `rebase_batch_ref` against the JAX `rebase_batch`: all eight outputs
  and their dtypes, on the 20 differential streams of
  tests/test_tree_depth.py, the kernel's edge set and config 4 whole;
- the port's `rebase_ops_columnar(device="cpu")` against the JAX one on
  the same inputs;
- on the 20 streams' unflagged ops, the port against the scalar
  `changeset.rebase_change`, piece by piece;
- `warp_steps`, the count of the kernel's warps by the step they run
  under its grouping of a block's ops by kind;
- the tables of `chip_smoke.py` that bound the kernel's operations.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidframework_tpu.tree import rebase_kernel as jrk
from fluidframework_tpu.tree.changeset import (
    insert_op,
    move_op,
    rebase_change,
    remove_op,
)
from fluidframework_tpu_torch.tree import rebase_kernel as prk
from fluidframework_tpu_torch.testing import tree_streams as ts

STREAMS = {name: (ops, base) for name, ops, base in ts.all_streams()}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def config4():
    return ts.config4_inputs()


def _inputs(name, config4):
    return config4 if name == "config4" else STREAMS[name]


def _columns(ops, base):
    ops, base = prk._pad(ops), prk._pad(base)
    return [ops[:, j] for j in range(4)] + [base[:, j] for j in range(4)]


@pytest.mark.parametrize("bk", [-1, 0, 1, 2, 3])
def test_helpers_match_jax(bk):
    vals = np.arange(-2, 9, dtype=np.int32)
    grid = np.array(list(itertools.product(vals, repeat=3)), np.int32)
    g = grid[:, 0]
    for bi, bn, bj in itertools.product((0, 2, 5), (0, 1, 3), (-1, 0, 3, 7)):
        tb = [torch.tensor(v, dtype=torch.int32) for v in (bk, bi, bn, bj)]
        jb = [jnp.int32(v) for v in (bk, bi, bn, bj)]
        jg = jrk._attach_gap(*jb[1:])
        pg = prk._attach_gap(*tb[1:])
        assert pg.dtype == torch.int32 and int(pg) == int(jg)
        got = prk._gap_over(torch.from_numpy(g), tb[0], tb[1], tb[2], pg)
        want = np.asarray(jrk._gap_over(jnp.asarray(g), *jb[:3], jg))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        gi, gc = prk._remove_over_rm(torch.from_numpy(grid[:, 1]),
                                     torch.from_numpy(grid[:, 2]), tb[1],
                                     tb[2])
        wi, wc = jrk._remove_over_rm(jnp.asarray(grid[:, 1]),
                                     jnp.asarray(grid[:, 2]), jb[1], jb[2])
        assert gi.dtype == gc.dtype == torch.int32
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))


@pytest.mark.parametrize("name", list(STREAMS) + ["config4"])
def test_rebase_batch_ref_matches_jax(name, config4):
    cols = _columns(*_inputs(name, config4))
    want = jrk.rebase_batch(*(jnp.asarray(c) for c in cols))
    ins = [torch.from_numpy(c.copy()) for c in cols]
    got = prk.rebase_batch_ref(*ins)
    assert len(got) == len(want) == 8
    for field, a, b in zip(prk.OUT_FIELDS, got, want):
        b = np.asarray(b)
        assert a.dtype == (torch.bool if b.dtype == bool else torch.int32)
        assert a.numpy().dtype == b.dtype, field
        np.testing.assert_array_equal(a.numpy(), b, err_msg=field)
    # functional: the inputs are left as they were
    for t, c in zip(ins, cols):
        np.testing.assert_array_equal(t.numpy(), c)


@pytest.mark.parametrize("name", list(STREAMS) + ["config4"])
def test_rebase_ops_columnar_matches_jax(name, config4):
    ops, base = _inputs(name, config4)
    want = jrk.rebase_ops_columnar(ops, base)
    got = prk.rebase_ops_columnar(ops, base, device="cpu")
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_edge_set_covers_its_cases():
    """The edge set holds what it is named for."""
    assert STREAMS["window_0"][1].shape[0] == 0
    assert STREAMS["branch_0"][0].shape[0] == 0
    assert STREAMS["ragged_301"][0].shape[0] % prk.THREADS != 0
    assert STREAMS["long_window"][1].shape[0] > 4 * prk.TILE
    ops, base = STREAMS["moves_only"]
    assert (ops[:, 0] == prk.K_MOVE).all() and (base[:, 0] == prk.K_MOVE).all()
    for a in (ops, base):
        noop = (a[:, 1] <= a[:, 3]) & (a[:, 3] <= a[:, 1] + a[:, 2])
        assert 0 < noop.sum() < len(a)
    rebased, spares, flagged = prk.rebase_ops_columnar(
        *STREAMS["double_split"], device="cpu")
    act = spares[:, 2] > 0
    assert (act & ~flagged).sum() > 0  # the spare taken, no second split
    assert (act & flagged).sum() > 0  # a second split flagged
    ops, base = STREAMS["odd_kinds"]
    assert not np.isin(ops[:, 0], (0, 1, 2)).all()
    assert not np.isin(base[:, 0], (0, 1, 2)).all()
    ops, base = STREAMS["int32_ends"]
    for a in (ops, base):
        assert (a[:, 1] > 2**31 - 50).any() and (a[:, 1] < -2**31 + 50).any()
    rebased, _, _ = prk.rebase_ops_columnar(ops, base, device="cpu")
    # some positions wrap past an end of int32, as the reference's do
    assert ((ops[:, 1] > 0) & (rebased[:, 1] < 0)).any()
    # one kind only, over several blocks: no warp runs the generic step
    for name, kind in (("inserts_only", prk.K_INSERT),
                       ("removes_only", prk.K_REMOVE)):
        ops, base = STREAMS[name]
        assert (ops[:, 0] == kind).all() and ops.shape[0] > 2 * prk.THREADS
        assert len(np.unique(base[:, 0])) == 3
        steps = prk.warp_steps(ops[:, 0])
        assert steps["generic"] == 0
        assert steps[prk.WARP_STEPS[kind]] == -(-ops.shape[0] // prk.WARP)
    _, spares, flagged = prk.rebase_ops_columnar(*STREAMS["removes_only"],
                                                 device="cpu")
    assert ((spares[:, 2] > 0) & ~flagged).any()  # the spare taken
    # runs of 31, 33 and a block and one of each kind: run edges inside
    # warps, runs across block edges, every step run
    kinds = STREAMS["kind_runs"][0][:, 0]
    edges = np.flatnonzero(np.diff(kinds)) + 1
    runs = np.diff(np.concatenate([[0], edges, [len(kinds)]]))
    assert sorted(runs) == sorted(ts.KIND_RUNS * 3)
    assert set(kinds[np.concatenate([[0], edges])]) == {0, 1, 2}
    assert (edges % prk.WARP != 0).sum() >= len(edges) - 1
    assert any(a // prk.THREADS != (b - 1) // prk.THREADS
               for a, b in zip(np.concatenate([[0], edges]),
                               np.concatenate([edges, [len(kinds)]])))
    assert all(v > 0 for v in prk.warp_steps(kinds).values())
    # branches of 1, 31, 33 and a block and one ops
    for n in (1, 31, 33, prk.THREADS + 1):
        ops, base = STREAMS[f"n_{n}"]
        assert ops.shape[0] == n and base.shape[0] > 0
    # kinds outside 0..2 among one warp's lanes, beside kinds 0..2
    kinds = STREAMS["odd_in_warp"][0][:, 0]
    for w0 in range(0, 96, prk.WARP):
        w = kinds[w0:w0 + prk.WARP]
        assert np.isin(w, (0, 1, 2)).any() and not np.isin(w, (0, 1, 2)).all()
    assert prk.warp_steps(kinds)["generic"] == len(kinds) // prk.WARP


def test_warp_steps():
    """The kernel's step per warp: ops ordered stably by class within
    each block, one kind's step for a warp of one kind of 0..2, the
    generic step otherwise."""
    zero = dict.fromkeys(prk.WARP_STEPS, 0)
    assert prk.warp_steps([]) == zero
    assert prk.warp_steps([0] * 256) == {**zero, "insert": 8}
    # 100 inserts, 100 removes, 56 moves: warps 3 and 6 straddle an edge
    kinds = [0] * 100 + [1] * 100 + [2] * 56
    want = {"insert": 3, "remove": 2, "move": 1, "generic": 2}
    assert prk.warp_steps(kinds) == want
    # the order within a block does not matter, the block does
    rng = np.random.default_rng(0)
    assert prk.warp_steps(rng.permutation(kinds)) == want
    assert prk.warp_steps(kinds, block=128) == {
        "insert": 3, "remove": 2, "move": 1, "generic": 2}
    assert prk.warp_steps([0] * 300) == {**zero, "insert": 10}
    # kinds outside 0..2 run the generic step, alone or among others
    assert prk.warp_steps([5] * 32) == {**zero, "generic": 1}
    assert prk.warp_steps([0] * 31 + [-1]) == {**zero, "generic": 1}
    assert prk.warp_steps([1] * 32 + [3] * 32) == {
        **zero, "remove": 1, "generic": 1}
    # config 4: every block's warps, at most three of eight generic
    ops, _ = ts.config4_inputs()
    steps = prk.warp_steps(ops[:, 0])
    blocks = -(-len(ops) // prk.THREADS)
    assert sum(steps.values()) == -(-len(ops) // prk.WARP)
    assert 0 < steps["generic"] <= 3 * blocks
    assert min(steps[k] for k in ("insert", "remove", "move")) > 0


def test_operations_bound_tables():
    """The kernel's operations bound: every (base code, pending kind)
    entry of REBASE_OPS has its ALU-only part in REBASE_ALU_OPS, never
    more than the entry; an identity base move costs nothing; at config
    4's inputs the ALU's share, over its half of the issue rate, takes
    longer than the whole at the issue rate."""
    import chip_smoke as cs

    assert cs.REBASE_ALU_OPS.keys() == cs.REBASE_OPS.keys()
    for code, row in cs.REBASE_OPS.items():
        alu = cs.REBASE_ALU_OPS[code]
        assert alu.keys() == row.keys() == {0, 1, 2, -1}
        assert all(0 <= alu[k] <= v for k, v in row.items())
    assert not any(cs.REBASE_OPS["noop"].values())
    assert cs.PEAK_ISSUE_S == 2 * cs.PEAK_OPS_S
    ops, base = ts.config4_inputs()
    codes = [("insert", "remove", "move")[k] for k in base[:, 0]]
    kinds = [int((ops[:, 0] == k).sum()) for k in (0, 1, 2)]
    alu, total = (sum(t[c][k] * nk for c in codes
                      for k, nk in zip((0, 1, 2), kinds))
                  for t in (cs.REBASE_ALU_OPS, cs.REBASE_OPS))
    assert 0.5 < alu / total < 1


def test_window_0_gives_the_inputs_back():
    ops, base = STREAMS["window_0"]
    cols = [torch.from_numpy(c.copy()) for c in _columns(ops, base)]
    k, i, c, d, si, sc, sa, f = prk.rebase_batch(*cols)
    for got, col in zip((k, i, c, d), cols[:4]):
        assert torch.equal(got, col) and got.data_ptr() != col.data_ptr()
    assert not si.any() and not sc.any() and not sa.any() and not f.any()


def test_rebase_batch_out_and_dtypes():
    """`rebase_batch` on CPU tensors fills an `alloc_result` buffer, and
    refuses columns that are not int32."""
    ops, base = STREAMS["moves_3"]
    cols = [torch.from_numpy(c.copy()) for c in _columns(ops, base)]
    buf, out = prk.alloc_result(ops.shape[0], "cpu")
    got = prk.rebase_batch(*cols, out=out)
    want = prk.rebase_batch_ref(*cols)
    for a, b, r in zip(got, want, prk.read_result(buf, ops.shape[0])):
        assert a.dtype == b.dtype and torch.equal(a, b)
        np.testing.assert_array_equal(r, b.numpy())
    with pytest.raises(ValueError, match="int32"):
        prk.rebase_batch(*(c.long() for c in cols))
    with pytest.raises(ValueError, match="differ in length"):
        prk.rebase_batch(*cols[:3], cols[3][:-1], *cols[4:])


# ------------------------------------------------ the scalar oracle
# (the helpers of tests/test_tree_depth.py:175-222)

def _col_to_op(row):
    kind, idx, cnt = int(row[0]), int(row[1]), int(row[2])
    dst = int(row[3]) if len(row) > 3 else 0
    if kind == prk.K_INSERT:
        return insert_op([], "f", idx, [{"value": v, "fields": {}}
                                        for v in range(cnt)])
    if kind == prk.K_REMOVE:
        return remove_op([], "f", idx, cnt)
    return move_op([], "f", idx, cnt, [], "f", dst)


def _scalar_rebase(ops, base):
    out = []
    base_ops = [_col_to_op(b) for b in base]
    for row in ops:
        rebased = rebase_change([_col_to_op(row)], base_ops, over_first=True)
        pieces = []
        for r in rebased:
            if r["type"] == "insert":
                pieces.append((prk.K_INSERT, r["index"], len(r["content"])))
            elif r["type"] == "remove":
                if r["count"] > 0:
                    pieces.append((prk.K_REMOVE, r["index"], r["count"]))
            elif r["type"] == "move":
                if r["count"] > 0:
                    pieces.append((prk.K_MOVE, r["index"], r["count"],
                                   r["dst_index"]))
        out.append(pieces)
    return out


def _kernel_pieces(got, spares, n):
    pieces = []
    gk, gi, gc, gd = got[n]
    if gc > 0:
        if gk == prk.K_MOVE:
            pieces.append((int(gk), int(gi), int(gc), int(gd)))
        else:
            pieces.append((int(gk), int(gi), int(gc)))
    sk, si, sc = spares[n]
    if sc > 0:
        pieces.append((int(sk), int(si), int(sc)))
    return pieces


@pytest.mark.parametrize("name", [n for n, _, _ in ts.random_streams()])
def test_port_matches_scalar_rebase(name):
    ops, base = STREAMS[name]
    got, spares, flagged = prk.rebase_ops_columnar(ops, base, device="cpu")
    want = _scalar_rebase(ops, base)
    n_ops = ops.shape[0]
    assert flagged.sum() < (n_ops // 8 if name.startswith("ins_rem")
                            else n_ops // 2)
    checked = 0
    for n in range(n_ops):
        if flagged[n]:
            continue  # rerouted through the scalar path
        checked += 1
        assert _kernel_pieces(got, spares, n) == want[n], (
            f"op {n}: {tuple(ops[n])} -> port "
            f"{_kernel_pieces(got, spares, n)} vs scalar {want[n]}")
    assert checked > n_ops // 2
