"""The port's sharded deli pool against the JAX package's.

The JAX package shards the ``[D, C]`` sequencer pool with ``shard_map``
over the conftest's virtual CPU devices; the port splits it into
per-entry slabs of a CPU mesh (``device="cpu"``). Same seeded traffic,
tolerance 0:

- `PackedDeliCore` on 2 and 4 entries against the JAX core on
  ``make_docs_mesh(2/4)``: verdicts pump by pump, and the logical slot
  to physical row map (`_phys`) after the pool grows while placed;
- evictions and parks under ``max_resident``;
- a row scatter into a placed pool writes only the slabs that own a
  loaded row;
- the checkpoint stays topology-free: a port 4-entry checkpoint
  restores into the JAX single-device deli and that one's back into a
  port 2-entry deli, bit-identical;
- `KernelDeliLambda(deli_devices=4)` meets deli_golden.json on its
  4-pump prefix;
- `KernelDeliRole(deli_devices=2)` over columnar topics gives the JAX
  role's records (``deli_devices=2`` there too);
- ``deli_devices`` with ``device_plane`` raises as the reference does.
"""

import json
import os
import random

import jax
import pytest
import torch

import fluidframework_tpu_torch.testing as port_testing
from fluidframework_tpu.server.deli_kernel import (
    KernelDeliLambda as JaxKernelDeli,
    KernelDeliRole as JaxKernelRole,
    PackedDeliCore as JaxCore,
    mesh_for_devices as jax_mesh_for_devices,
)
from fluidframework_tpu.server.log import MessageLog as JaxLog
from fluidframework_tpu_torch.ops.sequencer_kernel import (
    NO_GROUP,
    SUB_JOIN,
    SUB_LEAVE,
    SUB_OP,
    SUB_SYSTEM,
)
from fluidframework_tpu_torch.parallel.mesh import make_docs_mesh
from fluidframework_tpu_torch.server.columnar_log import make_topic
from fluidframework_tpu_torch.server.deli_kernel import (
    KernelDeliLambda,
    KernelDeliRole,
    PackedDeliCore,
    SeqPool,
    mesh_for_devices,
)
from fluidframework_tpu_torch.server.log import MessageLog
from fluidframework_tpu_torch.testing.deli_streams import (
    StreamDigest,
    build_pipeline_workload,
    canonical_role_record,
    checkpoint_digest,
    gen_boxcar_wire,
    gen_raw_traffic,
    gen_wire_traffic,
    norm_entry,
    to_inproc,
)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _need(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} (virtual) devices")


def _port_core(n, **kw):
    return PackedDeliCore(dedup=True, mesh=mesh_for_devices(n, "cpu"), **kw)


def _jax_core(n, **kw):
    return JaxCore(dedup=True, mesh=jax_mesh_for_devices(n), **kw)


def drive(core, seed, pumps=4, per_pump=80, docs=6, clients=5,
          docs_by_pump=None):
    """Seeded mixed traffic straight into a core (the traffic of the
    reference's tests/test_deli_sharded.py): joins, leaves, system stamps,
    standalone ops (some invalid), boxcars, resubmissions. With
    `docs_by_pump`, pump k draws from its own document count (growth
    after the pool is placed). Returns the verdicts per pump."""
    rng = random.Random(seed)
    results = []
    recent: list = []
    for k in range(pumps):
        n_docs = docs_by_pump[k] if docs_by_pump else docs
        core.begin()
        for _ in range(per_pump):
            h = core.touch(f"doc{rng.randrange(n_docs)}")
            slot = h["slot"]
            r = rng.random()
            if r < 0.15:
                cid = rng.randrange(1, clients + 1)
                core.add(slot, SUB_JOIN, core.pool.col_of_join(h, cid))
            elif r < 0.22:
                cid = rng.randrange(1, clients + 1)
                core.add(slot, SUB_LEAVE, h["cmap"].get(cid, 0))
            elif r < 0.27:
                core.add(slot, SUB_SYSTEM)
            elif r < 0.4:
                g = core.new_group(slot)
                col = rng.randrange(0, clients + 1)
                for _ in range(rng.randrange(2, 5)):
                    core.add(slot, SUB_OP, col, rng.randrange(1, 9),
                             rng.randrange(0, 5), g)
            elif r < 0.5 and recent:
                core.add(*rng.choice(recent))  # resubmission -> dedup
            else:
                sub = (slot, SUB_OP, rng.randrange(0, clients + 1),
                       rng.randrange(1, 9), rng.randrange(0, 5), NO_GROUP)
                recent.append(sub)
                if len(recent) > 32:
                    recent.pop(0)
                core.add(*sub)
        res = core.run()
        results.append((res.seq, res.msn, res.nack, res.skipped))
    return results


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_core_matches_jax(n):
    _need(n)
    got = drive(_port_core(n), seed=11)
    assert got == drive(_jax_core(n), seed=11)
    assert got == drive(PackedDeliCore(dedup=True, device="cpu"), seed=11)


@pytest.mark.parametrize("n", [2, 4])
def test_growth_while_placed_matches_jax_slot_map(n):
    """The pool grows after its first placement: each slab pads on its
    entry and `_phys` renumbers per slab exactly as the reference's
    placed grow does."""
    _need(n)
    port, jcore = _port_core(n, n_docs=4), _jax_core(n, n_docs=4)
    sched = [3, 5, 20, 40, 70]
    got = drive(port, seed=52, pumps=5, docs_by_pump=sched)
    assert got == drive(jcore, seed=52, pumps=5, docs_by_pump=sched)
    assert port.pool._placed and jcore.pool._placed
    assert port.pool.n_docs == jcore.pool.n_docs > 8
    assert port.pool._phys.tolist() == jcore.pool._phys.tolist()
    assert port.pool._phys.tolist() != list(range(port.pool.n_docs))
    assert sorted(port.pool._phys.tolist()) == list(range(port.pool.n_docs))
    assert [s.seq.shape[0] for s in port.pool.state] == \
        [port.pool.n_docs // n] * n
    assert port.pool.checkpoint_docs() == jcore.pool.checkpoint_docs()


def test_evict_park_matches_jax():
    _need(2)
    kw = dict(max_resident=3)
    got = drive(_port_core(2, **kw), seed=5, docs=10)
    assert got == drive(_jax_core(2, **kw), seed=5, docs=10)
    assert got == drive(PackedDeliCore(dedup=True, device="cpu", **kw),
                        seed=5, docs=10)


def test_scoped_scatter_writes_only_owning_slabs():
    pool = SeqPool(n_docs=8, n_clients=4, mesh=make_docs_mesh(4, "cpu"))
    pool.begin()
    for i in range(8):
        pool.touch(f"d{i}")
    pool.prepare()
    assert pool._placed and len(pool.state) == 4

    def marks():
        return [[(t.data_ptr(), t._version) for t in slab]
                for slab in pool.state]

    before = marks()
    victim = pool.slot_owner[0]
    pool.docs[victim]["clients"] = {1: [0, 3]}
    pool.docs[victim]["cmap"] = {1: 1}
    pool.park(victim)
    pool.begin()
    h = pool.touch(victim)
    rows = pool.n_docs // 4
    owner = int(pool._phys[h["slot"]]) // rows
    pool.prepare()
    after = marks()
    for s in range(4):
        if s == owner:
            assert all(a[0] == b[0] and a[1] > b[1]
                       for a, b in zip(after[s], before[s]))
        else:
            assert after[s] == before[s], f"slab {s} was written"
    local = int(pool._phys[h["slot"]]) - owner * rows
    assert int(pool.state[owner].client_seq[local, 1]) == 3
    assert bool(pool.state[owner].connected[local, 1])
    # Growth still pads every slab (new shapes) and keeps the placement.
    pool._need_clients = 16
    pool.prepare()
    assert pool._placed and all(s.connected.shape[1] >= 16
                                for s in pool.state)


def _lambda_run(recs, topo, checkpoint=None, prefix=()):
    """Drain `recs` (after `prefix`, which a restored consumer skips)
    through a deli of topology `topo` on a fresh log: an int entry
    count for the port on CPU entries, "jax1" for the JAX single-device
    kernel deli. Returns (this run's normalized deltas, checkpoint)."""
    if topo == "jax1":
        log = JaxLog()
        make = lambda: JaxKernelDeli(log, checkpoint)  # noqa: E731
    else:
        log = MessageLog()
        make = lambda: KernelDeliLambda(  # noqa: E731
            log, checkpoint, device="cpu", deli_devices=topo)
    log.topic("rawdeltas").append_many(list(prefix) + list(recs))
    deli = make()
    while deli.pump():
        pass
    return [norm_entry(e) for e in log.topic("deltas").read(0)], \
        deli.checkpoint()


def test_checkpoint_topology_free_across_packages():
    recs = gen_raw_traffic(33, n=300, docs=5)
    a, b, c = recs[:100], recs[100:200], recs[200:]
    want, cp_want = _lambda_run(recs, 1)
    out_a, cp_a = _lambda_run(a, 4)  # port, 4 entries
    out_b, cp_b = _lambda_run(b, "jax1", cp_a, prefix=a)  # JAX, 1 device
    out_c, cp_c = _lambda_run(c, 2, cp_b, prefix=a + b)  # port, 2 entries
    assert out_a and out_b and out_c
    assert out_a + out_b + out_c == want
    assert checkpoint_digest(cp_c) == checkpoint_digest(cp_want)
    assert checkpoint_digest(_lambda_run(a, 1)[1]) == checkpoint_digest(cp_a)


def test_lambda_deli_devices_4_meets_golden_prefix():
    with open(os.path.join(os.path.dirname(port_testing.__file__),
                           "deli_golden.json")) as f:
        golden = json.load(f)
    p = golden["params"]
    n = p["prefix_pumps"] * p["max_pump"]
    recs = to_inproc(build_pipeline_workload(
        p["n_docs"], p["n_clients"], p["ops_per_client"], seed=p["seed"],
        limit=n))
    log = MessageLog()
    log.topic("rawdeltas").append_many(recs)
    deli = KernelDeliLambda(log, max_pump=p["max_pump"], device="cpu",
                            deli_devices=4)
    pumps = 0
    while deli.pump():
        pumps += 1
    assert pumps == p["prefix_pumps"]
    digest = StreamDigest().update(log.topic("deltas").read(0))
    assert (digest.stamps, digest.nacks) == (len(recs), 0)
    assert digest.hexdigest() == golden["pump4_sha256"]
    pool = deli.core.pool
    assert pool._n_shards == 4 and len(pool.state) == 4
    assert (pool.n_docs, pool.chunks) == (16384, 4)


@pytest.mark.parametrize("seed", [0, 5])
def test_role_deli_devices_2_matches_jax_role(seed, tmp_path):
    _need(2)
    recs = gen_wire_traffic(seed, ops=8) + gen_boxcar_wire(seed + 1)
    outs = {}
    for name in ("port", "jax"):
        shared = str(tmp_path / name)
        raw = make_topic(os.path.join(shared, "topics", "rawdeltas.jsonl"),
                         "columnar")
        for lo in range(0, len(recs), 13):
            raw.append_many(recs[lo:lo + 13])
        if name == "port":
            role = KernelDeliRole(shared, owner="t", ttl_s=3600.0,
                                  device="cpu", deli_devices=2, batch=29,
                                  log_format="columnar")
            assert role.core.pool._n_shards == 2
        else:
            role = JaxKernelRole(shared, owner="j", ttl_s=3600.0,
                                 deli_devices=2, batch=29,
                                 log_format="columnar")
        for _ in range(10_000):
            if not role.step():
                break
        outs[name] = [canonical_role_record(r) for r in make_topic(
            os.path.join(shared, "topics", "deltas.jsonl"),
            "columnar").read_from(0)]
        if name == "port":
            snap = role.snapshot_state()
            role.restore_state(snap)  # the restored core keeps the mesh
            assert role.core.pool.mesh is role.mesh
    assert outs["port"] == outs["jax"]
    assert outs["port"]


def test_exclusive_options(tmp_path):
    _need(4)
    with pytest.raises(ValueError, match="exclusive") as want:
        JaxKernelDeli(JaxLog(), deli_devices=4, device_plane="2x2")
    with pytest.raises(ValueError, match="exclusive") as got:
        KernelDeliLambda(MessageLog(), device="cpu", deli_devices=4,
                         device_plane="2x2")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="exclusive"):
        KernelDeliRole(str(tmp_path), owner="x", device="cpu",
                       deli_devices=2, device_plane="2x2")
    assert not os.listdir(tmp_path)
    # One entry is the single-device pool, with or without a plane.
    deli = KernelDeliLambda(MessageLog(), device="cpu", deli_devices=1)
    assert deli.core.pool.mesh is None
