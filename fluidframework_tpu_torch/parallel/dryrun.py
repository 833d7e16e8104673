"""The multi-device dry run: every path of `parallel` on one mesh.

Counterpart of the repository's ``__graft_entry__.dryrun_multichip``
and its body ``_dryrun_impl`` (:98-357), the path the reference
validates on 8 devices. The reference re-executes itself under forced
virtual host devices; a mesh of n entries needs no subprocess, so
`dryrun_multichip` runs the body in this process on n entries of
`device` (None: CUDA, raising where there is none; ``"cpu"`` for the
tests). Its sections and assertions are the reference's:

1. one lagged-stream document per entry through
   `sharded_overlay_replay`, every document's digest equal to its own
   single-entry replay, ``gerr`` 0 and ``gmsn`` the min of the final
   MSNs;
2. four documents per entry, chained behind the sequencer: the
   sequencer re-derives every op's sequence number and MSN from raw
   submissions, and `sharded_overlay_replay_multi` folds on the
   sequencer's MSN schedule; digests equal to the single-entry
   replays;
3. one document sequence-sharded over every entry
   (`run_sequence_sharded`), its digest equal to the single-document
   `OverlayReplica`;
4. the row model's `sharded_pipeline_step` on two documents per entry.

`scale` shrinks every stream proportionally (the digest contracts do
not depend on length). Returns a report of each section: its sizes,
the kernel launches its sharded call made on the card (counted by the
wrappers around that call only; 0 on the CPU) and its reductions.
"""

from __future__ import annotations

import time
from dataclasses import fields

import numpy as np
import torch

from ..utils.devices import DeviceLike

CHUNK = 128
WINDOW = 1024
KR, KK = 12, 8


def _tiny_stream(n_ops: int, seed: int = 0):
    from ..testing.synthetic import generate_stream

    return generate_stream(n_ops, n_clients=4, seed=seed, window=8,
                           initial_len=8)


def _lagged_stream(n_ops: int, seed: int):
    from ..testing.synthetic import generate_lagged_stream

    return generate_lagged_stream(n_ops, n_clients=8, seed=seed, window=64,
                                  initial_len=16)


def _batch_from_stream(s, n_ops: int, device):
    from ..ops.mergetree_kernel import OpBatch

    def col(a):
        return torch.as_tensor(np.asarray(a[:n_ops], np.int32), device=device)

    return OpBatch(
        op_type=col(s.op_type), pos1=col(s.pos1), pos2=col(s.pos2),
        seq=col(s.seq), ref_seq=col(s.ref_seq), client=col(s.client),
        buf_start=col(s.buf_start), ins_len=col(s.ins_len),
        prop_keys=col(s.prop_key)[:, None],
        prop_vals=col(s.prop_val)[:, None],
    )


class _Launches:
    """Kernel launches made inside a `with` block, by wrapper."""

    def __init__(self):
        from ..ops.mergetree_scan import mergetree_scan_kernel
        from ..ops.overlay import overlay_chunk_kernel, overlay_fold_kernel
        from ..ops.sequencer_kernel import sequencer_step_kernel

        self.kernels = {"overlay_chunk": overlay_chunk_kernel,
                        "overlay_fold": overlay_fold_kernel,
                        "sequencer_step": sequencer_step_kernel,
                        "mergetree_scan": mergetree_scan_kernel}
        self.counts = dict.fromkeys(self.kernels, 0)

    def __enter__(self):
        self._before = {k: w.launches for k, w in self.kernels.items()}
        return self

    def __exit__(self, *exc):
        for k, w in self.kernels.items():
            self.counts[k] += w.launches - self._before[k]
        return False


def dryrun_multichip(n: int, device: DeviceLike = None,
                     scale: float = 1.0) -> dict:
    """Run every section on a mesh of `n` entries; raise AssertionError
    where a digest, a reduction or an error word differs from the
    single-entry run. Returns the report described in the module's
    docstring."""
    from ..core.overlay_replay import (
        OverlayDeviceReplica, restore_shard, stack_replicas,
    )
    from ..ops.mergetree_kernel import (
        SegmentTable, make_table, stack_op_batches,
    )
    from ..ops.overlay_ref import OverlayReplica
    from ..ops.sequencer_kernel import (
        ACCEPT, SUB_OP, SeqBatch, make_state, sequence_batch,
    )
    from ..protocol.constants import NO_CLIENT
    from ..testing.digest import state_digest
    from .mesh import (
        make_docs_mesh, shard_tables, sharded_overlay_replay,
        sharded_overlay_replay_multi, sharded_pipeline_step,
    )
    from .seqshard import run_sequence_sharded

    mesh = make_docs_mesh(n, device)
    dev = mesh.entries[0]
    sync = (torch.cuda.synchronize if dev.type == "cuda"
            else (lambda: None))
    report = {"entries": n, "mesh": mesh.describe(), "scale": scale}

    def make_rep(s):
        return OverlayDeviceReplica(
            s, initial_len=16, chunk_size=CHUNK, window=WINDOW,
            n_removers=KR, n_prop_keys=KK, device=dev)

    def check_digests(streams_, reps_, out, label):
        tables_, logs_, counts_, cursors_ = out[:4]
        for d, (s, ref) in enumerate(zip(streams_, reps_)):
            ref.replay()
            ref.check_errors()
            want = state_digest(ref.annotated_spans())
            got_rep = restore_shard(make_rep(s), tables_, logs_, counts_,
                                    cursors_, d)
            got = state_digest(got_rep.annotated_spans())
            assert got == want, (
                f"{label} doc {d}: sharded digest {got[:16]} != "
                f"single-entry {want[:16]}")

    def run_step(step, inputs):
        sync()
        t0 = time.perf_counter()
        with _Launches() as launched:
            out = step(*inputs)
            sync()
        return out, launched.counts, time.perf_counter() - t0

    # 1. One document per entry.
    ops_per_doc = max(256, int(1024 * scale))
    streams = [_lagged_stream(ops_per_doc, seed=100 + d) for d in range(n)]
    reps = [make_rep(s) for s in streams]
    tables, ops, logs, counts, msns = stack_replicas(reps)
    out, launched, secs = run_step(sharded_overlay_replay(mesh, CHUNK),
                                   (tables, ops, logs, counts, msns))
    gmsn, gerr = int(out[4]), int(out[5])
    assert gerr == 0, f"kernel error flags: {gerr}"
    assert gmsn == int(msns[-1].min()), f"gmsn {gmsn}"
    check_digests(streams, reps, out, "doc-shard")
    assert all(int(v) > 0 for v in out[0].n_rows.cpu())
    report["one_doc"] = dict(docs=n, ops=ops_per_doc, chunks=reps[0].n_chunks,
                             launches=launched, gmsn=gmsn, gerr=gerr,
                             seconds=secs)

    # 2. Four documents per entry, chained behind the sequencer: it
    # re-derives every op's sequence number and the MSN (the min over
    # connected clients' refSeqs) from raw submissions, and the replay
    # folds on its MSN schedule.
    docs_per_entry = 4
    multi_ops = max(128, int(512 * scale))
    n_multi = n * docs_per_entry
    n_clients = 8
    mstreams = [_lagged_stream(multi_ops, seed=500 + d)
                for d in range(n_multi)]
    kind = np.full((n_multi, multi_ops), SUB_OP, np.int32)
    client = np.stack([s.client for s in mstreams]).astype(np.int32)
    refs = np.stack([s.ref_seq for s in mstreams]).astype(np.int32)
    cseq = np.zeros_like(client)
    for d in range(n_multi):
        seen: dict = {}
        for i, c in enumerate(client[d]):
            seen[c] = seen.get(c, 0) + 1
            cseq[d, i] = seen[c]
    state = make_state(n_multi, n_clients + 1, dev)
    # Pre-admitted clients (the join prologue happened before the
    # captured window; joins would otherwise consume sequence numbers).
    admitted = torch.zeros((n_multi, n_clients + 1), dtype=torch.bool,
                           device=dev)
    admitted[:, 1:] = True
    state = state._replace(connected=admitted)
    sync()
    with _Launches() as seq_launched:
        _, res = sequence_batch(state, SeqBatch(*(
            torch.from_numpy(a).to(dev) for a in (kind, client, cseq, refs))))
        res_seq, res_msn, res_nack = (t.cpu().numpy() for t in res[:3])
    assert (res_nack == ACCEPT).all(), "the sequencer nacked a valid stream"
    for d, s in enumerate(mstreams):
        assert (res_seq[d] == s.seq).all(), (
            f"doc {d}: the sequencer's seq assignment diverged")
    mreps = [make_rep(s) for s in mstreams]
    mtables, mops, mlogs, mcounts, _ = stack_replicas(mreps)
    ends = np.minimum(np.arange(1, mreps[0].n_chunks + 1) * CHUNK,
                      multi_ops) - 1
    kernel_msns = torch.from_numpy(
        np.ascontiguousarray(res_msn[:, ends].T.astype(np.int32))).to(dev)
    out, launched, secs = run_step(
        sharded_overlay_replay_multi(mesh, CHUNK),
        (mtables, mops, mlogs, mcounts, kernel_msns))
    gmsn, gerr = int(out[4]), int(out[5])
    assert gerr == 0, f"multi-doc kernel error: {gerr}"
    assert gmsn == int(res_msn[:, -1].min()), f"multi-doc gmsn {gmsn}"
    check_digests(mstreams, mreps, out, "chained multi-doc")
    launched["sequencer_step"] += seq_launched.counts["sequencer_step"]
    report["multi_doc"] = dict(docs=n_multi, ops=multi_ops,
                               chunks=mreps[0].n_chunks, launches=launched,
                               gmsn=gmsn, gerr=gerr, seconds=secs)

    # 3. One document sequence-sharded over every entry, against the
    # single-document overlay engine.
    seq_initial = 16  # the lagged stream's generation-time length
    seq_stream = _lagged_stream(max(64, int(256 * scale)), seed=991)
    seq_ref = OverlayReplica(seq_stream, initial_len=seq_initial,
                             fold_interval=1 << 30, n_removers=KR)
    seq_ref.replay()
    seq_ref.check_errors()
    seq_mesh = make_docs_mesh(n, device, axis="seq")
    sync()
    t0 = time.perf_counter()
    seq_sharded, seq_err = run_sequence_sharded(
        seq_stream, seq_mesh, seq_initial, capacity=2048, n_removers=KR)
    secs = time.perf_counter() - t0
    assert seq_err == 0, f"seqshard error flags: {seq_err}"
    digest = state_digest(seq_sharded.annotated_spans())
    assert digest == state_digest(seq_ref.annotated_spans()), (
        "sequence-sharded digest != single-document")
    report["seqshard"] = dict(ops=len(seq_stream), gerr=seq_err,
                              digest=digest, seconds=secs)

    # 4. The row model's sharded pipeline step.
    n_docs = n * 2
    one = make_table(capacity=128, n_removers=4, n_prop_keys=8, device=dev)
    one.n_rows = torch.tensor(1, dtype=torch.int32, device=dev)
    one.length[0] = 8
    one.ins_client[0] = NO_CLIENT
    ptables = SegmentTable(*(
        getattr(one, f.name).expand((n_docs,) + getattr(one, f.name).shape)
        .contiguous() for f in fields(SegmentTable)))
    ptables = shard_tables(ptables, mesh)
    pstreams = [_tiny_stream(16, seed=d) for d in range(n_docs)]
    pops = stack_op_batches([_batch_from_stream(s, 16, dev)
                             for s in pstreams])
    dmins = torch.tensor([int(s.min_seq[15]) for s in pstreams],
                         dtype=torch.int32, device=dev)
    (ntab, gmin, perr), launched, secs = run_step(
        sharded_pipeline_step(mesh), (ptables, pops, dmins))
    assert int(perr) == 0, f"pipeline error: {int(perr)}"
    assert int(gmin) == int(dmins.min()), f"pipeline gmin {int(gmin)}"
    assert bool(torch.all(ntab.n_rows > 1))
    report["pipeline"] = dict(docs=n_docs, ops=16, launches=launched,
                              gmin=int(gmin), gerr=int(perr), seconds=secs)
    return report


__all__ = ["dryrun_multichip"]
