// The deli's per-document sequencer step, over a [D, B] chunk, for Hopper.
//
// Replaces fluidframework_tpu/ops/sequencer_kernel.py::_step_one_doc (:123)
// under the `_sequence_batch_impl` scan (:231): an XLA scan over the B
// columns of a [D, B] batch, vmapped over D documents. Its plain PyTorch
// version is `_step_one_doc_ref` / `sequence_batch_ref` in
// fluidframework_tpu_torch/ops/sequencer_kernel.py; this kernel computes
// exactly what they compute (int32 and bool, tolerance 0).
//
// Design: one warp per document. A document's B submissions are serial
// (each verdict reads the state the previous one left), documents are
// independent, so the warp loads its document's [C] row (connected,
// refSeq, clientSeq), loops over the chunk's B columns, and writes the row
// back with the [D, B] verdicts and the [D] abort tracker. Per column the
// verdict is warp-uniform scalar code: every lane reads the addressed
// slot's `connected` and `clientSeq`, lane 0 writes the slot's update, and
// on a stamp the MSN is a per-lane masked min over the lane's columns
// followed by a 5-step __shfl_xor_sync min. The batch is read 32 columns
// at a time, one column per lane (coalesced), and broadcast by shuffles;
// lane j keeps column j's verdicts and the warp stores them coalesced.
//
// Layouts: the row lives in shared memory (9 C bytes per document, padded
// to 16; four documents per block) when a block's rows fit 48 KB, i.e.
// C <= 1024; above that the warp copies the row into the new state and
// works on it there, in global memory (L1/L2). The wrapper picks the
// layout and may force either.
//
// Bound on an H100: bytes. Per launch the state row is read and written
// once (9 C bytes each way per document), the batch read once (20 B bytes)
// and the verdicts written once (13 B bytes): at the config-5 shape
// (D 16384, C 128, B 8) about 42 MB, ~12.7 us at 3.35 TB/s, against
// under 1 us of int32 work (about 32 per submission and, per stamp, 2 per
// client column for the MSN's masked min). The kernel is latency-bound per
// column instead (a dependent chain of shared reads, shuffles and syncs per
// submission); at 64 resident warps per SM (16 blocks of 4), the chunk's 16384 warps
// run in two waves over 132 SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SUB_OP = 0;
constexpr int SUB_JOIN = 1;
constexpr int SUB_LEAVE = 2;
constexpr int SUB_PAD = 3;
constexpr int SUB_SYSTEM = 4;
constexpr int NO_GROUP = -1;
constexpr int NACK_STALE_REFSEQ = 400;
constexpr int NACK_UNKNOWN_CLIENT = 403;
constexpr int NACK_FUTURE_REFSEQ = 416;
constexpr int NACK_OUT_OF_ORDER = 422;
constexpr int INT32_MAX_ = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;  // documents per block (WARPS_PER_BLOCK in Python)
constexpr int N_PTRS = 21;
constexpr int SMEM_DEFAULT = 48 * 1024;
constexpr int SMEM_OPTIN = 232448;

struct Args {
    int D, B, C, dedup;
    const int* seq_in;
    const int* min_in;
    const uint8_t* conn_in;
    const int* ref_in;
    const int* cseq_in;
    const int* abort_in;
    const int* kind;
    const int* client;
    const int* client_seq;
    const int* ref_seq;
    const int* group;
    int* seq_out;
    int* min_out;
    uint8_t* conn_out;
    int* ref_out;
    int* cseq_out;
    int* abort_out;
    int* r_seq;
    int* r_min;
    int* r_nack;
    uint8_t* r_skip;
};

__host__ __device__ inline size_t row_bytes(int C) {
    return ((size_t)9 * C + 15) / 16 * 16;
}

template <bool SHARED>
__global__ void __launch_bounds__(32 * WARPS) sequencer_step(Args a) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int lane = threadIdx.x & 31;
    const int w = threadIdx.x >> 5;
    const long long d = (long long)blockIdx.x * WARPS + w;
    if (d >= a.D) return;  // the whole warp leaves: no block barrier below
    const int C = a.C;
    const size_t row0 = (size_t)d * C;

    int* ref;
    int* cs;
    uint8_t* conn;
    if (SHARED) {
        unsigned char* base = smem + (size_t)w * row_bytes(C);
        ref = reinterpret_cast<int*>(base);
        cs = ref + C;
        conn = reinterpret_cast<uint8_t*>(cs + C);
    } else {
        ref = a.ref_out + row0;
        cs = a.cseq_out + row0;
        conn = a.conn_out + row0;
    }
    for (int c = lane; c < C; c += 32) {
        ref[c] = a.ref_in[row0 + c];
        cs[c] = a.cseq_in[row0 + c];
        conn[c] = a.conn_in[row0 + c] ? 1 : 0;
    }
    __syncwarp();

    int seq = a.seq_in[d];
    int msn = a.min_in[d];
    int aborted = a.abort_in[d];
    const size_t b_row = (size_t)d * a.B;

    for (int b0 = 0; b0 < a.B; b0 += 32) {
        const int bi = b0 + lane;
        const bool has = bi < a.B;
        const int kind_l = has ? a.kind[b_row + bi] : SUB_PAD;
        const int client_l = has ? a.client[b_row + bi] : 0;
        const int cseq_l = has ? a.client_seq[b_row + bi] : 0;
        const int ref_l = has ? a.ref_seq[b_row + bi] : 0;
        const int group_l = has ? a.group[b_row + bi] : NO_GROUP;
        int o_seq = 0, o_min = 0, o_nack = 0, o_skip = 0;
        const int n = min(32, a.B - b0);
        for (int j = 0; j < n; ++j) {
            const int k = __shfl_sync(FULL, kind_l, j);
            const int cl = __shfl_sync(FULL, client_l, j);
            const int q = __shfl_sync(FULL, cseq_l, j);
            const int r = __shfl_sync(FULL, ref_l, j);
            const int g = __shfl_sync(FULL, group_l, j);

            const int slot = min(max(cl, 0), C - 1);
            const bool known = conn[slot] != 0;
            const int last = cs[slot];
            const bool in_box = g >= 0;
            const bool box_dead = in_box && g == aborted;
            // Dedup first, and only for known clients: a resubmission
            // never reaches the nack ladder.
            const bool dup = a.dedup && k == SUB_OP && known && q <= last;
            const bool skipped = box_dead || dup;
            const bool is_op = k == SUB_OP && !skipped;
            int nack = 0;
            if (is_op) {
                if (!known) nack = NACK_UNKNOWN_CLIENT;
                else if (r < msn) nack = NACK_STALE_REFSEQ;
                else if (r > seq) nack = NACK_FUTURE_REFSEQ;
                else if (q != (int)((unsigned)last + 1u)) nack = NACK_OUT_OF_ORDER;
            }
            const bool ok_op = is_op && nack == 0;
            const bool live = !box_dead;
            const bool do_join = k == SUB_JOIN && live;
            const bool ok_leave = k == SUB_LEAVE && known && live;
            const bool do_sys = k == SUB_SYSTEM && live;
            const bool stamped = ok_op || do_join || ok_leave || do_sys;
            const int new_seq = (int)((unsigned)seq + (stamped ? 1u : 0u));

            __syncwarp();  // every lane has read the slot before it changes
            if (lane == 0) {
                if (do_join) {
                    // admitted at the head seq before its own stamp
                    conn[slot] = 1;
                    ref[slot] = seq;
                    cs[slot] = 0;
                } else if (ok_leave) {
                    conn[slot] = 0;
                } else if (ok_op) {
                    ref[slot] = r;
                    cs[slot] = q;
                }
            }
            __syncwarp();

            if (stamped) {  // warp-uniform
                int m = INT32_MAX_;
                bool any = false;
                for (int c = lane; c < C; c += 32) {
                    if (conn[c]) {
                        m = min(m, ref[c]);
                        any = true;
                    }
                }
#pragma unroll
                for (int o = 16; o > 0; o >>= 1)
                    m = min(m, __shfl_xor_sync(FULL, m, o));
                any = __any_sync(FULL, any);
                msn = max(msn, any ? m : new_seq);
            }
            seq = new_seq;
            if (in_box && nack != 0) aborted = g;
            if (lane == j) {
                o_seq = stamped ? new_seq : 0;
                o_min = msn;
                o_nack = nack;
                o_skip = skipped ? 1 : 0;
            }
        }
        if (has) {
            a.r_seq[b_row + bi] = o_seq;
            a.r_min[b_row + bi] = o_min;
            a.r_nack[b_row + bi] = o_nack;
            a.r_skip[b_row + bi] = (uint8_t)o_skip;
        }
    }

    if (lane == 0) {
        a.seq_out[d] = seq;
        a.min_out[d] = msn;
        a.abort_out[d] = aborted;
    }
    if (SHARED) {
        __syncwarp();
        for (int c = lane; c < C; c += 32) {
            a.ref_out[row0 + c] = ref[c];
            a.cseq_out[row0 + c] = cs[c];
            a.conn_out[row0 + c] = conn[c];
        }
    }
}

}  // namespace

// Pointers, in order: the state in (seq, min_seq, connected, ref_seq,
// client_seq), the abort tracker in, the batch (kind, client, client_seq,
// ref_seq, groups), the state out, the tracker out, the verdicts (seq,
// min_seq, nack, skipped). layout: 0 shared, 1 global. Returns a CUDA
// error code (0 on a launch that was accepted); never synchronises.
extern "C" int sequencer_step_launch(int device, int D, int B, int C,
                                     int dedup, int layout, int n_ptrs,
                                     void** ptrs, void* stream) {
    if (n_ptrs != N_PTRS || D < 1 || B < 1 || C < 1 ||
        (layout != 0 && layout != 1))
        return (int)cudaErrorInvalidValue;
    const size_t smem = layout == 0 ? WARPS * row_bytes(C) : 0;
    if (smem > (size_t)SMEM_OPTIN) return (int)cudaErrorInvalidValue;

    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    if (layout == 0 && smem > (size_t)SMEM_DEFAULT) {
        e = cudaFuncSetAttribute((const void*)sequencer_step<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
        if (e != cudaSuccess) return (int)e;
    }

    Args a;
    a.D = D;
    a.B = B;
    a.C = C;
    a.dedup = dedup ? 1 : 0;
    a.seq_in = (const int*)ptrs[0];
    a.min_in = (const int*)ptrs[1];
    a.conn_in = (const uint8_t*)ptrs[2];
    a.ref_in = (const int*)ptrs[3];
    a.cseq_in = (const int*)ptrs[4];
    a.abort_in = (const int*)ptrs[5];
    a.kind = (const int*)ptrs[6];
    a.client = (const int*)ptrs[7];
    a.client_seq = (const int*)ptrs[8];
    a.ref_seq = (const int*)ptrs[9];
    a.group = (const int*)ptrs[10];
    a.seq_out = (int*)ptrs[11];
    a.min_out = (int*)ptrs[12];
    a.conn_out = (uint8_t*)ptrs[13];
    a.ref_out = (int*)ptrs[14];
    a.cseq_out = (int*)ptrs[15];
    a.abort_out = (int*)ptrs[16];
    a.r_seq = (int*)ptrs[17];
    a.r_min = (int*)ptrs[18];
    a.r_nack = (int*)ptrs[19];
    a.r_skip = (uint8_t*)ptrs[20];

    const long long blocks = ((long long)D + WARPS - 1) / WARPS;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (layout == 0)
        sequencer_step<true><<<(unsigned)blocks, 32 * WARPS, smem, s>>>(a);
    else
        sequencer_step<false><<<(unsigned)blocks, 32 * WARPS, 0, s>>>(a);
    return (int)cudaGetLastError();
}
