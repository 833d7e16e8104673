// The overlay fold for Hopper (sm_90a): the settle-merge of a chunk
// boundary and, in its append form, the log append of a replay step, in
// one launch of one block per document, with no host sync.
//
// Replaces two XLA functions of fluidframework_tpu/ops/overlay_pallas.py:
//
// - `fold_device` (:703, with `_pack_partition`, ops/zamboni.py:129),
//   entry `overlay_fold_launch` with append = 0. Plain PyTorch version:
//   `ops/overlay.fold_device_ref`.
// - `fold_device` followed by the log step of `_chunk_step_body`
//   (:836-867), the same entry with append = 1. Plain PyTorch version:
//   `ops/overlay.fold_append_ref`.
//
// Each must equal its plain version bit for bit: the whole output table
// (every row, n_rows, settled_len), the whole [W, 5+KK] record block
// and n_rec; in the append form the whole log, counts and the cursor.
// Under the document's applied MSN (`msn`, by value or read from device
// memory), with live = idx < n_rows:
//
// - is_span = live & buf >= SETTLED_BASE; removed = live & rem_seq !=
//   NOT_REMOVED; drop = removed & rem_seq <= msn; settle_text = live &
//   !removed & !is_span & ins_seq <= msn; settle_span = live & !removed
//   & is_span; a live row that is none of these is kept;
// - exc = len where drop & is_span, ins = len where settle_text;
//   new_anchor = anchor - (exclusive prefix of exc) + (exclusive prefix
//   of ins), settled_len' = settled_len + sum ins - sum exc; new_buf =
//   SETTLED_BASE + new_anchor on span rows, else buf. All of it int32
//   with wraparound, as XLA computes it (unsigned arithmetic here);
// - the stable partition: kept row of rank k (kept rows before it) goes
//   to output row k as [new_anchor, new_buf, len, ins_seq, ins_client,
//   rem_seq, rem_clients, props]; output rows at and above n_new (the
//   kept count) take the fills 0, 0, 0, 0, NO_CLIENT, NOT_REMOVED,
//   NO_CLIENT, PROP_ABSENT;
// - the record block is the partition rotated by n_new: a row that is
//   not kept (a folding row, or a dead row at or above n_rows, which
//   still carries its new_anchor-derived buf) of drop rank j (rows not
//   kept before it) is record j, and kept row k is record W - n_new + k;
//   a record is [old anchor, code, new_buf, len, ins_seq, props] with
//   code 1 settle_text, 2 drop & is_span, 3 settle_span, else 0;
//   n_rec = (live rows) - n_new;
// - append form: the W records go to log rows [start, start + W) of the
//   document, start = clamp(cursor, 0, cap - W) as
//   `lax.dynamic_update_slice` clamps; counts[epoch] = n_rec; the new
//   cursor (a separate output) = cursor + n_rec. The input table is
//   never written; the log and counts are written in place.
//
// Design. One block of NT = 1024 threads per document (blockIdx.x);
// thread t owns the R = ceil(W / NT) contiguous rows [t*R, t*R+R), so a
// thread's rows are consecutive in storage order and one block scan
// orders them all. Pass 1: each thread tests its rows and sums its kept
// rows, exc and ins. A warp-shuffle inclusive scan, the per-warp totals
// in shared memory scanned by warp 0, and one more barrier give every
// thread the exclusive prefixes of the three sums and the block totals
// (n_new above all, which a kept row's record position needs before any
// write). Pass 2: each thread walks its rows again, re-reads the four
// test columns (L1 / L2 hits), carries the prefixes row by row and
// computes each row's destinations: the output row of its keep rank and
// the record of its drop or keep rank. It writes them as two inverse
// maps (output row -> source row, record -> source row) into a
// per-document scratch of 5 W ints in device memory (L2), with each
// row's new anchor, new buf and record code. A barrier, then pass 3:
// the block writes every output column element by element, thread t
// element t + j NT, so that a warp's stores are contiguous, each
// element reading its source row through the maps (the wide rows
// rem_clients and props, and the records, are gathered this way rather
// than copied row by row, which left a warp's 32 stores on 32 scattered
// sectors: 0.097 ms a launch at W 2048 in the first design). Every
// output int is written once, by one thread; no atomics, three
// barriers.
//
// What bounds it on this card: bytes, at 3.35 TB/s. The function reads
// the table (6 + KR + KK ints a row) and writes the new table and the
// record block (5 + KK ints a row): at W 2048, KR 24, KK 8 about 730 KB
// a document, ~0.22 us. A single document is one block on one SM, so
// the launch, the barriers and the SM's own load and store rate, not
// the card's bandwidth, set its time; D = 132 documents fill the SMs. A
// later redesign would fuse the fold into kernel A's block, whose hot
// columns are in shared memory at the chunk's end.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 1024;         // threads a block
constexpr int WARPS = NT / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int NOT_REMOVED = 2147483647;
constexpr int NO_CLIENT = -3;
constexpr int PROP_ABSENT = -1;
constexpr int SETTLED_BASE = 1 << 30;
constexpr int REC_SETTLE_TEXT = 1;
constexpr int REC_DROP_SPAN = 2;
constexpr int REC_SETTLE_SPAN = 3;
constexpr int N_PTRS = 27;
constexpr int SMEM_BYTES = 3 * (WARPS + 1) * 4;  // block_scan3

struct Args {
    int W, KR, KK, R;
    // inputs, [D] scalars and [D, W] / [D, W, K] columns
    const int* n_rows;
    const int* settled_len;
    const int* anchor;
    const int* buf;
    const int* len;
    const int* ins_seq;
    const int* ins_client;
    const int* rem_seq;
    const int* rem_clients;
    const int* props;
    const int* msn;  // null: msn_value
    int msn_value, msn_stride;
    // the output table
    int* o_n_rows;
    int* o_settled_len;
    int* o_anchor;
    int* o_buf;
    int* o_len;
    int* o_ins_seq;
    int* o_ins_client;
    int* o_rem_seq;
    int* o_rem_clients;
    int* o_props;
    // records: [D, W, 5 + KK] (append 0) or the log [D, cap, 5 + KK]
    int* rec;
    int* n_rec;  // [D] (append 0)
    int append, cap, n_epochs, epoch, cursor_stride;
    const int* cursor_in;  // append 1
    int* cursor_out;
    int* counts;  // [D, n_epochs]
    // [D, 5, W]: output row -> source row, record -> source row, and
    // each row's new anchor, new buf and record code
    int* scratch;
};

// One row's tests under the MSN.
struct Row {
    bool keep;
    int code;
    unsigned exc, ins;
    bool is_span;
};

__device__ __forceinline__ Row test_row(const Args& a, long long base, int i,
                                        int live_n, int msn) {
    Row r;
    const bool live = i < live_n;
    const int b = a.buf[base + i];
    const int rs = a.rem_seq[base + i];
    const int is = a.ins_seq[base + i];
    const unsigned ln = (unsigned)a.len[base + i];
    r.is_span = live && b >= SETTLED_BASE;
    const bool removed = live && rs != NOT_REMOVED;
    const bool drop = removed && rs <= msn;
    const bool settle_text = live && !removed && !r.is_span && is <= msn;
    const bool settle_span = live && !removed && r.is_span;
    const bool drop_span = drop && r.is_span;
    r.keep = live && !(drop || settle_text || settle_span);
    r.exc = drop_span ? ln : 0u;
    r.ins = settle_text ? ln : 0u;
    r.code = settle_text ? REC_SETTLE_TEXT
             : drop_span ? REC_DROP_SPAN
             : settle_span ? REC_SETTLE_SPAN : 0;
    return r;
}

// Block-wide exclusive scan of three unsigned sums: `v` in, the
// thread's exclusive prefixes out in `v`, the block totals in `tot`.
// `sh` holds 3 x (WARPS + 1) ints of shared memory: each sum's per-warp
// totals, then its block total.
__device__ __forceinline__ void block_scan3(unsigned v[3], unsigned tot[3],
                                            unsigned* sh) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    unsigned inc[3];
    for (int c = 0; c < 3; ++c) {
        unsigned x = v[c];
        for (int o = 1; o < 32; o <<= 1) {
            const unsigned y = (unsigned)__shfl_up_sync(FULL, (int)x, o);
            if (lane >= o) x += y;
        }
        inc[c] = x;
        if (lane == 31) sh[c * (WARPS + 1) + warp] = x;
    }
    __syncthreads();
    if (warp == 0) {
        // WARPS == 32: lane l scans warp l's totals; lane 31's inclusive
        // sum is the block's.
        for (int c = 0; c < 3; ++c) {
            const unsigned own = sh[c * (WARPS + 1) + lane];
            unsigned x = own;
            for (int o = 1; o < 32; o <<= 1) {
                const unsigned y = (unsigned)__shfl_up_sync(FULL, (int)x, o);
                if (lane >= o) x += y;
            }
            sh[c * (WARPS + 1) + lane] = x - own;
            if (lane == 31) sh[c * (WARPS + 1) + WARPS] = x;
        }
    }
    __syncthreads();
    for (int c = 0; c < 3; ++c) {
        v[c] = sh[c * (WARPS + 1) + warp] + inc[c] - v[c];
        tot[c] = sh[c * (WARPS + 1) + WARPS];
    }
}

__global__ void __launch_bounds__(NT) overlay_fold_kernel(Args a) {
    extern __shared__ __align__(16) int smem[];
    const int d = blockIdx.x;
    const int W = a.W, KR = a.KR, KK = a.KK, RC = 5 + KK;
    const long long base = (long long)d * W;
    int live_n = a.n_rows[d];
    live_n = live_n < 0 ? 0 : (live_n > W ? W : live_n);
    const int msn = a.msn ? a.msn[(long long)d * a.msn_stride] : a.msn_value;
    const int lo = threadIdx.x * a.R;
    const int hi = lo + a.R < W ? lo + a.R : W;

    // Pass 1: the thread's kept rows, exc and ins.
    unsigned v[3] = {0u, 0u, 0u};
    for (int i = lo; i < hi; ++i) {
        const Row r = test_row(a, base, i, live_n, msn);
        v[0] += r.keep ? 1u : 0u;
        v[1] += r.exc;
        v[2] += r.ins;
    }
    unsigned tot[3];
    block_scan3(v, tot, (unsigned*)smem);
    const int n_new = (int)tot[0];

    // The record block of this document.
    int* rec;
    int cursor = 0;
    if (a.append) {
        cursor = a.cursor_in[(long long)d * a.cursor_stride];
        int start = cursor;
        if (start > a.cap - W) start = a.cap - W;
        if (start < 0) start = 0;
        rec = a.rec + ((long long)d * a.cap + start) * RC;
    } else {
        rec = a.rec + base * RC;
    }

    // Pass 2: each row's destinations and new values into the maps.
    int* tsrc = a.scratch + (long long)d * 5 * W;
    int* rsrc = tsrc + W;
    int* s_anchor = rsrc + W;
    int* s_buf = s_anchor + W;
    int* s_code = s_buf + W;
    int k = (int)v[0];
    unsigned exc_b = v[1], ins_b = v[2];
    for (int i = lo; i < hi; ++i) {
        const Row r = test_row(a, base, i, live_n, msn);
        const int new_anchor =
            (int)((unsigned)a.anchor[base + i] - exc_b + ins_b);
        s_anchor[i] = new_anchor;
        s_buf[i] = r.is_span
            ? (int)((unsigned)SETTLED_BASE + (unsigned)new_anchor)
            : a.buf[base + i];
        s_code[i] = r.code;
        if (r.keep) {
            tsrc[k] = i;
            rsrc[W - n_new + k] = i;
            ++k;
        } else {
            rsrc[i - k] = i;
        }
        exc_b += r.exc;
        ins_b += r.ins;
    }
    __syncthreads();

    // Pass 3: every output column element by element, through the maps.
    for (int o = threadIdx.x; o < W; o += NT) {
        const long long dst = base + o;
        if (o < n_new) {
            const int i = tsrc[o];
            const long long src = base + i;
            a.o_anchor[dst] = s_anchor[i];
            a.o_buf[dst] = s_buf[i];
            a.o_len[dst] = a.len[src];
            a.o_ins_seq[dst] = a.ins_seq[src];
            a.o_ins_client[dst] = a.ins_client[src];
            a.o_rem_seq[dst] = a.rem_seq[src];
        } else {
            a.o_anchor[dst] = 0;
            a.o_buf[dst] = 0;
            a.o_len[dst] = 0;
            a.o_ins_seq[dst] = 0;
            a.o_ins_client[dst] = NO_CLIENT;
            a.o_rem_seq[dst] = NOT_REMOVED;
        }
    }
    for (int e = threadIdx.x; e < W * KR; e += NT) {
        const int o = e / KR, c = e - o * KR;
        a.o_rem_clients[base * KR + e] =
            o < n_new ? a.rem_clients[(base + tsrc[o]) * KR + c] : NO_CLIENT;
    }
    for (int e = threadIdx.x; e < W * KK; e += NT) {
        const int o = e / KK, c = e - o * KK;
        a.o_props[base * KK + e] =
            o < n_new ? a.props[(base + tsrc[o]) * KK + c] : PROP_ABSENT;
    }
    for (int e = threadIdx.x; e < W * RC; e += NT) {
        const int r = e / RC, c = e - r * RC;
        const int i = rsrc[r];
        const long long src = base + i;
        int val;
        switch (c) {
            case 0: val = a.anchor[src]; break;
            case 1: val = s_code[i]; break;
            case 2: val = s_buf[i]; break;
            case 3: val = a.len[src]; break;
            case 4: val = a.ins_seq[src]; break;
            default: val = a.props[src * KK + (c - 5)]; break;
        }
        rec[e] = val;
    }

    if (threadIdx.x == 0) {
        const int n_rec = live_n - n_new;
        a.o_n_rows[d] = n_new;
        a.o_settled_len[d] =
            (int)((unsigned)a.settled_len[d] + tot[2] - tot[1]);
        if (a.append) {
            a.counts[(long long)d * a.n_epochs + a.epoch] = n_rec;
            a.cursor_out[d] = (int)((unsigned)cursor + (unsigned)n_rec);
        } else {
            a.n_rec[d] = n_rec;
        }
    }
}

}  // namespace

// Plain C entry point (loaded with ctypes). `ptrs` holds, in order:
// n_rows, settled_len, anchor, buf_start, length, ins_seq, ins_client,
// rem_seq, rem_clients, props (the input table of `n_docs` documents
// back to back), the MSN ([n_docs] or one int, `msn_stride` 1 or 0;
// null: `msn_value` for every document), then the output table's
// n_rows, settled_len, anchor, buf_start, length, ins_seq, ins_client,
// rem_seq, rem_clients, props, then the records ([n_docs, W, 5 + KK];
// with `append` the log [n_docs, cap, 5 + KK]) and n_rec ([n_docs];
// null with `append`), then, with `append`, the cursor ([n_docs] or one
// int, `cursor_stride` 1 or 0), the new cursor [n_docs] and counts
// [n_docs, n_epochs] (nulls without it), and the scratch [n_docs, 5, W]:
// 27 pointers. Launches one
// block per document on `stream` and returns cudaGetLastError() (0
// when the launch was accepted).
extern "C" int overlay_fold_launch(int device, int n_docs, int W, int KR,
                                   int KK, int msn_value, int msn_stride,
                                   int append, int cap, int n_epochs,
                                   int epoch, int cursor_stride, int n_ptrs,
                                   void** ptrs, void* stream) {
    if (n_ptrs != N_PTRS || n_docs < 1 || W < 1 || KR < 0 || KK < 0 ||
        (msn_stride != 0 && msn_stride != 1) ||
        (append && (cap < W || epoch < 0 || epoch >= n_epochs ||
                    (cursor_stride != 0 && cursor_stride != 1))))
        return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    Args a;
    a.W = W;
    a.KR = KR;
    a.KK = KK;
    a.R = (W + NT - 1) / NT;
    int k = 0;
    a.n_rows = (const int*)ptrs[k++];
    a.settled_len = (const int*)ptrs[k++];
    a.anchor = (const int*)ptrs[k++];
    a.buf = (const int*)ptrs[k++];
    a.len = (const int*)ptrs[k++];
    a.ins_seq = (const int*)ptrs[k++];
    a.ins_client = (const int*)ptrs[k++];
    a.rem_seq = (const int*)ptrs[k++];
    a.rem_clients = (const int*)ptrs[k++];
    a.props = (const int*)ptrs[k++];
    a.msn = (const int*)ptrs[k++];
    a.msn_value = msn_value;
    a.msn_stride = msn_stride;
    a.o_n_rows = (int*)ptrs[k++];
    a.o_settled_len = (int*)ptrs[k++];
    a.o_anchor = (int*)ptrs[k++];
    a.o_buf = (int*)ptrs[k++];
    a.o_len = (int*)ptrs[k++];
    a.o_ins_seq = (int*)ptrs[k++];
    a.o_ins_client = (int*)ptrs[k++];
    a.o_rem_seq = (int*)ptrs[k++];
    a.o_rem_clients = (int*)ptrs[k++];
    a.o_props = (int*)ptrs[k++];
    a.rec = (int*)ptrs[k++];
    a.n_rec = (int*)ptrs[k++];
    a.cursor_in = (const int*)ptrs[k++];
    a.cursor_out = (int*)ptrs[k++];
    a.counts = (int*)ptrs[k++];
    a.scratch = (int*)ptrs[k++];
    a.append = append;
    a.cap = cap;
    a.n_epochs = n_epochs;
    a.epoch = epoch;
    a.cursor_stride = cursor_stride;
    const int smem = SMEM_BYTES;
    overlay_fold_kernel<<<n_docs, NT, (size_t)smem, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
