// Row-model scan for Hopper (sm_90a): a chunk of sequenced ops applied
// to the segment tables of D documents, one block per document.
//
// Replaces the XLA scan `_apply_one` under `apply_op_batch` and its
// vmapped docs form `apply_op_batch_docs_jit`
// (fluidframework_tpu/ops/mergetree_kernel.py:289, :383, :404-409),
// which the reference's `KernelReplica` and the summary service's
// `kernel` fold backend run. There is no Pallas kernel for it. Its
// plain PyTorch version is `ops/mergetree_kernel.apply_op_batch_ref`
// (and `apply_op_batch_docs_ref`), which it must equal bit for bit on
// n_rows, error and rows [:min(n_rows, C)].
//
// Per op, as the scan does it (NOOPs do nothing but the capacity
// test):
//   1. a boundary split at pos1 (insert, remove, annotate): the first
//      non-skip row with prefix < pos1 < prefix + vis splits; its tail
//      opens at the next row and inherits every field;
//   2. a boundary split at pos2 (remove, annotate);
//   3. an insert's landing: the first non-skip row at or after pos1
//      that is visible or loses the tie-break (op.seq > ins_seq), else
//      row n_rows; the suffix shifts up one row and the new row is
//      written there; ERR_BAD_POS when no row lands and pos1 > total;
//   4. a range op's covered rows (non-skip, visible, inside
//      [pos1, pos2)): a remove keeps the earliest rem_seq and puts the
//      client in slot 0 of a row not yet removed, else in the first
//      free slot (ERR_REMOVERS when none is free); an annotate writes
//      its keys in slot order (the last wins), PROP_DELETE clearing;
//      ERR_BAD_POS when pos2 > the visible total;
//   5. ERR_CAPACITY whenever n_rows exceeds C. As in the scan, n_rows
//      still grows past C: a row pushed off the top of a full table is
//      lost, and an insert or a split tail that would open row C is
//      not written.
//
// Design. One block of NT = min(1024, C rounded up to 32) threads per
// document, all D documents in one launch (grid D, no grid barrier).
// Each block keeps its table's hot columns -- buf_start, length,
// ins_seq, ins_client, rem_seq and a sixth column `slot` -- in shared
// memory for the whole chunk (24 bytes a row), with the chunk's ops
// staged there once. The cold columns rem_clients [KR] and props [KK]
// live in a per-document heap in global memory, C + 2B rows of
// KR + KK ints behind the slot column: a shift moves only the six hot
// columns, a split tail copies its head's cold row to a fresh heap row
// and an insert writes one (each op opens at most two rows). Thread t
// owns rows [t*R, t*R + R) for the passes (R = ceil(C / NT) <= 8).
// A pass computes each live row's visibility at the op's (ref_seq,
// client) -- reading the heap row only for a removed row whose insert
// is visible -- and a block-wide exclusive int32 scan of the visible
// lengths (warp shuffles, then one cross-warp step); the scan's
// "first row where ..." is a block-wide min of (row, prefix) keys. A
// shift is a move of the live suffix by one row in shared memory, in
// top-down tiles of NT rows between barriers. Passes per op: 2 for an
// insert, 3 for a remove or an annotate, 0 for a NOOP.
//
// What bounds it: the chain of block barriers and shared-memory passes
// per op (one document's ops are serial), not bytes: the tables cross
// device memory once each way per chunk. Capacity ceiling: C <= 8192
// rows (8 a thread), with the hot columns and the chunk's ops within
// the 227 KB of opt-in shared memory; `scan_geometry` in
// ops/mergetree_scan.py raises above it and this launcher refuses it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_NT = 1024;
constexpr int MAX_RPT = 8;           // rows per thread at most
constexpr int HOT = 6;               // hot columns in shared memory
constexpr int OPC = 8;               // op columns
constexpr int SMEM_MISC = 1024;      // bytes of `Misc`, rounded up
constexpr int SMEM_OPTIN = 232448;   // an H100 block's opt-in shared memory
constexpr int SMEM_DEFAULT = 48 * 1024;
constexpr int NOT_REMOVED = 2147483647;
constexpr int NO_CLIENT = -3;
constexpr int NO_KEY = -1;
constexpr int PROP_ABSENT = -1;
constexpr int PROP_DELETE = -2;
constexpr int OP_INSERT = 0;
constexpr int OP_REMOVE = 1;
constexpr int OP_ANNOTATE = 2;
constexpr int ERR_CAPACITY = 1;
constexpr int ERR_BAD_POS = 2;
constexpr int ERR_REMOVERS = 4;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long NONE = ~0ull;
constexpr int N_PTRS = 29;

enum { BUF = 0, LEN = 1, ISEQ = 2, ICL = 3, RSEQ = 4, SLOT = 5 };
enum { O_TYPE = 0, O_POS1, O_POS2, O_SEQ, O_REF, O_CLIENT, O_BUF, O_LEN };

struct Args {
    int D, C, KR, KK, B, PK, R;
    const int* n_rows_in;   // [D]
    const int* err_in;      // [D]
    const int* col_in[5];   // [D, C] buf, len, ins_seq, ins_client, rem_seq
    const int* rcl_in;      // [D, C, KR]
    const int* props_in;    // [D, C, KK]
    const int* op[OPC];     // [D, B] type, pos1, pos2, seq, ref, client, buf, len
    const int* prop_keys;   // [D, B, PK]
    const int* prop_vals;   // [D, B, PK]
    int* col_out[5];        // [D, C]
    int* rcl_out;           // [D, C, KR]
    int* props_out;         // [D, C, KK]
    int* n_rows_out;        // [D]
    int* err_out;           // [D]
    int* heap;              // [D, C + 2B, KR + KK] cold rows
};

struct Misc {
    int scan[2][32];
    unsigned long long key[32];
};
static_assert(sizeof(Misc) <= SMEM_MISC, "Misc outgrew its shared bytes");

__device__ __forceinline__ int wadd(int a, int b) {
    return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int wsub(int a, int b) {
    return (int)((unsigned)a - (unsigned)b);
}

__device__ __forceinline__ int warp_incl_scan(int v, int lane) {
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(FULL, v, o);
        if (lane >= o) v = wadd(v, u);
    }
    return v;
}

// Block-wide exclusive int32 scan (wrapping, as the scan's int32 cumsum
// does) of one value per thread, in thread order; `total` is the
// block's sum. One barrier; callers alternate `buf` between scans.
__device__ int block_excl_scan(int v, int* buf, int& total) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    const int inc = warp_incl_scan(v, lane);
    if (lane == 31) buf[wid] = inc;
    __syncthreads();
    const int wt = lane < nw ? buf[lane] : 0;
    const int winc = warp_incl_scan(wt, lane);
    const int wbase = __shfl_sync(FULL, wsub(winc, wt), wid);
    total = __shfl_sync(FULL, winc, 31);
    return wadd(wbase, wsub(inc, v));
}

__device__ __forceinline__ unsigned long long warp_min(unsigned long long k) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        const unsigned long long u = __shfl_xor_sync(FULL, k, o);
        k = u < k ? u : k;
    }
    return k;
}

// Block-wide min of one key per thread, returned to every thread. One
// barrier; between two calls there is always a scan's barrier, so the
// buffer is not overwritten while a warp still reads it.
__device__ unsigned long long block_min(unsigned long long k,
                                        unsigned long long* buf) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    k = warp_min(k);
    if (lane == 0) buf[wid] = k;
    __syncthreads();
    return warp_min(lane < nw ? buf[lane] : NONE);
}

// One document's chunk: its shared columns, heap and block-uniform
// state (every thread holds the same n, err and next_slot).
struct Doc {
    int* hot;        // [HOT][C] shared
    const int* ops;  // [OPC][B] shared
    const int* pk;   // [B][PK] shared
    const int* pv;   // [B][PK] shared
    Misc* m;
    int* heap;       // [C + 2B][W] global
    int C, R, KR, KK, W, B, PK;
    int n, err, next_slot, sc;

    __device__ int& h(int c, int i) { return hot[c * C + i]; }

    // Visibility and visible length of the thread's rows at (ref,
    // client), their exclusive prefixes, and the block's visible total.
    // Bit r of `skipm` is set for a skip row (not live, a tombstone at
    // the perspective, or removed with an unseen insert).
    __device__ int pass(int ref, int client, int (&vis)[MAX_RPT],
                        int (&pre)[MAX_RPT], unsigned& skipm) {
        const int lo = threadIdx.x * R;
        const int lim = n < C ? n : C;
        int sum = 0;
        skipm = 0;
#pragma unroll
        for (int r = 0; r < MAX_RPT; ++r) {
            const int i = lo + r;
            int v = 0;
            bool skip = true;
            if (r < R && i < lim) {
                const int rs = h(RSEQ, i);
                const bool removed = rs != NOT_REMOVED;
                const bool tomb = removed && rs <= ref;
                const bool ins_vis = h(ICL, i) == client || h(ISEQ, i) <= ref;
                skip = tomb || (removed && !ins_vis);
                bool visible = !skip && ins_vis;
                if (visible && removed) {
                    const int* rc = heap + (size_t)h(SLOT, i) * W;
                    bool among = false;
                    for (int k = 0; k < KR; ++k) among |= rc[k] == client;
                    visible = !among;
                }
                v = visible ? h(LEN, i) : 0;
            }
            if (skip) skipm |= 1u << r;
            vis[r] = v;
            sum = wadd(sum, v);
        }
        int total;
        int run = block_excl_scan(sum, m->scan[sc++ & 1], total);
#pragma unroll
        for (int r = 0; r < MAX_RPT; ++r) {
            pre[r] = run;
            run = wadd(run, vis[r]);
        }
        return total;
    }

    // Rows [a, e) take rows [a-1, e-1), in top-down tiles of NT rows: a
    // tile reads only rows below every earlier tile's writes, and the
    // barrier between a tile's reads and its writes orders the earlier
    // tile's reads before them. Ends with a barrier.
    __device__ void shift_up(int a, int e) {
        const int NT = blockDim.x;
        for (int top = e; top > a; top -= NT) {
            const int i = top - 1 - (int)threadIdx.x;
            const bool act = i >= a;
            int v[HOT];
            if (act) {
#pragma unroll
                for (int c = 0; c < HOT; ++c) v[c] = h(c, i - 1);
            }
            __syncthreads();
            if (act) {
#pragma unroll
                for (int c = 0; c < HOT; ++c) h(c, i) = v[c];
            }
        }
        __syncthreads();
    }

    // `_split_at`: the row strictly containing visible position `pos`
    // splits; the tail opens at the next row (not written when that is
    // row C) and copies the head's cold row.
    __device__ void split(int pos, int ref, int client) {
        int vis[MAX_RPT], pre[MAX_RPT];
        unsigned skipm;
        pass(ref, client, vis, pre, skipm);
        const int lo = threadIdx.x * R;
        unsigned long long key = NONE;
#pragma unroll
        for (int r = MAX_RPT - 1; r >= 0; --r) {
            if (r < R && !((skipm >> r) & 1u) && pre[r] < pos &&
                wadd(pre[r], vis[r]) > pos)
                key = ((unsigned long long)(lo + r) << 32) | (unsigned)pre[r];
        }
        key = block_min(key, m->key);
        if (key == NONE) return;
        const int idx = (int)(key >> 32);
        const int off = wsub(pos, (int)(unsigned)key);
        const int at = idx + 1;
        if (at < C) {
            shift_up(at + 1, n + 1 < C ? n + 1 : C);
            const int slot = next_slot++;
            const int* src = heap + (size_t)h(SLOT, idx) * W;
            int* dst = heap + (size_t)slot * W;
            for (int k = threadIdx.x; k < W; k += blockDim.x) dst[k] = src[k];
            if (threadIdx.x == 0) {
                h(BUF, at) = wadd(h(BUF, idx), off);
                h(LEN, at) = wsub(h(LEN, idx), off);
                h(ISEQ, at) = h(ISEQ, idx);
                h(ICL, at) = h(ICL, idx);
                h(RSEQ, at) = h(RSEQ, idx);
                h(SLOT, at) = slot;
            }
        }
        if (threadIdx.x == 0) h(LEN, idx) = off;
        n += 1;
        __syncthreads();
    }

    // An insert's landing, shift and write.
    __device__ void insert(int i) {
        const int pos1 = ops[O_POS1 * B + i], oseq = ops[O_SEQ * B + i];
        const int ref = ops[O_REF * B + i], client = ops[O_CLIENT * B + i];
        int vis[MAX_RPT], pre[MAX_RPT];
        unsigned skipm;
        const int total = pass(ref, client, vis, pre, skipm);
        const int lo = threadIdx.x * R;
        unsigned long long key = NONE;
#pragma unroll
        for (int r = MAX_RPT - 1; r >= 0; --r) {
            if (r < R && !((skipm >> r) & 1u) && pre[r] >= pos1 &&
                (vis[r] > 0 || oseq > h(ISEQ, lo + r)))
                key = (unsigned long long)(lo + r) << 32;
        }
        key = block_min(key, m->key);
        const bool found = key != NONE;
        if (!found && pos1 > total) err |= ERR_BAD_POS;
        const int at = found ? (int)(key >> 32) : n;
        if (at < C) {
            shift_up(at + 1, n + 1 < C ? n + 1 : C);
            const int slot = next_slot++;
            int* dst = heap + (size_t)slot * W;
            const int* keys = pk + i * PK;
            const int* vals = pv + i * PK;
            for (int k = threadIdx.x; k < W; k += blockDim.x) {
                int v = NO_CLIENT;
                if (k >= KR) {
                    // `row.at[keys].set(vals, mode="drop")`: NO_KEY is
                    // dropped, another negative key counts from the
                    // end once, the last of repeated keys wins.
                    v = PROP_ABSENT;
                    for (int p = 0; p < PK; ++p) {
                        int kk = keys[p];
                        if (kk == NO_KEY) continue;
                        if (kk < 0) kk += KK;
                        if (kk == k - KR)
                            v = vals[p] == PROP_DELETE ? PROP_ABSENT : vals[p];
                    }
                }
                dst[k] = v;
            }
            if (threadIdx.x == 0) {
                h(BUF, at) = ops[O_BUF * B + i];
                h(LEN, at) = ops[O_LEN * B + i];
                h(ISEQ, at) = oseq;
                h(ICL, at) = client;
                h(RSEQ, at) = NOT_REMOVED;
                h(SLOT, at) = slot;
            }
        }
        n += 1;
        __syncthreads();
    }

    // A remove's or an annotate's covered rows. Each row's heap row is
    // read (visibility) and written by its owner thread only.
    __device__ void cover(int i, bool is_rem) {
        const int pos1 = ops[O_POS1 * B + i], pos2 = ops[O_POS2 * B + i];
        const int oseq = ops[O_SEQ * B + i], ref = ops[O_REF * B + i];
        const int client = ops[O_CLIENT * B + i];
        int vis[MAX_RPT], pre[MAX_RPT];
        unsigned skipm;
        const int total = pass(ref, client, vis, pre, skipm);
        if (pos2 > total) err |= ERR_BAD_POS;
        const int lo = threadIdx.x * R;
        const int* keys = pk + i * PK;
        const int* vals = pv + i * PK;
        bool overflow = false;
#pragma unroll
        for (int r = 0; r < MAX_RPT; ++r) {
            if (!(r < R && !((skipm >> r) & 1u) && vis[r] > 0 &&
                  pre[r] >= pos1 && wadd(pre[r], vis[r]) <= pos2))
                continue;
            const int row = lo + r;
            int* hr = heap + (size_t)h(SLOT, row) * W;
            if (is_rem) {
                if (h(RSEQ, row) == NOT_REMOVED) {
                    h(RSEQ, row) = oseq;
                    hr[0] = client;
                } else {
                    int k = 0;
                    while (k < KR && hr[k] != NO_CLIENT) ++k;
                    if (k < KR)
                        hr[k] = client;
                    else
                        overflow = true;
                }
            } else {
                for (int p = 0; p < PK; ++p) {
                    const int kk = keys[p];
                    if (kk == NO_KEY || kk < 0 || kk >= KK) continue;
                    hr[KR + kk] = vals[p] == PROP_DELETE ? PROP_ABSENT : vals[p];
                }
            }
        }
        if (__syncthreads_or(overflow)) err |= ERR_REMOVERS;
    }
};

__global__ void __launch_bounds__(MAX_NT)
mergetree_scan_kernel(Args a) {
    extern __shared__ __align__(16) int smem[];
    const int d = blockIdx.x;
    const int C = a.C, B = a.B, PK = a.PK, KR = a.KR, KK = a.KK;
    const int W = KR + KK;
    const int tid = threadIdx.x, NT = blockDim.x;

    Doc x;
    x.hot = smem;
    int* ops = smem + HOT * C;
    int* pk = ops + OPC * B;
    int* pv = pk + B * PK;
    const size_t misc_off = ((size_t)(HOT * C + OPC * B + 2 * B * PK) * 4 + 15) & ~(size_t)15;
    x.m = reinterpret_cast<Misc*>(reinterpret_cast<char*>(smem) + misc_off);
    x.ops = ops;
    x.pk = pk;
    x.pv = pv;
    x.heap = a.heap + (size_t)d * (C + 2 * B) * W;
    x.C = C;
    x.R = a.R;
    x.KR = KR;
    x.KK = KK;
    x.W = W;
    x.B = B;
    x.PK = PK;
    x.n = a.n_rows_in[d];
    x.err = a.err_in[d];
    x.next_slot = C;
    x.sc = 0;

    const size_t tc = (size_t)d * C;
    for (int i = tid; i < C; i += NT) {
#pragma unroll
        for (int c = 0; c < 5; ++c) x.h(c, i) = a.col_in[c][tc + i];
        x.h(SLOT, i) = i;
    }
    const int* rcl = a.rcl_in + tc * KR;
    const int* prp = a.props_in + tc * KK;
    for (int i = tid; i < C * KR; i += NT)
        x.heap[(size_t)(i / KR) * W + i % KR] = rcl[i];
    for (int i = tid; i < C * KK; i += NT)
        x.heap[(size_t)(i / KK) * W + KR + i % KK] = prp[i];
    for (int i = tid; i < B; i += NT) {
#pragma unroll
        for (int c = 0; c < OPC; ++c) ops[c * B + i] = a.op[c][(size_t)d * B + i];
    }
    for (int i = tid; i < B * PK; i += NT) {
        pk[i] = a.prop_keys[(size_t)d * B * PK + i];
        pv[i] = a.prop_vals[(size_t)d * B * PK + i];
    }
    __syncthreads();

    for (int i = 0; i < B; ++i) {
        const int type = ops[O_TYPE * B + i];
        const bool is_ins = type == OP_INSERT;
        const bool is_range = type == OP_REMOVE || type == OP_ANNOTATE;
        if (is_ins || is_range) {
            const int ref = ops[O_REF * B + i], client = ops[O_CLIENT * B + i];
            x.split(ops[O_POS1 * B + i], ref, client);
            if (is_range) {
                x.split(ops[O_POS2 * B + i], ref, client);
                x.cover(i, type == OP_REMOVE);
            } else {
                x.insert(i);
            }
        }
        if (x.n > C) x.err |= ERR_CAPACITY;
    }

    for (int i = tid; i < C; i += NT) {
#pragma unroll
        for (int c = 0; c < 5; ++c) a.col_out[c][tc + i] = x.h(c, i);
    }
    for (int i = tid; i < C * KR; i += NT)
        a.rcl_out[tc * KR + i] = x.heap[(size_t)x.h(SLOT, i / KR) * W + i % KR];
    for (int i = tid; i < C * KK; i += NT)
        a.props_out[tc * KK + i] =
            x.heap[(size_t)x.h(SLOT, i / KK) * W + KR + i % KK];
    if (tid == 0) {
        a.n_rows_out[d] = x.n;
        a.err_out[d] = x.err;
    }
}

}  // namespace

// Shared bytes of one block: the hot columns, the chunk's ops, `Misc`.
static size_t smem_bytes(int C, int B, int PK) {
    const size_t cols = ((size_t)(HOT * C + OPC * B + 2 * B * PK) * 4 + 15) & ~(size_t)15;
    return cols + SMEM_MISC;
}

// ptrs: n_rows, error, buf, len, ins_seq, ins_client, rem_seq,
// rem_clients, props (inputs, [D, ...]); the 8 op columns, prop keys,
// prop values ([D, B], [D, B, PK]); buf, len, ins_seq, ins_client,
// rem_seq, rem_clients, props, n_rows, error (outputs); the heap.
extern "C" int mergetree_scan_launch(int device, int D, int C, int KR,
                                     int KK, int B, int PK, int NT, int R,
                                     int smem, int n_ptrs, void** ptrs,
                                     void* stream) {
    if (n_ptrs != N_PTRS || D < 1 || C < 1 || KR < 1 || KK < 0 || B < 0 ||
        PK < 0 || NT < 32 || NT > MAX_NT || NT % 32 || R < 1 ||
        R > MAX_RPT || (long long)NT * R < C || (long long)NT * (R - 1) >= C)
        return (int)cudaErrorInvalidValue;
    if ((size_t)smem != smem_bytes(C, B, PK) || smem > SMEM_OPTIN)
        return (int)cudaErrorInvalidValue;

    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    if (smem > SMEM_DEFAULT) {
        e = cudaFuncSetAttribute((const void*)mergetree_scan_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
        if (e != cudaSuccess) return (int)e;
    }

    Args a;
    a.D = D;
    a.C = C;
    a.KR = KR;
    a.KK = KK;
    a.B = B;
    a.PK = PK;
    a.R = R;
    int p = 0;
    a.n_rows_in = (const int*)ptrs[p++];
    a.err_in = (const int*)ptrs[p++];
    for (int c = 0; c < 5; ++c) a.col_in[c] = (const int*)ptrs[p++];
    a.rcl_in = (const int*)ptrs[p++];
    a.props_in = (const int*)ptrs[p++];
    for (int c = 0; c < OPC; ++c) a.op[c] = (const int*)ptrs[p++];
    a.prop_keys = (const int*)ptrs[p++];
    a.prop_vals = (const int*)ptrs[p++];
    for (int c = 0; c < 5; ++c) a.col_out[c] = (int*)ptrs[p++];
    a.rcl_out = (int*)ptrs[p++];
    a.props_out = (int*)ptrs[p++];
    a.n_rows_out = (int*)ptrs[p++];
    a.err_out = (int*)ptrs[p++];
    a.heap = (int*)ptrs[p++];

    mergetree_scan_kernel<<<(unsigned)D, NT, (size_t)smem, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
