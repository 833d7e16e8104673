// Row-model merge-tree chunk kernel for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_mergetree_chunk_kernel`
// (fluidframework_tpu/ops/mergetree_pallas.py:125, called through
// `apply_chunk` / `apply_chunk_at`). It applies a chunk of B sequenced
// insert/remove/annotate ops, one after another, to the full segment
// table of one document (rows in document order, rows [0, n_rows)
// live). Its plain PyTorch version is
// `ops/mergetree_chunk.apply_chunk_ref`, which it must equal on
// n_rows, error and rows [:n_rows] bit for bit.
//
// Per op, as the Pallas body does it: a boundary split at pos1; then
// the pos2 split of a range op or the landing of an insert (one suffix
// shift either way); then, for a range op, the covered-range removal
// (first free remover slot) or last-writer-wins annotate; sticky
// ERR_* flags. Like the port's plain version, an insert that finds no
// landing row in a full table flags ERR_CAPACITY (the Pallas kernel
// drops it without a flag); the table is left as the Pallas kernel
// leaves it.
//
// Design. One document's ops are serial, so one block of 1024 threads
// owns the document and loops over the chunk's ops; the op scalars are
// block-uniform, so every decision is a block-uniform branch.
//
// - The table lives in global memory (L2 resident: 19.4 MB at capacity
//   131072, KR 24, KK 8). The launcher copies it from the input to the
//   output buffers once; the kernel edits the outputs in place.
//   rem_clients and props stay row-major [C, K] as the torch tensors
//   are, so a row's slots are contiguous and a shift is a memmove.
// - `live` is always the prefix [0, n): it starts so, and the shifts
//   and the landing keep it so. Every pass covers only the live rows
//   (the landing's "first non-live row" is row n), and rows >= n are
//   never touched: they are scratch, and nothing reads them.
// - A visibility pass walks tiles of 4096 rows (4 contiguous rows per
//   thread, int4 loads). A row's KR remover slots are read only when
//   the row is removed. The exclusive prefix sum is a block-wide int32
//   scan with a running carry; the one-hot split / landing row of the
//   Pallas kernel is a shared-memory atomicMin. A pass stops at the
//   first tile that holds its row, or once the carry shows that no
//   later row can (prefixes only grow).
// - A shift is a top-down tiled memmove of rows [j, n) up by one, one
//   barrier per tile: the five [C] columns in one loop, then
//   rem_clients and props in 16-byte words (their rows are 96 and 32
//   bytes at the bench widths). One-row fix-ups (split head and tail,
//   the new row) are done by a few threads between barriers.
// - Sums wrap in int32, as on the TPU.
//
// What bounds it: one SM's bandwidth to L2 and the barrier chain of the
// passes and shifts, since one document's ops are serial. Spreading
// one op's passes over many SMs (a thread-block cluster or a
// cooperative grid) is left for later.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 1024;              // threads per block
constexpr int RPT = 4;                // rows per thread in a pass tile
constexpr int TILE = NT * RPT;        // rows per pass tile
constexpr int SHIFT_U = 4;            // rows per thread per tile of the [C] shift
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
constexpr int N_PTRS = 28;

struct Args {
    int C, KR, KK, B, PK;
    const int* n_rows_in;
    const int* err_in;
    const int* op[8];       // [B] type, pos1, pos2, seq, ref_seq, client, buf, len
    const int* prop_keys;   // [B, PK]
    const int* prop_vals;   // [B, PK]
    int* col[5];            // [C] buf, len, ins_seq, ins_client, rem_seq (in place)
    int* rcl;               // [C, KR]
    int* props;             // [C, KK]
    int* n_rows_out;
    int* err_out;
};

enum { BUF = 0, LEN = 1, ISEQ = 2, ICL = 3, RSEQ = 4 };

__device__ __forceinline__ int wrap_add(int a, int b) {
    return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
    return (int)((unsigned)a - (unsigned)b);
}

__device__ __forceinline__ int warp_incl_scan(int v, int lane) {
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        int u = __shfl_up_sync(FULL, v, o);
        if (lane >= o) v = wrap_add(v, u);
    }
    return v;
}

// Block-wide exclusive int32 scan of RPT values per thread (row order =
// thread order). Returns the tile total. One __syncthreads; callers
// alternate `buf` between consecutive scans.
__device__ int block_excl_scan(const int (&d)[RPT], int (&ex)[RPT], int* buf) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    int s = 0;
#pragma unroll
    for (int r = 0; r < RPT; ++r) s = wrap_add(s, d[r]);
    int inc = warp_incl_scan(s, lane);
    if (lane == 31) buf[wid] = inc;
    __syncthreads();
    int wt = buf[lane];  // NT / 32 == 32 warps
    int winc = warp_incl_scan(wt, lane);
    int wbase = __shfl_sync(FULL, wrap_sub(winc, wt), wid);
    int total = __shfl_sync(FULL, winc, 31);
    int run = wrap_add(wbase, wrap_sub(inc, s));
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
        ex[r] = run;
        run = wrap_add(run, d[r]);
    }
    return total;
}

// Per-block state shared by the passes.
struct Shared {
    int scan[2][32];
    unsigned long long key[2];
    int err;
};

struct Doc {
    int* c[5];
    int* rcl;
    int* props;
    int C, KR, KK;
    int n;       // live rows: the prefix [0, n)
    int err;     // block-uniform ERR_* flags
    int phase;   // alternates the scan buffers
    int kphase;  // alternates the pass keys
};

// One pass tile: visibility of the thread's RPT rows at (ref, client)
// and their exclusive visible-length prefix. `rs` and `is` return the
// rows' rem_seq and ins_seq. Returns the tile's total.
__device__ int vis_tile(Doc& d, Shared& sh, int r0, int ref, int client,
                        int (&vis)[RPT], bool (&skip)[RPT], int (&pre)[RPT],
                        int (&rs)[RPT], int (&is)[RPT], int carry) {
    if (r0 < d.n) {
        const int4 L = *reinterpret_cast<const int4*>(d.c[LEN] + r0);
        const int4 S = *reinterpret_cast<const int4*>(d.c[ISEQ] + r0);
        const int4 I = *reinterpret_cast<const int4*>(d.c[ICL] + r0);
        const int4 R = *reinterpret_cast<const int4*>(d.c[RSEQ] + r0);
        const int lv[RPT] = {L.x, L.y, L.z, L.w};
        const int sv[RPT] = {S.x, S.y, S.z, S.w};
        const int iv[RPT] = {I.x, I.y, I.z, I.w};
        const int rv[RPT] = {R.x, R.y, R.z, R.w};
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
            const int row = r0 + r;
            rs[r] = rv[r];
            is[r] = sv[r];
            const bool live = row < d.n;
            const bool removed = rv[r] != NOT_REMOVED;
            const bool tomb = removed && rv[r] <= ref;
            const bool ins_vis = iv[r] == client || sv[r] <= ref;
            skip[r] = !live || tomb || (removed && !ins_vis);
            bool visible = !skip[r] && ins_vis;
            if (visible && removed) {
                const int* rc = d.rcl + (size_t)row * d.KR;
                for (int k = 0; k < d.KR; ++k) {
                    if (rc[k] == client) {
                        visible = false;
                        break;
                    }
                }
            }
            vis[r] = visible ? lv[r] : 0;
        }
    } else {
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
            vis[r] = 0;
            skip[r] = true;
            rs[r] = NOT_REMOVED;
            is[r] = 0;
        }
    }
    int ex[RPT];
    const int total = block_excl_scan(vis, ex, sh.scan[d.phase++ & 1]);
#pragma unroll
    for (int r = 0; r < RPT; ++r) pre[r] = wrap_add(carry, ex[r]);
    return total;
}

// A fresh pass key: reset by thread 0, then one barrier. Keys
// alternate, so the reset never races the previous pass's readers.
__device__ unsigned long long* new_key(Doc& d, Shared& sh) {
    unsigned long long* key = &sh.key[d.kphase++ & 1];
    if (threadIdx.x == 0) *key = NONE;
    __syncthreads();
    return key;
}

// The row strictly containing visible position `pos` (the one-hot
// `inside` of the Pallas split), as (row, prefix) in `j`/`pre_j`.
__device__ bool find_split(Doc& d, Shared& sh, int pos, int ref, int client,
                           int& j, int& pre_j) {
    unsigned long long* key = new_key(d, sh);
    int carry = 0;
    for (int base = 0; base < d.n; base += TILE) {
        const int r0 = base + threadIdx.x * RPT;
        int vis[RPT], pre[RPT], rs[RPT], is[RPT];
        bool skip[RPT];
        const int tot = vis_tile(d, sh, r0, ref, client, vis, skip, pre, rs,
                                 is, carry);
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
            if (!skip[r] && pre[r] < pos && wrap_add(pre[r], vis[r]) > pos) {
                atomicMin(key, ((unsigned long long)(r0 + r) << 32) |
                                   (unsigned)pre[r]);
            }
        }
        __syncthreads();
        const unsigned long long k = *key;
        carry = wrap_add(carry, tot);
        if (k != NONE) {
            j = (int)(k >> 32);
            pre_j = (int)(unsigned)(k & 0xffffffffu);
            return true;
        }
        if (carry >= pos) break;  // every later row has prefix >= pos
    }
    return false;
}

// The insert's landing row among the live rows (insertingWalk +
// breakTie): the first non-skip row at/after pos1 that is visible or
// loses the tie-break. Returns false when there is none; `total` is
// then the visible total.
__device__ bool find_land(Doc& d, Shared& sh, int pos1, int oseq, int ref,
                          int client, int& j, int& total) {
    unsigned long long* key = new_key(d, sh);
    int carry = 0;
    for (int base = 0; base < d.n; base += TILE) {
        const int r0 = base + threadIdx.x * RPT;
        int vis[RPT], pre[RPT], rs[RPT], is[RPT];
        bool skip[RPT];
        const int tot = vis_tile(d, sh, r0, ref, client, vis, skip, pre, rs,
                                 is, carry);
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
            if (!skip[r] && pre[r] >= pos1 && (vis[r] > 0 || oseq > is[r])) {
                atomicMin(key, (unsigned long long)(r0 + r));
            }
        }
        __syncthreads();
        const unsigned long long k = *key;
        carry = wrap_add(carry, tot);
        if (k != NONE) {
            j = (int)k;
            return true;
        }
    }
    total = carry;
    return false;
}

// The shifts are memmoves of rows [lo-1, lim-1) to [lo, lim), done in
// tiles from the top down. A tile's reads lie below every earlier
// tile's writes, and its writes follow a barrier after which every
// earlier read is done, so one __syncthreads per tile suffices.

// The five [C] columns together, SHIFT_U rows per thread per tile.
__device__ void shift_cols1(Doc& d, int lo, int lim) {
    const int TE = NT * SHIFT_U;
    for (int top = lim; top > lo; top -= TE) {
        const int bot = max(top - TE, lo);
        int v[5][SHIFT_U];
#pragma unroll
        for (int q = 0; q < SHIFT_U; ++q) {
            const int i = bot + q * NT + threadIdx.x;
            if (i < top) {
#pragma unroll
                for (int c = 0; c < 5; ++c) v[c][q] = d.c[c][i - 1];
            }
        }
        __syncthreads();
#pragma unroll
        for (int q = 0; q < SHIFT_U; ++q) {
            const int i = bot + q * NT + threadIdx.x;
            if (i < top) {
#pragma unroll
                for (int c = 0; c < 5; ++c) d.c[c][i] = v[c][q];
            }
        }
    }
}

// A row-major [C, K] array. When K is a multiple of 4 every row starts
// on 16 bytes (the buffers come from the caching allocator), so the
// move goes in int4s; otherwise in ints.
template <typename V>
__device__ void shift_rows_of(V* base, long long K, int lo, int lim) {
    constexpr int U = 16 * sizeof(int) / sizeof(V);  // 64 bytes per thread
    const long long d0 = lo * K, d1 = lim * K;
    const int TE = NT * U;
    for (long long top = d1; top > d0; top -= TE) {
        const long long bot = top - TE > d0 ? top - TE : d0;
        V v[U];
#pragma unroll
        for (int q = 0; q < U; ++q) {
            const long long i = bot + q * NT + threadIdx.x;
            if (i < top) v[q] = base[i - K];
        }
        __syncthreads();
#pragma unroll
        for (int q = 0; q < U; ++q) {
            const long long i = bot + q * NT + threadIdx.x;
            if (i < top) base[i] = v[q];
        }
    }
}

__device__ void shift_slots(int* base, int K, int lo, int lim) {
    if (K % 4 == 0) {
        shift_rows_of(reinterpret_cast<int4*>(base), K / 4, lo, lim);
    } else {
        shift_rows_of(base, K, lo, lim);
    }
}

// Rows [lo, lim) take rows [lo-1, lim-1) in every column; ends with a
// barrier.
__device__ void shift_rows(Doc& d, int lo, int lim) {
    if (lo < lim) {
        shift_cols1(d, lo, lim);
        shift_slots(d.rcl, d.KR, lo, lim);
        shift_slots(d.props, d.KK, lo, lim);
    }
    __syncthreads();
}

// Boundary split at visible position `pos` (ensureIntervalBoundary):
// the row j strictly containing it keeps [0, off) and a copy at j+1
// (the shifted row) takes [off, len).
__device__ void split_at(Doc& d, Shared& sh, int pos, int ref, int client) {
    int j, pre_j;
    if (!find_split(d, sh, pos, ref, client, j, pre_j)) return;
    const int off = wrap_sub(pos, pre_j);
    // A live last row pushed off the end (keep[C-1] is false unless
    // j is the last row itself).
    if (d.n == d.C && j + 1 < d.C) d.err |= ERR_CAPACITY;
    const int lim = min(d.n + 1, d.C);
    shift_rows(d, j + 1, lim);
    if (threadIdx.x == 0) {
        if (j + 1 < d.C) {
            d.c[BUF][j + 1] = wrap_add(d.c[BUF][j + 1], off);
            d.c[LEN][j + 1] = wrap_sub(d.c[LEN][j + 1], off);
        }
        d.c[LEN][j] = off;
    }
    __syncthreads();
    d.n = lim;
}

__device__ void insert_op(Doc& d, Shared& sh, const Args& a, int i, int pos1,
                          int oseq, int ref, int client) {
    int j, total = 0;
    if (!find_land(d, sh, pos1, oseq, ref, client, j, total)) {
        if (d.n == d.C) {
            // No landing row in a full table: the insert would open
            // row C. Flagged; the table is left as it is.
            d.err |= ERR_CAPACITY;
            return;
        }
        j = d.n;  // the first non-live row: the end boundary
        if (total < pos1) d.err |= ERR_BAD_POS;
    }
    if (d.n == d.C) d.err |= ERR_CAPACITY;
    const int lim = min(d.n + 1, d.C);
    shift_rows(d, j + 1, lim);
    const int tid = threadIdx.x;
    if (tid == 0) {
        d.c[BUF][j] = __ldg(a.op[6] + i);
        d.c[LEN][j] = __ldg(a.op[7] + i);
        d.c[ISEQ][j] = oseq;
        d.c[ICL][j] = client;
        d.c[RSEQ][j] = NOT_REMOVED;
    }
    if (tid < d.KR) d.rcl[(size_t)j * d.KR + tid] = NO_CLIENT;
    if (tid < d.KK) {
        int v = PROP_ABSENT;
        for (int p = 0; p < a.PK; ++p) {
            const int key = __ldg(a.prop_keys + (size_t)i * a.PK + p);
            const int val = __ldg(a.prop_vals + (size_t)i * a.PK + p);
            if (key == tid) v = val == PROP_DELETE ? PROP_ABSENT : val;
        }
        d.props[(size_t)j * d.KK + tid] = v;
    }
    __syncthreads();
    d.n = lim;
}

// Covered-range updates of a range op [pos1, pos2): removal or
// annotate, each row by its own thread; ERR_BAD_POS when the visible
// total is below pos2.
__device__ void covered_op(Doc& d, Shared& sh, const Args& a, int i,
                           bool is_rem, int pos1, int pos2, int oseq, int ref,
                           int client) {
    int carry = 0;
    int err = 0;
    for (int base = 0; base < d.n && carry < pos2; base += TILE) {
        const int r0 = base + threadIdx.x * RPT;
        int vis[RPT], pre[RPT], rs[RPT], is[RPT];
        bool skip[RPT];
        const int tot = vis_tile(d, sh, r0, ref, client, vis, skip, pre, rs,
                                 is, carry);
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
            if (skip[r] || vis[r] <= 0 || pre[r] < pos1 ||
                wrap_add(pre[r], vis[r]) > pos2)
                continue;
            const int row = r0 + r;
            if (is_rem) {
                const bool already = rs[r] != NOT_REMOVED;
                if (!already) d.c[RSEQ][row] = oseq;
                int* rc = d.rcl + (size_t)row * d.KR;
                int first_free = d.KR;
                for (int k = d.KR - 1; k >= 0; --k)
                    if (rc[k] == NO_CLIENT) first_free = k;
                const bool no_free = first_free == d.KR;
                if (already && no_free) {
                    err |= ERR_REMOVERS;
                } else {
                    rc[already ? first_free : 0] = client;
                }
            } else {
                int* pr = d.props + (size_t)row * d.KK;
                for (int p = 0; p < a.PK; ++p) {
                    const int key = __ldg(a.prop_keys + (size_t)i * a.PK + p);
                    const int val = __ldg(a.prop_vals + (size_t)i * a.PK + p);
                    if (key != NO_KEY && key >= 0 && key < d.KK)
                        pr[key] = val == PROP_DELETE ? PROP_ABSENT : val;
                }
            }
        }
        carry = wrap_add(carry, tot);
    }
    // Stopped early only once carry >= pos2, so the total is too.
    if (carry < pos2) d.err |= ERR_BAD_POS;
    if (err) atomicOr(&sh.err, err);
    __syncthreads();
}

__global__ void __launch_bounds__(NT, 1) mergetree_chunk_kernel(Args a) {
    __shared__ Shared sh;
    Doc d;
    for (int c = 0; c < 5; ++c) d.c[c] = a.col[c];
    d.rcl = a.rcl;
    d.props = a.props;
    d.C = a.C;
    d.KR = a.KR;
    d.KK = a.KK;
    d.n = min(max(*a.n_rows_in, 0), a.C);
    d.err = 0;
    d.phase = 0;
    d.kphase = 0;
    if (threadIdx.x == 0) sh.err = 0;
    __syncthreads();

    for (int i = 0; i < a.B; ++i) {
        const int otype = __ldg(a.op[0] + i);
        const bool is_ins = otype == OP_INSERT;
        const bool is_rem = otype == OP_REMOVE;
        const bool is_range = is_rem || otype == OP_ANNOTATE;
        if (!is_ins && !is_range) continue;  // NOOP: every mask is empty
        const int pos1 = __ldg(a.op[1] + i);
        const int pos2 = __ldg(a.op[2] + i);
        const int oseq = __ldg(a.op[3] + i);
        const int ref = __ldg(a.op[4] + i);
        const int client = __ldg(a.op[5] + i);

        split_at(d, sh, pos1, ref, client);
        if (is_ins) {
            insert_op(d, sh, a, i, pos1, oseq, ref, client);
        } else {
            split_at(d, sh, pos2, ref, client);
            covered_op(d, sh, a, i, is_rem, pos1, pos2, oseq, ref, client);
        }
    }

    __syncthreads();
    if (threadIdx.x == 0) {
        *a.n_rows_out = d.n;
        *a.err_out = *a.err_in | d.err | sh.err;
    }
}

}  // namespace

// Plain C entry point (loaded with ctypes). `ptrs` holds, in order:
// n_rows, error, buf_start, length, ins_seq, ins_client, rem_seq,
// rem_clients, props, op_type, pos1, pos2, seq, ref_seq, client,
// buf_start, ins_len, prop_keys, prop_vals (inputs), then buf_start,
// length, ins_seq, ins_client, rem_seq, rem_clients, props, n_rows,
// error (outputs). Copies the table into the outputs and launches on
// `stream`; returns the first CUDA error (0 when the launch was
// accepted).
extern "C" int mergetree_chunk_launch(int device, int C, int KR, int KK,
                                      int B, int PK, int n_ptrs, void** ptrs,
                                      void* stream) {
    // int4 row loads: C must be a multiple of RPT (the wrapper asks 1024).
    if (n_ptrs != N_PTRS || C <= 0 || C % RPT != 0 || KR < 1)
        return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    cudaStream_t s = (cudaStream_t)stream;
    Args a;
    a.C = C;
    a.KR = KR;
    a.KK = KK;
    a.B = B;
    a.PK = PK;
    a.n_rows_in = (const int*)ptrs[0];
    a.err_in = (const int*)ptrs[1];
    const void* cols_in[7];
    for (int c = 0; c < 7; ++c) cols_in[c] = ptrs[2 + c];
    for (int c = 0; c < 8; ++c) a.op[c] = (const int*)ptrs[9 + c];
    a.prop_keys = (const int*)ptrs[17];
    a.prop_vals = (const int*)ptrs[18];
    for (int c = 0; c < 5; ++c) a.col[c] = (int*)ptrs[19 + c];
    a.rcl = (int*)ptrs[24];
    a.props = (int*)ptrs[25];
    a.n_rows_out = (int*)ptrs[26];
    a.err_out = (int*)ptrs[27];
    const size_t widths[7] = {1, 1, 1, 1, 1, (size_t)KR, (size_t)KK};
    void* cols_out[7] = {a.col[0], a.col[1], a.col[2], a.col[3], a.col[4],
                         a.rcl, a.props};
    for (int c = 0; c < 7; ++c) {
        e = cudaMemcpyAsync(cols_out[c], cols_in[c],
                            (size_t)C * widths[c] * sizeof(int),
                            cudaMemcpyDeviceToDevice, s);
        if (e != cudaSuccess) return (int)e;
    }
    mergetree_chunk_kernel<<<1, NT, 0, s>>>(a);
    return (int)cudaGetLastError();
}
