// Row-model merge-tree chunk kernel for Hopper (sm_90a): a cooperative
// grid that owns the table by row ranges.
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
// One document's ops are serial. The design spreads each op, not the
// ops, over the card: a persistent cooperative grid of G <= #SMs
// blocks, block b owning table rows [b*R, min((b+1)*R, C)) for the
// whole chunk (`kernel_geometry` in ops/mergetree_chunk.py picks G and
// R; R = 1024 and G = 128 at capacity 131072). Every op scalar is
// grid-uniform, so every block takes the same branches.
//
// - Hot columns in shared memory. A block loads its rows' buf_start,
//   length, ins_seq, ins_client and rem_seq once (cp.async) and keeps
//   them, with a sixth column `slot`, in shared memory for the chunk:
//   24 bytes per row. The chunk's ops go to shared memory too.
// - Cold columns behind a slot. rem_clients [C, KR] and props [C, KK]
//   live in a global heap of C + 2B rows of KR + KK ints; row i's cold
//   data is heap[slot[i]]. The launcher fills heap rows [0, C) from the
//   input and slot[i] = i; a split tail or a landed insert takes the
//   next heap row (a grid-uniform counter: every block sees the same
//   decisions), so a shift moves 24 bytes a row and never the cold
//   columns. At the end each block writes its rows < n_rows back,
//   gathering heap[slot[i]]. The inputs are never written.
// - A pass is a local scan and one grid barrier. Each block computes
//   the visibility and visible length of its live rows and their local
//   exclusive prefix (int32, wrapping), publishes its total (and, for a
//   landing, the local prefix of its last candidate row) plus its top
//   row's hot columns, and crosses the barrier. Then warp 0 of every
//   block scans the G totals for the block's carry, the visible total,
//   and the owner of the op's row: the landing row lies in the first
//   block whose last candidate's prefix reaches pos1; the split row can
//   only lie in the one block with carry < pos < carry + total, but pos
//   may fall on a row boundary there, so a split pass also publishes
//   every row's (local prefix, visible length) and the blocks from the
//   owner up read the owner's to find the row, or that there is none,
//   without a second barrier (the blocks below it take the new row
//   count from the next pass's partials). Both rules read the prefix as
//   increasing, which holds while the document's visible length fits in
//   int32, as the single-block kernel's early stop assumed.
// - A shift is local. Each block above the split / landing row moves
//   its live rows up by one in shared memory and takes its bottom row
//   from block b-1's published top row (applying the split tail's
//   offset when that row was the split row); row C-1 falls off the end
//   of the last block (ERR_CAPACITY, and its heap row is left unused).
// - Partials and published rows are double-buffered by pass parity: a
//   block writes pass k+2's data only after every block has crossed
//   pass k+1's barrier, i.e. finished reading pass k's. Cross-block
//   reads go through L2 (ld.global.cg). Errors are ORed per block into
//   the output word at the end.
//
// Barriers per op: 2 for an insert (split at pos1, landing pass), 3 for
// a remove or annotate (split at pos1, split at pos2, covered pass); 0
// for a NOOP. The grid barrier is a ticket counter in global memory
// (legal because the cooperative launch guarantees that all G blocks
// are co-resident).
//
// What bounds it: the latency of the grid barriers times the barriers
// per op, and the block-local shared-memory passes between them; not
// L2 bandwidth, and almost not the table size (one row per thread at
// R = 1024). Capacity ceiling: R <= 8192 rows per block (8 rows per
// thread) that fit the 227 KB of opt-in shared memory with the chunk's
// ops, i.e. C <= 8192 * #SMs = 1,081,344 rows on 132 SMs;
// `kernel_geometry` raises above it and the launcher refuses it.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int MAX_NT = 1024;         // threads per block at most
constexpr int MAX_R = 8192;          // rows per block at most
constexpr int ROW_QUANTUM = 32;
constexpr int HOT = 6;               // hot columns in shared memory
constexpr int OPC = 8;               // op columns
constexpr int SMEM_MISC = 1024;      // bytes of `Misc`, rounded up
constexpr int MAXK = 8;              // partials per lane of warp 0: G <= 256
constexpr int EXW = 8;               // words of a published top row
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
constexpr unsigned NO_OWNER = 0xffffffffu;
constexpr int N_PTRS = 30;

enum { BUF = 0, LEN = 1, ISEQ = 2, ICL = 3, RSEQ = 4, SLOT = 5 };
enum { SPLIT = 0, LAND = 1, COVER = 2 };

struct Args {
    int C, KR, KK, B, PK, R, G;
    const int* n_rows_in;
    const int* err_in;
    const int* col_in[5];   // [C] buf, len, ins_seq, ins_client, rem_seq
    const int* op[OPC];     // [B] type, pos1, pos2, seq, ref_seq, client, buf, len
    const int* prop_keys;   // [B, PK]
    const int* prop_vals;   // [B, PK]
    int* col_out[5];        // [C]
    int* rcl_out;           // [C, KR]
    int* props_out;         // [C, KK]
    int* n_rows_out;
    int* err_out;
    int* heap;              // [C + 2B, KR + KK] cold rows
    unsigned* bar;          // the barrier's arrival count
    int* part;              // [2][G][4] total, has candidate, its prefix
    int* exch;              // [2][G][EXW] top row: 6 hot columns
    int2* rows;             // [2][C] local prefix, visible length (split passes)
};

// Per-block scratch in shared memory, after the hot columns and ops.
struct Misc {
    unsigned long long lkey;  // (row + 1, prefix) of the last landing candidate, max
    unsigned long long skey;  // (row, prefix) of the split row, min
    int scan[2][32];
    int jmin;                 // the landing row, min
    int carry, total, owner, carry_owner;
    int err;                  // flags found by single threads
    int tail_src;             // heap row a crossing split tail copies
    int n;                    // the live rows the last block published
    int inc[EXW];             // the bottom row a block takes in
};
static_assert(sizeof(Misc) <= SMEM_MISC, "Misc outgrew its shared bytes");

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

// Block-wide exclusive int32 scan of one value per thread (thread
// order). Returns the exclusive prefix and the block total in `total`.
// One __syncthreads; callers alternate `buf` between scans.
__device__ int block_excl_scan(int v, int* buf, int& total) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    const int inc = warp_incl_scan(v, lane);
    if (lane == 31) buf[wid] = inc;
    __syncthreads();
    const int wt = lane < nw ? buf[lane] : 0;
    const int winc = warp_incl_scan(wt, lane);
    const int wbase = __shfl_sync(FULL, wrap_sub(winc, wt), wid);
    total = __shfl_sync(FULL, winc, 31);
    return wrap_add(wbase, wrap_sub(inc, v));
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
    unsigned v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                 : "=r"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void red_release_add(unsigned* p, unsigned v) {
    asm volatile("red.release.gpu.global.add.u32 [%0], %1;"
                 :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                 :: "r"(s), "l"(src) : "memory");
}

// The block's view of the document, grid-uniform but for `b`, `lo`,
// `nb`.
struct Ctx {
    int* heap;       // Args::heap
    unsigned* bar;   // Args::bar
    int* part;       // Args::part
    int* exch;       // Args::exch
    int2* rows;      // Args::rows
    int* hot;        // [HOT][R] in shared memory
    const int* ops;  // [OPC][B] in shared memory
    const int* pk;   // [B * PK]
    const int* pv;   // [B * PK]
    Misc* m;
    int R, C, G, W, KR, KK, PK, B;
    int b, lo, nb;   // block index, first row, rows owned
    int n;           // live rows: the prefix [0, n)
    int next_slot;   // next free heap row
    int err;         // grid-uniform ERR_* flags
    int ph;          // pass parity of the partials and published rows
    int sc;          // alternates the scan buffers
    unsigned gen;    // barriers crossed
};

__device__ __forceinline__ int& H(Ctx& x, int c, int i) {
    return x.hot[c * x.R + i];
}

// Grid-wide barrier: every block's writes before it are seen by every
// block after it. A ticket counter that only grows (zeroed by the
// launcher): barrier k is passed once it reads k * G arrivals; a launch
// crosses at most 3 * B barriers, far from wrapping.
__device__ void grid_sync(Ctx& x) {
    __syncthreads();
    x.gen += 1;
    if (threadIdx.x == 0) {
        // The block's writes, ordered by the barrier above, are
        // released to the grid by thread 0's fence and arrival.
        __threadfence();
        const unsigned target = x.gen * (unsigned)x.G;
        red_release_add(x.bar, 1u);
        while (ld_acquire(x.bar) < target) {
        }
        __threadfence();
    }
    __syncthreads();
}

// Rows [a, e) of the block take rows [a-1, e-1); row 0 takes `inc`
// (shared memory) when a == 0. Top-down tiles of blockDim.x rows: a
// tile's reads lie below every earlier tile's writes, so one barrier
// between its reads and its writes suffices. Ends with a barrier.
__device__ void shift_up(Ctx& x, int a, int e, const int* inc) {
    const int NT = blockDim.x;
    for (int top = e; top > a; top -= NT) {
        const int i = top - 1 - (int)threadIdx.x;
        const bool act = i >= a;
        int v[HOT];
        if (act) {
#pragma unroll
            for (int c = 0; c < HOT; ++c) v[c] = i > 0 ? H(x, c, i - 1) : inc[c];
        }
        __syncthreads();
        if (act) {
#pragma unroll
            for (int c = 0; c < HOT; ++c) H(x, c, i) = v[c];
        }
    }
    __syncthreads();
}

// heap[dst] = heap[src] (one cold row). The caller synchronises.
__device__ void copy_cold(Ctx& x, int dst, int src) {
    int* h = x.heap;
    for (int t = threadIdx.x; t < x.W; t += blockDim.x)
        h[(size_t)dst * x.W + t] = __ldcg(h + (size_t)src * x.W + t);
}

// After a barrier, warp 0 reads the G partials of this pass: the
// block's carry, the visible total, the owner block of the op's row
// (`mode`: the only block that can hold the split row at `pos`, or the
// block of the landing row at/after `pos`) with the owner's carry, and
// the live row count as the last block published it (which every block
// then takes); beside them, block b-1's published top row into m->inc.
// Ends with a barrier.
__device__ void resolve(Ctx& x, int mode, int pos) {
    Misc* m = x.m;
    if (threadIdx.x < 32) {
        const int lane = threadIdx.x;
        const int K = (x.G + 31) / 32;
        const int4* part =
            reinterpret_cast<const int4*>(x.part) + (size_t)x.ph * x.G;
        int4 p[MAXK];
        int s = 0;
#pragma unroll
        for (int q = 0; q < MAXK; ++q) {
            const int t = lane * K + q;
            p[q] = (q < K && t < x.G) ? __ldcg(part + t) : make_int4(0, 0, 0, 0);
            s = wrap_add(s, p[q].x);
        }
        const int inc = warp_incl_scan(s, lane);
        const int total = __shfl_sync(FULL, inc, 31);
        int c = wrap_sub(inc, s);
        unsigned cand = NO_OWNER;
        int cand_carry = 0, self_carry = 0, last_n = 0;
#pragma unroll
        for (int q = 0; q < MAXK; ++q) {
            const int t = lane * K + q;
            if (q < K && t < x.G) {
                if (t == x.b) self_carry = c;
                if (t == x.G - 1) last_n = p[q].w;
                const bool hit =
                    mode == SPLIT ? (c < pos && wrap_add(c, p[q].x) > pos)
                    : mode == LAND ? (p[q].y != 0 && wrap_add(c, p[q].z) >= pos)
                                   : false;
                if (hit && cand == NO_OWNER) {
                    cand = (unsigned)t;
                    cand_carry = c;
                }
                c = wrap_add(c, p[q].x);
            }
        }
        const unsigned owner = __reduce_min_sync(FULL, cand);
        const int co = __shfl_sync(FULL, cand_carry,
                                   owner == NO_OWNER ? 0 : (int)owner / K);
        const int sc = __shfl_sync(FULL, self_carry, x.b / K);
        const int ln = __shfl_sync(FULL, last_n, (x.G - 1) / K);
        if (lane == 0) {
            m->carry = sc;
            m->total = total;
            m->owner = (int)owner;
            m->carry_owner = co;
            m->n = ln;
            m->skey = ~0ull;
            m->jmin = INT_MAX;
        }
    } else if (threadIdx.x < 32 + HOT && mode != COVER && x.b > 0) {
        // Block b-1's top row as published in this pass, the row a
        // shift takes in, read beside the partials.
        const int c = threadIdx.x - 32;
        m->inc[c] = __ldcg(x.exch + ((size_t)x.ph * x.G + x.b - 1) * EXW + c);
    }
    __syncthreads();
    x.n = m->n;
}

// One pass of an op over the block's live rows: visibility at (ref,
// client), visible lengths `vis` and local exclusive prefixes `lpre`
// of the thread's RPT rows (rows tid*RPT + r), landing candidates in
// `elig`; then publish, grid barrier, resolve. Leaves x.ph at this
// pass's parity (the caller flips it once done with the published
// rows).
template <int RPT>
__device__ void pass(Ctx& x, int mode, int pos, int oseq, int ref, int client,
                     int (&vis)[RPT], int (&lpre)[RPT], unsigned& elig) {
    const int tid = threadIdx.x;
    const int* heap = x.heap;
    int sum = 0;
    elig = 0;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
        const int li = tid * RPT + r;
        int v = 0;
        if (li < x.nb && x.lo + li < x.n) {
            const int rs = H(x, RSEQ, li), is = H(x, ISEQ, li);
            const bool removed = rs != NOT_REMOVED;
            const bool tomb = removed && rs <= ref;
            const bool ins_vis = H(x, ICL, li) == client || is <= ref;
            const bool skip = tomb || (removed && !ins_vis);
            bool visible = !skip && ins_vis;
            if (visible && removed) {
                // Among the removers? All slots loaded at once: 16-byte
                // loads when the heap rows allow them.
                const int* rc = heap + (size_t)H(x, SLOT, li) * x.W;
                bool among = false;
                if (((x.KR | x.W) & 3) == 0) {
                    const int4* r4 = reinterpret_cast<const int4*>(rc);
#pragma unroll 8
                    for (int k = 0; k < x.KR / 4; ++k) {
                        const int4 q = __ldcg(r4 + k);
                        among |= (q.x == client) | (q.y == client) |
                                 (q.z == client) | (q.w == client);
                    }
                } else {
#pragma unroll 8
                    for (int k = 0; k < x.KR; ++k) among |= __ldcg(rc + k) == client;
                }
                visible = !among;
            }
            v = visible ? H(x, LEN, li) : 0;
            if (!skip && (v > 0 || oseq > is)) elig |= 1u << r;
        }
        vis[r] = v;
        sum = wrap_add(sum, v);
    }
    int total;
    int run = block_excl_scan(sum, x.m->scan[x.sc++ & 1], total);
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
        lpre[r] = run;
        run = wrap_add(run, vis[r]);
    }
    if (mode == LAND && elig) {
        const int rl = 31 - __clz(elig);
        int lp = 0;
#pragma unroll
        for (int r = 0; r < RPT; ++r)
            if (r == rl) lp = lpre[r];
        atomicMax(&x.m->lkey,
                  ((unsigned long long)(tid * RPT + rl + 1) << 32) | (unsigned)lp);
    }
    __syncthreads();
    if (tid == 0) {
        const unsigned long long k = x.m->lkey;
        reinterpret_cast<int4*>(x.part)[(size_t)x.ph * x.G + x.b] =
            make_int4(total, k != 0, (int)(unsigned)(k & 0xffffffffu), x.n);
        x.m->lkey = 0;
    }
    if (mode != COVER) {
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
            const int li = tid * RPT + r;
            if (li == x.nb - 1) {
                int* e = x.exch + ((size_t)x.ph * x.G + x.b) * EXW;
#pragma unroll
                for (int c = 0; c < HOT; ++c) e[c] = H(x, c, li);
            }
        }
    }
    if (mode == SPLIT) {
        int2* rows = x.rows + (size_t)x.ph * x.C + x.lo;
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
            const int li = tid * RPT + r;
            if (li < x.nb) rows[li] = make_int2(lpre[r], vis[r]);
        }
    }
    grid_sync(x);
    resolve(x, mode, pos);
}

// The bottom row a block takes in is block b-1's top row, which
// `resolve` read into m->inc. With `tail` (that row was the split row)
// it becomes the split tail: offset `off` and the fresh heap row
// `slot_new`; m->tail_src is then the heap row to copy, else -1. Ends
// with a barrier.
__device__ void take_in(Ctx& x, bool tail, int off, int slot_new) {
    Misc* m = x.m;
    if (threadIdx.x == 0) {
        m->tail_src = -1;
        if (tail) {
            m->inc[BUF] = wrap_add(m->inc[BUF], off);
            m->inc[LEN] = wrap_sub(m->inc[LEN], off);
            m->tail_src = m->inc[SLOT];
            m->inc[SLOT] = slot_new;
        }
    }
    __syncthreads();
}

// Boundary split at visible position `pos` (ensureIntervalBoundary):
// the row j strictly containing it keeps [0, off) and a copy at j+1
// (the shifted row, with a fresh heap row) takes [off, len).
//
// The partials name the only block that can hold j, but pos may fall
// on a row boundary there, and then nothing splits. So every block from
// the owner up reads the owner's published (prefix, length) rows to
// find j; blocks below the owner need nothing (all their rows are live
// and stay put) and take the new row count from the next pass's
// partials.
template <int RPT>
__device__ void split_step(Ctx& x, int pos, int ref, int client) {
    int vis[RPT], lpre[RPT];
    unsigned elig;
    pass<RPT>(x, SPLIT, pos, 0, ref, client, vis, lpre, elig);
    const int ph = x.ph;
    x.ph ^= 1;
    Misc* m = x.m;
    const int owner = m->owner;
    if (owner == (int)NO_OWNER) return;
    const int slot_new = x.next_slot++;  // taken even when nothing splits
    if (x.b < owner) return;
    const int olo = owner * x.R;
    const int onb = min(x.R, x.C - olo);
    const int co = m->carry_owner;
    const int2* rows = x.rows + (size_t)ph * x.C + olo;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
        const int li = (int)threadIdx.x * RPT + r;
        if (li < onb) {
            const int2 q = __ldcg(rows + li);
            const int pre = wrap_add(co, q.x);
            if (q.y > 0 && pre < pos && wrap_add(pre, q.y) > pos)
                atomicMin(&m->skey, ((unsigned long long)li << 32) | (unsigned)pre);
        }
    }
    __syncthreads();
    const unsigned long long k = m->skey;
    if (k == ~0ull) return;  // pos is a row boundary
    const int j = (int)(k >> 32);  // a row of the owner block
    const int off = wrap_sub(pos, (int)(unsigned)(k & 0xffffffffu));
    const int lim = min(x.n + 1, x.C);
    const int top = min(x.nb, lim - x.lo);  // local rows < top may move
    if (x.b == owner) {
        shift_up(x, j + 1, top, nullptr);
        const bool tail = j + 1 < top;
        if (threadIdx.x == 0) {
            // A live last row pushed off the end.
            if (x.n == x.C && x.lo + j + 1 < x.C) atomicOr(&m->err, ERR_CAPACITY);
            if (tail) {
                H(x, BUF, j + 1) = wrap_add(H(x, BUF, j + 1), off);
                H(x, LEN, j + 1) = wrap_sub(H(x, LEN, j + 1), off);
                H(x, SLOT, j + 1) = slot_new;
            }
            H(x, LEN, j) = off;
        }
        if (tail) copy_cold(x, slot_new, H(x, SLOT, j));
        __syncthreads();
    } else if (top > 0) {
        take_in(x, x.b == owner + 1 && j == onb - 1, off, slot_new);
        shift_up(x, 0, top, m->inc);
        if (m->tail_src >= 0) copy_cold(x, slot_new, m->tail_src);
        __syncthreads();
    }
    x.n = lim;
}

// The insert's landing (insertingWalk + breakTie): the first live
// non-skip row at/after pos1 that is visible or loses the tie-break,
// else row n; a fresh row opens there with a fresh heap row.
template <int RPT>
__device__ void insert_step(Ctx& x, int i, int pos1, int oseq, int ref,
                            int client) {
    int vis[RPT], lpre[RPT];
    unsigned elig;
    pass<RPT>(x, LAND, pos1, oseq, ref, client, vis, lpre, elig);
    x.ph ^= 1;
    Misc* m = x.m;
    const int owner = m->owner;
    int ob = owner;
    if (owner == (int)NO_OWNER) {
        if (x.n == x.C) {
            // No landing row in a full table: the insert would open
            // row C. Flagged; the table is left as it is.
            x.err |= ERR_CAPACITY;
            return;
        }
        if (m->total < pos1) x.err |= ERR_BAD_POS;
        ob = x.n / x.R;  // the end boundary: row n
    }
    if (x.n == x.C) x.err |= ERR_CAPACITY;
    const int lim = min(x.n + 1, x.C);
    const int slot_new = x.next_slot++;
    const int top = min(x.nb, lim - x.lo);
    if (x.b == ob) {
        int j;
        if (owner == (int)NO_OWNER) {
            j = x.n - x.lo;
        } else {
            const int carry = m->carry;
#pragma unroll
            for (int r = 0; r < RPT; ++r) {
                if (((elig >> r) & 1u) && wrap_add(carry, lpre[r]) >= pos1)
                    atomicMin(&m->jmin, (int)threadIdx.x * RPT + r);
            }
            __syncthreads();
            j = m->jmin;
        }
        shift_up(x, j + 1, top, nullptr);
        const int tid = threadIdx.x;
        if (tid == 0) {
            H(x, BUF, j) = x.ops[6 * x.B + i];
            H(x, LEN, j) = x.ops[7 * x.B + i];
            H(x, ISEQ, j) = oseq;
            H(x, ICL, j) = client;
            H(x, RSEQ, j) = NOT_REMOVED;
            H(x, SLOT, j) = slot_new;
        }
        int* h = x.heap + (size_t)slot_new * x.W;
        for (int t = tid; t < x.W; t += blockDim.x) {
            int v = NO_CLIENT;
            if (t >= x.KR) {
                const int kk = t - x.KR;
                v = PROP_ABSENT;
                for (int p = 0; p < x.PK; ++p) {
                    const int key = x.pk[i * x.PK + p];
                    const int val = x.pv[i * x.PK + p];
                    if (key == kk) v = val == PROP_DELETE ? PROP_ABSENT : val;
                }
            }
            h[t] = v;
        }
        __syncthreads();
    } else if (x.b > ob && top > 0) {
        take_in(x, false, 0, 0);
        shift_up(x, 0, top, m->inc);
    }
    x.n = lim;
}

// Covered-range updates of a range op [pos1, pos2): removal (earliest
// rem_seq wins, the client to the first free remover slot) or
// last-writer-wins annotate; ERR_BAD_POS when the visible total is
// below pos2.
template <int RPT>
__device__ void covered_step(Ctx& x, int i, bool is_rem, int pos1, int pos2,
                             int oseq, int ref, int client) {
    int vis[RPT], lpre[RPT];
    unsigned elig;
    pass<RPT>(x, COVER, 0, 0, ref, client, vis, lpre, elig);
    x.ph ^= 1;
    Misc* m = x.m;
    if (m->total < pos2) x.err |= ERR_BAD_POS;
    const int carry = m->carry;
    int* heap = x.heap;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
        if (vis[r] <= 0) continue;
        const int pre = wrap_add(carry, lpre[r]);
        if (pre < pos1 || wrap_add(pre, vis[r]) > pos2) continue;
        const int li = (int)threadIdx.x * RPT + r;
        int* h = heap + (size_t)H(x, SLOT, li) * x.W;
        if (is_rem) {
            const bool already = H(x, RSEQ, li) != NOT_REMOVED;
            if (!already) H(x, RSEQ, li) = oseq;
            int first_free = x.KR;
            for (int k = x.KR - 1; k >= 0; --k)
                if (__ldcg(h + k) == NO_CLIENT) first_free = k;
            if (already && first_free == x.KR) {
                atomicOr(&m->err, ERR_REMOVERS);
            } else {
                h[already ? first_free : 0] = client;
            }
        } else {
            for (int p = 0; p < x.PK; ++p) {
                const int key = x.pk[i * x.PK + p];
                const int val = x.pv[i * x.PK + p];
                if (key != NO_KEY && key >= 0 && key < x.KK)
                    h[x.KR + key] = val == PROP_DELETE ? PROP_ABSENT : val;
            }
        }
    }
    __syncthreads();
}

template <int RPT>
__global__ void __launch_bounds__(MAX_NT, 1) mergetree_chunk_kernel(Args a) {
    extern __shared__ __align__(16) int smem[];
    const int tid = threadIdx.x, NT = blockDim.x;
    Ctx x;
    x.heap = a.heap;
    x.bar = a.bar;
    x.part = a.part;
    x.exch = a.exch;
    x.rows = a.rows;
    x.B = a.B;
    x.R = a.R;
    x.C = a.C;
    x.G = a.G;
    x.KR = a.KR;
    x.KK = a.KK;
    x.PK = a.PK;
    x.W = a.KR + a.KK;
    x.b = blockIdx.x;
    x.lo = x.b * a.R;
    x.nb = min(a.R, a.C - x.lo);
    x.hot = smem;
    int* ops = smem + HOT * a.R;
    x.ops = ops;
    x.pk = ops + OPC * a.B;
    x.pv = x.pk + a.B * a.PK;
    x.m = reinterpret_cast<Misc*>(smem + HOT * a.R + a.B * (OPC + 2 * a.PK));
    x.n = min(max(*a.n_rows_in, 0), a.C);
    x.next_slot = a.C;
    x.err = 0;
    x.ph = 0;
    x.sc = 0;
    x.gen = 0;

    // The block's hot columns and the chunk's ops into shared memory.
    for (int i = tid; i < x.nb; i += NT) {
#pragma unroll
        for (int c = 0; c < 5; ++c) cp_async4(&H(x, c, i), a.col_in[c] + x.lo + i);
        H(x, SLOT, i) = x.lo + i;
    }
    for (int e = tid; e < OPC * a.B; e += NT)
        cp_async4(ops + e, a.op[e / a.B] + e % a.B);
    for (int e = tid; e < a.B * a.PK; e += NT) {
        cp_async4(ops + OPC * a.B + e, a.prop_keys + e);
        cp_async4(ops + OPC * a.B + a.B * a.PK + e, a.prop_vals + e);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
    if (tid == 0) {
        x.m->lkey = 0;
        x.m->skey = ~0ull;
        x.m->jmin = INT_MAX;
        x.m->err = 0;
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();

    const int B = a.B;
    for (int i = 0; i < B; ++i) {
        const int otype = x.ops[i];
        const bool is_ins = otype == OP_INSERT;
        const bool is_rem = otype == OP_REMOVE;
        const bool is_range = is_rem || otype == OP_ANNOTATE;
        if (!is_ins && !is_range) continue;  // NOOP: every mask is empty
        const int pos1 = x.ops[1 * B + i];
        const int pos2 = x.ops[2 * B + i];
        const int oseq = x.ops[3 * B + i];
        const int ref = x.ops[4 * B + i];
        const int client = x.ops[5 * B + i];

        split_step<RPT>(x, pos1, ref, client);
        if (is_ins) {
            insert_step<RPT>(x, i, pos1, oseq, ref, client);
        } else {
            split_step<RPT>(x, pos2, ref, client);
            covered_step<RPT>(x, i, is_rem, pos1, pos2, oseq, ref, client);
        }
    }

    // Write the block's live rows back, gathering the cold columns.
    const int rows = max(0, min(x.nb, x.n - x.lo));
    for (int i = tid; i < rows; i += NT) {
#pragma unroll
        for (int c = 0; c < 5; ++c) a.col_out[c][x.lo + i] = H(x, c, i);
    }
    const int* heap = a.heap;
    for (int e = tid; e < rows * x.KR; e += NT) {
        const int i = e / x.KR, k = e - i * x.KR;
        a.rcl_out[(size_t)(x.lo + i) * x.KR + k] =
            __ldcg(heap + (size_t)H(x, SLOT, i) * x.W + k);
    }
    for (int e = tid; e < rows * x.KK; e += NT) {
        const int i = e / x.KK, k = e - i * x.KK;
        a.props_out[(size_t)(x.lo + i) * x.KK + k] =
            __ldcg(heap + (size_t)H(x, SLOT, i) * x.W + x.KR + k);
    }
    __syncthreads();
    if (tid == 0) {
        if (x.b == x.G - 1) *a.n_rows_out = x.n;
        const int err = x.err | x.m->err;
        if (err) atomicOr(a.err_out, err);
    }
}

typedef void (*KernelFn)(Args);

KernelFn kernel_for(int rpt) {
    switch (rpt) {
        case 1: return mergetree_chunk_kernel<1>;
        case 2: return mergetree_chunk_kernel<2>;
        case 4: return mergetree_chunk_kernel<4>;
        case 8: return mergetree_chunk_kernel<8>;
        default: return nullptr;
    }
}

}  // namespace

// Plain C entry point (loaded with ctypes). `ptrs` holds, in order:
// n_rows, error, buf_start, length, ins_seq, ins_client, rem_seq,
// rem_clients, props, op_type, pos1, pos2, seq, ref_seq, client,
// buf_start, ins_len, prop_keys, prop_vals (inputs), then buf_start,
// length, ins_seq, ins_client, rem_seq, rem_clients, props, n_rows,
// error (outputs), then the heap [C + 2B, KR + KK] and the scratch
// words (4 + 24 G + 4 C int32). G, R and `smem` come from `kernel_geometry`.
// Copies the table into the outputs and the heap, zeroes the barrier,
// and launches the cooperative grid on `stream`; returns the first
// CUDA error (0 when the launch was accepted), and
// cudaErrorCooperativeLaunchTooLarge when the G blocks cannot all be
// resident at once.
extern "C" int mergetree_chunk_launch(int device, int C, int KR, int KK,
                                      int B, int PK, int G, int R, int smem,
                                      int n_ptrs, void** ptrs, void* stream) {
    if (n_ptrs != N_PTRS || C <= 0 || KR < 1 || KK < 0 || B < 0 || PK < 0 ||
        R <= 0 || R % ROW_QUANTUM != 0 || R > MAX_R || G < 1 ||
        G > 32 * MAXK || G != (C + R - 1) / R)
        return (int)cudaErrorInvalidValue;
    const int need = 4 * (HOT * R + B * (OPC + 2 * PK)) + SMEM_MISC;
    if (smem != need) return (int)cudaErrorInvalidValue;
    int rpt = 1;
    while (rpt * MAX_NT < R) rpt *= 2;
    const int nt = ((R + rpt - 1) / rpt + 31) / 32 * 32;
    KernelFn fn = kernel_for(rpt);
    if (fn == nullptr) return (int)cudaErrorInvalidValue;

    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    int coop = 0, sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
    if (e != cudaSuccess) return (int)e;
    if (!coop) return (int)cudaErrorNotSupported;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute((const void*)fn,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, (const void*)fn,
                                                      nt, smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm * sms < G) return (int)cudaErrorCooperativeLaunchTooLarge;

    cudaStream_t s = (cudaStream_t)stream;
    Args a;
    a.C = C;
    a.KR = KR;
    a.KK = KK;
    a.B = B;
    a.PK = PK;
    a.R = R;
    a.G = G;
    a.n_rows_in = (const int*)ptrs[0];
    a.err_in = (const int*)ptrs[1];
    for (int c = 0; c < 5; ++c) a.col_in[c] = (const int*)ptrs[2 + c];
    const int* rcl_in = (const int*)ptrs[7];
    const int* props_in = (const int*)ptrs[8];
    for (int c = 0; c < OPC; ++c) a.op[c] = (const int*)ptrs[9 + c];
    a.prop_keys = (const int*)ptrs[17];
    a.prop_vals = (const int*)ptrs[18];
    for (int c = 0; c < 5; ++c) a.col_out[c] = (int*)ptrs[19 + c];
    a.rcl_out = (int*)ptrs[24];
    a.props_out = (int*)ptrs[25];
    a.n_rows_out = (int*)ptrs[26];
    a.err_out = (int*)ptrs[27];
    a.heap = (int*)ptrs[28];
    int* scratch = (int*)ptrs[29];
    a.bar = (unsigned*)scratch;
    a.part = scratch + 4;
    a.exch = scratch + 4 + 2 * G * 4;
    a.rows = reinterpret_cast<int2*>(scratch + 4 + 2 * G * (4 + EXW));

    // Rows >= the output's n_rows keep the input's values.
    const size_t widths[7] = {1, 1, 1, 1, 1, (size_t)KR, (size_t)KK};
    const void* cols_in[7] = {a.col_in[0], a.col_in[1], a.col_in[2], a.col_in[3],
                              a.col_in[4], rcl_in, props_in};
    void* cols_out[7] = {a.col_out[0], a.col_out[1], a.col_out[2], a.col_out[3],
                         a.col_out[4], a.rcl_out, a.props_out};
    for (int c = 0; c < 7; ++c) {
        if (widths[c] == 0) continue;
        e = cudaMemcpyAsync(cols_out[c], cols_in[c],
                            (size_t)C * widths[c] * sizeof(int),
                            cudaMemcpyDeviceToDevice, s);
        if (e != cudaSuccess) return (int)e;
    }
    e = cudaMemcpyAsync(a.err_out, a.err_in, sizeof(int),
                        cudaMemcpyDeviceToDevice, s);
    if (e != cudaSuccess) return (int)e;
    // Heap rows [0, C): rem_clients then props, KR + KK ints a row.
    const size_t pitch = (size_t)(KR + KK) * sizeof(int);
    e = cudaMemcpy2DAsync(a.heap, pitch, rcl_in, KR * sizeof(int),
                          KR * sizeof(int), C, cudaMemcpyDeviceToDevice, s);
    if (e != cudaSuccess) return (int)e;
    if (KK > 0) {
        e = cudaMemcpy2DAsync(a.heap + KR, pitch, props_in, KK * sizeof(int),
                              KK * sizeof(int), C, cudaMemcpyDeviceToDevice, s);
        if (e != cudaSuccess) return (int)e;
    }
    e = cudaMemsetAsync(scratch, 0, 4 * sizeof(int), s);
    if (e != cudaSuccess) return (int)e;

    void* params[] = {&a};
    e = cudaLaunchCooperativeKernel((const void*)fn, dim3(G), dim3(nt), params,
                                    (size_t)smem, s);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}
