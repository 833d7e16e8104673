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
// test): (1) a boundary split at pos1 (insert, remove, annotate): the
// first non-skip row with prefix < pos1 < prefix + vis splits; its tail
// opens at the next row and inherits every field; (2) a boundary split
// at pos2 (remove, annotate); (3) an insert's landing: the first
// non-skip row at or after pos1 that is visible or loses the tie-break
// (op.seq > ins_seq), else row n_rows; the suffix shifts up one row and
// the new row is written there; ERR_BAD_POS when no row lands and
// pos1 > total; (4) a range op's covered rows (non-skip, visible,
// inside [pos1, pos2)): a remove keeps the earliest rem_seq and puts
// the client in slot 0 of a row not yet removed, else in the first
// free slot (ERR_REMOVERS when none is free); an annotate writes its
// keys in slot order (the last wins), PROP_DELETE clearing;
// ERR_BAD_POS when pos2 > the visible total; (5) ERR_CAPACITY whenever
// n_rows exceeds C. As in the scan, n_rows still grows past C: a row
// pushed off the top of a full table is lost, and an insert or a split
// tail that would open row C is not written.
//
// What bounds it. One document's ops are serial, so a launch lasts as
// long as the longest chain of per-op steps in one block; the bytes
// (the live rows in and out once, about 2 us at C 2048, D 132 on an
// H100) are a small part of it. The first design ran each op as 2-3 passes
// over the whole table (each a visibility step and a block scan),
// searched with 64-bit block min reductions, shifted the suffix once
// per opened row, crossed ~10-12 barriers of all 32 warps an op, read
// the removed rows' remover slots from global memory, and took 0.828
// ms a launch at C 2048, D 132 (6.1 us an op, 0.044 ms of it the
// copies; tools/scan_ab.py).
//
// This design shortens the chain:
// - One pass an op. One visibility pass and block scan at the op's
//   (ref_seq, client) decides everything before a row moves: the row
//   that pos1 falls strictly inside, the one pos2 falls in, an insert's
//   landing, the visible total, and the range op's covered rows, which
//   the pass updates in place (a split's pieces are covered or not by
//   the same rule, at their new rows). A split's tail has its head's
//   visibility, so no other row's prefix changes between the scan's
//   steps; an insert strictly inside a row lands at its tail. Then one
//   move of the suffix (rows between two split rows up one, rows above
//   up by the rows opened, two at most), each thread writing its own
//   rows from the registers the pass loaded them into (every read of
//   the op is behind the search barrier, the destinations are
//   distinct: no move barrier), and the opened rows' writes.
// - Searches without reductions: a split row is the only one that
//   contains its position (the pass checks the table for it), so its
//   owner leaves the row, its prefix and hot values in a slot tagged
//   with the op, and copies its cold row into the op's heap row during
//   the pass; an insert's landing row, the first of many, is an
//   atomicMin of (B - op) << 32 | row in shared memory. All of an op's
//   searches sit behind one barrier, which also ors the remover
//   overflow (`bar.red.or.pred`). Op i's opened rows take heap rows
//   C + 2i and C + 2i + 1, and every insert's own cold row is made
//   before the op loop by all threads at once.
// - Warps sized to the live rows: each block reads its n_rows_in and
//   takes the rows its chunk can reach, min(C, n_in + 2B). With the hot
//   columns in shared memory, up to 512 of them run one row a thread and
//   up to 1024 two, each a register-resident op loop of its own (not
//   inlined, with its own registers); more rows, or hot columns in
//   global memory, take the swept loop: K rows a thread (the fewest
//   even number at which the block's 16 warps hold them) walked 2 at a
//   time, the visibility computed again in the pass's second sweep,
//   moves in top-down tiles. Only the warps those rows need run the op
//   loop, on named barrier 1 (`bar.sync 1, 32w`), or `__syncwarp` with
//   one warp; each block writes the rows a thread and the warps it took
//   to a [D, 2] output. Every warp of the block copies the live rows in
//   and out and meets at `__syncthreads`. Per op: the pass barrier, the
//   search barrier and, when rows open, a closing barrier. Fewer rows a
//   thread on more warps is faster, and fewer registers a loop
//   (tools/scan_ab.py, NVIDIA H100 80GB HBM3, 700 W): forcing 2, 4 or
//   8 rows a thread on the fold's tables took 0.329 / 0.421 / 0.715 ms
//   against 0.315 at 1; a sweep step of 4 rows 2.664 / 3.598 ms at
//   KernelReplica's C 4096 / 8192 against 1.954 / 2.649 at 2; blocks of
//   1024 threads (64 registers a thread) 0.611 ms at the fold's C 2048
//   and 7.580 at C 8192 against 0.237 and 2.649 at 512.
// - Ownership: thread t of the active warps owns rows [t*K, t*K + K).
//   The hot columns permute the rows of each 32-row group by the
//   group's index (row i at i ^ (i/32 % 32)), so that the lanes' loads
//   of their r-th rows fall in distinct banks for K a power of two, at
//   no extra space.
// - Layouts (the launcher picks them from C, B, PK, KR and KK and
//   `ops/mergetree_scan.scan_geometry` returns them; bits of `layout`):
//   the chunk's ops always lie in shared memory; the six hot columns
//   (buf_start, length, ins_seq, ins_client, rem_seq and a `slot` into
//   the cold heap) in shared memory where they fit beside the ops, else
//   in a per-document scratch [6, C rounded up to 32] in global memory
//   (L2), walked by the swept loop (no capacity ceiling); the cold
//   heap's remover half [C + 2B, KR] (the part the visibility test
//   reads) in shared memory where it also fits, and then its props half
//   [C + 2B, KK]; a half that does not fit lies in a per-document heap
//   in global memory. At the fold's shapes (C <= 2048, B 128, KR 4, KK
//   8) everything is in shared memory; at KernelReplica's C 4096, B 512
//   the props half is global, and at C 8192 both halves.
// - Only live rows are copied: the prologue reads rows [0, min(n_in,
//   C)) and the epilogue writes rows [0, min(n_rows, C)); the rows
//   above are scratch, in and out.
// - Tables that can overflow (n + 2 > C before the op), or whose
//   visible lengths are negative or whose prefix passes INT32_MAX (no
//   valid table): the op runs as the scan's steps one after another
//   (split, split or landing, cover; each a pass, a ballot search
//   (`__ballot_sync`, `__ffs`, one shared slot per warp) and a move in
//   tiles that drops rows reaching C), a block-uniform branch inside
//   the kernel that keeps every full-table edge exact.
// - Profiling builds (-DSCAN_PROFILE, tools/scan_profile.py) add thread
//   0's clock64() cycles by part of the op loop into a [D, 8] int64
//   buffer that their own entry `mergetree_scan_profile_into` names.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 512;              // threads a block
constexpr int SWEEP_R = 2;           // rows a sweep step, the swept loop
constexpr int SWEEP_MR = 4;          // rows a thread a move tile, swept loop
constexpr int HOT = 6;               // hot columns
constexpr int OPC = 8;               // op columns
constexpr int SMEM_MISC = 2048;      // bytes of `Misc`, rounded up
constexpr int SMEM_OPTIN = 232448;   // an H100 block's opt-in shared memory
constexpr int SMEM_DEFAULT = 48 * 1024;
constexpr int NOT_REMOVED = 2147483647;
constexpr int NONE = 2147483647;     // no row found
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
constexpr int ABI = 3;
constexpr int N_PTRS = 31;
// A profiling build (-DSCAN_PROFILE, tools/scan_profile.py): thread 0 of
// each block adds the clock64() cycles of each part of its op loop into
// [D, PROF_PARTS] int64 at `g_prof`, which `mergetree_scan_profile_into`
// sets.
constexpr int PROF_PARTS = 8;
enum { P_PASS1, P_B1, P_PASS2, P_SEARCH, P_PREP, P_MOVE, P_WRITE, P_LOOP };
#ifdef SCAN_PROFILE
__device__ long long* g_prof;
#define PROF(k)                                   \
    do {                                          \
        if (threadIdx.x == 0) {                   \
            const long long t_ = clock64();       \
            prof[k] += t_ - prof_t;               \
            prof_t = t_;                          \
        }                                         \
    } while (0)
#else
#define PROF(k) \
    do {        \
    } while (0)
#endif
// `layout` bits: the part lies in shared memory.
constexpr int L_HOT = 1, L_RCL = 2, L_PROPS = 4;

enum { BUF = 0, LEN = 1, ISEQ = 2, ICL = 3, RSEQ = 4, SLOT = 5 };
enum { O_TYPE = 0, O_POS1, O_POS2, O_SEQ, O_REF, O_CLIENT, O_BUF, O_LEN };
enum { S_A = 0, S_B = 1, S_LAND = 2 };  // searches: split at pos1, at pos2, landing

struct Args {
    int D, C, KR, KK, B, PK, layout;
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
    int* heap;              // [D, (C + 2B) * (KR + KK)]: remover half, props half
    int* hot;               // [D, HOT, CP]: the global hot layout's columns
    int* geom;              // [D, 2]: rows a thread and warps of the op loop
};

struct Misc {
    int tot[2][32];         // warp totals, by pass parity
    int bad[2][32];         // warp flags: a negative length or a wrap
    int hit[3][32][2];      // per search and warp: first row, its prefix
    // One pass an op: the rows split at pos1 and pos2 (op + 1, row,
    // prefix; set by the row's owner) with their hot values, and the
    // first landing row ((B - op) << 32 | row, by atomicMin).
    int split[2][3];
    int shv[2][6];
    unsigned long long land;
    int fin;                // n_rows after the op loop, for every warp
};
static_assert(sizeof(Misc) <= SMEM_MISC, "Misc outgrew its shared bytes");

__device__ __forceinline__ int wadd(int a, int b) {
    return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int wsub(int a, int b) {
    return (int)((unsigned)a - (unsigned)b);
}

// Inclusive int32 warp scan (wrapping, as the scan's int32 cumsum
// does); `bad` is set where a partial sum of values >= 0 passes
// INT32_MAX (a partial sum of two in-range sums wraps negative once).
__device__ __forceinline__ int warp_incl_scan(int v, int lane, bool& bad) {
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(FULL, v, o);
        if (lane >= o) {
            v = wadd(v, u);
            bad |= v < 0;
        }
    }
    return v;
}

// One document's chunk: its columns, heap and block-uniform state
// (every active thread holds the same n; the error word is the one
// thread 0 holds). R rows a thread held in registers, or with SWEPT a
// sweep step of K rows a thread.
template <int R, bool SWEPT>
struct Doc {
    int* hot;        // [HOT][CP], in shared or global memory
    int CP;          // column stride: C rounded up to 32
    int* rcl;        // [C + 2B][KR] remover half of the cold heap
    int* prp;        // [C + 2B][KK] props half
    const int* ops;  // [OPC][B] shared
    const int* pk;   // [B][PK] shared
    const int* pv;   // [B][PK] shared
    Misc* m;
    int C, KR, KK, B, PK;
    int nw, K;       // active warps, rows a thread
    int n, err, pc;
#ifdef SCAN_PROFILE
    long long prof[PROF_PARTS], prof_t;
#endif

    // Row i's place in a column: the rows of each 32-row group are
    // permuted by the group's index (i ^ (i/32 % 32)), so that the
    // lanes' loads of their r-th rows fall in distinct banks for every
    // power-of-two K.
    __device__ static __forceinline__ int pad(int i) {
        return i ^ ((i >> 5) & 31);
    }
    __device__ __forceinline__ int& h(int c, int i) const {
        return hot[c * CP + pad(i)];
    }
    __device__ __forceinline__ int lim() const { return n < C ? n : C; }
    __device__ __forceinline__ int op(int c, int i) const {
        return ops[c * B + i];
    }

    __device__ __forceinline__ void sync() const {
        if (nw == 1)
            __syncwarp();
        else
            asm volatile("bar.sync 1, %0;" ::"r"(nw * 32) : "memory");
    }

    // A barrier of the active warps that also returns the or of `p`.
    __device__ __forceinline__ bool sync_or(bool p) const {
        if (nw == 1) {
            const bool r = __any_sync(FULL, p);
            __syncwarp();
            return r;
        }
        unsigned r;
        asm volatile(
            "{\n\t.reg .pred p, q;\n\t"
            "setp.ne.u32 p, %1, 0;\n\t"
            "bar.red.or.pred q, 1, %2, p;\n\t"
            "selp.u32 %0, 1, 0, q;\n\t}"
            : "=r"(r)
            : "r"((unsigned)p), "r"(nw * 32)
            : "memory");
        return r != 0;
    }

    // Row i's hot values, its visible length at (ref, client), whether
    // it is a skip row (a tombstone at the perspective, or removed with
    // an unseen insert), and whether an insert of seq `oseq` may land on
    // it.
    __device__ __forceinline__ void row_vis(int i, int ref, int client,
                                            int oseq, int* hv, int& v,
                                            bool& skip, bool& land) const {
#pragma unroll
        for (int c = 0; c < HOT; ++c) hv[c] = h(c, i);
        const int rs = hv[RSEQ], iseq = hv[ISEQ];
        const bool removed = rs != NOT_REMOVED;
        const bool ins_vis = hv[ICL] == client || iseq <= ref;
        skip = (removed && rs <= ref) || (removed && !ins_vis);
        bool visible = !skip && ins_vis;
        if (visible && removed) {
            const int* rc = rcl + (size_t)hv[SLOT] * KR;
            bool among = false;
            for (int k = 0; k < KR; ++k) among |= rc[k] == client;
            visible = !among;
        }
        v = visible ? hv[LEN] : 0;
        land = !skip && (v > 0 || oseq > iseq);
    }

    // One visibility pass at (ref, client): the visible lengths of the
    // thread's live rows, a block-wide exclusive scan, then
    // f(row, prefix, vis, skip, land, hot values) for each of them in
    // row order. Returns the visible total. `sane` (block-uniform, set
    // before the calls of f) says that every visible length is >= 0 and
    // no prefix passes INT32_MAX. Unswept, the rows' hot values stay in
    // `rv` (row lo + r in rv[r]) for a move from registers. Two
    // barriers apart from the pass's own: the warp totals' slots
    // alternate between passes.
    template <class F>
    __device__ __forceinline__ int pass(int ref, int client, int oseq,
                                       bool& sane, int (&rv)[R][HOT], F&& f) {
        const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
        const int lo = t * K, L = lim();
        const int steps = SWEPT ? K / R : 1;
        int vis[R];
        unsigned skipm = 0, landm = 0;
        int sum = 0;
        bool bad = false;
        for (int s = 0; s < steps; ++s) {
            if (SWEPT && lo + s * R >= L) break;
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const int i = lo + s * R + r;
                int v = 0;
                bool sk = true, ld = false;
                if (i < L) row_vis(i, ref, client, oseq, rv[r], v, sk, ld);
                if (!SWEPT) {
                    vis[r] = v;
                    skipm |= (unsigned)sk << r;
                    landm |= (unsigned)ld << r;
                }
                bad |= v < 0;
                sum = wadd(sum, v);
                bad |= sum < 0;
            }
        }
        const int buf = pc & 1;
        ++pc;
        const int inc = warp_incl_scan(sum, lane, bad);
        if (lane == 31) m->tot[buf][wid] = inc;
        const bool wbad = __any_sync(FULL, bad);
        if (lane == 0) m->bad[buf][wid] = wbad;
        PROF(P_PASS1);
        sync();
        PROF(P_B1);
        const int wt = lane < nw ? m->tot[buf][lane] : 0;
        bool bad2 = lane < nw && m->bad[buf][lane];
        const int winc = warp_incl_scan(wt, lane, bad2);
        sane = !__any_sync(FULL, bad2);
        const int total = __shfl_sync(FULL, winc, 31);
        int run = wadd(__shfl_sync(FULL, wsub(winc, wt), wid), wsub(inc, sum));
        for (int s = 0; s < steps; ++s) {
            if (SWEPT && lo + s * R >= L) break;
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const int i = lo + s * R + r;
                if (i >= L) break;
                int v;
                bool sk, ld;
                if (SWEPT) {
                    row_vis(i, ref, client, oseq, rv[r], v, sk, ld);
                } else {
                    v = vis[r];
                    sk = (skipm >> r) & 1u;
                    ld = (landm >> r) & 1u;
                }
                f(i, run, v, sk, ld, rv[r]);
                run = wadd(run, v);
            }
        }
        PROF(P_PASS2);
        return total;
    }

    // The thread's first hit of search s (row NONE if none) as its
    // warp's first hit; read by `first_hit` after the next barrier.
    __device__ __forceinline__ void publish(int s, int row, int pre) {
        const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
        const unsigned b = __ballot_sync(FULL, row != NONE);
        if (lane == (b ? __ffs(b) - 1 : 0)) {
            m->hit[s][wid][0] = row;
            m->hit[s][wid][1] = pre;
        }
    }

    // The block's first hit of search s: the first warp's that has one.
    __device__ __forceinline__ void first_hit(int s, int& row,
                                              int& pre) const {
        const int lane = threadIdx.x & 31;
        const int r = lane < nw ? m->hit[s][lane][0] : NONE;
        const int p = lane < nw ? m->hit[s][lane][1] : 0;
        const unsigned b = __ballot_sync(FULL, r != NONE);
        const int w = b ? __ffs(b) - 1 : 0;
        row = __shfl_sync(FULL, r, w);
        pre = __shfl_sync(FULL, p, w);
        if (!b) row = NONE;
    }

    // Rows j in [lo1, hi1) move up sh1 rows and rows in [lo2, e) up sh2
    // (lo1 <= hi1 <= lo2; rows in [hi1, lo2) stay); a row reaching C is
    // dropped. Aligned tiles of nw * 32 * MR rows from the top down, a
    // barrier between each tile's reads and its writes: a tile's writes
    // land on rows that this tile or the tiles above already read.
    // Unswept MR = R, so the live rows are one tile. Returns whether
    // there was a tile (and so a barrier after every read of the move).
    __device__ bool move(int lo1, int hi1, int sh1, int lo2, int sh2,
                         int e) {
        constexpr int MR = SWEPT ? SWEEP_MR : R;
        if (e <= lo1) return false;
        const int T = nw * 32 * MR;
        for (int kt = (e - 1) / T; kt >= lo1 / T; --kt) {
            const int base = kt * T + (int)threadIdx.x * MR;
            int v[MR][HOT], dst[MR];
#pragma unroll
            for (int r = 0; r < MR; ++r) {
                const int j = base + r;
                int sh = 0;
                if (j >= lo1 && j < e) sh = j < hi1 ? sh1 : (j >= lo2 ? sh2 : 0);
                dst[r] = sh && j + sh < C ? j + sh : -1;
                if (dst[r] >= 0) {
#pragma unroll
                    for (int c = 0; c < HOT; ++c) v[r][c] = h(c, j);
                }
            }
            sync();
#pragma unroll
            for (int r = 0; r < MR; ++r) {
                if (dst[r] >= 0) {
#pragma unroll
                    for (int c = 0; c < HOT; ++c) h(c, dst[r]) = v[r][c];
                }
            }
        }
        return true;
    }

    // The one-pass op's move: rows j in [lo1, hi1) up sh1 rows and rows
    // in [lo2, n) up sh2, as `move` takes them. Unswept, each thread
    // writes its own rows from the pass's registers (every read of the
    // op came before the search barrier, and the destinations are
    // distinct), so no barrier; swept, `move`.
    __device__ __forceinline__ void move_rows(int (&rv)[R][HOT], int lo1,
                                              int hi1, int sh1, int lo2,
                                              int sh2) {
        if (SWEPT) {
            move(lo1, hi1, sh1, lo2, sh2, n);
            return;
        }
        const int lo = threadIdx.x * R;
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int j = lo + r;
            if (j < lo1 || j >= n) continue;
            const int sh = j < hi1 ? sh1 : (j >= lo2 ? sh2 : 0);
            if (!sh) continue;
#pragma unroll
            for (int c = 0; c < HOT; ++c) h(c, j + sh) = rv[r][c];
        }
    }

    __device__ __forceinline__ void copy_cold(int dst, int src, int lane,
                                              int step) {
        for (int k = lane; k < KR; k += step)
            rcl[(size_t)dst * KR + k] = rcl[(size_t)src * KR + k];
        for (int k = lane; k < KK; k += step)
            prp[(size_t)dst * KK + k] = prp[(size_t)src * KK + k];
    }

    // Op i's new row's cold row: no remover; the props as
    // `row.at[keys].set(vals, mode="drop")` sets them: NO_KEY dropped,
    // another negative key counting from the end once, the last of
    // repeated keys winning, PROP_DELETE absent.
    __device__ __forceinline__ void init_cold(int slot, int i, int lane,
                                              int step) {
        for (int k = lane; k < KR; k += step) rcl[(size_t)slot * KR + k] = NO_CLIENT;
        const int* keys = pk + i * PK;
        const int* vals = pv + i * PK;
        for (int k = lane; k < KK; k += step) {
            int v = PROP_ABSENT;
            for (int p = 0; p < PK; ++p) {
                int kk = keys[p];
                if (kk == NO_KEY) continue;
                if (kk < 0) kk += KK;
                if (kk == k) v = vals[p] == PROP_DELETE ? PROP_ABSENT : vals[p];
            }
            prp[(size_t)slot * KK + k] = v;
        }
    }

    // A remove's or an annotate's update of one covered row (its
    // rem_seq through `rseq`, its cold row at `slot`); returns true when
    // a remove finds no free remover slot.
    __device__ __forceinline__ bool cover_row(int i, bool is_rem, int slot,
                                              int& rseq) {
        if (is_rem) {
            int* hr = rcl + (size_t)slot * KR;
            const int client = op(O_CLIENT, i);
            if (rseq == NOT_REMOVED) {
                rseq = op(O_SEQ, i);
                hr[0] = client;
                return false;
            }
            int k = 0;
            while (k < KR && hr[k] != NO_CLIENT) ++k;
            if (k == KR) return true;
            hr[k] = client;
            return false;
        }
        int* pr = prp + (size_t)slot * KK;
        const int* keys = pk + i * PK;
        const int* vals = pv + i * PK;
        for (int p = 0; p < PK; ++p) {
            const int kk = keys[p];
            if (kk < 0 || kk >= KK) continue;
            pr[kk] = vals[p] == PROP_DELETE ? PROP_ABSENT : vals[p];
        }
        return false;
    }

    // An op's two cold slots: op i opens at most two rows, and its new
    // rows take heap rows C + 2i and C + 2i + 1 (an insert's own row the
    // first, its cold row made before the op loop).
    __device__ __forceinline__ int slot_of(int i, int k) const {
        return C + 2 * i + k;
    }

    // Opens row `at` (the rows from it up move one row, a row reaching C
    // is dropped) and writes op i's new row there, unless at >= C; n
    // grows by one.
    __device__ void insert_row(int i, int at) {
        if (at < C) {
            PROF(P_PREP);
            move(at, at, 0, at, 1, lim());
            PROF(P_MOVE);
            if (threadIdx.x == 0) {
                h(BUF, at) = op(O_BUF, i);
                h(LEN, at) = op(O_LEN, i);
                h(ISEQ, at) = op(O_SEQ, i);
                h(ICL, at) = op(O_CLIENT, i);
                h(RSEQ, at) = NOT_REMOVED;
                h(SLOT, at) = slot_of(i, 0);
            }
        }
        n += 1;
        sync();
        PROF(P_WRITE);
    }

    // ---- the scan's steps, one after another (tables that can overflow)

    // `_split_at`: the first non-skip row strictly containing visible
    // position `pos` splits; the tail opens at the next row (not written
    // when that is row C) with a copy of the head's cold row at `slot`.
    __device__ void split_step(int i, int pos, int slot) {
        const int ref = op(O_REF, i), client = op(O_CLIENT, i);
        int hit = NONE, hp = 0, rv[R][HOT];
        bool sane;
        pass(ref, client, op(O_SEQ, i), sane, rv,
             [&](int row, int pre, int v, bool skip, bool, int*) {
                 if (!skip && hit == NONE && pre < pos && wadd(pre, v) > pos) {
                     hit = row;
                     hp = pre;
                 }
             });
        publish(S_A, hit, hp);
        sync();
        int idx, p;
        first_hit(S_A, idx, p);
        PROF(P_SEARCH);
        if (idx == NONE) return;
        const int off = wsub(pos, p), at = idx + 1;
        int hv[HOT];
        if (threadIdx.x == 0) {
#pragma unroll
            for (int c = 0; c < HOT; ++c) hv[c] = h(c, idx);
        }
        if (at < C) {
            if (threadIdx.x < 32) copy_cold(slot, h(SLOT, idx), threadIdx.x, 32);
            PROF(P_PREP);
            move(at, at, 0, at, 1, lim());
            PROF(P_MOVE);
            if (threadIdx.x == 0) {
                h(BUF, at) = wadd(hv[BUF], off);
                h(LEN, at) = wsub(hv[LEN], off);
                h(ISEQ, at) = hv[ISEQ];
                h(ICL, at) = hv[ICL];
                h(RSEQ, at) = hv[RSEQ];
                h(SLOT, at) = slot;
            }
        }
        if (threadIdx.x == 0) h(LEN, idx) = off;
        n += 1;
        sync();
        PROF(P_WRITE);
    }

    // An insert's landing, shift and write.
    __device__ void insert_step(int i) {
        const int pos1 = op(O_POS1, i);
        int hit = NONE, hp = 0, rv[R][HOT];
        bool sane;
        const int total = pass(
            op(O_REF, i), op(O_CLIENT, i), op(O_SEQ, i), sane, rv,
            [&](int row, int pre, int, bool, bool land, int*) {
                if (land && hit == NONE && pre >= pos1) {
                    hit = row;
                    hp = pre;
                }
            });
        publish(S_LAND, hit, hp);
        sync();
        int at, p;
        first_hit(S_LAND, at, p);
        PROF(P_SEARCH);
        if (at == NONE && pos1 > total) err |= ERR_BAD_POS;
        insert_row(i, at == NONE ? n : at);
    }

    // A remove's or an annotate's covered rows, each updated by its
    // owner thread.
    __device__ void cover_step(int i, bool is_rem) {
        const int pos1 = op(O_POS1, i), pos2 = op(O_POS2, i);
        int rv[R][HOT];
        bool ovf = false, sane;
        const int total = pass(
            op(O_REF, i), op(O_CLIENT, i), op(O_SEQ, i), sane, rv,
            [&](int row, int pre, int v, bool skip, bool, int* hv) {
                if (!skip && v > 0 && pre >= pos1 && wadd(pre, v) <= pos2) {
                    ovf |= cover_row(i, is_rem, hv[SLOT], hv[RSEQ]);
                    h(RSEQ, row) = hv[RSEQ];
                }
            });
        if (pos2 > total) err |= ERR_BAD_POS;
        if (sync_or(ovf)) err |= ERR_REMOVERS;
        PROF(P_SEARCH);
    }

    __device__ void steps(int i, int type) {
        if (type == OP_INSERT) {
            split_step(i, op(O_POS1, i), slot_of(i, 1));
            insert_step(i);
        } else {
            split_step(i, op(O_POS1, i), slot_of(i, 0));
            split_step(i, op(O_POS2, i), slot_of(i, 1));
            cover_step(i, type == OP_REMOVE);
        }
    }

    // ---- one pass an op (n + 2 <= C before the op)

    // The pieces of the rows that the op splits (up to four: two rows
    // cut once, or one row cut twice), written by lanes of warp 0 after
    // the move, from the hot values that the split rows' owners left in
    // `shv`. Piece k of a row keeps the row's cold slot when k == 0, else
    // takes the slot into which the owner copied the row's cold row in
    // the pass (slot_of(i, 0) for the row that pos1 splits, slot_of(i, 1)
    // for the one pos2 splits; both when one row is cut twice); a range
    // op covers a piece [s, e) when s >= pos1 and e <= pos2.
    __device__ void range_pieces(int i, bool is_rem, int (&rv)[R][HOT],
                                 int r0, int p0, int r1, int p1) {
        const int pos1 = op(O_POS1, i), pos2 = op(O_POS2, i);
        if (r0 == r1 && pos1 == pos2) r1 = NONE;  // one cut
        int ra, pa, sa, rb, pb, sb;  // split rows (ra < rb; rb NONE: one
                                     // row), prefixes, searches
        int c0, c1 = NONE;  // cuts: row ra's (c0, and c1 when one row is
                            // cut twice), row rb's (c1)
        if (r0 == NONE || r1 == NONE) {
            ra = r0 == NONE ? r1 : r0;
            pa = r0 == NONE ? p1 : p0;
            sa = r0 == NONE ? S_B : S_A;
            c0 = r0 == NONE ? pos2 : pos1;
            rb = NONE;
            pb = 0;
            sb = sa;
        } else if (r0 == r1) {
            ra = r0;
            pa = p0;
            sa = S_A;
            sb = S_B;
            rb = NONE;
            pb = 0;
            c0 = pos1 < pos2 ? pos1 : pos2;
            c1 = pos1 < pos2 ? pos2 : pos1;
        } else {
            const bool lo0 = r0 < r1;
            ra = lo0 ? r0 : r1;
            pa = lo0 ? p0 : p1;
            sa = lo0 ? S_A : S_B;
            c0 = lo0 ? pos1 : pos2;
            rb = lo0 ? r1 : r0;
            pb = lo0 ? p1 : p0;
            sb = lo0 ? S_B : S_A;
            c1 = lo0 ? pos2 : pos1;
        }
        const int opened = (rb != NONE || c1 != NONE) ? 2 : 1;
        const int pieces = rb != NONE ? 4 : opened + 1;
        const int lane = threadIdx.x & 31;
        if (threadIdx.x < 32) {
            // Piece `lane`: its source row, position, start, end, slot.
            int src = -1, at = 0, s = 0, e = 0, pre = 0, hs = S_A, slot = 0;
            if (lane < pieces) {
                if (rb == NONE) {  // one row: pieces at ra, ra + 1 (, ra + 2)
                    src = ra;
                    pre = pa;
                    hs = sa;
                    at = ra + lane;
                    s = lane == 0 ? pa : (lane == 1 ? c0 : c1);
                    e = lane == opened ? NONE : (lane == 0 ? c0 : c1);
                    slot = lane == 0 ? -1
                         : slot_of(i, opened == 2 ? lane - 1 : sa == S_B);
                } else {  // ra at ra, ra + 1; rb at rb + 1, rb + 2
                    src = lane < 2 ? ra : rb;
                    pre = lane < 2 ? pa : pb;
                    hs = lane < 2 ? sa : sb;
                    at = lane < 2 ? ra + lane : rb + lane - 1;
                    const int c = lane < 2 ? c0 : c1;
                    s = (lane & 1) ? c : pre;
                    e = (lane & 1) ? NONE : c;
                    slot = (lane & 1) ? slot_of(i, hs == S_B) : -1;
                }
            }
            int hv[HOT];
#pragma unroll
            for (int c = 0; c < HOT; ++c) hv[c] = m->shv[hs][c];
            if (e == NONE) e = wadd(pre, hv[LEN]);
            if (slot < 0) slot = hv[SLOT];
            bool ovf = false;
            int rseq = hv[RSEQ];
            if (src >= 0 && s >= pos1 && e <= pos2) ovf = cover_row(i, is_rem, slot, rseq);
            if (__any_sync(FULL, ovf)) err |= ERR_REMOVERS;
            PROF(P_PREP);
            if (rb == NONE)
                move_rows(rv, ra + 1, ra + 1, 0, ra + 1, opened);
            else
                move_rows(rv, ra + 1, rb, 1, rb + 1, 2);
            PROF(P_MOVE);
            if (src >= 0) {
                h(BUF, at) = wadd(hv[BUF], wsub(s, pre));
                h(LEN, at) = wsub(e, s);
                h(ISEQ, at) = hv[ISEQ];
                h(ICL, at) = hv[ICL];
                h(RSEQ, at) = rseq;
                h(SLOT, at) = slot;
            }
        } else if (rb == NONE) {
            move_rows(rv, ra + 1, ra + 1, 0, ra + 1, opened);
        } else {
            move_rows(rv, ra + 1, rb, 1, rb + 1, 2);
        }
        n += opened;
        sync();
        PROF(P_WRITE);
    }

    // An insert strictly inside row r (prefix p): the head keeps
    // [p, pos1) at r, the op's row opens at r + 1, the tail [pos1, end)
    // at r + 2 with the copy of the head's cold row that its owner made
    // in the pass; rows above move two.
    __device__ void insert_split(int i, int (&rv)[R][HOT], int r, int p) {
        const int off = wsub(op(O_POS1, i), p);
        PROF(P_PREP);
        move_rows(rv, r + 1, r + 1, 0, r + 1, 2);
        PROF(P_MOVE);
        if (threadIdx.x == 0) {
            int hv[HOT];
#pragma unroll
            for (int c = 0; c < HOT; ++c) hv[c] = m->shv[S_A][c];
            h(LEN, r) = off;
            h(BUF, r + 1) = op(O_BUF, i);
            h(LEN, r + 1) = op(O_LEN, i);
            h(ISEQ, r + 1) = op(O_SEQ, i);
            h(ICL, r + 1) = op(O_CLIENT, i);
            h(RSEQ, r + 1) = NOT_REMOVED;
            h(SLOT, r + 1) = slot_of(i, 0);
            h(BUF, r + 2) = wadd(hv[BUF], off);
            h(LEN, r + 2) = wsub(hv[LEN], off);
            h(ISEQ, r + 2) = hv[ISEQ];
            h(ICL, r + 2) = hv[ICL];
            h(RSEQ, r + 2) = hv[RSEQ];
            h(SLOT, r + 2) = slot_of(i, 1);
        }
        n += 2;
        sync();
        PROF(P_WRITE);
    }

    // An insert that lands at row `at` (no split): the rows from it up
    // move one, the op's row is written there.
    __device__ void insert_at(int i, int (&rv)[R][HOT], int at) {
        PROF(P_PREP);
        move_rows(rv, at, at, 0, at, 1);
        PROF(P_MOVE);
        if (threadIdx.x == 0) {
            h(BUF, at) = op(O_BUF, i);
            h(LEN, at) = op(O_LEN, i);
            h(ISEQ, at) = op(O_SEQ, i);
            h(ICL, at) = op(O_CLIENT, i);
            h(RSEQ, at) = NOT_REMOVED;
            h(SLOT, at) = slot_of(i, 0);
        }
        n += 1;
        sync();
        PROF(P_WRITE);
    }

    // The owner of a row that op i splits (the only one: the fused path
    // runs on valid tables) leaves the row, its prefix and hot values in
    // search slot s's entry, tagged with the op, and copies its cold row
    // into `slot`.
    __device__ __forceinline__ void split_hit(int s, int i, int row, int pre,
                                              const int* hv, int slot) {
        m->split[s][0] = i + 1;
        m->split[s][1] = row;
        m->split[s][2] = pre;
#pragma unroll
        for (int c = 0; c < HOT; ++c) m->shv[s][c] = hv[c];
        copy_cold(slot, hv[SLOT], 0, 1);
    }

    __device__ void apply(int i) {
        const int type = op(O_TYPE, i);
        const bool is_ins = type == OP_INSERT;
        const bool is_rem = type == OP_REMOVE;
        if (!(is_ins || is_rem || type == OP_ANNOTATE)) return;
        if (n + 2 > C) {
            steps(i, type);
            return;
        }
        const int pos1 = op(O_POS1, i), pos2 = op(O_POS2, i);
        int rv[R][HOT];
        bool ovf = false, sane, found_a = false, found_b = false;
        const unsigned long long tag = (unsigned long long)(B - i) << 32;
        const int total = pass(
            op(O_REF, i), op(O_CLIENT, i), op(O_SEQ, i), sane, rv,
            [&](int row, int pre, int v, bool skip, bool land, int* hv) {
                if (skip || !sane) return;
                const int end = wadd(pre, v);
                if (!found_a && pre < pos1 && end > pos1) {
                    found_a = true;
                    // (an insert's tail takes slot 1, its own row slot 0)
                    split_hit(S_A, i, row, pre, hv, slot_of(i, is_ins ? 1 : 0));
                }
                if (is_ins) {
                    if (!found_b && land && pre >= pos1) {
                        found_b = true;  // the first landing row wins
                        atomicMin(&m->land, tag | (unsigned)row);
                    }
                } else {
                    if (!found_b && pre < pos2 && end > pos2) {
                        found_b = true;
                        split_hit(S_B, i, row, pre, hv, slot_of(i, 1));
                    }
                    if (v > 0 && pre >= pos1 && end <= pos2) {
                        ovf |= cover_row(i, is_rem, hv[SLOT], hv[RSEQ]);
                        h(RSEQ, row) = hv[RSEQ];
                    }
                }
            });
        if (!sane) {
            steps(i, type);
            return;
        }
        if (sync_or(ovf)) err |= ERR_REMOVERS;
        const bool a = m->split[S_A][0] == i + 1;
        const int r0 = a ? m->split[S_A][1] : NONE, p0 = m->split[S_A][2];
        PROF(P_SEARCH);
        if (is_ins) {
            if (r0 != NONE) {
                insert_split(i, rv, r0, p0);
            } else {
                const unsigned long long key = m->land;
                const int r1 = (key & ~0xffffffffull) == tag ? (int)(unsigned)key : NONE;
                if (r1 == NONE && pos1 > total) err |= ERR_BAD_POS;
                insert_at(i, rv, r1 == NONE ? n : r1);
            }
        } else {
            if (pos2 > total) err |= ERR_BAD_POS;
            const bool b = m->split[S_B][0] == i + 1;
            const int r1 = b ? m->split[S_B][1] : NONE, p1 = m->split[S_B][2];
            if (r0 != NONE || r1 != NONE) range_pieces(i, is_rem, rv, r0, p0, r1, p1);
        }
    }
};

// dst[k] = src[k] for k < count, 16-byte loads where src is aligned.
__device__ __forceinline__ void copy_ints(int* dst, const int* src,
                                          int count) {
    const int tid = threadIdx.x;
    int k0 = 0;
    if ((((uintptr_t)src) & 15) == 0) {
        const int q = count >> 2;
        for (int j = tid; j < q; j += NT) {
            const int4 x = reinterpret_cast<const int4*>(src)[j];
            dst[4 * j] = x.x;
            dst[4 * j + 1] = x.y;
            dst[4 * j + 2] = x.z;
            dst[4 * j + 3] = x.w;
        }
        k0 = q * 4;
    }
    for (int k = k0 + tid; k < count; k += NT) dst[k] = src[k];
}

// The block's shared memory and heaps: `Misc`, the chunk's ops, then
// each part that `layout` puts in shared memory; the others in this
// document's slices of the global heap and hot scratch.
template <int R, bool SWEPT>
__device__ __forceinline__ void carve(Doc<R, SWEPT>& x, int* heap, int* hotg,
                                      int C, int KR, int KK, int B, int PK,
                                      int layout) {
    extern __shared__ __align__(16) int smem[];
    const size_t HR = (size_t)C + 2 * B;  // heap rows
    x.m = reinterpret_cast<Misc*>(smem);
    int* sp = smem + SMEM_MISC / 4;
    int* pk = sp + OPC * B;
    x.ops = sp;
    x.pk = pk;
    x.pv = pk + B * PK;
    sp = pk + 2 * B * PK;
    x.CP = (C + 31) & ~31;
    if (layout & L_HOT) {
        x.hot = sp;
        sp += HOT * x.CP;
    } else {
        x.hot = hotg + (size_t)blockIdx.x * HOT * x.CP;
    }
    int* gheap = heap + (size_t)blockIdx.x * HR * (KR + KK);
    if (layout & L_RCL) {
        x.rcl = sp;
        sp += HR * KR;
    } else {
        x.rcl = gheap;
    }
    x.prp = (layout & L_PROPS) ? sp : gheap + HR * KR;
    x.C = C;
    x.KR = KR;
    x.KK = KK;
    x.B = B;
    x.PK = PK;
}

// The op loop on the first nw warps at K rows a thread; returns n_rows
// and (as thread 0 holds it) the error word, packed. Not inlined: each
// loop gets its own register allocation.
template <int R, bool SWEPT>
__device__ __noinline__ long long op_loop(int* heap, int* hotg, int C, int KR,
                                          int KK, int B, int PK, int layout,
                                          int n, int err, int nw, int K) {
    Doc<R, SWEPT> x;
    carve(x, heap, hotg, C, KR, KK, B, PK, layout);
    x.n = n;
    x.err = err;
    x.pc = 0;
    x.nw = nw;
    x.K = K;
#ifdef SCAN_PROFILE
    for (int k = 0; k < PROF_PARTS; ++k) x.prof[k] = 0;
    x.prof_t = clock64();
#endif
    if ((int)threadIdx.x < nw * 32) {
        for (int i = 0; i < B; ++i) {
            x.apply(i);
            if (x.n > C) x.err |= ERR_CAPACITY;
#ifdef SCAN_PROFILE
            long long* prof = x.prof;
            long long& prof_t = x.prof_t;
            PROF(P_LOOP);
#endif
        }
    }
#ifdef SCAN_PROFILE
    if (threadIdx.x == 0 && g_prof)
        for (int k = 0; k < PROF_PARTS; ++k)
            g_prof[(size_t)blockIdx.x * PROF_PARTS + k] = x.prof[k];
#endif
    return ((long long)x.err << 32) | (unsigned)x.n;
}

// The warps that `rows` rows need at K rows a thread, one at least.
__device__ __forceinline__ int warps_for(int rows, int K) {
    const int w = (rows + 32 * K - 1) / (32 * K);
    return w < 1 ? 1 : (w > NT / 32 ? NT / 32 : w);
}

// Rows [0, count) of hot column c from `src` (16-byte loads where src is
// aligned and C a multiple of 4: rows up to the next multiple of 4,
// scratch, come along).
template <int R, bool SWEPT>
__device__ __forceinline__ void load_col(Doc<R, SWEPT>& x, int c,
                                         const int* src, int count) {
    const int tid = threadIdx.x;
    if ((((uintptr_t)src) & 15) == 0 && (x.C & 3) == 0) {
        for (int j = tid; j < (count + 3) >> 2; j += NT) {
            const int4 v = reinterpret_cast<const int4*>(src)[j];
            x.h(c, 4 * j) = v.x;
            x.h(c, 4 * j + 1) = v.y;
            x.h(c, 4 * j + 2) = v.z;
            x.h(c, 4 * j + 3) = v.w;
        }
    } else {
        for (int i = tid; i < count; i += NT) x.h(c, i) = src[i];
    }
}

template <int R, bool SWEPT>
__device__ __forceinline__ void store_col(const Doc<R, SWEPT>& x, int c,
                                          int* dst, int count) {
    const int tid = threadIdx.x;
    if ((((uintptr_t)dst) & 15) == 0 && (x.C & 3) == 0) {
        for (int j = tid; j < (count + 3) >> 2; j += NT) {
            int4 v;
            v.x = x.h(c, 4 * j);
            v.y = x.h(c, 4 * j + 1);
            v.z = x.h(c, 4 * j + 2);
            v.w = x.h(c, 4 * j + 3);
            reinterpret_cast<int4*>(dst)[j] = v;
        }
    } else {
        for (int i = tid; i < count; i += NT) dst[i] = x.h(c, i);
    }
}

// Each block runs its chunk on the op loop that the rows its chunk can
// reach need: register-resident at 1 or 2 rows a thread with the hot
// columns in shared memory and at most 2 * NT rows, else swept.
__global__ void __launch_bounds__(NT) mergetree_scan_kernel(Args a) {
    const int d = blockIdx.x;
    const int C = a.C, B = a.B, PK = a.PK, KR = a.KR, KK = a.KK;
    const int tid = threadIdx.x;

    Doc<1, false> x;
    carve(x, a.heap, a.hot, C, KR, KK, B, PK, a.layout);
    const int n_in = a.n_rows_in[d];
    x.n = n_in < 0 ? 0 : n_in;
    x.err = a.err_in[d];
    int* ops = const_cast<int*>(x.ops);
    int* pk = const_cast<int*>(x.pk);
    int* pv = const_cast<int*>(x.pv);

    // The live rows in (the rows above are scratch).
    const size_t tc = (size_t)d * C;
    const int live_in = x.lim();
    for (int c = 0; c < 5; ++c) load_col(x, c, a.col_in[c] + tc, live_in);
    for (int i = tid; i < live_in; i += NT) x.h(SLOT, i) = i;
    copy_ints(x.rcl, a.rcl_in + tc * KR, live_in * KR);
    copy_ints(x.prp, a.props_in + tc * KK, live_in * KK);
    for (int c = 0; c < OPC; ++c)
        for (int i = tid; i < B; i += NT) ops[c * B + i] = a.op[c][(size_t)d * B + i];
    copy_ints(pk, a.prop_keys + (size_t)d * B * PK, B * PK);
    copy_ints(pv, a.prop_vals + (size_t)d * B * PK, B * PK);
    __syncthreads();
    // The searches' slots, and each insert's own cold row (heap row
    // C + 2i), made here for every insert at once.
    if (tid == 0) {
        x.m->land = ~0ull;
        x.m->split[0][0] = x.m->split[1][0] = 0;
    }
    for (int q = tid; q < B; q += NT)
        if (ops[O_TYPE * B + q] == OP_INSERT) x.init_cold(C + 2 * q, q, 0, 1);
    __syncthreads();

    // The rows the chunk can reach (each op opens two at most).
    const long long reach = (long long)x.n + 2LL * B;
    const int rows = reach < C ? (int)reach : C;
    int K, nw;
    long long out;
    if ((a.layout & L_HOT) && rows <= 2 * NT) {
        K = rows <= NT ? 1 : 2;
        nw = warps_for(rows, K);
        out = K == 1 ? op_loop<1, false>(a.heap, a.hot, C, KR, KK, B, PK,
                                          a.layout, x.n, x.err, nw, K)
                     : op_loop<2, false>(a.heap, a.hot, C, KR, KK, B, PK,
                                          a.layout, x.n, x.err, nw, K);
    } else {
        K = ((rows + NT - 1) / NT + SWEEP_R - 1) / SWEEP_R * SWEEP_R;
        if (K < SWEEP_R) K = SWEEP_R;
        nw = warps_for(rows, K);
        out = op_loop<SWEEP_R, true>(a.heap, a.hot, C, KR, KK, B, PK,
                                     a.layout, x.n, x.err, nw, K);
    }
    // Thread 0's n_rows for the warps that did not run the op loop.
    if (tid == 0) x.m->fin = (int)out;
    __syncthreads();
    x.n = x.m->fin;
    x.err = (int)(out >> 32);

    // The live rows out.
    const int live_out = x.lim();
    for (int c = 0; c < 5; ++c) store_col(x, c, a.col_out[c] + tc, live_out);
    // The cold rows gathered by slot, 16 bytes at a time where every
    // row is a multiple of 4 ints on aligned bases.
    int* ro = a.rcl_out + tc * KR;
    int* po = a.props_out + tc * KK;
    const bool v4 = (KR & 3) == 0 && (KK & 3) == 0 &&
                    ((((uintptr_t)x.rcl) | ((uintptr_t)x.prp) |
                      ((uintptr_t)ro) | ((uintptr_t)po)) & 15) == 0;
    for (int i = tid; i < live_out; i += NT) {
        const size_t s = (size_t)x.h(SLOT, i);
        if (v4) {
            for (int k = 0; k < KR / 4; ++k)
                reinterpret_cast<int4*>(ro + (size_t)i * KR)[k] =
                    reinterpret_cast<const int4*>(x.rcl + s * KR)[k];
            for (int k = 0; k < KK / 4; ++k)
                reinterpret_cast<int4*>(po + (size_t)i * KK)[k] =
                    reinterpret_cast<const int4*>(x.prp + s * KK)[k];
        } else {
            for (int k = 0; k < KR; ++k) ro[(size_t)i * KR + k] = x.rcl[s * KR + k];
            for (int k = 0; k < KK; ++k) po[(size_t)i * KK + k] = x.prp[s * KK + k];
        }
    }
    if (tid == 0) {
        a.n_rows_out[d] = x.n;
        a.err_out[d] = x.err;
        a.geom[2 * d] = K;
        a.geom[2 * d + 1] = nw;
    }
}

// Shared bytes of one block in a layout: `Misc`, the chunk's ops, and
// each part the layout puts in shared memory.
size_t smem_bytes(int C, int KR, int KK, int B, int PK, int layout) {
    size_t ints = (size_t)OPC * B + 2 * (size_t)B * PK;
    const size_t HR = (size_t)C + 2 * B;
    if (layout & L_HOT) ints += (size_t)HOT * ((C + 31) & ~31);
    if (layout & L_RCL) ints += HR * KR;
    if (layout & L_PROPS) ints += HR * KK;
    return SMEM_MISC + 4 * ints;
}

}  // namespace

// The interface's version: 2 added the layout argument and the hot
// scratch pointer to the first design's entry; 3 drops the threads and
// the rows a thread (the kernel takes them) and adds the [D, 2] output
// of the rows a thread and warps each block's op loop took.
extern "C" int mergetree_scan_abi() { return ABI; }

// ptrs: n_rows, error, buf, len, ins_seq, ins_client, rem_seq,
// rem_clients, props (inputs, [D, ...]); the 8 op columns, prop keys,
// prop values ([D, B], [D, B, PK]); buf, len, ins_seq, ins_client,
// rem_seq, rem_clients, props, n_rows, error (outputs: rows at and above
// min(n_rows, C) are not written); the cold heap ([D, (C + 2B) * (KR +
// KK)], read only for the halves that `layout` leaves in global
// memory); the hot scratch ([D, 6, C rounded up to 32], read only when
// `layout` leaves the hot columns in global memory); the op loop's
// geometry ([D, 2] int32 out: rows a thread, warps). smem must be
// `smem_bytes` of the layout. Blocks of NT = 512 threads.
extern "C" int mergetree_scan_launch(int device, int D, int C, int KR,
                                     int KK, int B, int PK, int layout,
                                     int smem, int n_ptrs, void** ptrs,
                                     void* stream) {
    if (n_ptrs != N_PTRS || D < 1 || C < 1 || KR < 1 || KK < 0 || B < 0 ||
        PK < 0 || layout < 0 || layout > (L_HOT | L_RCL | L_PROPS))
        return (int)cudaErrorInvalidValue;
    if ((size_t)smem != smem_bytes(C, KR, KK, B, PK, layout) ||
        smem > SMEM_OPTIN)
        return (int)cudaErrorInvalidValue;

    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;

    Args a;
    a.D = D;
    a.C = C;
    a.KR = KR;
    a.KK = KK;
    a.B = B;
    a.PK = PK;
    a.layout = layout;
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
    a.hot = (int*)ptrs[p++];
    a.geom = (int*)ptrs[p++];

    const void* fn = (const void*)mergetree_scan_kernel;
    if (smem > SMEM_DEFAULT) {
        e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
        if (e != cudaSuccess) return (int)e;
    }
    mergetree_scan_kernel<<<(unsigned)D, NT, (size_t)smem,
                            (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

#ifdef SCAN_PROFILE
// A profiling build's own entry: the [D, PROF_PARTS] int64 buffer on the
// current device into which the next launches write their cycles.
extern "C" int mergetree_scan_profile_into(void* p) {
    return (int)cudaMemcpyToSymbol(g_prof, &p, sizeof(p));
}
#endif
