// Row-model compactions for Hopper (sm_90a): the zamboni and the chunk
// path's full compaction, each a device-wide, stable, multi-column
// compaction of a segment table with no host sync: the zamboni in two
// launches, the compaction (with its text move) in one.
//
// Replaces two XLA functions of fluidframework_tpu/ops/zamboni.py:
//
// - `zamboni_device` (:42), entry `zamboni_launch`. Plain PyTorch
//   version: `ops/zamboni.zamboni_device_ref`.
// - `compact_gather_text` (:185), entry `compaction_launch`. Plain
//   PyTorch version: `ops/zamboni.compact_gather_text_ref`.
//
// Each must equal its plain version on every row, n_rows and error, bit
// for bit; the compaction also on the whole new arena, wherever the
// plain version's event sweep is a function of the table (see below).
// Under the applied MSN `min_seq`:
//
// - rows idx < n_rows are live (every row when n_rows passes C); a live
//   row is kept unless it was removed at or below the MSN; kept rows
//   pack to the front in order, and kept row d's new text offset is the
//   int32 sum of the lengths of the kept rows before it;
// - a kept row is settled when it is not removed and was inserted at or
//   below the MSN; a settled kept row merges into the kept row before it
//   when that one is settled too and every prop is equal, and, for the
//   zamboni only, the previous row's text ends where this one's starts
//   (buf_start + length, int32): the zamboni coalesces only rows that
//   are already contiguous in the arena, the compaction every such pair
//   (its text move makes them contiguous). The two rules stay apart;
// - run r keeps its first row's fields, and its length is the int32 sum
//   of its rows' lengths (the difference of the next run's new offset,
//   or the total, and its own); the zamboni keeps the first row's
//   buf_start, the compaction writes its new offset there;
// - output rows at and above the run count m take the empty-row fills;
//   n_rows = m and the error word passes through;
// - the compaction's new arena (A ints): element e < total belongs to
//   the kept row k with new_off[k] <= e < new_off[k] + length[k] and
//   reads doc_arena[buf[k] + i] when buf[k] lies in [0, A), or
//   stream_text[buf[k] - STREAM_BASE + i] when it lies in
//   [STREAM_BASE, STREAM_BASE + S) (i = e - new_off[k]; a source past
//   its region reads 0); every other element, and every element at or
//   past the total, is 0. The plain version moves the text by an event
//   sweep and a scatter; the two agree on every table whose surviving
//   spans are disjoint and lie inside one region (or in neither), with
//   non-negative lengths summing to at most 2^31 - 1: every table the
//   replay produces. Outside that domain the sweep's result depends on
//   the scatter order, and the kernel only stays in bounds.
//
// The zamboni (reduce, then scan; its two-launch design): tiles of
// TILE = 512 rows, one block of NT = 256 threads a tile. `zb_tiles`
// counts each tile's kept rows, their lengths and their run starts
// (a tile's first kept row is decided against the tile before where
// that tile keeps a row, else left pending) and publishes them with the
// keep and start flags as ballot words; `zb_rows`, a programmatic
// dependent launch, scans every tile's aggregate itself, resolves a
// pending flag, writes each run's output row, the tile's runs' wide
// columns as one contiguous range and the fills at and above m.
//
// The compaction: one launch, a single pass with a decoupled look-back.
// G tiles of TILE rows and E = clamp(G / 8, 1, 32) blocks more, NT
// threads a block. Each block takes a ticket from a counter in the
// scratch (atomicAdd) and works on ticket order, not on blockIdx: a
// block waits only on blocks that took their tickets before it, which
// are all running, so the grid cannot deadlock. The last block to end
// sets the counter back to 0 (and its done counter). With
// L = min(max(n_rows, 0), C) the live rows and t_L the tile of row
// L - 1, tickets 0 .. t_L are tiles that may keep rows and every later
// ticket is a free block. A tile block:
//
//   1. stages its live rows' rem_seq, buf_start, length, ins_seq,
//      ins_client and [rows, KK] props in shared memory (`cp.async.bulk`
//      reported to an mbarrier where the slice is 16-byte aligned and a
//      multiple of 16 bytes, else 4-byte `cp.async`), each column read
//      once; meanwhile warp 0 reads rem_seq of the 32 rows before the
//      tile and, where one of them is kept, its ins_seq and props;
//   2. scans the tile in shared memory: keep flags, kept count, length
//      sum, start flags (the tile's first kept row's against the kept
//      row found in step 1, else pending), the local offset of each kept
//      row and start; it publishes its aggregate (below) and lays out
//      its kept rows' (offset, buf_start) and its run list in shared
//      memory;
//   3. writes its output rows at and above L (only tile t_L has any);
//      warp 0 looks back (below) while warps 1-7 read the tile's text
//      (up to TEXT_CAP ints) into shared memory: each element finds its
//      kept row by a binary search over the staged offsets, so a row of
//      any length is spread over threads;
//   4. with the prefix of the tiles before it (runs r0, text offset
//      len0, the last kept row and the offset of the last start)
//      resolves a pending first flag (the rows' fields are inputs, so
//      no ordering is needed) and publishes its inclusive prefix; then
//      each start writes its run's narrow columns and the length of the
//      run before it; the runs' rem_clients (from device memory) and
//      props (staged) go out as one contiguous range of rows; the text goes to
//      arena[len0, len0 + tile length) clipped to [0, A), one store an
//      element.
//
// A free block, the w-th of W, writes the output rows of its tile (when
// its ticket is a tile past t_L: all of them lie at or above L) at once;
// sums the aggregates of tiles 0 .. t_L for the total text length (no
// junction to decide, so it waits on no tile's prefix) and writes its
// share of the arena's tail [min(total, A), A); then looks back from
// t_L + 1 for the run count m and the last start's offset and writes its
// share of rows [m, L). The first free block writes n_rows, error and
// the last run's length (total minus its offset). Every output int is
// written once.
//
// The look-back, in the style of single-pass prefix scans. A tile's
// aggregate over a range of tiles is (kept rows, their length sum,
// first and last kept row, the first kept row's start flag: 1, 0 or
// pending, the starts among the other kept rows, the local offset of
// the last of those). Two aggregates combine associatively: the
// junction's flag is the later one's first flag where decided, else the
// merge test of the earlier one's last kept row and the later one's
// first kept row (read from the inputs). Each tile publishes its
// aggregate (flag AGGREGATE), then its inclusive prefix (PREFIX), in a
// 16-int record of the scratch: the fields, then the status word
// (epoch << 2 | flag) by a release store; a reader loads the status by
// an acquire load, then the fields. The epoch is the wrapper's call
// count on this scratch (30 bits, never 0, passed by value), so a
// status left by an earlier call never reads as ready. Warp 0 reads 32
// statuses at once, spins until the lanes up to the nearest PREFIX are
// ready, combines those 32 aggregates by a warp tree, and moves 32
// tiles back while it has found no PREFIX.
//
// What bounds it on this card: bytes, at 3.35 TB/s. The compaction must
// read rem_seq of every live row, buf_start, length, ins_seq and the KK
// props of the kept rows, ins_client and the KR removers of the run
// firsts and the text it moves, and write all C rows of 5 + KR + KK int32
// columns and the A-int arena once. At C 131072, KR 24, KK 8 the table's
// writes alone are 19.4 MB (5.8 us) and the arena 10.5 MB (3.1 us): most
// of the bound, and most of them fills, which go out evict-first so
// that L2 keeps what the tiles read. The latency is the stage's first
// copy, the scan, and the look-back chain (an L2 round trip a window of
// 32 tiles, after the slowest tile before has published); the arena's
// tail waits on every tile's aggregate, the rows [m, L) on tile t_L's
// prefix. The earlier design took three launches (`zb_tiles`, `zb_rows`, a
// text gather reading the kept rows' offsets back from a global
// scratch): 0.030549 ms at phase 7's table on an H100 80GB HBM3 at
// 700 W (5.962, 14.925, 18.165 us by the profiler).

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;          // threads a block
constexpr int RPT = 2;           // rows a thread
constexpr int TILE = NT * RPT;   // rows a tile
constexpr int WARPS = NT / 32;
constexpr int WORDS = WARPS * RPT;  // flag words a tile, of each kind
constexpr unsigned FULL = 0xffffffffu;
constexpr int NOT_REMOVED = 2147483647;
constexpr int NO_CLIENT = -3;
constexpr int PROP_ABSENT = -1;
constexpr int STREAM_BASE = 1 << 28;
constexpr int N_PTRS_ZAMBONI = 20;
constexpr int N_PTRS_COMPACTION = 23;

// The zamboni's tile aggregate (written by zb_tiles): field f of tile j
// is agg[f * G + j], so that zb_rows reads each field of every tile in
// one coalesced sweep. Then each tile's 2 WORDS flag words, at
// words[j * 2 WORDS].
enum {
    AG_KEEP,     // kept rows
    AG_LEN,      // unsigned sum of their lengths
    AG_FIRST,    // first kept row (-1: none)
    AG_LAST,     // last kept row (-1: none)
    AG_STARTS,   // run starts among the kept rows but the first
    AG_LSPRE,    // local length prefix of the last of those starts
    AG_FSTART,   // the first kept row starts a run: 1, 0, or -1 (pending)
    NA
};
constexpr int TILE_INTS = NA + 2 * WORDS;  // zamboni scratch ints a tile

// The zamboni's shared memory (ints): scan scratch, the tile values of
// zb_rows, its per-thread prefixes and run-first list.
constexpr int MAXF = 8;                        // fields a scan
constexpr int SH_SCAN = 0;                     // WARPS * MAXF
constexpr int SH_AT = SH_SCAN + WARPS * MAXF;  // MAXF
constexpr int SH_REST = SH_AT + MAXF;
constexpr int SH_LSG = SH_REST;                // NT
constexpr int SH_PRE = SH_LSG + NT;            // NT
constexpr int SH_LIST = SH_PRE + NT;           // TILE
constexpr int SMEM_ROWS = SH_LIST + TILE;

// The compaction's scratch (ints): the ticket and done counters, then a
// record of REC ints a tile: [0] the status word, [1, 8) the aggregate,
// [9, 16) the inclusive prefix (fields in `Agg` order).
constexpr int CNT_INTS = 32;
constexpr int REC = 16;
constexpr int REC_AGG = 0;     // the aggregate's int4 pair starts here
constexpr int REC_PREFIX = 8;  // and the prefix's
constexpr int ST_AGG = 1, ST_PREFIX = 2;
constexpr int MAX_EXTRA = 32;  // free blocks past the tiles, at most
constexpr int TEXT_CAP = 3072; // text ints a tile reads before its look-back

// The compaction's shared memory (ints). block_exscan uses SH_SCAN.
enum { M_TICKET, M_FIRST, M_FST, M_LSO, M_PK, M_PKRS, M_PKIS, M_LEN0, M_R0,
       M_PS, M_HASPS, M_M, M_TOTAL, M_LASTS, M_NONE };
constexpr int SC_MISC = SH_SCAN + WARPS * MAXF;  // 32
constexpr int SC_BAR = SC_MISC + 32;             // the mbarrier (4 ints)
constexpr int SC_COLS = SC_BAR + 4;              // 5 TILE: buf_start, length,
                                                 // ins_seq, ins_client, rem_seq
constexpr int SC_KOFF = SC_COLS + 5 * TILE;      // TILE: kept rows' local offsets
constexpr int SC_KBUF = SC_KOFF + TILE;          // TILE: their buf_start
constexpr int SC_LIST = SC_KBUF + TILE;          // TILE + 4: run list
constexpr int SC_PRE = SC_LIST + TILE + 4;       // NT: each thread's last start
constexpr int SC_TEXT = SC_PRE + NT;             // TEXT_CAP
constexpr int SC_PROPS = SC_TEXT + TEXT_CAP;     // TILE KK, then KK (the row
                                                 // before the tile)
static_assert(SC_COLS % 4 == 0 && SC_PROPS % 4 == 0, "16-byte slices");

__host__ __device__ constexpr long long compaction_smem(int KK) {
    return 4LL * (SC_PROPS + (long long)(TILE + 1) * KK);
}
// The shared memory a block of sm_90 may opt in to: compaction_launch
// refuses a KK past it (KK 99 and over); past 48 KB (KK 10 and over)
// `launch` opts in.
constexpr long long SMEM_OPT_IN = 227 * 1024;

struct Args {
    int C, KR, KK, G;
    int A, S;            // arena and stream text lengths (compaction)
    int grid;            // blocks of the compaction's launch
    unsigned epoch;      // the compaction's call count on its scratch
    int msn_value;       // the MSN, where msn_ptr is null
    const int* msn_ptr;
    const int* n_rows_in;
    const int* err_in;
    const int* col[5];   // buf_start, length, ins_seq, ins_client, rem_seq
    const int* rcl;      // [C, KR]
    const int* props;    // [C, KK]
    const int* doc;      // [A]   (compaction)
    const int* stream;   // [S]   (compaction)
    int* out[5];
    int* rcl_out;
    int* props_out;
    int* n_rows_out;
    int* err_out;
    int* arena_out;      // [A]   (compaction)
    int* agg;            // [NA * G] tile aggregates (zamboni)
    int* words;          // [G * 2 WORDS] keep and start flag words (zamboni)
    int* counter;        // [CNT_INTS] ticket, done (compaction)
    int* tiles;          // [G * REC] tile records (compaction)
};

// ---- Hopper primitives (PTX; the host emulation replaces this block) ----

__device__ __forceinline__ unsigned smem_u32(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

// zb_rows is a programmatic dependent launch: its blocks may start once
// every block of zb_tiles has begun, read only inputs of the call until
// `wait_for_prior_launch` returns (that launch done, its writes
// visible), and so hide the gap between the launches.
__device__ __forceinline__ void launch_dependents() {
    asm volatile("griddepcontrol.launch_dependents;");
}

__device__ __forceinline__ void wait_for_prior_launch() {
    asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ void mbar_init(unsigned long long* b, unsigned n) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_u32(b)), "r"(n) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(unsigned long long* b,
                                               unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem_u32(b)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* b,
                                          unsigned parity) {
    unsigned done;
    do {
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}"
            : "=r"(done) : "r"(smem_u32(b)), "r"(parity) : "memory");
    } while (!done);
}

// Orders this thread's earlier shared-memory accesses before the
// bulk-copy engine's writes that follow.
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// to shared memory by the bulk-copy engine, completion reported to `b`.
__device__ __forceinline__ void bulk_load(int* dst, const int* src,
                                          unsigned bytes,
                                          unsigned long long* b) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];"
        :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(b))
        : "memory");
}

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;" ::: "memory");
}

// A status word: an acquire load (the fields read after it see what was
// written before its release store) and that release store.
__device__ __forceinline__ int ld_acquire(const int* p) {
    int v;
    asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
                 : "=r"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
    asm volatile("st.release.gpu.global.s32 [%0], %1;"
                 :: "l"(p), "r"(v) : "memory");
}

// Another block's record fields, from L2 (not a stale L1 line).
__device__ __forceinline__ int ld_cg(const int* p) { return __ldcg(p); }

__device__ __forceinline__ int4 ld_cg4(const int* p) {
    return __ldcg(reinterpret_cast<const int4*>(p));
}

// A fill's store, evict-first in L2 (`st.global.cs`): nothing reads the
// fills soon, and as plain stores they push the rows and text that the
// compaction's tiles read out of L2.
__device__ __forceinline__ void st_stream(int* p, int v) { __stcs(p, v); }
__device__ __forceinline__ void st_stream(int4* p, int4 v) { __stcs(p, v); }

// ---- end of the PTX ----

__host__ __device__ __forceinline__ int imax(int a, int b) {
    return a > b ? a : b;
}
__host__ __device__ __forceinline__ int imin(int a, int b) {
    return a < b ? a : b;
}
__device__ __forceinline__ long long lmax(long long a, long long b) {
    return a > b ? a : b;
}
__device__ __forceinline__ long long lmin(long long a, long long b) {
    return a < b ? a : b;
}
__device__ __forceinline__ bool aligned16(const void* p) {
    return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

// Field f of a scan combines by signed max when bit f of M is set (row
// and tile indices, identity -1), else by wrapping add (identity 0).
template <unsigned M>
__device__ __forceinline__ int comb(int a, int b, int f) {
    return ((M >> f) & 1u) ? imax(a, b) : (int)((unsigned)a + (unsigned)b);
}
template <unsigned M>
__device__ __forceinline__ int ident(int f) {
    return ((M >> f) & 1u) ? -1 : 0;
}

// Exclusive block scan of N fields a thread: x becomes the combination
// of the threads before this one, tot that of the whole block.
template <unsigned M, int N>
__device__ void block_exscan(int (&x)[N], int (&tot)[N], int* smem) {
    int* sh = smem + SH_SCAN;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int inc[N];
#pragma unroll
    for (int f = 0; f < N; ++f) inc[f] = x[f];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
        for (int f = 0; f < N; ++f) {
            const int y = __shfl_up_sync(FULL, inc[f], o);
            if (lane >= o) inc[f] = comb<M>(inc[f], y, f);
        }
    }
    int ex[N];
#pragma unroll
    for (int f = 0; f < N; ++f) {
        const int y = __shfl_up_sync(FULL, inc[f], 1);
        ex[f] = lane ? y : ident<M>(f);
        if (lane == 31) sh[warp * MAXF + f] = inc[f];
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
        for (int f = 0; f < N; ++f) {
            int w = lane < WARPS ? sh[lane * MAXF + f] : ident<M>(f);
            for (int o = 1; o < WARPS; o <<= 1) {
                const int y = __shfl_up_sync(FULL, w, o);
                if (lane >= o) w = comb<M>(w, y, f);
            }
            if (lane < WARPS) sh[lane * MAXF + f] = w;  // inclusive
        }
    }
    __syncthreads();
#pragma unroll
    for (int f = 0; f < N; ++f) {
        const int before = warp ? sh[(warp - 1) * MAXF + f] : ident<M>(f);
        x[f] = comb<M>(before, ex[f], f);
        tot[f] = sh[(WARPS - 1) * MAXF + f];
    }
    __syncthreads();  // the scratch may be reused right after
}

__device__ __forceinline__ int msn_of(const Args& a) {
    return a.msn_ptr ? *a.msn_ptr : a.msn_value;
}

__device__ __forceinline__ bool keeps(int rem_seq, int msn) {
    return !(rem_seq != NOT_REMOVED && rem_seq <= msn);
}

__device__ __forceinline__ bool settled(int rem_seq, int ins_seq, int msn) {
    return rem_seq == NOT_REMOVED && ins_seq <= msn;
}

// Every prop of two rows equal (16-byte words where both rows are).
__device__ bool same_props(const int* p, const int* q, int KK) {
    int diff = 0;
    if ((KK & 3) == 0 && aligned16(p) && aligned16(q)) {
        const int4* p4 = reinterpret_cast<const int4*>(p);
        const int4* q4 = reinterpret_cast<const int4*>(q);
#pragma unroll 2
        for (int k = 0; k < KK / 4; ++k) {
            const int4 x = p4[k], y = q4[k];
            diff |= (x.x ^ y.x) | (x.y ^ y.y) | (x.z ^ y.z) | (x.w ^ y.w);
        }
    } else {
#pragma unroll 4
        for (int k = 0; k < KK; ++k) diff |= p[k] ^ q[k];
    }
    return diff == 0;
}

// The zamboni's merge test's narrow fields of a row.
struct Key {
    int rs, is, buf, len;  // rem_seq, ins_seq, buf_start, length
};

__device__ __forceinline__ Key key_of(const Args& a, int i) {
    return Key{a.col[4][i], a.col[2][i], a.col[0][i], a.col[1][i]};
}

// The zamboni: kept row s merges into the kept row p before it (see the
// header), given both rows' narrow fields: one round trip to memory, for
// the props, where the narrow fields allow a merge.
__device__ bool merges(const Args& a, int p, const Key& kp, int s,
                       const Key& ks, int msn) {
    const bool m = settled(ks.rs, ks.is, msn) && settled(kp.rs, kp.is, msn) &&
                   (unsigned)kp.buf + (unsigned)kp.len == (unsigned)ks.buf;
    if (!m) return false;
    return same_props(a.props + (long long)p * a.KK,
                      a.props + (long long)s * a.KK, a.KK);
}

// The compaction: kept row s merges into kept row p, both read from the
// inputs (a junction of the look-back).
__device__ bool merges_rows(const Args& a, int p, int s, int msn) {
    if (!settled(a.col[4][p], a.col[2][p], msn) ||
        !settled(a.col[4][s], a.col[2][s], msn))
        return false;
    return same_props(a.props + (long long)p * a.KK,
                      a.props + (long long)s * a.KK, a.KK);
}

// Every int of p[lo, hi) set to v: 16-byte stores on the aligned middle,
// all evict-first (`st_stream`).
__device__ void fill_range(int* p, long long lo, long long hi, int v) {
    if (lo >= hi) return;
    const long long a4 = (lo + 3) & ~3LL, b4 = hi & ~3LL;
    const long long head = a4 < hi ? a4 : hi;
    for (long long e = lo + threadIdx.x; e < head; e += NT) st_stream(p + e, v);
    for (long long e = (a4 > b4 ? a4 : b4) + threadIdx.x; e < hi; e += NT)
        st_stream(p + e, v);
    int4 v4;
    v4.x = v4.y = v4.z = v4.w = v;
    int4* q = reinterpret_cast<int4*>(p);
    for (long long e = a4 / 4 + threadIdx.x; e < b4 / 4; e += NT)
        st_stream(q + e, v4);
}

// Rows list[0 .. ns) of the two wide columns (w1 and w2 units a row) to
// rows r0 .. r0 + ns of their outputs, in one pass: element by element
// (neighbouring threads on neighbouring units), U loads in flight a
// thread. Row q of the first column is in1[(base1 + list[q]) w1 ..], of
// the second in2[(base2 + list[q]) w2 ..].
template <class T>
__device__ void copy_rows(const T* in1, long long base1, T* out1, int w1,
                          const T* in2, long long base2, T* out2, int w2,
                          int r0, int ns, const int* list) {
    constexpr int U = 8;
    const int n1 = ns * w1, n_el = n1 + ns * w2;
    out1 += (long long)r0 * w1;
    out2 += (long long)r0 * w2;
    for (int e0 = 0; e0 < n_el; e0 += U * NT) {
        T v[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int e = e0 + u * NT + (int)threadIdx.x;
            if (e < n1) {
                const int q = e / w1;
                v[u] = in1[(base1 + list[q]) * w1 + (e - q * w1)];
            } else if (e < n_el) {
                const int f = e - n1, q = f / w2;
                v[u] = in2[(base2 + list[q]) * w2 + (f - q * w2)];
            }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int e = e0 + u * NT + (int)threadIdx.x;
            if (e < n1) out1[e] = v[u];
            else if (e < n_el) out2[e - n1] = v[u];
        }
    }
}

// The removers and props of ns runs whose first rows are list[0 .. ns)
// (rows of the table, or with `staged_props`, rows of the tile staged at
// that pointer, tile row 0 being table row `tile0`): in 16-byte words
// where the rows of both are whole words, else in ints.
__device__ void copy_runs(const Args& a, int r0, int ns, const int* list,
                          const int* staged_props, int tile0) {
    if (ns == 0) return;
    const int* pin = staged_props ? staged_props : a.props;
    const long long pbase = staged_props ? 0 : tile0;
    if ((a.KR & 3) == 0 && (a.KK & 3) == 0 && aligned16(a.rcl) &&
        aligned16(pin) && aligned16(a.rcl_out) && aligned16(a.props_out))
        copy_rows(reinterpret_cast<const int4*>(a.rcl), tile0,
                  reinterpret_cast<int4*>(a.rcl_out), a.KR / 4,
                  reinterpret_cast<const int4*>(pin), pbase,
                  reinterpret_cast<int4*>(a.props_out), a.KK / 4, r0, ns,
                  list);
    else
        copy_rows(a.rcl, tile0, a.rcl_out, a.KR, pin, pbase, a.props_out,
                  a.KK, r0, ns, list);
}

// Output rows [lo, hi) take the empty-row fills.
__device__ void fill_rows(const Args& a, long long lo, long long hi) {
    if (lo >= hi) return;
    fill_range(a.out[0], lo, hi, 0);
    fill_range(a.out[1], lo, hi, 0);
    fill_range(a.out[2], lo, hi, 0);
    fill_range(a.out[3], lo, hi, NO_CLIENT);
    fill_range(a.out[4], lo, hi, NOT_REMOVED);
    fill_range(a.rcl_out, lo * a.KR, hi * a.KR, NO_CLIENT);
    fill_range(a.props_out, lo * a.KK, hi * a.KK, PROP_ABSENT);
}

// ======================================================== the zamboni

__global__ void zb_tiles(Args a) {
    extern __shared__ __align__(16) int smem[];
    launch_dependents();
    const int t = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int row0 = t * TILE + threadIdx.x * RPT;
    Key ky[RPT];
    int rq[RPT];
#pragma unroll
    for (int j = 0; j < RPT; ++j) {  // loads first: none waits on n
        const int i = row0 + j;
        ky[j] = i < a.C ? key_of(a, i) : Key{NOT_REMOVED, 0, 0, 0};
        rq[j] = t > 0 ? a.col[4][i - TILE] : NOT_REMOVED;
    }
    const int n = *a.n_rows_in, msn = msn_of(a);
    bool k[RPT];
    // kept rows, length sum, last kept row, last kept row of the tile before
    int x[4] = {0, 0, -1, -1};
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
        const int i = row0 + j;
        k[j] = i < a.C && i < n && keeps(ky[j].rs, msn);
        if (k[j]) {
            ++x[0];
            x[1] = (int)((unsigned)x[1] + (unsigned)ky[j].len);
            x[2] = i;
        }
        if (t > 0 && i - TILE < n && keeps(rq[j], msn)) x[3] = i - TILE;
    }
    int tot[4];
    block_exscan<12u, 4>(x, tot, smem);
    int* ag = a.agg + t;  // field f at ag[f * G]
    const int G = a.G;
    int prev = x[2];
    // The kept row before this thread's first: its fields (a row of the
    // thread before, or of the tile before for the tile's first kept row).
    const int pk = prev >= 0 ? prev : tot[3];
    Key kprev = pk >= 0 ? key_of(a, pk) : Key{};
    unsigned pre = (unsigned)x[1];
    bool s[RPT];
    int st[2] = {0, -1};  // starts but the tile's first kept row, last one
    unsigned last_pre = 0;
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
        s[j] = false;
        if (!k[j]) continue;
        const int i = row0 + j;
        if (prev < 0) {  // the tile's first kept row
            ag[AG_FIRST * G] = i;
            ag[AG_FSTART * G] = t == 0 ? 1 : pk < 0 ? -1
                : !merges(a, pk, kprev, i, ky[j], msn);
        } else if (!merges(a, prev, kprev, i, ky[j], msn)) {
            s[j] = true;
            ++st[0];
            st[1] = i;
            last_pre = pre;
        }
        pre += (unsigned)ky[j].len;
        prev = i;
        kprev = ky[j];
    }
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
        const unsigned kw = __ballot_sync(FULL, k[j]);
        const unsigned sw = __ballot_sync(FULL, s[j]);
        if (lane == 0) {
            int* w = a.words + (long long)t * 2 * WORDS + warp * RPT + j;
            w[0] = (int)kw;
            w[WORDS] = (int)sw;
        }
    }
    const int my_last = st[1];
    int stot[2];
    block_exscan<2u, 2>(st, stot, smem);
    if (my_last >= 0 && my_last == stot[1])
        ag[AG_LSPRE * G] = (int)last_pre;  // this thread holds the last start
    if (threadIdx.x == 0) {
        ag[AG_KEEP * G] = tot[0];
        ag[AG_LEN * G] = tot[1];
        ag[AG_LAST * G] = tot[2];
        ag[AG_STARTS * G] = stot[0];
        if (tot[0] == 0) {
            ag[AG_FIRST * G] = -1;
            ag[AG_FSTART * G] = 0;
        }
    }
}

// zb_rows' scan of every tile's aggregate: the values before tile t
// and the totals, into smem[SH_AT ..]: length offset, run offset, the
// first kept row's start flag, the new offset of the last start before
// the tile; the total length, m.
enum { AT_LEN, AT_START, AT_FSTART, AT_PREVPRE, AT_TOTAL, AT_M };

__device__ void scan_tiles(const Args& a, int t, int msn, int* smem) {
    int ca[3] = {0, 0, -1};  // kept rows, lengths, last kept row
    int cb[2] = {0, -1};     // run starts, last tile with a start
    unsigned carry_lsg = 0;
    for (int base = 0; base < a.G; base += NT) {
        const int j = base + (int)threadIdx.x;
        int xa[3] = {0, 0, -1}, starts = 0, fst = 0, first = -1, lspre = 0;
        if (j < a.G) {
            const int* ag = a.agg + j;
            xa[0] = ag[AG_KEEP * a.G];
            xa[1] = ag[AG_LEN * a.G];
            xa[2] = ag[AG_LAST * a.G];
            starts = ag[AG_STARTS * a.G];
            fst = ag[AG_FSTART * a.G];
            first = ag[AG_FIRST * a.G];
            lspre = ag[AG_LSPRE * a.G];
        }
        int ta[3];
        block_exscan<4u, 3>(xa, ta, smem);
        const int prevkept = imax(ca[2], xa[2]);
        if (fst < 0)  // pending: the tile before kept no row
            fst = prevkept < 0 ? 1
                : !merges(a, prevkept, key_of(a, prevkept), first,
                          key_of(a, first), msn);
        const unsigned lenoff = (unsigned)ca[1] + (unsigned)xa[1];
        const int S = starts + fst;
        smem[SH_LSG + threadIdx.x] =
            (int)(lenoff + (starts ? (unsigned)lspre : 0u));
        int xb[2] = {S, S ? j : -1}, tb[2];
        block_exscan<2u, 2>(xb, tb, smem);
        if (j == t) {
            const int p = imax(cb[1], xb[1]);
            smem[SH_AT + AT_LEN] = (int)lenoff;
            smem[SH_AT + AT_START] = cb[0] + xb[0];
            smem[SH_AT + AT_FSTART] = fst;
            smem[SH_AT + AT_PREVPRE] =
                p < 0 ? 0 : p >= base ? smem[SH_LSG + p - base]
                                      : (int)carry_lsg;
        }
#pragma unroll
        for (int f = 0; f < 3; ++f) ca[f] = comb<4u>(ca[f], ta[f], f);
        cb[0] += tb[0];
        if (tb[1] >= base) {
            cb[1] = tb[1];
            carry_lsg = (unsigned)smem[SH_LSG + tb[1] - base];
        }
        __syncthreads();  // SH_LSG is rewritten by the next round
    }
    if (threadIdx.x == 0) {
        smem[SH_AT + AT_TOTAL] = ca[1];
        smem[SH_AT + AT_M] = cb[0];
    }
    __syncthreads();
}

__global__ void zb_rows(Args a) {
    extern __shared__ __align__(16) int smem[];
    const int t = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int tile0 = t * TILE;
    const int row0 = tile0 + threadIdx.x * RPT;
    launch_dependents();
    // The inputs first, while zb_tiles may still run: the rows' length,
    // buf_start and the fields a run's first row carries.
    int ln[RPT], fc[RPT][4];  // buf_start, ins_seq, ins_client, rem_seq
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
        const int i = row0 + j;
        const bool in = i < a.C;
        ln[j] = in ? a.col[1][i] : 0;
#pragma unroll
        for (int c = 0; c < 4; ++c) fc[j][c] = in ? a.col[c ? c + 1 : 0][i] : 0;
    }
    const int msn = msn_of(a);
    wait_for_prior_launch();
    const int* wd = a.words + (long long)t * 2 * WORDS + warp * RPT;
    unsigned kw[RPT], sw[RPT];
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
        kw[j] = (unsigned)wd[j];
        sw[j] = (unsigned)wd[WORDS + j];
    }
    const int first = a.agg[AG_FIRST * a.G + t];
    scan_tiles(a, t, msn, smem);
    const unsigned len0 = (unsigned)smem[SH_AT + AT_LEN];
    const int r0 = smem[SH_AT + AT_START];
    const bool fstart = smem[SH_AT + AT_FSTART] != 0;
    const unsigned tile_prev_pre = (unsigned)smem[SH_AT + AT_PREVPRE];
    const int m = smem[SH_AT + AT_M];
    const unsigned total = (unsigned)smem[SH_AT + AT_TOTAL];

    bool k[RPT], s[RPT];
    // kept rows, length sum, starts, last start row
    int x[4] = {0, 0, 0, -1};
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
        const int i = row0 + j;
        k[j] = (kw[j] >> lane) & 1u;
        s[j] = k[j] && (i == first ? fstart : ((sw[j] >> lane) & 1u) != 0);
        if (k[j]) {
            ++x[0];
            x[1] = (int)((unsigned)x[1] + (unsigned)ln[j]);
        }
        if (s[j]) {
            ++x[2];
            x[3] = i;
        }
    }
    int tot[4];
    block_exscan<8u, 4>(x, tot, smem);
    unsigned pre[RPT], my_pre = 0;
    {
        unsigned p = len0 + (unsigned)x[1];
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
            pre[j] = p;
            if (s[j]) my_pre = p;
            if (k[j]) p += (unsigned)ln[j];
        }
    }
    smem[SH_PRE + threadIdx.x] = (int)my_pre;
    __syncthreads();
    unsigned prev_pre = x[3] >= 0
        ? (unsigned)smem[SH_PRE + (x[3] - tile0) / RPT] : tile_prev_pre;
    int li = x[2];  // the tile's index of this thread's next start
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
        if (!s[j]) continue;
        const int r = r0 + li;
        a.out[0][r] = fc[j][0];
        a.out[2][r] = fc[j][1];
        a.out[3][r] = fc[j][2];
        a.out[4][r] = fc[j][3];
        if (r > 0) a.out[1][r - 1] = (int)(pre[j] - prev_pre);
        if (r == m - 1) a.out[1][r] = (int)(total - pre[j]);
        smem[SH_LIST + li] = row0 + j - tile0;
        prev_pre = pre[j];
        ++li;
    }
    __syncthreads();
    // The wide columns of the tile's runs: one contiguous output range.
    copy_runs(a, r0, tot[2], smem + SH_LIST, nullptr, tile0);
    // The tile's output rows at and above m take the fills.
    fill_rows(a, imax(m, tile0), imin(a.C, tile0 + TILE));
    if (t == 0 && threadIdx.x == 0) {
        *a.n_rows_out = m;
        *a.err_out = *a.err_in;
    }
}

// ===================================================== the compaction

// An aggregate over a range of tiles (see the header): kept rows, their
// length sum, first and last kept row (-1: none), the first kept row's
// start flag (1, 0, or -1 pending), the starts among the other kept
// rows, and the offset of the last of those from the range's text start.
struct Agg {
    int keep;
    unsigned len;
    int first, last, fst, starts;
    unsigned lso;
};

__device__ __forceinline__ Agg agg_none() {
    return Agg{0, 0u, -1, -1, -1, 0, 0u};
}

// x then y (adjacent ranges, x first): associative, with agg_none() its
// identity on both sides.
__device__ Agg combine(const Args& a, const Agg& x, const Agg& y, int msn) {
    if (x.keep == 0) return y;
    if (y.keep == 0) return x;
    const int j = y.fst >= 0 ? y.fst : !merges_rows(a, x.last, y.first, msn);
    Agg r;
    r.keep = x.keep + y.keep;
    r.len = x.len + y.len;
    r.first = x.first;
    r.fst = x.fst;
    r.last = y.last;
    r.starts = x.starts + j + y.starts;
    r.lso = y.starts ? x.len + y.lso : j ? x.len : x.lso;
    return r;
}

__device__ __forceinline__ Agg shfl_down_agg(const Agg& v, int o) {
    Agg r;
    r.keep = __shfl_down_sync(FULL, v.keep, o);
    r.len = (unsigned)__shfl_down_sync(FULL, (int)v.len, o);
    r.first = __shfl_down_sync(FULL, v.first, o);
    r.last = __shfl_down_sync(FULL, v.last, o);
    r.fst = __shfl_down_sync(FULL, v.fst, o);
    r.starts = __shfl_down_sync(FULL, v.starts, o);
    r.lso = (unsigned)__shfl_down_sync(FULL, (int)v.lso, o);
    return r;
}

// Tile t's record: its aggregate (at REC_AGG) or its inclusive prefix
// (at REC_PREFIX), then the status word.
__device__ void publish(const Args& a, int t, const Agg& g, int at,
                        int flag) {
    int* rec = a.tiles + (long long)t * REC;
    rec[at + 1] = g.keep;
    rec[at + 2] = (int)g.len;
    rec[at + 3] = g.first;
    rec[at + 4] = g.last;
    rec[at + 5] = g.fst;
    rec[at + 6] = g.starts;
    rec[at + 7] = (int)g.lso;
    st_release(rec, (int)((a.epoch << 2) | (unsigned)flag));
}

__device__ __forceinline__ Agg load_rec(const int* p) {
    const int4 x = ld_cg4(p), y = ld_cg4(p + 4);
    return Agg{x.y, (unsigned)x.z, x.w, y.x, y.y, y.z, (unsigned)y.w};
}

// Warp 0, lane l on tile base - l: spins until the records of this call
// are ready on the lanes up to the nearest inclusive prefix (a tile
// below 0 reads as a prefix of nothing); returns the lane of that prefix
// (32: none in the window) and leaves each lane's status in `st`.
__device__ int await_window(const Args& a, int base, int& st) {
    const int k = base - (threadIdx.x & 31);
    const int* rec = a.tiles + (long long)(k < 0 ? 0 : k) * REC;
    for (;;) {
        bool valid = true, pre = true;
        if (k >= 0) {
            st = ld_acquire(rec);
            valid = ((unsigned)st >> 2) == a.epoch && (st & 3) != 0;
            pre = valid && (st & 3) == ST_PREFIX;
        }
        const unsigned vm = __ballot_sync(FULL, valid);
        const unsigned pm = __ballot_sync(FULL, pre);
        const unsigned need = pm ? ((pm & (0u - pm)) << 1) - 1u : FULL;
        if ((vm & need) == need) return pm ? __ffs(pm) - 1 : 32;
    }
}

// The record of tile k that `await_window` found: its inclusive prefix
// where the status says so, else its aggregate.
__device__ __forceinline__ const int* ready_rec(const Args& a, int k, int st) {
    return a.tiles + (long long)k * REC +
           ((st & 3) == ST_PREFIX ? REC_PREFIX : REC_AGG);
}

// Warp 0: the combination of tiles [0, u), from their records.
__device__ Agg look_back(const Args& a, int u, int msn) {
    const int lane = threadIdx.x & 31;
    Agg acc = agg_none();
    for (int base = u - 1;; base -= 32) {
        const int k = base - lane;
        int st = 0;
        const int lim = await_window(a, base, st);
        Agg v = agg_none();
        if (lane <= lim && k >= 0) v = load_rec(ready_rec(a, k, st));
        // lane l holds tile base - l: a tree from the back
        for (int o = 1; o < 32; o <<= 1) {
            const Agg w = shfl_down_agg(v, o);
            if ((lane & (2 * o - 1)) == 0) v = combine(a, w, v, msn);
        }
        // lane 0's window, to every lane
        v.keep = __shfl_sync(FULL, v.keep, 0);
        v.len = (unsigned)__shfl_sync(FULL, (int)v.len, 0);
        v.first = __shfl_sync(FULL, v.first, 0);
        v.last = __shfl_sync(FULL, v.last, 0);
        v.fst = __shfl_sync(FULL, v.fst, 0);
        v.starts = __shfl_sync(FULL, v.starts, 0);
        v.lso = (unsigned)__shfl_sync(FULL, (int)v.lso, 0);
        acc = combine(a, v, acc, msn);
        if (lim < 32) return acc;
    }
}

// Warp 0: the text length of tiles [0, u) alone, which needs only their
// aggregates: a sum, with no junction to decide.
__device__ unsigned look_back_len(const Args& a, int u) {
    const int lane = threadIdx.x & 31;
    unsigned acc = 0;
    for (int base = u - 1;; base -= 32) {
        const int k = base - lane;
        int st = 0;
        const int lim = await_window(a, base, st);
        unsigned v = lane <= lim && k >= 0
            ? (unsigned)ld_cg(ready_rec(a, k, st) + 2) : 0u;
        for (int o = 16; o; o >>= 1)
            v += (unsigned)__shfl_xor_sync(FULL, (int)v, o);
        acc += v;
        if (lim < 32) return acc;
    }
}

// The tile's live rows [tile0, tile0 + nst) of the five narrow columns
// and the props into shared memory: six contiguous slices, each by the
// bulk-copy engine where it can take it, else by 4-byte copies; not
// waited for here.
__device__ void stage_tile(const Args& a, int tile0, int nst, int* smem) {
    unsigned long long* bar = (unsigned long long*)(smem + SC_BAR);
    const int* src[6];
    int* dst[6];
    int n[6];
    for (int c = 0; c < 5; ++c) {
        src[c] = a.col[c] + tile0;
        dst[c] = smem + SC_COLS + c * TILE;
        n[c] = nst;
    }
    src[5] = a.props + (long long)tile0 * a.KK;
    dst[5] = smem + SC_PROPS;
    n[5] = nst * a.KK;
    bool bulk[6];
    unsigned tx = 0;
    for (int c = 0; c < 6; ++c) {
        bulk[c] = n[c] % 4 == 0 && aligned16(src[c]);
        tx += bulk[c] ? 4u * (unsigned)n[c] : 0u;
    }
    if (threadIdx.x == 0) {
        fence_proxy_async();
        mbar_arrive_tx(bar, tx);
        for (int c = 0; c < 6; ++c)
            if (bulk[c] && n[c])
                bulk_load(dst[c], src[c], 4u * (unsigned)n[c], bar);
    }
    for (int c = 0; c < 6; ++c)
        if (!bulk[c])
            for (int i = threadIdx.x; i < n[c]; i += NT)
                cp_async4(dst[c] + i, src[c] + i);
}

// The text of element i of a span whose buf_start is b (see the header).
__device__ __forceinline__ int fetch(const Args& a, int b, long long i) {
    if (b >= 0 && b < a.A) {
        const long long s = (long long)b + i;
        return s >= 0 && s < a.A ? a.doc[s] : 0;
    }
    if (b >= STREAM_BASE && (long long)b < (long long)STREAM_BASE + a.S) {
        const long long s = (long long)b - STREAM_BASE + i;
        return s >= 0 && s < a.S ? a.stream[s] : 0;
    }
    return 0;
}

// Element i of the tile's text: the last of its kt kept rows whose local
// offset is at most i (a zero-length row never owns an element).
__device__ __forceinline__ int tile_text(const Args& a, const int* smem,
                                         int kt, int i) {
    const int* koff = smem + SC_KOFF;
    int lo = 0, hi = kt;  // koff[lo] <= i < koff[hi]
    while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (koff[mid] <= i) lo = mid;
        else hi = mid;
    }
    return fetch(a, smem[SC_KBUF + lo], (long long)i - koff[lo]);
}

// A tile that may keep rows: tile t, rows [tile0, tile0 + TILE), its
// live rows [tile0, tile0 + nst).
__device__ void tile_block(const Args& a, int t, int L, int msn, int* smem) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int tile0 = t * TILE, nst = imin(TILE, L - tile0);
    int* misc = smem + SC_MISC;
    const int* s_buf = smem + SC_COLS;
    const int* s_len = s_buf + TILE;
    const int* s_is = s_len + TILE;
    const int* s_ic = s_is + TILE;
    const int* s_rs = s_ic + TILE;
    const int* s_props = smem + SC_PROPS;
    int* s_pp = smem + SC_PROPS + TILE * a.KK;  // the kept row before
    int* koff = smem + SC_KOFF;
    int* kbuf = smem + SC_KBUF;
    int* list = smem + SC_LIST;

    // 1. the stage; warp 0 looks for a kept row among the 32 before the tile
    stage_tile(a, tile0, nst, smem);
    if (warp == 0) {
        int pk = -1;
        if (t > 0) {  // every row before the tile is live
            const int i = tile0 - 32 + lane;
            const unsigned b = __ballot_sync(FULL, keeps(a.col[4][i], msn));
            pk = b ? tile0 - 32 + 31 - __clz((int)b) : -1;
            if (pk >= 0)
                for (int c = lane; c < a.KK; c += 32)
                    s_pp[c] = a.props[(long long)pk * a.KK + c];
        }
        if (lane == 0) {
            misc[M_PK] = pk;
            if (pk >= 0) {
                misc[M_PKRS] = a.col[4][pk];
                misc[M_PKIS] = a.col[2][pk];
            }
        }
    }
    cp_async_wait_all();
    mbar_wait((unsigned long long*)(smem + SC_BAR), 0);
    __syncthreads();

    // 2. the scan: kept rows, their lengths, the last kept row before
    const int l0 = threadIdx.x * RPT;
    bool k[RPT];
    int x[3] = {0, 0, -1};
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
        const int li = l0 + j;
        k[j] = li < nst && keeps(s_rs[li], msn);
        if (k[j]) {
            ++x[0];
            x[1] = (int)((unsigned)x[1] + (unsigned)s_len[li]);
            x[2] = li;
        }
    }
    int tot[3];
    block_exscan<4u, 3>(x, tot, smem);
    const int kt = tot[0];
    // start flags: the tile's first kept row against the row found in
    // step 1 (else pending), every other kept row against the kept row
    // before it in the tile
    bool s[RPT];
    unsigned pre[RPT], my_pre = 0;
    int st[2] = {0, -1};  // starts but the first kept row, the last one
    {
        int prev = x[2], d = x[0];
        unsigned p = (unsigned)x[1];
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
            const int li = l0 + j;
            s[j] = false;
            pre[j] = p;
            if (!k[j]) continue;
            if (prev < 0) {
                const int pk = misc[M_PK];
                misc[M_FIRST] = li;
                misc[M_FST] = t == 0 ? 1 : pk < 0 ? -1
                    : !(settled(misc[M_PKRS], misc[M_PKIS], msn) &&
                        settled(s_rs[li], s_is[li], msn) &&
                        same_props(s_pp, s_props + li * a.KK, a.KK));
            } else if (!(settled(s_rs[prev], s_is[prev], msn) &&
                         settled(s_rs[li], s_is[li], msn) &&
                         same_props(s_props + prev * a.KK,
                                    s_props + li * a.KK, a.KK))) {
                s[j] = true;
                ++st[0];
                st[1] = li;
                my_pre = p;
            }
            koff[d] = (int)p;
            kbuf[d] = s_buf[li];
            ++d;
            p += (unsigned)s_len[li];
            prev = li;
        }
    }
    const int my_last = st[1];
    int stot[2];
    block_exscan<2u, 2>(st, stot, smem);
    if (my_last >= 0 && my_last == stot[1]) misc[M_LSO] = (int)my_pre;
    smem[SC_PRE + threadIdx.x] = (int)my_pre;
    {
        int ls = 1 + st[0];  // list[0]: the first kept row
#pragma unroll
        for (int j = 0; j < RPT; ++j)
            if (s[j]) list[ls++] = l0 + j;
    }
    __syncthreads();
    const int first = kt ? misc[M_FIRST] : -1;
    Agg own = agg_none();  // the tile's aggregate, in thread 0
    if (threadIdx.x == 0) {
        list[0] = first;
        if (kt)
            own = Agg{kt, (unsigned)tot[1], tile0 + first, tile0 + tot[2],
                      misc[M_FST], stot[0],
                      stot[0] ? (unsigned)misc[M_LSO] : 0u};
        publish(a, t, own, REC_AGG, ST_AGG);
    }

    // 3. the fills at and above L; the look-back beside the text's reads
    fill_rows(a, imax(L, tile0), imin(a.C, tile0 + TILE));
    const int tl = tot[1];  // the tile's text length
    if (warp == 0) {
        const Agg e = look_back(a, t, msn);
        if (lane == 0) {
            if (kt && own.fst < 0)  // pending: decided against the prefix
                own.fst = e.keep ? !merges_rows(a, e.last, own.first, msn) : 1;
            publish(a, t, combine(a, e, own, msn), REC_PREFIX, ST_PREFIX);
            misc[M_FST] = kt ? own.fst : 0;
            misc[M_LEN0] = (int)e.len;
            misc[M_R0] = e.starts + (e.keep ? 1 : 0);
            misc[M_HASPS] = e.keep ? 1 : 0;
            misc[M_PS] = (int)(e.starts ? e.lso : 0u);
        }
    } else {
        for (int i = threadIdx.x - 32; i < imin(tl, TEXT_CAP); i += NT - 32)
            smem[SC_TEXT + i] = tile_text(a, smem, kt, i);
    }
    __syncthreads();

    // 4. the runs' rows and the text
    const unsigned len0 = (unsigned)misc[M_LEN0];
    const int r0 = misc[M_R0], fst = misc[M_FST];
    {
        int ls = fst + st[0];  // the tile's run index of the next start
        bool has;
        unsigned prevs;
        if (st[1] >= 0) {  // a start of a thread before
            has = true;
            prevs = len0 + (unsigned)smem[SC_PRE + st[1] / RPT];
        } else if (fst) {  // the first kept row, at the tile's offset 0
            has = true;
            prevs = len0;
        } else {
            has = misc[M_HASPS] != 0;
            prevs = (unsigned)misc[M_PS];
        }
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
            const int li = l0 + j;
            const bool isfirst = k[j] && li == first;
            if (!(isfirst ? fst != 0 : s[j])) continue;
            const unsigned o = len0 + pre[j];
            int r;
            if (isfirst) {
                r = r0;
                if (misc[M_HASPS])
                    a.out[1][r - 1] = (int)(o - (unsigned)misc[M_PS]);
            } else {
                r = r0 + ls++;
                if (has) a.out[1][r - 1] = (int)(o - prevs);
                has = true;
                prevs = o;
            }
            a.out[0][r] = (int)o;
            a.out[2][r] = s_is[li];
            a.out[3][r] = s_ic[li];
            a.out[4][r] = s_rs[li];
        }
    }
    copy_runs(a, r0, fst + stot[0], list + (fst ? 0 : 1), s_props, tile0);
    const long long base = (int)len0;
    const long long i_hi = lmin(tl, (long long)a.A - base);
    for (long long i = lmax(0, -base) + threadIdx.x; i < i_hi; i += NT)
        a.arena_out[base + i] = i < TEXT_CAP ? smem[SC_TEXT + i]
                                             : tile_text(a, smem, kt, (int)i);
}

// A block past the last tile that may keep rows, the w-th of W: its
// tile's fills at once (where its ticket is a tile); once every tile's
// aggregate is out, the total text length and its share of the arena's
// tail; once the last tile's prefix is out, its share of rows [m, L).
__device__ void free_block(const Args& a, int ticket, int L, int t_last,
                           int msn, int* smem) {
    int* misc = smem + SC_MISC;
    const long long W = a.grid - (t_last + 1), w = ticket - (t_last + 1);
    if (ticket < a.G)
        fill_rows(a, imax(L, ticket * TILE), imin(a.C, (ticket + 1) * TILE));
    if (threadIdx.x < 32) {
        const unsigned total = t_last >= 0 ? look_back_len(a, t_last + 1) : 0u;
        if (threadIdx.x == 0) misc[M_TOTAL] = (int)total;
    }
    __syncthreads();
    const long long z = lmin(lmax((int)misc[M_TOTAL], 0), a.A);
    const long long tail = a.A - z;
    fill_range(a.arena_out, z + tail * w / W, z + tail * (w + 1) / W, 0);
    if (threadIdx.x < 32) {
        const Agg g = t_last >= 0 ? look_back(a, t_last + 1, msn) : agg_none();
        if (threadIdx.x == 0) {
            misc[M_M] = g.starts + (g.keep ? 1 : 0);
            misc[M_LASTS] = (int)(g.starts ? g.lso : 0u);
        }
    }
    __syncthreads();
    const int m = misc[M_M];
    const long long rows = L - m;
    fill_rows(a, m + rows * w / W, m + rows * (w + 1) / W);
    if (w == 0 && threadIdx.x == 0) {
        *a.n_rows_out = m;
        *a.err_out = *a.err_in;
        if (m > 0)
            a.out[1][m - 1] = (int)((unsigned)misc[M_TOTAL] -
                                    (unsigned)misc[M_LASTS]);
    }
}

__global__ void zb_compact(Args a) {
    extern __shared__ __align__(16) int smem[];
    int* misc = smem + SC_MISC;
    if (threadIdx.x == 0) {
        misc[M_TICKET] = atomicAdd(a.counter, 1);
        mbar_init((unsigned long long*)(smem + SC_BAR), 1);
    }
    const int n = *a.n_rows_in, msn = msn_of(a);
    __syncthreads();
    const int ticket = misc[M_TICKET];
    const int L = imin(imax(n, 0), a.C);
    const int t_last = L > 0 ? (L - 1) / TILE : -1;
    if (ticket <= t_last) tile_block(a, ticket, L, msn, smem);
    else free_block(a, ticket, L, t_last, msn, smem);
    // The last block to end sets the counters back for the next call.
    __syncthreads();
    if (threadIdx.x == 0 && atomicAdd(a.counter + 1, 1) == a.grid - 1) {
        a.counter[0] = 0;
        a.counter[1] = 0;
    }
}

// One launch of NT threads a block; `dependent`: a programmatic
// dependent launch (see `wait_for_prior_launch`).
int launch(void (*kernel)(Args), int grid, size_t smem, cudaStream_t s,
           const Args& a, bool dependent) {
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    if (!dependent) {
        kernel<<<grid, NT, (size_t)smem, s>>>(a);
    } else {
        cudaLaunchAttribute attr[1];
        attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
        attr[0].val.programmaticStreamSerializationAllowed = 1;
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = dim3(grid);
        cfg.blockDim = dim3(NT);
        cfg.dynamicSmemBytes = smem;
        cfg.stream = s;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
        const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
        if (e != cudaSuccess) return (int)e;
    }
    return (int)cudaGetLastError();
}

// The table pointers shared by both entries: n_rows, error, min_seq
// (null: the value is passed), buf_start, length, ins_seq, ins_client,
// rem_seq, rem_clients, props (inputs); buf_start, length, ins_seq,
// ins_client, rem_seq, rem_clients, props, n_rows, error (outputs).
void table_args(Args& a, void** ptrs) {
    a.n_rows_in = (const int*)ptrs[0];
    a.err_in = (const int*)ptrs[1];
    a.msn_ptr = (const int*)ptrs[2];
    for (int c = 0; c < 5; ++c) a.col[c] = (const int*)ptrs[3 + c];
    a.rcl = (const int*)ptrs[8];
    a.props = (const int*)ptrs[9];
    for (int c = 0; c < 5; ++c) a.out[c] = (int*)ptrs[10 + c];
    a.rcl_out = (int*)ptrs[15];
    a.props_out = (int*)ptrs[16];
    a.n_rows_out = (int*)ptrs[17];
    a.err_out = (int*)ptrs[18];
}

bool bad_shape(int C, int KR, int KK, int G) {
    return C <= 0 || KR < 0 || KK < 0 || G != (C + TILE - 1) / TILE;
}

}  // namespace

// ptrs: the 19 table pointers (`table_args`), then the int32 scratch of
// TILE_INTS G ints (20 pointers).
extern "C" int zamboni_launch(int device, int C, int KR, int KK, int G,
                              int msn, int n_ptrs, void** ptrs,
                              void* stream) {
    if (n_ptrs != N_PTRS_ZAMBONI || bad_shape(C, KR, KK, G))
        return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    Args a = {};
    a.C = C;
    a.KR = KR;
    a.KK = KK;
    a.G = G;
    a.msn_value = msn;
    table_args(a, ptrs);
    a.agg = (int*)ptrs[19];
    a.words = a.agg + (long long)NA * G;
    const cudaStream_t s = (cudaStream_t)stream;
    const int r = launch(zb_tiles, G, sizeof(int) * SH_REST, s, a, false);
    if (r) return r;
    return launch(zb_rows, G, sizeof(int) * SMEM_ROWS, s, a, true);
}

// The dynamic shared memory of a compaction block at KK prop keys, in
// bytes.
extern "C" long long compaction_smem_bytes(int KK) {
    return compaction_smem(KK);
}

// ptrs: the 19 table pointers (`table_args`); the int32 scratch of
// CNT_INTS + REC G ints (zeroed when it is made, and left with its
// counters at 0 by every call); doc_arena [A], stream_text [S]; the new
// arena [A] (23 pointers). `epoch`: this call's count on the scratch,
// 1 to 2^30 - 1, another than the last call's.
extern "C" int compaction_launch(int device, int C, int KR, int KK, int G,
                                 int A, int S, int msn, int epoch,
                                 int n_ptrs, void** ptrs, void* stream) {
    if (n_ptrs != N_PTRS_COMPACTION || bad_shape(C, KR, KK, G) || A < 0 ||
        S < 0 || epoch <= 0 || epoch >= (1 << 30) ||
        compaction_smem(KK) > SMEM_OPT_IN)
        return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    Args a = {};
    a.C = C;
    a.KR = KR;
    a.KK = KK;
    a.G = G;
    a.A = A;
    a.S = S;
    a.grid = G + imin(imax(G / 8, 1), MAX_EXTRA);
    a.epoch = (unsigned)epoch;
    a.msn_value = msn;
    table_args(a, ptrs);
    a.counter = (int*)ptrs[19];
    a.tiles = a.counter + CNT_INTS;
    a.doc = (const int*)ptrs[20];
    a.stream = (const int*)ptrs[21];
    a.arena_out = (int*)ptrs[22];
    return launch(zb_compact, a.grid, (size_t)compaction_smem(KK),
                  (cudaStream_t)stream, a, false);
}
