// The overlay fold for Hopper (sm_90a): the settle-merge of a chunk
// boundary and, in its append form, the log append of a replay step, in
// one launch of one thread-block cluster per document, with no host
// sync.
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
//   with wraparound, as XLA computes it (unsigned arithmetic here, on
//   one prefix of delta = ins - exc);
// - the stable partition: kept row of rank k (kept rows before it) goes
//   to output row k as [new_anchor, new_buf, len, ins_seq, ins_client,
//   rem_seq, rem_clients, props]; output rows at and above n_new (the
//   kept count) take the fills 0, 0, 0, 0, NO_CLIENT, NOT_REMOVED,
//   NO_CLIENT, PROP_ABSENT;
// - the record block is the partition rotated by n_new: a row that is
//   not kept (a folding row, or a dead row at or above n_rows, whose buf
//   stays as it was) of drop rank j (rows not kept before it) is record
//   j, and kept row k is record W - n_new + k; a record is [old anchor,
//   code, new_buf, len, ins_seq, props] with code 1 settle_text, 2 drop
//   & is_span, 3 settle_span, else 0; n_rec = (live rows) - n_new;
// - append form: the W records go to log rows [start, start + W) of the
//   document, start = clamp(cursor, 0, cap - W) as
//   `lax.dynamic_update_slice` clamps; counts[epoch] = n_rec; the new
//   cursor (a separate output) = cursor + n_rec. The input table is
//   never written; the log and counts are written in place.
//
// Design. One cluster of G CTAs (G = 1, 2, 4 or 8; the wrapper picks it
// from D and W) per document, NT = 256 threads a CTA. CTA c of the
// cluster owns the contiguous tile of rows [c T, c T + T) (T = W / G
// rounded up to 4 rows; the last tile may be shorter or empty) and
// walks it in segments of at most S rows (S up to 4096 rows, fewer
// where 36 + 4 KK bytes a row would not fit in 227 KB: 3416 at KK 8;
// one segment unless a tile is longer, which the wrapper avoids up to
// G = 8):
//
// 1. Stage: the segment's six narrow columns (anchor, buf, len,
//    ins_seq, ins_client, rem_seq) and its props go into shared memory
//    by the bulk-copy engine (`cp.async.bulk` reported to an mbarrier)
//    where the slice is 16-byte aligned and a multiple of 16 bytes,
//    else by 4-byte `cp.async`.
// 2. Scan: each warp takes a contiguous run of the segment's rows, 32
//    at a time; a ballot counts the kept rows and one warp scan prefixes
//    delta, so each row's new anchor is known up to its warp's base. The
//    warps' totals in shared memory, one barrier, give the warp bases
//    and the segment's totals.
// 3. Cluster: each CTA publishes its tile's kept count and delta in its
//    own shared memory and arrives at a cluster barrier. The partition
//    is stable, so a segment's kept rows land as one contiguous run of
//    output rows and one of records, and its other rows as one run of
//    records: while the other ranks arrive, each thread walks its rows
//    again (a ballot gives the keep rank) and writes the segment's map
//    (run position -> row) and the rows' record codes into shared
//    memory. Then it waits, and reads the totals of the other ranks over
//    distributed shared memory (`mapa` and `ld.shared::cluster`): its
//    base keep and drop ranks, its delta base, and the cluster's n_new,
//    which every record position needs.
// 4. Write: each row takes its new anchor and new buf (the bases
//    added); a barrier, then the CTA writes its runs with coalesced
//    stores: the narrow columns, the records and the kept rows' props
//    from shared memory, the kept rows' rem_clients whole from the
//    source row whose index is in shared memory (the one gather from
//    device memory), as 16-byte vectors where the row width and
//    alignment allow, eight rows' loads in flight a thread. Each thread
//    keeps one column of the rows it copies (one load form, no branch a
//    record element), so there is no division by a row width an
//    element, and no global load's address depends on another global
//    load.
// 5. The fill rows [n_new, W) are split evenly across the cluster's
//    CTAs; thread 0 of rank 0 writes n_rows, settled_len, n_rec or
//    counts[epoch], and the new cursor. A second cluster barrier keeps
//    every CTA's shared memory alive until the other ranks have read it.
//
// Every output int is written once, by one thread; no atomics, no
// global scratch.
//
// What bounds it on this card: bytes, at 3.35 TB/s. The function reads
// the table (6 + KR + KK ints a row; less where a column is not needed)
// and writes the new table and the record block (5 + KK ints a row): at
// W 2048, KR 24, KK 8 about 0.6 MB a document, ~0.2 us, far below a
// launch. A single document is therefore latency-bound: the launch and
// a cluster's start, the stage's round trip to device memory, the
// barriers (one block barrier a scan, two cluster barriers) and the
// dependent chain copy-in -> scan -> exchange -> write set its time;
// G CTAs shorten the chain by G. D = 132 documents fill the SMs (G = 1)
// and there the bytes, at about 25 GB/s an SM, are the limit.
//
// The first design (one block of 1024 threads a document, the row maps
// in a global scratch, every output element through two dependent
// loads) took 0.045250 ms a launch for one document at W 2048, KR 24,
// KK 8, and 0.076096 ms at D = 132 (H100 80GB HBM3, 700 W).

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;  // threads a CTA
constexpr int WARPS = NT / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int NOT_REMOVED = 2147483647;
constexpr int NO_CLIENT = -3;
constexpr int PROP_ABSENT = -1;
constexpr int SETTLED_BASE = 1 << 30;
constexpr int REC_SETTLE_TEXT = 1;
constexpr int REC_DROP_SPAN = 2;
constexpr int REC_SETTLE_SPAN = 3;
constexpr int N_PTRS = 26;
constexpr int MAX_CLUSTER = 8;   // the portable cluster size
constexpr int MAX_SEGMENT = 4096;  // rows a CTA stages at once
constexpr int MAX_SMEM = 232448;   // an sm_90 block's dynamic shared memory
// Shared memory, in ints: the staging mbarrier (2), the CTA's published
// totals (2), 4 spare, the warps' totals (2 WARPS); then N_COLS columns
// of S ints and the segment's props (S x KK ints; S a multiple of 4, so
// every array is 16-byte aligned).
constexpr int PUB = 2;
constexpr int WT = 8;
constexpr int HEAD = WT + 2 * WARPS;
enum { C_ANCHOR, C_BUF, C_LEN, C_INS_SEQ, C_INS_CLIENT, C_REM_SEQ,
       C_NEW_ANCHOR, C_PERM, C_CODE, N_COLS };
constexpr int N_STAGED = 6;  // the first six columns come from the table

__host__ __device__ constexpr long long smem_bytes(int S, int KK) {
    return 4LL * (HEAD + (long long)S * (N_COLS + KK));
}

// ---- Hopper primitives (PTX; the host emulation replaces this block) ----

__device__ __forceinline__ unsigned smem_u32(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ unsigned cluster_rank() {
    unsigned r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
    return r;
}

__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// The int at `p`'s offset in the shared memory of cluster rank `rank`.
__device__ __forceinline__ int dsmem_load(const int* p, unsigned rank) {
    unsigned a;
    int v;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(a) : "r"(smem_u32(p)), "r"(rank));
    asm volatile("ld.shared::cluster.s32 %0, [%1];"
                 : "=r"(v) : "r"(a) : "memory");
    return v;
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

// ---- end of the PTX ----

struct Args {
    int W, KR, KK, G;
    int T;   // rows a tile (a multiple of 4)
    int S;   // rows a segment (a multiple of 4, at most MAX_SEGMENT)
    // inputs, [D] scalars and [D, W] / [D, W, K] columns
    const int* n_rows;
    const int* settled_len;
    const int* col[N_STAGED];  // anchor, buf, len, ins_seq, ins_client, rem_seq
    const int* rem_clients;
    const int* props;
    const int* msn;  // null: msn_value
    int msn_value, msn_stride;
    // the output table
    int* o_n_rows;
    int* o_settled_len;
    int* o_col[N_STAGED];
    int* o_rem_clients;
    int* o_props;
    // records: [D, W, 5 + KK] (append 0) or the log [D, cap, 5 + KK]
    int* rec;
    int* n_rec;  // [D] (append 0)
    int append, cap, n_epochs, epoch, cursor_stride;
    const int* cursor_in;  // append 1
    int* cursor_out;
    int* counts;  // [D, n_epochs]
};

// This CTA's view of its document: uniform across its threads.
struct Cta {
    int d, rank;
    int lo, n;        // the tile: rows [lo, lo + n) of the document
    long long row0;   // d * W + lo: the tile's first row in the stack
    int live_n, msn;
    int* sm;          // shared memory
    unsigned parity;  // the staging mbarrier's phase
};

__device__ __forceinline__ int* scol(const Cta& c, const Args& a, int k) {
    return c.sm + HEAD + k * a.S;
}

// The staged segment's props, [S, KK].
__device__ __forceinline__ int* sprops(const Cta& c, const Args& a) {
    return c.sm + HEAD + N_COLS * a.S;
}

__device__ __forceinline__ int imin(int x, int y) { return x < y ? x : y; }

__device__ __forceinline__ bool aligned16(const void* p) {
    return ((size_t)p & 15) == 0;
}

// One row's tests under the MSN, from the staged columns.
struct Row {
    bool keep;
    int code;
    unsigned delta;  // ins - exc
};

__device__ __forceinline__ Row test_row(const Cta& c, const Args& a, int s0,
                                        int i) {
    Row r;
    const bool live = c.lo + s0 + i < c.live_n;
    const int b = scol(c, a, C_BUF)[i];
    const int rs = scol(c, a, C_REM_SEQ)[i];
    const int is = scol(c, a, C_INS_SEQ)[i];
    const unsigned ln = (unsigned)scol(c, a, C_LEN)[i];
    const bool is_span = live && b >= SETTLED_BASE;
    const bool removed = live && rs != NOT_REMOVED;
    const bool drop = removed && rs <= c.msn;
    const bool settle_text = live && !removed && !is_span && is <= c.msn;
    const bool settle_span = live && !removed && is_span;
    const bool drop_span = drop && is_span;
    r.keep = live && !(drop || settle_text || settle_span);
    r.delta = (settle_text ? ln : 0u) - (drop_span ? ln : 0u);
    r.code = settle_text ? REC_SETTLE_TEXT
             : drop_span ? REC_DROP_SPAN
             : settle_span ? REC_SETTLE_SPAN : 0;
    return r;
}

// Rows [s0, s0 + m) of the tile's six narrow columns and its props into
// shared memory: seven contiguous slices, each by the bulk-copy engine
// where it can take it, else by 4-byte copies.
__device__ void stage(const Args& a, Cta& c, int s0, int m) {
    fence_proxy_async();
    __syncthreads();  // nobody reads the previous segment any more
    unsigned long long* bar = (unsigned long long*)c.sm;
    const long long off = c.row0 + s0;
    const int* src[N_STAGED + 1];
    int* dst[N_STAGED + 1];
    int n[N_STAGED + 1];
    for (int k = 0; k < N_STAGED; ++k) {
        src[k] = a.col[k] + off;
        dst[k] = scol(c, a, k);
        n[k] = m;
    }
    src[N_STAGED] = a.props + off * a.KK;
    dst[N_STAGED] = sprops(c, a);
    n[N_STAGED] = m * a.KK;
    bool bulk[N_STAGED + 1];
    unsigned tx = 0;
    for (int k = 0; k <= N_STAGED; ++k) {
        bulk[k] = n[k] % 4 == 0 && aligned16(src[k]);
        tx += bulk[k] ? 4u * (unsigned)n[k] : 0u;
    }
    if (threadIdx.x == 0) {
        mbar_arrive_tx(bar, tx);
        for (int k = 0; k <= N_STAGED; ++k)
            if (bulk[k] && n[k])
                bulk_load(dst[k], src[k], 4u * (unsigned)n[k], bar);
    }
    for (int k = 0; k <= N_STAGED; ++k)
        if (!bulk[k])
            for (int i = threadIdx.x; i < n[k]; i += NT)
                cp_async4(dst[k] + i, src[k] + i);
    cp_async_wait_all();
    mbar_wait(bar, c.parity);
    c.parity ^= 1u;
    __syncthreads();
}

// The rows [w0, w1) of warp `warp` in a staged segment of m rows: runs
// of whole 32-row rounds, one run a warp.
__device__ __forceinline__ void warp_rows(int m, int& w0, int& w1) {
    const int per = ((m + WARPS - 1) / WARPS + 31) & ~31;
    const int warp = threadIdx.x >> 5;
    w0 = imin(warp * per, m);
    w1 = imin(w0 + per, m);
}

// A staged segment's scan: every row's new anchor up to its warp's base
// (in C_NEW_ANCHOR), and the thread's warp base and the segment's totals
// of kept rows and delta.
struct Scan {
    int kbase, kseg;
    unsigned dbase, dseg;
};

__device__ Scan scan_segment(const Args& a, const Cta& c, int s0, int m) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int* anchor = scol(c, a, C_ANCHOR);
    int* new_anchor = scol(c, a, C_NEW_ANCHOR);
    int w0, w1;
    warp_rows(m, w0, w1);
    int k = 0;
    unsigned dl = 0;
    for (int r0 = w0; r0 < w1; r0 += 32) {
        const int i = r0 + lane;
        const bool valid = i < w1;
        Row r = {false, 0, 0u};
        if (valid) r = test_row(c, a, s0, i);
        const unsigned mask = __ballot_sync(FULL, r.keep);
        unsigned x = r.delta;
        for (int o = 1; o < 32; o <<= 1) {
            const unsigned y = (unsigned)__shfl_up_sync(FULL, (int)x, o);
            if (lane >= o) x += y;
        }
        if (valid)
            new_anchor[i] = (int)((unsigned)anchor[i] + dl + x - r.delta);
        dl += (unsigned)__shfl_sync(FULL, (int)x, 31);
        k += __popc(mask);
    }
    int* wt = c.sm + WT;
    if (lane == 0) {
        wt[warp] = k;
        wt[WARPS + warp] = (int)dl;
    }
    __syncthreads();
    Scan s = {0, 0, 0u, 0u};
    for (int w = 0; w < WARPS; ++w) {
        const int wk = wt[w];
        const unsigned wd = (unsigned)wt[WARPS + w];
        if (w < warp) {
            s.kbase += wk;
            s.dbase += wd;
        }
        s.kseg += wk;
        s.dseg += wd;
    }
    return s;
}

// Copies n rows of q values: dst row p (contiguous) from src row
// perm[p]. Thread t keeps column t % q of rows t / q, t / q + NT / q,
// ... (q <= NT), UNROLL rows loaded before they are stored.
constexpr int UNROLL = 8;
template <class V>
__device__ __forceinline__ void copy_rows_v(V* __restrict__ dst,
                                            const V* __restrict__ src,
                                            const int* perm, int n, int q) {
    if (q > NT) {
        for (int p = 0; p < n; ++p)
            for (int k = threadIdx.x; k < q; k += NT)
                dst[(long long)p * q + k] = src[(long long)perm[p] * q + k];
        return;
    }
    const int step = NT / q, k = threadIdx.x % q, r0 = threadIdx.x / q;
    if (r0 >= step) return;
    for (int p = r0; p < n; p += UNROLL * step) {
        V v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int pp = p + u * step;
            if (pp < n) v[u] = src[(long long)perm[pp] * q + k];
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int pp = p + u * step;
            if (pp < n) dst[(long long)pp * q + k] = v[u];
        }
    }
}

__device__ __forceinline__ void copy_rows(int* dst, const int* src,
                                          const int* perm, int n, int w) {
    if (w == 0 || n == 0) return;
    if ((w & 3) == 0 && aligned16(dst) && aligned16(src))
        copy_rows_v<int4>((int4*)dst, (const int4*)src, perm, n, w >> 2);
    else
        copy_rows_v<int>(dst, src, perm, n, w);
}

// n ints of value v from p, by the whole CTA (16-byte stores between
// the unaligned ends).
__device__ void fill_ints(int* p, long long n, int v) {
    if (n <= 0) return;
    long long head = (long long)((16 - ((size_t)p & 15)) & 15) / 4;
    if (head > n) head = n;
    if (threadIdx.x < head) p[threadIdx.x] = v;
    const long long nv = (n - head) / 4;
    int4* q = (int4*)(p + head);
    const int4 f = {v, v, v, v};
    for (long long e = threadIdx.x; e < nv; e += NT) q[e] = f;
    const long long t0 = head + nv * 4;
    if (threadIdx.x < n - t0) p[t0 + threadIdx.x] = v;
}

// Record column k of the staged segment: its first int and the stride
// of its rows.
__device__ __forceinline__ const int* rec_col(const Args& a, const Cta& c,
                                              int k, int& stride) {
    stride = 1;
    switch (k) {
        case 0: return scol(c, a, C_ANCHOR);
        case 1: return scol(c, a, C_CODE);
        case 2: return scol(c, a, C_BUF);
        case 3: return scol(c, a, C_LEN);
        case 4: return scol(c, a, C_INS_SEQ);
    }
    stride = a.KK;
    return sprops(c, a) + (k - 5);
}

// The segment's records: run position p (its map's entry) goes to record
// row kept0 + p where p < ks (a kept row), else drop0 + p - ks. Thread t
// keeps record column t % RC, so its loads take one address form, and a
// warp's stores are consecutive ints of the run.
__device__ void write_records(const Args& a, const Cta& c, int* rec, int m,
                              int ks, int kept0, int drop0) {
    const int RC = 5 + a.KK;
    const int* perm = scol(c, a, C_PERM);
    if (RC > NT) {
        for (int p = 0; p < m; ++p) {
            const int i = perm[p];
            int* dst = rec + (long long)(p < ks ? kept0 + p : drop0 + p - ks) * RC;
            for (int k = threadIdx.x; k < RC; k += NT) {
                int st;
                const int* col = rec_col(a, c, k, st);
                dst[k] = col[i * st];
            }
        }
        return;
    }
    const int step = NT / RC, k = threadIdx.x % RC, r0 = threadIdx.x / RC;
    if (r0 >= step) return;
    int st;
    const int* col = rec_col(a, c, k, st);
    for (int p = r0; p < m; p += UNROLL * step) {
        int v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int pp = p + u * step;
            if (pp < m) v[u] = col[perm[pp] * st];
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int pp = p + u * step;
            if (pp < m)
                rec[(long long)(pp < ks ? kept0 + pp : drop0 + pp - ks) * RC +
                    k] = v[u];
        }
    }
}

// Pass 2's own part for a staged, scanned segment: each row's keep rank
// (a ballot), so the segment's map (run position -> row: kept rows
// first, then the others), and each row's record code.
__device__ void rank_segment(const Args& a, const Cta& c, int s0, int m,
                             const Scan& sc) {
    const int lane = threadIdx.x & 31;
    int* perm = scol(c, a, C_PERM);
    int* code = scol(c, a, C_CODE);
    int w0, w1;
    warp_rows(m, w0, w1);
    int k = sc.kbase;
    for (int r0 = w0; r0 < w1; r0 += 32) {
        const int i = r0 + lane;
        const bool valid = i < w1;
        Row r = {false, 0, 0u};
        if (valid) r = test_row(c, a, s0, i);
        const unsigned mask = __ballot_sync(FULL, r.keep);
        if (valid) {
            const int kr = k + __popc(mask & ((1u << lane) - 1u));
            perm[r.keep ? kr : sc.kseg + i - kr] = i;
            code[i] = r.code;
        }
        k += __popc(mask);
    }
}

// Each row of the segment takes its new anchor (its warp's base and Db,
// the delta of every row before the segment, added) and, on span rows,
// its new buf; the rows are the ones `rank_segment` gave the thread. Ends
// with a barrier: the segment is ready to write.
__device__ void finalize_segment(const Args& a, const Cta& c, int s0, int m,
                                 const Scan& sc, unsigned Db) {
    const int lane = threadIdx.x & 31;
    int* new_anchor = scol(c, a, C_NEW_ANCHOR);
    int* buf = scol(c, a, C_BUF);
    const unsigned db = Db + sc.dbase;
    int w0, w1;
    warp_rows(m, w0, w1);
    for (int i = w0 + lane; i < w1; i += 32) {
        const int na = (int)((unsigned)new_anchor[i] + db);
        new_anchor[i] = na;
        if (c.lo + s0 + i < c.live_n && buf[i] >= SETTLED_BASE)
            buf[i] = (int)((unsigned)SETTLED_BASE + (unsigned)na);
    }
    __syncthreads();
}

// The writes of a finalized segment: its ks kept rows go to output rows
// [Kb, Kb + ks) and records [W - n_new + Kb, ...), its other rows to
// records [Jb, Jb + m - ks).
__device__ void write_segment(const Args& a, const Cta& c, int* rec, int s0,
                              int m, int ks, int Kb, int Jb, int n_new) {
    const int* perm = scol(c, a, C_PERM);
    const int* new_anchor = scol(c, a, C_NEW_ANCHOR);
    const long long out0 = (long long)c.d * a.W + Kb;
    for (int p = threadIdx.x; p < ks; p += NT) {
        const int i = perm[p];
        a.o_col[C_ANCHOR][out0 + p] = new_anchor[i];
        for (int q = C_BUF; q < N_STAGED; ++q)
            a.o_col[q][out0 + p] = scol(c, a, q)[i];
    }
    copy_rows(a.o_rem_clients + out0 * a.KR,
              a.rem_clients + (c.row0 + s0) * a.KR, perm, ks, a.KR);
    copy_rows(a.o_props + out0 * a.KK, sprops(c, a), perm, ks, a.KK);
    write_records(a, c, rec, m, ks, a.W - n_new + Kb, Jb);
}

__global__ void __launch_bounds__(NT) overlay_fold_kernel(Args a) {
    extern __shared__ __align__(16) int smem[];
    const int W = a.W;
    Cta c;
    c.rank = (int)cluster_rank();
    c.d = blockIdx.x / a.G;
    c.lo = imin(c.rank * a.T, W);
    c.n = imin(c.lo + a.T, W) - c.lo;
    c.row0 = (long long)c.d * W + c.lo;
    const int nr = a.n_rows[c.d];
    c.live_n = nr < 0 ? 0 : (nr > W ? W : nr);
    c.msn = a.msn ? a.msn[(long long)c.d * a.msn_stride] : a.msn_value;
    c.sm = smem;
    c.parity = 0u;
    if (threadIdx.x == 0) mbar_init((unsigned long long*)smem, 1);

    // Pass 1: the tile's kept rows and delta, segment by segment.
    const int nseg = (c.n + a.S - 1) / a.S;
    Scan sc = {0, 0, 0u, 0u};
    int kt = 0;
    unsigned dt = 0;
    for (int s = 0; s < nseg; ++s) {
        const int s0 = s * a.S, m = imin(a.S, c.n - s0);
        stage(a, c, s0, m);
        sc = scan_segment(a, c, s0, m);
        kt += sc.kseg;
        dt += sc.dseg;
    }

    // The cluster's exchange of the tiles' totals. Pass 2's own part (the
    // map and the codes) needs none of it, so a tile of one segment ranks
    // its rows between the barrier's arrival and its wait.
    if (threadIdx.x == 0) {
        smem[PUB] = kt;
        smem[PUB + 1] = (int)dt;
    }
    cluster_arrive();
    if (nseg == 1) rank_segment(a, c, 0, c.n, sc);
    cluster_wait();
    int Kc = 0, n_new = 0;
    unsigned Dc = 0, Dtot = 0;
    for (int r = 0; r < a.G; ++r) {
        const int kr = r == c.rank ? kt : dsmem_load(smem + PUB, r);
        const unsigned dr =
            r == c.rank ? dt : (unsigned)dsmem_load(smem + PUB + 1, r);
        if (r < c.rank) {
            Kc += kr;
            Dc += dr;
        }
        n_new += kr;
        Dtot += dr;
    }
    cluster_arrive();  // this CTA has read the other ranks' totals

    // The record block of this document.
    const int RC = 5 + a.KK;
    int* rec;
    int cursor = 0;
    if (a.append) {
        cursor = a.cursor_in[(long long)c.d * a.cursor_stride];
        int start = cursor;
        if (start > a.cap - W) start = a.cap - W;
        if (start < 0) start = 0;
        rec = a.rec + ((long long)c.d * a.cap + start) * RC;
    } else {
        rec = a.rec + (long long)c.d * W * RC;
    }

    // Pass 2: rank (when the tile has more than one segment, staged and
    // scanned again), finalize and write each segment.
    int Kb = Kc, Jb = c.lo - Kc;
    unsigned Db = Dc;
    for (int s = 0; s < nseg; ++s) {
        const int s0 = s * a.S, m = imin(a.S, c.n - s0);
        if (nseg > 1) {
            stage(a, c, s0, m);
            sc = scan_segment(a, c, s0, m);
            rank_segment(a, c, s0, m, sc);
        }
        finalize_segment(a, c, s0, m, sc, Db);
        write_segment(a, c, rec, s0, m, sc.kseg, Kb, Jb, n_new);
        Kb += sc.kseg;
        Jb += m - sc.kseg;
        Db += sc.dseg;
    }

    // This rank's share of the fill rows [n_new, W).
    const int nf = W - n_new, per = (nf + a.G - 1) / a.G;
    const int f0 = n_new + imin(c.rank * per, nf);
    const int nfc = n_new + imin((c.rank + 1) * per, nf) - f0;
    const long long fr = (long long)c.d * W + f0;
    for (int e = threadIdx.x; e < nfc; e += NT) {
        a.o_col[C_ANCHOR][fr + e] = 0;
        a.o_col[C_BUF][fr + e] = 0;
        a.o_col[C_LEN][fr + e] = 0;
        a.o_col[C_INS_SEQ][fr + e] = 0;
        a.o_col[C_INS_CLIENT][fr + e] = NO_CLIENT;
        a.o_col[C_REM_SEQ][fr + e] = NOT_REMOVED;
    }
    fill_ints(a.o_rem_clients + fr * a.KR, (long long)nfc * a.KR, NO_CLIENT);
    fill_ints(a.o_props + fr * a.KK, (long long)nfc * a.KK, PROP_ABSENT);

    if (c.rank == 0 && threadIdx.x == 0) {
        const int n_rec = c.live_n - n_new;
        a.o_n_rows[c.d] = n_new;
        a.o_settled_len[c.d] = (int)((unsigned)a.settled_len[c.d] + Dtot);
        if (a.append) {
            a.counts[(long long)c.d * a.n_epochs + a.epoch] = n_rec;
            a.cursor_out[c.d] = (int)((unsigned)cursor + (unsigned)n_rec);
        } else {
            a.n_rec[c.d] = n_rec;
        }
    }
    cluster_wait();  // the other ranks are done with this CTA's totals
}

// The same grid, clusters and shared memory with no work: the launch
// floor that `overlay_fold_empty_launch` times.
__global__ void __launch_bounds__(NT) overlay_fold_empty_kernel(Args) {}

// The launch geometry of (n_docs, W, KK, G, S) into `a`; the dynamic
// shared memory in bytes, or -1 where the arguments are out of range.
int geometry(Args& a, int n_docs, int W, int KK, int G, int S) {
    if (n_docs < 1 || W < 1 || KK < 0 || G < 1 || G > MAX_CLUSTER ||
        (G & (G - 1)) || S < 4 || S % 4 != 0 || S > MAX_SEGMENT ||
        smem_bytes(S, KK) > MAX_SMEM || (long long)n_docs * G > 2147483647LL)
        return -1;
    a.W = W;
    a.KK = KK;
    a.G = G;
    a.T = ((W + G - 1) / G + 3) & ~3;
    a.S = S < a.T ? S : a.T;
    return (int)smem_bytes(a.S, KK);
}

int launch(void (*kernel)(Args), const Args& a, int n_docs, int smem,
           cudaStream_t stream) {
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            smem);
        if (e != cudaSuccess) return (int)e;
    }
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)a.G;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(n_docs * a.G));
    cfg.blockDim = dim3(NT);
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
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
// [n_docs, n_epochs] (nulls without it): 26 pointers. `G` is the
// cluster size (1, 2, 4 or 8), `S` the rows a CTA stages at once (a
// multiple of 4 up to 4096, with its S (33 + 4 KK) bytes of shared
// memory within an sm_90 block's 227 KB). Launches n_docs clusters of G CTAs on
// `stream` and returns the launch's CUDA error (0 when it was
// accepted).
extern "C" int overlay_fold_launch(int device, int n_docs, int W, int KR,
                                   int KK, int G, int S, int msn_value,
                                   int msn_stride, int append, int cap,
                                   int n_epochs, int epoch, int cursor_stride,
                                   int n_ptrs, void** ptrs, void* stream) {
    Args a;
    const int smem = geometry(a, n_docs, W, KK, G, S);
    if (smem < 0 || n_ptrs != N_PTRS || KR < 0 ||
        (msn_stride != 0 && msn_stride != 1) ||
        (append && (cap < W || epoch < 0 || epoch >= n_epochs ||
                    (cursor_stride != 0 && cursor_stride != 1))))
        return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    a.KR = KR;
    int k = 0;
    a.n_rows = (const int*)ptrs[k++];
    a.settled_len = (const int*)ptrs[k++];
    for (int q = 0; q < N_STAGED; ++q) a.col[q] = (const int*)ptrs[k++];
    a.rem_clients = (const int*)ptrs[k++];
    a.props = (const int*)ptrs[k++];
    a.msn = (const int*)ptrs[k++];
    a.msn_value = msn_value;
    a.msn_stride = msn_stride;
    a.o_n_rows = (int*)ptrs[k++];
    a.o_settled_len = (int*)ptrs[k++];
    for (int q = 0; q < N_STAGED; ++q) a.o_col[q] = (int*)ptrs[k++];
    a.o_rem_clients = (int*)ptrs[k++];
    a.o_props = (int*)ptrs[k++];
    a.rec = (int*)ptrs[k++];
    a.n_rec = (int*)ptrs[k++];
    a.cursor_in = (const int*)ptrs[k++];
    a.cursor_out = (int*)ptrs[k++];
    a.counts = (int*)ptrs[k++];
    a.append = append;
    a.cap = cap;
    a.n_epochs = n_epochs;
    a.epoch = epoch;
    a.cursor_stride = cursor_stride;
    return launch(overlay_fold_kernel, a, n_docs, smem, (cudaStream_t)stream);
}

// An empty kernel launched as `overlay_fold_launch` would launch the
// fold of (n_docs, W, KK, G, S): the same grid, clusters and dynamic
// shared memory; it takes no pointers (n_ptrs 0). Returns the launch's
// CUDA error.
extern "C" int overlay_fold_empty_launch(int device, int n_docs, int W,
                                         int KK, int G, int S, int n_ptrs,
                                         void**, void* stream) {
    Args a = {};
    const int smem = geometry(a, n_docs, W, KK, G, S);
    if (smem < 0 || n_ptrs != 0) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    return launch(overlay_fold_empty_kernel, a, n_docs, smem,
                  (cudaStream_t)stream);
}
