// Row-model compactions for Hopper (sm_90a): the zamboni and the chunk
// path's full compaction, one device-wide, stable, multi-column
// compaction of a segment table in two launches (the zamboni) or three
// (the compaction, with its text gather), with no host sync.
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
//   the scatter order, and the gather only stays in bounds.
//
// Design: reduce, then scan. The table is cut into G tiles of TILE =
// 512 rows, one block of NT = 256 threads a tile (2 consecutive rows a
// thread). A run's start depends on the previous kept row, which may lie
// in any earlier tile, so run starts are counted only after kept rows
// are placed, in this order:
//
//   1. zb_tiles (G blocks): each tile tests its rows' keep flags, counts
//      its kept rows, sums their lengths, and tests the start flag of
//      each kept row but its first against the kept row before it in
//      the tile. Its first kept row's flag needs the previous kept row:
//      the tile reads the keep flags of the tile before it too, so the
//      flag is decided here whenever that tile keeps a row (else it is
//      left pending, -1). It publishes these aggregates, the local
//      length prefix of its last start, and its keep and start flags as
//      ballot words (two a warp each);
//   2. zb_rows (G blocks): each tile scans the aggregates of every tile
//      itself (no launch is spent on them): kept-row, length and run
//      offsets, m and the total, resolving a pending first-row flag
//      against the last kept row of the tiles before (the scan's max)
//      and taking the new offset of the last start before it. From its
//      flag words and lengths, each start row writes its run's output
//      row and the length of the run before it (the last start also
//      its own); the wide columns of a tile's runs go out as one
//      contiguous range, element by element; each tile fills its rows
//      at and above m with 16-byte stores. The compaction also writes
//      each kept row's new offset and buf_start in packed order, and for
//      each arena tile of GT elements the kept row that owns its first
//      element;
//   3. zb_gather (the compaction only, ceil(A / GT) blocks): a block
//      stages the kept rows that own its GT elements (from the tile map,
//      no search), marks where each starts, and a block max-scan gives
//      every element its row; each element then reads its text (or 0).
//
// The zamboni is launches 1-2, the compaction 1-3. Launches 2 and 3 are
// programmatic dependent launches: their blocks start while the launch
// before still runs, load what depends only on the call's inputs, and
// wait for it (`wait_for_prior_launch`) before they read its scratch,
// which hides the gap between launches. Beyond that wait, the launches'
// order on the stream is the only synchronisation: no grid barrier, no
// atomics, and every output int is written by one thread. Scratch
// (allocated by the wrapper, reused per capacity): NA + 32 ints a tile;
// for the compaction also two ints a row (new offsets and buf_start of
// the kept rows), two totals and one int an arena tile.
//
// What bounds it on this card: bytes, at 3.35 TB/s. The function must
// read rem_seq of every live row (the keep test), buf_start, length,
// ins_seq and the KK props of the kept rows (the merge test, the text
// offsets) and ins_client and the KR removers of the run firsts alone,
// and write all C rows of 5 + KR + KK int32 columns once; the
// compaction also reads the text it moves and writes the A-element
// arena. At C 131072, KR 24, KK 8 the table's writes alone are 19.4 MB,
// about 5.8 us: most of the bound, so the fills use 16-byte stores and
// every other step is kept to a few dependent loads. Launch 1 reads the
// previous tile's rem_seq again and launch 2 the G tile aggregates; the
// wide rem_clients columns move once, as in the plain version's gather
// of run firsts.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;          // threads a block
constexpr int RPT = 2;           // rows a thread
constexpr int TILE = NT * RPT;   // rows a tile
constexpr int WARPS = NT / 32;
constexpr int WORDS = WARPS * RPT;  // flag words a tile, of each kind
constexpr int GT = 2048;         // arena elements a gather block
constexpr int EPT = GT / NT;     // arena elements a gather thread
constexpr unsigned FULL = 0xffffffffu;
constexpr int NOT_REMOVED = 2147483647;
constexpr int NO_CLIENT = -3;
constexpr int PROP_ABSENT = -1;
constexpr int STREAM_BASE = 1 << 28;
constexpr int N_PTRS_ZAMBONI = 20;
constexpr int N_PTRS_COMPACTION = 23;

// A tile's aggregate (written by launch 1): field f of tile j is
// agg[f * G + j], so that launch 2 reads each field of every tile in one
// coalesced sweep. Then each tile's 2 WORDS flag words, at
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
constexpr int TILE_INTS = NA + 2 * WORDS;  // scratch ints a tile

// Shared memory (ints): scan scratch, the tile values of launch 2,
// then launch 2's per-thread prefixes and run-first list, or a gather
// block's element rows and staged kept rows.
constexpr int MAXF = 8;                        // fields a scan
constexpr int SH_SCAN = 0;                     // WARPS * MAXF
constexpr int SH_AT = SH_SCAN + WARPS * MAXF;  // MAXF
constexpr int SH_REST = SH_AT + MAXF;
constexpr int SH_LSG = SH_REST;                // NT
constexpr int SH_PRE = SH_LSG + NT;            // NT
constexpr int SH_LIST = SH_PRE + NT;           // TILE
constexpr int SH_OWNER = SH_REST;              // GT
constexpr int SH_OFF = SH_OWNER + GT;          // GT
constexpr int SH_BUF = SH_OFF + GT;            // GT
constexpr int SMEM_ROWS = SH_LIST + TILE;
constexpr int SMEM_GATHER = SH_BUF + GT;

struct Args {
    int C, KR, KK, G;
    int gather;          // 1: compact_gather_text, 0: zamboni
    int A, S, GA;        // arena and stream text lengths, arena tiles
    int msn_value;       // the MSN, where msn_ptr is null
    const int* msn_ptr;
    const int* n_rows_in;
    const int* err_in;
    const int* col[5];   // buf_start, length, ins_seq, ins_client, rem_seq
    const int* rcl;      // [C, KR]
    const int* props;    // [C, KK]
    const int* doc;      // [A]   (gather)
    const int* stream;   // [S]   (gather)
    int* out[5];
    int* rcl_out;
    int* props_out;
    int* n_rows_out;
    int* err_out;
    int* arena_out;      // [A]   (gather)
    int* agg;            // [NA * G] tile aggregates
    int* words;          // [G * 2 WORDS] keep and start flag words
    int* off;            // [C] new offset of kept row d (gather)
    int* sbuf;           // [C] buf_start of kept row d (gather)
    int* tot;            // [2] kept rows, total length (gather)
    int* tmap;           // [GA] kept row owning each arena tile's first
};

__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
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

// Launches 2 and 3 are programmatic dependent launches: their blocks
// may start once every block of the launch before has begun, read only
// inputs of the call until `wait_for_prior_launch` returns (that launch
// done, its writes visible), and so hide the gap between launches.
__device__ __forceinline__ void launch_dependents() {
    asm volatile("griddepcontrol.launch_dependents;");
}
__device__ __forceinline__ void wait_for_prior_launch() {
    asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ int msn_of(const Args& a) {
    return a.msn_ptr ? *a.msn_ptr : a.msn_value;
}

__device__ __forceinline__ bool keeps(int rem_seq, int msn) {
    return !(rem_seq != NOT_REMOVED && rem_seq <= msn);
}

// The merge test's narrow fields of a row.
struct Key {
    int rs, is, buf, len;  // rem_seq, ins_seq, buf_start, length
};

__device__ __forceinline__ Key key_of(const Args& a, int i) {
    return Key{a.col[4][i], a.col[2][i], a.col[0][i], a.col[1][i]};
}

// Kept row s merges into the kept row p before it (see the header),
// given both rows' narrow fields: one round trip to memory, for the
// props, where the narrow fields allow a merge.
__device__ bool merges(const Args& a, int p, const Key& kp, int s,
                       const Key& ks, int msn) {
    const bool m = ks.rs == NOT_REMOVED && kp.rs == NOT_REMOVED &&
                   ks.is <= msn && kp.is <= msn &&
                   (a.gather || (unsigned)kp.buf + (unsigned)kp.len ==
                                    (unsigned)ks.buf);
    if (!m) return false;
    const int* ps = a.props + (long long)s * a.KK;
    const int* pp = a.props + (long long)p * a.KK;
    int diff = 0;
    if ((a.KK & 3) == 0 && aligned16(a.props)) {
        // rows of 16-byte words
        const int4* qs = reinterpret_cast<const int4*>(ps);
        const int4* qp = reinterpret_cast<const int4*>(pp);
#pragma unroll 2
        for (int k = 0; k < a.KK / 4; ++k) {
            const int4 x = qs[k], y = qp[k];
            diff |= (x.x ^ y.x) | (x.y ^ y.y) | (x.z ^ y.z) | (x.w ^ y.w);
        }
    } else {
#pragma unroll 4
        for (int k = 0; k < a.KK; ++k) diff |= ps[k] ^ pp[k];
    }
    return diff == 0;
}

// Every int of p[lo, hi) set to v: 16-byte stores on the aligned middle.
__device__ void fill_range(int* p, long long lo, long long hi, int v) {
    if (lo >= hi) return;
    const long long a4 = (lo + 3) & ~3LL, b4 = hi & ~3LL;
    const long long head = a4 < hi ? a4 : hi;
    for (long long e = lo + threadIdx.x; e < head; e += NT) p[e] = v;
    for (long long e = (a4 > b4 ? a4 : b4) + threadIdx.x; e < hi; e += NT)
        p[e] = v;
    int4 v4;
    v4.x = v4.y = v4.z = v4.w = v;
    int4* q = reinterpret_cast<int4*>(p);
    for (long long e = a4 / 4 + threadIdx.x; e < b4 / 4; e += NT) q[e] = v4;
}

// Rows list[0 .. ns) of the two wide columns (w1 and w2 units a row) to
// rows r0 .. r0 + ns of their outputs, in one pass: element by element
// (neighbouring threads on neighbouring units), U loads in flight a
// thread.
template <class T>
__device__ void copy_rows(const T* in1, T* out1, int w1, const T* in2,
                          T* out2, int w2, int r0, int ns, const int* list) {
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
                v[u] = in1[(long long)list[q] * w1 + (e - q * w1)];
            } else if (e < n_el) {
                const int f = e - n1, q = f / w2;
                v[u] = in2[(long long)list[q] * w2 + (f - q * w2)];
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

// The removers and props of the tile's runs: in 16-byte words where the
// rows of both are whole words, else in ints.
__device__ void copy_runs(const Args& a, int r0, int ns, const int* list) {
    if (ns == 0) return;
    if ((a.KR & 3) == 0 && (a.KK & 3) == 0 && aligned16(a.rcl) &&
        aligned16(a.props) && aligned16(a.rcl_out) && aligned16(a.props_out))
        copy_rows(reinterpret_cast<const int4*>(a.rcl),
                  reinterpret_cast<int4*>(a.rcl_out), a.KR / 4,
                  reinterpret_cast<const int4*>(a.props),
                  reinterpret_cast<int4*>(a.props_out), a.KK / 4, r0, ns,
                  list);
    else
        copy_rows(a.rcl, a.rcl_out, a.KR, a.props, a.props_out, a.KK, r0, ns,
                  list);
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

// Launch 2's scan of every tile's aggregate: the values before tile t
// and the totals, into smem[SH_AT ..]: kept-row offset, length offset,
// run offset, the first kept row's start flag, the new offset of the
// last start before the tile; n_keep, the total length, m.
enum { AT_KEEP, AT_LEN, AT_START, AT_FSTART, AT_PREVPRE, AT_NKEEP, AT_TOTAL,
       AT_M };

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
            smem[SH_AT + AT_KEEP] = ca[0] + xa[0];
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
        smem[SH_AT + AT_NKEEP] = ca[0];
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
    // The inputs first, while launch 1 may still run: the rows' length,
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
    const int keep0 = smem[SH_AT + AT_KEEP];
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
    int d = keep0 + x[0];  // packed index of this thread's next kept row
    int li = x[2];         // the tile's index of this thread's next start
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
        if (!k[j]) continue;
        const int i = row0 + j;
        if (a.gather) {
            a.off[d] = (int)pre[j];
            a.sbuf[d] = fc[j][0];
            const long long o = (int)pre[j], e = o + ln[j];
            if (o >= 0 && ln[j] > 0) {  // the arena tiles whose first it owns
                const long long last = (e - 1) / GT < a.GA ? (e - 1) / GT
                                                           : a.GA - 1;
                for (long long b = (o + GT - 1) / GT; b <= last; ++b)
                    a.tmap[b] = d;
            }
        }
        ++d;
        if (!s[j]) continue;
        const int r = r0 + li;
        a.out[0][r] = a.gather ? (int)pre[j] : fc[j][0];
        a.out[2][r] = fc[j][1];
        a.out[3][r] = fc[j][2];
        a.out[4][r] = fc[j][3];
        if (r > 0) a.out[1][r - 1] = (int)(pre[j] - prev_pre);
        if (r == m - 1) a.out[1][r] = (int)(total - pre[j]);
        smem[SH_LIST + li] = i;
        prev_pre = pre[j];
        ++li;
    }
    __syncthreads();
    // The wide columns of the tile's runs: one contiguous output range.
    const int ns = tot[2];
    copy_runs(a, r0, ns, smem + SH_LIST);
    // The tile's output rows at and above m take the fills.
    fill_rows(a, imax(m, tile0), imin(a.C, tile0 + TILE));
    if (t == 0 && threadIdx.x == 0) {
        *a.n_rows_out = m;
        *a.err_out = *a.err_in;
        if (a.gather) {
            a.tot[0] = smem[SH_AT + AT_NKEEP];
            a.tot[1] = (int)total;
        }
    }
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

__global__ void zb_gather(Args a) {
    extern __shared__ __align__(16) int smem[];
    wait_for_prior_launch();
    const int b = blockIdx.x;
    const int e0 = b * GT, e1 = imin(a.A, e0 + GT);
    const int nk = a.tot[0], total = a.tot[1];
    if (nk <= 0 || e0 >= total) {  // past the text: zeros
        fill_range(a.arena_out, e0, e1, 0);
        return;
    }
    // The kept rows that own this tile's elements: the owner of its first
    // element to the owner of the next tile's first (or the last row).
    const int klo = imin(imax(a.tmap[b], 0), nk - 1);
    int khi = e1 < total && b + 1 < a.GA ? a.tmap[b + 1] : nk - 1;
    khi = imin(imax(khi, klo), nk - 1);
    const int cnt = khi - klo + 1;
    int* owner = smem + SH_OWNER;
    for (int p = threadIdx.x; p < GT; p += NT) owner[p] = -1;
    __syncthreads();
    for (int q = threadIdx.x; q < cnt; q += NT) {
        const int o = a.off[klo + q];
        const int nx = klo + q + 1 < nk ? a.off[klo + q + 1] : total;
        const int bb = a.sbuf[klo + q];
        if (q < GT) {
            smem[SH_OFF + q] = o;
            smem[SH_BUF + q] = bb;
        }
        if (nx > o && o > e0 && o < e1) owner[o - e0] = q;  // where it starts
    }
    if (threadIdx.x == 0) owner[0] = 0;
    __syncthreads();
    // Each element's row: the last start at or before it (a max-scan).
    int loc[EPT], run = -1;
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
        run = imax(run, owner[threadIdx.x * EPT + i]);
        loc[i] = run;
    }
    int x[1] = {run}, tot[1];
    block_exscan<1u, 1>(x, tot, smem);
#pragma unroll
    for (int i = 0; i < EPT; ++i)
        owner[threadIdx.x * EPT + i] = imax(x[0], loc[i]);
    __syncthreads();
    int v[EPT];
#pragma unroll
    for (int j = 0; j < EPT; ++j) {
        const int e = e0 + j * NT + (int)threadIdx.x;
        v[j] = 0;
        if (e < e1 && e < total) {
            const int q = owner[j * NT + threadIdx.x];
            const int o = q < GT ? smem[SH_OFF + q] : a.off[klo + q];
            const int bb = q < GT ? smem[SH_BUF + q] : a.sbuf[klo + q];
            v[j] = fetch(a, bb, (long long)e - o);
        }
    }
#pragma unroll
    for (int j = 0; j < EPT; ++j) {
        const int e = e0 + j * NT + (int)threadIdx.x;
        if (e < e1) a.arena_out[e] = v[j];
    }
}

// One launch of NT threads a block; `dependent`: a programmatic
// dependent launch (see `wait_for_prior_launch`).
int launch(void (*kernel)(Args), int grid, size_t smem, cudaStream_t s,
           const Args& a, bool dependent) {
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

int launch_all(const Args& a, cudaStream_t s) {
    int e = launch(zb_tiles, a.G, sizeof(int) * SH_REST, s, a, false);
    if (e) return e;
    e = launch(zb_rows, a.G, sizeof(int) * SMEM_ROWS, s, a, true);
    if (e || !a.gather || a.GA == 0) return e;
    return launch(zb_gather, a.GA, sizeof(int) * SMEM_GATHER, s, a, true);
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
    a.gather = 0;
    a.msn_value = msn;
    table_args(a, ptrs);
    a.agg = (int*)ptrs[19];
    a.words = a.agg + (long long)NA * G;
    return launch_all(a, (cudaStream_t)stream);
}

// ptrs: the 19 table pointers (`table_args`); the int32 scratch of
// TILE_INTS G + 2 C + 2 + ceil(A / GT) ints; doc_arena [A], stream_text
// [S]; the new arena [A] (23 pointers).
extern "C" int compaction_launch(int device, int C, int KR, int KK, int G,
                                 int A, int S, int msn, int n_ptrs,
                                 void** ptrs, void* stream) {
    if (n_ptrs != N_PTRS_COMPACTION || bad_shape(C, KR, KK, G) || A < 0 ||
        S < 0)
        return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    Args a = {};
    a.C = C;
    a.KR = KR;
    a.KK = KK;
    a.G = G;
    a.gather = 1;
    a.A = A;
    a.S = S;
    a.GA = (A + GT - 1) / GT;
    a.msn_value = msn;
    table_args(a, ptrs);
    int* scratch = (int*)ptrs[19];
    a.agg = scratch;
    a.words = a.agg + (long long)NA * G;
    a.off = scratch + (long long)TILE_INTS * G;
    a.sbuf = a.off + C;
    a.tot = a.sbuf + C;
    a.tmap = a.tot + 2;
    a.doc = (const int*)ptrs[20];
    a.stream = (const int*)ptrs[21];
    a.arena_out = (int*)ptrs[22];
    return launch_all(a, (cudaStream_t)stream);
}
