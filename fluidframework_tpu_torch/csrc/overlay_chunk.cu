// Overlay merge-tree chunk kernel for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_overlay_chunk_kernel`
// (fluidframework_tpu/ops/overlay_pallas.py:118, called through
// `overlay_apply_chunk`). It applies a chunk of B sequenced
// insert/remove/annotate ops, one after another, to the overlay table
// of unsettled rows, with exactly the semantics of
// `ops/overlay_ref.OverlayDoc.apply`; its plain PyTorch version is
// `ops/overlay.overlay_apply_chunk_ref`, which it must equal on
// n_rows, error and rows [:n_rows] bit for bit.
//
// Design. One document's ops are serial, so one persistent thread block
// of NT = 1024 threads owns one document on one SM and loops over the
// chunk's ops; the op scalars are block-uniform, so each `pl.when` of
// the Pallas kernel is a block-uniform branch. Many documents are many
// blocks of one launch (blockIdx.x is the document), so a stack of 132
// documents fills the card's 132 SMs. The window W is any multiple of
// NT. The rows are cut into segments of NT*R rows; in each segment,
// thread t owns the R contiguous rows [t*R, t*R+R).
//
// - Hot columns: anchor, buf, len, ins_seq, ins_client, rem_seq, the
//   pre/vis scratch of the perspective pass, and `slot`: 9 x W int32.
//   Where they live is the kernel's one template choice, made by
//   `plan` in the launcher and nowhere else:
//   * the shared layout (W = NT*R, R <= 6, one segment): the hot columns
//     and the chunk's ops in shared memory, when their
//     4 * (9W + 285 + B * (8 + 2PK)) bytes fit the block's opt-in limit
//     (W 2048 at chunks of 256 x 1: 85,108 bytes);
//   * the global layout (any W, R = 1, W/NT segments): the hot columns in
//     a per-document scratch [9, W] in device memory (288 KiB at W 8192,
//     held in L2), the ops read from device memory. Segments wholly
//     above the live rows are skipped by the per-op passes, so the cost
//     per op follows the live rows, not W.
// - Cold columns behind the slot. The Pallas table also holds KR
//   remover slots and KK props per row (128 bytes a row at the bench
//   geometry), too many for the SM. They live in a heap of W rows of
//   KRP = KR + KK rounded up to 4 ints in global memory, whose rows never
//   move: row j's cold data is heap[slot[j]]. The kernel fills the heap
//   from the input's live rows (the input is never written) and at the
//   end gathers it back in row order for rows < n_rows.
// - A shift moves the 9 hot words of a row and nothing of the heap. The
//   split insert's two rolls, and a range op's two rolls, are one shift
//   in which row j takes row j - k, k in {0, 1, 2}, from the composed
//   map. Segment by segment from the top, each thread loads its rows'
//   sources into registers, one barrier, and stores: a segment's sources
//   lie in it or in the two rows below it, which no store above has
//   touched. The slots stay a permutation of the W heap rows: the rows a
//   shift pushes off the top free exactly as many slots as the rows it
//   duplicates (the split tails, the new row), and each duplicate takes
//   one of them, with a 16-byte-wide copy of its source's heap row
//   unless it is a new row that is filled anyway. So the heap never runs
//   out, whatever the chunk (rows falling off at W - 1 included).
// - The perspective pass's prefix sum (an f32 MXU matmul in Pallas) is
//   a block-wide int32 exclusive scan per segment (warp shuffles plus
//   per-warp totals in shared memory), carried from segment to segment.
//   `first_idx` is a block min-reduction. Reductions alternate two
//   shared buffers, so each costs one barrier. The remover slots of a
//   removed row (visibility, first free slot) are read with 16-byte
//   loads and no early exit.
// - Gap materialization stays stepwise, as in Pallas: the count is
//   taken once, each step finds the first gap of the shifted table and
//   reads its bounds through the Pallas staging's clamped tile index.
// - One-row fixups (split heads and tails, the new row) are done by
//   thread 0 between barriers; writes to rows >= W are dropped, as the
//   one-hot writes of the Pallas kernel are, and the ERR_* flags are
//   raised the same way.
//
// What bounds it: the serial chain of block barriers per op on one SM
// (~6 for an insert, more for a range op with gaps; one scan more per
// live segment in the global layout) and the L2 round trips of the
// removed rows' remover slots and, in the global layout, of the hot
// columns; not the card's bandwidth or arithmetic (PERF.md works the
// bound out).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int NT = 1024;       // threads per block
constexpr int NHOT = 9;        // hot columns
constexpr int OPC = 8;         // op columns
constexpr int LANES = 128;
constexpr int R_SHARED_MAX = 6;  // 9 x 6144 ints is the most that fits
constexpr int NOT_REMOVED = 2147483647;
constexpr int NO_CLIENT = -3;
constexpr int PROP_ABSENT = -1;
constexpr int PROP_DELETE = -2;
constexpr int OP_INSERT = 0;
constexpr int OP_REMOVE = 1;
constexpr int OP_ANNOTATE = 2;
constexpr int ERR_CAPACITY = 1;
constexpr int ERR_BAD_POS = 2;
constexpr int ERR_REMOVERS = 4;
constexpr int SETTLED_BASE = 1 << 30;
constexpr unsigned FULL = 0xffffffffu;
constexpr int N_PTRS = 33;

enum { A_ = 0, B_, L_, IS_, IC_, RS_, PRE_, VIS_, SL_ };
enum { LAYOUT_SHARED = 0, LAYOUT_GLOBAL = 1 };

struct Args {
    int KR, KK, KRP, B, PK;
    int nseg;               // segments of NT*R rows (1 in the shared layout)
    // inputs: per document
    const int* n_rows_in;   // [D]
    const int* err_in;      // [D]
    const int* settled_len; // [D]
    const int* col_in[6];   // [D, W] anchor, buf, len, ins_seq, ins_client, rem_seq
    const int* rcl_in;      // [D, W, KR]
    const int* props_in;    // [D, W, KK]
    const int* op[OPC];     // [D, B] type, pos1, pos2, seq, ref_seq, client, buf, len
    const int* prop_keys;   // [D, B, PK]
    const int* prop_vals;   // [D, B, PK]
    // outputs
    int* col_out[6];        // [D, W]
    int* rcl_out;           // [D, W, KR]
    int* props_out;         // [D, W, KK]
    int* n_rows_out;        // [D]
    int* err_out;           // [D]
    int* heap;              // [D, W, KRP] cold rows behind the slots
    int* hot_scratch;       // [D, NHOT, W] hot columns (global layout only)
};

// The freed slots and the duplicated rows of one shift.
struct Lists {
    int nlost, ndup;
    int lost[4];     // slots of the rows pushed off the top
    int dup_row[4];  // rows that duplicate the row below them
    int dup_src[4];  // the heap row each duplicate copies
};
constexpr int LISTS_INTS = sizeof(Lists) / sizeof(int);
// Shared ints besides the hot columns and the ops: two 128-int
// reduction buffers, the error word and the two shift lists.
constexpr int MISC_INTS = 256 + 1 + 2 * LISTS_INTS;

// One or two composed `roll_from`s: rows j in [lo2, lim2) take j - 1,
// then rows in [lo1, lim1) of that take j - 1 (a range is empty when
// lo >= lim, and lo >= 1: row 0 never takes a row).
struct Shift {
    int lo1, lim1, lo2, lim2;
};

__device__ __forceinline__ Shift roll(int thr, int lim) {
    Shift s;
    s.lo1 = max(thr, 1);
    s.lim1 = lim;
    if (s.lo1 >= s.lim1) s.lo1 = s.lim1 = 0;
    s.lo2 = s.lim2 = 0;
    return s;
}

__device__ __forceinline__ Shift then_roll(Shift s, int thr, int lim) {
    s.lo2 = max(thr, 1);
    s.lim2 = lim;
    if (s.lo2 >= s.lim2) s.lo2 = s.lim2 = 0;
    return s;
}

// The row that row j takes after the shift: j, j - 1 or j - 2.
__device__ __forceinline__ int shift_src(const Shift& s, int j) {
    const int r = (j >= s.lo2 && j < s.lim2) ? j - 1 : j;
    return (r >= s.lo1 && r < s.lim1) ? r - 1 : r;
}

__device__ __forceinline__ int warp_incl_scan(int v, int lane) {
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        int u = __shfl_up_sync(FULL, v, o);
        if (lane >= o) v += u;
    }
    return v;
}

// Block-wide exclusive int32 scan of R values per thread (row order =
// thread order). Returns the grand total. One __syncthreads.
template <int R>
__device__ int block_excl_scan(const int (&d)[R], int (&ex)[R], int* buf) {
    constexpr int NW = NT / 32;
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    int s = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) s += d[r];
    int inc = warp_incl_scan(s, lane);
    if (lane == 31) buf[wid] = inc;
    __syncthreads();
    int wt = lane < NW ? buf[lane] : 0;
    int winc = warp_incl_scan(wt, lane);
    int wbase = __shfl_sync(FULL, winc - wt, wid);
    int total = __shfl_sync(FULL, winc, 31);
    int run = wbase + inc - s;
#pragma unroll
    for (int r = 0; r < R; ++r) {
        ex[r] = run;
        run += d[r];
    }
    return total;
}

// Block-wide min of N values per thread; every thread gets the
// results. One __syncthreads.
template <int N>
__device__ void block_min(int (&v)[N], int* buf) {
    constexpr int NW = NT / 32;
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < N; ++k) {
        int m = __reduce_min_sync(FULL, v[k]);
        if (lane == 0) buf[k * 32 + wid] = m;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < N; ++k)
        v[k] = __reduce_min_sync(FULL, lane < NW ? buf[k * 32 + lane] : INT_MAX);
}

__device__ int block_sum(int v, int* buf) {
    constexpr int NW = NT / 32;
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    int s = __reduce_add_sync(FULL, v);
    if (lane == 0) buf[wid] = s;
    __syncthreads();
    return __reduce_add_sync(FULL, lane < NW ? buf[lane] : 0);
}

// Apply `s` to the hot columns (hot[c * W + j], segments of NT*R rows).
// Rows outside [bot, top) do not move. Slot bookkeeping: a row whose
// source equals the source of the row below it is a duplicate; the
// slots of the rows no row takes any more (pushed off the top) are
// freed; each duplicate takes a freed slot (there are as many of each:
// the slots are a permutation before and after) and a copy of its
// source's heap row, unless it is `new_row`, which the caller fills.
// The lists cover the segments from bot's to top's (row `top` frees the
// slot below it) and the top segment's sources are loaded with them;
// then each segment, from the top, stores and the next one down loads
// behind a barrier. Block-uniform arguments; ends with a barrier when
// it moves anything. `par` alternates the two Lists, so that one shift
// zeroes the lists of the next without a barrier of its own.
template <int R, bool GLOBAL>
__device__ void shift_rows(int* hot, int W_, int nseg_, int* heap, int KRP,
                           const Shift& s, int new_row, Lists* ls, int& par) {
    constexpr int SR = NT * R;
    // The shared layout's window is a constant: its addressing folds.
    const int W = GLOBAL ? W_ : SR;
    const int nseg = GLOBAL ? nseg_ : 1;
    const bool e1 = s.lo1 < s.lim1, e2 = s.lo2 < s.lim2;
    if (!e1 && !e2) return;
    const int bot = min(e1 ? s.lo1 : W, e2 ? s.lo2 : W);
    const int top = max(s.lim1, s.lim2);
    // One segment in the shared layout: the loops below fold away.
    const int sg_lo = GLOBAL ? bot / SR : 0;
    const int sg_top = GLOBAL ? (top - 1) / SR : 0;
    const int sg_list = GLOBAL ? min(top / SR, nseg - 1) : 0;
    Lists* L = ls + par;
    Lists* next = ls + (par ^ 1);
    par ^= 1;
    const int* slot = hot + SL_ * W;
    const int tid = threadIdx.x;
    int v[NHOT][R];
    for (int sg = sg_lo; sg <= sg_list; ++sg) {
        const int row0 = sg * SR + tid * R;
        int sp = shift_src(s, row0 - 1);
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int j = row0 + r;
            const int sj = shift_src(s, j);
            if (j >= bot && j < top) {
                if (sg == sg_top) {
#pragma unroll
                    for (int c = 0; c < NHOT; ++c) v[c][r] = hot[c * W + sj];
                }
                if (sj == sp) {
                    const int k = atomicAdd(&L->ndup, 1);
                    L->dup_row[k] = j;
                    L->dup_src[k] = slot[sj];
                }
            }
            if (j > bot && j <= top) {
                for (int q = sp + 1; q < sj; ++q) L->lost[atomicAdd(&L->nlost, 1)] = slot[q];
            }
            sp = sj;
        }
        if (top == W && sg == nseg - 1 && tid == NT - 1) {
            for (int q = sp + 1; q < W; ++q) L->lost[atomicAdd(&L->nlost, 1)] = slot[q];
        }
    }
    __syncthreads();
    if (tid == 0) {
        next->nlost = 0;
        next->ndup = 0;
    }
    const int nd = L->ndup;
    for (int sg = sg_top; sg >= sg_lo; --sg) {
        const int row0 = sg * SR + tid * R;
        if (sg != sg_top) {
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const int j = row0 + r;
                if (j >= bot && j < top) {
                    const int sj = shift_src(s, j);
#pragma unroll
                    for (int c = 0; c < NHOT; ++c) v[c][r] = hot[c * W + sj];
                }
            }
            __syncthreads();
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int j = row0 + r;
            if (j >= bot && j < top) {
#pragma unroll
                for (int c = 0; c < SL_; ++c) hot[c * W + j] = v[c][r];
                int sl = v[SL_][r];
                for (int k = 0; k < nd; ++k)
                    if (L->dup_row[k] == j) sl = L->lost[k];
                hot[SL_ * W + j] = sl;
            }
        }
    }
    const int q4 = KRP / 4;
    if (tid < nd * q4) {
        const int k = tid / q4, q = tid - k * q4;
        if (L->dup_row[k] != new_row) {
            int4* h4 = reinterpret_cast<int4*>(heap);
            h4[(size_t)L->lost[k] * q4 + q] = h4[(size_t)L->dup_src[k] * q4 + q];
        }
    }
    __syncthreads();
}

// The gap before row j (overlay_ref "gap materialization"): settled
// coordinates [lo, hi) the range [c1, c2) covers there.
__device__ __forceinline__ bool gap_at(const int* hot, int W, int j, int nl,
                                       int S, int c1, int c2, int& lo,
                                       int& hi, int& ghi) {
    const bool live = j < nl;
    int glo = 0;
    bool prev_live = true;
    if (j > 0) {
        const int p = j - 1;
        prev_live = p < nl;
        const int cons =
            (prev_live && hot[B_ * W + p] >= SETTLED_BASE) ? hot[L_ * W + p] : 0;
        glo = hot[A_ * W + p] + cons;
    }
    ghi = live ? hot[A_ * W + j] : S;
    lo = max(glo, c1);
    hi = min(ghi, c2);
    return (live || prev_live) && lo < hi;
}

// Heap row of a fresh row (threads < KRP): no removers, the given props
// (`pk`/`pv`, PK of them; none when PK == 0), zero padding.
__device__ __forceinline__ void fill_new_cold(int* row, int KR, int KK,
                                              int KRP, const int* pk,
                                              const int* pv, int PK) {
    const int t = threadIdx.x;
    if (t >= KRP) return;
    int v = 0;
    if (t < KR) {
        v = NO_CLIENT;
    } else if (t < KR + KK) {
        v = PROP_ABSENT;
        for (int p = 0; p < PK; ++p)
            if (pk[p] == t - KR) v = (pv[p] == PROP_DELETE) ? PROP_ABSENT : pv[p];
    }
    row[t] = v;
}

// One block per document. GLOBAL picks the layout (see the top of the
// file): in the shared layout the window is NT*R rows and the ops are
// staged in shared memory; in the global layout R is 1, the window is
// NT * a.nseg rows in the document's hot scratch, and the ops are read
// where they lie.
template <int R, bool GLOBAL>
__global__ void __launch_bounds__(NT, 1) overlay_chunk_kernel(Args a) {
    extern __shared__ __align__(16) int sm[];
    constexpr int SR = NT * R;
    const int nseg = GLOBAL ? a.nseg : 1;
    const int W = SR * nseg;
    const int d = blockIdx.x;
    const int tid = threadIdx.x;
    const int KR = a.KR, KK = a.KK, KRP = a.KRP, B = a.B, PK = a.PK;
    const int KR4 = (KR + 3) / 4;

    int* hot = GLOBAL ? a.hot_scratch + (size_t)d * NHOT * W : sm;  // [NHOT][W]
    int* const A = hot + A_ * W;
    int* const Bf = hot + B_ * W;
    int* const Ln = hot + L_ * W;
    int* const IS = hot + IS_ * W;
    int* const IC = hot + IC_ * W;
    int* const RS = hot + RS_ * W;
    int* const PRE = hot + PRE_ * W;
    int* const VIS = hot + VIS_ * W;
    int* const SL = hot + SL_ * W;
    int* red = GLOBAL ? sm : sm + NHOT * W;  // 2 x 128 reduction buffers
    int* s_err = red + 256;                  // per-row error flags (atomicOr)
    Lists* ls = reinterpret_cast<Lists*>(s_err + 1);
    int* ops = s_err + 1 + 2 * LISTS_INTS;  // shared layout: [OPC][B], keys [B][PK], vals [B][PK]

    int* heap = a.heap + (size_t)d * W * KRP;
    const int* rcl_in = a.rcl_in + (size_t)d * W * KR;
    const int* props_in = a.props_in + (size_t)d * W * KK;
    int* cols[6] = {A, Bf, Ln, IS, IC, RS};

    int nl = a.n_rows_in[d];
    int err = a.err_in[d];
    const int S = a.settled_len[d];
    for (int j = tid; j < W; j += NT) {
#pragma unroll
        for (int c = 0; c < 6; ++c) cols[c][j] = a.col_in[c][(size_t)d * W + j];
        PRE[j] = 0;
        VIS[j] = 0;
        SL[j] = j;
    }
    // Cold rows of the live rows into the heap (row j at heap row j);
    // the rest are scratch until a new row fills them.
    const int n_in = min(max(nl, 0), W);
    for (int e = tid; e < n_in * KRP; e += NT) {
        const int j = e / KRP, k = e - j * KRP;
        int v = 0;
        if (k < KR) v = rcl_in[(size_t)j * KR + k];
        else if (k < KR + KK) v = props_in[(size_t)j * KK + k - KR];
        heap[e] = v;
    }
    if (!GLOBAL) {
        for (int e = tid; e < OPC * B; e += NT) {
            const int c = e / B;
            ops[e] = a.op[c][(size_t)d * B + e - c * B];
        }
        for (int e = tid; e < B * PK; e += NT) {
            ops[OPC * B + e] = a.prop_keys[(size_t)d * B * PK + e];
            ops[OPC * B + B * PK + e] = a.prop_vals[(size_t)d * B * PK + e];
        }
    }
    if (tid == 0) {
        *s_err = 0;
        ls[0].nlost = ls[0].ndup = 0;
        ls[1].nlost = ls[1].ndup = 0;
    }
    int phase = 0, lpar = 0;
    auto rbuf = [&]() {
        int* b = red + phase * 128;
        phase ^= 1;
        return b;
    };
    auto opv = [&](int c, int i) {
        return GLOBAL ? a.op[c][(size_t)d * B + i] : ops[c * B + i];
    };
    __syncthreads();

    for (int i = 0; i < B; ++i) {
        const int otype = opv(0, i);
        if (otype != OP_INSERT && otype != OP_REMOVE && otype != OP_ANNOTATE)
            continue;
        const int pos1 = opv(1, i);
        const int pos2 = opv(2, i);
        const int oseq = opv(3, i);
        const int orefseq = opv(4, i);
        const int oclient = opv(5, i);
        const int obuf = opv(6, i);
        const int oilen = opv(7, i);
        const int* pk = GLOBAL ? a.prop_keys + ((size_t)d * B + i) * PK
                               : ops + OPC * B + i * PK;
        const int* pv = GLOBAL ? a.prop_vals + ((size_t)d * B + i) * PK
                               : pk + B * PK;

        // ---- the perspective pass: visibility at (ref_seq, client)
        // and the exclusive prefix sum of vis - consume, segment by
        // segment up to the live rows' end, with the candidate rows of
        // the op's boundaries (the first of each: a block min after).
        // cand[0]: insert landing / range split at pos1; cand[1]: split
        // at pos2; cand[2], cand[3]: first live row at or past pos1, pos2.
        int cand[4] = {W, W, W, W};
        int carry = 0;
        for (int sg = 0; sg < nseg; ++sg) {
            const int row0 = sg * SR + tid * R;
            if (sg > 0 && sg * SR >= nl) break;  // no live row from here up
            bool skip[R];
            int pre[R], vis[R], dlt[R], ex[R];
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const int j = row0 + r;
                const bool live = j < nl;
                const int rs = RS[j];
                const bool removed = rs != NOT_REMOVED;
                const bool tomb = removed && rs <= orefseq;
                const bool ins_vis = IC[j] == oclient || IS[j] <= orefseq;
                const bool sk = !live || tomb || (removed && !ins_vis);
                bool visible = !sk && ins_vis;
                if (visible && removed) {
                    // Among the removers? Every slot loaded, 16 bytes at a time.
                    const int4* rc =
                        reinterpret_cast<const int4*>(heap + (size_t)SL[j] * KRP);
                    bool among = false;
                    for (int q = 0; q < KR4; ++q) {
                        const int4 x = rc[q];
                        const int k = 4 * q;
                        among |= (x.x == oclient) | ((x.y == oclient) & (k + 1 < KR)) |
                                 ((x.z == oclient) & (k + 2 < KR)) |
                                 ((x.w == oclient) & (k + 3 < KR));
                    }
                    visible = !among;
                }
                const int len = Ln[j];
                vis[r] = visible ? len : 0;
                const int consume = (live && Bf[j] >= SETTLED_BASE) ? len : 0;
                dlt[r] = vis[r] - consume;
                skip[r] = sk;
            }
            const int seg_sum = block_excl_scan<R>(dlt, ex, rbuf());
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const int j = row0 + r;
                pre[r] = A[j] + carry + ex[r];
                PRE[j] = pre[r];
                VIS[j] = vis[r];
            }
            carry += seg_sum;
            // This segment's first candidates (rows descend, so the last
            // assignment is the first row), then the first over segments.
            int c[4] = {W, W, W, W};
            if (otype == OP_INSERT) {
#pragma unroll
                for (int r = R - 1; r >= 0; --r) {
                    const int j = row0 + r;
                    const bool inside = pre[r] < pos1 && pre[r] + vis[r] > pos1;
                    const bool land =
                        j < nl &&
                        (pre[r] > pos1 ||
                         (pre[r] == pos1 && !skip[r] && (vis[r] > 0 || oseq > IS[j])));
                    if (inside || land) c[0] = j;
                }
            } else {
#pragma unroll
                for (int r = R - 1; r >= 0; --r) {
                    const int j = row0 + r;
                    const bool live = j < nl;
                    if (pre[r] < pos1 && pre[r] + vis[r] > pos1) c[0] = j;
                    if (pre[r] < pos2 && pre[r] + vis[r] > pos2) c[1] = j;
                    if (live && pre[r] >= pos1) c[2] = j;
                    if (live && pre[r] >= pos2) c[3] = j;
                }
            }
#pragma unroll
            for (int k = 0; k < 4; ++k) cand[k] = sg == 0 ? c[k] : min(cand[k], c[k]);
        }
        const int dsum = carry;
        const int total = S + dsum;

        if (otype == OP_INSERT) {
            int c1[1] = {cand[0]};
            block_min<1>(c1, rbuf());
            const int j0 = c1[0];
            const int jc = min(j0, W - 1);
            const int preX = PRE[jc], visX = VIS[jc];
            const int ancX = A[jc], bufX = Bf[jc];
            const bool has_split = j0 < W && preX < pos1 && preX + visX > pos1;
            const bool land_dead = j0 >= nl;
            const bool span_s = bufX >= SETTLED_BASE;
            const int off = pos1 - preX;
            int aval;
            if (has_split) aval = ancX + (span_s ? off : 0);
            else if (land_dead) aval = min(pos1 - dsum, S);
            else aval = ancX - (preX - pos1);
            const int t1 = has_split ? j0 + 1 : min(j0, nl);
            const int n_new = has_split ? 2 : 1;
            if (!has_split && land_dead && total < pos1) err |= ERR_BAD_POS;
            if (nl + n_new > W) err |= ERR_CAPACITY;
            __syncthreads();  // every scalar read above precedes any write
            // The split insert's two rolls from t1 as one shift by 2.
            Shift s = roll(t1, min(nl + 1, W));
            if (has_split) s = then_roll(s, t1, min(nl + 2, W));
            shift_rows<R, GLOBAL>(hot, W, nseg, heap, KRP, s, t1, ls, lpar);
            if (tid == 0) {
                if (has_split) {
                    const int hd = t1 - 1;
                    Ln[hd] = off;
                    VIS[hd] = off;
                    const int t = t1 + 1;  // tail: a raw copy of the split row
                    if (t < W) {
                        Bf[t] += off;
                        Ln[t] -= off;
                        if (span_s) A[t] += off;
                        PRE[t] = pos1;
                        VIS[t] -= off;
                    }
                }
                if (t1 < W) {
                    A[t1] = aval;
                    Bf[t1] = obuf;
                    Ln[t1] = oilen;
                    IS[t1] = oseq;
                    IC[t1] = oclient;
                    RS[t1] = NOT_REMOVED;
                    PRE[t1] = pos1;
                    VIS[t1] = oilen;
                }
            }
            // SL[t1] is final: the shift ended with a barrier.
            if (t1 < W) fill_new_cold(heap + (size_t)SL[t1] * KRP, KR, KK, KRP, pk, pv, PK);
            nl += n_new;
            __syncthreads();
            continue;
        }

        // ---- range ops: both boundary splits resolve in pre-split
        // coordinates from the one perspective pass.
        if (total < pos2) err |= ERR_BAD_POS;
        block_min<4>(cand, rbuf());
        const int j1 = cand[0], j2 = cand[1], jc1 = cand[2], jc2 = cand[3];
        const bool has1 = j1 < W, has2 = j2 < W;
        const int k1 = min(j1, W - 1), k2 = min(j2, W - 1);
        const int pre1 = PRE[k1], anc1 = A[k1], buf1 = Bf[k1];
        const int pre2 = PRE[k2], anc2 = A[k2], buf2 = Bf[k2];
        const int off1 = pos1 - pre1, off2 = pos2 - pre2;
        const bool span1 = buf1 >= SETTLED_BASE, span2 = buf2 >= SETTLED_BASE;
        int c1, c2;
        if (has1) c1 = anc1 + (span1 ? off1 : 0);
        else if (jc1 < W) c1 = A[jc1] - (PRE[jc1] - pos1);
        else c1 = pos1 - dsum;
        if (has2) c2 = anc2 + (span2 ? off2 : 0);
        else if (jc2 < W) c2 = A[jc2] - (PRE[jc2] - pos2);
        else c2 = pos2 - dsum;
        const int r1 = has1 ? j1 + 1 : (has2 ? j2 + 1 : W);
        const int nh = (int)has1 + (int)has2;
        if (nl + nh > W) err |= ERR_CAPACITY;
        __syncthreads();
        // The rolls from r1 and from j2 + 2 as one shift.
        Shift s = roll(W, W);
        if (has1 || has2) s = roll(r1, min(nl + 1, W));
        if (has1 && has2) s = then_roll(s, j2 + 2, min(nl + 2, W));
        shift_rows<R, GLOBAL>(hot, W, nseg, heap, KRP, s, -1, ls, lpar);
        if (tid == 0) {
            if (has1) {
                Ln[j1] = off1;
                VIS[j1] = off1;
                const int t = j1 + 1;
                if (t < W) {
                    Bf[t] += off1;
                    Ln[t] -= off1;
                    if (span1) A[t] += off1;
                    PRE[t] = pos1;
                    VIS[t] -= off1;
                }
            }
            if (has2) {
                const int d2 = j2 + (int)has1;
                const int base = (has1 && j1 == j2) ? off1 : 0;
                if (d2 < W) {
                    Ln[d2] = off2 - base;
                    VIS[d2] = off2 - base;
                }
                // tail2 is a raw copy of the ORIGINAL row j2
                const int t = d2 + 1;
                if (t < W) {
                    Bf[t] += off2;
                    Ln[t] -= off2;
                    if (span2) A[t] += off2;
                    PRE[t] = pos2;
                    VIS[t] -= off2;
                }
            }
        }
        nl += nh;
        __syncthreads();

        // ---- gap materialization: the count is taken once; each step
        // recomputes the gaps on the shifted table. A gap sits before a
        // row j <= nl, so only the segments up to row nl are read.
        int cnt = 0;
        for (int sg = 0; sg < nseg && (sg == 0 || sg * SR <= nl); ++sg) {
            const int row0 = sg * SR + tid * R;
#pragma unroll
            for (int r = 0; r < R; ++r) {
                int lo, hi, ghi;
                cnt += gap_at(hot, W, row0 + r, nl, S, c1, c2, lo, hi, ghi) ? 1 : 0;
            }
        }
        const int n_mat = block_sum(cnt, rbuf());
        for (int g = 0; g < n_mat; ++g) {
            int cj[1] = {W};
            for (int sg = 0; sg < nseg && (sg == 0 || sg * SR <= nl); ++sg) {
                const int row0 = sg * SR + tid * R;
                int c = W;
#pragma unroll
                for (int r = R - 1; r >= 0; --r) {
                    int lo, hi, ghi;
                    if (gap_at(hot, W, row0 + r, nl, S, c1, c2, lo, hi, ghi)) c = row0 + r;
                }
                cj[0] = sg == 0 ? c : min(cj[0], c);
            }
            block_min<1>(cj, rbuf());
            const int j = cj[0];
            // the Pallas kernel stages gap bounds in (W/128, 128) tiles
            // and reads them back with a clamped tile index
            const int jg = min(j / LANES, W / LANES - 1) * LANES + j % LANES;
            int loJ, hiJ, ghiJ;
            gap_at(hot, W, jg, nl, S, c1, c2, loJ, hiJ, ghiJ);
            const int pre_new = (j < nl ? PRE[min(j, W - 1)] : S + dsum) - (ghiJ - loJ);
            if (nl + 1 > W) err |= ERR_CAPACITY;
            __syncthreads();
            shift_rows<R, GLOBAL>(hot, W, nseg, heap, KRP, roll(j, min(nl + 1, W)), j, ls, lpar);
            if (j < W) {
                if (tid == 0) {
                    A[j] = loJ;
                    Bf[j] = SETTLED_BASE + loJ;
                    Ln[j] = hiJ - loJ;
                    IS[j] = 0;
                    IC[j] = NO_CLIENT;
                    RS[j] = NOT_REMOVED;
                    PRE[j] = pre_new;
                    VIS[j] = hiJ - loJ;
                }
                fill_new_cold(heap + (size_t)SL[j] * KRP, KR, KK, KRP, pk, pv, 0);
            }
            nl += 1;
            __syncthreads();
        }

        // ---- covered-range updates (markRangeRemoved / annotateRange)
        // straight off the maintained pre/vis columns.
        for (int sg = 0; sg < nseg && (sg == 0 || sg * SR < nl); ++sg) {
            const int row0 = sg * SR + tid * R;
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const int j = row0 + r;
                const int pj = PRE[j], vj = VIS[j];
                const bool covered = vj > 0 && pj >= pos1 && pj + vj <= pos2 && j < nl;
                if (!covered) continue;
                int* cold = heap + (size_t)SL[j] * KRP;
                if (otype == OP_REMOVE) {
                    const bool already = RS[j] != NOT_REMOVED;
                    if (!already) RS[j] = oseq;
                    // The first free slot: every slot loaded, 16 bytes at a time.
                    const int4* rc = reinterpret_cast<const int4*>(cold);
                    int first_free = KR;
                    for (int q = KR4 - 1; q >= 0; --q) {
                        const int4 x = rc[q];
                        const int k = 4 * q;
                        if (x.w == NO_CLIENT && k + 3 < KR) first_free = k + 3;
                        if (x.z == NO_CLIENT && k + 2 < KR) first_free = k + 2;
                        if (x.y == NO_CLIENT && k + 1 < KR) first_free = k + 1;
                        if (x.x == NO_CLIENT) first_free = k;
                    }
                    const bool no_free = first_free == KR;
                    if (already && no_free) {
                        atomicOr(s_err, ERR_REMOVERS);
                    } else {
                        cold[already ? first_free : 0] = oclient;
                    }
                } else {
                    // last writer wins; a delete tombstones on span rows but
                    // clears on text rows
                    const bool is_span = Bf[j] >= SETTLED_BASE;
                    for (int p = 0; p < PK; ++p) {
                        const int key = pk[p];
                        if (key < 0 || key >= KK) continue;
                        const int val = pv[p];
                        cold[KR + key] =
                            val == PROP_DELETE ? (is_span ? PROP_DELETE : PROP_ABSENT) : val;
                    }
                }
            }
        }
        __syncthreads();
    }

    // Hot columns of every row; cold columns gathered in row order for
    // the live rows (rows >= n_rows are scratch).
    for (int j = tid; j < W; j += NT) {
#pragma unroll
        for (int c = 0; c < 6; ++c) a.col_out[c][(size_t)d * W + j] = cols[c][j];
    }
    const int n_out = min(max(nl, 0), W);
    int* rcl_out = a.rcl_out + (size_t)d * W * KR;
    int* props_out = a.props_out + (size_t)d * W * KK;
    for (int e = tid; e < n_out * KR; e += NT) {
        const int j = e / KR;
        rcl_out[e] = heap[(size_t)SL[j] * KRP + e - j * KR];
    }
    for (int e = tid; e < n_out * KK; e += NT) {
        const int j = e / KK;
        props_out[e] = heap[(size_t)SL[j] * KRP + KR + e - j * KK];
    }
    if (tid == 0) {
        a.n_rows_out[d] = nl;
        a.err_out[d] = err | *s_err;
    }
}

struct Plan {
    int layout, smem, scratch_ints;
};

// The layout of a launch, decided here and only here: the shared layout
// when the window is at most R_SHARED_MAX rows a thread and its hot
// columns, misc ints and the chunk's ops fit the device's opt-in shared
// bytes per block; else the global layout, whose block needs only the
// misc ints and a hot scratch of NHOT x W ints per document. `force`
// LAYOUT_SHARED or LAYOUT_GLOBAL asks for that layout instead (to hold
// both against the plain version, or time them, on the same chunks);
// a shared layout that does not fit is refused (false).
bool plan(int W, int B, int PK, int smem_optin, int force, Plan& p) {
    const long long shared =
        4LL * (NHOT * (long long)W + MISC_INTS + (long long)B * (OPC + 2 * PK));
    const bool fits = W / NT <= R_SHARED_MAX && shared <= smem_optin;
    if (force == LAYOUT_SHARED && !fits) return false;
    if (fits && force != LAYOUT_GLOBAL) {
        p = {LAYOUT_SHARED, (int)shared, 0};
    } else {
        p = {LAYOUT_GLOBAL, 4 * MISC_INTS, NHOT * W};
    }
    return true;
}

bool valid_shape(int W, int KR, int KK, int KRP, int B, int PK, int force) {
    return W > 0 && W % NT == 0 && KR >= 1 && KK >= 0 && KRP % 4 == 0 &&
           KRP >= KR + KK && KRP <= NT && B >= 0 && PK >= 0 && force >= -1 &&
           force <= LAYOUT_GLOBAL;
}

cudaError_t device_plan(int device, int W, int B, int PK, int force, Plan& p) {
    int optin = 0;
    cudaError_t e =
        cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (e != cudaSuccess) return e;
    return plan(W, B, PK, optin, force, p) ? cudaSuccess : cudaErrorInvalidValue;
}

template <int R, bool GLOBAL>
cudaError_t launch(const Args& a, int n_docs, int smem, cudaStream_t stream) {
    cudaError_t e = cudaFuncSetAttribute(
        overlay_chunk_kernel<R, GLOBAL>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    overlay_chunk_kernel<R, GLOBAL><<<n_docs, NT, smem, stream>>>(a);
    return cudaGetLastError();
}

}  // namespace

// The plan of a launch at window W with KR + KK <= KRP heap ints a row
// and chunks of B ops x PK prop slots on `device` (`force` -1 lets the
// launcher choose the layout, 0 or 1 asks for the shared or the global
// one, and a shared layout that does not fit is refused): out[0] the layout
// (0 shared, 1 global), out[1] the dynamic shared bytes of a block,
// out[2] the hot-scratch ints a document needs (0 in the shared
// layout). The wrapper reads it to allocate the scratch; the launcher
// works it out again itself. Returns a CUDA error code (0 on success).
extern "C" int overlay_chunk_plan(int device, int W, int KR, int KK, int KRP,
                                  int B, int PK, int force, int* out) {
    if (!valid_shape(W, KR, KK, KRP, B, PK, force)) return (int)cudaErrorInvalidValue;
    Plan p;
    cudaError_t e = device_plan(device, W, B, PK, force, p);
    if (e != cudaSuccess) return (int)e;
    out[0] = p.layout;
    out[1] = p.smem;
    out[2] = p.scratch_ints;
    return 0;
}

// Plain C entry point (loaded with ctypes). `ptrs` holds, in order:
// n_rows, error, settled_len, anchor, buf_start, length, ins_seq,
// ins_client, rem_seq, rem_clients, props, op_type, pos1, pos2, seq,
// ref_seq, client, buf_start, ins_len, prop_keys, prop_vals (inputs),
// then anchor, buf_start, length, ins_seq, ins_client, rem_seq,
// rem_clients, props, n_rows, error (outputs), then the heap
// [n_docs, W, KRP] and the hot scratch [n_docs, scratch ints of the
// plan] (unused in the shared layout); each array holds `n_docs`
// documents back to back. A heap row of KRP ints holds KR + KK, is read
// 16 bytes at a time and filled or copied one int per thread: KRP is a
// multiple of 4, at most NT. `force` as in overlay_chunk_plan. Launches
// one block per document on `stream` and returns cudaGetLastError() (0
// when the launch was accepted).
extern "C" int overlay_chunk_launch(int device, int n_docs, int W, int KR,
                                    int KK, int KRP, int B, int PK, int force,
                                    int n_ptrs, void** ptrs, void* stream) {
    if (n_ptrs != N_PTRS || n_docs < 1 || !valid_shape(W, KR, KK, KRP, B, PK, force))
        return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    Plan p;
    e = device_plan(device, W, B, PK, force, p);
    if (e != cudaSuccess) return (int)e;
    Args a;
    a.KR = KR;
    a.KK = KK;
    a.KRP = KRP;
    a.B = B;
    a.PK = PK;
    int k = 0;
    a.n_rows_in = (const int*)ptrs[k++];
    a.err_in = (const int*)ptrs[k++];
    a.settled_len = (const int*)ptrs[k++];
    for (int c = 0; c < 6; ++c) a.col_in[c] = (const int*)ptrs[k++];
    a.rcl_in = (const int*)ptrs[k++];
    a.props_in = (const int*)ptrs[k++];
    for (int c = 0; c < OPC; ++c) a.op[c] = (const int*)ptrs[k++];
    a.prop_keys = (const int*)ptrs[k++];
    a.prop_vals = (const int*)ptrs[k++];
    for (int c = 0; c < 6; ++c) a.col_out[c] = (int*)ptrs[k++];
    a.rcl_out = (int*)ptrs[k++];
    a.props_out = (int*)ptrs[k++];
    a.n_rows_out = (int*)ptrs[k++];
    a.err_out = (int*)ptrs[k++];
    a.heap = (int*)ptrs[k++];
    a.hot_scratch = (int*)ptrs[k++];
    cudaStream_t s = (cudaStream_t)stream;
    if (p.layout == LAYOUT_GLOBAL) {
        a.nseg = W / NT;
        e = launch<1, true>(a, n_docs, p.smem, s);
    } else {
        a.nseg = 1;
        switch (W / NT) {
            case 1: e = launch<1, false>(a, n_docs, p.smem, s); break;
            case 2: e = launch<2, false>(a, n_docs, p.smem, s); break;
            case 3: e = launch<3, false>(a, n_docs, p.smem, s); break;
            case 4: e = launch<4, false>(a, n_docs, p.smem, s); break;
            case 5: e = launch<5, false>(a, n_docs, p.smem, s); break;
            case 6: e = launch<6, false>(a, n_docs, p.smem, s); break;
            default: return (int)cudaErrorInvalidValue;
        }
    }
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}
