// Overlay merge-tree chunk kernel for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_overlay_chunk_kernel`
// (fluidframework_tpu/ops/overlay_pallas.py:118, called through
// `overlay_apply_chunk`). It applies a chunk of B sequenced
// insert/remove/annotate ops, one after another, to the overlay table
// of unsettled rows, with exactly the semantics of
// `ops/overlay_ref.OverlayDoc.apply`; its plain PyTorch version is
// `ops/overlay.overlay_apply_chunk_ref`, which it must equal on rows
// [:n_rows] bit for bit.
//
// Design. One document's ops are serial, so one thread block of 1024
// threads owns one document and loops over the chunk's ops; the op
// scalars are block-uniform, so each `pl.when` of the Pallas kernel is
// a block-uniform branch here. Thread t owns the R contiguous rows
// [t*R, t*R+R) of a window W = 1024*R (R = 1, 2, 4).
//
// - The hot columns (anchor, buf, len, ins_seq, ins_client, rem_seq
//   and the pre/vis scratch) live in dynamic shared memory:
//   8 x W int32 = 64 KiB at W = 2048. The Pallas scratch also holds
//   the KR remover slots and KK prop columns (40 x W int32 = 320 KiB at
//   the bench geometry), more than the 227 KB a block may use, so
//   rem_clients[W, KR] and props[W, KK] stay in global memory (L2
//   resident; 256 KiB at the bench geometry), row-major as the torch
//   tensors are. They are read by the visibility pass only for removed
//   rows, and written only by shifts, new rows, removal and annotate.
// - The perspective pass's prefix sum (an f32 MXU matmul in Pallas) is
//   a block-wide int32 exclusive scan: warp shuffles plus per-warp
//   totals in shared memory. `first_idx` is a block min-reduction.
//   Reductions use two alternating shared buffers, so each costs one
//   __syncthreads.
// - `roll_from(thr)` (row j takes row j-1 for j >= thr) loads the
//   source rows to registers, synchronises and stores; the global
//   columns move as a top-down tiled memmove. Rows at or beyond the
//   live count after the shift are scratch and are not moved.
// - One-row fixups (split heads/tails, the new row) are done by
//   thread 0 between barriers; writes to rows >= W are dropped, as the
//   one-hot writes of the Pallas kernel are, and the ERR_* flags are
//   raised the same way.
//
// What bounds it: the serial chain of ~14 __syncthreads per op on one
// SM and the shifts' global traffic, not the card's bandwidth or
// arithmetic (PERF.md works the bound out). Many documents would be
// many blocks: the docs stride is in the signature already.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 1024;  // threads per block
constexpr int LANES = 128;
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
constexpr int N_PTRS = 31;

struct Args {
    int KR, KK, B, PK;
    // inputs: per document
    const int* n_rows_in;   // [D]
    const int* err_in;      // [D]
    const int* settled_len; // [D]
    const int* col_in[6];   // [D, W] anchor, buf, len, ins_seq, ins_client, rem_seq
    const int* rcl_in;      // [D, W, KR]
    const int* props_in;    // [D, W, KK]
    const int* op[8];       // [D, B] type, pos1, pos2, seq, ref_seq, client, buf, len
    const int* prop_keys;   // [D, B, PK]
    const int* prop_vals;   // [D, B, PK]
    // outputs
    int* col_out[6];        // [D, W]
    int* rcl_out;           // [D, W, KR]
    int* props_out;         // [D, W, KK]
    int* n_rows_out;        // [D]
    int* err_out;           // [D]
};

// Shared-memory view of one document's hot columns.
struct Hot {
    int *A, *Bf, *L, *IS, *IC, *RS, *PRE, *VIS;
};

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
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    int s = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) s += d[r];
    int inc = warp_incl_scan(s, lane);
    if (lane == 31) buf[wid] = inc;
    __syncthreads();
    int wt = buf[lane];  // NT / 32 == 32 warps
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
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < N; ++k) {
        int m = __reduce_min_sync(FULL, v[k]);
        if (lane == 0) buf[k * 32 + wid] = m;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = __reduce_min_sync(FULL, buf[k * 32 + lane]);
}

__device__ int block_sum(int v, int* buf) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    int s = __reduce_add_sync(FULL, v);
    if (lane == 0) buf[wid] = s;
    __syncthreads();
    return __reduce_add_sync(FULL, buf[lane]);
}

// Global-memory shift of rows [lo-1, lim-1) to [lo, lim) of a
// row-major [W, K] array: a memmove by K ints, done in tiles from the
// top down. A tile's reads lie below every earlier tile's writes, and
// its writes follow a barrier after which every earlier read is done,
// so one __syncthreads per tile suffices.
__device__ void gmem_shift(int* base, int K, int lo, int lim) {
    if (K == 0) return;
    const int TILE = NT * 4;
    const int d0 = lo * K, d1 = lim * K;
    for (int top = d1; top > d0; top -= TILE) {
        const int bot = max(top - TILE, d0);
        int v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            int i = bot + q * NT + threadIdx.x;
            if (i < top) v[q] = base[i - K];
        }
        __syncthreads();
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            int i = bot + q * NT + threadIdx.x;
            if (i < top) base[i] = v[q];
        }
    }
}

// Row j takes row j-1 for j in [max(thr, 1), lim), in every column.
// Block-uniform arguments; ends with a barrier when it moves anything.
template <int R>
__device__ void roll_from(const Hot& h, int* rcl, int* props, int KR, int KK,
                          int thr, int lim) {
    const int lo = max(thr, 1);
    if (lo >= lim) return;
    int v[8][R];
    const int row0 = threadIdx.x * R;
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int j = row0 + r;
        if (j >= lo && j < lim) {
            v[0][r] = h.A[j - 1];
            v[1][r] = h.Bf[j - 1];
            v[2][r] = h.L[j - 1];
            v[3][r] = h.IS[j - 1];
            v[4][r] = h.IC[j - 1];
            v[5][r] = h.RS[j - 1];
            v[6][r] = h.PRE[j - 1];
            v[7][r] = h.VIS[j - 1];
        }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int j = row0 + r;
        if (j >= lo && j < lim) {
            h.A[j] = v[0][r];
            h.Bf[j] = v[1][r];
            h.L[j] = v[2][r];
            h.IS[j] = v[3][r];
            h.IC[j] = v[4][r];
            h.RS[j] = v[5][r];
            h.PRE[j] = v[6][r];
            h.VIS[j] = v[7][r];
        }
    }
    gmem_shift(rcl, KR, lo, lim);
    gmem_shift(props, KK, lo, lim);
    __syncthreads();
}

// The gap before row j (overlay_ref "gap materialization"): settled
// coordinates [lo, hi) the range [c1, c2) covers there.
__device__ __forceinline__ bool gap_at(const Hot& h, int j, int nl, int S,
                                       int c1, int c2, int& lo, int& hi,
                                       int& ghi) {
    const bool live = j < nl;
    int glo = 0;
    bool prev_live = true;
    if (j > 0) {
        const int p = j - 1;
        prev_live = p < nl;
        const int cons = (prev_live && h.Bf[p] >= SETTLED_BASE) ? h.L[p] : 0;
        glo = h.A[p] + cons;
    }
    ghi = live ? h.A[j] : S;
    lo = max(glo, c1);
    hi = min(ghi, c2);
    return (live || prev_live) && lo < hi;
}

// Fill row j (< W) of every column with a fresh row's values; thread 0
// writes the hot columns, threads < KR / < KK the global ones.
__device__ __forceinline__ void clear_new_row_globals(int* rcl, int* props,
                                                      int KR, int KK, int j) {
    if ((int)threadIdx.x < KR) rcl[(size_t)j * KR + threadIdx.x] = NO_CLIENT;
    if ((int)threadIdx.x < KK) props[(size_t)j * KK + threadIdx.x] = PROP_ABSENT;
}

template <int R>
__global__ void __launch_bounds__(NT, 1) overlay_chunk_kernel(Args a) {
    extern __shared__ int sm[];
    constexpr int W = NT * R;
    Hot h;
    h.A = sm;
    h.Bf = h.A + W;
    h.L = h.Bf + W;
    h.IS = h.L + W;
    h.IC = h.IS + W;
    h.RS = h.IC + W;
    h.PRE = h.RS + W;
    h.VIS = h.PRE + W;
    int* red = h.VIS + W;     // 2 x 128 reduction buffers
    int* s_err = red + 256;   // per-row error flags (atomicOr)

    const int d = blockIdx.x;
    const int tid = threadIdx.x;
    const int KR = a.KR, KK = a.KK, B = a.B, PK = a.PK;
    int* rcl = a.rcl_out + (size_t)d * W * KR;
    int* props = a.props_out + (size_t)d * W * KK;
    const int* rcl_in = a.rcl_in + (size_t)d * W * KR;
    const int* props_in = a.props_in + (size_t)d * W * KK;
    int* hot[6] = {h.A, h.Bf, h.L, h.IS, h.IC, h.RS};

    for (int j = tid; j < W; j += NT) {
#pragma unroll
        for (int c = 0; c < 6; ++c) hot[c][j] = a.col_in[c][(size_t)d * W + j];
        h.PRE[j] = 0;
        h.VIS[j] = 0;
    }
    for (int i = tid; i < W * KR; i += NT) rcl[i] = rcl_in[i];
    for (int i = tid; i < W * KK; i += NT) props[i] = props_in[i];
    if (tid == 0) *s_err = 0;
    int nl = a.n_rows_in[d];
    int err = a.err_in[d];
    const int S = a.settled_len[d];
    int phase = 0;
    auto rbuf = [&]() {
        int* b = red + phase * 128;
        phase ^= 1;
        return b;
    };
    __syncthreads();

    const int row0 = tid * R;
    for (int i = 0; i < B; ++i) {
        const size_t oi = (size_t)d * B + i;
        const int otype = a.op[0][oi];
        const int pos1 = a.op[1][oi];
        const int pos2 = a.op[2][oi];
        const int oseq = a.op[3][oi];
        const int orefseq = a.op[4][oi];
        const int oclient = a.op[5][oi];
        const int obuf = a.op[6][oi];
        const int oilen = a.op[7][oi];
        const int* pk = a.prop_keys + oi * PK;
        const int* pv = a.prop_vals + oi * PK;
        if (otype != OP_INSERT && otype != OP_REMOVE && otype != OP_ANNOTATE)
            continue;

        // ---- the perspective pass: visibility at (ref_seq, client)
        // and the exclusive prefix sum of vis - consume.
        bool skip[R];
        int pre[R], vis[R], dlt[R], ex[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int j = row0 + r;
            const bool live = j < nl;
            const int rs = h.RS[j];
            const bool removed = rs != NOT_REMOVED;
            const bool tomb = removed && rs <= orefseq;
            const bool ins_vis = h.IC[j] == oclient || h.IS[j] <= orefseq;
            const bool sk = !live || tomb || (removed && !ins_vis);
            bool visible = !sk && ins_vis;
            if (visible && removed) {
                const int* rc = rcl + (size_t)j * KR;
                bool among = false;
                for (int k = 0; k < KR; ++k) among |= rc[k] == oclient;
                visible = !among;
            }
            const int len = h.L[j];
            vis[r] = visible ? len : 0;
            const int consume = (live && h.Bf[j] >= SETTLED_BASE) ? len : 0;
            dlt[r] = vis[r] - consume;
            skip[r] = sk;
        }
        const int dsum = block_excl_scan<R>(dlt, ex, rbuf());
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int j = row0 + r;
            pre[r] = h.A[j] + ex[r];
            h.PRE[j] = pre[r];
            h.VIS[j] = vis[r];
        }
        const int total = S + dsum;

        if (otype == OP_INSERT) {
            int cand[1] = {W};
#pragma unroll
            for (int r = R - 1; r >= 0; --r) {
                const int j = row0 + r;
                const bool inside = pre[r] < pos1 && pre[r] + vis[r] > pos1;
                const bool land =
                    j < nl &&
                    (pre[r] > pos1 ||
                     (pre[r] == pos1 && !skip[r] && (vis[r] > 0 || oseq > h.IS[j])));
                if (inside || land) cand[0] = j;
            }
            block_min<1>(cand, rbuf());
            const int j0 = cand[0];
            const int jc = min(j0, W - 1);
            const int preX = h.PRE[jc], visX = h.VIS[jc];
            const int ancX = h.A[jc], bufX = h.Bf[jc];
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
            roll_from<R>(h, rcl, props, KR, KK, t1, min(nl + 1, W));
            if (has_split) roll_from<R>(h, rcl, props, KR, KK, t1, min(nl + 2, W));
            if (tid == 0) {
                if (has_split) {
                    const int hd = t1 - 1;
                    h.L[hd] = off;
                    h.VIS[hd] = off;
                    const int t = t1 + 1;  // tail: a raw copy of the split row
                    if (t < W) {
                        h.Bf[t] += off;
                        h.L[t] -= off;
                        if (span_s) h.A[t] += off;
                        h.PRE[t] = pos1;
                        h.VIS[t] -= off;
                    }
                }
                if (t1 < W) {
                    h.A[t1] = aval;
                    h.Bf[t1] = obuf;
                    h.L[t1] = oilen;
                    h.IS[t1] = oseq;
                    h.IC[t1] = oclient;
                    h.RS[t1] = NOT_REMOVED;
                    h.PRE[t1] = pos1;
                    h.VIS[t1] = oilen;
                }
            }
            if (t1 < W) {
                clear_new_row_globals(rcl, props, KR, KK, t1);
                if (tid < KK) {
                    int v = PROP_ABSENT;
                    for (int p = 0; p < PK; ++p)
                        if (pk[p] == tid) v = (pv[p] == PROP_DELETE) ? PROP_ABSENT : pv[p];
                    props[(size_t)t1 * KK + tid] = v;
                }
            }
            nl += n_new;
            __syncthreads();
            continue;
        }

        // ---- range ops: both boundary splits resolve in pre-split
        // coordinates from the one perspective pass.
        if (total < pos2) err |= ERR_BAD_POS;
        int c4[4] = {W, W, W, W};
#pragma unroll
        for (int r = R - 1; r >= 0; --r) {
            const int j = row0 + r;
            const bool live = j < nl;
            if (pre[r] < pos1 && pre[r] + vis[r] > pos1) c4[0] = j;
            if (pre[r] < pos2 && pre[r] + vis[r] > pos2) c4[1] = j;
            if (live && pre[r] >= pos1) c4[2] = j;
            if (live && pre[r] >= pos2) c4[3] = j;
        }
        block_min<4>(c4, rbuf());
        const int j1 = c4[0], j2 = c4[1], jc1 = c4[2], jc2 = c4[3];
        const bool has1 = j1 < W, has2 = j2 < W;
        const int k1 = min(j1, W - 1), k2 = min(j2, W - 1);
        const int pre1 = h.PRE[k1], anc1 = h.A[k1], buf1 = h.Bf[k1];
        const int pre2 = h.PRE[k2], anc2 = h.A[k2], buf2 = h.Bf[k2];
        const int off1 = pos1 - pre1, off2 = pos2 - pre2;
        const bool span1 = buf1 >= SETTLED_BASE, span2 = buf2 >= SETTLED_BASE;
        int c1, c2;
        if (has1) c1 = anc1 + (span1 ? off1 : 0);
        else if (jc1 < W) c1 = h.A[jc1] - (h.PRE[jc1] - pos1);
        else c1 = pos1 - dsum;
        if (has2) c2 = anc2 + (span2 ? off2 : 0);
        else if (jc2 < W) c2 = h.A[jc2] - (h.PRE[jc2] - pos2);
        else c2 = pos2 - dsum;
        const int r1 = has1 ? j1 + 1 : (has2 ? j2 + 1 : W);
        const int nh = (int)has1 + (int)has2;
        if (nl + nh > W) err |= ERR_CAPACITY;
        __syncthreads();
        if (has1 || has2) roll_from<R>(h, rcl, props, KR, KK, r1, min(nl + 1, W));
        if (has1 && has2) roll_from<R>(h, rcl, props, KR, KK, j2 + 2, min(nl + 2, W));
        if (tid == 0) {
            if (has1) {
                h.L[j1] = off1;
                h.VIS[j1] = off1;
                const int t = j1 + 1;
                if (t < W) {
                    h.Bf[t] += off1;
                    h.L[t] -= off1;
                    if (span1) h.A[t] += off1;
                    h.PRE[t] = pos1;
                    h.VIS[t] -= off1;
                }
            }
            if (has2) {
                const int d2 = j2 + (int)has1;
                const int base = (has1 && j1 == j2) ? off1 : 0;
                if (d2 < W) {
                    h.L[d2] = off2 - base;
                    h.VIS[d2] = off2 - base;
                }
                // tail2 is a raw copy of the ORIGINAL row j2
                const int t = d2 + 1;
                if (t < W) {
                    h.Bf[t] += off2;
                    h.L[t] -= off2;
                    if (span2) h.A[t] += off2;
                    h.PRE[t] = pos2;
                    h.VIS[t] -= off2;
                }
            }
        }
        nl += nh;
        __syncthreads();

        // ---- gap materialization: the count is taken once; each step
        // recomputes the gaps on the shifted table.
        int cnt = 0;
#pragma unroll
        for (int r = 0; r < R; ++r) {
            int lo, hi, ghi;
            cnt += gap_at(h, row0 + r, nl, S, c1, c2, lo, hi, ghi) ? 1 : 0;
        }
        const int n_mat = block_sum(cnt, rbuf());
        for (int g = 0; g < n_mat; ++g) {
            int cj[1] = {W};
#pragma unroll
            for (int r = R - 1; r >= 0; --r) {
                int lo, hi, ghi;
                if (gap_at(h, row0 + r, nl, S, c1, c2, lo, hi, ghi)) cj[0] = row0 + r;
            }
            block_min<1>(cj, rbuf());
            const int j = cj[0];
            // the Pallas kernel stages gap bounds in (W/128, 128) tiles
            // and reads them back with a clamped tile index
            const int jg = min(j / LANES, W / LANES - 1) * LANES + j % LANES;
            int loJ, hiJ, ghiJ;
            gap_at(h, jg, nl, S, c1, c2, loJ, hiJ, ghiJ);
            const int pre_new =
                (j < nl ? h.PRE[min(j, W - 1)] : S + dsum) - (ghiJ - loJ);
            if (nl + 1 > W) err |= ERR_CAPACITY;
            __syncthreads();
            roll_from<R>(h, rcl, props, KR, KK, j, min(nl + 1, W));
            if (j < W) {
                if (tid == 0) {
                    h.A[j] = loJ;
                    h.Bf[j] = SETTLED_BASE + loJ;
                    h.L[j] = hiJ - loJ;
                    h.IS[j] = 0;
                    h.IC[j] = NO_CLIENT;
                    h.RS[j] = NOT_REMOVED;
                    h.PRE[j] = pre_new;
                    h.VIS[j] = hiJ - loJ;
                }
                clear_new_row_globals(rcl, props, KR, KK, j);
            }
            nl += 1;
            __syncthreads();
        }

        // ---- covered-range updates (markRangeRemoved / annotateRange)
        // straight off the maintained pre/vis columns.
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int j = row0 + r;
            const int pj = h.PRE[j], vj = h.VIS[j];
            const bool covered = vj > 0 && pj >= pos1 && pj + vj <= pos2 && j < nl;
            if (!covered) continue;
            if (otype == OP_REMOVE) {
                int* rc = rcl + (size_t)j * KR;
                const bool already = h.RS[j] != NOT_REMOVED;
                if (!already) h.RS[j] = oseq;
                int first_free = KR;
                for (int k = KR - 1; k >= 0; --k)
                    if (rc[k] == NO_CLIENT) first_free = k;
                const bool no_free = first_free == KR;
                if (already && no_free) {
                    atomicOr(s_err, ERR_REMOVERS);
                } else {
                    rc[already ? first_free : 0] = oclient;
                }
            } else {
                // last writer wins; a delete tombstones on span rows but
                // clears on text rows
                const bool is_span = h.Bf[j] >= SETTLED_BASE;
                for (int p = 0; p < PK; ++p) {
                    const int key = pk[p];
                    if (key < 0 || key >= KK) continue;
                    const int val = pv[p];
                    props[(size_t)j * KK + key] =
                        val == PROP_DELETE ? (is_span ? PROP_DELETE : PROP_ABSENT) : val;
                }
            }
        }
        __syncthreads();
    }

    for (int j = tid; j < W; j += NT) {
#pragma unroll
        for (int c = 0; c < 6; ++c) a.col_out[c][(size_t)d * W + j] = hot[c][j];
    }
    if (tid == 0) {
        a.n_rows_out[d] = nl;
        a.err_out[d] = err | *s_err;
    }
}

template <int R>
cudaError_t launch(const Args& a, int n_docs, cudaStream_t stream) {
    const size_t smem = (size_t)(8 * NT * R + 256 + 1) * sizeof(int);
    cudaError_t e = cudaFuncSetAttribute(
        overlay_chunk_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    overlay_chunk_kernel<R><<<n_docs, NT, smem, stream>>>(a);
    return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). `ptrs` holds, in order:
// n_rows, error, settled_len, anchor, buf_start, length, ins_seq,
// ins_client, rem_seq, rem_clients, props, op_type, pos1, pos2, seq,
// ref_seq, client, buf_start, ins_len, prop_keys, prop_vals (inputs),
// then anchor, buf_start, length, ins_seq, ins_client, rem_seq,
// rem_clients, props, n_rows, error (outputs); each array holds
// `n_docs` documents back to back. Launches on `stream` and returns
// cudaGetLastError() (0 when the launch was accepted).
extern "C" int overlay_chunk_launch(int device, int n_docs, int W, int KR,
                                    int KK, int B, int PK, int n_ptrs,
                                    void** ptrs, void* stream) {
    if (n_ptrs != N_PTRS) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    Args a;
    a.KR = KR;
    a.KK = KK;
    a.B = B;
    a.PK = PK;
    int k = 0;
    a.n_rows_in = (const int*)ptrs[k++];
    a.err_in = (const int*)ptrs[k++];
    a.settled_len = (const int*)ptrs[k++];
    for (int c = 0; c < 6; ++c) a.col_in[c] = (const int*)ptrs[k++];
    a.rcl_in = (const int*)ptrs[k++];
    a.props_in = (const int*)ptrs[k++];
    for (int c = 0; c < 8; ++c) a.op[c] = (const int*)ptrs[k++];
    a.prop_keys = (const int*)ptrs[k++];
    a.prop_vals = (const int*)ptrs[k++];
    for (int c = 0; c < 6; ++c) a.col_out[c] = (int*)ptrs[k++];
    a.rcl_out = (int*)ptrs[k++];
    a.props_out = (int*)ptrs[k++];
    a.n_rows_out = (int*)ptrs[k++];
    a.err_out = (int*)ptrs[k++];
    cudaStream_t s = (cudaStream_t)stream;
    switch (W) {
        case NT * 1: e = launch<1>(a, n_docs, s); break;
        case NT * 2: e = launch<2>(a, n_docs, s); break;
        case NT * 4: e = launch<4>(a, n_docs, s); break;
        default: return (int)cudaErrorInvalidValue;
    }
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}
