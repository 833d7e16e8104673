// SharedTree's batched changeset rebase (BASELINE config 4), for Hopper.
//
// Replaces fluidframework_tpu/tree/rebase_kernel.py::_rebase_step (:83)
// under the `rebase_batch` scan (:262): an XLA `lax.scan` over the M base
// (trunk) ops that adjusts all N pending ops per step. Its plain PyTorch
// version is `_rebase_step_ref` / `rebase_batch_ref` in
// fluidframework_tpu_torch/tree/rebase_kernel.py; this kernel computes
// exactly what they compute (int32 and bool, tolerance 0), for every
// int32 input the reference takes (unknown kinds included): its sums
// wrap at the ends of int32 as the reference's do.
//
// Bound on an H100: the integer ALU. Per launch the pending columns are
// read once (16 bytes an op) and the outputs written once (26 bytes an
// op): 4.2 MB at config 4 (N 100,000), ~1.25 us at 3.35 TB/s. A step
// needs 6-44 integer instructions per pending op, by the base op's code
// and the pending op's own kind (the table and its derivation are
// REBASE_OPS in chip_smoke.py; tools/rebase_sass.py counts this file's
// steps in SASS, by pipe): 19.44 an op-rebase at config 4. About 0.78 of
// them (REBASE_ALU_OPS: comparisons, selects, min / max) only the ALU's
// 64 lanes an SM can issue, the adds and moves also the FMA pipe as
// IMADs: 5.78 us for 100,000 x 64 steps on the ALU, against 3.72 us for
// all of them at the issue rate. The kinds' branches differ: at config
// 4's base mix a pending insert needs ~9.4 a step, a remove ~25.4, a
// move ~23.6. A warp issues the instructions of every branch one of its
// lanes takes, so a warp of mixed kinds issues all three (~58.4 by the
// table).
//
// Design: one thread per pending op. A step reads only the pending op and
// the current base op (no reduction across the pending axis), so each
// thread keeps its state in registers -- index, count, dst, spare index,
// spare count, spare active, flag -- and walks the M base ops in order.
// The block stages the base window in shared memory in tiles of TILE
// ops; every thread then reads the same entry (a broadcast, no bank
// conflict). The terms that depend only on the base op are computed once
// per entry while staging: its end bi + bn, a move's post-detach attach
// gap bg, and a code that folds the base kind with the identity-move
// test. The first tile is staged while the block partitions its ops.
//
// The step is a template on the pending kind and the base code. The walk
// tests each entry's code once (uniform across the block: no divergence)
// and runs that code's step; an identity base move runs none. K_INSERT,
// K_REMOVE and K_MOVE fix the pending kind at compile time, so only that
// kind's branch is issued; P_ANY reads the kind at run time and computes
// every kind's terms, as the reference does. Inside a step, conditions
// combine with & and | rather than && and ||, which leaves nvcc no
// short-circuit to branch on.
//
// Grouping: a block of BLOCK ops loads its pending columns coalesced,
// counts its ops by class (insert, remove, move, a kind outside 0..2,
// past N) with warp ballots, and writes a stable partition of them to
// shared memory, in segments of 32 slots. Each warp takes one segment:
// they are dealt so that each of the SM's four schedulers gets a heavy
// segment with a light one (at config 4 a launch takes ~6 % longer with
// warp w on segment w, and as long with segments w and 7 - w paired
// blindly: tools/rebase_ab.py). A warp whose live lanes share one kind of
// 0..2 walks the window with that kind's step, any other warp with P_ANY;
// the choice is made once per warp, before the walk. A block of 256 ops
// in four classes has at most three segments that straddle a class edge:
// at config 4's uniform kinds about two of its eight warps mix kinds
// (0.245 of the warps; `warp_steps` in tree/rebase_kernel.py counts them,
// phase 21 of chip_smoke.py prints the share), and only they issue every
// kind's branch. The results go back through shared memory to their ops'
// positions, so the stores stay coalesced (the two flag columns are
// written as bytes and read as torch.bool). At config 4 the grid is 391
// blocks of 256 threads, one wave on 132 SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K_INSERT = 0;
constexpr int K_REMOVE = 1;
constexpr int K_MOVE = 2;
constexpr int P_ANY = -1;  // step tag: the pending kind is read at run time
// Staged base-op codes: the base kind, with a move split by the identity
// test and every other kind value apart (the reference moves gaps over it
// as over a move, with none of a move's flags, splits or attach shifts).
constexpr int C_INSERT = 0;
constexpr int C_REMOVE = 1;
constexpr int C_MOVE = 2;
constexpr int C_OTHER = 3;
constexpr int C_NOOP = 4;  // identity base move: adjusts nothing
constexpr int BLOCK = 256;  // THREADS in tree/rebase_kernel.py
constexpr int WARPS = BLOCK / 32;
// Partition classes, in slot order: the three kinds, a kind outside 0..2,
// a lane past N (last, so the live slots are the first ones).
constexpr int N_CLS = 5;
constexpr int CLS_OTHER = 3;
constexpr int CLS_PAST = 4;
constexpr int TILE = 1024;  // base ops staged at a time (24 KB)
constexpr int N_PTRS = 16;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
    int N, M;
    const int* kind;
    const int* idx;
    const int* cnt;
    const int* dst;
    const int* bkind;
    const int* bidx;
    const int* bcnt;
    const int* bdst;
    int* o_kind;
    int* o_idx;
    int* o_cnt;
    int* o_dst;
    int* o_sidx;
    int* o_scnt;
    uint8_t* o_sact;
    uint8_t* o_flag;
};

// A pending op's state between steps (its kind never changes); the spare's
// activity and the flag are 0 or 1.
struct State {
    int idx, cnt, dst, sidx, scnt, sact, flag;
};

__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
// int32 sums and differences wrap, as the reference's do (signed
// overflow is undefined in C++, and nvcc may fold comparisons of sums
// that it assumes do not overflow).
__device__ __forceinline__ int add(int a, int b) {
    return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int sub(int a, int b) {
    return (int)((unsigned)a - (unsigned)b);
}

// A gap (insertion point) over a base remove [bi, E): gaps at or past its
// start slide down, not below bi.
__device__ __forceinline__ int gap_remove(int g, int bi, int bn) {
    return g < bi ? g : imax(bi, sub(g, bn));
}

// A gap over a base move of [bi, E) to bg (post-detach frame): gaps
// strictly inside travel with the block; others slide as over a remove,
// then shift past the attach unless they sit before it, or at it and at
// the block's start (the adjacency tie keeps its side). Both values are
// computed and one selected, so lanes on either side do not split.
__device__ __forceinline__ int gap_move(int g, int bi, int bn, int E,
                                        int bg) {
    const bool inside = (bi < g) & (g < E);
    const int g1 = gap_remove(g, bi, bn);
    const bool shift = (bg < g1) | ((bg == g1) & (g != bi));
    const int slid = shift ? add(g1, bn) : g1;
    return inside ? add(bg, sub(g, bi)) : slid;
}

// A range's overlap with [bi, E) is non-empty, as a move's claim tests
// it: the larger start below the smaller end.
__device__ __forceinline__ bool overlaps(int i, int c, int bi, int E) {
    return imax(i, bi) < imin(add(i, c), E);
}

// The length of that overlap, clamped at 0, as a remove's clip takes it
// (its difference wraps, so near the int32 ends it can disagree with
// `overlaps`; each test keeps the reference's form).
__device__ __forceinline__ int overlap_len(int i, int c, int bi, int E) {
    return imax(0, sub(imin(add(i, c), E), imax(i, bi)));
}

// One pending op over one staged base op (bi, bn, bj, E, bg) of code
// CODE. PK is the pending kind when it is known at compile time (then
// `kind` is not read), or P_ANY. The flag, the spare take and the mute
// read the pre-step state; the spare is adjusted whether active or not.
// Conditions combine with & and | rather than && and ||: every operand is
// computed, so the lanes of a warp have no short-circuit to split on.
template <int PK, int CODE>
__device__ __forceinline__ void rebase_step(int kind, int bi, int bn, int bj,
                                            int E, int bg, State& s) {
    if (CODE == C_NOOP) return;
    const bool p_ins = PK == P_ANY ? kind == K_INSERT : PK == K_INSERT;
    const bool p_rem = PK == P_ANY ? kind == K_REMOVE : PK == K_REMOVE;
    const bool p_mv = PK == P_ANY ? kind == K_MOVE : PK == K_MOVE;
    // only a split remove takes the spare, so only a remove's is active
    const bool sact = (PK == P_ANY || PK == K_REMOVE) & (s.sact != 0);
    const int idx = s.idx, cnt = s.cnt, dst = s.dst;
    const int sidx = s.sidx, scnt = s.scnt;

    const bool live = cnt > 0;
    // a pending identity move mutes, judged on the pre-step values
    const int pend = add(idx, cnt);
    const bool op_noop = p_mv & (idx <= dst) & (dst <= pend);
    int n_idx, n_cnt = cnt, n_dst = dst, n_sidx, n_scnt = scnt;
    bool split_p = false, use_flag = false;
    int head_idx = 0, head_cnt = 0, tail_idx = 0, tail_cnt = 0;

    if (CODE == C_INSERT) {
        // Every pending kind's index shifts when bi is at or before it;
        // content landing strictly inside a move's block is absorbed,
        // inside a remove's range splits it.
        n_idx = bi <= idx ? add(idx, bn) : idx;
        const bool inside = (bi > idx) & (bi < pend);
        if (p_mv) {
            if (inside) n_cnt = add(cnt, bn);
            n_dst = bi <= dst ? add(dst, bn) : dst;
        }
        split_p = p_rem & live & inside;
        head_idx = idx;
        head_cnt = sub(bi, idx);
        tail_idx = E;
        tail_cnt = sub(pend, bi);
        n_sidx = bi <= sidx ? add(sidx, bn) : sidx;
        use_flag = sact & (scnt > 0) & (bi > sidx) & (bi < add(sidx, scnt));
    } else if (CODE == C_REMOVE) {
        // Gaps slide; ranges (remove, move, other kinds) are clipped: the
        // overlap is gone already.
        n_idx = gap_remove(idx, bi, bn);
        if (!p_ins) n_cnt = sub(cnt, overlap_len(idx, cnt, bi, E));
        if (p_mv) n_dst = gap_remove(dst, bi, bn);
        n_sidx = gap_remove(sidx, bi, bn);
        n_scnt = sub(scnt, overlap_len(sidx, scnt, bi, E));
    } else {  // C_MOVE, or C_OTHER: positions only
        const bool mvk = CODE == C_MOVE;
        const int idx0 = idx >= E ? sub(idx, bn) : idx;  // detach slide
        const int end0 = add(idx0, cnt);
        if (p_ins) {
            n_idx = gap_move(idx, bi, bn, E, bg);
        } else if (p_mv) {
            n_idx = bg <= idx0 ? add(idx0, bn) : idx0;
            if ((bg > idx0) & (bg < end0)) n_cnt = add(cnt, bn);
            n_dst = gap_move(dst, bi, bn, E, bg);
            // competing node claims, or mutual containment
            use_flag = mvk & live &
                       (overlaps(idx, cnt, bi, E) |
                        ((bi < dst) & (dst < E) & (idx < bj) & (bj < pend)));
        } else {
            // a range fully inside the block travels with it
            const bool full = (idx >= bi) & (pend <= E);
            n_idx = full ? add(bg, sub(idx, bi)) : idx0;
            if (mvk & p_rem) {
                // overlap: a 3-piece overlap flags; none: the attach
                // shifts the range, or splits it
                const bool ov = overlap_len(idx, cnt, bi, E) > 0;
                const bool clear = live & !ov;
                use_flag = live & ov & !full;
                n_idx = clear & (bg <= idx0) ? add(n_idx, bn) : n_idx;
                split_p = clear & (bg > idx0) & (bg < end0);
            }
        }
        head_idx = idx0;
        head_cnt = sub(bg, idx0);
        tail_idx = add(bg, bn);
        tail_cnt = sub(end0, bg);
        const int sp0 = sidx >= E ? sub(sidx, bn) : sidx;
        n_sidx = bg <= sp0 ? add(sp0, bn) : sp0;
        if (mvk & sact & (scnt > 0))
            use_flag = use_flag | ((bg > sp0) & (bg < add(sp0, scnt))) |
                       overlaps(sidx, scnt, bi, E);
    }

    // A split takes the spare slot if it is free, else flags; both read
    // the pre-step spare activity.
    s.flag |= (int)(use_flag | (split_p & sact));
    if (split_p & !sact) {
        n_idx = head_idx;
        n_cnt = head_cnt;
        n_sidx = tail_idx;
        n_scnt = tail_cnt;
        s.sact = 1;
    }
    s.idx = n_idx;
    s.cnt = op_noop ? 0 : n_cnt;
    s.dst = n_dst;
    s.sidx = n_sidx;
    s.scnt = n_scnt;
}

// Stage the base ops [t0, t0 + T) in shared memory: each entry's code
// (its kind, a move split by the identity test), bi, bn, bj, its end E
// and a move's post-detach attach gap bg.
__device__ __forceinline__ void stage(const Args& a, int t0, int T,
                                      int4* s_op, int2* s_ex) {
    for (int j = threadIdx.x; j < T; j += BLOCK) {
        const int bk = a.bkind[t0 + j];
        const int bi = a.bidx[t0 + j];
        const int bn = a.bcnt[t0 + j];
        const int bj = a.bdst[t0 + j];
        const int E = add(bi, bn);
        const int bg = bj >= E ? sub(bj, bn) : (bj > bi ? bi : bj);
        int code;
        if (bk == K_INSERT) code = C_INSERT;
        else if (bk == K_REMOVE) code = C_REMOVE;
        else if (bk == K_MOVE) code = (bi <= bj && bj <= E) ? C_NOOP : C_MOVE;
        else code = C_OTHER;
        s_op[j] = make_int4(code, bi, bn, bj);
        s_ex[j] = make_int2(E, bg);
    }
}

// The staged entries [0, T) of a tile, in order: one test of the entry's
// code (uniform across the block) picks that code's step; an identity
// base move takes none.
template <int PK>
__device__ __forceinline__ void walk(const int4* s_op, const int2* s_ex,
                                     int T, int kind, State& s) {
#pragma unroll 1  // nvcc's unrolled loop ran slower on an H100
    for (int j = 0; j < T; ++j) {
        const int4 op = s_op[j];  // code, bi, bn, bj
        const int2 ex = s_ex[j];  // E, bg
        if (op.x == C_INSERT)
            rebase_step<PK, C_INSERT>(kind, op.y, op.z, op.w, ex.x, ex.y, s);
        else if (op.x == C_REMOVE)
            rebase_step<PK, C_REMOVE>(kind, op.y, op.z, op.w, ex.x, ex.y, s);
        else if (op.x == C_MOVE)
            rebase_step<PK, C_MOVE>(kind, op.y, op.z, op.w, ex.x, ex.y, s);
        else if (op.x == C_OTHER)
            rebase_step<PK, C_OTHER>(kind, op.y, op.z, op.w, ex.x, ex.y, s);
    }
}

__global__ void __launch_bounds__(BLOCK) rebase_batch(Args a) {
    __shared__ int4 s_op[TILE];  // code, bi, bn, bj
    __shared__ int2 s_ex[TILE];  // E = bi + bn, bg
    __shared__ int4 s_pend[BLOCK];  // by slot: kind, idx, cnt, dst
    __shared__ int s_from[BLOCK];  // by slot: the op's position
    __shared__ int4 s_res[BLOCK];  // by position: idx, cnt, dst, sidx
    __shared__ int2 s_res2[BLOCK];  // by position: scnt, sact | flag << 1
    __shared__ int s_scan[N_CLS * WARPS];  // by class, then warp
    __shared__ int s_seg[WARPS];  // by warp: the segment of slots it takes

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const long long first = (long long)blockIdx.x * BLOCK;
    const int n_live = (int)(a.N - first < BLOCK ? a.N - first : BLOCK);
    const bool valid = tid < n_live;
    const long long n = first + tid;
    int kind = 0, idx = 0, cnt = 0, dst = 0;
    if (valid) {
        kind = a.kind[n];
        idx = a.idx[n];
        cnt = a.cnt[n];
        dst = a.dst[n];
    }
    // The first tile is staged now, its loads in flight with the pending
    // ones; the partition's barriers publish it.
    if (a.M > 0) stage(a, 0, imin(TILE, a.M), s_op, s_ex);

    // Partition the block's ops by class, stably: each lane's rank among
    // its warp's lanes of its class, each warp's count of each class, and
    // (warp 0) the exclusive prefix over (class, warp).
    const int cls = !valid ? CLS_PAST
                           : (kind >= K_INSERT && kind <= K_MOVE ? kind
                                                                 : CLS_OTHER);
    int rank = 0;
#pragma unroll
    for (int c = 0; c < N_CLS; ++c) {
        const unsigned m = __ballot_sync(FULL, cls == c);
        if (cls == c) rank = __popc(m & ((1u << lane) - 1u));
        if (lane == c) s_scan[c * WARPS + warp] = __popc(m);
    }
    __syncthreads();
    if (warp == 0) {
        int carry = 0;
        for (int b = 0; b < N_CLS * WARPS; b += 32) {
            const int i = b + lane;
            const int v = i < N_CLS * WARPS ? s_scan[i] : 0;
            int x = v;
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
                const int y = __shfl_up_sync(FULL, x, d);
                if (lane >= d) x += y;
            }
            if (i < N_CLS * WARPS) s_scan[i] = carry + x - v;
            carry += __shfl_sync(FULL, x, 31);
        }
    }
    __syncthreads();
    const int slot = s_scan[cls * WARPS + warp] + rank;
    s_pend[slot] = make_int4(kind, idx, cnt, dst);
    s_from[slot] = tid;

    // Deal the slots' eight segments of 32 to the warps. Warps w and
    // w + WARPS / 2 issue from one of the SM's four schedulers (warp slot
    // modulo 4), so each scheduler gets the k-th heaviest segment with the
    // k-th lightest, by a rough cost: an insert's step 1, a remove's or a
    // move's 2, a mixed segment's (every kind's step) 3, none past N.
    if (warp == 0) {
        int cost = 0;
        if (lane < WARPS) {
            // the classes of the segment's first and last live slots
            const int lo = lane * 32, hi = imin(lo + 31, n_live - 1);
            int c_lo = 0, c_hi = 0;
#pragma unroll
            for (int c = 1; c < N_CLS; ++c) {
                const int start = s_scan[c * WARPS];  // class c's first slot
                c_lo += start <= lo;
                c_hi += start <= hi;
            }
            cost = lo >= n_live ? 0
                 : c_lo != c_hi || c_lo == CLS_OTHER ? 3
                 : c_lo == K_INSERT ? 1 : 2;
        }
        int order = 0;  // heaviest first; ties by segment
#pragma unroll
        for (int k = 0; k < WARPS; ++k) {
            const int ck = __shfl_sync(FULL, cost, k);
            order += ck > cost || (ck == cost && k < lane);
        }
        if (lane < WARPS)
            s_seg[order < WARPS / 2 ? order : WARPS + WARPS / 2 - 1 - order] =
                lane;
    }
    __syncthreads();

    // This thread's op is the one at its slot; the slots below n_live
    // hold the live ops. A warp whose live lanes share a kind of 0..2
    // steps with that kind's code, any other with every kind's: the OR
    // over the warp of each live lane's kind bit (bit 3 for a kind
    // outside 0..2) has one of bits 0..2 alone exactly then.
    const int my = s_seg[warp] * 32 + lane;
    const bool live = my < n_live;
    const int4 p = s_pend[my];
    const int from = s_from[my];
    const int pk = p.x;
    State s = {p.y, p.z, p.w, 0, 0, 0, 0};
    const unsigned kinds = __reduce_or_sync(
        FULL, !live ? 0u : pk >= K_INSERT && pk <= K_MOVE ? 1u << pk : 8u);
    const int step = kinds == 1u << K_INSERT   ? K_INSERT
                     : kinds == 1u << K_REMOVE ? K_REMOVE
                     : kinds == 1u << K_MOVE   ? K_MOVE
                                               : P_ANY;

    for (int t0 = 0; t0 < a.M; t0 += TILE) {
        const int T = imin(TILE, a.M - t0);
        if (t0 > 0) {
            __syncthreads();  // every thread is done with the previous tile
            stage(a, t0, T, s_op, s_ex);
            __syncthreads();
        }
        if (!live) continue;  // no barrier inside the walk below

        switch (step) {  // uniform across the warp
            case K_INSERT: walk<K_INSERT>(s_op, s_ex, T, pk, s); break;
            case K_REMOVE: walk<K_REMOVE>(s_op, s_ex, T, pk, s); break;
            case K_MOVE: walk<K_MOVE>(s_op, s_ex, T, pk, s); break;
            default: walk<P_ANY>(s_op, s_ex, T, pk, s);
        }
    }

    // Back to the ops' positions, so that the stores are coalesced.
    if (live) {
        s_res[from] = make_int4(s.idx, s.cnt, s.dst, s.sidx);
        s_res2[from] = make_int2(s.scnt, s.sact | s.flag << 1);
    }
    __syncthreads();
    if (valid) {
        const int4 r = s_res[tid];
        const int2 r2 = s_res2[tid];
        a.o_kind[n] = kind;
        a.o_idx[n] = r.x;
        a.o_cnt[n] = r.y;
        a.o_dst[n] = r.z;
        a.o_sidx[n] = r.w;
        a.o_scnt[n] = r2.x;
        a.o_sact[n] = r2.y & 1;
        a.o_flag[n] = r2.y >> 1;
    }
}

}  // namespace

// ptrs: kind, idx, cnt, dst [N]; base kind, idx, cnt, dst [M] (int32);
// out kind, idx, cnt, dst, spare idx, spare cnt [N] (int32), spare active,
// flagged [N] (bytes). Launches on `stream`; returns the CUDA error code
// of the launch (0 when it was accepted).
extern "C" int rebase_batch_launch(int device, int N, int M, int n_ptrs,
                                   void** ptrs, void* stream) {
    if (n_ptrs != N_PTRS || N < 1 || M < 0) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    Args a;
    a.N = N;
    a.M = M;
    a.kind = (const int*)ptrs[0];
    a.idx = (const int*)ptrs[1];
    a.cnt = (const int*)ptrs[2];
    a.dst = (const int*)ptrs[3];
    a.bkind = (const int*)ptrs[4];
    a.bidx = (const int*)ptrs[5];
    a.bcnt = (const int*)ptrs[6];
    a.bdst = (const int*)ptrs[7];
    a.o_kind = (int*)ptrs[8];
    a.o_idx = (int*)ptrs[9];
    a.o_cnt = (int*)ptrs[10];
    a.o_dst = (int*)ptrs[11];
    a.o_sidx = (int*)ptrs[12];
    a.o_scnt = (int*)ptrs[13];
    a.o_sact = (uint8_t*)ptrs[14];
    a.o_flag = (uint8_t*)ptrs[15];
    const unsigned blocks = (unsigned)((N + BLOCK - 1) / BLOCK);
    rebase_batch<<<blocks, BLOCK, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

#ifdef REBASE_STEP_PROBES
// One step of one instantiation over one base-op code, alone, so that its
// instructions can be read in SASS (tools/rebase_sass.py builds these
// with -DREBASE_STEP_PROBES; the library never holds them). The state
// and the staged base terms come in through `in`, the state goes out
// through `out`. K_OUTSIDE fixes a kind outside 0..2 at compile time
// (the kernel runs such ops with P_ANY); the code C_NOOP gives each
// instantiation's loads and stores alone.
namespace rebase_probes {

constexpr int K_OUTSIDE = 3;

template <int PK, int CODE>
__global__ void rebase_step_probe(const int* __restrict__ in,
                                  int* __restrict__ out) {
    State s = {in[1], in[2], in[3], in[4], in[5], in[6], in[7]};
    rebase_step<PK, CODE>(in[0], in[8], in[9], in[10], in[11], in[12], s);
    out[0] = s.idx;
    out[1] = s.cnt;
    out[2] = s.dst;
    out[3] = s.sidx;
    out[4] = s.scnt;
    out[5] = s.sact;
    out[6] = s.flag;
}

#define REBASE_PROBES(PK)                                                  \
    template __global__ void rebase_step_probe<PK, C_INSERT>(const int*,  \
                                                             int*);       \
    template __global__ void rebase_step_probe<PK, C_REMOVE>(const int*,  \
                                                             int*);       \
    template __global__ void rebase_step_probe<PK, C_MOVE>(const int*,    \
                                                           int*);         \
    template __global__ void rebase_step_probe<PK, C_OTHER>(const int*,   \
                                                            int*);        \
    template __global__ void rebase_step_probe<PK, C_NOOP>(const int*, int*);
REBASE_PROBES(K_INSERT)
REBASE_PROBES(K_REMOVE)
REBASE_PROBES(K_MOVE)
REBASE_PROBES(K_OUTSIDE)
REBASE_PROBES(P_ANY)
#undef REBASE_PROBES

}  // namespace rebase_probes
#endif  // REBASE_STEP_PROBES
