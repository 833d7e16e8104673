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
// Design: one thread per pending op. A step reads only the pending op and
// the current base op (no reduction across the pending axis), so each
// thread keeps its eight state values in registers -- kind, index, count,
// dst, spare index, spare count, spare active, flag -- and walks the M
// base ops in order. The block stages the base window in shared memory in
// tiles of TILE ops; every thread then reads the same entry (a broadcast,
// no bank conflict). The terms that depend only on the base op are
// computed once per entry while staging: its end bi + bn, a move's
// post-detach attach gap bg, and a code that folds the base kind with the
// identity-move test. The step branches on that code, which is uniform
// across the block; the per-pending-kind selects stay predicated, so a
// warp of mixed kinds never diverges. An identity base move leaves every
// field as it was, so its code skips the step. Pending ops are loaded and
// stored one int32 column at a time (coalesced); the two flag columns are
// written as bytes and read as torch.bool.
//
// Bound on an H100: operations. Per launch the pending columns are read
// once (16 bytes an op) and the outputs written once (26 bytes an op):
// 4.2 MB at config 4 (N 100,000), ~1.25 us at 3.35 TB/s. A step needs
// 6-44 integer instructions per pending op, by the base op's code and
// the pending op's own kind (the table and its derivation are
// REBASE_OPS in chip_smoke.py): ~21 an op-rebase at config 4, ~8 us for
// 100,000 x 64 steps at the card's int32 rate. A warp of mixed pending
// kinds runs every kind's branch, so the kernel does more than that.
// At config 4 the grid is 782 blocks of 128 threads, one wave on 132
// SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K_INSERT = 0;
constexpr int K_REMOVE = 1;
constexpr int K_MOVE = 2;
// Staged base-op codes: the base kind, with a move split by the identity
// test and every other kind value apart (the reference moves gaps over it
// as over a move, with none of a move's flags, splits or attach shifts).
constexpr int C_INSERT = 0;
constexpr int C_REMOVE = 1;
constexpr int C_MOVE = 2;
constexpr int C_OTHER = 3;
constexpr int C_NOOP = 4;  // identity base move: adjusts nothing
constexpr int THREADS = 128;  // THREADS in tree/rebase_kernel.py
constexpr int TILE = 1024;  // base ops staged at a time (24 KB)
constexpr int N_PTRS = 16;

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
// the block's start (the adjacency tie keeps its side).
__device__ __forceinline__ int gap_move(int g, int bi, int bn, int E,
                                        int bg) {
    if (bi < g && g < E) return add(bg, sub(g, bi));
    const int g1 = gap_remove(g, bi, bn);
    const bool shift = bg < g1 || (bg == g1 && g != bi);
    return shift ? add(g1, bn) : g1;
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

__global__ void __launch_bounds__(THREADS) rebase_batch(Args a) {
    __shared__ int4 s_op[TILE];  // code, bi, bn, bj
    __shared__ int2 s_ex[TILE];  // E = bi + bn, bg

    const long long n = (long long)blockIdx.x * THREADS + threadIdx.x;
    const bool valid = n < a.N;
    int kind = 0, idx = 0, cnt = 0, dst = 0;
    if (valid) {
        kind = a.kind[n];
        idx = a.idx[n];
        cnt = a.cnt[n];
        dst = a.dst[n];
    }
    int sidx = 0, scnt = 0;
    bool sact = false, flag = false;
    const bool p_ins = kind == K_INSERT;
    const bool p_rem = kind == K_REMOVE;
    const bool p_mv = kind == K_MOVE;

    for (int t0 = 0; t0 < a.M; t0 += TILE) {
        const int T = imin(TILE, a.M - t0);
        __syncthreads();  // every thread is done with the previous tile
        for (int j = threadIdx.x; j < T; j += THREADS) {
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
        __syncthreads();
        if (!valid) continue;  // no barrier inside the walk below

        for (int j = 0; j < T; ++j) {
            const int4 op = s_op[j];
            const int code = op.x;
            if (code == C_NOOP) continue;
            const int bi = op.y, bn = op.z, bj = op.w;
            const int2 ex = s_ex[j];
            const int E = ex.x, bg = ex.y;

            const bool live = cnt > 0;
            // a pending identity move mutes, judged on the pre-step values
            const int pend = add(idx, cnt);
            const bool op_noop = p_mv && idx <= dst && dst <= pend;
            int n_idx, n_cnt = cnt, n_dst = dst, n_sidx, n_scnt = scnt;
            bool split_p = false, use_flag = false;
            int head_idx = 0, head_cnt = 0, tail_idx = 0, tail_cnt = 0;

            if (code == C_INSERT) {
                // Every pending kind's index shifts when bi is at or
                // before it; content landing strictly inside a move's
                // block is absorbed, inside a remove's range splits it.
                n_idx = bi <= idx ? add(idx, bn) : idx;
                const bool inside = bi > idx && bi < pend;
                if (p_mv) {
                    if (inside) n_cnt = add(cnt, bn);
                    n_dst = bi <= dst ? add(dst, bn) : dst;
                }
                split_p = p_rem && live && inside;
                head_idx = idx;
                head_cnt = sub(bi, idx);
                tail_idx = E;
                tail_cnt = sub(pend, bi);
                n_sidx = bi <= sidx ? add(sidx, bn) : sidx;
                use_flag = sact && scnt > 0 && bi > sidx &&
                           bi < add(sidx, scnt);
            } else if (code == C_REMOVE) {
                // Gaps slide; ranges (remove, move, other kinds) are
                // clipped: the overlap is gone already.
                n_idx = gap_remove(idx, bi, bn);
                if (!p_ins) n_cnt = sub(cnt, overlap_len(idx, cnt, bi, E));
                if (p_mv) n_dst = gap_remove(dst, bi, bn);
                n_sidx = gap_remove(sidx, bi, bn);
                n_scnt = sub(scnt, overlap_len(sidx, scnt, bi, E));
            } else {  // C_MOVE, or C_OTHER: positions only
                const bool mvk = code == C_MOVE;
                const int idx0 = idx >= E ? sub(idx, bn) : idx;  // detach slide
                const int end0 = add(idx0, cnt);
                if (p_ins) {
                    n_idx = gap_move(idx, bi, bn, E, bg);
                } else if (p_mv) {
                    n_idx = bg <= idx0 ? add(idx0, bn) : idx0;
                    if (bg > idx0 && bg < end0) n_cnt = add(cnt, bn);
                    n_dst = gap_move(dst, bi, bn, E, bg);
                    // competing node claims, or mutual containment
                    use_flag = mvk && live &&
                               (overlaps(idx, cnt, bi, E) ||
                                (bi < dst && dst < E && idx < bj &&
                                 bj < pend));
                } else {
                    // a range fully inside the block travels with it
                    const bool full = idx >= bi && pend <= E;
                    n_idx = full ? add(bg, sub(idx, bi)) : idx0;
                    if (mvk && p_rem && live) {
                        if (overlap_len(idx, cnt, bi, E) > 0) {
                            use_flag = !full;  // 3-piece overlap
                        } else {
                            if (bg <= idx0) n_idx = add(n_idx, bn);  // attach shift
                            split_p = bg > idx0 && bg < end0;
                        }
                    }
                }
                head_idx = idx0;
                head_cnt = sub(bg, idx0);
                tail_idx = add(bg, bn);
                tail_cnt = sub(end0, bg);
                const int sp0 = sidx >= E ? sub(sidx, bn) : sidx;
                n_sidx = bg <= sp0 ? add(sp0, bn) : sp0;
                if (mvk && sact && scnt > 0)
                    use_flag = use_flag ||
                               (bg > sp0 && bg < add(sp0, scnt)) ||
                               overlaps(sidx, scnt, bi, E);
            }

            // A split takes the spare slot if it is free, else flags; both
            // read the pre-step spare activity.
            flag = flag || use_flag || (split_p && sact);
            if (split_p && !sact) {
                n_idx = head_idx;
                n_cnt = head_cnt;
                n_sidx = tail_idx;
                n_scnt = tail_cnt;
                sact = true;
            }
            idx = n_idx;
            cnt = op_noop ? 0 : n_cnt;
            dst = n_dst;
            sidx = n_sidx;
            scnt = n_scnt;
        }
    }

    if (valid) {
        a.o_kind[n] = kind;
        a.o_idx[n] = idx;
        a.o_cnt[n] = cnt;
        a.o_dst[n] = dst;
        a.o_sidx[n] = sidx;
        a.o_scnt[n] = scnt;
        a.o_sact[n] = sact ? 1 : 0;
        a.o_flag[n] = flag ? 1 : 0;
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
    const unsigned blocks = (unsigned)((N + THREADS - 1) / THREADS);
    rebase_batch<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
