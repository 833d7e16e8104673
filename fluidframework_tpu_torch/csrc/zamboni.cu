// Row-model zamboni for Hopper (sm_90a): a device-wide, stable,
// multi-column compaction of one segment table, in five short launches.
//
// Replaces the XLA function `zamboni_device`
// (fluidframework_tpu/ops/zamboni.py:42). Its plain PyTorch version is
// `ops/zamboni.zamboni_device_ref`, which it must equal on every row,
// n_rows and error, bit for bit. Under the applied MSN `min_seq`:
//
// - rows idx < n_rows are live (every row when n_rows passes C); a live
//   row survives unless it was removed at or below the MSN; survivors
//   pack to the front in order;
// - a packed row is settled when it is not removed and was inserted at
//   or below the MSN; a settled row merges into the packed row before
//   it when that one is settled too, every prop is equal and the
//   previous row's text ends where this one's starts
//   (buf_start + length, int32); a run keeps its first row's fields and
//   the int32 sum of its lengths;
// - output rows at and above the run count m take the empty-row fills;
//   n_rows = m and the error word passes through.
//
// Design. The table is cut into tiles of TILE = 1024 rows, one block of
// NT = 256 threads a tile, each thread owning 4 consecutive rows. The
// phases need results from every tile before them, so each phase is a
// launch of G = ceil(C / TILE) blocks (zb_write: of 8 G blocks of
// WTILE rows) and the launches' order on the
// stream is the only synchronisation (no grid barrier, no atomics; every
// destination is written by one thread):
//
//   1. zb_keep:   keep flags, the tile's count of kept rows;
//   2. zb_pack:   the tile's offset (the counts of the tiles before it)
//                 plus a block scan give each kept row its packed index;
//                 the row's source index goes there (`src`);
//   3. zb_starts: on the packed rows, the run-start flag (the previous
//                 packed row is src[d - 1], in this tile or the one
//                 before), the tile's count of starts and its sum of
//                 lengths (unsigned, so wrapping matches int32);
//   4. zb_runs:   tile offsets plus block scans give each start row its
//                 run index r and the lengths' exclusive prefix; run r
//                 records its first source row and that prefix; block 0
//                 records m and the total length;
//   5. zb_write:  output row r < m copies its first source row's fields,
//                 its length being the difference of the next run's
//                 prefix (or the total) and its own; rows >= m take the
//                 fills. The 2-D columns are written element by element
//                 so that neighbouring threads write neighbouring ints.
//                 Its blocks take WTILE = 128 rows each (8 G blocks), so
//                 that a thread's chain of dependent gathers (first[r],
//                 then the row) is short: with 1024 rows a block, the
//                 blocks holding the runs walked 128 such chains a
//                 thread and set the call's time (0.0651 ms at C 131072,
//                 KR 24, KK 8 on an NVIDIA H100 80GB HBM3, 700 W).
//
// Scratch (the wrapper allocates it, int32): 3 G tile values, 4 C row
// values (src, start flags, run firsts, run prefixes) and 2 totals.
//
// What bounds it on this card: bytes, at 3.35 TB/s. The function must
// read rem_seq of every live row (the keep test), buf_start, length,
// ins_seq and the KK props of the kept rows (the merge test) and
// ins_client and the KR removers of the run firsts alone, and write all
// C rows of 5 + KR + KK int32 columns once; at C 131072, KR 24 and KK 8
// the writes alone are 19.4 MB, about 5.8 us. The design reads rem_seq
// twice more and the merge test's columns (buf_start, length, ins_seq,
// rem_seq, props) of the kept rows and their neighbours, but moves the
// wide rem_clients column only through the gather of run firsts in
// zb_write, and its scratch traffic is 4 ints a row. At small C five launches of a few
// microseconds each dominate; one cooperative launch with grid barriers
// would save that, and is left for later work.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;          // threads a block
constexpr int RPT = 4;           // rows a thread
constexpr int TILE = NT * RPT;   // rows a block
constexpr int WTILE = 128;       // rows a block of zb_write
constexpr int WARPS = NT / 32;
constexpr int NOT_REMOVED = 2147483647;
constexpr int NO_CLIENT = -3;
constexpr int PROP_ABSENT = -1;
constexpr int N_PTRS = 20;

struct Args {
    int C, KR, KK, G;
    const int* n_rows_in;
    const int* err_in;
    const int* min_seq;
    const int* col[5];  // buf_start, length, ins_seq, ins_client, rem_seq
    const int* rcl;     // [C, KR]
    const int* props;   // [C, KK]
    int* out[5];
    int* rcl_out;
    int* props_out;
    int* n_rows_out;
    int* err_out;
    int* tile_keep;      // [G]
    int* tile_start;     // [G]
    unsigned* tile_len;  // [G]
    int* src;            // [C] packed row -> source row
    int* start;          // [C] run-start flag of each packed row
    int* first;          // [C] run -> source row of its first row
    unsigned* lenx;      // [C] run -> exclusive length prefix
    int* totals;         // [2] m, total length
};

// Exclusive block scan of one unsigned value a thread; `tot` gets the
// block's sum. `sh` holds WARPS + 1 ints of shared memory.
__device__ unsigned block_scan(unsigned v, unsigned* sh, unsigned* tot) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    unsigned x = v;
    for (int o = 1; o < 32; o <<= 1) {
        const unsigned y = (unsigned)__shfl_up_sync(0xffffffffu, (int)x, o);
        if (lane >= o) x += y;
    }
    if (lane == 31) sh[warp] = x;
    __syncthreads();
    if (warp == 0) {
        unsigned w = lane < WARPS ? sh[lane] : 0u;
        for (int o = 1; o < 32; o <<= 1) {
            const unsigned y = (unsigned)__shfl_up_sync(0xffffffffu, (int)w, o);
            if (lane >= o) w += y;
        }
        if (lane < WARPS) sh[lane] = w;  // inclusive warp prefixes
    }
    __syncthreads();
    const unsigned before = warp ? sh[warp - 1] : 0u;
    *tot = sh[WARPS - 1];
    __syncthreads();  // `sh` may be reused right after
    return before + x - v;
}

// Sum of a[0 .. n) over the block (every thread gets it).
__device__ unsigned block_sum(const unsigned* a, int n, unsigned* sh) {
    unsigned s = 0;
    for (int i = threadIdx.x; i < n; i += NT) s += a[i];
    unsigned tot;
    block_scan(s, sh, &tot);
    return tot;
}

__device__ bool kept(const Args& a, int i, int n, int msn) {
    if (i >= a.C || i >= n) return false;
    const int rs = a.col[4][i];
    return !(rs != NOT_REMOVED && rs <= msn);
}

__global__ void zb_keep(Args a) {
    extern __shared__ __align__(16) int smem[];
    unsigned* sh = reinterpret_cast<unsigned*>(smem);
    const int n = *a.n_rows_in, msn = *a.min_seq;
    const int row0 = blockIdx.x * TILE + threadIdx.x * RPT;
    unsigned c = 0;
    for (int j = 0; j < RPT; ++j) c += kept(a, row0 + j, n, msn) ? 1u : 0u;
    unsigned tot;
    block_scan(c, sh, &tot);
    if (threadIdx.x == 0) a.tile_keep[blockIdx.x] = (int)tot;
}

__global__ void zb_pack(Args a) {
    extern __shared__ __align__(16) int smem[];
    unsigned* sh = reinterpret_cast<unsigned*>(smem);
    const int n = *a.n_rows_in, msn = *a.min_seq;
    const unsigned base = block_sum(
        reinterpret_cast<const unsigned*>(a.tile_keep), blockIdx.x, sh);
    const int row0 = blockIdx.x * TILE + threadIdx.x * RPT;
    bool k[RPT];
    unsigned c = 0;
    for (int j = 0; j < RPT; ++j) {
        k[j] = kept(a, row0 + j, n, msn);
        c += k[j] ? 1u : 0u;
    }
    unsigned tot;
    unsigned pos = base + block_scan(c, sh, &tot);
    for (int j = 0; j < RPT; ++j)
        if (k[j]) a.src[pos++] = row0 + j;
}

__device__ bool settled(const Args& a, int s, int msn) {
    return a.col[4][s] == NOT_REMOVED && a.col[2][s] <= msn;
}

__global__ void zb_starts(Args a) {
    extern __shared__ __align__(16) int smem[];
    unsigned* sh = reinterpret_cast<unsigned*>(smem);
    const int msn = *a.min_seq;
    const int n_keep = (int)block_sum(
        reinterpret_cast<const unsigned*>(a.tile_keep), a.G, sh);
    const int row0 = blockIdx.x * TILE + threadIdx.x * RPT;
    unsigned c = 0, len = 0;
    for (int j = 0; j < RPT; ++j) {
        const int d = row0 + j;
        if (d >= a.C) break;
        int st = 0;
        if (d < n_keep) {
            const int s = a.src[d];
            len += (unsigned)a.col[1][s];
            st = 1;
            if (d > 0 && settled(a, s, msn)) {
                const int p = a.src[d - 1];
                if (settled(a, p, msn) &&
                    (unsigned)a.col[0][p] + (unsigned)a.col[1][p] ==
                        (unsigned)a.col[0][s]) {
                    bool same = true;
                    const int* ps = a.props + (long long)s * a.KK;
                    const int* pp = a.props + (long long)p * a.KK;
                    for (int k = 0; k < a.KK && same; ++k) same = ps[k] == pp[k];
                    st = same ? 0 : 1;
                }
            }
        }
        a.start[d] = st;
        c += (unsigned)st;
    }
    unsigned tot_c, tot_len;
    block_scan(c, sh, &tot_c);
    block_scan(len, sh, &tot_len);
    if (threadIdx.x == 0) {
        a.tile_start[blockIdx.x] = (int)tot_c;
        a.tile_len[blockIdx.x] = tot_len;
    }
}

__global__ void zb_runs(Args a) {
    extern __shared__ __align__(16) int smem[];
    unsigned* sh = reinterpret_cast<unsigned*>(smem);
    const int n_keep = (int)block_sum(
        reinterpret_cast<const unsigned*>(a.tile_keep), a.G, sh);
    const unsigned base_r = block_sum(
        reinterpret_cast<const unsigned*>(a.tile_start), blockIdx.x, sh);
    const unsigned base_len = block_sum(a.tile_len, blockIdx.x, sh);
    const int row0 = blockIdx.x * TILE + threadIdx.x * RPT;
    int st[RPT];
    unsigned ln[RPT];
    unsigned c = 0, len = 0;
    for (int j = 0; j < RPT; ++j) {
        const int d = row0 + j;
        const bool v = d < a.C && d < n_keep;
        st[j] = v ? a.start[d] : 0;
        ln[j] = v ? (unsigned)a.col[1][a.src[d]] : 0u;
        c += (unsigned)st[j];
        len += ln[j];
    }
    unsigned tot;
    unsigned r = base_r + block_scan(c, sh, &tot);
    unsigned pre = base_len + block_scan(len, sh, &tot);
    for (int j = 0; j < RPT; ++j) {
        if (st[j]) {
            a.first[r] = a.src[row0 + j];
            a.lenx[r] = pre;
            ++r;
        }
        pre += ln[j];
    }
    if (blockIdx.x == 0) {
        const unsigned m = block_sum(
            reinterpret_cast<const unsigned*>(a.tile_start), a.G, sh);
        const unsigned total = block_sum(a.tile_len, a.G, sh);
        if (threadIdx.x == 0) {
            a.totals[0] = (int)m;
            a.totals[1] = (int)total;
        }
    }
}

__global__ void zb_write(Args a) {
    const int m = a.totals[0];
    const unsigned total = (unsigned)a.totals[1];
    const int lo = blockIdx.x * WTILE;
    const int hi = lo + WTILE < a.C ? lo + WTILE : a.C;
    const int r = lo + (int)threadIdx.x;
    if (r < hi) {
        if (r < m) {
            const int s = a.first[r];
            const unsigned next = r + 1 < m ? a.lenx[r + 1] : total;
            a.out[0][r] = a.col[0][s];
            a.out[1][r] = (int)(next - a.lenx[r]);
            a.out[2][r] = a.col[2][s];
            a.out[3][r] = a.col[3][s];
            a.out[4][r] = a.col[4][s];
        } else {
            a.out[0][r] = 0;
            a.out[1][r] = 0;
            a.out[2][r] = 0;
            a.out[3][r] = NO_CLIENT;
            a.out[4][r] = NOT_REMOVED;
        }
    }
    const int width[2] = {a.KR, a.KK};
    const int* in2[2] = {a.rcl, a.props};
    int* out2[2] = {a.rcl_out, a.props_out};
    const int fill[2] = {NO_CLIENT, PROP_ABSENT};
    for (int c = 0; c < 2; ++c) {
        const int w = width[c];
        int* out = out2[c] + (long long)lo * w;
        for (int i = threadIdx.x; i < (hi - lo) * w; i += NT) {
            const int rr = lo + i / w;
            const int k = i - (rr - lo) * w;
            out[i] = rr < m ? in2[c][(long long)a.first[rr] * w + k] : fill[c];
        }
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) {
        *a.n_rows_out = m;
        *a.err_out = *a.err_in;
    }
}

}  // namespace

// ptrs: n_rows, error, min_seq, buf_start, length, ins_seq, ins_client,
// rem_seq, rem_clients, props (inputs); buf_start, length, ins_seq,
// ins_client, rem_seq, rem_clients, props, n_rows, error (outputs);
// the int32 scratch of 3 G + 4 C + 2 ints (20 pointers).
extern "C" int zamboni_launch(int device, int C, int KR, int KK, int G,
                              int n_ptrs, void** ptrs, void* stream) {
    if (n_ptrs != N_PTRS || C <= 0 || KR < 0 || KK < 0 ||
        G != (C + TILE - 1) / TILE)
        return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    Args a;
    a.C = C;
    a.KR = KR;
    a.KK = KK;
    a.G = G;
    a.n_rows_in = (const int*)ptrs[0];
    a.err_in = (const int*)ptrs[1];
    a.min_seq = (const int*)ptrs[2];
    for (int c = 0; c < 5; ++c) a.col[c] = (const int*)ptrs[3 + c];
    a.rcl = (const int*)ptrs[8];
    a.props = (const int*)ptrs[9];
    for (int c = 0; c < 5; ++c) a.out[c] = (int*)ptrs[10 + c];
    a.rcl_out = (int*)ptrs[15];
    a.props_out = (int*)ptrs[16];
    a.n_rows_out = (int*)ptrs[17];
    a.err_out = (int*)ptrs[18];
    int* scratch = (int*)ptrs[19];
    a.tile_keep = scratch;
    a.tile_start = scratch + G;
    a.tile_len = (unsigned*)(scratch + 2 * G);
    a.src = scratch + 3 * G;
    a.start = a.src + C;
    a.first = a.start + C;
    a.lenx = (unsigned*)(a.first + C);
    a.totals = (int*)(a.lenx + C);
    cudaStream_t s = (cudaStream_t)stream;
    const size_t smem = 4 * (WARPS + 1);
    zb_keep<<<G, NT, (size_t)smem, s>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    zb_pack<<<G, NT, (size_t)smem, s>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    zb_starts<<<G, NT, (size_t)smem, s>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    zb_runs<<<G, NT, (size_t)smem, s>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    const int GW = (C + WTILE - 1) / WTILE;
    zb_write<<<GW, NT, (size_t)smem, s>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    return 0;
}
