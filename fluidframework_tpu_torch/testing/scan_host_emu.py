"""The row-model scan's CUDA source run on the host, for CPU tests.

`build` compiles ``csrc/mergetree_scan.cu`` with g++ against an
emulation of the CUDA features it uses (`EMU_HEADER`): every CUDA
thread of a block is an OS thread, ``__syncthreads`` and named barrier
1 (``bar.sync`` / ``bar.red.or.pred``) are counting barriers, and the
warp shuffles and votes are exchanges behind a barrier of the warp's
32 threads. The blocks run one after another; shared memory and the
outputs start as garbage, as on the card. The header also emulates
what the other kernels' sources use: thread-block clusters (the CTAs
of a cluster run at once, each with its own shared memory; a split
cluster barrier; distributed shared memory as a pointer into another
rank's), mbarriers with transaction bytes, ``cp.async`` and the bulk
copy as a copy plus its arrival, and ``cudaLaunchKernelEx`` with
cluster dimensions and programmatic dependent launches. Its two ``asm`` barriers and
its launch are rewritten (`translate`); nothing else of the source
changes, so the tests hold the kernel's own logic (the op loops, the
layouts, the copies of the live rows) against the plain version
without a card. Timing means nothing here.

`run_docs` launches the emulated kernel through the same C entry and
the same allocations as `ops/mergetree_scan.MergetreeScanKernel.docs`,
on CPU tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from typing import Tuple

import torch

from ..ops import _build
from ..ops import mergetree_scan as tms
from ..ops.mergetree_kernel import OpBatch, SegmentTable

EMU_DIR = os.path.join(os.path.dirname(_build.BUILD_DIR), "scan_host_emu")
GXX_FLAGS = ("-std=c++17", "-O1", "-shared", "-fPIC", "-pthread",
             "-Wno-unknown-pragmas")
GARBAGE = -777  # the outputs' first value: rows left unwritten show it

EMU_HEADER = r"""
#pragma once
#include <stdint.h>
#include <stddef.h>
#include <condition_variable>
#include <cstring>
#include <map>
#include <mutex>
#include <thread>
#include <vector>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(x)
#define __shared__
#define __align__(x)
struct int4 { int x, y, z, w; };
struct Dim3 { unsigned x, y, z; };
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
// A counting barrier of n threads that also ors a predicate.
struct EmuBar {
    std::mutex m; std::condition_variable cv;
    int gen = 0, arrived = 0; bool acc = false, res = false;
    bool wait(int n, bool p = false) {
        std::unique_lock<std::mutex> l(m);
        const int g = gen;
        acc |= p;
        if (++arrived == n) {
            arrived = 0; res = acc; acc = false; ++gen; cv.notify_all();
            return res;
        }
        cv.wait(l, [&] { return gen != g; });
        return res;
    }
    // The split form: arrive returns the phase that `wait_phase` waits out.
    int arrive(int n) {
        std::lock_guard<std::mutex> l(m);
        const int g = gen;
        if (++arrived == n) { arrived = 0; ++gen; cv.notify_all(); }
        return g;
    }
    void wait_phase(int g) {
        std::unique_lock<std::mutex> l(m);
        cv.wait(l, [&] { return gen != g; });
    }
};
// An mbarrier: `count` arrivals and the expected transaction bytes
// complete a phase.
struct EmuMbar { int count = 0, pending = 0; long long tx = 0; unsigned phase = 0; };
struct EmuWarp { EmuBar b; long long buf[32]; };
struct EmuBlock {
    EmuBar b0, b1; EmuWarp w[32];
    std::mutex mm; std::condition_variable mcv;
    std::map<const void*, EmuMbar> mbar;
};
// The CTAs of one cluster run at once; `smem` holds each rank's shared
// memory, so distributed shared memory is a pointer into another rank's.
struct EmuCluster { EmuBar bar; int n = 0; std::vector<int*> smem; };
static thread_local Dim3 threadIdx, blockIdx;
static thread_local EmuBlock* emu_block;
static thread_local int* emu_smem;
static thread_local EmuCluster* emu_cluster;
static thread_local unsigned emu_rank;
static thread_local int emu_cluster_phase;
static int emu_nt;
// How a launch runs its clusters: 0 one after another in blockIdx
// order, 1 in its reverse, 2 all at once.
static int emu_order = 0;
extern "C" void emu_set_order(int o) { emu_order = o; }
static std::mutex emu_atomic;
inline int emu_lane() { return threadIdx.x & 31; }
inline EmuWarp& emu_warp() { return emu_block->w[threadIdx.x >> 5]; }
inline long long emu_xchg(long long v, int src) {
    EmuWarp& w = emu_warp();
    w.buf[emu_lane()] = v; w.b.wait(32);
    const long long r = w.buf[src]; w.b.wait(32);
    return r;
}
inline int __shfl_up_sync(unsigned, int v, int o) {
    const int l = emu_lane();
    return (int)emu_xchg(v, l >= o ? l - o : l);
}
inline int __shfl_sync(unsigned, int v, int s) { return (int)emu_xchg(v, s & 31); }
inline int __shfl_xor_sync(unsigned, int v, int m) {
    return (int)emu_xchg(v, emu_lane() ^ (m & 31));
}
inline int __shfl_down_sync(unsigned, int v, int o) {
    const int l = emu_lane();
    return (int)emu_xchg(v, l + o < 32 ? l + o : l);
}
inline unsigned __ballot_sync(unsigned, int p) {
    EmuWarp& w = emu_warp();
    w.buf[emu_lane()] = p ? 1 : 0; w.b.wait(32);
    unsigned r = 0;
    for (int k = 0; k < 32; ++k) r |= (unsigned)(w.buf[k] != 0) << k;
    w.b.wait(32);
    return r;
}
inline bool __any_sync(unsigned m, int p) { return __ballot_sync(m, p) != 0; }
inline int __ffs(unsigned v) { return __builtin_ffs(v); }
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __clz(int v) { return v ? __builtin_clz((unsigned)v) : 32; }
inline void __syncthreads() { emu_block->b0.wait(emu_nt); }
inline void __syncwarp() { emu_warp().b.wait(32); }
inline void emu_bar1(int n) { emu_block->b1.wait(n); }
inline bool emu_bar1_or(bool p, int n) { return emu_block->b1.wait(n, p); }
inline unsigned long long atomicMin(unsigned long long* a, unsigned long long v) {
    std::lock_guard<std::mutex> l(emu_atomic);
    const unsigned long long o = *a;
    if (v < o) *a = v;
    return o;
}
inline int atomicAdd(int* a, int v) {
    std::lock_guard<std::mutex> l(emu_atomic);
    const int o = *a;
    *a = o + v;
    return o;
}
// A release store and an acquire load of a status word another block
// reads or wrote.
inline void emu_st_release(int* p, int v) {
    std::lock_guard<std::mutex> l(emu_atomic);
    *p = v;
}
inline int emu_ld_acquire(const int* p) {
    std::lock_guard<std::mutex> l(emu_atomic);
    return *p;
}
// Clusters: the rank, the split cluster barrier over all the cluster's
// threads, and `p`'s offset in rank `r`'s shared memory.
inline unsigned emu_cluster_rank() { return emu_rank; }
inline void emu_cluster_arrive() {
    emu_cluster_phase = emu_cluster->bar.arrive(emu_cluster->n);
}
inline void emu_cluster_wait() { emu_cluster->bar.wait_phase(emu_cluster_phase); }
template <class T> T* emu_dsmem(T* p, unsigned r) {
    return (T*)((const char*)emu_cluster->smem[r]
                + ((const char*)p - (const char*)emu_smem));
}
// mbarriers of this CTA, by address; an asynchronous copy is a copy and
// then its transaction bytes on the barrier.
inline void emu_mbar_done(EmuMbar& b) {
    if (b.pending == 0 && b.tx == 0) {
        ++b.phase; b.pending = b.count; emu_block->mcv.notify_all();
    }
}
inline void emu_mbar_init(const void* p, unsigned n) {
    std::lock_guard<std::mutex> l(emu_block->mm);
    EmuMbar& b = emu_block->mbar[p];
    b = EmuMbar(); b.count = b.pending = (int)n;
}
inline void emu_mbar_arrive_tx(const void* p, unsigned bytes) {
    std::lock_guard<std::mutex> l(emu_block->mm);
    EmuMbar& b = emu_block->mbar.at(p);
    b.tx += bytes; --b.pending;
    emu_mbar_done(b);
}
inline void emu_mbar_wait(const void* p, unsigned parity) {
    std::unique_lock<std::mutex> l(emu_block->mm);
    EmuMbar& b = emu_block->mbar.at(p);
    emu_block->mcv.wait(l, [&] { return (b.phase & 1u) != (parity & 1u); });
}
inline void emu_bulk_copy(void* dst, const void* src, unsigned bytes,
                          const void* p) {
    std::memcpy(dst, src, bytes);
    std::lock_guard<std::mutex> l(emu_block->mm);
    EmuMbar& b = emu_block->mbar.at(p);
    b.tx -= bytes;
    emu_mbar_done(b);
}
inline void emu_cp_async(void* dst, const void* src, unsigned bytes) {
    std::memcpy(dst, src, bytes);
}
inline long long clock64() { return 0; }
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaFuncSetAttribute(const void*, int, int) { return cudaSuccess; }
template <class T> cudaError_t cudaMemcpyToSymbol(T&, const void*, size_t) {
    return cudaSuccess;
}
// A launch of n_ctas CTAs of NT threads in clusters of G: each cluster's
// CTAs run at once, every thread an OS thread; the clusters one after
// another in blockIdx order, in its reverse, or all at once
// (`emu_set_order`). Shared memory starts as garbage, as on the card.
struct EmuClusterRun {
    EmuCluster cl;
    std::vector<EmuBlock*> blocks;
    std::vector<std::vector<int>> sms;
    std::vector<std::thread> ts;
};
template <class A>
void emu_start_cluster(EmuClusterRun& r, void (*k)(A), unsigned c0, int NT,
                       size_t words, int G, A a) {
    r.cl.n = G * NT;
    r.sms.assign(G, std::vector<int>(words));
    for (int g = 0; g < G; ++g) {
        r.blocks.push_back(new EmuBlock());
        std::memset(r.sms[g].data(), 0xAB, words * 4);
        r.cl.smem.push_back(r.sms[g].data());
    }
    for (int g = 0; g < G; ++g)
        for (int t = 0; t < NT; ++t)
            r.ts.emplace_back([=, &r] {
                threadIdx = {(unsigned)t, 0, 0};
                blockIdx = {c0 + (unsigned)g, 0, 0};
                emu_block = r.blocks[g];
                emu_smem = r.cl.smem[g];
                emu_cluster = &r.cl;
                emu_rank = (unsigned)g;
                k(a);
            });
}
inline void emu_join_cluster(EmuClusterRun& r) {
    for (auto& t : r.ts) t.join();
    for (EmuBlock* b : r.blocks) delete b;
}
template <class A>
void emu_launch_cluster(void (*k)(A), unsigned n_ctas, int NT, size_t smem,
                        int G, A a) {
    emu_nt = NT;
    const size_t words = (smem + 3) / 4 + 4;
    const unsigned n_cl = (n_ctas + (unsigned)G - 1) / (unsigned)G;
    std::vector<EmuClusterRun> runs(n_cl);
    for (unsigned q = 0; q < n_cl; ++q) {
        const unsigned c = emu_order == 1 ? n_cl - 1 - q : q;
        emu_start_cluster(runs[c], k, c * (unsigned)G, NT, words, G, a);
        if (emu_order != 2) emu_join_cluster(runs[c]);
    }
    if (emu_order == 2)
        for (auto& r : runs) emu_join_cluster(r);
}
template <class A>
void emu_launch(void (*k)(A), unsigned D, int NT, size_t smem, A a) {
    emu_launch_cluster(k, D, NT, smem, 1, a);
}
// The extended launch API: programmatic dependent launches (a launch
// runs its CTAs once the launch before has ended, so the device side's
// wait and trigger do nothing) and cluster dimensions (G along x).
struct dim3 {
    unsigned x, y, z;
    dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
enum cudaLaunchAttributeID {
    cudaLaunchAttributeClusterDimension = 4,
    cudaLaunchAttributeProgrammaticStreamSerialization = 5 };
union cudaLaunchAttributeValue {
    int programmaticStreamSerializationAllowed;
    struct { unsigned x, y, z; } clusterDim;
};
struct cudaLaunchAttribute {
    cudaLaunchAttributeID id; cudaLaunchAttributeValue val; };
struct cudaLaunchConfig_t {
    dim3 gridDim, blockDim; size_t dynamicSmemBytes; cudaStream_t stream;
    cudaLaunchAttribute* attrs; unsigned numAttrs; };
template <class A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* c, void (*k)(A),
                               A a) {
    unsigned G = 1;
    for (unsigned i = 0; i < c->numAttrs; ++i)
        if (c->attrs[i].id == cudaLaunchAttributeClusterDimension)
            G = c->attrs[i].val.clusterDim.x;
    if (G < 1 || c->gridDim.x % G) return cudaErrorInvalidValue;
    emu_launch_cluster(k, c->gridDim.x, (int)c->blockDim.x,
                       c->dynamicSmemBytes, (int)G, a);
    return cudaSuccess;
}
"""


def translate(src: str) -> str:
    """The kernel source with its named-barrier ``asm`` and its launch
    rewritten for `EMU_HEADER`; raises if either is not found."""
    bar = 'asm volatile("bar.sync 1, %0;" ::"r"(nw * 32) : "memory");'
    if bar not in src:
        raise ValueError("scan_host_emu: the named barrier was not found")
    src = src.replace(bar, "emu_bar1(nw * 32);")
    i = src.index("        unsigned r;\n        asm volatile(")
    j = src.index("return r != 0;", i) + len("return r != 0;")
    src = src[:i] + "        return emu_bar1_or(p, nw * 32);" + src[j:]
    src = src.replace("extern __shared__ __align__(16) int smem[];",
                      "int* smem = emu_smem;")
    src = re.sub(r"(\w+)<<<\s*(.*?),\s*(\w+),\s*(\(size_t\)smem),\s*.*?>>>"
                 r"\((\w+)\);", r"emu_launch(\1, \2, \3, \4, \5);", src,
                 flags=re.S)
    if "asm" in src or "<<<" in src:
        raise ValueError("scan_host_emu: the source has untranslated parts")
    return src


def gxx_path() -> str:
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found: the scan's host emulation needs it")
    return found


def build(name: str = "mergetree_scan", rewrite=translate) -> str:
    """The emulated library of ``csrc/<name>.cu`` (its source rewritten
    for `EMU_HEADER` by `rewrite`), compiled if the source, the header
    or the flags changed."""
    with open(os.path.join(_build.CSRC_DIR, f"{name}.cu")) as f:
        src = rewrite(f.read())
    key = hashlib.sha256((src + EMU_HEADER + " ".join(GXX_FLAGS)).encode())
    lib = os.path.join(EMU_DIR, f"{name}-{key.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(EMU_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}"
    with open(tmp + ".h", "w") as f:
        f.write(EMU_HEADER)
    with open(tmp + ".cpp", "w") as f:
        f.write(src.replace("#include <cuda_runtime.h>",
                            f'#include "{os.path.basename(tmp)}.h"'))
    proc = subprocess.run([gxx_path(), *GXX_FLAGS, "-o", tmp, tmp + ".cpp"],
                          capture_output=True, text=True, timeout=600)
    for ext in (".h", ".cpp"):
        os.remove(tmp + ext)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


_fn = None


def run_docs(tables: SegmentTable,
             ops: OpBatch) -> Tuple[SegmentTable, torch.Tensor]:
    """The emulated kernel on stacked CPU tables and ops: (the output
    tables, the ``[D, 2]`` rows a thread and warps of each block)."""
    global _fn
    if _fn is None:
        _fn = tms.MergetreeScanKernel.bind(ctypes.CDLL(build()))
    D, C = tables.length.shape
    KR, KK = tables.rem_clients.shape[2], tables.props.shape[2]
    B, PK = ops.prop_keys.shape[1:]
    ins = [t.contiguous() for t in (
        tables.n_rows, tables.error, tables.buf_start, tables.length,
        tables.ins_seq, tables.ins_client, tables.rem_seq,
        tables.rem_clients, tables.props, ops.op_type, ops.pos1, ops.pos2,
        ops.seq, ops.ref_seq, ops.client, ops.buf_start, ops.ins_len,
        ops.prop_keys, ops.prop_vals)]
    g = tms.scan_geometry(C, B, PK, KR, KK)
    out = SegmentTable(*(torch.full_like(t, GARBAGE) for t in (
        ins[0], ins[2], ins[3], ins[4], ins[5], ins[6], ins[7], ins[8],
        ins[1])))
    heap = torch.full((D, C + 2 * B, KR + KK), GARBAGE, dtype=torch.int32)
    hot = torch.full((D, tms.HOT_COLS, -(-C // 32) * 32), GARBAGE,
                     dtype=torch.int32)
    geometry = torch.zeros((D, 2), dtype=torch.int32)
    ts = ins + [out.buf_start, out.length, out.ins_seq, out.ins_client,
                out.rem_seq, out.rem_clients, out.props, out.n_rows,
                out.error, heap, hot, geometry]
    ptrs = (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))
    rc = _fn(0, D, C, KR, KK, B, PK, g.layout, g.smem, len(ts), ptrs, None)
    if rc != 0:
        raise RuntimeError(f"the emulated scan refused the launch ({rc})")
    return out, geometry
