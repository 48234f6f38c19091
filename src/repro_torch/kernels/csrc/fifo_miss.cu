// FIFO-TLB miss flags over a whole access stream, for Hopper (sm_90a), CUDA C++.
//
// Replaces the device backend of src/repro/kernels/fifo_miss.py
// (`_fifo_miss_jit` / `_jit_scan`, a `jax.lax.scan` under `jax.jit`): pass 1
// of the batched access engine (core/batch.py:_general_vec).  An entry filled
// at fill number f is live while f >= nfill - capacity, so an access misses
// where its id's last fill number is below nfill - capacity; a miss refills
// the id at nfill and counts one more fill.  The caller densifies the vpns
// into ids 0..U-1 and seeds each id's fill number (the TLB's entries hold
// 0..n0-1 in fill order, every other id the sentinel -(capacity + 1), which
// always misses).  Integer-only, so the flags are exactly the reference's.
//
// What bounds it on this card: neither bytes nor operations but the chain.
// Each access's class depends on the running fill count, which depends on
// every earlier access, so the walk is sequential: one thread, a compare and
// an add a step on the chain.  The bytes (4 an id and a seed entry read, 1 a
// flag written) would take microseconds.
//
// Design: one block.  Its threads check that every id lies in 0..U-1 and copy
// the seed fill vector into shared memory when U ids fit (up to the opt-in
// 227 KB, 58 112 ids; an engine call has a few tens of thousands), else into
// the caller's scratch in global memory, where L2's 50 MB keeps it; the seed
// itself is never written.  The two places are two instances of the kernel,
// so the shared one uses shared loads and stores.  Then thread 0 walks, with
// no check left on its way: ids come in 16-byte loads kept AHEAD groups in
// front of the walk, flags go out four to a 32-bit store.  The four fill
// numbers of a group are loaded together, before any of the group's steps,
// so the group waits for one load and not four: a step whose id an earlier
// step of the same group refilled takes that step's fill number instead of
// the loaded one (the stores follow in program order).
//
// One thread walks, so the walk is bound by the latency of its dependent
// instructions: about 44 ns a step at the engine's shape on an H100 (PERF.md).
// A device assert on every step made the walk about half again as slow, which
// is why the whole block checks the ids before it.
//
// Rejected: arguments the launch cannot take return cudaErrorInvalidValue and
// launch nothing; an id outside 0..U-1 fails a device assert before the walk
// (cudaErrorAssert at the next synchronisation).
#include <cassert>
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;    // the block that checks the ids and copies the seed
constexpr int AHEAD = 8;        // 16-byte groups of ids loaded ahead of the walk

__device__ __forceinline__ uint32_t step(int* fill, int i, int& nfill, int capacity) {
    const bool miss = fill[i] < nfill - capacity;
    if (miss) {
        fill[i] = nfill;
        ++nfill;
    }
    return miss ? 1u : 0u;
}

// The four steps of one 16-byte group of ids; returns their flags, one a byte.
__device__ __forceinline__ uint32_t step4(int* fill, int4 v, int& nfill,
                                          int capacity) {
    const int id[4] = {v.x, v.y, v.z, v.w};
    int f[4], at[4];
    bool miss[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) f[j] = fill[id[j]];
    uint32_t flags = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int k = 0; k < j; ++k)        // the latest earlier refill wins
            if (miss[k] && id[k] == id[j]) f[j] = at[k];
        miss[j] = f[j] < nfill - capacity;
        at[j] = nfill;
        nfill += miss[j] ? 1 : 0;
        flags |= (miss[j] ? 1u : 0u) << (8 * j);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
        if (miss[j]) fill[id[j]] = at[j];
    return flags;
}

template <bool SHARED>
__global__ void __launch_bounds__(THREADS)
fifo_miss_kernel(const int* __restrict__ fill0, int U, int nfill0,
                 const int* __restrict__ ids, int n, int capacity,
                 int* __restrict__ scratch, uint8_t* __restrict__ mask) {
    extern __shared__ int shared_fill[];
    int* fill = SHARED ? shared_fill : scratch;
    for (int k = threadIdx.x; k < n; k += blockDim.x)
        assert((unsigned)__ldg(ids + k) < (unsigned)U);
    for (int u = threadIdx.x; u < U; u += blockDim.x) fill[u] = fill0[u];
    __syncthreads();
    if (threadIdx.x != 0) return;

    int nfill = nfill0;
    const int4* ids4 = reinterpret_cast<const int4*>(ids);
    uint32_t* mask4 = reinterpret_cast<uint32_t*>(mask);
    const int n4 = n >> 2;
    int4 ring[AHEAD];
#pragma unroll
    for (int a = 0; a < AHEAD; ++a)
        if (a < n4) ring[a] = __ldg(ids4 + a);
    for (int g = 0; g < n4; g += AHEAD) {
#pragma unroll
        for (int a = 0; a < AHEAD; ++a) {
            if (g + a < n4) {
                const int4 v = ring[a];
                if (g + a + AHEAD < n4) ring[a] = __ldg(ids4 + g + a + AHEAD);
                mask4[g + a] = step4(fill, v, nfill, capacity);
            }
        }
    }
    for (int k = n4 << 2; k < n; ++k)
        mask[k] = (uint8_t)step(fill, __ldg(ids + k), nfill, capacity);
}

}  // namespace

// How many ids the fill vector may hold in shared memory on the current
// device (its opt-in shared memory a block over 4 bytes).
extern "C" int fifo_miss_shared_ids(int* out) {
    int dev = 0, bytes = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    *out = bytes / (int)sizeof(int);
    return (int)err;
}

// fill0 [U] i32 seed fill numbers (read only); ids [n] i32 in 0..U-1, 16-byte
// aligned; mask [n] u8 (0/1), 4-byte aligned; scratch: null to keep the fill
// vector in shared memory, else [U] i32 of global memory for it.  nfill0 is
// the fill count before the stream, and nfill0 + n must stay below 2^31.
// Returns the launch's cudaError_t (0 = launched, or nothing to do when n = 0).
extern "C" int fifo_miss_launch(const void* fill0, int U, int nfill0, const void* ids,
                                int n, int capacity, void* scratch, void* mask,
                                void* stream) {
    const bool bad_shape = U < 0 || n < 0 || nfill0 < 0 || capacity < 0 ||
                           capacity == INT_MAX || (int64_t)nfill0 + n > INT_MAX ||
                           (n > 0 && U == 0);
    if (bad_shape) return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    if (!fill0 || !ids || !mask || (uintptr_t)ids % 16 != 0 || (uintptr_t)mask % 4 != 0)
        return (int)cudaErrorInvalidValue;
    size_t smem = 0;
    if (scratch == nullptr) {
        int limit = 0;
        cudaError_t err = (cudaError_t)fifo_miss_shared_ids(&limit);
        if (err != cudaSuccess) return (int)err;
        if (U > limit) return (int)cudaErrorInvalidValue;
        smem = (size_t)U * sizeof(int);
        err = cudaFuncSetAttribute(fifo_miss_kernel<true>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        fifo_miss_kernel<true><<<1, THREADS, smem, (cudaStream_t)stream>>>(
            (const int*)fill0, U, nfill0, (const int*)ids, n, capacity, nullptr,
            (uint8_t*)mask);
    } else {
        fifo_miss_kernel<false><<<1, THREADS, 0, (cudaStream_t)stream>>>(
            (const int*)fill0, U, nfill0, (const int*)ids, n, capacity, (int*)scratch,
            (uint8_t*)mask);
    }
    return (int)cudaGetLastError();
}
