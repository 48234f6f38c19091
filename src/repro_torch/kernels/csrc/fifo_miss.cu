// FIFO-TLB miss flags over a whole access stream, for Hopper (sm_90a), CUDA C++.
//
// Replaces the device backend of src/repro/kernels/fifo_miss.py
// (`_fifo_miss_jit` / `_jit_scan`, a `jax.lax.scan` under `jax.jit`): pass 1
// of the batched access engine (core/batch.py:_general_vec).  An entry filled
// at fill number f is live while f >= nfill - capacity, so an access misses
// where its id's last fill number is below nfill - capacity; a miss refills
// the id at nfill and counts one more fill.  The caller maps the vpns to ids
// 0..U-1 and seeds each id's fill number (the TLB's entries hold their fill
// order, every other id the sentinel -(capacity + 1), which always misses).
// Integer-only, so the flags are exactly the reference's.
//
// What bounds it on this card: neither bytes nor operations but the chain.
// Each access's class depends on the running fill count, which depends on
// every earlier access.  The bytes (4 an id and a seed entry read, 1 a flag
// written) would take microseconds.  Walked one access at a time, each step
// waits for the step before (44 ns a step with one thread on an NVIDIA H100
// 80GB HBM3 at 700 W, PERF.md).
//
// Design: one block.  Its threads check that every id lies in 0..U-1 and copy
// the seed fill vector into shared memory when U ids fit (up to the opt-in
// 227 KB, 58 112 ids; an engine call has a few tens of thousands), else into
// the caller's scratch in global memory, where L2's 50 MB keeps it; the seed
// itself is never written.  The two places are two instances of the kernel,
// so the shared one uses shared loads and stores.  Then warp 0 walks the
// stream in windows of 32 consecutive accesses, lane j taking access 32w + j:
//
//   - ids come in one coalesced 128-byte load a window, AHEAD windows ahead
//     of the walk; f = fill[id] is loaded after the previous window's stores
//     (__syncwarp orders them);
//   - the group: the lanes with the same id as lane j, and its peers the
//     group's lanes below j.  In global memory __match_any_sync finds it
//     while the L2 load of f is in flight.  In shared memory f comes back
//     sooner than a match over 32 distinct ids, which would be the window's
//     longest step, so there the lanes write their lane numbers into their
//     ids' entries of the fill vector, read back which lane won, and ballot
//     the winner's five bits (PERF.md, the fifo_miss findings);
//   - rounds on the window's miss flags b (a ballot).  Given b, lane j's fill
//     count is N_j = N + popc(b & lanes below j); its id's fill number F_j is
//     N_i of the latest earlier peer i that missed (i = fls(peers & b)), else
//     f; lane j misses iff F_j < N_j - capacity.  A round recomputes every
//     lane's flag from b and ballots them; the rounds stop when the ballot
//     no longer changes;
//   - stores: the last missing lane of each group writes fill[id] = N_j, and
//     in shared memory the winner of a group with no miss writes f back (one
//     writer an id); every lane writes its flag byte (32 bytes a window);
//     N += popc(b).  Lanes past n take no part.
//
// Why the fixpoint is the sequential walk.  Lane j's flag is a function of
// the flags of the lanes below it alone (N_j and F_j read nothing else, and
// every store of the earlier windows has landed), so the system is causal:
// in a fixpoint, lane 0's flag is forced, then lane 1's by lane 0's, and so
// on, each exactly as the sequential walk computes it.  The fixpoint is
// unique and is the walk.  From any start, if the lanes below j are right in
// a round's input, lane j is right in its output: after r rounds lanes
// 0..r-1 are right, so a window takes at most 32 rounds and one to confirm.
//
// The start only sets how many rounds it takes.  A window starts from "every
// lane misses" when every lane of the window before missed (a cold stream, or
// a sweep over more pages than the TLB holds, where each miss evicts the next
// page the sweep touches: one round), else from "no lane misses" (one or two
// rounds where hits and misses mix).  tests/test_torch_fifo_window.py models
// the warp on the CPU and counts the rounds.
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
constexpr int UNROLL = 8;       // loads in flight a thread while checking and copying
constexpr int AHEAD = 8;        // windows of ids loaded ahead of the walk
constexpr unsigned FULL = 0xffffffffu;

template <bool SHARED>
__global__ void __launch_bounds__(THREADS)
fifo_miss_kernel(const int* __restrict__ fill0, int U, int nfill0,
                 const int* __restrict__ ids, int n, int capacity,
                 int* __restrict__ scratch, uint8_t* __restrict__ mask,
                 int* __restrict__ rounds_out) {
    extern __shared__ int shared_fill[];
    int* fill = SHARED ? shared_fill : scratch;
    // UNROLL loads in flight a thread before their checks and stores
    for (int64_t k0 = threadIdx.x; k0 < n; k0 += UNROLL * THREADS) {
        int v[UNROLL];
#pragma unroll
        for (int j = 0; j < UNROLL; ++j) {
            const int64_t k = k0 + j * THREADS;
            v[j] = k < n ? __ldg(ids + k) : 0;
        }
#pragma unroll
        for (int j = 0; j < UNROLL; ++j) assert((unsigned)v[j] < (unsigned)U);
    }
    for (int64_t u0 = threadIdx.x; u0 < U; u0 += UNROLL * THREADS) {
        int v[UNROLL];
#pragma unroll
        for (int j = 0; j < UNROLL; ++j) {
            const int64_t u = u0 + j * THREADS;
            v[j] = u < U ? __ldg(fill0 + u) : 0;
        }
#pragma unroll
        for (int j = 0; j < UNROLL; ++j)
            if (u0 + j * THREADS < U) fill[u0 + j * THREADS] = v[j];
    }
    __syncthreads();
    if (threadIdx.x >= 32) return;

    const int lane = threadIdx.x;
    const unsigned below = (1u << lane) - 1u;       // lanes below this one
    const int nw = (int)(((int64_t)n + 31) >> 5);
    int ring[AHEAD];
#pragma unroll
    for (int a = 0; a < AHEAD; ++a) {
        const int64_t k = 32 * (int64_t)a + lane;
        ring[a] = k < n ? __ldg(ids + k) : -1;
    }
    int N = nfill0;
    bool all_missed = true;     // the window before missed on every lane
    int64_t rounds = 0;
    for (int w0 = 0; w0 < nw; w0 += AHEAD) {
#pragma unroll
        for (int a = 0; a < AHEAD; ++a) {
            const int w = w0 + a;
            if (w >= nw) break;                      // the same on every lane
            const int64_t k = 32 * (int64_t)w + lane;
            const bool active = k < n;
            const int id = ring[a];                  // -1 past n
            const int64_t next = k + 32 * AHEAD;
            ring[a] = next < n ? __ldg(ids + next) : -1;

            const int f = active ? fill[id] : 0;
            // group: the lanes that hold this lane's id (lanes past n share -1)
            unsigned group;
            int owner = 0;
            if (SHARED) {
                // Through the fill vector: each lane writes its lane number
                // into its id's entry; lanes that read back the same number
                // hold the same id.  Five ballots over that number (and a
                // sixth that sets lanes past n apart) give the group.  The
                // entry is rewritten below by one lane of each group.
                __syncwarp();
                if (active) fill[id] = lane;
                __syncwarp();
                owner = active ? fill[id] : 32 + lane;
                group = FULL;
#pragma unroll
                for (int bit = 0; bit < 6; ++bit) {
                    const bool set = (owner >> bit) & 1;
                    const unsigned with = __ballot_sync(FULL, set);
                    group &= set ? with : ~with;
                }
            } else {
                group = __match_any_sync(FULL, id);
            }
            const unsigned peers = group & below;
            const unsigned act = __ballot_sync(FULL, active);
            unsigned b = all_missed ? act : 0u;
            for (;;) {
                ++rounds;
                const unsigned p = peers & b;
                const int F = p ? N + __popc(b & ((1u << (31 - __clz(p))) - 1u)) : f;
                const int Nj = N + __popc(b & below);
                const unsigned nb = __ballot_sync(FULL, active && F < Nj - capacity);
                if (nb == b) break;
                b = nb;
            }
            // one writer an id: the group's last miss, or in shared memory
            // the winner of a group that did not miss (the entry back)
            const bool miss = (b >> lane) & 1u;
            const unsigned missed = group & b;
            const bool writes = missed ? 31 - __clz(missed) == lane
                                       : SHARED && owner == lane;
            if (active && writes) fill[id] = miss ? N + __popc(b & below) : f;
            if (active) mask[k] = miss ? 1 : 0;
            N += __popc(b);
            all_missed = b == act;
            __syncwarp();            // the stores land before the next loads
        }
    }
    if (rounds_out != nullptr && lane == 0)
        *rounds_out = (int)(rounds < INT_MAX ? rounds : INT_MAX);
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

// fill0 [U] i32 seed fill numbers (read only); ids [n] i32 in 0..U-1; mask
// [n] u8 (0/1); scratch: null to keep the fill vector in shared memory, else
// [U] i32 of global memory for it; rounds: null, or one i32 that receives
// the number of rounds the walk took over all its windows (at least one a
// window).  nfill0 is the fill count before the stream, and nfill0 + n must
// stay below 2^31.  Returns the launch's cudaError_t (0 = launched, or
// nothing to do when n = 0).
extern "C" int fifo_miss_launch(const void* fill0, int U, int nfill0, const void* ids,
                                int n, int capacity, void* scratch, void* mask,
                                void* rounds, void* stream) {
    const bool bad_shape = U < 0 || n < 0 || nfill0 < 0 || capacity < 0 ||
                           capacity == INT_MAX || (int64_t)nfill0 + n > INT_MAX ||
                           (n > 0 && U == 0);
    if (bad_shape) return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    if (!fill0 || !ids || !mask || (uintptr_t)ids % sizeof(int) != 0 ||
        (uintptr_t)fill0 % sizeof(int) != 0)
        return (int)cudaErrorInvalidValue;
    if (scratch == nullptr) {
        int limit = 0;
        cudaError_t err = (cudaError_t)fifo_miss_shared_ids(&limit);
        if (err != cudaSuccess) return (int)err;
        if (U > limit) return (int)cudaErrorInvalidValue;
        const size_t smem = (size_t)U * sizeof(int);
        err = cudaFuncSetAttribute(fifo_miss_kernel<true>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        fifo_miss_kernel<true><<<1, THREADS, smem, (cudaStream_t)stream>>>(
            (const int*)fill0, U, nfill0, (const int*)ids, n, capacity, nullptr,
            (uint8_t*)mask, (int*)rounds);
    } else {
        fifo_miss_kernel<false><<<1, THREADS, 0, (cudaStream_t)stream>>>(
            (const int*)fill0, U, nfill0, (const int*)ids, n, capacity, (int*)scratch,
            (uint8_t*)mask, (int*)rounds);
    }
    return (int)cudaGetLastError();
}
