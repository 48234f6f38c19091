// The device side of the page walk in one launch, for Hopper (sm_90a), CUDA C++:
// drain a list of block-table mutations into the device table, then walk a
// batch of logical block ids against the updated table with the degree-d
// prefetch window.
//
// Replaces the Pallas TPU kernel `_kernel` / `pte_gather_kernel` of
// src/repro/kernels/pte_gather/kernel.py (the walk: for each logical id the
// physical frame, a present flag and the 2^d raw entries around it, clipped
// to the covering table page, paper Fig 5), fused with the mutation drain
// that the JAX package runs as `pagedpt/blocktable.py:apply_mutations`
// before it: the paper's page walk on a local replica after the coherent
// drain.
//
// What bounds it on this card: bytes — 13 a mutation read (slot, entry,
// value, applied flag), 4 written for each slot an applied mutation names,
// and M * (4 + 4W + 4 + 1 + 4W) for the walk (id and window in; frame, flag
// and window out).  A few tens of kilobytes a call at the serving shape, so
// in practice the launch itself; what the design removes is launches and
// copies around it (one launch, fed by one host-to-device copy).
//
// Design: with mutations, ONE thread block.  Every write of the drain must
// be visible to every read of the walk; inside one block a __syncthreads
// orders them, so no grid-wide sync or second launch is needed (a wave
// switch carries about 2 100 mutations, a step about 1 100 ids, the table
// 128 KB).  The drain takes the mutations in chunks of THREADS in program
// order, a barrier between chunks.  Within a chunk each applied mutation
// enters its slot into a shared-memory hash with atomicMax of its list
// position, and only the mutation that holds the maximum stores: where a
// slot is named more than once the last applied mutation wins, with no race
// between stores.  Two hash tables alternate, so a chunk costs two barriers.
// With no mutations (a steady decode step) nothing orders the walk, and the
// launch spreads it over blocks of WALK_THREADS so that many SMs keep its
// loads in flight.  The walk gives each thread (id, window column) pairs:
// the window is written fully coalesced, the thread whose column is the
// id's own entry writes frame and flag, and each thread keeps up to UNROLL
// pairs in flight; the first pass's ids are loaded before the drain, which
// does not touch them.
//
// Rejected: arguments the launch cannot take return cudaErrorInvalidValue
// and launch nothing; a mutation naming a slot outside the table fails a
// device assert (cudaErrorAssert at the next synchronisation).  Nothing is
// dropped silently.  Integer-exact.
#include <cassert>
#include <climits>

#include "common.cuh"

namespace {

constexpr int FRAME_MASK = (1 << 28) - 1;
constexpr int THREADS = 1024;          // the block that drains, then walks
constexpr int WALK_THREADS = 256;      // a block of a walk with no drain
constexpr int HASH_BITS = 11;          // 2 048 slots for at most 1 024 keys
constexpr int HASH = 1 << HASH_BITS;
constexpr int EMPTY = -1;
// pairs a thread keeps in flight: one block walks the serving shape's
// 1 104 ids x 8 columns in one pass
constexpr int UNROLL = 9;

__device__ __forceinline__ int hash_slot(int pos) {
    return (int)(((unsigned)pos * 2654435761u) >> (32 - HASH_BITS));
}

// the ids of the pairs base, base + stride, ... (-1 past the end)
__device__ __forceinline__ void load_ids(const int* __restrict__ logical,
                                         int64_t base, int64_t stride,
                                         int64_t total, int log2W,
                                         int (&lg)[UNROLL]) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
        const int64_t k = base + u * stride;
        lg[u] = k < total ? logical[k >> log2W] : -1;
    }
}

// entries is read and written in this launch: it takes no __restrict__, so
// the walk's loads stay coherent with the drain's stores (no read-only path).
__global__ void __launch_bounds__(THREADS)
pte_gather_kernel(int* entries, const int* __restrict__ logical,
                  const int* __restrict__ mut_table, const int* __restrict__ mut_idx,
                  const int* __restrict__ mut_value,
                  const uint8_t* __restrict__ mut_applied,
                  int* __restrict__ frames, uint8_t* __restrict__ present,
                  int* __restrict__ window, int T, int epb, int log2W, int M,
                  int n_mut) {
    // two hash tables of HASH keys and HASH list positions, dynamic shared
    // memory: a launch with no drain asks for none
    extern __shared__ int hash[];
    int(*keys)[HASH] = reinterpret_cast<int(*)[HASH]>(hash);
    int(*last)[HASH] = reinterpret_cast<int(*)[HASH]>(hash + 2 * HASH);
    const int t = threadIdx.x;
    const int W = 1 << log2W;
    const int64_t total = (int64_t)M << log2W;
    const int64_t n_entries = (int64_t)T * epb;
    const int64_t first = (int64_t)blockIdx.x * blockDim.x + t;
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    // the ids do not depend on the drain: their first loads overlap it
    int lg[UNROLL];
    load_ids(logical, first, stride, total, log2W, lg);

    // ---- drain (one block of THREADS): chunks of THREADS mutations, in
    // program order
    if (n_mut > 0) {
        for (int s = t; s < HASH; s += THREADS) {
            keys[0][s] = EMPTY;
            last[0][s] = -1;
        }
        __syncthreads();
        const int n_chunks = (n_mut + THREADS - 1) / THREADS;
        for (int c = 0; c < n_chunks; ++c) {
            const int b = c & 1;
            const int i = c * THREADS + t;
            int pos = -1, val = 0, h = 0;
            if (i < n_mut) {
                const int tb = mut_table[i], ix = mut_idx[i];
                assert(tb >= 0 && tb < T && ix >= 0 && ix < epb);
                if (mut_applied[i]) {
                    pos = tb * epb + ix;
                    val = mut_value[i];
                    h = hash_slot(pos);
                    for (;;) {
                        const int prev = atomicCAS(&keys[b][h], EMPTY, pos);
                        if (prev == EMPTY || prev == pos) break;
                        h = (h + 1) & (HASH - 1);
                    }
                    atomicMax(&last[b][h], i);
                }
            }
            // the other table was last read before the previous barrier and
            // is next written after the coming one
            for (int s = t; s < HASH; s += THREADS) {
                keys[b ^ 1][s] = EMPTY;
                last[b ^ 1][s] = -1;
            }
            __syncthreads();
            if (pos >= 0 && last[b][h] == i) entries[pos] = val;
            __syncthreads();   // this chunk's stores before the next chunk's
        }                      // and before the walk's loads
    }

    // ---- walk: (id, window column) pairs, the window's flat index k
    for (int64_t base = first; base < total; base += stride * UNROLL) {
        if (base != first) load_ids(logical, base, stride, total, log2W, lg);
        int v[UNROLL];
        unsigned own = 0;          // bit u: pair u is the walked entry itself
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int64_t k = base + u * stride;
            // floor division and non-negative remainder, as numpy's // and %
            int tid = lg[u] / epb, idx = lg[u] % epb;
            if (idx < 0) {
                idx += epb;
                tid -= 1;
            }
            tid = min(max(tid, 0), T - 1);
            const int start = min(max(idx - W / 2, 0), epb - W);
            const int c = (int)(k & (W - 1));
            own |= (unsigned)(c == idx - start) << u;
            v[u] = k < total ? entries[(int64_t)tid * epb + start + c] : -1;
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int64_t k = base + u * stride;
            if (k >= total) continue;
            window[k] = lg[u] >= 0 ? v[u] : -1;
            if (own >> u & 1) {
                const bool ok = lg[u] >= 0 && (int64_t)lg[u] < n_entries && v[u] >= 0;
                frames[k >> log2W] = ok ? (v[u] & FRAME_MASK) : -1;
                present[k >> log2W] = ok ? 1 : 0;
            }
        }
    }
}

}  // namespace

// entries [T,epb] i32 packed PTEs, updated in place; logical [M] i32; the
// mutation list in program order: mut_table, mut_idx, mut_value [n_mut] i32
// and mut_applied [n_mut] u8 (0/1); frames [M] i32, present [M] u8 (0/1),
// window [M,W] i32, W = 2^k <= epb.  Returns the launch's cudaError_t (0 =
// launched, or nothing to do when M = n_mut = 0).
extern "C" int pte_gather_launch(void* entries, const void* logical,
                                 const void* mut_table, const void* mut_idx,
                                 const void* mut_value, const void* mut_applied,
                                 void* frames, void* present, void* window, int T,
                                 int epb, int W, int M, int n_mut, void* stream) {
    int log2W = 0;
    while (log2W < 30 && (1 << log2W) < W) ++log2W;
    const bool bad_shape = T <= 0 || epb <= 0 || (int64_t)T * epb > INT_MAX ||
                           W <= 0 || (1 << log2W) != W || W > epb || M < 0 ||
                           n_mut < 0;
    const bool bad_ptr = !entries ||
                         (M > 0 && !(logical && frames && present && window)) ||
                         (n_mut > 0 && !(mut_table && mut_idx && mut_value && mut_applied));
    if (bad_shape || bad_ptr) return (int)cudaErrorInvalidValue;
    if (M == 0 && n_mut == 0) return 0;
    const int64_t pairs = (int64_t)M * W;
    if (pairs > (int64_t)INT_MAX * WALK_THREADS) return (int)cudaErrorInvalidValue;
    const int blocks = n_mut > 0 ? 1 : (int)((pairs + WALK_THREADS - 1) / WALK_THREADS);
    const int threads = n_mut > 0 ? THREADS : WALK_THREADS;
    const size_t smem = n_mut > 0 ? 4 * HASH * sizeof(int) : 0;
    pte_gather_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
        (int*)entries, (const int*)logical, (const int*)mut_table,
        (const int*)mut_idx, (const int*)mut_value, (const uint8_t*)mut_applied,
        (int*)frames, (uint8_t*)present, (int*)window, T, epb, log2W, M, n_mut);
    return (int)cudaGetLastError();
}
