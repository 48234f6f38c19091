// Fused block-table walk + degree-d PTE prefetch for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel `_kernel` / `pte_gather_kernel` of
// src/repro/kernels/pte_gather/kernel.py: translate a batch of logical block
// ids against a block-table replica and return, for each, the physical frame,
// a present flag and the 2^d raw entries around it, clipped to the covering
// table page (the prefetch never crosses the page, paper Fig 5).
//
// What bounds it on this card: bytes — about M*(2W+3)*4 (one logical id and W
// table entries in; frame, flag and W entries out, per miss); a few kilobytes
// per step, so in practice the launch itself.  One warp per miss: lane 0 does the
// walk, and the warp reads the window as one coalesced W-wide int32 load from
// the one table row that covers the miss (on the TPU that row's index rode
// scalar prefetch; here the warp computes it).  Integer-exact.
#include "common.cuh"

namespace {

constexpr int FRAME_MASK = (1 << 28) - 1;
constexpr int WARPS_PER_BLOCK = 4;

__global__ void pte_gather_kernel(const int* __restrict__ entries,
                                  const int* __restrict__ logical,
                                  int* __restrict__ frames,
                                  uint8_t* __restrict__ present,
                                  int* __restrict__ window, int T, int epb, int W,
                                  int M) {
    const int miss = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (miss >= M) return;
    const int lg = logical[miss];
    // floor division and non-negative remainder, as the reference's // and %
    int tid = lg / epb, idx = lg % epb;
    if (idx < 0) { idx += epb; tid -= 1; }
    tid = min(max(tid, 0), T - 1);
    const int* row = entries + (int64_t)tid * epb;
    if (lane == 0) {
        const int raw = row[idx];
        const bool ok = lg >= 0 && (int64_t)lg < (int64_t)T * epb && raw >= 0;
        frames[miss] = ok ? (raw & FRAME_MASK) : -1;
        present[miss] = ok ? 1 : 0;
    }
    const int start = min(max(idx - W / 2, 0), epb - W);
    for (int c = lane; c < W; c += 32)
        window[(int64_t)miss * W + c] = lg >= 0 ? row[start + c] : -1;
}

}  // namespace

// entries [T,epb] i32 packed PTEs, logical [M] i32, frames [M] i32, present
// [M] u8 (0/1), window [M,W] i32, W = 2^degree <= epb.  Returns the launch's
// cudaError_t (0 = launched).
extern "C" int pte_gather_launch(const void* entries, const void* logical,
                                 void* frames, void* present, void* window, int T,
                                 int epb, int W, int M, void* stream) {
    if (M == 0) return 0;
    const int blocks = (M + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
    pte_gather_kernel<<<blocks, WARPS_PER_BLOCK * 32, 0, (cudaStream_t)stream>>>(
        (const int*)entries, (const int*)logical, (int*)frames, (uint8_t*)present,
        (int*)window, T, epb, W, M);
    return (int)cudaGetLastError();
}
