// Inline-PTX helpers for warp-level tensor-core kernels (sm_80 and later;
// the package builds for sm_90a): asynchronous 16-byte copies into shared memory,
// ldmatrix fragment loads and the bf16 m16n8k16 mma.sync.
//
// Fragment layouts of mma.sync.m16n8k16 (lane = 4 * g + t, g = lane / 4,
// t = lane % 4), each register holding two neighbouring 16-bit elements:
//   A [16 x 16], row-major:  a0 (g, 2t..2t+1)   a1 (g+8, 2t..)
//                            a2 (g, 2t+8..)      a3 (g+8, 2t+8..)
//   B [16 x 8],  col-major:  b0 (2t..2t+1, g)    b1 (2t+8.., g)
//   C [16 x 8],  f32:        c0, c1 (g, 2t..2t+1)  c2, c3 (g+8, 2t..2t+1)
// ldmatrix.x4 loads four 8x8 matrices; lanes 8i..8i+7 give the row addresses
// of matrix i, and register i of a lane holds (row g, cols 2t..2t+1) of
// matrix i, or (rows 2t..2t+1, col g) with .trans.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes from device memory to shared memory without passing through
// L1.  Of the 16 bytes, the first `src_bytes` are read and the rest are zero
// (src_bytes = 0 reads nothing and writes 16 zero bytes).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p)));
}

// d += a * b on the tensor cores: A [16 x 16] and B [16 x 8] in bf16, the
// products and the sum in f32.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two bf16 values as one register, x in the low half (the lower column of a
// fragment).
__device__ __forceinline__ uint32_t pack_bf16x2(__nv_bfloat16 x, __nv_bfloat16 y) {
    return static_cast<uint32_t>(__bfloat16_as_ushort(x)) |
           (static_cast<uint32_t>(__bfloat16_as_ushort(y)) << 16);
}

// hi = bf16(p), lo = bf16(p - hi) for two neighbouring p, packed as A
// fragment registers: a product with hi and one with lo into the same f32
// accumulator keep P V within ~1e-5 of the f32 product.
__device__ __forceinline__ void split_p(float p0, float p1, uint32_t& hi,
                                        uint32_t& lo) {
    const __nv_bfloat16 h0 = __float2bfloat16(p0), h1 = __float2bfloat16(p1);
    hi = pack_bf16x2(h0, h1);
    lo = pack_bf16x2(__float2bfloat16(p0 - __bfloat162float(h0)),
                     __float2bfloat16(p1 - __bfloat162float(h1)));
}
