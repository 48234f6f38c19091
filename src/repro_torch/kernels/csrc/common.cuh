// Shared device helpers for the numaPTE serving kernels (sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NEG_INF (-1073741824.0f)  // -2**30, the mask value of the reference

// dtype codes shared with the Python wrappers
#define DTYPE_F32 0
#define DTYPE_BF16 1

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
}

// Load N consecutive elements starting at p (aligned to N * sizeof(T), at
// most 16 bytes a request) and widen them to float.
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* __restrict__ p, float (&out)[N]) {
    constexpr int BYTES = N * (int)sizeof(T);
    if constexpr (BYTES % 16 == 0) {
        constexpr int PER = 16 / (int)sizeof(T);
#pragma unroll
        for (int c = 0; c < BYTES / 16; ++c) {
            uint4 raw = reinterpret_cast<const uint4*>(p)[c];
            const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
            for (int i = 0; i < PER; ++i) out[c * PER + i] = to_float(e[i]);
        }
    } else if constexpr (BYTES == 8) {
        uint2 raw = *reinterpret_cast<const uint2*>(p);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int i = 0; i < N; ++i) out[i] = to_float(e[i]);
    } else if constexpr (BYTES == 4) {
        uint32_t raw = *reinterpret_cast<const uint32_t*>(p);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int i = 0; i < N; ++i) out[i] = to_float(e[i]);
    } else {
#pragma unroll
        for (int i = 0; i < N; ++i) out[i] = to_float(p[i]);
    }
}
