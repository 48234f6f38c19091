// Prefill (flash) attention for Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces the Pallas TPU kernel `_kernel` / `flash_attention_kernel` of
// src/repro/kernels/flash_attention/kernel.py: blocked attention with
// online softmax, GQA (kv head = h / G), causal and/or sliding window or
// bidirectional, float32 output.
//
// What bounds it on this card: operations — 4*B*H*hd*(live q.k pairs) FLOPs
// against a few bytes per pair.  This first version is right and simple: the
// two products of a tile run as float32 FMAs on the CUDA cores out of shared
// memory (so f32 inputs keep full precision); the tensor cores (`wgmma`) are
// left to the pull request that makes it fast.  What the design does do:
//   * one block per (batch, head, 64-row q tile); the TPU's sequential k
//     grid axis is the loop over 64-row k tiles inside the block, with
//     m / l / acc in registers instead of VMEM scratch;
//   * the k loop runs only over the live range
//     [(q_start - window + 1) / BK, (q_start + BQ - 1) / BK]: dead tiles are
//     never visited, where the TPU kernel predicates them off;
//   * each thread owns a 4x4 piece of the score tile and the matching rows
//     of the output, so the softmax state never leaves its registers;
//   * ragged edges are masked, so S need not divide the tile; masked
//     entries contribute an exact 0 (they are not exponentiated);
//   * q, k, v and out are addressed through (batch, head, row) strides, so
//     the caller's [B,S,H,hd] projections are read in place as [B,H,S,hd].
#include "common.cuh"

namespace {

constexpr int BQ = 64;   // q rows per block
constexpr int BK = 64;   // k rows per step
constexpr int NT = 256;  // threads: 16 x 16, thread (ty, tx)
constexpr int LDP = BK + 4;

struct Strides { int64_t b, h, s; };

__device__ __forceinline__ bool visible(int qpos, int kpos, int S, int causal,
                                        int window) {
    return kpos < S && (!causal || qpos >= kpos) &&
           (window < 0 || qpos - kpos < window);
}

template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int64_t row_stride, int row0, int rows,
                                          int S, int hd, int ld) {
    for (int idx = threadIdx.x; idx < rows * hd; idx += NT) {
        const int r = idx / hd, d = idx - r * hd;
        const int row = row0 + r;
        dst[r * ld + d] = row < S ? to_float(src[row * row_stride + d]) : 0.f;
    }
}

// DPT: output head_dim elements per thread (thread tx owns d = tx + 16*j).
template <typename T, int DPT>
__global__ void __launch_bounds__(NT)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, float* __restrict__ out, int G,
                       int S, int hd, int causal, int window, float scale,
                       Strides qs, Strides ks, Strides vs, Strides os) {
    extern __shared__ __align__(16) float smem[];
    const int ld = hd + 4;            // keeps rows 16-byte aligned, spreads banks
    float* sq = smem;                 // [BQ][ld]
    float* sk = sq + BQ * ld;         // [BK][ld]
    float* sv = sk + BK * ld;         // [BK][ld]
    float* sp = sv + BK * ld;         // [BQ][LDP] probabilities of this step

    // heaviest (latest) causal tiles first
    const int q_start = (gridDim.x - 1 - blockIdx.x) * BQ;
    const int h = blockIdx.y, b = blockIdx.z;
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

    load_tile<T>(sq, q + b * qs.b + h * qs.h, qs.s, q_start, BQ, S, hd, ld);
    const T* kb = k + b * ks.b + (h / G) * ks.h;
    const T* vb = v + b * vs.b + (h / G) * vs.h;

    float m[4], l[4], acc[4][DPT];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = NEG_INF;
        l[i] = 0.f;
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
    }

    const int q_last = min(q_start + BQ, S) - 1;
    const int kt_lo = window >= 0 ? max(q_start - window + 1, 0) / BK : 0;
    const int kt_hi = (causal ? q_last : S - 1) / BK;
    for (int kt = kt_lo; kt <= kt_hi; ++kt) {
        const int k_start = kt * BK;
        __syncthreads();              // the previous step is done with sk/sv/sp
        load_tile<T>(sk, kb, ks.s, k_start, BK, S, hd, ld);
        load_tile<T>(sv, vb, vs.s, k_start, BK, S, hd, ld);
        __syncthreads();

        // scores: rows ty + 16*i, columns tx + 16*j
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
        for (int d = 0; d < hd; d += 4) {
            float4 a[4], c[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                a[i] = *reinterpret_cast<const float4*>(&sq[(ty + 16 * i) * ld + d]);
#pragma unroll
            for (int j = 0; j < 4; ++j)
                c[j] = *reinterpret_cast<const float4*>(&sk[(tx + 16 * j) * ld + d]);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    s[i][j] += a[i].x * c[j].x + a[i].y * c[j].y +
                               a[i].z * c[j].z + a[i].w * c[j].w;
        }

        // online softmax; the 16 threads of a row are 16 neighbouring lanes
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int qpos = q_start + ty + 16 * i;
            float mx = NEG_INF;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const bool ok = visible(qpos, k_start + tx + 16 * j, S, causal, window);
                s[i][j] = ok ? s[i][j] * scale : NEG_INF;
                mx = fmaxf(mx, s[i][j]);
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m[i], mx);
            const float alpha = expf(m[i] - m_new);
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const bool ok = visible(qpos, k_start + tx + 16 * j, S, causal, window);
                const float p = ok ? expf(s[i][j] - m_new) : 0.f;
                sp[(ty + 16 * i) * LDP + tx + 16 * j] = p;
                sum += p;
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                sum += __shfl_xor_sync(0xffffffffu, sum, off);
            l[i] = l[i] * alpha + sum;
            m[i] = m_new;
#pragma unroll
            for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
        }
        __syncthreads();

        // acc += P V
        for (int kk = 0; kk < BK; kk += 4) {
            float4 p4[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                p4[i] = *reinterpret_cast<const float4*>(&sp[(ty + 16 * i) * LDP + kk]);
#pragma unroll
            for (int j = 0; j < DPT; ++j) {
                const int d = tx + 16 * j;
                if (d < hd) {
                    const float v0 = sv[(kk + 0) * ld + d], v1 = sv[(kk + 1) * ld + d];
                    const float v2 = sv[(kk + 2) * ld + d], v3 = sv[(kk + 3) * ld + d];
#pragma unroll
                    for (int i = 0; i < 4; ++i)
                        acc[i][j] += p4[i].x * v0 + p4[i].y * v1 + p4[i].z * v2 +
                                     p4[i].w * v3;
                }
            }
        }
    }

    float* ob = out + b * os.b + h * os.h;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = q_start + ty + 16 * i;
        if (row >= S) continue;
        const float inv = 1.0f / fmaxf(l[i], 1e-30f);
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
            const int d = tx + 16 * j;
            if (d < hd) ob[row * os.s + d] = acc[i][j] * inv;
        }
    }
}

template <typename T, int DPT>
cudaError_t launch_dpt(const void* q, const void* k, const void* v, float* out,
                       int B, int H, int K, int S, int hd, int causal, int window,
                       Strides qs, Strides ks, Strides vs, Strides os,
                       cudaStream_t stream) {
    const size_t smem = ((size_t)(BQ + 2 * BK) * (hd + 4) + (size_t)BQ * LDP) * sizeof(float);
    auto kernel = flash_attention_kernel<T, DPT>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((S + BQ - 1) / BQ, H, B);
    const float scale = 1.0f / sqrtf((float)hd);
    kernel<<<grid, NT, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, out,
                                       H / K, S, hd, causal, window, scale, qs,
                                       ks, vs, os);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const void* q, const void* k, const void* v, float* out,
                      int B, int H, int K, int S, int hd, int causal, int window,
                      Strides qs, Strides ks, Strides vs, Strides os,
                      cudaStream_t stream) {
    const int per_thread = (hd + 15) / 16;
#define FA_ARGS q, k, v, out, B, H, K, S, hd, causal, window, qs, ks, vs, os, stream
    if (per_thread <= 1) return launch_dpt<T, 1>(FA_ARGS);
    if (per_thread <= 2) return launch_dpt<T, 2>(FA_ARGS);
    if (per_thread <= 4) return launch_dpt<T, 4>(FA_ARGS);
    if (per_thread <= 8) return launch_dpt<T, 8>(FA_ARGS);
    return launch_dpt<T, 16>(FA_ARGS);
#undef FA_ARGS
}

}  // namespace

// q [B,H,S,hd], k/v [B,K,S,hd] of `dtype`, out [B,H,S,hd] f32, each given by
// its (batch, head, row) strides in elements with head_dim contiguous.
// window < 0 means none.  Needs hd <= 256 and hd % 4 == 0, H <= 65535 and
// B <= 65535 (grid limits); the wrapper checks.  Returns the launch's
// cudaError_t (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* out, int B, int H, int K, int S,
                                      int hd, int causal, int window, int dtype,
                                      const int64_t* strides, void* stream) {
    if (B == 0 || S == 0) return 0;
    const Strides qs{strides[0], strides[1], strides[2]};
    const Strides ks{strides[3], strides[4], strides[5]};
    const Strides vs{strides[6], strides[7], strides[8]};
    const Strides os{strides[9], strides[10], strides[11]};
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == DTYPE_BF16)
        return (int)launch_hd<__nv_bfloat16>(q, k, v, (float*)out, B, H, K, S, hd,
                                             causal, window, qs, ks, vs, os, st);
    return (int)launch_hd<float>(q, k, v, (float*)out, B, H, K, S, hd, causal,
                                 window, qs, ks, vs, os, st);
}
