// Paged decode attention for Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces the Pallas TPU kernel `_kernel` / `paged_attention_kernel` of
// src/repro/kernels/paged_attention/kernel.py: one query token per sequence
// attends over its paged KV cache by walking the sequence's block table.
//
// What bounds it on this card: the live KV bytes over HBM bandwidth (each
// live K and V row is read once; the arithmetic is ~2 FLOP per byte).  The
// design therefore is about bytes in flight, not tensor cores:
//   * one block per (sequence, kv head); its 8 warps take the block-table
//     columns round-robin, so 8 frames per block are streaming at any time
//     (the in-block form of split-KV) and are merged once at the end;
//   * the block reads the frame id itself and computes the K/V pointers
//     from it — the block table is the page table, no gathered copy of the
//     cache is ever made (on the TPU the same id rode scalar prefetch);
//   * the G query heads that share a kv head reuse every K/V row from
//     registers, so the row is read from memory once per group;
//   * a lane owns EPL consecutive head_dim elements: one row is one
//     coalesced, vectorised warp load;
//   * masked slots (beyond seq_len, before the window, absent frames) are
//     skipped, never multiplied: stale slab contents cannot reach the sum.
// The TPU's sequential grid axis with m/l/acc in VMEM scratch is the loop
// over columns here, with the online-softmax state in registers.
#include "common.cuh"

namespace {

constexpr int NW = 8;  // warps per block
constexpr int TC = 4;  // tokens per online-softmax update

template <typename T, int EPL, int GT>
__global__ void __launch_bounds__(NW * 32)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_slabs,
                       const T* __restrict__ v_slabs,
                       const int* __restrict__ tables,
                       const int* __restrict__ lens, float* __restrict__ out,
                       int H, int K, int hd, int bt, int MB, int window,
                       float scale) {
    const int b = blockIdx.x;
    const int kh = blockIdx.y;
    const int G = H / K;
    const int g0 = blockIdx.z * GT;  // first query head of the group in this pass
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int d0 = lane * EPL;
    const bool lane_on = d0 < hd;
    const int seq_len = lens[b];
    const int lo = window >= 0 ? max(seq_len - window, 0) : 0;
    const int64_t row_stride = (int64_t)K * hd;       // one token
    const int64_t frame_stride = (int64_t)bt * row_stride;

    float qr[GT][EPL];
    float m[GT], l[GT], acc[GT][EPL];
#pragma unroll
    for (int g = 0; g < GT; ++g) {
        m[g] = NEG_INF;
        l[g] = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) { acc[g][e] = 0.f; qr[g][e] = 0.f; }
        if (lane_on && g0 + g < G)
            load_row<T, EPL>(q + ((int64_t)b * H + kh * G + g0 + g) * hd + d0, qr[g]);
    }

    const int n_cols = min(MB, (seq_len + bt - 1) / bt);
    for (int col = lo / bt + warp; col < n_cols; col += NW) {
        const int frame = tables[(int64_t)b * MB + col];
        if (frame < 0) continue;
        const T* kf = k_slabs + frame * frame_stride + (int64_t)kh * hd + d0;
        const T* vf = v_slabs + frame * frame_stride + (int64_t)kh * hd + d0;
        for (int t0 = 0; t0 < bt; t0 += TC) {
            bool ok[TC];
            bool any = false;
#pragma unroll
            for (int c = 0; c < TC; ++c) {
                const int pos = col * bt + t0 + c;
                ok[c] = (t0 + c < bt) && pos >= lo && pos < seq_len;
                any |= ok[c];
            }
            if (!any) continue;

            float s[GT][TC];
#pragma unroll
            for (int c = 0; c < TC; ++c) {
                if (ok[c]) {            // uniform across the warp
                    float kr[EPL];
#pragma unroll
                    for (int e = 0; e < EPL; ++e) kr[e] = 0.f;
                    if (lane_on) load_row<T, EPL>(kf + (t0 + c) * row_stride, kr);
#pragma unroll
                    for (int g = 0; g < GT; ++g) {
                        float part = 0.f;
#pragma unroll
                        for (int e = 0; e < EPL; ++e) part += qr[g][e] * kr[e];
#pragma unroll
                        for (int off = 16; off > 0; off >>= 1)
                            part += __shfl_xor_sync(0xffffffffu, part, off);
                        s[g][c] = part * scale;
                    }
                } else {
#pragma unroll
                    for (int g = 0; g < GT; ++g) s[g][c] = NEG_INF;
                }
            }
#pragma unroll
            for (int g = 0; g < GT; ++g) {
                float m_new = m[g];
#pragma unroll
                for (int c = 0; c < TC; ++c) m_new = fmaxf(m_new, s[g][c]);
                const float alpha = expf(m[g] - m_new);
                float sum = 0.f;
#pragma unroll
                for (int c = 0; c < TC; ++c) {
                    s[g][c] = ok[c] ? expf(s[g][c] - m_new) : 0.f;
                    sum += s[g][c];
                }
                l[g] = l[g] * alpha + sum;
                m[g] = m_new;
#pragma unroll
                for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
            }
#pragma unroll
            for (int c = 0; c < TC; ++c) {
                if (ok[c] && lane_on) {
                    float vr[EPL];
                    load_row<T, EPL>(vf + (t0 + c) * row_stride, vr);
#pragma unroll
                    for (int g = 0; g < GT; ++g)
#pragma unroll
                        for (int e = 0; e < EPL; ++e) acc[g][e] += s[g][c] * vr[e];
                }
            }
        }
    }

    // merge the warps' partial softmax states, one query head at a time
    __shared__ float sm_acc[NW][256];
    __shared__ float sm_m[NW];
    __shared__ float sm_l[NW];
#pragma unroll
    for (int g = 0; g < GT; ++g) {
        const bool head_on = g0 + g < G;   // uniform across the block
        __syncthreads();
        if (head_on) {
            if (lane_on) {
#pragma unroll
                for (int e = 0; e < EPL; ++e) sm_acc[warp][d0 + e] = acc[g][e];
            }
            if (lane == 0) { sm_m[warp] = m[g]; sm_l[warp] = l[g]; }
        }
        __syncthreads();
        const int d = threadIdx.x;
        if (head_on && d < hd) {
            float mx = NEG_INF;
            for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm_m[w]);
            float den = 0.f, num = 0.f;
            for (int w = 0; w < NW; ++w) {
                const float f = expf(sm_m[w] - mx);
                den += sm_l[w] * f;
                num += sm_acc[w][d] * f;
            }
            out[((int64_t)b * H + kh * G + g0 + g) * hd + d] = num / fmaxf(den, 1e-30f);
        }
    }
}

template <typename T, int EPL>
cudaError_t launch_gt(const void* q, const void* k, const void* v,
                      const int* tables, const int* lens, float* out, int B,
                      int H, int K, int hd, int bt, int MB, int window,
                      cudaStream_t stream) {
    const int G = H / K;
    const int gt = G >= 8 ? 8 : (G > 2 ? (G > 4 ? 8 : 4) : G);
    const dim3 grid(B, K, (G + gt - 1) / gt);
    const float scale = 1.0f / sqrtf((float)hd);
#define PA_LAUNCH(GT)                                                          \
    paged_attention_kernel<T, EPL, GT><<<grid, NW * 32, 0, stream>>>(          \
        (const T*)q, (const T*)k, (const T*)v, tables, lens, out, H, K, hd,    \
        bt, MB, window, scale)
    switch (gt) {
        case 1: PA_LAUNCH(1); break;
        case 2: PA_LAUNCH(2); break;
        case 4: PA_LAUNCH(4); break;
        default: PA_LAUNCH(8); break;
    }
#undef PA_LAUNCH
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_epl(const void* q, const void* k, const void* v,
                       const int* tables, const int* lens, float* out, int B,
                       int H, int K, int hd, int bt, int MB, int window,
                       cudaStream_t stream) {
    const int per_lane = (hd + 31) / 32;
#define PA_ARGS q, k, v, tables, lens, out, B, H, K, hd, bt, MB, window, stream
    if (per_lane <= 1) return launch_gt<T, 1>(PA_ARGS);
    if (per_lane <= 2) return launch_gt<T, 2>(PA_ARGS);
    if (per_lane <= 4) return launch_gt<T, 4>(PA_ARGS);
    return launch_gt<T, 8>(PA_ARGS);
#undef PA_ARGS
}

}  // namespace

// q [B,H,hd], k/v_slabs [N,bt,K,hd] (one layer, contiguous, all of `dtype`),
// tables [B,MB] i32 physical frames (-1 absent), lens [B] i32, out [B,H,hd]
// f32.  window < 0 means none.  Needs hd <= 256 and hd a multiple of the
// per-lane width (the next power of two >= ceil(hd/32)); the wrapper checks.
// Returns the launch's cudaError_t (0 = launched).
extern "C" int paged_attention_launch(const void* q, const void* k_slabs,
                                      const void* v_slabs, const void* tables,
                                      const void* lens, void* out, int B, int H,
                                      int K, int hd, int bt, int MB, int window,
                                      int dtype, void* stream) {
    if (B == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == DTYPE_BF16)
        return (int)launch_epl<__nv_bfloat16>(q, k_slabs, v_slabs,
                                              (const int*)tables, (const int*)lens,
                                              (float*)out, B, H, K, hd, bt, MB,
                                              window, st);
    return (int)launch_epl<float>(q, k_slabs, v_slabs, (const int*)tables,
                                  (const int*)lens, (float*)out, B, H, K, hd, bt,
                                  MB, window, st);
}
