// Prefill (flash) attention for Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces the Pallas TPU kernel `_kernel` / `flash_attention_kernel` of
// src/repro/kernels/flash_attention/kernel.py: blocked attention with
// online softmax, GQA (kv head = h / G), causal and/or sliding window or
// bidirectional, float32 output.
//
// What bounds it on this card: operations — 4*B*H*hd*(live q.k pairs) FLOPs
// against a few bytes per pair.  Two kernels share the block shape below:
//
// bfloat16 inputs (the serving path) run on the tensor cores
// (`flash_attention_bf16_kernel`), FlashAttention-2 shaped: 4 warps, each
// owning 16 q rows; S = Q K^T and O += P V as `mma.sync.m16n8k16` with f32
// accumulators; Q, K and V fragments come from shared memory by `ldmatrix`
// (rows padded by 16 bytes so the eight rows of a matrix hit eight different
// bank quads); K/V tiles go through a two-stage `cp.async` ring, so tile
// kt+1 is in flight while tile kt computes, with rows past S zero-filled (a
// garbage V row times a masked p of 0 could still give NaN).  The scores'
// C fragments become P's A fragments in registers, without a round trip
// through shared memory.
//
// P is split into two bf16 halves, hi = bf16(p) and lo = bf16(p - hi), and
// P V is two products into one f32 accumulator, so the result stays within
// ~1e-5 of the f32 product (V is exact in bf16).  Rounding P to one bf16
// value, as stock flash kernels do, misses the f32 plain version by 4.2e-3
// at [2,40,1024,128] causal; the split misses by 5.7e-6 (CPU emulation of
// both), well inside the 1e-4 bound that still sees a dropped 64-key tile
// (0.014 on late rows).  The split costs P V a second pass, 1.5x the FLOPs
// of the bound.
//
// Why `mma.sync` and not `wgmma` + TMA with warp specialisation: the latter
// would save a further ~0.1-0.3 ms a launch at the serving shape, about 1 %
// of a prefill that the cuBLAS products dominate, for much more code.
//
// float32 inputs keep the first design (`flash_attention_kernel`): both
// products as float32 FMAs on the CUDA cores out of shared memory, so f32
// inputs keep full precision.  Each thread owns a 4x4 piece of the score
// tile and the matching rows of the output.
//
// Common to both:
//   * one block per (batch, head, 64-row q tile), heaviest (latest) causal
//     tiles first; the TPU's sequential k grid axis is the loop over 64-row
//     k tiles inside the block, with m / l / acc in registers instead of
//     VMEM scratch;
//   * the k loop runs only over the live range
//     [(q_start - window + 1) / BK, (q_start + BQ - 1) / BK]: dead tiles are
//     never visited, where the TPU kernel predicates them off;
//   * ragged edges are masked, so S need not divide the tile; masked
//     entries contribute an exact 0 (they are not exponentiated);
//   * q, k, v and out are addressed through (batch, head, row) strides, so
//     the caller's [B,S,H,hd] projections are read in place as [B,H,S,hd];
//   * with a non-null `lse` each row's log-sum-exp is written beside the
//     output, as the backward (flash_attention_bwd.cu) reads it: the
//     natural log of sum exp(scale * q.k) over the visible keys.  The FMA
//     kernel keeps m in the scaled domain, the tensor-core kernel in the
//     unscaled one (exp2 of scale_log2 * x): each converts at its end.  The
//     serving path passes null and writes nothing.
#include "common.cuh"
#include "mma.cuh"

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
                       const T* __restrict__ v, float* __restrict__ out,
                       float* __restrict__ lse, int G, int S, int hd, int causal,
                       int window, float scale, Strides qs, Strides ks,
                       Strides vs, Strides os) {
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
        // m is the scaled row max here, l the sum of exp(s - m)
        if (lse != nullptr && tx == 0)
            lse[((int64_t)b * gridDim.y + h) * S + row] = m[i] + logf(fmaxf(l[i], 1e-30f));
    }
}

template <typename T, int DPT>
cudaError_t launch_dpt(const void* q, const void* k, const void* v, float* out,
                       float* lse, int B, int H, int K, int S, int hd, int causal,
                       int window,
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
                                       lse, H / K, S, hd, causal, window, scale,
                                       qs, ks, vs, os);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const void* q, const void* k, const void* v, float* out,
                      float* lse, int B, int H, int K, int S, int hd, int causal,
                      int window,
                      Strides qs, Strides ks, Strides vs, Strides os,
                      cudaStream_t stream) {
    const int per_thread = (hd + 15) / 16;
#define FA_ARGS q, k, v, out, lse, B, H, K, S, hd, causal, window, qs, ks, vs, os, stream
    if (per_thread <= 1) return launch_dpt<T, 1>(FA_ARGS);
    if (per_thread <= 2) return launch_dpt<T, 2>(FA_ARGS);
    if (per_thread <= 4) return launch_dpt<T, 4>(FA_ARGS);
    if (per_thread <= 8) return launch_dpt<T, 8>(FA_ARGS);
    return launch_dpt<T, 16>(FA_ARGS);
#undef FA_ARGS
}

// ------------------------------------------------ bf16 on the tensor cores
constexpr int TC_WARPS = 4;                  // each owns 16 of the BQ q rows
constexpr int TC_NT = 32 * TC_WARPS;
static_assert(BQ == 16 * TC_WARPS && BQ == BK, "one 16-row slice a warp");

// Start the copy of rows [row0, row0 + 64) of a [S, hd] bf16 matrix into a
// [64][HDP + 8] shared tile; rows >= S and columns >= hd are zero-filled.
template <int HDP>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* __restrict__ src,
                                                int64_t row_stride, int row0,
                                                int S, int hd) {
    constexpr int CH = HDP / 8;              // 16-byte chunks a row
    static_assert(BK * CH % TC_NT == 0, "every thread copies whole chunks");
#pragma unroll
    for (int i = 0; i < BK * CH / TC_NT; ++i) {
        const int idx = threadIdx.x + i * TC_NT;
        const int r = idx / CH, c = idx % CH;
        const int row = row0 + r;
        const bool ok = row < S && c * 8 < hd;
        cp_async_16(dst + r * (HDP + 8) + c * 8,
                    ok ? src + row * row_stride + c * 8 : src, ok ? 16 : 0);
    }
}

// HDP: head_dim rounded up to a power of two >= 16 (columns past hd are 0).
template <int HDP>
__global__ void __launch_bounds__(TC_NT)
flash_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            float* __restrict__ out, float* __restrict__ lse,
                            int G, int S, int hd, int causal, int window,
                            float scale_log2, Strides qs, Strides ks, Strides vs,
                            Strides os) {
    constexpr int LD = HDP + 8;              // +16 bytes: ldmatrix conflict-free
    constexpr int KSTEPS = HDP / 16;         // 16-wide slices of head_dim
    constexpr int DBLK = HDP / 8;            // 8-wide output column blocks
    constexpr int NBLK = BK / 8;             // 8-key column blocks of a score tile
    constexpr bool Q_IN_REGS = HDP <= 128;   // at 256 the registers run out
    extern __shared__ __align__(16) __nv_bfloat16 sbf[];
    __nv_bfloat16* sq = sbf;                 // [BQ][LD]
    __nv_bfloat16* skv = sq + BQ * LD;       // 2 stages of K [BK][LD], V [BK][LD]

    const int q_start = (gridDim.x - 1 - blockIdx.x) * BQ;
    const int h = blockIdx.y, b = blockIdx.z;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int row0 = q_start + 16 * warp + g;  // this lane's rows: row0, row0 + 8
    const __nv_bfloat16* kb = k + b * ks.b + (h / G) * ks.h;
    const __nv_bfloat16* vb = v + b * vs.b + (h / G) * vs.h;

    const int q_last = min(q_start + BQ, S) - 1;
    const int kt_lo = window >= 0 ? max(q_start - window + 1, 0) / BK : 0;
    const int kt_hi = (causal ? q_last : S - 1) / BK;

    load_tile_async<HDP>(sq, q + b * qs.b + h * qs.h, qs.s, q_start, S, hd);
    load_tile_async<HDP>(skv, kb, ks.s, kt_lo * BK, S, hd);
    load_tile_async<HDP>(skv + BK * LD, vb, vs.s, kt_lo * BK, S, hd);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // this warp's 16 q rows as A fragments, one per 16 columns of head_dim
    const __nv_bfloat16* sq_warp = sq + (16 * warp + (lane & 15)) * LD + (lane >> 4) * 8;
    uint32_t qf[Q_IN_REGS ? KSTEPS : 1][4];
    if constexpr (Q_IN_REGS) {
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) ldmatrix_x4(qf[kk], sq_warp + 16 * kk);
    }

    float acc[DBLK][4];
#pragma unroll
    for (int j = 0; j < DBLK; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // l: this lane's part

    for (int kt = kt_lo; kt <= kt_hi; ++kt) {
        const __nv_bfloat16* sk = skv + ((kt - kt_lo) & 1) * 2 * BK * LD;
        const __nv_bfloat16* sv = sk + BK * LD;
        if (kt < kt_hi) {                    // the next tile, into the other stage
            __nv_bfloat16* nk = skv + ((kt + 1 - kt_lo) & 1) * 2 * BK * LD;
            load_tile_async<HDP>(nk, kb, ks.s, (kt + 1) * BK, S, hd);
            load_tile_async<HDP>(nk + BK * LD, vb, vs.s, (kt + 1) * BK, S, hd);
            cp_async_commit();
        }

        // s = Q K^T: 16 rows x 64 keys a warp, as NBLK C fragments
        float s[NBLK][4];
#pragma unroll
        for (int j = 0; j < NBLK; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
        const __nv_bfloat16* sk_lane =
            sk + ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
            uint32_t a[4];
            if constexpr (Q_IN_REGS) {
#pragma unroll
                for (int c = 0; c < 4; ++c) a[c] = qf[kk][c];
            } else {
                ldmatrix_x4(a, sq_warp + 16 * kk);
            }
#pragma unroll
            for (int jj = 0; jj < NBLK / 2; ++jj) {   // keys 16 jj .. 16 jj + 15
                uint32_t kf[4];
                ldmatrix_x4(kf, sk_lane + 16 * jj * LD + 16 * kk);
                mma_bf16_16816(s[2 * jj], a, kf[0], kf[1]);
                mma_bf16_16816(s[2 * jj + 1], a, kf[2], kf[3]);
            }
        }

        // online softmax on the unscaled scores, exp(scale * (x - m)) as one
        // exp2 of an FMA; a row's 64 scores lie on the 4 lanes of a quad
        const int k_start = kt * BK;
        const bool edge = k_start + BK > S || (causal && k_start + BK - 1 > q_start) ||
                          (window >= 0 && q_start + BQ - 1 - k_start >= window);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int qpos = row0 + 8 * r;
            float mx = NEG_INF;
#pragma unroll
            for (int j = 0; j < NBLK; ++j)
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                    float& x = s[j][2 * r + c];
                    const bool ok = !edge || visible(qpos, k_start + 8 * j + 2 * t + c,
                                                     S, causal, window);
                    x = ok ? x : NEG_INF;
                    mx = fmaxf(mx, x);
                }
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float m_new = fmaxf(m[r], mx);
            const float alpha = exp2f((m[r] - m_new) * scale_log2);
            const float m_log2 = m_new * scale_log2;
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < NBLK; ++j)
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                    float& x = s[j][2 * r + c];
                    const bool ok = !edge || visible(qpos, k_start + 8 * j + 2 * t + c,
                                                     S, causal, window);
                    x = ok ? exp2f(fmaf(x, scale_log2, -m_log2)) : 0.f;
                    sum += x;
                }
            l[r] = l[r] * alpha + sum;
            m[r] = m_new;
#pragma unroll
            for (int j = 0; j < DBLK; ++j) {
                acc[j][2 * r] *= alpha;
                acc[j][2 * r + 1] *= alpha;
            }
        }

        // acc += P V, P = hi + lo; score blocks 2 kk2 and 2 kk2 + 1 are the
        // A fragment of keys 16 kk2 .. 16 kk2 + 15
        const __nv_bfloat16* sv_lane = sv + (lane & 15) * LD + (lane >> 4) * 8;
#pragma unroll
        for (int kk2 = 0; kk2 < BK / 16; ++kk2) {
            uint32_t hi[4], lo[4];
            split_p(s[2 * kk2][0], s[2 * kk2][1], hi[0], lo[0]);
            split_p(s[2 * kk2][2], s[2 * kk2][3], hi[1], lo[1]);
            split_p(s[2 * kk2 + 1][0], s[2 * kk2 + 1][1], hi[2], lo[2]);
            split_p(s[2 * kk2 + 1][2], s[2 * kk2 + 1][3], hi[3], lo[3]);
#pragma unroll
            for (int dd = 0; dd < DBLK / 2; ++dd) {   // columns 16 dd .. 16 dd + 15
                uint32_t vf[4];
                ldmatrix_x4_trans(vf, sv_lane + 16 * kk2 * LD + 16 * dd);
                mma_bf16_16816(acc[2 * dd], hi, vf[0], vf[1]);
                mma_bf16_16816(acc[2 * dd], lo, vf[0], vf[1]);
                mma_bf16_16816(acc[2 * dd + 1], hi, vf[2], vf[3]);
                mma_bf16_16816(acc[2 * dd + 1], lo, vf[2], vf[3]);
            }
        }

        cp_async_wait<0>();                  // the next tile has landed ...
        __syncthreads();                     // ... and no warp still reads this one
    }

    float* ob = out + b * os.b + h * os.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        float lr = l[r];
        lr += __shfl_xor_sync(0xffffffffu, lr, 1);
        lr += __shfl_xor_sync(0xffffffffu, lr, 2);
        if (row >= S) continue;
        const float inv = 1.0f / fmaxf(lr, 1e-30f);
#pragma unroll
        for (int j = 0; j < DBLK; ++j) {
            const int d = 8 * j + 2 * t;
            if (d < hd)
                *reinterpret_cast<float2*>(&ob[row * os.s + d]) =
                    make_float2(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
        }
        // m is the unscaled row max here and lr the sum of
        // 2^(scale_log2 (x - m)): ln(sum e^(scale x)) = ln 2 (m scale_log2 + log2 lr)
        if (lse != nullptr && t == 0)
            lse[((int64_t)b * gridDim.y + h) * S + row] =
                0.69314718f * fmaf(m[r], scale_log2, log2f(fmaxf(lr, 1e-30f)));
    }
}

template <int HDP>
cudaError_t launch_tc_hdp(const void* q, const void* k, const void* v, float* out,
                          float* lse, int B, int H, int K, int S, int hd,
                          int causal, int window, Strides qs, Strides ks,
                          Strides vs, Strides os, cudaStream_t stream) {
    const size_t smem = (size_t)(BQ + 4 * BK) * (HDP + 8) * sizeof(__nv_bfloat16);
    auto kernel = flash_attention_bf16_kernel<HDP>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((S + BQ - 1) / BQ, H, B);
    const float scale_log2 = 1.44269504f / sqrtf((float)hd);   // log2(e) / sqrt(hd)
    kernel<<<grid, TC_NT, smem, stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
        out, lse, H / K, S, hd, causal, window, scale_log2, qs, ks, vs, os);
    return cudaGetLastError();
}

cudaError_t launch_tc(const void* q, const void* k, const void* v, float* out,
                      float* lse, int B, int H, int K, int S, int hd, int causal,
                      int window, Strides qs, Strides ks, Strides vs, Strides os,
                      cudaStream_t stream) {
#define FA_ARGS q, k, v, out, lse, B, H, K, S, hd, causal, window, qs, ks, vs, os, stream
    if (hd <= 16) return launch_tc_hdp<16>(FA_ARGS);
    if (hd <= 32) return launch_tc_hdp<32>(FA_ARGS);
    if (hd <= 64) return launch_tc_hdp<64>(FA_ARGS);
    if (hd <= 128) return launch_tc_hdp<128>(FA_ARGS);
    return launch_tc_hdp<256>(FA_ARGS);
#undef FA_ARGS
}

}  // namespace

// q [B,H,S,hd], k/v [B,K,S,hd] of `dtype`, out [B,H,S,hd] f32, each given by
// its (batch, head, row) strides in elements with head_dim contiguous; lse
// null, or [B,H,S] f32 contiguous for the rows' log-sum-exp.
// window < 0 means none.  Needs hd <= 256 and hd % 4 == 0, H <= 65535 and
// B <= 65535 (grid limits); bf16 also needs hd % 16 == 0 and every stride a
// multiple of 8 elements (16-byte copies).  The wrapper checks.  Returns the
// launch's cudaError_t (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* out, void* lse, int B, int H, int K, int S,
                                      int hd, int causal, int window, int dtype,
                                      const int64_t* strides, void* stream) {
    if (B == 0 || S == 0) return 0;
    const Strides qs{strides[0], strides[1], strides[2]};
    const Strides ks{strides[3], strides[4], strides[5]};
    const Strides vs{strides[6], strides[7], strides[8]};
    const Strides os{strides[9], strides[10], strides[11]};
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == DTYPE_BF16)
        return (int)launch_tc(q, k, v, (float*)out, (float*)lse, B, H, K, S, hd,
                              causal, window, qs, ks, vs, os, st);
    return (int)launch_hd<float>(q, k, v, (float*)out, (float*)lse, B, H, K, S, hd,
                                 causal, window, qs, ks, vs, os, st);
}
