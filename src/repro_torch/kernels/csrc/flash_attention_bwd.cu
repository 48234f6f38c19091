// Backward of prefill (flash) attention for Hopper (sm_90a), written by hand
// in CUDA C++.
//
// The gradient of flash_attention.cu, the port of the Pallas TPU kernel
// `flash_attention_kernel` (src/repro/kernels/flash_attention/kernel.py).
// The TPU package has no backward kernel: its trainer differentiates the
// plain jnp attention (src/repro/models/attention.py:attn_forward).  Given
// q [B,H,S,hd], k/v [B,K,S,hd] (GQA, kv head = h / G), the forward's output
// O and row log-sum-exp `lse` (natural log of sum exp(scale q.k)), and the
// output gradient dO (float32), it computes, in float32:
//
//   D  = rowsum(dO * O)                  (pre-pass, one warp a row)
//   P  = exp(scale q.k - lse)            on the visible pairs, else 0
//   dV = P^T dO,   dS = P * (dO V^T - D)
//   dK = scale dS^T Q,   dQ = scale dS K
//
// with dK and dV summed over the G query heads of each kv head.
//
// What bounds it on this card: operations, 2.5x the forward's 4 hd FLOPs a
// visible pair (the Q K^T and dO V^T products are recomputed; each kernel
// below does its own), against a few bytes a pair.  This first design runs
// every product as float32 FMAs on the CUDA cores out of shared memory,
// for both input types; tensor cores (mma.sync / wgmma) and TMA are later
// work.
//
//   * dK/dV: one block per (64-key tile, kv head, batch) keeps its K and V
//     tiles and its dK / dV accumulators (registers) and loops over the G
//     query heads and, for each, over the query tiles that can see a key
//     of the tile; key tile 0 (the most query tiles under a causal mask)
//     first.
//   * dQ: one block per (64-row query tile, head, batch) keeps Q, dO, lse
//     and D and loops over the visible key tiles, as the forward does;
//     heaviest (latest) causal tiles first.
//   * No float atomics anywhere: every gradient element is summed by one
//     thread in a fixed order, so gradients are bit-reproducible run to run.
//   * Dead tiles are never visited (the same live ranges as the forward);
//     ragged rows and masked pairs contribute an exact 0 and are never
//     exponentiated.
//   * Tiles of 64 rows up to head_dim 128 and of 32 rows above, so the four
//     float32 tiles (Q, dO, K, V) fit in shared memory at head_dim 256
//     (142 KB); 256 threads as 16 x 16, each owning a (BT/16) x (BT/16)
//     piece of the score tile and (BT/16) rows x (hd/16) columns of an
//     accumulator.
//   * Every operand is addressed through (batch, head, row) strides with
//     head_dim contiguous and read four elements at a time.
#include "common.cuh"

namespace {

constexpr int NT = 256;  // threads: 16 x 16, thread (ty, tx)

struct Strides { int64_t b, h, s; };

__device__ __forceinline__ bool visible(int qpos, int kpos, int S, int causal,
                                        int window) {
    return qpos < S && kpos < S && (!causal || qpos >= kpos) &&
           (window < 0 || qpos - kpos < window);
}

// Rows [row0, row0 + BT) of a [S, hd] matrix into a [BT][ld] float tile,
// rows >= S zero-filled; four elements a thread a step.
template <typename T, int BT>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int64_t row_stride, int row0, int S,
                                          int hd, int ld) {
    const int q4 = hd / 4;
    for (int idx = threadIdx.x; idx < BT * q4; idx += NT) {
        const int r = idx / q4, c = (idx - r * q4) * 4;
        const int row = row0 + r;
        float x[4] = {0.f, 0.f, 0.f, 0.f};
        if (row < S) load_row<T, 4>(src + row * row_stride + c, x);
        *reinterpret_cast<float4*>(&dst[r * ld + c]) = make_float4(x[0], x[1], x[2], x[3]);
    }
}

// lse and D of rows [row0, row0 + BT) into shared memory (0 past S).
template <int BT>
__device__ __forceinline__ void load_rows(float* sl, float* sd,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ delta,
                                          int row0, int S) {
    for (int r = threadIdx.x; r < BT; r += NT) {
        const bool in = row0 + r < S;
        sl[r] = in ? lse[row0 + r] : 0.f;
        sd[r] = in ? delta[row0 + r] : 0.f;
    }
}

// acc[i][j] = a-row (ty + 16 i) . b-row (tx + 16 j) over hd columns.
template <int RT>
__device__ __forceinline__ void dot_tile(float (&acc)[RT][RT], const float* sa,
                                         const float* sb, int hd, int ld,
                                         int ty, int tx) {
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < RT; ++j) acc[i][j] = 0.f;
    for (int d = 0; d < hd; d += 4) {
        float4 a[RT], c[RT];
#pragma unroll
        for (int i = 0; i < RT; ++i)
            a[i] = *reinterpret_cast<const float4*>(&sa[(ty + 16 * i) * ld + d]);
#pragma unroll
        for (int j = 0; j < RT; ++j)
            c[j] = *reinterpret_cast<const float4*>(&sb[(tx + 16 * j) * ld + d]);
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
            for (int j = 0; j < RT; ++j)
                acc[i][j] += a[i].x * c[j].x + a[i].y * c[j].y +
                             a[i].z * c[j].z + a[i].w * c[j].w;
    }
}

// From the scores s (query rows ty + 16 i, key columns tx + 16 j) and dP =
// dO V^T of one (query tile q0, key tile k0) pair: P = exp(scale s - lse)
// on visible pairs (0 elsewhere) into sp (if given) and dS = P (dP - D)
// into sds, both [BT][BT + 1] indexed [query][key].
template <int RT>
__device__ __forceinline__ void p_and_ds(const float (&s)[RT][RT],
                                         const float (&dp)[RT][RT],
                                         const float* sl, const float* sd,
                                         float* sp, float* sds, int lds, int q0,
                                         int k0, int S, int causal, int window,
                                         float scale, int ty, int tx) {
#pragma unroll
    for (int i = 0; i < RT; ++i) {
        const int r = ty + 16 * i;
        const float l = sl[r], dd = sd[r];
#pragma unroll
        for (int j = 0; j < RT; ++j) {
            const int c = tx + 16 * j;
            const float p = visible(q0 + r, k0 + c, S, causal, window)
                                ? expf(fmaf(s[i][j], scale, -l)) : 0.f;
            if (sp != nullptr) sp[r * lds + c] = p;
            sds[r * lds + c] = p * (dp[i][j] - dd);
        }
    }
}

// D[b, h, row] = sum_d dO * O, one warp a row.
__global__ void __launch_bounds__(NT)
flash_bwd_delta_kernel(const float* __restrict__ out, const float* __restrict__ dout,
                       float* __restrict__ delta, int H, int S, int hd, int64_t rows,
                       Strides os, Strides dos) {
    const int64_t row_id = ((int64_t)blockIdx.x * NT + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (row_id >= rows) return;
    const int row = (int)(row_id % S);
    const int64_t bh = row_id / S;
    const int h = (int)(bh % H), b = (int)(bh / H);
    const float* o = out + b * os.b + h * os.h + row * os.s;
    const float* g = dout + b * dos.b + h * dos.h + row * dos.s;
    float acc = 0.f;
    for (int d = lane; d < hd; d += 32) acc += o[d] * g[d];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) delta[row_id] = acc;
}

// dK and dV of one (key tile, kv head, batch); DPT: accumulator columns a
// thread (d = tx + 16 j).
template <typename T, int BT, int DPT>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, int G, int S,
                      int hd, int causal, int window, float scale, Strides qs,
                      Strides ks, Strides vs, Strides dos, Strides dks,
                      Strides dvs) {
    constexpr int RT = BT / 16;
    constexpr int LDS = BT + 1;
    extern __shared__ __align__(16) float smem[];
    const int ld = hd + 4;            // keeps rows 16-byte aligned, spreads banks
    float* sk = smem;                 // [BT][ld]
    float* sv = sk + BT * ld;         // [BT][ld]
    float* sq = sv + BT * ld;         // [BT][ld] this step's query rows
    float* sdo = sq + BT * ld;        // [BT][ld] their output gradient
    float* sp = sdo + BT * ld;        // [BT][LDS] P      [query][key]
    float* sds = sp + BT * LDS;       // [BT][LDS] dS     [query][key]
    float* sl = sds + BT * LDS;       // [BT] lse of the query rows
    float* sd = sl + BT;              // [BT] D of the query rows

    const int k0 = blockIdx.x * BT;
    const int kvh = blockIdx.y, b = blockIdx.z;
    const int H = G * gridDim.y;
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

    load_tile<T, BT>(sk, k + b * ks.b + kvh * ks.h, ks.s, k0, S, hd, ld);
    load_tile<T, BT>(sv, v + b * vs.b + kvh * vs.h, vs.s, k0, S, hd, ld);

    float dka[RT][DPT], dva[RT][DPT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) dka[i][j] = dva[i][j] = 0.f;

    // the query tiles that can see a key of this tile
    const int k_last = min(k0 + BT, S) - 1;
    const int qt_lo = causal ? k0 / BT : 0;
    const int qt_hi = (window >= 0 ? min(S - 1, k_last + window - 1) : S - 1) / BT;
    for (int g = 0; g < G; ++g) {
        const int h = kvh * G + g;
        const T* qh = q + b * qs.b + h * qs.h;
        const float* doh = dout + b * dos.b + h * dos.h;
        const int64_t rows = ((int64_t)b * H + h) * S;
        for (int qt = qt_lo; qt <= qt_hi; ++qt) {
            const int q0 = qt * BT;
            __syncthreads();          // the previous step is done with sq .. sd
            load_tile<T, BT>(sq, qh, qs.s, q0, S, hd, ld);
            load_tile<float, BT>(sdo, doh, dos.s, q0, S, hd, ld);
            load_rows<BT>(sl, sd, lse + rows, delta + rows, q0, S);
            __syncthreads();

            float s[RT][RT], dp[RT][RT];
            dot_tile<RT>(s, sq, sk, hd, ld, ty, tx);
            dot_tile<RT>(dp, sdo, sv, hd, ld, ty, tx);
            p_and_ds<RT>(s, dp, sl, sd, sp, sds, LDS, q0, k0, S, causal, window,
                         scale, ty, tx);
            __syncthreads();

            // dV += P^T dO, dK += dS^T Q: key rows ty + 16 i, columns tx + 16 j
            for (int r = 0; r < BT; ++r) {
                float pr[RT], dsr[RT];
#pragma unroll
                for (int i = 0; i < RT; ++i) {
                    pr[i] = sp[r * LDS + ty + 16 * i];
                    dsr[i] = sds[r * LDS + ty + 16 * i];
                }
#pragma unroll
                for (int j = 0; j < DPT; ++j) {
                    const int d = tx + 16 * j;
                    if (d < hd) {
                        const float o = sdo[r * ld + d], x = sq[r * ld + d];
#pragma unroll
                        for (int i = 0; i < RT; ++i) {
                            dva[i][j] = fmaf(pr[i], o, dva[i][j]);
                            dka[i][j] = fmaf(dsr[i], x, dka[i][j]);
                        }
                    }
                }
            }
        }
    }

    float* dkb = dk + b * dks.b + kvh * dks.h;
    float* dvb = dv + b * dvs.b + kvh * dvs.h;
#pragma unroll
    for (int i = 0; i < RT; ++i) {
        const int row = k0 + ty + 16 * i;
        if (row >= S) continue;
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
            const int d = tx + 16 * j;
            if (d < hd) {
                dkb[row * dks.s + d] = dka[i][j] * scale;
                dvb[row * dvs.s + d] = dva[i][j];
            }
        }
    }
}

// dQ of one (query tile, head, batch).
template <typename T, int BT, int DPT>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int G, int S, int hd, int causal,
                    int window, float scale, Strides qs, Strides ks, Strides vs,
                    Strides dos, Strides dqs) {
    constexpr int RT = BT / 16;
    constexpr int LDS = BT + 1;
    extern __shared__ __align__(16) float smem[];
    const int ld = hd + 4;
    float* sq = smem;                 // [BT][ld]
    float* sdo = sq + BT * ld;        // [BT][ld]
    float* sk = sdo + BT * ld;        // [BT][ld] this step's keys
    float* sv = sk + BT * ld;         // [BT][ld] and values
    float* sds = sv + BT * ld;        // [BT][LDS] dS [query][key]
    float* sl = sds + BT * LDS;       // [BT]
    float* sd = sl + BT;              // [BT]

    // heaviest (latest) causal tiles first
    const int q0 = (gridDim.x - 1 - blockIdx.x) * BT;
    const int h = blockIdx.y, b = blockIdx.z;
    const int H = gridDim.y;
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
    const int64_t rows = ((int64_t)b * H + h) * S;

    load_tile<T, BT>(sq, q + b * qs.b + h * qs.h, qs.s, q0, S, hd, ld);
    load_tile<float, BT>(sdo, dout + b * dos.b + h * dos.h, dos.s, q0, S, hd, ld);
    load_rows<BT>(sl, sd, lse + rows, delta + rows, q0, S);
    const T* kb = k + b * ks.b + (h / G) * ks.h;
    const T* vb = v + b * vs.b + (h / G) * vs.h;

    float dqa[RT][DPT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) dqa[i][j] = 0.f;

    const int q_last = min(q0 + BT, S) - 1;
    const int kt_lo = window >= 0 ? max(q0 - window + 1, 0) / BT : 0;
    const int kt_hi = (causal ? q_last : S - 1) / BT;
    for (int kt = kt_lo; kt <= kt_hi; ++kt) {
        const int k0 = kt * BT;
        __syncthreads();              // the previous step is done with sk, sv, sds
        load_tile<T, BT>(sk, kb, ks.s, k0, S, hd, ld);
        load_tile<T, BT>(sv, vb, vs.s, k0, S, hd, ld);
        __syncthreads();

        float s[RT][RT], dp[RT][RT];
        dot_tile<RT>(s, sq, sk, hd, ld, ty, tx);
        dot_tile<RT>(dp, sdo, sv, hd, ld, ty, tx);
        p_and_ds<RT>(s, dp, sl, sd, nullptr, sds, LDS, q0, k0, S, causal, window,
                     scale, ty, tx);
        __syncthreads();

        // dQ += dS K: query rows ty + 16 i, columns tx + 16 j
        for (int c = 0; c < BT; ++c) {
            float dsr[RT];
#pragma unroll
            for (int i = 0; i < RT; ++i) dsr[i] = sds[(ty + 16 * i) * LDS + c];
#pragma unroll
            for (int j = 0; j < DPT; ++j) {
                const int d = tx + 16 * j;
                if (d < hd) {
                    const float x = sk[c * ld + d];
#pragma unroll
                    for (int i = 0; i < RT; ++i) dqa[i][j] = fmaf(dsr[i], x, dqa[i][j]);
                }
            }
        }
    }

    float* dqb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
    for (int i = 0; i < RT; ++i) {
        const int row = q0 + ty + 16 * i;
        if (row >= S) continue;
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
            const int d = tx + 16 * j;
            if (d < hd) dqb[row * dqs.s + d] = dqa[i][j] * scale;
        }
    }
}

struct Args {
    const void *q, *k, *v;
    const float *out, *dout, *lse;
    float *delta, *dq, *dk, *dv;
    int B, H, K, S, hd, causal, window;
    Strides qs, ks, vs, os, dos, dqs, dks, dvs;
};

template <typename T, int BT, int DPT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
    constexpr int LDS = BT + 1;
    const int ld = a.hd + 4;
    const size_t smem_dkdv = ((size_t)4 * BT * ld + 2 * BT * LDS + 2 * BT) * sizeof(float);
    const size_t smem_dq = ((size_t)4 * BT * ld + BT * LDS + 2 * BT) * sizeof(float);
    auto dkdv = flash_bwd_dkdv_kernel<T, BT, DPT>;
    auto dq = flash_bwd_dq_kernel<T, BT, DPT>;
    cudaError_t err = cudaFuncSetAttribute(
        dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dkdv);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_dq);
    if (err != cudaSuccess) return err;

    const int64_t rows = (int64_t)a.B * a.H * a.S;
    flash_bwd_delta_kernel<<<(unsigned)((rows * 32 + NT - 1) / NT), NT, 0, stream>>>(
        a.out, a.dout, a.delta, a.H, a.S, a.hd, rows, a.os, a.dos);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;

    const float scale = 1.0f / sqrtf((float)a.hd);
    const int G = a.H / a.K;
    const int tiles = (a.S + BT - 1) / BT;
    dkdv<<<dim3(tiles, a.K, a.B), NT, smem_dkdv, stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, a.dout, a.lse, a.delta, a.dk,
        a.dv, G, a.S, a.hd, a.causal, a.window, scale, a.qs, a.ks, a.vs, a.dos,
        a.dks, a.dvs);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    dq<<<dim3(tiles, a.H, a.B), NT, smem_dq, stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, a.dout, a.lse, a.delta, a.dq,
        G, a.S, a.hd, a.causal, a.window, scale, a.qs, a.ks, a.vs, a.dos, a.dqs);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const Args& a, cudaStream_t stream) {
    if (a.hd <= 16) return launch<T, 64, 1>(a, stream);
    if (a.hd <= 32) return launch<T, 64, 2>(a, stream);
    if (a.hd <= 64) return launch<T, 64, 4>(a, stream);
    if (a.hd <= 128) return launch<T, 64, 8>(a, stream);
    return launch<T, 32, 16>(a, stream);
}

}  // namespace

// q [B,H,S,hd], k/v [B,K,S,hd] of `dtype`; out, dout [B,H,S,hd] f32 (the
// forward's output and its gradient); lse [B,H,S] f32 contiguous (the
// forward's); delta [B,H,S] f32 contiguous scratch; dq [B,H,S,hd], dk, dv
// [B,K,S,hd] f32 outputs.  Strides: (batch, head, row) of q, k, v, out,
// dout, dq, dk, dv in elements, head_dim contiguous, every stride and
// pointer aligned to 4 elements (the wrapper checks or copies).  Needs
// hd <= 256 and hd % 4 == 0.  window < 0 means none.  Returns the first
// launch's cudaError_t (0 = all three launched).
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* out, const void* dout,
                                          const void* lse, void* delta, void* dq,
                                          void* dk, void* dv, int B, int H, int K,
                                          int S, int hd, int causal, int window,
                                          int dtype, const int64_t* strides,
                                          void* stream) {
    if (B == 0 || S == 0) return 0;
    Args a;
    a.q = q; a.k = k; a.v = v;
    a.out = (const float*)out; a.dout = (const float*)dout; a.lse = (const float*)lse;
    a.delta = (float*)delta; a.dq = (float*)dq; a.dk = (float*)dk; a.dv = (float*)dv;
    a.B = B; a.H = H; a.K = K; a.S = S; a.hd = hd; a.causal = causal; a.window = window;
    Strides* all[8] = {&a.qs, &a.ks, &a.vs, &a.os, &a.dos, &a.dqs, &a.dks, &a.dvs};
    for (int i = 0; i < 8; ++i)
        *all[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == DTYPE_BF16) return (int)launch_hd<__nv_bfloat16>(a, st);
    return (int)launch_hd<float>(a, st);
}
