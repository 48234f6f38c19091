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
// below does its own), against a few bytes a pair.  Two forms share the
// pre-pass and the split of the work:
//
// bfloat16 inputs at head_dim <= 128 (the training path) run every product
// on the tensor cores (`flash_bwd_*_bf16_kernel`): `mma.sync.m16n8k16` with
// bf16 operands and float32 accumulators, 4 warps a block.  Q, K and V are
// exact in bf16; dO, P and dS are float32, and each goes in as two bf16
// halves, hi = bf16(x) and lo = bf16(x - hi):
//
//   dP = dO_hi V^T + dO_lo V^T        dV += P_hi dO_hi + P_hi dO_lo + P_lo dO_hi
//   dK += dS_hi Q + dS_lo Q           dQ += dS_hi K + dS_lo K
//
// with S recomputed once in each kernel: 13 products a visible pair against
// the bound's 5.  A single bf16 P and dS would miss the plain gradient by
// far more than the halves do (tests/test_torch_flash_bwd_split.py emulates
// both).  The pre-pass splits dO once, writes both halves to bf16 scratch
// that the wrapper allocates, and sets a flag when any lo half is nonzero.
// The train step's dO is bf16-valued (the model casts the attention output
// to bf16), so the flag stays 0 and both kernels skip the dO_lo copies and
// products on that uniform branch: 10 products a pair.
//   * dK/dV: one block per (64-key tile, kv head, batch), 16 keys a warp.
//     K and V stay in shared memory and dK, dV in registers; the block
//     walks the G query heads x the visible 32-row query tiles, whose Q and
//     dO-half tiles (and the rows' lse and D) are double-buffered by
//     `cp.async`.  The scores are computed key-major, S^T = K Q^T and
//     dP^T = V dO^T, so their accumulator fragments are the A operands of
//     dV += P^T dO and dK += dS^T Q in registers, with no trip through
//     shared memory.
//   * dQ: one block per (64-row query tile, head, batch), 16 rows a warp:
//     Q and the dO halves stay in shared memory, 32-key K/V tiles are
//     double-buffered, and dS goes from its fragments into dQ += dS K.
//   * Tile rows are padded by 16 bytes so `ldmatrix` is conflict-free; rows
//     past S and columns past hd are zero-filled.
// At head_dim 256, dK and dV alone would take 256 accumulator floats a
// thread, past the 255 registers a thread may have, so bf16 at 256 runs
// the float32 kernels (the wrapper's `bwd_route` says which).
//
// float32 inputs keep the first design: every product as float32 FMAs on
// the CUDA cores out of shared memory (`flash_bwd_dkdv_kernel`,
// `flash_bwd_dq_kernel`), tiles of 64 rows up to head_dim 128 and of 32
// above, 256 threads as 16 x 16, each owning a (BT/16) x (BT/16) piece of
// the score tile and (BT/16) rows x (hd/16) columns of an accumulator.
//
// Common to both:
//   * No float atomics anywhere: every gradient element is summed by one
//     thread in a fixed order, so gradients are bit-reproducible run to
//     run.  dQ has its own kernel, which recomputes S and dP, rather than
//     summing per-key-tile partials.
//   * Dead tiles are never visited (the same live ranges as the forward),
//     and the heaviest causal tiles go first; ragged rows and masked pairs
//     contribute an exact 0 and are never exponentiated.
//   * Every operand is addressed through (batch, head, row) strides with
//     head_dim contiguous.
//   * The logit soft-cap (`softcap` = c > 0; 0 is none), a template flag
//     (CAP) of every kernel, so the instances without it are the ones that
//     ran before: the forward's scores were y = c tanh(scale q.k / c), so
//     P = exp(y - lse) is recomputed from the capped score, and dS, the
//     gradient of y, is multiplied by dy / d(scale q.k) = 1 - tanh^2 before
//     dQ and dK take their `scale`.  tanhf, not tanh.approx.f32.
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int NT = 256;  // threads of the float32 kernels: 16 x 16, thread (ty, tx)

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
// into sds, both [BT][BT + 1] indexed [query][key].  CAP: P = exp(c th -
// lse) and dS times 1 - th^2, th = tanh(scale s / c).
template <int RT, bool CAP>
__device__ __forceinline__ void p_and_ds(const float (&s)[RT][RT],
                                         const float (&dp)[RT][RT],
                                         const float* sl, const float* sd,
                                         float* sp, float* sds, int lds, int q0,
                                         int k0, int S, int causal, int window,
                                         float scale, float cap, int ty, int tx) {
#pragma unroll
    for (int i = 0; i < RT; ++i) {
        const int r = ty + 16 * i;
        const float l = sl[r], dd = sd[r];
#pragma unroll
        for (int j = 0; j < RT; ++j) {
            const int c = tx + 16 * j;
            const bool ok = visible(q0 + r, k0 + c, S, causal, window);
            float p, ds;
            if constexpr (CAP) {
                const float th = tanhf(s[i][j] * scale / cap);
                p = ok ? expf(fmaf(cap, th, -l)) : 0.f;
                ds = p * (dp[i][j] - dd) * (1.f - th * th);
            } else {
                p = ok ? expf(fmaf(s[i][j], scale, -l)) : 0.f;
                ds = p * (dp[i][j] - dd);
            }
            if (sp != nullptr) sp[r * lds + c] = p;
            sds[r * lds + c] = ds;
        }
    }
}

// D[b, h, row] = sum_d dO * O, one warp a row.  With `dohi` non-null (the
// tensor-core form) it also writes dO's bf16 halves, contiguous [B,H,S,hd],
// and sets *lo_flag (zeroed by the launcher) when any lo half is nonzero.
__global__ void __launch_bounds__(NT)
flash_bwd_delta_kernel(const float* __restrict__ out, const float* __restrict__ dout,
                       float* __restrict__ delta, __nv_bfloat16* __restrict__ dohi,
                       __nv_bfloat16* __restrict__ dolo, int* __restrict__ lo_flag,
                       int H, int S, int hd, int64_t rows, Strides os, Strides dos) {
    const int64_t row_id = ((int64_t)blockIdx.x * NT + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (row_id >= rows) return;           // whole warps: one row a warp
    const int row = (int)(row_id % S);
    const int64_t bh = row_id / S;
    const int h = (int)(bh % H), b = (int)(bh / H);
    const float* o = out + b * os.b + h * os.h + row * os.s;
    const float* g = dout + b * dos.b + h * dos.h + row * dos.s;
    float acc = 0.f;
    bool lo_nonzero = false;
    for (int d = 2 * lane; d < hd; d += 64) {
        const float2 x = *reinterpret_cast<const float2*>(o + d);
        const float2 y = *reinterpret_cast<const float2*>(g + d);
        acc += x.x * y.x + x.y * y.y;
        if (dohi != nullptr) {
            uint32_t hi, lo;
            split_p(y.x, y.y, hi, lo);
            *reinterpret_cast<uint32_t*>(dohi + row_id * hd + d) = hi;
            *reinterpret_cast<uint32_t*>(dolo + row_id * hd + d) = lo;
            lo_nonzero |= lo != 0u;
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) delta[row_id] = acc;
    if (dohi != nullptr && __any_sync(0xffffffffu, lo_nonzero) && lane == 0)
        *lo_flag = 1;                     // every writer stores the same 1
}

// dK and dV of one (key tile, kv head, batch); DPT: accumulator columns a
// thread (d = tx + 16 j).
template <typename T, int BT, int DPT, bool CAP>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, int G, int S,
                      int hd, int causal, int window, float scale, float cap,
                      Strides qs,
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
            p_and_ds<RT, CAP>(s, dp, sl, sd, sp, sds, LDS, q0, k0, S, causal,
                              window, scale, cap, ty, tx);
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
template <typename T, int BT, int DPT, bool CAP>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int G, int S, int hd, int causal,
                    int window, float scale, float cap, Strides qs, Strides ks,
                    Strides vs,
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
        p_and_ds<RT, CAP>(s, dp, sl, sd, nullptr, sds, LDS, q0, k0, S, causal,
                          window, scale, cap, ty, tx);
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

// ------------------------------------------------ bf16 on the tensor cores
constexpr int TC_NT = 128;     // 4 warps, each owning 16 rows of the block's tile
constexpr int KV_ROWS = 64;    // dK/dV: keys a block
constexpr int KV_STEP = 32;    // ... query rows a step
constexpr int Q_ROWS = 64;     // dQ: query rows a block
constexpr int Q_STEP = 32;     // ... keys a step
constexpr float LOG2E = 1.44269504f;
static_assert(KV_ROWS == 16 * (TC_NT / 32) && Q_ROWS == 16 * (TC_NT / 32),
              "one 16-row slice a warp");

// Start the copy of rows [row0, row0 + ROWS) of a [S, hd] bf16 matrix into a
// [ROWS][HDP + 8] shared tile; rows >= S and columns >= hd are zero-filled.
template <int ROWS, int HDP>
__device__ __forceinline__ void copy_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* __restrict__ src,
                                          int64_t row_stride, int row0, int S,
                                          int hd) {
    constexpr int CH = HDP / 8;              // 16-byte chunks a row
    for (int idx = threadIdx.x; idx < ROWS * CH; idx += TC_NT) {
        const int r = idx / CH, c = idx % CH;
        const int row = row0 + r;
        const bool ok = row < S && c * 8 < hd;
        cp_async_16(dst + r * (HDP + 8) + c * 8,
                    ok ? src + row * row_stride + c * 8 : src, ok ? 16 : 0);
    }
}

// Lane offsets into a [rows][HDP + 8] tile for ldmatrix: the A operand
// (16 rows from the warp's first, k = columns), the B operand of a product
// with the tile's rows as n (k = columns, `ldmatrix_x4`: registers 0-1 are
// rows 0-7, 2-3 rows 8-15) and as k (`ldmatrix_x4_trans`: registers 0-1 are
// columns 0-7, 2-3 columns 8-15).
template <int LD>
__device__ __forceinline__ int a_lane(int lane) {
    return (lane & 15) * LD + (lane >> 4) * 8;
}
template <int LD>
__device__ __forceinline__ int bn_lane(int lane) {
    return ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
}

// acc (16 x 8NB, as NB blocks of 16 x 8) += A B^T over HDP columns: A the 16
// rows at `a` (from a_lane), B the 8NB rows at `bn` (from bn_lane).
template <int HDP, int NB>
__device__ __forceinline__ void mma_abt(float (&acc)[NB][4], const __nv_bfloat16* a,
                                        const __nv_bfloat16* bn) {
    constexpr int LD = HDP + 8;
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
        uint32_t af[4];
        ldmatrix_x4(af, a + 16 * kk);
#pragma unroll
        for (int jj = 0; jj < NB / 2; ++jj) {
            uint32_t bf[4];
            ldmatrix_x4(bf, bn + 16 * jj * LD + 16 * kk);
            mma_bf16_16816(acc[2 * jj], af, bf[0], bf[1]);
            mma_bf16_16816(acc[2 * jj + 1], af, bf[2], bf[3]);
        }
    }
}

// acc (16 x 16: columns 16 dd .. 16 dd + 15) += A0 B (+ A1 B): A0, A1 16 x 16
// fragments in registers, B the 16 rows at `bk` (from a_lane, read transposed).
template <bool TWO>
__device__ __forceinline__ void mma_ab(float (&acc)[2][4], const uint32_t (&a0)[4],
                                       const uint32_t (&a1)[4],
                                       const __nv_bfloat16* bk, int dd) {
    uint32_t bf[4];
    ldmatrix_x4_trans(bf, bk + 16 * dd);
    mma_bf16_16816(acc[0], a0, bf[0], bf[1]);
    mma_bf16_16816(acc[1], a0, bf[2], bf[3]);
    if constexpr (TWO) {
        mma_bf16_16816(acc[0], a1, bf[0], bf[1]);
        mma_bf16_16816(acc[1], a1, bf[2], bf[3]);
    }
}

// sum[2 dd + i] += part[i]: a step's products are summed from 0 on the
// tensor cores and added to the running sum here, with adds that round to
// nearest.  The tensor cores' float32 adds truncate, so a long chain of
// mma.sync into one accumulator drifts: dK and dV chained over 512 steps at
// Yi-6B's shape missed the plain gradient by 2.8e-5 of its largest value,
// against 6.2e-6 summed this way.
template <int DBLK>
__device__ __forceinline__ void add_part(float (&sum)[DBLK][4], const float (&part)[2][4],
                                         int dd) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) sum[2 * dd + i][c] += part[i][c];
}

// The A fragments (hi and lo halves) of the 16 x 16 slice made of two
// neighbouring C fragments, columns 0-7 and 8-15.
__device__ __forceinline__ void split_frag(const float (&c0)[4], const float (&c1)[4],
                                           uint32_t (&hi)[4], uint32_t (&lo)[4]) {
    split_p(c0[0], c0[1], hi[0], lo[0]);
    split_p(c0[2], c0[3], hi[1], lo[1]);
    split_p(c1[0], c1[1], hi[2], lo[2]);
    split_p(c1[2], c1[3], hi[3], lo[3]);
}

// dK and dV of one (64-key tile, kv head, batch).  HDP: head_dim rounded up
// to a power of two >= 16 (columns past hd are 0).  CAP: as p_and_ds.
template <int HDP, bool CAP>
__global__ void __launch_bounds__(TC_NT)
flash_bwd_dkdv_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ dohi,
                           const __nv_bfloat16* __restrict__ dolo,
                           const int* __restrict__ lo_flag,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta, float* __restrict__ dk,
                           float* __restrict__ dv, int G, int S, int hd, int causal,
                           int window, float scale, float scale_log2, float cap,
                           Strides qs, Strides ks, Strides vs, Strides dks,
                           Strides dvs) {
    const float cap_scale = CAP ? scale / cap : 0.f;
    const float cap_log2 = CAP ? cap * LOG2E : 0.f;
    constexpr int LD = HDP + 8;
    constexpr int DBLK = HDP / 8;            // 8-wide accumulator column blocks
    constexpr int NB = KV_STEP / 8;          // 8-query column blocks of S^T
    constexpr int STAGE = 3 * KV_STEP * LD;  // Q, dO_hi, dO_lo
    extern __shared__ __align__(16) __nv_bfloat16 sbf[];
    __nv_bfloat16* sk = sbf;                 // [KV_ROWS][LD]
    __nv_bfloat16* sv = sk + KV_ROWS * LD;   // [KV_ROWS][LD]
    __nv_bfloat16* sst = sv + KV_ROWS * LD;  // 2 stages x [3][KV_STEP][LD]
    float* srow = reinterpret_cast<float*>(sst + 2 * STAGE);  // 2 x {lse log2 e, D}

    // key tile 0 (the most query tiles under a causal mask) first, for
    // every (kv head, batch) before the next tile
    const int k0 = blockIdx.z * KV_ROWS;
    const int kvh = blockIdx.x, b = blockIdx.y;
    const int H = G * gridDim.x;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const bool lo = *lo_flag != 0;           // the same for every thread

    // the query tiles that can see a key of this tile, for each of G heads
    const int k_last = min(k0 + KV_ROWS, S) - 1;
    const int qt_lo = causal ? k0 / KV_STEP : 0;
    const int qt_hi = (window >= 0 ? min(S - 1, k_last + window - 1) : S - 1) / KV_STEP;
    const int nq = qt_hi - qt_lo + 1;
    const int steps = G * nq;
    const int64_t do_head = (int64_t)S * hd; // the dO halves are contiguous

    auto q_start = [&](int n) { return (qt_lo + n % nq) * KV_STEP; };
    auto head = [&](int n) { return kvh * G + n / nq; };
    auto fetch = [&](int n, int stage) {     // step n's tiles, into `stage`
        const int h = head(n), q0 = q_start(n);
        __nv_bfloat16* dst = sst + stage * STAGE;
        const int64_t off = ((int64_t)b * H + h) * do_head;
        copy_tile<KV_STEP, HDP>(dst, q + b * qs.b + h * qs.h, qs.s, q0, S, hd);
        copy_tile<KV_STEP, HDP>(dst + KV_STEP * LD, dohi + off, hd, q0, S, hd);
        if (lo) copy_tile<KV_STEP, HDP>(dst + 2 * KV_STEP * LD, dolo + off, hd, q0, S, hd);
        cp_async_commit();
    };
    // threads 0-31: lse log2 e of step n's query rows, 32-63: their D (0 past S)
    auto row_value = [&](int n) {
        const int r = threadIdx.x % KV_STEP, q0 = q_start(n);
        if (threadIdx.x >= 2 * KV_STEP || q0 + r >= S) return 0.f;
        const int64_t at = ((int64_t)b * H + head(n)) * S + q0 + r;
        return threadIdx.x < KV_STEP ? lse[at] * LOG2E : delta[at];
    };

    copy_tile<KV_ROWS, HDP>(sk, k + b * ks.b + kvh * ks.h, ks.s, k0, S, hd);
    copy_tile<KV_ROWS, HDP>(sv, v + b * vs.b + kvh * vs.h, vs.s, k0, S, hd);
    fetch(0, 0);
    if (threadIdx.x < 2 * KV_STEP) srow[threadIdx.x] = row_value(0);
    cp_async_wait<0>();
    __syncthreads();

    float dka[DBLK][4], dva[DBLK][4];
#pragma unroll
    for (int j = 0; j < DBLK; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) dka[j][c] = dva[j][c] = 0.f;
    const __nv_bfloat16* sk_a = sk + 16 * warp * LD + a_lane<LD>(lane);
    const __nv_bfloat16* sv_a = sv + 16 * warp * LD + a_lane<LD>(lane);
    const int bn = bn_lane<LD>(lane), bk = a_lane<LD>(lane);
    const int kpos0 = k0 + 16 * warp + g; // this lane's keys: kpos0, kpos0 + 8

    for (int n = 0; n < steps; ++n) {
        const int stage = n & 1;
        float next_row = 0.f;
        if (n + 1 < steps) {                 // the next step, into the other stage
            fetch(n + 1, stage ^ 1);
            next_row = row_value(n + 1);
        }
        const __nv_bfloat16* sq = sst + stage * STAGE;
        const __nv_bfloat16* sdh = sq + KV_STEP * LD;
        const __nv_bfloat16* sdl = sdh + KV_STEP * LD;
        const float* sl = srow + stage * 2 * KV_STEP;
        const float* sd = sl + KV_STEP;
        const int q0 = q_start(n);

        // S^T = K Q^T and dP^T = V dO^T: 16 keys x 32 queries a warp
        float st[NB][4], dpt[NB][4];
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) st[j][c] = dpt[j][c] = 0.f;
        mma_abt<HDP, NB>(st, sk_a, sq + bn);
        mma_abt<HDP, NB>(dpt, sv_a, sdh + bn);
        if (lo) mma_abt<HDP, NB>(dpt, sv_a, sdl + bn);

        // P^T and dS^T in place; key rows kpos0 (+8), query columns 8 j + 2 t (+1)
        const bool edge = q0 + KV_STEP > S || k0 + KV_ROWS > S ||
                          (causal && k0 + KV_ROWS - 1 > q0) ||
                          (window >= 0 && q0 + KV_STEP - 1 - k0 >= window);
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int col = 8 * j + 2 * t + (c & 1);
                const bool ok = !edge || visible(q0 + col, kpos0 + 8 * (c >> 1), S,
                                                 causal, window);
                if constexpr (CAP) {
                    const float th = tanhf(st[j][c] * cap_scale);
                    const float p = ok ? exp2f(fmaf(th, cap_log2, -sl[col])) : 0.f;
                    st[j][c] = p;
                    dpt[j][c] = p * (dpt[j][c] - sd[col]) * (1.f - th * th);
                } else {
                    const float p = ok ? exp2f(fmaf(st[j][c], scale_log2, -sl[col])) : 0.f;
                    st[j][c] = p;
                    dpt[j][c] = p * (dpt[j][c] - sd[col]);
                }
            }

        // dV += P^T dO and dK += dS^T Q: the step's 32 queries are the k of
        // the products, 16 columns of head_dim at a time
        uint32_t phi[NB / 2][4], plo[NB / 2][4], shi[NB / 2][4], slo[NB / 2][4];
#pragma unroll
        for (int kk = 0; kk < NB / 2; ++kk) {
            split_frag(st[2 * kk], st[2 * kk + 1], phi[kk], plo[kk]);
            split_frag(dpt[2 * kk], dpt[2 * kk + 1], shi[kk], slo[kk]);
        }
#pragma unroll
        for (int dd = 0; dd < HDP / 16; ++dd) {
            float pv[2][4] = {}, pk[2][4] = {};
#pragma unroll
            for (int kk = 0; kk < NB / 2; ++kk) {
                mma_ab<true>(pv, phi[kk], plo[kk], sdh + 16 * kk * LD + bk, dd);
                if (lo) mma_ab<false>(pv, phi[kk], phi[kk], sdl + 16 * kk * LD + bk, dd);
                mma_ab<true>(pk, shi[kk], slo[kk], sq + 16 * kk * LD + bk, dd);
            }
            add_part<DBLK>(dva, pv, dd);
            add_part<DBLK>(dka, pk, dd);
        }

        if (n + 1 < steps && threadIdx.x < 2 * KV_STEP)
            srow[(stage ^ 1) * 2 * KV_STEP + threadIdx.x] = next_row;
        cp_async_wait<0>();                  // the next step has landed ...
        __syncthreads();                     // ... and no warp still reads this one
    }

    float* dkb = dk + b * dks.b + kvh * dks.h;
    float* dvb = dv + b * dvs.b + kvh * dvs.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = kpos0 + 8 * r;
        if (row >= S) continue;
#pragma unroll
        for (int j = 0; j < DBLK; ++j) {
            const int d = 8 * j + 2 * t;
            if (d < hd) {
                *reinterpret_cast<float2*>(&dkb[row * dks.s + d]) =
                    make_float2(dka[j][2 * r] * scale, dka[j][2 * r + 1] * scale);
                *reinterpret_cast<float2*>(&dvb[row * dvs.s + d]) =
                    make_float2(dva[j][2 * r], dva[j][2 * r + 1]);
            }
        }
    }
}

// dQ of one (64-row query tile, head, batch).  CAP: as p_and_ds.
template <int HDP, bool CAP>
__global__ void __launch_bounds__(TC_NT)
flash_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dohi,
                         const __nv_bfloat16* __restrict__ dolo,
                         const int* __restrict__ lo_flag,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, float* __restrict__ dq,
                         int G, int S, int hd, int causal, int window, float scale,
                         float scale_log2, float cap, Strides qs, Strides ks,
                         Strides vs, Strides dqs) {
    const float cap_scale = CAP ? scale / cap : 0.f;
    const float cap_log2 = CAP ? cap * LOG2E : 0.f;
    constexpr int LD = HDP + 8;
    constexpr int DBLK = HDP / 8;
    constexpr int NB = Q_STEP / 8;           // 8-key column blocks of S
    constexpr int STAGE = 2 * Q_STEP * LD;   // K, V
    extern __shared__ __align__(16) __nv_bfloat16 sbf[];
    __nv_bfloat16* sq = sbf;                 // [Q_ROWS][LD]
    __nv_bfloat16* sdh = sq + Q_ROWS * LD;   // [Q_ROWS][LD]
    __nv_bfloat16* sdl = sdh + Q_ROWS * LD;  // [Q_ROWS][LD]
    __nv_bfloat16* skv = sdl + Q_ROWS * LD;  // 2 stages x {K, V} [Q_STEP][LD]

    // the heaviest (latest) causal tile first, for every (head, batch)
    const int q0 = (gridDim.z - 1 - blockIdx.z) * Q_ROWS;
    const int h = blockIdx.x, b = blockIdx.y;
    const int H = gridDim.x;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const bool lo = *lo_flag != 0;
    const int qpos0 = q0 + 16 * warp + g;    // this lane's rows: qpos0, qpos0 + 8
    const int64_t rows = ((int64_t)b * H + h) * S;
    const __nv_bfloat16* kb = k + b * ks.b + (h / G) * ks.h;
    const __nv_bfloat16* vb = v + b * vs.b + (h / G) * vs.h;

    const int q_last = min(q0 + Q_ROWS, S) - 1;
    const int kt_lo = window >= 0 ? max(q0 - window + 1, 0) / Q_STEP : 0;
    const int kt_hi = (causal ? q_last : S - 1) / Q_STEP;

    auto fetch = [&](int kt, int stage) {
        __nv_bfloat16* dst = skv + stage * STAGE;
        copy_tile<Q_STEP, HDP>(dst, kb, ks.s, kt * Q_STEP, S, hd);
        copy_tile<Q_STEP, HDP>(dst + Q_STEP * LD, vb, vs.s, kt * Q_STEP, S, hd);
        cp_async_commit();
    };
    copy_tile<Q_ROWS, HDP>(sq, q + b * qs.b + h * qs.h, qs.s, q0, S, hd);
    copy_tile<Q_ROWS, HDP>(sdh, dohi + rows * hd, hd, q0, S, hd);
    if (lo) copy_tile<Q_ROWS, HDP>(sdl, dolo + rows * hd, hd, q0, S, hd);
    fetch(kt_lo, 0);

    float lr[2], dr[2];                      // lse log2 e and D of this lane's rows
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = qpos0 + 8 * r;
        lr[r] = row < S ? lse[rows + row] * LOG2E : 0.f;
        dr[r] = row < S ? delta[rows + row] : 0.f;
    }
    float dqa[DBLK][4];
#pragma unroll
    for (int j = 0; j < DBLK; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) dqa[j][c] = 0.f;
    const __nv_bfloat16* sq_a = sq + 16 * warp * LD + a_lane<LD>(lane);
    const __nv_bfloat16* sdh_a = sdh + 16 * warp * LD + a_lane<LD>(lane);
    const __nv_bfloat16* sdl_a = sdl + 16 * warp * LD + a_lane<LD>(lane);
    const int bn = bn_lane<LD>(lane), bk = a_lane<LD>(lane);
    cp_async_wait<0>();
    __syncthreads();

    for (int kt = kt_lo; kt <= kt_hi; ++kt) {
        const int stage = (kt - kt_lo) & 1;
        if (kt < kt_hi) fetch(kt + 1, stage ^ 1);
        const __nv_bfloat16* sk = skv + stage * STAGE;
        const __nv_bfloat16* sv = sk + Q_STEP * LD;
        const int k0 = kt * Q_STEP;

        // S = Q K^T and dP = dO V^T: 16 rows x 32 keys a warp
        float s[NB][4], dp[NB][4];
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) s[j][c] = dp[j][c] = 0.f;
        mma_abt<HDP, NB>(s, sq_a, sk + bn);
        mma_abt<HDP, NB>(dp, sdh_a, sv + bn);
        if (lo) mma_abt<HDP, NB>(dp, sdl_a, sv + bn);

        // dS in place of S; rows qpos0 (+8), key columns 8 j + 2 t (+1)
        const bool edge = k0 + Q_STEP > S || q0 + Q_ROWS > S ||
                          (causal && k0 + Q_STEP - 1 > q0) ||
                          (window >= 0 && q0 + Q_ROWS - 1 - k0 >= window);
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int r = c >> 1;
                const bool ok = !edge || visible(qpos0 + 8 * r, k0 + 8 * j + 2 * t + (c & 1),
                                                 S, causal, window);
                if constexpr (CAP) {
                    const float th = tanhf(s[j][c] * cap_scale);
                    const float p = ok ? exp2f(fmaf(th, cap_log2, -lr[r])) : 0.f;
                    s[j][c] = p * (dp[j][c] - dr[r]) * (1.f - th * th);
                } else {
                    const float p = ok ? exp2f(fmaf(s[j][c], scale_log2, -lr[r])) : 0.f;
                    s[j][c] = p * (dp[j][c] - dr[r]);
                }
            }

        // dQ += dS K: the step's 32 keys are the k of the product, 16 columns
        // of head_dim at a time
        uint32_t shi[NB / 2][4], slo[NB / 2][4];
#pragma unroll
        for (int kk = 0; kk < NB / 2; ++kk)
            split_frag(s[2 * kk], s[2 * kk + 1], shi[kk], slo[kk]);
#pragma unroll
        for (int dd = 0; dd < HDP / 16; ++dd) {
            float part[2][4] = {};
#pragma unroll
            for (int kk = 0; kk < NB / 2; ++kk)
                mma_ab<true>(part, shi[kk], slo[kk], sk + 16 * kk * LD + bk, dd);
            add_part<DBLK>(dqa, part, dd);
        }

        cp_async_wait<0>();
        __syncthreads();
    }

    float* dqb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = qpos0 + 8 * r;
        if (row >= S) continue;
#pragma unroll
        for (int j = 0; j < DBLK; ++j) {
            const int d = 8 * j + 2 * t;
            if (d < hd)
                *reinterpret_cast<float2*>(&dqb[row * dqs.s + d]) =
                    make_float2(dqa[j][2 * r] * scale, dqa[j][2 * r + 1] * scale);
        }
    }
}

struct Args {
    const void *q, *k, *v;
    const float *out, *dout, *lse;
    float *delta, *dq, *dk, *dv;
    __nv_bfloat16* do_split;   // [2][B,H,S,hd]: dO's hi and lo halves (tensor cores)
    int* lo_flag;
    int B, H, K, S, hd, causal, window;
    float cap;                 // the logit soft-cap, 0 for none
    Strides qs, ks, vs, os, dos, dqs, dks, dvs;
};

// The pre-pass: D, and with `split` dO's halves and the lo flag.
cudaError_t launch_delta(const Args& a, bool split, cudaStream_t stream) {
    const int64_t rows = (int64_t)a.B * a.H * a.S;
    __nv_bfloat16* hi = split ? a.do_split : nullptr;
    __nv_bfloat16* lo = split ? a.do_split + rows * a.hd : nullptr;
    if (split) {
        const cudaError_t err = cudaMemsetAsync(a.lo_flag, 0, sizeof(int), stream);
        if (err != cudaSuccess) return err;
    }
    flash_bwd_delta_kernel<<<(unsigned)((rows * 32 + NT - 1) / NT), NT, 0, stream>>>(
        a.out, a.dout, a.delta, hi, lo, a.lo_flag, a.H, a.S, a.hd, rows, a.os, a.dos);
    return cudaGetLastError();
}

template <typename T, int BT, int DPT, bool CAP>
cudaError_t launch_cap(const Args& a, cudaStream_t stream) {
    constexpr int LDS = BT + 1;
    const int ld = a.hd + 4;
    const size_t smem_dkdv = ((size_t)4 * BT * ld + 2 * BT * LDS + 2 * BT) * sizeof(float);
    const size_t smem_dq = ((size_t)4 * BT * ld + BT * LDS + 2 * BT) * sizeof(float);
    auto dkdv = flash_bwd_dkdv_kernel<T, BT, DPT, CAP>;
    auto dq = flash_bwd_dq_kernel<T, BT, DPT, CAP>;
    cudaError_t err = cudaFuncSetAttribute(
        dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dkdv);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_dq);
    if (err != cudaSuccess) return err;
    err = launch_delta(a, false, stream);
    if (err != cudaSuccess) return err;

    const float scale = 1.0f / sqrtf((float)a.hd);
    const int G = a.H / a.K;
    const int tiles = (a.S + BT - 1) / BT;
    dkdv<<<dim3(tiles, a.K, a.B), NT, smem_dkdv, stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, a.dout, a.lse, a.delta, a.dk,
        a.dv, G, a.S, a.hd, a.causal, a.window, scale, a.cap, a.qs, a.ks, a.vs,
        a.dos, a.dks, a.dvs);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    dq<<<dim3(tiles, a.H, a.B), NT, smem_dq, stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, a.dout, a.lse, a.delta, a.dq,
        G, a.S, a.hd, a.causal, a.window, scale, a.cap, a.qs, a.ks, a.vs, a.dos,
        a.dqs);
    return cudaGetLastError();
}

template <typename T, int BT, int DPT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
    return a.cap > 0.f ? launch_cap<T, BT, DPT, true>(a, stream)
                       : launch_cap<T, BT, DPT, false>(a, stream);
}

template <typename T>
cudaError_t launch_hd(const Args& a, cudaStream_t stream) {
    if (a.hd <= 16) return launch<T, 64, 1>(a, stream);
    if (a.hd <= 32) return launch<T, 64, 2>(a, stream);
    if (a.hd <= 64) return launch<T, 64, 4>(a, stream);
    if (a.hd <= 128) return launch<T, 64, 8>(a, stream);
    return launch<T, 32, 16>(a, stream);
}

template <int HDP, bool CAP>
cudaError_t launch_tc_cap(const Args& a, cudaStream_t stream) {
    constexpr int LD = HDP + 8;
    const size_t smem_kv = (size_t)(2 * KV_ROWS + 6 * KV_STEP) * LD * sizeof(__nv_bfloat16) +
                           4 * KV_STEP * sizeof(float);
    const size_t smem_q = (size_t)(3 * Q_ROWS + 4 * Q_STEP) * LD * sizeof(__nv_bfloat16);
    auto dkdv = flash_bwd_dkdv_bf16_kernel<HDP, CAP>;
    auto dq = flash_bwd_dq_bf16_kernel<HDP, CAP>;
    cudaError_t err = cudaFuncSetAttribute(
        dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_q);
    if (err != cudaSuccess) return err;
    err = launch_delta(a, true, stream);
    if (err != cudaSuccess) return err;

    const int64_t rows = (int64_t)a.B * a.H * a.S;
    const __nv_bfloat16* hi = a.do_split;
    const __nv_bfloat16* lo = a.do_split + rows * a.hd;
    const float scale = 1.0f / sqrtf((float)a.hd);
    const float scale_log2 = scale * LOG2E;
    const int G = a.H / a.K;
    auto q = (const __nv_bfloat16*)a.q;
    auto k = (const __nv_bfloat16*)a.k;
    auto v = (const __nv_bfloat16*)a.v;
    dkdv<<<dim3(a.K, a.B, (a.S + KV_ROWS - 1) / KV_ROWS), TC_NT, smem_kv, stream>>>(
        q, k, v, hi, lo, a.lo_flag, a.lse, a.delta, a.dk, a.dv, G, a.S, a.hd,
        a.causal, a.window, scale, scale_log2, a.cap, a.qs, a.ks, a.vs, a.dks, a.dvs);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    dq<<<dim3(a.H, a.B, (a.S + Q_ROWS - 1) / Q_ROWS), TC_NT, smem_q, stream>>>(
        q, k, v, hi, lo, a.lo_flag, a.lse, a.delta, a.dq, G, a.S, a.hd, a.causal,
        a.window, scale, scale_log2, a.cap, a.qs, a.ks, a.vs, a.dqs);
    return cudaGetLastError();
}

template <int HDP>
cudaError_t launch_tc_hdp(const Args& a, cudaStream_t stream) {
    return a.cap > 0.f ? launch_tc_cap<HDP, true>(a, stream)
                       : launch_tc_cap<HDP, false>(a, stream);
}

cudaError_t launch_tc(const Args& a, cudaStream_t stream) {
    if (a.lo_flag == nullptr || (a.S + 63) / 64 > 65535)  // the tile index is the grid's z
        return cudaErrorInvalidValue;
    if (a.hd <= 16) return launch_tc_hdp<16>(a, stream);
    if (a.hd <= 32) return launch_tc_hdp<32>(a, stream);
    if (a.hd <= 64) return launch_tc_hdp<64>(a, stream);
    if (a.hd <= 128) return launch_tc_hdp<128>(a, stream);
    return cudaErrorInvalidValue;            // dK + dV would outgrow the registers
}

}  // namespace

// q [B,H,S,hd], k/v [B,K,S,hd] of `dtype`; out, dout [B,H,S,hd] f32 (the
// forward's output and its gradient); lse [B,H,S] f32 contiguous (the
// forward's); delta [B,H,S] f32 contiguous scratch; dq [B,H,S,hd], dk, dv
// [B,K,S,hd] f32 outputs.  Strides: (batch, head, row) of q, k, v, out,
// dout, dq, dk, dv in elements, head_dim contiguous, every stride and
// pointer aligned to 4 elements (the wrapper checks or copies).  Needs
// hd <= 256 and hd % 4 == 0.  window < 0 means none; softcap > 0 is the
// forward's logit cap, 0 none.  The caller picks the
// route (ops.py:bwd_route): a non-null `do_split` (bf16 scratch of
// 2 * B*H*S*hd elements, 16-byte aligned) runs the tensor-core kernels,
// which also need bf16, hd <= 128, hd % 16 == 0, S <= 64 * 65535, q/k/v
// strides that are multiples of 8 elements and `lo_flag` (one int of
// scratch); a null one runs the FMA kernels, and `lo_flag` may be null.
// Returns the first failing call's cudaError_t (0 = every kernel launched).
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* out, const void* dout,
                                          const void* lse, void* delta, void* do_split,
                                          void* lo_flag, void* dq, void* dk, void* dv,
                                          int B, int H, int K, int S, int hd,
                                          int causal, int window, int dtype,
                                          float softcap, const int64_t* strides,
                                          void* stream) {
    if (B == 0 || S == 0) return 0;
    Args a;
    a.q = q; a.k = k; a.v = v;
    a.out = (const float*)out; a.dout = (const float*)dout; a.lse = (const float*)lse;
    a.delta = (float*)delta; a.dq = (float*)dq; a.dk = (float*)dk; a.dv = (float*)dv;
    a.do_split = (__nv_bfloat16*)do_split; a.lo_flag = (int*)lo_flag;
    a.B = B; a.H = H; a.K = K; a.S = S; a.hd = hd; a.causal = causal; a.window = window;
    a.cap = softcap;
    Strides* all[8] = {&a.qs, &a.ks, &a.vs, &a.os, &a.dos, &a.dqs, &a.dks, &a.dvs};
    for (int i = 0; i < 8; ++i)
        *all[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
    cudaStream_t st = (cudaStream_t)stream;
    if (do_split != nullptr)
        return dtype == DTYPE_BF16 ? (int)launch_tc(a, st) : (int)cudaErrorInvalidValue;
    if (dtype == DTYPE_BF16) return (int)launch<__nv_bfloat16, 32, 16>(a, st);
    return (int)launch_hd<float>(a, st);
}
