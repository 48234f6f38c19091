// Paged decode attention for Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces the Pallas TPU kernel `_kernel` / `paged_attention_kernel` of
// src/repro/kernels/paged_attention/kernel.py: one query token per sequence
// attends over its paged KV cache by walking the sequence's block table.
//
// What bounds it on this card: bytes.  Each live K and V row is read once and
// the arithmetic is about 2 FLOP per byte, so the least time is the live KV
// bytes over HBM bandwidth, reached only with enough copies in flight (at
// 3.35 TB/s and about a microsecond of latency, some 25 KB per SM).  What the
// design does about it:
//   * split-KV across blocks.  The grid is (B * K * n_gc, n_splits): a
//     block takes one contiguous range of `cps` block-table columns of one
//     (sequence, kv head, group of up to 16 query heads).  The wrapper picks
//     n_splits from shapes alone, never from seq_lens: as many as fit the
//     blocks into one wave, every SM holding as many blocks as it can (two
//     at head_dim 128 in bf16), at batch 16 and at batch 1.  Each split past
//     the first costs a partial write, an atomic and a merge, so a plan of
//     fewer splits can be faster where B * K already nears the SM count.
//     With a window the ranges start at the window's first column,
//     so they cover the window's span and not the whole table.  A range
//     wholly past seq_len, or a row whose frames are all absent, loads
//     nothing and gives an empty partial (m = NEG_INF, l = 0, acc = 0);
//   * a cp.async ring per warp.  The block's 4 warps take its 16-slot tiles
//     in turn; each warp keeps a ring of STAGES tiles in shared memory, K and
//     V of a tile in one commit group of 16-byte copies, so STAGES - 1 tiles
//     are in flight while the oldest one computes;
//   * the block table is the page table.  A block stages the frame ids of
//     its columns from the block table in shared memory (without a window
//     they load at the same time as seq_len) and each warp computes its
//     rows' addresses from them; no gathered copy of the cache exists.  A
//     slot past seq_len, before the window or in an absent frame (-1) is
//     copied with src_bytes = 0 (zeros, nothing is read) and masked out of
//     the softmax;
//   * bf16 inputs run both products on the tensor cores (mma.sync m16n8k16,
//     ldmatrix fragments).  The G query heads of the kv head are the 16 rows
//     of M (zero rows past G), the 16 slots of a tile are N for Q K^T and the
//     reduction of P V.  P is split into bf16 hi + lo halves, as in
//     flash_attention.cu, so P V stays within ~1e-5 of the f32 product.
//     float32 inputs keep full f32 products: FMAs out of the staged tiles,
//     in the same split and ring structure;
//   * the combine costs no launch.  The 4 warps' softmax states (m, l, acc)
//     merge in shared memory.  With one split the block writes the output;
//     otherwise it writes its partial to a float32 scratch, and the last
//     block of each (sequence, kv head, group), found with a counter that it
//     resets to 0, merges the partials by the reference's rule: max,
//     rescale, sum, denominator floored at 1e-30.  A row with no live slot
//     comes out as 0;
//   * an optional per-row log-sum-exp (`lse`, [B,H] float32, null when not
//     asked for): ln of the sum of exp(scale q.k) over the row's live slots,
//     NEG_INF for a row with none; written where the output is, by the
//     single-split path or by the merging block.  Sequence-parallel decode
//     combines shards' partials with it.  Serving passes null.
// Scores are kept in log2 units (scale * log2(e) folded in), so every
// exponential is one exp2f.  The logit soft-cap (`softcap` = c > 0; 0 is
// none) makes a live score log2(e) c tanhf(scale q.k / c), the reference's
// c tanh(s / c) in log2 units; it is a template flag (CAP), so the instance
// without it is the one that ran before.  tanhf, not tanh.approx.f32: the
// approximation's ~2^-11 relative error would miss the 5e-5 bound.
//
// The same file holds K4, the paged decode of multi-head latent attention
// (MLA, DeepSeek-V3's and Moonlight's): its own kernel, `mla_decode_kernel`,
// described above it.
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int NW = 4;       // warps a block
constexpr int NT = 32 * NW;
constexpr int TK = 16;      // token slots a tile
constexpr int GM = 16;      // query heads a block (the M of one mma)
constexpr int MAX_COLS = 512;  // block-table columns a split (staged in smem)
constexpr int MAX_SPLITS = 256;
constexpr int COLS_PER_THREAD = MAX_COLS / NT;
static_assert(MAX_COLS % NT == 0, "every thread stages whole columns");
constexpr unsigned FULL = 0xffffffffu;
constexpr float LN2 = 0.693147180559945309f;

// ln sum exp(scale q.k) from the softmax state in log2 units: max m, sum l
__device__ __forceinline__ float row_lse(float m, float l) {
    return l > 0.f ? m * LN2 + logf(l) : NEG_INF;
}

struct Params {
    const void* q;
    const void* k;
    const void* v;
    const int* tables;
    const int* lens;
    float* out;
    float* part;        // B*H*n_splits rows: acc [hd] each, then m, then l
    int* counters;      // [B, K * n_gc], 0 between launches
    float* lse;         // [B, H] or null
    int B, H, K, G, hd, bt, MB, window, n_gc, n_splits, cps;
    float scale_log2;
    int K_slab, kv0;    // kv heads a slab slot holds; the first one read
    float cap_log2;     // with a cap c: c log2(e) ...
    float cap_scale;    // ... and scale / c
};

// A live score in log2 units: scale log2(e) x, or under a cap c
// log2(e) c tanh(scale x / c).
template <bool CAP>
__device__ __forceinline__ float live_score(float x, float scale_log2,
                                            float cap_log2, float cap_scale) {
    if constexpr (CAP) return cap_log2 * tanhf(x * cap_scale);
    return x * scale_log2;
}

constexpr int round16(int x) { return (x + 15) / 16 * 16; }

template <typename T, int HDP>
struct Layout {
    static constexpr bool TC = std::is_same<T, __nv_bfloat16>::value;
    static constexpr int EPC = 16 / (int)sizeof(T);   // elements a 16-byte chunk
    static constexpr int LD = HDP + EPC;              // row + 16 bytes: ldmatrix
                                                      // rows on distinct banks
    static constexpr int CH = HDP / EPC;              // chunks a row
    static constexpr int STAGE = 2 * TK * LD;         // K tile, then V tile
    static constexpr int STAGE_BYTES = STAGE * (int)sizeof(T);
    static constexpr int STAGES = NW * 4 * STAGE_BYTES <= 110 * 1024   ? 4
                                  : NW * 3 * STAGE_BYTES <= 110 * 1024 ? 3
                                  : NW * 2 * STAGE_BYTES <= 200 * 1024 ? 2
                                                                       : 1;
    static constexpr int Q_BYTES = round16(GM * LD * (int)sizeof(T));
    static constexpr int P_BYTES = TC ? 0 : NW * GM * TK * 4;
    static constexpr int MASK_BYTES = round16(NW * STAGES * 4);
    static constexpr int HEAD = Q_BYTES + P_BYTES + MASK_BYTES;
    static constexpr int RING_BYTES = NW * STAGES * STAGE_BYTES;
    static constexpr int MERGE_BYTES = NW * GM * (HDP + 2) * 4;
    static_assert(TK * CH % 32 == 0, "a warp copies whole rows of a tile");
};

template <typename T, int HDP>
size_t smem_bytes(int n_splits) {
    using L = Layout<T, HDP>;
    const int combine = GM * (n_splits + 1) * 4;
    int big = L::RING_BYTES > L::MERGE_BYTES ? L::RING_BYTES : L::MERGE_BYTES;
    big = big > combine ? big : combine;
    return (size_t)L::HEAD + big;
}

// Start the copies of one tile: token slots pos0 .. pos0 + 15 of the K and V
// of kv head `head_off / hd`, each slot's frame looked up in `frames`, the
// block table's columns from c_begin on.  Returns the tile's mask of live
// slots (bit r: slot pos0 + r); a tile with no live slot copies nothing.
template <typename T, int HDP>
__device__ __forceinline__ uint32_t fetch_tile(T* sk, T* sv, const T* __restrict__ kb,
                                               const T* __restrict__ vb,
                                               const int* frames, int c_begin,
                                               int pos0, int p1, int bt,
                                               int64_t slot_stride, int64_t head_off,
                                               int hd, int lane) {
    using L = Layout<T, HDP>;
    const int pos = pos0 + (lane & 15);   // lanes r and r + 16 look up slot r
    const int frame = pos < p1 ? frames[pos / bt - c_begin] : -1;
    const uint32_t mask = __ballot_sync(FULL, frame >= 0) & 0xffffu;
    if (mask == 0) return 0;
    const int64_t row_off =
        frame >= 0 ? ((int64_t)frame * bt + pos % bt) * slot_stride + head_off : -1;
#pragma unroll
    for (int i = 0; i < TK * L::CH / 32; ++i) {
        const int idx = lane + 32 * i;
        const int r = idx / L::CH, c = idx % L::CH;
        const int64_t off = __shfl_sync(FULL, row_off, r);
        const bool live = off >= 0 && c * L::EPC < hd;
        const int64_t src = live ? off + c * L::EPC : 0;
        cp_async_16(sk + r * L::LD + c * L::EPC, kb + src, live ? 16 : 0);
        cp_async_16(sv + r * L::LD + c * L::EPC, vb + src, live ? 16 : 0);
    }
    return mask;
}

// The per-warp softmax state.  bf16: this lane's rows g and g + 8 of the C
// fragments (l is the lane's part of the row sum).  f32: every head of the
// group, m the same on every lane, l and acc this lane's part.
template <typename T, int HDP, bool TC = Layout<T, HDP>::TC>
struct State;

template <typename T, int HDP>
struct State<T, HDP, true> {
    static constexpr int KSTEPS = HDP / 16, DBLK = HDP / 8;
    static constexpr bool Q_IN_REGS = HDP <= 128;   // at 256 registers run out
    uint32_t qf[Q_IN_REGS ? KSTEPS : 1][4];
    float m[2], l[2], acc[DBLK][4];
};

template <typename T, int HDP>
struct State<T, HDP, false> {
    static constexpr int LPC = HDP / 4 < 32 ? HDP / 4 : 32;   // lanes a V row
    static constexpr int KG = 32 / LPC;                       // slot groups
    static constexpr int J = HDP > 128 ? HDP / 128 : 1;       // float4s a lane
    float m[GM], l[GM];
    float4 acc[GM][J];
};

// One tile on the tensor cores (bf16).
template <int HDP, bool CAP>
__device__ __forceinline__ void tile_tc(State<__nv_bfloat16, HDP>& st,
                                        const __nv_bfloat16* sq,
                                        const __nv_bfloat16* sk, uint32_t mask,
                                        float scale_log2, float cap_log2,
                                        float cap_scale, int lane) {
    using L = Layout<__nv_bfloat16, HDP>;
    using S = State<__nv_bfloat16, HDP>;
    constexpr int LD = L::LD;
    const int t = lane & 3;
    const __nv_bfloat16* sv = sk + TK * LD;

    // s = Q K^T: 16 heads x 16 slots as two C fragments of 8 slots
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
    const __nv_bfloat16* sk_lane =
        sk + ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
    const __nv_bfloat16* sq_lane = sq + (lane & 15) * LD + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < S::KSTEPS; ++kk) {
        uint32_t a[4];
        if constexpr (S::Q_IN_REGS) {
#pragma unroll
            for (int c = 0; c < 4; ++c) a[c] = st.qf[kk][c];
        } else {
            ldmatrix_x4(a, sq_lane + 16 * kk);
        }
        uint32_t kf[4];
        ldmatrix_x4(kf, sk_lane + 16 * kk);
        mma_bf16_16816(s[0], a, kf[0], kf[1]);
        mma_bf16_16816(s[1], a, kf[2], kf[3]);
    }

    // online softmax; a head's 16 scores lie on the 4 lanes of a quad
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
                float& x = s[j][2 * r + c];
                const bool ok = (mask >> (8 * j + 2 * t + c)) & 1u;
                x = ok ? live_score<CAP>(x, scale_log2, cap_log2, cap_scale) : NEG_INF;
                mx = fmaxf(mx, x);
            }
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
        const float m_new = fmaxf(st.m[r], mx);
        const float alpha = exp2f(st.m[r] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
                float& x = s[j][2 * r + c];
                const bool ok = (mask >> (8 * j + 2 * t + c)) & 1u;
                x = ok ? exp2f(x - m_new) : 0.f;
                sum += x;
            }
        st.l[r] = st.l[r] * alpha + sum;
        st.m[r] = m_new;
#pragma unroll
        for (int j = 0; j < S::DBLK; ++j) {
            st.acc[j][2 * r] *= alpha;
            st.acc[j][2 * r + 1] *= alpha;
        }
    }

    // acc += P V with P = hi + lo: the two score fragments are the A
    // fragment of the tile's 16 slots
    uint32_t hi[4], lo[4];
    split_p(s[0][0], s[0][1], hi[0], lo[0]);
    split_p(s[0][2], s[0][3], hi[1], lo[1]);
    split_p(s[1][0], s[1][1], hi[2], lo[2]);
    split_p(s[1][2], s[1][3], hi[3], lo[3]);
    const __nv_bfloat16* sv_lane = sv + (lane & 15) * LD + (lane >> 4) * 8;
#pragma unroll
    for (int dd = 0; dd < S::DBLK / 2; ++dd) {   // columns 16 dd .. 16 dd + 15
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, sv_lane + 16 * dd);
        mma_bf16_16816(st.acc[2 * dd], hi, vf[0], vf[1]);
        mma_bf16_16816(st.acc[2 * dd], lo, vf[0], vf[1]);
        mma_bf16_16816(st.acc[2 * dd + 1], hi, vf[2], vf[3]);
        mma_bf16_16816(st.acc[2 * dd + 1], lo, vf[2], vf[3]);
    }
}

// One tile in float32 FMAs.  Q K^T: lane (slot = lane % 16, half = lane / 16)
// sums its half of head_dim.  P V: lane (cg = lane % LPC, kg = lane / LPC)
// owns columns 4 cg + 128 j over the slots kg, kg + KG, ...
template <int HDP, bool CAP>
__device__ __forceinline__ void tile_f32(State<float, HDP>& st, const float* sq,
                                         const float* sk, float* sp, uint32_t mask,
                                         int Gc, float scale_log2, float cap_log2,
                                         float cap_scale, int lane) {
    using L = Layout<float, HDP>;
    using S = State<float, HDP>;
    constexpr int LD = L::LD, HALF = HDP / 2;
    const float* sv = sk + TK * LD;
    const int slot = lane & 15, half = lane >> 4;
    const bool ok = (mask >> slot) & 1u;

    float s[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) s[g] = 0.f;
    const float* kr = sk + slot * LD + half * HALF;
    const float* qr = sq + half * HALF;
#pragma unroll 4
    for (int d = 0; d < HALF; d += 4) {
        const float4 k4 = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
            if (g < Gc) {
                const float4 q4 = *reinterpret_cast<const float4*>(qr + g * LD + d);
                s[g] = fmaf(q4.x, k4.x, s[g]);
                s[g] = fmaf(q4.y, k4.y, s[g]);
                s[g] = fmaf(q4.z, k4.z, s[g]);
                s[g] = fmaf(q4.w, k4.w, s[g]);
            }
        }
    }
#pragma unroll
    for (int g = 0; g < GM; ++g) {
        if (g < Gc) {
            float x = s[g] + __shfl_xor_sync(FULL, s[g], 16);
            x = ok ? live_score<CAP>(x, scale_log2, cap_log2, cap_scale) : NEG_INF;
            float mx = x;
#pragma unroll
            for (int off = 1; off < 16; off <<= 1)
                mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
            const float m_new = fmaxf(st.m[g], mx);
            const float alpha = exp2f(st.m[g] - m_new);
            const float p = ok ? exp2f(x - m_new) : 0.f;
            st.l[g] = st.l[g] * alpha + (half == 0 ? p : 0.f);
            st.m[g] = m_new;
#pragma unroll
            for (int j = 0; j < S::J; ++j) {
                st.acc[g][j].x *= alpha;
                st.acc[g][j].y *= alpha;
                st.acc[g][j].z *= alpha;
                st.acc[g][j].w *= alpha;
            }
            if (half == 0) sp[g * TK + slot] = p;
        }
    }
    __syncwarp();
    const int cg = lane % S::LPC, kg = lane / S::LPC;
#pragma unroll
    for (int r = kg; r < TK; r += S::KG) {
        float4 v4[S::J];
#pragma unroll
        for (int j = 0; j < S::J; ++j)
            v4[j] = *reinterpret_cast<const float4*>(sv + r * LD + 4 * cg + 128 * j);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
            if (g < Gc) {
                const float p = sp[g * TK + r];
#pragma unroll
                for (int j = 0; j < S::J; ++j) {
                    st.acc[g][j].x = fmaf(p, v4[j].x, st.acc[g][j].x);
                    st.acc[g][j].y = fmaf(p, v4[j].y, st.acc[g][j].y);
                    st.acc[g][j].z = fmaf(p, v4[j].z, st.acc[g][j].z);
                    st.acc[g][j].w = fmaf(p, v4[j].w, st.acc[g][j].w);
                }
            }
        }
    }
}

template <typename T, int HDP, bool CAP>
__global__ void __launch_bounds__(NT)
paged_attention_kernel(const Params p) {
    using L = Layout<T, HDP>;
    using S = State<T, HDP>;
    constexpr int LD = L::LD, STAGES = L::STAGES;
    extern __shared__ __align__(16) unsigned char smem[];
    T* sq = reinterpret_cast<T*>(smem);                              // [GM][LD]
    float* sp_all = reinterpret_cast<float*>(smem + L::Q_BYTES);     // f32: [NW][GM][TK]
    uint32_t* smask = reinterpret_cast<uint32_t*>(smem + L::Q_BYTES + L::P_BYTES);
    unsigned char* big = smem + L::HEAD;   // the rings, later the merge buffers
    __shared__ int s_frames[MAX_COLS];   // the block table's columns [c_begin, c_end)
    __shared__ int s_last;

    const int n_kg = p.K * p.n_gc;
    const int b = blockIdx.x / n_kg;
    const int kh = blockIdx.x % n_kg / p.n_gc;
    const int g0 = blockIdx.x % p.n_gc * GM;
    const int Gc = min(GM, p.G - g0);
    const int split = blockIdx.y;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

    const int64_t bh0 = (int64_t)b * p.H + kh * p.G + g0;   // first head's row
    const int* table_row = p.tables + (int64_t)b * p.MB;

    // Q (zero rows past the group, zero columns past hd) rides in the first
    // commit group with the first tile; it needs nothing from seq_len
    {
        const T* qg = static_cast<const T*>(p.q) + bh0 * p.hd;
        for (int idx = threadIdx.x; idx < GM * L::CH; idx += NT) {
            const int r = idx / L::CH, c = idx % L::CH;
            const bool ok = r < Gc && c * L::EPC < p.hd;
            cp_async_16(sq + r * LD + c * L::EPC, ok ? qg + r * p.hd + c * L::EPC : qg,
                        ok ? 16 : 0);
        }
    }

    // this block's slots: columns [c_begin, c_end) clipped to the live
    // positions [lo, seq_len).  Without a window the columns do not depend
    // on seq_len, so their frame ids load at the same time as seq_len.
    int frames[COLS_PER_THREAD];
    auto load_frames = [&](int c_begin) {
        const int n_cols = min(c_begin + p.cps, p.MB) - c_begin;
#pragma unroll
        for (int j = 0; j < COLS_PER_THREAD; ++j) {
            const int c = threadIdx.x + NT * j;
            frames[j] = c < n_cols ? __ldg(table_row + c_begin + c) : -1;
        }
    };
    if (p.window < 0) load_frames(split * p.cps);
    const int seq_len = __ldg(p.lens + b);
    const int lo = p.window >= 0 ? max(seq_len - p.window, 0) : 0;
    const int c_begin = lo / p.bt + split * p.cps;
    if (p.window >= 0) load_frames(c_begin);
#pragma unroll
    for (int j = 0; j < COLS_PER_THREAD; ++j) s_frames[threadIdx.x + NT * j] = frames[j];
    const int c_end = min(c_begin + p.cps, p.MB);
    const int p0 = max(c_begin * p.bt, lo);
    const int p1 = min(c_end * p.bt, seq_len);
    const int n_tiles = p1 > p0 ? (p1 - p0 + TK - 1) / TK : 0;
    const int my_tiles = n_tiles > warp ? (n_tiles - warp + NW - 1) / NW : 0;
    __syncthreads();                           // the frame ids are staged

    const T* kb = static_cast<const T*>(p.k);
    const T* vb = static_cast<const T*>(p.v);
    const int64_t slot_stride = (int64_t)p.K_slab * p.hd;
    const int64_t head_off = (int64_t)(p.kv0 + kh) * p.hd;
    T* ring = reinterpret_cast<T*>(big) + warp * STAGES * L::STAGE;
    uint32_t* wmask = smask + warp * STAGES;

    auto fetch = [&](int i) {
        T* sk = ring + (i % STAGES) * L::STAGE;
        const uint32_t mask = fetch_tile<T, HDP>(
            sk, sk + TK * LD, kb, vb, s_frames, c_begin, p0 + (warp + NW * i) * TK,
            p1, p.bt, slot_stride, head_off, p.hd, lane);
        if (lane == 0) wmask[i % STAGES] = mask;
    };

    if constexpr (STAGES == 1) cp_async_commit();
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) {
        if (i < my_tiles) fetch(i);
        cp_async_commit();
    }
    cp_async_wait<(STAGES >= 2 ? STAGES - 2 : 0)>();
    __syncthreads();                           // Q has landed for every warp

    S st;
    if constexpr (L::TC) {
        st.m[0] = st.m[1] = NEG_INF;
        st.l[0] = st.l[1] = 0.f;
#pragma unroll
        for (int j = 0; j < S::DBLK; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) st.acc[j][c] = 0.f;
        if constexpr (S::Q_IN_REGS) {
            const T* sq_lane = sq + (lane & 15) * LD + (lane >> 4) * 8;
#pragma unroll
            for (int kk = 0; kk < S::KSTEPS; ++kk) ldmatrix_x4(st.qf[kk], sq_lane + 16 * kk);
        }
    } else {
#pragma unroll
        for (int g = 0; g < GM; ++g) {
            st.m[g] = NEG_INF;
            st.l[g] = 0.f;
#pragma unroll
            for (int j = 0; j < S::J; ++j) st.acc[g][j] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
    }

    for (int i = 0; i < my_tiles; ++i) {
        if (i + STAGES - 1 < my_tiles) fetch(i + STAGES - 1);
        cp_async_commit();
        cp_async_wait<STAGES - 1>();           // tile i has landed ...
        __syncwarp();                          // ... for every lane
        const uint32_t mask = wmask[i % STAGES];
        const T* sk = ring + (i % STAGES) * L::STAGE;
        if (mask) {
            if constexpr (L::TC)
                tile_tc<HDP, CAP>(st, sq, sk, mask, p.scale_log2, p.cap_log2,
                                  p.cap_scale, lane);
            else
                tile_f32<HDP, CAP>(st, sq, sk, sp_all + warp * GM * TK, mask, Gc,
                                   p.scale_log2, p.cap_log2, p.cap_scale, lane);
        }
        __syncwarp();                          // stage i % STAGES is free again
    }
    cp_async_wait<0>();
    __syncthreads();                           // every ring is done: reuse it

    // merge the 4 warps' states in shared memory
    float* sm_acc = reinterpret_cast<float*>(big);   // [NW][GM][HDP]
    float* sm_m = sm_acc + NW * GM * HDP;            // [NW][GM]
    float* sm_l = sm_m + NW * GM;
    if constexpr (L::TC) {
        const int g = lane >> 2, t = lane & 3;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            float lr = st.l[r];
            lr += __shfl_xor_sync(FULL, lr, 1);
            lr += __shfl_xor_sync(FULL, lr, 2);
            float* row = sm_acc + (warp * GM + g + 8 * r) * HDP;
#pragma unroll
            for (int j = 0; j < S::DBLK; ++j)
                *reinterpret_cast<float2*>(row + 8 * j + 2 * t) =
                    make_float2(st.acc[j][2 * r], st.acc[j][2 * r + 1]);
            if (t == 0) {
                sm_m[warp * GM + g + 8 * r] = st.m[r];
                sm_l[warp * GM + g + 8 * r] = lr;
            }
        }
    } else {
        const int cg = lane % S::LPC, kg = lane / S::LPC;
#pragma unroll
        for (int g = 0; g < GM; ++g) {
            float lg = st.l[g];
#pragma unroll
            for (int off = 1; off < 32; off <<= 1) lg += __shfl_xor_sync(FULL, lg, off);
#pragma unroll
            for (int j = 0; j < S::J; ++j) {
                float4& a = st.acc[g][j];
#pragma unroll
                for (int off = S::LPC; off < 32; off <<= 1) {
                    a.x += __shfl_xor_sync(FULL, a.x, off);
                    a.y += __shfl_xor_sync(FULL, a.y, off);
                    a.z += __shfl_xor_sync(FULL, a.z, off);
                    a.w += __shfl_xor_sync(FULL, a.w, off);
                }
                if (kg == 0)
                    *reinterpret_cast<float4*>(sm_acc + (warp * GM + g) * HDP +
                                               4 * cg + 128 * j) = a;
            }
            if (lane == 0) {
                sm_m[warp * GM + g] = st.m[g];
                sm_l[warp * GM + g] = lg;
            }
        }
    }
    __syncthreads();

    const int hd4 = p.hd / 4;
    float* part_acc = p.part;
    float* part_m = p.part + (int64_t)p.B * p.H * p.n_splits * p.hd;
    float* part_l = part_m + (int64_t)p.B * p.H * p.n_splits;
    for (int idx = threadIdx.x; idx < Gc * hd4; idx += NT) {
        const int g = idx / hd4, d = 4 * (idx % hd4);
        float M = NEG_INF;
#pragma unroll
        for (int w = 0; w < NW; ++w) M = fmaxf(M, sm_m[w * GM + g]);
        float Lsum = 0.f;
        float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int w = 0; w < NW; ++w) {
            const float f = exp2f(sm_m[w * GM + g] - M);
            const float4 a = *reinterpret_cast<const float4*>(sm_acc + (w * GM + g) * HDP + d);
            Lsum += sm_l[w * GM + g] * f;
            A.x += a.x * f;
            A.y += a.y * f;
            A.z += a.z * f;
            A.w += a.w * f;
        }
        if (p.n_splits == 1) {
            const float inv = 1.0f / fmaxf(Lsum, 1e-30f);
            *reinterpret_cast<float4*>(p.out + (bh0 + g) * p.hd + d) =
                make_float4(A.x * inv, A.y * inv, A.z * inv, A.w * inv);
            if (p.lse != nullptr && d == 0) p.lse[bh0 + g] = row_lse(M, Lsum);
        } else {
            const int64_t row = (bh0 + g) * p.n_splits + split;
            *reinterpret_cast<float4*>(part_acc + row * p.hd + d) = A;
            if (d == 0) {
                part_m[row] = M;
                part_l[row] = Lsum;
            }
        }
    }
    if (p.n_splits == 1) return;

    // the last block of this (sequence, kv head, group) merges the partials
    __threadfence();
    __syncthreads();
    int* counter = p.counters + blockIdx.x;
    if (threadIdx.x == 0) s_last = atomicAdd(counter, 1) == p.n_splits - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();

    const int n = p.n_splits;
    float* sf = reinterpret_cast<float*>(big);   // [GM][n] rescale factors
    float* sden = sf + GM * n;                   // [GM] denominators
    for (int g = warp; g < Gc; g += NW) {
        const int64_t row0 = (bh0 + g) * n;
        float M = NEG_INF;
        for (int s = lane; s < n; s += 32) M = fmaxf(M, __ldcg(part_m + row0 + s));
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) M = fmaxf(M, __shfl_xor_sync(FULL, M, off));
        float den = 0.f;
        for (int s = lane; s < n; s += 32) {
            const float f = exp2f(__ldcg(part_m + row0 + s) - M);
            sf[g * n + s] = f;
            den += __ldcg(part_l + row0 + s) * f;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) den += __shfl_xor_sync(FULL, den, off);
        if (lane == 0) {
            sden[g] = den;
            if (p.lse != nullptr) p.lse[bh0 + g] = row_lse(M, den);
        }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < Gc * hd4; idx += NT) {
        const int g = idx / hd4, d = 4 * (idx % hd4);
        const float* src = part_acc + (bh0 + g) * n * p.hd + d;
        float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
        for (int s = 0; s < n; ++s) {
            const float f = sf[g * n + s];
            const float4 a = __ldcg(reinterpret_cast<const float4*>(src + (int64_t)s * p.hd));
            num.x += a.x * f;
            num.y += a.y * f;
            num.z += a.z * f;
            num.w += a.w * f;
        }
        const float inv = 1.0f / fmaxf(sden[g], 1e-30f);
        *reinterpret_cast<float4*>(p.out + (bh0 + g) * p.hd + d) =
            make_float4(num.x * inv, num.y * inv, num.z * inv, num.w * inv);
    }
    if (threadIdx.x == 0) *counter = 0;         // ready for the next launch
}

template <typename T, int HDP, bool CAP>
cudaError_t launch(const Params& p, cudaStream_t stream) {
    const size_t smem = smem_bytes<T, HDP>(p.n_splits);
    auto kernel = paged_attention_kernel<T, HDP, CAP>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(p.B * p.K * p.n_gc, p.n_splits);
    kernel<<<grid, NT, smem, stream>>>(p);
    return cudaGetLastError();
}

// Blocks of the kernel for (T, HDP, CAP) that one SM holds at once.
template <typename T, int HDP, bool CAP>
cudaError_t occupancy(int* blocks) {
    const size_t smem = smem_bytes<T, HDP>(1);
    auto kernel = paged_attention_kernel<T, HDP, CAP>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, NT, smem);
}

// f(T{}, integral_constant<HDP>) for the kernel that serves (dtype, hd).
template <typename F>
cudaError_t dispatch(int dtype, int hd, F&& f) {
    auto by_hd = [&](auto t) -> cudaError_t {
        if (hd <= 16) return f(t, std::integral_constant<int, 16>{});
        if (hd <= 32) return f(t, std::integral_constant<int, 32>{});
        if (hd <= 64) return f(t, std::integral_constant<int, 64>{});
        if (hd <= 128) return f(t, std::integral_constant<int, 128>{});
        return f(t, std::integral_constant<int, 256>{});
    };
    if (dtype == DTYPE_BF16) return by_hd(__nv_bfloat16{});
    return by_hd(float{});
}

}  // namespace

// q [B,H,hd], k/v_slabs [N,bt,K_slab,hd] (one layer, contiguous, all of
// `dtype`), of which kv heads [kv0, kv0 + K) are read (a model shard's heads
// of a replicated slab; K_slab = K and kv0 = 0 read them all),
// tables [B,MB] i32 physical frames (-1 absent), lens [B] i32, out [B,H,hd]
// f32, lse [B,H] f32 or null.  window < 0 means none; softcap > 0 caps the
// scores at it, 0 means none.  The split plan (n_gc
// groups of up to 16 query heads, n_splits ranges of cps columns) comes from
// the wrapper; with n_splits > 1, `part` holds B*H*n_splits*(hd + 2) floats
// and `counters` B*K*n_gc ints that are 0 (the kernel leaves them 0).  Needs
// hd <= 256, hd a multiple of 16 bytes and 16-byte aligned operands; the
// wrapper checks.  A plan outside 1 <= n_splits <= MAX_SPLITS,
// 1 <= cps <= MAX_COLS or n_gc * 16 >= H / K returns cudaErrorInvalidValue and
// launches nothing.
// Returns the launch's cudaError_t (0 = launched).
extern "C" int paged_attention_launch(const void* q, const void* k_slabs,
                                      const void* v_slabs, const void* tables,
                                      const void* lens, void* out, void* part,
                                      void* counters, void* lse, int B, int H,
                                      int K, int K_slab, int kv0, int hd, int bt,
                                      int MB, int window,
                                      int n_gc, int n_splits, int cps, int dtype,
                                      float softcap, void* stream) {
    if (B == 0) return 0;
    if (n_splits < 1 || n_splits > MAX_SPLITS || cps < 1 || cps > MAX_COLS ||
        K < 1 || kv0 < 0 || kv0 + K > K_slab || n_gc * GM < H / K)
        return (int)cudaErrorInvalidValue;
    Params p{q, k_slabs, v_slabs, (const int*)tables, (const int*)lens,
             (float*)out, (float*)part, (int*)counters, (float*)lse, B, H, K,
             H / K, hd, bt, MB, window, n_gc, n_splits, cps,
             1.44269504f / sqrtf((float)hd),    // log2(e) / sqrt(hd)
             K_slab, kv0,
             softcap > 0.f ? 1.44269504f * softcap : 0.f,
             softcap > 0.f ? 1.0f / (sqrtf((float)hd) * softcap) : 0.f};
    cudaStream_t st = (cudaStream_t)stream;
    return (int)dispatch(dtype, hd, [&](auto t, auto h) {
        using T = decltype(t);
        constexpr int HDP = decltype(h)::value;
        return softcap > 0.f ? launch<T, HDP, true>(p, st) : launch<T, HDP, false>(p, st);
    });
}

// How many blocks of the kernel for (hd, dtype, capped) one SM holds at
// once, into *blocks: the wrapper sizes the split plan to one wave of them.
// Returns the cudaError_t of the query.
extern "C" int paged_attention_blocks_per_sm(int hd, int dtype, int capped,
                                             int* blocks) {
    return (int)dispatch(dtype, hd, [&](auto t, auto h) {
        using T = decltype(t);
        constexpr int HDP = decltype(h)::value;
        return capped ? occupancy<T, HDP, true>(blocks) : occupancy<T, HDP, false>(blocks);
    });
}

// ------------------------------------------------------------------ K4: MLA
//
// Paged decode of multi-head latent attention.  Every head of a row reads the
// same cached latent a slot: DK = DV + DR columns, the normed latent c (DV)
// then the roped key (DR).  The wrapper hands the queries already absorbed
// into the latent's space, q = [q_nope W_UK^T, q_pe] [B,H,DK], and the kernel
// computes softmax(scale q . latent) . latent[:, :DV] over the row's live
// slots, V aliasing K's first DV columns, so each slot is read once.
//
// What bounds it: bytes.  A 2 DK-byte slot costs 2 H DK + 2 H DV FLOPs, about
// 30 FLOPs a byte at H = 16, a tenth of what would make the tensor cores the
// limit; the least time is the live latents over HBM bandwidth.  The first
// design (K1's family) took about 4.4 us a 16-slot tile (18.4 KB) whatever
// the bandwidth: all 128 threads issued its 1 152 16-byte cp.async with their
// index arithmetic, the block met twice at __syncthreads, and the four warps
// passed their partial scores through 4 KB of shared memory, since no warp
// could hold all DV output columns of 16 heads.  Its column ranges were cut
// from the table's MB columns, so rows shorter than the table left blocks
// idle.  About a fifth of the bound in Moonlight's serving.  This design:
//   * splits each row's live columns, not MB.  The grid is (B, n_splits),
//     n_splits from shapes alone (a captured CUDA graph replays the same
//     launch); a block reads its row's length and takes its share of the
//     ceil(len / bt) live columns;
//   * one producer warp fills a ring of MLA_STAGES stages of 64 slots (72 KB
//     each) with TMA copies.  A frame of bt slots is NCH boxes of bt rows x
//     128 bytes, 128-byte swizzled, its frame id read from the block table on
//     the device (the block table is the page table: no gathered copy of the
//     cache exists).  Full / empty mbarriers track the stages, so the
//     consumers spend no instruction on an address and meet at no
//     block-wide barrier inside the loop;
//   * one consumer warpgroup runs both products on wgmma with the 16 heads as
//     N, so nothing is padded at H = 16: S^T = latent [64 x DK] . Q^T (Q
//     staged once, the K-major B), then O^T [DV x 16] += V^T . P^T, V^T the
//     stage's first DV columns read transposed as A and P [16 x 64] the B, in
//     shared memory as bf16 hi + lo (as K1 splits it, so P V stays within
//     ~1e-5 of the float32 product).  The warpgroup holds all 16 x DV outputs,
//     64 float32 a thread; the softmax of a stage meets once, to exchange the
//     heads' maxima over its 64 slots;
//   * the combine costs no launch: the last block of a row, found with a
//     counter it resets, merges the partials (max, rescale, sum, denominator
//     floored at 1e-30).  Scores, softmax and sums are float32.
// A slot past the row's length in a live frame is loaded and masked (P = 0);
// so is a frame that is absent (-1) or pads the last stage, which loads frame
// 0 in its place.  A row with no live slot comes out as 0.
#include <cuda.h>   // CUtensorMap and its enums; the encoder is fetched at run time

namespace {

constexpr int MLA_SLOTS = 64;       // slots a stage: the M of the scores' wgmma
constexpr int MLA_STAGES = 2;       // stages in the ring (two fill 144 KB)
constexpr int MLA_CONSUMERS = 128;  // one warpgroup
constexpr int MLA_THREADS = MLA_CONSUMERS + 32;   // and the producer warp
constexpr int SW = 128;             // bytes a swizzled row

template <int DV, int DR>
struct MlaLayout {
    static constexpr int DK = DV + DR;
    static constexpr int NCH = DK / 64;       // 128-byte chunks a latent row
    static constexpr int VCH = DV / 64;       // of them V's: O^T's m64 tiles
    static constexpr int KSTEPS = DK / 16;
    static constexpr int CHUNK = MLA_SLOTS * SW;       // one chunk of a stage
    static constexpr int STAGE = NCH * CHUNK;          // [NCH][64 slots][128 B]
    static constexpr int QCHUNK = GM * SW;
    static constexpr int SQ = MLA_STAGES * STAGE;      // Q [NCH][16][128 B]
    static constexpr int SP = SQ + NCH * QCHUNK;       // P hi, then lo [16][128 B]
    static constexpr int RED = SP + 2 * GM * SW;       // [NW][16] float32
    static constexpr int BARS = RED + NW * GM * 4;     // full, then empty
    static constexpr int LAST = BARS + 2 * MLA_STAGES * 8;
    static constexpr int BYTES = LAST + 16 + 1024;     // + aligning the base
    static_assert(DK % 64 == 0 && DV % 64 == 0, "128-byte chunks");
};

// The 16-byte unit u of row r of a 128-byte-swizzled block (1 024-aligned),
// as TMA writes it and wgmma reads it.
__device__ __forceinline__ int sw128(int r, int u) { return r * SW + ((u ^ (r & 7)) << 4); }

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`; trap
// (a launch failure) rather than hang on a stage that never arrives.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
    for (int n = 0;; ++n) {
        uint32_t done;
        asm volatile("{\n .reg .pred p;\n"
                     " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     " selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(bar), "r"(parity) : "memory");
        if (done) return;
        if (n == 1 << 22) __trap();
    }
}

// One box of the tensor map at column x, row y into shared memory at dst,
// its bytes counted on the mbarrier at bar.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int x,
                                            int y, uint32_t bar) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3}], [%4];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
        : "memory");
}

// A wgmma descriptor of a 128-byte-swizzled operand at shared address addr;
// lbo and sbo in 16-byte units (sbo: the stride of 8-row groups).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, int lbo, int sbo) {
    return (uint64_t)((addr & 0x3ffffu) >> 4) | (uint64_t)lbo << 16 |
           (uint64_t)sbo << 32 | 1ull << 62;
}

// d (+)= A [64 x 16] . B [16 x 16], bf16 from shared memory, float32 in
// registers; A K-major (TRANS_A 0) or M-major (1), B K-major.
template <int TRANS_A>
__device__ __forceinline__ void wgmma_n16(float (&d)[8], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %10, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(acc), "n"(TRANS_A));
}

__device__ __forceinline__ void wg_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit_wait() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from touching wgmma's registers before the wait.
__device__ __forceinline__ void reg_fence(float (&r)[8]) {
#pragma unroll
    for (int i = 0; i < 8; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// Generic-proxy writes to shared memory, visible to the async proxy (wgmma).
__device__ __forceinline__ void fence_async_smem() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The consumer warpgroup's barrier (the producer warp never joins it).
__device__ __forceinline__ void consumers_sync() {
    asm volatile("bar.sync 1, %0;\n" :: "n"(MLA_CONSUMERS) : "memory");
}

struct MlaParams {
    const __nv_bfloat16* q;      // [B,H,DK]
    const int* tables;           // [B,MB]
    const int* lens;             // [B]
    float* out;                  // [B,H,DV]
    float* part;                 // B*n_splits*GM rows: acc [DV], then m, then l
    int* counters;               // [B], 0 between launches
    int B, H, bt, MB, n_splits;
    float scale_log2;
};

// A thread's 8 accumulator registers of an m64n16 tile: register r holds row
// 16 warp + g + 8 ((r >> 1) & 1) and column (head) 8 (r >> 2) + 2 t + (r & 1);
// hh = 2 (r >> 2) + (r & 1) numbers the thread's four heads.
__device__ __forceinline__ int head_of(int hh, int t) { return 8 * (hh >> 1) + 2 * t + (hh & 1); }

template <int DV, int DR>
__global__ void __launch_bounds__(MLA_THREADS, 1)
    mla_decode_kernel(const __grid_constant__ CUtensorMap lat_map, const MlaParams p) {
    using L = MlaLayout<DV, DR>;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
    const uint32_t base = smem_u32(smem);
    const uint32_t full = base + L::BARS, empty = full + 8 * MLA_STAGES;
    int* s_last = reinterpret_cast<int*>(smem + L::LAST);

    // this block's share of the row's live columns
    const int b = blockIdx.x, split = blockIdx.y;
    const int* table_row = p.tables + (int64_t)b * p.MB;
    const int len = __ldg(p.lens + b);
    const int live_cols = len > 0 ? min(p.MB, (len + p.bt - 1) / p.bt) : 0;
    const int per = (live_cols + p.n_splits - 1) / p.n_splits;
    const int c_begin = min(split * per, live_cols);
    const int c_end = min(c_begin + per, live_cols);
    const int fps = MLA_SLOTS / p.bt;          // frames a stage
    const int n_stages = (c_end - c_begin + fps - 1) / fps;

    if (threadIdx.x == 0) {
        for (int s = 0; s < MLA_STAGES; ++s) {
            mbar_init(full + 8 * s, 1);
            mbar_init(empty + 8 * s, NW);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (threadIdx.x >= MLA_CONSUMERS) {        // the producer warp
        const int lane = threadIdx.x & 31;
        for (int i = 0; i < n_stages; ++i) {
            const int s = i % MLA_STAGES;
            if (i >= MLA_STAGES) mbar_wait(empty + 8 * s, (i / MLA_STAGES - 1) & 1);
            if (lane == 0) mbar_expect_tx(full + 8 * s, L::STAGE);
            __syncwarp();
            if (lane < fps) {                  // lane f copies frame f of the stage
                const int col = c_begin + i * fps + lane;
                const int frame = col < c_end ? __ldg(table_row + col) : -1;
                const int row = frame >= 0 ? frame * p.bt : 0;
                const uint32_t dst = base + s * L::STAGE + lane * p.bt * SW;
#pragma unroll
                for (int c = 0; c < L::NCH; ++c)
                    tma_load_2d(dst + c * L::CHUNK, &lat_map, 64 * c, row, full + 8 * s);
            }
        }
        return;
    }

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    {   // Q [16][DK], zero rows past H, as wgmma's K-major B
        const __nv_bfloat16* qb = p.q + (int64_t)b * p.H * L::DK;
        for (int idx = tid; idx < GM * L::NCH * 8; idx += MLA_CONSUMERS) {
            const int n = idx / (L::NCH * 8), u = idx % (L::NCH * 8);
            uint4 v = make_uint4(0u, 0u, 0u, 0u);
            if (n < p.H) v = *reinterpret_cast<const uint4*>(qb + n * L::DK + 8 * u);
            *reinterpret_cast<uint4*>(smem + L::SQ + (u >> 3) * L::QCHUNK + sw128(n, u & 7)) = v;
        }
    }
    fence_async_smem();
    consumers_sync();

    float m[4], l[4], acc[L::VCH][8];
#pragma unroll
    for (int hh = 0; hh < 4; ++hh) m[hh] = NEG_INF, l[hh] = 0.f;
#pragma unroll
    for (int j = 0; j < L::VCH; ++j)
#pragma unroll
        for (int r = 0; r < 8; ++r) acc[j][r] = 0.f;
    float* red = reinterpret_cast<float*>(smem + L::RED);
    const uint32_t sq = base + L::SQ, sp = base + L::SP;
    const int p0 = c_begin * p.bt, p1 = min(c_end * p.bt, len);

    for (int i = 0; i < n_stages; ++i) {
        const int s = i % MLA_STAGES;
        bool live[2];                          // this thread's slots 16 warp + g (+ 8)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
            const int sl = i * MLA_SLOTS + 16 * warp + g + 8 * k;
            live[k] = p0 + sl < p1 && __ldg(table_row + c_begin + sl / p.bt) >= 0;
        }
        mbar_wait(full + 8 * s, (i / MLA_STAGES) & 1);
        __syncwarp();                          // converged for wgmma
        const uint32_t st = base + s * L::STAGE;

        // S^T [64 slots x 16 heads] = latent . Q^T
        float sc[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) sc[r] = 0.f;
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < L::KSTEPS; ++kk)
            wgmma_n16<0>(sc, sw128_desc(st + (kk >> 2) * L::CHUNK + (kk & 3) * 32, 1, 64),
                         sw128_desc(sq + (kk >> 2) * L::QCHUNK + (kk & 3) * 32, 1, 64),
                         kk > 0);
        wg_commit_wait();
        reg_fence(sc);

        // online softmax over the stage's slots: a head's maxima meet once
        float mx[4] = {NEG_INF, NEG_INF, NEG_INF, NEG_INF};
#pragma unroll
        for (int r = 0; r < 8; ++r) {
            const int hh = 2 * (r >> 2) + (r & 1);
            sc[r] = live[(r >> 1) & 1] ? sc[r] * p.scale_log2 : NEG_INF;
            mx[hh] = fmaxf(mx[hh], sc[r]);
        }
#pragma unroll
        for (int hh = 0; hh < 4; ++hh) {
#pragma unroll
            for (int off = 4; off < 32; off <<= 1)
                mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(FULL, mx[hh], off));
            if (g == 0) red[warp * GM + head_of(hh, t)] = mx[hh];
        }
        consumers_sync();
        float alpha[4];
#pragma unroll
        for (int hh = 0; hh < 4; ++hh) {
            const int h = head_of(hh, t);
            float mm = fmaxf(fmaxf(red[h], red[GM + h]), fmaxf(red[2 * GM + h], red[3 * GM + h]));
            mm = fmaxf(m[hh], mm);
            alpha[hh] = exp2f(m[hh] - mm);
            m[hh] = mm;
            l[hh] *= alpha[hh];
        }
        // P = hi + lo as wgmma's K-major B: [head][slot]
#pragma unroll
        for (int r = 0; r < 8; ++r) {
            const int hh = 2 * (r >> 2) + (r & 1), h = head_of(hh, t);
            const int sl = 16 * warp + g + 8 * ((r >> 1) & 1);
            const float e = live[(r >> 1) & 1] ? exp2f(sc[r] - m[hh]) : 0.f;
            l[hh] += e;
            const __nv_bfloat16 hi = __float2bfloat16(e);
            const int off = L::SP + sw128(h, sl >> 3) + 2 * (sl & 7);
            *reinterpret_cast<__nv_bfloat16*>(smem + off) = hi;
            *reinterpret_cast<__nv_bfloat16*>(smem + off + GM * SW) =
                __float2bfloat16(e - __bfloat162float(hi));
        }
#pragma unroll
        for (int j = 0; j < L::VCH; ++j)
#pragma unroll
            for (int r = 0; r < 8; ++r) acc[j][r] *= alpha[2 * (r >> 2) + (r & 1)];
        fence_async_smem();
        consumers_sync();

        // O^T [DV x 16] += V^T . P^T, P = hi + lo
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < MLA_SLOTS / 16; ++kk)
#pragma unroll
            for (int j = 0; j < L::VCH; ++j) {
                const uint64_t v = sw128_desc(st + j * L::CHUNK + kk * 16 * SW, 64, 64);
                wgmma_n16<1>(acc[j], v, sw128_desc(sp + kk * 32, 1, 64), 1);
                wgmma_n16<1>(acc[j], v, sw128_desc(sp + GM * SW + kk * 32, 1, 64), 1);
            }
        wg_commit_wait();
#pragma unroll
        for (int j = 0; j < L::VCH; ++j) reg_fence(acc[j]);
        if (lane == 0) mbar_arrive(empty + 8 * s);   // the stage is free
    }

    // a head's sum over the g lanes, then over the warps
#pragma unroll
    for (int hh = 0; hh < 4; ++hh) {
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) l[hh] += __shfl_xor_sync(FULL, l[hh], off);
        if (g == 0) red[warp * GM + head_of(hh, t)] = l[hh];
    }
    consumers_sync();
#pragma unroll
    for (int hh = 0; hh < 4; ++hh) {
        const int h = head_of(hh, t);
        l[hh] = red[h] + red[GM + h] + red[2 * GM + h] + red[3 * GM + h];
    }
    float* part_m = p.part + (int64_t)p.B * p.n_splits * GM * DV;
    float* part_l = part_m + (int64_t)p.B * p.n_splits * GM;
    const int64_t prow0 = ((int64_t)b * p.n_splits + split) * GM;
#pragma unroll
    for (int hh = 0; hh < 4; ++hh) {
        const int h = head_of(hh, t);
        if (h >= p.H) continue;
        const float inv = p.n_splits == 1 ? 1.0f / fmaxf(l[hh], 1e-30f) : 1.f;
        float* o = p.n_splits == 1 ? p.out + ((int64_t)b * p.H + h) * DV
                                   : p.part + (prow0 + h) * DV;
#pragma unroll
        for (int j = 0; j < L::VCH; ++j)
#pragma unroll
            for (int k = 0; k < 2; ++k)
                o[64 * j + 16 * warp + g + 8 * k] = acc[j][4 * (hh >> 1) + 2 * k + (hh & 1)] * inv;
        if (p.n_splits > 1 && warp == 0 && g == 0) {
            part_m[prow0 + h] = m[hh];
            part_l[prow0 + h] = l[hh];
        }
    }
    if (p.n_splits == 1) return;

    // the last block of this row merges the partials
    __threadfence();
    consumers_sync();
    int* counter = p.counters + b;
    if (tid == 0) *s_last = atomicAdd(counter, 1) == p.n_splits - 1;
    consumers_sync();
    if (!*s_last) return;
    __threadfence();

    const int n = p.n_splits;
    float* sf = reinterpret_cast<float*>(smem);  // [GM][n] rescale factors (the ring is idle)
    float* sden = sf + GM * n;                   // [GM] denominators
    for (int h = warp; h < p.H; h += NW) {
        float M = NEG_INF;
        for (int sp2 = lane; sp2 < n; sp2 += 32)
            M = fmaxf(M, __ldcg(part_m + ((int64_t)b * n + sp2) * GM + h));
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) M = fmaxf(M, __shfl_xor_sync(FULL, M, off));
        float den = 0.f;
        for (int sp2 = lane; sp2 < n; sp2 += 32) {
            const int64_t prow = ((int64_t)b * n + sp2) * GM + h;
            const float f = exp2f(__ldcg(part_m + prow) - M);
            sf[h * n + sp2] = f;
            den += __ldcg(part_l + prow) * f;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) den += __shfl_xor_sync(FULL, den, off);
        if (lane == 0) sden[h] = den;
    }
    consumers_sync();
    constexpr int DV4 = DV / 4;
    for (int idx = tid; idx < p.H * DV4; idx += MLA_CONSUMERS) {
        const int h = idx / DV4, d = 4 * (idx % DV4);
        float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int sp2 = 0; sp2 < n; ++sp2) {
            const float f = sf[h * n + sp2];
            const float4 a = __ldcg(reinterpret_cast<const float4*>(
                p.part + (((int64_t)b * n + sp2) * GM + h) * DV + d));
            num.x += a.x * f;
            num.y += a.y * f;
            num.z += a.z * f;
            num.w += a.w * f;
        }
        const float inv = 1.0f / fmaxf(sden[h], 1e-30f);
        *reinterpret_cast<float4*>(p.out + ((int64_t)b * p.H + h) * DV + d) =
            make_float4(num.x * inv, num.y * inv, num.z * inv, num.w * inv);
    }
    if (tid == 0) *counter = 0;                  // ready for the next launch
}

// cuTensorMapEncodeTiled, fetched from the driver once (the library links
// only the runtime); null if the driver has none.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
    static const EncodeTiled fn = [] {
        void* f = nullptr;
        cudaDriverEntryPointQueryResult got;
#if CUDART_VERSION >= 12050
        const cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &got);
#else
        const cudaError_t err =
            cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &got);
#endif
        return err == cudaSuccess && got == cudaDriverEntryPointSuccess
                   ? reinterpret_cast<EncodeTiled>(f) : nullptr;
    }();
    return fn;
}

// The latents [N*bt rows, DK] as boxes of bt rows x 64 columns (128 bytes),
// 128-byte swizzled.
template <int DV, int DR>
cudaError_t mla_map(CUtensorMap* map, const void* lat, int N, int bt) {
    constexpr int DK = DV + DR;
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint64_t dims[2] = {(cuuint64_t)DK, (cuuint64_t)N * bt};
    const cuuint64_t strides[1] = {(cuuint64_t)DK * 2};
    const cuuint32_t box[2] = {64, (cuuint32_t)bt};
    const cuuint32_t step[2] = {1, 1};
    const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(lat),
                              dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int DV, int DR>
cudaError_t mla_launch(const MlaParams& p, const void* lat, int N, cudaStream_t stream) {
    CUtensorMap map;
    cudaError_t err = mla_map<DV, DR>(&map, lat, N, p.bt);
    if (err != cudaSuccess) return err;
    constexpr int smem = MlaLayout<DV, DR>::BYTES;
    auto kernel = mla_decode_kernel<DV, DR>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(p.B, p.n_splits), MLA_THREADS, smem, stream>>>(map, p);
    return cudaGetLastError();
}

template <int DV, int DR>
cudaError_t mla_occupancy(int* blocks) {
    constexpr int smem = MlaLayout<DV, DR>::BYTES;
    auto kernel = mla_decode_kernel<DV, DR>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, MLA_THREADS, smem);
}

// f(integral_constant<DV>, integral_constant<DR>) for the instance of
// (dv, dr): Moonlight's and DeepSeek-V3's (512, 64)
template <typename F>
cudaError_t mla_dispatch(int dv, int dr, F&& f) {
    if (dv == 512 && dr == 64)
        return f(std::integral_constant<int, 512>{}, std::integral_constant<int, 64>{});
    return cudaErrorInvalidValue;
}

}  // namespace

// q [B,H,dv+dr] bf16 (H <= 16), latents [N,bt,dv+dr] bf16 (one layer,
// contiguous, 16-byte aligned), tables [B,MB] i32 physical frames (-1
// absent), lens [B] i32, out [B,H,dv] f32.  n_splits (from the wrapper)
// blocks share each row's live columns; with n_splits > 1, `part` holds
// B*n_splits*16*(dv + 2) floats and `counters` B ints that are 0 (the kernel
// leaves them 0).  n_splits outside 1..MAX_SPLITS, H outside 1..16, a block
// size bt that does not divide the 64 slots of a stage into frames of 8 or
// more, or widths without an instance return cudaErrorInvalidValue and
// launch nothing.  Returns the launch's cudaError_t (0 = launched).
extern "C" int mla_decode_launch(const void* q, const void* lat, const void* tables,
                                 const void* lens, void* out, void* part,
                                 void* counters, int B, int H, int dv, int dr, int bt,
                                 int MB, int N, int n_splits, float scale, void* stream) {
    if (B == 0) return 0;
    if (n_splits < 1 || n_splits > MAX_SPLITS || H < 1 || H > GM || N < 1 || MB < 1 ||
        bt < 8 || MLA_SLOTS % bt != 0)
        return (int)cudaErrorInvalidValue;
    MlaParams p{(const __nv_bfloat16*)q, (const int*)tables, (const int*)lens,
                (float*)out, (float*)part, (int*)counters, B, H, bt, MB, n_splits,
                1.44269504f * scale};
    cudaStream_t st = (cudaStream_t)stream;
    return (int)mla_dispatch(dv, dr, [&](auto v, auto r) {
        return mla_launch<decltype(v)::value, decltype(r)::value>(p, lat, N, st);
    });
}

// How many blocks of K4's (dv, dr) instance one SM holds at once, into
// *blocks.  Returns the cudaError_t of the query.
extern "C" int mla_decode_blocks_per_sm(int dv, int dr, int* blocks) {
    return (int)mla_dispatch(dv, dr, [&](auto v, auto r) {
        return mla_occupancy<decltype(v)::value, decltype(r)::value>(blocks);
    });
}
