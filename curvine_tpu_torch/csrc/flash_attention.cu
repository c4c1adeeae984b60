// K3: causal flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels that curvine_tpu/tpu/model.py:113-122
// (_flash_attention) reaches through jax.experimental.pallas.ops.tpu.
// flash_attention, a jax.custom_vjp of three pallas_calls and one XLA
// reduction:
//   flash_fwd      <- _flash_attention_kernel       (flash_attention.py:758)
//   flash_bwd_di   <- di = sum(o * do, -1)          (flash_attention.py:273)
//   flash_bwd_dkv  <- _flash_attention_dkv_kernel   (flash_attention.py:1121)
//   flash_bwd_dq   <- _flash_attention_dq_kernel    (flash_attention.py:1456)
// (line numbers of the JAX release the package is tested with, 0.9.0).
//
// Layout: q, k, v, o, do, dq, dk, dv are contiguous [B*H, L, 128] bf16;
// lse and di are [B*H, L] f32. lse = m + log(l) is the row's log-sum-exp
// of the scaled scores (the library keeps m and l apart; one f32 a row
// carries the same information).
//
// di is the one departure from the library's numerics. The library takes
// di = rowsum(o * do) from the bf16 output o, whose rounding (2^-9 of
// |o||do|) swamps dS = P (dP - di) wherever the true dS is small: on the
// flagship model after twenty steps, attention is near uniform and dQ is
// ~1e-8, and with that di the kernel path's gradients and the plain
// path's (the same formula) disagreed, at a cosine of 0.647 for one
// layer's wq. flash_bwd_di takes di = sum_j P_ij dP_ij in f32 from the
// same P and dP that the other backward kernels recompute, which is
// rowsum(o * do) for the exact o and keeps sum_j dS_ij = 0; chip_smoke.py
// holds each layer's dQ against f64 dense attention there.
//
// Numerics follow the library kernel: S = Q K^T accumulates in f32 and
// is scaled by sm_scale; P is rounded to bf16 before P V (forward) and
// before dV = P^T dO; dS = P (dP - di) sm_scale is rounded to bf16
// before dK = dS^T Q and dQ = dS K. Masked scores get -inf in the
// forward (the diagonal of a causal row is always visible, so every row
// has a finite maximum) and P = 0 in the backward.
//
// What bounds them: at the flagship's shape ([16*20, 1024, 128]) the
// forward does 8.6e10 causal FLOP over 336 MB of q, k, v and o (0.087 ms
// of tensor-core time against 0.100 ms of bytes at 3.35 TB/s); the
// dK/dV and dQ kernels recompute S and do 1.3-1.7e11 FLOP over 419-503
// MB, so they are bound by operations; the di kernel does the forward's
// FLOP over its bytes, bound by bytes. All four are products of 16-row
// tiles, so the design's one aim is to keep them on the tensor cores:
// every product is an mma.sync m16n8k16 bf16 -> f32 (inline PTX). The
// softmax runs in registers on the accumulator fragments, and the
// accumulator layout of S is reused directly as the A operand of the
// next product (P V, P^T dO, dS^T Q, dS K), so P and dS never touch
// shared or device memory. Tiles come in through shared memory with
// 16-byte loads; operands that a product needs along the other axis
// (V for P V, Q and dO for the key-side products, K for dS K) are
// stored a second time transposed, so every fragment is one 32-bit
// shared load without bank conflicts. No atomics: the dK/dV kernel owns
// a key tile and walks the query tiles, the dQ kernel owns a query tile
// and walks the key tiles, so each output is written once and the
// result is deterministic; the di kernel owns a query tile like dQ.
// Causal tiles above the diagonal are skipped.
// This is the simple form: no TMA, no wgmma, no pipelining of loads
// with products; those wait for the redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = 128;          // head_dim
constexpr int LDS = D + 8;      // pitch (bf16) of a [row][d] tile in smem
constexpr int THREADS = 128;    // 4 warps, each owning 16 rows of a tile

constexpr int FWD_BQ = 64, FWD_BK = 64;   // forward: Q tile, K/V tile
constexpr int DKV_BK = 64, DKV_BQ = 32;   // dK/dV: K tile, Q tile walked
constexpr int DQ_BQ = 64, DQ_BK = 64;     // dQ: Q tile, K tile walked

__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4):
//   A 16x16 row-major: a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                      a3 (g+8, 2t+8..)
//   B 16x8 (k x n):    b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g)
//   C 16x8 f32:        c0,c1 (g, 2t..2t+1), c2,c3 (g+8, 2t..2t+1)

// A operand, rows [row0, row0+16) x cols [col0, col0+16) of a [row][col]
// smem tile with pitch `ld`.
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* s, int ld,
                                       int row0, int col0, int g, int t) {
    const bf16* p = s + (row0 + g) * ld + col0 + 2 * t;
    a[0] = ld32(p);
    a[1] = ld32(p + 8 * ld);
    a[2] = ld32(p + 8);
    a[3] = ld32(p + 8 * ld + 8);
}

// B operand (k x n = 16 x 8) read from a smem tile stored [n][k], pitch ld.
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1,
                                       const bf16* s, int ld, int n0, int k0,
                                       int g, int t) {
    const bf16* p = s + (n0 + g) * ld + k0 + 2 * t;
    b0 = ld32(p);
    b1 = ld32(p + 8);
}

// The accumulators of two neighbouring n-tiles (16 x 16 of C) as the A
// operand of the next product, rounded to bf16.
__device__ __forceinline__ void c_to_a(uint32_t a[4], const float c0[4],
                                       const float c1[4]) {
    a[0] = pack2(c0[0], c0[1]);
    a[1] = pack2(c0[2], c0[3]);
    a[2] = pack2(c1[0], c1[1]);
    a[3] = pack2(c1[2], c1[3]);
}

// ROWS rows of 128 bf16 from global (pitch D) into smem [row][LDS].
template <int ROWS>
__device__ __forceinline__ void load_rows(bf16* s, const bf16* g) {
    for (int i = threadIdx.x; i < ROWS * (D / 8); i += THREADS) {
        const int r = i / (D / 8), c = (i % (D / 8)) * 8;
        *reinterpret_cast<uint4*>(s + r * LDS + c) =
            *reinterpret_cast<const uint4*>(g + (size_t)r * D + c);
    }
}

// The same rows stored transposed, smem [d][row] with pitch ROWS + 8.
// Neighbouring threads take neighbouring rows, so the 2-byte stores of
// a warp fall in distinct banks.
template <int ROWS>
__device__ __forceinline__ void load_rows_t(bf16* s, const bf16* g) {
    constexpr int LDT = ROWS + 8;
    for (int i = threadIdx.x; i < ROWS * (D / 8); i += THREADS) {
        const int r = i % ROWS, c = (i / ROWS) * 8;
        uint4 v = *reinterpret_cast<const uint4*>(g + (size_t)r * D + c);
        const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
        for (int j = 0; j < 8; j++) s[(c + j) * LDT + r] = e[j];
    }
}

template <int N>
__device__ __forceinline__ void load_f32(float* s, const float* g) {
    for (int i = threadIdx.x; i < N; i += THREADS) s[i] = g[i];
}

__device__ __forceinline__ float quad_max(float x) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ------------------------------------------------------------- forward
// grid (L / 64, B*H): one block per 64-row Q tile, heaviest tiles first.
// Each warp keeps its 16 Q rows as A fragments in registers and walks
// the K/V tiles up to the diagonal with an online softmax.

constexpr int FWD_SMEM =
    (FWD_BK * LDS + D * (FWD_BK + 8)) * (int)sizeof(bf16);

__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int L, float scale) {
    extern __shared__ __align__(16) unsigned char smem[];
    bf16* sK = reinterpret_cast<bf16*>(smem);       // [64][LDS]; Q first
    bf16* sVt = sK + FWD_BK * LDS;                  // [128][64 + 8]
    constexpr int LDV = FWD_BK + 8;

    const int qt = gridDim.x - 1 - blockIdx.x;
    const size_t bh = blockIdx.y;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const bf16* K = k + bh * L * D;
    const bf16* V = v + bh * L * D;

    load_rows<FWD_BQ>(sK, q + (bh * L + (size_t)qt * FWD_BQ) * D);
    __syncthreads();
    uint32_t qa[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; kk++)
        load_a(qa[kk], sK, LDS, warp * 16, kk * 16, g, t);

    float acc[D / 8][4];
#pragma unroll
    for (int i = 0; i < D / 8; i++)
        acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    const int row0 = qt * FWD_BQ + warp * 16 + g;   // rows row0, row0 + 8

    for (int kt = 0; kt <= qt; kt++) {
        __syncthreads();                 // the last tile's reads are done
        load_rows<FWD_BK>(sK, K + (size_t)kt * FWD_BK * D);
        load_rows_t<FWD_BK>(sVt, V + (size_t)kt * FWD_BK * D);
        __syncthreads();

        float s[FWD_BK / 8][4];
#pragma unroll
        for (int nt = 0; nt < FWD_BK / 8; nt++)
            s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; kk++) {
#pragma unroll
            for (int nt = 0; nt < FWD_BK / 8; nt++) {
                uint32_t b0, b1;
                load_b(b0, b1, sK, LDS, nt * 8, kk * 16, g, t);
                mma16816(s[nt], qa[kk], b0, b1);
            }
        }
        const bool diag = kt == qt;
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int nt = 0; nt < FWD_BK / 8; nt++) {
#pragma unroll
            for (int e = 0; e < 4; e++) {
                const int r = row0 + (e >> 1) * 8;
                const int c = kt * FWD_BK + nt * 8 + 2 * t + (e & 1);
                float x = s[nt][e] * scale;
                if (diag && c > r) x = -INFINITY;
                s[nt][e] = x;
                mx[e >> 1] = fmaxf(mx[e >> 1], x);
            }
        }
#pragma unroll
        for (int i = 0; i < 2; i++) {
            mx[i] = quad_max(mx[i]);
            const float alpha = __expf(m[i] - mx[i]);
            m[i] = mx[i];
            l[i] *= alpha;
#pragma unroll
            for (int dt = 0; dt < D / 8; dt++) {
                acc[dt][2 * i] *= alpha;
                acc[dt][2 * i + 1] *= alpha;
            }
        }
#pragma unroll
        for (int nt = 0; nt < FWD_BK / 8; nt++) {
#pragma unroll
            for (int e = 0; e < 4; e++) {
                const float p = __expf(s[nt][e] - m[e >> 1]);
                s[nt][e] = p;
                l[e >> 1] += p;
            }
        }
#pragma unroll
        for (int kk = 0; kk < FWD_BK / 16; kk++) {
            uint32_t pa[4];
            c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
            for (int dt = 0; dt < D / 8; dt++) {
                uint32_t b0, b1;
                load_b(b0, b1, sVt, LDV, dt * 8, kk * 16, g, t);
                mma16816(acc[dt], pa, b0, b1);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 2; i++) {
        const float li = quad_sum(l[i]);
        const float inv = 1.f / li;
        const size_t r = bh * L + row0 + i * 8;
        bf16* orow = o + r * D;
#pragma unroll
        for (int dt = 0; dt < D / 8; dt++)
            *reinterpret_cast<uint32_t*>(orow + dt * 8 + 2 * t) =
                pack2(acc[dt][2 * i] * inv, acc[dt][2 * i + 1] * inv);
        if (t == 0) lse[r] = m[i] + logf(li);
    }
}

// ----------------------------------------------------- backward: dK, dV
// grid (L / 64, B*H): one block per 64-key tile; each warp owns 16 keys.
// The block walks the 32-row Q tiles from the diagonal to the end and
// accumulates dV = P^T dO and dK = dS^T Q in registers, with
// P^T = exp(K Q^T scale - lse) and dS^T = P^T (V dO^T - di) scale.

constexpr int DKV_LDT = DKV_BQ + 8;
constexpr int DKV_SMEM =
    (2 * DKV_BK * LDS + 2 * DKV_BQ * LDS + 2 * D * DKV_LDT)
        * (int)sizeof(bf16) + 2 * DKV_BQ * (int)sizeof(float);

__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ di, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int L, float scale) {
    extern __shared__ __align__(16) unsigned char smem[];
    bf16* sK = reinterpret_cast<bf16*>(smem);       // [64][LDS]
    bf16* sV = sK + DKV_BK * LDS;                   // [64][LDS]
    bf16* sQ = sV + DKV_BK * LDS;                   // [32][LDS]
    bf16* sdO = sQ + DKV_BQ * LDS;                  // [32][LDS]
    bf16* sQt = sdO + DKV_BQ * LDS;                 // [128][32 + 8]
    bf16* sdOt = sQt + D * DKV_LDT;                 // [128][32 + 8]
    float* sL = reinterpret_cast<float*>(sdOt + D * DKV_LDT);  // [32]
    float* sD = sL + DKV_BQ;                                   // [32]

    const int kt = gridDim.x - 1 - blockIdx.x;
    const size_t bh = blockIdx.y;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const size_t base = bh * L;

    load_rows<DKV_BK>(sK, k + (base + (size_t)kt * DKV_BK) * D);
    load_rows<DKV_BK>(sV, v + (base + (size_t)kt * DKV_BK) * D);

    float dKa[D / 8][4], dVa[D / 8][4];
#pragma unroll
    for (int i = 0; i < D / 8; i++) {
        dKa[i][0] = dKa[i][1] = dKa[i][2] = dKa[i][3] = 0.f;
        dVa[i][0] = dVa[i][1] = dVa[i][2] = dVa[i][3] = 0.f;
    }
    const int key0 = kt * DKV_BK + warp * 16 + g;   // keys key0, key0 + 8

    for (int qt = kt * DKV_BK / DKV_BQ; qt < L / DKV_BQ; qt++) {
        const size_t r0 = base + (size_t)qt * DKV_BQ;
        __syncthreads();
        load_rows<DKV_BQ>(sQ, q + r0 * D);
        load_rows<DKV_BQ>(sdO, dout + r0 * D);
        load_rows_t<DKV_BQ>(sQt, q + r0 * D);
        load_rows_t<DKV_BQ>(sdOt, dout + r0 * D);
        load_f32<DKV_BQ>(sL, lse + r0);
        load_f32<DKV_BQ>(sD, di + r0);
        __syncthreads();

        float s[DKV_BQ / 8][4], dp[DKV_BQ / 8][4];
#pragma unroll
        for (int nt = 0; nt < DKV_BQ / 8; nt++) {
            s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
            dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; kk++) {
            uint32_t ka[4], va[4];
            load_a(ka, sK, LDS, warp * 16, kk * 16, g, t);
            load_a(va, sV, LDS, warp * 16, kk * 16, g, t);
#pragma unroll
            for (int nt = 0; nt < DKV_BQ / 8; nt++) {
                uint32_t b0, b1;
                load_b(b0, b1, sQ, LDS, nt * 8, kk * 16, g, t);
                mma16816(s[nt], ka, b0, b1);
                load_b(b0, b1, sdO, LDS, nt * 8, kk * 16, g, t);
                mma16816(dp[nt], va, b0, b1);
            }
        }
#pragma unroll
        for (int nt = 0; nt < DKV_BQ / 8; nt++) {
#pragma unroll
            for (int e = 0; e < 4; e++) {
                const int key = key0 + (e >> 1) * 8;
                const int cq = nt * 8 + 2 * t + (e & 1);
                const int row = qt * DKV_BQ + cq;
                const float p = row >= key
                    ? __expf(s[nt][e] * scale - sL[cq]) : 0.f;
                s[nt][e] = p;
                dp[nt][e] = p * (dp[nt][e] - sD[cq]) * scale;
            }
        }
#pragma unroll
        for (int kk = 0; kk < DKV_BQ / 16; kk++) {
            uint32_t pa[4], dsa[4];
            c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
            c_to_a(dsa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
            for (int dt = 0; dt < D / 8; dt++) {
                uint32_t b0, b1;
                load_b(b0, b1, sdOt, DKV_LDT, dt * 8, kk * 16, g, t);
                mma16816(dVa[dt], pa, b0, b1);
                load_b(b0, b1, sQt, DKV_LDT, dt * 8, kk * 16, g, t);
                mma16816(dKa[dt], dsa, b0, b1);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 2; i++) {
        const size_t r = base + key0 + i * 8;
#pragma unroll
        for (int dt = 0; dt < D / 8; dt++) {
            const int c = dt * 8 + 2 * t;
            *reinterpret_cast<uint32_t*>(dk + r * D + c) =
                pack2(dKa[dt][2 * i], dKa[dt][2 * i + 1]);
            *reinterpret_cast<uint32_t*>(dv + r * D + c) =
                pack2(dVa[dt][2 * i], dVa[dt][2 * i + 1]);
        }
    }
}

// ------------------------------------------------- backward: di and dQ
// grid (L / 64, B*H): one block per 64-row Q tile; each warp owns 16
// rows. The block walks the K/V tiles up to the diagonal; for each it
// recomputes S = Q K^T and dP = dO V^T for the warp's rows
// (s_and_dp), then P = exp(S scale - lse). The di kernel sums P dP a
// row; the dQ kernel accumulates dQ = dS K in registers with
// dS = P (dP - di) scale.

constexpr int DQ_LDT = DQ_BK + 8;
constexpr int DI_SMEM = (2 * DQ_BQ * LDS + 2 * DQ_BK * LDS) * (int)sizeof(bf16);
constexpr int DQ_SMEM = DI_SMEM + D * DQ_LDT * (int)sizeof(bf16);

__device__ __forceinline__ void s_and_dp(float s[DQ_BK / 8][4],
                                         float dp[DQ_BK / 8][4],
                                         const bf16* sQ, const bf16* sdO,
                                         const bf16* sK, const bf16* sV,
                                         int warp, int g, int t) {
#pragma unroll
    for (int nt = 0; nt < DQ_BK / 8; nt++) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; kk++) {
        uint32_t qa[4], da[4];
        load_a(qa, sQ, LDS, warp * 16, kk * 16, g, t);
        load_a(da, sdO, LDS, warp * 16, kk * 16, g, t);
#pragma unroll
        for (int nt = 0; nt < DQ_BK / 8; nt++) {
            uint32_t b0, b1;
            load_b(b0, b1, sK, LDS, nt * 8, kk * 16, g, t);
            mma16816(s[nt], qa, b0, b1);
            load_b(b0, b1, sV, LDS, nt * 8, kk * 16, g, t);
            mma16816(dp[nt], da, b0, b1);
        }
    }
}

__global__ void __launch_bounds__(THREADS)
flash_bwd_di_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ di,
                    int L, float scale) {
    extern __shared__ __align__(16) unsigned char smem[];
    bf16* sQ = reinterpret_cast<bf16*>(smem);       // [64][LDS]
    bf16* sdO = sQ + DQ_BQ * LDS;                   // [64][LDS]
    bf16* sK = sdO + DQ_BQ * LDS;                   // [64][LDS]
    bf16* sV = sK + DQ_BK * LDS;                    // [64][LDS]

    const int qt = gridDim.x - 1 - blockIdx.x;
    const size_t bh = blockIdx.y;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const size_t base = bh * L;
    const int row0 = qt * DQ_BQ + warp * 16 + g;    // rows row0, row0 + 8

    load_rows<DQ_BQ>(sQ, q + (base + (size_t)qt * DQ_BQ) * D);
    load_rows<DQ_BQ>(sdO, dout + (base + (size_t)qt * DQ_BQ) * D);
    const float lr[2] = {lse[base + row0], lse[base + row0 + 8]};
    float acc[2] = {0.f, 0.f};

    for (int kt = 0; kt <= qt * DQ_BQ / DQ_BK; kt++) {
        const size_t r0 = base + (size_t)kt * DQ_BK;
        __syncthreads();
        load_rows<DQ_BK>(sK, k + r0 * D);
        load_rows<DQ_BK>(sV, v + r0 * D);
        __syncthreads();
        float s[DQ_BK / 8][4], dp[DQ_BK / 8][4];
        s_and_dp(s, dp, sQ, sdO, sK, sV, warp, g, t);
#pragma unroll
        for (int nt = 0; nt < DQ_BK / 8; nt++) {
#pragma unroll
            for (int e = 0; e < 4; e++) {
                const int i = e >> 1;
                const int key = kt * DQ_BK + nt * 8 + 2 * t + (e & 1);
                if (key <= row0 + i * 8)
                    acc[i] += __expf(s[nt][e] * scale - lr[i]) * dp[nt][e];
            }
        }
    }
#pragma unroll
    for (int i = 0; i < 2; i++) {
        const float sum = quad_sum(acc[i]);
        if (t == 0) di[base + row0 + i * 8] = sum;
    }
}

__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ di, bf16* __restrict__ dq,
                    int L, float scale) {
    extern __shared__ __align__(16) unsigned char smem[];
    bf16* sQ = reinterpret_cast<bf16*>(smem);       // [64][LDS]
    bf16* sdO = sQ + DQ_BQ * LDS;                   // [64][LDS]
    bf16* sK = sdO + DQ_BQ * LDS;                   // [64][LDS]
    bf16* sV = sK + DQ_BK * LDS;                    // [64][LDS]
    bf16* sKt = sV + DQ_BK * LDS;                   // [128][64 + 8]

    const int qt = gridDim.x - 1 - blockIdx.x;
    const size_t bh = blockIdx.y;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const size_t base = bh * L;
    const int row0 = qt * DQ_BQ + warp * 16 + g;    // rows row0, row0 + 8

    load_rows<DQ_BQ>(sQ, q + (base + (size_t)qt * DQ_BQ) * D);
    load_rows<DQ_BQ>(sdO, dout + (base + (size_t)qt * DQ_BQ) * D);
    const float lr[2] = {lse[base + row0], lse[base + row0 + 8]};
    const float dr[2] = {di[base + row0], di[base + row0 + 8]};

    float dQa[D / 8][4];
#pragma unroll
    for (int i = 0; i < D / 8; i++)
        dQa[i][0] = dQa[i][1] = dQa[i][2] = dQa[i][3] = 0.f;

    for (int kt = 0; kt <= qt * DQ_BQ / DQ_BK; kt++) {
        const size_t r0 = base + (size_t)kt * DQ_BK;
        __syncthreads();
        load_rows<DQ_BK>(sK, k + r0 * D);
        load_rows<DQ_BK>(sV, v + r0 * D);
        load_rows_t<DQ_BK>(sKt, k + r0 * D);
        __syncthreads();

        float s[DQ_BK / 8][4], dp[DQ_BK / 8][4];
        s_and_dp(s, dp, sQ, sdO, sK, sV, warp, g, t);
#pragma unroll
        for (int nt = 0; nt < DQ_BK / 8; nt++) {
#pragma unroll
            for (int e = 0; e < 4; e++) {
                const int i = e >> 1;
                const int row = row0 + i * 8;
                const int key = kt * DQ_BK + nt * 8 + 2 * t + (e & 1);
                const float p = key <= row
                    ? __expf(s[nt][e] * scale - lr[i]) : 0.f;
                dp[nt][e] = p * (dp[nt][e] - dr[i]) * scale;
            }
        }
#pragma unroll
        for (int kk = 0; kk < DQ_BK / 16; kk++) {
            uint32_t dsa[4];
            c_to_a(dsa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
            for (int dt = 0; dt < D / 8; dt++) {
                uint32_t b0, b1;
                load_b(b0, b1, sKt, DQ_LDT, dt * 8, kk * 16, g, t);
                mma16816(dQa[dt], dsa, b0, b1);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 2; i++) {
        bf16* orow = dq + (base + row0 + i * 8) * D;
#pragma unroll
        for (int dt = 0; dt < D / 8; dt++)
            *reinterpret_cast<uint32_t*>(orow + dt * 8 + 2 * t) =
                pack2(dQa[dt][2 * i], dQa[dt][2 * i + 1]);
    }
}

int launch_check(int L, int bh) {
    if (L <= 0 || L % 64 != 0 || bh <= 0 || bh > 65535)
        return (int)cudaErrorInvalidValue;
    return 0;
}

}  // namespace

extern "C" {

// Each returns 0 or the CUDA error of the launch. Pointers are device
// pointers; `stream` is a cudaStream_t. Nothing here synchronises.

int cv_flash_fwd(const void* q, const void* k, const void* v, void* o,
                 void* lse, int bh, int L, float scale, void* stream) {
    int rc = launch_check(L, bh);
    if (rc) return rc;
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        FWD_SMEM);
    if (e != cudaSuccess) return (int)e;
    flash_fwd_kernel<<<dim3(L / FWD_BQ, bh), THREADS, FWD_SMEM,
                       (cudaStream_t)stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o,
        (float*)lse, L, scale);
    return (int)cudaGetLastError();
}

int cv_flash_bwd_di(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, void* di, int bh,
                    int L, float scale, void* stream) {
    int rc = launch_check(L, bh);
    if (rc) return rc;
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_di_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        DI_SMEM);
    if (e != cudaSuccess) return (int)e;
    flash_bwd_di_kernel<<<dim3(L / DQ_BQ, bh), THREADS, DI_SMEM,
                          (cudaStream_t)stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
        (const float*)lse, (float*)di, L, scale);
    return (int)cudaGetLastError();
}

int cv_flash_bwd_dkv(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* di,
                     void* dk, void* dv, int bh, int L, float scale,
                     void* stream) {
    int rc = launch_check(L, bh);
    if (rc) return rc;
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        DKV_SMEM);
    if (e != cudaSuccess) return (int)e;
    flash_bwd_dkv_kernel<<<dim3(L / DKV_BK, bh), THREADS, DKV_SMEM,
                           (cudaStream_t)stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
        (const float*)lse, (const float*)di, (bf16*)dk, (bf16*)dv, L, scale);
    return (int)cudaGetLastError();
}

int cv_flash_bwd_dq(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* di,
                    void* dq, int bh, int L, float scale, void* stream) {
    int rc = launch_check(L, bh);
    if (rc) return rc;
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        DQ_SMEM);
    if (e != cudaSuccess) return (int)e;
    flash_bwd_dq_kernel<<<dim3(L / DQ_BQ, bh), THREADS, DQ_SMEM,
                          (cudaStream_t)stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
        (const float*)lse, (const float*)di, (bf16*)dq, L, scale);
    return (int)cudaGetLastError();
}

}  // extern "C"
