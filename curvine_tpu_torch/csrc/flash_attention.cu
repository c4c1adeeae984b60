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
// holds each layer's dQ, dK and dV against f64 dense attention there.
//
// Numerics follow the library kernel: S = Q K^T accumulates in f32 and
// is scaled by sm_scale; P is rounded to bf16 before P V (forward) and
// before dV = P^T dO; dS = P (dP - di) sm_scale is rounded to bf16
// before dK = dS^T Q and dQ = dS K. Masked scores get -inf in the
// forward (the diagonal of a causal row is always visible, so every row
// has a finite maximum) and P = 0 in the backward. The forward and dK/dV
// take exp as ex2 of the score scaled by sm_scale * log2(e).
//
// What bounds them: at the flagship's shape ([16*20, 1024, 128]) the
// forward does 8.6e10 causal FLOP over 336 MB of q, k, v and o (0.087 ms
// of tensor-core time against 0.100 ms of bytes at 3.35 TB/s); the
// dK/dV and dQ kernels recompute S and do 1.3-1.7e11 FLOP over 419-503
// MB, so they are bound by operations; the di kernel does the forward's
// FLOP over its bytes, bound by bytes. Either way the tensor cores must
// not wait, and on Hopper only wgmma reaches their full rate.
//
// All four kernels are built for that (hopper.cuh):
// - one producer warpgroup (its registers lowered with setmaxnreg) issues
//   TMA loads of 128-byte-swizzled tiles into a ring of three stages
//   (four for di and dQ) guarded by full and empty mbarriers, so loads
//   run ahead of the products;
// - two consumer warpgroups (registers raised to 240) each own 64 rows
//   and run every product as wgmma: S and dP with both operands in shared
//   memory, P V, P^T dO, dS^T Q and dS K with P or dS rounded to bf16 in
//   registers as the A operand (the accumulator layout of S is the A
//   fragment layout), and the other operand read in its natural [row][d]
//   order through the transpose bit, so no transposed copy is made;
// - the forward issues the next tile's S = Q K^T and this tile's P V
//   back to back and runs the next tile's softmax while P V is in
//   flight;
// - the blocks of one head run together, longest walk first (the last
//   query tile for the forward, di and dQ; dK/dV's first key tile): the
//   head's K and V (or Q and dO), read by each of its blocks, stay in L2.
//   Ordering all heads' longest walks first instead made every block
//   read them from device memory, 12% slower for the forward.
// Forward: one block per 128-row Q tile, 128-key tiles (only the diagonal
// tile is masked). dK/dV: one block per 128-key tile walking the 64-row
// Q tiles from the diagonal on; a consumer skips a tile wholly above its
// keys. di and dQ: one kernel template, one block per 128-row Q tile
// walking 64-key tiles up to the diagonal (dQ's 64 x 128 accumulator
// leaves no registers for 128-key S and dP). No atomics: each output is
// written once and the result is deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = 128;          // head_dim

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// A wgmma accumulator of N columns holds, for each warp's 16 rows
// (g = lane / 4, t = lane % 4), N / 8 fragments of 8 columns in order:
// c[4j], c[4j+1] at row g, columns 8j + 2t and 8j + 2t + 1, and c[4j+2],
// c[4j+3] at row g + 8. A wgmma A operand in registers holds, for each
// warp's 16 rows and 16 columns of k: a0 (g, 2t..2t+1), a1 (g+8, 2t..),
// a2 (g, 2t+8..), a3 (g+8, 2t+8..), four neighbouring accumulator pairs.

__device__ __forceinline__ float quad_max(float x) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ----------------------------------------------- Hopper kernels: common

constexpr int HOP_THREADS = 384;     // producer + two consumer warpgroups
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
// setmaxnreg moves registers within the block's allocation at launch
// (168 a thread at 384 threads): a consumer that asks for more than the
// producer gave up waits for ever.
static_assert(128 * PRODUCER_REGS + 256 * CONSUMER_REGS <= 168 * HOP_THREADS,
              "register budget");
constexpr int BOX_ROW = 128;         // bytes of a box row: 64 bf16
constexpr int HALF_D = 64;           // columns of a box
constexpr int KT = 128;              // rows of a K/V tile, both kernels
constexpr int KV_BYTES = KT * D * 2;             // 32 KB, two boxes
constexpr int SBO = 8 * BOX_ROW;                 // 1024: next 8 rows
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
    return p + ((1024 - (hopper::smem_addr(p) & 1023)) & 1023);
}

// A row tile of `rows` x 128 bf16 at `row` of the map: two boxes of 64
// columns, one after the other in shared memory.
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const CUtensorMap* map,
                                          uint64_t* bar, int row, int rows) {
    hopper::tma_load_2d(dst, map, bar, 0, row);
    hopper::tma_load_2d(dst + rows * BOX_ROW, map, bar, HALF_D, row);
}

// Descriptors of a K-major tile at shared address `a` (two boxes of 64
// columns) and of an MN-major one of `rows` rows (the reduction runs
// down the rows; 128 columns in two boxes).
__device__ __forceinline__ uint64_t kdesc(uint32_t a) {
    return hopper::desc(a, 16, SBO);
}

__device__ __forceinline__ uint64_t mndesc(uint32_t a, int rows) {
    return hopper::desc(a, rows * BOX_ROW, SBO);
}

// The k-th 16-wide step of the reduction: 32 bytes along a K-major row
// (the fifth step is the next box of a `rows`-row tile), 16 rows down an
// MN-major tile. The start address is the descriptor's low field.
__device__ __forceinline__ uint64_t kstep(uint64_t d, int rows, int k) {
    return d + (uint64_t)(((k >> 2) * rows * BOX_ROW + (k & 3) * 32) >> 4);
}

__device__ __forceinline__ uint64_t mnstep(uint64_t d, int k) {
    return d + (uint64_t)((k * 16 * BOX_ROW) >> 4);
}

// Round 16 columns (k-step kk) of a wgmma accumulator to a bf16 A operand.
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float (&c)[N],
                                         int kk) {
    a[0] = pack2(c[8 * kk], c[8 * kk + 1]);
    a[1] = pack2(c[8 * kk + 2], c[8 * kk + 3]);
    a[2] = pack2(c[8 * kk + 4], c[8 * kk + 5]);
    a[3] = pack2(c[8 * kk + 6], c[8 * kk + 7]);
}

// ------------------------------------------------------------- forward
// grid (L / 128, B*H): one block per 128-row Q tile, a head's last Q
// tile (the longest walk) first. The producer loads Q once and then K
// and V tile by tile, up to the diagonal, into the ring; each consumer
// owns 64 query rows and keeps its O accumulator (64 x 128 f32) and the
// online softmax's m and l in registers.

constexpr int FWD_STAGES = 3;
constexpr int FWD_Q = 0;                              // 32 KB
constexpr int FWD_KV = KV_BYTES;                      // stage s: K, then V
constexpr int FWD_STAGE = 2 * KV_BYTES;               // 64 KB
constexpr int FWD_BAR = FWD_KV + FWD_STAGES * FWD_STAGE;
constexpr int FWD_SMEM = FWD_BAR + 8 * (1 + 2 * FWD_STAGES) + 1024;

__global__ void __launch_bounds__(HOP_THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap mq,
                 const __grid_constant__ CUtensorMap mk,
                 const __grid_constant__ CUtensorMap mv,
                 bf16* __restrict__ o, float* __restrict__ lse, int L,
                 float scale_log2) {
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    unsigned char* sm = align1024(smem_raw);
    uint64_t* qfull = reinterpret_cast<uint64_t*>(sm + FWD_BAR);
    uint64_t* full = qfull + 1;                   // [FWD_STAGES]
    uint64_t* empty = full + FWD_STAGES;          // [FWD_STAGES]

    const int qt = gridDim.x - 1 - blockIdx.x;
    const int base = blockIdx.y * L;     // first row of the head
    const int wg = threadIdx.x / 128;

    if (threadIdx.x == 0) {
        hopper::mbar_init(qfull, 1);
        for (int s = 0; s < FWD_STAGES; s++) {
            hopper::mbar_init(&full[s], 1);
            hopper::mbar_init(&empty[s], 8);      // one arrival a warp
        }
        hopper::mbar_fence_init();
    }
    __syncthreads();

    if (wg == 0) {
        // ------------------------------------------------ producer
        hopper::regs_dec<PRODUCER_REGS>();
        if (threadIdx.x == 0) {
            hopper::mbar_expect_tx(qfull, KV_BYTES);
            load_tile(sm + FWD_Q, &mq, qfull, base + qt * KT, KT);
            for (int kt = 0; kt <= qt; kt++) {
                const int s = kt % FWD_STAGES;
                hopper::mbar_wait(&empty[s], ((kt / FWD_STAGES) & 1) ^ 1);
                hopper::mbar_expect_tx(&full[s], 2 * KV_BYTES);
                unsigned char* st = sm + FWD_KV + s * FWD_STAGE;
                load_tile(st, &mk, &full[s], base + kt * KT, KT);
                load_tile(st + KV_BYTES, &mv, &full[s], base + kt * KT, KT);
            }
        }
        return;
    }

    // ----------------------------------------------------- consumers
    hopper::regs_inc<CONSUMER_REGS>();
    const int c = wg - 1;
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int row0 = qt * KT + c * 64 + warp * 16 + g;   // and row0 + 8
    // this consumer's 64 rows of Q: 8 KB into each box
    const uint64_t qd =
        kdesc(hopper::smem_addr(sm + FWD_Q) + c * 64 * BOX_ROW);
    const uint32_t kv_addr = hopper::smem_addr(sm + FWD_KV);

    float acc[64], s[64];
#pragma unroll
    for (int i = 0; i < 64; i++) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    uint32_t p[8][4];

    // Online softmax of the S of key tile kt (in s), in the log2 domain:
    // s becomes P, m and l move on, alpha is O's rescale. The mask on the
    // diagonal tile only, the row maximum taken on the raw scores
    // (sm_scale > 0 keeps their order, the wrapper checks), then
    // P = 2^(S scale log2(e) - m) with one FMA an element.
    float alpha[2];
    auto softmax = [&](int kt) {
        float mx[2] = {-INFINITY, -INFINITY};
        if (kt == qt) {
#pragma unroll
            for (int j = 0; j < 16; j++) {
#pragma unroll
                for (int e = 0; e < 4; e++) {
                    const int r = row0 + (e >> 1) * 8;
                    const int col = kt * KT + j * 8 + 2 * t + (e & 1);
                    if (col > r) s[4 * j + e] = -INFINITY;
                }
            }
        }
#pragma unroll
        for (int j = 0; j < 16; j++) {
#pragma unroll
            for (int e = 0; e < 4; e++)
                mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
        }
#pragma unroll
        for (int i = 0; i < 2; i++) {
            mx[i] = fmaxf(m[i], quad_max(mx[i]) * scale_log2);
            alpha[i] = ex2(m[i] - mx[i]);
            m[i] = mx[i];
            l[i] *= alpha[i];
        }
#pragma unroll
        for (int j = 0; j < 16; j++) {
#pragma unroll
            for (int e = 0; e < 4; e++) {
                const float pv =
                    ex2(fmaf(s[4 * j + e], scale_log2, -m[e >> 1]));
                s[4 * j + e] = pv;
                l[e >> 1] += pv;
            }
        }
    };

    // S and P of the first tile
    hopper::mbar_wait(qfull, 0);
    hopper::mbar_wait(&full[0], 0);
    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; kk++)
        hopper::wgmma_128_ss<0>(s, kstep(qd, KT, kk),
                                kstep(kdesc(kv_addr), KT, kk), kk);
    hopper::wg_commit();
    hopper::wg_wait<0>();
    hopper::wg_hold(s);
    softmax(0);
#pragma unroll
    for (int kk = 0; kk < KT / 16; kk++) acc_to_a(p[kk], s, kk);

    // Each step issues the next tile's S = Q K^T and this tile's O += P V
    // back to back, runs the next softmax while P V is in flight, then
    // rescales O. The last tile's P V is peeled off the loop: with the S
    // under a condition inside it, ptxas serialised the warpgroup's
    // wgmmas (warning C7514).
    for (int kt = 0; kt < qt; kt++) {
        const int st = kt % FWD_STAGES, sn = (kt + 1) % FWD_STAGES;
        hopper::mbar_wait(&full[sn], ((kt + 1) / FWD_STAGES) & 1);
        const uint64_t kd = kdesc(kv_addr + sn * FWD_STAGE);
        const uint64_t vd = mndesc(kv_addr + st * FWD_STAGE + KV_BYTES, KT);
        hopper::wg_hold(acc);
        hopper::wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; kk++)
            hopper::wgmma_128_ss<0>(s, kstep(qd, KT, kk), kstep(kd, KT, kk),
                                    kk);
        hopper::wg_commit();
#pragma unroll
        for (int kk = 0; kk < KT / 16; kk++)
            hopper::wgmma_128_rs<1>(acc, p[kk], mnstep(vd, kk));
        hopper::wg_commit();
        hopper::wg_wait<1>();
        hopper::wg_hold(s);
        softmax(kt + 1);
        hopper::wg_wait<0>();
        hopper::wg_keep(p);
        hopper::wg_hold(acc);
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[st]);
#pragma unroll
        for (int j = 0; j < 16; j++) {
#pragma unroll
            for (int e = 0; e < 4; e++) acc[4 * j + e] *= alpha[e >> 1];
        }
#pragma unroll
        for (int kk = 0; kk < KT / 16; kk++) acc_to_a(p[kk], s, kk);
    }
    {
        const int st = qt % FWD_STAGES;
        const uint64_t vd = mndesc(kv_addr + st * FWD_STAGE + KV_BYTES, KT);
        hopper::wg_hold(acc);
        hopper::wg_fence();
#pragma unroll
        for (int kk = 0; kk < KT / 16; kk++)
            hopper::wgmma_128_rs<1>(acc, p[kk], mnstep(vd, kk));
        hopper::wg_commit();
        hopper::wg_wait<0>();
        hopper::wg_keep(p);
        hopper::wg_hold(acc);
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[st]);
    }

#pragma unroll
    for (int i = 0; i < 2; i++) {
        const float li = quad_sum(l[i]);
        const float inv = 1.f / li;
        const size_t r = (size_t)base + row0 + i * 8;
        bf16* orow = o + r * D;
#pragma unroll
        for (int j = 0; j < 16; j++)
            *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * t) =
                pack2(acc[4 * j + 2 * i] * inv, acc[4 * j + 2 * i + 1] * inv);
        if (t == 0) lse[r] = m[i] * LN2 + logf(li);
    }
}

// ----------------------------------------------------- backward: dK, dV
// grid (L / 128, B*H): one block per 128-key tile, a head's key tile 0
// (the longest walk) first. The producer loads K and V once and then, into the
// ring, each 64-row Q tile from the diagonal to the end with its dO, lse
// and di. Each consumer owns 64 keys and accumulates dV = P^T dO and
// dK = dS^T Q (64 x 128 f32 each) in registers, with
// P^T = exp(K Q^T scale - lse) and dS^T = P^T (V dO^T - di) scale.

constexpr int DKV_STAGES = 3;
constexpr int BQ = 64;            // Q rows a stage: S^T, dP^T are m64n64
constexpr int Q_BYTES = BQ * D * 2;                   // 16 KB
constexpr int DKV_K = 0, DKV_V = KV_BYTES;            // 32 KB each
constexpr int DKV_Q = 2 * KV_BYTES;                   // stage s: Q, dO
constexpr int DKV_STAGE = 2 * Q_BYTES;                // 32 KB
constexpr int DKV_ROWS = DKV_Q + DKV_STAGES * DKV_STAGE;   // s: lse, di
constexpr int DKV_BAR = DKV_ROWS + DKV_STAGES * 2 * BQ * 4;
constexpr int DKV_SMEM = DKV_BAR + 8 * (1 + 2 * DKV_STAGES) + 1024;
constexpr uint32_t DKV_TX = 2 * Q_BYTES + 2 * BQ * 4;

__global__ void __launch_bounds__(HOP_THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap mq,
                     const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mv,
                     const __grid_constant__ CUtensorMap mdo,
                     const float* __restrict__ lse,
                     const float* __restrict__ di, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int L, float scale,
                     float scale_log2) {
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    unsigned char* sm = align1024(smem_raw);
    uint64_t* kvfull = reinterpret_cast<uint64_t*>(sm + DKV_BAR);
    uint64_t* full = kvfull + 1;                  // [DKV_STAGES]
    uint64_t* empty = full + DKV_STAGES;          // [DKV_STAGES]
    float* rows = reinterpret_cast<float*>(sm + DKV_ROWS);   // [s][lse, di]

    const int kt = blockIdx.x;
    const int base = blockIdx.y * L;
    const int wg = threadIdx.x / 128;
    const int qt0 = kt * KT / BQ, n_qt = L / BQ - qt0;

    if (threadIdx.x == 0) {
        hopper::mbar_init(kvfull, 1);
        for (int s = 0; s < DKV_STAGES; s++) {
            hopper::mbar_init(&full[s], 1);
            hopper::mbar_init(&empty[s], 8);
        }
        hopper::mbar_fence_init();
    }
    __syncthreads();

    if (wg == 0) {
        // ------------------------------------------------ producer
        hopper::regs_dec<PRODUCER_REGS>();
        if (threadIdx.x == 0) {
            hopper::mbar_expect_tx(kvfull, 2 * KV_BYTES);
            load_tile(sm + DKV_K, &mk, kvfull, base + kt * KT, KT);
            load_tile(sm + DKV_V, &mv, kvfull, base + kt * KT, KT);
            for (int i = 0; i < n_qt; i++) {
                const int s = i % DKV_STAGES;
                const int r = base + (qt0 + i) * BQ;
                hopper::mbar_wait(&empty[s], ((i / DKV_STAGES) & 1) ^ 1);
                hopper::mbar_expect_tx(&full[s], DKV_TX);
                unsigned char* st = sm + DKV_Q + s * DKV_STAGE;
                load_tile(st, &mq, &full[s], r, BQ);
                load_tile(st + Q_BYTES, &mdo, &full[s], r, BQ);
                hopper::bulk_load(rows + s * 2 * BQ, lse + r, BQ * 4,
                                  &full[s]);
                hopper::bulk_load(rows + s * 2 * BQ + BQ, di + r, BQ * 4,
                                  &full[s]);
            }
        }
        return;
    }

    // ----------------------------------------------------- consumers
    hopper::regs_inc<CONSUMER_REGS>();
    const int c = wg - 1;
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int key_lo = kt * KT + c * 64;                 // this consumer's
    const int key0 = key_lo + warp * 16 + g;             // and key0 + 8
    const uint64_t kd0 =
        kdesc(hopper::smem_addr(sm + DKV_K) + c * 64 * BOX_ROW);
    const uint64_t vd0 =
        kdesc(hopper::smem_addr(sm + DKV_V) + c * 64 * BOX_ROW);
    const uint32_t q_base = hopper::smem_addr(sm + DKV_Q);

    float dK[64], dV[64];
#pragma unroll
    for (int i = 0; i < 64; i++) dK[i] = dV[i] = 0.f;

    hopper::mbar_wait(kvfull, 0);
    for (int i = 0; i < n_qt; i++) {
        const int st = i % DKV_STAGES;
        const int qt = qt0 + i;
        hopper::mbar_wait(&full[st], (i / DKV_STAGES) & 1);
        if (qt * BQ + BQ - 1 >= key_lo) {        // else wholly masked
            const uint32_t q_addr = q_base + st * DKV_STAGE;
            const uint32_t do_addr = q_addr + Q_BYTES;
            const uint64_t qd = kdesc(q_addr), dod = kdesc(do_addr);
            float s[BQ / 2], dp[BQ / 2];
            hopper::wg_fence();
#pragma unroll
            for (int kk = 0; kk < D / 16; kk++)
                hopper::wgmma_64_ss(s, kstep(kd0, KT, kk), kstep(qd, BQ, kk),
                                    kk);
            hopper::wg_commit();
#pragma unroll
            for (int kk = 0; kk < D / 16; kk++)
                hopper::wgmma_64_ss(dp, kstep(vd0, KT, kk),
                                    kstep(dod, BQ, kk), kk);
            hopper::wg_commit();

            hopper::wg_wait<0>();
            hopper::wg_hold(s);
            hopper::wg_hold(dp);
            const float* sl = rows + st * 2 * BQ;
            const float* sd = sl + BQ;
            if (qt * BQ < key_lo + 63) {     // a query row before a key
#pragma unroll
                for (int j = 0; j < BQ / 8; j++) {
#pragma unroll
                    for (int e = 0; e < 4; e++) {
                        const int key = key0 + (e >> 1) * 8;
                        const int row = qt * BQ + j * 8 + 2 * t + (e & 1);
                        if (row < key) s[4 * j + e] = -INFINITY;
                    }
                }
            }
#pragma unroll
            for (int j = 0; j < BQ / 8; j++) {
                const int cq = j * 8 + 2 * t;
                const float2 lv = *reinterpret_cast<const float2*>(sl + cq);
                const float2 dv2 = *reinterpret_cast<const float2*>(sd + cq);
                const float l2[2] = {lv.x * LOG2E, lv.y * LOG2E};
                const float dd[2] = {dv2.x, dv2.y};
#pragma unroll
                for (int e = 0; e < 4; e++) {
                    const float pv =
                        ex2(fmaf(s[4 * j + e], scale_log2, -l2[e & 1]));
                    s[4 * j + e] = pv;
                    dp[4 * j + e] = pv * (dp[4 * j + e] - dd[e & 1]) * scale;
                }
            }
            uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
#pragma unroll
            for (int kk = 0; kk < BQ / 16; kk++) {
                acc_to_a(pa[kk], s, kk);
                acc_to_a(dsa[kk], dp, kk);
            }
            hopper::wg_hold(dV);
            hopper::wg_hold(dK);
            hopper::wg_fence();
#pragma unroll
            for (int kk = 0; kk < BQ / 16; kk++)
                hopper::wgmma_128_rs<1>(dV, pa[kk],
                                        mnstep(mndesc(do_addr, BQ), kk));
#pragma unroll
            for (int kk = 0; kk < BQ / 16; kk++)
                hopper::wgmma_128_rs<1>(dK, dsa[kk],
                                        mnstep(mndesc(q_addr, BQ), kk));
            hopper::wg_commit();
            hopper::wg_wait<0>();
            hopper::wg_keep(pa);
            hopper::wg_keep(dsa);
            hopper::wg_hold(dV);
            hopper::wg_hold(dK);
        }
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[st]);
    }

#pragma unroll
    for (int i = 0; i < 2; i++) {
        const size_t r = (size_t)base + key0 + i * 8;
#pragma unroll
        for (int j = 0; j < 16; j++) {
            const int col = j * 8 + 2 * t;
            *reinterpret_cast<uint32_t*>(dk + r * D + col) =
                pack2(dK[4 * j + 2 * i], dK[4 * j + 2 * i + 1]);
            *reinterpret_cast<uint32_t*>(dv + r * D + col) =
                pack2(dV[4 * j + 2 * i], dV[4 * j + 2 * i + 1]);
        }
    }
}

// ------------------------------------------------- backward: di and dQ
// grid (L / 128, B*H): one block per 128-row Q tile, a head's last Q
// tile (the longest walk) first. The producer loads the tile's Q and dO
// once, with its lse rows (and di rows, for dQ), and then K and V, 64
// keys a tile, up to the diagonal, into the ring. Each consumer owns 64
// query rows and recomputes S = Q K^T and dP = dO V^T (m64n64, both
// operands in shared memory), then P = 2^(S scale log2(e) - lse log2(e)),
// as dK/dV does, and P = 0 above the diagonal, which only the tile
// crossing the consumer's diagonal, its last, needs. di (kDq false) sums
// P dP a row in f32. dQ (kDq true) accumulates dQ += dS K (64 x 128 f32
// in registers), dS = P (dP - di) scale rounded to bf16 as the A operand
// and K's tile read MN-major; with 128-key S and dP beside that
// accumulator the registers would not do. Consumer 0's rows end where
// tile 2 qt + 1 begins: it skips that tile but still releases its
// stage, or the ring would stop.

// Four stages: di ran 0.6-2.4% faster than with three on the card, dQ
// as fast (scripts/flash_variants.py).
constexpr int QB_STAGES = 4;
constexpr int BK = 64;                                // keys a tile
constexpr int QB_Q = 0, QB_DO = KV_BYTES;             // 128 rows, 32 KB
constexpr int QB_KV = 2 * KV_BYTES;                   // stage s: K, then V
constexpr int QB_STAGE = 2 * Q_BYTES;                 // 32 KB
constexpr int QB_ROWS = QB_KV + QB_STAGES * QB_STAGE;      // lse, di
constexpr int QB_BAR = QB_ROWS + 2 * KT * 4;
constexpr int QB_SMEM = QB_BAR + 8 * (1 + 2 * QB_STAGES) + 1024;
static_assert(BK * D * 2 == Q_BYTES, "a K or V tile is one Q tile's size");

template <bool kDq>
__global__ void __launch_bounds__(HOP_THREADS, 1)
flash_bwd_q_kernel(const __grid_constant__ CUtensorMap mq,
                   const __grid_constant__ CUtensorMap mk,
                   const __grid_constant__ CUtensorMap mv,
                   const __grid_constant__ CUtensorMap mdo,
                   const float* __restrict__ lse,
                   float* __restrict__ di,        // written by di, read by dQ
                   bf16* __restrict__ dq, int L, float scale,
                   float scale_log2) {
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    unsigned char* sm = align1024(smem_raw);
    uint64_t* qfull = reinterpret_cast<uint64_t*>(sm + QB_BAR);
    uint64_t* full = qfull + 1;                   // [QB_STAGES]
    uint64_t* empty = full + QB_STAGES;           // [QB_STAGES]
    float* rows = reinterpret_cast<float*>(sm + QB_ROWS);   // lse, di

    const int qt = gridDim.x - 1 - blockIdx.x;
    const int base = blockIdx.y * L;
    const int wg = threadIdx.x / 128;

    if (threadIdx.x == 0) {
        hopper::mbar_init(qfull, 1);
        for (int s = 0; s < QB_STAGES; s++) {
            hopper::mbar_init(&full[s], 1);
            hopper::mbar_init(&empty[s], 8);      // one arrival a warp
        }
        hopper::mbar_fence_init();
    }
    __syncthreads();

    if (wg == 0) {
        // ------------------------------------------------ producer
        hopper::regs_dec<PRODUCER_REGS>();
        if (threadIdx.x == 0) {
            const int r = base + qt * KT;
            hopper::mbar_expect_tx(qfull,
                                   2 * KV_BYTES + (kDq ? 2 : 1) * KT * 4);
            load_tile(sm + QB_Q, &mq, qfull, r, KT);
            load_tile(sm + QB_DO, &mdo, qfull, r, KT);
            hopper::bulk_load(rows, lse + r, KT * 4, qfull);
            if (kDq) hopper::bulk_load(rows + KT, di + r, KT * 4, qfull);
            for (int kt = 0; kt < 2 * qt + 2; kt++) {
                const int s = kt % QB_STAGES;
                hopper::mbar_wait(&empty[s], ((kt / QB_STAGES) & 1) ^ 1);
                hopper::mbar_expect_tx(&full[s], QB_STAGE);
                unsigned char* st = sm + QB_KV + s * QB_STAGE;
                load_tile(st, &mk, &full[s], base + kt * BK, BK);
                load_tile(st + Q_BYTES, &mv, &full[s], base + kt * BK, BK);
            }
        }
        return;
    }

    // ----------------------------------------------------- consumers
    hopper::regs_inc<CONSUMER_REGS>();
    const int c = wg - 1;
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int lrow = c * 64 + warp * 16 + g;         // in the tile, and + 8
    const int row0 = qt * KT + lrow;
    // this consumer's 64 rows of Q and dO: 8 KB into each box
    const uint64_t qd =
        kdesc(hopper::smem_addr(sm + QB_Q) + c * 64 * BOX_ROW);
    const uint64_t dod =
        kdesc(hopper::smem_addr(sm + QB_DO) + c * 64 * BOX_ROW);
    const uint32_t kv_addr = hopper::smem_addr(sm + QB_KV);

    hopper::mbar_wait(qfull, 0);
    float l2[2], dr[2], acc[kDq ? 64 : 2];
#pragma unroll
    for (int i = 0; i < 2; i++) {
        l2[i] = rows[lrow + i * 8] * LOG2E;
        dr[i] = kDq ? rows[KT + lrow + i * 8] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < (kDq ? 64 : 2); i++) acc[i] = 0.f;

    // up to the tile that holds this consumer's last row (written so, the
    // dQ kernel ran 5-10% faster on the card than with the equal
    // n_kt = 2 qt + 1 + c: scripts/flash_variants.py)
    const int n_kt = (qt * KT + c * 64 + 63) / BK + 1;
    for (int kt = 0; kt < n_kt; kt++) {
        const int st = kt % QB_STAGES;
        const uint32_t k_addr = kv_addr + st * QB_STAGE;
        const uint64_t kd = kdesc(k_addr), vd = kdesc(k_addr + Q_BYTES);
        hopper::mbar_wait(&full[st], (kt / QB_STAGES) & 1);
        float s[BK / 2], dp[BK / 2];
        hopper::wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; kk++)
            hopper::wgmma_64_ss(s, kstep(qd, KT, kk), kstep(kd, BK, kk), kk);
        hopper::wg_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; kk++)
            hopper::wgmma_64_ss(dp, kstep(dod, KT, kk), kstep(vd, BK, kk),
                                kk);
        hopper::wg_commit();
        hopper::wg_wait<0>();
        hopper::wg_hold(s);
        hopper::wg_hold(dp);

#pragma unroll
        for (int j = 0; j < BK / 8; j++) {
#pragma unroll
            for (int e = 0; e < 4; e++)
                s[4 * j + e] =
                    ex2(fmaf(s[4 * j + e], scale_log2, -l2[e >> 1]));
        }
        if (kt == n_kt - 1) {                     // the diagonal tile
#pragma unroll
            for (int j = 0; j < BK / 8; j++) {
#pragma unroll
                for (int e = 0; e < 4; e++) {
                    const int key = kt * BK + j * 8 + 2 * t + (e & 1);
                    if (key > row0 + (e >> 1) * 8) s[4 * j + e] = 0.f;
                }
            }
        }
        if constexpr (kDq) {
#pragma unroll
            for (int j = 0; j < BK / 8; j++) {
#pragma unroll
                for (int e = 0; e < 4; e++)
                    dp[4 * j + e] =
                        s[4 * j + e] * (dp[4 * j + e] - dr[e >> 1]) * scale;
            }
            uint32_t dsa[BK / 16][4];
#pragma unroll
            for (int kk = 0; kk < BK / 16; kk++) acc_to_a(dsa[kk], dp, kk);
            hopper::wg_hold(acc);
            hopper::wg_fence();
#pragma unroll
            for (int kk = 0; kk < BK / 16; kk++)
                hopper::wgmma_128_rs<1>(acc, dsa[kk],
                                        mnstep(mndesc(k_addr, BK), kk));
            hopper::wg_commit();
            hopper::wg_wait<0>();
            hopper::wg_keep(dsa);
            hopper::wg_hold(acc);
        } else {
#pragma unroll
            for (int j = 0; j < BK / 8; j++) {
#pragma unroll
                for (int e = 0; e < 4; e++)
                    acc[e >> 1] += s[4 * j + e] * dp[4 * j + e];
            }
        }
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[st]);
    }
    if (n_kt < 2 * qt + 2) {    // tile 2 qt + 1, wholly above its rows
        const int st = n_kt % QB_STAGES;
        hopper::mbar_wait(&full[st], (n_kt / QB_STAGES) & 1);
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[st]);
    }

#pragma unroll
    for (int i = 0; i < 2; i++) {
        const size_t r = (size_t)base + row0 + i * 8;
        if constexpr (kDq) {
#pragma unroll
            for (int j = 0; j < 16; j++)
                *reinterpret_cast<uint32_t*>(dq + r * D + j * 8 + 2 * t) =
                    pack2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
        } else {
            const float sum = quad_sum(acc[i]);
            if (t == 0) di[r] = sum;
        }
    }
}

// B*H*L rows of 128 bf16: each operand is one 2-D map of boxes of 64
// columns, rows addressed as int in the kernels and the maps.
int hop_check(int L, int bh) {
    if (L <= 0 || L % KT != 0 || bh <= 0 || bh > 65535
        || (long long)bh * L > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    return 0;
}

template <bool kDq>
int launch_bwd_q(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, void* di, void* dq,
                 int bh, int L, float scale, void* stream) {
    int rc = hop_check(L, bh);
    if (rc) return rc;
    const uint64_t rows = (uint64_t)bh * L;
    CUtensorMap mq, mk, mv, mdo;
    if ((rc = hopper::bf16_map(&mq, q, rows, D, KT))) return rc;
    if ((rc = hopper::bf16_map(&mk, k, rows, D, BK))) return rc;
    if ((rc = hopper::bf16_map(&mv, v, rows, D, BK))) return rc;
    if ((rc = hopper::bf16_map(&mdo, dout, rows, D, KT))) return rc;
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_q_kernel<kDq>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        QB_SMEM);
    if (e != cudaSuccess) return (int)e;
    flash_bwd_q_kernel<kDq><<<dim3(L / KT, bh), HOP_THREADS, QB_SMEM,
                              (cudaStream_t)stream>>>(
        mq, mk, mv, mdo, (const float*)lse, (float*)di, (bf16*)dq, L, scale,
        scale * LOG2E);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns 0 or the CUDA error of the launch. Pointers are device
// pointers; `stream` is a cudaStream_t. Nothing here synchronises. Each
// launcher encodes its TMA maps for the call's pointers (16-byte aligned;
// the wrapper checks).

int cv_flash_fwd(const void* q, const void* k, const void* v, void* o,
                 void* lse, int bh, int L, float scale, void* stream) {
    int rc = hop_check(L, bh);
    if (rc) return rc;
    const uint64_t rows = (uint64_t)bh * L;
    CUtensorMap mq, mk, mv;
    if ((rc = hopper::bf16_map(&mq, q, rows, D, KT))) return rc;
    if ((rc = hopper::bf16_map(&mk, k, rows, D, KT))) return rc;
    if ((rc = hopper::bf16_map(&mv, v, rows, D, KT))) return rc;
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        FWD_SMEM);
    if (e != cudaSuccess) return (int)e;
    flash_fwd_kernel<<<dim3(L / KT, bh), HOP_THREADS, FWD_SMEM,
                       (cudaStream_t)stream>>>(
        mq, mk, mv, (bf16*)o, (float*)lse, L, scale * LOG2E);
    return (int)cudaGetLastError();
}

int cv_flash_bwd_di(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, void* di, int bh,
                    int L, float scale, void* stream) {
    return launch_bwd_q<false>(q, k, v, dout, lse, di, nullptr, bh, L, scale,
                               stream);
}

int cv_flash_bwd_dkv(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* di,
                     void* dk, void* dv, int bh, int L, float scale,
                     void* stream) {
    int rc = hop_check(L, bh);
    if (rc) return rc;
    const uint64_t rows = (uint64_t)bh * L;
    CUtensorMap mq, mk, mv, mdo;
    if ((rc = hopper::bf16_map(&mq, q, rows, D, BQ))) return rc;
    if ((rc = hopper::bf16_map(&mk, k, rows, D, KT))) return rc;
    if ((rc = hopper::bf16_map(&mv, v, rows, D, KT))) return rc;
    if ((rc = hopper::bf16_map(&mdo, dout, rows, D, BQ))) return rc;
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        DKV_SMEM);
    if (e != cudaSuccess) return (int)e;
    flash_bwd_dkv_kernel<<<dim3(L / KT, bh), HOP_THREADS, DKV_SMEM,
                           (cudaStream_t)stream>>>(
        mq, mk, mv, mdo, (const float*)lse, (const float*)di, (bf16*)dk,
        (bf16*)dv, L, scale, scale * LOG2E);
    return (int)cudaGetLastError();
}

int cv_flash_bwd_dq(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* di,
                    void* dq, int bh, int L, float scale, void* stream) {
    return launch_bwd_q<true>(q, k, v, dout, lse, const_cast<void*>(di), dq,
                              bh, L, scale, stream);
}

}  // extern "C"
