// Hopper (sm_90a) building blocks for the port's kernels, as inline PTX:
// mbarriers, TMA tile loads, wgmma descriptors and products, register
// rebalancing between warpgroups, and the host-side encoding of TMA
// tensor maps without linking the driver library.
//
// Shared-memory tiles are written by TMA with the 128-byte swizzle: a box
// of R rows x 64 bf16 (128 bytes a row) lands as R / 8 atoms of 8 rows x
// 128 bytes (1024 bytes), the 16-byte chunks of row r stored at chunk
// index (c ^ r % 8). Every tile starts on a 1024-byte boundary, so the
// swizzle, a function of the address, is the one wgmma reads with layout
// type B128. A 128-wide bf16 row is two such boxes, one after the other.
//
// wgmma descriptors for those tiles (PTX ISA, "matrix descriptor"; CuTe's
// make_gmma_desc in cute/atom/mma_traits_sm90_gmma.hpp):
//   K-major (the reduction axis runs along a row): SBO = 1024 bytes from
//     one 8-row group to the next, LBO unused (1); a step of 16 elements
//     along k adds 32 bytes inside the atom, the fifth step moves to the
//     next box.
//   MN-major (the reduction axis runs down the rows; the transpose bit
//     set): 8 rows of k are one atom, SBO = 1024 bytes to the next 8 rows
//     of k, LBO = one box to the next 64 elements along m or n; a step of
//     16 along k adds 16 rows = 2048 bytes.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>
#include <stdint.h>

namespace hopper {

// ------------------------------------------------------------- mbarrier

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// Make the initialised barriers visible to the async proxy (TMA) and to
// the other threads; call once after the inits, before a __syncthreads.
__device__ __forceinline__ void mbar_fence_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_addr(bar)) : "memory");
}

// Arrive and announce `bytes` of asynchronous copies that complete on it.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` has completed. (No timeout
// with a trap here: a trap on the path makes ptxas serialise every wgmma
// of the kernel and spill its accumulators.)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t a = smem_addr(bar);
    uint32_t done;
    do {
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(a), "r"(parity) : "memory");
    } while (!done);
}

// ------------------------------------------------------------------ TMA

// A 2-D box of the tensor map at (col, row) into shared memory; the bytes
// complete on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int col, int row) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
        :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
           "r"(smem_addr(bar)), "r"(col), "r"(row)
        : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// to shared memory; the bytes complete on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
}

// ---------------------------------------------------------- warpgroups

template <uint32_t N>
__device__ __forceinline__ void regs_dec() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <uint32_t N>
__device__ __forceinline__ void regs_inc() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// --------------------------------------------------------------- wgmma

// Descriptor of a B128-swizzled operand at shared address `a`.
__device__ __forceinline__ uint64_t desc(uint32_t a, uint32_t lbo_bytes,
                                         uint32_t sbo_bytes) {
    return (uint64_t)((a & 0x3FFFF) >> 4)
         | ((uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16)
         | ((uint64_t)((sbo_bytes >> 4) & 0x3FFF) << 32)
         | (1ull << 62);
}

// Order this thread's register writes (accumulators, A fragments) before
// the wgmma that reads them.
__device__ __forceinline__ void wg_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across a
// wgmma boundary.
template <int N>
__device__ __forceinline__ void wg_hold(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; i++) asm volatile("" : "+f"(d[i]) :: "memory");
}

// Keep A fragments in their registers until this point: a wgmma reads
// them after it is issued, until the wait for its group returns.
template <int N>
__device__ __forceinline__ void wg_keep(const uint32_t (&a)[N][4]) {
#pragma unroll
    for (int i = 0; i < N; i++)
        asm volatile("" :: "r"(a[i][0]), "r"(a[i][1]), "r"(a[i][2]),
                     "r"(a[i][3]) : "memory");
}

#define HOPPER_F8(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), \
    "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]),   \
    "+f"(d[i + 7])

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B in shared memory;
// TB = 1 reads B MN-major. scale_d = 0 overwrites D.
template <int TB>
__device__ __forceinline__ void wgmma_128_ss(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, %67;\n}\n"
        : HOPPER_F8(d, 0), HOPPER_F8(d, 8), HOPPER_F8(d, 16),
          HOPPER_F8(d, 24), HOPPER_F8(d, 32), HOPPER_F8(d, 40),
          HOPPER_F8(d, 48), HOPPER_F8(d, 56)
        : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

// D[64 x 128] += A[64 x 16] B[16 x 128], A in registers (the fragment of
// m16n8k16's A for each warp's 16 rows), B in shared memory; TB = 1 reads
// B MN-major.
template <int TB>
__device__ __forceinline__ void wgmma_128_rs(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : HOPPER_F8(d, 0), HOPPER_F8(d, 8), HOPPER_F8(d, 16),
          HOPPER_F8(d, 24), HOPPER_F8(d, 32), HOPPER_F8(d, 40),
          HOPPER_F8(d, 48), HOPPER_F8(d, 56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
          "n"(TB));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], both K-major in shared memory.
__device__ __forceinline__ void wgmma_64_ss(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : HOPPER_F8(d, 0), HOPPER_F8(d, 8), HOPPER_F8(d, 16),
          HOPPER_F8(d, 24)
        : "l"(da), "l"(db), "r"(scale_d));
}

#undef HOPPER_F8

// ----------------------------------------------------------------- host

// cuTensorMapEncodeTiled, reached through the runtime so that no link
// against the driver library is needed; null where the driver lacks it.
inline PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
    static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        cudaError_t e = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
        cudaError_t e = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
        if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
    }
    return fn;
}

// A map of `rows` x `cols` contiguous bf16 with boxes of box_rows x 64
// columns, 128-byte swizzle. Returns 0 or a CUDA error code.
inline int bf16_map(CUtensorMap* map, const void* base, uint64_t rows,
                    uint64_t cols, uint32_t box_rows) {
    PFN_cuTensorMapEncodeTiled_v12000 fn = encode_fn();
    if (fn == nullptr) return (int)cudaErrorNotSupported;
    const cuuint64_t dims[2] = {cols, rows};
    const cuuint64_t strides[1] = {cols * 2};
    const cuuint32_t box[2] = {64, box_rows};
    const cuuint32_t elem[2] = {1, 1};
    CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                    const_cast<void*>(base), dims, strides, box, elem,
                    CU_TENSOR_MAP_INTERLEAVE_NONE,
                    CU_TENSOR_MAP_SWIZZLE_128B,
                    CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                    CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace hopper
