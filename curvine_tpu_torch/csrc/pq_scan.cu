// pq_lut_scan: the ADC stage of the IVF-PQ search, for a batch of queries.
//
// Replaces the Pallas TPU kernel curvine_tpu/tpu/pallas_ops.py
// (_pq_scan_kernel, launched by _pq_scan_padded / pq_lut_scan and vmapped
// over the queries of a batch in curvine_tpu/vector/index.py). For each
// query q and candidate w (asymmetric distance computation: a candidate is
// scored from its product-quantization codes through the query's lookup
// table):
//
//   out[q, w] = sum_{m = 0..M-1} lut[q, m, c - (pre_offset ? m * ksub : 0)]
//               with c = codes[q, w, m]
//
// summed in float32 in the order m = 0, 1, ..., M-1, and a code outside its
// subspace's [0, ksub) adds 0. The TPU kernel has no gather: it compares the
// codes with an iota and sums the selected LUT row, which adds exactly 0 for
// such a code, so out-of-range codes (-1, >= ksub, another subspace's
// pre-offset range) are part of the function. The sum in order makes the
// result bit-equal to the plain version (gpu/pq.py) and to the TPU kernel.
//
// Layout: lut [Q, M, ksub] float32, codes [Q, W, M] int32, out [Q, W]
// float32, all contiguous; any W >= 1. One launch takes the whole batch (the
// JAX package launches one kernel per query and pads W to 128).
//
// What bounds it on an H100: bytes. A candidate reads M 4-byte codes and
// does M shared-memory lookups and adds; the codes (Q*W*M*4 bytes) dominate
// the traffic, the LUT (Q*M*ksub*4) and the output (Q*W*4) are small. At
// the serving shape (Q 256, W about 7.7K, M 16) that is about 139 MB, about
// 41 us at 3.35 TB/s. The design is the simple one: grid (ceil(W/256), Q)
// of 256 threads; the block stages its query's LUT (M*ksub floats, 16 KiB
// at M 16, 64 KiB at M 64) in shared memory; each thread scores one
// candidate, reading its codes with 16-byte loads where M % 4 == 0 and the
// base is 16-byte aligned (4-byte loads otherwise), and adds its M table
// entries in order. A shared-memory table above 48 KiB needs the opt-in
// attribute, which the entry point sets. The grid's y extent is capped at
// 65,535; a block then walks the queries blockIdx.y, + gridDim.y, ...
//
// The C entry point launches on the caller's stream, does not synchronise,
// allocates nothing (the wrapper passes the output) and returns the CUDA
// error of the attribute call or of the launch (cudaGetLastError).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;
constexpr int kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float adc_term(const float* s_lut, int32_t code,
                                          int mi, int ksub, int pre_offset) {
  // 64-bit so that code - m*ksub cannot overflow for any int32 code
  const long long c = static_cast<long long>(code) -
                      (pre_offset ? static_cast<long long>(mi) * ksub : 0ll);
  return (c >= 0 && c < ksub) ? s_lut[mi * ksub + static_cast<int>(c)] : 0.0f;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
pq_scan_kernel(const float* __restrict__ lut,
               const int32_t* __restrict__ codes, float* __restrict__ out,
               int nq, long long w, int m, int ksub, int pre_offset) {
  extern __shared__ float s_lut[];
  const int table = m * ksub;
  const long long cand = static_cast<long long>(blockIdx.x) * kThreads +
                         threadIdx.x;
  for (int q = blockIdx.y; q < nq; q += gridDim.y) {
    __syncthreads();    // the previous query's lookups are done
    const float* __restrict__ qlut = lut + static_cast<long long>(q) * table;
    for (int i = threadIdx.x; i < table; i += kThreads) s_lut[i] = qlut[i];
    __syncthreads();
    if (cand >= w) continue;
    const long long row = static_cast<long long>(q) * w + cand;
    const int32_t* __restrict__ rc = codes + row * m;
    float acc = 0.0f;
    if (kVec) {
      const int4* __restrict__ rc4 = reinterpret_cast<const int4*>(rc);
      for (int j = 0; j < (m >> 2); ++j) {
        const int4 c = rc4[j];
        const int mi = j << 2;
        acc = __fadd_rn(acc, adc_term(s_lut, c.x, mi, ksub, pre_offset));
        acc = __fadd_rn(acc, adc_term(s_lut, c.y, mi + 1, ksub, pre_offset));
        acc = __fadd_rn(acc, adc_term(s_lut, c.z, mi + 2, ksub, pre_offset));
        acc = __fadd_rn(acc, adc_term(s_lut, c.w, mi + 3, ksub, pre_offset));
      }
    } else {
      for (int mi = 0; mi < m; ++mi)
        acc = __fadd_rn(acc, adc_term(s_lut, rc[mi], mi, ksub, pre_offset));
    }
    out[row] = acc;
  }
}

template <bool kVec>
int launch(const float* lut, const int32_t* codes, float* out, int nq,
           long long w, int m, int ksub, int pre_offset,
           cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(m) * ksub * sizeof(float);
  if (smem > static_cast<size_t>(kDefaultSmem)) {
    const cudaError_t e = cudaFuncSetAttribute(
        pq_scan_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>((w + kThreads - 1) / kThreads),
                  static_cast<unsigned>(nq < kMaxGridY ? nq : kMaxGridY));
  pq_scan_kernel<kVec><<<grid, kThreads, smem, stream>>>(
      lut, codes, out, nq, w, m, ksub, pre_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cv_pq_lut_scan(const void* lut, const void* codes, void* out,
                              int nq, long long w, int m, int ksub,
                              int pre_offset, void* stream) {
  if (nq <= 0 || w <= 0 || m <= 0 || ksub <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = (m & 3) == 0 &&
                  (reinterpret_cast<uintptr_t>(codes) & 15u) == 0;
  const auto* l = static_cast<const float*>(lut);
  const auto* c = static_cast<const int32_t*>(codes);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  return vec ? launch<true>(l, c, o, nq, w, m, ksub, pre_offset, s)
             : launch<false>(l, c, o, nq, w, m, ksub, pre_offset, s);
}
