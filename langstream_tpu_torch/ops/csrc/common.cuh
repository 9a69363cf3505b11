// Helpers shared by the port's kernels: the NaN-guard constant, float
// conversions, the cp.async copies and the partials' merge.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ls {

// finfo(float32).min: the Pallas kernels' "minus infinity"
constexpr float NEG_INF = -3.4028234663852886e+38f;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes = 0 writes 16 zero bytes and
// reads nothing (the ragged edge of a tile).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4-byte copy (through L1: .cg takes 16 bytes only); src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The combine's algebra for column d of one output row: merge the n
// partials (acc, m, l) at rows row + s * stride (acc rows D wide) with the
// NEG_INF guards of merge_partial_attention; n = 0 gives m = NEG_INF,
// l = 0, acc = 0. Serves the span combines and the int8 read's warp merge.
__device__ __forceinline__ void merge_partials(const float* acc_p, const float* m_p,
                                               const float* l_p, size_t row, size_t stride,
                                               int n, int D, int d, float& A, float& M,
                                               float& L) {
  M = NEG_INF;
  for (int s = 0; s < n; ++s) M = fmaxf(M, m_p[row + s * stride]);
  const float shift = (M <= NEG_INF) ? 0.f : M;
  A = 0.f;
  L = 0.f;
  for (int s = 0; s < n; ++s) {
    const size_t r = row + s * stride;
    const float ms = m_p[r];
    const float w = (ms <= NEG_INF) ? 0.f : expf(ms - shift);
    L += l_p[r] * w;
    A += acc_p[r * D + d] * w;
  }
}

}  // namespace ls
