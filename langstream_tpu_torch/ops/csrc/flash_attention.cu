// Blocked (flash) causal / non-causal GQA attention for prefill, sm_90a.
//
// Replaces: langstream_tpu/ops/flash_attention.py::_flash_kernel (called
// through _flash_bhsd and flash_attention). Same function: q (B,Sq,H,D),
// k/v (B,Sk,Kh,D), query head h reads KV head h / (H/Kh), scores scaled,
// masked at col >= Sk and (causal) row < col, online softmax with f32
// m/l/acc, normalised output written in the input dtype. The NaN guards
// are the Pallas kernel's: NEG_INF is finfo(float32).min, a running max at
// NEG_INF shifts by 0, and a row with l == 0 writes 0.
//
// What bounds it on an H100: the work is 4*S*S*D/2 FLOPs per (batch,
// head) against O(S*D) bytes, so from about S = 1k upward it passes the
// card's ~295 FLOP/byte balance point and is bound by operations (at
// B=4, S=2048, H=32, D=128: 0.139 ms of bf16 tensor-core work against
// 0.05 ms of bytes). This first version does the two products with plain
// f32 FMAs from shared memory (no tensor cores), so it runs at a fraction
// of the 989 TFLOP/s bf16 peak; mma/wgmma tiles are later work.
//
// Design: one CTA per (64-row query tile, head, batch), 256 threads in a
// 16x16 layout. The Q tile is staged in shared memory once (as f32); the
// CTA loops over 64-row K/V tiles up to the causal bound, skipping tiles
// that lie entirely in the future. Thread (ty, tx) owns query rows
// ty+16i and key columns tx+16j of each score tile, so Q reads broadcast
// and K reads (row stride D+1) hit distinct banks; the 16 threads that
// share a row reduce max/sum with warp shuffles. The output tile (64 x D)
// stays in registers. All tiles are f32 in dynamic shared memory (115 KB
// at D = 128), past the 48 KB static limit, hence cudaFuncSetAttribute.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr float NEG_INF = -3.4028234663852886e+38f;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t(BQ) * (D + 1) + size_t(BK) * (D + 1) + size_t(BK) * D +
          size_t(BQ) * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
                 int H, int Kh, float scale, int causal) {
  constexpr int DP = D + 1;   // padded stride: column reads hit distinct banks
  constexpr int PP = BK + 1;
  constexpr int DJ = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;            // BQ x DP
  float* Ks = Qs + BQ * DP;    // BK x DP
  float* Vs = Ks + BK * DP;    // BK x D
  float* Ps = Vs + BK * D;     // BQ x PP

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / Kh);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = qt * BQ;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i % D;
    const int row = q0 + r;
    float val = 0.f;
    if (row < Sq) val = to_f(q[((size_t)(b * Sq + row) * H + h) * D + d]);
    Qs[r * DP + d] = val;
  }

  float m_i[4], l_i[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  int n_kt = (Sk + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (q0 + BQ - 1) / BK + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, d = i % D;
      const int row = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (row < Sk) {
        const size_t off = ((size_t)(b * Sk + row) * Kh + kh) * D + d;
        kv = to_f(k[off]);
        vv = to_f(v[off]);
      }
      Ks[r * DP + d] = kv;
      Vs[r * D + d] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        ok[j] = col < Sk && (!causal || row >= col);
        s[i][j] = ok[j] ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float shift = (m_new <= NEG_INF) ? 0.f : m_new;
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - shift) : 0.f;
        Ps[(ty + 16 * i) * PP + tx + 16 * j] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      const float alpha = (m_i[i] <= NEG_INF) ? 0.f : expf(m_i[i] - shift);
      l_i[i] = l_i[i] * alpha + psum;
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = Ps[(ty + 16 * i) * PP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vb = Vs[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pa[i], vb, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float inv = l_i[i] > 0.f ? 1.f / fmaxf(l_i[i], 1e-30f) : 0.f;
    T* dst = o + ((size_t)(b * Sq + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) dst[tx + 16 * j] = from_f<T>(acc[i][j] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
           int Sk, int H, int Kh, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, Kh, scale,
      causal);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (a cudaError_t code; 0 = success); unsupported shapes return -1.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int Sq, int Sk, int H,
                                   int Kh, int D, int dtype, float scale,
                                   int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, o, B, Sq, Sk, H, Kh, scale, causal, s);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, o, B, Sq, Sk, H, Kh, scale, causal, s);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, B, Sq, Sk, H, Kh, scale,
                                      causal, s);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, B, Sq, Sk, H, Kh, scale,
                                     causal, s);
  if (dtype == 0 && D == 16)
    return launch<float, 16>(q, k, v, o, B, Sq, Sk, H, Kh, scale, causal, s);
  if (dtype == 1 && D == 16)
    return launch<__nv_bfloat16, 16>(q, k, v, o, B, Sq, Sk, H, Kh, scale,
                                     causal, s);
  return -1;
}
