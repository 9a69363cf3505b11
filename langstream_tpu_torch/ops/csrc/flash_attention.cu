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
// 0.05 ms of bytes). Two kernels, chosen by the caller (`kernel`):
//
// flash_fwd_wgmma_kernel (bfloat16, D in {64, 128}; what prefill runs):
// both products on the tensor cores with wgmma, bf16 in, f32 accumulate.
// One CTA of three warpgroups per 192 query rows of one (batch, head);
// each warpgroup owns 64 rows. Q is loaded once into shared memory in
// bf16; 128-key K/V tiles come through a two-stage ring filled by 16-byte
// cp.async copies (zero-filled past Sk), so tile t+1 loads while tile t is
// computed; one barrier per tile (177 KB of shared memory at D = 128).
// Every tile is stored as D/64 slabs of 128-byte rows with the 128-byte
// swizzle the wgmma descriptors name. S = Q.K^T is an m64n128k16 wgmma
// with both operands in shared memory; the online softmax runs on its f32
// accumulator fragments in registers (the scale folded into the exp2's
// multiply-add); P is rounded to bf16 in registers (the Pallas kernel's
// p.astype(v.dtype)) and fed back as the A operand of O += P.V (m64nDk16,
// V read MN-major from shared memory), so P never goes through shared
// memory. Causal: tiles wholly in a warpgroup's future are skipped, only
// the diagonal and the ragged tile are masked, and the grid starts with
// the last (longest) query tiles so its tail is short. Not done yet: TMA
// loads, a producer warp and warpgroup ping-pong (the softmax still takes
// issue slots the products could use).
//
// flash_fwd_kernel (float32, and D = 16): the first port, plain f32 FMA
// tiles from shared memory. A TF32 product would miss the f32 tolerance
// (1e-4) and the card-vs-CPU greedy identity, so f32 stays here. One CTA
// per (64-row query tile, head, batch), 256 threads in a 16x16 layout;
// thread (ty, tx) owns query rows ty+16i and key columns tx+16j of each
// score tile; the output tile stays in registers; all tiles are f32 in
// dynamic shared memory (115 KB at D = 128).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "wgmma.cuh"


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

namespace tc {

using namespace wg;  // swz, desc, the fences and the wgmma products

// Three warpgroups (12 warps, one CTA per SM) let one
// warpgroup's softmax run while another's products do; 128-key tiles halve
// the barriers and waits per key against 64.
constexpr int NWG = 3;        // warpgroups per CTA, 64 query rows each
constexpr int BM = 64 * NWG;  // query rows per CTA
constexpr int BN = 128;       // keys per K/V tile
constexpr int NT = 128 * NWG;

// Rows [row0, row0 + R) of head `head` of x (B, S, heads, D) into a tile;
// rows >= S are zero-filled. Thread tid copies chunk column tid % (D/8) of
// rows tid / (D/8) + j * RPP; RPP is a multiple of 8, so the swizzle term
// is the same for every j and each copy costs a few instructions. Offsets
// are 32-bit: the host entry refuses tensors of 2^31 elements or more.
template <int R, int D>
__device__ __forceinline__ void load_tile(uint8_t* dst, const __nv_bfloat16* x, int b,
                                          int row0, int S, int heads, int head,
                                          int tid) {
  constexpr int CPR = D / 8;
  constexpr int RPP = NT / CPR;  // rows per pass
  static_assert(NT % CPR == 0 && RPP % 8 == 0, "passes must keep the swizzle phase");
  const int cc = tid % CPR;
  const int r0 = tid / CPR;
  const uint32_t stride = (uint32_t)heads * D;  // elements from one row to the next
  const uint32_t off = (uint32_t)(b * S + row0 + r0) * stride + head * D + cc * 8;
  uint8_t* d = dst + swz<R>(r0, cc);
#pragma unroll
  for (int j = 0; j < (R + RPP - 1) / RPP; ++j) {
    if (R % RPP != 0 && r0 + j * RPP >= R) break;
    const bool ok = row0 + r0 + j * RPP < S;
    ls::cp_async16(d + j * RPP * 128, x + (ok ? off + j * RPP * stride : 0), ok ? 16 : 0);
  }
}

template <int D>
constexpr size_t smem_bytes() {
  return size_t(BM) * D * 2 + 4 * size_t(BN) * D * 2 + 1024;  // Q, 2 x (K, V), alignment
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                       int B, int Sq, int Sk, int H, int Kh, float scale_log2,
                       int causal) {
  static_assert(D == 64 || D == 128, "tensor-core flash takes D in {64, 128}");
  constexpr uint32_t Q_BYTES = BM * D * 2;
  constexpr uint32_t KV_BYTES = BN * D * 2;
  constexpr float NEG_INF = ls::NEG_INF;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle repeats every 1024 bytes: align the tiles to it
  uint8_t* sm = smem_raw + ((1024 - (ls::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Qs = sm;
  uint8_t* Ks = sm + Q_BYTES;     // 2 stages
  uint8_t* Vs = Ks + 2 * KV_BYTES;  // 2 stages

  // one CTA per (query tile, batch, head), the last query tiles first
  const int n_qt = (Sq + BM - 1) / BM;
  int idx = blockIdx.x;
  const int h = idx % H;
  idx /= H;
  const int b = idx % B;
  const int qt = n_qt - 1 - idx / B;
  const int kh = h / (H / Kh);
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int q0 = qt * BM;
  const int q0w = q0 + wg * 64;                    // this warpgroup's first row
  const int row0 = q0w + warp * 16 + (lane >> 2);  // this thread's rows: row0, row0 + 8
  const bool wg_live = q0w < Sq;

  int n_kt = (Sk + BN - 1) / BN;
  if (causal) n_kt = min(n_kt, (q0 + BM - 1) / BN + 1);

  load_tile<BM, D>(Qs, q, b, q0, Sq, H, h, tid);
  load_tile<BN, D>(Ks, k, b, 0, Sk, Kh, kh, tid);
  load_tile<BN, D>(Vs, v, b, 0, Sk, Kh, kh, tid);
  ls::cp_async_commit();

  // Fragment of an m64nN f32 accumulator: element 4j+e is row row0 + 8*(e>>1),
  // column 8j + 2*(lane%4) + (e&1).
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};
  float l_r[2] = {0.f, 0.f};  // this thread's columns only; summed over the quad at the end
  const uint32_t q_base = ls::smem_u32(Qs) + wg * 64 * 128;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1;
    ls::cp_async_wait<0>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // tile kt is in for every thread; tile kt-1's readers are done
    if (kt + 1 < n_kt) {
      load_tile<BN, D>(Ks + (st ^ 1) * KV_BYTES, k, b, (kt + 1) * BN, Sk, Kh, kh, tid);
      load_tile<BN, D>(Vs + (st ^ 1) * KV_BYTES, v, b, (kt + 1) * BN, Sk, Kh, kh, tid);
      ls::cp_async_commit();
    }
    const int k0 = kt * BN;
    if (!wg_live || (causal && k0 > q0w + 63)) continue;  // wholly in the future
    const uint32_t k_base = ls::smem_u32(Ks + st * KV_BYTES);
    const uint32_t v_base = ls::smem_u32(Vs + st * KV_BYTES);

    // S = Q . K^T, D/16 steps of k16 (32 bytes inside a 128-byte row, then the next slab)
    float s[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t qo = (kk >> 2) * (BM * 128) + (kk & 3) * 32;
      const uint32_t ko = (kk >> 2) * (BN * 128) + (kk & 3) * 32;
      wgmma_ss(s, desc(q_base + qo, 16, 1024), desc(k_base + ko, 16, 1024),
               kk > 0 ? 1 : 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // mask the diagonal and the ragged tile, then the online softmax; m is
    // kept in unscaled score units (the scale is positive) and the scale
    // (base 2) folds into the exponent's multiply-add
    if ((k0 + BN > Sk) || (causal && k0 + BN - 1 > q0w)) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * j + 2 * (lane & 3) + (e & 1);
          const int row = row0 + 8 * (e >> 1);
          if (col >= Sk || (causal && col > row)) s[4 * j + e] = NEG_INF;
        }
      }
    }
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
    float shift[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      shift[r] = (m_new <= NEG_INF) ? 0.f : m_new * scale_log2;
      alpha[r] = (m_r[r] <= NEG_INF) ? 0.f : exp2f(m_r[r] * scale_log2 - shift[r]);
      m_r[r] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a masked score is NEG_INF and shift is finite: p is exactly 0
        const float p = exp2f(fmaf(s[4 * j + e], scale_log2, -shift[e >> 1]));
        psum[e >> 1] += p;
        s[4 * j + e] = p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + psum[r];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[4 * j + e] *= alpha[e >> 1];

    // P in bf16 as the A fragments of k16 step kk: keys 16kk..16kk+15
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }

    // O += P . V: 16 keys (two 8-key groups, 2048 bytes) per step
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs(acc, pa[kk], desc(v_base + kk * 2048, BN * 128, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
  if (!wg_live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
    const float inv = l_r[r] > 0.f ? 1.f / fmaxf(l_r[r], 1e-30f) : 0.f;
    __nv_bfloat16* dst = o + ((size_t)(b * Sq + row) * H + h) * D + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
           int H, int Kh, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (Sq + BM - 1) / BM;
  flash_fwd_wgmma_kernel<D><<<n_qt * H * B, NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), B, Sq, Sk, H,
      Kh, scale * 1.4426950408889634f, causal);
  return (int)cudaGetLastError();
}

}  // namespace tc

// dtype: 0 = float32, 1 = bfloat16. kernel: 0 = the FMA tiles (float32 at
// D in {16, 64, 128}, bfloat16 at D = 16), 1 = the tensor cores (bfloat16
// at D in {64, 128}, tensors under 2^31 elements). Returns
// cudaGetLastError() after the launch (a cudaError_t code; 0 = success); an
// unsupported combination returns -1.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int Sq, int Sk, int H,
                                   int Kh, int D, int dtype, float scale,
                                   int causal, int kernel, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == 1 && ((long long)B * Sq * H * D >= (1ll << 31) ||
                      (long long)B * Sk * Kh * D >= (1ll << 31)))
    return -1;
  if (kernel == 1 && dtype == 1 && D == 128)
    return tc::launch<128>(q, k, v, o, B, Sq, Sk, H, Kh, scale, causal, s);
  if (kernel == 1 && dtype == 1 && D == 64)
    return tc::launch<64>(q, k, v, o, B, Sq, Sk, H, Kh, scale, causal, s);
  if (kernel != 0) return -1;
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, o, B, Sq, Sk, H, Kh, scale, causal, s);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, o, B, Sq, Sk, H, Kh, scale, causal, s);
  if (dtype == 0 && D == 16)
    return launch<float, 16>(q, k, v, o, B, Sq, Sk, H, Kh, scale, causal, s);
  if (dtype == 1 && D == 16)
    return launch<__nv_bfloat16, 16>(q, k, v, o, B, Sq, Sk, H, Kh, scale,
                                     causal, s);
  return -1;
}
