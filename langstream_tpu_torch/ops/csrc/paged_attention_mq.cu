// Multi-query paged history read (continuation prefill), bf16/f32 pools, sm_90a.
//
// Replaces: langstream_tpu/ops/paged_attention.py::_paged_mq_kernel (called
// through paged_attention_multiquery_partial). Same function: the T suffix
// queries of slot b attend that slot's paged HISTORY, the first starts[b]
// cache rows (never past num_read_blocks blocks), found through the block
// table. The mask is col < starts[b] for every query row: history is visible
// to the whole suffix, so there is no causal term (causality among the
// suffix itself is the caller's separate segment). Scores are q . k scaled
// by `scale`; the kernel keeps an online softmax per query row and returns
// the UNNORMALISED partials acc (B,T,H,D) f32, m (B,T,H) f32, l (B,T,H) f32.
// GQA: the G = H/Kh heads [kh*G, (kh+1)*G) read KV head kh, the column slice
// [kh*D, (kh+1)*D) of each fused Kh*D pool row. NaN guards are the Pallas
// kernel's: NEG_INF = finfo(float32).min, a slot with starts == 0 returns
// m = NEG_INF, l = 0, acc = 0.
//
// What bounds it on an H100: per KV head, each history row is used by T*G
// query rows, so the call does 4*T*H*D*sum(starts) operations over about
// 4*Kh*D*sum(starts) bytes of bf16 K and V: T*G operations per byte. The
// card's bf16 balance point is 989e12 / 3.35e12 = 295 operations per byte,
// so at Llama-3-8B (G = 4) a decode-sized suffix (T = 16: 64 per byte) is
// bound by bytes, and a chunk-sized one (T = 512: 2048 per byte) by
// operations; the crossover is T near 74. This first kernel does its two
// products with f32 FMAs from shared memory, far from the tensor-core rate:
// tensor cores (mma.sync / wgmma) and cp.async double buffering are later
// work.
//
// Design: grid (B, Kh, ceil(T / TQ)), 256 threads. A CTA owns R = 64 query
// rows of one (slot, KV head): TQ = 64 / G query positions times the G
// heads that share the KV head (16 x 4 at Llama-3-8B). It walks only the
// ceil(starts[b] / 32) history tiles of 32 rows the slot holds, looking
// each row's block up in the table itself, so a short or empty history
// costs what it holds and any block size works. Per tile: K and V are
// widened to f32 in shared memory (K with a padded stride); each warp owns
// 8 query rows and each lane one history row, so the scores stay in
// registers through the warp's max/sum shuffles; then each thread adds
// its 64*D/256 output accumulators (registers) from the probability tile.
// Query rows at or past T are masked: warps whose rows all lie past T skip
// the tile, and nothing is written for such rows. About 75 KB of shared
// memory at D = 128, so three CTAs share an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;       // history rows per tile (one per lane)
constexpr int NT = 256;        // threads per CTA
constexpr int NW = NT / 32;    // warps per CTA
constexpr int R = 64;          // query rows per CTA (TQ positions x G heads)
constexpr int RPW = R / NW;    // query rows per warp in the score phase
constexpr int SP = TILE + 1;   // padded stride of the probability tile
constexpr float NEG_INF = -3.4028234663852886e+38f;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// A 16-byte chunk of a pool row, widened to f32.
template <typename T> struct Chunk;
template <> struct Chunk<float> {
  static constexpr int N = 4;
  __device__ static void cvt(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};
template <> struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void cvt(const uint4& u, float* f) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(p[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};

__host__ __device__ constexpr size_t smem_bytes(int D) {
  // Ks, Vs, Qs, Ps, m/l/alpha (floats), then the tile's row offsets (ints)
  return sizeof(float) * (size_t(TILE) * (D + 1) + size_t(TILE) * D +
                          size_t(R) * D + size_t(R) * SP + 3 * size_t(R)) +
         sizeof(int) * TILE;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
paged_mq_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                const T* __restrict__ vp, const int* __restrict__ tables,
                const int* __restrict__ starts, float* __restrict__ acc_out,
                float* __restrict__ m_out, float* __restrict__ l_out, int Tq,
                int H, int Kh, int bs, int max_blocks, int nrb, float scale) {
  constexpr int KP = D + 1;
  constexpr int EPC = Chunk<T>::N;   // elements per 16-byte chunk
  constexpr int CPR = D / EPC;       // chunks per row slice
  constexpr int NRG = NT / D;        // row groups in the value phase
  constexpr int ACC = R / NRG;       // accumulators per thread
  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int G = H / Kh;
  const int TQ = R / G;
  const int t_first = blockIdx.z * TQ;
  // rows rr = t_local * G + g: position t_first + t_local, head kh * G + g
  const int nvalid = min(TQ, Tq - t_first) * G;
  const size_t KhD = (size_t)Kh * D;

  extern __shared__ float smem[];
  float* Ks = smem;                 // TILE x KP
  float* Vs = Ks + TILE * KP;       // TILE x D
  float* Qs = Vs + TILE * D;        // R x D
  float* Ps = Qs + R * D;           // R x SP
  float* m_s = Ps + R * SP;         // R
  float* l_s = m_s + R;             // R
  float* a_s = l_s + R;             // R
  int* rowoff = reinterpret_cast<int*>(a_s + R);  // TILE

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < R * D; i += NT) {
    const int rr = i / D, d = i % D;
    float v = 0.f;
    if (rr < nvalid) {
      const int t = t_first + rr / G;
      v = to_f(q[(((size_t)b * Tq + t) * H + (size_t)kh * G + rr % G) * D + d]);
    }
    Qs[i] = v;
  }
  for (int rr = tid; rr < R; rr += NT) {
    m_s[rr] = NEG_INF;
    l_s[rr] = 0.f;
  }
  float acc[ACC];
#pragma unroll
  for (int j = 0; j < ACC; ++j) acc[j] = 0.f;

  int start = starts[b];
  start = max(0, min(start, nrb * bs));
  const bool warp_live = warp * RPW < nvalid;
  const int rg = tid / D;  // value phase: rows rg + NRG * j, column d
  const int d = tid % D;

  for (int c0 = 0; c0 < start; c0 += TILE) {
    __syncthreads();  // the previous tile's readers are done
    if (tid < TILE) {
      const int p = c0 + tid;
      int off = -1;
      if (p < start) off = tables[(size_t)b * max_blocks + p / bs] * bs + p % bs;
      rowoff[tid] = off;
    }
    __syncthreads();
    for (int i = tid; i < TILE * CPR; i += NT) {
      const int r = i / CPR, c = i % CPR;
      const int off = rowoff[r];
      float kf[EPC], vf[EPC];
      if (off >= 0) {
        const size_t base = (size_t)off * KhD + (size_t)kh * D + (size_t)c * EPC;
        const uint4 ku = __ldg(reinterpret_cast<const uint4*>(kp + base));
        const uint4 vu = __ldg(reinterpret_cast<const uint4*>(vp + base));
        Chunk<T>::cvt(ku, kf);
        Chunk<T>::cvt(vu, vf);
      } else {
#pragma unroll
        for (int e = 0; e < EPC; ++e) kf[e] = vf[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < EPC; ++e) {
        Ks[r * KP + c * EPC + e] = kf[e];
        Vs[r * D + c * EPC + e] = vf[e];
      }
    }
    __syncthreads();

    if (warp_live) {
      // scores of this warp's RPW query rows against history row `lane`
      const float* kr = Ks + lane * KP;
      const float* qw = Qs + warp * RPW * D;
      float s[RPW];
#pragma unroll
      for (int i = 0; i < RPW; ++i) s[i] = 0.f;
#pragma unroll 4
      for (int dd = 0; dd < D; ++dd) {
        const float kv = kr[dd];
#pragma unroll
        for (int i = 0; i < RPW; ++i) s[i] = fmaf(qw[i * D + dd], kv, s[i]);
      }
      // online softmax, one row at a time across the warp's lanes
      const bool ok = c0 + lane < start;
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const int rr = warp * RPW + i;
        const float sc = ok ? s[i] * scale : NEG_INF;
        float mx = sc;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_prev = m_s[rr];
        const float m_new = fmaxf(m_prev, mx);
        const float shift = (m_new <= NEG_INF) ? 0.f : m_new;
        const float p = ok ? expf(sc - shift) : 0.f;
        float psum = p;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          psum += __shfl_xor_sync(0xffffffffu, psum, o);
        const float alpha = (m_prev <= NEG_INF) ? 0.f : expf(m_prev - shift);
        Ps[rr * SP + lane] = p;
        __syncwarp();
        if (lane == 0) {
          m_s[rr] = m_new;
          l_s[rr] = l_s[rr] * alpha + psum;
          a_s[rr] = alpha;
        }
      }
    }
    __syncthreads();

    // value sum: this thread's rows rg + NRG * j at column d
    const int nr = min(TILE, start - c0);
#pragma unroll
    for (int j = 0; j < ACC; ++j) {
      const int rr = rg + NRG * j;
      if (rr < nvalid) acc[j] *= a_s[rr];
    }
    for (int r = 0; r < nr; ++r) {
      const float vv = Vs[r * D + d];
#pragma unroll
      for (int j = 0; j < ACC; ++j) {
        const int rr = rg + NRG * j;
        if (rr < nvalid) acc[j] = fmaf(Ps[rr * SP + r], vv, acc[j]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int j = 0; j < ACC; ++j) {
    const int rr = rg + NRG * j;
    if (rr < nvalid) {
      const size_t row = ((size_t)b * Tq + t_first + rr / G) * H + (size_t)kh * G + rr % G;
      acc_out[row * D + d] = acc[j];
    }
  }
  for (int rr = tid; rr < nvalid; rr += NT) {
    const size_t row = ((size_t)b * Tq + t_first + rr / G) * H + (size_t)kh * G + rr % G;
    m_out[row] = m_s[rr];
    l_out[row] = l_s[rr];
  }
}

template <typename T, int D>
int launch(const void* q, const void* kp, const void* vp, const void* tables,
           const void* starts, void* acc, void* m, void* l, int B, int Tq,
           int H, int Kh, int bs, int max_blocks, int nrb, float scale,
           cudaStream_t stream) {
  const int G = H / Kh;
  const int TQ = R / G;
  const size_t smem = smem_bytes(D);
  auto kernel = paged_mq_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(B, Kh, (Tq + TQ - 1) / TQ);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(tables),
      static_cast<const int*>(starts), static_cast<float*>(acc),
      static_cast<float*>(m), static_cast<float*>(l), Tq, H, Kh, bs,
      max_blocks, nrb, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B,T,H,D), pools (nb,bs,Kh*D) in q's dtype (0 = float32, 1 = bfloat16),
// tables (B,max_blocks) int32, starts (B,) int32. G = H/Kh must divide 64.
// Returns cudaGetLastError() after the launch (0 = success); unsupported
// shapes return -1.
extern "C" int paged_attention_mq_partial_fwd(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* starts, void* acc, void* m, void* l, int B, int Tq, int H,
    int Kh, int D, int bs, int max_blocks, int nrb, int dtype, float scale,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Kh <= 0 || H % Kh != 0 || R % (H / Kh) != 0 || B <= 0 || Tq <= 0) return -1;
#define LAUNCH(TT, DD)                                                       \
  return launch<TT, DD>(q, k_pool, v_pool, tables, starts, acc, m, l, B, Tq, \
                        H, Kh, bs, max_blocks, nrb, scale, s)
  if (dtype == 0 && D == 128) LAUNCH(float, 128);
  if (dtype == 0 && D == 64) LAUNCH(float, 64);
  if (dtype == 0 && D == 16) LAUNCH(float, 16);
  if (dtype == 1 && D == 128) LAUNCH(__nv_bfloat16, 128);
  if (dtype == 1 && D == 64) LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && D == 16) LAUNCH(__nv_bfloat16, 16);
#undef LAUNCH
  return -1;
}
