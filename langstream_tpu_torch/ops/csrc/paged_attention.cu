// Single-query paged decode read, bf16/f32 pools and int8 pools, sm_90a.
//
// Replaces: langstream_tpu/ops/paged_attention.py::_paged_kernel (called
// through paged_attention_partial) and its int8 twin _paged_kernel_q8
// (called through _paged_attention_partial_q8). Same function: for slot b
// the kernel walks the block table over the first lengths[b] cache rows
// (never past num_read_blocks blocks), scores q . k scaled by 1/sqrt(D)
// and masked at col >= length, keeps an online softmax, and returns the
// UNNORMALISED partials acc (B,H,D) f32, m (B,H) f32, l (B,H) f32 for the
// caller to merge with the in-chunk buffer segment. GQA: the G = H/Kh
// query rows [kh*G, (kh+1)*G) read KV head kh, i.e. the column slice
// [kh*D, (kh+1)*D) of each fused Kh*D pool row. int8 pools carry one f32
// scale per (row, kv head): the k scale multiplies the score, the v scale
// folds into p before the value sum (l sums the unscaled p), exactly as
// _paged_kernel_q8 and kvquant.cache_scores/cache_values do. NaN guards
// are the Pallas kernel's: NEG_INF = finfo(float32).min, a slot with
// length 0 returns m = NEG_INF, l = 0, acc = 0.
//
// What bounds it on an H100: bytes. Each cache row is read once and used
// for G (= 4 at Llama-3-8B) multiply-adds per element, far below the
// card's FLOP/byte balance point, so the floor is the K/V bytes over
// 3.35 TB/s.
//
// Design: grid (B, Kh), 128 threads; one CTA owns the G query rows of one
// KV head of one slot. Unlike the TPU's static grid, the CTA walks only
// ceil(length/32) tiles of 32 rows, so short slots cost what they read.
// Each tile's rows are looked up in the block table one by one (any block
// size works), loaded with 16-byte vector loads (coalesced across the
// row), converted to f32 into shared memory (K with a padded stride so
// the per-row dot products hit distinct banks), then: one thread per
// (query, row) score, one warp per query for the max/sum, and each
// thread keeps up to 8 of the G*D output accumulators in registers. About
// 36 KB of shared memory per CTA lets several CTAs share an SM so their
// loads overlap. No double buffering yet: later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;   // cache rows per tile (one per lane in the softmax)
constexpr int NT = 128;    // threads per CTA
constexpr int MAXJ = 8;    // accumulators per thread: G*D <= MAXJ*NT
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
template <> struct Chunk<int8_t> {
  static constexpr int N = 16;
  __device__ static void cvt(const uint4& u, float* f) {
    const int8_t* p = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int i = 0; i < 16; ++i) f[i] = static_cast<float>(p[i]);
  }
};

__host__ __device__ constexpr size_t smem_floats(int D, int G) {
  // Ks, Vs, Qs, S, m/l/alpha, k/v scales, row offsets (as int)
  return size_t(TILE) * (D + 1) + size_t(TILE) * D + size_t(G) * D +
         size_t(G) * TILE + 3 * size_t(G) + 2 * TILE + TILE;
}

template <typename TQ, typename TKV, int D, bool Q8>
__global__ void __launch_bounds__(NT)
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                    const TKV* __restrict__ vp, const float* __restrict__ ksc,
                    const float* __restrict__ vsc,
                    const int* __restrict__ tables,
                    const int* __restrict__ lengths, float* __restrict__ acc_out,
                    float* __restrict__ m_out, float* __restrict__ l_out,
                    int H, int Kh, int bs, int max_blocks, int nrb,
                    float scale) {
  constexpr int KP = D + 1;
  constexpr int EPC = Chunk<TKV>::N;  // elements per 16-byte chunk
  constexpr int CPR = D / EPC;        // chunks per row slice
  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int G = H / Kh;
  const int GD = G * D;
  const size_t KhD = (size_t)Kh * D;

  extern __shared__ float smem[];
  float* Ks = smem;                 // TILE x KP
  float* Vs = Ks + TILE * KP;       // TILE x D
  float* Qs = Vs + TILE * D;        // G x D
  float* Ss = Qs + GD;              // G x TILE
  float* m_s = Ss + G * TILE;       // G
  float* l_s = m_s + G;             // G
  float* a_s = l_s + G;             // G
  float* kscale = a_s + G;          // TILE
  float* vscale = kscale + TILE;    // TILE
  int* rowoff = reinterpret_cast<int*>(vscale + TILE);  // TILE

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const TQ* qb = q + ((size_t)b * H + (size_t)kh * G) * D;
  for (int i = tid; i < GD; i += NT) Qs[i] = to_f(qb[i]);
  for (int g = tid; g < G; g += NT) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.f;
  }
  float acc[MAXJ];
#pragma unroll
  for (int j = 0; j < MAXJ; ++j) acc[j] = 0.f;

  int length = lengths[b];
  length = max(0, min(length, nrb * bs));

  for (int t0 = 0; t0 < length; t0 += TILE) {
    __syncthreads();  // the previous tile's readers are done
    if (tid < TILE) {
      const int p = t0 + tid;
      int off = -1;
      if (p < length) off = tables[(size_t)b * max_blocks + p / bs] * bs + p % bs;
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
        Chunk<TKV>::cvt(ku, kf);
        Chunk<TKV>::cvt(vu, vf);
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
    if (Q8 && tid < TILE) {
      const int off = rowoff[tid];
      kscale[tid] = off >= 0 ? ksc[(size_t)off * Kh + kh] : 0.f;
      vscale[tid] = off >= 0 ? vsc[(size_t)off * Kh + kh] : 0.f;
    }
    __syncthreads();

    // scores: one (query g, row r) pair per thread
    for (int pr = tid; pr < G * TILE; pr += NT) {
      const int g = pr / TILE, r = pr % TILE;
      const float* qg = Qs + g * D;
      const float* kr = Ks + r * KP;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(qg[d], kr[d], s);
      if (Q8) s = s * kscale[r] * scale;
      else s = s * scale;
      Ss[g * TILE + r] = (t0 + r < length) ? s : NEG_INF;
    }
    __syncthreads();

    // online softmax: one warp per query row, one lane per cache row
    for (int g = warp; g < G; g += NT / 32) {
      const bool ok = t0 + lane < length;
      const float s = Ss[g * TILE + lane];
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      const float shift = (m_new <= NEG_INF) ? 0.f : m_new;
      const float p = ok ? expf(s - shift) : 0.f;
      float psum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      const float alpha = (m_prev <= NEG_INF) ? 0.f : expf(m_prev - shift);
      Ss[g * TILE + lane] = Q8 ? p * vscale[lane] : p;
      __syncwarp();
      if (lane == 0) {
        m_s[g] = m_new;
        l_s[g] = l_s[g] * alpha + psum;
        a_s[g] = alpha;
      }
    }
    __syncthreads();

    // value sum: each thread owns entries tid + j*NT of the G x D output
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      const int idx = tid + j * NT;
      if (idx < GD) {
        const int g = idx / D, d = idx % D;
        const float* pg = Ss + g * TILE;
        float a = acc[j] * a_s[g];
#pragma unroll 8
        for (int r = 0; r < TILE; ++r) a = fmaf(pg[r], Vs[r * D + d], a);
        acc[j] = a;
      }
    }
  }
  __syncthreads();

  float* ab = acc_out + ((size_t)b * H + (size_t)kh * G) * D;
#pragma unroll
  for (int j = 0; j < MAXJ; ++j) {
    const int idx = tid + j * NT;
    if (idx < GD) ab[idx] = acc[j];
  }
  for (int g = tid; g < G; g += NT) {
    m_out[(size_t)b * H + kh * G + g] = m_s[g];
    l_out[(size_t)b * H + kh * G + g] = l_s[g];
  }
}

template <typename TQ, typename TKV, int D, bool Q8>
int launch(const void* q, const void* kp, const void* vp, const void* ks,
           const void* vs, const void* tables, const void* lengths, void* acc,
           void* m, void* l, int B, int H, int Kh, int bs, int max_blocks,
           int nrb, float scale, cudaStream_t stream) {
  const int G = H / Kh;
  const size_t smem = sizeof(float) * smem_floats(D, G);
  auto kernel = paged_decode_kernel<TQ, TKV, D, Q8>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(B, Kh);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kp),
      static_cast<const TKV*>(vp), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<float*>(acc),
      static_cast<float*>(m), static_cast<float*>(l), H, Kh, bs, max_blocks,
      nrb, scale);
  return (int)cudaGetLastError();
}

bool shape_ok(int H, int Kh, int D) {
  return Kh > 0 && H % Kh == 0 && (H / Kh) * D <= MAXJ * NT;
}

}  // namespace

// Pools (nb, bs, Kh*D) in the query's dtype. dtype: 0 = float32,
// 1 = bfloat16. Returns cudaGetLastError() after the launch (0 = success);
// unsupported shapes return -1.
extern "C" int paged_attention_partial_fwd(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* lengths, void* acc, void* m, void* l, int B, int H, int Kh,
    int D, int bs, int max_blocks, int nrb, int dtype, float scale,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!shape_ok(H, Kh, D)) return -1;
#define LAUNCH(TQ, DD)                                                       \
  return launch<TQ, TQ, DD, false>(q, k_pool, v_pool, nullptr, nullptr,     \
                                   tables, lengths, acc, m, l, B, H, Kh, bs, \
                                   max_blocks, nrb, scale, s)
  if (dtype == 0 && D == 128) LAUNCH(float, 128);
  if (dtype == 0 && D == 64) LAUNCH(float, 64);
  if (dtype == 1 && D == 128) LAUNCH(__nv_bfloat16, 128);
  if (dtype == 1 && D == 64) LAUNCH(__nv_bfloat16, 64);
  if (dtype == 0 && D == 16) LAUNCH(float, 16);
  if (dtype == 1 && D == 16) LAUNCH(__nv_bfloat16, 16);
#undef LAUNCH
  return -1;
}

// int8 pools (nb, bs, Kh*D) with f32 scales (nb, bs, Kh); q_dtype as above.
extern "C" int paged_attention_partial_q8_fwd(
    const void* q, const void* k_q, const void* k_s, const void* v_q,
    const void* v_s, const void* tables, const void* lengths, void* acc,
    void* m, void* l, int B, int H, int Kh, int D, int bs, int max_blocks,
    int nrb, int q_dtype, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!shape_ok(H, Kh, D)) return -1;
#define LAUNCH(TQ, DD)                                                      \
  return launch<TQ, int8_t, DD, true>(q, k_q, v_q, k_s, v_s, tables,       \
                                      lengths, acc, m, l, B, H, Kh, bs,    \
                                      max_blocks, nrb, scale, s)
  if (q_dtype == 0 && D == 128) LAUNCH(float, 128);
  if (q_dtype == 0 && D == 64) LAUNCH(float, 64);
  if (q_dtype == 1 && D == 128) LAUNCH(__nv_bfloat16, 128);
  if (q_dtype == 1 && D == 64) LAUNCH(__nv_bfloat16, 64);
  if (q_dtype == 0 && D == 16) LAUNCH(float, 16);
  if (q_dtype == 1 && D == 16) LAUNCH(__nv_bfloat16, 16);
#undef LAUNCH
  return -1;
}
