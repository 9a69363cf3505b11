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
// 3.35 TB/s; no tensor cores are needed.
//
// bf16/f32 pools (paged_decode_split_kernel + paged_decode_combine_kernel,
// flash-decoding): a grid of (B, Kh) CTAs leaves most of the card idle and
// makes a call wait on the one CTA that walks the longest slot. So the
// history is split: grid (n_split, Kh, B), each CTA reads one span of
// SPLIT_ROWS rows of one slot (n_split = ceil(num_read_blocks*bs /
// SPLIT_ROWS), from the host's ints) and exits at once if its span starts
// at or past the slot's length. Its rows are looked up in the block table
// one by one (any block size works) into shared memory, then come in
// 32-row tiles through a two-stage ring of 16-byte cp.async copies in the
// pool's own type (zero-filled past the length), tile t+1 loading while
// tile t is used; one barrier per tile. Warp w owns query heads w, w+4:
// lane r scores row r (K rows padded by 16 bytes, so the 16-byte reads of
// a quarter-warp hit distinct banks), the warp's shuffles give max and
// sum, and each lane keeps D/32 output columns, with p broadcast from the
// row's lane. Each live CTA writes its partial (acc, m, l) to scratch the
// wrapper allocates; the combine kernel (grid (H, B), D threads) merges
// the ceil(length / SPLIT_ROWS) live spans of each slot with the guards of
// merge_partial_attention. With n_split == 1 the split kernel writes the
// outputs and the combine is skipped. Scratch traffic is
// B*n_split*H*(D+2)*4 bytes each way (8.5 MB at B=64, n_split=8, against
// 281 MB of K/V at Llama-3-8B width).
//
// int8 pools (paged_decode_kernel, the first port, unchanged): grid
// (B, Kh), 128 threads; one CTA owns the G query rows of one KV head of
// one slot and walks ceil(length/32) tiles of 32 rows, each loaded with
// 16-byte vector loads, converted to f32 into shared memory, then scored
// (one thread per (query, row)), softmaxed (one warp per query) and summed
// (each thread keeps up to 8 of the G*D accumulators in registers).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

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


namespace split {

constexpr int SPLIT_ROWS = 256;  // cache rows per CTA
constexpr int TILE = 32;         // rows per ring stage: one per lane
constexpr int NT = 128;
constexpr int NW = NT / 32;
constexpr int MAXGW = 2;         // query heads per warp: G <= NW * MAXGW
constexpr float NEG_INF = ls::NEG_INF;

template <int BYTES> struct Vec;
template <> struct Vec<16> { using type = uint4; };
template <> struct Vec<8> { using type = uint2; };
template <> struct Vec<4> { using type = uint32_t; };
template <> struct Vec<2> { using type = uint16_t; };

// N consecutive elements of a shared-memory row, one vector load, widened to f32.
template <typename T, int N>
__device__ __forceinline__ void load_f(const uint8_t* p, float (&f)[N]) {
  using V = typename Vec<sizeof(T) * N>::type;
  const V raw = *reinterpret_cast<const V*>(p);
  const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int e = 0; e < N; ++e) f[e] = ls::to_f(x[e]);
}

template <typename T, int D>
struct Cfg {
  static constexpr int EPC = 16 / sizeof(T);          // elements per 16-byte chunk
  static constexpr int CPR = D / EPC;                 // chunks per row
  static constexpr int KSTRIDE = D * sizeof(T) + 16;  // an odd number of chunks
  static constexpr int VSTRIDE = D * sizeof(T);
  static constexpr int STAGE = TILE * (KSTRIDE + VSTRIDE);
  static constexpr int DPL = D >= 32 ? D / 32 : 1;    // output columns per lane
};

template <typename T, int D>
size_t smem_bytes(int G) {
  return 2 * size_t(Cfg<T, D>::STAGE) + sizeof(float) * G * D + sizeof(int) * SPLIT_ROWS;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
paged_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                          const T* __restrict__ vp, const int* __restrict__ tables,
                          const int* __restrict__ lengths, float* __restrict__ acc_out,
                          float* __restrict__ m_out, float* __restrict__ l_out, int H,
                          int Kh, int bs, int max_blocks, int nrb, int n_split,
                          float scale) {
  using C = Cfg<T, D>;
  const int split = blockIdx.x;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / Kh;
  const int length = max(0, min(lengths[b], nrb * bs));
  const int r0 = split * SPLIT_ROWS;
  if (split > 0 && r0 >= length) return;  // a dead span: the combine reads live ones only
  const int nrows = max(0, min(SPLIT_ROWS, length - r0));
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t KhD = (size_t)Kh * D;

  extern __shared__ __align__(16) uint8_t smem[];
  float* Qs = reinterpret_cast<float*>(smem + 2 * C::STAGE);  // G x D
  int* rowoff = reinterpret_cast<int*>(Qs + G * D);           // pool row of each span row

  const T* qb = q + ((size_t)b * H + (size_t)kh * G) * D;
  for (int i = tid; i < G * D; i += NT) Qs[i] = ls::to_f(qb[i]);
  for (int i = tid; i < nrows; i += NT) {
    const int p = r0 + i;
    rowoff[i] = tables[(size_t)b * max_blocks + p / bs] * bs + p % bs;
  }
  __syncthreads();

  const int n_tiles = (nrows + TILE - 1) / TILE;
  auto load = [&](int t) {
    uint8_t* ks = smem + (t & 1) * C::STAGE;
    uint8_t* vs = ks + TILE * C::KSTRIDE;
    for (int i = tid; i < TILE * C::CPR; i += NT) {
      const int r = i / C::CPR, c = i % C::CPR;
      const int row = t * TILE + r;
      const bool ok = row < nrows;
      const size_t off = ok ? (size_t)rowoff[row] * KhD + (size_t)kh * D + c * C::EPC : 0;
      ls::cp_async16(ks + r * C::KSTRIDE + c * 16, kp + off, ok ? 16 : 0);
      ls::cp_async16(vs + r * C::VSTRIDE + c * 16, vp + off, ok ? 16 : 0);
    }
    ls::cp_async_commit();
  };
  if (n_tiles > 0) load(0);

  float acc[MAXGW][C::DPL], m_g[MAXGW], l_g[MAXGW];
#pragma unroll
  for (int i = 0; i < MAXGW; ++i) {
    m_g[i] = NEG_INF;
    l_g[i] = 0.f;
#pragma unroll
    for (int e = 0; e < C::DPL; ++e) acc[i][e] = 0.f;
  }
  const int col = lane * C::DPL;  // this lane's output columns [col, col + DPL)
  const bool has_col = col < D;

  for (int t = 0; t < n_tiles; ++t) {
    ls::cp_async_wait<0>();
    __syncthreads();  // tile t is in for every thread; tile t-1's readers are done
    if (t + 1 < n_tiles) load(t + 1);
    const uint8_t* ks = smem + (t & 1) * C::STAGE;
    const uint8_t* vs = ks + TILE * C::KSTRIDE;
    const bool ok = t * TILE + lane < nrows;
#pragma unroll
    for (int i = 0; i < MAXGW; ++i) {
      const int g = warp + NW * i;
      if (g >= G) break;
      const float* qg = Qs + g * D;
      const uint8_t* kr = ks + lane * C::KSTRIDE;
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < C::CPR; ++c) {
        float kf[C::EPC];
        load_f<T, C::EPC>(kr + c * 16, kf);
#pragma unroll
        for (int e = 0; e < C::EPC; ++e) s = fmaf(qg[c * C::EPC + e], kf[e], s);
      }
      s = ok ? s * scale : NEG_INF;
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_g[i], mx);
      const float shift = (m_new <= NEG_INF) ? 0.f : m_new;
      const float p = ok ? expf(s - shift) : 0.f;
      float psum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      const float alpha = (m_g[i] <= NEG_INF) ? 0.f : expf(m_g[i] - shift);
      l_g[i] = l_g[i] * alpha + psum;
      m_g[i] = m_new;
#pragma unroll
      for (int e = 0; e < C::DPL; ++e) acc[i][e] *= alpha;
#pragma unroll 8
      for (int r = 0; r < TILE; ++r) {
        const float pr = __shfl_sync(0xffffffffu, p, r);
        if (has_col) {
          float vf[C::DPL];
          load_f<T, C::DPL>(vs + r * C::VSTRIDE + col * sizeof(T), vf);
#pragma unroll
          for (int e = 0; e < C::DPL; ++e) acc[i][e] = fmaf(pr, vf[e], acc[i][e]);
        }
      }
    }
  }

  const size_t base = ((size_t)b * n_split + split) * H + (size_t)kh * G;
#pragma unroll
  for (int i = 0; i < MAXGW; ++i) {
    const int g = warp + NW * i;
    if (g >= G) break;
    if (has_col) {
#pragma unroll
      for (int e = 0; e < C::DPL; ++e) acc_out[(base + g) * D + col + e] = acc[i][e];
    }
    if (lane == 0) {
      m_out[base + g] = m_g[i];
      l_out[base + g] = l_g[i];
    }
  }
}

// Merges the live spans of slot b, head h: grid (H, B), D threads.
__global__ void paged_decode_combine_kernel(const float* __restrict__ acc_p,
                                            const float* __restrict__ m_p,
                                            const float* __restrict__ l_p,
                                            const int* __restrict__ lengths,
                                            float* __restrict__ acc, float* __restrict__ m,
                                            float* __restrict__ l, int H, int D,
                                            int n_split, int max_rows) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int d = threadIdx.x;
  const int length = max(0, min(lengths[b], max_rows));
  const int n_live = (length + SPLIT_ROWS - 1) / SPLIT_ROWS;
  const size_t row = (size_t)b * n_split * H + h;  // span s is row + s * H
  float M = NEG_INF;
  for (int s = 0; s < n_live; ++s) M = fmaxf(M, m_p[row + (size_t)s * H]);
  const float shift = (M <= NEG_INF) ? 0.f : M;
  float L = 0.f, A = 0.f;
  for (int s = 0; s < n_live; ++s) {
    const size_t r = row + (size_t)s * H;
    const float ms = m_p[r];
    const float w = (ms <= NEG_INF) ? 0.f : expf(ms - shift);
    L += l_p[r] * w;
    A += acc_p[r * D + d] * w;
  }
  acc[((size_t)b * H + h) * D + d] = A;
  if (d == 0) {
    m[(size_t)b * H + h] = M;
    l[(size_t)b * H + h] = L;
  }
}

template <typename T, int D>
int launch(const void* q, const void* kp, const void* vp, const void* tables,
           const void* lengths, void* acc, void* m, void* l, void* acc_p, void* m_p,
           void* l_p, int B, int H, int Kh, int bs, int max_blocks, int nrb, int n_split,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, D>(H / Kh);
  auto kernel = paged_decode_split_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const bool direct = n_split == 1;
  kernel<<<dim3(n_split, Kh, B), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
      static_cast<const int*>(tables), static_cast<const int*>(lengths),
      static_cast<float*>(direct ? acc : acc_p), static_cast<float*>(direct ? m : m_p),
      static_cast<float*>(direct ? l : l_p), H, Kh, bs, max_blocks, nrb, n_split, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || direct) return (int)err;
  paged_decode_combine_kernel<<<dim3(H, B), D, 0, stream>>>(
      static_cast<const float*>(acc_p), static_cast<const float*>(m_p),
      static_cast<const float*>(l_p), static_cast<const int*>(lengths),
      static_cast<float*>(acc), static_cast<float*>(m), static_cast<float*>(l), H, D,
      n_split, nrb * bs);
  return (int)cudaGetLastError();
}

}  // namespace split

// Pools (nb, bs, Kh*D) in the query's dtype. dtype: 0 = float32,
// 1 = bfloat16. acc_part/m_part/l_part: (B, n_split, H, D) and
// (B, n_split, H) f32 scratch, unused when n_split == 1. split_rows must
// be SPLIT_ROWS and n_split ceil(nrb*bs / SPLIT_ROWS): the wrapper computes
// both. Returns cudaGetLastError() after the launches (0 = success);
// unsupported shapes return -1.
extern "C" int paged_attention_partial_fwd(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* lengths, void* acc, void* m, void* l, void* acc_part, void* m_part,
    void* l_part, int B, int H, int Kh, int D, int bs, int max_blocks, int nrb,
    int n_split, int split_rows, int dtype, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int want_split = max(1, (nrb * bs + split::SPLIT_ROWS - 1) / split::SPLIT_ROWS);
  if (Kh <= 0 || H % Kh || H / Kh > split::NW * split::MAXGW ||
      split_rows != split::SPLIT_ROWS || n_split != want_split)
    return -1;
#define LAUNCH(T, DD)                                                                 \
  return split::launch<T, DD>(q, k_pool, v_pool, tables, lengths, acc, m, l, acc_part, \
                              m_part, l_part, B, H, Kh, bs, max_blocks, nrb, n_split,  \
                              scale, s)
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
