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
// operations; the crossover is T near 74. Two kernels, chosen by the caller
// (`kernel`, multiquery_kernel_route in the wrapper):
//
// paged_mq_wgmma_kernel (bfloat16, D in {64, 128}; what the served models
// run): both products on the tensor cores, as in flash_attention.cu and
// with its helpers (wgmma.cuh). A warpgroup owns 64 query rows of one
// (slot, KV head): 64/G positions times the G heads that share the KV head,
// row R being position R / G, head kh*G + R % G, so the tile is runs of G*D
// contiguous bf16, loaded once into the 128-byte-swizzled layout; a CTA has
// `warpgroups` (1 or 3) of them. The history comes in 64-row K/V tiles
// through a two-stage cp.async ring with the same swizzle: the span's block
// ids are read into shared memory once, each row is looked up through them
// (any block size) and rows at or past starts[b] are zero-filled. S = Q.K^T
// is an m64n64k16 wgmma from shared memory; the online softmax runs on its
// f32 fragments with the uniform mask (only the ragged last tile has masked
// columns, whose p is exactly 0); P is rounded to bf16 in registers (the
// Pallas kernel's p.astype(v.dtype)) and fed as the A operand of O += P.V
// (V read MN-major). A decode- or hit-sized suffix (T*G <= 256) runs one
// warpgroup per CTA (more, smaller CTAs), a chunk three (each K/V tile
// serves 192 query rows). When the grid is small (B * Kh * ceil(T*G /
// (64*warpgroups)) CTAs under the card's 132 SMs, at most four query
// tiles per (slot, KV head)), the history is split in
// n_split spans of span_rows rows across CTAs, as the decode read does:
// dead spans exit at once and paged_mq_combine_kernel merges the
// ceil(min(starts, window) / span_rows) live ones. n_split and span_rows
// come from the host's ints (multiquery_read_splits in the wrapper); a
// chunk-sized suffix (T = 512) already fills the card and is never split.
//
// paged_mq_kernel (float32, and D = 16): the first port, f32 FMA tiles. A
// TF32 product would miss the f32 tolerance (1e-4) and the card-vs-CPU
// greedy identity of the tiny f32 engine, so f32 stays here. Grid (B, Kh,
// ceil(T / TQ)), 256 threads. A CTA owns R = 64 query rows of one (slot, KV
// head): TQ = 64 / G query positions times the G heads that share the KV
// head. It walks only the ceil(starts[b] / 32) history tiles of 32 rows the
// slot holds, looking each row's block up in the table itself. Per tile: K
// and V are widened to f32 in shared memory (K with a padded stride); each
// warp owns 8 query rows and each lane one history row, so the scores stay
// in registers through the warp's max/sum shuffles; then each thread adds
// its 64*D/256 output accumulators (registers) from the probability tile.
// Query rows at or past T are masked: warps whose rows all lie past T skip
// the tile, and nothing is written for such rows. About 75 KB of shared
// memory at D = 128, so three CTAs share an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "wgmma.cuh"

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

namespace tc {

using namespace wg;  // swz, desc, the fences and the wgmma products

constexpr int BN = 64;  // history rows per K/V tile
constexpr float NEG_INF = ls::NEG_INF;

template <int D, int NWG>
size_t smem_bytes(int max_blk) {
  // alignment, Q, 2 x (K, V), the span's block ids
  return 1024 + size_t(64 * NWG) * D * 2 + 4 * size_t(BN) * D * 2 + sizeof(int) * max_blk;
}

template <int D, int NWG>
__global__ void __launch_bounds__(128 * NWG, 1)
paged_mq_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ kp,
                      const __nv_bfloat16* __restrict__ vp, const int* __restrict__ tables,
                      const int* __restrict__ starts, float* __restrict__ acc_out,
                      float* __restrict__ m_out, float* __restrict__ l_out, int Tq, int H,
                      int Kh, int bs, int max_blocks, int nrb, int n_split, int span_rows,
                      float scale, float scale_log2) {
  static_assert(D == 64 || D == 128, "the tensor-core read takes D in {64, 128}");
  constexpr int BM = 64 * NWG;  // query rows per CTA
  constexpr int NT = 128 * NWG;
  constexpr uint32_t Q_BYTES = BM * D * 2;
  constexpr uint32_t KV_BYTES = BN * D * 2;
  constexpr int CPR = D / 8;      // 16-byte chunks per row
  constexpr int RPP = NT / CPR;   // rows per copy pass
  static_assert(NT % CPR == 0 && RPP % 8 == 0, "passes must keep the swizzle phase");
  extern __shared__ uint8_t smem_raw[];
  // the swizzle repeats every 1024 bytes: align the tiles to it
  uint8_t* sm = smem_raw + ((1024 - (ls::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Qs = sm;
  uint8_t* Ks = sm + Q_BYTES;       // 2 stages
  uint8_t* Vs = Ks + 2 * KV_BYTES;  // 2 stages
  int* blk = reinterpret_cast<int*>(Vs + 2 * KV_BYTES);  // the span's block ids

  const int qt = blockIdx.x;
  const int kh = blockIdx.y;
  const int b = blockIdx.z / n_split;
  const int split = blockIdx.z % n_split;
  const int G = H / Kh;
  const int n_qrows = Tq * G;  // query rows of this (slot, KV head): row R = (t, g)
  const int start = max(0, min(starts[b], nrb * bs));
  const int r0 = split * span_rows;
  if (split > 0 && r0 >= start) return;  // a dead span: the combine reads live ones only
  const int nrows = max(0, min(span_rows, start - r0));
  const int n_kt = (nrows + BN - 1) / BN;
  const int tid = threadIdx.x;
  const int wgi = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int q0w = qt * BM + wgi * 64;              // this warpgroup's first query row
  const int row0 = q0w + warp * 16 + (lane >> 2);  // this thread's rows: row0, row0 + 8
  const bool wg_live = q0w < n_qrows;
  const int cc = tid % CPR;  // the copies: chunk column cc of rows rq + j * RPP
  const int rq = tid / CPR;
  const uint32_t KhD = (uint32_t)Kh * D;

  const int blk0 = r0 / bs;
  const int n_blk = nrows > 0 ? (r0 + nrows - 1) / bs - blk0 + 1 : 0;
  for (int i = tid; i < n_blk; i += NT) blk[i] = tables[(size_t)b * max_blocks + blk0 + i];

  // Q: row R of the tile is position R / G, head kh * G + R % G, so the tile
  // is runs of G * D contiguous elements; rows past T * G are zero-filled
#pragma unroll
  for (int j = 0; j < (BM + RPP - 1) / RPP; ++j) {
    const int r = rq + j * RPP;
    if (BM % RPP != 0 && r >= BM) break;
    const int R = qt * BM + r;
    const bool ok = R < n_qrows;
    const int t = R / G;
    const uint32_t off = ((uint32_t)(b * Tq + t) * H + kh * G + (R - t * G)) * D + cc * 8;
    ls::cp_async16(Qs + swz<BM>(r, cc), q + (ok ? off : 0), ok ? 16 : 0);
  }
  __syncthreads();  // the block ids are in

  // history rows [kt * BN, kt * BN + BN) of the span, looked up row by row
  // through the block ids (any block size), zero-filled at or past nrows
  auto load_kv = [&](int kt) {
    uint8_t* kd = Ks + (kt & 1) * KV_BYTES + swz<BN>(rq, cc);
    uint8_t* vd = Vs + (kt & 1) * KV_BYTES + swz<BN>(rq, cc);
    const int i0 = kt * BN + rq;  // span row of this thread's first row
    int bi = (r0 + i0) / bs;
    int in = r0 + i0 - bi * bs;
#pragma unroll
    for (int j = 0; j < (BN + RPP - 1) / RPP; ++j) {
      if (BN % RPP != 0 && rq + j * RPP >= BN) break;
      const bool ok = i0 + j * RPP < nrows;
      const uint32_t off = ok ? ((uint32_t)blk[bi - blk0] * bs + in) * KhD + kh * D + cc * 8 : 0;
      ls::cp_async16(kd + j * RPP * 128, kp + off, ok ? 16 : 0);
      ls::cp_async16(vd + j * RPP * 128, vp + off, ok ? 16 : 0);
      in += RPP;
      while (in >= bs) {
        in -= bs;
        ++bi;
      }
    }
  };
  if (n_kt > 0) load_kv(0);
  ls::cp_async_commit();

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};  // in unscaled score units (the scale is positive)
  float l_r[2] = {0.f, 0.f};  // this thread's columns only; summed over the quad at the end
  const uint32_t q_base = ls::smem_u32(Qs) + wgi * 64 * 128;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1;
    ls::cp_async_wait<0>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // tile kt is in for every thread; tile kt-1's readers are done
    if (kt + 1 < n_kt) {
      load_kv(kt + 1);
      ls::cp_async_commit();
    }
    if (!wg_live) continue;
    const uint32_t k_base = ls::smem_u32(Ks + st * KV_BYTES);
    const uint32_t v_base = ls::smem_u32(Vs + st * KV_BYTES);

    // S = Q . K^T: D/16 steps of k16 (32 bytes inside a 128-byte row, then the next slab)
    float s[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t qo = (kk >> 2) * (BM * 128) + (kk & 3) * 32;
      const uint32_t ko = (kk >> 2) * (BN * 128) + (kk & 3) * 32;
      wgmma_ss(s, desc(q_base + qo, 16, 1024), desc(k_base + ko, 16, 1024), kk > 0 ? 1 : 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // the mask col < starts is the same for every query row: only the
    // ragged last tile has masked columns
    if (kt * BN + BN > nrows) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kt * BN + 8 * j + 2 * (lane & 3) + (e & 1) >= nrows) s[4 * j + e] = NEG_INF;
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

    // P in bf16 (the Pallas kernel's p.astype(v.dtype)) as the A fragments
    // of k16 step kk: history rows 16kk..16kk+15
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }

    // O += P . V: 16 rows (two 8-row groups, 2048 bytes) per step, V MN-major
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs(acc, pa[kk], desc(v_base + kk * 2048, BN * 128, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
  }

  ls::cp_async_wait<0>();  // no copy outlives the CTA (the Q tile of an empty span)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
  if (!wg_live) return;
  // the UNNORMALISED partials of rows (t, g) < (T, G); m in natural units
  const size_t out_t0 = (size_t)(b * n_split + split) * Tq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int R = row0 + 8 * r;
    if (R >= n_qrows) continue;
    const int t = R / G;
    const size_t o = (out_t0 + t) * H + (size_t)kh * G + (R - t * G);
    float* dst = acc_out + o * D + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) =
          make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    if ((lane & 3) == 0) {
      m_out[o] = (m_r[r] <= NEG_INF) ? NEG_INF : m_r[r] * scale;
      l_out[o] = l_r[r];
    }
  }
}

// Merges the live spans of slot b, query row th = t * H + h: grid (T*H, B),
// D threads; the algebra of paged_decode_combine_kernel with span_rows.
__global__ void paged_mq_combine_kernel(const float* __restrict__ acc_p,
                                        const float* __restrict__ m_p,
                                        const float* __restrict__ l_p,
                                        const int* __restrict__ starts,
                                        float* __restrict__ acc, float* __restrict__ m,
                                        float* __restrict__ l, int TH, int D, int n_split,
                                        int max_rows, int span_rows) {
  const int th = blockIdx.x;
  const int b = blockIdx.y;
  const int d = threadIdx.x;
  const int start = max(0, min(starts[b], max_rows));
  float A, M, L;  // span s of (b, th) is row (b * n_split + s) * TH + th
  ls::merge_partials(acc_p, m_p, l_p, (size_t)b * n_split * TH + th, TH,
                     (start + span_rows - 1) / span_rows, D, d, A, M, L);
  acc[((size_t)b * TH + th) * D + d] = A;
  if (d == 0) {
    m[(size_t)b * TH + th] = M;
    l[(size_t)b * TH + th] = L;
  }
}

template <int D, int NWG>
int launch(const void* q, const void* kp, const void* vp, const void* tables,
           const void* starts, void* acc, void* m, void* l, void* acc_p, void* m_p,
           void* l_p, int B, int Tq, int H, int Kh, int bs, int max_blocks, int nrb,
           int n_split, int span_rows, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D, NWG>((span_rows + bs - 1) / bs + 1);
  auto kernel = paged_mq_wgmma_kernel<D, NWG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (Tq * (H / Kh) + 64 * NWG - 1) / (64 * NWG);
  const bool direct = n_split == 1;
  kernel<<<dim3(n_qt, Kh, B * n_split), 128 * NWG, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kp),
      static_cast<const __nv_bfloat16*>(vp), static_cast<const int*>(tables),
      static_cast<const int*>(starts), static_cast<float*>(direct ? acc : acc_p),
      static_cast<float*>(direct ? m : m_p), static_cast<float*>(direct ? l : l_p), Tq, H,
      Kh, bs, max_blocks, nrb, n_split, span_rows, scale, scale * 1.4426950408889634f);
  err = cudaGetLastError();
  if (err != cudaSuccess || direct) return (int)err;
  paged_mq_combine_kernel<<<dim3(Tq * H, B), D, 0, stream>>>(
      static_cast<const float*>(acc_p), static_cast<const float*>(m_p),
      static_cast<const float*>(l_p), static_cast<const int*>(starts),
      static_cast<float*>(acc), static_cast<float*>(m), static_cast<float*>(l), Tq * H, D,
      n_split, nrb * bs, span_rows);
  return (int)cudaGetLastError();
}

}  // namespace tc

// q (B,T,H,D), pools (nb,bs,Kh*D) in q's dtype (0 = float32, 1 = bfloat16),
// tables (B,max_blocks) int32, starts (B,) int32. G = H/Kh must divide 64.
// kernel: 0 = the FMA tiles (float32, and bfloat16 at D = 16; n_split must
// be 1), 1 = the tensor cores (bfloat16 at D in {64, 128}; `warpgroups` 1
// or 3 per CTA; q and pools under 2^31 elements, which the wrapper
// checks). The history is read in n_split spans of span_rows rows (a
// multiple of 64 that covers the window nrb*bs in n_split spans); with
// n_split > 1, acc_part/m_part/l_part are (B, n_split, T, H, D) and (B,
// n_split, T, H) f32 scratch that a combine launch merges. Returns
// cudaGetLastError() after the launches (0 = success); unsupported
// arguments return -1.
extern "C" int paged_attention_mq_partial_fwd(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* starts, void* acc, void* m, void* l, void* acc_part, void* m_part,
    void* l_part, int B, int Tq, int H, int Kh, int D, int bs, int max_blocks, int nrb,
    int n_split, int span_rows, int dtype, int kernel, int warpgroups, float scale,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Kh <= 0 || H % Kh != 0 || R % (H / Kh) != 0 || B <= 0 || Tq <= 0 || n_split < 1)
    return -1;
  if (kernel == 1) {
    const int window = nrb * bs;
    if (dtype != 1 || span_rows <= 0 || span_rows % tc::BN != 0 ||
        (long long)span_rows * n_split < window ||
        (long long)span_rows * (n_split - 1) >= window || (long long)B * n_split > 65535)
      return -1;
#define LAUNCH(DD, NWG)                                                                  \
  return tc::launch<DD, NWG>(q, k_pool, v_pool, tables, starts, acc, m, l, acc_part,      \
                             m_part, l_part, B, Tq, H, Kh, bs, max_blocks, nrb, n_split, \
                             span_rows, scale, s)
    if (D == 128 && warpgroups == 1) LAUNCH(128, 1);
    if (D == 128 && warpgroups == 3) LAUNCH(128, 3);
    if (D == 64 && warpgroups == 1) LAUNCH(64, 1);
    if (D == 64 && warpgroups == 3) LAUNCH(64, 3);
#undef LAUNCH
    return -1;
  }
  if (kernel != 0 || n_split != 1) return -1;
#define LAUNCH(TT, DD)                                                       \
  return launch<TT, DD>(q, k_pool, v_pool, tables, starts, acc, m, l, B, Tq, \
                        H, Kh, bs, max_blocks, nrb, scale, s)
  if (dtype == 0 && D == 128) LAUNCH(float, 128);
  if (dtype == 0 && D == 64) LAUNCH(float, 64);
  if (dtype == 0 && D == 16) LAUNCH(float, 16);
  if (dtype == 1 && D == 16) LAUNCH(__nv_bfloat16, 16);
#undef LAUNCH
  return -1;
}
