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
// int8 pools (paged_decode_split_q8_mma_kernel for bf16 queries,
// paged_decode_split_q8_kernel for f32 ones, then the same combine): the
// same grid (KV heads fastest), spans, dead-span exit, row lookup and
// partial layout as the bf16 read, so paged_decode_combine_kernel merges
// their spans unchanged. The instruction budget decides the design. At
// 3.35 TB/s over 132 SMs an SM receives about 14 bytes per clock and can
// issue about 128 thread operations per clock: some 9 per int8 byte. Each
// K byte needs a conversion and G (= 4) score products, each V byte a
// conversion and G value products, so both kernels widen every int8
// element ONCE per CTA and use it for all G query heads (the bf16 layout,
// warp w owning heads w and w+4, would widen each K row once per head).
// The conversion takes no I2F (a quarter-rate unit): the byte, biased to
// unsigned, is permuted into the mantissa of 2^23 and one subtraction gives
// the exact f32 value. 64-row tiles come through a two-stage cp.async ring
// (int8 K and V rows, the rows' f32 k and v scales by 4-byte copies; one
// barrier per tile); each warp owns 16 rows of a tile and runs its own
// online softmax over them, so warps never wait on each other inside a
// tile, and the four warps' (acc, m, l) merge in shared memory with the
// combine's guards at the span's end. Numerics are the Pallas kernel's: the
// k scale multiplies the score, then `scale`; the v scale folds into p
// before the value sum; l sums the unscaled p. bf16 queries do both small
// products with mma.sync m16n8k16 (the G heads pad the n8; details at the
// kernel), the int8 rows widened to bf16 exactly and p * v_scale rounded
// to bf16, as the Pallas kernel's astype(q.dtype) do: about 2.5 issued
// operations per byte. f32 queries keep f32 FMAs (TF32 would miss the 1e-4
// tolerance of the tiny f32 engine): lane (r, c) scores rows r + 8j against
// all G heads over its quarter c of D (q in shared memory regrouped
// [c][e][g], one 16-byte read per element for the G heads), the quad's
// shuffles sum the quarters, p * v_scale goes through a per-warp scratch
// and each lane keeps D/32 output columns: about 7 operations per byte.
// Shared-memory strides are padded so a quarter-warp's 16-byte reads hit
// distinct banks (K rows 9 chunks at D=128; V rows 9 chunks, 80 bytes at
// D=64). Measured (PERF.md): the two routes differ by 7% though their
// issued operations differ by ~2.5x, so neither issue nor, from the sweeps
// there, ring depth, tile height, grid order or the shared-memory carveout
// is what holds the read at about half of the HBM rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

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

// ---- int8 pools ----------------------------------------------------------

constexpr int Q8_TILE = 64;            // rows per ring stage
constexpr int Q8_STAGES = 2;           // ring depth
constexpr int Q8_RPW = Q8_TILE / NW;   // rows per warp
constexpr int Q8_RPL = Q8_RPW / 8;     // rows per lane: lane (r, c) takes r + 8j
constexpr int Q8_MAXG = 8;             // query heads per KV head (the mma's n8)

template <int D>
struct Q8Cfg {
  static constexpr int KPL = D / 4;                  // K bytes per lane per row
  static constexpr int VPL = D >= 32 ? D / 32 : 1;   // FMA route: output columns per lane
  // K: a quarter-warp reads rows {r, r+1} x quarters 0..3, distinct bank
  // groups with 9 chunks a row at D=128 (two chunks a lane), 4 at D=64 (one).
  // V (mma route): lanes (g, t) read D/8 bytes at column (D/8)g of rows 2t,
  // 2t+1, ...: distinct banks with 9 chunks a row at D=128, 80 bytes at D=64.
  static constexpr int KSTRIDE = D == 128 ? D + 16 : D;
  static constexpr int VSTRIDE = D == 16 ? D : D + 16;
  static constexpr int KBYTES = Q8_TILE * KSTRIDE;
  static constexpr int VBYTES = Q8_TILE * VSTRIDE;
  static constexpr int STAGE = KBYTES + VBYTES + 2 * Q8_TILE * 4;  // + k, v scales
  static_assert(KBYTES % 16 == 0 && VBYTES % 16 == 0, "16-byte aligned stages");
};

template <int D, int MG>
__host__ __device__ constexpr int q8_qstride() {  // floats per quarter of q, padded
  return Q8Cfg<D>::KPL * MG + 4;
}

// the ring, which the warps' (acc, m, l) merge reuses at the end
template <int D, int MG>
__host__ __device__ constexpr size_t q8_ring_bytes() {
  return Q8_STAGES * size_t(Q8Cfg<D>::STAGE) > sizeof(float) * NW * MG * (D + 2)
             ? Q8_STAGES * size_t(Q8Cfg<D>::STAGE)
             : sizeof(float) * NW * MG * (D + 2);
}

template <int D, int MG>
__host__ __device__ constexpr size_t q8_fma_smem_bytes() {
  return q8_ring_bytes<D, MG>() + sizeof(float) * 4 * q8_qstride<D, MG>() +
         sizeof(float) * NW * Q8_RPW * MG + sizeof(int) * SPLIT_ROWS;
}

template <int D>
__host__ __device__ constexpr size_t q8_mma_smem_bytes() {
  return q8_ring_bytes<D, Q8_MAXG>() + 2 * NW * Q8_MAXG * Q8_RPW + sizeof(int) * SPLIT_ROWS;
}

// N bytes (1, 2, 4, 8, 16 or 32) of shared memory as 32-bit words, biased to unsigned.
template <int N>
__device__ __forceinline__ void load_biased(const uint8_t* p, uint32_t (&w)[(N + 3) / 4]) {
  if constexpr (N == 1) {
    w[0] = *p;
  } else if constexpr (N == 2) {
    w[0] = *reinterpret_cast<const uint16_t*>(p);
  } else if constexpr (N == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (N == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x;
    w[1] = u.y;
  } else {
#pragma unroll
    for (int i = 0; i < N / 16; ++i) {
      const uint4 u = *reinterpret_cast<const uint4*>(p + 16 * i);
      w[4 * i] = u.x;
      w[4 * i + 1] = u.y;
      w[4 * i + 2] = u.z;
      w[4 * i + 3] = u.w;
    }
  }
#pragma unroll
  for (int i = 0; i < (N + 3) / 4; ++i) w[i] ^= 0x80808080u;
}

// The four int8 of a biased word as exact f32 values: each byte into the
// mantissa of 2^23 (one permute), then one subtraction; no I2F.
__device__ __forceinline__ void i8x4_to_f(uint32_t w, float (&f)[4]) {
  f[0] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7441)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7442)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7443)) - 8388736.f;
}

// bf16x2 {lo, hi} of two f32 values that are small integers (|x| <= 128):
// their top halves, exactly.
__device__ __forceinline__ uint32_t top_halves(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// C (16 x 8 f32) += A (16 x 16 bf16, row) . B (16 x 8 bf16, col)
__device__ __forceinline__ void mma_16816(float (&c)[4], uint32_t a0, uint32_t a1,
                                          uint32_t a2, uint32_t a3, uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The span's rows through the block table into rowoff (one lookup each).
__device__ __forceinline__ void q8_lookup_rows(int* rowoff, const int* tables, int b,
                                               int max_blocks, int bs, int r0, int nrows,
                                               int tid) {
  for (int i = tid; i < nrows; i += NT) {
    const int p = r0 + i;
    rowoff[i] = tables[(size_t)b * max_blocks + p / bs] * bs + p % bs;
  }
}

// Tile t of the span (int8 K and V rows of KV head kh, then their k and v
// scales) into its ring stage; rows at or past nrows are zero-filled. The
// caller commits the group.
template <int D>
__device__ __forceinline__ void q8_load_tile(uint8_t* smem, const int8_t* kq, const float* ksc,
                                             const int8_t* vq, const float* vsc,
                                             const int* rowoff, int t, int nrows, int Kh,
                                             int kh, int tid) {
  using C = Q8Cfg<D>;
  constexpr int CPR = D / 16;    // 16-byte chunks per row
  constexpr int RPP = NT / CPR;  // rows per pass: thread tid copies chunk tid % CPR
  uint8_t* ks = smem + (t % Q8_STAGES) * C::STAGE;
  uint8_t* vs = ks + C::KBYTES;
  float* sc = reinterpret_cast<float*>(vs + C::VBYTES);  // k scales, then v scales
  const size_t KhD = (size_t)Kh * D;
  const int c = tid % CPR;
#pragma unroll
  for (int r = tid / CPR; r < Q8_TILE; r += RPP) {
    const int row = t * Q8_TILE + r;
    const bool ok = row < nrows;
    const size_t off = ok ? (size_t)rowoff[row] * KhD + (size_t)kh * D + c * 16 : 0;
    ls::cp_async16(ks + r * C::KSTRIDE + c * 16, kq + off, ok ? 16 : 0);
    ls::cp_async16(vs + r * C::VSTRIDE + c * 16, vq + off, ok ? 16 : 0);
  }
#pragma unroll
  for (int i = tid; i < 2 * Q8_TILE; i += NT) {
    const int row = t * Q8_TILE + i % Q8_TILE;
    const bool ok = row < nrows;
    const size_t off = ok ? (size_t)rowoff[row] * Kh + kh : 0;
    ls::cp_async4(sc + i, (i < Q8_TILE ? ksc : vsc) + off, ok ? 4 : 0);
  }
}

// The span's partial from the warps' (acc, m, l) that each warp wrote to
// Mw, Lw (NW x MG) and Aw (NW x MG x D).
template <int D, int MG>
__device__ __forceinline__ void q8_merge_warps(const float* Mw, const float* Lw, const float* Aw,
                                               float* acc_out, float* m_out, float* l_out,
                                               size_t base, int G, int tid) {
  for (int i = tid; i < G * D; i += NT) {
    const int g = i / D, d = i % D;
    float A, M, L;
    ls::merge_partials(Aw, Mw, Lw, g, MG, NW, D, d, A, M, L);
    acc_out[(base + g) * D + d] = A;
    if (d == 0) {
      m_out[base + g] = M;
      l_out[base + g] = L;
    }
  }
}

// f32 queries: f32 FMAs, each int8 element widened once for all G heads.
// One build for every G <= 8 (heads past G zero-padded): only the tiny f32
// engine runs this route, no served model.
template <int D>
__global__ void __launch_bounds__(NT)
paged_decode_split_q8_kernel(const float* __restrict__ q, const int8_t* __restrict__ kq,
                             const float* __restrict__ ksc, const int8_t* __restrict__ vq,
                             const float* __restrict__ vsc, const int* __restrict__ tables,
                             const int* __restrict__ lengths, float* __restrict__ acc_out,
                             float* __restrict__ m_out, float* __restrict__ l_out, int H,
                             int Kh, int bs, int max_blocks, int nrb, int n_split,
                             float scale) {
  using C = Q8Cfg<D>;
  constexpr int MG = Q8_MAXG;
  constexpr int QC = q8_qstride<D, MG>();
  constexpr int KW = C::KPL / 4;  // K words per lane per row
  const int kh = blockIdx.x;  // the KV heads of one span run side by side
  const int split = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / Kh;
  const int length = max(0, min(lengths[b], nrb * bs));
  const int r0 = split * SPLIT_ROWS;
  if (split > 0 && r0 >= length) return;  // a dead span: the combine reads live ones only
  const int nrows = max(0, min(SPLIT_ROWS, length - r0));
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int lr = lane >> 2;  // this lane's rows: lr + 8j of the warp's
  const int lc = lane & 3;   // this lane's quarter of D in the scores

  extern __shared__ __align__(16) uint8_t smem[];
  float* Qs = reinterpret_cast<float*>(smem + q8_ring_bytes<D, MG>());  // [c][e][g], 4 x QC
  float* PV = Qs + 4 * QC;                                       // NW x Q8_RPW x MG
  int* rowoff = reinterpret_cast<int*>(PV + NW * Q8_RPW * MG);  // pool row of each span row

  const float* qb = q + ((size_t)b * H + (size_t)kh * G) * D;
  for (int i = tid; i < 4 * C::KPL * MG; i += NT) {
    const int g = i % MG, e = (i / MG) % C::KPL, c = i / (MG * C::KPL);
    Qs[c * QC + e * MG + g] = g < G ? qb[g * D + c * C::KPL + e] : 0.f;
  }
  q8_lookup_rows(rowoff, tables, b, max_blocks, bs, r0, nrows, tid);
  __syncthreads();

  const int n_tiles = (nrows + Q8_TILE - 1) / Q8_TILE;
#pragma unroll
  for (int t = 0; t < Q8_STAGES - 1; ++t) {  // the ring's first tiles; empty groups keep the count
    if (t < n_tiles) q8_load_tile<D>(smem, kq, ksc, vq, vsc, rowoff, t, nrows, Kh, kh, tid);
    ls::cp_async_commit();
  }

  float acc[MG][C::VPL], m_g[MG], l_g[MG];
#pragma unroll
  for (int g = 0; g < MG; ++g) {
    m_g[g] = NEG_INF;
    l_g[g] = 0.f;
#pragma unroll
    for (int e = 0; e < C::VPL; ++e) acc[g][e] = 0.f;
  }
  const int col = lane * C::VPL;  // this lane's output columns [col, col + VPL)
  const bool has_col = col < D;
  float* pvw = PV + warp * Q8_RPW * MG;

  for (int t = 0; t < n_tiles; ++t) {
    ls::cp_async_wait<Q8_STAGES - 2>();
    __syncthreads();  // tile t is in for every thread; tile t-1's readers are done
    if (t + Q8_STAGES - 1 < n_tiles)
      q8_load_tile<D>(smem, kq, ksc, vq, vsc, rowoff, t + Q8_STAGES - 1, nrows, Kh, kh, tid);
    ls::cp_async_commit();
    const int wrow = warp * Q8_RPW;              // the warp's first row in the tile
    const int span_row = t * Q8_TILE + wrow;     // ... and in the span
    if (span_row >= nrows) continue;             // warp-uniform: nothing of the span here
    const uint8_t* ks = smem + (t % Q8_STAGES) * C::STAGE;
    const uint8_t* vs = ks + C::KBYTES;
    const float* ksc_s = reinterpret_cast<const float*>(vs + C::VBYTES);
    const float* vsc_s = ksc_s + Q8_TILE;

    // scores of rows lr + 8j against the G heads over quarter lc of D
    uint32_t kw[Q8_RPL][KW];
#pragma unroll
    for (int j = 0; j < Q8_RPL; ++j)
      load_biased<C::KPL>(ks + (wrow + lr + 8 * j) * C::KSTRIDE + lc * C::KPL, kw[j]);
    float s[Q8_RPL][MG];
#pragma unroll
    for (int j = 0; j < Q8_RPL; ++j)
#pragma unroll
      for (int g = 0; g < MG; ++g) s[j][g] = 0.f;
    const float* qc = Qs + lc * QC;
#pragma unroll
    for (int w = 0; w < KW; ++w) {
      float kf[Q8_RPL][4];
#pragma unroll
      for (int j = 0; j < Q8_RPL; ++j) i8x4_to_f(kw[j][w], kf[j]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float qv[MG];
#pragma unroll
        for (int g4 = 0; g4 < MG; g4 += 4) {
          const float4 v4 = *reinterpret_cast<const float4*>(qc + (4 * w + e) * MG + g4);
          qv[g4] = v4.x;
          qv[g4 + 1] = v4.y;
          qv[g4 + 2] = v4.z;
          qv[g4 + 3] = v4.w;
        }
#pragma unroll
        for (int g = 0; g < MG; ++g)
#pragma unroll
          for (int j = 0; j < Q8_RPL; ++j) s[j][g] = fmaf(qv[g], kf[j][e], s[j][g]);
      }
    }
    bool ok[Q8_RPL];
    float vsc_r[Q8_RPL];
#pragma unroll
    for (int j = 0; j < Q8_RPL; ++j) {
      const int r = wrow + lr + 8 * j;
      ok[j] = t * Q8_TILE + r < nrows;
      const float ksr = ksc_s[r];
      vsc_r[j] = vsc_s[r];
#pragma unroll
      for (int g = 0; g < MG; ++g) {
        float x = s[j][g];
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
        s[j][g] = ok[j] ? x * ksr * scale : NEG_INF;
      }
    }

    // online softmax of each head over the warp's rows (lanes xor 4, 8, 16)
#pragma unroll
    for (int g = 0; g < MG; ++g) {
      float mx = s[0][g];
#pragma unroll
      for (int j = 1; j < Q8_RPL; ++j) mx = fmaxf(mx, s[j][g]);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_g[g], mx);
      const float shift = (m_new <= NEG_INF) ? 0.f : m_new;
      float p[Q8_RPL], psum = 0.f;
#pragma unroll
      for (int j = 0; j < Q8_RPL; ++j) {
        p[j] = ok[j] ? expf(s[j][g] - shift) : 0.f;
        psum += p[j];
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      const float alpha = (m_g[g] <= NEG_INF) ? 0.f : expf(m_g[g] - shift);
      l_g[g] = l_g[g] * alpha + psum;
      m_g[g] = m_new;
#pragma unroll
      for (int e = 0; e < C::VPL; ++e) acc[g][e] *= alpha;
      if (lc == 0) {
#pragma unroll
        for (int j = 0; j < Q8_RPL; ++j)
          pvw[(lr + 8 * j) * MG + g] = p[j] * vsc_r[j];  // the v scale folds into p
      }
    }
    __syncwarp();

    // value sum: each lane its D/32 columns of every head, row by row
    if (has_col) {
#pragma unroll
      for (int i = 0; i < Q8_RPW; ++i) {
        uint32_t vw[1];
        load_biased<C::VPL>(vs + (wrow + i) * C::VSTRIDE + col, vw);
        float vf[4];
        i8x4_to_f(vw[0], vf);  // the first VPL are this lane's columns
        float pr[MG];
#pragma unroll
        for (int g4 = 0; g4 < MG; g4 += 4) {
          const float4 v4 = *reinterpret_cast<const float4*>(pvw + i * MG + g4);
          pr[g4] = v4.x;
          pr[g4 + 1] = v4.y;
          pr[g4 + 2] = v4.z;
          pr[g4 + 3] = v4.w;
        }
#pragma unroll
        for (int g = 0; g < MG; ++g)
#pragma unroll
          for (int e = 0; e < C::VPL; ++e) acc[g][e] = fmaf(pr[g], vf[e], acc[g][e]);
      }
    }
    __syncwarp();  // the scratch is rewritten at the next tile
  }

  // merge the four warps' (acc, m, l), reusing the ring
  __syncthreads();
  float* Mw = reinterpret_cast<float*>(smem);  // NW x MG
  float* Lw = Mw + NW * MG;                    // NW x MG
  float* Aw = Lw + NW * MG;                    // NW x MG x D
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < MG; ++g) {
      Mw[warp * MG + g] = m_g[g];
      Lw[warp * MG + g] = l_g[g];
    }
  }
  if (has_col) {
#pragma unroll
    for (int g = 0; g < MG; ++g)
#pragma unroll
      for (int e = 0; e < C::VPL; ++e) Aw[(warp * MG + g) * D + col + e] = acc[g][e];
  }
  __syncthreads();
  q8_merge_warps<D, MG>(Mw, Lw, Aw, acc_out, m_out, l_out,
                        ((size_t)b * n_split + split) * H + (size_t)kh * G, G, tid);
}

// bf16 queries: both products as mma.sync m16n8k16 bf16 with f32
// accumulators, the int8 rows widened to bf16 in registers (exact for
// |x| <= 127, the Pallas kernel's k_h.astype(q.dtype)). Each warp's 16 rows
// of a tile are one m16 tile; the G <= 8 heads of the KV head pad the n8.
// Scores S^T = K . Q^T: A is 16 K rows, and the contraction over D is
// permuted so that lane (g, t)'s A fragments of k16 step s are word s of
// its quarter t of rows g and g+8 (the layout of the FMA route), B is q in
// registers, loaded once with the same permutation. The online softmax runs
// on the accumulator fragments: lane (g, t) holds heads 2t, 2t+1 of rows g
// and g+8, so the max and sum over the warp's rows take the shuffles over g.
// Values O^T = V^T . P^T: the output columns are permuted so that lane
// (g, t)'s A fragments are D/8 contiguous bytes of rows 2t, 2t+1, 2t+8,
// 2t+9 (two rows' bytes paired by a permute); P^T (p * v_scale rounded to
// bf16, the Pallas kernel's p_h.astype(q.dtype)) goes through a per-warp
// scratch; the accumulator fragments hold heads 2t, 2t+1 as the softmax
// state does, so the rescale needs no exchange.
template <int D>
__global__ void __launch_bounds__(NT)
paged_decode_split_q8_mma_kernel(const __nv_bfloat16* __restrict__ q,
                                 const int8_t* __restrict__ kq, const float* __restrict__ ksc,
                                 const int8_t* __restrict__ vq, const float* __restrict__ vsc,
                                 const int* __restrict__ tables,
                                 const int* __restrict__ lengths, float* __restrict__ acc_out,
                                 float* __restrict__ m_out, float* __restrict__ l_out, int H,
                                 int Kh, int bs, int max_blocks, int nrb, int n_split,
                                 float scale) {
  using C = Q8Cfg<D>;
  constexpr int KS = D / 16;          // k16 steps of the scores = m16 tiles of the values
  constexpr int VB = D / 8;           // V bytes per lane per row
  constexpr int VW = (VB + 3) / 4;    // ... as 32-bit words
  static_assert(Q8_RPW == 16 && Q8_RPL == 2, "a warp's rows of a tile are one m16 tile");
  const int kh = blockIdx.x;  // the KV heads of one span run side by side
  const int split = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / Kh;
  const int length = max(0, min(lengths[b], nrb * bs));
  const int r0 = split * SPLIT_ROWS;
  if (split > 0 && r0 >= length) return;  // a dead span: the combine reads live ones only
  const int nrows = max(0, min(SPLIT_ROWS, length - r0));
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;  // score rows gq, gq+8; q head gq; value columns (D/8) gq ..
  const int tq = lane & 3;   // score quarter tq of D; value rows 2tq ..; heads 2tq, 2tq+1

  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* PT = reinterpret_cast<uint16_t*>(smem + q8_ring_bytes<D, Q8_MAXG>());  // NW x 8 x 16
  int* rowoff = reinterpret_cast<int*>(PT + NW * Q8_MAXG * Q8_RPW);

  // q as the B fragments of the scores: head gq, k16 step s holds elements
  // (D/4) tq + 4s + {0, 1} and + {2, 3}
  uint32_t qf[KS][2];
  {
    const __nv_bfloat16* qh = q + ((size_t)b * H + (size_t)kh * G + gq) * D + (D / 4) * tq;
#pragma unroll
    for (int st = 0; st < KS; ++st) {
      uint2 u = make_uint2(0u, 0u);
      if (gq < G) u = *reinterpret_cast<const uint2*>(qh + 4 * st);
      qf[st][0] = u.x;
      qf[st][1] = u.y;
    }
  }
  q8_lookup_rows(rowoff, tables, b, max_blocks, bs, r0, nrows, tid);
  __syncthreads();

  const int n_tiles = (nrows + Q8_TILE - 1) / Q8_TILE;
#pragma unroll
  for (int t = 0; t < Q8_STAGES - 1; ++t) {  // the ring's first tiles; empty groups keep the count
    if (t < n_tiles) q8_load_tile<D>(smem, kq, ksc, vq, vsc, rowoff, t, nrows, Kh, kh, tid);
    ls::cp_async_commit();
  }

  // acc[m]: O^T fragments of m16 tile m: columns (D/8) gq + 2m (+1 for
  // elements 2, 3) of heads 2tq (elements 0, 2) and 2tq + 1 (1, 3)
  float acc[KS][4];
#pragma unroll
  for (int m = 0; m < KS; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[m][e] = 0.f;
  float m_h[2] = {NEG_INF, NEG_INF};  // heads 2tq, 2tq + 1
  float l_h[2] = {0.f, 0.f};
  uint16_t* ptw = PT + warp * Q8_MAXG * Q8_RPW;  // this warp's P^T: [head][row] bf16

  for (int t = 0; t < n_tiles; ++t) {
    ls::cp_async_wait<Q8_STAGES - 2>();
    __syncthreads();  // tile t is in for every thread; tile t-1's readers are done
    if (t + Q8_STAGES - 1 < n_tiles)
      q8_load_tile<D>(smem, kq, ksc, vq, vsc, rowoff, t + Q8_STAGES - 1, nrows, Kh, kh, tid);
    ls::cp_async_commit();
    const int wrow = warp * Q8_RPW;              // the warp's first row in the tile
    const int span_row = t * Q8_TILE + wrow;     // ... and in the span
    if (span_row >= nrows) continue;             // warp-uniform: nothing of the span here
    const uint8_t* ks = smem + (t % Q8_STAGES) * C::STAGE;
    const uint8_t* vs = ks + C::KBYTES;
    const float* ksc_s = reinterpret_cast<const float*>(vs + C::VBYTES);
    const float* vsc_s = ksc_s + Q8_TILE;

    // S^T (rows gq, gq+8 x heads 2tq, 2tq+1) = K . Q^T
    uint32_t kw[2][KS];
#pragma unroll
    for (int j = 0; j < 2; ++j)
      load_biased<C::KPL>(ks + (wrow + gq + 8 * j) * C::KSTRIDE + tq * C::KPL, kw[j]);
    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int st = 0; st < KS; ++st) {
      float f0[4], f1[4];
      i8x4_to_f(kw[0][st], f0);
      i8x4_to_f(kw[1][st], f1);
      mma_16816(c, top_halves(f0[0], f0[1]), top_halves(f1[0], f1[1]),
                top_halves(f0[2], f0[3]), top_halves(f1[2], f1[3]), qf[st][0], qf[st][1]);
    }
    bool ok[2];
    float vsc_r[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = wrow + gq + 8 * j;
      ok[j] = t * Q8_TILE + r < nrows;
      const float ksr = ksc_s[r];
      vsc_r[j] = vsc_s[r];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        c[2 * j + h] = ok[j] ? c[2 * j + h] * ksr * scale : NEG_INF;
    }

    // online softmax of heads 2tq, 2tq+1 over the warp's 16 rows (lanes xor 4, 8, 16)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = fmaxf(c[h], c[2 + h]);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_h[h], mx);
      const float shift = (m_new <= NEG_INF) ? 0.f : m_new;
      const float p0 = ok[0] ? expf(c[h] - shift) : 0.f;
      const float p1 = ok[1] ? expf(c[2 + h] - shift) : 0.f;
      float psum = p0 + p1;
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      const float alpha = (m_h[h] <= NEG_INF) ? 0.f : expf(m_h[h] - shift);
      l_h[h] = l_h[h] * alpha + psum;
      m_h[h] = m_new;
#pragma unroll
      for (int m = 0; m < KS; ++m) {
        acc[m][h] *= alpha;
        acc[m][2 + h] *= alpha;
      }
      // the v scale folds into p, rounded to bf16
      __nv_bfloat16 x0 = __float2bfloat16(p0 * vsc_r[0]);
      __nv_bfloat16 x1 = __float2bfloat16(p1 * vsc_r[1]);
      ptw[(2 * tq + h) * Q8_RPW + gq] = *reinterpret_cast<uint16_t*>(&x0);
      ptw[(2 * tq + h) * Q8_RPW + gq + 8] = *reinterpret_cast<uint16_t*>(&x1);
    }
    __syncwarp();

    // O^T += V^T . P^T: B is P^T of head gq at rows 2tq, 2tq+1 (and + 8)
    const uint32_t b0 = *reinterpret_cast<const uint32_t*>(ptw + gq * Q8_RPW + 2 * tq);
    const uint32_t b1 = *reinterpret_cast<const uint32_t*>(ptw + gq * Q8_RPW + 2 * tq + 8);
    uint32_t vw[4][VW];  // rows 2tq, 2tq+1, 2tq+8, 2tq+9
#pragma unroll
    for (int i = 0; i < 4; ++i)
      load_biased<VB>(vs + (wrow + 2 * tq + (i & 1) + 8 * (i >> 1)) * C::VSTRIDE + VB * gq,
                      vw[i]);
#pragma unroll
    for (int w = 0; w < VW; ++w) {
      float f[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) i8x4_to_f(vw[i][w], f[i]);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = 2 * w + half;  // columns (D/8) gq + 2m, + 1: bytes 2 half, 2 half + 1
        if (m < KS)
          mma_16816(acc[m], top_halves(f[0][2 * half], f[1][2 * half]),
                    top_halves(f[0][2 * half + 1], f[1][2 * half + 1]),
                    top_halves(f[2][2 * half], f[3][2 * half]),
                    top_halves(f[2][2 * half + 1], f[3][2 * half + 1]), b0, b1);
      }
    }
    __syncwarp();  // the scratch is rewritten at the next tile
  }

  // merge the four warps' (acc, m, l), reusing the ring
  __syncthreads();
  float* Mw = reinterpret_cast<float*>(smem);  // NW x 8
  float* Lw = Mw + NW * Q8_MAXG;               // NW x 8
  float* Aw = Lw + NW * Q8_MAXG;               // NW x 8 x D
  if (gq == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      Mw[warp * Q8_MAXG + 2 * tq + h] = m_h[h];
      Lw[warp * Q8_MAXG + 2 * tq + h] = l_h[h];
    }
  }
#pragma unroll
  for (int m = 0; m < KS; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      Aw[(warp * Q8_MAXG + 2 * tq + (e & 1)) * D + VB * gq + 2 * m + (e >> 1)] = acc[m][e];
  __syncthreads();
  q8_merge_warps<D, Q8_MAXG>(Mw, Lw, Aw, acc_out, m_out, l_out,
                             ((size_t)b * n_split + split) * H + (size_t)kh * G, G, tid);
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
  float A, M, L;  // span s of (b, h) is row (b * n_split + s) * H + h
  ls::merge_partials(acc_p, m_p, l_p, (size_t)b * n_split * H + h, H,
                     (length + SPLIT_ROWS - 1) / SPLIT_ROWS, D, d, A, M, L);
  acc[((size_t)b * H + h) * D + d] = A;
  if (d == 0) {
    m[(size_t)b * H + h] = M;
    l[(size_t)b * H + h] = L;
  }
}

// The combine over the spans' partials; nothing to do when one span wrote the outputs.
int combine(const void* acc_p, const void* m_p, const void* l_p, const void* lengths,
            void* acc, void* m, void* l, int B, int H, int D, int n_split, int max_rows,
            cudaStream_t stream) {
  if (n_split == 1) return 0;
  paged_decode_combine_kernel<<<dim3(H, B), D, 0, stream>>>(
      static_cast<const float*>(acc_p), static_cast<const float*>(m_p),
      static_cast<const float*>(l_p), static_cast<const int*>(lengths),
      static_cast<float*>(acc), static_cast<float*>(m), static_cast<float*>(l), H, D,
      n_split, max_rows);
  return (int)cudaGetLastError();
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
  if (err != cudaSuccess) return (int)err;
  return combine(acc_p, m_p, l_p, lengths, acc, m, l, B, H, D, n_split, nrb * bs, stream);
}

// One int8 split-read kernel (with its dynamic shared memory), then the combine.
template <typename TQ, typename Kernel>
int launch_q8(Kernel kernel, size_t smem, const void* q, const void* kq, const void* ks,
              const void* vq, const void* vs, const void* tables, const void* lengths,
              void* acc, void* m, void* l, void* acc_p, void* m_p, void* l_p, int B, int H,
              int Kh, int D, int bs, int max_blocks, int nrb, int n_split, float scale,
              cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const bool direct = n_split == 1;
  // the KV heads fastest: the Kh CTAs of one span read the Kh slices of the
  // same pool rows close together in time (int8 slices are 128 bytes of a
  // 1,024-byte row at Llama-3-8B width)
  kernel<<<dim3(Kh, n_split, B), NT, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const int8_t*>(kq),
      static_cast<const float*>(ks), static_cast<const int8_t*>(vq),
      static_cast<const float*>(vs), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<float*>(direct ? acc : acc_p),
      static_cast<float*>(direct ? m : m_p), static_cast<float*>(direct ? l : l_p), H, Kh,
      bs, max_blocks, nrb, n_split, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return combine(acc_p, m_p, l_p, lengths, acc, m, l, B, H, D, n_split, nrb * bs, stream);
}

bool split_ok(int H, int Kh, int bs, int nrb, int n_split, int split_rows) {
  const int want_split = max(1, (nrb * bs + SPLIT_ROWS - 1) / SPLIT_ROWS);
  return Kh > 0 && H % Kh == 0 && H / Kh <= NW * MAXGW && split_rows == SPLIT_ROWS &&
         n_split == want_split;
}

}  // namespace split

// Pools (nb, bs, Kh*D) in the query's dtype. dtype: 0 = float32,
// 1 = bfloat16. acc_part/m_part/l_part: (B, n_split, H, D) and
// (B, n_split, H) f32 scratch, unused when n_split == 1. split_rows must
// be SPLIT_ROWS and n_split ceil(nrb*bs / SPLIT_ROWS): the wrapper computes
// both. At most 8 query heads per KV head. Returns cudaGetLastError() after
// the launches (0 = success); unsupported shapes return -1.
extern "C" int paged_attention_partial_fwd(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* lengths, void* acc, void* m, void* l, void* acc_part, void* m_part,
    void* l_part, int B, int H, int Kh, int D, int bs, int max_blocks, int nrb,
    int n_split, int split_rows, int dtype, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!split::split_ok(H, Kh, bs, nrb, n_split, split_rows)) return -1;
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

// int8 pools (nb, bs, Kh*D) with f32 scales (nb, bs, Kh); q_dtype, the
// scratch, split_rows and n_split as above.
extern "C" int paged_attention_partial_q8_fwd(
    const void* q, const void* k_q, const void* k_s, const void* v_q, const void* v_s,
    const void* tables, const void* lengths, void* acc, void* m, void* l, void* acc_part,
    void* m_part, void* l_part, int B, int H, int Kh, int D, int bs, int max_blocks,
    int nrb, int n_split, int split_rows, int q_dtype, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!split::split_ok(H, Kh, bs, nrb, n_split, split_rows)) return -1;
#define LAUNCH(TQ, KERNEL, SMEM)                                                      \
  return split::launch_q8<TQ>(KERNEL, SMEM, q, k_q, k_s, v_q, v_s, tables, lengths, acc, \
                              m, l, acc_part, m_part, l_part, B, H, Kh, D, bs,         \
                              max_blocks, nrb, n_split, scale, s)
#define LAUNCH_MMA(DD)                                                 \
  LAUNCH(__nv_bfloat16, split::paged_decode_split_q8_mma_kernel<DD>, \
         split::q8_mma_smem_bytes<DD>())
#define LAUNCH_FMA(DD)                                         \
  LAUNCH(float, split::paged_decode_split_q8_kernel<DD>,       \
         (split::q8_fma_smem_bytes<DD, split::Q8_MAXG>()))
  // bf16 queries through the tensor cores (mma.sync), f32 through FMAs
  if (q_dtype == 1 && D == 128) LAUNCH_MMA(128);
  if (q_dtype == 1 && D == 64) LAUNCH_MMA(64);
  if (q_dtype == 1 && D == 16) LAUNCH_MMA(16);
  if (q_dtype == 0 && D == 128) LAUNCH_FMA(128);
  if (q_dtype == 0 && D == 64) LAUNCH_FMA(64);
  if (q_dtype == 0 && D == 16) LAUNCH_FMA(16);
#undef LAUNCH_FMA
#undef LAUNCH_MMA
#undef LAUNCH
  return -1;
}
