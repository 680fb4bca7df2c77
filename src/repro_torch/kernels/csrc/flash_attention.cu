// Attention with an online softmax, causal or full, grouped-query heads.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:flash_attention
// (_kernel, pallas_call at :81): f32 scores, the causal mask
// k_pos <= q_pos + (Sk - Sq) at -1e30, f32 running (m, l, acc) updated once
// per key tile, out = acc / max(l, 1e-30) rounded once to q's dtype. Layout
// is the model's: q, o [B, Sq, H, D]; k, v [B, Sk, KVH, D]; query head h
// reads KV head h / (H / KVH). Sq and Sk take any length: ragged q tiles and
// ragged key tiles are masked here (the TPU kernel asserted divisibility).
// Head widths D = 16, 32, 64, 112 and 128 are compiled; the wrapper pads any
// other D up to the next of them with zero columns (which leave every score
// unchanged) and passes the scale 1/sqrt(D) of the true D, rounded once to
// f32, so a padded launch computes the unpadded attention.
//
// Causal attention also takes the hybrid family's sliding window and meta
// tokens: the mask of the reference's jnp attention
// (src/repro/models/attention.py:50 _mask_block; the Pallas kernel has
// none). With window > 0, key j is visible to the query at position p when
// j <= p and either j > p - window or j < meta. A block loads only the key
// tiles some row of it can see (KeyTiles, in attention_mask.cuh with the
// mask itself, shared with the backward): the tiles holding meta keys,
// then those from the first row's window start to the last row's diagonal,
// so the work is proportional to the window, not to Sk. Tiles between
// them are masked for every row of the block. A row may still meet a tile
// whose keys are all masked for it before its first visible key (a window
// edge inside a tile, or no meta keys): with the finite -1e30 its running
// max stays -1e30, its p = exp2(0) = 1, and the first visible key's
// correction factor exp2(-1e30 - m) = 0 clears l and acc, as the
// reference's chunked scan does. Every row sees its own key (j = p), so no
// row ends without one. window >= Sk masks nothing more than causal and
// loads the same tiles in the same order: the causal result bit for bit.
//
// Bound on the H100: at the prefill shape (B=8, H=32, KVH=4, Sq=Sk=500,
// D=64, bf16, causal) the bytes are 37 MB (11 us at 3.35 TB/s) and the
// causal work 8.2 GFLOP (8 us on the bf16 tensor cores, 122 us on the f32
// CUDA cores): only tensor-core products can come near the byte bound.
//
// Two variants, chosen by the wrapper from the dtype:
//
//  * bf16 (flash_fwd_bf16), FA2-style on the tensor cores. A block of 4
//    warps owns 64 query rows of one (b, h), 16 rows a warp. The q tile is
//    staged once and held in registers as mma.m16n8k16 A fragments
//    (ldmatrix). 64-key K and V tiles stream through a 2-stage shared ring
//    filled by 16-byte cp.async.cg, rows padded by 16 bytes so that every
//    ldmatrix phase hits 32 distinct banks. S = q.k^T is accumulated in f32
//    on the tensor cores, then scaled by scale * log2(e) (exp2f below);
//    masked entries (causal, and keys past Sk, whose shared rows are zero)
//    are set to -1e30 and never weighed. Row max and row sum reduce over the
//    4 lanes of a quad. P is rounded to bf16 and repacked in registers as A
//    fragments; V's B fragments come from ldmatrix.trans; l sums the
//    rounded P, so the output weights are the ones the products used.
//    Key tiles wholly above a block's causal diagonal are not loaded, those
//    above a warp's are not computed. Numerics against the reference: the
//    products of bf16 inputs are exact in f32, the scale is applied after
//    the product (one f32 rounding of the scores), and P carries bf16's
//    8 bits; tests/test_torch_kernels.py emulates exactly this rounding.
//  * f32 (flash_fwd_f32), the CUDA-core kernel: f32 inputs hold the
//    reference to 1e-5, which TF32 products would not (device.py keeps TF32
//    off). One thread per query row holds its running state and D
//    accumulators; the scaled q tile and 32-key K/V tiles sit in shared
//    memory as f32.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_mask.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------- bf16 ---

constexpr int kBM = 64;        // query rows per block
constexpr int kBN = 64;        // keys per tile
constexpr int kWarpsBF = 4;    // 16 query rows each
constexpr int kThreadsBF = 32 * kWarpsBF;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one register of two bf16 (lo in the low half), RN-even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float bf16_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

template <int D>
constexpr size_t smem_bytes_bf16() {
  // q tile, then 2 stages of K and 2 of V; rows of D + 8 bf16
  return static_cast<size_t>(kBM + 4 * kBN) * (D + 8) * 2;
}

template <int D>
__global__ void __launch_bounds__(kThreadsBF)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
               float* __restrict__ o32, int Sq, int Sk, int H, int KVH,
               int causal, int window, int meta, float scale_log2) {
  static_assert(D % 16 == 0, "the bf16 kernel steps D by 16 columns");
  constexpr int LD = D + 8;       // shared row stride, bf16
  constexpr int CH = D / 8;       // 16-byte chunks per row
  constexpr int KD = D / 16;      // k-steps of q.k^T
  constexpr int NB = kBN / 8;     // 8-key blocks of S per tile
  constexpr int ND = D / 8;       // 8-column blocks of O
  extern __shared__ uint4 smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + kBM * LD;      // [2][kBN][LD]
  __nv_bfloat16* v_s = k_s + 2 * kBN * LD;  // [2][kBN][LD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;  // quad row, lane in quad
  // causal: the longest q tiles first, so the last wave is short ones
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int b = blockIdx.z, h = blockIdx.y, q0 = qt * kBM;
  const int kvh = h / (H / KVH);
  const int rows = min(kBM, Sq - q0);
  const int off = Sk - Sq;  // q row r sits at key position r + off

  const size_t q_step = static_cast<size_t>(H) * D;
  const size_t kv_step = static_cast<size_t>(KVH) * D;
  const __nv_bfloat16* qb = q + (static_cast<size_t>(b) * Sq * H + h) * D;
  const __nv_bfloat16* kb = k + (static_cast<size_t>(b) * Sk * KVH + kvh) * D;
  const __nv_bfloat16* vb = v + (static_cast<size_t>(b) * Sk * KVH + kvh) * D;

  // causal: keys past the last row's diagonal are masked for every row
  const int k_end = causal ? min(Sk, q0 + rows + off) : Sk;
  const KeyTiles tiles(k_end, kBN, q0 + off, window, meta);
  const int n_tiles = tiles.count;

  for (int i = tid; i < kBM * CH; i += kThreadsBF) {
    const int r = i / CH, c = i % CH;
    const bool in = r < rows;
    cp_async16(smem_u32(q_s + r * LD + c * 8),
               in ? qb + (q0 + r) * q_step + c * 8 : qb, in ? 16 : 0);
  }
  auto load_kv = [&](int stage, int k0) {
    __nv_bfloat16* ks = k_s + stage * kBN * LD;
    __nv_bfloat16* vs = v_s + stage * kBN * LD;
    for (int i = tid; i < kBN * CH; i += kThreadsBF) {
      const int r = i / CH, c = i % CH;
      const bool in = k0 + r < Sk;
      const size_t src = in ? (k0 + r) * kv_step + c * 8 : 0;
      cp_async16(smem_u32(ks + r * LD + c * 8), kb + src, in ? 16 : 0);
      cp_async16(smem_u32(vs + r * LD + c * 8), vb + src, in ? 16 : 0);
    }
  };
  load_kv(0, tiles.k0(0, kBN));
  cp_async_commit();
  if (n_tiles > 1) {
    load_kv(1, tiles.k0(1, kBN));
    cp_async_commit();
  }

  const int row0 = warp * 16;  // this warp's first row in the tile
  const int pw = q0 + row0 + off;  // position of the warp's first row
  // absolute key position of the diagonal of rows row0 + g and + 8
  const int diag0 = pw + g, diag1 = diag0 + 8;
  uint32_t qf[KD][4];
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // l: this lane's part

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();
    const int stage = t & 1, k0 = tiles.k0(t, kBN);
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const int r = row0 + (lane & 7) + 8 * ((lane >> 3) & 1);
        ldsm_x4(smem_u32(q_s + r * LD + kk * 16 + 8 * (lane >> 4)), qf[kk]);
      }
    }
    // a warp whose rows all sit left of this tile, or whose windows all
    // start past it (and it holds no meta key), skips it: every entry
    // would be masked, leaving (m, l, acc) as they are
    const bool active = row0 < rows && !(causal && k0 > pw + 15) &&
                        !window_hides_tile(k0, kBN, pw, window, meta);
    if (active) {
      const __nv_bfloat16* ks = k_s + stage * kBN * LD;
      const __nv_bfloat16* vs = v_s + stage * kBN * LD;
      float s[NB][4];
#pragma unroll
      for (int j = 0; j < NB; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int nb = 0; nb < NB / 2; ++nb) {  // 16 keys
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          uint32_t bf[4];
          const int r = nb * 16 + (lane & 7) + 8 * (lane >> 4);
          ldsm_x4(smem_u32(ks + r * LD + kk * 16 + 8 * ((lane >> 3) & 1)), bf);
          mma_bf16(s[2 * nb], qf[kk], bf[0], bf[1]);
          mma_bf16(s[2 * nb + 1], qf[kk], bf[2], bf[3]);
        }
      }
      const bool need_mask = k0 + kBN > Sk ||
                             (causal && k0 + kBN - 1 > pw) ||
                             window_cuts_tile(k0, pw + 15, window, meta);
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < NB; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale_log2;
          if (need_mask) {
            const int key = k0 + j * 8 + 2 * tg + (e & 1);
            const int diag = e < 2 ? diag0 : diag1;
            if (key >= Sk || !mask_visible(key, diag, causal, window, meta))
              x = kNegInf;
          }
          s[j][e] = x;
        }
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float c0 = exp2f(m0 - mx0), c1 = exp2f(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      l0 *= c0;
      l1 *= c1;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        acc[j][0] *= c0;
        acc[j][1] *= c0;
        acc[j][2] *= c1;
        acc[j][3] *= c1;
      }
      // P in bf16, as the A fragments of 16-key steps
      uint32_t pf[NB][2];
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        pf[j][0] = pack_bf16(exp2f(s[j][0] - m0), exp2f(s[j][1] - m0));
        pf[j][1] = pack_bf16(exp2f(s[j][2] - m1), exp2f(s[j][3] - m1));
        l0 += bf16_lo(pf[j][0]) + bf16_hi(pf[j][0]);
        l1 += bf16_lo(pf[j][1]) + bf16_hi(pf[j][1]);
      }
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        const uint32_t a[4] = {pf[2 * kk][0], pf[2 * kk][1],
                               pf[2 * kk + 1][0], pf[2 * kk + 1][1]};
#pragma unroll
        for (int dn = 0; dn < D / 16; ++dn) {
          uint32_t bf[4];
          const int r = kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
          ldsm_x4_t(smem_u32(vs + r * LD + dn * 16 + 8 * (lane >> 4)), bf);
          mma_bf16(acc[2 * dn], a, bf[0], bf[1]);
          mma_bf16(acc[2 * dn + 1], a, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
    if (t + 2 < n_tiles) {
      load_kv(stage, tiles.k0(t + 2, kBN));
      cp_async_commit();
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int r0 = row0 + g, r1 = r0 + 8;
  if (lse != nullptr && tg == 0) {
    // natural log-sum-exp of the scaled scores: m is in log2 units
    float* lb = lse + (static_cast<size_t>(b) * H + h) * Sq + q0;
    if (r0 < rows) lb[r0] = m0 * kLn2 + logf(fmaxf(l0, 1e-30f));
    if (r1 < rows) lb[r1] = m1 * kLn2 + logf(fmaxf(l1, 1e-30f));
  }
  const size_t at0 = ((static_cast<size_t>(b) * Sq + q0 + r0) * H + h) * D;
  __nv_bfloat16* o0 = o + at0;
  __nv_bfloat16* o1 = o0 + 8 * q_step;
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    const int c = j * 8 + 2 * tg;
    if (r0 < rows)
      *reinterpret_cast<uint32_t*>(o0 + c) =
          pack_bf16(acc[j][0] * inv0, acc[j][1] * inv0);
    if (r1 < rows)
      *reinterpret_cast<uint32_t*>(o1 + c) =
          pack_bf16(acc[j][2] * inv1, acc[j][3] * inv1);
  }
  if (o32 != nullptr) {  // the same output before its rounding to bf16
    float* p0 = o32 + at0;
    float* p1 = p0 + 8 * q_step;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int c = j * 8 + 2 * tg;
      if (r0 < rows)
        *reinterpret_cast<float2*>(p0 + c) =
            make_float2(acc[j][0] * inv0, acc[j][1] * inv0);
      if (r1 < rows)
        *reinterpret_cast<float2*>(p1 + c) =
            make_float2(acc[j][2] * inv1, acc[j][3] * inv1);
    }
  }
}

// ----------------------------------------------------------------- f32 ---

constexpr int kRows = 64;   // query rows per block, one thread each
constexpr int kKeys = 32;   // keys per shared-memory tile

template <int D>
constexpr size_t smem_bytes_f32() {
  // q tile rows padded by 4 floats: the per-thread float4 reads of 8
  // neighbouring rows then fall on distinct banks
  return (static_cast<size_t>(kRows) * (D + 4) + 2 * kKeys * D) * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kRows)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, int Sq, int Sk, int H, int KVH,
              int causal, int window, int meta, float scale) {
  constexpr int QS = D + 4;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [kRows][QS]
  float* k_s = q_s + kRows * QS;                 // [kKeys][D]
  float* v_s = k_s + kKeys * D;                  // [kKeys][D]

  const int t = threadIdx.x;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kRows;
  const int kvh = h / (H / KVH);
  const int rows = min(kRows, Sq - q0);
  const int off = Sk - Sq;  // q row r sits at key position r + off

  const size_t q_step = static_cast<size_t>(H) * D;     // between positions
  const size_t kv_step = static_cast<size_t>(KVH) * D;
  const float* qb = q + (static_cast<size_t>(b) * Sq * H + h) * D;
  const float* kb = k + (static_cast<size_t>(b) * Sk * KVH + kvh) * D;
  const float* vb = v + (static_cast<size_t>(b) * Sk * KVH + kvh) * D;

  for (int i = t; i < kRows * D; i += kRows) {
    const int r = i / D, c = i % D;
    q_s[r * QS + c] = r < rows ? qb[(q0 + r) * q_step + c] * scale : 0.f;
  }

  // causal: keys past the last row's diagonal are masked for every row
  const int k_end = causal ? min(Sk, q0 + rows + off) : Sk;
  const KeyTiles tiles(k_end, kKeys, q0 + off, window, meta);
  const int q_pos = q0 + t + off;
  const float4* q4 = reinterpret_cast<const float4*>(q_s + t * QS);

  float m = kNegInf, l = 0.f;
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;

  for (int i = 0; i < tiles.count; ++i) {
    const int k0 = tiles.k0(i, kKeys);
    const int n = min(kKeys, Sk - k0);  // keys of this tile (same for all)
    __syncthreads();  // the previous tile is consumed; q_s is written
    for (int i = t; i < kKeys * D; i += kRows) {
      const int r = i / D, c = i % D;
      const bool in = r < n;
      k_s[i] = in ? kb[(k0 + r) * kv_step + c] : 0.f;
      v_s[i] = in ? vb[(k0 + r) * kv_step + c] : 0.f;
    }
    __syncthreads();
    if (t >= rows) continue;  // a ragged tile's spare threads only load

    float s[kKeys];
#pragma unroll
    for (int j = 0; j < kKeys; ++j) s[j] = 0.f;
    for (int d4 = 0; d4 < D / 4; ++d4) {
      const float4 a = q4[d4];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float4 kk = reinterpret_cast<const float4*>(k_s + j * D)[d4];
        s[j] = fmaf(a.x, kk.x, s[j]);
        s[j] = fmaf(a.y, kk.y, s[j]);
        s[j] = fmaf(a.z, kk.z, s[j]);
        s[j] = fmaf(a.w, kk.w, s[j]);
      }
    }
    float m_new = m;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      if (j < n) {
        const int key = k0 + j;
        if (!mask_visible(key, q_pos, causal, window, meta)) s[j] = kNegInf;
        m_new = fmaxf(m_new, s[j]);
      }
    }
    const float corr = expf(m - m_new);
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= corr;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      if (j < n) {
        const float p = expf(s[j] - m_new);
        psum += p;
        const float4* v4 = reinterpret_cast<const float4*>(v_s + j * D);
#pragma unroll
        for (int d4 = 0; d4 < D / 4; ++d4) {
          const float4 vv = v4[d4];
          acc[4 * d4 + 0] = fmaf(p, vv.x, acc[4 * d4 + 0]);
          acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
          acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
          acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
        }
      }
    }
    l = l * corr + psum;
    m = m_new;
  }

  if (t < rows) {
    const float den = fmaxf(l, 1e-30f);
    if (lse != nullptr)
      lse[(static_cast<size_t>(b) * H + h) * Sq + q0 + t] = m + logf(den);
    float* ob = o + ((static_cast<size_t>(b) * Sq + q0 + t) * H + h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) ob[d] = acc[d] / den;
  }
}

// ------------------------------------------------------------- launches ---

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, float* o32, int B, int Sq, int Sk, int H, int KVH,
                int causal, int window, int meta, float scale,
                cudaStream_t s) {
  constexpr size_t smem = smem_bytes_bf16<D>();
  const cudaError_t err = allow_smem(flash_fwd_bf16<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBM - 1) / kBM, H, B);
  flash_fwd_bf16<D><<<grid, kThreadsBF, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse,
      o32, Sq, Sk, H, KVH, causal, window, meta, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, float* /* o32: o is f32 */, int B, int Sq, int Sk,
               int H, int KVH, int causal, int window, int meta, float scale,
               cudaStream_t s) {
  constexpr size_t smem = smem_bytes_f32<D>();
  const cudaError_t err = allow_smem(flash_fwd_f32<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kRows - 1) / kRows, H, B);
  flash_fwd_f32<D><<<grid, kRows, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, Sq, Sk, H,
      KVH, causal, window, meta, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o [B, Sq, H, D]; k, v [B, Sk, KVH, D]; contiguous, one dtype (bf16
// pointers 16-byte aligned). B, Sq >= 1; Sk >= 1; H % KVH == 0;
// D in {16, 32, 64, 112, 128}; causal needs Sq <= Sk; window >= 0 and
// meta >= 0, a window only with causal (window 0: no window); the scores are
// multiplied by scale (1 / sqrt of the caller's true head width). lse, f32
// [B, H, Sq], receives the natural log-sum-exp of each row's scaled scores,
// m + log(max(l, 1e-30)), for the backward; null (serving) writes none.
// o32, f32 [B, Sq, H, D] (bf16 only; null writes none), receives the
// output before its rounding to bf16, from which the backward forms delta.
// Returns the cudaError_t of the launch (0 = queued).
#define REPRO_FLASH_CASE(launch, W) \
  case W:                           \
    return launch<W>(q, k, v, o, static_cast<float*>(lse),             \
                     static_cast<float*>(o32), B, Sq, Sk, H, KVH, causal, \
                     window, meta, scale, s);
#define REPRO_FLASH_DISPATCH(launch)                   \
  switch (D) {                                         \
    REPRO_FLASH_CASE(launch, 16)                       \
    REPRO_FLASH_CASE(launch, 32)                       \
    REPRO_FLASH_CASE(launch, 64)                       \
    REPRO_FLASH_CASE(launch, 112)                      \
    REPRO_FLASH_CASE(launch, 128)                      \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* o, void* lse, void* o32, int B,
                                   int Sq, int Sk, int H, int KVH, int D,
                                   int causal, int window, int meta,
                                   float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_FLASH_DISPATCH(launch_f32)
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, void* lse,
                                    void* o32, int B, int Sq, int Sk, int H,
                                    int KVH, int D, int causal, int window,
                                    int meta, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_FLASH_DISPATCH(launch_bf16)
}
