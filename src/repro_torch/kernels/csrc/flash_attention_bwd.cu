// The backward of attention with an online softmax, causal or full,
// grouped-query heads: dQ, dK, dV from (q, k, v, dO, lse, delta).
//
// Counterpart of the reference's custom_vjp backward
// src/repro/models/attention.py:136 (bwd, a jnp scan over key chunks; not
// a pallas_call): per (query, key) pair P = exp(scale q.k - lse), zero
// where the causal mask k_pos > q_pos + (Sk - Sq) hides the key; dV = P^T
// dO; dP = dO V^T; dS = P (dP - delta) scale; dQ = dS K; dK = dS^T Q; dK
// and dV summed over the G = H / KVH query heads of each KV head. lse
// [B, H, Sq] is the forward's log-sum-exp (flash_attention.cu writes it)
// and delta [B, H, Sq] = rowsum(dO * O), both f32. Layout is the model's:
// q, dO, dQ [B, Sq, H, D]; k, v, dK, dV [B, Sk, KVH, D]. Scores are never
// stored: each pair is recomputed from q and k, so memory stays O(S D).
//
// Bound on the H100: at a TinyLlama-1.1B training layer (B=8, Sq=Sk=2048,
// H=32, KVH=4, D=64, bf16, causal) the five products are 10 D FLOPs per
// unmasked pair, 0.35 ms on the bf16 tensor cores, against 0.09 ms for the
// bytes of q, k, v, O, dO, lse, delta, dQ, dK and dV: operations bound it,
// so the products run on the tensor cores.
//
// Two launches, both deterministic (no atomics: each output element is
// summed by one thread in one order):
//  * dK/dV: one block of 4 warps per (b, KV head, 64-key tile); each warp
//    owns 16 keys and keeps their dK and dV rows in f32 registers. The
//    block walks the G query heads of its KV head and, for each, the 64-row
//    query tiles at or after its causal diagonal, streaming (q, dO) tiles
//    and their lse and delta through a 2-stage cp.async ring. Per tile a
//    warp computes S^T = K q^T and dP^T = V dO^T (K and V A-fragments by
//    ldmatrix from the block's resident tiles; q and dO as B-fragments),
//    P^T, then dV += P^T dO and dK += dS^T q (P^T and dS^T repacked in
//    registers as A-fragments; dO and q as B-fragments by ldmatrix.trans).
//  * dQ: one block of 4 warps per (b, head, 64-row query tile), 16 rows a
//    warp, dQ in f32 registers; (K, V) tiles up to the causal diagonal
//    stream through the same ring. Per tile S = q K^T, dP = dO V^T, then
//    dQ += dS K (K by ldmatrix.trans).
// So S and dP are computed twice (once per launch): 7 products per pair
// where a fused single pass needs 5. Rows are padded by 16 bytes in shared
// memory, so every ldmatrix phase, transposed or not, hits 32 distinct
// banks (the forward's layout).
//
// Two variants, chosen by dtype as in the forward:
//  * bf16: mma.sync m16n8k16 with f32 accumulators. P is exp2 of the f32
//    score times scale*log2(e) less lse*log2(e); P and dS are rounded to
//    bf16 before their products (dS from the unrounded f32 P). The outputs
//    are rounded once from f32. tests/test_torch_attention_bwd.py emulates
//    these rounding points in plain torch.
//  * f32, on the CUDA cores (f32 gradients hold the reference to 1e-5,
//    which TF32 would not): one thread per key row (dK/dV) or query row
//    (dQ), accumulators in registers, the streamed tiles in shared memory
//    read as broadcasts.
// Masking sets P to 0 by selection (keys past Sk, query rows past Sq, the
// causal mask), never through exp(-1e30 - lse), so no NaN or inf appears.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;    // query rows and keys per tile
constexpr int kWarps = 4;    // 16 rows (keys or queries) each
constexpr int kThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;

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
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Fragment helpers over a shared tile of rows of LD bf16 (the accumulator
// element e of 8-column block j sits at row g + 8 (e >> 1), column
// 8 j + 2 tg + (e & 1)).
//
// c[NB][4] += A (16 rows at row0 of a, all D columns) . B^T, B the 64 rows
// of b: S = X Y^T with both operands stored row-major [rows][D].
template <int D, int LD>
__device__ __forceinline__ void mma_abt(float (&c)[kTile / 8][4],
                                        const __nv_bfloat16* a, int row0,
                                        const __nv_bfloat16* b, int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    const int ra = row0 + (lane & 7) + 8 * ((lane >> 3) & 1);
    ldsm_x4(smem_u32(a + ra * LD + kk * 16 + 8 * (lane >> 4)), af);
#pragma unroll
    for (int nb = 0; nb < kTile / 16; ++nb) {
      uint32_t bf[4];
      const int rb = nb * 16 + (lane & 7) + 8 * (lane >> 4);
      ldsm_x4(smem_u32(b + rb * LD + kk * 16 + 8 * ((lane >> 3) & 1)), bf);
      mma_bf16(c[2 * nb], af, bf[0], bf[1]);
      mma_bf16(c[2 * nb + 1], af, bf[2], bf[3]);
    }
  }
}

// acc[D/8][4] += P (16 x 64, as packed bf16 A-fragments pf) . Z, Z the 64
// rows of z [rows][D] (ldmatrix.trans gives its column-major B-fragments)
template <int D, int LD>
__device__ __forceinline__ void mma_pz(float (&acc)[D / 8][4],
                                       const uint32_t (&pf)[kTile / 8][2],
                                       const __nv_bfloat16* z, int lane) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    const uint32_t a[4] = {pf[2 * kk][0], pf[2 * kk][1], pf[2 * kk + 1][0],
                           pf[2 * kk + 1][1]};
#pragma unroll
    for (int dn = 0; dn < D / 16; ++dn) {
      uint32_t bf[4];
      const int r = kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
      ldsm_x4_t(smem_u32(z + r * LD + dn * 16 + 8 * (lane >> 4)), bf);
      mma_bf16(acc[2 * dn], a, bf[0], bf[1]);
      mma_bf16(acc[2 * dn + 1], a, bf[2], bf[3]);
    }
  }
}

// rows [r0, r0 + 64) of a [*, stride]-strided tensor (row r at src + r *
// stride) into a shared tile; rows at or past n are zero-filled
template <int D, int LD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          size_t stride, int r0, int n,
                                          int tid) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int i = tid; i < kTile * CH; i += kThreads) {
    const int r = i / CH, c = i % CH;
    const bool in = r0 + r < n;
    cp_async16(smem_u32(dst + r * LD + c * 8),
               in ? src + (r0 + r) * stride + c * 8 : src, in ? 16 : 0);
  }
}

template <int D>
constexpr size_t smem_bytes_bf16() {
  // two resident tiles, two stages of two streamed tiles; then two stages
  // of 64 floats each of lse and delta
  return static_cast<size_t>(6 * kTile) * (D + 8) * 2 + 4 * kTile * 4;
}

// ------------------------------------------------------ bf16 dK / dV ---

template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_bf16(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
              int Sq, int Sk, int H, int KVH, int causal, float scale) {
  static_assert(D % 16 == 0, "the bf16 kernel steps D by 16 columns");
  constexpr int LD = D + 8;
  constexpr int NB = kTile / 8;   // 8-query blocks of S^T
  constexpr int ND = D / 8;       // 8-column blocks of dK, dV
  extern __shared__ uint4 smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_s = k_s + kTile * LD;
  __nv_bfloat16* q_s = v_s + kTile * LD;     // [2][kTile][LD]
  __nv_bfloat16* do_s = q_s + 2 * kTile * LD;  // [2][kTile][LD]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * kTile * LD);  // [2][64]
  float* dl_s = lse_s + 2 * kTile;                                  // [2][64]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int b = blockIdx.z, kvh = blockIdx.y, k0 = blockIdx.x * kTile;
  const int G = H / KVH;
  const int off = Sk - Sq;  // query row r sits at key position r + off
  const float scale_log2 = scale * kLog2e;

  const size_t q_step = static_cast<size_t>(H) * D;
  const size_t kv_step = static_cast<size_t>(KVH) * D;
  const __nv_bfloat16* kb = k + (static_cast<size_t>(b) * Sk * KVH + kvh) * D;
  const __nv_bfloat16* vb = v + (static_cast<size_t>(b) * Sk * KVH + kvh) * D;

  // causal: query rows below the tile's first key see none of its keys
  const int qt0 = causal ? max(0, k0 - off) / kTile : 0;
  const int n_qt = (Sq + kTile - 1) / kTile - qt0;
  const int n_steps = G * n_qt;  // (head, query tile) pairs, head-major

  load_tile<D, LD>(k_s, kb, kv_step, k0, Sk, tid);
  load_tile<D, LD>(v_s, vb, kv_step, k0, Sk, tid);
  auto load_step = [&](int stage, int i) {
    const int h = kvh * G + i / n_qt, q0 = (qt0 + i % n_qt) * kTile;
    const size_t base = (static_cast<size_t>(b) * Sq * H + h) * D;
    load_tile<D, LD>(q_s + stage * kTile * LD, q + base, q_step, q0, Sq, tid);
    load_tile<D, LD>(do_s + stage * kTile * LD, dout + base, q_step, q0, Sq,
                     tid);
    if (tid < kTile) {
      const size_t row = (static_cast<size_t>(b) * H + h) * Sq;
      const bool in = q0 + tid < Sq;
      lse_s[stage * kTile + tid] = in ? lse[row + q0 + tid] * kLog2e : 0.f;
      dl_s[stage * kTile + tid] = in ? delta[row + q0 + tid] : 0.f;
    }
  };
  if (n_steps > 0) load_step(0, 0);
  cp_async_commit();
  if (n_steps > 1) {
    load_step(1, 1);
    cp_async_commit();
  }

  const int kr0 = warp * 16;                  // this warp's first key
  const int key0 = k0 + kr0 + g, key1 = key0 + 8;  // its two rows' keys
  float acc_k[ND][4], acc_v[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;

  for (int i = 0; i < n_steps; ++i) {
    if (i + 1 < n_steps) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();
    const int stage = i & 1, q0 = (qt0 + i % n_qt) * kTile;
    const __nv_bfloat16* qs = q_s + stage * kTile * LD;
    const __nv_bfloat16* dos = do_s + stage * kTile * LD;
    const float* ls = lse_s + stage * kTile;
    const float* dls = dl_s + stage * kTile;
    // a warp whose keys all lie past Sk, or right of every query row's
    // diagonal in this tile, adds nothing
    const bool active = k0 + kr0 < Sk &&
        !(causal && k0 + kr0 > min(Sq, q0 + kTile) - 1 + off);
    if (active) {
      float st[NB][4];
#pragma unroll
      for (int j = 0; j < NB; ++j) st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;
      mma_abt<D, LD>(st, k_s, kr0, qs, lane);
      // P^T in f32 (kept in st) and rounded to bf16 as A-fragments
      uint32_t pf[NB][2];
#pragma unroll
      for (int j = 0; j < NB; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qr = j * 8 + 2 * tg + (e & 1);   // query row in the tile
          const int key = e < 2 ? key0 : key1;
          const bool keep = q0 + qr < Sq && key < Sk &&
                            !(causal && key > q0 + qr + off);
          st[j][e] = keep ? exp2f(st[j][e] * scale_log2 - ls[qr]) : 0.f;
        }
        pf[j][0] = pack_bf16(st[j][0], st[j][1]);
        pf[j][1] = pack_bf16(st[j][2], st[j][3]);
      }
      mma_pz<D, LD>(acc_v, pf, dos, lane);
      float dpt[NB][4];
#pragma unroll
      for (int j = 0; j < NB; ++j) dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.f;
      mma_abt<D, LD>(dpt, v_s, kr0, dos, lane);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const int qr = j * 8 + 2 * tg;
        const float d0 = dls[qr], d1 = dls[qr + 1];
        pf[j][0] = pack_bf16(st[j][0] * (dpt[j][0] - d0) * scale,
                             st[j][1] * (dpt[j][1] - d1) * scale);
        pf[j][1] = pack_bf16(st[j][2] * (dpt[j][2] - d0) * scale,
                             st[j][3] * (dpt[j][3] - d1) * scale);
      }
      mma_pz<D, LD>(acc_k, pf, qs, lane);
    }
    __syncthreads();  // every warp is done with this stage
    if (i + 2 < n_steps) {
      load_step(stage, i + 2);
      cp_async_commit();
    }
  }

  __nv_bfloat16* dk0 = dk + ((static_cast<size_t>(b) * Sk + key0) * KVH + kvh) * D;
  __nv_bfloat16* dv0 = dv + ((static_cast<size_t>(b) * Sk + key0) * KVH + kvh) * D;
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    const int c = j * 8 + 2 * tg;
    if (key0 < Sk) {
      *reinterpret_cast<uint32_t*>(dk0 + c) = pack_bf16(acc_k[j][0], acc_k[j][1]);
      *reinterpret_cast<uint32_t*>(dv0 + c) = pack_bf16(acc_v[j][0], acc_v[j][1]);
    }
    if (key1 < Sk) {
      *reinterpret_cast<uint32_t*>(dk0 + 8 * kv_step + c) =
          pack_bf16(acc_k[j][2], acc_k[j][3]);
      *reinterpret_cast<uint32_t*>(dv0 + 8 * kv_step + c) =
          pack_bf16(acc_v[j][2], acc_v[j][3]);
    }
  }
}

// ------------------------------------------------------------ bf16 dQ ---

template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_dq_bf16(const __nv_bfloat16* __restrict__ q,
            const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v,
            const __nv_bfloat16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int H, int KVH,
            int causal, float scale) {
  constexpr int LD = D + 8;
  constexpr int NB = kTile / 8;
  constexpr int ND = D / 8;
  extern __shared__ uint4 smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* do_s = q_s + kTile * LD;
  __nv_bfloat16* k_s = do_s + kTile * LD;     // [2][kTile][LD]
  __nv_bfloat16* v_s = k_s + 2 * kTile * LD;  // [2][kTile][LD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  // causal: the longest query tiles first, so the last wave is short ones
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int b = blockIdx.z, h = blockIdx.y, q0 = qt * kTile;
  const int kvh = h / (H / KVH);
  const int rows = min(kTile, Sq - q0);
  const int off = Sk - Sq;
  const float scale_log2 = scale * kLog2e;

  const size_t q_step = static_cast<size_t>(H) * D;
  const size_t kv_step = static_cast<size_t>(KVH) * D;
  const size_t qbase = (static_cast<size_t>(b) * Sq * H + h) * D;
  const __nv_bfloat16* kb = k + (static_cast<size_t>(b) * Sk * KVH + kvh) * D;
  const __nv_bfloat16* vb = v + (static_cast<size_t>(b) * Sk * KVH + kvh) * D;

  const int k_end = causal ? min(Sk, q0 + rows + off) : Sk;
  const int n_tiles = (k_end + kTile - 1) / kTile;

  load_tile<D, LD>(q_s, q + qbase, q_step, q0, Sq, tid);
  load_tile<D, LD>(do_s, dout + qbase, q_step, q0, Sq, tid);
  auto load_kv = [&](int stage, int kt) {
    load_tile<D, LD>(k_s + stage * kTile * LD, kb, kv_step, kt * kTile, Sk,
                     tid);
    load_tile<D, LD>(v_s + stage * kTile * LD, vb, kv_step, kt * kTile, Sk,
                     tid);
  };
  load_kv(0, 0);
  cp_async_commit();
  if (n_tiles > 1) {
    load_kv(1, 1);
    cp_async_commit();
  }

  const int row0 = warp * 16;
  const int r0 = row0 + g, r1 = r0 + 8;  // this lane's two rows in the tile
  const size_t lrow = (static_cast<size_t>(b) * H + h) * Sq + q0;
  const float lse0 = r0 < rows ? lse[lrow + r0] * kLog2e : 0.f;
  const float lse1 = r1 < rows ? lse[lrow + r1] * kLog2e : 0.f;
  const float dl0 = r0 < rows ? delta[lrow + r0] : 0.f;
  const float dl1 = r1 < rows ? delta[lrow + r1] : 0.f;
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();
    const int stage = t & 1, kt0 = t * kTile;
    const __nv_bfloat16* ks = k_s + stage * kTile * LD;
    const __nv_bfloat16* vs = v_s + stage * kTile * LD;
    const bool active = row0 < rows &&
        !(causal && kt0 > q0 + min(rows, row0 + 16) - 1 + off);
    if (active) {
      float s[NB][4];
#pragma unroll
      for (int j = 0; j < NB; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      mma_abt<D, LD>(s, q_s, row0, ks, lane);
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kt0 + j * 8 + 2 * tg + (e & 1);
          const int r = e < 2 ? r0 : r1;
          const bool keep = r < rows && key < Sk &&
                            !(causal && key > q0 + r + off);
          s[j][e] = keep ? exp2f(s[j][e] * scale_log2 - (e < 2 ? lse0 : lse1))
                         : 0.f;
        }
      float dp[NB][4];
#pragma unroll
      for (int j = 0; j < NB; ++j) dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
      mma_abt<D, LD>(dp, do_s, row0, vs, lane);
      uint32_t pf[NB][2];
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        pf[j][0] = pack_bf16(s[j][0] * (dp[j][0] - dl0) * scale,
                             s[j][1] * (dp[j][1] - dl0) * scale);
        pf[j][1] = pack_bf16(s[j][2] * (dp[j][2] - dl1) * scale,
                             s[j][3] * (dp[j][3] - dl1) * scale);
      }
      mma_pz<D, LD>(acc, pf, ks, lane);
    }
    __syncthreads();
    if (t + 2 < n_tiles) {
      load_kv(stage, t + 2);
      cp_async_commit();
    }
  }

  __nv_bfloat16* o0 = dq + qbase + (q0 + r0) * q_step;
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    const int c = j * 8 + 2 * tg;
    if (r0 < rows)
      *reinterpret_cast<uint32_t*>(o0 + c) = pack_bf16(acc[j][0], acc[j][1]);
    if (r1 < rows)
      *reinterpret_cast<uint32_t*>(o0 + 8 * q_step + c) =
          pack_bf16(acc[j][2], acc[j][3]);
  }
}

// ----------------------------------------------------------------- f32 ---

constexpr int kRows = 64;   // rows per block, one thread each
constexpr int kCols = 32;   // streamed rows per shared-memory tile

template <int D>
constexpr size_t smem_bytes_f32() {
  // own rows padded by 4 floats (per-thread float4 reads of 8 neighbouring
  // rows fall on distinct banks); two streamed tiles [kCols][D]; lse and
  // delta of the streamed rows
  return (static_cast<size_t>(2 * kRows) * (D + 4) + 2 * kCols * D +
          2 * kCols) * sizeof(float);
}

template <int D>
__device__ __forceinline__ float dot_f32(const float* a, const float* b) {
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const float4* b4 = reinterpret_cast<const float4*>(b);
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < D / 4; ++d) {
    const float4 x = a4[d], y = b4[d];
    s = fmaf(x.x, y.x, s);
    s = fmaf(x.y, y.y, s);
    s = fmaf(x.z, y.z, s);
    s = fmaf(x.w, y.w, s);
  }
  return s;
}

// one thread per key: its k and v rows in shared memory, its dK and dV
// rows in registers; query rows of each head stream through shared memory
template <int D>
__global__ void __launch_bounds__(kRows)
bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk,
             int H, int KVH, int causal, float scale) {
  constexpr int RS = D + 4;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);  // [kRows][RS]
  float* v_s = k_s + kRows * RS;                 // [kRows][RS]
  float* q_s = v_s + kRows * RS;                 // [kCols][D]
  float* do_s = q_s + kCols * D;                 // [kCols][D]
  float* l_s = do_s + kCols * D;                 // [kCols]
  float* dl_s = l_s + kCols;                     // [kCols]

  const int t = threadIdx.x;
  const int b = blockIdx.z, kvh = blockIdx.y, k0 = blockIdx.x * kRows;
  const int G = H / KVH, off = Sk - Sq;
  const int key = k0 + t;
  const size_t q_step = static_cast<size_t>(H) * D;
  const size_t kv_step = static_cast<size_t>(KVH) * D;
  const float* kb = k + (static_cast<size_t>(b) * Sk * KVH + kvh) * D;
  const float* vb = v + (static_cast<size_t>(b) * Sk * KVH + kvh) * D;
  for (int i = t; i < kRows * D; i += kRows) {
    const int r = i / D, c = i % D;
    const bool in = k0 + r < Sk;
    k_s[r * RS + c] = in ? kb[(k0 + r) * kv_step + c] : 0.f;
    v_s[r * RS + c] = in ? vb[(k0 + r) * kv_step + c] : 0.f;
  }
  float ak[D], av[D];
#pragma unroll
  for (int d = 0; d < D; ++d) ak[d] = av[d] = 0.f;
  const int qs0 = causal ? max(0, k0 - off) / kCols * kCols : 0;
  const float* kr = k_s + t * RS;
  const float* vr = v_s + t * RS;

  for (int gi = 0; gi < G; ++gi) {
    const int h = kvh * G + gi;
    const float* qb = q + (static_cast<size_t>(b) * Sq * H + h) * D;
    const float* ob = dout + (static_cast<size_t>(b) * Sq * H + h) * D;
    const size_t lrow = (static_cast<size_t>(b) * H + h) * Sq;
    for (int c0 = qs0; c0 < Sq; c0 += kCols) {
      const int n = min(kCols, Sq - c0);
      __syncthreads();  // the previous tile is consumed
      for (int i = t; i < kCols * D; i += kRows) {
        const int r = i / D, c = i % D;
        const bool in = r < n;
        q_s[i] = in ? qb[(c0 + r) * q_step + c] : 0.f;
        do_s[i] = in ? ob[(c0 + r) * q_step + c] : 0.f;
      }
      if (t < kCols) {
        l_s[t] = t < n ? lse[lrow + c0 + t] : 0.f;
        dl_s[t] = t < n ? delta[lrow + c0 + t] : 0.f;
      }
      __syncthreads();
      if (key >= Sk) continue;  // a ragged tile's spare threads only load
      for (int j = 0; j < n; ++j) {
        if (causal && key > c0 + j + off) continue;
        const float* qj = q_s + j * D;
        const float* oj = do_s + j * D;
        const float p = expf(scale * dot_f32<D>(qj, kr) - l_s[j]);
        const float ds = p * (dot_f32<D>(oj, vr) - dl_s[j]) * scale;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          av[d] = fmaf(p, oj[d], av[d]);
          ak[d] = fmaf(ds, qj[d], ak[d]);
        }
      }
    }
  }
  if (key < Sk) {
    float* dko = dk + ((static_cast<size_t>(b) * Sk + key) * KVH + kvh) * D;
    float* dvo = dv + ((static_cast<size_t>(b) * Sk + key) * KVH + kvh) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dko[d] = ak[d];
      dvo[d] = av[d];
    }
  }
}

// one thread per query row: its q and dO rows in shared memory, its dQ row
// in registers; (k, v) tiles stream through shared memory
template <int D>
__global__ void __launch_bounds__(kRows)
bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           float* __restrict__ dq, int Sq, int Sk, int H, int KVH,
           int causal, float scale) {
  constexpr int RS = D + 4;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [kRows][RS]
  float* do_s = q_s + kRows * RS;                // [kRows][RS]
  float* k_s = do_s + kRows * RS;                // [kCols][D]
  float* v_s = k_s + kCols * D;                  // [kCols][D]

  const int t = threadIdx.x;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kRows;
  const int kvh = h / (H / KVH);
  const int rows = min(kRows, Sq - q0);
  const int off = Sk - Sq;
  const size_t q_step = static_cast<size_t>(H) * D;
  const size_t kv_step = static_cast<size_t>(KVH) * D;
  const size_t qbase = (static_cast<size_t>(b) * Sq * H + h) * D;
  const float* kb = k + (static_cast<size_t>(b) * Sk * KVH + kvh) * D;
  const float* vb = v + (static_cast<size_t>(b) * Sk * KVH + kvh) * D;
  for (int i = t; i < kRows * D; i += kRows) {
    const int r = i / D, c = i % D;
    const bool in = r < rows;
    q_s[r * RS + c] = in ? q[qbase + (q0 + r) * q_step + c] : 0.f;
    do_s[r * RS + c] = in ? dout[qbase + (q0 + r) * q_step + c] : 0.f;
  }
  const size_t lrow = (static_cast<size_t>(b) * H + h) * Sq + q0;
  const float l = t < rows ? lse[lrow + t] : 0.f;
  const float dl = t < rows ? delta[lrow + t] : 0.f;
  const int q_pos = q0 + t + off;
  const int k_end = causal ? min(Sk, q0 + rows + off) : Sk;
  const float* qr = q_s + t * RS;
  const float* orow = do_s + t * RS;
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;

  for (int c0 = 0; c0 < k_end; c0 += kCols) {
    const int n = min(kCols, Sk - c0);
    __syncthreads();
    for (int i = t; i < kCols * D; i += kRows) {
      const int r = i / D, c = i % D;
      const bool in = r < n;
      k_s[i] = in ? kb[(c0 + r) * kv_step + c] : 0.f;
      v_s[i] = in ? vb[(c0 + r) * kv_step + c] : 0.f;
    }
    __syncthreads();
    if (t >= rows) continue;
    for (int j = 0; j < n; ++j) {
      if (causal && c0 + j > q_pos) break;
      const float* kj = k_s + j * D;
      const float p = expf(scale * dot_f32<D>(qr, kj) - l);
      const float ds = p * (dot_f32<D>(orow, v_s + j * D) - dl) * scale;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(ds, kj[d], acc[d]);
    }
  }
  if (t < rows) {
    float* o = dq + qbase + (q0 + t) * q_step;
#pragma unroll
    for (int d = 0; d < D; ++d) o[d] = acc[d];
  }
}

// ------------------------------------------------------------- launches ---

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int B, Sq, Sk, H, KVH, causal;
  float scale;
};

template <int D>
int launch_bf16(const Args& a, cudaStream_t s) {
  using T = __nv_bfloat16;
  constexpr size_t smem = smem_bytes_bf16<D>();
  cudaError_t err = allow_smem(bwd_dkdv_bf16<D>, smem);
  if (err == cudaSuccess) err = allow_smem(bwd_dq_bf16<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_kv((a.Sk + kTile - 1) / kTile, a.KVH, a.B);
  bwd_dkdv_bf16<D><<<grid_kv, kThreads, smem, s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.Sq, a.Sk, a.H,
      a.KVH, a.causal, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q((a.Sq + kTile - 1) / kTile, a.H, a.B);
  bwd_dq_bf16<D><<<grid_q, kThreads, smem, s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dq), a.Sq, a.Sk, a.H, a.KVH, a.causal,
      a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const Args& a, cudaStream_t s) {
  constexpr size_t smem = smem_bytes_f32<D>();
  cudaError_t err = allow_smem(bwd_dkdv_f32<D>, smem);
  if (err == cudaSuccess) err = allow_smem(bwd_dq_f32<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_kv((a.Sk + kRows - 1) / kRows, a.KVH, a.B);
  bwd_dkdv_f32<D><<<grid_kv, kRows, smem, s>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
      a.Sq, a.Sk, a.H, a.KVH, a.causal, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q((a.Sq + kRows - 1) / kRows, a.H, a.B);
  bwd_dq_f32<D><<<grid_q, kRows, smem, s>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(a.dq), a.Sq, a.Sk, a.H, a.KVH,
      a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, dout, dq [B, Sq, H, D]; k, v, dk, dv [B, Sk, KVH, D]; one dtype,
// contiguous (bf16 pointers 16-byte aligned); lse, delta f32 [B, H, Sq].
// B, Sq, Sk >= 1; H % KVH == 0; D in {16, 32, 64, 112, 128}; causal needs
// Sq <= Sk; scale is 1 / sqrt of the caller's true head width. Two launches
// (dK/dV, then dQ) on one stream; returns the first cudaError_t (0 =
// queued).
#define REPRO_BWD_CASE(launch, W) \
  case W:                         \
    return launch<W>(a, s);
#define REPRO_BWD_ENTRY(name, launch)                                        \
  extern "C" int name(const void* q, const void* k, const void* v,          \
                      const void* dout, const void* lse, const void* delta, \
                      void* dq, void* dk, void* dv, int B, int Sq, int Sk,  \
                      int H, int KVH, int D, int causal, float scale,       \
                      void* stream) {                                       \
    const Args a{q, k, v, dout, static_cast<const float*>(lse),             \
                 static_cast<const float*>(delta), dq, dk, dv, B, Sq, Sk,   \
                 H, KVH, causal, scale};                                    \
    const cudaStream_t s = static_cast<cudaStream_t>(stream);               \
    switch (D) {                                                            \
      REPRO_BWD_CASE(launch, 16)                                            \
      REPRO_BWD_CASE(launch, 32)                                            \
      REPRO_BWD_CASE(launch, 64)                                            \
      REPRO_BWD_CASE(launch, 112)                                           \
      REPRO_BWD_CASE(launch, 128)                                           \
      default: return static_cast<int>(cudaErrorInvalidValue);              \
    }                                                                       \
  }

REPRO_BWD_ENTRY(flash_attention_bwd_bf16, launch_bf16)
REPRO_BWD_ENTRY(flash_attention_bwd_f32, launch_f32)
