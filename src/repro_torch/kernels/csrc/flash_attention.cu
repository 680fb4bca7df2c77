// Attention with an online softmax, causal or full, grouped-query heads.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:flash_attention
// (_kernel, pallas_call at :81). Same numerics: q cast to f32 and scaled by
// 1/sqrt(D) before the dot product; f32 scores; the causal mask
// k_pos <= q_pos + (Sk - Sq) at -1e30; f32 running (m, l, acc) updated once
// per key tile; out = acc / max(l, 1e-30), rounded to q's dtype. Layout is
// the model's: q, o [B, Sq, H, D]; k, v [B, Sk, KVH, D]; query head h reads
// KV head h / (H / KVH). Sq and Sk take any length: the ragged q tile and the
// ragged key tile are masked here (the TPU kernel asserted divisibility).
//
// Bound on the H100: at the prefill shape (B=8, H=32, KVH=4, Sq=Sk=500,
// D=64, bf16) the bytes are 37 MB (11 us at 3.35 TB/s) and the causal work
// 8.2 GFLOP (8 us on the bf16 tensor cores, 122 us on the f32 CUDA cores),
// so a tensor-core kernel would be bound by bytes. This one is the simple,
// right first version and is bound by its own f32 arithmetic: one block per
// (b, h, 64-query tile), one thread per query row holding its running state
// and its D accumulators in registers; the block's scaled q tile and each
// 32-key K/V tile are staged in shared memory as f32 (bf16 converted on
// load). Scores are formed d-outer so each q float4 is read once per tile
// and each K/V float4 is a broadcast read shared by the whole warp. Key
// tiles wholly above the causal diagonal of the q tile are not visited.
// Tensor-core products (mma/wgmma on bf16) and TMA staging are later work.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;   // query rows per block, one thread each
constexpr int kKeys = 32;   // keys per shared-memory tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

template <int D>
constexpr size_t smem_bytes() {
  // q tile rows padded by 4 floats: the per-thread float4 reads of 8
  // neighbouring rows then fall on distinct banks
  return (static_cast<size_t>(kRows) * (D + 4) + 2 * kKeys * D) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kRows)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk, int H,
          int KVH, int causal, float scale) {
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
  const T* qb = q + (static_cast<size_t>(b) * Sq * H + h) * D;
  const T* kb = k + (static_cast<size_t>(b) * Sk * KVH + kvh) * D;
  const T* vb = v + (static_cast<size_t>(b) * Sk * KVH + kvh) * D;

  for (int i = t; i < kRows * D; i += kRows) {
    const int r = i / D, c = i % D;
    q_s[r * QS + c] =
        r < rows ? to_f32(qb[(q0 + r) * q_step + c]) * scale : 0.f;
  }

  // causal: keys past the last row's diagonal are masked for every row
  const int k_end = causal ? min(Sk, q0 + rows + off) : Sk;
  const int q_pos = q0 + t + off;
  const float4* q4 = reinterpret_cast<const float4*>(q_s + t * QS);

  float m = kNegInf, l = 0.f;
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;

  for (int k0 = 0; k0 < k_end; k0 += kKeys) {
    const int n = min(kKeys, Sk - k0);  // keys of this tile (same for all)
    __syncthreads();  // the previous tile is consumed; q_s is written
    for (int i = t; i < kKeys * D; i += kRows) {
      const int r = i / D, c = i % D;
      const bool in = r < n;
      k_s[i] = in ? to_f32(kb[(k0 + r) * kv_step + c]) : 0.f;
      v_s[i] = in ? to_f32(vb[(k0 + r) * kv_step + c]) : 0.f;
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
        if (causal && k0 + j > q_pos) s[j] = kNegInf;
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
    T* ob = o + ((static_cast<size_t>(b) * Sq + q0 + t) * H + h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) store(ob + d, acc[d] / den);
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int Sq, int Sk, int H, int KVH, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // the scale of the reference, 1 / sqrt(D) rounded once to f32
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  const dim3 grid((Sq + kRows - 1) / kRows, H, B);
  flash_fwd<T, D><<<grid, kRows, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, KVH, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int KVH, int D, int causal, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_d<T, 32>(q, k, v, o, B, Sq, Sk, H, KVH, causal, s);
    case 64: return launch_d<T, 64>(q, k, v, o, B, Sq, Sk, H, KVH, causal, s);
    case 128: return launch_d<T, 128>(q, k, v, o, B, Sq, Sk, H, KVH, causal, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, o [B, Sq, H, D]; k, v [B, Sk, KVH, D]; contiguous, one dtype. B, Sq >= 1;
// Sk >= 1; H % KVH == 0; D in {32, 64, 128}; causal needs Sq <= Sk. Returns
// the cudaError_t of the launch (0 = queued).
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* o, int B, int Sq, int Sk, int H,
                                   int KVH, int D, int causal, void* stream) {
  return launch<float>(q, k, v, o, B, Sq, Sk, H, KVH, D, causal, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int B, int Sq,
                                    int Sk, int H, int KVH, int D, int causal,
                                    void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, KVH, D, causal,
                               stream);
}
