// Masked ragged-pool squared-L2 scan with exact per-query top-k.
//
// Replaces the TPU kernel src/repro/kernels/l2_topk.py:l2_topk_masked
// (_masked_kernel + _select_topk): per query, d2 = max(|q|^2 - 2 q.x +
// |x|^2, 0) over its candidate pool, padding (id < 0) masked to 3.4e38,
// and the k nearest by (d2, pool position).
//
// Bound on the H100: device-memory bytes. Every real pool row is read once
// (d * 4 bytes; padding rows are masked from their id alone) for about 4
// flops per 4 bytes, far below the card's balance point, so the tensor
// cores would not help. Design: one
// block per query keeps q in shared memory; each warp reads whole
// candidate rows coalesced (16 bytes a lane for f32 rows with d % 4 == 0)
// and shuffle-reduces q.x and |x|^2 in f32. The masked distances go to a
// scratch row [C] that the wrapper allocates (it stays in L2 for the
// selection); select_topk then takes k exact rounds over it.
#include <cuda_bf16.h>

#include "topk_select.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
l2_topk_masked_kernel(const float* __restrict__ q, const T* __restrict__ pools,
                      const int* __restrict__ ids, float* __restrict__ scratch,
                      float* __restrict__ out_d, int* __restrict__ out_i,
                      int C, int d, int k) {
  extern __shared__ float q_s[];  // [d]
  __shared__ unsigned long long red[33];
  __shared__ float qn_s;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const size_t qi = blockIdx.x;

  for (int j = threadIdx.x; j < d; j += blockDim.x) q_s[j] = q[qi * d + j];
  __syncthreads();
  if (warp == 0) {
    float s = 0.f;
    for (int j = lane; j < d; j += 32) s += q_s[j] * q_s[j];
    s = warp_sum(s);
    if (lane == 0) qn_s = s;
  }
  __syncthreads();
  const float qn = qn_s;

  const T* pool = pools + qi * static_cast<size_t>(C) * d;
  const int* id_row = ids + qi * C;
  float* d_row = scratch + qi * C;
  const bool vec4 = sizeof(T) == 4 && (d & 3) == 0 &&
                    (reinterpret_cast<uintptr_t>(pools) & 15) == 0;
  for (int c = warp; c < C; c += n_warps) {
    if (id_row[c] < 0) {  // padding: masked without reading its row
      if (lane == 0) d_row[c] = REPRO_INF;
      continue;
    }
    const T* x = pool + static_cast<size_t>(c) * d;
    float dot = 0.f, xn = 0.f;
    if (vec4) {
      const float4* x4 = reinterpret_cast<const float4*>(x);
      for (int j = lane; j < (d >> 2); j += 32) {
        const float4 v = x4[j];
        const float* qq = q_s + 4 * j;
        dot += qq[0] * v.x + qq[1] * v.y + qq[2] * v.z + qq[3] * v.w;
        xn += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
      }
    } else {
      for (int j = lane; j < d; j += 32) {
        const float v = to_f32(x[j]);
        dot += q_s[j] * v;
        xn += v * v;
      }
    }
    dot = warp_sum(dot);
    xn = warp_sum(xn);
    if (lane == 0) {
      const float d2 = qn - 2.f * dot + xn;
      d_row[c] = d2 > 0.f ? d2 : 0.f;
    }
  }
  __syncthreads();
  select_topk(d_row, id_row, C, k, out_d + qi * k, out_i + qi * k, red);
}

template <typename T>
int launch(const void* q, const void* pools, const void* ids, void* scratch,
           void* out_d, void* out_i, int Q, int C, int d, int k, void* stream) {
  l2_topk_masked_kernel<T><<<Q, kThreads, d * sizeof(float),
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const T*>(pools),
      static_cast<const int*>(ids), static_cast<float*>(scratch),
      static_cast<float*>(out_d), static_cast<int*>(out_i), C, d, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [Q, d] f32; pools [Q, C, d] f32 or bf16; ids [Q, C] i32 (-1 = padding);
// scratch [Q, C] f32; out_d [Q, k] f32; out_i [Q, k] i32. Returns the
// cudaError_t of the launch (0 = queued).
extern "C" int l2_topk_masked_f32(const void* q, const void* pools, const void* ids,
                                  void* scratch, void* out_d, void* out_i, int Q,
                                  int C, int d, int k, void* stream) {
  return launch<float>(q, pools, ids, scratch, out_d, out_i, Q, C, d, k, stream);
}

extern "C" int l2_topk_masked_bf16(const void* q, const void* pools, const void* ids,
                                   void* scratch, void* out_d, void* out_i, int Q,
                                   int C, int d, int k, void* stream) {
  return launch<__nv_bfloat16>(q, pools, ids, scratch, out_d, out_i, Q, C, d, k,
                               stream);
}
