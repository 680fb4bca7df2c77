// Masked ragged-pool squared-L2 scan with exact per-query top-k.
//
// Replaces the TPU kernel src/repro/kernels/l2_topk.py:l2_topk_masked
// (_masked_kernel + _select_topk): per query, d2 = max(|q|^2 - 2 q.x +
// |x|^2, 0) over its candidate pool, padding (id < 0) masked to 3.4e38,
// and the k nearest by (d2, pool position).
//
// Bound on the H100: device-memory bytes. Every real pool row is read once
// (d * 4 bytes, d * 2 for bf16; padding rows are masked from their id alone)
// for about 4 flops per 4 bytes, far below the card's balance point, so the
// tensor cores would not help. The design keeps enough bytes in flight to
// cover the memory latency and keeps the distances out of device memory:
//  * One block of kSelThreads (16 warps, two blocks an SM) per query; q in
//    shared memory.
//  * A warp takes 32 pool positions at a time: one coalesced load of their
//    ids (the next 32 are loaded before these are scored) and a ballot of
//    the real rows. Padding gets the masked key at once. The real rows go in
//    batches of kRows: the warp issues the loads of all kRows rows (16 bytes
//    a lane for f32 rows with d % 4 == 0, 8 bytes of 4 bf16 for bf16 rows;
//    one element a lane otherwise) before it reduces any, so each warp has
//    kRows * d * 4 bytes in flight.
//  * The 2 * kRows partial sums (q.x and |x|^2 of each row) are reduced
//    together: each shuffle step halves the values a lane holds, 10
//    shuffles for 4 rows instead of 40.
//  * Each row's key goes to shared memory (or to the scratch row for pools
//    too long for it) and its first radix digit to the histogram;
//    select_topk (topk_select.cuh) then selects without another pass over
//    device memory.
#include <cuda_bf16.h>

#include "topk_select.cuh"

namespace {

constexpr int kRows = 4;  // rows a warp has in flight before it reduces any

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// V consecutive elements from p as f32, in one access for V = 4.
__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);  // bf16 is f32's top half
  v[0] = __uint_as_float(t.x << 16);
  v[1] = __uint_as_float(t.x & 0xffff0000u);
  v[2] = __uint_as_float(t.y << 16);
  v[3] = __uint_as_float(t.y & 0xffff0000u);
}
template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[1]) { v[0] = to_f32(*p); }

// Warp sums of N values a lane at once (N a power of two <= 32). Each step
// sends half of the values to the partner lane and keeps the other half, so
// the warp shuffles N - 1 + 5 - log2(N) times. Afterwards every lane holds
// the whole sum of value lane >> (5 - log2(N)).
template <int N>
__device__ __forceinline__ float warp_sums(float (&v)[N]) {
  const int lane = threadIdx.x & 31;
  int off = 16;
#pragma unroll
  for (int n = N; n > 1; n >>= 1, off >>= 1) {
    const bool up = lane & off;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float send = up ? v[i] : v[i + n / 2];
      const float keep = up ? v[i + n / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(kFullMask, send, off);
    }
  }
  float s = v[0];
#pragma unroll
  for (; off > 0; off >>= 1) s += __shfl_xor_sync(kFullMask, s, off);
  return s;
}

template <typename T, int V, bool kSharedKeys>
__global__ void __launch_bounds__(kSelThreads, 2)
l2_topk_masked_kernel(const float* __restrict__ q, const T* __restrict__ pools,
                      const int* __restrict__ ids, uint32_t* __restrict__ scratch,
                      float* __restrict__ out_d, int* __restrict__ out_i,
                      int C, int d, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ SelectState st;
  __shared__ float qn_s;
  unsigned long long* surv = reinterpret_cast<unsigned long long*>(smem);
  int* hist = reinterpret_cast<int*>(smem + kSelMaxK * 8);
  float* q_s = reinterpret_cast<float*>(smem + kSelHeadBytes);
  const size_t qi = blockIdx.x;
  uint32_t* keys = kSharedKeys
      ? reinterpret_cast<uint32_t*>(smem + kSelHeadBytes +
                                    align16(4 * static_cast<size_t>(d)))
      : scratch + qi * select_stride(C);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  REPRO_PHASE(0);
  select_init(st, hist, k, C);
  for (int j = threadIdx.x; j < d; j += blockDim.x) q_s[j] = q[qi * d + j];
  __syncthreads();
  if (warp == 0) {
    float s = 0.f;
    for (int j = lane; j < d; j += 32) s += q_s[j] * q_s[j];
    s = warp_sum(s);
    if (lane == 0) qn_s = s;
  }
  __syncthreads();
  REPRO_PHASE(1);
  const float qn = qn_s;

  const T* pool = pools + qi * static_cast<size_t>(C) * d;
  const int* id_row = ids + qi * C;
  const uint32_t masked = float_key(REPRO_INF);
  int id = warp * 32 + lane < C ? id_row[warp * 32 + lane] : -1;
  for (int c0 = warp * 32; c0 < C; c0 += blockDim.x) {
    const int cn = c0 + blockDim.x + lane;
    const int id_next = cn < C ? id_row[cn] : -1;
    // padding: the masked key, without reading its row
    const bool pad = c0 + lane < C && id < 0;
    if (pad) keys[c0 + lane] = masked;
    hist_add(hist, first_digit(masked), pad);
    unsigned real = __ballot_sync(kFullMask, id >= 0);
    while (real) {
      int pos[kRows];  // the batch's positions (-1: none), the same in every lane
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        pos[r] = real ? c0 + __ffs(real) - 1 : -1;
        real &= real - 1;
      }
      float acc[2 * kRows];  // q.x and |x|^2 of each row, this lane's part
#pragma unroll
      for (int i = 0; i < 2 * kRows; ++i) acc[i] = 0.f;
      for (int j0 = 0; j0 < d; j0 += 32 * V) {
        const int j = j0 + lane * V;
        if (j < d) {
          float qv[V];
          load_vec(q_s + j, qv);
          float xv[kRows][V];
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            if (pos[r] >= 0) load_vec(pool + static_cast<size_t>(pos[r]) * d + j, xv[r]);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            if (pos[r] < 0) continue;
#pragma unroll
            for (int v = 0; v < V; ++v) {
              acc[2 * r] = fmaf(qv[v], xv[r][v], acc[2 * r]);
              acc[2 * r + 1] = fmaf(xv[r][v], xv[r][v], acc[2 * r + 1]);
            }
          }
        }
      }
      // row r's q.x lands in lanes 8r .. 8r+3, its |x|^2 in 8r+4 .. 8r+7
      const float dot = warp_sums<2 * kRows>(acc);
      const float xn = __shfl_xor_sync(kFullMask, dot, 4);
      int p = -1;
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if ((lane >> 3) == r) p = pos[r];
      const bool mine = (lane & 7) == 0 && p >= 0;
      const float d2 = qn - 2.f * dot + xn;
      const uint32_t key = float_key(d2 > 0.f ? d2 : 0.f);
      if (mine) keys[p] = key;
      hist_add(hist, first_digit(key), mine);
    }
    id = id_next;
  }
  __syncthreads();
  REPRO_PHASE(2);
  select_topk(keys, id_row, C, k, hist, surv, st, out_d + qi * k, out_i + qi * k);
}

template <typename T>
int launch(const void* q, const void* pools, const void* ids, void* scratch,
           void* out_d, void* out_i, int Q, int C, int d, int k, int smem,
           void* stream) {
  const bool shared_keys = scratch == nullptr;
  if (static_cast<size_t>(smem) <
      select_smem_bytes(C, 4 * static_cast<size_t>(d), shared_keys))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = (d & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(pools) & (4 * sizeof(T) - 1)) == 0;
  const auto kernel = vec ? (shared_keys ? l2_topk_masked_kernel<T, 4, true>
                                         : l2_topk_masked_kernel<T, 4, false>)
                          : (shared_keys ? l2_topk_masked_kernel<T, 1, true>
                                         : l2_topk_masked_kernel<T, 1, false>);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<Q, kSelThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const T*>(pools),
      static_cast<const int*>(ids), static_cast<uint32_t*>(scratch),
      static_cast<float*>(out_d), static_cast<int*>(out_i), C, d, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [Q, d] f32; pools [Q, C, d] f32 or bf16; ids [Q, C] i32 (-1 = padding);
// scratch [Q, select_stride(C)] u32 keys, or null when the keys live in
// shared memory; out_d [Q, k] f32; out_i [Q, k] i32; smem: the block's
// dynamic shared bytes (select_smem). Returns the cudaError_t of the launch
// (0 = queued).
extern "C" int l2_topk_masked_f32(const void* q, const void* pools, const void* ids,
                                  void* scratch, void* out_d, void* out_i, int Q,
                                  int C, int d, int k, int smem, void* stream) {
  return launch<float>(q, pools, ids, scratch, out_d, out_i, Q, C, d, k, smem, stream);
}

extern "C" int l2_topk_masked_bf16(const void* q, const void* pools, const void* ids,
                                   void* scratch, void* out_d, void* out_i, int Q,
                                   int C, int d, int k, int smem, void* stream) {
  return launch<__nv_bfloat16>(q, pools, ids, scratch, out_d, out_i, Q, C, d, k, smem,
                               stream);
}
