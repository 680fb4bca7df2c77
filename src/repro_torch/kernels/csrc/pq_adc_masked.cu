// Masked ragged-pool PQ asymmetric-distance scan with exact per-query top-k.
//
// Replaces the TPU kernel src/repro/kernels/pq_adc.py:pq_adc_masked
// (_masked_kernel): per query, the ADC distance sum_m lut[q, m, code[c, m]]
// over its pooled uint8 codes, padding (id < 0) masked to 3.4e38, and the
// k nearest by (distance, pool position).
//
// Bound on the H100: device-memory bytes (a 4-byte id per candidate, M
// code bytes per real one, and the query's M x 256 LUT once). The TPU
// kernel turned the lookup into one-hot matmuls because a TPU has no
// gather unit; Hopper gathers from shared memory natively. Design:
//  * One block of kSelThreads per query copies its LUT to shared memory
//    (M KB).
//  * A thread takes kUnroll candidates a round, kSelThreads apart: it loads
//    their kUnroll ids, then the code rows of the real ones (8 bytes a load
//    when M % 8 == 0, so a warp reads 32 contiguous code rows; one byte a
//    load otherwise), so each thread has kUnroll loads in flight at each of
//    the two steps.
//  * It sums a candidate's M lookups in m order, as the plain version does,
//    and writes the key to shared memory (or to the scratch row for pools
//    too long for it) and its first radix digit to the histogram.
//  * select_topk (topk_select.cuh) then selects: one radix select, not k
//    argmin rounds.
#include "topk_select.cuh"

namespace {

constexpr int kUnroll = 8;  // candidates a thread has in flight

template <bool kSharedKeys, bool kVec8>
__global__ void __launch_bounds__(kSelThreads, 2)
pq_adc_masked_kernel(const float* __restrict__ luts, const uint8_t* __restrict__ codes,
                     const int* __restrict__ ids, uint32_t* __restrict__ scratch,
                     float* __restrict__ out_d, int* __restrict__ out_i,
                     int C, int M, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ SelectState st;
  unsigned long long* surv = reinterpret_cast<unsigned long long*>(smem);
  int* hist = reinterpret_cast<int*>(smem + kSelMaxK * 8);
  float* lut_s = reinterpret_cast<float*>(smem + kSelHeadBytes);  // [M, 256]
  const size_t qi = blockIdx.x;
  uint32_t* keys = kSharedKeys
      ? reinterpret_cast<uint32_t*>(smem + kSelHeadBytes +
                                    static_cast<size_t>(M) * 1024)
      : scratch + qi * select_stride(C);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  REPRO_PHASE(0);
  select_init(st, hist, k, C);
  const float* lut = luts + qi * static_cast<size_t>(M) * 256;
  if ((reinterpret_cast<uintptr_t>(lut) & 15) == 0) {
    for (int j = threadIdx.x; j < M * 64; j += blockDim.x)
      reinterpret_cast<float4*>(lut_s)[j] = reinterpret_cast<const float4*>(lut)[j];
  } else {
    for (int j = threadIdx.x; j < M * 256; j += blockDim.x) lut_s[j] = lut[j];
  }
  __syncthreads();
  REPRO_PHASE(1);

  const uint8_t* code_row = codes + qi * static_cast<size_t>(C) * M;
  const int* id_row = ids + qi * C;
  const uint32_t masked = float_key(REPRO_INF);
  for (int c0 = warp * 32 + lane; c0 - lane < C; c0 += kSelThreads * kUnroll) {
    unsigned real = 0;  // bit u: candidate u is a real row
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + u * kSelThreads;
      real |= (c < C && id_row[c] >= 0 ? 1u : 0u) << u;
    }
    float s[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) s[u] = 0.f;
    if (kVec8) {
      for (int m0 = 0; m0 < M; m0 += 8) {
        uint2 w[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (real >> u & 1)
            w[u] = *reinterpret_cast<const uint2*>(
                code_row + static_cast<size_t>(c0 + u * kSelThreads) * M + m0);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (!(real >> u & 1)) continue;
#pragma unroll
          for (int b = 0; b < 8; ++b) {
            const uint32_t word = b < 4 ? w[u].x : w[u].y;
            s[u] += lut_s[(m0 + b) * 256 + ((word >> (8 * (b & 3))) & 0xffu)];
          }
        }
      }
    } else {
      for (int m = 0; m < M; ++m) {
        uint32_t b[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (real >> u & 1)
            b[u] = code_row[static_cast<size_t>(c0 + u * kSelThreads) * M + m];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (real >> u & 1) s[u] += lut_s[m * 256 + b[u]];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + u * kSelThreads;
      const uint32_t key = real >> u & 1 ? float_key(s[u]) : masked;
      if (c < C) keys[c] = key;
      hist_add(hist, first_digit(key), c < C);
    }
  }
  __syncthreads();
  REPRO_PHASE(2);
  select_topk(keys, id_row, C, k, hist, surv, st, out_d + qi * k, out_i + qi * k);
}

}  // namespace

// luts [Q, M, 256] f32; codes [Q, C, M] u8; ids [Q, C] i32 (-1 = padding);
// scratch [Q, select_stride(C)] u32 keys, or null when the keys live in
// shared memory; out_d [Q, k] f32; out_i [Q, k] i32; smem: the block's
// dynamic shared bytes (select_smem). Returns the cudaError_t of the launch
// (0 = queued).
extern "C" int pq_adc_masked(const void* luts, const void* codes, const void* ids,
                             void* scratch, void* out_d, void* out_i, int Q, int C,
                             int M, int k, int smem, void* stream) {
  const bool shared_keys = scratch == nullptr;
  if (static_cast<size_t>(smem) <
      select_smem_bytes(C, static_cast<size_t>(M) * 1024, shared_keys))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec8 = (M & 7) == 0 && (reinterpret_cast<uintptr_t>(codes) & 7) == 0;
  const auto kernel = vec8 ? (shared_keys ? pq_adc_masked_kernel<true, true>
                                          : pq_adc_masked_kernel<false, true>)
                           : (shared_keys ? pq_adc_masked_kernel<true, false>
                                          : pq_adc_masked_kernel<false, false>);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<Q, kSelThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(luts), static_cast<const uint8_t*>(codes),
      static_cast<const int*>(ids), static_cast<uint32_t*>(scratch),
      static_cast<float*>(out_d), static_cast<int*>(out_i), C, M, k);
  return static_cast<int>(cudaGetLastError());
}
