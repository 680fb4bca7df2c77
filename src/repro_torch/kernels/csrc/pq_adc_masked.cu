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
// gather unit; Hopper gathers from shared memory natively, so one block
// per query copies its LUT to shared memory (M * 1 KB; above 48 KB
// through the dynamic shared-memory attribute) and each thread sums its
// candidate's M lookups in m order. The masked distances go to a scratch row [C] that the
// wrapper allocates, and select_topk takes k exact rounds over it.
#include "topk_select.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
pq_adc_masked_kernel(const float* __restrict__ luts, const uint8_t* __restrict__ codes,
                     const int* __restrict__ ids, float* __restrict__ scratch,
                     float* __restrict__ out_d, int* __restrict__ out_i,
                     int C, int M, int k) {
  extern __shared__ float lut_s[];  // [M, 256]
  __shared__ unsigned long long red[33];
  const size_t qi = blockIdx.x;
  const float* lut = luts + qi * static_cast<size_t>(M) * 256;
  for (int j = threadIdx.x; j < M * 256; j += blockDim.x) lut_s[j] = lut[j];
  __syncthreads();

  const uint8_t* code_row = codes + qi * static_cast<size_t>(C) * M;
  const int* id_row = ids + qi * C;
  float* d_row = scratch + qi * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    if (id_row[c] < 0) {  // padding: masked without reading its codes
      d_row[c] = REPRO_INF;
      continue;
    }
    const uint8_t* cc = code_row + static_cast<size_t>(c) * M;
    float s = 0.f;
    for (int m = 0; m < M; ++m) s += lut_s[m * 256 + cc[m]];
    d_row[c] = s;
  }
  __syncthreads();
  select_topk(d_row, id_row, C, k, out_d + qi * k, out_i + qi * k, red);
}

}  // namespace

// luts [Q, M, 256] f32; codes [Q, C, M] u8; ids [Q, C] i32 (-1 = padding);
// scratch [Q, C] f32; out_d [Q, k] f32; out_i [Q, k] i32. Returns the
// cudaError_t of the launch (0 = queued).
extern "C" int pq_adc_masked(const void* luts, const void* codes, const void* ids,
                             void* scratch, void* out_d, void* out_i, int Q, int C,
                             int M, int k, void* stream) {
  const size_t smem = static_cast<size_t>(M) * 256 * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pq_adc_masked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  pq_adc_masked_kernel<<<Q, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(luts), static_cast<const uint8_t*>(codes),
      static_cast<const int*>(ids), static_cast<float*>(scratch),
      static_cast<float*>(out_d), static_cast<int*>(out_i), C, M, k);
  return static_cast<int>(cudaGetLastError());
}
