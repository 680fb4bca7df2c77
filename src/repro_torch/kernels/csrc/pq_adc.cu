// PQ asymmetric distances of a code table against one query's lookup table.
//
// Replaces the TPU kernel src/repro/kernels/pq_adc.py:pq_adc (_kernel):
// d[n] = sum_m lut[m, codes[n, m]], summed in the order m = 0 .. M-1.
//
// Bound on the H100: device-memory bytes (M code bytes and one 4-byte
// distance per row, the M x 256 LUT once) at one add per byte. The TPU
// kernel turned each lookup into a one-hot matmul because a TPU has no
// gather unit; Hopper gathers from shared memory natively. Every block
// copies the LUT to shared memory (M KB; above 48 KB through the dynamic
// shared-memory attribute) and each thread sums one code row's M lookups.
// On the DiskANN path a launch scores one hop's neighbours (N <= 64 at
// M = 8), so one block runs and the launch overhead sets the time.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
pq_adc_kernel(const float* __restrict__ lut, const T* __restrict__ codes,
              float* __restrict__ out, int N, int M) {
  extern __shared__ float lut_s[];  // [M, 256]
  for (int j = threadIdx.x; j < M * 256; j += blockDim.x) lut_s[j] = lut[j];
  __syncthreads();
  const size_t n = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= static_cast<size_t>(N)) return;
  const T* row = codes + n * M;
  float s = 0.f;
  for (int m = 0; m < M; ++m) {
    // codes lie in [0, 256); the mask keeps any other value inside the LUT
    s += lut_s[m * 256 + (static_cast<unsigned>(row[m]) & 255u)];
  }
  out[n] = s;
}

template <typename T>
int launch(const void* lut, const void* codes, void* out, int N, int M,
           void* stream) {
  const size_t smem = static_cast<size_t>(M) * 256 * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pq_adc_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  pq_adc_kernel<T><<<(N + kThreads - 1) / kThreads, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lut), static_cast<const T*>(codes),
      static_cast<float*>(out), N, M);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// lut [M, 256] f32; codes [N, M] u8 or i32; out [N] f32. N >= 1,
// 1 <= M <= 64. Returns the cudaError_t of the launch (0 = queued).
extern "C" int pq_adc_u8(const void* lut, const void* codes, void* out, int N,
                         int M, void* stream) {
  return launch<uint8_t>(lut, codes, out, N, M, stream);
}

extern "C" int pq_adc_i32(const void* lut, const void* codes, void* out, int N,
                          int M, void* stream) {
  return launch<int32_t>(lut, codes, out, N, M, stream);
}
