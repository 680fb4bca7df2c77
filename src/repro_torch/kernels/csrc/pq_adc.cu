// PQ asymmetric distances (ADC) of code rows against lookup tables.
//
// Replaces the TPU kernel src/repro/kernels/pq_adc.py:pq_adc (_kernel,
// pallas_call at :55): d[n] = sum_m lut[m, codes[n, m]], summed in the order
// m = 0 .. M-1. The TPU kernel turned each lookup into a one-hot matmul
// because a TPU has no gather unit; Hopper gathers natively. Two entry
// points:
//
//  * pq_adc (one LUT [M, 256], code rows [N, M]): every block copies the LUT
//    to shared memory (M KB; above 48 KB through the dynamic shared-memory
//    attribute) and each thread sums one code row's M lookups.
//  * pq_adc_rows (the DiskANN wave): Q LUTs [Q, M, 256] and a resident code
//    table [n, M]; row t of the launch is a node id rows[t] in the segment
//    [offsets[q], offsets[q + 1]) of query q, and d[t] sums LUT q over the
//    table row of that id. One launch scores every query's new neighbours
//    of one hop, where one launch per query and hop spent ~40 us of host and
//    launch time on ~18 rows. One block per segment; a thread reads its id,
//    then the row's M codes straight from the table (8-byte loads when M is a
//    multiple of 8), which fuses the host's gather of the code rows. The LUT
//    is read through the read-only path: a segment of ~50 rows at M = 8 reads
//    ~400 of its 2048 entries, so copying all of it to shared memory would
//    read 5x more than it uses. Long segments (the wrapper decides by the
//    mean length) take the staged variant: 256 threads copy the LUT to shared
//    memory first.
//    Bound: device-memory bytes (ids, the touched code rows and LUT entries,
//    the outputs) at one add per LUT byte; at a wave of the comparison
//    (1000 queries, ~50 rows each, M = 8) a few microseconds, so one launch
//    and its host time set the time.
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

constexpr int kRowThreads = 64;     // read-only LUT path: one row a thread
constexpr int kStageThreads = 256;  // staged LUT: the copy spreads wider

// LUT entry (m, code) of the block's query: from shared memory when staged,
// else through the read-only data cache
template <bool kStage>
__device__ __forceinline__ float lut_at(const float* lut, int m, unsigned c) {
  if (kStage) return lut[m * 256 + c];
  return __ldg(lut + m * 256 + c);
}

// kW: bytes per code load, 8 (M % 8 == 0), 4 (M % 4 == 0) or 1
template <int kW, bool kStage>
__global__ void __launch_bounds__(kStage ? kStageThreads : kRowThreads)
pq_adc_rows_kernel(const float* __restrict__ luts,
                   const uint8_t* __restrict__ table,
                   const int* __restrict__ rows, const int* __restrict__ offsets,
                   float* __restrict__ out, int n_table, int M, int T) {
  extern __shared__ float4 lut_s4[];  // [M * 64] float4 when staged
  const int q = blockIdx.x;
  const int begin = max(__ldg(offsets + q), 0);
  const int end = min(__ldg(offsets + q + 1), T);
  const float* lut = luts + static_cast<size_t>(q) * M * 256;
  if (kStage) {
    if (end <= begin) return;  // the whole block leaves together
    const float4* src = reinterpret_cast<const float4*>(lut);
    for (int j = threadIdx.x; j < M * 64; j += blockDim.x)
      lut_s4[j] = __ldg(src + j);
    __syncthreads();
    lut = reinterpret_cast<const float*>(lut_s4);
  }
  for (int t = begin + threadIdx.x; t < end; t += blockDim.x) {
    const int id = __ldg(rows + t);
    if (id < 0 || id >= n_table) {  // never read outside the table
      out[t] = __int_as_float(0x7fffffff);
      continue;
    }
    const uint8_t* row = table + static_cast<size_t>(id) * M;
    float s = 0.f;
    if (kW == 8) {
      for (int c = 0; c < M / 8; ++c) {
        const uint2 w = __ldg(reinterpret_cast<const uint2*>(row) + c);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s += lut_at<kStage>(lut, 8 * c + j, (w.x >> (8 * j)) & 255u);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s += lut_at<kStage>(lut, 8 * c + 4 + j, (w.y >> (8 * j)) & 255u);
      }
    } else if (kW == 4) {
      for (int c = 0; c < M / 4; ++c) {
        const unsigned w = __ldg(reinterpret_cast<const unsigned*>(row) + c);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s += lut_at<kStage>(lut, 4 * c + j, (w >> (8 * j)) & 255u);
      }
    } else {
      for (int m = 0; m < M; ++m) s += lut_at<kStage>(lut, m, __ldg(row + m));
    }
    out[t] = s;
  }
}

template <int kW, bool kStage>
int launch_rows(const void* luts, const void* table, const void* rows,
                const void* offsets, void* out, int n_table, int M, int T,
                int Q, void* stream) {
  const size_t smem = kStage ? static_cast<size_t>(M) * 256 * sizeof(float) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pq_adc_rows_kernel<kW, kStage>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  pq_adc_rows_kernel<kW, kStage>
      <<<Q, kStage ? kStageThreads : kRowThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(luts), static_cast<const uint8_t*>(table),
          static_cast<const int*>(rows), static_cast<const int*>(offsets),
          static_cast<float*>(out), n_table, M, T);
  return static_cast<int>(cudaGetLastError());
}

template <bool kStage>
int launch_rows_w(const void* luts, const void* table, const void* rows,
                  const void* offsets, void* out, int n_table, int M, int T,
                  int Q, void* stream) {
  const uintptr_t base = reinterpret_cast<uintptr_t>(table);
  if (M % 8 == 0 && base % 8 == 0)
    return launch_rows<8, kStage>(luts, table, rows, offsets, out, n_table, M,
                                  T, Q, stream);
  if (M % 4 == 0 && base % 4 == 0)
    return launch_rows<4, kStage>(luts, table, rows, offsets, out, n_table, M,
                                  T, Q, stream);
  return launch_rows<1, kStage>(luts, table, rows, offsets, out, n_table, M, T,
                                Q, stream);
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

// luts [Q, M, 256] f32 (16-byte aligned); table [n_table, M] u8; rows [T]
// i32 node ids; offsets [Q + 1] i32, nondecreasing from 0 to T; out [T] f32.
// Q, T >= 1, 1 <= M <= 64. An id outside [0, n_table) gives NaN. stage = 1
// copies each block's LUT to shared memory first. Returns the cudaError_t
// of the launch (0 = queued).
extern "C" int pq_adc_rows(const void* luts, const void* table,
                           const void* rows, const void* offsets, void* out,
                           int n_table, int M, int T, int Q, int stage,
                           void* stream) {
  if (stage)
    return launch_rows_w<true>(luts, table, rows, offsets, out, n_table, M, T,
                               Q, stream);
  return launch_rows_w<false>(luts, table, rows, offsets, out, n_table, M, T,
                              Q, stream);
}
