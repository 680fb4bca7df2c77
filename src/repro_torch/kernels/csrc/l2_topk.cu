// Fused squared-L2 distance + exact top-k of every query against a shared
// database x.
//
// Replaces the TPU kernel src/repro/kernels/l2_topk.py:l2_topk (_kernel +
// _select_topk): d2 = max(|q|^2 - 2 q.x + |x|^2, 0) for every (query, row)
// pair, and per query the k nearest rows by (d2, row id), ties to the
// lower id as jax.lax.top_k gives them; fewer than k rows pad (3.4e38, -1).
//
// Bound on the H100: float32 operations (2 Q N d) against Q d + N d + 8 Q k
// bytes, far above the card's balance point at the shapes it serves
// (512 queries x 1M rows x 128: 1.3e11 flops, 0.5 GB). No TF32: the
// distances are held to the float32 reference, and TF32 keeps three digits.
//
// Design. The TPU kernel carries a running top-k across a sequential grid;
// blocks here run in any order, so the work is split twice:
//  * l2_topk_scan: a block owns a tile of kTQ queries and one slice of the
//    rows. It stages kTN x kDC tiles of x (and the queries' kDC columns) in
//    shared memory, so each x element read from device memory serves kTQ
//    queries; each thread accumulates a 2 x 4 block of dot products. The
//    tile's distances then go to a shared [kTQ, kTN] buffer, and one warp
//    per query offers them to that query's running top-k: a sorted list of
//    k packed (d2, id) keys in shared memory. A candidate is compared with
//    the list's last key (almost all are rejected there) and inserted by a
//    warp-wide shift otherwise.
//  * l2_topk_merge (only when the rows were split): one warp per query
//    offers the S sorted partial lists to a fresh list of k, which gives
//    the same keys as one pass over all rows.
#include "topk_select.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTQ = 32;  // queries per block
constexpr int kTN = 64;  // database rows per tile
constexpr int kDC = 32;  // columns staged per step
constexpr int kMaxK = 256;
constexpr int kPerLane = kMaxK / 32;

__device__ __forceinline__ int key_id(unsigned long long key) {
  return static_cast<int>(key & 0xffffffffull);
}

// Insert key into the ascending list[0, k) of one warp (the last entry
// falls off). The caller has checked key < list[k - 1]; keys are distinct.
__device__ void warp_insert(unsigned long long* list, int k,
                            unsigned long long key) {
  const int lane = threadIdx.x & 31;
  int below = 0;
  for (int i = lane; i < k; i += 32) below += list[i] < key;
  const int pos = __reduce_add_sync(0xffffffffu, below);
  unsigned long long held[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int i = pos + lane + 32 * j;  // list[i + 1] <- list[i]
    if (i + 1 < k) held[j] = list[i];
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int i = pos + lane + 32 * j;
    if (i + 1 < k) list[i + 1] = held[j];
  }
  if (lane == 0) list[pos] = key;
  __syncwarp();
}

// Every lane of the warp offers one key (REPRO_NO_KEY offers nothing).
__device__ void warp_offer(unsigned long long* list, int k,
                           unsigned long long key) {
  unsigned mask = __ballot_sync(0xffffffffu, key < list[k - 1]);
  while (mask) {
    const int src = __ffs(mask) - 1;
    const unsigned long long cand = __shfl_sync(0xffffffffu, key, src);
    if (cand < list[k - 1]) warp_insert(list, k, cand);
    mask &= mask - 1;
  }
}

// Lanes write list[0, k) as (d2, id); empty places as (3.4e38, -1).
__device__ void warp_write(const unsigned long long* list, int k,
                           float* out_d, int* out_i) {
  for (int i = threadIdx.x & 31; i < k; i += 32) {
    const unsigned long long key = list[i];
    const bool real = key != REPRO_NO_KEY;
    out_d[i] = real ? key_dist(key) : REPRO_INF;
    out_i[i] = real ? key_id(key) : -1;
  }
}

__global__ void __launch_bounds__(kThreads)
l2_topk_scan(const float* __restrict__ q, const float* __restrict__ x,
             unsigned long long* __restrict__ part, float* __restrict__ out_d,
             int* __restrict__ out_i, int Q, int N, int d, int k,
             int rows_per_split) {
  extern __shared__ unsigned long long lists[];  // [kTQ, k]
  __shared__ float qs[kTQ][kDC + 1];
  __shared__ float xs[kTN][kDC + 1];
  __shared__ float dt[kTQ][kTN + 1];
  __shared__ float qn_s[kTQ];
  __shared__ float xn_s[kTN];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * kTQ;
  const int split = blockIdx.y;
  const int n_begin = split * rows_per_split;
  const int n_end = min(N, n_begin + rows_per_split);

  for (int i = tid; i < kTQ * k; i += kThreads) lists[i] = REPRO_NO_KEY;
  for (int r = warp; r < kTQ; r += kWarps) {
    float s = 0.f;
    if (q0 + r < Q) {
      const float* qr = q + static_cast<size_t>(q0 + r) * d;
      for (int j = lane; j < d; j += 32) s += qr[j] * qr[j];
    }
    s = warp_sum(s);
    if (lane == 0) qn_s[r] = s;
  }
  __syncthreads();

  const int ty = tid >> 4;  // queries ty and ty + 16 of the tile
  const int tx = tid & 15;  // rows tx + 16 j of the tile, j < 4
  for (int n0 = n_begin; n0 < n_end; n0 += kTN) {
    float acc[2][4] = {};
    float xn = 0.f;  // threads tid < kTN: |x|^2 of row n0 + tid
    for (int c0 = 0; c0 < d; c0 += kDC) {
      for (int i = tid; i < kTQ * kDC; i += kThreads) {
        const int r = i / kDC, c = i % kDC;
        qs[r][c] = (q0 + r < Q && c0 + c < d)
                       ? q[static_cast<size_t>(q0 + r) * d + c0 + c] : 0.f;
      }
      for (int i = tid; i < kTN * kDC; i += kThreads) {
        const int r = i / kDC, c = i % kDC;
        xs[r][c] = (n0 + r < n_end && c0 + c < d)
                       ? x[static_cast<size_t>(n0 + r) * d + c0 + c] : 0.f;
      }
      __syncthreads();
      if (tid < kTN) {
        for (int c = 0; c < kDC; ++c) xn += xs[tid][c] * xs[tid][c];
      }
#pragma unroll 8
      for (int c = 0; c < kDC; ++c) {
        const float a0 = qs[ty][c], a1 = qs[ty + 16][c];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float b = xs[tx + 16 * j][c];
          acc[0][j] += a0 * b;
          acc[1][j] += a1 * b;
        }
      }
      __syncthreads();
    }
    if (tid < kTN) xn_s[tid] = xn;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const float v = qn_s[r] - 2.f * acc[i][j] + xn_s[c];
        dt[r][c] = v > 0.f ? v : 0.f;
      }
    }
    __syncthreads();
    for (int r = warp; r < kTQ && q0 + r < Q; r += kWarps) {
      unsigned long long* list = lists + static_cast<size_t>(r) * k;
      for (int c = lane; c < kTN; c += 32) {  // every lane takes 2 rounds
        const int n = n0 + c;
        warp_offer(list, k, n < n_end ? pack_key(dt[r][c], n) : REPRO_NO_KEY);
      }
    }
    __syncthreads();
  }

  for (int r = warp; r < kTQ && q0 + r < Q; r += kWarps) {
    const unsigned long long* list = lists + static_cast<size_t>(r) * k;
    const size_t qi = q0 + r;
    if (gridDim.y == 1) {
      warp_write(list, k, out_d + qi * k, out_i + qi * k);
    } else {
      unsigned long long* dst = part + (qi * gridDim.y + split) * k;
      for (int i = lane; i < k; i += 32) dst[i] = list[i];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
l2_topk_merge(const unsigned long long* __restrict__ part,
              float* __restrict__ out_d, int* __restrict__ out_i, int Q,
              int S, int k) {
  extern __shared__ unsigned long long lists[];  // [kWarps, k]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t qi = static_cast<size_t>(blockIdx.x) * kWarps + warp;
  if (qi >= static_cast<size_t>(Q)) return;  // whole warps; no block barrier
  unsigned long long* list = lists + static_cast<size_t>(warp) * k;
  for (int i = lane; i < k; i += 32) list[i] = REPRO_NO_KEY;
  __syncwarp();
  const unsigned long long* src = part + qi * S * k;
  const int total = S * k;
  for (int base = 0; base < total; base += 32) {
    const int i = base + lane;
    warp_offer(list, k, i < total ? src[i] : REPRO_NO_KEY);
  }
  warp_write(list, k, out_d + qi * k, out_i + qi * k);
}

cudaError_t allow_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// q [Q, d] f32; x [N, d] f32; part [Q, S, k] u64 scratch (unused when
// S == 1); out_d [Q, k] f32; out_i [Q, k] i32. Rows split into S slices of
// rows_per_split (a multiple of 64). 1 <= k <= 256, Q, N >= 1. Returns the
// cudaError_t of the launches (0 = queued).
extern "C" int l2_topk(const void* q, const void* x, void* part, void* out_d,
                       void* out_i, int Q, int N, int d, int k, int S,
                       int rows_per_split, void* stream) {
  if (k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t scan_smem = static_cast<size_t>(kTQ) * k * sizeof(unsigned long long);
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(l2_topk_scan), scan_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Q + kTQ - 1) / kTQ, S);
  l2_topk_scan<<<grid, kThreads, scan_smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(x),
      static_cast<unsigned long long*>(part), static_cast<float*>(out_d),
      static_cast<int*>(out_i), Q, N, d, k, rows_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return static_cast<int>(err);
  const size_t merge_smem = static_cast<size_t>(kWarps) * k * sizeof(unsigned long long);
  l2_topk_merge<<<(Q + kWarps - 1) / kWarps, kThreads, merge_smem, st>>>(
      static_cast<const unsigned long long*>(part), static_cast<float*>(out_d),
      static_cast<int*>(out_i), Q, S, k);
  return static_cast<int>(cudaGetLastError());
}
