// Block-wide exact top-k selection shared by the masked scan kernels.
//
// One CUDA block owns one query. After the block has written the query's
// masked distances to a scratch row dist[0, C), select_topk picks the k
// smallest by the key (distance, pool position): the tie rule of the TPU
// kernels' _select_topk (first-index argmin over running top-k ++ block)
// and of jax.lax.top_k. Round r takes the smallest key strictly above the
// key of round r-1, so nothing is written back to the row and every round
// is one coalesced pass over it (the row of one query stays in L2).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// Sentinel of masked / missing entries, shared with the TPU kernels.
#define REPRO_INF 3.4e38f
#define REPRO_NO_KEY 0xffffffffffffffffull

// (d2, pos) packed so that unsigned order is lexicographic order: the
// float's bits are flipped into an order-preserving unsigned form (sign
// bit set for non-negatives, all bits inverted for negatives).
__device__ __forceinline__ unsigned long long pack_key(float d2, int pos) {
  const unsigned int u = __float_as_uint(d2);
  const unsigned int ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(ord) << 32) | static_cast<unsigned int>(pos);
}

__device__ __forceinline__ float key_dist(unsigned long long key) {
  const unsigned int ord = static_cast<unsigned int>(key >> 32);
  return __uint_as_float((ord & 0x80000000u) ? (ord & 0x7fffffffu) : ~ord);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ unsigned long long warp_min_key(unsigned long long v) {
  for (int off = 16; off > 0; off >>= 1) {
    unsigned long long o = __shfl_xor_sync(0xffffffffu, v, off);
    v = o < v ? o : v;
  }
  return v;
}

// blockDim.x must be a multiple of 32; red is __shared__ [33].
// Writes out_d[0, k) ascending and out_i[0, k) = ids[pos] of the chosen
// positions; masked choices (ids < 0) and rounds past C give (3.4e38, -1).
__device__ void select_topk(const float* dist, const int* ids, int C, int k,
                            float* out_d, int* out_i, unsigned long long* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  unsigned long long lo = 0;  // smallest admissible key of this round
  for (int r = 0; r < k; ++r) {
    unsigned long long best = REPRO_NO_KEY;
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      const unsigned long long key = pack_key(dist[c], c);
      if (key >= lo && key < best) best = key;
    }
    best = warp_min_key(best);
    if (lane == 0) red[warp] = best;
    __syncthreads();
    if (warp == 0) {
      unsigned long long v = lane < n_warps ? red[lane] : REPRO_NO_KEY;
      v = warp_min_key(v);
      if (lane == 0) red[32] = v;
    }
    __syncthreads();
    best = red[32];
    if (threadIdx.x == 0) {
      int id = -1;
      float d2 = REPRO_INF;
      if (best != REPRO_NO_KEY) {
        id = ids[static_cast<int>(best & 0xffffffffull)];
        d2 = key_dist(best);
      }
      out_d[r] = id >= 0 ? d2 : REPRO_INF;
      out_i[r] = id >= 0 ? id : -1;
    }
    if (best == REPRO_NO_KEY) {  // fewer than k candidates: pad the rest
      for (int j = r + 1 + threadIdx.x; j < k; j += blockDim.x) {
        out_d[j] = REPRO_INF;
        out_i[j] = -1;
      }
      return;
    }
    lo = best + 1;
  }
}
