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
// (512 queries x 1M rows x 128: 1.3e11 flops, 0.5 GB; 2.0 ms at 67 TFLOP/s).
// No TF32: the distances are held to the float32 reference, and TF32 keeps
// three digits.
//
// Design. The TPU kernel carries a running top-k across a sequential grid;
// blocks here run in any order, so the work is split twice:
//  * l2_topk_scan: a block of 256 threads (one per SM: the kernel takes up
//    to 255 registers a thread, and 128 would spill) owns kTQ = 128 queries
//    and one slice of the rows, walked in tiles of kTN = 128 rows. Column
//    slabs of 16 (q's and x's, each [128][16] f32, rows padded to 20 floats
//    so that the float4 reads of 8 neighbouring rows hit distinct banks)
//    stream through a 3-stage shared ring filled by cp.async, two slabs
//    ahead, across tile boundaries. Each thread holds an 8 x 8 micro-tile
//    of dot products (queries ty + 16 i, rows tx + 16 j) in registers: each
//    float4 of q or x feeds 32 FMAs. |x|^2 comes from the same slabs; |q|^2
//    is taken once per block. The loop is 1024 FMAs and 66 float4 shared
//    reads a slab; the reads deliver as many bytes as the SM's shared
//    memory moves in the FMAs' time, which holds it near half the f32 peak.
//  * The epilogue of a tile filters before it selects. Each thread forms
//    its 64 distances and compares them, branch-free, with its queries'
//    thresholds in shared memory: the d2 of the k-th key of each list (the
//    lists hold lower row ids only, so d2 < threshold is key < k-th key).
//    Survivors go to a 32-entry per-query shared queue. The queues are
//    drained after tiles 0, 1, 3, 7, 15, ... (about k keys pass between
//    two drains), after the slice's last tile, and when one overflows: the
//    survivors that found their queue full wait for the next round, against
//    the lowered thresholds. A drain offers each queue to its query's
//    sorted list of k keys (in shared memory for k <= 128, else in the
//    global scratch `part`): a key at or above the list's last is dropped,
//    one below it is placed by a warp-wide shift (for k <= 32 the list is
//    held one key a lane, and the shift is one shuffle). Stale thresholds
//    between drains only let through keys that the lists refuse.
//  * Tile 0 of a slice, for k <= 16, gets provisional thresholds: the k-th
//    smallest of the 16 lanes' minima of a query is a distance with at
//    least k distances at or below it, so d2 <= it keeps the tile's k
//    nearest and drops most of the rest.
//  * l2_topk_merge (only when the rows were split): one warp per query
//    offers the S sorted partial lists to a fresh list of k, which gives
//    the same keys as one pass over all rows.
#include "topk_select.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTQ = 128;     // queries per block
constexpr int kTN = 128;     // database rows per tile
constexpr int kDC = 16;      // columns per slab
constexpr int kLDS = kDC + 4;  // padded slab row, floats
constexpr int kStages = 3;
constexpr int kSlab = kTQ * kLDS;  // floats of one q (or x) slab
constexpr int kQueue = 32;   // survivor queue per query
constexpr int kMaxK = 256;
constexpr int kSmemMaxK = 128;  // lists in shared memory up to this k
constexpr int kPerLane = kMaxK / 32;
// The filter's threshold of a list with empty places is NaN: a key passes
// unless d2 >= threshold, so every distance (inf too) passes NaN.

static_assert(kTQ == kTN, "slab loads assume square tiles");
static_assert(kTN * 2 == kThreads && kDC % 8 == 0, "|x|^2: two threads a row");

__device__ __forceinline__ int key_id(unsigned long long key) {
  return static_cast<int>(key & 0xffffffffull);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 (or 4) bytes global -> shared; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Insert key into the ascending list[0, k) of one warp (the last entry
// falls off). The caller has checked key < list[k - 1]; keys are distinct.
// The list lies in shared or global memory.
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

// k <= 32: the list is held one key a lane (mine; lanes >= k hold
// nothing of it) and kth is its last key. Every lane offers one key.
__device__ __forceinline__ void lane_offer(unsigned long long& mine,
                                           unsigned long long& kth, int k,
                                           unsigned long long key) {
  const int lane = threadIdx.x & 31;
  unsigned mask = __ballot_sync(0xffffffffu, key < kth);
  while (mask) {
    const int src = __ffs(mask) - 1;
    const unsigned long long cand = __shfl_sync(0xffffffffu, key, src);
    if (cand < kth) {  // the same on every lane
      const int pos = __popc(__ballot_sync(0xffffffffu, lane < k && mine < cand));
      const unsigned long long up = __shfl_up_sync(0xffffffffu, mine, 1);
      mine = lane > pos ? up : (lane == pos ? cand : mine);
      kth = __shfl_sync(0xffffffffu, mine, k - 1);
    }
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

// Dynamic shared memory of the scan: u64 arrays first (lists only when
// they live here), then the f32 slab ring, then small arrays.
struct ScanSmem {
  size_t lists, queue, thresh, ring, count, qn, xn, total;
  __host__ __device__ explicit ScanSmem(int k) {
    const size_t list_keys = k <= kSmemMaxK ? static_cast<size_t>(kTQ) * k : 0;
    lists = 0;
    queue = lists + list_keys * 8;
    thresh = queue + static_cast<size_t>(kTQ) * kQueue * 8;
    ring = thresh + kTQ * 4;
    count = ring + static_cast<size_t>(kStages) * 2 * kSlab * 4;
    qn = count + kTQ * 4;
    xn = qn + kTQ * 4;
    total = xn + kTN * 4;
  }
};

// Stage slab g of the walk (tile g / n_slabs, columns 16 (g % n_slabs)...)
// of both q and x into ring entry g % kStages. Rows past Q or past the
// slice and columns past d are zero-filled. VEC: d % 4 == 0 and both
// pointers 16-byte aligned, so every 4-column chunk is whole or absent.
template <bool VEC>
__device__ __forceinline__ void load_slab(float* ring, const float* q,
                                          const float* x, int g, int n_slabs,
                                          int q0, int Q, int n_begin,
                                          int n_end, int d) {
  const int tile = g / n_slabs, c0 = (g % n_slabs) * kDC;
  const int n0 = n_begin + tile * kTN;
  float* qs = ring + (g % kStages) * 2 * kSlab;
  float* xs = qs + kSlab;
  if (VEC) {
    // 2 x 128 rows x 4 chunks of 16 bytes: 4 a thread
#pragma unroll
    for (int it = 0; it < 2 * kTQ * (kDC / 4) / kThreads; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int which = i / (kTQ * (kDC / 4));  // 0: q, 1: x
      const int r = (i / (kDC / 4)) % kTQ, c = c0 + 4 * (i % (kDC / 4));
      const bool row_in = which == 0 ? q0 + r < Q : n0 + r < n_end;
      const bool in = row_in && c < d;
      const float* base = which == 0 ? q : x;
      const float* src = in ? base + static_cast<size_t>(
                                  (which == 0 ? q0 : n0) + r) * d + c
                            : base;
      cp_async16(smem_u32((which == 0 ? qs : xs) + r * kLDS + c - c0), src,
                 in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < 2 * kTQ * kDC; i += kThreads) {
      const int which = i / (kTQ * kDC);
      const int r = (i / kDC) % kTQ, c = c0 + i % kDC;
      const bool row_in = which == 0 ? q0 + r < Q : n0 + r < n_end;
      const bool in = row_in && c < d;
      const float* base = which == 0 ? q : x;
      const float* src = in ? base + static_cast<size_t>(
                                  (which == 0 ? q0 : n0) + r) * d + c
                            : base;
      cp_async4(smem_u32((which == 0 ? qs : xs) + r * kLDS + c - c0), src,
                in ? 4 : 0);
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads, 1)  // up to 255 registers
l2_topk_scan(const float* __restrict__ q, const float* __restrict__ x,
             unsigned long long* __restrict__ part, float* __restrict__ out_d,
             int* __restrict__ out_i, int Q, int N, int d, int k,
             int rows_per_split) {
  extern __shared__ uint4 smem_raw[];
  char* sm = reinterpret_cast<char*>(smem_raw);
  const ScanSmem lay(k);
  unsigned long long* queue = reinterpret_cast<unsigned long long*>(sm + lay.queue);
  float* thresh = reinterpret_cast<float*>(sm + lay.thresh);
  float* ring = reinterpret_cast<float*>(sm + lay.ring);
  int* count = reinterpret_cast<int*>(sm + lay.count);
  float* qn_s = reinterpret_cast<float*>(sm + lay.qn);
  float* xn_s = reinterpret_cast<float*>(sm + lay.xn);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * kTQ;
  const int split = blockIdx.y;
  const int S = gridDim.y;
  const int n_begin = split * rows_per_split;
  const int n_end = min(N, n_begin + rows_per_split);
  const bool smem_lists = k <= kSmemMaxK;
  // the running list of query r of the tile
  auto list_of = [&](int r) {
    return smem_lists
               ? reinterpret_cast<unsigned long long*>(sm + lay.lists) + r * k
               : part + (static_cast<size_t>(q0 + r) * S + split) * k;
  };

  const int n_slabs = (d + kDC - 1) / kDC;
  const int n_steps = (n_end - n_begin + kTN - 1) / kTN * n_slabs;
  for (int g = 0; g < kStages - 1; ++g) {  // one group per slab, maybe empty
    if (g < n_steps) load_slab<VEC>(ring, q, x, g, n_slabs, q0, Q, n_begin, n_end, d);
    cp_async_commit();
  }

  for (int r = warp; r < kTQ; r += kWarps) {
    const bool real = q0 + r < Q;
    if (real) {
      unsigned long long* list = list_of(r);
      for (int i = lane; i < k; i += 32) list[i] = REPRO_NO_KEY;
    }
    float s = 0.f;
    if (real) {
      const float* qr = q + static_cast<size_t>(q0 + r) * d;
      for (int j = lane; j < d; j += 32) s += qr[j] * qr[j];
    }
    s = warp_sum(s);
    if (lane == 0) {
      qn_s[r] = s;
      // a query past Q takes no key
      thresh[r] = real ? __int_as_float(0x7fffffff) : -1.f;
      count[r] = 0;
    }
  }

  const int ty = tid >> 4;  // queries ty + 16 i of the tile, i < 8
  const int tx = tid & 15;  // rows tx + 16 j of the tile, j < 8
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float xn = 0.f;  // |x|^2 of row tid / 2 of the tile, half of the columns

  for (int g = 0; g < n_steps; ++g) {
    cp_async_wait<kStages - 2>();  // slab g has landed
    __syncthreads();  // ... for every thread; slab g - 1 is consumed
    if (g + kStages - 1 < n_steps)
      load_slab<VEC>(ring, q, x, g + kStages - 1, n_slabs, q0, Q, n_begin,
                     n_end, d);
    cp_async_commit();  // possibly empty: keeps the group count in step

    const float* qs = ring + (g % kStages) * 2 * kSlab;
    const float* xs = qs + kSlab;
#pragma unroll
    for (int c4 = 0; c4 < kDC / 4; ++c4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * kLDS + 4 * c4);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 bb =
            *reinterpret_cast<const float4*>(xs + (tx + 16 * j) * kLDS + 4 * c4);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][j] = fmaf(a[i].x, bb.x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, bb.y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, bb.z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, bb.w, acc[i][j]);
        }
      }
    }
    {  // |x|^2: two threads a row, half of the slab's columns each
      const float4* xr = reinterpret_cast<const float4*>(
          xs + (tid >> 1) * kLDS + (kDC / 2) * (tid & 1));
#pragma unroll
      for (int c = 0; c < kDC / 8; ++c) {
        const float4 u = xr[c];
        xn += u.x * u.x + u.y * u.y + u.z * u.z + u.w * u.w;
      }
    }
    if ((g + 1) % n_slabs != 0) continue;

    // ---- epilogue of tile g / n_slabs: filter, queue, insert ----
    const int n0 = n_begin + (g / n_slabs) * kTN;
    xn += __shfl_xor_sync(0xffffffffu, xn, 1);
    if ((tid & 1) == 0) xn_s[tid >> 1] = xn;
    xn = 0.f;
    __syncthreads();
    // bit 8 i + j stands for (query ty + 16 i, row tx + 16 j); rows past
    // the slice never take part
    unsigned long long pend = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (n0 + tx + 16 * j < n_end) pend |= 0x0101010101010101ull << j;
    // The queues are drained when one overflows, after tiles 0, 1, 3, 7,
    // 15, ... (about as many keys pass between two drains as the list
    // holds) and after the slice's last tile. In between the thresholds
    // are stale, which only lets through keys the lists will refuse.
    const int tile = g / n_slabs;
    const bool due = n0 + kTN >= n_end || ((tile + 1) & tile) == 0;
    if (tile == 0 && k <= 16) {
      // Provisional thresholds for the first tile: the k-th smallest of
      // the 16 lanes' minima (one lane's 8 rows each) is a distance, and k
      // distances lie at or below it, so the tile's k nearest pass d2 <=
      // it. Sorted across the half-warp of the query (bitonic).
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float m = __int_as_float(0x7f800000);  // +inf
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float d2 = fmaxf(
              qn_s[ty + 16 * i] - 2.f * acc[i][j] + xn_s[tx + 16 * j], 0.f);
          if (pend & (1ull << (8 * i + j))) m = fminf(m, d2);
        }
#pragma unroll
        for (int size = 2; size <= 16; size <<= 1) {
#pragma unroll
          for (int stride = size >> 1; stride > 0; stride >>= 1) {
            const float o = __shfl_xor_sync(0xffffffffu, m, stride);
            m = ((tx & stride) == 0) == ((tx & size) == 0) ? fminf(m, o)
                                                           : fmaxf(m, o);
          }
        }
        const float t = __shfl_sync(0xffffffffu, m, (lane & 16) + k - 1);
        // d2 < next float above t, i.e. d2 <= t; open (NaN) when t = inf
        if (tx == 0 && q0 + ty + 16 * i < Q)
          thresh[ty + 16 * i] = isinf(t) ? __int_as_float(0x7fffffff)
                                         : nextafterf(t, __int_as_float(0x7f800000));
      }
      __syncwarp();
    }
    while (true) {
      // branch-free filter: which pending keys lie below their query's
      // k-th key as of the last drain. The lists hold rows of earlier
      // tiles only, all of lower id, so key < k-th key is d2 < its d2.
      // A query past Q has threshold -1: nothing passes.
      unsigned long long surv = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float th = thresh[ty + 16 * i];
        const float qn = qn_s[ty + 16 * i];
        unsigned int byte = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float d2 = fmaxf(qn - 2.f * acc[i][j] + xn_s[tx + 16 * j], 0.f);
          byte |= static_cast<unsigned int>(!(d2 >= th)) << j;
        }
        surv |= static_cast<unsigned long long>(byte) << (8 * i);
      }
      surv &= pend;
      pend = 0;  // survivors that find their queue full
      if (surv) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const unsigned long long bit = 1ull << (8 * i + j);
            if (!(surv & bit)) continue;
            const float d2 = fmaxf(
                qn_s[ty + 16 * i] - 2.f * acc[i][j] + xn_s[tx + 16 * j], 0.f);
            const int slot = atomicAdd(&count[ty + 16 * i], 1);
            if (slot < kQueue)
              queue[(ty + 16 * i) * kQueue + slot] = pack_key(d2, n0 + tx + 16 * j);
            else
              pend |= bit;
          }
        }
      }
      // the common case: nothing overflowed and no drain is due
      if (!__syncthreads_or(pend != 0 || due)) break;
      for (int r = warp; r < kTQ; r += kWarps) {
        const int cnt = min(count[r], kQueue);
        if (cnt == 0) continue;
        unsigned long long* list = list_of(r);
        const unsigned long long key =
            lane < cnt ? queue[r * kQueue + lane] : REPRO_NO_KEY;
        unsigned long long kth;
        if (k <= 32) {  // in registers, one key a lane
          unsigned long long mine = lane < k ? list[lane] : REPRO_NO_KEY;
          kth = __shfl_sync(0xffffffffu, mine, k - 1);
          lane_offer(mine, kth, k, key);
          if (lane < k) list[lane] = mine;
        } else {
          warp_offer(list, k, key);
          kth = list[k - 1];
        }
        if (lane == 0) {
          thresh[r] = kth == REPRO_NO_KEY ? __int_as_float(0x7fffffff)
                                           : key_dist(kth);
          count[r] = 0;
        }
      }
      // the lists, thresholds and counts are written; any survivor left?
      if (!__syncthreads_or(pend != 0)) break;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  asm volatile("cp.async.wait_all;\n" ::);  // nothing in flight at exit

  for (int r = warp; r < kTQ && q0 + r < Q; r += kWarps) {
    const unsigned long long* list = list_of(r);
    const size_t qi = q0 + r;
    if (S == 1) {
      warp_write(list, k, out_d + qi * k, out_i + qi * k);
    } else if (smem_lists) {
      unsigned long long* dst = part + (qi * S + split) * k;
      for (int i = lane; i < k; i += 32) dst[i] = list[i];
    }  // else the list already lies in part
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

template <bool VEC>
cudaError_t launch_scan(const float* q, const float* x,
                        unsigned long long* part, float* out_d, int* out_i,
                        int Q, int N, int d, int k, int S, int rows_per_split,
                        cudaStream_t st) {
  const size_t smem = ScanSmem(k).total;
  const cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(l2_topk_scan<VEC>), smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Q + kTQ - 1) / kTQ, S);
  l2_topk_scan<VEC><<<grid, kThreads, smem, st>>>(q, x, part, out_d, out_i, Q,
                                                  N, d, k, rows_per_split);
  return cudaGetLastError();
}

}  // namespace

// q [Q, d] f32; x [N, d] f32; part [Q, S, k] u64 scratch (the partial
// lists; unused when S == 1 and k <= 128); out_d [Q, k] f32; out_i [Q, k]
// i32. Rows split into S slices of rows_per_split (a multiple of 128).
// 1 <= k <= 256, Q, N, d >= 1. Returns the cudaError_t of the launches
// (0 = queued).
extern "C" int l2_topk(const void* q, const void* x, void* part, void* out_d,
                       void* out_i, int Q, int N, int d, int k, int S,
                       int rows_per_split, void* stream) {
  if (k < 1 || k > kMaxK || rows_per_split % kTN != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  auto* qf = static_cast<const float*>(q);
  auto* xf = static_cast<const float*>(x);
  auto* pp = static_cast<unsigned long long*>(part);
  auto* od = static_cast<float*>(out_d);
  auto* oi = static_cast<int*>(out_i);
  cudaError_t err =
      vec ? launch_scan<true>(qf, xf, pp, od, oi, Q, N, d, k, S, rows_per_split, st)
          : launch_scan<false>(qf, xf, pp, od, oi, Q, N, d, k, S, rows_per_split, st);
  if (err != cudaSuccess || S == 1) return static_cast<int>(err);
  const size_t merge_smem = static_cast<size_t>(kWarps) * k * sizeof(unsigned long long);
  l2_topk_merge<<<(Q + kWarps - 1) / kWarps, kThreads, merge_smem, st>>>(
      pp, od, oi, Q, S, k);
  return static_cast<int>(cudaGetLastError());
}
