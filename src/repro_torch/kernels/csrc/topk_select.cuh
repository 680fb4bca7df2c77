// Keys and the block-wide exact top-k selection of the masked scan kernels
// (l2_topk_masked.cu, pq_adc_masked.cu); l2_topk.cu uses the key helpers.
//
// One CUDA block of kSelThreads owns one query. Its scan writes one 32-bit
// order-preserving key per pool position c to keys[c] (the position is the
// index; masked positions get the key of 3.4e38) and counts the first radix
// digit of each key into a shared histogram as it goes. select_topk then
// picks the k smallest (key, position) pairs, which is the tie rule of the
// TPU kernels' _select_topk (first-index argmin over running top-k ++ block)
// and of jax.lax.top_k:
//  1. Threshold. A radix select finds the key t of rank kk = min(k, C): per
//     digit (11, 11 and 10 bits, from the top) a histogram of the keys that
//     match the digits found so far, a block prefix sum, and the digit of
//     the bin where rank kk falls. It stops early once that bin is taken
//     whole (its count equals the rank left), which is the common case.
//  2. Survivors. Every position whose key lies below the bin is taken, and
//     the bin's positions too when it is taken whole (one pass, appended in
//     any order). Otherwise the bin is the single key t with more positions
//     than places left: they are taken in position order by a block-wide
//     stable compaction (ballot and prefix), until there are kk.
//  3. Output. The kk survivors are ranked by their (key, position) pairs,
//     all distinct, and written to their places; masked choices and places
//     past C give (3.4e38, -1).
// The keys live in shared memory when they fit (the wrapper decides: see
// select_smem in kernels/l2_topk.py) and otherwise in a device-memory
// scratch row; the passes are the same code over either.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// Sentinel of masked / missing entries, shared with the TPU kernels.
#define REPRO_INF 3.4e38f
#define REPRO_NO_KEY 0xffffffffffffffffull

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kSelThreads = 512;            // threads of a masked scan block
constexpr int kSelMaxK = 256;
constexpr int kSelBins = 2048;              // the widest digit: 11 bits
// dynamic shared memory of a masked scan block: survivors (u64) at 0, the
// histogram after them, then the kernel's own arrays, then the keys
constexpr int kSelHeadBytes = kSelMaxK * 8 + kSelBins * 4;

__host__ __device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// Dynamic shared bytes of a masked scan block whose own arrays take `head`
// bytes; the keys add 4 bytes a position (C rounded up to 4, see
// select_stride) when they live in shared memory. Mirrors
// select_smem in kernels/l2_topk.py.
__host__ __device__ __forceinline__ size_t select_smem_bytes(int C, size_t head,
                                                             bool shared_keys) {
  return kSelHeadBytes + align16(head) +
         (shared_keys ? 4 * static_cast<size_t>((C + 3) & ~3) : 0);
}

// Order-preserving 32-bit key of a float: unsigned order is float order
// (sign bit set for non-negatives, all bits inverted for negatives). -0.0
// keys as +0.0, since the two compare equal.
__device__ __forceinline__ uint32_t float_key(float v) {
  uint32_t u = __float_as_uint(v);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_float(uint32_t ord) {
  return __uint_as_float((ord & 0x80000000u) ? (ord & 0x7fffffffu) : ~ord);
}

// (d2, pos) packed so that unsigned order is lexicographic order.
__device__ __forceinline__ unsigned long long pack_key(float d2, int pos) {
  return (static_cast<unsigned long long>(float_key(d2)) << 32) |
         static_cast<unsigned int>(pos);
}

__device__ __forceinline__ float key_dist(unsigned long long key) {
  return key_float(static_cast<uint32_t>(key >> 32));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

// Phase clocks of the masked scan blocks, compiled in only with
// -DREPRO_PHASE_CLOCKS (scripts/kernel_bench.py --clocks): thread 0 of
// each block records clock64() at kernel start (0), after its setup (1),
// after the scan (2), the threshold (3) and the survivors (4), and at the
// end (5); read_phase_clocks copies [kPhaseBlocks][6] to the host.
#ifdef REPRO_PHASE_CLOCKS
constexpr int kPhaseBlocks = 1024;
__device__ long long g_phase_clock[kPhaseBlocks][6];
#define REPRO_PHASE(i)                                             \
  do {                                                             \
    if (threadIdx.x == 0 && blockIdx.x < kPhaseBlocks)             \
      g_phase_clock[blockIdx.x][i] = clock64();                    \
  } while (0)
extern "C" int read_phase_clocks(void* dst) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(dst, g_phase_clock, sizeof(g_phase_clock)));
}
#else
#define REPRO_PHASE(i) do {} while (0)
#endif

// Radix-select state of a block (static shared memory).
struct SelectState {
  int wsum[2][32];   // per-warp counts of a block scan (double-buffered)
  uint32_t prefix;   // digits found so far ...
  uint32_t mask;     // ... and the bits they cover
  int want;          // rank of the threshold inside the current bin
  int n_bin;         // keys in that bin
  int count;         // survivors appended
};

// Before the scan: the state for k of C, the histogram cleared. The caller
// puts a barrier between this and the first hist_add.
__device__ __forceinline__ void select_init(SelectState& st, int* hist, int k, int C) {
  if (threadIdx.x == 0) {
    st.prefix = 0u;
    st.mask = 0u;
    st.want = k < C ? k : C;
    st.n_bin = 0;
    st.count = 0;
  }
  for (int i = threadIdx.x; i < kSelBins; i += blockDim.x) hist[i] = 0;
}

// hist[bin] += 1 for every lane with ok; every lane of the warp calls it.
// The keys of one query share their top bits, so the lanes of a warp are
// grouped by bin (__match_any_sync) and each group's lowest lane adds the
// group's size: one shared atomic per distinct bin of the warp, where 32
// lanes on one bin would otherwise serialise.
__device__ __forceinline__ void hist_add(int* hist, uint32_t bin, bool ok) {
  const int lane = threadIdx.x & 31;
  if (!__any_sync(kFullMask, ok)) return;
  const unsigned peers = __match_any_sync(kFullMask, ok ? bin : 0xffffffffu);
  if (ok && __ffs(peers) - 1 == lane) atomicAdd(&hist[bin], __popc(peers));
}

// First digit of a key: bits 21..31.
__device__ __forceinline__ uint32_t first_digit(uint32_t key) { return key >> 21; }

// The keys are read four at a time: a row of keys starts 16-byte aligned
// and spans select_stride(C) entries (those past C are never written and
// never counted).
__host__ __device__ __forceinline__ int select_stride(int C) { return (C + 3) & ~3; }

__device__ __forceinline__ uint4 keys4_at(const uint32_t* keys, int g, int C) {
  return 4 * g < C ? reinterpret_cast<const uint4*>(keys)[g] : make_uint4(0u, 0u, 0u, 0u);
}

// Histogram of digit (shift, bits) over the keys that match prefix / mask.
__device__ void radix_pass(const uint32_t* keys, int C, int* hist, uint32_t prefix,
                           uint32_t mask, int shift, int bits) {
  const int lane = threadIdx.x & 31;
  const int n4 = select_stride(C) >> 2;
  for (int g0 = threadIdx.x & ~31; g0 < n4; g0 += blockDim.x) {
    const int g = g0 + lane;
    const uint4 kv = keys4_at(keys, g, C);
    const uint32_t kq[4] = {kv.x, kv.y, kv.z, kv.w};
    bool ok[4], any = false;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ok[i] = 4 * g + i < C && (kq[i] & mask) == prefix;
      any |= ok[i];
    }
    if (!__any_sync(kFullMask, any)) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      hist_add(hist, (kq[i] >> shift) & ((1u << bits) - 1u), ok[i]);
  }
}

// The bin of digit (shift, bits) where the rank st.want falls: its digit
// joins st.prefix / st.mask, st.want becomes the rank inside it and
// st.n_bin its count. Clears the histogram. Starts after a barrier that
// completes the histogram and ends with one.
__device__ void find_bin(int* hist, SelectState& st, int shift, int bits) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nb = 1 << bits;
  const int per = (nb + blockDim.x - 1) / blockDim.x;
  const int lo = min(static_cast<int>(threadIdx.x) * per, nb);
  const int hi = min(lo + per, nb);
  const int want = st.want;
  int s = 0;
  for (int i = lo; i < hi; ++i) s += hist[i];
  int incl = s;
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(kFullMask, incl, off);
    if (lane >= off) incl += t;
  }
  if (lane == 31) st.wsum[0][warp] = incl;
  __syncthreads();
  const int wv = lane < static_cast<int>(blockDim.x >> 5) ? st.wsum[0][lane] : 0;
  int below = __reduce_add_sync(kFullMask, lane < warp ? wv : 0) + incl - s;
  if (below < want && want <= below + s) {  // exactly one thread
    for (int i = lo; i < hi; ++i) {
      const int h = hist[i];
      if (below + h >= want) {
        st.want = want - below;
        st.n_bin = h;
        st.prefix |= static_cast<uint32_t>(i) << shift;
        st.mask |= static_cast<uint32_t>(nb - 1) << shift;
        break;
      }
      below += h;
    }
  }
  for (int i = lo; i < hi; ++i) hist[i] = 0;
  __syncthreads();
}

// Appends (key << 32 | position) to list[st.count ...) for every position
// whose key, on `mask`'s bits, lies below `prefix` (or at it, with
// at_too), in any order.
__device__ void gather_below(const uint32_t* keys, int C, uint32_t prefix, uint32_t mask,
                             bool at_too, unsigned long long* list, SelectState& st) {
  const int lane = threadIdx.x & 31;
  const unsigned lanes_below = (1u << lane) - 1u;
  const int n4 = select_stride(C) >> 2;
  for (int g0 = threadIdx.x & ~31; g0 < n4; g0 += blockDim.x) {
    const int g = g0 + lane;
    const uint4 kv = keys4_at(keys, g, C);
    const uint32_t kq[4] = {kv.x, kv.y, kv.z, kv.w};
    bool take[4], any = false;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t m = kq[i] & mask;
      take[i] = 4 * g + i < C && (m < prefix || (at_too && m == prefix));
      any |= take[i];
    }
    if (!__any_sync(kFullMask, any)) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned bal = __ballot_sync(kFullMask, take[i]);
      if (!bal) continue;
      const int leader = __ffs(bal) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(&st.count, __popc(bal));
      base = __shfl_sync(kFullMask, base, leader);
      if (take[i])
        list[base + __popc(bal & lanes_below)] =
            (static_cast<unsigned long long>(kq[i]) << 32) |
            static_cast<uint32_t>(4 * g + i);
    }
  }
}

// Ranks the kk distinct (key, position) pairs of list (kk <= kSelMaxK) and
// writes each to out_d/out_i[rank]; places kk .. k-1 get (3.4e38, -1). A
// team of lanes (a power of two, within one warp) counts the pairs below
// one entry, each lane every team-th pair.
__device__ void rank_out(const unsigned long long* list, int kk, int k,
                         const int* __restrict__ ids, float* __restrict__ out_d,
                         int* __restrict__ out_i) {
  int team = 1;
  while (team < 32 && 2 * team * kk <= static_cast<int>(blockDim.x)) team *= 2;
  const int i = threadIdx.x / team;
  const int part = threadIdx.x % team;
  const unsigned long long mine = i < kk ? list[i] : 0ull;
  int r = 0;
  if (i < kk)
    for (int j = part; j < kk; j += team) r += list[j] < mine;
  for (int off = team >> 1; off > 0; off >>= 1) r += __shfl_xor_sync(kFullMask, r, off);
  if (i < kk && part == 0) {
    const int id = ids[static_cast<int>(mine & 0xffffffffull)];
    out_d[r] = id >= 0 ? key_float(static_cast<uint32_t>(mine >> 32)) : REPRO_INF;
    out_i[r] = id >= 0 ? id : -1;
  }
  for (int p = kk + threadIdx.x; p < k; p += blockDim.x) {
    out_d[p] = REPRO_INF;
    out_i[p] = -1;
  }
}

// The k nearest of keys[0, C) by (key, position), written to out_d/out_i
// [k]. On entry (after a barrier) hist holds the first digit of every key
// and st is as select_init left it; ids is the query's id row (id < 0:
// masked). surv is shared [kSelMaxK].
__device__ void select_topk(const uint32_t* keys, const int* __restrict__ ids, int C,
                            int k, int* hist, unsigned long long* surv,
                            SelectState& st, float* __restrict__ out_d,
                            int* __restrict__ out_i) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  const int kk = k < C ? k : C;

  // 1. threshold: digits of 11, 11 and 10 bits, stopping at a whole bin
  find_bin(hist, st, 21, 11);
  if (st.n_bin != st.want) {
    radix_pass(keys, C, hist, st.prefix, st.mask, 10, 11);
    __syncthreads();
    find_bin(hist, st, 10, 11);
    if (st.n_bin != st.want) {
      radix_pass(keys, C, hist, st.prefix, st.mask, 0, 10);
      __syncthreads();
      find_bin(hist, st, 0, 10);
    }
  }
  const uint32_t prefix = st.prefix;
  const int want = st.want;
  const bool whole = st.n_bin == want;
  REPRO_PHASE(3);

  // 2. survivors below the bin (and the bin, when taken whole) ...
  gather_below(keys, C, prefix, st.mask, whole, surv, st);
  // ... then the first `want` positions of the tied key t, in position
  // order: a stable block compaction (the mask covers every bit here)
  if (!whole) {
    const int n_lt = kk - want;
    int taken = 0, buf = 0;
    for (int c0 = 0; c0 < C && taken < want; c0 += blockDim.x, buf ^= 1) {
      const int c = c0 + threadIdx.x;
      const uint32_t key = c < C ? keys[c] : 0u;
      const bool eq = c < C && key == prefix;
      const unsigned bal = __ballot_sync(kFullMask, eq);
      if (lane == 0) st.wsum[buf][warp] = __popc(bal);
      __syncthreads();
      const int wv = lane < n_warps ? st.wsum[buf][lane] : 0;
      const int rank = taken + __reduce_add_sync(kFullMask, lane < warp ? wv : 0) +
                       __popc(bal & lanes_below);
      if (eq && rank < want)
        surv[n_lt + rank] =
            (static_cast<unsigned long long>(key) << 32) | static_cast<uint32_t>(c);
      taken += __reduce_add_sync(kFullMask, wv);
    }
  }
  __syncthreads();
  REPRO_PHASE(4);

  // 3. rank the kk survivors and write them out
  rank_out(surv, kk, k, ids, out_d, out_i);
#ifdef REPRO_PHASE_CLOCKS
  __syncthreads();
#endif
  REPRO_PHASE(5);
}
