// The backward of attention with an online softmax, causal or full,
// grouped-query heads, and the hybrid family's sliding window and meta
// tokens: dQ, dK, dV from (q, k, v, O, dO, lse), O the forward's f32
// output before its rounding (the reference's residual out_g).
//
// Counterpart of the reference's custom_vjp backward
// src/repro/models/attention.py:136 (bwd, a jnp scan over key chunks; not
// a pallas_call): per (query, key) pair P = exp(scale q.k - lse), zero
// where the mask hides the key (the causal mask k_pos > q_pos + (Sk - Sq),
// and with window > 0 also k_pos <= q_pos - window unless k_pos < meta:
// _mask_block at :50, here attention_mask.cuh, the forward's); delta =
// rowsum(dO * O); dV = P^T dO; dP = dO V^T; dS = P (dP - delta) scale;
// dQ = dS K; dK = dS^T Q; dK and dV summed over the G = H / KVH query
// heads of each KV head. lse [B, H, Sq] is the forward's log-sum-exp
// (flash_attention.cu writes it). Layout is the model's: q, O, dO, dQ
// [B, Sq, H, D]; k, v, dK, dV [B, Sk, KVH, D]. Scores are never stored:
// each pair is recomputed from q and k, so memory stays O(S D).
//
// Bound on the H100: at a TinyLlama-1.1B training layer (B=8, Sq=Sk=2048,
// H=32, KVH=4, D=64, bf16, causal) the five products are 10 D FLOPs per
// unmasked pair, 0.35 ms on the bf16 tensor cores, against 0.09 ms for the
// bytes of q, k, v, O, dO, lse, dQ, dK and dV: operations bound it.
//
// What held the first port (mma.sync) back, and what this design does
// about each:
//  * Too little in flight: 222 registers a thread in dK/dV, two 4-warp
//    blocks an SM, every warp re-reading its K and V fragments with
//    ldmatrix each step and crossing two __syncthreads around a 2-stage
//    cp.async ring. Here both product launches run one block of three
//    warpgroups an SM: two consumer warpgroups issue wgmma (the operands
//    read by the tensor cores from shared memory, no ldmatrix) while one
//    producer thread keeps TMA loads of the streamed tiles in flight
//    through a ring of kStages stages, guarded by full and empty mbarriers
//    instead of block-wide barriers; setmaxnreg moves the producer's
//    registers to the consumers (24 / 240 a thread). Named barriers take
//    the two consumers' first products in turn, so one warpgroup's
//    exponentials run while the other's products hold the tensor cores.
//  * Instructions, not products, bound a step once wgmma does the math:
//    stage, phase and tile counters are kept incremental (no division
//    in the loop), a descriptor is a base plus a constant per k-step, the
//    mask is one branch taken only on ragged or diagonal tiles, and P is
//    ex2.approx.ftz on the MUFU alone. A step's last products stay in
//    flight while the next step's first are issued.
//  * Launch order: dK/dV blocks went out group by group, so the longest
//    blocks of the last groups started in the last wave. Blocks are now
//    numbered key tile first (dK/dV) or longest query block first (dQ), so
//    every group's long blocks start in the first wave.
//  * delta in eager torch (0.94 GB of f32 copies a call) and outside the
//    kernel times: it is launch 0 here, bwd_delta, 16-byte loads of the
//    bf16 dO and the f32 O and a shuffle sum per row; it also writes lse
//    log2(e), both with rows padded to whole 128-row blocks for the bulk
//    copies. delta read the bf16 O until whisper's cross-attention
//    trained (448 queries, full attention over 1500 encoder keys that
//    share a mean): the rounding entered every dS of a row alike, and
//    dQ was 0.0167 off autograd through the plain attention, against a
//    bound of 0.0028 (H100); from the f32 O, 0.00098.
//
// Three launches, all deterministic (no atomics, no waits across blocks:
// each output element is summed by one thread in one order):
//  0. bwd_delta: delta and lse2 = lse log2(e), f32 [B, H, ld].
//  1. bwd_dkdv_wgmma: one block per (b, KV head, 128 keys); each consumer
//     warpgroup owns 64 keys and keeps their dK and dV rows in f32
//     registers; K and V are loaded once; (q, dO, lse2, delta) tiles of NQ
//     query rows stream through the ring, every head of the KV head in
//     turn, from the block's causal diagonal on. A step: S^T = K q^T and
//     dP^T = V dO^T (wgmma, both operands in shared memory), P^T and dS^T
//     in registers, then dV += P^T dO and dK += dS^T q with P^T and dS^T
//     as wgmma's register A operand (the m64nNk16 accumulator layout is
//     the A fragment's, so P never goes to shared memory; dO and q read
//     through a transposed, MN-major descriptor).
//  2. bwd_dq_wgmma: one block per (b, head, 128 query rows), 64 rows a
//     consumer warpgroup, dQ in f32 registers; q and dO loaded once;
//     (K, V) tiles of 64 keys up to the causal diagonal stream through the
//     ring. S = q K^T, dP = dO V^T, dS in registers, dQ += dS K (K
//     transposed).
// So S and dP are computed twice (once per launch): 7 products per pair
// where a fused single pass needs 5, and dQ would need an ordered sum
// across key blocks (ROADMAP).
//
// The window and meta tokens (hymba: window 1024, 128 meta tokens, 2176
// rows) cut both walks to the pairs the mask lets through, as the forward's
// KeyTiles does: a dK/dV block walks the query rows from its diagonal to
// the last row its last key's window reaches (every later row if it holds a
// meta key); a dQ block walks the forward's KeyTiles, the meta tiles, then
// from its first row's window start to its diagonal. A warpgroup skips a
// tile the window hides from all its rows, and masks elements only in a
// tile the window or the diagonal cuts. Launch order stays longest first
// (dkdv_longest_first, dq_longest_first, attention_mask.cuh): with Sq = Sk
// the key blocks still go in order (a meta block walks every later row,
// the windowed ones at most window + 127 rows, fewer near the end), and
// the query blocks last first but for a ragged last one.
//
// Tiles: TMA reads q, dO, k and v through 3-D tensor maps (heads * D
// columns, S rows, B batches), so rows past S are zero-filled and never
// the next batch's; boxes are W = min(D, 64) columns wide with the swizzle
// of a W * 2-byte row (128, 64 or 32 bytes), the one wgmma's descriptors
// name; D = 128 is two boxes side by side. NQ is 64 query rows a step, 32
// at D = 128 (the dK and dV accumulators take 128 registers a thread
// there). Widths: D in {16, 32, 64, 128}; the wrapper zero-pads any other.
//
// Two variants, chosen by dtype as in the forward:
//  * bf16, on the tensor cores: P is exp2 of the f32 score times
//    scale*log2(e) less lse*log2(e) (a P below 2^-126 flushed to 0); P
//    and dS are rounded to bf16 before their products (dS from the
//    unrounded f32 P). The outputs are rounded once from f32.
//    tests/test_torch_attention_bwd.py emulates these tiles and rounding
//    points in plain torch.
//  * f32, on the CUDA cores (f32 gradients hold the reference to 1e-5,
//    which TF32 would not): one thread per key row (dK/dV) or query row
//    (dQ), accumulators in registers, the streamed tiles in shared memory
//    read as broadcasts; delta from launch 0 (ld = Sq).
// Masking sets P to 0 by selection (keys past Sk, query rows past Sq, the
// causal mask, the window), never through exp(-1e30 - lse), so no NaN or inf
// appears, even in a row whose only visible keys lie in the meta tile and
// far to its right.
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_mask.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------- PTX ---

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x on the MUFU alone (exp2f adds a rescaling for results below 2^-126,
// which this flushes to 0: such a P lies far below a bf16 step of any sum
// it enters)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// spin until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}
// a box of the 3-D tensor map at (column, row, batch) into shared memory;
// its bytes complete a transaction of the barrier (rows past the end are
// zeros)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int col, int row, int batch,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(batch),
      "r"(bar)
      : "memory");
}
// `bytes` (a multiple of 16, 16-byte aligned) global -> shared, likewise
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// pin registers a wgmma writes or reads asynchronously to this point of
// the program, so the compiler neither reads them early nor reuses them
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
// Named barriers 1 and 2 take the two consumer warpgroups' S and dP issues
// in turn: warpgroup w syncs on 1 + w before it issues and arrives on the
// other's barrier after, so one warpgroup's exponentials and dS run while
// the other's products hold the tensor cores (rather than both waiting,
// then both computing, in step)
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// wgmma.mma_async m64nNk16, bf16 in, f32 accumulate (d: the 64 x N
// accumulator, N / 2 floats a thread). _ss: A and B from shared memory
// through K-major descriptors; acc 0 overwrites d. _rs: A (4 registers
// of packed bf16) from registers, B through an MN-major (transposed)
// descriptor; always accumulates.
template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int acc);
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t* a, uint64_t b);
template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                             const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


// ------------------------------------------------------ bf16 layouts ---
//
// A tile of R rows by D bf16 columns sits in shared memory as D / W boxes
// of R rows by W columns (W = min(D, 64)), each box as TMA writes it with
// the swizzle of its W * 2-byte rows (128, 64 or 32 bytes): the 16-byte
// chunk c of row r lands at chunk c ^ (r % 8) (128-byte rows; the 64- and
// 32-byte patterns are the same XOR on fewer bits). Tiles start at 1024-
// byte boundaries, so the hardware's swizzle, a function of the address,
// is the one wgmma's descriptors name.

template <int D>
struct Cfg {
  static constexpr int W = D < 64 ? D : 64;        // columns per box
  static constexpr int NB = D / W;                 // boxes per tile
  static constexpr int NQ = D == 128 ? 32 : 64;    // dK/dV: query rows a step
  static constexpr int NK = 64;                    // dQ: keys a step
  static constexpr uint32_t kRowBytes = W * 2;
  // a descriptor's high word: the 8-row group stride and the swizzle
  static constexpr uint32_t kDescHi =
      (8 * kRowBytes >> 4) | (W == 64 ? 1u : W == 32 ? 2u : 3u) << 30;
};
constexpr int kRes = 128;     // resident rows a block: two warpgroups of 64
constexpr int kStages = 3;    // streamed tiles in flight
constexpr int kBlock = 384;   // two consumer warpgroups, one producer

// wgmma shared-memory descriptors of width D. The low word holds the start
// address and the leading byte offset, both in 16-byte units; a k-step
// adds a constant to it (the start address stays below 2^14 units, so the
// sum never carries into the offset field).
template <int D>
__device__ __forceinline__ uint32_t desc_lo(uint32_t addr, uint32_t lbo) {
  return ((addr & 0x3FFFF) >> 4) | (lbo >> 4) << 16;
}
template <int D>
__device__ __forceinline__ uint64_t desc(uint32_t lo) {
  return static_cast<uint64_t>(Cfg<D>::kDescHi) << 32 | lo;
}
// K-major operand (A, or B stored N rows by K columns): tile rows from the
// descriptor's start, the 16 columns of k-step kk, an R-row tile
template <int D>
__device__ __forceinline__ uint32_t desc_k(uint32_t addr) {
  return desc_lo<D>(addr, 16);
}
template <int D, int R>
__host__ __device__ constexpr uint32_t k_step(int kk) {
  using C = Cfg<D>;
  return ((kk * 16 / C::W) * R * C::kRowBytes + (kk * 16 % C::W) * 2) >> 4;
}
// MN-major operand B (K along an R-row tile's rows, N along its columns,
// read transposed): rows 16 kk .. 16 kk + 15, box c's W columns
template <int D, int R>
__device__ __forceinline__ uint32_t desc_mn(uint32_t addr) {
  return desc_lo<D>(addr, R * Cfg<D>::kRowBytes);
}
template <int D, int R>
__host__ __device__ constexpr uint32_t mn_step(int c, int kk) {
  using C = Cfg<D>;
  return (c * R * C::kRowBytes + kk * 16 * C::kRowBytes) >> 4;
}

// -------------------------------------------------------- bf16 dK / dV ---

// One block per (b, KV head, 128 keys), blocks ordered key tile first, the
// longest first (dkdv_longest_first: under the causal mask, and under a
// window with Sq = Sk, key tile 0, which holds the meta keys, then the
// others in order).
// Warpgroups 0 and 1 own 64 keys each and keep their dK and dV rows in f32
// registers; warpgroup 2's first thread loads the block's K and V once,
// then streams (q, dO, lse2, delta) tiles of NQ query rows through a ring
// of kStages stages: every query tile of every head of the KV head, head
// by head, from the block's causal diagonal to the last row its keys'
// windows reach (window_rows_end). A step: S^T = K q^T and
// dP^T = V dO^T (both operands from shared memory), P^T and dS^T in
// registers, then dV += P^T dO and dK += dS^T q with P^T and dS^T as the
// register A operand (the accumulator's layout is the A fragment's). The
// step's loop keeps its counters (stage, phase, tile) incremental and its
// descriptors as a base plus constants: its instruction count, not the
// tensor cores, bounds it.
template <int D>
__global__ void __launch_bounds__(kBlock, 1)
bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_do,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               const float* __restrict__ lse2,
               const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
               __nv_bfloat16* __restrict__ dv, int B, int Sq, int Sk, int H,
               int KVH, int causal, int window, int meta, int ld,
               float scale) {
  using C = Cfg<D>;
  constexpr int W = C::W, NB = C::NB, NQ = C::NQ;
  constexpr uint32_t kResBytes = kRes * D * 2, kQBytes = NQ * D * 2;
  constexpr uint32_t kStageBytes = 2 * kQBytes;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[2 * kStages + 1];  // full, empty, resident
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t k_s = base, v_s = base + kResBytes;
  const uint32_t ring = base + 2 * kResBytes;
  const uint32_t stats = ring + kStages * kStageBytes;  // [stage][lse2, delta][NQ]
  const float* stats_f =
      reinterpret_cast<const float*>(smem_raw + (stats - raw));
  const uint32_t full = smem_u32(&bars[0]), empty = smem_u32(&bars[kStages]);
  const uint32_t res = smem_u32(&bars[2 * kStages]);

  const int groups = B * KVH;
  const int b = blockIdx.x % groups / KVH, kvh = blockIdx.x % KVH;
  const int k0 = dkdv_longest_first(blockIdx.x / groups, Sq, Sk, kRes, NQ,
                                    causal, window, meta) * kRes;
  const int G = H / KVH, off = Sk - Sq;  // query row r sits at key r + off
  // causal: query tiles wholly above the block's first key add nothing;
  // window: nor do those past the last row its last key's window reaches
  const int q_first = causal ? max(0, k0 - off) / NQ * NQ : 0;
  const int q_end = (window_rows_end(k0, min(k0 + kRes, Sk) - 1, Sq, off,
                                     window, meta) + NQ - 1) / NQ * NQ;
  // (head, tile), head-major; none when no row sees a key of the block
  const int n_steps = G * max(0, (q_end - q_first) / NQ);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 256);
    }
    mbar_init(res, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer
    setmaxnreg_dec<24>();
    if (threadIdx.x != 256) return;
    mbar_expect_tx(res, 2 * kResBytes);
    for (int c = 0; c < NB; ++c) {
      tma_load(k_s + c * kRes * W * 2, &tm_k, kvh * D + c * W, k0, b, res);
      tma_load(v_s + c * kRes * W * 2, &tm_v, kvh * D + c * W, k0, b, res);
    }
    int s = 0, h = kvh * G, q0 = q_first;
    uint32_t phase = 0;
    for (int i = 0; i < n_steps; ++i) {
      if (i >= kStages) mbar_wait(empty + 8 * s, phase ^ 1);
      const uint32_t qs = ring + s * kStageBytes, dos = qs + kQBytes;
      const uint32_t bar = full + 8 * s;
      mbar_expect_tx(bar, kStageBytes + 2 * NQ * 4);
      for (int c = 0; c < NB; ++c) {
        tma_load(qs + c * NQ * W * 2, &tm_q, h * D + c * W, q0, b, bar);
        tma_load(dos + c * NQ * W * 2, &tm_do, h * D + c * W, q0, b, bar);
      }
      const size_t row = (static_cast<size_t>(b) * H + h) * ld + q0;
      bulk_load(stats + s * 2 * NQ * 4, lse2 + row, NQ * 4, bar);
      bulk_load(stats + s * 2 * NQ * 4 + NQ * 4, delta + row, NQ * 4, bar);
      if ((q0 += NQ) == q_end) {
        q0 = q_first;
        ++h;
      }
      if (++s == kStages) {
        s = 0;
        phase ^= 1;
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, tg = lane % 4;
  const int kw0 = k0 + 64 * wg;           // the warpgroup's first key
  const int key0 = kw0 + 16 * warp + g;   // this thread's rows: key0, +8
  const float scale_log2 = scale * kLog2e;
  const uint32_t k_desc = desc_k<D>(k_s + 64 * wg * C::kRowBytes);
  const uint32_t v_desc = desc_k<D>(v_s + 64 * wg * C::kRowBytes);
  float acc_k[NB][W / 2], acc_v[NB][W / 2];
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int e = 0; e < W / 2; ++e) acc_k[c][e] = acc_v[c][e] = 0.f;

  // A step's dV and dK products stay in flight while the next step's
  // S^T and dP^T are issued; the next step's first wait retires them, and
  // only then is their stage released and their A registers rewritten.
  uint32_t pf[NQ / 4], dsf[NQ / 4];
  int in_flight = -1;  // the stage the products in flight read, or -1
  int s = 0, q0 = q_first;
  uint32_t phase = 0;
  mbar_wait(res, 0);
  if (wg == 1 && n_steps > 0) turn_pass(wg);  // warpgroup 0 issues first
  for (int i = 0; i < n_steps; ++i) {
    mbar_wait(full + 8 * s, phase);
    turn_wait(wg);
    // no key of this warpgroup reaches a row of the tile: all right of the
    // last row's diagonal, or all hidden by the window from the first row
    const bool active =
        kw0 < Sk && !(causal && kw0 > min(Sq, q0 + NQ) - 1 + off) &&
        !window_hides_tile(kw0, 64, q0 + off, window, meta);
    if (!active && (wg == 0 || i + 1 < n_steps)) turn_pass(wg);
    if (active) {
      // some pair is masked: keys past Sk, rows past Sq, the diagonal, the
      // window
      const bool masked = kw0 + 64 > Sk || q0 + NQ > Sq ||
                          (causal && kw0 + 63 > q0 + off) ||
                          window_cuts_tile(kw0, q0 + NQ - 1 + off, window,
                                           meta);
      const uint32_t qs = ring + s * kStageBytes, dos = qs + kQBytes;
      const uint32_t q_desc = desc_k<D>(qs), do_desc = desc_k<D>(dos);
      const float* ls = stats_f + s * 2 * NQ;
      const float* dls = ls + NQ;
      float st[NQ / 2], dpt[NQ / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<NQ>(st, desc<D>(k_desc + k_step<D, kRes>(kk)),
                     desc<D>(q_desc + k_step<D, NQ>(kk)), kk > 0);
      wg_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<NQ>(dpt, desc<D>(v_desc + k_step<D, kRes>(kk)),
                     desc<D>(do_desc + k_step<D, NQ>(kk)), kk > 0);
      wg_commit();
      if (wg == 0 || i + 1 < n_steps) turn_pass(wg);
      wg_wait<1>();  // S^T, and the previous step's products
      pin(st);
      pin(pf);
      pin(dsf);
      if (in_flight >= 0) mbar_arrive(empty + 8 * in_flight);
      // P^T: element e at key key0 + 8 ((e >> 1) & 1), query row
      // q0 + 8 (e >> 2) + 2 tg + (e & 1)
#pragma unroll
      for (int e = 0; e < NQ / 2; ++e)
        st[e] = ex2(st[e] * scale_log2 - ls[8 * (e >> 2) + 2 * tg + (e & 1)]);
      if (masked) {
#pragma unroll
        for (int e = 0; e < NQ / 2; ++e) {
          const int key = key0 + 8 * ((e >> 1) & 1);
          const int r = q0 + 8 * (e >> 2) + 2 * tg + (e & 1);
          st[e] = r < Sq && key < Sk &&
                          mask_visible(key, r + off, causal, window, meta)
                      ? st[e] : 0.f;
        }
      }
#pragma unroll
      for (int m = 0; m < NQ / 4; ++m) pf[m] = pack_bf16(st[2 * m], st[2 * m + 1]);
      const uint32_t dom_desc = desc_mn<D, NQ>(dos);
      wg_fence();
#pragma unroll
      for (int c = 0; c < NB; ++c)
#pragma unroll
        for (int kk = 0; kk < NQ / 16; ++kk)
          wgmma_rs<W>(acc_v[c], pf + 4 * kk,
                      desc<D>(dom_desc + mn_step<D, NQ>(c, kk)));
      wg_commit();
      wg_wait<1>();  // dP^T
      pin(dpt);
#pragma unroll
      for (int m = 0; m < NQ / 4; ++m) {
        const int qr = 8 * (m >> 1) + 2 * tg;
        dsf[m] = pack_bf16(st[2 * m] * (dpt[2 * m] - dls[qr]) * scale,
                           st[2 * m + 1] * (dpt[2 * m + 1] - dls[qr + 1]) * scale);
      }
      const uint32_t qm_desc = desc_mn<D, NQ>(qs);
      wg_fence();
#pragma unroll
      for (int c = 0; c < NB; ++c)
#pragma unroll
        for (int kk = 0; kk < NQ / 16; ++kk)
          wgmma_rs<W>(acc_k[c], dsf + 4 * kk,
                      desc<D>(qm_desc + mn_step<D, NQ>(c, kk)));
      wg_commit();
      in_flight = s;
    } else {
      if (in_flight >= 0) {
        wg_wait<0>();
        pin(pf);
        pin(dsf);
        mbar_arrive(empty + 8 * in_flight);
        in_flight = -1;
      }
      mbar_arrive(empty + 8 * s);
    }
    if ((q0 += NQ) == q_end) q0 = q_first;
    if (++s == kStages) {
      s = 0;
      phase ^= 1;
    }
  }
  wg_wait<0>();
  pin(pf);
  pin(dsf);
  if (in_flight >= 0) mbar_arrive(empty + 8 * in_flight);
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    pin(acc_k[c]);
    pin(acc_v[c]);
  }

  const size_t kv_step = static_cast<size_t>(KVH) * D;
  const size_t o0 = ((static_cast<size_t>(b) * Sk + key0) * KVH + kvh) * D;
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int e = 0; e < W / 2; e += 2) {
      const int half = (e >> 1) & 1;
      const size_t o = o0 + half * 8 * kv_step + c * W + 8 * (e >> 2) + 2 * tg;
      if (key0 + 8 * half < Sk) {
        *reinterpret_cast<uint32_t*>(dk + o) = pack_bf16(acc_k[c][e], acc_k[c][e + 1]);
        *reinterpret_cast<uint32_t*>(dv + o) = pack_bf16(acc_v[c][e], acc_v[c][e + 1]);
      }
    }
}

// ------------------------------------------------------------ bf16 dQ ---

// One block per (b, head, 128 query rows), blocks ordered query block
// first, the longest first (dq_longest_first: under the causal mask the
// last).
// Warpgroups 0 and 1 own 64 rows each, their dQ rows in f32 registers;
// warpgroup 2's first thread loads the block's q and dO once, then streams
// (K, V) tiles of NK keys through the ring in the forward's KeyTiles order:
// the meta tiles, then from the first row's window start (or 0) up to the
// causal diagonal. A step: S = q K^T
// and dP = dO V^T from shared memory, dS in registers, dQ += dS K with dS
// as the register A operand and K read transposed.
template <int D>
__global__ void __launch_bounds__(kBlock, 1)
bwd_dq_wgmma(const __grid_constant__ CUtensorMap tm_q,
             const __grid_constant__ CUtensorMap tm_do,
             const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v,
             const float* __restrict__ lse2, const float* __restrict__ delta,
             __nv_bfloat16* __restrict__ dq, int B, int Sq, int Sk, int H,
             int KVH, int causal, int window, int meta, int ld,
             float scale) {
  using C = Cfg<D>;
  constexpr int W = C::W, NB = C::NB, NK = C::NK;
  constexpr uint32_t kResBytes = kRes * D * 2, kKBytes = NK * D * 2;
  constexpr uint32_t kStageBytes = 2 * kKBytes;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[2 * kStages + 1];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base, do_s = base + kResBytes;
  const uint32_t ring = base + 2 * kResBytes;
  const uint32_t full = smem_u32(&bars[0]), empty = smem_u32(&bars[kStages]);
  const uint32_t res = smem_u32(&bars[2 * kStages]);

  const int groups = B * H;
  const int b = blockIdx.x % groups / H, h = blockIdx.x % H;
  const int qb = dq_longest_first(blockIdx.x / groups, Sq, Sk, kRes, NK,
                                  causal, window, meta);
  const int q0 = qb * kRes, kvh = h / (H / KVH), off = Sk - Sq;
  const int k_end = causal ? min(Sk, min(Sq, q0 + kRes) + off) : Sk;
  const KeyTiles tiles(k_end, NK, q0 + off, window, meta);
  const int n_steps = tiles.count;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 256);
    }
    mbar_init(res, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer
    setmaxnreg_dec<24>();
    if (threadIdx.x != 256) return;
    mbar_expect_tx(res, 2 * kResBytes);
    for (int c = 0; c < NB; ++c) {
      tma_load(q_s + c * kRes * W * 2, &tm_q, h * D + c * W, q0, b, res);
      tma_load(do_s + c * kRes * W * 2, &tm_do, h * D + c * W, q0, b, res);
    }
    int s = 0;
    uint32_t phase = 0;
    for (int t = 0; t < n_steps; ++t) {
      if (t >= kStages) mbar_wait(empty + 8 * s, phase ^ 1);
      const uint32_t ks = ring + s * kStageBytes, vs = ks + kKBytes;
      const uint32_t bar = full + 8 * s;
      mbar_expect_tx(bar, kStageBytes);
      for (int c = 0; c < NB; ++c) {
        tma_load(ks + c * NK * W * 2, &tm_k, kvh * D + c * W, tiles.k0(t, NK),
                 b, bar);
        tma_load(vs + c * NK * W * 2, &tm_v, kvh * D + c * W, tiles.k0(t, NK),
                 b, bar);
      }
      if (++s == kStages) {
        s = 0;
        phase ^= 1;
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, tg = lane % 4;
  const int qw0 = q0 + 64 * wg;                   // the warpgroup's first row
  const int rows = min(64, Sq - qw0);             // its rows (<= 0: none)
  const int r0 = 16 * warp + g;                   // this thread's rows: r0, +8
  const float scale_log2 = scale * kLog2e;
  const uint32_t q_desc = desc_k<D>(q_s + 64 * wg * C::kRowBytes);
  const uint32_t do_desc = desc_k<D>(do_s + 64 * wg * C::kRowBytes);
  // lse2 and delta are 0 past Sq up to ld, a multiple of kRes
  const size_t lrow = (static_cast<size_t>(b) * H + h) * ld + qw0 + r0;
  const float l0 = lse2[lrow], l1 = lse2[lrow + 8];
  const float dl0 = delta[lrow], dl1 = delta[lrow + 8];
  float acc[NB][W / 2];
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int e = 0; e < W / 2; ++e) acc[c][e] = 0.f;

  // a step's dQ product stays in flight while the next step's S and dP
  // are issued (as in the dK/dV kernel)
  uint32_t dsf[NK / 4];
  int in_flight = -1;
  int s = 0;
  uint32_t phase = 0;
  mbar_wait(res, 0);
  if (wg == 1 && n_steps > 0) turn_pass(wg);  // warpgroup 0 issues first
  for (int t = 0; t < n_steps; ++t) {
    mbar_wait(full + 8 * s, phase);
    turn_wait(wg);
    const int kt0 = tiles.k0(t, NK);
    const bool last = t + 1 == n_steps;
    // a tile right of the last row's diagonal, or hidden by the window
    // from the first row on, adds nothing to this warpgroup's rows
    const bool active = rows > 0 &&
                        !(causal && kt0 > qw0 + rows - 1 + off) &&
                        !window_hides_tile(kt0, NK, qw0 + off, window, meta);
    if (!active && (wg == 0 || !last)) turn_pass(wg);
    if (active) {
      const bool masked = rows < 64 || kt0 + NK > Sk ||
                          (causal && kt0 + NK - 1 > qw0 + off) ||
                          window_cuts_tile(kt0, qw0 + 63 + off, window, meta);
      const uint32_t ks = ring + s * kStageBytes, vs = ks + kKBytes;
      const uint32_t k_desc = desc_k<D>(ks), v_desc = desc_k<D>(vs);
      float sc[NK / 2], dp[NK / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<NK>(sc, desc<D>(q_desc + k_step<D, kRes>(kk)),
                     desc<D>(k_desc + k_step<D, NK>(kk)), kk > 0);
      wg_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<NK>(dp, desc<D>(do_desc + k_step<D, kRes>(kk)),
                     desc<D>(v_desc + k_step<D, NK>(kk)), kk > 0);
      wg_commit();
      if (wg == 0 || !last) turn_pass(wg);
      wg_wait<1>();  // S, and the previous step's dQ product
      pin(sc);
      pin(dsf);
      if (in_flight >= 0) mbar_arrive(empty + 8 * in_flight);
      // P: element e at row r0 + 8 ((e >> 1) & 1), key
      // kt0 + 8 (e >> 2) + 2 tg + (e & 1)
#pragma unroll
      for (int e = 0; e < NK / 2; ++e)
        sc[e] = ex2(sc[e] * scale_log2 - ((e >> 1) & 1 ? l1 : l0));
      if (masked) {
#pragma unroll
        for (int e = 0; e < NK / 2; ++e) {
          const int r = r0 + 8 * ((e >> 1) & 1);
          const int key = kt0 + 8 * (e >> 2) + 2 * tg + (e & 1);
          sc[e] = r < rows && key < Sk &&
                          mask_visible(key, qw0 + r + off, causal, window,
                                       meta)
                      ? sc[e] : 0.f;
        }
      }
      wg_wait<0>();  // dP
      pin(dp);
#pragma unroll
      for (int m = 0; m < NK / 4; ++m) {
        const float dl = (m & 1) ? dl1 : dl0;
        dsf[m] = pack_bf16(sc[2 * m] * (dp[2 * m] - dl) * scale,
                           sc[2 * m + 1] * (dp[2 * m + 1] - dl) * scale);
      }
      const uint32_t km_desc = desc_mn<D, NK>(ks);
      wg_fence();
#pragma unroll
      for (int c = 0; c < NB; ++c)
#pragma unroll
        for (int kk = 0; kk < NK / 16; ++kk)
          wgmma_rs<W>(acc[c], dsf + 4 * kk,
                      desc<D>(km_desc + mn_step<D, NK>(c, kk)));
      wg_commit();
      in_flight = s;
    } else {
      if (in_flight >= 0) {
        wg_wait<0>();
        pin(dsf);
        mbar_arrive(empty + 8 * in_flight);
        in_flight = -1;
      }
      mbar_arrive(empty + 8 * s);
    }
    if (++s == kStages) {
      s = 0;
      phase ^= 1;
    }
  }
  wg_wait<0>();
  pin(dsf);
  if (in_flight >= 0) mbar_arrive(empty + 8 * in_flight);
#pragma unroll
  for (int c = 0; c < NB; ++c) pin(acc[c]);

  const size_t q_step = static_cast<size_t>(H) * D;
  const size_t o0 = ((static_cast<size_t>(b) * Sq + qw0 + r0) * H + h) * D;
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int e = 0; e < W / 2; e += 2) {
      const int half = (e >> 1) & 1;
      if (r0 + 8 * half < rows)
        *reinterpret_cast<uint32_t*>(dq + o0 + half * 8 * q_step + c * W +
                                     8 * (e >> 2) + 2 * tg) =
            pack_bf16(acc[c][e], acc[c][e + 1]);
    }
}

// ----------------------------------------------------------------- f32 ---

constexpr int kRows = 64;   // rows per block, one thread each
constexpr int kCols = 32;   // streamed rows per shared-memory tile

template <int D>
constexpr size_t smem_bytes_f32() {
  // own rows padded by 4 floats (per-thread float4 reads of 8 neighbouring
  // rows fall on distinct banks); two streamed tiles [kCols][D]; lse and
  // delta of the streamed rows
  return (static_cast<size_t>(2 * kRows) * (D + 4) + 2 * kCols * D +
          2 * kCols) * sizeof(float);
}

template <int D>
__device__ __forceinline__ float dot_f32(const float* a, const float* b) {
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const float4* b4 = reinterpret_cast<const float4*>(b);
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < D / 4; ++d) {
    const float4 x = a4[d], y = b4[d];
    s = fmaf(x.x, y.x, s);
    s = fmaf(x.y, y.y, s);
    s = fmaf(x.z, y.z, s);
    s = fmaf(x.w, y.w, s);
  }
  return s;
}

// one thread per key: its k and v rows in shared memory, its dK and dV
// rows in registers; query rows of each head stream through shared memory,
// from the block's diagonal to the last row its keys' windows reach
template <int D>
__global__ void __launch_bounds__(kRows)
bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk,
             int H, int KVH, int causal, int window, int meta, float scale) {
  constexpr int RS = D + 4;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);  // [kRows][RS]
  float* v_s = k_s + kRows * RS;                 // [kRows][RS]
  float* q_s = v_s + kRows * RS;                 // [kCols][D]
  float* do_s = q_s + kCols * D;                 // [kCols][D]
  float* l_s = do_s + kCols * D;                 // [kCols]
  float* dl_s = l_s + kCols;                     // [kCols]

  const int t = threadIdx.x;
  const int b = blockIdx.z, kvh = blockIdx.y, k0 = blockIdx.x * kRows;
  const int G = H / KVH, off = Sk - Sq;
  const int key = k0 + t;
  const size_t q_step = static_cast<size_t>(H) * D;
  const size_t kv_step = static_cast<size_t>(KVH) * D;
  const float* kb = k + (static_cast<size_t>(b) * Sk * KVH + kvh) * D;
  const float* vb = v + (static_cast<size_t>(b) * Sk * KVH + kvh) * D;
  for (int i = t; i < kRows * D; i += kRows) {
    const int r = i / D, c = i % D;
    const bool in = k0 + r < Sk;
    k_s[r * RS + c] = in ? kb[(k0 + r) * kv_step + c] : 0.f;
    v_s[r * RS + c] = in ? vb[(k0 + r) * kv_step + c] : 0.f;
  }
  float ak[D], av[D];
#pragma unroll
  for (int d = 0; d < D; ++d) ak[d] = av[d] = 0.f;
  const int qs0 = causal ? max(0, k0 - off) / kCols * kCols : 0;
  const int qs_end = window_rows_end(k0, min(k0 + kRows, Sk) - 1, Sq, off,
                                     window, meta);
  const float* kr = k_s + t * RS;
  const float* vr = v_s + t * RS;

  for (int gi = 0; gi < G; ++gi) {
    const int h = kvh * G + gi;
    const float* qb = q + (static_cast<size_t>(b) * Sq * H + h) * D;
    const float* ob = dout + (static_cast<size_t>(b) * Sq * H + h) * D;
    const size_t lrow = (static_cast<size_t>(b) * H + h) * Sq;
    for (int c0 = qs0; c0 < qs_end; c0 += kCols) {
      const int n = min(kCols, Sq - c0);
      __syncthreads();  // the previous tile is consumed
      for (int i = t; i < kCols * D; i += kRows) {
        const int r = i / D, c = i % D;
        const bool in = r < n;
        q_s[i] = in ? qb[(c0 + r) * q_step + c] : 0.f;
        do_s[i] = in ? ob[(c0 + r) * q_step + c] : 0.f;
      }
      if (t < kCols) {
        l_s[t] = t < n ? lse[lrow + c0 + t] : 0.f;
        dl_s[t] = t < n ? delta[lrow + c0 + t] : 0.f;
      }
      __syncthreads();
      if (key >= Sk) continue;  // a ragged tile's spare threads only load
      for (int j = 0; j < n; ++j) {
        if (!mask_visible(key, c0 + j + off, causal, window, meta)) continue;
        const float* qj = q_s + j * D;
        const float* oj = do_s + j * D;
        const float p = expf(scale * dot_f32<D>(qj, kr) - l_s[j]);
        const float ds = p * (dot_f32<D>(oj, vr) - dl_s[j]) * scale;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          av[d] = fmaf(p, oj[d], av[d]);
          ak[d] = fmaf(ds, qj[d], ak[d]);
        }
      }
    }
  }
  if (key < Sk) {
    float* dko = dk + ((static_cast<size_t>(b) * Sk + key) * KVH + kvh) * D;
    float* dvo = dv + ((static_cast<size_t>(b) * Sk + key) * KVH + kvh) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dko[d] = ak[d];
      dvo[d] = av[d];
    }
  }
}

// one thread per query row: its q and dO rows in shared memory, its dQ row
// in registers; (k, v) tiles stream through shared memory in KeyTiles order
template <int D>
__global__ void __launch_bounds__(kRows)
bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           float* __restrict__ dq, int Sq, int Sk, int H, int KVH,
           int causal, int window, int meta, float scale) {
  constexpr int RS = D + 4;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [kRows][RS]
  float* do_s = q_s + kRows * RS;                // [kRows][RS]
  float* k_s = do_s + kRows * RS;                // [kCols][D]
  float* v_s = k_s + kCols * D;                  // [kCols][D]

  const int t = threadIdx.x;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kRows;
  const int kvh = h / (H / KVH);
  const int rows = min(kRows, Sq - q0);
  const int off = Sk - Sq;
  const size_t q_step = static_cast<size_t>(H) * D;
  const size_t kv_step = static_cast<size_t>(KVH) * D;
  const size_t qbase = (static_cast<size_t>(b) * Sq * H + h) * D;
  const float* kb = k + (static_cast<size_t>(b) * Sk * KVH + kvh) * D;
  const float* vb = v + (static_cast<size_t>(b) * Sk * KVH + kvh) * D;
  for (int i = t; i < kRows * D; i += kRows) {
    const int r = i / D, c = i % D;
    const bool in = r < rows;
    q_s[r * RS + c] = in ? q[qbase + (q0 + r) * q_step + c] : 0.f;
    do_s[r * RS + c] = in ? dout[qbase + (q0 + r) * q_step + c] : 0.f;
  }
  const size_t lrow = (static_cast<size_t>(b) * H + h) * Sq + q0;
  const float l = t < rows ? lse[lrow + t] : 0.f;
  const float dl = t < rows ? delta[lrow + t] : 0.f;
  const int q_pos = q0 + t + off;
  const int k_end = causal ? min(Sk, q0 + rows + off) : Sk;
  const KeyTiles tiles(k_end, kCols, q0 + off, window, meta);
  const float* qr = q_s + t * RS;
  const float* orow = do_s + t * RS;
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;

  for (int tile = 0; tile < tiles.count; ++tile) {
    const int c0 = tiles.k0(tile, kCols);
    const int n = min(kCols, Sk - c0);
    __syncthreads();
    for (int i = t; i < kCols * D; i += kRows) {
      const int r = i / D, c = i % D;
      const bool in = r < n;
      k_s[i] = in ? kb[(c0 + r) * kv_step + c] : 0.f;
      v_s[i] = in ? vb[(c0 + r) * kv_step + c] : 0.f;
    }
    __syncthreads();
    if (t >= rows) continue;
    for (int j = 0; j < n; ++j) {
      if (causal && c0 + j > q_pos) break;
      if (window_hidden(c0 + j, q_pos, window, meta)) continue;
      const float* kj = k_s + j * D;
      const float p = expf(scale * dot_f32<D>(qr, kj) - l);
      const float ds = p * (dot_f32<D>(orow, v_s + j * D) - dl) * scale;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(ds, kj[d], acc[d]);
    }
  }
  if (t < rows) {
    float* o = dq + qbase + (q0 + t) * q_step;
#pragma unroll
    for (int d = 0; d < D; ++d) o[d] = acc[d];
  }
}


// ------------------------------------------------------------ delta ---

// delta[b, h, r] = rowsum(dO * O) in f32 for r < Sq, 0 for Sq <= r < ld
// (the row stride ld pads each (b, h) row for the bulk copies of the bf16
// kernels); with lse2 non-null also lse2 = lse * log2(e) (0 past Sq). O is
// the forward's f32 output before its rounding to dO's dtype (the residual
// the reference keeps): from a bf16 O, delta would carry its rounding,
// dO.(O - bf16(O)), into every dS = P (dP - delta) of the row alike, which
// the products with keys of a common mean do not cancel.
// L lanes read one W-wide row of dO with 16-byte loads (EPV elements
// each) and the same columns of O, and sum their products through
// shuffles: one warp covers 32 / L rows.
template <typename T, int W>
__global__ void __launch_bounds__(256)
bwd_delta(const float* __restrict__ out, const T* __restrict__ dout,
          const float* __restrict__ lse, float* __restrict__ delta,
          float* __restrict__ lse2, int B, int Sq, int H, int ld) {
  constexpr int EPV = 16 / static_cast<int>(sizeof(T));  // per 16 bytes
  constexpr int L = W / EPV;                              // lanes a row
  static_assert(L >= 1 && L <= 32 && W % EPV == 0, "row of whole vectors");
  const int lane = threadIdx.x & 31;
  const long long o =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / L;
  const long long n_out = static_cast<long long>(B) * H * ld;
  const int bh = static_cast<int>(o / ld), r = static_cast<int>(o % ld);
  const bool in = o < n_out && r < Sq;
  float s = 0.f;
  if (in) {
    const int b = bh / H, h = bh % H;
    const size_t row =
        ((static_cast<size_t>(b) * Sq + r) * H + h) * W + (lane % L) * EPV;
    const uint4 y = *reinterpret_cast<const uint4*>(dout + row);
    const float4* x = reinterpret_cast<const float4*>(out + row);
    if constexpr (sizeof(T) == 2) {
      const __nv_bfloat162* ys = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const float4 a = x[e / 2];
        const float2 c0 = __bfloat1622float2(ys[e]);
        const float2 c1 = __bfloat1622float2(ys[e + 1]);
        s = fmaf(a.x, c0.x, s);
        s = fmaf(a.y, c0.y, s);
        s = fmaf(a.z, c1.x, s);
        s = fmaf(a.w, c1.y, s);
      }
    } else {
      const float4 a = x[0];
      const float4 c = *reinterpret_cast<const float4*>(&y);
      s = fmaf(a.x, c.x, s);
      s = fmaf(a.y, c.y, s);
      s = fmaf(a.z, c.z, s);
      s = fmaf(a.w, c.w, s);
    }
  }
#pragma unroll
  for (int m = L / 2; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
  if (o < n_out && lane % L == 0) {
    delta[o] = s;
    if (lse2 != nullptr)
      lse2[o] = r < Sq ? lse[static_cast<size_t>(bh) * Sq + r] * kLog2e : 0.f;
  }
}

// ------------------------------------------------------------- launches ---

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

struct Args {
  const void *q, *k, *v, *out, *dout;
  const float* lse;
  float *delta, *lse2;
  void *dq, *dk, *dv;
  int B, Sq, Sk, H, KVH, causal, window, meta, ld;
  float scale;
};

// launch 0: delta (and lse2 where given) for every (b, h) row
template <typename T, int D>
cudaError_t launch_delta(const Args& a, cudaStream_t s) {
  constexpr int L = D * static_cast<int>(sizeof(T)) / 16;
  const long long threads = static_cast<long long>(a.B) * a.H * a.ld * L;
  bwd_delta<T, D><<<static_cast<unsigned>((threads + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(a.out), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.lse2, a.B, a.Sq, a.H, a.ld);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// the bf16 tensor [B, S, heads, D] as a 3-D map (heads * D columns, S rows,
// B batches), boxes of `rows` rows by W columns with W's swizzle: rows past
// S read as zeros, never as the next batch's rows
template <int D>
bool tensor_map(CUtensorMap* map, const void* ptr, int B, int S, int heads,
                int rows) {
  using C = Cfg<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t cols = static_cast<cuuint64_t>(heads) * D;
  const cuuint64_t dims[3] = {cols, static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {cols * 2, cols * 2 * S};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(C::W),
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      C::W == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
      : C::W == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_bf16(const Args& a, cudaStream_t s) {
  using C = Cfg<D>;
  using T = __nv_bfloat16;
  constexpr size_t smem_kv = 1024 + 2 * kRes * D * 2 +
                             kStages * (2 * C::NQ * D * 2 + 2 * C::NQ * 4);
  constexpr size_t smem_q = 1024 + 2 * kRes * D * 2 + kStages * 2 * C::NK * D * 2;
  cudaError_t err = allow_smem(bwd_dkdv_wgmma<D>, smem_kv);
  if (err == cudaSuccess) err = allow_smem(bwd_dq_wgmma<D>, smem_q);
  if (err == cudaSuccess) err = launch_delta<T, D>(a, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap mq, mdo, mk, mv;
  if (!tensor_map<D>(&mq, a.q, a.B, a.Sq, a.H, C::NQ) ||
      !tensor_map<D>(&mdo, a.dout, a.B, a.Sq, a.H, C::NQ) ||
      !tensor_map<D>(&mk, a.k, a.B, a.Sk, a.KVH, kRes) ||
      !tensor_map<D>(&mv, a.v, a.B, a.Sk, a.KVH, kRes))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_kt = (a.Sk + kRes - 1) / kRes;
  bwd_dkdv_wgmma<D><<<n_kt * a.B * a.KVH, kBlock, smem_kv, s>>>(
      mq, mdo, mk, mv, a.lse2, a.delta, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.B, a.Sq, a.Sk, a.H, a.KVH, a.causal, a.window,
      a.meta, a.ld, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!tensor_map<D>(&mq, a.q, a.B, a.Sq, a.H, kRes) ||
      !tensor_map<D>(&mdo, a.dout, a.B, a.Sq, a.H, kRes) ||
      !tensor_map<D>(&mk, a.k, a.B, a.Sk, a.KVH, C::NK) ||
      !tensor_map<D>(&mv, a.v, a.B, a.Sk, a.KVH, C::NK))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_qb = (a.Sq + kRes - 1) / kRes;
  bwd_dq_wgmma<D><<<n_qb * a.B * a.H, kBlock, smem_q, s>>>(
      mq, mdo, mk, mv, a.lse2, a.delta, static_cast<T*>(a.dq), a.B, a.Sq,
      a.Sk, a.H, a.KVH, a.causal, a.window, a.meta, a.ld, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const Args& a, cudaStream_t s) {
  constexpr size_t smem = smem_bytes_f32<D>();
  cudaError_t err = allow_smem(bwd_dkdv_f32<D>, smem);
  if (err == cudaSuccess) err = allow_smem(bwd_dq_f32<D>, smem);
  if (err == cudaSuccess) err = launch_delta<float, D>(a, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_kv((a.Sk + kRows - 1) / kRows, a.KVH, a.B);
  bwd_dkdv_f32<D><<<grid_kv, kRows, smem, s>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
      a.Sq, a.Sk, a.H, a.KVH, a.causal, a.window, a.meta, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q((a.Sq + kRows - 1) / kRows, a.H, a.B);
  bwd_dq_f32<D><<<grid_q, kRows, smem, s>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(a.dq), a.Sq, a.Sk, a.H, a.KVH,
      a.causal, a.window, a.meta, a.scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, dout, dq [B, Sq, H, D]; k, v, dk, dv [B, Sk, KVH, D]; one dtype,
// contiguous, 16-byte aligned; out f32 [B, Sq, H, D], the forward's output
// before its rounding to that dtype; lse f32 [B, H, Sq]; delta f32 [B, H, ld]
// and (bf16) lse2 f32 [B, H, ld], scratch that launch 0 fills, ld >= Sq
// (bf16: a multiple of 128; f32: Sq). B, Sq, Sk >= 1; H % KVH == 0; D in
// {16, 32, 64, 128}; causal needs Sq <= Sk; window >= 0 and meta >= 0, a
// window only with causal (window 0: no window), the forward's; scale is
// 1 / sqrt of the caller's true head width. Three launches (delta, dK/dV,
// dQ) on one stream; returns the first error (a cudaError_t; 0 = all
// queued).
#define REPRO_BWD_CASE(launch, W) \
  case W:                         \
    return launch<W>(a, s);
#define REPRO_BWD_ENTRY(name, launch)                                         \
  extern "C" int name(const void* q, const void* k, const void* v,           \
                      const void* out, const void* dout, const void* lse,    \
                      void* delta, void* lse2, void* dq, void* dk, void* dv, \
                      int B, int Sq, int Sk, int H, int KVH, int D,          \
                      int causal, int window, int meta, int ld, float scale, \
                      void* stream) {                                        \
    const Args a{q, k, v, out, dout, static_cast<const float*>(lse),         \
                 static_cast<float*>(delta), static_cast<float*>(lse2), dq,  \
                 dk, dv, B, Sq, Sk, H, KVH, causal, window, meta, ld,        \
                 scale};                                                     \
    const cudaStream_t s = static_cast<cudaStream_t>(stream);                \
    switch (D) {                                                             \
      REPRO_BWD_CASE(launch, 16)                                             \
      REPRO_BWD_CASE(launch, 32)                                             \
      REPRO_BWD_CASE(launch, 64)                                             \
      REPRO_BWD_CASE(launch, 128)                                            \
      default: return static_cast<int>(cudaErrorInvalidValue);               \
    }                                                                        \
  }

REPRO_BWD_ENTRY(flash_attention_bwd_bf16, launch_bf16)
REPRO_BWD_ENTRY(flash_attention_bwd_f32, launch_f32)
