// The attention mask and the tile ranges it lets a block skip, shared by
// the forward (flash_attention.cu) and the backward (flash_attention_bwd.cu).
//
// Causal attention, with the hybrid family's sliding window and meta tokens
// (the mask of src/repro/models/attention.py:50 _mask_block): the query row
// at position p (row r of Sq sits at p = r + Sk - Sq) sees key j when
// j <= p and, with window > 0, either j > p - window or j < meta. window 0
// is plain causal attention. A window of at least Sk hides nothing more than
// causal, and every range below is then the causal one: the kernels load the
// same tiles in the same order and give the causal result bit for bit.
#pragma once

#include <cuda_runtime.h>

namespace {

// the window (not the diagonal) hides key j from the query at position p
__device__ __forceinline__ bool window_hidden(int j, int p, int window,
                                              int meta) {
  return window > 0 && j >= meta && j <= p - window;
}
// key j is visible to the query at position p
__device__ __forceinline__ bool mask_visible(int j, int p, int causal,
                                             int window, int meta) {
  return !(causal && j > p) && !window_hidden(j, p, window, meta);
}
// the window hides every key of [k0, k0 + n) from every query at position
// p or later: none is a meta key, and the last lies at or before p - window
__device__ __forceinline__ bool window_hides_tile(int k0, int n, int p,
                                                  int window, int meta) {
  return window > 0 && k0 >= meta && k0 + n - 1 <= p - window;
}
// the window may hide some key from k0 on from some query at position
// p_last or before (the tile then needs the per-element mask)
__device__ __forceinline__ bool window_cuts_tile(int k0, int p_last,
                                                 int window, int meta) {
  return window > 0 && max(k0, meta) <= p_last - window;
}

// The key tiles a block of query rows whose first row sits at p_first loads,
// in order (forward and dQ): the n_meta tiles holding meta keys (window > 0
// only), then tiles t_lo .. t_end - 1, from the first row's window start (or
// 0) to the tile holding the block's last visible key, k_end - 1. Tiles
// between them are hidden from every row of the block.
struct KeyTiles {
  int n_meta, t_lo, count;
  __device__ KeyTiles(int k_end, int tile, int p_first, int window,
                      int meta) {
    const int t_end = (k_end + tile - 1) / tile;
    n_meta = 0;
    t_lo = 0;
    if (window > 0) {
      n_meta = min((meta + tile - 1) / tile, t_end);
      t_lo = max(n_meta, max(0, p_first - window + 1) / tile);
    }
    count = n_meta + max(0, t_end - t_lo);
  }
  // first key of the i-th tile loaded
  __device__ int k0(int i, int tile) const {
    return (i < n_meta ? i : t_lo + i - n_meta) * tile;
  }
};

// dK/dV: the exclusive end of the query rows (row r at r + off) that see
// some key of k_first .. k_last. Key j's last row under the window is
// j + window - 1 - off; a block holding a meta key (k_first < meta) is seen
// by every later row. The rows start at the causal diagonal, k_first - off.
__device__ __forceinline__ int window_rows_end(int k_first, int k_last,
                                               int Sq, int off, int window,
                                               int meta) {
  if (window <= 0 || k_first < meta) return Sq;
  return max(0, min(Sq, k_last + window - off));
}

// dK/dV: the query tiles of nq rows that the block of `keys` keys from
// key block kb walks, from its diagonal to window_rows_end
__device__ __forceinline__ int dkdv_tiles(int kb, int Sq, int Sk, int keys,
                                          int nq, int causal, int window,
                                          int meta) {
  const int off = Sk - Sq, k0 = kb * keys;
  const int first = causal ? max(0, k0 - off) / nq * nq : 0;
  const int end = (window_rows_end(k0, min(k0 + keys, Sk) - 1, Sq, off,
                                   window, meta) + nq - 1) / nq * nq;
  return max(0, end - first) / nq;
}

// dK/dV: the key block of `keys` keys that the i-th launched block takes,
// longest first (most query tiles, dkdv_tiles). Without a window the
// count never rises from one key block to the next: block order. With
// one, the blocks holding meta keys walk every row from their diagonal
// and go first; the others' counts rise to a peak (with Sq < Sk, blocks
// before the first row's window walk none), then fall, so the rest go as
// the merge of the blocks from the peak on with those before it, latest
// first. With Sq = Sk the peak is the first of them: block order again.
__device__ __forceinline__ int dkdv_longest_first(int i, int Sq, int Sk,
                                                  int keys, int nq,
                                                  int causal, int window,
                                                  int meta) {
  const int n = (Sk + keys - 1) / keys;
  const int m = min(n, (meta + keys - 1) / keys);  // blocks with meta keys
  if (window <= 0 || i < m) return i;
  auto count = [&](int kb) {
    return dkdv_tiles(kb, Sq, Sk, keys, nq, causal, window, meta);
  };
  int peak = m;   // the first block of the highest count after the meta
  for (int kb = m + 1, best = count(m); kb < n; ++kb) {
    const int c = count(kb);
    if (c > best) {
      best = c;
      peak = kb;
    }
  }
  int r = peak, l = peak - 1;   // heads of the falling and the rising run
  for (int j = m;; ++j) {
    const bool right = r < n && (l < m || count(r) >= count(l));
    const int kb = right ? r++ : l--;
    if (j == i) return kb;
  }
}

// dQ: the query block of `rows` rows that the i-th launched block takes,
// longest first (most key tiles of `tile` keys, KeyTiles). Full attention:
// every block walks all keys, in block order. Causal: the count never falls
// from one whole block to the next (the diagonal moves right; under a window
// its start moves with it and the meta tiles stay), so the blocks go last
// first; a ragged last block walks at least as many tiles as the whole block
// before it without a window, but may walk fewer with one, and then goes
// after every whole block that walks more.
__device__ __forceinline__ int dq_longest_first(int i, int Sq, int Sk,
                                                int rows, int tile,
                                                int causal, int window,
                                                int meta) {
  const int n = (Sq + rows - 1) / rows;
  if (!causal) return i;
  if (window <= 0 || Sq % rows == 0) return n - 1 - i;
  const int off = Sk - Sq;
  auto count = [&](int qb) {
    const int q0 = qb * rows;
    return KeyTiles(min(Sk, min(Sq, q0 + rows) + off), tile, q0 + off,
                    window, meta).count;
  };
  const int last = count(n - 1);
  int ahead = 0;   // whole blocks, latest first, that walk more tiles
  while (ahead < n - 1 && count(n - 2 - ahead) > last) ++ahead;
  return i < ahead ? n - 2 - i : i == ahead ? n - 1 : n - 1 - i;
}

}  // namespace
