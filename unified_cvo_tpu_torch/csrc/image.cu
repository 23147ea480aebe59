// The hysteresis of the host stereo frontend's Canny edges
// (ops/canny.py), written for Hopper (sm_90a). It replaces no Pallas
// kernel: the JAX package calls cv2.Canny on the host
// (unified_cvo_tpu/frontend/selector.py:188, _canny_uniform_orb), and its
// hysteresis is a stack-driven flood fill from the strong pixels over the
// 8 neighbours. As torch ops on the card that fill is a loop of data-
// dependent rounds; here it is the connected components of the candidate
// pixels under 8-connectivity, one pass each of tile, border and compress
// (cc.cuh): a candidate joins its four forward neighbours (right,
// down-left, down, down-right) when they are candidates too, and a join
// that another pixel's joins already make is skipped. The labels are
// the smallest pixel id of each component (a pixel off the mask is its own
// component), so two launches give the same bits, and the plain version
// (min-label propagation over the same links) gives the same labels. The
// edges are then the candidates whose component holds a strong pixel
// (torch, ops/canny.py).
//
// What bounds it on this card: it moves a byte and an int32 a pixel (2.3
// MB at 1241 x 376) and computes next to nothing; three short launches.
//
// Which joins are skipped, for a candidate i with d = i + cols below it:
// straight down (i, d) where i - 1 and d - 1 are candidates too (then
// i - 1 makes it, or the first of a run of such pixels to its left); the
// diagonals only where d is not a candidate (else the run through d joins
// them), and down-left where i - 1 is no candidate, down-right where i + 1
// is none (else that neighbour's straight-down join makes it).

#include <cuda_runtime.h>
#include <stdint.h>

#include "cc.cuh"

namespace {

// Tile pass: block (TILE_W, TILE_H) threads, grid (tiles across, tiles
// down); the joins that stay inside the tile.
__global__ void __launch_bounds__(cc::TILE_W * cc::TILE_H)
    cc_tile8(const uint8_t* __restrict__ mask, int* __restrict__ labels, int rows, int cols) {
  using cc::TILE_H;
  using cc::TILE_W;
  __shared__ int s[TILE_W * TILE_H];
  __shared__ unsigned in_mask[TILE_H];               // per tile row: bit j = candidate
  const int lc = threadIdx.x, lr = threadIdx.y;
  const int r0 = blockIdx.y * TILE_H, c0 = blockIdx.x * TILE_W;
  const int r = r0 + lr, c = c0 + lc, i = r * cols + c, li = lr * TILE_W + lc;
  const bool in = r < rows && c < cols;
  const bool m = in && __ldg(mask + i);
  const unsigned mb = __ballot_sync(cc::FULL, m);
  s[li] = lr * TILE_W + cc::run_start(mb & (mb >> 1), lc);   // runs of candidates
  if (lc == 0) in_mask[lr] = mb;
  __syncthreads();
  if (m && lr + 1 < TILE_H && r + 1 < rows) {
    const unsigned below = in_mask[lr + 1];
    const bool left = lc > 0 && (mb >> (lc - 1) & 1u);
    const bool next = lc + 1 < TILE_W && (mb >> (lc + 1) & 1u);
    if (below >> lc & 1u) {
      if (!(left && (below >> (lc - 1) & 1u))) cc::unite_shared(s, li, li + TILE_W);
    } else {
      if (lc > 0 && !left && (below >> (lc - 1) & 1u)) cc::unite_shared(s, li, li + TILE_W - 1);
      if (lc + 1 < TILE_W && !next && (below >> (lc + 1) & 1u))
        cc::unite_shared(s, li, li + TILE_W + 1);
    }
  }
  __syncthreads();
  if (in) labels[i] = cc::global_id(cc::find_shared(s, li), r0, c0, cols);
}

// Border pass: TILE_W + 2 TILE_H threads a tile, grid (tiles across, tiles
// down). Threads 0..TILE_W-1 take the tile's bottom row (its joins down into
// the next tile row: down, down-left, down-right), the next TILE_H its last
// column (right, and down-right above the bottom row), the last TILE_H its
// first column (down-left above the bottom row). Nothing wraps.
__global__ void cc_border8(const uint8_t* __restrict__ mask, int* labels, int rows, int cols) {
  using cc::TILE_H;
  using cc::TILE_W;
  const int r0 = blockIdx.y * TILE_H, c0 = blockIdx.x * TILE_W, t = threadIdx.x;
  auto at = [&](int rr, int cc_) { return __ldg(mask + rr * cols + cc_) != 0; };
  if (t < TILE_W) {
    const int k = t, r = r0 + TILE_H - 1, c = c0 + k, i = r * cols + c, d = i + cols;
    if (r + 1 >= rows || c >= cols || !at(r, c)) return;
    const bool left = k > 0 && at(r, c - 1);
    if (at(r + 1, c)) {
      if (!(left && at(r + 1, c - 1))) cc::unite_global(labels, i, d);
      return;
    }
    if (c > 0 && !left && at(r + 1, c - 1)) cc::unite_global(labels, i, d - 1);
    if (c + 1 < cols && !(k + 1 < TILE_W && at(r, c + 1)) && at(r + 1, c + 1))
      cc::unite_global(labels, i, d + 1);
  } else if (t < TILE_W + TILE_H) {
    const int k = t - TILE_W, r = r0 + k, c = c0 + TILE_W - 1, i = r * cols + c;
    if (r >= rows || c + 1 >= cols || !at(r, c)) return;
    const bool next = at(r, c + 1);
    if (next && !(k > 0 && at(r - 1, c) && at(r - 1, c + 1))) cc::unite_global(labels, i, i + 1);
    if (k + 1 < TILE_H && r + 1 < rows && !next && !at(r + 1, c) && at(r + 1, c + 1))
      cc::unite_global(labels, i, i + cols + 1);
  } else {
    const int k = t - TILE_W - TILE_H, r = r0 + k, c = c0, i = r * cols + c;
    if (r >= rows || c == 0 || k + 1 >= TILE_H || r + 1 >= rows || !at(r, c)) return;
    if (!at(r, c - 1) && !at(r + 1, c) && at(r + 1, c - 1))
      cc::unite_global(labels, i, i + cols - 1);
  }
}

}  // namespace

extern "C" {

// mask [rows, cols] bytes (1 = in) -> labels [rows, cols] int32, the
// smallest pixel id of each pixel's 8-connected component of the mask.
int cvo_image_components8(const uint8_t* mask, int* labels, int rows, int cols,
                          cudaStream_t stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  const int n = rows * cols, threads = 256, blocks = (n + threads - 1) / threads;
  const dim3 tiles((cols + cc::TILE_W - 1) / cc::TILE_W, (rows + cc::TILE_H - 1) / cc::TILE_H);
  cc_tile8<<<tiles, dim3(cc::TILE_W, cc::TILE_H), 0, stream>>>(mask, labels, rows, cols);
  cc_border8<<<tiles, cc::TILE_W + 2 * cc::TILE_H, 0, stream>>>(mask, labels, rows, cols);
  cc::compress<<<blocks, threads, 0, stream>>>(labels, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
