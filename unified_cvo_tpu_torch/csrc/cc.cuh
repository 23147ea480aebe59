// Union-find on the card, shared by the connected-components kernels of
// lidar.cu (L1, the range image's 4 links) and image.cu (components8, the
// 8-connected pixels of a mask).
//
// Three passes, each a launch:
//   tile    one block of TILE_W x TILE_H threads labels one tile of as many
//           cells in shared memory. Each warp is one row of the tile: a
//           ballot of the row's links to the right gives every cell the
//           start of its run, so the row needs no union at all; the links
//           to the row below hook run under run with shared-memory
//           atomicMin, one union for each pair of runs that touch (a cell
//           skips its union when its left neighbour makes the same one),
//           and finds halve the paths they walk.
//           The block then writes each cell's local root as a global id.
//           Local indices are row-major, in the order of the global ids, so
//           the smallest local index of a component is its smallest id.
//   border  one thread for each cell on a tile's bottom row and right (and,
//           for 8-connectivity, left) column joins the links that leave the
//           tile, on the global labels: the larger root is hooked under the
//           smaller with atomicMin, and find halves the path it walks.
//   compress every cell points at its root.
//
// A parent only ever falls (hooks and path halving all go through
// atomicMin), so the root of a component ends as its smallest cell id,
// whatever order the hooks ran in: two launches give the same bits, and the
// plain versions (min-label propagation with pointer jumping) give the
// same labels.
//
// What bounds it on this card: the bytes (a link byte or two and an int32
// label a cell) and the launches. The old design (one thread a cell, one
// global atomicMin hook a link, finds without compression) walked long
// chains in large components: 0.44-0.56 ms at 376 x 1241 against a byte
// bound of 0.0008 ms. Here a cell makes at most one global find (border
// cells only) and one walk to its root in compress.

#pragma once

#include <cuda_runtime.h>

namespace cc {

constexpr int TILE_W = 32;               // a tile row is a warp
// rows of a tile: one block of TILE_W x TILE_H threads. 16 measured best
// over 8, 16 and 32 on the main paths' inputs (PERF.md, section 6)
constexpr int TILE_H = 16;
constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------- tile pass

// Run starts of one tile row: bit j of `right` says cell j links to j + 1.
// Returns the lane of the first cell of this lane's run.
__device__ __forceinline__ int run_start(unsigned right, int lane) {
  const unsigned starts = ~(right << 1);               // bit 0 always set
  return 31 - __clz(starts & (FULL >> (31 - lane)));   // the last start at or left of lane
}

// Root of local cell x, halving the path on the way (atomicMin: a parent
// only falls).
__device__ __forceinline__ int find_shared(int* s, int x) {
  const volatile int* vs = s;
  while (true) {
    const int p = vs[x];
    if (p == x) return x;
    const int g = vs[p];
    if (g == p) return p;
    atomicMin(s + x, g);
    x = g;
  }
}

// Join the components of local cells a and b: hook the larger root under
// the smaller. If another thread hooked that root first, join with where it
// now points.
__device__ inline void unite_shared(int* s, int a, int b) {
  while (true) {
    a = find_shared(s, a);
    b = find_shared(s, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(&s[b], a);
    if (old == b) return;
    b = old;
  }
}

// The global id of local cell li of the tile whose first cell is (r0, c0).
__device__ __forceinline__ int global_id(int li, int r0, int c0, int cols) {
  return (r0 + li / TILE_W) * cols + c0 + li % TILE_W;
}

// ------------------------------------------------------------- border pass

// Root of x in the global labels, halving the path on the way: each cell
// passed is hooked (atomicMin) to its grandparent, an ancestor with a
// smaller id. Loads bypass L1 (other SMs hook concurrently).
__device__ __forceinline__ int find_global(int* parent, int x) {
  while (true) {
    const int p = __ldcg(parent + x);
    if (p == x) return x;
    const int g = __ldcg(parent + p);
    if (g == p) return p;
    atomicMin(parent + x, g);
    x = g;
  }
}

__device__ inline void unite_global(int* parent, int a, int b) {
  while (true) {
    a = find_global(parent, a);
    b = find_global(parent, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(parent + b, a);
    if (old == b) return;
    b = old;
  }
}

// ---------------------------------------------------------- compress pass

// Nothing hooks any more, and a root's entry never changes: plain loads
// (a stale one is only a longer way to the same root), the path halved as
// it is walked. The halving goes through atomicMin too: a plain store of a
// grandparent could land after that cell's own thread wrote its root, and
// leave it an ancestor that is not the root. Halving is optional, so any
// subset of the threads may do it.
__global__ void compress(int* parent, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int x = parent[i];
  while (true) {
    const int p = parent[x];
    if (p == x) break;
    const int g = parent[p];
    if (g == p) {
      x = p;
      break;
    }
    // one halving for each distinct x in the warp: the cells of a tile walk
    // the same few roots, and same-address atomics serialise
    const unsigned peers = __match_any_sync(__activemask(), x);
    if ((int)(threadIdx.x & 31) == __ffs(peers) - 1) atomicMin(parent + x, g);
    x = g;
  }
  parent[i] = x;
}

}  // namespace cc
