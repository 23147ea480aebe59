// Union-find on the card, shared by the connected-components kernels of
// lidar.cu (L1, the range image's 4 links) and image.cu (components8, the
// 8-connected pixels of a mask).
//
// One thread a cell hooks its links with atomicMin on the parent array: a
// root's parent only ever falls, so the root of a component ends as its
// smallest cell id, whatever order the hooks ran in. A last pass points
// every cell at its root. So two launches give the same bits, and the
// plain versions (min-label propagation with pointer jumping) give the
// same labels.

#pragma once

#include <cuda_runtime.h>

namespace cc {

__device__ __forceinline__ int find_root(const int* parent, int x) {
  const volatile int* p = parent;
  int q = p[x];
  while (q != x) {
    x = q;
    q = p[x];
  }
  return x;
}

// Join the components of a and b: hook the larger root under the smaller.
// If another thread hooked that root first, join with where it now points.
__device__ inline void unite(int* parent, int a, int b) {
  while (true) {
    a = find_root(parent, a);
    b = find_root(parent, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(&parent[b], a);
    if (old == b) return;
    b = old;
  }
}

__global__ void init(int* parent, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) parent[i] = i;
}

__global__ void compress(int* parent, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) parent[i] = find_root(parent, i);
}

}  // namespace cc
