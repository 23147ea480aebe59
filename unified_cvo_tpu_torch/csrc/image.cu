// The hysteresis of the host stereo frontend's Canny edges
// (ops/canny.py), written for Hopper (sm_90a). It replaces no Pallas
// kernel: the JAX package calls cv2.Canny on the host
// (unified_cvo_tpu/frontend/selector.py:188, _canny_uniform_orb), and its
// hysteresis is a stack-driven flood fill from the strong pixels over the
// 8 neighbours. As torch ops on the card that fill is a loop of data-
// dependent rounds; here it is the connected components of the candidate
// pixels under 8-connectivity, one pass each of init, hook and compress
// (cc.cuh): a candidate hooks its four forward neighbours (right,
// down-left, down, down-right) when they are candidates too. The labels are
// the smallest pixel id of each component (a pixel off the mask is its own
// component), so two launches give the same bits, and the plain version
// (min-label propagation over the same links) gives the same labels. The
// edges are then the candidates whose component holds a strong pixel
// (torch, ops/canny.py).
//
// What bounds it on this card: it moves a byte and an int32 a pixel (2.3
// MB at 1241 x 376) and computes next to nothing; three short launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cc.cuh"

namespace {

// mask [rows, cols] bytes: pixel i joins each forward 8-neighbour that is
// also in the mask
__global__ void hook8(const uint8_t* mask, int* parent, int rows, int cols) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * cols || !mask[i]) return;
  const int r = i / cols, c = i - r * cols;
  if (c + 1 < cols && mask[i + 1]) cc::unite(parent, i, i + 1);
  if (r + 1 < rows) {
    const int d = i + cols;
    if (c > 0 && mask[d - 1]) cc::unite(parent, i, d - 1);
    if (mask[d]) cc::unite(parent, i, d);
    if (c + 1 < cols && mask[d + 1]) cc::unite(parent, i, d + 1);
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
  cc::init<<<blocks, threads, 0, stream>>>(labels, n);
  hook8<<<blocks, threads, 0, stream>>>(mask, labels, rows, cols);
  cc::compress<<<blocks, threads, 0, stream>>>(labels, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
