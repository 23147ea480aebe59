// Deterministic block reductions shared by the port's kernels.
//
// Every sum runs in a fixed order (warp butterflies, then warp 0 over the
// per-warp partials), so a rerun on the same inputs and launch shape gives
// identical bits. No float atomics anywhere.
#pragma once

#include <cuda_runtime.h>

namespace cvo {

constexpr unsigned kFullMask = 0xffffffffu;

template <typename T, int NV>
__device__ __forceinline__ void warp_sum(T (&v)[NV]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < NV; ++i) v[i] += __shfl_xor_sync(kFullMask, v[i], off);
  }
}

// Sums v over the whole block. `smem` holds NV * (blockDim / 32) values.
// The result is valid in thread 0 (in fact in every lane of warp 0).
// Every thread of the block must call it; blockDim must be a multiple of 32
// and at most 1024.
template <typename T, int NV>
__device__ __forceinline__ void block_sum(T (&v)[NV], T* smem, int tid,
                                          int nthreads) {
  warp_sum<T, NV>(v);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) smem[warp * NV + i] = v[i];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) v[i] = lane < nwarps ? smem[lane * NV + i] : T(0);
    warp_sum<T, NV>(v);
  }
}

// Sums v (type T) and u (type U) over the whole block in one shared-memory
// pass: each array is summed in the same order as block_sum would sum it
// alone, so the results are bit-equal to two block_sum calls. `smem` holds
// NV * (blockDim / 32) values, `smem_u` NU * (blockDim / 32).
template <typename T, int NV, typename U, int NU>
__device__ __forceinline__ void block_sum(T (&v)[NV], U (&u)[NU], T* smem,
                                          U* smem_u, int tid, int nthreads) {
  warp_sum<T, NV>(v);
  warp_sum<U, NU>(u);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) smem[warp * NV + i] = v[i];
#pragma unroll
    for (int i = 0; i < NU; ++i) smem_u[warp * NU + i] = u[i];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) v[i] = lane < nwarps ? smem[lane * NV + i] : T(0);
#pragma unroll
    for (int i = 0; i < NU; ++i) u[i] = lane < nwarps ? smem_u[lane * NU + i] : U(0);
    warp_sum<T, NV>(v);
    warp_sum<U, NU>(u);
  }
}

}  // namespace cvo
