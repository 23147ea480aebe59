// ELL consume kernels of the align hot loop, written for Hopper (sm_90a).
//
// Replaces two TPU kernels of the JAX package:
//   * flow_reduce  <- unified_cvo_tpu/ops/pallas_ell.py::_flow_reduce_kernel
//                     (with _transform_and_a), reached through
//                     flow_twist_ell_fused(emit_a=True)
//   * step_cached  <- unified_cvo_tpu/ops/pallas_ell.py::_step_kernel_cached
//                     with _step_tail, reached through
//                     step_coeffs_ell_fused_cached
//
// What bounds them on this card: bytes. Each slot costs a few dozen flops
// and one expf against 16 bytes of slot data (raw xyz in, A out for flow;
// raw xyz and A in for step); at N = 16384, K = 32 a pass moves about
// 8.8 MB, a few microseconds of HBM time, while the arithmetic is far
// below the f32 peak. The design therefore reads every slot array exactly
// once, coalesced, and keeps all intermediates in registers:
//   * a block is 32 source points (threadIdx.x, adjacent in memory) times
//     8 slot groups (threadIdx.y); thread (x, y) walks slots k = y, y+8, ...
//     of point x, so every load of y_xyz[c, k, n] / A[k, n] is a 128-byte
//     coalesced row segment, and N/32 blocks fill the 132 SMs;
//   * the per-point flow moments (x cross wy, wy - s x) are linear in the
//     slot sums, so each thread forms them from its own partial sums and no
//     per-point exchange is needed;
//   * the block reduces in a fixed order into per-block partials, and a
//     one-block second stage sums them in a fixed order: no float atomics,
//     reruns give identical bits;
//   * the pose and twist scalars arrive as a device pointer to the [32]
//     block built by pack_scalars, so no value crosses to the host.
//
// Compiled with -fmad=false (never --use_fast_math): each multiply and add
// rounds as the plain PyTorch version's separate ops do, so the kernel
// matrix A and its gates match the plain version slot for slot.

#include <cuda_runtime.h>
#include <math.h>

#include "reduce.cuh"

namespace {

// scalar block layout, as pack_scalars builds it (pallas_ell.py:69-84)
enum {
  S_RINV = 0, S_TINV = 9, S_SIGMA2 = 12, S_SP = 13, S_OM2 = 14, S_VV = 15,
  S_OMEGA = 16, S_V = 19, S_WV = 22, S_C2 = 25, S_VWV = 28, S_WV2 = 29,
  S_VC2 = 30, S_VOM = 31, S_LEN = 32
};
// per-point rows, as pack_x builds them
enum { X0 = 0, X1 = 1, X2 = 2, THRES = 3, NEGI2L2 = 4, COEF = 5 };

constexpr int TN = 32;             // source points per block
constexpr int TK = 8;              // slot groups per block
constexpr int THREADS = TN * TK;   // 256
constexpr int FINAL_THREADS = 256;
constexpr int FLOW_NV = 7;         // omega(3), v(3), a_sum
constexpr int STEP_NV = 4;         // B, C, D, E

__global__ void __launch_bounds__(THREADS)
flow_partial_kernel(const float* __restrict__ xp, const float* __restrict__ y,
                    const float* __restrict__ scal, float* __restrict__ A,
                    float* __restrict__ part, int* __restrict__ part_cnt,
                    int N, int K) {
  __shared__ float s[S_LEN];
  __shared__ float red[FLOW_NV * THREADS / 32];
  __shared__ int red_cnt[THREADS / 32];
  const int tid = threadIdx.y * TN + threadIdx.x;
  if (tid < S_LEN) s[tid] = scal[tid];
  __syncthreads();

  float acc[FLOW_NV] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int cnt[1] = {0};
  const int n = blockIdx.x * TN + threadIdx.x;
  if (n < N) {
    const float x0 = xp[X0 * N + n], x1 = xp[X1 * N + n], x2 = xp[X2 * N + n];
    const float thres = xp[THRES * N + n], negi = xp[NEGI2L2 * N + n];
    const size_t plane = (size_t)K * N;
    float sa = 0.f, w0 = 0.f, w1 = 0.f, w2 = 0.f;
    for (int k = threadIdx.y; k < K; k += TK) {
      const size_t o = (size_t)k * N + n;
      const float ya = y[o], yb = y[plane + o], yc = y[2 * plane + o];
      const float t0 = ya * s[S_RINV + 0] + yb * s[S_RINV + 1] + yc * s[S_RINV + 2] + s[S_TINV + 0];
      const float t1 = ya * s[S_RINV + 3] + yb * s[S_RINV + 4] + yc * s[S_RINV + 5] + s[S_TINV + 1];
      const float t2 = ya * s[S_RINV + 6] + yb * s[S_RINV + 7] + yc * s[S_RINV + 8] + s[S_TINV + 2];
      const float e0 = x0 - t0, e1 = x1 - t1, e2 = x2 - t2;
      const float d2 = e0 * e0 + e1 * e1 + e2 * e2;
      // dead slots carry DEAD_COORD coordinates: d2 is ~1e18, the gate is
      // false and expf underflows to 0
      const float kg = s[S_SIGMA2] * expf(d2 * negi);
      const float a = (d2 < thres && kg > s[S_SP]) ? kg : 0.f;
      A[o] = a;
      sa += a;
      w0 += a * t0;
      w1 += a * t1;
      w2 += a * t2;
      cnt[0] += a > 0.f;
    }
    acc[0] = x1 * w2 - x2 * w1;
    acc[1] = x2 * w0 - x0 * w2;
    acc[2] = x0 * w1 - x1 * w0;
    acc[3] = w0 - sa * x0;
    acc[4] = w1 - sa * x1;
    acc[5] = w2 - sa * x2;
    acc[6] = sa;
  }
  cvo::block_sum<float, FLOW_NV>(acc, red, tid, THREADS);
  cvo::block_sum<int, 1>(cnt, red_cnt, tid, THREADS);
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < FLOW_NV; ++i) part[blockIdx.x * FLOW_NV + i] = acc[i];
    part_cnt[blockIdx.x] = cnt[0];
  }
}

// out[0:6] unit twist, out[6] joint norm, out[7] a_sum; out_nz[0] nonzeros
__global__ void __launch_bounds__(FINAL_THREADS)
flow_final_kernel(const float* __restrict__ part, const int* __restrict__ part_cnt,
                  int nblocks, float c, float d, float* __restrict__ out,
                  int* __restrict__ out_nz) {
  __shared__ float red[FLOW_NV * FINAL_THREADS / 32];
  __shared__ int red_cnt[FINAL_THREADS / 32];
  const int tid = threadIdx.x;
  float acc[FLOW_NV] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int cnt[1] = {0};
  for (int b = tid; b < nblocks; b += FINAL_THREADS) {
#pragma unroll
    for (int i = 0; i < FLOW_NV; ++i) acc[i] += part[b * FLOW_NV + i];
    cnt[0] += part_cnt[b];
  }
  cvo::block_sum<float, FLOW_NV>(acc, red, tid, FINAL_THREADS);
  cvo::block_sum<int, 1>(cnt, red_cnt, tid, FINAL_THREADS);
  if (tid == 0) {
    float joint[6];
    for (int i = 0; i < 3; ++i) joint[i] = acc[i] / c;
    for (int i = 3; i < 6; ++i) joint[i] = acc[i] / d;
    float ss = 0.f;
    for (int i = 0; i < 6; ++i) ss += joint[i] * joint[i];
    const float jn = sqrtf(ss);
    const float den = jn < 1e-30f ? 1.f : jn;
    for (int i = 0; i < 6; ++i) out[i] = joint[i] / den;
    out[6] = jn;
    out[7] = acc[6];
    out_nz[0] = cnt[0];
  }
}

__global__ void __launch_bounds__(THREADS)
step_partial_kernel(const float* __restrict__ xp, const float* __restrict__ y,
                    const float* __restrict__ A, const float* __restrict__ scal,
                    float* __restrict__ part, int N, int K) {
  __shared__ float s[S_LEN];
  __shared__ float red[STEP_NV * THREADS / 32];
  const int tid = threadIdx.y * TN + threadIdx.x;
  if (tid < S_LEN) s[tid] = scal[tid];
  __syncthreads();

  float acc[STEP_NV] = {0.f, 0.f, 0.f, 0.f};
  const int n = blockIdx.x * TN + threadIdx.x;
  if (n < N) {
    const float x0 = xp[X0 * N + n], x1 = xp[X1 * N + n], x2 = xp[X2 * N + n];
    const float coef = xp[COEF * N + n];
    const float om0 = s[S_OMEGA], om1 = s[S_OMEGA + 1], om2v = s[S_OMEGA + 2];
    const float om2 = s[S_OM2];
    // per-point dots of x with the constant twist vectors
    const float xom = x0 * om0 + x1 * om1 + x2 * om2v;
    const float xv = x0 * s[S_V] + x1 * s[S_V + 1] + x2 * s[S_V + 2];
    const float xwv = x0 * s[S_WV] + x1 * s[S_WV + 1] + x2 * s[S_WV + 2];
    const float xc2 = x0 * s[S_C2] + x1 * s[S_C2 + 1] + x2 * s[S_C2 + 2];
    const size_t plane = (size_t)K * N;
    for (int k = threadIdx.y; k < K; k += TK) {
      const size_t o = (size_t)k * N + n;
      const float a = A[o];
      const float ya = y[o], yb = y[plane + o], yc = y[2 * plane + o];
      float t0 = ya * s[S_RINV + 0] + yb * s[S_RINV + 1] + yc * s[S_RINV + 2] + s[S_TINV + 0];
      float t1 = ya * s[S_RINV + 3] + yb * s[S_RINV + 4] + yc * s[S_RINV + 5] + s[S_TINV + 1];
      float t2 = ya * s[S_RINV + 6] + yb * s[S_RINV + 7] + yc * s[S_RINV + 8] + s[S_TINV + 2];
      // dead slots carry DEAD_COORD coordinates and beta^4 of a 1e9-scale
      // value is inf, so 0 * inf would be NaN: zero y_t where A == 0
      if (!(a > 0.f)) { t0 = 0.f; t1 = 0.f; t2 = 0.f; }
      // Rodrigues collapse (pallas_ell.py:269-320): for skew W,
      // W^3 = -|w|^2 W and W^4 = -|w|^2 W^2, so every xi{1..4}z dot reduces
      // to contractions of t = w.y, |y|^2, y's dots with v, Wv, W^2 v and
      // one cross product u = W y
      const float tw = t0 * om0 + t1 * om1 + t2 * om2v;
      const float yy = t0 * t0 + t1 * t1 + t2 * t2;
      const float uu = om2 * yy - tw * tw;
      const float yv = t0 * s[S_V] + t1 * s[S_V + 1] + t2 * s[S_V + 2];
      const float ywv = t0 * s[S_WV] + t1 * s[S_WV + 1] + t2 * s[S_WV + 2];
      const float yc2 = t0 * s[S_C2] + t1 * s[S_C2 + 1] + t2 * s[S_C2 + 2];
      const float u0 = t2 * om1 - t1 * om2v;
      const float u1 = t0 * om2v - t2 * om0;
      const float u2 = t1 * om0 - t0 * om1;
      const float xu = x0 * u0 + x1 * u1 + x2 * u2;
      const float xy = x0 * t0 + x1 * t1 + x2 * t2;
      const float d1 = xu + (xv - yv);
      const float dw = xom * tw - om2 * xy + uu;
      const float d2 = dw + (xwv - ywv);
      const float d3 = -om2 * xu + (xc2 - yc2);
      const float d4 = -om2 * d2;
      const float normxiz2 = uu - 2.f * ywv + s[S_VV];
      const float vw = s[S_VOM] * tw - om2 * yv;
      const float xdx2 = yc2 - vw - s[S_VWV];
      const float epsc = -om2 * uu + 2.f * om2 * ywv + s[S_WV2] + 2.f * s[S_VC2];
      const float beta = -2.f * coef * d1;
      const float gamma = -coef * (normxiz2 + 2.f * d2);
      const float delta = 2.f * coef * (xdx2 - d3);
      const float epsil = -coef * (epsc + 2.f * d4);
      const float b2 = beta * beta;
      acc[0] += a * beta;
      acc[1] += a * (gamma + 0.5f * b2);
      acc[2] += a * (delta + beta * gamma + b2 * beta / 6.f);
      acc[3] += a * (epsil + beta * delta + 0.5f * b2 * gamma
                     + 0.5f * gamma * gamma + b2 * b2 / 24.f);
    }
  }
  cvo::block_sum<float, STEP_NV>(acc, red, tid, THREADS);
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < STEP_NV; ++i) part[blockIdx.x * STEP_NV + i] = acc[i];
  }
}

__global__ void __launch_bounds__(FINAL_THREADS)
step_final_kernel(const float* __restrict__ part, int nblocks,
                  float* __restrict__ out) {
  __shared__ float red[STEP_NV * FINAL_THREADS / 32];
  const int tid = threadIdx.x;
  float acc[STEP_NV] = {0.f, 0.f, 0.f, 0.f};
  for (int b = tid; b < nblocks; b += FINAL_THREADS) {
#pragma unroll
    for (int i = 0; i < STEP_NV; ++i) acc[i] += part[b * STEP_NV + i];
  }
  cvo::block_sum<float, STEP_NV>(acc, red, tid, FINAL_THREADS);
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < STEP_NV; ++i) out[i] = acc[i];
  }
}

}  // namespace

extern "C" {

int cvo_ell_blocks(int N) { return (N + TN - 1) / TN; }

// xp [6, N], y [3, K, N], scal [32] -> A [K, N]; part [nblocks, 7] and
// part_cnt [nblocks] are scratch; out [8] = (unit twist, joint norm, a_sum),
// out_nz [1] = nonzeros.
int cvo_flow_reduce(const float* xp, const float* y, const float* scal,
                    float* A, float* part, int* part_cnt, float* out,
                    int* out_nz, int N, int K, float c, float d,
                    cudaStream_t stream) {
  const int nblocks = cvo_ell_blocks(N);
  flow_partial_kernel<<<nblocks, dim3(TN, TK), 0, stream>>>(
      xp, y, scal, A, part, part_cnt, N, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flow_final_kernel<<<1, FINAL_THREADS, 0, stream>>>(part, part_cnt, nblocks,
                                                     c, d, out, out_nz);
  return (int)cudaGetLastError();
}

// xp [6, N], y [3, K, N], A [K, N], scal [32] -> out [4] = (B, C, D, E);
// part [nblocks, 4] is scratch.
int cvo_step_cached(const float* xp, const float* y, const float* A,
                    const float* scal, float* part, float* out, int N, int K,
                    cudaStream_t stream) {
  const int nblocks = cvo_ell_blocks(N);
  step_partial_kernel<<<nblocks, dim3(TN, TK), 0, stream>>>(
      xp, y, A, scal, part, N, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  step_final_kernel<<<1, FINAL_THREADS, 0, stream>>>(part, nblocks, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
