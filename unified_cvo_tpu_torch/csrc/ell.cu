// ELL consume kernels of the align hot loop, written for Hopper (sm_90a).
//
// Replaces four TPU kernels of the JAX package (unified_cvo_tpu/ops/
// pallas_ell.py):
//   * flow_reduce   <- _flow_reduce_kernel (with _transform_and_a), reached
//                      through flow_twist_ell_fused(emit_a=True)
//   * step_cached   <- _step_kernel_cached with _step_tail, reached through
//                      step_coeffs_ell_fused_cached
//   * flow_rows     <- _flow_kernel, reached through flow_stats_ell_fused
//   * step_uncached <- _step_kernel (reduced) with _step_tail, reached
//                      through step_coeffs_ell_fused
//
// The passes that evaluate the kernel matrix A do so in one of the three
// variants of _transform_and_a, each a template instantiation (no runtime
// branch in the slot loop): geometry only, geometry times the build-time
// channel factor chan [K, N], and chan alone (a list ranked by the channel
// kernel, built without geometry). slot_a below is the one front half all
// of them share; step_tail is the one back half of both step passes, so
// the cached and uncached steps cannot drift apart.
//
// What bounds them on this card: bytes. Each slot costs a few dozen flops
// and one expf against 16-20 bytes of slot data (raw xyz in, plus chan in
// and A out for flow; raw xyz and A or chan in for step); at N = 16384,
// K = 32 a pass moves about 9-11 MB, a few microseconds of HBM time, while
// the arithmetic is far below the f32 peak. The design therefore reads
// every slot array exactly once, coalesced, and keeps all intermediates in
// registers:
//   * a block is 32 source points (threadIdx.x, adjacent in memory) times
//     8 slot groups (threadIdx.y); thread (x, y) walks slots k = y, y+8, ...
//     of point x, so every load of y_xyz[c, k, n] / chan[k, n] / A[k, n] is
//     a 128-byte coalesced row segment, and N/32 blocks fill the 132 SMs;
//   * the per-point flow moments (x cross wy, wy - s x) are linear in the
//     slot sums, so each thread forms them from its own partial sums and no
//     per-point exchange is needed; the row-flow pass, which must write
//     whole per-point rows, combines the 8 slot groups through shared
//     memory in a fixed order instead;
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

// variant codes of the C interface (ops/ell.py VARIANTS)
enum { V_GEO = 0, V_GEO_CHAN = 1, V_CHAN = 2 };

// Raw slot coordinates moved by (R_inv, T_inv).
__device__ __forceinline__ void move_slot(const float* s, float ya, float yb,
                                          float yc, float& t0, float& t1,
                                          float& t2) {
  t0 = ya * s[S_RINV + 0] + yb * s[S_RINV + 1] + yc * s[S_RINV + 2] + s[S_TINV + 0];
  t1 = ya * s[S_RINV + 3] + yb * s[S_RINV + 4] + yc * s[S_RINV + 5] + s[S_TINV + 1];
  t2 = ya * s[S_RINV + 6] + yb * s[S_RINV + 7] + yc * s[S_RINV + 8] + s[S_TINV + 2];
}

// Gated kernel value of one slot (_transform_and_a): ok = chan > 0 and
// a = chan; under geometry a = a * kgeo and ok &= d2 < thres; then a where
// ok and a > sp, else 0. Dead slots carry DEAD_COORD coordinates: d2 is
// ~1e18, the distance gate is false and expf underflows to 0; without
// geometry chan (built with validity folded in) is 0 there.
template <bool GEO, bool CHAN>
__device__ __forceinline__ float slot_a(const float* s, float x0, float x1,
                                        float x2, float thres, float negi,
                                        float t0, float t1, float t2,
                                        float chan) {
  bool ok = true;
  float a = 0.f;
  if (CHAN) {
    ok = chan > 0.f;
    a = chan;
  }
  if (GEO) {
    const float e0 = x0 - t0, e1 = x1 - t1, e2 = x2 - t2;
    const float d2 = e0 * e0 + e1 * e1 + e2 * e2;
    const float kg = s[S_SIGMA2] * expf(d2 * negi);
    ok = CHAN ? (ok && d2 < thres) : (d2 < thres);
    a = CHAN ? a * kg : kg;
  }
  return (ok && a > s[S_SP]) ? a : 0.f;
}

// Flow pass with reduced moments and A written out; one launch of the
// <GEO, CHAN> variant per call.
template <bool GEO, bool CHAN>
__global__ void __launch_bounds__(THREADS)
flow_partial_kernel(const float* __restrict__ xp, const float* __restrict__ y,
                    const float* __restrict__ chan,
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
      float t0, t1, t2;
      move_slot(s, y[o], y[plane + o], y[2 * plane + o], t0, t1, t2);
      const float a = slot_a<GEO, CHAN>(s, x0, x1, x2, thres, negi, t0, t1, t2,
                                        CHAN ? chan[o] : 0.f);
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

// Row-flow pass (_flow_kernel): per-point rows s [N], wy [3, N] and
// cnt [N]. The 8 slot groups of a point meet in shared memory and row 0 of
// the block adds them in group order; warp 0 (that same row) then reduces
// the block's s and cnt into per-block partials of a_sum and nonzeros.
template <bool GEO, bool CHAN>
__global__ void __launch_bounds__(THREADS)
flow_rows_kernel(const float* __restrict__ xp, const float* __restrict__ y,
                 const float* __restrict__ chan, const float* __restrict__ scal,
                 float* __restrict__ s_out, float* __restrict__ wy_out,
                 int* __restrict__ cnt_out, float* __restrict__ part,
                 int* __restrict__ part_cnt, int N, int K) {
  __shared__ float s[S_LEN];
  __shared__ float grp[4][TK][TN];   // s, wy0, wy1, wy2 per slot group
  __shared__ int grp_cnt[TK][TN];
  const int tid = threadIdx.y * TN + threadIdx.x;
  if (tid < S_LEN) s[tid] = scal[tid];
  __syncthreads();

  const int n = blockIdx.x * TN + threadIdx.x;
  float sa = 0.f, w0 = 0.f, w1 = 0.f, w2 = 0.f;
  int c = 0;
  if (n < N) {
    const float x0 = xp[X0 * N + n], x1 = xp[X1 * N + n], x2 = xp[X2 * N + n];
    const float thres = xp[THRES * N + n], negi = xp[NEGI2L2 * N + n];
    const size_t plane = (size_t)K * N;
    for (int k = threadIdx.y; k < K; k += TK) {
      const size_t o = (size_t)k * N + n;
      float t0, t1, t2;
      move_slot(s, y[o], y[plane + o], y[2 * plane + o], t0, t1, t2);
      const float a = slot_a<GEO, CHAN>(s, x0, x1, x2, thres, negi, t0, t1, t2,
                                        CHAN ? chan[o] : 0.f);
      sa += a;
      w0 += a * t0;
      w1 += a * t1;
      w2 += a * t2;
      c += a > 0.f;
    }
  }
  grp[0][threadIdx.y][threadIdx.x] = sa;
  grp[1][threadIdx.y][threadIdx.x] = w0;
  grp[2][threadIdx.y][threadIdx.x] = w1;
  grp[3][threadIdx.y][threadIdx.x] = w2;
  grp_cnt[threadIdx.y][threadIdx.x] = c;
  __syncthreads();
  if (threadIdx.y == 0) {
    float row[4];
    int rc = 0;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float v = grp[r][0][threadIdx.x];
#pragma unroll
      for (int g = 1; g < TK; ++g) v += grp[r][g][threadIdx.x];
      row[r] = v;
    }
#pragma unroll
    for (int g = 0; g < TK; ++g) rc += grp_cnt[g][threadIdx.x];
    if (n < N) {
      s_out[n] = row[0];
      wy_out[n] = row[1];
      wy_out[N + n] = row[2];
      wy_out[2 * N + n] = row[3];
      cnt_out[n] = rc;
    }
    float bs[1] = {row[0]};   // 0 for points past N
    int bc[1] = {rc};
    cvo::warp_sum<float, 1>(bs);
    cvo::warp_sum<int, 1>(bc);
    if (threadIdx.x == 0) {
      part[blockIdx.x] = bs[0];
      part_cnt[blockIdx.x] = bc[0];
    }
  }
}

// a_sum and nonzeros from the row-flow pass's per-block partials.
__global__ void __launch_bounds__(FINAL_THREADS)
rows_final_kernel(const float* __restrict__ part, const int* __restrict__ part_cnt,
                  int nblocks, float* __restrict__ out_asum,
                  int* __restrict__ out_nz) {
  __shared__ float red[FINAL_THREADS / 32];
  __shared__ int red_cnt[FINAL_THREADS / 32];
  const int tid = threadIdx.x;
  float acc[1] = {0.f};
  int cnt[1] = {0};
  for (int b = tid; b < nblocks; b += FINAL_THREADS) {
    acc[0] += part[b];
    cnt[0] += part_cnt[b];
  }
  cvo::block_sum<float, 1>(acc, red, tid, FINAL_THREADS);
  cvo::block_sum<int, 1>(cnt, red_cnt, tid, FINAL_THREADS);
  if (tid == 0) {
    out_asum[0] = acc[0];
    out_nz[0] = cnt[0];
  }
}

// Step tail of one slot (_step_tail): adds a * (the quartic Taylor terms)
// to acc[0..3] = B, C, D, E. xom, xv, xwv and xc2 are the point's dots with
// the constant twist vectors.
__device__ __forceinline__ void step_tail(const float* s, float a, float t0,
                                          float t1, float t2, float x0,
                                          float x1, float x2, float coef,
                                          float xom, float xv, float xwv,
                                          float xc2, float (&acc)[STEP_NV]) {
  const float om0 = s[S_OMEGA], om1 = s[S_OMEGA + 1], om2v = s[S_OMEGA + 2];
  const float om2 = s[S_OM2];
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

// Step pass. CACHED reads A (from the flow pass) from `aux`; otherwise A is
// recomputed by the <GEO, CHAN> front half, with `aux` the channel factor
// (read only when CHAN).
template <bool CACHED, bool GEO, bool CHAN>
__global__ void __launch_bounds__(THREADS)
step_partial_kernel(const float* __restrict__ xp, const float* __restrict__ y,
                    const float* __restrict__ aux, const float* __restrict__ scal,
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
    const float thres = CACHED ? 0.f : xp[THRES * N + n];
    const float negi = CACHED ? 0.f : xp[NEGI2L2 * N + n];
    // per-point dots of x with the constant twist vectors
    const float xom = x0 * s[S_OMEGA] + x1 * s[S_OMEGA + 1] + x2 * s[S_OMEGA + 2];
    const float xv = x0 * s[S_V] + x1 * s[S_V + 1] + x2 * s[S_V + 2];
    const float xwv = x0 * s[S_WV] + x1 * s[S_WV + 1] + x2 * s[S_WV + 2];
    const float xc2 = x0 * s[S_C2] + x1 * s[S_C2 + 1] + x2 * s[S_C2 + 2];
    const size_t plane = (size_t)K * N;
    for (int k = threadIdx.y; k < K; k += TK) {
      const size_t o = (size_t)k * N + n;
      float t0, t1, t2;
      move_slot(s, y[o], y[plane + o], y[2 * plane + o], t0, t1, t2);
      const float a = CACHED ? aux[o]
                             : slot_a<GEO, CHAN>(s, x0, x1, x2, thres, negi, t0,
                                                 t1, t2, CHAN ? aux[o] : 0.f);
      step_tail(s, a, t0, t1, t2, x0, x1, x2, coef, xom, xv, xwv, xc2, acc);
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

// xp [6, N], y [3, K, N], chan [K, N] (variant V_GEO_CHAN or V_CHAN, else
// unused), scal [32] -> A [K, N]; part [nblocks, 7] and part_cnt [nblocks]
// are scratch; out [8] = (unit twist, joint norm, a_sum), out_nz [1] =
// nonzeros.
int cvo_flow_reduce(const float* xp, const float* y, const float* chan,
                    const float* scal, float* A, float* part, int* part_cnt,
                    float* out, int* out_nz, int N, int K, float c, float d,
                    int variant, cudaStream_t stream) {
  const int nblocks = cvo_ell_blocks(N);
  const dim3 block(TN, TK);
  switch (variant) {
    case V_GEO:
      flow_partial_kernel<true, false><<<nblocks, block, 0, stream>>>(
          xp, y, chan, scal, A, part, part_cnt, N, K);
      break;
    case V_GEO_CHAN:
      flow_partial_kernel<true, true><<<nblocks, block, 0, stream>>>(
          xp, y, chan, scal, A, part, part_cnt, N, K);
      break;
    case V_CHAN:
      flow_partial_kernel<false, true><<<nblocks, block, 0, stream>>>(
          xp, y, chan, scal, A, part, part_cnt, N, K);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
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
  step_partial_kernel<true, false, false><<<nblocks, dim3(TN, TK), 0, stream>>>(
      xp, y, A, scal, part, N, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  step_final_kernel<<<1, FINAL_THREADS, 0, stream>>>(part, nblocks, out);
  return (int)cudaGetLastError();
}

// xp [6, N], y [3, K, N], chan [K, N] (as cvo_flow_reduce), scal [32] ->
// s_out [N], wy_out [3, N], cnt_out [N], out_asum [1], out_nz [1];
// part [nblocks] and part_cnt [nblocks] are scratch.
int cvo_flow_rows(const float* xp, const float* y, const float* chan,
                  const float* scal, float* s_out, float* wy_out, int* cnt_out,
                  float* part, int* part_cnt, float* out_asum, int* out_nz,
                  int N, int K, int variant, cudaStream_t stream) {
  const int nblocks = cvo_ell_blocks(N);
  const dim3 block(TN, TK);
  switch (variant) {
    case V_GEO:
      flow_rows_kernel<true, false><<<nblocks, block, 0, stream>>>(
          xp, y, chan, scal, s_out, wy_out, cnt_out, part, part_cnt, N, K);
      break;
    case V_GEO_CHAN:
      flow_rows_kernel<true, true><<<nblocks, block, 0, stream>>>(
          xp, y, chan, scal, s_out, wy_out, cnt_out, part, part_cnt, N, K);
      break;
    case V_CHAN:
      flow_rows_kernel<false, true><<<nblocks, block, 0, stream>>>(
          xp, y, chan, scal, s_out, wy_out, cnt_out, part, part_cnt, N, K);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rows_final_kernel<<<1, FINAL_THREADS, 0, stream>>>(part, part_cnt, nblocks,
                                                     out_asum, out_nz);
  return (int)cudaGetLastError();
}

// xp [6, N], y [3, K, N], chan [K, N] (as cvo_flow_reduce), scal [32] ->
// out [4] = (B, C, D, E) with A recomputed; part [nblocks, 4] is scratch.
int cvo_step_uncached(const float* xp, const float* y, const float* chan,
                      const float* scal, float* part, float* out, int N, int K,
                      int variant, cudaStream_t stream) {
  const int nblocks = cvo_ell_blocks(N);
  const dim3 block(TN, TK);
  switch (variant) {
    case V_GEO:
      step_partial_kernel<false, true, false><<<nblocks, block, 0, stream>>>(
          xp, y, chan, scal, part, N, K);
      break;
    case V_GEO_CHAN:
      step_partial_kernel<false, true, true><<<nblocks, block, 0, stream>>>(
          xp, y, chan, scal, part, N, K);
      break;
    case V_CHAN:
      step_partial_kernel<false, false, true><<<nblocks, block, 0, stream>>>(
          xp, y, chan, scal, part, N, K);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  step_final_kernel<<<1, FINAL_THREADS, 0, stream>>>(part, nblocks, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
