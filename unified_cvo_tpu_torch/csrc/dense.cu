// Dense tiled passes of the align loop, written for Hopper (sm_90a).
//
// Replaces two TPU kernels of the JAX package:
//   * dense_flow <- unified_cvo_tpu/ops/pallas_kernels.py::_flow_kernel
//                   (with _a_block and _compacted_call), reached through
//                   flow_stats_pallas
//   * dense_step <- unified_cvo_tpu/ops/pallas_kernels.py::_step_kernel /
//                   _step_tile (with _a_block), reached through
//                   step_coeffs_pallas
//
// Both evaluate the kernel matrix A over every (source row, target column)
// of the active (source tile x target tile) pairs left by spatial culling:
// geometry, intensity, semantics and geometric-type gates, from the packed
// source rows x [N, Dx] and transposed target rows yT [Dy, M] that
// ops/dense.py builds. The flow pass reduces per source row s = sum_j A,
// wy = sum_j A (y_j - c) and the nonzero count; the step pass reduces the
// quartic step coefficients B..E.
//
// What bounds them on this card: operations. At the bench shapes (N = M =
// 16384, tiles 128 x 512, ~1100-1700 active pairs) a pass evaluates
// 75-114 M pairs at ~40-110 f32 operations and one or two expf each, from
// under 3 MB of packed inputs; the design therefore keeps every pair in
// registers and never writes A:
//   * the TPU walks a dynamic 1-D grid of exactly n active pairs and keeps
//     each source tile's output block resident across its pairs. Here a
//     fixed grid covers the source rows instead: a block is 32 source rows
//     (threadIdx.x) x 8 column groups (threadIdx.y), so N/32 = 512 blocks
//     fill the 132 SMs although there are only 128 source tiles;
//   * a block finds its source tile's range of the i-major active list by
//     binary search on pair_i over the first n entries, reading n from
//     device memory: n never goes to the host and no extra pass builds
//     offsets. A tile with no active pair gets an empty range and writes
//     zero rows (row_has in the JAX package);
//   * each active target tile is staged through shared memory 128 columns
//     at a time; thread (x, y) evaluates row x against columns y, y+8, ...,
//     so a warp reads one column value at a time (a broadcast) and keeps
//     its own row in registers (channel vectors in shared memory);
//   * the 8 column-group partials of a row are combined in shared memory in
//     a fixed order, and a one-block final stage sums rows (flow) or block
//     partials (step) in a fixed order: no float atomics, reruns give
//     identical bits; the nonzero count stays an exact integer.
//
// Compiled with -fmad=false (never --use_fast_math): each multiply and add
// rounds as the plain PyTorch version's separate ops do, and the channel
// dots are explicit sums in the same order, so every gate decides as in
// the plain version and nonzeros compare exactly.

#include <cuda_runtime.h>
#include <math.h>

#include "reduce.cuh"

namespace {

constexpr int ROWS = 32;                 // source rows per block
constexpr int GROUPS = 8;                // column groups per block
constexpr int THREADS = ROWS * GROUPS;   // 256
constexpr int CH = 128;                  // target columns staged at a time
constexpr int FINAL_THREADS = 1024;
constexpr int STEP_NV = 4;               // B, C, D, E

// Offsets of the packed layout (ops/dense.py::PackLayout).
struct Layout {
  int Dx, Dy, F, C;
  int geometry, intensity, semantics, geo_type;
  int x_featsq, x_label, x_labelsq, x_geo, x_geon2;
  int y_featsq, y_label, y_labelsq, y_geo, y_geon2, y_xiz, y_scal;
};
enum { X_MASK = 3, X_TWOL2 = 4, X_D2THRES = 5, X_COEF = 6, X_FEAT = 7,
       Y_PAD = 3, Y_FEAT = 4 };

// Kernel constants, exact f32 values from ops/dense.py::_consts.
struct Consts {
  float sigma2, sp, c_sigma2, c_thres, c_neg_inv_two_ell2, s_sigma2, s_thres,
      s_neg_inv_two_ell2;
};

// A source row's scalars, in registers.
struct XRow {
  float x0, x1, x2, mask, twol2, d2thres, coef, featsq, labelsq, g0, g1, gn2;
};

__device__ __forceinline__ XRow load_row(const Layout& L, const float* xs, int tx) {
  XRow r;
  r.x0 = xs[0 * ROWS + tx];
  r.x1 = xs[1 * ROWS + tx];
  r.x2 = xs[2 * ROWS + tx];
  r.mask = xs[X_MASK * ROWS + tx];
  r.twol2 = xs[X_TWOL2 * ROWS + tx];
  r.d2thres = xs[X_D2THRES * ROWS + tx];
  r.coef = xs[X_COEF * ROWS + tx];
  r.featsq = xs[L.x_featsq * ROWS + tx];
  r.labelsq = xs[L.x_labelsq * ROWS + tx];
  r.g0 = xs[L.x_geo * ROWS + tx];
  r.g1 = xs[(L.x_geo + 1) * ROWS + tx];
  r.gn2 = xs[L.x_geon2 * ROWS + tx];
  return r;
}

// One kernel-matrix entry (_a_block semantics, pallas_kernels.py:265-342):
// source row r (channel vectors at xs[col * ROWS + tx]) against staged
// target column c (row k at ys[k * CH + c]).
__device__ __forceinline__ float a_value(const Layout& L, const Consts& K,
                                         const XRow& r, const float* xs, int tx,
                                         const float* ys, int c) {
  bool ok = true, have = false;
  float a = 0.f;
  if (L.geo_type) {
    const float dot = r.g0 * ys[L.y_geo * CH + c] + r.g1 * ys[(L.y_geo + 1) * CH + c];
    const float n2 = r.gn2 * ys[L.y_geon2 * CH + c];
    a = dot * dot * (1.f / fmaxf(n2, 1e-12f));
    ok = a >= 0.01f;
    have = true;
  }
  if (L.geometry) {
    float d2 = ys[Y_PAD * CH + c];
    const float e0 = r.x0 - ys[0 * CH + c];
    d2 = d2 + e0 * e0;
    const float e1 = r.x1 - ys[1 * CH + c];
    d2 = d2 + e1 * e1;
    const float e2 = r.x2 - ys[2 * CH + c];
    d2 = d2 + e2 * e2;
    ok = ok && (d2 < r.d2thres);
    const float kg = K.sigma2 * expf(d2 * r.twol2);
    a = have ? a * kg : kg;
    have = true;
  }
  if (L.intensity) {
    float cross = 0.f;
    for (int f = 0; f < L.F; ++f)
      cross = cross + xs[(X_FEAT + f) * ROWS + tx] * ys[(Y_FEAT + f) * CH + c];
    const float d2c = fmaxf(r.featsq + ys[L.y_featsq * CH + c] - 2.f * cross, 0.f);
    ok = ok && (d2c < K.c_thres);
    const float ck = K.c_sigma2 * expf(d2c * K.c_neg_inv_two_ell2);
    a = have ? a * ck : ck;
    have = true;
  }
  if (L.semantics) {
    float cross = 0.f;
    for (int q = 0; q < L.C; ++q)
      cross = cross + xs[(L.x_label + q) * ROWS + tx] * ys[(L.y_label + q) * CH + c];
    const float d2s = fmaxf(r.labelsq + ys[L.y_labelsq * CH + c] - 2.f * cross, 0.f);
    ok = ok && (d2s < K.s_thres);
    const float sk = K.s_sigma2 * expf(d2s * K.s_neg_inv_two_ell2);
    a = have ? a * sk : sk;
    have = true;
  }
  if (!have)  // no active channel: only validity gates (a == 1)
    return (r.mask > 0.f && ys[Y_PAD * CH + c] == 0.f) ? 1.f : 0.f;
  return (ok && a > K.sp) ? a : 0.f;
}

// First index in a[0, n) (sorted ascending) whose value is >= v.
__device__ int lower_bound(const int* __restrict__ a, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Shared set-up of both passes: stage the block's 32 source rows
// (transposed, xs[col * ROWS + row]) and find the source tile's range of
// active pairs, [range[0], range[1]).
__device__ __forceinline__ void block_setup(
    const Layout& L, const float* __restrict__ xp, const int* __restrict__ pair_i,
    const unsigned char* __restrict__ row_has, const int* __restrict__ n_active,
    int tile_i, float* xs, int* range, int tid) {
  const int r0 = blockIdx.x * ROWS;
  const int tile = r0 / tile_i;
  for (int t = tid; t < ROWS * L.Dx; t += THREADS) {
    const int r = t / L.Dx, d = t - r * L.Dx;
    xs[d * ROWS + r] = xp[(size_t)r0 * L.Dx + t];
  }
  if (tid == 0) {
    int lo = 0, hi = 0;
    if (row_has[tile]) {
      const int n = *n_active;
      lo = lower_bound(pair_i, n, tile);
      hi = lower_bound(pair_i, n, tile + 1);
    }
    range[0] = lo;
    range[1] = hi;
  }
  __syncthreads();
}

// Stage columns [col0, col0 + cols) of yT into ys[k * CH + c].
__device__ __forceinline__ void stage_columns(const Layout& L, const float* __restrict__ yp,
                                              int M, int col0, int cols, float* ys, int tid) {
  __syncthreads();  // every thread is done with the previous chunk
  for (int t = tid; t < L.Dy * cols; t += THREADS) {
    const int k = t / cols, c = t - k * cols;
    ys[k * CH + c] = yp[(size_t)k * M + col0 + c];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
dense_flow_kernel(Layout L, Consts K, const float* __restrict__ xp,
                  const float* __restrict__ yp, const int* __restrict__ pair_i,
                  const int* __restrict__ pair_j, const unsigned char* __restrict__ row_has,
                  const int* __restrict__ n_active, float* __restrict__ s_out,
                  float* __restrict__ wy_out, int* __restrict__ cnt_out,
                  int M, int tile_i, int tile_j) {
  extern __shared__ float smem[];
  float* xs = smem;                   // [Dx][ROWS]
  float* ys = smem + L.Dx * ROWS;     // [Dy][CH]
  __shared__ float red[4][GROUPS][ROWS];
  __shared__ int red_cnt[GROUPS][ROWS];
  __shared__ int range[2];
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * ROWS + tx;
  block_setup(L, xp, pair_i, row_has, n_active, tile_i, xs, range, tid);
  const XRow r = load_row(L, xs, tx);

  float sa = 0.f, w0 = 0.f, w1 = 0.f, w2 = 0.f;
  int cnt = 0;
  for (int p = range[0]; p < range[1]; ++p) {
    const int base = pair_j[p] * tile_j;
    for (int c0 = 0; c0 < tile_j; c0 += CH) {
      const int cols = min(CH, tile_j - c0);
      stage_columns(L, yp, M, base + c0, cols, ys, tid);
      for (int c = ty; c < cols; c += GROUPS) {
        const float a = a_value(L, K, r, xs, tx, ys, c);
        sa += a;
        w0 += a * ys[0 * CH + c];
        w1 += a * ys[1 * CH + c];
        w2 += a * ys[2 * CH + c];
        cnt += a > 0.f;
      }
    }
  }
  red[0][ty][tx] = sa;
  red[1][ty][tx] = w0;
  red[2][ty][tx] = w1;
  red[3][ty][tx] = w2;
  red_cnt[ty][tx] = cnt;
  __syncthreads();
  if (ty == 0) {
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    int n = 0;
    for (int g = 0; g < GROUPS; ++g) {
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] += red[i][g][tx];
      n += red_cnt[g][tx];
    }
    const int row = blockIdx.x * ROWS + tx;
    s_out[row] = v[0];
    wy_out[row * 3 + 0] = v[1];
    wy_out[row * 3 + 1] = v[2];
    wy_out[row * 3 + 2] = v[3];
    cnt_out[row] = n;
  }
}

// a_sum = sum of the row sums, nonzeros = sum of the row counts.
__global__ void __launch_bounds__(FINAL_THREADS)
row_sum_kernel(const float* __restrict__ s, const int* __restrict__ cnt, int N,
               float* __restrict__ out_sum, int* __restrict__ out_nz) {
  __shared__ float red[FINAL_THREADS / 32];
  __shared__ int red_cnt[FINAL_THREADS / 32];
  const int tid = threadIdx.x;
  float acc[1] = {0.f};
  int n[1] = {0};
  for (int i = tid; i < N; i += FINAL_THREADS) {
    acc[0] += s[i];
    n[0] += cnt[i];
  }
  cvo::block_sum<float, 1>(acc, red, tid, FINAL_THREADS);
  cvo::block_sum<int, 1>(n, red_cnt, tid, FINAL_THREADS);
  if (tid == 0) {
    out_sum[0] = acc[0];
    out_nz[0] = n[0];
  }
}

__global__ void __launch_bounds__(THREADS)
dense_step_kernel(Layout L, Consts K, const float* __restrict__ xp,
                  const float* __restrict__ yp, const int* __restrict__ pair_i,
                  const int* __restrict__ pair_j, const unsigned char* __restrict__ row_has,
                  const int* __restrict__ n_active, float* __restrict__ part,
                  int M, int tile_i, int tile_j) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* ys = smem + L.Dx * ROWS;
  __shared__ float red[STEP_NV * THREADS / 32];
  __shared__ int range[2];
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * ROWS + tx;
  block_setup(L, xp, pair_i, row_has, n_active, tile_i, xs, range, tid);
  const XRow r = load_row(L, xs, tx);
  const float coef = r.coef;

  float acc[STEP_NV] = {0.f, 0.f, 0.f, 0.f};
  for (int p = range[0]; p < range[1]; ++p) {
    const int base = pair_j[p] * tile_j;
    for (int c0 = 0; c0 < tile_j; c0 += CH) {
      const int cols = min(CH, tile_j - c0);
      stage_columns(L, yp, M, base + c0, cols, ys, tid);
      for (int c = ty; c < cols; c += GROUPS) {
        const float a = a_value(L, K, r, xs, tx, ys, c);
        const float e0 = r.x0 - ys[0 * CH + c];
        const float e1 = r.x1 - ys[1 * CH + c];
        const float e2 = r.x2 - ys[2 * CH + c];
        // (x_i - y_j) . xi{q+1}z_j from the packed twist rows
        float d[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int b = L.y_xiz + 3 * q;
          float t = e0 * ys[b * CH + c];
          t = t + e1 * ys[(b + 1) * CH + c];
          d[q] = t + e2 * ys[(b + 2) * CH + c];
        }
        const float normxiz2 = ys[L.y_scal * CH + c];
        const float xdx2 = ys[(L.y_scal + 1) * CH + c];
        const float epsc = ys[(L.y_scal + 2) * CH + c];
        // _step_tile (pallas_kernels.py:468-487), term by term
        const float beta = -2.f * coef * d[0];
        const float gamma = -coef * (normxiz2 + 2.f * d[1]);
        const float delta = 2.f * coef * (xdx2 - d[2]);
        const float epsil = -coef * (epsc + 2.f * d[3]);
        const float b2 = beta * beta;
        acc[0] += a * beta;
        acc[1] += a * (gamma + 0.5f * b2);
        acc[2] += a * (delta + beta * gamma + b2 * beta / 6.f);
        acc[3] += a * (epsil + beta * delta + 0.5f * b2 * gamma
                       + 0.5f * gamma * gamma + b2 * b2 / 24.f);
      }
    }
  }
  cvo::block_sum<float, STEP_NV>(acc, red, tid, THREADS);
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < STEP_NV; ++i) part[blockIdx.x * STEP_NV + i] = acc[i];
  }
}

__global__ void __launch_bounds__(FINAL_THREADS)
step_sum_kernel(const float* __restrict__ part, int nblocks, float* __restrict__ out) {
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

// flags = (F, C, geometry, intensity, semantics, geo_type); Dy is the
// packed target height of the pass (flow 9 + F + C, step 24 + F + C).
Layout make_layout(const int* flags, int Dy) {
  Layout L;
  L.F = flags[0];
  L.C = flags[1];
  L.geometry = flags[2];
  L.intensity = flags[3];
  L.semantics = flags[4];
  L.geo_type = flags[5];
  const int F = L.F, C = L.C;
  L.Dx = 12 + F + C;
  L.Dy = Dy;
  L.x_featsq = 7 + F;
  L.x_label = 8 + F;
  L.x_labelsq = 8 + F + C;
  L.x_geo = 9 + F + C;
  L.x_geon2 = 11 + F + C;
  L.y_featsq = 4 + F;
  L.y_label = 5 + F;
  L.y_labelsq = 5 + F + C;
  L.y_geo = 6 + F + C;
  L.y_geon2 = 8 + F + C;
  L.y_xiz = 9 + F + C;
  L.y_scal = 21 + F + C;
  return L;
}

Consts make_consts(const float* k) {
  return Consts{k[0], k[1], k[2], k[3], k[4], k[5], k[6], k[7]};
}

// Dynamic shared memory of a pass; opts in above the default 48 KB.
template <typename Kernel>
cudaError_t shared_bytes(Kernel kernel, const Layout& L, size_t* bytes) {
  *bytes = (size_t)(L.Dx * ROWS + L.Dy * CH) * sizeof(float);
  if (*bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*bytes);
}

bool bad_shapes(int N, int M, int tile_i, int tile_j) {
  return N <= 0 || tile_i <= 0 || tile_j <= 0 || N % tile_i || M % tile_j ||
         tile_i % ROWS;
}

}  // namespace

extern "C" {

int cvo_dense_blocks(int N) { return N / ROWS; }

// xp [N, Dx], yp [9 + F + C, M], pair_i / pair_j [nI * nJ] int32, row_has
// [nI] bool, n_active [1] int32 -> s [N], wy [N, 3] (centred), cnt [N]
// int32, out_sum [1] = a_sum, out_nz [1] = nonzeros.
int cvo_dense_flow(const int* flags, const float* consts, const float* xp,
                   const float* yp, const int* pair_i, const int* pair_j,
                   const unsigned char* row_has, const int* n_active, float* s,
                   float* wy, int* cnt, float* out_sum, int* out_nz, int N, int M,
                   int tile_i, int tile_j, cudaStream_t stream) {
  if (bad_shapes(N, M, tile_i, tile_j)) return (int)cudaErrorInvalidValue;
  const Layout L = make_layout(flags, 9 + flags[0] + flags[1]);
  size_t smem = 0;
  cudaError_t err = shared_bytes(dense_flow_kernel, L, &smem);
  if (err != cudaSuccess) return (int)err;
  dense_flow_kernel<<<N / ROWS, dim3(ROWS, GROUPS), smem, stream>>>(
      L, make_consts(consts), xp, yp, pair_i, pair_j, row_has, n_active, s, wy, cnt,
      M, tile_i, tile_j);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  row_sum_kernel<<<1, FINAL_THREADS, 0, stream>>>(s, cnt, N, out_sum, out_nz);
  return (int)cudaGetLastError();
}

// As cvo_dense_flow with yp [24 + F + C, M] (twist rows appended);
// part [N / 32, 4] is scratch; out [4] = (B, C, D, E).
int cvo_dense_step(const int* flags, const float* consts, const float* xp,
                   const float* yp, const int* pair_i, const int* pair_j,
                   const unsigned char* row_has, const int* n_active, float* part,
                   float* out, int N, int M, int tile_i, int tile_j,
                   cudaStream_t stream) {
  if (bad_shapes(N, M, tile_i, tile_j)) return (int)cudaErrorInvalidValue;
  const Layout L = make_layout(flags, 24 + flags[0] + flags[1]);
  size_t smem = 0;
  cudaError_t err = shared_bytes(dense_step_kernel, L, &smem);
  if (err != cudaSuccess) return (int)err;
  const int nblocks = N / ROWS;
  dense_step_kernel<<<nblocks, dim3(ROWS, GROUPS), smem, stream>>>(
      L, make_consts(consts), xp, yp, pair_i, pair_j, row_has, n_active, part,
      M, tile_i, tile_j);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  step_sum_kernel<<<1, FINAL_THREADS, 0, stream>>>(part, nblocks, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
