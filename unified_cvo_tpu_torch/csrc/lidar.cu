// Two stages of the lidar frontend's LeGO-LOAM selection, written for
// Hopper (sm_90a). Neither replaces a Pallas kernel: the JAX package runs
// both on the host (unified_cvo_tpu/frontend/lidar.py), with scipy and
// Python loops. As torch ops on the card either stage would be thousands
// of tiny launches a scan (64 rings x up to 1800 serial steps), and both
// have data-dependent control flow, so each is one entry point here.
//
// L1 `cvo_lidar_components` replaces segment_range_image's
// connected_components (lidar.py:245-251): union-find on the [rows, cols]
// range image (cc.cuh: tile, border and compress passes). The links
// (vertical, and horizontal with the column wrap) are decided in torch and
// come in as bytes. The labels are the smallest cell id of each component.
// The host stereo frontend's speckle rule also runs it
// (ops/sgm.py::speckle_regions, no wrap: the last column's links are 0),
// and so does StereoSGBM's filterSpeckles (ops/sgbm_opencv.py).
//
// L2 `cvo_lidar_loam_features` replaces _loam_extract_features' ring loop
// (lidar.py:280-337): one warp a ring. The warp compacts the ring's kept
// columns (ballot), computes the +-5 curvature in numpy's pairwise order
// ((a0+a1)+(a2+a3))+((a4+a5)+(a6+a7)), then +a8, +a9, +a10, marks the
// occluded and parallel points, and splits the ring into numpy's 6
// linspace sectors. In each sector it takes the candidates (curvature
// finite and > the threshold, compared in double as numpy compares its
// float64 copy) in descending curvature, ties to the later column (the
// reversed stable order), by a warp argmax a step; lane 0 makes the
// serial decision (picked or not, the +-5 suppression that stops at
// column gaps > 10) until 20 corners. It writes a byte a cell (0 not in a
// processed sector, 1 "rest", 2 edge) and the rest count of each sector;
// the surface draw over the rest points is made in torch from one numpy
// stream, as JAX draws it sector by sector.
//
// What bounds them on this card: neither moves much (0.7 MB a scan each
// at 64 x 1800) nor computes much; L1 is three short launches (cc.cuh says
// what its design does about the long chains of large components), L2 is
// latency-bound on its serial greedy steps (64 warps, one per ring). The
// times are in PERF.md.
//
// Compiled with -fmad=false: the curvature's adds and multiplies round as
// the plain version's separate torch ops and numpy's do.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cc.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int N_SECTORS = 6;
constexpr int MAX_CORNERS = 20;
constexpr int CURV_HALF = 5;         // the +-5 curvature window
constexpr int MAX_COLS = 3400;       // 14 B of shared memory a column, under 48 KB

// link_v [rows - 1, cols]: cell (r, c) joins (r + 1, c); link_h [rows,
// cols]: (r, c) joins (r, (c + 1) % cols).
//
// Tile pass: block (TILE_W, TILE_H) threads, grid (tiles across, tiles
// down). The links that stay inside the tile (to the right but not out of
// its last column, down but not out of its last row) are joined here.
__global__ void __launch_bounds__(cc::TILE_W * cc::TILE_H)
    cc_tile4(const uint8_t* __restrict__ link_v, const uint8_t* __restrict__ link_h,
             int* __restrict__ labels, int rows, int cols) {
  using cc::TILE_H;
  using cc::TILE_W;
  __shared__ int s[TILE_W * TILE_H];
  __shared__ unsigned right_of[TILE_H];              // per tile row: bit j joins j and j + 1
  const int lc = threadIdx.x, lr = threadIdx.y;
  const int r0 = blockIdx.y * TILE_H, c0 = blockIdx.x * TILE_W;
  const int r = r0 + lr, c = c0 + lc, i = r * cols + c, li = lr * TILE_W + lc;
  const bool in = r < rows && c < cols;
  const bool h = in && lc + 1 < TILE_W && c + 1 < cols && __ldg(link_h + i);
  const bool v = in && lr + 1 < TILE_H && r + 1 < rows && __ldg(link_v + i);
  const unsigned hb = __ballot_sync(cc::FULL, h), vb = __ballot_sync(cc::FULL, v);
  s[li] = lr * TILE_W + cc::run_start(hb, lc);
  if (lc == 0) right_of[lr] = hb;
  __syncthreads();
  // the runs of rows lr and lr + 1 that meet at lc-1 and lc are joined by
  // the cell at lc-1 (or further left): one union per pair of runs
  if (v && !(lc > 0 && ((vb & hb & right_of[lr + 1]) >> (lc - 1) & 1u)))
    cc::unite_shared(s, li, li + TILE_W);
  __syncthreads();
  if (in) labels[i] = cc::global_id(cc::find_shared(s, li), r0, c0, cols);
}

// Border pass: TILE_W + TILE_H threads a tile, grid (tiles across, tiles
// down). Threads 0..TILE_W-1 take the tile's bottom row (its links down into
// the next tile row), the rest its last column (the links to the right out
// of the tile, and the wrap from the last column to column 0).
__global__ void cc_border4(const uint8_t* __restrict__ link_v,
                           const uint8_t* __restrict__ link_h, int* labels, int rows,
                           int cols) {
  using cc::TILE_H;
  using cc::TILE_W;
  const int r0 = blockIdx.y * TILE_H, c0 = blockIdx.x * TILE_W, t = threadIdx.x;
  if (t < TILE_W) {
    const int r = r0 + TILE_H - 1, c = c0 + t, i = r * cols + c;
    if (r + 1 >= rows || c >= cols || !__ldg(link_v + i)) return;
    // (r, c-1) makes the same union where it links down and both rows link it to c
    if (t > 0 && __ldg(link_v + i - 1) && __ldg(link_h + i - 1) && __ldg(link_h + i - 1 + cols))
      return;
    cc::unite_global(labels, i, i + cols);
  } else {
    const int lr = t - TILE_W, r = r0 + lr, c = min(c0 + TILE_W, cols) - 1, i = r * cols + c;
    if (r >= rows || !__ldg(link_h + i)) return;
    const int cn = c + 1 == cols ? 0 : c + 1;        // in the next tile, or the wrap
    // (r-1, c) makes the same union where it links right and both columns link down to r
    if (lr > 0 && __ldg(link_h + i - cols) && __ldg(link_v + i - cols)
        && __ldg(link_v + (r - 1) * cols + cn))
      return;
    cc::unite_global(labels, i, r * cols + cn);
  }
}

__device__ __forceinline__ bool better(float c, int k, float best, int bk) {
  return bk < 0 || c > best || (c == best && k > bk);
}

__global__ void loam_features_kernel(const float* range_img, const uint8_t* keep,
                                     uint8_t* kind, int* rest_counts, int cols,
                                     double edge_threshold) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* cc = reinterpret_cast<int*>(smem);            // kept columns, in order
  float* rr = reinterpret_cast<float*>(cc + cols);   // their ranges
  float* cv = rr + cols;                             // curvature
  uint8_t* picked = reinterpret_cast<uint8_t*>(cv + cols);
  uint8_t* state = picked + cols;                    // 0 open, 1 visited, 2 edge
  __shared__ int sector[N_SECTORS + 1];

  const int ring = blockIdx.x, lane = threadIdx.x;
  const float* row = range_img + (size_t)ring * cols;
  const uint8_t* krow = keep + (size_t)ring * cols;
  uint8_t* out = kind + (size_t)ring * cols;
  for (int c = lane; c < cols; c += 32) out[c] = 0;
  if (lane < N_SECTORS) rest_counts[ring * N_SECTORS + lane] = 0;

  int m = 0;
  for (int base = 0; base < cols; base += 32) {
    const int c = base + lane;
    const bool k = c < cols && krow[c];
    const unsigned b = __ballot_sync(FULL, k);
    if (k) {
      const int pos = m + __popc(b & ((1u << lane) - 1u));
      cc[pos] = c;
      rr[pos] = row[c];
    }
    m += __popc(b);
  }
  if (m < 12) return;                                // the whole warp: m is uniform
  __syncwarp();

  for (int k = lane; k < m; k += 32) {
    float cur = __int_as_float(0x7fc00000);          // NaN: no full window
    if (k >= CURV_HALF && k < m - CURV_HALF) {
      const float* a = rr + k - CURV_HALF;
      float s = ((a[0] + a[1]) + (a[2] + a[3])) + ((a[4] + a[5]) + (a[6] + a[7]));
      s = s + a[8];
      s = s + a[9];
      s = s + a[10];
      const float d = s - 11.0f * rr[k];
      cur = d * d;
    }
    cv[k] = cur;
    picked[k] = (k < CURV_HALF || k >= m - CURV_HALF) ? 1 : 0;
    state[k] = 0;
  }
  if (lane <= N_SECTORS)
    sector[lane] = lane == N_SECTORS ? m : (int)((double)lane * ((double)m / 6.0));
  __syncwarp();

  // occluded points (markOccludedPoints): every write stores 1
  for (int k = CURV_HALF + lane; k < m - 6; k += 32) {
    const int cd = abs(cc[k + 1] - cc[k]);
    const float rd = rr[k + 1] - rr[k];
    if (cd < 10) {
      if (rd < -0.3f) {
        for (int j = k - 5; j <= k; ++j) picked[j] = 1;
      } else if (rd > 0.3f) {
        for (int j = k + 1; j <= k + 6; ++j) picked[j] = 1;
      }
    }
  }
  // parallel beams: both neighbour steps above 2% of the range
  for (int k = lane; k < m; k += 32) {
    const float r = rr[k], lim = 0.02f * r;
    const float dp = k > 0 ? fabsf(r - rr[k - 1]) : 0.0f;
    const float dn = k < m - 1 ? fabsf(rr[k + 1] - r) : 0.0f;
    if (dp > lim && dn > lim) picked[k] = 1;
  }
  __syncwarp();

  for (int s = 0; s < N_SECTORS; ++s) {
    const int sp = sector[s], ep = sector[s + 1];
    if (ep - sp < 2) continue;
    int n_corner = 0;
    while (n_corner < MAX_CORNERS) {
      float best = 0.0f;
      int bk = -1;
      for (int k = sp + lane; k < ep; k += 32) {
        const float c = cv[k];
        if (!state[k] && isfinite(c) && (double)c > edge_threshold && better(c, k, best, bk)) {
          best = c;
          bk = k;
        }
      }
      for (int off = 16; off; off >>= 1) {
        const float ob = __shfl_down_sync(FULL, best, off);
        const int ok = __shfl_down_sync(FULL, bk, off);
        if (ok >= 0 && better(ob, ok, best, bk)) {
          best = ob;
          bk = ok;
        }
      }
      bk = __shfl_sync(FULL, bk, 0);
      if (bk < 0) break;
      if (lane == 0) {
        state[bk] = 1;
        if (!picked[bk]) {
          state[bk] = 2;
          picked[bk] = 1;
          const int hi = min(bk + 6, m);
          for (int l = bk + 1; l < hi; ++l) {
            if (abs(cc[l] - cc[l - 1]) > 10) break;
            picked[l] = 1;
          }
          const int lo = max(bk - 6, -1);
          for (int l = bk - 1; l > lo; --l) {
            if (abs(cc[l] - cc[l + 1]) > 10) break;
            picked[l] = 1;
          }
        }
      }
      __syncwarp();
      if (state[bk] == 2) ++n_corner;
    }
    int rest = 0;
    for (int k = sp + lane; k < ep; k += 32) {
      const bool edge = state[k] == 2;
      out[cc[k]] = edge ? 2 : 1;
      rest += edge ? 0 : 1;
    }
    for (int off = 16; off; off >>= 1) rest += __shfl_down_sync(FULL, rest, off);
    if (lane == 0) rest_counts[ring * N_SECTORS + s] = rest;
    __syncwarp();
  }
}

}  // namespace

extern "C" {

int cvo_lidar_max_cols() { return MAX_COLS; }

// link_v [rows - 1, cols] and link_h [rows, cols] bytes (1 = joined) ->
// labels [rows, cols] int32, the smallest cell id of each cell's component.
int cvo_lidar_components(const uint8_t* link_v, const uint8_t* link_h, int* labels, int rows,
                         int cols, cudaStream_t stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  const int n = rows * cols, threads = 256, blocks = (n + threads - 1) / threads;
  const dim3 tiles((cols + cc::TILE_W - 1) / cc::TILE_W, (rows + cc::TILE_H - 1) / cc::TILE_H);
  cc_tile4<<<tiles, dim3(cc::TILE_W, cc::TILE_H), 0, stream>>>(link_v, link_h, labels, rows,
                                                              cols);
  cc_border4<<<tiles, cc::TILE_W + cc::TILE_H, 0, stream>>>(link_v, link_h, labels, rows, cols);
  cc::compress<<<blocks, threads, 0, stream>>>(labels, n);
  return (int)cudaGetLastError();
}

// range_img [rows, cols] float32, keep [rows, cols] bytes -> kind [rows,
// cols] bytes (0 not in a processed sector, 1 rest, 2 edge), rest_counts
// [rows, 6] int32.
int cvo_lidar_loam_features(const float* range_img, const uint8_t* keep, uint8_t* kind,
                            int* rest_counts, int rows, int cols, double edge_threshold,
                            cudaStream_t stream) {
  if (rows <= 0 || cols <= 0 || cols > MAX_COLS) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)cols * (sizeof(int) + 2 * sizeof(float) + 2);
  loam_features_kernel<<<rows, 32, smem, stream>>>(range_img, keep, kind, rest_counts, cols,
                                                   edge_threshold);
  return (int)cudaGetLastError();
}

}  // extern "C"
