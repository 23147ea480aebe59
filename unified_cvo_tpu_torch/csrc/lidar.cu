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
// (lidar.py:280-337): one block a ring. The block compacts the ring's kept
// columns (every load in flight at once, a ballot for each warp's 32
// columns, a scan of those counts), computes the +-5 curvature in numpy's
// pairwise order ((a0+a1)+(a2+a3))+((a4+a5)+(a6+a7)), then +a8, +a9,
// +a10, marks the ends, the occluded and the parallel points, and splits
// the ring into numpy's 6 linspace sectors. In a sector the reference
// walks the candidates (curvature finite and > the threshold, compared in
// double as numpy compares its float64 copy) in descending curvature, ties
// to the later column (the reversed stable order); each one not yet
// picked becomes a corner and marks up to 5 positions either side
// (stopping at column gaps > 10), until 20 corners.
// Marking is symmetric (p marks q exactly when q would mark p), so the
// walk's corners are the first independent set in rank order among the
// unpicked candidates, and the block finds it in rounds: every live
// candidate that outranks its live neighbours (at most 10 positions)
// becomes a corner, then the neighbours of corners drop. A candidate's
// rank is only ever compared with its neighbours', so nothing is sorted.
// The walk's j-th corner is decided by round j, so at most 20 rounds a
// sector; if more than 20 corners were decided, the block keeps the 20
// that fewer than 20 others outrank (an all-pairs count over the corners).
// Those corners mark forward into the next sectors, which run in order.
// It writes a byte a cell (0 not in a processed sector, 1 "rest", 2 edge)
// and the rest count of each sector; the surface draw over the rest points
// is made in torch from one numpy stream, as JAX draws it sector by sector.
//
// What bounds them on this card: neither moves much (0.7 MB a scan each
// at 64 x 1800) nor computes much; L1 is three short launches (cc.cuh says
// what its design does about the long chains of large components). L2 is
// one launch of a block a ring (64 blocks on 132 SMs), so its time is the
// slowest ring's serial chain: the prologue (five barriers), then in each
// sector a round of two barrier-separated phases for every step of its
// longest chain of candidates that wait on a higher neighbour (at most 20
// rounds), and one or two barriers to close it. A barrier alone is cheap;
// the rounds' phases are most of a ring's time. The times are in PERF.md.
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
constexpr int MAX_COLS = 3400;       // L2: 13 B of shared memory a column, under 48 KB
#ifndef LOAM_THREADS
#define LOAM_THREADS 512                 // L2's threads a block (one block a ring)
#endif
constexpr int LOAM_WARPS = LOAM_THREADS / 32;
constexpr int COL_STEPS = (MAX_COLS + LOAM_THREADS - 1) / LOAM_THREADS;    // columns a thread
constexpr int MAX_SECTOR = MAX_COLS / N_SECTORS + 2;   // positions of a sector, at most
constexpr int SECTOR_STEPS = (MAX_SECTOR + LOAM_THREADS - 1) / LOAM_THREADS;   // a thread's
constexpr int SECTOR_WORDS = SECTOR_STEPS * LOAM_THREADS / 32 + 2;   // and a guard word each end
static_assert(LOAM_THREADS % 32 == 0 && LOAM_THREADS <= 1024, "whole warps, one block");
static_assert(COL_STEPS <= 32 && SECTOR_STEPS <= 32, "a bit a step in one word");
static_assert(SECTOR_WORDS <= LOAM_THREADS, "one thread clears each bitmap word");

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

constexpr uint8_t REST = 1, EDGE = 2;                  // kind's codes

__device__ __forceinline__ bool outranks(float cl, int l, float ck, int k) {
  return cl > ck || (cl == ck && l > k);
}

// Bits rel - 5 .. rel + 5 (bit 5 is rel) of a sector's bitmap, kept one
// word off its start so that the window never leaves it.
__device__ __forceinline__ unsigned window11(const unsigned* bits, int rel) {
  const int q = rel + 32 - CURV_HALF;
  const unsigned long long v =
      bits[q >> 5] | (unsigned long long)bits[(q >> 5) + 1] << 32;
  return (unsigned)(v >> (q & 31)) & 0x7ffu;
}

// One block a ring.
__global__ void __launch_bounds__(LOAM_THREADS)
    loam_features_kernel(const float* __restrict__ range_img, const uint8_t* __restrict__ keep,
                         uint8_t* __restrict__ kind, int* __restrict__ rest_counts, int cols,
                         double edge_threshold) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* rr = reinterpret_cast<float*>(smem);             // ranges of the kept columns, in order
  float* cv = rr + cols;                                  // curvature
  uint16_t* cc = reinterpret_cast<uint16_t*>(cv + cols);  // the kept columns
  uint8_t* picked = reinterpret_cast<uint8_t*>(cc + cols);
  uint8_t* st = picked + cols;                            // kind's code, 0 outside a processed sector
  uint8_t* reach = st + cols;                             // positions a corner marks: ahead | behind << 4
  // once the prologue is done, the ranges' room holds a sector's corners
  float* corner_cv = rr;
  uint16_t* corner_k = reinterpret_cast<uint16_t*>(rr + cols / N_SECTORS + 2);
  __shared__ int chunk_at[COL_STEPS * LOAM_WARPS];        // kept columns before each warp's chunk
  __shared__ unsigned active[SECTOR_WORDS], corner[SECTOR_WORDS];   // a sector's bitmaps
  __shared__ int n_kept, n_corner, rest_of[N_SECTORS];

  const int ring = blockIdx.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned below = (1u << lane) - 1u;
  const float* row = range_img + (size_t)ring * cols;
  const uint8_t* krow = keep + (size_t)ring * cols;
  uint8_t* out = kind + (size_t)ring * cols;

  // compaction: column j * LOAM_THREADS + t is thread t's j-th, all loads in
  // flight at once; a ballot a chunk of 32 columns and a scan of the chunks'
  // counts place the kept ones
  float rv[COL_STEPS];
  unsigned kept = 0, before[COL_STEPS];
#pragma unroll
  for (int j = 0; j < COL_STEPS; ++j) {
    const int c = j * LOAM_THREADS + t;
    const bool k = c < cols && krow[c];
    rv[j] = c < cols ? row[c] : 0.0f;
    const unsigned b = __ballot_sync(FULL, k);
    before[j] = __popc(b & below);
    kept |= (unsigned)k << j;
    if (lane == 0) chunk_at[j * LOAM_WARPS + warp] = __popc(b);
  }
  if (t < N_SECTORS) rest_of[t] = 0;
  if (t < SECTOR_WORDS) active[t] = corner[t] = 0;
  __syncthreads();
  if (warp == 0) {                                        // exclusive scan of the chunk counts
    constexpr int PER = (COL_STEPS * LOAM_WARPS + 31) / 32;
    int v[PER], sum = 0;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int at = lane * PER + i;
      v[i] = at < COL_STEPS * LOAM_WARPS ? chunk_at[at] : 0;
      sum += v[i];
    }
    int incl = sum;
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += x;
    }
    int run = incl - sum;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int at = lane * PER + i;
      if (at < COL_STEPS * LOAM_WARPS) chunk_at[at] = run;
      run += v[i];
    }
    if (lane == 31) n_kept = incl;
  }
  __syncthreads();
  const int m = n_kept;
  if (m < 12) {                                           // the whole block: m is uniform
#pragma unroll
    for (int j = 0; j < COL_STEPS; ++j)
      if (j * LOAM_THREADS + t < cols) out[j * LOAM_THREADS + t] = 0;
    if (t < N_SECTORS) rest_counts[ring * N_SECTORS + t] = 0;
    return;
  }
#pragma unroll
  for (int j = 0; j < COL_STEPS; ++j)
    if (kept >> j & 1u) {
      const int pos = chunk_at[j * LOAM_WARPS + warp] + before[j];
      cc[pos] = (uint16_t)(j * LOAM_THREADS + t);
      rr[pos] = rv[j];
    }
  __syncthreads();

  // curvature, the ends and parallel beams (both neighbour steps above 2%
  // of the range), and how far a corner at each position marks
  for (int k = t; k < m; k += LOAM_THREADS) {
    float cur = __int_as_float(0x7fc00000);               // NaN: no full window
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
    const float r = rr[k], lim = 0.02f * r;
    const float dp = k > 0 ? fabsf(r - rr[k - 1]) : 0.0f;
    const float dn = k < m - 1 ? fabsf(rr[k + 1] - r) : 0.0f;
    picked[k] = k < CURV_HALF || k >= m - CURV_HALF || (dp > lim && dn > lim);
    unsigned gap = 0;                                     // bit o: a gap > 10 after position k - 5 + o
#pragma unroll
    for (int o = 0; o < 2 * CURV_HALF; ++o) {
      const int a = k - CURV_HALF + o;
      const bool in = a >= 0 && a + 1 < m;
      gap |= (unsigned)(!in || cc[in ? a + 1 : 0] - cc[in ? a : 0] > 10) << o;
    }
    const int ahead = __ffs((gap >> CURV_HALF) | (1u << CURV_HALF)) - 1;
    const unsigned back = gap & ((1u << CURV_HALF) - 1u);
    const int behind = back ? CURV_HALF - 1 - (31 - __clz(back)) : CURV_HALF;
    reach[k] = (uint8_t)(ahead | behind << 4);
    st[k] = 0;
  }
  __syncthreads();
  // occluded points (markOccludedPoints): every write stores 1
  for (int k = CURV_HALF + t; k < m - 6; k += LOAM_THREADS) {
    const int cd = cc[k + 1] - cc[k];
    const float rd = rr[k + 1] - rr[k];
    if (cd < 10) {
      if (rd < -0.3f) {
        for (int j = k - 5; j <= k; ++j) picked[j] = 1;
      } else if (rd > 0.3f) {
        for (int j = k + 1; j <= k + 6; ++j) picked[j] = 1;
      }
    }
  }
  __syncthreads();

  // The sectors in order: a sector's corners mark positions of the next.
  // Thread t holds sector positions j * LOAM_THREADS + t; for each, a bit of
  // `live` (a candidate not yet decided) and `mine` (a corner), and two
  // 11-bit masks over positions -5..+5: the ones it would mark (nb) and,
  // among those, the ones that outrank it (hi). The block shares the
  // bitmaps `active` (live or corner) and `corner`.
  for (int s = 0; s < N_SECTORS; ++s) {
    const int sp = (int)((double)s * ((double)m / 6.0));
    const int ep = s + 1 == N_SECTORS ? m : (int)((double)(s + 1) * ((double)m / 6.0));
    if (ep - sp < 2) continue;                            // uniform
    unsigned live = 0, mine = 0, nb[SECTOR_STEPS], hi[SECTOR_STEPS];
#pragma unroll
    for (int j = 0; j < SECTOR_STEPS; ++j) {
      const int rel = j * LOAM_THREADS + t, k = sp + rel;
      nb[j] = hi[j] = 0;
      bool l = false;
      if (rel < ep - sp) {
        const float c = cv[k];
        l = !picked[k] && isfinite(c) && (double)c > edge_threshold;
        if (l) {
          const int r = reach[k], lo = CURV_HALF - (r >> 4), up = CURV_HALF + (r & 15);
#pragma unroll
          for (int o = 0; o <= 2 * CURV_HALF; ++o) {
            if (o == CURV_HALF || o < lo || o > up) continue;
            const int q = k - CURV_HALF + o;
            nb[j] |= 1u << o;
            hi[j] |= (unsigned)outranks(cv[q], q, c, k) << o;
          }
        }
      }
      live |= (unsigned)l << j;
      const unsigned b = __ballot_sync(FULL, l);
      if (lane == 0) {
        active[(j * LOAM_THREADS >> 5) + warp + 1] = b;
        corner[(j * LOAM_THREADS >> 5) + warp + 1] = 0;
      }
    }
    if (t == 0) n_corner = 0;
    // Rounds. A live candidate that outranks its active neighbours (the
    // positions it would mark, inside the sector) becomes a corner; then the
    // live neighbours of a corner drop. The corner with j corners of the
    // serial walk before it is decided by round j + 1, so 20 rounds decide
    // the walk's first 20.
    for (int round = 0; __syncthreads_or(live) && round < MAX_CORNERS; ++round) {
#pragma unroll
      for (int j = 0; j < SECTOR_STEPS; ++j) {
        const int rel = j * LOAM_THREADS + t;
        if ((live >> j & 1u) && !(window11(active, rel) & hi[j])) {
          atomicOr(&corner[(rel >> 5) + 1], 1u << (rel & 31));
          live &= ~(1u << j);
          mine |= 1u << j;
          const int i = atomicAdd(&n_corner, 1);
          corner_cv[i] = cv[sp + rel];
          corner_k[i] = (uint16_t)(sp + rel);
        }
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < SECTOR_STEPS; ++j) {
        const int rel = j * LOAM_THREADS + t;
        if ((live >> j & 1u) && (window11(corner, rel) & nb[j])) {
          atomicAnd(&active[(rel >> 5) + 1], ~(1u << (rel & 31)));
          live &= ~(1u << j);
        }
      }
    }
    const int n = n_corner;                               // after the loop's last barrier
    if (n > MAX_CORNERS) {
      // the walk stops at its 20th corner: a corner that 20 others outrank goes
      for (int i = t; i < n; i += LOAM_THREADS) {
        const float c = corner_cv[i];
        const int k = corner_k[i];
        int above = 0;
#pragma unroll 4
        for (int j = 0; j < n; ++j) above += outranks(corner_cv[j], corner_k[j], c, k);
        if (above >= MAX_CORNERS) {
          const int rel = k - sp;
          atomicAnd(&corner[(rel >> 5) + 1], ~(1u << (rel & 31)));
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < SECTOR_STEPS; ++j) {
      const int rel = j * LOAM_THREADS + t, k = sp + rel;
      if (rel >= ep - sp) continue;
      const bool edge = (mine >> j & 1u) && (corner[(rel >> 5) + 1] >> (rel & 31) & 1u);
      st[k] = edge ? EDGE : REST;
      if (edge) {
        const int r = reach[k];
        for (int l = k - (r >> 4); l <= k + (r & 15); ++l) picked[l] = 1;
      }
    }
    if (t == 0) rest_of[s] = (ep - sp) - min(n, MAX_CORNERS);
    __syncthreads();
  }

  if (t < N_SECTORS) rest_counts[ring * N_SECTORS + t] = rest_of[t];
#pragma unroll
  for (int j = 0; j < COL_STEPS; ++j) {
    const int c = j * LOAM_THREADS + t;
    if (c < cols) out[c] = kept >> j & 1u ? st[chunk_at[j * LOAM_WARPS + warp] + before[j]] : 0;
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
  const size_t smem = (size_t)cols * (2 * sizeof(float) + sizeof(uint16_t) + 3);
  loam_features_kernel<<<rows, LOAM_THREADS, smem, stream>>>(range_img, keep, kind, rest_counts,
                                                             cols, edge_threshold);
  return (int)cudaGetLastError();
}

}  // extern "C"
