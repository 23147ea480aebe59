// K-nearest candidate selection of the neighbor-list build, written for
// Hopper (sm_90a).
//
// Replaces unified_cvo_tpu/ops/pallas_select.py::_select_kernel (reached
// through pool_select from ops/neighbors.py::build_neighbor_list). The TPU
// kernel reads a pre-gathered, z-dilated candidate pool because TPU gathers
// cost per index; here the kernel gathers for itself: it reads each source
// point's 27 cells straight from the voxel table, so gather and selection
// are one pass and the pool never exists in device memory.
//
// What bounds it on this card: bytes. Per source point it reads up to 27
// table rows of 4P floats (864 B at P = 8) and writes K slots of index and
// raw xyz (16 B each); the arithmetic is a transform and a distance per
// candidate plus the selection. The table (16.8 MB at 64x32x64 cells, P = 8)
// fits the 50 MB L2, so the 27-fold reuse of each row across neighbouring
// source points is served from L2 rather than HBM.
//
// Layout: one warp per source point. Lane l holds candidates l, l+32, ...
// of the point's pool (position = cell offset * P + slot, offsets in
// dx, dy, dz order), keeping only their squared distances (+inf when gated
// out) in registers. The kept count is a warp sum, and the K nearest come
// out by iterated warp argmin over (d2 bits, position) packed in 64 bits,
// min(K, kept) steps per row. Ties therefore go to the lower pool
// position, which is the order a stable sort of the pool gives (the plain
// version), so kernel and plain agree slot for slot. The winning lane
// writes the slot's index and raw coordinates straight into the K-major
// outputs; unused slots get -1 / DEAD_COORD.
//
// Compiled with -fmad=false so the transform and distance round exactly as
// the plain PyTorch version's separate ops do.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int WARPS = 8;                 // source points per block
constexpr float DEAD_COORD = 1e9f;

struct Grid {
  int gx, gy, gz;       // cells per axis
  int nx, ny, nz;       // offsets per axis: 3, or 1 for a single-cell axis
};

// cell row of pool position c for base cell (bx, by, bz); -1 outside the grid
__device__ __forceinline__ long long cell_of(int c, int P, const Grid& g,
                                             int bx, int by, int bz) {
  const int o = c / P;
  const int oz = o % g.nz;
  const int oy = (o / g.nz) % g.ny;
  const int ox = o / (g.nz * g.ny);
  const int cx = bx + (g.nx == 3 ? ox - 1 : 0);
  const int cy = by + (g.ny == 3 ? oy - 1 : 0);
  const int cz = bz + (g.nz == 3 ? oz - 1 : 0);
  if (cx < 0 || cx >= g.gx || cy < 0 || cy >= g.gy || cz < 0 || cz >= g.gz)
    return -1;
  return ((long long)cx * g.gy + cy) * g.gz + cz;
}

template <int PL>
__global__ void __launch_bounds__(WARPS * 32)
select_kernel(const float* __restrict__ tab, const int* __restrict__ cbase,
              const float* __restrict__ xr2, const float* __restrict__ pose,
              int* __restrict__ idx_out, float* __restrict__ y_out,
              int* __restrict__ kept_out, int N, int K, int P, Grid g) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (n >= N) return;                    // whole warp leaves together
  const int P4 = 4 * P;
  const int C = g.nx * g.ny * g.nz * P;  // pool size of this point
  const float x0 = xr2[4 * n], x1 = xr2[4 * n + 1], x2 = xr2[4 * n + 2];
  const float r2 = xr2[4 * n + 3];       // -1 for masked source rows
  const int bx = cbase[3 * n], by = cbase[3 * n + 1], bz = cbase[3 * n + 2];
  float R[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) R[i] = pose[i];

  float key[PL];
  int kept = 0;
#pragma unroll
  for (int i = 0; i < PL; ++i) {
    key[i] = INFINITY;
    const int c = lane + 32 * i;
    if (c < C) {
      const long long cell = cell_of(c, P, g, bx, by, bz);
      if (cell >= 0) {
        const float* row = tab + cell * P4;
        const int s = c % P;
        const float ci = row[3 * P + s];
        if (ci >= 0.f) {
          const float ya = row[s], yb = row[P + s], yc = row[2 * P + s];
          const float t0 = ya * R[0] + yb * R[1] + yc * R[2] + R[9];
          const float t1 = ya * R[3] + yb * R[4] + yc * R[5] + R[10];
          const float t2 = ya * R[6] + yb * R[7] + yc * R[8] + R[11];
          const float e0 = x0 - t0, e1 = x1 - t1, e2 = x2 - t2;
          const float d2 = e0 * e0 + e1 * e1 + e2 * e2;
          if (d2 <= r2) {
            key[i] = d2;
            ++kept;
          }
        }
      }
    }
  }
  kept = __reduce_add_sync(kFullMask, kept);
  const int nsteps = kept < K ? kept : K;

  for (int j = 0; j < nsteps; ++j) {
    // d2 >= 0, so its bit pattern orders like the float; the low word
    // breaks ties by pool position
    unsigned long long best = ~0ull;
#pragma unroll
    for (int i = 0; i < PL; ++i) {
      if (key[i] != INFINITY) {
        const unsigned long long packed =
            ((unsigned long long)__float_as_uint(key[i]) << 32) |
            (unsigned)(lane + 32 * i);
        best = packed < best ? packed : best;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long other = __shfl_xor_sync(kFullMask, best, off);
      best = other < best ? other : best;
    }
    const int c = (int)(best & 0xffffffffull);
    if ((c & 31) == lane) {
#pragma unroll
      for (int i = 0; i < PL; ++i)
        if (lane + 32 * i == c) key[i] = INFINITY;
      const float* row = tab + cell_of(c, P, g, bx, by, bz) * P4;
      const int s = c % P;
      const size_t o = (size_t)j * N + n;
      const size_t plane = (size_t)K * N;
      idx_out[o] = (int)row[3 * P + s];
      y_out[o] = row[s];
      y_out[plane + o] = row[P + s];
      y_out[2 * plane + o] = row[2 * P + s];
    }
  }
  for (int j = nsteps + lane; j < K; j += 32) {
    const size_t o = (size_t)j * N + n;
    const size_t plane = (size_t)K * N;
    idx_out[o] = -1;
    y_out[o] = DEAD_COORD;
    y_out[plane + o] = DEAD_COORD;
    y_out[2 * plane + o] = DEAD_COORD;
  }
  if (lane == 0) kept_out[n] = kept;
}

template <int PL>
void launch(const float* tab, const int* cbase, const float* xr2,
            const float* pose, int* idx, float* y, int* kept, int N, int K,
            int P, Grid g, cudaStream_t stream) {
  const int blocks = (N + WARPS - 1) / WARPS;
  select_kernel<PL><<<blocks, WARPS * 32, 0, stream>>>(
      tab, cbase, xr2, pose, idx, y, kept, N, K, P, g);
}

}  // namespace

extern "C" {

// Largest pool (cells * P) one warp holds in registers.
int cvo_select_max_pool() { return 32 * 32; }

// tab [n_cells + 1, 4P] (x | y | z | index slots, -1 when empty),
// cbase [N, 3] int32 base cell, xr2 [N, 4] (xyz, squared radius or -1),
// pose [12] (R_inv row-major | T_inv) -> idx [K, N] int32 (-1 dead),
// y [3, K, N] raw target xyz (DEAD_COORD dead), kept [N] int32 in-support
// candidate count.
int cvo_select(const float* tab, const int* cbase, const float* xr2,
               const float* pose, int* idx, float* y, int* kept, int N,
               int K, int P, int gx, int gy, int gz, cudaStream_t stream) {
  Grid g{gx, gy, gz, gx > 1 ? 3 : 1, gy > 1 ? 3 : 1, gz > 1 ? 3 : 1};
  const int pool = g.nx * g.ny * g.nz * P;
  if (pool <= 32 * 4)
    launch<4>(tab, cbase, xr2, pose, idx, y, kept, N, K, P, g, stream);
  else if (pool <= 32 * 8)
    launch<8>(tab, cbase, xr2, pose, idx, y, kept, N, K, P, g, stream);
  else if (pool <= 32 * 16)
    launch<16>(tab, cbase, xr2, pose, idx, y, kept, N, K, P, g, stream);
  else if (pool <= 32 * 24)
    launch<24>(tab, cbase, xr2, pose, idx, y, kept, N, K, P, g, stream);
  else if (pool <= 32 * 32)
    launch<32>(tab, cbase, xr2, pose, idx, y, kept, N, K, P, g, stream);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
