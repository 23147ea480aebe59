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
// What bounds it on this card: bytes, served from L2. Per source point it
// reads its 27 table rows (4P floats each, 128 B at P = 8: one 32-B sector
// per component and cell) and writes K slots of index and raw xyz (16 B
// each). The table (16.8 MB at 64x32x64 cells) fits the 50 MB L2, so the
// 27-fold reuse of each row across neighbouring source points is served
// from L2 rather than HBM; the arithmetic is a transform and a distance per
// candidate plus the selection. So the design keeps every lane's loads in
// flight at once and the selection short:
//   * gather without branches: a block is WARPS warps and TILE_PTS source
//     points, each warp takes its points one after another. Lane o < n_off
//     holds the cell row of pool cell o (offsets in dx, dy, dz order, fixed
//     per lane for the whole launch, so no division per point); candidate
//     c = lane + 32 i (pool position: cell c / P, slot c % P, shifts at the
//     specialised P = 8) takes its cell with one shuffle. Cells outside the
//     grid and positions past the pool read the sentinel row, which holds
//     -1 everywhere, so every index and coordinate load of a lane is issued
//     before the first is used;
//   * pick by rank, not by K rounds of argmin: the kept candidates (ballot
//     and popc) form a per-warp list in pool-position order, their d2 bits
//     in shared memory; each entry's rank is the number of entries with a
//     smaller d2, or the same d2 and an earlier place in the list (a lower
//     pool position), counted by its own lane over the list. The ranks are
//     a permutation, so rank r is slot r: ascending d2, ties to the lower
//     pool position, the order a stable sort of the pool gives (the plain
//     version), and kernel and plain agree slot for slot. A candidate of
//     rank < K goes to its slot with its index and raw coordinates from
//     the gather's registers; no value is reloaded, no chain of steps
//     waits on another. d2 >= 0, so its bit pattern orders like the float;
//   * staged stores: slot j of each of the block's points goes into a
//     shared [K, TILE_PTS] tile per component (rows padded to TILE_PTS + 1
//     words, so a point's 32 slots fall in distinct banks); the block then
//     writes each slot row as one contiguous run of TILE_PTS points (128 B
//     per component at 32 points), dead slots (-1 / DEAD_COORD) in the
//     same pass, and the kept counts as one run. K > 32 (not the builders'
//     default) stores each slot straight from its lane.
// No float atomics, no host sync, one launch; two launches on the same
// inputs give identical bits.
//
// Measurement switches (chip_smoke.py --select-ablation; both 0 in the
// package's build):
//   SELECT_ITER_ARGMIN   the pick as min(K, kept) steps of a warp argmin
//                        over (d2 bits, pool position), on the same gather,
//                        into the same stores
//   SELECT_DIRECT_STORE  each slot stored straight from its lane into the
//                        K-major outputs, not staged
//
// Compiled with -fmad=false so the transform and distance round exactly as
// the plain PyTorch version's separate ops do.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef SELECT_ITER_ARGMIN
#define SELECT_ITER_ARGMIN 0
#endif
#ifndef SELECT_DIRECT_STORE
#define SELECT_DIRECT_STORE 0
#endif

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int WARPS = 8;                    // warps a block
constexpr int TILE_PTS = 32;                // source points a block
constexpr int PTS_PER_WARP = TILE_PTS / WARPS;
constexpr int K_STAGE = 32;                 // largest K of the staged stores
constexpr int TILE_LD = TILE_PTS + 1;       // padded: slot rows fall in distinct banks
constexpr int P_FAST = 8;                   // nbr.PER_CELL_CAP, specialised
constexpr float DEAD_COORD = 1e9f;
constexpr unsigned INF_BITS = 0x7f800000u;  // +inf: a candidate not kept
static_assert(TILE_PTS % WARPS == 0, "whole points a warp");
static_assert(TILE_PTS == 32, "a staged slot row is one lane per point");

struct Args {
  const float* tab;    // [n_cells + 1, 4P]
  const int* cbase;    // [N, 3]
  const float* xr2;    // [N, 4]
  const float* pose;   // [12]
  int* idx;            // [K, N] out
  float* y;            // [3, K, N] out
  int* kept;           // [N] out
  int N, K, P;
  int gx, gy, gz;      // cells per axis
  int nx, ny, nz;      // offsets per axis: 3, or 1 for a single-cell axis
  int C;               // pool size: nx * ny * nz * P
};

// Dynamic shared memory of a block: each warp's list of kept candidates
// (d2 bits, then their ranks), then the staged [K, TILE_PTS] output tile.
__host__ __device__ constexpr size_t list_bytes(int C) { return (size_t)WARPS * C * 8; }
__host__ __device__ constexpr size_t tile_bytes(bool staged) {
  return staged ? (size_t)4 * K_STAGE * TILE_LD * 4 : 0;
}

#if SELECT_ITER_ARGMIN
// Smallest (d2 bits, pool position) key over the warp; ~0 when none.
template <int PL>
__device__ __forceinline__ unsigned long long warp_argmin(const unsigned (&u)[PL], int lane) {
  unsigned long long best = ~0ull;
#pragma unroll
  for (int i = 0; i < PL; ++i) {
    const unsigned long long packed =
        ((unsigned long long)u[i] << 32) | (unsigned)(lane + 32 * i);
    best = (u[i] != INF_BITS && packed < best) ? packed : best;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long other = __shfl_xor_sync(kFullMask, best, off);
    best = other < best ? other : best;
  }
  return best;
}
#endif

// PC: P at compile time (0: runtime P). PL: candidates a lane (32 PL >= C).
// Blocks an SM must hold (the second launch bound): 4, i.e. 64 registers a
// thread, for pools of up to 256 candidates, the P = 8 cases, so the bench
// grid's 512 blocks run in one wave; 3 for larger pools, whose candidates a
// lane need more registers.
template <int PC, int PL>
__global__ void __launch_bounds__(WARPS * 32, (PL <= 8 ? 4 : 3))
select_kernel(const Args a) {
  __shared__ float s_pose[12];
  __shared__ int s_cb[TILE_PTS * 3];
  __shared__ float s_xr2[TILE_PTS * 4];
  __shared__ int s_kept[TILE_PTS];
  extern __shared__ __align__(16) unsigned char smem[];

  const int P = PC > 0 ? PC : a.P;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n0 = blockIdx.x * TILE_PTS;
  const int npts = min(TILE_PTS, a.N - n0);
  const int K = a.K;
  const int C = a.C;
  const size_t plane = (size_t)K * a.N;
  const bool staged = !SELECT_DIRECT_STORE && K <= K_STAGE;
  unsigned* s_u = reinterpret_cast<unsigned*>(smem) + (size_t)warp * C;   // list: d2 bits
  int* s_rank = reinterpret_cast<int*>(smem) + (size_t)(WARPS + warp) * C;  // list: ranks
  int* s_idx = reinterpret_cast<int*>(smem + list_bytes(C));           // [K_STAGE][TILE_LD]
  float* s_y = reinterpret_cast<float*>(s_idx) + K_STAGE * TILE_LD;    // [3][K_STAGE][TILE_LD]

  // the block's per-point inputs, one coalesced load each
  if (tid < 12) s_pose[tid] = a.pose[tid];
  for (int t = tid; t < 3 * npts; t += WARPS * 32) s_cb[t] = a.cbase[3 * n0 + t];
  for (int t = tid; t < 4 * npts; t += WARPS * 32) s_xr2[t] = a.xr2[4 * (size_t)n0 + t];
  // this lane's cell offset (lane o < n_off), fixed for the launch
  const int n_off = a.nx * a.ny * a.nz;
  const int oz = lane % a.nz, oy = (lane / a.nz) % a.ny, ox = lane / (a.nz * a.ny);
  const int dx = a.nx == 3 ? ox - 1 : 0;
  const int dy = a.ny == 3 ? oy - 1 : 0;
  const int dz = a.nz == 3 ? oz - 1 : 0;
  const int sentinel = a.gx * a.gy * a.gz;
  const size_t P4 = 4 * (size_t)P;
  __syncthreads();
  float R[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) R[i] = s_pose[i];

  for (int q = 0; q < PTS_PER_WARP; ++q) {
    const int p = warp * PTS_PER_WARP + q;   // point within the block
    if (p >= npts) break;                    // whole warp leaves together
    const int n = n0 + p;
    const float x0 = s_xr2[4 * p], x1 = s_xr2[4 * p + 1], x2 = s_xr2[4 * p + 2];
    const float r2 = s_xr2[4 * p + 3];       // -1 for masked source rows
    int cell = sentinel;
    {
      const int cx = s_cb[3 * p] + dx, cy = s_cb[3 * p + 1] + dy, cz = s_cb[3 * p + 2] + dz;
      if (lane < n_off && cx >= 0 && cx < a.gx && cy >= 0 && cy < a.gy && cz >= 0 && cz < a.gz)
        cell = (cx * a.gy + cy) * a.gz + cz;
    }

    // gather: every load of the lane issued before the first is used
    float cx_[PL], cy_[PL], cz_[PL], ci_[PL];
#pragma unroll
    for (int i = 0; i < PL; ++i) {
      const int c = lane + 32 * i;
      const int o = c / P;                   // shifts at P = 8
      const int s = c - o * P;
      const int src = __shfl_sync(kFullMask, cell, o < 32 ? o : 31);
      const float* row = a.tab + (size_t)(c < C ? src : sentinel) * P4 + (c < C ? s : 0);
      cx_[i] = __ldg(row);
      cy_[i] = __ldg(row + P);
      cz_[i] = __ldg(row + 2 * P);
      ci_[i] = __ldg(row + 3 * P);
    }
    unsigned u[PL];                          // d2 bits, INF_BITS when not kept
#pragma unroll
    for (int i = 0; i < PL; ++i) {
      const float t0 = cx_[i] * R[0] + cy_[i] * R[1] + cz_[i] * R[2] + R[9];
      const float t1 = cx_[i] * R[3] + cy_[i] * R[4] + cz_[i] * R[5] + R[10];
      const float t2 = cx_[i] * R[6] + cy_[i] * R[7] + cz_[i] * R[8] + R[11];
      const float e0 = x0 - t0, e1 = x1 - t1, e2 = x2 - t2;
      const float d2 = e0 * e0 + e1 * e1 + e2 * e2;
      u[i] = ci_[i] >= 0.f && d2 <= r2 ? __float_as_uint(d2) : INF_BITS;
    }

    // where slot j of this point goes
    auto put = [&](int j, int ci, float yx, float yy, float yz) {
      if (staged) {
        s_idx[j * TILE_LD + p] = ci;
        s_y[j * TILE_LD + p] = yx;
        s_y[(K_STAGE + j) * TILE_LD + p] = yy;
        s_y[(2 * K_STAGE + j) * TILE_LD + p] = yz;
      } else {
        const size_t o = (size_t)j * a.N + n;
        a.idx[o] = ci;
        a.y[o] = yx;
        a.y[plane + o] = yy;
        a.y[2 * plane + o] = yz;
      }
    };

    // the kept candidates as a list in pool-position order (i, then lane)
    const unsigned lt = (1u << lane) - 1u;
    int slot[PL];
    int kept = 0;
#pragma unroll
    for (int i = 0; i < PL; ++i) {
      const unsigned b = __ballot_sync(kFullMask, u[i] != INF_BITS);
      slot[i] = kept + __popc(b & lt);
      kept += __popc(b);
    }
    const int E = min(K, kept);              // live slots of this row
#if SELECT_ITER_ARGMIN
    for (int j = 0; j < E; ++j) {
      const unsigned long long best = warp_argmin<PL>(u, lane);
      const int c = (int)(best & 0xffffffffull);
      if ((c & 31) == lane) {
#pragma unroll
        for (int i = 0; i < PL; ++i) {
          if (lane + 32 * i == c) {
            u[i] = INF_BITS;
            put(j, (int)ci_[i], cx_[i], cy_[i], cz_[i]);
          }
        }
      }
    }
#else
#pragma unroll
    for (int i = 0; i < PL; ++i)
      if (u[i] != INF_BITS) s_u[slot[i]] = u[i];
    __syncwarp();
    // rank of list entry j: the entries with a smaller d2, or the same d2
    // and an earlier place in the list (a lower pool position); the ranks
    // are a permutation, and rank r is slot r
    for (int j = lane; j < kept; j += 32) {
      const unsigned uj = s_u[j];
      int rk = 0;
#pragma unroll 4
      for (int m = 0; m < kept; ++m) {
        const unsigned um = s_u[m];
        rk += um < uj || (um == uj && m < j);
      }
      s_rank[j] = rk;
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < PL; ++i) {
      if (u[i] != INF_BITS) {
        const int r = s_rank[slot[i]];
        if (r < K) put(r, (int)ci_[i], cx_[i], cy_[i], cz_[i]);
      }
    }
    __syncwarp();                            // the list is free for the next point
#endif
    for (int j = E + lane; j < K; j += 32) put(j, -1, DEAD_COORD, DEAD_COORD, DEAD_COORD);
    if (lane == 0) {
      if (staged) s_kept[p] = kept;
      else a.kept[n] = kept;
    }
  }

  if (!staged) return;                       // uniform over the block
  __syncthreads();
  // each slot row of the block as one run of points, dead slots included
  if (lane < npts) {
    const int n = n0 + lane;
    for (int j = warp; j < K; j += WARPS) {
      const size_t o = (size_t)j * a.N + n;
      a.idx[o] = s_idx[j * TILE_LD + lane];
      a.y[o] = s_y[j * TILE_LD + lane];
      a.y[plane + o] = s_y[(K_STAGE + j) * TILE_LD + lane];
      a.y[2 * plane + o] = s_y[(2 * K_STAGE + j) * TILE_LD + lane];
    }
    if (warp == 0) a.kept[n] = s_kept[lane];
  }
}

template <int PC, int PL>
int launch(const Args& a, cudaStream_t stream) {
  const int blocks = (a.N + TILE_PTS - 1) / TILE_PTS;
  const size_t smem = list_bytes(a.C) + tile_bytes(!SELECT_DIRECT_STORE && a.K <= K_STAGE);
  if (smem > 48 * 1024) {                    // large pools: opt in beyond 48 KB
    const cudaError_t err = cudaFuncSetAttribute(
        select_kernel<PC, PL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  select_kernel<PC, PL><<<blocks, WARPS * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest pool (cells * P) one warp holds in registers.
int cvo_select_max_pool() { return 32 * 32; }

// The build's measurement switches, in the order SELECT_ITER_ARGMIN,
// SELECT_DIRECT_STORE.
void cvo_select_design(int* out) {
  out[0] = SELECT_ITER_ARGMIN;
  out[1] = SELECT_DIRECT_STORE;
}

// tab [n_cells + 1, 4P] (x | y | z | index slots, -1 when empty),
// cbase [N, 3] int32 base cell, xr2 [N, 4] (xyz, squared radius or -1),
// pose [12] (R_inv row-major | T_inv) -> idx [K, N] int32 (-1 dead),
// y [3, K, N] raw target xyz (DEAD_COORD dead), kept [N] int32 in-support
// candidate count.
int cvo_select(const float* tab, const int* cbase, const float* xr2,
               const float* pose, int* idx, float* y, int* kept, int N,
               int K, int P, int gx, int gy, int gz, cudaStream_t stream) {
  if (N <= 0 || K <= 0 || P <= 0) return (int)cudaErrorInvalidValue;
  const int nx = gx > 1 ? 3 : 1, ny = gy > 1 ? 3 : 1, nz = gz > 1 ? 3 : 1;
  const int pool = nx * ny * nz * P;
  const Args a{tab, cbase, xr2, pose, idx, y, kept, N, K, P, gx, gy, gz, nx, ny, nz, pool};
  if (P == P_FAST) {                         // pools of 8, 24, 72 or 216
    if (pool <= 32) return launch<P_FAST, 1>(a, stream);
    if (pool <= 96) return launch<P_FAST, 3>(a, stream);
    return launch<P_FAST, 7>(a, stream);
  }
  if (pool <= 32 * 4) return launch<0, 4>(a, stream);
  if (pool <= 32 * 8) return launch<0, 8>(a, stream);
  if (pool <= 32 * 16) return launch<0, 16>(a, stream);
  if (pool <= 32 * 24) return launch<0, 24>(a, stream);
  if (pool <= 32 * 32) return launch<0, 32>(a, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
