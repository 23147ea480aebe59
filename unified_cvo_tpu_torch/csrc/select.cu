// K-nearest candidate selection of the neighbor-list build, written for
// Hopper (sm_90a).
//
// Replaces unified_cvo_tpu/ops/pallas_select.py::_select_kernel (reached
// through pool_select from ops/neighbors.py::build_neighbor_list, and from
// models/irls.py's ELL moments). The TPU kernel reads a pre-gathered,
// z-dilated candidate pool because TPU gathers cost per index; here the
// kernel gathers for itself: it reads each source point's 27 cells straight
// from the voxel table, so gather and selection are one pass and the pool
// never exists in device memory. Two routes, chosen by cvo_select's
// dispatch from the shapes alone:
//
// Route 1, the align list (P = 8, K <= 32: nbr.PER_CELL_CAP, nbr.DEFAULT_K).
// What bounds it: bytes, served from L2. Per source point it reads its 27
// table rows (4P floats each, 128 B at P = 8: one 32-B sector per component
// and cell) and writes K slots of index and raw xyz (16 B each). The table
// (16.8 MB at 64x32x64 cells) fits the 50 MB L2, so the 27-fold reuse of
// each row across neighbouring source points is served from L2. So
// `select_kernel` keeps every lane's loads in flight at once and the pick
// short:
//   * gather without branches: a block is WARPS warps and TILE_PTS source
//     points, each warp takes its points one after another. Lane o < n_off
//     holds the cell row of pool cell o (offsets in dx, dy, dz order, fixed
//     per lane for the whole launch, so no division per point); candidate
//     c = lane + 32 i (pool position: cell c / P, slot c % P) takes its cell
//     with one shuffle. Cells outside the grid and positions past the pool
//     read the sentinel row, which holds -1 everywhere, so every index and
//     coordinate load of a lane is issued before the first is used;
//   * pick by rank: the kept candidates (ballot and popc) form a per-warp
//     list in pool-position order, their d2 bits in shared memory; each
//     entry's rank is the number of entries with a smaller d2, or the same
//     d2 and an earlier place in the list (a lower pool position), counted
//     by its own lane over the list. The ranks are a permutation, so rank r
//     is slot r: ascending d2, ties to the lower pool position, the order a
//     stable sort of the pool gives (the plain version). d2 >= 0, so its
//     bit pattern orders like the float;
//   * staged stores: slot j of each of the block's points goes into a
//     shared [K, TILE_PTS] tile per component; the block then writes each
//     slot row as one contiguous run of TILE_PTS points (128 B per
//     component), dead slots (-1 / DEAD_COORD) in the same pass.
//
// Route 2 gives the align list the same outputs but takes 0.0439 ms there
// against route 1's 0.0262-0.0264 (H100, chip_smoke.py --compare-tree), so
// the dispatch keeps route 1 for it.
//
// Route 2, large pools (any other P or K; the IRLS list: P = 32, K = 128,
// pool 27 x 32 = 864). The table is 131073 x 128 floats (67 MB, more than
// L2), its cells mostly empty (a BA edge at 32768 points fills ~2 of a
// cell's 32 slots), and the output, K x N slots of 16 B (67 MB at K = 128),
// is what bounds it. Holding 27-32 candidates a lane in registers, as route
// 1 does, spills; ranking hundreds of kept entries by counting is quadratic;
// K slots stored from their lanes write every 4 B into a sector of its own.
// So `select_pool_kernel` takes one source point a warp, 8 a block:
//   * candidates out of registers: the pool streams in rounds of one
//     candidate a lane (POOL_ROUNDS in flight). Each lane loads the index slot
//     first and the three coordinates only where it is >= 0, so empty slots
//     and cells outside the grid (whole rounds at P = 32) cost no coordinate
//     traffic. Kept candidates append to the warp's list in shared memory by
//     ballot and popc, in pool order: d2 bits and the pool position
//     (cell << 10 | slot). Registers no longer grow with the pool;
//   * a pick linear in kept: when kept <= K every entry is a slot; when
//     kept > K a bitwise search with warp sums over the list finds the K-th
//     smallest d2, T, and the count `need` of entries equal to T that slot
//     K takes; the entries below T and the first `need` equal to T in list
//     order (the lower pool positions, as the stable sort settles a tie at
//     the K-th place) are the E = K selected. The E selected are ranked by
//     counting among themselves (at most K^2 / 32 steps a lane);
//   * slots re-read at store time: slot r's index and raw xyz come from the
//     table row of its pool position (an L1 / L2 hit), into a shared
//     [4][8 points][K] tile;
//   * stores in whole sectors: the block writes each slot row of its 8
//     points as one 32-B run per component, so the bytes written are the
//     output's bytes.
// No float atomics, no host sync, one launch; two launches on the same
// inputs give identical bits.
//
// Route 1 also comes with a lane axis (`cvo_select_lanes`, LANES = true):
// the build of L lists in one launch, the counterpart of _select_kernel
// under the JAX package's jax.vmap of align (parallel/batch_align.py:51-55),
// where the batch becomes a grid axis. The lane is blockIdx.y; every input
// and output carries a leading lane axis and a lane's block offsets its
// pointers by whole lanes, so each lane's slots are the unbatched launch's
// bit for bit. LANES = false compiles the offsets out. Route 2 keeps no
// lane axis: no JAX path vmaps the IRLS list.
//
// Compiled with -fmad=false so the transform and distance round exactly as
// the plain PyTorch version's separate ops do.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr float DEAD_COORD = 1e9f;
constexpr unsigned INF_BITS = 0x7f800000u;  // +inf: a candidate not kept

// ---- route 1: P = 8, K <= 32
constexpr int WARPS = 8;                    // warps a block
constexpr int TILE_PTS = 32;                // source points a block
constexpr int PTS_PER_WARP = TILE_PTS / WARPS;
constexpr int K_STAGE = 32;                 // largest K of route 1
constexpr int TILE_LD = TILE_PTS + 1;       // padded: slot rows fall in distinct banks
constexpr int P_FAST = 8;                   // nbr.PER_CELL_CAP
static_assert(TILE_PTS % WARPS == 0, "whole points a warp");
static_assert(TILE_PTS == 32, "a staged slot row is one lane per point");

// ---- route 2: any P and K
constexpr int POOL_WARPS = 8;               // warps a block = source points a block
constexpr int POOL_ROUNDS = 4;              // rounds of the pool in flight a lane
constexpr int POS_SHIFT = 10;               // pool position: cell << 10 | slot (P <= 1024)

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

// Lane l's view of a lane-axis launch: every array [L, ...] advanced by l
// whole lanes.
__device__ __forceinline__ Args lane_args(const Args& a, int l) {
  Args b = a;
  const size_t L = (size_t)l;
  b.tab += L * ((size_t)a.gx * a.gy * a.gz + 1) * 4 * a.P;
  b.cbase += L * 3 * a.N;
  b.xr2 += L * 4 * a.N;
  b.pose += L * 12;
  b.idx += L * a.K * a.N;
  b.y += L * 3 * a.K * a.N;
  b.kept += L * a.N;
  return b;
}

// d2 bits of a candidate (INF_BITS when not kept): the plain version's
// operation order, each multiply and add rounded on its own (-fmad=false).
__device__ __forceinline__ unsigned cand_bits(const float (&R)[12], float x0, float x1, float x2,
                                              float r2, float cx, float cy, float cz, float ci) {
  const float t0 = cx * R[0] + cy * R[1] + cz * R[2] + R[9];
  const float t1 = cx * R[3] + cy * R[4] + cz * R[5] + R[10];
  const float t2 = cx * R[6] + cy * R[7] + cz * R[8] + R[11];
  const float e0 = x0 - t0, e1 = x1 - t1, e2 = x2 - t2;
  const float d2 = e0 * e0 + e1 * e1 + e2 * e2;
  return ci >= 0.f && d2 <= r2 ? __float_as_uint(d2) : INF_BITS;
}

// ---- route 1 --------------------------------------------------------------

// Dynamic shared memory of a block: each warp's list of kept candidates
// (d2 bits, then their ranks), then the staged [K, TILE_PTS] output tile.
__host__ __device__ constexpr size_t list_bytes(int C) { return (size_t)WARPS * C * 8; }
__host__ __device__ constexpr size_t tile_bytes(bool staged) {
  return staged ? (size_t)4 * K_STAGE * TILE_LD * 4 : 0;
}

// PC: P at compile time (cvo_select dispatches P_FAST only). PL: candidates
// a lane (32 PL >= C). Blocks an SM must hold (the second launch bound): 4,
// i.e. 64 registers a thread, for pools of up to 256 candidates, the P = 8
// cases, so the bench grid's 512 blocks run in one wave. The kernel is kept
// as this route was first tuned, its branches the dispatch never takes (the
// unstaged stores, a runtime P) included: without them ptxas spills 12 B at
// PL = 7 and the align list takes 0.0275 ms against 0.0262-0.0264 (H100,
// chip_smoke.py --compare-tree), as a rewrite around shared helpers did.
// LANES: lane blockIdx.y of a lane-axis launch (lane_args).
template <int PC, int PL, bool LANES = false>
__global__ void __launch_bounds__(WARPS * 32, (PL <= 8 ? 4 : 3))
select_kernel(const Args args) {
  const Args a = LANES ? lane_args(args, blockIdx.y) : args;
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
  const bool staged = K <= K_STAGE;
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


// ---- route 2 --------------------------------------------------------------

// Words of a staged slot row (one point's K slots), padded so that the
// block's stores (8 points x 4 slots a warp) read 32 distinct banks.
__host__ __device__ constexpr int pool_tile_ld(int K) { return (K + 31) / 32 * 32 + 4; }

// Dynamic shared memory of a route-2 block, per warp: the list (d2 bits
// [C], pool positions [C] as u16), the selected entries (d2 bits [K], list
// places [K] as u16) and the slot order (list places [K] as u16); then the
// staged [4][POOL_WARPS][tile_ld] output tile.
__host__ __device__ constexpr size_t pool_warp_bytes(int C, int K) {
  return ((size_t)C * 6 + (size_t)K * 8 + 15) / 16 * 16;
}
__host__ __device__ constexpr size_t pool_smem_bytes(int C, int K) {
  return POOL_WARPS * pool_warp_bytes(C, K) + (size_t)4 * POOL_WARPS * pool_tile_ld(K) * 4;
}

// PC: P at compile time (0: runtime P). Three blocks an SM (85 registers a
// thread) where shared memory allows.
template <int PC>
__global__ void __launch_bounds__(POOL_WARPS * 32, 3)
select_pool_kernel(const Args a) {
  __shared__ int s_kept[POOL_WARPS];
  extern __shared__ __align__(16) unsigned char smem[];

  const int P = PC > 0 ? PC : a.P;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * POOL_WARPS;
  const int n = n0 + warp;                   // this warp's source point
  const int K = a.K;
  const int C = a.C;
  const int ld = pool_tile_ld(K);
  const unsigned lt = (1u << lane) - 1u;
  unsigned char* wbase = smem + (size_t)warp * pool_warp_bytes(C, K);
  unsigned* s_d2 = reinterpret_cast<unsigned*>(wbase);                   // [C]
  unsigned* s_sd2 = s_d2 + C;                                            // [K]
  unsigned short* s_pos = reinterpret_cast<unsigned short*>(s_sd2 + K);  // [C]
  unsigned short* s_sel = s_pos + C;                                     // [K]
  unsigned short* s_ord = s_sel + K;                                     // [K]
  float* tile = reinterpret_cast<float*>(smem + POOL_WARPS * pool_warp_bytes(C, K));
  float* t_pt = tile + (size_t)warp * ld;    // tile [4][POOL_WARPS][ld]: idx bits, x, y, z
  const size_t comp = (size_t)POOL_WARPS * ld;

  if (n < a.N) {                             // whole warp
    const size_t P4 = 4 * (size_t)P;
    const int sentinel = a.gx * a.gy * a.gz;
    const float x0 = a.xr2[4 * (size_t)n], x1 = a.xr2[4 * (size_t)n + 1];
    const float x2 = a.xr2[4 * (size_t)n + 2], r2 = a.xr2[4 * (size_t)n + 3];
    // this lane's pool cell (lane o < n_off holds pool cell o, offsets in
    // dx, dy, dz order); the sentinel row past n_off and outside the grid
    int cell = sentinel;
    {
      const int oz = lane % a.nz, oy = (lane / a.nz) % a.ny, ox = lane / (a.nz * a.ny);
      const int cx = a.cbase[3 * (size_t)n] + (a.nx == 3 ? ox - 1 : 0);
      const int cy = a.cbase[3 * (size_t)n + 1] + (a.ny == 3 ? oy - 1 : 0);
      const int cz = a.cbase[3 * (size_t)n + 2] + (a.nz == 3 ? oz - 1 : 0);
      if (lane < a.nx * a.ny * a.nz && cx >= 0 && cx < a.gx && cy >= 0 && cy < a.gy &&
          cz >= 0 && cz < a.gz)
        cell = (cx * a.gy + cy) * a.gz + cz;
    }
    float R[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) R[i] = __ldg(a.pose + i);

    // gather: U rounds of one candidate a lane in flight; coordinates only
    // behind an index >= 0. r2 < 0 (a masked row) keeps nothing.
    int kept = 0;
    if (r2 >= 0.f) {
      for (int base = 0; base < C; base += 32 * POOL_ROUNDS) {
        float ci[POOL_ROUNDS];
        const float* row[POOL_ROUNDS];
        int pk[POOL_ROUNDS];
#pragma unroll
        for (int u = 0; u < POOL_ROUNDS; ++u) {
          const int c = base + 32 * u + lane;
          const int o = c / P;               // shifts at P = 32
          const int s = c - o * P;
          const int src = __shfl_sync(kFullMask, cell, o < 32 ? o : 31);
          const bool in = c < C && src != sentinel;
          row[u] = a.tab + (size_t)(in ? src : sentinel) * P4 + (in ? s : 0);
          ci[u] = in ? __ldg(row[u] + 3 * P) : -1.f;
          pk[u] = (o << POS_SHIFT) | s;
        }
        float cx[POOL_ROUNDS], cy[POOL_ROUNDS], cz[POOL_ROUNDS];
#pragma unroll
        for (int u = 0; u < POOL_ROUNDS; ++u) {
          cx[u] = cy[u] = cz[u] = 0.f;
          if (ci[u] >= 0.f) {
            cx[u] = __ldg(row[u]);
            cy[u] = __ldg(row[u] + P);
            cz[u] = __ldg(row[u] + 2 * P);
          }
        }
#pragma unroll
        for (int u = 0; u < POOL_ROUNDS; ++u) {
          const unsigned d = cand_bits(R, x0, x1, x2, r2, cx[u], cy[u], cz[u], ci[u]);
          const unsigned b = __ballot_sync(kFullMask, d != INF_BITS);
          if (d != INF_BITS) {
            const int e = kept + __popc(b & lt);
            s_d2[e] = d;
            s_pos[e] = (unsigned short)pk[u];
          }
          kept += __popc(b);
        }
      }
    }
    __syncwarp();

    // the E selected entries, in list order
    const int E = min(K, kept);
    if (kept <= K) {
      for (int e = lane; e < kept; e += 32) {
        s_sel[e] = (unsigned short)e;
        s_sd2[e] = s_d2[e];
      }
    } else {
      // T: the K-th smallest d2 bits, bit by bit from the top; `need`: how
      // many entries equal to T the first K take
      unsigned T = 0;
      int need = K;
      for (int bit = 31; bit >= 0; --bit) {
        const unsigned hi = bit == 31 ? 0u : ~0u << (bit + 1);
        unsigned c0 = 0;
        for (int e = lane; e < kept; e += 32) {
          const unsigned v = s_d2[e];
          c0 += (v & hi) == T && !((v >> bit) & 1u);
        }
        c0 = __reduce_add_sync(kFullMask, c0);
        if ((int)c0 < need) {
          need -= (int)c0;
          T |= 1u << bit;
        }
      }
      int taken = 0, eq_seen = 0;
      for (int base = 0; base < kept; base += 32) {
        const int e = base + lane;
        const unsigned v = e < kept ? s_d2[e] : ~0u;
        const bool eq = e < kept && v == T;
        const unsigned beq = __ballot_sync(kFullMask, eq);
        const bool take = e < kept && (v < T || (eq && eq_seen + __popc(beq & lt) < need));
        const unsigned bt = __ballot_sync(kFullMask, take);
        if (take) {
          const int q = taken + __popc(bt & lt);
          s_sel[q] = (unsigned short)e;
          s_sd2[q] = v;
        }
        eq_seen += __popc(beq);
        taken += __popc(bt);
      }
    }
    __syncwarp();
    // slot of selected entry j: the selected entries with a smaller d2, or
    // the same d2 and an earlier place in the list (a lower pool position)
    for (int j = lane; j < E; j += 32) {
      const unsigned vj = s_sd2[j];
      int rk = 0;
#pragma unroll 4
      for (int m = 0; m < E; ++m) {
        const unsigned vm = s_sd2[m];
        rk += vm < vj || (vm == vj && m < j);
      }
      s_ord[rk] = s_sel[j];
    }
    __syncwarp();

    // slot j's index and raw xyz, re-read from its table row, into the tile
    for (int j0 = 0; j0 < K; j0 += 32) {
      const int j = j0 + lane;
      const int pk = j < E ? s_pos[s_ord[j]] : 0;
      const int o = pk >> POS_SHIFT;
      const int src = __shfl_sync(kFullMask, cell, o);
      if (j < K) {
        int ci = -1;
        float yx = DEAD_COORD, yy = DEAD_COORD, yz = DEAD_COORD;
        if (j < E) {
          const float* row = a.tab + (size_t)src * P4 + (pk & ((1 << POS_SHIFT) - 1));
          ci = (int)__ldg(row + 3 * P);
          yx = __ldg(row);
          yy = __ldg(row + P);
          yz = __ldg(row + 2 * P);
        }
        t_pt[j] = __int_as_float(ci);
        t_pt[comp + j] = yx;
        t_pt[2 * comp + j] = yy;
        t_pt[3 * comp + j] = yz;
      }
    }
    if (lane == 0) s_kept[warp] = kept;
  }
  __syncthreads();

  // each slot row of the block's points as one run a component: a warp
  // writes 4 slot rows x 8 points, whole 32-B sectors
  const int p = threadIdx.x & (POOL_WARPS - 1);
  const int nn = n0 + p;
  if (nn < a.N) {
    const size_t plane = (size_t)K * a.N;
    for (int j = threadIdx.x / POOL_WARPS; j < K; j += POOL_WARPS * 32 / POOL_WARPS) {
      const size_t o = (size_t)j * a.N + nn;
      const size_t t = (size_t)p * ld + j;
      a.idx[o] = __float_as_int(tile[t]);
      a.y[o] = tile[comp + t];
      a.y[plane + o] = tile[2 * comp + t];
      a.y[2 * plane + o] = tile[3 * comp + t];
    }
    if (threadIdx.x < POOL_WARPS) a.kept[nn] = s_kept[p];
  }
}

template <typename Kernel>
int launch_with(Kernel kernel, dim3 blocks, int threads, size_t smem, const Args& a,
                cudaStream_t stream) {
  if (smem > 48 * 1024) {                    // large pools: opt in beyond 48 KB
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<blocks, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int PC, int PL, bool LANES = false>
int launch(const Args& a, cudaStream_t stream, int lanes = 1) {
  return launch_with(select_kernel<PC, PL, LANES>,
                     dim3((a.N + TILE_PTS - 1) / TILE_PTS, LANES ? lanes : 1), WARPS * 32,
                     list_bytes(a.C) + tile_bytes(a.K <= K_STAGE), a, stream);
}

// Route 1 for every pool size it takes.
template <bool LANES>
int launch_route1(const Args& a, cudaStream_t stream, int lanes) {
  if (a.C <= 32) return launch<P_FAST, 1, LANES>(a, stream, lanes);
  if (a.C <= 96) return launch<P_FAST, 3, LANES>(a, stream, lanes);
  return launch<P_FAST, 7, LANES>(a, stream, lanes);
}

template <int PC>
int launch_pool(const Args& a, cudaStream_t stream) {
  return launch_with(select_pool_kernel<PC>, (a.N + POOL_WARPS - 1) / POOL_WARPS,
                     POOL_WARPS * 32, pool_smem_bytes(a.C, a.K), a, stream);
}

}  // namespace

extern "C" {

// Largest pool (cells * P) a point may have.
int cvo_select_max_pool() { return 32 * 32; }

// tab [n_cells + 1, 4P] (x | y | z | index slots, -1 when empty; the
// sentinel row n_cells all -1), cbase [N, 3] int32 base cell, xr2 [N, 4]
// (xyz, squared radius or -1), pose [12] (R_inv row-major | T_inv) ->
// idx [K, N] int32 (-1 dead), y [3, K, N] raw target xyz (DEAD_COORD dead),
// kept [N] int32 in-support candidate count.
int cvo_select(const float* tab, const int* cbase, const float* xr2,
               const float* pose, int* idx, float* y, int* kept, int N,
               int K, int P, int gx, int gy, int gz, cudaStream_t stream) {
  if (N <= 0 || K <= 0 || P <= 0) return (int)cudaErrorInvalidValue;
  const int nx = gx > 1 ? 3 : 1, ny = gy > 1 ? 3 : 1, nz = gz > 1 ? 3 : 1;
  const int pool = nx * ny * nz * P;
  if (pool > cvo_select_max_pool()) return (int)cudaErrorInvalidValue;
  const Args a{tab, cbase, xr2, pose, idx, y, kept, N, K, P, gx, gy, gz, nx, ny, nz, pool};
  if (P == P_FAST && K <= K_STAGE)           // route 1: pools of 8, 24, 72 or 216
    return launch_route1<false>(a, stream, 1);
  if (P == 32) return launch_pool<32>(a, stream);  // the IRLS list
  return launch_pool<0>(a, stream);
}

// cvo_select for L lanes in one launch, route 1 only (P = 8, K <= 32):
// tab [L, n_cells + 1, 4P], cbase [L, N, 3], xr2 [L, N, 4], pose [L, 12]
// -> idx [L, K, N], y [L, 3, K, N], kept [L, N]; lane l's outputs are
// cvo_select's on lane l's inputs, bit for bit.
int cvo_select_lanes(const float* tab, const int* cbase, const float* xr2,
                     const float* pose, int* idx, float* y, int* kept, int L, int N,
                     int K, int P, int gx, int gy, int gz, cudaStream_t stream) {
  if (L <= 0 || L > 65535 || N <= 0 || K <= 0 || K > K_STAGE || P != P_FAST)
    return (int)cudaErrorInvalidValue;
  const int nx = gx > 1 ? 3 : 1, ny = gy > 1 ? 3 : 1, nz = gz > 1 ? 3 : 1;
  const int pool = nx * ny * nz * P;
  if (pool > cvo_select_max_pool()) return (int)cudaErrorInvalidValue;
  const Args a{tab, cbase, xr2, pose, idx, y, kept, N, K, P, gx, gy, gz, nx, ny, nz, pool};
  return launch_route1<true>(a, stream, L);
}

}  // extern "C"
