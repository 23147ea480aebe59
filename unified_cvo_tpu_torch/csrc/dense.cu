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
// 16384, tiles 128 x 512, ~1100-1700 active pairs) a pass looks at 75-114 M
// point pairs from under 3 MB of packed inputs. The design:
//
//   1. Equal work items in a fixed order. One item is one active tile pair
//      (per 128 source rows of it). A persistent grid of a few blocks per SM
//      walks the i-major compacted list: block b takes items b, b + G, ...
//      and stops at n, read from device memory, so the active count never
//      reaches the host. An item writes its partial to scratch indexed by
//      item (flow: [pair, 5, tile_i] rows of s, wy, cnt; step: [item, 4]),
//      and a second kernel sums each source tile's items in list order
//      (its range by binary search on pair_i), the step's items in index
//      order. The order of every sum is fixed by the list and not by
//      scheduling: no float atomics, reruns give identical bits, the count
//      stays an exact integer, and a tile with no active pair writes zero
//      rows (row_has in the JAX package).
//   2. Register tiles. A block is 32 row groups x 8 column groups; a thread
//      owns 4 source rows (ry, ry + 32, ...: spread over the tile, so that
//      a cluster of survivors lands on every warp and not on one), whose
//      coordinates it keeps in registers, and takes 4 staged target columns
//      at a time with one 16-byte shared load per packed row, each value
//      used for all 4 rows.
//   3. A conservative first look at the geometric gate. About one pair in
//      two hundred of the active tiles passes the per-pair gate d2 <
//      d2_thres. The thread therefore first forms d2 with fused
//      multiply-adds (7 operations a pair) and tests it against the
//      row's threshold widened by 1e-5 relative; the fused d2 differs from
//      the exactly rounded one by under 1e-6 relative (a sum of
//      non-negative terms), so every pair the exact gate passes is kept.
//      The survivors (a 16-bit mask per thread) go through the full, exact
//      evaluation below; everything else contributes exactly zero, as in
//      the plain version. Without geometry every pair takes the full
//      evaluation. Survivors are few and clustered, so a thread that
//      evaluated its own would idle its warp: each warp instead queues its
//      chunk's survivors in shared memory in (lane, bit) order, a fixed
//      order, its 32 lanes evaluate the queue side by side, and each thread
//      takes its own pairs' values back in its own order (flow), or each
//      lane keeps what it evaluated (step, where only the total matters).
//   4. The channel set is a template parameter: colour (F = 5), all
//      channels (F = 5, C = 19), geometry only, and a generic runtime set
//      inside the same kernel, chosen by the C entry point from `flags`.
//      Row offsets become constants and the channel dots unroll.
//   5. Exact gates, fused arithmetic elsewhere. The chain that decides a
//      gate (d2, the channel distances, the exponent argument, a) is
//      written with __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, which
//      are never contracted, in the operation order of
//      ops/dense.py::_a_tiles, with the accurate expf (no fast-math
//      intrinsic, no fast-math flag): nonzeros equal the plain version's
//      exactly. The
//      file is compiled WITHOUT -fmad=false, so the step tail and the
//      accumulations fuse.
//   6. Asynchronous staging. Target columns arrive 128 at a time through a
//      ring of two shared-memory stages filled by cp.async (16 bytes a
//      thread); the next chunk, of this item or the next, is in flight
//      while this one is evaluated.
//
// No tensor cores: the only products are the colour and semantic cross
// terms of depth F = 5 and C = 19, the gates need them as explicit f32 sums
// in a fixed order, and wgmma offers f32 inputs only as TF32.
//
// Lane axis (`cvo_dense_flow_lanes`, `cvo_dense_step_lanes`): B pairs in
// one call, the counterpart of both TPU kernels under the JAX package's
// jax.vmap of align (parallel/batch_align.py:51-55), where the batch becomes
// a grid axis. xp is [B, N, Dx], yp [B, Dy, M], each lane's compacted list
// [B, nI * nJ] as compact_tile_mask gives it for that lane alone, its count
// [B] and its offset in the joined walk [B] on the device. The persistent
// pass walks the lanes' lists laid end to end (LANES = true: an item finds
// its lane from the offsets, and reads that lane's rows, tiles and list),
// writing each item's partial where the unbatched launch of that lane
// writes it, in a scratch B times as large; the row, row-sum and step sums
// then run per lane (blockIdx.y or blockIdx.x the lane) in the same launches.
// So a call launches the device kernels one unbatched call does (flow 3,
// step 2) whatever B is, and every lane's outputs are the unbatched
// launch's bit for bit: the same items, summed in the same order. A lane
// with count 0 (a frozen one) gets zeros.
//
// Build-time switches for measurements (never set by the package):
// -DDENSE_PREFILTER=0 sends every pair through the full evaluation,
// -DDENSE_COMPACT=0 lets each thread evaluate its own survivors,
// -DDENSE_ASYNC=0 waits for each chunk before evaluating it.

#include <cuda_runtime.h>
#include <math.h>

#include "reduce.cuh"

#ifndef DENSE_PREFILTER
#define DENSE_PREFILTER 1
#endif
#ifndef DENSE_ASYNC
#define DENSE_ASYNC 1
#endif
#ifndef DENSE_COMPACT
#define DENSE_COMPACT 1
#endif

namespace {

constexpr int RB = 128;                  // source rows per work item
constexpr int TR = 4;                    // source rows per thread
constexpr int TC = 4;                    // target columns per thread and step
constexpr int CXN = 8;                   // column groups (threads) per row group
constexpr int ROWG = RB / TR;             // 32 row groups; a thread's rows are ROWG apart
constexpr int THREADS = ROWG * CXN;      // 256
constexpr int CH = 128;                  // target columns staged at a time
constexpr int STAGES = 2;                // shared-memory stages of the ring
constexpr int STEPS = CH / (TC * CXN);   // 4 steps of 4 columns a thread a chunk
constexpr int QUEUE = 512;               // survivors a warp queues: one step's most
static_assert(STEPS * TR * TC <= 64, "a chunk's first-look mask is 64 bits");
static_assert(QUEUE >= 32 * TR * TC, "a round of one step must fit the queue");
static_assert(RB <= 256 && CH <= 256, "a queue entry packs row and column in 8 bits each");
constexpr int MIN_BLOCKS = 3;            // blocks per SM the registers must allow
constexpr int FINAL_THREADS = 1024;
constexpr int GATHER_THREADS = 128;
constexpr int STEP_NV = 4;               // B, C, D, E
constexpr int FLOW_NV = 5;               // s, wy (3), cnt
constexpr float LOOSE = 1.00001f;        // widening of the first-look gate

// Runtime description of the packed layout (ops/dense.py::PackLayout): the
// generic channel set reads it, the fixed sets only Dx and Dy.
struct Layout {
  int Dx, Dy, F, C;
  int geometry, intensity, semantics, geo_type;
};

// Channel sets. A fixed set folds every flag, width and row offset to a
// constant; the generic one takes them from Layout at run time.
template <bool GEO, bool INT, bool SEM, bool GT, int F_, int C_>
struct FixedSet {
  static constexpr bool kFixed = true, kGeo = GEO, kInt = INT, kSem = SEM, kGt = GT;
  static constexpr int kF = F_, kC = C_;
};
struct GenericSet {
  static constexpr bool kFixed = false, kGeo = false, kInt = false, kSem = false,
                        kGt = false;
  static constexpr int kF = 0, kC = 0;
};
using ColourSet = FixedSet<true, true, false, false, 5, 0>;
using AllSet = FixedSet<true, true, true, true, 5, 19>;
using GeometrySet = FixedSet<true, false, false, false, 0, 0>;
enum { INST_COLOUR = 0, INST_ALL = 1, INST_GEOMETRY = 2, INST_GENERIC = 3 };

template <class CS>
struct Channels {
  int F, C;
  bool geo, in, se, gt;
  __device__ __forceinline__ explicit Channels(const Layout& L)
      : F(CS::kFixed ? CS::kF : L.F), C(CS::kFixed ? CS::kC : L.C),
        geo(CS::kFixed ? CS::kGeo : L.geometry != 0),
        in(CS::kFixed ? CS::kInt : L.intensity != 0),
        se(CS::kFixed ? CS::kSem : L.semantics != 0),
        gt(CS::kFixed ? CS::kGt : L.geo_type != 0) {}
};

// x columns and yT rows that do not depend on the channel widths.
enum { X_MASK = 3, X_TWOL2 = 4, X_D2THRES = 5, X_COEF = 6, X_FEAT = 7,
       Y_PAD = 3, Y_FEAT = 4 };

// Where each lane's arrays start (LANES; zeros and one lane otherwise).
struct Lanes {
  const int* off;       // [lanes] first entry of each lane in the joined walk
  int lanes;
  int pairs;            // tile pairs of a lane (nI * nJ): its list and scratch stride
  int nI;               // source tiles of a lane: its row_has stride
  long long x_stride;   // floats of one lane's xp (N * Dx)
  long long y_stride;   // floats of one lane's yp (Dy * M)
};

// Kernel constants, exact f32 values from ops/dense.py::_consts.
struct Consts {
  float sigma2, sp, c_sigma2, c_thres, c_neg_inv_two_ell2, s_sigma2, s_thres,
      s_neg_inv_two_ell2;
};

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// One kernel-matrix entry (_a_block semantics, pallas_kernels.py:265-342):
// the source row in slot xr of the staged item (column d at xs[d * RB + xr])
// against staged target column c (row k at ys[k * CH + c]). Every operation
// that feeds a gate rounds on its own, in the order of
// ops/dense.py::_a_tiles.
template <class CS>
__device__ __forceinline__ float a_exact(const Layout& L, const Consts& K,
                                         const float* xs, int xr, const float* ys,
                                         int c) {
  const Channels<CS> ch(L);
  const int FC = ch.F + ch.C;
#define XV(d) xs[(d) * RB + xr]
#define YV(k) ys[(k) * CH + c]
  bool ok = true, have = false;
  float a = 0.f;
  if (ch.gt) {
    const int xg = 9 + FC, yg = 6 + FC;
    const float dot = __fadd_rn(__fmul_rn(XV(xg), YV(yg)), __fmul_rn(XV(xg + 1), YV(yg + 1)));
    const float n2 = __fmul_rn(XV(xg + 2), YV(yg + 2));
    a = __fmul_rn(__fmul_rn(dot, dot), __fdiv_rn(1.f, fmaxf(n2, 1e-12f)));
    ok = a >= 0.01f;
    have = true;
  }
  if (ch.geo) {
    float d2 = YV(Y_PAD);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float e = __fsub_rn(XV(k), YV(k));
      d2 = __fadd_rn(d2, __fmul_rn(e, e));
    }
    ok = ok && (d2 < XV(X_D2THRES));
    const float kg = __fmul_rn(K.sigma2, expf(__fmul_rn(d2, XV(X_TWOL2))));
    a = have ? __fmul_rn(a, kg) : kg;
    have = true;
  }
  if (ch.in) {
    float cross = 0.f;
#pragma unroll
    for (int f = 0; f < ch.F; ++f)
      cross = __fadd_rn(cross, __fmul_rn(XV(X_FEAT + f), YV(Y_FEAT + f)));
    const float d2c = fmaxf(__fsub_rn(__fadd_rn(XV(7 + ch.F), YV(4 + ch.F)),
                                      __fmul_rn(2.f, cross)), 0.f);
    ok = ok && (d2c < K.c_thres);
    const float ck = __fmul_rn(K.c_sigma2, expf(__fmul_rn(d2c, K.c_neg_inv_two_ell2)));
    a = have ? __fmul_rn(a, ck) : ck;
    have = true;
  }
  if (ch.se) {
    const int xl = 8 + ch.F, yl = 5 + ch.F;
    float cross = 0.f;
#pragma unroll
    for (int q = 0; q < ch.C; ++q)
      cross = __fadd_rn(cross, __fmul_rn(XV(xl + q), YV(yl + q)));
    const float d2s = fmaxf(__fsub_rn(__fadd_rn(XV(8 + FC), YV(5 + FC)),
                                      __fmul_rn(2.f, cross)), 0.f);
    ok = ok && (d2s < K.s_thres);
    const float sk = __fmul_rn(K.s_sigma2, expf(__fmul_rn(d2s, K.s_neg_inv_two_ell2)));
    a = have ? __fmul_rn(a, sk) : sk;
    have = true;
  }
  if (!have)  // no active channel: only validity gates (a == 1)
    return (XV(X_MASK) > 0.f && YV(Y_PAD) == 0.f) ? 1.f : 0.f;
  return (ok && a > K.sp) ? a : 0.f;
#undef XV
#undef YV
}

// The step pass's terms of one pair with a != 0 (_step_tile,
// pallas_kernels.py:468-487, term by term; free to fuse).
template <class CS>
__device__ __forceinline__ void step_terms(const Layout& L, float a, const float* xs,
                                           int xr, const float* ys, int c,
                                           float (&acc)[STEP_NV]) {
  const Channels<CS> ch(L);
  const int y_xiz = 9 + ch.F + ch.C, y_scal = 21 + ch.F + ch.C;
  const float e0 = xs[0 * RB + xr] - ys[0 * CH + c];
  const float e1 = xs[1 * RB + xr] - ys[1 * CH + c];
  const float e2 = xs[2 * RB + xr] - ys[2 * CH + c];
  const float coef = xs[X_COEF * RB + xr];
  // (x_i - y_j) . xi{q+1}z_j from the packed twist rows
  float d[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int b = y_xiz + 3 * q;
    d[q] = e0 * ys[b * CH + c] + e1 * ys[(b + 1) * CH + c] + e2 * ys[(b + 2) * CH + c];
  }
  const float normxiz2 = ys[y_scal * CH + c];
  const float xdx2 = ys[(y_scal + 1) * CH + c];
  const float epsc = ys[(y_scal + 2) * CH + c];
  const float beta = -2.f * coef * d[0];
  const float gamma = -coef * (normxiz2 + 2.f * d[1]);
  const float delta = 2.f * coef * (xdx2 - d[2]);
  const float epsil = -coef * (epsc + 2.f * d[3]);
  const float b2 = beta * beta;
  acc[0] += a * beta;
  acc[1] += a * (gamma + 0.5f * b2);
  acc[2] += a * (delta + beta * gamma + b2 * beta / 6.f);
  acc[3] += a * (epsil + beta * delta + 0.5f * b2 * gamma + 0.5f * gamma * gamma
                 + b2 * b2 / 24.f);
}

// Adds a pair's value to its row's flow moments (r < TR, known only at run
// time: the adds are predicated so the sums stay in registers).
__device__ __forceinline__ void flow_add(float a, int r, const float* ys, int col,
                                         float (&fs)[TR], float (&fw)[TR][3],
                                         int (&fc)[TR]) {
  const float w0 = a * ys[0 * CH + col], w1 = a * ys[1 * CH + col],
              w2 = a * ys[2 * CH + col];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    if (i == r) {
      fs[i] += a;
      fw[i][0] += w0;
      fw[i][1] += w1;
      fw[i][2] += w2;
      fc[i] += 1;
    }
  }
}

// Staged column of bit `bit` of a thread's chunk mask: 16 bits a step, a
// step 32 columns on, 4 columns a thread.
__device__ __forceinline__ int pair_col(int cx, int bit) {
  return TC * cx + (bit >> 4) * (TC * CXN) + (bit & (TC - 1));
}

// Inclusive sum of v over the lanes up to this one.
__device__ __forceinline__ int warp_scan(int v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(cvo::kFullMask, v, off);
    if (lane >= off) v += up;
  }
  return v;
}

// Lane of joined entry e: the last lane whose offset is <= e (a lane of
// count 0 shares its offset with the next one and is never chosen).
__device__ __forceinline__ int lane_of(const int* __restrict__ off, int lanes, int e) {
  int lo = 0, hi = lanes;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (off[mid] <= e) lo = mid; else hi = mid;
  }
  return lo;
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

// Start the copy of chunk `chunk` of a target tile (its first column at
// `tile`, rows M apart) into stage `dst` ([Dy][CH]); the caller commits the
// group.
__device__ __forceinline__ void stage_chunk(const Layout& L, const float* __restrict__ tile,
                                            int M, int tile_j, int chunk, float* dst,
                                            int tid) {
  const int cols = min(CH, tile_j - chunk * CH);
  const float* src = tile + chunk * CH;
  if (cols == CH) {
    for (int t = tid; t < L.Dy * (CH / 4); t += THREADS) {
      const int k = t / (CH / 4), q = t % (CH / 4);
      cp_async16(dst + k * CH + 4 * q, src + (size_t)k * M + 4 * q);
    }
  } else {
    const int per_row = cols >> 2;
    for (int t = tid; t < L.Dy * per_row; t += THREADS) {
      const int k = t / per_row, q = t - k * per_row;
      cp_async16(dst + k * CH + 4 * q, src + (size_t)k * M + 4 * q);
    }
  }
}

// One pass over the active list. Item = pair * rbn + row block; `part` is
// [pairs, FLOW_NV, tile_i] (flow; the count as int bits) or [items,
// STEP_NV] (step). LANES: the lanes' lists end to end, `n_active` their
// total, every array one lane after another (`Lanes`).
template <bool STEP, class CS, bool LANES = false>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
dense_pass_kernel(Layout L, Consts K, const float* __restrict__ xp,
                  const float* __restrict__ yp, const int* __restrict__ pair_i,
                  const int* __restrict__ pair_j, const unsigned char* __restrict__ row_has,
                  const int* __restrict__ n_active, float* __restrict__ part,
                  int M, int tile_i, int tile_j, int rbn, Lanes ln) {
  extern __shared__ __align__(16) float smem[];
  const int stage_floats = L.Dy * CH;
  float* xs = smem + STAGES * stage_floats;  // [Dx][RB]
  __shared__ float red[STEP_NV * THREADS / 32];
#if DENSE_COMPACT
  __shared__ int warp_queues[(THREADS / 32) * QUEUE];
  int* queue = warp_queues + (threadIdx.x / 32) * QUEUE;
  const int lane = threadIdx.x % 32;
#endif
  const Channels<CS> chs(L);
  const bool prefilter = DENSE_PREFILTER && chs.geo;
  const int tid = threadIdx.x, ry = tid / CXN, cx = tid % CXN;
  const int n_items = *n_active * rbn;
  const int n_chunks = (tile_j + CH - 1) / CH;
  const int G = gridDim.x;
  int item = blockIdx.x;
  if (item >= n_items) return;
  // an item's entry: its place in its lane's list and scratch (the joined
  // entry itself without LANES), and its lane
  auto entry = [&](int it, int& pl) -> size_t {
    const int e = it / rbn;
    pl = LANES ? lane_of(ln.off, ln.lanes, e) : 0;
    return LANES ? (size_t)pl * ln.pairs + (e - ln.off[pl]) : (size_t)e;
  };
  auto target_tile = [&](int it) {
    int pl;
    const size_t q = entry(it, pl);
    return yp + (LANES ? pl * ln.y_stride : 0) + (size_t)pair_j[q] * tile_j;
  };

  if (DENSE_ASYNC) {
    stage_chunk(L, target_tile(item), M, tile_j, 0, smem, tid);
    cp_async_commit();
  }
  int seq = 0;
  for (; item < n_items; item += G) {
    int pl;                                  // the item's pair lane
    const size_t p = entry(item, pl);
    const int rb = item - (item / rbn) * rbn;
    const int tile = pair_i[p];
    const int rows = min(RB, tile_i - rb * RB);
    const bool mine = row_has[(LANES ? (size_t)pl * ln.nI : 0) + tile] != 0;
    const float* ytile = target_tile(item);
    // a thread's rows are ry, ry + 32, ...: whatever part of the tile holds
    // the survivors, every warp gets its share. Row r is in the tile for
    // r < rows / 32 (rows is a multiple of 32).
    const int live_rows = rows / ROWG;
    {  // the item's source rows, transposed, a thread's 4 rows side by side:
       // row r of the item sits in slot 4 (r % 32) + r / 32 (every thread is
       // past the previous item: its last chunk ended with a barrier)
      const float* src = xp + (LANES ? pl * ln.x_stride : 0) +
                         ((size_t)tile * tile_i + (size_t)rb * RB) * L.Dx;
      for (int t = tid; t < rows * L.Dx; t += THREADS) {
        const int r = t / L.Dx, d = t - r * L.Dx;
        xs[d * RB + TR * (r % ROWG) + r / ROWG] = src[t];
      }
    }
    float x0[TR], x1[TR], x2[TR], loose[TR];
    float acc[STEP_NV] = {0.f, 0.f, 0.f, 0.f};
    float fs[TR], fw[TR][3];
    int fc[TR];
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      fs[r] = fw[r][0] = fw[r][1] = fw[r][2] = 0.f;
      fc[r] = 0;
    }

    for (int chunk = 0; chunk < n_chunks; ++chunk, ++seq) {
      float* ys = smem + (seq % STAGES) * stage_floats;
      if (DENSE_ASYNC) {
        float* nxt = smem + ((seq + 1) % STAGES) * stage_floats;
        if (chunk + 1 < n_chunks)
          stage_chunk(L, ytile, M, tile_j, chunk + 1, nxt, tid);
        else if (item + G < n_items)
          stage_chunk(L, target_tile(item + G), M, tile_j, 0, nxt, tid);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        stage_chunk(L, ytile, M, tile_j, chunk, ys, tid);
        cp_async_commit();
        cp_async_wait<0>();
      }
      __syncthreads();
      if (chunk == 0 && prefilter && mine) {
        const float4 a0 = *reinterpret_cast<const float4*>(xs + 0 * RB + TR * ry);
        const float4 a1 = *reinterpret_cast<const float4*>(xs + 1 * RB + TR * ry);
        const float4 a2 = *reinterpret_cast<const float4*>(xs + 2 * RB + TR * ry);
        const float4 th = *reinterpret_cast<const float4*>(xs + X_D2THRES * RB + TR * ry);
        x0[0] = a0.x; x0[1] = a0.y; x0[2] = a0.z; x0[3] = a0.w;
        x1[0] = a1.x; x1[1] = a1.y; x1[2] = a1.z; x1[3] = a1.w;
        x2[0] = a2.x; x2[1] = a2.y; x2[2] = a2.z; x2[3] = a2.w;
        // a masked row's threshold is -1 and stays below every d2, as does
        // that of a row outside the tile
        const float thr[TR] = {th.x, th.y, th.z, th.w};
#pragma unroll
        for (int r = 0; r < TR; ++r) loose[r] = r < live_rows ? thr[r] * LOOSE : -1.f;
      }
      if (mine) {
        const int cols = min(CH, tile_j - chunk * CH);
        // first look: 16 bits per step of 4 rows x 4 columns, 4 steps a chunk
        unsigned long long mask = 0ull;
        int stp = 0;
        for (int c = TC * cx; c < cols; c += TC * CXN, ++stp) {
          unsigned m16 = 0xffffu >> (TC * (TR - live_rows));
          if (prefilter) {
            const float4 v0 = *reinterpret_cast<const float4*>(ys + 0 * CH + c);
            const float4 v1 = *reinterpret_cast<const float4*>(ys + 1 * CH + c);
            const float4 v2 = *reinterpret_cast<const float4*>(ys + 2 * CH + c);
            const float4 vp = *reinterpret_cast<const float4*>(ys + Y_PAD * CH + c);
            const float y0[TC] = {v0.x, v0.y, v0.z, v0.w};
            const float y1[TC] = {v1.x, v1.y, v1.z, v1.w};
            const float y2[TC] = {v2.x, v2.y, v2.z, v2.w};
            const float yq[TC] = {vp.x, vp.y, vp.z, vp.w};
            m16 = 0u;
#pragma unroll
            for (int r = 0; r < TR; ++r) {
#pragma unroll
              for (int j = 0; j < TC; ++j) {
                const float e0 = x0[r] - y0[j], e1 = x1[r] - y1[j], e2 = x2[r] - y2[j];
                const float d2 = fmaf(e2, e2, fmaf(e1, e1, fmaf(e0, e0, yq[j])));
                if (d2 < loose[r]) m16 |= 1u << (r * TC + j);
              }
            }
          }
          mask |= (unsigned long long)m16 << (16 * stp);
        }
#if DENSE_COMPACT
        // The warp's survivors go into its queue in (lane, bit) order and
        // are evaluated 32 at a time, whichever thread found them; when
        // more than the queue holds survive, one step (at most 512) a round.
        int incl = warp_scan(__popcll(mask), lane);
        const int total = __shfl_sync(cvo::kFullMask, incl, 31);
        const int rounds = total == 0 ? 0 : (total <= QUEUE ? 1 : STEPS);
        for (int rd = 0; rd < rounds; ++rd) {
          unsigned long long m = mask;
          int n_round = total;
          if (rounds > 1) {
            m = mask & (0xffffull << (16 * rd));
            incl = warp_scan(__popcll(m), lane);
            n_round = __shfl_sync(cvo::kFullMask, incl, 31);
          }
          const int first = incl - __popcll(m);
          int pos = first;
          for (unsigned long long t = m; t; t &= t - 1) {
            const int bit = __ffsll((long long)t) - 1;
            queue[pos++] = ((TR * ry + (bit & 15) / TC) << 8) | pair_col(cx, bit);
          }
          __syncwarp();
          for (int k = lane; k < n_round; k += 32) {
            const int e = queue[k];
            const float a = a_exact<CS>(L, K, xs, e >> 8, ys, e & 255);
            if (STEP) {
              if (a != 0.f) step_terms<CS>(L, a, xs, e >> 8, ys, e & 255, acc);
            } else {
              queue[k] = __float_as_int(a);
            }
          }
          __syncwarp();
          if (!STEP) {  // each thread takes its own pairs' values back, in order
            pos = first;
            for (unsigned long long t = m; t; t &= t - 1) {
              const int bit = __ffsll((long long)t) - 1;
              const float a = __int_as_float(queue[pos++]);
              if (a != 0.f) flow_add(a, (bit & 15) / TC, ys, pair_col(cx, bit), fs, fw, fc);
            }
            __syncwarp();
          }
        }
#else
        for (unsigned long long t = mask; t; t &= t - 1) {  // ascending bits
          const int bit = __ffsll((long long)t) - 1;
          const int r = (bit & 15) / TC, xr = TR * ry + r, col = pair_col(cx, bit);
          const float a = a_exact<CS>(L, K, xs, xr, ys, col);
          if (a == 0.f) continue;
          if (STEP) step_terms<CS>(L, a, xs, xr, ys, col, acc);
          else flow_add(a, r, ys, col, fs, fw, fc);
        }
#endif
      }
      __syncthreads();  // the stage and xs are free again
    }

    if (STEP) {
      cvo::block_sum<float, STEP_NV>(acc, red, tid, THREADS);
      if (tid == 0) {
#pragma unroll
        for (int i = 0; i < STEP_NV; ++i) part[(p * rbn + rb) * STEP_NV + i] = acc[i];
      }
    } else {
      // the 8 column groups of a row group are 8 neighbouring lanes
#pragma unroll
      for (int off = 1; off < CXN; off <<= 1) {
#pragma unroll
        for (int r = 0; r < TR; ++r) {
          fs[r] += __shfl_xor_sync(cvo::kFullMask, fs[r], off);
          fw[r][0] += __shfl_xor_sync(cvo::kFullMask, fw[r][0], off);
          fw[r][1] += __shfl_xor_sync(cvo::kFullMask, fw[r][1], off);
          fw[r][2] += __shfl_xor_sync(cvo::kFullMask, fw[r][2], off);
          fc[r] += __shfl_xor_sync(cvo::kFullMask, fc[r], off);
        }
      }
      if (cx == 0) {
        float* dst = part + p * FLOW_NV * tile_i + rb * RB + ry;
#pragma unroll
        for (int r = 0; r < TR; ++r) {
          if (r < live_rows) {
            float* row = dst + ROWG * r;
            row[0] = fs[r];
#pragma unroll
            for (int k = 0; k < 3; ++k) row[(size_t)(1 + k) * tile_i] = fw[r][k];
            row[(size_t)4 * tile_i] = __int_as_float(fc[r]);
          }
        }
      }
    }
  }
  if (DENSE_ASYNC) cp_async_wait<0>();
}

// Rows of the flow pass: each source row sums its tile's pair partials in
// list order; a tile with no active pair writes zeros. Lane blockIdx.y:
// its list, scratch and outputs `pairs`, `pairs`, N rows on (one lane
// without a lane axis).
__global__ void __launch_bounds__(GATHER_THREADS)
flow_gather_kernel(const float* __restrict__ part, const int* __restrict__ pair_i,
                   const unsigned char* __restrict__ row_has,
                   const int* __restrict__ n_active, float* __restrict__ s_out,
                   float* __restrict__ wy_out, int* __restrict__ cnt_out, int N,
                   int tile_i, int pairs) {
  const int row = blockIdx.x * GATHER_THREADS + threadIdx.x;
  if (row >= N) return;
  const size_t lane = blockIdx.y;
  part += lane * pairs * FLOW_NV * tile_i;
  pair_i += lane * pairs;
  row_has += lane * (N / tile_i);
  s_out += lane * N;
  wy_out += lane * 3 * N;
  cnt_out += lane * N;
  const int tile = row / tile_i, rl = row - tile * tile_i;
  int lo = 0, hi = 0;
  if (row_has[tile]) {
    const int n = n_active[lane];
    lo = lower_bound(pair_i, n, tile);
    hi = lower_bound(pair_i, n, tile + 1);
  }
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  int cnt = 0;
  for (int p = lo; p < hi; ++p) {
    const float* src = part + (size_t)p * FLOW_NV * tile_i + rl;
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] += src[(size_t)i * tile_i];
    cnt += __float_as_int(src[(size_t)4 * tile_i]);
  }
  s_out[row] = v[0];
  wy_out[row * 3 + 0] = v[1];
  wy_out[row * 3 + 1] = v[2];
  wy_out[row * 3 + 2] = v[3];
  cnt_out[row] = cnt;
}

// a_sum = sum of the row sums, nonzeros = sum of the row counts; lane
// blockIdx.x.
__global__ void __launch_bounds__(FINAL_THREADS)
row_sum_kernel(const float* __restrict__ s, const int* __restrict__ cnt, int N,
               float* __restrict__ out_sum, int* __restrict__ out_nz) {
  __shared__ float red[FINAL_THREADS / 32];
  __shared__ int red_cnt[FINAL_THREADS / 32];
  const int tid = threadIdx.x;
  const size_t lane = blockIdx.x;
  s += lane * N;
  cnt += lane * N;
  out_sum += lane;
  out_nz += lane;
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

// B..E = sum of the first n * rbn item partials, in index order; lane
// blockIdx.x, its partials pairs * rbn items on.
__global__ void __launch_bounds__(FINAL_THREADS)
step_sum_kernel(const float* __restrict__ part, const int* __restrict__ n_active,
                int rbn, int pairs, float* __restrict__ out) {
  __shared__ float red[STEP_NV * FINAL_THREADS / 32];
  const int tid = threadIdx.x;
  const size_t lane = blockIdx.x;
  part += lane * pairs * rbn * STEP_NV;
  out += lane * STEP_NV;
  const int n_items = n_active[lane] * rbn;
  float acc[STEP_NV] = {0.f, 0.f, 0.f, 0.f};
  for (int b = tid; b < n_items; b += FINAL_THREADS) {
#pragma unroll
    for (int i = 0; i < STEP_NV; ++i) acc[i] += part[(size_t)b * STEP_NV + i];
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
  L.Dx = 12 + L.F + L.C;
  L.Dy = Dy;
  return L;
}

// The channel set's instantiation (ops/dense.py::kernel_instance says the
// same in Python).
int instance_of(const int* f) {
  const int F = f[0], C = f[1];
  const bool geo = f[2], in = f[3], se = f[4], gt = f[5];
  if (geo && in && !se && !gt && F == 5 && C == 0) return INST_COLOUR;
  if (geo && in && se && gt && F == 5 && C == 19) return INST_ALL;
  if (geo && !in && !se && !gt && F == 0 && C == 0) return INST_GEOMETRY;
  return INST_GENERIC;
}

Consts make_consts(const float* k) {
  return Consts{k[0], k[1], k[2], k[3], k[4], k[5], k[6], k[7]};
}

using PassKernel = void (*)(Layout, Consts, const float*, const float*, const int*,
                            const int*, const unsigned char*, const int*, float*, int,
                            int, int, int, Lanes);

template <bool STEP, bool LANES>
PassKernel pass_kernel(int inst) {
  switch (inst) {
    case INST_COLOUR: return dense_pass_kernel<STEP, ColourSet, LANES>;
    case INST_ALL: return dense_pass_kernel<STEP, AllSet, LANES>;
    case INST_GEOMETRY: return dense_pass_kernel<STEP, GeometrySet, LANES>;
    default: return dense_pass_kernel<STEP, GenericSet, LANES>;
  }
}

bool bad_shapes(int N, int M, int tile_i, int tile_j) {
  return N <= 0 || tile_i <= 0 || tile_j <= 0 || N % tile_i || M % tile_j ||
         tile_i % 32 || tile_j % 4;
}

int row_blocks(int tile_i) { return (tile_i + RB - 1) / RB; }

// Launch one pass on a persistent grid: as many blocks as stay resident
// (shared memory opted in above the default 48 KB), at most one per item of
// every lane's whole list. `n_active`: the count (LANES: the lanes' total).
template <bool STEP, bool LANES = false>
cudaError_t launch_pass(const int* flags, const float* consts, const float* xp,
                        const float* yp, const int* pair_i, const int* pair_j,
                        const unsigned char* row_has, const int* n_active, float* part,
                        int N, int M, int tile_i, int tile_j, cudaStream_t stream,
                        const int* lane_off = nullptr, int lanes = 1) {
  const Layout L = make_layout(flags, (STEP ? 24 : 9) + flags[0] + flags[1]);
  const int inst = instance_of(flags);
  const PassKernel kernel = pass_kernel<STEP, LANES>(inst);
  const size_t smem = (size_t)(STAGES * L.Dy * CH + L.Dx * RB) * sizeof(float);
  // resident blocks per kernel and shared-memory size, found once
  static size_t known_smem[4] = {0, 0, 0, 0};
  static int known_grid[4] = {0, 0, 0, 0};
  if (known_smem[inst] != smem) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
        cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                             smem)) != cudaSuccess)
      return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    known_smem[inst] = smem;
    known_grid[inst] = sms * per_sm;
  }
  const int rbn = row_blocks(tile_i);
  const int pairs = (N / tile_i) * (M / tile_j);
  const long long items = (long long)lanes * pairs * rbn;
  const int grid = (int)(items < known_grid[inst] ? items : known_grid[inst]);
  const Lanes ln{lane_off, lanes, pairs, N / tile_i, (long long)N * L.Dx,
                 (long long)L.Dy * M};
  kernel<<<grid, THREADS, smem, stream>>>(L, make_consts(consts), xp, yp, pair_i, pair_j,
                                          row_has, n_active, part, M, tile_i, tile_j, rbn, ln);
  return cudaGetLastError();
}

// The flow pass's row and total sums, one lane a block row / block.
cudaError_t flow_sums(const float* part, const int* pair_i, const unsigned char* row_has,
                      const int* n_lane, float* s, float* wy, int* cnt, float* out_sum,
                      int* out_nz, int lanes, int N, int M, int tile_i, int tile_j,
                      cudaStream_t stream) {
  flow_gather_kernel<<<dim3((N + GATHER_THREADS - 1) / GATHER_THREADS, lanes), GATHER_THREADS,
                       0, stream>>>(part, pair_i, row_has, n_lane, s, wy, cnt, N, tile_i,
                                    (N / tile_i) * (M / tile_j));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  row_sum_kernel<<<lanes, FINAL_THREADS, 0, stream>>>(s, cnt, N, out_sum, out_nz);
  return cudaGetLastError();
}

cudaError_t step_sums(const float* part, const int* n_lane, float* out, int lanes, int N,
                      int M, int tile_i, int tile_j, cudaStream_t stream) {
  step_sum_kernel<<<lanes, FINAL_THREADS, 0, stream>>>(part, n_lane, row_blocks(tile_i),
                                                       (N / tile_i) * (M / tile_j), out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Index of the channel set's instantiation: 0 colour, 1 all channels,
// 2 geometry only, 3 generic.
int cvo_dense_instance(const int* flags) { return instance_of(flags); }

// 1 when built with the first look at the geometric gate (the package's
// build), 0 in a measurement build that evaluates every pair in full.
int cvo_dense_prefilter(void) { return DENSE_PREFILTER; }

// xp [N, Dx], yp [9 + F + C, M], pair_i / pair_j [nI * nJ] int32, row_has
// [nI] bool, n_active [1] int32, part [nI * nJ, 5, tile_i] scratch -> s [N],
// wy [N, 3] (centred), cnt [N] int32, out_sum [1] = a_sum, out_nz [1] =
// nonzeros.
int cvo_dense_flow(const int* flags, const float* consts, const float* xp,
                   const float* yp, const int* pair_i, const int* pair_j,
                   const unsigned char* row_has, const int* n_active, float* part,
                   float* s, float* wy, int* cnt, float* out_sum, int* out_nz, int N,
                   int M, int tile_i, int tile_j, cudaStream_t stream) {
  if (bad_shapes(N, M, tile_i, tile_j)) return (int)cudaErrorInvalidValue;
  const cudaError_t err = launch_pass<false>(flags, consts, xp, yp, pair_i, pair_j, row_has,
                                             n_active, part, N, M, tile_i, tile_j, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)flow_sums(part, pair_i, row_has, n_active, s, wy, cnt, out_sum, out_nz, 1, N,
                        M, tile_i, tile_j, stream);
}

// As cvo_dense_flow with yp [24 + F + C, M] (twist rows appended);
// part [nI * nJ * row blocks, 4] is scratch; out [4] = (B, C, D, E).
int cvo_dense_step(const int* flags, const float* consts, const float* xp,
                   const float* yp, const int* pair_i, const int* pair_j,
                   const unsigned char* row_has, const int* n_active, float* part,
                   float* out, int N, int M, int tile_i, int tile_j,
                   cudaStream_t stream) {
  if (bad_shapes(N, M, tile_i, tile_j)) return (int)cudaErrorInvalidValue;
  const cudaError_t err = launch_pass<true>(flags, consts, xp, yp, pair_i, pair_j, row_has,
                                            n_active, part, N, M, tile_i, tile_j, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)step_sums(part, n_active, out, 1, N, M, tile_i, tile_j, stream);
}

// cvo_dense_flow for B lanes: xp [B, N, Dx], yp [B, 9 + F + C, M], pair_i
// / pair_j [B, nI * nJ] (each lane's list as compact_tile_mask gives it),
// row_has [B, nI], n_lane [B] (0: the lane gets zeros), lane_off [B] (the
// exclusive prefix sum of n_lane), n_total [1] (their sum), part [B * nI *
// nJ, 5, tile_i] scratch -> s [B, N], wy [B, N, 3], cnt [B, N], out_sum
// [B], out_nz [B]; three device kernels, as cvo_dense_flow.
int cvo_dense_flow_lanes(const int* flags, const float* consts, const float* xp,
                         const float* yp, const int* pair_i, const int* pair_j,
                         const unsigned char* row_has, const int* n_lane,
                         const int* lane_off, const int* n_total, float* part, float* s,
                         float* wy, int* cnt, float* out_sum, int* out_nz, int B, int N,
                         int M, int tile_i, int tile_j, cudaStream_t stream) {
  if (B <= 0 || B > 65535 || bad_shapes(N, M, tile_i, tile_j)) return (int)cudaErrorInvalidValue;
  const cudaError_t err = launch_pass<false, true>(flags, consts, xp, yp, pair_i, pair_j,
                                                   row_has, n_total, part, N, M, tile_i,
                                                   tile_j, stream, lane_off, B);
  if (err != cudaSuccess) return (int)err;
  return (int)flow_sums(part, pair_i, row_has, n_lane, s, wy, cnt, out_sum, out_nz, B, N, M,
                        tile_i, tile_j, stream);
}

// cvo_dense_step for B lanes, inputs as cvo_dense_flow_lanes with yp [B, 24
// + F + C, M]; part [B * nI * nJ * row blocks, 4] scratch -> out [B, 4];
// two device kernels, as cvo_dense_step.
int cvo_dense_step_lanes(const int* flags, const float* consts, const float* xp,
                         const float* yp, const int* pair_i, const int* pair_j,
                         const unsigned char* row_has, const int* n_lane,
                         const int* lane_off, const int* n_total, float* part, float* out,
                         int B, int N, int M, int tile_i, int tile_j, cudaStream_t stream) {
  if (B <= 0 || B > 65535 || bad_shapes(N, M, tile_i, tile_j)) return (int)cudaErrorInvalidValue;
  const cudaError_t err = launch_pass<true, true>(flags, consts, xp, yp, pair_i, pair_j,
                                                  row_has, n_total, part, N, M, tile_i, tile_j,
                                                  stream, lane_off, B);
  if (err != cudaSuccess) return (int)err;
  return (int)step_sums(part, n_lane, out, B, N, M, tile_i, tile_j, stream);
}

}  // extern "C"
