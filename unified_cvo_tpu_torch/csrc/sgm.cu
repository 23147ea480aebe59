// The SGM recurrence of the port's disparity paths, written for Hopper
// (sm_90a): ops/sgm.py::_sgm_scan on a CUDA tensor. No Pallas kernel stands
// behind it: it replaces the JAX package's `lax.scan` over the scan steps
// (unified_cvo_tpu/ops/sgm.py:154, `_sgm_scan` :98), which XLA runs as one
// loop on the device. As torch ops the recurrence was ~13-15 launches a
// step from a Python loop, W + H steps a frame. Three callers run it: the
// horizontal pair and the vertical / diagonal four of ops/sgm.py::
// _aggregate (native census-SGM and the device frontends), and StereoSGBM's
// `top` and `across` paths (ops/sgbm_opencv.py::_path_sums).
//
// costs [S, G, L, D] int32: S steps of G members over L lines. A chain is
// the sequence of cells one state runs through: a line (g, l) of an
// unshifted member, and for the last n_shift members (the diagonals, whose
// state moves one line along L a step) the diagonal (s, l0 + s), starting
// at every (0, l) and at every (s >= 1, 0), where the state is Lp = INF,
// minprev = 0 (the plain version's `_shift_lines` fill). Per step
//   Lc = cost + min(Lp[d], min(Lp[d-1], Lp[d+1]) + P1, minprev + P2) - minprev
// with INF past both ends of D, then min(Lc, cap), then Lc = cost where the
// line has no in-step predecessor (has_prev [G, L], from step 1); step 0 is
// the cost itself. Everything is int32 adds and minimums, so the output is
// the plain version's exactly.
//
// Design: one warp a chain, the step loop inside the kernel. D lies in the
// lanes, V = D / 32 rounded up to a power of two contiguous values a lane
// in registers (D 128: 4, one 16-byte load and store a lane a step, 512
// contiguous bytes a warp); Lp[d +- 1] across a lane's edge comes by one
// __shfl_up_sync and one __shfl_down_sync, minprev by __reduce_min_sync.
// The only serial dependence is that arithmetic: the costs of a chain are
// known in advance, so the warp keeps the next U steps' costs (U V = 32
// ints a lane) in flight in a register double buffer while it runs the
// current U, and the has_prev flags of U steps come in one load a lane and
// one ballot.
//
// What bounds it on this card: the bytes, each cost read once and each Lc
// written once, 2 S G L D 4 B (a 1241 x 376 frame at D 128: the horizontal
// pair 955.6 MB, 0.285 ms at 3.35 TB/s; the vertical four 1911.3 MB, 0.571
// ms), unless a chain's S serial steps take longer: the horizontal scan
// has only 2 x 376 chains of 1241 steps. PERF.md gives both bounds and the
// measured times (chip_smoke.py phase 15s).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int INF = 1 << 28;         // ops/sgm.py's INF
constexpr int WARPS = 2;             // chains a block
constexpr int BUF_INTS = 32;         // costs a lane holds in flight a buffer: U steps x V
constexpr int MAX_D = 32 * 32;

struct Chain {
  long long base;                    // element offset of the chain's first cell
  long long stride;                  // elements from one step's cell to the next
  int n;                             // steps
  int g, l0, dl;                     // member, first line, line step (0 or 1)
  bool raw0;                         // the chain starts at step 0: its first Lc is the cost
};

// Chains (G - n_shift) L lines first, then for each shifted member its L + S
// - 1 diagonals: (0, j) for j < L, then (j - L + 1, 0).
__device__ __forceinline__ Chain chain_of(int c, int S, int G, int L, int D, int n_shift) {
  const int lines = (G - n_shift) * L;
  Chain ch;
  int s0 = 0;
  if (c < lines) {
    ch.g = c / L;
    ch.l0 = c % L;
    ch.n = S;
    ch.dl = 0;
  } else {
    const int per = L + S - 1, j = (c - lines) % per;
    ch.g = G - n_shift + (c - lines) / per;
    ch.dl = 1;
    if (j < L) {
      ch.l0 = j;
      ch.n = min(S, L - j);
    } else {
      s0 = j - L + 1;
      ch.l0 = 0;
      ch.n = min(S - s0, L);
    }
  }
  ch.raw0 = s0 == 0;
  ch.base = (((long long)s0 * G + ch.g) * L + ch.l0) * D;
  ch.stride = ((long long)G * L + ch.dl) * D;
  return ch;
}

// A lane's V values of one row at p (d0 = lane V): 16-byte loads where the
// row is aligned for them (VEC), else one value at a time; 0 past D.
template <int V, bool VEC>
__device__ __forceinline__ void load_row(const int* __restrict__ p, int d0, int D, int (&c)[V]) {
  if (VEC && V >= 4) {
    if (d0 < D) {
#pragma unroll
      for (int k = 0; k < V; k += 4) {
        const int4 q = __ldcs(reinterpret_cast<const int4*>(p + d0 + k));
        c[k] = q.x;
        c[k + 1] = q.y;
        c[k + 2] = q.z;
        c[k + 3] = q.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) c[k] = 0;
    }
  } else if (VEC && V == 2) {
    const int2 q = d0 < D ? __ldcs(reinterpret_cast<const int2*>(p + d0)) : make_int2(0, 0);
    c[0] = q.x;
    c[1] = q.y;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) c[k] = d0 + k < D ? __ldcs(p + d0 + k) : 0;
  }
}

template <int V, bool VEC>
__device__ __forceinline__ void store_row(int* __restrict__ p, int d0, int D, const int (&v)[V]) {
  if (VEC && V >= 4) {
    if (d0 < D) {
#pragma unroll
      for (int k = 0; k < V; k += 4)
        __stcs(reinterpret_cast<int4*>(p + d0 + k), make_int4(v[k], v[k + 1], v[k + 2], v[k + 3]));
    }
  } else if (VEC && V == 2) {
    if (d0 < D) __stcs(reinterpret_cast<int2*>(p + d0), make_int2(v[0], v[1]));
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (d0 + k < D) __stcs(p + d0 + k, v[k]);
  }
}

// U steps' costs of a chain and, in lane u, the has_prev flag of step u.
template <int V, int U>
struct Block {
  int c[U][V];
  int ok;
};

template <int V, int U, bool VEC>
__device__ __forceinline__ void load_block(Block<V, U>& b, const int* __restrict__ costs,
                                           const uint8_t* __restrict__ hp, const Chain& ch,
                                           int kb, int lane, int d0, int D) {
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (kb + u < ch.n) load_row<V, VEC>(costs + ch.base + (long long)(kb + u) * ch.stride, d0, D,
                                        b.c[u]);
  const int k = kb + lane;
  b.ok = hp != nullptr && lane < U && k < ch.n ? __ldg(hp + k * ch.dl) : 1;
}

// One step of the recurrence on a lane's V values; lp becomes Lc (INF past
// D), minprev its minimum over D.
template <int V>
__device__ __forceinline__ void step(const int (&c)[V], int (&lp)[V], int& minprev, bool raw,
                                     bool ok, int lane, int d0, int D, int p1, int p2, int cap) {
  int left = __shfl_up_sync(FULL, lp[V - 1], 1);
  int right = __shfl_down_sync(FULL, lp[0], 1);
  if (lane == 0) left = INF;
  if (lane == 31) right = INF;
  const int mp2 = minprev + p2;
  int lc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int lo = k == 0 ? left : lp[k - 1];
    const int hi = k == V - 1 ? right : lp[k + 1];
    const int best = min(lp[k], min(min(lo, hi) + p1, mp2));
    const int v = min(c[k] + best - minprev, cap);
    lc[k] = raw || !ok ? c[k] : v;
  }
  int mn = INT_MAX;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const bool in = d0 + k < D;
    mn = in ? min(mn, lc[k]) : mn;
    lp[k] = in ? lc[k] : INF;
  }
  minprev = __reduce_min_sync(FULL, mn);
}

template <int V, int U, bool VEC>
__device__ __forceinline__ void run_block(const Block<V, U>& b, int* __restrict__ out,
                                          const Chain& ch, int kb, int (&lp)[V], int& minprev,
                                          int lane, int d0, int D, int p1, int p2, int cap) {
  const unsigned okm = __ballot_sync(FULL, b.ok != 0);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int k = kb + u;
    if (k < ch.n) {
      step<V>(b.c[u], lp, minprev, k == 0 && ch.raw0, (okm >> u) & 1u, lane, d0, D, p1, p2, cap);
      store_row<V, VEC>(out + ch.base + (long long)k * ch.stride, d0, D, lp);
    }
  }
}

// One warp a chain; the chain's steps in blocks of U, the next block loading
// while the current one runs.
template <int V, bool VEC>
__global__ void __launch_bounds__(32 * WARPS)
    sgm_scan_kernel(const int* __restrict__ costs, int* __restrict__ out,
                    const uint8_t* __restrict__ has_prev, int S, int G, int L, int D,
                    int n_shift, int n_chains, int p1, int p2, int cap) {
  constexpr int U = BUF_INTS / V > 0 ? BUF_INTS / V : 1;
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (c >= n_chains) return;                       // the whole warp
  const Chain ch = chain_of(c, S, G, L, D, n_shift);
  const int d0 = lane * V;
  const uint8_t* hp = has_prev != nullptr ? has_prev + ch.g * L + ch.l0 : nullptr;
  int lp[V];
#pragma unroll
  for (int k = 0; k < V; ++k) lp[k] = INF;
  int minprev = 0;
  Block<V, U> a, b;
  load_block<V, U, VEC>(a, costs, hp, ch, 0, lane, d0, D);
  for (int kb = 0; kb < ch.n; kb += 2 * U) {
    load_block<V, U, VEC>(b, costs, hp, ch, kb + U, lane, d0, D);
    run_block<V, U, VEC>(a, out, ch, kb, lp, minprev, lane, d0, D, p1, p2, cap);
    if (kb + U >= ch.n) break;
    load_block<V, U, VEC>(a, costs, hp, ch, kb + 2 * U, lane, d0, D);
    run_block<V, U, VEC>(b, out, ch, kb + U, lp, minprev, lane, d0, D, p1, p2, cap);
  }
}

template <int V>
int launch(const int* costs, int* out, const uint8_t* has_prev, int S, int G, int L, int D,
           int n_shift, int n_chains, int p1, int p2, int cap, bool vec, cudaStream_t stream) {
  const int blocks = (n_chains + WARPS - 1) / WARPS;
  if (vec)
    sgm_scan_kernel<V, true><<<blocks, 32 * WARPS, 0, stream>>>(costs, out, has_prev, S, G, L, D,
                                                                n_shift, n_chains, p1, p2, cap);
  else
    sgm_scan_kernel<V, false><<<blocks, 32 * WARPS, 0, stream>>>(costs, out, has_prev, S, G, L,
                                                                 D, n_shift, n_chains, p1, p2,
                                                                 cap);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int cvo_sgm_max_d() { return MAX_D; }

// costs [S, G, L, D] int32 -> out [S, G, L, D] int32 (ops/sgm.py::_sgm_scan);
// has_prev [G, L] bytes (0 or 1) or null; cap INT_MAX for none.
int cvo_sgm_scan(const int* costs, int* out, const uint8_t* has_prev, int S, int G, int L, int D,
                 int n_shift, int p1, int p2, int cap, cudaStream_t stream) {
  if (S <= 0 || G <= 0 || L <= 0 || D <= 0 || D > MAX_D || n_shift < 0 || n_shift > G)
    return (int)cudaErrorInvalidValue;
  const long long chains = (long long)(G - n_shift) * L + (long long)n_shift * (L + S - 1);
  if (chains > INT_MAX - WARPS) return (int)cudaErrorInvalidValue;
  const int V = D <= 32 ? 1 : D <= 64 ? 2 : D <= 128 ? 4 : D <= 256 ? 8 : D <= 512 ? 16 : 32;
  // vector loads and stores: every row's chunk lane V .. lane V + V - 1 aligned
  const uintptr_t align = (uintptr_t)(V >= 4 ? 16 : 4 * V);
  const bool vec = D % V == 0 && ((uintptr_t)costs | (uintptr_t)out) % align == 0;
  const int n = (int)chains;
  switch (V) {
    case 1: return launch<1>(costs, out, has_prev, S, G, L, D, n_shift, n, p1, p2, cap, vec, stream);
    case 2: return launch<2>(costs, out, has_prev, S, G, L, D, n_shift, n, p1, p2, cap, vec, stream);
    case 4: return launch<4>(costs, out, has_prev, S, G, L, D, n_shift, n, p1, p2, cap, vec, stream);
    case 8: return launch<8>(costs, out, has_prev, S, G, L, D, n_shift, n, p1, p2, cap, vec, stream);
    case 16:
      return launch<16>(costs, out, has_prev, S, G, L, D, n_shift, n, p1, p2, cap, vec, stream);
    default:
      return launch<32>(costs, out, has_prev, S, G, L, D, n_shift, n, p1, p2, cap, vec, stream);
  }
}

}  // extern "C"
