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
// What bounds them on this card: bytes, and below that the fixed cost of a
// launch. Each slot costs a few dozen flops and one expf against 16-20
// bytes of slot data (raw xyz in, plus chan in and A out for flow; raw xyz
// and A or chan in for step); at N = 16384, K = 32 a pass moves about 9-11
// MB, under 3.3 us of HBM time and less from the 50 MB L2 that holds it
// across iterations, while the arithmetic is far below the f32 peak. So:
//   * every slot array is read exactly once, coalesced: a block is 32
//     threads along the points times TK slot groups; thread (x, y) walks
//     slots k = y, y + TK, ... of its points. Both flow passes take 8 slot
//     groups and 4 adjacent points a thread (vector loads and stores where
//     N allows), the step 4 slot groups and one point, so that its ~96
//     registers a thread still fit all 512 blocks in one wave (the shapes
//     that lost on the H100 are recorded in PERF.md);
//   * at K = UNROLL_K (the builders' default) the slot count is a compile-
//     time constant: a thread issues its point rows and all of its slot
//     loads (y x 3, plus chan or A) before it waits at the block barrier for
//     the scalar block, so its trips to memory overlap each other and that
//     wait; any other K takes the runtime loop with the same arithmetic in
//     the same order;
//   * the per-point flow moments (x cross wy, wy - s x) are linear in the
//     slot sums, so each thread forms them from its own partial sums; the
//     block reduces its 7 floats and its integer count in one shared-memory
//     pass into per-block partials. The row-flow pass is the same template
//     (flow_kernel<ROWS = true>): the same loads and slot arithmetic, then
//     the 8 slot groups of each point meet in shared memory, row 0 adds them
//     in group order, stores the point's s, wy and count, and reduces the
//     block's a_sum and nonzeros partials;
//   * one launch per pass: each block writes its partials and takes a ticket
//     from a per-kernel counter; the block that takes the last
//     ticket sums all partials in block-index order, writes the outputs and
//     sets the counter back to 0 for the next launch. The order of the sums
//     does not depend on which block comes last, so reruns give identical
//     bits; no float atomics. The counters belong to the wrapper
//     (ops/ell.py, one set per device) and assume one stream per device, as
//     the port runs: two launches of one kernel in flight at once on two
//     streams would share a counter;
//   * flow_reduce and step_cached also come with a lane axis (LANES = true,
//     the counterparts of the vmapped Pallas kernels of the JAX package's
//     batched registration): blockIdx.y is the lane, every input and output
//     of a lane starts at its own stride ([B, ...] tensors), and each lane
//     has its own finish counter, so the last block of a lane sums only that
//     lane's partials, in block order. A lane runs the arithmetic of the
//     unbatched launch in the same order, so each lane's outputs equal that
//     launch's bit for bit; LANES = false compiles the offsets out;
//   * the pose scalars arrive as a device pointer to the [32] block built
//     by pack_scalars; the step can also take the flow's unit twist [6] as
//     a device pointer and build the block's twist part itself (thread 0 of
//     each block, in twist_scalars' operation order), so no value crosses
//     to the host and the host builds one scalar block per iteration.
// Compiled with -fmad=false (never --use_fast_math): each multiply and add
// rounds as the plain PyTorch version's separate ops do, so the kernel
// matrix A and its gates match the plain version slot for slot.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "reduce.cuh"

// Design switches, both 1 in the package's build; measurement builds
// (chip_smoke.py --ell-ablation) set one to 0 to time what it is worth:
//   ELL_UNROLL      K = UNROLL_K specialised and unrolled, every slot load in
//                   flight before the barrier (0: the runtime-K loop)
//   ELL_FUSED_SUM   the flow's 7 floats and its count in one block
//                   reduction (0: one reduction each)
#ifndef ELL_UNROLL
#define ELL_UNROLL 1
#endif
#ifndef ELL_FUSED_SUM
#define ELL_FUSED_SUM 1
#endif

namespace {

// scalar block layout, as pack_scalars builds it (pallas_ell.py:69-84)
enum {
  S_RINV = 0, S_TINV = 9, S_SIGMA2 = 12, S_SP = 13, S_OM2 = 14, S_VV = 15,
  S_OMEGA = 16, S_V = 19, S_WV = 22, S_C2 = 25, S_VWV = 28, S_WV2 = 29,
  S_VC2 = 30, S_VOM = 31, S_LEN = 32
};
// per-point rows, as pack_x builds them
enum { X0 = 0, X1 = 1, X2 = 2, THRES = 3, NEGI2L2 = 4, COEF = 5 };

constexpr int FLOW_NV = 7;         // omega(3), v(3), a_sum
constexpr int STEP_NV = 4;         // B, C, D, E

constexpr int TX = 32;             // threads along the points
constexpr int UNROLL_K = 32;       // nbr.DEFAULT_K
constexpr int FLOW_TK = 8;         // flow passes: slot groups per block
constexpr int FLOW_VEC = 4;        // flow passes: adjacent points a thread
constexpr int STEP_TK = 4;         // step: slot groups per block, one point a thread
constexpr int FLOW_THREADS = TX * FLOW_TK;
constexpr int STEP_THREADS = TX * STEP_TK;
static_assert(UNROLL_K % FLOW_TK == 0 && UNROLL_K % STEP_TK == 0,
              "the unrolled slot loop splits UNROLL_K evenly over the slot groups");
static_assert(FLOW_THREADS <= 1024 && STEP_THREADS <= 1024, "at most 1024 threads a block");

// variant codes of the C interface (ops/ell.py VARIANTS)
enum { V_GEO = 0, V_GEO_CHAN = 1, V_CHAN = 2 };

// VEC adjacent floats from p (aligned to 4 * VEC bytes), read-only path.
template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&r)[VEC]) {
  static_assert(VEC == 1 || VEC == 4, "1 or 4 points a thread");
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    r[0] = t.x; r[1] = t.y; r[2] = t.z; r[3] = t.w;
  } else {
    r[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&r)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  } else {
    p[0] = r[0];
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(int* p, const int (&r)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<int4*>(p) = make_int4(r[0], r[1], r[2], r[3]);
  } else {
    p[0] = r[0];
  }
}

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

// Twist part of the scalar block (S_OM2 .. S_VOM) from the unit twist
// (omega, v), in the operation order of ops/ell.py::twist_scalars: W v and
// W^2 v as cross products with omega, dots summed left to right.
__device__ __forceinline__ void twist_scalars(const float* tw, float* s) {
  const float w0 = tw[0], w1 = tw[1], w2 = tw[2];
  const float v0 = tw[3], v1 = tw[4], v2 = tw[5];
  const float a0 = w1 * v2 - w2 * v1, a1 = w2 * v0 - w0 * v2, a2 = w0 * v1 - w1 * v0;
  const float c0 = w1 * a2 - w2 * a1, c1 = w2 * a0 - w0 * a2, c2 = w0 * a1 - w1 * a0;
  s[S_OM2] = w0 * w0 + w1 * w1 + w2 * w2;
  s[S_VV] = v0 * v0 + v1 * v1 + v2 * v2;
  s[S_OMEGA] = w0; s[S_OMEGA + 1] = w1; s[S_OMEGA + 2] = w2;
  s[S_V] = v0; s[S_V + 1] = v1; s[S_V + 2] = v2;
  s[S_WV] = a0; s[S_WV + 1] = a1; s[S_WV + 2] = a2;
  s[S_C2] = c0; s[S_C2 + 1] = c1; s[S_C2 + 2] = c2;
  s[S_VWV] = v0 * a0 + v1 * a1 + v2 * a2;
  s[S_WV2] = a0 * a0 + a1 * a1 + a2 * a2;
  s[S_VC2] = v0 * c0 + v1 * c1 + v2 * c2;
  s[S_VOM] = v0 * w0 + v1 * w1 + v2 * w2;
}

// True in every thread of the block that finishes last. Thread 0 wrote the
// block's partials itself and takes a ticket with an acquire-release atomic
// at device scope: its partials are visible before its ticket, and the
// block with ticket gridDim.x - 1 sees every earlier block's partials; the
// barrier then orders the block's loads after that acquire.
__device__ __forceinline__ bool last_block_in(int* counter, int tid) {
  __shared__ int last;
  if (tid == 0) {
    int ticket;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
                 : "=r"(ticket) : "l"(counter) : "memory");
    last = ticket == (int)gridDim.x - 1;
  }
  __syncthreads();
  return last != 0;
}

template <int NT>
__device__ __forceinline__ void flow_block_sum(float (&acc)[FLOW_NV], int (&cnt)[1],
                                               float* red, int* red_cnt, int tid) {
#if ELL_FUSED_SUM
  cvo::block_sum<float, FLOW_NV, int, 1>(acc, cnt, red, red_cnt, tid, NT);
#else
  cvo::block_sum<float, FLOW_NV>(acc, red, tid, NT);
  cvo::block_sum<int, 1>(cnt, red_cnt, tid, NT);
#endif
}

// Flow outputs from nblocks partials, run by one whole block of NT threads:
// thread t sums blocks t, t + NT, ... in order, then the block reduces in
// its fixed order. out[0:6] unit twist, out[6] joint norm, out[7] a_sum;
// out_nz[0] nonzeros. Sets *counter back to 0.
template <int NT>
__device__ __forceinline__ void flow_finish(const float* part, const int* part_cnt,
                                            int nblocks, float c, float d,
                                            float* out, int* out_nz, float* red,
                                            int* red_cnt, int tid, int* counter) {
  float acc[FLOW_NV] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int cnt[1] = {0};
  for (int b = tid; b < nblocks; b += NT) {
#pragma unroll
    for (int i = 0; i < FLOW_NV; ++i) acc[i] += __ldcg(part + b * FLOW_NV + i);
    cnt[0] += __ldcg(part_cnt + b);
  }
  flow_block_sum<NT>(acc, cnt, red, red_cnt, tid);
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
    *counter = 0;
  }
}

// a_sum and nonzeros of the row-flow pass from nblocks partials, as
// flow_finish: out[0] a_sum, out_nz[0] nonzeros.
template <int NT>
__device__ __forceinline__ void rows_finish(const float* part, const int* part_cnt,
                                            int nblocks, float* out, int* out_nz,
                                            float* red, int* red_cnt, int tid,
                                            int* counter) {
  float acc[1] = {0.f};
  int cnt[1] = {0};
  for (int b = tid; b < nblocks; b += NT) {
    acc[0] += __ldcg(part + b);
    cnt[0] += __ldcg(part_cnt + b);
  }
  cvo::block_sum<float, 1, int, 1>(acc, cnt, red, red_cnt, tid, NT);
  if (tid == 0) {
    out[0] = acc[0];
    out_nz[0] = cnt[0];
    *counter = 0;
  }
}

// B, C, D, E from nblocks partials, as flow_finish.
template <int NT>
__device__ __forceinline__ void step_finish(const float* part, int nblocks,
                                            float* out, float* red, int tid,
                                            int* counter) {
  float acc[STEP_NV] = {0.f, 0.f, 0.f, 0.f};
  for (int b = tid; b < nblocks; b += NT) {
#pragma unroll
    for (int i = 0; i < STEP_NV; ++i) acc[i] += __ldcg(part + b * STEP_NV + i);
  }
  cvo::block_sum<float, STEP_NV>(acc, red, tid, NT);
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < STEP_NV; ++i) out[i] = acc[i];
    *counter = 0;
  }
}

struct FlowArgs {
  int lanes;          // lanes in blockIdx.y (LANES); inputs and outputs [lanes, ...]
  const float* xp;    // [6, N]
  const float* y;     // [3, K, N]
  const float* chan;  // [K, N] (variants with a channel factor)
  const float* scal;  // [32]
  float* A;           // [K, N] out (flow_reduce)
  float* s_out;       // [N] out (flow_rows)
  float* wy_out;      // [3, N] out (flow_rows)
  int* cnt_out;       // [N] out (flow_rows)
  float* part;        // [nblocks, 7] scratch ([nblocks] for flow_rows)
  int* part_cnt;      // [nblocks] scratch
  int* counter;       // finish ticket, 0 between launches
  float* out;         // [8] out; flow_rows: [1] a_sum
  int* out_nz;        // [1] out
  int N, K;
  float c, d;
};

// The arguments of lane `lane` of a lane-axis flow launch: every array
// moved to the lane's stride, the lane's own finish counter.
template <bool ROWS>
__device__ __forceinline__ FlowArgs flow_lane(FlowArgs p, int lane, int nblocks) {
  const size_t N = p.N, KN = (size_t)p.K * p.N, l = lane;
  p.xp += l * 6 * N;
  p.y += l * 3 * KN;
  if (p.chan != nullptr) p.chan += l * KN;
  p.scal += l * S_LEN;
  if (ROWS) {
    p.s_out += l * N;
    p.wy_out += l * 3 * N;
    p.cnt_out += l * N;
    p.part += l * nblocks;
    p.out += l;
  } else {
    p.A += l * KN;
    p.part += l * nblocks * FLOW_NV;
    p.out += l * 8;
  }
  p.part_cnt += l * nblocks;
  p.counter += l;
  p.out_nz += l;
  return p;
}

// One slot of one point in a flow pass: its A, and its share of the
// point's sums.
template <bool GEO, bool CHAN>
__device__ __forceinline__ float flow_slot(const float* s, float ya, float yb,
                                           float yc, float ch, float x0, float x1,
                                           float x2, float thres, float negi,
                                           float& sa, float& w0, float& w1,
                                           float& w2, int& cnt) {
  float t0, t1, t2;
  move_slot(s, ya, yb, yc, t0, t1, t2);
  const float a = slot_a<GEO, CHAN>(s, x0, x1, x2, thres, negi, t0, t1, t2, ch);
  sa += a;
  w0 += a * t0;
  w1 += a * t1;
  w2 += a * t2;
  cnt += a > 0.f;
  return a;
}

// Flow pass, finished in the last block. ROWS = false (flow_reduce): A
// written out, the flow moments reduced. ROWS = true (flow_rows): the
// point rows s, wy and cnt written out, a_sum and nonzeros reduced.
// KC > 0: K == KC, unrolled. VEC points a thread (N % VEC == 0). LANES: the
// lane axis in blockIdx.y (flow_lane).
template <bool ROWS, bool GEO, bool CHAN, int KC, int VEC, bool LANES = false>
__global__ void __launch_bounds__(FLOW_THREADS)
flow_kernel(const FlowArgs args) {
  const FlowArgs p = LANES ? flow_lane<ROWS>(args, blockIdx.y, gridDim.x) : args;
  constexpr int NT = FLOW_THREADS;
  constexpr int SL = KC > 0 ? KC / FLOW_TK : 1;   // slots a thread, unrolled
  __shared__ float s[S_LEN];
  __shared__ float red[FLOW_NV * NT / 32];
  __shared__ int red_cnt[NT / 32];
  const int tid = threadIdx.y * TX + threadIdx.x;
  const int N = p.N;
  const int n0 = (blockIdx.x * TX + threadIdx.x) * VEC;
  const bool live = n0 < N;   // N % VEC == 0: a thread's points are all in range or none
  const size_t plane = (size_t)p.K * N;

  // the point rows and, unrolled, every slot: loads issued before the block
  // waits for its scalar block. The point rows start at 0: a thread past N
  // still adds x cross wy and wy - s x (with wy = s = 0) into the block's
  // moments, and a register left unset could hold an inf or NaN pattern
  float x0[VEC], x1[VEC], x2[VEC], thres[VEC], negi[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) { x0[j] = 0.f; x1[j] = 0.f; x2[j] = 0.f; thres[j] = 0.f; negi[j] = 0.f; }
  float ya[SL][VEC], yb[SL][VEC], yc[SL][VEC], ch[SL][VEC];
  if (live) {
    load_vec<VEC>(p.xp + X0 * N + n0, x0);
    load_vec<VEC>(p.xp + X1 * N + n0, x1);
    load_vec<VEC>(p.xp + X2 * N + n0, x2);
    load_vec<VEC>(p.xp + THRES * N + n0, thres);
    load_vec<VEC>(p.xp + NEGI2L2 * N + n0, negi);
    if constexpr (KC > 0) {
#pragma unroll
      for (int i = 0; i < SL; ++i) {
        const size_t o = (size_t)(threadIdx.y + i * FLOW_TK) * N + n0;
        load_vec<VEC>(p.y + o, ya[i]);
        load_vec<VEC>(p.y + plane + o, yb[i]);
        load_vec<VEC>(p.y + 2 * plane + o, yc[i]);
        if (CHAN) {
          load_vec<VEC>(p.chan + o, ch[i]);
        } else {
#pragma unroll
          for (int j = 0; j < VEC; ++j) ch[i][j] = 0.f;
        }
      }
    }
  }
  if (tid < S_LEN) s[tid] = p.scal[tid];
  __syncthreads();

  float sa[VEC], w0[VEC], w1[VEC], w2[VEC];
  int pc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) { sa[j] = 0.f; w0[j] = 0.f; w1[j] = 0.f; w2[j] = 0.f; pc[j] = 0; }
  if (live) {
    if constexpr (KC > 0) {
#pragma unroll
      for (int i = 0; i < SL; ++i) {
        float a[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          a[j] = flow_slot<GEO, CHAN>(s, ya[i][j], yb[i][j], yc[i][j], ch[i][j], x0[j],
                                      x1[j], x2[j], thres[j], negi[j], sa[j], w0[j],
                                      w1[j], w2[j], pc[j]);
        if (!ROWS) store_vec<VEC>(p.A + (size_t)(threadIdx.y + i * FLOW_TK) * N + n0, a);
      }
    } else {
      // runtime K (SL = 1): each slot loaded into row 0, then used
      for (int k = threadIdx.y; k < p.K; k += FLOW_TK) {
        const size_t o = (size_t)k * N + n0;
        float a[VEC];
        load_vec<VEC>(p.y + o, ya[0]);
        load_vec<VEC>(p.y + plane + o, yb[0]);
        load_vec<VEC>(p.y + 2 * plane + o, yc[0]);
        if (CHAN) {
          load_vec<VEC>(p.chan + o, ch[0]);
        } else {
#pragma unroll
          for (int j = 0; j < VEC; ++j) ch[0][j] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          a[j] = flow_slot<GEO, CHAN>(s, ya[0][j], yb[0][j], yc[0][j], ch[0][j], x0[j], x1[j],
                                      x2[j], thres[j], negi[j], sa[j], w0[j], w1[j], w2[j],
                                      pc[j]);
        if (!ROWS) store_vec<VEC>(p.A + o, a);
      }
    }
  }

  if constexpr (ROWS) {
    // the slot groups of each point meet here; row 0 adds them in group order
    // point j of thread x at column j * TX + x: no bank conflicts
    __shared__ float grp[4][FLOW_TK][VEC * TX];   // s, wy0, wy1, wy2
    __shared__ int grp_cnt[FLOW_TK][VEC * TX];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int col = j * TX + threadIdx.x;
      grp[0][threadIdx.y][col] = sa[j];
      grp[1][threadIdx.y][col] = w0[j];
      grp[2][threadIdx.y][col] = w1[j];
      grp[3][threadIdx.y][col] = w2[j];
      grp_cnt[threadIdx.y][col] = pc[j];
    }
    __syncthreads();
    if (threadIdx.y == 0) {
      float row[4][VEC];
      int rc[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int col = j * TX + threadIdx.x;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float v = grp[r][0][col];
#pragma unroll
          for (int g = 1; g < FLOW_TK; ++g) v += grp[r][g][col];
          row[r][j] = v;
        }
        int c = grp_cnt[0][col];
#pragma unroll
        for (int g = 1; g < FLOW_TK; ++g) c += grp_cnt[g][col];
        rc[j] = c;
      }
      if (live) {
        store_vec<VEC>(p.s_out + n0, row[0]);
        store_vec<VEC>(p.wy_out + n0, row[1]);
        store_vec<VEC>(p.wy_out + N + n0, row[2]);
        store_vec<VEC>(p.wy_out + 2 * N + n0, row[3]);
        store_vec<VEC>(p.cnt_out + n0, rc);
      }
      float bs[1] = {0.f};   // 0 for points past N
      int bc[1] = {0};
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        bs[0] += row[0][j];
        bc[0] += rc[j];
      }
      cvo::warp_sum<float, 1>(bs);
      cvo::warp_sum<int, 1>(bc);
      if (threadIdx.x == 0) {
        p.part[blockIdx.x] = bs[0];
        p.part_cnt[blockIdx.x] = bc[0];
      }
    }
    if (last_block_in(p.counter, tid))
      rows_finish<NT>(p.part, p.part_cnt, gridDim.x, p.out, p.out_nz, red, red_cnt, tid,
                      p.counter);
  } else {
    float acc[FLOW_NV] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    int cnt[1] = {0};
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      acc[0] += x1[j] * w2[j] - x2[j] * w1[j];
      acc[1] += x2[j] * w0[j] - x0[j] * w2[j];
      acc[2] += x0[j] * w1[j] - x1[j] * w0[j];
      acc[3] += w0[j] - sa[j] * x0[j];
      acc[4] += w1[j] - sa[j] * x1[j];
      acc[5] += w2[j] - sa[j] * x2[j];
      acc[6] += sa[j];
      cnt[0] += pc[j];
    }
    flow_block_sum<NT>(acc, cnt, red, red_cnt, tid);
    if (tid == 0) {
#pragma unroll
      for (int i = 0; i < FLOW_NV; ++i) p.part[blockIdx.x * FLOW_NV + i] = acc[i];
      p.part_cnt[blockIdx.x] = cnt[0];
    }
    if (last_block_in(p.counter, tid))
      flow_finish<NT>(p.part, p.part_cnt, gridDim.x, p.c, p.d, p.out, p.out_nz, red,
                      red_cnt, tid, p.counter);
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

struct StepArgs {
  const float* xp;     // [6, N] ([lanes, 6, N] under LANES, as every array)
  const float* y;      // [3, K, N]
  const float* aux;    // [K, N]: A (cached), chan (uncached with a channel factor)
  const float* scal;   // [32]
  const float* twist;  // [6] unit twist, or null: the twist part of scal
  float* part;         // [nblocks, 4] scratch
  int* counter;        // finish ticket, 0 between launches
  float* out;          // [4] out
  int N, K;
  int twist_ld;        // LANES: floats from one lane's twist to the next
};

// The arguments of lane `lane` of a lane-axis step launch, as flow_lane.
__device__ __forceinline__ StepArgs step_lane(StepArgs p, int lane, int nblocks) {
  const size_t N = p.N, KN = (size_t)p.K * p.N, l = lane;
  p.xp += l * 6 * N;
  p.y += l * 3 * KN;
  if (p.aux != nullptr) p.aux += l * KN;
  p.scal += l * S_LEN;
  if (p.twist != nullptr) p.twist += l * p.twist_ld;
  p.part += l * nblocks * STEP_NV;
  p.counter += l;
  p.out += l * STEP_NV;
  return p;
}

// One slot of one point in the step pass. CACHED takes A from `av`;
// otherwise A is recomputed by the <GEO, CHAN> front half, with `av` the
// channel factor (used only when CHAN).
template <bool CACHED, bool GEO, bool CHAN>
__device__ __forceinline__ void step_slot(const float* s, float ya, float yb, float yc,
                                          float av, float x0, float x1, float x2,
                                          float thres, float negi, float coef,
                                          float xom, float xv, float xwv, float xc2,
                                          float (&acc)[STEP_NV]) {
  float t0, t1, t2;
  move_slot(s, ya, yb, yc, t0, t1, t2);
  const float a = CACHED ? av
                         : slot_a<GEO, CHAN>(s, x0, x1, x2, thres, negi, t0, t1, t2,
                                             CHAN ? av : 0.f);
  step_tail(s, a, t0, t1, t2, x0, x1, x2, coef, xom, xv, xwv, xc2, acc);
}

// Step pass, cached (A read) or uncached (A recomputed), finished in the
// last block; one point a thread. KC and LANES as in flow_kernel. Both modes
// visit the slots and points in the same order, so on the same A they agree
// bit for bit.
template <bool CACHED, bool GEO, bool CHAN, int KC, bool LANES = false>
__global__ void __launch_bounds__(STEP_THREADS)
step_kernel(const StepArgs args) {
  const StepArgs p = LANES ? step_lane(args, blockIdx.y, gridDim.x) : args;
  constexpr int NT = STEP_THREADS;
  constexpr int SL = KC > 0 ? KC / STEP_TK : 1;   // slots a thread, unrolled
  constexpr bool READ_AUX = CACHED || CHAN;
  __shared__ float s[S_LEN];
  __shared__ float red[STEP_NV * NT / 32];
  const int tid = threadIdx.y * TX + threadIdx.x;
  const int N = p.N;
  const int n = blockIdx.x * TX + threadIdx.x;
  const bool live = n < N;
  const size_t plane = (size_t)p.K * N;

  // loads issued before the block waits for its scalar block, as in
  // flow_kernel
  float x0 = 0.f, x1 = 0.f, x2 = 0.f, coef = 0.f, thres = 0.f, negi = 0.f;
  float ya[SL], yb[SL], yc[SL], av[SL];
  if (live) {
    x0 = __ldg(p.xp + X0 * N + n);
    x1 = __ldg(p.xp + X1 * N + n);
    x2 = __ldg(p.xp + X2 * N + n);
    coef = __ldg(p.xp + COEF * N + n);
    if (!CACHED) {
      thres = __ldg(p.xp + THRES * N + n);
      negi = __ldg(p.xp + NEGI2L2 * N + n);
    }
    if constexpr (KC > 0) {
#pragma unroll
      for (int i = 0; i < SL; ++i) {
        const size_t o = (size_t)(threadIdx.y + i * STEP_TK) * N + n;
        ya[i] = __ldg(p.y + o);
        yb[i] = __ldg(p.y + plane + o);
        yc[i] = __ldg(p.y + 2 * plane + o);
        av[i] = READ_AUX ? __ldg(p.aux + o) : 0.f;
      }
    }
  }
  if (tid < (p.twist != nullptr ? S_OM2 : S_LEN)) s[tid] = p.scal[tid];
  if (p.twist != nullptr && tid == 0) twist_scalars(p.twist, s);
  __syncthreads();

  float acc[STEP_NV] = {0.f, 0.f, 0.f, 0.f};
  if (live) {
    // the point's dots with the constant twist vectors
    const float xom = x0 * s[S_OMEGA] + x1 * s[S_OMEGA + 1] + x2 * s[S_OMEGA + 2];
    const float xv = x0 * s[S_V] + x1 * s[S_V + 1] + x2 * s[S_V + 2];
    const float xwv = x0 * s[S_WV] + x1 * s[S_WV + 1] + x2 * s[S_WV + 2];
    const float xc2 = x0 * s[S_C2] + x1 * s[S_C2 + 1] + x2 * s[S_C2 + 2];
    if constexpr (KC > 0) {
#pragma unroll
      for (int i = 0; i < SL; ++i)
        step_slot<CACHED, GEO, CHAN>(s, ya[i], yb[i], yc[i], av[i], x0, x1, x2, thres, negi,
                                     coef, xom, xv, xwv, xc2, acc);
    } else {
      // runtime K: each slot loaded, then used
      for (int k = threadIdx.y; k < p.K; k += STEP_TK) {
        const size_t o = (size_t)k * N + n;
        step_slot<CACHED, GEO, CHAN>(s, __ldg(p.y + o), __ldg(p.y + plane + o),
                                     __ldg(p.y + 2 * plane + o),
                                     READ_AUX ? __ldg(p.aux + o) : 0.f, x0, x1, x2, thres,
                                     negi, coef, xom, xv, xwv, xc2, acc);
      }
    }
  }
  cvo::block_sum<float, STEP_NV>(acc, red, tid, NT);
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < STEP_NV; ++i) p.part[blockIdx.x * STEP_NV + i] = acc[i];
  }
  if (last_block_in(p.counter, tid)) step_finish<NT>(p.part, gridDim.x, p.out, red, tid, p.counter);
}

bool aligned(const void* q, int bytes) {
  return q == nullptr || reinterpret_cast<uintptr_t>(q) % bytes == 0;
}

template <bool ROWS, bool GEO, bool CHAN, int KC, int VEC, bool LANES>
int launch_flow(const FlowArgs& a, cudaStream_t stream) {
  const int nblocks = (a.N + TX * VEC - 1) / (TX * VEC);
  flow_kernel<ROWS, GEO, CHAN, KC, VEC, LANES>
      <<<dim3(nblocks, LANES ? a.lanes : 1), dim3(TX, FLOW_TK), 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// The slot loop (unrolled at K = UNROLL_K) and the points a thread (FLOW_VEC
// where N and every pointer allow vector loads and stores, else 1) of this
// launch.
// The slot loop (unrolled at K = UNROLL_K) and the points a thread (FLOW_VEC
// where N and every pointer allow vector loads and stores, else 1) of this
// launch. Under LANES every lane's arrays start a multiple of N floats after
// the first lane's, so N % FLOW_VEC == 0 keeps them aligned too.
template <bool ROWS, bool GEO, bool CHAN, bool LANES>
int dispatch_flow(const FlowArgs& a, cudaStream_t stream) {
  constexpr int V = FLOW_VEC;
  const bool vec = a.N % V == 0 && aligned(a.xp, 4 * V) && aligned(a.y, 4 * V)
                   && aligned(a.chan, 4 * V) && aligned(a.A, 4 * V)
                   && aligned(a.s_out, 4 * V) && aligned(a.wy_out, 4 * V)
                   && aligned(a.cnt_out, 4 * V);
  if (ELL_UNROLL && a.K == UNROLL_K)
    return vec ? launch_flow<ROWS, GEO, CHAN, UNROLL_K, V, LANES>(a, stream)
               : launch_flow<ROWS, GEO, CHAN, UNROLL_K, 1, LANES>(a, stream);
  return vec ? launch_flow<ROWS, GEO, CHAN, 0, V, LANES>(a, stream)
             : launch_flow<ROWS, GEO, CHAN, 0, 1, LANES>(a, stream);
}

template <bool ROWS, bool LANES = false>
int dispatch_flow_variant(const FlowArgs& a, int variant, cudaStream_t stream) {
  if (a.N <= 0 || a.K <= 0 || a.lanes <= 0 || a.lanes > 65535)
    return (int)cudaErrorInvalidValue;
  switch (variant) {
    case V_GEO: return dispatch_flow<ROWS, true, false, LANES>(a, stream);
    case V_GEO_CHAN: return dispatch_flow<ROWS, true, true, LANES>(a, stream);
    case V_CHAN: return dispatch_flow<ROWS, false, true, LANES>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool CACHED, bool GEO, bool CHAN, int KC, bool LANES>
int launch_step(const StepArgs& a, int lanes, cudaStream_t stream) {
  const int nblocks = (a.N + TX - 1) / TX;
  step_kernel<CACHED, GEO, CHAN, KC, LANES>
      <<<dim3(nblocks, lanes), dim3(TX, STEP_TK), 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// The slot loop of this launch: unrolled at K = UNROLL_K, else the runtime
// loop.
template <bool CACHED, bool GEO, bool CHAN, bool LANES = false>
int dispatch_step(const StepArgs& a, cudaStream_t stream, int lanes = 1) {
  if (ELL_UNROLL && a.K == UNROLL_K)
    return launch_step<CACHED, GEO, CHAN, UNROLL_K, LANES>(a, lanes, stream);
  return launch_step<CACHED, GEO, CHAN, 0, LANES>(a, lanes, stream);
}

}  // namespace

extern "C" {

// Rows of per-block scratch any pass of this file needs for N points (one
// block per 32 points at most).
int cvo_ell_blocks(int N) { return (N + TX - 1) / TX; }

// The build's design switches, in the order ELL_UNROLL, ELL_FUSED_SUM.
void cvo_ell_design(int* out) {
  out[0] = ELL_UNROLL;
  out[1] = ELL_FUSED_SUM;
}

// xp [6, N], y [3, K, N], chan [K, N] (variant V_GEO_CHAN or V_CHAN, else
// unused), scal [32] -> A [K, N]; part [nblocks, 7] and part_cnt [nblocks]
// are scratch, counter [1] is 0 before and after; out [8] = (unit twist,
// joint norm, a_sum), out_nz [1] = nonzeros.
int cvo_flow_reduce(const float* xp, const float* y, const float* chan,
                    const float* scal, float* A, float* part, int* part_cnt,
                    int* counter, float* out, int* out_nz, int N, int K, float c,
                    float d, int variant, cudaStream_t stream) {
  const FlowArgs a{1, xp, y, chan, scal, A, nullptr, nullptr, nullptr, part, part_cnt,
                   counter, out, out_nz, N, K, c, d};
  return dispatch_flow_variant<false>(a, variant, stream);
}

// cvo_flow_reduce with a lane axis: every array [lanes, ...] (xp [lanes, 6,
// N], y [lanes, 3, K, N], chan and A [lanes, K, N], scal [lanes, 32], part
// [lanes, nblocks, 7], part_cnt [lanes, nblocks], out [lanes, 8], out_nz
// [lanes]); counter points at lanes consecutive counters, 0 before and
// after. Each lane's outputs equal cvo_flow_reduce's on that lane's inputs.
int cvo_flow_reduce_lanes(const float* xp, const float* y, const float* chan,
                          const float* scal, float* A, float* part, int* part_cnt,
                          int* counter, float* out, int* out_nz, int N, int K, float c,
                          float d, int variant, int lanes, cudaStream_t stream) {
  const FlowArgs a{lanes, xp, y, chan, scal, A, nullptr, nullptr, nullptr, part, part_cnt,
                   counter, out, out_nz, N, K, c, d};
  return dispatch_flow_variant<false, true>(a, variant, stream);
}

// xp [6, N], y [3, K, N], A [K, N], scal [32], twist [6] or null -> out [4]
// = (B, C, D, E). With twist, the twist part of scal is built from it on
// the device and scal's own is not read. part [nblocks, 4] is scratch,
// counter [1] is 0 before and after.
int cvo_step_cached(const float* xp, const float* y, const float* A,
                    const float* scal, const float* twist, float* part,
                    int* counter, float* out, int N, int K, cudaStream_t stream) {
  if (N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const StepArgs a{xp, y, A, scal, twist, part, counter, out, N, K};
  return dispatch_step<true, false, false>(a, stream);
}

// cvo_step_cached with a lane axis, as cvo_flow_reduce_lanes: twist [lanes,
// 6] with twist_ld floats from one lane's row to the next (8 for the flow's
// out rows), or null; part [lanes, nblocks, 4], out [lanes, 4], counter at
// lanes consecutive counters.
int cvo_step_cached_lanes(const float* xp, const float* y, const float* A,
                          const float* scal, const float* twist, int twist_ld,
                          float* part, int* counter, float* out, int N, int K, int lanes,
                          cudaStream_t stream) {
  if (N <= 0 || K <= 0 || lanes <= 0 || lanes > 65535) return (int)cudaErrorInvalidValue;
  const StepArgs a{xp, y, A, scal, twist, part, counter, out, N, K, twist_ld};
  return dispatch_step<true, false, false, true>(a, stream, lanes);
}

// xp [6, N], y [3, K, N], chan [K, N] (as cvo_flow_reduce), scal [32] ->
// s_out [N], wy_out [3, N], cnt_out [N], out_asum [1], out_nz [1];
// part [nblocks] and part_cnt [nblocks] are scratch, counter [1] is 0
// before and after.
int cvo_flow_rows(const float* xp, const float* y, const float* chan,
                  const float* scal, float* s_out, float* wy_out, int* cnt_out,
                  float* part, int* part_cnt, int* counter, float* out_asum,
                  int* out_nz, int N, int K, int variant, cudaStream_t stream) {
  const FlowArgs a{1, xp, y, chan, scal, nullptr, s_out, wy_out, cnt_out, part, part_cnt,
                   counter, out_asum, out_nz, N, K, 0.f, 0.f};
  return dispatch_flow_variant<true>(a, variant, stream);
}

// xp [6, N], y [3, K, N], chan [K, N] (as cvo_flow_reduce), scal [32] ->
// out [4] = (B, C, D, E) with A recomputed; part [nblocks, 4] is scratch,
// counter [1] is 0 before and after.
int cvo_step_uncached(const float* xp, const float* y, const float* chan,
                      const float* scal, float* part, int* counter, float* out,
                      int N, int K, int variant, cudaStream_t stream) {
  if (N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const StepArgs a{xp, y, chan, scal, nullptr, part, counter, out, N, K};
  switch (variant) {
    case V_GEO: return dispatch_step<false, true, false>(a, stream);
    case V_GEO_CHAN: return dispatch_step<false, true, true>(a, stream);
    case V_CHAN: return dispatch_step<false, false, true>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
