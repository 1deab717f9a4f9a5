// Dual-proximal SGD update for Hopper (sm_90a): paper Alg. 1 l.4, Eq. 6.
//
//   out[a,n] = w[a,n] - (lr*scale[a]) * (g[a,n] + mu1*(w[a,n] - a1[a,n])
//                                               + mu2*(w[a,n] - a2[a,n]))
//
// Replaces the Pallas kernel dual_proximal_sgd (body _update_kernel) of
// src/repro/kernels/dual_proximal_sgd.py, and computes the flat engine's
// inline step (src/repro/fedsim/simulator.py, _local_train_flat) exactly:
// scale[a] is the per-agent step mask, given either as a float (A,) tensor
// or as the integer (A,) active_steps with the step index, from which the
// kernel forms live = (step < active_steps[a]) itself, as the reference
// does (no scale means 1).  a1 / a2 may each be a full (A, N) array, one
// (N,) row broadcast over the A rows (the cloud master), or one row a group
// of consecutive rows.  w, g and out are all fp32 or all bf16 (the LLM's
// leaves: the TPU kernel writes its output in w's dtype); a1 and a2 are
// fp32 or bf16 (widened exactly, as .float() does); arithmetic is fp32, and
// a bf16 out is rounded to nearest even.  A term whose mu is 0 is dropped
// and its anchor not read, as in the TPU kernel.
//
// The scenario axis.  A multi-scenario sweep stacks S fleets of A agents
// as S*A rows; row a belongs to scenario a / A.  Its cloud anchor is then
// one row a scenario, a2 (S, N) with groups of A rows, and lr, mu1 and mu2
// are each a float every row shares or an (S,) device array that the
// kernel reads by the row's scenario.  One launch serves all S*A rows.
//
// Bound: bytes.  w, g and a1 are read once and out written once, 4*A*N*4
// bytes for fp32 (half for bf16), plus a2 (N*4 bytes when broadcast);
// about nine flops an element are far below the fp32 ridge.
//
// Design.  The first version put one row of 256 scalar columns on a block,
// the grid x-fastest, so the card streamed one row at a time: the order
// HBM serves best (94% of the bound with full-shape anchors at perception
// scale, NVIDIA H100 80GB HBM3, 700 W), but a perception-scale row (4 x 38
// MB of w, g, a1, out) evicted the broadcast 38 MB a2 from the 50 MB L2
// between rows, so a2 was re-read from device memory once a row (75% of
// the bound).  Blocks that walk all rows of a column tile, with a2 held in
// registers, read a2 once but scatter the card's accesses over every row
// at once (79%: step 3 of PERF.md's table).  So the grid keeps the row
// streaming order inside super-tiles of kSuperCols columns: the grid is
// (tile in super-tile, row, super-tile), dispatched x-fastest, so all rows
// of one super-tile run before the next, each row streams 1 MB a stream, and the
// 1 MB a2 slice is re-read from L2 by every row (4 MB of other traffic
// between two reads of it).  Each thread takes V = 2 adjacent columns with
// 8-byte loads (4-byte bf16x2 for bf16 anchors).  Alignment: with N even
// every row of an fp32 (A, N) array starts 8-byte aligned and every bf16
// row 4-byte aligned; N % 4 == 2 at the engines' shapes, so 16-byte loads
// are not taken.  The host takes V = 2 only when N is even and every
// pointer is aligned to its pair, else the scalar variant V = 1.  w and out
// may alias (the in-place update of the training loop): each element is
// read and then written by the same thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pairs.cuh"

namespace {

using repro::F2;
using repro::narrow;
using repro::Vec;
using repro::widen;

constexpr int kThreads = 256;
constexpr int64_t kSuperCols = 262144;   // columns a super-tile (1 MB fp32)

// flags of repro_dual_proximal_sgd
constexpr int kA1Bf16 = 1, kA2Bf16 = 2, kWBf16 = 4;
constexpr int kScaleShift = 4;  // 0 none, 1 fp32 scale, 2 int32, 3 int64 steps

struct Args {
  void* out;           // w's dtype, as g
  const void* w;
  const void* g;
  const void* a1;
  int a1_group;        // rows an anchor row serves: 1 full, A broadcast
  const void* a2;
  int a2_group;
  const void* scale;   // fp32 scale, int32 / int64 active_steps, or null
  int scale_kind;
  long long step;
  int A;               // rows
  int64_t units;       // N / V
  float lr, mu1, mu2;
  // per-scenario hyper-parameters, or null for the float above; row a
  // reads entry a / hp_group
  const float* lr_s;
  const float* mu1_s;
  const float* mu2_s;
  int hp_group;
};

// The anchor row that serves ``row`` (uniform over a block): the row itself,
// the one broadcast row, or row / group; 32-bit, and no division in the
// first two cases.
__device__ __forceinline__ int anchor_row(int row, int group, int rows) {
  return group == 1 ? row : (group >= rows ? 0 : row / group);
}

__device__ __forceinline__ float row_scale(const Args& p, int a) {
  switch (p.scale_kind) {
    case 1: return static_cast<const float*>(p.scale)[a];
    case 2: return p.step < static_cast<const int32_t*>(p.scale)[a] ? 1.f : 0.f;
    case 3: return p.step < static_cast<const int64_t*>(p.scale)[a] ? 1.f : 0.f;
    default: return 1.f;
  }
}

template <typename TW, typename TA1, typename TA2, int V>
__global__ void __launch_bounds__(kThreads) dual_proximal_sgd_kernel(Args p) {
  using WV = typename Vec<TW, V>::type;
  using A1V = typename Vec<TA1, V>::type;
  using A2V = typename Vec<TA2, V>::type;
  // grid (tile in super-tile, row, super-tile), dispatched x-fastest
  const int row = blockIdx.y;
  const int64_t j =
      ((int64_t)blockIdx.z * gridDim.x + blockIdx.x) * kThreads + threadIdx.x;
  if (j >= p.units) return;
  const int64_t o = (int64_t)row * p.units + j;
  const F2 wv = widen(static_cast<const WV*>(p.w)[o]);
  const F2 gv = widen(static_cast<const WV*>(p.g)[o]);
  // the row's scenario's hyper-parameters (uniform over the block)
  const int sc = anchor_row(row, p.hp_group, p.A);
  const float mu1 = p.mu1_s ? p.mu1_s[sc] : p.mu1;
  const float mu2 = p.mu2_s ? p.mu2_s[sc] : p.mu2;
  F2 v1{}, v2{};
  if (mu1 != 0.f) {
    v1 = widen(static_cast<const A1V*>(
        p.a1)[(int64_t)anchor_row(row, p.a1_group, p.A) * p.units + j]);
  }
  if (mu2 != 0.f) {
    v2 = widen(static_cast<const A2V*>(
        p.a2)[(int64_t)anchor_row(row, p.a2_group, p.A) * p.units + j]);
  }
  const float lr = (p.lr_s ? p.lr_s[sc] : p.lr) * row_scale(p, row);
  float r[2];
#pragma unroll
  for (int c = 0; c < V; ++c) {
    float step = gv.v[c];
    if (mu1 != 0.f) step += mu1 * (wv.v[c] - v1.v[c]);
    if (mu2 != 0.f) step += mu2 * (wv.v[c] - v2.v[c]);
    r[c] = wv.v[c] - lr * step;
  }
  narrow(static_cast<WV*>(p.out) + o, r);
}

template <typename TW, typename TA1, typename TA2>
cudaError_t launch(Args p, bool vec2, cudaStream_t stream) {
  const int V = vec2 ? 2 : 1;
  p.units /= V;
  const int64_t tiles = (p.units + kThreads - 1) / kThreads;
  const int64_t per_super = kSuperCols / (kThreads * V);
  const int64_t supers = (tiles + per_super - 1) / per_super;
  if (p.A > 65535 || supers > 65535) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)(tiles < per_super ? tiles : per_super),
                  (unsigned)p.A, (unsigned)supers);
  if (vec2) {
    dual_proximal_sgd_kernel<TW, TA1, TA2, 2>
        <<<grid, kThreads, 0, stream>>>(p);
  } else {
    dual_proximal_sgd_kernel<TW, TA1, TA2, 1>
        <<<grid, kThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

bool aligned(const void* ptr, int bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

template <typename TW>
cudaError_t launch_w(Args p, int flags, bool vec2, cudaStream_t s) {
  if (flags & kA1Bf16) {
    return flags & kA2Bf16
               ? launch<TW, __nv_bfloat16, __nv_bfloat16>(p, vec2, s)
               : launch<TW, __nv_bfloat16, float>(p, vec2, s);
  }
  return flags & kA2Bf16 ? launch<TW, float, __nv_bfloat16>(p, vec2, s)
                         : launch<TW, float, float>(p, vec2, s);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 == cudaSuccess).
// flags: bit 0 / 1 a1 / a2 in bf16 (else fp32); bit 2 w, g and out in bf16
// (else fp32); bits 4-5 the scale's kind:
// 0 none, 1 fp32 scale (A,), 2 / 3 int32 / int64 active_steps (A,),
// compared with step.  a1_group / a2_group: the rows each anchor row
// serves (1: a full (A, N) anchor, A: one broadcast row).  lr_s / mu1_s /
// mu2_s: null, or an fp32 array read at row / hp_group in place of the
// float.  The caller checks shapes, dtypes, devices and contiguity and
// guarantees 1 <= A <= 65535, N >= 1 and groups that divide A.
extern "C" int repro_dual_proximal_sgd(
    void* out, const void* w, const void* g, const void* a1, int a1_group,
    const void* a2, int a2_group, const void* scale,
    long long step, int A, long long N, float lr, float mu1, float mu2,
    const void* lr_s, const void* mu1_s, const void* mu2_s, int hp_group,
    int flags, void* stream) {
  Args p{out, w, g, a1, a1_group, a2, a2_group, scale,
         (flags >> kScaleShift) & 3, step, A, (int64_t)N, lr, mu1, mu2,
         static_cast<const float*>(lr_s), static_cast<const float*>(mu1_s),
         static_cast<const float*>(mu2_s), hp_group};
  const int s1 = flags & kA1Bf16 ? 4 : 8, s2 = flags & kA2Bf16 ? 4 : 8;
  const int sw = flags & kWBf16 ? 4 : 8;
  const bool vec2 = N % 2 == 0 && aligned(out, sw) && aligned(w, sw) &&
                    aligned(g, sw) && aligned(a1, s1) && aligned(a2, s2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return flags & kWBf16 ? (int)launch_w<__nv_bfloat16>(p, flags, vec2, s)
                        : (int)launch_w<float>(p, flags, vec2, s);
}
