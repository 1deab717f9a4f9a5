// Masked hierarchical aggregation for Hopper (sm_90a): the RSU layer (paper
// Alg. 2 l.8) and the cloud layer (Alg. 3 l.6) of the H2-Fed round.
//
// Replaces the Pallas kernels of src/repro/kernels/masked_hier_agg.py:
//   * _fused_agg_blend (body _make_fused_kernel), the ring kernel below:
//       out[r,n] = guard[r] ? (retained[r]*buf[r,n] + sum_i W_i[r,:].X_i[:,n])
//                              / safe[r]
//                           : buf[r,n]
//     either with W and the per-row coef [retained | safe | guard] given
//     (repro_fused_agg_blend: agg_absorb's 1 or 2 (W_i, X_i) pairs), or
//     with the weights built in the kernel from what the engine holds
//     (repro_agg_blend: agg_blend and cloud_blend, below);
//   * weighted_agg_matmul (body _agg_kernel), the matmul kernels at the end:
//       out[r,n] = sum_a W[r,a].X[a,n], out in X's dtype or fp32 (the
//       scatter-accumulate's unnormalized sums).
// W and coef are fp32, X is fp32 or bf16, accumulation is fp32.
//
// The scenario axis.  A multi-scenario sweep stacks S independent fleets:
// X (S, A, N), buf and out (S, R, N), W (S, R, A) (or one (R, A) matrix
// every scenario shares, for the matmul), and for the built weights
// weights / mask / assign (S, A) or one shared (A,) row each.  Every
// kernel takes the scenario from blockIdx.y, so one launch serves all S
// fleets, and a block reads only its scenario's rows and builds only its
// scenario's weights in shared memory: the shared-memory limit stays the
// per-scenario one on A, and the FMAs are S times one scenario's (a
// block-diagonal (S*R, S*A) weight matrix would cost S times more).  The
// agent split below is chosen for one scenario whatever S is, so each
// scenario's sums run in the order of its run alone, and a sweep's buffers
// equal its sequential runs' bit for bit; at S = 16, A = 100, N = 31,810
// that costs agg_blend 0.17 ms against 0.09 with a split chosen for all S
// (PERF.md, section 6): every block builds its scenario's weights, and the
// one-scenario split makes 8 times the blocks.
//
// Bound: bytes.  A launch must read every X_i once and write out once, and
// read buf only where a row needs it (a row whose guard is off, or that
// retains part of buf): sum_i A_i*N*sizeof(X) + R*N*sizeof(out) + the rows
// of buf it needs (R*N*sizeof(X) out and no buf for the plain matmul).  The
// arithmetic, 2*R*sum_i A_i flops a column, sits far below the fp32 ridge
// for the R of a few tens the engines use.
//
// Ring kernel (agg_blend, cloud_blend, agg_absorb).
//   What held the first version back at R = 10, N ~ 1e7 (58% of the byte
//   bound): each thread kept RC*C = 32 accumulators, so it had only two
//   4-byte loads in flight an agent, and the launch paths built W, mass
//   and coef in some 25 small launches before the kernel's own.
//   * Bytes in flight: each thread owns V = 2 adjacent columns and streams
//     its own X values through a private ring in shared memory with
//     cp.async (kStages stages of kStageAgents agents: 12 agents' loads in
//     flight a thread while it sums the 4 of the oldest stage).  A thread
//     reads back only what it copied itself, so cp.async.wait_group alone
//     orders the ring; no barrier is needed in the agent loop.  The copies
//     are 8 bytes (fp32) or 4 (bf16x2): with N even every row of an (A, N)
//     array starts 8-byte aligned in fp32 and 4-byte aligned in bf16; N %
//     4 == 2 at the engines' shapes, so rows are not 16-byte aligned and
//     neither 16-byte copies nor a 2-D tensor map can describe X.  The host
//     takes V = 2 only when N is even and every pointer is aligned to its
//     pair, else V = 1 (4-byte cp.async in fp32; for bf16 a 2-byte copy is
//     below cp.async's least size, so V = 1 bf16 copies through registers).
//   * Rows: all of R <= 16 in one pass, padded to RC = 1, 2, 4, 8, 12 or 16
//     (12 for the paper's R = 10), RC*V <= 32 accumulators; R > 16 goes in
//     chunks of 16, each re-reading X.
//   * The weights on the device (repro_agg_blend): each block stages every
//     agent's weights[a]*mask[a] and row in shared memory (one coalesced
//     pass: a loop of dependent device-memory loads over the R x A weights
//     cost a small-N block more than its share of X), computes its RC
//     rows' masses, mass[r] = sum_a [assign[a]
//     == r] weights[a]*mask[a], one warp a row, lanes over agents in a
//     fixed order and a butterfly sum, so every block gets the same numbers
//     and needs no atomics; then W = wm / mass (the reference's row
//     normalization), guard = mass > 0.  Block 0 writes mass.  assign =
//     null puts every agent on row 0 and mask = null is all ones: that is
//     cloud_blend, the R -> 1 layer over the RSU masses.  The ring's first
//     stages are issued before this, so the weights are built while X is in
//     flight.
//   * A row that needs no buf does not read it.
//   * Small N: a block of 256 threads per column tile leaves most SMs idle
//     (63 blocks at the main path's N = 31,810), and a block of 64 threads
//     per tile runs a warp an SM partition through all A agents.  So, as in
//     the matmul kernels, the host splits the agents over K groups of
//     256/K threads (the smallest K of 1, 2, 4, 8, 16, at most A, that
//     gives two blocks an SM, else the largest), each with its own ring;
//     after a barrier every (row, unit) adds its K partial sums in group
//     order.  The partial sums take the ring's shared memory, so a block
//     at the paper's shape (A = 100, R = 10, N = 31,810) needs 38 KB and
//     all its 498 blocks are resident at once.  Fewer threads (128, 64)
//     only where the weights leave too little shared memory.
//   What it gives up: X is re-read once per chunk when R > 16, padded rows
//   cost FMAs on zeros, and A is limited by shared memory (RC*(A_1 + A_2)*4
//   bytes of weights, 8 bytes an agent when the kernel builds them, and the
//   ring <= 227 KB).  buf and out may alias: each element is read and then
//   written by the same thread.
//
// Matmul kernels (weighted_agg_matmul).  RSU rows in chunks of RC
// (1, 2, 4, 8 or 16); a block of 256 threads owns a run of columns; the
// chunk's W rows are staged in shared memory transposed, agent-major and
// zero-padded to RC, and each weight serves C columns (C = 8 / 8 / 8 / 4 /
// 2 for RC = 1 / 2 / 4 / 8 / 16).  At small N the host splits the agents
// over K groups of 256/K threads (K = 1, 2, 4, 8, 16, at most A; the
// smallest K that gives two blocks an SM, else the largest), which add
// their partial sums in group order after a barrier.  Every sum's order is
// fixed, so results are deterministic.
//   Agent tiles.  Where the chunk's weights for all A agents fit in shared
// memory (RC*A*4 <= 227 KB) a block stages them once, as the kernels always
// did, and nothing about the sums changes.  Past that (A > 3,632 at R = 9-16,
// the streamed rounds' 16,384-agent chunks) the block walks over tiles of
// kTileBytes of weights (512 agents at RC = 16), staging each in turn and
// keeping its fp32 accumulators in registers across the tiles; with the
// agents split, group s takes the s-th K-th of every tile, so every group
// has work in every tile.  Agents are still summed in ascending order within
// a thread, so results stay deterministic.
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
constexpr int kMaxSplits = 16;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;   // per block on sm_90, opted in

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return sms;
}

int cached_sm_count() {
  static const int sms = sm_count();
  return sms > 0 ? sms : 132;
}

// ---------------------------------------------------------------------------
// Ring kernel
// ---------------------------------------------------------------------------

constexpr int kStages = 4;
constexpr int kStageAgents = 4;
constexpr int kRingThreads = 256;   // the most threads a block

// One unit (V columns of X) from device memory into this thread's slot:
// cp.async where the unit is 4 or 8 bytes, else through a register.
template <typename U>
__device__ __forceinline__ void copy_unit(U* dst, const U* src) {
  if constexpr (sizeof(U) >= 4) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"((int)sizeof(U))
                 : "memory");
  } else {
    *dst = *src;
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct RingArgs {
  // weights built in the kernel (BUILD)
  const float* weights;   // (a1,)
  const void* mask;       // (a1,) fp32 or bool, or null (all ones)
  int mask_kind;          // 0 null, 1 fp32, 2 bool
  const void* assign;     // (a1,) int32 or int64 row of each agent, or null
  int assign_kind;        // 0 null (every agent on row 0), 1 int32, 2 int64
  float* mass_out;        // (R,) or null
  // weights given (!BUILD)
  const float* coef;      // (R, 3)
  const float* w1;        // (R, a1)
  const float* w2;        // (R, a2) or null
  const void* x1;         // (a1, N)
  const void* x2;         // (a2, N) or null
  int a1, a2;             // a2 == 0: one pair
  const void* buf;        // (R, N) in out's dtype
  void* out;              // (R, N)
  int R;
  int64_t N;
  int splits;             // K: agent groups a block (1, 2, 4, 8 or 16)
  int S;                  // scenarios (gridDim.y)
  // the scenario axis (gridDim.y): bytes from one scenario's operand to
  // the next; 0 for an operand every scenario shares
  int64_t weights_sb, mask_sb, assign_sb;
  int64_t x1_sb, x2_sb, buf_sb, out_sb;
};

// The operands of scenario s: every pointer moved by its stride; mass
// (R floats), coef (R x 3) and W (R x a) are per scenario.
__device__ __forceinline__ RingArgs scenario_view(RingArgs p, int s) {
  auto at = [s](const void* ptr, int64_t sb) {
    return ptr ? static_cast<const void*>(static_cast<const char*>(ptr) +
                                          (int64_t)s * sb)
               : ptr;
  };
  p.weights = static_cast<const float*>(at(p.weights, p.weights_sb));
  p.mask = at(p.mask, p.mask_sb);
  p.assign = at(p.assign, p.assign_sb);
  if (p.mass_out) p.mass_out += (int64_t)s * p.R;
  if (p.coef) p.coef += (int64_t)s * p.R * 3;
  if (p.w1) p.w1 += (int64_t)s * p.R * p.a1;
  if (p.w2) p.w2 += (int64_t)s * p.R * p.a2;
  p.x1 = at(p.x1, p.x1_sb);
  p.x2 = at(p.x2, p.x2_sb);
  p.buf = at(p.buf, p.buf_sb);
  p.out = const_cast<void*>(at(p.out, p.out_sb));
  return p;
}

__device__ __forceinline__ float agent_weight(const RingArgs& p, int a) {
  const float w = p.weights[a];
  switch (p.mask_kind) {
    case 1: return w * static_cast<const float*>(p.mask)[a];
    case 2: return w * (static_cast<const bool*>(p.mask)[a] ? 1.f : 0.f);
    default: return w;
  }
}

__device__ __forceinline__ int64_t agent_row(const RingArgs& p, int a) {
  switch (p.assign_kind) {
    case 1: return static_cast<const int32_t*>(p.assign)[a];
    case 2: return static_cast<const int64_t*>(p.assign)[a];
    default: return 0;
  }
}

// acc[j][c] += w[j] * x[c] for one agent's RC weights w (16-byte aligned
// when RC % 4 == 0) and its V values x.
template <int RC, int V>
__device__ __forceinline__ void fma_rows(float (&acc)[RC][V], const float* w,
                                         const F2& x) {
  if constexpr (RC % 4 == 0) {
#pragma unroll
    for (int q = 0; q < RC / 4; ++q) {
      const float4 w4 = reinterpret_cast<const float4*>(w)[q];
      const float ws[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int c = 0; c < V; ++c) {
          acc[4 * q + k][c] = fmaf(ws[k], x.v[c], acc[4 * q + k][c]);
        }
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < RC; ++j) {
      const float wj = w[j];
#pragma unroll
      for (int c = 0; c < V; ++c) acc[j][c] = fmaf(wj, x.v[c], acc[j][c]);
    }
  }
}

// Bytes of the ring, or of the K > 1 groups' partial sums where those are
// more: they share the start of shared memory.
template <typename XU, int RC, int V>
__host__ __device__ constexpr size_t ring_bytes(int threads, int splits) {
  const size_t ring = (size_t)kStages * kStageAgents * threads * sizeof(XU);
  const size_t part = splits > 1 ? (size_t)RC * V * threads * sizeof(float) : 0;
  return ring > part ? ring : part;
}

// Shared memory: the ring (kStages * kStageAgents * blockDim units; after
// the agent loop, the groups' partial sums), then the chunk's weights
// wt[a*RC + j] = W[r0 + j, a] (zero past R), then 4*RC floats of per-row
// values (BUILD: mass; else retained, safe, guard), then (BUILD) each
// agent's masked weight and row.  SPLIT: the agents split over p.splits
// groups; a separate kernel, because the run-time group arithmetic in the
// unsplit kernel made perception-scale agg_blend 1-10% slower (at 79
// registers, 3 blocks an SM, or at 64 under a launch bound).
template <typename TX, typename TO, int RC, int V, bool BUILD, bool SPLIT>
__global__ void __launch_bounds__(kRingThreads) agg_blend_ring_kernel(
    RingArgs args) {
  const RingArgs p = scenario_view(args, blockIdx.y);   // this scenario's
  using XU = typename Vec<TX, V>::type;
  using OU = typename Vec<TO, V>::type;
  extern __shared__ float4 smem4[];
  const int T = blockDim.x, tid = threadIdx.x;
  const int A = p.a1 + p.a2;
  // K agent groups of L threads; group g sums agents [a_lo, a_hi) for the
  // block's L units, thread l of it for unit j (unsplit: constants, so the
  // kernel is the plain one)
  const int K = SPLIT ? p.splits : 1, L = SPLIT ? T / K : T;
  const int g = SPLIT ? tid / L : 0, l = SPLIT ? tid % L : tid;
  const int a_lo = SPLIT ? g * A / K : 0, a_hi = SPLIT ? (g + 1) * A / K : A;
  // the partial sums reuse the ring's bytes once every copy has landed
  XU* ring = reinterpret_cast<XU*>(smem4);
  float* partial = reinterpret_cast<float*>(smem4);
  float* wt = reinterpret_cast<float*>(
      reinterpret_cast<char*>(smem4) + ring_bytes<XU, RC, V>(T, K));
  float* rowc = wt + (size_t)A * RC;
  float* wa = rowc + 4 * RC;              // BUILD: weights[a] * mask[a]
  int* ra = reinterpret_cast<int*>(wa + A);   // BUILD: row of agent a, or -1
  const XU* X1 = static_cast<const XU*>(p.x1);
  const XU* X2 = static_cast<const XU*>(p.x2);
  const OU* buf = static_cast<const OU*>(p.buf);
  OU* out = static_cast<OU*>(p.out);
  const int64_t units = p.N / V;          // units a row
  const int64_t j = (int64_t)blockIdx.x * L + l;
  const bool live = j < units;
  const int n_stages = (a_hi - a_lo + kStageAgents - 1) / kStageAgents;

  auto load_stage = [&](int s) {
    if (!live || s >= n_stages) return;
    XU* slot = ring + (size_t)(s % kStages) * kStageAgents * T + tid;
#pragma unroll
    for (int i = 0; i < kStageAgents; ++i) {
      const int a = a_lo + s * kStageAgents + i;
      if (a < a_hi) {
        const XU* src = a < p.a1 ? X1 + (int64_t)a * units + j
                                 : X2 + (int64_t)(a - p.a1) * units + j;
        copy_unit(slot + (size_t)i * T, src);
      }
    }
  };

  // no early return: every thread takes part in building the weights and
  // in the barriers
  for (int r0 = 0; r0 < p.R; r0 += RC) {
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      load_stage(s);
      cp_async_commit();
    }

    if constexpr (BUILD) {
      // each agent's masked weight and row once, coalesced, then the
      // masses and W from shared memory
      for (int a = tid; a < A; a += T) {
        const int64_t r = agent_row(p, a);
        wa[a] = agent_weight(p, a);
        ra[a] = r >= 0 && r < p.R ? (int)r : -1;
      }
      __syncthreads();
      const int warp = tid / 32, lane = tid % 32, nwarps = T / 32;
      for (int jj = warp; jj < RC; jj += nwarps) {
        const int r = r0 + jj;
        float s = 0.f;
        for (int a = lane; a < A; a += 32) {
          if (ra[a] == r) s += wa[a];
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          s += __shfl_xor_sync(0xffffffffu, s, off);
        }
        if (lane == 0) rowc[jj] = s;
      }
      __syncthreads();
      if (blockIdx.x == 0 && p.mass_out && tid < RC && r0 + tid < p.R) {
        p.mass_out[r0 + tid] = rowc[tid];
      }
      for (int i = tid; i < A * RC; i += T) {
        const int a = i / RC, jj = i % RC;
        const float m = rowc[jj];
        wt[i] = ra[a] == r0 + jj && m > 0.f ? wa[a] / m : 0.f;
      }
    } else {
#pragma unroll 4
      for (int i = tid; i < A * RC; i += T) {
        const int a = i / RC, jj = i % RC, r = r0 + jj;
        float v = 0.f;
        if (r < p.R) {
          v = a < p.a1 ? p.w1[(int64_t)r * p.a1 + a]
                       : p.w2[(int64_t)r * p.a2 + (a - p.a1)];
        }
        wt[i] = v;
      }
      for (int jj = tid; jj < RC; jj += T) {
        const int r = r0 + jj;
        rowc[3 * jj + 0] = r < p.R ? p.coef[r * 3 + 0] : 0.f;
        rowc[3 * jj + 1] = r < p.R ? p.coef[r * 3 + 1] : 1.f;
        rowc[3 * jj + 2] = r < p.R ? p.coef[r * 3 + 2] : 0.f;
      }
    }
    __syncthreads();

    float acc[RC][V];
#pragma unroll
    for (int jj = 0; jj < RC; ++jj) {
#pragma unroll
      for (int c = 0; c < V; ++c) acc[jj][c] = 0.f;
    }
    for (int k = 0; k < n_stages; ++k) {
      cp_async_wait<kStages - 2>();     // stage k has landed
      load_stage(k + kStages - 1);      // into the slot read at k - 1
      cp_async_commit();
      if (live) {
        const XU* slot = ring + (size_t)(k % kStages) * kStageAgents * T + tid;
#pragma unroll
        for (int i = 0; i < kStageAgents; ++i) {
          const int a = a_lo + k * kStageAgents + i;
          if (a < a_hi) {
            fma_rows<RC, V>(acc, wt + (size_t)a * RC, widen(slot[(size_t)i * T]));
          }
        }
      }
    }
    cp_async_wait<0>();

    // out[r0 + jj, unit jn] from its sum v: the blend with buf
    auto finish = [&](int jj, int64_t jn, float (&v)[2]) {
      const int64_t o = (int64_t)(r0 + jj) * units + jn;
      float retained = 0.f, safe = 1.f;
      bool guard;
      if constexpr (BUILD) {
        guard = rowc[jj] > 0.f;
      } else {
        retained = rowc[3 * jj];
        safe = rowc[3 * jj + 1];
        guard = rowc[3 * jj + 2] > 0.f;
      }
      if (guard && retained == 0.f) {
        if constexpr (!BUILD) {
#pragma unroll
          for (int c = 0; c < V; ++c) v[c] = v[c] / safe;
        }
      } else {
        const F2 b = widen(buf[o]);
#pragma unroll
        for (int c = 0; c < V; ++c) {
          v[c] = guard ? (retained * b.v[c] + v[c]) / safe : b.v[c];
        }
      }
      narrow(out + o, v);
    };

    if constexpr (!SPLIT) {
      if (live) {
#pragma unroll
        for (int jj = 0; jj < RC; ++jj) {
          if (r0 + jj >= p.R) break;
          float v[2] = {acc[jj][0], acc[jj][V - 1]};
          finish(jj, j, v);
        }
      }
    } else {
      // partial[((g*RC + jj)*V + c)*L + l]; then each (row, unit) of the
      // block adds its K partials in group order
      __syncthreads();   // every thread is done with its ring
#pragma unroll
      for (int jj = 0; jj < RC; ++jj) {
#pragma unroll
        for (int c = 0; c < V; ++c) {
          partial[((g * RC + jj) * V + c) * L + l] = acc[jj][c];
        }
      }
      __syncthreads();
      for (int e = tid; e < RC * L; e += T) {
        const int jj = e / L, le = e % L;
        const int64_t jn = (int64_t)blockIdx.x * L + le;
        if (r0 + jj >= p.R || jn >= units) continue;
        float v[2] = {0.f, 0.f};
        for (int gg = 0; gg < K; ++gg) {
#pragma unroll
          for (int c = 0; c < V; ++c) {
            v[c] += partial[((gg * RC + jj) * V + c) * L + le];
          }
        }
        finish(jj, jn, v);
      }
    }
    __syncthreads();   // this chunk's smem is read before the next's
  }
}

template <typename TX, typename TO, int RC, int V, bool BUILD>
cudaError_t ring_launch(RingArgs p, cudaStream_t stream) {
  using XU = typename Vec<TX, V>::type;
  const int64_t units = p.N / V;
  const int A = p.a1 + p.a2;
  const size_t w_bytes =
      ((size_t)(RC + (BUILD ? 2 : 0)) * A + 4 * RC) * sizeof(float);
  auto smem = [&](int t, int k) {
    return ring_bytes<XU, RC, V>(t, k) + w_bytes;
  };
  auto blocks = [&](int t, int k) {
    const int64_t per_block = t / k;
    return (units + per_block - 1) / per_block;
  };
  // the fewest agent groups that give one scenario two blocks an SM, else
  // the most (each group keeps at least one agent; the partials must fit);
  // fewer threads only where the weights leave too little shared memory.
  // The choice does not depend on S, so a scenario's sums run in the same
  // order in a sweep as alone.
  const int sms = cached_sm_count();
  int T = kRingThreads;
  p.splits = 1;
  while (blocks(T, p.splits) < 2 * sms && 2 * p.splits <= kMaxSplits &&
         2 * p.splits <= A && smem(T, 2 * p.splits) <= kMaxSmem)
    p.splits *= 2;
  while (T > 64 && smem(T, p.splits) > kMaxSmem) T /= 2;
  const size_t bytes = smem(T, p.splits);
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = p.splits > 1 ? agg_blend_ring_kernel<TX, TO, RC, V, BUILD, true>
                             : agg_blend_ring_kernel<TX, TO, RC, V, BUILD, false>;
  if (bytes > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((unsigned)blocks(T, p.splits), (unsigned)p.S);
  kernel<<<grid, T, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename TX, typename TO, bool BUILD>
cudaError_t ring_by_rows(const RingArgs& p, bool vec2, cudaStream_t s) {
  const int R = p.R;
  if (vec2) {
    if (R <= 1) return ring_launch<TX, TO, 1, 2, BUILD>(p, s);
    if (R <= 2) return ring_launch<TX, TO, 2, 2, BUILD>(p, s);
    if (R <= 4) return ring_launch<TX, TO, 4, 2, BUILD>(p, s);
    if (R <= 8) return ring_launch<TX, TO, 8, 2, BUILD>(p, s);
    if (R <= 12) return ring_launch<TX, TO, 12, 2, BUILD>(p, s);
    return ring_launch<TX, TO, 16, 2, BUILD>(p, s);
  }
  if (R <= 1) return ring_launch<TX, TO, 1, 1, BUILD>(p, s);
  if (R <= 2) return ring_launch<TX, TO, 2, 1, BUILD>(p, s);
  if (R <= 4) return ring_launch<TX, TO, 4, 1, BUILD>(p, s);
  if (R <= 8) return ring_launch<TX, TO, 8, 1, BUILD>(p, s);
  if (R <= 12) return ring_launch<TX, TO, 12, 1, BUILD>(p, s);
  return ring_launch<TX, TO, 16, 1, BUILD>(p, s);
}

bool aligned(const void* ptr, size_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

template <bool BUILD>
int ring_dispatch(const RingArgs& p, int x_bf16, int out_bf16,
                  cudaStream_t s) {
  const size_t sx = x_bf16 ? 2 : 4, so = out_bf16 ? 2 : 4;
  const bool vec2 = p.N % 2 == 0 && aligned(p.x1, 2 * sx) &&
                    (!p.x2 || aligned(p.x2, 2 * sx)) &&
                    aligned(p.buf, 2 * so) && aligned(p.out, 2 * so);
  if (!x_bf16 && !out_bf16) return (int)ring_by_rows<float, float, BUILD>(p, vec2, s);
  if (x_bf16 && out_bf16) {
    return (int)ring_by_rows<__nv_bfloat16, __nv_bfloat16, BUILD>(p, vec2, s);
  }
  if (x_bf16) return (int)ring_by_rows<__nv_bfloat16, float, BUILD>(p, vec2, s);
  return (int)cudaErrorNotSupported;
}

// ---------------------------------------------------------------------------
// Matmul kernels (weighted_agg_matmul)
// ---------------------------------------------------------------------------

template <int RC>
__host__ __device__ constexpr int cols_per_thread() {
  return RC >= 16 ? 2 : (RC >= 8 ? 4 : 8);
}

struct MatmulArgs {
  const float* w;     // (S, R, A), or one (R, A) every scenario shares
  const void* x;      // (S, A, N)
  int a;
  void* out;          // (S, R, N) in X's dtype or fp32
  int R;
  int64_t N;
  int splits;         // K: agent groups a block (1, 2, 4, 8 or 16)
  int S;              // scenarios (gridDim.y)
  int64_t w_s;        // floats from one scenario's W to the next (0: shared)
  int tile;           // agents a staged weight tile (a itself where it fits)
};

// Weights a tile stages past the shared-memory limit of a whole W chunk:
// with the split's partial sums (at most 32 KB) three blocks fit an SM.
constexpr size_t kTileBytes = 32 * 1024;

// Stage W rows [r0, r0 + RC) of agents [t0, t0 + tn) transposed:
// wt[i*RC + j] = W[r0 + j, t0 + i], zero past R.
template <int RC>
__device__ __forceinline__ void stage(float* wt, const float* W, int A, int R,
                                      int r0, int t0, int tn) {
  for (int i = threadIdx.x; i < tn * RC; i += kThreads) {
    const int a = i / RC, j = i % RC;
    wt[i] = r0 + j < R ? W[(int64_t)(r0 + j) * A + t0 + a] : 0.f;
  }
}

// acc[j][c] += w[j] * xv[c]: one agent's weights (w = wt + a*RC) times its
// C loaded values.
template <int RC, int C>
__device__ __forceinline__ void fma_cols(float (&acc)[RC][C], const float* w,
                                         const float (&xv)[C]) {
  if constexpr (RC % 4 == 0) {
#pragma unroll
    for (int q = 0; q < RC / 4; ++q) {
      const float4 w4 = reinterpret_cast<const float4*>(w)[q];
      const float ws[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          acc[4 * q + k][c] = fmaf(ws[k], xv[c], acc[4 * q + k][c]);
        }
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < RC; ++j) {
      const float wj = w[j];
#pragma unroll
      for (int c = 0; c < C; ++c) acc[j][c] = fmaf(wj, xv[c], acc[j][c]);
    }
  }
}

// acc[j][c] += sum_a wt[a*RC + j] * X[a, base + c*kThreads], agents in
// ascending order.
template <typename TX, int RC, int C>
__device__ __forceinline__ void accumulate(float (&acc)[RC][C],
                                           const float* wt,
                                           const TX* __restrict__ X, int A,
                                           int64_t base, int64_t N) {
  const bool full = base + (int64_t)(C - 1) * kThreads < N;
#pragma unroll 2
  for (int a = 0; a < A; ++a) {
    const TX* row = X + (int64_t)a * N;
    float xv[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int64_t n = base + (int64_t)c * kThreads;
      xv[c] = (full || n < N) ? to_f32(row[n]) : 0.f;
    }
    fma_cols<RC, C>(acc, wt + a * RC, xv);
  }
}

// The same over agents [a0, a1) for columns base + c*stride: one agent
// group of the split kernel.  The unsplit kernel keeps its own loop with
// the constant stride: sharing one loop with a run-time stride made it up
// to 1.5x slower at perception scale (NVIDIA H100 80GB HBM3, 700 W).
template <typename TX, int RC, int C>
__device__ __forceinline__ void accumulate_group(float (&acc)[RC][C],
                                                 const float* wt,
                                                 const TX* __restrict__ X,
                                                 int a0, int a1, int64_t base,
                                                 int stride, int64_t N) {
  const bool full = base + (int64_t)(C - 1) * stride < N;
  for (int a = a0; a < a1; ++a) {
    const TX* row = X + (int64_t)a * N;
    float xv[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int64_t n = base + (int64_t)c * stride;
      xv[c] = (full || n < N) ? to_f32(row[n]) : 0.f;
    }
    fma_cols<RC, C>(acc, wt + a * RC, xv);
  }
}

// Every agent for C columns a thread: large N.  Four blocks an SM (at most
// 64 registers): the scenario's base pointers took RC = 16 to 70
// registers and three blocks, 14% slower at perception scale.
template <typename TX, typename TO, int RC>
__global__ void __launch_bounds__(kThreads, 4) matmul_kernel(MatmulArgs p) {
  constexpr int C = cols_per_thread<RC>();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  // this block's scenario
  const int64_t sc = blockIdx.y;
  const float* W = p.w + sc * p.w_s;
  const TX* X = static_cast<const TX*>(p.x) + sc * p.a * p.N;
  TO* out = static_cast<TO*>(p.out) + sc * p.R * p.N;
  const int64_t base = (int64_t)blockIdx.x * (kThreads * C) + threadIdx.x;

  // no early return: every thread takes part in staging and the barriers
  for (int r0 = 0; r0 < p.R; r0 += RC) {
    float acc[RC][C];
#pragma unroll
    for (int j = 0; j < RC; ++j) {
#pragma unroll
      for (int c = 0; c < C; ++c) acc[j][c] = 0.f;
    }
    for (int t0 = 0; t0 < p.a; t0 += p.tile) {
      const int tn = min(p.tile, p.a - t0);
      __syncthreads();  // the previous tile's reads of smem are done
      stage<RC>(smem, W, p.a, p.R, r0, t0, tn);
      __syncthreads();
      accumulate<TX, RC, C>(acc, smem, X + (int64_t)t0 * p.N, tn, base, p.N);
    }

#pragma unroll
    for (int j = 0; j < RC; ++j) {
      const int r = r0 + j;
      if (r >= p.R) break;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int64_t n = base + (int64_t)c * kThreads;
        if (n < p.N) out[(int64_t)r * p.N + n] = from_f32<TO>(acc[j][c]);
      }
    }
  }
}

// The agents split over K = p.splits groups of L = 256/K threads: small N.
// Group s sums agents [s*A/K, (s+1)*A/K) (with agent tiles, the s-th K-th of
// each tile) for C columns of the block's L*C, then every thread adds the K
// partials of some outputs in group order.
template <typename TX, typename TO, int RC>
__global__ void __launch_bounds__(kThreads) matmul_split_kernel(MatmulArgs p) {
  constexpr int C = cols_per_thread<RC>();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  // this block's scenario
  const int64_t sc = blockIdx.y;
  const float* W = p.w + sc * p.w_s;
  float* partial = smem + RC * p.tile;
  const TX* X = static_cast<const TX*>(p.x) + sc * p.a * p.N;
  TO* out = static_cast<TO*>(p.out) + sc * p.R * p.N;
  const int K = p.splits, L = kThreads / K;
  const int s = threadIdx.x / L, l = threadIdx.x % L;
  const int64_t col0 = (int64_t)blockIdx.x * (L * C);   // block's first

  for (int r0 = 0; r0 < p.R; r0 += RC) {
    float acc[RC][C];
#pragma unroll
    for (int j = 0; j < RC; ++j) {
#pragma unroll
      for (int c = 0; c < C; ++c) acc[j][c] = 0.f;
    }
    // group s sums the s-th K-th of every tile (of all A with one tile)
    for (int t0 = 0; t0 < p.a; t0 += p.tile) {
      const int tn = min(p.tile, p.a - t0);
      __syncthreads();  // the previous tile's (and sums') reads of smem
      stage<RC>(smem, W, p.a, p.R, r0, t0, tn);
      __syncthreads();
      accumulate_group<TX, RC, C>(acc, smem, X + (int64_t)t0 * p.N,
                                  s * tn / K, (s + 1) * tn / K, col0 + l, L,
                                  p.N);
    }
    // partial[((s*RC + j)*C + c)*L + l]: group s's sum for row j, column
    // col0 + c*L + l; then output e = (j*C + c)*L + l sums its K partials
#pragma unroll
    for (int j = 0; j < RC; ++j) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        partial[((s * RC + j) * C + c) * L + l] = acc[j][c];
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < RC * C * L; e += kThreads) {
      const int r = r0 + e / (C * L);
      const int64_t n = col0 + e % (C * L);
      if (r >= p.R || n >= p.N) continue;
      float v = 0.f;
      for (int g = 0; g < K; ++g) v += partial[g * RC * C * L + e];
      out[(int64_t)r * p.N + n] = from_f32<TO>(v);
    }
  }
}

template <typename TX, typename TO, int RC>
cudaError_t matmul_launch(MatmulArgs p, cudaStream_t stream) {
  constexpr int C = cols_per_thread<RC>();
  // all of A in one tile where it fits, else tiles of kTileBytes
  p.tile = (size_t)RC * p.a * sizeof(float) <= kMaxSmem
               ? p.a
               : (int)(kTileBytes / (RC * sizeof(float)));
  const size_t stage_bytes = (size_t)RC * p.tile * sizeof(float);
  // the fewest agent groups that give one scenario two blocks an SM, else
  // the most (each group keeps at least one agent; the partials must fit);
  // as in the ring kernel, not a function of S
  const int sms = cached_sm_count();
  const size_t partial_bytes = (size_t)RC * C * kThreads * sizeof(float);
  auto blocks = [&](int k) {
    const int64_t per_block = (int64_t)(kThreads / k) * C;
    return (p.N + per_block - 1) / per_block;
  };
  p.splits = 1;
  while (blocks(p.splits) < 2 * sms && 2 * p.splits <= kMaxSplits &&
         2 * p.splits <= p.a && stage_bytes + partial_bytes <= kMaxSmem)
    p.splits *= 2;
  const size_t smem = stage_bytes + (p.splits > 1 ? partial_bytes : 0);
  auto kernel = p.splits > 1 ? matmul_split_kernel<TX, TO, RC>
                             : matmul_kernel<TX, TO, RC>;
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((unsigned)blocks(p.splits), (unsigned)p.S);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename TX, typename TO>
cudaError_t matmul_by_rows(const MatmulArgs& p, cudaStream_t s) {
  if (p.R <= 1) return matmul_launch<TX, TO, 1>(p, s);
  if (p.R <= 2) return matmul_launch<TX, TO, 2>(p, s);
  if (p.R <= 4) return matmul_launch<TX, TO, 4>(p, s);
  if (p.R <= 8) return matmul_launch<TX, TO, 8>(p, s);
  return matmul_launch<TX, TO, 16>(p, s);
}

}  // namespace

// flags of repro_agg_blend: bit 0 X in bf16, bit 1 out in bf16, bits 2-3 the
// mask's kind (0 none, 1 fp32, 2 bool), bits 4-5 assign's (0 none: every
// agent on row 0, 1 int32, 2 int64), bits 6 / 7 / 8 weights / mask /
// assign one (A,) row that every scenario shares (else (S, A)).
//
// For each of the S scenarios: out = where(mass > 0, (wm / mass) @ X, buf)
// with wm[r, a] = [assign[a] == r] * weights[a] * mask[a] and mass its row
// sums, written to mass_out (S, R) when that is not null: agg_blend (R RSUs
// over A agents) and, with assign and mask null, cloud_blend (R = 1 over the
// A RSUs).  X is (S, A, N), buf and out (S, R, N).  Returns
// cudaGetLastError() after the launch (0 == cudaSuccess), or an error code
// without launching.  The caller checks shapes, dtypes, devices and
// contiguity and guarantees R, N, A >= 1 and 1 <= S <= 65535.
extern "C" int repro_agg_blend(const void* x, const void* weights,
                               const void* mask, const void* assign, int A,
                               int R, long long N, const void* buf, void* out,
                               void* mass_out, int flags, int S,
                               void* stream) {
  const int64_t sx = flags & 1 ? 2 : 4, so = flags & 2 ? 2 : 4;
  const int mask_kind = (flags >> 2) & 3, assign_kind = (flags >> 4) & 3;
  RingArgs p{};
  p.S = S;
  p.weights_sb = flags & 64 ? 0 : (int64_t)A * 4;
  p.mask_sb = flags & 128 ? 0 : (int64_t)A * (mask_kind == 2 ? 1 : 4);
  p.assign_sb = flags & 256 ? 0 : (int64_t)A * (assign_kind == 2 ? 8 : 4);
  p.x1_sb = (int64_t)A * N * sx;
  p.buf_sb = p.out_sb = (int64_t)R * N * so;
  p.weights = static_cast<const float*>(weights);
  p.mask = mask;
  p.mask_kind = mask_kind;
  p.assign = assign;
  p.assign_kind = assign_kind;
  p.mass_out = static_cast<float*>(mass_out);
  p.x1 = x;
  p.a1 = A;
  p.buf = buf;
  p.out = out;
  p.R = R;
  p.N = (int64_t)N;
  return ring_dispatch<true>(p, flags & 1, (flags >> 1) & 1,
                             static_cast<cudaStream_t>(stream));
}

// The coef form, for 1 or 2 (W, X) pairs (a second pair where w2 is not
// null), for each of S scenarios: coef (S, R, 3), W_i (S, R, a_i), X_i (S,
// a_i, N), buf and out (S, R, N).  out is in X's dtype or fp32, buf in
// out's.  Returns as above; the caller guarantees R, N, a1 >= 1 and
// 1 <= S <= 65535.
extern "C" int repro_fused_agg_blend(const void* coef, const void* w1,
                                     const void* x1, int a1, const void* w2,
                                     const void* x2, int a2, const void* buf,
                                     void* out, int R, long long N, int x_bf16,
                                     int out_bf16, int S, void* stream) {
  const int64_t sx = x_bf16 ? 2 : 4, so = out_bf16 ? 2 : 4;
  RingArgs p{};
  p.S = S;
  p.x1_sb = (int64_t)a1 * N * sx;
  p.x2_sb = w2 ? (int64_t)a2 * N * sx : 0;
  p.buf_sb = p.out_sb = (int64_t)R * N * so;
  p.coef = static_cast<const float*>(coef);
  p.w1 = static_cast<const float*>(w1);
  p.x1 = x1;
  p.a1 = a1;
  p.w2 = static_cast<const float*>(w2);
  p.x2 = w2 ? x2 : nullptr;
  p.a2 = w2 ? a2 : 0;
  p.buf = buf;
  p.out = out;
  p.R = R;
  p.N = (int64_t)N;
  return ring_dispatch<false>(p, x_bf16, out_bf16,
                              static_cast<cudaStream_t>(stream));
}

// The plain matmul for each of S scenarios, out[s] = W[s] @ X[s]: X (S, A,
// N), out (S, R, N), W (S, R, A) or (bit 2 of dtypes) one (R, A) matrix
// every scenario shares.  dtypes: bit 0 X in bf16, bit 1 out in bf16 (out
// is in X's dtype, or fp32 for a bf16 X).  Returns as above; the caller
// guarantees R, N, A >= 1 and 1 <= S <= 65535.
extern "C" int repro_weighted_agg_matmul(const void* w, const void* x,
                                         void* out, int R, int A, long long N,
                                         int dtypes, int S, void* stream) {
  MatmulArgs p{static_cast<const float*>(w), x, A, out, R, (int64_t)N, 1, S,
               dtypes & 4 ? 0 : (int64_t)R * A, A};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtypes & 3) {
    case 0: return (int)matmul_by_rows<float, float>(p, s);
    case 1: return (int)matmul_by_rows<__nv_bfloat16, float>(p, s);
    case 3: return (int)matmul_by_rows<__nv_bfloat16, __nv_bfloat16>(p, s);
    default: return (int)cudaErrorNotSupported;
  }
}
