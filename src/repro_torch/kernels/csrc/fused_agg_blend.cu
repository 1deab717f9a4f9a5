// Fused aggregate-and-blend for Hopper (sm_90a): the RSU layer (paper
// Alg. 2 l.8) and the cloud layer (Alg. 3 l.6) of the H2-Fed round.
//
// Replaces the Pallas kernels of src/repro/kernels/masked_hier_agg.py:
//   * _fused_agg_blend (body _make_fused_kernel) when has_buf != 0:
//       out[r,n] = guard[r] ? (retained[r]*buf[r,n] + sum_i W_i[r,:].X_i[:,n])
//                              / safe[r]
//                           : buf[r,n]
//     for 1 or 2 (W_i, X_i) pairs, coef (R,3) = [retained | safe | guard];
//   * weighted_agg_matmul (body _agg_kernel) when has_buf == 0:
//       out[r,n] = sum_a W[r,a].X[a,n], out in X's dtype.
// W and coef are fp32, X is fp32 or bf16, accumulation is fp32.
//
// Bound: bytes.  Each launch must read every X_i once and buf once and write
// out once: sum_i A_i*N*sizeof(X) + 2*R*N*sizeof(buf) (R*N*sizeof(X) out and
// no buf read for the plain matmul).  The arithmetic, 2*R*sum_i A_i flops a
// column, sits far below the fp32 ridge for the R of a few tens the engines
// use.
//
// Design.  RSU rows go in chunks of RC (the smallest of 1, 2, 4, 8, 16 that
// holds R, so R <= 16 is one pass over X).  A block of 256 threads owns a
// run of columns; the chunk's W rows are staged in shared memory
// transposed, agent-major and zero-padded to RC, so one 16-byte shared load
// feeds four rows and each weight serves C columns (C = 8 / 8 / 8 / 4 / 2
// for RC = 1 / 2 / 4 / 8 / 16: a thread keeps RC*C <= 32 accumulators and C
// loads in flight).  At large N each thread walks every agent for C
// columns t, t+256, ... of its block (256*C columns a block), so each X row
// read is coalesced and buf is read once, in the epilogue, where the blend
// is applied.  At small N that grid would leave most SMs idle (16 blocks at
// the main path's N = 31,810), so the host splits the agents over K groups
// of 256/K threads (K = 1, 2, 4, 8, 16, at most A; the smallest K that
// gives two blocks an SM, else the largest): group s sums its own run of
// agents for C columns of the block's 256*C/K, writes its partial sums to
// shared memory, and after a barrier every thread adds the K partials of
// some outputs in group order and applies the epilogue.  The order of every
// sum is fixed, so results are deterministic (no atomics).  What this
// design gives up: X is re-read from L2 once per chunk when R > 16, a
// thread loads one 2- or 4-byte word per column instead of 16 bytes (rows
// of a ragged N are not 16-byte aligned), padded rows cost FMAs on zeros,
// and A is limited by shared memory (RC*(A_1 + A_2)*4 bytes <= 227 KB; a
// split needs 32 KB more for the partials and is not taken where they do
// not fit).  buf and out may alias: each element is read and then written
// by the same thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <int RC>
__host__ __device__ constexpr int cols_per_thread() {
  return RC >= 16 ? 2 : (RC >= 8 ? 4 : 8);
}

struct Args {
  const float* coef;  // (R, 3) or null without buf
  const float* w1;    // (R, a1)
  const void* x1;     // (a1, N)
  int a1;
  const float* w2;    // (R, a2) or null
  const void* x2;     // (a2, N) or null
  int a2;
  const void* buf;    // (R, N) in out's dtype, or null
  void* out;          // (R, N)
  int R;
  int64_t N;
  int splits;         // K: agent groups a block (1, 2, 4, 8 or 16)
};

// Stage W rows [r0, r0 + RC) transposed: wt[a*RC + j] = W[r0 + j, a], zero
// past R.
template <int RC>
__device__ __forceinline__ void stage(float* wt, const float* W, int A, int R,
                                      int r0) {
  for (int i = threadIdx.x; i < A * RC; i += kThreads) {
    const int a = i / RC, j = i % RC;
    wt[i] = r0 + j < R ? W[(int64_t)(r0 + j) * A + a] : 0.f;
  }
}

// acc[j][c] += w[j] * xv[c]: one agent's weights (w = wt + a*RC) times its
// C loaded values.
template <int RC, int C>
__device__ __forceinline__ void fma_rows(float (&acc)[RC][C], const float* w,
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
    fma_rows<RC, C>(acc, wt + a * RC, xv);
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
    fma_rows<RC, C>(acc, wt + a * RC, xv);
  }
}

// out[r, n] from the sum v: the blend with buf, or v itself.
template <typename TO, bool HAS_BUF>
__device__ __forceinline__ void epilogue(const Args& p, const TO* buf, TO* out,
                                         int r, int64_t n, float v) {
  const int64_t o = (int64_t)r * p.N + n;
  if constexpr (HAS_BUF) {
    const float b = to_f32(buf[o]);
    v = p.coef[r * 3 + 2] > 0.f ? (p.coef[r * 3] * b + v) / p.coef[r * 3 + 1]
                                : b;
  }
  out[o] = from_f32<TO>(v);
}

// Every agent for C columns a thread: large N.
template <typename TX, typename TO, int NPAIRS, bool HAS_BUF, int RC>
__global__ void __launch_bounds__(kThreads) fused_agg_blend_kernel(Args p) {
  constexpr int C = cols_per_thread<RC>();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const TX* X1 = static_cast<const TX*>(p.x1);
  const TX* X2 = static_cast<const TX*>(p.x2);
  const TO* buf = static_cast<const TO*>(p.buf);
  TO* out = static_cast<TO*>(p.out);
  const int64_t base = (int64_t)blockIdx.x * (kThreads * C) + threadIdx.x;

  // no early return: every thread takes part in staging and the barriers
  for (int r0 = 0; r0 < p.R; r0 += RC) {
    __syncthreads();  // the previous chunk's reads of smem are done
    stage<RC>(smem, p.w1, p.a1, p.R, r0);
    if constexpr (NPAIRS == 2) stage<RC>(smem + p.a1 * RC, p.w2, p.a2, p.R, r0);
    __syncthreads();

    float acc[RC][C];
#pragma unroll
    for (int j = 0; j < RC; ++j) {
#pragma unroll
      for (int c = 0; c < C; ++c) acc[j][c] = 0.f;
    }
    accumulate<TX, RC, C>(acc, smem, X1, p.a1, base, p.N);
    if constexpr (NPAIRS == 2) {
      accumulate<TX, RC, C>(acc, smem + p.a1 * RC, X2, p.a2, base, p.N);
    }

#pragma unroll
    for (int j = 0; j < RC; ++j) {
      const int r = r0 + j;
      if (r >= p.R) break;
      float retained = 0.f, safe = 1.f, guard = 1.f;
      if constexpr (HAS_BUF) {
        retained = p.coef[r * 3 + 0];
        safe = p.coef[r * 3 + 1];
        guard = p.coef[r * 3 + 2];
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int64_t n = base + (int64_t)c * kThreads;
        if (n < p.N) {
          const int64_t o = (int64_t)r * p.N + n;
          float v = acc[j][c];
          if constexpr (HAS_BUF) {
            const float b = to_f32(buf[o]);
            v = guard > 0.f ? (retained * b + v) / safe : b;
          }
          out[o] = from_f32<TO>(v);
        }
      }
    }
  }
}

// The agents split over K = p.splits groups of L = 256/K threads: small N.
// Group s sums agents [s*A/K, (s+1)*A/K) of each pair for C columns of the
// block's L*C, then every thread adds the K partials of some outputs in
// group order.
template <typename TX, typename TO, int NPAIRS, bool HAS_BUF, int RC>
__global__ void __launch_bounds__(kThreads)
    fused_agg_blend_split_kernel(Args p) {
  constexpr int C = cols_per_thread<RC>();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* partial = smem + RC * (p.a1 + (NPAIRS == 2 ? p.a2 : 0));
  const TX* X1 = static_cast<const TX*>(p.x1);
  const TX* X2 = static_cast<const TX*>(p.x2);
  const TO* buf = static_cast<const TO*>(p.buf);
  TO* out = static_cast<TO*>(p.out);
  const int K = p.splits, L = kThreads / K;
  const int s = threadIdx.x / L, l = threadIdx.x % L;
  const int64_t col0 = (int64_t)blockIdx.x * (L * C);   // block's first

  for (int r0 = 0; r0 < p.R; r0 += RC) {
    __syncthreads();  // the previous chunk's reads of smem are done
    stage<RC>(smem, p.w1, p.a1, p.R, r0);
    if constexpr (NPAIRS == 2) stage<RC>(smem + p.a1 * RC, p.w2, p.a2, p.R, r0);
    __syncthreads();

    float acc[RC][C];
#pragma unroll
    for (int j = 0; j < RC; ++j) {
#pragma unroll
      for (int c = 0; c < C; ++c) acc[j][c] = 0.f;
    }
    accumulate_group<TX, RC, C>(acc, smem, X1, s * p.a1 / K,
                                (s + 1) * p.a1 / K, col0 + l, L, p.N);
    if constexpr (NPAIRS == 2) {
      accumulate_group<TX, RC, C>(acc, smem + p.a1 * RC, X2, s * p.a2 / K,
                                  (s + 1) * p.a2 / K, col0 + l, L, p.N);
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
      epilogue<TO, HAS_BUF>(p, buf, out, r, n, v);
    }
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return sms;
}

template <typename TX, typename TO, int NPAIRS, bool HAS_BUF, int RC>
cudaError_t launch(Args p, cudaStream_t stream) {
  constexpr int C = cols_per_thread<RC>();
  const size_t stage_bytes =
      (size_t)RC * (p.a1 + (NPAIRS == 2 ? p.a2 : 0)) * sizeof(float);
  if (stage_bytes > kMaxSmem) return cudaErrorInvalidValue;
  // the fewest agent groups that give two blocks an SM, else the most
  // (each group keeps at least one agent; the partials must fit)
  static const int sms = sm_count();
  const int agents = p.a1 > p.a2 ? p.a1 : p.a2;
  const size_t partial_bytes = (size_t)RC * C * kThreads * sizeof(float);
  auto blocks = [&](int k) {
    const int64_t per_block = (int64_t)(kThreads / k) * C;
    return (p.N + per_block - 1) / per_block;
  };
  p.splits = 1;
  while (blocks(p.splits) < 2 * sms && 2 * p.splits <= kMaxSplits &&
         2 * p.splits <= agents && stage_bytes + partial_bytes <= kMaxSmem)
    p.splits *= 2;
  const size_t smem = stage_bytes + (p.splits > 1 ? partial_bytes : 0);
  auto kernel = p.splits > 1
                    ? fused_agg_blend_split_kernel<TX, TO, NPAIRS, HAS_BUF, RC>
                    : fused_agg_blend_kernel<TX, TO, NPAIRS, HAS_BUF, RC>;
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<(unsigned)blocks(p.splits), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename TX, typename TO, int NPAIRS, bool HAS_BUF>
cudaError_t by_rows(const Args& p, cudaStream_t s) {
  if (p.R <= 1) return launch<TX, TO, NPAIRS, HAS_BUF, 1>(p, s);
  if (p.R <= 2) return launch<TX, TO, NPAIRS, HAS_BUF, 2>(p, s);
  if (p.R <= 4) return launch<TX, TO, NPAIRS, HAS_BUF, 4>(p, s);
  if (p.R <= 8) return launch<TX, TO, NPAIRS, HAS_BUF, 8>(p, s);
  return launch<TX, TO, NPAIRS, HAS_BUF, 16>(p, s);
}

template <typename TX, typename TO>
cudaError_t with_buf(const Args& p, cudaStream_t s) {
  return p.w2 ? by_rows<TX, TO, 2, true>(p, s)
              : by_rows<TX, TO, 1, true>(p, s);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 == cudaSuccess), or an
// error code without launching for an unsupported combination.
// x_bf16 / out_bf16 select the dtypes (0: fp32, 1: bf16).  A second pair
// (w2, x2) is used where w2 is not null.  With a buffer (buf not null) out
// is in X's dtype or fp32 and there are 1 or 2 pairs; without one out is in
// X's dtype and there is one pair.  The caller checks shapes, dtypes,
// devices and contiguity and guarantees R, N, a1 >= 1.
extern "C" int repro_fused_agg_blend(const void* coef, const void* w1,
                                     const void* x1, int a1, const void* w2,
                                     const void* x2, int a2, const void* buf,
                                     void* out, int R, long long N, int x_bf16,
                                     int out_bf16, void* stream) {
  Args p{static_cast<const float*>(coef), static_cast<const float*>(w1), x1,
         a1, static_cast<const float*>(w2), x2, a2, buf, out, R, (int64_t)N,
         1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (buf) {
    if (!x_bf16 && !out_bf16) return (int)with_buf<float, float>(p, s);
    if (x_bf16 && out_bf16) {
      return (int)with_buf<__nv_bfloat16, __nv_bfloat16>(p, s);
    }
    if (x_bf16) return (int)with_buf<__nv_bfloat16, float>(p, s);
    return (int)cudaErrorNotSupported;
  }
  if (w2 || x_bf16 != out_bf16) return (int)cudaErrorNotSupported;
  return x_bf16 ? (int)by_rows<__nv_bfloat16, __nv_bfloat16, 1, false>(p, s)
                : (int)by_rows<float, float, 1, false>(p, s);
}

// The plain matmul alone, out = W @ X in X's dtype: the same kernel with
// fewer arguments to pass, for the shortest host path.
extern "C" int repro_weighted_agg_matmul(const void* w, const void* x,
                                         void* out, int R, int A, long long N,
                                         int x_bf16, void* stream) {
  return repro_fused_agg_blend(nullptr, w, x, A, nullptr, nullptr, 0, nullptr,
                               out, R, N, x_bf16, x_bf16, stream);
}
