// Dual-proximal SGD update for Hopper (sm_90a): paper Alg. 1 l.4, Eq. 6.
//
//   out[a,n] = w[a,n] - (lr*scale[a]) * (g[a,n] + mu1*(w[a,n] - a1[a,n])
//                                               + mu2*(w[a,n] - a2[a,n]))
//
// Replaces the Pallas kernel dual_proximal_sgd (body _update_kernel) of
// src/repro/kernels/dual_proximal_sgd.py, and computes the flat engine's
// inline step (src/repro/fedsim/simulator.py, _local_train_flat) exactly:
// scale[a] is the per-agent step mask `live` (null means 1), and a1 / a2
// may each be a full (A, N) array or one (N,) row broadcast over the A rows
// (row stride 0; the cloud master).  w, g and out are fp32; a1 and a2 are
// fp32 or bf16; arithmetic is fp32.  A term whose mu is 0 is dropped and its
// anchor not read, as in the TPU kernel.
//
// Bound: bytes.  w, g and a1 are read once and out written once, 4*A*N*4
// bytes for fp32, plus a2 (N*4 bytes when broadcast); about nine flops an
// element are far below the fp32 ridge.
//
// Design (simple first): blockIdx.y is the agent row, so the per-row scale
// and the broadcast row need no division; each thread updates one element
// with coalesced scalar loads.  It gives up 16-byte vector loads (rows of a
// ragged N are not 16-byte aligned) and a grid-stride loop.  w and out may
// alias (the in-place update of the training loop): each element is read and
// then written by the same thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

struct Args {
  float* out;
  const float* w;
  const float* g;
  const void* a1;
  int64_t a1_stride;  // N for a full (A, N) anchor, 0 for one broadcast row
  const void* a2;
  int64_t a2_stride;
  const float* scale;  // (A,) or null
  int64_t N;
  float lr, mu1, mu2;
};

template <typename TA1, typename TA2>
__global__ void __launch_bounds__(kThreads) dual_proximal_sgd_kernel(Args p) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= p.N) return;
  const int64_t row = blockIdx.y;
  const int64_t i = row * p.N + n;
  const float wv = p.w[i];
  float step = p.g[i];
  if (p.mu1 != 0.f) {
    step += p.mu1 * (wv - to_f32(static_cast<const TA1*>(p.a1)[row * p.a1_stride + n]));
  }
  if (p.mu2 != 0.f) {
    step += p.mu2 * (wv - to_f32(static_cast<const TA2*>(p.a2)[row * p.a2_stride + n]));
  }
  const float lr = p.scale ? p.lr * p.scale[row] : p.lr;
  p.out[i] = wv - lr * step;
}

template <typename TA1, typename TA2>
cudaError_t launch(const Args& p, int A, cudaStream_t stream) {
  const dim3 grid((unsigned)((p.N + kThreads - 1) / kThreads), (unsigned)A);
  dual_proximal_sgd_kernel<TA1, TA2><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 == cudaSuccess).
// a1_bf16 / a2_bf16 select the anchors' dtypes (0: fp32, 1: bf16); the
// caller checks shapes, dtypes, devices and contiguity and guarantees
// 1 <= A <= 65535 and N >= 1.
extern "C" int repro_dual_proximal_sgd(void* out, const void* w, const void* g,
                                       const void* a1, long long a1_stride,
                                       int a1_bf16, const void* a2,
                                       long long a2_stride, int a2_bf16,
                                       const void* scale, int A, long long N,
                                       float lr, float mu1, float mu2,
                                       void* stream) {
  Args p{static_cast<float*>(out), static_cast<const float*>(w),
         static_cast<const float*>(g), a1, (int64_t)a1_stride, a2,
         (int64_t)a2_stride, static_cast<const float*>(scale), (int64_t)N,
         lr, mu1, mu2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a1_bf16) {
    return a2_bf16 ? (int)launch<__nv_bfloat16, __nv_bfloat16>(p, A, s)
                   : (int)launch<__nv_bfloat16, float>(p, A, s);
  }
  return a2_bf16 ? (int)launch<float, __nv_bfloat16>(p, A, s)
                 : (int)launch<float, float>(p, A, s);
}
