// Forward sLSTM scan for Hopper (sm_90a): the whole recurrence in one launch.
//
// Per batch row, from (c, n, h, m) = (0, 0, 0, -1e30), for t = 0 .. S-1:
//
//   g   = wx[b,t] + headmajor(h @ R) + bias          (4d gate pre-activations)
//   [i | f | z | o] = g;  i, f <- 15 tanh(. / 15)   (the gate soft cap)
//   logf = log_sigmoid(f),  m' = max(logf + m, i)
//   i' = exp(i - m'),  f' = exp(logf + m - m')
//   c = f' c + i' tanh(z),  n = f' n + i',  h = sigmoid(o) c / max(n, 1)
//
// out[b,t] = h, fp32.  wx is (B, S, 4d) fp32, R is (H, P, 4P) bf16 or fp32
// (converted exactly to fp32), bias is (4d,) fp32, d = H*P; all contiguous.
// Everything is fp32: no TF32, no fast math.
//
// Replaces the Pallas kernel slstm_scan (body _slstm_kernel) of
// src/repro/kernels/slstm_scan.py.  As there, R, the bias and the running
// state stay on chip for the whole scan; only wx is read and h written.  The
// TPU's sequential sequence-block grid axis with state in VMEM scratch
// becomes a loop over t inside one launch: no padding, no block_s.
//
// The gate layout couples all heads.  h @ R is (H, 4P) per row, flattened
// head-major and split into four blocks of width d, so gate column
// j = gate*d + u reads head j / (4P), column j % (4P) of R[head], and the P
// values h[head*P : head*P + P].  For xlstm-125m (4P = d) the i gates of
// every unit come from head 0, the f gates from head 1, and so on: every
// step of a row needs the whole previous h.
//
// Bound: a recurrence.  The step's work (4d*P multiply-adds a row; 589,824 at
// xlstm-125m) is small and S steps run one after the other, so the time is
// S times the latency of one step; the card's flop and byte bounds are far
// below that.  What the design does about it:
// - One thread-block cluster per batch row, of C CTAs (1-8, the smallest
//   whose share of R fits in shared memory).  CTA r owns units
//   [r*d/C, (r+1)*d/C) and their four gates, one thread a gate column, and
//   keeps its columns of R resident in shared memory for the whole scan,
//   column-major with a padded stride so each thread reads 8 of its P
//   values in one conflict-free 16-byte load (bf16 R at d = 768: 8 CTAs of
//   150 KB each).
// - Each step: every column's dot product over P from the resident R and
//   h_{t-1} (fp32, shared memory); a CTA barrier; one thread per unit runs
//   the gate update with its (c, n, m) in registers, writes h to out and
//   pushes it into the next h buffer of every CTA of the cluster through
//   distributed shared memory; one cluster barrier (release / acquire)
//   publishes h_t.  h is double-buffered, so one cluster barrier a step is
//   enough: a CTA writes buffer t+1 while others may still read buffer t.
// - wx is read from device memory two steps ahead, so its latency stays off
//   the recurrence's critical path.
// - Where even 8 CTAs cannot hold their share of R (fp32 R at d = 768), the
//   columns read R from device memory (L2-resident) every step instead.
// Several rows share R, but they are kept in separate clusters: rows
// proceed in parallel on separate SMs and no row waits for another.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 8;    // the largest portable cluster
constexpr int kMaxThreads = 1024;
constexpr float kGateCap = 15.0f;

struct Params {
  float* out;          // (B, S, d)
  const float* wx;     // (B, S, 4d)
  const void* r;       // (H, P, 4P)
  const float* bias;   // (4d,)
  int S, P, d;
  int units;           // d / C: the units of one CTA
  int r_stride;        // row stride of the resident R columns, in elements
};

__device__ __forceinline__ float bf16_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// 8 consecutive R values of one column, as fp32 (exact for bf16).
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&r)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  r[0] = bf16_lo(v.x); r[1] = bf16_hi(v.x);
  r[2] = bf16_lo(v.y); r[3] = bf16_hi(v.y);
  r[4] = bf16_lo(v.z); r[5] = bf16_hi(v.z);
  r[6] = bf16_lo(v.w); r[7] = bf16_hi(v.w);
}
__device__ __forceinline__ void load8(const float* p, float (&r)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
  r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
}

__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(float v) { return v; }

// sum_p h[p] * col[p] over P (a multiple of 8), h in shared memory.
template <typename TR>
__device__ __forceinline__ float dot_resident(const TR* col, const float* h,
                                              int P) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  for (int p = 0; p < P; p += 8) {
    float r[8];
    load8(col + p, r);
    const float4 h0 = *reinterpret_cast<const float4*>(h + p);
    const float4 h1 = *reinterpret_cast<const float4*>(h + p + 4);
    a0 = fmaf(h0.x, r[0], a0);
    a1 = fmaf(h0.y, r[1], a1);
    a2 = fmaf(h0.z, r[2], a2);
    a3 = fmaf(h0.w, r[3], a3);
    a0 = fmaf(h1.x, r[4], a0);
    a1 = fmaf(h1.y, r[5], a1);
    a2 = fmaf(h1.z, r[6], a2);
    a3 = fmaf(h1.w, r[7], a3);
  }
  return (a0 + a1) + (a2 + a3);
}

// The same from R in device memory: col[p * ld], read through L2.
template <typename TR>
__device__ __forceinline__ float dot_global(const TR* col, int ld,
                                            const float* h, int P) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 2
  for (int p = 0; p < P; p += 4) {
    a0 = fmaf(h[p], to_float(col[(size_t)p * ld]), a0);
    a1 = fmaf(h[p + 1], to_float(col[(size_t)(p + 1) * ld]), a1);
    a2 = fmaf(h[p + 2], to_float(col[(size_t)(p + 2) * ld]), a2);
    a3 = fmaf(h[p + 3], to_float(col[(size_t)(p + 3) * ld]), a3);
  }
  return (a0 + a1) + (a2 + a3);
}

__device__ __forceinline__ float soft_cap(float x) {
  return kGateCap * tanhf(x / kGateCap);
}

// log(sigmoid(x)) = -softplus(-x), softplus(y) = max(y, 0) + log1p(exp(-|y|))
__device__ __forceinline__ float log_sigmoid(float x) {
  return -(fmaxf(-x, 0.f) + log1pf(expf(-fabsf(x))));
}

// One cluster per batch row; one thread per gate column of the CTA's units.
template <typename TR, bool kResident>
__global__ void __launch_bounds__(kMaxThreads, 1)
slstm_scan_kernel(Params p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.x / C;
  const int U = p.units, d = p.d, P = p.P, P4 = 4 * p.P, G = 4 * U;
  const int u0 = rank * U;                 // first unit of this CTA
  const int k = threadIdx.x;               // gate column (blockDim.x == G)
  const int j = (k / U) * d + u0 + k % U;  // its index among the 4d gates
  const int head = j / P4;

  extern __shared__ __align__(16) unsigned char smem[];
  float* hbuf = reinterpret_cast<float*>(smem);  // 2 x d: h_{t-1}, h_t
  float* gates = hbuf + 2 * d;                    // G pre-activations
  TR* rs = reinterpret_cast<TR*>(gates + G);      // G x r_stride columns

  const TR* R = static_cast<const TR*>(p.r);
  for (int i = k; i < d; i += G) hbuf[i] = 0.f;
  if (kResident) {
    // coalesced over q for each p; column kk of this CTA is gate column jj
    for (int i = k; i < P * G; i += G) {
      const int kk = i % G, pp = i / G;
      const int jj = (kk / U) * d + u0 + kk % U;
      rs[(size_t)kk * p.r_stride + pp] =
          R[((size_t)(jj / P4) * P + pp) * P4 + jj % P4];
    }
  }
  const TR* col = kResident ? rs + (size_t)k * p.r_stride
                            : R + (size_t)head * P * P4 + j % P4;
  const float bias = p.bias[j];
  float c = 0.f, n = 0.f, m = -1e30f;  // state of unit u0 + k, for k < U
  const size_t wx_step = (size_t)4 * d;
  const float* wx = p.wx + (size_t)row * p.S * wx_step + j;
  float* out = p.out + (size_t)row * p.S * d + u0 + k;
  float wx0 = p.S > 0 ? __ldg(wx) : 0.f;
  float wx1 = p.S > 1 ? __ldg(wx + wx_step) : 0.f;
  cluster.sync();  // R columns and h_0 in place in every CTA of the cluster

  for (int t = 0; t < p.S; ++t) {
    const float wx2 = t + 2 < p.S ? __ldg(wx + (t + 2) * wx_step) : 0.f;
    const float* h = hbuf + (t & 1) * d + head * P;
    const float rec = kResident ? dot_resident(col, h, P)
                                : dot_global(col, P4, h, P);
    gates[k] = (wx0 + rec) + bias;
    wx0 = wx1;
    wx1 = wx2;
    __syncthreads();
    if (k < U) {
      const float gi = soft_cap(gates[k]);
      const float gf = soft_cap(gates[U + k]);
      const float gz = gates[2 * U + k];
      const float go = gates[3 * U + k];
      const float logf = log_sigmoid(gf);
      const float m_new = fmaxf(logf + m, gi);
      const float i_p = expf(gi - m_new);
      const float f_p = expf(logf + m - m_new);
      c = f_p * c + i_p * tanhf(gz);
      n = f_p * n + i_p;
      m = m_new;
      const float hv = (1.f / (1.f + expf(-go))) * c / fmaxf(n, 1.f);
      out[(size_t)t * d] = hv;
      float* next = hbuf + ((t + 1) & 1) * d + u0 + k;
      for (int r = 0; r < C; ++r) *cluster.map_shared_rank(next, r) = hv;
    }
    cluster.sync();  // h_t visible in every CTA; buffer t free for t+2
  }
}

// Elements per resident column: P rounded up to 16 bytes, then padded so
// the stride is 4 words past a multiple of 32 (conflict-free 16-byte loads
// by consecutive threads).
int column_stride(int P, int esize) {
  int words = (P * esize + 15) / 16 * 4;
  while (words % 32 != 4) words += 4;
  return words * 4 / esize;
}

struct Plan {
  int cluster = 0;      // 0: the shape is not supported
  int resident = 0;     // R columns in shared memory
  int r_stride = 0;
  size_t smem = 0;
};

Plan make_plan(int d, int P, int esize, int smem_optin) {
  Plan plan;
  if (P <= 0 || P % 8 || d <= 0 || d % P) return plan;
  const int stride = column_stride(P, esize);
  int fallback = 0;
  for (int C = 1; C <= kMaxCluster; C *= 2) {
    if (d % C || 4 * (d / C) > kMaxThreads) continue;
    const int U = d / C;
    const size_t base = (size_t)2 * d * 4 + (size_t)4 * U * 4;
    const size_t bytes = base + (size_t)4 * U * stride * esize;
    if (bytes <= (size_t)smem_optin) {
      plan.cluster = C;
      plan.resident = 1;
      plan.r_stride = stride;
      plan.smem = bytes;
      return plan;
    }
    if (base <= (size_t)smem_optin) fallback = C;
  }
  if (fallback) {
    plan.cluster = fallback;
    plan.smem = (size_t)2 * d * 4 + (size_t)4 * (d / fallback) * 4;
  }
  return plan;
}

int smem_optin() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return bytes;
}

template <typename TR, bool kResident>
cudaError_t launch(const Params& p, int B, const Plan& plan,
                   cudaStream_t stream) {
  auto kernel = slstm_scan_kernel<TR, kResident>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(plan.smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * plan.cluster);
  cfg.blockDim = dim3(4 * p.units);
  cfg.dynamicSmemBytes = plan.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = plan.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// How the kernel would run a shape: cluster size (0: not supported) and
// whether R stays in shared memory.  Returns a CUDA error code.
extern "C" int repro_slstm_scan_plan(int d, int P, int r_bf16, int* cluster,
                                     int* resident) {
  const int optin = smem_optin();
  if (!optin) return static_cast<int>(cudaErrorInvalidDevice);
  const Plan plan = make_plan(d, P, r_bf16 ? 2 : 4, optin);
  *cluster = plan.cluster;
  *resident = plan.resident;
  return 0;
}

extern "C" int repro_slstm_scan(void* out, const void* wx, const void* r,
                                const void* bias, int B, int S, int H, int P,
                                int r_bf16, void* stream) {
  const int optin = smem_optin();
  if (!optin) return static_cast<int>(cudaErrorInvalidDevice);
  const int d = H * P;
  const Plan plan = make_plan(d, P, r_bf16 ? 2 : 4, optin);
  if (!plan.cluster || B <= 0 || S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.out = static_cast<float*>(out);
  p.wx = static_cast<const float*>(wx);
  p.r = r;
  p.bias = static_cast<const float*>(bias);
  p.S = S;
  p.P = P;
  p.d = d;
  p.units = d / plan.cluster;
  p.r_stride = plan.r_stride;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (r_bf16)
    err = plan.resident ? launch<__nv_bfloat16, true>(p, B, plan, s)
                        : launch<__nv_bfloat16, false>(p, B, plan, s);
  else
    err = plan.resident ? launch<float, true>(p, B, plan, s)
                        : launch<float, false>(p, B, plan, s);
  return static_cast<int>(err);
}
