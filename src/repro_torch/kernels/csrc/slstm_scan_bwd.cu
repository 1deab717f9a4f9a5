// Backward of the sLSTM scan (slstm_scan.cu) for Hopper (sm_90a): the serial
// part of the gradient, the reverse scan over t.
//
// The forward step, per unit (see slstm_scan.cu), from the gate
// pre-activations g_t = [i | f | z | o] and the state (c, n, m) after step
// t-1:
//
//   gi = 15 tanh(i / 15),  gf = 15 tanh(f / 15),  a = log_sigmoid(gf) + m
//   m' = max(a, gi),  i' = exp(gi - m'),  f' = exp(a - m')
//   c' = f' c + i' tanh(z),  n' = f' n + i',  h = sigmoid(o) c' / max(n', 1)
//
// Given the upstream dh (B, S, d) fp32, the recomputed g (B, S, 4d) fp32 and
// the forward's saved state (B, S, 3, d) fp32 ((c, n, m) after each step),
// the kernel writes dg = dL/dg (B, S, 4d) fp32, which is also dL/dwx.  From
// t = S-1 down to 0 it carries (dc, dn, dm) of each unit and the recurrent
//
//   dh_{t-1}[head*P + p] = sum_q R[head, p, q] dg_t[head*4P + q],
//
// so every step's dh needs the whole dg_t of the row (the gate layout couples
// all heads, as in the forward).  dR = sum h_{t-1}^T dg_t and db = sum dg_t
// are not serial: the wrapper forms them with one batched product after the
// kernel, and recomputes g with one batched product before it.  The
// gradient is that of every op as PyTorch's autograd takes it: the soft cap;
// log_sigmoid (d/dx = sigmoid(-x)); max(a, gi) gives each side half of a
// tie's gradient (at t = 0, m = -1e30 makes gi the larger); max(n', 1)
// passes the gradient at n' == 1 (clamp's rule).
//
// Replaces no TPU kernel: the reference trains the sLSTM by differentiating
// its lax.scan (src/repro/models/xlstm.py, slstm_prefill) with jax.grad.
//
// Bound: a recurrence, as the forward.  A step's work (4d*P multiply-adds a
// row for dh, ~30 flops a unit) is small and S steps run one after another,
// so the time is S times one step's latency.  Design (simple first): one
// thread-block cluster a batch row; CTA r owns units [r*U, (r+1)*U), U =
// d/C, keeps rows [r*U, (r+1)*U) of R viewed as a (d, 4P) matrix (unit u is
// row u: head u / P, row u % P) in shared memory, padded 16 bytes a row, or
// reads them from device memory (L2) where C CTAs cannot hold R.  KS
// threads a unit split its dot over 4P into 16-byte column chunks and add
// their parts by shuffles, so every one of them holds dh_{t-1} of the unit;
// each then runs the unit's elementwise step (the same values on every
// lane), lane 0 stores the unit's 4 gate gradients to dg, and lane k sends
// them into the dg_t buffer of cluster ranks k, k + KS, ...  One cluster
// barrier a step publishes dg_t; two buffers are enough, since a CTA writes
// buffer t&1 only after the barrier of step t+1, which every peer reached
// after its last read of that buffer (step t+2's dot).  The next step's
// loads are issued before the barrier so that their latency overlaps it.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 16;   // non-portable above 8
constexpr int kMaxThreads = 1024;
constexpr float kGateCap = 15.0f;
constexpr float kNegInf = -1e30f;

struct Bwd {
  float* dg;             // (B, S, 4d)
  const float* dh;       // (B, S, d)
  const float* g;        // (B, S, 4d)
  const float* state;    // (B, S, 3, d): c, n, m after each step
  const void* r;         // (H, P, 4P) = (d, 4P)
  int S, P, d;
  int units;             // U = d / C
  int ks;                // threads a unit
  int r_stride;          // elements a resident row of R (4P + 16 bytes)
};

__device__ __forceinline__ float bf16_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// 8 consecutive R values of a row, as fp32 (exact for bf16).
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

__device__ __forceinline__ float log_sigmoid(float x) {
  return -(fmaxf(-x, 0.f) + log1pf(expf(-fabsf(x))));
}
__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// What a unit's step reads: its 4 gate pre-activations, dh from above, the
// state after the step (c, n) and before it (c, n, m).
struct StepIn {
  float gi, gf, gz, go, dh, c, n, c0, n0, m0;
};

__device__ __forceinline__ StepIn load_step(const Bwd& p, int row, int t,
                                            int u) {
  StepIn s;
  const size_t gt = ((size_t)row * p.S + t) * 4 * p.d + u;
  s.gi = __ldg(p.g + gt);
  s.gf = __ldg(p.g + gt + p.d);
  s.gz = __ldg(p.g + gt + 2 * p.d);
  s.go = __ldg(p.g + gt + 3 * p.d);
  s.dh = __ldg(p.dh + ((size_t)row * p.S + t) * p.d + u);
  const float* st = p.state + ((size_t)row * p.S + t) * 3 * p.d + u;
  s.c = __ldg(st);
  s.n = __ldg(st + p.d);
  if (t > 0) {
    s.c0 = __ldg(st - 3 * p.d);
    s.n0 = __ldg(st - 2 * p.d);
    s.m0 = __ldg(st - p.d);
  } else {
    s.c0 = 0.f;
    s.n0 = 0.f;
    s.m0 = kNegInf;
  }
  return s;
}

template <typename TR, bool kResident>
__global__ void __launch_bounds__(kMaxThreads, 1)
slstm_scan_bwd_kernel(Bwd p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.x / C;   // batch row
  const int U = p.units, KS = p.ks, P4 = 4 * p.P, d = p.d;
  const int ur = threadIdx.x / KS;  // this thread's unit in the CTA
  const int part = threadIdx.x % KS;
  const bool active = ur < U;
  const int u = rank * U + (active ? ur : 0);
  const int head = u / p.P;

  extern __shared__ __align__(16) unsigned char smem[];
  float* dgbuf = reinterpret_cast<float*>(smem);        // 2 x 4d
  TR* rs = reinterpret_cast<TR*>(dgbuf + 8 * d);        // U rows of R
  const TR* R = static_cast<const TR*>(p.r);
  if (kResident) {
    // rows [rank*U, rank*U + U) of R, 8 values a thread a turn
    const int chunks = P4 / 8;
    for (int i = threadIdx.x; i < U * chunks; i += blockDim.x) {
      const int rr = i / chunks, cc = (i % chunks) * 8;
      const TR* from = R + (size_t)(rank * U + rr) * P4 + cc;
      TR* to = rs + (size_t)rr * p.r_stride + cc;
      if (sizeof(TR) == 2) {
        *reinterpret_cast<uint4*>(to) = *reinterpret_cast<const uint4*>(from);
      } else {
        reinterpret_cast<float4*>(to)[0] =
            reinterpret_cast<const float4*>(from)[0];
        reinterpret_cast<float4*>(to)[1] =
            reinterpret_cast<const float4*>(from)[1];
      }
    }
  }
  const TR* rrow = kResident ? rs + (size_t)ur * p.r_stride
                             : R + (size_t)u * P4;
  // the cluster ranks this lane sends a unit's dg to: part, part + KS, ...
  float dc = 0.f, dn = 0.f, dm = 0.f, dh_rec = 0.f;
  StepIn cur = {};
  if (active && p.S > 0) cur = load_step(p, row, p.S - 1, u);
  float* dg_out = p.dg + (size_t)row * p.S * 4 * d + u;
  cluster.sync();  // R in place in every CTA before any dot

  for (int t = p.S - 1; t >= 0; --t) {
    StepIn nxt = {};
    if (active && t > 0) nxt = load_step(p, row, t - 1, u);
    float* buf = dgbuf + (t & 1) * 4 * d;
    if (active) {
      // the unit's step backward, the same on each of its KS lanes
      const float ti = tanhf(cur.gi / kGateCap), tf = tanhf(cur.gf / kGateCap);
      const float gi = kGateCap * ti, gf = kGateCap * tf;
      const float a = log_sigmoid(gf) + cur.m0;
      const float m_new = fmaxf(a, gi);
      const float i_p = expf(gi - m_new), f_p = expf(a - m_new);
      const float tz = tanhf(cur.gz), so = sigmoid(cur.go);
      const float nc = fmaxf(cur.n, 1.f);
      const float x = so * cur.c;
      const float dht = cur.dh + dh_rec;
      const float dx = dht / nc;
      if (cur.n >= 1.f) dn += -dht * x / (nc * nc);
      dc += dx * so;
      const float dgo = dx * cur.c * (1.f - so) * so;
      const float dgz = dc * i_p * (1.f - tz * tz);
      const float die = (dc * tz + dn) * i_p;
      const float dfe = (dc * cur.c0 + dn * cur.n0) * f_p;
      dc *= f_p;
      dn *= f_p;
      const float dmn = dm - dfe - die;
      const float half = 0.5f * dmn;
      const float da = dfe + (a > gi ? dmn : (a == gi ? half : 0.f));
      const float dgi = die + (gi > a ? dmn : (a == gi ? half : 0.f));
      dm = da;
      const float dgf = da * sigmoid(-gf);
      const float d4[4] = {dgi * (1.f - ti * ti), dgf * (1.f - tf * tf), dgz,
                           dgo};
      if (part == 0) {
#pragma unroll
        for (int k = 0; k < 4; ++k) dg_out[(size_t)t * 4 * d + k * d] = d4[k];
      }
      if (t > 0) {
        for (int dst = part; dst < C; dst += KS) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            *cluster.map_shared_rank(buf + k * d + u, dst) = d4[k];
          }
        }
      }
    }
    if (t == 0) break;
    cluster.sync();  // dg_t in every CTA of the cluster
    // dh_{t-1}[u] = R[u, :] . dg_t[head*4P : head*4P + 4P], KS lanes a unit
    float acc0 = 0.f, acc1 = 0.f;
    if (active) {
      const float* dgh = buf + head * P4;
      for (int col = 8 * part; col < P4; col += 8 * KS) {
        float rv[8];
        load8(rrow + col, rv);
        const float4 g0 = *reinterpret_cast<const float4*>(dgh + col);
        const float4 g1 = *reinterpret_cast<const float4*>(dgh + col + 4);
        acc0 = fmaf(rv[0], g0.x, acc0);
        acc1 = fmaf(rv[1], g0.y, acc1);
        acc0 = fmaf(rv[2], g0.z, acc0);
        acc1 = fmaf(rv[3], g0.w, acc1);
        acc0 = fmaf(rv[4], g1.x, acc0);
        acc1 = fmaf(rv[5], g1.y, acc1);
        acc0 = fmaf(rv[6], g1.z, acc0);
        acc1 = fmaf(rv[7], g1.w, acc1);
      }
    }
    float sum = acc0 + acc1;
    for (int off = 1; off < KS; off *= 2) {
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    }
    dh_rec = sum;
    cur = nxt;
  }
}

// Where a shape's R lives, the plan's ``where`` (as slstm_scan.cu's).
enum Where { kUnsupported = 0, kShared = 2, kDevice = 3 };

struct Plan {
  int where = kUnsupported;
  int cluster = 0;
  int threads = 0;
  int ks = 0;
  int r_stride = 0;
  size_t smem = 0;
};

template <typename TR, bool kResident>
const void* kernel_of() {
  return reinterpret_cast<const void*>(&slstm_scan_bwd_kernel<TR, kResident>);
}

const void* plan_kernel(const Plan& plan, bool bf16) {
  const bool shared = plan.where == kShared;
  if (bf16)
    return shared ? kernel_of<__nv_bfloat16, true>()
                  : kernel_of<__nv_bfloat16, false>();
  return shared ? kernel_of<float, true>() : kernel_of<float, false>();
}

cudaLaunchConfig_t launch_config(const Plan& plan, int B,
                                 cudaLaunchAttribute* attr,
                                 cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * plan.cluster);
  cfg.blockDim = dim3(plan.threads);
  cfg.dynamicSmemBytes = plan.smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = plan.cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Whether the card can run one cluster of this plan.
bool runs(const Plan& plan, bool bf16) {
  const void* kernel = plan_kernel(plan, bf16);
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(plan.smem)) != cudaSuccess ||
      (plan.cluster > 8 &&
       cudaFuncSetAttribute(kernel,
                            cudaFuncAttributeNonPortableClusterSizeAllowed,
                            1) != cudaSuccess)) {
    cudaGetLastError();
    return false;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(plan, 1, &attr, 0);
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) !=
          cudaSuccess ||
      clusters < 1) {
    cudaGetLastError();   // clear a refused query's error
    return false;
  }
  return true;
}

// The fewest CTAs (a power of two, at most 16) that hold their rows of R in
// shared memory and that the card runs as a cluster; else R read from device
// memory at the fewest CTAs of at most 1024 units each.  KS: the most lanes
// a unit (a power of two up to 32) within 1024 threads whose 8-column
// chunks tile 4P.
Plan make_plan(int d, int P, bool bf16, int optin) {
  Plan best;
  if (P <= 0 || P % 8 || d <= 0 || d % P) return best;
  const int esize = bf16 ? 2 : 4;
  const int stride = 4 * P + 16 / esize;
  for (int pass = 0; pass < 2 && !best.where; ++pass) {
    for (int C = 1; C <= kMaxCluster; C *= 2) {
      if (d % C) continue;
      const int U = d / C;
      if (U > kMaxThreads) continue;
      int ks = 32;
      while (ks > 1 && (U * ks > kMaxThreads || (4 * P) % (8 * ks))) ks /= 2;
      Plan plan;
      plan.where = pass == 0 ? kShared : kDevice;
      plan.cluster = C;
      plan.ks = ks;
      plan.threads = (U * ks + 31) / 32 * 32;
      plan.r_stride = pass == 0 ? stride : 0;
      plan.smem = (size_t)8 * d * 4 +
                  (pass == 0 ? (size_t)U * stride * esize : 0);
      if (plan.smem > (size_t)optin || !runs(plan, bf16)) continue;
      best = plan;
      break;
    }
  }
  return best;
}

int smem_optin() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return bytes;
}

}  // namespace

// How the kernel would run a shape: cluster size (0: not supported), where
// R lives (2 shared memory, 3 device memory) and the lanes a unit.  Returns a
// CUDA error code.
extern "C" int repro_slstm_scan_bwd_plan(int d, int P, int r_bf16,
                                         int* cluster, int* where, int* ks) {
  const int optin = smem_optin();
  if (!optin) return static_cast<int>(cudaErrorInvalidDevice);
  const Plan plan = make_plan(d, P, r_bf16 != 0, optin);
  *cluster = plan.cluster;
  *where = plan.where;
  *ks = plan.ks;
  return 0;
}

// dg (B, S, 4d) fp32 of the scan from dh (B, S, d), g (B, S, 4d) and the
// saved state (B, S, 3, d), all fp32 and contiguous, and R (H, P, 4P) bf16 or
// fp32.  Returns cudaGetLastError() after the launch (0 == cudaSuccess), or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int repro_slstm_scan_bwd(void* dg, const void* dh, const void* g,
                                    const void* state, const void* r, int B,
                                    int S, int H, int P, int r_bf16,
                                    void* stream) {
  const int optin = smem_optin();
  if (!optin) return static_cast<int>(cudaErrorInvalidDevice);
  const int d = H * P;
  const Plan plan = make_plan(d, P, r_bf16 != 0, optin);
  if (!plan.cluster || B <= 0 || S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) return 0;
  Bwd p;
  p.dg = static_cast<float*>(dg);
  p.dh = static_cast<const float*>(dh);
  p.g = static_cast<const float*>(g);
  p.state = static_cast<const float*>(state);
  p.r = r;
  p.S = S;
  p.P = P;
  p.d = d;
  p.units = d / plan.cluster;
  p.ks = plan.ks;
  p.r_stride = plan.r_stride;
  const void* kernel = plan_kernel(plan, r_bf16 != 0);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(plan, B, &attr, static_cast<cudaStream_t>(stream));
  void* args[] = {&p};
  const cudaError_t err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
