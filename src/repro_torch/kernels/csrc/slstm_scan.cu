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
// Everything is fp32: no TF32, no fast math.  When a gradient is wanted the
// kernel also writes the state after every step, (B, S, 3, d) fp32 holding
// (c, n, m), which the backward (slstm_scan_bwd.cu) reads; without it the
// kernel stores nothing more.
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
// below that.  One thread-block cluster per batch row: CTA r of the C owns
// units [r*d/C, (r+1)*d/C) and their four gates.  Several rows share R, but
// they are kept in separate clusters: rows proceed in parallel on separate
// SMs and no row waits for another.  wx is read from device memory two
// steps ahead, so its latency stays off the recurrence's critical path.
//
// The register kernel (P = 8, 16, 32, 64, 192; xlstm-125m's layer) takes a
// step's latency apart where it lies (NVIDIA H100 80GB HBM3, 700 W: 1.07
// us a step at the layer shape, 0.52 at the smallest width; PERF.md):
// - R in registers.  Each CTA's columns of R are loaded once, as fp32
//   (exact for bf16), into its threads' registers: at P = 192 a thread
//   keeps 4 columns (4 adjacent units, one gate) over 24 rows, 8 threads
//   share those columns (three shuffle rounds add their parts), so a CTA
//   of 48 units x 4 gates x 2 threads = 384 threads keeps 192 columns
//   (147 KB) in its register file, and d = 768 takes a cluster of 16 CTAs
//   (non-portable; the plan asks the card whether it can run one).  A step
//   reads only h from shared memory, broadcast, each slice padded by 4
//   floats so a warp's slices fall in distinct banks; it spends no
//   instruction converting bf16 and re-reads no R.  Each h value a thread
//   loads feeds 4 columns: the loads of h, 4x redundant across a warp's
//   units, set the dot's time at one column a thread.
// - The gate update on a unit's lanes.  A block of units' 4 gates (x 8
//   threads) sits in one warp; after the dot products the 8 lanes of a
//   gate each apply the gate's function to one column (2 lanes a column),
//   written as one a*tanh(x/b) + o for all four gates (i and f soft
//   capped, z tanh, o sigmoid as 0.5 tanh(x/2) + 0.5) so no lane waits on
//   another's branch, then f's log sigmoid; shuffles bring a unit's four
//   to the lanes that run its (c, n, m) update.  No __syncthreads, no
//   gates round trip through shared memory.
// - h shared without a cluster barrier.  Each warp sends its units' h_t to
//   every CTA of the cluster, itself included, as 16-byte st.async stores
//   that complete on the receiver's mbarrier of that h buffer, which its
//   thread 0 arms with 4*d expected bytes.  A CTA waits only on its own
//   barrier (tracking each buffer's phase parity).  Two buffers are enough:
//   a warp sends h_{t+1} into buffer t&1 only after it has received every
//   h_t, and each peer sent h_t after its last read of buffer t&1.  The
//   last step's h is not sent, so every store into a CTA lands before it
//   waits for the last time; a cluster barrier before the loop (barriers
//   armed, h_{-1} = 0) and one after it remain.
// The shared-memory kernel (other P, or a cluster the card cannot run):
// one thread a gate column in 1-8 CTAs, each CTA's columns of R resident
// in shared memory (column-major, padded so each thread reads 8 values in
// one conflict-free 16-byte load), or read from device memory
// (L2-resident) where 8 CTAs cannot hold them; a CTA barrier between the
// dot and one thread a unit running the gate update; h pushed to every CTA
// by remote stores and published by one cluster barrier a step.
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
  float* state;        // (B, S, 3, d): c, n, m after each step; or null
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
  float* st = p.state ? p.state + (size_t)row * p.S * 3 * d + u0 + k
                      : nullptr;
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
      if (st) {
        st[(size_t)t * 3 * d] = c;
        st[(size_t)t * 3 * d + d] = n;
        st[(size_t)t * 3 * d + 2 * d] = m;
      }
      float* next = hbuf + ((t + 1) & 1) * d + u0 + k;
      for (int r = 0; r < C; ++r) *cluster.map_shared_rank(next, r) = hv;
    }
    cluster.sync();  // h_t visible in every CTA; buffer t free for t+2
  }
}

// ---------------------------------------------------------------------------
// The register kernel: R in registers, h exchanged through mbarriers.

constexpr int kRegMaxCluster = 16;   // non-portable above 8

// The register kernel's layout for head size P: a thread keeps NC columns
// (NC adjacent units, one gate) over P/KS rows, KS threads share those
// columns, and the block's thread limit (its register file is 64K /
// threads) bounds each thread's registers.
__host__ __device__ constexpr int reg_split(int P) { return P > 64 ? 8 : 1; }
__host__ __device__ constexpr int reg_cols(int P) { return P > 64 ? 4 : 1; }
__host__ __device__ constexpr int reg_max_threads(int P) {
  return P > 64 ? 384 : 512;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}
// The shared::cluster address of ``addr`` (this CTA's) in CTA ``rank``.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes) : "memory");
}
// Waits for the phase of ``bar`` with this parity to complete, acquiring at
// cluster scope what the other CTAs' stores released.  A wait that
// outlasts some 2^26 polls traps (the launch fails with an error) rather
// than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}
// 16 bytes into another CTA's shared memory (``addr``), counted in bytes
// on that CTA's ``bar``.
__device__ __forceinline__ void st_async16(uint32_t addr, float4 v,
                                           uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)),
      "r"(__float_as_uint(v.z)), "r"(__float_as_uint(v.w)), "r"(bar)
      : "memory");
}

// One cluster per batch row.  A block of NC adjacent units takes 4*KS
// adjacent lanes of one warp, [i s0 .. s_KS-1 | f .. | z .. | o ..]: each
// thread keeps rows [s*P/KS, (s+1)*P/KS) of its gate's NC columns of R in
// registers as fp32.  After the dot products every lane of a gate holds
// the NC pre-activations; the lanes of split s apply the gate's function
// to column s % NC and keep unit s % NC's (c, n, m).  h_{t-1} is read from
// shared memory, whose two buffers of d values (padded per slice of P/KS)
// are filled by the cluster's CTAs with st.async and guarded by one
// mbarrier each.
template <typename TR, int P>
__global__ void __launch_bounds__(reg_max_threads(P), 1)
slstm_scan_reg_kernel(Params p) {
  constexpr int KS = reg_split(P), NC = reg_cols(P);
  constexpr int PK = P / KS;          // rows of R a thread keeps
  constexpr int SLOT = PK + 4;        // a slice's floats, padded
  constexpr int LANES = 4 * KS;       // threads of a block of NC units
  constexpr int UW = 32 / LANES * NC; // units a warp
  constexpr int CHUNKS = UW / 4;      // 16-byte chunks of h a warp sends
  static_assert(KS % NC == 0 && UW % 4 == 0, "lanes per column, chunks");
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.x / C;
  const int d = p.d, P4 = 4 * P;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gate = (threadIdx.x / KS) % 4, split = threadIdx.x % KS;
  const int mine = split % NC;            // the column this lane finishes
  // the block's first unit and its gate column; the NC columns lie in one
  // head (NC divides d and 4P)
  const int unit = rank * p.units + threadIdx.x / LANES * NC;
  const int j = gate * d + unit;
  const int head = j / P4;
  const int buf_floats = d / PK * SLOT;   // one h buffer

  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);   // 2 mbarriers
  float* hbuf = reinterpret_cast<float*>(smem + 16);    // 2 h buffers

  float r[NC][PK];
  const TR* R = static_cast<const TR*>(p.r) +
                ((size_t)head * P + split * PK) * P4 + j % P4;
#pragma unroll
  for (int k = 0; k < PK; ++k) {
#pragma unroll
    for (int c = 0; c < NC; ++c) r[c][k] = to_float(R[(size_t)k * P4 + c]);
  }

  const uint32_t bar0 = smem_u32(bars), bar1 = smem_u32(bars + 1);
  if (threadIdx.x == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // buffer 1 takes h_0, buffer 0 h_1 (the last step's h is not sent)
    if (p.S >= 2) mbar_expect_tx(bar1, 4 * d);
    if (p.S >= 3) mbar_expect_tx(bar0, 4 * d);
  }
  for (int i = threadIdx.x; i < 2 * buf_floats; i += blockDim.x) hbuf[i] = 0.f;

  // what this lane sends each step: chunk ``ch`` of its warp's UW units
  // (4 units, 16 bytes) to CTA ``dst``; h of unit u sits in slice u / PK
  const int ch = lane % CHUNKS, dst = lane / CHUNKS;
  const bool sender = dst < C;
  const int to = sender ? dst : rank;   // mapa wants a rank of the cluster
  const int u_first = rank * p.units + warp * UW + ch * 4;
  const uint32_t slot_off = (u_first / PK * SLOT + u_first % PK) * 4;
  const uint32_t buf0_to = map_rank(smem_u32(hbuf) + slot_off, to);
  const uint32_t buf1_to = map_rank(smem_u32(hbuf + buf_floats) + slot_off, to);
  const uint32_t bar0_to = map_rank(bar0, to), bar1_to = map_rank(bar1, to);
  const float* h_slice = hbuf + (head * KS + split) * SLOT;
  // the lane's gate function, y = a * tanh(x / b) + o: i and f soft capped,
  // z tanh, o sigmoid as 0.5 tanh(x/2) + 0.5; then log sigmoid for f.  x /
  // 15 stays a division (by a constant), x / 1 and x / 2 are exact products
  const float ga = gate < 2 ? kGateCap : (gate == 2 ? 1.f : 0.5f);
  const float gs = gate == 2 ? 1.f : 0.5f;
  const float go = gate == 3 ? 0.5f : 0.f;
  const int group = lane / LANES * LANES + mine;   // gate i of unit ``mine``
  const float bias = p.bias[j + mine];
  float c = 0.f, n = 0.f, m = -1e30f;
  const size_t wx_step = (size_t)4 * d;
  const float* wx = p.wx + (size_t)row * p.S * wx_step + j + mine;
  float* out = p.out + (size_t)row * p.S * d + u_first;
  // lane (gate i, split s < NC) stores unit s's state, if one is wanted
  float* st = p.state && gate == 0 && split < NC
                  ? p.state + (size_t)row * p.S * 3 * d + unit + mine
                  : nullptr;
  float wx0 = p.S > 0 ? __ldg(wx) : 0.f;
  float wx1 = p.S > 1 ? __ldg(wx + wx_step) : 0.f;
  cluster.sync();  // barriers armed and h_{-1} = 0 in every CTA

  for (int t = 0; t < p.S; ++t) {
    const float wx2 = t + 2 < p.S ? __ldg(wx + (t + 2) * wx_step) : 0.f;
    const bool odd = t & 1;
    if (t > 0) {
      mbar_wait(odd ? bar1 : bar0, ((t - 1) >> 1) & 1);
      // the next phase of this buffer's barrier takes h_{t+1}
      if (threadIdx.x == 0 && t + 3 <= p.S)
        mbar_expect_tx(odd ? bar1 : bar0, 4 * d);
    }
    const float* h = h_slice + (odd ? buf_floats : 0);
    float acc[NC][4] = {};
#pragma unroll
    for (int k = 0; k < PK; k += 4) {
      const float4 hq = *reinterpret_cast<const float4*>(h + k);
#pragma unroll
      for (int q = 0; q < NC; ++q) {
        acc[q][0] = fmaf(hq.x, r[q][k], acc[q][0]);
        acc[q][1] = fmaf(hq.y, r[q][k + 1], acc[q][1]);
        acc[q][2] = fmaf(hq.z, r[q][k + 2], acc[q][2]);
        acc[q][3] = fmaf(hq.w, r[q][k + 3], acc[q][3]);
      }
    }
    float rec = 0.f;
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      float sum = (acc[q][0] + acc[q][1]) + (acc[q][2] + acc[q][3]);
#pragma unroll
      for (int off = 1; off < KS; off *= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (q == mine) rec = sum;
    }
    const float x = (wx0 + rec) + bias;
    float y = ga * tanhf(gate < 2 ? x / kGateCap : x * gs) + go;
    if (gate == 1) y = log_sigmoid(y);
    wx0 = wx1;
    wx1 = wx2;
    const float gi = __shfl_sync(0xffffffffu, y, group);
    const float logf = __shfl_sync(0xffffffffu, y, group + KS);
    const float gz = __shfl_sync(0xffffffffu, y, group + 2 * KS);
    const float so = __shfl_sync(0xffffffffu, y, group + 3 * KS);
    const float m_new = fmaxf(logf + m, gi);
    const float i_p = expf(gi - m_new);
    const float f_p = expf(logf + m - m_new);
    c = f_p * c + i_p * gz;
    n = f_p * n + i_p;
    m = m_new;
    const float hv = so * c / fmaxf(n, 1.f);
    if (st) {
      st[(size_t)t * 3 * d] = c;
      st[(size_t)t * 3 * d + d] = n;
      st[(size_t)t * 3 * d + 2 * d] = m;
    }
    // gather chunk ch's 4 units of h into this lane: warp unit w is unit
    // w % NC of the block in lanes [w / NC * LANES, ...), held by split w % NC
    float4 h4;
    h4.x = __shfl_sync(0xffffffffu, hv, (ch * 4 + 0) / NC * LANES + 0 % NC);
    h4.y = __shfl_sync(0xffffffffu, hv, (ch * 4 + 1) / NC * LANES + 1 % NC);
    h4.z = __shfl_sync(0xffffffffu, hv, (ch * 4 + 2) / NC * LANES + 2 % NC);
    h4.w = __shfl_sync(0xffffffffu, hv, (ch * 4 + 3) / NC * LANES + 3 % NC);
    if (sender && t + 1 < p.S)
      st_async16(odd ? buf0_to : buf1_to, h4, odd ? bar0_to : bar1_to);
    if (dst == 0) *reinterpret_cast<float4*>(out + (size_t)t * d) = h4;
  }
  cluster.sync();  // no CTA leaves while another may still address it
}

// Elements per resident column: P rounded up to 16 bytes, then padded so
// the stride is 4 words past a multiple of 32 (conflict-free 16-byte loads
// by consecutive threads).
int column_stride(int P, int esize) {
  int words = (P * esize + 15) / 16 * 4;
  while (words % 32 != 4) words += 4;
  return words * 4 / esize;
}

// Where a shape's R lives, the plan's ``where``.
enum Where { kUnsupported = 0, kRegisters = 1, kShared = 2, kDevice = 3 };

struct Plan {
  int where = kUnsupported;
  int cluster = 0;
  int threads = 0;
  int r_stride = 0;     // shared-memory kernel, R resident
  size_t smem = 0;
};

// The register kernel for (R type, P), or null where it has none.
template <typename TR>
const void* reg_kernel(int P) {
  switch (P) {
    case 192: return reinterpret_cast<const void*>(
        &slstm_scan_reg_kernel<TR, 192>);
    case 64: return reinterpret_cast<const void*>(
        &slstm_scan_reg_kernel<TR, 64>);
    case 32: return reinterpret_cast<const void*>(
        &slstm_scan_reg_kernel<TR, 32>);
    case 16: return reinterpret_cast<const void*>(
        &slstm_scan_reg_kernel<TR, 16>);
    case 8: return reinterpret_cast<const void*>(
        &slstm_scan_reg_kernel<TR, 8>);
  }
  return nullptr;
}

const void* plan_kernel(const Plan& plan, int P, bool bf16) {
  if (plan.where == kRegisters)
    return bf16 ? reg_kernel<__nv_bfloat16>(P) : reg_kernel<float>(P);
  const bool shared = plan.where == kShared;
  if (bf16)
    return shared ? reinterpret_cast<const void*>(
                        &slstm_scan_kernel<__nv_bfloat16, true>)
                  : reinterpret_cast<const void*>(
                        &slstm_scan_kernel<__nv_bfloat16, false>);
  return shared
             ? reinterpret_cast<const void*>(&slstm_scan_kernel<float, true>)
             : reinterpret_cast<const void*>(&slstm_scan_kernel<float, false>);
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

// The register kernel's layout: the fewest CTAs (a power of two, at most
// 16) whose units give each CTA whole warps within its thread limit, if
// the card can run such a cluster.
Plan register_plan(int d, int P, bool bf16) {
  Plan plan;
  const void* kernel = bf16 ? reg_kernel<__nv_bfloat16>(P)
                            : reg_kernel<float>(P);
  if (!kernel) return plan;
  const int pk = P / reg_split(P), nc = reg_cols(P);
  for (int C = 1; C <= kRegMaxCluster; C *= 2) {
    if (d % (C * nc)) continue;
    const int U = d / C, threads = U / nc * 4 * reg_split(P);
    if (threads > reg_max_threads(P) || threads % 32) continue;
    plan.where = kRegisters;
    plan.cluster = C;
    plan.threads = threads;
    plan.smem = 16 + (size_t)2 * (d / pk) * (pk + 4) * 4;
    break;
  }
  if (plan.where != kRegisters) return plan;
  if (plan.cluster > 8 &&
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeNonPortableClusterSizeAllowed,
                           1) != cudaSuccess)
    return Plan();
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(plan, 1, &attr, 0);
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) !=
          cudaSuccess ||
      clusters < 1) {
    cudaGetLastError();   // clear a refused query's error
    return Plan();
  }
  return plan;
}

// The shared-memory / device-memory kernel's layout (one thread a gate
// column, 1-8 CTAs), for shapes the register kernel does not take.
Plan shared_plan(int d, int P, int esize, int optin) {
  Plan plan;
  if (P <= 0 || P % 8 || d <= 0 || d % P) return plan;
  const int stride = column_stride(P, esize);
  int fallback = 0;
  for (int C = 1; C <= kMaxCluster; C *= 2) {
    if (d % C || 4 * (d / C) > kMaxThreads) continue;
    const int U = d / C;
    const size_t base = (size_t)2 * d * 4 + (size_t)4 * U * 4;
    const size_t bytes = base + (size_t)4 * U * stride * esize;
    if (bytes <= (size_t)optin) {
      plan.where = kShared;
      plan.cluster = C;
      plan.threads = 4 * U;
      plan.r_stride = stride;
      plan.smem = bytes;
      return plan;
    }
    if (base <= (size_t)optin) fallback = C;
  }
  if (fallback) {
    plan.where = kDevice;
    plan.cluster = fallback;
    plan.threads = 4 * (d / fallback);
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

Plan make_plan(int d, int P, bool bf16, int optin) {
  if (P <= 0 || P % 8 || d <= 0 || d % P) return Plan();
  const Plan plan = register_plan(d, P, bf16);
  return plan.where ? plan : shared_plan(d, P, bf16 ? 2 : 4, optin);
}

}  // namespace

// How the kernel would run a shape: cluster size (0: not supported) and
// where R lives (a Where: 1 registers, 2 shared memory, 3 device memory).
// Returns a CUDA error code.
extern "C" int repro_slstm_scan_plan(int d, int P, int r_bf16, int* cluster,
                                     int* where) {
  const int optin = smem_optin();
  if (!optin) return static_cast<int>(cudaErrorInvalidDevice);
  const Plan plan = make_plan(d, P, r_bf16 != 0, optin);
  *cluster = plan.cluster;
  *where = plan.where;
  return 0;
}

// ``state`` (B, S, 3, d) fp32, or null: the state after every step.
extern "C" int repro_slstm_scan(void* out, void* state, const void* wx,
                                const void* r, const void* bias, int B, int S,
                                int H, int P, int r_bf16, void* stream) {
  const int optin = smem_optin();
  if (!optin) return static_cast<int>(cudaErrorInvalidDevice);
  const int d = H * P;
  const Plan plan = make_plan(d, P, r_bf16 != 0, optin);
  if (!plan.cluster || B <= 0 || S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.out = static_cast<float*>(out);
  p.state = static_cast<float*>(state);
  p.wx = static_cast<const float*>(wx);
  p.r = r;
  p.bias = static_cast<const float*>(bias);
  p.S = S;
  p.P = P;
  p.d = d;
  p.units = d / plan.cluster;
  p.r_stride = plan.r_stride;
  const void* kernel = plan_kernel(plan, P, r_bf16 != 0);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(plan.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(plan, B, &attr, static_cast<cudaStream_t>(stream));
  void* args[] = {&p};
  err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
