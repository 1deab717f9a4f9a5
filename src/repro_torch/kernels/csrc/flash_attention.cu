// Causal / sliding-window flash attention for Hopper (sm_90a), forward only.
//
//   out[b,s,h,:] = softmax_t(q[b,s,h,:] . k[b,t,h/G,:] * D^-1/2 + mask) @ v[b,t,h/G,:]
//
// mask: t < S always, t <= s when causal, t > s - window when window > 0.
// q is (B,S,H,D), k and v (B,S,KV,D), G = H/KV, read through their strides
// (the last axis contiguous); out is a new contiguous (B,S,H,D) tensor in
// q's dtype.  Scores, the running (max, sum) and the output accumulator are
// fp32; bf16 or fp32 inputs; D is 32, 64 or 128 (a template per D).
//
// Replaces the Pallas kernel flash_attention (body _attn_kernel) of
// src/repro/kernels/flash_attention.py.  As there, the running (m, l, acc)
// state never goes to device memory, and KV tiles with no live key are never
// visited, so a window W bounds a query tile's work to O(W + BQ).  The TPU's
// sequential nk grid axis becomes a loop inside the block, from the first
// live KV tile to the last one; no transpose or padding copy is made, and
// the ragged S tail is zero-filled in shared memory and never stored.
//
// Bound: operations.  At prefill lengths (S in the thousands, D = 128)
// attention does 4*S*D flops per (q, live key) pair against a few bytes per
// pair of q/k/v/out traffic, far above the card's ridge.  What the design
// does about it (simple first):
// - bf16 inputs run on the tensor cores through mma.sync m16n8k16 (bf16 in,
//   fp32 accumulate), flash-attention-2 style: one block of 4 warps per
//   (b, h, 64-row query tile), each warp owning 16 query rows; K and V tiles
//   of 64 keys stream through padded shared memory with cp.async, the next
//   K tile loading while this tile's softmax and PV product run.  The score
//   fragment is reused in registers as the A operand of the PV product.
//   The probabilities stay fp32 as in the TPU kernel: each is split into a
//   bf16 high part and a bf16 remainder, and both go through the tensor
//   cores (PV costs two products; the error is about 2^-16 of p, against
//   2^-9 for a single bf16 rounding).
// - fp32 inputs (the fp32 test configurations) run on the FMA units: one
//   block of 4 warps per (b, h, 32-row tile), a lane per key for the scores
//   and a lane per output column for the PV product.
// wgmma, TMA and warp specialisation are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 warps in both kernels

struct Params {
  void* out;
  const void* q;
  const void* k;
  const void* v;
  int S, H, group;
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  float scale_log2;  // D^-1/2 * log2(e): scores go through exp2
  int causal, window;
};

// The KV tiles [lo, hi] that hold a live key for query rows [q0, q0+bq).
__device__ __forceinline__ void kv_tiles(const Params& p, int q0, int bq,
                                         int bk, int& lo, int& hi) {
  const int q1 = min(q0 + bq, p.S) - 1;
  const int t_hi = p.causal ? q1 : p.S - 1;
  const int t_lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  lo = t_lo / bk;
  hi = t_hi / bk;
}

// True when some (row, key) pair of the tile may be masked.
__device__ __forceinline__ bool tile_needs_mask(const Params& p, int q0,
                                                int bq, int k0, int bk) {
  return k0 + bk > p.S || (p.causal && k0 + bk - 1 > q0) ||
         (p.window > 0 && k0 <= q0 + bq - 1 - p.window);
}

__device__ __forceinline__ bool live(const Params& p, int s, int t) {
  return t < p.S && (!p.causal || t <= s) &&
         (p.window <= 0 || t > s - p.window);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

constexpr int kBQ = 64, kBK = 64;
static_assert(kBQ == kBK, "load_tile_bf16 copies tiles of kBK rows");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  // src-size 0 fills the 16 bytes with zeros (rows past S)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The two bf16 parts of a pair of fp32 probabilities: hi = bf16(p),
// lo = bf16(p - hi).
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(x - __low2float(h), y - __high2float(h));
}

// Copy rows [r0, r0+kBK) of one head of a (B,S,*,D) bf16 tensor into a padded
// shared tile; rows past S become zeros.
template <int D, int STRIDE>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* head,
                                               int64_t ss, int r0, int S) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < kBK * kChunks; c += kThreads) {
    const int row = c / kChunks, col = (c % kChunks) * 8;
    const bool valid = r0 + row < S;
    const __nv_bfloat16* src = valid ? head + (r0 + row) * ss + col : head;
    cp_async16(dst + row * STRIDE + col, src, valid);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_bf16_kernel(Params p) {
  constexpr int STRIDE = D + 8;  // 16-byte rows, conflict-free fragments
  constexpr int NB = kBK / 8;    // score n-blocks of 8 keys
  constexpr int ND = D / 8;      // output n-blocks of 8 columns
  constexpr int KS = D / 16;     // k-steps over D
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kBQ * STRIDE;
  __nv_bfloat16* Vs = Ks + kBK * STRIDE;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int nq = (p.S + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kBQ;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / p.group;
  const __nv_bfloat16* qh =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kh =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vh =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  int lo, hi;
  kv_tiles(p, q0, kBQ, kBK, lo, hi);
  load_tile_bf16<D, STRIDE>(Qs, qh, p.q_ss, q0, p.S);
  load_tile_bf16<D, STRIDE>(Ks, kh, p.k_ss, lo * kBK, p.S);
  cp_async_commit();
  load_tile_bf16<D, STRIDE>(Vs, vh, p.v_ss, lo * kBK, p.S);
  cp_async_commit();
  cp_async_wait<1>();  // Q and the first K tile
  __syncthreads();

  // this warp's 16 query rows as A fragments, one per k-step
  uint32_t qf[KS][4];
  {
    const __nv_bfloat16* r0 = Qs + (warp * 16 + g) * STRIDE + tig * 2;
    const __nv_bfloat16* r8 = r0 + 8 * STRIDE;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      qf[ks][0] = *reinterpret_cast<const uint32_t*>(r0 + ks * 16);
      qf[ks][1] = *reinterpret_cast<const uint32_t*>(r8 + ks * 16);
      qf[ks][2] = *reinterpret_cast<const uint32_t*>(r0 + ks * 16 + 8);
      qf[ks][3] = *reinterpret_cast<const uint32_t*>(r8 + ks * 16 + 8);
    }
  }

  float o[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // rows g and g+8, in log2 units
  float l[2] = {0.f, 0.f};              // this thread's part of the row sums
  const int row0 = q0 + warp * 16 + g;

  for (int j = lo; j <= hi; ++j) {
    const int k0 = j * kBK;
    const bool has_next = j < hi;
    // S = Q K^T for 16 rows x 64 keys
    float s[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
      const uint32_t* kr = reinterpret_cast<const uint32_t*>(
          Ks + (nb * 8 + g) * STRIDE + tig * 2);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        mma_bf16(s[nb], qf[ks], kr[ks * 8], kr[ks * 8 + 4]);
      }
    }
    __syncthreads();  // every warp is done with Ks
    if (has_next) {
      load_tile_bf16<D, STRIDE>(Ks, kh, p.k_ss, k0 + kBK, p.S);
      cp_async_commit();
    }

    // online softmax; masked scores are -inf
    const bool masked = tile_needs_mask(p, q0, kBQ, k0, kBK);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nb][e] * p.scale_log2;
        if (masked) {
          const int t = k0 + nb * 8 + tig * 2 + (e & 1);
          if (!live(p, row0 + (e >> 1) * 8, t)) x = -INFINITY;
        }
        s[nb][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = exp2f(m[r] - m_use[r]);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(s[nb][e] - m_use[e >> 1]);
        s[nb][e] = pe;
        l[e >> 1] += pe;
      }
    }
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      o[nd][0] *= alpha[0];
      o[nd][1] *= alpha[0];
      o[nd][2] *= alpha[1];
      o[nd][3] *= alpha[1];
    }

    if (has_next) {
      cp_async_wait<1>();  // this tile's V (the next K may still fly)
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // O += P V, P as (hi + lo) bf16 A fragments straight from the scores
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t ah[4], al[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ah[0], al[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ah[1], al[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ah[2], al[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ah[3], al[3]);
      const __nv_bfloat16* vrow =
          Vs + (kk * 16 + (lane & 15)) * STRIDE + (lane >> 4) * 8;
#pragma unroll
      for (int nd2 = 0; nd2 < ND / 2; ++nd2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vrow + nd2 * 16);
        mma_bf16(o[2 * nd2], ah, bv[0], bv[1]);
        mma_bf16(o[2 * nd2], al, bv[0], bv[1]);
        mma_bf16(o[2 * nd2 + 1], ah, bv[2], bv[3]);
        mma_bf16(o[2 * nd2 + 1], al, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with Vs
    if (has_next) {
      load_tile_bf16<D, STRIDE>(Vs, vh, p.v_ss, k0 + kBK, p.S);
      cp_async_commit();
      cp_async_wait<1>();  // the next K tile
      __syncthreads();
    }
  }

  // out = O / l, rows past S are not stored
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
  const int64_t o_ss = (int64_t)p.H * D;
  const int64_t o_sb = (int64_t)p.S * o_ss;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const float inv = 1.f / fmaxf(lr, 1e-30f);
    const int row = row0 + r * 8;
    if (row < p.S) {
      __nv_bfloat16* dst = out + b * o_sb + row * o_ss + h * D + tig * 2;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        *reinterpret_cast<uint32_t*>(dst + nd * 8) =
            pack_bf16(o[nd][2 * r] * inv, o[nd][2 * r + 1] * inv);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: FMA units
// ---------------------------------------------------------------------------

constexpr int kRows = 8;                 // query rows per warp
constexpr int kFBQ = kRows * kThreads / 32;  // 32
constexpr int kFBK = 32;                 // one key per lane

template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, int stride,
                                              const float* head, int64_t ss,
                                              int r0, int rows, int S) {
  for (int c = threadIdx.x; c < rows * D; c += kThreads) {
    const int row = c / D, col = c % D;
    dst[row * stride + col] = r0 + row < S ? head[(r0 + row) * ss + col] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_f32_kernel(Params p) {
  constexpr int NC = D / 32;  // output columns per lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [kFBQ][D], broadcast
  float* Ks = Qs + kFBQ * D;                       // [kFBK][D+1], lane = key
  float* Vs = Ks + kFBK * (D + 1);                 // [kFBK][D], lane = column

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nq = (p.S + kFBQ - 1) / kFBQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kFBQ;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / p.group;
  const float* qh = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kh = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vh = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  int lo, hi;
  kv_tiles(p, q0, kFBQ, kFBK, lo, hi);
  load_tile_f32<D>(Qs, D, qh, p.q_ss, q0, kFBQ, p.S);

  float o[kRows][NC], m[kRows], l[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) o[r][i] = 0.f;
  }
  const int rbase = q0 + warp * kRows;

  for (int j = lo; j <= hi; ++j) {
    const int k0 = j * kFBK;
    __syncthreads();  // the previous tile is consumed
    load_tile_f32<D>(Ks, D + 1, kh, p.k_ss, k0, kFBK, p.S);
    load_tile_f32<D>(Vs, D, vh, p.v_ss, k0, kFBK, p.S);
    __syncthreads();

    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float* kr = Ks + lane * (D + 1);
    const float* qr = Qs + warp * kRows * D;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r] = fmaf(qr[r * D + d], kd, s[r]);
    }
    const int t = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float x = live(p, rbase + r, t) ? s[r] * p.scale_log2 : -INFINITY;
      float mx = x;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[r] - m_use);
      const float pe = exp2f(x - m_use);
      float sum = pe;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
      s[r] = pe;
#pragma unroll
      for (int i = 0; i < NC; ++i) o[r][i] *= alpha;
    }
    for (int jj = 0; jj < kFBK; ++jj) {
      float vv[NC];
#pragma unroll
      for (int i = 0; i < NC; ++i) vv[i] = Vs[jj * D + lane + 32 * i];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pj = __shfl_sync(0xffffffffu, s[r], jj);
#pragma unroll
        for (int i = 0; i < NC; ++i) o[r][i] = fmaf(pj, vv[i], o[r][i]);
      }
    }
  }

  float* out = static_cast<float*>(p.out);
  const int64_t o_ss = (int64_t)p.H * D;
  const int64_t o_sb = (int64_t)p.S * o_ss;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = rbase + r;
    if (row < p.S) {
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      float* dst = out + b * o_sb + row * o_ss + h * D;
#pragma unroll
      for (int i = 0; i < NC; ++i) dst[lane + 32 * i] = o[r][i] * inv;
    }
  }
}

template <int D>
cudaError_t launch(const Params& p, int B, int is_bf16, cudaStream_t stream) {
  if (is_bf16) {
    const int smem = (kBQ + 2 * kBK) * (D + 8) * 2;
    cudaError_t e = cudaFuncSetAttribute(
        flash_attention_bf16_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid((p.S + kBQ - 1) / kBQ, p.H, B);
    flash_attention_bf16_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  } else {
    const int smem = (kFBQ * D + kFBK * (D + 1) + kFBK * D) * 4;
    cudaError_t e = cudaFuncSetAttribute(
        flash_attention_f32_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid((p.S + kFBQ - 1) / kFBQ, p.H, B);
    flash_attention_f32_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 == cudaSuccess), or
// cudaErrorInvalidValue for a head dim without a template.  Strides are in
// elements; the caller checks devices, dtypes (q/k/v/out all bf16 or all
// fp32), shapes, a unit stride on the last axis, 16-byte aligned rows for
// bf16, S >= 1, H % KV == 0 and 1 <= B, H <= 65535.
extern "C" int repro_flash_attention(
    void* out, const void* q, const void* k, const void* v, int B, int S,
    int H, int KV, int D, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, int causal, int window, int is_bf16,
    void* stream) {
  Params p{out,  q,    k,    v,    S,    H,    H / KV, q_sb, q_ss,
           q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,   0.f,  causal,
           window};
  p.scale_log2 = (1.0f / sqrtf((float)D)) * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return (int)launch<32>(p, B, is_bf16, s);
    case 64: return (int)launch<64>(p, B, is_bf16, s);
    case 128: return (int)launch<128>(p, B, is_bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
