// Backward of the causal / sliding-window flash attention (flash_attention.cu)
// for Hopper (sm_90a): dQ, dK and dV of
//
//   O[b,s,h,:] = softmax_t(q[b,s,h,:] . k[b,t,h/G,:] * D^-1/2 + mask) @ v[b,t,h/G,:]
//
// with the forward kernel's masks (t < S; t <= s when causal; t > s - window
// when window > 0).  The TPU reference has no such kernel: the JAX package
// differentiates its jnp attention.  q, O, dO and dQ are contiguous
// (B,S,H,D) bf16, k, v, dK and dV contiguous (B,S,KV,D) bf16; D is 64 or
// 128; products are mma.sync m16n8k16 (bf16 in, fp32 accumulate), and
// everything between them is fp32.  With P = softmax(scores) and
// Delta_s = sum_d dO[s,d] O[s,d]:
//
//   dV = P^T dO,   dP = dO V^T,   dS = P * (dP - Delta),
//   dQ = dS K D^-1/2,   dK = dS^T Q D^-1/2,
//
// where dK and dV of a KV head sum over its G query heads (GQA).
//
// Three kernels, one block of 4 warps per 64-row tile, each warp 16 rows,
// with the tiles they read in padded shared memory (cp.async, rows past S
// zero-filled):
// - prep, per (b, h, query tile): Delta of each row, and the row's
//   log-sum-exp of the scaled scores (in log2 units) in a pass over the
//   live key tiles of its own.  The forward kernel is left as it is (it
//   saves no statistics), so P is rebuilt here from one more Q K^T product.
// - dq, per (b, h, query tile): over the live key tiles, S = Q K^T and
//   dP = dO V^T, then dQ += dS K with dS rounded to bf16 as the A operand.
// - dkdv, per (b, kv head, key tile): over the G query heads and their live
//   query tiles, S^T = K Q^T and dP^T = V dO^T, then dV += P^T dO and
//   dK += dS^T Q with P^T and dS^T rounded to bf16 as the A operands.
// dQ needs no atomics: the dq kernel recomputes S and dP rather than share
// them with dkdv.  So the work is 8 products of a (query, key) pair where
// a fused kernel with saved statistics needs 5; making it fast is left to
// a redesign (TMA, wgmma).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace {

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::ldmatrix_x4_trans;
using repro::mma_bf16;
using repro::pack_bf16;

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // 4 warps of 16 rows
constexpr int kBT = 64;        // rows of a query or key tile

struct Bwd {
  bf16* dq;
  bf16* dk;
  bf16* dv;
  float* lse;    // (B, H, S): log2 of sum_t 2^(score * scale_log2)
  float* delta;  // (B, H, S): sum_d dO * O
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* o;
  const bf16* dout;
  int S, H, KV, group;
  float scale;       // D^-1/2
  float scale_log2;  // D^-1/2 * log2(e)
  int causal, window;
};

__device__ __forceinline__ bool live(const Bwd& p, int s, int t) {
  return s < p.S && t < p.S && (!p.causal || t <= s) &&
         (p.window <= 0 || t > s - p.window);
}

// The key tiles [lo, hi] with a live key for query rows [q0, q0 + kBT).
__device__ __forceinline__ void key_tiles(const Bwd& p, int q0, int& lo,
                                          int& hi) {
  const int q1 = min(q0 + kBT, p.S) - 1;
  lo = (p.window > 0 ? max(0, q0 - p.window + 1) : 0) / kBT;
  hi = (p.causal ? q1 : p.S - 1) / kBT;
}

// The query tiles [lo, hi] with a live query for key rows [k0, k0 + kBT).
__device__ __forceinline__ void query_tiles(const Bwd& p, int k0, int& lo,
                                            int& hi) {
  const int nt = (p.S + kBT - 1) / kBT;
  const int k1 = min(k0 + kBT, p.S) - 1;
  lo = p.causal ? k0 / kBT : 0;
  hi = p.window > 0 ? min(nt - 1, (k1 + p.window - 1) / kBT) : nt - 1;
}

// Rows [r0, r0 + kBT) of head hh of a contiguous (B, S, heads, D) tensor
// into a padded shared tile; rows past S become zeros.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* base, int b,
                                          int hh, int heads, int r0, int S) {
  constexpr int STRIDE = D + 8;
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < kBT * kChunks; c += kThreads) {
    const int row = c / kChunks, col = (c % kChunks) * 8;
    const int r = r0 + row;
    const bool valid = r < S;
    const bf16* src =
        valid ? base + (((int64_t)b * S + r) * heads + hh) * D + col : base;
    cp_async16(dst + row * STRIDE + col, src, valid);
  }
}

// c (16 rows x 64 cols) = A[row0 .. row0+16) . Bt^T over D: both tiles
// row-major with D contiguous (Q K^T, dO V^T, K Q^T, V dO^T).
template <int D>
__device__ __forceinline__ void mm_abt(float (&c)[8][4], const bf16* A,
                                       int row0, const bf16* Bt, int g,
                                       int tig) {
  constexpr int STRIDE = D + 8, KS = D / 16;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) c[nb][0] = c[nb][1] = c[nb][2] = c[nb][3] = 0.f;
  const bf16* r0 = A + (row0 + g) * STRIDE + tig * 2;
  const bf16* r8 = r0 + 8 * STRIDE;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t a[4];
    a[0] = *reinterpret_cast<const uint32_t*>(r0 + ks * 16);
    a[1] = *reinterpret_cast<const uint32_t*>(r8 + ks * 16);
    a[2] = *reinterpret_cast<const uint32_t*>(r0 + ks * 16 + 8);
    a[3] = *reinterpret_cast<const uint32_t*>(r8 + ks * 16 + 8);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const uint32_t* br = reinterpret_cast<const uint32_t*>(
          Bt + (nb * 8 + g) * STRIDE + tig * 2);
      mma_bf16(c[nb], a, br[ks * 8], br[ks * 8 + 4]);
    }
  }
}

// acc (16 rows x D) += bf16(x) (16 x 64, a C fragment) . T (64 x D, rows
// are the product's k, D contiguous: read transposed with ldmatrix).
template <int D>
__device__ __forceinline__ void mm_xt(float (&acc)[D / 8][4],
                                      const float (&x)[8][4], const bf16* T,
                                      int lane) {
  constexpr int STRIDE = D + 8, ND = D / 8;
#pragma unroll
  for (int kk = 0; kk < kBT / 16; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    a[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    a[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
    const bf16* trow = T + (kk * 16 + (lane & 15)) * STRIDE + (lane >> 4) * 8;
#pragma unroll
    for (int nd2 = 0; nd2 < ND / 2; ++nd2) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, trow + nd2 * 16);
      mma_bf16(acc[2 * nd2], a, bv[0], bv[1]);
      mma_bf16(acc[2 * nd2 + 1], a, bv[2], bv[3]);
    }
  }
}

// Stores acc * mul (16 rows x D, C fragments) as bf16 rows of a contiguous
// (B, S, heads, D) tensor; rows past S are not stored.
template <int D>
__device__ __forceinline__ void store_rows(bf16* base, const float (&acc)[D / 8][4],
                                           float mul, int b, int row0,
                                           int hh, int heads, int S,
                                           int tig) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row < S) {
      bf16* dst = base + (((int64_t)b * S + row) * heads + hh) * D + tig * 2;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        *reinterpret_cast<uint32_t*>(dst + nd * 8) =
            pack_bf16(acc[nd][2 * r] * mul, acc[nd][2 * r + 1] * mul);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) attn_bwd_prep_kernel(Bwd p) {
  constexpr int STRIDE = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kBT * STRIDE;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * kBT, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / p.group;
  const int64_t stat = ((int64_t)b * p.H + h) * p.S;

  load_tile<D>(Qs, p.q, b, h, p.H, q0, p.S);
  cp_async_commit();
  // Delta: lanes over D, one row at a time
  for (int r = 0; r < 16; ++r) {
    const int s = q0 + warp * 16 + r;
    if (s < p.S) {
      const int64_t off = (((int64_t)b * p.S + s) * p.H + h) * D;
      float acc = 0.f;
      for (int d = lane; d < D; d += 32) {
        acc += __bfloat162float(p.o[off + d]) *
               __bfloat162float(p.dout[off + d]);
      }
#pragma unroll
      for (int sh = 16; sh > 0; sh >>= 1) {
        acc += __shfl_xor_sync(0xffffffffu, acc, sh);
      }
      if (lane == 0) p.delta[stat + s] = acc;
    }
  }

  // log-sum-exp over the live keys, online in log2 units
  int lo, hi;
  key_tiles(p, q0, lo, hi);
  const int row0 = q0 + warp * 16 + g;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int j = lo; j <= hi; ++j) {
    __syncthreads();  // every warp is done with the last K tile
    load_tile<D>(Ks, p.k, b, kvh, p.KV, j * kBT, p.S);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float s[8][4];
    mm_abt<D>(s, Qs, warp * 16, Ks, g, tig);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = j * kBT + nb * 8 + tig * 2 + (e & 1);
        const float x = live(p, row0 + (e >> 1) * 8, t)
                            ? s[nb][e] * p.scale_log2
                            : -INFINITY;
        s[nb][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;
      l[r] *= exp2f(m[r] - m_use[r]);
      m[r] = m_new;
    }
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) l[e >> 1] += exp2f(s[nb][e] - m_use[e >> 1]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int row = row0 + r * 8;
    if (row < p.S && tig == 0) p.lse[stat + row] = m[r] + log2f(lr);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) attn_bwd_dq_kernel(Bwd p) {
  constexpr int STRIDE = D + 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + kBT * STRIDE;
  bf16* Ks = dOs + kBT * STRIDE;
  bf16* Vs = Ks + kBT * STRIDE;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int nt = (p.S + kBT - 1) / kBT;
  const int q0 = (nt - 1 - (int)blockIdx.x) * kBT;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / p.group;
  const int64_t stat = ((int64_t)b * p.H + h) * p.S;

  load_tile<D>(Qs, p.q, b, h, p.H, q0, p.S);
  load_tile<D>(dOs, p.dout, b, h, p.H, q0, p.S);
  cp_async_commit();
  const int row0 = q0 + warp * 16 + g;
  float lse[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    lse[r] = row < p.S ? p.lse[stat + row] : 0.f;
    dl[r] = row < p.S ? p.delta[stat + row] : 0.f;
  }
  float dq[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) dq[nd][0] = dq[nd][1] = dq[nd][2] = dq[nd][3] = 0.f;

  int lo, hi;
  key_tiles(p, q0, lo, hi);
  for (int j = lo; j <= hi; ++j) {
    __syncthreads();  // every warp is done with the last K and V tiles
    load_tile<D>(Ks, p.k, b, kvh, p.KV, j * kBT, p.S);
    load_tile<D>(Vs, p.v, b, kvh, p.KV, j * kBT, p.S);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float s[8][4], dp[8][4];
    mm_abt<D>(s, Qs, warp * 16, Ks, g, tig);
    mm_abt<D>(dp, dOs, warp * 16, Vs, g, tig);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int t = j * kBT + nb * 8 + tig * 2 + (e & 1);
        const float pr = live(p, row0 + r * 8, t)
                             ? exp2f(s[nb][e] * p.scale_log2 - lse[r])
                             : 0.f;
        s[nb][e] = pr * (dp[nb][e] - dl[r]);  // dS
      }
    }
    mm_xt<D>(dq, s, Ks, lane);
  }
  store_rows<D>(p.dq, dq, p.scale, b, row0, h, p.H, p.S, tig);
}

template <int D>
__global__ void __launch_bounds__(kThreads) attn_bwd_dkdv_kernel(Bwd p) {
  constexpr int STRIDE = D + 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kBT * STRIDE;
  bf16* Qs = Vs + kBT * STRIDE;
  bf16* dOs = Qs + kBT * STRIDE;
  float* lse_s = reinterpret_cast<float*>(dOs + kBT * STRIDE);
  float* dl_s = lse_s + kBT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int k0 = blockIdx.x * kBT, kvh = blockIdx.y, b = blockIdx.z;

  load_tile<D>(Ks, p.k, b, kvh, p.KV, k0, p.S);
  load_tile<D>(Vs, p.v, b, kvh, p.KV, k0, p.S);
  cp_async_commit();
  const int key0 = k0 + warp * 16 + g;
  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    dk[nd][0] = dk[nd][1] = dk[nd][2] = dk[nd][3] = 0.f;
    dv[nd][0] = dv[nd][1] = dv[nd][2] = dv[nd][3] = 0.f;
  }

  int lo, hi;
  query_tiles(p, k0, lo, hi);
  for (int gi = 0; gi < p.group; ++gi) {
    const int h = kvh * p.group + gi;
    const int64_t stat = ((int64_t)b * p.H + h) * p.S;
    for (int i = lo; i <= hi; ++i) {
      const int q0 = i * kBT;
      __syncthreads();  // every warp is done with the last Q and dO tiles
      load_tile<D>(Qs, p.q, b, h, p.H, q0, p.S);
      load_tile<D>(dOs, p.dout, b, h, p.H, q0, p.S);
      cp_async_commit();
      for (int c = threadIdx.x; c < kBT; c += kThreads) {
        const bool in = q0 + c < p.S;
        lse_s[c] = in ? p.lse[stat + q0 + c] : 0.f;
        dl_s[c] = in ? p.delta[stat + q0 + c] : 0.f;
      }
      cp_async_wait<0>();
      __syncthreads();
      float st[8][4], dpt[8][4];
      mm_abt<D>(st, Ks, warp * 16, Qs, g, tig);    // S^T: keys x queries
      mm_abt<D>(dpt, Vs, warp * 16, dOs, g, tig);  // dP^T
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = nb * 8 + tig * 2 + (e & 1);
          const float pr =
              live(p, q0 + c, key0 + (e >> 1) * 8)
                  ? exp2f(st[nb][e] * p.scale_log2 - lse_s[c])
                  : 0.f;
          st[nb][e] = pr;                         // P^T
          dpt[nb][e] = pr * (dpt[nb][e] - dl_s[c]);  // dS^T
        }
      }
      mm_xt<D>(dv, st, dOs, lane);
      mm_xt<D>(dk, dpt, Qs, lane);
    }
  }
  cp_async_wait<0>();  // the K and V copies, when no query tile was live
  store_rows<D>(p.dk, dk, p.scale, b, key0, kvh, p.KV, p.S, tig);
  store_rows<D>(p.dv, dv, 1.f, b, key0, kvh, p.KV, p.S, tig);
}

template <int D>
cudaError_t launch_bwd(const Bwd& p, int B, cudaStream_t stream) {
  const int tile = kBT * (D + 8) * (int)sizeof(bf16);
  const int nt = (p.S + kBT - 1) / kBT;
  const int smem_prep = 2 * tile, smem_dq = 4 * tile;
  const int smem_dkdv = 4 * tile + 2 * kBT * (int)sizeof(float);
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(attn_bwd_prep_kernel<D>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem_prep)) != cudaSuccess) {
    return e;
  }
  if ((e = cudaFuncSetAttribute(attn_bwd_dq_kernel<D>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem_dq)) != cudaSuccess) {
    return e;
  }
  if ((e = cudaFuncSetAttribute(attn_bwd_dkdv_kernel<D>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem_dkdv)) != cudaSuccess) {
    return e;
  }
  attn_bwd_prep_kernel<D>
      <<<dim3(nt, p.H, B), kThreads, smem_prep, stream>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  attn_bwd_dq_kernel<D><<<dim3(nt, p.H, B), kThreads, smem_dq, stream>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  attn_bwd_dkdv_kernel<D>
      <<<dim3(nt, p.KV, B), kThreads, smem_dkdv, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the last launch (0 == cudaSuccess).
// lse and delta are fp32 (B, H, S) workspaces.  The caller checks dtypes,
// shapes, devices and contiguity and guarantees D in {64, 128}, H % KV == 0,
// and B, H <= 65535.
extern "C" int repro_flash_attention_bwd(
    void* dq, void* dk, void* dv, void* lse, void* delta, const void* q,
    const void* k, const void* v, const void* o, const void* dout, int B,
    int S, int H, int KV, int D, int causal, int window, void* stream) {
  const float scale = 1.f / sqrtf((float)D);
  Bwd p{static_cast<bf16*>(dq), static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), static_cast<float*>(lse),
        static_cast<float*>(delta), static_cast<const bf16*>(q),
        static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
        S, H, KV, H / KV, scale, scale * 1.4426950408889634f, causal,
        window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return (int)launch_bwd<64>(p, B, s);
    case 128: return (int)launch_bwd<128>(p, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
