// Causal / sliding-window flash attention for Hopper (sm_90a), forward only.
//
//   out[b,s,h,:] = softmax_t(q[b,s,h,:] . k[b,t,h/G,:] * D^-1/2 + mask) @ v[b,t,h/G,:]
//
// mask: t < T always, t <= s when causal, t > s - window when window > 0.
// q is (B,S,H,D), k (B,T,KV,D) and v (B,T,KV,Dv), G = H/KV, read through
// their strides (the last axis contiguous); out is a new contiguous
// (B,S,H,Dv) tensor in q's dtype.  T, the number of keys, is S for
// self-attention; whisper's cross-attention (S decoder tokens over T = 1500
// encoder frames) passes its own, with causal = 0 and window = 0 (the
// caller checks that).  The query tiles, the output, the log-sum-exp and
// the block order stay on S; the key tiles, their tail masks and the K/V
// loads and tensor maps are on T.  Scores, the running (max, sum) and the
// output accumulator are fp32; bf16 or fp32 inputs; (D, Dv) is (32, 32),
// (64, 64), zamba2-2.7b's (80, 80) (d_model 2560 over 32 heads),
// phi-3-vision's (96, 96) (d_model 3072 over 32 heads), (128, 128) or
// MLA's (192, 128) (a template per pair): MLA's prefill folds 64 RoPE dims
// into q and k (128 + 64) and keeps v at 128, where the reference pads v
// with zeros to 192 for its shared kernel and so spends a third of the PV
// products and output bytes on zeros.
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
// pair of q/k/v/out traffic, far above the card's ridge.  The probabilities
// stay fp32 as in the TPU kernel: each is split into a bf16 high part and a
// bf16 remainder, and both go through the tensor cores, so PV costs two
// products and the work is three products where a bf16 P would need two
// (the error is about 2^-16 of p, against 2^-9 for one bf16 rounding; a
// single bf16 P would put outputs near zero outside the one-ulp elementwise
// tolerance that chip_smoke.py's phase 2b holds the kernel to).  At MLA's
// dims that is 2 (192 + 2 x 128) flops a live pair, 1.4x the 2 (192 + 128)
// of the bound.
// Given an lse pointer, the bf16 kernels also store each row's log-sum-exp
// m + log2(l) (log2 units of the scores times D^-1/2 log2 e, fp32, (B, H,
// S)) in their epilogue (the split-key kernel in its merge), for the backward
// (flash_attention_bwd.cu) to rebuild P without a pass of its own; a null
// pointer stores nothing, so serving runs the code it ran before.
// Four kernels:
// - bf16 at (D, Dv) = (128, 128) (the serving path, qwen3-0.6b), MLA's
//   (192, 128) (deepseek-v2-lite's prefill), (80, 80) (zamba2-2.7b's
//   shared attention block, d_model 2560 over 32 heads), (96, 96)
//   (phi-3-vision-4.2b, d_model 3072 over 32 heads) and (64, 64)
//   (whisper-tiny's self- and cross-attention, the reduced configs), one
//   template on (D, Dv): Hopper's shape of a fast kernel.  One block of
//   three warpgroups per (b, h, 128-row query tile): a producer warpgroup
//   whose one elected thread issues TMA copies of Q and of 128-key K/V
//   tiles into a 2-stage ring guarded by mbarriers, and two consumer
//   warpgroups (64 query rows each, registers raised to 240 with
//   setmaxnreg) that run QK^T as wgmma.mma_async m64n128k16 and PV as
//   m64n<Dv>k16, with the online softmax on the fp32 accumulator in
//   registers.  A Q or K row is ceil(D / 64) 128-byte swizzled boxes (one
//   at 64, so S = QK^T is 4 k-steps; three at 192, 12 k-steps; two at 80,
//   the second zero past column 16, so 5 k-steps; two at 96, the second
//   zero past column 32, so 6 k-steps), a V row ceil(Dv / 64).  At 192 a
//   block takes 214,144 bytes of shared memory (Q 48 KB, K 2 x 48, V 2 x
//   32), at 128, 96 and 80 164,992, at 64 82,944 (Q 16 KB, K and V 2 x 16
//   each), one block an SM; a consumer thread holds Dv / 2 fp32 of O (64,
//   48 at 96, 40 at 80, 32 at 64), 64 of S and 64 registers of P's bf16 hi
//   and lo parts.  The blocks run in groups of 16 (b, h) pairs, so that
//   those in flight share K/V through the L2.
// - bf16 at D = Dv = 64 with at most 4 non-causal queries over many keys
//   (whisper-tiny's decode step: one query over 1500 encoder frames, 48
//   (b, h) pairs at batch 8): split keys.  The keys of each (b, h) are cut
//   into ranges, one block of 4 warps a range, so that the pairs fill the
//   card; a lane takes a key for the scores and two output columns for PV,
//   on the FMA units (a 64-row wgmma would waste 63 of its rows), each
//   warp keeping fp32 (m, l, acc) for every query.  The block's merged
//   partial goes to an fp32 scratch, and the last block of a (b, h) to
//   finish (a __threadfence and an atomic counter, which it resets for the
//   next call) merges the ranges in order and writes the output and the
//   lse: one launch a call.  Bound: bytes (K and V read once).
// - bf16, D = 32 (test shapes, the reduced SSM and MLA configs): mma.sync
//   m16n8k16 (bf16 in, fp32 accumulate), flash-attention-2 style: one
//   block of 4 warps per (b, h, 64-row query tile), each warp owning 16
//   query rows; K and V tiles of 64 keys stream through padded shared
//   memory with cp.async, the next K tile loading while this tile's
//   softmax and PV product run.  The score fragment is reused in registers
//   as the A operand of PV.
// - fp32 inputs (the fp32 test configurations, and the card-against-host
//   checks at every head dims) run on the FMA units: one block of 4 warps
//   per (b, h, 32-row tile), a lane per key for the scores and a lane per
//   output column for the PV product (columns lane + 32 i; at Dv = 80 the
//   third group is ragged, lanes 16-31 idle there).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>  // CUtensorMap, PFN_cuTensorMapEncodeTiled
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_sync.cuh"

namespace {

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::ldmatrix_x4_trans;
using repro::mma_bf16;
using repro::pack_bf16;
using repro::smem_addr;
using repro::encode_map;
using repro::ex2;
using repro::fence_regs;
using repro::mbar_arrive;
using repro::mbar_expect_tx;
using repro::mbar_init;
using repro::mbar_wait;
using repro::named_arrive;
using repro::named_sync;
using repro::smem_desc;
using repro::tma_load;
using repro::wgmma_commit;
using repro::wgmma_fence;
using repro::wgmma_rs;
using repro::wgmma_ss;
using repro::wgmma_wait_all;

constexpr int kThreads = 128;  // 4 warps: the mma.sync, split, FMA kernels

struct Params {
  void* out;  // (B, S, H, Dv), contiguous
  float* lse;  // (B, H, S) log-sum-exp for the backward, or null
  const void* q;
  const void* k;
  const void* v;
  int S, T, H, group;  // queries, keys, heads, H / KV
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  float scale_log2;  // D^-1/2 * log2(e) (q's and k's D): scores use exp2
  int causal, window;
};

// The KV tiles [lo, hi] that hold a live key for query rows [q0, q0+bq).
__device__ __forceinline__ void kv_tiles(const Params& p, int q0, int bq,
                                         int bk, int& lo, int& hi) {
  const int q1 = min(q0 + bq, p.S) - 1;
  const int t_hi = p.causal ? q1 : p.T - 1;
  const int t_lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  lo = t_lo / bk;
  hi = t_hi / bk;
}

// True when some (row, key) pair of the tile may be masked.
__device__ __forceinline__ bool tile_needs_mask(const Params& p, int q0,
                                                int bq, int k0, int bk) {
  return k0 + bk > p.T || (p.causal && k0 + bk - 1 > q0) ||
         (p.window > 0 && k0 <= q0 + bq - 1 - p.window);
}

__device__ __forceinline__ bool live(const Params& p, int s, int t) {
  return t < p.T && (!p.causal || t <= s) &&
         (p.window <= 0 || t > s - p.window);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

constexpr int kBQ = 64, kBK = 64;
static_assert(kBQ == kBK, "load_tile_bf16 copies tiles of kBK rows");

// The two bf16 parts of a pair of fp32 probabilities: hi = bf16(p),
// lo = bf16(p - hi).
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(x - __low2float(h), y - __high2float(h));
}

// Copy rows [r0, r0+kBK) of one head of a (B,S,*,D) bf16 tensor into a padded
// shared tile; rows past S (T for keys) become zeros.
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

// (kThreads, 1): without the block count, ptxas capped this kernel at 96
// registers for D = 32 and spilled.  Instantiated at D = 32 only: bf16
// (64, 64) runs the TMA + wgmma kernel or the split-key kernel.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
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
  load_tile_bf16<D, STRIDE>(Ks, kh, p.k_ss, lo * kBK, p.T);
  cp_async_commit();
  load_tile_bf16<D, STRIDE>(Vs, vh, p.v_ss, lo * kBK, p.T);
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
      load_tile_bf16<D, STRIDE>(Ks, kh, p.k_ss, k0 + kBK, p.T);
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
      load_tile_bf16<D, STRIDE>(Vs, vh, p.v_ss, k0 + kBK, p.T);
      cp_async_commit();
      cp_async_wait<1>();  // the next K tile
      __syncthreads();
    }
  }

  // out = O / l and the row's log-sum-exp m + log2(l), rows past S are not
  // stored
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
      if (p.lse != nullptr && tig == 0) {
        p.lse[((int64_t)b * p.H + h) * p.S + row] = m[r] + __log2f(lr);
      }
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
// bf16, (D, Dv) = (128, 128), MLA's (192, 128), zamba2's (80, 80),
// phi-3-vision's (96, 96) or whisper's (64, 64): TMA ring, wgmma,
// warp-specialised
// ---------------------------------------------------------------------------
//
// One block of three warpgroups per (b, h, 128-row query tile).  Warpgroup 0
// is the producer: it gives up registers (setmaxnreg) and one of its
// threads issues every copy.  Q arrives once; K and V tiles of 128 keys
// stream through a ring of kWsStages stages, each operand of each stage
// guarded by a "full" mbarrier (the TMA's transaction bytes) and an
// "empty" one that the 256 consumer threads arrive on once they are done
// with it.  Warpgroups 1 and 2 are consumers, 64 query rows each: S = Q K^T
// is a wgmma with both operands in shared memory, the online softmax runs
// on the fp32 accumulator in registers, and O += P V is a wgmma with P
// taken from registers (hi and lo bf16 parts, as in the mma.sync kernel)
// and V read key-major (the MN-major B operand).  The consumers take turns
// to issue their products, so that one's softmax runs under the other's
// products.  Every tile is made of 128-row boxes of 128-byte rows (64 bf16
// columns) written by the TMA with the 128-byte swizzle, which is the
// layout the wgmma descriptors name: a Q or K row of D values is
// ceil(D / 64) boxes (one at 64, two at 80, 96 or 128, three at 192), a V row
// ceil(Dv / 64); query rows past S, key rows past T, and columns past the
// row's width (80 to 127 of an 80-wide row's second box, 96 to 127 of a
// 96-wide one's), are zero-filled by the TMA.  Tensor maps are 4-D over
// (width, rows, heads, B), rows S for q and T for k and v, with q/k/v's
// own strides, so views are read in place.  The softmax and the consumers' turns are the same at
// every width; PV is wgmma m64n<Dv>k16, and a consumer holds Dv / 2 fp32 of
// O beside 64 of S and 64 registers of P's hi and lo parts.
//
// Block order: groups of kWsGroup (b, h) pairs, the group slowest; in a
// group, the query tiles longest first, and for each tile the group's
// pairs with h fastest.  So the ~132 blocks in flight hold ~132 / kWsGroup
// neighbouring tiles of each of kWsGroup heads, which read the same K/V
// tiles at about the same time and share them through the 50 MB L2 (as
// do the heads of a GQA group), while the grid's tail is the last
// group's shortest tiles.  Up to kWsGroup pairs this is the order with the
// head fastest and the tile slowest; beyond it, that order left one tile
// of each (b, h) in flight (zamba2's prefill, B = 4, H = KV = 32: 128
// pairs on 132 SMs), so every query tile read its K/V from device memory,
// some 10.9 GB a call.

constexpr int kWsBQ = 128;          // query rows a block, 64 a consumer
constexpr int kWsBK = 128;          // keys a KV tile
constexpr int kWsStages = 2;        // depth of the K/V ring
constexpr int kWsConsumers = 2;     // consumer warpgroups
constexpr int kWsGroup = 16;        // (b, h) pairs a group of the block order
constexpr int kWsThreads = 128 * (1 + kWsConsumers);
constexpr int kBoxCols = 64;        // bf16 in a 128-byte swizzled row
constexpr uint32_t kBoxBytes = kWsBK * 128;     // one 128-row box
static_assert(kWsBQ == kWsBK, "Q and K/V tiles share one box height");

// Shared memory at head dims (D, Dv): Q and each K stage are ceil(D / 64)
// boxes, each V stage ceil(Dv / 64); then the barriers, and room to align
// to 1 KB.  At (192, 128) that is 48 + 2 x 48 + 2 x 32 KB, 214,144 bytes
// with the rest (one block an SM, under the 232,448 a block may take); at
// (128, 128), (96, 96) and (80, 80), 164,992; at (64, 64), 16 + 2 x 16 +
// 2 x 16 KB, 82,944.  A deeper ring at 64, where a stage is 32 KB, ran no
// faster on the H100 (3 stages within 0-2.7% of 2, 2 ahead in 7-14 of 20
// reps in turns, 4 behind 3; tools/attn_ab.py, PERF.md).
template <int D, int Dv>
struct WsLayout {
  static_assert(D % 16 == 0 && Dv % 16 == 0, "whole k-steps and n-blocks");
  static constexpr int kBoxes = (D + kBoxCols - 1) / kBoxCols;
  static constexpr int kVBoxes = (Dv + kBoxCols - 1) / kBoxCols;
  static constexpr uint32_t kQKTileBytes = kBoxes * kBoxBytes;
  static constexpr uint32_t kVTileBytes = kVBoxes * kBoxBytes;
  static constexpr int kSmem =
      (1 + kWsStages) * kQKTileBytes + kWsStages * kVTileBytes + 128 + 1024;
};

// S = Q K^T for 64 rows x 128 keys: D / 16 k-steps of 16; step ks lies in
// box ks / 4, 32 bytes a step along its 128-byte rows (at D = 64, 4 steps
// in box 0; at D = 96, 6 steps,
// the last two in box 1, whose columns past 32 are zeros no step reads;
// at D = 80, 5 steps, the last at the start of box 1, whose columns past
// 16 are zeros no step reads; at D = 192, 12 steps over three boxes).
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[64], uint32_t q_rows,
                                         uint32_t k_tile) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint32_t off = (ks / 4) * kBoxBytes + (ks % 4) * 32;
    wgmma_ss(s, smem_desc(q_rows + off, 16, 1024),
             smem_desc(k_tile + off, 16, 1024), ks > 0);
  }
}

// O += P V for 64 rows: P as hi + lo A fragments (one set of 4 registers
// per 16 keys), V rows are keys (the k of this product), Dv contiguous in
// 64-column boxes kBoxBytes apart (the descriptor's leading offset, unused
// at Dv = 64).
template <int Dv>
__device__ __forceinline__ void issue_pv(float (&o)[Dv / 2],
                                         const uint32_t (&pa_hi)[8][4],
                                         const uint32_t (&pa_lo)[8][4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < kWsBK / 16; ++kk) {
    const uint64_t vd = smem_desc(v_tile + kk * 16 * 128, kBoxBytes, 1024);
    wgmma_rs(o, pa_hi[kk], vd);
    wgmma_rs(o, pa_lo[kk], vd);
  }
}

// The online softmax of one score tile in place, on the wgmma accumulator:
// s[4n + e] is row row0 + 8(e/2), key k0 + 8n + 2 tig + (e%2), and a row's
// 128 keys lie in one quad.  s becomes the fp32 probabilities, (m, l) move
// on, and alpha is the factor for O.  Masked scores become -inf without a
// branch per score (with one, the kernel ran markedly slower on the H100);
// the max is taken on the raw scores (the scale is positive).
__device__ __forceinline__ void online_softmax(float (&s)[64], float (&m)[2],
                                               float (&l)[2], float (&alpha)[2],
                                               const Params& p, bool masked,
                                               int row0, int base) {
  if (masked) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the live keys of this row as [first, last], counted from base
      const int row = row0 + 8 * r;
      const int last = (p.causal ? min(row, p.T - 1) : p.T - 1) - base;
      const int first = (p.window > 0 ? row - p.window + 1 : 0) - base;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int key = 8 * n + c;
          if (key < first || key > last) s[4 * n + 2 * r + c] = -INFINITY;
        }
      }
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < 64; ++n) mx[(n >> 1) & 1] = fmaxf(mx[(n >> 1) & 1], s[n]);
  float m_use[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * p.scale_log2);
    m_use[r] = m_new == -INFINITY ? 0.f : m_new;
    alpha[r] = ex2(m[r] - m_use[r]);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int n = 0; n < 64; ++n) {
    const float pe = ex2(fmaf(s[n], p.scale_log2, -m_use[(n >> 1) & 1]));
    s[n] = pe;
    l[(n >> 1) & 1] += pe;
  }
}

// O *= alpha (skipped when no row of the warp moved its max), then P as A
// fragments, each p split into a bf16 high part and a bf16 remainder.
template <int N>
__device__ __forceinline__ void rescale_and_split(float (&o)[N],
                                                  const float (&alpha)[2],
                                                  const float (&s)[64],
                                                  uint32_t (&pa_hi)[8][4],
                                                  uint32_t (&pa_lo)[8][4]) {
  if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
    for (int n = 0; n < N; ++n) o[n] *= alpha[(n >> 1) & 1];
  }
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      split_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], pa_hi[kk][r],
                 pa_lo[kk][r]);
    }
  }
}

// The two consumers take turns to issue their products (named barrier
// 1 + c is consumer c's turn; consumer 0 goes first, and every arrival on
// the other's barrier is matched by one of its waits).
template <int D, int Dv>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_attention_bf16_ws_kernel(const __grid_constant__ CUtensorMap tq,
                                   const __grid_constant__ CUtensorMap tk,
                                   const __grid_constant__ CUtensorMap tv,
                                   Params p, int B) {
  using L = WsLayout<D, Dv>;
  extern __shared__ __align__(16) unsigned char smem_ws[];
  const uint32_t sQ = (smem_addr(smem_ws) + 1023u) & ~1023u;  // swizzle atoms
  const uint32_t sK = sQ + L::kQKTileBytes;     // stage st at st * tile
  const uint32_t sV = sK + kWsStages * L::kQKTileBytes;
  const uint32_t full_q = sV + kWsStages * L::kVTileBytes;  // 8 bytes each
  const uint32_t full_k = full_q + 8;       // TMA bytes of K, per stage
  const uint32_t full_v = full_k + 8 * kWsStages;
  const uint32_t empty_k = full_v + 8 * kWsStages;  // consumers done with K
  const uint32_t empty_v = empty_k + 8 * kWsStages;

  // blockIdx.x as (group, tile, pair in the group), the group slowest;
  // tiles longest first, and the last group may hold fewer pairs
  const int nq = (p.S + kWsBQ - 1) / kWsBQ;
  const int64_t group_blocks = (int64_t)kWsGroup * nq;
  const int group = (int)(blockIdx.x / group_blocks);
  const int width = min(kWsGroup, p.H * B - group * kWsGroup);
  const int in_group = (int)(blockIdx.x - group * group_blocks);
  const int bh = group * kWsGroup + in_group % width;
  const int h = bh % p.H, b = bh / p.H;
  const int q0 = (nq - 1 - in_group / width) * kWsBQ;
  const int kvh = h / p.group;
  int lo, hi;
  kv_tiles(p, q0, kWsBQ, kWsBK, lo, hi);
  const int n_tiles = hi - lo + 1;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int st = 0; st < kWsStages; ++st) {
      mbar_init(full_k + 8 * st, 1);
      mbar_init(full_v + 8 * st, 1);
      mbar_init(empty_k + 8 * st, 128 * kWsConsumers);
      mbar_init(empty_v + 8 * st, 128 * kWsConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      // each operand's own byte count, whole boxes (their zero fill
      // included): with a wrong count a phase never completes (mbar_wait
      // traps and the launch fails) or completes with a box still in
      // flight
      mbar_expect_tx(full_q, L::kQKTileBytes);
#pragma unroll
      for (int c = 0; c < L::kBoxes; ++c) {
        tma_load(sQ + c * kBoxBytes, &tq, full_q, c * kBoxCols, q0, h, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        // tile i is stage i % kWsStages in its (i / kWsStages)-th round
        const int st = i % kWsStages, k0 = (lo + i) * kWsBK;
        const uint32_t ph = (i / kWsStages) & 1;
        const uint32_t k_st = sK + st * L::kQKTileBytes;
        const uint32_t v_st = sV + st * L::kVTileBytes;
        // a fresh barrier passes a wait on parity 1
        mbar_wait(empty_k + 8 * st, ph ^ 1);
        mbar_expect_tx(full_k + 8 * st, L::kQKTileBytes);
#pragma unroll
        for (int c = 0; c < L::kBoxes; ++c) {
          tma_load(k_st + c * kBoxBytes, &tk, full_k + 8 * st, c * kBoxCols,
                   k0, kvh, b);
        }
        mbar_wait(empty_v + 8 * st, ph ^ 1);
        mbar_expect_tx(full_v + 8 * st, L::kVTileBytes);
#pragma unroll
        for (int c = 0; c < L::kVBoxes; ++c) {
          tma_load(v_st + c * kBoxBytes, &tv, full_v + 8 * st, c * kBoxCols,
                   k0, kvh, b);
        }
      }
    }
  } else {
    // consumer: 64 query rows, warp w owning rows 16w..16w+15 of them
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = wg - 1;
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int g = lane >> 2, tig = lane & 3;
    const int rq0 = q0 + 64 * cw;            // this warpgroup's first row
    const int row0 = rq0 + 16 * warp + g;    // this thread's rows: +0, +8
    const uint32_t q_rows = sQ + 64 * cw * 128;
    const int my_turn = 1 + cw, their_turn = 2 - cw;

    float o[Dv / 2];
#pragma unroll
    for (int i = 0; i < Dv / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // rows g and g+8, log2 units
    float l[2] = {0.f, 0.f};              // this thread's part of the sums
    float alpha[2];
    float s[64];                          // scores, then probabilities
    uint32_t pa_hi[8][4], pa_lo[8][4];    // P of the tile before
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) pa_hi[kk][r] = pa_lo[kk][r] = 0u;
    if (cw == 1) named_arrive(1, 2 * 128);
    mbar_wait(full_q, 0);

    // Step i is one turn: the PV product of tile i - 1, then S_i; the
    // softmax of S_i then runs while the other consumer's turn keeps the
    // tensor cores busy.  The PV product is waited for before S_i is
    // issued: P as hi and lo parts takes 64 registers, and with S and O
    // beside it the consumer would spill from Dv = 80 up (at 64, both
    // under one wait ran 0.3-1.1% faster on the H100, ahead in 13-18 reps
    // of 20: a win in nine of ten at one shape of six, so one order serves
    // every width).  No wgmma sits
    // in a branch (that makes ptxas serialize them all): step 0 multiplies
    // a zero P by V_0, which step 1 reads anyway, and the last step
    // computes a discarded S from the Q tile.
    for (int i = 0; i <= n_tiles; ++i) {
      const bool has_s = i < n_tiles, has_pv = i > 0;
      const int pv = has_pv ? i - 1 : 0;  // the tile whose V is read
      const int st = i % kWsStages, sp = pv % kWsStages;
      const int k0 = (lo + i) * kWsBK;
      mbar_wait(full_v + 8 * sp, (pv / kWsStages) & 1);
      if (has_s) mbar_wait(full_k + 8 * st, (i / kWsStages) & 1);
      named_sync(my_turn, 2 * 128);
      wgmma_fence();
      issue_pv<Dv>(o, pa_hi, pa_lo, sV + sp * L::kVTileBytes);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      fence_regs(pa_hi);
      fence_regs(pa_lo);
      if (has_pv) mbar_arrive(empty_v + 8 * sp);
      wgmma_fence();
      issue_qk<D>(s, q_rows, has_s ? sK + st * L::kQKTileBytes : sQ);
      wgmma_commit();
      if (cw == 0 || has_s) named_arrive(their_turn, 2 * 128);
      wgmma_wait_all();
      fence_regs(s);
      if (has_s) {
        mbar_arrive(empty_k + 8 * st);
        online_softmax(s, m, l, alpha, p,
                       tile_needs_mask(p, rq0, 64, k0, kWsBK), row0,
                       k0 + 2 * tig);
        rescale_and_split(o, alpha, s, pa_hi, pa_lo);
      }
    }

    // out = O / l and the row's log-sum-exp m + log2(l), rows past S are
    // not stored
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
    const int64_t o_ss = (int64_t)p.H * Dv;
    const int64_t o_sb = (int64_t)p.S * o_ss;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const float inv = 1.f / fmaxf(lr, 1e-30f);
      const int row = row0 + r * 8;
      if (row < p.S) {
        if (p.lse != nullptr && tig == 0) {
          p.lse[((int64_t)b * p.H + h) * p.S + row] = m[r] + __log2f(lr);
        }
        __nv_bfloat16* dst = out + b * o_sb + row * o_ss + h * Dv + tig * 2;
#pragma unroll
        for (int n = 0; n < Dv / 8; ++n) {
          *reinterpret_cast<uint32_t*>(dst + n * 8) =
              pack_bf16(o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16, D = Dv = 64, at most 4 queries over many keys: split keys
// ---------------------------------------------------------------------------
//
// One block of 4 warps per (b, h, key range): range j is [j * chunk,
// min(T, (j + 1) * chunk)), none empty (the wrapper's split plan).  The
// warps take the range's keys in groups of 32, in turn; in a group a lane
// holds one key's K row (8 x 16 bytes) for the scores of every query, and
// two output columns of the group's V rows for PV, the probabilities
// broadcast by shuffles.  Each warp keeps fp32 (m, l, acc) a query; the
// block merges its warps in shared memory and stores (acc[64], m, l) to
// part[b, h, s, j, :].  The last block of a (b, h) to arrive on its counter
// merges the ranges in order j = 0, 1, ... (so the output does not depend
// on which block came last), writes out and the lse, and sets the counter
// back to 0.  All softmax state is in log2 units, as the other kernels'.
// Bound: bytes, K and V read once (B T KV 256 bytes); the scores and PV
// are 4 S D flops a key and head on the FMA units.

constexpr int kSplitWarps = kThreads / 32;
constexpr int kSplitPart = 66;  // a partial: acc[64], then m and l
constexpr int kSplitMaxQueries = 4;  // past it the TMA kernel is faster

template <int NQ>  // the kernel's query capacity: S <= NQ
__global__ void __launch_bounds__(kThreads)
    flash_attention_split_kernel(Params p, float* part, int* count,
                                 int splits, int chunk) {
  __shared__ float qs[NQ][64];                          // the queries, fp32
  __shared__ float red[kSplitWarps][NQ][kSplitPart];    // warps' partials
  __shared__ int is_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / p.group, bh = b * p.H + h;
  const __nv_bfloat16* qh =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kh =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vh =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  for (int i = threadIdx.x; i < NQ * 64; i += kThreads) {
    const int s = i / 64, d = i % 64;
    qs[s][d] = s < p.S ? __bfloat162float(qh[s * p.q_ss + d]) : 0.f;
  }
  __syncthreads();

  const int t0 = split * chunk, t1 = min(p.T, t0 + chunk);
  float m[NQ], l[NQ], acc[NQ][2];  // l: this lane's share of the sum
#pragma unroll
  for (int s = 0; s < NQ; ++s) {
    m[s] = -INFINITY;
    l[s] = acc[s][0] = acc[s][1] = 0.f;
  }
  for (int base = t0 + 32 * warp; base < t1; base += 32 * kSplitWarps) {
    const int t = base + lane;
    const bool live_key = t < t1;
    // this lane's K row, and two columns of each of the group's V rows
    // (zeros past the range, where the probabilities are 0 too)
    uint4 kr[8];
    const uint4* krow =
        reinterpret_cast<const uint4*>(kh + (live_key ? t : base) * p.k_ss);
#pragma unroll
    for (int c = 0; c < 8; ++c) kr[c] = __ldg(krow + c);
    __nv_bfloat162 vv[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      vv[j] = __floats2bfloat162_rn(0.f, 0.f);
      if (base + j < t1) {
        vv[j] = __ldg(reinterpret_cast<const __nv_bfloat162*>(
            vh + (base + j) * p.v_ss + 2 * lane));
      }
    }
    float kf[64];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const __nv_bfloat162* pair =
          reinterpret_cast<const __nv_bfloat162*>(&kr[c]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(pair[e]);
        kf[8 * c + 2 * e] = f.x;
        kf[8 * c + 2 * e + 1] = f.y;
      }
    }
#pragma unroll
    for (int s = 0; s < NQ; ++s) {
      if (s >= p.S) break;
      float dot[4] = {0.f, 0.f, 0.f, 0.f};  // four chains of 16 FMAs
#pragma unroll
      for (int d = 0; d < 64; ++d)
        dot[d % 4] = fmaf(qs[s][d], kf[d], dot[d % 4]);
      const float x = live_key
                          ? ((dot[0] + dot[1]) + (dot[2] + dot[3])) *
                                p.scale_log2
                          : -INFINITY;
      float mx = x;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[s], mx);  // finite: lane 0's key is live
      const float alpha = ex2(m[s] - m_new);
      const float pe = ex2(x - m_new);
      m[s] = m_new;
      l[s] = l[s] * alpha + pe;
      float a0 = acc[s][0] * alpha, a1 = acc[s][1] * alpha;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float pj = __shfl_sync(0xffffffffu, pe, j);
        const float2 vf = __bfloat1622float2(vv[j]);
        a0 = fmaf(pj, vf.x, a0);
        a1 = fmaf(pj, vf.y, a1);
      }
      acc[s][0] = a0;
      acc[s][1] = a1;
    }
  }

  // the block's partial: the warps merged (a warp without keys has m =
  // -inf, l = 0, acc = 0 and weighs 0)
#pragma unroll
  for (int s = 0; s < NQ; ++s) {
    float ls = l[s];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ls += __shfl_xor_sync(0xffffffffu, ls, off);
    red[warp][s][2 * lane] = acc[s][0];
    red[warp][s][2 * lane + 1] = acc[s][1];
    if (lane == 0) {
      red[warp][s][64] = m[s];
      red[warp][s][65] = ls;
    }
  }
  __syncthreads();
  const int64_t part_bh = (int64_t)bh * p.S * splits;
  for (int i = threadIdx.x; i < p.S * 64; i += kThreads) {
    const int s = i / 64, d = i % 64;
    float mb = -INFINITY;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) mb = fmaxf(mb, red[w][s][64]);
    float a = 0.f, lb = 0.f;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) {
      const float f = ex2(red[w][s][64] - mb);
      a = fmaf(f, red[w][s][d], a);
      lb = fmaf(f, red[w][s][65], lb);
    }
    float* dst = part + (part_bh + (int64_t)s * splits + split) * kSplitPart;
    dst[d] = a;
    if (d == 0) {
      dst[64] = mb;
      dst[65] = lb;
    }
  }
  __threadfence();  // the partial is visible before the counter moves
  __syncthreads();
  if (threadIdx.x == 0) {
    is_last = atomicAdd(count + bh, 1) == splits - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();  // every other block's partial, read from the L2 below

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
  for (int i = threadIdx.x; i < p.S * 64; i += kThreads) {
    const int s = i / 64, d = i % 64;
    const float* src = part + (part_bh + (int64_t)s * splits) * kSplitPart;
    float mx = -INFINITY;
    for (int j = 0; j < splits; ++j)
      mx = fmaxf(mx, __ldcg(src + j * kSplitPart + 64));
    float a = 0.f, lsum = 0.f;
    for (int j = 0; j < splits; ++j) {
      const float f = ex2(__ldcg(src + j * kSplitPart + 64) - mx);
      a = fmaf(f, __ldcg(src + j * kSplitPart + d), a);
      lsum = fmaf(f, __ldcg(src + j * kSplitPart + 65), lsum);
    }
    out[(((int64_t)b * p.S + s) * p.H + h) * 64 + d] =
        __float2bfloat16_rn(a / lsum);
    if (d == 0 && p.lse != nullptr) {
      p.lse[(int64_t)bh * p.S + s] = mx + __log2f(lsum);
    }
  }
  if (threadIdx.x == 0) count[bh] = 0;  // for the next call
}

// the instance that takes S <= kSplitMaxQueries queries
using SplitKernel = void (*)(Params, float*, int*, int, int);
SplitKernel split_kernel(int S) {
  return S == 1   ? flash_attention_split_kernel<1>
         : S == 2 ? flash_attention_split_kernel<2>
                  : flash_attention_split_kernel<4>;
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

// A lane owns output columns lane + 32 i, i < NC; when DV is not a multiple
// of 32 (zamba2's 80) the last group is ragged, and a lane past DV reads
// and stores nothing there.
template <int DV>
__device__ __forceinline__ bool f32_col_live(int lane, int i) {
  return DV % 32 == 0 || lane + 32 * i < DV;
}

template <int D, int DV>
__global__ void __launch_bounds__(kThreads)
    flash_attention_f32_kernel(Params p) {
  constexpr int NC = (DV + 31) / 32;  // output columns per lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [kFBQ][D], broadcast
  float* Ks = Qs + kFBQ * D;                       // [kFBK][D+1], lane = key
  float* Vs = Ks + kFBK * (D + 1);                 // [kFBK][DV], lane = column

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
    load_tile_f32<D>(Ks, D + 1, kh, p.k_ss, k0, kFBK, p.T);
    load_tile_f32<DV>(Vs, DV, vh, p.v_ss, k0, kFBK, p.T);
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
      for (int i = 0; i < NC; ++i) {
        vv[i] = f32_col_live<DV>(lane, i) ? Vs[jj * DV + lane + 32 * i] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pj = __shfl_sync(0xffffffffu, s[r], jj);
#pragma unroll
        for (int i = 0; i < NC; ++i) o[r][i] = fmaf(pj, vv[i], o[r][i]);
      }
    }
  }

  float* out = static_cast<float*>(p.out);
  const int64_t o_ss = (int64_t)p.H * DV;
  const int64_t o_sb = (int64_t)p.S * o_ss;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = rbase + r;
    if (row < p.S) {
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      float* dst = out + b * o_sb + row * o_ss + h * DV;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        if (f32_col_live<DV>(lane, i)) dst[lane + 32 * i] = o[r][i] * inv;
      }
    }
  }
}

// q and k are mapped at their width D, v at Dv: a map narrower than the
// row would not fail, its last box would read zeros past the map's columns.
template <int D, int Dv>
cudaError_t launch_ws(const Params& p, int B, cudaStream_t stream) {
  constexpr int smem = WsLayout<D, Dv>::kSmem;
  const int KV = p.H / p.group;
  CUtensorMap tq, tk, tv;
  if (!encode_map(&tq, p.q, D, p.S, p.H, B, p.q_ss, p.q_sh, p.q_sb, kWsBQ) ||
      !encode_map(&tk, p.k, D, p.T, KV, B, p.k_ss, p.k_sh, p.k_sb, kWsBK) ||
      !encode_map(&tv, p.v, Dv, p.T, KV, B, p.v_ss, p.v_sh, p.v_sb, kWsBK)) {
    return cudaErrorInvalidValue;
  }
  const int64_t blocks = (int64_t)((p.S + kWsBQ - 1) / kWsBQ) * p.H * B;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_bf16_ws_kernel<D, Dv>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  flash_attention_bf16_ws_kernel<D, Dv><<<(unsigned)blocks, kWsThreads, smem,
                                          stream>>>(tq, tk, tv, p, B);
  return cudaGetLastError();
}

template <int D, int DV>
cudaError_t launch(const Params& p, int B, int is_bf16, cudaStream_t stream) {
  if (is_bf16) {
    if constexpr (D >= 64) {  // (64, 64) up to (192, 128)
      return launch_ws<D, DV>(p, B, stream);
    } else {  // D = Dv = 32
      const int smem = (kBQ + 2 * kBK) * (D + 8) * 2;
      cudaError_t e = cudaFuncSetAttribute(
          flash_attention_bf16_kernel<D>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return e;
      const dim3 grid((p.S + kBQ - 1) / kBQ, p.H, B);
      flash_attention_bf16_kernel<D><<<grid, kThreads, smem, stream>>>(p);
    }
  } else {
    const int smem = (kFBQ * D + kFBK * (D + 1) + kFBK * DV) * 4;
    cudaError_t e = cudaFuncSetAttribute(
        flash_attention_f32_kernel<D, DV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid((p.S + kFBQ - 1) / kFBQ, p.H, B);
    flash_attention_f32_kernel<D, DV><<<grid, kThreads, smem, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 == cudaSuccess), or
// cudaErrorInvalidValue for a (D, Dv) pair without a template, a tensor map the
// driver refuses or a grid of 2^31 blocks or more.  Strides are in
// elements; the caller checks devices, dtypes (q/k/v/out all bf16 or all
// fp32), shapes, a unit stride on the last axis, 16-byte aligned rows for
// bf16, S >= 1, T >= 1, causal = window = 0 where T != S, H % KV == 0
// and 1 <= B, H <= 65535.  lse, a contiguous fp32 (B, H, S) tensor or
// null, takes each row's log-sum-exp (bf16 only).
extern "C" int repro_flash_attention(
    void* out, void* lse, const void* q, const void* k, const void* v, int B,
    int S, int T, int H, int KV, int D, int Dv, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, int causal, int window,
    int is_bf16, void* stream) {
  Params p{out,  static_cast<float*>(lse), q, k, v, S, T, H, H / KV, q_sb,
           q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, 0.f, causal,
           window};
  p.scale_log2 = (1.0f / sqrtf((float)D)) * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == Dv) {
    switch (D) {
      case 32: return (int)launch<32, 32>(p, B, is_bf16, s);
      case 64: return (int)launch<64, 64>(p, B, is_bf16, s);
      case 80: return (int)launch<80, 80>(p, B, is_bf16, s);
      case 96: return (int)launch<96, 96>(p, B, is_bf16, s);
      case 128: return (int)launch<128, 128>(p, B, is_bf16, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (D == 192 && Dv == 128) return (int)launch<192, 128>(p, B, is_bf16, s);
  return (int)cudaErrorInvalidValue;
}

// The split-key kernel: bf16 q/k/v at D = Dv = 64, 1 <= S <=
// kSplitMaxQueries queries, non-causal, no window, over T keys cut into
// ``splits`` ranges of ``chunk`` keys (the last ragged; none empty).  part
// is an fp32 scratch of B * H * S * splits * 66 values, count B * H ints
// that are 0 on entry and left 0.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a plan or shape it does not take.
extern "C" int repro_flash_attention_split(
    void* out, void* lse, const void* q, const void* k, const void* v,
    void* part, void* count, int B, int S, int T, int H, int KV, int splits,
    int chunk, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, void* stream) {
  if (S < 1 || S > kSplitMaxQueries || T < 1 || splits < 1 || chunk < 1 ||
      (int64_t)(splits - 1) * chunk >= T || (int64_t)splits * chunk < T ||
      KV < 1 || H % KV != 0 || B > 65535 || H > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  Params p{out,  static_cast<float*>(lse), q, k, v, S, T, H, H / KV, q_sb,
           q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, 0.f, 0, 0};
  p.scale_log2 = 0.125f * 1.4426950408889634f;  // 64^-1/2 log2(e)
  const dim3 grid(splits, H, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  split_kernel(S)<<<grid, kThreads, 0, s>>>(
      p, static_cast<float*>(part), static_cast<int*>(count), splits, chunk);
  return (int)cudaGetLastError();
}

// The split-key kernel's blocks an SM holds at once for S queries (its
// occupancy at kThreads threads, set by its registers), in *blocks; the
// wrapper's split plan reads it.  Returns the CUDA error, or
// cudaErrorInvalidValue for an S it does not take.
extern "C" int repro_flash_attention_split_occupancy(int S, int* blocks) {
  if (S < 1 || S > kSplitMaxQueries) return (int)cudaErrorInvalidValue;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, split_kernel(S), kThreads, 0);
}
