// Backward of the causal / sliding-window flash attention (flash_attention.cu)
// for Hopper (sm_90a): dQ, dK and dV of
//
//   O[b,s,h,:] = softmax_t(q[b,s,h,:] . k[b,t,h/G,:] * D^-1/2 + mask) @ v[b,t,h/G,:]
//
// with the forward kernel's masks (t < T; t <= s when causal; t > s - window
// when window > 0).  The TPU reference has no such kernel: the JAX package
// differentiates its jnp attention.  q, O, dO and dQ are contiguous
// (B,S,H,D) bf16, k, v, dK and dV contiguous (B,T,KV,D) bf16; D is 64, 80
// (zamba2-2.7b), 96 (phi-3-vision-4.2b) or 128; the keys are the queries'
// own (T == S), or at D = 64 non-causal without a window they have a length
// of their own (whisper-tiny's cross-attention: S decoder tokens over T =
// 1500 encoder frames): the key side (key tiles, their tail masks, the K/V
// loads, the dK/dV rows, the grid) runs on T, the query side (query tiles,
// the padded lse, Delta, the dQ scratch and pass) on S; products take bf16 operands
// and accumulate in fp32, and everything between them is fp32.  With lse
// the forward's log-sum-exp of each row (in
// log2 units of the scores times D^-1/2 log2 e, saved by the forward
// kernel), P = 2^(S D^-1/2 log2 e - lse) and Delta_s = sum_d dO[s,d] O[s,d]:
//
//   dV = P^T dO,   dP = dO V^T,   dS = P * (dP - Delta),
//   dQ = dS K D^-1/2,   dK = dS^T Q D^-1/2,
//
// where dK and dV of a KV head sum over its G query heads (GQA).
//
// Bound: operations.  A live (query, key) pair costs 5 products of 2 D
// flops (S, dP, dV, dK, dQ), the least the function needs with P rebuilt
// from the saved lse.  Three launches a call:
// - prep, per row: Delta, the lse padded to whole 64-row tiles (+inf past
//   S, so that P is 0 there) and the zeroed fp32 dQ scratch;
// - the main kernel, one block per (key tile, KV head, b), key tiles in
//   index order so that the longest blocks under the causal mask start
//   first.  dK and dV of the tile sum in registers over the G query heads
//   and their live 64-row query tiles, so they need no atomics; each query
//   tile's dQ share goes into the scratch by the TMA's bulk reduce-add
//   (cp.reduce.async.bulk .add.f32), staged in shared memory in the
//   accumulator's own order (scratch tile [D/8][128 threads][4]: column
//   block n of 8 columns, then thread, then the thread's four values; at
//   80 and 96 the last 64-column box holds 2 or 4 blocks).  The sums into
//   dQ run in no fixed order, so dQ may differ in its last bits from run
//   to run.
// - dq, per element: the scratch times D^-1/2 into the bf16 dQ.
// Score tiles that cross the causal diagonal, the window's edge or T take
// the mask; the others no per-element test.
//
// D = 128 (the qwen3-0.6b layer), 96 and 80: one template on D, a block of
// two consumer warpgroups per 128-key tile, each owning 64 keys (warp w 16
// of them).  A row of Q, K, V or dO is two TMA boxes of 64 columns whose
// tensor maps are D columns wide, so at 80 and 96 the TMA zero-fills
// columns D..127 of the second box (as the forward's maps do at those
// widths) and the shared-memory plan is the same at every D.  Thread 0 also
// starts the TMA loads: K and V once (128-byte swizzle), then each query
// tile's Q and dO (64 rows) with its 64 lse and Delta values (1-D bulk
// copies), one step ahead, into a 2-stage ring of mbarriers ("full" by
// transaction bytes, "empty" once all 256 threads are done with a stage).
// For each query tile, every product a wgmma.mma_async with fp32
// accumulators:
//   S^T = K Q^T, dP^T = V dO^T   (m64n32k16 for each half of the tile's 64
//                                 queries, both operands K-major; D / 16
//                                 k-steps: 8, 6 at 96, 5 at 80)
//   P^T, dS^T                    (on the accumulators, then bf16 into two
//                                 128 x 64 tiles with the 128-byte swizzle)
//   dV += P^T dO, dK += dS^T Q   (m64nDk16, D = 128, 96 or 80: A the
//                                 consumer's rows of those tiles, K-major;
//                                 dO / Q read MN-major through the
//                                 descriptor, no copy, across one whole
//                                 64-column atom and D - 64 columns of
//                                 the next)
//   dQ[:, 64c:64c+64] = dS K     (m64n64k16, consumer c: A the dS^T tile
//                                 read MN-major, B K's box c read
//                                 MN-major; the D columns split by box)
// dQ by box: at 80 and 96 consumer 1's box holds D - 64 = 16 or 32 live
// columns and the rest zeros, and it still runs the m64n64k16 product over
// the whole box and sends only its live columns to the scratch.  A product
// of 16 or 32 columns for consumer 1 alone would be a wgmma under a branch
// on the warpgroup, which ptxas answers by serializing every wgmma of the
// kernel; and halves of D (n40, n48) would start the MN-major B operand
// inside a swizzle atom, which the descriptor cannot name.  The cost is
// 48 or 32 zero columns of one product of five: 1.12x the products a live
// pair at 80, 1.07x at 96.
// dS^T's tile is double-buffered, so one named barrier between the
// consumers an iteration suffices.  Register budget of a consumer thread:
// dK and dV (64 keys x D) stay in 2 x D / 2 fp32 registers for the whole
// loop (128 at D = 128, 96 at 96, 80 at 80); S^T and dP^T of half a tile
// (64 x 32) take 2 x 16 = 32 more, the dQ share (64 x 64) 32 at another
// time; addressing, the softmax and the load requests take the rest of
// the 236 ptxas reports at D = 128, with no spill.
// Two choices follow from that budget.  No producer warpgroup: with a third
// warpgroup the kernel's limit is 65,536 / 384 = 168 registers a thread,
// and ptxas judges whether the products can stay in flight by that limit,
// whatever setmaxnreg gives the consumers afterwards: it serialized every
// wgmma of the kernel and spilled.  At 256 threads the limit is 255.  And
// S^T and dP^T by halves: a whole tile's (64 registers more) put a
// consumer past 255.  Shared memory: K, V 64 KB; 2 stages of Q, dO 64 KB;
// dS^T 2 x 16 KB; P^T 16 KB; dQ staging 2 x 16 KB; lse, Delta, barriers:
// 210 KB, one block an SM, at every D.
//
// D = 64 (test shapes and the reduced qwen3): the same structure on
// mma.sync m16n8k16, one block of 4 warps per 64-key tile, each warp 16
// keys; Q, dO, lse and Delta double-buffered by cp.async in padded shared
// tiles; dS^T through shared memory for the dQ product (read transposed by
// ldmatrix), each warp 16 query rows of it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_sync.cuh"

namespace {

using namespace repro;

using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;  // query rows a tile (both kernels, and the scratch)

struct Bwd {
  bf16* dq;
  bf16* dk;
  bf16* dv;
  const float* lse;  // (B, H, S) from the forward
  float* lse_pad;    // (B, H, S_pad): lse, +inf past S
  float* delta;      // (B, H, S_pad): sum_d dO * O, 0 past S
  float* dq_acc;     // (B, H, S_pad / 64) tiles of 64 x D fp32 (see above)
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* o;
  const bf16* dout;
  int B, S, T, S_pad, H, KV, group;  // S queries over T keys
  float scale;       // D^-1/2
  float scale_log2;  // D^-1/2 * log2(e)
  int causal, window;
};

__device__ __forceinline__ bool live(const Bwd& p, int s, int t) {
  return t < p.T && (!p.causal || t <= s) &&
         (p.window <= 0 || t > s - p.window);
}

// The query tiles [lo, hi] with a live query for keys [k0, k0 + bk).
__device__ __forceinline__ void query_tiles(const Bwd& p, int k0, int bk,
                                            int& lo, int& hi) {
  const int k1 = min(k0 + bk, p.T) - 1;
  lo = p.causal ? k0 / kBQ : 0;
  hi = p.S_pad / kBQ - 1;
  if (p.window > 0) hi = min(hi, (k1 + p.window - 1) / kBQ);
}

// True when some (query, key) pair of rows [q0, q0+64) x keys [k0, k0+bk)
// may be masked (query rows past S need no test: their lse is +inf).
__device__ __forceinline__ bool tile_needs_mask(const Bwd& p, int q0, int k0,
                                                int bk) {
  return k0 + bk > p.T || (p.causal && k0 + bk - 1 > q0) ||
         (p.window > 0 && k0 <= q0 + kBQ - 1 - p.window);
}

// fp32 offset of (b, h, query tile qt) in the dQ scratch
__device__ __forceinline__ int64_t dq_tile(const Bwd& p, int b, int h, int qt,
                                           int D) {
  return (((int64_t)b * p.H + h) * (p.S_pad / kBQ) + qt) * kBQ * D;
}

// ---------------------------------------------------------------------------
// prep and dq passes
// ---------------------------------------------------------------------------

constexpr int kPassThreads = 256;

// A warp a padded row (b, h, s): Delta, the padded lse, and the row's D
// fp32 of dQ scratch zeroed; lane l takes the row's bf16 pairs l, l + 32.
template <int D>
__global__ void __launch_bounds__(kPassThreads) attn_bwd_prep_kernel(Bwd p) {
  constexpr int kPairs = D / 2;  // bf16 pairs a row
  const int lane = threadIdx.x & 31;
  const int64_t rows = (int64_t)p.B * p.H * p.S_pad;
  for (int64_t r = (int64_t)blockIdx.x * (kPassThreads / 32) + threadIdx.x / 32;
       r < rows; r += (int64_t)gridDim.x * (kPassThreads / 32)) {
    const int64_t bh = r / p.S_pad;
    const int s = (int)(r % p.S_pad);
    const int b = (int)(bh / p.H), h = (int)(bh % p.H);
    float acc = 0.f;
    if (s < p.S) {
      const int64_t off = (((int64_t)b * p.S + s) * p.H + h) * D;
#pragma unroll
      for (int j = lane; j < kPairs; j += 32) {
        const float2 o2 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(p.o + off + 2 * j));
        const float2 d2 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(p.dout + off + 2 * j));
        acc += o2.x * d2.x + o2.y * d2.y;
      }
    }
#pragma unroll
    for (int sh = 16; sh > 0; sh >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, sh);
    }
    if (lane == 0) {
      p.delta[r] = acc;
      p.lse_pad[r] = s < p.S ? p.lse[bh * p.S + s] : INFINITY;
    }
    float* z = p.dq_acc + r * D;
#pragma unroll
    for (int j = lane; j < kPairs; j += 32) {
      *reinterpret_cast<float2*>(z + 2 * j) = make_float2(0.f, 0.f);
    }
  }
}

// A thread a float4 of the scratch: the accumulator's (rows g, g + 8;
// columns 2 tig, 2 tig + 1) of column block n (8 columns: 64 c + 8 n over
// the 64-column boxes c), times D^-1/2, into the bf16 dQ; rows past S are
// not stored.
template <int D>
__global__ void __launch_bounds__(kPassThreads) attn_bwd_dq_kernel(Bwd p) {
  constexpr int kTile4 = kBQ * D / 4;  // float4s a query tile
  const int nq = p.S_pad / kBQ;
  const int64_t n4 = (int64_t)p.B * p.H * nq * kTile4;
  for (int64_t f = (int64_t)blockIdx.x * kPassThreads + threadIdx.x; f < n4;
       f += (int64_t)gridDim.x * kPassThreads) {
    const int64_t tile = f / kTile4;
    const int in = (int)(f % kTile4);
    const int t = in % 128, n = (in / 128) % 8, c = in / 1024;
    const int qt = (int)(tile % nq);
    const int64_t bh = tile / nq;
    const int b = (int)(bh / p.H), h = (int)(bh % p.H);
    const int lane = t % 32, g = lane >> 2, tig = lane & 3;
    const int row = qt * kBQ + 16 * (t / 32) + g;
    const int col = 64 * c + 8 * n + 2 * tig;
    const float4 x = reinterpret_cast<const float4*>(p.dq_acc)[f];
    if (row < p.S) {
      *reinterpret_cast<uint32_t*>(
          p.dq + (((int64_t)b * p.S + row) * p.H + h) * D + col) =
          pack_bf16(x.x * p.scale, x.y * p.scale);
    }
    if (row + 8 < p.S) {
      *reinterpret_cast<uint32_t*>(
          p.dq + (((int64_t)b * p.S + row + 8) * p.H + h) * D + col) =
          pack_bf16(x.z * p.scale, x.w * p.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// D = 128, 96, 80: TMA ring, wgmma, two consumer warpgroups
// ---------------------------------------------------------------------------

constexpr int kWBK = 128;            // keys a block, 64 a consumer
constexpr int kWStages = 2;          // depth of the Q / dO ring
constexpr int kWThreads = 256;       // 2 consumer warpgroups
constexpr uint32_t kKVBox = kWBK * 128;          // 128 rows x 64 columns
constexpr uint32_t kKVTile = 2 * kKVBox;         // 128 rows of D <= 128
constexpr uint32_t kQBox = kBQ * 128;            // 64 rows x 64 columns
constexpr uint32_t kQTile = 2 * kQBox;           // 64 rows of D <= 128
constexpr uint32_t kDSBytes = kWBK * kBQ * 2;    // dS^T: 128 keys x 64 rows
constexpr uint32_t kDQBytes = kBQ * 64 * 4;      // a consumer's dQ share
constexpr uint32_t kStatBytes = kBQ * 4;         // 64 lse or Delta values
// shared memory offsets from a 1 KB aligned base
constexpr uint32_t kOffK = 0;
constexpr uint32_t kOffV = kOffK + kKVTile;
constexpr uint32_t kOffQ = kOffV + kKVTile;
constexpr uint32_t kOffDO = kOffQ + kWStages * kQTile;
constexpr uint32_t kOffDS = kOffDO + kWStages * kQTile;
constexpr uint32_t kOffP = kOffDS + 2 * kDSBytes;
constexpr uint32_t kOffDQ = kOffP + kDSBytes;
constexpr uint32_t kOffLse = kOffDQ + 2 * kDQBytes;
constexpr uint32_t kOffDelta = kOffLse + kWStages * kStatBytes;
constexpr uint32_t kOffBar = kOffDelta + kWStages * kStatBytes;
constexpr int kWSmem = kOffBar + 8 * (1 + 2 * kWStages) + 1024;
static_assert(kWSmem <= 232448, "one block's shared memory");
// named barriers: both consumers' dS^T stored; consumer c's dQ staging
constexpr int kBarDS = 1, kBarDQ = 2;

// Shared memory by 32-bit address: a generic pointer would hold two
// registers a base, and the consumers have none to spare.
__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ void st_shared_f4(uint32_t addr, float a, float b,
                                             float c, float d) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "f"(a), "f"(b), "f"(c), "f"(d)
               : "memory");
}
__device__ __forceinline__ float2 ld_shared_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr)
               : "memory");
  return v;
}

// A consumer's 64 x 32 fp32 accumulator (rows = its keys, columns = 32 of
// the tile's queries, from 8 n0) as bf16 into a 128 x 64 tile with the
// 128-byte swizzle: row = key (128 bytes of 64 queries), 16-byte chunk
// n ^ (row % 8).  ``at`` is the tile plus this thread's first row (64 c +
// 16 warp + g) times 128 plus 4 tig.  K-major for a product over the
// queries, MN-major for one over the keys.
__device__ __forceinline__ void store_tile_t(uint32_t at, const float (&x)[16],
                                             int g, int n0) {
#pragma unroll
  for (int n = 0; n < 4; ++n) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      st_shared_u32(at + r * 8 * 128 + (((n0 + n) ^ g) << 4),
                    pack_bf16(x[4 * n + 2 * r], x[4 * n + 2 * r + 1]));
    }
  }
}

// A descriptor moved ``bytes`` along shared memory (16-byte aligned, the
// start field does not overflow: shared memory is under 256 KB).
__device__ __forceinline__ uint64_t desc_at(uint64_t d, uint32_t bytes) {
  return d + (bytes >> 4);
}

// The TMA loads of query tile i of this block into stage i % kWStages:
// Q and dO (two 64-column boxes each), their lse and Delta values.
__device__ __forceinline__ void load_step(const Bwd& p, const CUtensorMap* tq,
                                          const CUtensorMap* tdo,
                                          uint32_t base, uint32_t full, int i,
                                          int nqt, int lo, int kvh, int b) {
  const int h = kvh * p.group + i / nqt;
  const int q0 = (lo + i % nqt) * kBQ;
  const int st = i % kWStages;
  const uint32_t bar = full + 8 * st;
  const uint32_t q_st = base + kOffQ + st * kQTile;
  const uint32_t do_st = base + kOffDO + st * kQTile;
  const int64_t stat = ((int64_t)b * p.H + h) * p.S_pad + q0;
  mbar_expect_tx(bar, 2 * kQTile + 2 * kStatBytes);
  tma_load(q_st, tq, bar, 0, q0, h, b);
  tma_load(q_st + kQBox, tq, bar, 64, q0, h, b);
  tma_load(do_st, tdo, bar, 0, q0, h, b);
  tma_load(do_st + kQBox, tdo, bar, 64, q0, h, b);
  bulk_load(base + kOffLse + st * kStatBytes, p.lse_pad + stat, kStatBytes,
            bar);
  bulk_load(base + kOffDelta + st * kStatBytes, p.delta + stat, kStatBytes,
            bar);
}

// Two consumer warpgroups and no producer warpgroup (see the header):
// thread 0 also starts the loads, each step's one iteration ahead.
template <int D>
__global__ void __launch_bounds__(kWThreads, 1)
    attn_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, Bwd p) {
  static_assert(D == 80 || D == 96 || D == 128, "two boxes a row");
  constexpr int kAcc = D / 2;   // fp32 a thread of 64 keys x D (dK or dV)
  constexpr int kKSteps = D / 16;
  extern __shared__ __align__(16) unsigned char smem_bwd[];
  const uint32_t base = (smem_addr(smem_bwd) + 1023u) & ~1023u;  // swizzle
  const uint32_t full_kv = base + kOffBar;        // K and V, once
  const uint32_t full = full_kv + 8;               // a stage's TMA bytes
  const uint32_t empty = full + 8 * kWStages;      // consumers done with it

  int idx = blockIdx.x;
  const int kvh = idx % p.KV;
  idx /= p.KV;
  const int b = idx % p.B;
  const int k0 = (idx / p.B) * kWBK;  // key tile slowest: longest first
  int lo, hi;
  query_tiles(p, k0, kWBK, lo, hi);
  const int nqt = hi - lo + 1;
  const int n_iter = p.group * nqt;

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int st = 0; st < kWStages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, kWThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(full_kv, 2 * kKVTile);
    tma_load(base + kOffK, &tk, full_kv, 0, k0, kvh, b);
    tma_load(base + kOffK + kKVBox, &tk, full_kv, 64, k0, kvh, b);
    tma_load(base + kOffV, &tv, full_kv, 0, k0, kvh, b);
    tma_load(base + kOffV + kKVBox, &tv, full_kv, 64, k0, kvh, b);
    for (int i = 0; i < kWStages && i < n_iter; ++i) {
      load_step(p, &tq, &tdo, base, full, i, nqt, lo, kvh, b);
    }
  }
  // consumer c: keys k0 + 64c .. + 63, warp w owning 16 of them
  const int c = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int kc0 = k0 + 64 * c;
  const int key0 = kc0 + 16 * warp + g;  // this thread's keys: +0, +8
  // this thread's first row in the P^T and dS^T tiles
  const uint32_t row_at = (64 * c + 16 * warp + g) * 128 + 4 * tig;
  // every descriptor is one of two bases moved along shared memory:
  // K-major operands (and MN-major ones one 64-column atom wide, whose
  // leading offset is unused), and dO / Q read MN-major across D
  const uint64_t d16 = smem_desc(base, 16, 1024);
  const uint64_t dmn = smem_desc(base, kQBox, 1024);

  float dv[kAcc], dk[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) dv[j] = dk[j] = 0.f;
  mbar_wait(full_kv, 0);

  for (int i = 0; i < n_iter; ++i) {
    // step i + 1 into the stage step i - 1 used, once both consumers
    // are done with it (steps 0 and 1 were started before the loop)
    if (threadIdx.x == 0 && i >= 1 && i + 1 < n_iter) {
      mbar_wait(empty + 8 * ((i + 1) % kWStages),
                ((i - 1) / kWStages) & 1);
      load_step(p, &tq, &tdo, base, full, i + 1, nqt, lo, kvh, b);
    }
    const int h = kvh * p.group + i / nqt;
    const int qt = lo + i % nqt;
    const int q0 = qt * kBQ;
    const int st = i % kWStages;
    const uint32_t oQ = kOffQ + st * kQTile;     // dO at oQ + kOffDO - kOffQ
    const uint32_t oDS = kOffDS + (i & 1) * kDSBytes;
    const uint32_t oStat = st * kStatBytes;
    mbar_wait(full + 8 * st, (i / kWStages) & 1);

    // S^T = K Q^T and dP^T = V dO^T, then P^T and dS^T, for one half of
    // the query tile (32 queries) at a time, to keep the consumer's
    // registers within the kernel's limit
    const bool masked = tile_needs_mask(p, q0, kc0, 64);
#pragma unroll
    for (int hq = 0; hq < 2; ++hq) {
      // D / 16 k-steps over D; k-steps 0-3 walk 32 bytes at a time
      // through the first 64-column box, the rest the second
      float s[16], dp[16];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
        const uint32_t ka = c * 64 * 128 + (ks / 4) * kKVBox + (ks % 4) * 32;
        const uint32_t qb =
            oQ + (ks / 4) * kQBox + hq * 32 * 128 + (ks % 4) * 32;
        wgmma_ss32(s, desc_at(d16, kOffK + ka), desc_at(d16, qb), ks > 0);
      }
      wgmma_commit();
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
        const uint32_t ka = c * 64 * 128 + (ks / 4) * kKVBox + (ks % 4) * 32;
        const uint32_t qb = oQ + (kOffDO - kOffQ) + (ks / 4) * kQBox +
                            hq * 32 * 128 + (ks % 4) * 32;
        wgmma_ss32(dp, desc_at(d16, kOffV + ka), desc_at(d16, qb), ks > 0);
      }
      wgmma_commit();

      // P^T on S^T's accumulator while dP^T is in flight: s[4n + 2r + e]
      // is key key0 + 8r, query q0 + 32hq + 8n + 2tig + e
      wgmma_wait<1>();
      fence_regs(s);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int col = 32 * hq + 8 * n + 2 * tig;
        const float2 l2 = ld_shared_f2(base + kOffLse + oStat + 4 * col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pe = ex2(fmaf(s[4 * n + e], p.scale_log2,
                              -((e & 1) ? l2.y : l2.x)));
          if (masked && !live(p, q0 + col + (e & 1), key0 + 8 * (e >> 1))) {
            pe = 0.f;
          }
          s[4 * n + e] = pe;
        }
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int col = 32 * hq + 8 * n + 2 * tig;
        const float2 d2 = ld_shared_f2(base + kOffDelta + oStat + 4 * col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dp[4 * n + e] =
              s[4 * n + e] * (dp[4 * n + e] - ((e & 1) ? d2.y : d2.x));
        }
      }

      // P^T and dS^T in bf16 into their swizzled tiles
      store_tile_t(base + kOffP + row_at, s, g, 4 * hq);
      store_tile_t(base + oDS + row_at, dp, g, 4 * hq);
    }
    fence_proxy_async();

    // dV += P^T dO, dK += dS^T Q: A = this consumer's 64 rows of the P^T
    // / dS^T tile (K-major, the 64 queries are the k of the product, 32
    // bytes a step), B = dO / Q read MN-major (16 query rows a step,
    // 2048 bytes; D's two boxes one box apart)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_ss<0, 1>(dv, desc_at(d16, kOffP + c * 64 * 128 + kk * 32),
                     desc_at(dmn, oQ + (kOffDO - kOffQ) + kk * 2048), 1);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_ss<0, 1>(dk, desc_at(d16, oDS + c * 64 * 128 + kk * 32),
                     desc_at(dmn, oQ + kk * 2048), 1);
    }
    wgmma_commit();

    // dQ[:, 64c .. 64c+63] = dS K over the block's 128 keys, once both
    // consumers' halves of dS^T are stored: A = dS^T read MN-major, B =
    // K's box c read MN-major, keys the k of the product (16 a step); at
    // D < 128 box 1's columns past D are zeros and its product's too
    named_sync(kBarDS, kWThreads);
    float dq[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWBK / 16; ++kk) {
      wgmma_ss64<1, 1>(dq, desc_at(d16, oDS + kk * 2048),
                       desc_at(d16, kOffK + c * kKVBox + kk * 2048),
                       kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(dq);
    mbar_arrive(empty + 8 * st);

    // the dQ share into the scratch: staged in the accumulator's order,
    // then one bulk reduce-add by one thread of the share's live columns
    // (its first min(64, D - 64 c) / 8 column blocks: 16 KB, and 4 or 8
    // KB from box 1 at 80 or 96)
    const uint32_t stage = base + kOffDQ + c * kDQBytes;
    if (t == 0) bulk_wait_read();  // the last tile's share has left
    named_sync(kBarDQ + c, 128);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      st_shared_f4(stage + (n * 128 + t) * 16, dq[4 * n], dq[4 * n + 1],
                   dq[4 * n + 2], dq[4 * n + 3]);
    }
    fence_proxy_async();
    named_sync(kBarDQ + c, 128);
    if (t == 0) {
      bulk_reduce_add_f32(p.dq_acc + dq_tile(p, b, h, qt, D) + c * 4096,
                          stage, (uint32_t)min(64, D - 64 * c) * kBQ * 4);
    }
  }
  if (t == 0) bulk_wait();

  // dK (times D^-1/2) and dV, rows past T are not stored
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key < p.T) {
      const int64_t off = (((int64_t)b * p.T + key) * p.KV + kvh) * D +
                          2 * tig;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<uint32_t*>(p.dk + off + 8 * n) =
            pack_bf16(dk[4 * n + 2 * r] * p.scale,
                      dk[4 * n + 2 * r + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(p.dv + off + 8 * n) =
            pack_bf16(dv[4 * n + 2 * r], dv[4 * n + 2 * r + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// D = 64: mma.sync m16n8k16, cp.async double buffering
// ---------------------------------------------------------------------------

constexpr int kMBK = 64;        // keys a block, 16 a warp
constexpr int kMThreads = 128;  // 4 warps
constexpr int kDSStride = kBQ + 8;  // dS^T rows: 64 queries + padding

// Rows [r0, r0 + 64) of head hh of a contiguous (B, S, heads, D) tensor
// into a padded shared tile; rows past S become zeros.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int b,
                                          int hh, int heads, int r0, int S) {
  constexpr int STRIDE = D + 8;
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  for (int c = threadIdx.x; c < 64 * kChunks; c += kMThreads) {
    const int row = c / kChunks, col = (c % kChunks) * 8;
    const int r = r0 + row;
    const bool valid = r < S;
    const bf16* from =
        valid ? src + (((int64_t)b * S + r) * heads + hh) * D + col : src;
    cp_async16(dst + row * STRIDE + col, from, valid);
  }
}

// c (16 rows x 64 cols) = A[row0 .. row0+16) . Bt^T over D: both tiles
// row-major with D contiguous (K Q^T, V dO^T).
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

// acc (16 rows x D) += A (16 x 16, a k-step's fragment) . T rows
// [16 kk, 16 kk + 16) (rows are the product's k, D contiguous: read
// transposed with ldmatrix).
template <int D>
__device__ __forceinline__ void mm_at(float (&acc)[D / 8][4],
                                      const uint32_t (&a)[4], const bf16* T,
                                      int kk, int lane) {
  constexpr int STRIDE = D + 8;
  const bf16* trow = T + (kk * 16 + (lane & 15)) * STRIDE + (lane >> 4) * 8;
#pragma unroll
  for (int nd2 = 0; nd2 < D / 16; ++nd2) {
    uint32_t bv[4];
    ldmatrix_x4_trans(bv, trow + nd2 * 16);
    mma_bf16(acc[2 * nd2], a, bv[0], bv[1]);
    mma_bf16(acc[2 * nd2 + 1], a, bv[2], bv[3]);
  }
}

// acc (16 rows x D) += bf16(x) (16 x 64, a C fragment) . T (64 x D).
template <int D>
__device__ __forceinline__ void mm_xt(float (&acc)[D / 8][4],
                                      const float (&x)[8][4], const bf16* T,
                                      int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    a[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    a[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
    mm_at<D>(acc, a, T, kk, lane);
  }
}

// Stores acc * mul (16 rows x D, C fragments) as bf16 rows of a contiguous
// (B, S, heads, D) tensor; rows past S are not stored.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst0,
                                           const float (&acc)[D / 8][4],
                                           float mul, int b, int row0, int hh,
                                           int heads, int S, int tig) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row < S) {
      bf16* dst = dst0 + (((int64_t)b * S + row) * heads + hh) * D + tig * 2;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        *reinterpret_cast<uint32_t*>(dst + nd * 8) =
            pack_bf16(acc[nd][2 * r] * mul, acc[nd][2 * r + 1] * mul);
      }
    }
  }
}

template <int D>
constexpr int mma_smem() {
  // K, V; 2 stages of Q, dO; dS^T; 2 stages of lse, Delta; dQ staging
  return (6 * 64 * (D + 8) + 64 * kDSStride) * 2 + 4 * kBQ * 4 + kBQ * D * 4;
}

template <int D>
__global__ void __launch_bounds__(kMThreads) attn_bwd_mma_kernel(Bwd p) {
  constexpr int STRIDE = D + 8, ND = D / 8, TILE = 64 * STRIDE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + TILE;
  bf16* Qs = Vs + TILE;       // [2][TILE]
  bf16* dOs = Qs + 2 * TILE;  // [2][TILE]
  bf16* dSs = dOs + 2 * TILE; // [64 keys][kDSStride]
  float* lse_s = reinterpret_cast<float*>(dSs + 64 * kDSStride);  // [2][64]
  float* dl_s = lse_s + 2 * kBQ;                                   // [2][64]
  float* dq_stage = dl_s + 2 * kBQ;  // [ND][128 threads][4]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;

  int idx = blockIdx.x;
  const int kvh = idx % p.KV;
  idx /= p.KV;
  const int b = idx % p.B;
  const int k0 = (idx / p.B) * kMBK;  // key tile slowest: longest first
  int lo, hi;
  query_tiles(p, k0, kMBK, lo, hi);
  const int nqt = hi - lo + 1;
  const int n_iter = p.group * nqt;

  // Q, dO, lse and Delta of step i into stage i % 2
  auto load_stage = [&](int i) {
    const int h = kvh * p.group + i / nqt;
    const int q0 = (lo + i % nqt) * kBQ;
    const int st = i & 1;
    load_tile<D>(Qs + st * TILE, p.q, b, h, p.H, q0, p.S);
    load_tile<D>(dOs + st * TILE, p.dout, b, h, p.H, q0, p.S);
    const int64_t stat = ((int64_t)b * p.H + h) * p.S_pad + q0;
    const int j = threadIdx.x;
    if (j < 16) {
      cp_async16(lse_s + st * kBQ + 4 * j, p.lse_pad + stat + 4 * j, true);
    } else if (j < 32) {
      cp_async16(dl_s + st * kBQ + 4 * (j - 16), p.delta + stat + 4 * (j - 16),
                 true);
    }
  };
  load_tile<D>(Ks, p.k, b, kvh, p.KV, k0, p.T);
  load_tile<D>(Vs, p.v, b, kvh, p.KV, k0, p.T);
  if (n_iter > 0) load_stage(0);
  cp_async_commit();
  if (n_iter > 1) load_stage(1);
  cp_async_commit();

  const int key0 = k0 + warp * 16 + g;  // this thread's keys: +0, +8
  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    dk[nd][0] = dk[nd][1] = dk[nd][2] = dk[nd][3] = 0.f;
    dv[nd][0] = dv[nd][1] = dv[nd][2] = dv[nd][3] = 0.f;
  }

  for (int i = 0; i < n_iter; ++i) {
    const int h = kvh * p.group + i / nqt;
    const int qt = lo + i % nqt;
    const int q0 = qt * kBQ;
    const int st = i & 1;
    const bf16* Qt = Qs + st * TILE;
    const bf16* dOt = dOs + st * TILE;
    cp_async_wait<1>();  // step i's stage (step i + 1's may still fly)
    __syncthreads();

    float sT[8][4], dpT[8][4];
    mm_abt<D>(sT, Ks, warp * 16, Qt, g, tig);    // S^T: keys x queries
    mm_abt<D>(dpT, Vs, warp * 16, dOt, g, tig);  // dP^T
    const bool masked = tile_needs_mask(p, q0, k0, kMBK);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cq = nb * 8 + tig * 2 + (e & 1);
        float pr = exp2f(sT[nb][e] * p.scale_log2 - lse_s[st * kBQ + cq]);
        if (masked && !live(p, q0 + cq, key0 + (e >> 1) * 8)) pr = 0.f;
        sT[nb][e] = pr;                                          // P^T
        dpT[nb][e] = pr * (dpT[nb][e] - dl_s[st * kBQ + cq]);    // dS^T
      }
    }
    mm_xt<D>(dv, sT, dOt, lane);
    mm_xt<D>(dk, dpT, Qt, lane);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        *reinterpret_cast<uint32_t*>(
            dSs + (warp * 16 + g + 8 * r) * kDSStride + nb * 8 + 2 * tig) =
            pack_bf16(dpT[nb][2 * r], dpT[nb][2 * r + 1]);
      }
    }
    if (threadIdx.x == 0) bulk_wait_read();  // the last tile's dQ has left
    __syncthreads();

    // dQ rows q0 + 16 warp .. + 15 over the 64 keys: dS as the A operand,
    // read from dS^T by ldmatrix with transpose (matrices: rows 0-7 / 8-15
    // of the 16 query rows, keys 0-7 / 8-15 of the k-step)
    float dq[ND][4];
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) dq[nd][0] = dq[nd][1] = dq[nd][2] = dq[nd][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kMBK / 16; ++kk) {
      uint32_t a[4];
      const int key = kk * 16 + ((lane >> 4) & 1) * 8 + (lane & 7);
      ldmatrix_x4_trans(
          a, dSs + key * kDSStride + warp * 16 + ((lane >> 3) & 1) * 8);
      mm_at<D>(dq, a, Ks, kk, lane);
    }
    float4* stage = reinterpret_cast<float4*>(dq_stage);
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      stage[nd * kMThreads + threadIdx.x] =
          make_float4(dq[nd][0], dq[nd][1], dq[nd][2], dq[nd][3]);
    }
    fence_proxy_async();
    __syncthreads();  // staging written; the stage and dS^T are read
    if (threadIdx.x == 0) {
      bulk_reduce_add_f32(p.dq_acc + dq_tile(p, b, h, qt, D),
                          smem_addr(dq_stage), kBQ * D * 4);
    }
    if (i + 2 < n_iter) load_stage(i + 2);
    cp_async_commit();
  }
  cp_async_wait<0>();
  if (threadIdx.x == 0) bulk_wait();
  store_rows<D>(p.dk, dk, p.scale, b, key0, kvh, p.KV, p.T, tig);
  store_rows<D>(p.dv, dv, 1.f, b, key0, kvh, p.KV, p.T, tig);
}

int pass_blocks(int64_t work, int per_block) {
  const int64_t blocks = (work + per_block - 1) / per_block;
  return (int)(blocks < 132 * 32 ? blocks : 132 * 32);
}

template <int D>
cudaError_t launch_bwd(const Bwd& p, cudaStream_t stream) {
  cudaError_t e;
  attn_bwd_prep_kernel<D>
      <<<pass_blocks((int64_t)p.B * p.H * p.S_pad, kPassThreads / 32),
         kPassThreads, 0, stream>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if constexpr (D != 64) {
    CUtensorMap tq, tdo, tk, tv;
    const int64_t qs = (int64_t)p.H * D, ks = (int64_t)p.KV * D;
    if (!encode_map(&tq, p.q, D, p.S, p.H, p.B, qs, D, p.S * qs, kBQ) ||
        !encode_map(&tdo, p.dout, D, p.S, p.H, p.B, qs, D, p.S * qs, kBQ) ||
        !encode_map(&tk, p.k, D, p.T, p.KV, p.B, ks, D, p.T * ks, kWBK) ||
        !encode_map(&tv, p.v, D, p.T, p.KV, p.B, ks, D, p.T * ks, kWBK)) {
      return cudaErrorInvalidValue;
    }
    const int64_t blocks = (int64_t)((p.T + kWBK - 1) / kWBK) * p.KV * p.B;
    if (blocks > INT_MAX) return cudaErrorInvalidValue;
    if ((e = cudaFuncSetAttribute(attn_bwd_wgmma_kernel<D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kWSmem)) != cudaSuccess) {
      return e;
    }
    attn_bwd_wgmma_kernel<D>
        <<<(unsigned)blocks, kWThreads, kWSmem, stream>>>(tq, tdo, tk, tv, p);
  } else {
    const int64_t blocks = (int64_t)((p.T + kMBK - 1) / kMBK) * p.KV * p.B;
    if (blocks > INT_MAX) return cudaErrorInvalidValue;
    if ((e = cudaFuncSetAttribute(attn_bwd_mma_kernel<D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  mma_smem<D>())) != cudaSuccess) {
      return e;
    }
    attn_bwd_mma_kernel<D>
        <<<(unsigned)blocks, kMThreads, mma_smem<D>(), stream>>>(p);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  attn_bwd_dq_kernel<D>
      <<<pass_blocks((int64_t)p.B * p.H * p.S_pad * D / 4, kPassThreads),
         kPassThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the last launch (0 == cudaSuccess), or
// cudaErrorInvalidValue for a head dim other than 64, 80, 96 or 128, keys of
// a length of their own (T != S) other than at D = 64 non-causal without a
// window, no keys, a tensor map cuTensorMapEncodeTiled refuses or a grid of
// 2^31 blocks or more.  q, O, dO are (B, S, H, D), k and v (B, T, KV, D);
// lse is the forward's fp32 (B, H, S); lse_pad and delta are fp32 (B, H,
// S_pad) and dq_acc fp32 (B, H, S_pad, D) workspaces, S_pad = S rounded up
// to 64.  The caller checks dtypes, shapes, devices and contiguity and
// guarantees H % KV == 0.
extern "C" int repro_flash_attention_bwd(
    void* dq, void* dk, void* dv, const void* lse, void* lse_pad, void* delta,
    void* dq_acc, const void* q, const void* k, const void* v, const void* o,
    const void* dout, int B, int S, int T, int H, int KV, int D, int causal,
    int window, void* stream) {
  if (T < 1 || (T != S && (D != 64 || causal || window))) {
    return (int)cudaErrorInvalidValue;
  }
  const float scale = 1.f / sqrtf((float)D);
  Bwd p{static_cast<bf16*>(dq),         static_cast<bf16*>(dk),
        static_cast<bf16*>(dv),         static_cast<const float*>(lse),
        static_cast<float*>(lse_pad),   static_cast<float*>(delta),
        static_cast<float*>(dq_acc),    static_cast<const bf16*>(q),
        static_cast<const bf16*>(k),    static_cast<const bf16*>(v),
        static_cast<const bf16*>(o),    static_cast<const bf16*>(dout),
        B,
        S,
        T,
        (S + kBQ - 1) / kBQ * kBQ,
        H,
        KV,
        H / KV,
        scale,
        scale * 1.4426950408889634f,
        causal,
        window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return (int)launch_bwd<64>(p, s);
    case 80: return (int)launch_bwd<80>(p, s);
    case 96: return (int)launch_bwd<96>(p, s);
    case 128: return (int)launch_bwd<128>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
