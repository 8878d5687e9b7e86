// Fused decode-step kernels for Hopper (sm_90a): one transformer block of one
// GPT-2 decode step in two launches, attention and MLP, with bf16 or int8
// (W8A16) weights.
//
//   attention: x_out = x + (ctx @ Wout) * s_out + b_out, where
//              qkv = bf16((bf16(LN1(x)) @ Wqkv) * s_qkv + b_qkv),
//              K/V rows of this step written into the [T, S, D] caches at
//              pos[s] in place, and ctx = bf16(softmax(q k^T / sqrt(hd) +
//              mask) v) per head, in f32 over the bf16 cache;
//   mlp:       x_out = x + (bf16(gelu(bf16(LN2(x)) @ W1 * s1 + b1)) @ W2) * s2 + b2.
//
// The scales exist only for int8 weights.  x_out is rounded to bf16 once.
//
// Replaces the TPU kernels of pytorch_zappa_serverless_tpu/ops/fused_decode.py:
//   fused_attn_step      (_attn_kernel      -> _attn_body, pallas_call in _attn_call)
//   fused_attn_step_int8 (_attn_kernel_int8 -> _attn_body)
//   fused_mlp_step       (_mlp_kernel       -> _mlp_body,  pallas_call in _mlp_call)
//   fused_mlp_step_int8  (_mlp_kernel_int8  -> _mlp_body)
//
// What bounds them on an H100: at S = 8 decode rows each weight byte feeds
// 8 (bf16) or 16 (int8) operations, far below the ~295 operations per byte
// at which the tensor cores would be the limit, so the bytes bound both: at
// GPT-2 small (D = 768, F = 3072, T = 96) an attention launch must read 7.1
// MB (bf16 weights and both caches) and an MLP launch 9.4 MB, 2.1 and 2.8 us
// at 3.35 TB/s.  Measured, the first port (three grid barriers, split-K
// partials through device memory) spent its 45 us on latency instead: the
// per-(row, head) attention phase took 28 us, the projections 3-14 us each,
// each grid barrier ~1.3 us (tools/fused_ablation.py; PERF.md).
//
// The design (each launch one cooperative launch of clusters of C blocks,
// every block resident; ops/fused_decode.py::plan sizes it):
// - Work: projection A takes LN(x) (QKV or fc1), projection B takes what A's
//   phase wrote to device memory (ctx or h1: out or fc2).  A cluster owns
//   whole output columns of an item: one head's q, k and v columns
//   (attention) or a tile of fc1 columns, and a tile of B's columns.  Its C
//   blocks split the item's K rows (split-K).
// - At kernel start one thread of every block issues TMA loads (2-D boxes of
//   the [K, N] weights, one per column segment and chunk, each ring stage on
//   its own mbarrier) of its K slice of BOTH projections' first item and,
//   for attention, of the cached K/V rows of its rows of the head (3-D boxes
//   of the [T, S, D] caches): B's bytes arrive while A computes and while
//   the grid waits at its barrier.  Where a slice exceeds the shared-memory
//   budget (large D or F) it streams through a ring of two stages of K
//   chunks instead.  (One bulk copy per weight row, tried first, took 5 us
//   just to issue: PERF.md.)
// - Products on the tensor cores, mma.sync m16n8k16 bf16 with f32
//   accumulators: the weight tile is the A operand (16 output columns x 16
//   K rows, read transposed from the [K, N] rows in shared memory) and the
//   activation rows the narrow B operand (N = 8 rows, up to 64).  int8
//   weights become bf16 in the fragment through the f32 magic number
//   (hopper::bf16x2_of), exact for |q| <= 127: W8A16, the int8 column scale
//   on the f32 sum.
// - Split-K sums inside the cluster: each block leaves its f32 partial tile
//   in its shared memory; after a cluster barrier each rank sums its share
//   of the outputs over the ranks in rank order 0..C-1 through distributed
//   shared memory, so the result is the same from run to run, and runs the
//   epilogue once per output (scale, bias, bf16 rounding, then GELU or the
//   residual).  Attention: rank r sums the q/k/v of rows s = r, r + C, ...,
//   writes their new K/V rows into the caches at pos[s] and runs the head's
//   softmax attention for them from its shared-memory copy of the cache,
//   the new row spliced in at pos[s] (the JAX kernel does the same with its
//   VMEM copy).
// - One grid barrier per launch, between A's phase and B's: cooperative
//   groups' grid sync, which measured faster than a flag barrier of one
//   block per cluster (tools/fused_ablation.py variant flag_barrier).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MT = 4;     // 16-column tiles per warp, at most: 512 columns per item
constexpr int SEG = 64;   // columns of a segment: one TMA box, 128 (bf16) or 64 (int8) bytes a row
constexpr int MAX_S = 64;
constexpr int MAX_HD = 128;
constexpr int MAX_T = 32768;
constexpr int PLAN_INTS = 32;

// How one projection is cut (ops/fused_decode.py::ProjPlan, the same order):
// K rows per rank (a multiple of 16), rows per ring chunk (a multiple of
// 16 that divides it) and chunks per rank, output columns per item (a
// multiple of SEG) made of nseg segments of SEG columns, each a swizzled
// [kch][SEG] tile of a ring stage (rows `stride` bytes); segw, the columns
// a head's q (k, v) takes in an item (attention's projection A); the
// items; and whether a TMA tensor map can describe the weights.
struct ProjPlan {
  int kslice, kch, nch, ncols, segw, nseg, stride, items, tma;
};

// The launch plan (ops/fused_decode.py::plan, the same field order).
struct Plan {
  int C, ncl;  // cluster size, clusters
  ProjPlan a, b;
  int hs_stride, p_stride, kv_smem, rows_per_rank;
  int off_ring_a, off_ring_b, off_hs, off_part, off_own, off_sc, off_kv, smem;
};
static_assert(sizeof(Plan) == PLAN_INTS * 4, "Plan is PLAN_INTS ints");

constexpr int OFF_BAR = 0;     // 5 mbarriers: ring A stages 0, 1; ring B 0, 1; K/V
constexpr int OFF_STATS = 64;  // mean, rstd of each row
constexpr int OFF_RED = OFF_STATS + 2 * MAX_S * 4;  // WARPS * MAX_HD floats
constexpr int OFF_FIXED_END = OFF_RED + WARPS * MAX_HD * 4;

// One projection: y[S, N] = h[S, K] @ w[K, N] (* scale) + bias.
struct Proj : ProjPlan {
  const void* w;       // [K, N] row-major, bf16 or int8
  const float* scale;  // [N] for int8 weights, else nullptr
  const float* bias;   // [N]
  int K, N;
};

struct Args {
  CUtensorMap map_a, map_b;  // the two projections' weights (when tma)
  CUtensorMap map_k, map_v;  // the caches (attention, when kv_smem)
  const bf16* x;      // [S, D]
  const float* ln_s;  // [D]
  const float* ln_b;  // [D]
  bf16* x_out;        // [S, D]
  bf16* mid;          // [S, A's N]: ctx (attention, [S, D]) or h1 (mlp, [S, F])
  Proj a, b;
  bf16* cache_k;      // [T, S, D] (attention)
  bf16* cache_v;
  const int* pos;     // [S]
  const float* mask;  // [T, S]: the [T, S, 1] additive bias
  int S, D, T, heads, hd, approx_gelu;
  float eps, sm_scale;
  Plan pl;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The sum (or max) of v over the block, the same value in every thread.
template <bool MAX>
__device__ float block_reduce(float v, float* buf) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  v = MAX ? warp_max(v) : warp_sum(v);
  __syncthreads();  // buf is free: every thread has read the last reduction
  if (lane == 0) buf[warp] = v;
  __syncthreads();
  float r = buf[0];
  for (int i = 1; i < WARPS; ++i) r = MAX ? fmaxf(r, buf[i]) : r + buf[i];
  return r;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ int round16(int n) { return (n + 15) & ~15; }

// Output columns of segment `sg` (SEG columns) of an item: attention's
// projection A item is a head, its q, k and v columns (hd <= SEG each, or
// two segments each at hd > SEG); every other item one tile of columns.
__device__ __forceinline__ int segment_col(const Proj& p, const Args& a, bool head_item, int item,
                                           int sg) {
  if (!head_item) return item * p.ncols + sg * SEG;
  const int per = p.nseg / 3;  // segments a head's q (k, v) takes
  return (sg / per) * a.D + item * a.hd + (sg % per) * SEG;
}

// The output columns [col0, col0 + width) of a column-tile item.
__device__ __forceinline__ void item_cols(const Proj& p, int item, int& col0, int& width) {
  col0 = item * p.ncols;
  width = min(p.ncols, p.N - col0);
}

// The byte offset in a segment tile (rows of SEG weights, TMA's 128-byte
// swizzle for bf16 rows of 128 bytes, its 64-byte swizzle for int8 rows of
// 64) of byte `b` of row r: the 16-byte chunk moves to chunk ^ (r % 8), or
// chunk ^ (r / 2 % 4).  The fragment reads of 8 consecutive rows then fall
// in different banks.
template <typename W>
__device__ __forceinline__ int swizzled(int r, int b) {
  const int x = sizeof(W) == 2 ? (r & 7) : ((r >> 1) & 3);
  return r * SEG * (int)sizeof(W) + ((((b >> 4) ^ x)) << 4) + (b & 15);
}

// Rows [k0, k1) of this rank's K slice that chunk `chunk` covers.
__device__ __forceinline__ void chunk_rows(const Proj& p, int rank, int chunk, int& k0, int& k1) {
  const int s0 = rank * p.kslice;
  k0 = s0 + chunk * p.kch;
  k1 = min(min(p.K, s0 + p.kslice), k0 + p.kch);
  if (k1 < k0) k1 = k0;
}

// Bring chunk `chunk` of an item's weights into a ring stage: segment sg's
// [kch][SEG] tile at sg * kch * SEG elements, swizzled, its row r weight
// row k0 + r; rows past K and columns past N are zero.  Called by every
// thread of the block, after the stage's last readers are done; completes
// a phase of `bar`.
template <typename W>
__device__ void issue(const Proj& p, const CUtensorMap* map, const Args& a, bool head_item,
                      int item, int rank, int chunk, unsigned char* stage, uint64_t* bar) {
  const int k0 = rank * p.kslice + chunk * p.kch;
  const int seg_bytes = p.kch * p.stride;
  if (p.tma) {
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_expect_tx(bar, (uint32_t)(p.nseg * seg_bytes));
      for (int sg = 0; sg < p.nseg; ++sg)
        hopper::tma_load_2d(stage + sg * seg_bytes, map, bar,
                            segment_col(p, a, head_item, item, sg), k0);
    }
    return;
  }
  // Weights a tensor map cannot describe (rows not 16-byte aligned):
  // element by element into the same swizzled tiles, then one arrival.
  for (int sg = 0; sg < p.nseg; ++sg) {
    const int col0 = segment_col(p, a, head_item, item, sg);
    unsigned char* dst = stage + sg * seg_bytes;
    for (int i = threadIdx.x; i < p.kch * SEG; i += THREADS) {
      const int r = i / SEG, c = i % SEG;
      const W v = (k0 + r < p.K && col0 + c < p.N)
                      ? static_cast<const W*>(p.w)[(size_t)(k0 + r) * p.N + col0 + c] : W{};
      *reinterpret_cast<W*>(dst + swizzled<W>(r, c * (int)sizeof(W))) = v;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) hopper::mbar_arrive(bar);
}

// The A fragment of mma m16n8k16 (row-major 16 x 16, m = output column, k
// = K row) at (k0, m0) of a swizzled [kch][SEG] segment tile: a[0] = (m,
// k..k+1), a[1] = (m + 8, k..k+1), a[2] = (m, k+8..k+9), a[3] = (m + 8,
// k+8..k+9), lower k in the low half, with m = m0 + lane / 4 and k = k0 +
// 2 (lane % 4).  bf16: one ldmatrix.trans of the four 8 x 8 blocks (lane l
// gives row l % 8 of block l / 8); int8: the bytes one by one, converted
// exactly.  k0 is a multiple of 16, so each lane's swizzle is the same at
// every k0: the lane's address is set once, at k0 = 0.
struct Frag {
  const unsigned char* base;
};

__device__ __forceinline__ Frag frag_base(const bf16*, const unsigned char* seg, int m0) {
  const int l = threadIdx.x % 32, blk = l / 8, r = (blk & 2) * 4 + l % 8;
  return {seg + swizzled<bf16>(r, 2 * (m0 + (blk & 1) * 8))};
}

__device__ __forceinline__ Frag frag_base(const int8_t*, const unsigned char* seg, int m0) {
  const int l = threadIdx.x % 32;
  return {seg + swizzled<int8_t>(2 * (l % 4), m0 + l / 4)};
}

__device__ __forceinline__ void load_a(const bf16*, Frag f, int k0, uint32_t (&a)[4]) {
  const uint32_t addr = hopper::smem_u32(f.base + k0 * SEG * 2);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// Rows 2t and 2t + 1 (and + 8, + 9) share their swizzle (r / 2 % 4 = t),
// and columns m and m + 8 their 16-byte chunk.
__device__ __forceinline__ void load_a(const int8_t*, Frag f, int k0, uint32_t (&a)[4]) {
  const unsigned char* b = f.base + k0 * SEG;
  const uint32_t sel = 0x7650u;
  a[0] = hopper::bf16x2_of(b[0] ^ 0x80u, b[SEG] ^ 0x80u, sel);
  a[1] = hopper::bf16x2_of(b[8] ^ 0x80u, b[SEG + 8] ^ 0x80u, sel);
  a[2] = hopper::bf16x2_of(b[8 * SEG] ^ 0x80u, b[9 * SEG] ^ 0x80u, sel);
  a[3] = hopper::bf16x2_of(b[8 * SEG + 8] ^ 0x80u, b[9 * SEG + 8] ^ 0x80u, sel);
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += the products of one chunk: weight rows [0, rows16) of the stage's
// segments against the chunk's activation tile hs (bf16 [rows][K], rows
// hs_stride bytes apart).  Warp w owns the 16-column tiles w, w + 8, ...;
// every warp covers all NT tiles of 8 activation rows.  The tiles' fragment
// addresses are set once, outside the k loop.
template <typename W, int NT>
__device__ __forceinline__ void mma_chunk(const Proj& p, const unsigned char* stage, int rows16,
                                          const unsigned char* hs, int hs_stride,
                                          float (&acc)[MT][NT][4]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  Frag f[MT];
  int tiles = 0;
#pragma unroll
  for (int j = 0; j < MT; ++j) {
    const int mc = 16 * (warp + WARPS * j);
    if (mc < p.ncols) {
      f[j] = frag_base(static_cast<const W*>(nullptr), stage + (mc / SEG) * p.kch * p.stride,
                       mc % SEG);
      tiles = j + 1;
    }
  }
  const unsigned char* hrow = hs + g * hs_stride + 4 * t;
  for (int k = 0; k < rows16; k += 16) {
    uint32_t b[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const unsigned char* row = hrow + 8 * nt * hs_stride + 2 * k;
      b[nt][0] = *reinterpret_cast<const uint32_t*>(row);
      b[nt][1] = *reinterpret_cast<const uint32_t*>(row + 16);
    }
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      if (j >= tiles) break;
      uint32_t af[4];
      load_a(static_cast<const W*>(nullptr), f[j], k, af);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma16816(acc[j][nt], af, b[nt][0], b[nt][1]);
    }
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ((x - mean) * rstd) * scale + bias, uncontracted, then one rounding to
// bf16: the plain version's order.
__device__ __forceinline__ float ln_value(float x, const float* stats, int s, float scale,
                                          float bias) {
  return __fadd_rn(__fmul_rn(__fmul_rn(x - stats[2 * s], stats[2 * s + 1]), scale), bias);
}

// The activation tile of one chunk, bf16 [S8][16 * ceil(kn / 16)]: K
// columns [k0, k0 + kn) of LN(x) (stats != nullptr) or of `src` [S, K]
// written by this launch before the grid barrier (read past L1).  Rows past
// S and columns past the chunk are zero.  Eight columns a thread with
// 16-byte loads where the rows allow, so one round trip to L2 covers the
// tile.
__device__ void stage_rows(const Args& a, const Proj& p, int k0, int kn, const float* stats,
                           const bf16* src, unsigned char* hs, int S8) {
  const int kw = round16(kn);
  const bool vec = p.K % 8 == 0 && k0 % 8 == 0 &&
                   (stats ? aligned16(a.x) && aligned16(a.ln_s) && aligned16(a.ln_b)
                          : aligned16(src));
  if (vec) {
    const int per_row = kw / 8;
    for (int u = threadIdx.x; u < S8 * per_row; u += THREADS) {
      const int s = u / per_row, k = 8 * (u % per_row), kk = k0 + k;
      uint4 out = make_uint4(0, 0, 0, 0);
      if (s < a.S && k < kn) {
        if (stats) {
          const uint4 xv = *reinterpret_cast<const uint4*>(a.x + (size_t)s * a.D + kk);
          const float4 g0 = *reinterpret_cast<const float4*>(a.ln_s + kk);
          const float4 g1 = *reinterpret_cast<const float4*>(a.ln_s + kk + 4);
          const float4 b0 = *reinterpret_cast<const float4*>(a.ln_b + kk);
          const float4 b1 = *reinterpret_cast<const float4*>(a.ln_b + kk + 4);
          const uint32_t w[4] = {xv.x, xv.y, xv.z, xv.w};
          const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
          const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
          uint32_t o[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float lo = ln_value(__uint_as_float(w[i] << 16), stats, s, g[2 * i], b[2 * i]);
            const float hi = ln_value(__uint_as_float(w[i] & 0xffff0000u), stats, s, g[2 * i + 1],
                                      b[2 * i + 1]);
            const __nv_bfloat162 h2 = __floats2bfloat162_rn(lo, hi);
            o[i] = *reinterpret_cast<const uint32_t*>(&h2);
          }
          out = make_uint4(o[0], o[1], o[2], o[3]);
        } else {
          out = __ldcg(reinterpret_cast<const uint4*>(src + (size_t)s * p.K + kk));
        }
      }
      *reinterpret_cast<uint4*>(hs + s * a.pl.hs_stride + 2 * k) = out;
    }
    return;
  }
  for (int i = threadIdx.x; i < S8 * kw; i += THREADS) {
    const int s = i / kw, k = i % kw, kk = k0 + k;
    float v = 0.f;
    if (s < a.S && k < kn) {
      if (stats) {
        v = ln_value(__bfloat162float(a.x[(size_t)s * a.D + kk]), stats, s, a.ln_s[kk], a.ln_b[kk]);
      } else {
        const unsigned short u =
            __ldcg(reinterpret_cast<const unsigned short*>(src) + (size_t)s * p.K + kk);
        v = __bfloat162float(__ushort_as_bfloat16(u));
      }
    }
    reinterpret_cast<bf16*>(hs + s * a.pl.hs_stride)[k] = __float2bfloat16(v);
  }
}

// Ring bookkeeping, the same in every thread: the parity each stage's next
// wait expects.
struct Ring {
  unsigned char* base;
  uint64_t* bar;
  int stage_bytes;
  uint32_t parity;  // bit st: stage st's
};

// One item of a projection through the ring: its chunks (the first two
// already issued), products into acc, then acc to the block's f32 partial
// tile part[row][column] (p_stride floats a row).
// The activation rows come from LN(x) (stats) or from src, chunk by chunk
// into hs.
// The chunk loop of one item: stage each chunk's activation rows while its
// weights arrive, wait for them, run `mma(stage, rows16)`, and refill the
// stage with the chunk two ahead.
template <typename W, typename Mma>
__device__ __forceinline__ void chunks(const Proj& p, const CUtensorMap* map, const Args& a,
                                       bool head_item, int item, int rank, Ring& ring,
                                       const float* stats, const bf16* src, unsigned char* hs,
                                       int S8, Mma mma) {
  for (int c = 0; c < p.nch; ++c) {
    const int st = c & 1;
    int k0, k1;
    chunk_rows(p, rank, c, k0, k1);
    stage_rows(a, p, k0, k1 - k0, stats, src, hs, S8);  // while the weights arrive
    __syncthreads();
    hopper::mbar_wait(&ring.bar[st], (ring.parity >> st) & 1);
    ring.parity ^= 1u << st;
    mma(ring.base + st * ring.stage_bytes, round16(k1 - k0));
    __syncthreads();  // every warp is done with the stage
    if (c + 2 < p.nch)
      issue<W>(p, map, a, head_item, item, rank, c + 2, ring.base + st * ring.stage_bytes,
               &ring.bar[st]);
  }
}

// One item of a projection through the ring (its first two chunks already
// issued), into the block's f32 partial tile part[row][column] (p_stride
// floats a row).  The activation rows come from LN(x) (stats) or from src.
template <typename W, int NT>
__device__ void project(const Proj& p, const CUtensorMap* map, const Args& a, bool head_item,
                        int item, int rank, Ring& ring, const float* stats, const bf16* src,
                        unsigned char* hs, float* part) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4, ps = a.pl.p_stride, hst = a.pl.hs_stride;
  float acc[MT][NT][4];
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc[j][nt][0] = acc[j][nt][1] = acc[j][nt][2] = acc[j][nt][3] = 0.f;
  chunks<W>(p, map, a, head_item, item, rank, ring, stats, src, hs, 8 * NT,
            [&](const unsigned char* stage, int rows16) {
              mma_chunk<W, NT>(p, stage, rows16, hs, hst, acc);
            });
#pragma unroll
  for (int j = 0; j < MT; ++j) {
    const int m = 16 * (warp + WARPS * j);
    if (m >= p.ncols) break;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = 8 * nt + 2 * t;
      part[n * ps + m + g] = acc[j][nt][0];
      part[(n + 1) * ps + m + g] = acc[j][nt][1];
      part[n * ps + m + g + 8] = acc[j][nt][2];
      part[(n + 1) * ps + m + g + 8] = acc[j][nt][3];
    }
  }
}

// The sum over the cluster's ranks, in rank order, of partial entry `off`
// (floats from the partial tile's start).
__device__ __forceinline__ float cluster_sum(uint32_t part_addr, int off, int C) {
  float v[8];
#pragma unroll
  for (int q = 0; q < 8; ++q)
    if (q < C) v[q] = hopper::ld_cluster_f32(hopper::mapa(part_addr + 4 * off, q));
  float s = v[0];
#pragma unroll
  for (int q = 1; q < 8; ++q)
    if (q < C) s += v[q];
  return s;
}

// y = sum * scale + bias, uncontracted, in the plain version's order.
__device__ __forceinline__ float epilogue(const Proj& p, float sum, int col) {
  if (p.scale) sum = __fmul_rn(sum, p.scale[col]);
  return __fadd_rn(sum, p.bias[col]);
}

// The sum over a row of x of f(value), one warp: lane l adds the values at
// l, l + 32, ... in that order, loading eight of them before it adds them.
template <typename Fn>
__device__ __forceinline__ float row_sum(const Args& a, const bf16* xr, Fn f) {
  const int lane = threadIdx.x % 32;
  float acc = 0.f;
  for (int d0 = lane; d0 < a.D; d0 += 256) {
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = d0 + 32 * j < a.D ? __bfloat162float(xr[d0 + 32 * j]) : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (d0 + 32 * j < a.D) acc += f(v[j]);
  }
  return warp_sum(acc);
}

// Mean and 1/sqrt(population variance + eps) of every row of x, one warp
// per row.
__device__ void ln_stats(const Args& a, float* stats) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int s = warp; s < a.S; s += WARPS) {
    const bf16* xr = a.x + (size_t)s * a.D;
    const float mu = row_sum(a, xr, [](float v) { return v; }) / a.D;
    const float var = row_sum(a, xr, [mu](float v) { return (v - mu) * (v - mu); }) / a.D;
    if (lane == 0) {
      stats[2 * s] = mu;
      stats[2 * s + 1] = rsqrtf(var + a.eps);
    }
  }
}

// Keys (and values) of one row of the K/V copy: T rows of hd, in boxes of
// up to 256 positions; the copy of row r's keys at kv + 2 r kv_region(a)
// bytes, its values kv_region(a) bytes further.
__device__ __forceinline__ int kv_box(const Args& a) { return min(a.T, 256); }

__device__ __forceinline__ int kv_region(const Args& a) {
  const int tb = kv_box(a);
  return ((a.T + tb - 1) / tb * tb * a.hd * 2 + 127) / 128 * 128;
}

// TMA loads of the cached K and V rows of head h for this rank's rows
// s = rank, rank + C, ..., one thread issuing.
__device__ void issue_kv(const Args& a, int h, int rank, unsigned char* kv, uint64_t* bar) {
  if (threadIdx.x != 0) return;
  const int C = a.pl.C, rows = (a.S - rank + C - 1) / C, tb = kv_box(a);
  const int boxes = (a.T + tb - 1) / tb;
  hopper::mbar_arrive_expect_tx(bar, (uint32_t)(rows * 2 * boxes * tb * a.hd * 2));
  for (int r = 0; r < rows; ++r)
    for (int kvi = 0; kvi < 2; ++kvi)
      for (int b = 0; b < boxes; ++b)
        hopper::tma_load_3d(kv + (size_t)(2 * r + kvi) * kv_region(a) + (size_t)b * tb * a.hd * 2,
                            kvi ? &a.map_v : &a.map_k, bar, h * a.hd, rank + C * r, b * tb);
}

// Softmax attention of row s for head h: q, k_new, v_new (f32 values of
// the bf16 projections) in `own`; the cached keys and values from the
// shared-memory copy (kv != nullptr) or from the caches, with the new row
// in place of position p.  ctx (bf16) to a.mid.
__device__ void attend(const Args& a, int s, int h, int p, const float* own, const bf16* kv,
                       float* sc, float* red, bool masked) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int T = a.T, hd = a.hd, segw = a.a.segw;
  const float* q = own;
  const float* kn = own + segw;
  const float* vn = own + 2 * segw;
  if (!masked)  // else sc holds the mask column already (loaded at kernel start)
    for (int t = tid; t < T; t += THREADS) sc[t] = a.mask[(size_t)t * a.S + s];
  __syncthreads();
  const int CH = hd / 8;  // threads per key: 8 dims each, 16-byte loads
  const bool fast = kv && hd % 8 == 0 && 32 % CH == 0;
  if (fast) {
    const bf16* vb = kv + kv_region(a) / 2;
    const int c = tid % CH, d0 = 8 * c;
    float qs[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) qs[j] = q[d0 + j] * a.sm_scale;
    // Every lane of a warp takes the same passes: the shuffles need them all.
    for (int t0 = 0; t0 < T; t0 += THREADS / CH) {
      const int t = t0 + tid / CH;
      float kf[8] = {};
      if (t == p) {
#pragma unroll
        for (int j = 0; j < 8; ++j) kf[j] = kn[d0 + j];
      } else if (t < T) {
        const uint4 u = *reinterpret_cast<const uint4*>(kv + (size_t)t * hd + d0);
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          kf[2 * j] = __uint_as_float(w[j] << 16);
          kf[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
        }
      }
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) dot = fmaf(qs[j], kf[j], dot);
      for (int o = 1; o < CH; o <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (c == 0 && t < T) sc[t] += dot;
    }
  } else {
    const bf16* kb = kv ? kv : a.cache_k + (size_t)s * a.D + h * hd;
    const size_t kst = kv ? hd : (size_t)a.S * a.D;
    for (int t = warp; t < T; t += WARPS) {
      float dot = 0.f;
      if (t == p) {
        for (int d = lane; d < hd; d += 32) dot = fmaf(q[d] * a.sm_scale, kn[d], dot);
      } else {
        for (int d = lane; d < hd; d += 32)
          dot = fmaf(q[d] * a.sm_scale, __bfloat162float(kb[t * kst + d]), dot);
      }
      dot = warp_sum(dot);
      if (lane == 0) sc[t] += dot;
    }
  }
  __syncthreads();
  float m = -INFINITY;
  for (int t = tid; t < T; t += THREADS) m = fmaxf(m, sc[t]);
  m = block_reduce<true>(m, red);
  float l = 0.f;
  for (int t = tid; t < T; t += THREADS) {
    const float e = expf(sc[t] - m);
    sc[t] = e;
    l += e;
  }
  l = block_reduce<false>(l, red);
  for (int t = tid; t < T; t += THREADS) sc[t] = sc[t] / l;
  __syncthreads();
  if (fast) {
    // Thread (group g, chunk c): keys g, g + G, ... for dims 8c..8c+7; the
    // groups of a warp summed by shuffles, the warps' sums in order.
    const bf16* vb = kv + kv_region(a) / 2;
    const int c = tid % CH, d0 = 8 * c, G = THREADS / CH;
    float acc[8] = {};
    for (int t = tid / CH; t < T; t += G) {
      const float pt = sc[t];
      if (t == p) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] = fmaf(pt, vn[d0 + j], acc[j]);
      } else {
        const uint4 u = *reinterpret_cast<const uint4*>(vb + (size_t)t * hd + d0);
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[2 * j] = fmaf(pt, __uint_as_float(w[j] << 16), acc[2 * j]);
          acc[2 * j + 1] = fmaf(pt, __uint_as_float(w[j] & 0xffff0000u), acc[2 * j + 1]);
        }
      }
    }
    for (int o = CH; o < 32; o <<= 1)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
    if (lane < CH)
#pragma unroll
      for (int j = 0; j < 8; ++j) red[warp * hd + d0 + j] = acc[j];
    __syncthreads();
    for (int d = tid; d < hd; d += THREADS) {
      float sum = 0.f;
      for (int w = 0; w < WARPS; ++w) sum += red[w * hd + d];
      a.mid[(size_t)s * a.D + h * hd + d] = __float2bfloat16(sum);
    }
  } else {
    const bf16* vb = kv ? kv + kv_region(a) / 2 : a.cache_v + (size_t)s * a.D + h * hd;
    const size_t kst = kv ? hd : (size_t)a.S * a.D;
    const int G = THREADS / hd;  // key groups of the P.V sum
    if (tid < G * hd) {
      const int gi = tid / hd, d = tid % hd;
      float acc = 0.f;
      for (int t = gi; t < T; t += G)
        acc = fmaf(sc[t], t == p ? vn[d] : __bfloat162float(vb[t * kst + d]), acc);
      red[tid] = acc;
    }
    __syncthreads();
    for (int d = tid; d < hd; d += THREADS) {
      float acc = 0.f;
      for (int gi = 0; gi < G; ++gi) acc += red[gi * hd + d];
      a.mid[(size_t)s * a.D + h * hd + d] = __float2bfloat16(acc);
    }
  }
  __syncthreads();  // sc and red are free for the next row
}

template <typename W, bool ATTN, int NT>
__global__ void __launch_bounds__(THREADS, 1) step(const __grid_constant__ Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Plan& pl = a.pl;
  const int C = pl.C, rank = blockIdx.x % C, cid = blockIdx.x / C;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  float* stats = reinterpret_cast<float*>(smem + OFF_STATS);
  float* red = reinterpret_cast<float*>(smem + OFF_RED);
  unsigned char* hs = smem + pl.off_hs;
  float* part = reinterpret_cast<float*>(smem + pl.off_part);
  const uint32_t part_addr = hopper::smem_u32(part);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 5; ++i) hopper::mbar_init(&bars[i], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  Ring ra = {smem + pl.off_ring_a, bars, pl.a.nseg * pl.a.kch * pl.a.stride, 0};
  Ring rb = {smem + pl.off_ring_b, bars + 2, pl.b.nseg * pl.b.kch * pl.b.stride, 0};
  uint32_t kv_parity = 0;
  unsigned char* kv = pl.kv_smem ? smem + pl.off_kv : nullptr;

  // Both projections' first items and (attention) the head's cached K/V,
  // all in flight before any work.
  if (cid < pl.a.items) {
    for (int c = 0; c < min(2, a.a.nch); ++c)
      issue<W>(a.a, &a.map_a, a, ATTN, cid, rank, c, ra.base + c * ra.stage_bytes, &ra.bar[c]);
    if (ATTN && kv) issue_kv(a, cid, rank, kv, &bars[4]);
  }
  if (cid < pl.b.items)
    for (int c = 0; c < min(2, a.b.nch); ++c)
      issue<W>(a.b, &a.map_b, a, false, cid, rank, c, rb.base + c * rb.stage_bytes, &rb.bar[c]);

  // One attention row a rank (S <= C) and T <= THREADS: its mask column,
  // loaded while LN runs.
  float* sc = reinterpret_cast<float*>(smem + pl.off_sc);
  bool premasked = ATTN && pl.rows_per_rank == 1 && rank < a.S && cid < pl.a.items &&
                   a.T <= THREADS && pl.off_sc != pl.off_part;  // (the plan may share them)
  const float mval = premasked && threadIdx.x < a.T
                         ? a.mask[(size_t)threadIdx.x * a.S + rank] : 0.f;
  ln_stats(a, stats);
  if (premasked && threadIdx.x < a.T) sc[threadIdx.x] = mval;
  __syncthreads();

  // Phase A: QKV + attention per head, or fc1 + GELU per column tile.
  for (int item = cid; item < pl.a.items; item += pl.ncl) {
    if (item != cid) {
      for (int c = 0; c < min(2, a.a.nch); ++c)
        issue<W>(a.a, &a.map_a, a, ATTN, item, rank, c, ra.base + c * ra.stage_bytes, &ra.bar[c]);
      if (ATTN && kv) issue_kv(a, item, rank, kv, &bars[4]);
    }
    project<W, NT>(a.a, &a.map_a, a, ATTN, item, rank, ra, stats, nullptr, hs, part);
    hopper::cluster_sync();  // every rank's partial tile is written
    if (ATTN) {
      float* own = reinterpret_cast<float*>(smem + pl.off_own);
      const int segw = a.a.segw, hd = a.hd;  // segw: one head's q (k, v) columns
      for (int i = threadIdx.x; i < pl.rows_per_rank * 3 * hd; i += THREADS) {
        const int r = i / (3 * hd), sg = (i / hd) % 3, d = i % hd;
        const int s = rank + C * r;
        if (s >= a.S) continue;
        const float y = epilogue(a.a, cluster_sum(part_addr, s * pl.p_stride + sg * segw + d, C),
                                 sg * a.D + item * hd + d);
        own[(r * 3 + sg) * segw + d] = round_bf16(y);
      }
      // `own` is whole: the K/V rows and attend below read entries other
      // threads wrote.  Every rank's sums have read this block's partial
      // tile too where it is rewritten before the grid barrier: by the next
      // item, or by the scores where the plan lets them share it.
      if (item + pl.ncl < pl.a.items || pl.off_sc == pl.off_part) hopper::cluster_sync();
      else __syncthreads();
      if (kv) {
        hopper::mbar_wait(&bars[4], kv_parity);
        kv_parity ^= 1;
      }
      for (int r = 0; r < pl.rows_per_rank; ++r) {
        const int s = rank + C * r;
        if (s >= a.S) break;
        const float* o = own + r * 3 * segw;
        const int p = min(max(a.pos[s], 0), a.T - 1);
        for (int d = threadIdx.x; d < hd; d += THREADS) {
          const size_t at = ((size_t)p * a.S + s) * a.D + item * hd + d;
          a.cache_k[at] = __float2bfloat16(o[segw + d]);
          a.cache_v[at] = __float2bfloat16(o[2 * segw + d]);
        }
        attend(a, s, item, p, o,
               kv ? reinterpret_cast<const bf16*>(kv + (size_t)r * 2 * kv_region(a)) : nullptr, sc,
               red, premasked);
        premasked = false;
      }
    } else {
      int col0, width;
      item_cols(a.a, item, col0, width);
      const int units = a.S * width;
      for (int u = rank * units / C + threadIdx.x; u < (rank + 1) * units / C; u += THREADS) {
        const int s = u / width, j = u % width;
        const float v = epilogue(a.a, cluster_sum(part_addr, s * pl.p_stride + j, C), col0 + j);
        float gl;
        if (a.approx_gelu) {
          const float inner = 0.7978845608028654f * (v + 0.044715f * (v * v * v));
          gl = 0.5f * v * (1.0f + tanhf(inner));
        } else {
          gl = 0.5f * v * (1.0f + erff(v * 0.7071067811865476f));
        }
        a.mid[(size_t)s * a.a.N + col0 + j] = __float2bfloat16(gl);
      }
      if (item + pl.ncl < pl.a.items) hopper::cluster_sync();  // the next item rewrites the tiles
    }
  }

  cooperative_groups::this_grid().sync();  // the one grid-wide barrier

  // Phase B: out or fc2 per column tile, with the residual.
  for (int item = cid; item < pl.b.items; item += pl.ncl) {
    if (item != cid)
      for (int c = 0; c < min(2, a.b.nch); ++c)
        issue<W>(a.b, &a.map_b, a, false, item, rank, c, rb.base + c * rb.stage_bytes, &rb.bar[c]);
    project<W, NT>(a.b, &a.map_b, a, false, item, rank, rb, nullptr, a.mid, hs, part);
    hopper::cluster_sync();
    int col0, width;
    item_cols(a.b, item, col0, width);
    const int units = a.S * width;
    for (int u = rank * units / C + threadIdx.x; u < (rank + 1) * units / C; u += THREADS) {
      const int s = u / width, j = u % width;
      const float y = epilogue(a.b, cluster_sum(part_addr, s * pl.p_stride + j, C), col0 + j);
      const size_t at = (size_t)s * a.D + col0 + j;
      a.x_out[at] = __float2bfloat16(__fadd_rn(__bfloat162float(a.x[at]), y));
    }
    hopper::cluster_sync();
  }
}

// The kernel's dynamic shared-memory limit set to exactly `smem` (the limit
// enters the occupancy a cooperative launch is checked against, so it is
// not left at a larger plan's), once per change of plan on a device.
template <typename W, bool ATTN, int NT>
cudaError_t set_smem(int smem) {
  static int smem_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && smem_set[dev] == smem) return cudaSuccess;
  err = cudaFuncSetAttribute(step<W, ATTN, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && dev < 64) smem_set[dev] = smem;
  return err;
}

template <typename W, bool ATTN, int NT>
int launch_one(const Args& args, cudaStream_t stream) {
  auto kernel = step<W, ATTN, NT>;
  cudaError_t err = set_smem<W, ATTN, NT>(args.pl.smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(args.pl.C * args.pl.ncl);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = args.pl.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = args.pl.C;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  // Every block resident at once: the grid barrier needs it.
  attrs[1].id = cudaLaunchAttributeCooperative;
  attrs[1].val.cooperative = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool ATTN>
int launch(const Args& args, int int8, cudaStream_t s) {
  const bool wide = args.S > 8;
  if (int8) return wide ? launch_one<int8_t, ATTN, 8>(args, s) : launch_one<int8_t, ATTN, 1>(args, s);
  return wide ? launch_one<bf16, ATTN, 8>(args, s) : launch_one<bf16, ATTN, 1>(args, s);
}

template <typename W, bool ATTN, int NT>
int clusters_of(int C, int smem) {
  auto kernel = step<W, ATTN, NT>;
  cudaError_t err = set_smem<W, ATTN, NT>(smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * 64);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

Proj make_proj(const ProjPlan& q, const void* w, const void* scale, const void* bias, int K,
               int N, int int8) {
  Proj p;
  static_cast<ProjPlan&>(p) = q;
  p.w = w;
  p.scale = int8 ? static_cast<const float*>(scale) : nullptr;
  p.bias = static_cast<const float*>(bias);
  p.K = K;
  p.N = N;
  return p;
}

bool bad_proj(const ProjPlan& q, int wb) {
  return q.kslice < 16 || q.kslice % 16 || q.kch < 16 || q.kch % 16 || q.kch > 256 ||
         q.kslice % q.kch || q.nch != q.kslice / q.kch || q.ncols < 16 || q.ncols % 16 ||
         q.ncols > 16 * WARPS * MT || q.segw % 16 || q.nseg * SEG != q.ncols ||
         q.stride != SEG * wb || q.items < 1;
}

bool bad_plan(const Plan& pl, int S, int wb) {
  return pl.C < 1 || pl.C > 8 || pl.ncl < 1 || pl.smem > 232448 || pl.smem < OFF_FIXED_END ||
         bad_proj(pl.a, wb) || bad_proj(pl.b, wb) || S < 1 || S > MAX_S ||
         pl.rows_per_rank != (S + pl.C - 1) / pl.C;
}

// Whether the plan's shared-memory regions are out of place.  They must lie
// in the kernel's order, each aligned (1024 bytes for the swizzled rings,
// 128 for the rest) and clear of the one before, the last ending at or
// below smem, with each region's size the one the kernel indexes, taken
// from the plan's own fields.  The scores may instead start where the
// partial tile does, when the tile holds them.
bool bad_layout(const Plan& pl, int S, int T, int hd, bool attn) {
  const long S8 = S > 8 ? 64 : 8;  // the activation rows of the mma tiles (NT = 8 or 1)
  const long tb = T < 256 ? T : 256;
  const long kv_region = ((T + tb - 1) / tb * tb * hd * 2 + 127) / 128 * 128;
  const long part = S8 * pl.p_stride * 4, sc = attn ? (long)T * 4 : 0;
  const bool share = attn && pl.off_sc == pl.off_part;
  const auto ring = [](const ProjPlan& q) {
    return (long)(q.nch == 1 ? 1 : 2) * q.nseg * q.kch * q.stride;
  };
  const struct { long off, size, align; } regions[] = {
      {pl.off_ring_a, ring(pl.a), 1024},
      {pl.off_ring_b, ring(pl.b), 1024},
      {pl.off_hs, S8 * pl.hs_stride, 128},
      {pl.off_part, share && sc > part ? sc : part, 128},
      {pl.off_own, attn ? (long)pl.rows_per_rank * 3 * pl.a.segw * 4 : 0, 128},
      {share ? -1 : pl.off_sc, sc, 128},  // (shared: inside the partial tile)
      {pl.off_kv, attn && pl.kv_smem ? pl.rows_per_rank * 2 * kv_region : 0, 128},
  };
  long end = OFF_FIXED_END;
  for (const auto& r : regions) {
    if (r.off == -1) continue;
    if (r.off < end || r.off % r.align) return true;
    end = r.off + r.size;
  }
  return end > pl.smem || pl.p_stride < max(pl.a.ncols, pl.b.ncols) ||
         pl.hs_stride < 2 * max(pl.a.kch, pl.b.kch) || pl.hs_stride % 16 ||
         (attn && (pl.a.segw < hd || pl.a.ncols != 3 * pl.a.segw));
}

// The tensor map of a [K, N] weight in boxes of one segment: SEG columns
// by kch rows, swizzled as `swizzled` reads them.
int weight_map(CUtensorMap* map, const ProjPlan& q, const void* w, int K, int N, int int8) {
  const hopper::EncodeTiled fn = hopper::encode_tiled();
  if (!fn) return hopper::ERR_NO_TENSOR_MAP_API;
  const int wb = int8 ? 1 : 2;
  const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)K};
  const cuuint64_t strides[1] = {(cuuint64_t)N * wb};
  const cuuint32_t box[2] = {(cuuint32_t)SEG, (cuuint32_t)q.kch};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        2, const_cast<void*>(w), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        int8 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : hopper::ERR_TENSOR_MAP + (int)r;
}

// The tensor map of a [T, S, D] cache in boxes of one head's row at up to
// 256 positions: hd x 1 x min(T, 256).
int cache_map(CUtensorMap* map, const void* cache, int T, int S, int D, int hd) {
  const hopper::EncodeTiled fn = hopper::encode_tiled();
  if (!fn) return hopper::ERR_NO_TENSOR_MAP_API;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)T};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)hd, 1, (cuuint32_t)(T < 256 ? T : 256)};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(cache), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : hopper::ERR_TENSOR_MAP + (int)r;
}

}  // namespace

// C entry points, bound from Python with ctypes.  Every tensor is contiguous
// and row-major on the current device (the wrapper checks that); `plan`
// holds PLAN_INTS ints (ops/fused_decode.py::plan).  The launches go on
// `stream` without synchronising, and return 0 when launched, else the
// launch's cudaError_t or one of hopper.cuh's ERR_ codes.

// Clusters of C blocks with `smem` bytes each that can be resident at once,
// or -cudaError_t.
extern "C" int fused_decode_clusters(int mlp, int int8, int wide, int C, int smem) {
  if (mlp) {
    if (int8) return wide ? clusters_of<int8_t, false, 8>(C, smem) : clusters_of<int8_t, false, 1>(C, smem);
    return wide ? clusters_of<bf16, false, 8>(C, smem) : clusters_of<bf16, false, 1>(C, smem);
  }
  if (int8) return wide ? clusters_of<int8_t, true, 8>(C, smem) : clusters_of<int8_t, true, 1>(C, smem);
  return wide ? clusters_of<bf16, true, 8>(C, smem) : clusters_of<bf16, true, 1>(C, smem);
}

extern "C" int fused_attn_step_launch(
    int int8, const void* x, const void* ln_s, const void* ln_b, const void* wqkv,
    const void* sqkv, const void* bqkv, const void* wout, const void* sout, const void* bout,
    void* cache_k, void* cache_v, const void* pos, const void* mask, void* x_out, void* ctx,
    int S, int D, int T, int heads, float eps, float sm_scale, const int* plan, void* stream) {
  Args a = {};
  memcpy(&a.pl, plan, sizeof(Plan));
  if (bad_plan(a.pl, S, int8 ? 1 : 2) || heads < 1 || D % heads != 0 || D / heads > MAX_HD ||
      T < 1 || T > MAX_T || bad_layout(a.pl, S, T, D / heads, true))
    return (int)cudaErrorInvalidValue;
  a.x = static_cast<const bf16*>(x);
  a.ln_s = static_cast<const float*>(ln_s);
  a.ln_b = static_cast<const float*>(ln_b);
  a.x_out = static_cast<bf16*>(x_out);
  a.mid = static_cast<bf16*>(ctx);
  a.a = make_proj(a.pl.a, wqkv, sqkv, bqkv, D, 3 * D, int8);
  a.b = make_proj(a.pl.b, wout, sout, bout, D, D, int8);
  a.cache_k = static_cast<bf16*>(cache_k);
  a.cache_v = static_cast<bf16*>(cache_v);
  a.pos = static_cast<const int*>(pos);
  a.mask = static_cast<const float*>(mask);
  a.S = S;
  a.D = D;
  a.T = T;
  a.heads = heads;
  a.hd = D / heads;
  a.eps = eps;
  a.sm_scale = sm_scale;
  int rc = 0;
  if (a.a.tma) rc = weight_map(&a.map_a, a.a, wqkv, D, 3 * D, int8);
  if (!rc && a.b.tma) rc = weight_map(&a.map_b, a.b, wout, D, D, int8);
  if (!rc && a.pl.kv_smem) rc = cache_map(&a.map_k, cache_k, T, S, D, a.hd);
  if (!rc && a.pl.kv_smem) rc = cache_map(&a.map_v, cache_v, T, S, D, a.hd);
  if (rc) return rc;
  return launch<true>(a, int8, static_cast<cudaStream_t>(stream));
}

extern "C" int fused_mlp_step_launch(
    int int8, const void* x, const void* ln_s, const void* ln_b, const void* w1, const void* s1,
    const void* b1, const void* w2, const void* s2, const void* b2, void* x_out, void* h1, int S,
    int D, int F, float eps, int approx_gelu, const int* plan, void* stream) {
  Args a = {};
  memcpy(&a.pl, plan, sizeof(Plan));
  if (bad_plan(a.pl, S, int8 ? 1 : 2) || F < 1 || D < 1 || bad_layout(a.pl, S, 1, D, false))
    return (int)cudaErrorInvalidValue;
  a.x = static_cast<const bf16*>(x);
  a.ln_s = static_cast<const float*>(ln_s);
  a.ln_b = static_cast<const float*>(ln_b);
  a.x_out = static_cast<bf16*>(x_out);
  a.mid = static_cast<bf16*>(h1);
  a.a = make_proj(a.pl.a, w1, s1, b1, D, F, int8);
  a.b = make_proj(a.pl.b, w2, s2, b2, F, D, int8);
  a.S = S;
  a.D = D;
  a.T = 1;
  a.heads = 1;
  a.hd = D;
  a.approx_gelu = approx_gelu;
  a.eps = eps;
  int rc = 0;
  if (a.a.tma) rc = weight_map(&a.map_a, a.a, w1, D, F, int8);
  if (!rc && a.b.tma) rc = weight_map(&a.map_b, a.b, w2, F, D, int8);
  if (rc) return rc;
  return launch<false>(a, int8, static_cast<cudaStream_t>(stream));
}
