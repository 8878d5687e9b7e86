// W8A16 matrix product for Hopper (sm_90a):
//     y[M, N] = (x[M, K] @ bf16(w_q[K, N])) * scale[N]
// with x in bf16 or f32, w_q int8, scale f32 (one per output column), and the
// product accumulated in f32.  y is bf16 or f32, rounded once.
//
// Replaces the TPU kernel pytorch_zappa_serverless_tpu/ops/int8_matmul.py::_kernel
// (reached through int8_matmul).  What it keeps from that kernel: the int8
// weights are the only weight bytes read from device memory, converted to
// bf16 on chip (exact: |q| <= 127 fits bf16's 8-bit significand), so no
// dequantised copy of the weights is ever written; the product is bf16 x
// bf16 with f32 accumulation (W8A16, never W8A8: the activations stay
// bf16); the per-column scale multiplies the f32 accumulator once, in the
// epilogue, which is exact because a column scale commutes with the K sum.
//
// What bounds it on an H100: two regimes.  GPT-2 decode (M = 1 or 8) reads
// each weight byte once for 2·M operations: the weight bytes bound it (one
// position step's 123.6 MB of int8 at 3.35 TB/s is ~0.037 ms).  BERT-base
// at bucket (8, 128), M = 1024, does ~2000 operations per weight byte: the
// tensor cores bound it (72 products, 0.176 ms at 989 TFLOP/s).
//
// bf16 activations (every served path), w8a16_wgmma: one block owns a
// BM x BN output tile and a slice of the K tiles.  A producer warpgroup
// (24 registers after setmaxnreg; one thread issues every copy) keeps a
// ring of STAGES stages in flight by TMA: the x tile [BM, 64] bf16, K-major
// and 128-byte swizzled, and the int8 tile [64, BN] as it lies in w_q.  The
// 2-D tensor maps run over the operands' own row strides and zero-fill past
// M, K and N, so the main loop has no masks.  One or two consumer
// warpgroups (BM = 64 or 128) turn each int8 tile into a bf16 K-major
// 128-byte-swizzled tile [BN, 64] in shared memory, four bytes at a time
// through an f32 magic number (byte permutes, one subtraction, the upper
// halves), release the int8 stage at once, and issue wgmma m64nBNk16 (both
// operands in shared memory, f32 accumulators in registers) as one commit
// group per K tile, waiting one group behind.  The epilogue scales the
// fragments in registers (the tile's scales staged in shared memory while
// the ring fills) and stores them straight to y.  Below one tile of rows
// (decode), x's box stops at M rounded up to 8 rows.
//   Measured, a decode launch is held by latency, not bytes: launched one
// after another, an empty block took ~2 us, and a block's first tiles,
// its reduction and its stores about as much again (tools/int8_ablation.py;
// PERF.md).  So every
// launch is a programmatic dependent launch: each block lets the next
// kernel on the stream start once the grid is resident, and that kernel
// loads its first stages' weights and scales before it waits
// (griddepcontrol.wait) for this one's output, its x.
//   Small M leaves too few output tiles to fill 132 SMs, so the launch
// planner (ops/int8_matmul.py::plan) splits K over up to 8 blocks of one
// thread-block cluster.  Each block writes its f32 partial tile to its own
// shared memory; after a cluster barrier, each rank sums its share of the
// tile over the ranks in fixed rank order through distributed shared
// memory, scales and stores it.  One launch, no workspace, no atomics: the
// result does not depend on which block finishes first.
//
// f32 activations take a plain f32 FMA path on the CUDA cores (not TF32),
// because the TPU kernel multiplies in f32 for f32 inputs.  It masks ragged
// M, K and N itself.  No serving path uses it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 64;  // f32 path: output rows per block
constexpr int BN = 64;  // f32 path: output columns per block
constexpr int FK = 16;  // f32 path: K step

using hopper::bf16x2_of;
using hopper::encode_tiled;
using hopper::EncodeTiled;
using hopper::ERR_NO_TENSOR_MAP_API;
using hopper::ERR_PLAN;
using hopper::ERR_REGISTERS;
using hopper::ERR_TENSOR_MAP;

template <typename O>
__device__ __forceinline__ O from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as XLA's convert
}

// f32 activations: f32 FMA on the CUDA cores.  256 threads in a 16x16 grid;
// thread (ty, tx) owns rows ty + 16*i and columns tx + 16*j of the tile.
template <typename O>
__global__ void __launch_bounds__(256)
w8a16_f32(const float* __restrict__ x, const int8_t* __restrict__ w,
          const float* __restrict__ scale, O* __restrict__ y,
          int M, int K, int N) {
  __shared__ float As[FK][BM + 4];  // x tile, transposed: As[k][m]
  __shared__ float Bs[FK][BN + 4];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += FK) {
    for (int i = tid; i < BM * FK; i += 256) {
      const int r = i / FK, c = i % FK;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : 0.0f;
    }
    for (int i = tid; i < FK * BN; i += 256) {
      const int r = i / BN, c = i % BN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[r][c] = (gk < K && gn < N) ? (float)w[(size_t)gk * N + gn] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gm < M && gn < N) y[(size_t)gm * N + gn] = from_f32<O>(acc[i][j] * scale[gn]);
    }
  }
}

// -- bf16: TMA ring, conversion in shared memory, wgmma, cluster split-K -----

namespace bf16 {

constexpr int BK = 64;             // K per stage: one 128-byte swizzled row of bf16
constexpr int STAGES = 4;          // ring depth (x and int8 tiles)
constexpr int PRODUCER_REGS = 24;  // the producer warpgroup after setmaxnreg

// One tile shape: NC consumer warpgroups of 64 rows (BM = 64·NC), BN output
// columns.  NC = 1 runs two blocks per SM (128 registers a thread at
// launch, split 24 / 232), NC = 2 one (168, split 24 / 240).  The bf16 B
// tile is double-buffered for one warpgroup and triple-buffered for two: a
// buffer is rewritten only once every warpgroup's products on it are done.
// After the main loop the ring's bytes hold the f32 partial tile of a
// split-K block, rows P_LD floats apart.  The tile's BN scales sit after
// the barriers, staged while the ring fills.
template <int NC_, int BN_>
struct Tile {
  static constexpr int NC = NC_, BN = BN_;
  static constexpr int BM = 64 * NC;
  static constexpr int CONSUMERS = 128 * NC;
  static constexpr int THREADS = CONSUMERS + 128;
  static constexpr int MIN_BLOCKS = NC == 1 ? 2 : 1;
  static constexpr int CONSUMER_REGS = NC == 1 ? 232 : 240;
  static constexpr int NB = NC == 1 ? 2 : 3;
  static constexpr int X_BYTES = BM * BK * 2;
  static constexpr int W_BYTES = BK * BN;
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr int X_OFF = 0;
  static constexpr int W_OFF = X_OFF + STAGES * X_BYTES;
  static constexpr int B_OFF = W_OFF + STAGES * W_BYTES;
  static constexpr int BAR_OFF = B_OFF + NB * B_BYTES;
  static constexpr int SCALE_OFF = BAR_OFF + 8 * 3 * STAGES;
  static constexpr int P_LD = BN + 8;
  static constexpr int SMEM = SCALE_OFF + 4 * BN + 1024;  // + base alignment
  static_assert(W_OFF % 1024 == 0 && B_OFF % 1024 == 0, "swizzled tiles are 1024-aligned");
  static_assert(BM * P_LD * 4 <= BAR_OFF, "the partial tile fits in the ring");
  static_assert(SMEM <= 232448, "a block has at most 227 KB of shared memory");
};

// The int8 tile [BK][BN] (rows of BN bytes, as TMA wrote it) to the bf16
// K-major tile [BN][BK] that wgmma reads as B: 128-byte rows, the 16-byte
// chunk c of row n at (c ^ (n % 8)).  A unit is 8 K rows by 4 columns:
// eight 4-byte loads, four 16-byte stores of 8 K values, one per column.
template <class T>
__device__ __forceinline__ void convert(const unsigned char* wt, unsigned char* bt, int ct) {
  constexpr int N4 = T::BN / 4;
  const uint32_t* src = reinterpret_cast<const uint32_t*>(wt);
  for (int u = ct; u < 8 * N4; u += T::CONSUMERS) {
    const int g = u / N4, n4 = u % N4;
    uint32_t w[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i] = src[(8 * g + i) * N4 + n4] ^ 0x80808080u;
#pragma unroll
    for (int step = 0; step < 4; ++step) {
      // Rotated so that 8 neighbouring threads store to 8 different chunks.
      const int j = (step + (n4 >> 1)) & 3;
      const uint32_t sel = 0x7650u | j;
      const int n = 4 * n4 + j;
      uint32_t o[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) o[p] = bf16x2_of(w[2 * p], w[2 * p + 1], sel);
      *reinterpret_cast<uint4*>(bt + n * 128 + ((g ^ (n & 7)) << 4)) =
          make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
}

// The consumers' K loop over nk tiles: wait for a stage, convert its int8
// tile, release it, issue the tile's products, and release the x stage of
// the tile before once its products are done.
template <class T>
__device__ __forceinline__ void mainloop(unsigned char* smem, uint64_t* full, uint64_t* empty_x,
                                         uint64_t* empty_w, int nk, float (&acc)[T::BN / 2]) {
  using namespace hopper;
  const int ct = threadIdx.x, wg = ct / 128, lane = ct % 32;
#pragma unroll
  for (int i = 0; i < T::BN / 2; ++i) acc[i] = 0.0f;
  for (int it = 0; it < nk; ++it) {
    const int st = it % STAGES;
    unsigned char* bt = smem + T::B_OFF + (it % T::NB) * T::B_BYTES;
    mbar_wait(&full[st], (it / STAGES) & 1);
    convert<T>(smem + T::W_OFF + st * T::W_BYTES, bt, ct);
    fence_proxy_async();
    named_barrier_sync(1, T::CONSUMERS);
    if (ct == 0) mbar_arrive(&empty_w[st]);
    const uint32_t xa = smem_u32(smem + T::X_OFF + st * T::X_BYTES) + wg * 64 * 128;
    const uint32_t ba = smem_u32(bt);
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      Wgmma<T::BN>::template ss<0, 0>(acc, desc_sw128(xa + kk * 32, 16, 1024),
                                      desc_sw128(ba + kk * 32, 16, 1024), 1);
    wgmma_commit();
    wgmma_wait<1>();
    fence_operands(acc);
    if (it > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty_x[(it - 1) % STAGES]);
    }
  }
  wgmma_wait<0>();
  fence_operands(acc);
}

// Columns col, col + 1 of one row, scaled and rounded once; `pair` says
// the second is inside N, `aligned` that the pair may be one store.
template <typename O>
__device__ __forceinline__ void store2(O* p, float a, float b, bool pair, bool aligned) {
  if (pair && aligned) {
    if constexpr (sizeof(O) == 4)
      *reinterpret_cast<float2*>(p) = make_float2(a, b);
    else
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
    return;
  }
  p[0] = from_f32<O>(a);
  if (pair) p[1] = from_f32<O>(b);
}

// The whole-K epilogue: scale the fragments in registers and store them.
// Thread t of warpgroup wg holds rows 64·wg + 16·(t/32) + (t%32)/4 (+8) and
// columns 8i + 2·(t%4) (+1).
template <class T, class O>
__device__ __forceinline__ void store_fragments(const float (&acc)[T::BN / 2], const float* sc,
                                                O* __restrict__ y, int M, int N, int m0, int n0) {
  const int t = threadIdx.x % 128, wg = threadIdx.x / 128;
  const int r0 = m0 + 64 * wg + 16 * (t / 32) + (t % 32) / 4;
  const bool aligned = (N & 1) == 0;
#pragma unroll
  for (int i = 0; i < T::BN / 8; ++i) {
    const int c = 8 * i + 2 * (t % 4), col = n0 + c;
    if (col >= N) continue;
    const bool pair = col + 1 < N;
    const float s0 = sc[c], s1 = sc[c + 1];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = r0 + 8 * hr;
      if (row < M)
        store2<O>(y + (size_t)row * N + col, acc[4 * i + 2 * hr] * s0,
                  acc[4 * i + 2 * hr + 1] * s1, pair, aligned);
    }
  }
}

// Split-K: the block's partial tile to its own shared memory, then each
// rank sums its share of the tile's valid rows over the ranks in rank
// order 0, 1, ... (4 columns at a time), scales and stores it.  A thread
// issues the loads from every rank before it sums them, so the remote
// reads overlap.  The second cluster barrier keeps every block's shared
// memory alive until all ranks have read it.
template <class T, class O>
__device__ __forceinline__ void reduce_cluster(unsigned char* smem, const float (&acc)[T::BN / 2],
                                               const float* sc, O* __restrict__ y, int M, int N,
                                               int m0, int n0, int rank, int splits) {
  using namespace hopper;
  named_barrier_sync(1, T::CONSUMERS);  // every consumer's products are done: the ring is free
  float* part = reinterpret_cast<float*>(smem);
  const int t = threadIdx.x % 128, wg = threadIdx.x / 128;
  const int r = 64 * wg + 16 * (t / 32) + (t % 32) / 4;
  const int rows = min(T::BM, M - m0);
#pragma unroll
  for (int i = 0; i < T::BN / 8; ++i) {
    const int c = 8 * i + 2 * (t % 4);
    if (r < rows)
      *reinterpret_cast<float2*>(part + r * T::P_LD + c) = make_float2(acc[4 * i], acc[4 * i + 1]);
    if (r + 8 < rows)
      *reinterpret_cast<float2*>(part + (r + 8) * T::P_LD + c) =
          make_float2(acc[4 * i + 2], acc[4 * i + 3]);
  }
  cluster_sync();
  constexpr int C4 = T::BN / 4;
  const int units = rows * C4;
  const int u1 = (rank + 1) * units / splits;
  uint32_t at[8];  // the partial tile of each rank, in the cluster's window
#pragma unroll
  for (int q = 0; q < 8; ++q) at[q] = mapa(smem_u32(part), q < splits ? q : 0);
  const bool vec = (N & 3) == 0;
  for (int u = rank * units / splits + threadIdx.x; u < u1; u += T::CONSUMERS) {
    const int row = u / C4, c = 4 * (u % C4);
    const uint32_t off = 4 * (row * T::P_LD + c);
    float4 v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (q < splits) v[q] = ld_cluster_f4(at[q] + off);
    float4 s = v[0];
#pragma unroll
    for (int q = 1; q < 8; ++q) {
      if (q < splits) {
        s.x += v[q].x;
        s.y += v[q].y;
        s.z += v[q].z;
        s.w += v[q].w;
      }
    }
    const int col = n0 + c;
    O* out = y + (size_t)(m0 + row) * N + col;
    if (vec && col + 3 < N) {
      store2<O>(out, s.x * sc[c], s.y * sc[c + 1], true, true);
      store2<O>(out + 2, s.z * sc[c + 2], s.w * sc[c + 3], true, true);
    } else {
      const float e4[4] = {s.x, s.y, s.z, s.w};
      for (int e = 0; e < 4 && col + e < N; ++e) out[e] = from_f32<O>(e4[e] * sc[c + e]);
    }
  }
  cluster_sync();
}

template <class T, class O>
__global__ void __launch_bounds__(T::THREADS, T::MIN_BLOCKS)
    w8a16_wgmma(const __grid_constant__ CUtensorMap map_x,
                const __grid_constant__ CUtensorMap map_w, const float* __restrict__ scale,
                O* __restrict__ y, int M, int N, int k_tiles, int x_bytes) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::BAR_OFF);
  uint64_t* empty_x = full + STAGES;
  uint64_t* empty_w = empty_x + STAGES;

  // The cluster is (1, 1, splits): a block's rank in it is its split.
  const int splits = gridDim.z, split = blockIdx.z;
  const int kt0 = split * k_tiles / splits;
  const int nk = (split + 1) * k_tiles / splits - kt0;
  const int n0 = blockIdx.x * T::BN, m0 = blockIdx.y * T::BM;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty_x[s], T::CONSUMERS / 32);
      mbar_init(&empty_w[s], 1);
    }
    fence_barrier_init();
  }
  __syncthreads();
  griddep_launch_dependents();

  if (threadIdx.x >= T::CONSUMERS) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == T::CONSUMERS) {
      tma_prefetch_map(&map_x);
      tma_prefetch_map(&map_w);
      // The first stages' weights before the wait for the kernel before
      // this one (which may still write x, or read what becomes y); the
      // weights are no kernel's output.
      const int early = min(nk, STAGES);
      for (int it = 0; it < early; ++it) {
        mbar_arrive_expect_tx(&full[it], x_bytes + T::W_BYTES);
        tma_load_2d(smem + T::W_OFF + it * T::W_BYTES, &map_w, &full[it], n0, (kt0 + it) * BK);
      }
      griddep_wait();
      for (int it = 0; it < nk; ++it) {
        const int st = it % STAGES;
        const uint32_t free_parity = ((it / STAGES) & 1) ^ 1;  // the first pass is free
        const int k = (kt0 + it) * BK;
        if (it >= early) {
          mbar_wait(&empty_w[st], free_parity);
          mbar_arrive_expect_tx(&full[st], x_bytes + T::W_BYTES);
          tma_load_2d(smem + T::W_OFF + st * T::W_BYTES, &map_w, &full[st], n0, k);
        }
        mbar_wait(&empty_x[st], free_parity);
        tma_load_2d(smem + T::X_OFF + st * T::X_BYTES, &map_x, &full[st], k, m0);
      }
    }
    __syncwarp();
    if (splits > 1) {  // the producer takes part in both cluster barriers
      cluster_sync();
      cluster_sync();
    }
    return;
  }
  setmaxnreg_inc<T::CONSUMER_REGS>();
  // The tile's scales (0 past N), read after the main loop's first
  // consumer barrier.
  float* sc = reinterpret_cast<float*>(smem + T::SCALE_OFF);
  for (int c = threadIdx.x; c < T::BN; c += T::CONSUMERS) sc[c] = n0 + c < N ? scale[n0 + c] : 0.0f;
  float acc[T::BN / 2];
  mainloop<T>(smem, full, empty_x, empty_w, nk, acc);
  if (splits == 1)
    store_fragments<T, O>(acc, sc, y, M, N, m0, n0);
  else
    reduce_cluster<T, O>(smem, acc, sc, y, M, N, m0, n0, split, splits);
}

// A 2-D map over a row-major operand with `inner` columns, `outer` rows
// and rows `row_bytes` apart; boxes of box_inner x box_outer elements.
int encode_2d(EncodeTiled fn, CUtensorMap* map, const void* base, CUtensorMapDataType type,
              int inner, int outer, long long row_bytes, int box_inner, int box_outer,
              CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP + (int)r;
}

template <class T, class O>
int launch(const CUtensorMap& mx, const CUtensorMap& mw, const float* scale, O* y, int M, int N,
           int k_tiles, int splits, int x_rows, cudaStream_t s) {
  // Once per (kernel, device): the shared-memory limit above 48 KB, and a
  // check that the kernel holds enough registers for setmaxnreg's split (a
  // consumer raising its limit past the block's allocation would wait
  // forever).
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !ready[dev]) {
    err = cudaFuncSetAttribute(w8a16_wgmma<T, O>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               T::SMEM);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, w8a16_wgmma<T, O>);
    if (err != cudaSuccess) return (int)err;
    if (attr.numRegs * T::THREADS < 32 * (T::CONSUMERS / 32 * T::CONSUMER_REGS + 4 * PRODUCER_REGS))
      return ERR_REGISTERS;
    if (dev < 64) ready[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM, splits);
  cfg.blockDim = dim3(T::THREADS);
  cfg.dynamicSmemBytes = T::SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = 1;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = splits;
  // Programmatic dependent launch: this grid may start while the kernel
  // before it finishes, up to griddep_wait.
  attrs[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, w8a16_wgmma<T, O>, mx, mw, scale, y, M, N, k_tiles,
                           x_rows * BK * 2);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The tiles the planner chooses from: (BM, BN) = (64, 32), (64, 64),
// (64, 128), (128, 256).
template <class O>
int dispatch(const void* x, const void* w, const float* scale, O* y, int M, int K, int N,
             long long ld_x, long long ld_w, int bm, int bn, int splits, cudaStream_t s) {
  const int k_tiles = (K + BK - 1) / BK;
  const bool tile_ok = (bm == 64 && (bn == 32 || bn == 64 || bn == 128)) ||
                       (bm == 128 && bn == 256);
  if (!tile_ok || splits < 1 || splits > 8 || splits > k_tiles) return ERR_PLAN;
  const EncodeTiled fn = encode_tiled();
  if (!fn) return ERR_NO_TENSOR_MAP_API;
  // Below one tile of rows, x's box stops at M rounded up to 8 (one swizzle
  // atom): the rows past it keep stale bytes, which reach only output rows
  // that are never stored, and TMA writes no zero rows for them.
  const int x_rows = min(bm, (M + 7) / 8 * 8);
  CUtensorMap mx, mw;
  int rc = encode_2d(fn, &mx, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, K, M, 2 * ld_x, BK, x_rows,
                     CU_TENSOR_MAP_SWIZZLE_128B);
  if (!rc)
    rc = encode_2d(fn, &mw, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, N, K, ld_w, bn, BK,
                   CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc) return rc;
  if (bm == 128)
    return launch<Tile<2, 256>, O>(mx, mw, scale, y, M, N, k_tiles, splits, x_rows, s);
  if (bn == 32) return launch<Tile<1, 32>, O>(mx, mw, scale, y, M, N, k_tiles, splits, x_rows, s);
  if (bn == 64) return launch<Tile<1, 64>, O>(mx, mw, scale, y, M, N, k_tiles, splits, x_rows, s);
  return launch<Tile<1, 128>, O>(mx, mw, scale, y, M, N, k_tiles, splits, x_rows, s);
}

}  // namespace bf16

}  // namespace

// C entry point, bound from Python with ctypes.  x [M, K] and w_q [K, N]
// are row-major with rows ld_x and ld_w elements apart; y [M, N] and scale
// are contiguous.  bf16 x: (bm, bn, splits) is the planner's choice, and x
// and w_q need 16-byte-aligned bases and row strides (TMA reads them; the
// wrapper copies an operand that has not).  f32 x: the operands are
// contiguous and the plan is not read.  Launches on `stream` without
// synchronising and returns 0 when launched, else a cudaError_t or one of
// the ERR_ codes above.
extern "C" int w8a16_matmul(const void* x, const void* w_q, const void* scale, void* y, int M,
                            int K, int N, long long ld_x, long long ld_w, int x_bf16, int y_bf16,
                            int bm, int bn, int splits, void* stream) {
  if (M < 1 || K < 1 || N < 1 || M > 65535 * 64) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* wq = static_cast<const int8_t*>(w_q);
  const float* sc = static_cast<const float*>(scale);
  if (x_bf16) {
    if (y_bf16)
      return bf16::dispatch(x, wq, sc, static_cast<__nv_bfloat16*>(y), M, K, N, ld_x, ld_w, bm,
                            bn, splits, s);
    return bf16::dispatch(x, wq, sc, static_cast<float*>(y), M, K, N, ld_x, ld_w, bm, bn,
                          splits, s);
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const float* xf = static_cast<const float*>(x);
  if (y_bf16)
    w8a16_f32<__nv_bfloat16><<<grid, 256, 0, s>>>(xf, wq, sc, static_cast<__nv_bfloat16*>(y),
                                                  M, K, N);
  else
    w8a16_f32<float><<<grid, 256, 0, s>>>(xf, wq, sc, static_cast<float*>(y), M, K, N);
  return (int)cudaGetLastError();
}
