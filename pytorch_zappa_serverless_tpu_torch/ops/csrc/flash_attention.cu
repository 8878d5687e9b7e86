// Blocked online-softmax attention for Hopper (sm_90a):
//     o[b, i, h, :] = sum_j softmax_j(q[b, i, h, :] . k[b, j, h, :] * sm_scale + bias[b, j]) v[b, j, h, :]
// for q [B, Tq, H, D], k and v [B, Tk, H, D] in bf16 or f32, read in place
// through their strides (last axis contiguous), and o [B, Tq, H, D]
// contiguous in the input type.
//
// Replaces the TPU kernel pytorch_zappa_serverless_tpu/ops/flash_attention.py::_kernel
// (reached through flash_attention).  Its contract, kept here:
// - scores in f32, times sm_scale (the wrapper passes 1/sqrt(D) of the true
//   D); an optional bias [B, Tk] of 0 / -1e9 (the wrapper's kv_mask) is
//   added, and `causal` replaces every key above the diagonal by -1e9;
// - online softmax with f32 running max m (starting at -1e9), sum l and
//   accumulator; P is cast to the input type before P.V (bf16 in
//   production) and P.V accumulates in f32;
// - o = acc / (l == 0 ? 1 : l): a row whose keys are all masked gets a
//   uniform distribution over its keys, finite, never NaN.
// Keys past Tk (the ragged edge of the last tile) get -inf and so weigh
// exactly 0; query rows past Tq are computed on zeros and never stored.
//
// What bounds it on an H100: at the SD-1.5 UNet's 4096-token
// self-attention, [2, 4096, 8, 40] bf16, the two products are 42.9 GFLOP
// (0.043 ms at 989 TFLOP/s) while the exponentials are 268 M, about
// 0.069 ms at the special-function units' ~3.9 T/s: the exponentials bound
// it, and device memory (21 MB) never does.  At [2, 1024, 8, 80] the
// products bound it (5.4 GFLOP, 0.0054 ms).  Measured, the kernel is held
// by bringing K/V into shared memory instead: every 128-row block of a head
// reads all of the head's K/V from L2 (tools/flash_ablation.py takes out
// the softmax or either product and saves ~10% each; PERF.md).
//
// bf16 (the serving path), flash_bf16: one block owns a (b, h, 128-row Q
// tile).  Two consumer warpgroups own 64 query rows each; a producer
// warpgroup after them (register budget cut to 24 by setmaxnreg, the
// consumers' raised to 240), of which one thread issues every copy by TMA:
// Q once, then K and V tiles through a ring of three shared-memory stages
// with full / empty mbarriers.  The tensor maps are 4-D, (D, H, T, B)
// innermost first, over the operands' own strides, so head-split views are
// read in place; TMA zero-fills columns past D and rows past T.  Tiles land
// 128-byte swizzled, the head dim padded to a multiple of 64 (40 -> 64,
// 80 -> 128, 160 -> 192): zero columns change neither Q.K^T nor the first D
// columns of P.V, and Q.K^T skips the 16-wide steps past D.
//   Per K/V tile, each warpgroup issues O += P.V for the previous tile and
// S = Q.K^T for this one as one group of wgmma (Q and K K-major in shared
// memory), accumulated in registers.  The softmax runs on those accumulator
// fragments: a row's max and sum over the 4 lanes that share it, in log2
// units, sm_scale·log2(e) folded into one FFMA before ex2 on the
// special-function unit.  P is rounded to bf16 pairs in registers and is
// the A operand of O += P.V (V MN-major in shared memory); O stays in
// registers.  S, P and O never touch shared memory.  Masks are applied only
// on the tiles that need them: the kv_mask bias when one is passed, the
// causal diagonal (tiles wholly above it are never loaded), and -inf past
// Tk on the ragged last tile.
//
// f32 inputs take flash_f32, a CUDA-core FMA path (not TF32), as the TPU
// kernel multiplies in f32 for f32 inputs: 64-row Q tiles and 64-key K/V
// tiles staged in shared memory, D padded to 48, 80, 128 or 160.  No
// serving path uses it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;         // f32 path: query rows per block
constexpr int BK = 64;         // f32 path: key rows per K/V tile
constexpr int THREADS = 128;   // f32 path: 4 warps; two threads own each query row
constexpr float NEG = -1e9f;   // the finite mask of the TPU kernel

using hopper::encode_tiled;
using hopper::EncodeTiled;
using hopper::ERR_NO_TENSOR_MAP_API;
using hopper::ERR_REGISTERS;
using hopper::ERR_TENSOR_MAP;

template <int DP>
struct F32Smem {
  static constexpr int LDQ = DP + 1;  // Q, K, V tiles (f32)
  static constexpr int LDP = BK + 1;  // probabilities (f32)
  static constexpr size_t Q = 0;
  static constexpr size_t K = Q + sizeof(float) * BQ * LDQ;
  static constexpr size_t V = K + sizeof(float) * BK * LDQ;
  static constexpr size_t P = V + sizeof(float) * BK * LDQ;
  static constexpr size_t BYTES = P + sizeof(float) * BQ * LDP;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;  // [B, Tk] or null
  void* o;
  int Tq, Tk, H, D;
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  float sm_scale;
  int causal;
};

// Stage rows [t0, t0 + rows) of one (b, h) head into shared memory as a
// [rows, DP] tile with row stride ld, zero-filling rows past t_len and
// columns past D.  Neighbouring threads read neighbouring elements of a row.
template <int DP>
__device__ __forceinline__ void stage(float* dst, int ld, const float* src, long long st,
                                      int t0, int rows, int t_len, int D) {
  for (int i = threadIdx.x; i < rows * DP; i += THREADS) {
    const int r = i / DP, c = i % DP;
    const int t = t0 + r;
    dst[r * ld + c] = (t < t_len && c < D) ? src[(long long)t * st + c] : 0.0f;
  }
}

// The softmax update of one K/V tile for one query row.  The calling thread holds the row's scores for keys 2j + half,
// j < 32, in s[] (already scaled, biased and masked); its partner (lane ^ 1)
// holds the other half.  Returns alpha, the rescale of the old state, and
// leaves p = exp(s - m_new) in s[].
__device__ __forceinline__ float online_update(float (&s)[BK / 2], float& m_run,
                                               float& l_run) {
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < BK / 2; ++j) mx = fmaxf(mx, s[j]);
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  const float m_new = fmaxf(m_run, mx);
  const float alpha = __expf(m_run - m_new);
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < BK / 2; ++j) {
    s[j] = __expf(s[j] - m_new);
    sum += s[j];
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  l_run = alpha * l_run + sum;
  m_run = m_new;
  return alpha;
}

// Scale, bias and mask one score: key index kidx of query row qidx.
__device__ __forceinline__ float masked_score(float dot, const Args& a, const float* bias_b,
                                              int qidx, int kidx) {
  if (kidx >= a.Tk) return -INFINITY;  // ragged edge: weighs exactly 0
  float s = dot * a.sm_scale;
  if (bias_b) s += bias_b[kidx];
  if (a.causal && kidx > qidx) s = NEG;
  return s;
}

// -- f32: CUDA-core FMAs ------------------------------------------------------

// f32 inputs: f32 FMA on the CUDA cores.  Scores and the accumulator live in
// the registers of the two threads that own a row (keys and output columns
// split even / odd between them).
template <int DP>
__global__ void __launch_bounds__(THREADS) flash_f32(Args a) {
  using L = F32Smem<DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + L::Q);
  float* Ks = reinterpret_cast<float*>(smem + L::K);
  float* Vs = reinterpret_cast<float*>(smem + L::V);
  float* Ps = reinterpret_cast<float*>(smem + L::P);

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int row = tid >> 1, half = tid & 1;
  const float* q = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* k = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* v = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* bias_b = a.bias ? a.bias + (long long)b * a.Tk : nullptr;

  stage<DP>(Qs, L::LDQ, q, a.q_st, q0, BQ, a.Tq, a.D);
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;
  float m_run = NEG, l_run = 0.0f;

  const int k_end = a.causal ? min(a.Tk, q0 + BQ) : a.Tk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    stage<DP>(Ks, L::LDQ, k, a.k_st, k0, BK, a.Tk, a.D);
    stage<DP>(Vs, L::LDQ, v, a.v_st, k0, BK, a.Tk, a.D);
    __syncthreads();

    float s[BK / 2];
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int c = 2 * j + half;
      float dot = 0.0f;
#pragma unroll 8
      for (int d = 0; d < DP; ++d) dot = fmaf(Qs[row * L::LDQ + d], Ks[c * L::LDQ + d], dot);
      s[j] = masked_score(dot, a, bias_b, q0 + row, k0 + c);
    }
    const float alpha = online_update(s, m_run, l_run);
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) Ps[row * L::LDP + 2 * j + half] = s[j];
    __syncwarp();  // the row's partner is the neighbouring lane
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) {
      const int c = 2 * i + half;
      float sum = acc[i] * alpha;
#pragma unroll 8
      for (int j = 0; j < BK; ++j) sum = fmaf(Ps[row * L::LDP + j], Vs[j * L::LDQ + c], sum);
      acc[i] = sum;
    }
    __syncthreads();
  }

  const float inv = 1.0f / (l_run == 0.0f ? 1.0f : l_run);
  const int qi = q0 + row;
  if (qi < a.Tq) {
    float* o = static_cast<float*>(a.o) + (((long long)b * a.Tq + qi) * a.H + h) * a.D;
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) {
      const int c = 2 * i + half;
      if (c < a.D) o[c] = acc[i] * inv;
    }
  }
}

// -- bf16: TMA, wgmma, softmax in registers -----------------------------------

namespace bf16 {

constexpr int BQ = 128;            // query rows per block
constexpr int CONSUMER_WARPS = 8;  // two warpgroups of 64 rows
constexpr int THREADS = 384;       // + the producer warpgroup (one thread issues TMA)
// setmaxnreg's split of the 168 registers a thread gets at launch (ptxas
// sizes the block as whole warpgroups): 24 for the producer, 240 for each
// consumer, 64,512 in all.
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG2 = NEG * LOG2E;  // the -1e9 mask in log2 units

struct Args {
  const float* bias;  // [B, Tk] or null
  void* o;
  int Tq, Tk, H, D;
  float sm_scale;
  int causal;
};

// Shared-memory plan for a head dim padded to DP (a multiple of 64), BK-key
// tiles and STAGES K/V stages; KS is the number of 16-wide Q.K^T steps that
// hold head-dim columns (ceil(D / 16)), fixed at compile time so each wgmma
// chain is straight-line code.  Each operand tile is ATOMS atom columns of
// [rows][64] bf16 (128-byte rows, 128-byte swizzle), each 1024-byte aligned.
template <int DP_, int BK_, int STAGES_, int KS_>
struct Tile {
  static constexpr int DP = DP_, BK = BK_, STAGES = STAGES_, KS = KS_;
  static constexpr int ATOMS = DP / 64;
  static constexpr int Q_ATOM = BQ * 128;   // bytes of one Q atom column
  static constexpr int KV_ATOM = BK * 128;  // bytes of one K or V atom column
  static constexpr int KV_BYTES = ATOMS * KV_ATOM;
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;  // K then V
  static constexpr int Q_OFF = 0;
  static constexpr int KV_OFF = ATOMS * Q_ATOM;
  static constexpr int BAR_OFF = KV_OFF + STAGES * STAGE_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;  // + base alignment
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// One consumer warpgroup: 64 query rows against every K/V tile of the block.
template <class T>
__device__ __forceinline__ void consume(unsigned char* smem, uint64_t* q_full, uint64_t* full,
                                        uint64_t* empty, const Args& a, int q0, int h, int b,
                                        int n_tiles) {
  using namespace hopper;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128, lane = t % 32;
  const int row_wg = q0 + 64 * wg;                     // the warpgroup's first row
  const int r0 = row_wg + 16 * (t / 32) + lane / 4;    // this thread's rows: r0, r0 + 8
  const int cq = 2 * (lane % 4);                       // its columns in each group of 8
  const float c = a.sm_scale * LOG2E;
  const float* bias = a.bias ? a.bias + (long long)b * a.Tk : nullptr;

  float o[T::DP / 2], s[T::BK / 2];
#pragma unroll
  for (int i = 0; i < T::DP / 2; ++i) o[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < T::BK / 2; ++i) s[i] = 0.0f;
  uint32_t p[T::BK / 16][4] = {};  // P of the last tile: the A operand of O += P.V
  float m[2] = {NEG2, NEG2}, l[2] = {0.0f, 0.0f};  // per row; l is this thread's share
  const uint32_t q_addr = smem_u32(smem + T::Q_OFF) + wg * 64 * 128;
  auto stage_addr = [&](int it) {
    return smem_u32(smem + T::KV_OFF + (it % T::STAGES) * T::STAGE_BYTES);
  };

  auto wait_tile = [&](int it) { mbar_wait(&full[it % T::STAGES], (it / T::STAGES) & 1); };
  // S = Q.K_it^T, both K-major: 16 head-dim columns per step, 32 bytes along
  // a swizzled row, the next atom column every fourth step.
  auto issue_s = [&](int it) {
    const uint32_t k_addr = stage_addr(it);
#pragma unroll
    for (int ks = 0; ks < T::KS; ++ks) {
      const uint64_t dq = desc_sw128(q_addr + (ks / 4) * T::Q_ATOM + (ks % 4) * 32, 16, 1024);
      const uint64_t dk = desc_sw128(k_addr + (ks / 4) * T::KV_ATOM + (ks % 4) * 32, 16, 1024);
      Wgmma<T::BK>::template ss<0, 0>(s, dq, dk, ks > 0);
    }
  };
  // O += P.V_it: V MN-major, 16 keys (2048 bytes of rows) per step, its atom
  // columns KV_ATOM bytes apart.
  auto issue_pv = [&](int it) {
    const uint32_t v_addr = stage_addr(it) + T::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < T::BK / 16; ++kk)
      Wgmma<T::DP>::template rs<1>(o, p[kk], desc_sw128(v_addr + kk * 2048, T::KV_ATOM, 1024), 1);
  };
  // One group of products per tile: O += P_{it-1}.V_{it-1} and S_it = Q.K_it^T
  // issued together, then one wait.
  auto begin_products = [&] {
    fence_operands(o);
    fence_operands(s);
    wgmma_fence();
  };
  auto end_products = [&] {
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(o);
    fence_operands(s);
#pragma unroll
    for (int kk = 0; kk < T::BK / 16; ++kk) fence_operands(p[kk]);
  };
  auto release = [&](int it) {  // this warp is done with tile it's stage
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[it % T::STAGES]);
  };

  // Softmax of tile it on the S fragments, in log2 units.  Unmasked tiles
  // keep the raw dot products and fold the scale into the exponent's FFMA
  // (mul = c); a tile that needs a mask is scaled here (mul = 1), so a masked
  // score is exactly -1e9·log2(e) and a fully masked row stays uniform.
  auto softmax = [&](int it) {
    const int k0 = it * T::BK;
    const bool diag = a.causal && k0 + T::BK - 1 > row_wg;
    const bool ragged = k0 + T::BK > a.Tk;
    float mul = c;
    if (bias || diag || ragged || !(c > 0.0f)) {
      mul = 1.0f;
#pragma unroll
      for (int i = 0; i < T::BK / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * i + cq + e;
          const float b2 = (bias && key < a.Tk) ? bias[key] * LOG2E : 0.0f;
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            float& x = s[4 * i + 2 * hr + e];
            x = fmaf(x, c, b2);
            if (diag && key > r0 + 8 * hr) x = NEG2;
            if (key >= a.Tk) x = -INFINITY;
          }
        }
      }
    }
    // Each row's max over the 4 lanes that share it.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < T::BK / 8; ++i) {
      mx[0] = fmaxf(mx[0], fmaxf(s[4 * i], s[4 * i + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[4 * i + 2], s[4 * i + 3]));
    }
    float alpha[2], neg_m[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
      const float m_new = fmaxf(m[hr], mx[hr] * mul);
      alpha[hr] = ex2(m[hr] - m_new);
      m[hr] = m_new;
      neg_m[hr] = -m_new;
    }
#pragma unroll
    for (int i = 0; i < T::BK / 8; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = ex2(fmaf(s[4 * i + j], mul, neg_m[j / 2]));
        s[4 * i + j] = e;
        sum[j / 2] += e;
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) l[hr] = l[hr] * alpha[hr] + sum[hr];
#pragma unroll
    for (int i = 0; i < T::DP / 8; ++i) {
      o[4 * i] *= alpha[0];
      o[4 * i + 1] *= alpha[0];
      o[4 * i + 2] *= alpha[1];
      o[4 * i + 3] *= alpha[1];
    }
    // P in bf16: the S fragments of 16 keys are the A fragment of one step.
#pragma unroll
    for (int kk = 0; kk < T::BK / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) p[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
  };

  mbar_wait(q_full, 0);
  wait_tile(0);
  begin_products();
  issue_s(0);
  end_products();
  softmax(0);
  for (int it = 1; it < n_tiles; ++it) {
    wait_tile(it);
    begin_products();
    issue_pv(it - 1);
    issue_s(it);
    end_products();
    release(it - 1);
    softmax(it);
  }
  begin_products();
  issue_pv(n_tiles - 1);
  end_products();
  release(n_tiles - 1);

  // o = acc / l, rounded to bf16 once, D columns of the rows below Tq.
  float inv[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
    inv[hr] = 1.0f / (l[hr] == 0.0f ? 1.0f : l[hr]);
  }
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.o);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r0 + 8 * hr;
    if (row >= a.Tq) continue;
    __nv_bfloat16* orow = out + ((long long)b * a.Tq + row) * a.H * a.D + (long long)h * a.D;
#pragma unroll
    for (int i = 0; i < T::DP / 8; ++i) {
      const int col = 8 * i + cq;
      const float y0 = o[4 * i + 2 * hr] * inv[hr], y1 = o[4 * i + 2 * hr + 1] * inv[hr];
      if ((a.D & 1) == 0) {
        if (col < a.D) *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(y0, y1);
      } else {
        if (col < a.D) orow[col] = __float2bfloat16(y0);
        if (col + 1 < a.D) orow[col + 1] = __float2bfloat16(y1);
      }
    }
  }
}

template <class T>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bf16(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v, const Args a) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + T::BAR_OFF);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + T::STAGES;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  // Causal: key tiles wholly above the block's diagonal are never loaded.
  const int kv_end = a.causal ? min(a.Tk, q0 + BQ) : a.Tk;
  const int n_tiles = (kv_end + T::BK - 1) / T::BK;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // One branch per role for the kernel's whole life: setmaxnreg needs the
  // roles never to reconverge.
  if (warp >= CONSUMER_WARPS) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 32 * CONSUMER_WARPS) {
      tma_prefetch_map(&map_q);
      tma_prefetch_map(&map_k);
      tma_prefetch_map(&map_v);
      mbar_arrive_expect_tx(q_full, T::ATOMS * T::Q_ATOM);
      for (int c = 0; c < T::ATOMS; ++c)
        tma_load_4d(smem + T::Q_OFF + c * T::Q_ATOM, &map_q, q_full, 64 * c, h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % T::STAGES;
        mbar_wait(&empty[st], ((it / T::STAGES) & 1) ^ 1);  // the first pass is free
        mbar_arrive_expect_tx(&full[st], T::STAGE_BYTES);
        unsigned char* kt = smem + T::KV_OFF + st * T::STAGE_BYTES;
        for (int c = 0; c < T::ATOMS; ++c) {
          tma_load_4d(kt + c * T::KV_ATOM, &map_k, &full[st], 64 * c, h, it * T::BK, b);
          tma_load_4d(kt + T::KV_BYTES + c * T::KV_ATOM, &map_v, &full[st], 64 * c, h,
                      it * T::BK, b);
        }
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    consume<T>(smem, q_full, full, empty, a, q0, h, b, n_tiles);
  }
}

// A 4-D map (D, H, T, B) over a bf16 operand's own strides (elements), with
// a box of 64 head-dim columns by `rows` positions of one (b, h).  Under
// graph capture the map is baked into the launch by value (the address of
// `base` at capture; hopper.cuh, encode_tiled).
int encode(EncodeTiled fn, CUtensorMap* map, const void* base, int D, int H, int T, int B,
           long long sb, long long st, long long sh, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)st * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP + (int)r;
}

template <class T>
int launch(const ::Args& a, int B, cudaStream_t s) {
  // Once per (kernel, device): the shared-memory limit above 48 KB, and a
  // check that the kernel holds enough registers for setmaxnreg's split (a
  // consumer raising its limit past the block's allocation would wait
  // forever).
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !ready[dev]) {
    err = cudaFuncSetAttribute(flash_bf16<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, flash_bf16<T>);
    if (err != cudaSuccess) return (int)err;
    if (attr.numRegs * THREADS < 32 * (CONSUMER_WARPS * CONSUMER_REGS + 4 * PRODUCER_REGS))
      return ERR_REGISTERS;
    if (dev < 64) ready[dev] = true;
  }
  const EncodeTiled fn = encode_tiled();
  if (!fn) return ERR_NO_TENSOR_MAP_API;
  CUtensorMap mq, mk, mv;
  int rc = encode(fn, &mq, a.q, a.D, a.H, a.Tq, B, a.q_sb, a.q_st, a.q_sh, BQ);
  if (!rc) rc = encode(fn, &mk, a.k, a.D, a.H, a.Tk, B, a.k_sb, a.k_st, a.k_sh, T::BK);
  if (!rc) rc = encode(fn, &mv, a.v, a.D, a.H, a.Tk, B, a.v_sb, a.v_st, a.v_sh, T::BK);
  if (rc) return rc;
  const Args ba{a.bias, a.o, a.Tq, a.Tk, a.H, a.D, a.sm_scale, a.causal};
  const dim3 grid((a.Tq + BQ - 1) / BQ, a.H, B);
  flash_bf16<T><<<grid, THREADS, T::SMEM, s>>>(mq, mk, mv, ba);
  return (int)cudaGetLastError();
}

// Head dims padded to whole 64-column atoms, with a Q.K^T step count for
// the UNet's widths (40: 3 steps, 80: 5) and one for the rest of each atom
// width.  D <= 128 takes 128-key tiles; D up to 160 (SD-1.5's 1280-wide
// level at 1024x1024) 64-key tiles, so the 96 accumulator registers of O
// leave room for S.
int dispatch(const ::Args& a, int B, cudaStream_t s) {
  if (a.D <= 48) return launch<Tile<64, 128, 3, 3>>(a, B, s);
  if (a.D <= 64) return launch<Tile<64, 128, 3, 4>>(a, B, s);
  if (a.D <= 80) return launch<Tile<128, 128, 3, 5>>(a, B, s);
  if (a.D <= 128) return launch<Tile<128, 128, 3, 8>>(a, B, s);
  return launch<Tile<192, 64, 3, 10>>(a, B, s);
}

}  // namespace bf16

template <int DP>
int launch_f32(const Args& a, int B, cudaStream_t s) {
  // Above 48 KB a block's shared memory must be asked for: once per device.
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  constexpr int smem = (int)F32Smem<DP>::BYTES;
  if (dev >= 64 || !ready[dev]) {
    err = cudaFuncSetAttribute(flash_f32<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) ready[dev] = true;
  }
  const dim3 grid((a.Tq + BQ - 1) / BQ, a.H, B);
  flash_f32<DP><<<grid, THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point, bound from Python with ctypes.  Strides are in elements;
// the last axis of q, k and v is contiguous and o is contiguous
// [B, Tq, H, D].  bf16 operands need 16-byte-aligned bases and strides (TMA
// reads them); the wrapper copies an operand that has not.  Launches on
// `stream` without synchronising and returns 0 when launched, else a
// cudaError_t or one of the ERR_ codes above.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* bias, void* o, int B, int Tq, int Tk, int H,
                                   int D, long long q_sb, long long q_st, long long q_sh,
                                   long long k_sb, long long k_st, long long k_sh,
                                   long long v_sb, long long v_st, long long v_sh,
                                   float sm_scale, int causal, int is_bf16, void* stream) {
  if (B < 1 || Tq < 1 || Tk < 1 || H < 1 || D < 1 || D > 160 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, static_cast<const float*>(bias), o, Tq, Tk, H, D,
               q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, sm_scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return bf16::dispatch(a, B, s);
  // f32: a few padded widths, each D zero-filled up to the next.
  if (D <= 48) return launch_f32<48>(a, B, s);
  if (D <= 80) return launch_f32<80>(a, B, s);
  if (D <= 128) return launch_f32<128>(a, B, s);
  return launch_f32<160>(a, B, s);
}
