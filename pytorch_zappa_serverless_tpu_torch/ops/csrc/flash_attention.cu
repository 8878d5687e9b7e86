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
// products bound it (5.4 GFLOP, 0.0054 ms).
//
// The TPU kernel walks K/V blocks along a sequential grid axis and carries
// m, l and acc in VMEM scratch.  Hopper blocks run in no order, so here one
// block owns a (b, h, 64-row Q tile) and loops over 64-row K/V tiles staged
// in shared memory; m and l live in the registers of the two threads that
// own a row, acc in shared memory.  The bf16 products run on the tensor
// cores as wmma 16x16x16 fragments with f32 accumulators; D is zero-filled
// in shared memory to the next of four padded widths (48, 80, 128, 160:
// 40 -> 48, 80 -> 80), which changes neither Q.K^T nor the first D columns
// of P.V, and only D columns are stored.  D up to 160 is taken: SD-1.5's
// 1280-wide level runs at 1024 tokens with D = 160 once images reach
// 1024x1024.  f32 inputs take a
// CUDA-core FMA path (not TF32), as the TPU
// kernel multiplies in f32 for f32 inputs.  This first version has no TMA,
// no wgmma and no software pipelining: four block-wide barriers per K/V
// tile, scalar loads.  Its times against its bound are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // key rows per K/V tile
constexpr int THREADS = 128;   // 4 warps; two threads own each query row
constexpr float NEG = -1e9f;   // the finite mask of the TPU kernel

// Shared-memory layout of the bf16 kernel for a padded head dim DP (a
// multiple of 16).  Row strides are padded against bank conflicts and keep
// what wmma needs: a leading dimension that is a multiple of 8 (16-bit) or 4
// (f32), and fragment pointers on 32-byte boundaries for every 16-row and
// 16-column step.  Every region's size is a multiple of 128 bytes.
template <int DP>
struct Bf16Smem {
  static constexpr int LDH = DP + 8;  // Q, K, V tiles (bf16)
  static constexpr int LDS = BK + 4;  // scores (f32)
  static constexpr int LDP = BK + 8;  // probabilities (bf16)
  static constexpr int LDO = DP + 4;  // output accumulator (f32)
  static constexpr size_t Q = 0;
  static constexpr size_t K = Q + sizeof(__nv_bfloat16) * BQ * LDH;
  static constexpr size_t V = K + sizeof(__nv_bfloat16) * BK * LDH;
  static constexpr size_t S = V + sizeof(__nv_bfloat16) * BK * LDH;
  static constexpr size_t P = S + sizeof(float) * BQ * LDS;
  static constexpr size_t O = P + sizeof(__nv_bfloat16) * BQ * LDP;
  static constexpr size_t BYTES = O + sizeof(float) * BQ * LDO;
};

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

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() { return __float2bfloat16(0.0f); }

// Stage rows [t0, t0 + rows) of one (b, h) head into shared memory as a
// [rows, DP] tile with row stride ld, zero-filling rows past t_len and
// columns past D.  Neighbouring threads read neighbouring elements of a row.
template <typename T, int DP>
__device__ __forceinline__ void stage(T* dst, int ld, const T* src, long long st,
                                      int t0, int rows, int t_len, int D) {
  for (int i = threadIdx.x; i < rows * DP; i += THREADS) {
    const int r = i / DP, c = i % DP;
    const int t = t0 + r;
    dst[r * ld + c] = (t < t_len && c < D) ? src[(long long)t * st + c] : zero<T>();
  }
}

// The softmax update of one K/V tile for one query row, shared by both
// paths.  The calling thread holds the row's scores for keys 2j + half,
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

// bf16 inputs: tensor cores for Q.K^T and P.V.
template <int DP>
__global__ void __launch_bounds__(THREADS) flash_bf16(Args a) {
  using L = Bf16Smem<DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + L::Q);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + L::K);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + L::V);
  float* Ss = reinterpret_cast<float*>(smem + L::S);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(smem + L::P);
  float* Os = reinterpret_cast<float*>(smem + L::O);

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32;
  const int row = tid >> 1, half = tid & 1;  // softmax ownership
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + h * a.k_sh;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* bias_b = a.bias ? a.bias + (long long)b * a.Tk : nullptr;

  stage<__nv_bfloat16, DP>(Qs, L::LDH, q, a.q_st, q0, BQ, a.Tq, a.D);
  for (int i = tid; i < BQ * DP; i += THREADS) Os[(i / DP) * L::LDO + i % DP] = 0.0f;
  float m_run = NEG, l_run = 0.0f;

  // Causal: key tiles wholly above the diagonal contribute nothing.
  const int k_end = a.causal ? min(a.Tk, q0 + BQ) : a.Tk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    stage<__nv_bfloat16, DP>(Ks, L::LDH, k, a.k_st, k0, BK, a.Tk, a.D);
    stage<__nv_bfloat16, DP>(Vs, L::LDH, v, a.v_st, k0, BK, a.Tk, a.D);
    __syncthreads();

    // S = Q K^T: warp w owns score rows 16w..16w+15, all 64 columns.
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BK / 16];
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll
      for (int kk = 0; kk < DP; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, Qs + (16 * warp) * L::LDH + kk, L::LDH);
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) {
          // K^T as a column-major B: element (d, key) sits at Ks[key][d].
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
          wmma::load_matrix_sync(fb, Ks + (16 * j) * L::LDH + kk, L::LDH);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
        wmma::store_matrix_sync(Ss + (16 * warp) * L::LDS + 16 * j, acc[j], L::LDS,
                                wmma::mem_row_major);
    }
    __syncthreads();

    // Online softmax on the row's two halves; rescale the accumulator row.
    {
      float s[BK / 2];
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        const int c = 2 * j + half;
        s[j] = masked_score(Ss[row * L::LDS + c], a, bias_b, q0 + row, k0 + c);
      }
      const float alpha = online_update(s, m_run, l_run);
#pragma unroll
      for (int j = 0; j < BK / 2; ++j)
        Ps[row * L::LDP + 2 * j + half] = __float2bfloat16(s[j]);
#pragma unroll
      for (int c = half; c < DP; c += 2) Os[row * L::LDO + c] *= alpha;
    }
    __syncthreads();

    // O += P V: warp w owns output rows 16w..16w+15, all DP columns.
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[DP / 16];
#pragma unroll
      for (int j = 0; j < DP / 16; ++j)
        wmma::load_matrix_sync(acc[j], Os + (16 * warp) * L::LDO + 16 * j, L::LDO,
                               wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, Ps + (16 * warp) * L::LDP + kk, L::LDP);
#pragma unroll
        for (int j = 0; j < DP / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, Vs + kk * L::LDH + 16 * j, L::LDH);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < DP / 16; ++j)
        wmma::store_matrix_sync(Os + (16 * warp) * L::LDO + 16 * j, acc[j], L::LDO,
                                wmma::mem_row_major);
    }
    __syncthreads();
  }

  // o = acc / l, D columns of the rows below Tq, in bf16.
  const float inv = 1.0f / (l_run == 0.0f ? 1.0f : l_run);
  const int qi = q0 + row;
  if (qi < a.Tq) {
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.o) +
                       (((long long)b * a.Tq + qi) * a.H + h) * a.D;
    for (int c = half; c < a.D; c += 2) o[c] = __float2bfloat16(Os[row * L::LDO + c] * inv);
  }
}

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

  stage<float, DP>(Qs, L::LDQ, q, a.q_st, q0, BQ, a.Tq, a.D);
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;
  float m_run = NEG, l_run = 0.0f;

  const int k_end = a.causal ? min(a.Tk, q0 + BQ) : a.Tk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    stage<float, DP>(Ks, L::LDQ, k, a.k_st, k0, BK, a.Tk, a.D);
    stage<float, DP>(Vs, L::LDQ, v, a.v_st, k0, BK, a.Tk, a.D);
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

template <typename Kernel>
int launch(Kernel kernel, size_t smem_bytes, const Args& a, int B, cudaStream_t s) {
  // Above 48 KB a block's shared memory must be asked for.  The attribute is
  // per kernel and per device; setting it again is cheap and idempotent.
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Tq + BQ - 1) / BQ, a.H, B);
  kernel<<<grid, THREADS, smem_bytes, s>>>(a);
  return (int)cudaGetLastError();
}

template <int DP>
int dispatch(const Args& a, int B, int bf16, cudaStream_t s) {
  if (bf16) return launch(flash_bf16<DP>, Bf16Smem<DP>::BYTES, a, B, s);
  return launch(flash_f32<DP>, F32Smem<DP>::BYTES, a, B, s);
}

}  // namespace

// C entry point, bound from Python with ctypes.  Strides are in elements;
// the last axis of q, k and v is contiguous and o is contiguous
// [B, Tq, H, D].  Launches on `stream` without synchronising and returns
// cudaGetLastError() (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* bias, void* o, int B, int Tq, int Tk, int H,
                                   int D, long long q_sb, long long q_st, long long q_sh,
                                   long long k_sb, long long k_st, long long k_sh,
                                   long long v_sb, long long v_st, long long v_sh,
                                   float sm_scale, int causal, int bf16, void* stream) {
  if (B < 1 || Tq < 1 || Tk < 1 || H < 1 || D < 1 || D > 160 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, static_cast<const float*>(bias), o, Tq, Tk, H, D,
               q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, sm_scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // A few padded widths, each D zero-filled up to the next: 40 -> 48 and
  // 80 -> 80 (the UNet at 512x512), 160 (its 1280-wide level at 1024x1024),
  // 128 for the rest.  Each width is two instantiations and adds build time.
  if (D <= 48) return dispatch<48>(a, B, bf16, s);
  if (D <= 80) return dispatch<80>(a, B, bf16, s);
  if (D <= 128) return dispatch<128>(a, B, bf16, s);
  return dispatch<160>(a, B, bf16, s);
}
