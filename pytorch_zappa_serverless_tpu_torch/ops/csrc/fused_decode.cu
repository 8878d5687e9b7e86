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
// at which the tensor cores would be the limit.  The weights, and for
// attention the two caches, must be read once per launch: bytes bound both
// kernels.  At GPT-2 small (D = 768, F = 3072, T = 96) an attention launch
// reads 7.1 MB (bf16 weights) and an MLP launch 9.4 MB: about 2.1 and 2.8 us
// at 3.35 TB/s, half the weight bytes with int8.
//
// What the design does about that:
// - Every weight byte is read once per launch and used for all S rows.  A
//   lane owns two adjacent output columns, so a warp reads a contiguous row
//   segment of the [K, N] row-major weight.
// - The K axis of each projection is split into slabs, so every block of the
//   grid streams weights in every projection phase; a block writes the f32
//   partial sums of its (64-column tile, K slab) to scratch, and the consumer
//   of the projection sums the slabs in a fixed order, then applies the int8
//   column scale and the bias (the scale commutes with the K sum).
// - The phases depend on each other across the grid (a head needs q/k/v
//   columns made by many blocks; the out-projection needs every head's
//   context), so each kernel is one cooperative launch with grid-wide
//   barriers between phases, its grid sized so every block is resident:
//     attention: LN1 + QKV partials | per (row, head): q/k/v epilogue, cache
//                write, softmax attention -> ctx | out partials | residual
//     mlp:       LN2 + fc1 partials | GELU -> h1 | fc2 partials | residual
//   The grid barrier also orders the in-place cache writes: the row written
//   at pos[s] for a head is written and then read by the same block, after a
//   block barrier, and no other block reads it.
// - Products are f32 FMAs on the CUDA cores: bf16 and int8 values convert to
//   f32 exactly, and at M = 8 rows the tensor cores would idle.
// This first version has no cp.async/TMA pipelining and reads weights with
// 2- or 4-byte loads; PERF.md holds its times against the bound.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE_N = 64;   // output columns of one projection work item, 2 per lane
constexpr int ROWS = 8;      // activation rows per accumulator pass
constexpr int KS_MAX = 256;  // K rows of one slab, at most
constexpr int MAX_S = 64;
constexpr int MAX_HD = 128;
constexpr int MAX_T = 32768;
constexpr int BLOCKS_PER_SM = 2;

struct Proj {
  const void* w;       // [K, N] row-major, bf16 or int8
  const float* scale;  // [N] for int8 weights, else nullptr
  const float* bias;   // [N]
  int K, N, ks;        // ks: K rows per slab
};

struct Common {
  const bf16* x;      // [S, D]
  const float* ln_s;  // [D]
  const float* ln_b;  // [D]
  bf16* x_out;        // [S, D]
  float* part;        // scratch: f32 partials [K slabs, S, N] of the current projection
  int S, D;
  float eps;
};

struct AttnArgs {
  Common c;
  Proj qkv, out;
  bf16* cache_k;      // [T, S, D]
  bf16* cache_v;
  const int* pos;     // [S]
  const float* mask;  // [T, S]: the [T, S, 1] additive bias
  bf16* ctx;          // scratch [S, D]
  int T, heads;
  float sm_scale;
};

struct MlpArgs {
  Common c;
  Proj fc1, fc2;
  bf16* h1;  // scratch [S, F]
  int approx_gelu;
};

__device__ __forceinline__ float wval(const bf16* w, size_t i) { return __bfloat162float(w[i]); }
__device__ __forceinline__ float wval(const int8_t* w, size_t i) { return (float)w[i]; }

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
// buf holds WARPS floats.
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

// Mean and 1/sqrt(population variance + eps) of every row of x, one warp per
// row, into stats[2 s], stats[2 s + 1].
__device__ void ln_stats(const Common& c, float* stats) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int s = warp; s < c.S; s += WARPS) {
    const bf16* xr = c.x + (size_t)s * c.D;
    float sum = 0.f;
    for (int d = lane; d < c.D; d += 32) sum += __bfloat162float(xr[d]);
    const float mu = warp_sum(sum) / c.D;
    float sq = 0.f;
    for (int d = lane; d < c.D; d += 32) {
      const float t = __bfloat162float(xr[d]) - mu;
      sq += t * t;
    }
    const float var = warp_sum(sq) / c.D;
    if (lane == 0) {
      stats[2 * s] = mu;
      stats[2 * s + 1] = rsqrtf(var + c.eps);
    }
  }
  __syncthreads();
}

// The f32 partial sums of y[S, N] = h[S, K] @ w[K, N] for every (column tile,
// K slab) work item this block takes, into part[slab, S, N].  The input rows
// of a slab are staged in shared memory as bf16: LN(x) (stats != nullptr,
// K == D) or a copy of src [S, K].
template <typename W>
__device__ void proj_partials(const Proj& p, const Common& c, const bf16* src,
                              const float* stats, float* red, bf16* hs) {
  const W* w = static_cast<const W*>(p.w);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int S = c.S, K = p.K, N = p.N;
  const int ntiles = (N + TILE_N - 1) / TILE_N;
  const int ksplit = (K + p.ks - 1) / p.ks;
  for (int item = blockIdx.x; item < ntiles * ksplit; item += gridDim.x) {
    const int n0 = (item % ntiles) * TILE_N, slab = item / ntiles;
    const int k0 = slab * p.ks, kn = min(p.ks, K - k0);
    __syncthreads();  // the previous item's readers of hs and red are done
    for (int i = tid; i < S * kn; i += THREADS) {
      const int s = i / kn, k = i % kn;
      if (stats) {
        // ((x - mean) * rstd) * scale + bias, without contraction to an FMA,
        // then one rounding to bf16: the plain version's order.
        const float xv = __bfloat162float(c.x[(size_t)s * K + k0 + k]);
        const float v = __fadd_rn(__fmul_rn(__fmul_rn(xv - stats[2 * s], stats[2 * s + 1]),
                                            c.ln_s[k0 + k]),
                                  c.ln_b[k0 + k]);
        hs[s * KS_MAX + k] = __float2bfloat16(v);
      } else {
        hs[s * KS_MAX + k] = src[(size_t)s * K + k0 + k];
      }
    }
    __syncthreads();
    const int n = n0 + 2 * lane;
    for (int r0 = 0; r0 < S; r0 += ROWS) {
      float acc[ROWS][2];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r][0] = acc[r][1] = 0.f;
#pragma unroll 4
      for (int k = warp; k < kn; k += WARPS) {
        const size_t row = (size_t)(k0 + k) * N;
        const float w0 = n < N ? wval(w, row + n) : 0.f;
        const float w1 = n + 1 < N ? wval(w, row + n + 1) : 0.f;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          if (r0 + r < S) {
            const float hv = __bfloat162float(hs[(r0 + r) * KS_MAX + k]);
            acc[r][0] = fmaf(hv, w0, acc[r][0]);
            acc[r][1] = fmaf(hv, w1, acc[r][1]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        red[(warp * ROWS + r) * TILE_N + 2 * lane] = acc[r][0];
        red[(warp * ROWS + r) * TILE_N + 2 * lane + 1] = acc[r][1];
      }
      __syncthreads();
      for (int i = tid; i < ROWS * TILE_N; i += THREADS) {
        const int r = i / TILE_N, col = i % TILE_N;
        if (r0 + r < S && n0 + col < N) {
          float sum = 0.f;
          for (int q = 0; q < WARPS; ++q) sum += red[(q * ROWS + r) * TILE_N + col];
          c.part[((size_t)slab * S + r0 + r) * N + n0 + col] = sum;
        }
      }
      __syncthreads();
    }
  }
}

// Column n of row s of a projection: the slabs summed in order, times the
// int8 column scale, plus the bias (all in f32, uncontracted).
__device__ __forceinline__ float proj_out(const Proj& p, const float* part, int S, int s, int n) {
  const int ksplit = (p.K + p.ks - 1) / p.ks;
  float acc = 0.f;
  for (int j = 0; j < ksplit; ++j) acc += part[((size_t)j * S + s) * p.N + n];
  if (p.scale) acc = __fmul_rn(acc, p.scale[n]);
  return __fadd_rn(acc, p.bias[n]);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// One (row, head) per work item: q/k/v from the QKV partials, this step's
// K/V written at pos[s], softmax over the T cached keys with the additive
// mask, P.V in f32, ctx rounded to bf16.
__device__ void attention(const AttnArgs& a, float* smem) {
  const Common& c = a.c;
  const int S = c.S, D = c.D, T = a.T, H = a.heads, hd = D / H;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  float* qs = smem;             // [MAX_HD]
  float* red2 = qs + MAX_HD;    // [THREADS]
  float* rbuf = red2 + THREADS; // [32]
  float* sc = rbuf + 32;        // [T]
  const int G = THREADS / hd;   // key groups of the P.V sum
  for (int item = blockIdx.x; item < S * H; item += gridDim.x) {
    const int s = item / H, h = item % H;
    const int p = min(max(a.pos[s], 0), T - 1);
    __syncthreads();  // the previous item's readers of qs, sc and red2 are done
    for (int d = tid; d < hd; d += THREADS) {
      const int col = h * hd + d;
      qs[d] = round_bf16(proj_out(a.qkv, c.part, S, s, col)) * a.sm_scale;
      const size_t at = ((size_t)p * S + s) * D + col;
      a.cache_k[at] = __float2bfloat16(proj_out(a.qkv, c.part, S, s, D + col));
      a.cache_v[at] = __float2bfloat16(proj_out(a.qkv, c.part, S, s, 2 * D + col));
    }
    __syncthreads();  // the cache row and q are visible to the whole block
    for (int t = warp; t < T; t += WARPS) {
      const bf16* kr = a.cache_k + ((size_t)t * S + s) * D + h * hd;
      float dot = 0.f;
      for (int d = lane; d < hd; d += 32) dot = fmaf(qs[d], __bfloat162float(kr[d]), dot);
      dot = warp_sum(dot);
      if (lane == 0) sc[t] = dot + a.mask[(size_t)t * S + s];
    }
    __syncthreads();
    float m = -INFINITY;
    for (int t = tid; t < T; t += THREADS) m = fmaxf(m, sc[t]);
    m = block_reduce<true>(m, rbuf);
    float l = 0.f;
    for (int t = tid; t < T; t += THREADS) {
      const float e = expf(sc[t] - m);
      sc[t] = e;
      l += e;
    }
    l = block_reduce<false>(l, rbuf);
    for (int t = tid; t < T; t += THREADS) sc[t] = sc[t] / l;
    __syncthreads();
    if (tid < G * hd) {
      const int g = tid / hd, d = tid % hd;
      const bf16* vcol = a.cache_v + (size_t)s * D + h * hd + d;
      float acc = 0.f;
      for (int t = g; t < T; t += G) acc = fmaf(sc[t], __bfloat162float(vcol[(size_t)t * S * D]), acc);
      red2[tid] = acc;
    }
    __syncthreads();
    for (int d = tid; d < hd; d += THREADS) {
      float acc = 0.f;
      for (int g = 0; g < G; ++g) acc += red2[g * hd + d];
      a.ctx[(size_t)s * D + h * hd + d] = __float2bfloat16(acc);
    }
  }
}

// x_out = bf16(x + y) over [S, D], y the projection's output.
__device__ void residual(const Proj& p, const Common& c) {
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < c.S * c.D; i += gridDim.x * THREADS) {
    const float y = proj_out(p, c.part, c.S, i / c.D, i % c.D);
    c.x_out[i] = __float2bfloat16(__fadd_rn(__bfloat162float(c.x[i]), y));
  }
}

// h1 = bf16(gelu(fc1)), tanh form or exact.
__device__ void gelu_phase(const MlpArgs& a) {
  const int S = a.c.S, F = a.fc1.N;
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < S * F; i += gridDim.x * THREADS) {
    const float u = proj_out(a.fc1, a.c.part, S, i / F, i % F);
    float g;
    if (a.approx_gelu) {
      const float inner = 0.7978845608028654f * (u + 0.044715f * (u * u * u));
      g = 0.5f * u * (1.0f + tanhf(inner));
    } else {
      g = 0.5f * u * (1.0f + erff(u * 0.7071067811865476f));
    }
    a.h1[i] = __float2bfloat16(g);
  }
}

struct SmemLayout {
  float* stats;
  float* red;
  bf16* hs;
};

__device__ __forceinline__ SmemLayout layout(unsigned char* raw) {
  SmemLayout l;
  l.stats = reinterpret_cast<float*>(raw);
  l.red = l.stats + 2 * MAX_S;
  l.hs = reinterpret_cast<bf16*>(l.red + WARPS * ROWS * TILE_N);
  return l;
}

template <typename W>
__global__ void __launch_bounds__(THREADS) attn_step(AttnArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const SmemLayout sm = layout(smem_raw);
  cg::grid_group grid = cg::this_grid();
  ln_stats(a.c, sm.stats);
  proj_partials<W>(a.qkv, a.c, nullptr, sm.stats, sm.red, sm.hs);
  grid.sync();
  attention(a, reinterpret_cast<float*>(smem_raw));
  grid.sync();
  proj_partials<W>(a.out, a.c, a.ctx, nullptr, sm.red, sm.hs);
  grid.sync();
  residual(a.out, a.c);
}

template <typename W>
__global__ void __launch_bounds__(THREADS) mlp_step(MlpArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const SmemLayout sm = layout(smem_raw);
  cg::grid_group grid = cg::this_grid();
  ln_stats(a.c, sm.stats);
  proj_partials<W>(a.fc1, a.c, nullptr, sm.stats, sm.red, sm.hs);
  grid.sync();
  gelu_phase(a);
  grid.sync();
  proj_partials<W>(a.fc2, a.c, a.h1, nullptr, sm.red, sm.hs);
  grid.sync();
  residual(a.fc2, a.c);
}

size_t smem_bytes(bool attn, int S, int T) {
  const size_t proj = (2 * MAX_S + WARPS * ROWS * TILE_N) * sizeof(float)
                      + (size_t)S * KS_MAX * sizeof(bf16);
  const size_t att = attn ? (MAX_HD + THREADS + 32 + (size_t)T) * sizeof(float) : 0;
  return proj > att ? proj : att;
}

// Blocks of a cooperative launch: every block must be resident, so at most
// the occupancy per SM (at BLOCKS_PER_SM) times the SMs.  Negative on error.
template <typename Args>
int grid_for(void (*kernel)(Args), size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (err != cudaSuccess) return -(int)err;
  if (per_sm < 1) return -(int)cudaErrorInvalidConfiguration;
  return (per_sm < BLOCKS_PER_SM ? per_sm : BLOCKS_PER_SM) * sms;
}

template <typename Args>
int launch(void (*kernel)(Args), Args args, int grid, size_t smem, void* stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  void* params[] = {&args};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), dim3(grid), dim3(THREADS), params, smem,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

bool bad_common(int S, int D, int ks_a, int ks_b, int grid) {
  return S < 1 || S > MAX_S || D < 1 || ks_a < 1 || ks_a > KS_MAX || ks_b < 1 ||
         ks_b > KS_MAX || grid < 1;
}

}  // namespace

// C entry points, bound from Python with ctypes.  Every tensor is contiguous
// and row-major on the current device (the wrapper checks that); the
// launches go on `stream` without synchronising, and return the launch's
// cudaError_t (0 = launched).

// The grid of one kernel at S rows and T cache positions, or -cudaError_t.
extern "C" int fused_decode_grid(int mlp, int int8, int S, int T) {
  if (S < 1 || S > MAX_S || T < 0 || T > MAX_T) return -(int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(!mlp, S, T);
  if (mlp) return int8 ? grid_for(mlp_step<int8_t>, smem) : grid_for(mlp_step<bf16>, smem);
  return int8 ? grid_for(attn_step<int8_t>, smem) : grid_for(attn_step<bf16>, smem);
}

extern "C" int fused_attn_step_launch(
    int int8, const void* x, const void* ln_s, const void* ln_b, const void* wqkv,
    const void* sqkv, const void* bqkv, const void* wout, const void* sout, const void* bout,
    void* cache_k, void* cache_v, const void* pos, const void* mask, void* x_out, void* part,
    void* ctx, int S, int D, int T, int heads, float eps, float sm_scale, int ks_qkv,
    int ks_out, int grid, void* stream) {
  if (bad_common(S, D, ks_qkv, ks_out, grid) || heads < 1 || D % heads != 0 ||
      D / heads > MAX_HD || T < 1 || T > MAX_T)
    return (int)cudaErrorInvalidValue;
  AttnArgs a;
  a.c = {static_cast<const bf16*>(x), static_cast<const float*>(ln_s),
         static_cast<const float*>(ln_b), static_cast<bf16*>(x_out),
         static_cast<float*>(part), S, D, eps};
  a.qkv = {wqkv, int8 ? static_cast<const float*>(sqkv) : nullptr,
           static_cast<const float*>(bqkv), D, 3 * D, ks_qkv};
  a.out = {wout, int8 ? static_cast<const float*>(sout) : nullptr,
           static_cast<const float*>(bout), D, D, ks_out};
  a.cache_k = static_cast<bf16*>(cache_k);
  a.cache_v = static_cast<bf16*>(cache_v);
  a.pos = static_cast<const int*>(pos);
  a.mask = static_cast<const float*>(mask);
  a.ctx = static_cast<bf16*>(ctx);
  a.T = T;
  a.heads = heads;
  a.sm_scale = sm_scale;
  const size_t smem = smem_bytes(true, S, T);
  return int8 ? launch(attn_step<int8_t>, a, grid, smem, stream)
              : launch(attn_step<bf16>, a, grid, smem, stream);
}

extern "C" int fused_mlp_step_launch(
    int int8, const void* x, const void* ln_s, const void* ln_b, const void* w1, const void* s1,
    const void* b1, const void* w2, const void* s2, const void* b2, void* x_out, void* part,
    void* h1, int S, int D, int F, float eps, int approx_gelu, int ks1, int ks2, int grid,
    void* stream) {
  if (bad_common(S, D, ks1, ks2, grid) || F < 1) return (int)cudaErrorInvalidValue;
  MlpArgs a;
  a.c = {static_cast<const bf16*>(x), static_cast<const float*>(ln_s),
         static_cast<const float*>(ln_b), static_cast<bf16*>(x_out),
         static_cast<float*>(part), S, D, eps};
  a.fc1 = {w1, int8 ? static_cast<const float*>(s1) : nullptr,
           static_cast<const float*>(b1), D, F, ks1};
  a.fc2 = {w2, int8 ? static_cast<const float*>(s2) : nullptr,
           static_cast<const float*>(b2), F, D, ks2};
  a.h1 = static_cast<bf16*>(h1);
  a.approx_gelu = approx_gelu;
  const size_t smem = smem_bytes(false, S, 0);
  return int8 ? launch(mlp_step<int8_t>, a, grid, smem, stream)
              : launch(mlp_step<bf16>, a, grid, smem, stream);
}
