// Full-step Monte Carlo kernels for Hopper (sm_90a): Q1 curve sums, Q2b
// ZBC control-variate moments and Q3 pathwise vega with one fresh random
// value per path per time step over all n_steps.  Plain C interface,
// loaded with ctypes (hullwhite_tpu_torch/kernels/build.py); the Python
// wrappers in hullwhite_tpu_torch/kernels/fused.py allocate every buffer
// and pass the current stream.  The seed triple and the 10 option consts
// go to the kernels by value.
//
// Replaces (hullwhite_tpu/pallas/fused.py):
//   curve_full_kernel <- _curve_kernel (Q1 full step)
//   zbc_full_kernel   <- _zbc_full_kernel + _legs_pair + _moment_accum
//   vega_full_kernel  <- _vega_full_kernel + _vega_terms
//
// The generator is _raw_block behind the interpret-mode _tile_rng: per
// 128-step block q (the draw salt) each u32 word gives two exact bf16 raws
// (hw::raw_pair).  The Hadamard mix is pre-folded into the weights on the
// host, so each kernel runs one product per block on the raws:
//   curve:   z (paths, 128 maturities) += U_q (paths, 128 steps) @ W_q;
//            word i * 128 + k of block q holds steps k of paths 2i (low
//            half) and 2i + 1 (high half);
//   options: (z_r, z_i) = rows 0 and 1 of sum_q W_q (2, 128) @ U_q;
//            word j * 4096 + p holds steps 2j (low) and 2j + 1 (high) of
//            path p.
// "highest" multiplies the exact raws by the fp32 weights; any other
// precision rounds the weights to bf16 first; both accumulate in fp32.
// Each CTA writes partial sums that reduce_kernel (hw_reduce.cuh) sums in
// a fixed order: no float atomics, so reruns are bitwise identical.
//
// What bounds them on the H100:
//   * curve_full: fp32 FMA on the CUDA cores, 2^20 paths x 1024 steps x 128
//     columns per call at the reference size (1.4e11 FMAs, of which 100 of
//     128 columns and 1000 of 1024 steps are live).  The design keeps the
//     product's operands in shared memory and registers: per 64-step stage
//     a CTA stages 64 x 128 weights and 64 x 128 raws (64 KB); each thread
//     holds a 16-path x 4-column register tile, so one broadcast float4
//     load feeds 16 FMAs and one weight load 16.  Hashing costs one word
//     per path pair per step, about a tenth of the FMA issue slots.
//   * zbc_full/vega_full: integer ALU (three murmur3 rounds per word, one
//     word per two steps) plus 4 FMAs per word; the weight rows (2 x 512
//     floats) sit in shared memory and every read is a broadcast.
// What this simple design leaves for later work: the raws are exact bf16,
// so the curve product can run on the tensor cores (mma/wgmma with bf16
// hi/mid/lo splits of W for "highest", one bf16 pass otherwise); the
// 28 dead columns and 24 dead steps are multiplied as zeros.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hw_device.cuh"
#include "hw_reduce.cuh"

namespace {

constexpr int PAD = 128;             // fused.PAD: maturity columns of W
constexpr int MIX_BLOCK = 128;       // fused._MIX_BLOCK: steps per block (the draw salt)
constexpr int TILE_FULL = 2048;      // fused.TILE_FULL: curve paths per tile
constexpr int TILE_FULL_OPT = 4096;  // fused.TILE_FULL_OPT: option paths per tile

// Q1: a CTA owns CURVE_PATHS paths of one tile and walks every block in
// stages of SUB steps.  Warp w owns paths 16w .. 16w + 15; lane l owns
// columns l, l + 32, l + 64, l + 96.
constexpr int CURVE_THREADS = 256;
constexpr int CURVE_PATHS = 128;
constexpr int CURVE_WARPS = CURVE_THREADS / 32;
constexpr int WARP_PATHS = CURVE_PATHS / CURVE_WARPS;  // 16
constexpr int LANE_COLS = PAD / 32;                    // 4
constexpr int SUB = 64;                                // steps per stage
constexpr int CURVE_PAIRS = CURVE_PATHS / 2;           // words per step per CTA
constexpr int CURVE_CTAS_PER_TILE = TILE_FULL / CURVE_PATHS;  // 16
constexpr int CURVE_SMEM = static_cast<int>(sizeof(float)) * (SUB * PAD + SUB * CURVE_PATHS);

// Q2b/Q3: one path per thread.
constexpr int OPT_THREADS = 256;
constexpr int OPT_CTAS_PER_TILE = TILE_FULL_OPT / OPT_THREADS;  // 16

// fused._zbc_consts (fused.py:450).
struct FullConsts {
  float c_r, c_i, A, B, K, P0S2, c_dr, c_di, sigma, q;
};

// ---------------------------------------------------------------------------
// Q1: per-maturity sums of t + 1/t, t = exp(-z), z = sum_q U_q W_q.
// Shared memory per stage: Ws[k][m] the stage's weight rows (bf16-rounded
// for non-"highest" precision) and Xs[k][p] the raws of its 128 paths,
// both step-major.
// ---------------------------------------------------------------------------
template <bool BF16>
__global__ void __launch_bounds__(CURVE_THREADS, 2)
curve_full_kernel(hw::Seeds sd, const float* __restrict__ W, int nb,
                  float* __restrict__ partials) {
  extern __shared__ float4 curve_smem[];
  float* Ws = reinterpret_cast<float*>(curve_smem);  // [SUB][PAD]
  float* Xs = Ws + SUB * PAD;                         // [SUB][CURVE_PATHS]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t tile = sd.s2 + static_cast<uint32_t>(blockIdx.x / CURVE_CTAS_PER_TILE);
  const uint32_t pair0 = static_cast<uint32_t>(blockIdx.x % CURVE_CTAS_PER_TILE) * CURVE_PAIRS;
  const uint32_t s0 = hw::tile_seed(sd.s0, tile);
  // the word's pair and first step row of this thread's draws
  const int pair = tid % CURVE_PAIRS;
  const int row0 = tid / CURVE_PAIRS;

  float acc[WARP_PATHS][LANE_COLS];
#pragma unroll
  for (int r = 0; r < WARP_PATHS; ++r)
#pragma unroll
    for (int c = 0; c < LANE_COLS; ++c) acc[r][c] = 0.0f;

  for (int q = 0; q < nb; ++q) {
    for (int h = 0; h < MIX_BLOCK / SUB; ++h) {
      __syncthreads();  // the previous stage is consumed
      const float4* Wg = reinterpret_cast<const float4*>(
          W + static_cast<size_t>(q * MIX_BLOCK + h * SUB) * PAD);
      float4* Ws4 = reinterpret_cast<float4*>(Ws);
      for (int i = tid; i < SUB * PAD / 4; i += CURVE_THREADS) {
        float4 w = Wg[i];
        if (BF16) {
          w.x = hw::round_bf16(w.x);
          w.y = hw::round_bf16(w.y);
          w.z = hw::round_bf16(w.z);
          w.w = hw::round_bf16(w.w);
        }
        Ws4[i] = w;
      }
      for (int k = row0; k < SUB; k += CURVE_THREADS / CURVE_PAIRS) {
        const uint32_t idx = (pair0 + pair) * MIX_BLOCK + h * SUB + k;
        float lo, hi;
        hw::raw_pair(hw::tile_draw(s0, sd.s1, idx, static_cast<uint32_t>(q)), lo, hi);
        *reinterpret_cast<float2*>(Xs + k * CURVE_PATHS + 2 * pair) = make_float2(lo, hi);
      }
      __syncthreads();
      const float* xw = Xs + warp * WARP_PATHS;
#pragma unroll 2
      for (int k = 0; k < SUB; ++k) {
        float w[LANE_COLS];
#pragma unroll
        for (int c = 0; c < LANE_COLS; ++c) w[c] = Ws[k * PAD + lane + 32 * c];
        const float4* x4 = reinterpret_cast<const float4*>(xw + k * CURVE_PATHS);
#pragma unroll
        for (int r4 = 0; r4 < WARP_PATHS / 4; ++r4) {
          const float4 x = x4[r4];
#pragma unroll
          for (int c = 0; c < LANE_COLS; ++c) {
            acc[4 * r4 + 0][c] = fmaf(x.x, w[c], acc[4 * r4 + 0][c]);
            acc[4 * r4 + 1][c] = fmaf(x.y, w[c], acc[4 * r4 + 1][c]);
            acc[4 * r4 + 2][c] = fmaf(x.z, w[c], acc[4 * r4 + 2][c]);
            acc[4 * r4 + 3][c] = fmaf(x.w, w[c], acc[4 * r4 + 3][c]);
          }
        }
      }
    }
  }

  // antithetic pair from one exp: e^{-(c+z)} + e^{-(c-z)} = e^{-c}(t + 1/t);
  // e^{-c} is applied in the second pass
  float colsum[LANE_COLS];
#pragma unroll
  for (int c = 0; c < LANE_COLS; ++c) {
    colsum[c] = 0.0f;
#pragma unroll
    for (int r = 0; r < WARP_PATHS; ++r) {
      const float t = expf(-acc[r][c]);
      colsum[c] += t + __frcp_rn(t);
    }
  }
  __syncthreads();  // Xs is free: it takes the warps' column sums
  float* red = Xs;  // [CURVE_WARPS][PAD]
#pragma unroll
  for (int c = 0; c < LANE_COLS; ++c) red[warp * PAD + lane + 32 * c] = colsum[c];
  __syncthreads();
  if (tid < PAD) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < CURVE_WARPS; ++w) s += red[w * PAD + tid];
    partials[static_cast<size_t>(blockIdx.x) * PAD + tid] = s;
  }
}

// ---------------------------------------------------------------------------
// Q2b/Q3: (z_r, z_i) of this thread's path, rows 0 and 1 of the weights
// staged once in shared memory (ws[0 .. ld) row 0, ws[ld .. 2 ld) row 1).
// ---------------------------------------------------------------------------
template <bool BF16>
__device__ __forceinline__ void full_state(hw::Seeds sd, const float* __restrict__ W,
                                           int nb, float* ws, float& z_r, float& z_i) {
  const int ld = nb * MIX_BLOCK;
  for (int i = threadIdx.x; i < 2 * ld; i += OPT_THREADS) {
    const float w = W[i];
    ws[i] = BF16 ? hw::round_bf16(w) : w;
  }
  __syncthreads();
  const uint32_t tile = sd.s2 + static_cast<uint32_t>(blockIdx.x / OPT_CTAS_PER_TILE);
  const uint32_t p = static_cast<uint32_t>(blockIdx.x % OPT_CTAS_PER_TILE) * OPT_THREADS + threadIdx.x;
  const uint32_t s0 = hw::tile_seed(sd.s0, tile);
  float zr = 0.0f, zi = 0.0f;
  for (int q = 0; q < nb; ++q) {
    const float2* wr = reinterpret_cast<const float2*>(ws + q * MIX_BLOCK);
    const float2* wi = reinterpret_cast<const float2*>(ws + ld + q * MIX_BLOCK);
#pragma unroll 4
    for (int j = 0; j < MIX_BLOCK / 2; ++j) {
      float lo, hi;
      hw::raw_pair(hw::tile_draw(s0, sd.s1, j * TILE_FULL_OPT + p, static_cast<uint32_t>(q)), lo, hi);
      const float2 a = wr[j], b = wi[j];
      zr = fmaf(lo, a.x, zr);
      zr = fmaf(hi, a.y, zr);
      zi = fmaf(lo, b.x, zi);
      zi = fmaf(hi, b.y, zi);
    }
  }
  z_r = zr;
  z_i = zi;
}

template <bool BF16>
__global__ void __launch_bounds__(OPT_THREADS)
zbc_full_kernel(hw::Seeds sd, FullConsts c, const float* __restrict__ W, int nb,
                float* __restrict__ partials) {
  extern __shared__ float opt_smem[];
  float z_r, z_i;
  full_state<BF16>(sd, W, nb, opt_smem, z_r, z_i);
  const float P_base = c.A * expf(-c.B * c.c_r);
  const float d_base = expf(-c.c_i);
  float s[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  hw::zbc_pair_moments(c, P_base, d_base, z_r, z_i, s);
  block_sum<5, OPT_THREADS>(s, partials + blockIdx.x * 5);
}

template <bool BF16>
__global__ void __launch_bounds__(OPT_THREADS)
vega_full_kernel(hw::Seeds sd, FullConsts c, const float* __restrict__ W, int nb,
                 float* __restrict__ partials) {
  extern __shared__ float opt_smem[];
  float z_r, z_i;
  full_state<BF16>(sd, W, nb, opt_smem, z_r, z_i);
  float s[1] = {hw::vega_term(c, z_r, z_i)};
  block_sum<1, OPT_THREADS>(s, partials + blockIdx.x);
}

int curve_full_ctas(int n_tiles) { return n_tiles * CURVE_CTAS_PER_TILE; }
int option_full_ctas(int n_tiles) { return n_tiles * OPT_CTAS_PER_TILE; }

FullConsts load_full_consts(const float* h) {
  FullConsts c;
  c.c_r = h[0]; c.c_i = h[1]; c.A = h[2]; c.B = h[3]; c.K = h[4];
  c.P0S2 = h[5]; c.c_dr = h[6]; c.c_di = h[7]; c.sigma = h[8]; c.q = h[9];
  return c;
}

template <class Kernel>
cudaError_t launch_option(Kernel kernel, int n_tiles, int nb, cudaStream_t st,
                          hw::Seeds sd, const FullConsts& c, const float* W,
                          float* partials) {
  const size_t smem = sizeof(float) * 2 * nb * MIX_BLOCK;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<option_full_ctas(n_tiles), OPT_THREADS, smem, st>>>(sd, c, W, nb, partials);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Scratch sizes (floats) the wrappers allocate for the partial sums.
int hw_curve_full_partials(int n_tiles) { return curve_full_ctas(n_tiles) * PAD; }
int hw_option_full_partials(int n_tiles, int n_values) {
  return option_full_ctas(n_tiles) * n_values;
}

// out (n_mat): [count, exp_c[m] * sum_paths (t + 1/t) for 1 <= m < n_mat].
// W is (nb * 128, PAD) row-major; exp_c is (PAD,).
int hw_curve_full(int32_t s0, int32_t s1, int32_t s2, const float* W, int nb,
                  const float* exp_c, int n_mat, int n_tiles, int bf16,
                  float count, float* partials, float* out, void* stream) {
  if (nb < 1 || n_mat < 2 || n_mat > PAD || n_tiles < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ctas = curve_full_ctas(n_tiles);
  cudaError_t err;
  if (bf16) {
    err = cudaFuncSetAttribute(curve_full_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, CURVE_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    curve_full_kernel<true><<<ctas, CURVE_THREADS, CURVE_SMEM, st>>>(make_seeds(s0, s1, s2), W, nb, partials);
  } else {
    err = cudaFuncSetAttribute(curve_full_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, CURVE_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    curve_full_kernel<false><<<ctas, CURVE_THREADS, CURVE_SMEM, st>>>(make_seeds(s0, s1, s2), W, nb, partials);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // column 0 (T = 0) is the count: partial column m + 1 goes to out[1 + m]
  reduce_kernel<<<n_mat - 1, REDUCE_THREADS, 0, st>>>(partials + 1, ctas, PAD, nullptr,
                                                     exp_c + 1, out, 1, count, 0);
  return static_cast<int>(cudaGetLastError());
}

// out (6): [sum X, sum Yc, sum X^2, sum Yc^2, sum X Yc, count].
// W is (8, nb * 128) row-major; rows 0 and 1 are read.
int hw_zbc_full(int32_t s0, int32_t s1, int32_t s2, const float* W, int nb,
                const float* consts_host, int n_tiles, int bf16, float count,
                float* partials, float* out, void* stream) {
  if (nb < 1 || n_tiles < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const hw::Seeds sd = make_seeds(s0, s1, s2);
  const FullConsts c = load_full_consts(consts_host);
  cudaError_t err = bf16 ? launch_option(zbc_full_kernel<true>, n_tiles, nb, st, sd, c, W, partials)
                         : launch_option(zbc_full_kernel<false>, n_tiles, nb, st, sd, c, W, partials);
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_kernel<<<5, REDUCE_THREADS, 0, st>>>(partials, option_full_ctas(n_tiles), 5, nullptr,
                                              nullptr, out, 0, count, 5);
  return static_cast<int>(cudaGetLastError());
}

// out (2): [sum v, count].
int hw_vega_full(int32_t s0, int32_t s1, int32_t s2, const float* W, int nb,
                 const float* consts_host, int n_tiles, int bf16, float count,
                 float* partials, float* out, void* stream) {
  if (nb < 1 || n_tiles < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const hw::Seeds sd = make_seeds(s0, s1, s2);
  const FullConsts c = load_full_consts(consts_host);
  cudaError_t err = bf16 ? launch_option(vega_full_kernel<true>, n_tiles, nb, st, sd, c, W, partials)
                         : launch_option(vega_full_kernel<false>, n_tiles, nb, st, sd, c, W, partials);
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_kernel<<<1, REDUCE_THREADS, 0, st>>>(partials, option_full_ctas(n_tiles), 1, nullptr,
                                              nullptr, out, 0, count, 1);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
