// Exact-sampling Monte Carlo kernels for Hopper (sm_90a): Q1 curve sums,
// Q2b ZBC control-variate moments, Q3 pathwise vega, pathwise delta, and
// the option kernels' normals.  Plain C interface, loaded with ctypes
// (hullwhite_tpu_torch/kernels/build.py); the Python wrappers in
// hullwhite_tpu_torch/kernels/fused.py allocate every buffer and pass the
// current stream.  The seed triple and the 13 (delta: 15) option consts go
// to the kernels by value, so a launch copies nothing to the card.
//
// Replaces (hullwhite_tpu/pallas/fused.py):
//   curve_exact_kernel    <- _curve_exact_kernel (Q1)
//   zbc_exact_kernel      <- _zbc_exact_kernel + _legs_pair + _moment_accum
//   vega_exact_kernel     <- _vega_exact_kernel + _vega_terms
//   delta_exact_kernel    <- _delta_exact_kernel
//   option_normals_kernel <- the inner kernel of dump_option_normals
//
// Each CTA writes partial sums that reduce_kernel (hw_reduce.cuh) sums in
// a fixed order: no float atomics, so reruns are bitwise identical.
//
// What bounds them on the H100:
//   * curve_exact: fp32 FMA.  Each path samples k = n_mat - 1 normals and
//     multiplies them by the k x k factor sig_st L^T: 2^20 paths x 100 x 100
//     MACs per call at the reference size, on the CUDA cores.
//   * zbc/vega/delta/normals: per-element SFU work (2 hashes, log, sqrt, 2-4 exp,
//     2 reciprocals) and no memory traffic at all.
// What this simple design leaves for later work: a tensor-core (wgmma/mma)
// product for Q1 with the normals staged as bf16x3 or TF32 splits; fewer
// partials per call (persistent CTAs); 28 of 128 column threads idle in
// the Q1 product when n_mat - 1 = 100.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hw_device.cuh"
#include "hw_reduce.cuh"

namespace {

constexpr int PAD = 128;                        // fused.PAD
constexpr int TILE_EXACT = 4096;                // fused.TILE_EXACT (BM rows)
constexpr int TILE_OPT = 256;                   // fused.TILE_OPT
constexpr int OPT_TILE_ELEMS = TILE_OPT * PAD;  // pairs (paths) per option tile

// Q1: a chunk is CHUNK_ROWS Box-Muller rows of one tile = 2 * CHUNK_ROWS
// paths (the cos and sin halves); a CTA walks CHUNKS_PER_CTA chunks.
constexpr int CURVE_THREADS = 256;              // 2 row groups x 128 columns
constexpr int CHUNK_ROWS = 32;
constexpr int CHUNK_PATHS = 2 * CHUNK_ROWS;
constexpr int GROUP_PATHS = CHUNK_PATHS / (CURVE_THREADS / PAD);  // 32
constexpr int CHUNKS_PER_TILE = TILE_EXACT / CHUNK_ROWS;          // 128
constexpr int CHUNKS_PER_CTA = 8;

// Q2b/Q3/delta: one element per thread per step, OPT_PER_THREAD steps.
constexpr int OPT_THREADS = 256;
constexpr int OPT_PER_THREAD = 8;
constexpr int OPT_PER_CTA = OPT_THREADS * OPT_PER_THREAD;  // 2048

constexpr int NORMALS_THREADS = 256;

// Layout of fused._zbc_consts + the sampling factor (fused.py:450, :638),
// then the delta kernel's [dr/dr0, dI/dr0] (zero for the other kernels).
struct OptConsts {
  float c_r, c_i, A, B, K, P0S2, c_dr, c_di, sigma, q, l11, l21, l22;
  float dr_dr0, di_dr0;
};

// ---------------------------------------------------------------------------
// Q1: per-maturity sums of t + 1/t, t = exp(-z), z = X (sig_st L^T).
// Shared memory: W (k x k, live block only) and the chunk's normals stored
// k-major (Xs[j * 64 + p], p = path within the chunk), so the product reads
// four paths per 16-byte broadcast load.  Thread (g, m) owns maturity
// column m for the 32 paths of row group g.  Columns >= k of the padded
// TPU operand multiply zero rows and the hash is stateless, so they are
// neither drawn nor multiplied.
// ---------------------------------------------------------------------------
template <bool BF16>
__global__ void __launch_bounds__(CURVE_THREADS)
curve_exact_kernel(hw::Seeds sd, const float* __restrict__ W, int ldw, int k,
                   int ws_floats, float* __restrict__ partials) {
  extern __shared__ float4 smem4[];
  float* Ws = reinterpret_cast<float*>(smem4);
  float* Xs = Ws + ws_floats;
  const int tid = threadIdx.x;
  for (int i = tid; i < k * k; i += CURVE_THREADS) {
    const float w = W[(i / k) * ldw + (i % k)];
    Ws[i] = BF16 ? hw::round_bf16(w) : w;
  }
  const int m = tid % PAD;
  const int g = tid / PAD;
  float colsum = 0.0f;

  for (int j = 0; j < CHUNKS_PER_CTA; ++j) {
    const int chunk = blockIdx.x * CHUNKS_PER_CTA + j;
    const uint32_t tile = sd.s2 + static_cast<uint32_t>(chunk / CHUNKS_PER_TILE);
    const uint32_t row0 = static_cast<uint32_t>((chunk % CHUNKS_PER_TILE) * CHUNK_ROWS);
    const uint32_t s0 = hw::tile_seed(sd.s0, tile);
    __syncthreads();  // W staged / previous chunk consumed
    for (int p = tid; p < CHUNK_ROWS * k; p += CURVE_THREADS) {
      const int r = p / k, col = p % k;
      float z0, z1;
      hw::box_muller(s0, sd.s1, (row0 + r) * PAD + col, z0, z1);
      Xs[col * CHUNK_PATHS + r] = BF16 ? hw::round_bf16(z0) : z0;
      Xs[col * CHUNK_PATHS + CHUNK_ROWS + r] = BF16 ? hw::round_bf16(z1) : z1;
    }
    __syncthreads();
    if (m < k) {
      float acc[GROUP_PATHS];
#pragma unroll
      for (int r = 0; r < GROUP_PATHS; ++r) acc[r] = 0.0f;
      const float* xg = Xs + g * GROUP_PATHS;
      for (int jj = 0; jj < k; ++jj) {
        const float w = Ws[jj * k + m];
        const float4* x4 = reinterpret_cast<const float4*>(xg + jj * CHUNK_PATHS);
#pragma unroll
        for (int q = 0; q < GROUP_PATHS / 4; ++q) {
          const float4 x = x4[q];
          acc[4 * q + 0] = fmaf(x.x, w, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(x.y, w, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(x.z, w, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(x.w, w, acc[4 * q + 3]);
        }
      }
#pragma unroll
      for (int r = 0; r < GROUP_PATHS; ++r) {
        // antithetic pair from one exp: e^{-(c+z)} + e^{-(c-z)} = e^{-c}(t + 1/t)
        const float t = expf(-acc[r]);
        colsum += t + __frcp_rn(t);
      }
    }
  }
  __syncthreads();
  float* other = Xs;  // reuse: row group 1 hands its column sums to group 0
  if (g == 1) other[m] = colsum;
  __syncthreads();
  if (g == 0) partials[blockIdx.x * PAD + m] = colsum + other[m];
}

// ---------------------------------------------------------------------------
// Q2b: both antithetic legs share one exp per process (_legs_pair):
//   P(+/-) = A e^{-B c_r} t_r^{+/-1},  disc(+/-) = e^{-c_I} t_i^{+/-1}.
// Five centered CV moments per CTA (_moment_accum rows 0-4).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(OPT_THREADS)
zbc_exact_kernel(hw::Seeds sd, OptConsts c, float* __restrict__ partials) {
  const float P_base = c.A * expf(-c.B * c.c_r);
  const float d_base = expf(-c.c_i);
  float s[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int j = 0; j < OPT_PER_THREAD; ++j) {
    const long long e = static_cast<long long>(blockIdx.x) * OPT_PER_CTA +
                        j * OPT_THREADS + threadIdx.x;
    const uint32_t tile = sd.s2 + static_cast<uint32_t>(e / OPT_TILE_ELEMS);
    const uint32_t idx = static_cast<uint32_t>(e % OPT_TILE_ELEMS);
    float x1, x2;
    hw::box_muller(hw::tile_seed(sd.s0, tile), sd.s1, idx, x1, x2);
    hw::zbc_pair_moments(c, P_base, d_base, c.l11 * x1,
                         c.l21 * x1 + c.l22 * x2, s);
  }
  block_sum<5, OPT_THREADS>(s, partials + blockIdx.x * 5);
}

// ---------------------------------------------------------------------------
// Q3: pathwise vega, single leg (_vega_terms):
//   v = 1{P>K} (-P B (q + dr)) disc - dI disc (P - K)^+,
//   dr = c_dr + z_r / sigma,  dI = c_dI + z_I / sigma.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(OPT_THREADS)
vega_exact_kernel(hw::Seeds sd, OptConsts c, float* __restrict__ partials) {
  float s[1] = {0.0f};
  for (int j = 0; j < OPT_PER_THREAD; ++j) {
    const long long e = static_cast<long long>(blockIdx.x) * OPT_PER_CTA +
                        j * OPT_THREADS + threadIdx.x;
    const uint32_t tile = sd.s2 + static_cast<uint32_t>(e / OPT_TILE_ELEMS);
    const uint32_t idx = static_cast<uint32_t>(e % OPT_TILE_ELEMS);
    float x1, x2;
    hw::box_muller(hw::tile_seed(sd.s0, tile), sd.s1, idx, x1, x2);
    s[0] += hw::vega_term(c, c.l11 * x1, c.l21 * x1 + c.l22 * x2);
  }
  block_sum<1, OPT_THREADS>(s, partials + blockIdx.x);
}

// ---------------------------------------------------------------------------
// Pathwise delta (d price / d r0), both antithetic legs (hw::delta_pair):
// the ZBC kernel's state and exps with another tail, one accumulator.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(OPT_THREADS)
delta_exact_kernel(hw::Seeds sd, OptConsts c, float* __restrict__ partials) {
  const float P_base = c.A * expf(-c.B * c.c_r);
  const float d_base = expf(-c.c_i);
  float s[1] = {0.0f};
  for (int j = 0; j < OPT_PER_THREAD; ++j) {
    const long long e = static_cast<long long>(blockIdx.x) * OPT_PER_CTA +
                        j * OPT_THREADS + threadIdx.x;
    const uint32_t tile = sd.s2 + static_cast<uint32_t>(e / OPT_TILE_ELEMS);
    const uint32_t idx = static_cast<uint32_t>(e % OPT_TILE_ELEMS);
    float x1, x2;
    hw::box_muller(hw::tile_seed(sd.s0, tile), sd.s1, idx, x1, x2);
    s[0] += hw::delta_pair(c, P_base, d_base, c.l11 * x1,
                           c.l21 * x1 + c.l22 * x2);
  }
  block_sum<1, OPT_THREADS>(s, partials + blockIdx.x);
}

// (x1, x2) of every element of n_tiles option tiles, row-major
// (n_tiles * TILE_OPT, PAD) like dump_option_normals.
__global__ void __launch_bounds__(NORMALS_THREADS)
option_normals_kernel(hw::Seeds sd, long long n,
                      float* __restrict__ x1, float* __restrict__ x2) {
  const long long e = static_cast<long long>(blockIdx.x) * NORMALS_THREADS + threadIdx.x;
  if (e >= n) return;
  const uint32_t tile = sd.s2 + static_cast<uint32_t>(e / OPT_TILE_ELEMS);
  float a, b;
  hw::box_muller(hw::tile_seed(sd.s0, tile), sd.s1,
                 static_cast<uint32_t>(e % OPT_TILE_ELEMS), a, b);
  x1[e] = a;
  x2[e] = b;
}

int curve_ctas(int n_tiles) { return n_tiles * (CHUNKS_PER_TILE / CHUNKS_PER_CTA); }
int option_ctas(int n_tiles) { return n_tiles * (OPT_TILE_ELEMS / OPT_PER_CTA); }

OptConsts load_consts(const float* h) {
  OptConsts c;
  c.c_r = h[0]; c.c_i = h[1]; c.A = h[2]; c.B = h[3]; c.K = h[4];
  c.P0S2 = h[5]; c.c_dr = h[6]; c.c_di = h[7]; c.sigma = h[8]; c.q = h[9];
  c.l11 = h[10]; c.l21 = h[11]; c.l22 = h[12];
  c.dr_dr0 = 0.0f; c.di_dr0 = 0.0f;
  return c;
}

OptConsts load_delta_consts(const float* h) {
  OptConsts c = load_consts(h);
  c.dr_dr0 = h[13]; c.di_dr0 = h[14];
  return c;
}

}  // namespace

extern "C" {

// Scratch sizes (floats) the wrappers allocate for the partial sums.
int hw_curve_partials(int n_tiles) { return curve_ctas(n_tiles) * PAD; }
int hw_zbc_partials(int n_tiles) { return option_ctas(n_tiles) * 5; }
int hw_vega_partials(int n_tiles) { return option_ctas(n_tiles); }
int hw_delta_partials(int n_tiles) { return option_ctas(n_tiles); }

// out (k + 1): [count, e^{-c_m} sum_paths (t + 1/t) for m < k].
int hw_curve_exact(int32_t s0, int32_t s1, int32_t s2, const float* W,
                   int ldw, const float* c, int k, int n_tiles, int bf16,
                   float count, float* partials, float* out, void* stream) {
  if (k < 1 || k > PAD || n_tiles < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ws_floats = (k * k + 3) & ~3;
  // the normals' region doubles as the PAD-float hand-off of the epilogue
  const int xs_floats = k * CHUNK_PATHS > PAD ? k * CHUNK_PATHS : PAD;
  const size_t smem = sizeof(float) * (ws_floats + xs_floats);
  const int ctas = curve_ctas(n_tiles);
  cudaError_t err;
  if (bf16) {
    err = cudaFuncSetAttribute(curve_exact_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    curve_exact_kernel<true><<<ctas, CURVE_THREADS, smem, st>>>(make_seeds(s0, s1, s2), W, ldw, k, ws_floats, partials);
  } else {
    err = cudaFuncSetAttribute(curve_exact_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    curve_exact_kernel<false><<<ctas, CURVE_THREADS, smem, st>>>(make_seeds(s0, s1, s2), W, ldw, k, ws_floats, partials);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_kernel<<<k, REDUCE_THREADS, 0, st>>>(partials, ctas, PAD, c, nullptr, out, 1, count, 0);
  return static_cast<int>(cudaGetLastError());
}

// out (6): [sum X, sum Yc, sum X^2, sum Yc^2, sum X Yc, count].
int hw_zbc_exact(int32_t s0, int32_t s1, int32_t s2, const float* consts_host,
                 int n_tiles, float count, float* partials, float* out,
                 void* stream) {
  if (n_tiles < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ctas = option_ctas(n_tiles);
  zbc_exact_kernel<<<ctas, OPT_THREADS, 0, st>>>(make_seeds(s0, s1, s2), load_consts(consts_host), partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_kernel<<<5, REDUCE_THREADS, 0, st>>>(partials, ctas, 5, nullptr, nullptr, out, 0, count, 5);
  return static_cast<int>(cudaGetLastError());
}

// out (2): [sum v, count].
int hw_vega_exact(int32_t s0, int32_t s1, int32_t s2, const float* consts_host,
                  int n_tiles, float count, float* partials, float* out,
                  void* stream) {
  if (n_tiles < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ctas = option_ctas(n_tiles);
  vega_exact_kernel<<<ctas, OPT_THREADS, 0, st>>>(make_seeds(s0, s1, s2), load_consts(consts_host), partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_kernel<<<1, REDUCE_THREADS, 0, st>>>(partials, ctas, 1, nullptr, nullptr, out, 0, count, 1);
  return static_cast<int>(cudaGetLastError());
}

// out (2): [sum of delta terms over both legs, count]; consts_host (15).
int hw_delta_exact(int32_t s0, int32_t s1, int32_t s2, const float* consts_host,
                   int n_tiles, float count, float* partials, float* out,
                   void* stream) {
  if (n_tiles < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ctas = option_ctas(n_tiles);
  delta_exact_kernel<<<ctas, OPT_THREADS, 0, st>>>(make_seeds(s0, s1, s2), load_delta_consts(consts_host), partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_kernel<<<1, REDUCE_THREADS, 0, st>>>(partials, ctas, 1, nullptr, nullptr, out, 0, count, 1);
  return static_cast<int>(cudaGetLastError());
}

int hw_option_normals(int32_t s0, int32_t s1, int32_t s2, int n_tiles,
                      float* x1, float* x2, void* stream) {
  if (n_tiles < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(n_tiles) * OPT_TILE_ELEMS;
  const int ctas = static_cast<int>((n + NORMALS_THREADS - 1) / NORMALS_THREADS);
  option_normals_kernel<<<ctas, NORMALS_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      make_seeds(s0, s1, s2), n, x1, x2);
  return static_cast<int>(cudaGetLastError());
}

const char* hw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
