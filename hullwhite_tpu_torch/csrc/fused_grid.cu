// Option-surface kernel for Hopper (sm_90a): the control-variate moments of
// an nK x nS2 surface of European calls on P(S1, S2_j) with strikes K_i,
// every cell from the same exact-sampled state per antithetic pair.  Plain
// C interface, loaded with ctypes (hullwhite_tpu_torch/kernels/build.py);
// the wrapper fused.grid_exact allocates every buffer and passes the
// current stream.  The seeds and every const (at most MAX_K strikes and
// MAX_S2 maturities) go to the kernel by value: a launch copies nothing to
// the card.
//
// Replaces (hullwhite_tpu/pallas/fused.py):
//   grid_exact_kernel <- _grid_exact_kernel (:768), consts of grid_local_fn
//
// Per pair: the option normals of the exact kernels (salt 505 by the key),
// z_r = l11 x1, z_I = l21 x1 + l22 x2, one t_I = e^{-z_I} and its
// reciprocal give disc+/-; per maturity one t_r = e^{-B_j z_r} and its
// reciprocal give P+/- = A_j e^{-B_j c_r} t_r^{+/-1} and the centered
// controls y+/- = disc+/- P+/- - P0_j; per strike x+/- = disc+/- (P+/- -
// K_i)^+.  Output rows [count | sy_j | syy_j | sx_ij | sxx_ij | sxy_ij],
// the (i, j) blocks row-major, as the TPU kernel's.
//
// What bounds it on the H100: per pair 1 + nS2 exps and reciprocals and
// about 11 nK nS2 FMA-class operations of payoff and moments (5 x 5: 6 exps,
// 6 reciprocals, ~275 flops), plus one warp shuffle tree per output row per
// warp.  No memory traffic but the partials.
// The surface size is known only at run time, so a thread cannot hold one
// accumulator per row (86 at 5 x 5, 801 at 16 x 16: they would spill).
// Instead each thread keeps its GRID_PER_THREAD pairs' state (z_r, disc+/-)
// in registers and walks the rows in order: for each row it sums its pairs,
// the warp sums the lanes by a shuffle tree and lane 0 writes the warp's
// column of a (rows, warps) shared array; after one barrier each row's
// warps are summed in order into the CTA's partials row, and reduce_kernel
// sums the CTAs in a fixed order.  No float atomics: reruns are bitwise
// identical.
// What this simple design leaves for later work: amortizing the shuffle
// trees over more pairs per thread; fewer partials per call (persistent
// CTAs).

#include <cuda_runtime.h>
#include <stdint.h>

#include "hw_device.cuh"
#include "hw_reduce.cuh"

namespace {

constexpr int PAD = 128;                        // fused.PAD
constexpr int TILE_OPT = 256;                   // fused.TILE_OPT
constexpr int OPT_TILE_ELEMS = TILE_OPT * PAD;  // pairs per option tile
constexpr int MAX_K = 16;                       // fused.GRID_MAX_K
constexpr int MAX_S2 = 16;                      // fused.GRID_MAX_S2

constexpr int GRID_THREADS = 256;
constexpr int GRID_WARPS = GRID_THREADS / 32;
constexpr int GRID_PER_THREAD = 8;
constexpr int GRID_PER_CTA = GRID_THREADS * GRID_PER_THREAD;  // 2048

// fused.GridPrepared: consts [c_r, c_I, l11, l21, l22, A_j.., P0_j..], the
// bond factors B_j and the strikes K_i.
struct GridConsts {
  float c_r, c_i, l11, l21, l22;
  int n_k, n_s2;
  float A[MAX_S2], P0[MAX_S2], B[MAX_S2], K[MAX_K];
};

// Sum of v over the warp's lanes (fixed shuffle tree); lane 0 stores it in
// the warp's column of output row `row`.
__device__ __forceinline__ void warp_row(float v, float* warp_part, int row,
                                         int lane, int warp) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, o);
  if (lane == 0) warp_part[row * GRID_WARPS + warp] = v;
}

__global__ void __launch_bounds__(GRID_THREADS)
grid_exact_kernel(hw::Seeds sd, GridConsts c, float* __restrict__ partials) {
  extern __shared__ float warp_part[];  // (n_rows, GRID_WARPS)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_k = c.n_k, n_s2 = c.n_s2;
  const int cells = n_k * n_s2;
  const int n_rows = 2 * n_s2 + 3 * cells;  // the count is reduce_kernel's
  const float d_base = expf(-c.c_i);

  float z_r[GRID_PER_THREAD], disc_p[GRID_PER_THREAD], disc_m[GRID_PER_THREAD];
#pragma unroll
  for (int e = 0; e < GRID_PER_THREAD; ++e) {
    const long long g = static_cast<long long>(blockIdx.x) * GRID_PER_CTA +
                        e * GRID_THREADS + threadIdx.x;
    const uint32_t tile = sd.s2 + static_cast<uint32_t>(g / OPT_TILE_ELEMS);
    float x1, x2;
    hw::box_muller(hw::tile_seed(sd.s0, tile), sd.s1,
                   static_cast<uint32_t>(g % OPT_TILE_ELEMS), x1, x2);
    z_r[e] = c.l11 * x1;
    const float t_i = expf(-(c.l21 * x1 + c.l22 * x2));
    disc_p[e] = d_base * t_i;
    disc_m[e] = d_base * __frcp_rn(t_i);
  }

  for (int j = 0; j < n_s2; ++j) {
    const float B = c.B[j], P0 = c.P0[j];
    const float P_base = c.A[j] * expf(-B * c.c_r);
    float P_p[GRID_PER_THREAD], P_m[GRID_PER_THREAD];
    float y_p[GRID_PER_THREAD], y_m[GRID_PER_THREAD];
    float sy = 0.0f, syy = 0.0f;
#pragma unroll
    for (int e = 0; e < GRID_PER_THREAD; ++e) {
      const float t_r = expf(-B * z_r[e]);
      P_p[e] = P_base * t_r;
      P_m[e] = P_base * __frcp_rn(t_r);
      y_p[e] = disc_p[e] * P_p[e] - P0;
      y_m[e] = disc_m[e] * P_m[e] - P0;
      sy += y_p[e] + y_m[e];
      syy += y_p[e] * y_p[e] + y_m[e] * y_m[e];
    }
    warp_row(sy, warp_part, j, lane, warp);
    warp_row(syy, warp_part, n_s2 + j, lane, warp);
    for (int i = 0; i < n_k; ++i) {
      const float K = c.K[i];
      float sx = 0.0f, sxx = 0.0f, sxy = 0.0f;
#pragma unroll
      for (int e = 0; e < GRID_PER_THREAD; ++e) {
        const float x_p = disc_p[e] * fmaxf(P_p[e] - K, 0.0f);
        const float x_m = disc_m[e] * fmaxf(P_m[e] - K, 0.0f);
        sx += x_p + x_m;
        sxx += x_p * x_p + x_m * x_m;
        sxy += x_p * y_p[e] + x_m * y_m[e];
      }
      const int cell = 2 * n_s2 + i * n_s2 + j;
      warp_row(sx, warp_part, cell, lane, warp);
      warp_row(sxx, warp_part, cells + cell, lane, warp);
      warp_row(sxy, warp_part, 2 * cells + cell, lane, warp);
    }
  }
  __syncthreads();
  for (int v = threadIdx.x; v < n_rows; v += GRID_THREADS) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < GRID_WARPS; ++w) s += warp_part[v * GRID_WARPS + w];
    partials[static_cast<long long>(blockIdx.x) * n_rows + v] = s;
  }
}

int grid_ctas(int n_tiles) { return n_tiles * (OPT_TILE_ELEMS / GRID_PER_CTA); }

}  // namespace

extern "C" {

// Scratch size (floats) of the partial sums: one row set per CTA.
int hw_grid_partials(int n_tiles, int n_k, int n_s2) {
  return grid_ctas(n_tiles) * (2 * n_s2 + 3 * n_k * n_s2);
}

// out (1 + 2 nS2 + 3 nK nS2): [count | sy | syy | sx | sxx | sxy].
int hw_grid_exact(int32_t s0, int32_t s1, int32_t s2, const float* consts_host,
                  const float* Bs, const float* Ks, int n_k, int n_s2,
                  int n_tiles, float count, float* partials, float* out,
                  void* stream) {
  if (n_tiles < 1 || n_k < 1 || n_k > MAX_K || n_s2 < 1 || n_s2 > MAX_S2)
    return static_cast<int>(cudaErrorInvalidValue);
  GridConsts c;
  c.c_r = consts_host[0]; c.c_i = consts_host[1];
  c.l11 = consts_host[2]; c.l21 = consts_host[3]; c.l22 = consts_host[4];
  c.n_k = n_k; c.n_s2 = n_s2;
  for (int j = 0; j < MAX_S2; ++j) {
    c.A[j] = j < n_s2 ? consts_host[5 + j] : 0.0f;
    c.P0[j] = j < n_s2 ? consts_host[5 + n_s2 + j] : 0.0f;
    c.B[j] = j < n_s2 ? Bs[j] : 0.0f;
  }
  for (int i = 0; i < MAX_K; ++i) c.K[i] = i < n_k ? Ks[i] : 0.0f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_rows = 2 * n_s2 + 3 * n_k * n_s2;
  const int ctas = grid_ctas(n_tiles);
  const size_t smem = sizeof(float) * n_rows * GRID_WARPS;  // <= 25.6 KB
  grid_exact_kernel<<<ctas, GRID_THREADS, smem, st>>>(make_seeds(s0, s1, s2), c, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_kernel<<<n_rows, REDUCE_THREADS, 0, st>>>(partials, ctas, n_rows, nullptr, nullptr, out, 1, count, 0);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
