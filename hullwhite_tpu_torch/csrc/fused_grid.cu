// Option-surface kernel for Hopper (sm_90a): the control-variate moments of
// an nK x nS2 surface of European calls on P(S1, S2_j) with strikes K_i,
// every cell from the same exact-sampled state per antithetic pair.  Plain
// C interface, loaded with ctypes (hullwhite_tpu_torch/kernels/build.py);
// the wrapper fused.grid_exact allocates every buffer and passes the
// current stream and the stream's ticket.  The seeds and every const (at
// most MAX_K strikes and MAX_S2 maturities) go to the kernel by value: a
// launch copies nothing to the card.
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
// about 10 nK nS2 FMA-class operations of payoff and moments (5 x 5: 6
// exps, 6 reciprocals, ~295 flops: roofline.work), no memory traffic but
// the partials.  Besides the draw, the loop issues ~110 instructions per
// pair and maturity at 5 x 5 (SASS: 12 a cell, the exp, the reciprocal and
// its slow-path branch, the cross-lane sums), so the card's issue rate is
// the wall it meets; the design spends as few issue slots as it can on
// anything but the function.
//   * The whole card in one wave: persistent CTAs of CTA_THREADS threads
//     (BIG_NK_THREADS above BIG_NK strikes), as many as the occupancy
//     query fits (one of 1024 threads at 64 registers per SM on the H100)
//     and at most one per unit.  The warps walk units of 32 x PAIRS
//     pairs that lie inside one option tile: unit u holds elements
//     (u % UNITS_PER_TILE) UNIT + e 32 + lane, e < PAIRS, of tile s2 +
//     u / UNITS_PER_TILE; warp w of CTA b takes units b + w gridDim.x,
//     then every gridDim.x warps-per-CTA on, so a small call spreads over
//     the SMs (at 2^15 pairs one warp on each of 128) and a large one
//     fills every warp slot.  Per unit the tile seed and the salt words are
//     computed once and the element index is a 32-bit add.
//   * Row sums kept over the whole walk: the surface's size is known only
//     at run time (86 rows at 5 x 5, 801 at 16 x 16), so each warp keeps
//     one running sum per row in shared memory, (warps, nS2 (2 + 3 nK))
//     floats, maturity-major (51 KB at 16 x 16).  A thread draws its
//     PAIRS pairs; per maturity it keeps the maturity's 2 + 3 nK rows
//     in registers (one kernel instance per nK) as running sums from 0
//     over its pairs in order, leg + then leg - of each, the squares and
//     products fused into the add (fmaf: 12 instructions a cell where
//     summing the legs first took 14), then the warp sums the lanes by a
//     transposed reduce-scatter: butterflies over blocks of 2^M rows, a
//     lane keeping half of its rows at each of M steps, the rest a shuffle
//     tree; 31 shuffles per 32 rows where 32 trees take 160 (a tree per
//     row was slower).  It pairs lanes by xor offsets 16, 8, 4, 2, 1
//     in that order, so its sums equal a shuffle tree's bit for bit; the
//     lane that ends with a row's sum adds it to the warp's running sum.
//   * One launch: at its end a CTA sums its warps in order into its partial
//     rows (in output order); the CTA that takes the last ticket sums every
//     CTA's partials in a fixed order (last_cta_rows, hw_reduce.cuh) and
//     puts the ticket back to 0.  No float atomics: reruns are bitwise
//     identical.
// PERF.md section 6 gives the other layouts timed (CTA_THREADS and PAIRS
// below, a shuffle tree per row) and why this one was kept.

#include <cuda_runtime.h>
#include <stdint.h>

#include <array>
#include <utility>

#include "hw_device.cuh"
#include "hw_reduce.cuh"

namespace {

constexpr int PAD = 128;                        // fused.PAD
constexpr int TILE_OPT = 256;                   // fused.TILE_OPT
constexpr int OPT_TILE_ELEMS = TILE_OPT * PAD;  // pairs per option tile
constexpr int MAX_K = 16;                       // fused.GRID_MAX_K
constexpr int MAX_S2 = 16;                      // fused.GRID_MAX_S2

constexpr int CTA_THREADS = 1024;  // per CTA, up to BIG_NK strikes
constexpr int PAIRS = 8;           // per thread and unit
constexpr int UNIT = 32 * PAIRS;   // pairs of a warp's unit
constexpr int UNITS_PER_TILE = OPT_TILE_ELEMS / UNIT;
static_assert(OPT_TILE_ELEMS % UNIT == 0, "a unit lies inside one tile");
// Above BIG_NK strikes a maturity's 2 + 3 nK row sums and the pairs' state
// outgrow the 64 registers a thread of a 1024-thread CTA has (6 to 16
// strikes spilled): those instances take CTAs of at most BIG_NK_THREADS.
constexpr int BIG_NK = 5;
constexpr int BIG_NK_THREADS = 512;
constexpr unsigned int FULL = 0xFFFFFFFFu;

// The geometry of the instance of NK strikes.
template <int NK>
struct GridGeometry {
  static constexpr int threads = NK > BIG_NK ? BIG_NK_THREADS : CTA_THREADS;
  static constexpr int warps = threads / 32;
  static_assert(threads % 32 == 0 && threads <= 1024, "whole warps");
};

// fused.GridPrepared: consts [c_r, c_i, l11, l21, l22, A_j.., P0_j..], the
// bond factors B_j and the strikes K_i.
struct GridConsts {
  float c_r, c_i, l11, l21, l22;
  int n_k, n_s2;
  float A[MAX_S2], P0[MAX_S2], B[MAX_S2], K[MAX_K];
};

// Output row (count excluded) of slot s of maturity j: slots 0 and 1 are
// sy_j and syy_j, slots 2 + 3 i .. 4 + 3 i sx_ij, sxx_ij and sxy_ij.
__device__ __forceinline__ int out_row(int j, int s, int n_k, int n_s2) {
  if (s < 2) return s * n_s2 + j;
  const int i = (s - 2) / 3, m = (s - 2) % 3;
  return (2 + m * n_k) * n_s2 + i * n_s2 + j;
}

// The row of a block of 2^M rows whose warp sum lane `lane` holds after
// scatter<M>: row bit k - 1 is lane bit 5 - k.
template <int M>
__device__ __forceinline__ int scatter_row(int lane) {
  int r = 0;
#pragma unroll
  for (int k = 1; k <= M; ++k) r |= ((lane >> (5 - k)) & 1) << (k - 1);
  return r;
}

// Reduce-scatter of rows ROW0 .. ROW0 + 2^M - 1 of v over the warp: step k
// (xor offset 32 >> k) pairs the halves of each block of 2^k rows, a lane
// keeps the half its bit 5 - k names and adds its partner's value of it.
// Lane l returns row ROW0 + scatter_row<M>(l) summed over the 2^M lanes
// that differ from l in bits 5 - M .. 4 only.
template <int M, int ROW0, int N>
__device__ __forceinline__ float scatter(const float (&v)[N], int lane) {
  if constexpr (M == 0) {
    return v[ROW0];
  } else {
    constexpr int o = 32 >> M;
    const float a = scatter<M - 1, ROW0>(v, lane);
    const float b = scatter<M - 1, ROW0 + (1 << (M - 1))>(v, lane);
    const bool hi = (lane & o) != 0;
    return (hi ? b : a) + __shfl_xor_sync(FULL, hi ? a : b, o);
  }
}

// Adds the warp sums of rows ROW0 .. ROW0 + LEFT - 1 of v to acc: blocks
// of the largest power of two left (at most 32 rows), each a
// reduce-scatter and a shuffle tree over the remaining offsets; the lanes
// with the remaining offsets' bits 0 add.
template <int ROW0, int LEFT, int N>
__device__ __forceinline__ void add_rows(const float (&v)[N], float* acc, int lane) {
  if constexpr (LEFT > 0) {
    constexpr int M = LEFT >= 32 ? 5 : LEFT >= 16 ? 4 : LEFT >= 8 ? 3 : LEFT >= 4 ? 2 : LEFT >= 2 ? 1 : 0;
    float s = scatter<M, ROW0>(v, lane);
#pragma unroll
    for (int o = 16 >> M; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
    if ((lane & ((32 >> M) - 1)) == 0) acc[ROW0 + scatter_row<M>(lane)] += s;
    add_rows<ROW0 + (1 << M), LEFT - (1 << M)>(v, acc, lane);
  }
}

// One CTA per SM is asked for: the register cap is then 65536 / threads (64
// at 1024 threads, 128 at 512); without it ptxas held the 6-strike
// instance to 64 registers and spilled.
template <int NK>
__global__ void __launch_bounds__(GridGeometry<NK>::threads, 1)
grid_exact_kernel(hw::Seeds sd, GridConsts c, uint32_t n_units, float count,
                  float* __restrict__ partials, unsigned int* ticket, float* __restrict__ out) {
  using G = GridGeometry<NK>;
  constexpr int THREADS = G::threads, WARPS = G::warps;
  constexpr int R = 2 + 3 * NK;  // rows of one maturity
  extern __shared__ float acc[];  // (WARPS, n_s2 R): the warps' running sums
  __shared__ float p_base[MAX_S2];
  const int n_s2 = c.n_s2, rows = n_s2 * R;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int v = threadIdx.x; v < WARPS * rows; v += THREADS) acc[v] = 0.0f;
  if (threadIdx.x < n_s2)
    p_base[threadIdx.x] = c.A[threadIdx.x] * expf(-c.B[threadIdx.x] * c.c_r);
  __syncthreads();
  const float d_base = expf(-c.c_i);
  float* wacc = acc + warp * rows;

  for (uint32_t u = blockIdx.x + gridDim.x * warp; u < n_units; u += gridDim.x * WARPS) {
    const uint32_t s0 = hw::tile_seed(sd.s0, sd.s2 + u / UNITS_PER_TILE);
    const uint32_t salted1 = hw::SALT_MULT ^ s0;  // salt 0's word is s0 itself
    const uint32_t idx = (u % UNITS_PER_TILE) * UNIT + lane;
    float z_r[PAIRS], disc_p[PAIRS], disc_m[PAIRS];
#pragma unroll
    for (int e = 0; e < PAIRS; ++e) {
      const uint32_t el = idx + e * 32;
      float x1, x2;
      hw::box_muller_words(hw::tile_draw_salted(s0, s0, sd.s1, el),
                           hw::tile_draw_salted(salted1, s0, sd.s1, el), x1, x2);
      z_r[e] = c.l11 * x1;
      const float t_i = expf(-(c.l21 * x1 + c.l22 * x2));
      disc_p[e] = d_base * t_i;
      disc_m[e] = d_base * __frcp_rn(t_i);
    }
    for (int j = 0; j < n_s2; ++j) {
      const float B = c.B[j], P0 = c.P0[j], P_base = p_base[j];
      float v[R];  // this thread's sums of the maturity's rows over its pairs
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] = 0.0f;
#pragma unroll
      for (int e = 0; e < PAIRS; ++e) {
        const float t_r = expf(-B * z_r[e]);
        const float P_p = P_base * t_r, P_m = P_base * __frcp_rn(t_r);
        const float y_p = disc_p[e] * P_p - P0, y_m = disc_m[e] * P_m - P0;
        v[0] += y_p;
        v[0] += y_m;
        v[1] = fmaf(y_p, y_p, v[1]);
        v[1] = fmaf(y_m, y_m, v[1]);
#pragma unroll
        for (int i = 0; i < NK; ++i) {
          const float x_p = disc_p[e] * fmaxf(P_p - c.K[i], 0.0f);
          const float x_m = disc_m[e] * fmaxf(P_m - c.K[i], 0.0f);
          v[2 + 3 * i] += x_p;
          v[2 + 3 * i] += x_m;
          v[3 + 3 * i] = fmaf(x_p, x_p, v[3 + 3 * i]);
          v[3 + 3 * i] = fmaf(x_m, x_m, v[3 + 3 * i]);
          v[4 + 3 * i] = fmaf(x_p, y_p, v[4 + 3 * i]);
          v[4 + 3 * i] = fmaf(x_m, y_m, v[4 + 3 * i]);
        }
      }
      add_rows<0, R>(v, wacc + j * R, lane);
    }
  }

  // the warps in order into this CTA's partial rows, in output order
  __syncthreads();
  for (int v = threadIdx.x; v < rows; v += THREADS) {
    float s = acc[v];
    for (int w = 1; w < WARPS; ++w) s += acc[w * rows + v];
    partials[static_cast<size_t>(blockIdx.x) * rows + out_row(v / R, v % R, NK, n_s2)] = s;
  }
  last_cta_rows<THREADS>(partials, rows, ticket, count, out, acc);
}

// A kernel instance and its threads per CTA.
struct GridInstance {
  void (*kernel)(hw::Seeds, GridConsts, uint32_t, float, float*, unsigned int*, float*);
  int threads;
};

template <int... I>
std::array<GridInstance, sizeof...(I)> grid_instances(std::integer_sequence<int, I...>) {
  return {{{grid_exact_kernel<I + 1>, GridGeometry<I + 1>::threads}...}};
}

// The kernel instance of n_k strikes.
GridInstance grid_instance(int n_k) {
  static const auto table = grid_instances(std::make_integer_sequence<int, MAX_K>{});
  return table[n_k - 1];
}

// Bytes of the warps' running sums (dynamic shared memory).
int grid_smem(const GridInstance& inst, int n_k, int n_s2) {
  return static_cast<int>(sizeof(float)) * (inst.threads / 32) * n_s2 * (2 + 3 * n_k);
}

// Units of a walk over n_tiles option tiles.
long long grid_units(int n_tiles) { return static_cast<long long>(n_tiles) * UNITS_PER_TILE; }

// The persistent grid for the wrappers' arguments (persistent_ctas, at
// the surface's shared memory: above 48 KB from 16 x 16 at 512 threads),
// at most one CTA per unit.
cudaError_t grid_ctas(int n_tiles, int n_k, int n_s2, GridInstance* inst, int* ctas) {
  if (n_tiles < 1 || n_tiles > (1 << 24) || n_k < 1 || n_k > MAX_K || n_s2 < 1 ||
      n_s2 > MAX_S2)
    return cudaErrorInvalidValue;
  *inst = grid_instance(n_k);
  return persistent_ctas(inst->kernel, inst->threads, grid_smem(*inst, n_k, n_s2),
                         grid_units(n_tiles), ctas);
}

}  // namespace

extern "C" {

// Scratch size (floats) of the partial sums, one row set per CTA of the
// persistent grid, or minus a CUDA error code if the grid query fails.
int hw_grid_partials(int n_tiles, int n_k, int n_s2) {
  GridInstance inst;
  int ctas = 0;
  const cudaError_t err = grid_ctas(n_tiles, n_k, n_s2, &inst, &ctas);
  return err == cudaSuccess ? ctas * n_s2 * (2 + 3 * n_k) : -static_cast<int>(err);
}

// out (1 + 2 nS2 + 3 nK nS2): [count | sy | syy | sx | sxx | sxy];
// partials holds n_partials floats (hw_grid_partials), ticket one zeroed
// uint32 of the stream's own.
int hw_grid_exact(int32_t s0, int32_t s1, int32_t s2, const float* consts_host,
                  const float* Bs, const float* Ks, int n_k, int n_s2,
                  int n_tiles, float count, float* partials, int n_partials,
                  void* ticket, float* out, void* stream) {
  GridInstance inst;
  int ctas = 0;
  const cudaError_t err = grid_ctas(n_tiles, n_k, n_s2, &inst, &ctas);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_partials < ctas * n_s2 * (2 + 3 * n_k) || ticket == nullptr)
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
  const auto kernel = inst.kernel;
  kernel<<<ctas, inst.threads, grid_smem(inst, n_k, n_s2), static_cast<cudaStream_t>(stream)>>>(
      make_seeds(s0, s1, s2), c, static_cast<uint32_t>(grid_units(n_tiles)), count,
      partials, static_cast<unsigned int*>(ticket), out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
