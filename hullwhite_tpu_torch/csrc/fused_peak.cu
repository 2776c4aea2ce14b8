// Unit-wall microbenchmarks for Hopper (sm_90a).  Full-step tier: the raw
// wall (draw + octave spread), the generator wall (the 3-round murmur3
// counter hash alone) and the integer-ALU wall (the octave op mix held in
// registers).  Exact tier: the Box-Muller wall, the exp wall and the
// reciprocal wall (after the full-step walls below).  Plain C interface,
// loaded with ctypes
// (hullwhite_tpu_torch/kernels/build.py); the Python wrappers in
// hullwhite_tpu_torch/kernels/fused.py allocate every buffer and pass the
// current stream.  The seed triple goes to the kernels by value.
//
// Replaces (hullwhite_tpu/pallas/fused.py):
//   raw_peak_kernel    <- _raw_peak_kernel
//   draw_peak_kernel   <- _draw_peak_kernel
//   bitops_peak_kernel <- _bitops_peak_kernel
//   bm_peak_kernel     <- _bm_peak_kernel
//   exp_peak_kernel    <- _exp_peak_kernel
//   recip_peak_kernel  <- _recip_peak_kernel
//
// Geometry is the TPU kernels', which is the full-step option tiers': n_tiles
// tiles of 64 word rows x 4096 lanes; word idx = row * 4096 + lane of global
// tile seed2 + t is hashed under salt q for each of nb blocks (bitops: salt
// 0 only).  One thread per lane, 256 threads, 16 CTAs per tile; the hash
// stays on those logical coordinates, so the CTA shape changes no word.
//
// Consumers.  A wall must spend every word it draws, or nvcc deletes the
// hash and the wall reads too fast:
//   * raw: every raw of a lane goes into the lane's fp32 sum.  (The TPU
//     kernel keeps 8 of each block's 128 bf16 rows, relying on the draw
//     volume being spent anyway; here that would leave 60 of 64 word rows
//     dead.)  Each raw is a multiple of 2^-7 below 32 in magnitude, so a
//     lane's sum of 128 nb raws is exact in fp32 for nb <= 32, in any order;
//   * draw: per word row, the xor of its nb words (the TPU kernel's acc);
//   * bitops: one word per row, then 16 rounds of the octave op mix,
//     xor-accumulated (fused.py:1035-1040).
// Each lane writes one value: raw, its exact sum; draw and bitops, the
// wrapping uint32 sum of its 64 row accumulators (an integer digest that
// changes with any skipped word).  Its checksum term (raw: the sum; draw
// and bitops: sum over rows of int32(acc) * 2^-32 in row order, the TPU
// checksum) goes into the CTA's fixed-order block_sum, and reduce_kernel
// sums the CTAs in order.  No float atomics: reruns are bitwise identical.
//
// What bounds them on the H100: the integer pipes.  A word costs three
// murmur3 rounds (shifts and xors on the ALU pipe, two multiplies per round
// as IMAD on the FMA pipe); the octave spread and the op mix are
// LOP3/SHF/LEA work on the ALU pipe.  Nothing but one value per lane and
// one partial per CTA reaches memory.  Each thread keeps ROWS_IN_FLIGHT
// independent word rows in flight (an unrolled body inside a loop that is
// not unrolled further), so a thread offers that much ILP on top of the
// warps' parallelism, and the loop body is what kernels/sass.py reads to
// count the card's instructions per word.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hw_device.cuh"
#include "hw_reduce.cuh"

namespace {

constexpr int TILE_FULL_OPT = 4096;  // fused.TILE_FULL_OPT: lanes per tile
constexpr int WORD_ROWS = 64;        // fused._MIX_BLOCK / 2: words per lane per block
constexpr int PEAK_THREADS = 256;
constexpr int CTAS_PER_TILE = TILE_FULL_OPT / PEAK_THREADS;  // 16
constexpr int ROWS_IN_FLIGHT = 4;
constexpr int BITOPS_ROUNDS = 16;    // fused._BITOPS_ROUNDS
constexpr float TWO_M32 = 2.3283064365386963e-10f;  // 2^-32

// This thread's tile seed and lane.
__device__ __forceinline__ void lane_of(hw::Seeds sd, uint32_t& s0, uint32_t& lane) {
  const uint32_t tile = sd.s2 + static_cast<uint32_t>(blockIdx.x / CTAS_PER_TILE);
  s0 = hw::tile_seed(sd.s0, tile);
  lane = static_cast<uint32_t>(blockIdx.x % CTAS_PER_TILE) * PEAK_THREADS + threadIdx.x;
}

// The TPU checksum term of one row accumulator: int32(acc) * 2^-32.
__device__ __forceinline__ float checksum_term(uint32_t acc) {
  return static_cast<float>(static_cast<int32_t>(acc)) * TWO_M32;
}

__global__ void __launch_bounds__(PEAK_THREADS)
raw_peak_kernel(hw::Seeds sd, int nb, float* __restrict__ lanes, float* __restrict__ partials) {
  uint32_t s0, lane;
  lane_of(sd, s0, lane);
  float acc[ROWS_IN_FLIGHT];
#pragma unroll
  for (int i = 0; i < ROWS_IN_FLIGHT; ++i) acc[i] = 0.0f;
#pragma unroll 1
  for (int q = 0; q < nb; ++q) {
#pragma unroll 1
    for (int r = 0; r < WORD_ROWS; r += ROWS_IN_FLIGHT) {
#pragma unroll
      for (int i = 0; i < ROWS_IN_FLIGHT; ++i) {
        float lo, hi;
        hw::raw_pair(hw::tile_draw(s0, sd.s1, (r + i) * TILE_FULL_OPT + lane,
                                   static_cast<uint32_t>(q)), lo, hi);
        acc[i] += lo + hi;  // exact: see the header
      }
    }
  }
  float v[1] = {(acc[0] + acc[1]) + (acc[2] + acc[3])};
  lanes[blockIdx.x * PEAK_THREADS + threadIdx.x] = v[0];
  block_sum<1, PEAK_THREADS>(v, partials + blockIdx.x);
}

__global__ void __launch_bounds__(PEAK_THREADS)
draw_peak_kernel(hw::Seeds sd, int nb, uint32_t* __restrict__ lanes,
                 float* __restrict__ partials) {
  uint32_t s0, lane;
  lane_of(sd, s0, lane);
  uint32_t digest = 0u;
  float v[1] = {0.0f};
#pragma unroll 1
  for (int r = 0; r < WORD_ROWS; r += ROWS_IN_FLIGHT) {
    uint32_t acc[ROWS_IN_FLIGHT];
#pragma unroll
    for (int i = 0; i < ROWS_IN_FLIGHT; ++i) acc[i] = 0u;
#pragma unroll 1
    for (int q = 0; q < nb; ++q) {
#pragma unroll
      for (int i = 0; i < ROWS_IN_FLIGHT; ++i)
        acc[i] ^= hw::tile_draw(s0, sd.s1, (r + i) * TILE_FULL_OPT + lane,
                                static_cast<uint32_t>(q));
    }
#pragma unroll
    for (int i = 0; i < ROWS_IN_FLIGHT; ++i) {  // rows in order
      digest += acc[i];
      v[0] += checksum_term(acc[i]);
    }
  }
  lanes[blockIdx.x * PEAK_THREADS + threadIdx.x] = digest;
  block_sum<1, PEAK_THREADS>(v, partials + blockIdx.x);
}

__global__ void __launch_bounds__(PEAK_THREADS)
bitops_peak_kernel(hw::Seeds sd, uint32_t* __restrict__ lanes, float* __restrict__ partials) {
  uint32_t s0, lane;
  lane_of(sd, s0, lane);
  uint32_t digest = 0u;
  float v[1] = {0.0f};
#pragma unroll 1
  for (int r = 0; r < WORD_ROWS; r += ROWS_IN_FLIGHT) {
    uint32_t x[ROWS_IN_FLIGHT], acc[ROWS_IN_FLIGHT];
#pragma unroll
    for (int i = 0; i < ROWS_IN_FLIGHT; ++i) {
      x[i] = hw::tile_draw(s0, sd.s1, (r + i) * TILE_FULL_OPT + lane, 0u);
      acc[i] = 0u;
    }
#pragma unroll
    for (int k = 0; k < BITOPS_ROUNDS; ++k) {
#pragma unroll
      for (int i = 0; i < ROWS_IN_FLIGHT; ++i) {
        const uint32_t base = (x[i] & 0x807F807Fu) | 0x3F803F80u;
        const uint32_t c = ((x[i] >> 8) & ((x[i] >> 9) | (x[i] >> 10))) & 0x00010001u;
        const uint32_t w = base + (c << 9);
        acc[i] ^= w;
        x[i] = w ^ (x[i] >> 1);
      }
    }
#pragma unroll
    for (int i = 0; i < ROWS_IN_FLIGHT; ++i) {  // rows in order
      digest += acc[i];
      v[0] += checksum_term(acc[i]);
    }
  }
  lanes[blockIdx.x * PEAK_THREADS + threadIdx.x] = digest;
  block_sum<1, PEAK_THREADS>(v, partials + blockIdx.x);
}

// ---------------------------------------------------------------------------
// Exact-tier walls.  The device math is the tiers' own, so a wall measures
// what the tiers execute: hw::box_muller (logf, sqrtf and the degree-5
// polynomials), expf (not __expf) and __frcp_rn, which the payoff tails use;
// the build has no --use_fast_math.
//
// Box-Muller wall: a tile is the exact curve tile, (TILE_EXACT, PAD)
// elements, element idx = row * PAD + col hashed under salts 0 and 1.  A
// lane is BM_LANE_ROWS rows of one column; it sums z0 + z1 of its elements,
// so a dropped element moves its lane by |z0 + z1| (mean ~1.13).  Lanes are
// row-major per tile (lane = (row / BM_LANE_ROWS) * PAD + col), one thread
// each, BM_IN_FLIGHT elements in flight (the TPU kernel's consumer sums
// whole columns; its checksum, the sum of all lanes, is the same number).
// Bound on the H100: the two words' hash on the integer pipes (ALU), then
// the log and sqrt on the MUFU.
//
// exp and recip walls: a tile is an exact option tile, (TILE_OPT, PAD)
// lanes; lane idx starts from x0 = [1, 2) float of its word (salt 0) minus
// 1 and runs CHAIN_ROUNDS chained x <- e^{-x} or x <- 1/(x + 1).  Each chain
// is serial, so each thread keeps CHAINS_IN_FLIGHT lanes in flight (lanes
// base + i * CHAIN_THREADS + tid, coalesced per i) on top of the warps'
// parallelism.  Bound: the MUFU (one EX2 or RCP per round, 16 per clock per
// SM); a lane writes its final x.
//
// Each innermost loop (elements for BM, rounds for the chains) is what
// kernels/sass.py reads to count the card's instructions per Box-Muller
// element, per exp and per reciprocal.
// ---------------------------------------------------------------------------

constexpr int PAD = 128;             // fused.PAD
constexpr int TILE_EXACT = 4096;     // fused.TILE_EXACT: BM rows per tile
constexpr int TILE_OPT = 256;        // fused.TILE_OPT: chain lane rows per tile
constexpr int BM_LANE_ROWS = 32;     // fused.BM_LANE_ROWS
constexpr int BM_THREADS = 256;
constexpr int BM_IN_FLIGHT = 4;
constexpr int BM_TILE_LANES = TILE_EXACT / BM_LANE_ROWS * PAD;  // 16384
constexpr int BM_CTAS_PER_TILE = BM_TILE_LANES / BM_THREADS;    // 64
constexpr int CHAIN_ROUNDS = 32;     // fused.CHAIN_ROUNDS (fused.py:1108)
constexpr int CHAIN_THREADS = 256;
constexpr int CHAINS_IN_FLIGHT = 4;
constexpr int CHAIN_TILE_LANES = TILE_OPT * PAD;  // 32768
constexpr int CHAIN_CTA_LANES = CHAIN_THREADS * CHAINS_IN_FLIGHT;
constexpr int CHAIN_CTAS_PER_TILE = CHAIN_TILE_LANES / CHAIN_CTA_LANES;  // 32
static_assert(BM_IN_FLIGHT == 4 && BM_LANE_ROWS % BM_IN_FLIGHT == 0,
              "bm_peak_kernel folds four accumulators");

__global__ void __launch_bounds__(BM_THREADS)
bm_peak_kernel(hw::Seeds sd, float* __restrict__ lanes, float* __restrict__ partials) {
  const uint32_t tile = sd.s2 + static_cast<uint32_t>(blockIdx.x / BM_CTAS_PER_TILE);
  const uint32_t s0 = hw::tile_seed(sd.s0, tile);
  const uint32_t lane = static_cast<uint32_t>(blockIdx.x % BM_CTAS_PER_TILE) * BM_THREADS +
                        threadIdx.x;
  const uint32_t col = lane % PAD;
  const uint32_t row0 = (lane / PAD) * BM_LANE_ROWS;
  float acc[BM_IN_FLIGHT];
#pragma unroll
  for (int i = 0; i < BM_IN_FLIGHT; ++i) acc[i] = 0.0f;
#pragma unroll 1
  for (int r = 0; r < BM_LANE_ROWS; r += BM_IN_FLIGHT) {
#pragma unroll
    for (int i = 0; i < BM_IN_FLIGHT; ++i) {
      float z0, z1;
      hw::box_muller(s0, sd.s1, (row0 + r + i) * PAD + col, z0, z1);
      acc[i] += z0 + z1;
    }
  }
  float v[1] = {(acc[0] + acc[1]) + (acc[2] + acc[3])};
  lanes[static_cast<long long>(blockIdx.x) * BM_THREADS + threadIdx.x] = v[0];
  block_sum<1, BM_THREADS>(v, partials + blockIdx.x);
}

// One CTA's CHAIN_CTA_LANES chains: x0 from the lane's word, then
// CHAIN_ROUNDS steps of x <- e^{-x} (RECIP false) or x <- 1/(x + 1).
template <bool RECIP>
__device__ __forceinline__ void chain_lanes(hw::Seeds sd, float* __restrict__ lanes,
                                            float* __restrict__ partials) {
  const uint32_t tile = sd.s2 + static_cast<uint32_t>(blockIdx.x / CHAIN_CTAS_PER_TILE);
  const uint32_t s0 = hw::tile_seed(sd.s0, tile);
  const uint32_t base = static_cast<uint32_t>(blockIdx.x % CHAIN_CTAS_PER_TILE) *
                        CHAIN_CTA_LANES + threadIdx.x;
  float x[CHAINS_IN_FLIGHT];
#pragma unroll
  for (int i = 0; i < CHAINS_IN_FLIGHT; ++i)
    x[i] = hw::bits_float12(hw::tile_draw(s0, sd.s1, base + i * CHAIN_THREADS, 0u)) - 1.0f;
#pragma unroll 1
  for (int k = 0; k < CHAIN_ROUNDS; ++k) {
#pragma unroll
    for (int i = 0; i < CHAINS_IN_FLIGHT; ++i)
      x[i] = RECIP ? __frcp_rn(x[i] + 1.0f) : expf(-x[i]);
  }
  float* out = lanes + static_cast<long long>(blockIdx.x / CHAIN_CTAS_PER_TILE) *
                           CHAIN_TILE_LANES + base;
  float v[1] = {0.0f};
#pragma unroll
  for (int i = 0; i < CHAINS_IN_FLIGHT; ++i) {  // lanes in order
    out[i * CHAIN_THREADS] = x[i];
    v[0] += x[i];
  }
  block_sum<1, CHAIN_THREADS>(v, partials + blockIdx.x);
}

__global__ void __launch_bounds__(CHAIN_THREADS)
exp_peak_kernel(hw::Seeds sd, float* __restrict__ lanes, float* __restrict__ partials) {
  chain_lanes<false>(sd, lanes, partials);
}

__global__ void __launch_bounds__(CHAIN_THREADS)
recip_peak_kernel(hw::Seeds sd, float* __restrict__ lanes, float* __restrict__ partials) {
  chain_lanes<true>(sd, lanes, partials);
}

int peak_ctas(int n_tiles) { return n_tiles * CTAS_PER_TILE; }
int bm_ctas(int n_tiles) { return n_tiles * BM_CTAS_PER_TILE; }
int chain_ctas(int n_tiles) { return n_tiles * CHAIN_CTAS_PER_TILE; }

// out (2): [checksum, count], the checksum the fixed-order sum of the
// n_ctas CTAs' partials.
cudaError_t reduce_peak(const float* partials, int n_ctas, float count, float* out,
                        cudaStream_t st) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_kernel<<<1, REDUCE_THREADS, 0, st>>>(partials, n_ctas, 1, nullptr, nullptr, out, 0,
                                              count, 1);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Scratch size (floats) the wrappers allocate for the partial sums.
int hw_peak_partials(int n_tiles) { return peak_ctas(n_tiles); }

// lanes (n_tiles * 4096) float: each lane's exact sum of its 128 nb raws.
int hw_raw_peak(int32_t s0, int32_t s1, int32_t s2, int nb, int n_tiles, float count,
                float* lanes, float* partials, float* out, void* stream) {
  if (nb < 1 || nb > 32 || n_tiles < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  raw_peak_kernel<<<peak_ctas(n_tiles), PEAK_THREADS, 0, st>>>(make_seeds(s0, s1, s2), nb,
                                                                lanes, partials);
  return static_cast<int>(reduce_peak(partials, peak_ctas(n_tiles), count, out, st));
}

// lanes (n_tiles * 4096) uint32: each lane's digest of its row accumulators.
int hw_draw_peak(int32_t s0, int32_t s1, int32_t s2, int nb, int n_tiles, float count,
                 void* lanes, float* partials, float* out, void* stream) {
  if (nb < 1 || n_tiles < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  draw_peak_kernel<<<peak_ctas(n_tiles), PEAK_THREADS, 0, st>>>(
      make_seeds(s0, s1, s2), nb, static_cast<uint32_t*>(lanes), partials);
  return static_cast<int>(reduce_peak(partials, peak_ctas(n_tiles), count, out, st));
}

int hw_bitops_peak(int32_t s0, int32_t s1, int32_t s2, int n_tiles, float count, void* lanes,
                   float* partials, float* out, void* stream) {
  if (n_tiles < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bitops_peak_kernel<<<peak_ctas(n_tiles), PEAK_THREADS, 0, st>>>(
      make_seeds(s0, s1, s2), static_cast<uint32_t*>(lanes), partials);
  return static_cast<int>(reduce_peak(partials, peak_ctas(n_tiles), count, out, st));
}

// Scratch sizes (floats) of the exact-tier walls' partial sums.
int hw_bm_peak_partials(int n_tiles) { return bm_ctas(n_tiles); }
int hw_exp_peak_partials(int n_tiles) { return chain_ctas(n_tiles); }
int hw_recip_peak_partials(int n_tiles) { return chain_ctas(n_tiles); }

// lanes (n_tiles * 16384) float: each lane's sum of z0 + z1 over its rows.
int hw_bm_peak(int32_t s0, int32_t s1, int32_t s2, int n_tiles, float count, float* lanes,
               float* partials, float* out, void* stream) {
  if (n_tiles < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bm_peak_kernel<<<bm_ctas(n_tiles), BM_THREADS, 0, st>>>(make_seeds(s0, s1, s2), lanes,
                                                           partials);
  return static_cast<int>(reduce_peak(partials, bm_ctas(n_tiles), count, out, st));
}

// lanes (n_tiles * 32768) float: each chain's final x.
int hw_exp_peak(int32_t s0, int32_t s1, int32_t s2, int n_tiles, float count, float* lanes,
                float* partials, float* out, void* stream) {
  if (n_tiles < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  exp_peak_kernel<<<chain_ctas(n_tiles), CHAIN_THREADS, 0, st>>>(make_seeds(s0, s1, s2),
                                                                  lanes, partials);
  return static_cast<int>(reduce_peak(partials, chain_ctas(n_tiles), count, out, st));
}

int hw_recip_peak(int32_t s0, int32_t s1, int32_t s2, int n_tiles, float count, float* lanes,
                  float* partials, float* out, void* stream) {
  if (n_tiles < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  recip_peak_kernel<<<chain_ctas(n_tiles), CHAIN_THREADS, 0, st>>>(make_seeds(s0, s1, s2),
                                                                    lanes, partials);
  return static_cast<int>(reduce_peak(partials, chain_ctas(n_tiles), count, out, st));
}

}  // extern "C"
