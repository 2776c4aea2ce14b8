// Unit-wall microbenchmarks of the full-step tier for Hopper (sm_90a): the
// raw wall (draw + octave spread), the generator wall (the 3-round murmur3
// counter hash alone) and the integer-ALU wall (the octave op mix held in
// registers).  Plain C interface, loaded with ctypes
// (hullwhite_tpu_torch/kernels/build.py); the Python wrappers in
// hullwhite_tpu_torch/kernels/fused.py allocate every buffer and pass the
// current stream.  The seed triple goes to the kernels by value.
//
// Replaces (hullwhite_tpu/pallas/fused.py):
//   raw_peak_kernel    <- _raw_peak_kernel
//   draw_peak_kernel   <- _draw_peak_kernel
//   bitops_peak_kernel <- _bitops_peak_kernel
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

int peak_ctas(int n_tiles) { return n_tiles * CTAS_PER_TILE; }

// out (2): [checksum, count], the checksum the fixed-order sum of the
// CTAs' partials.
cudaError_t reduce_peak(const float* partials, int n_tiles, float count, float* out,
                        cudaStream_t st) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_kernel<<<1, REDUCE_THREADS, 0, st>>>(partials, peak_ctas(n_tiles), 1, nullptr,
                                              nullptr, out, 0, count, 1);
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
  return static_cast<int>(reduce_peak(partials, n_tiles, count, out, st));
}

// lanes (n_tiles * 4096) uint32: each lane's digest of its row accumulators.
int hw_draw_peak(int32_t s0, int32_t s1, int32_t s2, int nb, int n_tiles, float count,
                 void* lanes, float* partials, float* out, void* stream) {
  if (nb < 1 || n_tiles < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  draw_peak_kernel<<<peak_ctas(n_tiles), PEAK_THREADS, 0, st>>>(
      make_seeds(s0, s1, s2), nb, static_cast<uint32_t*>(lanes), partials);
  return static_cast<int>(reduce_peak(partials, n_tiles, count, out, st));
}

int hw_bitops_peak(int32_t s0, int32_t s1, int32_t s2, int n_tiles, float count, void* lanes,
                   float* partials, float* out, void* stream) {
  if (n_tiles < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bitops_peak_kernel<<<peak_ctas(n_tiles), PEAK_THREADS, 0, st>>>(
      make_seeds(s0, s1, s2), static_cast<uint32_t*>(lanes), partials);
  return static_cast<int>(reduce_peak(partials, n_tiles, count, out, st));
}

}  // extern "C"
