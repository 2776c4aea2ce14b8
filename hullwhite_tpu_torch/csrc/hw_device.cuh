// Shared device helpers of the exact-sampling kernels: the counter-hash
// generator and the Box-Muller transform of hullwhite_tpu/pallas/fused.py
// (_mix, the interpret branch of _tile_rng, _bits_float12, _cospi_sinpi,
// _box_muller).
//
// Every random word is a pure function of (seeds, global tile, row, col,
// salt): elements are hashed by the JAX kernels' logical coordinates, never
// by blockIdx/threadIdx, so launch geometry does not change the stream and
// the normals equal the JAX package's CPU (interpret-mode) stream up to the
// rounding of logf/sqrtf and the polynomials.
//
// No fast-math: logf, sqrtf, expf are the full-precision library calls and
// reciprocals are IEEE round-to-nearest (pl.reciprocal(approx=False)).
#pragma once

#include <stdint.h>

namespace hw {

constexpr uint32_t SEED_STRIDE = 1000003u;  // fused.SEED_STRIDE
constexpr uint32_t SALT_MULT = 0x9E3779B9u;

// A key's seed triple (ops.rng.key_seed), passed to the kernels by value.
struct Seeds {
  uint32_t s0, s1, s2;
};

// murmur3 finalizer: a bijective 32-bit avalanche mix.
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// s0 = seed0 + (seed2 + tile) * SEED_STRIDE.  The TPU kernel computes it in
// int32 and casts to uint32; uint32 arithmetic wraps identically.
__device__ __forceinline__ uint32_t tile_seed(uint32_t seed0, uint32_t tile) {
  return seed0 + tile * SEED_STRIDE;
}

// Random word of element idx = row * width + col of one tile.
__device__ __forceinline__ uint32_t tile_draw(uint32_t s0, uint32_t s1,
                                              uint32_t idx, uint32_t salt) {
  uint32_t x = mix32(idx ^ (salt * SALT_MULT) ^ s0);
  x = mix32(x + s1);
  return mix32(x ^ s0);
}

// [1, 2) float from the top 23 of 32 random bits (mantissa trick).
__device__ __forceinline__ float bits_float12(uint32_t b) {
  return __uint_as_float((b >> 9) | 0x3F800000u);
}

// (cos(pi x), sin(pi x)) for x in [-1, 1): degree-5 Chebyshev fits in
// y = x^2 (fused._COS5 / fused._SIN5, rounded to float32).
__device__ __forceinline__ void cospi_sinpi(float x, float& c, float& s) {
  const float y = x * x;
  c = -0.020577251866763305f;
  c = c * y + 0.22965036551851092f;
  c = c * y + -1.3323690970594237f;
  c = c * y + 4.0580410955948345f;
  c = c * y + -4.934745090535487f;
  c = c * y + 0.9999992108812327f;
  s = -0.006089474441873218f;
  s = s * y + 0.08074781848280516f;
  s = s * y + -0.5985505692547316f;
  s = s * y + 2.5499982307289915f;
  s = s * y + -5.167698654480206f;
  s = s * y + 3.1415924582721866f;
  s = s * x;
}

// Two independent N(0,1) values of element idx (draw salts 0 and 1).
__device__ __forceinline__ void box_muller(uint32_t s0, uint32_t s1,
                                           uint32_t idx, float& z0, float& z1) {
  const float u1 = 2.0f - bits_float12(tile_draw(s0, s1, idx, 0u));
  const float rad = sqrtf(-2.0f * logf(u1));
  const float x = 2.0f * bits_float12(tile_draw(s0, s1, idx, 1u)) - 3.0f;
  float c, s;
  cospi_sinpi(x, c, s);
  z0 = rad * c;
  z1 = rad * s;
}

}  // namespace hw
