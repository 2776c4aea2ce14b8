// Shared device helpers of the fused kernels: the counter-hash generator,
// the Box-Muller transform and the full-step raws of
// hullwhite_tpu/pallas/fused.py (_mix, the interpret branch of _tile_rng,
// _bits_float12, _cospi_sinpi, _box_muller, _raw_block), and the option
// payoff tails (_legs_pair, _vega_terms, the tail of _delta_exact_kernel).
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

#include <cuda_bf16.h>
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

// Random word of element idx = row * width + col of one tile, from
// salted = (salt * SALT_MULT) ^ s0: a caller that walks many elements of
// one tile computes it once.
__device__ __forceinline__ uint32_t tile_draw_salted(uint32_t salted, uint32_t s0,
                                                     uint32_t s1, uint32_t idx) {
  uint32_t x = mix32(idx ^ salted);
  x = mix32(x + s1);
  return mix32(x ^ s0);
}

// The same word, the salt word computed here.
__device__ __forceinline__ uint32_t tile_draw(uint32_t s0, uint32_t s1,
                                              uint32_t idx, uint32_t salt) {
  return tile_draw_salted((salt * SALT_MULT) ^ s0, s0, s1, idx);
}

// x rounded to bf16 (round to nearest even) and back: the operand of the
// one bf16 pass that non-"highest" precision stands for.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
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

// Two independent N(0,1) values of an element from its words w0 (draw
// salt 0) and w1 (salt 1).
__device__ __forceinline__ void box_muller_words(uint32_t w0, uint32_t w1,
                                                 float& z0, float& z1) {
  const float u1 = 2.0f - bits_float12(w0);
  const float rad = sqrtf(-2.0f * logf(u1));
  const float x = 2.0f * bits_float12(w1) - 3.0f;
  float c, s;
  cospi_sinpi(x, c, s);
  z0 = rad * c;
  z1 = rad * s;
}

// Two independent N(0,1) values of element idx.
__device__ __forceinline__ void box_muller(uint32_t s0, uint32_t s1,
                                           uint32_t idx, float& z0, float& z1) {
  box_muller_words(tile_draw(s0, s1, idx, 0u), tile_draw(s0, s1, idx, 1u), z0, z1);
}

// The two full-step raws of one random word (_raw_block): each 16-bit
// half is the bf16 v = +/- (1 + m/128) 16^c with sign, 7-bit mantissa m
// and c = b8 & (b9 | b10) of that half; adding c << 9 adds 4 to the
// exponent.  lo is the low half, hi the high half (the bitcast puts them
// in rows 2i and 2i+1).  Exact in float32.  raw_bits is the packed bf16x2
// of the two raws (low half lo, high half hi), a tensor-core operand as it
// stands.
__device__ __forceinline__ uint32_t raw_bits(uint32_t b) {
  const uint32_t base = (b & 0x807F807Fu) | 0x3F803F80u;
  const uint32_t c = ((b >> 8) & ((b >> 9) | (b >> 10))) & 0x00010001u;
  return base + (c << 9);
}

__device__ __forceinline__ void raw_pair(uint32_t b, float& lo, float& hi) {
  const uint32_t bits = raw_bits(b);
  lo = __uint_as_float(bits << 16);
  hi = __uint_as_float(bits & 0xFFFF0000u);
}

// Payoff tails shared by the exact and full-step option kernels.  C is a
// consts struct with the fields of fused._zbc_consts (fused.py:450).

// One antithetic pair of the ZBC control-variate estimator (_legs_pair +
// _moment_accum rows 0-4): both legs share one exp per process,
//   P(+/-) = A e^{-B c_r} t_r^{+/-1},  disc(+/-) = e^{-c_I} t_i^{+/-1},
// with P_base = A e^{-B c_r} and d_base = e^{-c_I}.
template <class C>
__device__ __forceinline__ void zbc_pair_moments(const C& c, float P_base,
                                                 float d_base, float z_r,
                                                 float z_i, float (&s)[5]) {
  const float t_r = expf(-c.B * z_r);
  const float t_i = expf(-z_i);
  float P = P_base * t_r;
  float disc = d_base * t_i;
  const float xa = disc * fmaxf(P - c.K, 0.0f);
  const float ya = disc * P - c.P0S2;
  P = P_base * __frcp_rn(t_r);
  disc = d_base * __frcp_rn(t_i);
  const float xb = disc * fmaxf(P - c.K, 0.0f);
  const float yb = disc * P - c.P0S2;
  s[0] += xa + xb;
  s[1] += ya + yb;
  s[2] += xa * xa + xb * xb;
  s[3] += ya * ya + yb * yb;
  s[4] += xa * ya + xb * yb;
}

// Pathwise delta (d payoff / d r0) of one antithetic pair, both legs from
// one exp per process as in zbc_pair_moments (_delta_exact_kernel):
//   per leg 1{P>K} (-P B dr/dr0) disc - dI/dr0 disc (P - K)^+,
// with C's fields dr_dr0, di_dr0 the host fp64 sensitivities.
template <class C>
__device__ __forceinline__ float delta_pair(const C& c, float P_base,
                                            float d_base, float z_r,
                                            float z_i) {
  const float t_r = expf(-c.B * z_r);
  const float t_i = expf(-z_i);
  float P = P_base * t_r;
  float disc = d_base * t_i;
  const float da = (P > c.K ? -P * c.B * c.dr_dr0 * disc : 0.0f) -
                   c.di_dr0 * disc * fmaxf(P - c.K, 0.0f);
  P = P_base * __frcp_rn(t_r);
  disc = d_base * __frcp_rn(t_i);
  const float db = (P > c.K ? -P * c.B * c.dr_dr0 * disc : 0.0f) -
                   c.di_dr0 * disc * fmaxf(P - c.K, 0.0f);
  return da + db;
}

// Single-leg pathwise vega term (_vega_terms):
//   v = 1{P>K} (-P B (q + dr)) disc - dI disc (P - K)^+,
//   dr = c_dr + z_r / sigma,  dI = c_dI + z_I / sigma.
template <class C>
__device__ __forceinline__ float vega_term(const C& c, float z_r, float z_i) {
  const float r = c.c_r + z_r;
  const float i_r = c.c_i + z_i;
  const float dr = c.c_dr + z_r / c.sigma;
  const float di = c.c_di + z_i / c.sigma;
  const float P = c.A * expf(-c.B * r);
  const float disc = expf(-i_r);
  const float dP = -P * c.B * (c.q + dr);
  const float term1 = P > c.K ? dP * disc : 0.0f;
  const float term2 = di * disc * fmaxf(P - c.K, 0.0f);
  return term1 - term2;
}

}  // namespace hw
