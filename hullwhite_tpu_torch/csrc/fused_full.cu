// Full-step Monte Carlo kernels for Hopper (sm_90a): Q1 curve sums, Q2b
// ZBC control-variate moments and Q3 pathwise vega with one fresh random
// value per path per time step over all n_steps.  Plain C interface,
// loaded with ctypes (hullwhite_tpu_torch/kernels/build.py); the Python
// wrappers in hullwhite_tpu_torch/kernels/fused.py allocate every buffer
// and pass the current stream.  The seed triple and the 10 option consts
// go to the kernels by value.
//
// Replaces (hullwhite_tpu/pallas/fused.py):
//   curve_full_kernel <- _curve_kernel (:320, Q1 full step)
//   zbc_full_kernel   <- _zbc_full_kernel + _legs_pair + _moment_accum
//   vega_full_kernel  <- _vega_full_kernel + _vega_terms
//
// The generator is _raw_block behind the interpret-mode _tile_rng: per
// 128-step block q (the draw salt) each u32 word gives two exact bf16 raws
// (hw::raw_bits).  The Hadamard mix is pre-folded into the weights on the
// host, so each kernel runs one product per block on the raws:
//   curve:   z (paths, 128 maturities) += U_q (paths, 128 steps) @ W_q;
//            word i * 128 + k of block q holds steps k of paths 2i (low
//            half) and 2i + 1 (high half);
//   options: (z_r, z_i) = rows 0 and 1 of sum_q W_q (2, 128) @ U_q;
//            word j * 4096 + p holds steps 2j (low) and 2j + 1 (high) of
//            path p.
// Each CTA writes partial sums that reduce_kernel (hw_reduce.cuh) sums in
// a fixed order: no float atomics, so reruns are bitwise identical.
//
// curve_full: the product on the tensor cores, the hash on the ALU pipe.
//   * Bound: the hash.  At 2^20 paths the kernel hashes 2^29 words at
//     about 28 ALU-pipe instructions each (the raw wall's count): ~0.90 ms
//     on 64 ALU lanes x 132 SMs x 1980 MHz.  The live product, 56,960
//     weights per path x 3 passes for "highest", is ~0.33 ms on the tensor
//     pipe at 2048 dense bf16 FMAs per SM per clock ("default": 0.11 ms).
//   * Raws straight into A: a warp owns 16 paths (8 word pairs); fragment
//     row g is path 2 pair_g (the words' low halves), row g + 8 path
//     2 pair_g + 1 (the high halves), so each thread hashes exactly the 4
//     words of its own A fragment per 16-step chunk, and two byte permutes
//     of two words' packed bf16x2 are its A registers.  The raws never pass
//     through shared memory and no barrier waits on them.
//   * The split: W = lo + mid + hi exactly in bf16 (kernels/fused.py,
//     split_bf16), one pass per part, small to large; "default" runs hi
//     = bf16(W) alone.  The TPU splits both operands (6 MXU passes); the
//     raws are exact bf16, so three passes give the fp32 product up to
//     the accumulation.
//   * Route: wgmma.mma_async m64n32k16, A from the warpgroup's registers
//     (64 paths), B from shared memory, so the tensor core reads B once
//     per 64 paths and issues no shared loads.  It is asynchronous: a warp
//     issues a half-block's product, hashes the next half's words while
//     the tensor core runs it, then waits.  The first route,
//     mma.sync.m16n8k16 with B fragments loaded per warp, ran 2.29 ms
//     ("highest") / 1.71 ms ("default") at 2^20 paths on an H100 80GB
//     HBM3 at 700 W: its tensor rate there is half of wgmma's and each
//     warp stalled on its own mma chains instead of hashing.
//   * The skip: a per-block mask of live 8-column groups, computed on the
//     host from W's nonzeros.  The product runs on quads of 4 groups
//     (wgmma's n32), those with a live group; a dead group's tiles in a
//     live quad are zeros.  At the reference size 24 of 32 block-quads
//     run (62 of 128 n8 groups are live): the T = 0 column's and columns
//     104-127's groups and the blocks after T_m are skipped.
//   * No promotion: the tensor core's fp32 sums run over all blocks (the
//     chains' length is 8 x 8 x 3 wgmma).  Measured on the card with the
//     mma.sync route at 2^20 paths ("highest"), against the plain fp32
//     product: max rel 1.67e-6 with a per-block fp32 promotion and
//     without, mean signed rel -1.9e-9 with and -9.3e-8 without; the
//     tolerance is 1e-5.  Promotion would need a second 64-float sum per
//     thread, which 16 warps of 128 registers cannot hold.
//   * W staging: a CTA owns 256 paths of one tile and copies each block's
//     live quads once (cp.async, double-buffered, two barriers per block):
//     about 0.6 MB of split per CTA, 2.4 GB of L2 reads per call.
// What stays open: the hash's own issue slots (index math, the A packing)
// and the tensor time the hash does not hide.

// zbc_full/vega_full: integer ALU (three murmur3 rounds per word, one word
// per two steps) plus 4 FMAs per word; the weight rows (2 x 512 floats)
// sit in shared memory and every read is a broadcast.  "highest" multiplies
// the exact raws by the fp32 weights; any other precision rounds the
// weights to bf16 first; both accumulate in fp32.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hw_device.cuh"
#include "hw_reduce.cuh"
#include "hw_wgmma.cuh"

namespace {

constexpr int PAD = 128;             // fused.PAD: maturity columns of W
constexpr int MIX_BLOCK = 128;       // fused._MIX_BLOCK: steps per block (the draw salt)
constexpr int TILE_FULL = 2048;      // fused.TILE_FULL: curve paths per tile
constexpr int TILE_FULL_OPT = 4096;  // fused.TILE_FULL_OPT: option paths per tile

// Q1 geometry.  Per block the split W is (SPLIT_PASSES, GROUPS, CHUNKS)
// tiles of TILE_BYTES: pass lo, mid, hi; n8 column group j; 16-step chunk
// kc; each tile the two 8 x 8 core matrices of wgmma's K-major B, steps
// 0-7 then 8-15, 8 columns of 16 bytes each (kernels/fused.py,
// split_tiles).
constexpr int SPLIT_PASSES = 3;
constexpr int GROUPS = PAD / 8;           // n8 tiles of the 128 columns
constexpr int CHUNKS = MIX_BLOCK / 16;    // k16 chunks of a block
constexpr int TILE_BYTES = 16 * 8 * 2;
constexpr int CORE_BYTES = TILE_BYTES / 2;                           // 8 x 16 B
constexpr int GROUP_BYTES = CHUNKS * TILE_BYTES;                     // 2 KB
constexpr int PASS_BYTES = GROUPS * GROUP_BYTES;                     // 32 KB
constexpr int BLOCK_BYTES = SPLIT_PASSES * PASS_BYTES;               // 96 KB
// A warp owns 8 word pairs, 16 paths (fragment rows g and g + 8), a
// warpgroup 64 paths (wgmma's m64), a CTA 16 warps, 256 paths of one tile.
constexpr int CURVE_WARPS = 16;
constexpr int CURVE_THREADS = 32 * CURVE_WARPS;
constexpr int WARP_PAIRS = 8;
constexpr int CURVE_PAIRS = CURVE_WARPS * WARP_PAIRS;
constexpr int CURVE_CTAS_PER_TILE = TILE_FULL / (2 * CURVE_PAIRS);  // 8
static_assert(CURVE_WARPS == GROUPS, "warp j copies group j of a stage");
// Blocks run in halves of HALF_CHUNKS chunks; the product runs on quads of
// QUAD n8 groups (wgmma's n32), those with a live group.
constexpr int HALF_CHUNKS = CHUNKS / 2;
constexpr int QUAD = 4;
constexpr int HALF_WORDS = 4 * HALF_CHUNKS;  // a thread's words per half

// Q2b/Q3: one path per thread.
constexpr int OPT_THREADS = 256;
constexpr int OPT_CTAS_PER_TILE = TILE_FULL_OPT / OPT_THREADS;  // 16

// fused._zbc_consts (fused.py:450).
struct FullConsts {
  float c_r, c_i, A, B, K, P0S2, c_dr, c_di, sigma, q;
};

// ---------------------------------------------------------------------------
// Q1: per-maturity sums of t + 1/t, t = exp(-z), z = sum_q U_q W_q.
// ---------------------------------------------------------------------------

// Warp j copies group j of block q's last PASSES passes into a stage laid
// out [pass slot][group][chunk][tile] if its quad has a live group (a dead
// group's tiles are zeros, which its quad's product then adds); the groups
// of dead quads stay untouched.
template <int PASSES>
__device__ __forceinline__ void stage_split(uint32_t stage, const char* Wq, uint32_t live) {
  const int j = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (!((live >> (j & ~(QUAD - 1))) & 0xFu)) return;
#pragma unroll
  for (int s = 0; s < PASSES; ++s)
#pragma unroll
    for (int i = lane; i < GROUP_BYTES / 16; i += 32)
      hw::cp_async16(stage + (s * GROUPS + j) * GROUP_BYTES + 16 * i,
                     Wq + ((SPLIT_PASSES - PASSES + s) * GROUPS + j) * GROUP_BYTES + 16 * i);
}

// The packed raws of word i of half-block hh for the pair of idx0: chunk
// HALF_CHUNKS (hh % 2) + i / 4, step (i % 2) + 8 ((i / 2) % 2) of it.
__device__ __forceinline__ uint32_t half_word(hw::Seeds sd, uint32_t s0, uint32_t idx0,
                                              int hh, int i) {
  const uint32_t q = static_cast<uint32_t>(hh >> 1);
  const uint32_t idx = idx0 + ((hh & 1) * HALF_CHUNKS + (i >> 2)) * 16 + (i & 1) +
                       8 * ((i >> 1) & 1);
  uint32_t x = hw::mix32(idx ^ (q * hw::SALT_MULT) ^ s0);
  x = hw::mix32(x + sd.s1);
  return hw::raw_bits(hw::mix32(x ^ s0));
}

// A fragments of a half from its words: rows g (low halves), g + 8 (high
// halves); steps 2t, 2t + 1 | 2t + 8, 2t + 9 of each chunk.
__device__ __forceinline__ void pack_fragments(const uint32_t (&w)[HALF_WORDS],
                                               uint32_t (&a)[HALF_CHUNKS][4]) {
#pragma unroll
  for (int c = 0; c < HALF_CHUNKS; ++c) {
    a[c][0] = __byte_perm(w[4 * c], w[4 * c + 1], 0x5410);
    a[c][1] = __byte_perm(w[4 * c], w[4 * c + 1], 0x7632);
    a[c][2] = __byte_perm(w[4 * c + 2], w[4 * c + 3], 0x5410);
    a[c][3] = __byte_perm(w[4 * c + 2], w[4 * c + 3], 0x7632);
  }
}

// Each CTA owns CURVE_PAIRS word pairs of one tile; warp w owns pairs
// 8w .. 8w + 7 of them, lane (g, t) = (lane / 4, lane % 4) the words of
// pair 8w + g at steps 2t, 2t + 1, 2t + 8, 2t + 9 of each 16-step chunk
// and the sums of its fragment rows g, g + 8 at columns 8j + 2t, 8j + 2t + 1.
// Per half-block: issue the half's product (per live quad, chunk and pass
// one asynchronous wgmma), hash the next half's words while the tensor
// core runs it, wait, and pack the words into the next A fragments.
template <int PASSES>
__global__ void __launch_bounds__(CURVE_THREADS, 1)
curve_full_kernel(hw::Seeds sd, const char* __restrict__ Wf,
                  const int* __restrict__ live_mask, int nb,
                  float* __restrict__ partials) {
  constexpr int STAGE = PASSES * PASS_BYTES;
  extern __shared__ float4 curve_smem[];
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(curve_smem));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t tile = sd.s2 + static_cast<uint32_t>(blockIdx.x / CURVE_CTAS_PER_TILE);
  const uint32_t s0 = hw::tile_seed(sd.s0, tile);
  const uint32_t pair = static_cast<uint32_t>(blockIdx.x % CURVE_CTAS_PER_TILE) * CURVE_PAIRS +
                        warp * WARP_PAIRS + g;
  const uint32_t idx0 = pair * MIX_BLOCK + 2 * t;

  float acc[GROUPS][4];
#pragma unroll
  for (int j = 0; j < GROUPS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  // the next half's words and the current half's A fragments
  uint32_t w[HALF_WORDS], a[HALF_CHUNKS][4];
#pragma unroll
  for (int i = 0; i < HALF_WORDS; ++i) w[i] = half_word(sd, s0, idx0, 0, i);
  pack_fragments(w, a);

  stage_split<PASSES>(sbase, Wf, static_cast<uint32_t>(__ldg(live_mask)));
  hw::cp_async_commit();
  for (int hh = 0; hh < 2 * nb; ++hh) {
    const int q = hh >> 1;
    if (!(hh & 1)) {
      if (q + 1 < nb)
        stage_split<PASSES>(sbase + ((q + 1) & 1) * STAGE,
                            Wf + static_cast<size_t>(q + 1) * BLOCK_BYTES,
                            static_cast<uint32_t>(__ldg(live_mask + q + 1)));
      hw::cp_async_commit();
      hw::cp_async_wait<1>();
      __syncthreads();  // block q's split has landed for every thread
    }
    const uint32_t live = static_cast<uint32_t>(__ldg(live_mask + q));
    const uint64_t desc = hw::b_desc<CORE_BYTES, GROUP_BYTES>(
        sbase + (q & 1) * STAGE + (hh & 1) * HALF_CHUNKS * TILE_BYTES);
    hw::wgmma_fence();  // a and acc were written by ordinary instructions
    const bool more = hh + 1 < 2 * nb;
#pragma unroll
    for (int j = 0; j < GROUPS; j += QUAD) {
      if ((live >> j) & 0xFu) {
#pragma unroll
        for (int c = 0; c < HALF_CHUNKS; ++c)
#pragma unroll
          for (int p = 0; p < PASSES; ++p)
            hw::wgmma_groups<QUAD>(
                acc + j, a[c], desc + (((p * GROUPS + j) * GROUP_BYTES + c * TILE_BYTES) >> 4));
      }
      // a quarter of the next half's words while the tensor core runs
      if (more) {
#pragma unroll
        for (int i = j; i < j + QUAD; ++i) w[i] = half_word(sd, s0, idx0, hh + 1, i);
      }
    }
    hw::wgmma_commit();
    hw::wgmma_wait_all();
#pragma unroll
    for (int j = 0; j < GROUPS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) hw::fence_operand(acc[j][e]);
    pack_fragments(w, a);
    if (hh & 1) __syncthreads();  // the stage is consumed before block q + 2's copy
  }

  // antithetic pair from one exp: e^{-(c+z)} + e^{-(c-z)} = e^{-c}(t + 1/t);
  // e^{-c} is applied in the second pass.  Rows g and g + 8, then the 8
  // row groups of the warp in a fixed shuffle order.
  float* red = reinterpret_cast<float*>(curve_smem);  // [CURVE_WARPS][PAD]
#pragma unroll
  for (int j = 0; j < GROUPS; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float t0 = expf(-acc[j][e]), t1 = expf(-acc[j][e + 2]);
      float s = (t0 + __frcp_rn(t0)) + (t1 + __frcp_rn(t1));
      s += __shfl_xor_sync(0xFFFFFFFFu, s, 4);
      s += __shfl_xor_sync(0xFFFFFFFFu, s, 8);
      s += __shfl_xor_sync(0xFFFFFFFFu, s, 16);
      if (g == 0) red[warp * PAD + 8 * j + 2 * t + e] = s;
    }
  __syncthreads();
  if (threadIdx.x < PAD) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < CURVE_WARPS; ++w) s += red[w * PAD + threadIdx.x];
    partials[static_cast<size_t>(blockIdx.x) * PAD + threadIdx.x] = s;
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

template <int PASSES>
cudaError_t launch_curve(int n_tiles, int nb, cudaStream_t st, hw::Seeds sd,
                         const char* Wf, const int* live, float* partials) {
  constexpr int smem = 2 * PASSES * PASS_BYTES;  // two stages; then the warps' sums
  static_assert(smem >= CURVE_WARPS * PAD * static_cast<int>(sizeof(float)),
                "the epilogue's sums fit in the stages");
  const cudaError_t err = cudaFuncSetAttribute(
      curve_full_kernel<PASSES>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  curve_full_kernel<PASSES><<<curve_full_ctas(n_tiles), CURVE_THREADS, smem, st>>>(
      sd, Wf, live, nb, partials);
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
// w_split is W's split as (nb, 3, 16, 8, 64) uint32 wgmma B tiles
// (kernels/fused.py, split_tiles), 16-byte aligned; live (nb,) the blocks'
// masks of live 8-column groups; exp_c is (PAD,).
int hw_curve_full(int32_t s0, int32_t s1, int32_t s2, const void* w_split,
                  const int32_t* live, int nb, const float* exp_c, int n_mat,
                  int n_tiles, int bf16, float count, float* partials,
                  float* out, void* stream) {
  if (nb < 1 || n_mat < 2 || n_mat > PAD || n_tiles < 1 ||
      reinterpret_cast<uintptr_t>(w_split) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const hw::Seeds sd = make_seeds(s0, s1, s2);
  const char* Wf = static_cast<const char*>(w_split);
  const cudaError_t err =
      bf16 ? launch_curve<1>(n_tiles, nb, st, sd, Wf, live, partials)
           : launch_curve<3>(n_tiles, nb, st, sd, Wf, live, partials);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ctas = curve_full_ctas(n_tiles);
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

// The launch the entries above make of one kernel of this file and what the
// card reports of it (launch_report's out, LAUNCH_FIELDS ints), for n_tiles,
// bf16 and nb as they take them: kind 0 the curve kernel, 1 zbc, 2 vega,
// 3 the reduce of hw_vega_full (one CTA).
int hw_full_launch(int kind, int n_tiles, int bf16, int nb, int* out) {
  if (nb < 1 || n_tiles < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int opt_smem = static_cast<int>(sizeof(float)) * 2 * nb * MIX_BLOCK;
  cudaError_t err = cudaErrorInvalidValue;
  if (kind == 0)
    err = bf16 ? launch_report(curve_full_kernel<1>, CURVE_THREADS, 2 * PASS_BYTES,
                               curve_full_ctas(n_tiles), out)
               : launch_report(curve_full_kernel<SPLIT_PASSES>, CURVE_THREADS,
                               2 * SPLIT_PASSES * PASS_BYTES, curve_full_ctas(n_tiles), out);
  else if (kind == 1)
    err = bf16 ? launch_report(zbc_full_kernel<true>, OPT_THREADS, opt_smem,
                               option_full_ctas(n_tiles), out)
               : launch_report(zbc_full_kernel<false>, OPT_THREADS, opt_smem,
                               option_full_ctas(n_tiles), out);
  else if (kind == 2)
    err = bf16 ? launch_report(vega_full_kernel<true>, OPT_THREADS, opt_smem,
                               option_full_ctas(n_tiles), out)
               : launch_report(vega_full_kernel<false>, OPT_THREADS, opt_smem,
                               option_full_ctas(n_tiles), out);
  else if (kind == 3)
    err = launch_report(reduce_kernel, REDUCE_THREADS, 0, 1, out);
  return static_cast<int>(err);
}

}  // extern "C"
