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
// Each CTA writes partial sums that a fixed-order second pass sums:
// reduce_kernel (hw_reduce.cuh) for the curve, or for zbc, vega and delta
// the kernel's own last CTA (last_cta_sums).  No float atomics, so reruns
// are bitwise identical.
//
// curve_exact: Box-Muller normals times the upper-triangular factor
// W = sig_st L^T on the tensor cores.
//   * Bound: the generator on the ALU pipe.  At 2^20 pairs and k = n_mat -
//     1 = 100 the kernel hashes 2^20 x 100 words at ~20 ALU-pipe
//     instructions each (the generator wall's count): ~0.13 ms on 64 ALU
//     lanes x 132 SMs x 1980 MHz.  The Box-Muller math, the epilogue's exp
//     and reciprocal and the split run beside it on the FMA and MUFU
//     pipes; the live product, k (k + 1) / 2 = 5050 weights per pair x 6
//     bf16 passes ("highest"), is ~0.06 ms on the tensor pipe.
//   * Normals straight into A: a warpgroup owns 64 paths (wgmma's m64),
//     32 Box-Muller rows; fragment row g of a warp is the cos half (z0)
//     of its row rho, row g + 8 the sin half (z1).  Each thread evaluates
//     exactly the 4 elements of its own A fragment per 16-column chunk
//     (columns 2t, 2t + 1, 2t + 8, 2t + 9 of row rho), hashed on the JAX
//     coordinates (tile, row, column), and splits them in registers.  No
//     normal passes through shared memory and no barrier waits on one.
//     Columns >= k multiply zero rows of W: they are not drawn, and the
//     chunks from k on are not issued.
//   * The split, both operands: x = hi + mid + lo exactly in bf16, in
//     registers (hw::split_bf16x2); W's three parts from the host
//     (kernels/fused.py, split_bf16 / split_tiles).  "highest" issues the
//     TPU's six bf16 passes Xhi Wlo, Xlo Whi, Xmid Wmid, Xhi Wmid,
//     Xmid Whi, Xhi Whi (small to large; the three dropped terms are
//     ~2^-24 of each product), "default" the one pass Xhi Whi, which is
//     the plain version's bf16 product; fp32 sums on the tensor core.
//   * The skip: W is upper-triangular, so whole (k16 chunk, n32 quad)
//     tiles are zero.  A mask of live quads per chunk, built on the host
//     from W's nonzeros (fused.chunk_quads), names those the product runs:
//     19 of the 28 at the reference size.  The columns from k on hold no
//     accumulator: an instance per NG = ceil(k / 8) keeps NG n8 groups,
//     and a quad's wgmma covers its groups below NG (N = 8 .. 32), 7040
//     executed FMAs per pair and pass for 5050 live.
//   * Persistent CTAs, as many as fit at once (one per SM at the
//     reference size): 5 warpgroups (20 warps of <= 96 registers; 4 where
//     the accumulators need more, curve_wgs) share W's live tiles, staged
//     once per chunk span (cp.async, <= 3 x 19 KB at the reference size);
//     each warpgroup walks the 64-path tiles w, w + 5 grid, ...  Per
//     chunk it issues the product (per live quad one wgmma per pass)
//     asynchronously, evaluates the next chunk's (or the next tile's
//     first) normals while the tensor core runs it, waits, and splits
//     them into the A registers.  Per tile, the exp and reciprocal
//     epilogue, whose column sums are folded across the warp's 8 row
//     groups (fold_rows) into 4 running sums per thread, kept in shared
//     memory and summed across the warps once, at the CTA's end, in a
//     fixed order.
//   * Warps hide the latency: the kernel is register-bound.  64 fp32
//     accumulators a thread allowed 12-16 warps per SM; NG groups (52 at
//     the reference size), the folded column sums and a warp-uniform
//     warpgroup index (a divergent loop bound made ptxas serialize the
//     wgmma) allow 20 (PERF.md section 6 lists the routes timed).
// What stays open: Box-Muller and the epilogue run at 67-77% of their
// walls' rates and add up on the issue slots; the product adds ~0.09 ms
// ("highest") that the other warps' work does not hide.
//
// zbc/vega/delta: per-element work and no memory traffic: 2 hashed words,
// Box-Muller (log, sqrt, the sin/cos polynomials), 2 exps, 2 reciprocals
// (vega: 2 IEEE divisions by sigma) and the payoff.
//   * Bound: the function's fp32 work at the unit walls' per-item cost,
//     ~3 us at 2^20 pairs (roofline.work).  The loop issues ~195
//     instructions per element (SASS), so the card's issue rate, one
//     instruction per scheduler per clock, is the wall it meets: ~97 us at
//     2^24 pairs and 1980 MHz.
//   * The whole card in one wave: persistent CTAs of 1024 threads, two per
//     SM at 32 registers (the occupancy query, at most one per unit), walk
//     units of 4096 elements that lie inside one tile.  At 2^20 pairs the
//     256 units fill 256 CTAs, one unit each; at 2^24 the walk leaves no
//     wave tail.  The tile seed and the salt words are per unit, the
//     element index a 32-bit add.
//   * Four elements in flight per thread, drawn together, their terms
//     added to one accumulator set in order: an accumulator set per
//     element took 40 registers for ZBC (6 CTAs of 256 per SM) and ran
//     slower (PERF.md section 6 lists the routes timed).
//   * One launch: the last CTA to take a ticket sums the CTAs' partials in
//     a fixed order (last_cta_sums); the ticket is one zeroed word per
//     stream that the wrapper keeps.
//   * delta walks the same units with ZBC's state and exps and one
//     accumulator (hw::delta_pair).
//
// option_normals: the same Box-Muller pairs, stored: 8 bytes per element.
//   * Bound: the hash on the ALU pipe (~2.5 us at 2^20 pairs) and the
//     stores at HBM peak (~2.5 us) are as long as each other, so they have
//     to overlap.  The loop issues ~116 instructions per element (SASS,
//     54 on the ALU pipe): the issue rate is the wall it meets, ~3.7 us of
//     work at 2^20 pairs and 1980 MHz beside ~2 us a launch takes.
//   * Persistent CTAs of STORE_THREADS, as many as fit at once (at most
//     one unit per warp); each warp walks units of STORE_ROWS rows of one
//     tile, the tile seed and salt word once per unit.  Lane l draws
//     columns 4 l .. 4 l + 3 of each row and stores them as one float4 per
//     array: a warp's store is one 512-byte row, and the draws of the
//     unit's next row run while the last row's stores drain.

#include <cuda_runtime.h>
#include <stdint.h>

#include <array>
#include <utility>

#include "hw_device.cuh"
#include "hw_reduce.cuh"
#include "hw_wgmma.cuh"

namespace {

constexpr int PAD = 128;                        // fused.PAD
constexpr int TILE_EXACT = 4096;                // fused.TILE_EXACT (BM rows)
constexpr int TILE_OPT = 256;                   // fused.TILE_OPT
constexpr int OPT_TILE_ELEMS = TILE_OPT * PAD;  // pairs (paths) per option tile

// Q1 geometry.  W's split is (part lo, mid, hi; n8 group j; k16 chunk s)
// tiles of TILE_BYTES (kernels/fused.py, split_tiles of one 128-row
// block), each the two 8 x 8 core matrices of wgmma's K-major B: rows
// 16 s + 0-7, then 8-15, of 8 columns, 16 bytes per column.  The product
// and the mask run on quad tiles (chunk s, quad q): rows 16 s .. + 15,
// columns 32 q .. + 31, the n8 tiles of groups 4 q .. 4 q + 3; a chunk's
// W is staged over the span from its first to its last live quad.
constexpr int SPLIT_PARTS = 3;
constexpr int GROUPS = PAD / 8;
constexpr int CHUNKS = PAD / 16;
constexpr int QUADS = PAD / 32;
constexpr int QUAD_GROUPS = GROUPS / QUADS;
constexpr int TILE_BYTES = 16 * 8 * 2;
constexpr int CORE_BYTES = TILE_BYTES / 2;
constexpr int QUAD_BYTES = QUAD_GROUPS * TILE_BYTES;
static_assert(CHUNKS * QUADS == 32, "the live mask is one 32-bit word");
// A warpgroup owns a 64-path tile of WG_ROWS Box-Muller rows of one curve
// tile at a time (wgmma's m64); a CTA is curve_wgs warpgroups that share
// the staged weights.
constexpr int WG_ROWS = 32;
constexpr int WG_TILES_PER_TILE = TILE_EXACT / WG_ROWS;

// Warpgroups per CTA of the instance with XPARTS A parts and NG
// accumulator groups: 5 (20 warps per SM at <= 96 registers a thread)
// where the accumulators and the A parts take at most 68 registers, else
// 4 (16 warps at <= 128); more warps hide more of the Box-Muller and
// epilogue latency, and no instance spills (chip_smoke.py checks the
// ptxas report).
template <int XPARTS, int NG>
__host__ __device__ constexpr int curve_wgs() {
  return 4 * NG + 4 * XPARTS <= 68 ? 5 : 4;
}

// Layout of fused._zbc_consts + the sampling factor (fused.py:450, :638),
// then the delta kernel's [dr/dr0, dI/dr0] (zero for the other kernels).
// P0S2 centers the control: it is market.P[-1] = P(0, t_final), as in the
// JAX package, and equals P(0,S2) only when S2 = t_final.
struct OptConsts {
  float c_r, c_i, A, B, K, P0S2, c_dr, c_di, sigma, q, l11, l21, l22;
  float dr_dr0, di_dr0;
};

// ---------------------------------------------------------------------------
// Q1: per-maturity sums of t + 1/t, t = exp(-z), z = X (sig_st L^T).
// ---------------------------------------------------------------------------

// Pass p of "highest" multiplies A part pass_x(p) by W part pass_w(p):
// (hi, lo), (lo, hi), (mid, mid), (hi, mid), (mid, hi), (hi, hi), with the
// A parts hi, mid, lo = 0, 1, 2 and the staged W parts lo, mid, hi = 0, 1,
// 2; "default" runs pass 0 alone, A's hi by the one staged part, W's hi.
__host__ __device__ constexpr int pass_x(int p) {
  return p == 1 ? 2 : (p == 2 || p == 4) ? 1 : 0;
}
__host__ __device__ constexpr int pass_w(int p) {
  return p == 0 ? 0 : (p == 2 || p == 3) ? 1 : 2;
}

// The Box-Muller row of this thread in 64-path tile w of the call: tile
// w / WG_TILES_PER_TILE, row WG_ROWS (w % WG_TILES_PER_TILE) + 8 warp + g;
// its tile seed and the element index of its first column 2t.
struct CurveRow {
  uint32_t s0, idx0;
};

__device__ __forceinline__ CurveRow curve_row(hw::Seeds sd, int w, int warp, int g, int t) {
  const uint32_t tile = sd.s2 + static_cast<uint32_t>(w / WG_TILES_PER_TILE);
  const uint32_t rho = static_cast<uint32_t>((w % WG_TILES_PER_TILE) * WG_ROWS + 8 * warp + g);
  return {hw::tile_seed(sd.s0, tile), rho * PAD + 2 * t};
}

// Element e of this thread's A fragment of chunk s: column 16 s + 2t +
// (e & 1) + 8 (e >> 1) of its row, z0 (the cos half, fragment row g) and
// z1 (the sin half, row g + 8); 0 from column k on.
__device__ __forceinline__ void fragment_normal(hw::Seeds sd, CurveRow r, int t, int s, int k,
                                                int e, float (&z0)[4], float (&z1)[4]) {
  const int off = 16 * s + (e & 1) + 8 * (e >> 1);
  if (2 * t + off < k) {
    hw::box_muller(r.s0, sd.s1, r.idx0 + off, z0[e], z1[e]);
  } else {
    z0[e] = 0.0f;
    z1[e] = 0.0f;
  }
}

// The span of chunk s's live quads: the first q0 and the count nq from it
// to the last (0 if none).  W's parts are staged over the span; a dead
// quad inside it is staged (W's zeros) but not multiplied.
__host__ __device__ inline void chunk_span(uint32_t live, int s, int& q0, int& nq) {
  const uint32_t m = (live >> (QUADS * s)) & 0xFu;
  q0 = 0;
  nq = 0;
  if (!m) return;
  while (!((m >> q0) & 1u)) ++q0;
  int q1 = QUADS - 1;
  while (!((m >> q1) & 1u)) --q1;
  nq = q1 - q0 + 1;
}

// The A fragments of the chunk, split into XPARTS bf16 parts (hi, mid,
// lo): registers 0-3 hold rows g, g + 8 at k 2t, 2t + 1, then rows g,
// g + 8 at k 2t + 8, 2t + 9.
template <int XPARTS>
__device__ __forceinline__ void split_fragments(const float (&z0)[4], const float (&z1)[4],
                                                uint32_t (&a)[XPARTS][4]) {
  uint32_t p0[XPARTS], p1[XPARTS], p2[XPARTS], p3[XPARTS];
  hw::split_bf16x2<XPARTS>(z0[0], z0[1], p0);
  hw::split_bf16x2<XPARTS>(z1[0], z1[1], p1);
  hw::split_bf16x2<XPARTS>(z0[2], z0[3], p2);
  hw::split_bf16x2<XPARTS>(z1[2], z1[3], p3);
#pragma unroll
  for (int i = 0; i < XPARTS; ++i) {
    a[i][0] = p0[i];
    a[i][1] = p1[i];
    a[i][2] = p2[i];
    a[i][3] = p3[i];
  }
}

// A tile's column sums v[2 j + e] (columns 8 j + 2t + e) summed over the
// warp's 8 row groups g in three butterfly steps across lane bits 2-4,
// each halving what a lane keeps: lane (g, t) is left with the sums of
// v[fold_base(g) + i], i < 4, each added in a fixed order.
__device__ __forceinline__ int fold_base(int g) {
  return 16 * (g & 1) + 8 * ((g >> 1) & 1) + 4 * (g >> 2);
}

__device__ __forceinline__ void fold_rows(const float (&v)[2 * GROUPS], int g,
                                          float (&out)[4]) {
  float h[GROUPS], q[GROUPS / 2];
  const bool b0 = g & 1, b1 = (g >> 1) & 1, b2 = (g >> 2) & 1;
#pragma unroll
  for (int i = 0; i < GROUPS; ++i) {
    const float send = b0 ? v[i] : v[i + GROUPS];
    h[i] = (b0 ? v[i + GROUPS] : v[i]) + __shfl_xor_sync(0xFFFFFFFFu, send, 4);
  }
#pragma unroll
  for (int i = 0; i < GROUPS / 2; ++i) {
    const float send = b1 ? h[i] : h[i + GROUPS / 2];
    q[i] = (b1 ? h[i + GROUPS / 2] : h[i]) + __shfl_xor_sync(0xFFFFFFFFu, send, 8);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = b2 ? q[i] : q[i + 4];
    out[i] = (b2 ? q[i + 4] : q[i]) + __shfl_xor_sync(0xFFFFFFFFu, send, 16);
  }
}

// The chunk's product on quads Q .. QUADS - 1 that hold columns below
// 8 NG: per live quad and pass p, d[4 Q ..] += A part pass_x(p) x W part
// pass_w(p), one wgmma over the quad's G groups below NG (N = 8 G).
// Quad Q's W parts sit at quad_base + Q QUAD_BYTES, part after part nq
// quads apart.
template <int XPARTS, int NG, int Q = 0>
__device__ __forceinline__ void issue_quads(float (&acc)[NG][4], const uint32_t (&a)[XPARTS][4],
                                            uint32_t quads, uint32_t quad_base, int nq) {
  if constexpr (Q < QUADS && QUAD_GROUPS * Q < NG) {
    constexpr int PASSES = XPARTS == SPLIT_PARTS ? 6 : 1;
    constexpr int G = NG - QUAD_GROUPS * Q < QUAD_GROUPS ? NG - QUAD_GROUPS * Q : QUAD_GROUPS;
    if ((quads >> Q) & 1u) {
      const uint32_t quad = quad_base + Q * QUAD_BYTES;
#pragma unroll
      for (int p = 0; p < PASSES; ++p)
        hw::wgmma_groups<G>(acc + QUAD_GROUPS * Q, a[pass_x(p)],
                            hw::b_desc<CORE_BYTES, TILE_BYTES>(
                                quad + pass_w(p) * nq * QUAD_BYTES));
    }
    issue_quads<XPARTS, NG, Q + 1>(acc, a, quads, quad_base, nq);
  }
}

// w_split is W's split (kernels/fused.py, split_shape(1)); bit 4 s + q of
// live names the quad tiles the product runs; the columns from k on, and
// so the n8 groups from NG = ceil(k / 8) on, multiply zeros and hold no
// accumulator.  Thread (warpgroup, warp, g, t) owns the paths of its
// Box-Muller row (fragment rows g, g + 8) in each of its warpgroup's
// 64-path tiles, and the running sums of 4 of the columns 8 j + 2t + e its
// accumulators hold (fold_rows).
template <int XPARTS, int NG>
__global__ void __launch_bounds__(128 * curve_wgs<XPARTS, NG>(), 1)
curve_exact_kernel(hw::Seeds sd, const char* __restrict__ w_split, uint32_t live, int k,
                   int n_wg, float* __restrict__ partials) {
  constexpr int WGS = curve_wgs<XPARTS, NG>();
  constexpr int THREADS = 128 * WGS;
  static_assert(THREADS >= PAD, "thread m < PAD sums column m of the CTA");
  extern __shared__ float4 curve_smem[];
  __shared__ float red[THREADS / 32][PAD];
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(curve_smem));
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  // the warpgroup, broadcast from lane 0 so that the compiler sees it
  // warp-uniform: a loop bound it cannot prove uniform puts the wgmma on
  // a divergent path, and ptxas then serializes them
  const int wg = __shfl_sync(0xFFFFFFFFu, static_cast<int>(threadIdx.x >> 7), 0);
  const int g = lane >> 2, t = lane & 3;

  // Stage W's last XPARTS parts of each chunk's span once, chunk after
  // chunk: [part][n8 group 4 q0 .. 4 (q0 + nq) - 1][TILE_BYTES].
  uint32_t off = 0;
  for (int s = 0; s < CHUNKS; ++s) {
    int q0, nq;
    chunk_span(live, s, q0, nq);
    const int per_part = nq * QUAD_BYTES / 16;
    for (int i = threadIdx.x; i < XPARTS * per_part; i += THREADS) {
      const int part = i / per_part, jj = (i % per_part) / (TILE_BYTES / 16);
      const int piece = i % (TILE_BYTES / 16);
      const int src_tile =
          ((SPLIT_PARTS - XPARTS + part) * GROUPS + QUAD_GROUPS * q0 + jj) * CHUNKS + s;
      hw::cp_async16(sbase + off + part * nq * QUAD_BYTES + jj * TILE_BYTES + 16 * piece,
                     w_split + src_tile * TILE_BYTES + 16 * piece);
    }
    off += XPARTS * nq * QUAD_BYTES;
  }
  hw::cp_async_commit();
  hw::cp_async_wait<0>();
  __syncthreads();

  // this thread's 4 running column sums (fold_rows), kept in shared
  // memory to spare registers: each slot has one owner until the end
  float* colsum = red[threadIdx.x >> 5];
  const int col0 = 8 * (fold_base(g) >> 1) + 2 * t;
#pragma unroll
  for (int i = 0; i < 4; ++i) colsum[col0 + 8 * (i >> 1) + (i & 1)] = 0.0f;

  const int n_chunks = (k + 15) / 16;
  const int first = blockIdx.x * WGS + wg, stride = gridDim.x * WGS;
  float acc[NG][4];
#pragma unroll
  for (int j = 0; j < NG; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  float z0[4], z1[4];
  uint32_t a[XPARTS][4];
  CurveRow row = curve_row(sd, first, warp, g, t);
  if (first < n_wg) {
#pragma unroll
    for (int e = 0; e < 4; ++e) fragment_normal(sd, row, t, 0, k, e, z0, z1);
  }
  for (int w = first; w < n_wg; w += stride) {
    uint32_t base = sbase;
    for (int s = 0; s < n_chunks; ++s) {
      split_fragments<XPARTS>(z0, z1, a);
      int q0, nq;
      chunk_span(live, s, q0, nq);
      hw::wgmma_fence();  // a and acc were written by ordinary instructions
      issue_quads<XPARTS, NG>(acc, a, (live >> (QUADS * s)) & 0xFu,
                              base - q0 * QUAD_BYTES, nq);
      hw::wgmma_commit();
      // the next chunk's normals, or the next tile's first, while the
      // tensor core runs this chunk's product
      const bool next_chunk = s + 1 < n_chunks, more = next_chunk || w + stride < n_wg;
      const int sn = next_chunk ? s + 1 : 0;
      if (!next_chunk && more) row = curve_row(sd, w + stride, warp, g, t);
      if (more) {
#pragma unroll
        for (int e = 0; e < 4; ++e) fragment_normal(sd, row, t, sn, k, e, z0, z1);
      }
      base += XPARTS * nq * QUAD_BYTES;
      hw::wgmma_wait_all();
#pragma unroll
      for (int j = 0; j < NG; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) hw::fence_operand(acc[j][e]);
    }
    // antithetic pair from one exp: e^{-(c+z)} + e^{-(c-z)} = e^{-c}(t + 1/t);
    // e^{-c} is applied in the second pass, which reads the columns below k
    // only (the last group's others hold z = 0).
    float v[2 * GROUPS], folded[4];
#pragma unroll
    for (int i = 0; i < 2 * GROUPS; ++i) v[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NG; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float t0 = expf(-acc[j][e]), t1 = expf(-acc[j][e + 2]);
        v[2 * j + e] = (t0 + __frcp_rn(t0)) + (t1 + __frcp_rn(t1));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
    }
    fold_rows(v, g, folded);
#pragma unroll
    for (int i = 0; i < 4; ++i) colsum[col0 + 8 * (i >> 1) + (i & 1)] += folded[i];
  }

  // the warps' column sums in order: thread m < PAD writes column m of the
  // CTA's partials
  __syncthreads();
  if (threadIdx.x < PAD) {
    float sum = red[0][threadIdx.x];
#pragma unroll
    for (int i = 1; i < THREADS / 32; ++i) sum += red[i][threadIdx.x];
    partials[static_cast<size_t>(blockIdx.x) * PAD + threadIdx.x] = sum;
  }
}

// ---------------------------------------------------------------------------
// Q2b, Q3 and delta: persistent CTAs walk units of WALK_THREADS x WALK_ILP
// elements, each unit inside one option tile.  Unit u holds elements
// (u % WALK_UNITS_PER_TILE) WALK_UNIT + i WALK_THREADS + threadIdx.x,
// i < WALK_ILP, of tile s2 + u / WALK_UNITS_PER_TILE; CTA b walks units b,
// b + gridDim.x, ...  Per unit the tile seed and the salt words are
// computed once and the element index is a 32-bit add; each thread draws
// its WALK_ILP elements together and adds their terms to its one
// accumulator set in order i = 0, 1, ...; then block_sum and the last
// CTA's pass over every CTA's partials (last_cta_sums).
// ---------------------------------------------------------------------------
constexpr int WALK_THREADS = 1024;
constexpr int WALK_ILP = 4;
constexpr int WALK_UNIT = WALK_THREADS * WALK_ILP;
constexpr int WALK_UNITS_PER_TILE = OPT_TILE_ELEMS / WALK_UNIT;
static_assert(OPT_TILE_ELEMS % WALK_UNIT == 0, "a unit lies inside one tile");
// at most 32 registers a thread: two CTAs fill an SM's 2048 threads
constexpr int WALK_CTAS_PER_SM = 2048 / WALK_THREADS;

// Calls term(x1, x2, s) on the normals of every element of this CTA's
// units, in walk order.
template <int N, class Term>
__device__ __forceinline__ void walk_units(hw::Seeds sd, uint32_t n_units, const Term& term,
                                           float (&s)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) s[n] = 0.0f;
  for (uint32_t u = blockIdx.x; u < n_units; u += gridDim.x) {
    const uint32_t s0 = hw::tile_seed(sd.s0, sd.s2 + u / WALK_UNITS_PER_TILE);
    const uint32_t salted1 = hw::SALT_MULT ^ s0;  // salt 0's word is s0 itself
    const uint32_t idx = (u % WALK_UNITS_PER_TILE) * WALK_UNIT + threadIdx.x;
#pragma unroll
    for (int i = 0; i < WALK_ILP; ++i) {
      const uint32_t e = idx + i * WALK_THREADS;
      float x1, x2;
      hw::box_muller_words(hw::tile_draw_salted(s0, s0, sd.s1, e),
                           hw::tile_draw_salted(salted1, s0, sd.s1, e), x1, x2);
      term(x1, x2, s);
    }
  }
}

// Q2b: both antithetic legs share one exp per process (_legs_pair):
//   P(+/-) = A e^{-B c_r} t_r^{+/-1},  disc(+/-) = e^{-c_I} t_i^{+/-1}.
// Five centered CV moments (_moment_accum rows 0-4); out (6) with the count.
__global__ void __launch_bounds__(WALK_THREADS, WALK_CTAS_PER_SM)
zbc_exact_kernel(hw::Seeds sd, OptConsts c, uint32_t n_units, float count,
                 float* __restrict__ partials, unsigned int* ticket, float* __restrict__ out) {
  const float P_base = c.A * expf(-c.B * c.c_r);
  const float d_base = expf(-c.c_i);
  float v[5];
  walk_units(sd, n_units, [&](float x1, float x2, float (&s)[5]) {
    hw::zbc_pair_moments(c, P_base, d_base, c.l11 * x1, c.l21 * x1 + c.l22 * x2, s);
  }, v);
  block_sum<5, WALK_THREADS>(v, partials + blockIdx.x * 5);
  last_cta_sums<5, WALK_THREADS>(partials, ticket, count, out);
}

// Q3: pathwise vega, single leg (_vega_terms):
//   v = 1{P>K} (-P B (q + dr)) disc - dI disc (P - K)^+,
//   dr = c_dr + z_r / sigma,  dI = c_dI + z_I / sigma.
// out (2): [sum v, count].
__global__ void __launch_bounds__(WALK_THREADS, WALK_CTAS_PER_SM)
vega_exact_kernel(hw::Seeds sd, OptConsts c, uint32_t n_units, float count,
                  float* __restrict__ partials, unsigned int* ticket, float* __restrict__ out) {
  float v[1];
  walk_units(sd, n_units, [&](float x1, float x2, float (&s)[1]) {
    s[0] += hw::vega_term(c, c.l11 * x1, c.l21 * x1 + c.l22 * x2);
  }, v);
  block_sum<1, WALK_THREADS>(v, partials + blockIdx.x);
  last_cta_sums<1, WALK_THREADS>(partials, ticket, count, out);
}

// Pathwise delta (d price / d r0), both antithetic legs (hw::delta_pair):
// the ZBC kernel's state and exps with another tail, one accumulator.
// out (2): [sum of delta terms, count].
__global__ void __launch_bounds__(WALK_THREADS, WALK_CTAS_PER_SM)
delta_exact_kernel(hw::Seeds sd, OptConsts c, uint32_t n_units, float count,
                   float* __restrict__ partials, unsigned int* ticket, float* __restrict__ out) {
  const float P_base = c.A * expf(-c.B * c.c_r);
  const float d_base = expf(-c.c_i);
  float v[1];
  walk_units(sd, n_units, [&](float x1, float x2, float (&s)[1]) {
    s[0] += hw::delta_pair(c, P_base, d_base, c.l11 * x1, c.l21 * x1 + c.l22 * x2);
  }, v);
  block_sum<1, WALK_THREADS>(v, partials + blockIdx.x);
  last_cta_sums<1, WALK_THREADS>(partials, ticket, count, out);
}

// ---------------------------------------------------------------------------
// The option tiles' normals: (x1, x2) of every element of n_tiles option
// tiles, row-major (n_tiles * TILE_OPT, PAD) like dump_option_normals.
// Persistent CTAs whose warps walk units of STORE_ROWS rows of one tile:
// warp w of CTA b walks units b STORE_WARPS + w, then + gridDim.x
// STORE_WARPS, ...; unit u is rows (u % STORE_UNITS_PER_TILE) STORE_ROWS
// .. + STORE_ROWS - 1 of tile s2 + u / STORE_UNITS_PER_TILE, i.e.
// elements u STORE_UNIT .. + STORE_UNIT - 1 of the arrays.  Per unit the
// tile seed and the salt word are computed once; lane l draws elements
// row PAD + 4 l + j, j < 4, of each row and stores them as one float4.
// ---------------------------------------------------------------------------
constexpr int STORE_THREADS = 512;
constexpr int STORE_ROWS = 2;
constexpr int STORE_WARPS = STORE_THREADS / 32;
constexpr int STORE_UNIT = STORE_ROWS * PAD;
constexpr int STORE_UNITS_PER_TILE = TILE_OPT / STORE_ROWS;
static_assert(PAD == 32 * 4, "a lane stores one float4 of each row");
static_assert(TILE_OPT % STORE_ROWS == 0, "a unit lies inside one tile");

// at most 32 registers a thread: 2048 / STORE_THREADS CTAs fill an SM
__global__ void __launch_bounds__(STORE_THREADS, 2048 / STORE_THREADS)
option_normals_kernel(hw::Seeds sd, uint32_t n_units, float* __restrict__ x1,
                      float* __restrict__ x2) {
  const uint32_t lane = threadIdx.x % 32;
  for (uint32_t u = blockIdx.x * STORE_WARPS + threadIdx.x / 32; u < n_units;
       u += gridDim.x * STORE_WARPS) {
    const uint32_t s0 = hw::tile_seed(sd.s0, sd.s2 + u / STORE_UNITS_PER_TILE);
    const uint32_t salted1 = hw::SALT_MULT ^ s0;  // salt 0's word is s0 itself
    const uint32_t idx = (u % STORE_UNITS_PER_TILE) * STORE_UNIT + 4 * lane;
    const size_t at = static_cast<size_t>(u) * STORE_UNIT + 4 * lane;
#pragma unroll
    for (int r = 0; r < STORE_ROWS; ++r) {
      float a[4], b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t e = idx + r * PAD + j;
        hw::box_muller_words(hw::tile_draw_salted(s0, s0, sd.s1, e),
                             hw::tile_draw_salted(salted1, s0, sd.s1, e), a[j], b[j]);
      }
      *reinterpret_cast<float4*>(x1 + at + r * PAD) = make_float4(a[0], a[1], a[2], a[3]);
      *reinterpret_cast<float4*>(x2 + at + r * PAD) = make_float4(b[0], b[1], b[2], b[3]);
    }
  }
}

// The kernel instance of XPARTS parts and NG = ceil(k / 8) accumulator
// groups and its warpgroups per CTA, from a table of all 16 widths.
struct CurveInstance {
  void (*kernel)(hw::Seeds, const char*, uint32_t, int, int, float*);
  int wgs;
};

template <int XPARTS, int... I>
std::array<CurveInstance, sizeof...(I)> curve_instances(std::integer_sequence<int, I...>) {
  return {{{curve_exact_kernel<XPARTS, I + 1>, curve_wgs<XPARTS, I + 1>()}...}};
}

CurveInstance curve_exact_instance(int bf16, int k) {
  static const auto split =
      curve_instances<SPLIT_PARTS>(std::make_integer_sequence<int, GROUPS>{});
  static const auto one = curve_instances<1>(std::make_integer_sequence<int, GROUPS>{});
  return (bf16 ? one : split)[(k + 7) / 8 - 1];
}

// Bytes of the staged spans of xparts parts.
int curve_exact_smem(uint32_t live, int xparts) {
  int quads = 0;
  for (int s = 0; s < CHUNKS; ++s) {
    int q0, nq;
    chunk_span(live, s, q0, nq);
    quads += nq;
  }
  return quads * xparts * QUAD_BYTES;
}

// The persistent grid for the wrappers' arguments (persistent_ctas), at
// most one CTA per warpgroups' worth of 64-path tiles.
cudaError_t curve_exact_ctas(int n_tiles, int bf16, uint32_t live, int k, int* ctas) {
  if (n_tiles < 1 || n_tiles > (1 << 24) || k < 1 || k > PAD) return cudaErrorInvalidValue;
  const CurveInstance inst = curve_exact_instance(bf16, k);
  const int most = (n_tiles * WG_TILES_PER_TILE + inst.wgs - 1) / inst.wgs;
  return persistent_ctas(inst.kernel, 128 * inst.wgs,
                         curve_exact_smem(live, bf16 ? 1 : SPLIT_PARTS), most, ctas);
}

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

// A walk kernel, its partials per CTA and the loader of its consts.
struct Walk {
  void (*kernel)(hw::Seeds, OptConsts, uint32_t, float, float*, unsigned int*, float*);
  int n;
  OptConsts (*load)(const float*);
};
const Walk zbc_walk{zbc_exact_kernel, 5, load_consts};
const Walk vega_walk{vega_exact_kernel, 1, load_consts};
const Walk delta_walk{delta_exact_kernel, 1, load_delta_consts};

// The persistent grid of a walk over n_tiles option tiles
// (persistent_ctas), at most one CTA per unit.
cudaError_t walk_ctas(const Walk& w, int n_tiles, int* ctas) {
  if (n_tiles < 1 || n_tiles > (1 << 24)) return cudaErrorInvalidValue;
  return persistent_ctas(w.kernel, WALK_THREADS, 0,
                         static_cast<long long>(n_tiles) * WALK_UNITS_PER_TILE, ctas);
}

// Scratch floats of a walk (n partials per CTA), or minus a CUDA error
// code if the grid query fails.
int walk_partials(const Walk& w, int n_tiles) {
  int ctas = 0;
  const cudaError_t err = walk_ctas(w, n_tiles, &ctas);
  return err == cudaSuccess ? ctas * w.n : -static_cast<int>(err);
}

// One launch of a walk kernel; partials holds n_partials floats
// (walk_partials), ticket one zeroed word that no launch on another stream
// uses at the same time.
int walk_launch(const Walk& w, int32_t s0, int32_t s1, int32_t s2, const float* consts_host,
                int n_tiles, float count, float* partials, int n_partials, void* ticket,
                float* out, void* stream) {
  int ctas = 0;
  const cudaError_t err = walk_ctas(w, n_tiles, &ctas);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_partials < ctas * w.n || ticket == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = w.kernel;
  kernel<<<ctas, WALK_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      make_seeds(s0, s1, s2), w.load(consts_host),
      static_cast<uint32_t>(n_tiles) * WALK_UNITS_PER_TILE, count, partials,
      static_cast<unsigned int*>(ticket), out);
  return static_cast<int>(cudaGetLastError());
}

// The persistent grid of the normals over n_tiles option tiles
// (persistent_ctas), at most one unit per warp.
cudaError_t normals_ctas(int n_tiles, int* ctas) {
  if (n_tiles < 1 || n_tiles > (1 << 24)) return cudaErrorInvalidValue;
  const long long units = static_cast<long long>(n_tiles) * STORE_UNITS_PER_TILE;
  return persistent_ctas(option_normals_kernel, STORE_THREADS, 0,
                         (units + STORE_WARPS - 1) / STORE_WARPS, ctas);
}

}  // namespace

extern "C" {

// Scratch sizes (floats) the wrappers allocate for the partial sums; the
// curve's is minus a CUDA error code if the grid query fails.
int hw_curve_partials(int n_tiles, int bf16, int32_t live, int k) {
  int ctas = 0;
  const cudaError_t err = curve_exact_ctas(n_tiles, bf16, static_cast<uint32_t>(live), k, &ctas);
  return err == cudaSuccess ? ctas * PAD : -static_cast<int>(err);
}
int hw_zbc_partials(int n_tiles) { return walk_partials(zbc_walk, n_tiles); }
int hw_vega_partials(int n_tiles) { return walk_partials(vega_walk, n_tiles); }
int hw_delta_partials(int n_tiles) { return walk_partials(delta_walk, n_tiles); }

// out (k + 1): [count, e^{-c_m} sum_paths (t + 1/t) for m < k].  w_split
// is W's split as (1, 3, 16, 8, 64) uint32 wgmma B tiles (kernels/fused.py,
// split_tiles), 16-byte aligned; bit 4 s + q of live marks quad tile
// (chunk s, quad q) live; partials holds n_partials floats
// (hw_curve_partials).  W's rows from k on must be zero.
int hw_curve_exact(int32_t s0, int32_t s1, int32_t s2, const void* w_split,
                   int32_t live, const float* c, int k, int n_tiles, int bf16,
                   float count, float* partials, int n_partials, float* out,
                   void* stream) {
  if (reinterpret_cast<uintptr_t>(w_split) % 16) return static_cast<int>(cudaErrorInvalidValue);
  int ctas = 0;
  const uint32_t mask = static_cast<uint32_t>(live);
  cudaError_t err = curve_exact_ctas(n_tiles, bf16, mask, k, &ctas);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_partials < ctas * PAD) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const CurveInstance inst = curve_exact_instance(bf16, k);
  const auto kernel = inst.kernel;
  kernel<<<ctas, 128 * inst.wgs, curve_exact_smem(mask, bf16 ? 1 : SPLIT_PARTS), st>>>(
      make_seeds(s0, s1, s2), static_cast<const char*>(w_split), mask, k,
      n_tiles * WG_TILES_PER_TILE, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_kernel<<<k, REDUCE_THREADS, 0, st>>>(partials, ctas, PAD, c, nullptr, out, 1, count, 0);
  return static_cast<int>(cudaGetLastError());
}

// out (6): [sum X, sum Yc, sum X^2, sum Yc^2, sum X Yc, count]; partials
// holds n_partials floats (hw_zbc_partials), ticket one zeroed uint32 of
// the stream's own.
int hw_zbc_exact(int32_t s0, int32_t s1, int32_t s2, const float* consts_host,
                 int n_tiles, float count, float* partials, int n_partials,
                 void* ticket, float* out, void* stream) {
  return walk_launch(zbc_walk, s0, s1, s2, consts_host, n_tiles, count, partials, n_partials,
                     ticket, out, stream);
}

// out (2): [sum v, count]; partials and ticket as for hw_zbc_exact.
int hw_vega_exact(int32_t s0, int32_t s1, int32_t s2, const float* consts_host,
                  int n_tiles, float count, float* partials, int n_partials,
                  void* ticket, float* out, void* stream) {
  return walk_launch(vega_walk, s0, s1, s2, consts_host, n_tiles, count, partials, n_partials,
                     ticket, out, stream);
}

// out (2): [sum of delta terms over both legs, count]; consts_host (15);
// partials and ticket as for hw_zbc_exact.
int hw_delta_exact(int32_t s0, int32_t s1, int32_t s2, const float* consts_host,
                   int n_tiles, float count, float* partials, int n_partials,
                   void* ticket, float* out, void* stream) {
  return walk_launch(delta_walk, s0, s1, s2, consts_host, n_tiles, count, partials, n_partials,
                     ticket, out, stream);
}

// x1, x2: (n_tiles * TILE_OPT, PAD) float32 each, 16-byte aligned.
int hw_option_normals(int32_t s0, int32_t s1, int32_t s2, int n_tiles,
                      float* x1, float* x2, void* stream) {
  if (reinterpret_cast<uintptr_t>(x1) % 16 || reinterpret_cast<uintptr_t>(x2) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  int ctas = 0;
  const cudaError_t err = normals_ctas(n_tiles, &ctas);
  if (err != cudaSuccess) return static_cast<int>(err);
  option_normals_kernel<<<ctas, STORE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      make_seeds(s0, s1, s2), static_cast<uint32_t>(n_tiles) * STORE_UNITS_PER_TILE, x1, x2);
  return static_cast<int>(cudaGetLastError());
}

const char* hw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
