// Shared reduction pieces of the fused kernels: the fixed-order block sum,
// the second-pass reduce kernel, the same pass run by a kernel's last CTA
// (N sums per CTA, or a run-time count of rows), the persistent grid's
// size and the seed triple.
//
// The TPU kernels accumulate into one output block across a sequential
// grid.  Here blocks run in parallel in no order: each CTA writes its
// partial sums to a scratch buffer and reduce_kernel sums them in a fixed
// order.  No float atomics, so reruns are bitwise identical.
//
// Everything sits in an anonymous namespace: a kernel defined in one
// translation unit cannot be launched from another without -rdc, so each
// .cu that includes this header gets its own copy.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hw_device.cuh"

namespace {

constexpr int REDUCE_THREADS = 256;

// Fixed-order block sum of N values per thread; thread v < N of warp 0
// returns total v.  Deterministic: shuffle tree, then warps in order.
template <int N, int THREADS>
__device__ __forceinline__ void block_sum(float (&v)[N], float* out) {
  __shared__ float warp_part[N][THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = v[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xFFFFFFFFu, s, o);
    if (lane == 0) warp_part[i][warp] = s;
  }
  __syncthreads();
  if (threadIdx.x < N) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) s += warp_part[threadIdx.x][w];
    out[threadIdx.x] = s;
  }
}

// Second pass: out[out_off + v] = (sum_b part[b * stride + v]) * f_v with
// f_v = exp(-c[v]) when c is given (the exact curve's deterministic
// discount), scale[v] when scale is given (the full-step curve's e^{-c}),
// else 1; out[count_idx] = count.  One CTA per value, fixed summation
// order.
__global__ void __launch_bounds__(REDUCE_THREADS)
reduce_kernel(const float* __restrict__ part, int n_parts, int stride,
              const float* __restrict__ c, const float* __restrict__ scale,
              float* __restrict__ out, int out_off, float count,
              int count_idx) {
  const int v = blockIdx.x;
  float s[1] = {0.0f};
  for (int b = threadIdx.x; b < n_parts; b += REDUCE_THREADS)
    s[0] += part[static_cast<long long>(b) * stride + v];
  __shared__ float total;
  block_sum<1, REDUCE_THREADS>(s, &total);
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = total;
    if (c != nullptr) t = total * expf(-c[v]);
    else if (scale != nullptr) t = total * scale[v];
    out[out_off + v] = t;
    if (v == 0) out[count_idx] = count;
  }
}

// atomicAdd with acquire-release semantics at device scope: the release
// publishes what the calling warp wrote before it (ordered by __syncwarp),
// the acquire lets the last caller read what every earlier caller published.
__device__ __forceinline__ unsigned int atomic_add_acq_rel(unsigned int* p, unsigned int v) {
  unsigned int old;
  asm volatile("atom.acq_rel.gpu.add.u32 %0, [%1], %2;" : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

// The second pass inside the kernel, after block_sum<N, THREADS> wrote this
// CTA's N partials to part + N blockIdx.x (lanes < N of warp 0): warp 0
// takes a ticket, and the CTA that takes the last one sums all gridDim.x
// CTAs' partials in a fixed order (thread t: CTAs t, t + THREADS, ...; then
// block_sum) into out[0 .. N - 1], writes out[N] = count and puts the
// ticket back to 0 for the next launch on its stream.  The ticket is an
// integer, so which CTA ends last changes nothing in the sums: reruns stay
// bitwise equal.  Every thread of the CTA must reach the call.
template <int N, int THREADS>
__device__ __forceinline__ void last_cta_sums(const float* part, unsigned int* ticket,
                                              float count, float* __restrict__ out) {
  __shared__ bool last;
  if (threadIdx.x < 32) {
    __syncwarp();  // the partials' writers, before lane 0's release
    if (threadIdx.x == 0) last = atomic_add_acq_rel(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();  // after lane 0's acquire: the CTAs' partials are visible
  if (!last) return;
  float s[N];
#pragma unroll
  for (int v = 0; v < N; ++v) s[v] = 0.0f;
#pragma unroll 4
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += THREADS) {
#pragma unroll
    for (int v = 0; v < N; ++v) s[v] += __ldcg(part + static_cast<size_t>(b) * N + v);
  }
  block_sum<N, THREADS>(s, out);
  if (threadIdx.x == 0) {
    out[N] = count;
    *ticket = 0u;
  }
}

// The same second pass for n_rows partials per CTA, a run-time count, that
// every thread of the CTA may have written to part + n_rows blockIdx.x:
// each thread fences its writes before thread 0 takes the ticket.  The
// last CTA sums in a fixed order into out[1 .. n_rows] and writes out[0] =
// count: the CTAs are cut into G = min(THREADS / n_rows, THREADS / 32)
// (at least 1) consecutive runs, thread g n_rows + v sums row v over run g
// in CTA order (thread v takes rows v, v + THREADS, ... when G = 1), and
// thread v adds the runs in order, so more loads are in flight when the
// surface is small.  scratch: (THREADS / 32) n_rows floats of shared
// memory.  Every thread of the CTA must reach the call.
template <int THREADS>
__device__ __forceinline__ void last_cta_rows(const float* part, int n_rows,
                                              unsigned int* ticket, float count,
                                              float* __restrict__ out, float* scratch) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomic_add_acq_rel(ticket, 1u) == gridDim.x - 1;
  __syncthreads();  // after thread 0's acquire: the CTAs' partials are visible
  if (!last) return;
  const int n_parts = static_cast<int>(gridDim.x);
  int runs = THREADS / n_rows;
  runs = runs < 1 ? 1 : runs > THREADS / 32 ? THREADS / 32 : runs;
  const int per_run = (n_parts + runs - 1) / runs;
  for (int t = threadIdx.x; t < runs * n_rows; t += THREADS) {
    const int v = t % n_rows, g = t / n_rows;
    const int end = (g + 1) * per_run < n_parts ? (g + 1) * per_run : n_parts;
    float s = 0.0f;
#pragma unroll 8
    for (int b = g * per_run; b < end; ++b)
      s += __ldcg(part + static_cast<size_t>(b) * n_rows + v);
    scratch[g * n_rows + v] = s;
  }
  __syncthreads();
  for (int v = threadIdx.x; v < n_rows; v += THREADS) {
    float s = scratch[v];
    for (int g = 1; g < runs; ++g) s += scratch[g * n_rows + v];
    out[1 + v] = s;
  }
  if (threadIdx.x == 0) {
    out[0] = count;
    *ticket = 0u;
  }
}

// The persistent grid of a kernel: the CTAs of `threads` threads and `smem`
// bytes of dynamic shared memory that fit on the card at once (the
// occupancy query), at most `most`.  Above the default 48 KB it raises the
// kernel's shared-memory limit first.
template <typename Kernel>
cudaError_t persistent_ctas(Kernel kernel, int threads, int smem, long long most, int* ctas) {
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long fit = static_cast<long long>(per_sm) * sms;
  *ctas = static_cast<int>(most < fit ? most : fit);
  return cudaSuccess;
}

// Fields of launch_report's out, in order (utils/profile.py, LAUNCH_FIELDS).
constexpr int LAUNCH_FIELDS = 9;

// What the card reports of one launch of `kernel` with `threads` threads,
// `smem` bytes of dynamic shared memory and `grid` CTAs: out = [registers
// a thread, static shared bytes, local bytes a thread, max threads a CTA,
// threads a CTA, dynamic shared bytes, CTAs an SM (the occupancy query),
// CTAs of the grid, max dynamic shared bytes].  Above the default 48 KB it
// raises the kernel's shared-memory limit first, as the launch does.
template <typename Kernel>
cudaError_t launch_report(Kernel kernel, int threads, int smem, int grid, int* out) {
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncAttributes a;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, kernel);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  const int v[LAUNCH_FIELDS] = {a.numRegs, static_cast<int>(a.sharedSizeBytes),
                                static_cast<int>(a.localSizeBytes), a.maxThreadsPerBlock,
                                threads, smem, per_sm, grid, a.maxDynamicSharedSizeBytes};
  for (int i = 0; i < LAUNCH_FIELDS; ++i) out[i] = v[i];
  return cudaSuccess;
}

// The int32 triple of ops.rng.key_seed, reinterpreted as uint32 (the TPU
// kernels' int32 arithmetic wraps like uint32).
hw::Seeds make_seeds(int32_t s0, int32_t s1, int32_t s2) {
  return {static_cast<uint32_t>(s0), static_cast<uint32_t>(s1), static_cast<uint32_t>(s2)};
}

}  // namespace
