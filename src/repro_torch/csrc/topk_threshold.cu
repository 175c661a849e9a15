// Magnitude-threshold histogram of packed float32 (rows, 128) buckets, for
// Hopper (sm_90a): one sweep that brackets the k-th largest |x| of a bucket.
//
//   counts[a, b] = #{ e : |X[a][e]| >= TAU[a, b] }     b = 0 .. n_bins-1
//
// X is (A, rows * 128) float32, one bucket of every agent, one launch;
// TAU is (A, n_bins) float32, the geometric thresholds amax_a * span^(b /
// (n_bins - 1)) that the wrapper computes (the reference computes amax, the
// thresholds and the final pick outside its Pallas call too); COUNTS is (A,
// n_bins) uint32, zeroed by the caller.  The wrapper picks the smallest tau
// whose count is <= k.
//
// Replaces: src/repro/kernels/consensus_update/topk.py
//   topk_threshold_2d (line 187; pallas_call line 218; body
//   _threshold_count_kernel, line 159).
//
// Counts are exact integers.  The TPU kernel sums them in float32, which
// is exact only below 2^24 elements per bucket; above that its counts
// round and these do not.
//
// Bound on an H100 SXM (3.35 TB/s): memory.  The sweep reads each element
// once (4 bytes) and does one compare and one add per bin (32 integer and
// compare operations per element at 16 bins), near the byte time.  At the
// training path's shape (A = 5, 16,941 rows): 43.37 MB, ~12.9 us.
//
// Design: a grid-stride loop over the agent's float4s (blockIdx.y is the
// agent), per-thread counters in registers for 16 bins, the reference's
// count (fewer bins pad with +inf thresholds, which no finite |x| reaches,
// so the loop needs no guard), a warp reduction (__reduce_add_sync), a
// block reduction in shared memory, and one atomicAdd per bin per block.
// Integer sums are exact in any order, so the result does not depend on
// the launch shape.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 16;
constexpr int kBlocksPerAgent = 264;    // two blocks per SM over 132 SMs

__global__ void __launch_bounds__(kThreads)
threshold_kernel(const float4* __restrict__ x, const float* __restrict__ taus,
                 unsigned int* __restrict__ counts, long long n4, int n_bins) {
  __shared__ float tau_s[kBins];
  __shared__ unsigned int part[kWarps][kBins];
  const int a = blockIdx.y;
  if (threadIdx.x < kBins) {
    tau_s[threadIdx.x] = threadIdx.x < n_bins ? taus[a * n_bins + threadIdx.x]
                                              : __int_as_float(0x7f800000);
  }
  __syncthreads();
  float tau[kBins];
  unsigned int c[kBins];
#pragma unroll
  for (int b = 0; b < kBins; ++b) {
    tau[b] = tau_s[b];
    c[b] = 0;
  }
  const float4* xa = x + a * n4;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; p < n4;
       p += stride) {
    const float4 v = xa[p];
    const float e0 = fabsf(v.x), e1 = fabsf(v.y), e2 = fabsf(v.z), e3 = fabsf(v.w);
#pragma unroll
    for (int b = 0; b < kBins; ++b) {
      c[b] += static_cast<unsigned int>(e0 >= tau[b]) + static_cast<unsigned int>(e1 >= tau[b]) +
              static_cast<unsigned int>(e2 >= tau[b]) + static_cast<unsigned int>(e3 >= tau[b]);
    }
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int b = 0; b < kBins; ++b) {
    const unsigned int s = __reduce_add_sync(0xffffffffu, c[b]);
    if (lane == 0) part[warp][b] = s;
  }
  __syncthreads();
  if (threadIdx.x < n_bins) {
    unsigned int s = 0;
    for (int w = 0; w < kWarps; ++w) s += part[w][threadIdx.x];
    if (s) atomicAdd(counts + a * n_bins + threadIdx.x, s);
  }
}

}  // namespace

// Plain C interface, loaded with ctypes.  x: (a_count, n4) float4s,
// 16-byte aligned; taus: (a_count, n_bins) float32; counts: (a_count,
// n_bins) uint32, zeroed by the caller.  1 <= n_bins <= 16.  Returns the
// CUDA error of the device selection or of the launch (0 = launched).
extern "C" int topk_threshold(const float* x, const float* taus, unsigned int* counts,
                              int a_count, long long n4, int n_bins, int device,
                              void* stream) {
  if (n_bins < 1 || n_bins > kBins) return static_cast<int>(cudaErrorInvalidValue);
  if (a_count <= 0 || n4 <= 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  long long blocks = (n4 + kThreads - 1) / kThreads;
  if (blocks > kBlocksPerAgent) blocks = kBlocksPerAgent;
  const dim3 grid(static_cast<unsigned int>(blocks), static_cast<unsigned int>(a_count));
  threshold_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), taus, counts, n4, n_bins);
  return static_cast<int>(cudaGetLastError());
}
