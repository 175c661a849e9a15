// Magnitude-threshold histogram of packed float32 (rows, 128) buckets, for
// Hopper (sm_90a): the whole top-k threshold function on the device.
//
//   amax[a]     = max_e |X[a][e]|
//   tau[a, b]   = f32(max(amax[a], 1e-30) * RATIO[b])      b = 0 .. n_bins-1
//   counts[a, b] = #{ e : |X[a][e]| >= tau[a, b] }
//   TAU[a]      = tau[a, max(#{b : counts[a, b] <= k} - 1, 0)]
//
// X is (A, rows * 128) float32, one bucket of every agent; RATIO the n_bins
// float32 ratios span^(b / (n_bins - 1)), rounded once on the host and
// passed by value.  Outputs: TAU (A,) and COUNTS (A, n_bins) as float32, as
// the reference returns them.  Per call: one memset of the scratch words
// (per-agent amax bits, integer counts, a ticket) and two launches.
//
// Replaces: src/repro/kernels/consensus_update/topk.py
//   topk_threshold_2d (line 187; pallas_call line 218; body
//   _threshold_count_kernel, line 159), and the amax, thresholds and pick
//   that the reference computes around its Pallas call.
//
// Counts are exact integers.  The TPU kernel sums them in float32, which
// is exact only below 2^24 elements per bucket; above that its counts
// round and these do not.  Every other value is the plain path's bit for
// bit: the max is exact in any order, each threshold is one __fmul_rn of
// the same operands, and the pick compares the exact counts.
//
// Bound on an H100 SXM (3.35 TB/s): memory.  The function reads X twice
// (amax, then the counts: the thresholds need amax first); the count
// sweep alone reads it once.  At the training path's shape (A = 5, 16,941
// rows): 43.37 MB, 12.95 us a read, 25.9 us for the function.
//
// Design.
//  - Both kernels run a resident grid (at most kBlocksPerSm blocks on each
//    SM, more only when a chunk would pass kMaxChunk) over all agents'
//    float4s as one range, cut into one contiguous chunk per block, so agent
//    boundaries fall inside chunks and no block idles at the tail of an
//    agent.  A block walks each agent's piece of its chunk with kUnroll
//    16-byte loads in flight per thread.
//  - amax: a warp max of the |x| bits (non-negative floats order as
//    unsigned integers; NaN stays NaN) and one atomicMax per warp and agent.
//  - counts: each block builds its agent's thresholds in ascending order u
//    in shared memory (16, padded with +inf), four groups of four and a
//    fifth of NaN.  An element compares with the four groups' tops (count
//    t[q] of each) and then with three thresholds of the one group it falls
//    in (read from shared memory; an element equal to tau_b counts for b),
//    seven compares instead of sixteen, and counts those three in byte q of
//    three packed words; #{|x| >= u[c - 1]} is t[q] plus byte q.  A thread
//    sees at most 252 elements of an agent (kMaxChunk), so a byte does not
//    overflow.  Warp sums (__reduce_add_sync), then one atomicAdd a bin and
//    block.  The loads of the next kUnroll float4s are issued before the
//    current ones are counted, and the first before amax is read.  The
//    sweep walks its chunk backwards, so it starts on the lines that the
//    amax sweep read last (still in L2).
//  - The last block to finish (an atomic ticket) writes the counts as
//    float32 and picks tau.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 16;
constexpr int kGroups = kBins / 4 + 1;   // four groups of thresholds, one of +inf
constexpr int kUnroll = 4;                // 16-byte loads in flight per thread
constexpr int kBlocksPerSm = 4;
constexpr long long kMaxChunk = 63LL * kThreads;   // float4s of a block: 252 elements a thread

struct Ratios {
  float r[kBins];
};

__device__ __forceinline__ unsigned abs_bits(float v) { return __float_as_uint(v) & 0x7fffffffu; }

// max(amax, 1e-30) as torch.maximum takes it: NaN propagates
__device__ __forceinline__ float floored(unsigned amax_bits) {
  const float a = __uint_as_float(amax_bits);
  return a != a ? a : fmaxf(a, 1e-30f);
}

// this block's contiguous chunk [start, end) of the total float4s
__device__ __forceinline__ void chunk(long long total, long long* start, long long* end) {
  const long long per = (total + gridDim.x - 1) / gridDim.x;
  *start = min(total, per * blockIdx.x);
  *end = min(total, *start + per);
}

__device__ __forceinline__ unsigned max4(float4 v) {
  return max(max(abs_bits(v.x), abs_bits(v.y)), max(abs_bits(v.z), abs_bits(v.w)));
}

__global__ void __launch_bounds__(kThreads)
threshold_amax_kernel(const float4* __restrict__ x, unsigned* __restrict__ amax_bits,
                      long long n4, long long total) {
  long long start, end;
  chunk(total, &start, &end);
  for (long long a = start / n4; a * n4 < end; ++a) {
    const long long s = max(start, a * n4), e = min(end, (a + 1) * n4);
    unsigned m = 0;
    long long p = s + threadIdx.x;
    for (; p + (kUnroll - 1) * kThreads < e; p += kUnroll * kThreads) {
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = x[p + u * kThreads];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) m = max(m, max4(v[u]));
    }
    for (; p < e; p += kThreads) m = max(m, max4(x[p]));
    m = __reduce_max_sync(0xffffffffu, m);
    if ((threadIdx.x & 31) == 0 && m) atomicMax(amax_bits + a, m);
  }
}

// A thread's counts for one agent.  u are the thresholds ascending, in four
// groups of four (u[4q + 3] tops group q); t[q] counts |x| >= u[4q + 3], and
// byte q of w[r] counts the elements of group q (u[4q - 1] <= |x| <
// u[4q + 3]) with |x| >= u[4q + r].
struct Counts {
  unsigned t[4] = {0, 0, 0, 0};
  unsigned w[3] = {0, 0, 0};
};

__device__ __forceinline__ void count1(float v, const float (&top)[4], const float4* groups,
                                       Counts& n) {
  const float e = fabsf(v);
  int q = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (e >= top[j]) {
      ++n.t[j];
      ++q;
    }
  }
  const float4 g = groups[q];              // group 4 is NaN: no compare holds
  const unsigned inc = 1u << (8 * q & 31);
  if (e >= g.x) n.w[0] += inc;
  if (e >= g.y) n.w[1] += inc;
  if (e >= g.z) n.w[2] += inc;
}

__device__ __forceinline__ void count4(float4 v, const float (&top)[4], const float4* groups,
                                       Counts& n) {
  count1(v.x, top, groups, n);
  count1(v.y, top, groups, n);
  count1(v.z, top, groups, n);
  count1(v.w, top, groups, n);
}

// scratch: amax bits (a_count), counts (a_count x kBins), the ticket
__global__ void __launch_bounds__(kThreads)
threshold_count_kernel(const float4* __restrict__ x, unsigned* __restrict__ scratch,
                       float* __restrict__ tau_out, float* __restrict__ counts_out, Ratios ratios,
                       int a_count, long long n4, long long total, int n_bins, long long k) {
  __shared__ unsigned warp_bins[kWarps][kBins + 1];
  __shared__ float4 groups[kGroups];
  __shared__ bool last;
  const unsigned* amax_bits = scratch;
  unsigned* counts = scratch + a_count;
  unsigned* ticket = counts + a_count * kBins;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  long long start, end;
  chunk(total, &start, &end);
  for (long long a = (end - 1) / n4; start < end && a * n4 + n4 > start; --a) {
    const long long s = max(start, a * n4), e = min(end, (a + 1) * n4);
    // the first loads are issued before the thresholds are built (they wait
    // for amax), and each iteration's loads before the previous ones count
    long long p = e - 1 - tid;             // backwards: the amax sweep's last lines first
    bool full = p - (kUnroll - 1) * kThreads >= s;
    float4 v[kUnroll];
    if (full) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = x[p - u * kThreads];
    }
    __syncthreads();                       // the previous piece's sums are read
    if (tid < 4 * kGroups) {               // ascending: tau_{n_bins-1} first
      const int b = n_bins - 1 - tid;
      reinterpret_cast<float*>(groups)[tid] =
          tid >= 4 * (kGroups - 1) ? __int_as_float(0x7fc00000)
          : b >= 0                 ? __fmul_rn(floored(amax_bits[a]), ratios.r[b])
                                   : __int_as_float(0x7f800000);
    }
    __syncthreads();
    const float top[4] = {groups[0].w, groups[1].w, groups[2].w, groups[3].w};
    // a thread sees at most kMaxChunk / kThreads float4s (252 elements):
    // its byte counters do not overflow
    Counts n;
    while (full) {
      const long long next = p - kUnroll * kThreads;
      const bool next_full = next - (kUnroll - 1) * kThreads >= s;
      float4 nv[kUnroll];
      if (next_full) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) nv[u] = x[next - u * kThreads];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) count4(v[u], top, groups, n);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = nv[u];
      p = next;
      full = next_full;
    }
    for (; p >= s; p -= kThreads) count4(x[p], top, groups, n);
    // N_c = #{|x| >= u[c - 1]}: t[q] for c = 4q + 4, t[q] + byte q of w[r]
    // for c = 4q + 1 + r
#pragma unroll
    for (int c = 1; c <= kBins; ++c) {
      const int q = (c - 1) / 4, r = (c - 1) % 4;
      const unsigned mine = n.t[q] + (r < 3 ? (n.w[r < 3 ? r : 0] >> (8 * q)) & 0xffu : 0u);
      const unsigned sum = __reduce_add_sync(0xffffffffu, mine);
      if (lane == 0) warp_bins[warp][c] = sum;
    }
    __syncthreads();
    if (tid < n_bins) {
      unsigned sum = 0;                    // counts[b] = N_{n_bins - b}
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += warp_bins[w][n_bins - tid];
      if (sum) atomicAdd(counts + a * kBins + tid, sum);
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = tid; i < a_count * n_bins; i += kThreads) {
    counts_out[i] = __uint2float_rn(__ldcg(counts + (i / n_bins) * kBins + i % n_bins));
  }
  for (int a = tid; a < a_count; a += kThreads) {
    int ok = 0;
    for (int b = 0; b < n_bins; ++b) {
      ok += static_cast<long long>(__ldcg(counts + a * kBins + b)) <= k;
    }
    tau_out[a] = __fmul_rn(floored(__ldcg(amax_bits + a)), ratios.r[ok > 0 ? ok - 1 : 0]);
  }
}

// blocks resident on `device` at once, at most kBlocksPerSm an SM (cached
// per device: the SM count and the occupancy do not change in a process)
cudaError_t resident_blocks(int device, long long* out) {
  static long long cached[64] = {};
  if (device >= 0 && device < 64 && cached[device] > 0) {
    *out = cached[device];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, threshold_count_kernel, kThreads,
                                                      0);
  if (err != cudaSuccess) return err;
  per_sm = per_sm < 1 ? 1 : per_sm > kBlocksPerSm ? kBlocksPerSm : per_sm;
  *out = static_cast<long long>(sms) * per_sm;
  if (device >= 0 && device < 64) cached[device] = *out;
  return cudaSuccess;
}

}  // namespace

// Plain C interface, loaded with ctypes.  x: (a_count, n4) float4s, 16-byte
// aligned; ratios: n_bins host floats, passed to the kernel by value; tau
// (a_count,) and counts (a_count, n_bins) float32 outputs; scratch:
// a_count * 17 + 1 uint32 words, zeroed here.  1 <= n_bins <= 16.  Returns
// the CUDA error of the device selection, the memset or the launches (0 =
// launched).
extern "C" int topk_threshold(const float* x, const float* ratios, float* tau, float* counts,
                              unsigned* scratch, int a_count, long long n4, int n_bins,
                              long long k, int device, void* stream) {
  if (n_bins < 1 || n_bins > kBins) return static_cast<int>(cudaErrorInvalidValue);
  if (a_count <= 0 || n4 <= 0) return 0;
  int current = -1;  // make device current unless it already is
  if (cudaGetDevice(&current) != cudaSuccess || current != device) {
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return static_cast<int>(set);
  }
  Ratios r;
  for (int b = 0; b < kBins; ++b) r.r[b] = b < n_bins ? ratios[b] : 0.0f;
  long long resident = 0;
  cudaError_t err = resident_blocks(device, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(a_count) * n4;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > resident) blocks = resident;
  if (blocks < (total + kMaxChunk - 1) / kMaxChunk) blocks = (total + kMaxChunk - 1) / kMaxChunk;
  auto st = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(scratch, 0, sizeof(unsigned) * (a_count * (1 + kBins) + 1), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto grid = static_cast<unsigned>(blocks);
  threshold_amax_kernel<<<grid, kThreads, 0, st>>>(reinterpret_cast<const float4*>(x), scratch,
                                                   n4, total);
  threshold_count_kernel<<<grid, kThreads, 0, st>>>(reinterpret_cast<const float4*>(x), scratch,
                                                    tau, counts, r, a_count, n4, total, n_bins, k);
  return static_cast<int>(cudaGetLastError());
}
