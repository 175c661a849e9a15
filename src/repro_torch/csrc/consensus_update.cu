// Fused consensus updates (paper eq. 5, Algorithms 1-2) on packed float32
// (rows, 128) buckets, for Hopper (sm_90a).
//
//   cdsgd_update:   out[a] = sum_s W[a,s] X[s] - alpha G[a]
//   cdmsgd_update:  v'     = mu V[a] - alpha G[a]
//                   out[a] = sum_s W[a,s] X[s] + v'
//
// W is (A_out, S), X is (S, rows, 128), G and V are (A_out, rows, 128).
// The same kernel serves the one-agent stencil form (A_out = 1, W = one
// agent's S neighbor weights) and the stacked simulation (A_out = S = A,
// W = Pi, X = the whole agent stack): one launch per bucket either way.
// out is written into G's storage and v' into V's (the in-place contract of
// the JAX package's input_output_aliases).
//
// Replaces: src/repro/kernels/consensus_update/consensus_update.py
//   cdsgd_update_2d  (line 687; body _cdsgd_kernel / _mix_stencil), and
//   cdmsgd_update_2d (line 729; body _cdmsgd_body), unquantized forms.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores): memory.  Per element and output the kernel does 2S+2 (cdsgd) or
// 2S+4 (cdmsgd) flops against at least 4 (S/A_out + 2) bytes, far below the
// ~20 flop/byte ridge.  At the training path's shape (A = S = 5, 16,941
// rows) the least traffic is X, G read once and out written once: 130.1 MB,
// ~39 us for cdsgd; X, G, V read and out, V' written: 216.8 MB, ~65 us for
// cdmsgd.
//
// Design: one thread owns one float4 (4 lanes) of a row for all A_out
// outputs, so G and V are read once and written once with 16-byte
// coalesced accesses.  The neighbor tile X[s][p] is read from device memory
// by the first output and re-read for the others from L1/L2 (the same
// thread touches it again within a few instructions), so device-memory
// traffic stays at the least above; a shared-memory copy of the S tiles
// would trade those cache hits for a barrier and is left for later work.
// The sum runs in float32 in stencil order s = 0..S-1 from zero with
// explicit round-to-nearest multiplies and adds (no FMA contraction), the
// arithmetic of the Pallas kernel and of the plain PyTorch version (ref.py).
// A thread past the last float4 is masked, so any row count works.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void axpy_rn(float4& acc, float w, const float4& x) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(w, x.x));
  acc.y = __fadd_rn(acc.y, __fmul_rn(w, x.y));
  acc.z = __fadd_rn(acc.z, __fmul_rn(w, x.z));
  acc.w = __fadd_rn(acc.w, __fmul_rn(w, x.w));
}

// sum_s w[s] * x[s * n4 + p], f32, stencil order, starting from +0.
__device__ __forceinline__ float4 mix(const float* __restrict__ w,
                                      const float4* __restrict__ x,
                                      int s_count, long long n4, long long p) {
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < s_count; ++s) {
    axpy_rn(acc, w[s], x[s * n4 + p]);
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
cdsgd_kernel(const float* __restrict__ w, const float4* __restrict__ x,
             float4* __restrict__ g, int a_out, int s_count, long long n4,
             float alpha) {
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= n4) return;
  for (int a = 0; a < a_out; ++a) {
    float4 acc = mix(w + static_cast<long long>(a) * s_count, x, s_count, n4, p);
    float4* ga = g + a * n4 + p;
    const float4 gv = *ga;
    acc.x = __fsub_rn(acc.x, __fmul_rn(alpha, gv.x));
    acc.y = __fsub_rn(acc.y, __fmul_rn(alpha, gv.y));
    acc.z = __fsub_rn(acc.z, __fmul_rn(alpha, gv.z));
    acc.w = __fsub_rn(acc.w, __fmul_rn(alpha, gv.w));
    *ga = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
cdmsgd_kernel(const float* __restrict__ w, const float4* __restrict__ x,
              float4* __restrict__ g, float4* __restrict__ v, int a_out,
              int s_count, long long n4, float alpha, float mu) {
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= n4) return;
  for (int a = 0; a < a_out; ++a) {
    const float4 acc = mix(w + static_cast<long long>(a) * s_count, x, s_count, n4, p);
    float4* ga = g + a * n4 + p;
    float4* va = v + a * n4 + p;
    const float4 gv = *ga;
    const float4 vv = *va;
    float4 nv, out;
    nv.x = __fsub_rn(__fmul_rn(mu, vv.x), __fmul_rn(alpha, gv.x));
    nv.y = __fsub_rn(__fmul_rn(mu, vv.y), __fmul_rn(alpha, gv.y));
    nv.z = __fsub_rn(__fmul_rn(mu, vv.z), __fmul_rn(alpha, gv.z));
    nv.w = __fsub_rn(__fmul_rn(mu, vv.w), __fmul_rn(alpha, gv.w));
    out.x = __fadd_rn(acc.x, nv.x);
    out.y = __fadd_rn(acc.y, nv.y);
    out.z = __fadd_rn(acc.z, nv.z);
    out.w = __fadd_rn(acc.w, nv.w);
    *ga = out;
    *va = nv;
  }
}

unsigned int blocks_for(long long n4) {
  return static_cast<unsigned int>((n4 + kThreads - 1) / kThreads);
}

}  // namespace

// Plain C interface, loaded with ctypes.  device is the CUDA device
// ordinal the tensors live on (this library links its own CUDA runtime, so
// it selects the device itself); stream is PyTorch's current stream there.
// n4 is the number of float4s per output buffer (rows * 32).  Pointers must
// be 16-byte aligned, X must not overlap G or V (the wrapper checks).
// Returns the CUDA error of the device selection or of the launch (0 =
// launched); a call with nothing to do launches nothing.
extern "C" int cdsgd_update_f32(const float* w, const float* x, float* g,
                                int a_out, int s_count, long long n4,
                                float alpha, int device, void* stream) {
  if (n4 <= 0 || a_out <= 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cdsgd_kernel<<<blocks_for(n4), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      w, reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(g),
      a_out, s_count, n4, alpha);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cdmsgd_update_f32(const float* w, const float* x, float* g,
                                 float* v, int a_out, int s_count, long long n4,
                                 float alpha, float mu, int device,
                                 void* stream) {
  if (n4 <= 0 || a_out <= 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cdmsgd_kernel<<<blocks_for(n4), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      w, reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(g),
      reinterpret_cast<float4*>(v), a_out, s_count, n4, alpha, mu);
  return static_cast<int>(cudaGetLastError());
}
