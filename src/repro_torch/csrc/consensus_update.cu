// Fused consensus updates (paper eq. 5, Algorithms 1-2) on packed float32
// (rows, 128) buckets, for Hopper (sm_90a).
//
// Dense form (the f32 / bf16 legacy wire: every neighbor, self included,
// arrives in one stack):
//   cdsgd_update:    out[a] = sum_s W[a,s] X[s] - alpha G[a]
//   cdmsgd_update:   v'     = mu V[a] - alpha G[a]
//                    out[a] = sum_s W[a,s] X[s] + v'
// W is (A_out, S), X is (S, rows, 128) float32 or bfloat16, G and V are
// (A_out, rows, 128) float32.
//
// Self-separated form (the quantized wire and the overlap schedule's carried
// wire: the self buffer never crosses the wire and stays native):
//   mix_q[a] = W[a,0] SELF[a] + sum_s W[a,1+s] (float(Q[s]) * SC[s, row])
//   cdsgd_update_q:  out[a] = mix_q[a] - alpha G[a]
//   cdmsgd_update_q: v' = mu V[a] - alpha G[a];  out[a] = mix_q[a] + v'
// W is (A_out, S+1), SELF is (A_out, rows, 128) float32, Q is the wire
// payload (S, rows, 128) in int8, float8_e4m3fn, bfloat16 or float32, SC its
// per-row scales (S, rows, 1) float32 (ones for bf16 / f32 payloads).
//
// The same kernels serve one agent's stencil (A_out = 1) and the stacked
// simulation (A_out = S = A, W = Pi or [diag(Pi) | zero-diag Pi], X / Q =
// the whole agent stack): one launch per bucket either way.  out is written
// into G's storage and v' into V's (the in-place contract of the JAX
// package's input_output_aliases).
//
// Replaces: src/repro/kernels/consensus_update/consensus_update.py
//   cdsgd_update_2d  (line 687; bodies _cdsgd_kernel, _cdsgd_kernel_q), and
//   cdmsgd_update_2d (line 729; bodies _cdmsgd_kernel, _cdmsgd_kernel_q).
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores): memory.  Per element and output the kernels do 2S+2 .. 3S+5
// flops against at least 4 (2 .. 4) bytes of G/V/SELF/out traffic, far
// below the ~20 flop/byte ridge.  At the training path's shape (A = S = 5,
// 16,941 rows): cdsgd_update 130.1 MB (~39 us) with f32 neighbors, 108.4 MB
// (~32 us) with bf16; cdsgd_update_q 141.3 MB (~42 us) with an int8
// payload, 152.1 MB (~45 us) bf16, 173.8 MB (~52 us) f32; cdmsgd_update_q
// 228.0 MB (~68 us) with int8.
//
// Design: one thread owns one float4 (4 lanes) of a row for all A_out
// outputs, so G, V and SELF are read once and written once with 16-byte
// coalesced accesses.  The neighbor / payload tile at that position is read
// from device memory by the first output and re-read for the others from
// L1/L2, so device-memory traffic stays at the least above.  A payload
// float4 position p lies in row p / 32, whose scale the thread loads once
// per stencil entry.  Payloads are converted to float32 exactly (int8 and
// bf16 by value, e4m3 through half), then scaled, weighted and summed in
// float32 in stencil order with explicit round-to-nearest multiplies and
// adds (no FMA contraction): the arithmetic of the Pallas bodies and of the
// plain PyTorch versions (ref.py), so kernel and plain version agree bit for
// bit.  A thread past the last float4 is masked, so any row count works.

#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
// payload / neighbor kinds: the wrapper's codes
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kI8 = 2;
constexpr int kFP8 = 3;

__device__ __forceinline__ float fp8_e4m3_to_float(uint32_t byte) {
  const __half_raw h =
      __nv_cvt_fp8_to_halfraw(static_cast<__nv_fp8_storage_t>(byte), __NV_E4M3);
  return __half2float(__half(h));
}

// the four elements of float4 position i of a (.., rows, 128) stack of kind K
template <int K>
__device__ __forceinline__ float4 load4(const void* base, long long i) {
  if constexpr (K == kF32) {
    return static_cast<const float4*>(base)[i];
  } else if constexpr (K == kBF16) {
    const uint2 u = static_cast<const uint2*>(base)[i];
    return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
  } else if constexpr (K == kI8) {
    const char4 c = static_cast<const char4*>(base)[i];
    return make_float4(static_cast<float>(c.x), static_cast<float>(c.y),
                       static_cast<float>(c.z), static_cast<float>(c.w));
  } else {
    const uint32_t u = static_cast<const uint32_t*>(base)[i];
    return make_float4(fp8_e4m3_to_float(u & 0xffu), fp8_e4m3_to_float((u >> 8) & 0xffu),
                       fp8_e4m3_to_float((u >> 16) & 0xffu), fp8_e4m3_to_float(u >> 24));
  }
}

__device__ __forceinline__ void axpy_rn(float4& acc, float w, const float4& x) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(w, x.x));
  acc.y = __fadd_rn(acc.y, __fmul_rn(w, x.y));
  acc.z = __fadd_rn(acc.z, __fmul_rn(w, x.z));
  acc.w = __fadd_rn(acc.w, __fmul_rn(w, x.w));
}

// sum_s w[s] * x[s * n4 + p], f32, stencil order, starting from +0.
template <int K>
__device__ __forceinline__ float4 mix(const float* __restrict__ w, const void* x,
                                      int s_count, long long n4, long long p) {
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < s_count; ++s) {
    axpy_rn(acc, w[s], load4<K>(x, s * n4 + p));
  }
  return acc;
}

// w[0] * self[p] + sum_s w[1+s] * (float(q[s * n4 + p]) * sc[s * rows + p / 32])
template <int K>
__device__ __forceinline__ float4 mix_q(const float* __restrict__ w,
                                        const float4* __restrict__ self, const void* q,
                                        const float* __restrict__ sc, int s_count,
                                        long long rows, long long n4, long long p) {
  const float4 sv = self[p];
  const float w0 = w[0];
  float4 acc = make_float4(__fmul_rn(w0, sv.x), __fmul_rn(w0, sv.y),
                           __fmul_rn(w0, sv.z), __fmul_rn(w0, sv.w));
  const long long row = p >> 5;
  for (int s = 0; s < s_count; ++s) {
    const float scale = sc[s * rows + row];
    const float4 d = load4<K>(q, s * n4 + p);
    axpy_rn(acc, w[1 + s],
            make_float4(__fmul_rn(d.x, scale), __fmul_rn(d.y, scale),
                        __fmul_rn(d.z, scale), __fmul_rn(d.w, scale)));
  }
  return acc;
}

// *g <- acc - alpha * g
__device__ __forceinline__ void sgd_out(float4 acc, float4* g, float alpha) {
  const float4 gv = *g;
  acc.x = __fsub_rn(acc.x, __fmul_rn(alpha, gv.x));
  acc.y = __fsub_rn(acc.y, __fmul_rn(alpha, gv.y));
  acc.z = __fsub_rn(acc.z, __fmul_rn(alpha, gv.z));
  acc.w = __fsub_rn(acc.w, __fmul_rn(alpha, gv.w));
  *g = acc;
}

// *v <- mu v - alpha g;  *g <- acc + v'
__device__ __forceinline__ void msgd_out(const float4& acc, float4* g, float4* v,
                                         float alpha, float mu) {
  const float4 gv = *g;
  const float4 vv = *v;
  float4 nv, out;
  nv.x = __fsub_rn(__fmul_rn(mu, vv.x), __fmul_rn(alpha, gv.x));
  nv.y = __fsub_rn(__fmul_rn(mu, vv.y), __fmul_rn(alpha, gv.y));
  nv.z = __fsub_rn(__fmul_rn(mu, vv.z), __fmul_rn(alpha, gv.z));
  nv.w = __fsub_rn(__fmul_rn(mu, vv.w), __fmul_rn(alpha, gv.w));
  out.x = __fadd_rn(acc.x, nv.x);
  out.y = __fadd_rn(acc.y, nv.y);
  out.z = __fadd_rn(acc.z, nv.z);
  out.w = __fadd_rn(acc.w, nv.w);
  *g = out;
  *v = nv;
}

template <int K>
__global__ void __launch_bounds__(kThreads)
cdsgd_kernel(const float* __restrict__ w, const void* x, float4* __restrict__ g,
             int a_out, int s_count, long long n4, float alpha) {
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= n4) return;
  for (int a = 0; a < a_out; ++a) {
    sgd_out(mix<K>(w + static_cast<long long>(a) * s_count, x, s_count, n4, p),
            g + a * n4 + p, alpha);
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
cdmsgd_kernel(const float* __restrict__ w, const void* x, float4* __restrict__ g,
              float4* __restrict__ v, int a_out, int s_count, long long n4,
              float alpha, float mu) {
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= n4) return;
  for (int a = 0; a < a_out; ++a) {
    msgd_out(mix<K>(w + static_cast<long long>(a) * s_count, x, s_count, n4, p),
             g + a * n4 + p, v + a * n4 + p, alpha, mu);
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
cdsgd_q_kernel(const float* __restrict__ w, const float4* __restrict__ self,
               const void* q, const float* __restrict__ sc, float4* __restrict__ g,
               int a_out, int s_count, long long rows, float alpha) {
  const long long n4 = rows * 32;
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= n4) return;
  for (int a = 0; a < a_out; ++a) {
    sgd_out(mix_q<K>(w + static_cast<long long>(a) * (s_count + 1), self + a * n4, q,
                     sc, s_count, rows, n4, p),
            g + a * n4 + p, alpha);
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
cdmsgd_q_kernel(const float* __restrict__ w, const float4* __restrict__ self,
                const void* q, const float* __restrict__ sc, float4* __restrict__ g,
                float4* __restrict__ v, int a_out, int s_count, long long rows,
                float alpha, float mu) {
  const long long n4 = rows * 32;
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= n4) return;
  for (int a = 0; a < a_out; ++a) {
    msgd_out(mix_q<K>(w + static_cast<long long>(a) * (s_count + 1), self + a * n4, q,
                      sc, s_count, rows, n4, p),
             g + a * n4 + p, v + a * n4 + p, alpha, mu);
  }
}

unsigned int blocks_for(long long n4) {
  return static_cast<unsigned int>((n4 + kThreads - 1) / kThreads);
}

// Select the device, then launch(k) with k the compile-time kind; returns
// the CUDA error of the selection or of the launch.
template <typename Launch>
int launch_kind(int kind, bool quantized_kinds, int device, Launch launch) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  switch (kind) {
    case kF32: launch(std::integral_constant<int, kF32>{}); break;
    case kBF16: launch(std::integral_constant<int, kBF16>{}); break;
    case kI8:
      if (!quantized_kinds) return static_cast<int>(cudaErrorInvalidValue);
      launch(std::integral_constant<int, kI8>{});
      break;
    case kFP8:
      if (!quantized_kinds) return static_cast<int>(cudaErrorInvalidValue);
      launch(std::integral_constant<int, kFP8>{});
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes.  device is the CUDA device ordinal
// the tensors live on (this library links its own CUDA runtime, so it
// selects the device itself); stream is PyTorch's current stream there.
// kind is the neighbor / payload type: 0 float32, 1 bfloat16, 2 int8,
// 3 float8_e4m3fn (the dense form takes 0 and 1 only).  n4 is the number
// of float4s per output buffer (rows * 32).  Pointers must be 16-byte
// aligned; X, Q, SELF and SC must not overlap G or V (the wrapper checks).
// Returns the CUDA error of the device selection or of the launch
// (0 = launched); a call with nothing to do launches nothing.
extern "C" int cdsgd_update(const float* w, const void* x, int kind, float* g,
                            int a_out, int s_count, long long n4, float alpha,
                            int device, void* stream) {
  if (n4 <= 0 || a_out <= 0) return 0;
  auto* g4 = reinterpret_cast<float4*>(g);
  auto st = static_cast<cudaStream_t>(stream);
  return launch_kind(kind, false, device, [&](auto k) {
    cdsgd_kernel<decltype(k)::value><<<blocks_for(n4), kThreads, 0, st>>>(
        w, x, g4, a_out, s_count, n4, alpha);
  });
}

extern "C" int cdmsgd_update(const float* w, const void* x, int kind, float* g,
                             float* v, int a_out, int s_count, long long n4,
                             float alpha, float mu, int device, void* stream) {
  if (n4 <= 0 || a_out <= 0) return 0;
  auto* g4 = reinterpret_cast<float4*>(g);
  auto* v4 = reinterpret_cast<float4*>(v);
  auto st = static_cast<cudaStream_t>(stream);
  return launch_kind(kind, false, device, [&](auto k) {
    cdmsgd_kernel<decltype(k)::value><<<blocks_for(n4), kThreads, 0, st>>>(
        w, x, g4, v4, a_out, s_count, n4, alpha, mu);
  });
}

extern "C" int cdsgd_update_q(const float* w, const float* self, const void* q,
                              int kind, const float* sc, float* g, int a_out,
                              int s_count, long long rows, float alpha, int device,
                              void* stream) {
  if (rows <= 0 || a_out <= 0) return 0;
  const auto* self4 = reinterpret_cast<const float4*>(self);
  auto* g4 = reinterpret_cast<float4*>(g);
  auto st = static_cast<cudaStream_t>(stream);
  return launch_kind(kind, true, device, [&](auto k) {
    cdsgd_q_kernel<decltype(k)::value><<<blocks_for(rows * 32), kThreads, 0, st>>>(
        w, self4, q, sc, g4, a_out, s_count, rows, alpha);
  });
}

extern "C" int cdmsgd_update_q(const float* w, const float* self, const void* q,
                               int kind, const float* sc, float* g, float* v,
                               int a_out, int s_count, long long rows, float alpha,
                               float mu, int device, void* stream) {
  if (rows <= 0 || a_out <= 0) return 0;
  const auto* self4 = reinterpret_cast<const float4*>(self);
  auto* g4 = reinterpret_cast<float4*>(g);
  auto* v4 = reinterpret_cast<float4*>(v);
  auto st = static_cast<cudaStream_t>(stream);
  return launch_kind(kind, true, device, [&](auto k) {
    cdmsgd_q_kernel<decltype(k)::value><<<blocks_for(rows * 32), kThreads, 0, st>>>(
        w, self4, q, sc, g4, v4, a_out, s_count, rows, alpha, mu);
  });
}
