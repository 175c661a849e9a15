// Fused consensus updates (paper eq. 5, Algorithms 1-2) on packed (rows,
// 128) parameter buckets, for Hopper (sm_90a).
//
// Dense form (the f32 / bf16 legacy wire: every neighbor, self included,
// arrives in one stack):
//   cdsgd_update:    out[a] = sum_s W[a,s] X[s] - alpha G[a]
//   cdmsgd_update:   v'     = mu V[a] - alpha G[a]
//                    out[a] = sum_s W[a,s] X[s] + v'
// W is (A_out, S), X is (S, rows, 128) float32 or bfloat16, G and V are
// (A_out, rows, 128) in the bucket's type (see "Bucket types" below).
//
// Self-separated form (the quantized wire and the overlap schedule's carried
// wire: the self buffer never crosses the wire and stays native):
//   mix_q[a] = W[a,0] SELF[a] + sum_s W[a,1+s] (float(Q[s]) * SC[s, row])
//   cdsgd_update_q:  out[a] = mix_q[a] - alpha G[a]
//   cdmsgd_update_q: v' = mu V[a] - alpha G[a];  out[a] = mix_q[a] + v'
// W is (A_out, S+1), SELF is (A_out, rows, 128) in the bucket's type, Q is
// the wire payload (S, rows, 128) in int8, float8_e4m3fn, bfloat16 or
// float32, SC its per-row scales (S, rows, 1) float32 (ones for bf16 / f32
// payloads).
//
// Bucket types.  Every form takes a float32 or a bfloat16 bucket (G, SELF
// and every state and output buffer of one type, a template parameter B):
// a bf16 element is widened exactly, the float32 expression above runs
// unchanged (same _rn operations, same stencil order), and each output is
// rounded once to bf16, to nearest even (__float2bfloat16_rn), as the Pallas
// bodies store float32 results into out_ref.dtype.  An output that another
// output's expression uses (Nesterov's x' and v' in LOOK, Adam's m' and v'
// in out) enters it unrounded, as in the Pallas bodies.
//
// Mixed-momentum form (_qm: the momentum buffer rode the wire too, as a
// second payload VQ / VSC of the same type; the local momentum is its self
// tile at W[a,0]):
//   cdmsgd_update_qm: v' = mu mix_q(V; VQ, VSC)[a] - alpha G[a]
//                     out[a] = mix_q[a] + v'
//
// Nesterov (Algorithm 3) and CDAdam, in the dense, _q and _qm forms:
//   cdmsgd_nesterov_update*: as cdmsgd, and LOOK[a] = out[a] + mu v'
//     (the next step's lookahead point, a new output buffer);
//   cdadam_update*: m' = b1 M[a] + (1 - b1) G[a]     (_qm: b1 mix_q(M; ..))
//                   v' = b2 V[a] + ((1 - b2) G[a]) G[a]
//                   out[a] = mix - alpha ((m' / bc1) / (sqrt(v' / bc2) + eps)),
//     its divisions taken as m' / (bc1 (sqrt(v' / bc2) + eps)), the form XLA
//     compiles the Pallas body's expression into,
//     with the scalars alpha, b1, b2, eps, bc1 = 1 - b1^t, bc2 = 1 - b2^t
//     passed in float32 (the Pallas kernel's packed scal operand).
//
// The same kernels serve one agent's stencil (A_out = 1) and the stacked
// simulation (A_out = S = A, W = Pi or [diag(Pi) | zero-diag Pi], X / Q =
// the whole agent stack): one launch per bucket either way.  out is written
// into G's storage, v' into V's and m' into M's (the in-place contract of
// the JAX package's input_output_aliases); LOOK is the one new buffer.
//
// Replaces: src/repro/kernels/consensus_update/consensus_update.py
//   cdsgd_update_2d  (line 687; bodies _cdsgd_kernel, _cdsgd_kernel_q),
//   cdmsgd_update_2d (line 729; bodies _cdmsgd_kernel, _cdmsgd_kernel_q,
//                     _cdmsgd_kernel_qm),
//   cdmsgd_nesterov_update_2d (line 783; _cdmsgd_nesterov_kernel{,_q,_qm}),
//   cdadam_update_2d (line 842; _cdadam_kernel{,_q,_qm}),
//   and the sparse operand form of the top-k wire (*_update_sparse below):
//   cdsgd_update_sparse_2d (line 507), cdmsgd_update_sparse_2d (545),
//   cdmsgd_nesterov_update_sparse_2d (590), cdadam_update_sparse_2d (636),
//   bodies _cdsgd_kernel_s & co. over _sparse_stencil (line 219).
//
// The sparse forms are bound by the same dense traffic (SELF, G, V, out):
// the compact stacks are k_rows / rows of a payload (547,400 B at topk:0.01
// for A = S = 5), so at the path shape cdsgd_update_sparse moves 130.65 MB
// (~39.0 us), cdmsgd 217.39 MB (~64.9 us), Nesterov 260.76 MB (~77.8 us),
// CDAdam 304.13 MB (~90.8 us).  The TPU kernel masks out-of-block indices
// because it cannot scatter; here each block binary-searches its range of
// every neighbour's sorted indices and scatters into shared memory.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores): memory.  Per element and output the kernels do 2S+2 .. 3S+5
// flops against at least 4 (2 .. 4) bytes of G/V/SELF/out traffic, far
// below the ~20 flop/byte ridge.  At the training path's shape (A = S = 5,
// 16,941 rows): cdsgd_update 130.1 MB (~39 us) with f32 neighbors, 108.4 MB
// (~32 us) with bf16; cdsgd_update_q 141.3 MB (~42 us) with an int8
// payload, 152.1 MB (~45 us) bf16, 173.8 MB (~52 us) f32; cdmsgd_update_q
// 228.0 MB (~68 us) with int8; cdmsgd_update_qm 239.2 MB (~71 us) int8,
// 304.3 MB (~91 us) with an f32 payload; cdmsgd_nesterov_update 260.2 MB
// (~78 us) f32, _q 271.4 MB (~81 us) and _qm 282.6 MB (~84 us) int8, 347.7
// MB (~104 us) f32 payload; cdadam_update 303.6 MB (~91 us) f32, _q 314.8
// MB (~94 us) and _qm 325.9 MB (~97 us) int8, 391.0 MB (~117 us) f32
// payload.  Adam's divisions and square root (about 30 flops per element
// with the mix) stay far under the f32 rate.  At gemma3-1b's bf16 bucket (A = S = 4,
// 7,811,037 rows: 2 bytes per element of X, G, V, SELF and the outputs):
// cdsgd_update 24.00 GB (~7.16 ms), cdmsgd_update 39.99 GB (~11.94 ms),
// cdsgd_update_q with an int8 payload 28.12 GB (~8.39 ms), cdmsgd_update_q
// 44.12 GB (~13.17 ms).
//
// Design (dense, _q and sparse forms): one thread owns one float4 (4 lanes)
// of a row for all A_out outputs, so G, V and SELF are read once and
// written once with 16-byte coalesced accesses.  The neighbor / payload
// tile at that position is read from device memory by the first output and
// re-read for the others from L1/L2, so device-memory traffic stays at the
// least above.  A payload float4 position p lies in row p / 32, whose scale
// the thread loads once per stencil entry.  Payloads are converted to
// float32 exactly (int8 and bf16 by value, e4m3 through half), then scaled,
// weighted and summed in float32 in stencil order with explicit
// round-to-nearest multiplies and adds (no FMA contraction): the arithmetic
// of the Pallas bodies and of the plain PyTorch versions (ref.py), so
// kernel and plain version agree bit for bit; Adam divides with __fdiv_rn
// and takes __fsqrt_rn, the correctly rounded operations.  A thread past
// the last float4 is masked, so any row count works.  The _qm form reads
// two payloads per output and loops the other way round (see qm_tiles):
// with f32 payloads the per-output re-reads no longer fit L1.

#include <cuda_bf16.h>
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

__device__ __forceinline__ float4 scale4(float w, const float4& x) {
  return make_float4(__fmul_rn(w, x.x), __fmul_rn(w, x.y), __fmul_rn(w, x.z),
                     __fmul_rn(w, x.w));
}

// float(q[s * n4 + p]) * sc[s * rows + p / 32]: float4 position p of payload
// stack s, dequantized
template <int K>
__device__ __forceinline__ float4 dequant(const void* __restrict__ q,
                                          const float* __restrict__ sc, int s,
                                          long long rows, long long n4, long long p) {
  return scale4(sc[s * rows + (p >> 5)], load4<K>(q, s * n4 + p));
}

// a bucket's two float32 values as one word of two bfloat16s, each rounded
// to nearest even (x in the low half: the first element at the lower address)
__device__ __forceinline__ uint32_t bf16x2_rn(float x, float y) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x))) |
         static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(y))) << 16;
}

// store float4 position i of a bucket of type B (float32, or rounded once
// to bfloat16)
template <int B>
__device__ __forceinline__ void store4(void* base, long long i, const float4& x) {
  if constexpr (B == kF32) {
    static_cast<float4*>(base)[i] = x;
  } else {
    static_cast<uint2*>(base)[i] = make_uint2(bf16x2_rn(x.x, x.y), bf16x2_rn(x.z, x.w));
  }
}

// w[0] * self[si] + sum_s w[1+s] * (float(q[s * n4 + p]) * sc[s * rows + p / 32]),
// self a bucket of type B read at float4 position si
template <int K, int B = kF32>
__device__ __forceinline__ float4 mix_q(const float* __restrict__ w,
                                        const void* __restrict__ self, long long si,
                                        const void* q,
                                        const float* __restrict__ sc, int s_count,
                                        long long rows, long long n4, long long p) {
  float4 acc = scale4(w[0], load4<B>(self, si));
  for (int s = 0; s < s_count; ++s) {
    axpy_rn(acc, w[1 + s], dequant<K>(q, sc, s, rows, n4, p));
  }
  return acc;
}

// acc - alpha * gv
__device__ __forceinline__ float4 sgd_step(float4 acc, const float4& gv, float alpha) {
  acc.x = __fsub_rn(acc.x, __fmul_rn(alpha, gv.x));
  acc.y = __fsub_rn(acc.y, __fmul_rn(alpha, gv.y));
  acc.z = __fsub_rn(acc.z, __fmul_rn(alpha, gv.z));
  acc.w = __fsub_rn(acc.w, __fmul_rn(alpha, gv.w));
  return acc;
}

// mu vin - alpha g
__device__ __forceinline__ float4 mom_step(const float4& vin, const float4& gv,
                                           float alpha, float mu) {
  return make_float4(__fsub_rn(__fmul_rn(mu, vin.x), __fmul_rn(alpha, gv.x)),
                     __fsub_rn(__fmul_rn(mu, vin.y), __fmul_rn(alpha, gv.y)),
                     __fsub_rn(__fmul_rn(mu, vin.z), __fmul_rn(alpha, gv.z)),
                     __fsub_rn(__fmul_rn(mu, vin.w), __fmul_rn(alpha, gv.w)));
}

__device__ __forceinline__ float4 add4(const float4& a, const float4& b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

struct AdamScalars {
  float alpha, b1, b2, eps, bc1, bc2;
};

__device__ __forceinline__ float adam_lane(float acc, float m_in, float gv, float vv,
                                           const AdamScalars& c, float* nm, float* nv) {
  const float m = __fadd_rn(__fmul_rn(c.b1, m_in), __fmul_rn(__fsub_rn(1.f, c.b1), gv));
  const float v = __fadd_rn(__fmul_rn(c.b2, vv),
                            __fmul_rn(__fmul_rn(__fsub_rn(1.f, c.b2), gv), gv));
  // (m / bc1) / (sqrt(v / bc2) + eps) as XLA compiles the Pallas body: its
  // simplifier folds (A / B) / C into A / (B * C)
  const float dir = __fdiv_rn(m, __fmul_rn(c.bc1, __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c.bc2)),
                                                            c.eps)));
  *nm = m;
  *nv = v;
  return __fsub_rn(acc, __fmul_rn(c.alpha, dir));
}

// The epilogues.  Outputs are buckets of type B written at float4 position
// i, each computed in float32 and rounded once (store4<B>); every output is
// computed from the unrounded float32 values, as the Pallas bodies compute
// theirs before the stores.  gv is G's tile, vin V's (or the momentum mix).
// CDSGD: g <- acc - alpha gv
template <int B>
__device__ __forceinline__ void sgd_out(const float4& acc, const float4& gv, void* g,
                                        long long i, float alpha) {
  store4<B>(g, i, sgd_step(acc, gv, alpha));
}

// CDMSGD: v <- v' = mu vin - alpha gv;  g <- acc + v'
template <int B>
__device__ __forceinline__ void msgd_out(const float4& acc, const float4& vin,
                                         const float4& gv, void* g, void* v, long long i,
                                         float alpha, float mu) {
  const float4 nv = mom_step(vin, gv, alpha, mu);
  store4<B>(g, i, add4(acc, nv));
  store4<B>(v, i, nv);
}

// Nesterov: msgd_out, and look <- (acc + v') + mu v' (from the float32 x'
// and v', not from their rounded stores)
template <int B>
__device__ __forceinline__ void nesterov_out(const float4& acc, const float4& vin,
                                             const float4& gv, void* g, void* v, void* look,
                                             long long i, float alpha, float mu) {
  const float4 nv = mom_step(vin, gv, alpha, mu);
  const float4 x = add4(acc, nv);
  store4<B>(g, i, x);
  store4<B>(v, i, nv);
  store4<B>(look, i, add4(x, scale4(mu, nv)));
}

// CDAdam: m <- b1 m_in + (1-b1) gv;  v <- b2 vv + ((1-b2) gv) gv;
// g <- acc - alpha ((m'/bc1) / (sqrt(v'/bc2) + eps))  (m_in: M's tile, or
// its mix; vv: V's tile)
template <int B>
__device__ __forceinline__ void adam_out(const float4& acc, const float4& m_in,
                                         const float4& gv, const float4& vv, void* g, void* m,
                                         void* v, long long i, const AdamScalars& c) {
  float4 out, nm, nv;
  out.x = adam_lane(acc.x, m_in.x, gv.x, vv.x, c, &nm.x, &nv.x);
  out.y = adam_lane(acc.y, m_in.y, gv.y, vv.y, c, &nm.y, &nv.y);
  out.z = adam_lane(acc.z, m_in.z, gv.z, vv.z, c, &nm.z, &nv.z);
  out.w = adam_lane(acc.w, m_in.w, gv.w, vv.w, c, &nm.w, &nv.w);
  store4<B>(g, i, out);
  store4<B>(m, i, nm);
  store4<B>(v, i, nv);
}

template <int K, int B>
__global__ void __launch_bounds__(kThreads)
cdsgd_kernel(const float* __restrict__ w, const void* x, void* __restrict__ g,
             int a_out, int s_count, long long n4, float alpha) {
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= n4) return;
  for (int a = 0; a < a_out; ++a) {
    const long long i = a * n4 + p;
    sgd_out<B>(mix<K>(w + static_cast<long long>(a) * s_count, x, s_count, n4, p),
               load4<B>(g, i), g, i, alpha);
  }
}

template <int K, int B>
__global__ void __launch_bounds__(kThreads)
cdmsgd_kernel(const float* __restrict__ w, const void* x, void* __restrict__ g,
              void* __restrict__ v, int a_out, int s_count, long long n4, float alpha,
              float mu) {
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= n4) return;
  for (int a = 0; a < a_out; ++a) {
    const long long i = a * n4 + p;
    msgd_out<B>(mix<K>(w + static_cast<long long>(a) * s_count, x, s_count, n4, p),
                load4<B>(v, i), load4<B>(g, i), g, v, i, alpha, mu);
  }
}

template <int K, int B>
__global__ void __launch_bounds__(kThreads)
cdsgd_q_kernel(const float* __restrict__ w, const void* __restrict__ self, const void* q,
               const float* __restrict__ sc, void* __restrict__ g, int a_out,
               int s_count, long long rows, float alpha) {
  const long long n4 = rows * 32;
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= n4) return;
  for (int a = 0; a < a_out; ++a) {
    const long long i = a * n4 + p;
    sgd_out<B>(mix_q<K, B>(w + static_cast<long long>(a) * (s_count + 1), self, i, q, sc,
                           s_count, rows, n4, p),
               load4<B>(g, i), g, i, alpha);
  }
}

template <int K, int B>
__global__ void __launch_bounds__(kThreads)
cdmsgd_q_kernel(const float* __restrict__ w, const void* __restrict__ self,
                const void* q, const float* __restrict__ sc, void* __restrict__ g,
                void* __restrict__ v, int a_out, int s_count, long long rows, float alpha,
                float mu) {
  const long long n4 = rows * 32;
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= n4) return;
  for (int a = 0; a < a_out; ++a) {
    const long long i = a * n4 + p;
    msgd_out<B>(mix_q<K, B>(w + static_cast<long long>(a) * (s_count + 1), self, i, q,
                            sc, s_count, rows, n4, p),
                load4<B>(v, i), load4<B>(g, i), g, v, i, alpha, mu);
  }
}

template <int K, int B>
__global__ void __launch_bounds__(kThreads)
nesterov_kernel(const float* __restrict__ w, const void* x, void* __restrict__ g,
                void* __restrict__ v, void* __restrict__ look, int a_out, int s_count,
                long long n4, float alpha, float mu) {
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= n4) return;
  for (int a = 0; a < a_out; ++a) {
    const long long i = a * n4 + p;
    nesterov_out<B>(mix<K>(w + static_cast<long long>(a) * s_count, x, s_count, n4, p),
                    load4<B>(v, i), load4<B>(g, i), g, v, look, i, alpha, mu);
  }
}

template <int K, int B>
__global__ void __launch_bounds__(kThreads)
nesterov_q_kernel(const float* __restrict__ w, const void* __restrict__ self,
                  const void* q, const float* __restrict__ sc, void* __restrict__ g,
                  void* __restrict__ v, void* __restrict__ look, int a_out, int s_count,
                  long long rows, float alpha, float mu) {
  const long long n4 = rows * 32;
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= n4) return;
  for (int a = 0; a < a_out; ++a) {
    const long long i = a * n4 + p;
    nesterov_out<B>(mix_q<K, B>(w + static_cast<long long>(a) * (s_count + 1), self, i, q,
                                sc, s_count, rows, n4, p),
                    load4<B>(v, i), load4<B>(g, i), g, v, look, i, alpha, mu);
  }
}

template <int K, int B>
__global__ void __launch_bounds__(kThreads)
adam_kernel(const float* __restrict__ w, const void* x, void* __restrict__ g,
            void* __restrict__ m, void* __restrict__ v, int a_out, int s_count,
            long long n4, AdamScalars c) {
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= n4) return;
  for (int a = 0; a < a_out; ++a) {
    const long long i = a * n4 + p;
    adam_out<B>(mix<K>(w + static_cast<long long>(a) * s_count, x, s_count, n4, p),
                load4<B>(m, i), load4<B>(g, i), load4<B>(v, i), g, m, v, i, c);
  }
}

template <int K, int B>
__global__ void __launch_bounds__(kThreads)
adam_q_kernel(const float* __restrict__ w, const void* __restrict__ self, const void* q,
              const float* __restrict__ sc, void* __restrict__ g, void* __restrict__ m,
              void* __restrict__ v, int a_out, int s_count, long long rows,
              AdamScalars c) {
  const long long n4 = rows * 32;
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= n4) return;
  for (int a = 0; a < a_out; ++a) {
    const long long i = a * n4 + p;
    adam_out<B>(mix_q<K, B>(w + static_cast<long long>(a) * (s_count + 1), self, i, q, sc,
                            s_count, rows, n4, p),
                load4<B>(m, i), load4<B>(g, i), load4<B>(v, i), g, m, v, i, c);
  }
}

// ---------------------------------------------------------------------------
// Mixed-momentum (_qm) form: two payloads (the parameters' Q / SC and the
// momentum's MQ / MSC, one kind), two mixes per output that share W.  One
// thread owns float4 position p for a register tile of up to T outputs:
// per tile it loads the outputs' SELF and momentum self tile M (and, by the
// plan below, G and Adam's V), then, for each neighbour s in order, loads
// s's two payload float4s and row scales once, dequantizes them once and
// folds them into every output of the tile (acc_x[t] += W[a,1+s] dx,
// acc_m[t] += W[a,1+s] dm).  A payload byte is read once per tile, not
// once per output and mix, and each output's sums keep the stencil order
// (W[a,0] SELF[a] first, then s ascending, _rn operations): the plain
// version's bits.  Above T outputs the tiles loop and re-read the payload
// once per tile, so any A_out and S work.
//
// Why: with an f32 payload the old loop (one output at a time, each mix
// re-reading all S payload float4s) needed 2 x S x 16 B per thread in L1,
// 40 KB per 256-thread block at S = 5: more than L1 holds for the blocks
// resident on an SM, so the re-reads went to L2 and the kernel ran at 40-58%
// of its byte bound.  Narrow payloads (int8 / fp8 / bf16) fit L1 and ran at
// 73-77%; there a register tile costs more occupancy than the re-reads
// cost, so they keep one output per tile.

// epilogue families (the _qm and sparse kernels)
constexpr int kSgd = 0;
constexpr int kMsgd = 1;
constexpr int kNesterov = 2;
constexpr int kAdam = 3;

// per payload kind K, family F and bucket type B (chosen by measurement on
// an H100 with chip_smoke's phase 3, on float32 buckets): outputs per
// register tile, whether the tile's G (and Adam's V) load before the mix
// loop or after it, and the mix loop's unroll.  f32 payloads take 4-output
// tiles (8 outputs cost 150-210 registers and half the occupancy); CDAdam's
// f32 tile loads G and V after the mix, with the mix loop unrolled twice
// (four float4 arrays per output in registers cost more occupancy than
// that); narrow payloads take one output per tile.  The choice follows the
// payload, whose re-reads it saves, not the bucket type: a bf16 bucket (half
// the G / SELF / state bytes, the same float4 registers once widened) keeps it.
template <int K, int F>
struct QmPlan {
  static constexpr bool kWide = K == kF32;
  static constexpr int kTile = kWide ? 4 : 1;
  static constexpr bool kLoadFirst = !(kWide && F == kAdam);
  static constexpr int kUnroll = (kWide && F == kAdam) ? 2 : 1;
};

struct QmArgs {
  const float* w;        // (a_out, s_count + 1)
  const void* self;      // (a_out, rows * 32) float4 positions of the bucket type
  const void* q;         // (s_count, rows * 32) float4 positions of the kind
  const float* sc;       // (s_count, rows)
  const void* mq;        // the momentum payload and its scales, same shapes
  const float* msc;
  void* g;               // grad in, params out
  void* m;               // momentum (Adam: first moment) in, mixed update out
  void* v;               // Adam: second moment
  void* look;            // Nesterov: lookahead out
  int a_out;
  int s_count;
  long long rows;
  float alpha, mu;
  AdamScalars adam;
};

template <int F, int B>
__device__ __forceinline__ void qm_out(const QmArgs& p, const float4& ax, const float4& am,
                                       const float4& gv, const float4& vv, long long j) {
  if constexpr (F == kMsgd) {
    msgd_out<B>(ax, am, gv, p.g, p.m, j, p.alpha, p.mu);
  } else if constexpr (F == kNesterov) {
    nesterov_out<B>(ax, am, gv, p.g, p.m, p.look, j, p.alpha, p.mu);
  } else {
    adam_out<B>(ax, am, gv, vv, p.g, p.m, p.v, j, p.adam);
  }
}

template <int K, int F, int B>
__device__ __forceinline__ void qm_tiles(const QmArgs& p) {
  using Plan = QmPlan<K, F>;
  constexpr int T = Plan::kTile;
  const long long n4 = p.rows * 32;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n4) return;
  const int sw = p.s_count + 1;
  for (int a0 = 0; a0 < p.a_out; a0 += T) {
    const int na = min(T, p.a_out - a0);
    const float* __restrict__ w = p.w + static_cast<long long>(a0) * sw;
    float4 ax[T], am[T], gv[T], vv[T];
#pragma unroll
    for (int t = 0; t < T; ++t) {
      if (t < na) {
        const long long j = (a0 + t) * n4 + i;
        const float w0 = w[t * sw];
        ax[t] = scale4(w0, load4<B>(p.self, j));
        am[t] = scale4(w0, load4<B>(p.m, j));
        if constexpr (Plan::kLoadFirst) {
          gv[t] = load4<B>(p.g, j);
          if constexpr (F == kAdam) vv[t] = load4<B>(p.v, j);
        }
      }
    }
#pragma unroll (Plan::kUnroll)
    for (int s = 0; s < p.s_count; ++s) {
      const float4 dx = dequant<K>(p.q, p.sc, s, p.rows, n4, i);
      const float4 dm = dequant<K>(p.mq, p.msc, s, p.rows, n4, i);
#pragma unroll
      for (int t = 0; t < T; ++t) {
        if (t < na) {
          const float ws = w[t * sw + 1 + s];
          axpy_rn(ax[t], ws, dx);
          axpy_rn(am[t], ws, dm);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < T; ++t) {
      if (t < na) {
        const long long j = (a0 + t) * n4 + i;
        if constexpr (!Plan::kLoadFirst) {
          gv[t] = load4<B>(p.g, j);
          if constexpr (F == kAdam) vv[t] = load4<B>(p.v, j);
        }
        qm_out<F, B>(p, ax[t], am[t], gv[t], vv[t], j);
      }
    }
  }
}

// v' = mu mix_q(M; MQ, MSC) - alpha G;  out = mix_q(SELF; Q, SC) + v'
template <int K, int B>
__global__ void __launch_bounds__(kThreads) cdmsgd_qm_kernel(const QmArgs p) {
  qm_tiles<K, kMsgd, B>(p);
}

// as cdmsgd_qm_kernel, and LOOK = out + mu v'
template <int K, int B>
__global__ void __launch_bounds__(kThreads) nesterov_qm_kernel(const QmArgs p) {
  qm_tiles<K, kNesterov, B>(p);
}

// m' = b1 mix_q(M; MQ, MSC) + (1 - b1) G, Adam's epilogue on mix_q(SELF; Q, SC)
template <int K, int B>
__global__ void __launch_bounds__(kThreads) adam_qm_kernel(const QmArgs p) {
  qm_tiles<K, kAdam, B>(p);
}

// ---------------------------------------------------------------------------
// Sparse operand form (the top-k wire): the neighbours arrive as compact
// stacks VALS (S, k_rows, 128) int8, IDX (S, k_rows, 128) int32 flat dense
// positions, sorted ascending and unique within each neighbour, and SC
// (S, k_rows, 1) float32 per-compact-row scales.  Per element e of agent a:
//   acc = W[a,0] SELF[a][e];  for s = 0..S-1 in order, for each j with
//   IDX[s][j] == e:  acc = acc + W[a,1+s] (float(VALS[s][j]) * SC[s][j/128])
// then the family's epilogue (the _q forms' arithmetic).  One CTA owns 8
// dense rows (1,024 elements, one float4 per thread) for up to
// kAgentsPerCta agents: acc lives in shared memory, each neighbour's
// contiguous index range inside the block is found by binary search (all
// neighbours' searches at once, before the first scatter), the range is
// scatter-added into acc for every agent, and a __syncthreads() separates
// neighbours.  Indices are unique within a neighbour, so no two threads
// touch one element between two barriers, and the per-element order is the
// stencil order of the Pallas body (_sparse_stencil).  SELF, G and the state
// buffers are of the bucket type B; the compact values stay int8 with
// float32 scales (the wire compresses a float32 copy of the bucket).

constexpr int kSparseElems = kThreads * 4;     // 8 rows of 128 lanes
constexpr int kAgentsPerCta = 8;               // 32 KB of acc at most

struct SparseArgs {
  const float* w;            // (a_out, s_count + 1)
  const void* self;          // (a_out, rows * 32) float4 positions of the bucket type
  const int8_t* vals;        // (s_count, k_rows * 128)
  const int* idx;            // (s_count, k_rows * 128)
  const float* sc;           // (s_count, k_rows)
  void* g;                   // grad in, params out
  void* s1;                  // momentum (Adam: first moment)
  void* s2;                  // Adam: second moment
  void* look;                // Nesterov: lookahead out
  int a_out;
  int s_count;
  long long k_rows;
  long long rows;
  float alpha, mu;
  AdamScalars adam;
};

template <int F, int B>
__global__ void __launch_bounds__(kThreads) sparse_kernel(const SparseArgs p) {
  extern __shared__ float4 smem[];
  const int a0 = blockIdx.y * kAgentsPerCta;
  const int ca = min(kAgentsPerCta, p.a_out - a0);
  float4* acc4 = smem;                                     // [ca][kThreads]
  float* acc = reinterpret_cast<float*>(smem);
  long long* bounds = reinterpret_cast<long long*>(smem + ca * kThreads);
  const int sw = p.s_count + 1;
  const long long n4 = p.rows * 32;
  const long long kk = p.k_rows * 128;
  const long long e0 = static_cast<long long>(blockIdx.x) * kSparseElems;
  const long long e1 = min(e0 + kSparseElems, p.rows * 128);
  // bounds[2s], bounds[2s+1]: the first compact position of neighbour s at
  // or past e0, and at or past e1 (lower bounds in its sorted indices)
  for (int i = threadIdx.x; i < 2 * p.s_count; i += kThreads) {
    const int* ix = p.idx + (i >> 1) * kk;
    const long long target = (i & 1) ? e1 : e0;
    long long lo = 0, hi = kk;
    while (lo < hi) {
      const long long mid = (lo + hi) >> 1;
      if (ix[mid] < target) lo = mid + 1; else hi = mid;
    }
    bounds[i] = lo;
  }
  const long long q = e0 / 4 + threadIdx.x;               // this thread's float4
  const bool live = q < n4;
  for (int a = 0; a < ca; ++a) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live) {
      v = scale4(p.w[static_cast<long long>(a0 + a) * sw], load4<B>(p.self, (a0 + a) * n4 + q));
    }
    acc4[a * kThreads + threadIdx.x] = v;
  }
  __syncthreads();
  for (int s = 0; s < p.s_count; ++s) {
    const long long hi = bounds[2 * s + 1];
    for (long long j = bounds[2 * s] + threadIdx.x; j < hi; j += kThreads) {
      const long long c = s * kk + j;
      const int local = static_cast<int>(p.idx[c] - e0);
      const float deq = __fmul_rn(static_cast<float>(p.vals[c]),
                                  p.sc[s * p.k_rows + j / 128]);
      for (int a = 0; a < ca; ++a) {
        float* cell = acc + a * kSparseElems + local;
        *cell = __fadd_rn(*cell, __fmul_rn(p.w[static_cast<long long>(a0 + a) * sw + 1 + s],
                                           deq));
      }
    }
    __syncthreads();
  }
  if (!live) return;
  for (int a = 0; a < ca; ++a) {
    const long long i = (a0 + a) * n4 + q;
    const float4 mix = acc4[a * kThreads + threadIdx.x];
    const float4 gv = load4<B>(p.g, i);
    if constexpr (F == kSgd) {
      sgd_out<B>(mix, gv, p.g, i, p.alpha);
    } else if constexpr (F == kMsgd) {
      msgd_out<B>(mix, load4<B>(p.s1, i), gv, p.g, p.s1, i, p.alpha, p.mu);
    } else if constexpr (F == kNesterov) {
      nesterov_out<B>(mix, load4<B>(p.s1, i), gv, p.g, p.s1, p.look, i, p.alpha, p.mu);
    } else {
      adam_out<B>(mix, load4<B>(p.s1, i), gv, load4<B>(p.s2, i), p.g, p.s1, p.s2, i,
                  p.adam);
    }
  }
}

// make device current unless it already is (cudaSetDevice on every call
// costs host time the launch does not need)
cudaError_t select_device(int device) {
  int current = -1;
  if (cudaGetDevice(&current) == cudaSuccess && current == device) return cudaSuccess;
  return cudaSetDevice(device);
}

// f(b) with b the compile-time bucket type (kF32 or kBF16); its result, or
// cudaErrorInvalidValue for another bucket code
template <typename F>
int with_bucket(int bucket, F f) {
  switch (bucket) {
    case kF32: return f(std::integral_constant<int, kF32>{});
    case kBF16: return f(std::integral_constant<int, kBF16>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int F>
int launch_sparse(const SparseArgs& p, int bucket, int device, void* stream) {
  if (p.rows <= 0 || p.a_out <= 0) return 0;
  const cudaError_t set = select_device(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int ca = p.a_out < kAgentsPerCta ? p.a_out : kAgentsPerCta;
  const size_t smem = static_cast<size_t>(ca) * kSparseElems * sizeof(float) +
                      2 * static_cast<size_t>(p.s_count) * sizeof(long long);
  const dim3 grid(static_cast<unsigned int>((p.rows * 128 + kSparseElems - 1) / kSparseElems),
                  static_cast<unsigned int>((p.a_out + kAgentsPerCta - 1) / kAgentsPerCta));
  return with_bucket(bucket, [&](auto b) {
    auto kernel = sparse_kernel<F, decltype(b)::value>;
    if (smem > 48 * 1024) {
      const cudaError_t attr = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (attr != cudaSuccess) return static_cast<int>(attr);
    }
    kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
    return static_cast<int>(cudaGetLastError());
  });
}

SparseArgs sparse_args(const float* w, const void* self, const void* vals,
                       const int* idx, const float* sc, void* g, int a_out, int s_count,
                       long long k_rows, long long rows) {
  SparseArgs p{};
  p.w = w;
  p.self = self;
  p.vals = static_cast<const int8_t*>(vals);
  p.idx = idx;
  p.sc = sc;
  p.g = g;
  p.a_out = a_out;
  p.s_count = s_count;
  p.k_rows = k_rows;
  p.rows = rows;
  return p;
}

QmArgs qm_args(const float* w, const void* self, const void* q, const void* mq,
               const float* sc, const float* msc, void* g, void* m, int a_out,
               int s_count, long long rows) {
  QmArgs p{};
  p.w = w;
  p.self = self;
  p.q = q;
  p.sc = sc;
  p.mq = mq;
  p.msc = msc;
  p.g = g;
  p.m = m;
  p.a_out = a_out;
  p.s_count = s_count;
  p.rows = rows;
  return p;
}

unsigned int blocks_for(long long n4) {
  return static_cast<unsigned int>((n4 + kThreads - 1) / kThreads);
}

// Select the device, then launch(k, b) with k the compile-time kind and b
// the compile-time bucket type; returns the CUDA error of the selection or
// of the launch.  Only the quantized forms take int8 and fp8 kinds.
template <typename Launch>
int launch_bucket(int kind, int bucket, bool quantized_kinds, int device,
                  Launch launch) {
  return with_bucket(bucket, [&](auto b) {
    const cudaError_t set = select_device(device);
    if (set != cudaSuccess) return static_cast<int>(set);
    switch (kind) {
      case kF32: launch(std::integral_constant<int, kF32>{}, b); break;
      case kBF16: launch(std::integral_constant<int, kBF16>{}, b); break;
      case kI8:
        if (!quantized_kinds) return static_cast<int>(cudaErrorInvalidValue);
        launch(std::integral_constant<int, kI8>{}, b);
        break;
      case kFP8:
        if (!quantized_kinds) return static_cast<int>(cudaErrorInvalidValue);
        launch(std::integral_constant<int, kFP8>{}, b);
        break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

// Plain C interface, loaded with ctypes.  device is the CUDA device ordinal
// the tensors live on (this library links its own CUDA runtime, so it
// selects the device itself); stream is PyTorch's current stream there.
// kind is the neighbor / payload type: 0 float32, 1 bfloat16, 2 int8,
// 3 float8_e4m3fn (the dense form takes 0 and 1 only).  bucket is the
// type of G, SELF and every state and output buffer (V, M, LOOK): 0
// float32, 1 bfloat16.  n4 is the number of float4 positions (4 elements)
// per output buffer (rows * 32).  Pointers must be 16-byte aligned; X, Q,
// SELF and SC must not overlap G, V, M or LOOK, nor the outputs one another
// (the wrapper checks).  Returns the CUDA error of the device selection or
// of the launch (0 = launched); a call with nothing to do launches nothing.
// The _qm forms take the momentum payload VQ in the same kind as Q.
#define KIND_AND_BUCKET decltype(k)::value, decltype(b)::value

extern "C" int cdsgd_update(const float* w, const void* x, int kind, void* g,
                            int bucket, int a_out, int s_count, long long n4,
                            float alpha, int device, void* stream) {
  if (n4 <= 0 || a_out <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  return launch_bucket(kind, bucket, false, device, [&](auto k, auto b) {
    cdsgd_kernel<KIND_AND_BUCKET>
        <<<blocks_for(n4), kThreads, 0, st>>>(w, x, g, a_out, s_count, n4, alpha);
  });
}

extern "C" int cdmsgd_update(const float* w, const void* x, int kind, void* g, void* v,
                             int bucket, int a_out, int s_count, long long n4,
                             float alpha, float mu, int device, void* stream) {
  if (n4 <= 0 || a_out <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  return launch_bucket(kind, bucket, false, device, [&](auto k, auto b) {
    cdmsgd_kernel<KIND_AND_BUCKET>
        <<<blocks_for(n4), kThreads, 0, st>>>(w, x, g, v, a_out, s_count, n4, alpha, mu);
  });
}

extern "C" int cdsgd_update_q(const float* w, const void* self, const void* q, int kind,
                              const float* sc, void* g, int bucket, int a_out,
                              int s_count, long long rows, float alpha, int device,
                              void* stream) {
  if (rows <= 0 || a_out <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  return launch_bucket(kind, bucket, true, device, [&](auto k, auto b) {
    cdsgd_q_kernel<KIND_AND_BUCKET>
        <<<blocks_for(rows * 32), kThreads, 0, st>>>(w, self, q, sc, g, a_out, s_count,
                                                     rows, alpha);
  });
}

extern "C" int cdmsgd_update_q(const float* w, const void* self, const void* q, int kind,
                               const float* sc, void* g, void* v, int bucket, int a_out,
                               int s_count, long long rows, float alpha, float mu,
                               int device, void* stream) {
  if (rows <= 0 || a_out <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  return launch_bucket(kind, bucket, true, device, [&](auto k, auto b) {
    cdmsgd_q_kernel<KIND_AND_BUCKET>
        <<<blocks_for(rows * 32), kThreads, 0, st>>>(w, self, q, sc, g, v, a_out, s_count,
                                                     rows, alpha, mu);
  });
}

extern "C" int cdmsgd_update_qm(const float* w, const void* self, const void* q,
                                const void* vq, int kind, const float* sc,
                                const float* vsc, void* g, void* v, int bucket, int a_out,
                                int s_count, long long rows, float alpha, float mu,
                                int device, void* stream) {
  if (rows <= 0 || a_out <= 0) return 0;
  QmArgs p = qm_args(w, self, q, vq, sc, vsc, g, v, a_out, s_count, rows);
  p.alpha = alpha;
  p.mu = mu;
  auto st = static_cast<cudaStream_t>(stream);
  return launch_bucket(kind, bucket, true, device, [&](auto k, auto b) {
    cdmsgd_qm_kernel<KIND_AND_BUCKET><<<blocks_for(rows * 32), kThreads, 0, st>>>(p);
  });
}

extern "C" int cdmsgd_nesterov_update(const float* w, const void* x, int kind, void* g,
                                      void* v, void* look, int bucket, int a_out,
                                      int s_count, long long n4, float alpha, float mu,
                                      int device, void* stream) {
  if (n4 <= 0 || a_out <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  return launch_bucket(kind, bucket, false, device, [&](auto k, auto b) {
    nesterov_kernel<KIND_AND_BUCKET><<<blocks_for(n4), kThreads, 0, st>>>(
        w, x, g, v, look, a_out, s_count, n4, alpha, mu);
  });
}

extern "C" int cdmsgd_nesterov_update_q(const float* w, const void* self, const void* q,
                                        int kind, const float* sc, void* g, void* v,
                                        void* look, int bucket, int a_out, int s_count,
                                        long long rows, float alpha, float mu,
                                        int device, void* stream) {
  if (rows <= 0 || a_out <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  return launch_bucket(kind, bucket, true, device, [&](auto k, auto b) {
    nesterov_q_kernel<KIND_AND_BUCKET><<<blocks_for(rows * 32), kThreads, 0, st>>>(
        w, self, q, sc, g, v, look, a_out, s_count, rows, alpha, mu);
  });
}

extern "C" int cdmsgd_nesterov_update_qm(const float* w, const void* self,
                                         const void* q, const void* vq, int kind,
                                         const float* sc, const float* vsc, void* g,
                                         void* v, void* look, int bucket, int a_out,
                                         int s_count, long long rows, float alpha,
                                         float mu, int device, void* stream) {
  if (rows <= 0 || a_out <= 0) return 0;
  QmArgs p = qm_args(w, self, q, vq, sc, vsc, g, v, a_out, s_count, rows);
  p.look = look;
  p.alpha = alpha;
  p.mu = mu;
  auto st = static_cast<cudaStream_t>(stream);
  return launch_bucket(kind, bucket, true, device, [&](auto k, auto b) {
    nesterov_qm_kernel<KIND_AND_BUCKET><<<blocks_for(rows * 32), kThreads, 0, st>>>(p);
  });
}

extern "C" int cdadam_update(const float* w, const void* x, int kind, void* g, void* m,
                             void* v, int bucket, int a_out, int s_count, long long n4,
                             float alpha, float b1, float b2, float eps, float bc1,
                             float bc2, int device, void* stream) {
  if (n4 <= 0 || a_out <= 0) return 0;
  const AdamScalars c{alpha, b1, b2, eps, bc1, bc2};
  auto st = static_cast<cudaStream_t>(stream);
  return launch_bucket(kind, bucket, false, device, [&](auto k, auto b) {
    adam_kernel<KIND_AND_BUCKET><<<blocks_for(n4), kThreads, 0, st>>>(
        w, x, g, m, v, a_out, s_count, n4, c);
  });
}

extern "C" int cdadam_update_q(const float* w, const void* self, const void* q,
                               int kind, const float* sc, void* g, void* m, void* v,
                               int bucket, int a_out, int s_count, long long rows,
                               float alpha, float b1, float b2, float eps, float bc1,
                               float bc2, int device, void* stream) {
  if (rows <= 0 || a_out <= 0) return 0;
  const AdamScalars c{alpha, b1, b2, eps, bc1, bc2};
  auto st = static_cast<cudaStream_t>(stream);
  return launch_bucket(kind, bucket, true, device, [&](auto k, auto b) {
    adam_q_kernel<KIND_AND_BUCKET><<<blocks_for(rows * 32), kThreads, 0, st>>>(
        w, self, q, sc, g, m, v, a_out, s_count, rows, c);
  });
}

extern "C" int cdadam_update_qm(const float* w, const void* self, const void* q,
                                const void* mq, int kind, const float* sc,
                                const float* msc, void* g, void* m, void* v, int bucket,
                                int a_out, int s_count, long long rows, float alpha,
                                float b1, float b2, float eps, float bc1, float bc2,
                                int device, void* stream) {
  if (rows <= 0 || a_out <= 0) return 0;
  QmArgs p = qm_args(w, self, q, mq, sc, msc, g, m, a_out, s_count, rows);
  p.v = v;
  p.adam = AdamScalars{alpha, b1, b2, eps, bc1, bc2};
  auto st = static_cast<cudaStream_t>(stream);
  return launch_bucket(kind, bucket, true, device, [&](auto k, auto b) {
    adam_qm_kernel<KIND_AND_BUCKET><<<blocks_for(rows * 32), kThreads, 0, st>>>(p);
  });
}

#undef KIND_AND_BUCKET

// The sparse operand form: VALS int8, IDX int32 (sorted ascending and unique
// within each neighbour, every value in [0, rows * 128)), SC float32 per
// compact row; W is (A_out, S+1) with the self weight first, SELF (A_out,
// rows, 128).  Outputs as the _q forms: out into G, v' into V (Adam: m' into
// M, v' into V), Nesterov's lookahead into LOOK.
extern "C" int cdsgd_update_sparse(const float* w, const void* self, const void* vals,
                                   const int* idx, const float* sc, void* g, int bucket,
                                   int a_out, int s_count, long long k_rows,
                                   long long rows, float alpha, int device, void* stream) {
  SparseArgs p = sparse_args(w, self, vals, idx, sc, g, a_out, s_count, k_rows, rows);
  p.alpha = alpha;
  return launch_sparse<kSgd>(p, bucket, device, stream);
}

extern "C" int cdmsgd_update_sparse(const float* w, const void* self, const void* vals,
                                    const int* idx, const float* sc, void* g, void* v,
                                    int bucket, int a_out, int s_count, long long k_rows,
                                    long long rows, float alpha, float mu, int device,
                                    void* stream) {
  SparseArgs p = sparse_args(w, self, vals, idx, sc, g, a_out, s_count, k_rows, rows);
  p.s1 = v;
  p.alpha = alpha;
  p.mu = mu;
  return launch_sparse<kMsgd>(p, bucket, device, stream);
}

extern "C" int cdmsgd_nesterov_update_sparse(const float* w, const void* self,
                                             const void* vals, const int* idx,
                                             const float* sc, void* g, void* v, void* look,
                                             int bucket, int a_out, int s_count,
                                             long long k_rows, long long rows,
                                             float alpha, float mu, int device,
                                             void* stream) {
  SparseArgs p = sparse_args(w, self, vals, idx, sc, g, a_out, s_count, k_rows, rows);
  p.s1 = v;
  p.look = look;
  p.alpha = alpha;
  p.mu = mu;
  return launch_sparse<kNesterov>(p, bucket, device, stream);
}

extern "C" int cdadam_update_sparse(const float* w, const void* self, const void* vals,
                                    const int* idx, const float* sc, void* g, void* m,
                                    void* v, int bucket, int a_out, int s_count,
                                    long long k_rows, long long rows, float alpha,
                                    float b1, float b2, float eps, float bc1, float bc2,
                                    int device, void* stream) {
  SparseArgs p = sparse_args(w, self, vals, idx, sc, g, a_out, s_count, k_rows, rows);
  p.s1 = m;
  p.s2 = v;
  p.adam = AdamScalars{alpha, b1, b2, eps, bc1, bc2};
  return launch_sparse<kAdam>(p, bucket, device, stream);
}
