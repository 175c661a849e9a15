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
// because it cannot scatter, over a grid that runs in order; here a
// persistent CTA walks a range of tiles and carries one cursor into each
// neighbour's sorted indices from tile to tile (one warp search at the
// range's start, then a ballot over the next 32 indices a tile), marks the
// tile's entries in shared memory and gathers them per element, while the
// next tiles' dense operands arrive by bulk copies (see "Sparse operand
// form" below).
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
// Design (dense and _q forms; the sparse form keeps the float4 a thread
// over a persistent CTA's tiles, below): one thread owns one float4 (4
// lanes) of a row for all A_out outputs, so G, V and SELF are read once and
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
// then the family's epilogue (the _q forms' arithmetic).  SELF, G and the
// state buffers are of the bucket type B; the compact values stay int8 with
// float32 scales (the wire compresses a float32 copy of the bucket).
//
// Design.  The bucket is cut into tiles of 8 dense rows (1,024 elements,
// one float4 a thread).  sparse_kernel is persistent: each CTA walks a
// contiguous range of tiles for a chunk of output agents (grid.y), the
// chunk's width CA a template parameter (1, 2, 3, 4 or 6: the register
// tile of the mix).  Warp w owns neighbours s = w, w + 8, ...:
//   * once, at the start of its range, it finds each neighbour's first
//     compact position at or past the range's first element with a 32-ary
//     warp search (ceil(log32(k_rows * 128)) dependent loads: 5 at
//     gemma3-1b's 10 M entries, where a binary search takes 24);
//   * then it carries that cursor from tile to tile.  The compact stacks
//     stream through its registers (Stream: three 32-entry chunks, loaded
//     two chunks ahead of use); a tile's entries are the ones from the
//     cursor below the tile's end, found by one ballot over the next 32
//     (a full ballot sends the warp through the tile's at most 1,024
//     positions with 16-byte loads, mark_dense).  It marks them in the
//     tile's presence mask (32 words of 32 elements, each with its first
//     entry) and stages their dequantized values in shared memory; the
//     new cursor is the tile's end.
// The scan runs a tile ahead of the gather: one __syncthreads() a tile
// separates the scan of t + 1 from the gather of t + 1, and masks and
// staged values are double-buffered by tile parity.  In the gather a
// thread reads the mask words of its four elements for eight neighbours
// at once and visits only the neighbours where it has entries, in stencil
// order, adding them with the _rn operations of the Pallas body
// (_sparse_stencil): the plain version's bits.  The dense operands (SELF,
// G, the family's state) arrive by bulk copies (cp.async.bulk, one thread
// issuing them) into a ring of tiles in shared memory, each stage on an
// mbarrier, as many tiles ahead as the ring's budget (kSparseRingBytes, so
// that two CTAs fit an SM) allows.  The ring's reuse
// needs no barrier of its own: a stage is refilled after the tile loop's
// __syncthreads() that follows its last read.
//
// What the design buys (an H100, chip_smoke and sparse_update_bench.py):
// the old kernel (one CTA a tile, 2S binary searches of up to 24 dependent
// loads and S + 1 barriers a tile) ran at 0.47-0.63 of the byte bound at
// gemma3-1b's bf16 bucket; the gather was the last cost to go (visiting
// every neighbour with a vote cost more than the scan, the ring and the
// epilogue together).
//
// A bucket whose persistent CTAs would each walk fewer than
// kSparseMinRangeBytes of dense operands (the CNN's one-agent stencil,
// buckets of a few hundred rows) takes sparse_tile_kernel instead: one CTA
// a tile, the same search, scan and gather without the ring, its operands
// loaded into registers first.  There a persistent CTA's set-up (search,
// stream) and each tile's scan would sit on the critical path of a range
// of a few tiles.

constexpr int kTile = kThreads * 4;            // 8 rows of 128 lanes
constexpr int kWords = kTile / 32;             // mask words a tile: one a lane
constexpr int kWarps = kThreads / 32;
constexpr int kStaged = 32;                    // staged values a tile and neighbour
constexpr int kEarly = 2;                      // neighbours a warp probes ahead
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kSparseMinBlocks = 2;            // CTAs an SM the registers allow
constexpr int kSparseRingBytes = 96 * 1024;    // a CTA's dense ring, at most
constexpr int kSparseCapBytes = 96 * 1024;     // two stages of a CTA's agents, at most
constexpr int kSparseMaxStages = 8;            // tiles in the ring, at most
// a persistent CTA walks at least this many bytes of dense operands, or the
// bucket takes sparse_tile_kernel (one CTA a tile) with at most
// kSparseTileAgents agents a CTA
constexpr long long kSparseMinRangeBytes = 256 * 1024;
constexpr int kSparseTileAgents = 2;

// sparse_tile_kernel's CTAs an SM, at least: five for CDSGD and CDMSGD,
// whose few operands leave room to cap the registers at 48 (on an H100,
// sparse_update_bench.py: within 2% of the one-CTA-a-tile binary-search
// kernel this replaced on the one-agent stencil, 7-8% behind at the
// compiler's own 55-57); Nesterov and CDAdam are faster uncapped
template <int F>
constexpr int sparse_tile_blocks() {
  return F <= kMsgd ? 5 : 1;
}

// operand tiles a stage holds per agent (SELF, G, then V, or Adam's M and V)
// and the agents a CTA takes, for family F and bucket type B
template <int F, int B>
struct SparsePlan {
  static constexpr int kOps = F == kSgd ? 2 : (F == kAdam ? 4 : 3);
  static constexpr int kElem = B == kF32 ? 4 : 2;
  static constexpr int kAgentBytes = kOps * kTile * kElem;
  static constexpr int kCap = kSparseCapBytes / (2 * kAgentBytes);
  static constexpr int kMaxAgents = kCap < 1 ? 1 : (kCap < 6 ? kCap : 6);
};

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
  int agents;                // output agents per CTA (the launch sets it)
  int stages;                // tiles in the dense ring (the launch sets it)
  long long k_rows;
  long long rows;
  float alpha, mu;
  AdamScalars adam;
};

// the first j in [lo, hi] with j == hi or ix[j] >= target (ix sorted
// ascending on [lo, hi)), found by one warp: each round probes the last
// entry of 32 equal chunks and keeps the chunk where the entries reach
// target, the last round probes one entry a lane
__device__ __noinline__ long long warp_lower_bound(const int* __restrict__ ix,
                                                      long long lo, long long hi,
                                                      long long target, int lane) {
  while (hi - lo > 32) {
    const long long c = (hi - lo + 31) >> 5;
    const long long at = lo + (lane + 1) * c - 1;
    const bool below = at < hi && ix[at] < target;
    lo += static_cast<long long>(__popc(__ballot_sync(kFullMask, below))) * c;
    hi = min(hi, lo + c);
  }
  const long long at = lo + lane;
  return lo + __popc(__ballot_sync(kFullMask, at < hi && ix[at] < target));
}

// one lane's entry among a neighbour's 32 from the cursor: its flat
// position (e1, the tile's end, past the last index), raw value and row
// scale
struct Probe {
  long long e;
  int v;
  float scale;
};

// the probe read from device memory (neighbours past the streamed ones)
__device__ __forceinline__ Probe probe(const SparseArgs& p, int s, long long kk,
                                       long long c0, long long e1, int lane) {
  Probe r{e1, 0, 0.f};
  const long long j = c0 + lane;
  if (j < kk) {
    r.e = p.idx[s * kk + j];
    r.v = p.vals[s * kk + j];
    r.scale = p.sc[s * p.k_rows + (j >> 7)];
  }
  return r;
}

// One warp: the first position c of neighbour s's indices at or past e0
// (as warp_lower_bound), and the probe of position c + lane for the tile
// [e0, e1).  The search's last round reads 64 positions from its lower
// end, which hold the probe's 32 as well: no round trip of its own.
__device__ __forceinline__ long long lower_bound_probe(const SparseArgs& p, int s,
                                                       long long kk, long long e0, long long e1,
                                                       int lane, Probe* pr) {
  const int* __restrict__ ix = p.idx + s * kk;
  long long lo = 0, hi = kk;
  while (hi - lo > 32) {
    const long long c = (hi - lo + 31) >> 5;
    const long long at = lo + (lane + 1) * c - 1;
    const bool below = at < hi && ix[at] < e0;
    lo += static_cast<long long>(__popc(__ballot_sync(kFullMask, below))) * c;
    hi = min(hi, lo + c);
  }
  Probe a{e1, 0, 0.f}, b{e1, 0, 0.f};
  const long long ja = lo + lane, jb = lo + 32 + lane;
  if (ja < kk) a = Probe{ix[ja], p.vals[s * kk + ja], p.sc[s * p.k_rows + (ja >> 7)]};
  if (jb < kk) b = Probe{ix[jb], p.vals[s * kk + jb], p.sc[s * p.k_rows + (jb >> 7)]};
  const int below = __popc(__ballot_sync(kFullMask, ja < hi && a.e < e0));
  const int pos = below + lane;                 // 0 .. 63
  const int src = pos & 31;
  const long long ea = __shfl_sync(kFullMask, a.e, src), eb = __shfl_sync(kFullMask, b.e, src);
  const int va = __shfl_sync(kFullMask, a.v, src), vb = __shfl_sync(kFullMask, b.v, src);
  const float sa = __shfl_sync(kFullMask, a.scale, src), sb = __shfl_sync(kFullMask, b.scale, src);
  const bool second = pos >= 32;
  *pr = Probe{second ? eb : ea, second ? vb : va, second ? sb : sa};
  return lo + below;
}

// A neighbour's compact stacks streamed through a warp's registers: the
// 32-entry chunks at c (holding the cursor), c + 32 and c + 64, one entry a
// lane, with each chunk's row scale (128 is a multiple of 32: one row a
// chunk).  A scan reads the first two; the third is loaded when the cursor
// enters the first, so its loads have at least two tiles' work to land.
struct Stream {
  long long c;
  int ia, ib, ic, va, vb, vc;
  float sa, sb, sc;
};

__device__ __forceinline__ void load_chunk(const SparseArgs& p, int s, long long kk,
                                           long long c, int lane, int* i, int* v,
                                           float* scale) {
  if (c < kk) {                              // c and kk are multiples of 32
    *i = p.idx[s * kk + c + lane];
    *v = p.vals[s * kk + c + lane];
    *scale = p.sc[s * p.k_rows + (c >> 7)];
  }
}

// bring the stream to the chunk of the cursor cur (after a scan moved it)
__device__ __forceinline__ void advance(Stream& st, const SparseArgs& p, int s, long long kk,
                                        long long cur, int lane) {
  const long long c = cur & ~31LL;
  if (c == st.c) return;
  if (c == st.c + 32) {
    st.ia = st.ib;
    st.va = st.vb;
    st.sa = st.sb;
    st.ib = st.ic;
    st.vb = st.vc;
    st.sb = st.sc;
  } else if (c == st.c + 64) {
    st.ia = st.ic;
    st.va = st.vc;
    st.sa = st.sc;
    load_chunk(p, s, kk, c + 32, lane, &st.ib, &st.vb, &st.sb);
  } else {                                   // a dense tile passed every chunk
    load_chunk(p, s, kk, c, lane, &st.ia, &st.va, &st.sa);
    load_chunk(p, s, kk, c + 32, lane, &st.ib, &st.vb, &st.sb);
  }
  st.c = c;
  load_chunk(p, s, kk, c + 64, lane, &st.ic, &st.vc, &st.sc);
}

// the probe of position cur + lane, from the stream's two chunks
__device__ __forceinline__ Probe stream_probe(const Stream& st, long long cur, long long kk,
                                              long long e1, int lane) {
  const int pos = static_cast<int>(cur - st.c) + lane;   // 0 .. 62
  const int src = pos & 31;
  const int ia = __shfl_sync(kFullMask, st.ia, src), ib = __shfl_sync(kFullMask, st.ib, src);
  const int va = __shfl_sync(kFullMask, st.va, src), vb = __shfl_sync(kFullMask, st.vb, src);
  const bool second = pos >= 32;
  Probe r;
  r.e = cur + lane < kk ? (second ? ib : ia) : e1;
  r.v = second ? vb : va;
  r.scale = second ? st.sb : st.sa;
  return r;
}

// One warp, a dense tile (the first 32 entries from c0 all in it): mark
// the rest of its entries, which lie in the next e1 - e0 positions (unique
// and sorted, so every position past them holds e1 or more).  The window
// from the 16-byte boundary at or below c0 + 32 re-marks at most 4 of the
// first 32, and a 16-byte load never passes kk (a multiple of 128).  Out
// of line: the registers it needs are not held through the tile loop.
__device__ __noinline__ void mark_dense(const int* __restrict__ ix, long long kk, long long e0,
                                        long long e1, long long c0, uint2* wd, int lane) {
  const long long we = min(c0 + (e1 - e0), kk);
  const long long from = (c0 + 32) & ~3LL;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    int4 q[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const long long at = from + 4 * (lane + 32 * (4 * half + r));
      if (at < we) q[r] = *reinterpret_cast<const int4*>(ix + at);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (from + 4 * (lane + 32 * (4 * half + r)) < we) {
        // the four sorted entries' bits, one atomic a word they touch
        const int e4[4] = {q[r].x, q[r].y, q[r].z, q[r].w};
        int word = -1;
        unsigned mask = 0u;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (e4[k] < e1) {
            const int u = static_cast<int>(e4[k] - e0);
            if ((u >> 5) != word) {
              if (mask != 0u) atomicOr(&wd[word].x, mask);
              word = u >> 5;
              mask = 0u;
            }
            mask |= 1u << (u & 31);
          }
        }
        if (mask != 0u) atomicOr(&wd[word].x, mask);
      }
    }
  }
}

// One warp: neighbour ix's entries in the tile [e0, e1), from *cur (the
// first position at or past e0) on, pr the lane's probe.  Sets their bits
// in the tile's mask words wd[w].x (element e0 + 32 w + b is bit b of word
// w) with each word's first entry, counted from the tile's first position,
// in wd[w].y; stages the first 32 entries' dequantized values in dq; *base
// gets the tile's first position and *cur the first one at or past e1.
__device__ __forceinline__ void scan_tile(const int* __restrict__ ix, long long kk,
                                          long long e0, long long e1, const Probe& pr,
                                          long long* cur, long long* base, uint2* wd,
                                          float* dq, int lane) {
  const long long c0 = *cur;
  wd[lane].x = 0u;
  const bool in = pr.e < e1;                  // a prefix of the lanes: ix is sorted
  const unsigned ins = __ballot_sync(kFullMask, in);
  const long long at = pr.e - e0;
  const int word = static_cast<int>(at >> 5);
  const int before = __shfl_up_sync(kFullMask, word, 1);
  int count = __popc(ins);
  __syncwarp();
  if (in) {
    atomicOr(&wd[word].x, 1u << (at & 31));
    dq[lane] = __fmul_rn(static_cast<float>(pr.v), pr.scale);
    // a word's first entry is the lane that starts its run
    if (lane == 0 || before != word) wd[word].y = static_cast<unsigned>(lane);
  }
  if (ins == kFullMask) {
    // a dense tile: its other entries, then every word's first entry from a
    // warp prefix sum of the words' counts
    mark_dense(ix, kk, e0, e1, c0, wd, lane);
    __syncwarp();
    const unsigned bits = wd[lane].x;
    int first = __popc(bits);                // inclusive, then exclusive prefix
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFullMask, first, o);
      if (lane >= o) first += y;
    }
    wd[lane].y = static_cast<unsigned>(first - __popc(bits));
    count = __shfl_sync(kFullMask, first, 31);
  }
  if (lane == 0) {
    *base = c0;
    *cur = c0 + count;
  }
  __syncwarp();
}

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// Wait until the phase of parity `parity` of the mbarrier has completed.  A
// wait of more than 2^34 clocks (~10 s) traps: a protocol fault fails the
// launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1LL << 34)) __trap();
  } while (!done);
}

// One thread: bring tile t's dense operands (every agent's SELF, G and
// state tiles, each contiguous) into a ring stage with bulk copies that
// complete on the stage's mbarrier (which expects their bytes)
template <int F, int B>
__device__ __forceinline__ void fill_stage(const SparseArgs& p, unsigned char* stage,
                                           uint32_t bar, int a0, int na, long long n4,
                                           long long t) {
  using Plan = SparsePlan<F, B>;
  const long long q0 = t * (kTile / 4);
  const long long left = n4 - q0;
  const uint32_t bytes =
      static_cast<uint32_t>((left < kTile / 4 ? left : kTile / 4) * 4 * Plan::kElem);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes * na * Plan::kOps)
               : "memory");
  const void* ops[4] = {p.self, p.g, p.s1, p.s2};
  for (int a = 0; a < na; ++a) {
#pragma unroll
    for (int o = 0; o < Plan::kOps; ++o) {
      const char* src = static_cast<const char*>(ops[o]) + ((a0 + a) * n4 + q0) * 4 * Plan::kElem;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];" ::"r"(smem_addr(stage + (a * Plan::kOps + o) * (kTile * Plan::kElem))),
          "l"(src), "r"(bytes), "r"(bar)
          : "memory");
    }
  }
}

__device__ __forceinline__ float& lane_of(float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// Add this thread's neighbour entries of the tile (masks, staged values
// and tile bases of buffer buf) to acc, for agents 0 .. na of the CTA.  The
// mask words of eight neighbours at a time are read together, then only the
// neighbours where this thread has entries are visited, in stencil order,
// each with its (up to four) values read together (staged, or past the
// first 32 of a dense tile from device memory).
template <int CA>
__device__ __forceinline__ void gather_hits(const SparseArgs& p, const uint2* words,
                                            const float* dq, const long long* base,
                                            const float* wts, int buf, int na, float4 (&acc)[CA]) {
  const int s_count = p.s_count, sw = s_count + 1;
  const long long kk = p.k_rows * 128;
  const int wi = threadIdx.x >> 3, b0 = (threadIdx.x & 7) * 4;
  const unsigned below = (1u << b0) - 1u;
  for (int s0 = 0; s0 < s_count; s0 += 8) {
    unsigned hits = 0u;                      // 4 bits a neighbour
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (s0 + u < s_count) {
        hits |= ((words[(buf * s_count + s0 + u) * kWords + wi].x >> b0) & 0xfu) << (4 * u);
      }
    }
    while (hits != 0u) {
      const int u = (__ffs(hits) - 1) >> 2;
      const unsigned nib = (hits >> (4 * u)) & 0xfu;
      hits &= ~(0xfu << (4 * u));
      const int s = s0 + u, nb = buf * s_count + s;
      const uint2 m = words[nb * kWords + wi];
      int rel = static_cast<int>(m.y) + __popc(m.x & below);
      float d[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if ((nib >> k) & 1u) {
          if (rel < kStaged) {
            d[k] = dq[nb * kStaged + rel];
          } else {
            const long long j = base[nb] + rel;
            d[k] = __fmul_rn(static_cast<float>(p.vals[s * kk + j]),
                             p.sc[s * p.k_rows + (j >> 7)]);
          }
          ++rel;
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if ((nib >> k) & 1u) {
#pragma unroll
          for (int a = 0; a < CA; ++a) {
            if (a < na) {
              float& c = lane_of(acc[a], k);
              c = __fadd_rn(c, __fmul_rn(wts[a * sw + 1 + s], d[k]));
            }
          }
        }
      }
    }
  }
}

// The family's outputs of one float4 position of one agent from its mix
// acc; op(o) gives the position's operand o (1 G, 2 V or Adam's M, 3
// Adam's V), read only where the family uses it.
template <int F, int B, typename Op>
__device__ __forceinline__ void sparse_out(const SparseArgs& p, const float4& acc, Op op,
                                           long long i) {
  const float4 gv = op(1);
  if constexpr (F == kSgd) {
    sgd_out<B>(acc, gv, p.g, i, p.alpha);
  } else if constexpr (F == kMsgd) {
    msgd_out<B>(acc, op(2), gv, p.g, p.s1, i, p.alpha, p.mu);
  } else if constexpr (F == kNesterov) {
    nesterov_out<B>(acc, op(2), gv, p.g, p.s1, p.look, i, p.alpha, p.mu);
  } else {
    adam_out<B>(acc, op(2), gv, op(3), p.g, p.s1, p.s2, i, p.adam);
  }
}

template <int F, int B, int CA>
__global__ void __launch_bounds__(kThreads, kSparseMinBlocks) sparse_kernel(const SparseArgs p) {
  using Plan = SparsePlan<F, B>;
  constexpr int kStage = kTile * Plan::kElem;      // one operand tile, bytes
  const int ahead = p.stages - 1;                  // dense tiles in flight
  extern __shared__ __align__(16) unsigned char smem[];
  const int ca = p.agents;
  const int a0 = blockIdx.y * ca;
  const int na = min(ca, p.a_out - a0);
  const int s_count = p.s_count, sw = s_count + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long n = p.rows * 128, n4 = p.rows * 32, kk = p.k_rows * 128;
  const long long tiles = (n + kTile - 1) / kTile;
  const long long t0 = tiles * blockIdx.x / gridDim.x;
  const long long t1 = tiles * (blockIdx.x + 1) / gridDim.x;
  if (na <= 0 || t0 >= t1) return;
  // [ring: stages x ca agents x kOps tiles][ring mbarriers: kSparseMaxStages]
  // [masks: 2 x S x kWords][staged values: 2 x S x kStaged][tile bases:
  // 2 x S][cursors: S][weights: ca x (S + 1)]
  unsigned char* ring = smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.stages * ca * Plan::kAgentBytes);
  uint2* words = reinterpret_cast<uint2*>(full + kSparseMaxStages);
  float* dq = reinterpret_cast<float*>(words + 2 * s_count * kWords);
  long long* base = reinterpret_cast<long long*>(dq + 2 * s_count * kStaged);
  long long* cur = base + 2 * s_count;
  float* wts = reinterpret_cast<float*>(cur + s_count);
  // tile t's ring stage and its mbarrier: tiles t0, t0 + 1, .. in turn
  auto slot = [&](long long t) { return static_cast<int>(t - t0) % p.stages; };
  auto stage_of = [&](long long t) { return ring + slot(t) * ca * Plan::kAgentBytes; };
  auto full_of = [&](long long t) { return smem_addr(full + slot(t)); };
  Stream st[kEarly];
  // scan tile t for this warp's neighbours: the first kEarly from their
  // streams (then moved on), any further one from device memory
  auto scan = [&](long long t) {
    const long long e0 = t * kTile, e1 = min(e0 + kTile, n);
    for (int s = warp, k = 0; s < s_count; s += kWarps, ++k) {
      Probe pr;
#pragma unroll
      for (int u = 0; u < kEarly; ++u) {
        if (u == k) pr = stream_probe(st[u], cur[s], kk, e1, lane);
      }
      if (k >= kEarly) pr = probe(p, s, kk, cur[s], e1, lane);
      const int nb = static_cast<int>(t & 1) * s_count + s;
      scan_tile(p.idx + s * kk, kk, e0, e1, pr, cur + s, base + nb, words + nb * kWords,
                dq + nb * kStaged, lane);
#pragma unroll
      for (int u = 0; u < kEarly; ++u) {
        if (u == k) advance(st[u], p, s, kk, cur[s], lane);
      }
    }
  };
  for (int i = threadIdx.x; i < na * sw; i += kThreads) {
    wts[i] = p.w[static_cast<long long>(a0) * sw + i];
  }
  if (threadIdx.x == 0) {
    for (int k = 0; k < p.stages; ++k) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(full + k))
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    fill_stage<F, B>(p, stage_of(t0), full_of(t0), a0, na, n4, t0);
  }
  for (int s = warp, k = 0; s < s_count; s += kWarps, ++k) {
    const long long c = warp_lower_bound(p.idx + s * kk, 0, kk, t0 * kTile, lane);
    if (lane == 0) cur[s] = c;
#pragma unroll
    for (int u = 0; u < kEarly; ++u) {
      if (u == k) {
        st[u].c = (c & ~31LL) - 128;         // no chunk held: advance loads all
        advance(st[u], p, s, kk, c, lane);
      }
    }
  }
  __syncwarp();
  // the rest of the ring only now: the searches' and streams' short
  // dependent loads do not queue behind its bulk copies
  if (threadIdx.x == 0) {
    for (long long t = t0 + 1; t < t0 + ahead && t < t1; ++t) {
      fill_stage<F, B>(p, stage_of(t), full_of(t), a0, na, n4, t);
    }
  }
  scan(t0);
  __syncthreads();
  const int wi = threadIdx.x >> 3, b0 = (threadIdx.x & 7) * 4;
  const unsigned below = (1u << b0) - 1u;
  for (long long t = t0; t < t1; ++t) {
    const int buf = static_cast<int>(t & 1);
    const long long q = t * (kTile / 4) + threadIdx.x;   // this thread's float4
    // the stage of tile t - 1, which every thread left before the last
    // barrier, takes tile t + ahead
    if (threadIdx.x == 0 && t + ahead < t1) {
      fill_stage<F, B>(p, stage_of(t + ahead), full_of(t + ahead), a0, na, n4, t + ahead);
    }
    if (q < n4) {
      mbar_wait(full_of(t), static_cast<uint32_t>((t - t0) / p.stages) & 1u);
      const unsigned char* stage = stage_of(t);
      float4 acc[CA];
#pragma unroll
      for (int a = 0; a < CA; ++a) {
        if (a < na) {
          acc[a] = scale4(wts[a * sw], load4<B>(stage + a * Plan::kOps * kStage, threadIdx.x));
        }
      }
      // the thread's entries, as gather_hits adds them (inline here: the
      // tile loop's registers are at the launch bounds' limit)
      for (int s0 = 0; s0 < s_count; s0 += 8) {
        unsigned hits = 0u;                      // 4 bits a neighbour
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          if (s0 + u < s_count) {
            hits |= ((words[(buf * s_count + s0 + u) * kWords + wi].x >> b0) & 0xfu) << (4 * u);
          }
        }
        while (hits != 0u) {
          const int u = (__ffs(hits) - 1) >> 2;
          const unsigned nib = (hits >> (4 * u)) & 0xfu;
          hits &= ~(0xfu << (4 * u));
          const int s = s0 + u, nb = buf * s_count + s;
          const uint2 m = words[nb * kWords + wi];
          int rel = static_cast<int>(m.y) + __popc(m.x & below);
          float d[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if ((nib >> k) & 1u) {
              if (rel < kStaged) {
                d[k] = dq[nb * kStaged + rel];
              } else {
                const long long j = base[nb] + rel;
                d[k] = __fmul_rn(static_cast<float>(p.vals[s * kk + j]),
                                 p.sc[s * p.k_rows + (j >> 7)]);
              }
              ++rel;
            }
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if ((nib >> k) & 1u) {
#pragma unroll
              for (int a = 0; a < CA; ++a) {
                if (a < na) {
                  float& c = lane_of(acc[a], k);
                  c = __fadd_rn(c, __fmul_rn(wts[a * sw + 1 + s], d[k]));
                }
              }
            }
          }
        }
      }
#pragma unroll
      for (int a = 0; a < CA; ++a) {
        if (a < na) {
          const unsigned char* at = stage + a * Plan::kOps * kStage;
          const long long i = (a0 + a) * n4 + q;
          const float4 gv = load4<B>(at + kStage, threadIdx.x);
          if constexpr (F == kSgd) {
            sgd_out<B>(acc[a], gv, p.g, i, p.alpha);
          } else if constexpr (F == kMsgd) {
            msgd_out<B>(acc[a], load4<B>(at + 2 * kStage, threadIdx.x), gv, p.g, p.s1, i,
                        p.alpha, p.mu);
          } else if constexpr (F == kNesterov) {
            nesterov_out<B>(acc[a], load4<B>(at + 2 * kStage, threadIdx.x), gv, p.g, p.s1,
                            p.look, i, p.alpha, p.mu);
          } else {
            adam_out<B>(acc[a], load4<B>(at + 2 * kStage, threadIdx.x), gv,
                        load4<B>(at + 3 * kStage, threadIdx.x), p.g, p.s1, p.s2, i, p.adam);
          }
        }
      }
    }
    if (t + 1 < t1) scan(t + 1);
    __syncthreads();
  }
}

// The same function, one CTA a tile, for a bucket too small for the
// persistent CTAs to repay their set-up (each would walk few tiles, and
// its range's search and stream loads, then each tile's scan, would sit
// on its critical path): every CTA searches its own tile's start in each
// neighbour's indices, the search's last round reading the scan's 32
// entries too (lower_bound_probe), scans the tile (scan_tile) and gathers
// (gather_hits); its dense operands are loaded after the scan, as the
// registers they would hold through the searches cost more CTAs an SM
// than their latency costs.  At most kSparseTileAgents agents a CTA keep
// its registers few.
template <int F, int B, int CA>
__global__ void __launch_bounds__(kThreads, sparse_tile_blocks<F>()) sparse_tile_kernel(
    const SparseArgs p) {
  using Plan = SparsePlan<F, B>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ca = p.agents;
  const int a0 = blockIdx.y * ca;
  const int na = min(ca, p.a_out - a0);
  const int s_count = p.s_count, sw = s_count + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long n = p.rows * 128, n4 = p.rows * 32, kk = p.k_rows * 128;
  const long long t = blockIdx.x;
  const long long e0 = t * kTile, e1 = min(e0 + kTile, n);
  const long long q = t * (kTile / 4) + threadIdx.x;
  if (na <= 0) return;
  // [masks: S x kWords][staged values: S x kStaged][tile bases: S]
  // [cursors: S][weights: ca x (S + 1)]
  uint2* words = reinterpret_cast<uint2*>(smem);
  float* dq = reinterpret_cast<float*>(words + s_count * kWords);
  long long* base = reinterpret_cast<long long*>(dq + s_count * kStaged);
  long long* cur = base + s_count;
  float* wts = reinterpret_cast<float*>(cur + s_count);
  const void* ops[4] = {p.self, p.g, p.s1, p.s2};
  for (int i = threadIdx.x; i < na * sw; i += kThreads) {
    wts[i] = p.w[static_cast<long long>(a0) * sw + i];
  }
  for (int s = warp; s < s_count; s += kWarps) {
    Probe pr;
    const long long c = lower_bound_probe(p, s, kk, e0, e1, lane, &pr);
    if (lane == 0) cur[s] = c;
    __syncwarp();
    scan_tile(p.idx + s * kk, kk, e0, e1, pr, cur + s, base + s, words + s * kWords,
              dq + s * kStaged, lane);
  }
  __syncthreads();
  if (q >= n4) return;
  float4 opv[CA][Plan::kOps];
#pragma unroll
  for (int a = 0; a < CA; ++a) {
    if (a < na) {
#pragma unroll
      for (int o = 0; o < Plan::kOps; ++o) opv[a][o] = load4<B>(ops[o], (a0 + a) * n4 + q);
    }
  }
  float4 acc[CA];
#pragma unroll
  for (int a = 0; a < CA; ++a) {
    if (a < na) acc[a] = scale4(wts[a * sw], opv[a][0]);
  }
  gather_hits<CA>(p, words, dq, base, wts, 0, na, acc);
#pragma unroll
  for (int a = 0; a < CA; ++a) {
    if (a < na) {
      sparse_out<F, B>(p, acc[a], [&](int o) { return opv[a][o]; }, (a0 + a) * n4 + q);
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

// dynamic shared memory of sparse_kernel<F, B, *> for ca agents a CTA, a
// ring of stages tiles and s neighbours (its layout in the kernel)
template <int F, int B>
size_t sparse_smem(int ca, int stages, int s) {
  return static_cast<size_t>(stages) * ca * SparsePlan<F, B>::kAgentBytes +
         kSparseMaxStages * sizeof(uint64_t) +
         static_cast<size_t>(s) * (2 * kWords * sizeof(uint2) + 2 * kStaged * sizeof(float) +
                                   3 * sizeof(long long)) +
         static_cast<size_t>(ca) * (s + 1) * sizeof(float);
}

// CTAs of sparse_kernel<F, B, CA> resident on the device at once with smem
// bytes of dynamic shared memory, which it enables above 48 KB.  The card's
// SM count is cached per device, the answer for the last (device, smem).
template <int F, int B, int CA>
cudaError_t sparse_resident(int device, size_t smem, long long* out) {
  static int sms[64] = {};
  static int last_device = -1;
  static size_t last_smem = 0;
  static long long last = 0;
  if (device == last_device && smem == last_smem) {
    *out = last;
    return cudaSuccess;
  }
  int count = device >= 0 && device < 64 ? sms[device] : 0;
  cudaError_t err = cudaSuccess;
  if (count == 0) {
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    if (device >= 0 && device < 64) sms[device] = count;
  }
  auto kernel = sparse_kernel<F, B, CA>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  *out = static_cast<long long>(count) * (per_sm > 0 ? per_sm : 1);
  last_device = device;
  last_smem = smem;
  last = *out;
  return cudaSuccess;
}

// f(c) with c the compile-time agents a CTA: the least of 1, 2, 3, 4 and 6
// at or above ca (at most 6; the kernel's register tile is that wide)
template <typename Fn>
int with_agents(int ca, Fn f) {
  switch (ca) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    default: return f(std::integral_constant<int, 6>{});
  }
}

// sparse_tile_kernel over every tile (grid.x) and chunk of at most
// kSparseTileAgents output agents (grid.y)
template <int F, int B>
int launch_sparse_tiles(SparseArgs p, long long tiles, void* stream) {
  const int chunks = (p.a_out + kSparseTileAgents - 1) / kSparseTileAgents;
  p.agents = (p.a_out + chunks - 1) / chunks;
  const size_t smem =
      static_cast<size_t>(p.s_count) * (kWords * sizeof(uint2) + kStaged * sizeof(float) +
                                        2 * sizeof(long long)) +
      static_cast<size_t>(p.agents) * (p.s_count + 1) * sizeof(float);
  auto launch = [&](auto kernel) {
    if (smem > 48 * 1024) {
      const cudaError_t attr = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (attr != cudaSuccess) return static_cast<int>(attr);
    }
    kernel<<<dim3(static_cast<unsigned int>(tiles), static_cast<unsigned int>(chunks)), kThreads,
             smem, static_cast<cudaStream_t>(stream)>>>(p);
    return static_cast<int>(cudaGetLastError());
  };
  return p.agents == 1 ? launch(sparse_tile_kernel<F, B, 1>)
                       : launch(sparse_tile_kernel<F, B, 2>);
}

// One launch: the output agents in ceil(a_out / kMaxAgents) equal chunks
// (grid.y), fewer agents a CTA while the shared memory exceeds what a block
// can use (many neighbours); the tiles over as many CTAs per chunk as are
// resident on the card (grid.x), at most one a tile.
template <int F>
int launch_sparse(SparseArgs p, int bucket, int device, void* stream) {
  if (p.rows <= 0 || p.a_out <= 0) return 0;
  const cudaError_t set = select_device(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  return with_bucket(bucket, [&](auto b) {
    constexpr int B = decltype(b)::value;
    constexpr size_t kMaxSmem = 227 * 1024;
    using Plan = SparsePlan<F, B>;
    int chunks = (p.a_out + Plan::kMaxAgents - 1) / Plan::kMaxAgents;
    p.agents = (p.a_out + chunks - 1) / chunks;
    while (p.agents > 1 && sparse_smem<F, B>(p.agents, 2, p.s_count) > kMaxSmem) {
      chunks = (p.a_out + p.agents - 2) / (p.agents - 1);
      p.agents = (p.a_out + chunks - 1) / chunks;
    }
    return with_agents(p.agents, [&](auto c) {
      constexpr int CA = decltype(c)::value;
      // as many tiles in flight as the ring's budget holds: a CTA of few
      // agents keeps more of its range's tiles coming
      p.stages = kSparseRingBytes / (p.agents * Plan::kAgentBytes);
      p.stages = p.stages < 2 ? 2 : (p.stages > kSparseMaxStages ? kSparseMaxStages : p.stages);
      while (p.stages > 2 && sparse_smem<F, B>(p.agents, p.stages, p.s_count) > kMaxSmem) {
        --p.stages;
      }
      const size_t smem = sparse_smem<F, B>(p.agents, p.stages, p.s_count);
      if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
      long long resident = 0;
      const cudaError_t err = sparse_resident<F, B, CA>(device, smem, &resident);
      if (err != cudaSuccess) return static_cast<int>(err);
      const long long tiles = (p.rows * 128 + kTile - 1) / kTile;
      long long per_chunk = resident / chunks;
      per_chunk = per_chunk < 1 ? 1 : (per_chunk < tiles ? per_chunk : tiles);
      if (tiles / per_chunk * p.agents * Plan::kAgentBytes < kSparseMinRangeBytes) {
        return launch_sparse_tiles<F, B>(p, tiles, stream);
      }
      const dim3 grid(static_cast<unsigned int>(per_chunk), static_cast<unsigned int>(chunks));
      sparse_kernel<F, B, CA><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
      return static_cast<int>(cudaGetLastError());
    });
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
