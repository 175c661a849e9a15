// Per-row scaled quantization of packed float32 or bfloat16 (rows, 128)
// buckets for the consensus wire, for Hopper (sm_90a).
//
//   scale[r] = amax_r * (1/qmax)  (qmax 127 int8, 448 fp8; 1.0 if amax_r == 0)
//   int8:  q = clip(floor(x / scale + u), -127, 127)   (stochastic rounding)
//   fp8:   q = e4m3fn(x / scale)                       (nearest, saturating)
//
// x is (A, rows, 128): one bucket of every agent, one launch.  A bfloat16
// bucket (the template parameter XB) is widened to float32 exactly as it is
// loaded, and everything after the load is the float32 kernel: the same
// scales, the same Philox counter, the same codes as the float32 bucket of
// those values (the Pallas kernel's x_ref[...].astype(float32)).  Agent a draws
// its uniforms from the 32-bit seed  seed + agent_stride * a  (wrapping), so
// the caller passes one seed per agent as a base and a stride.
//
// Replaces: src/repro/kernels/consensus_update/consensus_update.py
//   sr_quantize_2d (line 130; pallas_call line 167; body _sr_quantize_kernel
//   and _quantize_math, line 96).
//
// Random stream.  The TPU kernel draws pltpu.prng_random_bits, which no GPU
// can reproduce.  This kernel defines the port's stream instead:
// Philox4x32-10 keyed by (seed, 0), counter (p mod 2^32, p >> 32, 0, 0) for
// the float4 index p within the agent's bucket; the four output words are
// the uniforms of that float4's four elements, u = (bits >> 8) * 2^-24
// (exact in float32, strictly below 1).  The bits depend on (seed, p) only,
// not on the launch shape, and the plain version (ref.py: philox_uniforms)
// computes the same words with int64 tensors, so the two agree bit for bit.
// Nothing reads u from memory.
//
// Bound on an H100 SXM (3.35 TB/s): memory.  Per element the kernel reads 4
// bytes and writes 1 (+4 bytes of scale per 128 elements) and does ~25
// integer and float operations (Philox's 10 rounds amortized over 4
// elements, the abs-max, a divide, an add and a floor), far below the
// ridge.  At the training path's shape (A = 5, 16,941 rows): 43.37 MB read,
// 11.18 MB written, ~16.3 us.  At gemma3-1b's bf16 bucket (A = 4, 7,811,037
// rows, 2 bytes read per element): 8.00 GB read, 4.12 GB written, ~3.62 ms.
//
// Scale arithmetic.  The JAX source writes amax / qmax, but XLA, compiling
// the JAX trainer's step, folds a division by a literal into a multiply by
// its float32 reciprocal; this kernel follows the compiled arithmetic
// (__fmul_rn by 1.0f/qmax, folded the same way), so its wire bits equal the
// JAX trainer's.  x / scale divides by a value, which XLA keeps a true
// division: __fdiv_rn here.
//
// Design.  One warp quantizes one 128-lane row at a time: each lane holds
// one float4 (16-byte coalesced, 512 bytes per warp), the warp reduces |x|
// to the row's max with __shfl_xor_sync (fabsf and fmaxf are exact, so the
// order does not matter), every lane divides by the same scale, rounds its
// four elements and stores them as one 4-byte word; lane 0 writes the
// scale.  The grid is persistent (as many blocks as are resident on the
// card at once), and each warp walks the rows grid-stride with the next
// row's load issued before it quantizes the current one, so loads stay in
// flight while the integer and float work runs.  A warp tracks its row's
// agent and row within the agent incrementally, in 32-bit integers (one
// division per warp; fewer than 2^31 rows per launch, which the entry point
// checks), so agent boundaries fall anywhere; a warp past the last row
// exits whole, so any row count works.
//
// What bounds it: not the memory alone.  The fp8 form, with the same
// traffic and no random stream, runs at 80-86% of the byte bound; the int8
// form adds Philox's ten dependent rounds (two wide integer multiplies
// each, on the half-rate IMAD pipe) and reaches about 70%.  On an H100 its
// time did not move with more resident warps, two or three rows in flight,
// two rows per iteration, one reciprocal per row instead of four, a fused
// add-and-floor or a one-instruction warp max.

#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;
constexpr int kKindF32 = 0;       // the wrapper's kind codes: bucket types ...
constexpr int kKindBF16 = 1;
constexpr int kKindInt8 = 2;      // ... and payload types
constexpr int kKindFp8 = 3;

constexpr unsigned kPhiloxM0 = 0xD2511F53u;
constexpr unsigned kPhiloxM1 = 0xCD9E8D57u;
constexpr unsigned kPhiloxW0 = 0x9E3779B9u;
constexpr unsigned kPhiloxW1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, unsigned k0, unsigned k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += kPhiloxW0;
      k1 += kPhiloxW1;
    }
    const unsigned hi0 = __umulhi(kPhiloxM0, c.x);
    const unsigned lo0 = kPhiloxM0 * c.x;
    const unsigned hi1 = __umulhi(kPhiloxM1, c.z);
    const unsigned lo1 = kPhiloxM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ float uniform24(unsigned bits) {
  return __fmul_rn(__uint2float_rn(bits >> 8), 5.9604644775390625e-08f);  // 2^-24
}

// floor(y + u) clipped to [-127, 127], as one byte
__device__ __forceinline__ uint32_t sr_int8(float y, unsigned bits) {
  const float r = fminf(fmaxf(floorf(__fadd_rn(y, uniform24(bits))), -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(r)));
}

__device__ __forceinline__ uint32_t rn_fp8(float y) {
  return static_cast<uint32_t>(__nv_cvt_float_to_fp8(y, __NV_SATFINITE, __NV_E4M3));
}

// float4 position i of a bucket of type XB, widened exactly to float32
template <int XB>
__device__ __forceinline__ float4 load_x(const void* __restrict__ x, size_t i) {
  if constexpr (XB == kKindF32) {
    return static_cast<const float4*>(x)[i];
  } else {
    const uint2 u = static_cast<const uint2*>(x)[i];
    return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
  }
}

// quantize row v of agent a, row r within the agent (launch row grow)
template <bool kStochastic>
__device__ __forceinline__ void quantize_row(const float4& v, unsigned grow, unsigned a,
                                             unsigned r, unsigned lane, uint32_t* q,
                                             float* scales, unsigned seed,
                                             unsigned agent_stride) {
  float amax = fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  }
  const float inv_qmax = kStochastic ? 1.0f / 127.0f : 1.0f / 448.0f;
  const float scale = amax > 0.f ? __fmul_rn(amax, inv_qmax) : 1.f;
  const float y0 = __fdiv_rn(v.x, scale);
  const float y1 = __fdiv_rn(v.y, scale);
  const float y2 = __fdiv_rn(v.z, scale);
  const float y3 = __fdiv_rn(v.w, scale);
  uint32_t word;
  if (kStochastic) {
    // counter: the float4 index r * 32 + lane in the agent's bucket, in two words
    const unsigned key = seed + agent_stride * a;
    const uint4 bits = philox4x32_10(make_uint4((r << 5) | lane, r >> 27, 0u, 0u), key, 0u);
    word = sr_int8(y0, bits.x) | sr_int8(y1, bits.y) << 8 |
           sr_int8(y2, bits.z) << 16 | sr_int8(y3, bits.w) << 24;
  } else {
    word = rn_fp8(y0) | rn_fp8(y1) << 8 | rn_fp8(y2) << 16 | rn_fp8(y3) << 24;
  }
  q[static_cast<size_t>(grow) * 32 + lane] = word;
  if (lane == 0) scales[grow] = scale;
}

// Row indices are 32-bit (the host takes fewer than 2^31 rows), addresses
// 64-bit.
template <bool kStochastic, int XB>
__global__ void __launch_bounds__(kThreads)
sr_quantize_kernel(const void* __restrict__ x, uint32_t* __restrict__ q,
                   float* __restrict__ scales, unsigned total_rows, unsigned rows,
                   unsigned seed, unsigned agent_stride) {
  const unsigned lane = threadIdx.x & 31;
  const unsigned stride = gridDim.x * kRowsPerBlock;
  unsigned grow = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (grow >= total_rows) return;  // the whole warp leaves together
  // agent a and row r within it of grow; a stride moves them by (da, dr)
  unsigned a = grow / rows;
  unsigned r = grow - a * rows;
  const unsigned da = stride / rows;
  const unsigned dr = stride - da * rows;
  float4 v = load_x<XB>(x, static_cast<size_t>(grow) * 32 + lane);
  for (;;) {
    const unsigned next = grow + stride;
    const bool more = next < total_rows;
    float4 nv;
    if (more) nv = load_x<XB>(x, static_cast<size_t>(next) * 32 + lane);  // in flight
    quantize_row<kStochastic>(v, grow, a, r, lane, q, scales, seed, agent_stride);
    if (!more) break;
    grow = next;
    v = nv;
    a += da;
    r += dr;
    if (r >= rows) {
      r -= rows;
      ++a;
    }
  }
}

// blocks of sr_quantize_kernel<kStochastic, XB> resident on device at once
// (cached per device: the card's SM count and the kernel's occupancy do not
// change in a process)
template <bool kStochastic, int XB>
cudaError_t resident_blocks(int device, long long* out) {
  static long long cached[64] = {};
  if (device >= 0 && device < 64 && cached[device] > 0) {
    *out = cached[device];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, sr_quantize_kernel<kStochastic, XB>, kThreads, 0);
  if (err != cudaSuccess) return err;
  *out = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (device >= 0 && device < 64) cached[device] = *out;
  return cudaSuccess;
}

template <bool kStochastic, int XB>
int launch(const void* x, void* q, float* scales, long long total_rows, long long rows,
           unsigned seed, unsigned agent_stride, int device, cudaStream_t st) {
  long long resident = 0;
  const cudaError_t err = resident_blocks<kStochastic, XB>(device, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long needed = (total_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const auto blocks = static_cast<unsigned>(needed < resident ? needed : resident);
  sr_quantize_kernel<kStochastic, XB><<<blocks, kThreads, 0, st>>>(
      x, static_cast<uint32_t*>(q), scales,
      static_cast<unsigned>(total_rows), static_cast<unsigned>(rows), seed, agent_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes.  x is (A, rows, 128) float32
// (x_kind 0) or bfloat16 (x_kind 1), q the
// (A, rows, 128) one-byte output (kind 2 = int8, 3 = float8_e4m3fn),
// scales the (A, rows, 1) float32 output; total_rows = A * rows.  device is
// the CUDA device ordinal of the tensors (this library links its own CUDA
// runtime and selects the device itself); stream is PyTorch's current
// stream there.  x must be 16-byte aligned (8 for bfloat16) and q 4-byte
// aligned (the wrapper checks 16 for both).  Returns the CUDA error of the device selection or of
// the launch (0 = launched); a call with nothing to do launches nothing.
extern "C" int sr_quantize(const void* x, int x_kind, void* q, int kind, float* scales,
                           long long total_rows, long long rows, unsigned seed,
                           unsigned agent_stride, int device, void* stream) {
  if (total_rows <= 0 || rows <= 0) return 0;
  if (kind != kKindInt8 && kind != kKindFp8) return static_cast<int>(cudaErrorInvalidValue);
  if (x_kind != kKindF32 && x_kind != kKindBF16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (total_rows > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  int current = -1;  // make device current unless it already is
  if (cudaGetDevice(&current) != cudaSuccess || current != device) {
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return static_cast<int>(set);
  }
  auto st = static_cast<cudaStream_t>(stream);
  if (x_kind == kKindF32) {
    return kind == kKindInt8
               ? launch<true, kKindF32>(x, q, scales, total_rows, rows, seed, agent_stride,
                                        device, st)
               : launch<false, kKindF32>(x, q, scales, total_rows, rows, seed,
                                         agent_stride, device, st);
  }
  return kind == kKindInt8
             ? launch<true, kKindBF16>(x, q, scales, total_rows, rows, seed, agent_stride,
                                       device, st)
             : launch<false, kKindBF16>(x, q, scales, total_rows, rows, seed,
                                        agent_stride, device, st);
}
