// Masked GQA attention with an online softmax, for Hopper (sm_90a): the
// prefill attention of the model zoo's transformer layers.
//
//   O[b, h] = softmax(scale * Q[b, h] K[b, g]^T + mask) V[b, g]
//   g = h / (H / KV)                (grouped-query: H query heads on KV heads)
//   mask: -inf where col > row (causal) or col <= row - window (window > 0),
//         from global row / column indices, as the reference builds them
//
// Q (B, H, Sq, D), K and V (B, KV, Sk, D), O (B, H, Sq, D), each with its
// own strides over (b, head, position) and the D axis contiguous, so the
// model's (b, s, heads, D) tensors are read and written in place without a
// transpose.  Inputs and output are bfloat16 or float32 (one type for
// all); every product, the running max, sum and accumulator are float32.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py
//   flash_attention (line 74; pallas_call line 107; body _flash_kernel,
//   line 34).  The same arithmetic: q is scaled in float32 before the dot;
//   masked scores are -1e30 and masked probabilities exactly 0
//   (p = exp(s - m) * allowed); the denominator is max(l, 1e-30).
//
// Bound on an H100 SXM: operations.  Each allowed (row, col) pair costs a
// D-long dot and a D-long axpy (4 D float32 operations); the bytes (each
// input read once, the output written once) are far below: at the gemma3-1b
// prefill shape (B 4, H 4, KV 1, S 2048, D 256, bf16) a causal layer is
// ~3.4e10 operations (0.51 ms at 67 TFLOP/s) against 42 MB (0.013 ms).
//
// Design (simple, float32 CUDA cores; wgmma and TMA are later work): one
// block of 256 threads per (64-row query tile, b * h), heaviest tiles
// (latest rows) first.  The scaled query tile stays in shared memory
// transposed (D x 64 floats); each 64-key tile of K (transposed) and V is
// staged through shared memory in float32.  A thread owns a 4 x 4 patch of
// the 64 x 64 score tile and a 4 x (D/16) patch of the output accumulator
// (registers), so the row state (max, sum) is per thread and reduced over
// the 16 lanes that share a row with shuffles.  Key tiles that the mask
// removes entirely (above the diagonal, or left of the window) are skipped:
// in the reference their p is 0 and their correction exp(m - m) is 1, so
// skipping them is exact.  At D = 256 the tiles take 208 KB of shared
// memory (one block per SM).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;              // query rows per block
constexpr int kBK = 64;              // keys per staged tile
constexpr float kNegInf = -1e30f;    // the reference's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 16 bytes of T: 4 floats or 8 bfloat16s, widened to float32.
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int kN = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&a);
#pragma unroll
    for (int e = 0; e < 8; ++e) out[e] = __bfloat162float(h[e]);
  }
};

struct Strides {          // in elements: batch, head, position (D is unit)
  long long b, h, s;
};

// Stage rows [row0, row0 + 64) of one (b, head) slice into shared memory,
// transposed: dst[d * 64 + r] = x[r][d] * mul.  Rows at or past n_rows are
// zero.  Consecutive threads take consecutive rows, so the stores hit
// consecutive banks.
template <typename T, int D>
__device__ void stage_transposed(float* dst, const T* src, long long stride_s, int row0,
                                 int n_rows, float mul, bool scaled) {
  constexpr int kN = Vec16<T>::kN;
  constexpr int kChunks = D / kN;
  for (int idx = threadIdx.x; idx < 64 * kChunks; idx += kThreads) {
    const int r = idx & 63;
    const int d0 = (idx >> 6) * kN;
    float val[kN];
    if (row0 + r < n_rows) {
      Vec16<T>::load(src + (row0 + r) * stride_s + d0, val);
    } else {
#pragma unroll
      for (int e = 0; e < kN; ++e) val[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      dst[(d0 + e) * 64 + r] = scaled ? __fmul_rn(val[e], mul) : val[e];
    }
  }
}

// Stage rows [row0, row0 + 64) as they are: dst[r * D + d] = x[r][d].
template <typename T, int D>
__device__ void stage_rows(float* dst, const T* src, long long stride_s, int row0, int n_rows) {
  constexpr int kN = Vec16<T>::kN;
  constexpr int kChunks = D / kN;
  for (int idx = threadIdx.x; idx < 64 * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int d0 = (idx % kChunks) * kN;
    float val[kN];
    if (row0 + r < n_rows) {
      Vec16<T>::load(src + (row0 + r) * stride_s + d0, val);
    } else {
#pragma unroll
      for (int e = 0; e < kN; ++e) val[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < kN; e += 4) {
      *reinterpret_cast<float4*>(dst + r * D + d0 + e) =
          make_float4(val[e], val[e + 1], val[e + 2], val[e + 3]);
    }
  }
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, int heads, int kv_heads, int sq, int sk, Strides qs,
             Strides ks, Strides vs, Strides os, float scale, int causal, int window) {
  constexpr int kCols = D / 16;              // output columns per thread
  extern __shared__ float4 smem4[];
  float* q_t = reinterpret_cast<float*>(smem4);     // (D, 64) scaled queries
  float* k_t = q_t + D * kBQ;                       // (D, 64) keys
  float* v_s = k_t + D * kBK;                       // (64, D) values
  float* p_t = v_s + kBK * D;                       // (64 keys, 64 rows)

  const int n_q = (sq + kBQ - 1) / kBQ;
  const int qi = n_q - 1 - static_cast<int>(blockIdx.x);   // latest rows first
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int g = h / (heads / kv_heads);
  const int q0 = qi * kBQ;
  const int tx = threadIdx.x & 15;           // score columns 4 tx .. 4 tx + 3
  const int ty = threadIdx.x >> 4;           // rows 4 ty .. 4 ty + 3

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + g * ks.h;
  const T* vb = v + b * vs.b + g * vs.h;

  // key tiles that hold at least one allowed column for these rows
  const int last_row = min(q0 + kBQ, sq) - 1;
  int hi = (sk - 1) / kBK;
  if (causal) hi = min(hi, last_row / kBK);
  int lo = 0;
  if (window > 0) {
    const int first_col = q0 - window + 1;      // smallest allowed column of row q0
    if (first_col > 0) lo = first_col / kBK;
  }

  stage_transposed<T, D>(q_t, qb, qs.s, q0, sq, scale, true);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                            // the previous tile is consumed
    stage_transposed<T, D>(k_t, kb, ks.s, k0, sk, 1.0f, false);
    stage_rows<T, D>(v_s, vb, vs.s, k0, sk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(q_t + d * kBQ + 4 * ty);
      const float4 c = *reinterpret_cast<const float4*>(k_t + d * kBK + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + 4 * tx + j;
        ok[j] = col < sk && (!causal || col <= row) && (window <= 0 || col > row - window);
        if (!ok[j]) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = ok[j] ? expf(s[i][j] - m_new) : 0.0f;
        sum += p[i][j];
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(p_t + (4 * tx + j) * kBQ + 4 * ty) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < kBK; ++c) {
      const float4 pr = *reinterpret_cast<const float4*>(p_t + c * kBQ + 4 * ty);
      const float pv[4] = {pr.x, pr.y, pr.z, pr.w};
#pragma unroll
      for (int jj = 0; jj < kCols / 4; ++jj) {
        const float4 vv = *reinterpret_cast<const float4*>(v_s + c * D + 4 * tx + 64 * jj);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * jj + 0] = fmaf(pv[i], vv.x, acc[i][4 * jj + 0]);
          acc[i][4 * jj + 1] = fmaf(pv[i], vv.y, acc[i][4 * jj + 1]);
          acc[i][4 * jj + 2] = fmaf(pv[i], vv.z, acc[i][4 * jj + 2]);
          acc[i][4 * jj + 3] = fmaf(pv[i], vv.w, acc[i][4 * jj + 3]);
        }
      }
    }
  }

  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < kCols / 4; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ob[row * os.s + 4 * tx + 64 * jj + e] = from_f32<T>(__fdiv_rn(acc[i][4 * jj + e], denom));
      }
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int heads,
           int kv_heads, int sq, int sk, const long long* st, float scale, int causal,
           int window, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * D * 64 + 64 * D + 64 * 64);
  auto kernel = flash_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]}, vs{st[6], st[7], st[8]},
      os{st[9], st[10], st[11]};
  const dim3 grid(static_cast<unsigned int>((sq + kBQ - 1) / kBQ),
                  static_cast<unsigned int>(batch * heads));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), heads, kv_heads, sq, sk, qs, ks, vs, os, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v, void* o, int batch,
               int heads, int kv_heads, int sq, int sk, const long long* st, float scale,
               int causal, int window, cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch<T, 64>(q, k, v, o, batch, heads, kv_heads, sq, sk, st, scale, causal,
                           window, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, batch, heads, kv_heads, sq, sk, st, scale, causal,
                            window, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, batch, heads, kv_heads, sq, sk, st, scale, causal,
                            window, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C interface, loaded with ctypes.  dtype: 0 float32, 1 bfloat16 (q,
// k, v and o alike).  d in {64, 128, 256}; heads a multiple of kv_heads.
// strides: 12 element strides, (b, head, position) of q, k, v, o in that
// order; the D axis is contiguous and every row 16-byte aligned.  window
// <= 0 means no window.  Returns the CUDA error of the device selection, the
// shared-memory attribute or the launch (0 = launched).
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o,
                               int dtype, int batch, int heads, int kv_heads, int sq, int sk,
                               int d, const long long* strides, float scale, int causal,
                               int window, int device, void* stream) {
  if (heads <= 0 || kv_heads <= 0 || heads % kv_heads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch <= 0 || sq <= 0 || sk <= 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch_d<float>(d, q, k, v, o, batch, heads, kv_heads, sq, sk, strides, scale,
                             causal, window, s);
  }
  if (dtype == 1) {
    return dispatch_d<__nv_bfloat16>(d, q, k, v, o, batch, heads, kv_heads, sq, sk, strides,
                                     scale, causal, window, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
