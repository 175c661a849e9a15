// The RWKV6 (Finch) WKV recurrence, for Hopper (sm_90a): the time-mix
// scan of the rwkv6 prefill.  Per batch x head, with an hs x hs float32
// state that starts at 0:
//
//   y_t[j]        = sum_i r_t[i] S_t[i][j] + v_t[j] b_t,   b_t = sum_i r_t[i] u[i] k_t[i]
//   S_{t+1}[i][j] = w_t[i] S_t[i][j] + k_t[i] v_t[j]
//
// (the same function as y_t = r_t . (S_t + (u * k_t) v_t^T): the bonus term
// is one scalar per step).  r, k, v (B, S, NH, hs) or (BH, S, hs) in
// bfloat16 or float32 (one type), w and u float32; each with its own
// strides over (b, head, time) and the hs axis contiguous, so the model's
// (b, s, n_h, hs) projections are read in place (no fold, no cast pass).
// Each (b, head, time) row of r, k, v and w starts on 16 bytes (the wrapper
// copies an operand where it does not).  y has r's type and layout; the
// final state is (B * NH, hs, hs) float32, S[i][j].
//
// Replaces: src/repro/kernels/rwkv_scan/rwkv_scan.py
//   wkv6_pallas (line 67; pallas_call line 86; body _wkv6_kernel, line 30).
//   The TPU kernel walks time chunks (grid axis) with the state resident in
//   VMEM; here each block walks all of time with its state columns in
//   registers.  The reference needs S to be a multiple of its chunk; this
//   kernel takes any length (the last chunk is masked).
//
// Bound on an H100 SXM: at the rwkv6-1.6b prefill shape (BH 128, S 2048,
// hs 64) the operations.  Per step and head y is 2 hs^2 + 5 hs and the
// state update 3 hs^2: 5 hs^2 + 5 hs (5.45e9 in all, 0.081 ms at 67
// TFLOP/s); bytes: r, k, v, y bf16, w f32, the final state (~204 MB, 0.061
// ms).  Each step depends on the last, so the card is filled across heads
// and state elements, never across time.  Per state element and step the
// floor is 3 float32 instructions (k v, the y partial, the update).
//
// Design: one block of hs^2 / 8 threads per (b, head) (512 at hs 64: 16
// warps on each of 128 SMs), 32 time steps staged per chunk (16 at hs 16).
// - The state.  Thread (g, l) holds rows [4 g, 4 g + 4) of columns 2 l and
//   2 l + 1 in registers.  A warp's r, k and w reads are one 16-byte
//   address (a broadcast) and its v reads and y partials 256 consecutive
//   bytes: 3 float instructions per element and 5 shared-memory accesses
//   per 8 elements.  (Splitting a head's columns over 2 blocks, a thread
//   holding 8 rows of 1 column, loads 25 floats per 8 elements against 14
//   here, and ran slower.)
// - The bonus.  y_j = sum_i r_i S_ij + v_j b_t with the scalar b_t =
//   sum_i r_i u_i k_i summed once per step while the chunk is staged, so
//   the element loop is kv = k v (rounded), acc = fma(r, S, acc), S =
//   fma(w, S, kv): the state's arithmetic is the plain version's, unchanged.
//   y sums in another order: each thread's 4 rows in sequence, the hs / 4
//   row groups' partials as a tree, then fma(v_j, b_t, sum).
// - Staging.  The raw rows of chunk c+1 land in shared memory by 16-byte
//   cp.async while chunk c steps through float32 tiles.  At the chunk
//   boundary half the threads finish y of chunk c (the tree over the row
//   groups' partials, in 16-byte reads; y leaves in row order) while the
//   other half widen the landed rows of chunk c+1 into the tiles and sum
//   its bonus (v and b_t are double-buffered for that).
// What bounds it now: the element loop's float issue rate, then the chunk
// boundaries (2 __syncthreads and the partials' reduction), which stall the
// SM's only block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 4;        // state rows per thread
constexpr int kCols = 2;        // state columns per thread

// The tiling of one head size, fixed at compile time: one block per head.
template <int HS>
struct Tile {
  static constexpr int kT = HS >= 32 ? 32 : 16;            // time steps per chunk
  static constexpr int kGroups = HS / kRows;               // row groups
  static constexpr int kLanes = HS / kCols;                // threads per row group
  static constexpr int kThreads = kGroups * kLanes;
  static constexpr int kHalf = kThreads / 2;               // chunk boundary: y | staging
  static constexpr int kStageRows = kT * HS / kHalf;       // staging: rows per thread
  static constexpr int kStageLanes = HS / kStageRows;      // staging: threads per step
  // the staging half's lanes of a warp (a half warp at hs 16)
  static constexpr unsigned kStageMask =
      kHalf >= 32 ? 0xffffffffu : ((1u << kHalf) - 1u) << kHalf;
  static_assert(kThreads % 32 == 0 && kStageLanes <= 32 && kStageRows % 4 == 0, "tiling");
};

// Shared memory of one block, in bytes from the dynamic base (each a
// multiple of 16).
template <typename T, int HS>
struct Smem {
  using Tl = Tile<HS>;
  static constexpr int kT = Tl::kT;
  static constexpr int kRow = kT * HS;                        // elements of one tile
  static constexpr int kLandR = 0;                            // raw r, k, w, v [kT][HS]
  static constexpr int kLandK = kLandR + kRow * sizeof(T);
  static constexpr int kLandW = kLandK + kRow * sizeof(T);
  static constexpr int kLandV = kLandW + kRow * 4;
  static constexpr int kR = kLandV + kRow * sizeof(T);        // float tiles r, k, w
  static constexpr int kK = kR + kRow * 4;
  static constexpr int kW = kK + kRow * 4;
  static constexpr int kV = kW + kRow * 4;                    // float v [2][kT][HS]
  static constexpr int kB = kV + 2 * kRow * 4;                // bonus [2][kT]
  static constexpr int kPart = kB + 2 * kT * 4;               // y partials [kT][kGroups][HS]
  static constexpr int kBytes = kPart + kRow * Tl::kGroups * 4;
};

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// N consecutive values of shared memory into float registers, in 16- or
// 8-byte loads (p aligned to N elements, N even).
template <int N>
__device__ __forceinline__ void load(float (&x)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 f = reinterpret_cast<const float4*>(p)[q];
      x[4 * q] = f.x;
      x[4 * q + 1] = f.y;
      x[4 * q + 2] = f.z;
      x[4 * q + 3] = f.w;
    }
  } else {
    static_assert(N == 2, "even counts");
    const float2 f = *reinterpret_cast<const float2*>(p);
    x[0] = f.x;
    x[1] = f.y;
  }
}

template <int N>
__device__ __forceinline__ void load(float (&x)[N], const __nv_bfloat16* p) {
#pragma unroll
  for (int q = 0; q < N / 2; ++q) {
    const float2 f = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(p)[q]);
    x[2 * q] = f.x;
    x[2 * q + 1] = f.y;
  }
}

template <int N>
__device__ __forceinline__ void store(float* p, const float (&x)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      reinterpret_cast<float4*>(p)[q] =
          make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
    }
  } else {
    static_assert(N == 2, "even counts");
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  }
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 fills zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}

// Issue the copies of rows [t0, t0 + kT) of one operand into dst[kT][HS];
// rows at or past n_steps land as zeros.
template <typename T, int HS>
__device__ __forceinline__ void land(unsigned char* dst, const T* src, long long stride_t,
                                     int t0, int n_steps) {
  constexpr int kT = Tile<HS>::kT;
  constexpr int kPieces = HS * static_cast<int>(sizeof(T)) / 16;   // per row
  for (int idx = threadIdx.x; idx < kT * kPieces; idx += Tile<HS>::kThreads) {
    const int t = idx / kPieces;
    const int p = idx % kPieces;
    const bool in = t0 + t < n_steps;
    const T* row = src + (in ? (t0 + t) * stride_t : 0);
    cp_async16(dst + idx * 16, reinterpret_cast<const unsigned char*>(row) + p * 16, in ? 16 : 0);
  }
}

struct Strides {          // in elements: batch, head, time (hs is unit)
  long long b, h, t;
};

struct Operands {
  Strides r, k, v, w, y, u;   // u: batch and head strides only
};

template <typename T, int HS>
__global__ void __launch_bounds__(Tile<HS>::kThreads, 1)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
            const float* __restrict__ w, const float* __restrict__ u, T* __restrict__ y,
            float* __restrict__ state, int heads, int n_steps, Operands st) {
  using Tl = Tile<HS>;
  using Sm = Smem<T, HS>;
  constexpr int kT = Tl::kT, G = Tl::kGroups, SR = Tl::kStageRows, SL = Tl::kStageLanes;
  extern __shared__ __align__(16) unsigned char smem[];
  float* r_s = reinterpret_cast<float*>(smem + Sm::kR);
  float* k_s = reinterpret_cast<float*>(smem + Sm::kK);
  float* w_s = reinterpret_cast<float*>(smem + Sm::kW);
  float* v_s = reinterpret_cast<float*>(smem + Sm::kV);
  float* b_s = reinterpret_cast<float*>(smem + Sm::kB);
  float* part = reinterpret_cast<float*>(smem + Sm::kPart);

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh % heads;
  const int tid = threadIdx.x;
  const int g = tid / Tl::kLanes;         // row group: rows kRows g ..
  const int j = tid % Tl::kLanes * kCols; // state columns j, j + 1
  const int ts = (tid - Tl::kHalf) / SL;  // staging: step ts, rows SR qs ..
  const int qs = (tid - Tl::kHalf) % SL;

  const T* rb = r + b * st.r.b + h * st.r.h;
  const T* kb = k + b * st.k.b + h * st.k.h;
  const T* vb = v + b * st.v.b + h * st.v.h;
  const float* wb = w + b * st.w.b + h * st.w.h;
  T* yb = y + b * st.y.b + h * st.y.h;
  const float* ub = u + b * st.u.b + h * st.u.h;

  float uu[SR];
#pragma unroll
  for (int i = 0; i < SR; ++i) uu[i] = tid >= Tl::kHalf ? ub[qs * SR + i] : 0.0f;
  float s[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) s[i][c] = 0.0f;
  }

  const auto land_chunk = [&](int t0) {
    land<T, HS>(smem + Sm::kLandR, rb, st.r.t, t0, n_steps);
    land<T, HS>(smem + Sm::kLandK, kb, st.k.t, t0, n_steps);
    land<float, HS>(smem + Sm::kLandW, wb, st.w.t, t0, n_steps);
    land<T, HS>(smem + Sm::kLandV, vb, st.v.t, t0, n_steps);
    asm volatile("cp.async.commit_group;\n" ::);
  };

  const int n_chunks = (n_steps + kT - 1) / kT;
  land_chunk(0);
  for (int c = 0;; ++c) {
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();                      // chunk c landed; chunk c-1's steps done
    if (tid < Tl::kHalf) {                // y of chunk c-1: a tree over the row groups
      if (c > 0) {
        const int t0 = (c - 1) * kT;
        const float* vp = v_s + ((c - 1) & 1) * kT * HS;
        const float* bp = b_s + ((c - 1) & 1) * kT;
        for (int idx = tid; idx < kT * HS / 4; idx += Tl::kHalf) {
          const int t = idx / (HS / 4);
          const int jj = idx % (HS / 4) * 4;
          if (t0 + t >= n_steps) break;
          float q[G][4], vq[4];
#pragma unroll
          for (int gg = 0; gg < G; ++gg) load(q[gg], part + (t * G + gg) * HS + jj);
#pragma unroll
          for (int step = 1; step < G; step *= 2) {
#pragma unroll
            for (int gg = 0; gg < G; gg += 2 * step) {
#pragma unroll
              for (int e = 0; e < 4; ++e) q[gg][e] += q[gg + step][e];
            }
          }
          load(vq, vp + t * HS + jj);
          T* yt = yb + (t0 + t) * st.y.t + jj;
#pragma unroll
          for (int e = 0; e < 4; ++e) yt[e] = from_f32<T>(fmaf(vq[e], bp[t], q[0][e]));
        }
      }
    } else if (c < n_chunks) {            // meanwhile: widen chunk c; its bonus
      float rr[SR], kk[SR], ww[SR];
      const int off = ts * HS + qs * SR;
      load(rr, reinterpret_cast<const T*>(smem + Sm::kLandR) + off);
      load(kk, reinterpret_cast<const T*>(smem + Sm::kLandK) + off);
      load(ww, reinterpret_cast<const float*>(smem + Sm::kLandW) + off);
      float bonus = 0.0f;
#pragma unroll
      for (int i = 0; i < SR; ++i) bonus = fmaf(rr[i], __fmul_rn(uu[i], kk[i]), bonus);
#pragma unroll
      for (int m = 1; m < SL; m *= 2) bonus += __shfl_xor_sync(Tl::kStageMask, bonus, m);
      store(r_s + off, rr);
      store(k_s + off, kk);
      store(w_s + off, ww);
      float* vp = v_s + (c & 1) * kT * HS;
      if (qs == 0) b_s[(c & 1) * kT + ts] = bonus;
      const T* lv = reinterpret_cast<const T*>(smem + Sm::kLandV);
      for (int idx = tid - Tl::kHalf; idx < kT * HS / 4; idx += Tl::kHalf) {
        float x[4];
        load(x, lv + 4 * idx);
        store(vp + 4 * idx, x);
      }
    }
    if (c == n_chunks) break;
    __syncthreads();                      // tiles ready; the landing rows free
    if (c + 1 < n_chunks) land_chunk((c + 1) * kT);

    const float* vj = v_s + (c & 1) * kT * HS + j;
    const int steps = min(kT, n_steps - c * kT);
#pragma unroll 8
    for (int t = 0; t < steps; ++t) {           // the state recurrence
      float rr[kRows], kk[kRows], ww[kRows], vv[kCols];
      load(rr, r_s + t * HS + g * kRows);
      load(kk, k_s + t * HS + g * kRows);
      load(ww, w_s + t * HS + g * kRows);
      load(vv, vj + t * HS);
      float acc[kCols];
#pragma unroll
      for (int c2 = 0; c2 < kCols; ++c2) acc[c2] = 0.0f;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int c2 = 0; c2 < kCols; ++c2) {
          const float kv = __fmul_rn(kk[i], vv[c2]);
          acc[c2] = fmaf(rr[i], s[i][c2], acc[c2]);
          s[i][c2] = fmaf(ww[i], s[i][c2], kv);
        }
      }
      store(part + (t * G + g) * HS + j, acc);
    }
  }

  float* sb = state + static_cast<long long>(bh) * HS * HS + j;
#pragma unroll
  for (int i = 0; i < kRows; ++i) store(sb + (g * kRows + i) * HS, s[i]);
}

template <typename T, int HS>
int launch(const T* r, const T* k, const T* v, const float* w, const float* u, T* y,
           float* state, int batch, int heads, int n_steps, const Operands& st,
           cudaStream_t stream) {
  constexpr int bytes = Smem<T, HS>::kBytes;
  const cudaError_t set = cudaFuncSetAttribute(
      wkv6_kernel<T, HS>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(static_cast<unsigned int>(batch * heads));
  wkv6_kernel<T, HS><<<grid, Tile<HS>::kThreads, bytes, stream>>>(r, k, v, w, u, y, state,
                                                                 heads, n_steps, st);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hs(int hs, const void* r, const void* k, const void* v, const float* w,
                const float* u, void* y, float* state, int batch, int heads, int n_steps,
                const Operands& st, cudaStream_t stream) {
  const T* rr = static_cast<const T*>(r);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  T* yy = static_cast<T*>(y);
  switch (hs) {
    case 16:
      return launch<T, 16>(rr, kk, vv, w, u, yy, state, batch, heads, n_steps, st, stream);
    case 32:
      return launch<T, 32>(rr, kk, vv, w, u, yy, state, batch, heads, n_steps, st, stream);
    case 64:
      return launch<T, 64>(rr, kk, vv, w, u, yy, state, batch, heads, n_steps, st, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C interface, loaded with ctypes.  dtype (r, k, v, y): 0 float32, 1
// bfloat16; w and u float32.  hs in {16, 32, 64}.  strides: 17
// element strides, (b, head, time) of r, k, v, w, y, then (b, head) of u;
// the hs axis is contiguous, and every row of r, k, v and w starts on 16
// bytes.  state: (batch * heads, hs, hs) float32, contiguous.  Returns the
// CUDA error of the device selection or of the launch (0 = launched).
extern "C" int wkv6(const void* r, const void* k, const void* v, const float* w, const float* u,
                    void* y, float* state, int dtype, int batch, int heads, int n_steps, int hs,
                    const long long* strides, int device, void* stream) {
  if (batch <= 0 || heads <= 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const long long* p = strides;
  const Operands st{{p[0], p[1], p[2]},   {p[3], p[4], p[5]},    {p[6], p[7], p[8]},
                    {p[9], p[10], p[11]}, {p[12], p[13], p[14]}, {p[15], p[16], 0}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch_hs<float>(hs, r, k, v, w, u, y, state, batch, heads, n_steps, st, s);
  }
  if (dtype == 1) {
    return dispatch_hs<__nv_bfloat16>(hs, r, k, v, w, u, y, state, batch, heads, n_steps, st, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
