// The RWKV6 (Finch) WKV recurrence, for Hopper (sm_90a): the time-mix
// scan of the rwkv6 prefill.  Per batch x head, with an hs x hs float32
// state that starts at 0:
//
//   y_t[j]        = sum_i r_t[i] (S_t[i][j] + u[i] k_t[i] v_t[j])
//   S_{t+1}[i][j] = w_t[i] S_t[i][j] + k_t[i] v_t[j]
//
// r, k, v (B, S, NH, hs) or (BH, S, hs) in bfloat16 or float32 (one type),
// w and u float32; each with its own strides over
// (b, head, time) and the hs axis contiguous, so the model's (b, s, n_h,
// hs) projections are read in place (no fold, no cast pass).  y has r's
// type and layout; the final state is (B * NH, hs, hs) float32, S[i][j].
//
// Replaces: src/repro/kernels/rwkv_scan/rwkv_scan.py
//   wkv6_pallas (line 67; pallas_call line 86; body _wkv6_kernel, line 30).
//   The TPU kernel walks time chunks (grid axis) with the state resident in
//   VMEM; here one block walks all of time with the state in registers.
//   The reference needs S to be a multiple of its chunk; this kernel takes
//   any length (its time staging masks the last chunk).
//
// Bound on an H100 SXM: at the rwkv6-1.6b prefill shape (BH 128, S 2048,
// hs 64) the operations over the bytes.  Operations per step and head:
// y_j = sum_i r_i S_ij + v_j sum_i r_i u_i k_i is 2 hs^2 + 5 hs, and
// S <- w (.) S + k (x) v is 3 hs^2, so 5 hs^2 + 5 hs (5.45e9 in all, 0.081
// ms at 67 TFLOP/s); bytes: r, k, v, y bf16, w f32, the final state (~204
// MB, 0.061 ms).  The time loop is sequential: each step depends on the last.
//
// Design (simple): one block per (b, head) of 4 hs threads.  Thread (j,
// g) holds rows [g hs/4, (g+1) hs/4) of state column j in registers
// (hs / 4 floats) and u for those rows.  32 time steps of r, k, v and w
// are staged in shared memory (float32); a step computes the partial y_j
// over the thread's rows before updating them (the reference's order), the
// four partials of a column are summed with two shuffles, and the y of the
// chunk leaves through shared memory in coalesced rows.  BH = 128 blocks
// on 132 SMs under-fill the card; splitting the columns of a head over
// several blocks is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kT = 32;          // time steps staged per chunk

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

struct Strides {          // in elements: batch, head, time (hs is unit)
  long long b, h, t;
};

struct Operands {
  Strides r, k, v, w, y, u;   // u: batch and head strides only
};

// Stage steps [t0, t0 + kT) of one (b, head) row block into dst[t][i]
// (float32); steps at or past n_steps are zero.
template <typename T, int HS>
__device__ void stage(float* dst, const T* src, long long stride_t, int t0, int n_steps) {
  for (int idx = threadIdx.x; idx < kT * HS; idx += 4 * HS) {
    const int t = idx / HS;
    const int i = idx % HS;
    dst[idx] = t0 + t < n_steps ? to_f32(src[(t0 + t) * stride_t + i]) : 0.0f;
  }
}

template <typename T, int HS>
__global__ void __launch_bounds__(4 * HS)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
            const float* __restrict__ w, const float* __restrict__ u, T* __restrict__ y,
            float* __restrict__ state, int heads, int n_steps, Operands st) {
  constexpr int kRows = HS / 4;               // state rows per thread
  __shared__ float r_s[kT * HS], k_s[kT * HS], v_s[kT * HS], w_s[kT * HS], y_s[kT * HS];

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh % heads;
  const int j = threadIdx.x >> 2;             // state column
  const int g = threadIdx.x & 3;              // row group: rows g kRows ..
  const int i0 = g * kRows;

  const T* rb = r + b * st.r.b + h * st.r.h;
  const T* kb = k + b * st.k.b + h * st.k.h;
  const T* vb = v + b * st.v.b + h * st.v.h;
  const float* wb = w + b * st.w.b + h * st.w.h;
  T* yb = y + b * st.y.b + h * st.y.h;
  const float* ub = u + b * st.u.b + h * st.u.h;

  float s[kRows], uu[kRows];
#pragma unroll
  for (int ii = 0; ii < kRows; ++ii) {
    s[ii] = 0.0f;
    uu[ii] = ub[i0 + ii];
  }

  for (int t0 = 0; t0 < n_steps; t0 += kT) {
    __syncthreads();                          // the last chunk's y is written out
    stage<T, HS>(r_s, rb, st.r.t, t0, n_steps);
    stage<T, HS>(k_s, kb, st.k.t, t0, n_steps);
    stage<T, HS>(v_s, vb, st.v.t, t0, n_steps);
    stage<float, HS>(w_s, wb, st.w.t, t0, n_steps);
    __syncthreads();
    const int steps = min(kT, n_steps - t0);
    for (int t = 0; t < steps; ++t) {
      const float* rt = r_s + t * HS + i0;
      const float* kt = k_s + t * HS + i0;
      const float* wt = w_s + t * HS + i0;
      const float vj = v_s[t * HS + j];
      float acc = 0.0f;
#pragma unroll
      for (int ii = 0; ii < kRows; ++ii) {
        const float kv = __fmul_rn(kt[ii], vj);
        acc = fmaf(rt[ii], s[ii] + __fmul_rn(uu[ii], kv), acc);
        s[ii] = fmaf(wt[ii], s[ii], kv);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (g == 0) y_s[t * HS + j] = acc;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < steps * HS; idx += 4 * HS) {
      yb[(t0 + idx / HS) * st.y.t + idx % HS] = from_f32<T>(y_s[idx]);
    }
  }

  float* sb = state + static_cast<long long>(bh) * HS * HS;
#pragma unroll
  for (int ii = 0; ii < kRows; ++ii) sb[(i0 + ii) * HS + j] = s[ii];
}

template <typename T>
int dispatch_hs(int hs, const void* r, const void* k, const void* v, const float* w,
                const float* u, void* y, float* state, int batch, int heads, int n_steps,
                const Operands& st, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned int>(batch * heads));
  const T* rr = static_cast<const T*>(r);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  T* yy = static_cast<T*>(y);
  switch (hs) {
    case 16:
      wkv6_kernel<T, 16><<<grid, 64, 0, stream>>>(rr, kk, vv, w, u, yy, state, heads, n_steps,
                                                  st);
      break;
    case 32:
      wkv6_kernel<T, 32><<<grid, 128, 0, stream>>>(rr, kk, vv, w, u, yy, state, heads, n_steps,
                                                   st);
      break;
    case 64:
      wkv6_kernel<T, 64><<<grid, 256, 0, stream>>>(rr, kk, vv, w, u, yy, state, heads, n_steps,
                                                   st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes.  dtype (r, k, v, y): 0 float32, 1
// bfloat16; w and u float32.  hs in {16, 32, 64}.  strides: 17
// element strides, (b, head, time) of r, k, v, w, y, then (b, head) of u;
// the hs axis is contiguous.  state: (batch * heads, hs, hs) float32,
// contiguous.  Returns the CUDA error of the device selection or of the
// launch (0 = launched).
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
