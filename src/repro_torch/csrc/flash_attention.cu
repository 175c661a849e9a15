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
// transpose.  Any Sq, Sk >= 1.  q, k, v and o share one type: float32 runs
// flash_kernel (CUDA cores), bfloat16 runs flash_tc_kernel (tensor cores).
// D is 64, 128 or 256, or 120 (h2o-danube-3-4b), which runs the kernels of
// width 128 with columns 120-127 zero-filled as they land (wgmma's bf16 K
// step is 16, and flash_kernel's tiles are 64 columns wide): the zeros add
// exact zero terms to Q K^T, P V's padded columns are dropped at the store.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py
//   flash_attention (line 74; pallas_call line 107; body _flash_kernel,
//   line 34).  The same arithmetic: masked scores are -1e30 and masked
//   probabilities exactly 0 (p = exp(s - m) * allowed); the denominator is
//   max(l, 1e-30); the running max, sum and accumulator are float32.
//
// Bound on an H100 SXM: operations.  Each allowed (row, col) pair costs a
// D-long dot and a D-long axpy (4 D operations); the bytes (each input read
// once, the output written once) are far below.  At the gemma3-1b prefill
// shape (B 4, H 4, KV 1, S 2048, D 256) a causal layer is 3.4e10 operations
// against 42 MB of bf16 (0.013 ms): 0.51 ms at float32's 67 TFLOP/s, 0.035
// ms at the bf16 tensor cores' 989 TFLOP/s (the 512 window: 1.5e10, 0.224
// and 0.015 ms).
//
// flash_kernel (float32, CUDA cores): what bounds it is the float32 FMA
// rate of each SM and, at short lengths, how many SMs have work: one block
// per (64-row query tile, b * h) gave 40 blocks on 132 SMs at b 1, s 640,
// 4 heads, the last tile's key loop run serially on one SM.  So:
//  - Units.  A query tile's key tiles (those the mask leaves) are cut into
//    splits of at most max_tiles tiles, max_tiles chosen per call so that
//    about kWaves x the resident blocks run.  One block per unit, 1-d grid:
//    (b, head) fastest, query tiles latest first (most key tiles first).
//    A split writes its row state (m, l) and its unnormalised O to the
//    workspace; the last split of a tile to finish (an atomic ticket,
//    zeroed by a memset in the launch) combines them in split order (M =
//    max m, L = sum l e^(m - M), O = sum O e^(m - M), out = O / max(L,
//    1e-30)), so the result does not depend on the order the splits end.
//  - Key tiles of 128 keys; a thread owns a 4 x 8 patch of the 64 x 128
//    score tile (rows ty + 16 i, keys tx + 16 j: conflict-free 16-byte
//    shared loads along D, 12 loads per 128 FMAs) and a 4 x (D / 16) patch
//    of O in registers; the row state is per thread and reduced over the 16
//    lanes of a row with shuffles.  P goes through shared memory (keys by
//    rows, padded).
//  - One block of 256 threads an SM (up to 255 registers a thread): the
//    scaled query tile stays in shared memory (64 x D, padded rows), and K
//    and V stream through a 3-slot cp.async ring of 34 KB chunks (K: 128
//    keys by 64 of D, padded rows; V: 8192 / D keys by D), so chunk i + 2
//    lands while chunk i computes: 205,824 bytes at D = 256.
// The arithmetic is the reference's: q scaled in float32 before the dot,
// masked scores -1e30 and masked p exactly 0, the denominator max(l,
// 1e-30); key tiles the mask removes entirely are skipped (their p is 0 and
// their correction exp(m - m) 1 in the reference, so skipping is exact).
// A split sums the keys in another order than one block would: results
// agree with the plain version to the reference's float32 tolerance.

// flash_tc_kernel (bfloat16; wgmma and TMA): the float32 cores cap the
// bf16 path at 67 TFLOP/s, 15x under the tensor cores.  One block of two
// warpgroups (256 threads) per (128-row query tile, b * h), latest rows
// first; each warpgroup owns 64 rows, wgmma's M.  256 threads leave 255
// registers a thread (228 used at D = 256, no spills): the O accumulator
// alone is D / 2 of them.  A producer warp or warpgroup beside them caps
// the block at 168 registers a thread, and setmaxnreg did not lift that
// for this kernel (ptxas spilled and serialized the wgmmas).
//  - Copies: TMA, one 64-column box (128 bytes, the swizzle span) at a
//    time, with 128-byte swizzle, through 4-d tensor maps over the strided
//    (b, head, position) views; out-of-range rows arrive as zeros.  Q (128
//    x D) is loaded once; K and V go through 2-stage rings of 64-key tiles
//    with mbarriers of their own ("full" when a tile has landed, "empty"
//    once all 256 threads are done with it: K after its S product, V
//    after its PV product).  Warpgroup 0 issues the loads (thread 0, by
//    predicate: a branch on one thread would make wgmma's path divergent
//    and ptxas serializes the wgmmas): K or V of tile i + 2 as soon as both
//    warpgroups have released it for tile i.  At D = 256: Q 64 KB + 2 x
//    (32 + 32) KB = 192 KB of shared memory.
//  - S = Q K^T: wgmma.m64n64k16 with both operands in shared memory (K's
//    rows are keys with D contiguous: the K-major B operand), D / 16
//    k-steps into 32 float32 registers a thread.
//  - Online softmax in registers (float32, base 2: s * scale * log2 e,
//    ex2.approx): a row's 64 scores lie on the 4 lanes of a quad, so its
//    max is reduced with two shuffles; the sum stays per lane until the
//    end.  Only tiles that cross the diagonal, the window's edge or Sk are
//    masked; tiles the mask removes for all of a warpgroup's rows are
//    skipped (exact, as above).
//  - O = corr O + P V: wgmma.m64n64k16 with P as the register A operand
//    (the S accumulator rounded to bf16 pairs: the accumulator and A
//    fragments share their layout), V from shared memory as the MN-major B
//    operand (transposed), one product per 64 output columns; O is D / 2
//    float32 registers a thread (128 at D = 256).
//  - Overlap within a warpgroup (FA3's order): for tile i, S_i is issued,
//    O is rescaled and PV of tile i - 1 issued behind it; once S_i is done
//    its softmax runs on the CUDA cores while PV of tile i - 1 is still on
//    the tensor cores.  No register that an in-flight wgmma writes is
//    touched meanwhile (else ptxas serializes the wgmmas).
//  - The output goes from registers to the strided O directly; rows at or
//    past Sq are not written.
// P is rounded to bf16 before the PV product, where the reference keeps
// float32: the results differ by about one bf16 step of p (held at the
// reference's bf16 tolerance, 2e-2).
// cuTensorMapEncodeTiled comes from cudaGetDriverEntryPoint (no -lcuda).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;    // the reference's NEG_INF

struct Strides {          // in elements: batch, head, position (D is unit)
  long long b, h, s;
};

// ---------------------------------------------------------------------------
// float32 operands: CUDA cores

namespace f32 {

constexpr int kThreads = 256;
constexpr int kBQ = 64;                  // query rows of a unit
constexpr int kBK = 128;                 // keys of a key tile
constexpr int kKJ = kBK / 16;            // its keys in a thread's score patch
constexpr int kKC = 64;                  // a K chunk: kBK keys by 64 of D
constexpr int kKStride = kKC + 4;        // its padded key row (floats)
constexpr int kPStride = kBQ + 4;        // P's padded key row (floats)
constexpr int kStages = 3;               // cp.async ring depth
constexpr int kSlot = kBK * kKStride;    // floats in a ring slot (K chunk, padded)
constexpr int kMinBlocks = 1;            // blocks resident on an SM
constexpr int kWaves = 2;                // units aimed for, in resident blocks

template <int D>
struct Cfg {
  static constexpr int kQStride = D + 4;                 // Q's padded row (floats)
  static constexpr int kVC = kBK * kKC / D;              // keys of a V chunk
  static constexpr int kKChunks = D / kKC;
  static constexpr int kChunks = kKChunks + kBK / kVC;   // ring chunks per key tile
  static constexpr int kCols = D / 16;                   // output columns a thread
  static constexpr size_t kSmem =
      sizeof(float) * (kBQ * kQStride + kBK * kPStride + kStages * kSlot);
};

// The number of key tiles that hold an allowed column for query tile qi,
// from key tile *lo on.
__host__ __device__ inline int key_tiles(int qi, int sq, int sk, int causal, int window,
                                         int* lo) {
  const int q0 = qi * kBQ;
  const int last_row = (q0 + kBQ < sq ? q0 + kBQ : sq) - 1;
  int hi = (sk - 1) / kBK;
  if (causal && last_row / kBK < hi) hi = last_row / kBK;
  *lo = 0;
  if (window > 0 && q0 - window + 1 > 0) *lo = (q0 - window + 1) / kBK;
  return hi >= *lo ? hi - *lo + 1 : 0;
}

// The units that a query tile of n key tiles is cut into.
__host__ __device__ inline int n_splits(int n, int max_tiles) {
  return n > max_tiles ? (n + max_tiles - 1) / max_tiles : 1;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
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

// Copy ring chunk j of the key tile at k0 into `slot`: a K chunk (its kBK
// keys, D columns kKC j .. kKC j + kKC - 1, padded rows) or a V chunk (kVC
// keys, all of D).  Keys at or past sk, and columns at or past the operands'
// head dim DR (a head dim padded to D), arrive as zeros (a copy of source
// size 0).  A thread copies 16 bytes at a fixed column of rows r, r + kRows,
// ...
template <int D, int DR>
__device__ __forceinline__ void issue_chunk(float* slot, const float* kb, const float* vb,
                                            long long ks_s, long long vs_s, int k0, int j,
                                            int sk) {
  using C = Cfg<D>;
  if (j < C::kKChunks) {
    constexpr int kPer = kKC / 4, kRows = kThreads / kPer;
    const int r = threadIdx.x / kPer, c4 = threadIdx.x % kPer;
    const bool col_ok = j * kKC + 4 * c4 < DR;
    const float* src = kb + (k0 + r) * ks_s + j * kKC + 4 * c4;
    float* dst = slot + r * kKStride + 4 * c4;
#pragma unroll
    for (int it = 0; it < kBK / kRows; ++it) {
      const bool ok = col_ok && k0 + r + it * kRows < sk;
      cp_async16(dst + it * kRows * kKStride, ok ? src + it * kRows * ks_s : kb, ok);
    }
  } else {
    constexpr int kPer = D / 4, kRows = kThreads / kPer;
    const int key0 = k0 + (j - C::kKChunks) * C::kVC;
    const int r = threadIdx.x / kPer, c4 = threadIdx.x % kPer;
    const bool col_ok = 4 * c4 < DR;
    const float* src = vb + (key0 + r) * vs_s + 4 * c4;
    float* dst = slot + r * D + 4 * c4;
#pragma unroll
    for (int it = 0; it < C::kVC / kRows; ++it) {
      const bool ok = col_ok && key0 + r + it * kRows < sk;
      cp_async16(dst + it * kRows * D, ok ? src + it * kRows * vs_s : vb, ok);
    }
  }
}

// D is the tile width (64, 128 or 256); DR <= D the operands' head dim:
// columns DR .. D - 1 of Q, K and V are zeros in shared memory, add exact
// zeros to every score, give zero output columns and are not stored.
template <int D, int DR>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int n_bh, int heads,
             int kv_heads, int sq, int sk, Strides qs, Strides ks, Strides vs, Strides os,
             float scale, int causal, int window, int max_tiles, int* __restrict__ tickets,
             float2* __restrict__ part_ml, float* __restrict__ part_o) {
  using C = Cfg<D>;
  constexpr int kCols = C::kCols;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);    // (64 rows, D) scaled queries
  float* p_s = q_s + kBQ * C::kQStride;            // (64 keys, 64 rows) probabilities
  float* ring = p_s + kBK * kPStride;              // kStages chunk slots
  __shared__ bool last_split;

  // This block's unit: (b, head) fastest, then query tiles latest first,
  // each cut into n_splits units of key ranges as equal as they can be.
  const int bh = static_cast<int>(blockIdx.x % n_bh);
  int unit = static_cast<int>(blockIdx.x / n_bh);
  const int n_q = (sq + kBQ - 1) / kBQ;
  int qi = 0, lo = 0, n = 0, splits = 1, split_base = 0;
  for (int t = 0; t < n_q; ++t) {
    qi = n_q - 1 - t;
    n = key_tiles(qi, sq, sk, causal, window, &lo);
    splits = n_splits(n, max_tiles);
    if (unit < splits) break;
    unit -= splits;
    if (splits > 1) split_base += splits;
  }
  const int split = unit;
  const int t_begin = lo + split * (n / splits) + min(split, n % splits);
  const int n_tiles = n / splits + (split < n % splits ? 1 : 0);

  const int b = bh / heads;
  const int h = bh % heads;
  const int g = h / (heads / kv_heads);
  const int q0 = qi * kBQ;
  const int tx = threadIdx.x & 15;     // keys tx + 16 jj; columns 4 tx + 64 jj + e
  const int ty = threadIdx.x >> 4;     // rows ty + 16 i
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + g * ks.h;
  const float* vb = v + b * vs.b + g * vs.h;

  const int n_chunks = n_tiles * C::kChunks;
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < n_chunks) {
      issue_chunk<D, DR>(ring + c * kSlot, kb, vb, ks.s, vs.s,
                         (t_begin + c / C::kChunks) * kBK, c % C::kChunks, sk);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }
  // the scaled query tile, while the first chunks land
  for (int idx = threadIdx.x; idx < kBQ * D / 4; idx += kThreads) {
    const int r = idx / (D / 4), c4 = idx % (D / 4);
    float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (q0 + r < sq && 4 * c4 < DR) {
      val = *reinterpret_cast<const float4*>(qb + (q0 + r) * qs.s + 4 * c4);
      val = make_float4(__fmul_rn(val.x, scale), __fmul_rn(val.y, scale),
                        __fmul_rn(val.z, scale), __fmul_rn(val.w, scale));
    }
    *reinterpret_cast<float4*>(q_s + r * C::kQStride + 4 * c4) = val;
  }

  float m[4], l[4], acc[4][kCols], s[4][kKJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
#pragma unroll
    for (int jj = 0; jj < kKJ; ++jj) s[i][jj] = 0.0f;
  }

  for (int c = 0; c < n_chunks; ++c) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
    __syncthreads();               // chunk c has landed; chunk c - 1's slot is free
    const int cn = c + kStages - 1;
    if (cn < n_chunks) {
      issue_chunk<D, DR>(ring + (cn % kStages) * kSlot, kb, vb, ks.s, vs.s,
                         (t_begin + cn / C::kChunks) * kBK, cn % C::kChunks, sk);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    const float* slot = ring + (c % kStages) * kSlot;
    const int j = c % C::kChunks;
    if (j < C::kKChunks) {
      // S += Q[:, 32 j .. 32 j + 31] K_chunk^T, in d order
      const float* qrow = q_s + ty * C::kQStride + j * kKC;
      const float* krow = slot + tx * kKStride;
#pragma unroll
      for (int dq = 0; dq < kKC / 4; ++dq) {
        float4 kv[kKJ];
#pragma unroll
        for (int jj = 0; jj < kKJ; ++jj) {
          kv[jj] = *reinterpret_cast<const float4*>(krow + 16 * jj * kKStride + 4 * dq);
        }
float4 qv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qv[i] = *reinterpret_cast<const float4*>(qrow + 16 * i * C::kQStride + 4 * dq);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < kKJ; ++jj) s[i][jj] = fmaf(qv[i].x, kv[jj].x, s[i][jj]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < kKJ; ++jj) s[i][jj] = fmaf(qv[i].y, kv[jj].y, s[i][jj]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < kKJ; ++jj) s[i][jj] = fmaf(qv[i].z, kv[jj].z, s[i][jj]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < kKJ; ++jj) s[i][jj] = fmaf(qv[i].w, kv[jj].w, s[i][jj]);
      }
      if (j == C::kKChunks - 1) {
        // the key tile's online softmax; P to shared memory
        const int k0 = (t_begin + c / C::kChunks) * kBK;
        float p[4][kKJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = q0 + ty + 16 * i;
          bool ok[kKJ];
          float mx = kNegInf;
#pragma unroll
          for (int jj = 0; jj < kKJ; ++jj) {
            const int col = k0 + tx + 16 * jj;
            ok[jj] = col < sk && (!causal || col <= row) && (window <= 0 || col > row - window);
            if (!ok[jj]) s[i][jj] = kNegInf;
            mx = fmaxf(mx, s[i][jj]);
          }
          const float m_new = fmaxf(m[i], row_max16(mx));
          float sum = 0.0f;
#pragma unroll
          for (int jj = 0; jj < kKJ; ++jj) {
            p[i][jj] = ok[jj] ? expf(s[i][jj] - m_new) : 0.0f;
            sum += p[i][jj];
            s[i][jj] = 0.0f;
          }
          const float corr = expf(m[i] - m_new);
          l[i] = l[i] * corr + row_sum16(sum);
          m[i] = m_new;
#pragma unroll
          for (int cc = 0; cc < kCols; ++cc) acc[i][cc] *= corr;
        }
#pragma unroll
        for (int jj = 0; jj < kKJ; ++jj) {
          *reinterpret_cast<float4*>(p_s + (tx + 16 * jj) * kPStride + 4 * ty) =
              make_float4(p[0][jj], p[1][jj], p[2][jj], p[3][jj]);
        }
      }
    } else {
      // O += P[:, this chunk's keys] V_chunk, in key order
      const int key0 = (j - C::kKChunks) * C::kVC;
#pragma unroll
      for (int kk = 0; kk < C::kVC; ++kk) {
        const float4 pr =
            *reinterpret_cast<const float4*>(p_s + (key0 + kk) * kPStride + 4 * ty);
        const float pv[4] = {pr.x, pr.y, pr.z, pr.w};
#pragma unroll
        for (int jj = 0; jj < kCols / 4; ++jj) {
          const float4 vv = *reinterpret_cast<const float4*>(slot + kk * D + 4 * tx + 64 * jj);
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
  }
  asm volatile("cp.async.wait_all;\n" ::);

  float* ob = o + b * os.b + h * os.h;
  if (splits > 1) {
    // A split writes its (m, l) and unnormalised O; the last split of the
    // query tile to finish (a ticket) combines them all in split order, so
    // the result does not depend on which split is last.
    const long long first = static_cast<long long>(split_base) * n_bh + bh;
    float* mine = part_o + ((first + static_cast<long long>(split) * n_bh) * kBQ) * D;
    float2* mine_ml = part_ml + (first + static_cast<long long>(split) * n_bh) * kBQ;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      if (tx == 0) mine_ml[r] = make_float2(m[i], l[i]);
#pragma unroll
      for (int jj = 0; jj < kCols / 4; ++jj) {
        *reinterpret_cast<float4*>(mine + r * D + 4 * tx + 64 * jj) = make_float4(
            acc[i][4 * jj], acc[i][4 * jj + 1], acc[i][4 * jj + 2], acc[i][4 * jj + 3]);
      }
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      last_split = atomicAdd(tickets + static_cast<long long>(qi) * n_bh + bh, 1) == splits - 1;
    }
    __syncthreads();
    if (!last_split) return;
    __threadfence();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      float mm = kNegInf;
      for (int sp = 0; sp < splits; ++sp) {
        mm = fmaxf(mm, __ldcg(part_ml + (first + static_cast<long long>(sp) * n_bh) * kBQ + r).x);
      }
      float ll = 0.0f;
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) acc[i][cc] = 0.0f;
      for (int sp = 0; sp < splits; ++sp) {
        const long long at = (first + static_cast<long long>(sp) * n_bh) * kBQ + r;
        const float2 ml = __ldcg(part_ml + at);
        const float w = expf(ml.x - mm);
        ll = fmaf(ml.y, w, ll);
#pragma unroll
        for (int jj = 0; jj < kCols / 4; ++jj) {
          const float4 pv = __ldcg(reinterpret_cast<const float4*>(part_o + at * D + 4 * tx +
                                                                   64 * jj));
          acc[i][4 * jj + 0] = fmaf(pv.x, w, acc[i][4 * jj + 0]);
          acc[i][4 * jj + 1] = fmaf(pv.y, w, acc[i][4 * jj + 1]);
          acc[i][4 * jj + 2] = fmaf(pv.z, w, acc[i][4 * jj + 2]);
          acc[i][4 * jj + 3] = fmaf(pv.w, w, acc[i][4 * jj + 3]);
        }
      }
      l[i] = ll;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < kCols / 4; ++jj) {
      if (4 * tx + 64 * jj >= DR) continue;
      *reinterpret_cast<float4*>(ob + row * os.s + 4 * tx + 64 * jj) = make_float4(
          __fdiv_rn(acc[i][4 * jj], denom), __fdiv_rn(acc[i][4 * jj + 1], denom),
          __fdiv_rn(acc[i][4 * jj + 2], denom), __fdiv_rn(acc[i][4 * jj + 3], denom));
    }
  }
}

// Resident blocks of flash_kernel<D, DR> on `device` (cached per device; the
// call also lifts the kernel's shared-memory limit).
template <int D, int DR>
cudaError_t resident_blocks(int device, int* out) {
  static int cached[64] = {};
  if (device >= 0 && device < 64 && cached[device] > 0) {
    *out = cached[device];
    return cudaSuccess;
  }
  auto kernel = flash_kernel<D, DR>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(Cfg<D>::kSmem));
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, Cfg<D>::kSmem);
  if (err != cudaSuccess) return err;
  *out = sms * (per_sm > 0 ? per_sm : 1);
  if (device >= 0 && device < 64) cached[device] = *out;
  return cudaSuccess;
}

// The plan of one call: the most key tiles a unit takes, the units and the
// split units of one (b, head), and the workspace bytes (tickets, then
// each split unit's (m, l) and O).
struct Plan {
  int max_tiles = 1;
  long long units = 0, split_units = 0, ticket_bytes = 0, ws_bytes = 0;
};

template <int D, int DR>
cudaError_t plan(int n_bh, int sq, int sk, int causal, int window, int device, Plan* p) {
  int resident = 0;
  const cudaError_t err = resident_blocks<D, DR>(device, &resident);
  if (err != cudaSuccess) return err;
  const int n_q = (sq + kBQ - 1) / kBQ;
  long long work = 0;
  int lo = 0;
  for (int qi = 0; qi < n_q; ++qi) work += key_tiles(qi, sq, sk, causal, window, &lo);
  work *= n_bh;
  const long long aim = static_cast<long long>(kWaves) * resident;
  const long long t = (work + aim - 1) / aim;
  p->max_tiles = t < 1 ? 1 : static_cast<int>(t);
  for (int qi = 0; qi < n_q; ++qi) {
    const int ns = n_splits(key_tiles(qi, sq, sk, causal, window, &lo), p->max_tiles);
    p->units += ns;
    if (ns > 1) p->split_units += ns;
  }
  if (p->split_units > 0) {
    p->ticket_bytes = static_cast<long long>(n_q) * n_bh * sizeof(int);
    p->ws_bytes = (p->ticket_bytes + 255) / 256 * 256 +
                  p->split_units * n_bh * kBQ * (sizeof(float2) + D * sizeof(float));
  }
  return cudaSuccess;
}

template <int D, int DR = D>
int workspace(int batch, int heads, int sq, int sk, int causal, int window, int device,
              long long* bytes) {
  Plan p;
  const cudaError_t err = plan<D, DR>(batch * heads, sq, sk, causal, window, device, &p);
  *bytes = p.ws_bytes;
  return static_cast<int>(err);
}

template <int D, int DR = D>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int heads,
           int kv_heads, int sq, int sk, const long long* st, float scale, int causal,
           int window, void* ws, long long ws_bytes, int device, cudaStream_t stream) {
  const int n_bh = batch * heads;
  Plan p;
  cudaError_t err = plan<D, DR>(n_bh, sq, sk, causal, window, device, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ws_bytes < p.ws_bytes || (p.ws_bytes > 0 && ws == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int* tickets = nullptr;
  float2* part_ml = nullptr;
  float* part_o = nullptr;
  if (p.split_units > 0) {
    tickets = static_cast<int*>(ws);
    part_ml = reinterpret_cast<float2*>(static_cast<char*>(ws) +
                                        (p.ticket_bytes + 255) / 256 * 256);
    part_o = reinterpret_cast<float*>(part_ml + p.split_units * n_bh * kBQ);
    err = cudaMemsetAsync(tickets, 0, p.ticket_bytes, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]}, vs{st[6], st[7], st[8]},
      os{st[9], st[10], st[11]};
  flash_kernel<D, DR><<<static_cast<unsigned>(p.units * n_bh), kThreads, Cfg<D>::kSmem,
                        stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), n_bh, heads, kv_heads, sq, sk, qs, ks, vs, os, scale, causal,
      window, p.max_tiles, tickets, part_ml, part_o);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bfloat16 operands: tensor cores

namespace tc {

constexpr int kThreads = 256;        // two warpgroups
constexpr int kBQ = 128;             // query rows per block, 64 per warpgroup
constexpr int kBK = 64;              // keys per tile
constexpr int kBox = 64;             // bf16 columns per TMA box: 128 bytes
constexpr int kRowBytes = 128;       // one box row in shared memory
constexpr float kLog2e = 1.4426950408889634f;

// The tensor-map dimension (1..3; 0 is D) of position, head and batch: the
// maps order them by stride.
struct Order {
  int s, h, b;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.  A
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

// Where `pred`: arrive on the barrier and add `bytes` to its expected
// transactions.  Predicated, not branched: wgmma's warpgroups stay convergent.
__device__ __forceinline__ void mbar_expect_tx(bool pred, uint32_t bar, uint32_t bytes) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %2, 0;\n\t"
      "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n\t}" ::"r"(bar),
      "r"(bytes), "r"(static_cast<int>(pred))
      : "memory");
}

// Where `pred`: one TMA box of a 4-d map into shared memory, completing on
// `bar` (predicated, as above).
__device__ __forceinline__ void tma_load(bool pred, uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2, int c3) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %7, 0;\n\t"
      "@p cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n\t}" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(static_cast<int>(pred))
      : "memory");
}

// Box `c` of the tile whose rows start at `row` of (head, batch), under
// the map's dimension `order`.
__device__ __forceinline__ void tma_box(bool pred, uint32_t dst, const CUtensorMap* map,
                                        const Order& order, uint32_t bar, int c, int row,
                                        int head, int batch) {
  const int c1 = order.s == 1 ? row : (order.h == 1 ? head : batch);
  const int c2 = order.s == 2 ? row : (order.h == 2 ? head : batch);
  const int c3 = order.s == 3 ? row : (order.h == 3 ? head : batch);
  tma_load(pred, dst, map, bar, c * kBox, c1, c2, c3);
}

// wgmma's shared-memory descriptor of a tile in the 128-byte swizzle
// layout (what TMA writes with CU_TENSOR_MAP_SWIZZLE_128B): start address,
// then both byte offsets at 1024 B (eight 128-byte rows, the swizzle atom)
// in 16-byte units, layout type 1 (128-byte swizzle).  Every operand here
// spans one atom in its contiguous dimension, so the offset along it is
// unused and the other steps over 8-row groups.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(64) << 16) |
         (static_cast<uint64_t>(64) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

// Keep the compiler from moving accesses of wgmma's registers across the
// wait that completes them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define TC_D32                                                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define TC_OUT32(d)                                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),         \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d (64 x 64, f32) (+)= A (64 x 16) B (16 x 64): A and B K-major in shared
// memory.  `accumulate` 0 overwrites d.
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TC_D32
      ", %32, %33, p, 1, 1, 0, 0;\n\t}"
      : TC_OUT32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16, registers) B (16 x 64): B MN-major in
// shared memory (the transpose bit).
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TC_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n\t}"
      : TC_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef TC_D32
#undef TC_OUT32

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Key tiles [lo, hi] with an allowed column for rows [r0, min(r0 + 63,
// sq - 1)]; lo > hi when there is none.
__device__ __forceinline__ void tile_range(int r0, int sq, int sk, int causal, int window,
                                           int& lo, int& hi) {
  const int r1 = min(r0 + 63, sq - 1);
  lo = 0;
  hi = (sk - 1) / kBK;
  if (r0 > r1) {
    lo = 1;
    hi = 0;
    return;
  }
  if (causal) hi = min(hi, r1 / kBK);
  if (window > 0 && r0 - window + 1 > 0) lo = (r0 - window + 1) / kBK;
}

// Accumulator layout of wgmma.m64nNk16 (f32), per warpgroup: register i of
// lane `lane` in warp `w` holds row 16 w + lane / 4 + 8 ((i / 2) % 2),
// column 8 (i / 4) + 2 (lane % 4) + i % 2.  D is the tile width (64, 128
// or 256, a multiple of wgmma's bf16 K step of 16); DR <= D the operands'
// head dim (a multiple of 8): the tensor maps' inner extent is DR, so TMA
// fills columns DR .. D - 1 with zeros, Q K^T gains exact zero terms, and
// P V's extra output columns are not stored.
template <int D, int DR>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap, Order qo, Order ko, Order vo,
                __nv_bfloat16* __restrict__ o, Strides os, int heads, int kv_heads, int sq,
                int sk, float scale_log2, int causal, int window) {
  constexpr int kBoxes = D / kBox;
  constexpr int kQBox = kBQ * kRowBytes;           // bytes of one Q box
  constexpr int kKVBox = kBK * kRowBytes;          // bytes of one K or V box
  constexpr int kQBytes = kBoxes * kQBox;
  constexpr int kKVBytes = kBoxes * kKVBox;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;   // swizzle atoms: 1 KB
  const uint32_t q_s = base;
  const uint32_t k_s = q_s + kQBytes;              // stage st at k_s + st * kKVBytes
  const uint32_t v_s = k_s + 2 * kKVBytes;
  const uint32_t bars = v_s + 2 * kKVBytes;  // q_full, k_full[2], v_full[2], k_empty[2], v_empty[2]
  const uint32_t q_full = bars;
  const uint32_t k_full = bars + 8;
  const uint32_t v_full = bars + 24;
  const uint32_t k_empty = bars + 40;
  const uint32_t v_empty = bars + 56;

  const int tid = threadIdx.x;
  // warp-uniform by construction (a shuffle from lane 0), so the branches
  // on them do not make wgmma's paths divergent
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int lane = tid & 31;
  const int n_q = (sq + kBQ - 1) / kBQ;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.x)) * kBQ;   // latest rows first
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int g = h / (heads / kv_heads);

  // the block loads the union of its warpgroups' tile ranges
  int lo0, hi0, lo1, hi1;
  tile_range(q0, sq, sk, causal, window, lo0, hi0);
  tile_range(q0 + 64, sq, sk, causal, window, lo1, hi1);
  int lo = lo0, hi = hi0;
  if (lo1 <= hi1) {
    lo = lo0 <= hi0 ? min(lo0, lo1) : lo1;
    hi = lo0 <= hi0 ? max(hi0, hi1) : hi1;
  }
  const int n_tiles = hi >= lo ? hi - lo + 1 : 0;
  const int my_lo = wg == 0 ? lo0 : lo1;
  const int my_hi = wg == 0 ? hi0 : hi1;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < 2; ++st) {
      mbar_init(k_full + 8 * st, 1);
      mbar_init(v_full + 8 * st, 1);
      mbar_init(k_empty + 8 * st, kThreads);
      mbar_init(v_empty + 8 * st, kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  auto load_k = [&](int i, bool pred) {     // K of tile lo + i into stage i % 2
    const int st = i & 1;
    mbar_expect_tx(pred, k_full + 8 * st, kKVBytes);
#pragma unroll
    for (int c = 0; c < kBoxes; ++c) {
      tma_box(pred, k_s + st * kKVBytes + c * kKVBox, &kmap, ko, k_full + 8 * st, c,
              (lo + i) * kBK, g, b);
    }
  };
  auto load_v = [&](int i, bool pred) {     // V of tile lo + i into stage i % 2
    const int st = i & 1;
    mbar_expect_tx(pred, v_full + 8 * st, kKVBytes);
#pragma unroll
    for (int c = 0; c < kBoxes; ++c) {
      tma_box(pred, v_s + st * kKVBytes + c * kKVBox, &vmap, vo, v_full + 8 * st, c,
              (lo + i) * kBK, g, b);
    }
  };
  // warp 0 issues the loads (lane 0 by predicate): Q and the first two tiles
  if (warp == 0 && n_tiles > 0) {
    mbar_expect_tx(lane == 0, q_full, kQBytes);
#pragma unroll
    for (int c = 0; c < kBoxes; ++c) {
      tma_box(lane == 0, q_s + c * kQBox, &qmap, qo, q_full, c, q0, h, b);
    }
    for (int i = 0; i < min(2, n_tiles); ++i) {
      load_k(i, lane == 0);
      load_v(i, lane == 0);
    }
  }

  const int r0 = q0 + 64 * wg;                       // this warpgroup's first row
  const int row_a = r0 + 16 * ((tid >> 5) & 3) + (lane >> 2);   // rows row_a, row_a + 8
  const int col_t = 2 * (lane & 3);
  const uint32_t q_wg = q_s + 64 * wg * kRowBytes;   // its 64 rows in every Q box

  float acc[kBoxes][32];
  float s[32];
  uint32_t pa[16];                                   // P of the previous tile, bf16 pairs
#pragma unroll
  for (int c = 0; c < kBoxes; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[c][e] = 0.0f;
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};
  float corr[2] = {1.0f, 1.0f};                      // of the last softmax

  // Release K or V of tile i (this warpgroup is done with it); warpgroup 0
  // then waits for the other and loads tile i + 2 into the freed stage.
  auto release_k = [&](int i) {
    mbar_arrive(k_empty + 8 * (i & 1));
    if (wg == 0 && i + 2 < n_tiles) {
      mbar_wait(k_empty + 8 * (i & 1), (i >> 1) & 1);
      load_k(i + 2, tid == 0);
    }
  };
  auto release_v = [&](int i) {
    mbar_arrive(v_empty + 8 * (i & 1));
    if (wg == 0 && i + 2 < n_tiles) {
      mbar_wait(v_empty + 8 * (i & 1), (i >> 1) & 1);
      load_v(i + 2, tid == 0);
    }
  };
  // a tile outside this warpgroup's range: every load lands before the
  // block exits, and the tile is released as if used
  auto pass = [&](int i) {
    mbar_wait(k_full + 8 * (i & 1), (i >> 1) & 1);
    mbar_wait(v_full + 8 * (i & 1), (i >> 1) & 1);
    release_k(i);
    release_v(i);
  };
  // S = Q K^T of tile i into s (issued, not waited for)
  auto issue_s = [&](int i) {
    mbar_wait(k_full + 8 * (i & 1), (i >> 1) & 1);
    const uint32_t k_st = k_s + (i & 1) * kKVBytes;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk & 3) * 32;          // 16 columns = 32 bytes into a box row
      mma_ss(s, desc(q_wg + (kk >> 2) * kQBox + off), desc(k_st + (kk >> 2) * kKVBox + off),
             kk > 0);
    }
    wg_commit();
  };
  // online softmax of tile i in s (base 2), masked only where the tile
  // needs it; leaves P in s and the rows' correction in corr
  auto softmax = [&](int i) {
    const int k0 = (lo + i) * kBK;
    const bool masked = k0 + kBK > sk || (causal && k0 + kBK - 1 > r0) ||
                        (window > 0 && k0 <= r0 + 63 - window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      float x = s[e] * scale_log2;
      if (masked) {
        const int col = k0 + 8 * (e >> 2) + col_t + (e & 1);
        const int row = row_a + 8 * ((e >> 1) & 1);
        const bool ok = col < sk && (!causal || col <= row) && (window <= 0 || col > row - window);
        x = ok ? x : kNegInf;
      }
      s[e] = x;
      mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], x);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = ex2(m[r] - m_new);
      m[r] = m_new;
    }
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int r = (e >> 1) & 1;
      float p = ex2(s[e] - m[r]);
      if (masked && s[e] == kNegInf) p = 0.0f;
      s[e] = p;
      sum[r] += p;
    }
    l[0] = l[0] * corr[0] + sum[0];
    l[1] = l[1] * corr[1] + sum[1];
  };
  // O = corr O + P V of tile i (P in pa): issued, not waited for
  auto issue_pv = [&](int i) {
#pragma unroll
    for (int c = 0; c < kBoxes; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[c][e] *= corr[(e >> 1) & 1];
    mbar_wait(v_full + 8 * (i & 1), (i >> 1) & 1);
    const uint32_t v_st = v_s + (i & 1) * kKVBytes;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
#pragma unroll
      for (int c = 0; c < kBoxes; ++c) {
        mma_rs(acc[c], a, desc(v_st + c * kKVBox + kk * 16 * kRowBytes));
      }
    }
    wg_commit();
  };
  auto to_pa = [&]() {
#pragma unroll
    for (int j = 0; j < 16; ++j) pa[j] = pack_bf16(s[2 * j], s[2 * j + 1]);
  };

  if (n_tiles > 0) mbar_wait(q_full, 0);
  const int first = my_lo <= my_hi ? my_lo - lo : n_tiles;   // this warpgroup's tiles
  const int last = my_lo <= my_hi ? my_hi - lo : n_tiles - 1;
  for (int i = 0; i < first; ++i) pass(i);
  if (first <= last) {
    issue_s(first);
    wg_wait_all();
    fence_regs(s);
    release_k(first);
    softmax(first);
    to_pa();
    for (int i = first + 1; i <= last; ++i) {
      issue_s(i);                                    // S_i on the tensor cores ...
      issue_pv(i - 1);                               // ... then PV of tile i - 1
      wg_wait_one();                                 // S_i done
      fence_regs(s);
      release_k(i);
      softmax(i);                                    // during PV of tile i - 1
      wg_wait_all();
#pragma unroll
      for (int c = 0; c < kBoxes; ++c) fence_regs(acc[c]);
      release_v(i - 1);
      to_pa();
    }
    issue_pv(last);
    wg_wait_all();
#pragma unroll
    for (int c = 0; c < kBoxes; ++c) fence_regs(acc[c]);
    release_v(last);
  }
  for (int i = last + 1; i < n_tiles; ++i) pass(i);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  __nv_bfloat16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= sq) continue;
    const float inv = 1.0f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = ob + row * os.s + col_t;
#pragma unroll
    for (int c = 0; c < kBoxes; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (kBox * c + 8 * j >= DR) continue;        // a padded column group
        *reinterpret_cast<uint32_t*>(orow + kBox * c + 8 * j) =
            pack_bf16(acc[c][4 * j + 2 * r] * inv, acc[c][4 * j + 2 * r + 1] * inv);
      }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

constexpr int kNoEncoder = -1000;    // cuTensorMapEncodeTiled not found

// The map of one operand (b, head, position, D) with element strides `st`
// (b, head, position): dimension 0 is D, then position, head and batch in
// order of their strides; a box of 64 columns by `rows` positions.
// Returns 0, kNoEncoder, or minus the driver's error.
int make_map(CUtensorMap* map, Order* order, const void* ptr, int d, int seq, int n_heads,
             int batch, const long long* st, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kNoEncoder;
  const long long stride[3] = {st[2], st[1], st[0]};    // position, head, batch
  const long long extent[3] = {seq, n_heads, batch};
  int idx[3] = {0, 1, 2};
  for (int a = 1; a < 3; ++a)
    for (int j = a; j > 0 && stride[idx[j]] < stride[idx[j - 1]]; --j) {
      const int t = idx[j];
      idx[j] = idx[j - 1];
      idx[j - 1] = t;
    }
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), 0, 0, 0};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {static_cast<cuuint32_t>(kBox), 1, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  int pos[3];
  for (int j = 0; j < 3; ++j) {
    dims[j + 1] = static_cast<cuuint64_t>(extent[idx[j]]);
    strides[j] = static_cast<cuuint64_t>(stride[idx[j]]) * sizeof(__nv_bfloat16);
    box[j + 1] = idx[j] == 0 ? static_cast<cuuint32_t>(rows) : 1;
    pos[idx[j]] = j + 1;
  }
  *order = Order{pos[0], pos[1], pos[2]};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -static_cast<int>(r);
}

template <int D, int DR = D>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int heads,
           int kv_heads, int sq, int sk, const long long* st, float scale, int causal,
           int window, void*, long long, int, cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap;
  Order qo, ko, vo;
  int rc = make_map(&qmap, &qo, q, DR, sq, heads, batch, st, kBQ);
  if (rc == 0) rc = make_map(&kmap, &ko, k, DR, sk, kv_heads, batch, st + 3, kBK);
  if (rc == 0) rc = make_map(&vmap, &vo, v, DR, sk, kv_heads, batch, st + 6, kBK);
  if (rc != 0) return rc;
  const size_t smem = 1024 + (kBQ + 4 * kBK) * D * sizeof(__nv_bfloat16) + 9 * 8;
  auto kernel = flash_tc_kernel<D, DR>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides os{st[9], st[10], st[11]};
  const dim3 grid(static_cast<unsigned int>((sq + kBQ - 1) / kBQ),
                  static_cast<unsigned int>(batch * heads));
  kernel<<<grid, kThreads, smem, stream>>>(qmap, kmap, vmap, qo, ko, vo,
                                           static_cast<__nv_bfloat16*>(o), os, heads, kv_heads,
                                           sq, sk, scale * kLog2e, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

using Launch = int (*)(const void*, const void*, const void*, void*, int, int, int, int, int,
                       const long long*, float, int, int, void*, long long, int, cudaStream_t);

// The launcher for operand type `dtype` (0 float32, 1 bfloat16) at head dim
// d; nullptr when there is none.  Head dim 120 (h2o-danube-3-4b) runs the
// D = 128 kernels with its last 8 columns zero-filled.
Launch launcher(int dtype, int d) {
  const int slot = d == 64 ? 0 : d == 128 ? 1 : d == 256 ? 2 : d == 120 ? 3 : -1;
  if (slot < 0 || dtype < 0 || dtype > 1) return nullptr;
  static const Launch table[2][4] = {
      {f32::launch<64>, f32::launch<128>, f32::launch<256>, f32::launch<128, 120>},
      {tc::launch<64>, tc::launch<128>, tc::launch<256>, tc::launch<128, 120>}};
  return table[dtype][slot];
}

}  // namespace

// Plain C interface, loaded with ctypes.  dtype: 0 float32 (flash_kernel),
// 1 bfloat16 (flash_tc_kernel), for q, k, v and o alike.  d in {64, 120,
// 128, 256}; heads a multiple of kv_heads.  strides: 12 element strides, (b,
// head, position) of q, k, v, o in that order; the D axis is contiguous and
// every row 16-byte aligned.  window <= 0 means no window.  workspace:
// flash_attention_workspace bytes for the same arguments (float32; unused
// for bfloat16).  Returns the CUDA error of the device
// selection, the shared-memory attribute, the memset or the launch (0 =
// launched; cudaErrorInvalidValue for a workspace too small); for bfloat16
// also -1000 when the driver has no cuTensorMapEncodeTiled and minus its
// CUresult when a tensor map is refused.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o,
                               int dtype, int batch, int heads, int kv_heads, int sq, int sk,
                               int d, const long long* strides, float scale, int causal,
                               int window, void* workspace, long long workspace_bytes,
                               int device, void* stream) {
  if (heads <= 0 || kv_heads <= 0 || heads % kv_heads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Launch launch = launcher(dtype, d);
  if (launch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0 || sq <= 0 || sk <= 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  return launch(q, k, v, o, batch, heads, kv_heads, sq, sk, strides, scale, causal, window,
                workspace, workspace_bytes, device, static_cast<cudaStream_t>(stream));
}

// The workspace bytes that flash_attention needs for float32 operands with
// these arguments, into *bytes: the split units' partial results and
// tickets (0 when no query tile is split; bfloat16 needs none).  Returns a
// CUDA error (0 = success).
extern "C" int flash_attention_workspace(int batch, int heads, int sq, int sk, int d, int causal,
                                         int window, int device, long long* bytes) {
  *bytes = 0;
  if (batch <= 0 || heads <= 0 || sq <= 0 || sk <= 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  switch (d) {
    case 64: return f32::workspace<64>(batch, heads, sq, sk, causal, window, device, bytes);
    case 128: return f32::workspace<128>(batch, heads, sq, sk, causal, window, device, bytes);
    case 256: return f32::workspace<256>(batch, heads, sq, sk, causal, window, device, bytes);
    case 120:
      return f32::workspace<128, 120>(batch, heads, sq, sk, causal, window, device, bytes);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
