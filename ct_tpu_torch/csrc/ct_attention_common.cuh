// Device functions shared by the one-thread-per-anchor Context-Transformer
// attention kernels (ct_attention_cm.cu and the blockwise backward's stats
// kernel in ct_attention_cm_bwd.cu), float32, for Hopper.
//
// Those kernels run one thread per anchor with its row of C values in
// registers, C a template parameter CP padded to 16 or 64 (15 source
// classes and 60 both fit; padded classes are zero and never stored), and
// sum every product on the FP32 pipes: a shared-memory float feeds one FMA,
// so they are held by shared-memory issue. The backward's dq and dk/dv
// kernels do not use these functions: they are tiled on the tensor cores
// (3xTF32 mma.sync) with their own helpers, and the note of
// ct_attention_cm_bwd.cu describes them. Two layouts of the per-anchor
// tensors q, base, g, out, dq:
//
//   class-major [B,C,P]: a thread reads its column; consecutive threads
//                        read consecutive anchors, coalesced;
//   row-major   [B,P,C]: the rows of a block's anchors are one contiguous
//                        span; it is read (and written) coalesced through
//                        shared memory in halves of 64 rows at a stride of
//                        CP+1 floats (no bank conflicts), and each thread
//                        takes its row from there.
//
// k and v are [B,K,C] in both.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace ct {

constexpr int kThreads = 128;    // anchors (or keys) per block, one a thread
constexpr int kKeyTile = 64;     // keys staged in shared memory at a time
constexpr int kHalf = 64;        // rows staged at a time by load/store_rows

// sum_c row[c] * x[c] over a shared-memory row, in four partial sums: the
// forwards and the stats kernel sum a score in this order, so each sees the
// same s (the tensor-core backward sums it in its own order).
template <int CP>
__device__ __forceinline__ float dot_row(const float* row,
                                         const float (&x)[CP]) {
  const float4* r = reinterpret_cast<const float4*>(row);
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
  for (int c4 = 0; c4 < CP / 4; ++c4) {
    const float4 rr = r[c4];
    s0 = fmaf(rr.x, x[4 * c4 + 0], s0);
    s1 = fmaf(rr.y, x[4 * c4 + 1], s1);
    s2 = fmaf(rr.z, x[4 * c4 + 2], s2);
    s3 = fmaf(rr.w, x[4 * c4 + 3], s3);
  }
  return (s0 + s1) + (s2 + s3);
}

// acc[c] += w * row[c] over a shared-memory row.
template <int CP>
__device__ __forceinline__ void axpy_row(float w, const float* row,
                                         float (&acc)[CP]) {
  const float4* r = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int c4 = 0; c4 < CP / 4; ++c4) {
    const float4 rr = r[c4];
    acc[4 * c4 + 0] = fmaf(w, rr.x, acc[4 * c4 + 0]);
    acc[4 * c4 + 1] = fmaf(w, rr.y, acc[4 * c4 + 1]);
    acc[4 * c4 + 2] = fmaf(w, rr.z, acc[4 * c4 + 2]);
    acc[4 * c4 + 3] = fmaf(w, rr.w, acc[4 * c4 + 3]);
  }
}

// x rounded to bfloat16 (nearest, ties to even) and back to float32.
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Stage keys j0 .. j0+nk-1 of one image's k and v into ks, vs [kKeyTile,CP],
// zero past nk and past C. The caller synchronises around it.
template <int CP>
__device__ __forceinline__ void stage_keys(float* ks, float* vs,
                                           const float* __restrict__ kb,
                                           const float* __restrict__ vb,
                                           int j0, int nk, int C) {
  for (int e = threadIdx.x; e < kKeyTile * CP; e += kThreads) {
    const int j = e / CP;
    const int c = e % CP;
    const bool ok = j < nk && c < C;
    const size_t gi = static_cast<size_t>(j0 + j) * C + c;
    ks[e] = ok ? kb[gi] : 0.f;
    vs[e] = ok ? vb[gi] : 0.f;
  }
}

// Each thread's row of C values of x for anchor p0 + threadIdx.x of image b,
// zero past P and past C. `stage` holds kHalf*(CP+1) floats (row-major
// only); every thread of the block must call this.
template <int CP, bool kRowMajor>
__device__ __forceinline__ void load_rows(const float* __restrict__ x,
                                          int b, int p0, int C, int P,
                                          float* stage, float (&r)[CP]) {
  const int p = p0 + threadIdx.x;
  if (!kRowMajor) {
    const size_t img = static_cast<size_t>(b) * C * P;
#pragma unroll
    for (int c = 0; c < CP; ++c) {
      r[c] = (p < P && c < C) ? x[img + static_cast<size_t>(c) * P + p]
                              : 0.f;
    }
    return;
  }
#pragma unroll
  for (int c = 0; c < CP; ++c) r[c] = 0.f;
  for (int h = 0; h < kThreads; h += kHalf) {
    const int rows = max(0, min(kHalf, P - (p0 + h)));
    const size_t first = (static_cast<size_t>(b) * P + p0 + h) * C;
    __syncthreads();  // the stage is no longer read
    for (int e = threadIdx.x; e < rows * C; e += kThreads) {
      stage[(e / C) * (CP + 1) + e % C] = x[first + e];
    }
    __syncthreads();
    const int a = threadIdx.x - h;
    if (a >= 0 && a < rows) {
#pragma unroll
      for (int c = 0; c < CP; ++c) {
        r[c] = c < C ? stage[a * (CP + 1) + c] : 0.f;
      }
    }
  }
}

// Write each thread's row r of C values for anchor p0 + threadIdx.x of
// image b to out; with `base` and `wz`, out = base + wz * r. Rows past P
// are not written. `stage` as for load_rows; every thread must call this.
template <int CP, bool kRowMajor>
__device__ __forceinline__ void store_rows(float* __restrict__ out,
                                           const float* __restrict__ base,
                                           const float* __restrict__ wz,
                                           int b, int p0, int C, int P,
                                           float* stage,
                                           const float (&r)[CP]) {
  const int p = p0 + threadIdx.x;
  if (!kRowMajor) {
    if (p >= P) return;
    const size_t img = static_cast<size_t>(b) * C * P;
#pragma unroll
    for (int c = 0; c < CP; ++c) {
      if (c < C) {
        const size_t o = img + static_cast<size_t>(c) * P + p;
        out[o] = base ? base[o] + wz[c] * r[c] : r[c];
      }
    }
    return;
  }
  for (int h = 0; h < kThreads; h += kHalf) {
    const int rows = max(0, min(kHalf, P - (p0 + h)));
    const size_t first = (static_cast<size_t>(b) * P + p0 + h) * C;
    __syncthreads();  // the stage is no longer read
    const int a = threadIdx.x - h;
    if (a >= 0 && a < rows) {
#pragma unroll
      for (int c = 0; c < CP; ++c) {
        if (c < C) stage[a * (CP + 1) + c] = r[c];
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < rows * C; e += kThreads) {
      const int c = e % C;
      const float d = stage[(e / C) * (CP + 1) + c];
      out[first + e] = base ? base[first + e] + wz[c] * d : d;
    }
  }
}

// The softmax-weighted sum of one image's values for query qr: on return
// acc[c] = sum_j e^(s_j - m) v[j,c] and l = sum_j e^(s_j - m), with
// s_j = k[j,:].qr and m = max_j s_j, over all K keys. ks and vs are the
// kernel's [kKeyTile,CP] tiles in shared memory.
//
// kExpBf16 = false: one pass, an online softmax (a running max and
// denominator; the accumulators are rescaled only when the max grows).
// kExpBf16 = true: two passes, the first for m, the second with each
// weight e = bf16(exp(bf16(s - m))), the exponential of an argument and
// with a result rounded to bfloat16, as a bfloat16 exp of (s - m) gives it.
template <int CP, bool kExpBf16>
__device__ __forceinline__ void softmax_sum(const float (&qr)[CP],
                                            const float* __restrict__ kb,
                                            const float* __restrict__ vb,
                                            int C, int K, float* ks,
                                            float* vs, float (&acc)[CP],
                                            float& m, float& l) {
#pragma unroll
  for (int c = 0; c < CP; ++c) acc[c] = 0.f;
  m = -INFINITY;
  l = 0.f;
  if (kExpBf16) {
    for (int j0 = 0; j0 < K; j0 += kKeyTile) {
      const int nk = min(kKeyTile, K - j0);
      __syncthreads();
      stage_keys<CP>(ks, vs, kb, vb, j0, nk, C);
      __syncthreads();
      for (int j = 0; j < nk; ++j) m = fmaxf(m, dot_row<CP>(ks + j * CP, qr));
    }
  }
  for (int j0 = 0; j0 < K; j0 += kKeyTile) {
    const int nk = min(kKeyTile, K - j0);
    __syncthreads();  // the previous tile is no longer read
    stage_keys<CP>(ks, vs, kb, vb, j0, nk, C);
    __syncthreads();
    for (int j = 0; j < nk; ++j) {
      const float s = dot_row<CP>(ks + j * CP, qr);
      float w;
      if (kExpBf16) {
        w = bf16_round(expf(bf16_round(s - m)));
      } else {
        if (s > m) {
          const float corr = expf(m - s);  // 0 on the first key
          l *= corr;
#pragma unroll
          for (int c = 0; c < CP; ++c) acc[c] *= corr;
          m = s;
        }
        w = expf(s - m);
      }
      l += w;
      axpy_row<CP>(w, vs + j * CP, acc);
    }
  }
}

}  // namespace ct
