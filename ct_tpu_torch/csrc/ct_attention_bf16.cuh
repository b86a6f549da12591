// The bfloat16 walk of the Context-Transformer serving head
// (ct_attention_serving.cu), for Hopper; the other bf16 forwards run on
// warpgroup wgmma tiles (ct_attention_cm.cu).
//
// What it computes is the attention of the JAX package's forward kernels
// on bfloat16 operands (`_serving_kernel` of ct_tpu/ops/ct_attention.py,
// as `_kernel_cm` computes it), with their rounding points:
//   s[j] = sum_c k[j,c] q[c]            bf16 operands, f32 sums
//   m    = max_j s[j]                   f32
//   e[j] = bf16(exp(s[j] - m))          f32 exponential, rounded to nearest
//                                       even (`e.astype(v.dtype)`)
//   num  = sum_j e[j] v[j,:]            f32 sums of exact bf16 products
//   den  = sum_j e[j] * 1               the same product, from a ones
//                                       column appended to v
// and the caller forms num / den.
//
// Every product is one warp-wide mma.sync m16n8k16 on bf16 operands with
// an f32 accumulator: a bf16 x bf16 product is exact in f32, so one
// product per tile does what 3xTF32 needs three for (ct_attention_mma.cuh),
// and the walk differs from the plain version only in the order of its f32
// sums. The m16n8k16 layouts need no permutation: the accumulator of the
// score product for keys n0..n0+7 and n0+8..n0+15 (C layout: row g, keys
// 2t, 2t+1 of each) is, rounded and packed two by two, the A fragment of
// the P V product over those 16 keys (rows g and g+8, keys 2t, 2t+1 and
// 2t+8, 2t+9).
//
// Rounding e against the final max (as the JAX kernel, which holds all K
// scores of a row, rounds it) needs the max before the first weight: the
// walk goes over the keys twice, the first time for the max alone (scores
// only: k tiles, no exponentials), the second for the weights. That
// recomputes the scores, 2*B*P*K*C tensor flops more than the function's
// 4*B*P*K*C, which the bounds leave out; the bound of this walk is its
// exponentials, B*P*K on the special-function units (PERF.md §6).
//
// k and v arrive padded to [B,K,CP] bf16 (pad_kv, one launch before the
// walk's): rows of CP bf16 are 16-byte aligned for cp.async (rows of C=15
// bf16 are 30 bytes), the padded classes are zero, and v's column C holds
// the ones of the denominator (so C < CP: 15 in CP=16, up to 63 in CP=64).
// A block owns 64 anchors, 16 a warp; the keys are staged in tiles of 32,
// [32][CP + 8] bf16 (the 8 of padding put the eight 16-byte rows that
// ldmatrix reads at once on distinct banks), double-buffered by cp.async.

#pragma once

#include "ct_attention_mma.cuh"

namespace ct {
namespace bf {

using bf16 = __nv_bfloat16;

// Row stride of a staged [kItems][CP] tile, in bf16.
template <int CP>
constexpr int kStride = CP + 8;

// A staged tile, in bf16.
template <int CP>
constexpr int kTileElems = kItems * kStride<CP>;

// Shared memory of the walk in bytes: the k and v tiles, double-buffered;
// 6 KB at CP=16, 18 KB at CP=64.
template <int CP>
constexpr int kWalkBytes = 4 * kTileElems<CP> * static_cast<int>(sizeof(bf16));

// Blocks an SM: the bf16 walk keeps a quarter of the f32 walk's operand
// registers (no hi/lo split): q 2*CP/8, the accumulators 4*CP/8 + 16. At
// CP=64 at least three blocks (up to 168 registers a thread) keep a
// tile's fresh P V accumulators beside the running ones; at CP=16, six
// (up to 85). ptxas on an H100 gave the serving head 132 registers at
// CP=64 and 72 at CP=16, none spilled.
template <int CP>
constexpr int kMinBlocks = CP <= 16 ? 6 : 3;

// The class count padded for the walk: C classes and the ones column.
__host__ __device__ constexpr int padded_classes(int C) {
  return C < 16 ? 16 : 64;
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float unpack_lo(uint32_t x) {
  return __uint_as_float(x << 16);
}

__device__ __forceinline__ float unpack_hi(uint32_t x) {
  return __uint_as_float(x & 0xffff0000u);
}

// d += a b on the tensor cores, one m16n8k16 bf16 product, f32 sums.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l%8 of matrix l/8. Without kTrans register i of lane (g, t) holds
// row g, columns 2t, 2t+1 of matrix i; with it, column g, rows 2t, 2t+1.
template <bool kTrans>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if (kTrans) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
  } else {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
  }
}

// cp.async of 16 bytes into shared memory, zero-filled where !ok.
__device__ __forceinline__ void copy16(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// k and v [B,K,C] → kp and vp [B,K,CP]: zero past C, and vp's column C one.
__global__ void pad_kv(const bf16* __restrict__ k, const bf16* __restrict__ v,
                       bf16* __restrict__ kp, bf16* __restrict__ vp,
                       long long rows, int C, int CP) {
  const long long n = rows * CP;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < n; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long r = e / CP;
    const int c = static_cast<int>(e % CP);
    const bool in = c < C;
    kp[e] = in ? k[r * C + c] : __float2bfloat16_rn(0.f);
    vp[e] = in ? v[r * C + c] : __float2bfloat16_rn(c == C ? 1.f : 0.f);
  }
}

// The q operand of a warp's 16 rows (anchors p0 + g, p0 + g + 8), classes
// as k: x[kk] is the A fragment of classes 16kk .. 16kk+15 (x0: row g,
// classes 16kk + 2t, +1; x1: row g+8; x2, x3: classes + 8), from a
// class-major [B,C,P] bf16 tensor; zero past P and C.
// The halves of x[kk][r] sit where the accumulator of a [16][CP] product
// holds chunk 2kk + r/2, elements 2(r%2) and 2(r%2) + 1.
template <int CP>
__device__ __forceinline__ void load_rows(const bf16* __restrict__ src,
                                          int b, int p0, int C, int P, int g,
                                          int t, uint32_t (&x)[CP / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < CP / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = p0 + g + (r % 2) * 8;
      float two[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = 16 * kk + 2 * t + (r / 2) * 8 + h;
        const bool ok = p < P && c < C;
        const size_t o = (static_cast<size_t>(b) * C + c) * P + p;
        two[h] = ok ? __bfloat162float(src[o]) : 0.f;
      }
      x[kk][r] = pack(two[0], two[1]);  // exact: the values are bf16
    }
  }
}

// Stage keys j0 .. j0+31 of image b's padded [K][CP] rows into a
// [32][kStride] tile, 16 bytes a copy, zero past K.
template <int CP>
__device__ __forceinline__ void stage_tile(bf16* tile,
                                           const bf16* __restrict__ src,
                                           int j0, int K) {
  constexpr int kPerRow = CP / 8;  // 16-byte chunks a row
  for (int e = threadIdx.x; e < kItems * kPerRow; e += kThreads) {
    const int i = e / kPerRow;
    const int c = (e % kPerRow) * 8;
    const bool ok = j0 + i < K;
    copy16(tile + i * kStride<CP> + c,
           ok ? src + static_cast<size_t>(j0 + i) * CP + c : src, ok);
  }
}

// The softmax-weighted sum of one image's values for this warp's 16
// anchors. On return element r of o[nn] (row g + 8(r/2), class 8nn + 2t +
// r%2) holds sum_j e[j] vp[j, c], column C the denominator sum_j e[j], and
// m[h] row g + 8h's max. kp and vp are the padded [B,K,CP] tensors; qa the
// warp's q operand (load_rows). Every thread of the block calls it; smem
// holds kWalkBytes<CP>; the walk begins with a barrier, so the caller may
// read smem up to the call, and it synchronises before reusing it.
//
// Per tile and group of 32 keys each warp forms S [16 x 32] (four 8-key
// chunks) on the tensor cores, k read by ldmatrix; the first walk keeps
// the row max of the live keys, the second takes e, packs it as the A
// operand and adds P V [16 x CP], v read by ldmatrix.trans, into fresh
// accumulators that are added to o with rounded f32 adds once a tile (the
// tensor cores truncate their accumulator at every step; ct_attention_mma.cuh).
// Keys past K are masked after the exponential (weight 0) and out of the max.
template <int CP>
__device__ __forceinline__ void attend(const uint32_t (&qa)[CP / 16][4],
                                       const bf16* __restrict__ kp,
                                       const bf16* __restrict__ vp, int b,
                                       int K, bf16* smem,
                                       float (&o)[CP / 8][4], float (&m)[2]) {
  static_assert(CP % 16 == 0, "tile shapes");
  constexpr int NK = CP / 16;  // k steps of the score product
  constexpr int NN = CP / 8;   // class chunks of P V
  constexpr int S = kStride<CP>;
  constexpr int kTile = kTileElems<CP>;
  const int lane = threadIdx.x % 32;
  const int tq = lane % 4;
  // ldmatrix: this lane's row (of a 16-row pair of matrices) and column
  const int lrow = (lane & 7) + ((lane >> 4) << 3);
  const int lcol = ((lane >> 3) & 1) << 3;
  const int lrow_t = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int lcol_t = (lane >> 4) << 3;

#pragma unroll
  for (int nn = 0; nn < NN; ++nn) {
#pragma unroll
    for (int r = 0; r < 4; ++r) o[nn][r] = 0.f;
  }
  m[0] = m[1] = -INFINITY;

  const bf16* kb = kp + static_cast<size_t>(b) * K * CP;
  const bf16* vb = vp + static_cast<size_t>(b) * K * CP;
  const int tiles = (K + kItems - 1) / kItems;
#pragma unroll 1
  for (int walk = 0; walk < 2; ++walk) {
    const bool values = walk == 1;
    // the k and v tiles of buffer buf: smem + (2 buf + 0 or 1) kTile
    auto stage = [&](int tile, int buf) {
      stage_tile<CP>(smem + 2 * buf * kTile, kb, tile * kItems, K);
      if (values) stage_tile<CP>(smem + (2 * buf + 1) * kTile, vb,
                                 tile * kItems, K);
    };
    __syncthreads();  // the last walk's tiles are no longer read
    stage(0, 0);
    copy_commit();
#pragma unroll 1
    for (int tile = 0; tile < tiles; ++tile) {
      const int buf = tile % 2;
      copy_wait_all();
      // the tile has landed, and every warp is done with the last one,
      // whose buffer the next tile's copies fill while this one is read
      __syncthreads();
      if (tile + 1 < tiles) stage(tile + 1, buf ^ 1);
      copy_commit();
      const bf16* kt = smem + 2 * buf * kTile;
      const bf16* vt = smem + (2 * buf + 1) * kTile;
      const int j0 = tile * kItems;

      // S = Q K^T, keys 8ch .. 8ch+7 of the tile in s[ch]
      float s[4][4];
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) {
#pragma unroll
        for (int r = 0; r < 4; ++r) s[ch][r] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {  // keys 16 half .. +15
          uint32_t r4[4];
          ldmatrix_x4<false>(r4, kt + (16 * half + lrow) * S + 16 * kk + lcol);
          const uint32_t b0[2] = {r4[0], r4[1]};
          const uint32_t b1[2] = {r4[2], r4[3]};
          mma(s[2 * half], qa[kk], b0);
          mma(s[2 * half + 1], qa[kk], b1);
        }
      }
      // element r of s[ch]: row g + 8(r/2), key j0 + 8ch + 2t + r%2
      if (!values) {
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            if (j0 + 8 * ch + 2 * tq + r % 2 < K) {
              m[r / 2] = fmaxf(m[r / 2], s[ch][r]);
            }
          }
        }
        continue;
      }
      // the weights, rounded to bf16, as the A operands of P V: keys
      // 16 half .. +15 in pa[half]
      uint32_t pa[2][4];
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) {
        float w[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float x = s[ch][r] - m[r / 2];
          w[r] = j0 + 8 * ch + 2 * tq + r % 2 >= K ? 0.f : __expf(x);
        }
        pa[ch / 2][(ch % 2) * 2 + 0] = pack(w[0], w[1]);  // row g
        pa[ch / 2][(ch % 2) * 2 + 1] = pack(w[2], w[3]);  // row g + 8
      }
      // O += P V, a tile's products in fresh accumulators
      float t[NN][4];
#pragma unroll
      for (int nn = 0; nn < NN; ++nn) {
#pragma unroll
        for (int r = 0; r < 4; ++r) t[nn][r] = 0.f;
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int nn = 0; nn < NN; nn += 2) {  // class chunks nn, nn + 1
          uint32_t r4[4];
          ldmatrix_x4<true>(r4, vt + (16 * half + lrow_t) * S + 8 * nn +
                                    lcol_t);
          const uint32_t b0[2] = {r4[0], r4[1]};
          const uint32_t b1[2] = {r4[2], r4[3]};
          mma(t[nn], pa[half], b0);
          mma(t[nn + 1], pa[half], b1);
        }
      }
#pragma unroll
      for (int nn = 0; nn < NN; ++nn) {
#pragma unroll
        for (int r = 0; r < 4; ++r) o[nn][r] += t[nn][r];
      }
    }
    if (!values) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
        m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2));
      }
    }
  }
}

}  // namespace bf
}  // namespace ct
