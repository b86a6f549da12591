// The tensor-core building blocks of the Context-Transformer attention
// kernels (ct_attention_cm.cu: the forwards; ct_attention_cm_bwd.cu: the
// blockwise backward's stats pass and the dq and dk/dv kernels;
// ct_attention_serving.cu: the serving head), float32 on Hopper, and the
// forward's walk over the keys that the forwards, the stats pass and the
// serving head share.
//
// Every product is a warp-wide mma.sync m16n8k8 on the tensor cores in
// 3xTF32: each operand a is split as big + small and a*b = small*big +
// big*small + big*big, accumulated in f32. The tensor cores read a TF32
// operand from the top 19 bits of its register, so big = a + half a TF32
// step (read: a rounded to nearest, ties away, as cvt.rna.tf32 rounds) and
// small = a - tf32(big) (read: truncated), three integer and float
// instructions where two cvt.rna take eight. That keeps about 21 of
// float32's 24 mantissa bits, where a single TF32 product keeps 11: scores
// reach |s| ~ 30 at C=60, so one TF32 pass would move the attention by ~1%,
// far outside the kernels' bands (tests/test_torch_tf32_split.py holds this
// argument on the CPU).
//
// A warp owns 16 rows (anchors, or keys in dk/dv) and keeps them as A
// fragments (RowsA, classes as the k dimension). The other side is staged
// in tiles of kItems = 32 items, [CP][32] floats, items XOR-swizzled by
// class (swz) so that the copies and both fragment loads hit 32 distinct
// banks, by cp.async, double-buffered; in dq and dk/dv, once a tile lands
// the block splits it into hi and lo tiles (split_tile), so that each
// float is split once and not by each of the four warps; the forward's
// walk reads it unsplit and splits in registers (see attend). The
// accumulator of a score product
// (C layout: row g, columns 2t and 2t+1 of a lane's quad) becomes the A
// operand of the next product (rows g, g+8, columns t and t+4) without a
// shuffle or a pass through shared memory: the B fragments of the score
// products read the items in the order pi(n) = 4(n&1) + n/2 (load_kn), so
// that a lane's accumulator columns 2t, 2t+1 hold items t and t+4, the very
// k indices its A fragment needs; the next product reads its B operand
// with the items as k (load_nk). The tensor cores truncate their f32
// accumulator at every step: a long sum (over all keys or anchors) takes
// each step's product from a zero accumulator and adds it with a rounded
// f32 add (mma3_add), else the error grows with the step count.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ct {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16 * kWarps;  // rows a block owns, 16 a warp
constexpr int kItems = 32;          // items (keys or anchors) a tile

// x rounded to bfloat16 (nearest, ties to even) and back to float32.
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// bits + 0x1000, kept where it is written (volatile: a split inside a loop
// is not hoisted out of it).
__device__ __forceinline__ uint32_t add_half_ulp_here(uint32_t bits) {
  uint32_t r;
  asm volatile("add.u32 %0, %1, 4096;" : "=r"(r) : "r"(bits));
  return r;
}

// x as hi + lo for the tensor cores, which read a TF32 operand from the top
// 19 bits of its register and drop the low 13 (the compiler's own
// cvt.rna.tf32.f32 relies on this too). hi = x + half a TF32 step, so that
// it reads as x rounded to nearest TF32, ties away, as cvt.rna rounds; lo =
// x - tf32(hi), exact in f32, reads truncated to TF32. |x - tf32(hi) -
// tf32(lo)| < 2^-21 |x|, in 3 instructions where two cvt.rna take 8.
template <int N, bool kHere = false>
__device__ __forceinline__ void split(const float (&x)[N], uint32_t (&hi)[N],
                                      uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const uint32_t bits = __float_as_uint(x[i]);
    hi[i] = kHere ? add_half_ulp_here(bits) : bits + 0x1000u;
    lo[i] = __float_as_uint(x[i] - __uint_as_float(hi[i] & 0xffffe000u));
  }
}

// d += a b on the tensor cores, one m16n8k8 TF32 product.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a b on the tensor cores, from a zero accumulator.
__device__ __forceinline__ void mma_zero(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f), "f"(0.f), "f"(0.f), "f"(0.f));
}

// d += a b in 3xTF32, a and b split (see split): the small terms first,
// then big x big.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4],
                                     const uint32_t (&bhi)[2],
                                     const uint32_t (&blo)[2]) {
  mma(d, alo, bhi);
  mma(d, ahi, blo);
  mma(d, ahi, bhi);
}

// sum += a b in 3xTF32, the product formed in a fresh accumulator and added
// with a rounded f32 add. The tensor cores truncate their f32 accumulator
// at every step; over the thousands of steps of a sum over all anchors or
// keys that error is biased and grows with the count (2.3e-4 of dk's
// largest entry at P=32,756 on an H100 when dk was the accumulator
// itself), where rounded adds keep it at the f32 sum's own.
__device__ __forceinline__ void mma3_add(float (&sum)[4],
                                         const uint32_t (&ahi)[4],
                                         const uint32_t (&alo)[4],
                                         const uint32_t (&bhi)[2],
                                         const uint32_t (&blo)[2]) {
  float t[4];
  mma_zero(t, alo, bhi);
  mma(t, ahi, blo);
  mma(t, ahi, bhi);
#pragma unroll
  for (int i = 0; i < 4; ++i) sum[i] += t[i];
}

// The A operand a warp keeps for its 16 rows, k = classes: x[kk] is the
// fragment of classes 8kk .. 8kk+7 (a0: row g, class t; a1: row g+8,
// class t; a2, a3: class t+4). With kHoist it is split once; otherwise it
// is split at each use (the same bits either way).
template <int NK, bool kHoist>
struct RowsA {
  float x[NK][4];
  uint32_t hi[kHoist ? NK : 1][4];
  uint32_t lo[kHoist ? NK : 1][4];

  // x from rows p0 + g (+8) of image b of a class-major [B,C,P] or
  // row-major [B,P,C] tensor, times scale[c] if given; zero past P and C.
  template <bool kRowMajor>
  __device__ __forceinline__ void load(const float* __restrict__ src,
                                       const float* __restrict__ scale,
                                       int b, int p0, int C, int P, int g,
                                       int t) {
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int p = p0 + g + (r % 2) * 8;
        const int c = 8 * kk + t + (r / 2) * 4;
        const bool ok = p < P && c < C;
        const size_t o = kRowMajor
                             ? (static_cast<size_t>(b) * P + p) * C + c
                             : (static_cast<size_t>(b) * C + c) * P + p;
        x[kk][r] = ok ? (scale ? src[o] * scale[c] : src[o]) : 0.f;
      }
    }
    prepare();
  }
  // split x once, with kHoist; the caller that fills x itself calls it
  __device__ __forceinline__ void prepare() {
    if (kHoist) {
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) split<4>(x[kk], hi[kHoist ? kk : 0],
                                               lo[kHoist ? kk : 0]);
    }
  }
  __device__ __forceinline__ void at(int kk, uint32_t (&h)[4],
                                     uint32_t (&l)[4]) const {
    if (kHoist) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        h[i] = hi[kHoist ? kk : 0][i];
        l[i] = lo[kHoist ? kk : 0][i];
      }
    } else {
      split<4, true>(x[kk], h, l);
    }
  }
};

// Word of (class c, item i) in a [CP][kItems] tile: the items of a class
// XOR-swizzled by bits 0-2 of the class, so that the fragment loads below
// and the 16-byte copies hit 32 distinct banks.
__device__ __forceinline__ int swz(int c, int i) {
  return c * kItems + (i ^ (((c & 3) << 3) | (c & 4)));
}

// B operand with k = classes 8kk + t (+4) and n = items n0 + pi(g),
// pi(g) = 4(g&1) + g/2: accumulator columns 2t, 2t+1 then hold items t and
// t+4, the k indices of the A fragment of the next product.
__device__ __forceinline__ void load_kn(const uint32_t* hi, const uint32_t* lo,
                                        int kk, int n0, int g, int t,
                                        uint32_t (&bhi)[2],
                                        uint32_t (&blo)[2]) {
  const int i = n0 + ((g & 1) << 2) + (g >> 1);
  const int w0 = swz(8 * kk + t, i), w1 = swz(8 * kk + t + 4, i);
  bhi[0] = hi[w0];
  bhi[1] = hi[w1];
  blo[0] = lo[w0];
  blo[1] = lo[w1];
}

// B operand with k = items i0 + t (+4) and n = classes 8nn + g.
__device__ __forceinline__ void load_nk(const uint32_t* hi, const uint32_t* lo,
                                        int i0, int nn, int g, int t,
                                        uint32_t (&bhi)[2],
                                        uint32_t (&blo)[2]) {
  const int w0 = swz(8 * nn + g, i0 + t), w1 = swz(8 * nn + g, i0 + t + 4);
  bhi[0] = hi[w0];
  bhi[1] = hi[w1];
  blo[0] = lo[w0];
  blo[1] = lo[w1];
}

// load_kn and load_nk from a staged tile that is not split: the warp
// splits its two floats itself (the forward's walk; see attend).
__device__ __forceinline__ void load_kn_raw(const float* raw, int kk, int n0,
                                            int g, int t, uint32_t (&bhi)[2],
                                            uint32_t (&blo)[2]) {
  const int i = n0 + ((g & 1) << 2) + (g >> 1);
  const float x[2] = {raw[swz(8 * kk + t, i)], raw[swz(8 * kk + t + 4, i)]};
  split<2>(x, bhi, blo);
}

__device__ __forceinline__ void load_nk_raw(const float* raw, int i0, int nn,
                                            int g, int t, uint32_t (&bhi)[2],
                                            uint32_t (&blo)[2]) {
  const float x[2] = {raw[swz(8 * nn + g, i0 + t)],
                      raw[swz(8 * nn + g, i0 + t + 4)]};
  split<2>(x, bhi, blo);
}

// Split a staged [CP][kItems] tile into hi and lo tiles (see split), a
// block's threads four floats each at a time: every warp then reads its B
// operands split, where it would otherwise split the same floats itself.
template <int CP>
__device__ __forceinline__ void split_tile(const float* raw, uint32_t* hi,
                                           uint32_t* lo) {
  for (int e = threadIdx.x * 4; e < CP * kItems; e += kThreads * 4) {
    const float4 x4 = *reinterpret_cast<const float4*>(raw + e);
    const float x[4] = {x4.x, x4.y, x4.z, x4.w};
    uint32_t h[4], l[4];
    split<4>(x, h, l);
    *reinterpret_cast<uint4*>(hi + e) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + e) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// Dynamic shared memory of a dq or dk/dv block: two arrays staged
// double-buffered [2][2][CP * kItems] floats, then their hi and lo tiles
// [2][2][CP * kItems].
template <int CP>
constexpr size_t kTileBytes = 8 * sizeof(float) * CP * kItems;

// Shared memory of a block of the forward's walk, in floats: the k and v
// tiles double-buffered, [2][2][CP * kItems], unsplit. The epilogues reuse
// it once the walk is done. 8 KB at CP=16 and 32 KB at CP=64, under the
// 48 KB a kernel may declare statically.
template <int CP>
constexpr int kWalkFloats = 4 * CP * kItems;

// cp.async of 4 or 16 bytes into shared memory, zero-filled where !ok (src
// must then still be a valid address; it is not read).
__device__ __forceinline__ void copy4(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one group of copies is in flight.
__device__ __forceinline__ void copy_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Wait until every group of copies has landed.
__device__ __forceinline__ void copy_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Stage items [0, n) of a tile whose item i is the row src[i*C .. i*C+C):
// k, v and row-major q, g. 4-byte copies (rows of C=15 are 60 bytes); a
// warp's 32 lanes take 8 items x 4 classes (8 sectors a request, no bank
// conflicts).
template <int CP>
__device__ __forceinline__ void stage_rows(float* tile,
                                           const float* __restrict__ src,
                                           int n, int C) {
  const int lane = threadIdx.x % 32;
  const int r = lane % 8, u = lane / 8;
  for (int blk = threadIdx.x / 32; blk < CP; blk += kWarps) {
    const int i = (blk % 4) * 8 + r;
    const int c = (blk / 4) * 4 + u;
    const bool ok = i < n && c < C;
    copy4(tile + swz(c, i), ok ? src + static_cast<size_t>(i) * C + c : src,
          ok);
  }
}

// Stage items [0, n) of a tile whose class c is the row src[c*P ..]:
// class-major q, g. 16-byte copies of 4 items where `vec` (P a multiple of
// 4 and src 16-byte aligned, so n is a multiple of 4 too), else 4-byte ones.
template <int CP>
__device__ __forceinline__ void stage_cols(float* tile,
                                           const float* __restrict__ src,
                                           int n, int C, int P, bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < CP * (kItems / 4); e += kThreads) {
      const int c = e / (kItems / 4);
      const int i = (e % (kItems / 4)) * 4;
      const bool ok = i < n && c < C;
      copy16(tile + swz(c, i),
             ok ? src + static_cast<size_t>(c) * P + i : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < CP * kItems; e += kThreads) {
      const int c = e / kItems;
      const int i = e % kItems;
      const bool ok = i < n && c < C;
      copy4(tile + swz(c, i), ok ? src + static_cast<size_t>(c) * P + i : src,
            ok);
    }
  }
}

// Items processed together, 8 a chunk: more chunks share each split of the
// A operand, at 8 accumulator registers a chunk.
template <int CP>
constexpr int kChunks = CP <= 16 ? 2 : 4;

// --- the forward's walk over the keys ------------------------------------

// The softmax-weighted sum of one image's values for this warp's 16
// anchors: on return, element r of o[nn] (row g + 8(r/2), class 8nn + 2t +
// r%2, the accumulator layout) holds sum_j e^(s_j - m) v[j, c], and m[h],
// l[h] hold row g + 8h's max m = max_j s_j and denominator sum_j e^(s_j -
// m), l summed over the lane quad. s_j = k[j,:].q[:,p] over all K keys of
// image b, k and v [B,K,C]; the caller prepares q, the warp's A operand
// (RowsA, split once): the forwards and the stats pass load it from q,
// the serving head forms it from conf by its theta product. Every thread
// of the block calls it; `smem` holds kWalkFloats<CP>, and the caller
// synchronises before reusing it. The walk begins with a barrier, so the
// caller may read smem up to the call.
//
// The scores are the dq kernel's (bwd_dq_kernel): the same fragments,
// splits, class steps and 3xTF32 order for each accumulator, so the flash
// backward recomputes the very s whose max the training forward saved.
// kExpBf16 = false: one walk, an online softmax; per group of chunks the
// row's max is taken over the quad with two shuffles, and the row's
// accumulators are rescaled only when it grows. kExpBf16 = true: a first
// walk over the keys alone for m, then each weight e = bf16(exp(bf16(s -
// m))), the exponential of an argument and with a result rounded to
// bfloat16, as a bfloat16 exp of (s - m) gives it; e has 8 significant
// bits, so it is exact in TF32 and e v needs two products (e v_lo + e
// v_hi), not three. P V is summed a group at a time: the group's chunks
// in a fresh accumulator, then one rounded f32 add. Keys past K are
// masked after the exponential (weight 0), and out of the max.
//
// The staged tiles are not split once per block, as dq splits them: each
// warp splits the B fragments it loads in registers, which halves the
// fragment loads and drops the split pass and its barrier (6% faster on an
// H100, PERF.md §6). Independent products are issued together (the chunks
// of a class step; four class blocks of P V), each accumulator's products
// in mma3's order.
template <int CP, bool kExpBf16>
__device__ __forceinline__ void attend(const RowsA<CP / 8, true>& qa,
                                       const float* __restrict__ k,
                                       const float* __restrict__ v, int b,
                                       int C, int K, float* smem,
                                       float (&o)[CP / 8][4], float (&m)[2],
                                       float (&l)[2]) {
  static_assert(CP % 8 == 0 && kThreads % 32 == 0, "tile shapes");
  constexpr int NK = CP / 8;
  constexpr int NCH = kChunks<CP>;
  constexpr int NB = NK < 4 ? NK : 4;  // class blocks of P V issued together
  constexpr int kTile = CP * kItems;
  const int lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;

#pragma unroll
  for (int nn = 0; nn < NK; ++nn) {
#pragma unroll
    for (int r = 0; r < 4; ++r) o[nn][r] = 0.f;
  }
  m[0] = m[1] = -INFINITY;
  l[0] = l[1] = 0.f;

  const float* kb = k + static_cast<size_t>(b) * K * C;
  const float* vb = v + static_cast<size_t>(b) * K * C;
  const int tiles = (K + kItems - 1) / kItems;
  // walk 0 of the bf16 variant takes the max alone and stages no values
  constexpr int kWalks = kExpBf16 ? 2 : 1;
#pragma unroll 1
  for (int walk = 0; walk < kWalks; ++walk) {
    const bool values = walk == kWalks - 1;
    // the k and v tiles of buffer buf: smem + (2 buf + 0 or 1) kTile
    auto stage = [&](int tile, int buf) {
      const int j0 = tile * kItems;
      const int n = min(kItems, K - j0);
      stage_rows<CP>(smem + 2 * buf * kTile,
                     kb + static_cast<size_t>(j0) * C, n, C);
      if (values) {
        stage_rows<CP>(smem + (2 * buf + 1) * kTile,
                       vb + static_cast<size_t>(j0) * C, n, C);
      }
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
      const float* kt = smem + 2 * buf * kTile;
      const float* vt = smem + (2 * buf + 1) * kTile;
      const int j0 = tile * kItems;
#pragma unroll 1
      for (int n0 = 0; n0 < kItems; n0 += 8 * NCH) {
        // the scores, as bwd_dq_kernel computes them
        float s[NCH][4];
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
#pragma unroll
          for (int r = 0; r < 4; ++r) s[ch][r] = 0.f;
        }
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) {
          uint32_t qh[4], ql[4], bh[NCH][2], bl[NCH][2];
          qa.at(kk, qh, ql);
#pragma unroll
          for (int ch = 0; ch < NCH; ++ch) {
            load_kn_raw(kt, kk, n0 + 8 * ch, gq, tq, bh[ch], bl[ch]);
          }
          // mma3 of each chunk, the chunks interleaved
#pragma unroll
          for (int ch = 0; ch < NCH; ++ch) mma(s[ch], ql, bh[ch]);
#pragma unroll
          for (int ch = 0; ch < NCH; ++ch) mma(s[ch], qh, bl[ch]);
#pragma unroll
          for (int ch = 0; ch < NCH; ++ch) mma(s[ch], qh, bh[ch]);
        }
        // element r: anchor row g + 8(r/2), key t + 4(r%2) of the chunk
        bool live[NCH][2];
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            live[ch][u] = j0 + n0 + 8 * ch + tq + 4 * u < K;
          }
        }
        if (!values) {  // the bf16 variant's first walk: the max alone
#pragma unroll
          for (int ch = 0; ch < NCH; ++ch) {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              if (live[ch][r % 2]) m[r / 2] = fmaxf(m[r / 2], s[ch][r]);
            }
          }
          continue;
        }
        if (!kExpBf16) {
          // the group's max of each row over the quad; rescale the rows
          // whose max grew
          float mx[2] = {m[0], m[1]};
#pragma unroll
          for (int ch = 0; ch < NCH; ++ch) {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              if (live[ch][r % 2]) mx[r / 2] = fmaxf(mx[r / 2], s[ch][r]);
            }
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          }
          if (__any_sync(0xffffffffu, mx[0] > m[0] || mx[1] > m[1])) {
            float corr[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              corr[h] = mx[h] > m[h] ? __expf(m[h] - mx[h]) : 1.f;  // 0 first
              l[h] *= corr[h];
              m[h] = mx[h];
            }
#pragma unroll
            for (int nn = 0; nn < NK; ++nn) {
#pragma unroll
              for (int r = 0; r < 4; ++r) o[nn][r] *= corr[r / 2];
            }
          }
        }
        // the weights, masked after the exponential, as the A operands of
        // O += P V (k = the chunk's keys t, t+4)
        uint32_t ph[NCH][4], pl[NCH][4];
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
          float w[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float x = s[ch][r] - m[r / 2];
            w[r] = !live[ch][r % 2] ? 0.f
                   : kExpBf16       ? bf16_round(expf(bf16_round(x)))
                                    : __expf(x);
            l[r / 2] += w[r];
          }
          const float a[4] = {w[0], w[2], w[1], w[3]};
          if (kExpBf16) {
#pragma unroll
            for (int i = 0; i < 4; ++i) ph[ch][i] = __float_as_uint(a[i]);
          } else {
            split<4>(a, ph[ch], pl[ch]);
          }
        }
#pragma unroll
        for (int nb = 0; nb < NK; nb += NB) {
          float t[NB][4];
#pragma unroll
          for (int j = 0; j < NB; ++j) {
#pragma unroll
            for (int r = 0; r < 4; ++r) t[j][r] = 0.f;
          }
#pragma unroll
          for (int ch = 0; ch < NCH; ++ch) {
            uint32_t bh[NB][2], bl[NB][2];
#pragma unroll
            for (int j = 0; j < NB; ++j) {
              load_nk_raw(vt, n0 + 8 * ch, nb + j, gq, tq, bh[j], bl[j]);
            }
            if (!kExpBf16) {
#pragma unroll
              for (int j = 0; j < NB; ++j) mma(t[j], pl[ch], bh[j]);
            }
#pragma unroll
            for (int j = 0; j < NB; ++j) mma(t[j], ph[ch], bl[j]);
#pragma unroll
            for (int j = 0; j < NB; ++j) mma(t[j], ph[ch], bh[j]);
          }
#pragma unroll
          for (int j = 0; j < NB; ++j) {
#pragma unroll
            for (int r = 0; r < 4; ++r) o[nb + j][r] += t[j][r];
          }
        }
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
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
}

// The blockwise backwards' dwz (ct_attention_cm_bwd.cu,
// ct_attention_bwd_bf16.cu): dwz[c] = the sum over the n partial rows of
// part[:, c], in a fixed order: one block per class, a strided sum per
// thread, then a tree in shared memory.
constexpr int kReduceThreads = 256;

__global__ void __launch_bounds__(kReduceThreads)
dwz_reduce_kernel(const float* __restrict__ part, float* __restrict__ dwz,
                  int n, int C) {
  __shared__ float red[kReduceThreads];
  const int c = blockIdx.x;
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += kReduceThreads) {
    s += part[static_cast<size_t>(i) * C + c];
  }
  red[threadIdx.x] = s;
  __syncthreads();
  for (int w = kReduceThreads / 2; w > 0; w /= 2) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) dwz[c] = red[0];
}

}  // namespace ct
