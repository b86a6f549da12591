// Context-Transformer attention, backward, bfloat16, for Hopper.
//
// Replaces three Pallas TPU kernels of ct_tpu/ops/ct_attention.py on the
// bfloat16 operands that `train.py --bf16` gives them:
//  * `_bwd_kernel_cm_flash` (reached through `_bwd_call_cm_flash`): the
//    flash backward, from the statistics the training forward saved;
//  * `_bwd_kernel_cm` (reached through `_bwd_call_cm`, with
//    CT_ATTENTION_FLASH=0): the blockwise backward, from q, k, v, wz and g
//    alone;
//  * `_bwd_kernel` (the row-major blockwise backward, reached through
//    `pl.pallas_call` in scripts/bench_ct_bwd.py, which feeds it bf16): the
//    same with q, g and dq row-major.
// For out = base + wz * delta, delta = softmax_K(k^T q) v, per image b,
// anchor p and key j, with the JAX kernels' rounding points (bf() rounds
// to bfloat16, nearest even; every product of two bf16 operands is exact
// and summed in f32):
//
//   s      = sum_c k[j,c] q[c,p]               m = max_j s
//   attn   = e^(s - m) * inv                   f32, unrounded
//   gv     = bf(g[c,p] * wz[c])                rounded before both uses
//   dattn  = sum_c v[j,c] gv[c]
//   ds     = bf(a * (dattn - colsum))
//   dq[c,p] = bf(sum_j k[j,c] ds)   dk[j,c] = sum_p q[c,p] ds
//   dv[j,c] = sum_p gv[c,p] bf(attn)                        (dk, dv f32)
//
// The two backwards differ in inv, a and colsum:
//  * flash (row 3): inv = 1/z, z the forward's sum of the bf16-rounded
//    weights; a = attn, unrounded; colsum = sum_c g wz delta, from the
//    forward's bf16 delta, taken by the caller (as `_bwd_call_cm_flash`
//    takes it outside its kernel);
//  * blockwise (rows 4 and 5): inv = 1/sum_j e^(s - m), of the unrounded
//    exponentials (row 5 divides by the sum instead, e / l, correctly
//    rounded); a = bf(attn), the rounded weights; colsum = sum_j a dattn;
//    and dwz = sum_{b,p} g delta with delta = sum_j v[j,:] bf(attn), all
//    computed here; row 5 emits dq unrounded, in float32, as the bench's
//    wrapper declares it.
//
// What bounds it on the H100. Per (anchor, key) the blockwise backward
// takes 10 products of CP classes (stats: S twice, delta; dq: S, dP, dQ;
// dk/dv: S, dP, dK, dV; 20*B*P*K*CP flops) and 4 exponentials (stats
// twice, dq, dk/dv); the flash one 7 and 2. At C=60 (CP=64) the products
// on the bf16 tensor cores set the floor, at C=15 (CP=16) the exponentials
// on the special-function units (16 a clock an SM); the elementwise work
// between them (the weight, its rounding, ds and the packing of two
// operands a pair) runs on the FP32 and conversion pipes beside them.
//
// Design. Each kernel is one warpgroup (128 threads) that owns 64 rows:
// anchors in the stats pass and dq, keys in dk/dv. Every product is a
// warpgroup wgmma (ct_attention_wgmma.cuh): the scores S and dP (or their
// transposes) read both operands from shared memory, the block's own rows
// (q and gv, or k and v) staged once and the walked tile's rows; dQ, delta,
// dK and dV take the computed operand (ds, bf(attn), their transposes)
// from registers, packed two by two from the score accumulators, and read
// the walked tile a second time, MN-major: one staged tile serves both of
// its products. The k and v rows and the register file they held in the
// mma.sync design are free for the score accumulators.
//  * Scratch layout: prep kernels (prep_kv, which the forwards share, in
//    ct_attention_wgmma.cuh, and prep_q) write k, v, q, gv (and for the
//    stats epilogue the raw g) as [B][rows][CP] bf16 in the swizzled tile
//    layout of ct_attention_wgmma.cuh, rows padded to whole 64-row tiles
//    with zeros, so that staging a tile is one contiguous cp.async.bulk that
//    completes on an mbarrier: the scratch is the port's own, so no tensor
//    map is needed (one would need libcuda's cuTensorMapEncodeTiled on the
//    host at each call, for the same contiguous bytes). The
//    statistics (m log2 e, the inverse sum, the sum, colsum) go to
//    [4][B][Pp] f32; a padded anchor has m = +inf, so that its weight is 0.
//    The class-major prep transposes a [64 anchors x C] block through
//    shared memory; the row-major one reads the block's contiguous C*64
//    values 16 bytes a thread where the address allows it.
//  * Pipeline: two stages of walked tiles; thread 0 issues the next
//    stage's copies once the warpgroup has passed the block barrier that
//    ends the products reading it, so the copy of a tile overlaps the work
//    on the one before. A tile takes two wgmma groups, each waited for:
//    the scores, then the products from them. Two to five blocks an SM
//    (registers) let the elementwise work of one warpgroup overlap the
//    products of another. Two variants ran slower at C=60 (PERF.md §6):
//    the next tile's scores issued with this tile's products (one wait a
//    tile; dk/dv 2.16 against 1.55 ms), and two warpgroups a block sharing
//    each staged tile (half the reads from L2; row 4 4.96 against 4.50).
//  * Elementwise: the exponential as ex2 of s log2 e - m log2 e (one FMA);
//    bf() of a weight on the integer pipe (round_bf16); a key past K is
//    masked in the ragged last tile only.
//  0. (blockwise only) stats: 64 anchors a block, the keys in tiles of 64,
//     two walks: the max and the sum together, online (l <- l e^(m_old -
//     m_new) + sum e^(s - m_new), the max reduced over a row's four
//     threads every tile), then delta = sum_j bf(attn) v against the final
//     m and l; the epilogue writes the statistics, colsum = sum_c gv delta,
//     and the block's partial sums of g delta per class, which dwz_reduce
//     sums in a fixed order, one block a class.
//  1. dq: 64 anchors a block, the keys in tiles of 64: S = Q K^T and dP =
//     GV V^T, ds elementwise, dQ += ds K.
//  2. dk, dv: 64 keys a block, the anchors in tiles of 64: S^T = K Q^T and
//     dP^T = V GV^T, then dK += ds^T Q and dV += bf(attn)^T GV.
// Row 5's division: r = 1/l once a row, then each weight by Markstein's
// correction of e r (div_fast), the bits of __fdiv_rn in three FMA-pipe
// operations and no branch; a warp that holds a weight below 2^-100
// takes div_rn, which divides those (a branch a weight took row 5's dk/dv
// to 3.76 ms, the warp's test to 2.39, against 1.53 for row 4's, which
// multiplies; PERF.md §6). No float atomics: the result does not depend
// on the order in which blocks run. The long sums (dq over the keys, dk
// and dv over the anchors) take each 64-item tile's product in a fresh
// accumulator and add it to the running sum with rounded f32 adds: the
// tensor cores truncate their accumulator (ct_attention_mma.cuh). Outputs
// leave through shared memory, in rows of the output's own layout. Ragged
// K: keys past K are zero rows, masked after the exponential in the last
// tile.

#include "ct_attention_mma.cuh"
#include "ct_attention_wgmma.cuh"

namespace {

using namespace ct;
using bf16 = __nv_bfloat16;
using wg::add_to;
using wg::ex2;
using wg::kLog2e;
using wg::kPrepThreads;
using wg::kTile;
using wg::mask_keys;
using wg::round_bf16;
using wg::rows_product;
using wg::scores;
using wg::to_frags;
using wg::whole_tiles;

constexpr int kNT = wg::kThreads;
constexpr int kStages = 2;

// Blocks an SM that the launch bounds ask registers for. ptxas on an H100
// (CP=64 / 16): stats 94-128 / 64-71, dq 114-134 / 95-122, dk/dv 165-182
// / 103-136 registers a thread, none spilled; dk/dv at three blocks for
// CP=64 spilled.
template <int CP>
constexpr int kStatsBlocks = CP <= 16 ? 4 : 3;
template <int CP>
constexpr int kDqBlocks = CP <= 16 ? 4 : 3;
template <int CP>
constexpr int kDkDvBlocks = CP <= 16 ? 3 : 2;

// e / l from r = 1/l (correctly rounded): Markstein's correction of q0 =
// e r by the exact residual e - q0 l, correctly rounded for e = 0 and for
// every e whose quotient is normal (e >= 2^-100 > 2^-126 l, l < 2^26).
__device__ __forceinline__ float div_fast(float e, float l, float r) {
  const float q0 = __fmul_rn(e, r);
  const float rho = __fmaf_rn(-q0, l, e);
  return __fmaf_rn(rho, r, q0);
}

// e / l correctly rounded for every e >= 0: tiny e take the division
// itself.
__device__ __noinline__ float div_rn(float e, float l, float r) {
  return e > 0.f && e < 0x1p-100f ? __fdiv_rn(e, l) : div_fast(e, l, r);
}

// The weights of a [64 x 64] score accumulator x, in place: e = e^(s - m)
// as 2^(s log2 e - ml), then e r or, with kDiv, e / l; ml(i), r(i) and
// l(i) give element i's statistics. The division runs branch-free unless
// a thread of the warp holds an e below 2^-100 (s - m < -69; or 0, as the
// exponentials of a padded anchor, and a key past K may be): then each
// weight takes div_rn, which is exact for all.
template <bool kDiv, typename ML, typename R, typename L>
__device__ __forceinline__ void weights(float (&x)[32], ML ml, R r, L l) {
#pragma unroll
  for (int i = 0; i < 32; ++i) x[i] = ex2(__fmaf_rn(x[i], kLog2e, -ml(i)));
  if (!kDiv) {
#pragma unroll
    for (int i = 0; i < 32; ++i) x[i] = __fmul_rn(x[i], r(i));
    return;
  }
  float least = x[0];
#pragma unroll
  for (int i = 1; i < 32; ++i) least = fminf(least, x[i]);
  if (__any_sync(0xffffffffu, least < 0x1p-100f)) {
#pragma unroll
    for (int i = 0; i < 32; ++i) x[i] = div_rn(x[i], l(i), r(i));
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) x[i] = div_fast(x[i], l(i), r(i));
  }
}

// A [kTile][CP] f32 staging of a block's output in shared memory, rows of
// CP + 8 floats (the float2 stores of an accumulator's quads fall on
// distinct banks).
template <int CP>
constexpr int kOutStride = CP + 8;

// Stage accumulator d (rows of the block, classes) into out.
template <int CP>
__device__ __forceinline__ void stage_out(float* out, const float (&d)[CP / 2],
                                          int w, int g, int t) {
#pragma unroll
  for (int i = 0; i < CP / 8; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * w + g + 8 * h;
      *reinterpret_cast<float2*>(out + row * kOutStride<CP> + 8 * i + 2 * t) =
          make_float2(d[4 * i + 2 * h], d[4 * i + 2 * h + 1]);
    }
  }
}

// Write rows r0 .. r0+n-1 of a staged output to a row-major [rows][C] f32
// tensor: their n*C values are contiguous.
template <int CP>
__device__ __forceinline__ void write_rows(float* __restrict__ dst,
                                           const float* out, int n, int C) {
  for (int e = threadIdx.x; e < n * C; e += kNT) {
    dst[e] = out[(e / C) * kOutStride<CP> + e % C];
  }
}

// --- prep ----------------------------------------------------------------

// One block a 64-anchor tile of one image: q and g (class-major [B,C,P] or
// row-major [B,P,C] bf16) → qp = q, gp = bf(g * wz) and, with kRaw, gr = g,
// each [B][Pp][CP] in the tile layout, zero past C and P. The block is
// read coalesced into shared memory ([anchor][class]) and written 16 bytes
// a thread. With kFlash also the statistics st [4][B][Pp] from the flash
// backward's m, z and colsum [B,P]: m log2 e, 1/z, z, colsum (+inf, 0, 1,
// 0 past P).
template <int CP, bool kRowMajor, bool kFlash, bool kRaw>
__global__ void __launch_bounds__(kPrepThreads)
prep_q(const uint16_t* __restrict__ q, const uint16_t* __restrict__ g,
       const float* __restrict__ wz, const float* __restrict__ m,
       const float* __restrict__ z, const float* __restrict__ colsum,
       bf16* __restrict__ qp, bf16* __restrict__ gp, bf16* __restrict__ gr,
       float* __restrict__ st, int B, int C, int P, int Pp) {
  constexpr int SP = CP + 2;  // odd words a row: a column's writes spread
  __shared__ uint16_t sq[kTile * SP], sg[kTile * SP];
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kTile;
  const int n = min(kTile, P - p0);
  const int tid = threadIdx.x;
  for (int e = tid; e < kTile * SP; e += kPrepThreads) sq[e] = sg[e] = 0;
  __syncthreads();
  if (kRowMajor) {
    // the block's n*C values are contiguous
    const uint16_t* qs = q + (static_cast<size_t>(b) * P + p0) * C;
    const uint16_t* gs = g + (static_cast<size_t>(b) * P + p0) * C;
    const int cnt = n * C;
    int done = 0;
    if (((reinterpret_cast<uintptr_t>(qs) | reinterpret_cast<uintptr_t>(gs)) &
         15) == 0) {
      const int nv = cnt / 8;
      for (int u = tid; u < nv; u += kPrepThreads) {
        const uint4 a = reinterpret_cast<const uint4*>(qs)[u];
        const uint4 c4 = reinterpret_cast<const uint4*>(gs)[u];
        const uint16_t* pa = reinterpret_cast<const uint16_t*>(&a);
        const uint16_t* pc = reinterpret_cast<const uint16_t*>(&c4);
#pragma unroll
        for (int h = 0; h < 8; ++h) {
          const int e = 8 * u + h;
          const int o = (e / C) * SP + e % C;
          sq[o] = pa[h];
          sg[o] = pc[h];
        }
      }
      done = nv * 8;
    }
    for (int e = done + tid; e < cnt; e += kPrepThreads) {
      const int o = (e / C) * SP + e % C;
      sq[o] = qs[e];
      sg[o] = gs[e];
    }
  } else {
    for (int e = tid; e < C * kTile; e += kPrepThreads) {
      const int c = e / kTile;
      const int i = e % kTile;
      if (i < n) {
        const size_t at = (static_cast<size_t>(b) * C + c) * P + p0 + i;
        sq[i * SP + c] = q[at];
        sg[i * SP + c] = g[at];
      }
    }
  }
  __syncthreads();
  constexpr int kChunks = CP / 8;
  for (int e = tid; e < kTile * kChunks; e += kPrepThreads) {
    const int i = e / kChunks;
    const int ch = e % kChunks;
    uint32_t wq[4], wg4[4], wr[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = 8 * ch + 2 * u;
      const uint16_t q0 = sq[i * SP + c], q1 = sq[i * SP + c + 1];
      const uint16_t g0 = sg[i * SP + c], g1 = sg[i * SP + c + 1];
      wq[u] = q0 | (static_cast<uint32_t>(q1) << 16);
      wr[u] = g0 | (static_cast<uint32_t>(g1) << 16);
      const float x0 =
          c < C ? __fmul_rn(__uint_as_float(static_cast<uint32_t>(g0) << 16),
                            wz[c])
                : 0.f;
      const float x1 =
          c + 1 < C
              ? __fmul_rn(__uint_as_float(static_cast<uint32_t>(g1) << 16),
                          wz[c + 1])
              : 0.f;
      wg4[u] = wg::pack(x0, x1);
    }
    const size_t o = (static_cast<size_t>(b) * Pp + p0 + i) * CP +
                     wg::chunk_at<CP>(i, ch) * 8;
    *reinterpret_cast<uint4*>(qp + o) = make_uint4(wq[0], wq[1], wq[2], wq[3]);
    *reinterpret_cast<uint4*>(gp + o) =
        make_uint4(wg4[0], wg4[1], wg4[2], wg4[3]);
    if (kRaw) {
      *reinterpret_cast<uint4*>(gr + o) =
          make_uint4(wr[0], wr[1], wr[2], wr[3]);
    }
  }
  if (kFlash) {
    const size_t all = static_cast<size_t>(B) * Pp;
    for (int i = tid; i < kTile; i += kPrepThreads) {
      const int p = p0 + i;
      const bool live = p < P;
      const size_t at = static_cast<size_t>(b) * P + p;
      const size_t o = static_cast<size_t>(b) * Pp + p;
      st[o] = live ? __fmul_rn(m[at], kLog2e) : INFINITY;
      st[all + o] = live ? __frcp_rn(z[at]) : 0.f;
      st[2 * all + o] = live ? z[at] : 1.f;
      st[3 * all + o] = live ? colsum[at] : 0.f;
    }
  }
}

// --- the kernels ---------------------------------------------------------

// Blockwise stats pass (rows 4 and 5) over 64 anchors a block: the
// statistics → st, and the block's partial sums of g delta per class →
// part [B * Pp/64][C]. kDiv (row 5): the weights e / l.
template <int CP, bool kDiv>
__global__ void __launch_bounds__(kNT, kStatsBlocks<CP>)
stats_kernel(const bf16* __restrict__ qp, const bf16* __restrict__ gp,
             const bf16* __restrict__ gr, const bf16* __restrict__ kp,
             const bf16* __restrict__ vp, float* __restrict__ st,
             float* __restrict__ part, int B, int C, int P, int Pp, int K,
             int Kp) {
  constexpr int TB = wg::kTileBytes<CP>;
  constexpr int kStage = 2 * TB;  // a k tile and a v tile
  extern __shared__ uint8_t dyn[];
  __shared__ __align__(8) uint64_t bar[1 + kStages];
  __shared__ float red[4][CP];
  uint8_t* base = wg::align_1024(dyn);
  bf16* sq = reinterpret_cast<bf16*>(base);
  auto stage_k = [&](int s) {
    return reinterpret_cast<bf16*>(base + TB + s * kStage);
  };
  auto stage_v = [&](int s) {
    return reinterpret_cast<bf16*>(base + TB + s * kStage + TB);
  };
  const int tid = threadIdx.x;
  const int w = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kTile;
  const int tiles = Kp / kTile;
  const int loads = 2 * tiles;  // walk 1 the k tiles, walk 2 k and v
  const bf16* kb = kp + static_cast<size_t>(b) * Kp * CP;
  const bf16* vb = vp + static_cast<size_t>(b) * Kp * CP;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 1 + kStages; ++i) wg::bar_init(&bar[i], 1);
    wg::bar_init_fence();
  }
  __syncthreads();
  auto issue = [&](int n) {
    const int s = n % kStages;
    const size_t off = static_cast<size_t>(n % tiles) * kTile * CP;
    const bool values = n >= tiles;
    wg::bar_expect(&bar[1 + s], values ? 2 * TB : TB);
    wg::bulk_copy(stage_k(s), kb + off, TB, &bar[1 + s]);
    if (values) wg::bulk_copy(stage_v(s), vb + off, TB, &bar[1 + s]);
  };
  if (tid == 0) {
    wg::bar_expect(&bar[0], TB);
    wg::bulk_copy(sq, qp + (static_cast<size_t>(b) * Pp + p0) * CP, TB,
                  &bar[0]);
    for (int n = 0; n < kStages && n < loads; ++n) issue(n);
  }

  const uint64_t dq = wg::desc<CP>(sq);
  // row h of this thread: 16w + g + 8h of the block; m, l partial over
  // the thread's keys until the end of walk 1, the row's after it
  float ml[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, r[2];
  float o[CP / 2];
  wg::zero(o);
  wg::bar_wait(&bar[0], 0);
#pragma unroll 1
  for (int n = 0; n < loads; ++n) {
    const int s = n % kStages;
    wg::bar_wait(&bar[1 + s], (n / kStages) & 1);
    __syncwarp();
    const int j0 = (n % tiles) * kTile;
    const bool ragged = j0 + kTile > K;
    float sc[32];
    wg::fence();
    scores<CP>(sc, dq, wg::desc<CP>(stage_k(s)));
    wg::commit();
    wg::wait<0>();
    wg::keep(sc);
    if (n < tiles) {
      // walk 1: the max and the sum, online (a key past K: s = -inf)
      if (ragged) mask_keys(sc, j0, K, t, -INFINITY);
      float tm[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        tm[(i >> 1) & 1] = fmaxf(tm[(i >> 1) & 1], sc[i]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        tm[h] = fmaxf(tm[h], __shfl_xor_sync(0xffffffffu, tm[h], 1));
        tm[h] = fmaxf(tm[h], __shfl_xor_sync(0xffffffffu, tm[h], 2));
        const float mn = fmaxf(ml[h], __fmul_rn(tm[h], kLog2e));
        l[h] = __fmul_rn(l[h], ex2(ml[h] - mn));
        ml[h] = mn;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i >> 1) & 1;
        l[h] += ex2(__fmaf_rn(sc[i], kLog2e, -ml[h]));
      }
      if (n == tiles - 1) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
          l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
          r[h] = __frcp_rn(l[h]);
        }
      }
    } else {
      // walk 2: delta += bf(attn) V
      weights<kDiv>(
          sc, [&](int i) { return ml[(i >> 1) & 1]; },
          [&](int i) { return r[(i >> 1) & 1]; },
          [&](int i) { return l[(i >> 1) & 1]; });
      if (ragged) mask_keys(sc, j0, K, t);
      uint32_t a[4][4];
      to_frags(sc, a);
      float dt[CP / 2];
      wg::fence();
      rows_product<CP>(dt, a, wg::desc<CP>(stage_v(s)));
      wg::commit();
      wg::wait<0>();
      wg::keep(dt);
      add_to(o, dt);
    }
    // every thread is done with stage s: refill it
    __syncthreads();
    if (tid == 0 && n + kStages < loads) issue(n + kStages);
  }

  // delta in the accumulator layout (element 4i + 2h + u: row 16w + g + 8h,
  // class 8i + 2t + u): colsum = sum_c gv delta per row, and per class this
  // thread's two rows of g delta; a row past P or a class past C holds
  // g = gv = 0
  const bf16* gpb = gp + static_cast<size_t>(b) * Pp * CP;
  const bf16* grb = gr + static_cast<size_t>(b) * Pp * CP;
  float cs[2] = {0.f, 0.f};
  float col[CP / 8][2];
#pragma unroll
  for (int i = 0; i < CP / 8; ++i) {
    col[i][0] = col[i][1] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * w + g + 8 * h;
      const size_t at = static_cast<size_t>(p0) * CP +
                        wg::at<CP>(row, 8 * i + 2 * t);
      const uint32_t gv2 = *reinterpret_cast<const uint32_t*>(gpb + at);
      const uint32_t g2 = *reinterpret_cast<const uint32_t*>(grb + at);
      const float d0 = o[4 * i + 2 * h], d1 = o[4 * i + 2 * h + 1];
      cs[h] = fmaf(wg::unpack_lo(gv2), d0, cs[h]);
      cs[h] = fmaf(wg::unpack_hi(gv2), d1, cs[h]);
      col[i][0] = fmaf(wg::unpack_lo(g2), d0, col[i][0]);
      col[i][1] = fmaf(wg::unpack_hi(g2), d1, col[i][1]);
    }
  }
  const size_t all = static_cast<size_t>(B) * Pp;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    cs[h] += __shfl_xor_sync(0xffffffffu, cs[h], 1);
    cs[h] += __shfl_xor_sync(0xffffffffu, cs[h], 2);
    const int p = p0 + 16 * w + g + 8 * h;
    if (t == 0) {
      const size_t at = static_cast<size_t>(b) * Pp + p;
      const bool live = p < P;
      st[at] = live ? ml[h] : INFINITY;
      st[all + at] = live ? r[h] : 0.f;
      st[2 * all + at] = live ? l[h] : 1.f;
      st[3 * all + at] = live ? cs[h] : 0.f;
    }
  }

  // this block's sum of g delta over its anchors, per class: the 8 row
  // groups of a warp, then the four warps in order
#pragma unroll
  for (int i = 0; i < CP / 8; ++i) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float x = col[i][u];
#pragma unroll
      for (int off = 4; off < 32; off *= 2) {
        x += __shfl_xor_sync(0xffffffffu, x, off);
      }
      if (g == 0) red[w][8 * i + 2 * t + u] = x;
    }
  }
  __syncthreads();
  if (tid < C) {
    float sum = 0.f;
    for (int v = 0; v < 4; ++v) sum += red[v][tid];
    part[(static_cast<size_t>(b) * gridDim.x + blockIdx.x) * C + tid] = sum;
  }
}

// dq over 64 anchors a block; kRound: ds from the rounded weights (rows 4
// and 5); kDiv: the weights divided by the sum (row 5); kRowMajor: dq
// row-major [B,P,C] float32, as the JAX bench's row-major wrapper emits it
// (else class-major [B,C,P] bf16).
template <int CP, bool kRound, bool kDiv, bool kRowMajor>
__global__ void __launch_bounds__(kNT, kDqBlocks<CP>)
dq_kernel(const bf16* __restrict__ qp, const bf16* __restrict__ gp,
          const bf16* __restrict__ kp, const bf16* __restrict__ vp,
          const float* __restrict__ st, void* __restrict__ dq, int B, int C,
          int P, int Pp, int K, int Kp) {
  constexpr int TB = wg::kTileBytes<CP>;
  constexpr int kStage = 2 * TB;  // a k tile and a v tile
  extern __shared__ uint8_t dyn[];
  __shared__ __align__(8) uint64_t bar[1 + kStages];
  uint8_t* base = wg::align_1024(dyn);
  bf16* sq = reinterpret_cast<bf16*>(base);
  bf16* sg = reinterpret_cast<bf16*>(base + TB);
  auto stage_k = [&](int s) {
    return reinterpret_cast<bf16*>(base + 2 * TB + s * kStage);
  };
  auto stage_v = [&](int s) {
    return reinterpret_cast<bf16*>(base + 2 * TB + s * kStage + TB);
  };
  const int tid = threadIdx.x;
  const int w = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kTile;
  const int tiles = Kp / kTile;
  const bf16* kb = kp + static_cast<size_t>(b) * Kp * CP;
  const bf16* vb = vp + static_cast<size_t>(b) * Kp * CP;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 1 + kStages; ++i) wg::bar_init(&bar[i], 1);
    wg::bar_init_fence();
  }
  __syncthreads();
  auto issue = [&](int n) {
    const int s = n % kStages;
    const size_t off = static_cast<size_t>(n) * kTile * CP;
    wg::bar_expect(&bar[1 + s], 2 * TB);
    wg::bulk_copy(stage_k(s), kb + off, TB, &bar[1 + s]);
    wg::bulk_copy(stage_v(s), vb + off, TB, &bar[1 + s]);
  };
  if (tid == 0) {
    const size_t off = (static_cast<size_t>(b) * Pp + p0) * CP;
    wg::bar_expect(&bar[0], 2 * TB);
    wg::bulk_copy(sq, qp + off, TB, &bar[0]);
    wg::bulk_copy(sg, gp + off, TB, &bar[0]);
    for (int n = 0; n < kStages && n < tiles; ++n) issue(n);
  }

  const size_t all = static_cast<size_t>(B) * Pp;
  float ml[2], r[2], l[2], cr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t at = static_cast<size_t>(b) * Pp + p0 + 16 * w + g + 8 * h;
    ml[h] = st[at];
    r[h] = st[all + at];
    l[h] = st[2 * all + at];
    cr[h] = st[3 * all + at];
  }
  const uint64_t dsq = wg::desc<CP>(sq);
  const uint64_t dsg = wg::desc<CP>(sg);
  float acc[CP / 2];
  wg::zero(acc);
  wg::bar_wait(&bar[0], 0);
#pragma unroll 1
  for (int n = 0; n < tiles; ++n) {
    const int s = n % kStages;
    wg::bar_wait(&bar[1 + s], (n / kStages) & 1);
    __syncwarp();
    const int j0 = n * kTile;
    const bool ragged = j0 + kTile > K;
    float sc[32], dp[32];
    wg::fence();
    scores<CP>(sc, dsq, wg::desc<CP>(stage_k(s)));
    scores<CP>(dp, dsg, wg::desc<CP>(stage_v(s)));
    wg::commit();
    wg::wait<0>();
    wg::keep(sc);
    wg::keep(dp);
    // ds over the tile's keys (element i: row 16w + g + 8((i/2)%2), key
    // j0 + 8(i/4) + 2t + i%2), 0 past K
    weights<kDiv>(
        sc, [&](int i) { return ml[(i >> 1) & 1]; },
        [&](int i) { return r[(i >> 1) & 1]; },
        [&](int i) { return l[(i >> 1) & 1]; });
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float a = kRound ? round_bf16(sc[i]) : sc[i];
      sc[i] = __fmul_rn(a, dp[i] - cr[(i >> 1) & 1]);
    }
    if (ragged) mask_keys(sc, j0, K, t);
    uint32_t da[4][4];
    to_frags(sc, da);
    float dt[CP / 2];
    wg::fence();
    rows_product<CP>(dt, da, wg::desc<CP>(stage_k(s)));
    wg::commit();
    wg::wait<0>();
    wg::keep(dt);
    add_to(acc, dt);
    __syncthreads();
    if (tid == 0 && n + kStages < tiles) issue(n + kStages);
  }

  // out through shared memory (the stages are free: no copy is in flight)
  float* out = reinterpret_cast<float*>(base + 2 * TB);
  stage_out<CP>(out, acc, w, g, t);
  __syncthreads();
  const int live = min(kTile, P - p0);
  if (kRowMajor) {
    write_rows<CP>(
        static_cast<float*>(dq) + (static_cast<size_t>(b) * P + p0) * C, out,
        live, C);
  } else {
    bf16* dqb = static_cast<bf16*>(dq) + static_cast<size_t>(b) * C * P + p0;
    for (int e = tid; e < C * kTile; e += kNT) {
      const int c = e / kTile;
      const int i = e % kTile;
      if (i < live) {
        dqb[static_cast<size_t>(c) * P + i] =
            __float2bfloat16_rn(out[i * kOutStride<CP> + c]);
      }
    }
  }
}

// dk and dv (f32 [B,K,C]) over 64 keys a block; kRound and kDiv as dq's.
template <int CP, bool kRound, bool kDiv>
__global__ void __launch_bounds__(kNT, kDkDvBlocks<CP>)
dkdv_kernel(const bf16* __restrict__ qp, const bf16* __restrict__ gp,
            const bf16* __restrict__ kp, const bf16* __restrict__ vp,
            const float* __restrict__ st, float* __restrict__ dk,
            float* __restrict__ dv, int B, int C, int Pp, int K, int Kp) {
  constexpr int TB = wg::kTileBytes<CP>;
  // a q tile, a gv tile, and the tile's statistics [4][kTile] f32
  constexpr int kStats = 4 * kTile * 4;
  constexpr int kStage = 2 * TB + kStats;
  extern __shared__ uint8_t dyn[];
  __shared__ __align__(8) uint64_t bar[1 + kStages];
  uint8_t* base = wg::align_1024(dyn);
  bf16* sk = reinterpret_cast<bf16*>(base);
  bf16* sv = reinterpret_cast<bf16*>(base + TB);
  auto stage_q = [&](int s) {
    return reinterpret_cast<bf16*>(base + 2 * TB + s * kStage);
  };
  auto stage_g = [&](int s) {
    return reinterpret_cast<bf16*>(base + 2 * TB + s * kStage + TB);
  };
  auto stage_st = [&](int s) {
    return reinterpret_cast<float*>(base + 2 * TB + s * kStage + 2 * TB);
  };
  const int tid = threadIdx.x;
  const int w = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int b = blockIdx.y;
  const int j0 = blockIdx.x * kTile;
  const int tiles = Pp / kTile;
  const size_t all = static_cast<size_t>(B) * Pp;
  const bf16* qb = qp + static_cast<size_t>(b) * Pp * CP;
  const bf16* gb = gp + static_cast<size_t>(b) * Pp * CP;
  const float* sb = st + static_cast<size_t>(b) * Pp;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 1 + kStages; ++i) wg::bar_init(&bar[i], 1);
    wg::bar_init_fence();
  }
  __syncthreads();
  auto issue = [&](int n) {
    const int s = n % kStages;
    const size_t off = static_cast<size_t>(n) * kTile * CP;
    wg::bar_expect(&bar[1 + s], 2 * TB + kStats);
    wg::bulk_copy(stage_q(s), qb + off, TB, &bar[1 + s]);
    wg::bulk_copy(stage_g(s), gb + off, TB, &bar[1 + s]);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      wg::bulk_copy(stage_st(s) + u * kTile, sb + u * all + n * kTile,
                    kTile * 4, &bar[1 + s]);
    }
  };
  if (tid == 0) {
    const size_t off = (static_cast<size_t>(b) * Kp + j0) * CP;
    wg::bar_expect(&bar[0], 2 * TB);
    wg::bulk_copy(sk, kp + off, TB, &bar[0]);
    wg::bulk_copy(sv, vp + off, TB, &bar[0]);
    for (int n = 0; n < kStages && n < tiles; ++n) issue(n);
  }

  const uint64_t dsk = wg::desc<CP>(sk);
  const uint64_t dsv = wg::desc<CP>(sv);
  float dka[CP / 2], dva[CP / 2];
  wg::zero(dka);
  wg::zero(dva);
  wg::bar_wait(&bar[0], 0);
#pragma unroll 1
  for (int n = 0; n < tiles; ++n) {
    const int s = n % kStages;
    wg::bar_wait(&bar[1 + s], (n / kStages) & 1);
    __syncwarp();
    float sc[32], dp[32];
    wg::fence();
    scores<CP>(sc, dsk, wg::desc<CP>(stage_q(s)));
    scores<CP>(dp, dsv, wg::desc<CP>(stage_g(s)));
    wg::commit();
    wg::wait<0>();
    wg::keep(sc);
    wg::keep(dp);
    // element i: key row 16w + g + 8((i/2)%2), anchor 8(i/4) + 2t + i%2 of
    // the tile; ds in sc, bf(attn) in dp's place
    const float* ts = stage_st(s);
    auto col = [&](int i) { return 8 * (i / 4) + 2 * t + (i & 1); };
    weights<kDiv>(
        sc, [&](int i) { return ts[col(i)]; },
        [&](int i) { return ts[kTile + col(i)]; },
        [&](int i) { return ts[2 * kTile + col(i)]; });
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float a = kRound ? round_bf16(sc[i]) : sc[i];
      const float at = sc[i];
      sc[i] = __fmul_rn(a, dp[i] - ts[3 * kTile + col(i)]);
      dp[i] = at;
    }
    uint32_t pds[4][4], pat[4][4];
    to_frags(sc, pds);
    to_frags(dp, pat);
    float kt[CP / 2], vt[CP / 2];
    wg::fence();
    rows_product<CP>(kt, pds, wg::desc<CP>(stage_q(s)));
    rows_product<CP>(vt, pat, wg::desc<CP>(stage_g(s)));
    wg::commit();
    wg::wait<0>();
    wg::keep(kt);
    wg::keep(vt);
    add_to(dka, kt);
    add_to(dva, vt);
    __syncthreads();
    if (tid == 0 && n + kStages < tiles) issue(n + kStages);
  }

  // out through shared memory, dk then dv; the block's live keys' rows of
  // [B,K,C] are contiguous
  float* out = reinterpret_cast<float*>(base + 2 * TB);
  const int live = min(kTile, K - j0);
  const size_t kv = (static_cast<size_t>(b) * K + j0) * C;
  stage_out<CP>(out, dka, w, g, t);
  __syncthreads();
  write_rows<CP>(dk + kv, out, live, C);
  __syncthreads();
  stage_out<CP>(out, dva, w, g, t);
  __syncthreads();
  write_rows<CP>(dv + kv, out, live, C);
}

// The division of row 5's weights alone, for its card test: out = div_rn
// (e, l, 1/l) and ref = __fdiv_rn(e, l) over n pairs.
__global__ void division_kernel(const float* __restrict__ e,
                                const float* __restrict__ l,
                                float* __restrict__ out,
                                float* __restrict__ ref, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    out[i] = div_rn(e[i], l[i], __frcp_rn(l[i]));
    ref[i] = __fdiv_rn(e[i], l[i]);
  }
}

int status() { return static_cast<int>(cudaGetLastError()); }

bool bad_shape(int B, int C, int P, int K) {
  return B <= 0 || C <= 0 || C >= 64 || P <= 0 || K <= 0 || B > 65535;
}

// The caller's scratch, as the entry points take it: kvp [2][B][Kp][CP]
// and qg [3][B][Pp][CP] bf16 (q, gv, and the raw g of the stats pass), st
// [4][B][Pp] f32; Kp and Pp the keys and anchors padded to whole tiles.
struct Scratch {
  bf16* kp;
  bf16* vp;
  bf16* qp;
  bf16* gp;
  bf16* gr;
  float* st;
  Scratch(void* kvp, void* qg, void* stats, int B, int CP, int Kp, int Pp)
      : kp(static_cast<bf16*>(kvp)),
        vp(kp + static_cast<size_t>(B) * Kp * CP),
        qp(static_cast<bf16*>(qg)),
        gp(qp + static_cast<size_t>(B) * Pp * CP),
        gr(gp + static_cast<size_t>(B) * Pp * CP),
        st(static_cast<float*>(stats)) {}
};

int grid_for(long long n, int threads) {
  const long long blocks = (n + threads - 1) / threads;
  return static_cast<int>(blocks < 8192 ? blocks : 8192);
}

// Launch a wgmma kernel on `smem` bytes of dynamic shared memory (and the
// slack to align it).
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, int smem, cudaStream_t st,
           Args... args) {
  const int bytes = smem + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kNT, bytes, st>>>(args...);
  return status();
}

// lay k, v, q and gv (with kRaw g, with kFlash the statistics) out
template <int CP, bool kRowMajor, bool kFlash>
int prepare(const void* q, const void* k, const void* v, const void* wz,
            const void* g, const void* m, const void* z, const void* colsum,
            const Scratch& sc, int B, int C, int P, int Pp, int K, int Kp,
            cudaStream_t st) {
  int err = wg::launch_prep_kv<CP, false>(k, v, sc.kp, sc.vp, B, K, Kp, C,
                                          st);
  if (err) return err;
  prep_q<CP, kRowMajor, kFlash, !kFlash>
      <<<dim3(Pp / kTile, B), kPrepThreads, 0, st>>>(
          static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(g),
          static_cast<const float*>(wz), static_cast<const float*>(m),
          static_cast<const float*>(z), static_cast<const float*>(colsum),
          sc.qp, sc.gp, sc.gr, sc.st, B, C, P, Pp);
  return status();
}

template <int CP, bool kRound, bool kDiv, bool kRowMajor>
int grads(const Scratch& sc, void* dq, void* dk, void* dv, int B, int C,
          int P, int Pp, int K, int Kp, cudaStream_t st) {
  constexpr int TB = wg::kTileBytes<CP>;
  const int dq_smem = 2 * TB + kStages * 2 * TB;
  int err = launch(dq_kernel<CP, kRound, kDiv, kRowMajor>,
                   dim3(Pp / kTile, B), dq_smem, st, sc.qp, sc.gp, sc.kp,
                   sc.vp, sc.st, dq, B, C, P, Pp, K, Kp);
  if (err) return err;
  const int dkdv_smem = 2 * TB + kStages * (2 * TB + 4 * kTile * 4);
  return launch(dkdv_kernel<CP, kRound, kDiv>, dim3(Kp / kTile, B),
                dkdv_smem, st, sc.qp, sc.gp, sc.kp, sc.vp, sc.st,
                static_cast<float*>(dk), static_cast<float*>(dv), B, C, Pp,
                K, Kp);
}

template <int CP>
int flash(const void* q, const void* k, const void* v, const void* wz,
          const void* g, const void* m, const void* z, const void* colsum,
          void* dq, void* dk, void* dv, const Scratch& sc, int B, int C,
          int P, int Pp, int K, int Kp, cudaStream_t st) {
  int err = prepare<CP, false, true>(q, k, v, wz, g, m, z, colsum, sc, B, C,
                                     P, Pp, K, Kp, st);
  if (err) return err;
  return grads<CP, false, false, false>(sc, dq, dk, dv, B, C, P, Pp, K, Kp,
                                        st);
}

template <int CP, bool kRowMajor>
int blockwise(const void* q, const void* k, const void* v, const void* wz,
              const void* g, void* dq, void* dk, void* dv, void* dwz,
              const Scratch& sc, void* part, int B, int C, int P, int Pp,
              int K, int Kp, cudaStream_t st) {
  int err = prepare<CP, kRowMajor, false>(q, k, v, wz, g, nullptr, nullptr,
                                          nullptr, sc, B, C, P, Pp, K, Kp,
                                          st);
  if (err) return err;
  constexpr int TB = wg::kTileBytes<CP>;
  const int blocks = Pp / kTile;
  err = launch(stats_kernel<CP, kRowMajor>, dim3(blocks, B),
               TB + kStages * 2 * TB, st, sc.qp, sc.gp, sc.gr, sc.kp, sc.vp,
               sc.st, static_cast<float*>(part), B, C, P, Pp, K, Kp);
  if (err) return err;
  dwz_reduce_kernel<<<C, kReduceThreads, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(dwz), B * blocks,
      C);
  err = status();
  if (err) return err;
  return grads<CP, true, kRowMajor, kRowMajor>(sc, dq, dk, dv, B, C, P, Pp,
                                               K, Kp, st);
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers of
// contiguous tensors: q, k, v, g and dq bf16, wz float32, dk, dv (and dwz)
// float32; C < 64. The caller's scratch: kvp [2][B][Kp][CP] and qg
// [3][B][Pp][CP] bf16 and st [4][B][Pp] float32, CP = 16 for C < 16 else
// 64, Kp and Pp = K and P rounded up to a multiple of 64. `stream` is a
// cudaStream_t. Each launches its kernels on it and returns the first
// launch error (cudaGetLastError), 0 on success.

// Flash backward, class-major q, g, dq [B,C,P], from the saved m, z and
// the caller's colsum [B,1,P] float32 → dq, dk, dv.
extern "C" int ct_attention_cm_bwd_flash_bf16(
    const void* q, const void* k, const void* v, const void* wz,
    const void* g, const void* m, const void* z, const void* colsum,
    void* dq, void* dk, void* dv, void* kvp, void* qg, void* stats, int B,
    int C, int P, int K, void* stream) {
  if (bad_shape(B, C, P, K)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int CP = wg::padded_classes(C);
  const int Pp = whole_tiles(P), Kp = whole_tiles(K);
  const Scratch sc(kvp, qg, stats, B, CP, Kp, Pp);
  if (CP == 16) {
    return flash<16>(q, k, v, wz, g, m, z, colsum, dq, dk, dv, sc, B, C, P,
                     Pp, K, Kp, st);
  }
  return flash<64>(q, k, v, wz, g, m, z, colsum, dq, dk, dv, sc, B, C, P, Pp,
                   K, Kp, st);
}

template <bool kRowMajor>
static int blockwise_entry(const void* q, const void* k, const void* v,
                           const void* wz, const void* g, void* dq, void* dk,
                           void* dv, void* dwz, void* kvp, void* qg,
                           void* stats, void* part, int B, int C, int P,
                           int K, void* stream) {
  if (bad_shape(B, C, P, K)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int CP = wg::padded_classes(C);
  const int Pp = whole_tiles(P), Kp = whole_tiles(K);
  const Scratch sc(kvp, qg, stats, B, CP, Kp, Pp);
  if (CP == 16) {
    return blockwise<16, kRowMajor>(q, k, v, wz, g, dq, dk, dv, dwz, sc, part,
                                    B, C, P, Pp, K, Kp, st);
  }
  return blockwise<64, kRowMajor>(q, k, v, wz, g, dq, dk, dv, dwz, sc, part,
                                  B, C, P, Pp, K, Kp, st);
}

// Blockwise backward, class-major q, g, dq [B,C,P] → dq, dk, dv, dwz [C].
// part: [B * Pp/64][C] float32 scratch, the blocks' partial sums of dwz.
extern "C" int ct_attention_cm_bwd_bf16(
    const void* q, const void* k, const void* v, const void* wz,
    const void* g, void* dq, void* dk, void* dv, void* dwz, void* kvp,
    void* qg, void* stats, void* part, int B, int C, int P, int K,
    void* stream) {
  return blockwise_entry<false>(q, k, v, wz, g, dq, dk, dv, dwz, kvp, qg,
                                stats, part, B, C, P, K, stream);
}

// Blockwise backward, row-major q, g [B,P,C] bf16 and dq [B,P,C] float32;
// otherwise as above (row 5: the weights divided by their sum).
extern "C" int ct_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* wz,
    const void* g, void* dq, void* dk, void* dv, void* dwz, void* kvp,
    void* qg, void* stats, void* part, int B, int C, int P, int K,
    void* stream) {
  return blockwise_entry<true>(q, k, v, wz, g, dq, dk, dv, dwz, kvp, qg,
                               stats, part, B, C, P, K, stream);
}

// Row 5's division on n float32 pairs (e, l): out the kernels' div_rn,
// ref __fdiv_rn, for the card test that holds them to the same bits.
extern "C" int ct_attention_bwd_bf16_division(const void* e, const void* l,
                                              void* out, void* ref, int n,
                                              void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  division_kernel<<<grid_for(n, 256), 256, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(e), static_cast<const float*>(l),
      static_cast<float*>(out), static_cast<float*>(ref), n);
  return status();
}
