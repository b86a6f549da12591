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
//    exponentials (row 5 divides by the sum instead); a = bf(attn), the
//    rounded weights; colsum = sum_j a dattn; and dwz = sum_{b,p} g delta
//    with delta = sum_j v[j,:] bf(attn), all computed here; row 5 emits
//    dq unrounded, in float32, as the bench's wrapper declares it.
//
// What bounds it on the H100: the B*P*K exponentials on the
// special-function units (16 a clock an SM): the products, 10*B*P*K*C
// flops (12 blockwise) at the bf16 tensor-core rate, take less at C=15 and
// about as much at C=60. PERF.md §6 rows 3, 4 and 5 (bf16) give the times.
//
// Design. Every product is a warp-wide mma.sync m16n8k16 on bf16 operands
// with f32 accumulators, operands read by ldmatrix from cp.async-staged
// tiles, as in the forwards' bf16 walk (ct_attention_bf16.cuh, whose
// helpers this file uses). A prep kernel lays q and gv out class-major
// [B][CP][Pp] (P padded to a multiple of 64 with zeros, C to CP), so that
// every tile is a whole, 16-byte-aligned one; pad_kv pads k and v to
// [B][K][CP] (v's ones column at C meets gv's zero class C and adds
// nothing). The statistics m, inv (with row 5 the sum itself) and colsum
// go to [3][B][Pp]; a padded anchor has m = 0, inv = 0 (row 5: sum = inf)
// and colsum = 0, so that its weight is 0 and it adds nothing.
//  0. (blockwise only) stats: 64 anchors a block, 16 a warp, three walks
//     over the keys in tiles of 32: the max, the sum of e^(s - m), then
//     delta = sum_j bf(attn) v on the tensor cores; the epilogue writes m,
//     inv, colsum = sum_c gv delta, and the block's partial sums of g delta
//     per class, which dwz_reduce sums in a fixed order, one block a class.
//  1. dq: 64 anchors a block, 16 a warp (q and gv rows as A operands), the
//     keys in tiles of 32, 16 at a time: S = Q K^T and dP = GV V^T, then
//     ds elementwise, packed to bf16 as the A operand of dQ += ds K.
//  2. dk, dv: 64 keys a block, 16 a warp (k and v rows as A operands), the
//     anchors in tiles of 32, 16 at a time: S^T = K Q^T and dP^T = V GV^T,
//     then dK += ds^T Q and dV += bf(attn)^T GV.
// No float atomics: the result does not depend on the order in which
// blocks run. The accumulator of a score product (C layout) packed two by
// two is the A operand of the next product (ct_attention_bf16.cuh). The
// long sums (dq over the keys, dk and dv over the anchors) take each
// 16-item product from a zero accumulator and add it with a rounded f32
// add: the tensor cores truncate their accumulator (ct_attention_mma.cuh).
// Ragged K: keys past K are zero-filled and masked after the exponential.

#include "ct_attention_bf16.cuh"

namespace {

using namespace ct;
using ct::bf::bf16;
using ct::bf::ldmatrix_x4;
using ct::bf::mma;
using ct::bf::pack;

// bf16 of a class row of a staged [CP][32] anchor tile: 32 anchors and 8
// of padding (rows of 80 bytes: the eight rows an ldmatrix reads at once
// fall on distinct banks)
constexpr int kAnchorStride = kItems + 8;

// Blocks an SM: at CP=64 a warp keeps two [16][64] A operands and two
// [16][64] f32 accumulators (dk/dv) or one (dq), 130-150 registers.
template <int CP>
constexpr int kBwdMinBlocks = CP <= 16 ? 4 : 2;

constexpr int kPrepThreads = 256;

__host__ __device__ __forceinline__ int padded_anchors(int P) {
  return (P + kRows - 1) / kRows * kRows;
}

// d = a b on the tensor cores, one m16n8k16 bf16 product from a zero
// accumulator.
__device__ __forceinline__ void mma_zero(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] = 0.f;
  mma(d, a, b);
}

// sum += a b, the product in a fresh accumulator, added with rounded adds.
__device__ __forceinline__ void mma_add(float (&sum)[4],
                                        const uint32_t (&a)[4],
                                        const uint32_t (&b)[2]) {
  float t[4];
  mma_zero(t, a, b);
#pragma unroll
  for (int i = 0; i < 4; ++i) sum[i] += t[i];
}

// The weight of one (anchor, key) from its score s and its anchor's m and
// zi: e^(s - m) times zi (the inverse of the denominator) or, with kDiv,
// over zi (the denominator itself).
template <bool kDiv>
__device__ __forceinline__ float weight(float s, float m, float zi) {
  const float e = __expf(s - m);
  return kDiv ? __fdiv_rn(e, zi) : __fmul_rn(e, zi);
}

// q and g (class-major [B,C,P] or row-major [B,P,C] bf16) → qp = q and gp
// = bf(g * wz), class-major [B][CP][Pp], zero past C and P. With kFlash
// also st = (m, 1/z, colsum) [3][B][Pp] from the flash backward's m, z and
// colsum [B,P]; zero past P. A thread an (image, anchor).
template <bool kRowMajor, bool kFlash>
__global__ void __launch_bounds__(kPrepThreads)
prep_kernel(const bf16* __restrict__ q, const bf16* __restrict__ g,
            const float* __restrict__ wz, const float* __restrict__ m,
            const float* __restrict__ z, const float* __restrict__ colsum,
            bf16* __restrict__ qp, bf16* __restrict__ gp,
            float* __restrict__ st, int B, int C, int CP, int P, int Pp) {
  const long long n = static_cast<long long>(B) * Pp;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < n; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int b = static_cast<int>(e / Pp);
    const int p = static_cast<int>(e % Pp);
    const bool live = p < P;
    for (int c = 0; c < CP; ++c) {
      float qv = 0.f, gv = 0.f;
      if (live && c < C) {
        const size_t at = kRowMajor
                              ? (static_cast<size_t>(b) * P + p) * C + c
                              : (static_cast<size_t>(b) * C + c) * P + p;
        qv = __bfloat162float(q[at]);
        gv = __fmul_rn(__bfloat162float(g[at]), wz[c]);
      }
      const size_t o = (static_cast<size_t>(b) * CP + c) * Pp + p;
      qp[o] = __float2bfloat16_rn(qv);
      gp[o] = __float2bfloat16_rn(gv);
    }
    if (kFlash) {
      const size_t at = static_cast<size_t>(b) * P + p;
      st[e] = live ? m[at] : 0.f;
      st[n + e] = live ? __frcp_rn(z[at]) : 0.f;
      st[2 * n + e] = live ? colsum[at] : 0.f;
    }
  }
}

// The score product of a warp's 16 rows against 16 items of a staged tile
// stored [item][CP] (k or v tiles, as the forward's walk reads them): s[0]
// items i0 .. i0+7, s[1] i0+8 .. i0+15, added to s.
template <int CP>
__device__ __forceinline__ void rows_x_items(const uint32_t (&a)[CP / 16][4],
                                             const bf16* tile, int i0,
                                             int lrow, int lcol,
                                             float (&s)[2][4]) {
  constexpr int S = bf::kStride<CP>;
#pragma unroll
  for (int kk = 0; kk < CP / 16; ++kk) {
    uint32_t r4[4];
    ldmatrix_x4<false>(r4, tile + (i0 + lrow) * S + 16 * kk + lcol);
    const uint32_t b0[2] = {r4[0], r4[1]};
    const uint32_t b1[2] = {r4[2], r4[3]};
    mma(s[0], a[kk], b0);
    mma(s[1], a[kk], b1);
  }
}

// The same against 16 items of a staged tile stored [CP][kAnchorStride]
// (q and gv anchor tiles, classes as rows).
template <int CP>
__device__ __forceinline__ void rows_x_anchors(const uint32_t (&a)[CP / 16][4],
                                               const bf16* tile, int i0,
                                               int lrow_t, int lcol_t,
                                               float (&s)[2][4]) {
#pragma unroll
  for (int kk = 0; kk < CP / 16; ++kk) {
    uint32_t r4[4];
    ldmatrix_x4<true>(r4,
                      tile + (16 * kk + lrow_t) * kAnchorStride + i0 + lcol_t);
    const uint32_t b0[2] = {r4[0], r4[1]};
    const uint32_t b1[2] = {r4[2], r4[3]};
    mma(s[0], a[kk], b0);
    mma(s[1], a[kk], b1);
  }
}

// Blockwise stats pass (rows 4 and 5): m, inv (kDiv: the sum), colsum →
// st, and the block's partial sums of g delta per class → part. q comes
// from qp, g from the caller's tensor in its own layout.
template <int CP, bool kRowMajor, bool kDiv>
__global__ void __launch_bounds__(kThreads, kBwdMinBlocks<CP>)
stats_kernel(const bf16* __restrict__ qp, const bf16* __restrict__ gp,
             const bf16* __restrict__ kp, const bf16* __restrict__ vp,
             const bf16* __restrict__ g, float* __restrict__ st,
             float* __restrict__ part, int B, int C, int P, int Pp, int K) {
  constexpr int NK = CP / 16;
  constexpr int NN = CP / 8;
  constexpr int S = bf::kStride<CP>;
  constexpr int kTile = bf::kTileElems<CP>;
  __shared__ __align__(16) bf16 smem[4 * kTile];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int gq = lane / 4, tq = lane % 4;
  const int lrow = (lane & 7) + ((lane >> 4) << 3);
  const int lcol = ((lane >> 3) & 1) << 3;
  const int lrow_t = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int lcol_t = (lane >> 4) << 3;
  const int b = blockIdx.y;
  const int pw = blockIdx.x * kRows + warp * 16;

  uint32_t qa[NK][4];
  bf::load_rows<CP, false>(qp, b, pw, CP, Pp, gq, tq, qa);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, zi[2];
  float o[NN][4];
#pragma unroll
  for (int nn = 0; nn < NN; ++nn) {
#pragma unroll
    for (int r = 0; r < 4; ++r) o[nn][r] = 0.f;
  }

  const bf16* kb = kp + static_cast<size_t>(b) * K * CP;
  const bf16* vb = vp + static_cast<size_t>(b) * K * CP;
  const int tiles = (K + kItems - 1) / kItems;
  // walk 0: the max; 1: the sum of e^(s - m); 2: delta = sum bf(attn) v
#pragma unroll 1
  for (int walk = 0; walk < 3; ++walk) {
    const bool values = walk == 2;
    auto stage = [&](int tile, int buf) {
      bf::stage_tile<CP>(smem + 2 * buf * kTile, kb, tile * kItems, K);
      if (values) bf::stage_tile<CP>(smem + (2 * buf + 1) * kTile, vb,
                                     tile * kItems, K);
    };
    __syncthreads();  // the last walk's tiles are no longer read
    stage(0, 0);
    ct::copy_commit();
#pragma unroll 1
    for (int tile = 0; tile < tiles; ++tile) {
      const int buf = tile % 2;
      ct::copy_wait_all();
      __syncthreads();
      if (tile + 1 < tiles) stage(tile + 1, buf ^ 1);
      ct::copy_commit();
      const bf16* kt = smem + 2 * buf * kTile;
      const bf16* vt = smem + (2 * buf + 1) * kTile;
      const int j0 = tile * kItems;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float s[2][4] = {};
        rows_x_items<CP>(qa, kt, 16 * half, lrow, lcol, s);
        // element r of s[ch]: row g + 8(r/2), key j0 + 16half + 8ch + 2t
        // + r%2
        uint32_t pa[4];
#pragma unroll
        for (int ch = 0; ch < 2; ++ch) {
          float w[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int h = r / 2;
            const bool live = j0 + 16 * half + 8 * ch + 2 * tq + r % 2 < K;
            if (walk == 0) {
              if (live) m[h] = fmaxf(m[h], s[ch][r]);
            } else if (walk == 1) {
              if (live) l[h] += __expf(s[ch][r] - m[h]);
            } else {
              w[r] = live ? weight<kDiv>(s[ch][r], m[h], zi[h]) : 0.f;
            }
          }
          if (values) {
            pa[ch * 2 + 0] = pack(w[0], w[1]);  // row g
            pa[ch * 2 + 1] = pack(w[2], w[3]);  // row g + 8
          }
        }
        if (!values) continue;
        // delta += bf(attn) V over these 16 keys
#pragma unroll
        for (int nn = 0; nn < NN; nn += 2) {
          uint32_t r4[4];
          ldmatrix_x4<true>(r4, vt + (16 * half + lrow_t) * S + 8 * nn +
                                    lcol_t);
          const uint32_t b0[2] = {r4[0], r4[1]};
          const uint32_t b1[2] = {r4[2], r4[3]};
          mma_add(o[nn], pa, b0);
          mma_add(o[nn + 1], pa, b1);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (walk == 0) {
        m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
        m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2));
      } else if (walk == 1) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
        zi[h] = kDiv ? l[h] : __frcp_rn(l[h]);
      }
    }
  }

  // delta in the accumulator layout (row g + 8(r/2), class 8nn + 2t +
  // r%2): colsum = sum_c gv delta per row, and per class this lane's two
  // rows of g delta; a row past P or a class past C holds g = gv = 0
  float cs[2] = {0.f, 0.f};
  float col[NN][2];
  const bf16* gpb = gp + static_cast<size_t>(b) * CP * Pp;
#pragma unroll
  for (int nn = 0; nn < NN; ++nn) {
    col[nn][0] = col[nn][1] = 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = pw + gq + (r / 2) * 8;
      const int c = 8 * nn + 2 * tq + r % 2;
      const bool ok = p < P && c < C;
      const size_t at = kRowMajor
                            ? (static_cast<size_t>(b) * P + p) * C + c
                            : (static_cast<size_t>(b) * C + c) * P + p;
      const float gval = ok ? __bfloat162float(g[at]) : 0.f;
      const float gv = __bfloat162float(gpb[static_cast<size_t>(c) * Pp + p]);
      cs[r / 2] = fmaf(gv, o[nn][r], cs[r / 2]);
      col[nn][r % 2] = fmaf(gval, o[nn][r], col[nn][r % 2]);
    }
  }
  const size_t n = static_cast<size_t>(B) * Pp;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    cs[h] += __shfl_xor_sync(0xffffffffu, cs[h], 1);
    cs[h] += __shfl_xor_sync(0xffffffffu, cs[h], 2);
    const int p = pw + gq + h * 8;
    if (tq == 0) {
      const size_t at = static_cast<size_t>(b) * Pp + p;
      const bool live = p < P;
      st[at] = live ? m[h] : 0.f;
      st[n + at] = live ? zi[h] : (kDiv ? INFINITY : 0.f);
      st[2 * n + at] = live ? cs[h] : 0.f;
    }
  }

  // this block's sum of g delta over its anchors, per class: the 8 row
  // groups of a warp, then the four warps in order
  float* red = reinterpret_cast<float*>(smem);  // [kWarps][CP]
  __syncthreads();                              // the tiles are not read
#pragma unroll
  for (int nn = 0; nn < NN; ++nn) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float x = col[nn][u];
#pragma unroll
      for (int off = 4; off < 32; off *= 2) {
        x += __shfl_xor_sync(0xffffffffu, x, off);
      }
      if (gq == 0) red[warp * CP + 8 * nn + 2 * tq + u] = x;
    }
  }
  __syncthreads();
  if (threadIdx.x < C) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w * CP + threadIdx.x];
    part[(static_cast<size_t>(b) * gridDim.x + blockIdx.x) * C +
         threadIdx.x] = s;
  }
}

// dq over 64 anchors a block; kRound: ds from the rounded weights (rows 4
// and 5); kDiv: the weights divided by st's sum (row 5); kRowMajor: dq
// row-major [B,P,C] float32, as the JAX bench's row-major wrapper emits it
// (else class-major [B,C,P] bf16).
template <int CP, bool kRound, bool kDiv, bool kRowMajor>
__global__ void __launch_bounds__(kThreads, kBwdMinBlocks<CP>)
dq_kernel(const bf16* __restrict__ qp, const bf16* __restrict__ gp,
          const bf16* __restrict__ kp, const bf16* __restrict__ vp,
          const float* __restrict__ st, void* __restrict__ dq, int B, int C,
          int P, int Pp, int K) {
  constexpr int NK = CP / 16;
  constexpr int NN = CP / 8;
  constexpr int S = bf::kStride<CP>;
  constexpr int kTile = bf::kTileElems<CP>;
  __shared__ __align__(16) bf16 smem[4 * kTile];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int gq = lane / 4, tq = lane % 4;
  const int lrow = (lane & 7) + ((lane >> 4) << 3);
  const int lcol = ((lane >> 3) & 1) << 3;
  const int lrow_t = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int lcol_t = (lane >> 4) << 3;
  const int b = blockIdx.y;
  const int pw = blockIdx.x * kRows + warp * 16;

  uint32_t qa[NK][4], ga[NK][4];
  bf::load_rows<CP, false>(qp, b, pw, CP, Pp, gq, tq, qa);
  bf::load_rows<CP, false>(gp, b, pw, CP, Pp, gq, tq, ga);
  const size_t n = static_cast<size_t>(B) * Pp;
  float mr[2], zr[2], cr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t at = static_cast<size_t>(b) * Pp + pw + gq + 8 * h;
    mr[h] = st[at];
    zr[h] = st[n + at];
    cr[h] = st[2 * n + at];
  }
  float acc[NN][4];
#pragma unroll
  for (int nn = 0; nn < NN; ++nn) {
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nn][r] = 0.f;
  }

  const bf16* kb = kp + static_cast<size_t>(b) * K * CP;
  const bf16* vb = vp + static_cast<size_t>(b) * K * CP;
  const int tiles = (K + kItems - 1) / kItems;
  auto stage = [&](int tile, int buf) {
    bf::stage_tile<CP>(smem + 2 * buf * kTile, kb, tile * kItems, K);
    bf::stage_tile<CP>(smem + (2 * buf + 1) * kTile, vb, tile * kItems, K);
  };
  stage(0, 0);
  ct::copy_commit();
#pragma unroll 1
  for (int tile = 0; tile < tiles; ++tile) {
    const int buf = tile % 2;
    ct::copy_wait_all();
    // the tile has landed, and every warp is done with the last one, whose
    // buffer the next tile's copies fill
    __syncthreads();
    if (tile + 1 < tiles) stage(tile + 1, buf ^ 1);
    ct::copy_commit();
    const bf16* kt = smem + 2 * buf * kTile;
    const bf16* vt = smem + (2 * buf + 1) * kTile;
    const int j0 = tile * kItems;
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // keys 16 half .. +15
      float s[2][4] = {}, d[2][4] = {};
      rows_x_items<CP>(qa, kt, 16 * half, lrow, lcol, s);
      rows_x_items<CP>(ga, vt, 16 * half, lrow, lcol, d);
      // element r of s[ch]: anchor row g + 8(r/2), key j0 + 16half + 8ch
      // + 2t + r%2; ds packed as the A operand over these 16 keys
      uint32_t pa[4];
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        float w[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int h = r / 2;
          const bool live = j0 + 16 * half + 8 * ch + 2 * tq + r % 2 < K;
          float a = live ? weight<kDiv>(s[ch][r], mr[h], zr[h]) : 0.f;
          if (kRound) a = bf16_round(a);
          w[r] = __fmul_rn(a, d[ch][r] - cr[h]);
        }
        pa[ch * 2 + 0] = pack(w[0], w[1]);
        pa[ch * 2 + 1] = pack(w[2], w[3]);
      }
      // dQ += ds K over these 16 keys, k read transposed
#pragma unroll
      for (int nn = 0; nn < NN; nn += 2) {
        uint32_t r4[4];
        ldmatrix_x4<true>(r4, kt + (16 * half + lrow_t) * S + 8 * nn +
                                  lcol_t);
        const uint32_t b0[2] = {r4[0], r4[1]};
        const uint32_t b1[2] = {r4[2], r4[3]};
        mma_add(acc[nn], pa, b0);
        mma_add(acc[nn + 1], pa, b1);
      }
    }
  }

  // element r of acc[nn]: anchor row g + 8(r/2), class 8nn + 2t + r%2
#pragma unroll
  for (int nn = 0; nn < NN; ++nn) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = pw + gq + (r / 2) * 8;
      const int c = 8 * nn + 2 * tq + r % 2;
      if (p < P && c < C) {
        if (kRowMajor) {
          static_cast<float*>(dq)[(static_cast<size_t>(b) * P + p) * C + c] =
              acc[nn][r];
        } else {
          static_cast<bf16*>(dq)[(static_cast<size_t>(b) * C + c) * P + p] =
              __float2bfloat16_rn(acc[nn][r]);
        }
      }
    }
  }
}

// dk and dv (f32 [B,K,C]) over 64 keys a block; kRound and kDiv as dq's.
template <int CP, bool kRound, bool kDiv>
__global__ void __launch_bounds__(kThreads, kBwdMinBlocks<CP>)
dkdv_kernel(const bf16* __restrict__ qp, const bf16* __restrict__ gp,
            const bf16* __restrict__ kp, const bf16* __restrict__ vp,
            const float* __restrict__ st, float* __restrict__ dk,
            float* __restrict__ dv, int B, int C, int Pp, int K) {
  constexpr int NK = CP / 16;
  constexpr int NN = CP / 8;
  constexpr int kTile = CP * kAnchorStride;
  __shared__ __align__(16) bf16 smem[4 * kTile];
  __shared__ __align__(16) float rs[2][3][kItems];  // m, zi, colsum
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int gq = lane / 4, tq = lane % 4;
  const int lrow = (lane & 7) + ((lane >> 4) << 3);
  const int lcol = ((lane >> 3) & 1) << 3;
  const int lrow_t = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int lcol_t = (lane >> 4) << 3;
  const int b = blockIdx.y;
  const int jw = blockIdx.x * kRows + warp * 16;

  // this warp's rows of k and v, zero past K
  uint32_t ka[NK][4], va[NK][4];
  bf::load_rows<CP, true>(kp, b, jw, CP, K, gq, tq, ka);
  bf::load_rows<CP, true>(vp, b, jw, CP, K, gq, tq, va);
  float dka[NN][4], dva[NN][4];
#pragma unroll
  for (int nn = 0; nn < NN; ++nn) {
#pragma unroll
    for (int r = 0; r < 4; ++r) dka[nn][r] = dva[nn][r] = 0.f;
  }

  const size_t n = static_cast<size_t>(B) * Pp;
  const bf16* qb = qp + static_cast<size_t>(b) * CP * Pp;
  const bf16* gb = gp + static_cast<size_t>(b) * CP * Pp;
  const float* sb = st + static_cast<size_t>(b) * Pp;
  const int tiles = Pp / kItems;
  // anchors a0 .. a0+31 of every class row of q and gv (Pp is a multiple
  // of 64: whole, aligned tiles), and their m, zi and colsum
  auto stage = [&](int tile, int buf) {
    const int a0 = tile * kItems;
    constexpr int kPerRow = kItems / 8;  // 16-byte copies a class row
    for (int e = threadIdx.x; e < 2 * CP * kPerRow; e += kThreads) {
      const int which = e / (CP * kPerRow);
      const int c = (e / kPerRow) % CP;
      const int u = (e % kPerRow) * 8;
      const bf16* src = (which ? gb : qb) + static_cast<size_t>(c) * Pp + a0 +
                        u;
      bf::copy16(smem + (2 * buf + which) * kTile + c * kAnchorStride + u, src,
                 true);
    }
    for (int e = threadIdx.x; e < 3 * (kItems / 4); e += kThreads) {
      const int w = e / (kItems / 4);
      const int u = (e % (kItems / 4)) * 4;
      bf::copy16(&rs[buf][w][u], sb + w * n + a0 + u, true);
    }
  };

  stage(0, 0);
  ct::copy_commit();
#pragma unroll 1
  for (int tile = 0; tile < tiles; ++tile) {
    const int buf = tile % 2;
    ct::copy_wait_all();
    // the tile has landed, and every warp is done with the last one, whose
    // buffers (its statistics are read until the end of its step) the next
    // copies fill
    __syncthreads();
    if (tile + 1 < tiles) stage(tile + 1, buf ^ 1);
    ct::copy_commit();
    const bf16* qt = smem + 2 * buf * kTile;
    const bf16* gt = smem + (2 * buf + 1) * kTile;
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // anchors 16 half .. +15
      float s[2][4] = {}, d[2][4] = {};
      rows_x_anchors<CP>(ka, qt, 16 * half, lrow_t, lcol_t, s);
      rows_x_anchors<CP>(va, gt, 16 * half, lrow_t, lcol_t, d);
      // element r of s[ch]: key row g + 8(r/2), anchor 16half + 8ch + 2t
      // + r%2 of the tile; ds and bf(attn) packed as A operands over these
      // 16 anchors
      uint32_t pds[4], pat[4];
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        float ds[4], at[4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int i = 16 * half + 8 * ch + 2 * tq + u;
          const float mi = rs[buf][0][i];
          const float zi = rs[buf][1][i];
          const float ci = rs[buf][2][i];
#pragma unroll
          for (int row = 0; row < 2; ++row) {
            const int r = 2 * row + u;
            at[r] = weight<kDiv>(s[ch][r], mi, zi);
            const float a = kRound ? bf16_round(at[r]) : at[r];
            ds[r] = __fmul_rn(a, d[ch][r] - ci);
          }
        }
        pds[ch * 2 + 0] = pack(ds[0], ds[1]);  // key row g
        pds[ch * 2 + 1] = pack(ds[2], ds[3]);  // key row g + 8
        pat[ch * 2 + 0] = pack(at[0], at[1]);
        pat[ch * 2 + 1] = pack(at[2], at[3]);
      }
      // dK += ds^T Q and dV += bf(attn)^T GV over these 16 anchors
#pragma unroll
      for (int c0 = 0; c0 < CP; c0 += 16) {
        uint32_t r4[4];
        ldmatrix_x4<false>(r4, qt + (c0 + lrow) * kAnchorStride + 16 * half +
                                   lcol);
        const uint32_t q0[2] = {r4[0], r4[1]};
        const uint32_t q1[2] = {r4[2], r4[3]};
        mma_add(dka[c0 / 8], pds, q0);
        mma_add(dka[c0 / 8 + 1], pds, q1);
        ldmatrix_x4<false>(r4, gt + (c0 + lrow) * kAnchorStride + 16 * half +
                                   lcol);
        const uint32_t g0[2] = {r4[0], r4[1]};
        const uint32_t g1[2] = {r4[2], r4[3]};
        mma_add(dva[c0 / 8], pat, g0);
        mma_add(dva[c0 / 8 + 1], pat, g1);
      }
    }
  }

  // element r of dka[nn]: key row g + 8(r/2), class 8nn + 2t + r%2
  const size_t kv = static_cast<size_t>(b) * K * C;
#pragma unroll
  for (int nn = 0; nn < NN; ++nn) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = jw + gq + (r / 2) * 8;
      const int c = 8 * nn + 2 * tq + r % 2;
      if (j < K && c < C) {
        const size_t o = kv + static_cast<size_t>(j) * C + c;
        dk[o] = dka[nn][r];
        dv[o] = dva[nn][r];
      }
    }
  }
}

int status() { return static_cast<int>(cudaGetLastError()); }

bool bad_shape(int B, int C, int P, int K) {
  return B <= 0 || C <= 0 || C >= 64 || P <= 0 || K <= 0 || B > 65535;
}

// The caller's scratch, as the entry points take it: kvp [2][B][K][CP] and
// qg [2][B][CP][Pp] bf16, st [3][B][Pp] f32.
struct Scratch {
  bf16* kp;
  bf16* vp;
  bf16* qp;
  bf16* gp;
  float* st;
  Scratch(void* kvp, void* qg, void* stats, int B, int CP, int K, int Pp)
      : kp(static_cast<bf16*>(kvp)),
        vp(kp + static_cast<size_t>(B) * K * CP),
        qp(static_cast<bf16*>(qg)),
        gp(qp + static_cast<size_t>(B) * CP * Pp),
        st(static_cast<float*>(stats)) {}
};

int grid_for(long long n, int threads) {
  const long long blocks = (n + threads - 1) / threads;
  return static_cast<int>(blocks < 8192 ? blocks : 8192);
}

// pad k and v, then lay q and gv (and with kFlash the statistics) out
template <bool kRowMajor, bool kFlash>
int prepare(const void* q, const void* k, const void* v, const void* wz,
            const void* g, const void* m, const void* z, const void* colsum,
            const Scratch& sc, int B, int C, int CP, int P, int Pp, int K,
            cudaStream_t st) {
  const long long rows = static_cast<long long>(B) * K;
  bf::pad_kv<<<grid_for(rows * CP, 256), 256, 0, st>>>(
      static_cast<const bf16*>(k), static_cast<const bf16*>(v), sc.kp, sc.vp,
      rows, C, CP);
  int err = status();
  if (err) return err;
  prep_kernel<kRowMajor, kFlash>
      <<<grid_for(static_cast<long long>(B) * Pp, kPrepThreads),
         kPrepThreads, 0, st>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(g),
          static_cast<const float*>(wz), static_cast<const float*>(m),
          static_cast<const float*>(z), static_cast<const float*>(colsum),
          sc.qp, sc.gp, sc.st, B, C, CP, P, Pp);
  return status();
}

template <int CP, bool kRound, bool kDiv, bool kRowMajor>
int grads(const Scratch& sc, void* dq, void* dk, void* dv, int B, int C,
          int P, int Pp, int K, cudaStream_t st) {
  dq_kernel<CP, kRound, kDiv, kRowMajor>
      <<<dim3(Pp / kRows, B), kThreads, 0, st>>>(
          sc.qp, sc.gp, sc.kp, sc.vp, sc.st, dq, B, C, P, Pp, K);
  int err = status();
  if (err) return err;
  dkdv_kernel<CP, kRound, kDiv>
      <<<dim3((K + kRows - 1) / kRows, B), kThreads, 0, st>>>(
          sc.qp, sc.gp, sc.kp, sc.vp, sc.st, static_cast<float*>(dk),
          static_cast<float*>(dv), B, C, Pp, K);
  return status();
}

template <int CP>
int flash(const void* q, const void* k, const void* v, const void* wz,
          const void* g, const void* m, const void* z, const void* colsum,
          void* dq, void* dk, void* dv, const Scratch& sc, int B, int C,
          int P, int Pp, int K, cudaStream_t st) {
  int err = prepare<false, true>(q, k, v, wz, g, m, z, colsum, sc, B, C, CP,
                                 P, Pp, K, st);
  if (err) return err;
  return grads<CP, false, false, false>(sc, dq, dk, dv, B, C, P, Pp, K, st);
}

template <int CP, bool kRowMajor>
int blockwise(const void* q, const void* k, const void* v, const void* wz,
              const void* g, void* dq, void* dk, void* dv, void* dwz,
              const Scratch& sc, void* part, int B, int C, int P, int Pp,
              int K, cudaStream_t st) {
  int err = prepare<kRowMajor, false>(q, k, v, wz, g, nullptr, nullptr,
                                      nullptr, sc, B, C, CP, P, Pp, K, st);
  if (err) return err;
  const int blocks = Pp / kRows;
  stats_kernel<CP, kRowMajor, kRowMajor>
      <<<dim3(blocks, B), kThreads, 0, st>>>(
          sc.qp, sc.gp, sc.kp, sc.vp, static_cast<const bf16*>(g), sc.st,
          static_cast<float*>(part), B, C, P, Pp, K);
  err = status();
  if (err) return err;
  dwz_reduce_kernel<<<C, kReduceThreads, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(dwz), B * blocks,
      C);
  err = status();
  if (err) return err;
  return grads<CP, true, kRowMajor, kRowMajor>(sc, dq, dk, dv, B, C, P, Pp,
                                               K, st);
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers of
// contiguous tensors: q, k, v, g and dq bf16, wz float32, dk, dv (and dwz)
// float32; C < 64. The caller's scratch: kvp [2][B][K][CP] and qg
// [2][B][CP][Pp] bf16 and st [3][B][Pp] float32, CP = 16 for C < 16 else
// 64, Pp = P rounded up to a multiple of 64. `stream` is a cudaStream_t.
// Each launches its kernels on it and returns the first launch error
// (cudaGetLastError), 0 on success.

// Flash backward, class-major q, g, dq [B,C,P], from the saved m, z and
// the caller's colsum [B,1,P] float32 → dq, dk, dv.
extern "C" int ct_attention_cm_bwd_flash_bf16(
    const void* q, const void* k, const void* v, const void* wz,
    const void* g, const void* m, const void* z, const void* colsum,
    void* dq, void* dk, void* dv, void* kvp, void* qg, void* stats, int B,
    int C, int P, int K, void* stream) {
  if (bad_shape(B, C, P, K)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int CP = bf::padded_classes(C);
  const int Pp = padded_anchors(P);
  const Scratch sc(kvp, qg, stats, B, CP, K, Pp);
  if (CP == 16) {
    return flash<16>(q, k, v, wz, g, m, z, colsum, dq, dk, dv, sc, B, C, P,
                     Pp, K, st);
  }
  return flash<64>(q, k, v, wz, g, m, z, colsum, dq, dk, dv, sc, B, C, P, Pp,
                   K, st);
}

template <bool kRowMajor>
static int blockwise_entry(const void* q, const void* k, const void* v,
                           const void* wz, const void* g, void* dq, void* dk,
                           void* dv, void* dwz, void* kvp, void* qg,
                           void* stats, void* part, int B, int C, int P,
                           int K, void* stream) {
  if (bad_shape(B, C, P, K)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int CP = bf::padded_classes(C);
  const int Pp = padded_anchors(P);
  const Scratch sc(kvp, qg, stats, B, CP, K, Pp);
  if (CP == 16) {
    return blockwise<16, kRowMajor>(q, k, v, wz, g, dq, dk, dv, dwz, sc, part,
                                    B, C, P, Pp, K, st);
  }
  return blockwise<64, kRowMajor>(q, k, v, wz, g, dq, dk, dv, dwz, sc, part,
                                  B, C, P, Pp, K, st);
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
