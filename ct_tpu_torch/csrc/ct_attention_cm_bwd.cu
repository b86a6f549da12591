// Context-Transformer attention, backward, float32, for Hopper.
//
// Replaces four Pallas TPU kernels of ct_tpu/ops/ct_attention.py:
//  * `_bwd_kernel_cm_flash` (reached through `_bwd_call_cm_flash`): the
//    flash backward, from the statistics the training forward saved;
//  * `_bwd_kernel_cm` (reached through `_bwd_call_cm`, with
//    CT_ATTENTION_FLASH=0, and `ct_attention_bwd_pallas`): the blockwise
//    backward, from q, k, v, wz and g alone;
//  * `_bwd_kernel` (the row-major blockwise backward of `ct_attention`,
//    reached through `pl.pallas_call` in scripts/bench_ct_bwd.py): the same
//    with q, g and dq row-major.
// For out = base + wz * delta with delta = softmax_K(k^T q) v, per image b,
// anchor p and key j:
//
//   attn   = e^(s - m[p]) / z[p],   s = sum_c k[j,c] q[c,p],  m = max_j s
//   dattn  = sum_c v[j,c] g[c,p] wz[c]
//   colsum = sum_c g[c,p] wz[c] delta[c,p]  (= sum_j attn dattn)
//   ds     = attn * (dattn - colsum)
//   dq[c,p] += ds k[j,c];  dk[j,c] += ds q[c,p];  dv[j,c] += attn g[c,p] wz[c]
//   dwz[c]  = sum_{b,p} g[c,p] delta[c,p]
//
// q, g, dq are class-major [B,C,P] or row-major [B,P,C]; k, v, dk, dv are
// [B,K,C]; wz, dwz are [C]; m, z, colsum are [B,P].
//
// What bounds it on the H100: arithmetic. The flash backward needs
// 10*B*P*K*C flops (scores, dattn, dq, dk, dv), the blockwise one
// 12*B*P*K*C (its stats pass adds the forward's scores and P V); two
// kernels that each recompute the scores and dattn do 14*B*P*K*C. On the
// FP32 pipes (67 TFLOP/s) that is 17 ms at B=64, C=60, P=11,620, K=1,858;
// as three TF32 products on the tensor cores (495 TFLOP/s, the data
// sheet's dense rate) 7 ms, though mma.sync, unlike wgmma, may not reach
// that rate. The bytes (q, g, dq and the small k, v, dk, dv) are a few
// hundred MB, a tenth of that. PERF.md §6 rows 3, 4 and 5 give the times.
//
// Design. No float atomics, so the result does not depend on the order in
// which blocks run, and two launches give the same bits. Every product is
// a warp-wide mma.sync m16n8k8 in 3xTF32 on cp.async-staged tiles, with the
// helpers and the forward's walk of ct_attention_mma.cuh (its note gives
// the split, the fragment layouts and the item order that lets an
// accumulator serve as the next product's A operand).
//  0. (blockwise only) stats: the forward's walk (attend: 64 anchors a
//     block, 16 a warp, keys in tiles of 32, the scores, the online
//     softmax and P V on the tensor cores) recomputes m, z and delta; the
//     epilogue holds g in the accumulator layout and writes m, z, colsum
//     (summed over the lane quad with two shuffles) and the block's partial
//     sums of g*delta per class (a lane's two rows, the 8 row groups of a
//     warp by shuffles, then the four warps in order); dwz_reduce sums the
//     partials of every block in a fixed order, one block per class.
//  1. dq: a block owns 64 anchors of one image, 16 per warp, and walks the
//     keys in tiles of 32. Per group of 8-key chunks a warp computes the
//     score tile S = Q K^T and dP = (G wz) V^T [16 x 8 each], then attn and
//     ds elementwise from its rows' m, 1/z and colsum, then dQ += ds K.
//  2. dk, dv: a block owns 64 keys, 16 per warp, and walks the anchors in
//     tiles of 32: S^T = K Q^T and dP^T = (V wz) G^T, then dK += ds^T Q and
//     dV += attn^T G (scaled by wz once, at the end).
// The operand rows a warp owns (q and g*wz in dq, k and v*wz in dk/dv) and
// its accumulators stay in registers; at CP=64 the rows stay in float32
// and are split where they are used (pinned there, so that the compiler
// does not hoist 128 registers of splits out of the loop), at CP=16 they
// are split once. The tiles of the other side are staged double-buffered:
// class-major per-class rows of 32 anchors in 16-byte copies where P and
// the base are 16-byte aligned, else 4-byte copies (row-major rows and k/v
// at C=15 are 60 bytes; P=1001 gives unaligned class rows), zero-filled
// past P, K and C. dk/dv reads the tile's m, z and colsum from their
// staging buffer until the end of its step, so it issues the next tile's
// copies only after the barrier that follows the step (dq, whose staged
// tiles are read only before its second barrier, issues them before
// waiting for the current tile). The long sums (dq over the keys, dk and
// dv over the anchors) take each step's product from a fresh accumulator
// and add it with a rounded f32 add (mma3_add).
// What the card showed (PERF.md): with cvt.rna the splits were more
// than half of the loop's instructions; neither a third block per SM nor
// separate accumulators for the small terms moved the time.
// Ragged P and K are masked after the exponential, as the JAX kernel masks
// them: a padded anchor's or key's attn is 0, and it is never stored.
// Padded classes are zero. The scores are those of the forward's walk, bit
// for bit (the same routine in dq's class-step order; dk/dv, with k as the
// A operand, sums them in another order, within f32 rounding); the
// exponential is __expf (ex2.approx of s*log2 e), within a few ulp of expf.

#include "ct_attention_mma.cuh"

namespace {

using namespace ct;

template <int CP, bool kRowMajor>
__global__ void __launch_bounds__(kThreads, 2)
bwd_stats_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ wz,
                 const float* __restrict__ g, float* __restrict__ m_out,
                 float* __restrict__ z_out, float* __restrict__ colsum_out,
                 float* __restrict__ dwz_part, int C, int P, int K) {
  __shared__ __align__(16) float smem[kWalkFloats<CP>];
  constexpr int NK = CP / 8;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int gq = lane / 4, tq = lane % 4;
  const int b = blockIdx.y;
  const int pw = blockIdx.x * kRows + warp * 16;

  RowsA<NK, true> qa;
  qa.template load<kRowMajor>(q, nullptr, b, pw, C, P, gq, tq);
  float o[NK][4], m[2], l[2];
  attend<CP, false>(qa, k, v, b, C, K, smem, o, m, l);

  // g * delta in the accumulator layout (row g + 8(r/2), class 8nn + 2t +
  // r%2): colsum per row, and per class this lane's two rows; a row past P
  // or a class past C holds g = 0, so it adds nothing
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
  float cs[2] = {0.f, 0.f};
  float col[NK][2];
#pragma unroll
  for (int nn = 0; nn < NK; ++nn) {
    col[nn][0] = col[nn][1] = 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = pw + gq + (r / 2) * 8;
      const int c = 8 * nn + 2 * tq + r % 2;
      const bool ok = p < P && c < C;
      const size_t at = kRowMajor
                            ? (static_cast<size_t>(b) * P + p) * C + c
                            : (static_cast<size_t>(b) * C + c) * P + p;
      const float gd = ok ? g[at] * (o[nn][r] * inv[r / 2]) : 0.f;
      if (ok) cs[r / 2] = fmaf(gd, wz[c], cs[r / 2]);
      col[nn][r % 2] += gd;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    cs[h] += __shfl_xor_sync(0xffffffffu, cs[h], 1);
    cs[h] += __shfl_xor_sync(0xffffffffu, cs[h], 2);
    const int p = pw + gq + h * 8;
    if (tq == 0 && p < P) {
      const size_t at = static_cast<size_t>(b) * P + p;
      m_out[at] = m[h];
      z_out[at] = l[h];
      colsum_out[at] = cs[h];
    }
  }

  // this block's sum of g * delta over its anchors, per class: the 8 row
  // groups of a warp, then the four warps in order
  float* red = smem;  // [kWarps][CP]
  __syncthreads();    // the key tiles are no longer read
#pragma unroll
  for (int nn = 0; nn < NK; ++nn) {
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
    dwz_part[(static_cast<size_t>(b) * gridDim.x + blockIdx.x) * C +
             threadIdx.x] = s;
  }
}

template <int CP, bool kRowMajor>
__global__ void __launch_bounds__(kThreads, 2)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ wz,
              const float* __restrict__ g, const float* __restrict__ m,
              const float* __restrict__ z, const float* __restrict__ colsum,
              float* __restrict__ dq, int C, int P, int K) {
  static_assert(CP % 8 == 0 && kThreads % 32 == 0, "tile shapes");
  constexpr int NK = CP / 8;
  constexpr int NCH = kChunks<CP>;
  constexpr int kTile = CP * kItems;
  extern __shared__ __align__(16) float smem[];
  // staged k, v tiles of buffer buf: smem + (2 buf + 0 or 1) kTile; their
  // hi and lo tiles after them
  uint32_t* khi = reinterpret_cast<uint32_t*>(smem + 4 * kTile);
  uint32_t* klo = khi + kTile;
  uint32_t* vhi = klo + kTile;
  uint32_t* vlo = vhi + kTile;

  const int lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kRows + (threadIdx.x / 32) * 16;

  // this warp's rows of q and g*wz, zero past P and C
  RowsA<NK, (CP <= 16)> qa, ga;
  qa.template load<kRowMajor>(q, nullptr, b, p0, C, P, gq, tq);
  ga.template load<kRowMajor>(g, wz, b, p0, C, P, gq, tq);
  // rows g and g+8: m, 1/z, colsum; 0 past P, so that attn is 0
  float mr[2], izr[2], csr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = p0 + gq + h * 8;
    const size_t o = static_cast<size_t>(b) * P + p;
    mr[h] = p < P ? m[o] : 0.f;
    izr[h] = p < P ? 1.f / z[o] : 0.f;
    csr[h] = p < P ? colsum[o] : 0.f;
  }
  float acc[NK][4];
#pragma unroll
  for (int nn = 0; nn < NK; ++nn) {
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nn][r] = 0.f;
  }

  const float* kb = k + static_cast<size_t>(b) * K * C;
  const float* vb = v + static_cast<size_t>(b) * K * C;
  const int tiles = (K + kItems - 1) / kItems;
  auto stage = [&](int tile, int buf) {
    const int j0 = tile * kItems;
    const int n = min(kItems, K - j0);
    stage_rows<CP>(smem + 2 * buf * kTile, kb + static_cast<size_t>(j0) * C,
                   n, C);
    stage_rows<CP>(smem + (2 * buf + 1) * kTile,
                   vb + static_cast<size_t>(j0) * C, n, C);
  };

  stage(0, 0);
  copy_commit();
  for (int tile = 0; tile < tiles; ++tile) {
    const int buf = tile % 2;
    if (tile + 1 < tiles) stage(tile + 1, buf ^ 1);
    copy_commit();
    copy_wait_all_but_one();
    __syncthreads();  // the tile has landed; the last one is read
    split_tile<CP>(smem + 2 * buf * kTile, khi, klo);
    split_tile<CP>(smem + (2 * buf + 1) * kTile, vhi, vlo);
    __syncthreads();
    const int j0 = tile * kItems;
#pragma unroll 1  // unrolled, the two halves of a tile spill at CP=64
    for (int n0 = 0; n0 < kItems; n0 += 8 * NCH) {
      float s[NCH][4], d[NCH][4];
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) {
#pragma unroll
        for (int r = 0; r < 4; ++r) s[ch][r] = d[ch][r] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        uint32_t qh[4], ql[4], gh[4], gl[4];
        qa.at(kk, qh, ql);
        ga.at(kk, gh, gl);
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
          uint32_t bh[2], bl[2];
          load_kn(khi, klo, kk, n0 + 8 * ch, gq, tq, bh, bl);
          mma3(s[ch], qh, ql, bh, bl);
          load_kn(vhi, vlo, kk, n0 + 8 * ch, gq, tq, bh, bl);
          mma3(d[ch], gh, gl, bh, bl);
        }
      }
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) {
        // element r: anchor row g + 8(r/2), key t + 4(r%2) of the chunk
        float ds[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int h = r / 2;
          const bool live = j0 + n0 + 8 * ch + tq + 4 * (r % 2) < K;
          const float attn = live ? __expf(s[ch][r] - mr[h]) * izr[h] : 0.f;
          ds[r] = attn * (d[ch][r] - csr[h]);
        }
        // the A operand of dQ += ds K, k = the chunk's keys t, t+4
        const float a[4] = {ds[0], ds[2], ds[1], ds[3]};
        uint32_t ah[4], al[4];
        split<4>(a, ah, al);
#pragma unroll
        for (int nn = 0; nn < NK; ++nn) {
          uint32_t bh[2], bl[2];
          load_nk(khi, klo, n0 + 8 * ch, nn, gq, tq, bh, bl);
          mma3_add(acc[nn], ah, al, bh, bl);
        }
      }
    }
  }

  // element r of acc[nn]: anchor row g + 8(r/2), class 8nn + 2t + r%2
#pragma unroll
  for (int nn = 0; nn < NK; ++nn) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = p0 + gq + (r / 2) * 8;
      const int c = 8 * nn + 2 * tq + r % 2;
      if (p < P && c < C) {
        const size_t o = kRowMajor
                             ? (static_cast<size_t>(b) * P + p) * C + c
                             : (static_cast<size_t>(b) * C + c) * P + p;
        dq[o] = acc[nn][r];
      }
    }
  }
}

template <int CP, bool kRowMajor>
__global__ void __launch_bounds__(kThreads, 2)
bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ wz,
                const float* __restrict__ g, const float* __restrict__ m,
                const float* __restrict__ z,
                const float* __restrict__ colsum, float* __restrict__ dk,
                float* __restrict__ dv, int C, int P, int K, bool vec) {
  static_assert(CP % 8 == 0 && kThreads % 32 == 0, "tile shapes");
  constexpr int NK = CP / 8;
  constexpr int NCH = kChunks<CP>;
  constexpr int kTile = CP * kItems;
  extern __shared__ __align__(16) float smem[];
  // staged q, g tiles of buffer buf: smem + (2 buf + 0 or 1) kTile; their
  // hi and lo tiles after them
  uint32_t* qhi = reinterpret_cast<uint32_t*>(smem + 4 * kTile);
  uint32_t* qlo = qhi + kTile;
  uint32_t* ghi = qlo + kTile;
  uint32_t* glo = ghi + kTile;
  __shared__ __align__(16) float rs[2][3][kItems];  // m, z, colsum

  const int lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int b = blockIdx.y;
  const int j0 = blockIdx.x * kRows + (threadIdx.x / 32) * 16;
  const size_t kv = static_cast<size_t>(b) * K * C;

  // this warp's rows of k and v*wz, zero past K and C (loaded together:
  // two loads of RowsA::load each leave dk/dv at CP=64 spilling)
  RowsA<NK, (CP <= 16)> ka, va;
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = j0 + gq + (r % 2) * 8;
      const int c = 8 * kk + tq + (r / 2) * 4;
      const bool ok = j < K && c < C;
      const size_t o = kv + static_cast<size_t>(j) * C + c;
      ka.x[kk][r] = ok ? k[o] : 0.f;
      va.x[kk][r] = ok ? v[o] * wz[c] : 0.f;
    }
  }
  ka.prepare();
  va.prepare();
  float dka[NK][4], dva[NK][4];
#pragma unroll
  for (int nn = 0; nn < NK; ++nn) {
#pragma unroll
    for (int r = 0; r < 4; ++r) dka[nn][r] = dva[nn][r] = 0.f;
  }

  const float* qb = q + static_cast<size_t>(b) * C * P;
  const float* gb = g + static_cast<size_t>(b) * C * P;
  const int tiles = (P + kItems - 1) / kItems;
  auto stage = [&](int tile, int buf) {
    const int a0 = tile * kItems;
    const int n = min(kItems, P - a0);
    float* qt = smem + 2 * buf * kTile;
    float* gt = smem + (2 * buf + 1) * kTile;
    if (kRowMajor) {
      stage_rows<CP>(qt, qb + static_cast<size_t>(a0) * C, n, C);
      stage_rows<CP>(gt, gb + static_cast<size_t>(a0) * C, n, C);
    } else {
      stage_cols<CP>(qt, qb + a0, n, C, P, vec);
      stage_cols<CP>(gt, gb + a0, n, C, P, vec);
    }
    for (int e = threadIdx.x; e < 3 * kItems; e += kThreads) {
      const int w = e / kItems;
      const int i = e % kItems;
      const float* src = (w == 0 ? m : w == 1 ? z : colsum) +
                         static_cast<size_t>(b) * P + a0;
      copy4(&rs[buf][w][i], i < n ? src + i : src, i < n);
    }
  };

  stage(0, 0);
  copy_commit();
  for (int tile = 0; tile < tiles; ++tile) {
    const int buf = tile % 2;
    copy_wait_all();
    // the tile has landed, and every warp is done with the last one, whose
    // buffers (m, z and colsum are read until the end of its step) the
    // next copy fills
    __syncthreads();
    if (tile + 1 < tiles) stage(tile + 1, buf ^ 1);
    copy_commit();
    split_tile<CP>(smem + 2 * buf * kTile, qhi, qlo);
    split_tile<CP>(smem + (2 * buf + 1) * kTile, ghi, glo);
    __syncthreads();
    const int a0 = tile * kItems;
#pragma unroll 1  // unrolled, the two halves of a tile spill at CP=64
    for (int n0 = 0; n0 < kItems; n0 += 8 * NCH) {
      float s[NCH][4], d[NCH][4];
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) {
#pragma unroll
        for (int r = 0; r < 4; ++r) s[ch][r] = d[ch][r] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        uint32_t kh[4], kl[4], vh[4], vl[4];
        ka.at(kk, kh, kl);
        va.at(kk, vh, vl);
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
          uint32_t bh[2], bl[2];
          load_kn(qhi, qlo, kk, n0 + 8 * ch, gq, tq, bh, bl);
          mma3(s[ch], kh, kl, bh, bl);
          load_kn(ghi, glo, kk, n0 + 8 * ch, gq, tq, bh, bl);
          mma3(d[ch], vh, vl, bh, bl);
        }
      }
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) {
        // element r: key row g + 8(r/2), anchor t + 4(r%2) of the chunk
        float at[4], ds[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = n0 + 8 * ch + tq + 4 * h;
          const bool live = a0 + i < P;
          const float mi = rs[buf][0][i];
          const float izi = live ? __frcp_rn(rs[buf][1][i]) : 0.f;
          const float csi = rs[buf][2][i];
#pragma unroll
          for (int row = 0; row < 2; ++row) {
            const int r = 2 * row + h;
            at[r] = live ? __expf(s[ch][r] - mi) * izi : 0.f;
            ds[r] = at[r] * (d[ch][r] - csi);
          }
        }
        // the A operands of dK += ds^T Q and dV += attn^T G, k = anchors
        const float a_ds[4] = {ds[0], ds[2], ds[1], ds[3]};
        const float a_at[4] = {at[0], at[2], at[1], at[3]};
        uint32_t dh[4], dl[4], ah[4], al[4];
        split<4>(a_ds, dh, dl);
        split<4>(a_at, ah, al);
#pragma unroll
        for (int nn = 0; nn < NK; ++nn) {
          uint32_t bh[2], bl[2];
          load_nk(qhi, qlo, n0 + 8 * ch, nn, gq, tq, bh, bl);
          mma3_add(dka[nn], dh, dl, bh, bl);
          load_nk(ghi, glo, n0 + 8 * ch, nn, gq, tq, bh, bl);
          mma3_add(dva[nn], ah, al, bh, bl);
        }
      }
    }
  }

  // element r of dka[nn]: key row g + 8(r/2), class 8nn + 2t + r%2
#pragma unroll
  for (int nn = 0; nn < NK; ++nn) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = j0 + gq + (r / 2) * 8;
      const int c = 8 * nn + 2 * tq + r % 2;
      if (j < K && c < C) {
        const size_t o = kv + static_cast<size_t>(j) * C + c;
        dk[o] = dka[nn][r];
        dv[o] = dva[nn][r] * wz[c];
      }
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int CP, bool kRowMajor>
int launch_grads(const float* q, const float* k, const float* v,
                 const float* wz, const float* g, const float* m,
                 const float* z, const float* colsum, float* dq, float* dk,
                 float* dv, int B, int C, int P, int K, cudaStream_t st) {
  constexpr size_t bytes = kTileBytes<CP>;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dq_kernel<CP, kRowMajor>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dq_kernel<CP, kRowMajor>
      <<<dim3((P + kRows - 1) / kRows, B), kThreads, bytes, st>>>(
          q, k, v, wz, g, m, z, colsum, dq, C, P, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(bwd_dkdv_kernel<CP, kRowMajor>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = !kRowMajor && P % 4 == 0 && aligned16(q) && aligned16(g);
  bwd_dkdv_kernel<CP, kRowMajor>
      <<<dim3((K + kRows - 1) / kRows, B), kThreads, bytes, st>>>(
          q, k, v, wz, g, m, z, colsum, dk, dv, C, P, K, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int CP, bool kRowMajor>
int launch_blockwise(const float* q, const float* k, const float* v,
                     const float* wz, const float* g, float* dq, float* dk,
                     float* dv, float* dwz, float* m, float* z, float* colsum,
                     float* part, int B, int C, int P, int K,
                     cudaStream_t st) {
  const int tiles = (P + kRows - 1) / kRows;
  bwd_stats_kernel<CP, kRowMajor><<<dim3(tiles, B), kThreads, 0, st>>>(
      q, k, v, wz, g, m, z, colsum, part, C, P, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dwz_reduce_kernel<<<C, kReduceThreads, 0, st>>>(part, dwz, B * tiles, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_grads<CP, kRowMajor>(q, k, v, wz, g, m, z, colsum, dq, dk, dv,
                                     B, C, P, K, st);
}

bool bad_shape(int B, int C, int P, int K) {
  return B <= 0 || C <= 0 || C > 64 || P <= 0 || K <= 0 || B > 65535;
}

const float* ro(const void* p) { return static_cast<const float*>(p); }
float* rw(void* p) { return static_cast<float*>(p); }

template <bool kRowMajor>
int blockwise(const void* q, const void* k, const void* v, const void* wz,
              const void* g, void* dq, void* dk, void* dv, void* dwz,
              void* m, void* z, void* colsum, void* part, int B, int C,
              int P, int K, void* stream) {
  if (bad_shape(B, C, P, K)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C <= 16) {
    return launch_blockwise<16, kRowMajor>(
        ro(q), ro(k), ro(v), ro(wz), ro(g), rw(dq), rw(dk), rw(dv), rw(dwz),
        rw(m), rw(z), rw(colsum), rw(part), B, C, P, K, st);
  }
  return launch_blockwise<64, kRowMajor>(
      ro(q), ro(k), ro(v), ro(wz), ro(g), rw(dq), rw(dk), rw(dv), rw(dwz),
      rw(m), rw(z), rw(colsum), rw(part), B, C, P, K, st);
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers of
// contiguous float32 tensors; `stream` is a cudaStream_t. Each launches its
// kernels on it and returns the first launch error (cudaGetLastError), 0 on
// success.

// Flash backward, class-major, from the saved m, z [B,1,P] and the
// caller's colsum [B,1,P] → dq, dk, dv.
extern "C" int ct_attention_cm_bwd_flash_f32(
    const void* q, const void* k, const void* v, const void* wz,
    const void* g, const void* m, const void* z, const void* colsum,
    void* dq, void* dk, void* dv, int B, int C, int P, int K, void* stream) {
  if (bad_shape(B, C, P, K)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C <= 16) {
    return launch_grads<16, false>(ro(q), ro(k), ro(v), ro(wz), ro(g), ro(m),
                                   ro(z), ro(colsum), rw(dq), rw(dk), rw(dv),
                                   B, C, P, K, st);
  }
  return launch_grads<64, false>(ro(q), ro(k), ro(v), ro(wz), ro(g), ro(m),
                                 ro(z), ro(colsum), rw(dq), rw(dk), rw(dv), B,
                                 C, P, K, st);
}

// Blockwise backward, class-major q, g, dq [B,C,P] → dq, dk, dv, dwz. The
// caller's scratch: m, z, colsum [B,P] and part [B, ceil(P/64), C].
extern "C" int ct_attention_cm_bwd_f32(
    const void* q, const void* k, const void* v, const void* wz,
    const void* g, void* dq, void* dk, void* dv, void* dwz, void* m, void* z,
    void* colsum, void* part, int B, int C, int P, int K, void* stream) {
  return blockwise<false>(q, k, v, wz, g, dq, dk, dv, dwz, m, z, colsum, part,
                          B, C, P, K, stream);
}

// Blockwise backward, row-major q, g, dq [B,P,C]; otherwise as above.
extern "C" int ct_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* wz,
    const void* g, void* dq, void* dk, void* dv, void* dwz, void* m, void* z,
    void* colsum, void* part, int B, int C, int P, int K, void* stream) {
  return blockwise<true>(q, k, v, wz, g, dq, dk, dv, dwz, m, z, colsum, part,
                         B, C, P, K, stream);
}
