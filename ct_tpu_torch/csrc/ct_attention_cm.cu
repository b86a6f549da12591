// Context-Transformer attention, forwards, float32 and bfloat16, for Hopper.
//
// Replaces four Pallas TPU kernels of ct_tpu/ops/ct_attention.py and
// scripts/bench_ct_attention.py: `_kernel_cm` (the class-major eval forward,
// reached through `ct_attention_cm`), `_kernel_cm_stats` (the class-major
// training forward, reached through `ct_attention_cm_stats`), `_kernel` (the
// row-major forward, reached through `ct_attention`) and the bench's
// `make_variant` kernel (the row-major forward with its exponential in
// bfloat16). For image b and anchor p:
//
//   s[j]     = sum_c k[b,j,c] * q[b,p,c]
//   out[b,p] = base[b,p] + wz * sum_j e^(s[j]-max s) v[b,j,:]
//                               / sum_j e^(s[j]-max s)
//
// q, base, out are class-major [B,C,P] (anchors contiguous) or row-major
// [B,P,C]; k, v are [B,K,C]; wz is [C]. The class-major training forward
// also writes what the flash backward needs: delta[b,c,p] (the attention
// output before wz), m[b,p] = max s and z[b,p] = sum_j e^(s[j]-m), f32. The
// online softmax ends holding exactly its final max and denominator, so
// these cost three stores.
//
// What bounds it on the H100: arithmetic. Per (anchor, key) the function
// needs C multiply-adds for the score, C for the weighted value sum and one
// exponential, 4*B*P*K*C flops in all, while it moves only q, base and out
// once each plus k and v (K*C floats per image, which stay in L2). Its two
// products run on the tensor cores in 3xTF32 (ct_attention_mma.cuh), three
// TF32 products each: 12*B*P*K*C tensor flops over 495 TFLOP/s, or
// 4*B*P*K*C over the FP32 pipes' 67. The bfloat16 variant's weights are
// exact in TF32, so its P V takes two products: 3*2 + 2*2 = 10*B*P*K*C
// tensor flops. It walks the keys twice (the max first, then the weights),
// so it computes the scores again: 6*B*P*K*C more tensor flops, a cost of
// this design and not of the function, which the bounds leave out.
// PERF.md §6 rows 1, 2, 5 (forward) and 10 give the times against both
// bounds.
//
// Design: a block owns 64 anchors of one image, 16 a warp, and walks the
// keys in tiles of 32 (attend, ct_attention_mma.cuh): per group of 8-key
// chunks each warp computes S = Q K^T [16 x 8 a chunk] on the tensor cores
// from its anchors' q fragments and the staged k tile, in the dq kernel's
// order, takes the online softmax on the accumulator fragments, and feeds
// the weights straight back as the A operand of O += P V. Only the [64, C]
// rows of q and out and the key tiles ever exist; the [K,P] affinity never
// does. The epilogue stages delta = O / z in shared memory, so that the
// block's loads of base and stores of out (and delta) run along the
// anchors (class-major) or along the rows' contiguous span (row-major).
// Ragged P (rows past P compute on zeros and store nothing), ragged K
// (the last tile is zero-filled and its dead keys masked) and padded
// classes (zero, never stored) are handled in the walk.
//
// bfloat16 (ct_attention_cm_bf16, ct_attention_cm_stats_bf16,
// ct_attention_bf16, ct_attention_variant_bf16 and
// ct_attention_variant_unfused_bf16): the same function on bf16 q, k, v
// and base, f32 wz, bf16 out, with the JAX kernels' rounding points:
//   s[j] = sum_c k[j,c] q[c]            bf16 operands, f32 sums
//   e[j] = bf16(exp(s[j] - max_j s))    against the row's final max
//   num  = sum_j e[j] v[j,:], den = sum_j e[j]   f32 sums of exact bf16
//                                       products, den from a ones column
// on warpgroup wgmma tiles (ct_attention_wgmma.cuh). Its bound is its
// B*P*K exponentials on the special-function units at C=15 and its
// products at C=60 (PERF.md §6). Design:
//  * prep_kv (shared with the bf16 backward and the serving head) lays k
//    and v out as 64-key tiles in the swizzled layout, zero past C and K,
//    v's column C one;
//  * one warpgroup (128 threads) owns 64 anchors of one image and stages
//    their q rows once as a tile of the same layout (read along the
//    anchors, or the rows' contiguous classes, while the first keys land).
//    q as A fragments held in registers, read once, gave wrong sums on the
//    card at CP=64 for every tile after the first of walk 2 (reloaded
//    before each tile's scores, they did not); the tile costs 8 KB of
//    shared memory and frees 16 registers;
//  * the two walks over 64-key tiles staged by cp.async.bulk, two stages
//    (wg::walk, shared with the serving head): walk 1 the row max of the
//    scores, walk 2 the scores again, the weights rounded to bf16 by the
//    conversion unit (one cvt a pair; on the integer pipe the kernel took
//    12-24% longer) and O += P V, a fresh accumulator a tile added with
//    rounded f32 adds (the tensor cores truncate their accumulator;
//    ct_attention_mma.cuh). The unfused variant (kSumF32) sums the
//    unrounded f32 weights in registers beside the product and divides by
//    that sum instead.
// The epilogue divides by the denominator, out = bf16(base + wz * num /
// den), rounded to nearest even; the training forward (`_kernel_cm_stats`
// on bf16) also stores delta = num / den rounded to bf16, as JAX saves it
// in base's type, and m (natural units) and z = den in f32, for the bf16
// flash backward (ct_attention_bwd_bf16.cu).

#include "ct_attention_mma.cuh"
#include "ct_attention_wgmma.cuh"

namespace {

using namespace ct;

// shared-memory stride of a class in the class-major epilogue's stage:
// 2t*68 + g hits 32 distinct banks for a warp's fragment writes
constexpr int kStageStride = kRows + 4;

// Two blocks an SM (up to 255 registers: the f32 walk takes about 210 at
// CP=64 and spills within 168), three for the bf16 variant, which fits in
// 168 without spilling and runs 11% faster so on an H100 (PERF.md §6).
template <int CP, bool kStats, bool kRowMajor, bool kExpBf16>
__global__ void __launch_bounds__(kThreads, kExpBf16 ? 3 : 2)
ct_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ base,
                    const float* __restrict__ wz, float* __restrict__ out,
                    float* __restrict__ delta, float* __restrict__ m_out,
                    float* __restrict__ z_out, int C, int P, int K) {
  static_assert(!(kStats && kRowMajor), "statistics are class-major only");
  static_assert(CP * kStageStride <= kWalkFloats<CP> &&
                    kRows * (CP + 1) <= kWalkFloats<CP>,
                "the epilogue's stage fits in the walk's shared memory");
  __shared__ __align__(16) float smem[kWalkFloats<CP>];
  constexpr int NK = CP / 8;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int gq = lane / 4, tq = lane % 4;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kRows;

  RowsA<NK, true> qa;
  qa.template load<kRowMajor>(q, nullptr, b, p0 + warp * 16, C, P, gq, tq);
  float o[NK][4], m[2], l[2];
  attend<CP, kExpBf16>(qa, k, v, b, C, K, smem, o, m, l);

  // rows g and g+8 of this warp: delta = O / z into the stage
  __syncthreads();  // the key tiles are no longer read
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
  for (int nn = 0; nn < NK; ++nn) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = warp * 16 + gq + (r / 2) * 8;
      const int c = 8 * nn + 2 * tq + r % 2;
      const float d = o[nn][r] * inv[r / 2];
      if (kRowMajor) {
        smem[row * (CP + 1) + c] = d;
      } else {
        smem[c * kStageStride + row] = d;
      }
    }
  }
  if (kStats && tq == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + warp * 16 + gq + h * 8;
      if (p < P) {
        const size_t at = static_cast<size_t>(b) * P + p;
        m_out[at] = m[h];
        z_out[at] = l[h];
      }
    }
  }
  __syncthreads();
  const int rows = min(kRows, P - p0);
  if (kRowMajor) {
    const size_t first = (static_cast<size_t>(b) * P + p0) * C;
    for (int e = threadIdx.x; e < rows * C; e += kThreads) {
      const int c = e % C;
      const float d = smem[(e / C) * (CP + 1) + c];
      out[first + e] = base[first + e] + wz[c] * d;
    }
  } else {
    for (int e = threadIdx.x; e < C * kRows; e += kThreads) {
      const int c = e / kRows;
      const int i = e % kRows;
      if (i < rows) {
        const size_t at = (static_cast<size_t>(b) * C + c) * P + p0 + i;
        const float d = smem[c * kStageStride + i];
        out[at] = base[at] + wz[c] * d;
        if (kStats) delta[at] = d;
      }
    }
  }
}

template <int CP, bool kStats, bool kRowMajor, bool kExpBf16>
int launch_cp(const float* q, const float* k, const float* v,
              const float* base, const float* wz, float* out, float* delta,
              float* m, float* z, int B, int C, int P, int K,
              cudaStream_t st) {
  ct_attention_kernel<CP, kStats, kRowMajor, kExpBf16>
      <<<dim3((P + kRows - 1) / kRows, B), kThreads, 0, st>>>(
          q, k, v, base, wz, out, delta, m, z, C, P, K);
  return static_cast<int>(cudaGetLastError());
}

template <bool kStats, bool kRowMajor, bool kExpBf16>
int launch(const void* q, const void* k, const void* v, const void* base,
           const void* wz, void* out, void* delta, void* m, void* z, int B,
           int C, int P, int K, void* stream) {
  if (B <= 0 || C <= 0 || C > 64 || P <= 0 || K <= 0 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* bf = static_cast<const float*>(base);
  const float* wf = static_cast<const float*>(wz);
  float* of = static_cast<float*>(out);
  float* df = static_cast<float*>(delta);
  float* mf = static_cast<float*>(m);
  float* zf = static_cast<float*>(z);
  if (C <= 16) {
    return launch_cp<16, kStats, kRowMajor, kExpBf16>(
        qf, kf, vf, bf, wf, of, df, mf, zf, B, C, P, K, st);
  }
  return launch_cp<64, kStats, kRowMajor, kExpBf16>(
      qf, kf, vf, bf, wf, of, df, mf, zf, B, C, P, K, st);
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers of
// contiguous float32 tensors; `stream` is a cudaStream_t. Each returns the
// launch status (cudaGetLastError), 0 on success.

// Class-major eval forward: out only.
extern "C" int ct_attention_cm_f32(const void* q, const void* k,
                                   const void* v, const void* base,
                                   const void* wz, void* out, int B, int C,
                                   int P, int K, void* stream) {
  return launch<false, false, false>(q, k, v, base, wz, out, nullptr, nullptr,
                                     nullptr, B, C, P, K, stream);
}

// Class-major training forward: out and delta [B,C,P], m and z [B,1,P].
extern "C" int ct_attention_cm_stats_f32(const void* q, const void* k,
                                         const void* v, const void* base,
                                         const void* wz, void* out,
                                         void* delta, void* m, void* z,
                                         int B, int C, int P, int K,
                                         void* stream) {
  return launch<true, false, false>(q, k, v, base, wz, out, delta, m, z, B, C,
                                    P, K, stream);
}

// Row-major forward: q, base, out [B,P,C].
extern "C" int ct_attention_f32(const void* q, const void* k, const void* v,
                                const void* base, const void* wz, void* out,
                                int B, int C, int P, int K, void* stream) {
  return launch<false, true, false>(q, k, v, base, wz, out, nullptr, nullptr,
                                    nullptr, B, C, P, K, stream);
}

// Row-major forward with the exponential rounded as a bfloat16 one: the
// attention bench's variant (its float32 variant is ct_attention_f32).
extern "C" int ct_attention_variant_f32(const void* q, const void* k,
                                        const void* v, const void* base,
                                        const void* wz, void* out, int B,
                                        int C, int P, int K, void* stream) {
  return launch<false, true, true>(q, k, v, base, wz, out, nullptr, nullptr,
                                   nullptr, B, C, P, K, stream);
}

// --- bfloat16 -------------------------------------------------------------

namespace {

using bf16 = __nv_bfloat16;
using wg::kTile;

// Blocks an SM that the launch bounds ask registers for (up to 168 a
// thread at three, 102 at five): at CP=64 a thread holds a tile's scores
// (32 f32) and the running and the tile's fresh P V (32 each). ptxas on
// an H100 gave the CP=64 forwards 88-91 registers at three (five blocks
// an SM fit them and the 41 KB of shared memory) but the unfused variant
// 126, four blocks an SM; held to five it takes 94 without a spill and
// runs 10% faster (PERF.md §6). CP=16: 62-82.
template <int CP, bool kSumF32>
constexpr int kFwdBlocks = CP <= 16 ? 4 : kSumF32 ? 5 : 3;

// One warpgroup, 64 anchors of image b. kp and vp: the keys and values in
// the tile layout, Kp keys (whole tiles), vp's column C the ones.
template <int CP, bool kRowMajor, bool kExpBf16, bool kStats, bool kSumF32>
__global__ void __launch_bounds__(wg::kThreads, kFwdBlocks<CP, kSumF32>)
ct_attention_bf16_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ kp,
                         const bf16* __restrict__ vp,
                         const bf16* __restrict__ base,
                         const float* __restrict__ wz,
                         bf16* __restrict__ out, bf16* __restrict__ delta,
                         float* __restrict__ m_out, float* __restrict__ z_out,
                         int C, int P, int K, int Kp) {
  static_assert(!(kStats && kRowMajor), "statistics are class-major only");
  static_assert(!kSumF32 || kRowMajor, "the unfused variant is row-major");
  constexpr int TB = wg::kTileBytes<CP>;
  static_assert(CP * kStageStride * 4 <= TB + wg::KeyTiles<CP>::kBytes &&
                    kTile * (CP + 1) * 4 <= TB + wg::KeyTiles<CP>::kBytes,
                "the epilogue's stage fits in the tiles' bytes");
  extern __shared__ uint8_t dyn[];
  __shared__ __align__(8) uint64_t bar[wg::KeyTiles<CP>::kStages];
  uint8_t* tiles_s = wg::align_1024(dyn);
  bf16* sq = reinterpret_cast<bf16*>(tiles_s);
  const int tid = threadIdx.x;
  const int w = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kTile;
  const wg::KeyTiles<CP> ks{tiles_s + TB, bar,
                            kp + static_cast<size_t>(b) * Kp * CP,
                            vp + static_cast<size_t>(b) * Kp * CP,
                            Kp / kTile};
  ks.start();

  // the block's q rows into the q tile while the first keys land: read
  // along the anchors (class-major) or the rows' contiguous classes, zero
  // past P and C
  for (int e = tid; e < kTile * CP; e += wg::kThreads) {
    const int c = kRowMajor ? e % CP : e / kTile;
    const int i = kRowMajor ? e / CP : e % kTile;
    const int p = p0 + i;
    bf16 x = __float2bfloat16_rn(0.f);
    if (p < P && c < C) {
      x = q[kRowMajor ? (static_cast<size_t>(b) * P + p) * C + c
                      : (static_cast<size_t>(b) * C + c) * P + p];
    }
    sq[wg::at<CP>(i, c)] = x;
  }
  wg::fence_proxy_async();
  __syncthreads();

  float mx[2], lsum[2], o[CP / 2];
  wg::walk<CP, kExpBf16, kSumF32>(ks, wg::desc<CP>(sq), K, mx, lsum, o);

  // the numerators and (column C) the denominator into the stage, which
  // the tiles' bytes hold (no copy is in flight); element 4i + 2h + u of
  // o: row 16w + g + 8h, class 8i + 2t + u
  float* stagef = reinterpret_cast<float*>(tiles_s);
  if (kStats && t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + 16 * w + g + 8 * h;
      if (p < P) m_out[static_cast<size_t>(b) * P + p] = mx[h];
    }
  }
  if (kSumF32) {  // a row's keys are spread over the quad's four threads
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lsum[h] += __shfl_xor_sync(0xffffffffu, lsum[h], 1);
      lsum[h] += __shfl_xor_sync(0xffffffffu, lsum[h], 2);
    }
  }
#pragma unroll
  for (int i = 0; i < CP / 8; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int h = r / 2;
      const int row = 16 * w + g + 8 * h;
      const int c = 8 * i + 2 * t + r % 2;
      if (kRowMajor) {
        // kSumF32: column C is the f32 sum of the unrounded weights
        stagef[row * (CP + 1) + c] = kSumF32 && c == C ? lsum[h] : o[4 * i + r];
      } else {
        stagef[c * kStageStride + row] = o[4 * i + r];
      }
    }
  }
  __syncthreads();
  const int rows = min(kTile, P - p0);
  if (kRowMajor) {
    const size_t first = (static_cast<size_t>(b) * P + p0) * C;
    for (int e = tid; e < rows * C; e += wg::kThreads) {
      const int c = e % C;
      const float* st = stagef + (e / C) * (CP + 1);
      const float d = __fdiv_rn(st[c], st[C]);
      out[first + e] = __float2bfloat16_rn(
          __fadd_rn(__bfloat162float(base[first + e]), __fmul_rn(d, wz[c])));
    }
  } else {
    for (int e = tid; e < C * kTile; e += wg::kThreads) {
      const int c = e / kTile;
      const int i = e % kTile;
      if (i < rows) {
        const size_t at = (static_cast<size_t>(b) * C + c) * P + p0 + i;
        const float d = __fdiv_rn(stagef[c * kStageStride + i],
                                  stagef[C * kStageStride + i]);
        out[at] = __float2bfloat16_rn(
            __fadd_rn(__bfloat162float(base[at]), __fmul_rn(d, wz[c])));
        if (kStats) delta[at] = __float2bfloat16_rn(d);
      }
    }
    if (kStats && tid < rows) {
      z_out[static_cast<size_t>(b) * P + p0 + tid] =
          stagef[C * kStageStride + tid];
    }
  }
}

// lay k and v out as tiles into scratch [2][B][Kp][CP], then the walk
template <bool kRowMajor, bool kExpBf16, bool kStats = false,
          bool kSumF32 = false>
int launch_bf16(const void* q, const void* k, const void* v,
                const void* base, const void* wz, void* out, void* scratch,
                int B, int C, int P, int K, void* stream,
                void* delta = nullptr, void* m = nullptr, void* z = nullptr) {
  if (B <= 0 || C <= 0 || C >= 64 || P <= 0 || K <= 0 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int CP = wg::padded_classes(C);
  const int Kp = wg::whole_tiles(K);
  bf16* kp = static_cast<bf16*>(scratch);
  bf16* vp = kp + static_cast<size_t>(B) * Kp * CP;
  const int err = CP == 16
                      ? wg::launch_prep_kv<16, true>(k, v, kp, vp, B, K, Kp,
                                                     C, st)
                      : wg::launch_prep_kv<64, true>(k, v, kp, vp, B, K, Kp,
                                                     C, st);
  if (err) return err;
  const dim3 grid((P + kTile - 1) / kTile, B);
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* bb = static_cast<const bf16*>(base);
  const float* wf = static_cast<const float*>(wz);
  bf16* ob = static_cast<bf16*>(out);
  bf16* db = static_cast<bf16*>(delta);
  float* mf = static_cast<float*>(m);
  float* zf = static_cast<float*>(z);
  if (CP == 16) {
    ct_attention_bf16_kernel<16, kRowMajor, kExpBf16, kStats, kSumF32>
        <<<grid, wg::kThreads, wg::kWalkSmem<16>, st>>>(
            qb, kp, vp, bb, wf, ob, db, mf, zf, C, P, K, Kp);
  } else {
    ct_attention_bf16_kernel<64, kRowMajor, kExpBf16, kStats, kSumF32>
        <<<grid, wg::kThreads, wg::kWalkSmem<64>, st>>>(
            qb, kp, vp, bb, wf, ob, db, mf, zf, C, P, K, Kp);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bfloat16 entry points: q, k, v, base and out bf16, wz float32, C < 64;
// `scratch` holds 2*B*Kp*CP bf16 (CP = 16 for C < 16, else 64; Kp = K
// rounded up to a multiple of 64), k and v in the tile layout. Each
// launches two kernels (the prep, then the walk) on `stream` and returns
// the first launch error.

// Class-major eval forward: q, base, out [B,C,P].
extern "C" int ct_attention_cm_bf16(const void* q, const void* k,
                                    const void* v, const void* base,
                                    const void* wz, void* out, void* scratch,
                                    int B, int C, int P, int K,
                                    void* stream) {
  return launch_bf16<false, false>(q, k, v, base, wz, out, scratch, B, C, P,
                                   K, stream);
}

// Class-major training forward: out and delta [B,C,P] bf16 (delta, the
// attention before wz, rounded to bf16 as `_kernel_cm_stats` saves it in
// base's type), m and z [B,1,P] float32: the row max of the f32 scores and
// the sum of the bf16-rounded weights (the walk's ones column).
extern "C" int ct_attention_cm_stats_bf16(const void* q, const void* k,
                                          const void* v, const void* base,
                                          const void* wz, void* out,
                                          void* delta, void* m, void* z,
                                          void* scratch, int B, int C, int P,
                                          int K, void* stream) {
  return launch_bf16<false, false, true>(q, k, v, base, wz, out, scratch, B,
                                         C, P, K, stream, delta, m, z);
}

// Row-major forward: q, base, out [B,P,C] (the attention bench).
extern "C" int ct_attention_bf16(const void* q, const void* k, const void* v,
                                 const void* base, const void* wz, void* out,
                                 void* scratch, int B, int C, int P, int K,
                                 void* stream) {
  return launch_bf16<true, false>(q, k, v, base, wz, out, scratch, B, C, P, K,
                                  stream);
}

// Row-major forward with the exponential's argument rounded to bf16 too:
// the attention bench's bfloat16-exponent variant on bf16 inputs.
extern "C" int ct_attention_variant_bf16(const void* q, const void* k,
                                         const void* v, const void* base,
                                         const void* wz, void* out,
                                         void* scratch, int B, int C, int P,
                                         int K, void* stream) {
  return launch_bf16<true, true>(q, k, v, base, wz, out, scratch, B, C, P, K,
                                 stream);
}

// Row-major forward whose denominator is the f32 sum of the weights before
// their rounding to bf16 (v is still multiplied by the rounded ones): the
// attention bench's unfused float32-exponent variant on bf16 inputs.
extern "C" int ct_attention_variant_unfused_bf16(
    const void* q, const void* k, const void* v, const void* base,
    const void* wz, void* out, void* scratch, int B, int C, int P, int K,
    void* stream) {
  return launch_bf16<true, false, false, true>(q, k, v, base, wz, out,
                                               scratch, B, C, P, K, stream);
}

// The prep alone, for its card test: k and v [B,K,C] bf16 → kp and vp
// [B][Kp][CP] in the tile layout, with (ones != 0) or without v's ones
// column.
extern "C" int ct_attention_prep_kv_bf16(const void* k, const void* v,
                                         void* kp, void* vp, int B, int C,
                                         int K, int ones, void* stream) {
  if (B <= 0 || C <= 0 || C >= 64 || K <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Kp = wg::whole_tiles(K);
  bf16* kb = static_cast<bf16*>(kp);
  bf16* vb = static_cast<bf16*>(vp);
  if (wg::padded_classes(C) == 16) {
    return ones ? wg::launch_prep_kv<16, true>(k, v, kb, vb, B, K, Kp, C, st)
                : wg::launch_prep_kv<16, false>(k, v, kb, vb, B, K, Kp, C,
                                                st);
  }
  return ones ? wg::launch_prep_kv<64, true>(k, v, kb, vb, B, K, Kp, C, st)
              : wg::launch_prep_kv<64, false>(k, v, kb, vb, B, K, Kp, C, st);
}
