// Context-Transformer attention, forward, float32, for Hopper.
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
// ct_attention_variant_unfused_bf16): the same function on
// bf16 q, k, v and base, f32 wz, bf16 out, with the JAX kernels' rounding
// points, on the bf16 walk (ct_attention_bf16.cuh: one m16n8k16 product per
// tile, the weights rounded to bf16 against the final max, the denominator
// from v's ones column). Its bound is its B*P*K exponentials on the
// special-function units, not its products (PERF.md §6). The epilogue
// divides by the denominator, out = bf16(base + wz * num / den), rounded
// to nearest even; the training forward (`_kernel_cm_stats` on bf16) also
// stores delta = num / den rounded to bf16, as JAX saves it in base's type,
// and m and z = den in f32, for the bf16 flash backward
// (ct_attention_bwd_bf16.cu). The bench's unfused float32-exponent variant
// divides by the f32 sum of the weights before their rounding instead of
// column C (kSumF32 on the walk: one f32 add a weight, a shared-memory add
// a tile, two shuffles a row).

#include "ct_attention_bf16.cuh"
#include "ct_attention_mma.cuh"

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

using ct::bf::bf16;

// The unfused variant (kSumF32) at CP=64 asks for four blocks an SM (up to
// 128 registers), as many as the fused forward's 128 registers fit: held
// to three, it took more registers than four blocks allow and ran behind
// the fused forward by about the lost block. With its running sums in
// shared memory between tiles (attend) it fits four without a spill.
template <int CP, bool kRowMajor, bool kExpBf16, bool kStats,
          bool kSumF32>
__global__ void __launch_bounds__(kThreads, kSumF32 && CP == 64
                                                ? 4
                                                : ct::bf::kMinBlocks<CP>)
ct_attention_bf16_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ kp,
                         const bf16* __restrict__ vp,
                         const bf16* __restrict__ base,
                         const float* __restrict__ wz,
                         bf16* __restrict__ out, bf16* __restrict__ delta,
                         float* __restrict__ m_out, float* __restrict__ z_out,
                         int C, int P, int K) {
  static_assert(!(kStats && kRowMajor), "statistics are class-major only");
  static_assert(!kSumF32 || kRowMajor, "the unfused variant is row-major");
  constexpr int kBytes = ct::bf::kWalkBytes<CP>;
  static_assert(CP * kStageStride * 4 <= kBytes &&
                    kRows * (CP + 1) * 4 <= kBytes,
                "the epilogue's stage fits in the walk's shared memory");
  __shared__ __align__(16) unsigned char smem_raw[kBytes];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  float* stagef = reinterpret_cast<float*>(smem_raw);
  constexpr int NN = CP / 8;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int gq = lane / 4, tq = lane % 4;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kRows;

  uint32_t qa[CP / 16][4];
  ct::bf::load_rows<CP, kRowMajor>(q, b, p0 + warp * 16, C, P, gq, tq, qa);
  float o[NN][4], m[2], l[2];
  ct::bf::attend<CP, kExpBf16, kSumF32>(qa, kp, vp, b, K, smem, o, m, l);

  // the numerators and (column C) the denominator into the stage
  __syncthreads();  // the key tiles are no longer read
  if (kStats && tq == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + warp * 16 + gq + h * 8;
      if (p < P) m_out[static_cast<size_t>(b) * P + p] = m[h];
    }
  }
#pragma unroll
  for (int nn = 0; nn < NN; ++nn) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = warp * 16 + gq + (r / 2) * 8;
      const int c = 8 * nn + 2 * tq + r % 2;
      if (kRowMajor) {
        // kSumF32: column C is the f32 sum of the unrounded weights, held
        // by each thread of the row's quad; the one holding column C of o
        // writes it
        stagef[row * (CP + 1) + c] = kSumF32 && c == C ? l[r / 2] : o[nn][r];
      } else {
        stagef[c * kStageStride + row] = o[nn][r];
      }
    }
  }
  __syncthreads();
  const int rows = min(kRows, P - p0);
  if (kRowMajor) {
    const size_t first = (static_cast<size_t>(b) * P + p0) * C;
    for (int e = threadIdx.x; e < rows * C; e += kThreads) {
      const int c = e % C;
      const float* st = stagef + (e / C) * (CP + 1);
      const float d = __fdiv_rn(st[c], st[C]);
      out[first + e] = __float2bfloat16_rn(
          __fadd_rn(__bfloat162float(base[first + e]), __fmul_rn(d, wz[c])));
    }
  } else {
    for (int e = threadIdx.x; e < C * kRows; e += kThreads) {
      const int c = e / kRows;
      const int i = e % kRows;
      if (i < rows) {
        const size_t at = (static_cast<size_t>(b) * C + c) * P + p0 + i;
        const float d = __fdiv_rn(stagef[c * kStageStride + i],
                                  stagef[C * kStageStride + i]);
        out[at] = __float2bfloat16_rn(
            __fadd_rn(__bfloat162float(base[at]), __fmul_rn(d, wz[c])));
        if (kStats) delta[at] = __float2bfloat16_rn(d);
      }
    }
    if (kStats && threadIdx.x < rows) {
      z_out[static_cast<size_t>(b) * P + p0 + threadIdx.x] =
          stagef[C * kStageStride + threadIdx.x];
    }
  }
}

// pad k and v into scratch [2][B][K][CP], then the walk
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
  const int CP = ct::bf::padded_classes(C);
  bf16* kp = static_cast<bf16*>(scratch);
  bf16* vp = kp + static_cast<size_t>(B) * K * CP;
  const long long rows = static_cast<long long>(B) * K;
  const long long pad_blocks = (rows * CP + 255) / 256;
  ct::bf::pad_kv<<<static_cast<int>(pad_blocks < 4096 ? pad_blocks : 4096),
                     256, 0, st>>>(static_cast<const bf16*>(k),
                                             static_cast<const bf16*>(v), kp,
                                             vp, rows, C, CP);
  const cudaError_t pad = cudaGetLastError();
  if (pad != cudaSuccess) return static_cast<int>(pad);
  const dim3 grid((P + kRows - 1) / kRows, B);
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* bb = static_cast<const bf16*>(base);
  const float* wf = static_cast<const float*>(wz);
  bf16* ob = static_cast<bf16*>(out);
  bf16* db = static_cast<bf16*>(delta);
  float* mf = static_cast<float*>(m);
  float* zf = static_cast<float*>(z);
  if (CP == 16) {
    ct_attention_bf16_kernel<16, kRowMajor, kExpBf16, kStats, kSumF32>
        <<<grid, kThreads, 0, st>>>(qb, kp, vp, bb, wf, ob, db, mf, zf, C, P,
                                    K);
  } else {
    ct_attention_bf16_kernel<64, kRowMajor, kExpBf16, kStats, kSumF32>
        <<<grid, kThreads, 0, st>>>(qb, kp, vp, bb, wf, ob, db, mf, zf, C, P,
                                    K);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bfloat16 entry points: q, k, v, base and out bf16, wz float32, C < 64;
// `scratch` holds 2*B*K*CP bf16 (CP = 16 for C < 16, else 64), the padded
// k and v. Each launches two kernels (the padding, then the walk) on
// `stream` and returns the launch status.

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
