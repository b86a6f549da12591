// Fused serving Context-Transformer head, float32, for Hopper, on the
// tensor cores.
//
// Replaces the Pallas TPU kernel `_serving_kernel` of
// ct_tpu/ops/ct_attention.py, reached through `ct_attention_serving`. For
// image b and anchor p, with conf = conf[b,:,p]:
//
//   q[o]     = sum_c Wt[c,o] conf[c] + bt[o] + conf[o]       (theta, residual)
//   s[j]     = sum_c k[b,j,c] q[c]
//   novel[c] = conf[c] + wz[c] * sum_j e^(s[j]-max s) v[b,j,c]
//                                 / sum_j e^(s[j]-max s)
//   out[b,n,p] = scale * sum_c obj[n,c] novel[c] / ||novel||_2
//
// conf is [B,C,P] (anchors contiguous); k, v are [B,K,C]; Wt is the theta
// kernel [C,C] laid out (in, out); bt, wz are [C]; obj is [N,C]; out is
// [B,N,P]. Only out reaches device memory: q and novel never do.
//
// What bounds it on the H100: arithmetic. Per anchor it does C*C
// multiply-adds for q, 2*K*C for the attention (score and weighted value
// sum), K exponentials and N*C for the classifier: 2*B*P*C*(2K+C+N) flops,
// against conf read once and out written once (7.5 MB at B=8, C=15, N=5),
// with k and v (K*C floats per image) held in L2. Its three products (q,
// the scores, P V) run on the tensor cores in 3xTF32, three TF32 products
// each (ct_attention_mma.cuh); the classifier (N*C of the 2K+C+N terms,
// 1% at C=60, N=20) on the FP32 pipes. PERF.md §6 row 6 gives the time
// against both bounds.
//
// Design: the forwards' walk (attend, ct_attention_mma.cuh: 64 anchors a
// block, 16 a warp, keys in cp.async tiles of 32, the scores and P V in
// 3xTF32 mma.sync, an online softmax on the accumulator fragments), with
// the head around it:
//  * prologue: Wt + I (the residual folded into theta) is staged [CP][CP]
//    in the walk's shared memory; each warp loads its 16 anchors' conf
//    rows as A fragments (classes as k) and forms Q = X (Wt + I) on the
//    tensor cores in 3xTF32. The B fragments read the output classes in
//    the order pi(n) = 4(n&1) + n/2 (as load_kn reads keys), so that the
//    accumulator already is the walk's A layout: bt is added, the
//    fragments split, and the walk starts, with no shuffle and no trip
//    through shared memory; the conf fragments are dead by then.
//  * epilogue: delta = O / l staged in shared memory, as
//    ct_attention_kernel stages it; obj [N][CP] and wz beside it. Each
//    anchor is taken by two threads (the block's 128 for its 64 anchors):
//    both read conf again along the anchors (coalesced) for the residual,
//    take novel and its norm, and each computes half of the N scores on
//    the FP32 pipes, obj read as broadcasts, out stored along the anchors.
// Ragged P (rows past P compute on conf = 0 and store nothing), ragged K and
// padded classes (zero in Wt + I, bt, wz and obj, so q and novel are zero
// there) are handled as the forwards handle them. No atomics: two launches
// give the same bits.
//
// bfloat16 (ct_attention_serving_bf16): conf, k, v, Wt and obj bf16, bt
// and wz f32, out bf16, with the JAX kernel's rounding points:
//   q     = bf16(Wt^T conf + bt + conf)    f32 sums, rounded once
//   e     = bf16(exp(s - max s))           (the bf16 walk)
//   novel = bf16(n / ||n||_2),  n = conf + wz * num / den    (f32, rsqrt)
//   out   = bf16(scale * obj . novel)      f32 sums of exact bf16 products
// on the bf16 walk (ct_attention_bf16.cuh). Wt is staged transposed
// [out][in] bf16 and q = conf Wt is one m16n8k16 product a tile: its
// accumulator is the walk's A layout as it stands (chunks 2kk and 2kk+1 of
// the output classes are the A fragment of classes 16kk .. 16kk+15), and
// the residual conf is read from the conf fragments, which hold the same
// (row, class) pairs. Its bound, as the forward's, is its exponentials.

#include "ct_attention_bf16.cuh"
#include "ct_attention_mma.cuh"

namespace {

using namespace ct;

constexpr int kMaxN = 64;  // the widest classifier
// shared-memory stride of a class in the epilogue's stage: 2t*68 + g hits
// 32 distinct banks for a warp's fragment writes
constexpr int kStageStride = kRows + 4;

// stride of an input class of the staged Wt + I: the four rows 8kk + t of
// a B fragment then start on banks 8 apart (72t or 24t mod 32), so that a
// warp's loads (those rows, output classes 8nn + pi(g)) hit 32 distinct
// banks
template <int CP>
constexpr int kThetaStride = CP + 8;

// shared memory of a block, in floats: Wt + I, then the walk's tiles, then
// the epilogue's stage [CP][kStageStride] and obj [kMaxN][CP]; 8.4 KB at
// CP=16, 33 KB at CP=64, under the 48 KB a kernel may declare statically
template <int CP>
constexpr int kServingFloats =
    kWalkFloats<CP> > CP * kStageStride + kMaxN * CP
        ? kWalkFloats<CP>
        : CP * kStageStride + kMaxN * CP;

// B operand of the theta product from the staged Wt + I: k = input classes
// 8kk + t (+4), n = output classes 8nn + pi(g), split in registers.
template <int CP>
__device__ __forceinline__ void load_theta(const float* w, int kk, int nn,
                                           int g, int t, uint32_t (&bh)[2],
                                           uint32_t (&bl)[2]) {
  constexpr int S = kThetaStride<CP>;
  const int o = 8 * nn + ((g & 1) << 2) + (g >> 1);
  const float x[2] = {w[(8 * kk + t) * S + o], w[(8 * kk + t + 4) * S + o]};
  split<2>(x, bh, bl);
}

// Two blocks an SM, as the f32 forward: up to 255 registers a thread.
template <int CP>
__global__ void __launch_bounds__(kThreads, 2)
ct_attention_serving_kernel(const float* __restrict__ conf,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ wt,
                            const float* __restrict__ bt,
                            const float* __restrict__ wz,
                            const float* __restrict__ obj,
                            float* __restrict__ out, int C, int P, int K,
                            int N, float scale) {
  static_assert(CP * kThetaStride<CP> <= kWalkFloats<CP>,
                "Wt + I fits in the walk's shared memory");
  __shared__ __align__(16) float smem[kServingFloats<CP>];
  __shared__ float wzs[CP];
  constexpr int NK = CP / 8;
  constexpr int S = kThetaStride<CP>;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int gq = lane / 4, tq = lane % 4;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kRows;

  for (int e = threadIdx.x; e < CP * CP; e += kThreads) {
    const int c = e / CP;
    const int o = e % CP;
    smem[c * S + o] =
        (c < C && o < C) ? wt[c * C + o] + (c == o ? 1.f : 0.f) : 0.f;
  }
  __syncthreads();

  // q = conf (Wt + I) + bt, 3xTF32; element r of d[nn] is row g + 8(r/2),
  // output class 8nn + t + 4(r%2): A fragment element {0, 2, 1, 3}[r]
  RowsA<NK, true> qa;
  {
    RowsA<NK, false> x;
    x.template load<false>(conf, nullptr, b, p0 + warp * 16, C, P, gq, tq);
    float d[NK][4];
#pragma unroll
    for (int nn = 0; nn < NK; ++nn) {
#pragma unroll
      for (int r = 0; r < 4; ++r) d[nn][r] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t xh[4], xl[4];
      x.at(kk, xh, xl);
#pragma unroll
      for (int nn = 0; nn < NK; ++nn) {
        uint32_t bh[2], bl[2];
        load_theta<CP>(smem, kk, nn, gq, tq, bh, bl);
        mma3(d[nn], xh, xl, bh, bl);
      }
    }
#pragma unroll
    for (int nn = 0; nn < NK; ++nn) {
      const int c = 8 * nn + tq;
      const float b0 = c < C ? bt[c] : 0.f;
      const float b1 = c + 4 < C ? bt[c + 4] : 0.f;
      qa.x[nn][0] = d[nn][0] + b0;
      qa.x[nn][1] = d[nn][2] + b0;
      qa.x[nn][2] = d[nn][1] + b1;
      qa.x[nn][3] = d[nn][3] + b1;
    }
    qa.prepare();
  }

  float o[NK][4], m[2], l[2];
  attend<CP, false>(qa, k, v, b, C, K, smem, o, m, l);

  // delta = O / l into the stage; obj and wz beside it
  __syncthreads();  // the key tiles are no longer read
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
  for (int nn = 0; nn < NK; ++nn) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = warp * 16 + gq + (r / 2) * 8;
      const int c = 8 * nn + 2 * tq + r % 2;
      smem[c * kStageStride + row] = o[nn][r] * inv[r / 2];
    }
  }
  float* objs = smem + CP * kStageStride;
  for (int e = threadIdx.x; e < N * CP; e += kThreads) {
    const int n = e / CP;
    const int c = e % CP;
    objs[e] = c < C ? obj[n * C + c] : 0.f;
  }
  for (int c = threadIdx.x; c < CP; c += kThreads) {
    wzs[c] = c < C ? wz[c] : 0.f;
  }
  __syncthreads();

  // anchor i of the block, by threads i and i + 64
  const int i = threadIdx.x % kRows;
  const int p = p0 + i;
  if (p >= P) return;
  const float* confp = conf + static_cast<size_t>(b) * C * P + p;
  float nv[CP];
  float ss = 0.f;
#pragma unroll
  for (int c = 0; c < CP; ++c) {
    const float x = c < C ? confp[static_cast<size_t>(c) * P] : 0.f;
    nv[c] = x + smem[c * kStageStride + i] * wzs[c];
    ss = fmaf(nv[c], nv[c], ss);
  }
  const float rn = rsqrtf(ss);
#pragma unroll
  for (int c = 0; c < CP; ++c) nv[c] *= rn;

  float* outp = out + static_cast<size_t>(b) * N * P + p;
  for (int n = threadIdx.x / kRows; n < N; n += kThreads / kRows) {
    const float4* orow = reinterpret_cast<const float4*>(objs + n * CP);
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
    for (int c4 = 0; c4 < CP / 4; ++c4) {
      const float4 w = orow[c4];
      s0 = fmaf(w.x, nv[4 * c4 + 0], s0);
      s1 = fmaf(w.y, nv[4 * c4 + 1], s1);
      s2 = fmaf(w.z, nv[4 * c4 + 2], s2);
      s3 = fmaf(w.w, nv[4 * c4 + 3], s3);
    }
    outp[static_cast<size_t>(n) * P] = ((s0 + s1) + (s2 + s3)) * scale;
  }
}

}  // namespace

// Plain C entry point for ctypes. Pointers are device pointers of
// contiguous float32 tensors; `stream` is a cudaStream_t. Returns the launch
// status (cudaGetLastError), 0 on success.
extern "C" int ct_attention_serving_f32(const void* conf, const void* k,
                                        const void* v, const void* wt,
                                        const void* bt, const void* wz,
                                        const void* obj, void* out, int B,
                                        int C, int P, int K, int N,
                                        float scale, void* stream) {
  if (B <= 0 || C <= 0 || C > 64 || P <= 0 || K <= 0 || N <= 0 ||
      N > kMaxN || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((P + kRows - 1) / kRows, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* cf = static_cast<const float*>(conf);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* wf = static_cast<const float*>(wt);
  const float* bf = static_cast<const float*>(bt);
  const float* zf = static_cast<const float*>(wz);
  const float* of = static_cast<const float*>(obj);
  float* outf = static_cast<float*>(out);
  if (C <= 16) {
    ct_attention_serving_kernel<16><<<grid, kThreads, 0, st>>>(
        cf, kf, vf, wf, bf, zf, of, outf, C, P, K, N, scale);
  } else {
    ct_attention_serving_kernel<64><<<grid, kThreads, 0, st>>>(
        cf, kf, vf, wf, bf, zf, of, outf, C, P, K, N, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// --- bfloat16 -------------------------------------------------------------

namespace {

using ct::bf::bf16;

// shared memory of a bf16 block, in bytes: the walk's tiles (the staged Wt
// [CP][CP + 8] bf16 before them), then the epilogue's stage [CP][68] and
// obj [kMaxN][CP] f32; 8.3 KB at CP=16, 33 KB at CP=64
template <int CP>
constexpr int kServingBf16Bytes =
    ct::bf::kWalkBytes<CP> > 4 * (CP * kStageStride + kMaxN * CP)
        ? ct::bf::kWalkBytes<CP>
        : 4 * (CP * kStageStride + kMaxN * CP);

template <int CP>
__global__ void __launch_bounds__(kThreads, ct::bf::kMinBlocks<CP>)
ct_attention_serving_bf16_kernel(const bf16* __restrict__ conf,
                                 const bf16* __restrict__ kp,
                                 const bf16* __restrict__ vp,
                                 const bf16* __restrict__ wt,
                                 const float* __restrict__ bt,
                                 const float* __restrict__ wz,
                                 const bf16* __restrict__ obj,
                                 bf16* __restrict__ out, int C, int P, int K,
                                 int N, float scale) {
  constexpr int S = ct::bf::kStride<CP>;
  static_assert(CP * S * 2 <= ct::bf::kWalkBytes<CP>,
                "Wt fits in the walk's shared memory");
  __shared__ __align__(16) unsigned char smem_raw[kServingBf16Bytes<CP>];
  __shared__ float wzs[CP];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  float* stagef = reinterpret_cast<float*>(smem_raw);
  constexpr int NK = CP / 16;
  constexpr int NN = CP / 8;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int gq = lane / 4, tq = lane % 4;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kRows;

  // Wt transposed: smem[o * S + i] = Wt[i][o], zero past C
  for (int e = threadIdx.x; e < CP * CP; e += kThreads) {
    const int o = e / CP;
    const int i = e % CP;
    smem[o * S + i] = (i < C && o < C) ? wt[i * C + o]
                                       : __float2bfloat16_rn(0.f);
  }
  __syncthreads();

  // q = conf Wt + bt + conf, rounded to bf16, as the walk's A operand
  uint32_t qa[NK][4];
  {
    uint32_t x[NK][4];
    ct::bf::load_rows<CP>(conf, b, p0 + warp * 16, C, P, gq, tq, x);
    float d[NN][4];
#pragma unroll
    for (int nn = 0; nn < NN; ++nn) {
#pragma unroll
      for (int r = 0; r < 4; ++r) d[nn][r] = 0.f;
    }
    // ldmatrix rows: output classes 8nn + (lane & 7) (+8 for lanes 16-31),
    // input classes 16kk (+8 for lanes 8-15 and 24-31)
    const int lrow = (lane & 7) + ((lane >> 4) << 3);
    const int lcol = ((lane >> 3) & 1) << 3;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
      for (int nn = 0; nn < NN; nn += 2) {
        uint32_t r4[4];
        ct::bf::ldmatrix_x4<false>(r4, smem + (8 * nn + lrow) * S + 16 * kk +
                                           lcol);
        const uint32_t b0[2] = {r4[0], r4[1]};
        const uint32_t b1[2] = {r4[2], r4[3]};
        ct::bf::mma(d[nn], x[kk], b0);
        ct::bf::mma(d[nn + 1], x[kk], b1);
      }
    }
    // element r of d[nn]: row g + 8(r/2), class 8nn + 2t + r%2; the conf
    // value of that (row, class) is half r%2 of x[nn/2][2(nn%2) + r/2]
#pragma unroll
    for (int nn = 0; nn < NN; ++nn) {
      float qv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int c = 8 * nn + 2 * tq + r % 2;
        const uint32_t xw = x[nn / 2][2 * (nn % 2) + r / 2];
        const float cf = r % 2 ? ct::bf::unpack_hi(xw) : ct::bf::unpack_lo(xw);
        qv[r] = __fadd_rn(__fadd_rn(d[nn][r], c < C ? bt[c] : 0.f), cf);
      }
      qa[nn / 2][2 * (nn % 2) + 0] = ct::bf::pack(qv[0], qv[1]);
      qa[nn / 2][2 * (nn % 2) + 1] = ct::bf::pack(qv[2], qv[3]);
    }
  }

  float o[NN][4], m[2];
  ct::bf::attend<CP>(qa, kp, vp, b, K, smem, o, m);

  // numerators and denominator into the stage; obj and wz beside it
  __syncthreads();  // the key tiles are no longer read
#pragma unroll
  for (int nn = 0; nn < NN; ++nn) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = warp * 16 + gq + (r / 2) * 8;
      const int c = 8 * nn + 2 * tq + r % 2;
      stagef[c * kStageStride + row] = o[nn][r];
    }
  }
  float* objs = stagef + CP * kStageStride;
  for (int e = threadIdx.x; e < N * CP; e += kThreads) {
    const int n = e / CP;
    const int c = e % CP;
    objs[e] = c < C ? __bfloat162float(obj[n * C + c]) : 0.f;
  }
  for (int c = threadIdx.x; c < CP; c += kThreads) {
    wzs[c] = c < C ? wz[c] : 0.f;
  }
  __syncthreads();

  // anchor i of the block, by threads i and i + 64
  const int i = threadIdx.x % kRows;
  const int p = p0 + i;
  if (p >= P) return;
  const bf16* confp = conf + static_cast<size_t>(b) * C * P + p;
  const float den = stagef[C * kStageStride + i];
  float nv[CP];
  float ss = 0.f;
#pragma unroll
  for (int c = 0; c < CP; ++c) {
    const float x =
        c < C ? __bfloat162float(confp[static_cast<size_t>(c) * P]) : 0.f;
    const float d = __fdiv_rn(stagef[c * kStageStride + i], den);
    nv[c] = __fadd_rn(x, __fmul_rn(d, wzs[c]));  // 0 past C (wz 0 there)
    ss = __fmaf_rn(nv[c], nv[c], ss);
  }
  const float rn = rsqrtf(ss);
#pragma unroll
  for (int c = 0; c < CP; ++c) nv[c] = ct::bf16_round(__fmul_rn(nv[c], rn));

  bf16* outp = out + static_cast<size_t>(b) * N * P + p;
  for (int n = threadIdx.x / kRows; n < N; n += kThreads / kRows) {
    const float4* orow = reinterpret_cast<const float4*>(objs + n * CP);
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
    for (int c4 = 0; c4 < CP / 4; ++c4) {
      const float4 w = orow[c4];
      s0 = fmaf(w.x, nv[4 * c4 + 0], s0);
      s1 = fmaf(w.y, nv[4 * c4 + 1], s1);
      s2 = fmaf(w.z, nv[4 * c4 + 2], s2);
      s3 = fmaf(w.w, nv[4 * c4 + 3], s3);
    }
    outp[static_cast<size_t>(n) * P] =
        __float2bfloat16_rn(((s0 + s1) + (s2 + s3)) * scale);
  }
}

}  // namespace

// bfloat16 entry point: conf, k, v, wt, obj and out bf16, bt and wz float32,
// C < 64; `scratch` holds 2*B*K*CP bf16 (CP = 16 for C < 16, else 64), the
// padded k and v. Launches the padding, then the head, on `stream`; returns
// the launch status.
extern "C" int ct_attention_serving_bf16(const void* conf, const void* k,
                                         const void* v, const void* wt,
                                         const void* bt, const void* wz,
                                         const void* obj, void* out,
                                         void* scratch, int B, int C, int P,
                                         int K, int N, float scale,
                                         void* stream) {
  if (B <= 0 || C <= 0 || C >= 64 || P <= 0 || K <= 0 || N <= 0 ||
      N > kMaxN || B > 65535) {
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
                                 static_cast<const bf16*>(v), kp, vp, rows, C,
                                 CP);
  const cudaError_t pad = cudaGetLastError();
  if (pad != cudaSuccess) return static_cast<int>(pad);
  const dim3 grid((P + kRows - 1) / kRows, B);
  const bf16* cf = static_cast<const bf16*>(conf);
  const bf16* wf = static_cast<const bf16*>(wt);
  const float* bf = static_cast<const float*>(bt);
  const float* zf = static_cast<const float*>(wz);
  const bf16* of = static_cast<const bf16*>(obj);
  bf16* outf = static_cast<bf16*>(out);
  if (CP == 16) {
    ct_attention_serving_bf16_kernel<16><<<grid, kThreads, 0, st>>>(
        cf, kp, vp, wf, bf, zf, of, outf, C, P, K, N, scale);
  } else {
    ct_attention_serving_bf16_kernel<64><<<grid, kThreads, 0, st>>>(
        cf, kp, vp, wf, bf, zf, of, outf, C, P, K, N, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
