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
//   s     = k . q                          f32 sums of exact bf16 products
//   e     = bf16(exp(s - max s))           against the row's final max
//   novel = bf16(n / ||n||_2),  n = conf + wz * num / den    (f32, rsqrt)
//   out   = bf16(scale * obj . novel)      f32 sums of exact bf16 products
// on the bf16 forwards' warpgroup wgmma tiles (ct_attention_wgmma.cuh).
// Its bound, as the forwards', is its exponentials at C=15 and its
// products at C=60. Design:
//  * prep_kv (the forwards') lays k and v out as whole 64-key swizzled
//    tiles, v's column C one (the denominator);
//  * one warpgroup owns 64 anchors of one image. Prologue: it stages their
//    conf rows as a [64][CP] tile (read along the anchors) and Wt
//    transposed (output classes as rows, zero past C) as a second tile in
//    stage 0's v tile, which walk 1's first loads leave alone, while the
//    first key tiles land; conf Wt is one wgmma product (m64n64k16, both
//    tiles K-major; at CP=16 its output columns past 16 are zero rows of
//    the Wt tile, and ignored); each thread adds bt and conf (read from the
//    conf tile at its accumulator's (row, class)) and writes bf16 q over
//    conf in place, so that q is the walks' operand tile. q stays in shared
//    memory: as wgmma A fragments held in registers across products it gave
//    wrong sums at CP=64 in the forwards (PERF.md §6);
//  * the forwards' two walks (wg::walk): the row max, then the bf16
//    weights and O += P V, its numerators and denominator in one product
//    a tile, a fresh accumulator a tile added with rounded f32 adds;
//  * epilogue: the numerators and denominator staged in f32 as the
//    forwards' class-major epilogue stages them, obj and wz beside them;
//    each anchor taken by two threads, as the f32 head's, both reading
//    conf again along the anchors for the residual and taking novel and
//    its norm, each computing half of the N scores on the FP32 pipes.
// Ragged P (rows past P compute on conf = 0 and store nothing) and ragged
// K (the last tile's dead keys masked) as in the forwards. No atomics: two
// launches give the same bits.

#include "ct_attention_mma.cuh"
#include "ct_attention_wgmma.cuh"

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

using bf16 = __nv_bfloat16;
using wg::kTile;

// Blocks an SM that the launch bounds ask registers for: up to 102 a
// thread at CP=64 (five blocks, which the 41 KB of shared memory allow),
// 128 at CP=16. Held to three, ptxas on an H100 gave the CP=64 kernel 127
// registers, four blocks an SM, and it ran 12% slower at B=128 (PERF.md
// §6); at five it takes 96 without a spill. CP=16: 68.
template <int CP>
constexpr int kServingBlocks = CP <= 16 ? 4 : 5;

// One warpgroup, 64 anchors of image b. kp and vp: the keys and values in
// the tile layout, Kp keys (whole tiles), vp's column C the ones.
template <int CP>
__global__ void __launch_bounds__(wg::kThreads, kServingBlocks<CP>)
ct_attention_serving_bf16_kernel(const bf16* __restrict__ conf,
                                 const bf16* __restrict__ kp,
                                 const bf16* __restrict__ vp,
                                 const bf16* __restrict__ wt,
                                 const float* __restrict__ bt,
                                 const float* __restrict__ wz,
                                 const bf16* __restrict__ obj,
                                 bf16* __restrict__ out, int C, int P, int K,
                                 int Kp, int N, float scale) {
  constexpr int TB = wg::kTileBytes<CP>;
  static_assert(4 * (CP * kStageStride + kMaxN * CP) <=
                    TB + wg::KeyTiles<CP>::kBytes,
                "the epilogue's stage fits in the tiles' bytes");
  extern __shared__ uint8_t dyn[];
  __shared__ __align__(8) uint64_t bar[wg::KeyTiles<CP>::kStages];
  __shared__ float wzs[CP];
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
  bf16* sw = reinterpret_cast<bf16*>(ks.v_tile(0));
  ks.start();

  // conf rows into the q tile (read along the anchors, zero past P and
  // C) and Wt transposed into sw (row o = output class, the input classes
  // along it, zero past C; read along the output classes)
  for (int e = tid; e < kTile * CP; e += wg::kThreads) {
    const int c = e / kTile;
    const int i = e % kTile;
    const int p = p0 + i;
    bf16 x = __float2bfloat16_rn(0.f);
    if (p < P && c < C) x = conf[(static_cast<size_t>(b) * C + c) * P + p];
    sq[wg::at<CP>(i, c)] = x;
    const bool live = c < C && i < C;  // input class c, output class i
    sw[wg::at<CP>(i, c)] = live ? wt[c * C + i] : __float2bfloat16_rn(0.f);
  }
  wg::fence_proxy_async();
  __syncthreads();

  // theta: conf Wt, element j of th at row 16w + g + 8((j >> 1) & 1),
  // output class 8(j / 4) + 2t + (j & 1)
  float th[32];
  wg::fence();
  wg::scores<CP>(th, wg::desc<CP>(sq), wg::desc<CP>(sw));
  wg::commit();
  wg::wait<0>();
  wg::keep(th);
  __syncthreads();  // every warp's product has read the conf tile
  // q = bf16(th + bt + conf) over conf, a pair of classes at a time
#pragma unroll
  for (int j = 0; j < CP / 2; j += 2) {
    const int row = 16 * w + g + 8 * ((j >> 1) & 1);
    const int c = 8 * (j / 4) + 2 * t;
    uint32_t* at = reinterpret_cast<uint32_t*>(sq + wg::at<CP>(row, c));
    const uint32_t x = *at;
    const float b0 = c < C ? bt[c] : 0.f;
    const float b1 = c + 1 < C ? bt[c + 1] : 0.f;
    *at = wg::pack(__fadd_rn(__fadd_rn(th[j], b0), wg::unpack_lo(x)),
                   __fadd_rn(__fadd_rn(th[j + 1], b1), wg::unpack_hi(x)));
  }
  wg::fence_proxy_async();
  __syncthreads();

  float mx[2], lsum[2], o[CP / 2];
  wg::walk<CP, false, false>(ks, wg::desc<CP>(sq), K, mx, lsum, o);

  // the numerators and (column C) the denominator into the stage, which
  // the tiles' bytes hold (no copy is in flight): element 4i + 2h + u of
  // o is row 16w + g + 8h, class 8i + 2t + u; obj and wz beside them
  float* stagef = reinterpret_cast<float*>(tiles_s);
#pragma unroll
  for (int i = 0; i < CP / 8; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = 16 * w + g + 8 * (r / 2);
      const int c = 8 * i + 2 * t + r % 2;
      stagef[c * kStageStride + row] = o[4 * i + r];
    }
  }
  float* objs = stagef + CP * kStageStride;
  for (int e = tid; e < N * CP; e += wg::kThreads) {
    const int n = e / CP;
    const int c = e % CP;
    objs[e] = c < C ? __bfloat162float(obj[n * C + c]) : 0.f;
  }
  for (int c = tid; c < CP; c += wg::kThreads) {
    wzs[c] = c < C ? wz[c] : 0.f;
  }
  __syncthreads();

  // anchor i of the block, by threads i and i + 64
  const int i = tid % kTile;
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
  for (int n = tid / kTile; n < N; n += wg::kThreads / kTile) {
    const float4* orow = reinterpret_cast<const float4*>(objs + n * CP);
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
    for (int c4 = 0; c4 < CP / 4; ++c4) {
      const float4 v4 = orow[c4];
      s0 = fmaf(v4.x, nv[4 * c4 + 0], s0);
      s1 = fmaf(v4.y, nv[4 * c4 + 1], s1);
      s2 = fmaf(v4.z, nv[4 * c4 + 2], s2);
      s3 = fmaf(v4.w, nv[4 * c4 + 3], s3);
    }
    outp[static_cast<size_t>(n) * P] =
        __float2bfloat16_rn(((s0 + s1) + (s2 + s3)) * scale);
  }
}

template <int CP>
int launch_serving_bf16(const void* conf, const void* k, const void* v,
                        const void* wt, const void* bt, const void* wz,
                        const void* obj, void* out, void* scratch, int B,
                        int C, int P, int K, int N, float scale,
                        cudaStream_t st) {
  const int Kp = wg::whole_tiles(K);
  bf16* kp = static_cast<bf16*>(scratch);
  bf16* vp = kp + static_cast<size_t>(B) * Kp * CP;
  const int err = wg::launch_prep_kv<CP, true>(k, v, kp, vp, B, K, Kp, C, st);
  if (err) return err;
  ct_attention_serving_bf16_kernel<CP>
      <<<dim3((P + kTile - 1) / kTile, B), wg::kThreads, wg::kWalkSmem<CP>,
         st>>>(static_cast<const bf16*>(conf), kp, vp,
               static_cast<const bf16*>(wt), static_cast<const float*>(bt),
               static_cast<const float*>(wz), static_cast<const bf16*>(obj),
               static_cast<bf16*>(out), C, P, K, Kp, N, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bfloat16 entry point: conf, k, v, wt, obj and out bf16, bt and wz float32,
// C < 64; `scratch` holds 2*B*Kp*CP bf16 (CP = 16 for C < 16, else 64; Kp =
// K rounded up to a multiple of 64), k and v in the tile layout. Launches
// the prep, then the head, on `stream`; returns the first launch error.
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
  if (wg::padded_classes(C) == 16) {
    return launch_serving_bf16<16>(conf, k, v, wt, bt, wz, obj, out, scratch,
                                   B, C, P, K, N, scale, st);
  }
  return launch_serving_bf16<64>(conf, k, v, wt, bt, wz, obj, out, scratch, B,
                                 C, P, K, N, scale, st);
}
