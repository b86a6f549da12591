// Fused serving Context-Transformer head, float32, for Hopper.
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
// [B,N,P]. Only out reaches device memory: q and novel live in registers.
//
// What bounds it on the H100: arithmetic. Per anchor it does C*C FMAs for
// q, 2*K*C for the attention (score and weighted value sum), K exponentials
// and N*C for the classifier: 2*B*P*C*(2K+C+N) flops, against conf read
// once and out written once (7.5 MB at B=8, C=15, N=5), with k and v
// (K*C floats per image) held in L2. This first version runs on the FP32
// pipes.
//
// Design: the attention of ct_attention_cm.cu (one thread per anchor, 128
// anchors per block, grid (P tiles, B); keys and values staged 64 at a time
// in shared memory and read as warp broadcasts; an online softmax; ragged P
// and K masked; C padded to 16 or 64 with zeros that add nothing), with the
// head around it. Shared memory holds only the two key tiles and bt, wz:
// Wt + I (the theta residual folded into the kernel) is staged first in the
// key tile's space and obj last, so C = 64 fits in the 48 KB of static
// shared memory. Registers: q and the C accumulators. q is formed by a loop
// over the C classes that reads the conf column once from device memory,
// coalesced along P (a loop, not unrolled, so that the compiler does not
// unroll C*C products); the column is read again for the residual at the
// end rather than held.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;  // anchors per block, one per thread
constexpr int kKeyTile = 64;   // keys staged in shared memory at a time

template <int CP>
__global__ void __launch_bounds__(kThreads)
ct_attention_serving_kernel(const float* __restrict__ conf,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ wt,
                            const float* __restrict__ bt,
                            const float* __restrict__ wz,
                            const float* __restrict__ obj,
                            float* __restrict__ out, int C, int P, int K,
                            int N, float scale) {
  static_assert(CP % 4 == 0, "padded class count must be a multiple of 4");
  static_assert(CP <= kKeyTile, "Wt + I must fit the key tile's space");
  // ks holds Wt + I [CP, CP] first, then key tiles, then obj [N, CP]
  __shared__ __align__(16) float ks[kKeyTile * CP];
  __shared__ __align__(16) float vs[kKeyTile * CP];
  __shared__ float bts[CP];
  __shared__ float wzs[CP];

  const int b = blockIdx.y;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const bool live = p < P;
  const float* confb = conf + static_cast<size_t>(b) * C * P;

  for (int e = threadIdx.x; e < CP * CP; e += kThreads) {
    const int c = e / CP;
    const int o = e % CP;
    ks[e] = (c < C && o < C) ? wt[c * C + o] + (c == o ? 1.f : 0.f) : 0.f;
  }
  for (int c = threadIdx.x; c < CP; c += kThreads) {
    bts[c] = c < C ? bt[c] : 0.f;
    wzs[c] = c < C ? wz[c] : 0.f;
  }
  __syncthreads();

  // q = (Wt + I)^T conf + bt
  float qr[CP];
  float acc[CP];
#pragma unroll
  for (int o = 0; o < CP; ++o) {
    qr[o] = bts[o];
    acc[o] = 0.f;
  }
#pragma unroll 1
  for (int c = 0; c < C; ++c) {
    const float x = live ? confb[static_cast<size_t>(c) * P + p] : 0.f;
    const float4* wr = reinterpret_cast<const float4*>(ks + c * CP);
#pragma unroll
    for (int o4 = 0; o4 < CP / 4; ++o4) {
      const float4 w = wr[o4];
      qr[4 * o4 + 0] = fmaf(w.x, x, qr[4 * o4 + 0]);
      qr[4 * o4 + 1] = fmaf(w.y, x, qr[4 * o4 + 1]);
      qr[4 * o4 + 2] = fmaf(w.z, x, qr[4 * o4 + 2]);
      qr[4 * o4 + 3] = fmaf(w.w, x, qr[4 * o4 + 3]);
    }
  }

  float m = -INFINITY;  // running max of the scores
  float l = 0.f;        // running softmax denominator, relative to m
  const float* kb = k + static_cast<size_t>(b) * K * C;
  const float* vb = v + static_cast<size_t>(b) * K * C;

  for (int j0 = 0; j0 < K; j0 += kKeyTile) {
    const int nk = min(kKeyTile, K - j0);
    __syncthreads();  // Wt or the previous tile is no longer read
    for (int e = threadIdx.x; e < kKeyTile * CP; e += kThreads) {
      const int j = e / CP;
      const int c = e % CP;
      const bool ok = j < nk && c < C;
      const size_t g = static_cast<size_t>(j0 + j) * C + c;
      ks[e] = ok ? kb[g] : 0.f;
      vs[e] = ok ? vb[g] : 0.f;
    }
    __syncthreads();

    for (int j = 0; j < nk; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(ks + j * CP);
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
      for (int c4 = 0; c4 < CP / 4; ++c4) {
        const float4 kk = kr[c4];
        s0 = fmaf(kk.x, qr[4 * c4 + 0], s0);
        s1 = fmaf(kk.y, qr[4 * c4 + 1], s1);
        s2 = fmaf(kk.z, qr[4 * c4 + 2], s2);
        s3 = fmaf(kk.w, qr[4 * c4 + 3], s3);
      }
      const float s = (s0 + s1) + (s2 + s3);
      if (s > m) {
        const float corr = expf(m - s);  // 0 on the first key
        l *= corr;
#pragma unroll
        for (int c = 0; c < CP; ++c) acc[c] *= corr;
        m = s;
      }
      const float w = expf(s - m);
      l += w;
      const float4* vr = reinterpret_cast<const float4*>(vs + j * CP);
#pragma unroll
      for (int c4 = 0; c4 < CP / 4; ++c4) {
        const float4 vv = vr[c4];
        acc[4 * c4 + 0] = fmaf(w, vv.x, acc[4 * c4 + 0]);
        acc[4 * c4 + 1] = fmaf(w, vv.y, acc[4 * c4 + 1]);
        acc[4 * c4 + 2] = fmaf(w, vv.z, acc[4 * c4 + 2]);
        acc[4 * c4 + 3] = fmaf(w, vv.w, acc[4 * c4 + 3]);
      }
    }
  }

  // obj replaces the last key tile
  __syncthreads();
  for (int e = threadIdx.x; e < N * CP; e += kThreads) {
    const int n = e / CP;
    const int c = e % CP;
    ks[e] = c < C ? obj[n * C + c] : 0.f;
  }
  __syncthreads();
  if (!live) return;

  // novel = conf + delta * wz, normalised; padded classes stay 0
  const float inv_l = 1.f / l;
  float ss = 0.f;
#pragma unroll
  for (int c = 0; c < CP; ++c) {
    const float x =
        c < C ? confb[static_cast<size_t>(c) * P + p] : 0.f;
    acc[c] = x + acc[c] * inv_l * wzs[c];
    ss = fmaf(acc[c], acc[c], ss);
  }
  const float inv = rsqrtf(ss);
#pragma unroll
  for (int c = 0; c < CP; ++c) acc[c] *= inv;

  float* outb = out + static_cast<size_t>(b) * N * P;
  for (int n = 0; n < N; ++n) {
    const float4* orow = reinterpret_cast<const float4*>(ks + n * CP);
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
    for (int c4 = 0; c4 < CP / 4; ++c4) {
      const float4 w = orow[c4];
      s0 = fmaf(w.x, acc[4 * c4 + 0], s0);
      s1 = fmaf(w.y, acc[4 * c4 + 1], s1);
      s2 = fmaf(w.z, acc[4 * c4 + 2], s2);
      s3 = fmaf(w.w, acc[4 * c4 + 3], s3);
    }
    outb[static_cast<size_t>(n) * P + p] = ((s0 + s1) + (s2 + s3)) * scale;
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
  if (B <= 0 || C <= 0 || C > 64 || P <= 0 || K <= 0 || N <= 0 || N > 64 ||
      B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((P + kThreads - 1) / kThreads, B);
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
