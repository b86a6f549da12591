// Class-major Context-Transformer attention, forward, float32, for Hopper.
//
// Replaces the Pallas TPU kernel `_kernel_cm` (ct_tpu/ops/ct_attention.py,
// reached through `ct_attention_cm`). For image b and anchor p:
//
//   s[j]       = sum_c k[b,j,c] * q[b,c,p]
//   out[b,c,p] = base[b,c,p] + wz[c] * sum_j e^(s[j]-max s) v[b,j,c]
//                                     / sum_j e^(s[j]-max s)
//
// q, base, out are [B,C,P] (anchors contiguous); k, v are [B,K,C]; wz is [C].
//
// What bounds it on the H100: arithmetic. Per (anchor, key) it does C FMAs
// for the score, C FMAs for the weighted value sum and one exponential,
// 4*B*P*K*C flops in all, while it moves only q, base and out once each plus
// k and v (K*C floats per image, which stay in L2). This first version runs
// on the FP32 pipes, not the tensor cores.
//
// Design: one thread per anchor, 128 anchors per block, grid (P tiles, B).
// Each thread keeps its query column and C accumulators in registers (C is
// a template parameter padded to 16 or 64, so 15 source classes and 60 both
// fit) and walks K in tiles of 64 keys staged in shared memory; all threads
// of a warp read the same key row, a broadcast with no bank conflicts. The
// softmax is online: a running max and denominator per anchor, and the
// accumulators are rescaled only when the max grows, so the [K,P] affinity
// never exists in memory. Loads and stores of q, base and out are coalesced
// along P. Ragged P (threads past the end compute on zeros and store
// nothing) and ragged K (the last tile is short) are masked; padded classes
// are zero in q, k and v, so they add nothing to the scores and are never
// stored.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;  // anchors per block, one per thread
constexpr int kKeyTile = 64;   // keys staged in shared memory at a time

template <int CP>
__global__ void __launch_bounds__(kThreads)
ct_attention_cm_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ base,
                       const float* __restrict__ wz, float* __restrict__ out,
                       int C, int P, int K) {
  static_assert(CP % 4 == 0, "padded class count must be a multiple of 4");
  __shared__ __align__(16) float ks[kKeyTile * CP];
  __shared__ __align__(16) float vs[kKeyTile * CP];

  const int b = blockIdx.y;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const bool live = p < P;
  const size_t img = static_cast<size_t>(b) * C * P;

  float qr[CP];
  float acc[CP];
#pragma unroll
  for (int c = 0; c < CP; ++c) {
    qr[c] = (live && c < C) ? q[img + static_cast<size_t>(c) * P + p] : 0.f;
    acc[c] = 0.f;
  }
  float m = -INFINITY;  // running max of the scores
  float l = 0.f;        // running softmax denominator, relative to m

  const float* kb = k + static_cast<size_t>(b) * K * C;
  const float* vb = v + static_cast<size_t>(b) * K * C;

  for (int j0 = 0; j0 < K; j0 += kKeyTile) {
    const int nk = min(kKeyTile, K - j0);
    __syncthreads();  // the previous tile is no longer read
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

  if (!live) return;
  const float inv = 1.f / l;
#pragma unroll
  for (int c = 0; c < CP; ++c) {
    if (c < C) {
      const size_t o = img + static_cast<size_t>(c) * P + p;
      out[o] = base[o] + wz[c] * (acc[c] * inv);
    }
  }
}

}  // namespace

// Plain C entry point for ctypes. Pointers are device pointers of
// contiguous float32 tensors; `stream` is a cudaStream_t. Returns the
// launch status (cudaGetLastError), 0 on success.
extern "C" int ct_attention_cm_f32(const void* q, const void* k,
                                   const void* v, const void* base,
                                   const void* wz, void* out, int B, int C,
                                   int P, int K, void* stream) {
  if (B <= 0 || C <= 0 || C > 64 || P <= 0 || K <= 0 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((P + kThreads - 1) / kThreads, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* bf = static_cast<const float*>(base);
  const float* wf = static_cast<const float*>(wz);
  float* of = static_cast<float*>(out);
  if (C <= 16) {
    ct_attention_cm_kernel<16><<<grid, kThreads, 0, st>>>(qf, kf, vf, bf, wf,
                                                          of, C, P, K);
  } else {
    ct_attention_cm_kernel<64><<<grid, kThreads, 0, st>>>(qf, kf, vf, bf, wf,
                                                          of, C, P, K);
  }
  return static_cast<int>(cudaGetLastError());
}
