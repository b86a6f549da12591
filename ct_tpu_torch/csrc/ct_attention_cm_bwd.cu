// Class-major Context-Transformer attention, flash backward, float32, for
// Hopper.
//
// Replaces the Pallas TPU kernel `_bwd_kernel_cm_flash`
// (ct_tpu/ops/ct_attention.py, reached through `_bwd_call_cm_flash`, the
// backward rule of `ct_attention_cm`). For out = base + wz * delta with
// delta = softmax_K(k^T q) v, the forward saved the per-anchor row max m and
// denominator z, and the caller computed colsum[b,p] = sum_c g*delta*wz. Per
// image b, anchor p and key j:
//
//   attn  = e^(s - m[p]) / z[p],       s = sum_c k[j,c] q[c,p]
//   dattn = sum_c v[j,c] g[c,p] wz[c]
//   ds    = attn * (dattn - colsum[p])
//   dq[c,p] += ds k[j,c];  dk[j,c] += ds q[c,p];  dv[j,c] += attn g[c,p] wz[c]
//
// q, g, dq are [B,C,P] (anchors contiguous); k, v, dk, dv are [B,K,C]; wz is
// [C]; m, z, colsum are [B,1,P].
//
// What bounds it on the H100: arithmetic, 10*B*P*K*C flops (scores, dattn,
// dq, dk, dv), against q, g, dq and the small k/v/dk/dv moved once.
//
// Design: two kernels, both on the FP32 pipes, with no float atomics, so the
// result does not depend on the order blocks run in.
//  1. dq: one thread per anchor, 128 anchors per block, grid (P tiles, B),
//     as in the forward. A thread keeps q, g*wz and its dq accumulators in
//     registers and walks the keys in tiles of 64 staged in shared memory
//     (warp-wide broadcast reads).
//  2. dk, dv: one thread per key, 128 keys per block, grid (K tiles, B). A
//     thread keeps its k and v rows and its dk and dv accumulators in
//     registers and walks the anchors in tiles of 64, with q, g*wz, m, 1/z
//     and colsum of the tile staged in shared memory.
// Each kernel computes the scores and the exponential again, so the
// exponential runs twice per (anchor, key); both kernels sum the score in
// the forward's order, so they see the forward's s exactly. C is a template
// parameter padded to 16 or 64 (15 source classes and 60 both fit); padded
// classes are zero and never stored. Ragged P and K are masked: a thread
// past the end computes on zeros (its m and 1/z are 0, so attn is 0) and
// stores nothing, and the last tile of keys or anchors is short.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;    // anchors (dq) or keys (dk, dv) per block
constexpr int kKeyTile = 64;     // keys staged in shared memory at a time
constexpr int kAnchorTile = 64;  // anchors staged in shared memory at a time

// sum_c row[c] * x[c] over a shared-memory row, in the forward's order.
template <int CP>
__device__ __forceinline__ float dot_row(const float* row,
                                         const float (&x)[CP]) {
  const float4* r = reinterpret_cast<const float4*>(row);
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
  for (int c4 = 0; c4 < CP / 4; ++c4) {
    const float4 rr = r[c4];
    s0 = fmaf(rr.x, x[4 * c4 + 0], s0);
    s1 = fmaf(rr.y, x[4 * c4 + 1], s1);
    s2 = fmaf(rr.z, x[4 * c4 + 2], s2);
    s3 = fmaf(rr.w, x[4 * c4 + 3], s3);
  }
  return (s0 + s1) + (s2 + s3);
}

template <int CP>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ wz,
              const float* __restrict__ g, const float* __restrict__ m,
              const float* __restrict__ z, const float* __restrict__ colsum,
              float* __restrict__ dq, int C, int P, int K) {
  static_assert(CP % 4 == 0, "padded class count must be a multiple of 4");
  __shared__ __align__(16) float ks[kKeyTile * CP];
  __shared__ __align__(16) float vs[kKeyTile * CP];

  const int b = blockIdx.y;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const bool live = p < P;
  const size_t img = static_cast<size_t>(b) * C * P;
  const size_t row = static_cast<size_t>(b) * P + p;

  float qr[CP];
  float gw[CP];
  float acc[CP];
#pragma unroll
  for (int c = 0; c < CP; ++c) {
    const bool ok = live && c < C;
    const size_t o = img + static_cast<size_t>(c) * P + p;
    qr[c] = ok ? q[o] : 0.f;
    gw[c] = ok ? g[o] * wz[c] : 0.f;
    acc[c] = 0.f;
  }
  const float mp = live ? m[row] : 0.f;
  const float iz = live ? 1.f / z[row] : 0.f;
  const float cs = live ? colsum[row] : 0.f;

  const float* kb = k + static_cast<size_t>(b) * K * C;
  const float* vb = v + static_cast<size_t>(b) * K * C;

  for (int j0 = 0; j0 < K; j0 += kKeyTile) {
    const int nk = min(kKeyTile, K - j0);
    __syncthreads();  // the previous tile is no longer read
    for (int e = threadIdx.x; e < kKeyTile * CP; e += kThreads) {
      const int j = e / CP;
      const int c = e % CP;
      const bool ok = j < nk && c < C;
      const size_t gi = static_cast<size_t>(j0 + j) * C + c;
      ks[e] = ok ? kb[gi] : 0.f;
      vs[e] = ok ? vb[gi] : 0.f;
    }
    __syncthreads();

    for (int j = 0; j < nk; ++j) {
      const float s = dot_row<CP>(ks + j * CP, qr);
      const float attn = expf(s - mp) * iz;
      const float ds = attn * (dot_row<CP>(vs + j * CP, gw) - cs);
      const float4* kr = reinterpret_cast<const float4*>(ks + j * CP);
#pragma unroll
      for (int c4 = 0; c4 < CP / 4; ++c4) {
        const float4 kk = kr[c4];
        acc[4 * c4 + 0] = fmaf(ds, kk.x, acc[4 * c4 + 0]);
        acc[4 * c4 + 1] = fmaf(ds, kk.y, acc[4 * c4 + 1]);
        acc[4 * c4 + 2] = fmaf(ds, kk.z, acc[4 * c4 + 2]);
        acc[4 * c4 + 3] = fmaf(ds, kk.w, acc[4 * c4 + 3]);
      }
    }
  }

  if (!live) return;
#pragma unroll
  for (int c = 0; c < CP; ++c) {
    if (c < C) dq[img + static_cast<size_t>(c) * P + p] = acc[c];
  }
}

template <int CP>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ wz,
                const float* __restrict__ g, const float* __restrict__ m,
                const float* __restrict__ z,
                const float* __restrict__ colsum, float* __restrict__ dk,
                float* __restrict__ dv, int C, int P, int K) {
  static_assert(CP % 4 == 0, "padded class count must be a multiple of 4");
  __shared__ __align__(16) float qs[kAnchorTile * CP];
  __shared__ __align__(16) float gs[kAnchorTile * CP];
  __shared__ float ms[kAnchorTile];
  __shared__ float izs[kAnchorTile];
  __shared__ float css[kAnchorTile];

  const int b = blockIdx.y;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const bool live = j < K;
  const size_t img = static_cast<size_t>(b) * C * P;
  const size_t key = (static_cast<size_t>(b) * K + j) * C;

  float kr[CP];
  float vr[CP];
  float dkr[CP];
  float dvr[CP];
#pragma unroll
  for (int c = 0; c < CP; ++c) {
    const bool ok = live && c < C;
    kr[c] = ok ? k[key + c] : 0.f;
    vr[c] = ok ? v[key + c] : 0.f;
    dkr[c] = 0.f;
    dvr[c] = 0.f;
  }

  for (int p0 = 0; p0 < P; p0 += kAnchorTile) {
    const int np = min(kAnchorTile, P - p0);
    __syncthreads();  // the previous tile is no longer read
    // element e = (c, a): consecutive threads read consecutive anchors
    for (int e = threadIdx.x; e < kAnchorTile * CP; e += kThreads) {
      const int c = e / kAnchorTile;
      const int a = e % kAnchorTile;
      const bool ok = a < np && c < C;
      const size_t o = img + static_cast<size_t>(c) * P + p0 + a;
      qs[a * CP + c] = ok ? q[o] : 0.f;
      gs[a * CP + c] = ok ? g[o] * wz[c] : 0.f;
    }
    for (int a = threadIdx.x; a < kAnchorTile; a += kThreads) {
      const bool ok = a < np;
      const size_t o = static_cast<size_t>(b) * P + p0 + a;
      ms[a] = ok ? m[o] : 0.f;
      izs[a] = ok ? 1.f / z[o] : 0.f;
      css[a] = ok ? colsum[o] : 0.f;
    }
    __syncthreads();

    for (int a = 0; a < np; ++a) {
      const float s = dot_row<CP>(qs + a * CP, kr);
      const float attn = expf(s - ms[a]) * izs[a];
      const float ds = attn * (dot_row<CP>(gs + a * CP, vr) - css[a]);
      const float4* qa = reinterpret_cast<const float4*>(qs + a * CP);
      const float4* ga = reinterpret_cast<const float4*>(gs + a * CP);
#pragma unroll
      for (int c4 = 0; c4 < CP / 4; ++c4) {
        const float4 qq = qa[c4];
        const float4 gg = ga[c4];
        dkr[4 * c4 + 0] = fmaf(ds, qq.x, dkr[4 * c4 + 0]);
        dkr[4 * c4 + 1] = fmaf(ds, qq.y, dkr[4 * c4 + 1]);
        dkr[4 * c4 + 2] = fmaf(ds, qq.z, dkr[4 * c4 + 2]);
        dkr[4 * c4 + 3] = fmaf(ds, qq.w, dkr[4 * c4 + 3]);
        dvr[4 * c4 + 0] = fmaf(attn, gg.x, dvr[4 * c4 + 0]);
        dvr[4 * c4 + 1] = fmaf(attn, gg.y, dvr[4 * c4 + 1]);
        dvr[4 * c4 + 2] = fmaf(attn, gg.z, dvr[4 * c4 + 2]);
        dvr[4 * c4 + 3] = fmaf(attn, gg.w, dvr[4 * c4 + 3]);
      }
    }
  }

  if (!live) return;
#pragma unroll
  for (int c = 0; c < CP; ++c) {
    if (c < C) {
      dk[key + c] = dkr[c];
      dv[key + c] = dvr[c];
    }
  }
}

template <int CP>
int launch(const float* q, const float* k, const float* v, const float* wz,
           const float* g, const float* m, const float* z,
           const float* colsum, float* dq, float* dk, float* dv, int B, int C,
           int P, int K, cudaStream_t st) {
  bwd_dq_kernel<CP><<<dim3((P + kThreads - 1) / kThreads, B), kThreads, 0,
                      st>>>(q, k, v, wz, g, m, z, colsum, dq, C, P, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dkdv_kernel<CP><<<dim3((K + kThreads - 1) / kThreads, B), kThreads, 0,
                        st>>>(q, k, v, wz, g, m, z, colsum, dk, dv, C, P, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes. Pointers are device pointers of contiguous
// float32 tensors; `stream` is a cudaStream_t. Launches both kernels on it
// and returns the first launch error (cudaGetLastError), 0 on success.
extern "C" int ct_attention_cm_bwd_flash_f32(
    const void* q, const void* k, const void* v, const void* wz,
    const void* g, const void* m, const void* z, const void* colsum,
    void* dq, void* dk, void* dv, int B, int C, int P, int K, void* stream) {
  if (B <= 0 || C <= 0 || C > 64 || P <= 0 || K <= 0 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  float* dqf = static_cast<float*>(dq);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  if (C <= 16) {
    return launch<16>(f(q), f(k), f(v), f(wz), f(g), f(m), f(z), f(colsum),
                      dqf, dkf, dvf, B, C, P, K, st);
  }
  return launch<64>(f(q), f(k), f(v), f(wz), f(g), f(m), f(z), f(colsum),
                    dqf, dkf, dvf, B, C, P, K, st);
}
