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
// What bounds it on the H100: arithmetic, 10*B*P*K*C flops for the flash
// backward (scores, dattn, dq, dk, dv) and 12*B*P*K*C for the blockwise one
// (which also recomputes the scores' softmax and delta), against q, g, dq
// and the small k/v/dk/dv moved once.
//
// Design: all on the FP32 pipes, with no float atomics, so the result does
// not depend on the order blocks run in.
//  0. (blockwise only) stats: one thread per anchor, as the forward
//     (softmax_sum), recomputes m, z and delta, then writes m, z and
//     colsum, and each block's partial sum of g*delta over its 128 anchors
//     (warp shuffles, then the four warps in order); dwz_reduce sums the
//     partials of every block in a fixed order, one block per class.
//  1. dq: one thread per anchor, 128 anchors per block, grid (P tiles, B).
//     A thread keeps q, g*wz and its dq accumulators in registers and walks
//     the keys in tiles of 64 staged in shared memory (warp-wide broadcast
//     reads).
//  2. dk, dv: one thread per key, 128 keys per block, grid (K tiles, B). A
//     thread keeps its k and v rows and its dk and dv accumulators in
//     registers and walks the anchors in tiles of 64, with q, g*wz, m, 1/z
//     and colsum of the tile staged in shared memory.
// Each kernel computes the scores and the exponential again, so the
// exponential runs twice per (anchor, key) in the flash backward and three
// times in the blockwise one; every kernel sums a score in the forward's
// order (dot_row), so all see the same s. Ragged P and K are masked: a
// thread past the end computes on zeros (its m and 1/z are 0, so attn is 0)
// and stores nothing, and the last tile of keys or anchors is short.

#include "ct_attention_common.cuh"

namespace {

using namespace ct;

template <int CP, bool kRowMajor>
__global__ void __launch_bounds__(kThreads)
bwd_stats_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ wz,
                 const float* __restrict__ g, float* __restrict__ m_out,
                 float* __restrict__ z_out, float* __restrict__ colsum_out,
                 float* __restrict__ dwz_part, int C, int P, int K) {
  static_assert(CP % 4 == 0, "padded class count must be a multiple of 4");
  __shared__ __align__(16) float smem[2 * kKeyTile * CP];
  float* ks = smem;
  float* vs = smem + kKeyTile * CP;

  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kThreads;
  const int p = p0 + threadIdx.x;

  float qr[CP];
  float gr[CP];
  load_rows<CP, kRowMajor>(q, b, p0, C, P, smem, qr);
  load_rows<CP, kRowMajor>(g, b, p0, C, P, smem, gr);
  float acc[CP];
  float m, l;
  softmax_sum<CP, false>(qr, k + static_cast<size_t>(b) * K * C,
                         v + static_cast<size_t>(b) * K * C, C, K, ks, vs,
                         acc, m, l);

  // delta = acc / l; a thread past P holds g = 0, so it adds nothing
  const float inv = 1.f / l;
  float cs = 0.f;
#pragma unroll
  for (int c = 0; c < CP; ++c) {
    acc[c] = gr[c] * (acc[c] * inv);  // g * delta
    if (c < C) cs = fmaf(acc[c], wz[c], cs);
  }
  if (p < P) {
    const size_t at = static_cast<size_t>(b) * P + p;
    m_out[at] = m;
    z_out[at] = l;
    colsum_out[at] = cs;
  }

  // this block's sum of g * delta over its anchors, per class
  float* red = smem;  // [kThreads / 32][CP]
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  __syncthreads();  // the key tiles are no longer read
#pragma unroll
  for (int c = 0; c < CP; ++c) {
    float x = acc[c];
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      x += __shfl_down_sync(0xffffffffu, x, off);
    }
    if (lane == 0) red[warp * CP + c] = x;
  }
  __syncthreads();
  if (threadIdx.x < C) {
    float s = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) s += red[w * CP + threadIdx.x];
    dwz_part[(static_cast<size_t>(b) * gridDim.x + blockIdx.x) * C +
             threadIdx.x] = s;
  }
}

constexpr int kReduceThreads = 256;

// dwz[c] = sum over the n partial rows of part[:, c], in a fixed order: one
// block per class, a strided sum per thread, then a tree in shared memory.
__global__ void __launch_bounds__(kReduceThreads)
dwz_reduce_kernel(const float* __restrict__ part, float* __restrict__ dwz,
                  int n, int C) {
  __shared__ float red[kReduceThreads];
  const int c = blockIdx.x;
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += kReduceThreads) {
    s += part[static_cast<size_t>(i) * C + c];
  }
  red[threadIdx.x] = s;
  __syncthreads();
  for (int w = kReduceThreads / 2; w > 0; w /= 2) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) dwz[c] = red[0];
}

template <int CP, bool kRowMajor>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ wz,
              const float* __restrict__ g, const float* __restrict__ m,
              const float* __restrict__ z, const float* __restrict__ colsum,
              float* __restrict__ dq, int C, int P, int K) {
  static_assert(CP % 4 == 0, "padded class count must be a multiple of 4");
  __shared__ __align__(16) float smem[2 * kKeyTile * CP];
  float* ks = smem;
  float* vs = smem + kKeyTile * CP;

  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kThreads;
  const int p = p0 + threadIdx.x;
  const bool live = p < P;
  const size_t row = static_cast<size_t>(b) * P + p;

  float qr[CP];
  float gw[CP];
  float acc[CP];
  load_rows<CP, kRowMajor>(q, b, p0, C, P, smem, qr);
  load_rows<CP, kRowMajor>(g, b, p0, C, P, smem, gw);
#pragma unroll
  for (int c = 0; c < CP; ++c) {
    gw[c] = c < C ? gw[c] * wz[c] : 0.f;
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
    stage_keys<CP>(ks, vs, kb, vb, j0, nk, C);
    __syncthreads();

    for (int j = 0; j < nk; ++j) {
      const float s = dot_row<CP>(ks + j * CP, qr);
      const float attn = expf(s - mp) * iz;
      const float ds = attn * (dot_row<CP>(vs + j * CP, gw) - cs);
      axpy_row<CP>(ds, ks + j * CP, acc);
    }
  }
  store_rows<CP, kRowMajor>(dq, nullptr, nullptr, b, p0, C, P, smem, acc);
}

template <int CP, bool kRowMajor>
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
    for (int e = threadIdx.x; e < kAnchorTile * CP; e += kThreads) {
      int a, c;
      size_t o;
      if (kRowMajor) {
        // element e = (a, c): consecutive threads read consecutive classes
        a = e / CP;
        c = e % CP;
        o = (static_cast<size_t>(b) * P + p0 + a) * C + c;
      } else {
        // element e = (c, a): consecutive threads read consecutive anchors
        c = e / kAnchorTile;
        a = e % kAnchorTile;
        o = (static_cast<size_t>(b) * C + c) * P + p0 + a;
      }
      const bool ok = a < np && c < C;
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
      axpy_row<CP>(ds, qs + a * CP, dkr);
      axpy_row<CP>(attn, gs + a * CP, dvr);
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

template <int CP, bool kRowMajor>
int launch_grads(const float* q, const float* k, const float* v,
                 const float* wz, const float* g, const float* m,
                 const float* z, const float* colsum, float* dq, float* dk,
                 float* dv, int B, int C, int P, int K, cudaStream_t st) {
  bwd_dq_kernel<CP, kRowMajor>
      <<<dim3((P + kThreads - 1) / kThreads, B), kThreads, 0, st>>>(
          q, k, v, wz, g, m, z, colsum, dq, C, P, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dkdv_kernel<CP, kRowMajor>
      <<<dim3((K + kThreads - 1) / kThreads, B), kThreads, 0, st>>>(
          q, k, v, wz, g, m, z, colsum, dk, dv, C, P, K);
  return static_cast<int>(cudaGetLastError());
}

template <int CP, bool kRowMajor>
int launch_blockwise(const float* q, const float* k, const float* v,
                     const float* wz, const float* g, float* dq, float* dk,
                     float* dv, float* dwz, float* m, float* z, float* colsum,
                     float* part, int B, int C, int P, int K,
                     cudaStream_t st) {
  const int tiles = (P + kThreads - 1) / kThreads;
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
// caller's scratch: m, z, colsum [B,P] and part [B, ceil(P/128), C].
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
