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
// What bounds it on the H100: arithmetic. Per (anchor, key) it does C FMAs
// for the score, C FMAs for the weighted value sum and one exponential,
// 4*B*P*K*C flops in all, while it moves only q, base and out once each plus
// k and v (K*C floats per image, which stay in L2). This first version runs
// on the FP32 pipes, not the tensor cores.
//
// Design: one thread per anchor, 128 anchors per block, grid (P tiles, B).
// Each thread keeps its query row and C accumulators in registers (C padded
// to 16 or 64) and walks K in tiles of 64 keys staged in shared memory; all
// threads of a warp read the same key row, a broadcast with no bank
// conflicts. The softmax is online (ct_attention_common.cuh, softmax_sum),
// so the [K,P] affinity never exists in memory. Class-major loads and
// stores are coalesced along P; row-major ones go through shared memory
// (load_rows, store_rows), in the key tiles' space before and after the
// walk. Ragged P (threads past the end compute on zeros and store nothing)
// and ragged K (the last tile is short) are masked. The bfloat16-exponent
// variant takes two passes over K, the first for the row max, so that each
// weight is rounded as the plain version rounds it.

#include "ct_attention_common.cuh"

namespace {

using namespace ct;

template <int CP, bool kStats, bool kRowMajor, bool kExpBf16>
__global__ void __launch_bounds__(kThreads)
ct_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ base,
                    const float* __restrict__ wz, float* __restrict__ out,
                    float* __restrict__ delta, float* __restrict__ m_out,
                    float* __restrict__ z_out, int C, int P, int K) {
  static_assert(CP % 4 == 0, "padded class count must be a multiple of 4");
  static_assert(!(kStats && kRowMajor), "statistics are class-major only");
  // the key and value tiles; row-major rows are staged in the same space
  __shared__ __align__(16) float smem[2 * kKeyTile * CP];
  float* ks = smem;
  float* vs = smem + kKeyTile * CP;

  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kThreads;
  const int p = p0 + threadIdx.x;

  float qr[CP];
  load_rows<CP, kRowMajor>(q, b, p0, C, P, smem, qr);
  float acc[CP];
  float m, l;
  softmax_sum<CP, kExpBf16>(qr, k + static_cast<size_t>(b) * K * C,
                            v + static_cast<size_t>(b) * K * C, C, K, ks, vs,
                            acc, m, l);

  const float inv = 1.f / l;
#pragma unroll
  for (int c = 0; c < CP; ++c) acc[c] *= inv;
  store_rows<CP, kRowMajor>(out, base, wz, b, p0, C, P, smem, acc);
  if (kStats && p < P) {
    store_rows<CP, false>(delta, nullptr, nullptr, b, p0, C, P, smem, acc);
    const size_t s_at = static_cast<size_t>(b) * P + p;
    m_out[s_at] = m;
    z_out[s_at] = l;
  }
}

template <bool kStats, bool kRowMajor, bool kExpBf16>
int launch(const void* q, const void* k, const void* v, const void* base,
           const void* wz, void* out, void* delta, void* m, void* z, int B,
           int C, int P, int K, void* stream) {
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
  float* df = static_cast<float*>(delta);
  float* mf = static_cast<float*>(m);
  float* zf = static_cast<float*>(z);
  if (C <= 16) {
    ct_attention_kernel<16, kStats, kRowMajor, kExpBf16>
        <<<grid, kThreads, 0, st>>>(qf, kf, vf, bf, wf, of, df, mf, zf, C, P,
                                    K);
  } else {
    ct_attention_kernel<64, kStats, kRowMajor, kExpBf16>
        <<<grid, kThreads, 0, st>>>(qf, kf, vf, bf, wf, of, df, mf, zf, C, P,
                                    K);
  }
  return static_cast<int>(cudaGetLastError());
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
