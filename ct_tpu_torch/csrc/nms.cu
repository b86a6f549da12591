// Greedy non-maximum suppression over score-sorted candidates, for Hopper.
//
// Replaces the Pallas TPU kernel `_nms_kernel` of ct_tpu/ops/nms_pallas.py,
// reached through `nms_pallas`. For each of N rows (one image and class) of
// K candidates sorted by descending score:
//
//   sup[j,i] = j < i  and  IoU(j, i) > t      (IoU with a +offset area)
//   keep[i]  = valid[i] and no j < i has sup[j,i] and keep[j]
//
// The TPU kernel resolves keep as the fixpoint of that recurrence, one
// whole-mask sweep at a time; the greedy scan below computes the same mask,
// since the greedy solution is the recurrence's unique fixpoint.
//
// What bounds it on the H100: neither bytes nor operations. It reads
// 16*K + K bytes per row and writes K, and does K*(K-1)/2 IoUs of ~20 flops
// (3.2 M IoUs at N=160, K=200: microseconds at either peak); its time is the
// launch and the serial scan, K dependent steps per row.
//
// Design: one block of 256 threads per row; nothing leaves the block but
// keep, so the host never waits on it. The row's boxes and valid flags are
// staged in shared memory; each thread builds whole rows j of the
// suppression mask as bit words (W = ceil(K/32) words per row, 200 x 7
// words at K = 200) in shared memory; then one warp scans i = 0..K-1, lane
// w holding word w of the "removed" set: keep[i] is valid[i] and not
// removed, and a kept i ORs its mask row into the set, as the reference
// CUDA NMS scans its bit mask on the host. The IoU is computed in the plain
// version's order with every operation rounded on its own (no FMA
// contraction), so an IoU at the threshold is decided as the plain version
// decides it and the keep masks agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 1024;  // W <= 32: the removed set fits one warp

__device__ __forceinline__ float area(float4 b, float off) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), off),
                   __fadd_rn(__fsub_rn(b.w, b.y), off));
}

// clamp(x, min=0) as torch computes it: NaN stays NaN
__device__ __forceinline__ float clamp0(float x) { return x < 0.f ? 0.f : x; }

__global__ void __launch_bounds__(kThreads)
nms_kernel(const float4* __restrict__ boxes,
           const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep,
           int K, float thr, float off) {
  const int W = (K + 31) / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  float4* bx = reinterpret_cast<float4*>(smem);                   // [K]
  uint32_t* sup = reinterpret_cast<uint32_t*>(bx + K);            // [K, W]
  uint8_t* vs = reinterpret_cast<uint8_t*>(sup + K * W);          // [K]
  uint8_t* ks = vs + K;                                           // [K]

  const size_t row = blockIdx.x;
  for (int i = threadIdx.x; i < K; i += kThreads) {
    bx[i] = boxes[row * K + i];
    vs[i] = valid[row * K + i];
  }
  __syncthreads();

  for (int j = threadIdx.x; j < K; j += kThreads) {
    const float4 a = bx[j];
    const float area_a = area(a, off);
    for (int w = 0; w < W; ++w) {
      uint32_t bits = 0;
      for (int t = 0; t < 32; ++t) {
        const int i = w * 32 + t;
        if (i <= j || i >= K) continue;
        const float4 c = bx[i];
        const float xx1 = fmaxf(a.x, c.x);
        const float yy1 = fmaxf(a.y, c.y);
        const float xx2 = fminf(a.z, c.z);
        const float yy2 = fminf(a.w, c.w);
        const float iw = clamp0(__fadd_rn(__fsub_rn(xx2, xx1), off));
        const float ih = clamp0(__fadd_rn(__fsub_rn(yy2, yy1), off));
        const float inter = __fmul_rn(iw, ih);
        const float iou = __fdiv_rn(
            inter, __fsub_rn(__fadd_rn(area_a, area(c, off)), inter));
        if (iou > thr) bits |= 1u << t;
      }
      sup[j * W + w] = bits;
    }
  }
  __syncthreads();

  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    uint32_t removed = 0;  // word `lane` of the suppressed set
    for (int i = 0; i < K; ++i) {
      const uint32_t word = __shfl_sync(0xffffffffu, removed, i >> 5);
      const bool kept = vs[i] && !((word >> (i & 31)) & 1u);
      if (kept && lane < W) removed |= sup[i * W + lane];
      if (lane == 0) ks[i] = kept;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < K; i += kThreads) keep[row * K + i] = ks[i];
}

}  // namespace

// Plain C entry point for ctypes. boxes is a device pointer of contiguous
// float32 [N, K, 4]; valid and keep of contiguous bool (one byte) [N, K];
// `stream` is a cudaStream_t. Returns the launch status (cudaGetLastError),
// 0 on success.
extern "C" int nms_mask_f32(const void* boxes, const void* valid, void* keep,
                            int N, int K, float thr, float off,
                            void* stream) {
  if (N <= 0 || K <= 0 || K > kMaxK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int W = (K + 31) / 32;
  const size_t smem = static_cast<size_t>(K) * 16 +
                      static_cast<size_t>(K) * W * 4 + 2 * K;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_kernel<<<N, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), K, thr, off);
  return static_cast<int>(cudaGetLastError());
}
