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
// (3.2 M IoUs at N=160, K=200: microseconds at either peak); its time is
// the chain of dependent steps in each row: the IoUs a thread computes one
// after another, then the scan.
//
// Design: one block of 512 threads per row; nothing leaves the block but
// keep, so the host never waits on it. The row's boxes (zero past K), their
// areas and its valid flags (as bit words) are staged in shared memory.
//  * The mask: words of 32 bits, W = ceil(K/32) a row; only the upper
//    triangle is built, the items (word w, rows of word jb <= w), 32 rows a
//    warp: lane r takes row 32 jb + r and the warp's 32 IoUs against
//    candidates 32w .. 32w+31 (read as broadcasts) run unrolled, so that
//    they overlap. 896 items of 32 IoUs at K=200 over all 512 threads. An
//    item whose rows are all invalid (past K, or below the score threshold,
//    which the sorted rows leave at their end) or whose word holds no valid
//    candidate is not computed: its bits are never read. The words are
//    stored transposed, word w of row j at w * (32W + 1) + j, so that the
//    stores and the scan's reads hit distinct banks. The correctly rounded
//    division is most of an IoU's cost, the more so as a zero dividend
//    appears to take its slow path (PERF.md §6): a pair that does not
//    intersect (inter = 0, most pairs) is not divided, since 0 / union is
//    +-0, or NaN where union is 0 or NaN, whatever the rounding, and so
//    exceeds the threshold exactly when 0 > t and union is neither.
//  * The scan: one warp, a word at a time. Lane w holds word w of the
//    "removed" set. Every lane resolves word jb's own 32 x 32 diagonal block
//    alike, in registers: alive = valid and not removed; for t = 0..31, a
//    candidate still alive when reached is kept and clears the later ones
//    it suppresses (bit operations only). Then lane w > jb ORs the kept
//    candidates' words w into its word of the set. W broadcasts where a
//    candidate-at-a-time scan takes K dependent shuffles.
// The IoU is computed in the plain version's order with every operation
// rounded on its own (no FMA contraction, a correctly rounded division), so
// an IoU at the threshold is decided as the plain version decides it and
// the keep masks agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 1024;  // W <= 32: the removed set fits one warp

__device__ __forceinline__ float area(float4 b, float off) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), off),
                   __fadd_rn(__fsub_rn(b.w, b.y), off));
}

// clamp(x, min=0) as torch computes it: NaN stays NaN
__device__ __forceinline__ float clamp0(float x) { return x < 0.f ? 0.f : x; }

// Shared memory of a row, in bytes: boxes [32W] (float4), areas [32W],
// valid words [32], the mask's words [W][32W + 1].
size_t smem_bytes(int W) {
  return static_cast<size_t>(32 * W) * (16 + 4) + 32 * 4 +
         static_cast<size_t>(W) * (32 * W + 1) * 4;
}

__global__ void __launch_bounds__(kThreads)
nms_kernel(const float4* __restrict__ boxes,
           const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep,
           int K, float thr, float off) {
  const int W = (K + 31) / 32;
  const int stride = 32 * W + 1;  // of a word's row of the mask
  extern __shared__ __align__(16) unsigned char smem[];
  float4* bx = reinterpret_cast<float4*>(smem);              // [32W]
  float* ar = reinterpret_cast<float*>(bx + 32 * W);         // [32W]
  uint32_t* vw = reinterpret_cast<uint32_t*>(ar + 32 * W);   // [32]
  uint32_t* sup = vw + 32;                                   // [W][stride]
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;

  const size_t row = blockIdx.x;
  for (int i = threadIdx.x; i < 32 * W; i += kThreads) {
    const float4 c = i < K ? boxes[row * K + i] : make_float4(0, 0, 0, 0);
    bx[i] = c;
    ar[i] = area(c, off);
  }
  for (int w = warp; w < W; w += kWarps) {
    const int i = w * 32 + lane;
    const uint32_t bits =
        __ballot_sync(0xffffffffu, i < K && valid[row * K + i] != 0);
    if (lane == 0) vw[w] = bits;
  }
  __syncthreads();

  // the upper triangle: the 32 W (W + 1) / 2 items (w, j), jb = j / 32 <=
  // w, by word block jb: block jb's 32 (W - jb) items start at
  // 32 (jb W - jb (jb - 1) / 2), 32 a warp (one word, 32 rows)
  const int items = 16 * W * (W + 1);
  const bool zero_hit = 0.f > thr;  // whether 0 / union exceeds t
  for (int e = threadIdx.x; e < items; e += kThreads) {
    int jb = 0, start = 0;
    while (start + 32 * (W - jb) <= e) {
      start += 32 * (W - jb);
      ++jb;
    }
    const int w = jb + (e - start) / 32;
    const int j = 32 * jb + lane;
    const bool live = (vw[jb] >> lane) & 1u;  // false past K too
    uint32_t bits = 0;
    if (vw[w] != 0 && __any_sync(0xffffffffu, live)) {
      const float4 a = bx[j];
      const float area_a = ar[j];
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        const int i = 32 * w + t;
        const float4 c = bx[i];
        const float xx1 = fmaxf(a.x, c.x);
        const float yy1 = fmaxf(a.y, c.y);
        const float xx2 = fminf(a.z, c.z);
        const float yy2 = fminf(a.w, c.w);
        const float iw = clamp0(__fadd_rn(__fsub_rn(xx2, xx1), off));
        const float ih = clamp0(__fadd_rn(__fsub_rn(yy2, yy1), off));
        const float inter = __fmul_rn(iw, ih);
        const float uni = __fsub_rn(__fadd_rn(area_a, ar[i]), inter);
        bool hit;
        if (inter == 0.f) {
          hit = zero_hit && uni == uni && uni != 0.f;
        } else {
          hit = __fdiv_rn(inter, uni) > thr;
        }
        if (i > j && hit) bits |= 1u << t;
      }
    }
    sup[w * stride + j] = bits;
  }
  __syncthreads();

  if (warp != 0) return;
  uint32_t removed = 0;  // word `lane` of the suppressed set
  for (int jb = 0; jb < W; ++jb) {
    const uint32_t* diag = sup + jb * stride + 32 * jb;
    uint32_t alive = vw[jb] & ~__shfl_sync(0xffffffffu, removed, jb);
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      const uint32_t d = diag[t];
      if ((alive >> t) & 1u) alive &= ~d;
    }
    // alive is now the word's kept set
    const int i = 32 * jb + lane;
    if (i < K) keep[row * K + i] = (alive >> lane) & 1u;
    if (lane > jb && lane < W) {
      const uint32_t* col = sup + lane * stride + 32 * jb;
      uint32_t acc = 0;
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        if ((alive >> t) & 1u) acc |= col[t];
      }
      removed |= acc;
    }
  }
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
  const size_t smem = smem_bytes((K + 31) / 32);
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
