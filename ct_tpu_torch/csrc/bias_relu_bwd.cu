// Backward of a convolution's bias + ReLU, float32, NCHW, for Hopper.
//
// Replaces the Pallas TPU kernel `_kernel` of scripts/bench_bias_relu_bwd.py
// (reached through `bias_relu_bwd_pallas`). For y = relu(x + bias) and the
// upstream gradient g, both [N,C,H,W]:
//
//   masked[n,c,h,w] = y > 0 ? g : 0         (the gradient of x)
//   dbias[c]        = sum_{n,h,w} masked    (the gradient of bias)
//
// What bounds it on the H100: bytes. It reads g and y and writes masked
// once, 12 bytes an element, and does one compare and one add per element.
//
// Design: one pass. A block takes a chunk of up to kChunk elements of one
// (n, c) plane (grid: chunks of the plane, N*C planes), reads g and y with
// 16-byte loads where a plane's length is a multiple of 4 (else one float a
// thread), writes masked, and sums its chunk (warp shuffles, then the warps
// in order) into one partial per block. A second kernel sums the partials
// of each channel over n and chunks in a fixed order, one block per
// channel: no atomics, so dbias does not depend on the order blocks run in.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 8192;  // elements of a plane per block

template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
mask_kernel(const float* __restrict__ g, const float* __restrict__ y,
            float* __restrict__ masked, float* __restrict__ part, int HW) {
  const size_t plane = static_cast<size_t>(blockIdx.y) * HW;
  const int lo = blockIdx.x * kChunk;
  const int hi = min(HW, lo + kChunk);
  float s = 0.f;
  if (kVec4) {
    const float4* g4 = reinterpret_cast<const float4*>(g + plane);
    const float4* y4 = reinterpret_cast<const float4*>(y + plane);
    float4* m4 = reinterpret_cast<float4*>(masked + plane);
    for (int i = lo / 4 + threadIdx.x; i < hi / 4; i += kThreads) {
      const float4 gg = g4[i];
      const float4 yy = y4[i];
      float4 mm;
      mm.x = yy.x > 0.f ? gg.x : 0.f;
      mm.y = yy.y > 0.f ? gg.y : 0.f;
      mm.z = yy.z > 0.f ? gg.z : 0.f;
      mm.w = yy.w > 0.f ? gg.w : 0.f;
      m4[i] = mm;
      s += (mm.x + mm.y) + (mm.z + mm.w);
    }
  } else {
    for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
      const float mm = y[plane + i] > 0.f ? g[plane + i] : 0.f;
      masked[plane + i] = mm;
      s += mm;
    }
  }
  __shared__ float red[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    s += __shfl_down_sync(0xffffffffu, s, off);
  }
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) t += red[w];
    part[static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x] = t;
  }
}

// dbias[c] = sum over n and chunks of part[(n*C + c)*chunks + chunk].
__global__ void __launch_bounds__(kThreads)
channel_sum_kernel(const float* __restrict__ part, float* __restrict__ dbias,
                   int N, int C, int chunks) {
  __shared__ float red[kThreads];
  const int c = blockIdx.x;
  float s = 0.f;
  for (int i = threadIdx.x; i < N * chunks; i += kThreads) {
    const int n = i / chunks;
    s += part[(static_cast<size_t>(n) * C + c) * chunks + i % chunks];
  }
  red[threadIdx.x] = s;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w /= 2) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) dbias[c] = red[0];
}

}  // namespace

// Plain C entry point for ctypes. g, y, masked are device pointers of
// contiguous float32 [N,C,H,W] tensors with HW = H*W, dbias [C], and part
// the caller's scratch of N*C*ceil(HW/8192) floats; `stream` is a
// cudaStream_t. Returns the first launch error (cudaGetLastError), 0 on
// success.
extern "C" int bias_relu_bwd_f32(const void* g, const void* y, void* masked,
                                 void* dbias, void* part, int N, int C,
                                 int HW, void* stream) {
  if (N <= 0 || C <= 0 || HW <= 0 || static_cast<long long>(N) * C > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int chunks = (HW + kChunk - 1) / kChunk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  const float* yf = static_cast<const float*>(y);
  float* mf = static_cast<float*>(masked);
  float* pf = static_cast<float*>(part);
  const dim3 grid(chunks, N * C);
  if (HW % 4 == 0) {
    mask_kernel<true><<<grid, kThreads, 0, st>>>(gf, yf, mf, pf, HW);
  } else {
    mask_kernel<false><<<grid, kThreads, 0, st>>>(gf, yf, mf, pf, HW);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  channel_sum_kernel<<<C, kThreads, 0, st>>>(pf, static_cast<float*>(dbias),
                                             N, C, chunks);
  return static_cast<int>(cudaGetLastError());
}
