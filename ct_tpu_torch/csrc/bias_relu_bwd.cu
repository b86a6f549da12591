// Backward of a convolution's bias + ReLU, float32 and bfloat16, NCHW, for
// Hopper.
//
// Replaces the Pallas TPU kernel `_kernel` of scripts/bench_bias_relu_bwd.py
// (reached through `bias_relu_bwd_pallas`). For y = relu(x + bias) and the
// upstream gradient g, both [N,C,H,W]:
//
//   masked[n,c,h,w] = y > 0 ? g : 0         (the gradient of x)
//   dbias[c]        = sum_{n,h,w} masked    (the gradient of bias)
//
// bfloat16 (the type the JAX bench feeds its kernel): g, y and masked bf16,
// dbias float32, as the JAX kernel computes them: the predicate on y
// widened to f32 (`y.astype(f32) > 0`), masked g's bits or +0.0's (a -0.0
// in g where y > 0 passes through), and each masked value widened to f32
// before it is added.
//
// What bounds it on the H100: bytes. It reads g and y and writes masked
// once, 12 bytes an element in f32 and 6 in bf16, and does one compare and
// one add per element.
//
// Design: one pass. A block takes a chunk of up to kChunk elements of one
// (n, c) plane (grid: chunks of the plane, N*C planes), reads g and y with
// 16-byte loads where a plane's start is 16-byte aligned (HW a multiple of
// 4 in f32, of 8 in bf16), else with 8-byte loads where it is 8-byte
// aligned (bf16, HW a multiple of 4), else one element a thread, writes
// masked, and sums its chunk (warp shuffles, then the warps in order) into
// one f32 partial per block. A second kernel sums the partials of each
// channel over n and chunks in a fixed order, one block per channel: no
// atomics, so dbias does not depend on the order blocks run in.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 8192;  // elements of a plane per block

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// +0.0 of the element type
template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __ushort_as_bfloat16(0);
}

// V elements loaded and stored as one access of V * sizeof(T) bytes
template <typename T, int V>
struct alignas(V * sizeof(T)) Vec {
  T x[V];
};

// the sum of V values in pairs: (x0 + x1) + (x2 + x3), ...
template <int V>
__device__ __forceinline__ float pair_sum(const float (&v)[V]) {
  float t[V];
#pragma unroll
  for (int i = 0; i < V; ++i) t[i] = v[i];
#pragma unroll
  for (int w = 1; w < V; w *= 2) {
#pragma unroll
    for (int i = 0; i + w < V; i += 2 * w) t[i] += t[i + w];
  }
  return t[0];
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
mask_kernel(const T* __restrict__ g, const T* __restrict__ y,
            T* __restrict__ masked, float* __restrict__ part, int HW) {
  const size_t plane = static_cast<size_t>(blockIdx.y) * HW;
  const int lo = blockIdx.x * kChunk;
  const int hi = min(HW, lo + kChunk);
  const auto* gv = reinterpret_cast<const Vec<T, V>*>(g + plane);
  const auto* yv = reinterpret_cast<const Vec<T, V>*>(y + plane);
  auto* mv = reinterpret_cast<Vec<T, V>*>(masked + plane);
  float s = 0.f;
  // V divides HW and kChunk, so a chunk is whole vectors
  for (int i = lo / V + threadIdx.x; i < hi / V; i += kThreads) {
    const Vec<T, V> gg = gv[i];
    const Vec<T, V> yy = yv[i];
    Vec<T, V> mm;
    float f[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      mm.x[j] = widen(yy.x[j]) > 0.f ? gg.x[j] : zero<T>();
      f[j] = widen(mm.x[j]);
    }
    mv[i] = mm;
    s += pair_sum(f);
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

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T>
int bias_relu_bwd(const void* g, const void* y, void* masked, void* dbias,
                  void* part, int N, int C, int HW, void* stream) {
  if (N <= 0 || C <= 0 || HW <= 0 || static_cast<long long>(N) * C > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int chunks = (HW + kChunk - 1) / kChunk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* gt = static_cast<const T*>(g);
  const T* yt = static_cast<const T*>(y);
  T* mt = static_cast<T*>(masked);
  float* pf = static_cast<float*>(part);
  const dim3 grid(chunks, N * C);
  // every plane starts on a multiple of `bytes` where HW * sizeof(T) and
  // the three base pointers are
  auto fits = [&](int elems) {
    const int bytes = elems * static_cast<int>(sizeof(T));
    return HW % elems == 0 && aligned(g, bytes) && aligned(y, bytes) &&
           aligned(masked, bytes);
  };
  constexpr int kV16 = 16 / sizeof(T);
  if (fits(kV16)) {
    mask_kernel<T, kV16><<<grid, kThreads, 0, st>>>(gt, yt, mt, pf, HW);
  } else if (kV16 > 4 && fits(4)) {
    mask_kernel<T, 4><<<grid, kThreads, 0, st>>>(gt, yt, mt, pf, HW);
  } else {
    mask_kernel<T, 1><<<grid, kThreads, 0, st>>>(gt, yt, mt, pf, HW);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  channel_sum_kernel<<<C, kThreads, 0, st>>>(pf, static_cast<float*>(dbias),
                                             N, C, chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. g, y, masked are device pointers of
// contiguous [N,C,H,W] tensors, float32 (_f32) or bfloat16 (_bf16), with
// HW = H*W; dbias [C] float32, and part the caller's scratch of
// N*C*ceil(HW/8192) floats; `stream` is a cudaStream_t. Each returns the
// first launch error (cudaGetLastError), 0 on success.
extern "C" int bias_relu_bwd_f32(const void* g, const void* y, void* masked,
                                 void* dbias, void* part, int N, int C,
                                 int HW, void* stream) {
  return bias_relu_bwd<float>(g, y, masked, dbias, part, N, C, HW, stream);
}

extern "C" int bias_relu_bwd_bf16(const void* g, const void* y, void* masked,
                                  void* dbias, void* part, int N, int C,
                                  int HW, void* stream) {
  return bias_relu_bwd<__nv_bfloat16>(g, y, masked, dbias, part, N, C, HW,
                                      stream);
}
