// Fused 2x2/stride-2 max pool + ReLU, forward and backward, float32 and
// bfloat16, for Hopper.
//
// Replaces the Pallas TPU kernels `_fwd_kernel` and `_bwd_kernel` of
// ct_tpu/ops/pool_packed_pallas.py (reached through `pool2x2_packed_relu`),
// the pool that closes the conv1 stage in training. On the TPU they work on
// an x-pair-packed NHWC layout that fills 128 lanes; here the tensors are
// plain NCHW, x [N,C,H,W] -> y [N,C,H/2,W/2] with H and W even.
//
//   forward:  y = relu(max of the 2x2 window)
//   backward: dx gets g at the FIRST window element equal to the rectified
//             output y, in row-major window order (0,0), (0,1), (1,0), (1,1),
//             and 0 elsewhere; where y <= 0 the ReLU kills g and dx is 0.
//
// That is the gradient torch's autograd gives for F.relu then F.max_pool2d
// (max_pool2d keeps the first maximum: its scan replaces the index only on
// a strictly greater value or a NaN), bit for bit: g is moved, never
// combined with anything.
//
// What bounds it on the H100: memory. The forward reads x once and writes y
// (5/4 of x's bytes); the backward reads x, y and g and writes dx (9/4).
// Design: one thread per output element; windows do not overlap, so every
// input element belongs to one thread and the backward needs no atomics and
// no zero fill. A thread reads (writes) its window's two rows as float2 pairs,
// so neighbouring threads touch neighbouring 8-byte words: both directions
// coalesce.
//
// bfloat16 (`train.py --bf16`): the same kernels on bf16 x, y, g and dx, a
// window's two rows read as bf16 pairs. The max, the ReLU and the
// comparisons run on the values widened to float32, which is exact, as the
// JAX kernel compares in f32; the result is bit for bit that of torch's
// autograd of F.relu then F.max_pool2d on the bf16 tensors.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// A pair of neighbouring elements, widened to float32, and back.
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// exact: a and b are bf16 values or zero
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pool2x2_relu_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                        int64_t planes, int H, int W) {
  const int H2 = H / 2, W2 = W / 2;
  const int64_t n = planes * H2 * W2;
  for (int64_t o = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       o < n; o += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int j = static_cast<int>(o % W2);
    const int64_t t = o / W2;
    const int i = static_cast<int>(t % H2);
    const int64_t plane = t / H2;
    const T* r0 = x + (plane * H + 2 * i) * W + 2 * j;
    const float2 a = load2(r0);
    const float2 c = load2(r0 + W);
    // torch's scan: replace on a strictly greater value or a NaN
    float mx = a.x;
    if (a.y > mx || isnan(a.y)) mx = a.y;
    if (c.x > mx || isnan(c.x)) mx = c.x;
    if (c.y > mx || isnan(c.y)) mx = c.y;
    y[o] = narrow<T>(mx < 0.f ? 0.f : mx);  // relu, NaN passes as in torch
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pool2x2_relu_bwd_kernel(const T* __restrict__ x, const T* __restrict__ y,
                        const T* __restrict__ g, T* __restrict__ dx,
                        int64_t planes, int H, int W) {
  const int H2 = H / 2, W2 = W / 2;
  const int64_t n = planes * H2 * W2;
  for (int64_t o = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       o < n; o += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int j = static_cast<int>(o % W2);
    const int64_t t = o / W2;
    const int i = static_cast<int>(t % H2);
    const int64_t plane = t / H2;
    const int64_t at = (plane * H + 2 * i) * W + 2 * j;
    const float2 a = load2(x + at);
    const float2 c = load2(x + at + W);
    const float yo = widen(y[o]);
    const float go = yo > 0.f ? widen(g[o]) : 0.f;
    // first-max priority chain, row-major window order
    const bool w00 = a.x == yo;
    const bool w01 = !w00 && a.y == yo;
    const bool w10 = !w00 && !w01 && c.x == yo;
    const bool w11 = !w00 && !w01 && !w10 && c.y == yo;
    store2(dx + at, w00 ? go : 0.f, w01 ? go : 0.f);
    store2(dx + at + W, w10 ? go : 0.f, w11 ? go : 0.f);
  }
}

int grid_for(int64_t n) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  // a grid-stride loop covers what one launch's grid does not
  return static_cast<int>(blocks < (1 << 30) ? blocks : (1 << 30));
}

template <typename T>
int fwd(const void* x, void* y, int64_t planes, int H, int W, void* stream) {
  if (planes <= 0 || H <= 0 || W <= 0 || H % 2 || W % 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n = planes * (H / 2) * (W / 2);
  pool2x2_relu_fwd_kernel<T><<<grid_for(n), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(y), planes, H, W);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd(const void* x, const void* y, const void* g, void* dx,
        int64_t planes, int H, int W, void* stream) {
  if (planes <= 0 || H <= 0 || W <= 0 || H % 2 || W % 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n = planes * (H / 2) * (W / 2);
  pool2x2_relu_bwd_kernel<T><<<grid_for(n), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(g), static_cast<T*>(dx), planes, H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers of contiguous
// NCHW tensors, float32 (_f32) or bfloat16 (_bf16), `planes` = N*C; H and W
// are even. `stream` is a cudaStream_t. Each returns the launch status
// (cudaGetLastError).
extern "C" int pool2x2_relu_fwd_f32(const void* x, void* y, int64_t planes,
                                    int H, int W, void* stream) {
  return fwd<float>(x, y, planes, H, W, stream);
}

extern "C" int pool2x2_relu_bwd_f32(const void* x, const void* y,
                                    const void* g, void* dx, int64_t planes,
                                    int H, int W, void* stream) {
  return bwd<float>(x, y, g, dx, planes, H, W, stream);
}

extern "C" int pool2x2_relu_fwd_bf16(const void* x, void* y, int64_t planes,
                                     int H, int W, void* stream) {
  return fwd<__nv_bfloat16>(x, y, planes, H, W, stream);
}

extern "C" int pool2x2_relu_bwd_bf16(const void* x, const void* y,
                                     const void* g, void* dx, int64_t planes,
                                     int H, int W, void* stream) {
  return bwd<__nv_bfloat16>(x, y, g, dx, planes, H, W, stream);
}
