// Fused 2x2/stride-2 max pool + ReLU, forward and backward, float32, for
// Hopper.
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

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
pool2x2_relu_fwd_kernel(const float* __restrict__ x, float* __restrict__ y,
                        int64_t planes, int H, int W) {
  const int H2 = H / 2, W2 = W / 2;
  const int64_t n = planes * H2 * W2;
  for (int64_t o = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       o < n; o += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int j = static_cast<int>(o % W2);
    const int64_t t = o / W2;
    const int i = static_cast<int>(t % H2);
    const int64_t plane = t / H2;
    const float* r0 = x + (plane * H + 2 * i) * W + 2 * j;
    const float2 a = *reinterpret_cast<const float2*>(r0);
    const float2 c = *reinterpret_cast<const float2*>(r0 + W);
    // torch's scan: replace on a strictly greater value or a NaN
    float mx = a.x;
    if (a.y > mx || isnan(a.y)) mx = a.y;
    if (c.x > mx || isnan(c.x)) mx = c.x;
    if (c.y > mx || isnan(c.y)) mx = c.y;
    y[o] = mx < 0.f ? 0.f : mx;  // relu, NaN passes as in torch
  }
}

__global__ void __launch_bounds__(kThreads)
pool2x2_relu_bwd_kernel(const float* __restrict__ x,
                        const float* __restrict__ y,
                        const float* __restrict__ g, float* __restrict__ dx,
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
    const float2 a = *reinterpret_cast<const float2*>(x + at);
    const float2 c = *reinterpret_cast<const float2*>(x + at + W);
    const float yo = y[o];
    const float go = yo > 0.f ? g[o] : 0.f;
    // first-max priority chain, row-major window order
    const bool w00 = a.x == yo;
    const bool w01 = !w00 && a.y == yo;
    const bool w10 = !w00 && !w01 && c.x == yo;
    const bool w11 = !w00 && !w01 && !w10 && c.y == yo;
    *reinterpret_cast<float2*>(dx + at) =
        make_float2(w00 ? go : 0.f, w01 ? go : 0.f);
    *reinterpret_cast<float2*>(dx + at + W) =
        make_float2(w10 ? go : 0.f, w11 ? go : 0.f);
  }
}

int grid_for(int64_t n) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  // a grid-stride loop covers what one launch's grid does not
  return static_cast<int>(blocks < (1 << 30) ? blocks : (1 << 30));
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers of contiguous
// float32 NCHW tensors, `planes` = N*C; H and W are even. `stream` is a
// cudaStream_t. Each returns the launch status (cudaGetLastError).
extern "C" int pool2x2_relu_fwd_f32(const void* x, void* y, int64_t planes,
                                    int H, int W, void* stream) {
  if (planes <= 0 || H <= 0 || W <= 0 || H % 2 || W % 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n = planes * (H / 2) * (W / 2);
  pool2x2_relu_fwd_kernel<<<grid_for(n), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), planes, H, W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pool2x2_relu_bwd_f32(const void* x, const void* y,
                                    const void* g, void* dx, int64_t planes,
                                    int H, int W, void* stream) {
  if (planes <= 0 || H <= 0 || W <= 0 || H % 2 || W % 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n = planes * (H / 2) * (W / 2);
  pool2x2_relu_bwd_kernel<<<grid_for(n), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(g), static_cast<float*>(dx), planes, H, W);
  return static_cast<int>(cudaGetLastError());
}
