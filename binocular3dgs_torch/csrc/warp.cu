// Horizontal inverse warp for Hopper (sm_90a): forward (W1) and its
// transpose (W2), the binocular-consistency core of the training step.
//
// W1 replaces the TPU kernel warp_forward_pallas and W2 replaces
// warp_backward_pallas (binocular3dgs_tpu/ops/warp_pallas.py: _fwd_kernel,
// _bwd_kernel). Contract (reference utils/graphics_utils.py:80-125): for
// pixel (r, x) with disparity d, x0 = floor(d), w1 = d - x0, w0 = 1 - w1,
// c0 = x + x0; the pixel is valid when c0 >= 0 and c0 + 1 < W, and then
//   out[c, r, x]  = w0 * img[c, r, c0] + w1 * img[c, r, c0 + 1]
//   diff[c, r, x] = img[c, r, c0 + 1] - img[c, r, c0]   (d out / d d)
// and both are 0 on invalid pixels. W2 is the transpose scatter
//   d_img[c, r, c0] += w0 * d_out[c, r, x], d_img[c, r, c0 + 1] += w1 * d_out
// over valid pixels. The disparity cotangent sum_c diff * d_out is formed
// outside the kernels (ops/warp.py).
//
// What bounds them on the card: bytes. W1 reads the disparity and two
// image taps per channel and writes out and diff (~40 B per pixel, ~30 MB
// at 1008x756); W2 reads the disparity and d_out and writes d_img (~28 B
// per pixel). A few FP32 operations per pixel are far below the card's
// rate, so each is bound by the 3.35 TB/s of device memory.
//
// Design (simple first): W1 is one thread per pixel for all channels, two
// loads per channel (the taps of neighbouring threads are neighbouring
// addresses, so the loads coalesce). W2 gives each image row a block: the
// row's C x W accumulators live in shared memory (12 KB at W = 1008),
// collisions between pixels of the row go to shared-memory atomicAdd, and
// the row is written once, coalesced; no two blocks touch the same row, so
// nothing is accumulated in device memory. The TPU kernels' shift-
// accumulate loop over the block's disparity range, their 8-row blocks and
// 128-lane padding exist only because a TPU gather is slow and are not
// carried over. The order of W2's atomics varies from run to run, so its
// sums are exact only up to the order of a few float32 additions.
#include <cuda_runtime.h>

namespace b3dgs {

constexpr int kWarpThreads = 256;

struct WarpTap {
  int c0;  // left tap column, clamped into the row
  int c1;  // right tap column, clamped into the row
  float w0, w1;
  bool valid;
};

__device__ __forceinline__ WarpTap warp_tap(float d, int x, int W) {
  WarpTap t;
  const float x0 = floorf(d);
  const int c0 = x + static_cast<int>(x0);
  t.valid = c0 >= 0 && c0 + 1 < W;
  t.w1 = d - x0;
  t.w0 = 1.0f - t.w1;
  t.c0 = min(max(c0, 0), W - 1);
  t.c1 = min(max(c0 + 1, 0), W - 1);
  return t;
}

__global__ void __launch_bounds__(kWarpThreads)
    warp_forward_kernel(const float* __restrict__ image, const float* __restrict__ disparity,
                        int C, int H, int W, float* __restrict__ out, float* __restrict__ diff) {
  const long long HW = static_cast<long long>(H) * W;
  const long long i = static_cast<long long>(blockIdx.x) * kWarpThreads + threadIdx.x;
  if (i >= HW) return;
  const int x = static_cast<int>(i % W);
  const long long row = i - x;
  const WarpTap t = warp_tap(disparity[i], x, W);
  for (int c = 0; c < C; ++c) {
    const float g0 = image[c * HW + row + t.c0];
    const float g1 = image[c * HW + row + t.c1];
    out[c * HW + i] = t.valid ? t.w0 * g0 + t.w1 * g1 : 0.0f;
    diff[c * HW + i] = t.valid ? g1 - g0 : 0.0f;
  }
}

__global__ void __launch_bounds__(kWarpThreads)
    warp_backward_kernel(const float* __restrict__ disparity, const float* __restrict__ d_out,
                         int C, int H, int W, float* __restrict__ d_image) {
  extern __shared__ float s_acc[];  // (C, W) accumulators of this row
  const long long HW = static_cast<long long>(H) * W;
  const long long row = static_cast<long long>(blockIdx.x) * W;
  for (int i = threadIdx.x; i < C * W; i += kWarpThreads) s_acc[i] = 0.0f;
  __syncthreads();
  for (int x = threadIdx.x; x < W; x += kWarpThreads) {
    const WarpTap t = warp_tap(disparity[row + x], x, W);
    if (!t.valid) continue;
    for (int c = 0; c < C; ++c) {
      const float g = d_out[c * HW + row + x];
      atomicAdd(&s_acc[c * W + t.c0], t.w0 * g);
      atomicAdd(&s_acc[c * W + t.c1], t.w1 * g);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < C * W; i += kWarpThreads) {
    const int c = i / W;
    d_image[c * HW + row + (i - c * W)] = s_acc[i];
  }
}

}  // namespace b3dgs

// image, out, diff: (C, H, W) float32; disparity: (H, W) float32. Launches
// on `stream`; returns cudaGetLastError().
extern "C" int b3dgs_warp_forward(const float* image, const float* disparity, int C, int H, int W,
                                  float* out, float* diff, void* stream) {
  const long long HW = static_cast<long long>(H) * W;
  if (HW > 0) {
    const unsigned blocks = static_cast<unsigned>((HW + b3dgs::kWarpThreads - 1) /
                                                  b3dgs::kWarpThreads);
    b3dgs::warp_forward_kernel<<<blocks, b3dgs::kWarpThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(image, disparity, C, H, W,
                                                                      out, diff);
  }
  return static_cast<int>(cudaGetLastError());
}

// disparity: (H, W) float32; d_out, d_image: (C, H, W) float32; d_image is
// written whole. Shared memory per block is C * W * 4 bytes (raised past the
// 48 KB default where needed, up to the card's per-block limit).
extern "C" int b3dgs_warp_backward(const float* disparity, const float* d_out, int C, int H,
                                   int W, float* d_image, void* stream) {
  if (H > 0 && W > 0 && C > 0) {
    const size_t smem = static_cast<size_t>(C) * W * sizeof(float);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          b3dgs::warp_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    b3dgs::warp_backward_kernel<<<H, b3dgs::kWarpThreads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(disparity, d_out, C, H, W,
                                                                       d_image);
  }
  return static_cast<int>(cudaGetLastError());
}
