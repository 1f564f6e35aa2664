// SSIM of the photometric loss for Hopper (sm_90a): the forward
// (ssim_forward_kernel, with ssim_forward_mean_kernel for the mean) and the
// backward (ssim_backward_kernel).
//
// Replaces no TPU kernel: the JAX package's SSIM (binocular3dgs_tpu/ops/
// losses.py) is XLA's convolutions and elementwise algebra, which XLA fuses.
// In PyTorch the reference's composition (ops/losses.py:ssim_torch, which
// the CPU runs) runs five 11x11 depthwise convolutions and ~20 elementwise operations
// forward, their input gradients and ~35 more backward, each over the whole
// image; at LLFF's 3x1512x2016 the two convolution kernels alone were the
// second and fourth largest device operations of a training step, and at
// Blender's 400x400 the ~60 launches are host dispatch (PERF.md §5).
//
// Contract: ops/losses.py. For N planes of H x W (N = B * C, one plane per
// image channel) and the 11-tap Gaussian g of sigma 1.5 (the caller's
// window, ops/losses.py:_gaussian_window), blur = the 11x11 window g x g
// with zero padding at every border, and per pixel
//   mu1 = blur(x), mu2 = blur(y), sxx = blur(x*x), syy = blur(y*y),
//   sxy = blur(x*y), s1 = sxx - mu1^2, s2 = syy - mu2^2, s12 = sxy - mu1*mu2
//   n1 = 2 mu1 mu2 + C1, n2 = 2 s12 + C2, d1 = mu1^2 + mu2^2 + C1,
//   d2 = s1 + s2 + C2, m = (n1 n2) / (d1 d2)      (C1 = 0.01^2, C2 = 0.03^2)
// in the reference's order of operations; the forward gives the mean of m
// over each of `groups` consecutive runs of planes (one per image, or one
// for all). With maps asked for, it also writes the derivatives of m in
// mu1, sxx and sxy with the other two held (the chain through s1 and s12
// taken):
//   dm/dmu1 = 2 mu2 (n2 - n1) / (d1 d2) + 2 mu1 m (1/d2 - 1/d1)
//   dm/dsxx = -m / d2,  dm/dsxy = 2 n1 / (d1 d2).
// The backward gives the gradient of x (y, the ground truth, needs none):
//   dL/dx = s * (blur(dm/dmu1) + 2 x blur(dm/dsxx) + y blur(dm/dsxy)),
// s = the group's upstream gradient / its element count: the window is
// symmetric and the zero-padded blur's adjoint is the same blur of the
// maps, zero outside the image. ops/losses.py:ssim_maps_torch and
// ssim_backward_torch compute the same in torch ops.
//
// The forward's blurs round as the reference's. Where a window holds a
// nearly flat patch, s1, s2 and s12 are differences of nearly equal sums,
// and m moves by their last bits over C2 (~1e-4 of m a pixel, with the same
// sign over a patch): a separable blur, rounding otherwise than the
// reference's 11x11 depthwise convolution, moved the mean SSIM of a
// Blender-cell render by ~4e-5 and put the benchmark's `block_loss_gap` at
// half its limit (PERF.md §6, the SSIM kernels' finding). So each forward
// blur is the convolution's own sum: per output, 121 fused multiply-adds
// from 0, window row outer and column inner, with the window g[kh] * g[kw]
// rounded once (PyTorch's conv_depthwise2d kernel, whose `value += w * x`
// nvcc contracts; the taps outside the image, which it skips, add zeros
// here). That is the order of PyTorch 2.11 built with CUDA 12.8
// (ops/losses.py:SSIM_CONV_PINNED); tests/test_torch_cuda.py fails where
// the plain blur leaves conv_depthwise2d or its sums change. The
// elementwise algebra after it is in the reference's order, one operation
// at a time (the library builds with --fmad=false), so the maps and the map
// equal the plain composition's on the card; only the mean sums otherwise.
// The backward's result goes into a gradient that autograd of the
// composition sums in its own order anyway, so it blurs separably.
//
// Determinism: every output has one writer, each block sums its values in
// a fixed order into one partial, and the mean kernel sums a group's
// partials in a fixed order (in double); no atomics. A training step that
// runs these kernels repeats bit for bit.
//
// What bounds them on the card. SSIM needs, a pixel-channel, its bytes:
// the forward reads x and y and writes the three maps (20 B, 183 MB at
// LLFF's size), the backward reads the maps, x and y and writes dx (24 B);
// and its instructions with separable blurs: the forward ~145 (110 taps),
// the backward ~72 (66 taps). The bytes bind both (44 B at 3.35 TB/s take
// 13 ps, 217 instructions at 33.5e12/s 6.5 ps). S1 as written runs 605
// taps, to round as the reference does: its own instructions take ~19 ps
// a pixel-channel, three times its byte bound, which is the price of that
// rounding (benchmark/metrics/train.ssim_roofline.py counts the 145). So a
// value is read from and written to device memory once, and the blurring
// happens in shared memory and registers:
//   * a block takes a tile of kTileH x kTileW outputs of one plane and loads
//     its inputs with the 5-pixel halo into shared memory (zeros outside the
//     image: the padding), once;
//   * the forward gives each thread kVRows outputs of one column: each
//     loaded value (and its products x*x, y*y, x*y, formed once) feeds the
//     taps of all of them that reach it, from registers, and the window
//     sits in the kernel's parameters (an operand of the multiply-add);
//   * the backward's horizontal pass gives each thread kHCols adjacent
//     outputs of a row (halo rows included), its vertical pass kVRows
//     outputs of one column, each horizontal sum read once from shared
//     memory.
// Tall tiles keep the vertical halo's extra work at 10/64; the row pitches
// are odd so that the horizontal pass's strided lanes (4 columns apart, 4
// rows to a warp) hit distinct banks. A block is 256 threads (25 KB and 66
// KB of shared memory).
#include <cuda_runtime.h>

namespace b3dgs {

constexpr int kWin = 11;
constexpr int kHalf = kWin / 2;
constexpr int kSsimThreads = 256;
constexpr int kTileW = 32;                      // output columns of a tile
constexpr int kTileH = 64;                      // output rows of a tile
constexpr int kHCols = 4;                       // horizontal outputs a thread
constexpr int kHGroups = kTileW / kHCols;       // 8 column groups a row
constexpr int kVRows = kTileH / (kSsimThreads / kTileW);  // 8 vertical outputs a thread
constexpr int kInW = kTileW + 2 * kHalf;        // 42 input columns
constexpr int kInH = kTileH + 2 * kHalf;        // 74 input rows
constexpr int kInPitch = kInW + 1;              // 43: odd, see the header
constexpr int kHPitch = kTileW + 1;             // 33
constexpr int kInPlane = kInH * kInPitch;
constexpr int kHPlane = kInH * kHPitch;
constexpr int kMeanThreads = 256;
// float32 of the reference's 0.01^2 and 0.03^2, as PyTorch casts the scalars
constexpr float kC1 = 1e-4f;
constexpr float kC2 = 9e-4f;

static_assert(kTileW == 32, "the vertical pass maps a warp onto a tile row");
static_assert(kTileH % (kSsimThreads / kTileW) == 0, "rows split evenly over the warps");

struct SsimWindow {
  float w[kWin];
};
struct SsimWindow2D {
  float w[kWin][kWin];  // w[kh][kw] = g[kh] * g[kw], rounded once, as the reference's window
};

// Loads Q planes' tile inputs with the halo (zeros outside the image) into
// shared memory, kInPlane floats apart.
template <int Q>
__device__ __forceinline__ void load_tile(const float* const (&src)[Q], float* s, int H, int W,
                                          int x0, int y0) {
  for (int i = threadIdx.x; i < kInH * kInW; i += kSsimThreads) {
    const int r = i / kInW, c = i - r * kInW;
    const int gy = y0 - kHalf + r, gx = x0 - kHalf + c;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const long long at = static_cast<long long>(gy) * W + gx;
#pragma unroll
    for (int q = 0; q < Q; ++q) s[q * kInPlane + r * kInPitch + c] = in ? src[q][at] : 0.0f;
  }
}

// The backward's horizontal pass over every row of the tile's inputs: the
// Q loaded planes' sums into `h`, kHPlane floats apart.
template <int Q>
__device__ __forceinline__ void horizontal(const float* s, float* h, const SsimWindow& win) {
  for (int item = threadIdx.x; item < kInH * kHGroups; item += kSsimThreads) {
    const int r = item / kHGroups, c0 = (item - r * kHGroups) * kHCols;
    float acc[Q][kHCols];
#pragma unroll
    for (int q = 0; q < Q; ++q)
#pragma unroll
      for (int j = 0; j < kHCols; ++j) acc[q][j] = 0.0f;
#pragma unroll
    for (int t = 0; t < kHCols + kWin - 1; ++t) {
      float v[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) v[q] = s[q * kInPlane + r * kInPitch + c0 + t];
#pragma unroll
      for (int j = 0; j < kHCols; ++j) {
        const int k = t - j;
        if (k >= 0 && k < kWin) {
#pragma unroll
          for (int q = 0; q < Q; ++q) acc[q][j] = __fmaf_rn(win.w[k], v[q], acc[q][j]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < Q; ++q)
#pragma unroll
      for (int j = 0; j < kHCols; ++j) h[q * kHPlane + r * kHPitch + c0 + j] = acc[q][j];
  }
}

// The backward's vertical pass: the Q blurred values of this thread's kVRows outputs
// (tile rows r0.., column `col`).
template <int Q>
__device__ __forceinline__ void vertical(const float* h, const SsimWindow& win, int r0, int col,
                                         float (&acc)[Q][kVRows]) {
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int i = 0; i < kVRows; ++i) acc[q][i] = 0.0f;
#pragma unroll
  for (int t = 0; t < kVRows + kWin - 1; ++t) {
    float v[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) v[q] = h[q * kHPlane + (r0 + t) * kHPitch + col];
#pragma unroll
    for (int i = 0; i < kVRows; ++i) {
      const int k = t - i;
      if (k >= 0 && k < kWin) {
#pragma unroll
        for (int q = 0; q < Q; ++q) acc[q][i] = __fmaf_rn(win.w[k], v[q], acc[q][i]);
      }
    }
  }
}

template <bool kMaps>
__global__ void __launch_bounds__(kSsimThreads, 3)
    ssim_forward_kernel(const float* __restrict__ x, const float* __restrict__ y, int H, int W,
                        const __grid_constant__ SsimWindow2D win, float* __restrict__ partials,
                        float* __restrict__ d_mu1, float* __restrict__ d_sxx,
                        float* __restrict__ d_sxy) {
  extern __shared__ float smem[];  // the x and y tiles with the halo
  __shared__ float warp_sums[kSsimThreads / 32];
  const long long plane = static_cast<long long>(blockIdx.z) * H * W;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const float* const src[2] = {x + plane, y + plane};
  load_tile<2>(src, smem, H, W, x0, y0);
  __syncthreads();

  // mu1, mu2, sxx, syy, sxy of this thread's kVRows outputs (tile rows
  // r0.., column col): each output sums its 121 taps as one fused
  // multiply-add chain from 0, window row outer and column inner, as the
  // reference's depthwise convolution does (its out-of-image taps skipped
  // there, zeros here: the same sums)
  const int col = threadIdx.x % kTileW, r0 = (threadIdx.x / kTileW) * kVRows;
  float acc[5][kVRows];
#pragma unroll
  for (int q = 0; q < 5; ++q)
#pragma unroll
    for (int i = 0; i < kVRows; ++i) acc[q][i] = 0.0f;
#pragma unroll
  for (int t = 0; t < kVRows + kWin - 1; ++t) {
#pragma unroll
    for (int kw = 0; kw < kWin; ++kw) {
      const float xv = smem[(r0 + t) * kInPitch + col + kw];
      const float yv = smem[kInPlane + (r0 + t) * kInPitch + col + kw];
      const float v[5] = {xv, yv, xv * xv, yv * yv, xv * yv};
#pragma unroll
      for (int i = 0; i < kVRows; ++i) {
        const int kh = t - i;
        if (kh >= 0 && kh < kWin) {
#pragma unroll
          for (int q = 0; q < 5; ++q) acc[q][i] = __fmaf_rn(win.w[kh][kw], v[q], acc[q][i]);
        }
      }
    }
  }
  const int gx = x0 + col;
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < kVRows; ++i) {
    const int gy = y0 + r0 + i;
    if (gx >= W || gy >= H) continue;
    const float mu1 = acc[0][i], mu2 = acc[1][i];
    const float mu1_sq = mu1 * mu1, mu2_sq = mu2 * mu2, mu1_mu2 = mu1 * mu2;
    const float s1 = acc[2][i] - mu1_sq, s2 = acc[3][i] - mu2_sq, s12 = acc[4][i] - mu1_mu2;
    const float n1 = 2.0f * mu1_mu2 + kC1, n2 = 2.0f * s12 + kC2;
    const float d1 = mu1_sq + mu2_sq + kC1, d2 = s1 + s2 + kC2;
    const float den = d1 * d2;
    const float m = (n1 * n2) / den;
    sum += m;
    if constexpr (kMaps) {
      const long long at = plane + static_cast<long long>(gy) * W + gx;
      d_mu1[at] = (2.0f * mu2 * (n2 - n1)) / den + 2.0f * mu1 * m * (1.0f / d2 - 1.0f / d1);
      d_sxx[at] = -m / d2;
      d_sxy[at] = (2.0f * n1) / den;
    }
  }
  // the block's partial sum, in a fixed order
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
#pragma unroll
    for (int w = 0; w < kSsimThreads / 32; ++w) total += warp_sums[w];
    partials[(static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y) * gridDim.x +
             blockIdx.x] = total;
  }
}

// One block a group: the mean of the group's `per_group` consecutive
// partials over its `elems` values, summed in double in a fixed order.
__global__ void __launch_bounds__(kMeanThreads)
    ssim_forward_mean_kernel(const float* __restrict__ partials, long long per_group,
                             long long elems, float* __restrict__ mean) {
  __shared__ double sums[kMeanThreads];
  const float* p = partials + blockIdx.x * per_group;
  double acc = 0.0;
  for (long long i = threadIdx.x; i < per_group; i += kMeanThreads) acc += p[i];
  sums[threadIdx.x] = acc;
  __syncthreads();
  for (int o = kMeanThreads / 2; o > 0; o >>= 1) {
    if (threadIdx.x < o) sums[threadIdx.x] += sums[threadIdx.x + o];
    __syncthreads();
  }
  if (threadIdx.x == 0) mean[blockIdx.x] = static_cast<float>(sums[0] / static_cast<double>(elems));
}

__global__ void __launch_bounds__(kSsimThreads, 3)
    ssim_backward_kernel(const float* __restrict__ x, const float* __restrict__ y,
                         const float* __restrict__ d_mu1, const float* __restrict__ d_sxx,
                         const float* __restrict__ d_sxy, const float* __restrict__ grad,
                         int planes_per_group, float group_elems, int H, int W,
                         const __grid_constant__ SsimWindow win, float* __restrict__ dx) {
  extern __shared__ float smem[];
  float* s = smem;                // the three maps' tiles with the halo
  float* h = smem + 3 * kInPlane;  // their horizontal sums
  const long long plane = static_cast<long long>(blockIdx.z) * H * W;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const float* const src[3] = {d_mu1 + plane, d_sxx + plane, d_sxy + plane};
  load_tile<3>(src, s, H, W, x0, y0);
  __syncthreads();
  horizontal<3>(s, h, win);
  __syncthreads();

  const int col = threadIdx.x % kTileW, r0 = (threadIdx.x / kTileW) * kVRows;
  float acc[3][kVRows];
  vertical<3>(h, win, r0, col, acc);
  const float scale = grad[blockIdx.z / planes_per_group] / group_elems;
  const int gx = x0 + col;
#pragma unroll
  for (int i = 0; i < kVRows; ++i) {
    const int gy = y0 + r0 + i;
    if (gx >= W || gy >= H) continue;
    const long long at = plane + static_cast<long long>(gy) * W + gx;
    const float xv = x[at], yv = y[at];
    dx[at] = scale * ((acc[0][i] + 2.0f * xv * acc[1][i]) + yv * acc[2][i]);
  }
}

constexpr size_t kForwardSmem = 2 * kInPlane * sizeof(float);
constexpr size_t kBackwardSmem = (3 * kInPlane + 3 * kHPlane) * sizeof(float);

inline dim3 ssim_grid(int N, int H, int W) {
  return dim3((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, N);
}

// S2's 66 KB of shared memory, above the 48 KB a launch gets unasked: the
// attributes are set once a process (S1's 25 KB need none).
inline cudaError_t backward_smem() {
  static const cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(ssim_backward_kernel,
                                         cudaFuncAttributePreferredSharedMemoryCarveout,
                                         cudaSharedmemCarveoutMaxShared);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssim_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kBackwardSmem));
    return e;
  }();
  return err;
}

inline SsimWindow window_from(const float* host) {
  SsimWindow win;
  for (int k = 0; k < kWin; ++k) win.w[k] = host[k];
  return win;
}

inline SsimWindow2D window2d_from(const float* host) {
  SsimWindow2D win;
  for (int kh = 0; kh < kWin; ++kh)
    for (int kw = 0; kw < kWin; ++kw) win.w[kh][kw] = host[kh] * host[kw];
  return win;
}

}  // namespace b3dgs

// x, y: N planes of H x W float32, contiguous; window: 11 floats on the
// host; groups divides N. Writes mean[groups] and, when d_mu1 is not null,
// the three maps (each N x H x W); partials is scratch of n_partials
// floats, at least one a tile of 64 x 32 outputs (N * ceil(H / 64) *
// ceil(W / 32)). Two launches on `stream`.
extern "C" int b3dgs_ssim_forward(const float* x, const float* y, int N, int H, int W,
                                  const float* window, int groups, float* partials,
                                  long long n_partials, float* mean, float* d_mu1, float* d_sxx,
                                  float* d_sxy, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || groups <= 0 || N % groups) return cudaErrorInvalidValue;
  const dim3 grid = b3dgs::ssim_grid(N, H, W);
  if (n_partials < static_cast<long long>(grid.x) * grid.y * grid.z) return cudaErrorInvalidValue;
  const b3dgs::SsimWindow2D win = b3dgs::window2d_from(window);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d_mu1 != nullptr)
    b3dgs::ssim_forward_kernel<true><<<grid, b3dgs::kSsimThreads, b3dgs::kForwardSmem, s>>>(
        x, y, H, W, win, partials, d_mu1, d_sxx, d_sxy);
  else
    b3dgs::ssim_forward_kernel<false><<<grid, b3dgs::kSsimThreads, b3dgs::kForwardSmem, s>>>(
        x, y, H, W, win, partials, nullptr, nullptr, nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long per_group = static_cast<long long>(grid.x) * grid.y * (N / groups);
  const long long elems = static_cast<long long>(N / groups) * H * W;
  b3dgs::ssim_forward_mean_kernel<<<groups, b3dgs::kMeanThreads, 0, s>>>(partials, per_group,
                                                                        elems, mean);
  return static_cast<int>(cudaGetLastError());
}

// x, y, the three maps: N planes of H x W float32, contiguous; grad: the
// upstream gradient of each of the forward's `groups` means (device);
// writes dx (N x H x W) whole. One launch on `stream`.
extern "C" int b3dgs_ssim_backward(const float* x, const float* y, const float* d_mu1,
                                   const float* d_sxx, const float* d_sxy, const float* grad,
                                   int N, int H, int W, const float* window, int groups, float* dx,
                                   void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || groups <= 0 || N % groups) return cudaErrorInvalidValue;
  const b3dgs::SsimWindow win = b3dgs::window_from(window);
  const cudaError_t err = b3dgs::backward_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int planes_per_group = N / groups;
  const float group_elems = static_cast<float>(static_cast<long long>(planes_per_group) * H * W);
  b3dgs::ssim_backward_kernel<<<b3dgs::ssim_grid(N, H, W), b3dgs::kSsimThreads,
                                b3dgs::kBackwardSmem, static_cast<cudaStream_t>(stream)>>>(
      x, y, d_mu1, d_sxx, d_sxy, grad, planes_per_group, group_elems, H, W, win, dx);
  return static_cast<int>(cudaGetLastError());
}
