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
// at 1008x756); W2 reads the disparity and d_out and writes d_img (28 B per
// pixel, 21 MB). A few operations per pixel are far below the card's rates,
// so each is bound by the 3.35 TB/s of device memory. The TPU kernels'
// shift-accumulate loop over the block's disparity range, their 8-row
// blocks and 128-lane padding exist only because a TPU gather is slow and
// are not carried over.
//
// W1 is one thread per pixel for all channels, two loads per channel (the
// taps of neighbouring threads are neighbouring addresses, so the loads
// coalesce).
//
// W2 gives each image row a block (no two rows share a column, so nothing
// is accumulated in device memory) and sums each column in fixed point, so
// its output does not depend on the order of the additions: it is the same
// on every run and bit for bit the plain version's (ops/warp.py:
// warp_backward_torch).
//   1. The row's d_out is staged into shared memory by cp.async (16-byte
//      copies where the row is aligned), all in flight at once; the
//      thread's disparity loads (kept in registers) and the zeroing of the
//      sums overlap them.
//   2. M = max |d_out| over the row's valid pixels and all channels (finite
//      values only). With e from frexp(M) and L = ceil(log2 W), the scale is
//      2^s, s = 62 - e - L: every term t = w * d_out has |t| <= M < 2^e and
//      a column gathers at most W of them, so every scaled column sum fits
//      an int64. A term's rounding error is below 2^-s-1 <= W * 2^-61 * M:
//      exact to float32 for a column near its row's max, to that absolute
//      step for one far below it.
//   3. Each term, the float32 product w * d_out, becomes
//      q = round_half_even(t * 2^s) and is added to its column's int64 sum,
//      held as two 32-bit words in shared memory: a native atomicAdd on the
//      low word returns the old word, whose carry goes with q's high word
//      into the high word by a second one. (A 64-bit shared atomicAdd
//      compiles to a compare-and-swap loop on sm_90, which measured slower.)
//      Lanes take consecutive pixels, so their d_out reads are consecutive
//      words.
//   4. Each column's sum v becomes float32 once, correctly rounded. Where
//      s <= 126 (e >= -64 - L: at W = 1008 every row whose max is at least
//      2^-75), v * 2^-s is 0 or at least 2^-126, so float32(v) (one rounding) times 2^-s (exact) is the
//      correctly rounded result. Rows of smaller values take the general
//      path: v rounded to odd at 53 bits (exact in float64), scaled by 2^-s
//      in float64 (exact), then rounded to float32, subnormals included. A
//      row with M = 0 writes zeros.
//   Non-finite terms (from a non-finite d_out at a valid pixel) stay out of
//   the sums: each sets 2 bits of its column in a flag word (+inf: bit 0,
//   -inf: bit 1, NaN: both), and a column with flags writes what a float sum
//   of its terms would: NaN for both bits, else +inf or -inf.
// What holds it (chip_smoke width, W = 1008, C = 3; measured in PERF.md): the
// 756 rows run in one wave (6 blocks per SM), so the loads of all rows come
// first, then the sums, then the writes: the memory phases and the sums do
// not overlap. The sums cost per pixel and channel two 64-bit conversions
// (16 a clock on an SM) and four 32-bit shared atomics (the float32 kernel
// this replaces needed two atomics and no conversion), and per column one
// conversion back. Loops over a row run channel by channel, without a
// division by W (an integer division per element cost ~2 us of the kernel).
// Where the rendered depth is noisy, as there, neighbouring pixels rarely
// share an integer shift, so terms on one column cannot be merged in
// registers first, nor gathered per column without long divergent loops.
#include <cuda_runtime.h>

#include <cstdint>

namespace b3dgs {

constexpr int kWarpThreads = 256;              // W1's block
constexpr int kBwdThreads = 256;               // W2's block: one image row
constexpr int kFlagCols = 16;                  // columns per 32-bit flag word (2 bits each)
constexpr int kDispRegs = 4;                   // disparities a thread keeps in registers
// 756 rows of 1008 on 132 SMs run in one wave at 6 blocks per SM (37 KB of
// shared memory each)
constexpr int kBwdBlocksPerSM = 6;

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

// 2^n as a double, exact for -1022 <= n <= 1023
__device__ __forceinline__ double pow2(int n) {
  return __hiloint2double((n + 1023) << 20, 0);
}

// e of frexp(m) for a finite m >= 0 (0 for m = 0): m < 2^e
__device__ __forceinline__ int frexp_exponent(float m) {
  const unsigned b = __float_as_uint(m);
  if (b == 0) return 0;
  const int biased = static_cast<int>(b >> 23);
  return biased ? biased - 126 : (32 - __clz(b)) - 149;
}

// float32 of v * 2^-s, correctly rounded for any s (the header, step 4)
__device__ __forceinline__ float fixed_to_float(long long v, int s) {
  const unsigned long long a =
      v < 0 ? 0ull - static_cast<unsigned long long>(v) : static_cast<unsigned long long>(v);
  const int k = max(0, 64 - __clzll(a) - 53);
  unsigned long long t = a >> k;
  if (a & ((1ull << k) - 1ull)) t |= 1ull;  // round to odd: the dropped bits stay visible
  const double d = __ull2double_rn(t) * pow2(k - s);
  return __double2float_rn(v < 0 ? -d : d);
}

// finite test and non-finite class on the bits (no dependence on
// math-library overloads): +inf 1, -inf 2, NaN 3
__device__ __forceinline__ bool is_finite(float v) {
  return (__float_as_uint(v) & 0x7f800000u) != 0x7f800000u;
}
__device__ __forceinline__ unsigned nonfinite_code(float t) {
  return (__float_as_uint(t) & 0x7fffffffu) > 0x7f800000u ? 3u : (t > 0.0f ? 1u : 2u);
}

__device__ __forceinline__ void cp_async(void* smem, const void* gmem, bool vec16) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (vec16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem));
}

// Dynamic shared memory of a row block, for C channels and a row of W: the
// column sums as low and high 32-bit words (2 x C x Wp), the staged d_out
// (C x Wp float32) and the flag words (C x Wf), Wp = W rounded up to 4.
__host__ __device__ __forceinline__ size_t warp_backward_smem(int C, int W) {
  const size_t Wp = (static_cast<size_t>(W) + 3) & ~size_t{3};
  const size_t Wf = (Wp + kFlagCols - 1) / kFlagCols;
  return C * (3 * Wp + Wf) * sizeof(float);
}

// 2^n as a float32, for -126 <= n <= 127
__device__ __forceinline__ float pow2f(int n) { return __int_as_float((n + 127) << 23); }

// round_half_even(t * 2^s) as an int64, with 2^s = sa * sb, each factor a
// float32 (s = a + b, a = floor(s / 2)). Equal to the float64 product
// rounded: (t * sa) * sb is exact unless t * sa falls below float32's
// normal range, and then |t * 2^s| < 2^-126 * 2^105 < 1/2 and both round
// to 0.
__device__ __forceinline__ long long to_fixed(float t, float sa, float sb) {
  return __float2ll_rn(t * sa * sb);
}

// Adds the int64 q to a column held as two 32-bit words, lo and hi (hi:lo
// is the sum mod 2^64, see the header, step 3): add_low returns the old low
// word, whose carry add_high adds with q's high word.
__device__ __forceinline__ unsigned add_low(unsigned* lo, long long q) {
  return q ? atomicAdd(lo, static_cast<unsigned>(q)) : 0u;
}
__device__ __forceinline__ void add_high(unsigned* hi, long long q, unsigned old) {
  const unsigned ql = static_cast<unsigned>(q);
  const unsigned h = static_cast<unsigned>(q >> 32) + (old + ql < old ? 1u : 0u);
  if (q && h) atomicAdd(hi, h);
}

__global__ void __launch_bounds__(kBwdThreads, kBwdBlocksPerSM)
    warp_backward_kernel(const float* __restrict__ disparity, const float* __restrict__ d_out,
                         int C, int H, int W, float* __restrict__ d_image) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_wmax[kBwdThreads / 32];
  const int Wp = (W + 3) & ~3;
  unsigned* s_lo = reinterpret_cast<unsigned*>(smem);
  unsigned* s_hi = s_lo + static_cast<size_t>(C) * Wp;
  float* s_g = reinterpret_cast<float*>(s_hi + static_cast<size_t>(C) * Wp);
  unsigned* s_flag = reinterpret_cast<unsigned*>(s_g + static_cast<size_t>(C) * Wp);
  const int Wf = (Wp + kFlagCols - 1) / kFlagCols;
  const long long HW = static_cast<long long>(H) * W;
  const long long row = static_cast<long long>(blockIdx.x) * W;
  const float* disp = disparity + row;
  const int tid = threadIdx.x;

  // 1. stage the row's d_out (16-byte copies where W is a multiple of 4 and
  //    the base is aligned); the sums and flags are zeroed meanwhile
  const bool vec = (W & 3) == 0 && (reinterpret_cast<uintptr_t>(d_out) & 15) == 0;
  const int step = vec ? 4 : 1;
  for (int c = 0; c < C; ++c)
    for (int x = step * tid; x < W; x += step * kBwdThreads)
      cp_async(s_g + c * Wp + x, d_out + c * HW + row + x, vec);
  asm volatile("cp.async.commit_group;\n" ::);
  // the thread's first kDispRegs disparities stay in registers (all of them
  // for W <= kDispRegs * kBwdThreads); their loads overlap the copies.
  // Lanes take consecutive pixels: the loads coalesce, and the
  // shared-memory accesses below meet few bank conflicts.
  float dreg[kDispRegs];
#pragma unroll
  for (int k = 0; k < kDispRegs; ++k) {
    const int x = tid + k * kBwdThreads;
    dreg[k] = x < W ? __ldg(disp + x) : 0.0f;
  }
  // body(d, x) for each of the thread's pixels x with disparity d
  auto each_pixel = [&](auto&& body) {
#pragma unroll
    for (int k = 0; k < kDispRegs; ++k)
      if (tid + k * kBwdThreads < W) body(dreg[k], tid + k * kBwdThreads);
    for (int x = tid + kDispRegs * kBwdThreads; x < W; x += kBwdThreads) body(__ldg(disp + x), x);
  };
  for (int i = tid; i < C * Wp / 2; i += kBwdThreads)  // both words, 16 bytes a store
    reinterpret_cast<uint4*>(s_lo)[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < C * Wf; i += kBwdThreads) s_flag[i] = 0u;
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // 2. the row's max |d_out| over valid pixels (finite values)
  float m = 0.0f;
  each_pixel([&](float d, int x) {
    if (!warp_tap(d, x, W).valid) return;
    for (int c = 0; c < C; ++c) {
      const float g = s_g[c * Wp + x];
      if (is_finite(g)) m = fmaxf(m, fabsf(g));
    }
  });
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((tid & 31) == 0) s_wmax[tid >> 5] = m;
  __syncthreads();
  m = s_wmax[0];
#pragma unroll
  for (int w = 1; w < kBwdThreads / 32; ++w) m = fmaxf(m, s_wmax[w]);
  const int s = 62 - frexp_exponent(m) - (W > 1 ? 32 - __clz(W - 1) : 0);
  const float sa = pow2f(s >> 1), sb = pow2f(s - (s >> 1));

  // 3. the fixed-point scatter: a valid pixel's two terms per channel, low
  //    words first, then high words, so a thread waits once per channel
  bool flagged = false;
  each_pixel([&](float d, int x) {
    const WarpTap tap = warp_tap(d, x, W);
    if (!tap.valid) return;
    const int c0 = tap.c0;
    for (int c = 0; c < C; ++c) {
      const float g = s_g[c * Wp + x];
      const float t0 = tap.w0 * g, t1 = tap.w1 * g;
      if (!is_finite(g)) {  // then neither term is finite: flags, not sums
        unsigned* flags = s_flag + c * Wf;
        atomicOr(flags + c0 / kFlagCols, nonfinite_code(t0) << (2 * (c0 % kFlagCols)));
        atomicOr(flags + (c0 + 1) / kFlagCols,
                 nonfinite_code(t1) << (2 * ((c0 + 1) % kFlagCols)));
        flagged = true;
        continue;
      }
      const long long q0 = to_fixed(t0, sa, sb), q1 = to_fixed(t1, sa, sb);
      unsigned* lo = s_lo + c * Wp + c0;
      unsigned* hi = s_hi + c * Wp + c0;
      const unsigned old0 = add_low(lo, q0), old1 = add_low(lo + 1, q1);
      add_high(hi, q0, old0);
      add_high(hi + 1, q1, old1);
    }
  });
  flagged = __syncthreads_or(flagged);

  // 4. one conversion per column, written coalesced; a column with flags
  //    writes what a float sum of its terms would
  const bool one_rounding = s <= 126;
  const float unscale = one_rounding ? pow2f(-s) : 0.0f;
  for (int c = 0; c < C; ++c) {
    for (int x = tid; x < W; x += kBwdThreads) {
      const int k = c * Wp + x;
      const unsigned f =
          flagged ? (s_flag[c * Wf + x / kFlagCols] >> (2 * (x % kFlagCols))) & 3u : 0u;
      const long long v =
          static_cast<long long>((static_cast<unsigned long long>(s_hi[k]) << 32) | s_lo[k]);
      d_image[c * HW + row + x] =
          f ? __uint_as_float(f == 3u ? 0x7fc00000u : (f == 1u ? 0x7f800000u : 0xff800000u))
            : (one_rounding ? __ll2float_rn(v) * unscale : fixed_to_float(v, s));
    }
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
// written whole. Shared memory per block is warp_backward_smem(C, W) (12 B
// per channel and column; raised past the 48 KB default where needed, up to
// the card's per-block limit). The kernel asks for the largest shared
// carveout, so that 6 row blocks of the 1008-wide image fit one SM.
extern "C" int b3dgs_warp_backward(const float* disparity, const float* d_out, int C, int H,
                                   int W, float* d_image, void* stream) {
  if (H > 0 && W > 0 && C > 0) {
    const size_t smem = b3dgs::warp_backward_smem(C, W);
    cudaError_t err = cudaFuncSetAttribute(b3dgs::warp_backward_kernel,
                                           cudaFuncAttributePreferredSharedMemoryCarveout,
                                           cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess && smem > 48 * 1024)
      err = cudaFuncSetAttribute(b3dgs::warp_backward_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    b3dgs::warp_backward_kernel<<<H, b3dgs::kBwdThreads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(disparity, d_out, C, H, W,
                                                                       d_image);
  }
  return static_cast<int>(cudaGetLastError());
}
