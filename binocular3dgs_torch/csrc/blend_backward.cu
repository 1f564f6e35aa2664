// Tile blend backward for Hopper (sm_90a): per-pair cotangents of the
// front-to-back compositing of csrc/blend_forward.cu.
//
// Replaces the TPU kernel blend_backward_pallas
// (binocular3dgs_tpu/ops/blend_pallas.py: _backward_kernel /
// _backward_tile). Contract (the CUDA renderCUDA backward, SURVEY.md §3.5,
// at the record level of binocular3dgs_tpu/ops/blend.py:
// blend_backward_xla): every pixel of tile t walks the pairs of its
// segment below its n_contrib from back to front, rebuilds the
// transmittance before each pair by division from T_final
// (T /= max(1 - alpha, 0.01)), carries the suffix sum of w * r, where
// r = d_r*r + d_g*g + d_b*b + d_depth*depth is the d_out-weighted colour
// response, and forms
//   d_alpha = T * r - (suffix + d_Tfinal * T_final) / (1 - alpha),
// zero where the pair did not blend or its alpha was clamped at 0.99. The
// ten cotangents d_mx, d_my, d_a, d_b, d_c, d_op, d_r, d_g, d_b, d_depth of
// each pair are summed over the tile's 256 pixels and written once into
// d_records (row order of blend_pallas.py:714-718).
//
// What bounds it on the card: it reads 40 B per walked pair and 28 B per
// pixel and writes 40 B per walked pair (~35 MB at the chip_smoke
// workload), so the bound is arithmetic: the alpha (one expf and ~15 FP32
// instructions) for every pair below a pixel's n_contrib, ~45 more for
// each pair that blended there, and the sums over the tile's pixels.
//
// Design (simple first): one block per tile, one thread per pixel. The
// block finds the tile's largest n_contrib and walks its segment back to
// front in batches of 64 pairs staged in shared memory (2.5 KB). For each
// pair every thread computes its ten terms (zeros where the pair misses
// it); a warp whose 32 pixels all miss the pair skips the reduction
// (__any_sync), the others sum by shuffles, and each warp leaves its ten
// partials in shared memory (20 KB per batch). After the batch the block
// adds the 8 warps' partials of each (field, pair) and writes it.
// Hazards the TPU kernel did not have, and how this one avoids them:
//  * blocks run in any order and in parallel, so nothing is accumulated
//    across blocks: each pair lies in exactly one tile's segment and is
//    written once (the TPU kernel's read-add-write on windows shared by
//    two tiles was safe only on its sequential grid);
//  * slots outside every walked segment stay as the wrapper zeroed them;
//  * alpha comes from splat_eval (csrc/blend_common.cuh), the forward's own
//    expression, under the same flags, so both kernels gate each pair
//    alike.
// Left for a later change: several pixels per thread, culling a batch's
// pairs against the tile's live pixels before the per-pair work, and TMA
// staging.
#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace b3dgs {

constexpr int kBwdBatch = 64;  // pairs staged per batch
constexpr int kWarps = kTilePixels / 32;
constexpr unsigned kFullMask = 0xffffffffu;

__global__ void __launch_bounds__(kTilePixels)
    blend_backward_kernel(const float* __restrict__ records, long long stride,
                          const int* __restrict__ tile_start, const int* __restrict__ tile_count,
                          const float* __restrict__ out5, const int* __restrict__ n_contrib,
                          const float* __restrict__ d_out5, int TW, int num_tiles,
                          float* __restrict__ d_records) {
  __shared__ float s_rec[kLiveRows][kBwdBatch];
  __shared__ float s_part[kWarps][kLiveRows][kBwdBatch];
  __shared__ int s_walk;

  const int t = blockIdx.x;
  const int s = threadIdx.x;
  const int lane = s & 31;
  const int warp = s >> 5;
  const float px = static_cast<float>((t % TW) * kTileSize + s % kTileSize);
  const float py = static_cast<float>((t / TW) * kTileSize + s / kTileSize);
  const long long start = tile_start[t];
  const int count = tile_count[t];

  const long long plane = static_cast<long long>(num_tiles) * kTilePixels;
  const long long o = static_cast<long long>(t) * kTilePixels + s;
  const float T_final = out5[4 * plane + o];
  const float d_r = d_out5[o];
  const float d_g = d_out5[plane + o];
  const float d_b = d_out5[2 * plane + o];
  const float d_z = d_out5[3 * plane + o];
  const float tfd = d_out5[4 * plane + o] * T_final;
  const int nc = n_contrib[o];

  if (s == 0) s_walk = 0;
  __syncthreads();
  const int warp_max = __reduce_max_sync(kFullMask, nc);
  if (lane == 0) atomicMax(&s_walk, warp_max);
  __syncthreads();
  const int n_walk = min(s_walk, count);

  float T = T_final;
  float suffix = 0.0f;  // sum of w * r over the pairs behind the current one
  for (int base = n_walk > 0 ? ((n_walk - 1) / kBwdBatch) * kBwdBatch : -1; base >= 0;
       base -= kBwdBatch) {
    const int n = min(kBwdBatch, n_walk - base);
    __syncthreads();  // the previous batch's readers of s_rec and s_part are done
    for (int i = s; i < kLiveRows * kBwdBatch; i += kTilePixels) {
      const int f = i / kBwdBatch;
      const int j = i % kBwdBatch;
      if (j < n) s_rec[f][j] = records[f * stride + start + base + j];
    }
    __syncthreads();

    for (int j = n - 1; j >= 0; --j) {
      float v[kLiveRows];
#pragma unroll
      for (int f = 0; f < kLiveRows; ++f) v[f] = 0.0f;
      bool hit = false;
      if (base + j < nc) {
        const float ca = s_rec[2][j], cb = s_rec[3][j], cc = s_rec[4][j], op = s_rec[5][j];
        const SplatEval e = splat_eval(s_rec[0][j], s_rec[1][j], ca, cb, cc, op, px, py);
        if (e.alpha > 0.0f) {
          hit = true;
          const float one_minus = fmaxf(1.0f - e.alpha, kOneMinusFloor);
          T = T / one_minus;  // transmittance before this pair
          const float w = e.alpha * T;
          const float r = d_r * s_rec[6][j] + d_g * s_rec[7][j] + d_b * s_rec[8][j] +
                          d_z * s_rec[9][j];
          const float inv_om = 1.0f / one_minus;
          float d_alpha = T * r - inv_om * (suffix + tfd);
          suffix += w * r;
          if (!(op * e.G <= kAlphaClamp)) d_alpha = 0.0f;  // clamped alpha
          const float d_pow = e.alpha * d_alpha;
          v[0] = -(ca * e.dx + cb * e.dy) * d_pow;
          v[1] = -(cc * e.dy + cb * e.dx) * d_pow;
          v[2] = -0.5f * e.dx * e.dx * d_pow;
          v[3] = -e.dx * e.dy * d_pow;
          v[4] = -0.5f * e.dy * e.dy * d_pow;
          v[5] = e.G * d_alpha;
          v[6] = w * d_r;
          v[7] = w * d_g;
          v[8] = w * d_b;
          v[9] = w * d_z;
        }
      }
      if (__any_sync(kFullMask, hit)) {
#pragma unroll
        for (int f = 0; f < kLiveRows; ++f) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) v[f] += __shfl_down_sync(kFullMask, v[f], off);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int f = 0; f < kLiveRows; ++f) s_part[warp][f][j] = v[f];
      }
    }
    __syncthreads();

    for (int i = s; i < kLiveRows * n; i += kTilePixels) {
      const int f = i / n;
      const int j = i % n;
      float acc = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) acc += s_part[w][f][j];
      d_records[f * stride + start + base + j] = acc;
    }
  }
}

}  // namespace b3dgs

// records: (R >= 10, stride) float32; tile_start/tile_count: (num_tiles,)
// int32; out5, d_out5: (5, num_tiles, 256) float32; n_contrib:
// (num_tiles, 256) int32; d_records: (R, stride) float32, zeroed by the
// caller (only walked pairs of rows 0-9 are written). Launches on `stream`;
// returns cudaGetLastError().
extern "C" int b3dgs_blend_backward(const float* records, long long stride, const int* tile_start,
                                    const int* tile_count, const float* out5,
                                    const int* n_contrib, const float* d_out5, int TW,
                                    int num_tiles, float* d_records, void* stream) {
  if (num_tiles > 0) {
    b3dgs::blend_backward_kernel<<<num_tiles, b3dgs::kTilePixels, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
        records, stride, tile_start, tile_count, out5, n_contrib, d_out5, TW, num_tiles,
        d_records);
  }
  return static_cast<int>(cudaGetLastError());
}
