// Tile blend forward for Hopper (sm_90a): front-to-back alpha compositing of
// each 16x16 tile's depth-sorted pair segment.
//
// Replaces the TPU kernel blend_forward_pallas
// (binocular3dgs_tpu/ops/blend_pallas.py: _forward_kernel / _forward_tile).
// Contract (the CUDA renderCUDA forward, SURVEY.md §3.5): for every pixel of
// tile t, walk the pairs [tile_start[t], tile_start[t] + tile_count[t]) of
// the field-major record table (rows 0-1 mx,my; 2-4 conic a,b,c; 5 opacity;
// 6-8 rgb; 9 depth) in order; alpha = min(0.99, op * exp(power)), skipped if
// power > 0 or alpha < 1/255; a pixel stops BEFORE the pair that would take
// its transmittance below 1e-4. Outputs the planes r, g, b, depth
// (unnormalized alpha-weighted), T_final as out5 (5, T, 256) and
// n_contrib (T, 256) = index + 1, within the segment, of the last blended
// pair. Every pixel of every tile is computed, including those past the
// image edge in the last tile row and column; the caller crops them.
//
// What bounds it on the card: the data moved is small (about 40 B per valid
// pair read plus 24 B per pixel written: ~45 MB at 100k gaussians, 1008x756,
// 6 pairs per gaussian), so the bound is arithmetic: one expf and about 15
// FP32 operations per pair-pixel evaluation, times the pairs each pixel
// evaluates before it terminates.
//
// Design (simple first): one block per tile, one thread per pixel. The
// block walks its segment in batches of 256 pairs; each thread stages one
// pair's 10 live fields into shared memory (10 KB per batch, coalesced
// row-wise loads), then every thread blends the batch for its pixel reading
// the staged records as shared-memory broadcasts. The block leaves once no
// pixel is still blending (__syncthreads_count). Left for a later change:
// several pixels per thread held in registers (fewer shared loads per
// evaluation), per-warp culling of pairs whose ellipse misses the warp's
// pixels, and TMA-fed double-buffered record staging so loads overlap the
// blend.
#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace b3dgs {

constexpr int kBatch = kTilePixels;  // pairs staged per batch: one per thread

__global__ void __launch_bounds__(kTilePixels)
    blend_forward_kernel(const float* __restrict__ records, long long stride,
                         const int* __restrict__ tile_start, const int* __restrict__ tile_count,
                         int TW, int num_tiles, float* __restrict__ out5,
                         int* __restrict__ n_contrib) {
  __shared__ float s_rec[kLiveRows][kBatch];

  const int t = blockIdx.x;
  const int s = threadIdx.x;
  const float px = static_cast<float>((t % TW) * kTileSize + s % kTileSize);
  const float py = static_cast<float>((t / TW) * kTileSize + s / kTileSize);
  const long long start = tile_start[t];
  const int count = tile_count[t];

  float T = 1.0f, r = 0.0f, g = 0.0f, b = 0.0f, z = 0.0f;
  int last = 0;
  bool done = false;

  for (int base = 0; base < count; base += kBatch) {
    // also the barrier that keeps the previous batch's readers ahead of the
    // writes below
    if (__syncthreads_count(!done) == 0) break;
    const int k = base + s;
    if (k < count) {
#pragma unroll
      for (int f = 0; f < kLiveRows; ++f) s_rec[f][s] = records[f * stride + start + k];
    }
    __syncthreads();
    const int n = min(kBatch, count - base);
    for (int j = 0; j < n && !done; ++j) {
      const float alpha = splat_alpha(s_rec[0][j], s_rec[1][j], s_rec[2][j], s_rec[3][j],
                                      s_rec[4][j], s_rec[5][j], px, py);
      if (alpha == 0.0f) continue;
      const float test_T = T * (1.0f - alpha);
      if (test_T < kTransmittanceMin) {
        done = true;
        break;
      }
      const float w = alpha * T;
      r += w * s_rec[6][j];
      g += w * s_rec[7][j];
      b += w * s_rec[8][j];
      z += w * s_rec[9][j];
      T = test_T;
      last = base + j + 1;
    }
  }

  const long long plane = static_cast<long long>(num_tiles) * kTilePixels;
  const long long o = static_cast<long long>(t) * kTilePixels + s;
  out5[o] = r;
  out5[plane + o] = g;
  out5[2 * plane + o] = b;
  out5[3 * plane + o] = z;
  out5[4 * plane + o] = T;
  n_contrib[o] = last;
}

}  // namespace b3dgs

// records: (R >= 10, stride) float32, row-major; tile_start/tile_count:
// (num_tiles,) int32; out5: (5, num_tiles, 256) float32; n_contrib:
// (num_tiles, 256) int32. Launches on `stream`; returns cudaGetLastError().
extern "C" int b3dgs_blend_forward(const float* records, long long stride, const int* tile_start,
                                   const int* tile_count, int TW, int num_tiles, float* out5,
                                   int* n_contrib, void* stream) {
  if (num_tiles > 0) {
    b3dgs::blend_forward_kernel<<<num_tiles, b3dgs::kTilePixels, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        records, stride, tile_start, tile_count, TW, num_tiles, out5, n_contrib);
  }
  return static_cast<int>(cudaGetLastError());
}
