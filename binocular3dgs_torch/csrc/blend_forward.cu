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
// What bounds it on the card: it reads 40 B per pair and 8 B per tile and
// writes 24 B per pixel (~33 MB at the chip_smoke workload, 0.010 ms at
// 3.35 TB/s); its arithmetic is ~16 FP32 instructions (one expf and the
// exponent) for each pair-pixel that blends. A dense walk evaluates every
// pair of the tile at every live pixel, ~5x the evaluations that blend: a
// pair's binning box, and the tile it covers, are far larger than the part
// of the tile its alpha >= 1/255 ellipse reaches.
//
// Design:
//  * several pixels per thread (kFwdPix = 2), each with T, r, g, b, depth
//    and n_contrib in registers; a pair's fields come from shared memory
//    once per thread, as three float4 of a pair-major table, for all its
//    pixels;
//  * per-cell culling (blend_common.cuh): the tile is 8 cells of 8x4
//    pixels, warp w holds cells 2w and 2w+1 (an 8x8 quadrant), one pixel of
//    each per lane. Each thread stages one pair of the batch and computes
//    its conservative alpha box (alpha_extent) and one bit per cell, set
//    when the box meets the cell (cell_mask). A warp ballots the bits of 32
//    pairs, walks only the pairs that may reach one of its cells, front to
//    back, and evaluates a pair only in those cells (a warp-uniform
//    branch). A culled pair has alpha = 0 at every pixel of the cell, which
//    a dense walk skips too, so every output bit and n_contrib (which counts
//    culled pairs in the index) are those of a dense walk;
//  * early exit: a warp stops walking once none of its pixels is live, and
//    the block leaves at a batch boundary once no thread is
//    (__syncthreads_count).
// Tried (build variants timed against each other on an NVIDIA H100 80GB
// HBM3 at 700 W, chip_smoke workload, profiler ms with L2 flushed; PERF.md
// has the table): 1 / 2 / 4 pixels per thread 0.125 / 0.123 / 0.141 (at
// the overdraw shape 0.147 / 0.134 / 0.150, hence 2); register caps
// (__launch_bounds__ min-blocks) spilled and lost; the dense one-pixel
// kernel this design replaced 0.182 in the same run (at the overdraw shape
// 0.133, where the large splats leave little to cull and early exit bounds
// both). Not done: cp.async or TMA staging. The staging thread needs the
// pair's fields in registers for its cull box anyway, and most tiles of
// the chip_smoke workload fit one 128-pair batch; a TMA tensor map would
// also need the pair capacity padded to a multiple of 4 and -lcuda.
#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace b3dgs {

constexpr int kFwdPix = 2;  // pixels per thread (1 and 4 measured slower, above)
constexpr int kFwdThreads = kTilePixels / kFwdPix;
constexpr int kFwdBatch = kFwdThreads;           // pairs staged per batch: one per thread
constexpr unsigned kFwdFull = 0xffffffffu;
static_assert(kFwdPix == 1 || kFwdPix == 2 || kFwdPix == 4, "1, 2 or 4 pixels per thread");

__global__ void __launch_bounds__(kFwdThreads)
    blend_forward_kernel(const float* __restrict__ records, long long stride,
                         const int* __restrict__ tile_start, const int* __restrict__ tile_count,
                         int TW, int num_tiles, float* __restrict__ out5,
                         int* __restrict__ n_contrib) {
  __shared__ float4 s_rec[kFwdBatch][3];  // mx my a b | c op r g | b depth - -
  __shared__ unsigned s_mask[kFwdBatch];  // bit c: the pair may blend cell c

  const int t = blockIdx.x;
  const int s = threadIdx.x;
  const int lane = s & 31;
  const int warp = s >> 5;
  const int tx0 = (t % TW) * kTileSize;
  const int ty0 = (t / TW) * kTileSize;
  const long long start = tile_start[t];
  const int count = tile_count[t];
  const int shift = warp * kFwdPix;  // this warp's cells: shift .. shift + kFwdPix - 1
  const unsigned my_cells = ((1u << kFwdPix) - 1) << shift;

  float px[kFwdPix], py[kFwdPix], T[kFwdPix], r[kFwdPix], g[kFwdPix], b[kFwdPix], z[kFwdPix];
  int last[kFwdPix];
#pragma unroll
  for (int i = 0; i < kFwdPix; ++i) {
    const int c = shift + i;
    px[i] = static_cast<float>(tx0 + kCellW * (c >> 2) + (lane & 7));
    py[i] = static_cast<float>(ty0 + kCellH * (c & 3) + (lane >> 3));
    T[i] = 1.0f;
    r[i] = g[i] = b[i] = z[i] = 0.0f;
    last[i] = 0;
  }
  unsigned live = (1u << kFwdPix) - 1;  // bit i: pixel i is still blending

  for (int base = 0; base < count; base += kFwdBatch) {
    // also the barrier that keeps the previous batch's readers ahead of the
    // writes below
    if (__syncthreads_count(live != 0) == 0) break;
    const int k = base + s;
    unsigned mask = 0;
    if (k < count) {
      float f[kLiveRows];
#pragma unroll
      for (int q = 0; q < kLiveRows; ++q) f[q] = records[q * stride + start + k];
      s_rec[s][0] = make_float4(f[0], f[1], f[2], f[3]);
      s_rec[s][1] = make_float4(f[4], f[5], f[6], f[7]);
      s_rec[s][2] = make_float4(f[8], f[9], 0.0f, 0.0f);
      mask = cell_mask(f[0], f[1], alpha_extent(f[0], f[1], f[2], f[3], f[4], f[5]),
                       static_cast<float>(tx0), static_cast<float>(ty0));
    }
    s_mask[s] = mask;
    __syncthreads();

    const int n = min(kFwdBatch, count - base);
    for (int c = 0; c * 32 < n; ++c) {
      const int jl = c * 32 + lane;
      unsigned bits = __ballot_sync(kFwdFull, jl < n && (s_mask[jl] & my_cells));
      while (bits && __any_sync(kFwdFull, live != 0)) {
        const int j = c * 32 + __ffs(bits) - 1;
        bits &= bits - 1;
        const unsigned cells = s_mask[j] >> shift;  // the same in every lane
        const float4 q0 = s_rec[j][0], q1 = s_rec[j][1], q2 = s_rec[j][2];
#pragma unroll
        for (int i = 0; i < kFwdPix; ++i) {
          if (!((cells >> i) & 1u) || !((live >> i) & 1u)) continue;
          const float alpha = splat_alpha(q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, px[i], py[i]);
          if (alpha == 0.0f) continue;
          const float test_T = T[i] * (1.0f - alpha);
          if (test_T < kTransmittanceMin) {
            live &= ~(1u << i);
            continue;
          }
          const float w = alpha * T[i];
          r[i] += w * q1.z;
          g[i] += w * q1.w;
          b[i] += w * q2.x;
          z[i] += w * q2.y;
          T[i] = test_T;
          last[i] = base + j + 1;
        }
      }
    }
  }

  const long long plane = static_cast<long long>(num_tiles) * kTilePixels;
#pragma unroll
  for (int i = 0; i < kFwdPix; ++i) {
    const int c = shift + i;
    const int pix = (kCellH * (c & 3) + (lane >> 3)) * kTileSize + kCellW * (c >> 2) + (lane & 7);
    const long long o = static_cast<long long>(t) * kTilePixels + pix;
    out5[o] = r[i];
    out5[plane + o] = g[i];
    out5[2 * plane + o] = b[i];
    out5[3 * plane + o] = z[i];
    out5[4 * plane + o] = T[i];
    n_contrib[o] = last[i];
  }
}

}  // namespace b3dgs

// records: (R >= 10, stride) float32, row-major; tile_start/tile_count:
// (num_tiles,) int32; out5: (5, num_tiles, 256) float32; n_contrib:
// (num_tiles, 256) int32. Launches on `stream`; returns cudaGetLastError().
extern "C" int b3dgs_blend_forward(const float* records, long long stride, const int* tile_start,
                                   const int* tile_count, int TW, int num_tiles, float* out5,
                                   int* n_contrib, void* stream) {
  if (num_tiles > 0) {
    b3dgs::blend_forward_kernel<<<num_tiles, b3dgs::kFwdThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        records, stride, tile_start, tile_count, TW, num_tiles, out5, n_contrib);
  }
  return static_cast<int>(cudaGetLastError());
}
