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
// pixel and writes 40 B per walked pair (~51 MB at the chip_smoke
// workload, 0.015 ms at 3.35 TB/s), so the bound is arithmetic: ~71 FP32
// instructions for each pair-pixel that blended (its alpha, the cotangent
// algebra and its share of the pixel sums). A dense walk adds the alpha of
// every pair below each pixel's n_contrib, but only ~20% of those
// evaluations blend: a pair's 3-sigma binning box, and the tile it covers,
// are far larger than the part of the tile its alpha >= 1/255 ellipse
// reaches.
//
// Design:
//  * several pixels per thread (kBwdPix = 2), each with its own T, suffix
//    and cotangents in registers; a pair's fields are read from shared
//    memory once per thread, as three float4 of a pair-major table, for all
//    its pixels;
//  * per-cell culling (blend_common.cuh): the tile is 8 cells of 8x4
//    pixels, warp w holds cells 2w and 2w+1 (an 8x8 quadrant), one pixel of
//    each per lane. The block stages 128 pairs at a time; the thread that
//    stages a pair computes its conservative alpha box (alpha_extent) and
//    one bit per cell, set when the box meets the cell and the pair lies
//    below the cell's largest n_contrib (cell_mask). A warp ballots the bits
//    of 32 pairs and walks only the pairs that may reach one of its cells,
//    back to front, and evaluates a pair only in those cells (a
//    warp-uniform branch). A culled pair has alpha = 0 at every pixel of the
//    cell, so T and the suffix see the same sequence of blended pairs as a
//    dense walk. At the chip_smoke workload the cells leave about half of
//    the dense walk's pair-pixel evaluations (computed on the CPU with
//    ops/blend_cuda.py:_alpha_extent);
//  * one reciprocal instead of two IEEE divisions per hit: T *= 1 / (1 -
//    alpha) with the correctly rounded __frcp_rn, and the same reciprocal
//    in d_alpha. T differs from the quotient by ~1 ulp per blended pair; the
//    plain version rebuilds T from chunk products, so the two never rounded
//    alike, and chip_smoke phase 7 holds every row within 1e-3 x max|row|;
//  * a warp adds its pixels' ten terms in registers, then sums them over
//    its lanes with a transposing butterfly (blend_common.cuh:warp_sum10,
//    12 shuffles instead of 50) only when some lane blended the pair; the
//    walking warps' partials go to shared memory, and after the batch the
//    block adds them in warp order and writes each (field, pair) once.
//  * the forward's work items (csrc/blend_forward.cu), all in this one
//    launch: the last T blocks walk a tile of at most `chunk` pairs whole,
//    as before, bit for bit; the first walk a long tile's chunks, each back
//    to front from its boundary state, T at the chunk's end, with the
//    suffix of the pairs behind it taken as d_out . (C_final - C through
//    the chunk) from the combine's sums. Each pair lies in one chunk and is
//    written once. One block a tile walked Blender's longest tiles
//    (~3,400 pairs) in sequence: 0.752 ms a launch at the cell's start
//    state; in chunks of 256 / 384 / 512 pairs 0.263 / 0.318 / 0.371 ms
//    (CUDA events, the median of the views; LLFF's 1.48 ms at each, its
//    tiles never split; PERF.md §6 has the runs).
// Hazards the TPU kernel did not have, and how this one avoids them:
//  * blocks run in any order and in parallel, so nothing is accumulated
//    across blocks: each pair lies in exactly one tile's segment and is
//    written once (the TPU kernel's read-add-write on windows shared by
//    two tiles was safe only on its sequential grid);
//  * slots outside every walked segment, and pairs no warp walked, stay as
//    the wrapper zeroed them;
//  * alpha comes from splat_eval (csrc/blend_common.cuh), the forward's own
//    expression, under the same flags, so both kernels gate each pair
//    alike.
// Tried (build variants timed against each other on an NVIDIA H100 80GB
// HBM3 at 700 W, chip_smoke workload, profiler ms with L2 flushed; PERF.md
// has the table): 1 / 2 / 4 pixels per thread 0.284 / 0.262 / 0.284 at 64
// pairs per batch, 0.258 with 2 pixels at 128; register caps
// (__launch_bounds__ min-blocks) spilled and lost; the dense one-pixel
// kernel this design replaced 0.548 in the same run. What remains, read
// from the code and not from a profile: instructions per (pair, cell),
// since the warp sum and the algebra run for all 32 lanes when any lane
// blends. Not done: cp.async or TMA staging. The staging thread needs the
// pair's fields in registers for its cull box anyway, and the batch size
// barely moves the time (above); a TMA tensor map would also need the
// pair capacity padded to a multiple of 4 and -lcuda.
#include <cuda_runtime.h>

#include <algorithm>

#include "blend_common.cuh"

namespace b3dgs {

constexpr int kBwdPix = 2;       // pixels per thread (1 and 4 measured slower, above)
constexpr int kBwdThreads = kTilePixels / kBwdPix;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kBwdBatch = 128;   // pairs staged per batch (64 measured slower)
constexpr int kPartStride = kLiveRows + 1;       // odd: conflict-free column reads
constexpr unsigned kFullMask = 0xffffffffu;
static_assert(kBwdPix == 1 || kBwdPix == 2 || kBwdPix == 4, "1, 2 or 4 pixels per thread");
static_assert(kBwdThreads >= kBwdBatch, "one staging thread per pair of a batch");

__global__ void __launch_bounds__(kBwdThreads)
    blend_backward_kernel(const float* __restrict__ records, long long stride,
                          const int* __restrict__ tile_start, const int* __restrict__ tile_count,
                          const float* __restrict__ out5, const int* __restrict__ n_contrib,
                          const float* __restrict__ d_out5, int TW, int num_tiles, int chunk,
                          const int* __restrict__ plan, const float* __restrict__ scratch,
                          float* __restrict__ d_records) {
  __shared__ float4 s_rec[kBwdBatch][3];  // mx my a b | c op r g | b depth - -
  __shared__ unsigned s_mask[kBwdBatch];  // bit c: cell c's pixels evaluate the pair
  __shared__ float s_part[kBwdWarps][kBwdBatch][kPartStride];
  __shared__ int s_walk[kCells];          // each cell's pairs of the item below its n_contrib

  const ChunkPlan cp = read_plan(plan, num_tiles, stride, chunk);
  const long long splane =
      static_cast<long long>(chunk_cap(num_tiles, stride, chunk)) * kTilePixels;
  const int s = threadIdx.x;
  const int lane = s & 31;
  const int warp = s >> 5;
  const int shift = warp * kBwdPix;  // this warp's cells: shift .. shift + kBwdPix - 1
  const unsigned my_cells = ((1u << kBwdPix) - 1) << shift;
  const long long plane = static_cast<long long>(num_tiles) * kTilePixels;

  // the first gridDim.x - num_tiles blocks: the chunk items blockIdx.x,
  // + those blocks, ... (the longest work first); the last num_tiles: the
  // tile blockIdx.x - those blocks, walked whole if it is short
  const int chunk_blocks = gridDim.x - num_tiles;
  const bool whole = blockIdx.x >= chunk_blocks;
  const int items = whole ? num_tiles : cp.n_chunk;
  for (int k = whole ? blockIdx.x - chunk_blocks : blockIdx.x; k < items;
       k += whole ? num_tiles : chunk_blocks) {
    const int t = whole ? k : cp.chunk_items[k];
    const int count = tile_count[t];
    if (whole && count > chunk) break;  // a long tile: its chunks are the chunk blocks'
    __syncthreads();  // the previous item's readers of the shared arrays are done
    const int tx0 = (t % TW) * kTileSize;
    const int ty0 = (t / TW) * kTileSize;
    const int first = whole ? 0 : (k - cp.first[t]) * chunk;  // the pairs [first, end)
    const int end = whole ? count : min(count, first + chunk);
    const long long seg = tile_start[t] + static_cast<long long>(first);

    float px[kBwdPix], py[kBwdPix], T[kBwdPix], suffix[kBwdPix], tfd[kBwdPix];
    float d_r[kBwdPix], d_g[kBwdPix], d_b[kBwdPix], d_z[kBwdPix];
    int nc[kBwdPix];
#pragma unroll
    for (int i = 0; i < kBwdPix; ++i) {
      const int c = shift + i;
      const int x = kCellW * (c >> 2) + (lane & 7);
      const int y = kCellH * (c & 3) + (lane >> 3);
      const long long o = static_cast<long long>(t) * kTilePixels + y * kTileSize + x;
      px[i] = static_cast<float>(tx0 + x);
      py[i] = static_cast<float>(ty0 + y);
      T[i] = out5[4 * plane + o];
      suffix[i] = 0.0f;  // sum of w * r over the pairs behind the current one
      tfd[i] = d_out5[4 * plane + o] * T[i];
      d_r[i] = d_out5[o];
      d_g[i] = d_out5[plane + o];
      d_b[i] = d_out5[2 * plane + o];
      d_z[i] = d_out5[3 * plane + o];
      nc[i] = n_contrib[o];
      if (!whole) {
        // a long tile's chunk starts from its boundary state: T at its end,
        // and the later chunks' part of the suffix, d_out . (C_final - C
        // through this chunk)
        const long long so = static_cast<long long>(k) * kTilePixels + y * kTileSize + x;
        T[i] = fabsf(scratch[kPlaneT * splane + so]);
        suffix[i] = d_r[i] * (out5[o] - scratch[kPlaneColor * splane + so]) +
                    d_g[i] * (out5[plane + o] - scratch[(kPlaneColor + 1) * splane + so]) +
                    d_b[i] * (out5[2 * plane + o] - scratch[(kPlaneColor + 2) * splane + so]) +
                    d_z[i] * (out5[3 * plane + o] - scratch[(kPlaneColor + 3) * splane + so]);
      }
      const int cell_walk = __reduce_max_sync(kFullMask, nc[i]);
      if (lane == 0) s_walk[c] = max(0, min(cell_walk, end) - first);
    }
    __syncthreads();
    int n_walk = 0;
#pragma unroll
    for (int c = 0; c < kCells; ++c) n_walk = max(n_walk, s_walk[c]);

    for (int base = n_walk > 0 ? ((n_walk - 1) / kBwdBatch) * kBwdBatch : -1; base >= 0;
         base -= kBwdBatch) {
      const int n = min(kBwdBatch, n_walk - base);
      __syncthreads();  // the previous batch's readers of s_rec, s_mask and s_part are done
      if (s < kBwdBatch) {
        unsigned mask = 0;
        if (s < n) {
          float f[kLiveRows];
#pragma unroll
          for (int r = 0; r < kLiveRows; ++r) f[r] = records[r * stride + seg + base + s];
          s_rec[s][0] = make_float4(f[0], f[1], f[2], f[3]);
          s_rec[s][1] = make_float4(f[4], f[5], f[6], f[7]);
          s_rec[s][2] = make_float4(f[8], f[9], 0.0f, 0.0f);
          mask = cell_mask(f[0], f[1], alpha_extent(f[0], f[1], f[2], f[3], f[4], f[5]),
                           static_cast<float>(tx0), static_cast<float>(ty0));
#pragma unroll
          for (int c = 0; c < kCells; ++c) {
            if (base + s >= s_walk[c]) mask &= ~(1u << c);
          }
        }
        s_mask[s] = mask;
      }
      __syncthreads();

      // this warp's pairs of the batch, back to front
      for (int c = (n - 1) >> 5; c >= 0; --c) {
        const int jl = c * 32 + lane;
        unsigned bits = __ballot_sync(kFullMask, jl < n && (s_mask[jl] & my_cells));
        while (bits) {
          const int hb = 31 - __clz(bits);
          bits ^= 1u << hb;
          const int j = c * 32 + hb;
          const int k = first + base + j;  // the pair's index in the tile's segment
          const unsigned cells = s_mask[j] >> shift;  // the same in every lane
          const float4 q0 = s_rec[j][0], q1 = s_rec[j][1], q2 = s_rec[j][2];
          float v[kLiveRows];
#pragma unroll
          for (int f = 0; f < kLiveRows; ++f) v[f] = 0.0f;
          bool hit = false;
#pragma unroll
          for (int i = 0; i < kBwdPix; ++i) {
            if (!((cells >> i) & 1u) || k >= nc[i]) continue;
            const SplatEval e = splat_eval(q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, px[i], py[i]);
            if (!(e.alpha > 0.0f)) continue;
            hit = true;
            const float inv_om = __frcp_rn(fmaxf(1.0f - e.alpha, kOneMinusFloor));
            T[i] = T[i] * inv_om;  // transmittance before this pair
            const float w = e.alpha * T[i];
            const float r = d_r[i] * q1.z + d_g[i] * q1.w + d_b[i] * q2.x + d_z[i] * q2.y;
            float d_alpha = T[i] * r - inv_om * (suffix[i] + tfd[i]);
            suffix[i] += w * r;
            if (!(q1.y * e.G <= kAlphaClamp)) d_alpha = 0.0f;  // clamped alpha
            const float d_pow = e.alpha * d_alpha;
            v[0] += -(q0.z * e.dx + q0.w * e.dy) * d_pow;
            v[1] += -(q1.x * e.dy + q0.w * e.dx) * d_pow;
            v[2] += -0.5f * e.dx * e.dx * d_pow;
            v[3] += -e.dx * e.dy * d_pow;
            v[4] += -0.5f * e.dy * e.dy * d_pow;
            v[5] += e.G * d_alpha;
            v[6] += w * d_r[i];
            v[7] += w * d_g[i];
            v[8] += w * d_b[i];
            v[9] += w * d_z[i];
          }
          const float sum = __any_sync(kFullMask, hit) ? warp_sum10(v, lane) : 0.0f;
          const int field = warp_sum10_field(lane);
          if (field >= 0) s_part[warp][j][field] = sum;
        }
      }
      __syncthreads();

      for (int i = s; i < kLiveRows * kBwdBatch; i += kBwdThreads) {
        const int f = i / kBwdBatch;
        const int j = i % kBwdBatch;
        const unsigned mask = j < n ? s_mask[j] : 0u;
        if (mask == 0) continue;  // no warp walked it: the wrapper's zero stands
        float acc = 0.0f;
#pragma unroll
        for (int w = 0; w < kBwdWarps; ++w) {
          if ((mask >> (w * kBwdPix)) & ((1u << kBwdPix) - 1)) acc += s_part[w][j][f];
        }
        d_records[f * stride + seg + base + j] = acc;
      }
    }
  }
}

}  // namespace b3dgs

// records: (R >= 10, stride) float32, stride the pair capacity;
// tile_start/tile_count: (num_tiles,) int32; out5, d_out5: (5, num_tiles,
// 256) float32; n_contrib: (num_tiles, 256) int32; plan and scratch: the
// forward's (csrc/blend_forward.cu) for these inputs and chunk; d_records:
// (R, stride) float32, zeroed by the caller (only walked pairs of rows 0-9
// are written). Launches on `stream`; returns cudaGetLastError().
extern "C" int b3dgs_blend_backward(const float* records, long long stride, const int* tile_start,
                                    const int* tile_count, const float* out5,
                                    const int* n_contrib, const float* d_out5, int TW,
                                    int num_tiles, int chunk, const int* plan,
                                    const float* scratch, float* d_records, void* stream) {
  if (num_tiles > 0) {
    const int chunks = std::max(1, std::min(b3dgs::chunk_cap(num_tiles, stride, chunk),
                                            b3dgs::kExtraBlocks));
    b3dgs::blend_backward_kernel<<<num_tiles + chunks, b3dgs::kBwdThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
        records, stride, tile_start, tile_count, out5, n_contrib, d_out5, TW, num_tiles, chunk,
        plan, scratch, d_records);
  }
  return static_cast<int>(cudaGetLastError());
}
