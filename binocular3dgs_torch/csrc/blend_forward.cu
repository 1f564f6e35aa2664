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
//    (__syncthreads_count);
//  * work items, not tiles (blend_common.cuh has the plan's layout and
//    caps): a tile of at most `chunk` pairs (ops/blend_cuda.py:BLEND_CHUNK,
//    256) is walked whole by one block as above; a longer tile is split
//    into chunks of `chunk` pairs, one block each. One block a tile walked
//    a Blender tile's 1,000-3,400 pairs in sequence while the other SMs
//    idled (435-506 working blocks on 132 SMs; B1 0.47 ms, B2 0.75 ms a
//    launch at the cell's start state). A chunk needs the transmittance
//    the earlier chunks leave, so a long tile takes three steps:
//      1. local walk (the first blocks of blend_forward_kernel):
//         each chunk blended from T = 1 with the rule above, kept in the
//         scratch;
//      2. walk from T_in (blend_chunk_kernel): T_in is the product of the
//         earlier chunks' local T in chunk order; where T_in is 1 the
//         local walk is the chunk's blend bit for bit, where the pixel
//         cannot stop in the chunk (T_in * local T >= 1e-4, no local stop)
//         it is the local blend scaled by T_in, and only the pixels that
//         stop in the chunk walk it again from T_in;
//      3. combine (the block that finishes a tile's last chunk, counted by
//         an integer atomic): the chunks summed in chunk order into out5
//         and n_contrib, each chunk's slot left holding the sums through
//         it and its T at its end (the backward's boundary state).
//    A product of chunk products, and a blend scaled by it, round
//    otherwise than one walk of the whole segment: a few float32 ulps,
//    inside the card gates' 1e-4 on out5 where a T_in rounded to bfloat16
//    is not (PERF.md §6); a pixel whose stop test lies within that
//    rounding of 1e-4 may stop one pair apart. A tile of at most `chunk`
//    pairs walks exactly as before. The grids are fixed by the tile count
//    and the pair capacity; blocks past the plan's counts leave, so the
//    launches are capturable and read nothing on the host.
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
// The chunks (PERF.md §6 has the runs; CUDA events over 20 launches
// at the cells' start states, the median of the views): chunk 256 / 384 /
// 512 pairs read B1 0.312 / 0.359 / 0.382 ms at Blender's (the one-block
// walk 0.474), and the same 0.62 ms at LLFF's, whose tiles of at most ~180
// pairs are never split: 256 is the least chunk that leaves every LLFF
// tile whole, and the fastest. Tried before this design: one kernel for
// every item with a product pass before it (0.309 ms at Blender's, but 62
// registers, one block an SM fewer, and LLFF's B1 0.592 -> 0.655 ms); the
// short tiles' walk apart from the chunks' (LLFF's as before, Blender's
// 0.373 ms: with ~1,900 chunks resident the kernels are bound by the
// instructions they issue, and the product pass walked most pairs twice).
#include <cuda_runtime.h>

#include <algorithm>

#include "blend_common.cuh"

namespace b3dgs {

constexpr int kFwdPix = 2;  // pixels per thread (1 and 4 measured slower, above)
constexpr int kFwdThreads = kTilePixels / kFwdPix;
constexpr int kFwdBatch = kFwdThreads;           // pairs staged per batch: one per thread
constexpr unsigned kFwdFull = 0xffffffffu;
// blocks an SM holds of blend_forward_kernel: its whole walk needs 56
// registers, which leave room for 9 blocks of 128 threads; the chunks'
// local walk in the same kernel takes it to 64 (8 blocks) uncapped. Capped,
// the local walk spills 24 bytes, and the kernel read 580 us a launch at
// LLFF's start state against 583 us uncapped (the same at Blender's;
// PERF.md §6)
constexpr int kFwdMinBlocks = 9;
constexpr int kPlanThreads = 1024;
constexpr int kPlanWarps = kPlanThreads / 32;
static_assert(kFwdPix == 1 || kFwdPix == 2 || kFwdPix == 4, "1, 2 or 4 pixels per thread");
static_assert(2 * kFwdThreads == kTilePixels, "the combine takes two pixels a thread");
static_assert(kPlanWarps == 32, "the plan's second scan level is one warp");

struct FwdStage {
  float4 rec[kFwdBatch][3];  // mx my a b | c op r g | b depth - -
  unsigned mask[kFwdBatch];  // bit c: the pair may blend cell c
};

// One thread's pixels: pixel i is lane (lane & 7, lane >> 3) of cell
// shift + i, where shift = warp * kFwdPix.
struct FwdPixels {
  float px[kFwdPix], py[kFwdPix], T[kFwdPix], r[kFwdPix], g[kFwdPix], b[kFwdPix], z[kFwdPix];
  int last[kFwdPix];
  unsigned live;  // bit i: pixel i is still blending
};

// index within the tile (y * 16 + x) of a thread's pixel in cell c
__device__ __forceinline__ int cell_pixel(int c, int lane) {
  return (kCellH * (c & 3) + (lane >> 3)) * kTileSize + kCellW * (c >> 2) + (lane & 7);
}

__device__ __forceinline__ void init_pixels(FwdPixels& p, int tx0, int ty0, int shift, int lane) {
#pragma unroll
  for (int i = 0; i < kFwdPix; ++i) {
    const int c = shift + i;
    p.px[i] = static_cast<float>(tx0 + kCellW * (c >> 2) + (lane & 7));
    p.py[i] = static_cast<float>(ty0 + kCellH * (c & 3) + (lane >> 3));
    p.T[i] = 1.0f;
    p.r[i] = p.g[i] = p.b[i] = p.z[i] = 0.0f;
    p.last[i] = 0;
  }
  p.live = (1u << kFwdPix) - 1;
}

// Blends the records [seg, seg + n_pairs), the pairs first .. first +
// n_pairs - 1 of a tile's segment, front to back from the pixels' T; a
// pixel stops before the pair that would take its T below the threshold.
__device__ __forceinline__ void walk(FwdStage& st, FwdPixels& p, const float* __restrict__ records,
                                     long long stride, long long seg, int n_pairs, int first,
                                     int tx0, int ty0, int shift, int s, int lane) {
  const unsigned my_cells = ((1u << kFwdPix) - 1) << shift;
  for (int base = 0; base < n_pairs; base += kFwdBatch) {
    // also the barrier that keeps the previous batch's readers ahead of the
    // writes below
    if (__syncthreads_count(p.live != 0) == 0) break;
    const int k = base + s;
    unsigned mask = 0;
    if (k < n_pairs) {
      float f[kLiveRows];
#pragma unroll
      for (int q = 0; q < kLiveRows; ++q) f[q] = records[q * stride + seg + k];
      st.rec[s][0] = make_float4(f[0], f[1], f[2], f[3]);
      st.rec[s][1] = make_float4(f[4], f[5], f[6], f[7]);
      st.rec[s][2] = make_float4(f[8], f[9], 0.0f, 0.0f);
      mask = cell_mask(f[0], f[1], alpha_extent(f[0], f[1], f[2], f[3], f[4], f[5]),
                       static_cast<float>(tx0), static_cast<float>(ty0));
    }
    st.mask[s] = mask;
    __syncthreads();

    const int n = min(kFwdBatch, n_pairs - base);
    for (int c = 0; c * 32 < n; ++c) {
      const int jl = c * 32 + lane;
      unsigned bits = __ballot_sync(kFwdFull, jl < n && (st.mask[jl] & my_cells));
      while (bits && __any_sync(kFwdFull, p.live != 0)) {
        const int j = c * 32 + __ffs(bits) - 1;
        bits &= bits - 1;
        const unsigned cells = st.mask[j] >> shift;  // the same in every lane
        const float4 q0 = st.rec[j][0], q1 = st.rec[j][1], q2 = st.rec[j][2];
#pragma unroll
        for (int i = 0; i < kFwdPix; ++i) {
          if (!((cells >> i) & 1u) || !((p.live >> i) & 1u)) continue;
          const float alpha = splat_alpha(q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, p.px[i], p.py[i]);
          if (alpha == 0.0f) continue;
          const float test_T = p.T[i] * (1.0f - alpha);
          if (test_T < kTransmittanceMin) {
            p.live &= ~(1u << i);
            continue;
          }
          const float w = alpha * p.T[i];
          p.r[i] += w * q1.z;
          p.g[i] += w * q1.w;
          p.b[i] += w * q2.x;
          p.z[i] += w * q2.y;
          p.T[i] = test_T;
          p.last[i] = first + base + j + 1;
        }
      }
    }
  }
}

// The work list (blend_common.cuh): one block of kPlanThreads threads, each
// taking a run of consecutive tiles; an exclusive scan of the runs' chunk
// items places each run's entries, so the list is in tile order. Also the
// render's two counters: the work items that walk at least one pair (a
// short tile's block or a chunk) and the most pairs one of them walks.
__global__ void __launch_bounds__(kPlanThreads)
    blend_plan_kernel(const int* __restrict__ tile_count, int num_tiles, long long capacity,
                      int chunk, int* __restrict__ plan, int* __restrict__ walked_items,
                      int* __restrict__ longest_walk) {
  __shared__ int s_scan[kPlanWarps];
  __shared__ int s_red[2][kPlanWarps];
  const int s = threadIdx.x;
  const int lane = s & 31;
  const int warp = s >> 5;
  const int per = (num_tiles + kPlanThreads - 1) / kPlanThreads;
  const int t0 = min(num_tiles, s * per);
  const int t1 = min(num_tiles, t0 + per);
  int items = 0, walked = 0, longest = 0;  // of this run: chunk items, ...
  for (int t = t0; t < t1; ++t) {
    const int c = tile_count[t];
    const int n = n_chunks(c, chunk);
    if (n > 1) items += n;
    if (c > 0) walked += n;
    longest = max(longest, min(c, chunk));
  }
  int x = items;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFwdFull, x, d);
    if (lane >= d) x += y;
  }
  int item = x - items;  // exclusive within the warp
  if (lane == 31) s_scan[warp] = x;
  walked = __reduce_add_sync(kFwdFull, walked);
  longest = __reduce_max_sync(kFwdFull, longest);
  if (lane == 0) {
    s_red[0][warp] = walked;
    s_red[1][warp] = longest;
  }
  __syncthreads();
  if (warp == 0) {
    int w = s_scan[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFwdFull, w, d);
      if (lane >= d) w += y;
    }
    s_scan[lane] = w;  // inclusive over the warps
    const int sum = __reduce_add_sync(kFwdFull, s_red[0][lane]);
    const int most = __reduce_max_sync(kFwdFull, s_red[1][lane]);
    if (lane == 0) {
      *walked_items = sum;
      *longest_walk = most;
    }
  }
  __syncthreads();
  item += warp > 0 ? s_scan[warp - 1] : 0;

  const int ccap = chunk_cap(num_tiles, capacity, chunk);
  int* first = plan + kPlanHeader;
  int* chunk_items = first + num_tiles;
  int* done = chunk_items + ccap;
  for (int t = t0; t < t1; ++t) {
    const int n = n_chunks(tile_count[t], chunk);
    done[t] = 0;
    first[t] = n > 1 ? item : -1;
    if (n == 1) continue;
    for (int j = 0; j < n && item + j < ccap; ++j) chunk_items[item + j] = t;
    item += n;
  }
  if (s == 0) plan[0] = min(s_scan[kPlanWarps - 1], ccap);
}

// The first gridDim.x - num_tiles blocks: the local walk of each chunk
// item, the blend of its pairs from T = 1 with the whole walk's rule, kept
// in its scratch slot: T at its end (negated where a pixel stopped in the
// chunk) in kPlaneLocalT, colour and depth, n_contrib. They come first so
// that the longest work starts first. The last num_tiles blocks: the whole
// walk of each tile of at most `chunk` pairs (a long tile's block leaves).
__global__ void __launch_bounds__(kFwdThreads, kFwdMinBlocks)
    blend_forward_kernel(const float* __restrict__ records, long long stride,
                         const int* __restrict__ tile_start, const int* __restrict__ tile_count,
                         int TW, int num_tiles, int chunk, const int* __restrict__ plan,
                         float* __restrict__ scratch, float* __restrict__ out5,
                         int* __restrict__ n_contrib) {
  __shared__ FwdStage st;
  const int s = threadIdx.x;
  const int lane = s & 31;
  const int shift = (s >> 5) * kFwdPix;
  const int chunk_blocks = gridDim.x - num_tiles;
  if (blockIdx.x >= chunk_blocks) {
    const int t = blockIdx.x - chunk_blocks;
    const int count = tile_count[t];
    if (count > chunk) return;
    const int tx0 = (t % TW) * kTileSize;
    const int ty0 = (t / TW) * kTileSize;
    FwdPixels p;
    init_pixels(p, tx0, ty0, shift, lane);
    walk(st, p, records, stride, tile_start[t], count, 0, tx0, ty0, shift, s, lane);
    const long long plane = static_cast<long long>(num_tiles) * kTilePixels;
#pragma unroll
    for (int q = 0; q < kFwdPix; ++q) {
      const long long o = static_cast<long long>(t) * kTilePixels + cell_pixel(shift + q, lane);
      out5[o] = p.r[q];
      out5[plane + o] = p.g[q];
      out5[2 * plane + o] = p.b[q];
      out5[3 * plane + o] = p.z[q];
      out5[4 * plane + o] = p.T[q];
      n_contrib[o] = p.last[q];
    }
    return;
  }
  const ChunkPlan cp = read_plan(plan, num_tiles, stride, chunk);
  const long long splane =
      static_cast<long long>(chunk_cap(num_tiles, stride, chunk)) * kTilePixels;
  for (int k = blockIdx.x; k < cp.n_chunk; k += chunk_blocks) {
    const int t = cp.chunk_items[k];
    const int first = (k - cp.first[t]) * chunk;
    const int tx0 = (t % TW) * kTileSize;
    const int ty0 = (t / TW) * kTileSize;
    FwdPixels p;
    init_pixels(p, tx0, ty0, shift, lane);
    walk(st, p, records, stride, tile_start[t] + static_cast<long long>(first),
                min(chunk, tile_count[t] - first), first, tx0, ty0, shift, s, lane);
#pragma unroll
    for (int q = 0; q < kFwdPix; ++q) {
      const long long o = static_cast<long long>(k) * kTilePixels + cell_pixel(shift + q, lane);
      scratch[kPlaneLocalT * splane + o] = (p.live >> q) & 1u ? p.T[q] : -p.T[q];
      scratch[kPlaneColor * splane + o] = p.r[q];
      scratch[(kPlaneColor + 1) * splane + o] = p.g[q];
      scratch[(kPlaneColor + 2) * splane + o] = p.b[q];
      scratch[(kPlaneColor + 3) * splane + o] = p.z[q];
      reinterpret_cast<int*>(scratch + kPlaneLast * splane)[o] = p.last[q];
    }
  }
}

// Each chunk item from T_in, the product of the earlier chunks' local T in
// chunk order, and the combine. A pixel is done before the chunk where an
// earlier chunk stopped it or T_in is below the threshold. Where T_in is 1
// the local walk is this chunk's blend, bit for bit; where T_in * the local
// T stays at or above the threshold and the local walk did not stop, the
// blend is the local one scaled by T_in (the pixel cannot stop in the
// chunk); else the chunk is walked again from T_in for those pixels alone.
// It writes the chunk's boundary state: colour and depth, n_contrib, and T
// at its end, negated where the pixel stopped in this chunk and -inf where
// it was done before it. The block that finishes a tile's last chunk (the
// tile's `done` count, an integer atomic: which block that is changes
// nothing computed) combines the tile, one thread two pixels: the chunks'
// colour and depth summed in chunk order until the chunk where the pixel
// stopped, each chunk's slot left holding the sum through it (the
// backward's boundary state), T_final the T at that chunk's end, n_contrib
// the last chunk's that blended; out5 and n_contrib as the whole walk
// writes them.
__global__ void __launch_bounds__(kFwdThreads)
    blend_chunk_kernel(const float* __restrict__ records, long long stride,
                       const int* __restrict__ tile_start, const int* __restrict__ tile_count,
                       int TW, int num_tiles, int chunk, int* __restrict__ plan,
                       float* __restrict__ scratch, float* __restrict__ out5,
                       int* __restrict__ n_contrib) {
  __shared__ FwdStage st;
  __shared__ int s_last;
  const ChunkPlan cp = read_plan(plan, num_tiles, stride, chunk);
  int* done = plan + cp.done_offset;
  const long long splane =
      static_cast<long long>(chunk_cap(num_tiles, stride, chunk)) * kTilePixels;
  const long long plane = static_cast<long long>(num_tiles) * kTilePixels;
  float* local_T = scratch + kPlaneLocalT * splane;
  int* last_plane = reinterpret_cast<int*>(scratch + kPlaneLast * splane);
  const float inf = __int_as_float(0x7f800000);
  const int s = threadIdx.x;
  const int lane = s & 31;
  const int shift = (s >> 5) * kFwdPix;
  for (int k = blockIdx.x; k < cp.n_chunk; k += gridDim.x) {
    const int t = cp.chunk_items[k];
    const int k0 = cp.first[t];
    const int count = tile_count[t];
    const int n = n_chunks(count, chunk);
    const int first = (k - k0) * chunk;
    const int tx0 = (t % TW) * kTileSize;
    const int ty0 = (t / TW) * kTileSize;
    FwdPixels p;
    init_pixels(p, tx0, ty0, shift, lane);
    float t_in[kFwdPix];
    unsigned pass = 0;  // bit q: pixel q takes the local walk, scaled by T_in
#pragma unroll
    for (int q = 0; q < kFwdPix; ++q) {
      const long long o = static_cast<long long>(k) * kTilePixels + cell_pixel(shift + q, lane);
      t_in[q] = 1.0f;
      bool stopped = false;
      for (long long j = o - static_cast<long long>(k - k0) * kTilePixels; j < o;
           j += kTilePixels) {
        const float tj = local_T[j];
        stopped = tj < 0.0f;
        if (stopped) break;
        t_in[q] = t_in[q] * tj;
      }
      const float own = local_T[o];
      p.T[q] = t_in[q];
      if (stopped || t_in[q] < kTransmittanceMin) {
        p.live &= ~(1u << q);  // done before this chunk
        t_in[q] = -inf;
      } else if (t_in[q] == 1.0f || (own >= 0.0f && t_in[q] * own >= kTransmittanceMin)) {
        p.live &= ~(1u << q);
        pass |= 1u << q;
      }
    }
    walk(st, p, records, stride, tile_start[t] + static_cast<long long>(first),
                min(chunk, count - first), first, tx0, ty0, shift, s, lane);
#pragma unroll
    for (int q = 0; q < kFwdPix; ++q) {
      const long long o = static_cast<long long>(k) * kTilePixels + cell_pixel(shift + q, lane);
      float tv;
      if ((pass >> q) & 1u) {
        const float own = local_T[o];
        tv = t_in[q] * fabsf(own);
        if (own < 0.0f) tv = -tv;  // T_in is 1: the local walk stopped it here
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float* x = scratch + (kPlaneColor + c) * splane + o;
          *x = t_in[q] * *x;
        }
      } else {
        tv = t_in[q] == -inf ? -inf : (((p.live >> q) & 1u) ? p.T[q] : -p.T[q]);
        scratch[kPlaneColor * splane + o] = p.r[q];
        scratch[(kPlaneColor + 1) * splane + o] = p.g[q];
        scratch[(kPlaneColor + 2) * splane + o] = p.b[q];
        scratch[(kPlaneColor + 3) * splane + o] = p.z[q];
        last_plane[o] = p.last[q];
      }
      scratch[kPlaneT * splane + o] = tv;
    }

    __threadfence();  // this chunk's slot, before the count says it is there
    __syncthreads();
    if (s == 0) s_last = atomicAdd(done + t, 1) == n - 1;
    __syncthreads();
    if (!s_last) continue;
    __threadfence();
    // a thread's two pixels side by side, every chunk's slot read whether
    // or not the pixel still needs it, so that the reads of one chunk do
    // not wait on the sums of the one before
    float acc[2][4] = {};
    float T[2] = {1.0f, 1.0f};
    int last[2] = {0, 0};
    bool stopped[2] = {false, false};
    for (int j = k0; j < k0 + n; ++j) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const long long o = static_cast<long long>(j) * kTilePixels + s + q * kFwdThreads;
        const float tv = __ldcg(scratch + kPlaneT * splane + o);
        float col[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) col[c] = __ldcg(scratch + (kPlaneColor + c) * splane + o);
        const int lj = __ldcg(last_plane + o);
        if (!stopped[q]) {
          if (isinf(tv)) {
            stopped[q] = true;  // done before this chunk
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[q][c] += col[c];
            T[q] = fabsf(tv);
            stopped[q] = tv < 0.0f;
            last[q] = max(last[q], lj);
          }
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) scratch[(kPlaneColor + c) * splane + o] = acc[q][c];
      }
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const long long o = static_cast<long long>(t) * kTilePixels + s + q * kFwdThreads;
#pragma unroll
      for (int c = 0; c < 4; ++c) out5[c * plane + o] = acc[q][c];
      out5[4 * plane + o] = T[q];
      n_contrib[o] = last[q];
    }
  }
}

}  // namespace b3dgs

// tile_count: (num_tiles,) int32; plan: int32, ops/blend_cuda.py:plan_size
// entries for the pair capacity `capacity` (blend_common.cuh's layout);
// walked_items, longest_walk: 0-d int32. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int b3dgs_blend_plan(const int* tile_count, int num_tiles, long long capacity,
                                int chunk, int* plan, int* walked_items, int* longest_walk,
                                void* stream) {
  b3dgs::blend_plan_kernel<<<1, b3dgs::kPlanThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tile_count, num_tiles, capacity, chunk, plan, walked_items, longest_walk);
  return static_cast<int>(cudaGetLastError());
}

// records: (R >= 10, stride) float32, row-major, stride the pair capacity;
// tile_start/tile_count: (num_tiles,) int32; plan: b3dgs_blend_plan's of
// tile_count, stride and chunk (its `done` counts are consumed); scratch:
// (kScratchPlanes, chunk_cap, 256) float32; out5: (5, num_tiles, 256)
// float32; n_contrib: (num_tiles, 256) int32. Launches the whole walk with
// the chunks' local walk, then the chunks' walk from T_in with the combine,
// on `stream`; returns the first cudaError.
extern "C" int b3dgs_blend_forward(const float* records, long long stride, const int* tile_start,
                                   const int* tile_count, int TW, int num_tiles, int chunk,
                                   int* plan, float* scratch, float* out5, int* n_contrib,
                                   void* stream) {
  if (num_tiles <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunks = std::max(1, std::min(b3dgs::chunk_cap(num_tiles, stride, chunk),
                                          b3dgs::kExtraBlocks));
  b3dgs::blend_forward_kernel<<<num_tiles + chunks, b3dgs::kFwdThreads, 0, st>>>(
      records, stride, tile_start, tile_count, TW, num_tiles, chunk, plan, scratch, out5,
      n_contrib);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  b3dgs::blend_chunk_kernel<<<chunks, b3dgs::kFwdThreads, 0, st>>>(
      records, stride, tile_start, tile_count, TW, num_tiles, chunk, plan, scratch, out5,
      n_contrib);
  return static_cast<int>(cudaGetLastError());
}
