// Shared device code of the tile blend kernels.
//
// The blend backward walks pairs back to front and gates them on the same
// thresholds as the forward, rebuilding transmittance by division from
// T_final; an alpha that differs by one bit at the 1/255 cut between the two
// kernels blew gradient norms up 150x on the TPU
// (binocular3dgs_tpu/ops/blend_pallas.py, _chunk_alpha). So every kernel
// computes alpha through splat_eval below, and all kernels are built with
// the same nvcc flags: no --use_fast_math, and --fmad=false so that the
// products round one by one in the order written, as in the plain PyTorch
// version (ops/blend_cuda.py); kernel and plain version then agree on alpha
// bit for bit and cannot disagree on which pairs pass the 1/255 cut.
// Culling (alpha_extent, cell_mask) only skips pairs whose alpha is 0, so
// it changes no output bit.
#pragma once

namespace b3dgs {

constexpr int kTileSize = 16;
constexpr int kTilePixels = kTileSize * kTileSize;  // 256
constexpr int kLiveRows = 10;  // record rows: mx my a b c op r g b depth

constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTransmittanceMin = 1e-4f;
constexpr float kAlphaClamp = 0.99f;
// floor of 1 - alpha in the backward's division: float32(1.0 - 0.99), as the
// plain version's clamp(min=1 - ALPHA_CLAMP) rounds it (not 1.0f - 0.99f)
constexpr float kOneMinusFloor = 0.01f;

// One splat at one pixel: the offsets, the exponent, G = exp(power) and
// alpha, which is 0 when the pair is skipped (power > 0 or alpha < 1/255).
// The CUDA renderCUDA contract (SURVEY.md §3.5); expf, not __expf, for the
// exact exponential. The forward reads alpha; the backward also needs G
// (d_op and the clamp test op * G <= 0.99) and the offsets, so both take
// them from this one expression.
struct SplatEval {
  float dx, dy, G, alpha;
};

__device__ __forceinline__ SplatEval splat_eval(float mx, float my, float ca, float cb, float cc,
                                                float opacity, float px, float py) {
  SplatEval e;
  e.dx = mx - px;
  e.dy = my - py;
  const float power = -0.5f * (ca * e.dx * e.dx + cc * e.dy * e.dy) - cb * e.dx * e.dy;
  e.G = 0.0f;
  e.alpha = 0.0f;
  if (power > 0.0f) return e;
  e.G = expf(power);
  const float alpha = fminf(kAlphaClamp, opacity * e.G);
  e.alpha = alpha < kAlphaMin ? 0.0f : alpha;
  return e;
}

__device__ __forceinline__ float splat_alpha(float mx, float my, float ca, float cb, float cc,
                                             float opacity, float px, float py) {
  return splat_eval(mx, my, ca, cb, cc, opacity, px, py).alpha;
}

// Conservative half-extents (rx, ry), in pixels, of the axis-aligned box
// around the mean outside which splat_eval's alpha is 0. Alpha >= 1/255
// needs op * exp(-d'Qd / 2) >= 1/255, i.e. d'Qd <= k = 2 ln(255 op), an
// ellipse of half-extents sqrt(k c / det), sqrt(k a / det) for the conic
// Q = [[a, b], [b, c]], det = a c - b^2. The rounding of splat_eval's
// power grows with the conic's condition a c / det (its three terms cancel
// on a thin rotated ellipse), so k is raised by 1% plus 1e-5 of that
// condition and 0.01, the extents by 1% and one pixel. Returns:
//   rx = ry = inf  cull nothing: the mean or the conic is not finite (the
//                  power may then be NaN, and splat_eval's alpha 0.99 at
//                  any opacity: fminf(0.99, NaN) is 0.99), or the conic is
//                  not clearly positive definite (det <= 1e-4 a c, so that
//                  det itself is good to 0.1%);
//   rx = ry = -1   else where op < 1/255: alpha < 1/255 at every pixel
//                  (op * G <= op);
// and NaN where op is NaN, which cell_mask below treats as "may blend", as
// splat_eval blends it. ops/blend_cuda.py:_alpha_extent is the plain mirror
// the tests hold against _splat.
__device__ __forceinline__ float2 alpha_extent(float mx, float my, float ca, float cb, float cc,
                                               float op) {
  const float inf = __int_as_float(0x7f800000);
  if (!(fabsf(mx) + fabsf(my) + fabsf(ca) + fabsf(cb) + fabsf(cc) < inf)) {
    return make_float2(inf, inf);
  }
  if (op < kAlphaMin) return make_float2(-1.0f, -1.0f);
  const float det = ca * cc - cb * cb;
  const float ac = ca * cc;
  if (!(ca > 0.0f) || !(det > 1e-4f * ac) || !(ac < inf)) return make_float2(inf, inf);
  const float k = (2.0f * logf(255.0f * op) + 0.01f) * (1.01f + 1e-5f * (ac / det));
  return make_float2(sqrtf(k * cc / det) * 1.01f + 1.0f, sqrtf(k * ca / det) * 1.01f + 1.0f);
}

// The kernels cull pairs per cell: cell c (0..7) of a tile is the 8x4
// pixels at x = 8 * (c >> 2) + 0..7, y = 4 * (c & 3) + 0..3 from the
// tile's corner, and lane l of a warp holds pixel (l & 7, l >> 3) of a cell.
// Bit c of cell_mask: a pair of mean (mx, my) and half-extents `ext` may
// blend a pixel of cell c (pixel centres). Clear only when the pair's box
// misses the cell; a NaN mean or extent leaves the bit set, and so does an
// infinite mean with the infinite extents alpha_extent gives it.
// ops/blend_cuda.py:_cell_mask is the plain mirror.
constexpr int kCellW = 8;
constexpr int kCellH = 4;
constexpr int kCells = kTilePixels / (kCellW * kCellH);  // 8

__device__ __forceinline__ unsigned cell_mask(float mx, float my, float2 ext, float tx0,
                                              float ty0) {
  unsigned cols = 0, rows = 0;
#pragma unroll
  for (int cx = 0; cx < kTileSize / kCellW; ++cx) {
    const float x0 = tx0 + static_cast<float>(cx * kCellW);
    const float gap = fmaxf(fmaxf(x0 - mx, mx - (x0 + (kCellW - 1))), 0.0f);
    if (!(gap > ext.x)) cols |= 1u << cx;
  }
#pragma unroll
  for (int cy = 0; cy < kTileSize / kCellH; ++cy) {
    const float y0 = ty0 + static_cast<float>(cy * kCellH);
    const float gap = fmaxf(fmaxf(y0 - my, my - (y0 + (kCellH - 1))), 0.0f);
    if (!(gap > ext.y)) rows |= 1u << cy;
  }
  return ((cols & 1u) ? rows : 0u) | ((cols & 2u) ? rows << 4 : 0u);
}

// Ten per-lane values summed over the warp, ending as field f's total in
// the lanes returned by warp_sum10_field: a transposing butterfly in which
// every step halves the fields a lane carries (10 -> 5 -> 3 -> 2 -> 1, the
// odd counts padded with a zero), so 12 shuffles replace the 50 of ten
// separate trees. Returns this lane's total; warp_sum10_field says which
// field it is (-1: a padding slot, nothing to write).
__device__ __forceinline__ float warp_sum10(const float (&v)[kLiveRows], int lane) {
  constexpr unsigned kFull = 0xffffffffu;
  const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4, h2 = lane & 2;
  float a[6];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const float send = h16 ? v[i] : v[i + 5];
    a[i] = (h16 ? v[i + 5] : v[i]) + __shfl_xor_sync(kFull, send, 16);
  }
  a[5] = 0.0f;
  float b[4];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float send = h8 ? a[i] : a[i + 3];
    b[i] = (h8 ? a[i + 3] : a[i]) + __shfl_xor_sync(kFull, send, 8);
  }
  b[3] = 0.0f;
  float c[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = h4 ? b[i] : b[i + 2];
    c[i] = (h4 ? b[i + 2] : b[i]) + __shfl_xor_sync(kFull, send, 4);
  }
  float d = (h2 ? c[1] : c[0]) + __shfl_xor_sync(kFull, h2 ? c[0] : c[1], 2);
  return d + __shfl_xor_sync(kFull, d, 1);
}

__device__ __forceinline__ int warp_sum10_field(int lane) {
  const int ib = ((lane >> 2) & 1) * 2 + ((lane >> 1) & 1);  // slot after the 8-step
  const int ia = ((lane >> 3) & 1) * 3 + ib;                 // slot after the 16-step
  if ((lane & 1) || ib >= 3 || ia >= 5) return -1;          // odd lanes repeat even ones
  return ((lane >> 4) & 1) * 5 + ia;
}

// ---------------------------------------------------------------------------
// Work items of the blend kernels. A tile of at most `chunk` pairs is
// walked whole by one block, as the kernels always walked a tile. A longer
// ("long") tile is split into n = ceil(count / chunk) chunk items, chunk c
// holding its pairs [c * chunk, min(count, (c + 1) * chunk)), one block
// each. The plan (csrc/blend_forward.cu:blend_plan_kernel;
// ops/blend_cuda.py:blend_plan_torch is the plain mirror) is one int32
// buffer:
//   [0] chunk items,
//   first (T: each long tile's first chunk item, -1 for a short tile),
//   chunk items (chunk_cap: the tile of each, tile by tile in tile order,
//     so a long tile's chunks are the items first[t] .. first[t] + n - 1),
//   done (T: a long tile's chunks walked so far; the plan zeroes it).
// The cap follows from the pair capacity P alone: the counts sum to at most
// P, and a long tile of c > chunk pairs is n < c / chunk + 1 chunks, so
// there are at most ceil(P / chunk) + min(T, ceil(P / chunk)) chunk items.
// Grids are fixed by the tile count and this cap (at most kExtraBlocks
// blocks for the chunk list); a block walks the chunk items blockIdx.x,
// + the chunk blocks, ... below the plan's count, so the launches are
// capturable and read nothing on the host.
constexpr int kPlanHeader = 1;
constexpr int kExtraBlocks = 4096;

__host__ __device__ __forceinline__ int chunk_cap(int num_tiles, long long capacity, int chunk) {
  const int p = static_cast<int>((capacity + chunk - 1) / chunk);
  return p + (num_tiles < p ? num_tiles : p);
}

__host__ __device__ __forceinline__ int n_chunks(int count, int chunk) {
  return count > chunk ? (count - 1) / chunk + 1 : 1;
}

struct ChunkPlan {
  int n_chunk;
  const int* first;
  const int* chunk_items;
  int done_offset;  // done's entries from the plan's start
};

__device__ __forceinline__ ChunkPlan read_plan(const int* plan, int num_tiles, long long capacity,
                                               int chunk) {
  ChunkPlan p;
  p.n_chunk = plan[0];
  p.first = plan + kPlanHeader;
  p.chunk_items = p.first + num_tiles;
  p.done_offset = kPlanHeader + num_tiles + chunk_cap(num_tiles, capacity, chunk);
  return p;
}

// The boundary state of the long tiles' chunks, one slot of kTilePixels
// values per chunk item in each plane of (kScratchPlanes, chunk_cap, 256)
// float32 scratch: the chunk's local T (its blend from T = 1, read by the
// later chunks for their T_in), its T at its end (sign: see
// blend_forward.cu), the colour and depth accumulated through it (the
// local walk writes its own, the walk from T_in the chunk's part, the
// combine the sum over the tile's chunks up to this one), and n_contrib as
// int32 bits.
constexpr int kScratchPlanes = 7;
enum ScratchPlane { kPlaneLocalT = 0, kPlaneT = 1, kPlaneColor = 2, kPlaneLast = 6 };

}  // namespace b3dgs
