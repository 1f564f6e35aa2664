// Tile binning and the record gather of the render for Hopper (sm_90a):
// the depth key (bin_keys_kernel), the per-rank tile rectangles and pair
// counts (bin_count_kernel), the pairs' emission (bin_emit_kernel), a
// stable least-significant-digit radix sort of the emitted pairs by tile
// (bin_histogram_kernel, bin_scan_kernel, bin_scatter_kernel), the tile
// ranges (bin_ranges_kernel), the gather of each sorted pair's record
// (gather_forward_kernel) and its backward (gather_backward_kernel).
//
// Replaces no TPU kernel: the JAX package bins with XLA's sort and gathers
// with XLA (binocular3dgs_tpu/ops/binning.py, rasterize.py). In PyTorch the
// plain version (ops/binning.py:bin_gaussians_torch and the gathers of
// ops/rasterize.py) sizes every stage after the vertex stage to the pair
// capacity P = pairs_per_gaussian x rows: ~25 int64 elementwise operations,
// a searchsorted and a 64-bit radix sort over all P slots, a (10, P) gather,
// and in the backward a second sort of the P slots by gaussian, a
// searchsorted, a transposed gather and segment_reduce. At LLFF's size
// P = 12,582,912 and ~86% of the slots carry no pair; those sorts and
// gathers were most of the card's work outside the blend (PERF.md §5).
// Here every stage after the per-rank ones walks the emitted pairs only:
// E = min(wanted pairs, P), read from the device, never from the host.
//
// Contract (ops/binning.py, ops/rasterize.py), in depth-rank space:
//   * the depth key is depth where the row's radius is positive (both
//     extents for per-axis extents), +inf elsewhere; the caller sorts it
//     stably into `order` (a sort over the N rows, not the slots);
//   * rank i's clamped tile rectangle is ops/binning.py:tile_rect's (CUDA
//     getRect, clamped in float before the integer conversion) of row
//     order[i], its pair count span_x * span_y (0 where culled), its pairs
//     the emission slots [off[i], off[i + 1]) in row-major order over the
//     rectangle (off: the exclusive prefix sums, int64);
//   * the slots e < P are sorted by tile, stably in emission order, so each
//     tile's pairs come in ascending depth rank: exactly the order of the
//     plain version's sort of (tile << bits) | rank keys, whose keys are
//     distinct. Slots from P on are dropped, the deepest first.
// Outputs: pair_tile and pair_gauss on [0, E) (the slots from E on are not
// written), sorted_pos[e] for e < E (the sorted position of emission slot
// e, for the backward), tile_start/tile_count per tile (searchsorted's
// values: an empty tile starts where the next tile's pairs start),
// rank_offsets (N + 1, int32, saturated at 2^31 - 1), num_pairs (the wanted
// pairs, saturated alike) and E.
//
// The sort: pairs are cut into blocks of 4096 in emission order; each pass
// takes 8 bits of the tile id (2 passes up to 65,536 tiles, as ceil(bits /
// 8) of the largest tile id decides): a 256-bin histogram per block, one
// exclusive scan over the digit-major histograms, and a scatter in which
// each block sorts its items by the digit with CUB's stable block radix
// sort and writes each to its digit's global start plus its place among
// the block's items of that digit. Every pass is stable, so the result is
// stable in emission order; no segment length or tile count needs another
// path. The histograms count with shared-memory integer atomics, whose
// totals do not depend on their order.
//
// The gather backward sums, for each row, the cotangents of its rank's
// slots e from off[g] to min(off[g + 1], P), ascending, from 0.0f: within a
// rank, ascending emission slot is ascending tile, which is the order the
// plain backward's stable sort by gaussian gives its sorted pairs, so the
// sums are the same float additions in the same order as
// ops/rasterize.py:segment_sum_columns (its terms of the capacity's unused
// slots are +0.0 and change no sum that starts from +0.0). Each row is
// written by one thread (or, for a rank of more than 32 pairs, by its warp
// with one lane per field summing in the same order), the gradient goes
// straight to the row through `rank_of`, no float atomics: a training step
// repeats bit for bit. A rank's slots lie at random in sorted order, and a
// read at random costs a transaction however few bytes it takes: the ten
// rows of d_records would cost ten a slot. So a first kernel copies the
// cotangents, coalesced, into one 48-byte record a sorted slot, which the
// sums read at sorted_pos[e] in two sectors (on an H100 at LLFF's size,
// 0.26 ms for both against 0.56 for the sums reading the rows, and 0.37
// for scattering the records into emission order instead, with whole or
// partial sectors alike).
//
// What bounds them: bytes. Per emitted pair binning must write 12 B
// (pair_tile, pair_gauss, sorted_pos), the gather 40 B of record and the
// backward read its 40 B of cotangent; per row binning reads 20 B and
// writes 12, the backward writes 40 B of gradient, and an emitting row's
// 40 B of fields are read (chip_smoke.py phase 24 holds the stages to that
// sum). The sort moves ~60 B a pair more (emission 8, two passes of 4 + 8
// read and 8 written, the last pass's rank gather), the backward's records
// 48 + 48 + 4. No arithmetic is near the card's rate.
#include <cuda_runtime.h>

#include <climits>
#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>

namespace b3dgs {

constexpr int kRowThreads = 256;   // kernels over rows or ranks
constexpr int kSortThreads = 256;  // the sort's blocks: 16 pairs a thread
constexpr int kSortItems = 16;
constexpr int kSortTile = kSortThreads * kSortItems;
constexpr int kRadixBits = 8;
constexpr int kDigits = 1 << kRadixBits;
static_assert(kDigits == kSortThreads, "one digit per thread of a sort block");
constexpr int kScanThreads = 256;
constexpr int kGatherThreads = 256;
constexpr int kGatherBlocks = 2048;  // grid-stride over the emitted pairs
constexpr int kFields = 10;          // record rows: mx, my, conic a b c, opacity, rgb, depth
constexpr int kLongRank = 32;        // pairs above which a rank's warp sums it
constexpr int kRecordVecs = 3;       // float4s of a sorted slot's cotangent record (48 B)

inline int blocks_for(long long n, int threads) {
  const long long b = (n + threads - 1) / threads;
  return static_cast<int>(b < 1 ? 1 : b);
}

// blocks of a grid-stride loop over the pair capacity
inline int grid_stride_blocks(long long P) {
  const int b = blocks_for(P, kGatherThreads);
  return b < kGatherBlocks ? b : kGatherBlocks;
}

__device__ __forceinline__ bool extent_ok(const float* radius, int cols, long long row) {
  // radius > 0 (radius.amin(dim=1) > 0 for per-axis extents; NaN fails)
  if (cols == 2) return radius[2 * row] > 0.0f && radius[2 * row + 1] > 0.0f;
  return radius[row] > 0.0f;
}

// torch.clamp(torch.floor(v), 0, hi).to(torch.int32); the card's cast
// turns a NaN into 0, as fmaxf does here
__device__ __forceinline__ int tile_clip(float v, int hi) {
  return static_cast<int>(fminf(fmaxf(floorf(v), 0.0f), static_cast<float>(hi)));
}

// the rank g in [lo, hi] whose slots hold e: the last g with off[g] <= e
// (ranks without pairs share their offset with the next rank)
__device__ __forceinline__ long long rank_of_slot(const long long* __restrict__ off,
                                                  long long e, long long lo, long long hi) {
  while (lo < hi) {
    const long long mid = lo + (hi - lo + 1) / 2;
    if (__ldg(off + mid) <= e) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__global__ void __launch_bounds__(kRowThreads)
    bin_keys_kernel(const float* __restrict__ radius, int cols, const float* __restrict__ depth,
                    long long n, float* __restrict__ key) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) key[i] = extent_ok(radius, cols, i) ? depth[i] : __int_as_float(0x7f800000);
}

__global__ void __launch_bounds__(kRowThreads)
    bin_count_kernel(const long long* __restrict__ order, const float* __restrict__ mean2d,
                     const float* __restrict__ radius, int cols, long long n, int ts, int TW,
                     int TH, int* __restrict__ order32, int* __restrict__ rank_of,
                     int4* __restrict__ rect, long long* __restrict__ counts) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i == 0) counts[0] = 0;  // counts[i + 1] is rank i's: a cumsum gives the offsets
  if (i >= n) return;
  const long long row = order[i];
  order32[i] = static_cast<int>(row);
  rank_of[row] = static_cast<int>(i);
  const float px = mean2d[2 * row], py = mean2d[2 * row + 1];
  const float rx = cols == 2 ? radius[2 * row] : radius[row];
  const float ry = cols == 2 ? radius[2 * row + 1] : radius[row];
  const float t = static_cast<float>(ts);
  // tile_rect's expressions, one rounding an operation as PyTorch's
  const int x0 = tile_clip((px - rx) / t, TW), y0 = tile_clip((py - ry) / t, TH);
  const int x1 = tile_clip((((px + rx) + t) - 1.0f) / t, TW);
  const int y1 = tile_clip((((py + ry) + t) - 1.0f) / t, TH);
  const int sx = max(x1 - x0, 0), sy = max(y1 - y0, 0);
  rect[i] = make_int4(x0, y0, sx, sy);
  counts[i + 1] = extent_ok(radius, cols, row) ? static_cast<long long>(sx) * sy : 0;
}

// Emission: the slots of one sort block, each its tile and rank, and the
// block's histogram of the tile's lowest 8 bits. Block 0 writes the wanted
// pairs and E.
__global__ void __launch_bounds__(kSortThreads)
    bin_emit_kernel(const long long* __restrict__ off, const int4* __restrict__ rect,
                    long long n, long long P, int TW, int* __restrict__ tile_e,
                    int* __restrict__ rank_e, int* __restrict__ hist,
                    int* __restrict__ num_pairs, int* __restrict__ slots) {
  __shared__ int counts[kDigits];
  __shared__ long long bounds[2];
  const long long total = off[n];
  const long long E = total < P ? total : P;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *num_pairs = static_cast<int>(total < INT_MAX ? total : INT_MAX);
    *slots = static_cast<int>(E);
  }
  const long long base = static_cast<long long>(blockIdx.x) * kSortTile;
  if (base >= E) return;
  const long long nb = (E + kSortTile - 1) / kSortTile;
  const long long end = base + kSortTile < E ? base + kSortTile : E;
  counts[threadIdx.x] = 0;
  if (threadIdx.x == 0) bounds[0] = rank_of_slot(off, base, 0, n - 1);
  if (threadIdx.x == 1) bounds[1] = rank_of_slot(off, end - 1, 0, n - 1);
  __syncthreads();
  const long long hi = bounds[1];
  // blocked: each thread emits kSortItems consecutive slots, searching its
  // first slot's rank and walking from there
  const long long first = base + static_cast<long long>(threadIdx.x) * kSortItems;
  int tiles[kSortItems], ranks[kSortItems];
  if (first < end) {
    long long g = rank_of_slot(off, first, bounds[0], hi);
    long long next = __ldg(off + g + 1);
#pragma unroll
    for (int k = 0; k < kSortItems; ++k) {
      const long long e = first + k;
      if (e < end) {
        for (int step = 0; next <= e; ++step) {  // ranks without pairs share the offset
          g = step < 8 ? g + 1 : rank_of_slot(off, e, g + 1, hi);
          next = __ldg(off + g + 1);
        }
        const int4 r = rect[g];
        const int j = static_cast<int>(e - __ldg(off + g));
        tiles[k] = (r.y + j / r.z) * TW + r.x + j % r.z;
        ranks[k] = static_cast<int>(g);
        atomicAdd(&counts[tiles[k] & (kDigits - 1)], 1);
      }
    }
    if (first + kSortItems <= end) {
#pragma unroll
      for (int q = 0; q < kSortItems / 4; ++q) {
        reinterpret_cast<int4*>(tile_e + first)[q] =
            make_int4(tiles[4 * q], tiles[4 * q + 1], tiles[4 * q + 2], tiles[4 * q + 3]);
        reinterpret_cast<int4*>(rank_e + first)[q] =
            make_int4(ranks[4 * q], ranks[4 * q + 1], ranks[4 * q + 2], ranks[4 * q + 3]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kSortItems; ++k) {
        if (first + k < end) tile_e[first + k] = tiles[k], rank_e[first + k] = ranks[k];
      }
    }
  }
  __syncthreads();
  hist[threadIdx.x * nb + blockIdx.x] = counts[threadIdx.x];
}

// A later pass's histograms: each block's count of the digit at `shift`.
__global__ void __launch_bounds__(kSortThreads)
    bin_histogram_kernel(const unsigned* __restrict__ keys, const int* __restrict__ slots,
                         int shift, int* __restrict__ hist) {
  __shared__ int counts[kDigits];
  const long long E = *slots;
  const long long base = static_cast<long long>(blockIdx.x) * kSortTile;
  if (base >= E) return;
  const long long nb = (E + kSortTile - 1) / kSortTile;
  counts[threadIdx.x] = 0;
  __syncthreads();
  for (int k = 0; k < kSortItems; ++k) {
    const long long e = base + static_cast<long long>(k) * kSortThreads + threadIdx.x;
    if (e < E) atomicAdd(&counts[(keys[e] >> shift) & (kDigits - 1)], 1);
  }
  __syncthreads();
  hist[threadIdx.x * nb + blockIdx.x] = counts[threadIdx.x];
}

// Each digit's row of the histograms (one block a digit; a row holds the
// digit's count in each sort block): exclusive prefix sums in place, and
// the digit's total. The scatter adds the totals of the lower digits.
__global__ void __launch_bounds__(kScanThreads)
    bin_scan_kernel(int* __restrict__ hist, const int* __restrict__ slots,
                    int* __restrict__ totals) {
  using Scan = cub::BlockScan<int, kScanThreads>;
  __shared__ typename Scan::TempStorage tmp;
  __shared__ int carry;
  const long long E = *slots;
  const int nb = static_cast<int>((E + kSortTile - 1) / kSortTile);
  int* row = hist + static_cast<long long>(blockIdx.x) * nb;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < nb; base += kScanThreads) {
    const int i = base + threadIdx.x;
    int prefix, total;
    Scan(tmp).ExclusiveSum(i < nb ? row[i] : 0, prefix, total);
    const int c = carry;
    if (i < nb) row[i] = c + prefix;
    __syncthreads();
    if (threadIdx.x == 0) carry = c + total;
    __syncthreads();
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// One pass's scatter. kFirst: the keys are the emission's tiles and the
// values the emission slots themselves. kLast: writes pair_tile, pair_gauss
// (the rank of the slot) and sorted_pos instead of the next pass's input.
template <bool kFirst, bool kLast>
__global__ void __launch_bounds__(kSortThreads)
    bin_scatter_kernel(const unsigned* __restrict__ keys_in, const int* __restrict__ vals_in,
                       const int* __restrict__ slots, const int* __restrict__ scanned,
                       const int* __restrict__ totals, int shift,
                       unsigned* __restrict__ keys_out, int* __restrict__ vals_out,
                       const int* __restrict__ rank_e, int* __restrict__ sorted_pos) {
  using Sort = cub::BlockRadixSort<unsigned, kSortThreads, kSortItems, int>;
  using Scan = cub::BlockScan<int, kSortThreads>;
  __shared__ union {
    typename Sort::TempStorage sort;
    typename Scan::TempStorage scan;
  } tmp;
  __shared__ int counts[kDigits], local_start[kDigits], global_start[kDigits];
  const long long E = *slots;
  const long long base = static_cast<long long>(blockIdx.x) * kSortTile;
  if (base >= E) return;
  const long long nb = (E + kSortTile - 1) / kSortTile;
  const int n_valid = static_cast<int>(E - base < kSortTile ? E - base : kSortTile);
  counts[threadIdx.x] = 0;
  __syncthreads();
  unsigned keys[kSortItems];
  int vals[kSortItems];
  const int first = threadIdx.x * kSortItems;  // blocked: the block's order is emission order
  if (first + kSortItems <= n_valid) {
    const uint4* k4 = reinterpret_cast<const uint4*>(keys_in + base + first);
#pragma unroll
    for (int q = 0; q < kSortItems / 4; ++q) {
      const uint4 v = k4[q];
      keys[4 * q] = v.x, keys[4 * q + 1] = v.y, keys[4 * q + 2] = v.z, keys[4 * q + 3] = v.w;
    }
    if (kFirst) {
#pragma unroll
      for (int k = 0; k < kSortItems; ++k) vals[k] = static_cast<int>(base) + first + k;
    } else {
      const int4* v4 = reinterpret_cast<const int4*>(vals_in + base + first);
#pragma unroll
      for (int q = 0; q < kSortItems / 4; ++q) {
        const int4 v = v4[q];
        vals[4 * q] = v.x, vals[4 * q + 1] = v.y, vals[4 * q + 2] = v.z, vals[4 * q + 3] = v.w;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kSortItems; ++k) {
      const int i = first + k;
      // past E: the largest digit, after every valid item of that digit
      keys[k] = i < n_valid ? keys_in[base + i] : 0xffffffffu;
      vals[k] = i < n_valid ? (kFirst ? static_cast<int>(base) + i : vals_in[base + i]) : -1;
    }
  }
#pragma unroll
  for (int k = 0; k < kSortItems; ++k)
    if (first + k < n_valid) atomicAdd(&counts[(keys[k] >> shift) & (kDigits - 1)], 1);
  __syncthreads();
  int start, digit_base;
  Scan(tmp.scan).ExclusiveSum(counts[threadIdx.x], start);
  __syncthreads();
  Scan(tmp.scan).ExclusiveSum(totals[threadIdx.x], digit_base);
  local_start[threadIdx.x] = start;
  global_start[threadIdx.x] = digit_base + scanned[threadIdx.x * nb + blockIdx.x];
  __syncthreads();
  Sort(tmp.sort).SortBlockedToStriped(keys, vals, shift, shift + kRadixBits);
#pragma unroll
  for (int k = 0; k < kSortItems; ++k) {
    const int i = k * kSortThreads + threadIdx.x;  // striped: the item's place in the block
    if (i < n_valid) {
      const int d = (keys[k] >> shift) & (kDigits - 1);
      const int pos = global_start[d] + i - local_start[d];
      keys_out[pos] = keys[k];
      if (kLast) {
        vals_out[pos] = rank_e[vals[k]];
        sorted_pos[vals[k]] = pos;
      } else {
        vals_out[pos] = vals[k];
      }
    }
  }
}

__device__ __forceinline__ int lower_bound(const int* __restrict__ a, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(a + mid) < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Each tile's [start, start + count) of the sorted pairs, and the int32
// rank offsets.
__global__ void __launch_bounds__(kRowThreads)
    bin_ranges_kernel(const int* __restrict__ pair_tile, const int* __restrict__ slots, int T,
                      const long long* __restrict__ off, long long n,
                      int* __restrict__ tile_start, int* __restrict__ tile_count,
                      int* __restrict__ rank_offsets) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < T) {
    const int E = *slots;
    const int lo = lower_bound(pair_tile, E, static_cast<int>(i));
    tile_start[i] = lo;
    tile_count[i] = lower_bound(pair_tile, E, static_cast<int>(i) + 1) - lo;
  }
  if (i <= n) rank_offsets[i] = static_cast<int>(off[i] < INT_MAX ? off[i] : INT_MAX);
}

// records (10, P): the sorted pairs' rows of the projected fields.
__global__ void __launch_bounds__(kGatherThreads)
    gather_forward_kernel(const float* __restrict__ mean2d, const float* __restrict__ conic,
                          const float* __restrict__ opacity, const float* __restrict__ color,
                          const float* __restrict__ depth, const int* __restrict__ order,
                          const int* __restrict__ pair_gauss, const int* __restrict__ slots,
                          long long P, float* __restrict__ records) {
  const long long E = *slots;
  for (long long s = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; s < E;
       s += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long row = order[pair_gauss[s]];
    const float f[kFields] = {mean2d[2 * row], mean2d[2 * row + 1], conic[3 * row],
                              conic[3 * row + 1], conic[3 * row + 2], opacity[row],
                              color[3 * row], color[3 * row + 1], color[3 * row + 2], depth[row]};
#pragma unroll
    for (int q = 0; q < kFields; ++q) records[q * P + s] = f[q];
  }
}

// The sorted pairs' cotangents (10, P) as one 48-byte record a sorted
// slot (the 10 fields and 2 floats of padding), so that the backward's
// reads at random take two sectors a slot where the rows take ten. Reads
// and writes are coalesced: neighbouring threads write neighbouring
// records, whole sectors.
__global__ void __launch_bounds__(kGatherThreads)
    gather_transpose_kernel(const float* __restrict__ d, long long P,
                            const int* __restrict__ slots, float4* __restrict__ d_s) {
  const long long E = *slots;
  for (long long s = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; s < E;
       s += static_cast<long long>(gridDim.x) * blockDim.x) {
    float4* out = d_s + s * kRecordVecs;
    out[0] = make_float4(d[s], d[P + s], d[2 * P + s], d[3 * P + s]);
    out[1] = make_float4(d[4 * P + s], d[5 * P + s], d[6 * P + s], d[7 * P + s]);
    out[2] = make_float4(d[8 * P + s], d[9 * P + s], 0.0f, 0.0f);
  }
}

// The fields' gradients, one row a thread (rows in order, so the writes
// coalesce): its rank's cotangents summed in emission order from 0.0f.
__global__ void __launch_bounds__(kRowThreads)
    gather_backward_kernel(const float4* __restrict__ d_s, long long P,
                           const int* __restrict__ sorted_pos,
                           const int* __restrict__ rank_offsets, const int* __restrict__ rank_of,
                           long long n, float* __restrict__ g_mean2d,
                           float* __restrict__ g_conic, float* __restrict__ g_opacity,
                           float* __restrict__ g_color, float* __restrict__ g_depth) {
  __shared__ float buf[kRowThreads / 32][32 * kFields];
  const long long r = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cap = static_cast<int>(P);
  int lo = 0, hi = 0;
  if (r < n) {
    const int g = rank_of[r];
    lo = min(rank_offsets[g], cap);
    hi = min(rank_offsets[g + 1], cap);
  }
  float acc[kFields];
#pragma unroll
  for (int q = 0; q < kFields; ++q) acc[q] = 0.0f;
  const bool is_long = hi - lo > kLongRank;
  if (!is_long) {
#pragma unroll 4
    for (int e = lo; e < hi; ++e) {
      const float4* rec = d_s + static_cast<long long>(sorted_pos[e]) * kRecordVecs;
      const float4 a = rec[0], b = rec[1], c = rec[2];
      acc[0] += a.x, acc[1] += a.y, acc[2] += a.z, acc[3] += a.w;
      acc[4] += b.x, acc[5] += b.y, acc[6] += b.z, acc[7] += b.w;
      acc[8] += c.x, acc[9] += c.y;
    }
  }
  // a long rank's slots, 32 at a time by the whole warp; lane q < 10 adds
  // field q's terms in the same ascending order
  unsigned longs = __ballot_sync(0xffffffffu, is_long);
  while (longs) {
    const int src = __ffs(longs) - 1;
    longs &= longs - 1;
    const int l_lo = __shfl_sync(0xffffffffu, lo, src), l_hi = __shfl_sync(0xffffffffu, hi, src);
    float a = 0.0f;
    for (int chunk = l_lo; chunk < l_hi; chunk += 32) {
      const int m = min(32, l_hi - chunk);
      if (lane < m) {
        const float* rec = reinterpret_cast<const float*>(
            d_s + static_cast<long long>(sorted_pos[chunk + lane]) * kRecordVecs);
#pragma unroll
        for (int q = 0; q < kFields; ++q) buf[warp][lane * kFields + q] = rec[q];
      }
      __syncwarp();
      if (lane < kFields)
        for (int k = 0; k < m; ++k) a += buf[warp][k * kFields + lane];
      __syncwarp();
    }
#pragma unroll
    for (int q = 0; q < kFields; ++q) {
      const float v = __shfl_sync(0xffffffffu, a, q);
      if (lane == src) acc[q] = v;
    }
  }
  if (r < n) {
    g_mean2d[2 * r] = acc[0], g_mean2d[2 * r + 1] = acc[1];
    g_conic[3 * r] = acc[2], g_conic[3 * r + 1] = acc[3], g_conic[3 * r + 2] = acc[4];
    g_opacity[r] = acc[5];
    g_color[3 * r] = acc[6], g_color[3 * r + 1] = acc[7], g_color[3 * r + 2] = acc[8];
    g_depth[r] = acc[9];
  }
}

}  // namespace b3dgs

// radius: (n, cols) float32 (cols 1 or 2); depth (n,); writes key (n,).
// One launch on `stream`.
extern "C" int b3dgs_bin_keys(const float* radius, int cols, const float* depth, long long n,
                              float* key, void* stream) {
  if (n < 0 || (cols != 1 && cols != 2)) return cudaErrorInvalidValue;
  if (n > 0)
    b3dgs::bin_keys_kernel<<<b3dgs::blocks_for(n, b3dgs::kRowThreads), b3dgs::kRowThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(radius, cols, depth, n, key);
  return static_cast<int>(cudaGetLastError());
}

// order: (n,) int64, the key's stable sort; mean2d (n, 2), radius (n, cols)
// float32; writes order32 (n,), rank_of (n,), rect (n, 4) int32 and counts
// (n + 1,) int64 (0, then each rank's pair count). One launch on `stream`.
extern "C" int b3dgs_bin_count(const long long* order, const float* mean2d, const float* radius,
                               int cols, long long n, int ts, int TW, int TH, int* order32,
                               int* rank_of, int* rect, long long* counts, void* stream) {
  if (n < 0 || (cols != 1 && cols != 2) || ts <= 0 || TW <= 0 || TH <= 0)
    return cudaErrorInvalidValue;
  b3dgs::bin_count_kernel<<<b3dgs::blocks_for(n, b3dgs::kRowThreads), b3dgs::kRowThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      order, mean2d, radius, cols, n, ts, TW, TH, order32, rank_of,
      reinterpret_cast<int4*>(rect), counts);
  return static_cast<int>(cudaGetLastError());
}

// off: (n + 1,) int64 offsets (n >= 1); rect from b3dgs_bin_count; P the
// pair capacity (1 <= P <= 2^31 - 1); T tiles in rows of TW; `passes` of 8
// bits cover the largest tile id. Scratch: tile_e, rank_e (P,) int32, hist
// (256 * ceil(P / 4096) + 256,) int32, key_a/val_a (P,) when passes > 1 and
// key_b/val_b (P,) when passes > 2. Writes pair_tile, pair_gauss,
// sorted_pos (on [0, E)), tile_start, tile_count (T,), rank_offsets
// (n + 1,), num_pairs and slots (E). 1 + 3 * passes launches on `stream`:
// emission, per pass a histogram (the first pass's is the emission's), a
// scan and a scatter, and the tile ranges.
extern "C" int b3dgs_bin_sort(const long long* off, const int* rect, long long n, long long P,
                              int TW, int T, int passes, int* tile_e, int* rank_e, int* key_a,
                              int* val_a, int* key_b, int* val_b, int* hist, int* pair_tile,
                              int* pair_gauss, int* sorted_pos, int* tile_start, int* tile_count,
                              int* rank_offsets, int* num_pairs, int* slots, void* stream) {
  using namespace b3dgs;
  if (n < 1 || P < 1 || P > INT_MAX || T < 1 || TW < 1 || passes < 1 || passes > 4 ||
      (passes > 1 && (key_a == nullptr || val_a == nullptr)) ||
      (passes > 2 && (key_b == nullptr || val_b == nullptr)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = blocks_for(P, kSortTile);
  int* totals = hist + static_cast<long long>(kDigits) * blocks;
  bin_emit_kernel<<<blocks, kSortThreads, 0, s>>>(off, reinterpret_cast<const int4*>(rect), n,
                                                   P, TW, tile_e, rank_e, hist, num_pairs, slots);
  const unsigned* kin = reinterpret_cast<const unsigned*>(tile_e);
  const int* vin = nullptr;
  for (int p = 0; p < passes; ++p) {
    const int shift = kRadixBits * p;
    if (p > 0) bin_histogram_kernel<<<blocks, kSortThreads, 0, s>>>(kin, slots, shift, hist);
    bin_scan_kernel<<<kDigits, kScanThreads, 0, s>>>(hist, slots, totals);
    const bool last = p == passes - 1;
    unsigned* kout = reinterpret_cast<unsigned*>(last ? pair_tile : (p % 2 == 0 ? key_a : key_b));
    int* vout = last ? pair_gauss : (p % 2 == 0 ? val_a : val_b);
    if (p == 0 && last)
      bin_scatter_kernel<true, true><<<blocks, kSortThreads, 0, s>>>(
          kin, vin, slots, hist, totals, shift, kout, vout, rank_e, sorted_pos);
    else if (p == 0)
      bin_scatter_kernel<true, false><<<blocks, kSortThreads, 0, s>>>(
          kin, vin, slots, hist, totals, shift, kout, vout, rank_e, sorted_pos);
    else if (last)
      bin_scatter_kernel<false, true><<<blocks, kSortThreads, 0, s>>>(
          kin, vin, slots, hist, totals, shift, kout, vout, rank_e, sorted_pos);
    else
      bin_scatter_kernel<false, false><<<blocks, kSortThreads, 0, s>>>(
          kin, vin, slots, hist, totals, shift, kout, vout, rank_e, sorted_pos);
    kin = kout;
    vin = vout;
  }
  const long long ranges = T > n + 1 ? T : n + 1;
  bin_ranges_kernel<<<blocks_for(ranges, kRowThreads), kRowThreads, 0, s>>>(
      pair_tile, slots, T, off, n, tile_start, tile_count, rank_offsets);
  return static_cast<int>(cudaGetLastError());
}

// The projected fields, contiguous: mean2d (n, 2), conic (n, 3), opacity
// (n,), color (n, 3), depth (n,); order (n,), pair_gauss (P,) and slots
// from b3dgs_bin_sort. Writes records (10, P) on its first E columns. One
// launch on `stream`.
extern "C" int b3dgs_gather_forward(const float* mean2d, const float* conic,
                                    const float* opacity, const float* color, const float* depth,
                                    const int* order, const int* pair_gauss, const int* slots,
                                    long long P, float* records, void* stream) {
  using namespace b3dgs;
  if (P < 1) return cudaErrorInvalidValue;
  gather_forward_kernel<<<grid_stride_blocks(P), kGatherThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      mean2d, conic, opacity, color, depth, order, pair_gauss, slots, P, records);
  return static_cast<int>(cudaGetLastError());
}

// d_records (10, P) float32; sorted_pos (P,), slots, rank_offsets (n + 1,)
// and rank_of (n,) from binning; d_s: scratch of 12 * P floats, 16-byte
// aligned; writes the gradients of mean2d (n, 2), conic (n, 3), opacity
// (n,), color (n, 3) and depth (n,) whole. Two launches on `stream`.
extern "C" int b3dgs_gather_backward(const float* d_records, long long P, const int* sorted_pos,
                                     const int* slots, const int* rank_offsets,
                                     const int* rank_of, long long n, float* d_s,
                                     float* g_mean2d, float* g_conic, float* g_opacity,
                                     float* g_color, float* g_depth, void* stream) {
  using namespace b3dgs;
  if (P < 1 || P > INT_MAX || n < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gather_transpose_kernel<<<grid_stride_blocks(P), kGatherThreads, 0, s>>>(
      d_records, P, slots, reinterpret_cast<float4*>(d_s));
  gather_backward_kernel<<<blocks_for(n, kRowThreads), kRowThreads, 0, s>>>(
      reinterpret_cast<const float4*>(d_s), P, sorted_pos, rank_offsets, rank_of, n, g_mean2d,
      g_conic, g_opacity, g_color, g_depth);
  return static_cast<int>(cudaGetLastError());
}
