// The masked Adam update of the training step over the six parameter groups,
// in one launch (sm_90a).
//
// Contract (train/state.py:adam_update_torch, the plain composition, and the
// reference scene/gaussian_model.py's per-group torch Adam with eps 1e-15):
// for each group's value p with gradient g and moments m, v, in a row whose
// `active` byte is set,
//   m = 0.9 m + 0.1 g,  v = 0.999 v + 0.001 g*g,
//   p = p - lr * (m * c1) / (sqrt(v * c2) + 1e-15),
// c1 and c2 the bias corrections' factors (state.py:bias_corrections); in
// an inactive row the gradient counts as 0: the moments decay and p keeps
// its value. Every operation rounds as the plain composition's PyTorch
// kernel for it does on the card, in its order: a product or sum of two
// float32 values, rounded once (the library builds with --fmad=false and
// each operation here is an explicit round-to-nearest intrinsic, so nothing
// contracts), an IEEE square root and an IEEE division; each Python number
// becomes the float32 that PyTorch makes of the double (0.1f is
// float(1.0 - 0.9)). So the kernel writes the plain composition's bits,
// NaN and inf included, and a training run is the same run.
//
// What bounds it: bytes. An active value reads p, g, m, v and writes p, m,
// v (28 B); an inactive one reads and writes m and v (16 B): p and g are
// neither read nor written. The plain composition launches 18 elementwise
// operations on each group (~40 passes over the state in all); this is
// one. A thread takes four consecutive values of a group's flat (rows x
// width) range, loaded and stored as float4 where the group's four base
// pointers are 16-byte aligned and the four values are all active or all
// inactive; a chunk that straddles a row of the other kind, the range's
// last partial chunk and an unaligned group (a row slice at an odd offset)
// go value by value. The mask is read once for each row a chunk touches.
// Each block belongs to one group, so a block's threads take one path but
// at the few chunks that straddle. (A value a thread, coalesced, took 1.23x and 1.15x this
// design's time at the two benchmark cells' capacities on an H100, and four
// values a thread 256 apart 1.09x and 1.05x.)
//
// The rates are numbers but xyz's, which, like the two factors, is read
// from device memory at launch where its pointer is not null: a CUDA
// graph's 0-d inputs, so that one captured update serves every step. No
// atomics, no host read, no allocation.
#include <cuda_runtime.h>

#include <cstdint>

namespace b3dgs {

constexpr int kAdamGroups = 6;
constexpr int kAdamThreads = 256;
// train/state.py's ADAM_B1, ADAM_B2 and ADAM_EPS, and the plain
// composition's (1.0 - ADAM_B1) and (1.0 - ADAM_B2), as PyTorch rounds a
// double to float32
constexpr float kB1 = static_cast<float>(0.9);
constexpr float kB1c = static_cast<float>(1.0 - 0.9);
constexpr float kB2 = static_cast<float>(0.999);
constexpr float kB2c = static_cast<float>(1.0 - 0.999);
constexpr float kEps = static_cast<float>(1e-15);

struct AdamGroup {
  float* p;
  const float* g;
  float* m;
  float* v;
  unsigned width;        // values a row (0 for an empty group)
  unsigned values;       // rows x width
  unsigned first_block;  // the group's first block in the grid
  bool vec;              // p, g, m and v 16-byte aligned
  float lr;
};

struct AdamArgs {
  AdamGroup group[kAdamGroups];
  const uint8_t* active;
  const float* lr0_dev;  // where not null, group 0's (xyz's) rate on the device
  float c1, c2;
  const float* c1_dev;  // where not null, the factor on the device
  const float* c2_dev;
};

struct AdamRates {
  float lr, c1, c2;
};

// The moments after one step with gradient g (0 in an inactive row).
__device__ __forceinline__ void adam_moments(float g, float& m, float& v) {
  m = __fadd_rn(__fmul_rn(kB1, m), __fmul_rn(kB1c, g));
  v = __fadd_rn(__fmul_rn(kB2, v), __fmul_rn(kB2c, __fmul_rn(g, g)));
}

// p after one step, from the updated moments.
__device__ __forceinline__ float adam_param(float p, float m, float v, const AdamRates& r) {
  const float num = __fmul_rn(r.lr, __fmul_rn(m, r.c1));
  const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v, r.c2)), kEps);
  return __fsub_rn(p, __fdiv_rn(num, den));
}

__device__ __forceinline__ void adam_value(const AdamGroup& G, unsigned e, bool on,
                                           const AdamRates& r) {
  float m = G.m[e], v = G.v[e];
  adam_moments(on ? G.g[e] : 0.0f, m, v);
  G.m[e] = m;
  G.v[e] = v;
  if (on) G.p[e] = adam_param(G.p[e], m, v, r);
}

// Values 4c .. 4c + 3 of the group's range.
__device__ __forceinline__ void adam_chunk(const AdamGroup& G, unsigned c, const uint8_t* active,
                                           const AdamRates& r) {
  const unsigned e0 = 4u * c;
  const unsigned n = min(4u, G.values - e0);
  unsigned row = e0 / G.width, col = e0 - row * G.width;
  bool on[4];
  uint8_t a = active[row];
  unsigned count = 0;
#pragma unroll
  for (unsigned j = 0; j < 4; ++j) {
    on[j] = j < n && a != 0;
    count += on[j];
    if (++col == G.width && j + 1 < n) {
      col = 0;
      a = active[++row];
    }
  }
  if (n == 4 && G.vec && (count == 0 || count == 4)) {
    float4 m = reinterpret_cast<const float4*>(G.m)[c];
    float4 v = reinterpret_cast<const float4*>(G.v)[c];
    if (count == 4) {
      const float4 g = reinterpret_cast<const float4*>(G.g)[c];
      float4 p = reinterpret_cast<const float4*>(G.p)[c];
      adam_moments(g.x, m.x, v.x);
      adam_moments(g.y, m.y, v.y);
      adam_moments(g.z, m.z, v.z);
      adam_moments(g.w, m.w, v.w);
      p.x = adam_param(p.x, m.x, v.x, r);
      p.y = adam_param(p.y, m.y, v.y, r);
      p.z = adam_param(p.z, m.z, v.z, r);
      p.w = adam_param(p.w, m.w, v.w, r);
      reinterpret_cast<float4*>(G.p)[c] = p;
    } else {
      adam_moments(0.0f, m.x, v.x);
      adam_moments(0.0f, m.y, v.y);
      adam_moments(0.0f, m.z, v.z);
      adam_moments(0.0f, m.w, v.w);
    }
    reinterpret_cast<float4*>(G.m)[c] = m;
    reinterpret_cast<float4*>(G.v)[c] = v;
  } else {
    for (unsigned j = 0; j < n; ++j) adam_value(G, e0 + j, on[j], r);
  }
}

__global__ void __launch_bounds__(kAdamThreads) adam_update_kernel(
    const __grid_constant__ AdamArgs a) {
  // the group whose blocks hold this one: the last whose first block is at
  // or before it (an empty group's first block is its successor's)
#pragma unroll
  for (int k = kAdamGroups - 1; k >= 0; --k) {
    const AdamGroup& G = a.group[k];
    if (blockIdx.x >= G.first_block) {
      const unsigned c = (blockIdx.x - G.first_block) * kAdamThreads + threadIdx.x;
      if (c < (G.values + 3u) / 4u) {
        const AdamRates r{k == 0 && a.lr0_dev ? *a.lr0_dev : G.lr,
                          a.c1_dev ? *a.c1_dev : a.c1, a.c2_dev ? *a.c2_dev : a.c2};
        adam_chunk(G, c, a.active, r);
      }
      return;
    }
  }
}

AdamGroup adam_group(float* p, const float* g, float* m, float* v, int width, float lr,
                     int rows) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g) |
                          reinterpret_cast<uintptr_t>(m) | reinterpret_cast<uintptr_t>(v);
  return AdamGroup{p, g, m, v, static_cast<unsigned>(width),
                   static_cast<unsigned>(rows) * static_cast<unsigned>(width), 0u,
                   bases % 16 == 0, lr};
}

}  // namespace b3dgs

// One Adam step of the six groups (xyz, f_dc, f_rest, opacity, scaling,
// rotation, in that order), in place. Each group: p, its gradient g and
// its moments m, v, contiguous (rows, width) float32, width values a row
// (rows x width < 2^31), and its rate lrN; xyz's rate is the float at
// lr0_dev where that is not null. active: (rows,) bytes, non-zero for an
// active row. c1, c2: the bias corrections' factors, or the floats at
// c1_dev, c2_dev where those are not null. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int b3dgs_adam_update(
    float* p0, const float* g0, float* m0, float* v0, int w0, float lr0, const float* lr0_dev,
    float* p1, const float* g1, float* m1, float* v1, int w1, float lr1,
    float* p2, const float* g2, float* m2, float* v2, int w2, float lr2,
    float* p3, const float* g3, float* m3, float* v3, int w3, float lr3,
    float* p4, const float* g4, float* m4, float* v4, int w4, float lr4,
    float* p5, const float* g5, float* m5, float* v5, int w5, float lr5,
    const uint8_t* active, int rows, float c1, const float* c1_dev, float c2,
    const float* c2_dev, void* stream) {
  using b3dgs::adam_group;
  b3dgs::AdamArgs a{{adam_group(p0, g0, m0, v0, w0, lr0, rows),
                     adam_group(p1, g1, m1, v1, w1, lr1, rows),
                     adam_group(p2, g2, m2, v2, w2, lr2, rows),
                     adam_group(p3, g3, m3, v3, w3, lr3, rows),
                     adam_group(p4, g4, m4, v4, w4, lr4, rows),
                     adam_group(p5, g5, m5, v5, w5, lr5, rows)},
                    active, lr0_dev, c1, c2, c1_dev, c2_dev};
  unsigned blocks = 0;
  for (b3dgs::AdamGroup& G : a.group) {
    G.first_block = blocks;
    blocks += (G.values + 4u * b3dgs::kAdamThreads - 1) / (4u * b3dgs::kAdamThreads);
  }
  if (blocks > 0)
    b3dgs::adam_update_kernel<<<blocks, b3dgs::kAdamThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
