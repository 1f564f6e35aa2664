// Vertex stage of the render for Hopper (sm_90a): the forward
// (project_forward_kernel) and its backward (project_backward_kernel), one
// thread per capacity row.
//
// Replaces no TPU kernel: the JAX vertex stage (binocular3dgs_tpu/ops/
// project.py) is XLA, which fuses its elementwise algebra into a few
// loops. In PyTorch the same algebra ran as 307 device operations a render
// forward and 579 in autograd's backward, over columns of the 1,048,576
// capacity rows; both benchmark cells render twice a step, and the host's
// dispatch of those ~1,760 launches an iteration was the largest share of
// the card's idle time (PERF.md §5, by the program's own ranges). This is
// that profile's kernel.
//
// Contract: ops/project.py:project_gaussians on the raw leaves, in its order
// of operations, float32, built with --fmad=false like the other kernels so
// that each product and sum rounds as one PyTorch op does:
//   * xyz through world_view (view-space point, depth) and full_proj (clip
//     point), the z <= znear_cull cull, the 1e-7-guarded homogeneous divide,
//     NDC to pixels, plus the optional mean2d carrier * (W/2, H/2);
//   * cov3d from exp(scaling) and the normalised quaternion; EWA with the
//     1.3 tan(fov) clamp of the linearisation point (culled rows at the
//     dummy point (0, 0, 1)) and the dilation; det, conic, radius =
//     ceil(3 sqrt(lambda_max)); the tight bin_extent from sigmoid(opacity);
//     invisible rows sanitised (mean2d 0, conic (1, 0, 1), depth 0,
//     opacity 0, radius 0, bin_extent 0);
//   * SH of degree D (a template parameter, 0-3) at the normalised view
//     direction, +0.5, clamped at 0 (colour is not masked by visibility).
// Two pieces of the plain version are not elementwise: the 4-term camera
// products (cuBLAS, which fuses them) and the norms of the quaternion and
// of the view direction (PyTorch's reductions, which sum in their own
// order). The kernel reproduces both orders as measured on the card, with
// explicit fused multiply-adds for the products, so that on the card its
// outputs equal the plain version's bit for bit. That matters beyond the
// tolerances of a test: a last-bit difference in a conic moves pairs
// across the blend's 1/255 cut, and the benchmark's reference, which runs
// the plain version's operations, then parts from the program by far more
// than rounding (PERF.md §6, the vertex kernels' finding).
//
// The backward recomputes every intermediate from the raw leaves in
// registers (nothing is saved beyond the inputs) and writes the gradient
// of every leaf and of the carrier, autograd's conventions included: clamp
// passes a gradient at its bounds (inclusive), torch.where's masks, the
// clamp of the direction's norm at 1e-8, the colour's clamp at 0; the
// cotangents of mean2d, depth, conic and opacity count only on visible
// rows (where the forward sanitised them), the colour's on every row;
// radius, visible and bin_extent carry none. Each row is written by its own
// thread, so the result does not depend on scheduling and a training step
// repeats bit for bit. Its formulas are ops/project.py:
// project_backward_torch's, row for row.
//
// What bounds them on the card: bytes. At SH degree 1 the forward reads
// 101 B a row (xyz 12, f_dc 12, f_rest 36, opacity 4, scaling 12, rotation
// 16, active 1, carrier 8) and writes 53 B (mean2d 8, depth 4, conic 12,
// colour 12, opacity 4, radius 4, visible 1, bin_extent 8); the backward
// reads the 93 B of the leaves and 40 B of cotangents and writes 100 B of
// gradients. ~300 FP32 operations a row forward and ~700 backward are far
// below the card's rate at those byte counts (at 3.35 TB/s a row's bytes
// take ~45-70 ps, the card's 33.5e12 FP32 instructions/s ~9 and ~21 ps).
// So the design is what a memory-bound per-row map wants: one thread per
// row, every load issued before the arithmetic, no shared memory but the
// camera's 37 floats (staged once per block), no reduction across rows.
// Neighbouring threads read neighbouring rows, so each warp's loads cover
// contiguous spans of every field.
#include <cuda_runtime.h>

#include <cstdint>

namespace b3dgs {

constexpr int kProjThreads = 256;
constexpr int kCamFloats = 37;  // world_view 16, full_proj 16, cam_center 3, tanfovx, tanfovy

// SH constants (core/sh.py), each rounded once to float32 as PyTorch rounds
// a Python float against a float32 tensor
constexpr float kC0 = 0.28209479177387814;
constexpr float kC1 = 0.4886025119029199;
constexpr float kC2_0 = 1.0925484305920792;
constexpr float kC2_1 = -1.0925484305920792;
constexpr float kC2_2 = 0.31539156525252005;
constexpr float kC2_3 = -1.0925484305920792;
constexpr float kC2_4 = 0.5462742152960396;
constexpr float kC3_0 = -0.5900435899266435;
constexpr float kC3_1 = 2.890611442640554;
constexpr float kC3_2 = -0.4570457994644658;
constexpr float kC3_3 = 0.3731763325901154;
constexpr float kC3_4 = -0.4570457994644658;
constexpr float kC3_5 = 1.445305721320277;
constexpr float kC3_6 = -0.5900435899266435;

struct ProjectArgs {
  const float* xyz;       // (n, 3)
  const float* f_dc;      // (n, 1, 3)
  const float* f_rest;    // (n, k_rest, 3)
  const float* opacity;   // (n, 1) pre-sigmoid
  const float* scaling;   // (n, 3) log-scale
  const float* rotation;  // (n, 4) unnormalised (w, x, y, z)
  const uint8_t* active;  // (n,) bool
  const float* carrier;   // (n, 2) or null
  const float* world_view;  // (4, 4) row convention
  const float* full_proj;   // (4, 4)
  const float* cam_center;  // (3,)
  const float* tanfovx;     // ()
  const float* tanfovy;     // ()
  long long n;
  int k_rest;
  int width, height;
  float dilation, znear_cull;
};

// NaN-propagating clamps and minimum, as torch.clamp and torch.minimum
__device__ __forceinline__ float clamp_lo(float v, float lo) { return v < lo ? lo : v; }
__device__ __forceinline__ float clamp_hi(float v, float hi) { return v > hi ? hi : v; }
__device__ __forceinline__ float nan_min(float a, float b) { return (a != a || a < b) ? a : b; }

// The camera of the block in shared memory: V(i, j) = world_view[i][j],
// P(i, j) = full_proj[i][j], then the centre and the two tan-fovs.
__device__ __forceinline__ void stage_camera(const ProjectArgs& a, float* cam) {
  const int t = threadIdx.x;
  if (t < 16) cam[t] = a.world_view[t];
  else if (t < 32) cam[t] = a.full_proj[t - 16];
  else if (t < 35) cam[t] = a.cam_center[t - 32];
  else if (t == 35) cam[35] = *a.tanfovx;
  else if (t == 36) cam[36] = *a.tanfovy;
  __syncthreads();
}

// Column j of [x, y, z, 1] @ M for the row-major 4x4 M whose column j
// starts at m (stride 4), rounded as cuBLAS rounds the plain version's
// product on the card: fused multiply-adds in the order x, y, z, then the
// +1 row (measured bit-equal on 1,048,576 random rows; PERF.md §6).
__device__ __forceinline__ float camera_product(float x, float y, float z, const float* m) {
  return __fmaf_rn(z, m[8], __fmaf_rn(y, m[4], x * m[0])) + m[12];
}

// Every intermediate of project_gaussians that a row's outputs or its
// gradient need, in project_gaussians' order of operations.
struct Geometry {
  float pv[3];   // view-space point; pv[2] is the depth
  float ph0, ph1, ph3;  // clip-space point (its z is not used)
  bool in_front;
  float pw;      // 1 / (w_hom + 1e-7)
  float q[4], qn;  // normalised quaternion (r, x, y, z) and the norm
  float R[9];    // rotation, row-major
  float s[3], a[3];  // exp(scaling) and its squares
  float S[6];    // cov3d xx xy xz yy yz zz
  float tx, ty, tz, ux, uy, cux, cuy, inv_z, inv_z2;
  float fx, fy, limx, limy;
  float T[6];    // EWA's T = J W: rows 0 (T[0..2]) and 1 (T[3..5])
  float U[6];    // T Sigma
  float xx, xy, yy, det, inv_det;
  bool det_ok;
};

__device__ __forceinline__ Geometry geometry(const float* cam, const float* p, const float* sraw,
                                             const float* rot, float W, float H, float dilation,
                                             float znear) {
  Geometry g;
  const float x = p[0], y = p[1], z = p[2];
#define V(i, j) cam[(i) * 4 + (j)]
#define P(i, j) cam[16 + (i) * 4 + (j)]
#pragma unroll
  for (int j = 0; j < 3; ++j) g.pv[j] = camera_product(x, y, z, &V(0, j));
  g.ph0 = camera_product(x, y, z, &P(0, 0));
  g.ph1 = camera_product(x, y, z, &P(0, 1));
  g.ph3 = camera_product(x, y, z, &P(0, 3));
  g.in_front = g.pv[2] > znear;
  g.pw = 1.0f / ((g.in_front ? g.ph3 : 1.0f) + 1e-7f);

  // cov3d (compute_cov3d)
  const float r0 = rot[0], r1 = rot[1], r2 = rot[2], r3 = rot[3];
  g.qn = sqrtf((r0 * r0 + r2 * r2) + (r1 * r1 + r3 * r3));  // linalg.norm's order
  g.q[0] = r0 / g.qn;
  g.q[1] = r1 / g.qn;
  g.q[2] = r2 / g.qn;
  g.q[3] = r3 / g.qn;
  const float qr = g.q[0], qx = g.q[1], qy = g.q[2], qz = g.q[3];
  g.R[0] = 1.0f - 2.0f * (qy * qy + qz * qz);
  g.R[1] = 2.0f * (qx * qy - qr * qz);
  g.R[2] = 2.0f * (qx * qz + qr * qy);
  g.R[3] = 2.0f * (qx * qy + qr * qz);
  g.R[4] = 1.0f - 2.0f * (qx * qx + qz * qz);
  g.R[5] = 2.0f * (qy * qz - qr * qx);
  g.R[6] = 2.0f * (qx * qz - qr * qy);
  g.R[7] = 2.0f * (qy * qz + qr * qx);
  g.R[8] = 1.0f - 2.0f * (qx * qx + qy * qy);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    g.s[j] = expf(sraw[j]);
    g.a[j] = g.s[j] * g.s[j];
  }
  const float* R = g.R;
#define SIG(i, k) \
  (((R[(i) * 3] * R[(k) * 3]) * g.a[0] + (R[(i) * 3 + 1] * R[(k) * 3 + 1]) * g.a[1]) + \
   (R[(i) * 3 + 2] * R[(k) * 3 + 2]) * g.a[2])
  g.S[0] = SIG(0, 0);
  g.S[1] = SIG(0, 1);
  g.S[2] = SIG(0, 2);
  g.S[3] = SIG(1, 1);
  g.S[4] = SIG(1, 2);
  g.S[5] = SIG(2, 2);
#undef SIG

  // EWA (ewa_cov2d); Wm(a, j) = world_view[j][a]
  g.tx = g.in_front ? g.pv[0] : 0.0f;
  g.ty = g.in_front ? g.pv[1] : 0.0f;
  g.tz = g.in_front ? g.pv[2] : 1.0f;
  const float tanx = cam[35], tany = cam[36];
  g.fx = (1.0f / (2.0f * tanx)) * W;  // width / (2 tan): a reciprocal, then the product
  g.fy = (1.0f / (2.0f * tany)) * H;
  g.limx = 1.3f * tanx;
  g.limy = 1.3f * tany;
  g.ux = g.tx / g.tz;
  g.uy = g.ty / g.tz;
  g.cux = clamp_hi(clamp_lo(g.ux, -g.limx), g.limx);
  g.cuy = clamp_hi(clamp_lo(g.uy, -g.limy), g.limy);
  const float txtz = g.cux * g.tz, tytz = g.cuy * g.tz;
  g.inv_z = 1.0f / g.tz;
  g.inv_z2 = g.inv_z * g.inv_z;
  const float j00 = g.fx * g.inv_z;
  const float j02 = (-g.fx * txtz) * g.inv_z2;
  const float j11 = g.fy * g.inv_z;
  const float j12 = (-g.fy * tytz) * g.inv_z2;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    g.T[j] = j00 * V(j, 0) + j02 * V(j, 2);
    g.T[3 + j] = j11 * V(j, 1) + j12 * V(j, 2);
  }
  const float* S = g.S;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float* T = g.T + 3 * r;
    g.U[3 * r + 0] = (T[0] * S[0] + T[1] * S[1]) + T[2] * S[2];
    g.U[3 * r + 1] = (T[0] * S[1] + T[1] * S[3]) + T[2] * S[4];
    g.U[3 * r + 2] = (T[0] * S[2] + T[1] * S[4]) + T[2] * S[5];
  }
  g.xx = ((g.U[0] * g.T[0] + g.U[1] * g.T[1]) + g.U[2] * g.T[2]) + dilation;
  g.xy = (g.U[3] * g.T[0] + g.U[4] * g.T[1]) + g.U[5] * g.T[2];
  g.yy = ((g.U[3] * g.T[3] + g.U[4] * g.T[4]) + g.U[5] * g.T[5]) + dilation;
  g.det = g.xx * g.yy - g.xy * g.xy;
  g.det_ok = g.det > 0.0f;
  g.inv_det = 1.0f / (g.det_ok ? g.det : 1.0f);
#undef V
#undef P
  return g;
}

// SH basis at the unit direction (x, y, z), each term in eval_sh's order of
// operations (a subtracted term as the sum of its negation, which rounds
// alike).
template <int D>
__device__ __forceinline__ void sh_basis(float x, float y, float z, float* b) {
  b[0] = kC0;
  if (D > 0) {
    b[1] = -(kC1 * y);
    b[2] = kC1 * z;
    b[3] = -(kC1 * x);
  }
  if (D > 1) {
    const float xx = x * x, yy = y * y, zz = z * z, xy = x * y, yz = y * z, xz = x * z;
    b[4] = kC2_0 * xy;
    b[5] = kC2_1 * yz;
    b[6] = kC2_2 * ((2.0f * zz - xx) - yy);
    b[7] = kC2_3 * xz;
    b[8] = kC2_4 * (xx - yy);
    if (D > 2) {
      b[9] = (kC3_0 * y) * (3.0f * xx - yy);
      b[10] = (kC3_1 * xy) * z;
      b[11] = (kC3_2 * y) * ((4.0f * zz - xx) - yy);
      b[12] = (kC3_3 * z) * ((2.0f * zz - 3.0f * xx) - 3.0f * yy);
      b[13] = (kC3_4 * x) * ((4.0f * zz - xx) - yy);
      b[14] = (kC3_5 * z) * (xx - yy);
      b[15] = (kC3_6 * x) * (xx - 3.0f * yy);
    }
  }
}

// d(sum_k G[k] b_k) / d(x, y, z): the derivative of each basis term, in
// project_backward_torch's order.
template <int D>
__device__ __forceinline__ void sh_dir_grad(float x, float y, float z, const float* G,
                                            float* gd) {
  float gx = 0.0f, gy = 0.0f, gz = 0.0f;
  if (D > 0) {
    gy = gy + G[1] * -kC1;
    gz = gz + G[2] * kC1;
    gx = gx + G[3] * -kC1;
  }
  if (D > 1) {
    const float xx = x * x, yy = y * y, zz = z * z, xy = x * y, yz = y * z, xz = x * z;
    gx = gx + G[4] * (kC2_0 * y);
    gy = gy + G[4] * (kC2_0 * x);
    gy = gy + G[5] * (kC2_1 * z);
    gz = gz + G[5] * (kC2_1 * y);
    constexpr float m2 = -2.0f * kC2_2, p4 = 4.0f * kC2_2;
    gx = gx + G[6] * (m2 * x);
    gy = gy + G[6] * (m2 * y);
    gz = gz + G[6] * (p4 * z);
    gx = gx + G[7] * (kC2_3 * z);
    gz = gz + G[7] * (kC2_3 * x);
    constexpr float e2 = 2.0f * kC2_4, em2 = -2.0f * kC2_4;
    gx = gx + G[8] * (e2 * x);
    gy = gy + G[8] * (em2 * y);
    if (D > 2) {
      gx = gx + G[9] * ((6.0f * kC3_0) * xy);
      gy = gy + G[9] * (kC3_0 * (3.0f * xx - 3.0f * yy));
      gx = gx + G[10] * (kC3_1 * yz);
      gy = gy + G[10] * (kC3_1 * xz);
      gz = gz + G[10] * (kC3_1 * xy);
      gx = gx + G[11] * ((-2.0f * kC3_2) * xy);
      gy = gy + G[11] * (kC3_2 * ((4.0f * zz - xx) - 3.0f * yy));
      gz = gz + G[11] * ((8.0f * kC3_2) * yz);
      gx = gx + G[12] * ((-6.0f * kC3_3) * xz);
      gy = gy + G[12] * ((-6.0f * kC3_3) * yz);
      gz = gz + G[12] * (kC3_3 * ((6.0f * zz - 3.0f * xx) - 3.0f * yy));
      gx = gx + G[13] * (kC3_4 * ((4.0f * zz - 3.0f * xx) - yy));
      gy = gy + G[13] * ((-2.0f * kC3_4) * xy);
      gz = gz + G[13] * ((8.0f * kC3_4) * xz);
      gx = gx + G[14] * ((2.0f * kC3_5) * xz);
      gy = gy + G[14] * ((-2.0f * kC3_5) * yz);
      gz = gz + G[14] * (kC3_5 * (xx - yy));
      gx = gx + G[15] * (kC3_6 * (3.0f * xx - 3.0f * yy));
      gy = gy + G[15] * ((-6.0f * kC3_6) * xy);
    }
  }
  gd[0] = gx;
  gd[1] = gy;
  gd[2] = gz;
}

// The view direction: d = xyz - centre, norm, its clamp at 1e-8, d / clamp.
struct Direction {
  float d[3], norm, cn, u[3];
};

__device__ __forceinline__ Direction direction(const float* cam, const float* p) {
  Direction v;
#pragma unroll
  for (int j = 0; j < 3; ++j) v.d[j] = p[j] - cam[32 + j];
  v.norm = sqrtf((v.d[0] * v.d[0] + v.d[2] * v.d[2]) + v.d[1] * v.d[1]);  // torch.sum's order
  v.cn = clamp_lo(v.norm, 1e-8f);
#pragma unroll
  for (int j = 0; j < 3; ++j) v.u[j] = v.d[j] / v.cn;
  return v;
}

template <int D>
__global__ void __launch_bounds__(kProjThreads)
    project_forward_kernel(ProjectArgs a, float* __restrict__ mean2d, float* __restrict__ depth,
                           float* __restrict__ conic, float* __restrict__ color,
                           float* __restrict__ opacity_out, float* __restrict__ radius_out,
                           uint8_t* __restrict__ visible_out, float* __restrict__ bin_extent) {
  constexpr int NB = (D + 1) * (D + 1);
  __shared__ float cam[kCamFloats];
  stage_camera(a, cam);
  const long long i = static_cast<long long>(blockIdx.x) * kProjThreads + threadIdx.x;
  if (i >= a.n) return;

  // every load of the row first
  float p[3], sraw[3], rot[4], f[NB][3], c[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    p[j] = __ldg(a.xyz + 3 * i + j);
    sraw[j] = __ldg(a.scaling + 3 * i + j);
    f[0][j] = __ldg(a.f_dc + 3 * i + j);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) rot[j] = __ldg(a.rotation + 4 * i + j);
  const float* fr = a.f_rest + 3 * static_cast<long long>(a.k_rest) * i;
#pragma unroll
  for (int k = 1; k < NB; ++k)
#pragma unroll
    for (int j = 0; j < 3; ++j) f[k][j] = __ldg(fr + 3 * (k - 1) + j);
  const float oraw = __ldg(a.opacity + i);
  const bool active = __ldg(a.active + i) != 0;
  if (a.carrier != nullptr) {
    c[0] = __ldg(a.carrier + 2 * i);
    c[1] = __ldg(a.carrier + 2 * i + 1);
  }

  const float W = static_cast<float>(a.width), H = static_cast<float>(a.height);
  const Geometry g = geometry(cam, p, sraw, rot, W, H, a.dilation, a.znear_cull);
  float px = ((g.ph0 * g.pw + 1.0f) * W - 1.0f) * 0.5f;
  float py = ((g.ph1 * g.pw + 1.0f) * H - 1.0f) * 0.5f;
  if (a.carrier != nullptr) {
    px = px + c[0] * (0.5f * W);
    py = py + c[1] * (0.5f * H);
  }
  const float mid = 0.5f * (g.xx + g.yy);
  const float disc = sqrtf(clamp_lo(mid * mid - g.det, 0.1f));
  const float lambda1 = mid + disc;
  const bool visible = active && g.in_front && g.det_ok;
  const float radius = visible ? ceilf(3.0f * sqrtf(clamp_lo(lambda1, 0.0f))) : 0.0f;

  const float o = 1.0f / (1.0f + expf(-oraw));
  const float d_max = sqrtf(clamp_lo(2.0f * logf(255.0f * o), 0.0f));
  const bool binned = visible && d_max > 0.0f;
  const float ext0 = nan_min(d_max * sqrtf(clamp_lo(g.xx, 0.0f)) + 1.0f, radius);
  const float ext1 = nan_min(d_max * sqrtf(clamp_lo(g.yy, 0.0f)) + 1.0f, radius);

  const Direction v = direction(cam, p);
  float b[NB];
  sh_basis<D>(v.u[0], v.u[1], v.u[2], b);

  mean2d[2 * i] = visible ? px : 0.0f;
  mean2d[2 * i + 1] = visible ? py : 0.0f;
  depth[i] = visible ? g.pv[2] : 0.0f;
  conic[3 * i] = visible ? g.yy * g.inv_det : 1.0f;
  conic[3 * i + 1] = visible ? -g.xy * g.inv_det : 0.0f;
  conic[3 * i + 2] = visible ? g.xx * g.inv_det : 1.0f;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float acc = b[0] * f[0][ch];
#pragma unroll
    for (int k = 1; k < NB; ++k) acc = acc + b[k] * f[k][ch];
    color[3 * i + ch] = clamp_lo(acc + 0.5f, 0.0f);
  }
  opacity_out[i] = visible ? o : 0.0f;
  radius_out[i] = radius;
  visible_out[i] = visible ? 1 : 0;
  bin_extent[2 * i] = binned ? ext0 : 0.0f;
  bin_extent[2 * i + 1] = binned ? ext1 : 0.0f;
}

struct ProjectGrads {
  const float* mean2d;   // (n, 2) or null (zeros)
  const float* depth;    // (n,) or null
  const float* conic;    // (n, 3) or null
  const float* color;    // (n, 3) or null
  const float* opacity;  // (n,) or null
};

struct LeafGrads {
  float* xyz;       // (n, 3)
  float* f_dc;      // (n, 1, 3)
  float* f_rest;    // (n, k_rest, 3)
  float* opacity;   // (n, 1)
  float* scaling;   // (n, 3)
  float* rotation;  // (n, 4)
  float* carrier;   // (n, 2) or null
};

__device__ __forceinline__ float load_or_zero(const float* p, long long k) {
  return p == nullptr ? 0.0f : __ldg(p + k);
}

template <int D>
__global__ void __launch_bounds__(kProjThreads)
    project_backward_kernel(ProjectArgs a, ProjectGrads go, LeafGrads out) {
  constexpr int NB = (D + 1) * (D + 1);
  __shared__ float cam[kCamFloats];
  stage_camera(a, cam);
  const long long i = static_cast<long long>(blockIdx.x) * kProjThreads + threadIdx.x;
  if (i >= a.n) return;

  float p[3], sraw[3], rot[4], f[NB][3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    p[j] = __ldg(a.xyz + 3 * i + j);
    sraw[j] = __ldg(a.scaling + 3 * i + j);
    f[0][j] = __ldg(a.f_dc + 3 * i + j);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) rot[j] = __ldg(a.rotation + 4 * i + j);
  const float* fr = a.f_rest + 3 * static_cast<long long>(a.k_rest) * i;
#pragma unroll
  for (int k = 1; k < NB; ++k)
#pragma unroll
    for (int j = 0; j < 3; ++j) f[k][j] = __ldg(fr + 3 * (k - 1) + j);
  const float oraw = __ldg(a.opacity + i);
  const bool active = __ldg(a.active + i) != 0;
  float gm[2], gc[3], gcol[3];
  gm[0] = load_or_zero(go.mean2d, 2 * i);
  gm[1] = load_or_zero(go.mean2d, 2 * i + 1);
  const float gdep_in = load_or_zero(go.depth, i);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    gc[j] = load_or_zero(go.conic, 3 * i + j);
    gcol[j] = load_or_zero(go.color, 3 * i + j);
  }
  const float gop_in = load_or_zero(go.opacity, i);

  const float W = static_cast<float>(a.width), H = static_cast<float>(a.height);
  const Geometry g = geometry(cam, p, sraw, rot, W, H, a.dilation, a.znear_cull);
  const bool visible = active && g.in_front && g.det_ok;
  // the sanitising where()s: only visible rows pass these cotangents
  const float gmx = visible ? gm[0] : 0.0f, gmy = visible ? gm[1] : 0.0f;
  const float gdep = visible ? gdep_in : 0.0f;
  const float gc0 = visible ? gc[0] : 0.0f, gc1 = visible ? gc[1] : 0.0f,
              gc2 = visible ? gc[2] : 0.0f;
  const float gop = visible ? gop_in : 0.0f;

  // opacity: sigmoid's backward, grad * (1 - y) * y
  const float o = 1.0f / (1.0f + expf(-oraw));
  out.opacity[i] = (gop * (1.0f - o)) * o;
  if (out.carrier != nullptr) {
    out.carrier[2 * i] = gmx * (0.5f * W);
    out.carrier[2 * i + 1] = gmy * (0.5f * H);
  }

  // colour: clamp(sh + 0.5, min=0) passes where its input >= 0
  const Direction v = direction(cam, p);
  float b[NB];
  sh_basis<D>(v.u[0], v.u[1], v.u[2], b);
  float gs[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float acc = b[0] * f[0][ch];
#pragma unroll
    for (int k = 1; k < NB; ++k) acc = acc + b[k] * f[k][ch];
    gs[ch] = (acc + 0.5f >= 0.0f) ? gcol[ch] : 0.0f;
  }
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) out.f_dc[3 * i + ch] = gs[ch] * b[0];
  float* gfr = out.f_rest + 3 * static_cast<long long>(a.k_rest) * i;
#pragma unroll
  for (int k = 1; k < NB; ++k)
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) gfr[3 * (k - 1) + ch] = gs[ch] * b[k];
  for (int k = NB - 1; k < a.k_rest; ++k)
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) gfr[3 * k + ch] = 0.0f;
  float G[NB];
#pragma unroll
  for (int k = 0; k < NB; ++k) G[k] = (gs[0] * f[k][0] + gs[1] * f[k][1]) + gs[2] * f[k][2];
  float gu[3];
  sh_dir_grad<D>(v.u[0], v.u[1], v.u[2], G, gu);
  // u = d / clamp(norm, 1e-8), norm = sqrt(sum d^2)
  float gx[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) gx[j] = gu[j] / v.cn;
  const float gcn = -(((gu[0] * v.d[0] + gu[1] * v.d[1]) + gu[2] * v.d[2]) / (v.cn * v.cn));
  const float gnorm = v.norm >= 1e-8f ? gcn : 0.0f;
  const float gss = gnorm / (2.0f * v.norm);
#pragma unroll
  for (int j = 0; j < 3; ++j) gx[j] = gx[j] + (2.0f * v.d[j]) * gss;

  // conic = (yy, -xy, xx) / det over det_ok
  float gxx = gc2 * g.inv_det, gyy = gc0 * g.inv_det, gxy = -(gc1 * g.inv_det);
  const float ginv = (gc0 * g.yy + gc1 * -g.xy) + gc2 * g.xx;
  const float gdet = g.det_ok ? -(ginv * (g.inv_det * g.inv_det)) : 0.0f;
  gxx = gxx + gdet * g.yy;
  gyy = gyy + gdet * g.xx;
  gxy = gxy - 2.0f * (gdet * g.xy);

  // cov2d = T Sigma T^T (+ dilation)
  float gU[6], gT[6], gS[6];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    gU[j] = gxx * g.T[j];
    gU[3 + j] = gxy * g.T[j] + gyy * g.T[3 + j];
  }
  const float* S = g.S;
  // Sigma row j as packed indices
  const int kSym[3][3] = {{0, 1, 2}, {1, 3, 4}, {2, 4, 5}};
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    gT[j] = (gxx * g.U[j] + gxy * g.U[3 + j]) +
            ((gU[0] * S[kSym[j][0]] + gU[1] * S[kSym[j][1]]) + gU[2] * S[kSym[j][2]]);
    gT[3 + j] = gyy * g.U[3 + j] +
                ((gU[3] * S[kSym[j][0]] + gU[4] * S[kSym[j][1]]) + gU[5] * S[kSym[j][2]]);
  }
  const float* T = g.T;
  gS[0] = gU[0] * T[0] + gU[3] * T[3];
  gS[1] = (gU[0] * T[1] + gU[1] * T[0]) + (gU[3] * T[4] + gU[4] * T[3]);
  gS[2] = (gU[0] * T[2] + gU[2] * T[0]) + (gU[3] * T[5] + gU[5] * T[3]);
  gS[3] = gU[1] * T[1] + gU[4] * T[4];
  gS[4] = (gU[1] * T[2] + gU[2] * T[1]) + (gU[4] * T[5] + gU[5] * T[4]);
  gS[5] = gU[2] * T[2] + gU[5] * T[5];

  // T = J W: J's entries, then the linearisation point
#define V(i_, j_) cam[(i_) * 4 + (j_)]
  const float gj00 = (gT[0] * V(0, 0) + gT[1] * V(1, 0)) + gT[2] * V(2, 0);
  const float gj02 = (gT[0] * V(0, 2) + gT[1] * V(1, 2)) + gT[2] * V(2, 2);
  const float gj11 = (gT[3] * V(0, 1) + gT[4] * V(1, 1)) + gT[5] * V(2, 1);
  const float gj12 = (gT[3] * V(0, 2) + gT[4] * V(1, 2)) + gT[5] * V(2, 2);
  const float txtz = g.cux * g.tz, tytz = g.cuy * g.tz;
  const float gtxtz = (gj02 * g.inv_z2) * -g.fx;
  const float gtytz = (gj12 * g.inv_z2) * -g.fy;
  const float ginvz2 = gj02 * (-g.fx * txtz) + gj12 * (-g.fy * tytz);
  const float ginvz = (gj00 * g.fx + gj11 * g.fy) + 2.0f * (ginvz2 * g.inv_z);
  float gtz = -(ginvz * (g.inv_z * g.inv_z));
  gtz = gtz + gtxtz * g.cux + gtytz * g.cuy;
  const float gux = (g.ux >= -g.limx && g.ux <= g.limx) ? gtxtz * g.tz : 0.0f;
  const float guy = (g.uy >= -g.limy && g.uy <= g.limy) ? gtytz * g.tz : 0.0f;
  const float gtx = gux / g.tz, gty = guy / g.tz;
  gtz = gtz - (gux * (g.ux / g.tz) + guy * (g.uy / g.tz));

  // the mean: pixels from NDC, the guarded divide, the two camera products
  const float gndc0 = (gmx * 0.5f) * W, gndc1 = (gmy * 0.5f) * H;
  const float gph0 = gndc0 * g.pw, gph1 = gndc1 * g.pw;
  const float gpw = gndc0 * g.ph0 + gndc1 * g.ph1;
  const float gph3 = g.in_front ? -(gpw * (g.pw * g.pw)) : 0.0f;
  const float gpv0 = g.in_front ? gtx : 0.0f, gpv1 = g.in_front ? gty : 0.0f;
  const float gpv2 = gdep + (g.in_front ? gtz : 0.0f);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float* Pj = cam + 16 + 4 * j;
    gx[j] = gx[j] + ((gph0 * Pj[0] + gph1 * Pj[1]) + gph3 * Pj[3]);
    gx[j] = gx[j] + ((gpv0 * V(j, 0) + gpv1 * V(j, 1)) + gpv2 * V(j, 2));
    out.xyz[3 * i + j] = gx[j];
  }
#undef V

  // cov3d: Sigma_ik = sum_j R_ij R_kj a_j
  const float* R = g.R;
  float gR[9];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float r0 = R[j], r1 = R[3 + j], r2 = R[6 + j];
    gR[j] = g.a[j] * ((2.0f * gS[0] * r0 + gS[1] * r1) + gS[2] * r2);
    gR[3 + j] = g.a[j] * ((gS[1] * r0 + 2.0f * gS[3] * r1) + gS[4] * r2);
    gR[6 + j] = g.a[j] * ((gS[2] * r0 + gS[4] * r1) + 2.0f * gS[5] * r2);
    const float ga = (r0 * ((gS[0] * r0 + gS[1] * r1) + gS[2] * r2) +
                      r1 * (gS[3] * r1 + gS[4] * r2)) + r2 * (gS[5] * r2);
    // a = s * s, s = exp(raw): d raw = 2 s ga * s
    out.scaling[3 * i + j] = ((2.0f * g.s[j]) * ga) * g.s[j];
  }
  const float qr = g.q[0], qx = g.q[1], qy = g.q[2], qz = g.q[3];
  float gq[4];
  gq[0] = 2.0f * (((((-qz * gR[1] + qy * gR[2]) + qz * gR[3]) - qx * gR[5]) - qy * gR[6]) +
                  qx * gR[7]);
  gq[1] = 2.0f * (((((((qy * gR[1] + qz * gR[2]) + qy * gR[3]) - 2.0f * qx * gR[4]) -
                     qr * gR[5]) + qz * gR[6]) + qr * gR[7]) - 2.0f * qx * gR[8]);
  gq[2] = 2.0f * (((((((-2.0f * qy * gR[0] + qx * gR[1]) + qr * gR[2]) + qx * gR[3]) +
                     qz * gR[5]) - qr * gR[6]) + qz * gR[7]) - 2.0f * qy * gR[8]);
  gq[3] = 2.0f * (((((((-2.0f * qz * gR[0] - qr * gR[1]) + qx * gR[2]) + qr * gR[3]) -
                     2.0f * qz * gR[4]) + qy * gR[5]) + qx * gR[6]) + qy * gR[7]);
  // q = rot / |rot|
  const float dot = ((gq[0] * qr + gq[1] * qx) + gq[2] * qy) + gq[3] * qz;
#pragma unroll
  for (int j = 0; j < 4; ++j) out.rotation[4 * i + j] = (gq[j] - dot * g.q[j]) / g.qn;
}

template <template <int> class Launch, typename... Args>
cudaError_t by_degree(int degree, Args... args) {
  switch (degree) {
    case 0: return Launch<0>::run(args...);
    case 1: return Launch<1>::run(args...);
    case 2: return Launch<2>::run(args...);
    case 3: return Launch<3>::run(args...);
    default: return cudaErrorInvalidValue;
  }
}

template <int D>
struct LaunchForward {
  static cudaError_t run(const ProjectArgs& a, cudaStream_t stream, float* mean2d, float* depth,
                         float* conic, float* color, float* opacity, float* radius,
                         uint8_t* visible, float* bin_extent) {
    const unsigned blocks = static_cast<unsigned>((a.n + kProjThreads - 1) / kProjThreads);
    project_forward_kernel<D><<<blocks, kProjThreads, 0, stream>>>(
        a, mean2d, depth, conic, color, opacity, radius, visible, bin_extent);
    return cudaSuccess;
  }
};

template <int D>
struct LaunchBackward {
  static cudaError_t run(const ProjectArgs& a, cudaStream_t stream, const ProjectGrads& go,
                         const LeafGrads& out) {
    const unsigned blocks = static_cast<unsigned>((a.n + kProjThreads - 1) / kProjThreads);
    project_backward_kernel<D><<<blocks, kProjThreads, 0, stream>>>(a, go, out);
    return cudaSuccess;
  }
};

}  // namespace b3dgs

namespace {

b3dgs::ProjectArgs project_args(const float* xyz, const float* f_dc, const float* f_rest,
                                const float* opacity, const float* scaling,
                                const float* rotation, const uint8_t* active,
                                const float* carrier, const float* world_view,
                                const float* full_proj, const float* cam_center,
                                const float* tanfovx, const float* tanfovy, long long n,
                                int k_rest, int width, int height, float dilation,
                                float znear_cull) {
  return b3dgs::ProjectArgs{xyz, f_dc, f_rest, opacity, scaling, rotation, active, carrier,
                            world_view, full_proj, cam_center, tanfovx, tanfovy, n, k_rest,
                            width, height, dilation, znear_cull};
}

}  // namespace

// Row-major float32 inputs of n rows (active: one byte a row; carrier may
// be null); the camera as five device tensors of 16, 16, 3, 1 and 1
// floats; sh_degree 0-3 with (sh_degree + 1)^2 - 1 <= k_rest. Outputs of n
// rows, each written whole (visible: one byte a row, 0 or 1).
extern "C" int b3dgs_project_forward(
    const float* xyz, const float* f_dc, const float* f_rest, const float* opacity,
    const float* scaling, const float* rotation, const uint8_t* active, const float* carrier,
    const float* world_view, const float* full_proj, const float* cam_center,
    const float* tanfovx, const float* tanfovy, long long n, int k_rest, int sh_degree,
    int width, int height, float dilation, float znear_cull, float* mean2d, float* depth,
    float* conic, float* color, float* opacity_out, float* radius, uint8_t* visible,
    float* bin_extent, void* stream) {
  if (n > 0) {
    const b3dgs::ProjectArgs a =
        project_args(xyz, f_dc, f_rest, opacity, scaling, rotation, active, carrier, world_view,
                     full_proj, cam_center, tanfovx, tanfovy, n, k_rest, width, height,
                     dilation, znear_cull);
    const cudaError_t err = b3dgs::by_degree<b3dgs::LaunchForward>(
        sh_degree, a, static_cast<cudaStream_t>(stream), mean2d, depth, conic, color,
        opacity_out, radius, visible, bin_extent);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// The forward's inputs, then the cotangents of mean2d (n, 2), depth (n,),
// conic (n, 3), color (n, 3) and opacity (n,), each null for zeros; writes
// the gradients of xyz, f_dc, f_rest, opacity, scaling and rotation whole,
// and of the carrier (n, 2) where d_carrier is not null.
extern "C" int b3dgs_project_backward(
    const float* xyz, const float* f_dc, const float* f_rest, const float* opacity,
    const float* scaling, const float* rotation, const uint8_t* active,
    const float* world_view, const float* full_proj, const float* cam_center,
    const float* tanfovx, const float* tanfovy, long long n, int k_rest, int sh_degree,
    int width, int height, float dilation, float znear_cull, const float* g_mean2d,
    const float* g_depth, const float* g_conic, const float* g_color, const float* g_opacity,
    float* d_xyz, float* d_f_dc, float* d_f_rest, float* d_opacity, float* d_scaling,
    float* d_rotation, float* d_carrier, void* stream) {
  if (n > 0) {
    const b3dgs::ProjectArgs a =
        project_args(xyz, f_dc, f_rest, opacity, scaling, rotation, active, nullptr,
                     world_view, full_proj, cam_center, tanfovx, tanfovy, n, k_rest, width,
                     height, dilation, znear_cull);
    const b3dgs::ProjectGrads go{g_mean2d, g_depth, g_conic, g_color, g_opacity};
    const b3dgs::LeafGrads out{d_xyz, d_f_dc, d_f_rest, d_opacity, d_scaling, d_rotation,
                               d_carrier};
    const cudaError_t err = b3dgs::by_degree<b3dgs::LaunchBackward>(
        sh_degree, a, static_cast<cudaStream_t>(stream), go, out);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
