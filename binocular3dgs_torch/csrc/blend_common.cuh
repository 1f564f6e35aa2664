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

}  // namespace b3dgs
