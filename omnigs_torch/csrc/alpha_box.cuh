// The ellipse-box alpha test of the tile binning, shared by the superblock
// pre-cull (csrc/precull.cu) and the expansion (csrc/expand_keys.cu): the
// device form of omnigs_torch/ops/binning.py's _min_quad_over_box and
// _alpha_reaches_min, bit for bit their PyTorch elementwise passes.
//
// Every float operation is the one PyTorch's elementwise kernel runs, in the
// plain version's order: q = ((A u) u + ((2 B) u) v) + (C v) v,
// ((-B) u0) / clamp_min(C, 1e-12), IEEE division, expf without fast math, the
// Python scalars as float32 (1e-12, 1/255, -0.5, 2), and NaN carried as
// torch.clamp, clamp_min and torch.minimum carry it (the first NaN operand
// wins; fminf / fmaxf alone would drop it). The sources that include this
// header build with --fmad=false (omnigs_torch/cuda_build.py), so nothing is
// contracted.

#pragma once

namespace alpha_box {

// PyTorch casts a Python float scalar to the tensor's float32
constexpr float EPS = static_cast<float>(1e-12);
constexpr float ALPHA_FLOOR = static_cast<float>(1.0 / 255.0);

// torch.clamp(v, lo, hi) with tensor bounds: the first NaN of (v, lo, hi)
__device__ __forceinline__ float clamp_t(float v, float lo, float hi) {
  if (v != v) return v;
  if (lo != lo) return lo;
  if (hi != hi) return hi;
  return fminf(fmaxf(v, lo), hi);
}

// torch.clamp_min(v, s) with a scalar s: NaN stays NaN
__device__ __forceinline__ float clamp_min_t(float v, float s) {
  return v != v ? v : fmaxf(v, s);
}

// torch.minimum(a, b): the first NaN of (a, b)
__device__ __forceinline__ float minimum_t(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fminf(a, b);
}

// q(u, v) = A u^2 + 2 B u v + C v^2 in the plain version's order
__device__ __forceinline__ float quad(float A, float B, float C, float u, float v) {
  return (A * u * u + 2.0f * B * u * v) + C * v * v;
}

// _min_quad_over_box: the least of q over the box [u0, u1] x [v0, v1], 0 if
// the box holds the origin, else the least of the four clamped edge minima
__device__ __forceinline__ float min_quad_over_box(float A, float B, float C, float u0,
                                                   float u1, float v0, float v1) {
  if (u0 <= 0.0f && u1 >= 0.0f && v0 <= 0.0f && v1 >= 0.0f) return 0.0f;
  const float negb = -B;
  const float ce = clamp_min_t(C, EPS), ae = clamp_min_t(A, EPS);
  const float vs0 = clamp_t(negb * u0 / ce, v0, v1);
  const float vs1 = clamp_t(negb * u1 / ce, v0, v1);
  const float us0 = clamp_t(negb * v0 / ae, u0, u1);
  const float us1 = clamp_t(negb * v1 / ae, u0, u1);
  return minimum_t(minimum_t(quad(A, B, C, u0, vs0), quad(A, B, C, u1, vs1)),
                   minimum_t(quad(A, B, C, us0, v0), quad(A, B, C, us1, v1)));
}

// _alpha_reaches_min: the max alpha over the box, op exp(-qmin / 2), reaches
// the 1/255 skip floor
__device__ __forceinline__ bool alpha_reaches_min(float op, float qmin) {
  return op * expf(-0.5f * qmin) >= ALPHA_FLOOR;
}

}  // namespace alpha_box
