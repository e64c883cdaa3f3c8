// Device helpers of the dense-transfer kernels (dense_pcdf.cu, dense_p2g.cu,
// dense_g2p.cu), templated on the dimension D.  Each follows its plain
// PyTorch counterpart operation by operation: ops/kernel.py
// stencil_base_and_weights, ops/transfer.py velocity_at_point,
// project_velocity and the ghost velocity.
#pragma once
#include "cpic.cuh"

// Grid geometry of the row-major node grid (unused axes: shape 1, origin 0).
struct DenseGrid {
  int s[3];
  int o[3];
  float h;
  __host__ __device__ __forceinline__ long long nodes() const {
    return (long long)s[0] * s[1] * s[2];
  }
};

// Quadratic B-spline weight of offset o (0, 1, 2) at the fractional offset x
// (ops/kernel.axis_weights).
__device__ __forceinline__ float axis_weight(float x, int o) {
  if (o == 0) {
    float a = 1.5f - x;
    return 0.5f * (a * a);
  }
  if (o == 1) {
    float b = x - 1.0f;
    return 0.75f - b * b;
  }
  float c = x - 0.5f;
  return 0.5f * (c * c);
}

// Stencil offset k (0 .. 3^D - 1, the last axis fastest) on axis a.
template <int D>
__device__ __forceinline__ int stencil_off(int k, int a) {
  if (D == 2) return a == 0 ? k / 3 : k % 3;
  return a == 0 ? k / 9 : (a == 1 ? (k / 3) % 3 : k % 3);
}

// The weight of a stencil node: the per-axis weights multiplied axis by axis.
template <int D>
__device__ __forceinline__ float stencil_weight(const float wa[3][3], int k) {
  float w = wa[0][stencil_off<D>(k, 0)];
  for (int a = 1; a < D; ++a) w = w * wa[a][stencil_off<D>(k, a)];
  return w;
}

// Base cell round(p / h) - 1 (IEEE division, halves to even) and the
// per-axis weights of a particle.
template <int D>
__device__ __forceinline__ void stencil_axes(const float p[3], float h, int base[3],
                                             float wa[3][3]) {
  for (int a = 0; a < D; ++a) {
    float u = p[a] / h;
    base[a] = (int)rintf(u) - 1;
    float x = u - (float)base[a];
    for (int o = 0; o < 3; ++o) wa[a][o] = axis_weight(x, o);
  }
}

// Velocity of body b at world point x: lin + ang x (x - com) (3D body table
// rows 0-2 COM, 3-5 linvel, 6-8 angvel; 2D rows 0-1, 2-3, 4).
template <int D>
__device__ __forceinline__ void body_velocity(const float* bt, int b, const float x[3],
                                              float bv[3]) {
  float rel[3];
  for (int a = 0; a < D; ++a) rel[a] = x[a] - bt[a * 128 + b];
  if (D == 2) {
    float om = bt[4 * 128 + b];
    bv[0] = bt[2 * 128 + b] + om * -rel[1];
    bv[1] = bt[3 * 128 + b] + om * rel[0];
    return;
  }
  float a0 = bt[6 * 128 + b], a1 = bt[7 * 128 + b], a2 = bt[8 * 128 + b];
  bv[0] = bt[3 * 128 + b] + (a1 * rel[2] - a2 * rel[1]);
  bv[1] = bt[4 * 128 + b] + (a2 * rel[0] - a0 * rel[2]);
  bv[2] = bt[5 * 128 + b] + (a0 * rel[1] - a1 * rel[0]);
}

// CPIC ghost velocity bv + project_velocity(v - bv, nrm) (grid.wgsl:390-403).
template <int D>
__device__ __forceinline__ void dense_ghost(const float v[3], const float bv[3],
                                            const float nrm[3], float g[3]) {
  float u[3];
  for (int i = 0; i < D; ++i) u[i] = v[i] - bv[i];
  float nv = u[0] * nrm[0];
  for (int i = 1; i < D; ++i) nv = nv + u[i] * nrm[i];
  float t[3];
  for (int i = 0; i < D; ++i) t[i] = u[i] - nrm[i] * nv;
  float tl = t[0] * t[0];
  for (int i = 1; i < D; ++i) tl = tl + t[i] * t[i];
  tl = sqrtf(tl);
  float s = fmaxf(tl + FRICTION * nv, 0.0f);
  bool big = tl > 1e-8f;
  float tmax = fmaxf(tl, 1e-30f);
  for (int i = 0; i < D; ++i)
    g[i] = bv[i] + (nv < 0.0f ? (big ? t[i] / tmax : 0.0f) * s : u[i]);
}
