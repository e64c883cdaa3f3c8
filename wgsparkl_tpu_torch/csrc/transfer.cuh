// Device helpers shared by the 3D transfer kernels (p2g_cdf.cu, p2g.cu,
// g2p.cu).
// Each follows its plain PyTorch counterpart in wgsparkl_tpu_torch/ops/rows.py
// and collision/cdf_channel.py operation by operation.
#pragma once
#include "cpic.cuh"

#define WV_MAX 360          // window nodes of a 4 x 8 x 4 block (6 x 10 x 6)

// Rows of the particle matrix and of the body table.
#define PX 0
#define VX 3
#define PM 6
#define A0 7
#define AFF 16
#define NX 17
#define AFF_SPARE 20

// v rotated by quaternion (w, x, y, z) -- cdf_channel._quat_rotate_ch.
__device__ __forceinline__ void quat_rot(float w, float x, float y, float z,
                                         const float v[3], float o[3]) {
  float t0 = 2.0f * (y * v[2] - z * v[1]);
  float t1 = 2.0f * (z * v[0] - x * v[2]);
  float t2 = 2.0f * (x * v[1] - y * v[0]);
  o[0] = v[0] + w * t0 + (y * t2 - z * t1);
  o[1] = v[1] + w * t1 + (z * t0 - x * t2);
  o[2] = v[2] + w * t2 + (x * t1 - y * t0);
}

// Cuboid collider `slot` of the body table at world point p:
// within (affinity reach), inside, world distance to the boundary.
__device__ void cuboid_cdf(const float* bt, int slot, const float p[3],
                           float cap, bool* within, bool* inside, float* dist) {
  float qw = bt[9 * 128 + slot], qx = bt[10 * 128 + slot];
  float qy = bt[11 * 128 + slot], qz = bt[12 * 128 + slot];
  float rel[3], q[3], he[3];
  for (int a = 0; a < 3; ++a) {
    rel[a] = p[a] - bt[(13 + a) * 128 + slot];
    he[a] = bt[(16 + a) * 128 + slot];
  }
  quat_rot(qw, -qx, -qy, -qz, rel, q);
  bool ins = fabsf(q[0]) < he[0] && fabsf(q[1]) < he[1] && fabsf(q[2]) < he[2];
  float gaps[3];
  for (int a = 0; a < 3; ++a) gaps[a] = he[a] - fabsf(q[a]);
  float min_gap = fminf(fminf(gaps[0], gaps[1]), gaps[2]);
  bool snapped = false;
  float dl[3];
  for (int a = 0; a < 3; ++a) {
    float sgn = q[a] >= 0.0f ? 1.0f : -1.0f;
    bool is_min = gaps[a] == min_gap && !snapped;
    snapped = snapped || is_min;
    float clamped = fminf(fmaxf(q[a], -he[a]), he[a]);
    float proj = (ins && is_min) ? sgn * he[a] : clamped;
    dl[a] = proj - q[a];
  }
  float dw[3];
  quat_rot(qw, qx, qy, qz, dl, dw);
  bool box = fabsf(dw[0]) <= cap && fabsf(dw[1]) <= cap && fabsf(dw[2]) <= cap;
  *within = ins || box;
  *inside = ins;
  *dist = sqrtf(dw[0] * dw[0] + dw[1] * dw[1] + dw[2] * dw[2]);
}

// World position of window node n of a job whose block origin cell is bc.
__device__ __forceinline__ void node_pos(int n, int wsh1, int wsh2,
                                         const int bc[3], float h, float xw[3]) {
  int wx = n / (wsh1 * wsh2), wy = (n / wsh2) % wsh1, wz = n % wsh2;
  xw[0] = ((float)wx + (float)bc[0]) * h;
  xw[1] = ((float)wy + (float)bc[1]) * h;
  xw[2] = ((float)wz + (float)bc[2]) * h;
}

// Window node CDF: the gathered static channels, merged at gate level >= 2
// with the moving colliders (strictly closer wins, lower index on ties).
__device__ void window_node_cdf(const float* tile, const float* bt, int lvl,
                                unsigned moving, const float xw[3], float cap,
                                uint32_t* naff, float* closest, float* dist) {
  uint32_t a = aff_word(tile[0], tile[1]);
  float cl = tile[2], di = tile[3];
  if (lvl >= 2 && moving) {
    float d_dist = BIG, d_cl = -1.0f;
    uint32_t d_aff = 0;
    for (int s = 0; s < 16; ++s) {
      if (!((moving >> s) & 1u)) continue;
      bool within, inside;
      float d;
      cuboid_cdf(bt, s, xw, cap, &within, &inside, &d);
      if (within && d < d_dist) { d_cl = (float)s; d_dist = d; }
      if (within) d_aff |= inside ? ((1u << (16 + s)) | (1u << s)) : (1u << s);
    }
    float da = cl >= 0.0f ? di : BIG;
    bool bw = d_cl >= 0.0f &&
              (d_dist < da || (d_dist == da && (cl < 0.0f || d_cl < cl)));
    a |= d_aff;
    cl = bw ? d_cl : cl;
    di = bw ? d_dist : da;
  }
  *naff = a;
  *closest = cl;
  *dist = di;
}

// Velocity at xw of body `closest` (zero when closest < 0).
__device__ void node_body_velocity(float closest, const float xw[3],
                                   const float* bt, int nc, float bv[3]) {
  bv[0] = bv[1] = bv[2] = 0.0f;
  for (int b = 0; b < nc; ++b) {
    if (closest != (float)b) continue;
    float r[3];
    for (int k = 0; k < 3; ++k) r[k] = xw[k] - bt[k * 128 + b];
    float l0 = bt[3 * 128 + b], l1 = bt[4 * 128 + b], l2 = bt[5 * 128 + b];
    float a0 = bt[6 * 128 + b], a1 = bt[7 * 128 + b], a2 = bt[8 * 128 + b];
    bv[0] = l0 + a1 * r[2] - a2 * r[1];
    bv[1] = l1 + a2 * r[0] - a0 * r[2];
    bv[2] = l2 + a0 * r[1] - a1 * r[0];
  }
}

// CPIC ghost velocity of particle velocity vp against body velocity bv.
__device__ void ghost_velocity(const float vp[3], const float bv[3],
                               const float nrm[3], float g[3]) {
  float u[3];
  for (int i = 0; i < 3; ++i) u[i] = vp[i] - bv[i];
  float nv = u[0] * nrm[0] + u[1] * nrm[1] + u[2] * nrm[2];
  float tang[3];
  for (int i = 0; i < 3; ++i) tang[i] = u[i] - nrm[i] * nv;
  float tl = sqrtf(tang[0] * tang[0] + tang[1] * tang[1] + tang[2] * tang[2]);
  float inv_tl = tl > 1e-8f ? nr_recip(fmaxf(tl, 1e-30f)) : 0.0f;
  float scale = fmaxf(tl + FRICTION * nv, 0.0f) * inv_tl;
  bool sliding = nv < 0.0f;
  for (int i = 0; i < 3; ++i) g[i] = bv[i] + (sliding ? tang[i] * scale : u[i]);
}

// Quadratic B-spline stencil of a particle inside its job window.
// A stencil node outside the window (past its high edge when the base cell
// rounds up at an exact half-cell tie; below its low edge when p * (1/h)
// rounds below the p / h of the block sort key) is dropped, as the TPU
// kernels drop it: weight 0, index 0, its bit in `valid` clear.
struct Stencil {
  float w[27];
  int n[27];
  unsigned valid;
};

// Per-axis weights wa[axis][offset] and the stencil's base cell relative
// to the block origin bc.  Node (ox, oy, oz) of the stencil has weight
// (wa[0][ox] * wa[1][oy]) * wa[2][oz].
__device__ void stencil_axes(const float p[3], const int bc[3], float inv_h,
                             float wa[3][3], int bl[3]) {
  for (int a = 0; a < 3; ++a) {
    float u = p[a] * inv_h;
    int base = (int)floorf(u + 0.5f) - 1;
    float xf = u - (float)base;
    float t0 = 1.5f - xf, t1 = xf - 1.0f, t2 = xf - 0.5f;
    wa[a][0] = 0.5f * (t0 * t0);
    wa[a][1] = 0.75f - t1 * t1;
    wa[a][2] = 0.5f * (t2 * t2);
    bl[a] = base - bc[a];
  }
}

__device__ void stencil(const float p[3], const int bc[3], float inv_h,
                        int wsh1, int wsh2, Stencil* s) {
  const int wsh[3] = {6, wsh1, wsh2};
  float wa[3][3];
  int bl[3];
  stencil_axes(p, bc, inv_h, wa, bl);
  int o = 0;
  s->valid = 0u;
  for (int ox = 0; ox < 3; ++ox)
    for (int oy = 0; oy < 3; ++oy) {
      float wxy = wa[0][ox] * wa[1][oy];
      for (int oz = 0; oz < 3; ++oz, ++o) {
        bool ok = bl[0] + ox >= 0 && bl[0] + ox < wsh[0] && bl[1] + oy >= 0 &&
                  bl[1] + oy < wsh[1] && bl[2] + oz >= 0 && bl[2] + oz < wsh[2];
        s->w[o] = ok ? wxy * wa[2][oz] : 0.0f;
        s->n[o] = ok ? (bl[0] + ox) * (wsh1 * wsh2) + (bl[1] + oy) * wsh2 + bl[2] + oz : 0;
        if (ok) s->valid |= 1u << o;
      }
    }
}

// The P2G kernels' second launch, one block of 96 threads: imp[0, r, b] =
// sum over jobs, in job order, of the per-job impulses part[j, r, b]
// (part [MAXJ, 6, 16], imp [1, 8, 128]).
__global__ void impulse_sum_kernel(const float* part, int maxj, float* imp) {
  int t = threadIdx.x;
  if (t >= 96) return;
  float acc = 0.0f;
  for (int j = 0; j < maxj; ++j) acc = acc + part[(long long)j * 96 + t];
  imp[(t / 16) * 128 + t % 16] = acc;
}
