// The rigid solve of a substep: body contacts, then joints, in one launch.
//
// Replaces no Pallas kernel: the JAX package runs this solver as plain XLA
// (wgsparkl_tpu/rigid/contacts.py resolve_contacts, a Gauss-Seidel lax.scan
// over contact samples, and rigid/joints.py resolve_joints, eight sweeps
// over the joints).  Issued op by op it would take thousands of launches a
// substep; here it is one block and one launch, with no host sync.
//
// What bounds it: the dependency chain of the Gauss-Seidel sweeps, whose
// every impulse reads the velocities the previous one wrote.  The design:
//   1. every thread of the block computes, in parallel, the pose-dependent
//      terms of contact samples (point, normal, depth, levers, normal
//      effective mass, positional bias) and of joints (levers, anchor bias,
//      inverse effective masses, angular terms) into a scratch buffer;
//      they are the same in every sweep;
//   2. thread 0 then lists the active samples (depth > 0) once, in sample
//      order, runs the contact sweeps over that list and the joint sweeps,
//      in the plain version's order, on velocity tables in shared memory,
//      and writes them out.  (Walking every sample in every sweep cost
//      0.155 ms a launch on 616 samples, mostly inactive: a chain of
//      dependent loads.)
// Every operation follows the plain PyTorch version (rigid/contacts.py,
// rigid/joints.py) in order, with IEEE division and sqrt and no FMA
// contraction (-fmad=false), so the kernel equals it bit for bit.
//
// Layouts (float32, row-major): rot [B, 4 | 2], pos, com, inv_mass,
// lin [B, D], ang [B, NA], inertia [B, NA, NA], params [B, 8]; pairs
// [P, 5] int32 (b, bt, c, ct, two_way), cand [K, 2] int32 (pair, sample)
// in solve order, offs [S, D] cuboid sample offsets; joints ji [J, 3]
// int32 (b, c, kind: 0 ball, 1 fixed, 2 revolute, 3 prismatic), jf [J, 16]
// (anchor b [0:3], anchor c [3:6], axis [6:9], axis in c's frame [9:12],
// initial relative rotation [12:16]); scratch: K sample records, J joint
// records, then K ints of the active-sample list.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAXB = 16;
constexpr int CAND_F = 20;   // floats a contact sample's record
constexpr int JOINT_F = 48;  // floats a joint's record
constexpr int CUBOID = 0, BALL = 1, CAPSULE = 2, HALFSPACE = 3;
constexpr int BALLJ = 0, REVOLUTE = 2, PRISMATIC = 3;  // and 1: fixed

// PyTorch's clamp(min=m), maximum, minimum: NaN propagates.
__device__ __forceinline__ float clamp_min(float x, float m) {
  return isnan(x) ? x : fmaxf(x, m);
}
__device__ __forceinline__ float tmax(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tmin(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}
__device__ __forceinline__ float tsign(float x) {
  return (float)(0.f < x) - (float)(x < 0.f);
}

template <int D> struct Geo { static constexpr int NA = D == 3 ? 3 : 1, NR = D == 3 ? 4 : 2; };

template <int N> __device__ __forceinline__ float dot(const float* a, const float* b) {
  float acc = a[0] * b[0];
#pragma unroll
  for (int i = 1; i < N; ++i) acc = acc + a[i] * b[i];
  return acc;
}

// 3D cross product; in 2D the scalar cross into o[0].
template <int D> __device__ __forceinline__ void cross(const float* a, const float* b, float* o) {
  if (D == 2) {
    o[0] = a[0] * b[1] - a[1] * b[0];
  } else {
    float x = a[1] * b[2] - a[2] * b[1], y = a[2] * b[0] - a[0] * b[2],
          z = a[0] * b[1] - a[1] * b[0];
    o[0] = x; o[1] = y; o[2] = z;
  }
}

// Velocity of angular velocity w at lever r.
template <int D> __device__ __forceinline__ void avel(const float* w, const float* r, float* o) {
  if (D == 2) {
    float x = -w[0] * r[1], y = w[0] * r[0];
    o[0] = x; o[1] = y;
  } else {
    cross<3>(w, r, o);
  }
}

// o = m v, m [N, N] row-major.
template <int N> __device__ __forceinline__ void matvec(const float* m, const float* v, float* o) {
  float t[N];
#pragma unroll
  for (int i = 0; i < N; ++i) t[i] = dot<N>(m + i * N, v);
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] = t[i];
}

// sum_a (v_a v_a) w_a.
template <int N> __device__ __forceinline__ float wsum(const float* v, const float* w) {
  float acc = (v[0] * v[0]) * w[0];
#pragma unroll
  for (int i = 1; i < N; ++i) acc = acc + (v[i] * v[i]) * w[i];
  return acc;
}

// cdf_channel._quat_rotate_ch.
__device__ __forceinline__ void qrot(float w, float x, float y, float z, const float* v,
                                     float* o) {
  float t0 = 2.0f * (y * v[2] - z * v[1]);
  float t1 = 2.0f * (z * v[0] - x * v[2]);
  float t2 = 2.0f * (x * v[1] - y * v[0]);
  float a = v[0] + w * t0 + (y * t2 - z * t1);
  float b = v[1] + w * t1 + (z * t0 - x * t2);
  float c = v[2] + w * t2 + (x * t1 - y * t0);
  o[0] = a; o[1] = b; o[2] = c;
}

// cdf_channel._to_world_vec (rotation of a local vector).
template <int D> __device__ __forceinline__ void to_world_vec(const float* r, const float* v,
                                                              float* o) {
  if (D == 2) {
    float a = r[0] * v[0] - r[1] * v[1], b = r[1] * v[0] + r[0] * v[1];
    o[0] = a; o[1] = b;
  } else {
    qrot(r[0], r[1], r[2], r[3], v, o);
  }
}

template <int D> __device__ __forceinline__ void transform(const float* r, const float* t,
                                                           const float* v, float* o) {
  to_world_vec<D>(r, v, o);
#pragma unroll
  for (int a = 0; a < D; ++a) o[a] = o[a] + t[a];
}

// cdf_channel._to_local.
template <int D> __device__ __forceinline__ void to_local(const float* r, const float* t,
                                                          const float* p, float* q) {
  float rel[3];
#pragma unroll
  for (int a = 0; a < D; ++a) rel[a] = p[a] - t[a];
  if (D == 2) {
    float c = r[0], s = -r[1];
    q[0] = c * rel[0] - s * rel[1];
    q[1] = s * rel[0] + c * rel[1];
  } else {
    qrot(r[0], -r[1], -r[2], -r[3], rel, q);
  }
}

// cdf_channel.project: boundary projection of local q; returns inside.
template <int D> __device__ bool project(int st, const float* prm, const float* q, float* proj) {
  if (st == CUBOID) {
    bool inside = true;
    float gap[3], min_gap = 0.f;
#pragma unroll
    for (int a = 0; a < D; ++a) {
      float he = prm[a];
      inside = inside && (fabsf(q[a]) < he);
      gap[a] = he - fabsf(q[a]);
      min_gap = a == 0 ? gap[0] : tmin(min_gap, gap[a]);
    }
    bool snapped = false;
#pragma unroll
    for (int a = 0; a < D; ++a) {
      float he = prm[a];
      float clamped = tmin(tmax(q[a], -he), he);
      bool is_min = (gap[a] == min_gap) && !snapped;
      snapped = snapped || is_min;
      float sgn = q[a] >= 0.f ? 1.0f : -1.0f;
      proj[a] = (inside && is_min) ? sgn * he : clamped;
    }
    return inside;
  }
  if (st == BALL) {
    float radius = prm[0];
    float n = sqrtf(dot<D>(q, q));
    bool away = n > 1e-12f;
    float inv = away ? 1.0f / clamp_min(n, 1e-30f) : 0.f;
#pragma unroll
    for (int a = 0; a < D; ++a) proj[a] = away ? q[a] * inv * radius : 0.f;
    proj[0] = away ? proj[0] : radius;
    return n < radius;
  }
  if (st == CAPSULE) {
    float hh = prm[0], radius = prm[1];
    float cy = tmin(tmax(q[1], -hh), hh);
    float base[3], rel[3];
#pragma unroll
    for (int a = 0; a < D; ++a) {
      base[a] = a == 1 ? cy : 0.0f;
      rel[a] = q[a] - base[a];
    }
    float n = sqrtf(dot<D>(rel, rel));
    bool away = n > 1e-12f;
    float inv = away ? 1.0f / clamp_min(n, 1e-30f) : 0.f;
#pragma unroll
    for (int a = 0; a < D; ++a)
      proj[a] = base[a] + (away ? rel[a] * inv : (a == 0 ? 1.0f : 0.0f)) * radius;
    return n < radius;
  }
  // Halfspace: boundary y = 0, inside y < 0.
#pragma unroll
  for (int a = 0; a < D; ++a) proj[a] = a == 1 ? 0.0f : q[a];
  return q[1] < 0.f;
}

struct Bodies {
  const float *rot, *pos, *com, *im, *inertia, *params, *plin, *pang;
};

// A contact sample's record: n [0:3], rb [3:6], rc [6:9], rxn_b [9:12],
// rxn_c [12:15], k_n 15, bias 16, depth 17.
template <int D>
__device__ void contact_terms(const Bodies& B, const int* pr, int s, const float* offs,
                              float dt, float slop, float beta, float* rec) {
  constexpr int NA = Geo<D>::NA, NR = Geo<D>::NR;
  const int b = pr[0], bt = pr[1], c = pr[2], ct = pr[3], two_way = pr[4];
  const float* pb = B.params + b * 8;
  float pt[3], dpt[3], q[3], proj[3], w[3], n[3];
  float radius = 0.f;
  if (bt == CUBOID) {
    float local[3];
#pragma unroll
    for (int a = 0; a < D; ++a) local[a] = offs[s * D + a] * pb[a];
    transform<D>(B.rot + b * NR, B.pos + b * D, local, pt);
  } else if (bt == BALL) {
    radius = pb[0];
#pragma unroll
    for (int a = 0; a < D; ++a) pt[a] = B.com[b * D + a];
  } else {
    float hh = pb[0], local[3] = {0.f, s == 0 ? hh : -hh, 0.f};
    radius = pb[1];
    transform<D>(B.rot + b * NR, B.pos + b * D, local, pt);
  }
  const float* rc_ = B.rot + c * NR;
  const float* tc = B.pos + c * D;
  to_local<D>(rc_, tc, pt, q);
  bool inside = project<D>(ct, B.params + c * 8, q, proj);
  transform<D>(rc_, tc, proj, w);
#pragma unroll
  for (int a = 0; a < D; ++a) dpt[a] = w[a] - pt[a];
  float dist = sqrtf(dot<D>(dpt, dpt));
  float safe = clamp_min(dist, 1e-12f);
  float depth;
  if (bt == CUBOID) {
#pragma unroll
    for (int a = 0; a < D; ++a) n[a] = dpt[a] / safe;
    depth = inside ? dist : -1.0f;
  } else {
#pragma unroll
    for (int a = 0; a < D; ++a) {
      float dirn = dpt[a] / safe;
      n[a] = inside ? dirn : -dirn;
      pt[a] = pt[a] + dpt[a];
    }
    depth = inside ? radius + dist : radius - dist;
  }
  float rb[3], rc[3], xb[3], xc[3], u[3];
#pragma unroll
  for (int a = 0; a < D; ++a) {
    rb[a] = pt[a] - B.com[b * D + a];
    rc[a] = pt[a] - B.com[c * D + a];
  }
  cross<D>(rb, n, xb);
  cross<D>(rc, n, xc);
  matvec<NA>(B.inertia + b * NA * NA, xb, u);
  float k_n = wsum<D>(n, B.im + b * D) + dot<NA>(xb, u);
  if (two_way) {
    matvec<NA>(B.inertia + c * NA * NA, xc, u);
    k_n = (k_n + wsum<D>(n, B.im + c * D)) + dot<NA>(xc, u);
  }
  float bias = beta * clamp_min(depth - slop, 0.0f) / dt;
#pragma unroll
  for (int a = 0; a < D; ++a) { rec[a] = n[a]; rec[3 + a] = rb[a]; rec[6 + a] = rc[a]; }
#pragma unroll
  for (int a = 0; a < NA; ++a) { rec[9 + a] = xb[a]; rec[12 + a] = xc[a]; }
  rec[15] = k_n;
  rec[16] = bias;
  rec[17] = depth;
}

// One Gauss-Seidel impulse of a sample (contacts.contact_step).
template <int D>
__device__ void contact_step(const Bodies& B, float* V, float* W, const int* pr,
                             const float* rec, float friction) {
  constexpr int NA = Geo<D>::NA;
  const int b = pr[0], c = pr[2], two_way = pr[4];
  const float *n = rec, *rb = rec + 3, *rc = rec + 6, *xb = rec + 9, *xc = rec + 12;
  const float *im_b = B.im + b * D, *im_c = B.im + c * D;
  const float *ii_b = B.inertia + b * NA * NA, *ii_c = B.inertia + c * NA * NA;
  float vb[3], vc[3], vrel[3], tmp[3], u[3];

  auto rel_vel = [&]() {
    avel<D>(W + b * 3, rb, tmp);
#pragma unroll
    for (int a = 0; a < D; ++a) vb[a] = V[b * 3 + a] + tmp[a];
    if (two_way) {
      avel<D>(W + c * 3, rc, tmp);
#pragma unroll
      for (int a = 0; a < D; ++a) vc[a] = V[c * 3 + a] + tmp[a];
    } else {
      avel<D>(B.pang + c * NA, rc, tmp);
#pragma unroll
      for (int a = 0; a < D; ++a) vc[a] = B.plin[c * D + a] + tmp[a];
    }
#pragma unroll
    for (int a = 0; a < D; ++a) vrel[a] = vb[a] - vc[a];
  };

  rel_vel();
  float vn = dot<D>(vrel, n);
  float jn = clamp_min((-vn + rec[16]) / clamp_min(rec[15], 1e-12f), 0.0f);
#pragma unroll
  for (int a = 0; a < D; ++a) V[b * 3 + a] = V[b * 3 + a] + (jn * n[a]) * im_b[a];
#pragma unroll
  for (int a = 0; a < NA; ++a) tmp[a] = xb[a] * jn;
  matvec<NA>(ii_b, tmp, u);
#pragma unroll
  for (int a = 0; a < NA; ++a) W[b * 3 + a] = W[b * 3 + a] + u[a];
  if (two_way) {
    float njn = -jn;
#pragma unroll
    for (int a = 0; a < D; ++a) V[c * 3 + a] = V[c * 3 + a] + (njn * n[a]) * im_c[a];
#pragma unroll
    for (int a = 0; a < NA; ++a) tmp[a] = xc[a] * njn;
    matvec<NA>(ii_c, tmp, u);
#pragma unroll
    for (int a = 0; a < NA; ++a) W[c * 3 + a] = W[c * 3 + a] + u[a];
  }

  rel_vel();
  vn = dot<D>(vrel, n);
  float vt[3], t[3], xtb[3], xtc[3];
#pragma unroll
  for (int a = 0; a < D; ++a) vt[a] = vrel[a] - vn * n[a];
  float vt_len = sqrtf(dot<D>(vt, vt));
  float safe = clamp_min(vt_len, 1e-12f);
#pragma unroll
  for (int a = 0; a < D; ++a) t[a] = vt[a] / safe;
  cross<D>(rb, t, xtb);
  cross<D>(rc, t, xtc);
  matvec<NA>(ii_b, xtb, u);
  float k_t = wsum<D>(t, im_b) + dot<NA>(xtb, u);
  if (two_way) {
    matvec<NA>(ii_c, xtc, u);
    k_t = (k_t + wsum<D>(t, im_c)) + dot<NA>(xtc, u);
  }
  float jt = tmin(clamp_min(vt_len / clamp_min(k_t, 1e-12f), 0.0f), friction * jn);
  jt = vt_len > 1e-9f ? jt : 0.0f;
  float njt = -jt;
#pragma unroll
  for (int a = 0; a < D; ++a) V[b * 3 + a] = V[b * 3 + a] + (njt * t[a]) * im_b[a];
#pragma unroll
  for (int a = 0; a < NA; ++a) tmp[a] = xtb[a] * njt;
  matvec<NA>(ii_b, tmp, u);
#pragma unroll
  for (int a = 0; a < NA; ++a) W[b * 3 + a] = W[b * 3 + a] + u[a];
  if (two_way) {
#pragma unroll
    for (int a = 0; a < D; ++a) V[c * 3 + a] = V[c * 3 + a] + (jt * t[a]) * im_c[a];
#pragma unroll
    for (int a = 0; a < NA; ++a) tmp[a] = xtc[a] * jt;
    matvec<NA>(ii_c, tmp, u);
#pragma unroll
    for (int a = 0; a < NA; ++a) W[c * 3 + a] = W[c * 3 + a] + u[a];
  }
}

__device__ __forceinline__ void inv2(const float* k, float* o) {
  float det = k[0] * k[3] - k[1] * k[2];
  float inv_det = fabsf(det) > 1e-12f ? 1.0f / det : 0.0f;
  float a = inv_det * k[3], b = inv_det * -k[1], c = inv_det * -k[2], d = inv_det * k[0];
  o[0] = a; o[1] = b; o[2] = c; o[3] = d;
}

__device__ __forceinline__ void inv3(const float* k, float* o) {
  float c[9];
  cross<3>(k + 3, k + 6, c);
  cross<3>(k + 6, k, c + 3);
  cross<3>(k, k + 3, c + 6);
  float det = dot<3>(k, c);
  float inv_det = fabsf(det) > 1e-12f ? 1.0f / det : 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) o[i * 3 + j] = inv_det * c[j * 3 + i];
}

// o = a b, 3 x 3 row-major.
__device__ __forceinline__ void matmul3(const float* a, const float* b, float* o) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float col[3] = {b[j], b[3 + j], b[6 + j]};
      o[i * 3 + j] = dot<3>(a + i * 3, col);
    }
}

// Row vector v times N x N matrix m.
template <int N> __device__ __forceinline__ void vecmat(const float* v, const float* m, float* o) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float col[3];
#pragma unroll
    for (int i = 0; i < N; ++i) col[i] = m[i * N + j];
    o[j] = dot<N>(v, col);
  }
}

// joints._tangents: unit t1 perpendicular to a, t2 = a x t1.
__device__ __forceinline__ void tangents(const float* a, float* t1, float* t2) {
  bool near_x = fabsf(a[0]) < 0.9f;
  float h[3] = {near_x ? 1.0f : 0.0f, near_x ? 0.0f : 1.0f, 0.0f};
  cross<3>(a, h, t1);
  float nrm = clamp_min(sqrtf(dot<3>(t1, t1)), 1e-12f);
#pragma unroll
  for (int i = 0; i < 3; ++i) t1[i] = t1[i] / nrm;
  cross<3>(a, t1, t2);
}

// joints._k2: [[t1 k t1, t1 k t2], [t2 k t1, t2 k t2]].
__device__ __forceinline__ void k2(const float* t1, const float* t2, const float* k, float* o) {
  float a[3], b[3];
  vecmat<3>(t1, k, a);
  vecmat<3>(t2, k, b);
  o[0] = dot<3>(a, t1); o[1] = dot<3>(a, t2); o[2] = dot<3>(b, t1); o[3] = dot<3>(b, t2);
}

__device__ __forceinline__ void quat_mul(const float* a, const float* b, float* o) {
  float w1 = a[0], x1 = a[1], y1 = a[2], z1 = a[3];
  float w2 = b[0], x2 = b[1], y2 = b[2], z2 = b[3];
  float w = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2;
  float x = w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2;
  float y = w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2;
  float z = w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2;
  o[0] = w; o[1] = x; o[2] = y; o[3] = z;
}

// A joint's record: rb [0:3], rc [3:6], bias [6:9], dyn_b 9, dyn_c 10;
// linear: kinv [12:21] (2D [12:16]), or prismatic 2D t1 [12:14], k1 14,
// 3D t1 [12:15], t2 [15:18], kinv [18:22]; angular: ang_bias [24:27]
// (2D scalar 24), 2D ang_k 27, 3D fixed ang_kinv [28:37], revolute
// ang_t1 [28:31], ang_t2 [31:34], ang_kinv [34:38].
template <int D>
__device__ void joint_terms(const Bodies& B, const int* ji, const float* jf, float bdt,
                            float* rec) {
  constexpr int NA = Geo<D>::NA, NR = Geo<D>::NR;
  const int b = ji[0], c = ji[1], kind = ji[2];
  const float *im_b = B.im + b * D, *im_c = B.im + c * D;
  const float *ii_b = B.inertia + b * NA * NA, *ii_c = B.inertia + c * NA * NA;
  float ab[3], ac[3];
  transform<D>(B.rot + b * NR, B.pos + b * D, jf, ab);
  transform<D>(B.rot + c * NR, B.pos + c * D, jf + 3, ac);
  float rb[3], rc[3];
#pragma unroll
  for (int a = 0; a < D; ++a) {
    rb[a] = ab[a] - B.com[b * D + a];
    rc[a] = ac[a] - B.com[c * D + a];
    rec[a] = rb[a];
    rec[3 + a] = rc[a];
    rec[6 + a] = bdt * (ab[a] - ac[a]);
  }
  rec[9] = im_b[0] != 0.0f ? 1.0f : 0.0f;
  rec[10] = im_c[0] != 0.0f ? 1.0f : 0.0f;
  float k[9];
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) k[i * D + j] = (im_b[j] + im_c[j]) * (i == j ? 1.0f : 0.0f);
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    const float* ii = side ? ii_c : ii_b;
    const float* r = side ? rc : rb;
    float s[9];
    if (D == 2) {
      float i0 = ii[0];
      s[0] = i0 * (r[1] * r[1]);
      s[1] = i0 * (-r[0] * r[1]);
      s[2] = i0 * (-r[0] * r[1]);
      s[3] = i0 * (r[0] * r[0]);
    } else {
      float nrx[9] = {-0.0f, r[2], -r[1], -r[2], -0.0f, r[0], r[1], -r[0], -0.0f};
      float rx[9] = {0.0f, -r[2], r[1], r[2], 0.0f, -r[0], -r[1], r[0], 0.0f};
      float m[9];
      matmul3(nrx, ii, m);
      matmul3(m, rx, s);
    }
#pragma unroll
    for (int i = 0; i < D * D; ++i) k[i] = k[i] + s[i];
  }
  if (kind == PRISMATIC) {
    float aw[3];
    to_world_vec<D>(B.rot + b * NR, jf + 6, aw);
    if (D == 2) {
      float t1[2] = {-aw[1], aw[0]}, kt[2];
      matvec<2>(k, t1, kt);
      rec[12] = t1[0]; rec[13] = t1[1]; rec[14] = dot<2>(t1, kt);
    } else {
      float t1[3], t2[3], kk[4];
      tangents(aw, t1, t2);
      k2(t1, t2, k, kk);
#pragma unroll
      for (int i = 0; i < 3; ++i) { rec[12 + i] = t1[i]; rec[15 + i] = t2[i]; }
      inv2(kk, rec + 18);
    }
  } else if (D == 2) {
    inv2(k, rec + 12);
  } else {
    inv3(k, rec + 12);
  }
  if (kind == BALLJ) return;
  const float* rel0 = jf + 12;
  if (D == 2) {
    const float *rbt = B.rot + b * NR, *rct = B.rot + c * NR;
    float cb = rbt[0], sb = -rbt[1];
    float rel_c = cb * rct[0] - sb * rct[1], rel_s = cb * rct[1] + sb * rct[0];
    float err = rel_c * -rel0[1] + rel_s * rel0[0];
    rec[24] = bdt * err;
    rec[27] = ii_b[0] + ii_c[0];
    return;
  }
  float ksum[9], err[3];
#pragma unroll
  for (int i = 0; i < 9; ++i) ksum[i] = ii_b[i] + ii_c[i];
  const float *qb = B.rot + b * NR, *qc = B.rot + c * NR;
  if (kind == REVOLUTE) {
    float axb[3], axc[3], t1[3], t2[3], x[3], kk[4];
    qrot(qb[0], qb[1], qb[2], qb[3], jf + 6, axb);
    qrot(qc[0], qc[1], qc[2], qc[3], jf + 9, axc);
    tangents(axb, t1, t2);
    cross<3>(axc, axb, x);
#pragma unroll
    for (int i = 0; i < 3; ++i) { err[i] = -x[i]; rec[28 + i] = t1[i]; rec[31 + i] = t2[i]; }
    k2(t1, t2, ksum, kk);
    inv2(kk, rec + 34);
  } else {
    float cqb[4] = {qb[0], -qb[1], -qb[2], -qb[3]};
    float crel[4] = {rel0[0], -rel0[1], -rel0[2], -rel0[3]};
    float qrel[4], qerr[4];
    quat_mul(cqb, qc, qrel);
    quat_mul(qrel, crel, qerr);
    float two_sign = 2.0f * tsign(qerr[0]);
    float v[3] = {two_sign * qerr[1], two_sign * qerr[2], two_sign * qerr[3]};
    qrot(qb[0], qb[1], qb[2], qb[3], v, err);
    inv3(ksum, rec + 28);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) rec[24 + i] = bdt * err[i];
}

// One Gauss-Seidel pass of a joint (joints.joint_step).
template <int D>
__device__ void joint_step(const Bodies& B, float* V, float* W, const int* ji,
                           const float* rec) {
  constexpr int NA = Geo<D>::NA;
  const int b = ji[0], c = ji[1], kind = ji[2];
  const bool dyn_b = rec[9] != 0.0f, dyn_c = rec[10] != 0.0f;
  const float *rb = rec, *rc = rec + 3;
  float vb[3], vc[3], verr[3], imp[3], tmp[3], u[3];
  avel<D>(dyn_b ? W + b * 3 : B.pang + b * NA, rb, tmp);
#pragma unroll
  for (int a = 0; a < D; ++a) vb[a] = (dyn_b ? V[b * 3 + a] : B.plin[b * D + a]) + tmp[a];
  avel<D>(dyn_c ? W + c * 3 : B.pang + c * NA, rc, tmp);
#pragma unroll
  for (int a = 0; a < D; ++a) vc[a] = (dyn_c ? V[c * 3 + a] : B.plin[c * D + a]) + tmp[a];
#pragma unroll
  for (int a = 0; a < D; ++a) verr[a] = (vb[a] - vc[a]) + rec[6 + a];
  if (kind == PRISMATIC && D == 2) {
    const float* t1 = rec + 12;
    float k1 = rec[14];
    float p1 = -(k1 > 1e-12f ? dot<2>(t1, verr) / clamp_min(k1, 1e-30f) : 0.0f);
#pragma unroll
    for (int a = 0; a < D; ++a) imp[a] = p1 * t1[a];
  } else if (kind == PRISMATIC) {
    const float *t1 = rec + 12, *t2 = rec + 15;
    float rr[2] = {dot<3>(t1, verr), dot<3>(t2, verr)}, p2[2];
    matvec<2>(rec + 18, rr, p2);
    p2[0] = -p2[0];
    p2[1] = -p2[1];
#pragma unroll
    for (int a = 0; a < 3; ++a) imp[a] = p2[0] * t1[a] + p2[1] * t2[a];
  } else {
    matvec<D>(rec + 12, verr, imp);
#pragma unroll
    for (int a = 0; a < D; ++a) imp[a] = -imp[a];
  }
  if (dyn_b) {
#pragma unroll
    for (int a = 0; a < D; ++a) V[b * 3 + a] = V[b * 3 + a] + imp[a] * B.im[b * D + a];
    cross<D>(rb, imp, tmp);
    matvec<NA>(B.inertia + b * NA * NA, tmp, u);
#pragma unroll
    for (int a = 0; a < NA; ++a) W[b * 3 + a] = W[b * 3 + a] + u[a];
  }
  if (dyn_c) {
    float nimp[3];
#pragma unroll
    for (int a = 0; a < D; ++a) {
      nimp[a] = -imp[a];
      V[c * 3 + a] = V[c * 3 + a] + nimp[a] * B.im[c * D + a];
    }
    cross<D>(rc, nimp, tmp);
    matvec<NA>(B.inertia + c * NA * NA, tmp, u);
#pragma unroll
    for (int a = 0; a < NA; ++a) W[c * 3 + a] = W[c * 3 + a] + u[a];
  }
  if (kind == BALLJ || (kind == REVOLUTE && D == 2)) return;
  const float* wb = dyn_b ? W + b * 3 : B.pang + b * NA;
  const float* wc = dyn_c ? W + c * 3 : B.pang + c * NA;
  float r[3], p[3];
#pragma unroll
  for (int a = 0; a < NA; ++a) r[a] = (wc[a] - wb[a]) + rec[24 + a];
  if (D == 2) {
    float k = rec[27];
    p[0] = -(k > 1e-12f ? r[0] / clamp_min(k, 1e-30f) : 0.0f);
  } else if (kind == REVOLUTE) {
    const float *t1 = rec + 28, *t2 = rec + 31;
    float rr[2] = {dot<3>(t1, r), dot<3>(t2, r)}, p2[2];
    matvec<2>(rec + 34, rr, p2);
    p2[0] = -p2[0];
    p2[1] = -p2[1];
#pragma unroll
    for (int a = 0; a < 3; ++a) p[a] = p2[0] * t1[a] + p2[1] * t2[a];
  } else {
    matvec<3>(rec + 28, r, p);
#pragma unroll
    for (int a = 0; a < 3; ++a) p[a] = -p[a];
  }
  if (dyn_c) {
    matvec<NA>(B.inertia + c * NA * NA, p, u);
#pragma unroll
    for (int a = 0; a < NA; ++a) W[c * 3 + a] = W[c * 3 + a] + u[a];
  }
  if (dyn_b) {
    matvec<NA>(B.inertia + b * NA * NA, p, u);
#pragma unroll
    for (int a = 0; a < NA; ++a) W[b * 3 + a] = W[b * 3 + a] + -u[a];
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) rigid_solve_kernel(
    Bodies B, const float* lin_in, const float* ang_in, const int* pairs, const int* cand,
    int k_total, const float* offs, const int* ji, const float* jf, int nj, float* scratch,
    float* lin_out, float* ang_out, int nb, float dt, float slop, float beta,
    float friction, int iters_c, float bdt, int iters_j) {
  constexpr int NA = Geo<D>::NA;
  __shared__ float V[MAXB * 3], W[MAXB * 3];
  float* crec = scratch;
  float* jrec = scratch + (size_t)k_total * CAND_F;
  int* active = reinterpret_cast<int*>(jrec + (size_t)nj * JOINT_F);
  for (int i = threadIdx.x; i < k_total; i += THREADS)
    contact_terms<D>(B, pairs + cand[2 * i] * 5, cand[2 * i + 1], offs, dt, slop, beta,
                     crec + (size_t)i * CAND_F);
  for (int i = threadIdx.x; i < nj; i += THREADS)
    joint_terms<D>(B, ji + 3 * i, jf + 16 * i, bdt, jrec + (size_t)i * JOINT_F);
  for (int i = threadIdx.x; i < nb * 3; i += THREADS) {
    int body = i / 3, a = i % 3;
    V[i] = a < D ? lin_in[body * D + a] : 0.0f;
    W[i] = a < NA ? ang_in[body * NA + a] : 0.0f;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int n_active = 0;
    for (int i = 0; i < k_total; ++i)
      if (crec[(size_t)i * CAND_F + 17] > 0.0f) active[n_active++] = i;
    for (int it = 0; it < iters_c; ++it)
      for (int a = 0; a < n_active; ++a) {
        const int i = active[a];
        contact_step<D>(B, V, W, pairs + cand[2 * i] * 5, crec + (size_t)i * CAND_F,
                        friction);
      }
    for (int it = 0; it < iters_j; ++it)
      for (int i = 0; i < nj; ++i) joint_step<D>(B, V, W, ji + 3 * i, jrec + (size_t)i * JOINT_F);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nb * 3; i += THREADS) {
    int body = i / 3, a = i % 3;
    if (a < D) lin_out[body * D + a] = V[i];
    if (a < NA) ang_out[body * NA + a] = W[i];
  }
}

}  // namespace

extern "C" int rigid_solve_cuda(
    const float* rot, const float* pos, const float* com, const float* inv_mass,
    const float* inertia, const float* params, const float* plin, const float* pang,
    const float* lin_in, const float* ang_in, const int* pairs, const int* cand,
    long long k_total, const float* offs, const int* ji, const float* jf, long long nj,
    float* scratch, float* lin_out, float* ang_out, long long nb, long long dim,
    float dt, float slop, float beta, float friction, long long iters_c, float bdt,
    long long iters_j, cudaStream_t stream) {
  Bodies B{rot, pos, com, inv_mass, inertia, params, plin, pang};
  if (dim == 3)
    rigid_solve_kernel<3><<<1, THREADS, 0, stream>>>(
        B, lin_in, ang_in, pairs, cand, (int)k_total, offs, ji, jf, (int)nj, scratch,
        lin_out, ang_out, (int)nb, dt, slop, beta, friction, (int)iters_c, bdt,
        (int)iters_j);
  else
    rigid_solve_kernel<2><<<1, THREADS, 0, stream>>>(
        B, lin_in, ang_in, pairs, cand, (int)k_total, offs, ji, jf, (int)nj, scratch,
        lin_out, ang_out, (int)nb, dt, slop, beta, friction, (int)iters_c, bdt,
        (int)iters_j);
  return (int)cudaGetLastError();
}
