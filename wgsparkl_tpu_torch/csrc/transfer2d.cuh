// Device helpers shared by the 2D transfer kernels (pcdf2d.cu, p2g2d.cu,
// g2p2d.cu).  Each follows its plain PyTorch counterpart in
// wgsparkl_tpu_torch/ops/rows2d.py, ops/transfer2d.py and
// collision/cdf_channel.py operation by operation.
#pragma once
#include "cpic.cuh"

#define WSH 10              // window nodes per axis: an 8 x 8 block + 2-node halo
#define WVOL 100            // window nodes, node index wx * 10 + wy
#define WPAD 104            // rows of a window tile

// Rows of the 2D particle matrix (ops/rows2d.py).
#define PX 0
#define VX 2
#define PM 4
#define A0 5
#define AFF 9
#define NX 10
#define AFF_SPARE 12

// World position of window node n of a job whose block origin cell is bc.
__device__ __forceinline__ void node_pos2(int n, const int bc[2], float h, float xw[2]) {
  xw[0] = ((float)(n / WSH) + (float)bc[0]) * h;
  xw[1] = ((float)(n % WSH) + (float)bc[1]) * h;
}

// Analytic collider `slot` of the 2D body table (rows 5-6 rotation (cos,
// sin), 7-8 translation, 9-11 shape parameters) at world point p, of type
// (shapes >> 2 slot) & 3 (cdf_channel.collider_cdf with two channels):
// within (affinity reach), inside, world distance to the boundary.
__device__ void collider_cdf2(const float* bt, int slot, unsigned shapes,
                              const float p[2], float cap, bool* within,
                              bool* inside, float* dist) {
  const float c = bt[5 * 128 + slot], s = bt[6 * 128 + slot];
  const float* par = bt + 9 * 128 + slot;      // shape parameter k: par[k * 128]
  const float r0 = p[0] - bt[7 * 128 + slot], r1 = p[1] - bt[8 * 128 + slot];
  const float si = -s;                         // the inverse rotation
  const float q[2] = {c * r0 - si * r1, si * r0 + c * r1};
  float proj[2];
  bool ins;
  switch ((shapes >> (2 * slot)) & 3u) {
    case SHAPE_BALL: {
      const float r = par[0];
      const float n = sqrtf(q[0] * q[0] + q[1] * q[1]);
      const bool away = n > 1e-12f;            // off the centre
      const float inv = away ? 1.0f / fmaxf(n, 1e-30f) : 0.0f;
      proj[0] = away ? q[0] * inv * r : r;     // the centre projects along +x
      proj[1] = away ? q[1] * inv * r : 0.0f;
      ins = n < r;
      break;
    }
    case SHAPE_CAPSULE: {                      // axis along local y, [-hh, hh]
      const float hh = par[0], r = par[128];
      const float cy = fminf(fmaxf(q[1], -hh), hh);
      const float d[2] = {q[0], q[1] - cy};
      const float n = sqrtf(d[0] * d[0] + d[1] * d[1]);
      const bool away = n > 1e-12f;            // off the axis
      const float inv = away ? 1.0f / fmaxf(n, 1e-30f) : 0.0f;
      proj[0] = 0.0f + (away ? d[0] * inv : 1.0f) * r;   // on the axis: along +x
      proj[1] = cy + (away ? d[1] * inv : 0.0f) * r;
      ins = n < r;
      break;
    }
    case SHAPE_HALFSPACE:                      // boundary y = 0, inside y < 0
      proj[0] = q[0];
      proj[1] = 0.0f;
      ins = q[1] < 0.0f;
      break;
    default: {                                 // cuboid, half-extents par[0..1]
      const float he[2] = {par[0], par[128]};
      ins = fabsf(q[0]) < he[0] && fabsf(q[1]) < he[1];
      const float gaps[2] = {he[0] - fabsf(q[0]), he[1] - fabsf(q[1])};
      const float min_gap = fminf(gaps[0], gaps[1]);
      bool snapped = false;
      for (int a = 0; a < 2; ++a) {
        const float sgn = q[a] >= 0.0f ? 1.0f : -1.0f;
        const bool is_min = gaps[a] == min_gap && !snapped;
        snapped = snapped || is_min;
        const float clamped = fminf(fmaxf(q[a], -he[a]), he[a]);
        proj[a] = (ins && is_min) ? sgn * he[a] : clamped;
      }
    }
  }
  const float dl0 = proj[0] - q[0], dl1 = proj[1] - q[1];
  const float dw0 = c * dl0 - s * dl1, dw1 = s * dl0 + c * dl1;
  *inside = ins;
  *within = ins || (fabsf(dw0) <= cap && fabsf(dw1) <= cap);
  *dist = sqrtf(dw0 * dw0 + dw1 * dw1);
}

// Node CDF of colliders 0..nc-1 at xw, in slot order (transfer2d.
// window_node_cdf, the chan-free mode): strictly closer wins; BIG, 0, -1
// where no collider is within reach.
__device__ void window_node_cdf2(const float* bt, int nc, unsigned shapes,
                                 const float xw[2], float cap, uint32_t* naff,
                                 float* closest, float* dist) {
  float d_dist = BIG, d_cl = -1.0f;
  uint32_t d_aff = 0u;
  for (int s = 0; s < nc; ++s) {
    bool within, inside;
    float d;
    collider_cdf2(bt, s, shapes, xw, cap, &within, &inside, &d);
    if (within && d < d_dist) { d_cl = (float)s; d_dist = d; }
    if (within) d_aff |= inside ? ((1u << (16 + s)) | (1u << s)) : (1u << s);
  }
  *naff = d_aff;
  *closest = d_cl;
  *dist = d_dist;
}

// Velocity at xw of body `closest` from the 2D body table (rows 0-1 COM, 2-3
// linvel, 4 scalar angvel); zero when closest < 0.
__device__ void node_body_velocity2(float closest, const float xw[2],
                                    const float* bt, int nc, float bv[2]) {
  bv[0] = bv[1] = 0.0f;
  for (int b = 0; b < nc; ++b) {
    if (closest != (float)b) continue;
    float r0 = xw[0] - bt[b], r1 = xw[1] - bt[128 + b];
    float ang = bt[4 * 128 + b];
    bv[0] = bt[2 * 128 + b] - ang * r1;
    bv[1] = bt[3 * 128 + b] + ang * r0;
  }
}

// CPIC ghost velocity of particle velocity vp against body velocity bv.
__device__ void ghost_velocity2(const float vp[2], const float bv[2],
                                const float nrm[2], float g[2]) {
  float u0 = vp[0] - bv[0], u1 = vp[1] - bv[1];
  float nv = u0 * nrm[0] + u1 * nrm[1];
  float t0 = u0 - nrm[0] * nv, t1 = u1 - nrm[1] * nv;
  float tl = sqrtf(t0 * t0 + t1 * t1);
  float inv_tl = tl > 1e-8f ? nr_recip(fmaxf(tl, 1e-30f)) : 0.0f;
  float scale = fmaxf(tl + FRICTION * nv, 0.0f) * inv_tl;
  bool sliding = nv < 0.0f;
  g[0] = bv[0] + (sliding ? t0 * scale : u0);
  g[1] = bv[1] + (sliding ? t1 * scale : u1);
}

// Quadratic B-spline weights wa[axis][offset] of a particle and the base
// cell of its 3 x 3 stencil relative to the block origin bc.  Stencil node
// (ox, oy) is window node (bl[0] + ox) * 10 + bl[1] + oy with weight
// wa[0][ox] * wa[1][oy] when it lies in the window; a node outside it (past
// the high edge at an exact half-cell tie, below the low edge when p * (1/h)
// rounds below the p / h of the sort key) is dropped, as the TPU kernels'
// window weight rows drop it.
__device__ void stencil_axes2(const float p[2], const int bc[2], float inv_h,
                              float wa[2][3], int bl[2]) {
  for (int a = 0; a < 2; ++a) {
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

__device__ __forceinline__ bool in_window(int wx, int wy) {
  return wx >= 0 && wx < WSH && wy >= 0 && wy < WSH;
}

// The stencil per axis (kernel I; the 2D twin of transfer.cuh
// stencil_axis_nodes, held against R.stencil by
// tests/test_torch_lists_order.py): offset o of axis a lies in the window
// when (unsigned)(bl[a] + o) < WSH, at node coordinate xa[a][o] =
// ((float)(bl[a] + o) + (float)bc[a]) * h, node_pos2's bits.  Node (ox, oy)
// lies in the window when both offsets do; its index is (bl[0] + ox) * WSH
// + bl[1] + oy, with no division and no 9-node array.
__device__ __forceinline__ void stencil_axis_nodes2(const int bl[2], const int bc[2],
                                                    float h, bool ok[2][3],
                                                    float xa[2][3]) {
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int o = 0; o < 3; ++o) {
      ok[a][o] = (unsigned)(bl[a] + o) < (unsigned)WSH;
      xa[a][o] = ((float)(bl[a] + o) + (float)bc[a]) * h;
    }
}

// ---- The zero tail of a 2D kernel that owns its output (kernels G and I).
// The live job slots are [0, L) (len > 0 exactly there) and their particles
// cover the lanes [0, end), end = start + len of slot L - 1, in one run
// (ops/blocked.py build_jobs: a job starts where the one before it ended,
// the first at rank 0, and a job-table overflow drops a tail of slots;
// tests/test_torch_g2p2d_gates.py holds this).  The lanes past end are
// zeroed in stripes: by the blocks of the first DEAD_PARTS dead slots (the
// other dead slots' blocks return after one load), or, with no dead slot,
// by every block after its job.
#define DEAD_PARTS 32   // dead job slots that stripe the zero tail

// Job slot j's (of length len) stripe of the tail: sets end and (part,
// parts), the stripe part of parts, and returns false when its block zeroes
// nothing.  A dead slot's block finds L with one warp ballot over the 31
// slots before its own and ends in a barrier, so every thread of the block
// calls this.
__device__ __forceinline__ bool tail_share(const int* __restrict__ jt, int maxj,
                                           int j, int len, long long* end,
                                           int* part, int* parts) {
  __shared__ int s_live;
  const int* lens = jt + maxj;
  if (len > 0) {
    if (lens[maxj - 1] == 0) return false;
    *end = (long long)jt[maxj - 1] + lens[maxj - 1];
    *part = j;
    *parts = maxj;
    return true;
  }
  // Past the first DEAD_PARTS dead slots; else L lies in
  // [j - DEAD_PARTS + 1, j].
  if (j >= DEAD_PARTS && lens[j - DEAD_PARTS] == 0) return false;
  const int tid = threadIdx.x;
  if (tid < 32) {
    int lo = max(j - DEAD_PARTS + 1, 0), hi = j;
    while (lo < hi) {
      const int step = (hi - lo + 30) / 31;     // lane 31 reaches hi
      const int k = lo + tid * step;
      const unsigned dead = __ballot_sync(0xFFFFFFFFu, k >= hi || lens[k] == 0);
      const int f = __ffs(dead) - 1;
      if (f == 0) {
        hi = lo;
      } else {
        const int nlo = lo + (f - 1) * step + 1;
        hi = min(lo + f * step, hi);
        lo = nlo;
      }
    }
    if (tid == 0) s_live = lo;
  }
  __syncthreads();
  const int live = s_live;
  *end = live > 0 ? (long long)jt[live - 1] + lens[live - 1] : 0;
  *part = j - live;
  *parts = min(maxj - live, DEAD_PARTS);
  return true;
}

// Zero rows [r0, r0 + nr) of a [., stride] matrix on the lanes [a, b), lane
// by lane, thread t of nt taking every nt-th lane: the tail past the live
// jobs (a few thousand lanes, striped over many blocks).
__device__ __forceinline__ void zero_tail(float* base, long long stride, int r0, int nr,
                                          long long a, long long b, int t, int nt) {
  for (long long lane = a + t; lane < b; lane += nt)
#pragma unroll
    for (int r = 0; r < nr; ++r) base[(r0 + r) * stride + lane] = 0.0f;
}

// Thread t of nt's first item (r, i) of an nr x n run of items, row by
// row, and its step (dr, di) to its next one: the divisions happen once.
__device__ __forceinline__ void run_start(int t, int nt, int n, int* r, int* i,
                                          int* dr, int* di) {
  *r = t / n;
  *i = t - *r * n;
  *dr = nt / n;
  *di = nt - *dr * n;
}

__device__ __forceinline__ void run_next(int n, int dr, int di, int* r, int* i) {
  *r += dr;
  *i += di;
  if (*i >= n) {
    *i -= n;
    *r += 1;
  }
}

// Zero the lanes [a, b) of rows [r0, r0 + nr) of a [., stride] matrix, all
// rows as one run of stores, thread t of nt taking every nt-th: 16-byte
// stores on the lanes whose address is 16-byte aligned (the same lanes in
// every row when stride is a multiple of 4), 4-byte ones on the at most 3
// lanes before and after them (on every lane when stride is not).
__device__ __forceinline__ void zero_rows(float* base, long long stride, int r0, int nr,
                                          long long a, long long b, int t, int nt) {
  if (a >= b) return;
  float* first = base + r0 * stride + a;
  const int n = (int)(b - a);
  const int head = (stride & 3) ? n
      : min(n, (int)(((16u - (unsigned)((uintptr_t)first & 15u)) & 15u) >> 2));
  const int nq = (n - head) >> 2, ne = n - 4 * nq;   // quads, 4-byte lanes a row
  int r, i, dr, di;
  if (nq > 0)
    for (run_start(t, nt, nq, &r, &i, &dr, &di); r < nr; run_next(nq, dr, di, &r, &i))
      reinterpret_cast<float4*>(first + r * stride + head)[i] =
          make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (ne > 0)
    for (run_start(t, nt, ne, &r, &i, &dr, &di); r < nr; run_next(ne, dr, di, &r, &i))
      first[r * stride + (i < head ? i : i + 4 * nq)] = 0.0f;
}
