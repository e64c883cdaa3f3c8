// Device helpers shared by the 3D transfer kernels (p2g_cdf.cu, p2g.cu,
// g2p.cu) and the P2G ablation probe (p2g_ablation.cu).
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

// Analytic collider `slot` of the body table at world point p, of type
// (shapes >> 2 slot) & 3 (cdf_channel.collider_cdf and its projections):
// within (affinity reach), inside, world distance to the boundary.
__device__ void collider_cdf(const float* bt, int slot, unsigned shapes,
                             const float p[3], float cap, bool* within,
                             bool* inside, float* dist) {
  float qw = bt[9 * 128 + slot], qx = bt[10 * 128 + slot];
  float qy = bt[11 * 128 + slot], qz = bt[12 * 128 + slot];
  const float* par = bt + 16 * 128 + slot;     // shape parameter k: par[k * 128]
  float rel[3], q[3];
  for (int a = 0; a < 3; ++a) rel[a] = p[a] - bt[(13 + a) * 128 + slot];
  quat_rot(qw, -qx, -qy, -qz, rel, q);
  float proj[3];
  bool ins;
  switch ((shapes >> (2 * slot)) & 3u) {
    case SHAPE_BALL: {
      const float r = par[0];
      const float n = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2]);
      const bool away = n > 1e-12f;   // off the centre
      const float inv = away ? 1.0f / fmaxf(n, 1e-30f) : 0.0f;
      for (int a = 0; a < 3; ++a) proj[a] = away ? q[a] * inv * r : 0.0f;
      if (!away) proj[0] = r;              // the centre projects along +x
      ins = n < r;
      break;
    }
    case SHAPE_CAPSULE: {                  // axis along local y, [-hh, hh]
      const float hh = par[0], r = par[128];
      const float cy = fminf(fmaxf(q[1], -hh), hh);
      const float base[3] = {0.0f, cy, 0.0f};
      float d[3];
      for (int a = 0; a < 3; ++a) d[a] = q[a] - base[a];
      const float n = sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
      const bool away = n > 1e-12f;   // off the axis
      const float inv = away ? 1.0f / fmaxf(n, 1e-30f) : 0.0f;
      for (int a = 0; a < 3; ++a)          // on the axis: along +x
        proj[a] = base[a] + (away ? d[a] * inv : (a == 0 ? 1.0f : 0.0f)) * r;
      ins = n < r;
      break;
    }
    case SHAPE_HALFSPACE:                  // boundary y = 0, inside y < 0
      proj[0] = q[0];
      proj[1] = 0.0f;
      proj[2] = q[2];
      ins = q[1] < 0.0f;
      break;
    default: {                             // cuboid, half-extents par[0..2]
      float he[3], gaps[3];
      for (int a = 0; a < 3; ++a) he[a] = par[a * 128];
      ins = fabsf(q[0]) < he[0] && fabsf(q[1]) < he[1] && fabsf(q[2]) < he[2];
      for (int a = 0; a < 3; ++a) gaps[a] = he[a] - fabsf(q[a]);
      float min_gap = fminf(fminf(gaps[0], gaps[1]), gaps[2]);
      bool snapped = false;
      for (int a = 0; a < 3; ++a) {
        float sgn = q[a] >= 0.0f ? 1.0f : -1.0f;
        bool is_min = gaps[a] == min_gap && !snapped;
        snapped = snapped || is_min;
        float clamped = fminf(fmaxf(q[a], -he[a]), he[a]);
        proj[a] = (ins && is_min) ? sgn * he[a] : clamped;
      }
    }
  }
  float dl[3], dw[3];
  for (int a = 0; a < 3; ++a) dl[a] = proj[a] - q[a];
  quat_rot(qw, qx, qy, qz, dl, dw);
  bool box = fabsf(dw[0]) <= cap && fabsf(dw[1]) <= cap && fabsf(dw[2]) <= cap;
  *within = ins || box;
  *inside = ins;
  *dist = sqrtf(dw[0] * dw[0] + dw[1] * dw[1] + dw[2] * dw[2]);
}

// Node CDF of the colliders of slot mask `set`, in index order, at xw
// (rows.moving_node_cdf): strictly closer wins; BIG, 0, -1 where none.
__device__ void colliders_cdf(const float* bt, unsigned set, unsigned shapes,
                              const float xw[3], float cap, uint32_t* naff,
                              float* closest, float* dist) {
  float d_dist = BIG, d_cl = -1.0f;
  uint32_t d_aff = 0;
  for (int s = 0; s < 16; ++s) {
    if (!((set >> s) & 1u)) continue;
    bool within, inside;
    float d;
    collider_cdf(bt, s, shapes, xw, cap, &within, &inside, &d);
    if (within && d < d_dist) { d_cl = (float)s; d_dist = d; }
    if (within) d_aff |= inside ? ((1u << (16 + s)) | (1u << s)) : (1u << s);
  }
  *naff = d_aff;
  *closest = d_cl;
  *dist = d_dist;
}

// World position of window node n of a job whose block origin cell is bc.
__device__ __forceinline__ void node_pos(int n, int wsh1, int wsh2,
                                         const int bc[3], float h, float xw[3]) {
  int wx = n / (wsh1 * wsh2), wy = (n / wsh2) % wsh1, wz = n % wsh2;
  xw[0] = ((float)wx + (float)bc[0]) * h;
  xw[1] = ((float)wy + (float)bc[1]) * h;
  xw[2] = ((float)wz + (float)bc[2]) * h;
}

// Window node CDF at gate level lvl >= 1 (rows.window_cdf).  Gathered
// (tile = the node's [aff lo, aff hi, closest, dist] channels): the
// channels, merged at level >= 2 with the `moving` colliders (strictly
// closer wins, lower index on ties).  Chan-free (tile = nullptr, not read):
// the `statics` colliders at level 1, statics | moving at level >= 2.
__device__ void window_node_cdf(const float* tile, const float* bt, int lvl,
                                unsigned moving, unsigned statics,
                                unsigned shapes, const float xw[3], float cap,
                                uint32_t* naff, float* closest, float* dist) {
  if (tile == nullptr) {
    colliders_cdf(bt, lvl >= 2 ? (statics | moving) : statics, shapes, xw, cap,
                  naff, closest, dist);
    return;
  }
  uint32_t a = aff_word(tile[0], tile[1]);
  float cl = tile[2], di = tile[3];
  if (lvl >= 2 && moving) {
    float d_dist, d_cl;
    uint32_t d_aff;
    colliders_cdf(bt, moving, shapes, xw, cap, &d_aff, &d_cl, &d_dist);
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

// The stencil of the axis weights and base cell that stencil_axes gives.
__device__ void stencil_from_axes(const float wa[3][3], const int bl[3], int wsh1,
                                  int wsh2, Stencil* s) {
  const int wsh[3] = {6, wsh1, wsh2};
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

__device__ void stencil(const float p[3], const int bc[3], float inv_h,
                        int wsh1, int wsh2, Stencil* s) {
  float wa[3][3];
  int bl[3];
  stencil_axes(p, bc, inv_h, wa, bl);
  stencil_from_axes(wa, bl, wsh1, wsh2, s);
}

// The stencil per axis (kernel B; tests/test_torch_lists_order.py holds
// its rule against the plain R.stencil),
// for the base cell bl that stencil_axes gives: offset o of axis a lies in
// the window when (unsigned)(bl[a] + o) < the window's extent, at node
// coordinate xa[a][o] = ((float)(bl[a] + o) + (float)bc[a]) * h, bit for
// bit node_pos's coordinate of any node there (both terms are integers f32
// holds exactly).  Node (ox, oy, oz) lies in the window when its three
// offsets do; its index is ((bl[0] + ox) * wsh1 + bl[1] + oy) * wsh2 +
// bl[2] + oz and its weight stencil_from_axes's, so no division is needed
// and no 27-node array is formed.
__device__ __forceinline__ void stencil_axis_nodes(const int bl[3], const int bc[3],
                                                   int wsh1, int wsh2, float h,
                                                   bool ok[3][3], float xa[3][3]) {
  const unsigned wsh[3] = {6u, (unsigned)wsh1, (unsigned)wsh2};
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int o = 0; o < 3; ++o) {
      ok[a][o] = (unsigned)(bl[a] + o) < wsh[a];
      xa[a][o] = ((float)(bl[a] + o) + (float)bc[a]) * h;
    }
}

// ---- The `lists` P2G core: per-node particle lists (kernels A and F, the probe) ----
//
// A chunk of up to LIST_CHUNK particles of a job is bucketed by its stencil
// base cell relative to the block, bl + 1 per axis: that is the window's own
// index space (bl runs over [-1, bsh], the window over [0, bsh + 2)), so
// bucket b is the window index of bl + 1.  The block sort keeps bl there
// (its round(p / h) and the stencil's floor(p * (1/h) + 1/2) differ by at
// most one cell); bucket wvol, which no node walks, bounds the index of a
// particle that lies outside.  A stable
// counting sort gives every particle its position in bucket order; each
// window node then walks its 27 stencil offsets in stencil order (oz
// fastest) and, within each, the particles of bucket node - offset + 1 in
// particle order: ~27 x 8 pairs per node at 8 particles a cell instead of a
// membership test against every particle of the chunk.
#define LIST_CHUNK 1024
#define LIST_THREADS 384    // one thread per window node (wvol <= 360)

struct ListScratch {
  unsigned short key[LIST_CHUNK];    // bucket of particle i of the chunk
  unsigned short pos[LIST_CHUNK];    // its position in bucket order
  int start[WV_MAX + 2];             // bucket b holds positions [start[b], start[b + 1])
};

// The P2G record of a particle, field-major with stride rs in a chunk's
// shared memory: axis weights wa[a][o] at REC_W + 3a + o, and at REC_F the
// 13 features m v - A x_p (3), m, and A[a][k] at 4 + 3k + a.  A kernel's own
// fields follow from REC_P2G.
#define REC_W 0
#define REC_F 9
#define REC_P2G 22

// The 16 P2G rows of one lane: position, velocity, mass, affine rows.
__device__ __forceinline__ void load_rows(const float* __restrict__ pdata,
                                          long long pstride, long long lane,
                                          float r16[16]) {
  for (int f = 0; f < 16; ++f) r16[f] = pdata[f * pstride + lane];
}

// Writes the record of the particle with rows r16 at r and gives its axis
// weights and base cell (stencil_axes) to the caller.
__device__ __forceinline__ void p2g_record(const float r16[16], const int bc[3],
                                           float inv_h, float* r, int rs,
                                           float wa[3][3], int bl[3]) {
  const float p[3] = {r16[PX], r16[PX + 1], r16[PX + 2]};
  stencil_axes(p, bc, inv_h, wa, bl);
  for (int k = 0; k < 9; ++k) r[(REC_W + k) * rs] = wa[k / 3][k % 3];
  const float mass = r16[PM];
  for (int k = 0; k < 3; ++k) {
    const float* A = r16 + A0 + 3 * k;
    const float ap = A[0] * p[0] + A[1] * p[1] + A[2] * p[2];
    r[(REC_F + k) * rs] = mass * r16[VX + k] - ap;
  }
  r[(REC_F + 3) * rs] = mass;
  for (int k = 0; k < 3; ++k)
    for (int a = 0; a < 3; ++a) r[(REC_F + 4 + 3 * k + a) * rs] = r16[A0 + 3 * a + k];
}

// Stencil base cell of p relative to the block origin bc (as stencil_axes).
__device__ __forceinline__ void stencil_base(const float p[3], const int bc[3],
                                             float inv_h, int bl[3]) {
  for (int a = 0; a < 3; ++a) bl[a] = (int)floorf(p[a] * inv_h + 0.5f) - 1 - bc[a];
}

__device__ __forceinline__ int list_bucket(const int bl[3], int wsh1, int wsh2,
                                           int wvol) {
  const unsigned x = bl[0] + 1, y = bl[1] + 1, z = bl[2] + 1;
  return (x < 6u && y < (unsigned)wsh1 && z < (unsigned)wsh2)
             ? ((int)x * wsh1 + (int)y) * wsh2 + (int)z
             : wvol;
}

// Stable counting sort of the chunk's cnt keys (s->key, set and published by
// the caller) into s->pos and s->start; run by warp 0 alone, the caller
// synchronises the block before and after.  The fill position of a particle
// is its bucket's start plus the number of earlier particles in its bucket,
// counted by one pass over 32-particle segments in particle order (a match
// within the warp, a running count per bucket), so each bucket keeps
// particle order and no atomic decides an order.
__device__ void list_sort_warp(ListScratch* s, int cnt, int wvol) {
  const int lane = threadIdx.x & 31;
  const int nb = wvol + 1;                 // buckets, the discard bucket included
  for (int b = lane; b <= nb; b += 32) s->start[b] = 0;
  __syncwarp();
  for (int s0 = 0; s0 < cnt; s0 += 32) {
    const int i = s0 + lane;
    const bool ok = i < cnt;
    const int k = ok ? (int)s->key[i] : -1 - lane;
    const unsigned m = __match_any_sync(0xFFFFFFFFu, k);
    const int r = __popc(m & ((1u << lane) - 1u));
    const int c = ok ? s->start[k + 1] : 0;
    __syncwarp();
    if (ok) {
      s->pos[i] = (unsigned short)(c + r);
      if (r == 0) s->start[k + 1] = c + __popc(m);
    }
    __syncwarp();
  }
  // start[1..nb] hold the counts: an inclusive scan makes start[b] the
  // first position of bucket b.  Lane l sums a run of `per` buckets.
  const int per = (nb + 31) / 32;
  const int b0 = 1 + lane * per;
  int run = 0;
  for (int b = b0; b < b0 + per && b <= nb; ++b) run += s->start[b];
  int incl = run;
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (lane >= d) incl += t;
  }
  int acc = incl - run;
  for (int b = b0; b < b0 + per && b <= nb; ++b) {
    acc += s->start[b];
    s->start[b] = acc;
  }
  __syncwarp();
  for (int i = lane; i < cnt; i += 32) s->pos[i] += (unsigned short)s->start[s->key[i]];
}

// Walks the pairs of window node n in the lists order: offsets (ox, oy, oz)
// in stencil order, within each the particles of its bucket in particle
// order.  wa: the records' axis weights wa[a][o] at field 3a + o, field
// stride rs, indexed by position in bucket order.  pair(k, w) gets the
// particle's position k and the pair's weight, rounded as stencil() rounds
// it: (wa[0][ox] * wa[1][oy]) * wa[2][oz].
template <typename Pair>
__device__ __forceinline__ void list_walk(int n, int wsh1, int wsh2, const int* start,
                                          const float* wa, int rs, Pair&& pair) {
  const int nx = n / (wsh1 * wsh2), ny = (n / wsh2) % wsh1, nz = n % wsh2;
  // Not unrolled: the pair's body is inlined once.
#pragma unroll 1
  for (int ox = 0; ox < 3; ++ox) {
    const unsigned bx = (unsigned)(nx + 1 - ox);
    if (bx >= 6u) continue;
#pragma unroll 1
    for (int oy = 0; oy < 3; ++oy) {
      const unsigned by_ = (unsigned)(ny + 1 - oy);
      if (by_ >= (unsigned)wsh1) continue;
#pragma unroll 1
      for (int oz = 0; oz < 3; ++oz) {
        const unsigned bz = (unsigned)(nz + 1 - oz);
        if (bz >= (unsigned)wsh2) continue;
        const int b = ((int)bx * wsh1 + (int)by_) * wsh2 + (int)bz;
        const int e = start[b + 1];
        for (int k = start[b]; k < e; ++k) {
          const float w =
              (wa[ox * rs + k] * wa[(3 + oy) * rs + k]) * wa[(6 + oz) * rs + k];
          pair(k, w);
        }
      }
    }
  }
}

// Walks the pairs of two z-neighbour window nodes n and n + 1 (n's z index
// even; the window is 6 nodes deep in z) at once, each in its own lists
// order.  For each (ox, oy) it walks buckets z = nz + 2, nz + 1, nz, nz - 1
// once: the upper node n + 1 takes the first three (its oz = 0, 1, 2), the
// lower node n the last three (its oz = 0, 1, 2), so a record read by both
// is fetched once.  pair(k, lo, w_lo, hi, w_hi) gets the particle's
// position k and, for the lower and the upper node, whether the node takes
// it and the pair's weight, rounded as list_walk rounds it.
template <typename Pair>
__device__ __forceinline__ void list_walk_pair(int n, int wsh1, int wsh2,
                                               const int* start, const float* wa,
                                               int rs, Pair&& pair) {
  const int nx = n / (wsh1 * wsh2), ny = (n / wsh2) % wsh1, nz = n % wsh2;
#pragma unroll 1
  for (int ox = 0; ox < 3; ++ox) {
    const unsigned bx = (unsigned)(nx + 1 - ox);
    if (bx >= 6u) continue;
#pragma unroll 1
    for (int oy = 0; oy < 3; ++oy) {
      const unsigned by_ = (unsigned)(ny + 1 - oy);
      if (by_ >= (unsigned)wsh1) continue;
      const int row = ((int)bx * wsh1 + (int)by_) * wsh2;
      // Bucket nz + 2 - t is the upper node's offset oz = t, the lower's t - 1.
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const unsigned bz = (unsigned)(nz + 2 - t);
        if (bz >= (unsigned)wsh2) continue;
        const int b = row + (int)bz;
        const int e = start[b + 1];
        for (int k = start[b]; k < e; ++k) {
          const float wxy = wa[ox * rs + k] * wa[(3 + oy) * rs + k];
          const float w_hi = t <= 2 ? wxy * wa[(6 + t) * rs + k] : 0.0f;
          const float w_lo = t >= 1 ? wxy * wa[(5 + t) * rs + k] : 0.0f;
          pair(k, t >= 1, w_lo, t <= 2, w_hi);
        }
      }
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
