// G2P with CPIC ghost velocities, one thread block per job (kernel B).
//
// Replaces: wgsparkl_tpu/ops/pallas_transfer.py `_g2p_kernel` (launched by
// `g2p_rows`): per job, each particle gathers the PIC velocity and the
// velocity moment sum w v x^T from the job's window through the
// compatibility-masked weights; incompatible nodes give the particle's ghost
// velocity instead (gate level 1: the per-particle static chain,
// `_ghost_static`; level 2: the pairwise ghost against the node's closest
// body, `_ghost_velocity`).  The window node CDF is kernel A's
// (transfer.cuh window_node_cdf): gathered channels merged with the moving
// colliders, or in chan-free mode every collider evaluated at the window
// nodes with no tile read (pallas_transfer.py:868-888).  With `fold` the
// grid tiles hold raw momentum (cols 0-2) and mass (col 3), and the kernel
// does the grid update itself (pallas_transfer.py:767-787): v = clip((mom +
// m g dt) / m, -vlim, vlim) with the Newton-refined reciprocal, g dt and
// vlim from body-table row 24, once a node as the tile is loaded.
// Bound on the H100: instruction issue.  Device traffic is small (3 rows in
// per particle of an ungated job, 11 in a gated one, 12 out: ~0.1 GB a
// substep at 1M particles, ~0.03 ms); the arithmetic is ~27 x 33 f32
// operations per particle (~27 x 40 more in gated jobs), ~30M warp
// instructions a substep, and everything else a thread issues is overhead.
// Design: the window's grid velocity and CDF channels go to shared memory
// (~13 KB at by = 8), filled once a node (the fold and the window node CDF
// there); one thread per particle walks its 27 stencil nodes in stencil
// order (ox slowest, oz fastest) and writes its own 12 output lanes, so the
// result is deterministic and needs no atomics.  The walk is per axis
// (transfer.cuh stencil_axis_nodes): three validity bits and three node
// coordinates an axis and the node index formed from the axes, so no node
// position is recovered from a window index (four run-time integer
// divisions a node) and no 27-node stencil array is formed (it would live
// in local memory); the 3 x 3 x 3 loop is unrolled so that weights,
// coordinates and sums stay in registers (103, no stack frame: two blocks
// an SM).  The job's gate level picks one of three walks once per block
// (g2p_walk<LVL>): an ungated job reads only the particle's position, tests
// no compatibility and keeps no ghost sums.  Only lanes [start, start +
// len) are written (no dependence on block order, unlike the TPU's
// sequential-grid handoff).
#include "transfer.cuh"

__device__ void ghost_static(const float vp[3], const float nrm[3], float rel[3]) {
  float nv = vp[0] * nrm[0] + vp[1] * nrm[1] + vp[2] * nrm[2];
  float tang[3];
  for (int i = 0; i < 3; ++i) tang[i] = vp[i] - nrm[i] * nv;
  float tl = sqrtf(tang[0] * tang[0] + tang[1] * tang[1] + tang[2] * tang[2]);
  float inv_tl = tl > 1e-8f ? nr_recip(fmaxf(tl, 1e-30f)) : 0.0f;
  float scale = fmaxf(tl + FRICTION * nv, 0.0f) * inv_tl;
  for (int i = 0; i < 3; ++i) rel[i] = nv < 0.0f ? tang[i] * scale : vp[i];
}

// Gate levels of a job's walk: 0 ungated (or no collider), 1 the static
// chain, 2 the pairwise ghost (gate level >= 2).
template <int LVL>
__device__ __forceinline__ void g2p_walk(
    const float* __restrict__ pdata, long long pstride, int start, int len,
    const int bc[3], int wsh1, int wsh2, float h, float inv_h, const float* s_v,
    const uint32_t* s_naff, const float* s_cl, const float* s_bv,
    float* __restrict__ out, long long ostride) {
  for (int i = threadIdx.x; i < len; i += NTHREADS) {
    const long long lane = (long long)start + i;
    auto row = [&](int r) { return pdata[r * pstride + lane]; };
    const float p[3] = {row(PX), row(PX + 1), row(PX + 2)};
    float vp[3] = {0.0f, 0.0f, 0.0f}, nrm[3] = {0.0f, 0.0f, 0.0f};
    uint32_t paff = 0u;
    if (LVL > 0) {
      for (int k = 0; k < 3; ++k) {
        vp[k] = row(VX + k);
        nrm[k] = row(NX + k);
      }
      paff = aff_word(row(AFF), row(AFF_SPARE));
    }
    float wa[3][3], xa[3][3];
    int bl[3];
    bool ok[3][3];
    stencil_axes(p, bc, inv_h, wa, bl);
    stencil_axis_nodes(bl, bc, wsh1, wsh2, h, ok, xa);
    const int sx = wsh1 * wsh2, n0 = (bl[0] * wsh1 + bl[1]) * wsh2 + bl[2];
    float acc[12], ex[12];
    for (int r = 0; r < 12; ++r) { acc[r] = 0.0f; ex[r] = 0.0f; }
    float dib[4] = {0.f, 0.f, 0.f, 0.f}, din[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ox = 0; ox < 3; ++ox)
#pragma unroll
      for (int oy = 0; oy < 3; ++oy)
#pragma unroll
        for (int oz = 0; oz < 3; ++oz) {
          // A node outside the window is dropped.
          if (!(ok[0][ox] && ok[1][oy] && ok[2][oz])) continue;
          const int n = n0 + ox * sx + oy * wsh2 + oz;
          const float w = (wa[0][ox] * wa[1][oy]) * wa[2][oz];
          const float x[3] = {xa[0][ox], xa[1][oy], xa[2][oz]};
          const float* v = &s_v[n * 3];
          const float wc = (LVL == 0 || compat(s_naff[n], paff)) ? w : 0.0f;
          for (int a = 0; a < 3; ++a) {
            acc[a] = acc[a] + wc * v[a];
            for (int k = 0; k < 3; ++k)
              acc[3 + 3 * a + k] = acc[3 + 3 * a + k] + wc * (v[a] * x[k]);
          }
          if (LVL == 0) continue;
          const float wi = w - wc;
          const bool hb = s_cl[n] >= 0.0f;
          if (LVL == 1) {
            const float wib = wi * (hb ? 1.0f : 0.0f);
            const float win = wi - wib;
            dib[0] = dib[0] + wib;
            din[0] = din[0] + win;
            for (int k = 0; k < 3; ++k) {
              dib[1 + k] = dib[1 + k] + x[k] * wib;
              din[1 + k] = din[1 + k] + x[k] * win;
            }
          } else {
            float g[3];
            if (hb) ghost_velocity(vp, &s_bv[n * 3], nrm, g);
            else { g[0] = vp[0]; g[1] = vp[1]; g[2] = vp[2]; }
            for (int a = 0; a < 3; ++a) {
              const float wg = wi * g[a];
              ex[a] = ex[a] + wg;
              for (int k = 0; k < 3; ++k) ex[3 + 3 * a + k] = ex[3 + 3 * a + k] + x[k] * wg;
            }
          }
        }
    if (LVL == 1) {
      float rel[3];
      ghost_static(vp, nrm, rel);
      for (int a = 0; a < 3; ++a) {
        ex[a] = dib[0] * rel[a] + din[0] * vp[a];
        for (int k = 0; k < 3; ++k)
          ex[3 + 3 * a + k] = dib[1 + k] * rel[a] + din[1 + k] * vp[a];
      }
    }
    for (int r = 0; r < 12; ++r)
      out[r * ostride + lane] = LVL > 0 ? acc[r] + ex[r] : acc[r];
  }
}

__global__ void __launch_bounds__(NTHREADS) g2p_kernel(
    const float* __restrict__ pdata, long long pstride,
    const float* __restrict__ ftiles, const float* __restrict__ ntiles,
    const float* __restrict__ bt, const int* __restrict__ jt, int maxj,
    int wsh1, int wsh2, int wvol, int wpad, int nc, unsigned moving,
    unsigned statics, unsigned shapes, int chan_free, int fold, float h,
    float inv_h, float cap, float* __restrict__ out, long long ostride) {
  __shared__ float s_v[WV_MAX * 3], s_bv[WV_MAX * 3];
  __shared__ uint32_t s_naff[WV_MAX];
  __shared__ float s_cl[WV_MAX];
  const int j = blockIdx.x, tid = threadIdx.x;
  const int start = jt[j], len = jt[maxj + j], lvl = jt[5 * maxj + j];
  if (len == 0) return;
  const int bc[3] = {jt[2 * maxj + j], jt[3 * maxj + j], jt[4 * maxj + j]};
  for (int n = tid; n < wvol; n += NTHREADS) {
    const float* ft = ftiles + ((long long)j * wpad + n) * 4;
    if (fold) {
      const float m = ft[3], vlim = bt[24 * 128 + 3];
      const float inv_m = m > 0.0f ? nr_recip(fmaxf(m, 1e-30f)) : 0.0f;
      for (int k = 0; k < 3; ++k)
        s_v[n * 3 + k] =
            fminf(fmaxf((ft[k] + m * bt[24 * 128 + k]) * inv_m, -vlim), vlim);
    } else {
      for (int k = 0; k < 3; ++k) s_v[n * 3 + k] = ft[k];
    }
    for (int k = 0; k < 3; ++k) s_bv[n * 3 + k] = 0.0f;
    s_naff[n] = 0u;
    s_cl[n] = -1.0f;
    if (lvl >= 1 && nc > 0) {
      float xw[3], dist;
      node_pos(n, wsh1, wsh2, bc, h, xw);
      window_node_cdf(chan_free ? nullptr : ntiles + ((long long)j * wpad + n) * 4,
                      bt, lvl, moving, statics, shapes, xw, cap, &s_naff[n],
                      &s_cl[n], &dist);
      if (lvl >= 2) node_body_velocity(s_cl[n], xw, bt, nc, &s_bv[n * 3]);
    }
  }
  __syncthreads();

  const int gate = (lvl >= 1 && nc > 0) ? min(lvl, 2) : 0;
  if (gate == 0)
    g2p_walk<0>(pdata, pstride, start, len, bc, wsh1, wsh2, h, inv_h, s_v, s_naff,
                s_cl, s_bv, out, ostride);
  else if (gate == 1)
    g2p_walk<1>(pdata, pstride, start, len, bc, wsh1, wsh2, h, inv_h, s_v, s_naff,
                s_cl, s_bv, out, ostride);
  else
    g2p_walk<2>(pdata, pstride, start, len, bc, wsh1, wsh2, h, inv_h, s_v, s_naff,
                s_cl, s_bv, out, ostride);
}

extern "C" int g2p_cuda(const float* pdata, long long pstride, const float* ftiles,
                        const float* ntiles, const float* bt, const int* jt,
                        long long maxj, long long by, long long nc,
                        long long moving, long long statics, long long shapes,
                        long long chan_free, long long fold, float h,
                        float inv_h, float cap, float* out, long long ostride,
                        cudaStream_t stream) {
  int wsh1 = (int)by + 2, wsh2 = 6;
  int wvol = 6 * wsh1 * wsh2, wpad = (wvol + 7) / 8 * 8;
  if (maxj > 0)
    g2p_kernel<<<(unsigned)maxj, NTHREADS, 0, stream>>>(
        pdata, pstride, ftiles, ntiles, bt, jt, (int)maxj, wsh1, wsh2, wvol, wpad,
        (int)nc, (unsigned)moving, (unsigned)statics, (unsigned)shapes,
        (int)chan_free, (int)fold, h, inv_h, cap, out, ostride);
  return (int)cudaGetLastError();
}
