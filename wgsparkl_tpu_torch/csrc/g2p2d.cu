// G2P of the 2D path with CPIC ghost velocities, one thread block per job.
//
// Replaces: wgsparkl_tpu/ops/pallas_transfer2d.py `_g2p_kernel` (launched by
// `g2p_rows`): per job, each particle gathers the PIC velocity and the
// velocity moment sum w v x^T from its 3 x 3 stencil in the job's window
// through the compatibility-masked weights; at a gated job the incompatible
// nodes give the particle's ghost velocity against the node's closest body
// instead (`_ghost_velocity`), or its own velocity where the node has no
// body.  The window node CDF is the gathered channels, or in chan-free mode
// every collider evaluated at the window nodes of a gated job
// (pallas_transfer2d.py:504-507; transfer2d.cuh window_node_cdf2), with no
// tile read.  With `fold` the grid tiles hold raw momentum (cols 0-1) and
// mass (col 2), and the kernel does the grid update itself
// (pallas_transfer2d.py:446-463): v = clip((mom + m g dt) / m, -vlim, vlim)
// with the Newton-refined reciprocal, g dt and vlim from body-table row 13.
// Bound on the H100: device memory, lightly.  Per particle it reads 8 rows
// and writes 6 (~27 MB per substep at 490k particles, ~8 us at 3.35 TB/s),
// plus the window tiles (~1.7 KB per job); ~9 x 12 multiply-adds, ~9 x 30
// more in gated jobs.
// Design: the window's grid velocity (folded once a node as the tile is
// loaded), affinity words, closest bodies and body velocities go to shared
// memory (~2 KB); one thread per particle walks
// its 9 stencil nodes in the plain version's order and writes its own 6
// output lanes, so the result matches the plain version bit for bit and
// needs no atomics.  Only lanes [start, start + len) are written (the
// wrapper zeroes the rest).
#include "transfer2d.cuh"

__global__ void __launch_bounds__(NTHREADS) g2p2d_kernel(
    const float* __restrict__ pdata, long long pstride,
    const float* __restrict__ ftiles, const float* __restrict__ ntiles,
    const float* __restrict__ bt, const int* __restrict__ jt, int maxj, int nc,
    unsigned shapes, int chan_free, int fold, float h, float inv_h, float cap,
    float* __restrict__ out, long long ostride) {
  __shared__ float s_v[WVOL * 2], s_bv[WVOL * 2];
  __shared__ uint32_t s_naff[WVOL];
  __shared__ float s_cl[WVOL];
  const int j = blockIdx.x, tid = threadIdx.x;
  const int start = jt[j], len = jt[maxj + j], lvl = jt[5 * maxj + j];
  if (len == 0) return;
  const int bc[2] = {jt[2 * maxj + j], jt[3 * maxj + j]};
  const bool gated = lvl > 0;
  for (int n = tid; n < WVOL; n += NTHREADS) {
    const float* ft = ftiles + ((long long)j * WPAD + n) * 4;
    if (fold) {
      const float m = ft[2], vlim = bt[13 * 128 + 2];
      const float inv_m = m > 0.0f ? nr_recip(fmaxf(m, 1e-30f)) : 0.0f;
      for (int k = 0; k < 2; ++k)
        s_v[2 * n + k] =
            fminf(fmaxf((ft[k] + m * bt[13 * 128 + k]) * inv_m, -vlim), vlim);
    } else {
      s_v[2 * n] = ft[0];
      s_v[2 * n + 1] = ft[1];
    }
    float xw[2], dist;
    node_pos2(n, bc, h, xw);
    s_naff[n] = 0u;
    s_cl[n] = -1.0f;
    if (chan_free) {
      // Only a gated job reads its window's CDF.
      if (gated) window_node_cdf2(bt, nc, shapes, xw, cap, &s_naff[n], &s_cl[n], &dist);
    } else if (nc > 0) {
      // The gathered tile (with no collider there is none to read: the
      // caller may pass just one).
      const float* t = ntiles + ((long long)j * WPAD + n) * 4;
      s_naff[n] = aff_word(t[0], t[1]);
      s_cl[n] = t[2];
    }
    node_body_velocity2(s_cl[n], xw, bt, nc, &s_bv[2 * n]);
  }
  __syncthreads();

  for (int i = tid; i < len; i += NTHREADS) {
    const long long lane = (long long)start + i;
    auto row = [&](int r) { return pdata[r * pstride + lane]; };
    const float p[2] = {row(PX), row(PX + 1)};
    const float vp[2] = {row(VX), row(VX + 1)};
    const float nrm[2] = {row(NX), row(NX + 1)};
    const uint32_t paff = aff_word(row(AFF), row(AFF_SPARE));
    float wa[2][3];
    int bl[2];
    stencil_axes2(p, bc, inv_h, wa, bl);
    // Row 2 + 2 i + k of the output is the moment sum w v_i x_k.
    float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float ex[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int ox = 0; ox < 3; ++ox)
      for (int oy = 0; oy < 3; ++oy) {
        if (!in_window(bl[0] + ox, bl[1] + oy)) continue;
        const int n = (bl[0] + ox) * WSH + bl[1] + oy;
        float x[2];
        node_pos2(n, bc, h, x);
        const float w = wa[0][ox] * wa[1][oy];
        const float wc = (!gated || compat(s_naff[n], paff)) ? w : 0.0f;
        const float* v = &s_v[2 * n];
        for (int a = 0; a < 2; ++a) {
          acc[a] = acc[a] + wc * v[a];
          for (int k = 0; k < 2; ++k)
            acc[2 + 2 * a + k] = acc[2 + 2 * a + k] + wc * (v[a] * x[k]);
        }
        if (!gated || nc == 0) continue;
        const float wi = w - wc;
        float g[2] = {vp[0], vp[1]};
        if (s_cl[n] >= 0.0f) ghost_velocity2(vp, &s_bv[2 * n], nrm, g);
        for (int a = 0; a < 2; ++a) {
          const float wg = wi * g[a];
          ex[a] = ex[a] + wg;
          for (int k = 0; k < 2; ++k) ex[2 + 2 * a + k] = ex[2 + 2 * a + k] + wg * x[k];
        }
      }
    const bool extra = gated && nc > 0;
    for (int r = 0; r < 6; ++r)
      out[r * ostride + lane] = extra ? acc[r] + ex[r] : acc[r];
  }
}

extern "C" int g2p2d_cuda(const float* pdata, long long pstride,
                          const float* ftiles, const float* ntiles,
                          const float* bt, const int* jt, long long maxj,
                          long long nc, long long shapes, long long chan_free,
                          long long fold, float h, float inv_h, float cap,
                          float* out, long long ostride, cudaStream_t stream) {
  if (maxj > 0)
    g2p2d_kernel<<<(unsigned)maxj, NTHREADS, 0, stream>>>(
        pdata, pstride, ftiles, ntiles, bt, jt, (int)maxj, (int)nc,
        (unsigned)shapes, (int)chan_free, (int)fold, h, inv_h, cap, out, ostride);
  return (int)cudaGetLastError();
}
