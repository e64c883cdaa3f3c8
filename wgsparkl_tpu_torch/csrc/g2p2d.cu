// G2P of the 2D path with CPIC ghost velocities, one thread block per job
// slot.
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
// Bound on the H100: device memory.  A particle of an ungated job reads its
// 2 position rows (one of a gated job 8), every lane of the output is
// written once (8 rows), and each live job reads its window's grid tile
// (2 columns; 3 folded) and, gated and gathered, its node tile: ~22 MB a
// substep at 490k particles, ~7 us at 3.35 TB/s.  ~9 x 12 multiply-adds a
// particle, ~9 x 30 more in a gated job.
// Design: the window's grid velocity (folded once a node as the tile is
// loaded) goes to shared memory, and at a gated job its affinity words,
// closest bodies and body velocities too (~2.4 KB).  One thread per
// particle walks its 9 stencil nodes per axis (stencil_axis_nodes2: 3
// weights and 3 node coordinates an axis, the node index from the axes),
// unrolled, in the plain version's order, and writes its own 8 output
// lanes, so the result matches the plain version bit for bit and needs no
// atomics.  One walk a gate level, chosen once a block (g2p2d_walk<GATED>):
// an ungated job (or a scene with no collider) reads only the position
// rows, tests no compatibility and keeps no ghost sums.  One kernel has one
// register count, and the gated walk's sets it for every job (PERF.md §7).
// The kernel owns its whole output (the wrapper allocates it with
// torch.empty): each live block writes its lanes' 8 rows, and the lanes
// past the live jobs get 0 in stripes (transfer2d.cuh tail_share: the
// first DEAD_PARTS dead slots' blocks, or with no dead slot every block).
#include "transfer2d.cuh"

template <bool GATED>
__device__ __forceinline__ void g2p2d_walk(
    const float* __restrict__ pdata, long long pstride, int start, int len,
    const int bc[2], float h, float inv_h, const float2* s_v,
    const uint32_t* s_naff, const float* s_cl, const float* s_bv,
    float* __restrict__ out, long long ostride) {
  for (int i = threadIdx.x; i < len; i += NTHREADS) {
    const long long lane = (long long)start + i;
    auto row = [&](int r) { return pdata[r * pstride + lane]; };
    const float p[2] = {row(PX), row(PX + 1)};
    float vp[2] = {0.0f, 0.0f}, nrm[2] = {0.0f, 0.0f};
    uint32_t paff = 0u;
    if (GATED) {
      vp[0] = row(VX);
      vp[1] = row(VX + 1);
      nrm[0] = row(NX);
      nrm[1] = row(NX + 1);
      paff = aff_word(row(AFF), row(AFF_SPARE));
    }
    float wa[2][3], xa[2][3];
    int bl[2];
    bool ok[2][3];
    stencil_axes2(p, bc, inv_h, wa, bl);
    stencil_axis_nodes2(bl, bc, h, ok, xa);
    const int n0 = bl[0] * WSH + bl[1];
    // Row 2 + 2 i + k of the output is the moment sum w v_i x_k.
    float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float ex[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ox = 0; ox < 3; ++ox)
#pragma unroll
      for (int oy = 0; oy < 3; ++oy) {
        // A node outside the window is dropped.
        if (!(ok[0][ox] && ok[1][oy])) continue;
        const int n = n0 + ox * WSH + oy;
        const float w = wa[0][ox] * wa[1][oy];
        const float x[2] = {xa[0][ox], xa[1][oy]};
        const float2 v2 = s_v[n];
        const float v[2] = {v2.x, v2.y};
        const float wc = (!GATED || compat(s_naff[n], paff)) ? w : 0.0f;
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          acc[a] = acc[a] + wc * v[a];
#pragma unroll
          for (int k = 0; k < 2; ++k)
            acc[2 + 2 * a + k] = acc[2 + 2 * a + k] + wc * (v[a] * x[k]);
        }
        if (!GATED) continue;
        const float wi = w - wc;
        float g[2] = {vp[0], vp[1]};
        if (s_cl[n] >= 0.0f) ghost_velocity2(vp, &s_bv[2 * n], nrm, g);
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const float wg = wi * g[a];
          ex[a] = ex[a] + wg;
#pragma unroll
          for (int k = 0; k < 2; ++k) ex[2 + 2 * a + k] = ex[2 + 2 * a + k] + wg * x[k];
        }
      }
#pragma unroll
    for (int r = 0; r < 6; ++r) out[r * ostride + lane] = GATED ? acc[r] + ex[r] : acc[r];
    out[6 * ostride + lane] = 0.0f;
    out[7 * ostride + lane] = 0.0f;
  }
}

__global__ void __launch_bounds__(NTHREADS) g2p2d_kernel(
    const float* __restrict__ pdata, long long pstride,
    const float* __restrict__ ftiles, const float* __restrict__ ntiles,
    const float* __restrict__ bt, const int* __restrict__ jt, int maxj, int nc,
    unsigned shapes, int chan_free, int fold, float h, float inv_h, float cap,
    float* __restrict__ out, long long ostride) {
  __shared__ float2 s_v[WVOL];
  __shared__ float s_bv[WVOL * 2];
  __shared__ uint32_t s_naff[WVOL];
  __shared__ float s_cl[WVOL];
  const int j = blockIdx.x, tid = threadIdx.x;
  const int* lens = jt + maxj;
  // Every job-table entry at once: one load latency.
  const int len = lens[j], start = jt[j], lvl = jt[5 * maxj + j];
  const int bc[2] = {jt[2 * maxj + j], jt[3 * maxj + j]};
  long long end;
  int part, parts;
  if (len == 0) {
    if (tail_share(jt, maxj, j, len, &end, &part, &parts))
      zero_tail(out, ostride, 0, 8, end, ostride, part * NTHREADS + tid,
                parts * NTHREADS);
    return;
  }
  const bool gated = lvl > 0 && nc > 0;
  for (int n = tid; n < WVOL; n += NTHREADS) {
    const float* ft = ftiles + ((long long)j * WPAD + n) * 4;
    if (fold) {
      const float m = ft[2], vlim = bt[13 * 128 + 2];
      const float inv_m = m > 0.0f ? nr_recip(fmaxf(m, 1e-30f)) : 0.0f;
      s_v[n] = make_float2(
          fminf(fmaxf((ft[0] + m * bt[13 * 128]) * inv_m, -vlim), vlim),
          fminf(fmaxf((ft[1] + m * bt[13 * 128 + 1]) * inv_m, -vlim), vlim));
    } else {
      s_v[n] = make_float2(ft[0], ft[1]);
    }
    if (!gated) continue;
    float xw[2], dist;
    node_pos2(n, bc, h, xw);
    if (chan_free) {
      window_node_cdf2(bt, nc, shapes, xw, cap, &s_naff[n], &s_cl[n], &dist);
    } else {
      const float* t = ntiles + ((long long)j * WPAD + n) * 4;
      s_naff[n] = aff_word(t[0], t[1]);
      s_cl[n] = t[2];
    }
    node_body_velocity2(s_cl[n], xw, bt, nc, &s_bv[2 * n]);
  }
  __syncthreads();
  if (gated)
    g2p2d_walk<true>(pdata, pstride, start, len, bc, h, inv_h, s_v, s_naff, s_cl,
                     s_bv, out, ostride);
  else
    g2p2d_walk<false>(pdata, pstride, start, len, bc, h, inv_h, s_v, s_naff, s_cl,
                      s_bv, out, ostride);
  // No dead slot (every slot live, or the table overflowed): every block
  // stripes the lanes past the last job.
  if (tail_share(jt, maxj, j, len, &end, &part, &parts))
    zero_tail(out, ostride, 0, 8, end, ostride, part * NTHREADS + tid,
              parts * NTHREADS);
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
