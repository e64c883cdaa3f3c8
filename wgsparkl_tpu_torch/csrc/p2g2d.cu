// CPIC P2G of the 2D path, one thread block per job.
//
// Replaces: wgsparkl_tpu/ops/pallas_transfer2d.py `_p2g_kernel` (launched by
// `p2g_tiles`): per job of up to `group` sorted particles of one 8 x 8 block,
// the compatibility-masked APIC scatter of momentum and mass into the job's
// 10 x 10 window tile, and at a gated job the impulse of every incompatible
// (node, particle) pair against the node's closest body, reduced per job and
// collider into linear (rows 0-1) and angular (row 2) parts.  The window
// node CDF is the gathered channels, or in chan-free mode every collider
// evaluated at the window nodes of a gated job (pallas_transfer2d.py:318-321;
// transfer2d.cuh window_node_cdf2), with no tile read.
// Bound on the H100: shared-memory traffic and instruction throughput.  Device traffic is
// small (13 rows in per particle, a 104 x 8 tile out per job: ~30 MB per
// substep at 490k particles); each window node tests every particle of its
// job for stencil membership (100 x group tests per job) and adds 9 pairs
// per particle.
// Design: the window's node channels and the 7 P2G accumulators per node
// live in shared memory (~6 KB).  Particles go in chunks of NTHREADS: one
// thread per particle leaves a 19-word record (axis weights, P2G features,
// velocity, normal, base cell, affinity) in shared memory; then one thread
// per node adds the chunk's records that reach it, in particle order.  So
// every sum has the plain version's order and the kernel is deterministic,
// with no atomics (shared-memory atomics would sum in another order on every
// run, and the Drucker-Prager return map turns that roundoff into F).  The
// per-job impulses go to imp [MAXJ, 8, 128] as in the TPU kernel; the caller
// sums them over jobs.
#include "transfer2d.cuh"

// Particle record of a chunk, field-major ([PREC][NTHREADS]): axis weights
// wa[a][o] at 3a + o, the 7 P2G features, velocity, normal, the base cell
// relative to the block (+8 per axis, 8 bits each) and the affinity word,
// both as raw bits.
#define R_W 0
#define R_F 6
#define R_V 13
#define R_N 15
#define R_BASE 17
#define R_AFF 18
#define PREC 19
#define NFEAT 7

__global__ void __launch_bounds__(NTHREADS) p2g2d_kernel(
    const float* __restrict__ pdata, long long pstride,
    const float* __restrict__ ntiles, const float* __restrict__ bt,
    const int* __restrict__ jt, int maxj, int nc, unsigned shapes, int chan_free,
    float h, float inv_h, float cap, float* __restrict__ mm,
    float* __restrict__ imp) {
  __shared__ uint32_t s_naff[WVOL];
  __shared__ float s_cl[WVOL];
  __shared__ float s_bv[WVOL * 2], s_d[WVOL * 2];
  __shared__ float s_acc[WVOL * NFEAT];
  __shared__ float s_rec[PREC * NTHREADS];
  const int j = blockIdx.x, tid = threadIdx.x;
  const int start = jt[j], len = jt[maxj + j], lvl = jt[5 * maxj + j];
  float* tile = mm + (long long)j * WPAD * 8;
  if (len == 0) {
    for (int k = tid; k < WPAD * 8; k += NTHREADS) tile[k] = 0.0f;
    return;
  }
  const bool gated = lvl > 0;
  const int bc[2] = {jt[2 * maxj + j], jt[3 * maxj + j]};
  for (int n = tid; n < WVOL; n += NTHREADS) {
    for (int f = 0; f < NFEAT; ++f) s_acc[n * NFEAT + f] = 0.0f;
    s_d[2 * n] = s_d[2 * n + 1] = 0.0f;
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

  for (int c0 = 0; c0 < len; c0 += NTHREADS) {
    const int i = c0 + tid;
    if (i < len) {
      const long long lane = (long long)start + i;
      auto row = [&](int r) { return pdata[r * pstride + lane]; };
      const float p[2] = {row(PX), row(PX + 1)};
      const float v[2] = {row(VX), row(VX + 1)};
      const float mass = row(PM);
      const float A[4] = {row(A0), row(A0 + 1), row(A0 + 2), row(A0 + 3)};
      float feat[NFEAT];
      feat[0] = mass * v[0] - (A[0] * p[0] + A[1] * p[1]);
      feat[1] = mass * v[1] - (A[2] * p[0] + A[3] * p[1]);
      feat[2] = mass;
      for (int k = 0; k < 4; ++k) feat[3 + k] = A[k];
      float wa[2][3];
      int bl[2];
      stencil_axes2(p, bc, inv_h, wa, bl);
      float* r = s_rec + tid;
      for (int k = 0; k < 6; ++k) r[(R_W + k) * NTHREADS] = wa[k / 3][k % 3];
      for (int f = 0; f < NFEAT; ++f) r[(R_F + f) * NTHREADS] = feat[f];
      for (int k = 0; k < 2; ++k) {
        r[(R_V + k) * NTHREADS] = v[k];
        r[(R_N + k) * NTHREADS] = row(NX + k);
      }
      r[R_BASE * NTHREADS] = __int_as_float(((bl[0] + 8) << 8) | (bl[1] + 8));
      r[R_AFF * NTHREADS] = __uint_as_float(aff_word(row(AFF), row(AFF_SPARE)));
    }
    __syncthreads();

    // Each node adds the chunk's particles that reach it, in particle order:
    // compatible pairs (every pair of an ungated job) into the P2G sums, the
    // incompatible pairs of a gated job into the node's impulse.
    const int cnt = min(NTHREADS, len - c0);
    for (int n = tid; n < WVOL; n += NTHREADS) {
      const int nx = n / WSH, ny = n % WSH;
      const uint32_t naff = s_naff[n];
      const bool has_body = s_cl[n] >= 0.0f;
      float acc[NFEAT], d[2] = {s_d[2 * n], s_d[2 * n + 1]};
      for (int f = 0; f < NFEAT; ++f) acc[f] = s_acc[n * NFEAT + f];
      for (int q = 0; q < cnt; ++q) {
        const float* r = s_rec + q;
        const int pb = __float_as_int(r[R_BASE * NTHREADS]);
        const unsigned dx = (unsigned)(nx - ((pb >> 8) - 8));
        const unsigned dy = (unsigned)(ny - ((pb & 255) - 8));
        if (dx > 2u || dy > 2u) continue;
        const float w = r[(R_W + dx) * NTHREADS] * r[(R_W + 3 + dy) * NTHREADS];
        if (!gated || compat(naff, __float_as_uint(r[R_AFF * NTHREADS]))) {
          for (int f = 0; f < NFEAT; ++f) acc[f] = acc[f] + w * r[(R_F + f) * NTHREADS];
        } else if (has_body) {
          const float vq[2] = {r[R_V * NTHREADS], r[(R_V + 1) * NTHREADS]};
          const float nq[2] = {r[R_N * NTHREADS], r[(R_N + 1) * NTHREADS]};
          float g[2];
          ghost_velocity2(vq, &s_bv[2 * n], nq, g);
          const float wi = w * r[(R_F + 2) * NTHREADS];
          d[0] = d[0] + wi * (vq[0] - g[0]);
          d[1] = d[1] + wi * (vq[1] - g[1]);
        }
      }
      for (int f = 0; f < NFEAT; ++f) s_acc[n * NFEAT + f] = acc[f];
      s_d[2 * n] = d[0];
      s_d[2 * n + 1] = d[1];
    }
    __syncthreads();
  }

  // Window tile: cols 0-1 momentum (sum w (m v - A p) + (sum w A) x), 2 mass.
  for (int k = tid; k < WPAD * 8; k += NTHREADS) {
    const int n = k / 8, c = k % 8;
    float val = 0.0f;
    if (n < WVOL && c < 3) {
      const float* ac = &s_acc[n * NFEAT];
      if (c == 2) {
        val = ac[2];
      } else {
        float xw[2];
        node_pos2(n, bc, h, xw);
        val = ac[c] + ac[3 + 2 * c] * xw[0] + ac[4 + 2 * c] * xw[1];
      }
    }
    tile[k] = val;
  }
  // Impulses per collider, summed over the window nodes in node order; the
  // wrapper zeroes imp, which is what ungated jobs leave.
  if (gated && tid < nc) {
    const int b = tid;
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
    for (int n = 0; n < WVOL; ++n) {
      if (s_cl[n] != (float)b) continue;
      float xw[2];
      node_pos2(n, bc, h, xw);
      const float d0 = s_d[2 * n], d1 = s_d[2 * n + 1];
      s0 = s0 + d0;
      s1 = s1 + d1;
      s2 = s2 + (d0 * xw[1] - d1 * xw[0]);
    }
    float* ij = imp + (long long)j * 8 * 128;
    ij[b] = s0;
    ij[128 + b] = s1;
    ij[256 + b] = s0 * bt[128 + b] - s1 * bt[b] - s2;
  }
}

extern "C" int p2g2d_cuda(const float* pdata, long long pstride,
                          const float* ntiles, const float* bt, const int* jt,
                          long long maxj, long long nc, long long shapes,
                          long long chan_free, float h, float inv_h, float cap,
                          float* mm, float* imp, cudaStream_t stream) {
  if (maxj > 0)
    p2g2d_kernel<<<(unsigned)maxj, NTHREADS, 0, stream>>>(
        pdata, pstride, ntiles, bt, jt, (int)maxj, (int)nc, (unsigned)shapes,
        (int)chan_free, h, inv_h, cap, mm, imp);
  return (int)cudaGetLastError();
}
