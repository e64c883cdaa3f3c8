// APIC P2G without the particle CDF, one thread block per job (kernel F).
//
// Replaces: wgsparkl_tpu/ops/pallas_transfer.py `_p2g_kernel` (launched by
// `p2g_tiles`): per job of up to `group` sorted particles of one 4 x by x 4
// block, the APIC scatter of momentum and mass into the job's window tile
// [wpad, 8].  With colliders (nc > 0) a job of gate level > 0 masks the
// weights by CPIC compatibility of the node tiles' affinity words with the
// particles' stored ones and reduces the impulses of its incompatible pairs
// against each node's closest body per collider.  The collider-free substep
// runs the nc = 0 branch; no pipeline path runs the other.
// Bound on the H100: instruction issue.  Device traffic is small (16 rows in
// per particle, a 360 x 8 tile out per job: ~0.08 GB per substep at 1M
// particles, ~0.025 ms); each window node tests every particle of its job
// for stencil membership (360 x group tests per job) and forms 27 pairs per
// particle of ~30 flops each.
// Design: kernel A's without the particle CDF.  The window's four
// accumulators per node (and, for nc > 0, its affinity word, closest body,
// body velocity and impulse sums) live in shared memory.  Particles go in
// chunks of NTHREADS: one thread per particle leaves a 33-word record (axis
// weights, m v, mass, affine rows, position, base cell, affinity, velocity,
// normal) in dynamic shared memory; then one thread per node adds the
// chunk's records that reach it, in particle order, each pair as
// w (m v + A (x_node - x_p)) -- not the TPU's m v - A x_p per particle
// recombined with (sum w A) x_node per node after an MXU product.  So every
// sum has the plain version's order and the kernel is deterministic with no
// atomics.  Dead jobs write zero tiles; with colliders, per-job impulses
// are summed in job order by kernel A's second launch (impulse_sum_kernel,
// transfer.cuh), which the collider-free path skips (35 us a substep at
// 1408 job slots).
#include "transfer.cuh"

// Particle record of a chunk, field-major ([PREC][NTHREADS]): axis weights
// wa[a][o] at 3a + o, m v, mass, the affine rows A[i][k] at 3i + k, the
// position, the base cell relative to the block (+8 per axis, 8 bits each,
// raw bits), the affinity word (raw bits), velocity and normal.
#define R_W 0
#define R_MV 9
#define R_M 12
#define R_A 13
#define R_P 22
#define R_BASE 25
#define R_AFF 26
#define R_V 27
#define R_N 30
#define PREC 33

__global__ void __launch_bounds__(NTHREADS) p2g_kernel(
    const float* __restrict__ pdata, long long pstride,
    const float* __restrict__ ntiles, const float* __restrict__ bt,
    const int* __restrict__ jt, int maxj, int wsh1, int wsh2, int wvol, int wpad,
    int nc, float h, float inv_h, float* __restrict__ mm,
    float* __restrict__ part) {
  __shared__ float s_acc[WV_MAX * 4];
  __shared__ uint32_t s_naff[WV_MAX];
  __shared__ float s_cl[WV_MAX], s_bv[WV_MAX * 3], s_d[WV_MAX * 3];
  extern __shared__ float s_rec[];
  const int j = blockIdx.x, tid = threadIdx.x;
  const int start = jt[j], len = jt[maxj + j];
  const bool gated = nc > 0 && jt[5 * maxj + j] > 0;
  const int bc[3] = {jt[2 * maxj + j], jt[3 * maxj + j], jt[4 * maxj + j]};
  float* tile = mm + (long long)j * wpad * 8;
  float* pj = part + (long long)j * 96;
  if (len == 0) {
    for (int k = tid; k < wpad * 8; k += NTHREADS) tile[k] = 0.0f;
    for (int k = tid; k < 96; k += NTHREADS) pj[k] = 0.0f;
    return;
  }
  for (int n = tid; n < wvol; n += NTHREADS) {
    for (int c = 0; c < 4; ++c) s_acc[n * 4 + c] = 0.0f;
    if (gated) {
      const float* t = ntiles + ((long long)j * wpad + n) * 4;
      float xw[3];
      node_pos(n, wsh1, wsh2, bc, h, xw);
      s_naff[n] = aff_word(t[0], t[1]);
      s_cl[n] = t[2];
      node_body_velocity(s_cl[n], xw, bt, nc, &s_bv[n * 3]);
      for (int k = 0; k < 3; ++k) s_d[n * 3 + k] = 0.0f;
    }
  }
  __syncthreads();

  for (int c0 = 0; c0 < len; c0 += NTHREADS) {
    const int i = c0 + tid;
    if (i < len) {
      const long long lane = (long long)start + i;
      auto row = [&](int r) { return pdata[r * pstride + lane]; };
      const float p[3] = {row(PX), row(PX + 1), row(PX + 2)};
      const float mass = row(PM);
      float wa[3][3];
      int bl[3];
      stencil_axes(p, bc, inv_h, wa, bl);
      float* r = s_rec + tid;
      for (int k = 0; k < 9; ++k) r[(R_W + k) * NTHREADS] = wa[k / 3][k % 3];
      for (int k = 0; k < 3; ++k) {
        const float v = row(VX + k);
        r[(R_MV + k) * NTHREADS] = mass * v;
        r[(R_P + k) * NTHREADS] = p[k];
        r[(R_V + k) * NTHREADS] = v;
        r[(R_N + k) * NTHREADS] = row(NX + k);
      }
      r[R_M * NTHREADS] = mass;
      for (int k = 0; k < 9; ++k) r[(R_A + k) * NTHREADS] = row(A0 + k);
      r[R_BASE * NTHREADS] =
          __int_as_float(((bl[0] + 8) << 16) | ((bl[1] + 8) << 8) | (bl[2] + 8));
      r[R_AFF * NTHREADS] = __uint_as_float(aff_word(row(AFF), row(AFF_SPARE)));
    }
    __syncthreads();

    // Each node adds the chunk's particles that reach it, in particle order:
    // compatible pairs (every pair of an ungated job) into momentum and
    // mass, the incompatible pairs of a gated job into the node's impulse.
    const int cnt = min(NTHREADS, len - c0);
    for (int n = tid; n < wvol; n += NTHREADS) {
      const int nx = n / (wsh1 * wsh2), ny = (n / wsh2) % wsh1, nz = n % wsh2;
      float xn[3];
      node_pos(n, wsh1, wsh2, bc, h, xn);
      const uint32_t naff = gated ? s_naff[n] : 0u;
      const bool has_body = gated && s_cl[n] >= 0.0f;
      float acc[4], d[3] = {0.0f, 0.0f, 0.0f};
      for (int c = 0; c < 4; ++c) acc[c] = s_acc[n * 4 + c];
      if (gated)
        for (int k = 0; k < 3; ++k) d[k] = s_d[n * 3 + k];
      for (int q = 0; q < cnt; ++q) {
        const float* r = s_rec + q;
        const int pb = __float_as_int(r[R_BASE * NTHREADS]);
        const unsigned dx = (unsigned)(nx - ((pb >> 16) - 8));
        const unsigned dy = (unsigned)(ny - (((pb >> 8) & 255) - 8));
        const unsigned dz = (unsigned)(nz - ((pb & 255) - 8));
        if (dx > 2u || dy > 2u || dz > 2u) continue;
        const float w = (r[(R_W + dx) * NTHREADS] * r[(R_W + 3 + dy) * NTHREADS])
                        * r[(R_W + 6 + dz) * NTHREADS];
        if (!gated || compat(naff, __float_as_uint(r[R_AFF * NTHREADS]))) {
          float rel[3];
          for (int k = 0; k < 3; ++k) rel[k] = xn[k] - r[(R_P + k) * NTHREADS];
          for (int a = 0; a < 3; ++a) {
            const float* A = r + (R_A + 3 * a) * NTHREADS;
            const float ar = (A[0] * rel[0] + A[NTHREADS] * rel[1])
                             + A[2 * NTHREADS] * rel[2];
            acc[a] = acc[a] + w * (r[(R_MV + a) * NTHREADS] + ar);
          }
          acc[3] = acc[3] + w * r[R_M * NTHREADS];
        } else if (has_body) {
          float vq[3], nq[3], g[3];
          for (int k = 0; k < 3; ++k) {
            vq[k] = r[(R_V + k) * NTHREADS];
            nq[k] = r[(R_N + k) * NTHREADS];
          }
          const float wi = w * r[R_M * NTHREADS];
          ghost_velocity(vq, &s_bv[n * 3], nq, g);
          for (int k = 0; k < 3; ++k) d[k] = d[k] + wi * (vq[k] - g[k]);
        }
      }
      for (int c = 0; c < 4; ++c) s_acc[n * 4 + c] = acc[c];
      if (gated)
        for (int k = 0; k < 3; ++k) s_d[n * 3 + k] = d[k];
    }
    __syncthreads();
  }

  for (int k = tid; k < wpad * 8; k += NTHREADS) {
    const int n = k / 8, c = k % 8;
    tile[k] = (n < wvol && c < 4) ? s_acc[n * 4 + c] : 0.0f;
  }
  // Per-collider impulses of the job, window nodes in node order.
  if (tid < 16) {
    const int b = tid;
    float db[3] = {0.0f, 0.0f, 0.0f}, cb[3] = {0.0f, 0.0f, 0.0f};
    if (gated && b < nc) {
      for (int n = 0; n < wvol; ++n) {
        if (s_cl[n] != (float)b) continue;
        const float* d = &s_d[n * 3];
        float x[3];
        node_pos(n, wsh1, wsh2, bc, h, x);
        db[0] = db[0] + d[0];
        db[1] = db[1] + d[1];
        db[2] = db[2] + d[2];
        cb[0] = cb[0] + (d[1] * x[2] - d[2] * x[1]);
        cb[1] = cb[1] + (d[2] * x[0] - d[0] * x[2]);
        cb[2] = cb[2] + (d[0] * x[1] - d[1] * x[0]);
      }
    }
    float com[3] = {0.0f, 0.0f, 0.0f};
    if (b < nc) for (int k = 0; k < 3; ++k) com[k] = bt[k * 128 + b];
    pj[0 * 16 + b] = db[0];
    pj[1 * 16 + b] = db[1];
    pj[2 * 16 + b] = db[2];
    pj[3 * 16 + b] = db[1] * com[2] - db[2] * com[1] - cb[0];
    pj[4 * 16 + b] = db[2] * com[0] - db[0] * com[2] - cb[1];
    pj[5 * 16 + b] = db[0] * com[1] - db[1] * com[0] - cb[2];
  }
}

extern "C" int p2g_cuda(const float* pdata, long long pstride,
                        const float* ntiles, const float* bt, const int* jt,
                        long long maxj, long long by, long long nc, float h,
                        float inv_h, float* mm, float* part, float* imp,
                        cudaStream_t stream) {
  int wsh1 = (int)by + 2, wsh2 = 6;
  int wvol = 6 * wsh1 * wsh2, wpad = (wvol + 7) / 8 * 8;
  const int shm = PREC * NTHREADS * (int)sizeof(float);
  if (maxj > 0) {
    // Static (~17 KB) plus dynamic (~34 KB) shared memory passes the 48 KB
    // default.
    cudaError_t e = cudaFuncSetAttribute(
        p2g_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shm);
    if (e != cudaSuccess) return (int)e;
    p2g_kernel<<<(unsigned)maxj, NTHREADS, shm, stream>>>(
        pdata, pstride, ntiles, bt, jt, (int)maxj, wsh1, wsh2, wvol, wpad,
        (int)nc, h, inv_h, mm, part);
    // With no collider the impulses are the wrapper's zeros.
    if (nc > 0) impulse_sum_kernel<<<1, 96, 0, stream>>>(part, (int)maxj, imp);
  }
  return (int)cudaGetLastError();
}
