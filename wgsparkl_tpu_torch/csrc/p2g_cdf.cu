// Fused particle CDF + CPIC P2G, one thread block per job.
//
// Replaces: wgsparkl_tpu/ops/pallas_cdf.py `_p2g_cdf_kernel` (launched by
// `p2g_cdf_tiles`) with its body `_pcdf_body`: per job of up to `group`
// sorted particles of one 4 x by x 4 block, the particle CDF (affinity union
// over the 3^3 stencil, sign votes with temporal persistence, 4x4 MLS solve
// for signed distance and normal), the compatibility-masked APIC P2G of
// momentum and mass into the job's window tile, and at gate level 2 the
// merge of the moving colliders into the window CDF and the ghost-velocity
// impulses reduced per collider.
// Bound on the H100: arithmetic and shared-memory reads.  Device traffic is
// small (24 rows in, 6 rows and one 360 x 8 tile out per job: ~0.15 GB per
// substep at 1M particles); each particle runs ~27 x (nc + 14)
// multiply-adds for the CDF, and each window node tests every particle of
// its job for stencil membership (360 x group tests per job).
// Design: the window's node channels (360 nodes at by = 8) and the 13 P2G
// accumulators per node live in shared memory (~32 KB).  Particles go in
// chunks of NTHREADS: one thread per particle walks its own 27 stencil
// nodes for the CDF (not the TPU's dense [window x group] weight matrix) and
// leaves a 30-word record (axis weights, P2G features, velocity, normal,
// base cell, affinity) in shared memory; then one thread per node adds the
// chunk's records that reach it, in particle order.  So every sum has a
// fixed order (the plain version's accumulation order) and the kernel is
// deterministic: shared-memory atomics would sum in a different order on
// every run, and the Drucker-Prager return map near its cone tip turns that
// f32 roundoff into ~1e-4 of F.  Each job writes only its own lanes
// [start, start + len): CUDA blocks run in no order, so the TPU kernel's
// sequential-grid handoff of each job's padded tail does not carry over.
// Impulses go to per-job partials summed in job order by a second launch,
// so the result does not depend on block scheduling either.
#include "transfer.cuh"

__device__ void inv4_solve(const float a[4][4], const float b[4], float x[4],
                           float* det_out) {
  float s0 = a[0][0] * a[1][1] - a[1][0] * a[0][1];
  float s1 = a[0][0] * a[1][2] - a[1][0] * a[0][2];
  float s2 = a[0][0] * a[1][3] - a[1][0] * a[0][3];
  float s3 = a[0][1] * a[1][2] - a[1][1] * a[0][2];
  float s4 = a[0][1] * a[1][3] - a[1][1] * a[0][3];
  float s5 = a[0][2] * a[1][3] - a[1][2] * a[0][3];
  float c5 = a[2][2] * a[3][3] - a[3][2] * a[2][3];
  float c4 = a[2][1] * a[3][3] - a[3][1] * a[2][3];
  float c3 = a[2][1] * a[3][2] - a[3][1] * a[2][2];
  float c2 = a[2][0] * a[3][3] - a[3][0] * a[2][3];
  float c1 = a[2][0] * a[3][2] - a[3][0] * a[2][2];
  float c0 = a[2][0] * a[3][1] - a[3][0] * a[2][1];
  float det = s0 * c5 - s1 * c4 + s2 * c3 + s3 * c2 - s4 * c1 + s5 * c0;
  float i[4][4];
  i[0][0] = a[1][1] * c5 - a[1][2] * c4 + a[1][3] * c3;
  i[0][1] = -a[0][1] * c5 + a[0][2] * c4 - a[0][3] * c3;
  i[0][2] = a[3][1] * s5 - a[3][2] * s4 + a[3][3] * s3;
  i[0][3] = -a[2][1] * s5 + a[2][2] * s4 - a[2][3] * s3;
  i[1][0] = -a[1][0] * c5 + a[1][2] * c2 - a[1][3] * c1;
  i[1][1] = a[0][0] * c5 - a[0][2] * c2 + a[0][3] * c1;
  i[1][2] = -a[3][0] * s5 + a[3][2] * s2 - a[3][3] * s1;
  i[1][3] = a[2][0] * s5 - a[2][2] * s2 + a[2][3] * s1;
  i[2][0] = a[1][0] * c4 - a[1][1] * c2 + a[1][3] * c0;
  i[2][1] = -a[0][0] * c4 + a[0][1] * c2 - a[0][3] * c0;
  i[2][2] = a[3][0] * s4 - a[3][1] * s2 + a[3][3] * s0;
  i[2][3] = -a[2][0] * s4 + a[2][1] * s2 - a[2][3] * s0;
  i[3][0] = -a[1][0] * c3 + a[1][1] * c1 - a[1][2] * c0;
  i[3][1] = a[0][0] * c3 - a[0][1] * c1 + a[0][2] * c0;
  i[3][2] = -a[3][0] * s3 + a[3][1] * s1 - a[3][2] * s0;
  i[3][3] = a[2][0] * s3 - a[2][1] * s1 + a[2][2] * s0;
  float inv_det = fabsf(det) > 1e-30f ? nr_recip(det) : 0.0f;
  for (int r = 0; r < 4; ++r)
    x[r] = (i[r][0] * b[0] + i[r][1] * b[1] + i[r][2] * b[2] + i[r][3] * b[3]) * inv_det;
  *det_out = det;
}

// Particle record of a chunk, field-major in dynamic shared memory
// ([PREC][NTHREADS]): axis weights wa[a][o] at 3a + o, the 13 P2G features,
// velocity, normal, the base cell relative to the block (+8 per axis,
// packed 8 bits each) and the affinity word, both as raw bits.
#define R_W 0
#define R_F 9
#define R_V 22
#define R_N 25
#define R_BASE 28
#define R_AFF 29
#define PREC 30

__global__ void __launch_bounds__(NTHREADS) p2g_cdf_kernel(
    const float* __restrict__ pdata, long long pstride,
    const float* __restrict__ ntiles, const float* __restrict__ bt,
    const int* __restrict__ jt, int maxj, int wsh1, int wsh2, int wvol, int wpad,
    int nc, unsigned moving, float h, float inv_h, float cap,
    float* __restrict__ mm, float* __restrict__ part, float* __restrict__ pcdf,
    long long ostride) {
  __shared__ uint32_t s_naff[WV_MAX];
  __shared__ float s_cl[WV_MAX], s_dist[WV_MAX];
  __shared__ float s_bv[WV_MAX * 3], s_d[WV_MAX * 3];
  __shared__ float s_acc[WV_MAX * 13];
  extern __shared__ float s_rec[];
  const int j = blockIdx.x, tid = threadIdx.x;
  const int start = jt[j], len = jt[maxj + j], lvl = jt[5 * maxj + j];
  const int bc[3] = {jt[2 * maxj + j], jt[3 * maxj + j], jt[4 * maxj + j]};
  float* tile = mm + (long long)j * wpad * 8;
  float* pj = part + (long long)j * 96;
  if (len == 0) {
    for (int k = tid; k < wpad * 8; k += NTHREADS) tile[k] = 0.0f;
    for (int k = tid; k < 96; k += NTHREADS) pj[k] = 0.0f;
    return;
  }
  for (int n = tid; n < wvol; n += NTHREADS) {
    for (int c = 0; c < 13; ++c) s_acc[n * 13 + c] = 0.0f;
    for (int k = 0; k < 3; ++k) { s_d[n * 3 + k] = 0.0f; s_bv[n * 3 + k] = 0.0f; }
    if (lvl >= 1) {
      float xw[3];
      node_pos(n, wsh1, wsh2, bc, h, xw);
      window_node_cdf(ntiles + ((long long)j * wpad + n) * 4, bt, lvl, moving, xw,
                      cap, &s_naff[n], &s_cl[n], &s_dist[n]);
      if (lvl >= 2) node_body_velocity(s_cl[n], xw, bt, nc, &s_bv[n * 3]);
    }
  }
  __syncthreads();

  const float offs[3] = {(float)bc[0] * h, (float)bc[1] * h, (float)bc[2] * h};
  for (int c0 = 0; c0 < len; c0 += NTHREADS) {
    const int i = c0 + tid;
    if (i < len) {
      const long long lane = (long long)start + i;
      auto row = [&](int r) { return pdata[r * pstride + lane]; };
      float p[3] = {row(PX), row(PX + 1), row(PX + 2)};
      float v[3] = {row(VX), row(VX + 1), row(VX + 2)};
      float mass = row(PM);
      float A[3][3];
      for (int a = 0; a < 3; ++a)
        for (int k = 0; k < 3; ++k) A[a][k] = row(A0 + 3 * a + k);
      Stencil st;
      stencil(p, bc, inv_h, wsh1, wsh2, &st);

      uint32_t aff = 0;
      float sd = 0.0f, nrm[3] = {0.0f, 0.0f, 0.0f};
      if (lvl >= 1) {
        uint32_t prev = aff_word(row(AFF), row(AFF_SPARE));
        uint32_t p_bits = 0, sign_word = 0;
        for (int c = 0; c < nc; ++c) {
          bool present = false;
          float votes = 0.0f;
          for (int o = 0; o < 27; ++o) {
            uint32_t na = ((st.valid >> o) & 1u) ? s_naff[st.n[o]] : 0u;
            bool has = (na >> c) & 1u;
            present = present || has;
            float dw = s_dist[st.n[o]] * st.w[o];
            float term = has ? (((na >> (16 + c)) & 1u) ? -dw : dw) : 0.0f;
            votes = votes + term;
          }
          if (present) p_bits |= 1u << c;
          bool prev_has = (prev >> c) & 1u;
          bool prev_sign = (prev >> (16 + c)) & 1u;
          bool new_sign = prev_has ? prev_sign : (votes < 0.0f);
          if (new_sign) sign_word |= 1u << (16 + c);
        }
        uint32_t p_aff = p_bits | sign_word;
        float sm[10], tm[4];
        for (int m = 0; m < 10; ++m) sm[m] = 0.0f;
        for (int m = 0; m < 4; ++m) tm[m] = 0.0f;
        for (int o = 0; o < 27; ++o) {
          int n = st.n[o];
          uint32_t na = ((st.valid >> o) & 1u) ? s_naff[n] : 0u;
          uint32_t combined = na & p_aff & 0xFFFFu;
          uint32_t sign_diff = (((na ^ p_aff) >> 16) & 0xFFFFu) & combined;
          float wk = combined != 0u ? st.w[o] : 0.0f;
          float wks = wk * (sign_diff == 0u ? s_dist[n] : -s_dist[n]);
          float xw[3];
          node_pos(n, wsh1, wsh2, bc, h, xw);
          float x0 = xw[0] - offs[0], x1 = xw[1] - offs[1], x2 = xw[2] - offs[2];
          const float mono[10] = {1.0f, x0, x1, x2, x0 * x0, x0 * x1, x0 * x2,
                                  x1 * x1, x1 * x2, x2 * x2};
          sm[0] = sm[0] + wk;
          for (int m = 1; m < 10; ++m) sm[m] = sm[m] + mono[m] * wk;
          tm[0] = tm[0] + wks;
          for (int m = 1; m < 4; ++m) tm[m] = tm[m] + mono[m] * wks;
        }
        float pl[3] = {p[0] - offs[0], p[1] - offs[1], p[2] - offs[2]};
        const int pair[3][3] = {{4, 5, 6}, {5, 7, 8}, {6, 8, 9}};
        float a[4][4], b[4], x[4], det;
        for (int r = 0; r < 3; ++r) {
          for (int c = r; c < 3; ++c)
            a[r][c] = sm[pair[r][c]] - pl[r] * sm[1 + c] - pl[c] * sm[1 + r]
                      + pl[r] * pl[c] * sm[0];
          a[r][3] = sm[1 + r] - pl[r] * sm[0];
        }
        a[3][3] = sm[0];
        for (int r = 0; r < 4; ++r)
          for (int c = 0; c < r; ++c) a[r][c] = a[c][r];
        for (int k = 0; k < 3; ++k) b[k] = tm[1 + k] - pl[k] * tm[0];
        b[3] = tm[0];
        inv4_solve(a, b, x, &det);
        bool ok = det > 1e-8f;
        float nlen = sqrtf(x[0] * x[0] + x[1] * x[1] + x[2] * x[2]);
        float ninv = nlen > 1e-6f ? nr_recip(fmaxf(nlen, 1e-30f)) : 0.0f;
        for (int k = 0; k < 3; ++k) nrm[k] = ok ? x[k] * ninv : 0.0f;
        sd = ok ? x[3] : 0.0f;
        aff = ok ? p_aff : 0u;
      }
      pcdf[lane] = (float)(aff & 0xFFFFu);
      pcdf[ostride + lane] = sd;
      for (int k = 0; k < 3; ++k) pcdf[(2 + k) * ostride + lane] = nrm[k];
      pcdf[5 * ostride + lane] = (float)((aff >> 16) & 0xFFFFu);

      // The particle's record for the node-side P2G.
      float feat[13];
      for (int k = 0; k < 3; ++k) {
        float ap = A[k][0] * p[0] + A[k][1] * p[1] + A[k][2] * p[2];
        feat[k] = mass * v[k] - ap;
      }
      feat[3] = mass;
      for (int k = 0; k < 3; ++k)
        for (int a = 0; a < 3; ++a) feat[4 + 3 * k + a] = A[a][k];
      float wa[3][3];
      int bl[3];
      stencil_axes(p, bc, inv_h, wa, bl);
      float* r = s_rec + tid;
      for (int k = 0; k < 9; ++k) r[(R_W + k) * NTHREADS] = wa[k / 3][k % 3];
      for (int f = 0; f < 13; ++f) r[(R_F + f) * NTHREADS] = feat[f];
      for (int k = 0; k < 3; ++k) {
        r[(R_V + k) * NTHREADS] = v[k];
        r[(R_N + k) * NTHREADS] = nrm[k];
      }
      r[R_BASE * NTHREADS] =
          __int_as_float(((bl[0] + 8) << 16) | ((bl[1] + 8) << 8) | (bl[2] + 8));
      r[R_AFF * NTHREADS] = __uint_as_float(aff);
    }
    __syncthreads();

    // Compatibility-masked APIC P2G (+ level-2 impulse pairs): each node
    // adds the chunk's particles that reach it, in particle order.
    const int cnt = min(NTHREADS, len - c0);
    for (int n = tid; n < wvol; n += NTHREADS) {
      const int nx = n / (wsh1 * wsh2), ny = (n / wsh2) % wsh1, nz = n % wsh2;
      const uint32_t naff = s_naff[n];
      const float cl = s_cl[n];
      float acc[13], d[3];
      for (int f = 0; f < 13; ++f) acc[f] = s_acc[n * 13 + f];
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
        const uint32_t paff = __float_as_uint(r[R_AFF * NTHREADS]);
        if (lvl == 0 || compat(naff, paff)) {
          for (int f = 0; f < 13; ++f) acc[f] = acc[f] + w * r[(R_F + f) * NTHREADS];
        } else if (lvl >= 2 && cl >= 0.0f) {
          float vq[3], nq[3], g[3];
          for (int k = 0; k < 3; ++k) {
            vq[k] = r[(R_V + k) * NTHREADS];
            nq[k] = r[(R_N + k) * NTHREADS];
          }
          const float wi = w * r[(R_F + 3) * NTHREADS];
          ghost_velocity(vq, &s_bv[n * 3], nq, g);
          for (int k = 0; k < 3; ++k) d[k] = d[k] + wi * (vq[k] - g[k]);
        }
      }
      for (int f = 0; f < 13; ++f) s_acc[n * 13 + f] = acc[f];
      for (int k = 0; k < 3; ++k) s_d[n * 3 + k] = d[k];
    }
    __syncthreads();
  }

  for (int k = tid; k < wpad * 8; k += NTHREADS) {
    int n = k / 8, c = k % 8;
    float val = 0.0f;
    if (n < wvol && c < 4) {
      const float* ac = &s_acc[n * 13];
      if (c == 3) {
        val = ac[3];
      } else {
        float xw[3];
        node_pos(n, wsh1, wsh2, bc, h, xw);
        val = ac[c] + xw[0] * ac[4 + c] + xw[1] * ac[7 + c] + xw[2] * ac[10 + c];
      }
    }
    tile[k] = val;
  }
  if (tid < 16) {
    const int b = tid;
    float db[3] = {0.0f, 0.0f, 0.0f}, cb[3] = {0.0f, 0.0f, 0.0f};
    if (lvl >= 2 && b < nc) {
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

extern "C" int p2g_cdf_cuda(const float* pdata, long long pstride,
                            const float* ntiles, const float* bt, const int* jt,
                            long long maxj, long long by, long long nc,
                            long long moving, float h, float inv_h, float cap,
                            float* mm, float* part, float* imp, float* pcdf,
                            long long ostride, cudaStream_t stream) {
  int wsh1 = (int)by + 2, wsh2 = 6;
  int wvol = 6 * wsh1 * wsh2, wpad = (wvol + 7) / 8 * 8;
  const int shm = PREC * NTHREADS * (int)sizeof(float);
  if (maxj > 0) {
    // Static (~32 KB) plus dynamic shared memory passes the 48 KB default.
    cudaError_t e = cudaFuncSetAttribute(
        p2g_cdf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shm);
    if (e != cudaSuccess) return (int)e;
    p2g_cdf_kernel<<<(unsigned)maxj, NTHREADS, shm, stream>>>(
        pdata, pstride, ntiles, bt, jt, (int)maxj, wsh1, wsh2, wvol, wpad,
        (int)nc, (unsigned)moving, h, inv_h, cap, mm, part, pcdf, ostride);
    impulse_sum_kernel<<<1, 96, 0, stream>>>(part, (int)maxj, imp);
  }
  return (int)cudaGetLastError();
}
