// Particle CDF of the 2D path, one thread block per job.
//
// Replaces: wgsparkl_tpu/ops/pallas_transfer2d.py `_pcdf_kernel` (launched by
// `pcdf_rows`) with its body `_pcdf_body`: per job of up to `group` sorted
// particles of one 8 x 8 block, each particle's affinity word (the union of
// its stencil nodes' collider bits, per-collider sign votes weighted by node
// distance with the previous word's signs kept), and its signed distance and
// normal from the 3x3 MLS solve over the compatible stencil nodes.  The
// window node CDF is the gathered channels, or in chan-free mode every
// collider evaluated at the window nodes (`_moving_node_cdf_2d`,
// pallas_transfer2d.py:667-671; transfer2d.cuh window_node_cdf2), with no
// tile read.
// Bound on the H100: device memory, lightly.  Per particle it reads 4 rows
// and writes 5 (~18 MB per substep at 490k particles, ~5 us at 3.35 TB/s);
// the arithmetic is ~9 x (2 nc + 14) multiply-adds and one 3x3 cofactor
// solve, a few hundred flops.
// In chan-free mode each gated job adds 100 x nc collider evaluations
// (~90 flops each) and reads no tile.
// Design: the job's 100 window nodes' affinity words and distances go to
// shared memory; one thread per particle walks only its 3 x 3 stencil (the
// TPU kernel's support mask over the whole window is exactly that stencil)
// and sums in the plain version's order, node (ox, oy) with oy fastest, so
// the result matches it bit for bit.  Only the lanes [start, start + len)
// of gated jobs are written; the wrapper zeroes the output, which is what
// the TPU kernel leaves on the lanes of ungated jobs.
#include "transfer2d.cuh"

__device__ void inv3_solve(const float a[3][3], const float b[3], float x[3],
                           float* det_out) {
  float c00 = a[1][1] * a[2][2] - a[1][2] * a[2][1];
  float c01 = a[1][2] * a[2][0] - a[1][0] * a[2][2];
  float c02 = a[1][0] * a[2][1] - a[1][1] * a[2][0];
  float det = a[0][0] * c00 + a[0][1] * c01 + a[0][2] * c02;
  float inv_det = fabsf(det) > 1e-30f ? nr_recip(det) : 0.0f;
  float i[3][3];
  i[0][0] = c00;
  i[0][1] = a[0][2] * a[2][1] - a[0][1] * a[2][2];
  i[0][2] = a[0][1] * a[1][2] - a[0][2] * a[1][1];
  i[1][0] = c01;
  i[1][1] = a[0][0] * a[2][2] - a[0][2] * a[2][0];
  i[1][2] = a[0][2] * a[1][0] - a[0][0] * a[1][2];
  i[2][0] = c02;
  i[2][1] = a[0][1] * a[2][0] - a[0][0] * a[2][1];
  i[2][2] = a[0][0] * a[1][1] - a[0][1] * a[1][0];
  for (int r = 0; r < 3; ++r)
    x[r] = (i[r][0] * b[0] + i[r][1] * b[1] + i[r][2] * b[2]) * inv_det;
  *det_out = det;
}

__global__ void __launch_bounds__(NTHREADS) pcdf2d_kernel(
    const float* __restrict__ pdata, long long pstride,
    const float* __restrict__ ntiles, const float* __restrict__ bt,
    const int* __restrict__ jt, int maxj, int nc, unsigned shapes,
    int chan_free, float h, float inv_h, float cap, float* __restrict__ out,
    long long ostride) {
  __shared__ uint32_t s_naff[WVOL];
  __shared__ float s_dist[WVOL];
  const int j = blockIdx.x;
  const int start = jt[j], len = jt[maxj + j], lvl = jt[5 * maxj + j];
  if (len == 0 || lvl == 0) return;
  const int bc[2] = {jt[2 * maxj + j], jt[3 * maxj + j]};
  for (int n = threadIdx.x; n < WVOL; n += NTHREADS) {
    if (chan_free) {
      float xw[2], cl;
      node_pos2(n, bc, h, xw);
      window_node_cdf2(bt, nc, shapes, xw, cap, &s_naff[n], &cl, &s_dist[n]);
    } else {
      const float* t = ntiles + ((long long)j * WPAD + n) * 4;
      s_naff[n] = aff_word(t[0], t[1]);
      s_dist[n] = t[3];
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < len; i += NTHREADS) {
    const long long lane = (long long)start + i;
    auto row = [&](int r) { return pdata[r * pstride + lane]; };
    const float p[2] = {row(PX), row(PX + 1)};
    float wa[2][3];
    int bl[2];
    stencil_axes2(p, bc, inv_h, wa, bl);
    // The 9 stencil nodes: weight, affinity word (0 outside the window),
    // distance and offset from the particle.
    float w[9], nd[9], dx[9][2];
    uint32_t na[9];
    for (int ox = 0; ox < 3; ++ox)
      for (int oy = 0; oy < 3; ++oy) {
        const int o = 3 * ox + oy;
        const bool ok = in_window(bl[0] + ox, bl[1] + oy);
        const int n = ok ? (bl[0] + ox) * WSH + bl[1] + oy : 0;
        float xw[2];
        node_pos2(n, bc, h, xw);
        w[o] = ok ? wa[0][ox] * wa[1][oy] : 0.0f;
        na[o] = ok ? s_naff[n] : 0u;
        nd[o] = s_dist[n];
        dx[o][0] = xw[0] - p[0];
        dx[o][1] = xw[1] - p[1];
      }

    const uint32_t prev = aff_word(row(AFF), row(AFF_SPARE));
    uint32_t p_bits = 0u, sign_word = 0u;
    for (int c = 0; c < nc; ++c) {
      bool present = false;
      float votes = 0.0f;
      for (int o = 0; o < 9; ++o) {
        const bool has = (na[o] >> c) & 1u;
        present = present || has;
        const float dw = nd[o] * w[o];
        votes = votes + (has ? (((na[o] >> (16 + c)) & 1u) ? -dw : dw) : 0.0f);
      }
      if (present) p_bits |= 1u << c;
      const bool new_sign = ((prev >> c) & 1u) ? (((prev >> (16 + c)) & 1u) != 0u)
                                               : (votes < 0.0f);
      if (new_sign) sign_word |= 1u << (16 + c);
    }
    const uint32_t p_aff = p_bits | sign_word;

    // MLS moments: a = sum wk [dx dx^T, dx; dx^T, 1], b = sum wk sd [dx; 1].
    float a00 = 0.f, a01 = 0.f, a02 = 0.f, a11 = 0.f, a12 = 0.f, a22 = 0.f;
    float b0 = 0.f, b1 = 0.f, b2 = 0.f;
    for (int o = 0; o < 9; ++o) {
      const uint32_t combined = na[o] & p_aff & 0xFFFFu;
      const uint32_t sign_diff = (((na[o] ^ p_aff) >> 16) & 0xFFFFu) & combined;
      const float wk = combined != 0u ? w[o] : 0.0f;
      const float wks = wk * (sign_diff == 0u ? nd[o] : -nd[o]);
      a00 = a00 + wk * dx[o][0] * dx[o][0];
      a01 = a01 + wk * dx[o][0] * dx[o][1];
      a02 = a02 + wk * dx[o][0];
      a11 = a11 + wk * dx[o][1] * dx[o][1];
      a12 = a12 + wk * dx[o][1];
      a22 = a22 + wk;
      b0 = b0 + wks * dx[o][0];
      b1 = b1 + wks * dx[o][1];
      b2 = b2 + wks;
    }
    const float a[3][3] = {{a00, a01, a02}, {a01, a11, a12}, {a02, a12, a22}};
    const float b[3] = {b0, b1, b2};
    float x[3], det;
    inv3_solve(a, b, x, &det);
    const bool ok = det > 1e-8f;
    const float nlen = sqrtf(x[0] * x[0] + x[1] * x[1]);
    const float ninv = nlen > 1e-6f ? nr_recip(fmaxf(nlen, 1e-30f)) : 0.0f;
    const uint32_t aff = ok ? p_aff : 0u;
    out[lane] = (float)(aff & 0xFFFFu);
    out[ostride + lane] = ok ? x[2] : 0.0f;
    out[2 * ostride + lane] = ok ? x[0] * ninv : 0.0f;
    out[3 * ostride + lane] = ok ? x[1] * ninv : 0.0f;
    out[4 * ostride + lane] = (float)((aff >> 16) & 0xFFFFu);
  }
}

extern "C" int pcdf2d_cuda(const float* pdata, long long pstride,
                           const float* ntiles, const float* bt, const int* jt,
                           long long maxj, long long nc, long long shapes,
                           long long chan_free, float h, float inv_h, float cap,
                           float* out, long long ostride, cudaStream_t stream) {
  if (maxj > 0)
    pcdf2d_kernel<<<(unsigned)maxj, NTHREADS, 0, stream>>>(
        pdata, pstride, ntiles, bt, jt, (int)maxj, (int)nc, (unsigned)shapes,
        (int)chan_free, h, inv_h, cap, out, ostride);
  return (int)cudaGetLastError();
}
