// Particle CDF of the 2D path, one thread block per job slot, with the
// sorted rows patched in place.
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
// tile read.  Also the patch of the particle rows that follows it
// (wgsparkl_tpu/pipeline.py:1671-1683): rows AFF, NX, NY and AFF_SPARE of
// pdata take output rows 0, 2, 3 and 4 on every lane [0, NPAD), in place.
// Bound on the H100: device memory.  It writes all 8 output rows of its
// width and the 4 patched rows (~23.5 MB a substep at 490k particles, ~7 us
// at 3.35 TB/s); a particle of a gated job reads 4 rows and its job's node
// tile, ~9 x (2 nc + 14) multiply-adds and one 3x3 cofactor solve.  In
// chan-free mode each gated job adds 100 x nc collider evaluations (~40
// flops each) and reads no tile.
// Design: the kernel owns its output (the wrapper allocates it with
// torch.empty).  A gated job's 100 window nodes' affinity words and
// distances go to shared memory; one thread per particle walks its 3 x 3
// stencil per axis (stencil_axis_nodes2: no node array, no division; the
// TPU kernel's support mask over the whole window is exactly that stencil),
// twice (the votes, then the MLS moments), and sums in the plain version's
// order, node (ox, oy) with oy fastest, so the result matches it bit for
// bit.  The thread reads the lane's previous affinity rows before it
// writes the patched ones, and no other thread reads or writes that lane,
// so pdata is patched in place.  An ungated job streams zeros over its
// lanes, its 12 rows as one run of 16-byte stores (transfer2d.cuh
// zero_rows), and the lanes past the live jobs get zeros in stripes, lane
// by lane (tail_share and zero_tail, as in kernel I).
#include "transfer2d.cuh"

// The patched particle rows AFF, NX, NY, AFF_SPARE are zeroed as one run.
#if NX != AFF + 1 || AFF_SPARE != AFF + 3
#error "the patched rows AFF, NX, NY, AFF_SPARE must be consecutive"
#endif

__device__ __forceinline__ void inv3_solve(const float a[3][3], const float b[3],
                                           float x[3], float* det_out) {
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

// One particle of a gated job: its CDF into output rows 0-4 (rows 5-7
// zero) and pdata rows AFF, NX, NY, AFF_SPARE, which it reads first.
__device__ __forceinline__ void pcdf2d_particle(
    float* __restrict__ pdata, long long pstride, long long lane, const int bc[2],
    int nc, float h, float inv_h, const uint32_t* s_naff, const float* s_dist,
    float* __restrict__ out, long long ostride) {
  auto row = [&](int r) { return pdata[r * pstride + lane]; };
  const float p[2] = {row(PX), row(PX + 1)};
  const uint32_t prev = aff_word(row(AFF), row(AFF_SPARE));
  float wa[2][3], xa[2][3];
  int bl[2];
  bool ok[2][3];
  stencil_axes2(p, bc, inv_h, wa, bl);
  stencil_axis_nodes2(bl, bc, h, ok, xa);
  const int n0 = bl[0] * WSH + bl[1];
  // A node outside the window is dropped (weight and affinity 0: it adds
  // nothing to any sum below).
  uint32_t p_bits = 0u, sign_word = 0u;
  for (int c = 0; c < nc; ++c) {
    bool present = false;
    float votes = 0.0f;
#pragma unroll
    for (int ox = 0; ox < 3; ++ox)
#pragma unroll
      for (int oy = 0; oy < 3; ++oy) {
        if (!(ok[0][ox] && ok[1][oy])) continue;
        const int n = n0 + ox * WSH + oy;
        const uint32_t na = s_naff[n];
        const bool has = (na >> c) & 1u;
        present = present || has;
        const float dw = s_dist[n] * (wa[0][ox] * wa[1][oy]);
        votes = votes + (has ? (((na >> (16 + c)) & 1u) ? -dw : dw) : 0.0f);
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
#pragma unroll
  for (int ox = 0; ox < 3; ++ox)
#pragma unroll
    for (int oy = 0; oy < 3; ++oy) {
      if (!(ok[0][ox] && ok[1][oy])) continue;
      const int n = n0 + ox * WSH + oy;
      const uint32_t na = s_naff[n];
      const float nd = s_dist[n];
      const uint32_t combined = na & p_aff & 0xFFFFu;
      const uint32_t sign_diff = (((na ^ p_aff) >> 16) & 0xFFFFu) & combined;
      const float wk = combined != 0u ? wa[0][ox] * wa[1][oy] : 0.0f;
      const float wks = wk * (sign_diff == 0u ? nd : -nd);
      const float dx0 = xa[0][ox] - p[0], dx1 = xa[1][oy] - p[1];
      a00 = a00 + wk * dx0 * dx0;
      a01 = a01 + wk * dx0 * dx1;
      a02 = a02 + wk * dx0;
      a11 = a11 + wk * dx1 * dx1;
      a12 = a12 + wk * dx1;
      a22 = a22 + wk;
      b0 = b0 + wks * dx0;
      b1 = b1 + wks * dx1;
      b2 = b2 + wks;
    }
  const float a[3][3] = {{a00, a01, a02}, {a01, a11, a12}, {a02, a12, a22}};
  const float b[3] = {b0, b1, b2};
  float x[3], det;
  inv3_solve(a, b, x, &det);
  const bool solved = det > 1e-8f;
  const float nlen = sqrtf(x[0] * x[0] + x[1] * x[1]);
  const float ninv = nlen > 1e-6f ? nr_recip(fmaxf(nlen, 1e-30f)) : 0.0f;
  const uint32_t aff = solved ? p_aff : 0u;
  const float v[5] = {(float)(aff & 0xFFFFu), solved ? x[2] : 0.0f,
                      solved ? x[0] * ninv : 0.0f, solved ? x[1] * ninv : 0.0f,
                      (float)((aff >> 16) & 0xFFFFu)};
#pragma unroll
  for (int r = 0; r < 8; ++r) out[r * ostride + lane] = r < 5 ? v[r] : 0.0f;
  pdata[AFF * pstride + lane] = v[0];
  pdata[NX * pstride + lane] = v[2];
  pdata[(NX + 1) * pstride + lane] = v[3];
  pdata[AFF_SPARE * pstride + lane] = v[4];
}

// Zero the output's 8 rows and pdata's 4 patched rows on an ungated job's
// lanes [start, start + len) with the block's threads (zero_job), and past
// the live jobs, from end to each one's width (pdata's is NPAD), as thread
// t of nt (zero_past).
__device__ __forceinline__ void zero_job(float* out, long long ostride, float* pdata,
                                         long long pstride, long long start, int len) {
  zero_rows(out, ostride, 0, 8, start, start + len, threadIdx.x, NTHREADS);
  zero_rows(pdata, pstride, AFF, 4, start, start + len, threadIdx.x, NTHREADS);
}

__device__ __forceinline__ void zero_past(float* out, long long ostride, float* pdata,
                                          long long pstride, long long end, int t, int nt) {
  zero_tail(out, ostride, 0, 8, end, ostride, t, nt);
  zero_tail(pdata, pstride, AFF, 4, end, pstride, t, nt);
}

__global__ void __launch_bounds__(NTHREADS) pcdf2d_kernel(
    float* __restrict__ pdata, long long pstride, const float* __restrict__ ntiles,
    const float* __restrict__ bt, const int* __restrict__ jt, int maxj, int nc,
    unsigned shapes, int chan_free, float h, float inv_h, float cap,
    float* __restrict__ out, long long ostride) {
  __shared__ uint32_t s_naff[WVOL];
  __shared__ float s_dist[WVOL];
  const int j = blockIdx.x, tid = threadIdx.x;
  // Every job-table entry at once: one load latency.
  const int len = jt[maxj + j], start = jt[j], lvl = jt[5 * maxj + j];
  const int bc[2] = {jt[2 * maxj + j], jt[3 * maxj + j]};
  long long end;
  int part, parts;
  if (len == 0) {
    if (tail_share(jt, maxj, j, len, &end, &part, &parts))
      zero_past(out, ostride, pdata, pstride, end, part * NTHREADS + tid,
                parts * NTHREADS);
    return;
  }
  if (lvl > 0) {
    for (int n = tid; n < WVOL; n += NTHREADS) {
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
    for (int i = tid; i < len; i += NTHREADS)
      pcdf2d_particle(pdata, pstride, (long long)start + i, bc, nc, h, inv_h, s_naff,
                      s_dist, out, ostride);
  } else {
    // Ungated: no particle CDF, zero rows.
    zero_job(out, ostride, pdata, pstride, start, len);
  }
  // No dead slot (every slot live, or the table overflowed): every block
  // stripes the lanes past the last job.
  if (tail_share(jt, maxj, j, len, &end, &part, &parts))
    zero_past(out, ostride, pdata, pstride, end, part * NTHREADS + tid,
              parts * NTHREADS);
}

extern "C" int pcdf2d_cuda(float* pdata, long long pstride,
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
