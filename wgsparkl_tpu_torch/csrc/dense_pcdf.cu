// The dense transfer's particle CDF, one thread per lane; one entry point per
// dimension (dense_pcdf3d_cuda, dense_pcdf2d_cuda).
//
// Port-only kernel: the JAX package computes it in plain XLA,
// wgsparkl_tpu/collision/cdf.py:166 `particle_cdf_update`; its plain version
// is wgsparkl_tpu_torch/collision/cdf.py `particle_cdf_update`, which this
// kernel follows operation by operation (built with -fmad=false, IEEE
// division and sqrt), so the two agree bit for bit.
// Per lane: gather the 3^D stencil nodes' distance and affinity word (a node
// off the grid reads 0 and 0), OR the affinity bits, vote a sign per collider
// (the sum in stencil order of w * (+-1) * dist over the nodes carrying its
// bit; a collider the particle was already affine to keeps its sign), then
// fit the signed distance and normal by weighted least squares over the
// nodes sharing affinity with the particle, solving the (D+1)^2 normal
// equations by the JAX package's explicit cofactor formulas.
// Bound on the H100, counted: device memory for the lanes' 5-6 rows read
// and 8 rows written, plus the 27 node gathers a lane (L2-resident
// neighbours); the ~1k flops of the normal equations and the solve sit well
// below the f32 rate.  Design: scalar per-lane code, the 27 gathered nodes
// kept in registers between the vote and the fit.
#include "dense.cuh"

template <int D>
struct Solve;

template <>
struct Solve<2> {
  __device__ static void run(const float a[3][3], const float b[3], float x[3],
                             float* det_out) {
    float c00 = a[1][1] * a[2][2] - a[1][2] * a[2][1];
    float c01 = a[1][2] * a[2][0] - a[1][0] * a[2][2];
    float c02 = a[1][0] * a[2][1] - a[1][1] * a[2][0];
    float det = a[0][0] * c00 + a[0][1] * c01 + a[0][2] * c02;
    float c10 = a[0][2] * a[2][1] - a[0][1] * a[2][2];
    float c11 = a[0][0] * a[2][2] - a[0][2] * a[2][0];
    float c12 = a[0][1] * a[2][0] - a[0][0] * a[2][1];
    float c20 = a[0][1] * a[1][2] - a[0][2] * a[1][1];
    float c21 = a[0][2] * a[1][0] - a[0][0] * a[1][2];
    float c22 = a[0][0] * a[1][1] - a[0][1] * a[1][0];
    float adj[3][3] = {{c00, c10, c20}, {c01, c11, c21}, {c02, c12, c22}};
    float inv_det = fabsf(det) > 1e-30f ? 1.0f / det : 0.0f;
    for (int i = 0; i < 3; ++i) {
      float acc = adj[i][0] * b[0];
      for (int j = 1; j < 3; ++j) acc = acc + adj[i][j] * b[j];
      x[i] = acc * inv_det;
    }
    *det_out = det;
  }
};

template <>
struct Solve<3> {
  __device__ static void run(const float a[4][4], const float b[4], float x[4],
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
    float adj[4][4] = {
        {a[1][1] * c5 - a[1][2] * c4 + a[1][3] * c3,
         -a[0][1] * c5 + a[0][2] * c4 - a[0][3] * c3,
         a[3][1] * s5 - a[3][2] * s4 + a[3][3] * s3,
         -a[2][1] * s5 + a[2][2] * s4 - a[2][3] * s3},
        {-a[1][0] * c5 + a[1][2] * c2 - a[1][3] * c1,
         a[0][0] * c5 - a[0][2] * c2 + a[0][3] * c1,
         -a[3][0] * s5 + a[3][2] * s2 - a[3][3] * s1,
         a[2][0] * s5 - a[2][2] * s2 + a[2][3] * s1},
        {a[1][0] * c4 - a[1][1] * c2 + a[1][3] * c0,
         -a[0][0] * c4 + a[0][1] * c2 - a[0][3] * c0,
         a[3][0] * s4 - a[3][1] * s2 + a[3][3] * s0,
         -a[2][0] * s4 + a[2][1] * s2 - a[2][3] * s0},
        {-a[1][0] * c3 + a[1][1] * c1 - a[1][2] * c0,
         a[0][0] * c3 - a[0][1] * c1 + a[0][2] * c0,
         -a[3][0] * s3 + a[3][1] * s1 - a[3][2] * s0,
         a[2][0] * s3 - a[2][1] * s1 + a[2][2] * s0}};
    float inv_det = fabsf(det) > 1e-30f ? 1.0f / det : 0.0f;
    for (int i = 0; i < 4; ++i) {
      float acc = adj[i][0] * b[0];
      for (int j = 1; j < 4; ++j) acc = acc + adj[i][j] * b[j];
      x[i] = acc * inv_det;
    }
    *det_out = det;
  }
};

template <int D>
__global__ void __launch_bounds__(NTHREADS) dense_pcdf_kernel(
    const float* __restrict__ rows, long long npad, int n,
    const float* __restrict__ ndist, const int* __restrict__ naff, DenseGrid g,
    int nc, int aff_lo_row, int aff_hi_row, float* __restrict__ out) {
  constexpr int K = D == 3 ? 27 : 9;
  constexpr int P = D + 1;
  long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= npad) return;
  if (l >= n) {
    for (int r = 0; r < 8; ++r) out[r * npad + l] = 0.0f;
    return;
  }
  float p[3] = {0.f, 0.f, 0.f};
  for (int a = 0; a < D; ++a) p[a] = rows[a * npad + l];
  uint32_t prev = aff_word(rows[aff_lo_row * npad + l], rows[aff_hi_row * npad + l]);
  int base[3];
  float wa[3][3];
  stencil_axes<D>(p, g.h, base, wa);

  uint32_t na[K];
  float nd[K];
  uint32_t or_all = 0u;
  float votes[16];
  for (int c = 0; c < nc; ++c) votes[c] = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    bool valid = true;
    long long flat = 0;
    for (int a = 0; a < D; ++a) {
      int i = base[a] + stencil_off<D>(k, a) - g.o[a];
      valid = valid && i >= 0 && i < g.s[a];
      flat = flat * g.s[a] + i;
    }
    na[k] = valid ? (uint32_t)naff[flat] : 0u;
    nd[k] = valid ? ndist[flat] : 0.0f;
    or_all |= na[k];
    float wd = stencil_weight<D>(wa, k) * nd[k];
    for (int c = 0; c < nc; ++c) {
      float term = ((na[k] >> (16 + c)) & 1u) ? -wd : wd;
      votes[c] = votes[c] + (((na[k] >> c) & 1u) ? term : 0.0f);
    }
  }
  uint32_t sign_word = 0u;
  for (int c = 0; c < nc; ++c) {
    bool s = ((prev >> c) & 1u) ? (((prev >> (16 + c)) & 1u) != 0u) : votes[c] < 0.0f;
    sign_word |= (uint32_t)s << c;
  }
  uint32_t paff = (or_all & 0xFFFFu) | (sign_word << 16);

  float qtq[P][P], qtu[P];
  for (int i = 0; i < P; ++i) {
    qtu[i] = 0.0f;
    for (int j = 0; j < P; ++j) qtq[i][j] = 0.0f;
  }
  uint32_t phi = paff >> 16;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    uint32_t combined = na[k] & paff & 0xFFFFu;
    uint32_t sign_diff = ((na[k] >> 16) ^ phi) & combined;
    float sdist = sign_diff == 0u ? nd[k] : -nd[k];
    float wk = combined != 0u ? stencil_weight<D>(wa, k) : 0.0f;
    float pv[P];
    for (int a = 0; a < D; ++a)
      pv[a] = (float)(base[a] + stencil_off<D>(k, a)) * g.h - p[a];
    pv[D] = 1.0f;
    for (int i = 0; i < P; ++i) {
      float wp = wk * pv[i];
      for (int j = 0; j < P; ++j) qtq[i][j] = qtq[i][j] + wp * pv[j];
      qtu[i] = qtu[i] + (wk * sdist) * pv[i];
    }
  }
  float sol[P], det;
  Solve<D>::run(qtq, qtu, sol, &det);
  bool ok = det > 1e-8f;
  float nlen = sol[0] * sol[0];
  for (int i = 1; i < D; ++i) nlen = nlen + sol[i] * sol[i];
  nlen = sqrtf(nlen);
  uint32_t word = ok ? paff : 0u;
  out[l] = (float)(word & 0xFFFFu);
  out[npad + l] = ok ? sol[D] : 0.0f;
  for (int a = 0; a < D; ++a)
    out[(2 + a) * npad + l] = (ok && nlen > 1e-6f) ? sol[a] / fmaxf(nlen, 1e-30f) : 0.0f;
  out[(2 + D) * npad + l] = (float)(word >> 16);
  for (int r = 3 + D; r < 8; ++r) out[r * npad + l] = 0.0f;
}

template <int D>
static int launch(const float* rows, long long npad, long long n, const float* ndist,
                  const int* naff, long long s0, long long s1, long long s2,
                  long long o0, long long o1, long long o2, long long nc, float h,
                  float* out, cudaStream_t stream, int lo, int hi) {
  DenseGrid g{{(int)s0, (int)s1, (int)s2}, {(int)o0, (int)o1, (int)o2}, h};
  unsigned blocks = (unsigned)((npad + NTHREADS - 1) / NTHREADS);
  dense_pcdf_kernel<D><<<blocks, NTHREADS, 0, stream>>>(rows, npad, (int)n, ndist,
                                                        naff, g, (int)nc, lo, hi, out);
  return (int)cudaGetLastError();
}

// Rows AFF / AFF_SPARE of the 3D (16, 20) and 2D (9, 12) row matrices.
extern "C" int dense_pcdf3d_cuda(const float* rows, long long npad, long long n,
                                 const float* ndist, const int* naff, long long s0,
                                 long long s1, long long s2, long long o0, long long o1,
                                 long long o2, long long nc, float h, float* out,
                                 cudaStream_t stream) {
  return launch<3>(rows, npad, n, ndist, naff, s0, s1, s2, o0, o1, o2, nc, h, out,
                   stream, 16, 20);
}

extern "C" int dense_pcdf2d_cuda(const float* rows, long long npad, long long n,
                                 const float* ndist, const int* naff, long long s0,
                                 long long s1, long long s2, long long o0, long long o1,
                                 long long o2, long long nc, float h, float* out,
                                 cudaStream_t stream) {
  return launch<2>(rows, npad, n, ndist, naff, s0, s1, s2, o0, o1, o2, nc, h, out,
                   stream, 9, 12);
}
