// The dense transfer's G2P with CPIC ghost velocities, one thread per lane;
// one entry point per dimension (dense_g2p3d_cuda, dense_g2p2d_cuda).
//
// Port-only kernel: the JAX package computes it in plain XLA,
// wgsparkl_tpu/ops/transfer.py:132 `g2p`; its plain version is
// wgsparkl_tpu_torch/ops/transfer.py `g2p_plain`, which this kernel follows
// operation by operation, so the two agree bit for bit.
// Per lane: gather the 3^D stencil nodes' velocity (a node off the grid adds
// nothing); at a node whose affinity word is incompatible with the
// particle's, the ghost velocity of its closest body (or the particle's own
// velocity where it has none) takes the grid velocity's place; sum in
// stencil order the velocity w v and the moments (w v_i) (x - p)_j, centred
// on the particle, into the rows kernel C takes (its `centered` mode, which
// also gives every lane its rigid contact velocity).  Lanes past n or past
// the blocked transfer's lane bound write zero velocity and moments.
// Bound on the H100, counted: device memory, the lanes' 5-9 rows read and 16
// (3D) or 8 (2D) rows written, the 27 node gathers a lane mostly L2 hits;
// ~30 flops a node, well below the f32 rate.  No cross-lane sum.
#include "dense.cuh"

template <int D>
__global__ void __launch_bounds__(NTHREADS) dense_g2p_kernel(
    const float* __restrict__ rows, long long npad, int n,
    const float* __restrict__ pcdf, const float* __restrict__ gvel,
    const int* __restrict__ naff, const int* __restrict__ nclosest,
    const float* __restrict__ bt, const int* __restrict__ live, DenseGrid g, int nc,
    float* __restrict__ out) {
  constexpr int K = D == 3 ? 27 : 9;
  constexpr int NR = D == 3 ? 16 : 8;
  long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= npad) return;
  if (l >= n || l >= live[0]) {
    for (int r = 0; r < NR; ++r) out[r * npad + l] = 0.0f;
    return;
  }
  float p[3], v[3], nrm[3];
  for (int a = 0; a < D; ++a) {
    p[a] = rows[a * npad + l];
    v[a] = rows[(D + a) * npad + l];
    nrm[a] = pcdf[(2 + a) * npad + l];
  }
  uint32_t paff = nc > 0 ? aff_word(pcdf[l], pcdf[(2 + D) * npad + l]) : 0u;
  int base[3];
  float wa[3][3];
  stencil_axes<D>(p, g.h, base, wa);
  float vs[3] = {0.f, 0.f, 0.f};
  float s[3][3];
  for (int i = 0; i < D; ++i)
    for (int j = 0; j < D; ++j) s[i][j] = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    bool valid = true;
    long long flat = 0;
    float dpt[3];
    for (int a = 0; a < D; ++a) {
      int c = base[a] + stencil_off<D>(k, a);
      int i = c - g.o[a];
      valid = valid && i >= 0 && i < g.s[a];
      flat = flat * g.s[a] + i;
      dpt[a] = (float)c * g.h - p[a];
    }
    if (!valid) continue;
    float eff[3];
    for (int i = 0; i < D; ++i) eff[i] = gvel[flat * D + i];
    if (nc > 0 && !compat((uint32_t)naff[flat], paff)) {
      int cl = nclosest[flat];
      if (cl >= 0) {
        float cc[3], bv[3];
        for (int a = 0; a < D; ++a) cc[a] = dpt[a] + p[a];
        body_velocity<D>(bt, cl, cc, bv);
        dense_ghost<D>(v, bv, nrm, eff);
      } else {
        for (int i = 0; i < D; ++i) eff[i] = v[i];
      }
    }
    const float w = stencil_weight<D>(wa, k);
    for (int i = 0; i < D; ++i) {
      float we = w * eff[i];
      vs[i] = vs[i] + we;
      for (int j = 0; j < D; ++j) s[i][j] = s[i][j] + we * dpt[j];
    }
  }
  for (int i = 0; i < D; ++i) {
    out[i * npad + l] = vs[i];
    for (int j = 0; j < D; ++j) out[(D + D * i + j) * npad + l] = s[i][j];
  }
  for (int r = D + D * D; r < NR; ++r) out[r * npad + l] = 0.0f;
}

template <int D>
static int launch(const float* rows, long long npad, long long n, const float* pcdf,
                  const float* gvel, const int* naff, const int* nclosest,
                  const float* bt, const int* live, long long s0, long long s1,
                  long long s2, long long o0, long long o1, long long o2, long long nc,
                  float h, float* out, cudaStream_t stream) {
  DenseGrid g{{(int)s0, (int)s1, (int)s2}, {(int)o0, (int)o1, (int)o2}, h};
  unsigned blocks = (unsigned)((npad + NTHREADS - 1) / NTHREADS);
  dense_g2p_kernel<D><<<blocks, NTHREADS, 0, stream>>>(
      rows, npad, (int)n, pcdf, gvel, naff, nclosest, bt, live, g, (int)nc, out);
  return (int)cudaGetLastError();
}

extern "C" int dense_g2p3d_cuda(const float* rows, long long npad, long long n,
                                const float* pcdf, const float* gvel, const int* naff,
                                const int* nclosest, const float* bt, const int* live,
                                long long s0, long long s1, long long s2, long long o0,
                                long long o1, long long o2, long long nc, float h,
                                float* out, cudaStream_t stream) {
  return launch<3>(rows, npad, n, pcdf, gvel, naff, nclosest, bt, live, s0, s1, s2, o0,
                   o1, o2, nc, h, out, stream);
}

extern "C" int dense_g2p2d_cuda(const float* rows, long long npad, long long n,
                                const float* pcdf, const float* gvel, const int* naff,
                                const int* nclosest, const float* bt, const int* live,
                                long long s0, long long s1, long long s2, long long o0,
                                long long o1, long long o2, long long nc, float h,
                                float* out, cudaStream_t stream) {
  return launch<2>(rows, npad, n, pcdf, gvel, naff, nclosest, bt, live, s0, s1, s2, o0,
                   o1, o2, nc, h, out, stream);
}
