// The dense transfer's P2G into the whole row-major node grid, with the CPIC
// impulses; one entry point per dimension (dense_p2g3d_cuda,
// dense_p2g2d_cuda), each two launches: the node pass and the impulse
// reduction.
//
// Port-only kernel: the JAX package computes it in plain XLA,
// wgsparkl_tpu/ops/transfer.py:51 `p2g` (a scatter-add over (particle,
// stencil offset) pairs and a segment sum of the impulses); its plain version
// is wgsparkl_tpu_torch/ops/transfer.py `p2g_plain`, which sums in this
// kernel's order, so the two agree bit for bit.
// Design: no float atomics (their order changes from run to run).  The glue
// sorts the lanes stably by stencil base cell (ops/transfer.cell_lists: order
// and each cell's start); one thread a node walks its 3^D stencil offsets in
// order (the last axis fastest) and, within each, the lanes of base cell
// node - offset in lane order, summing momentum and mass of the compatible
// pairs and the impulse of the incompatible pairs whose node has a closest
// body.  A node's impulse goes to that body alone: each 256-node block sums
// the impulses per body by a shared-memory tree into one partial a block
// (zero when no node of the block has a body), and the reduction launch sums
// the partials per (body, component): each of 256 threads a stride of blocks
// in order, then a tree.
// Bound on the H100, counted: device memory, each lane's 16 (3D) or 9 (2D)
// P2G rows and its particle-CDF rows read once and the grid written once;
// the node walk re-reads each lane 3^D times from the caches and recomputes
// its weight per pair (~60 flops a pair, ~27M pairs at 1M particles), which
// is what holds the kernel.
#include "dense.cuh"

#define NODE_BLOCK 256
#define FINAL_THREADS 256

template <int D>
__global__ void __launch_bounds__(NODE_BLOCK) dense_p2g_nodes(
    const float* __restrict__ rows, long long npad, const float* __restrict__ pcdf,
    const int* __restrict__ naff, const int* __restrict__ nclosest,
    const float* __restrict__ bt, const int* __restrict__ order,
    const int* __restrict__ start, DenseGrid g, int nc, float* __restrict__ grid_mm,
    float* __restrict__ part) {
  constexpr int K = D == 3 ? 27 : 9;
  constexpr int C = D + (D == 3 ? 3 : 1);
  __shared__ float sh[C][NODE_BLOCK];
  const int t = threadIdx.x;
  const long long m = (long long)blockIdx.x * NODE_BLOCK + t;
  const bool in = m < g.nodes();
  float mom[3] = {0.f, 0.f, 0.f}, mass = 0.0f, imp[C];
  for (int c = 0; c < C; ++c) imp[c] = 0.0f;
  int cl = -1;
  if (in) {
    int ix[3];
    long long r = m;
    for (int a = D - 1; a >= 0; --a) {
      ix[a] = (int)(r % g.s[a]);
      r /= g.s[a];
    }
    uint32_t nw = 0u;
    if (nc > 0) {
      nw = (uint32_t)naff[m];
      cl = nclosest[m];
    }
    float xn[3];
    for (int a = 0; a < D; ++a) xn[a] = (float)(ix[a] + g.o[a]) * g.h;
#pragma unroll 1
    for (int k = 0; k < K; ++k) {
      long long e = 0;
      for (int a = 0; a < D; ++a) e = e * (g.s[a] + 2) + (ix[a] - stencil_off<D>(k, a) + 2);
      const int j1 = start[e + 1];
#pragma unroll 1
      for (int j = start[e]; j < j1; ++j) {
        const long long l = order[j];
        float p[3], dpt[3], w = 1.0f;
        for (int a = 0; a < D; ++a) {
          p[a] = rows[a * npad + l];
          int o = stencil_off<D>(k, a);
          float x = p[a] / g.h - (float)(ix[a] + g.o[a] - o);
          float wa = axis_weight(x, o);
          w = a == 0 ? wa : w * wa;
          dpt[a] = xn[a] - p[a];
        }
        const float mp = rows[2 * D * npad + l];
        float v[3];
        for (int i = 0; i < D; ++i) v[i] = rows[(D + i) * npad + l];
        bool comp = true;
        if (nc > 0) comp = compat(nw, aff_word(pcdf[l], pcdf[(2 + D) * npad + l]));
        if (comp) {
          for (int i = 0; i < D; ++i) {
            const float* arow = rows + (2 * D + 1 + D * i) * npad + l;
            float acc = arow[0] * dpt[0];
            for (int q = 1; q < D; ++q) acc = acc + arow[q * npad] * dpt[q];
            acc = acc + mp * v[i];
            mom[i] = mom[i] + acc * w;
          }
          mass = mass + w * mp;
        } else if (cl >= 0) {
          float cc[3], bv[3], gh[3], nrm[3], delta[3], lever[3];
          for (int a = 0; a < D; ++a) {
            cc[a] = dpt[a] + p[a];
            nrm[a] = pcdf[(2 + a) * npad + l];
          }
          body_velocity<D>(bt, cl, cc, bv);
          dense_ghost<D>(v, bv, nrm, gh);
          const float wm = w * mp;
          for (int i = 0; i < D; ++i) {
            delta[i] = (v[i] - gh[i]) * wm;
            lever[i] = bt[i * 128 + cl] - cc[i];
            imp[i] = imp[i] + delta[i];
          }
          if (D == 3) {
            imp[3] = imp[3] + (delta[1] * lever[2] - delta[2] * lever[1]);
            imp[4] = imp[4] + (delta[2] * lever[0] - delta[0] * lever[2]);
            imp[5] = imp[5] + (delta[0] * lever[1] - delta[1] * lever[0]);
          } else {
            imp[2] = imp[2] + (delta[0] * lever[1] - delta[1] * lever[0]);
          }
        }
      }
    }
    for (int i = 0; i < D; ++i) grid_mm[m * (D + 1) + i] = mom[i];
    grid_mm[m * (D + 1) + D] = mass;
  }
  if (nc == 0) return;
  float* pb = part + (long long)blockIdx.x * nc * C;
  if (!__syncthreads_or(cl >= 0)) {
    for (int q = t; q < nc * C; q += NODE_BLOCK) pb[q] = 0.0f;
    return;
  }
  for (int b = 0; b < nc; ++b) {
    for (int c = 0; c < C; ++c) sh[c][t] = cl == b ? imp[c] : 0.0f;
    __syncthreads();
    for (int s = NODE_BLOCK / 2; s > 0; s >>= 1) {
      if (t < s)
        for (int c = 0; c < C; ++c) sh[c][t] = sh[c][t] + sh[c][t + s];
      __syncthreads();
    }
    if (t < C) pb[b * C + t] = sh[t][0];
    __syncthreads();
  }
}

// Block (body b, component c) = (blockIdx.x / C, blockIdx.x % C).
__global__ void __launch_bounds__(FINAL_THREADS) dense_p2g_impulses(
    const float* __restrict__ part, int nblk, int nc, int C, float* __restrict__ imp) {
  __shared__ float sh[FINAL_THREADS];
  const int t = threadIdx.x;
  const int b = blockIdx.x / C, c = blockIdx.x % C;
  float acc = 0.0f;
  for (int p = t; p < nblk; p += FINAL_THREADS)
    acc = acc + part[((long long)p * nc + b) * C + c];
  sh[t] = acc;
  __syncthreads();
  for (int s = FINAL_THREADS / 2; s > 0; s >>= 1) {
    if (t < s) sh[t] = sh[t] + sh[t + s];
    __syncthreads();
  }
  if (t == 0) imp[b * C + c] = sh[0];
}

template <int D>
static int launch(const float* rows, long long npad, const float* pcdf, const int* naff,
                  const int* nclosest, const float* bt, const int* order,
                  const int* start, long long s0, long long s1, long long s2,
                  long long o0, long long o1, long long o2, long long nc, float h,
                  float* grid_mm, float* part, float* imp, cudaStream_t stream) {
  constexpr int C = D + (D == 3 ? 3 : 1);
  DenseGrid g{{(int)s0, (int)s1, (int)s2}, {(int)o0, (int)o1, (int)o2}, h};
  const long long nblk = (g.nodes() + NODE_BLOCK - 1) / NODE_BLOCK;
  dense_p2g_nodes<D><<<(unsigned)nblk, NODE_BLOCK, 0, stream>>>(
      rows, npad, pcdf, naff, nclosest, bt, order, start, g, (int)nc, grid_mm, part);
  int err = (int)cudaGetLastError();
  if (err != 0 || nc == 0) return err;
  dense_p2g_impulses<<<(unsigned)(nc * C), FINAL_THREADS, 0, stream>>>(
      part, (int)nblk, (int)nc, C, imp);
  return (int)cudaGetLastError();
}

extern "C" int dense_p2g3d_cuda(const float* rows, long long npad, const float* pcdf,
                                const int* naff, const int* nclosest, const float* bt,
                                const int* order, const int* start, long long s0,
                                long long s1, long long s2, long long o0, long long o1,
                                long long o2, long long nc, float h, float* grid_mm,
                                float* part, float* imp, cudaStream_t stream) {
  return launch<3>(rows, npad, pcdf, naff, nclosest, bt, order, start, s0, s1, s2, o0,
                   o1, o2, nc, h, grid_mm, part, imp, stream);
}

extern "C" int dense_p2g2d_cuda(const float* rows, long long npad, const float* pcdf,
                                const int* naff, const int* nclosest, const float* bt,
                                const int* order, const int* start, long long s0,
                                long long s1, long long s2, long long o0, long long o1,
                                long long o2, long long nc, float h, float* grid_mm,
                                float* part, float* imp, cudaStream_t stream) {
  return launch<2>(rows, npad, pcdf, naff, nclosest, bt, order, start, s0, s1, s2, o0,
                   o1, o2, nc, h, grid_mm, part, imp, stream);
}
