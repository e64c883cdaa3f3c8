// Mesh node-CDF pass: every grid node's distance to the nearest mesh
// primitive (triangle in 3D, segment in 2D) that it projects inside, packed
// with the collider slot into one int32 key, and the OR of the slots'
// affinity and sign bits.
//
// Replaces (port-only: the JAX package has no pallas_call for it):
// wgsparkl_tpu/ops/rigid_cdf.py `mesh_node_cdf` (:89), a lax.scan over a
// block-sorted sample job table that builds one-hot window tiles and
// scatter-min/max-reduces them into the node grid, all to work around the
// TPU's lack of atomics.
// Bound on the H100: device-memory bytes, the two node grids written once
// by their fills (2 x 4 B a node) plus the samples, primitives and vertices
// read once; the work is ~35 f32 operations a (sample, stencil node) pair.
// Design: one thread per sample.  It reads its primitive's world vertices
// once, builds the edges, the normal and its length and the three edge
// normals in registers, then walks its 3^d stencil nodes (x slowest); a
// valid pair issues atomicMin on the node's key and atomicOr on its
// affinity word at the node's block-major address.  Minimum and OR commute,
// so the grid holds the same bits in any thread order: no sort and no job
// table.  Keys are never negative (|d| has no sign bit), so the signed
// minimum orders them as distances.  Every dot, cross and norm is spelled
// out in the plain version's order (ops/rigid_cdf.py mesh_node_cdf_plain),
// the divisions are IEEE and the build has -fmad=false, so the two agree
// bit for bit.  A sample whose base cell lies outside the grid adds
// nothing; a node past the grid's high edge is skipped.
// The sparse domain's entry (mesh_cdf_sparse_cuda; JAX:
// ops/rigid_cdf.py `mesh_node_cdf_sparse` (:235), the same scan addressed
// to the active-slot table) runs the same thread per sample with another
// address: the grid is unbounded, so there is no grid-box test; a sample
// whose block digits leave +-511 (the sentinel key) adds nothing, and a
// stencil node's packed block key is found by binary search in the sorted
// active table act (log2 of ~10^4 slots: 14 probes, from L2), the node
// dropped where its block is not active.  Its address is slot * 64 + its
// row-major cell in the 4^3 block.
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 128
#define SPARSE_HALF 512
#define SPARSE_DIM 1024

struct Grid {
  int shape[3], origin[3], bsh[3], nb[3];
  float h;
};

// Block-major address of node cell c (grid-relative, in range): blocks in
// storage order (x, z, y in 3D with y fastest, x, y in 2D), nodes row-major
// inside a block.
template <int D>
__device__ __forceinline__ long long node_addr(const Grid& g, const int* c) {
  long long blk, inner;
  if (D == 3) {
    const int bx = c[0] / g.bsh[0], by = c[1] / g.bsh[1], bz = c[2] / g.bsh[2];
    blk = ((long long)bx * g.nb[1] * g.nb[2]) + by + (long long)bz * g.nb[1];
    inner = ((long long)(c[0] % g.bsh[0]) * g.bsh[1] + c[1] % g.bsh[1]) * g.bsh[2]
            + c[2] % g.bsh[2];
    return blk * (g.bsh[0] * g.bsh[1] * g.bsh[2]) + inner;
  }
  const int bx = c[0] / g.bsh[0], by = c[1] / g.bsh[1];
  blk = (long long)bx * g.nb[1] + by;
  inner = (long long)(c[0] % g.bsh[0]) * g.bsh[1] + c[1] % g.bsh[1];
  return blk * (g.bsh[0] * g.bsh[1]) + inner;
}

// Floor division by 4 and its remainder, negative cells included.
__device__ __forceinline__ int floor4(int x) { return (x - (x & 3)) / 4; }

// The bounded grid's addressing: the base cell must lie in the grid, a node
// past the grid's high edge is skipped.
struct BoxAddr {
  Grid g;
  __device__ __forceinline__ bool sample_ok(const int* rel) const {
    for (int a = 0; a < 3; ++a)
      if (rel[a] < 0 || rel[a] >= g.shape[a]) return false;
    return true;
  }
  __device__ __forceinline__ long long node(const int* c) const {
    if (c[0] >= g.shape[0] || c[1] >= g.shape[1] || c[2] >= g.shape[2]) return -1;
    return node_addr<3>(g, c);
  }
};

// The sparse domain's: the base block's digits in [0, SPARSE_DIM - 1), a
// node's block looked up in the sorted active table (-1: not active).
struct SlotAddr {
  const int* act;
  int nact;
  __device__ __forceinline__ bool sample_ok(const int* rel) const {
    for (int a = 0; a < 3; ++a) {
      const int dig = floor4(rel[a]) + SPARSE_HALF;
      if (dig < 0 || dig >= SPARSE_DIM - 1) return false;
    }
    return true;
  }
  __device__ __forceinline__ long long node(const int* c) const {
    const int bx = floor4(c[0]), by = floor4(c[1]), bz = floor4(c[2]);
    const int key = ((bx + SPARSE_HALF) * SPARSE_DIM + bz + SPARSE_HALF) * SPARSE_DIM
                    + by + SPARSE_HALF;
    int lo = 0, hi = nact;   // first slot whose key is >= key
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(act + mid) < key) lo = mid + 1; else hi = mid;
    }
    if (lo == nact || __ldg(act + lo) != key) return -1;
    return (long long)lo * 64 + ((c[0] & 3) * 4 + (c[1] & 3)) * 4 + (c[2] & 3);
  }
};

__device__ __forceinline__ void put(int* key, int* word, long long a, float sd,
                                    int cid) {
  const int k = (__float_as_int(fabsf(sd)) & (int)0xFFFFFFF0) | cid;
  atomicMin(key + a, k);
  const unsigned w = (1u << cid) | (sd < 0.0f ? (1u << (cid + 16)) : 0u);
  atomicOr(reinterpret_cast<unsigned*>(word) + a, w);
}

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ void cross3(const float* a, const float* b, float* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

template <class Addr>
__global__ void __launch_bounds__(THREADS) mesh_cdf3_kernel(
    const float* __restrict__ sw, const float* __restrict__ vw,
    const int* __restrict__ prim, const int* __restrict__ cids, long long s, Grid g,
    Addr addr, int* __restrict__ key, int* __restrict__ word) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= s) return;
  int rel[3];
  for (int a = 0; a < 3; ++a)
    rel[a] = (int)rintf(__fdiv_rn(sw[i * 3 + a], g.h)) - 1 - g.origin[a];
  if (!addr.sample_ok(rel)) return;
  const int cid = cids[i];
  float va[3], vb[3], vc[3];
  for (int a = 0; a < 3; ++a) {
    va[a] = vw[(long long)prim[i * 3 + 0] * 3 + a];
    vb[a] = vw[(long long)prim[i * 3 + 1] * 3 + a];
    vc[a] = vw[(long long)prim[i * 3 + 2] * 3 + a];
  }
  float ab[3], ac[3], bc[3], n[3], e1[3], e2[3], e3[3];
  for (int a = 0; a < 3; ++a) {
    ab[a] = vb[a] - va[a];
    ac[a] = vc[a] - va[a];
    bc[a] = vc[a] - vb[a];
  }
  cross3(ab, ac, n);
  const float nlen = __fsqrt_rn(dot3(n, n));
  if (!(nlen > 0.0f)) return;
  cross3(ab, n, e1);
  cross3(bc, n, e2);
  cross3(ac, n, e3);
  const float den = fmaxf(nlen, 1e-30f);
  for (int kx = 0; kx < 3; ++kx) {
    for (int ky = 0; ky < 3; ++ky) {
      for (int kz = 0; kz < 3; ++kz) {
        const int c[3] = {rel[0] + kx, rel[1] + ky, rel[2] + kz};
        const long long at = addr.node(c);
        if (at < 0) continue;
        float ap[3], bp[3], cp[3];
        for (int a = 0; a < 3; ++a) {
          const float x = (float)(c[a] + g.origin[a]) * g.h;
          ap[a] = x - va[a];
          bp[a] = x - vb[a];
          cp[a] = x - vc[a];
        }
        if (!(dot3(e1, ap) <= 0.0f && dot3(e2, bp) <= 0.0f && dot3(e3, cp) >= 0.0f))
          continue;
        put(key, word, at, __fdiv_rn(dot3(n, ap), den), cid);
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS) mesh_cdf2_kernel(
    const float* __restrict__ sw, const float* __restrict__ vw,
    const int* __restrict__ prim, const int* __restrict__ cids, long long s, Grid g,
    int* __restrict__ key, int* __restrict__ word) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= s) return;
  int rel[2];
  for (int a = 0; a < 2; ++a) {
    rel[a] = (int)rintf(__fdiv_rn(sw[i * 2 + a], g.h)) - 1 - g.origin[a];
    if (rel[a] < 0 || rel[a] >= g.shape[a]) return;
  }
  const int cid = cids[i];
  const long long pa = prim[i * 2 + 0], pb = prim[i * 2 + 1];
  const float va0 = vw[pa * 2], va1 = vw[pa * 2 + 1];
  const float ab0 = vw[pb * 2] - va0, ab1 = vw[pb * 2 + 1] - va1;
  const float ab2 = fmaxf(ab0 * ab0 + ab1 * ab1, 1e-30f);
  const float p0 = -ab1, p1 = ab0;
  const float plen = fmaxf(__fsqrt_rn(p0 * p0 + p1 * p1), 1e-30f);
  for (int kx = 0; kx < 3; ++kx) {
    for (int ky = 0; ky < 3; ++ky) {
      const int c[2] = {rel[0] + kx, rel[1] + ky};
      if (c[0] >= g.shape[0] || c[1] >= g.shape[1]) continue;
      const float ap0 = (float)(c[0] + g.origin[0]) * g.h - va0;
      const float ap1 = (float)(c[1] + g.origin[1]) * g.h - va1;
      const float t = __fdiv_rn(ab0 * ap0 + ab1 * ap1, ab2);
      if (!(t > 0.0f && t < 1.0f)) continue;
      put(key, word, node_addr<2>(g, c), __fdiv_rn(p0 * ap0 + p1 * ap1, plen), cid);
    }
  }
}

extern "C" int mesh_cdf_cuda(const float* sw, const float* vw, const int* prim,
                             const int* cids, long long s, long long dim,
                             long long sh0, long long sh1, long long sh2,
                             long long or0, long long or1, long long or2,
                             long long bs0, long long bs1, long long bs2, float h,
                             int* key, int* word, cudaStream_t stream) {
  if (s <= 0) return 0;
  Grid g;
  const long long sh[3] = {sh0, sh1, sh2}, orig[3] = {or0, or1, or2},
                  bs[3] = {bs0, bs1, bs2};
  for (int a = 0; a < 3; ++a) {
    g.shape[a] = (int)sh[a];
    g.origin[a] = (int)orig[a];
    g.bsh[a] = (int)bs[a];
    g.nb[a] = (int)(sh[a] / bs[a]);
  }
  g.h = h;
  const unsigned blocks = (unsigned)((s + THREADS - 1) / THREADS);
  if (dim == 3)
    mesh_cdf3_kernel<<<blocks, THREADS, 0, stream>>>(sw, vw, prim, cids, s, g,
                                                     BoxAddr{g}, key, word);
  else
    mesh_cdf2_kernel<<<blocks, THREADS, 0, stream>>>(sw, vw, prim, cids, s, g, key,
                                                     word);
  return (int)cudaGetLastError();
}

// The sparse domain's pass: key and word hold (amax + 1) x 64 nodes, slot
// by slot; act [nact] the sorted active table.
extern "C" int mesh_cdf_sparse_cuda(const float* sw, const float* vw, const int* prim,
                                    const int* cids, long long s, long long or0,
                                    long long or1, long long or2, float h,
                                    const int* act, long long nact, int* key,
                                    int* word, cudaStream_t stream) {
  if (s <= 0) return 0;
  Grid g = {};
  g.origin[0] = (int)or0;
  g.origin[1] = (int)or1;
  g.origin[2] = (int)or2;
  g.h = h;
  const unsigned blocks = (unsigned)((s + THREADS - 1) / THREADS);
  mesh_cdf3_kernel<<<blocks, THREADS, 0, stream>>>(sw, vw, prim, cids, s, g,
                                                   SlotAddr{act, (int)nact}, key, word);
  return (int)cudaGetLastError();
}
