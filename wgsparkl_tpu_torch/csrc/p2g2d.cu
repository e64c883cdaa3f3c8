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
// Bound on the H100: shared-memory reads and instruction issue.  Device
// traffic is small (13 rows in per particle, a 104 x 8 tile out per job:
// ~30 MB per substep at 490k particles, ~0.008 ms); each particle forms 9
// (node, particle) pairs of 7 multiply-adds, each pair reading 9 words of
// its particle's record from shared memory.
// Design: one thread per window node (THREADS2 = 128 >= 100 nodes), so a
// node's affinity word, closest body, body velocity, 7 P2G sums and 2
// impulse sums stay in its thread's registers for the whole job.
// Particles go in chunks of up to CHUNK2 = 256 (a whole job of the 2D
// scenes, which hold 4 particles a cell, 256 a full block).  Each particle
// leaves its record (axis weights, the P2G features m v - A x_p, m, A; in
// a gated job also its velocity, normal and affinity word; its stencil
// base cell) at its index in the chunk, and marks its bit in the bitmask
// of its bucket: the window index of its base cell + 1 per axis, so the
// particles of a bucket are those whose stencil's first node is that
// window node (a warp match gives each bucket of a 32-particle segment its
// word, written by one lane, with no atomic).  A node ORs the masks of the
// 9 buckets its stencil offsets reach and walks the set bits in order:
// exactly its pairs, ~9 x 4 at 4 particles a cell, in particle order, the
// order in which the plain version (ops/transfer2d.py) and the JAX kernel
// sum them.  A walk per offset (the lists order of kernels A and F) moved
// the sums' roundoff, which the 2D collider-free sand column's cone-tip
// particles amplify past the slice tests' tolerance against JAX within 10
// substeps (PERF.md).  Every sum has a fixed order, so the kernel is
// deterministic and equal to its plain version bit for bit with no
// atomics (shared-memory atomics would sum in another order on every run,
// and the Drucker-Prager return map turns that roundoff into F).  ~24 KB
// of shared memory and 63 registers a thread, so eight blocks of 128 share
// an SM with the driver's default carveout (capping the registers at 64
// for that spills instead).  In a gated job the compatible pairs go into
// the sums and the incompatible pairs of a node with a body add w m (v -
// ghost) to its impulse; the per-job impulses are reduced per collider over
// window nodes in node order into imp [MAXJ, 8, 128], as in the TPU kernel,
// and the caller sums them over jobs.  Dead jobs write zero tiles.
#include "transfer2d.cuh"

#define THREADS2 128        // one thread per window node (WVOL = 100)
#define CHUNK2 256          // particles a chunk (ops/rows2d.py P2G_CHUNK)
#define MWORDS (CHUNK2 / 32)

// Particle record of a chunk, field-major ([PREC][CHUNK2]) at the
// particle's index: axis weights wa[a][o] at R_W + 3a + o, the 7 P2G
// features, its bucket (bl[0] + 1) * WSH + bl[1] + 1 (raw bits); in a
// gated job also velocity, normal and the affinity word (raw bits).
#define R_W 0
#define R_F 6
#define R_BUCKET 13
#define R_V 14
#define R_N 16
#define R_AFF 18
#define PREC 19
#define NFEAT 7

__global__ void __launch_bounds__(THREADS2) p2g2d_kernel(
    const float* __restrict__ pdata, long long pstride,
    const float* __restrict__ ntiles, const float* __restrict__ bt,
    const int* __restrict__ jt, int maxj, int nc, unsigned shapes, int chan_free,
    float h, float inv_h, float cap, float* __restrict__ mm,
    float* __restrict__ imp) {
  __shared__ uint32_t s_mask[WVOL * MWORDS];     // bucket b's particles: bit i
  __shared__ float s_rec[PREC * CHUNK2];
  __shared__ float s_cl[WVOL], s_d[WVOL * 2];
  const int j = blockIdx.x, tid = threadIdx.x;
  const int start = jt[j], len = jt[maxj + j], lvl = jt[5 * maxj + j];
  float* tile = mm + (long long)j * WPAD * 8;
  if (len == 0) {
    for (int k = tid; k < WPAD * 8; k += THREADS2) tile[k] = 0.0f;
    return;
  }
  const bool gated = lvl > 0;
  const int bc[2] = {jt[2 * maxj + j], jt[3 * maxj + j]};
  // Window node `tid`: its position and, in a gated job, its affinity word,
  // closest body and that body's velocity.
  const bool is_node = tid < WVOL;
  const int nx = tid / WSH, ny = tid % WSH;
  uint32_t naff = 0u;
  float cl = -1.0f, xw[2] = {0.0f, 0.0f}, bv[2] = {0.0f, 0.0f};
  if (is_node) {
    node_pos2(tid, bc, h, xw);
    if (gated) {
      if (chan_free) {
        float dist;
        window_node_cdf2(bt, nc, shapes, xw, cap, &naff, &cl, &dist);
      } else if (nc > 0) {
        const float* t = ntiles + ((long long)j * WPAD + tid) * 4;
        naff = aff_word(t[0], t[1]);
        cl = t[2];
      }
      node_body_velocity2(cl, xw, bt, nc, bv);
    }
  }
  float acc[NFEAT], d[2] = {0.0f, 0.0f};
  for (int f = 0; f < NFEAT; ++f) acc[f] = 0.0f;

  for (int c0 = 0; c0 < len; c0 += CHUNK2) {
    const int cnt = min(CHUNK2, len - c0);
    const long long lane0 = (long long)start + c0;
    for (int k = tid; k < WVOL * MWORDS; k += THREADS2) s_mask[k] = 0u;
    __syncthreads();
    // Warp w takes particles [i0 + 32 w, i0 + 32 w + 32): one mask word.
    for (int i0 = 0; i0 < cnt; i0 += THREADS2) {
      const int i = i0 + tid;
      int bucket = -1 - (tid & 31);               // no particle: a key of its own
      if (i < cnt) {
        const long long lane = lane0 + i;
        auto row = [&](int r) { return pdata[r * pstride + lane]; };
        const float p[2] = {row(PX), row(PX + 1)};
        const float v[2] = {row(VX), row(VX + 1)};
        const float mass = row(PM);
        const float A[4] = {row(A0), row(A0 + 1), row(A0 + 2), row(A0 + 3)};
        float* r = s_rec + i;
        float wa[2][3];
        int bl[2];
        stencil_axes2(p, bc, inv_h, wa, bl);
        for (int k = 0; k < 6; ++k) r[(R_W + k) * CHUNK2] = wa[k / 3][k % 3];
        r[(R_F + 0) * CHUNK2] = mass * v[0] - (A[0] * p[0] + A[1] * p[1]);
        r[(R_F + 1) * CHUNK2] = mass * v[1] - (A[2] * p[0] + A[3] * p[1]);
        r[(R_F + 2) * CHUNK2] = mass;
        for (int k = 0; k < 4; ++k) r[(R_F + 3 + k) * CHUNK2] = A[k];
        if (gated) {
          for (int k = 0; k < 2; ++k) {
            r[(R_V + k) * CHUNK2] = v[k];
            r[(R_N + k) * CHUNK2] = row(NX + k);
          }
          r[R_AFF * CHUNK2] = __uint_as_float(aff_word(row(AFF), row(AFF_SPARE)));
        }
        // The block sort key (ops/blocked.py particle_sort_keys_ch: round(p
        // / h) - 1 in the job's block) keeps bl in [-1, 8], so bl + 1 lies
        // inside the window; a particle outside it would be dropped, and
        // the plain version (ops/transfer2d.py p2g_plain) raises there.
        const unsigned b0 = (unsigned)(bl[0] + 1), b1 = (unsigned)(bl[1] + 1);
        if (b0 < (unsigned)WSH && b1 < (unsigned)WSH) bucket = (int)(b0 * WSH + b1);
        r[R_BUCKET * CHUNK2] = __int_as_float(bucket);
      }
      const unsigned peers = __match_any_sync(0xFFFFFFFFu, bucket);
      if (bucket >= 0 && (peers & ((1u << (tid & 31)) - 1u)) == 0u)
        s_mask[bucket * MWORDS + (i >> 5)] = peers;
    }
    __syncthreads();

    // Each node walks the particles of its 9 buckets in particle order:
    // compatible pairs (every pair of an ungated job) into the P2G sums,
    // the incompatible pairs of a gated job's node with a body into its
    // impulse.
    if (is_node) {
      for (int wd = 0; wd < (cnt + 31) / 32; ++wd) {
        uint32_t m = 0u;
        for (int ox = 0; ox < 3; ++ox) {
          const unsigned bx = (unsigned)(nx + 1 - ox);
          if (bx >= (unsigned)WSH) continue;
          for (int oy = 0; oy < 3; ++oy) {
            const unsigned by_ = (unsigned)(ny + 1 - oy);
            if (by_ < (unsigned)WSH) m |= s_mask[(bx * WSH + by_) * MWORDS + wd];
          }
        }
        while (m != 0u) {
          const int q = wd * 32 + __ffs(m) - 1;
          m &= m - 1u;
          const float* r = s_rec + q;
          const int pb = __float_as_int(r[R_BUCKET * CHUNK2]);
          const int dx = nx + 1 - pb / WSH, dy = ny + 1 - pb % WSH;
          const float w = r[(R_W + dx) * CHUNK2] * r[(R_W + 3 + dy) * CHUNK2];
          if (!gated || compat(naff, __float_as_uint(r[R_AFF * CHUNK2]))) {
            for (int f = 0; f < NFEAT; ++f) acc[f] = acc[f] + w * r[(R_F + f) * CHUNK2];
          } else if (cl >= 0.0f) {
            const float vq[2] = {r[R_V * CHUNK2], r[(R_V + 1) * CHUNK2]};
            const float nq[2] = {r[R_N * CHUNK2], r[(R_N + 1) * CHUNK2]};
            float g[2];
            ghost_velocity2(vq, bv, nq, g);
            const float wi = w * r[(R_F + 2) * CHUNK2];
            d[0] = d[0] + wi * (vq[0] - g[0]);
            d[1] = d[1] + wi * (vq[1] - g[1]);
          }
        }
      }
    }
    __syncthreads();
  }

  // Window tile row `tid`: cols 0-1 momentum (sum w (m v - A p) + (sum w A)
  // x), 2 mass.
  if (tid < WPAD) {
    float row[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (is_node) {
      for (int c = 0; c < 2; ++c)
        row[c] = acc[c] + acc[3 + 2 * c] * xw[0] + acc[4 + 2 * c] * xw[1];
      row[2] = acc[2];
      s_cl[tid] = cl;
      s_d[2 * tid] = d[0];
      s_d[2 * tid + 1] = d[1];
    }
    float4* out = reinterpret_cast<float4*>(tile + tid * 8);
    out[0] = make_float4(row[0], row[1], row[2], row[3]);
    out[1] = make_float4(row[4], row[5], row[6], row[7]);
  }
  __syncthreads();
  // Impulses per collider, summed over the window nodes in node order; the
  // wrapper zeroes imp, which is what ungated jobs leave.
  if (gated && tid < nc) {
    const int b = tid;
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
    for (int n = 0; n < WVOL; ++n) {
      if (s_cl[n] != (float)b) continue;
      float x[2];
      node_pos2(n, bc, h, x);
      const float d0 = s_d[2 * n], d1 = s_d[2 * n + 1];
      s0 = s0 + d0;
      s1 = s1 + d1;
      s2 = s2 + (d0 * x[1] - d1 * x[0]);
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
    p2g2d_kernel<<<(unsigned)maxj, THREADS2, 0, stream>>>(
        pdata, pstride, ntiles, bt, jt, (int)maxj, (int)nc, (unsigned)shapes,
        (int)chan_free, h, inv_h, cap, mm, imp);
  return (int)cudaGetLastError();
}
