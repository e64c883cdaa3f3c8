// Fused particle CDF + CPIC P2G, one thread block per job.
//
// Replaces: wgsparkl_tpu/ops/pallas_cdf.py `_p2g_cdf_kernel` (launched by
// `p2g_cdf_tiles`) with its body `_pcdf_body`: per job of up to `group`
// sorted particles of one 4 x by x 4 block, the particle CDF (affinity union
// over the 3^3 stencil, sign votes with temporal persistence, 4x4 MLS solve
// for signed distance and normal), the compatibility-masked APIC P2G of
// momentum and mass into the job's window tile, and at gate level 2 the
// ghost-velocity impulses reduced per collider.  The window node CDF is
// the gathered static channels, merged at level 2 with the moving colliders
// (`_merge_ntile_cdf`), or in chan-free mode every analytic collider (cuboid,
// ball, capsule, halfspace) evaluated at the window nodes, the static ones
// at level 1 and all at level 2 (`_moving_node_cdf`, `lvl1_cdf` / `lvl2_cdf`,
// pallas_cdf.py:391-408), with no tile read.
// Bound on the H100: instruction throughput and shared-memory reads.  Device
// traffic is small (24 rows in, 6 rows and one 360 x 8 tile out per job:
// ~0.15 GB per substep at 1M particles); each particle runs ~27 x (nc + 14)
// multiply-adds for the CDF and forms 27 (node, particle) pairs of 13
// multiply-adds each, every pair reading its particle's 16-word record.
// Design: one thread per window node (LIST_THREADS = 384 >= 360 nodes), so a
// node's CDF channels, body velocity and 13 P2G accumulators stay in that
// thread's registers for the whole job.  Particles go in chunks of up to
// LIST_CHUNK (the whole job at group <= 1024): each is bucketed by its
// stencil base cell and placed by a stable counting sort (transfer.cuh,
// the `lists` core; one sort per job, so each bucket holds ~8 particles
// at by = 8 and the walk's bucket overhead is paid once); one thread per
// particle leaves a 24-word record at its sorted position in dynamic shared
// memory (the P2G record of transfer.cuh, which the P2G ablation probe
// times, then its affinity word and index in the chunk) and computes its
// CDF on the same stencil; then each node walks its 27 offsets and their
// buckets (`list_walk`).  The parent design tested every particle of a 256-particle
// chunk at every node (360 x 1024 tests per job, 7.5% hits) in two passes of
// 256 threads, the second with 104 working.  Every sum keeps a fixed order
// (offsets in stencil order, particles in particle order within each), which
// the plain version follows (ops/p2g_cdf.py), so the kernel is
// deterministic and equal to it bit for bit: shared-memory atomics would sum
// in a different order on every run, and the Drucker-Prager return map near
// its cone tip turns that f32 roundoff into ~1e-4 of F.  Two blocks fit an
// SM (~112 KB of shared memory each at group 1024).  Each job writes only
// its own lanes [start, start + len): CUDA blocks run in no order, so the TPU
// kernel's sequential-grid handoff of each job's padded tail does not carry
// over.  Impulses go to per-job partials summed in job order by a second
// launch, so the result does not depend on block scheduling either.
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
// ([PREC][chunk], indexed by position in bucket order): the P2G record
// (transfer.cuh: axis weights, the 13 P2G features), then the affinity word
// (raw bits) and the particle's index in the chunk (raw bits; the level-2
// pairs read its velocity from pdata and its normal back from pcdf).
#define R_AFF REC_P2G
#define R_IDX (REC_P2G + 1)
#define PREC (REC_P2G + 2)

__global__ void __launch_bounds__(LIST_THREADS, 2) p2g_cdf_kernel(
    const float* __restrict__ pdata, long long pstride,
    const float* __restrict__ ntiles, const float* __restrict__ bt,
    const int* __restrict__ jt, int maxj, int wsh1, int wsh2, int wvol, int wpad,
    int nc, unsigned moving, unsigned statics, unsigned shapes, int chan_free,
    float h, float inv_h, float cap, int chunk,
    float* __restrict__ mm, float* __restrict__ part, float* pcdf,
    long long ostride) {
  __shared__ uint32_t s_naff[WV_MAX];
  __shared__ float s_cl[WV_MAX], s_dist[WV_MAX], s_d[WV_MAX * 3];
  __shared__ ListScratch s_list;
  extern __shared__ float s_rec[];
  const int j = blockIdx.x, tid = threadIdx.x;
  const int start = jt[j], len = jt[maxj + j], lvl = jt[5 * maxj + j];
  const int bc[3] = {jt[2 * maxj + j], jt[3 * maxj + j], jt[4 * maxj + j]};
  float* tile = mm + (long long)j * wpad * 8;
  float* pj = part + (long long)j * 96;
  if (len == 0) {
    for (int k = tid; k < wpad * 8; k += LIST_THREADS) tile[k] = 0.0f;
    for (int k = tid; k < 96; k += LIST_THREADS) pj[k] = 0.0f;
    return;
  }
  // Window node `tid`: its CDF channels and body velocity.
  const bool is_node = tid < wvol;
  uint32_t naff = 0u;
  float cl = -1.0f, xn[3] = {0.0f, 0.0f, 0.0f}, bv[3] = {0.0f, 0.0f, 0.0f};
  if (is_node) {
    node_pos(tid, wsh1, wsh2, bc, h, xn);
    if (lvl >= 1) {
      float dist;
      window_node_cdf(chan_free ? nullptr : ntiles + ((long long)j * wpad + tid) * 4,
                      bt, lvl, moving, statics, shapes, xn, cap, &naff, &cl, &dist);
      s_naff[tid] = naff;
      s_cl[tid] = cl;
      s_dist[tid] = dist;
      if (lvl >= 2) node_body_velocity(cl, xn, bt, nc, bv);
    }
  }
  float acc[13], d[3] = {0.0f, 0.0f, 0.0f};
  for (int f = 0; f < 13; ++f) acc[f] = 0.0f;

  const float offs[3] = {(float)bc[0] * h, (float)bc[1] * h, (float)bc[2] * h};
  for (int c0 = 0; c0 < len; c0 += chunk) {
    const int cnt = min(chunk, len - c0);
    const long long lane0 = (long long)start + c0;
    for (int i = tid; i < cnt; i += LIST_THREADS) {
      const float p[3] = {pdata[PX * pstride + lane0 + i],
                          pdata[(PX + 1) * pstride + lane0 + i],
                          pdata[(PX + 2) * pstride + lane0 + i]};
      int bl[3];
      stencil_base(p, bc, inv_h, bl);
      s_list.key[i] = (unsigned short)list_bucket(bl, wsh1, wsh2, wvol);
    }
    __syncthreads();
    if (tid < 32) list_sort_warp(&s_list, cnt, wvol);
    __syncthreads();

    for (int i = tid; i < cnt; i += LIST_THREADS) {
      const long long lane = lane0 + i;
      // The particle's record for the node-side P2G, at its sorted
      // position; its stencil serves the CDF.
      float r16[16];
      load_rows(pdata, pstride, lane, r16);
      float* rec = s_rec + s_list.pos[i];
      Stencil st;
      {
        float wa[3][3];
        int bl[3];
        p2g_record(r16, bc, inv_h, rec, chunk, wa, bl);
        stencil_from_axes(wa, bl, wsh1, wsh2, &st);
      }
      const float p[3] = {r16[PX], r16[PX + 1], r16[PX + 2]};

      uint32_t aff = 0;
      float sd = 0.0f, nrm[3] = {0.0f, 0.0f, 0.0f};
      if (lvl >= 1) {
        uint32_t prev = aff_word(pdata[AFF * pstride + lane],
                                 pdata[AFF_SPARE * pstride + lane]);
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

      rec[R_AFF * chunk] = __uint_as_float(aff);
      rec[R_IDX * chunk] = __int_as_float(i);
    }
    __syncthreads();

    // Compatibility-masked APIC P2G (+ level-2 impulse pairs): node `tid`
    // walks its lists.  The level-2 branch reads the particle's velocity
    // from pdata and its normal from the pcdf rows written above (visible
    // to the block after the barrier).
    if (is_node) {
      list_walk(tid, wsh1, wsh2, s_list.start, s_rec + REC_W * chunk, chunk,
                [&](int k, float w) {
        const uint32_t paff = __float_as_uint(s_rec[R_AFF * chunk + k]);
        if (lvl == 0 || compat(naff, paff)) {
          for (int f = 0; f < 13; ++f) acc[f] = acc[f] + w * s_rec[(REC_F + f) * chunk + k];
        } else if (lvl >= 2 && cl >= 0.0f) {
          const long long q = lane0 + __float_as_int(s_rec[R_IDX * chunk + k]);
          float vq[3], nq[3], g[3];
          for (int a = 0; a < 3; ++a) {
            vq[a] = pdata[(VX + a) * pstride + q];
            nq[a] = pcdf[(2 + a) * ostride + q];
          }
          const float wi = w * s_rec[(REC_F + 3) * chunk + k];
          ghost_velocity(vq, bv, nq, g);
          for (int a = 0; a < 3; ++a) d[a] = d[a] + wi * (vq[a] - g[a]);
        }
      });
    }
    __syncthreads();
  }

  // Tile row `tid`: momentum recombined with the node position, mass.
  if (tid < wpad) {
    float row[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (is_node) {
      for (int c = 0; c < 3; ++c)
        row[c] = acc[c] + xn[0] * acc[4 + c] + xn[1] * acc[7 + c] + xn[2] * acc[10 + c];
      row[3] = acc[3];
      for (int k = 0; k < 3; ++k) s_d[tid * 3 + k] = d[k];
    }
    float4* out = reinterpret_cast<float4*>(tile + tid * 8);
    out[0] = make_float4(row[0], row[1], row[2], row[3]);
    out[1] = make_float4(row[4], row[5], row[6], row[7]);
  }
  __syncthreads();
  if (tid < 16) {
    const int b = tid;
    float db[3] = {0.0f, 0.0f, 0.0f}, cb[3] = {0.0f, 0.0f, 0.0f};
    if (lvl >= 2 && b < nc) {
      for (int n = 0; n < wvol; ++n) {
        if (s_cl[n] != (float)b) continue;
        const float* dn = &s_d[n * 3];
        float x[3];
        node_pos(n, wsh1, wsh2, bc, h, x);
        db[0] = db[0] + dn[0];
        db[1] = db[1] + dn[1];
        db[2] = db[2] + dn[2];
        cb[0] = cb[0] + (dn[1] * x[2] - dn[2] * x[1]);
        cb[1] = cb[1] + (dn[2] * x[0] - dn[0] * x[2]);
        cb[2] = cb[2] + (dn[0] * x[1] - dn[1] * x[0]);
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

// chunk: particles per list sort, min(group, LIST_CHUNK); a job of len <=
// group then sorts in chunks of LIST_CHUNK, the plain version's order.
// moving / statics: slot masks; shapes: shape types, 2 bits a slot;
// chan_free: ntiles is not read.
extern "C" int p2g_cdf_cuda(const float* pdata, long long pstride,
                            const float* ntiles, const float* bt, const int* jt,
                            long long maxj, long long by, long long nc,
                            long long moving, long long statics, long long shapes,
                            long long chan_free, float h, float inv_h, float cap,
                            long long chunk, float* mm, float* part, float* imp,
                            float* pcdf, long long ostride, cudaStream_t stream) {
  int wsh1 = (int)by + 2, wsh2 = 6;
  int wvol = 6 * wsh1 * wsh2, wpad = (wvol + 7) / 8 * 8;
  if (chunk < 1 || chunk > LIST_CHUNK || wpad > LIST_THREADS)
    return (int)cudaErrorInvalidValue;
  const int shm = PREC * (int)chunk * (int)sizeof(float);
  if (maxj > 0) {
    // Static (~14 KB) plus dynamic (96 KB at chunk 1024) shared memory
    // passes the 48 KB default; two blocks an SM need the largest carveout.
    cudaError_t e = cudaFuncSetAttribute(
        p2g_cdf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shm);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(p2g_cdf_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    p2g_cdf_kernel<<<(unsigned)maxj, LIST_THREADS, shm, stream>>>(
        pdata, pstride, ntiles, bt, jt, (int)maxj, wsh1, wsh2, wvol, wpad,
        (int)nc, (unsigned)moving, (unsigned)statics, (unsigned)shapes,
        (int)chan_free, h, inv_h, cap, (int)chunk, mm, part, pcdf,
        ostride);
    impulse_sum_kernel<<<1, 96, 0, stream>>>(part, (int)maxj, imp);
  }
  return (int)cudaGetLastError();
}
