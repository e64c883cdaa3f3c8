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
// Bound on the H100: instruction issue and shared-memory reads.  Device
// traffic is small (16 rows in per particle, a 360 x 8 tile out per job:
// ~0.08 GB per substep at 1M particles, ~0.024 ms); each particle forms up
// to 27 (node, particle) pairs of 13 multiply-adds, each pair reading 13
// words of its particle's record from shared memory.
// Design: kernel A's P2G without the particle CDF, on the `lists` core of
// transfer.cuh.  Particles go in chunks of up to LIST_CHUNK (the whole job
// at group <= 1024): each is bucketed by its stencil base cell and placed by
// a stable counting sort; one thread per particle leaves its P2G record
// (axis weights, m v - A x_p, m, A; in a gated job also its stored affinity
// word and index in the chunk) at its sorted position in dynamic shared
// memory; then one thread per window node walks its 27 offsets' buckets
// (list_walk) with its 13 sums in registers, and the epilogue recombines
// momentum with the node position, as kernel A does.  (Walking two
// z-neighbour nodes a thread, list_walk_pair, doubles each thread's node
// state and spills at two blocks an SM: slower in F, see PERF.md.)  Every
// sum keeps a fixed order (offsets in stencil order, particles in particle
// order within each), which the plain version follows (ops/p2g.py), so the
// kernel is deterministic and equal to it bit for bit.  In a gated job the
// compatible pairs go into the sums and the incompatible pairs of a node
// with a body add w m (v - ghost) to its impulse, reading the particle's
// velocity and normal back from device memory; the per-job impulses are
// reduced per collider over window nodes in node order and summed in job
// order by a second launch (impulse_sum_kernel, transfer.cuh), which the
// collider-free path skips.  Dead jobs write zero tiles.
#include "transfer.cuh"

// Record fields after the P2G record (transfer.cuh), gated jobs only: the
// stored affinity word and the particle's index in the chunk (raw bits).
#define R_AFF REC_P2G
#define R_IDX (REC_P2G + 1)
#define PREC (REC_P2G + 2)

__global__ void __launch_bounds__(LIST_THREADS, 2) p2g_kernel(
    const float* __restrict__ pdata, long long pstride,
    const float* __restrict__ ntiles, const float* __restrict__ bt,
    const int* __restrict__ jt, int maxj, int wsh1, int wsh2, int wvol, int wpad,
    int nc, float h, float inv_h, float* __restrict__ mm, float* __restrict__ part) {
  constexpr int chunk = LIST_CHUNK;
  __shared__ float s_cl[WV_MAX], s_d[WV_MAX * 3];
  __shared__ ListScratch s_list;
  extern __shared__ float s_rec[];
  const int j = blockIdx.x, tid = threadIdx.x;
  const int start = jt[j], len = jt[maxj + j];
  const bool gated = nc > 0 && jt[5 * maxj + j] > 0;
  const int bc[3] = {jt[2 * maxj + j], jt[3 * maxj + j], jt[4 * maxj + j]};
  float* tile = mm + (long long)j * wpad * 8;
  float* pj = part + (long long)j * 96;
  if (len == 0) {
    for (int k = tid; k < wpad * 8; k += LIST_THREADS) tile[k] = 0.0f;
    for (int k = tid; k < 96; k += LIST_THREADS) pj[k] = 0.0f;
    return;
  }
  // Window node `tid`: in a gated job its affinity word, closest body and
  // that body's velocity.
  const bool is_node = tid < wvol;
  uint32_t naff = 0u;
  float cl = -1.0f, xn[3] = {0.0f, 0.0f, 0.0f}, bv[3] = {0.0f, 0.0f, 0.0f};
  if (is_node) {
    node_pos(tid, wsh1, wsh2, bc, h, xn);
    if (gated) {
      const float* t = ntiles + ((long long)j * wpad + tid) * 4;
      naff = aff_word(t[0], t[1]);
      cl = t[2];
      node_body_velocity(cl, xn, bt, nc, bv);
    }
  }
  float acc[13], d[3] = {0.0f, 0.0f, 0.0f};
  for (int f = 0; f < 13; ++f) acc[f] = 0.0f;

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
      float r16[16];
      load_rows(pdata, pstride, lane, r16);
      float* rec = s_rec + s_list.pos[i];
      float wa[3][3];
      int bl[3];
      p2g_record(r16, bc, inv_h, rec, chunk, wa, bl);
      if (gated) {
        rec[R_AFF * chunk] = __uint_as_float(
            aff_word(pdata[AFF * pstride + lane], pdata[AFF_SPARE * pstride + lane]));
        rec[R_IDX * chunk] = __int_as_float(i);
      }
    }
    __syncthreads();

    // Compatible pairs (every pair of an ungated job) into the sums, the
    // incompatible pairs of a gated job's node with a body into its impulse.
    if (is_node) {
      list_walk(tid, wsh1, wsh2, s_list.start, s_rec + REC_W * chunk, chunk,
                [&](int k, float w) {
        if (!gated || compat(naff, __float_as_uint(s_rec[R_AFF * chunk + k]))) {
          for (int f = 0; f < 13; ++f) acc[f] = acc[f] + w * s_rec[(REC_F + f) * chunk + k];
        } else if (cl >= 0.0f) {
          const long long q = lane0 + __float_as_int(s_rec[R_IDX * chunk + k]);
          float vq[3], nq[3], g[3];
          for (int a = 0; a < 3; ++a) {
            vq[a] = pdata[(VX + a) * pstride + q];
            nq[a] = pdata[(NX + a) * pstride + q];
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
      if (gated) {
        s_cl[tid] = cl;
        for (int k = 0; k < 3; ++k) s_d[tid * 3 + k] = d[k];
      }
    }
    float4* out = reinterpret_cast<float4*>(tile + tid * 8);
    out[0] = make_float4(row[0], row[1], row[2], row[3]);
    out[1] = make_float4(row[4], row[5], row[6], row[7]);
  }
  __syncthreads();
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

// Jobs sort in chunks of LIST_CHUNK particles, the plain version's order.
extern "C" int p2g_cuda(const float* pdata, long long pstride,
                        const float* ntiles, const float* bt, const int* jt,
                        long long maxj, long long by, long long nc, float h,
                        float inv_h, float* mm, float* part, float* imp,
                        cudaStream_t stream) {
  const int wsh1 = (int)by + 2, wsh2 = 6;
  const int wvol = 6 * wsh1 * wsh2, wpad = (wvol + 7) / 8 * 8;
  if (wpad > LIST_THREADS) return (int)cudaErrorInvalidValue;
  const int shm = PREC * LIST_CHUNK * (int)sizeof(float);
  if (maxj > 0) {
    // Static (~11 KB) plus dynamic (96 KB) shared memory passes the 48 KB
    // default; two blocks an SM need the largest carveout.
    cudaError_t e = cudaFuncSetAttribute(
        p2g_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shm);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(p2g_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    p2g_kernel<<<(unsigned)maxj, LIST_THREADS, shm, stream>>>(
        pdata, pstride, ntiles, bt, jt, (int)maxj, wsh1, wsh2, wvol, wpad,
        (int)nc, h, inv_h, mm, part);
    // With no collider the impulses are the wrapper's zeros.
    if (nc > 0) impulse_sum_kernel<<<1, 96, 0, stream>>>(part, (int)maxj, imp);
  }
  return (int)cudaGetLastError();
}
