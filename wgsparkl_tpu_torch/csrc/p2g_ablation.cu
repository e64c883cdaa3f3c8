// The P2G ablation probe: the stages of one P2G pass, one thread block per
// job, on the synthetic jobs of ops/ablation.py.
//
// Replaces: tools/ablate_kernels.py `kern` (its pallas_call at :106), the
// TPU probe that times DMA only, + W, + dot and full on 1,002,001 particles.
// Its "full" is kernel A's P2G without the particle CDF: per job, 13
// accumulated features per window node (m v - A x_p, m, the nine A[a][k])
// recombined with the node position (cols 0-2 momentum, 3 mass); its
// "full2" is the same function with another layout of the MXU product, so
// STAGE_FULL covers both.  Each stage includes the ones before it:
//   STAGE_LOAD     the job's 16 P2G rows (position, velocity, mass, affine
//                  rows) into shared memory; the tile is made of them;
//   STAGE_WEIGHTS  + each particle's stencil axis weights and 13 features
//                  in its record (the lists core also buckets and sorts the
//                  chunk); the tile is made of the records;
//   STAGE_ACC      + the 13 node sums; the tile is made of them;
//   STAGE_FULL     + the recombination epilogue (kernel A's tile).
// Three cores run the same stages on the same inputs:
//   scan   the node loop kernels A and F ran before their redesign: chunks
//          of 256 particles, 256 threads, every window node tests every
//          particle of the chunk for stencil membership, its sums carried
//          in shared memory from chunk to chunk;
//   lists  kernel A's core (transfer.cuh): a stable counting sort by base
//          cell, 384 threads, one per window node, each walking its 27
//          offsets' buckets (list_walk) with its sums in registers;
//   pairs  the lists core's sort and records, with one thread per two
//          z-neighbour window nodes walking their buckets together
//          (list_walk_pair): each record read serves both nodes; 180 of the
//          384 threads walk.
// Bound on the H100: instruction throughput and shared-memory reads (the same
// device bytes as kernel A's P2G: 16 rows in per particle, a 360 x 8 tile
// out per job).  Each core's full stage sums every node in that core's
// order (lists and pairs: the same order), which the plain version follows
// (ops/ablation.py), so it equals the plain version bit for bit.
#include "transfer.cuh"

#define STAGE_LOAD 0
#define STAGE_WEIGHTS 1
#define STAGE_ACC 2
#define STAGE_FULL 3

// Record fields, field-major with stride rs.  The load stage keeps the 16
// rows as read; the later stages keep the P2G record (transfer.cuh), and
// the scan core the base cell relative to the block after it (+8 per axis,
// 8 bits each, raw bits).  The lists kernel serves both list cores.
#define R_BASE REC_P2G
#define PREC_LISTS REC_P2G
#define PREC_SCAN (REC_P2G + 1)
#define SCAN_THREADS 256

// Tile row of node n: the stage's output.  rec/q: a record of the last
// chunk (load and weights stages); acc: the node's sums; xn: its position.
template <int STAGE>
__device__ __forceinline__ void tile_row(const float* rec, int rs, int q,
                                         const float acc[13], const float xn[3],
                                         float row[8]) {
  for (int c = 0; c < 8; ++c) {
    if (STAGE == STAGE_LOAD) {
      row[c] = rec[c * rs + q] + rec[(8 + c) * rs + q];
    } else if (STAGE == STAGE_WEIGHTS) {
      row[c] = rec[(REC_W + c) * rs + q] + rec[(REC_F + c) * rs + q];
      if (c < 5) row[c] += rec[(REC_F + 8 + c) * rs + q];
      if (c == 0) row[c] += rec[(REC_W + 8) * rs + q];
    } else if (STAGE == STAGE_ACC) {
      row[c] = acc[c] + (c < 5 ? acc[8 + c] : 0.0f);
    } else {
      row[c] = c < 3 ? acc[c] + xn[0] * acc[4 + c] + xn[1] * acc[7 + c]
                           + xn[2] * acc[10 + c]
                     : (c == 3 ? acc[3] : 0.0f);
    }
  }
}

template <int STAGE>
__global__ void __launch_bounds__(SCAN_THREADS) ablation_scan_kernel(
    const float* __restrict__ pdata, long long pstride, const int* __restrict__ starts,
    const int* __restrict__ lens, const int* __restrict__ bcells, int wsh1, int wsh2,
    int wvol, int wpad, float h, float inv_h, float* __restrict__ out) {
  __shared__ float s_acc[WV_MAX * 13];
  extern __shared__ float s_rec[];
  const int j = blockIdx.x, tid = threadIdx.x;
  const int start = starts[j], len = lens[j];
  const int bc[3] = {bcells[3 * j], bcells[3 * j + 1], bcells[3 * j + 2]};
  float* tile = out + (long long)j * wpad * 8;
  if (len == 0) {
    for (int k = tid; k < wpad * 8; k += SCAN_THREADS) tile[k] = 0.0f;
    return;
  }
  for (int n = tid; n < wvol; n += SCAN_THREADS)
    for (int c = 0; c < 13; ++c) s_acc[n * 13 + c] = 0.0f;
  int cnt = 0;
  for (int c0 = 0; c0 < len; c0 += SCAN_THREADS) {
    cnt = min(SCAN_THREADS, len - c0);
    if (tid < cnt) {
      float r16[16];
      load_rows(pdata, pstride, (long long)start + c0 + tid, r16);
      float* r = s_rec + tid;
      if (STAGE == STAGE_LOAD) {
        for (int f = 0; f < 16; ++f) r[f * SCAN_THREADS] = r16[f];
      } else {
        float wa[3][3];
        int bl[3];
        p2g_record(r16, bc, inv_h, r, SCAN_THREADS, wa, bl);
        r[R_BASE * SCAN_THREADS] =
            __int_as_float(((bl[0] + 8) << 16) | ((bl[1] + 8) << 8) | (bl[2] + 8));
      }
    }
    __syncthreads();
    if (STAGE >= STAGE_ACC) {
      for (int n = tid; n < wvol; n += SCAN_THREADS) {
        const int nx = n / (wsh1 * wsh2), ny = (n / wsh2) % wsh1, nz = n % wsh2;
        float acc[13];
        for (int f = 0; f < 13; ++f) acc[f] = s_acc[n * 13 + f];
        for (int q = 0; q < cnt; ++q) {
          const float* r = s_rec + q;
          const int pb = __float_as_int(r[R_BASE * SCAN_THREADS]);
          const unsigned dx = (unsigned)(nx - ((pb >> 16) - 8));
          const unsigned dy = (unsigned)(ny - (((pb >> 8) & 255) - 8));
          const unsigned dz = (unsigned)(nz - ((pb & 255) - 8));
          if (dx > 2u || dy > 2u || dz > 2u) continue;
          const float w = (r[(REC_W + dx) * SCAN_THREADS]
                           * r[(REC_W + 3 + dy) * SCAN_THREADS])
                          * r[(REC_W + 6 + dz) * SCAN_THREADS];
          for (int f = 0; f < 13; ++f) acc[f] = acc[f] + w * r[(REC_F + f) * SCAN_THREADS];
        }
        for (int f = 0; f < 13; ++f) s_acc[n * 13 + f] = acc[f];
      }
      __syncthreads();
    }
  }
  for (int n = tid; n < wpad; n += SCAN_THREADS) {
    float row[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (n < wvol) {
      float xn[3];
      node_pos(n, wsh1, wsh2, bc, h, xn);
      tile_row<STAGE>(s_rec, SCAN_THREADS, n % cnt, &s_acc[n * 13], xn, row);
    }
    for (int c = 0; c < 8; ++c) tile[n * 8 + c] = row[c];
  }
}

// NPT window nodes per thread: 1 walks one node (list_walk, the lists
// core), 2 walks two z-neighbours together (list_walk_pair, the pairs core).
template <int STAGE, int NPT>
__global__ void __launch_bounds__(LIST_THREADS, 2) ablation_lists_kernel(
    const float* __restrict__ pdata, long long pstride, const int* __restrict__ starts,
    const int* __restrict__ lens, const int* __restrict__ bcells, int wsh1, int wsh2,
    int wvol, int wpad, float h, float inv_h, int chunk, float* __restrict__ out) {
  __shared__ ListScratch s_list;
  extern __shared__ float s_rec[];
  const int j = blockIdx.x, tid = threadIdx.x;
  const int start = starts[j], len = lens[j];
  const int bc[3] = {bcells[3 * j], bcells[3 * j + 1], bcells[3 * j + 2]};
  float* tile = out + (long long)j * wpad * 8;
  if (len == 0) {
    for (int k = tid; k < wpad * 8; k += LIST_THREADS) tile[k] = 0.0f;
    return;
  }
  const int n0 = tid * NPT;
  float acc[NPT][13];
  for (int i = 0; i < NPT; ++i)
    for (int f = 0; f < 13; ++f) acc[i][f] = 0.0f;
  int cnt = 0;
  for (int c0 = 0; c0 < len; c0 += chunk) {
    cnt = min(chunk, len - c0);
    const long long lane0 = (long long)start + c0;
    if (STAGE == STAGE_LOAD) {
      for (int i = tid; i < cnt; i += LIST_THREADS) {
        float r16[16];
        load_rows(pdata, pstride, lane0 + i, r16);
        for (int f = 0; f < 16; ++f) s_rec[f * chunk + i] = r16[f];
      }
      __syncthreads();
      continue;
    }
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
      float r16[16];
      load_rows(pdata, pstride, lane0 + i, r16);
      float wa[3][3];
      int bl[3];
      p2g_record(r16, bc, inv_h, s_rec + s_list.pos[i], chunk, wa, bl);
    }
    __syncthreads();
    if (STAGE >= STAGE_ACC) {
      if (n0 < wvol) {
        auto add = [&](float* a, int k, float w) {
          for (int f = 0; f < 13; ++f) a[f] = a[f] + w * s_rec[(REC_F + f) * chunk + k];
        };
        if constexpr (NPT == 1) {
          list_walk(n0, wsh1, wsh2, s_list.start, s_rec + REC_W * chunk, chunk,
                    [&](int k, float w) { add(acc[0], k, w); });
        } else {
          list_walk_pair(n0, wsh1, wsh2, s_list.start, s_rec + REC_W * chunk, chunk,
                         [&](int k, bool lo, float w_lo, bool hi, float w_hi) {
            if (lo) add(acc[0], k, w_lo);
            if (hi) add(acc[1], k, w_hi);
          });
        }
      }
      __syncthreads();
    }
  }
  for (int i = 0; i < NPT; ++i) {
    const int n = n0 + i;
    if (n >= wpad) break;
    float row[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (n < wvol) {
      float xn[3];
      node_pos(n, wsh1, wsh2, bc, h, xn);
      tile_row<STAGE>(s_rec, chunk, n % cnt, acc[i], xn, row);
    }
    float4* o = reinterpret_cast<float4*>(tile + n * 8);
    o[0] = make_float4(row[0], row[1], row[2], row[3]);
    o[1] = make_float4(row[4], row[5], row[6], row[7]);
  }
}

template <int STAGE, int NPT>
static int launch_lists(const float* pdata, long long pstride, const int* starts,
                        const int* lens, const int* bcells, int maxj, int wsh1, int wsh2,
                        int wvol, int wpad, float h, float inv_h, int chunk, float* out,
                        cudaStream_t stream) {
  const int shm = (STAGE == STAGE_LOAD ? 16 : PREC_LISTS) * chunk * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(ablation_lists_kernel<STAGE, NPT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, shm);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ablation_lists_kernel<STAGE, NPT>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  ablation_lists_kernel<STAGE, NPT><<<(unsigned)maxj, LIST_THREADS, shm, stream>>>(
      pdata, pstride, starts, lens, bcells, wsh1, wsh2, wvol, wpad, h, inv_h, chunk, out);
  return (int)cudaGetLastError();
}

template <int STAGE>
static int launch_stage(int core, const float* pdata, long long pstride,
                        const int* starts, const int* lens, const int* bcells,
                        int maxj, int wsh1, int wsh2, int wvol, int wpad, float h,
                        float inv_h, int chunk, float* out, cudaStream_t stream) {
  if (core == 1)
    return launch_lists<STAGE, 1>(pdata, pstride, starts, lens, bcells, maxj, wsh1, wsh2,
                                  wvol, wpad, h, inv_h, chunk, out, stream);
  if (core == 2)
    return launch_lists<STAGE, 2>(pdata, pstride, starts, lens, bcells, maxj, wsh1, wsh2,
                                  wvol, wpad, h, inv_h, chunk, out, stream);
  // Static (~19 KB) plus dynamic (~24 KB) shared memory: under 48 KB.
  const int shm = PREC_SCAN * SCAN_THREADS * (int)sizeof(float);
  ablation_scan_kernel<STAGE><<<(unsigned)maxj, SCAN_THREADS, shm, stream>>>(
      pdata, pstride, starts, lens, bcells, wsh1, wsh2, wvol, wpad, h, inv_h, out);
  return (int)cudaGetLastError();
}

// core: 0 scan, 1 lists, 2 pairs; stage: STAGE_LOAD .. STAGE_FULL; chunk: the lists
// core's particles per sort, min(group, LIST_CHUNK).
extern "C" int p2g_ablation_cuda(const float* pdata, long long pstride,
                                 const int* starts, const int* lens, const int* bcells,
                                 long long maxj, long long by, float h, float inv_h,
                                 long long core, long long stage, long long chunk,
                                 float* out, cudaStream_t stream) {
  typedef int (*Launch)(int, const float*, long long, const int*, const int*,
                        const int*, int, int, int, int, int, float, float, int,
                        float*, cudaStream_t);
  static const Launch launches[4] = {launch_stage<STAGE_LOAD>, launch_stage<STAGE_WEIGHTS>,
                                     launch_stage<STAGE_ACC>, launch_stage<STAGE_FULL>};
  const int wsh1 = (int)by + 2, wsh2 = 6;
  const int wvol = 6 * wsh1 * wsh2, wpad = (wvol + 7) / 8 * 8;
  if (wvol > WV_MAX || chunk < 1 || chunk > LIST_CHUNK || core < 0 || core > 2 ||
      stage < 0 || stage > STAGE_FULL)
    return (int)cudaErrorInvalidValue;
  if (maxj == 0) return 0;
  return launches[stage]((int)core, pdata, pstride, starts, lens, bcells, (int)maxj,
                         wsh1, wsh2, wvol, wpad, h, inv_h, (int)chunk, out, stream);
}
