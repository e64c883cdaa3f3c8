// Window scatter as a pull: every grid row written once, in the order an
// accumulating scatter of the job slots adds it.
//
// Replaces: `ops/blocked.add_rows` over every job slot's window tile
// (`index_put_(accumulate=True)`: a sort of all J x wvol destinations, then a
// serial sum per destination).  Dead slots window the ghost block NB, so the
// ghost's rows took ~7,000-9,000 serial adds each.
// Order: the accumulating scatter sums a row's tiles in ascending (job,
// window node) order, from +0.0, then adds that sum to the zeroed row.  A
// grid block B's node c is window node e * bsh + c of source block B - e
// (e in {0,1}^d, on the grid, e * bsh + c inside the window); the source
// blocks' jobs are consecutive slots in ascending block id, so B sums the
// octants in ascending source id (descending flat offset, ORDER3 / ORDER2)
// and each source's jobs [cum[s-1], min(cum[s], maxj)) in slot order.  The
// ghost sums, per live job in slot order, its octants that leave the grid in
// ascending octant (= window node) order; dead slots' tiles are +0.0, which
// leaves a sum that starts at +0.0 unchanged, so they are skipped.
// Bound on the H100: device-memory bytes, the live tiles' rows read once
// and the grid written once.
// Design: one block a destination grid block, one thread a node, its d + 1
// channels in one 16-byte load a tile row; block 0 is the ghost, started
// first: its threads scan the live jobs' block ids in chunks, compact the
// jobs whose window leaves the grid (in slot order), then each node thread
// sums those jobs' rows.  No sort, no atomics, no zero fill beforehand.
#include <cuda_runtime.h>
#include <stdint.h>

#define PULL_MAX 128   // threads a block at most: the nodes of a block (16 by, 64 in 2D)
#define SCAN_K 16      // live jobs a thread scans in a ghost chunk

// Octants in ascending source id (descending flat offset): 3D octant index
// ex * 4 + ey * 2 + ez, offsets x nb1 * nb2, z nb1, y 1; 2D ex * 2 + ey.
__constant__ int ORDER3[8] = {7, 5, 6, 4, 3, 1, 2, 0};
__constant__ int ORDER2[4] = {3, 2, 1, 0};

template <int DIM>
struct Geo {
  int nb[3], st[3], bsh[3], wsh[3], wst[3];
  __device__ Geo(int nb0, int nb1, int nb2, int by) {
    nb[0] = nb0; nb[1] = nb1; nb[2] = nb2;
    if (DIM == 3) {
      st[0] = nb1 * nb2; st[1] = 1; st[2] = nb1;
      bsh[0] = 4; bsh[1] = by; bsh[2] = 4;
    } else {
      st[0] = nb1; st[1] = 1; st[2] = 0;
      bsh[0] = 8; bsh[1] = 8; bsh[2] = 1;
    }
    for (int a = 0; a < 3; ++a) wsh[a] = bsh[a] + 2;
    wst[DIM - 1] = 1;
    for (int a = DIM - 2; a >= 0; --a) wst[a] = wst[a + 1] * wsh[a + 1];
  }
  __device__ int bit(int o, int a) const { return (o >> (DIM - 1 - a)) & 1; }
};

template <int GCH>
__device__ __forceinline__ void add_row(float* acc, const float* __restrict__ row) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(row));
  acc[0] += v.x;
  acc[1] += v.y;
  acc[2] += v.z;
  if (GCH == 4) acc[3] += v.w;
}

template <int DIM>
__global__ void __launch_bounds__(PULL_MAX) scatter_pull_kernel(
    const float* __restrict__ tiles, const int* __restrict__ block,
    const int* __restrict__ cum, float* __restrict__ grid, int nb0, int nb1,
    int nb2, int by, int maxj, int wpad, int tch) {
  constexpr int NOCT = 1 << DIM, GCH = DIM + 1;    // channels: momentum, mass
  const Geo<DIM> g(nb0, nb1, DIM == 3 ? nb2 : 1, by);
  const int bsd = blockDim.x, t = threadIdx.x;
  const int nbt = nb0 * nb1 * (DIM == 3 ? nb2 : 1);
  // This thread's node: cell c, its window row in octant 0, and the octants
  // whose window holds it (e * bsh + c < wsh on every axis).
  int c[3], w0 = 0;
  {
    int r = t;
    for (int a = DIM - 1; a >= 0; --a) { c[a] = r % g.bsh[a]; r /= g.bsh[a]; }
    for (int a = 0; a < DIM; ++a) w0 += c[a] * g.wst[a];
  }
  unsigned inwin = 0u;
  int wo[NOCT];
#pragma unroll
  for (int o = 0; o < NOCT; ++o) {
    bool in = true;
    int w = w0;
    for (int a = 0; a < DIM; ++a) {
      in = in && (g.bit(o, a) * g.bsh[a] + c[a] < g.wsh[a]);
      w += g.bit(o, a) * g.bsh[a] * g.wst[a];
    }
    wo[o] = w;
    if (in) inwin |= 1u << o;
  }
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const long long tstride = (long long)wpad * tch;

  if (blockIdx.x == 0) {
    // The ghost: the live jobs' octants that leave the grid.
    __shared__ int s_job[PULL_MAX * SCAN_K];
    __shared__ unsigned char s_top[PULL_MAX * SCAN_K];
    __shared__ int s_warp[PULL_MAX / 32];
    const int nlive = min(nbt > 0 ? cum[nbt - 1] : 0, maxj);
    const int lane = t & 31, warp = t >> 5, nwarps = (bsd + 31) >> 5;
    // The warp's lanes: the last warp is partial where bsd is no multiple
    // of 32 (by 1, 3, 5, 7 in 3D).
    const int nlanes = min(32, bsd - (warp << 5));
    const unsigned lanes = nlanes == 32 ? 0xffffffffu : (1u << nlanes) - 1u;
    for (int base = 0; base < nlive; base += bsd * SCAN_K) {
      // Thread t scans slots base + t * SCAN_K .. + SCAN_K - 1: top holds,
      // as octant bits, the axes on which the job's block is the last.
      unsigned tops[SCAN_K];
      int cnt = 0;
#pragma unroll
      for (int k = 0; k < SCAN_K; ++k) {
        const int j = base + t * SCAN_K + k;
        unsigned top = 0u;
        if (j < nlive) {
          const int s = __ldg(block + j);
          for (int a = 0; a < DIM; ++a)
            if ((s / g.st[a]) % g.nb[a] == g.nb[a] - 1) top |= 1u << (DIM - 1 - a);
        }
        tops[k] = top;
        cnt += top != 0u;
      }
      // Exclusive scan of the counts in thread order keeps slot order.
      int incl = cnt;
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(lanes, incl, d);
        if (lane >= d) incl += v;
      }
      if (lane == 31 || t == bsd - 1) s_warp[warp] = incl;
      __syncthreads();
      int off = incl - cnt, total = 0;
      for (int q = 0; q < nwarps; ++q) {
        if (q < warp) off += s_warp[q];
        total += s_warp[q];
      }
#pragma unroll
      for (int k = 0; k < SCAN_K; ++k) {
        if (tops[k] != 0u) {
          s_job[off] = base + t * SCAN_K + k;
          s_top[off] = (unsigned char)tops[k];
          ++off;
        }
      }
      __syncthreads();
      for (int i = 0; i < total; ++i) {
        const unsigned top = s_top[i];
        const float* tile = tiles + (long long)s_job[i] * tstride;
#pragma unroll
        for (int o = 1; o < NOCT; ++o)
          if ((o & top) && (inwin >> o & 1u))
            add_row<GCH>(acc, tile + (long long)wo[o] * tch);
      }
      __syncthreads();
    }
  } else {
    // Grid block B: each octant's source block and its job slots.
    __shared__ int s_lo[NOCT], s_hi[NOCT];
    const int b = blockIdx.x - 1;
    if (t < NOCT) {
      bool on = true;
      int s = b;
      for (int a = 0; a < DIM; ++a) {
        on = on && (b / g.st[a]) % g.nb[a] >= g.bit(t, a);
        s -= g.bit(t, a) * g.st[a];
      }
      int lo = 0, hi = 0;
      if (on) {
        lo = min(s > 0 ? __ldg(cum + s - 1) : 0, maxj);
        hi = min(__ldg(cum + s), maxj);
      }
      s_lo[t] = lo;
      s_hi[t] = hi;
    }
    __syncthreads();
    // Each octant's first job loaded together, then the adds in order.
    float first[NOCT][4];
#pragma unroll
    for (int r = 0; r < NOCT; ++r) {
      const int o = DIM == 3 ? ORDER3[r] : ORDER2[r];
      first[r][0] = first[r][1] = first[r][2] = first[r][3] = 0.0f;
      if ((inwin >> o & 1u) && s_lo[o] < s_hi[o]) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(
            tiles + s_lo[o] * tstride + (long long)wo[o] * tch));
        first[r][0] = v.x; first[r][1] = v.y; first[r][2] = v.z; first[r][3] = v.w;
      }
    }
#pragma unroll
    for (int r = 0; r < NOCT; ++r) {
      const int o = DIM == 3 ? ORDER3[r] : ORDER2[r];
      if (!(inwin >> o & 1u) || s_lo[o] >= s_hi[o]) continue;
      for (int ch = 0; ch < GCH; ++ch) acc[ch] += first[r][ch];
      for (int j = s_lo[o] + 1; j < s_hi[o]; ++j)
        add_row<GCH>(acc, tiles + j * tstride + (long long)wo[o] * tch);
    }
  }
  // The ghost is row block NB, after the grid's.
  const long long row = (long long)(blockIdx.x == 0 ? nbt : blockIdx.x - 1) * bsd + t;
  float* out = grid + row * GCH;
  if (GCH == 4) {
    *reinterpret_cast<float4*>(out) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
    for (int ch = 0; ch < GCH; ++ch) out[ch] = acc[ch];
  }
}

// tiles [maxj, wpad, tch] (tch a multiple of 4), block [maxj] and cum [NB]
// int32 (build_jobs' job blocks and inclusive per-block job sums), grid
// [NB + 1, bsd, dim + 1] (momentum, mass): every row written.
extern "C" int scatter_pull_cuda(const float* tiles, const int* block, const int* cum,
                                 float* grid, long long dim, long long nb0, long long nb1,
                                 long long nb2, long long by, long long maxj,
                                 long long wpad, long long tch, cudaStream_t stream) {
  const unsigned blocks = (unsigned)(nb0 * nb1 * (dim == 3 ? nb2 : 1) + 1);
  if (dim == 3) {
    scatter_pull_kernel<3><<<blocks, 16 * (int)by, 0, stream>>>(
        tiles, block, cum, grid, (int)nb0, (int)nb1, (int)nb2, (int)by, (int)maxj,
        (int)wpad, (int)tch);
  } else {
    scatter_pull_kernel<2><<<blocks, 64, 0, stream>>>(
        tiles, block, cum, grid, (int)nb0, (int)nb1, 1, 8, (int)maxj, (int)wpad,
        (int)tch);
  }
  return (int)cudaGetLastError();
}
