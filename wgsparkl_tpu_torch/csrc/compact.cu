// Flagged-lane stream compaction: pack vals[:, lane] of the flagged lanes to
// the front, in lane order, with the lane indices as an extra row; columns
// past the flag count hold 2^24, and ok = total <= cap (the first cap
// flagged lanes are kept when it is false).
//
// Replaces: wgsparkl_tpu/ops/compact.py `_compact_kernel` (launched by
// `compact_flagged`), the TPU's chunked log-shift prefix sum plus one-hot
// MXU packing with a sort to glue the chunks.
// Bound on the H100: launch latency.  The function needs 1 B of flag a
// lane, R * 4 B a flagged lane and (R + 1) * 4 * cap B out: ~1 MB at 1M
// lanes, a few tenths of a microsecond at 3.35 TB/s.
// Design: one launch, one pass (a chained scan with decoupled look-back).
// A block takes a ticket from an atomic counter, so that tiles are numbered
// in the order blocks started and a tile never waits on one that has not
// been scheduled.  Ticket t < T reads tile t (16384 lanes, 32 flags a
// thread in two 16-byte loads), ranks its flags (per-thread bit mask, warp
// and block scans of the counts), publishes its aggregate in its status
// word, looks back over its predecessors' words with one warp (32 words a
// round, up to the nearest inclusive prefix: at most 2 rounds at 1M lanes),
// publishes its own inclusive prefix and writes each flagged lane straight
// to its global rank (tiles of 4096 or 8192 lanes, with 2-4x the look-back
// rounds, were slower on the 3D main path's call: H100,
// tools/torch_kernel_variants.py).  Tickets >= T are fill blocks: each
// waits for the last tile's inclusive prefix (the total) and writes 2^24 to
// its slice of the columns [min(total, cap), cap); the last tile writes ok.  No atomics touch the output, so it is exactly lane
// order.
// Status words and counters start clean on every call with no host work:
// the wrapper keeps them in a zeroed scratch buffer, and the block that
// bumps a done counter last (every block bumps it after its last read of a
// status word, before it writes its output) zeroes them again.  A memset
// launch would cost what the scan saves, and a host-side epoch would go
// stale inside a captured CUDA graph.  A status word is (flag << 30) |
// value with flag 0 not ready, 1 the tile's aggregate, 2 its inclusive
// prefix: one 32-bit store publishes both, so no fence has to order a value
// before its flag; readers spin on a volatile load.
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 512
#define PER_THREAD 32                   // flags a thread: 16 or 32 (16-byte loads)
#define TILE (THREADS * PER_THREAD)     // 16384 lanes a tile
#define FILL 4096                       // columns of the tail a fill block writes
#define ST_AGG (1u << 30)
#define ST_INC (2u << 30)
#define ST_VAL ((1u << 30) - 1u)
#define PAD_VALUE 16777216.0f           // 2^24

// Bump the done counter after the block's last read of a status word;
// true for the block that bumps it last (every block has then read its
// last status word, so that block may zero them all).
__device__ __forceinline__ bool done(unsigned* scratch) {
  __threadfence();
  return atomicAdd(&scratch[1], 1u) == gridDim.x - 1u;
}

// scratch: [0] ticket, [1] done, [2 ..] one status word a tile.
__global__ void __launch_bounds__(THREADS) compact_kernel(
    const float* __restrict__ vals, const uint8_t* __restrict__ flag, int r,
    long long n, long long cap, int ntiles, unsigned* scratch,
    float* __restrict__ out, uint8_t* __restrict__ ok) {
  __shared__ int s_ticket, s_warp[THREADS / 32], s_excl, s_total;
  __shared__ bool s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  volatile unsigned* status = scratch + 2;
  if (tid == 0) s_ticket = (int)atomicAdd(&scratch[0], 1u);
  __syncthreads();
  const int t = s_ticket;

  if (t < ntiles) {
    // ---- a tile: rank its flags ----
    const long long base = (long long)t * TILE + (long long)tid * PER_THREAD;
    unsigned mask = 0u;
    if (base + PER_THREAD <= n && ((uintptr_t)(flag + base) & 15u) == 0u) {
#pragma unroll
      for (int v = 0; v < PER_THREAD / 16; ++v) {
        const uint4 q = reinterpret_cast<const uint4*>(flag + base)[v];
        const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            mask |= (((w[i] >> (8 * b)) & 0xFFu) != 0u ? 1u : 0u) << (16 * v + 4 * i + b);
      }
    } else {
      for (int k = 0; k < PER_THREAD; ++k)
        if (base + k < n && flag[base + k]) mask |= 1u << k;
    }
    const int c = __popc(mask);
    int incl = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xFFFFFFFFu, incl, off);
      if (lane >= off) incl += v;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int v = lane < THREADS / 32 ? s_warp[lane] : 0;
      int wi = v;
#pragma unroll
      for (int off = 1; off < THREADS / 32; off <<= 1) {
        const int u = __shfl_up_sync(0xFFFFFFFFu, wi, off);
        if (lane >= off) wi += u;
      }
      if (lane < THREADS / 32) s_warp[lane] = wi - v;   // exclusive
      const int agg = __shfl_sync(0xFFFFFFFFu, wi, THREADS / 32 - 1);
      // ---- publish the aggregate, look back, publish the prefix ----
      if (lane == 0) status[t] = (t == 0 ? ST_INC : ST_AGG) | (unsigned)agg;
      int excl = 0;
      for (int idx = t - 1; idx >= 0; idx -= 32) {
        const int k = idx - lane;
        unsigned s = ST_INC;                 // before tile 0: a prefix of 0
        if (k >= 0) {
          do { s = status[k]; } while ((s & ~ST_VAL) == 0u);
        }
        const unsigned inc = __ballot_sync(0xFFFFFFFFu, (s & ~ST_VAL) == ST_INC);
        const int stop = inc ? __ffs(inc) - 1 : 31;   // nearest prefix
        int v = lane <= stop ? (int)(s & ST_VAL) : 0;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, off);
        excl += v;
        if (inc) break;
      }
      if (lane == 0) {
        if (t > 0) status[t] = ST_INC | (unsigned)(excl + agg);
        s_excl = excl;
        s_total = excl + agg;
        s_last = done(scratch);
      }
    }
    __syncthreads();
    // ---- write each flagged lane at its global rank ----
    long long rank = (long long)s_excl + s_warp[warp] + (incl - c);
    for (unsigned m = mask; m; m &= m - 1u, ++rank) {
      if (rank >= cap) break;
      const long long ln = base + (__ffs(m) - 1);
      for (int q = 0; q < r; ++q) out[q * cap + rank] = vals[q * n + ln];
      out[(long long)r * cap + rank] = (float)ln;
    }
    if (t == ntiles - 1 && tid == 0) ok[0] = s_total <= cap ? 1 : 0;
  } else {
    // ---- a fill block: 2^24 on its columns past the total ----
    if (tid == 0) {
      unsigned s = ST_INC;                   // no tile: a total of 0
      if (ntiles > 0) {
        do { s = status[ntiles - 1]; } while ((s & ~ST_VAL) != ST_INC);
      }
      s_total = (int)(s & ST_VAL);
      if (ntiles == 0 && t == 0) ok[0] = 1;
      s_last = done(scratch);
    }
    __syncthreads();
    const long long f = t - ntiles;
    const long long lo = f * FILL > s_total ? f * FILL : (long long)s_total;
    const long long hi = (f + 1) * FILL < cap ? (f + 1) * FILL : cap;
    for (long long col = lo + tid; col < hi; col += THREADS)
      for (int q = 0; q <= r; ++q) out[q * cap + col] = PAD_VALUE;
  }

  // ---- the block that bumped the done counter last cleans the scratch ----
  if (s_last) {
    for (int k = tid; k < ntiles; k += THREADS) status[k] = 0u;
    if (tid == 0) {
      scratch[0] = 0u;
      scratch[1] = 0u;
    }
  }
}

extern "C" int compact_flagged_cuda(const float* vals, const uint8_t* flag,
                                    long long r, long long n, long long cap,
                                    unsigned* scratch, float* out, uint8_t* ok,
                                    cudaStream_t stream) {
  const long long ntiles = (n + TILE - 1) / TILE;
  const long long fills = (cap + FILL - 1) / FILL;
  const long long blocks = ntiles + (fills > 0 ? fills : (ntiles == 0 ? 1 : 0));
  if (blocks > 0)
    compact_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(
        vals, flag, (int)r, n, cap, (int)ntiles, scratch, out, ok);
  return (int)cudaGetLastError();
}
