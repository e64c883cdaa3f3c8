// Lane permutation of the channel-major row matrix: out[c, i] = rows[c, perm[i]].
//
// Replaces: wgsparkl_tpu/ops/permute.py `_permute_kernel` (launched by
// `_permute_banded` / `permute_lanes`), the TPU's banded one-hot MXU move
// with shift classes and far-mover exception levels -- all workarounds for
// the TPU having no fast gather.
// Bound on the H100: device-memory bytes, 2 * C * NPAD * 4 B plus the index
// read once (~0.39 GB at C = 48, NPAD = 1M: 0.116 ms at 3.35 TB/s).
// Design: a gather.  Each thread owns LANES = 4 consecutive output lanes:
// one 16-byte load of their perm entries, then for every channel four
// 4-byte gathered loads and one 16-byte store, the channel loop unrolled so
// that several channels' loads are in flight.  So perm is read once (the
// parent kernel re-read it for each of the C channels) and every store is
// a full 16 bytes.  After the per-substep re-sort perm is close to the
// identity, so a warp's gathered loads mostly hit the same few cache
// lines.  One thread per lane group (~980 blocks at NPAD = 1M, more than
// the 132 SMs hold at once): a grid clamped to the blocks that fit at once
// left some threads two groups and others one, and ran slower.  An NPAD
// that is not a multiple of 4 takes a scalar loop.
#include <cuda_runtime.h>
#include <stdint.h>

#define LANES 4
#define THREADS 256

__global__ void __launch_bounds__(THREADS) permute_kernel(
    const float* __restrict__ rows, const int* __restrict__ perm, int c,
    long long npad, float* __restrict__ out) {
  // 16-byte stores need rows of whole groups.
  const long long groups = npad % LANES == 0 ? npad / LANES : 0;
  const long long step = (long long)gridDim.x * THREADS;
  const long long t0 = (long long)blockIdx.x * THREADS + threadIdx.x;
  for (long long g = t0; g < groups; g += step) {
    const int4 p = __ldg(reinterpret_cast<const int4*>(perm) + g);
    const float* r = rows;
    float4* o = reinterpret_cast<float4*>(out + g * LANES);
#pragma unroll 8
    for (int ch = 0; ch < c; ++ch) {
      const float4 v = make_float4(__ldg(r + p.x), __ldg(r + p.y), __ldg(r + p.z),
                                   __ldg(r + p.w));
      *o = v;
      r += npad;
      o += npad / LANES;
    }
  }
  for (long long i = groups * LANES + t0; i < npad; i += step) {
    const int q = perm[i];
    for (int ch = 0; ch < c; ++ch) out[ch * npad + i] = rows[ch * npad + q];
  }
}

extern "C" int permute_lanes_cuda(const float* rows, const int* perm,
                                  long long c, long long npad, float* out,
                                  cudaStream_t stream) {
  if (npad <= 0 || c <= 0) return 0;
  const long long blocks = (npad / LANES + THREADS - 1) / THREADS;
  permute_kernel<<<(unsigned)(blocks > 0 ? blocks : 1), THREADS, 0, stream>>>(
      rows, perm, (int)c, npad, out);
  return (int)cudaGetLastError();
}
