// Elementwise f32 math of csrc/'s rounding contract, one thread per element.
//
// Replaces: tools/probe_mosaic_math.py `kernel`, the TPU probe of in-kernel
// f32 reciprocal, division, sqrt and rsqrt (and their Newton-refined forms)
// and of exp(log(x) / 2); this one adds logf, the call of kernel C's
// neo-Hookean stress.  Built like every kernel of the package (-fmad=false,
// IEEE division and sqrt, no fast math), so what it computes is what the
// engine's kernels compute.
// Bound on the H100: launch latency (2 inputs and 9 outputs of 4096 floats).
// Design: out[k, i] for the k-th expression of x[i], y[i], in the order and
// association of the TPU probe's kernel; rsqrt is CUDA's rsqrtf, the
// counterpart of jax.lax.rsqrt.
#include <cuda_runtime.h>

__global__ void math_probe_kernel(const float* __restrict__ x,
                                  const float* __restrict__ y, long long n,
                                  float* __restrict__ out) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float xi = x[i], yi = y[i];
  const float r = 1.0f / xi;
  const float rs = rsqrtf(xi);
  out[i] = r;
  out[n + i] = r * (2.0f - xi * r);
  out[2 * n + i] = yi / xi;
  out[3 * n + i] = sqrtf(xi);
  out[4 * n + i] = rs;
  out[5 * n + i] = rs * (1.5f - 0.5f * xi * rs * rs);
  out[6 * n + i] = xi * rs;
  out[7 * n + i] = expf(logf(xi) * 0.5f);
  out[8 * n + i] = logf(xi);
}

extern "C" int math_probe_cuda(const float* x, const float* y, long long n,
                               float* out, cudaStream_t stream) {
  if (n > 0)
    math_probe_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(x, y, n, out);
  return (int)cudaGetLastError();
}
