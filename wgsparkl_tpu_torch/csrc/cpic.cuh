// CPIC helpers shared by the 2D and 3D transfer kernels.  Each follows its
// plain PyTorch counterpart in wgsparkl_tpu_torch/ops/rows.py operation by
// operation.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#define BIG 1.0e10f
#define FRICTION 20.0f
#define NTHREADS 256

// Shape types (collision/shapes.py), packed 2 bits a slot in `shapes`.
#define SHAPE_CUBOID 0
#define SHAPE_BALL 1
#define SHAPE_CAPSULE 2
#define SHAPE_HALFSPACE 3

__device__ __forceinline__ float nr_recip(float x) {
  float r = 1.0f / x;
  return r * (2.0f - x * r);
}

__device__ __forceinline__ uint32_t aff_word(float lo, float hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

__device__ __forceinline__ bool compat(uint32_t naff, uint32_t paff) {
  uint32_t common = naff & paff & 0xFFFFu;
  return (((naff >> 16) & 0xFFFFu) & common) == (((paff >> 16) & 0xFFFFu) & common);
}
