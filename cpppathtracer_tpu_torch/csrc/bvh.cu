// The skip-pointer BVH walk as a kernel: one thread per ray, each walking
// the tables on its own (bvh.cuh).
//
// Replaces cpppathtracer_tpu/ops/pallas/bvh_kernel.py::
// pallas_bvh_winner_index.  Per ray it reads 8 floats (o, d, tmin, tmax)
// and writes one int, the closest hit's grouped index (0 on a miss); the
// tables are read from device memory through the read-only cache (at
// M = 511 nodes, 20 KB of nodes and 512 KB of leaf rows for the
// 16384-object scene, which stay in L2).
//
// What bounds it on an H100: FP32 operations, the slab tests and leaf-row
// tests that each ray's walk needs (counted by the plain version), at the
// 67 TFLOP/s of the FP32 units; a warp's threads take different paths
// through the tree, so divergence is what this simple form pays.
// Shared-memory staging of the upper nodes and warp-coherent traversal are
// left for a later change.  Rays are bounds-checked, never padded.
#include <cuda_runtime.h>

#include "bvh.cuh"

#define POCA_BVH_BLOCK 128

__global__ void __launch_bounds__(POCA_BVH_BLOCK)
bvh_winner_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                  const float* __restrict__ oz, const float* __restrict__ dx,
                  const float* __restrict__ dy, const float* __restrict__ dz,
                  const float* __restrict__ tmin, const float* __restrict__ tmax,
                  const int* __restrict__ meta, const float* __restrict__ aabb,
                  const float* __restrict__ objs, int* __restrict__ out, int R, int m, int k) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  const BvhRay r = bvh_ray(ox[i], oy[i], oz[i], dx[i], dy[i], dz[i], tmin[i]);
  out[i] = bvh_walk<false>(meta, aabb, objs, m, k, r, tmax[i], nullptr);
}

extern "C" int poca_bvh_winner_index(
    const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz,
    const float* tmin, const float* tmax,
    const int* meta, const float* aabb, const float* objs,
    int* out, int R, int m, int k, cudaStream_t stream) {
  if (R <= 0) return 0;
  const int grid = (R + POCA_BVH_BLOCK - 1) / POCA_BVH_BLOCK;
  bvh_winner_kernel<<<grid, POCA_BVH_BLOCK, 0, stream>>>(
      ox, oy, oz, dx, dy, dz, tmin, tmax, meta, aabb, objs, out, R, m, k);
  return (int)cudaGetLastError();
}
