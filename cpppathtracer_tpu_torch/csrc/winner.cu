// The dense closest-hit winner search as a standalone kernel: one thread
// per ray around winner.cuh's poca_winner_search.
//
// Replaces cpppathtracer_tpu/ops/pallas/intersect_kernel.py::
// pallas_winner_index_planar, pallas_winner_index_v and
// pallas_winner_index.  The three compute one function and differ only in
// how they lay rays and objects out for the TPU's registers and matrix
// unit (planar or packed [8, R] rays, MXU or VPU form); this launch reads
// the planar rays, and the wavefront path (ops/fast.py) is its only
// caller.
//
// Each block stages the geometry rows (32 bytes per object, 8-row aligned
// groups) in dynamic shared memory, above 48 KB by opt-in as mega_trace.cu
// does, so the winner loop reads broadcast rows.  The wrapper refuses a
// scene whose rows exceed the card's 227 KB per block (about 7,000
// objects), as the Pallas kernel refused scenes past its VMEM budget.
//
// What bounds it on an H100: FP32 operations, about 33 per (sphere, ray)
// and 87 per (cylinder, ray) pair; per ray it reads 8 floats and writes
// one int.
#include <cuda_runtime.h>

#include "winner.cuh"

#define POCA_WINNER_BLOCK 256

__global__ void __launch_bounds__(POCA_WINNER_BLOCK)
winner_index_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                    const float* __restrict__ oz, const float* __restrict__ dx,
                    const float* __restrict__ dy, const float* __restrict__ dz,
                    const float* __restrict__ tmin, const float* __restrict__ tmax,
                    const float* __restrict__ geom, int* __restrict__ out,
                    int R, int n_s, int n_p, int n_c, int n_rep) {
  extern __shared__ float sgeom[];
  for (int k = threadIdx.x; k < 8 * n_rep; k += blockDim.x) sgeom[k] = geom[k];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  out[i] = poca_winner_search(sgeom, n_s, n_p, n_c, ox[i], oy[i], oz[i],
                              dx[i], dy[i], dz[i], tmin[i], tmax[i]);
}

extern "C" int poca_winner_index(
    const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz,
    const float* tmin, const float* tmax, const float* geom,
    int* out, int R, int n_s, int n_p, int n_c, int n_rep, cudaStream_t stream) {
  if (R <= 0) return 0;
  const size_t smem = sizeof(float) * 8 * (size_t)n_rep;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        winner_index_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (R + POCA_WINNER_BLOCK - 1) / POCA_WINNER_BLOCK;
  winner_index_kernel<<<grid, POCA_WINNER_BLOCK, smem, stream>>>(
      ox, oy, oz, dx, dy, dz, tmin, tmax, geom, out, R, n_s, n_p, n_c, n_rep);
  return (int)cudaGetLastError();
}
