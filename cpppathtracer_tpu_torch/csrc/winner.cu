// The dense closest-hit winner search as a standalone kernel around
// winner.cuh's poca_winner_search.
//
// Replaces cpppathtracer_tpu/ops/pallas/intersect_kernel.py::
// pallas_winner_index_planar, pallas_winner_index_v and
// pallas_winner_index.  The three compute one function and differ only in
// how they lay rays and objects out for the TPU's registers and matrix
// unit (planar or packed [8, R] rays, MXU or VPU form); this launch reads
// the planar rays, and the wavefront path (ops/fast.py) is its only
// caller.
//
// What bounds it on an H100: FP32 operations, about 33 per (sphere, ray)
// and 87 per (cylinder, ray) pair; per ray it reads 8 floats and writes
// one int.  The design:
// - blocks of 1024 threads, one ray a thread, each staging the geometry
//   rows (32 bytes per object, 8-row aligned groups) in dynamic shared
//   memory, above 48 KB by opt-in.  A scene of a few thousand objects
//   fills most of an SM's shared memory, so one block fits on an SM: at
//   1024 threads that is 32 resident warps to hide the latency of the
//   square roots and divisions, and the rows are read from global memory
//   once per 1024 rays.  (Persistent blocks that stage the rows once per
//   SM and take rays from a counter were no faster; PERF.md);
// - each warp runs the warp-wide search of winner.cuh; a lane past R runs
//   masked.
// The wrapper refuses a scene whose rows exceed the card's 227 KB per
// block (7,264 rows, about 7,000 objects), as the Pallas kernel refused
// scenes past its VMEM budget.
#include <cuda_runtime.h>

#include "winner.cuh"

#define POCA_WINNER_BLOCK 1024

struct WinnerArgs {
  const float *ox, *oy, *oz, *dx, *dy, *dz, *tmin, *tmax, *geom;
  int* out;
  int R, n_s, n_p, n_c, n_rep;
};

__global__ void __launch_bounds__(POCA_WINNER_BLOCK) winner_index_kernel(WinnerArgs a) {
  extern __shared__ float4 srows[];
  float* s = reinterpret_cast<float*>(srows);
  for (int k = threadIdx.x; k < 8 * a.n_rep; k += blockDim.x) s[k] = __ldg(a.geom + k);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool on = i < a.R;
  const int j = on ? i : a.R - 1;  // a masked lane reads a ray it does not write
  float best_t;
  const int w = poca_winner_search(srows, a.n_s, a.n_p, a.n_c, on, a.ox[j], a.oy[j], a.oz[j],
                                   a.dx[j], a.dy[j], a.dz[j], a.tmin[j], a.tmax[j], best_t);
  if (on) a.out[i] = w;
}

// The shared memory a block stages for n_rep rows, opted into above 48 KB.
static int winner_smem(int n_rep, size_t* smem) {
  *smem = sizeof(float) * 8 * (size_t)n_rep;
  if (*smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(winner_index_kernel,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  return 0;
}

// Rays: 8 planes f32[R]; geom f32[n_rep, 8]; out i32[R].
extern "C" int poca_winner_index(
    const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz,
    const float* tmin, const float* tmax, const float* geom,
    int* out, int R, int n_s, int n_p, int n_c, int n_rep, cudaStream_t stream) {
  if (R <= 0) return 0;
  size_t smem = 0;
  const int err = winner_smem(n_rep, &smem);
  if (err) return err;
  WinnerArgs a = {ox, oy, oz, dx, dy, dz, tmin, tmax, geom, out, R, n_s, n_p, n_c, n_rep};
  const int grid = (R + POCA_WINNER_BLOCK - 1) / POCA_WINNER_BLOCK;
  winner_index_kernel<<<grid, POCA_WINNER_BLOCK, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The kernel's registers, local bytes per thread, resident blocks per SM
// and the grid of a launch over R rays with n_rep rows, into info[0..3].
extern "C" int poca_winner_info(int R, int n_rep, int* info) {
  size_t smem = 0;
  const int err = winner_smem(n_rep, &smem);
  if (err) return err;
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, winner_index_kernel);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, winner_index_kernel,
                                                    POCA_WINNER_BLOCK, smem);
  if (e != cudaSuccess) return (int)e;
  info[0] = fa.numRegs;
  info[1] = (int)fa.localSizeBytes;
  info[2] = per_sm;
  info[3] = (R + POCA_WINNER_BLOCK - 1) / POCA_WINNER_BLOCK;
  return 0;
}
