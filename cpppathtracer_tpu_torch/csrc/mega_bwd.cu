// The megakernel's backward: the gradient of one sample w.r.t. its primary
// rays and the record tables, in one launch.
//
// Replaces cpppathtracer_tpu/ops/pallas/mega_bwd_kernel.py::pallas_mega_bwd
// (body _mega_bwd_kernel).  The per-ray body, a forward sweep that rebuilds
// the entry carries from the saved winner planes and a reverse sweep of
// hand-derived adjoints, is in mega_bwd.cuh; it shares the forward bounce
// body with mega_trace.cu (bounce.cuh), so the rebuilt carries equal the
// forward kernel's bitwise.  Built with --fmad=false like mega_trace.
//
// Design for the H100, where the TPU version took a 1024-ray tile per
// sequential grid step, kept the carries in [depth, tile] VMEM stacks
// (masked one-hot inserts: Mosaic has no dynamic indexing) and summed the
// table cotangents in output blocks that the sequential grid revisits:
// - one thread per ray; each thread keeps its entry carries (10 words per
//   bounce, depth <= 32) in local memory, indexed directly;
// - each block stages both record tables in shared memory (6.5 KB for the
//   93-object demo scene) and loops over rays with a grid stride, so the
//   grid is one wave of resident blocks;
// - table cotangents: blocks run in parallel and in no order, so a block
//   sums its rays' cotangents in shared memory with shared atomics and
//   adds its sums to device memory with one global atomicAdd per nonzero
//   entry at the end.  Where the 2 x 17 x n_pad floats of tables and sums
//   do not fit (n_pad > 1024, set by the wrapper) the cotangents go
//   straight to device memory with global atomics.  Atomics make ct_ts and
//   ct_trt depend on the order of the adds, so they are held to a
//   tolerance, not bitwise.
// What bounds it: bytes, narrowly.  Per ray it reads 6 + 2 + 13 words and
// the depth winner planes and writes 6; per ray-bounce that hit it
// recomputes the bounce body twice (forward sweep and reverse sweep, no
// winner search) and runs its adjoint, about 960 FP32 operations, which on
// the demo scene take about half as long as the bytes (chip_smoke.py
// counts both).
#include <cuda_runtime.h>

#include "mega_bwd.cuh"

#define POCA_BWD_BLOCK 128

template <bool SMEM_ACC>
__global__ void __launch_bounds__(POCA_BWD_BLOCK) mega_bwd_kernel(BwdParams p) {
  extern __shared__ float smem[];
  const int np = p.n_pad;
  float* ts = smem;
  float* trt = ts + POCA_F_S * np;
  float* acc = trt + POCA_F_R * np;  // [17, np] when SMEM_ACC
  const int n_ts = POCA_F_S * np, n_tr = POCA_F_R * np, n_acc = (POCA_F_S + POCA_F_R) * np;
  for (int k = threadIdx.x; k < n_ts; k += blockDim.x) ts[k] = p.ts[k];
  for (int k = threadIdx.x; k < n_tr; k += blockDim.x) trt[k] = p.trt[k];
  if (SMEM_ACC)
    for (int k = threadIdx.x; k < n_acc; k += blockDim.x) acc[k] = 0.0f;
  __syncthreads();

  TableAcc a = {SMEM_ACC ? acc : p.out_tab, np};
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < p.R; i += gridDim.x * blockDim.x)
    mega_bwd_ray(p, i, ts, trt, a);

  if (SMEM_ACC) {
    __syncthreads();
    for (int k = threadIdx.x; k < n_acc; k += blockDim.x) {
      const float v = acc[k];
      if (v != 0.0f) atomicAdd(p.out_tab + k, v);
    }
  }
}

extern "C" int poca_mega_bwd(
    const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz,
    const int* pix, const int* samp, const float* ts, const float* trt, const int* hits,
    const float* ct0, const float* ct1, const float* ct2, const float* ct3,
    const float* ct4, const float* ct5, const float* ct6, const float* ct7,
    const float* ct8, const float* ct9, const float* ct10, const float* ct11,
    const float* ct12,
    float* out_tab, float* out_od, float* carry,
    int R, int n_pad, int depth, int seed, int smem_acc, cudaStream_t stream) {
  if (R <= 0) return 0;
  if (depth < 1 || depth > POCA_MAX_DEPTH || n_pad < 1) return (int)cudaErrorInvalidValue;
  BwdParams p = {ox, oy, oz, dx, dy, dz, pix, samp, ts, trt, hits,
                 {ct0, ct1, ct2, ct3, ct4, ct5, ct6, ct7, ct8, ct9, ct10, ct11, ct12},
                 out_tab, out_od, carry, R, n_pad, depth, (uint32_t)seed};
  void (*kern)(BwdParams) = smem_acc ? mega_bwd_kernel<true> : mega_bwd_kernel<false>;
  const size_t smem = sizeof(float) * (POCA_F_S + POCA_F_R) * (size_t)n_pad * (smem_acc ? 2 : 1);
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // one wave of resident blocks; each loops over rays
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, POCA_BWD_BLOCK, smem);
  if (e != cudaSuccess) return (int)e;
  const int need = (R + POCA_BWD_BLOCK - 1) / POCA_BWD_BLOCK;
  const int wave = (per_sm > 0 ? per_sm : 1) * sms;
  kern<<<need < wave ? need : wave, POCA_BWD_BLOCK, smem, stream>>>(p);
  return (int)cudaGetLastError();
}
