// The wavefront path's bounce body as one kernel a bounce: record fetch, hit
// attributes, PCG4D uniforms, BSDF sampling and the carry updates around the
// walk (wavefront.cuh, one thread a lane).
//
// Replaces no Pallas kernel: it is the hand-written counterpart of what XLA
// fuses out of the JAX package's per-bounce body (cpppathtracer_tpu/
// integrator.py, the planar body around the winner search), which the port
// ran as some 670 PyTorch operations a bounce over every lane.
//
// What bounds it on an H100: device memory.  Per lane and bounce it reads
// the carry (o, d, thru, rad: 12 floats), alive, the winner, pix and samp,
// and writes back what changed, some 110 bytes, against about 240 FP32
// operations; the 13 + 4-float record it gathers comes from tables of about
// 1 MB (big_scene(16384)), which stay in the 50 MB L2.  What the design
// does about it: every intermediate of the bounce stays in registers; the
// carry planes are read once and a plane is stored only where it changes;
// the tables are read through the read-only path (restrict-qualified
// pointers, never written by the kernel).  Blocks of 256 threads stride
// over the lanes in one wave of resident blocks.
//
// The seed is a word in device memory, read once a thread, as the
// megakernel reads it: a CUDA graph that captured a launch replays any
// seed written there.  Built with --fmad=false like every kernel here, so
// the arithmetic is the PyTorch body's bit for bit.
#include <cuda_runtime.h>

#include "wavefront.cuh"

#define POCA_WAVE_BLOCK 256

__global__ void __launch_bounds__(POCA_WAVE_BLOCK)
wavefront_bounce_kernel(float* __restrict__ carry, bool* __restrict__ alive,
                        float* __restrict__ first, const int* __restrict__ gidx,
                        const int* __restrict__ pix, const int* __restrict__ samp,
                        const int* __restrict__ seed, const float* __restrict__ ts,
                        const float* __restrict__ trt, int R, int n_tab, int bounce) {
  const uint32_t s = (uint32_t)__ldg(seed);
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < R; i += stride)
    wavefront_lane(i, R, n_tab, bounce, s, carry, alive, first, gidx, pix, samp, ts, trt);
}

// The grid of a launch over R lanes: one wave of resident blocks, or fewer
// when R needs fewer.
static int wave_grid(int R, int* grid, int* per_sm) {
  int dev = 0, sms = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, wavefront_bounce_kernel,
                                                    POCA_WAVE_BLOCK, 0);
  if (e != cudaSuccess) return (int)e;
  const int wave = (*per_sm > 0 ? *per_sm : 1) * sms;
  const int need = (R + POCA_WAVE_BLOCK - 1) / POCA_WAVE_BLOCK;
  *grid = need < wave ? need : wave;
  return 0;
}

// carry f32[12, R] and alive bool[R] updated in place; first f32[4, R]
// written at bounce 0; gidx, pix, samp i32[R] (gidx < n_tab); seed an i32
// word; ts f32[13, n_tab], trt f32[4, n_tab].
extern "C" int poca_wavefront_bounce(float* carry, bool* alive, float* first, const int* gidx,
                                     const int* pix, const int* samp, const int* seed,
                                     const float* ts, const float* trt, int R, int n_tab,
                                     int bounce, cudaStream_t stream) {
  if (R <= 0) return 0;
  int grid = 0, per_sm = 0;
  const int err = wave_grid(R, &grid, &per_sm);
  if (err) return err;
  wavefront_bounce_kernel<<<grid, POCA_WAVE_BLOCK, 0, stream>>>(
      carry, alive, first, gidx, pix, samp, seed, ts, trt, R, n_tab, bounce);
  return (int)cudaGetLastError();
}

// The kernel's registers, local bytes per thread, resident blocks per SM
// and the grid of a launch over R lanes, into info[0..3].
extern "C" int poca_wavefront_info(int R, int* info) {
  int grid = 0, per_sm = 0;
  const int err = wave_grid(R, &grid, &per_sm);
  if (err) return err;
  cudaFuncAttributes fa;
  const cudaError_t e = cudaFuncGetAttributes(&fa, wavefront_bounce_kernel);
  if (e != cudaSuccess) return (int)e;
  info[0] = fa.numRegs;
  info[1] = (int)fa.localSizeBytes;
  info[2] = per_sm;
  info[3] = grid;
  return 0;
}
