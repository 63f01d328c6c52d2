// The edge-avoiding 5x5 denoiser of the progressive frame and the still
// render.
//
// Replaces no Pallas kernel: the JAX package's denoiser
// (cpppathtracer_tpu/ops/denoise.py:39-75) is 25 shifted elementwise taps
// that XLA fuses into one pass inside its jitted frame program
// (cpppathtracer_tpu/renderer.py:98-108).  This is that pass, written by
// hand, as the reference program's Denoising kernel is
// (cuSrc/path_tracer.cu:177-239).  The port's plain version
// (ops/cuda/denoise_kernel.py::denoise_plain) is some 25 x 20 small
// PyTorch kernels over the frame.
//
// What bounds it on an H100: at 1280 x 720, 7 floats read and 3 written a
// pixel (36.9 MB, 0.011 ms at 3.35 TB/s) against its FP32 work: with each
// pair's weight factor computed once, 12 factors and the centre's a pixel
// and the 25 taps' sums, some 5.2e8 operations (0.008 ms at 67 TFLOP/s;
// 8.1e8 and 0.012 ms with 25 factors a pixel), so bytes bound it.  The
// kernel is built with --fmad=false, so every multiply and add issues
// alone, and each expf is some eight instructions: what the card issues,
// not the bytes, sets its pace.  The design (csrc/denoise.cuh)
// keeps the bytes at the bound's (one coalesced read of the tile and its
// halo into shared memory) and cuts the instructions and shared loads a
// pixel: constant tap offsets, 16-byte shared loads, no bounds tests
// inside the image, each pair's weight computed once, and shared taps read
// once for several pixels of a thread.
//
// One block of DN_THREADS threads covers a DN_BX x DN_BY tile: stage,
// __syncthreads, the pair factors, __syncthreads, the taps.  At stepwidth
// 1 (every caller's) it holds 54 KB of shared memory, so four blocks share
// an SM; other stepwidths run the untiled kernel at the end.

#include <cuda_runtime.h>

#include <atomic>

#include "denoise.cuh"

template <int S, bool PAIRS>
__global__ void __launch_bounds__(DN_THREADS, 1024 / DN_THREADS)
denoise_kernel(const float* __restrict__ rad, const float* __restrict__ nrm,
               const float* __restrict__ dep, float* __restrict__ out, int H, int W, int step) {
  extern __shared__ float4 sm[];
  const DnArgs a = {rad, nrm, dep, out, H, W};
  const DnTile<S> g(step);
  const bool interior = dn_interior(a, g, blockIdx.x, blockIdx.y);
  dn_stage(a, g, sm, blockIdx.x, blockIdx.y, interior, threadIdx.x);
  __syncthreads();
  if (PAIRS) {
    dn_pairs(g, sm, threadIdx.x);
    __syncthreads();
  }
  if (interior)
    dn_taps<S, PAIRS, false>(a, g, sm, blockIdx.x, blockIdx.y, threadIdx.x);
  else
    dn_taps<S, PAIRS, true>(a, g, sm, blockIdx.x, blockIdx.y, threadIdx.x);
}

// Any other stepwidth: one pixel a thread of a DN_BX x 8 block, every tap
// read from device memory (dn_pixel), so no stepwidth outgrows shared
// memory.  The same name as the tiled kernel's, so that the profiler's
// records of both read "denoise_kernel".
__global__ void __launch_bounds__(DN_BX * 8)
denoise_kernel(const float* __restrict__ rad, const float* __restrict__ nrm,
               const float* __restrict__ dep, float* __restrict__ out, int H, int W, int step) {
  const DnArgs a = {rad, nrm, dep, out, H, W};
  const int px = blockIdx.x * DN_BX + threadIdx.x % DN_BX;
  const int py = blockIdx.y * 8 + threadIdx.x / DN_BX;
  if (px < W && py < H) dn_pixel(a, step, px, py);
}

// Past 48 KB of shared memory a kernel opts in to the card's most: once a
// device, on its first eager launch there.  A stream being captured into a
// CUDA graph must not record that, and needs none: its eager warm-up
// opted in.
template <int S, bool PAIRS>
static int dn_optin(cudaStream_t stream) {
  static std::atomic<bool> done[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 64 && done[dev].load(std::memory_order_relaxed)) return 0;
  cudaStreamCaptureStatus capturing;
  e = cudaStreamIsCapturing(stream, &capturing);
  if (e != cudaSuccess || capturing != cudaStreamCaptureStatusNone) return (int)e;
  int most = 0;
  e = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(denoise_kernel<S, PAIRS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             most);
  if (e == cudaSuccess && dev < 64) done[dev].store(true, std::memory_order_relaxed);
  return (int)e;
}

template <int S, bool PAIRS>
static int dn_launch(const DnArgs& a, int step, cudaStream_t stream) {
  const DnTile<S> g(step);
  const long smem = dn_smem_bytes(g.tnp(), g.rn(), PAIRS);
  if (smem > 48 * 1024) {
    const int e = dn_optin<S, PAIRS>(stream);
    if (e) return e;
  }
  const dim3 grid((a.W + DN_BX - 1) / DN_BX, (a.H + DN_BY - 1) / DN_BY);
  denoise_kernel<S, PAIRS><<<grid, DN_THREADS, (size_t)smem, stream>>>(a.rad, a.nrm, a.dep, a.out,
                                                                        a.H, a.W, step);
  return (int)cudaGetLastError();
}

// rad, nrm f32[H, W, 3], dep f32[H, W], out f32[H, W, 3]; stepwidth >= 0.
extern "C" int poca_denoise(const float* rad, const float* nrm, const float* dep, float* out,
                            int H, int W, int step, cudaStream_t stream) {
  if (H <= 0 || W <= 0) return 0;
  if (step < 0) return (int)cudaErrorInvalidValue;
  const DnArgs a = {rad, nrm, dep, out, H, W};
  constexpr bool kPairs = true;
  if (step == 1) return dn_launch<1, kPairs>(a, step, stream);
  const dim3 grid((W + DN_BX - 1) / DN_BX, (H + 7) / 8);
  denoise_kernel<<<grid, DN_BX * 8, 0, stream>>>(rad, nrm, dep, out, H, W, step);
  return (int)cudaGetLastError();
}
