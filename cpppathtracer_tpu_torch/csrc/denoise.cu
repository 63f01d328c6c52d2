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
// Design: one thread a pixel, blocks of 32 x 8 pixels.  A block stages its
// tile and a halo of 2 * stepwidth pixels on each side of radiance, normal
// and depth in shared memory, as seven float planes (zeros outside the
// image, as the plain version's padding), with coalesced loads; 12 KB at
// stepwidth 1, 18 KB at 2.  Each thread then runs the 25 taps in the plain
// version's order (i over x offsets outer, j over y offsets inner) with its
// arithmetic, each operation rounded alone (the library is built with
// --fmad=false): the squared distances summed over the channels as
// (c0 + c1) + c2, times -1/pi as float32, expf, the weight
// ((c_w * n_w) * p_w) * valid * k, num += wgt * tap, den += wgt, and
// num / den.  A tap outside the image reads zeros and has valid = 0, so
// its weight is exactly 0, as in the plain version.
//
// What bounds it on an H100: at 1280 x 720, 7 floats read and 3 written a
// pixel (36.9 MB, 0.011 ms at 3.35 TB/s) against some 32 FP32 operations
// and 3 expf a tap (8.1e8 operations, 0.012 ms at 67 TFLOP/s; the 6.9e7
// expf take their ex2 on the SFU, 16 a clock an SM, some 0.017 ms).  The
// halo read from shared memory keeps device memory traffic at the bound's
// bytes; the taps are arithmetic in registers.

#include <cuda_runtime.h>

#define POCA_DN_BX 32
#define POCA_DN_BY 8

// float32(1 / pi), as ops/cuda/denoise_kernel.py's _INV_PI
#define POCA_INV_PI 0x1.45f306p-2f

__constant__ float poca_dn_k[25] = {
    1.f, 4.f, 7.f, 4.f, 1.f,
    4.f, 16.f, 26.f, 16.f, 4.f,
    7.f, 26.f, 41.f, 26.f, 7.f,
    4.f, 16.f, 26.f, 16.f, 4.f,
    1.f, 4.f, 7.f, 4.f, 1.f,
};

__global__ void __launch_bounds__(POCA_DN_BX * POCA_DN_BY)
denoise_kernel(const float* __restrict__ rad, const float* __restrict__ nrm,
               const float* __restrict__ dep, float* __restrict__ out, int H, int W, int step) {
  extern __shared__ float sm[];
  const int r = 2 * step;
  const int tw = POCA_DN_BX + 2 * r;
  const int tn = tw * (POCA_DN_BY + 2 * r);
  float* const s_c0 = sm;
  float* const s_c1 = sm + tn;
  float* const s_c2 = sm + 2 * tn;
  float* const s_n0 = sm + 3 * tn;
  float* const s_n1 = sm + 4 * tn;
  float* const s_n2 = sm + 5 * tn;
  float* const s_d = sm + 6 * tn;
  const int x0 = blockIdx.x * POCA_DN_BX - r;
  const int y0 = blockIdx.y * POCA_DN_BY - r;
  for (int k = threadIdx.y * POCA_DN_BX + threadIdx.x; k < tn; k += POCA_DN_BX * POCA_DN_BY) {
    const int ty = k / tw;
    const int gx = x0 + (k - ty * tw), gy = y0 + ty;
    float c0 = 0.f, c1 = 0.f, c2 = 0.f, n0 = 0.f, n1 = 0.f, n2 = 0.f, d = 0.f;
    if (gx >= 0 && gx < W && gy >= 0 && gy < H) {
      const size_t p = (size_t)gy * W + gx;
      c0 = rad[3 * p]; c1 = rad[3 * p + 1]; c2 = rad[3 * p + 2];
      n0 = nrm[3 * p]; n1 = nrm[3 * p + 1]; n2 = nrm[3 * p + 2];
      d = dep[p];
    }
    s_c0[k] = c0; s_c1[k] = c1; s_c2[k] = c2;
    s_n0[k] = n0; s_n1[k] = n1; s_n2[k] = n2;
    s_d[k] = d;
  }
  __syncthreads();
  const int px = blockIdx.x * POCA_DN_BX + threadIdx.x;
  const int py = blockIdx.y * POCA_DN_BY + threadIdx.y;
  if (px >= W || py >= H) return;
  const int ct = (threadIdx.y + r) * tw + threadIdx.x + r;
  const float c0 = s_c0[ct], c1 = s_c1[ct], c2 = s_c2[ct];
  const float n0 = s_n0[ct], n1 = s_n1[ct], n2 = s_n2[ct];
  const float d = s_d[ct];
  float num0 = 0.f, num1 = 0.f, num2 = 0.f, den = 0.f;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int dx = (i - 2) * step;
    const bool in_x = px + dx >= 0 && px + dx < W;
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      const int dy = (j - 2) * step;
      const float valid = in_x && py + dy >= 0 && py + dy < H ? 1.f : 0.f;
      const int t = ct + dy * tw + dx;
      const float t0 = s_c0[t], t1 = s_c1[t], t2 = s_c2[t];
      const float cd0 = c0 - t0, cd1 = c1 - t1, cd2 = c2 - t2;
      const float nd0 = n0 - s_n0[t], nd1 = n1 - s_n1[t], nd2 = n2 - s_n2[t];
      const float pd = d - s_d[t];
      const float c_w = expf(-(cd0 * cd0 + cd1 * cd1 + cd2 * cd2) * POCA_INV_PI);
      const float n_w = expf(-(nd0 * nd0 + nd1 * nd1 + nd2 * nd2) * POCA_INV_PI);
      const float p_w = expf(-(pd * pd) * POCA_INV_PI);
      const float wgt = c_w * n_w * p_w * valid * poca_dn_k[i * 5 + j];
      num0 = num0 + wgt * t0;
      num1 = num1 + wgt * t1;
      num2 = num2 + wgt * t2;
      den = den + wgt;
    }
  }
  const size_t p = (size_t)py * W + px;
  out[3 * p] = num0 / den;
  out[3 * p + 1] = num1 / den;
  out[3 * p + 2] = num2 / den;
}

// The dynamic shared memory of one block at this stepwidth.
static size_t denoise_smem(int step) {
  return sizeof(float) * 7 * (size_t)(POCA_DN_BX + 4 * step) * (POCA_DN_BY + 4 * step);
}

// rad, nrm f32[H, W, 3], dep f32[H, W], out f32[H, W, 3]; stepwidth >= 0.
extern "C" int poca_denoise(const float* rad, const float* nrm, const float* dep, float* out,
                            int H, int W, int step, cudaStream_t stream) {
  if (H <= 0 || W <= 0) return 0;
  if (step < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = denoise_smem(step);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        denoise_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 block(POCA_DN_BX, POCA_DN_BY);
  const dim3 grid((W + POCA_DN_BX - 1) / POCA_DN_BX, (H + POCA_DN_BY - 1) / POCA_DN_BY);
  denoise_kernel<<<grid, block, smem, stream>>>(rad, nrm, dep, out, H, W, step);
  return (int)cudaGetLastError();
}
