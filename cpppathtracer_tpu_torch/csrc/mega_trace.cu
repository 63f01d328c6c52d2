// The bounce-loop megakernel: every bounce of every ray in one launch.
//
// Replaces cpppathtracer_tpu/ops/pallas/mega_kernel.py::pallas_mega_trace
// (body _mega_kernel, RNG _uniforms3).  Per ray and bounce: winner search
// (winner.cuh), then the bounce body of bounce.cuh, which the backward
// kernel (mega_bwd.cu) shares: winner record fetch, hit attributes
// (planar.object_hit_attrs_p), PCG4D uniforms, BSDF sampling
// (planar.shade_p, forward form); then the carry updates.  The arithmetic
// repeats the plain PyTorch version (ops/cuda/mega_kernel.py::
// mega_trace_plain) op for op; it is built with --fmad=false so that no
// a*b+c is contracted and the two agree at float32 rounding.
//
// Design for the H100, where the TPU version tiled 1024 rays per grid step
// and did the record fetch as a one-hot matmul on the MXU:
// - one thread per ray, a masked tail, no padding to tiles;
// - each block stages the geometry rows and both record tables in shared
//   memory (about 10 KB for the 93-object demo scene), so the winner loop
//   reads broadcast rows and the record fetch is an indexed shared load;
// - the carry (origin, direction, throughput, radiance, first-hit normal
//   and t) stays in registers for all bounces;
// - every output is a plane of R floats or ints, written once, so stores
//   of a warp are coalesced.
// What bounds it: FP32 operations.  Per ray it reads 11 words and writes
// 14 (+3 with_o) floats and one int per bounce, some 100 bytes, against
// roughly 5,000 operations per bounce for the demo scene's winner search.
//
// Phase B of the split trace passes n_alive (read on the device, no host
// sync) and an alive mask: a lane at or past n_alive, or masked, publishes
// neutral outputs (zeros, hit -1) and exits at once.
//
// The with_aux form (textured scenes, pallas_mega_trace(with_aux=True)):
// per bounce b it also writes aux[4b + 0..2] = the hit position the bounce
// body already holds and aux[4b + 3] = the attenuation-on mask (glass, or
// dot(normal, bounce) > 0), four coalesced stores a bounce and no new
// arithmetic; inactive lanes write zeros.  It is a second instantiation
// (AUX = true), so the untextured kernel's code is unchanged.  The form
// adds 16 bytes per lane and bounce to the bytes above, still well under
// the operations' bound.
#include <cstdint>
#include <cuda_runtime.h>

#include "bounce.cuh"
#include "winner.cuh"

#define POCA_MEGA_BLOCK 128

struct MegaParams {
  const float *ox, *oy, *oz, *dx, *dy, *dz;
  const float *tx, *ty, *tz;  // input throughput, null = ones
  const int *pix, *samp;
  const float *geom, *ts, *trt;
  const int* n_alive;   // null = unguarded
  const float* amask;   // null = no mask; nonzero = dead
  float* out_f;         // [14, R]: rad3 miss_dir3 miss_thru3 missed first_n3 first_t
  float* out_o;         // [3, R] or null
  int* hits;            // [depth, R]
  float* aux;           // [4 * depth, R] (AUX only): pos3 att per bounce
  int R, n_s, n_p, n_c, n_rep, n_pad, depth, start_bounce;
  uint32_t seed;
};

// -------------------------------------------------------------- kernel
template <bool AUX>
__global__ void __launch_bounds__(POCA_MEGA_BLOCK)
mega_trace_kernel(MegaParams p) {
  extern __shared__ float smem[];
  float* geom = smem;
  float* ts = geom + 8 * p.n_rep;
  float* trt = ts + POCA_F_S * p.n_pad;
  const int n_geom = 8 * p.n_rep, n_ts = POCA_F_S * p.n_pad, n_tr = POCA_F_R * p.n_pad;
  for (int k = threadIdx.x; k < n_geom; k += blockDim.x) geom[k] = p.geom[k];
  for (int k = threadIdx.x; k < n_ts; k += blockDim.x) ts[k] = p.ts[k];
  for (int k = threadIdx.x; k < n_tr; k += blockDim.x) trt[k] = p.trt[k];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.R) return;
  const int R = p.R;

  const bool active = p.n_alive == nullptr ||
                      (i < *p.n_alive && (p.amask == nullptr || p.amask[i] == 0.0f));
  if (!active) {
    for (int k = 0; k < 14; ++k) p.out_f[k * R + i] = 0.0f;
    if (p.out_o) for (int k = 0; k < 3; ++k) p.out_o[k * R + i] = 0.0f;
    for (int b = 0; b < p.depth; ++b) p.hits[b * R + i] = -1;
    if (AUX)
      for (int k = 0; k < 4 * p.depth; ++k) p.aux[(size_t)k * R + i] = 0.0f;
    return;
  }

  V3 o = v3(p.ox[i], p.oy[i], p.oz[i]);
  V3 d = v3(p.dx[i], p.dy[i], p.dz[i]);
  V3 thru = p.tx ? v3(p.tx[i], p.ty[i], p.tz[i]) : v3(1.0f, 1.0f, 1.0f);
  V3 rad = v3(0.0f, 0.0f, 0.0f);
  V3 first_n = v3(0.0f, 0.0f, 0.0f);
  float first_t = 0.0f;
  bool alive = true;
  const uint32_t pix = (uint32_t)p.pix[i], samp = (uint32_t)p.samp[i];

  for (int b = 0; b < p.depth; ++b) {
    const float tmin = (p.start_bounce + b == 0) ? 0.0f : POCA_TMIN_BOUNCE;
    const float tmax = POCA_INF;
    const int w = poca_winner_search(geom, p.n_s, p.n_p, p.n_c, o.x, o.y, o.z,
                                    d.x, d.y, d.z, tmin, tmax);
    float u1, u2, u3;
    uniforms3(pix, samp, (uint32_t)(1 + p.start_bounce + b), p.seed, u1, u2, u3);
    BounceFwd bf;
    bounce_body(ts, trt, p.n_pad, w, o, d, tmin, u1, u2, u3, bf);
    const bool hit = bf.hit;
    p.hits[b * R + i] = hit ? w : -1;
    const V3 normal = bf.normal;
    const float t = bf.h.t;
    const V3 pos = bf.pos;
    const V3 bounce = bf.s.bounce, atten = bf.s.atten, emitted = bf.s.emitted;
    if (AUX) {
      float* a = p.aux + (size_t)(4 * b) * R + i;
      a[0] = pos.x;
      a[R] = pos.y;
      a[2 * (size_t)R] = pos.z;
      a[3 * (size_t)R] = bf.s.atten_on ? 1.0f : 0.0f;
    }

    const bool live_hit = hit && alive;
    const float lh = live_hit ? 1.0f : 0.0f;
    rad = add(rad, scale(mul(thru, emitted), lh));
    thru = live_hit ? mul(thru, atten) : thru;
    if (b == 0) {
      first_n = hit ? normal : scale(d, -1.0f);
      first_t = hit ? t : POCA_INF;
    }
    alive = alive && hit;
    if (hit) {
      o = pos;
      d = normalize(bounce);
    }
  }

  float* f = p.out_f;
  f[0 * R + i] = rad.x;  f[1 * R + i] = rad.y;  f[2 * R + i] = rad.z;
  f[3 * R + i] = d.x;    f[4 * R + i] = d.y;    f[5 * R + i] = d.z;
  f[6 * R + i] = thru.x; f[7 * R + i] = thru.y; f[8 * R + i] = thru.z;
  f[9 * R + i] = alive ? 0.0f : 1.0f;
  f[10 * R + i] = first_n.x; f[11 * R + i] = first_n.y; f[12 * R + i] = first_n.z;
  f[13 * R + i] = first_t;
  if (p.out_o) {
    p.out_o[0 * R + i] = o.x; p.out_o[1 * R + i] = o.y; p.out_o[2 * R + i] = o.z;
  }
}

extern "C" int poca_mega_trace(
    const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz,
    const float* tx, const float* ty, const float* tz,
    const int* pix, const int* samp,
    const float* geom, const float* ts, const float* trt,
    const int* n_alive, const float* amask,
    float* out_f, float* out_o, int* hits, float* aux,
    int R, int n_s, int n_p, int n_c, int n_rep, int n_pad, int depth,
    int start_bounce, int seed, cudaStream_t stream) {
  if (R <= 0) return 0;
  MegaParams p = {ox, oy, oz, dx, dy, dz, tx, ty, tz, pix, samp, geom, ts, trt,
                  n_alive, amask, out_f, out_o, hits, aux,
                  R, n_s, n_p, n_c, n_rep, n_pad, depth, start_bounce, (uint32_t)seed};
  const size_t smem = sizeof(float) * (8 * (size_t)n_rep + (POCA_F_S + POCA_F_R) * (size_t)n_pad);
  void (*kernel)(MegaParams) = aux ? mega_trace_kernel<true> : mega_trace_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (R + POCA_MEGA_BLOCK - 1) / POCA_MEGA_BLOCK;
  kernel<<<grid, POCA_MEGA_BLOCK, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// The shared memory one block of `device` may opt into
// (cudaDevAttrMaxSharedMemoryPerBlockOptin; 232,448 bytes on the H100).
extern "C" int poca_smem_optin(int device, int* out) {
  return (int)cudaDeviceGetAttribute(out, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}
