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
// a*b+c is contracted and the two agree bitwise.
//
// What bounds it: FP32 operations.  Per ray it reads 11 words and writes
// 14 (+3 with_o) floats and one int per bounce, some 100 bytes, against
// roughly 5,000 operations per bounce for the demo scene's winner search,
// each its own instruction under --fmad=false.  The design for the H100, where
// the TPU version tiled 1024 rays per grid step and did the record fetch
// as a one-hot matmul on the MXU:
// - a block of 128 threads per 128 lanes stages the geometry rows and both
//   record tables in shared memory (about 10 KB for the 93-object demo
//   scene), so the winner loop reads broadcast rows and the record fetch
//   is an indexed shared load;
// - its warps take rays from a counter in device memory (atomicAdd over
//   the warp's idle lanes; zeroed by a memset before the launch), a lane
//   at a time: a lane whose path has ended takes the next ray while the
//   others go on, so every lane of a warp searches for a live ray, and
//   the blocks that start once the rays have run out find the counter dry
//   and go straight to the tail below.  (Persistent blocks, one wave that
//   stages the tables once per block and takes every ray, were no faster
//   on the H100 and slower in the with_aux form; PERF.md);
// - a path ends at its first miss (early exit).  A miss stays a miss: the
//   ray's o and d change only on a hit, tmin never decreases from one
//   bounce to the next (0, then BOUNCE_RAY_TMIN) and tmax is INF, so each
//   later bounce's search returns the same winner, whose hit test misses
//   again, and the later bounces would change no carry.  The lane writes
//   -1 to its later hit planes and, in the with_aux form, the missed
//   bounce's aux values (pos = o + d * 0, the attenuation-on mask = the
//   winner's material is glass: on a miss the normal is zero) to them,
//   which is what those bounces compute.  The one case where the search
//   could change is a primary ray (tmin 0) whose best t lies in
//   (0, BOUNCE_RAY_TMIN]; such a lane runs one more bounce;
// - the carry (origin, direction, throughput, radiance, first-hit normal
//   and t) stays in registers for all bounces; every output is a plane of
//   R floats or ints, written once.
//
// The seed is a word in device memory, as the Pallas kernel's scalar-prefetch
// seed_ref is (mega_kernel.py:136), read once a block: a CUDA graph that
// captured a launch replays whatever seed is written there.
//
// Phase B of the split trace passes n_alive (read on the device, no host
// sync) and an alive mask: the counter stops at n_alive, a masked lane
// publishes neutral outputs (zeros, hit -1, aux 0) without a search, and
// the lanes in [n_alive, R) get the same, one a thread, after the block's
// paths, with no search.
//
// The with_aux form (textured scenes, pallas_mega_trace(with_aux=True)):
// per bounce b it also writes aux[4b + 0..2] = the hit position the bounce
// body already holds and aux[4b + 3] = the attenuation-on mask (glass, or
// dot(normal, bounce) > 0), four stores a bounce and no new arithmetic;
// inactive lanes write zeros.  It is a second instantiation (AUX = true),
// so the untextured kernel carries none of it.
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
  int* counter;         // the ray counter, 0 at launch
  unsigned long long* stats;  // null, or [2]: lane searches with a ray, warp lane slots
  const int* seed;       // the seed word: PCG4D's fourth key, read on the device
  int R, n_s, n_p, n_c, n_rep, n_pad, depth, start_bounce;
};

// Neutral outputs of lane i (inactive: past n_alive, or masked)
template <bool AUX>
__device__ __forceinline__ void mega_neutral(const MegaParams& p, int i) {
  const int R = p.R;
  for (int k = 0; k < 14; ++k) p.out_f[k * R + i] = 0.0f;
  if (p.out_o) for (int k = 0; k < 3; ++k) p.out_o[k * R + i] = 0.0f;
  for (int b = 0; b < p.depth; ++b) p.hits[b * R + i] = -1;
  if (AUX)
    for (int k = 0; k < 4 * p.depth; ++k) p.aux[(size_t)k * R + i] = 0.0f;
}

// -------------------------------------------------------------- kernel
// The paths of lanes [0, n_work) that the block's warps take: stage the
// tables, then each warp takes rays from the counter until it runs dry.
template <bool AUX>
__device__ __forceinline__ void mega_paths(const MegaParams& p, int n_work) {
  const int R = p.R;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* ts = smem + 8 * p.n_rep;
  float* trt = ts + POCA_F_S * p.n_pad;
  const int n_geom = 8 * p.n_rep, n_ts = POCA_F_S * p.n_pad, n_tr = POCA_F_R * p.n_pad;
  for (int k = threadIdx.x; k < n_geom; k += blockDim.x) smem[k] = __ldg(p.geom + k);
  for (int k = threadIdx.x; k < n_ts; k += blockDim.x) ts[k] = __ldg(p.ts + k);
  for (int k = threadIdx.x; k < n_tr; k += blockDim.x) trt[k] = __ldg(p.trt + k);
  // the seed word, read once a block (a graph replays any seed written there)
  __shared__ uint32_t seed;
  if (threadIdx.x == 0) seed = (uint32_t)__ldg(p.seed);
  __syncthreads();

  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  // this lane's ray (-1: none) and the carry of its path at bounce b
  int i = -1, b = 0;
  V3 o = zero3(), d = v3(0.0f, 1.0f, 0.0f), thru = zero3(), rad = zero3(), first_n = zero3();
  float first_t = 0.0f;
  bool alive = false;
  uint32_t pix = 0, samp = 0;
  bool drained = false;
  unsigned long long n_search = 0, n_slots = 0;

  for (;;) {
    // idle lanes take the next rays, a warp-wide atomicAdd at a time
    unsigned idle = __ballot_sync(full, i < 0);
    while (idle && !drained) {
      const int n = __popc(idle), leader = __ffs(idle) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(p.counter, n);
      base = __shfl_sync(full, base, leader);
      drained = base + n >= n_work;
      const int k = base + __popc(idle & below);
      if (i < 0 && k < n_work) {
        if (p.amask != nullptr && p.amask[k] != 0.0f) {
          mega_neutral<AUX>(p, k);
        } else {
          i = k;
          b = 0;
          o = v3(p.ox[k], p.oy[k], p.oz[k]);
          d = v3(p.dx[k], p.dy[k], p.dz[k]);
          thru = p.tx ? v3(p.tx[k], p.ty[k], p.tz[k]) : v3(1.0f, 1.0f, 1.0f);
          rad = zero3();
          first_n = zero3();
          first_t = 0.0f;
          alive = true;
          pix = (uint32_t)p.pix[k];
          samp = (uint32_t)p.samp[k];
        }
      }
      idle = __ballot_sync(full, i < 0);
    }
    if (idle == full) break;  // drained, and no lane holds a ray

    const bool on = i >= 0;
    const float tmin = (p.start_bounce + b == 0) ? 0.0f : POCA_TMIN_BOUNCE;
    float best_t;
    const int w = poca_winner_search(smem4, p.n_s, p.n_p, p.n_c, on, o.x, o.y, o.z,
                                    d.x, d.y, d.z, tmin, POCA_INF, best_t);
    if (p.stats) {
      n_search += __popc(~idle);
      n_slots += 32;
    }
    if (!on) continue;

    float u1, u2, u3;
    uniforms3(pix, samp, (uint32_t)(1 + p.start_bounce + b), seed, u1, u2, u3);
    BounceFwd bf;
    // a search that found no object is a miss (w is 0 there, whose recompute
    // could pass: a ray leaving object 0's surface)
    bounce_body_in(ts, trt, p.n_pad, w, o, d, tmin, best_t < POCA_INF ? POCA_INF : tmin, u1, u2,
                   u3, bf);
    const bool hit = bf.hit;
    p.hits[b * R + i] = hit ? w : -1;
    const V3 normal = bf.normal;
    const float t = bf.h.t;
    const V3 pos = bf.pos;
    const V3 bounce = bf.s.bounce, atten = bf.s.atten, emitted = bf.s.emitted;
    const float att_on = bf.s.atten_on ? 1.0f : 0.0f;
    if (AUX) {
      float* a = p.aux + (size_t)(4 * b) * R + i;
      a[0] = pos.x;
      a[R] = pos.y;
      a[2 * (size_t)R] = pos.z;
      a[3 * (size_t)R] = att_on;
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

    const bool stop = !hit && (tmin != 0.0f || best_t > POCA_TMIN_BOUNCE);
    if (!stop && ++b < p.depth) continue;

    // the path is done: the bounces it skips, then its outputs
    for (int bb = b + 1; stop && bb < p.depth; ++bb) {
      p.hits[bb * R + i] = -1;
      if (AUX) {
        float* a = p.aux + (size_t)(4 * bb) * R + i;
        a[0] = pos.x;
        a[R] = pos.y;
        a[2 * (size_t)R] = pos.z;
        a[3 * (size_t)R] = att_on;
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
    i = -1;
  }
  if (p.stats && lane == 0) {
    atomicAdd(p.stats, n_search);
    atomicAdd(p.stats + 1, n_slots);
  }
}

template <bool AUX>
__global__ void __launch_bounds__(POCA_MEGA_BLOCK)
mega_trace_kernel(MegaParams p) {
  const int R = p.R;
  const int n_work = p.n_alive ? min(max(*p.n_alive, 0), R) : R;
  if (n_work > 0) mega_paths<AUX>(p, n_work);
  // the lanes past n_alive, one a thread: neutral outputs
  const int i = n_work + blockIdx.x * blockDim.x + threadIdx.x;
  if (i < R) mega_neutral<AUX>(p, i);
}

// The kernel of a form and its dynamic shared memory per block (opted
// into above 48 KB).
static int mega_shape(bool aux, int n_rep, int n_pad, void (**kern)(MegaParams), size_t* smem) {
  *kern = aux ? mega_trace_kernel<true> : mega_trace_kernel<false>;
  *smem = sizeof(float) * (8 * (size_t)n_rep + (POCA_F_S + POCA_F_R) * (size_t)n_pad);
  if (*smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(*kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)*smem);
  return 0;
}

extern "C" int poca_mega_trace(
    const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz,
    const float* tx, const float* ty, const float* tz,
    const int* pix, const int* samp,
    const float* geom, const float* ts, const float* trt,
    const int* n_alive, const float* amask,
    float* out_f, float* out_o, int* hits, float* aux, int* counter,
    unsigned long long* stats, const int* seed,
    int R, int n_s, int n_p, int n_c, int n_rep, int n_pad, int depth,
    int start_bounce, cudaStream_t stream) {
  if (R <= 0) return 0;
  MegaParams p = {ox, oy, oz, dx, dy, dz, tx, ty, tz, pix, samp, geom, ts, trt,
                  n_alive, amask, out_f, out_o, hits, aux, counter, stats, seed,
                  R, n_s, n_p, n_c, n_rep, n_pad, depth, start_bounce};
  void (*kern)(MegaParams);
  size_t smem = 0;
  const int err = mega_shape(aux != nullptr, n_rep, n_pad, &kern, &smem);
  if (err) return err;
  cudaError_t e = cudaMemsetAsync(counter, 0, sizeof(int), stream);
  if (e != cudaSuccess) return (int)e;
  kern<<<(R + POCA_MEGA_BLOCK - 1) / POCA_MEGA_BLOCK, POCA_MEGA_BLOCK, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// A form's registers, local bytes per thread, resident blocks per SM and
// the grid of a launch over R lanes, into info[0..3].
extern "C" int poca_mega_info(int aux, int R, int n_rep, int n_pad, int* info) {
  void (*kern)(MegaParams);
  size_t smem = 0;
  const int err = mega_shape(aux != 0, n_rep, n_pad, &kern, &smem);
  if (err) return err;
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, kern);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, POCA_MEGA_BLOCK, smem);
  if (e != cudaSuccess) return (int)e;
  info[0] = fa.numRegs;
  info[1] = (int)fa.localSizeBytes;
  info[2] = per_sm;
  info[3] = (R + POCA_MEGA_BLOCK - 1) / POCA_MEGA_BLOCK;
  return 0;
}

// The shared memory one block of `device` may opt into
// (cudaDevAttrMaxSharedMemoryPerBlockOptin; 232,448 bytes on the H100).
extern "C" int poca_smem_optin(int device, int* out) {
  return (int)cudaDeviceGetAttribute(out, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}
