// The bounce-loop megakernel: every bounce of every ray in one launch.
//
// Replaces cpppathtracer_tpu/ops/pallas/mega_kernel.py::pallas_mega_trace
// (body _mega_kernel, RNG _uniforms3).  Per ray and bounce: winner search
// (winner.cuh), winner record fetch, hit attributes
// (planar.object_hit_attrs_p), PCG4D uniforms, BSDF sampling
// (planar.shade_p, forward form) and the carry updates.  The arithmetic
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
#include <cstdint>
#include <cuda_runtime.h>

#include "winner.cuh"

#define POCA_EPS 1e-12f
#define POCA_TMIN_BOUNCE 2e-5f
#define POCA_TWO_PI 6.283185307179586f
#define POCA_MEGA_BLOCK 128
#define POCA_F_S 13
#define POCA_F_R 4

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
  int R, n_s, n_p, n_c, n_rep, n_pad, depth, start_bounce;
  uint32_t seed;
};

// ---------------------------------------------------------------- RNG
__device__ __forceinline__ void pcg4d(uint32_t& x, uint32_t& y, uint32_t& z, uint32_t& w) {
  const uint32_t mul = 1664525u, add = 1013904223u;
  x = x * mul + add; y = y * mul + add; z = z * mul + add; w = w * mul + add;
  x += y * w; y += z * x; z += x * y; w += y * z;
  x ^= x >> 16; y ^= y >> 16; z ^= z >> 16; w ^= w >> 16;
  x += y * w; y += z * x; z += x * y; w += y * z;
}

__device__ __forceinline__ float u24(uint32_t v) {
  return (float)(v >> 8) * 5.9604644775390625e-08f;  // 2^-24
}

// ---------------------------------------------------------------- vec
struct V3 { float x, y, z; };

__device__ __forceinline__ V3 v3(float x, float y, float z) { V3 r = {x, y, z}; return r; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 scale(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ V3 add(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ V3 mul(V3 a, V3 b) { return v3(a.x * b.x, a.y * b.y, a.z * b.z); }
__device__ __forceinline__ V3 sel(bool c, V3 a, V3 b) { return c ? a : b; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
__device__ __forceinline__ V3 normalize(V3 v) {
  const float n2 = dot(v, v);
  const float inv = n2 > 0.0f ? 1.0f / sqrtf(fmaxf(n2, POCA_EPS)) : 0.0f;
  return scale(v, inv);
}

// ------------------------------------------------------- hit attributes
// planar.object_hit_attrs_p for the winner's primitive only (the other
// branches are discarded by its selects, so skipping them changes nothing).
__device__ void hit_attrs(int prim, V3 c, float radius, float y_pos, float height,
                          V3 o, V3 d, float tmin, float tmax, float& t_out, V3& n_out) {
  const float sgn = d.y > 0.0f ? 1.0f : (d.y < 0.0f ? -1.0f : 0.0f);
  const V3 n_plat = v3(0.0f, -sgn, 0.0f);
  const float dy_safe = d.y == 0.0f ? 1.0f : d.y;
  if (prim == 0) {  // sphere (object.cu:10-35)
    const V3 ac = sub(o, c);
    const float a = d.x * d.x + d.y * d.y + d.z * d.z;
    const float b = ac.x * d.x + ac.y * d.y + ac.z * d.z;
    const float cq = ac.x * ac.x + ac.y * ac.y + ac.z * ac.z - radius * radius;
    const float disc = b * b - a * cq;
    const bool has = disc > 0.0f;
    const float sq = sqrtf(has ? disc : 1.0f);
    const float a_safe = a == 0.0f ? 1.0f : a;
    const float t_sn = (-b - sq) / a_safe;
    const float t_sf = (-b + sq) / a_safe;
    const bool v_sn = has && (t_sn < tmax) && (t_sn > tmin);
    const bool v_sf = has && (t_sf < tmax) && (t_sf > tmin);
    const float t = v_sn ? t_sn : (v_sf ? t_sf : POCA_INF);
    const float ts = t < POCA_INF ? t : 0.0f;
    const V3 p = v3(o.x + ts * d.x, o.y + ts * d.y, o.z + ts * d.z);
    const V3 pc = sub(p, c);
    const float inv_r = 1.0f / (radius == 0.0f ? 1.0f : radius);
    n_out = v_sn ? scale(pc, inv_r) : normalize(pc);
    t_out = t;
  } else if (prim == 1) {  // platform (object.cu:37-48)
    const bool crossing = ((o.y < y_pos) && (d.y > 0.0f)) || ((o.y > y_pos) && (d.y < 0.0f));
    const float t = (y_pos - o.y) / dy_safe;
    const bool v = crossing && (t < tmax) && (t > tmin);
    t_out = v ? t : POCA_INF;
    n_out = n_plat;
  } else if (prim == 2) {  // cylinder (object.cu:50-112)
    const float y_top = c.y + height * 0.5f;
    const float y_bot = c.y - height * 0.5f;
    float t_cap_k[2];
    const float planes[2] = {y_top, y_bot};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float yp = planes[k];
      const bool crossing = ((o.y < yp) && (d.y > 0.0f)) || ((o.y > yp) && (d.y < 0.0f));
      const float t = (yp - o.y) / dy_safe;
      const float ex = o.x + t * d.x - c.x;
      const float ez = o.z + t * d.z - c.z;
      const float r2 = ex * ex + ez * ez;
      const bool v = crossing && (t < tmax) && (t > tmin) && (radius > 0.0f) &&
                     (r2 < radius * radius);
      t_cap_k[k] = v ? t : POCA_INF;
    }
    const float axc = d.x * d.x + d.z * d.z;
    const float rx = o.x - c.x, rz = o.z - c.z;
    const float bc = rx * d.x + rz * d.z;
    const float cc = rx * rx + rz * rz - radius * radius;
    const float disc = bc * bc - axc * cc;
    const bool has = disc > 0.0f;
    const float sq = sqrtf(has ? disc : 1.0f);
    const float ax_safe = axc == 0.0f ? 1.0f : axc;
    const float t_ln = (-bc - sq) / ax_safe;
    const float t_lf = (-bc + sq) / ax_safe;
    const float hy_n = o.y + t_ln * d.y;
    const float hy_f = o.y + t_lf * d.y;
    const bool ok_n = has && (t_ln < tmax) && (t_ln > tmin) && (hy_n > y_bot) && (hy_n < y_top);
    const bool ok_f = has && (t_lf < tmax) && (t_lf > tmin) && (hy_f > y_bot) && (hy_f < y_top);
    const float t_cap = fminf(t_cap_k[0], t_cap_k[1]);
    const float t_lat = fminf(ok_n ? t_ln : POCA_INF, ok_f ? t_lf : POCA_INF);
    const float t = fminf(t_cap, t_lat);
    const bool is_cap = (t == t_cap) && (t_cap < POCA_INF);
    const float ts = t < POCA_INF ? t : 0.0f;
    const V3 radial = v3(o.x + ts * d.x - c.x, 0.0f, o.z + ts * d.z - c.z);
    n_out = is_cap ? n_plat : normalize(radial);
    t_out = t;
  } else {
    t_out = POCA_INF;
    n_out = v3(0.0f, 0.0f, 0.0f);
  }
}

// ------------------------------------------------------------- shading
__device__ __forceinline__ float schlick(float cosine, float ref_idx) {
  float r0 = (1.0f - ref_idx) / (1.0f + ref_idx);
  r0 = r0 * r0;
  const float m = fmaxf(1.0f - cosine, 0.0f);
  return r0 + (1.0f - r0) * m * m * m * m * m;
}

__device__ __forceinline__ V3 to_world(float ax, float ay, float az, V3 n) {
  const bool use_x = fabsf(n.x) > fabsf(n.y);
  const float ilx = 1.0f / sqrtf(fmaxf(n.x * n.x + n.z * n.z, POCA_EPS));
  const float ily = 1.0f / sqrtf(fmaxf(n.y * n.y + n.z * n.z, POCA_EPS));
  const V3 c = v3(use_x ? n.z * ilx : 0.0f, use_x ? 0.0f : n.z * ily,
                  use_x ? -n.x * ilx : -n.y * ily);
  const V3 b = cross(c, n);
  return v3(ax * b.x + ay * c.x + az * n.x, ax * b.y + ay * c.y + az * n.y,
            ax * b.z + ay * c.z + az * n.z);
}

// planar.shade_p with score_grad=False
__device__ void shade(int mat_type, V3 kd, float emission, float smoothness,
                      float reflectivity, float ior, V3 normal, V3 in_dir,
                      float u1, float u2, float u3, V3& bounce, V3& atten, V3& emitted) {
  const bool is_metal = mat_type == 1, is_mirror = mat_type == 2, is_glass = mat_type == 3;
  const bool is_diffuse = !(is_metal || is_mirror || is_glass);

  const float alpha_phong = powf(1000.0f, smoothness);
  const float s = 2.0f * dot(in_dir, normal);
  const V3 reflect_dir = v3(in_dir.x - s * normal.x, in_dir.y - s * normal.y,
                            in_dir.z - s * normal.z);
  const bool mirror_reflects = u3 < reflectivity;

  const float d_dot_n = dot(in_dir, normal);
  const bool inside = d_dot_n > 0.0f;
  const V3 on = inside ? scale(normal, -1.0f) : normal;
  const float ni = inside ? ior : 1.0f / (ior == 0.0f ? 1.0f : ior);
  const float cos_arg = 1.0f - ior * ior * (1.0f - d_dot_n * d_dot_n);
  const float cos_in = cos_arg > 0.0f ? sqrtf(cos_arg) : 0.0f;
  const float cosine = inside ? cos_in : -d_dot_n;

  // refract(in_dir, on, ni)
  const V3 uv = normalize(in_dir);
  const float dt = dot(uv, on);
  const float disc = 1.0f - ni * ni * (1.0f - dt * dt);
  const bool refract_ok = disc > 0.0f;
  const float sq = sqrtf(refract_ok ? disc : 1.0f);
  const V3 refr_raw = v3(ni * (uv.x - on.x * dt) - on.x * sq,
                         ni * (uv.y - on.y * dt) - on.y * sq,
                         ni * (uv.z - on.z * dt) - on.z * sq);
  const V3 refracted = refract_ok ? normalize(refr_raw) : v3(0.0f, 0.0f, 0.0f);
  const float reflect_prob = refract_ok ? schlick(cosine, ior) : 1.0f;
  const bool glass_reflects = u3 < reflect_prob;

  const float alpha = is_diffuse ? 2.0f
                      : ((is_mirror && !mirror_reflects) ? 2.0f : alpha_phong);
  const V3 base = is_diffuse ? normal
                  : is_mirror ? (mirror_reflects ? reflect_dir : normal)
                  : is_glass ? (glass_reflects ? reflect_dir : refracted)
                  : reflect_dir;

  // Phong lobe (material.cu:23-26), r^2 = -expm1(y) as -tanh(y/2)(e^y+1)
  const float log_u = logf(fmaxf(u1, 1e-38f));
  const float inv_a = 1.0f / alpha;
  const float lz = expf(log_u * inv_a);
  const float y = 2.0f * log_u * inv_a;
  const float r = sqrtf(fmaxf(-tanhf(0.5f * y) * (expf(y) + 1.0f), 0.0f));
  const float phi = POCA_TWO_PI * u2;
  bounce = to_world(r * cosf(phi), r * sinf(phi), lz, base);

  const bool atten_on = is_glass || (dot(normal, bounce) > 0.0f);
  atten = atten_on ? kd : v3(0.0f, 0.0f, 0.0f);
  emitted = scale(kd, emission);
}

// -------------------------------------------------------------- kernel
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
    const int w = poca_winner_index(geom, p.n_s, p.n_p, p.n_c, o.x, o.y, o.z,
                                    d.x, d.y, d.z, tmin, tmax);
    const float* col = ts + w;  // ts[f * n_pad + w]
    const int np = p.n_pad;
    const V3 center = v3(col[0], col[np], col[2 * np]);
    const int prim = (int)col[6 * np];
    float t;
    V3 normal;
    hit_attrs(prim, center, col[3 * np], col[4 * np], col[5 * np], o, d, tmin, tmax,
              t, normal);
    const bool hit = t < POCA_INF;
    p.hits[b * R + i] = hit ? w : -1;
    const float t_safe = hit ? t : 0.0f;
    const V3 pos = add(o, scale(d, t_safe));
    normal = hit ? normal : v3(0.0f, 0.0f, 0.0f);

    uint32_t x = pix, y = samp, z = (uint32_t)(1 + p.start_bounce + b), ww = p.seed;
    pcg4d(x, y, z, ww);
    const float u1 = u24(x), u2 = u24(y), u3 = u24(z);

    const V3 kd = v3(trt[w], trt[np + w], trt[2 * np + w]);
    V3 bounce, atten, emitted;
    shade((int)col[7 * np], kd, trt[3 * np + w], col[8 * np], col[9 * np], col[10 * np],
          normal, d, u1, u2, u3, bounce, atten, emitted);

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
    float* out_f, float* out_o, int* hits,
    int R, int n_s, int n_p, int n_c, int n_rep, int n_pad, int depth,
    int start_bounce, int seed, cudaStream_t stream) {
  if (R <= 0) return 0;
  MegaParams p = {ox, oy, oz, dx, dy, dz, tx, ty, tz, pix, samp, geom, ts, trt,
                  n_alive, amask, out_f, out_o, hits,
                  R, n_s, n_p, n_c, n_rep, n_pad, depth, start_bounce, (uint32_t)seed};
  const size_t smem = sizeof(float) * (8 * (size_t)n_rep + (POCA_F_S + POCA_F_R) * (size_t)n_pad);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        mega_trace_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (R + POCA_MEGA_BLOCK - 1) / POCA_MEGA_BLOCK;
  mega_trace_kernel<<<grid, POCA_MEGA_BLOCK, smem, stream>>>(p);
  return (int)cudaGetLastError();
}
