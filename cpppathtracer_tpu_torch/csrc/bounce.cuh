// The forward bounce body shared by the megakernel (mega_trace.cu) and its
// backward (mega_bwd.cu / mega_bwd.cuh): PCG4D uniforms, vector helpers,
// the hit attributes of the winner's primitive (planar.object_hit_attrs_p)
// and BSDF sampling (planar.shade_p).  Both kernels run this same code, so
// the backward's forward sweep rebuilds the forward kernel's carries
// bitwise (both are built with --fmad=false).
//
// hit_attrs and shade record their intermediates (HitFwd, ShadeFwd) for
// the adjoints in mega_bwd.cuh; the forward kernel reads only the results,
// and the compiler drops the rest.
//
// Every function here is host-and-device: tests/mega_bwd_host.cpp compiles
// the backward's per-ray body for the CPU to hold its adjoints against
// torch autograd without a card.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define POCA_HD __host__ __device__ __forceinline__
#else
#include <math.h>
#define POCA_HD inline
#endif

#ifndef POCA_INF
#define POCA_INF 1e30f
#endif
#define POCA_EPS 1e-12f
#define POCA_TMIN_BOUNCE 2e-5f
#define POCA_TWO_PI 6.283185307179586f
#define POCA_F_S 13
#define POCA_F_R 4

// ---------------------------------------------------------------- RNG
POCA_HD void pcg4d(uint32_t& x, uint32_t& y, uint32_t& z, uint32_t& w) {
  const uint32_t mul = 1664525u, add = 1013904223u;
  x = x * mul + add; y = y * mul + add; z = z * mul + add; w = w * mul + add;
  x += y * w; y += z * x; z += x * y; w += y * z;
  x ^= x >> 16; y ^= y >> 16; z ^= z >> 16; w ^= w >> 16;
  x += y * w; y += z * x; z += x * y; w += y * z;
}

POCA_HD float u24(uint32_t v) {
  return (float)(v >> 8) * 5.9604644775390625e-08f;  // 2^-24
}

// The first three uniforms of key (pixel, sample, counter, seed)
POCA_HD void uniforms3(uint32_t pix, uint32_t samp, uint32_t ctr, uint32_t seed,
                       float& u1, float& u2, float& u3) {
  uint32_t x = pix, y = samp, z = ctr, w = seed;
  pcg4d(x, y, z, w);
  u1 = u24(x); u2 = u24(y); u3 = u24(z);
}

// ---------------------------------------------------------------- vec
struct V3 { float x, y, z; };

POCA_HD V3 v3(float x, float y, float z) { V3 r = {x, y, z}; return r; }
POCA_HD V3 zero3() { return v3(0.0f, 0.0f, 0.0f); }
POCA_HD float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
POCA_HD V3 scale(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
POCA_HD V3 add(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
POCA_HD V3 sub(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
POCA_HD V3 mul(V3 a, V3 b) { return v3(a.x * b.x, a.y * b.y, a.z * b.z); }
POCA_HD V3 sel(bool c, V3 a, V3 b) { return c ? a : b; }
POCA_HD V3 cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
POCA_HD V3 normalize(V3 v) {
  const float n2 = dot(v, v);
  const float inv = n2 > 0.0f ? 1.0f / sqrtf(fmaxf(n2, POCA_EPS)) : 0.0f;
  return scale(v, inv);
}

// ------------------------------------------------------- hit attributes
// planar.object_hit_attrs_p for the winner's primitive only (the other
// branches are discarded by its selects, so skipping them changes nothing,
// in value or in gradient).
// The intermediates of each primitive share their storage: only the
// winner's are ever set or read, and the backward holds them across the
// shading adjoint, so a union keeps them in as many registers as the
// largest needs rather than in all three's sum.
struct HitFwd {
  int prim;
  float t;
  V3 n;
  float dy_safe;
  union {
    struct {  // sphere
      V3 ac, pc;
      float a, b, cq, disc, sq, a_safe, t_sn, t_sf, t_s, r_safe;
      bool has, v_sn, v_sf;
    };
    struct {  // platform
      float t_pl;
      bool v_pl;
    };
    struct {  // cylinder
      float t_capk[2];
      bool v_capk[2];
      float axc, rx, rz, bc, cc, disc_c, sq_c, ax_safe, t_ln, t_lf, t_cap, t_lat, t_c;
      bool has_c, ok_n, ok_f, is_cap;
      V3 radial;
    };
  };
};

POCA_HD void hit_attrs(int prim, V3 c, float radius, float y_pos, float height, V3 o, V3 d,
                       float tmin, float tmax, HitFwd& h) {
  h.prim = prim;
  const float sgn = d.y > 0.0f ? 1.0f : (d.y < 0.0f ? -1.0f : 0.0f);
  const V3 n_plat = v3(0.0f, -sgn, 0.0f);
  h.dy_safe = d.y == 0.0f ? 1.0f : d.y;
  const float dy_safe = h.dy_safe;
  if (prim == 0) {  // sphere (object.cu:10-35)
    h.ac = sub(o, c);
    const V3 ac = h.ac;
    h.a = d.x * d.x + d.y * d.y + d.z * d.z;
    h.b = ac.x * d.x + ac.y * d.y + ac.z * d.z;
    h.cq = ac.x * ac.x + ac.y * ac.y + ac.z * ac.z - radius * radius;
    h.disc = h.b * h.b - h.a * h.cq;
    h.has = h.disc > 0.0f;
    h.sq = sqrtf(h.has ? h.disc : 1.0f);
    h.a_safe = h.a == 0.0f ? 1.0f : h.a;
    h.t_sn = (-h.b - h.sq) / h.a_safe;
    h.t_sf = (-h.b + h.sq) / h.a_safe;
    h.v_sn = h.has && (h.t_sn < tmax) && (h.t_sn > tmin);
    h.v_sf = h.has && (h.t_sf < tmax) && (h.t_sf > tmin);
    const float t = h.v_sn ? h.t_sn : (h.v_sf ? h.t_sf : POCA_INF);
    h.t_s = t < POCA_INF ? t : 0.0f;
    const V3 p = v3(o.x + h.t_s * d.x, o.y + h.t_s * d.y, o.z + h.t_s * d.z);
    h.pc = sub(p, c);
    h.r_safe = radius == 0.0f ? 1.0f : radius;
    const float inv_r = 1.0f / h.r_safe;
    h.n = h.v_sn ? scale(h.pc, inv_r) : normalize(h.pc);
    h.t = t;
  } else if (prim == 1) {  // platform (object.cu:37-48)
    const bool crossing = ((o.y < y_pos) && (d.y > 0.0f)) || ((o.y > y_pos) && (d.y < 0.0f));
    h.t_pl = (y_pos - o.y) / dy_safe;
    h.v_pl = crossing && (h.t_pl < tmax) && (h.t_pl > tmin);
    h.t = h.v_pl ? h.t_pl : POCA_INF;
    h.n = n_plat;
  } else if (prim == 2) {  // cylinder (object.cu:50-112)
    const float y_top = c.y + height * 0.5f;
    const float y_bot = c.y - height * 0.5f;
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
      h.t_capk[k] = t;
      h.v_capk[k] = v;
    }
    h.axc = d.x * d.x + d.z * d.z;
    h.rx = o.x - c.x;
    h.rz = o.z - c.z;
    h.bc = h.rx * d.x + h.rz * d.z;
    h.cc = h.rx * h.rx + h.rz * h.rz - radius * radius;
    h.disc_c = h.bc * h.bc - h.axc * h.cc;
    h.has_c = h.disc_c > 0.0f;
    h.sq_c = sqrtf(h.has_c ? h.disc_c : 1.0f);
    h.ax_safe = h.axc == 0.0f ? 1.0f : h.axc;
    h.t_ln = (-h.bc - h.sq_c) / h.ax_safe;
    h.t_lf = (-h.bc + h.sq_c) / h.ax_safe;
    const float hy_n = o.y + h.t_ln * d.y;
    const float hy_f = o.y + h.t_lf * d.y;
    h.ok_n = h.has_c && (h.t_ln < tmax) && (h.t_ln > tmin) && (hy_n > y_bot) && (hy_n < y_top);
    h.ok_f = h.has_c && (h.t_lf < tmax) && (h.t_lf > tmin) && (hy_f > y_bot) && (hy_f < y_top);
    h.t_cap = fminf(h.v_capk[0] ? h.t_capk[0] : POCA_INF, h.v_capk[1] ? h.t_capk[1] : POCA_INF);
    h.t_lat = fminf(h.ok_n ? h.t_ln : POCA_INF, h.ok_f ? h.t_lf : POCA_INF);
    const float t = fminf(h.t_cap, h.t_lat);
    h.is_cap = (t == h.t_cap) && (h.t_cap < POCA_INF);
    h.t_c = t < POCA_INF ? t : 0.0f;
    h.radial = v3(o.x + h.t_c * d.x - c.x, 0.0f, o.z + h.t_c * d.z - c.z);
    h.n = h.is_cap ? n_plat : normalize(h.radial);
    h.t = t;
  } else {
    h.t = POCA_INF;
    h.n = zero3();
  }
}

// ------------------------------------------------------------- shading
POCA_HD float schlick(float cosine, float ref_idx) {
  float r0 = (1.0f - ref_idx) / (1.0f + ref_idx);
  r0 = r0 * r0;
  const float m = fmaxf(1.0f - cosine, 0.0f);
  return r0 + (1.0f - r0) * m * m * m * m * m;
}

POCA_HD V3 to_world(float ax, float ay, float az, V3 n) {
  const bool use_x = fabsf(n.x) > fabsf(n.y);
  const float ilx = 1.0f / sqrtf(fmaxf(n.x * n.x + n.z * n.z, POCA_EPS));
  const float ily = 1.0f / sqrtf(fmaxf(n.y * n.y + n.z * n.z, POCA_EPS));
  const V3 c = v3(use_x ? n.z * ilx : 0.0f, use_x ? 0.0f : n.z * ily,
                  use_x ? -n.x * ilx : -n.y * ily);
  const V3 b = cross(c, n);
  return v3(ax * b.x + ay * c.x + az * n.x, ax * b.y + ay * c.y + az * n.y,
            ax * b.z + ay * c.z + az * n.z);
}

enum { POCA_BASE_NORMAL = 0, POCA_BASE_REFLECT = 1, POCA_BASE_REFRACT = 2 };

struct ShadeFwd {
  bool is_mirror, is_glass, is_diffuse, mirror_reflects, glass_reflects;
  bool inside, refract_ok, atten_on, phong;
  int base_src;
  float alpha_phong, s2, ni, cos_arg, cos_in, cosine, dt, sq, reflect_prob;
  float alpha, log_u, inv_a, lz, y, r_arg, r, cphi, sphi;
  V3 on, uv, refr_raw, base;
  V3 bounce, atten, emitted;
};

// planar.shade_p with score_grad=False: the score-function weight is 1.0
// in value, so the attenuation is the same; its gradient is the adjoint's.
POCA_HD void shade(int mat_type, V3 kd, float emission, float smoothness, float reflectivity,
                   float ior, V3 normal, V3 in_dir, float u1, float u2, float u3, ShadeFwd& s) {
  const bool is_metal = mat_type == 1, is_mirror = mat_type == 2, is_glass = mat_type == 3;
  const bool is_diffuse = !(is_metal || is_mirror || is_glass);
  s.is_mirror = is_mirror; s.is_glass = is_glass; s.is_diffuse = is_diffuse;

  s.alpha_phong = powf(1000.0f, smoothness);
  s.s2 = 2.0f * dot(in_dir, normal);
  const V3 reflect_dir = v3(in_dir.x - s.s2 * normal.x, in_dir.y - s.s2 * normal.y,
                            in_dir.z - s.s2 * normal.z);
  s.mirror_reflects = u3 < reflectivity;

  const float d_dot_n = dot(in_dir, normal);
  s.inside = d_dot_n > 0.0f;
  s.on = s.inside ? scale(normal, -1.0f) : normal;
  s.ni = s.inside ? ior : 1.0f / (ior == 0.0f ? 1.0f : ior);
  s.cos_arg = 1.0f - ior * ior * (1.0f - d_dot_n * d_dot_n);
  s.cos_in = s.cos_arg > 0.0f ? sqrtf(s.cos_arg) : 0.0f;
  s.cosine = s.inside ? s.cos_in : -d_dot_n;

  // refract(in_dir, on, ni)
  const V3 on = s.on;
  const float ni = s.ni;
  s.uv = normalize(in_dir);
  const V3 uv = s.uv;
  s.dt = dot(uv, on);
  const float dt = s.dt;
  const float disc = 1.0f - ni * ni * (1.0f - dt * dt);
  s.refract_ok = disc > 0.0f;
  s.sq = sqrtf(s.refract_ok ? disc : 1.0f);
  const float sq = s.sq;
  s.refr_raw = v3(ni * (uv.x - on.x * dt) - on.x * sq,
                  ni * (uv.y - on.y * dt) - on.y * sq,
                  ni * (uv.z - on.z * dt) - on.z * sq);
  const V3 refracted = s.refract_ok ? normalize(s.refr_raw) : zero3();
  s.reflect_prob = s.refract_ok ? schlick(s.cosine, ior) : 1.0f;
  s.glass_reflects = u3 < s.reflect_prob;

  s.phong = !is_diffuse && !(is_mirror && !s.mirror_reflects);
  s.alpha = is_diffuse ? 2.0f
            : ((is_mirror && !s.mirror_reflects) ? 2.0f : s.alpha_phong);
  s.base_src = is_diffuse ? POCA_BASE_NORMAL
               : is_mirror ? (s.mirror_reflects ? POCA_BASE_REFLECT : POCA_BASE_NORMAL)
               : is_glass ? (s.glass_reflects ? POCA_BASE_REFLECT : POCA_BASE_REFRACT)
               : POCA_BASE_REFLECT;
  s.base = s.base_src == POCA_BASE_NORMAL ? normal
           : s.base_src == POCA_BASE_REFLECT ? reflect_dir : refracted;

  // Phong lobe (material.cu:23-26), r^2 = -expm1(y) as -tanh(y/2)(e^y+1)
  s.log_u = logf(fmaxf(u1, 1e-38f));
  s.inv_a = 1.0f / s.alpha;
  s.lz = expf(s.log_u * s.inv_a);
  s.y = 2.0f * s.log_u * s.inv_a;
  s.r_arg = -tanhf(0.5f * s.y) * (expf(s.y) + 1.0f);
  s.r = sqrtf(fmaxf(s.r_arg, 0.0f));
  const float phi = POCA_TWO_PI * u2;
  s.cphi = cosf(phi);
  s.sphi = sinf(phi);
  s.bounce = to_world(s.r * s.cphi, s.r * s.sphi, s.lz, s.base);

  s.atten_on = is_glass || (dot(normal, s.bounce) > 0.0f);
  s.atten = s.atten_on ? kd : zero3();
  s.emitted = scale(kd, emission);
}

// ------------------------------------------------------- one bounce
// The bounce from the winner's record onward: record fetch from the
// transposed tables (ts[f * np + w], trt[f * np + w]), hit attributes, the
// gather epilogue (t_safe, pos, zeroed normal on a miss) and shading.
struct BounceFwd {
  HitFwd h;
  ShadeFwd s;
  bool hit;  // recomputed: t < INF
  float t_safe;
  V3 pos, normal;
  V3 center, kd;
  float radius, emission, smoothness, reflectivity, ior;
};

POCA_HD void bounce_body(const float* ts, const float* trt, int np, int w, V3 o, V3 d,
                         float tmin, float u1, float u2, float u3, BounceFwd& f) {
  const float* col = ts + w;  // ts[field * np + w]
  f.center = v3(col[0], col[np], col[2 * np]);
  f.radius = col[3 * np];
  hit_attrs((int)col[6 * np], f.center, f.radius, col[4 * np], col[5 * np], o, d, tmin,
            POCA_INF, f.h);
  f.hit = f.h.t < POCA_INF;
  f.t_safe = f.hit ? f.h.t : 0.0f;
  f.pos = add(o, scale(d, f.t_safe));
  f.normal = f.hit ? f.h.n : zero3();
  f.kd = v3(trt[w], trt[np + w], trt[2 * np + w]);
  f.emission = trt[3 * np + w];
  f.smoothness = col[8 * np];
  f.reflectivity = col[9 * np];
  f.ior = col[10 * np];
  shade((int)col[7 * np], f.kd, f.emission, f.smoothness, f.reflectivity, f.ior, f.normal, d,
        u1, u2, u3, f.s);
}
