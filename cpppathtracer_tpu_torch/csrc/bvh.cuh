// Skip-pointer BVH walk for one ray: the closest hit's grouped object index
// over the tables of ops/bvh.py (node_meta i32[M, 2] = escape, leaf_id;
// node_aabb f32[M, 8] = min.xyz, max.xyz, pad; leaf_objs f32[L*K, 8] =
// cx cy cz radius y_pos height prim_type gidx).
//
// Replaces the walk of cpppathtracer_tpu/ops/pallas/bvh_kernel.py
// (_bvh_kernel, _leaf_candidates).  TPU lanes cannot diverge, so the Pallas
// kernel shared one preorder walk across a tile of rays and entered a node
// when any lane of the tile overlapped it.  Here each thread walks on its
// own, without a stack:
//
//   node = 0
//   while node < M:
//     slab-test node against this ray's best t
//     overlap and leaf: test its K rows, node = escape
//     overlap:          node = node + 1
//     otherwise:        node = escape
//
// A ray visits a subset of the tile walk's leaves, in the same order, so
// the two agree except on exact float ties and on grazing hits that the
// slab test puts outside an AABB (sphere boxes carry no tolerance).
//
// The slab test and the leaf rows copy the Pallas kernel's arithmetic:
// inv_d = 1 / (d == 0 ? 1 : d), an axis with d == 0 is unconstrained
// (+-2 INF), overlap = lo <= hi && lo <= best_t && hi >= tmin; the leaf
// rows use _leaf_candidates' direct forms (sphere b = (o-c).d and
// c = |o-c|^2 - r^2; plane and cap t = (y - oy) * inv(dy), a product with a
// reciprocal; cylinder caps at cy +- hh*0.5), not winner.cuh's expanded
// ones: another rounding of t flips winners on grazing rays.  Within a leaf
// the least t wins and, among rows at that t, the lowest grouped index;
// the leaf's winner replaces the best only when strictly closer.  Rows test
// against tmax = best t, so the walk prunes as hits accumulate.  The result
// is the grouped index, or 0 when nothing is hit: the gather epilogue
// recomputes t and decides the hit.
//
// Every function is host-and-device: tests/bvh_host.cpp builds the walk for
// the CPU, where it is held bitwise against the plain PyTorch version
// (ops/cuda/bvh_kernel.py::bvh_winner_index_plain).  Build with
// --fmad=false (nvcc) or -ffp-contract=off (g++): nothing may contract
// a*b+c.
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

// FP32 operations per slab test and per leaf row by primitive type
// (adds, multiplies, divides, square roots, compares, selects, minima and
// maxima each count one), for chip_smoke.py's bound.
#define POCA_BVH_OPS_SLAB 33
#define POCA_BVH_OPS_SPHERE 38
#define POCA_BVH_OPS_PLATFORM 14
#define POCA_BVH_OPS_CYLINDER 90
#define POCA_BVH_OPS_PAD 5

// read-only loads: through the read-only data cache on the card
POCA_HD float bvh_ldf(const float* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

POCA_HD int bvh_ldi(const int* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

POCA_HD float bvh_inv(float v) { return 1.0f / (v == 0.0f ? 1.0f : v); }

// One ray and what its tests share: the reciprocals of d and of the
// quadratics' leading coefficients.
struct BvhRay {
  float ox, oy, oz, dx, dy, dz, tmin;
  float inv_dx, inv_dy, inv_dz;
  float a, inv_a;    // |d|^2
  float ax, inv_ax;  // dx^2 + dz^2
};

POCA_HD BvhRay bvh_ray(float ox, float oy, float oz, float dx, float dy, float dz,
                       float tmin) {
  BvhRay r;
  r.ox = ox; r.oy = oy; r.oz = oz;
  r.dx = dx; r.dy = dy; r.dz = dz;
  r.tmin = tmin;
  r.inv_dx = bvh_inv(dx); r.inv_dy = bvh_inv(dy); r.inv_dz = bvh_inv(dz);
  r.a = dx * dx + dy * dy + dz * dz;
  r.inv_a = bvh_inv(r.a);
  r.ax = dx * dx + dz * dz;
  r.inv_ax = bvh_inv(r.ax);
  return r;
}

// One axis of the slab test.  An axis with d == 0 is unconstrained: its
// interval (-2 INF, 2 INF) leaves lo and hi as they are.
POCA_HD void bvh_axis(float mn, float mx, float o, float d, float inv, float& lo, float& hi) {
  if (d == 0.0f) return;
  const float t0 = (mn - o) * inv;
  const float t1 = (mx - o) * inv;
  lo = fmaxf(lo, fminf(t0, t1));
  hi = fminf(hi, fmaxf(t0, t1));
}

POCA_HD bool bvh_overlap(const float* box, const BvhRay& r, float best_t) {
  float lo = -2.0f * POCA_INF, hi = 2.0f * POCA_INF;
  bvh_axis(bvh_ldf(box + 0), bvh_ldf(box + 3), r.ox, r.dx, r.inv_dx, lo, hi);
  bvh_axis(bvh_ldf(box + 1), bvh_ldf(box + 4), r.oy, r.dy, r.inv_dy, lo, hi);
  bvh_axis(bvh_ldf(box + 2), bvh_ldf(box + 5), r.oz, r.dz, r.inv_dz, lo, hi);
  return lo <= hi && lo <= best_t && hi >= r.tmin;
}

POCA_HD bool bvh_crosses(float oy, float dy, float y) {
  return (oy < y && dy > 0.0f) || (oy > y && dy < 0.0f);
}

// A cylinder's cap at height y (object.cu:50-112): t or INF.
POCA_HD float bvh_cap(const BvhRay& r, float y, float cx, float cz, float rr, float tmax) {
  const float t = (y - r.oy) * r.inv_dy;
  const float hx = r.ox + t * r.dx;
  const float hz = r.oz + t * r.dz;
  const float ex = hx - cx, ez = hz - cz;
  const float r2 = ex * ex + ez * ez;
  const bool v = bvh_crosses(r.oy, r.dy, y) && t < tmax && t > r.tmin && rr > 0.0f &&
                 r2 < rr * rr;
  return v ? t : POCA_INF;
}

POCA_HD bool bvh_lateral_ok(const BvhRay& r, bool has, float t, float tmax, float y_bot,
                            float y_top) {
  const float hy = r.oy + t * r.dy;
  return has && t < tmax && t > r.tmin && hy > y_bot && hy < y_top;
}

// The candidate t of one leaf row against [tmin, tmax] (object.cu:10-112);
// prim_type -1 (padding) never hits.
POCA_HD float bvh_row_t(const float* row, int pt, const BvhRay& r, float tmax) {
  const float cx = bvh_ldf(row + 0), cy = bvh_ldf(row + 1), cz = bvh_ldf(row + 2);
  const float rr = bvh_ldf(row + 3);
  if (pt == 0) {  // sphere
    const float ex = r.ox - cx, ey = r.oy - cy, ez = r.oz - cz;
    const float b = ex * r.dx + ey * r.dy + ez * r.dz;
    const float c = ex * ex + ey * ey + ez * ez - rr * rr;
    const float disc = b * b - r.a * c;
    const bool has = disc > 0.0f;
    const float sq = sqrtf(has ? disc : 1.0f);
    const float t_n = (-b - sq) * r.inv_a;
    const float t_f = (-b + sq) * r.inv_a;
    const bool nv = has && t_n < tmax && t_n > r.tmin;
    const bool fv = has && t_f < tmax && t_f > r.tmin;
    return nv ? t_n : (fv ? t_f : POCA_INF);
  }
  if (pt == 1) {  // platform
    const float y0 = bvh_ldf(row + 4);
    const float t = (y0 - r.oy) * r.inv_dy;
    const bool v = bvh_crosses(r.oy, r.dy, y0) && t < tmax && t > r.tmin;
    return v ? t : POCA_INF;
  }
  if (pt == 2) {  // capped cylinder
    const float hh = bvh_ldf(row + 5);
    const float y_top = cy + hh * 0.5f;
    const float y_bot = cy - hh * 0.5f;
    const float t_cap = fminf(bvh_cap(r, y_top, cx, cz, rr, tmax),
                              bvh_cap(r, y_bot, cx, cz, rr, tmax));
    const float ex = r.ox - cx, ez = r.oz - cz;
    const float bc = ex * r.dx + ez * r.dz;
    const float cc = ex * ex + ez * ez - rr * rr;
    const float disc = bc * bc - r.ax * cc;
    const bool has = disc > 0.0f;
    const float sq = sqrtf(has ? disc : 1.0f);
    const float t_n = (-bc - sq) * r.inv_ax;
    const float t_f = (-bc + sq) * r.inv_ax;
    const float t_lat = fminf(bvh_lateral_ok(r, has, t_n, tmax, y_bot, y_top) ? t_n : POCA_INF,
                              bvh_lateral_ok(r, has, t_f, tmax, y_bot, y_top) ? t_f : POCA_INF);
    return fminf(t_cap, t_lat);
  }
  return POCA_INF;
}

// What a walk tested: slab tests, and leaf rows by primitive type
// (sphere, platform, cylinder, padding).
struct BvhCounts {
  int nodes;
  int rows[4];
};

template <bool kCount>
POCA_HD int bvh_walk(const int* meta, const float* aabb, const float* objs, int m, int k,
                     const BvhRay& r, float tmax, BvhCounts* counts) {
  float best_t = tmax;
  int best_i = 0;
  int node = 0;
  while (node < m) {
    const bool overlap = bvh_overlap(aabb + 8 * (size_t)node, r, best_t);
    const int leaf = bvh_ldi(meta + 2 * node + 1);
    if (kCount) ++counts->nodes;
    if (overlap && leaf >= 0) {
      const float* rows = objs + (size_t)leaf * k * 8;
      float t_min = 0.0f;
      int win = 0;
      for (int j = 0; j < k; ++j) {
        const float* row = rows + 8 * j;
        const int pt = (int)bvh_ldf(row + 6);
        const float t = bvh_row_t(row, pt, r, best_t);
        const int g = (int)bvh_ldf(row + 7);
        if (kCount) ++counts->rows[pt >= 0 && pt <= 2 ? pt : 3];
        if (j == 0 || t < t_min) {
          t_min = t;
          win = g;
        } else if (t == t_min && g < win) {
          win = g;
        }
      }
      if (t_min < best_t) {
        best_t = t_min;
        best_i = win;
      }
      node = bvh_ldi(meta + 2 * node);
    } else if (overlap) {
      node = node + 1;
    } else {
      node = bvh_ldi(meta + 2 * node);
    }
  }
  return best_i;
}
