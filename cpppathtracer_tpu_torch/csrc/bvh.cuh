// Skip-pointer BVH walk for one ray: the closest hit's grouped object index.
//
// The walk reads its own layout (ops/cuda/bvh_kernel.py::bvh_leaf_layout)
// of the JAX-equal tables of ops/bvh.py (node_meta i32[M, 2] = escape,
// leaf_id; node_aabb f32[M, 8] = min.xyz, max.xyz, pad; leaf_objs
// f32[L*K, 8] = cx cy cz radius y_pos height prim_type gidx):
//   nodes  f32[M, 8]  min.xyz, escape | max.xyz, leaf id (ints as bits)
//   leaves i32[L, 4]  first word of rows, spheres, cylinders, platforms
//   rows   f32[W, 4]  16-byte words, within each leaf the spheres (cx cy cz
//                     radius), then the cylinders (cx cy cz radius | height
//                     0 0 0), then the platforms (y_pos 0 0 0); padding
//                     rows dropped
//   gidx   i32[W]     each row's grouped index at its first word
// so a node is two 16-byte loads, a sphere or platform one and a cylinder
// two, and the rows take under half the cache of leaf_objs.
//
// Replaces the walk of cpppathtracer_tpu/ops/pallas/bvh_kernel.py
// (_bvh_kernel, _leaf_candidates).  TPU lanes cannot diverge, so the Pallas
// kernel shared one preorder walk across a tile of rays and entered a node
// when any lane of the tile overlapped it.  Here each ray walks on its own,
// without a stack:
//
//   node = 0
//   while node < M:
//     slab-test node against this ray's best t
//     overlap and leaf: test its rows, node = escape
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
// Why the grouped layout gives the same bits.  A leaf's winner, (least t,
// lowest gidx), does not depend on the order of its rows.  Every row body
// selects INF where its test fails, so no t is NaN, and a row at INF never
// beats best_t <= tmax: dropped padding rows, and rows at INF (skipped
// without reading their gidx), change nothing.  That needs tmax <= INF, a
// precondition of the walk which every caller meets (the wavefront path
// passes INF).  On a ray with a larger tmax the two may differ: where it
// hits nothing, the plain version returns an index from the first leaf it
// enters, the walk 0.
//
// Every function is host-and-device: tests/bvh_host.cpp builds the walk
// for the CPU, where it is held bitwise against the plain PyTorch
// version (ops/cuda/bvh_kernel.py::bvh_winner_index_plain).  Build with
// --fmad=false (nvcc) or -ffp-contract=off (g++): nothing may contract
// a*b+c.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define POCA_HD __host__ __device__ __forceinline__
#else
#include <math.h>
#include <string.h>
#define POCA_HD inline
struct float4 { float x, y, z, w; };
struct int4 { int x, y, z, w; };
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

// 16-byte loads of the grouped layout: from shared memory (kShared) or
// through the read-only cache
template <bool kShared>
POCA_HD float4 bvh_ld4(const float4* p) {
#ifdef __CUDA_ARCH__
  if (!kShared) return __ldg(p);
#endif
  return *p;
}

template <bool kShared>
POCA_HD int4 bvh_ld4i(const int4* p) {
#ifdef __CUDA_ARCH__
  if (!kShared) return __ldg(p);
#endif
  return *p;
}

// an int stored as the bits of a float (escape and leaf id in nodes)
POCA_HD int bvh_bits(float v) {
#ifdef __CUDA_ARCH__
  return __float_as_int(v);
#else
  int i;
  memcpy(&i, &v, sizeof(i));
  return i;
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

POCA_HD bool bvh_slab(float4 mn, float4 mx, const BvhRay& r, float best_t) {
  float lo = -2.0f * POCA_INF, hi = 2.0f * POCA_INF;
  bvh_axis(mn.x, mx.x, r.ox, r.dx, r.inv_dx, lo, hi);
  bvh_axis(mn.y, mx.y, r.oy, r.dy, r.inv_dy, lo, hi);
  bvh_axis(mn.z, mx.z, r.oz, r.dz, r.inv_dz, lo, hi);
  return lo <= hi && lo <= best_t && hi >= r.tmin;
}

POCA_HD bool bvh_crosses(float oy, float dy, float y) {
  return (oy < y && dy > 0.0f) || (oy > y && dy < 0.0f);
}

// ------------------------------------------------------------ leaf rows
// The candidate t of one row against [tmin, tmax] (object.cu:10-112), or
// INF.  c = (cx, cy, cz, radius).  A test that fails returns INF at once:
// most rows miss, and a warp whose lanes all miss skips the square root
// and the rest (the plain version selects INF there, to the same bits).
POCA_HD float bvh_sphere_t(float4 c, const BvhRay& r, float tmax) {
  const float ex = r.ox - c.x, ey = r.oy - c.y, ez = r.oz - c.z;
  const float b = ex * r.dx + ey * r.dy + ez * r.dz;
  const float cq = ex * ex + ey * ey + ez * ez - c.w * c.w;
  const float disc = b * b - r.a * cq;
  if (!(disc > 0.0f)) return POCA_INF;
  const float sq = sqrtf(disc);
  const float t_n = (-b - sq) * r.inv_a;
  const float t_f = (-b + sq) * r.inv_a;
  const bool nv = t_n < tmax && t_n > r.tmin;
  const bool fv = t_f < tmax && t_f > r.tmin;
  return nv ? t_n : (fv ? t_f : POCA_INF);
}

POCA_HD float bvh_platform_t(float y0, const BvhRay& r, float tmax) {
  const float t = (y0 - r.oy) * r.inv_dy;
  const bool v = bvh_crosses(r.oy, r.dy, y0) && t < tmax && t > r.tmin;
  return v ? t : POCA_INF;
}

// A cylinder's cap at height y: t or INF.
POCA_HD float bvh_cap(const BvhRay& r, float y, float cx, float cz, float rr, float tmax) {
  if (!bvh_crosses(r.oy, r.dy, y)) return POCA_INF;
  const float t = (y - r.oy) * r.inv_dy;
  const float hx = r.ox + t * r.dx;
  const float hz = r.oz + t * r.dz;
  const float ex = hx - cx, ez = hz - cz;
  const float r2 = ex * ex + ez * ez;
  const bool v = t < tmax && t > r.tmin && rr > 0.0f && r2 < rr * rr;
  return v ? t : POCA_INF;
}

POCA_HD bool bvh_lateral_ok(const BvhRay& r, float t, float tmax, float y_bot, float y_top) {
  const float hy = r.oy + t * r.dy;
  return t < tmax && t > r.tmin && hy > y_bot && hy < y_top;
}

POCA_HD float bvh_cylinder_t(float4 c, float hh, const BvhRay& r, float tmax) {
  const float y_top = c.y + hh * 0.5f;
  const float y_bot = c.y - hh * 0.5f;
  const float t_cap = fminf(bvh_cap(r, y_top, c.x, c.z, c.w, tmax),
                            bvh_cap(r, y_bot, c.x, c.z, c.w, tmax));
  const float ex = r.ox - c.x, ez = r.oz - c.z;
  const float bc = ex * r.dx + ez * r.dz;
  const float cc = ex * ex + ez * ez - c.w * c.w;
  const float disc = bc * bc - r.ax * cc;
  if (!(disc > 0.0f)) return t_cap;  // fminf(t_cap, INF)
  const float sq = sqrtf(disc);
  const float t_n = (-bc - sq) * r.inv_ax;
  const float t_f = (-bc + sq) * r.inv_ax;
  const float t_lat = fminf(bvh_lateral_ok(r, t_n, tmax, y_bot, y_top) ? t_n : POCA_INF,
                            bvh_lateral_ok(r, t_f, tmax, y_bot, y_top) ? t_f : POCA_INF);
  return fminf(t_cap, t_lat);
}

// What a walk tested: slab tests, and leaf rows by primitive type
// (sphere, platform, cylinder; the layout has no padding rows).
struct BvhCounts {
  int nodes;
  int rows[3];
};

// ------------------------------------------------- the grouped layout
// One step of a ray's walk over the kernel's nodes: slab-test `node`, move
// `node` on (node + 1 into an overlapping internal node, else the escape,
// also after a leaf), and return the leaf id when the ray overlaps a leaf
// (its rows are tested next, against the same best_t), else -1.
template <bool kShared>
POCA_HD int bvh_step(const float4* nodes, int& node, const BvhRay& r, float best_t) {
  const float4 mn = bvh_ld4<kShared>(nodes + 2 * node);
  const float4 mx = bvh_ld4<kShared>(nodes + 2 * node + 1);
  const bool overlap = bvh_slab(mn, mx, r, best_t);
  const int leaf = bvh_bits(mx.w);
  node = overlap && leaf < 0 ? node + 1 : bvh_bits(mn.w);
  return overlap ? leaf : -1;
}

// A leaf's winner so far: the least t below INF and, among rows at that t,
// the lowest grouped index (read only for such rows).
struct BvhBest {
  float t;
  int i;
};

POCA_HD BvhBest bvh_best_none() {
  BvhBest b = {POCA_INF, 0};
  return b;
}

POCA_HD void bvh_take(BvhBest& w, float t, const int* g) {
  if (t < w.t) {
    w.t = t;
    w.i = bvh_ldi(g);
  } else if (t == w.t && t < POCA_INF) {
    const int gi = bvh_ldi(g);
    if (gi < w.i) w.i = gi;
  }
}

enum { BVH_SPHERES = 0, BVH_CYLINDERS = 1, BVH_PLATFORMS = 2 };

// The kernel's layout of the leaf rows: rows, and gidx beside them
struct BvhRows {
  const float4* rows;
  const int* gidx;
};

// Row j of one type of a leaf (lf = first word, spheres, cylinders,
// platforms) into w.
template <int kType>
POCA_HD void bvh_leaf_row(BvhRows lr, int4 lf, int j, const BvhRay& r, float best_t,
                          BvhBest& w) {
  if (kType == BVH_SPHERES) {
    const int q = lf.x + j;
    bvh_take(w, bvh_sphere_t(bvh_ld4<false>(lr.rows + q), r, best_t), lr.gidx + q);
  } else if (kType == BVH_CYLINDERS) {
    const int q = lf.x + lf.y + 2 * j;
    const float4 c = bvh_ld4<false>(lr.rows + q);
    bvh_take(w, bvh_cylinder_t(c, bvh_ldf(&lr.rows[q + 1].x), r, best_t), lr.gidx + q);
  } else {
    const int q = lf.x + lf.y + 2 * lf.z + j;
    bvh_take(w, bvh_platform_t(bvh_ldf(&lr.rows[q].x), r, best_t), lr.gidx + q);
  }
}

// The walk over the kernel's layout, one ray at a time (the kernel runs
// the same steps and rows with a warp's lanes in lock-step).
template <bool kCount>
POCA_HD int bvh_walk_grouped(const float4* nodes, const int4* leaves, BvhRows rows, int m,
                             const BvhRay& r, float tmax, BvhCounts* counts) {
  float best_t = tmax;
  int best_i = 0;
  int node = 0;
  while (node < m) {
    const int leaf = bvh_step<false>(nodes, node, r, best_t);
    if (kCount) ++counts->nodes;
    if (leaf < 0) continue;
    const int4 lf = bvh_ld4i<false>(leaves + leaf);
    BvhBest w = bvh_best_none();
    for (int j = 0; j < lf.y; ++j) bvh_leaf_row<BVH_SPHERES>(rows, lf, j, r, best_t, w);
    for (int j = 0; j < lf.z; ++j) bvh_leaf_row<BVH_CYLINDERS>(rows, lf, j, r, best_t, w);
    for (int j = 0; j < lf.w; ++j) bvh_leaf_row<BVH_PLATFORMS>(rows, lf, j, r, best_t, w);
    if (kCount) {
      counts->rows[0] += lf.y;
      counts->rows[1] += lf.w;
      counts->rows[2] += lf.z;
    }
    if (w.t < best_t) {
      best_t = w.t;
      best_i = w.i;
    }
  }
  return best_i;
}
