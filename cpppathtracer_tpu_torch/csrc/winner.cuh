// Closest-hit winner search over the type-grouped scene, one ray per
// lane, a warp at a time: inlined by the megakernel (mega_trace.cu) and
// launched alone by winner.cu for the per-bounce wavefront path.
//
// Replaces the winner search of cpppathtracer_tpu/ops/pallas/
// intersect_kernel.py (_winner_kernel, and _mxu_best_index, its MXU form,
// which the TPU megakernel inlines).  The TPU evaluated every (object, ray)
// pair as an [objects, rays] block and reduced it with argmin; on the GPU
// each lane walks the objects in grouped order and keeps the closest hit.
// The quadratics use _winner_kernel's formulas (b = o.d - c.d,
// c = |o|^2 - 2 o.c + (|c|^2 - r^2)), not the MXU features, whose matmul
// exists only to feed the TPU's matrix unit.
//
// Tie-break: a candidate replaces the best only when strictly closer, so
// the lowest dense grouped index wins a tie, as argmin-within-group plus
// strictly-closer-across-groups does on the TPU.
//
// What bounds it on an H100: FP32 operations, about 33 per (sphere, ray)
// and 87 per (cylinder, ray) pair and 10 per platform, each its own instruction
// (the kernels are built with --fmad=false).  What the design does about
// it:
// - the rows sit in shared memory, where every lane of a warp reads the
//   same row (a broadcast), two 16-byte loads a row;
// - the warp skips work that every one of its lanes would throw away: a
//   sphere's root, t_near / t_far and validity tests when no lane has a
//   positive discriminant; a cylinder's lateral part likewise; a platform,
//   or one cap of a cylinder, when no lane's ray crosses its plane.  Such
//   a lane's candidate is INF either way, which never replaces the best,
//   so the result is the full computation's bit for bit.  Every
//   arithmetic operation that does run is the plain version's, in its
//   order.
// The warp must call it converged (all 32 lanes); a lane without a ray
// passes on = false and runs masked: its result means nothing.
#pragma once

#define POCA_INF 1e30f

__device__ __forceinline__ int poca_ceil8(int n) { return (n + 7) / 8 * 8; }

// Whether any lane of the converged warp has `pred`: the warp runs a
// block of per-object work only then.
__device__ __forceinline__ bool poca_warp_any(bool pred) {
  return __any_sync(0xffffffffu, pred);
}

// One geometry row: (cx cy cz radius) (y_pos height |c|^2-r^2 cx^2+cz^2-r^2)
struct PocaRow {
  float4 a, b;
};

__device__ __forceinline__ PocaRow poca_row(const float4* rows, int j) {
  return {rows[2 * j], rows[2 * j + 1]};
}

// rows: f32[n_rep, 8] as float4 pairs in shared memory, 16-byte aligned,
// groups at 8-row aligned offsets [S | P | C]
// (ops/cuda/intersect_kernel.py::build_geom_rows).  Returns the winner's
// dense grouped index (0 when nothing is hit) and its t in best_t_out
// (POCA_INF when nothing is hit).
__device__ __forceinline__ int poca_winner_search(
    const float4* __restrict__ rows, int n_s, int n_p, int n_c, bool on,
    float ox, float oy, float oz, float dx, float dy, float dz,
    float tmin, float tmax, float& best_t_out) {
  float best_t = POCA_INF;
  int best_i = 0;
  const int ns8 = poca_ceil8(n_s), np8 = poca_ceil8(n_p);

  if (n_s) {
    const float od = ox * dx + oy * dy + oz * dz;
    const float oo = ox * ox + oy * oy + oz * oz;
    const float a = dx * dx + dy * dy + dz * dz;
    const float inv_a = 1.0f / (a == 0.0f ? 1.0f : a);
    for (int j = 0; j < n_s; ++j) {
      const PocaRow g = poca_row(rows, j);
      const float cx = g.a.x, cy = g.a.y, cz = g.a.z, cc = g.b.z;
      const float oc = cx * ox + cy * oy + cz * oz;
      const float dc = cx * dx + cy * dy + cz * dz;
      const float b = od - dc;
      const float c = oo - 2.0f * oc + cc;
      const float disc = b * b - a * c;
      const bool has = disc > 0.0f;
      if (poca_warp_any(on && has)) {
        const float sq = sqrtf(has ? disc : 1.0f);
        const float t_near = (-b - sq) * inv_a;
        const float t_far = (-b + sq) * inv_a;
        const bool nv = has && (t_near < tmax) && (t_near > tmin);
        const bool fv = has && (t_far < tmax) && (t_far > tmin);
        const float t = nv ? t_near : (fv ? t_far : POCA_INF);
        if (t < best_t) { best_t = t; best_i = j; }
      }
    }
  }

  const float dy_safe = dy == 0.0f ? 1.0f : dy;
  for (int j = 0; j < n_p; ++j) {
    const float y0 = poca_row(rows, ns8 + j).b.x;
    const bool crossing = ((oy < y0) && (dy > 0.0f)) || ((oy > y0) && (dy < 0.0f));
    if (poca_warp_any(on && crossing)) {
      const float t = (y0 - oy) / dy_safe;
      const bool v = crossing && (t < tmax) && (t > tmin);
      const float tt = v ? t : POCA_INF;
      if (tt < best_t) { best_t = tt; best_i = n_s + j; }
    }
  }

  if (n_c) {
    const float od2 = ox * dx + oz * dz;
    const float oo2 = ox * ox + oz * oz;
    const float ax = dx * dx + dz * dz;
    const float inv_ax = 1.0f / (ax == 0.0f ? 1.0f : ax);
    for (int j = 0; j < n_c; ++j) {
      const PocaRow g = poca_row(rows, ns8 + np8 + j);
      const float cx = g.a.x, cy = g.a.y, cz = g.a.z;
      const float radius = g.a.w, height = g.b.y, cc2 = g.b.w;
      const float y_top = cy + height * 0.5f;
      const float y_bot = cy - height * 0.5f;

      float t_cap = POCA_INF;
      const float planes[2] = {y_top, y_bot};
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float yp = planes[k];
        const bool crossing = ((oy < yp) && (dy > 0.0f)) || ((oy > yp) && (dy < 0.0f));
        if (poca_warp_any(on && crossing)) {
          const float t = (yp - oy) / dy_safe;
          const float hx = ox + t * dx;
          const float hz = oz + t * dz;
          const float ex = hx - cx, ez = hz - cz;
          const float r2 = ex * ex + ez * ez;
          const bool v = crossing && (t < tmax) && (t > tmin) && (radius > 0.0f) &&
                         (r2 < radius * radius);
          t_cap = fminf(t_cap, v ? t : POCA_INF);
        }
      }

      const float oc2 = cx * ox + cz * oz;
      const float dc2 = cx * dx + cz * dz;
      const float b2 = od2 - dc2;
      const float cq = oo2 - 2.0f * oc2 + cc2;
      const float disc2 = b2 * b2 - ax * cq;
      const bool has2 = disc2 > 0.0f;
      float t_lat = POCA_INF;
      if (poca_warp_any(on && has2)) {
        const float sq2 = sqrtf(has2 ? disc2 : 1.0f);
        const float t_ln = (-b2 - sq2) * inv_ax;
        const float t_lf = (-b2 + sq2) * inv_ax;
        const float hy_n = oy + t_ln * dy;
        const float hy_f = oy + t_lf * dy;
        const bool ok_n = has2 && (t_ln < tmax) && (t_ln > tmin) && (hy_n > y_bot) && (hy_n < y_top);
        const bool ok_f = has2 && (t_lf < tmax) && (t_lf > tmin) && (hy_f > y_bot) && (hy_f < y_top);
        t_lat = fminf(ok_n ? t_ln : POCA_INF, ok_f ? t_lf : POCA_INF);
      }
      const float t = fminf(t_cap, t_lat);
      if (t < best_t) { best_t = t; best_i = n_s + n_p + j; }
    }
  }
  best_t_out = best_t;
  return best_i;
}
