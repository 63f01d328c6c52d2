// The per-ray body of the megakernel's backward (mega_bwd.cu): a forward
// sweep that rebuilds each bounce's entry carry from the saved winners, and
// a reverse sweep of hand-derived adjoints.
//
// Replaces the body of cpppathtracer_tpu/ops/pallas/mega_bwd_kernel.py
// (_mega_bwd_kernel, which differentiated _replay_bounce with jax.vjp at
// trace time).  The function is torch autograd of the replay
// (ops/mega.py::_replay_outputs, ops/cuda/mega_bwd_kernel.py::
// mega_bwd_plain), and the adjoints follow its rules op for op:
// - a select (torch.where, a ?: here) sends the cotangent to the branch it
//   took and nothing to the other;
// - a clamp (mathx.clamp, fmaxf here) passes the gradient only where it
//   does not clamp;
// - minimum splits the cotangent in half on a tie, as torch.minimum does;
// - comparisons, casts, sign() and the random numbers carry none;
// - the score-function weight w = p / detach(p) is 1.0 in value, and
//   its cotangent is that of the attenuation, times 1 / p (the branch
//   taken) or -1 / (1-p) (the branch skipped).
// The saved sign decides whether a bounce hit (`enc >= 0`); a bounce that
// missed passes every cotangent through unchanged (plus -ct_first_n into
// ct_d at bounce 0), so a lane dead before bounce b contributes exactly 0
// there.
#pragma once

#include "bounce.cuh"

#define POCA_MAX_DEPTH 32
#define POCA_LOG_1000 6.907755279f  // float32 log(1000): pow's exponent slope

struct BwdParams {
  const float *ox, *oy, *oz, *dx, *dy, *dz;  // primary rays
  const int *pix, *samp;
  const float *ts, *trt;  // [13, n_pad], [4, n_pad] in device memory
  const int* hits;        // [depth, R]: winner on a hit, -1 on a miss
  // cotangents of rad3, miss_dir3, miss_thru3, first_n3, first_t
  const float* ct[13];
  float* out_tab;  // [17, n_pad], zeroed: ct_ts rows 0-12, ct_trt rows 13-16
  float* out_od;   // [6, R]: ct_o3, ct_d3
  float* carry;    // [10, R] or null: final o3 d3 thru3 missed
  int R, n_pad, depth;
  uint32_t seed;
};

// Cotangents of one bounce's winner record
struct RecGrad {
  V3 center, kd;
  float radius, y_pos, height, smoothness, reflectivity, ior, emission;
};

POCA_HD RecGrad rec_zero() {
  RecGrad g;
  g.center = zero3(); g.kd = zero3();
  g.radius = g.y_pos = g.height = g.smoothness = g.reflectivity = g.ior = g.emission = 0.0f;
  return g;
}

// Accumulates table cotangents: atomics on the card (into shared or
// device memory), plain adds in the host build.
struct TableAcc {
  float* a;
  int np;
  POCA_HD void add(int field, int idx, float v) {
    if (v == 0.0f) return;
#ifdef __CUDA_ARCH__
    atomicAdd(a + field * np + idx, v);
#else
    a[field * np + idx] += v;
#endif
  }
  POCA_HD void add_rec(int idx, const RecGrad& g) {
    add(0, idx, g.center.x); add(1, idx, g.center.y); add(2, idx, g.center.z);
    add(3, idx, g.radius); add(4, idx, g.y_pos); add(5, idx, g.height);
    add(8, idx, g.smoothness); add(9, idx, g.reflectivity); add(10, idx, g.ior);
    add(POCA_F_S + 0, idx, g.kd.x); add(POCA_F_S + 1, idx, g.kd.y);
    add(POCA_F_S + 2, idx, g.kd.z); add(POCA_F_S + 3, idx, g.emission);
  }
};

// ------------------------------------------------------------ adjoints
// normalize(v) = v * inv, inv = n2 > 0 ? 1 / sqrt(max(n2, EPS)) : 0
POCA_HD V3 normalize_bwd(V3 v, V3 ct) {
  const float n2 = dot(v, v);
  if (!(n2 > 0.0f)) return zero3();
  const float s = sqrtf(fmaxf(n2, POCA_EPS));
  const float inv = 1.0f / s;
  V3 r = scale(ct, inv);
  if (n2 > POCA_EPS) {
    const float ct_n2 = -dot(ct, v) * inv * inv / (2.0f * s);
    r = add(r, scale(v, 2.0f * ct_n2));
  }
  return r;
}

// torch.minimum's backward: all to the smaller, half each on a tie
POCA_HD void min_bwd(float a, float b, float ct, float& ca, float& cb) {
  if (a < b) { ca = ct; cb = 0.0f; }
  else if (a > b) { ca = 0.0f; cb = ct; }
  else { ca = 0.5f * ct; cb = 0.5f * ct; }
}

// (t, n) of hit_attrs -> o, d and the record's geometry
POCA_HD void hit_attrs_bwd(const HitFwd& h, float radius, V3 o, V3 d, float ct_t, V3 ct_n,
                           V3& ct_o, V3& ct_d, RecGrad& g) {
  if (h.prim == 0) {  // sphere
    V3 ct_pc;
    if (h.v_sn) {  // n = pc / r
      const float inv_r = 1.0f / h.r_safe;
      ct_pc = scale(ct_n, inv_r);
      if (radius != 0.0f) g.radius -= dot(ct_n, h.pc) * inv_r * inv_r;
    } else {
      ct_pc = normalize_bwd(h.pc, ct_n);
    }
    // pc = o + t_s d - c
    ct_o = add(ct_o, ct_pc);
    g.center = sub(g.center, ct_pc);
    ct_d = add(ct_d, scale(ct_pc, h.t_s));
    const float ct_tt = ct_t + (h.t < POCA_INF ? dot(ct_pc, d) : 0.0f);
    const float c_sn = h.v_sn ? ct_tt : 0.0f;
    const float c_sf = (!h.v_sn && h.v_sf) ? ct_tt : 0.0f;
    // t = (-b -+ sq) / a
    float ct_b = -(c_sn + c_sf) / h.a_safe;
    const float ct_sq = (c_sf - c_sn) / h.a_safe;
    float ct_a = h.a != 0.0f ? -(c_sn * h.t_sn + c_sf * h.t_sf) / h.a_safe : 0.0f;
    const float ct_disc = h.has ? ct_sq / (2.0f * h.sq) : 0.0f;
    // disc = b^2 - a cq
    ct_b += 2.0f * h.b * ct_disc;
    ct_a -= h.cq * ct_disc;
    const float ct_cq = -h.a * ct_disc;
    // cq = |ac|^2 - r^2, b = ac . d, a = |d|^2, ac = o - c
    const V3 ct_ac = add(scale(h.ac, 2.0f * ct_cq), scale(d, ct_b));
    g.radius -= 2.0f * radius * ct_cq;
    ct_d = add(ct_d, add(scale(h.ac, ct_b), scale(d, 2.0f * ct_a)));
    ct_o = add(ct_o, ct_ac);
    g.center = sub(g.center, ct_ac);
  } else if (h.prim == 1) {  // platform: t = (y_pos - o.y) / dy; n has no gradient
    if (h.v_pl) {
      const float q = ct_t / h.dy_safe;
      g.y_pos += q;
      ct_o.y -= q;
      if (d.y != 0.0f) ct_d.y -= q * h.t_pl;
    }
  } else if (h.prim == 2) {  // cylinder
    V3 ct_r = h.is_cap ? zero3() : normalize_bwd(h.radial, ct_n);
    // radial = (o.x + t_c d.x - c.x, 0, o.z + t_c d.z - c.z)
    ct_o.x += ct_r.x; ct_o.z += ct_r.z;
    g.center.x -= ct_r.x; g.center.z -= ct_r.z;
    ct_d.x += ct_r.x * h.t_c; ct_d.z += ct_r.z * h.t_c;
    const float ct_tc = ct_t + (h.t < POCA_INF ? ct_r.x * d.x + ct_r.z * d.z : 0.0f);
    float ct_cap, ct_lat, c_top, c_bot, c_n, c_f;
    min_bwd(h.t_cap, h.t_lat, ct_tc, ct_cap, ct_lat);
    min_bwd(h.v_capk[0] ? h.t_capk[0] : POCA_INF, h.v_capk[1] ? h.t_capk[1] : POCA_INF,
            ct_cap, c_top, c_bot);
    const float c_k[2] = {h.v_capk[0] ? c_top : 0.0f, h.v_capk[1] ? c_bot : 0.0f};
#pragma unroll
    for (int k = 0; k < 2; ++k) {  // t = (c.y +- height/2 - o.y) / dy
      const float q = c_k[k] / h.dy_safe;
      g.center.y += q;
      g.height += k == 0 ? 0.5f * q : -0.5f * q;
      ct_o.y -= q;
      if (d.y != 0.0f) ct_d.y -= q * h.t_capk[k];
    }
    min_bwd(h.ok_n ? h.t_ln : POCA_INF, h.ok_f ? h.t_lf : POCA_INF, ct_lat, c_n, c_f);
    if (!h.ok_n) c_n = 0.0f;
    if (!h.ok_f) c_f = 0.0f;
    // t = (-bc -+ sq_c) / axc
    float ct_bc = -(c_n + c_f) / h.ax_safe;
    const float ct_sq = (c_f - c_n) / h.ax_safe;
    float ct_ax = h.axc != 0.0f ? -(c_n * h.t_ln + c_f * h.t_lf) / h.ax_safe : 0.0f;
    const float ct_disc = h.has_c ? ct_sq / (2.0f * h.sq_c) : 0.0f;
    // disc_c = bc^2 - axc cc
    ct_bc += 2.0f * h.bc * ct_disc;
    ct_ax -= h.cc * ct_disc;
    const float ct_cc = -h.axc * ct_disc;
    // cc = rx^2 + rz^2 - r^2, bc = rx d.x + rz d.z, axc = d.x^2 + d.z^2
    const float ct_rx = 2.0f * h.rx * ct_cc + ct_bc * d.x;
    const float ct_rz = 2.0f * h.rz * ct_cc + ct_bc * d.z;
    g.radius -= 2.0f * radius * ct_cc;
    ct_d.x += ct_bc * h.rx + 2.0f * d.x * ct_ax;
    ct_d.z += ct_bc * h.rz + 2.0f * d.z * ct_ax;
    ct_o.x += ct_rx; ct_o.z += ct_rz;
    g.center.x -= ct_rx; g.center.z -= ct_rz;
  }
}

POCA_HD void schlick_bwd(float cosine, float ref_idx, float ct, float& ct_cos, float& ct_ior) {
  const float den = 1.0f + ref_idx;
  const float r0a = (1.0f - ref_idx) / den;
  const float r0 = r0a * r0a;
  const float m_raw = 1.0f - cosine;
  const float m = fmaxf(m_raw, 0.0f);
  const float m4 = m * m * m * m;
  if (m_raw > 0.0f) ct_cos -= ct * (1.0f - r0) * 5.0f * m4;
  const float ct_r0a = 2.0f * r0a * (ct * (1.0f - m4 * m));
  ct_ior += -ct_r0a / den - ct_r0a * r0a / den;
}

POCA_HD void to_world_bwd(float ax, float ay, float az, V3 n, V3 ct, float& ct_ax,
                          float& ct_ay, float& ct_az, V3& ct_n) {
  const bool use_x = fabsf(n.x) > fabsf(n.y);
  const float mx = n.x * n.x + n.z * n.z, my = n.y * n.y + n.z * n.z;
  const float sx = sqrtf(fmaxf(mx, POCA_EPS)), sy = sqrtf(fmaxf(my, POCA_EPS));
  const float ilx = 1.0f / sx, ily = 1.0f / sy;
  const V3 c = v3(use_x ? n.z * ilx : 0.0f, use_x ? 0.0f : n.z * ily,
                  use_x ? -n.x * ilx : -n.y * ily);
  const V3 b = cross(c, n);
  // out = ax b + ay c + az n, b = c x n
  ct_ax = dot(ct, b); ct_ay = dot(ct, c); ct_az = dot(ct, n);
  const V3 ct_b = scale(ct, ax);
  const V3 ct_c = add(scale(ct, ay), cross(n, ct_b));
  ct_n = add(scale(ct, az), cross(ct_b, c));
  if (use_x) {  // c = (n.z, 0, -n.x) / sqrt(n.x^2 + n.z^2)
    ct_n.z += ct_c.x * ilx;
    ct_n.x -= ct_c.z * ilx;
    if (mx > POCA_EPS) {
      const float ct_m = -(ct_c.x * n.z - ct_c.z * n.x) * ilx * ilx / (2.0f * sx);
      ct_n.x += 2.0f * n.x * ct_m;
      ct_n.z += 2.0f * n.z * ct_m;
    }
  } else {  // c = (0, n.z, -n.y) / sqrt(n.y^2 + n.z^2)
    ct_n.z += ct_c.y * ily;
    ct_n.y -= ct_c.z * ily;
    if (my > POCA_EPS) {
      const float ct_m = -(ct_c.y * n.z - ct_c.z * n.y) * ily * ily / (2.0f * sy);
      ct_n.y += 2.0f * n.y * ct_m;
      ct_n.z += 2.0f * n.z * ct_m;
    }
  }
}

// d w / d p of the score-function weight's branch (bsdf._branch)
POCA_HD float score_bwd(bool took, float p, float ct) {
  const float q = 1.0f - p;
  return took ? ct / (p > 0.0f ? p : 1.0f) : -(ct / (q > 0.0f ? q : 1.0f));
}

// shade's outputs (bounce, atten = atten_on ? kd * w : 0, emitted) ->
// normal, in_dir and the record's material fields
POCA_HD void shade_bwd(const BounceFwd& f, V3 in_dir, V3 ct_bounce, V3 ct_atten,
                       V3 ct_emitted, V3& ct_normal, V3& ct_in, RecGrad& g) {
  const ShadeFwd& s = f.s;
  const V3 normal = f.normal, kd = f.kd;
  const float ior = f.ior;
  ct_normal = zero3();
  ct_in = zero3();
  // emitted = kd * emission
  g.kd = add(g.kd, scale(ct_emitted, f.emission));
  g.emission += dot(ct_emitted, kd);
  // atten = (atten_on ? kd : 0) * w_mirror * w_glass, each w 1.0 in value
  float ct_w = 0.0f;
  if (s.atten_on) {
    g.kd = add(g.kd, ct_atten);
    ct_w = dot(ct_atten, kd);
  }
  float ct_rp = 0.0f;
  if (s.is_mirror) g.reflectivity += score_bwd(s.mirror_reflects, f.reflectivity, ct_w);
  if (s.is_glass) ct_rp = score_bwd(s.glass_reflects, s.reflect_prob, ct_w);
  // reflect_prob = refract_ok ? schlick(cosine, ior) : 1
  float ct_cos = 0.0f;
  if (s.refract_ok) schlick_bwd(s.cosine, ior, ct_rp, ct_cos, g.ior);

  // bounce = to_world(r cos phi, r sin phi, lz, base)
  float ct_lx, ct_ly, ct_lz;
  V3 ct_base;
  to_world_bwd(s.r * s.cphi, s.r * s.sphi, s.lz, s.base, ct_bounce, ct_lx, ct_ly, ct_lz,
               ct_base);
  if (s.phong) {  // alpha = 1000^smoothness; lz = exp(log_u / alpha), r^2 = -expm1(y)
    float ct_y = 0.0f;
    if (s.r_arg > 0.0f) {
      const float ct_arg = (ct_lx * s.cphi + ct_ly * s.sphi) / (2.0f * s.r);
      const float th = tanhf(0.5f * s.y), ey = expf(s.y);
      ct_y = ct_arg * (-(0.5f * (1.0f - th * th)) * (ey + 1.0f) - th * ey);
    }
    const float ct_inv_a = ct_y * (2.0f * s.log_u) + ct_lz * s.lz * s.log_u;
    const float ct_alpha = -ct_inv_a * s.inv_a * s.inv_a;
    g.smoothness += ct_alpha * (s.alpha_phong * POCA_LOG_1000);
  }
  V3 ct_refl = zero3(), ct_refr = zero3();
  if (s.base_src == POCA_BASE_NORMAL) ct_normal = ct_base;
  else if (s.base_src == POCA_BASE_REFLECT) ct_refl = ct_base;
  else ct_refr = ct_base;

  // reflect_dir = in - s2 n, s2 = 2 (in . n)
  ct_in = add(ct_in, ct_refl);
  ct_normal = sub(ct_normal, scale(ct_refl, s.s2));
  const float ct_dot2 = -2.0f * dot(ct_refl, normal);
  ct_in = add(ct_in, scale(normal, ct_dot2));
  ct_normal = add(ct_normal, scale(in_dir, ct_dot2));

  // refracted = refract_ok ? normalize(raw) : 0,
  // raw = ni (uv - on dt) - on sq, sq = sqrt(1 - ni^2 (1 - dt^2))
  const V3 on = s.on, uv = s.uv;
  const float ni = s.ni, dt = s.dt;
  float ct_ni = 0.0f, ct_dt = 0.0f;
  V3 ct_uv = zero3(), ct_on = zero3();
  if (s.refract_ok) {
    const V3 cr = normalize_bwd(s.refr_raw, ct_refr);
    ct_ni += cr.x * (uv.x - on.x * dt) + cr.y * (uv.y - on.y * dt) + cr.z * (uv.z - on.z * dt);
    ct_uv = scale(cr, ni);
    ct_on = scale(cr, -(ni * dt) - s.sq);
    ct_dt -= ni * dot(cr, on);
    const float ct_disc = -dot(cr, on) / (2.0f * s.sq);
    ct_ni -= ct_disc * (1.0f - dt * dt) * 2.0f * ni;
    ct_dt += ct_disc * ni * ni * 2.0f * dt;
  }
  // dt = uv . on, uv = normalize(in), on = inside ? -n : n
  ct_uv = add(ct_uv, scale(on, ct_dt));
  ct_on = add(ct_on, scale(uv, ct_dt));
  ct_in = add(ct_in, normalize_bwd(in_dir, ct_uv));
  ct_normal = s.inside ? sub(ct_normal, ct_on) : add(ct_normal, ct_on);
  // ni = inside ? ior : 1 / ior
  if (s.inside) g.ior += ct_ni;
  else if (ior != 0.0f) g.ior -= ct_ni * ni * ni;

  // cosine = inside ? sqrt(1 - ior^2 (1 - dn^2)) : -dn, dn = in . n
  const float dn = dot(in_dir, normal);
  float ct_dn = 0.0f;
  if (s.inside) {
    if (s.cos_arg > 0.0f) {
      const float ct_ca = ct_cos / (2.0f * s.cos_in);
      g.ior -= ct_ca * (1.0f - dn * dn) * 2.0f * ior;
      ct_dn += ct_ca * ior * ior * 2.0f * dn;
    }
  } else {
    ct_dn -= ct_cos;
  }
  ct_in = add(ct_in, scale(normal, ct_dn));
  ct_normal = add(ct_normal, scale(in_dir, ct_dn));
}

// The adjoint of one bounce that hit (enc >= 0), from the entry carry
// (o, d, thru, alive) and its recomputed forward f.  In: the cotangents of
// the carry after the bounce; out: those of the entry carry, and the
// record's cotangents in g.
POCA_HD void bounce_bwd(const BounceFwd& f, V3 o, V3 d, V3 thru, bool alive, bool first,
                        V3 ct_rad, V3 ct_fn, float ct_ft, V3& ct_o, V3& ct_d, V3& ct_thru,
                        RecGrad& g) {
  // o' = pos, d' = normalize(bounce)
  const V3 ct_pos = ct_o;
  const V3 ct_bounce = normalize_bwd(f.s.bounce, ct_d);
  // thru' = alive ? thru * atten : thru; rad' = rad + thru * emitted * alive
  V3 ct_atten = zero3(), ct_emitted = zero3();
  if (alive) {
    ct_atten = mul(ct_thru, thru);
    ct_emitted = mul(ct_rad, thru);
    ct_thru = add(mul(ct_thru, f.s.atten), mul(ct_rad, f.s.emitted));
  }
  V3 ct_normal, ct_in;
  shade_bwd(f, d, ct_bounce, ct_atten, ct_emitted, ct_normal, ct_in, g);
  float ct_trec = 0.0f;
  if (first) {  // first_n = normal, first_t = t
    ct_normal = add(ct_normal, ct_fn);
    ct_trec = ct_ft;
  }
  // pos = o + d t_safe; normal and t are zero / INF where the recompute missed
  ct_o = ct_pos;
  ct_d = add(ct_in, scale(ct_pos, f.t_safe));
  if (f.hit)
    hit_attrs_bwd(f.h, f.radius, o, d, dot(ct_pos, d) + ct_trec, ct_normal, ct_o, ct_d, g);
}

// ------------------------------------------------------------- one ray
POCA_HD void mega_bwd_ray(const BwdParams& p, int i, const float* ts, const float* trt,
                          TableAcc acc) {
  const int R = p.R, np = p.n_pad, depth = p.depth;
  const uint32_t pix = (uint32_t)p.pix[i], samp = (uint32_t)p.samp[i];
  // entry carries of every bounce (local memory)
  V3 co[POCA_MAX_DEPTH], cd[POCA_MAX_DEPTH], cth[POCA_MAX_DEPTH];
  bool cal[POCA_MAX_DEPTH];

  // forward sweep: mega_trace's carry updates, winners from the planes
  V3 o = v3(p.ox[i], p.oy[i], p.oz[i]);
  V3 d = v3(p.dx[i], p.dy[i], p.dz[i]);
  V3 thru = v3(1.0f, 1.0f, 1.0f);
  bool alive = true;
  for (int b = 0; b < depth; ++b) {
    co[b] = o; cd[b] = d; cth[b] = thru; cal[b] = alive;
    const int enc = p.hits[b * R + i];
    if (enc >= 0) {
      float u1, u2, u3;
      uniforms3(pix, samp, (uint32_t)(1 + b), p.seed, u1, u2, u3);
      BounceFwd f;
      bounce_body(ts, trt, np, enc, o, d, b == 0 ? 0.0f : POCA_TMIN_BOUNCE, u1, u2, u3, f);
      if (alive) thru = mul(thru, f.s.atten);
      o = f.pos;
      d = normalize(f.s.bounce);
    } else {
      alive = false;
    }
  }
  if (p.carry) {
    float* c = p.carry;
    c[0 * R + i] = o.x; c[1 * R + i] = o.y; c[2 * R + i] = o.z;
    c[3 * R + i] = d.x; c[4 * R + i] = d.y; c[5 * R + i] = d.z;
    c[6 * R + i] = thru.x; c[7 * R + i] = thru.y; c[8 * R + i] = thru.z;
    c[9 * R + i] = alive ? 0.0f : 1.0f;
  }

  // reverse sweep
  const V3 ct_rad = v3(p.ct[0][i], p.ct[1][i], p.ct[2][i]);
  const V3 ct_fn = v3(p.ct[9][i], p.ct[10][i], p.ct[11][i]);
  const float ct_ft = p.ct[12][i];
  V3 ct_o = zero3();
  V3 ct_d = v3(p.ct[3][i], p.ct[4][i], p.ct[5][i]);
  V3 ct_thru = v3(p.ct[6][i], p.ct[7][i], p.ct[8][i]);
  for (int b = depth - 1; b >= 0; --b) {
    const int enc = p.hits[b * R + i];
    if (enc < 0) {  // a miss keeps the carry; first_n = -d at bounce 0
      if (b == 0) ct_d = sub(ct_d, ct_fn);
      continue;
    }
    float u1, u2, u3;
    uniforms3(pix, samp, (uint32_t)(1 + b), p.seed, u1, u2, u3);
    BounceFwd f;
    bounce_body(ts, trt, np, enc, co[b], cd[b], b == 0 ? 0.0f : POCA_TMIN_BOUNCE, u1, u2, u3, f);
    RecGrad g = rec_zero();
    bounce_bwd(f, co[b], cd[b], cth[b], cal[b], b == 0, ct_rad, ct_fn, ct_ft, ct_o, ct_d,
               ct_thru, g);
    acc.add_rec(enc, g);
  }
  float* od = p.out_od;
  od[0 * R + i] = ct_o.x; od[1 * R + i] = ct_o.y; od[2 * R + i] = ct_o.z;
  od[3 * R + i] = ct_d.x; od[4 * R + i] = ct_d.y; od[5 * R + i] = ct_d.z;
}
