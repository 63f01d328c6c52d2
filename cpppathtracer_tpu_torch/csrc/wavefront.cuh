// One bounce of the wavefront path's body for one lane: the work around the
// walk in each bounce of integrator.trace_bounces (its plain version is
// ops/cuda/wavefront_kernel.py::bounce_p, one bounce of the PyTorch body).
//
// Given the lane's winner (the walk's or the dense search's grouped index),
// it runs bounce.cuh's uniforms3 and bounce_body, the per-lane arithmetic
// the megakernel (mega_trace.cu) shares with its plain version, then the
// carry updates of trace_bounces:
//   rad  += thru * emitted * (hit && alive);
//   thru  = hit && alive ? thru * attenuation : thru;
//   first_n, first_t at bounce 0 (the hit's normal and t, or -d and INF);
//   alive = alive && hit;
//   o, d  = hit ? (pos, normalize(bounce dir)) : (o, d),
// on every lane, dead ones included: a dead lane still takes its recomputed
// hit's o and d, as the PyTorch body does.  There is no early exit (the
// megakernel's is not valid here: a primary ray whose best t lies in
// (0, BOUNCE_RAY_TMIN] can hit at bounce 1, which changes its miss
// direction).
//
// The carry lives in device memory between bounces and is updated in place;
// a plane is stored only where its value changes (rad where a bit changes,
// so a product that is not finite still propagates as in the PyTorch body).
//
// Host-and-device: tests/wavefront_host.cpp compiles it for the CPU to hold
// it bitwise against the PyTorch body without a card.
#pragma once

#include <stdint.h>
#include <string.h>

#include "bounce.cuh"

POCA_HD bool poca_same_bits(V3 a, V3 b) {
  uint32_t x[3], y[3];
  memcpy(x, &a, sizeof x);
  memcpy(y, &b, sizeof y);
  return x[0] == y[0] && x[1] == y[1] && x[2] == y[2];
}

// Lane i of R at bounce `bounce`: carry [12, R] (o3 d3 thru3 rad3) and
// alive [R] read and updated; first [4, R] (first_n3 first_t) written at
// bounce 0; gidx, pix, samp [R]; ts [13, n_tab], trt [4, n_tab] the
// field-major record tables; seed the PCG4D key's fourth word.
POCA_HD void wavefront_lane(int i, int R, int n_tab, int bounce, uint32_t seed, float* carry,
                            bool* alive, float* first, const int* gidx, const int* pix,
                            const int* samp, const float* ts, const float* trt) {
  const size_t n = (size_t)R;
  float* c = carry + i;
  const V3 o = v3(c[0], c[n], c[2 * n]);
  const V3 d = v3(c[3 * n], c[4 * n], c[5 * n]);
  const float tmin = bounce == 0 ? 0.0f : POCA_TMIN_BOUNCE;
  float u1, u2, u3;
  uniforms3((uint32_t)pix[i], (uint32_t)samp[i], (uint32_t)(1 + bounce), seed, u1, u2, u3);
  BounceFwd f;
  bounce_body(ts, trt, n_tab, gidx[i], o, d, tmin, u1, u2, u3, f);
  const bool hit = f.hit;
  const bool was_alive = alive[i];
  const bool live_hit = hit && was_alive;

  const V3 thru = v3(c[6 * n], c[7 * n], c[8 * n]);
  const V3 rad = v3(c[9 * n], c[10 * n], c[11 * n]);
  const V3 rad2 = add(rad, scale(mul(thru, f.s.emitted), live_hit ? 1.0f : 0.0f));
  if (!poca_same_bits(rad2, rad)) {
    c[9 * n] = rad2.x;
    c[10 * n] = rad2.y;
    c[11 * n] = rad2.z;
  }
  if (live_hit) {
    const V3 t2 = mul(thru, f.s.atten);
    c[6 * n] = t2.x;
    c[7 * n] = t2.y;
    c[8 * n] = t2.z;
  }
  if (bounce == 0) {
    const V3 fn = hit ? f.normal : scale(d, -1.0f);
    float* fi = first + i;
    fi[0] = fn.x;
    fi[n] = fn.y;
    fi[2 * n] = fn.z;
    fi[3 * n] = hit ? f.h.t : POCA_INF;
  }
  if (was_alive && !hit) alive[i] = false;
  if (hit) {
    const V3 d2 = normalize(f.s.bounce);
    c[0] = f.pos.x;
    c[n] = f.pos.y;
    c[2 * n] = f.pos.z;
    c[3 * n] = d2.x;
    c[4 * n] = d2.y;
    c[5 * n] = d2.z;
  }
}
