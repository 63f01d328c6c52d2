// The denoise kernel's block of work (cpppathtracer_tpu_torch/csrc/denoise.cuh)
// compiled for the host, so that tests/test_torch_denoise.py can hold its
// tiles, halo, pair factors and tap order against a plain loop without a card:
//
//   g++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC
//       -I cpppathtracer_tpu_torch/csrc tests/denoise_host.cpp -o libdenoise_host.so
//
// poca_denoise_host runs each block as csrc/denoise.cu's tiled kernel does,
// its threads one after the other in each phase (stage, pair factors,
// taps), at the instance the arguments choose: the stepwidth as a
// compile-time constant (1) or read at run time, with or without pair
// factors, with or without the interior blocks' shortcut.
// poca_denoise_host_any runs the untiled kernel of every other stepwidth,
// dn_pixel a pixel.  poca_denoise_loop is the plain version's arithmetic
// written as one loop a pixel.  All call the host's expf, so they agree
// bitwise where the kernels' logic is right.
#include <string.h>

#include <vector>

#include "denoise.cuh"

template <int S, bool PAIRS>
static void run(const DnArgs& a, int step, bool interior_ok) {
  const DnTile<S> g(step);
  const long bytes = dn_smem_bytes(g.tnp(), g.rn(), PAIRS);
  std::vector<float4> sm((bytes + 15) / 16);
  for (int by = 0; by * DN_BY < a.H; ++by) {
    for (int bx = 0; bx * DN_BX < a.W; ++bx) {
      memset(sm.data(), 0xff, sm.size() * sizeof(float4));  // NaN where nothing is staged
      const bool interior = interior_ok && dn_interior(a, g, bx, by);
      for (int tid = 0; tid < DN_THREADS; ++tid) dn_stage(a, g, sm.data(), bx, by, interior, tid);
      if (PAIRS)
        for (int tid = 0; tid < DN_THREADS; ++tid) dn_pairs(g, sm.data(), tid);
      for (int tid = 0; tid < DN_THREADS; ++tid) {
        if (interior)
          dn_taps<S, PAIRS, false>(a, g, sm.data(), bx, by, tid);
        else
          dn_taps<S, PAIRS, true>(a, g, sm.data(), bx, by, tid);
      }
    }
  }
}

extern "C" int poca_denoise_host(const float* rad, const float* nrm, const float* dep, float* out,
                                 int H, int W, int step, int fixed, int pairs, int interior) {
  const DnArgs a = {rad, nrm, dep, out, H, W};
  if (fixed && step == 1) {
    pairs ? run<1, true>(a, step, interior) : run<1, false>(a, step, interior);
  } else {
    pairs ? run<0, true>(a, step, interior) : run<0, false>(a, step, interior);
  }
  return 0;
}

extern "C" int poca_denoise_host_any(const float* rad, const float* nrm, const float* dep,
                                     float* out, int H, int W, int step) {
  const DnArgs a = {rad, nrm, dep, out, H, W};
  for (int py = 0; py < H; ++py)
    for (int px = 0; px < W; ++px) dn_pixel(a, step, px, py);
  return 0;
}

extern "C" int poca_denoise_loop(const float* rad, const float* nrm, const float* dep, float* out,
                                 int H, int W, int step) {
  for (int py = 0; py < H; ++py) {
    for (int px = 0; px < W; ++px) {
      const long p = (long)py * W + px;
      float num[3] = {0.f, 0.f, 0.f}, den = 0.f;
      for (int i = 0; i < 5; ++i) {
        for (int j = 0; j < 5; ++j) {
          const int qx = px + (i - 2) * step, qy = py + (j - 2) * step;
          const bool inside = qx >= 0 && qx < W && qy >= 0 && qy < H;
          const long q = (long)qy * W + qx;
          float c[3], n[3], d = 0.f;
          for (int ch = 0; ch < 3; ++ch) {
            c[ch] = inside ? rad[3 * q + ch] : 0.f;
            n[ch] = inside ? nrm[3 * q + ch] : 0.f;
          }
          if (inside) d = dep[q];
          float cs = 0.f, ns = 0.f;
          for (int ch = 0; ch < 3; ++ch) {
            const float cd = rad[3 * p + ch] - c[ch], nd = nrm[3 * p + ch] - n[ch];
            cs = ch ? cs + cd * cd : cd * cd;
            ns = ch ? ns + nd * nd : nd * nd;
          }
          const float pd = dep[p] - d;
          const float c_w = expf(-cs * POCA_INV_PI);
          const float n_w = expf(-ns * POCA_INV_PI);
          const float p_w = expf(-(pd * pd) * POCA_INV_PI);
          const float wgt = c_w * n_w * p_w * (inside ? 1.f : 0.f) * dn_k(5 * i + j);
          for (int ch = 0; ch < 3; ++ch) num[ch] = num[ch] + wgt * c[ch];
          den = den + wgt;
        }
      }
      for (int ch = 0; ch < 3; ++ch) out[3 * p + ch] = num[ch] / den;
    }
  }
  return 0;
}
