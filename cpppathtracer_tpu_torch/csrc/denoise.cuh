// The edge-avoiding 5x5 denoiser's block of work, host-and-device: the
// staging of a tile, the pair weights and the taps (csrc/denoise.cu
// launches them; tests/denoise_host.cpp runs them on the CPU, one thread
// after the other, phase by phase).
//
// A block of DN_THREADS threads covers DN_BX x DN_BY pixels.  It stages
// its tile and a halo of r = 2 * stepwidth pixels on each side in shared
// memory (zeros outside the image, as the plain version's padding), then
// runs the 25 taps of each pixel in the plain version's order (i over x
// offsets outer, j over y offsets inner) with its arithmetic, each
// operation rounded alone (built with --fmad=false or -ffp-contract=off):
// the squared distances summed over the channels as (c0 + c1) + c2, times
// -1/pi as float32, expf, the weight (((c_w * n_w) * p_w) * valid) * k,
// num += wgt * tap, den += wgt, and num / den.
//
// Five design steps, each bitwise (scripts/torch_kernel_steps.py turns
// each off in a copy of this directory and times what it buys):
//
//   fixed_step  the stepwidth every caller passes (1) is a template
//               instance, so the tile width and the 25 tap offsets are
//               constants and each shared load takes an immediate offset
//               (S = 0 reads the stepwidth at run time: the steps script's
//               form with this step off).
//   float4      a staged pixel is two 16-byte words, (c0, c1, c2, d) and
//               (n0, n1, n2, 0), in two planes: a tap reads two 16-byte
//               loads, not seven 4-byte ones.
//   interior    a block whose tile and halo lie inside the image tests no
//               bounds: multiplying by valid = 1.0f changes no bit.
//   pairs       the weight factor (c_w * n_w) * p_w of pixel p at offset o
//               is bitwise that of pixel p + o at offset -o (IEEE
//               subtraction is antisymmetric, so the squares are equal; the
//               channel sum, the scale and expf are the same operations;
//               KERNEL_5X5 is symmetric under a half turn; valid and k
//               multiply after the factor).  So the block computes the
//               factor once a pair: for the 12 offsets of one half, o =
//               (dx, dy) with dy > 0 or (dy == 0 and dx > 0), at every
//               staged position whose factor some pixel of the tile reads
//               (the tile's rows and r above, the full staged width), into
//               shared memory; a pixel then reads its 12 own factors at its
//               position and the other 12 at its partners'.  Only the
//               centre's factor is computed by the pixel itself (1 for
//               finite inputs, NaN for an inf or NaN one).
//   strips      a thread takes DN_V pixels down a column in the taps, and
//               dn_strip(S) positions down a column in the pair factors;
//               the taps (or partners) of one x offset that its pixels
//               share are read once for all of them.  The accumulation
//               order of each pixel is unchanged.
//
// Every other stepwidth runs dn_pixel below: one pixel a thread, its taps
// read from device memory, so any stepwidth launches (a staged tile and
// halo outgrow shared memory past some 15).
#pragma once

#ifdef __CUDACC__
#define POCA_DN_HD __host__ __device__ __forceinline__
#else
#include <math.h>
#define POCA_DN_HD inline
struct float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
#endif

#define DN_BX 32
#define DN_BY 16
// pixels a thread takes in the taps, down a column
#define DN_V 2
#define DN_THREADS (DN_BX * DN_BY / DN_V)
// the offsets of one half of the footprint, whose factors are staged
#define DN_HALF 12

// float32(1 / pi), as ops/cuda/denoise_kernel.py's _INV_PI
#define POCA_INV_PI 0x1.45f306p-2f

// KERNEL_5X5[i][j] of tap t = 5 * i + j
POCA_DN_HD constexpr float dn_k(int t) {
  return (t == 12) ? 41.f
       : (t == 7 || t == 11 || t == 13 || t == 17) ? 26.f
       : (t == 6 || t == 8 || t == 16 || t == 18) ? 16.f
       : (t == 2 || t == 10 || t == 14 || t == 22) ? 7.f
       : (t == 0 || t == 4 || t == 20 || t == 24) ? 1.f
       : 4.f;
}

// Tap t = 5 * i + j lies at dx = (i - 2) * step, dy = (j - 2) * step; its
// half-turn partner is 24 - t.  The staged half: dy > 0 (j > 2), or dy == 0
// and dx > 0 (j == 2, i > 2); its taps, in order, are factor planes 0-11.
POCA_DN_HD constexpr bool dn_in_half(int t) { return t % 5 > 2 || (t % 5 == 2 && t > 12); }
POCA_DN_HD constexpr int dn_plane(int t) {
  // taps 3 4 8 9 13 14 17 18 19 22 23 24
  return t < 5 ? t - 3 : t < 10 ? t - 6 : t < 15 ? t - 9 : t < 20 ? t - 11 : t - 13;
}
// the tap of factor plane h
POCA_DN_HD constexpr int dn_half_tap(int h) {
  return h < 2 ? h + 3 : h < 4 ? h + 6 : h < 6 ? h + 9 : h < 9 ? h + 11 : h + 13;
}
POCA_DN_HD constexpr bool dn_half_ok(int h = 0) {
  return h == DN_HALF || (dn_in_half(dn_half_tap(h)) && dn_plane(dn_half_tap(h)) == h &&
                          !dn_in_half(24 - dn_half_tap(h)) && dn_half_ok(h + 1));
}
static_assert(dn_half_ok(), "the staged half and its planes");

// Positions a thread takes in the pair factors, down a column: they divide
// the DN_BY + 2 * stepwidth rows that carry factors.
POCA_DN_HD constexpr int dn_strip(int S) { return S == 1 ? 3 : 2; }
static_assert((DN_BY + 2) % dn_strip(1) == 0 && DN_BY % 2 == 0 && DN_BY % DN_V == 0,
              "strips divide the rows");

// The block's geometry at stepwidth S (S = 0: the stepwidth given at run time).
template <int S>
struct DnTile {
  int step_;
  POCA_DN_HD explicit DnTile(int step) : step_(step) {}
  POCA_DN_HD int step() const { return S ? S : step_; }
  POCA_DN_HD int r() const { return 2 * step(); }
  POCA_DN_HD int tw() const { return DN_BX + 2 * r(); }        // staged width
  POCA_DN_HD int tn() const { return tw() * (DN_BY + 2 * r()); }  // staged positions
  // the staged planes' length: a pair factor's partner reads up to r past the end
  POCA_DN_HD int tnp() const { return tn() + r(); }
  POCA_DN_HD int rn() const { return tw() * (DN_BY + r()); }   // positions with pair factors
  POCA_DN_HD int off(int t) const { return ((t % 5) - 2) * step() * tw() + (t / 5 - 2) * step(); }
};

// Shared memory of one block: two float4 planes of tnp, then (with pairs)
// DN_HALF float planes of rn pair factors.
POCA_DN_HD long dn_smem_bytes(int tnp, int rn, bool pairs) {
  return 2 * 16 * (long)tnp + (pairs ? DN_HALF * 4 * (long)rn : 0);
}

struct DnPix {
  float c0, c1, c2, d, n0, n1, n2;
};

// ---- the staged layout: planes (c0, c1, c2, d) and (n0, n1, n2, 0)
POCA_DN_HD void dn_put(float4* sm, int tnp, int k, const DnPix& v) {
  sm[k] = make_float4(v.c0, v.c1, v.c2, v.d);
  sm[tnp + k] = make_float4(v.n0, v.n1, v.n2, 0.f);
}

POCA_DN_HD DnPix dn_get(const float4* sm, int tnp, int k) {
  const float4 a = sm[k], b = sm[tnp + k];
  return {a.x, a.y, a.z, a.w, b.x, b.y, b.z};
}

POCA_DN_HD float4 dn_get_c(const float4* sm, int tnp, int k) { return sm[k]; }
// ---- end of the staged layout

// (c_w * n_w) * p_w of centre a and tap b, as the plain version rounds it
POCA_DN_HD float dn_factor(const DnPix& a, const DnPix& b) {
  const float cd0 = a.c0 - b.c0, cd1 = a.c1 - b.c1, cd2 = a.c2 - b.c2;
  const float nd0 = a.n0 - b.n0, nd1 = a.n1 - b.n1, nd2 = a.n2 - b.n2;
  const float pd = a.d - b.d;
  const float c_w = expf(-(cd0 * cd0 + cd1 * cd1 + cd2 * cd2) * POCA_INV_PI);
  const float n_w = expf(-(nd0 * nd0 + nd1 * nd1 + nd2 * nd2) * POCA_INV_PI);
  const float p_w = expf(-(pd * pd) * POCA_INV_PI);
  return c_w * n_w * p_w;
}

struct DnArgs {
  const float* rad;
  const float* nrm;
  const float* dep;
  float* out;
  int H, W;
};

// Stage the tile and halo of block (bx, by); thread tid of DN_THREADS.
template <int S>
POCA_DN_HD void dn_stage(const DnArgs& a, const DnTile<S>& g, float4* sm, int bx, int by,
                         bool interior, int tid) {
  const int x0 = bx * DN_BX - g.r(), y0 = by * DN_BY - g.r();
  for (int k = tid; k < g.tn(); k += DN_THREADS) {
    const int ky = k / g.tw();
    const int gx = x0 + (k - ky * g.tw()), gy = y0 + ky;
    DnPix v = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (interior || (gx >= 0 && gx < a.W && gy >= 0 && gy < a.H)) {
      const long p = (long)gy * a.W + gx;
      v = {a.rad[3 * p], a.rad[3 * p + 1], a.rad[3 * p + 2], a.dep[p],
           a.nrm[3 * p], a.nrm[3 * p + 1], a.nrm[3 * p + 2]};
    }
    dn_put(sm, g.tnp(), k, v);
  }
}

// The pair factors of the staged half at every position q < rn: plane h
// holds factor(q, q + offset of tap dn_half_tap(h)).  A thread takes a strip
// of dn_strip(S) positions down a column; the half's taps of one column
// offset read the rows of a strip's partners once for all its positions
// (all loads of a column offset come before its stores, so the compiler
// can merge equal ones; the own column first, whose partners below are
// own positions).
template <int S>
POCA_DN_HD void dn_pairs(const DnTile<S>& g, float4* sm, int tid) {
  constexpr int V = dn_strip(S);
  float* const wf = reinterpret_cast<float*>(sm + 2 * g.tnp());
  const int strips = g.tw() * (DN_BY + g.r()) / V;
  for (int k = tid; k < strips; k += DN_THREADS) {
    const int sy = k / g.tw();
    const int q = sy * V * g.tw() + (k - sy * g.tw());
    DnPix own[V];
#pragma unroll
    for (int v = 0; v < V; ++v) own[v] = dn_get(sm, g.tnp(), q + v * g.tw());
#pragma unroll
    for (int n = 0; n < 5; ++n) {
      const int i = (n + 2) % 5;  // x offsets 0, -2, -1, 1, 2
      float f[3][V];
#pragma unroll
      for (int j = 2; j < 5; ++j)
#pragma unroll
        for (int v = 0; v < V; ++v)
          if (dn_in_half(5 * i + j))
            f[j - 2][v] = dn_factor(own[v], dn_get(sm, g.tnp(), q + v * g.tw() + g.off(5 * i + j)));
#pragma unroll
      for (int j = 2; j < 5; ++j)
#pragma unroll
        for (int v = 0; v < V; ++v)
          if (dn_in_half(5 * i + j)) wf[dn_plane(5 * i + j) * g.rn() + q + v * g.tw()] = f[j - 2][v];
    }
  }
}

// The 25 taps of thread tid's DN_V pixels (down a column) of block (bx,
// by), and their output.  The taps of one x offset read the rows they
// share once for all the thread's pixels.  EDGE: some tap of the block may
// lie outside the image.
template <int S, bool PAIRS, bool EDGE>
POCA_DN_HD void dn_taps(const DnArgs& a, const DnTile<S>& g, const float4* sm, int bx, int by,
                        int tid) {
  constexpr int V = DN_V;
  const int tx = tid % DN_BX, ty = tid / DN_BX;
  const int px = bx * DN_BX + tx, py = by * DN_BY + ty * V;  // the thread's first pixel
  if (px >= a.W || py >= a.H) return;
  const float* const wf = reinterpret_cast<const float*>(sm + 2 * g.tnp());
  const int c = (ty * V + g.r()) * g.tw() + tx + g.r();
  DnPix ctr[V];
  float fc[V], num0[V], num1[V], num2[V], den[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    ctr[v] = dn_get(sm, g.tnp(), c + v * g.tw());
    fc[v] = dn_factor(ctr[v], ctr[v]);
    num0[v] = num1[v] = num2[v] = den[v] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int dx = (i - 2) * g.step();
    const bool in_x = px + dx >= 0 && px + dx < a.W;
#pragma unroll
    for (int j = 0; j < 5; ++j) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int t = 5 * i + j;
        const int cv = c + v * g.tw(), o = g.off(t);
        float wgt;
        float4 tap;
        if (t == 12) {
          wgt = fc[v];
          tap = make_float4(ctr[v].c0, ctr[v].c1, ctr[v].c2, ctr[v].d);
        } else if (!PAIRS) {
          const DnPix b = dn_get(sm, g.tnp(), cv + o);
          wgt = dn_factor(ctr[v], b);
          tap = make_float4(b.c0, b.c1, b.c2, b.d);
        } else {
          wgt = dn_in_half(t) ? wf[dn_plane(t) * g.rn() + cv]
                              : wf[dn_plane(24 - t) * g.rn() + cv + o];
          tap = dn_get_c(sm, g.tnp(), cv + o);
        }
        if (EDGE) {
          const int y = py + v + (j - 2) * g.step();
          wgt = wgt * (in_x && y >= 0 && y < a.H ? 1.f : 0.f);
        }
        wgt = wgt * dn_k(t);
        num0[v] = num0[v] + wgt * tap.x;
        num1[v] = num1[v] + wgt * tap.y;
        num2[v] = num2[v] + wgt * tap.z;
        den[v] = den[v] + wgt;
      }
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    if (py + v < a.H) {
      const long p = (long)(py + v) * a.W + px;
      a.out[3 * p] = num0[v] / den[v];
      a.out[3 * p + 1] = num1[v] / den[v];
      a.out[3 * p + 2] = num2[v] / den[v];
    }
  }
}

// Block (bx, by)'s tile and halo lie inside the image.
template <int S>
POCA_DN_HD bool dn_interior(const DnArgs& a, const DnTile<S>& g, int bx, int by) {
  return bx * DN_BX >= g.r() && (bx + 1) * DN_BX + g.r() <= a.W && by * DN_BY >= g.r() &&
         (by + 1) * DN_BY + g.r() <= a.H;
}

// The plain version's 25 taps of pixel (px, py) at any stepwidth >= 0, each
// read from device memory (zeros outside the image, weighted by valid =
// 0), in its order and with its arithmetic.
POCA_DN_HD DnPix dn_load(const DnArgs& a, long x, long y) {
  if (x < 0 || x >= a.W || y < 0 || y >= a.H) return {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const long p = y * a.W + x;
  return {a.rad[3 * p], a.rad[3 * p + 1], a.rad[3 * p + 2], a.dep[p],
          a.nrm[3 * p], a.nrm[3 * p + 1], a.nrm[3 * p + 2]};
}

POCA_DN_HD void dn_pixel(const DnArgs& a, int step, int px, int py) {
  const DnPix ctr = dn_load(a, px, py);
  float num0 = 0.f, num1 = 0.f, num2 = 0.f, den = 0.f;
  for (int i = 0; i < 5; ++i) {
    const long x = px + (long)(i - 2) * step;
    for (int j = 0; j < 5; ++j) {
      const long y = py + (long)(j - 2) * step;
      const DnPix b = dn_load(a, x, y);
      float wgt = dn_factor(ctr, b);
      wgt = wgt * (x >= 0 && x < a.W && y >= 0 && y < a.H ? 1.f : 0.f);
      wgt = wgt * dn_k(5 * i + j);
      num0 = num0 + wgt * b.c0;
      num1 = num1 + wgt * b.c1;
      num2 = num2 + wgt * b.c2;
      den = den + wgt;
    }
  }
  const long p = (long)py * a.W + px;
  a.out[3 * p] = num0 / den;
  a.out[3 * p + 1] = num1 / den;
  a.out[3 * p + 2] = num2 / den;
}
