// The wavefront bounce kernel's per-lane body (cpppathtracer_tpu_torch/csrc/
// wavefront.cuh) compiled for the host, so that tests/test_torch_wavefront.py
// can hold it bitwise against the PyTorch body without a card:
//
//   g++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC
//       -I cpppathtracer_tpu_torch/csrc tests/wavefront_host.cpp -o libwavefront_host.so
//
// Same planes as csrc/wavefront.cu's poca_wavefront_bounce (the seed as a
// value), the lanes one after the other.  Every operation of the body but
// seven rounds alike on the host and in PyTorch's CPU kernels: +, -, *, /,
// min, max, compares and the integer hash.  The seven, powf, logf, expf,
// tanhf, cosf, sinf and sqrtf, round differently in the host's libm (and
// its correctly rounded sqrtss) and in PyTorch's vectorised CPU kernels
// (MKL's and SLEEF's, whose sqrt is not always correctly rounded), so here
// they answer from tables of PyTorch's own results keyed by the argument's
// bits (poca_wavefront_host_fn, filled by the test from the PyTorch body's
// calls).  An argument that is not in its table is counted and answered by
// libm: a count above zero means the body reached one of them with another
// argument than PyTorch did.  (On the card both sides call CUDA's own
// functions, and the kernel is held bitwise against the same body there.)
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

struct FnTable {
  const uint32_t* keys;  // argument bits, ascending
  const uint32_t* vals;  // result bits
  int n;
};

enum { FN_POW, FN_LOG, FN_EXP, FN_TANH, FN_COS, FN_SIN, FN_SQRT, FN_COUNT };
FnTable g_tables[FN_COUNT];
int g_missing = 0;

float from_table(int fn, float x, float libm) {
  uint32_t k;
  memcpy(&k, &x, sizeof k);
  const FnTable& t = g_tables[fn];
  int lo = 0, hi = t.n;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (t.keys[mid] < k) lo = mid + 1;
    else hi = mid;
  }
  if (lo < t.n && t.keys[lo] == k) {
    float v;
    memcpy(&v, &t.vals[lo], sizeof v);
    return v;
  }
  ++g_missing;
  return libm;
}

// torch.pow(1000, s): keyed by the exponent, the base is always 1000
float host_powf(float b, float e) { return b == 1000.0f ? from_table(FN_POW, e, powf(b, e))
                                                        : (++g_missing, powf(b, e)); }
float host_logf(float x) { return from_table(FN_LOG, x, logf(x)); }
float host_expf(float x) { return from_table(FN_EXP, x, expf(x)); }
float host_tanhf(float x) { return from_table(FN_TANH, x, tanhf(x)); }
float host_cosf(float x) { return from_table(FN_COS, x, cosf(x)); }
float host_sinf(float x) { return from_table(FN_SIN, x, sinf(x)); }
float host_sqrtf(float x) { return from_table(FN_SQRT, x, sqrtf(x)); }

}  // namespace

#define powf host_powf
#define logf host_logf
#define expf host_expf
#define tanhf host_tanhf
#define cosf host_cosf
#define sinf host_sinf
#define sqrtf host_sqrtf
#include "wavefront.cuh"

// Table `fn` (0 pow, 1 log, 2 exp, 3 tanh, 4 cos, 5 sin, 6 sqrt): n argument bits in
// ascending order and their results' bits; the arrays stay the caller's.
extern "C" void poca_wavefront_host_fn(int fn, const uint32_t* keys, const uint32_t* vals,
                                       int n) {
  g_tables[fn] = {keys, vals, n};
}

// One bounce of R lanes in place; returns the arguments missing from the
// tables.
extern "C" int poca_wavefront_host(float* carry, bool* alive, float* first, const int* gidx,
                                   const int* pix, const int* samp, int seed, const float* ts,
                                   const float* trt, int R, int n_tab, int bounce) {
  g_missing = 0;
  for (int i = 0; i < R; ++i)
    wavefront_lane(i, R, n_tab, bounce, (uint32_t)seed, carry, alive, first, gidx, pix, samp,
                   ts, trt);
  return g_missing;
}
