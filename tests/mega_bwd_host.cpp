// The backward kernel's per-ray body (cpppathtracer_tpu_torch/csrc/
// mega_bwd.cuh) compiled for the host, so that tests/test_torch_grad.py can
// hold its hand-derived adjoints against torch autograd without a card:
//
//   g++ -std=c++17 -O2 -shared -fPIC -I cpppathtracer_tpu_torch/csrc
//       tests/mega_bwd_host.cpp -o libmega_bwd_host.so
//
// Same arguments as csrc/mega_bwd.cu's poca_mega_bwd (ct_aux null, or the
// [4 depth, R] aux cotangents of a textured sample), less the stream and
// the shared-memory switch; the rays run one after the other and the table
// cotangents are plain sums.  The host's expf/logf/tanhf/sinf/cosf/powf
// round differently from the card's, so the results agree with the
// plain version to float32 tolerance, not bitwise.
#include "mega_bwd.cuh"

extern "C" int poca_mega_bwd_host(
    const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz,
    const int* pix, const int* samp, const float* ts, const float* trt, const int* hits,
    const float* ct0, const float* ct1, const float* ct2, const float* ct3,
    const float* ct4, const float* ct5, const float* ct6, const float* ct7,
    const float* ct8, const float* ct9, const float* ct10, const float* ct11,
    const float* ct12, const float* ct_aux,
    float* out_tab, float* out_od, float* carry,
    int R, int n_pad, int depth, int seed) {
  // the seed word the card's kernel reads from device memory
  if (depth < 1 || depth > POCA_MAX_DEPTH) return 1;
  BwdParams p = {ox, oy, oz, dx, dy, dz, pix, samp, ts, trt, hits,
                 {ct0, ct1, ct2, ct3, ct4, ct5, ct6, ct7, ct8, ct9, ct10, ct11, ct12},
                 ct_aux, out_tab, out_od, carry, &seed, R, n_pad, depth};
  TableAcc acc = {out_tab, n_pad};
  for (int i = 0; i < R; ++i) {
    if (ct_aux) mega_bwd_ray<true>(p, i, ts, trt, acc, p.seed);
    else mega_bwd_ray<false>(p, i, ts, trt, acc, p.seed);
  }
  return 0;
}
