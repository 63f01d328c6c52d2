// The BVH walk of cpppathtracer_tpu_torch/csrc/bvh.cuh compiled for the
// host, so that tests/test_torch_bvh.py can hold it bitwise against the
// plain PyTorch version without a card:
//
//   g++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC
//       -I cpppathtracer_tpu_torch/csrc tests/bvh_host.cpp -o libbvh_host.so
//
// Same rays and layout as csrc/bvh.cu's poca_bvh_winner_index, and the same
// walk per ray (bvh_walk_grouped), plus what each walk tested: slab tests
// i32[R] and leaf rows by type (sphere, platform, cylinder) i32[3, R].  The
// walk uses only +, -, *, /, sqrt, min and max, which round alike on the
// host and the card.
#include "bvh.cuh"

extern "C" int poca_bvh_winner_host(
    const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz,
    const float* tmin, const float* tmax,
    const float* nodes, const int* leaves, const float* rows, const int* gidx,
    int* out, int* n_nodes, int* n_rows, int R, int m) {
  for (int i = 0; i < R; ++i) {
    const BvhRay r = bvh_ray(ox[i], oy[i], oz[i], dx[i], dy[i], dz[i], tmin[i]);
    BvhCounts c = {0, {0, 0, 0}};
    out[i] = bvh_walk_grouped<true>(reinterpret_cast<const float4*>(nodes),
                                    reinterpret_cast<const int4*>(leaves),
                                    {reinterpret_cast<const float4*>(rows), gidx}, m, r,
                                    tmax[i], &c);
    n_nodes[i] = c.nodes;
    for (int t = 0; t < 3; ++t) n_rows[t * R + i] = c.rows[t];
  }
  return 0;
}
