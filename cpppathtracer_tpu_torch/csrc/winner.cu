// The dense closest-hit winner search as a standalone kernel around
// winner.cuh's poca_winner_search.
//
// Replaces cpppathtracer_tpu/ops/pallas/intersect_kernel.py::
// pallas_winner_index_planar, pallas_winner_index_v and
// pallas_winner_index.  The three compute one function and differ only in
// how they lay rays and objects out for the TPU's registers and matrix
// unit (planar or packed [8, R] rays, MXU or VPU form); this launch reads
// the planar rays, and the wavefront path (ops/fast.py) is its only
// caller.
//
// What bounds it on an H100: FP32 operations, about 33 per (sphere, ray)
// and 87 per (cylinder, ray) pair; per ray it reads 8 floats and writes
// one int.  The design:
// - blocks of 1024 threads, one ray a thread, each staging the geometry
//   rows (32 bytes per object, 8-row aligned groups) in dynamic shared
//   memory, above 48 KB by opt-in.  A scene of a few thousand objects
//   fills most of an SM's shared memory, so one block fits on an SM: at
//   1024 threads that is 32 resident warps to hide the latency of the
//   square roots and divisions, and the rows are read from global memory
//   once per 1024 rays.  (Persistent blocks that stage the rows once per
//   SM and take rays from a counter were no faster; PERF.md);
// - each warp runs the warp-wide search of winner.cuh; a lane past R runs
//   masked.
// Rows past one block's shared memory (tile_rows, 7,264 rows of 32 bytes
// in the card's 227 KB, about 7,000 objects) are staged in tiles of
// tile_rows rows taken in grouped order, as the Pallas kernel keeps every
// row in VMEM: a tile is rows [r0, r1) of the grouped layout, with r0 and
// r1 multiples of 8, so its parts of the three groups are again 8-row
// aligned groups and winner.cuh searches it as a scene of its own.  Each
// lane carries its best (t, index) across tiles and takes a tile's
// winner only when strictly closer, so the lowest grouped index wins a
// tie as in the one-tile search, bit for bit.  A scene that fits in one
// tile takes the one-tile instance, unchanged.
#include <cuda_runtime.h>

#include "winner.cuh"

#define POCA_WINNER_BLOCK 1024

struct WinnerArgs {
  const float *ox, *oy, *oz, *dx, *dy, *dz, *tmin, *tmax, *geom;
  int* out;
  int R, n_s, n_p, n_c, n_rep, tile_rows;
};

// TILED: the rows are staged tile_rows at a time (the header).
template <bool TILED>
__global__ void __launch_bounds__(POCA_WINNER_BLOCK) winner_index_kernel(WinnerArgs a) {
  extern __shared__ float4 srows[];
  float* s = reinterpret_cast<float*>(srows);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool on = i < a.R;
  const int j = on ? i : a.R - 1;  // a masked lane reads a ray it does not write
  if (!TILED) {
    for (int k = threadIdx.x; k < 8 * a.n_rep; k += blockDim.x) s[k] = __ldg(a.geom + k);
    __syncthreads();
    float best_t;
    const int w = poca_winner_search(srows, a.n_s, a.n_p, a.n_c, on, a.ox[j], a.oy[j], a.oz[j],
                                     a.dx[j], a.dy[j], a.dz[j], a.tmin[j], a.tmax[j], best_t);
    if (on) a.out[i] = w;
    return;
  }
  const float ox = a.ox[j], oy = a.oy[j], oz = a.oz[j];
  const float dx = a.dx[j], dy = a.dy[j], dz = a.dz[j];
  const float tmin = a.tmin[j], tmax = a.tmax[j];
  const int p_row = poca_ceil8(a.n_s), c_row = p_row + poca_ceil8(a.n_p);
  float best_t = POCA_INF;
  int best_i = 0;
  for (int r0 = 0; r0 < a.n_rep; r0 += a.tile_rows) {
    const int r1 = min(r0 + a.tile_rows, a.n_rep);
    __syncthreads();  // every lane is done with the previous tile
    for (int k = threadIdx.x; k < 8 * (r1 - r0); k += blockDim.x) s[k] = __ldg(a.geom + 8 * r0 + k);
    __syncthreads();
    // the tile's objects of each group: [lo, hi) in the group's own order
    const int s_lo = min(r0, a.n_s), s_hi = min(r1, a.n_s);
    const int p_lo = min(max(r0 - p_row, 0), a.n_p), p_hi = min(max(r1 - p_row, 0), a.n_p);
    const int c_lo = min(max(r0 - c_row, 0), a.n_c), c_hi = min(max(r1 - c_row, 0), a.n_c);
    const int ns = s_hi - s_lo, np = p_hi - p_lo, nc = c_hi - c_lo;
    float t;
    const int w = poca_winner_search(srows, ns, np, nc, on, ox, oy, oz, dx, dy, dz, tmin, tmax, t);
    if (t < best_t) {
      best_t = t;
      best_i = w < ns ? s_lo + w
             : w < ns + np ? a.n_s + p_lo + (w - ns)
             : a.n_s + a.n_p + c_lo + (w - ns - np);
    }
  }
  if (on) a.out[i] = best_i;
}

// The kernel a call over n_rep rows launches, with the shared memory a
// block stages, opted into above 48 KB.
static int winner_pick(int n_rep, int tile_rows, void (**kern)(WinnerArgs), size_t* smem) {
  const bool tiled = n_rep > tile_rows;
  *kern = tiled ? winner_index_kernel<true> : winner_index_kernel<false>;
  *smem = sizeof(float) * 8 * (size_t)(tiled ? tile_rows : n_rep);
  if (*smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(*kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)*smem);
  return 0;
}

// Rays: 8 planes f32[R]; geom f32[n_rep, 8]; out i32[R]; tile_rows, a
// multiple of 8, the rows one block stages at a time.
extern "C" int poca_winner_index(
    const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz,
    const float* tmin, const float* tmax, const float* geom,
    int* out, int R, int n_s, int n_p, int n_c, int n_rep, int tile_rows, cudaStream_t stream) {
  if (R <= 0) return 0;
  if (tile_rows < 8 || tile_rows % 8) return (int)cudaErrorInvalidValue;
  void (*kern)(WinnerArgs);
  size_t smem = 0;
  const int err = winner_pick(n_rep, tile_rows, &kern, &smem);
  if (err) return err;
  WinnerArgs a = {ox, oy, oz, dx, dy, dz, tmin, tmax, geom, out,
                  R, n_s, n_p, n_c, n_rep, tile_rows};
  const int grid = (R + POCA_WINNER_BLOCK - 1) / POCA_WINNER_BLOCK;
  kern<<<grid, POCA_WINNER_BLOCK, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The registers, local bytes per thread, resident blocks per SM and grid
// of a launch over R rays with n_rep rows, into info[0..3].
extern "C" int poca_winner_info(int R, int n_rep, int tile_rows, int* info) {
  void (*kern)(WinnerArgs);
  size_t smem = 0;
  const int err = winner_pick(n_rep, tile_rows, &kern, &smem);
  if (err) return err;
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, kern);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, POCA_WINNER_BLOCK, smem);
  if (e != cudaSuccess) return (int)e;
  info[0] = fa.numRegs;
  info[1] = (int)fa.localSizeBytes;
  info[2] = per_sm;
  info[3] = (R + POCA_WINNER_BLOCK - 1) / POCA_WINNER_BLOCK;
  return 0;
}
