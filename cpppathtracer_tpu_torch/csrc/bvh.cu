// The skip-pointer BVH walk as a kernel: persistent warps, each walking 32
// rays at a time in lock-step over the walk's own layout of the tables
// (bvh.cuh).
//
// Replaces cpppathtracer_tpu/ops/pallas/bvh_kernel.py::
// pallas_bvh_winner_index.  Per ray it reads 8 floats (o, d, tmin, tmax)
// and writes one int, the closest hit's grouped index (0 on a miss).
//
// What bounds it on an H100: FP32 operations, the slab tests and leaf-row
// tests that each ray's walk needs (counted by the plain version), at the
// 67 TFLOP/s of the FP32 units.  What the design does about the rest:
// - leaf rows grouped by type: a warp's lanes sit in different leaves, and
//   rows in table order made each row step run the sphere, platform and
//   cylinder bodies one after another.  Here a leaf is tested in three
//   phases, all the warp's sphere rows, then its cylinder rows, then its
//   platform rows, and padding rows are gone;
// - lanes park at leaves: a lane that overlaps a leaf waits there (its
//   node already moved on to the escape, its best t kept) while the other
//   lanes walk on, one node per step; once POCA_BVH_PARK_MIN lanes are
//   parked, or none is still walking, the warp tests the parked lanes'
//   leaves together.  Each ray still tests its own leaves in its own walk
//   order, so the result is the one-ray walk's (bvh_walk_grouped) bit for
//   bit;
// - the nodes (two 16-byte words each) and the leaf headers live in shared
//   memory, staged once per block, when they fit in POCA_BVH_NODE_SMEM_MAX
//   bytes; else they are read through the read-only cache.  Rows are
//   16-byte words read through the same cache, a sphere in one
//   (big_scene(16384)'s rows take 175 KB where the JAX-equal rows take
//   512 KB), and a row's grouped index is read only when the row is the
//   leaf's best so far;
// - persistent blocks, one wave: each warp takes the next 32 rays from a
//   counter in device memory (atomicAdd; zeroed by a memset before the
//   launch), so warps whose rays escape early take more.
// Precondition: tmax <= INF on every ray (the wavefront path passes INF);
// the layout drops padding rows, which is exact only then (bvh.cuh).  Rays
// are bounds-checked, never padded.
#include <cuda_runtime.h>

#include "bvh.cuh"

#define POCA_BVH_BLOCK 256
#define POCA_BVH_PARK_MIN 32
// M = 511 nodes and 256 leaves take 20 KB
#define POCA_BVH_NODE_SMEM_MAX (48 * 1024)

struct BvhArgs {
  const float *ox, *oy, *oz, *dx, *dy, *dz, *tmin, *tmax;
  const float4* nodes;  // the walk's layout
  const int4* leaves;
  BvhRows rows;
  int* out;
  int* counter;
  int R, m, n_leaves;
};

// Test the parked lanes' leaves (lf zero on the other lanes), type phase
// by type phase; each phase runs as many row steps as the warp's longest.
template <int kType>
__device__ __forceinline__ void leaf_phase(BvhRows rows, int4 lf, int n, const BvhRay& r,
                                           float best_t, BvhBest& w) {
  const int steps = __reduce_max_sync(0xffffffffu, n);
  for (int j = 0; j < steps; ++j)
    if (j < n) bvh_leaf_row<kType>(rows, lf, j, r, best_t, w);
}

template <bool kShared>
__global__ void __launch_bounds__(POCA_BVH_BLOCK) bvh_winner_kernel(BvhArgs a) {
  extern __shared__ float4 smem[];
  const float4* nodes = a.nodes;
  const int4* leaves = a.leaves;
  if (kShared) {
    float4* sn = smem;
    int4* sl = reinterpret_cast<int4*>(smem + 2 * a.m);
    for (int q = threadIdx.x; q < 2 * a.m; q += blockDim.x) sn[q] = __ldg(a.nodes + q);
    for (int q = threadIdx.x; q < a.n_leaves; q += blockDim.x) sl[q] = __ldg(a.leaves + q);
    __syncthreads();
    nodes = sn;
    leaves = sl;
  }
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  for (;;) {
    int base = 0;
    if (lane == 0) base = atomicAdd(a.counter, 32);
    base = __shfl_sync(full, base, 0);
    if (base >= a.R) return;
    const int i = base + lane;
    BvhRay r{};
    float best_t = 0.0f;
    int best_i = 0, node = a.m;  // lanes past R, and walks that ended, stand at node m
    if (i < a.R) {
      r = bvh_ray(a.ox[i], a.oy[i], a.oz[i], a.dx[i], a.dy[i], a.dz[i], a.tmin[i]);
      best_t = a.tmax[i];
      node = 0;
    }
    for (;;) {
      // walk, one node per step, until POCA_BVH_PARK_MIN lanes are parked
      // at a leaf or no lane is still walking
      int leaf = -1;
      unsigned parked;
      for (;;) {
        if (leaf < 0 && node < a.m) leaf = bvh_step<kShared>(nodes, node, r, best_t);
        parked = __ballot_sync(full, leaf >= 0);
        const unsigned walking = __ballot_sync(full, leaf < 0 && node < a.m);
        if (!walking || __popc(parked) >= POCA_BVH_PARK_MIN) break;
      }
      if (!parked) break;
      int4 lf = {0, 0, 0, 0};
      if (leaf >= 0) lf = bvh_ld4i<kShared>(leaves + leaf);
      BvhBest w = bvh_best_none();
      leaf_phase<BVH_SPHERES>(a.rows, lf, lf.y, r, best_t, w);
      leaf_phase<BVH_CYLINDERS>(a.rows, lf, lf.z, r, best_t, w);
      leaf_phase<BVH_PLATFORMS>(a.rows, lf, lf.w, r, best_t, w);
      if (leaf >= 0 && w.t < best_t) {
        best_t = w.t;
        best_i = w.i;
      }
    }
    if (i < a.R) a.out[i] = best_i;
  }
}

// whether the nodes and leaf headers are staged in shared memory, and
// how many bytes they take
static bool uses_smem(int m, int n_leaves, size_t* bytes) {
  *bytes = sizeof(float4) * 2 * (size_t)m + sizeof(int4) * (size_t)n_leaves;
  return *bytes <= POCA_BVH_NODE_SMEM_MAX;
}

// The kernel for these tables, its dynamic shared memory per block and its
// grid: one wave of resident blocks.
static int launch_shape(int m, int n_leaves, void (**kern)(BvhArgs), size_t* smem, int* grid) {
  const bool shared = uses_smem(m, n_leaves, smem);
  if (!shared) *smem = 0;
  *kern = shared ? bvh_winner_kernel<true> : bvh_winner_kernel<false>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, *kern, POCA_BVH_BLOCK, *smem);
  if (e != cudaSuccess) return (int)e;
  *grid = (per_sm > 0 ? per_sm : 1) * sms;
  return 0;
}

// The kernel's registers, local bytes per thread, resident blocks per SM
// and whether it stages the nodes in shared memory, at this table size,
// into info[0..3].
extern "C" int poca_bvh_info(int m, int n_leaves, int* info) {
  void (*kern)(BvhArgs);
  size_t smem = 0;
  int grid = 0, dev = 0, sms = 0;
  const int err = launch_shape(m, n_leaves, &kern, &smem, &grid);
  if (err) return err;
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, kern);
  if (e != cudaSuccess) return (int)e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  info[0] = fa.numRegs;
  info[1] = (int)fa.localSizeBytes;
  info[2] = grid / sms;
  info[3] = smem > 0;
  return 0;
}

// Rays: 8 planes f32[R] with tmax <= INF; nodes/leaves/rows/gidx the walk's
// layout (M nodes, n_leaves leaves), 16-byte aligned; out i32[R + 1], whose
// word R is the ray counter.
extern "C" int poca_bvh_winner_index(
    const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz,
    const float* tmin, const float* tmax,
    const float* nodes, const int* leaves, const float* rows, const int* gidx,
    int* out, int R, int m, int n_leaves, cudaStream_t stream) {
  if (R <= 0) return 0;
  if (m < 1 || n_leaves < 1) return (int)cudaErrorInvalidValue;
  void (*kern)(BvhArgs);
  size_t smem = 0;
  int grid = 0;
  const int err = launch_shape(m, n_leaves, &kern, &smem, &grid);
  if (err) return err;
  const int need = (R + POCA_BVH_BLOCK - 1) / POCA_BVH_BLOCK;
  if (grid > need) grid = need;
  BvhArgs a = {ox, oy, oz, dx, dy, dz, tmin, tmax,
               reinterpret_cast<const float4*>(nodes), reinterpret_cast<const int4*>(leaves),
               {reinterpret_cast<const float4*>(rows), gidx}, out, out + R, R, m, n_leaves};
  cudaMemsetAsync(out + R, 0, sizeof(int), stream);
  kern<<<grid, POCA_BVH_BLOCK, smem, stream>>>(a);
  return (int)cudaGetLastError();
}
