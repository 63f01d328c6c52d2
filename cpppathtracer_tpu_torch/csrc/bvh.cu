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
//   memory, staged once per block, when they fit in POCA_BVH_SMEM_MAX
//   bytes beside the lane queues; else they are read through the
//   read-only cache.  Rows are 16-byte words read through the same cache,
//   a sphere in one (big_scene(16384)'s rows take 175 KB where the
//   JAX-equal rows take 512 KB), and a row's grouped index is read only
//   when the row is the leaf's best so far;
// - persistent blocks, one wave: each warp takes the next 32 lanes from a
//   counter in device memory (atomicAdd; zeroed by a memset before the
//   launch), so warps whose rays escape early take more;
// - only the lanes whose ray can still change are walked (the live set,
//   kLive, from bounce 2 of the wavefront path): a warp ballots which of
//   its 32 lanes to walk, writes the previous bounce's winner for the
//   others, and queues the walked lanes' indices in its slice of shared
//   memory (POCA_BVH_QUEUE slots); it walks 32 queued lanes at a time, and
//   what is left once the lanes run out.  So the walks run in full warps
//   where 5-30% of the lanes are live, not in warps of 32 neighbouring
//   lanes with a few of them walking.
//
// The live set's rule (csrc/wavefront.cuh's carry updates): a lane's ray
// changes at a bounce only where that bounce's recomputed hit is true.  A
// lane that died at a bounce k >= 1 missed there with tmin = TMIN_BOUNCE;
// its ray and window stay as they were, so every later walk returns the
// index it returned at bounce k, and the recompute misses again.  A lane
// that died at bounce 0 missed with tmin = 0 and can still hit at bounce 1
// and move (wavefront.cuh's exception); alive after bounce 0 is first_t <
// INF.  So at a bounce b >= 2 a lane is walked where alive || !(first_t <
// INF), and every other lane takes prev, the winner of bounce b - 1, which
// is what its walk would return, bit for bit.
//
// Besides the ray counter the kernel counts the lanes it walked (a device
// word after it), for tests and chip_smoke.py.
//
// Precondition: tmax <= INF on every ray (the wavefront path passes INF);
// the layout drops padding rows, which is exact only then (bvh.cuh).  Rays
// are bounds-checked, never padded.
#include <cuda_runtime.h>

#include "bvh.cuh"

#define POCA_BVH_BLOCK 256
#define POCA_BVH_PARK_MIN 32
// a warp's queue of lanes to walk: under 32 left over plus a chunk of 32
#define POCA_BVH_QUEUE 64
#define POCA_BVH_QUEUE_BYTES (POCA_BVH_BLOCK / 32 * POCA_BVH_QUEUE * 4)
// a block's shared memory without an opt-in: the lane queues, and the nodes
// and leaf headers where they fit (M = 511 nodes and 256 leaves take 20 KB)
#define POCA_BVH_SMEM_MAX (48 * 1024)

struct BvhArgs {
  const float *ox, *oy, *oz, *dx, *dy, *dz, *tmin, *tmax;
  const float4* nodes;  // the walk's layout
  const int4* leaves;
  BvhRows rows;
  // the live set (kLive): alive and first_t as the bounce before left them,
  // prev that bounce's winners
  const bool* alive;
  const float* first_t;
  const int* prev;
  int* out;
  int* counter;  // out + R
  int* walked;   // out + R + 1
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

// The whole warp walks the rays of its lanes with i >= 0 in lock-step and
// writes out[i]; a lane with i < 0 stands at node m (its walk has ended).
template <bool kShared>
__device__ __forceinline__ void walk_warp(const BvhArgs& a, const float4* nodes,
                                          const int4* leaves, int i) {
  const unsigned full = 0xffffffffu;
  BvhRay r{};
  float best_t = 0.0f;
  int best_i = 0, node = a.m;
  if (i >= 0) {
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
  if (i >= 0) a.out[i] = best_i;
}

// The lane's index in its warp, and the mask of the lanes below it, read from
// their special registers where needed: ptxas holds the kernel to 40
// registers, and a lane index kept live across a walk spilled.
__device__ __forceinline__ int lane_id() {
  int v;
  asm volatile("mov.u32 %0, %%laneid;" : "=r"(v));
  return v;
}

__device__ __forceinline__ unsigned lanes_below() {
  unsigned v;
  asm volatile("mov.u32 %0, %%lanemask_lt;" : "=r"(v));
  return v;
}

template <bool kShared, bool kLive>
__global__ void __launch_bounds__(POCA_BVH_BLOCK) bvh_winner_kernel(BvhArgs a) {
  extern __shared__ float4 smem[];
  const float4* nodes = a.nodes;
  const int4* leaves = a.leaves;
  int* queue = reinterpret_cast<int*>(smem) + (threadIdx.x >> 5) * POCA_BVH_QUEUE;
  if (kShared) {
    float4* sn = smem + POCA_BVH_QUEUE_BYTES / 16;
    int4* sl = reinterpret_cast<int4*>(sn + 2 * a.m);
    for (int q = threadIdx.x; q < 2 * a.m; q += blockDim.x) sn[q] = __ldg(a.nodes + q);
    for (int q = threadIdx.x; q < a.n_leaves; q += blockDim.x) sl[q] = __ldg(a.leaves + q);
    __syncthreads();
    nodes = sn;
    leaves = sl;
  }
  const unsigned full = 0xffffffffu;
  int queued = 0, walked = 0;  // the same on every lane of the warp
  for (;;) {
    int base = 0;
    if (lane_id() == 0) base = atomicAdd(a.counter, 32);
    base = __shfl_sync(full, base, 0);
    const bool done = base >= a.R;
    if (!done) {
      // queue the lanes of this chunk that are walked; the others take prev
      const int i = base + lane_id();
      bool walk = i < a.R;
      if (kLive && walk) {
        walk = a.alive[i] || !(a.first_t[i] < POCA_INF);
        if (!walk) a.out[i] = a.prev[i];
      }
      const unsigned take = __ballot_sync(full, walk);
      if (walk) queue[queued + __popc(take & lanes_below())] = i;
      queued += __popc(take);
      walked += __popc(take);
      __syncwarp();
    }
    // walk 32 queued lanes at a time, and the rest once the lanes run out
    while (queued >= 32 || (done && queued > 0)) {
      const int lane = lane_id();
      const int i = lane < queued ? queue[lane] : -1;
      __syncwarp();
      if (lane + 32 < queued) queue[lane] = queue[lane + 32];
      queued = queued > 32 ? queued - 32 : 0;
      __syncwarp();
      walk_warp<kShared>(a, nodes, leaves, i);
    }
    if (done) break;
  }
  if (lane_id() == 0 && walked) atomicAdd(a.walked, walked);
}

// whether the nodes and leaf headers are staged in shared memory, and the
// block's bytes of it (the lane queues first)
static bool uses_smem(int m, int n_leaves, size_t* bytes) {
  const size_t tables = sizeof(float4) * 2 * (size_t)m + sizeof(int4) * (size_t)n_leaves;
  const bool shared = POCA_BVH_QUEUE_BYTES + tables <= POCA_BVH_SMEM_MAX;
  *bytes = POCA_BVH_QUEUE_BYTES + (shared ? tables : 0);
  return shared;
}

typedef void (*BvhKernel)(BvhArgs);

// The kernel for these tables and this launch (with a live set or not),
// its dynamic shared memory per block and its grid: one wave of resident
// blocks.
static int launch_shape(int m, int n_leaves, bool live, BvhKernel* kern, size_t* smem,
                        int* grid, bool* shared) {
  *shared = uses_smem(m, n_leaves, smem);
  *kern = *shared ? (live ? bvh_winner_kernel<true, true> : bvh_winner_kernel<true, false>)
                  : (live ? bvh_winner_kernel<false, true> : bvh_winner_kernel<false, false>);
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
// with a live set (live != 0) or not, into info[0..3].
extern "C" int poca_bvh_info(int m, int n_leaves, int live, int* info) {
  BvhKernel kern;
  size_t smem = 0;
  int grid = 0, dev = 0, sms = 0;
  bool shared = false;
  const int err = launch_shape(m, n_leaves, live != 0, &kern, &smem, &grid, &shared);
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
  info[3] = shared;
  return 0;
}

// Rays: 8 planes f32[R] with tmax <= INF; nodes/leaves/rows/gidx the walk's
// layout (M nodes, n_leaves leaves), 16-byte aligned; the live set alive
// bool[R], first_t f32[R], prev i32[R], or three nulls to walk every lane;
// out i32[R + 2], whose word R is the ray counter and word R + 1 the count
// of lanes walked.
extern "C" int poca_bvh_winner_index(
    const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz,
    const float* tmin, const float* tmax,
    const float* nodes, const int* leaves, const float* rows, const int* gidx,
    const bool* alive, const float* first_t, const int* prev,
    int* out, int R, int m, int n_leaves, cudaStream_t stream) {
  if (R <= 0) return 0;
  if (m < 1 || n_leaves < 1) return (int)cudaErrorInvalidValue;
  const bool live = alive != nullptr;
  if (live && (first_t == nullptr || prev == nullptr)) return (int)cudaErrorInvalidValue;
  BvhKernel kern;
  size_t smem = 0;
  int grid = 0;
  bool shared = false;
  const int err = launch_shape(m, n_leaves, live, &kern, &smem, &grid, &shared);
  if (err) return err;
  const int need = (R + POCA_BVH_BLOCK - 1) / POCA_BVH_BLOCK;
  if (grid > need) grid = need;
  BvhArgs a = {ox, oy, oz, dx, dy, dz, tmin, tmax,
               reinterpret_cast<const float4*>(nodes), reinterpret_cast<const int4*>(leaves),
               {reinterpret_cast<const float4*>(rows), gidx}, alive, first_t, prev,
               out, out + R, out + R + 1, R, m, n_leaves};
  cudaMemsetAsync(out + R, 0, 2 * sizeof(int), stream);
  kern<<<grid, POCA_BVH_BLOCK, smem, stream>>>(a);
  return (int)cudaGetLastError();
}
