// Stream compaction and its inverse for the split trace.
//
// Replaces cpppathtracer_tpu/ops/pallas/compact_kernel.py::stream_compact
// (_compact_kernel) and ::stream_expand (_expand_kernel).  The TPU version
// packed each 8192-lane chunk with a logarithmic lane-shift network and
// appended it to a global stream with 128-lane-aligned DMAs, leaving up to
// 127 "bubble" lanes per chunk.  On the GPU the pack is exact, in three
// simple passes:
//   1. count: each block counts its alive lanes with __ballot_sync/__popc;
//   2. scan: one block turns the block counts into exclusive offsets and
//      the total n_alive, left in device memory (no host sync);
//   3. scatter: each alive lane writes its payload words to
//      offset + rank, and writes its own original position into the pos
//      plane; lanes at or past n_alive get the per-plane fill values.
// stream_expand routes packed lane k < n_alive back to pos[k] and writes
// the fills at every dead original position.
//
// What bounds it on an H100: bytes.  Compaction reads the miss plane twice
// and each payload plane once and writes each packed plane once; expansion
// reads and writes each plane once.  Each pass is one coalesced sweep
// (the scattered stores of a warp land in one contiguous run), so the
// design aims at the memory rate.  The planes are 32-bit words; float
// planes travel as their bit patterns.
#include <cstdint>
#include <cuda_runtime.h>

#define POCA_CB 1024        // threads per compaction block
#define POCA_MAX_PLANES 32

struct PlaneSet {
  const int* src[POCA_MAX_PLANES];
  int fill[POCA_MAX_PLANES];
};

__device__ __forceinline__ bool lane_alive(const float* missed, int i, int R) {
  return i < R && missed[i] == 0.0f;
}

// Per-warp counts -> this thread's block-local exclusive offset.
__device__ __forceinline__ int block_rank(bool alive, int* warp_base, int* block_total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned m = __ballot_sync(0xffffffffu, alive);
  if (lane == 0) warp_base[warp] = __popc(m);
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int k = 0; k < POCA_CB / 32; ++k) {
      const int c = warp_base[k];
      warp_base[k] = run;
      run += c;
    }
    *block_total = run;
  }
  __syncthreads();
  return warp_base[warp] + __popc(m & ((1u << lane) - 1u));
}

__global__ void __launch_bounds__(POCA_CB)
compact_count_kernel(const float* missed, int R, int* block_counts) {
  __shared__ int warp_base[POCA_CB / 32];
  __shared__ int total;
  const int i = blockIdx.x * POCA_CB + threadIdx.x;
  block_rank(lane_alive(missed, i, R), warp_base, &total);
  if (threadIdx.x == 0) block_counts[blockIdx.x] = total;
}

// One block: exclusive scan of n_blocks counts (in place) and the total.
__global__ void __launch_bounds__(POCA_CB)
compact_scan_kernel(int* block_counts, int n_blocks, int* n_alive) {
  __shared__ int sums[POCA_CB];
  const int per = (n_blocks + POCA_CB - 1) / POCA_CB;
  const int lo = threadIdx.x * per;
  const int hi = min(lo + per, n_blocks);
  int s = 0;
  for (int k = lo; k < hi; ++k) s += block_counts[k];
  sums[threadIdx.x] = s;
  __syncthreads();
  // Hillis-Steele inclusive scan over the thread sums
  for (int off = 1; off < POCA_CB; off <<= 1) {
    const int v = threadIdx.x >= off ? sums[threadIdx.x - off] : 0;
    __syncthreads();
    sums[threadIdx.x] += v;
    __syncthreads();
  }
  int run = sums[threadIdx.x] - s;
  for (int k = lo; k < hi; ++k) {
    const int c = block_counts[k];
    block_counts[k] = run;
    run += c;
  }
  if (threadIdx.x == POCA_CB - 1) *n_alive = sums[POCA_CB - 1];
}

__global__ void __launch_bounds__(POCA_CB)
compact_scatter_kernel(const float* missed, PlaneSet planes, int n_planes,
                       const int* block_offs, const int* n_alive, int R,
                       int* out, int* pos) {
  __shared__ int warp_base[POCA_CB / 32];
  __shared__ int total;
  const int i = blockIdx.x * POCA_CB + threadIdx.x;
  const bool alive = lane_alive(missed, i, R);
  const int rank = block_rank(alive, warp_base, &total);
  if (alive) {
    const int dst = block_offs[blockIdx.x] + rank;
    for (int p = 0; p < n_planes; ++p) out[(size_t)p * R + dst] = planes.src[p][i];
    pos[dst] = i;
  }
  if (i < R && i >= *n_alive) {
    for (int p = 0; p < n_planes; ++p) out[(size_t)p * R + i] = planes.fill[p];
    pos[i] = -1;
  }
}

__global__ void expand_kernel(const float* missed, const int* pos, PlaneSet packed,
                              int n_planes, const int* n_alive, int R, int* out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= R) return;
  if (k < *n_alive) {
    const int dst = pos[k];
    for (int p = 0; p < n_planes; ++p) out[(size_t)p * R + dst] = packed.src[p][k];
  }
  if (missed[k] != 0.0f) {
    for (int p = 0; p < n_planes; ++p) out[(size_t)p * R + k] = packed.fill[p];
  }
}

static int fill_set(PlaneSet& s, const void* const* src, const int* fills, int n_planes) {
  if (n_planes < 0 || n_planes > POCA_MAX_PLANES) return (int)cudaErrorInvalidValue;
  for (int p = 0; p < n_planes; ++p) {
    s.src[p] = static_cast<const int*>(src[p]);
    s.fill[p] = fills[p];
  }
  return 0;
}

extern "C" int poca_compact_scratch_ints(int R) { return (R + POCA_CB - 1) / POCA_CB; }

// missed f32[R] (0 = alive); src: n_planes host pointers to 32-bit [R]
// planes; fills: n_planes host ints.  out i32[n_planes, R], pos i32[R],
// n_alive i32[1], block_counts i32[poca_compact_scratch_ints(R)].
extern "C" int poca_stream_compact(const float* missed, const void* const* src, int n_planes,
                                   const int* fills, int* out, int* pos, int* n_alive,
                                   int* block_counts, int R, cudaStream_t stream) {
  PlaneSet s;
  int e = fill_set(s, src, fills, n_planes);
  if (e) return e;
  const int nb = poca_compact_scratch_ints(R);
  if (R <= 0) {
    cudaMemsetAsync(n_alive, 0, sizeof(int), stream);
    return (int)cudaGetLastError();
  }
  compact_count_kernel<<<nb, POCA_CB, 0, stream>>>(missed, R, block_counts);
  compact_scan_kernel<<<1, POCA_CB, 0, stream>>>(block_counts, nb, n_alive);
  compact_scatter_kernel<<<nb, POCA_CB, 0, stream>>>(missed, s, n_planes, block_counts,
                                                    n_alive, R, out, pos);
  return (int)cudaGetLastError();
}

// missed f32[R] of the original domain, pos i32[R] and n_alive from
// poca_stream_compact; packed: n_planes host pointers to 32-bit [R] planes
// in the packed domain.  out i32[n_planes, R].
extern "C" int poca_stream_expand(const float* missed, const int* pos, const void* const* packed,
                                  int n_planes, const int* fills, int* out, const int* n_alive,
                                  int R, cudaStream_t stream) {
  PlaneSet s;
  int e = fill_set(s, packed, fills, n_planes);
  if (e) return e;
  if (R <= 0) return 0;
  const int block = 256;
  expand_kernel<<<(R + block - 1) / block, block, 0, stream>>>(missed, pos, s, n_planes,
                                                               n_alive, R, out);
  return (int)cudaGetLastError();
}
