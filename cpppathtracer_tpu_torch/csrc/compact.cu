// Stream compaction and its inverse for the split trace.
//
// Replaces cpppathtracer_tpu/ops/pallas/compact_kernel.py::stream_compact
// (_compact_kernel) and ::stream_expand (_expand_kernel).  The TPU version
// packed each 8192-lane chunk with a logarithmic lane-shift network and
// appended it to a global stream with 128-lane-aligned DMAs, leaving up to
// 127 "bubble" lanes per chunk; expansion read each chunk's segment back at
// the offset the compaction recorded.  Here the pack is exact (no bubbles)
// and both directions work on blocks of POCA_CB = 1024 lanes, four lanes a
// thread:
//
// stream_compact, one launch, one pass over the data:
//   - each block takes an ordered ticket (atomicAdd), so every block with a
//     smaller ticket is already resident, and works on the ticket's lanes;
//   - it reads the miss plane once as float4, counts its alive lanes with
//     __ballot_sync/__popc and ranks them with a warp-shuffle scan over the
//     eight warp counts;
//   - it finds the alive lanes before it by decoupled look-back (Merrill &
//     Garland, "Single-pass Parallel Prefix Scan with Decoupled Look-back",
//     NVIDIA 2016): it publishes its count, then its inclusive prefix, in a
//     status word per block, and warp 0 sums the predecessors' words 32 at a
//     time back to the nearest published prefix.  The status words and the
//     ticket are zeroed by a cudaMemsetAsync before the launch;
//   - it loads the alive lanes' payload words (16 bytes a thread, skipped
//     where none of a thread's four lanes is alive), stages them plane by
//     plane in shared memory at their ranks and writes each plane's run of
//     up to 1024 words contiguously;
//   - it writes offs[b], its exclusive offset, and the last block n_alive.
//   Nothing is written past n_alive: that tail is unspecified, as the
//   Pallas kernel's is.
//
// stream_expand, one launch, gather form: each block recomputes its lanes'
// ranks from the miss plane, reads offs[b], and each alive lane takes
// packed[offs[b] + rank]; a dead lane takes the fill.  Every output word is
// written once, by its own lane, 16 bytes a thread.  It reads neither
// n_alive nor any packed lane past it.
//
// What bounds both on an H100: bytes.  Compaction needs the miss plane and
// the alive lanes' payload words read and the packed words written;
// expansion the miss plane and the packed words read and every output word
// written.  The design moves each of those once, in coalesced runs, with no
// second pass over the miss plane and no fills past n_alive.  The planes are
// 32-bit words; float planes travel as their bit patterns.
#include <cstdint>
#include <cuda_runtime.h>

#define POCA_CB 1024           // lanes per block (B)
#define POCA_CT 256            // threads per block, four lanes each
#define POCA_WARPS (POCA_CT / 32)
#define POCA_MAX_PLANES 32
#define POCA_GROUP 4           // planes whose loads are in flight together
// look-back status word: (count << 2) | flag; 0 = nothing published yet
#define POCA_ST_AGG 1u         // the block's own count
#define POCA_ST_PRE 2u         // the inclusive prefix up to and with the block

struct PlaneSet {
  const int* src[POCA_MAX_PLANES];
  int fill[POCA_MAX_PLANES];
};

// Bit j set: lane i0 + j is alive (missed == 0).  `full`: the block's lanes
// are all < R and the plane is 16-byte aligned.
__device__ __forceinline__ unsigned alive_bits(const float* missed, int i0, int R, bool full) {
  if (full) {
    const float4 m = __ldg(reinterpret_cast<const float4*>(missed + i0));
    return (unsigned)(m.x == 0.0f) | (unsigned)(m.y == 0.0f) << 1 |
           (unsigned)(m.z == 0.0f) << 2 | (unsigned)(m.w == 0.0f) << 3;
  }
  unsigned bits = 0;
  for (int j = 0; j < 4; ++j)
    if (i0 + j < R && __ldg(missed + i0 + j) == 0.0f) bits |= 1u << j;
  return bits;
}

// The alive lanes of the block before this thread's lanes; the block's
// count in *total.  Ballots within a warp, a shuffle scan across warps.
__device__ __forceinline__ int block_rank(unsigned bits, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  int in_warp = 0, warp_count = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned m = __ballot_sync(0xffffffffu, (bits >> j) & 1u);
    in_warp += __popc(m & below);
    warp_count += __popc(m);
  }
  if (lane == 0) warp_sums[warp] = warp_count;
  __syncthreads();
  if (warp == 0) {
    const int own = lane < POCA_WARPS ? warp_sums[lane] : 0;
    int v = own;
#pragma unroll
    for (int off = 1; off < POCA_WARPS; off <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    if (lane < POCA_WARPS) warp_sums[lane] = v - own;
    if (lane == POCA_WARPS - 1) *total = v;
  }
  __syncthreads();
  return warp_sums[warp] + in_warp;
}

// Four consecutive words of a plane at i0, where `bits` says they are needed.
__device__ __forceinline__ int4 load4(const int* p, int i0, bool full, unsigned bits) {
  if (full) return __ldg(reinterpret_cast<const int4*>(p + i0));
  int4 v = make_int4(0, 0, 0, 0);
  if (bits & 1u) v.x = __ldg(p + i0);
  if (bits & 2u) v.y = __ldg(p + i0 + 1);
  if (bits & 4u) v.z = __ldg(p + i0 + 2);
  if (bits & 8u) v.w = __ldg(p + i0 + 3);
  return v;
}

__device__ __forceinline__ unsigned ld_status(const unsigned* s) {
  return *reinterpret_cast<const volatile unsigned*>(s);
}

__device__ __forceinline__ void st_status(unsigned* s, unsigned v) {
  *reinterpret_cast<volatile unsigned*>(s) = v;
}

// Warp 0 of block b > 0: the alive lanes of blocks [0, b), from the status
// words of its predecessors, 32 at a time back to the nearest inclusive
// prefix.  A predecessor with nothing published yet is read again.
__device__ __forceinline__ int look_back(const unsigned* status, int b) {
  const int lane = threadIdx.x;
  int before = 0;
  for (int j = b - 1 - lane;; j -= 32) {
    unsigned w;
    do {
      w = j >= 0 ? ld_status(status + j) : POCA_ST_PRE;  // before block 0: prefix 0
    } while (__any_sync(0xffffffffu, (w & 3u) == 0u));
    const unsigned pre = __ballot_sync(0xffffffffu, (w & 3u) == POCA_ST_PRE);
    int v = (int)(w >> 2);
    if (pre) {
      // lanes 0 .. k-1 hold counts, lane k the nearest prefix
      if (lane > __ffs(pre) - 1) v = 0;
      return before + __reduce_add_sync(0xffffffffu, v);
    }
    before += __reduce_add_sync(0xffffffffu, v);
  }
}

__global__ void __launch_bounds__(POCA_CT)
compact_kernel(const float* __restrict__ missed, PlaneSet planes, int n_planes, int R,
               bool aligned, int n_blocks, int* __restrict__ out, int stride,
               int* __restrict__ offs, int* __restrict__ n_alive, unsigned* status) {
  __shared__ int stage[2][POCA_CB];
  __shared__ int warp_sums[POCA_WARPS];
  __shared__ int ticket, count, base;
  if (threadIdx.x == 0) ticket = (int)atomicAdd(status + n_blocks, 1u);
  __syncthreads();
  const int b = ticket;
  const int i0 = b * POCA_CB + 4 * threadIdx.x;
  const bool full = aligned && (b + 1) * POCA_CB <= R;
  const unsigned bits = alive_bits(missed, i0, R, full);
  const int rank0 = block_rank(bits, warp_sums, &count);
  const int n = count;
  if (threadIdx.x == 0)
    st_status(status + b, (unsigned)n << 2 | (b == 0 ? POCA_ST_PRE : POCA_ST_AGG));

  // the first planes' loads are in flight during the look-back
  int4 cur[POCA_GROUP];
#pragma unroll
  for (int q = 0; q < POCA_GROUP; ++q)
    cur[q] = q < n_planes && bits ? load4(planes.src[q], i0, full, bits) : make_int4(0, 0, 0, 0);

  if (threadIdx.x < 32) {
    const int before = b == 0 ? 0 : look_back(status, b);
    if (threadIdx.x == 0) {
      if (b > 0) st_status(status + b, (unsigned)(before + n) << 2 | POCA_ST_PRE);
      base = before;
      offs[b] = before;
      if (b == n_blocks - 1) *n_alive = before + n;
    }
  }
  __syncthreads();
  const int off = base;

  for (int g = 0; g < n_planes; g += POCA_GROUP) {
    int4 nxt[POCA_GROUP];
#pragma unroll
    for (int q = 0; q < POCA_GROUP; ++q) {
      const int p = g + POCA_GROUP + q;
      nxt[q] = p < n_planes && bits ? load4(planes.src[p], i0, full, bits) : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int q = 0; q < POCA_GROUP; ++q) {
      const int p = g + q;
      if (p >= n_planes) break;
      // stage[p & 1] was last read before the previous plane's barrier
      int* buf = stage[p & 1];
      int k = rank0;
      if (bits & 1u) buf[k++] = cur[q].x;
      if (bits & 2u) buf[k++] = cur[q].y;
      if (bits & 4u) buf[k++] = cur[q].z;
      if (bits & 8u) buf[k] = cur[q].w;
      __syncthreads();
      int* dst = out + (size_t)p * stride + off;
      for (int t = threadIdx.x; t < n; t += POCA_CT) dst[t] = buf[t];
    }
#pragma unroll
    for (int q = 0; q < POCA_GROUP; ++q) cur[q] = nxt[q];
  }
}

__global__ void __launch_bounds__(POCA_CT)
expand_kernel(const float* __restrict__ missed, const int* __restrict__ offs, PlaneSet packed,
              int n_planes, int R, bool aligned, int* __restrict__ out, int stride) {
  __shared__ int warp_sums[POCA_WARPS];
  __shared__ int count;
  const int b = blockIdx.x;
  const int i0 = b * POCA_CB + 4 * threadIdx.x;
  const unsigned bits = alive_bits(missed, i0, R, aligned && (b + 1) * POCA_CB <= R);
  const int k0 = block_rank(bits, warp_sums, &count) + __ldg(offs + b);
  if (i0 >= R) return;
  const int k1 = k0 + (int)(bits & 1u);
  const int k2 = k1 + (int)((bits >> 1) & 1u);
  const int k3 = k2 + (int)((bits >> 2) & 1u);
  for (int g = 0; g < n_planes; g += POCA_GROUP) {
    int4 v[POCA_GROUP];
#pragma unroll
    for (int q = 0; q < POCA_GROUP; ++q) {
      const int p = g + q;
      if (p < n_planes) {
        const int* s = packed.src[p];
        const int f = packed.fill[p];
        v[q].x = bits & 1u ? __ldg(s + k0) : f;
        v[q].y = bits & 2u ? __ldg(s + k1) : f;
        v[q].z = bits & 4u ? __ldg(s + k2) : f;
        v[q].w = bits & 8u ? __ldg(s + k3) : f;
      }
    }
    // rows are padded to a multiple of four words: the last thread's store
    // stays inside its row
#pragma unroll
    for (int q = 0; q < POCA_GROUP; ++q)
      if (g + q < n_planes)
        *reinterpret_cast<int4*>(out + (size_t)(g + q) * stride + i0) = v[q];
  }
}

static bool set_planes(PlaneSet& s, const void* const* src, const int* fills, int n_planes) {
  if (n_planes < 1 || n_planes > POCA_MAX_PLANES) return false;
  bool aligned = true;
  for (int p = 0; p < n_planes; ++p) {
    s.src[p] = static_cast<const int*>(src[p]);
    s.fill[p] = fills ? fills[p] : 0;
    aligned = aligned && (reinterpret_cast<uintptr_t>(src[p]) & 15u) == 0;
  }
  return aligned;
}

static int n_blocks_of(int R) { return (R + POCA_CB - 1) / POCA_CB; }

static bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// B, the lanes of one block: offs has one entry per block of B lanes.
extern "C" int poca_compact_block_lanes() { return POCA_CB; }

// missed f32[R] (0 = alive); src: n_planes host pointers to 32-bit [R]
// planes.  out i32[n_planes, stride] (stride >= R), offs i32[ceil(R / B)],
// n_alive i32[1], status: ceil(R / B) + 1 words of scratch.
extern "C" int poca_stream_compact(const float* missed, const void* const* src, int n_planes,
                                   int* out, int stride, int* offs, int* n_alive,
                                   unsigned* status, int R, cudaStream_t stream) {
  PlaneSet s;
  if (n_planes < 1 || n_planes > POCA_MAX_PLANES || R < 0 || stride < R)
    return (int)cudaErrorInvalidValue;
  const bool aligned = set_planes(s, src, nullptr, n_planes) && aligned16(missed);
  const int nb = n_blocks_of(R);
  if (nb == 0) {
    cudaMemsetAsync(n_alive, 0, sizeof(int), stream);
    return (int)cudaGetLastError();
  }
  cudaMemsetAsync(status, 0, sizeof(unsigned) * (nb + 1), stream);
  compact_kernel<<<nb, POCA_CT, 0, stream>>>(missed, s, n_planes, R, aligned, nb, out, stride,
                                             offs, n_alive, status);
  return (int)cudaGetLastError();
}

// missed f32[R] of the original domain and offs from poca_stream_compact;
// packed: n_planes host pointers to 32-bit planes of the packed domain,
// read below n_alive only; fills: n_planes host ints.  out i32[n_planes,
// stride], stride a multiple of 4 >= R, 16-byte aligned.
extern "C" int poca_stream_expand(const float* missed, const int* offs, const void* const* packed,
                                  int n_planes, const int* fills, int* out, int stride, int R,
                                  cudaStream_t stream) {
  PlaneSet s;
  if (n_planes < 1 || n_planes > POCA_MAX_PLANES || R < 0 || stride < R || stride % 4 ||
      !aligned16(out))
    return (int)cudaErrorInvalidValue;
  set_planes(s, packed, fills, n_planes);
  const int nb = n_blocks_of(R);
  if (nb == 0) return 0;
  expand_kernel<<<nb, POCA_CT, 0, stream>>>(missed, offs, s, n_planes, R, aligned16(missed), out,
                                            stride);
  return (int)cudaGetLastError();
}
