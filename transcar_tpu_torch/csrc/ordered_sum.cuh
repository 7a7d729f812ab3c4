// Float32 sums whose order does not depend on how the blocks are
// scheduled, so that a kernel gives the same bits run after run, as the
// TPU kernels do: their grid runs in sequence and carries each sum from
// one step to the next in a fixed order.
//
// Two tools, shared by K3 (dcn_backward.cu), K4 / K5 (osa_wgmma.cuh,
// conv_tile.cuh) and K9 (msdeform_backward.cu):
//
// - arrive(): the groups that each wrote one partial of a sum take a
//   ticket; the group that takes the last one sums the partials in their
//   index order (sum_strided()) and writes the result.  A partial is
//   written once, never added into, so no float atomic is left.  This is
//   the cross-block reduction of K4 / K5's eSE channel sums (partials a
//   pixel tile) and of K3's d_W (partials a pixel split).
// - gather_sum(): a scatter of weighted rows to places that depend on the
//   data (K3's d_x: the bilinear corners of deformed taps; K9's d_value:
//   the corners of the sampling locations), turned into a gather by
//   target, the idea of the JAX K9 kernel made exact for any offset.  A
//   producer kernel lists every source s, its target cell cell[s] (-1 for
//   none) and its weight coef[s], and takes a slot in its cell by counting
//   it; then (1) an exclusive scan of the counts gives each cell's
//   segment (and zeroes the counts again), (2) every source is filed at
//   its slot of its cell's segment, (3) each segment is put in source
//   order, and (4) each cell sums coef[s] * V[s / per_row, :] over its
//   segment in that order and writes its row of the output once: no zero
//   fill and no float atomics.
//
// The only atomics are on integers: the tickets and the counts, whose
// results do not depend on the order in which the threads arrive (the
// last ticket is the count-th whatever the order; a count is a count,
// and the slot a source's count hands it decides only where in its
// segment it is filed, which step (3) then undoes by sorting on the
// source's id).
//
// What bounds the gather: it reads each source's V row once from the
// cell that takes it, so its traffic is that of the scatter it replaces,
// but as plain loads into registers and one store a cell instead of L2
// read-modify-writes; the lists move 12 to 24 bytes a source.  A segment
// of up to kWarpRank sources is ordered by one warp, by ranks (L^2 / 32
// warp steps: about 36 sources for K3); a longer one (the coarse levels
// of K9's encoder call take ~340 and ~1360 a cell) by one block, a
// bitonic sort in shared memory up to kBlockSort sources, by ranks past
// that (only a degenerate input, all taps on one pixel, gets there: it
// stays correct, only slower).
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace ordered {

// ---------------------------------------------------------------------------
// Last-arrival reduction.

// Every thread of an arriving group calls this after writing its part of a
// sum; returns true in the group that arrives last, which may then read
// every part (past L1).  `ticket` is zero before the first arrival of a
// launch and zero again after the last (this resets it), so consecutive
// launches on one stream share it without a memset.  `leader`: one thread
// of the group; `flag`: one int of shared memory; `sync`: the group's
// barrier.  As a grid barrier does, the leader alone fences, after the
// group's barrier: the fence is cumulative over the writes the barrier
// ordered before it, so the other threads' stores (their output tiles
// too) need not drain.
template <typename Sync>
__device__ __forceinline__ bool arrive(unsigned* ticket, unsigned count, bool leader,
                                       int* flag, Sync sync) {
  sync();
  if (leader) {
    __threadfence();                             // the group's parts, device-wide
    // an integer count: the last arrival is the count-th whatever the order
    const unsigned got = atomicAdd(ticket, 1u);
    const int last = got == count - 1;
    if (last) {
      atomicExch(ticket, 0u);
      __threadfence();                           // every part before the reads
    }
    *flag = last;
  }
  sync();
  return *flag != 0;
}

// sum_{i < n} p[i * stride] in one fixed order (eight running sums by
// i % 8, then a fixed tree of them), read past L1: the parts were written
// by other blocks.  Eight independent loads in flight: the block that
// sums a column does it while the others have finished, so its latency
// is the launch's tail.
__device__ __forceinline__ float sum_strided(const float* p, int n, size_t stride) {
  float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int i = 0;
  for (; i + 8 <= n; i += 8) {
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = __ldcg(p + static_cast<size_t>(i + k) * stride);
#pragma unroll
    for (int k = 0; k < 8; ++k) s[k] += v[k];
  }
  for (; i < n; ++i) s[0] += __ldcg(p + static_cast<size_t>(i) * stride);
  return ((s[0] + s[1]) + (s[2] + s[3])) + ((s[4] + s[5]) + (s[6] + s[7]));
}

// The same over float4 parts (16-byte aligned).
__device__ __forceinline__ float4 sum_strided4(const float* p, int n, size_t stride) {
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = 0; i < n; ++i) {
    const float4 v = __ldcg(reinterpret_cast<const float4*>(p + static_cast<size_t>(i) * stride));
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  return s;
}

// ---------------------------------------------------------------------------
// Gather by target.

constexpr int kScanThreads = 256;
constexpr int kScanItems = 16;                       // counts a thread
constexpr int kChunk = kScanThreads * kScanItems;    // counts a scan block
constexpr int kWarpRank = 256;     // longest segment a warp orders by ranks
constexpr int kBlockSort = 4096;   // longest a block sorts in shared memory
constexpr int kSortThreads = 512;

// The device buffers of one gather over E sources and `cells` cells.
struct Gather {
  int* cell;                    // [E] a source's target cell, -1: none
  float* coef;                  // [E] its weight
  int* slot;                    // [E] its place in the cell's segment
  unsigned long long* keys;     // [E] (source << 32 | coef bits), filed
  unsigned long long* sorted;   // [E] the same in source order per segment
  int* start;                   // [cells + 1] segment starts
  int* chunk;                   // [chunks] counts a scan block
  int* longs;                   // [cells + 1] count, then the long segments
  unsigned* counts;             // [cells] zero before the producer and after
  long long E;
  int cells;
};

inline size_t align256(size_t n) { return (n + 255) & ~size_t(255); }

inline int chunks(int cells) { return (cells + kChunk - 1) / kChunk; }

// Bytes of workspace a gather needs (the counts excepted: they live in
// the caller's zeroed scratch).
inline size_t workspace_bytes(long long E, int cells) {
  return 3 * align256(E * sizeof(int)) +
         2 * align256(E * sizeof(unsigned long long)) +
         2 * align256((static_cast<size_t>(cells) + 1) * sizeof(int)) +
         align256(static_cast<size_t>(chunks(cells)) * sizeof(int));
}

// The gather's buffers carved out of `work` (workspace_bytes() long);
// returns the first byte past them through `end`.
inline Gather carve(void* work, long long E, int cells, unsigned* counts,
                    unsigned char** end) {
  unsigned char* b = static_cast<unsigned char*>(work);
  Gather g{};
  g.cell = reinterpret_cast<int*>(b);
  b += align256(E * sizeof(int));
  g.coef = reinterpret_cast<float*>(b);
  b += align256(E * sizeof(float));
  g.slot = reinterpret_cast<int*>(b);
  b += align256(E * sizeof(int));
  g.keys = reinterpret_cast<unsigned long long*>(b);
  b += align256(E * sizeof(unsigned long long));
  g.sorted = reinterpret_cast<unsigned long long*>(b);
  b += align256(E * sizeof(unsigned long long));
  g.start = reinterpret_cast<int*>(b);
  b += align256((static_cast<size_t>(cells) + 1) * sizeof(int));
  g.chunk = reinterpret_cast<int*>(b);
  b += align256(static_cast<size_t>(chunks(cells)) * sizeof(int));
  g.longs = reinterpret_cast<int*>(b);
  b += align256((static_cast<size_t>(cells) + 1) * sizeof(int));
  g.counts = counts;
  g.E = E;
  g.cells = cells;
  if (end != nullptr) *end = b;
  return g;
}

// A producer's entry for source s: its cell (-1: none) and weight, and
// one more source counted for the cell, whose count before it is the
// source's slot (an integer count: the slots of a cell are 0 .. n - 1
// whatever order the threads take them in).
__device__ __forceinline__ void list_source(const Gather& g, long long s, int cell,
                                            float coef) {
  g.cell[s] = cell;
  g.coef[s] = coef;
  if (cell >= 0) g.slot[s] = static_cast<int>(atomicAdd(g.counts + cell, 1u));
}

namespace {

__device__ __forceinline__ int block_sum(int v, int* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
  for (int w = 0; w < kScanThreads / 32; ++w) s += red[w];
  return s;
}

// (1a) the counts of each scan block
__global__ void __launch_bounds__(kScanThreads) scan_chunks_kernel(Gather g) {
  __shared__ int red[kScanThreads / 32];
  const int base = blockIdx.x * kChunk;
  int s = 0;
  for (int i = threadIdx.x; i < kChunk; i += kScanThreads)
    if (base + i < g.cells) s += static_cast<int>(g.counts[base + i]);
  s = block_sum(s, red);
  if (threadIdx.x == 0) g.chunk[blockIdx.x] = s;
}

// (1b) start[c] = the counts before c: the blocks before this one, then an
// exclusive scan inside it (kScanItems a thread, then across the threads);
// the counts are zeroed for the next launch, and so is the long list
__global__ void __launch_bounds__(kScanThreads) scan_apply_kernel(Gather g) {
  __shared__ int red[kScanThreads / 32];
  __shared__ int warp_tot[kScanThreads / 32];
  int before = 0;
  for (int b = threadIdx.x; b < static_cast<int>(blockIdx.x); b += kScanThreads)
    before += g.chunk[b];
  before = block_sum(before, red);
  const int base = blockIdx.x * kChunk + threadIdx.x * kScanItems;
  int v[kScanItems];
  int mine = 0;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    v[i] = base + i < g.cells ? static_cast<int>(g.counts[base + i]) : 0;
    if (base + i < g.cells) g.counts[base + i] = 0u;
    mine += v[i];
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) g.longs[0] = 0;
  // inclusive scan of `mine` over the block
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += t;
  }
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  int off = before;
  for (int w = 0; w < warp; ++w) off += warp_tot[w];
  int run = off + inc - mine;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    if (base + i < g.cells) g.start[base + i] = run;
    run += v[i];
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == kScanThreads - 1)
    g.start[g.cells] = run;                        // the total
}

// (2) file each source at its slot of its cell's segment
__global__ void __launch_bounds__(256) fill_kernel(Gather g) {
  const long long s = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (s >= g.E) return;
  const int c = g.cell[s];
  if (c < 0) return;
  const int pos = g.start[c] + g.slot[s];
  g.keys[pos] = (static_cast<unsigned long long>(s) << 32) |
                __float_as_uint(g.coef[s]);
}

// (3a) a warp per cell: each key goes to its rank by source id (ids are
// distinct, so the ranks are a permutation of the segment); the ids of 32
// keys at a time are read coalesced and handed round by shuffles.  A
// segment longer than kWarpRank goes on the long list for (3b).
__global__ void __launch_bounds__(256) rank_kernel(Gather g) {
  const long long w = (static_cast<long long>(blockIdx.x) * 256 + threadIdx.x) >> 5;
  if (w >= g.cells) return;                        // whole warps leave together
  const int lane = threadIdx.x & 31;
  const int a = g.start[w], n = g.start[w + 1] - a;
  if (n > kWarpRank) {
    // an integer count: the list's order is not the segments' order,
    // and each segment is sorted on its own
    if (lane == 0) g.longs[1 + atomicAdd(g.longs, 1)] = static_cast<int>(w);
    return;
  }
  const unsigned long long* k = g.keys + a;
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int i = i0 + lane;
    const unsigned long long mine = i < n ? k[i] : ~0ull;
    const unsigned id = static_cast<unsigned>(mine >> 32);
    int rank = 0;
    for (int c0 = 0; c0 < n; c0 += 32) {
      const unsigned other =
          c0 == i0 ? id : (c0 + lane < n ? static_cast<unsigned>(k[c0 + lane] >> 32) : 0u);
      const int m = min(32, n - c0);
      for (int j = 0; j < m; ++j) rank += __shfl_sync(0xffffffffu, other, j) < id;
    }
    if (i < n) g.sorted[a + rank] = mine;
  }
}

// (3b) a block per long segment, the blocks walking the long list: a
// bitonic sort of the segment's keys in shared memory (the source id in
// the high bits, distinct, so the keys sort as the ids do), or ranks by
// comparison past kBlockSort
__global__ void __launch_bounds__(kSortThreads) sort_long_kernel(Gather g) {
  __shared__ unsigned long long s[kBlockSort];
  const int count = g.longs[0];
  for (int li = blockIdx.x; li < count; li += gridDim.x) {
    const int c = g.longs[1 + li];
    const int a = g.start[c], n = g.start[c + 1] - a;
    const unsigned long long* k = g.keys + a;
    if (n <= kBlockSort) {
      int n2 = 1;
      while (n2 < n) n2 <<= 1;
      for (int e = threadIdx.x; e < n2; e += kSortThreads) s[e] = e < n ? k[e] : ~0ull;
      __syncthreads();
      for (int size = 2; size <= n2; size <<= 1) {
        for (int j = size >> 1; j > 0; j >>= 1) {
          for (int e = threadIdx.x; e < n2; e += kSortThreads) {
            const int q = e ^ j;
            if (q > e) {
              const unsigned long long x = s[e], y = s[q];
              if ((x > y) == ((e & size) == 0)) {
                s[e] = y;
                s[q] = x;
              }
            }
          }
          __syncthreads();
        }
      }
      for (int e = threadIdx.x; e < n; e += kSortThreads) g.sorted[a + e] = s[e];
      __syncthreads();                           // s is read before the next
    } else {
      for (int e = threadIdx.x; e < n; e += kSortThreads) {
        const unsigned long long mine = k[e];
        int rank = 0;
        for (int j = 0; j < n; ++j) rank += k[j] < mine;
        g.sorted[a + rank] = mine;
      }
    }
  }
}

// (4) out[c, ch] = sum over c's segment, in source order, of
// coef * V[source / per_row, ch]; a thread per (cell, VW channels).  The
// keys and rows of kAhead entries are loaded before their products are
// added, in order, so that kAhead row loads are in flight at a time.
constexpr int kAhead = 8;

template <int VW>
__global__ void __launch_bounds__(256)
sum_kernel(Gather g, const float* __restrict__ V, int C, int per_row,
           float* __restrict__ out, int groups) {
  const long long t = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (t >= static_cast<long long>(g.cells) * groups) return;
  const int c = static_cast<int>(t / groups);
  const int ch = static_cast<int>(t - static_cast<long long>(c) * groups) * VW;
  const int a = g.start[c], b = g.start[c + 1];
  float acc[VW];
#pragma unroll
  for (int e = 0; e < VW; ++e) acc[e] = 0.f;
  for (int i0 = a; i0 < b; i0 += kAhead) {
    unsigned long long key[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) key[u] = i0 + u < b ? g.sorted[i0 + u] : 0ull;
    float x[kAhead][VW];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const float* v = V + static_cast<long long>(key[u] >> 32) / per_row * C + ch;
      if constexpr (VW == 4) {
        const float4 f = i0 + u < b ? __ldg(reinterpret_cast<const float4*>(v))
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
        x[u][0] = f.x;
        x[u][1] = f.y;
        x[u][2] = f.z;
        x[u][3] = f.w;
      } else {
        x[u][0] = i0 + u < b ? __ldg(v) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (i0 + u >= b) break;
      const float w = __uint_as_float(static_cast<unsigned>(key[u]));
#pragma unroll
      for (int e = 0; e < VW; ++e) acc[e] = fmaf(w, x[u][e], acc[e]);
    }
  }
  float* o = out + static_cast<long long>(c) * C + ch;
  if constexpr (VW == 4)
    *reinterpret_cast<float4*>(o) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  else
    *o = acc[0];
}

}  // namespace

// Steps (1)-(4) after a producer has listed every source (list_source()):
// out [cells, C] float32 = the ordered sums of coef * V[s / per_row, :],
// V [E / per_row, C] float32.  Six launches on `stream`; returns a
// cudaError_t.
inline int gather_sum(const Gather& g, const float* V, int C, int per_row, float* out,
                      cudaStream_t stream) {
  if (g.cells <= 0) return static_cast<int>(cudaSuccess);
  if (g.E >= (1ll << 31) || C <= 0 || per_row <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nch = chunks(g.cells);
  scan_chunks_kernel<<<nch, kScanThreads, 0, stream>>>(g);
  scan_apply_kernel<<<nch, kScanThreads, 0, stream>>>(g);
  if (g.E > 0) fill_kernel<<<static_cast<unsigned>((g.E + 255) / 256), 256, 0, stream>>>(g);
  rank_kernel<<<static_cast<unsigned>((static_cast<long long>(g.cells) * 32 + 255) / 256),
                256, 0, stream>>>(g);
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  sort_long_kernel<<<4 * sms, kSortThreads, 0, stream>>>(g);
  const bool vec = C % 4 == 0 && reinterpret_cast<uintptr_t>(V) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int groups = vec ? C / 4 : C;
  const long long threads = static_cast<long long>(g.cells) * groups;
  const unsigned blocks = static_cast<unsigned>((threads + 255) / 256);
  if (vec)
    sum_kernel<4><<<blocks, 256, 0, stream>>>(g, V, C, per_row, out, groups);
  else
    sum_kernel<1><<<blocks, 256, 0, stream>>>(g, V, C, per_row, out, groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ordered
