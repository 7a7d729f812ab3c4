// Hungarian matching: min-cost assignment of gts to queries, float32.
//
// Replaces transcar_tpu/ops/hungarian.py::hungarian_match, which solves
// each (layer, sample) problem on the device inside the jitted train step
// with lax.while_loops (no Pallas: an XLA formulation).  The wrapper, the
// bound and the design are described in transcar_tpu_torch/ops/hungarian.py.
//
// For P problems at once: cost [P, Q, G] float32 (rows queries, columns
// gt slots), num_gt [P] int32; out matched [P, G] int64 (the query of
// each gt slot, the sentinel Q at slots >= num_gt) and valid [P, G] bool
// (slot < num_gt).  The solver is the JAX one, step for step: a
// shortest-augmenting-path LAP (scipy's rectangular_lsap.cpp) over the
// gts as rows, solved only up to num_gt, with the same float32 sums in
// the same order, and argmin ties broken to the lowest column, so its
// matches are the JAX solver's.
//
// One thread block per problem, a Dijkstra loop per row: each scan,
// every thread updates its columns (j = tid, tid + 256, ...), reading
// cost[j, i] where it lies (a stride of G floats; sanitized as read:
// NaN -> +1e7, +-inf -> +-1e7, clipped to +-1e7) and offers its least
// unscanned column; a warp shuffle and a pass over the 8 warp minima
// (double-buffered, so one __syncthreads a scan) give every thread the
// same column.  The potentials and the augmentation follow as in JAX,
// the augmentation on one thread.  State in shared memory: v, shortest,
// path, row4col, sc [Q] and u, col4row, sr [G] (17 Q + 9 G bytes: 16.5
// KB at Q = 900, G = 128).  Nothing is read on the host.  A scan waits on
// its loads, its shuffle and its barrier in turn, so the scans' latency,
// not bytes, sets the time; a problem's cost (115 KB at 900 x 32) stays
// in L2 for its rescans.

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kBigM = 1e7f;
// the JAX solver's _INF, float32 max / 4 (exact)
constexpr float kInf = FLT_MAX / 4.0f;

__device__ __forceinline__ float sanitize(float c) {
  if (isnan(c)) return kBigM;
  return fminf(fmaxf(c, -kBigM), kBigM);      // +-inf and past +-1e7 clip
}

// (value, column) pairs: the lesser value, ties to the lower column, as
// jnp.argmin returns the first index of the least value
__device__ __forceinline__ void take_min(float& best, int& bj, float ov,
                                         int oj) {
  if (ov < best || (ov == best && oj < bj)) {
    best = ov;
    bj = oj;
  }
}

size_t shared_bytes(int Q, int G) {
  return static_cast<size_t>(Q) * 16 + static_cast<size_t>(G) * 8
         + 2 * kWarps * 8 + Q + G;
}

__global__ void __launch_bounds__(kThreads)
hungarian_kernel(const float* __restrict__ cost, const int* __restrict__ num_gt,
                 long long* __restrict__ matched,
                 unsigned char* __restrict__ valid, int* __restrict__ scans,
                 int Q, int G) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* v = reinterpret_cast<float*>(smem);
  float* shortest = v + Q;
  int* path = reinterpret_cast<int*>(shortest + Q);
  int* row4col = path + Q;
  float* u = reinterpret_cast<float*>(row4col + Q);
  int* col4row = reinterpret_cast<int*>(u + G);
  float* red_v = reinterpret_cast<float*>(col4row + G);     // [2][kWarps]
  int* red_j = reinterpret_cast<int*>(red_v + 2 * kWarps);  // [2][kWarps]
  unsigned char* sc = reinterpret_cast<unsigned char*>(red_j + 2 * kWarps);
  unsigned char* sr = sc + Q;

  const int p = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = min(max(num_gt[p], 0), G);
  const float* c = cost + static_cast<long long>(p) * Q * G;
  for (int j = tid; j < Q; j += kThreads) {
    v[j] = 0.f;
    row4col[j] = -1;
  }
  for (int g = tid; g < G; g += kThreads) {
    u[g] = 0.f;
    col4row[g] = -1;
  }
  int total_scans = 0;

  for (int cur = 0; cur < n; ++cur) {
    for (int j = tid; j < Q; j += kThreads) {
      shortest[j] = kInf;
      path[j] = -1;
      sc[j] = 0;
    }
    for (int g = tid; g < G; g += kThreads) sr[g] = 0;
    __syncthreads();

    // Dijkstra from row cur; the scan bound is the JAX solver's backstop
    int i = cur, sink = -1, it = 0;
    float min_val = 0.f;
    while (sink == -1 && it < Q) {
      if (tid == 0) sr[i] = 1;
      const float ui = u[i];
      const float* ci = c + i;                    // cost[j, i] = ci[j * G]
      float best = INFINITY;
      int bj = 0x7fffffff;
      for (int j = tid; j < Q; j += kThreads) {   // j's owner: j % kThreads
        float m = kInf;                           // a scanned column
        if (!sc[j]) {
          // ((min_val + cost[i, j]) - u[i]) - v[j], the JAX order
          const float red =
              __fsub_rn(__fsub_rn(__fadd_rn(min_val, sanitize(__ldg(
                  ci + static_cast<long long>(j) * G))), ui), v[j]);
          m = shortest[j];
          if (red < m) {
            m = red;
            shortest[j] = red;
            path[j] = i;
          }
        }
        take_min(best, bj, m, j);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        take_min(best, bj, __shfl_down_sync(0xffffffffu, best, o),
                 __shfl_down_sync(0xffffffffu, bj, o));
      const int buf = (it & 1) * kWarps;
      if (lane == 0) {
        red_v[buf + warp] = best;
        red_j[buf + warp] = bj;
      }
      __syncthreads();
      best = red_v[buf];
      bj = red_j[buf];
#pragma unroll
      for (int w = 1; w < kWarps; ++w)
        take_min(best, bj, red_v[buf + w], red_j[buf + w]);
      min_val = best;
      if (bj % kThreads == tid) sc[bj] = 1;
      const int owner = row4col[bj];
      if (owner == -1) {
        sink = bj;
      } else {
        i = owner;
      }
      ++it;
    }
    total_scans += it;
    __syncthreads();

    // potentials (rectangular_lsap.cpp, as hungarian.py updates them)
    for (int g = tid; g < G; g += kThreads) {
      if (g == cur) {
        u[g] = __fadd_rn(u[g], min_val);
      } else if (sr[g]) {
        const int cj = min(max(col4row[g], 0), Q - 1);
        u[g] = __fsub_rn(__fadd_rn(u[g], min_val), shortest[cj]);
      }
    }
    for (int j = tid; j < Q; j += kThreads)
      if (sc[j]) v[j] = __fsub_rn(v[j], __fsub_rn(min_val, shortest[j]));
    __syncthreads();

    // augment along the alternating path, at most G + 1 steps (the JAX
    // backstop); a bailed Dijkstra (sink -1) leaves the row unmatched
    if (tid == 0 && sink != -1) {
      int j = sink;
      for (int step = 0; step <= G; ++step) {
        const int pi = path[j];
        if (pi < 0 || pi >= G) break;       // no path: degenerate input
        row4col[j] = pi;
        const int nj = col4row[pi];
        col4row[pi] = j;
        if (pi == cur || nj < 0) break;
        j = nj;
      }
    }
    __syncthreads();
  }

  // padded slots take the sentinel Q; a real slot the backstops left
  // unmatched keeps -1, as the JAX solver returns
  for (int g = tid; g < G; g += kThreads) {
    const int q = col4row[g];
    const bool real = g < n;
    matched[static_cast<long long>(p) * G + g] = real ? q : Q;
    valid[static_cast<long long>(p) * G + g] = real;
  }
  if (scans != nullptr && tid == 0) scans[p] = total_scans;
}

}  // namespace

// P problems, one block each, on the given stream; scans (P ints, the
// Dijkstra scans of each problem) may be null.  Returns a cudaError_t.
extern "C" int hungarian_match_f32(const void* cost, const void* num_gt,
                                   void* matched, void* valid, void* scans,
                                   int P, int Q, int G, void* stream) {
  if (P < 0 || Q < 1 || G < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (P == 0 || G == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = shared_bytes(Q, G);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        hungarian_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  hungarian_kernel<<<P, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cost), static_cast<const int*>(num_gt),
      static_cast<long long*>(matched),
      static_cast<unsigned char*>(valid), static_cast<int*>(scans), Q, G);
  return static_cast<int>(cudaGetLastError());
}
