// Implicit-GEMM convolution tile shared by K4 (osa_reduce.cu), K5
// (osa_block.cu) and K6 (bottleneck.cu).
//
//   acc_d[p, o] = sum over the segments s with dst == d of
//                 sum_{tap, c} a_s[n, i + dy(tap), j + dx(tap), c]
//                              * b_s[tap * C_s + c, o]
//   v = acc_0 * scale + bias  (+ acc_1 * scale2 + bias2)  (+ resid[p, o])
//   out[p, o] = round_T(relu?(v)),   sums[n, o] = sum of v over the real pixels
//
// with p = (n*H + i)*W + j.  A segment is one activation tensor and its
// weights: a 1x1 piece (taps = 1), or a 3x3 / stride 1 / pad 1 conv input
// (taps = 9, dy = tap/3 - 1, dx = tap%3 - 1, zero padding by predicate).
// Walking several segments into one accumulator is K4's concat-free
// reduce: the concatenation is a table of pointers.  All affine math is
// float32 on the float32 accumulators; the output is rounded once.
//
// Layouts: a_s [N,H,W,C_s], b_s [taps*C_s, Cout] row-major (tap-major),
// resid and out [N,H,W,Cout], sums [N,Cout]; all contiguous.  Any C_s and
// Cout: 16-byte cp.async loads where a row is aligned (C_s % 8 == 0 and an
// aligned base, flagged by the host), element loads with bounds otherwise.
//
// Block: 64 pixels of one image x 128 output channels, 4 warps.  bfloat16
// multiplies on the tensor cores (nvcuda::wmma 16x16x16, float32
// accumulators, warp tile 32 x 64); float32 takes CUDA-core FMAs (8 x 8
// per thread), so the float32 path has no TF32.  The K slices are double
// buffered in shared memory with cp.async.  The per-image channel sums
// are summed in one fixed order: over the block's rows by warp shuffles
// and then over its warps (or threads) in index order, into one partial a
// (block, channel) written once; the block that completes an (image, Cout
// tile) column, found by a ticket (ordered_sum.cuh), sums the column's
// partials in pixel-block order.  Blocks run in no order, but no float
// atomic takes part, so the sums are the same bits run after run.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

#include "ordered_sum.cuh"

namespace tck {

using bf16 = __nv_bfloat16;

constexpr int kMaxSeg = 8;
constexpr int BM = 64;     // pixels per block (one image)
constexpr int BN = 128;    // output channels per block
constexpr int NT = 128;    // threads per block

struct Seg {
  const void* a;   // [N, H, W, c]
  const void* b;   // [taps * c, Cout]
  int c;           // channels of a
  int taps;        // 1 or 9
  int dst;         // accumulator 0 or 1
  int vec;         // rows of a load as 16-byte vectors
};

struct ConvGemm {
  Seg seg[kMaxSeg];
  int nseg;
  const float* scale;    // [Cout] affine of accumulator 0
  const float* bias;
  const float* scale2;   // [Cout] affine of accumulator 1 (two-acc kernels)
  const float* bias2;
  const void* resid;     // [N, H, W, Cout] added in float32, or null
  void* out;             // [N, H, W, Cout]
  float* sums;           // [N, Cout] written, or null
  float* partials;       // sums: [N, pixel blocks, Cout] a block's part
  unsigned* tickets;     // sums: [N * Cout blocks], zero between launches
  int N, H, W, Cout;
  int relu;
  int bvec;              // every b loads as 16-byte vectors (Cout % 8 == 0)
  int ovec;              // out and resid store / load as 16-byte vectors
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// 8 contiguous elements: 16 (bf16) or 32 (float) bytes.
template <typename T>
__device__ __forceinline__ void cp8(T* dst, const T* src) {
#pragma unroll
  for (int v = 0; v < static_cast<int>(sizeof(T)) / 2; ++v)
    cp_async16(reinterpret_cast<char*>(dst) + 16 * v,
               reinterpret_cast<const char*>(src) + 16 * v);
}
template <typename T>
__device__ __forceinline__ void zero8(T* dst) {
#pragma unroll
  for (int v = 0; v < static_cast<int>(sizeof(T)) / 2; ++v)
    reinterpret_cast<uint4*>(dst)[v] = make_uint4(0, 0, 0, 0);
}
// Element loads with a bound: src[v] for v < lim, zero past it.
template <typename T>
__device__ __forceinline__ void load8_bounded(T* dst, const T* src, int lim) {
#pragma unroll
  for (int v = 0; v < 8; ++v) dst[v] = v < lim ? src[v] : from_f<T>(0.f);
}

// KIND (4, 5 or 6) names the kernel of the port that launches the tile,
// so that a profiler trace tells K4, K5 and K6 apart.
template <int KIND, typename T, bool TWO>
__global__ void __launch_bounds__(NT) conv_gemm_kernel(const ConvGemm p) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  constexpr int BK = kBf16 ? 32 : 16;          // K per step
  constexpr int PAD = 16 / sizeof(T);          // 16 bytes of row padding
  constexpr int A_LD = BK + PAD;
  constexpr int B_LD = BN + PAD;
  __shared__ __align__(128) T a_s[2][BM * A_LD];
  __shared__ __align__(128) T b_s[2][BK * B_LD];
  __shared__ __align__(32) float stage[kBf16 ? 4 * 256 : 1];
  __shared__ int row_i[BM], row_j[BM];
  __shared__ float colpart[8][BN];     // channel sums by warp row / thread row
  __shared__ int last_flag;
  __shared__ Seg segs[kMaxSeg];

  const int HW = p.H * p.W;
  const int n0 = blockIdx.x * BN;      // first output channel
  const int q0 = blockIdx.y * BM;      // first pixel within the image
  const int img = blockIdx.z;
  const int tid = threadIdx.x;

#pragma unroll
  for (int s = 0; s < kMaxSeg; ++s)    // static indices into the parameters
    if (tid == s && s < p.nseg) segs[s] = p.seg[s];
  for (int r = tid; r < BM; r += NT) {
    const int q = q0 + r;
    // a pixel past the image gets a row far outside, so every tap is zero
    row_i[r] = q < HW ? q / p.W : -(1 << 28);
    row_j[r] = q < HW ? q - (q / p.W) * p.W : 0;
  }
  for (int c = tid; c < 8 * BN; c += NT) colpart[c / BN][c % BN] = 0.f;
  __syncthreads();

  int total = 0;
  for (int s = 0; s < p.nseg; ++s)
    total += segs[s].taps * ((segs[s].c + BK - 1) / BK);

  // Position in the walk over (segment, tap, channel slice).
  struct Cursor { int seg, tap, c0; };
  auto advance = [&](Cursor& cu) {
    cu.c0 += BK;
    if (cu.c0 >= segs[cu.seg].c) {
      cu.c0 = 0;
      if (++cu.tap >= segs[cu.seg].taps) { cu.tap = 0; ++cu.seg; }
    }
  };

  auto load = [&](const Cursor& cu, int buf) {
    const Seg& sg = segs[cu.seg];
    const int dy = sg.taps == 9 ? cu.tap / 3 - 1 : 0;
    const int dx = sg.taps == 9 ? cu.tap % 3 - 1 : 0;
    const T* a = static_cast<const T*>(sg.a);
    for (int e = tid; e < BM * (BK / 8); e += NT) {
      const int r = e / (BK / 8), cc = (e - r * (BK / 8)) * 8;
      T* dst = &a_s[buf][r * A_LD + cc];
      const int ii = row_i[r] + dy, jj = row_j[r] + dx;
      const int c = cu.c0 + cc;
      if (ii >= 0 && ii < p.H && jj >= 0 && jj < p.W && c < sg.c) {
        const T* src = a + (static_cast<size_t>(img * p.H + ii) * p.W + jj) * sg.c + c;
        if (sg.vec && c + 8 <= sg.c) cp8(dst, src);
        else load8_bounded(dst, src, sg.c - c);
      } else {
        zero8(dst);
      }
    }
    const T* b = static_cast<const T*>(sg.b);
    for (int e = tid; e < BK * (BN / 8); e += NT) {
      const int r = e / (BN / 8), cv = (e - r * (BN / 8)) * 8;
      T* dst = &b_s[buf][r * B_LD + cv];
      const int k = cu.c0 + r, col = n0 + cv;
      if (k < sg.c && col < p.Cout) {
        const T* src = b + static_cast<size_t>(cu.tap * sg.c + k) * p.Cout + col;
        if (p.bvec && col + 8 <= p.Cout) cp8(dst, src);
        else load8_bounded(dst, src, p.Cout - col);
      } else {
        zero8(dst);
      }
    }
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;     // bf16 warp tile 32 x 64
  const int tx = tid & 15, ty = tid >> 4;      // float: rows ty+8i, cols tx+16j
  using namespace nvcuda;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4], acc2[TWO ? 2 : 1][TWO ? 4 : 1];
  float facc[8][8], facc2[TWO ? 8 : 1][TWO ? 8 : 1];
  if constexpr (kBf16) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fill_fragment(acc[i][j], 0.f);
        if constexpr (TWO) wmma::fill_fragment(acc2[i][j], 0.f);
      }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        facc[i][j] = 0.f;
        if constexpr (TWO) facc2[i][j] = 0.f;
      }
  }

  Cursor lc{0, 0, 0}, cc{0, 0, 0};
  if (total > 0) { load(lc, 0); advance(lc); }
  cp_async_commit();
  for (int s = 0; s < total; ++s) {
    const int buf = s & 1;
    if (s + 1 < total) { load(lc, buf ^ 1); advance(lc); }
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const bool second = TWO && segs[cc.seg].dst == 1;
    const T* as = a_s[buf];
    const T* bs = b_s[buf];
    if constexpr (kBf16) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], as + (wm * 32 + i * 16) * A_LD + kk, A_LD);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::load_matrix_sync(fb[j], bs + kk * B_LD + wn * 64 + j * 16, B_LD);
        if (!second) {
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
        } else if constexpr (TWO) {
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) wmma::mma_sync(acc2[i][j], fa[i], fb[j], acc2[i][j]);
        }
      }
    } else {
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float av[8], bv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) av[i] = to_f(as[(ty + 8 * i) * A_LD + kk]);
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = to_f(bs[kk * B_LD + tx + 16 * j]);
        if (!second) {
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) facc[i][j] += av[i] * bv[j];
        } else if constexpr (TWO) {
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) facc2[i][j] += av[i] * bv[j];
        }
      }
    }
    __syncthreads();
    advance(cc);
  }

  // Epilogue: v = acc*scale + bias (+ acc2*scale2 + bias2) (+ resid),
  // relu, one rounding to T; channel sums of v over the real pixels.
  T* out = static_cast<T*>(p.out);
  const T* resid = static_cast<const T*>(p.resid);
  const size_t img_row0 = static_cast<size_t>(img) * HW;
  auto finish = [&](float v, float v2, int q, int col) -> float {
    v = v * p.scale[col] + p.bias[col];
    if constexpr (TWO) v += v2 * p.scale2[col] + p.bias2[col];
    if (resid != nullptr) v += to_f(resid[(img_row0 + q) * p.Cout + col]);
    return p.relu ? fmaxf(v, 0.f) : v;
  };

  if constexpr (kBf16) {
    float* st = stage + warp * 256;
    const int r = lane >> 1, c8 = (lane & 1) * 8;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v[8], v2[8];
        wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = st[r * 16 + c8 + e];
        __syncwarp();
        if constexpr (TWO) {
          wmma::store_matrix_sync(st, acc2[i][j], 16, wmma::mem_row_major);
          __syncwarp();
#pragma unroll
          for (int e = 0; e < 8; ++e) v2[e] = st[r * 16 + c8 + e];
          __syncwarp();
        }
        const int q = q0 + wm * 32 + i * 16 + r;
        const int lcol = wn * 64 + j * 16 + c8;
        const int col = n0 + lcol;
        const bool row_ok = q < HW;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const bool ok = row_ok && col + e < p.Cout;
          v[e] = ok ? finish(v[e], TWO ? v2[e] : 0.f, q, col + e) : 0.f;
        }
        if (row_ok) {
          T* o = out + (img_row0 + q) * p.Cout + col;
          if (p.ovec && col + 8 <= p.Cout) {
            uint4 u;
            __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
            for (int e = 0; e < 4; ++e) h[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
            *reinterpret_cast<uint4*>(o) = u;
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e)
              if (col + e < p.Cout) o[e] = from_f<T>(v[e]);
          }
        }
        if (p.sums != nullptr) {
          // lanes of one parity hold the same 8 columns of 16 rows
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            float s = v[e];
#pragma unroll
            for (int off = 2; off < 32; off <<= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
            v[e] = s;
          }
          if (lane < 2) {        // this lane alone adds to these columns of row wm
#pragma unroll
            for (int e = 0; e < 8; ++e) colpart[wm][lcol + e] += v[e];
          }
        }
      }
    }
  } else {
    float csum[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) csum[j] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q = q0 + ty + 8 * i;
      if (q >= HW) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + tx + 16 * j;
        if (col >= p.Cout) continue;
        const float v = finish(facc[i][j], TWO ? facc2[TWO ? i : 0][TWO ? j : 0] : 0.f, q, col);
        out[(img_row0 + q) * p.Cout + col] = from_f<T>(v);
        csum[j] += v;
      }
    }
    if (p.sums != nullptr) {
#pragma unroll
      for (int j = 0; j < 8; ++j) colpart[ty][tx + 16 * j] = csum[j];
    }
  }

  if (p.sums != nullptr) {
    // this block's part: its rows of colpart in order, written once; the
    // block that completes the (image, Cout tile) column sums its parts in
    // pixel-block order
    __syncthreads();
    const size_t col = static_cast<size_t>(img) * gridDim.y * p.Cout + n0;
    for (int c = tid; c < BN; c += NT) {
      if (n0 + c >= p.Cout) continue;
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < (kBf16 ? 2 : 8); ++r) s += colpart[r][c];
      p.partials[col + static_cast<size_t>(blockIdx.y) * p.Cout + c] = s;
    }
    if (ordered::arrive(p.tickets + img * gridDim.x + blockIdx.x, gridDim.y, tid == 0,
                        &last_flag, [] { __syncthreads(); })) {
      for (int c = tid; c < BN; c += NT)
        if (n0 + c < p.Cout)
          p.sums[static_cast<size_t>(img) * p.Cout + n0 + c] =
              ordered::sum_strided(p.partials + col + c, gridDim.y, p.Cout);
    }
  }
}

inline bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

// Fill the alignment flags and launch; returns the launch's cudaError_t.
template <int KIND, typename T>
int launch_conv_gemm(ConvGemm p, void* stream) {
  if (p.nseg < 1 || p.nseg > kMaxSeg) return static_cast<int>(cudaErrorInvalidValue);
  bool two = false;
  p.bvec = p.Cout % 8 == 0;
  for (int s = 0; s < p.nseg; ++s) {
    Seg& sg = p.seg[s];
    sg.vec = sg.c % 8 == 0 && aligned16(sg.a);
    p.bvec = p.bvec && aligned16(sg.b);
    two = two || sg.dst == 1;
  }
  p.ovec = p.Cout % 8 == 0 && aligned16(p.out) &&
           (p.resid == nullptr || aligned16(p.resid));
  const int HW = p.H * p.W;
  dim3 grid((p.Cout + BN - 1) / BN, (HW + BM - 1) / BM, p.N);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (two) conv_gemm_kernel<KIND, T, true><<<grid, NT, 0, s>>>(p);
  else conv_gemm_kernel<KIND, T, false><<<grid, NT, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tck
