// DCNv2 backward (3x3, stride 1, pad 1, dilation 1): two kernels.
//
// Replaces transcar_tpu/ops/pallas_dcn.py::_fused_dcn_bwd_impl (the Pallas
// kernel _bwd_kernel, the custom VJP of fused_deform_conv_ad).  The
// wrapper, the bound and the design are described in
// transcar_tpu_torch/ops/pallas_dcn.py.
//
// With p = (n*H + i)*W + j, tap k = 3r + c sampling at
// (py, px) = (i - 1 + r + dy_k, j - 1 + c + dx_k), s_k = sigmoid(m_k),
// and the four bilinear corners v_00 .. v_11 of x (zero outside the image):
//
//   d_samp[p, k, c] = sum_o d_out[p, o] * w[k*Cin + c, o]          (fp32)
//   d_x[q, c]       = sum over the (p, k, corner) landing on pixel q, in
//                     that order, of s_k * bw_corner * d_samp[p, k, c]
//   d_om[p, 2k]     = s_k * sum_c d_samp * d bilinear / d py         (floor
//   d_om[p, 2k+1]   = s_k * sum_c d_samp * d bilinear / d px          convention)
//   d_om[p, 18+k]   = s_k (1 - s_k) * sum_c d_samp * bilinear
//   d_w[k*Cin + c, o] = sum_p round_T(s_k * bilinear)[p, k, c] * d_out[p, o]
//
// The derivative at an integer sample position is the one-sided one of
// the floor convention: py = y0 exactly gives (row y0+1) - (row y0).
// Layouts: x [N,H,W,Cin], om [N,H,W,27] (ch 2k = dy_k, 2k+1 = dx_k,
// 18+k = mask logit), w [9*Cin, Cout] row-major, d_out [N,H,W,Cout], all
// of the working type T and contiguous; d_x [N,H,W,Cin] and d_w
// [9*Cin, Cout] are float32 and written whole; d_om is T.  Requires
// Cin % 32 == 0, Cout % 8 == 0 and 16-byte aligned tensors (checked by
// the wrapper).
//
// Every sum has one fixed order, so the results repeat bit for bit, as
// the TPU kernel's do (ordered_sum.cuh).  (a) writes d_samp [M*9, Cin]
// float32 and lists each (p, k, corner) with its pixel and weight
// s_k * bw_corner; the gather by target then sums each pixel's list in
// (p, k, corner) order into d_x, with no float atomic.  (b) writes one
// partial d_W tile a pixel split; the split that completes a tile, found
// by a ticket, sums the tile's partials in split order.  The workspace
// (dcn_backward_*_workspace) holds d_samp, the gather's lists and the
// partials; `zeroed` is int32 scratch, zero on entry and left zero.
//
// bfloat16 with Cout <= 1024 takes the Hopper kernels below (wgmma, TMA);
// float32 (used by the checks) and a larger Cout take the first two (wmma or
// CUDA-core FMAs, synchronous staging).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "dcn_tap.cuh"
#include "hopper_tile.cuh"
#include "ordered_sum.cuh"

#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

using dcn::empty_tap;
using dcn::make_tap;
using dcn::Tap;
using dcn::to_float;

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// 4 contiguous elements -> floats (8-byte bf16 / 16-byte float loads).
__device__ __forceinline__ void load4(const float* p, float* f) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  f[0] = t.x; f[1] = t.y; f[2] = t.z; f[3] = t.w;
}
__device__ __forceinline__ void load4(const bf16* p, float* f) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
}

// 16 contiguous elements <-> 16 floats, with 16-byte vector accesses.
__device__ __forceinline__ void load16(const float* p, float* f) {
#pragma unroll
  for (int v = 0; v < 4; ++v) load4(p + 4 * v, f + 4 * v);
}
__device__ __forceinline__ void load16(const bf16* p, float* f) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    uint4 u = q[v];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 t = __bfloat1622float2(h[i]);
      f[8 * v + 2 * i] = t.x;
      f[8 * v + 2 * i + 1] = t.y;
    }
  }
}
__device__ __forceinline__ void store16(float* p, const float* f) {
  float4* q = reinterpret_cast<float4*>(p);
#pragma unroll
  for (int v = 0; v < 4; ++v)
    q[v] = make_float4(f[4 * v], f[4 * v + 1], f[4 * v + 2], f[4 * v + 3]);
}
__device__ __forceinline__ void store16(bf16* p, const float* f) {
  uint4* q = reinterpret_cast<uint4*>(p);
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(f[8 * v + 2 * i], f[8 * v + 2 * i + 1]);
    q[v] = u;
  }
}

// 8 contiguous elements, 16-byte aligned.
template <typename T>
__device__ __forceinline__ void copy8(T* dst, const T* src) {
  constexpr int n = 8 * sizeof(T) / 16;
#pragma unroll
  for (int v = 0; v < n; ++v)
    reinterpret_cast<uint4*>(dst)[v] = reinterpret_cast<const uint4*>(src)[v];
}
template <typename T>
__device__ __forceinline__ void zero8(T* dst) {
  constexpr int n = 8 * sizeof(T) / 16;
#pragma unroll
  for (int v = 0; v < n; ++v)
    reinterpret_cast<uint4*>(dst)[v] = make_uint4(0, 0, 0, 0);
}

// The gather's entries of one (pixel p, tap k): its four corners' pixels
// (-1: padding) and weights s_k * bw_corner, sources (p * 9 + k) * 4 + c.
__device__ __forceinline__ void list_tap(const ordered::Gather& g, int p, int k,
                                         const Tap& t) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
    ordered::list_source(g, (static_cast<long long>(p) * 9 + k) * 4 + c, t.off[c],
                         t.sig * t.w[c]);
}

// d_samp row (p, k), 4 channels from ch.
__device__ __forceinline__ float* samp_row(float* dsamp, int p, int k, int Cin, int ch) {
  return dsamp + (static_cast<size_t>(p) * 9 + k) * Cin + ch;
}

// ---------------------------------------------------------------------------
// (a) d_x, d_offset and d_mask.  A block owns BM pixels; for each tap and
// each BC-channel slice it first forms d_samp = d_out x w_k^T on the
// tensor cores (bf16; float32 takes a CUDA-core FMA loop, no TF32), then
// every warp walks 16 of the pixels with one lane per 4 channels: it
// stores d_samp for the gather of d_x, gathers the 4 corners and reduces
// the offset and mask terms over the channels with warp shuffles.
// ---------------------------------------------------------------------------

constexpr int BM = 64;           // pixels per block
constexpr int BC = 128;          // input channels per d_samp tile
constexpr int BK = 32;           // Cout per MMA step
constexpr int NT = 128;          // threads (4 warps)
constexpr int LD = BK + 8;       // staged operand rows (elements)
constexpr int DS_LD = BC + 4;    // d_samp tile rows (floats)

template <typename T>
__global__ void __launch_bounds__(NT)
dcn_bwd_data_kernel(const T* __restrict__ x, const T* __restrict__ om,
                    const T* __restrict__ w, const T* __restrict__ dout,
                    float* __restrict__ dsamp, ordered::Gather g, T* __restrict__ dom,
                    int N, int H, int W, int Cin, int Cout) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  static_assert((BM + BC) * LD * sizeof(T) <= BM * DS_LD * sizeof(float),
                "staged operands must fit in the d_samp tile they alias");
  // The staged MMA operands and the d_samp tile are never live together.
  __shared__ __align__(32) unsigned char raw[BM * DS_LD * sizeof(float)];
  T* a_s = reinterpret_cast<T*>(raw);            // [BM][LD]  d_out slice
  T* b_s = a_s + BM * LD;                        // [BC][LD]  w_k slice
  float* ds = reinterpret_cast<float*>(raw);     // [BM][DS_LD] d_samp
  __shared__ Tap taps[BM];
  __shared__ float red[BM][3];                   // d_py, d_px, d_s sums

  const int M = N * H * W;
  const int m0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;       // bf16 warp tile 32 x 64
  const int tx = tid & 15, ty = tid >> 4;        // float: rows ty+8i, cols tx+16j

  for (int k = 0; k < 9; ++k) {
    __syncthreads();                 // the previous tap's readers are done
    if (tid < BM) {
      const int p = m0 + tid;
      taps[tid] = p < M ? make_tap(om, p, k, H, W) : empty_tap();
      if (p < M) list_tap(g, p, k, taps[tid]);
      red[tid][0] = red[tid][1] = red[tid][2] = 0.f;
    }
    for (int c0 = 0; c0 < Cin; c0 += BC) {
      // 1. d_samp[BM, BC] = d_out[m0.., :] x w[k*Cin + c0.., :]^T
      nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> acc[2][4];
      float facc[8][8];
      if constexpr (kBf16) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) nvcuda::wmma::fill_fragment(acc[i][j], 0.f);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) facc[i][j] = 0.f;
      }
      for (int o0 = 0; o0 < Cout; o0 += BK) {
        __syncthreads();             // earlier readers of raw are done
        for (int e = tid; e < BM * (BK / 8); e += NT) {
          const int r = e / (BK / 8), cv = (e - r * (BK / 8)) * 8;
          const int p = m0 + r;
          T* dst = a_s + r * LD + cv;
          if (p < M && o0 + cv < Cout)
            copy8(dst, dout + static_cast<size_t>(p) * Cout + o0 + cv);
          else
            zero8(dst);
        }
        for (int e = tid; e < BC * (BK / 8); e += NT) {
          const int r = e / (BK / 8), cv = (e - r * (BK / 8)) * 8;
          const int c = c0 + r;
          T* dst = b_s + r * LD + cv;
          if (c < Cin && o0 + cv < Cout)
            copy8(dst, w + static_cast<size_t>(k * Cin + c) * Cout + o0 + cv);
          else
            zero8(dst);
        }
        __syncthreads();
        if constexpr (kBf16) {
          using namespace nvcuda;
#pragma unroll
          for (int kk = 0; kk < BK; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb[4];
#pragma unroll
            for (int i = 0; i < 2; ++i)
              wmma::load_matrix_sync(fa[i], a_s + (wm * 32 + i * 16) * LD + kk, LD);
#pragma unroll
            for (int j = 0; j < 4; ++j)
              wmma::load_matrix_sync(fb[j], b_s + (wn * 64 + j * 16) * LD + kk, LD);
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
          }
        } else {
#pragma unroll 4
          for (int kk = 0; kk < BK; ++kk) {
            float av[8], bv[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) av[i] = to_float(a_s[(ty + 8 * i) * LD + kk]);
#pragma unroll
            for (int j = 0; j < 8; ++j) bv[j] = to_float(b_s[(tx + 16 * j) * LD + kk]);
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
              for (int j = 0; j < 8; ++j) facc[i][j] += av[i] * bv[j];
          }
        }
      }
      __syncthreads();               // the operands die; ds takes their place
      if constexpr (kBf16) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            nvcuda::wmma::store_matrix_sync(
                ds + (wm * 32 + i * 16) * DS_LD + wn * 64 + j * 16, acc[i][j],
                DS_LD, nvcuda::wmma::mem_row_major);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) ds[(ty + 8 * i) * DS_LD + tx + 16 * j] = facc[i][j];
      }
      __syncthreads();

      // 2. Scatter and reduce: warp -> 16 pixels, lane -> 4 channels.
      const int ch = lane * 4;
      const bool live = c0 + ch < Cin;
      for (int q = 0; q < BM / 4; ++q) {
        const int pi = warp * (BM / 4) + q;
        if (m0 + pi >= M) break;                   // warp-uniform
        const Tap& t = taps[pi];
        // d(corner weight)/d fy and /d fx for corners 00, 01, 10, 11
        const float cy[4] = {-(1.f - t.fx), -t.fx, 1.f - t.fx, t.fx};
        const float cx[4] = {-(1.f - t.fy), 1.f - t.fy, -t.fy, t.fy};
        float gy = 0.f, gx = 0.f, gm = 0.f;
        if (live) {
          float d[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) d[e] = ds[pi * DS_LD + ch + e];
          *reinterpret_cast<float4*>(samp_row(dsamp, m0 + pi, k, Cin, c0 + ch)) =
              make_float4(d[0], d[1], d[2], d[3]);
          float sy[4] = {0.f, 0.f, 0.f, 0.f}, sx[4] = {0.f, 0.f, 0.f, 0.f};
          float sm[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (t.off[c] < 0) continue;
            const size_t base = static_cast<size_t>(t.off[c]) * Cin + c0 + ch;
            float v[4];
            load4(x + base, v);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              sy[e] += cy[c] * v[e];
              sx[e] += cx[c] * v[e];
              sm[e] += t.w[c] * v[e];
            }
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            gy += d[e] * sy[e];
            gx += d[e] * sx[e];
            gm += d[e] * sm[e];
          }
        }
#pragma unroll
        for (int s = 16; s > 0; s >>= 1) {
          gy += __shfl_xor_sync(0xffffffffu, gy, s);
          gx += __shfl_xor_sync(0xffffffffu, gx, s);
          gm += __shfl_xor_sync(0xffffffffu, gm, s);
        }
        if (lane == 0) {
          red[pi][0] += gy;
          red[pi][1] += gx;
          red[pi][2] += gm;
        }
      }
    }
    __syncwarp();
    // 3. This tap's three d_om channels, written once by the owning warp.
    if (lane < BM / 4) {
      const int pi = warp * (BM / 4) + lane, p = m0 + pi;
      if (p < M) {
        const float s = taps[pi].sig;
        T* o = dom + static_cast<size_t>(p) * 27;
        o[2 * k] = from_float<T>(s * red[pi][0]);
        o[2 * k + 1] = from_float<T>(s * red[pi][1]);
        o[18 + k] = from_float<T>(red[pi][2] * s * (1.f - s));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// (b) d_w = sampled^T x d_out, an implicit GEMM over the pixels.  A block
// owns a [WM rows = WM input channels of one tap] x [WN output channels]
// tile of d_w and one split of the pixels; per WK-pixel step it regathers
// the modulated sample (rounded to T, as the forward rounds it) into
// shared memory, stages d_out beside it and multiplies (bf16 wmma; float32
// CUDA-core FMAs).  Each split writes its fp32 partial tile; the split
// that completes a tile sums the tile's partials in split order.
// ---------------------------------------------------------------------------

constexpr int WM = 128;          // d_w rows per block
constexpr int WN = 128;          // d_w cols per block
constexpr int WK = 32;           // pixels per step
constexpr int WNT = 256;         // threads (8 warps)
constexpr int S_LD = WM + 8;     // sampled tile [WK][S_LD] (pixel-major)
constexpr int D_LD = WN + 8;     // d_out tile [WK][D_LD]

template <typename T>
__global__ void __launch_bounds__(WNT)
dcn_bwd_weight_kernel(const T* __restrict__ x, const T* __restrict__ om,
                      const T* __restrict__ dout, float* __restrict__ dw,
                      float* __restrict__ part, unsigned* __restrict__ tickets,
                      int N, int H, int W, int Cin, int Cout, int per_split) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  __shared__ Tap taps[WK];
  __shared__ __align__(32) T s_s[WK * S_LD];
  __shared__ __align__(32) T d_s[WK * D_LD];
  __shared__ __align__(32) float stage[kBf16 ? 8 * 256 : 1];
  __shared__ int last_flag;

  const int M = N * H * W;
  const int ctiles = (Cin + WM - 1) / WM;
  const int k = blockIdx.x / ctiles;
  const int c0 = (blockIdx.x - k * ctiles) * WM;
  const int o0 = blockIdx.y * WN;
  const int p_begin = blockIdx.z * per_split;
  const int p_end = min(M, p_begin + per_split);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;       // bf16 warp tile 32 x 64
  const int tx = tid & 15, ty = tid >> 4;        // float: rows ty+16i, cols tx+16j

  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> acc[2][4];
  float facc[8][8];
  if constexpr (kBf16) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) nvcuda::wmma::fill_fragment(acc[i][j], 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) facc[i][j] = 0.f;
  }

  for (int pb = p_begin; pb < p_end; pb += WK) {
    __syncthreads();                 // the previous step's readers are done
    if (tid < WK) {
      const int p = pb + tid;
      Tap t = p < p_end ? make_tap(om, p, k, H, W) : empty_tap();
#pragma unroll
      for (int c = 0; c < 4; ++c) t.w[c] *= t.sig;
      taps[tid] = t;
    }
    for (int e = tid; e < WK * (WN / 8); e += WNT) {
      const int r = e / (WN / 8), cv = (e - r * (WN / 8)) * 8;
      const int p = pb + r;
      T* dst = d_s + r * D_LD + cv;
      if (p < p_end && o0 + cv < Cout)
        copy8(dst, dout + static_cast<size_t>(p) * Cout + o0 + cv);
      else
        zero8(dst);
    }
    __syncthreads();
    {  // sampled tile: thread -> (pixel tid/8, 16 channels)
      const int r = tid >> 3, ch = (tid & 7) * 16;
      const Tap& t = taps[r];
      float a[16];
#pragma unroll
      for (int q = 0; q < 16; ++q) a[q] = 0.f;
      if (c0 + ch < Cin) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (t.off[c] < 0) continue;
          float v[16];
          load16(x + static_cast<size_t>(t.off[c]) * Cin + c0 + ch, v);
#pragma unroll
          for (int q = 0; q < 16; ++q) a[q] += t.w[c] * v[q];
        }
      }
      store16(s_s + r * S_LD + ch, a);
    }
    __syncthreads();
    if constexpr (kBf16) {
      using namespace nvcuda;
#pragma unroll
      for (int kk = 0; kk < WK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], s_s + kk * S_LD + wm * 32 + i * 16, S_LD);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::load_matrix_sync(fb[j], d_s + kk * D_LD + wn * 64 + j * 16, D_LD);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
    } else {
#pragma unroll 4
      for (int kk = 0; kk < WK; ++kk) {
        float av[8], bv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) av[i] = to_float(s_s[kk * S_LD + ty + 16 * i]);
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = to_float(d_s[kk * D_LD + tx + 16 * j]);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) facc[i][j] += av[i] * bv[j];
      }
    }
  }

  // Epilogue: this split's partial tile (d_w itself when there is one split)
  const int splits = gridDim.z;
  const size_t dw_size = static_cast<size_t>(9) * Cin * Cout;
  float* dst_base = splits == 1 ? dw : part + blockIdx.z * dw_size;
  if constexpr (kBf16) {
    float* st = stage + warp * 256;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        nvcuda::wmma::store_matrix_sync(st, acc[i][j], 16, nvcuda::wmma::mem_row_major);
        __syncwarp();
        const int r = lane >> 1, cc = (lane & 1) * 8;
        const int c = c0 + wm * 32 + i * 16 + r;
        const int col = o0 + wn * 64 + j * 16 + cc;
        if (c < Cin && col < Cout) {
          float* dst = dst_base + static_cast<size_t>(k * Cin + c) * Cout + col;
          const float* s = st + r * 16 + cc;
          reinterpret_cast<float4*>(dst)[0] = make_float4(s[0], s[1], s[2], s[3]);
          reinterpret_cast<float4*>(dst)[1] = make_float4(s[4], s[5], s[6], s[7]);
        }
        __syncwarp();
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = c0 + ty + 16 * i;
      if (c >= Cin) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = o0 + tx + 16 * j;
        if (col < Cout) dst_base[static_cast<size_t>(k * Cin + c) * Cout + col] = facc[i][j];
      }
    }
  }
  if (splits > 1 && ordered::arrive(tickets + blockIdx.x + gridDim.x * blockIdx.y, splits,
                                    tid == 0, &last_flag, [] { __syncthreads(); })) {
    for (int e = tid; e < WM * WN / 4; e += WNT) {
      const int r = e / (WN / 4), col = o0 + (e % (WN / 4)) * 4;
      if (c0 + r >= Cin || col >= Cout) continue;
      const size_t at = static_cast<size_t>(k * Cin + c0 + r) * Cout + col;
      *reinterpret_cast<float4*>(dw + at) = ordered::sum_strided4(part + at, splits, dw_size);
    }
  }
}

// ---------------------------------------------------------------------------
// The bfloat16 kernels on the Hopper tile (hopper_tile.cuh).
//
// (a) d_x, d_offset and d_mask.  A block owns BM pixels (one 128- or
// 64-row band of the [N*H*W, .] matrices) and a group of TG taps.  Its
// d_out tile [BM, Cout] arrives once by TMA and stays in shared memory;
// the W9 slices [64 channels, 64 Cout] stream through a 4-stage ring.
// For each (tap, 64-channel slice) the consumer warpgroups form d_samp
// [BM, 64] with wgmma (K = Cout, float32 accumulators) and hand it to a
// double-buffered shared tile; two scatter warpgroups then rebuild the four
// bilinear corners of each pixel (half a warp per pixel, 4 channels a
// lane, the corner loads of two pixels in flight together), store d_samp
// for the gather of d_x (one 16-byte store per (pixel, 4 channels)) and
// reduce the offset and mask terms over the channels with warp shuffles,
// while the consumers multiply the next slice.  The taps per block (tg) trade the
// wave tail against each block's start (loading its d_out band).
// ---------------------------------------------------------------------------

constexpr int HD_RING = 4;          // W9 slices in flight
constexpr int HD_BC = 64;           // channels per d_samp slice
constexpr int HD_LD = HD_BC + 8;    // d_samp rows (floats): conflict-free float2 writes

struct DataParams {
  CUtensorMap dout;                 // [M, Cout], box [64, BM]
  CUtensorMap w;                    // [9 * Cin, Cout], box [64, 64]
  const bf16* x;
  const bf16* om;
  float* dsamp;                     // [M * 9, Cin]
  ordered::Gather g;                // the (p, k, corner) list of d_x
  bf16* dom;
  int N, H, W, Cin, Cout;
  int tg;                           // taps per block
};

template <int BM>
constexpr int data_smem_bytes(int cout) {
  return 1024 + BM * ((cout + 63) / 64) * 64 * 2 + HD_RING * HD_BC * 64 * 2 +
         2 * BM * HD_LD * 4 + BM * static_cast<int>(sizeof(Tap)) + BM * 3 * 4 +
         (2 * HD_RING + 5) * 8;
}

template <int BM>
__global__ void __launch_bounds__(128 * (BM / 64 + 3), 1)
dcn_bwd_data_wgmma_kernel(const __grid_constant__ DataParams p) {
  constexpr int NC = BM / 64;                  // consumer warpgroups
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int ko = (p.Cout + 63) / 64;           // 64-wide Cout slices
  bf16* a_s = reinterpret_cast<bf16*>(base);                   // [ko][BM][64]
  bf16* b_s = a_s + ko * BM * 64;                              // [RING][64][64]
  float* ds = reinterpret_cast<float*>(b_s + HD_RING * HD_BC * 64);  // [2][BM][HD_LD]
  Tap* taps = reinterpret_cast<Tap*>(ds + 2 * BM * HD_LD);     // [BM]
  float* red = reinterpret_cast<float*>(taps + BM);            // [BM][3]
  uint64_t* bars = reinterpret_cast<uint64_t*>(red + BM * 3);
  uint64_t* full = bars;                       // [RING]
  uint64_t* empty = full + HD_RING;            // [RING]
  uint64_t* a_full = empty + HD_RING;
  uint64_t* ds_full = a_full + 1;              // [2]
  uint64_t* ds_empty = ds_full + 2;            // [2]

  const int M = p.N * p.H * p.W;
  const int bands = (M + BM - 1) / BM;
  const int m0 = (blockIdx.x % bands) * BM;
  const int k_begin = (blockIdx.x / bands) * p.tg;
  const int k_end = min(9, k_begin + p.tg);
  const int cs = (p.Cin + HD_BC - 1) / HD_BC;  // channel slices per tap
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < HD_RING; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], NC);
    }
    hop::mbar_init(a_full, 1);
    for (int b = 0; b < 2; ++b) {
      hop::mbar_init(&ds_full[b], 128 * NC);
      hop::mbar_init(&ds_empty[b], 256);
    }
    hop::mbar_fence_init();
  }
  for (int i = threadIdx.x; i < BM * 3; i += blockDim.x) red[i] = 0.f;
  __syncthreads();

  if (wg == 0) {
    // ---- producer: the d_out tile once, then the W9 slices ---------------
    if (t == 0) {
      hop::mbar_expect_tx(a_full, ko * BM * 64 * 2);
      for (int o = 0; o < ko; ++o)
        hop::tma_load_2d(a_s + o * BM * 64, &p.dout, a_full, o * 64, m0);
      hop::Ring<HD_RING> r;
      for (int k = k_begin; k < k_end; ++k)
        for (int c = 0; c < cs; ++c)
          for (int o = 0; o < ko; ++o) {
            hop::mbar_wait(&empty[r.stage], r.phase ^ 1u);
            hop::mbar_expect_tx(&full[r.stage], HD_BC * 64 * 2);
            hop::tma_load_2d(b_s + r.stage * HD_BC * 64, &p.w, &full[r.stage], o * 64,
                             k * p.Cin + c * HD_BC);
            r.next();
          }
    }
  } else if (wg <= NC) {
    // ---- consumers: d_samp[64 rows of the band, 64 channels] --------------
    const int cw = wg - 1, warp = t / 32, lane = t % 32;
    float acc[32];
    hop::Ring<HD_RING> r;
    hop::mbar_wait(a_full, 0);
    int tile = 0;
    for (int k = k_begin; k < k_end; ++k)
      for (int c = 0; c < cs; ++c, ++tile) {
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = 0.f;
        for (int o = 0; o < ko; ++o) {
          hop::mbar_wait(&full[r.stage], r.phase);
          const uint64_t da = hop::make_desc(a_s + (o * BM + cw * 64) * 64, 0, 1024);
          const uint64_t db = hop::make_desc(b_s + r.stage * HD_BC * 64, 0, 1024);
          hop::fence_regs<32>(acc);
          hop::wgmma_fence();
          hop::mma_slice<64, 0, 0>(acc, da, db);
          hop::wgmma_commit();
          hop::wgmma_wait<0>();
          hop::fence_regs<32>(acc);
          if (t == 0) hop::mbar_arrive(&empty[r.stage]);
          r.next();
        }
        const int b = tile & 1;
        hop::mbar_wait(&ds_empty[b], ((tile >> 1) & 1) ^ 1u);
        float* d = ds + b * BM * HD_LD + (cw * 64 + warp * 16 + lane / 4) * HD_LD + 2 * (lane & 3);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          *reinterpret_cast<float2*>(d + 8 * j) = make_float2(acc[4 * j], acc[4 * j + 1]);
          *reinterpret_cast<float2*>(d + 8 * HD_LD + 8 * j) =
              make_float2(acc[4 * j + 2], acc[4 * j + 3]);
        }
        hop::mbar_arrive(&ds_full[b]);
      }
  } else {
    // ---- scatter: two warpgroups, half a warp per pixel, 4 channels a lane;
    // half-warp hw owns the pixels hw, hw + 16, ... of the band
    const int st = threadIdx.x - 128 * (NC + 1);      // 0 .. 255
    const int lane = t % 32, q = lane & 15, hw = st / 16;
    int tile = 0;
    for (int k = k_begin; k < k_end; ++k) {
      asm volatile("bar.sync 1, 256;\n" ::: "memory");     // the last tap is read
      if (st < BM) {
        taps[st] = m0 + st < M ? make_tap(p.om, m0 + st, k, p.H, p.W) : empty_tap();
        if (m0 + st < M) list_tap(p.g, m0 + st, k, taps[st]);
      }
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      for (int c = 0; c < cs; ++c, ++tile) {
        const int b = tile & 1;
        hop::mbar_wait(&ds_full[b], (tile >> 1) & 1);
        const float* dsb = ds + b * BM * HD_LD;
        const int ch = c * HD_BC + 4 * q;
        const bool live = ch < p.Cin;
        for (int it = 0; it < BM / 16; it += 2) {
          // two pixels: every corner load first, then the arithmetic
          float v[2][4][4], d[2][4];
          Tap tp[2];
          bool on[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int pi = 16 * (it + u) + hw;
            tp[u] = taps[pi];
            on[u] = live && m0 + pi < M;
            const float4 d4 = on[u] ? *reinterpret_cast<const float4*>(dsb + pi * HD_LD + 4 * q)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
            if (on[u]) *reinterpret_cast<float4*>(samp_row(p.dsamp, m0 + pi, k, p.Cin, ch)) = d4;
            d[u][0] = d4.x; d[u][1] = d4.y; d[u][2] = d4.z; d[u][3] = d4.w;
#pragma unroll
            for (int cn = 0; cn < 4; ++cn) {
              if (on[u] && tp[u].off[cn] >= 0) {
                load4(p.x + static_cast<size_t>(tp[u].off[cn]) * p.Cin + ch, v[u][cn]);
              } else {
                v[u][cn][0] = v[u][cn][1] = v[u][cn][2] = v[u][cn][3] = 0.f;
              }
            }
          }
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int pi = 16 * (it + u) + hw;
            const Tap& tq = tp[u];
            // d(corner weight)/d fy and /d fx for corners 00, 01, 10, 11
            const float cy[4] = {-(1.f - tq.fx), -tq.fx, 1.f - tq.fx, tq.fx};
            const float cx[4] = {-(1.f - tq.fy), 1.f - tq.fy, -tq.fy, tq.fy};
            float gy = 0.f, gx = 0.f, gm = 0.f;
#pragma unroll
            for (int cn = 0; cn < 4; ++cn) {
              float dv = 0.f;                    // d_samp . corner value
#pragma unroll
              for (int e = 0; e < 4; ++e) dv += d[u][e] * v[u][cn][e];
              gy += cy[cn] * dv;
              gx += cx[cn] * dv;
              gm += tq.w[cn] * dv;
            }
#pragma unroll
            for (int sh = 8; sh > 0; sh >>= 1) {
              gy += __shfl_xor_sync(0xffffffffu, gy, sh);
              gx += __shfl_xor_sync(0xffffffffu, gx, sh);
              gm += __shfl_xor_sync(0xffffffffu, gm, sh);
            }
            if (q == 0) {
              red[pi * 3] += gy;
              red[pi * 3 + 1] += gx;
              red[pi * 3 + 2] += gm;
            }
          }
        }
        hop::mbar_arrive(&ds_empty[b]);
      }
      // this tap's three d_om channels, by the lanes that own the sums
      if (q == 0) {
        for (int it = 0; it < BM / 16; ++it) {
          const int pi = 16 * it + hw, pm = m0 + pi;
          if (pm < M) {
            const float s = taps[pi].sig;
            bf16* o = p.dom + static_cast<size_t>(pm) * 27;
            o[2 * k] = __float2bfloat16_rn(s * red[pi * 3]);
            o[2 * k + 1] = __float2bfloat16_rn(s * red[pi * 3 + 1]);
            o[18 + k] = __float2bfloat16_rn(red[pi * 3 + 2] * s * (1.f - s));
          }
          red[pi * 3] = red[pi * 3 + 1] = red[pi * 3 + 2] = 0.f;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// (b) d_W = sampled^T x d_out.  A block owns 64 rows of d_W (one tap, 64
// input channels), a BN-wide Cout tile and one split of the pixels.  Per
// 64-pixel slice a gather warpgroup writes the modulated sample, rounded
// to bfloat16 as the forward rounds it, straight into the 128-byte
// swizzled shared layout wgmma reads as a transposed (MN-major) A, with
// 16-byte stores, and its first thread brings the d_out slice by TMA, the
// transposed B.  Two gather warpgroups take the slices in turn, so eight
// warps keep corner loads in flight, while the consumer warpgroup
// multiplies (K = pixels); each split writes its float32 tile, and the
// split that completes a tile sums the tile's partials in split order.
// ---------------------------------------------------------------------------

constexpr int HW_RING = 4;
constexpr int HW_PX = 64;            // pixels per slice

struct WeightParams {
  CUtensorMap dout;                  // [M, Cout], box [64, 64]
  const bf16* x;
  const bf16* om;
  float* dw;
  float* part;                       // [splits, 9 * Cin, Cout] where splits > 1
  unsigned* tickets;                 // [tiles], zero between launches
  int N, H, W, Cin, Cout;
  int ctiles, ntiles, per_split;     // per_split: pixels, a multiple of 64
  int splits;
};

template <int BN>
constexpr int weight_smem_bytes() {
  return 1024 + HW_RING * (64 + BN) * HW_PX * 2 + 2 * HW_RING * 8 + 16;
}

template <int BN>
__global__ void __launch_bounds__(384, 1)
dcn_bwd_weight_wgmma_kernel(const __grid_constant__ WeightParams p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* a_s = base;                                    // [RING][64 px][128 B]
  unsigned char* b_s = a_s + HW_RING * 64 * HW_PX * 2;         // [RING][BN/64][64 px][128 B]
  uint64_t* full = reinterpret_cast<uint64_t*>(b_s + HW_RING * BN * HW_PX * 2);
  uint64_t* empty = full + HW_RING;
  int* sflag = reinterpret_cast<int*>(empty + HW_RING);

  const int M = p.N * p.H * p.W;
  int u = blockIdx.x;
  const int ct = u % p.ctiles; u /= p.ctiles;
  const int nt = u % p.ntiles; u /= p.ntiles;
  const int k = u % 9;
  const int split = u / 9;
  const int c0 = ct * 64, o0 = nt * BN;
  const int p_begin = split * p.per_split;
  const int p_end = min(M, p_begin + p.per_split);
  const int slices = (p_end - p_begin + HW_PX - 1) / HW_PX;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < HW_RING; ++s) {
      hop::mbar_init(&full[s], 129);       // the TMA arrival + 128 gatherers
      hop::mbar_init(&empty[s], 1);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (wg < 2) {
    // ---- gather warpgroup wg: slices wg, wg + 2, ...; pixel t % 64,
    // channels c0 + 32 (t / 64) .. + 32 (four 16-byte chunks)
    const int px = t % HW_PX, part = t / HW_PX;
    for (int sl = wg; sl < slices; sl += 2) {
      const int stage = sl % HW_RING;
      const uint32_t round = static_cast<uint32_t>(sl / HW_RING);
      hop::mbar_wait(&empty[stage], (round & 1u) ^ 1u);
      const int pb = p_begin + sl * HW_PX;
      if (t == 0) {
        hop::mbar_expect_tx(&full[stage], BN * HW_PX * 2);
        for (int nb = 0; nb < BN / 64; ++nb)
          hop::tma_load_2d(b_s + (stage * (BN / 64) + nb) * HW_PX * 128, &p.dout,
                           &full[stage], o0 + nb * 64, pb);
      }
      const int pm = pb + px;
      Tap tp = pm < p_end ? make_tap(p.om, pm, k, p.H, p.W) : empty_tap();
      uint4 raw[4][4];                     // [chunk][corner], all in flight
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ch = c0 + (part * 4 + j) * 8;
#pragma unroll
        for (int cn = 0; cn < 4; ++cn)
          raw[j][cn] = tp.off[cn] >= 0 && ch < p.Cin
                           ? __ldg(reinterpret_cast<const uint4*>(
                                 p.x + static_cast<size_t>(tp.off[cn]) * p.Cin + ch))
                           : make_uint4(0, 0, 0, 0);
      }
      unsigned char* row = a_s + stage * HW_PX * 128 + px * 128;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float a[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) a[e] = 0.f;
#pragma unroll
        for (int cn = 0; cn < 4; ++cn) {
          const float wc = tp.w[cn] * tp.sig;
          const __nv_bfloat162* hv = reinterpret_cast<const __nv_bfloat162*>(&raw[j][cn]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(hv[e]);
            a[2 * e] += wc * f.x;
            a[2 * e + 1] += wc * f.y;
          }
        }
        uint4 o;
        __nv_bfloat162* ho = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
        for (int e = 0; e < 4; ++e) ho[e] = __floats2bfloat162_rn(a[2 * e], a[2 * e + 1]);
        const int chunk = part * 4 + j;
        *reinterpret_cast<uint4*>(row + ((chunk ^ (px & 7)) << 4)) = o;
      }
      hop::fence_proxy_async();
      hop::mbar_arrive(&full[stage]);
    }
  } else {
    // ---- consumer: d_W rows c0 .. c0 + 64 over this split -----------------
    const int warp = t / 32, lane = t % 32;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    hop::Ring<HW_RING> r;
    for (int sl = 0; sl < slices; ++sl) {
      hop::mbar_wait(&full[r.stage], r.phase);
      const uint64_t da = hop::make_desc(a_s + r.stage * HW_PX * 128, 8192, 1024);
      const uint64_t db = hop::make_desc(b_s + r.stage * (BN / 64) * HW_PX * 128, 8192, 1024);
      hop::fence_regs<BN / 2>(acc);
      hop::wgmma_fence();
      hop::mma_slice<BN, 1, 1>(acc, da, db);
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs<BN / 2>(acc);
      if (t == 0) hop::mbar_arrive(&empty[r.stage]);
      r.next();
    }
    // this split's tile (d_W itself when there is one split)
    const size_t dw_size = static_cast<size_t>(9) * p.Cin * p.Cout;
    float* dst = p.splits == 1 ? p.dw : p.part + split * dw_size;
    const int c_a = c0 + warp * 16 + lane / 4;     // and c_a + 8
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = o0 + 8 * j + 2 * (lane & 3);
      if (col < p.Cout) {
        if (c_a < p.Cin)
          *reinterpret_cast<float2*>(dst + static_cast<size_t>(k * p.Cin + c_a) * p.Cout +
                                     col) = make_float2(acc[4 * j], acc[4 * j + 1]);
        if (c_a + 8 < p.Cin)
          *reinterpret_cast<float2*>(dst + static_cast<size_t>(k * p.Cin + c_a + 8) * p.Cout +
                                     col) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
    const int tiles = 9 * p.ctiles * p.ntiles;
    if (p.splits > 1 &&
        ordered::arrive(p.tickets + blockIdx.x % tiles, p.splits, t == 0, sflag,
                        [] { asm volatile("bar.sync 2, 128;\n" ::: "memory"); })) {
      for (int e = t; e < 64 * BN / 4; e += 128) {
        const int r = e / (BN / 4), col = o0 + (e % (BN / 4)) * 4;
        if (c0 + r >= p.Cin || col >= p.Cout) continue;
        const size_t at = static_cast<size_t>(k * p.Cin + c0 + r) * p.Cout + col;
        *reinterpret_cast<float4*>(p.dw + at) =
            ordered::sum_strided4(p.part + at, p.splits, dw_size);
      }
    }
  }
}

// The largest Cout whose d_out band the (a) kernel keeps in shared memory.
constexpr int kMaxHopperCout = 1024;

// The (a) kernels' workspace: the gather's lists of d_x, then d_samp.
struct DataWork {
  ordered::Gather g;
  float* dsamp;
};

inline size_t data_workspace(int N, int H, int W, int Cin) {
  const long long M = static_cast<long long>(N) * H * W;
  return ordered::workspace_bytes(M * 36, static_cast<int>(M)) +
         ordered::align256(static_cast<size_t>(M) * 9 * Cin * sizeof(float));
}

inline DataWork carve_data(void* work, unsigned* zeroed, int N, int H, int W) {
  const long long M = static_cast<long long>(N) * H * W;
  DataWork d;
  unsigned char* end = nullptr;
  d.g = ordered::carve(work, M * 36, static_cast<int>(M), zeroed, &end);
  d.dsamp = reinterpret_cast<float*>(end);
  return d;
}

// d_x from the listed (p, k, corner) entries and d_samp [M * 9, Cin].
inline int gather_dx(const DataWork& d, void* dx, int Cin, void* stream) {
  return ordered::gather_sum(d.g, d.dsamp, Cin, 4, static_cast<float*>(dx),
                             static_cast<cudaStream_t>(stream));
}

template <int BM>
int launch_data_wgmma(const void* x, const void* om, const void* w, const void* dout,
                      void* dx, void* dom, void* work, unsigned* zeroed, int N, int H,
                      int W, int Cin, int Cout, void* stream) {
  DataParams p{};
  const uint64_t M = static_cast<uint64_t>(N) * H * W;
  const uint64_t ddims[2] = {static_cast<uint64_t>(Cout), M};
  const uint64_t dstr[1] = {static_cast<uint64_t>(Cout) * 2};
  const uint32_t dbox[2] = {64, BM};
  const uint64_t wdims[2] = {static_cast<uint64_t>(Cout), 9ull * Cin};
  const uint32_t wbox[2] = {64, HD_BC};
  if (!hop::make_map(&p.dout, dout, 2, ddims, dstr, dbox) ||
      !hop::make_map(&p.w, w, 2, wdims, dstr, wbox))
    return static_cast<int>(cudaErrorInvalidValue);
  const DataWork d = carve_data(work, zeroed, N, H, W);
  p.x = static_cast<const bf16*>(x);
  p.om = static_cast<const bf16*>(om);
  p.dsamp = d.dsamp;
  p.g = d.g;
  p.dom = static_cast<bf16*>(dom);
  p.N = N; p.H = H; p.W = W; p.Cin = Cin; p.Cout = Cout;
  const int smem = data_smem_bytes<BM>(Cout);
  constexpr int threads = 128 * (BM / 64 + 3);
  cudaError_t err = cudaFuncSetAttribute(dcn_bwd_data_wgmma_kernel<BM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dcn_bwd_data_wgmma_kernel<BM>,
                                                      threads, smem);
  if (err != cudaSuccess || per_sm < 1)
    return static_cast<int>(err != cudaSuccess ? err : cudaErrorInvalidConfiguration);
  // Taps per block: a block pays a fixed start (its d_out band, the first
  // slices) of about 0.2 taps' work beside tg taps (fitted to the layer-3
  // and layer-4 shapes on an H100 80GB HBM3, 700 W, tg = 1 / 3 / 9), and
  // the blocks run in waves of per_sm per SM: minimize waves * (0.2 + tg).
  const int bands = static_cast<int>((M + BM - 1) / BM);
  const int slots = hop::sm_count() * per_sm;
  float best = 1e30f;
  for (int tg : {9, 3, 1}) {
    const int waves = (bands * (9 / tg) + slots - 1) / slots;
    const float cost = waves * (0.2f + tg);
    if (cost < best) { best = cost; p.tg = tg; }
  }
  const int grid = bands * ((9 + p.tg - 1) / p.tg);
  dcn_bwd_data_wgmma_kernel<BM><<<grid, threads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return gather_dx(d, dx, Cin, stream);
}

// The pixel splits of the (b) kernels: each fills whole waves of blocks.
// Hopper kernel (BN-wide Cout tiles): at least 4 slices of 64 pixels a
// split.  First kernel: about four blocks per SM in flight.
struct Splits {
  int per_split, splits;
};

template <int BN>
Splits wgmma_weight_splits(int M, int Cin, int Cout) {
  const int tiles = 9 * ((Cin + 63) / 64) * ((Cout + BN - 1) / BN), sms = hop::sm_count();
  const int slices = (M + HW_PX - 1) / HW_PX;
  int splits = 1;
  float best = -1.f;
  for (int s = 1; s <= 64 && (s == 1 || slices / s >= 4); ++s) {
    const int units = tiles * s, waves = (units + sms - 1) / sms;
    const float eff = static_cast<float>(units) / (waves * sms);
    if (eff > best + 0.02f) { best = eff; splits = s; }
  }
  Splits r;
  r.per_split = ((slices + splits - 1) / splits) * HW_PX;
  r.splits = (M + r.per_split - 1) / r.per_split;
  return r;
}

Splits first_weight_splits(int M, int Cin, int Cout) {
  const int tiles = 9 * ((Cin + WM - 1) / WM) * ((Cout + WN - 1) / WN);
  const int steps = (M + WK - 1) / WK;
  int splits = (4 * 132 + tiles - 1) / tiles;
  splits = splits < 1 ? 1 : (splits > steps ? steps : splits);
  Splits r;
  r.per_split = ((steps + splits - 1) / splits) * WK;
  r.splits = (M + r.per_split - 1) / r.per_split;
  return r;
}

// The splits the (b) entry of this dtype takes at this shape.
Splits weight_splits(bool bf16_in, int M, int Cin, int Cout) {
  if (!bf16_in || Cout > kMaxHopperCout) return first_weight_splits(M, Cin, Cout);
  return Cout <= 128 ? wgmma_weight_splits<128>(M, Cin, Cout)
                     : wgmma_weight_splits<256>(M, Cin, Cout);
}

template <int BN>
int launch_weight_wgmma(const void* x, const void* om, const void* dout, void* dw,
                        void* work, unsigned* zeroed, int N, int H, int W, int Cin,
                        int Cout, void* stream) {
  WeightParams p{};
  const int M = N * H * W;
  const uint64_t ddims[2] = {static_cast<uint64_t>(Cout), static_cast<uint64_t>(M)};
  const uint64_t dstr[1] = {static_cast<uint64_t>(Cout) * 2};
  const uint32_t dbox[2] = {64, HW_PX};
  if (!hop::make_map(&p.dout, dout, 2, ddims, dstr, dbox))
    return static_cast<int>(cudaErrorInvalidValue);
  p.x = static_cast<const bf16*>(x);
  p.om = static_cast<const bf16*>(om);
  p.dw = static_cast<float*>(dw);
  p.part = static_cast<float*>(work);
  p.tickets = zeroed;
  p.N = N; p.H = H; p.W = W; p.Cin = Cin; p.Cout = Cout;
  p.ctiles = (Cin + 63) / 64;
  p.ntiles = (Cout + BN - 1) / BN;
  const Splits sp = wgmma_weight_splits<BN>(M, Cin, Cout);
  p.per_split = sp.per_split;
  p.splits = sp.splits;
  const int tiles = 9 * p.ctiles * p.ntiles;
  constexpr int smem = weight_smem_bytes<BN>();
  cudaError_t err = cudaFuncSetAttribute(dcn_bwd_weight_wgmma_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dcn_bwd_weight_wgmma_kernel<BN><<<tiles * p.splits, 384, smem,
                                    static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_data(const void* x, const void* om, const void* w, const void* dout,
                void* dx, void* dom, void* work, unsigned* zeroed, int N, int H, int W,
                int Cin, int Cout, void* stream) {
  const int M = N * H * W;
  const DataWork d = carve_data(work, zeroed, N, H, W);
  dcn_bwd_data_kernel<T><<<(M + BM - 1) / BM, NT, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(om),
      static_cast<const T*>(w), static_cast<const T*>(dout), d.dsamp, d.g,
      static_cast<T*>(dom), N, H, W, Cin, Cout);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return gather_dx(d, dx, Cin, stream);
}

template <typename T>
int launch_weight(const void* x, const void* om, const void* dout, void* dw, void* work,
                  unsigned* zeroed, int N, int H, int W, int Cin, int Cout, void* stream) {
  const int M = N * H * W;
  const Splits sp = first_weight_splits(M, Cin, Cout);
  dim3 grid(9 * ((Cin + WM - 1) / WM), (Cout + WN - 1) / WN, sp.splits);
  dcn_bwd_weight_kernel<T><<<grid, WNT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(om),
      static_cast<const T*>(dout), static_cast<float*>(dw), static_cast<float*>(work),
      zeroed, N, H, W, Cin, Cout, sp.per_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of workspace (a) needs: the gather's lists and d_samp.
extern "C" long long dcn_backward_data_workspace(int N, int H, int W, int Cin) {
  return static_cast<long long>(data_workspace(N, H, W, Cin));
}

// Bytes of workspace (b) needs: one partial d_W a pixel split where
// there are several (bf16: the bfloat16 entry, else the float32 one).
extern "C" long long dcn_backward_weight_workspace(int bf16_in, int N, int H, int W,
                                                   int Cin, int Cout) {
  const Splits sp = weight_splits(bf16_in != 0, N * H * W, Cin, Cout);
  return sp.splits > 1 ? static_cast<long long>(sp.splits) * 9 * Cin * Cout * 4 : 0;
}

// (a): d_x (float32, written whole) and d_om; `work` holds
// dcn_backward_data_workspace() bytes, `zeroed` N*H*W zero int32 (left
// zero).
extern "C" int dcn_backward_data_bf16(const void* x, const void* om,
                                      const void* w, const void* dout,
                                      void* dx, void* dom, void* work, void* zeroed,
                                      int N, int H, int W, int Cin, int Cout,
                                      void* stream) {
  unsigned* z = static_cast<unsigned*>(zeroed);
  if (Cout > kMaxHopperCout)
    return launch_data<bf16>(x, om, w, dout, dx, dom, work, z, N, H, W, Cin, Cout, stream);
  if (Cout <= 256)
    return launch_data_wgmma<128>(x, om, w, dout, dx, dom, work, z, N, H, W, Cin, Cout,
                                  stream);
  return launch_data_wgmma<64>(x, om, w, dout, dx, dom, work, z, N, H, W, Cin, Cout,
                               stream);
}

extern "C" int dcn_backward_data_f32(const void* x, const void* om,
                                     const void* w, const void* dout,
                                     void* dx, void* dom, void* work, void* zeroed,
                                     int N, int H, int W, int Cin, int Cout,
                                     void* stream) {
  return launch_data<float>(x, om, w, dout, dx, dom, work, static_cast<unsigned*>(zeroed),
                            N, H, W, Cin, Cout, stream);
}

// (b): d_w (float32 [9*Cin, Cout], written whole); `work` holds
// dcn_backward_weight_workspace() bytes, `zeroed` one zero int32 a d_W
// tile (left zero).
extern "C" int dcn_backward_weight_bf16(const void* x, const void* om,
                                        const void* dout, void* dw, void* work,
                                        void* zeroed, int N, int H, int W, int Cin,
                                        int Cout, void* stream) {
  unsigned* z = static_cast<unsigned*>(zeroed);
  if (Cout > kMaxHopperCout)
    return launch_weight<bf16>(x, om, dout, dw, work, z, N, H, W, Cin, Cout, stream);
  if (Cout <= 128)
    return launch_weight_wgmma<128>(x, om, dout, dw, work, z, N, H, W, Cin, Cout, stream);
  return launch_weight_wgmma<256>(x, om, dout, dw, work, z, N, H, W, Cin, Cout, stream);
}

extern "C" int dcn_backward_weight_f32(const void* x, const void* om,
                                       const void* dout, void* dw, void* work,
                                       void* zeroed, int N, int H, int W, int Cin,
                                       int Cout, void* stream) {
  return launch_weight<float>(x, om, dout, dw, work, static_cast<unsigned*>(zeroed), N, H,
                              W, Cin, Cout, stream);
}
