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
//   d_x[corner, c] += s_k * bw_corner * d_samp[p, k, c]             (fp32 atomics)
//   d_om[p, 2k]     = s_k * sum_c d_samp * d bilinear / d py         (floor
//   d_om[p, 2k+1]   = s_k * sum_c d_samp * d bilinear / d px          convention)
//   d_om[p, 18+k]   = s_k (1 - s_k) * sum_c d_samp * bilinear
//   d_w[k*Cin + c, o] += sum_p round_T(s_k * bilinear)[p, k, c] * d_out[p, o]
//
// The derivative at an integer sample position is the one-sided one of
// the floor convention: py = y0 exactly gives (row y0+1) - (row y0).
// Layouts: x [N,H,W,Cin], om [N,H,W,27] (ch 2k = dy_k, 2k+1 = dx_k,
// 18+k = mask logit), w [9*Cin, Cout] row-major, d_out [N,H,W,Cout], all
// of the working type T and contiguous; d_x [N,H,W,Cin] and d_w
// [9*Cin, Cout] are float32 and zeroed by the caller; d_om is T.
// Requires Cin % 32 == 0, Cout % 8 == 0 and 16-byte aligned tensors
// (checked by the wrapper).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

// One (pixel, tap): four corners as pixel indices into x (-1 = outside
// the image), their bilinear weights without the mask, the mask
// sigmoid(m) and the fractions (fy, fx) of the sample position.
struct Tap {
  int off[4];
  float w[4];
  float sig, fy, fx;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__device__ __forceinline__ Tap make_tap(const T* __restrict__ om, int p, int k,
                                        int H, int W) {
  Tap t;
  const int HW = H * W;
  const int n = p / HW, r = p - n * HW, i = r / W, j = r - i * W;
  const T* o = om + static_cast<size_t>(p) * 27;
  const float py = static_cast<float>(i - 1 + k / 3) + to_float(o[2 * k]);
  const float px = static_cast<float>(j - 1 + k % 3) + to_float(o[2 * k + 1]);
  t.sig = 1.f / (1.f + expf(-to_float(o[18 + k])));
  const float y0f = floorf(py), x0f = floorf(px);
  t.fy = py - y0f;
  t.fx = px - x0f;
  const int y0 = static_cast<int>(y0f), x0 = static_cast<int>(x0f);
  const float wy[2] = {1.f - t.fy, t.fy};
  const float wx[2] = {1.f - t.fx, t.fx};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int yy = y0 + (c >> 1), xx = x0 + (c & 1);
    const bool in = yy >= 0 && yy < H && xx >= 0 && xx < W;
    t.off[c] = in ? (n * H + yy) * W + xx : -1;
    t.w[c] = in ? wy[c >> 1] * wx[c & 1] : 0.f;
  }
  return t;
}

__device__ __forceinline__ Tap empty_tap() {
  Tap t;
#pragma unroll
  for (int c = 0; c < 4; ++c) { t.off[c] = -1; t.w[c] = 0.f; }
  t.sig = t.fy = t.fx = 0.f;
  return t;
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

// Four float32 atomic adds in one 16-byte vector atomic (sm_90).
__device__ __forceinline__ void atomic_add4(float* p, float a, float b,
                                            float c, float d) {
  atomicAdd(reinterpret_cast<float4*>(p), make_float4(a, b, c, d));
}

// ---------------------------------------------------------------------------
// (a) d_x, d_offset and d_mask.  A block owns BM pixels; for each tap and
// each BC-channel slice it first forms d_samp = d_out x w_k^T on the
// tensor cores (bf16; float32 takes a CUDA-core FMA loop, no TF32), then
// every warp walks 16 of the pixels with one lane per 4 channels: it
// gathers the 4 corners, scatters s_k * bw * d_samp into d_x and reduces
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
                    float* __restrict__ dx, T* __restrict__ dom,
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
            const float g = t.sig * t.w[c];
            atomic_add4(dx + base, g * d[0], g * d[1], g * d[2], g * d[3]);
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
// CUDA-core FMAs).  The splits add their fp32 partial tiles with atomics.
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
                      int N, int H, int W, int Cin, int Cout, int per_split) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  __shared__ Tap taps[WK];
  __shared__ __align__(32) T s_s[WK * S_LD];
  __shared__ __align__(32) T d_s[WK * D_LD];
  __shared__ __align__(32) float stage[kBf16 ? 8 * 256 : 1];

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

  // Epilogue: add the partial tile into d_w (float32).
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
          float* dst = dw + static_cast<size_t>(k * Cin + c) * Cout + col;
          const float* s = st + r * 16 + cc;
          atomic_add4(dst, s[0], s[1], s[2], s[3]);
          atomic_add4(dst + 4, s[4], s[5], s[6], s[7]);
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
        if (col < Cout) atomicAdd(dw + static_cast<size_t>(k * Cin + c) * Cout + col, facc[i][j]);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* om, const void* w, const void* dout,
           void* dx, void* dom, void* dw, int N, int H, int W, int Cin,
           int Cout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = N * H * W;
  dcn_bwd_data_kernel<T><<<(M + BM - 1) / BM, NT, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(om),
      static_cast<const T*>(w), static_cast<const T*>(dout),
      static_cast<float*>(dx), static_cast<T*>(dom), N, H, W, Cin, Cout);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // Split the pixels so that about four blocks per SM are in flight.
  const int tiles = 9 * ((Cin + WM - 1) / WM) * ((Cout + WN - 1) / WN);
  const int steps = (M + WK - 1) / WK;
  int splits = (4 * 132 + tiles - 1) / tiles;
  splits = splits < 1 ? 1 : (splits > steps ? steps : splits);
  const int per_split = ((steps + splits - 1) / splits) * WK;
  splits = (M + per_split - 1) / per_split;
  dim3 grid(9 * ((Cin + WM - 1) / WM), (Cout + WN - 1) / WN, splits);
  dcn_bwd_weight_kernel<T><<<grid, WNT, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(om),
      static_cast<const T*>(dout), static_cast<float*>(dw), N, H, W, Cin,
      Cout, per_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dcn_backward_bf16(const void* x, const void* om, const void* w,
                                 const void* dout, void* dx, void* dom,
                                 void* dw, int N, int H, int W, int Cin,
                                 int Cout, void* stream) {
  return launch<bf16>(x, om, w, dout, dx, dom, dw, N, H, W, Cin, Cout, stream);
}

extern "C" int dcn_backward_f32(const void* x, const void* om, const void* w,
                                const void* dout, void* dx, void* dom,
                                void* dw, int N, int H, int W, int Cin,
                                int Cout, void* stream) {
  return launch<float>(x, om, w, dout, dx, dom, dw, N, H, W, Cin, Cout, stream);
}
