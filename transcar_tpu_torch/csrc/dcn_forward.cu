// DCNv2 forward (3x3, stride 1, pad 1, dilation 1) as an implicit GEMM.
//
// Replaces transcar_tpu/ops/pallas_dcn.py::fused_deform_conv.  The
// wrapper, the bound and the design are described in
// transcar_tpu_torch/ops/pallas_dcn.py.
//
//   out[p, o] = sum_{k, c} sampled[p, k*Cin + c] * w[k*Cin + c, o]
//   sampled[p, k*Cin + c] = round_T(sigmoid(m_k) * bilinear(x[n, :, :, c],
//                                   i - 1 + k/3 + dy_k, j - 1 + k%3 + dx_k))
//
// with p = (n*H + i)*W + j, zero padding outside the image, and all
// coordinate math in float32.  Layouts: x [N,H,W,Cin], offset_mask
// [N,H,W,27] (ch 2k = dy_k, 2k+1 = dx_k, 18+k = mask logit), w
// [3,3,Cin,Cout] = [9*Cin, Cout] row-major, out [N,H,W,Cout]; all
// contiguous.  Requires Cin % 32 == 0, Cout % 8 == 0, 16-byte aligned x
// and w (checked by the wrapper).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int BM = 64;          // output pixels per block
constexpr int BN = 128;         // output channels per block
constexpr int BK = 32;          // K (= tap-major input channels) per step
constexpr int NT = 128;         // threads per block (4 warps)
constexpr int A_LD = BK + 8;    // padded smem row lengths (elements); keep
constexpr int B_LD = BN + 8;    // wmma pointers 32-byte aligned

using bf16 = __nv_bfloat16;

// One (pixel, tap): the four bilinear corners as pixel indices into x
// (-1 = outside the image) and their weights with sigma(mask) folded in.
struct Tap {
  int off[4];
  float w[4];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

// 16 contiguous elements <-> 16 floats, with 16-byte vector accesses.
__device__ __forceinline__ void load16(const float* p, float* f) {
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    float4 t = q[v];
    f[4 * v] = t.x; f[4 * v + 1] = t.y; f[4 * v + 2] = t.z; f[4 * v + 3] = t.w;
  }
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

// 8 contiguous elements, 16-byte aligned for bf16 (one uint4) and for
// float (two float4).
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

template <typename T>
__global__ void __launch_bounds__(NT)
dcn_forward_kernel(const T* __restrict__ x, const T* __restrict__ om,
                   const T* __restrict__ w, T* __restrict__ out,
                   int N, int H, int W, int Cin, int Cout) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  __shared__ Tap taps[BM * 9];
  __shared__ __align__(32) T a_s[BM * A_LD];
  __shared__ __align__(32) T b_s[BK * B_LD];
  __shared__ __align__(32) float stage[kBf16 ? 4 * 256 : 1];

  const int HW = H * W;
  const int M = N * HW;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;

  // 1. Sampling table: once per (pixel, tap), float32 throughout.
  for (int e = tid; e < BM * 9; e += NT) {
    const int mi = e / 9, k = e - mi * 9;
    const int p = m0 + mi;
    Tap t;
#pragma unroll
    for (int c = 0; c < 4; ++c) { t.off[c] = -1; t.w[c] = 0.f; }
    if (p < M) {
      const int n = p / HW, r = p - n * HW, i = r / W, j = r - i * W;
      const T* o = om + static_cast<size_t>(p) * 27;
      const float py = static_cast<float>(i - 1 + k / 3) + to_float(o[2 * k]);
      const float px = static_cast<float>(j - 1 + k % 3) + to_float(o[2 * k + 1]);
      const float mk = 1.f / (1.f + expf(-to_float(o[18 + k])));
      const float y0f = floorf(py), x0f = floorf(px);
      const float fy = py - y0f, fx = px - x0f;
      const int y0 = static_cast<int>(y0f), x0 = static_cast<int>(x0f);
      const float wy[2] = {1.f - fy, fy};
      const float wx[2] = {1.f - fx, fx};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int yy = y0 + (c >> 1), xx = x0 + (c & 1);
        if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
          t.off[c] = (n * H + yy) * W + xx;
          t.w[c] = wy[c >> 1] * wx[c & 1] * mk;
        }
      }
    }
    taps[e] = t;
  }

  // Accumulators: wmma fragments (bf16) or an 8x8 register tile (float).
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;          // warp tile 32 x 64
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> acc[2][4];
  float facc[8][8];
  const int tx = tid & 15, ty = tid >> 4;           // float: rows ty+8i, cols tx+16j
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
  __syncthreads();

  const int csteps = Cin / BK;
  for (int s = 0; s < 9 * csteps; ++s) {
    const int k = s / csteps;
    const int c0 = (s - k * csteps) * BK;

    // 2. B tile: rows k*Cin + c0 .. +BK of w, columns n0 .. n0+BN.
    for (int e = tid; e < BK * (BN / 8); e += NT) {
      const int r = e / (BN / 8), cv = (e - r * (BN / 8)) * 8;
      T* dst = b_s + r * B_LD + cv;
      if (n0 + cv < Cout)
        copy8(dst, w + static_cast<size_t>(k * Cin + c0 + r) * Cout + n0 + cv);
      else
        zero8(dst);
    }

    // 3. A tile: two threads per pixel, 16 channels each, 4 gathered corners.
    {
      const int mi = tid >> 1, ch = (tid & 1) * 16;
      const Tap& t = taps[mi * 9 + k];
      float a[16];
#pragma unroll
      for (int q = 0; q < 16; ++q) a[q] = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (t.off[c] >= 0) {
          float v[16];
          load16(x + static_cast<size_t>(t.off[c]) * Cin + c0 + ch, v);
#pragma unroll
          for (int q = 0; q < 16; ++q) a[q] += t.w[c] * v[q];
        }
      }
      store16(a_s + mi * A_LD + ch, a);
    }
    __syncthreads();

    // 4. Multiply.
    if constexpr (kBf16) {
      using namespace nvcuda;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], a_s + (wm * 32 + i * 16) * A_LD + kk, A_LD);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::load_matrix_sync(fb[j], b_s + kk * B_LD + wn * 64 + j * 16, B_LD);
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
        for (int i = 0; i < 8; ++i) av[i] = to_float(a_s[(ty + 8 * i) * A_LD + kk]);
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = to_float(b_s[kk * B_LD + tx + 16 * j]);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) facc[i][j] += av[i] * bv[j];
      }
    }
    __syncthreads();
  }

  // 5. Epilogue: float32 accumulators -> T.
  if constexpr (kBf16) {
    float* st = stage + warp * 256;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        nvcuda::wmma::store_matrix_sync(st, acc[i][j], 16, nvcuda::wmma::mem_row_major);
        __syncwarp();
        const int r = lane >> 1, cc = (lane & 1) * 8;
        const int p = m0 + wm * 32 + i * 16 + r;
        const int col = n0 + wn * 64 + j * 16 + cc;
        if (p < M && col < Cout) {
          uint4 u;
          __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            h[q] = __floats2bfloat162_rn(st[r * 16 + cc + 2 * q], st[r * 16 + cc + 2 * q + 1]);
          *reinterpret_cast<uint4*>(out + static_cast<size_t>(p) * Cout + col) = u;
        }
        __syncwarp();
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int p = m0 + ty + 8 * i;
      if (p >= M) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + tx + 16 * j;
        if (col < Cout) out[static_cast<size_t>(p) * Cout + col] = facc[i][j];
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* om, const void* w, void* out, int N,
           int H, int W, int Cin, int Cout, void* stream) {
  const int M = N * H * W;
  dim3 grid((M + BM - 1) / BM, (Cout + BN - 1) / BN);
  dcn_forward_kernel<T><<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(om),
      static_cast<const T*>(w), static_cast<T*>(out), N, H, W, Cin, Cout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dcn_forward_bf16(const void* x, const void* om, const void* w,
                                void* out, int N, int H, int W, int Cin,
                                int Cout, void* stream) {
  return launch<bf16>(x, om, w, out, N, H, W, Cin, Cout, stream);
}

extern "C" int dcn_forward_f32(const void* x, const void* om, const void* w,
                               void* out, int N, int H, int W, int Cin,
                               int Cout, void* stream) {
  return launch<float>(x, om, w, out, N, H, W, Cin, Cout, stream);
}
