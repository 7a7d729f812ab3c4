// int8 serving mode (model.backbone.quantize=int8): the activation quantize
// pass and the int8 x int8 -> int32 implicit-GEMM convolution with its
// dequantizing epilogue.
//
// Replaces no TPU kernel: the JAX package runs this convolution in XLA
// (transcar_tpu/ops/int8.py:48 dynamic_int8_conv, lax.conv_general_dilated
// on int8 operands with preferred_element_type=int32), not in Pallas.  It
// exists because PyTorch has no int8 convolution on CUDA (F.conv2d refuses
// int8 tensors), and an int8 mode computed in bfloat16 or float32 would not
// be one.  The wrapper, the bound and the design notes are in
// transcar_tpu_torch/ops/int8.py.
//
// Entries (plain C, each returns a cudaError_t):
// - int8_quantize: s = max(max|x|, 1e-8) / 127 into a device scalar, then
//   q = clip(rint(x / s), -127, 127) as int8 in x's memory order.  Two
//   kernels: an amax reduction (float bits of |x|, which order as unsigned
//   integers, meet in one atomicMax per block) and an elementwise pass that
//   reads the amax back on the device.  The codes are those of an IEEE
//   division rounded half to even, as the plain version and XLA compute
//   them (a multiply by 1/s, checked against the division near a tie).
// - int8_conv: out[m, c] = float(sum_k A[m, k] * B[c, k]) * (s_x * s_w[c])
//   rounded once to the output type, M = N*Ho*Wo output pixels, K =
//   KH*KW*Cin.  A is gathered from the NHWC int8 codes with zero padding;
//   B is the [Cout, Kp] int8 weight codes, k = (ky*KW + kx)*Cin + ci, zero
//   past K (Kp a multiple of 64).  The int32 sum is exact, so the result
//   equals the plain version's (a float64 convolution of the same codes)
//   bit for bit.
//
// The conv tile: 128 pixels x 128 channels a block of 8 warps (64
// channels and 4 warps where Cout < 128), each warp 64 x 32 as 4 x 4
// mma.sync m16n8k32 s8 products on ldmatrix fragments, K in steps of 64
// bytes through a 3-stage cp.async ring (rows padded to 80 bytes, so each
// 8-row ldmatrix phase hits 32 distinct banks).  A bfloat16 tile is staged
// in shared memory and stored in 16-byte row chunks.  With Cin % 16 == 0 (every
// convolution of the two int8 presets but the stem) a 16-byte chunk of a
// row lies inside one tap and is one cp.async with zero fill at the image
// edge and past K; the stem (Cin = 3) gathers its chunks byte by byte.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int BM = 128;
constexpr int BK = 64;
constexpr int STAGES = 3;
constexpr int LDS = BK + 16;  // row pitch in bytes
constexpr int A_BYTES = BM * LDS;

// BN output channels a block: 2 x (BN / 32) warps of 64 x 32 each.
template <int BN>
struct Tile {
  static constexpr int THREADS = 2 * BN;
  static constexpr int B_BYTES = BN * LDS;
  static constexpr int SMEM_BYTES = STAGES * (A_BYTES + B_BYTES);
  static constexpr int OUT_LDS = BN + 8;  // bf16 staging pitch (elements)
  static_assert(BM * OUT_LDS * 2 <= SMEM_BYTES, "staging fits the ring");
};

struct ConvParams {
  const int8_t* x;  // [N, H, W, Cin]
  const int8_t* w;  // [Cout, Kp]
  const float* sx;  // device scalar
  const float* sw;  // [Cout]
  void* out;        // [M, Cout]
  int N, H, W, Cin, Cout, KH, KW, stride, pad, Ho, Wo, M, K, Kp;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;  // 0: nothing is read, 16 zero bytes land
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8 x 16-byte matrices; lanes 8j..8j+7 give matrix j's row addresses.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One stage of A: this thread's 16-byte chunk `chunk` of the rows row0 +
// (THREADS / 4) i (i < ROWS), at K step kt.  rn[i] < 0 marks a row past M.
template <bool VEC, int ROWS, int STEP>
__device__ __forceinline__ void load_a(const ConvParams& p, int8_t* as,
                                       int kt, const int* rn, const int* ry,
                                       const int* rx, int chunk, int row0) {
  const int kbase = kt * BK + chunk * 16;
  if constexpr (VEC) {
    const int tap = kbase / p.Cin;
    const int ci = kbase - tap * p.Cin;
    const int ky = tap / p.KW;
    const int kx = tap - ky * p.KW;
    const bool kok = kbase < p.K;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int iy = ry[i] + ky;
      const int ix = rx[i] + kx;
      const bool ok = kok && rn[i] >= 0 && iy >= 0 && iy < p.H && ix >= 0 &&
                      ix < p.W;
      const int8_t* src =
          ok ? p.x + ((static_cast<size_t>(rn[i]) * p.H + iy) * p.W + ix) *
                             p.Cin + ci
             : p.x;
      cp_async16(as + (row0 + STEP * i) * LDS + chunk * 16, src, ok);
    }
  } else {
    uint32_t words[ROWS][4];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) words[i][j] = 0u;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int k = kbase + j;
      const int tap = k / p.Cin;
      const int ci = k - tap * p.Cin;
      const int ky = tap / p.KW;
      const int kx = tap - ky * p.KW;
      const bool kok = k < p.K;
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int iy = ry[i] + ky;
        const int ix = rx[i] + kx;
        if (kok && rn[i] >= 0 && iy >= 0 && iy < p.H && ix >= 0 && ix < p.W) {
          const uint8_t v = static_cast<uint8_t>(
              p.x[((static_cast<size_t>(rn[i]) * p.H + iy) * p.W + ix) *
                      p.Cin + ci]);
          words[i][j >> 2] |= static_cast<uint32_t>(v) << (8 * (j & 3));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
      *reinterpret_cast<uint4*>(as + (row0 + STEP * i) * LDS + chunk * 16) =
          make_uint4(words[i][0], words[i][1], words[i][2], words[i][3]);
  }
}

__device__ __forceinline__ float dequant(int acc, float scale) {
  return __fmul_rn(__int2float_rn(acc), scale);
}

template <int BN, bool VEC, typename OutT>
__global__ void __launch_bounds__(Tile<BN>::THREADS)
    int8_conv_kernel(const __grid_constant__ ConvParams p) {
  using T = Tile<BN>;
  constexpr int STEP = T::THREADS / 4;  // rows one pass of the block loads
  constexpr int A_ROWS = BM / STEP;
  constexpr int B_ROWS = BN / STEP;
  extern __shared__ __align__(16) uint8_t smem[];
  int8_t* as_all = reinterpret_cast<int8_t*>(smem);
  int8_t* bs_all = as_all + STAGES * A_BYTES;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int chunk = tid & 3;
  const int row0 = tid >> 2;

  int rn[A_ROWS], ry[A_ROWS], rx[A_ROWS];
  const int hw = p.Ho * p.Wo;
#pragma unroll
  for (int i = 0; i < A_ROWS; ++i) {
    const int m = m0 + row0 + STEP * i;
    if (m < p.M) {
      const int n = m / hw;
      const int rem = m - n * hw;
      const int oy = rem / p.Wo;
      const int ox = rem - oy * p.Wo;
      rn[i] = n;
      ry[i] = oy * p.stride - p.pad;
      rx[i] = ox * p.stride - p.pad;
    } else {
      rn[i] = -1;
      ry[i] = 0;
      rx[i] = 0;
    }
  }

  const int KT = p.Kp / BK;
  auto load = [&](int stage, int kt) {
    load_a<VEC, A_ROWS, STEP>(p, as_all + stage * A_BYTES, kt, rn, ry, rx,
                              chunk, row0);
    int8_t* bs = bs_all + stage * T::B_BYTES;
#pragma unroll
    for (int i = 0; i < B_ROWS; ++i) {
      const int r = row0 + STEP * i;
      const int c = n0 + r;
      const bool ok = c < p.Cout;
      const int8_t* src =
          ok ? p.w + static_cast<size_t>(c) * p.Kp + kt * BK + chunk * 16
             : p.w;
      cp_async16(bs + r * LDS + chunk * 16, src, ok);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();  // one group a stage, empty or not
  }

  const int wm = (warp & 1) * 64;
  const int wn = (warp >> 1) * 32;
  const int g = lane >> 2;
  const int t2 = (lane & 3) * 2;
  // ldmatrix row addresses: A matrix j = rows (j & 1) * 8 + r, bytes
  // (j >> 1) * 16; B matrix j = n-tile j >> 1, rows r, bytes (j & 1) * 16
  const int lr = lane & 7;
  const int lj = lane >> 3;
  const int a_off = (wm + (lj & 1) * 8 + lr) * LDS + (lj >> 1) * 16;
  const int b_off = (wn + (lj >> 1) * 8 + lr) * LDS + (lj & 1) * 16;
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed; stage kt - 1 is free
    const int nk = kt + STAGES - 1;
    if (nk < KT) load(nk % STAGES, nk);
    cp_async_commit();
    const int8_t* as = as_all + (kt % STAGES) * A_BYTES;
    const int8_t* bs = bs_all + (kt % STAGES) * T::B_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi], as + a_off + mi * 16 * LDS + kk);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r[4];
        ldmatrix_x4(r, bs + b_off + nj * 16 * LDS + kk);
        bf[2 * nj][0] = r[0];
        bf[2 * nj][1] = r[1];
        bf[2 * nj + 1][0] = r[2];
        bf[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
  }
  cp_async_wait<0>();

  // epilogue: float(acc) * (s_x * s_w[c]), each product rounded on its own
  // (__fmul_rn: never contracted into an FMA), then one rounding to OutT
  const float sx = *p.sx;
  float sc[4][2];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = n0 + wn + ni * 8 + t2 + e;
      sc[ni][e] = col < p.Cout ? __fmul_rn(sx, p.sw[col]) : 0.f;
    }
  if constexpr (std::is_same<OutT, __nv_bfloat16>::value) {
    // staged through shared memory, then 16-byte row-contiguous stores
    __syncthreads();  // every warp is done with the ring
    __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(smem);
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int r = wm + mi * 16 + g + 8 * h;
          const int c = wn + ni * 8 + t2;
          *reinterpret_cast<__nv_bfloat162*>(st + r * T::OUT_LDS + c) =
              __floats2bfloat162_rn(dequant(acc[mi][ni][2 * h], sc[ni][0]),
                                    dequant(acc[mi][ni][2 * h + 1],
                                            sc[ni][1]));
        }
    __syncthreads();
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
    constexpr int CHUNKS = BN / 8;  // 16-byte chunks a row
    const bool vec_ok = (p.Cout & 7) == 0;
    for (int e = tid; e < BM * CHUNKS; e += T::THREADS) {
      const int r = e / CHUNKS;
      const int c = (e - r * CHUNKS) * 8;
      const int row = m0 + r;
      const int col = n0 + c;
      if (row >= p.M || col >= p.Cout) continue;
      const __nv_bfloat16* src = st + r * T::OUT_LDS + c;
      __nv_bfloat16* dst = out + static_cast<size_t>(row) * p.Cout + col;
      if (vec_ok && col + 8 <= p.Cout) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int k = 0; k < 8 && col + k < p.Cout; ++k) dst[k] = src[k];
      }
    }
  } else {
    float* out = static_cast<float*>(p.out);
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn + ni * 8 + t2;
      if (col >= p.Cout) continue;
      const bool second = col + 1 < p.Cout;
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + wm + mi * 16 + g + 8 * h;
          if (row >= p.M) continue;
          float* o = out + static_cast<size_t>(row) * p.Cout + col;
          o[0] = dequant(acc[mi][ni][2 * h], sc[ni][0]);
          if (second) o[1] = dequant(acc[mi][ni][2 * h + 1], sc[ni][1]);
        }
    }
  }
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

constexpr int Q_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(Q_THREADS)
    int8_amax_kernel(const T* x, long long n, int vec, unsigned* amax) {
  const long long start = static_cast<long long>(blockIdx.x) * blockDim.x +
                          threadIdx.x;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  float m = 0.f;
  long long done = 0;
  if (vec) {
    done = n / 8 * 8;
    for (long long i = start; i < n / 8; i += step) {
      float v[8];
      load8(x + 8 * i, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(v[j]));
    }
  }
  for (long long i = done + start; i < n; i += step)
    m = fmaxf(m, fabsf(to_float(x[i])));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float warp_max[Q_THREADS / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < Q_THREADS / 32; ++w) m = fmaxf(m, warp_max[w]);
    atomicMax(amax, __float_as_uint(m));
  }
}

// clip(rint(v / s), -127, 127) with v / s the IEEE quotient, rounded half
// to even.  v * (1/s) is within 3 ulps of v / s, which is < 2.3e-5 while
// |v / s| < 128, so both round to the same integer unless a half-integer
// lies within 1e-4 of v * (1/s): only then is the true division taken.
__device__ __forceinline__ int8_t code(float v, float s, float inv) {
  float y = v * inv;
  if (fabsf(y - floorf(y) - 0.5f) < 1e-4f && fabsf(y) < 128.f)
    y = __fdiv_rn(v, s);
  const float r = rintf(y);
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(r, -127.f), 127.f)));
}

template <typename T>
__global__ void __launch_bounds__(Q_THREADS)
    int8_quantize_kernel(const T* x, long long n, int vec,
                         const unsigned* amax, int8_t* q, float* scale) {
  const float s = __fdiv_rn(fmaxf(__uint_as_float(*amax), 1e-8f), 127.f);
  const float inv = __frcp_rn(s);
  const long long start = static_cast<long long>(blockIdx.x) * blockDim.x +
                          threadIdx.x;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  if (start == 0) *scale = s;
  long long done = 0;
  if (vec) {
    done = n / 8 * 8;
    for (long long i = start; i < n / 8; i += step) {
      float v[8];
      load8(x + 8 * i, v);
      uint32_t lo = 0u, hi = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        lo |= static_cast<uint32_t>(static_cast<uint8_t>(code(v[j], s, inv)))
              << (8 * j);
        hi |= static_cast<uint32_t>(static_cast<uint8_t>(code(v[j + 4], s, inv)))
              << (8 * j);
      }
      reinterpret_cast<uint2*>(q)[i] = make_uint2(lo, hi);
    }
  }
  for (long long i = done + start; i < n; i += step)
    q[i] = code(to_float(x[i]), s, inv);
}

template <typename T>
int quantize(const void* x, long long n, unsigned* amax, int8_t* q,
             float* scale, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const int vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 8 == 0) ? 1 : 0;
  const long long work = vec ? n / 8 + n % 8 : n;
  const int blocks = static_cast<int>(
      work / Q_THREADS + 1 < 2048 ? work / Q_THREADS + 1 : 2048);
  cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(unsigned), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  int8_amax_kernel<T><<<blocks, Q_THREADS, 0, stream>>>(xt, n, vec, amax);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int8_quantize_kernel<T><<<blocks, Q_THREADS, 0, stream>>>(xt, n, vec, amax,
                                                           q, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int BN, bool VEC, typename OutT>
int launch_tile(const ConvParams& p, cudaStream_t stream) {
  using T = Tile<BN>;
  auto kernel = int8_conv_kernel<BN, VEC, OutT>;
  if (T::SMEM_BYTES > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((p.M + BM - 1) / BM, (p.Cout + BN - 1) / BN);
  kernel<<<grid, T::THREADS, T::SMEM_BYTES, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// 128 output channels a block where Cout is a multiple of 128 (half the
// re-reads of A), else 64 (VoVNet's 160, 192 and 224 waste less).
template <bool VEC, typename OutT>
int launch_conv(const ConvParams& p, cudaStream_t stream) {
  return p.Cout % 128 == 0 ? launch_tile<128, VEC, OutT>(p, stream)
                           : launch_tile<64, VEC, OutT>(p, stream);
}

}  // namespace

// x: float32 (x_bf16 = 0) or bfloat16 (1), n elements in memory order;
// amax: one unsigned of scratch; q: n int8 codes; scale: the float32 s.
extern "C" int int8_quantize(const void* x, int x_bf16, long long n,
                             unsigned* amax, int8_t* q, float* scale,
                             void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? quantize<__nv_bfloat16>(x, n, amax, q, scale, s)
                : quantize<float>(x, n, amax, q, scale, s);
}

// x [N, H, W, Cin] and w [Cout, Kp] int8 codes, sx the activation scale (a
// device scalar), sw [Cout]; out [N, Ho, Wo, Cout] float32 (out_bf16 = 0)
// or bfloat16 (1).  Square kernels, dilation 1; the wrapper checks shapes.
extern "C" int int8_conv(const void* x, const void* w, const float* sx,
                         const float* sw, void* out, int out_bf16, int N,
                         int H, int W, int Cin, int Cout, int KH, int KW,
                         int stride, int pad, int Ho, int Wo, int Kp,
                         void* stream) {
  ConvParams p{};
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.sx = sx;
  p.sw = sw;
  p.out = out;
  p.N = N; p.H = H; p.W = W; p.Cin = Cin; p.Cout = Cout;
  p.KH = KH; p.KW = KW; p.stride = stride; p.pad = pad;
  p.Ho = Ho; p.Wo = Wo;
  p.M = N * Ho * Wo;
  p.K = KH * KW * Cin;
  p.Kp = Kp;
  if (p.M <= 0 || Cout <= 0 || Kp % BK != 0 || Kp < p.K ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = Cin % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    return vec ? launch_conv<true, __nv_bfloat16>(p, s)
               : launch_conv<false, __nv_bfloat16>(p, s);
  return vec ? launch_conv<true, float>(p, s) : launch_conv<false, float>(p, s);
}
