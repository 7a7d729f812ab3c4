// int8 serving mode (model.backbone.quantize=int8): the activation quantize
// passes and the int8 x int8 -> int32 convolution with ConvBN's epilogue.
//
// Replaces no TPU kernel: the JAX package runs this convolution in XLA
// (transcar_tpu/ops/int8.py:48 dynamic_int8_conv, lax.conv_general_dilated
// on int8 operands with preferred_element_type=int32, the dequantize fused
// by XLA into the following BN and ReLU), not in Pallas.  It exists
// because PyTorch has no int8 convolution on CUDA (F.conv2d refuses int8
// tensors), and an int8 mode computed in bfloat16 or float32 would not be
// one.  The wrapper, the bound and the design notes are in
// transcar_tpu_torch/ops/int8.py.
//
// What is computed.  s = max(amax, 1e-8) / 127 (an IEEE division) and
// q = clip(rint(x / s), -127, 127) per tensor; then out[m, c] =
// relu?(o(o(o(float(acc[m, c]) * (s_x * s_w[c])) * sc[c]) + bi[c])) with
// acc = sum_k A[m, k] * B[c, k] exact in int32, M = N*Ho*Wo output pixels,
// K = KH*KW*Cin, A gathered from the NHWC codes with zero padding, B the
// [Cout, Kp] K-major weight codes (k = (ky*KW + kx)*Cin + ci, zero past K,
// Kp a multiple of 64), sc / bi FrozenBN's folded scale and bias cast to
// the output type (or none), o() the rounding to it: the module's eager
// roundings, so the result equals relu(bn(dequant)) bit for bit.  Where
// asked, the epilogue also takes max |out| (the next conv's amax).
//
// Entries (plain C, each returns a cudaError_t):
// - int8_amax: max |x| in one launch (16-byte loads, four in flight a
//   thread, from the end of x back to its start so that L2 holds the start
//   for the codes pass; one atomicMax of float bits a block into a scratch
//   pair whose last block publishes the max and resets the pair: no
//   memset).
// - int8_codes: the scale and codes from a given amax (the standalone
//   pass's, or a producing conv epilogue's), 16-byte loads, four in flight
//   a thread.  The codes are those of an IEEE division rounded half to
//   even, as the plain version and XLA compute them (a multiply by 1/s,
//   checked against the division near a tie).
// - int8_conv_wgmma: Cin % 16 == 0 and Cout % 8 == 0, k x k (1, 3, 7),
//   stride 1 or 2: the persistent wgmma body of osa_wgmma.cuh instantiated
//   for s8 (S8Op): one producer thread keeps a 4-stage TMA ring of 128-byte
//   (128-channel) K slices in flight, two consumer warpgroups run wgmma
//   m64nNk32 s8 with int32 accumulators over 128 pixels x BN channels (one
//   slice's products in flight while the next is awaited), and one tile's
//   epilogue overlaps the next tile's loads.  BN (s8_tile_n): the whole
//   Cout up to 128; a bfloat16 Cout that is a multiple of 128 above that on
//   128-wide tiles; 160, 192 and 224 (VoVNet's 3x3 chain) in one tile, so
//   each pixel tile's gathered A is read once; 256-wide slices above.  1x1
//   stride-1 convs take the body's reduce form (a GEMM per image on a 3-D
//   map); the others its conv form, taps as 4-D boxes with TMA's zero fill
//   as the padding, stride 2 through one map per tap parity.  bfloat16
//   tiles of BN <= 128 stage the output in shared memory and TMA-store it;
//   the others store from the registers.
//
//   What bounds it: a 1x1 conv's output bytes (R101's K = 256 and 1024
//   convs); a 3x3 conv's L2 -> SM traffic, since every pixel tile reads
//   all of the weight's slices again (VoVNet's chain; PERF.md has the
//   measured shares).
// - int8_conv_mma: the stems (Cin <= 4) on a second tile (mma.sync
//   m16n8k32 s8, 128 pixels x 128 or 64 channels a block, 3-stage cp.async
//   ring).  A stem's image is quantized into 4-channel codes
//   (int8_codes_quad: three channels and a zero), its weight laid out with
//   each kernel row padded to a multiple of 4 taps, so a 16-byte chunk of A
//   is 4 adjacent pixels of one kernel row: four 4-byte loads (K = 7 x 8 x
//   4 = 224 for the 7x7, where the wgmma tile would read a 128-channel
//   slice a tap, K = 6272).  The same epilogue.  The wrapper raises for a
//   conv that neither tile takes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "osa_wgmma.cuh"

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
  const float* scale;  // [Cout] FrozenBN's, or null (no fold)
  const float* bias;
  float* amax;      // null, or where max |out| is published
  unsigned* scratch;  // [2], zero between launches
  void* out;        // [M, Cout]
  int N, H, W, Cin, Cout, KH, KW, stride, pad, Ho, Wo, M, K, Kp, relu;
  int KWP;          // taps a kernel row takes in K: KW rounded up to 4
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
// STEP i (i < ROWS), at K step kt.  The codes have 4 channels (a stem's
// three and a zero) and the taps of a kernel row are padded to KWP, a
// multiple of 4, so the chunk is 4 adjacent input pixels of one kernel
// row: four 4-byte loads.  rn[i] < 0 marks a row past M.
template <int ROWS, int STEP>
__device__ __forceinline__ void load_a(const ConvParams& p, int8_t* as,
                                       int kt, const int* rn, const int* ry,
                                       const int* rx, int chunk, int row0) {
  const int tap = (kt * BK + chunk * 16) / 4;  // of the padded rows: ky * KWP + kx0
  const int ky = tap / p.KWP;
  const int kx0 = tap - ky * p.KWP;
  const bool kok = ky < p.KH;
  const uint32_t* x = reinterpret_cast<const uint32_t*>(p.x);
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int iy = ry[i] + ky;
    const bool rok = kok && rn[i] >= 0 && iy >= 0 && iy < p.H;
    const size_t base = (static_cast<size_t>(rn[i] < 0 ? 0 : rn[i]) * p.H + iy) * p.W;
    uint32_t w[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int ix = rx[i] + kx0 + t;
      w[t] = rok && ix >= 0 && ix < p.W ? x[base + ix] : 0u;
    }
    *reinterpret_cast<uint4*>(as + (row0 + STEP * i) * LDS + chunk * 16) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <int BN, typename OutT>
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
    load_a<A_ROWS, STEP>(p, as_all + stage * A_BYTES, kt, rn, ry, rx,
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

  // epilogue: osa::S8Op::value per element (the dequantize, FrozenBN where
  // given, ReLU where set, with the module's roundings)
  constexpr bool BF16 = std::is_same<OutT, __nv_bfloat16>::value;
  const bool fold = p.scale != nullptr;
  const float sx = *p.sx;
  float sc[4][2][3];  // dq, BN scale, BN bias of this thread's 8 columns
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = n0 + wn + ni * 8 + t2 + e;
      const bool ok = col < p.Cout;
      sc[ni][e][0] = ok ? __fmul_rn(sx, p.sw[col]) : 0.f;
      sc[ni][e][1] = ok && fold ? p.scale[col] : 1.f;
      sc[ni][e][2] = ok && fold ? p.bias[col] : 0.f;
      if (BF16) {
        sc[ni][e][1] = osa::round_bf16(sc[ni][e][1]);
        sc[ni][e][2] = osa::round_bf16(sc[ni][e][2]);
      }
    }
  auto value = [&](int a, int ni, int e) {
    return osa::S8Op::value(a, sc[ni][e][0], sc[ni][e][1], sc[ni][e][2], fold,
                            p.relu != 0, BF16);
  };
  float amax = 0.f;
  if constexpr (BF16) {
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
          const __nv_bfloat162 v2 = __floats2bfloat162_rn(
              value(acc[mi][ni][2 * h], ni, 0), value(acc[mi][ni][2 * h + 1], ni, 1));
          *reinterpret_cast<__nv_bfloat162*>(st + r * T::OUT_LDS + c) = v2;
          if (m0 + r < p.M) {
            if (n0 + c < p.Cout) amax = fmaxf(amax, fabsf(__low2float(v2)));
            if (n0 + c + 1 < p.Cout) amax = fmaxf(amax, fabsf(__high2float(v2)));
          }
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
          o[0] = value(acc[mi][ni][2 * h], ni, 0);
          amax = fmaxf(amax, fabsf(o[0]));
          if (second) {
            o[1] = value(acc[mi][ni][2 * h + 1], ni, 1);
            amax = fmaxf(amax, fabsf(o[1]));
          }
        }
    }
  }
  if (p.amax != nullptr) {
    __shared__ float red[T::THREADS / 32];
    osa::publish_amax(amax, red, tid, T::THREADS, p.scratch, p.amax);
  }
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 8 elements from 16-byte aligned memory: two float4 loads, or one of 8
// bfloat16.
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
constexpr int Q_UNROLL = 4;  // groups of 8 elements in flight a thread

template <typename T>
__global__ void __launch_bounds__(Q_THREADS)
    int8_amax_kernel(const T* x, long long n, int vec, float* amax, unsigned* scratch) {
  const long long n8 = vec ? n / 8 : 0;  // groups of 8, then a scalar tail
  const long long stride = static_cast<long long>(gridDim.x) * Q_THREADS;
  float m = 0.f;
  // thread t takes groups t, t + stride, ...: every thread within one
  // group of the others' count, Q_UNROLL loads in flight.  The groups are
  // walked from the end of x to its start, so that the start is what L2
  // holds when the codes pass begins there.
  for (long long b = static_cast<long long>(blockIdx.x) * Q_THREADS + threadIdx.x;
       b < n8; b += Q_UNROLL * stride) {
    float v[Q_UNROLL][8];
#pragma unroll
    for (int u = 0; u < Q_UNROLL; ++u) {
      const long long i = b + u * stride;
      if (i < n8) {
        load8(x + 8 * (n8 - 1 - i), v[u]);
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) v[u][k] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < Q_UNROLL; ++u)
#pragma unroll
      for (int k = 0; k < 8; ++k) m = fmaxf(m, fabsf(v[u][k]));
  }
  for (long long i = n8 * 8 + static_cast<long long>(blockIdx.x) * Q_THREADS + threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * Q_THREADS)
    m = fmaxf(m, fabsf(to_float(x[i])));
  __shared__ float red[Q_THREADS / 32];
  osa::publish_amax(m, red, threadIdx.x, Q_THREADS, scratch, amax);
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
    int8_codes_kernel(const T* x, long long n, int vec, const float* amax, int8_t* q,
                      float* scale) {
  const float s = __fdiv_rn(fmaxf(*amax, 1e-8f), 127.f);
  const float inv = __frcp_rn(s);
  if (blockIdx.x == 0 && threadIdx.x == 0) *scale = s;
  const long long n8 = vec ? n / 8 : 0;  // groups of 8, then a scalar tail
  const long long stride = static_cast<long long>(gridDim.x) * Q_THREADS;
  for (long long b = static_cast<long long>(blockIdx.x) * Q_THREADS + threadIdx.x;
       b < n8; b += Q_UNROLL * stride) {
    float v[Q_UNROLL][8];
#pragma unroll
    for (int u = 0; u < Q_UNROLL; ++u) {
      const long long i = b + u * stride;
      if (i < n8) load8(x + 8 * i, v[u]);
    }
#pragma unroll
    for (int u = 0; u < Q_UNROLL; ++u) {
      const long long i = b + u * stride;
      if (i >= n8) continue;
      uint32_t lo = 0u, hi = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        lo |= static_cast<uint32_t>(static_cast<uint8_t>(code(v[u][j], s, inv))) << (8 * j);
        hi |= static_cast<uint32_t>(static_cast<uint8_t>(code(v[u][j + 4], s, inv)))
              << (8 * j);
      }
      reinterpret_cast<uint2*>(q)[i] = make_uint2(lo, hi);
    }
  }
  for (long long i = n8 * 8 + static_cast<long long>(blockIdx.x) * Q_THREADS + threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * Q_THREADS)
    q[i] = code(to_float(x[i]), s, inv);
}

// The codes of x [pixels, C] (bf16) into q [pixels, CP] with zero codes in
// channels C..CP-1 (CP = 4: a stem's image, for int8_conv_mma).
template <typename T>
__global__ void __launch_bounds__(Q_THREADS)
    int8_codes_padded_kernel(const T* x, long long pixels, int C, const float* amax,
                             uint32_t* q, float* scale) {
  const float s = __fdiv_rn(fmaxf(*amax, 1e-8f), 127.f);
  const float inv = __frcp_rn(s);
  if (blockIdx.x == 0 && threadIdx.x == 0) *scale = s;
  for (long long i = static_cast<long long>(blockIdx.x) * Q_THREADS + threadIdx.x; i < pixels;
       i += static_cast<long long>(gridDim.x) * Q_THREADS) {
    uint32_t w = 0u;
    for (int c = 0; c < C; ++c)
      w |= static_cast<uint32_t>(static_cast<uint8_t>(code(to_float(x[i * C + c]), s, inv)))
           << (8 * c);
    q[i] = w;
  }
}

// Blocks of a quantize pass: enough for every group of Q_UNROLL x 8
// elements, at most 8 a multiprocessor.
int q_blocks(long long n, int vec) {
  const long long per_block = static_cast<long long>(Q_THREADS) * (vec ? Q_UNROLL * 8 : 1);
  const long long want = (n + per_block - 1) / per_block;
  const long long most = 8LL * hop::sm_count();
  return static_cast<int>(want < 1 ? 1 : want < most ? want : most);
}

int q_vec(const void* x, const void* q) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 8 == 0;
}

template <int BN, typename OutT>
int launch_tile(const ConvParams& p, cudaStream_t stream) {
  using T = Tile<BN>;
  auto kernel = int8_conv_kernel<BN, OutT>;
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
// re-reads of A), else 64.
template <typename OutT>
int launch_conv(const ConvParams& p, cudaStream_t stream) {
  return p.Cout % 128 == 0 ? launch_tile<128, OutT>(p, stream)
                           : launch_tile<64, OutT>(p, stream);
}

// ---- the wgmma tile ----------------------------------------------------------

template <int BN, bool kConv, bool kStage>
__global__ void __launch_bounds__(osa::THREADS, 1)
    int8_conv_wgmma_kernel(const __grid_constant__ osa::OsaParams p) {
  osa::osa_tile<BN, kConv, 0, kStage, osa::S8Op>(p);
}

constexpr CUtensorMapDataType kU8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;

// The reduce form (1x1, stride 1): x [N, H*W, C] codes, box [1, BM, 128];
// w [Cout, C] K-major with row stride Kp, box [BN, 128].
int s8_reduce_params(osa::OsaParams* p, const void* x, int C, const void* w, int Kp,
                     int N, int H, int W, int Cout, int bn) {
  const uint64_t c = C, hw = static_cast<uint64_t>(H) * W;
  const uint64_t adims[3] = {c, hw, static_cast<uint64_t>(N)};
  const uint64_t astrides[2] = {c, hw * c};
  const uint32_t abox[3] = {osa::ROW, osa::BM, 1};
  const uint64_t bdims[2] = {c, static_cast<uint64_t>(Cout)};
  const uint64_t bstrides[1] = {static_cast<uint64_t>(Kp)};
  const uint32_t bbox[2] = {osa::ROW, static_cast<uint32_t>(bn)};
  if (!hop::make_map(&p->a[0], x, 3, adims, astrides, abox, kU8) ||
      !hop::make_map(&p->b[0], w, 2, bdims, bstrides, bbox, kU8))
    return static_cast<int>(cudaErrorInvalidValue);
  p->n_pieces = 1;
  p->width[0] = C;
  p->HW = H * W;
  p->Cout = Cout;
  p->b_rows = bn;
  p->tiles_m = (H * W + osa::BM - 1) / osa::BM;
  p->tiles_n = (Cout + bn - 1) / bn;
  p->tiles = N * p->tiles_m * p->tiles_n;
  return 0;
}

// The conv form (k x k, stride s = 1 or 2, padding pad) over x [N, H, W, C]
// codes into Ho x Wo: one 4-D map a (row, column) parity of the tap offset
// (stride 1: one), box [1, bh, bw, 128]; w [Cout, k*k, C] K-major with
// row stride Kp, box [b_rows, 1, 128].
int s8_conv_params(osa::OsaParams* p, const void* x, int C, const void* w, int Kp,
                   int N, int H, int W, int Cout, int k, int stride, int pad, int Ho,
                   int Wo, int bn) {
  p->bw = osa::tile_width(Ho, Wo);
  const uint32_t bh = osa::BM / p->bw;
  const uint64_t c = C;
  for (int py = 0; py < stride; ++py)
    for (int px = 0; px < stride; ++px) {
      const uint64_t rows = (H - py + stride - 1) / stride;
      const uint64_t cols = (W - px + stride - 1) / stride;
      const uint64_t adims[4] = {c, cols, rows, static_cast<uint64_t>(N)};
      const uint64_t astrides[3] = {stride * c, stride * c * W, c * W * H};
      const uint32_t abox[4] = {osa::ROW, static_cast<uint32_t>(p->bw), bh, 1};
      const int8_t* base = static_cast<const int8_t*>(x) + (py * W + px) * c;
      if (rows == 0 || cols == 0 ||
          !hop::make_map(&p->a[2 * py + px], base, 4, adims, astrides, abox, kU8))
        return static_cast<int>(cudaErrorInvalidValue);
    }
  p->b_rows = Cout < bn ? Cout : bn;
  const uint64_t bdims[3] = {c, static_cast<uint64_t>(k * k), static_cast<uint64_t>(Cout)};
  const uint64_t bstrides[2] = {c, static_cast<uint64_t>(Kp)};
  const uint32_t bbox[3] = {osa::ROW, 1, static_cast<uint32_t>(p->b_rows)};
  if (!hop::make_map(&p->b[0], w, 3, bdims, bstrides, bbox, kU8))
    return static_cast<int>(cudaErrorInvalidValue);
  p->n_pieces = 1;
  p->width[0] = C;
  p->taps = k * k;
  p->kw = k;
  p->pad = pad;
  p->sshift = stride == 2 ? 1 : 0;
  p->Cout = Cout;
  p->H = Ho;
  p->W = Wo;
  p->tiles_w = (Wo + p->bw - 1) / p->bw;
  p->tiles_m = p->tiles_w * ((Ho + static_cast<int>(bh) - 1) / static_cast<int>(bh));
  p->tiles_n = (Cout + bn - 1) / bn;
  p->tiles = N * p->tiles_m * p->tiles_n;
  return 0;
}

// The Cout tile: the whole Cout up to 128; a bfloat16 Cout that is a
// multiple of 128 above it on staged 128-wide tiles (the 1x1 convs that
// are bound by their output bytes: a pixel tile's A is read again from
// L2, each output leaves in TMA stores); else the whole Cout up to 256
// (the conv form: 160, 192, 224, so each pixel tile's gathered A is read
// once), 256-wide slices above.
int s8_tile_n(int Cout, bool conv, bool bf16_out) {
  if (Cout <= 64) return 64;
  if (Cout <= 128) return 128;
  if (bf16_out && Cout % 128 == 0) return 128;
  if (conv && Cout <= 224) return (Cout + 31) / 32 * 32;
  return 256;
}

template <int BN, bool kConv, bool kStage>
int s8_launch(osa::OsaParams& p, int N, void* stream) {
  if constexpr (kStage) {
    if (!osa::slot_map(&p.o, p.out, p, kConv, N)) return static_cast<int>(cudaErrorInvalidValue);
  }
  return osa::launch_tile<BN, kStage>(int8_conv_wgmma_kernel<BN, kConv, kStage>, p, stream);
}

// bfloat16 output on BN <= 128 tiles is staged (two output slots fit
// beside the ring); wider tiles and float32 output store from the
// registers.
template <bool kConv>
int s8_dispatch(osa::OsaParams& p, int bn, int N, void* stream) {
  const bool staged = p.out_f32 == nullptr;
  switch (bn) {
    case 64:
      return staged ? s8_launch<64, kConv, true>(p, N, stream)
                    : s8_launch<64, kConv, false>(p, N, stream);
    case 128:
      return staged ? s8_launch<128, kConv, true>(p, N, stream)
                    : s8_launch<128, kConv, false>(p, N, stream);
    case 256:
      return s8_launch<256, kConv, false>(p, N, stream);
    default:
      break;
  }
  if constexpr (kConv) {
    switch (bn) {
      case 160: return s8_launch<160, true, false>(p, N, stream);
      case 192: return s8_launch<192, true, false>(p, N, stream);
      case 224: return s8_launch<224, true, false>(p, N, stream);
      default: break;
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x: float32 (x_bf16 = 0) or bfloat16 (1), n elements in memory order;
// amax: the float32 result; scratch: [2] unsigned, zero between launches
// (the pass leaves it zero).
extern "C" int int8_amax(const void* x, int x_bf16, long long n, float* amax,
                         unsigned* scratch, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int blocks = q_blocks(n, vec);
  if (x_bf16)
    int8_amax_kernel<__nv_bfloat16><<<blocks, Q_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), n, vec, amax, scratch);
  else
    int8_amax_kernel<float><<<blocks, Q_THREADS, 0, s>>>(static_cast<const float*>(x), n,
                                                          vec, amax, scratch);
  return static_cast<int>(cudaGetLastError());
}

// The codes q (n int8, x's memory order) and the scale (float32) of x from
// its amax (a device scalar).
extern "C" int int8_codes(const void* x, int x_bf16, long long n, const float* amax,
                          int8_t* q, float* scale, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = q_vec(x, q);
  const int blocks = q_blocks(n, vec);
  if (x_bf16)
    int8_codes_kernel<__nv_bfloat16><<<blocks, Q_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), n, vec, amax, q, scale);
  else
    int8_codes_kernel<float><<<blocks, Q_THREADS, 0, s>>>(static_cast<const float*>(x), n,
                                                           vec, amax, q, scale);
  return static_cast<int>(cudaGetLastError());
}

// The codes of x [pixels, C] (C < 4, float32 or bfloat16, NHWC) written
// as [pixels, 4] with zero codes past C, and the scale, from its amax.
extern "C" int int8_codes_quad(const void* x, int x_bf16, long long pixels, int C,
                               const float* amax, void* q, float* scale, void* stream) {
  if (pixels <= 0 || C < 1 || C > 4 || reinterpret_cast<uintptr_t>(q) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = q_blocks(pixels, 0);
  uint32_t* q4 = static_cast<uint32_t*>(q);
  if (x_bf16)
    int8_codes_padded_kernel<__nv_bfloat16><<<blocks, Q_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), pixels, C, amax, q4, scale);
  else
    int8_codes_padded_kernel<float><<<blocks, Q_THREADS, 0, s>>>(
        static_cast<const float*>(x), pixels, C, amax, q4, scale);
  return static_cast<int>(cudaGetLastError());
}

// Both convolutions: x [N, H, W, Cin] and w [Cout, Kp] int8 codes
// (int8_conv_mma: Cin = 4, a stem's codes padded to 4 channels, w in the
// layout k = (ky * KWP + kx) * 4 + ci), sx the activation scale (a device scalar), sw [Cout]; scale / bias [Cout]
// float32 FrozenBN's folded affine or both null; relu; out [N, Ho, Wo,
// Cout] float32 (out_bf16 = 0) or bfloat16 (1); amax null or where max
// |out| goes, with scratch [2] (zero between launches).  Square kernels,
// dilation 1; the wrapper checks shapes and picks the entry by shape.
extern "C" int int8_conv_mma(const void* x, const void* w, const float* sx,
                             const float* sw, const float* scale, const float* bias,
                             int relu, void* out, int out_bf16, float* amax,
                             unsigned* scratch, int N, int H, int W, int Cin, int Cout,
                             int KH, int KW, int stride, int pad, int Ho, int Wo, int Kp,
                             void* stream) {
  ConvParams p{};
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.sx = sx;
  p.sw = sw;
  p.scale = scale;
  p.bias = bias;
  p.amax = amax;
  p.scratch = scratch;
  p.out = out;
  p.N = N; p.H = H; p.W = W; p.Cin = Cin; p.Cout = Cout;
  p.KH = KH; p.KW = KW; p.stride = stride; p.pad = pad;
  p.Ho = Ho; p.Wo = Wo;
  p.M = N * Ho * Wo;
  p.KWP = (KW + 3) / 4 * 4;
  p.K = KH * p.KWP * Cin;
  p.Kp = Kp;
  p.relu = relu;
  if (Cin != 4 || p.M <= 0 || Cout <= 0 || Kp % BK != 0 || Kp < p.K ||
      (scale == nullptr) != (bias == nullptr) ||
      (reinterpret_cast<uintptr_t>(w) % 16 | reinterpret_cast<uintptr_t>(x) % 4) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_bf16 ? launch_conv<__nv_bfloat16>(p, s) : launch_conv<float>(p, s);
}

extern "C" int int8_conv_wgmma(const void* x, const void* w, const float* sx,
                               const float* sw, const float* scale, const float* bias,
                               int relu, void* out, int out_bf16, float* amax,
                               unsigned* scratch, int N, int H, int W, int Cin, int Cout,
                               int KH, int KW, int stride, int pad, int Ho, int Wo, int Kp,
                               void* stream) {
  const bool conv = !(KH == 1 && stride == 1 && pad == 0);
  if (N <= 0 || Ho <= 0 || Wo <= 0 || Cin % 16 != 0 || Cout % 8 != 0 || KH != KW ||
      (stride != 1 && stride != 2) || Kp % 16 != 0 || Kp < KH * KW * Cin ||
      (scale == nullptr) != (bias == nullptr) ||
      (!conv && (Ho != H || Wo != W)) ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(out)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  osa::OsaParams p{};
  const int bn = s8_tile_n(Cout, conv, out_bf16 != 0);
  const int rc = conv ? s8_conv_params(&p, x, Cin, w, Kp, N, H, W, Cout, KH, stride, pad,
                                       Ho, Wo, bn)
                      : s8_reduce_params(&p, x, Cin, w, Kp, N, H, W, Cout, bn);
  if (rc != 0) return rc;
  p.sx = sx;
  p.sw = sw;
  p.scale = scale;
  p.bias = bias;
  p.fold = scale != nullptr;
  p.relu = relu;
  p.amax = amax;
  p.scratch = scratch;
  if (out_bf16)
    p.out = static_cast<hop::bf16*>(out);
  else
    p.out_f32 = static_cast<float*>(out);
  return conv ? s8_dispatch<true>(p, bn, N, stream) : s8_dispatch<false>(p, bn, N, stream);
}
