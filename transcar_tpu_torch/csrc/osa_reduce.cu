// K4: VoVNet OSA concat-reduce, relu?((sum_i piece_i @ W_i) * scale + bias)
// without the concatenation, plus per-image float32 channel sums.
//
// Replaces transcar_tpu/ops/pallas_osa.py::osa_reduce.  The wrapper, the
// bound and the design are described in transcar_tpu_torch/ops/pallas_osa.py.
//
// Two tiles:
// - osa_reduce_bf16_wgmma: the Hopper tile (hopper_tile.cuh) for bfloat16
//   with C_i % 8 == 0, Cout % 8 == 0 and 16-byte aligned bases.  GEMM per
//   image: M = its H*W pixels, N = Cout, K = sum C_i walked piece by piece in
//   64-wide slices.  A piece is a 3-D tensor map [N, H*W, C_i] with a box of
//   [1, 128, 64]: TMA's zero fill ends a tile at its image's edge and a
//   slice past C_i (160 and 224 are no multiple of 64), in the weight map
//   [Cout, C_i] (K-major) as well, which keeps the product exact.  A
//   persistent block (one per SM) walks (image, pixel tile, Cout tile)
//   tiles: one producer thread keeps a 4-stage ring of (A, B) slices in
//   flight, two consumer warpgroups each run wgmma over 64 pixels x BN
//   channels (BN = 256 where Cout allows, else 128), so one tile's
//   epilogue overlaps the next tile's loads.  The epilogue works from the
//   accumulator registers: the tile's affine staged in shared memory,
//   affine and ReLU in float32, one rounding to bfloat16, 8-byte stores
//   after one exchange between neighbouring lanes, and the channel sums by
//   a butterfly of warp shuffles, one shared-memory row per warp (no shared
//   atomics: contended, they cost more than the whole multiply) and one
//   float32 global atomic per (tile, channel).
// - osa_reduce_bf16 / osa_reduce_f32: the tile of conv_tile.cuh (wmma /
//   CUDA-core FMAs) with one 1x1 segment per piece, for float32 and for
//   bfloat16 calls outside the shapes above.
//
// Layouts: piece_i [N,H,W,C_i]; W_i [C_i, Cout] (conv_tile.cuh: contiguous;
// the Hopper tile: a K-major view, element (c, o) at w_i + o * w_ld_i + c);
// scale / bias [Cout] float32, out [N,H,W,Cout], sums [N,Cout] float32
// (zeroed by the caller).

#include "conv_tile.cuh"
#include "hopper_tile.cuh"

namespace {

constexpr int kMaxPieces = 8;
constexpr int BM = 128;           // pixels per tile (two consumer warpgroups)
constexpr int BK = 64;            // K per slice: one 128-byte swizzled row
constexpr int STAGES = 4;
constexpr int THREADS = 384;      // producer warpgroup + 2 consumer warpgroups

struct OsaParams {
  CUtensorMap a[kMaxPieces];      // piece i: [N, HW, C_i], box [1, BM, BK]
  CUtensorMap b[kMaxPieces];      // weight i: [Cout, C_i] K-major, box [BN, BK]
  int width[kMaxPieces];
  int n_pieces;
  const float* scale;
  const float* bias;
  hop::bf16* out;
  float* sums;
  int HW, Cout, relu;
  int tiles_m, tiles_n, tiles;
};

template <int BN>
constexpr int smem_bytes() {
  return 1024 + STAGES * (BM + BN) * BK * 2 + 2 * STAGES * 8 + 10 * BN * 4;
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
osa_reduce_wgmma_kernel(const __grid_constant__ OsaParams p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  hop::bf16* sa = reinterpret_cast<hop::bf16*>(base);          // [S][BM][BK]
  hop::bf16* sb = sa + STAGES * BM * BK;                       // [S][BN][BK]
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + STAGES * BN * BK);
  uint64_t* empty = full + STAGES;
  float* part = reinterpret_cast<float*>(empty + STAGES);      // [8 warps][BN]
  float* sscale = part + 8 * BN;                               // [BN] this tile's
  float* sbias = sscale + BN;                                  // [BN] affine

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 2);        // both consumer warpgroups
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every TMA load --------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (t == 0) {
      for (int i = 0; i < p.n_pieces; ++i) {
        hop::tma_prefetch(&p.a[i]);
        hop::tma_prefetch(&p.b[i]);
      }
      hop::Ring<STAGES> r;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const int nt = tile % p.tiles_n, rest = tile / p.tiles_n;
        const int mt = rest % p.tiles_m, img = rest / p.tiles_m;
        for (int i = 0; i < p.n_pieces; ++i) {
          for (int k0 = 0; k0 < p.width[i]; k0 += BK) {
            hop::mbar_wait(&empty[r.stage], r.phase ^ 1u);
            hop::mbar_expect_tx(&full[r.stage], (BM + BN) * BK * 2);
            hop::tma_load_3d(sa + r.stage * BM * BK, &p.a[i], &full[r.stage], k0,
                             mt * BM, img);
            hop::tma_load_2d(sb + r.stage * BN * BK, &p.b[i], &full[r.stage], k0,
                             nt * BN);
            r.next();
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns tile rows [64 cw, 64 cw + 64) ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;
    const int warp = t / 32, lane = t % 32;
    float acc[BN / 2];
    hop::Ring<STAGES> r;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int nt = tile % p.tiles_n, rest = tile / p.tiles_n;
      const int mt = rest % p.tiles_m, img = rest / p.tiles_m;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      for (int i = 0; i < p.n_pieces; ++i) {
        for (int k0 = 0; k0 < p.width[i]; k0 += BK) {
          hop::mbar_wait(&full[r.stage], r.phase);
          const uint64_t da = hop::make_desc(sa + r.stage * BM * BK + cw * 64 * BK, 0, 1024);
          const uint64_t db = hop::make_desc(sb + r.stage * BN * BK, 0, 1024);
          hop::fence_regs<BN / 2>(acc);
          hop::wgmma_fence();
          hop::mma_slice<BN, 0, 0>(acc, da, db);
          hop::wgmma_commit();
          hop::wgmma_wait<0>();
          hop::fence_regs<BN / 2>(acc);
          if (t == 0) hop::mbar_arrive(&empty[r.stage]);
          r.next();
        }
      }

      // ---- epilogue from the accumulator registers ---------------------
      const int col_base = nt * BN;
      const int ct = threadIdx.x - 128;                 // 0 .. 255
      if (ct < BN) {
        const bool in = col_base + ct < p.Cout;
        sscale[ct] = in ? p.scale[col_base + ct] : 0.f;
        sbias[ct] = in ? p.bias[col_base + ct] : 0.f;
      }
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      const int row0 = mt * BM + cw * 64 + warp * 16 + lane / 4;  // and row0 + 8
      const bool ok0 = row0 < p.HW, ok1 = row0 + 8 < p.HW;
      // lanes of even l % 4 store 4 columns of row0, odd ones of row0 + 8
      const bool odd = lane & 1;
      const bool okr = odd ? ok1 : ok0;
      const size_t orow = (static_cast<size_t>(img) * p.HW + row0 + (odd ? 8 : 0)) * p.Cout +
                          col_base + 2 * (lane & 2);
#pragma unroll
      for (int g = 0; g < BN / 32; ++g) {
        float cs[8];                       // column sums of this thread's 2 rows
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = 4 * g + k;
          const int lc = 8 * j + 2 * (lane & 3);          // column within the tile
          const float2 sc = *reinterpret_cast<const float2*>(sscale + lc);
          const float2 bi = *reinterpret_cast<const float2*>(sbias + lc);
          float v[4] = {acc[4 * j] * sc.x + bi.x, acc[4 * j + 1] * sc.y + bi.y,
                        acc[4 * j + 2] * sc.x + bi.x, acc[4 * j + 3] * sc.y + bi.y};
          if (p.relu) {
#pragma unroll
            for (int e = 0; e < 4; ++e) v[e] = fmaxf(v[e], 0.f);
          }
          cs[2 * k] = (ok0 ? v[0] : 0.f) + (ok1 ? v[2] : 0.f);
          cs[2 * k + 1] = (ok0 ? v[1] : 0.f) + (ok1 ? v[3] : 0.f);
          // one exchange with lane ^ 1 gives each lane 4 contiguous columns
          const uint32_t a = pack_bf16(v[0], v[1]), b = pack_bf16(v[2], v[3]);
          const uint32_t got = __shfl_xor_sync(0xffffffffu, odd ? a : b, 1);
          const uint2 w = odd ? make_uint2(got, b) : make_uint2(a, got);
          if (okr && col_base + 8 * j < p.Cout)
            *reinterpret_cast<uint2*>(p.out + orow + 8 * j) = w;
        }
        // Sum the 8 values over the 8 lanes of one l % 4 (the warp's 16
        // rows) by a butterfly that halves what each lane keeps: after the
        // xor-4 / 8 / 16 rounds lane l holds value c = 4 b2 + 2 b3 + b4 of
        // the group (b = the bits of l), 7 shuffles instead of 24.
        const bool b2 = lane & 4, b3 = lane & 8, b4 = lane & 16;
        float h4[4], h2[2];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          h4[i] = (b2 ? cs[4 + i] : cs[i]) +
                  __shfl_xor_sync(0xffffffffu, b2 ? cs[i] : cs[4 + i], 4);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          h2[i] = (b3 ? h4[2 + i] : h4[i]) +
                  __shfl_xor_sync(0xffffffffu, b3 ? h4[i] : h4[2 + i], 8);
        const float h1 = (b4 ? h2[1] : h2[0]) +
                         __shfl_xor_sync(0xffffffffu, b4 ? h2[0] : h2[1], 16);
        const int c = (b2 ? 4 : 0) + (b3 ? 2 : 0) + (b4 ? 1 : 0);
        part[(cw * 4 + warp) * BN + 8 * (4 * g + (c >> 1)) + 2 * (lane & 3) + (c & 1)] = h1;
      }
      // the 8 warps' partial rows, then one global atomic per (tile,
      // channel); the second named barrier keeps the next tile's partials
      // after this read
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      if (ct < BN && col_base + ct < p.Cout) {
        float sum = 0.f;
#pragma unroll
        for (int w8 = 0; w8 < 8; ++w8) sum += part[w8 * BN + ct];
        atomicAdd(p.sums + static_cast<size_t>(img) * p.Cout + col_base + ct, sum);
      }
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
    }
  }
}

template <int BN>
int launch_wgmma(OsaParams& p, int N, int H, int W, int Cout, void* stream) {
  p.tiles_m = (H * W + BM - 1) / BM;
  p.tiles_n = (Cout + BN - 1) / BN;
  p.tiles = N * p.tiles_m * p.tiles_n;
  if (p.tiles == 0) return 0;
  constexpr int smem = smem_bytes<BN>();
  cudaError_t err = cudaFuncSetAttribute(osa_reduce_wgmma_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = p.tiles < hop::sm_count() ? p.tiles : hop::sm_count();
  osa_reduce_wgmma_kernel<BN><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int osa_reduce(int n_pieces, const void* const* pieces, const void* const* weights,
               const int* widths, const float* scale, const float* bias,
               void* out, float* sums, int N, int H, int W, int Cout, int relu,
               void* stream) {
  if (n_pieces < 1 || n_pieces > tck::kMaxSeg)
    return static_cast<int>(cudaErrorInvalidValue);
  tck::ConvGemm p{};
  p.nseg = n_pieces;
  for (int i = 0; i < n_pieces; ++i)
    p.seg[i] = tck::Seg{pieces[i], weights[i], widths[i], 1, 0, 0};
  p.scale = scale;
  p.bias = bias;
  p.out = out;
  p.sums = sums;
  p.N = N; p.H = H; p.W = W; p.Cout = Cout;
  p.relu = relu;
  return tck::launch_conv_gemm<4, T>(p, stream);
}

}  // namespace

// The Hopper tile: w_ld[i] is the row stride (elements) of weight i's
// K-major storage [Cout, .]; the caller guarantees the shapes above.
extern "C" int osa_reduce_bf16_wgmma(int n_pieces, const void* const* pieces,
                                     const void* const* weights, const int* widths,
                                     const int* w_ld, const float* scale,
                                     const float* bias, void* out, float* sums, int N,
                                     int H, int W, int Cout, int relu, void* stream) {
  if (n_pieces < 1 || n_pieces > kMaxPieces || Cout % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bn = Cout % 256 == 0 ? 256 : 128;
  OsaParams p{};
  p.n_pieces = n_pieces;
  const uint64_t hw = static_cast<uint64_t>(H) * W;
  for (int i = 0; i < n_pieces; ++i) {
    const uint64_t c = widths[i];
    if (c % 8 != 0 || w_ld[i] % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
    const uint64_t adims[3] = {c, hw, static_cast<uint64_t>(N)};
    const uint64_t astrides[2] = {c * 2, hw * c * 2};
    const uint32_t abox[3] = {BK, BM, 1};
    const uint64_t bdims[2] = {c, static_cast<uint64_t>(Cout)};
    const uint64_t bstrides[1] = {static_cast<uint64_t>(w_ld[i]) * 2};
    const uint32_t bbox[2] = {BK, static_cast<uint32_t>(bn)};
    if (!hop::make_map(&p.a[i], pieces[i], 3, adims, astrides, abox) ||
        !hop::make_map(&p.b[i], weights[i], 2, bdims, bstrides, bbox))
      return static_cast<int>(cudaErrorInvalidValue);
    p.width[i] = widths[i];
  }
  p.scale = scale;
  p.bias = bias;
  p.out = static_cast<hop::bf16*>(out);
  p.sums = sums;
  p.HW = H * W;
  p.Cout = Cout;
  p.relu = relu;
  return bn == 256 ? launch_wgmma<256>(p, N, H, W, Cout, stream)
                   : launch_wgmma<128>(p, N, H, W, Cout, stream);
}

extern "C" int osa_reduce_bf16(int n_pieces, const void* const* pieces,
                               const void* const* weights, const int* widths,
                               const float* scale, const float* bias, void* out,
                               float* sums, int N, int H, int W, int Cout,
                               int relu, void* stream) {
  return osa_reduce<tck::bf16>(n_pieces, pieces, weights, widths, scale, bias,
                               out, sums, N, H, W, Cout, relu, stream);
}

extern "C" int osa_reduce_f32(int n_pieces, const void* const* pieces,
                              const void* const* weights, const int* widths,
                              const float* scale, const float* bias, void* out,
                              float* sums, int N, int H, int W, int Cout,
                              int relu, void* stream) {
  return osa_reduce<float>(n_pieces, pieces, weights, widths, scale, bias, out,
                           sums, N, H, W, Cout, relu, stream);
}
