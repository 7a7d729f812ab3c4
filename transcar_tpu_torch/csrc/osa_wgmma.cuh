// The Hopper OSA tile: K4's concat-free reduce (osa_reduce.cu) and K5's
// 3x3 chain conv (osa_block.cu) on one persistent wgmma kernel body, for
// bfloat16 with every width and Cout a multiple of 8 and 16-byte aligned
// bases (hopper_tile.cuh).
//
//   out[p, o] = round(relu?(acc[p, o] * scale[o] + bias[o]))
//   reduce:  acc[p, o] = sum_i sum_c piece_i[p, c] * W_i[c, o],
//            sums[n, o] += the float32 value before the rounding
//   conv:    acc[p, o] = sum_{tap, c} x[n, i - 1 + tap/3, j - 1 + tap%3, c]
//                                     * w[o, tap, c]      (zero outside)
//
// A persistent block (one per SM) walks (image, pixel tile, Cout tile)
// tiles: one producer thread keeps a 4-stage ring of (A, B) slices of 64
// channels in flight by TMA, and two consumer warpgroups each run wgmma over
// 64 pixels x BN channels (BN = 256 or 128, chosen by the entry), so one
// tile's epilogue overlaps the next tile's loads.  The epilogue works from
// the accumulator registers: the tile's affine staged in shared memory,
// affine and ReLU in float32, one rounding to bfloat16, 8-byte stores after
// one exchange between neighbouring lanes.
//
// - reduce (K4): GEMM per image, M = its H*W pixels, K = sum C_i walked
//   piece by piece.  Piece i is a 3-D tensor map [N, H*W, C_i] with a box
//   of [1, 128, 64]: TMA's zero fill ends a tile at its image's edge and a
//   slice past C_i (160 and 224 are no multiple of 64), in the weight map
//   [Cout, C_i] (K-major, row stride w_ld_i) as well, which keeps the
//   product exact.  The channel sums: a butterfly of warp shuffles, one
//   shared-memory row per warp (no shared atomics: contended, they cost
//   more than the whole multiply) and one float32 global atomic per (tile,
//   channel).
// - conv (K5): the tile is a rectangle of bh x bw = 128 pixels of one image
//   and K = 9 taps x the input's 64-channel slices.  The input is a 4-D map
//   [N, H, W, C] with a box of [1, bh, bw, 64], loaded for tap (ky, kx) at
//   (n, i0 - 1 + ky, j0 - 1 + kx, c0): TMA's zero fill of the elements
//   outside the image is the conv's zero padding and ends a slice past a C
//   of 160 or 224.  The weight is K-major [Cout][9][C], a 3-D map with a box
//   of [BN, 1, 64], or [Cout, 1, 64] where Cout < BN: the B rows past Cout
//   are then left as they are, since they feed only output columns that are
//   never stored.  The epilogue masks the rows past H and the columns past
//   W; no channel sums.
#pragma once

#include "hopper_tile.cuh"

namespace osa {

constexpr int kMaxPieces = 8;
constexpr int BM = 128;           // pixels per tile (two consumer warpgroups)
constexpr int BK = 64;            // K per slice: one 128-byte swizzled row
constexpr int STAGES = 4;
constexpr int THREADS = 384;      // producer warpgroup + 2 consumer warpgroups

struct OsaParams {
  CUtensorMap a[kMaxPieces];      // reduce: piece i [N, HW, C_i], box [1, BM, BK]
                                  // conv: a[0] [N, H, W, C], box [1, bh, bw, BK]
  CUtensorMap b[kMaxPieces];      // reduce: weight i [Cout, C_i], box [BN, BK]
                                  // conv: b[0] [Cout, 9, C], box [BN, 1, BK]
  int width[kMaxPieces];
  int n_pieces;
  const float* scale;
  const float* bias;
  hop::bf16* out;
  float* sums;                    // reduce only
  int HW, Cout, relu;
  int b_rows;                     // rows of a B box: BN, or Cout where smaller
  int tiles_m, tiles_n, tiles;
  int H, W, bw, tiles_w;          // conv only: tiles_m = tiles_h * tiles_w
};

template <int BN>
constexpr int smem_bytes() {
  return 1024 + STAGES * (BM + BN) * BK * 2 + 2 * STAGES * 8 + 10 * BN * 4;
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

template <int BN, bool kConv>
__device__ __forceinline__ void osa_tile(const OsaParams& p) {
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
  constexpr int taps = kConv ? 9 : 1;

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
          for (int tap = 0; tap < taps; ++tap) {
            for (int k0 = 0; k0 < p.width[i]; k0 += BK) {
              hop::mbar_wait(&empty[r.stage], r.phase ^ 1u);
              hop::mbar_expect_tx(&full[r.stage], (BM + p.b_rows) * BK * 2);
              if constexpr (kConv) {
                const int i0 = (mt / p.tiles_w) * (BM / p.bw);
                const int j0 = (mt % p.tiles_w) * p.bw;
                hop::tma_load_4d(sa + r.stage * BM * BK, &p.a[0], &full[r.stage], k0,
                                 j0 - 1 + tap % 3, i0 - 1 + tap / 3, img);
                hop::tma_load_3d(sb + r.stage * BN * BK, &p.b[0], &full[r.stage], k0,
                                 tap, nt * BN);
              } else {
                hop::tma_load_3d(sa + r.stage * BM * BK, &p.a[i], &full[r.stage], k0,
                                 mt * BM, img);
                hop::tma_load_2d(sb + r.stage * BN * BK, &p.b[i], &full[r.stage], k0,
                                 nt * BN);
              }
              r.next();
            }
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
        for (int tap = 0; tap < taps; ++tap) {
          for (int k0 = 0; k0 < p.width[i]; k0 += BK) {
            hop::mbar_wait(&full[r.stage], r.phase);
            const uint64_t da =
                hop::make_desc(sa + r.stage * BM * BK + cw * 64 * BK, 0, 1024);
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
      // lanes of even l % 4 store 4 columns of row0, odd ones of row0 + 8
      const bool odd = lane & 1;
      const int lrow = cw * 64 + warp * 16 + lane / 4;  // and lrow + 8
      bool ok0 = false, ok1 = false, okr;
      size_t orow;
      if constexpr (kConv) {
        const int lr = lrow + (odd ? 8 : 0);
        const int i = (mt / p.tiles_w) * (BM / p.bw) + lr / p.bw;
        const int j = (mt % p.tiles_w) * p.bw + lr % p.bw;
        okr = i < p.H && j < p.W;
        orow = ((static_cast<size_t>(img) * p.H + i) * p.W + j) * p.Cout + col_base +
               2 * (lane & 2);
      } else {
        const int row0 = mt * BM + lrow;
        ok0 = row0 < p.HW;
        ok1 = row0 + 8 < p.HW;
        okr = odd ? ok1 : ok0;
        orow = (static_cast<size_t>(img) * p.HW + row0 + (odd ? 8 : 0)) * p.Cout +
               col_base + 2 * (lane & 2);
      }
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
          if constexpr (!kConv) {
            cs[2 * k] = (ok0 ? v[0] : 0.f) + (ok1 ? v[2] : 0.f);
            cs[2 * k + 1] = (ok0 ? v[1] : 0.f) + (ok1 ? v[3] : 0.f);
          }
          // one exchange with lane ^ 1 gives each lane 4 contiguous columns
          const uint32_t a = pack_bf16(v[0], v[1]), b = pack_bf16(v[2], v[3]);
          const uint32_t got = __shfl_xor_sync(0xffffffffu, odd ? a : b, 1);
          const uint2 w = odd ? make_uint2(got, b) : make_uint2(a, got);
          if (okr && col_base + 8 * j < p.Cout)
            *reinterpret_cast<uint2*>(p.out + orow + 8 * j) = w;
        }
        if constexpr (!kConv) {
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
      }
      if constexpr (!kConv) {
        // the 8 warps' partial rows, then one global atomic per (tile,
        // channel)
        asm volatile("bar.sync 1, 256;\n" ::: "memory");
        if (ct < BN && col_base + ct < p.Cout) {
          float sum = 0.f;
#pragma unroll
          for (int w8 = 0; w8 < 8; ++w8) sum += part[w8 * BN + ct];
          atomicAdd(p.sums + static_cast<size_t>(img) * p.Cout + col_base + ct, sum);
        }
      }
      // keeps the next tile's affine and partials after this tile's reads
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
    }
  }
}

// Launch a kernel of this body on one block per SM (at most one per tile).
template <int BN, typename Kernel>
int launch_tile(Kernel kernel, const OsaParams& p, void* stream) {
  if (p.tiles == 0) return 0;
  constexpr int smem = smem_bytes<BN>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = p.tiles < hop::sm_count() ? p.tiles : hop::sm_count();
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace osa
