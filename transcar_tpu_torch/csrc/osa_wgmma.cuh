// The Hopper OSA tile: K4's concat-free reduce (osa_reduce.cu), K5's 3x3
// chain conv (osa_block.cu), K6's three convs (bottleneck.cu) and the int8
// conv (int8_conv.cu) on one persistent wgmma kernel body, templated on
// the operand type (Bf16Op: bfloat16 in, float32 accumulators, every width
// and Cout a multiple of 8; S8Op: int8 codes in, int32 accumulators, every
// width a multiple of 16) with 16-byte aligned bases (hopper_tile.cuh).
// A K slice is one 128-byte swizzled row either way: 64 bf16 or 128 int8
// channels, so the ring, the descriptors and the staging are byte for
// byte the same.
//
//   out[p, o] = round(relu?(acc[p, o] * scale[o] + bias[o] + res[p, o]))
//   reduce:  acc[p, o] = sum_i sum_c piece_i[p, c] * W_i[c, o],
//            sums[n, o] += the float32 value before the rounding (where
//            sums is not null: a uniform branch)
//   res:     0 (kResid 0); resid[p, o] read as float32 (kResid 1, K6's
//            identity); acc2[p, o] * scale2[o] + bias2[o] (kResid 2, K6's
//            downsample: piece 1 goes to its own accumulator acc2)
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
// - staged output (kStage, K6's BN = 128 instantiations): the epilogue
//   writes the tile's bf16 values into one of two output slots in shared
//   memory (BN / 64 boxes of [BM][64] under the 128-byte swizzle, 8 bytes
//   a lane at the stores' own positions: two wavefronts an instruction),
//   and the producer thread TMA-stores a slot, clipped at the image's edge
//   and past Cout, then waits for the store to have read it before the
//   slot takes the tile after next.  Full 128-byte lines leave the SM
//   asynchronously, in place of 16-byte pieces of rows from every lane.
// - int8 (S8Op; int8_conv.cu): the conv form generalised to a k x k
//   kernel (k = 1, 3 or 7) with padding and stride 1 or 2.  A stride-2
//   conv reads its input through up to four maps, one per (row, column)
//   parity of the tap offset (base + (py * W + px) * C, row and column
//   strides 2 W C and 2 C bytes), so that tap (ky, kx) of output pixel
//   (i, j) is element (i + (oy >> 1), j + (ox >> 1)) of map 2 (oy & 1) +
//   (ox & 1), oy = ky - pad; TMA's zero fill is the padding (and the
//   channels past a width that is no multiple of 128).  A 1x1 stride-1
//   conv takes the reduce form.  Each consumer keeps one slice's wgmma
//   group in flight while it awaits the next slice.  The epilogue
//   dequantizes and folds ConvBN's FrozenBN and ReLU with the module's
//   roundings (S8Op::value; on bfloat16 pairs for a bfloat16 output),
//   writes bfloat16 (staged for BN <= 128) or float32 (from the
//   registers), and where asked takes max |out| over the valid elements:
//   one atomicMax of float bits per block into a scratch pair, whose last
//   block publishes the max and resets the pair.
// - residual (K6's conv3, a reduce form with no sums): kResid 1 has the
//   producer TMA-load the tile's residual [BM, BN] box into its output
//   slot after the tile's slices; the epilogue adds it in float32 from
//   there and writes the output over it.  kResid 2 runs the second piece's
//   slices into acc2 (BN = 128: 2 x 64 accumulator registers) and adds its
//   affine, staged in shared memory, before the ReLU.
#pragma once

#include "hopper_tile.cuh"

namespace osa {

constexpr int kMaxPieces = 8;
constexpr int BM = 128;           // pixels per tile (two consumer warpgroups)
constexpr int BK = 64;            // bf16 K per slice: one 128-byte swizzled row
constexpr int ROW = 128;          // bytes of a slice row
constexpr int STAGES = 4;
constexpr int THREADS = 384;      // producer warpgroup + 2 consumer warpgroups

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// bfloat16 operands, float32 accumulators (K4, K5, K6).
struct Bf16Op {
  using Acc = float;
  static constexpr bool kS8 = false;
  static constexpr int kCh = BK;  // channels a slice
};

// int8 codes, int32 accumulators (the int8 conv).
struct S8Op {
  using Acc = int;
  static constexpr bool kS8 = true;
  static constexpr int kCh = ROW;
  // The int8 ConvBN's value of one accumulator, with the module's
  // roundings: t = o(float(acc) * dq), dq = s_x * s_w[c] in float32; where
  // fold, u = o(t * sc) and v = o(u + bi) (sc, bi: FrozenBN's scale and
  // bias already cast to the output type); max(v, 0) where relu.  o()
  // rounds to bfloat16 (bf16) or is none (float32); __fmul_rn / __fadd_rn
  // keep each product and sum rounded on its own, as separate PyTorch ops
  // round them.
  __device__ __forceinline__ static float value(int acc, float dq, float sc, float bi,
                                                bool fold, bool relu, bool bf16) {
    float v = __fmul_rn(__int2float_rn(acc), dq);
    if (bf16) v = round_bf16(v);
    if (fold) {
      v = __fmul_rn(v, sc);
      if (bf16) v = round_bf16(v);
      v = __fadd_rn(v, bi);
      if (bf16) v = round_bf16(v);
    }
    return relu ? fmaxf(v, 0.f) : v;
  }
};

// bfloat16 pairs (bits of a __nv_bfloat162): the exact product or sum
// rounded once to bfloat16 (what PyTorch's eager bf16 ops give: a float32
// product of two bf16 values is exact, and a float32 sum of two is exact
// wherever its bf16 rounding could differ), and the max.
__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t bf16x2_add(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t bf16x2_max(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// The int8 epilogue's max |out| of a block (`m`, one value a consumer
// thread; `red` 8 floats of shared memory): one atomicMax of its float
// bits into scratch[0], then a count in scratch[1]; the block that counts
// last publishes the max into *out and resets both, so the pair is zero
// again for the next launch and no memset precedes one.
__device__ __forceinline__ void publish_amax(float m, float* red, int tid, int nthreads,
                                             unsigned* scratch, float* out) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((tid & 31) == 0) red[tid >> 5] = m;
  if (nthreads == 256)
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
  else
    __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < nthreads / 32; ++w) m = fmaxf(m, red[w]);
    atomicMax(scratch, __float_as_uint(m));
    __threadfence();
    if (atomicAdd(scratch + 1, 1u) == gridDim.x * gridDim.y * gridDim.z - 1) {
      __threadfence();
      *out = __uint_as_float(atomicExch(scratch, 0u));
      atomicExch(scratch + 1, 0u);
    }
  }
}

struct OsaParams {
  CUtensorMap a[kMaxPieces];      // reduce: piece i [N, HW, C_i], box [1, BM, BK]
                                  // conv: a[0] [N, H, W, C], box [1, bh, bw, BK]
  CUtensorMap b[kMaxPieces];      // reduce: weight i [Cout, C_i], box [BN, BK]
                                  // conv: b[0] [Cout, 9, C], box [BN, 1, BK]
  CUtensorMap o;                  // kStage: out, box [1, BM, 64] / [1, bh, bw, 64]
  CUtensorMap r;                  // kResid 1: the residual [N, HW, Cout], box
                                  // [1, BM, 64]
  int width[kMaxPieces];
  int n_pieces;
  const float* scale;
  const float* bias;
  hop::bf16* out;
  float* sums;                    // reduce only; null: none
  const float* scale2;            // kResid 2: piece 1's affine
  const float* bias2;
  int HW, Cout, relu;
  int b_rows;                     // rows of a B box: BN, or Cout where smaller
  int tiles_m, tiles_n, tiles;
  int H, W, bw, tiles_w;          // conv only: tiles_m = tiles_h * tiles_w
  int taps, kw, pad, sshift;      // conv only: kw x kw taps, padding, stride 1 << sshift
  // S8Op only
  const float* sx;                // the activation scale, a device scalar
  const float* sw;                // [Cout] weight scales
  float* out_f32;                 // float32 output, else `out` (bfloat16)
  float* amax;                    // null, or where max |out| is published
  unsigned* scratch;              // [2], zero between launches (publish_amax)
  int fold;                       // scale / bias: FrozenBN's, else none
};

// kStage: two output slots of BM x BN, as BN / 64 boxes of [BM][64] under
// the 128-byte swizzle, and a full / ready barrier pair for each.
template <int BN, bool kStage = false>
constexpr int smem_bytes() {
  return 1024 + STAGES * (BM + BN) * ROW + (kStage ? 2 * BM * BN * 2 + 4 * 8 : 0) +
         2 * STAGES * 8 + 10 * BN * 4;
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// One 64-deep slice into accumulator d, waited for, then the stage freed.
template <int BN>
__device__ __forceinline__ void mma_stage(float* d, uint64_t da, uint64_t db) {
  hop::fence_regs<BN / 2>(d);
  hop::wgmma_fence();
  hop::mma_slice<BN, 0, 0>(d, da, db);
  hop::wgmma_commit();
  hop::wgmma_wait<0>();
  hop::fence_regs<BN / 2>(d);
}

// The BN / 64 column boxes of Cout tile nt that hold output columns.
template <int BN>
__device__ __forceinline__ int live_boxes(const OsaParams& p, int nt) {
  const int left = (p.Cout - nt * BN + 63) / 64;
  return left < BN / 64 ? left : BN / 64;
}

// kStage: TMA-store the output slot of the block's tile number seq once the
// epilogue has staged it, then wait until the store has read the slot.
template <int BN, bool kConv>
__device__ __forceinline__ void store_slot(const OsaParams& p, const hop::bf16* so,
                                           uint64_t* sready, int seq) {
  const int tile = blockIdx.x + seq * gridDim.x;
  const int nt = tile % p.tiles_n, rest = tile / p.tiles_n;
  const int mt = rest % p.tiles_m, img = rest / p.tiles_m;
  const int s = seq & 1;
  hop::mbar_wait(&sready[s], (seq >> 1) & 1);
  const int boxes = live_boxes<BN>(p, nt);
  for (int h = 0; h < boxes; ++h) {
    const hop::bf16* src = so + (s * BN / 64 + h) * BM * 64;
    if constexpr (kConv)
      hop::tma_store_4d(&p.o, src, nt * BN + h * 64, (mt % p.tiles_w) * p.bw,
                        (mt / p.tiles_w) * (BM / p.bw), img);
    else
      hop::tma_store_3d(&p.o, src, nt * BN + h * 64, mt * BM, img);
  }
  hop::bulk_commit();
  hop::bulk_wait_read<0>();
}

template <int BN, bool kConv, int kResid = 0, bool kStage = false, typename Op = Bf16Op>
__device__ __forceinline__ void osa_tile(const OsaParams& p) {
  static_assert(kResid == 0 || !kConv, "a residual takes the reduce form");
  static_assert(kResid != 1 || kStage, "the residual arrives in an output slot");
  static_assert(!kStage || BN % 64 == 0, "a slot holds [BM][64] boxes");
  static_assert(!Op::kS8 || kResid == 0, "the int8 conv has no residual");
  using Acc = typename Op::Acc;
  constexpr int KC = Op::kCh;                                  // channels a slice
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sa = base;                                    // [S][BM][ROW]
  unsigned char* sb = sa + STAGES * BM * ROW;                  // [S][BN][ROW]
  constexpr int kSlot = kStage ? BM * BN : 0;                  // per slot
  hop::bf16* so = reinterpret_cast<hop::bf16*>(sb + STAGES * BN * ROW);  // [2][BN/64][BM][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(so + 2 * kSlot);
  uint64_t* empty = full + STAGES;
  uint64_t* sfull = empty + STAGES;                            // kStage: [2]
  uint64_t* sready = sfull + 2;                                // kStage: [2]
  float* part = reinterpret_cast<float*>(empty + STAGES + (kStage ? 4 : 0));
  float* sscale = part + 8 * BN;                               // [BN] this tile's
  float* sbias = sscale + BN;                                  // [BN] affine
  const int taps = kConv ? p.taps : 1;

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 2);        // both consumer warpgroups
    }
    if constexpr (kStage) {
      for (int s = 0; s < 2; ++s) {
        hop::mbar_init(&sfull[s], 1);
        hop::mbar_init(&sready[s], 1);
      }
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every TMA load (and store) --------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (t == 0) {
      for (int i = 0; i < p.n_pieces; ++i) {
        hop::tma_prefetch(&p.a[i]);
        hop::tma_prefetch(&p.b[i]);
      }
      hop::Ring<STAGES> r;
      int seq = 0;                         // the block's tile number
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++seq) {
        const int nt = tile % p.tiles_n, rest = tile / p.tiles_n;
        const int mt = rest % p.tiles_m, img = rest / p.tiles_m;
        for (int i = 0; i < p.n_pieces; ++i) {
          for (int tap = 0; tap < taps; ++tap) {
            for (int k0 = 0; k0 < p.width[i]; k0 += KC) {
              hop::mbar_wait(&empty[r.stage], r.phase ^ 1u);
              hop::mbar_expect_tx(&full[r.stage], (BM + p.b_rows) * ROW);
              if constexpr (kConv) {
                const int i0 = (mt / p.tiles_w) * (BM / p.bw);
                const int j0 = (mt % p.tiles_w) * p.bw;
                // tap offset (oy, ox); stride 2: the map of its parity
                const int oy = tap / p.kw - p.pad, ox = tap % p.kw - p.pad;
                const int sm = (1 << p.sshift) - 1;
                hop::tma_load_4d(sa + r.stage * BM * ROW, &p.a[2 * (oy & sm) + (ox & sm)],
                                 &full[r.stage], k0, j0 + (ox >> p.sshift),
                                 i0 + (oy >> p.sshift), img);
                hop::tma_load_3d(sb + r.stage * BN * ROW, &p.b[0], &full[r.stage], k0,
                                 tap, nt * BN);
              } else {
                hop::tma_load_3d(sa + r.stage * BM * ROW, &p.a[i], &full[r.stage], k0,
                                 mt * BM, img);
                hop::tma_load_2d(sb + r.stage * BN * ROW, &p.b[i], &full[r.stage], k0,
                                 nt * BN);
              }
              r.next();
            }
          }
        }
        if constexpr (kStage) {
          // slot seq & 1: the store of tile seq - 2 leaves it, then the
          // residual of this tile (or the bare signal) fills it
          const int s = seq & 1;
          if (seq >= 2) store_slot<BN, kConv>(p, so, sready, seq - 2);
          if constexpr (kResid == 1) {
            const int boxes = live_boxes<BN>(p, nt);
            hop::mbar_expect_tx(&sfull[s], boxes * BM * 64 * 2);
            for (int h = 0; h < boxes; ++h)
              hop::tma_load_3d(so + (s * BN / 64 + h) * BM * 64, &p.r, &sfull[s],
                               nt * BN + h * 64, mt * BM, img);
          } else {
            hop::mbar_arrive(&sfull[s]);
          }
        }
      }
      if constexpr (kStage) {
        for (int k = seq >= 2 ? seq - 2 : 0; k < seq; ++k)
          store_slot<BN, kConv>(p, so, sready, k);
        hop::bulk_wait<0>();
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns tile rows [64 cw, 64 cw + 64) ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;
    const int warp = t / 32, lane = t % 32;
    const int ct = threadIdx.x - 128;                   // 0 .. 255
    const bool sums = !Op::kS8 && !kConv && kResid == 0 && p.sums != nullptr;  // uniform
    // S8Op: the epilogue's flags (uniform) and the running max |out|
    const bool fold = Op::kS8 && p.fold, bf16_out = !Op::kS8 || p.out_f32 == nullptr;
    const float sx = Op::kS8 ? *p.sx : 0.f;
    float amax = 0.f;
    uint32_t amax2 = 0u;          // S8Op, bfloat16 out: max |out| as a bf16 pair
    int held = -1;                // S8Op: the stage whose wgmma group is in flight
    Acc acc[BN / 2];
    float acc2[kResid == 2 ? BN / 2 : 1];
    hop::Ring<STAGES> r;
    int seq = 0;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++seq) {
      const int nt = tile % p.tiles_n, rest = tile / p.tiles_n;
      const int mt = rest % p.tiles_m, img = rest / p.tiles_m;
      const int col_base = nt * BN;
      // this tile's affine, read before the mainloop so that its latency
      // overlaps the multiply
      float aff[4] = {0.f, 0.f, 0.f, 0.f};
      if (ct < BN && col_base + ct < p.Cout) {
        if constexpr (Op::kS8) {
          // dq = s_x * s_w[c]; FrozenBN's scale and bias cast to the output
          aff[0] = __fmul_rn(sx, p.sw[col_base + ct]);
          aff[1] = fold ? p.scale[col_base + ct] : 1.f;
          aff[2] = fold ? p.bias[col_base + ct] : 0.f;
          if (bf16_out) {
            aff[1] = round_bf16(aff[1]);
            aff[2] = round_bf16(aff[2]);
          }
        } else {
          aff[0] = p.scale[col_base + ct];
          aff[1] = p.bias[col_base + ct];
        }
        if constexpr (kResid == 2) {
          aff[2] = p.scale2[col_base + ct];
          aff[3] = p.bias2[col_base + ct];
        }
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
      if constexpr (kResid == 2) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc2[i] = 0.f;
      }
      for (int i = 0; i < p.n_pieces; ++i) {
        for (int tap = 0; tap < taps; ++tap) {
          for (int k0 = 0; k0 < p.width[i]; k0 += KC) {
            hop::mbar_wait(&full[r.stage], r.phase);
            const uint64_t da =
                hop::make_desc(sa + r.stage * BM * ROW + cw * 64 * ROW, 0, 1024);
            const uint64_t db = hop::make_desc(sb + r.stage * BN * ROW, 0, 1024);
            if constexpr (kResid == 2) {
              if (i == 1)
                mma_stage<BN>(acc2, da, db);
              else
                mma_stage<BN>(acc, da, db);
            } else if constexpr (Op::kS8) {
              // one slice's wgmma group stays in flight while the next
              // slice is awaited: the stage of the slice before is freed
              // once its group is done
              hop::wgmma_fence();
              hop::mma_slice_s8<BN>(acc, da, db);
              hop::wgmma_commit();
              hop::wgmma_wait<1>();
              if (t == 0 && held >= 0) hop::mbar_arrive(&empty[held]);
              held = r.stage;
              r.next();
              continue;
            } else {
              mma_stage<BN>(acc, da, db);
            }
            if (t == 0) hop::mbar_arrive(&empty[r.stage]);
            r.next();
          }
        }
      }
      if constexpr (Op::kS8) {
        hop::wgmma_wait<0>();
        hop::fence_regs<BN / 2>(acc);
        if (t == 0 && held >= 0) hop::mbar_arrive(&empty[held]);
        held = -1;
      }

      // ---- epilogue from the accumulator registers ---------------------
      float* sscale2 = part;                            // kResid 2 (no sums)
      float* sbias2 = part + BN;
      float* sdq = part;                                // S8Op (no sums)
      if (ct < BN) {
        if constexpr (Op::kS8) {
          sdq[ct] = aff[0];
          sscale[ct] = aff[1];
          sbias[ct] = aff[2];
        } else {
          sscale[ct] = aff[0];
          sbias[ct] = aff[1];
        }
        if constexpr (kResid == 2) {
          sscale2[ct] = aff[2];
          sbias2[ct] = aff[3];
        }
      }
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      // lanes of even l % 4 store 4 columns of row0, odd ones of row0 + 8
      const bool odd = lane & 1;
      const int lrow = cw * 64 + warp * 16 + lane / 4;  // and lrow + 8
      const int srow = lrow + (odd ? 8 : 0);            // the row this lane stores
      bool ok0 = false, ok1 = false, okr;
      size_t orow;
      if constexpr (kConv) {
        const int i = (mt / p.tiles_w) * (BM / p.bw) + srow / p.bw;
        const int j = (mt % p.tiles_w) * p.bw + srow % p.bw;
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
      // S8Op: the output pixels of this lane's two accumulator rows (lrow,
      // lrow + 8) and whether they lie inside the image (ok0, ok1)
      size_t pix0 = 0, pix1 = 0;
      if constexpr (Op::kS8) {
        if constexpr (kConv) {
          const int i = (mt / p.tiles_w) * (BM / p.bw) + lrow / p.bw;
          const int j = (mt % p.tiles_w) * p.bw + lrow % p.bw;
          const int i8 = (mt / p.tiles_w) * (BM / p.bw) + (lrow + 8) / p.bw;
          const int j8 = (mt % p.tiles_w) * p.bw + (lrow + 8) % p.bw;
          ok0 = i < p.H && j < p.W;
          ok1 = i8 < p.H && j8 < p.W;
          pix0 = (static_cast<size_t>(img) * p.H + i) * p.W + j;
          pix1 = (static_cast<size_t>(img) * p.H + i8) * p.W + j8;
        } else {
          pix0 = static_cast<size_t>(img) * p.HW + mt * BM + lrow;
          pix1 = pix0 + 8;
        }
      }
      // kStage: this lane's 8 bytes of slot row srow in column group j sit
      // in box j / 8 at 16-byte chunk (j % 8) ^ (srow % 8) (the swizzle)
      hop::bf16* slot = so + (seq & 1) * kSlot + srow * 64 + 2 * (lane & 2);
      if constexpr (kStage) hop::mbar_wait(&sfull[seq & 1], (seq >> 1) & 1);
#pragma unroll
      for (int g = 0; g < BN / 32; ++g) {
        float cs[8];                       // column sums of this thread's 2 rows
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = 4 * g + k;
          const int lc = 8 * j + 2 * (lane & 3);          // column within the tile
          uint2* sp = reinterpret_cast<uint2*>(
              slot + (j / 8) * BM * 64 + (((j % 8) ^ (srow & 7)) << 3));
          const float2 sc = *reinterpret_cast<const float2*>(sscale + lc);
          const float2 bi = *reinterpret_cast<const float2*>(sbias + lc);
          float v[4];
          uint32_t a, b;                   // bf16 pairs of rows lrow, lrow + 8
          if constexpr (Op::kS8) {
            const float2 dq = *reinterpret_cast<const float2*>(sdq + lc);
            const bool relu = p.relu, live = p.amax != nullptr && col_base + 8 * j < p.Cout;
            if (bf16_out) {
              // S8Op::value on bfloat16 pairs: the dequantize in float32,
              // one rounding to bf16, then FrozenBN and ReLU in bf16
              a = pack_bf16(__fmul_rn(__int2float_rn(acc[4 * j]), dq.x),
                            __fmul_rn(__int2float_rn(acc[4 * j + 1]), dq.y));
              b = pack_bf16(__fmul_rn(__int2float_rn(acc[4 * j + 2]), dq.x),
                            __fmul_rn(__int2float_rn(acc[4 * j + 3]), dq.y));
              if (fold) {
                const uint32_t sc2 = pack_bf16(sc.x, sc.y), bi2 = pack_bf16(bi.x, bi.y);
                a = bf16x2_add(bf16x2_mul(a, sc2), bi2);
                b = bf16x2_add(bf16x2_mul(b, sc2), bi2);
              }
              if (relu) {
                a = bf16x2_max(a, 0u);
                b = bf16x2_max(b, 0u);
              }
              if (live && ok0) amax2 = bf16x2_max(amax2, a & 0x7fff7fffu);
              if (live && ok1) amax2 = bf16x2_max(amax2, b & 0x7fff7fffu);
            } else {
              v[0] = S8Op::value(acc[4 * j], dq.x, sc.x, bi.x, fold, relu, false);
              v[1] = S8Op::value(acc[4 * j + 1], dq.y, sc.y, bi.y, fold, relu, false);
              v[2] = S8Op::value(acc[4 * j + 2], dq.x, sc.x, bi.x, fold, relu, false);
              v[3] = S8Op::value(acc[4 * j + 3], dq.y, sc.y, bi.y, fold, relu, false);
              if (live && ok0) amax = fmaxf(amax, fmaxf(fabsf(v[0]), fabsf(v[1])));
              if (live && ok1) amax = fmaxf(amax, fmaxf(fabsf(v[2]), fabsf(v[3])));
              if constexpr (!kStage) {
                // float32: each lane's two columns of its two rows, from the registers
                if (col_base + 8 * j < p.Cout) {
                  const size_t c = col_base + lc;
                  if (ok0)
                    *reinterpret_cast<float2*>(p.out_f32 + pix0 * p.Cout + c) =
                        make_float2(v[0], v[1]);
                  if (ok1)
                    *reinterpret_cast<float2*>(p.out_f32 + pix1 * p.Cout + c) =
                        make_float2(v[2], v[3]);
                }
              }
              continue;
            }
          } else {
            v[0] = acc[4 * j] * sc.x + bi.x;
            v[1] = acc[4 * j + 1] * sc.y + bi.y;
            v[2] = acc[4 * j + 2] * sc.x + bi.x;
            v[3] = acc[4 * j + 3] * sc.y + bi.y;
            if constexpr (kResid == 1) {
              // the residual in the slot, 4 columns of srow a lane: lane ^ 1
              // holds the other row's half of this lane's columns
              const uint2 res = *sp;
              const uint32_t got = __shfl_xor_sync(0xffffffffu, odd ? res.x : res.y, 1);
              const float2 r0 = unpack_bf16(odd ? got : res.x);
              const float2 r8 = unpack_bf16(odd ? res.y : got);
              v[0] += r0.x;
              v[1] += r0.y;
              v[2] += r8.x;
              v[3] += r8.y;
            } else if constexpr (kResid == 2) {
              const float2 sd = *reinterpret_cast<const float2*>(sscale2 + lc);
              const float2 bd = *reinterpret_cast<const float2*>(sbias2 + lc);
              v[0] += acc2[4 * j] * sd.x + bd.x;
              v[1] += acc2[4 * j + 1] * sd.y + bd.y;
              v[2] += acc2[4 * j + 2] * sd.x + bd.x;
              v[3] += acc2[4 * j + 3] * sd.y + bd.y;
            }
            if (p.relu) {
#pragma unroll
              for (int e = 0; e < 4; ++e) v[e] = fmaxf(v[e], 0.f);
            }
            if (sums) {
              cs[2 * k] = (ok0 ? v[0] : 0.f) + (ok1 ? v[2] : 0.f);
              cs[2 * k + 1] = (ok0 ? v[1] : 0.f) + (ok1 ? v[3] : 0.f);
            }
            a = pack_bf16(v[0], v[1]);
            b = pack_bf16(v[2], v[3]);
          }
          // one exchange with lane ^ 1 gives each lane 4 contiguous columns
          const uint32_t got = __shfl_xor_sync(0xffffffffu, odd ? a : b, 1);
          const uint2 w = odd ? make_uint2(got, b) : make_uint2(a, got);
          if constexpr (kStage)
            *sp = w;                       // TMA stores it, clipped at the edges
          else if (okr && col_base + 8 * j < p.Cout)
            *reinterpret_cast<uint2*>(p.out + orow + 8 * j) = w;
        }
        if (sums) {
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
      if (sums) {
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
      if constexpr (kStage) hop::fence_proxy_async();   // the slot, for TMA
      // keeps the next tile's affine and partials after this tile's reads
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      if constexpr (kStage) {
        if (ct == 0) hop::mbar_arrive(&sready[seq & 1]);
      }
    }
    if constexpr (Op::kS8) {
      // after the last tile's closing barrier: `part` is free
      const float2 m2 = unpack_bf16(amax2);
      if (p.amax != nullptr)
        publish_amax(fmaxf(amax, fmaxf(m2.x, m2.y)), part, ct, 256, p.scratch, p.amax);
    }
  }
}

// The reduce form's params over n_pieces pieces [N, H*W, widths[i]] and
// K-major weights [Cout, .] of row stride w_ld[i] (elements), on BN-wide
// Cout tiles; the caller sets the affine, out, sums, relu and residual.
// Returns a cudaError_t.
inline int reduce_params(OsaParams* p, int n_pieces, const void* const* pieces,
                         const void* const* weights, const int* widths,
                         const int* w_ld, int N, int H, int W, int Cout, int bn) {
  if (n_pieces < 1 || n_pieces > kMaxPieces || Cout % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  p->n_pieces = n_pieces;
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
    if (!hop::make_map(&p->a[i], pieces[i], 3, adims, astrides, abox) ||
        !hop::make_map(&p->b[i], weights[i], 2, bdims, bstrides, bbox))
      return static_cast<int>(cudaErrorInvalidValue);
    p->width[i] = widths[i];
  }
  p->HW = H * W;
  p->Cout = Cout;
  p->b_rows = bn;
  p->tiles_m = (H * W + BM - 1) / BM;
  p->tiles_n = (Cout + bn - 1) / bn;
  p->tiles = N * p->tiles_m * p->tiles_n;
  return 0;
}

// The conv form's tile rectangle: bh x bw = 128 with the fewest pixels
// past the image (bw = 16 on 232 x 400, 64 on 29 x 50).
inline int tile_width(int H, int W) {
  int best = 128;
  long waste = -1;
  for (int bw : {128, 64, 32, 16}) {
    const int bh = BM / bw;
    const long cover = static_cast<long>((H + bh - 1) / bh) * bh * ((W + bw - 1) / bw) * bw;
    if (waste < 0 || cover < waste) { waste = cover; best = bw; }
  }
  return best;
}

// The conv form's params: x [N, H, W, C], wk [Cout, 3, 3, C] (K-major) on
// BN-wide Cout tiles; the caller sets the affine, out and relu.  Returns a
// cudaError_t.
inline int conv3x3_params(OsaParams* p, const void* x, int C, const void* wk, int N,
                          int H, int W, int Cout, int bn) {
  if (C % 8 != 0 || Cout % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  p->n_pieces = 1;
  p->b_rows = Cout < bn ? Cout : bn;
  p->width[0] = C;
  p->bw = tile_width(H, W);
  const uint64_t c = C;
  const uint64_t adims[4] = {c, static_cast<uint64_t>(W), static_cast<uint64_t>(H),
                             static_cast<uint64_t>(N)};
  const uint64_t astrides[3] = {c * 2, c * W * 2, c * W * H * 2};
  const uint32_t abox[4] = {BK, static_cast<uint32_t>(p->bw),
                            static_cast<uint32_t>(BM / p->bw), 1};
  const uint64_t bdims[3] = {c, 9, static_cast<uint64_t>(Cout)};
  const uint64_t bstrides[2] = {c * 2, c * 9 * 2};
  const uint32_t bbox[3] = {BK, 1, static_cast<uint32_t>(p->b_rows)};
  if (!hop::make_map(&p->a[0], x, 4, adims, astrides, abox) ||
      !hop::make_map(&p->b[0], wk, 3, bdims, bstrides, bbox))
    return static_cast<int>(cudaErrorInvalidValue);
  p->Cout = Cout;
  p->H = H;
  p->W = W;
  p->taps = 9;
  p->kw = 3;
  p->pad = 1;
  p->sshift = 0;
  p->tiles_w = (W + p->bw - 1) / p->bw;
  p->tiles_m = p->tiles_w * ((H + BM / p->bw - 1) / (BM / p->bw));
  p->tiles_n = (Cout + bn - 1) / bn;
  p->tiles = N * p->tiles_m * p->tiles_n;
  return 0;
}

// kStage's output map, or kResid 1's residual map (the same shape), over a
// bfloat16 tensor of N images: the reduce form's [N, HW, Cout] with a box
// of [1, BM, 64], or the conv form's [N, H, W, Cout] with a box of [1, bh,
// bw, 64] (after conv3x3_params).  Returns false on failure.
inline bool slot_map(CUtensorMap* map, const void* base, const OsaParams& p, bool conv,
                     int N) {
  const uint64_t c = p.Cout;
  if (conv) {
    const uint64_t dims[4] = {c, static_cast<uint64_t>(p.W), static_cast<uint64_t>(p.H),
                              static_cast<uint64_t>(N)};
    const uint64_t strides[3] = {c * 2, c * p.W * 2, c * p.W * p.H * 2};
    const uint32_t box[4] = {64, static_cast<uint32_t>(p.bw),
                             static_cast<uint32_t>(BM / p.bw), 1};
    return hop::make_map(map, base, 4, dims, strides, box);
  }
  const uint64_t dims[3] = {c, static_cast<uint64_t>(p.HW), static_cast<uint64_t>(N)};
  const uint64_t strides[2] = {c * 2, c * p.HW * 2};
  const uint32_t box[3] = {64, BM, 1};
  return hop::make_map(map, base, 3, dims, strides, box);
}

// Launch a kernel of this body on one block per SM (at most one per tile).
template <int BN, bool kStage = false, typename Kernel>
int launch_tile(Kernel kernel, const OsaParams& p, void* stream) {
  if (p.tiles == 0) return 0;
  constexpr int smem = smem_bytes<BN, kStage>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = p.tiles < hop::sm_count() ? p.tiles : hop::sm_count();
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace osa
