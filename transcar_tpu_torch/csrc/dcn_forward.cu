// K1: DCNv2 forward (3x3, stride 1, pad 1, dilation 1) as an implicit GEMM.
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
// coordinate math in float32 (dcn_tap.cuh).  Layouts: x [N,H,W,Cin],
// offset_mask [N,H,W,27] (ch 2k = dy_k, 2k+1 = dx_k, 18+k = mask logit),
// out [N,H,W,Cout]; all contiguous.
//
// Two tiles:
// - dcn_forward_bf16_wgmma: the Hopper tile (hopper_tile.cuh) for bfloat16
//   with Cin % 8 == 0, Cout % 8 == 0 and 16-byte aligned x, w and out.  The
//   weight is K-major, wk [Cout, 3, 3, Cin] = [Cout][9][Cin].  A persistent
//   block (one per SM) walks tiles of a bh x bw pixel rectangle (<= 128
//   pixels, chosen per shape so that the rounds of one tile per SM come out
//   full, see pick_tile) x BN output channels (BN = 256 where Cout > 128,
//   so one gather serves all of a 256-wide Cout).  K walks the 64-channel
//   slices and, within each, the 9 taps, through a ring of 2 stages.  A
//   gather warpgroup writes each slice's A: per tile a thread computes one
//   pixel's corners and weights x sigma(mask) for the 9 taps in float32
//   into a shared table (dcn_tap.cuh); per slice 8 neighbouring threads
//   load one 128-byte corner row together (16 bytes each; a thread's 32
//   loads, 8 pixels x 4 corners, all in flight), and each writes its
//   pixels' modulated sample rounded to bfloat16 into the 128-byte swizzled
//   [128 px][64 ch] stage, the same bytes K3's d_W kernel writes, then
//   fence.proxy.async and an mbarrier arrive.  The 9 taps of a slice read
//   overlapping corner rows of the tile's neighbourhood, so the block asks
//   for the smallest shared-memory carve-out that holds it and leaves the
//   rest of the SM's memory to L1, which serves those rows again.  The
//   first gather thread also brings the weight slice [BN][64] by TMA from a
//   3-D map [Cout][9][Cin] (its zero fill ends a slice past a Cin that is no
//   multiple of 64).  Two consumer warpgroups each run wgmma m64nBN over 64
//   of the tile's rows with float32 accumulators; the epilogue rounds once
//   to bfloat16 and, after a 4 x 4 transpose of packed words within each
//   quad of lanes, stores 16 bytes a lane, masked past the image and Cout.
// - dcn_forward_f32: the first tile, for float32 (the checks): a block of
//   64 pixels x 128 channels that stages a 32-wide K slice at a time and
//   multiplies with CUDA-core FMAs (no TF32); w [3,3,Cin,Cout] = [9*Cin,
//   Cout] row-major.  Requires Cin % 32 == 0, Cout % 8 == 0 and 16-byte
//   aligned x and w (checked by the wrapper).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dcn_tap.cuh"
#include "hopper_tile.cuh"

#include <cstdint>

namespace {

constexpr int BM = 64;          // output pixels per block
constexpr int BN = 128;         // output channels per block
constexpr int BK = 32;          // K (= tap-major input channels) per step
constexpr int NT = 128;         // threads per block (4 warps)
constexpr int A_LD = BK + 8;    // padded smem row lengths (elements), 16-byte
constexpr int B_LD = BN + 8;    // aligned rows

using bf16 = __nv_bfloat16;

// One (pixel, tap): the four bilinear corners as pixel indices into x (-1 =
// outside the image) and their weights with sigma(mask) folded in.
struct __align__(16) ModTap {
  int off[4];
  float w[4];
};

// 8 contiguous floats, 16-byte aligned.
__device__ __forceinline__ void copy8(float* dst, const float* src) {
#pragma unroll
  for (int v = 0; v < 2; ++v)
    reinterpret_cast<float4*>(dst)[v] = reinterpret_cast<const float4*>(src)[v];
}
__device__ __forceinline__ void zero8(float* dst) {
#pragma unroll
  for (int v = 0; v < 2; ++v) reinterpret_cast<float4*>(dst)[v] = make_float4(0, 0, 0, 0);
}

__global__ void __launch_bounds__(NT)
dcn_forward_kernel(const float* __restrict__ x, const float* __restrict__ om,
                   const float* __restrict__ w, float* __restrict__ out,
                   int N, int H, int W, int Cin, int Cout) {
  __shared__ ModTap taps[BM * 9];
  __shared__ __align__(16) float a_s[BM * A_LD];
  __shared__ __align__(16) float b_s[BK * B_LD];

  const int HW = H * W;
  const int M = N * HW;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;

  // 1. Sampling table: once per (pixel, tap), float32 throughout.
  for (int e = tid; e < BM * 9; e += NT) {
    const int mi = e / 9, k = e - mi * 9;
    const int p = m0 + mi;
    const dcn::Tap t = p < M ? dcn::make_tap(om, p, k, H, W) : dcn::empty_tap();
    ModTap mt;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      mt.off[c] = t.off[c];
      mt.w[c] = t.w[c] * t.sig;
    }
    taps[e] = mt;
  }

  // Accumulators: an 8x8 register tile, rows ty + 8i, columns tx + 16j.
  float acc[8][8];
  const int tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  __syncthreads();

  const int csteps = Cin / BK;
  for (int s = 0; s < 9 * csteps; ++s) {
    const int k = s / csteps;
    const int c0 = (s - k * csteps) * BK;

    // 2. B tile: rows k*Cin + c0 .. +BK of w, columns n0 .. n0+BN.
    for (int e = tid; e < BK * (BN / 8); e += NT) {
      const int r = e / (BN / 8), cv = (e - r * (BN / 8)) * 8;
      float* dst = b_s + r * B_LD + cv;
      if (n0 + cv < Cout)
        copy8(dst, w + static_cast<size_t>(k * Cin + c0 + r) * Cout + n0 + cv);
      else
        zero8(dst);
    }

    // 3. A tile: two threads per pixel, 16 channels each, 4 gathered corners.
    {
      const int mi = tid >> 1, ch = (tid & 1) * 16;
      const ModTap& t = taps[mi * 9 + k];
      float a[16];
#pragma unroll
      for (int q = 0; q < 16; ++q) a[q] = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (t.off[c] >= 0) {
          const float4* v = reinterpret_cast<const float4*>(
              x + static_cast<size_t>(t.off[c]) * Cin + c0 + ch);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 f = v[q];
            a[4 * q] += t.w[c] * f.x;
            a[4 * q + 1] += t.w[c] * f.y;
            a[4 * q + 2] += t.w[c] * f.z;
            a[4 * q + 3] += t.w[c] * f.w;
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        reinterpret_cast<float4*>(a_s + mi * A_LD + ch)[q] =
            make_float4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
    }
    __syncthreads();

    // 4. Multiply.
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float av[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = a_s[(ty + 8 * i) * A_LD + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = b_s[kk * B_LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }

  // 5. Epilogue.
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int p = m0 + ty + 8 * i;
    if (p >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < Cout) out[static_cast<size_t>(p) * Cout + col] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// The Hopper tile (see the file comment).
// ---------------------------------------------------------------------------

constexpr int FM = 128;               // tile rows (two consumer warpgroups)
constexpr int FK = 64;                // channels per slice: one 128-byte row
// Two stages: the one gather warpgroup, not the ring, sets the pace, and
// each stage's shared memory is taken from the L1 that serves the corner
// rows (a 3-stage ring was slower at both flagship shapes; PERF.md).
constexpr int F_STAGES = 2;
constexpr int F_THREADS = 384;        // gather warpgroup + 2 consumer warpgroups

struct FwdParams {
  CUtensorMap w;                      // [Cout][9][Cin] K-major, box [BN, 1, 64]
  const bf16* x;
  const bf16* om;
  bf16* out;
  int N, H, W, Cin, Cout;
  int cs;                             // channel slices per tap
  int bh, bw;                         // the tile's pixel rectangle, bh * bw <= FM
  int tiles_h, tiles_w, tiles_n, tiles;
};

// Shared memory: the ring of (A, B) slices, then the tile's tap table
// [9][FM].  It leaves the rest of the SM's 256 KB to L1, which serves the
// corner rows that the 9 taps of one channel slice share.
template <int BN>
constexpr int fwd_smem_bytes() {
  return 1024 + F_STAGES * (FM + BN) * FK * 2 + 9 * FM * static_cast<int>(sizeof(ModTap)) +
         2 * F_STAGES * 8;
}

// The tile index's image, pixel rectangle origin and Cout tile.
struct TileAt {
  int img, i0, j0, nt;
};
__device__ __forceinline__ TileAt tile_at(const FwdParams& p, int tile) {
  TileAt a;
  a.nt = tile % p.tiles_n;
  int rest = tile / p.tiles_n;
  a.j0 = (rest % p.tiles_w) * p.bw;
  rest /= p.tiles_w;
  a.i0 = (rest % p.tiles_h) * p.bh;
  a.img = rest / p.tiles_h;
  return a;
}

template <int BN>
__global__ void __launch_bounds__(F_THREADS, 1)
dcn_forward_wgmma_kernel(const __grid_constant__ FwdParams p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* a_s = base;                                   // [S][FM][128 B]
  bf16* b_s = reinterpret_cast<bf16*>(a_s + F_STAGES * FM * FK * 2);   // [S][BN][FK]
  ModTap* taps = reinterpret_cast<ModTap*>(b_s + F_STAGES * BN * FK);  // [9][FM]
  uint64_t* full = reinterpret_cast<uint64_t*>(taps + 9 * FM);
  uint64_t* empty = full + F_STAGES;

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int tile_px = p.bh * p.bw;
  if (threadIdx.x == 0) {
    for (int s = 0; s < F_STAGES; ++s) {
      hop::mbar_init(&full[s], 128 + 1);        // the gatherers + the TMA arrival
      hop::mbar_init(&empty[s], 2);             // both consumer warpgroups
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- gather.  Per tile thread t computes pixel row t's corners and
    // weights x sigma(mask) for the 9 taps once, into the tap table; then
    // K walks the 64-channel slices, and within each the 9 taps, so the
    // corner rows the taps share are read from L1.  Per slice thread t
    // loads 16-byte chunk q = t % 8 of the 4 corner rows of tile rows
    // t / 8 + 16 i (i < 8): 8 neighbouring threads read one 128-byte corner
    // row, so a warp's load touches 4 lines, and all 32 loads of a thread
    // are in flight together.  Thread 0 also issues the weight loads.
    if (t == 0) hop::tma_prefetch(&p.w);
    const int q = t % 8, pr = t / 8;
    hop::Ring<F_STAGES> r;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const TileAt at = tile_at(p, tile);
      {
        const int i = at.i0 + t / p.bw, j = at.j0 + t % p.bw;
        const bool real = t < tile_px && i < p.H && j < p.W;
        const int pm = (at.img * p.H + i) * p.W + j;
        // the previous tile's slices are all read before the table changes
        asm volatile("bar.sync 3, 128;\n" ::: "memory");
        for (int k = 0; k < 9; ++k) {
          const dcn::Tap tp = real ? dcn::make_tap(p.om, pm, k, p.H, p.W)
                                   : dcn::empty_tap();
          ModTap m;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            m.off[c] = tp.off[c];
            m.w[c] = tp.w[c] * tp.sig;
          }
          taps[k * FM + t] = m;
        }
        asm volatile("bar.sync 3, 128;\n" ::: "memory");
      }
      for (int c = 0; c < p.cs; ++c) {
        for (int k = 0; k < 9; ++k) {
          const int ch = c * FK + 8 * q;
          const bool live = ch < p.Cin;
          const ModTap* tk = taps + k * FM;
          hop::mbar_wait(&empty[r.stage], r.phase ^ 1u);
          if (t == 0) {
            hop::mbar_expect_tx(&full[r.stage], BN * FK * 2);
            hop::tma_load_3d(b_s + r.stage * BN * FK, &p.w, &full[r.stage], c * FK, k,
                             at.nt * BN);
          }
          uint4 raw[8][4];                               // [pixel][corner]
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int4 off = *reinterpret_cast<const int4*>(tk[pr + 16 * i].off);
            const int o4[4] = {off.x, off.y, off.z, off.w};
#pragma unroll
            for (int cn = 0; cn < 4; ++cn)
              raw[i][cn] = live && o4[cn] >= 0
                               ? __ldg(reinterpret_cast<const uint4*>(
                                     p.x + static_cast<size_t>(o4[cn]) * p.Cin + ch))
                               : make_uint4(0, 0, 0, 0);
          }
          unsigned char* st = a_s + r.stage * FM * 128;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int px = pr + 16 * i;
            const float4 w4 = *reinterpret_cast<const float4*>(tk[px].w);
            const float wc[4] = {w4.x, w4.y, w4.z, w4.w};
            float a[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) a[e] = 0.f;
#pragma unroll
            for (int cn = 0; cn < 4; ++cn) {
              const __nv_bfloat162* hv = reinterpret_cast<const __nv_bfloat162*>(&raw[i][cn]);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float2 f = __bfloat1622float2(hv[e]);
                a[2 * e] += wc[cn] * f.x;
                a[2 * e + 1] += wc[cn] * f.y;
              }
            }
            uint4 o;
            __nv_bfloat162* ho = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
            for (int e = 0; e < 4; ++e) ho[e] = __floats2bfloat162_rn(a[2 * e], a[2 * e + 1]);
            *reinterpret_cast<uint4*>(st + px * 128 + ((q ^ (px & 7)) << 4)) = o;
          }
          hop::fence_proxy_async();
          hop::mbar_arrive(&full[r.stage]);
          r.next();
        }
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns tile rows [64 cw, 64 cw + 64) ------
    const int cw = wg - 1, warp = t / 32, lane = t % 32;
    float acc[BN / 2];
    hop::Ring<F_STAGES> r;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const TileAt at = tile_at(p, tile);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      for (int s = 0; s < 9 * p.cs; ++s) {
        hop::mbar_wait(&full[r.stage], r.phase);
        const uint64_t da = hop::make_desc(a_s + (r.stage * FM + cw * 64) * 128, 0, 1024);
        const uint64_t db = hop::make_desc(b_s + r.stage * BN * FK, 0, 1024);
        hop::fence_regs<BN / 2>(acc);
        hop::wgmma_fence();
        hop::mma_slice<BN, 0, 0>(acc, da, db);
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::fence_regs<BN / 2>(acc);
        if (t == 0) hop::mbar_arrive(&empty[r.stage]);
        r.next();
      }
      // ---- epilogue: one rounding, then 16-byte stores.  The 4 lanes of a
      // quad hold columns 2 (l % 4) .. + 1 of each 8-column group for rows
      // r0 and r0 + 8; a 4 x 4 transpose of their packed words over the
      // groups (j, j + 1) gives lane l % 4 = 2 b + g row r0 + 8 b, group
      // j + g, whole.
      const int qd = lane & 3;
      const int row = cw * 64 + warp * 16 + lane / 4 + ((qd >> 1) << 3);
      const int i = at.i0 + row / p.bw, j = at.j0 + row % p.bw;
      const bool ok = row < tile_px && i < p.H && j < p.W;
      bf16* orow = p.out + ((static_cast<size_t>(at.img) * p.H + i) * p.W + j) * p.Cout +
                   at.nt * BN;
#pragma unroll
      for (int jj = 0; jj < BN / 8; jj += 2) {
        // word w of this lane: (row r0 + 8 (w >> 1), group jj + (w & 1))
        uint32_t w[4];
        {
          __nv_bfloat162 h;
          h = __floats2bfloat162_rn(acc[4 * jj], acc[4 * jj + 1]);
          w[0] = *reinterpret_cast<uint32_t*>(&h);
          h = __floats2bfloat162_rn(acc[4 * jj + 4], acc[4 * jj + 5]);
          w[1] = *reinterpret_cast<uint32_t*>(&h);
          h = __floats2bfloat162_rn(acc[4 * jj + 2], acc[4 * jj + 3]);
          w[2] = *reinterpret_cast<uint32_t*>(&h);
          h = __floats2bfloat162_rn(acc[4 * jj + 6], acc[4 * jj + 7]);
          w[3] = *reinterpret_cast<uint32_t*>(&h);
        }
        uint32_t got[4];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          // send the word lane qd ^ s wants; it lands in slot qd ^ s
          const int want = qd ^ s;
          const uint32_t send = want == 0 ? w[0] : want == 1 ? w[1] : want == 2 ? w[2] : w[3];
          const uint32_t v = __shfl_xor_sync(0xffffffffu, send, s);
#pragma unroll
          for (int m = 0; m < 4; ++m)
            if (m == (qd ^ s)) got[m] = v;
        }
        const int col = (jj + (qd & 1)) * 8;
        if (ok && at.nt * BN + col < p.Cout)
          *reinterpret_cast<uint4*>(orow + col) = make_uint4(got[0], got[1], got[2], got[3]);
      }
    }
  }
}

// The tile rectangle bh x bw (<= 128 pixels) that leaves the least gather
// work on the busiest SM: rounds of one tile per SM times the pixels of a
// tile (the gather's cost follows them), plus a per-tile share for its tap
// table and weight slices; among equals the squarest, whose taps share
// more corner rows.
void pick_tile(FwdParams& p, int sms) {
  long best = -1;
  for (int bh = 1; bh <= 16; ++bh) {
    for (int bw = 1; bh * bw <= FM; ++bw) {
      const int th = (p.H + bh - 1) / bh, tw = (p.W + bw - 1) / bw;
      const long tiles = static_cast<long>(p.N) * th * tw * p.tiles_n;
      const long rounds = (tiles + sms - 1) / sms;
      const long cost = (rounds * (bh * bw + 24)) * 64 + bh + bw;
      if (best < 0 || cost < best) {
        best = cost;
        p.bh = bh; p.bw = bw; p.tiles_h = th; p.tiles_w = tw;
        p.tiles = static_cast<int>(tiles);
      }
    }
  }
}

template <int BN>
int launch_wgmma(const void* x, const void* om, const void* wk, void* out, int N, int H,
                 int W, int Cin, int Cout, void* stream) {
  FwdParams p{};
  if (static_cast<long>(N) * H * W == 0) return 0;
  const uint64_t dims[3] = {static_cast<uint64_t>(Cin), 9, static_cast<uint64_t>(Cout)};
  const uint64_t strides[2] = {static_cast<uint64_t>(Cin) * 2,
                               static_cast<uint64_t>(Cin) * 9 * 2};
  const uint32_t box[3] = {FK, 1, BN};
  if (!hop::make_map(&p.w, wk, 3, dims, strides, box))
    return static_cast<int>(cudaErrorInvalidValue);
  p.x = static_cast<const bf16*>(x);
  p.om = static_cast<const bf16*>(om);
  p.out = static_cast<bf16*>(out);
  p.N = N; p.H = H; p.W = W; p.Cin = Cin; p.Cout = Cout;
  p.cs = (Cin + FK - 1) / FK;
  p.tiles_n = (Cout + BN - 1) / BN;
  const int sms = hop::sm_count();
  pick_tile(p, sms);
  constexpr int smem = fwd_smem_bytes<BN>();
  cudaError_t err = cudaFuncSetAttribute(dcn_forward_wgmma_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the smallest shared-memory carve-out that holds the tile: the rest is L1
  err = cudaFuncSetAttribute(dcn_forward_wgmma_kernel<BN>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (smem * 100 + 233471) / 233472);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = p.tiles < sms ? p.tiles : sms;
  dcn_forward_wgmma_kernel<BN><<<grid, F_THREADS, smem,
                                 static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The Hopper tile: wk is the K-major weight [Cout, 3, 3, Cin] in bfloat16;
// the caller guarantees the shapes above.
extern "C" int dcn_forward_bf16_wgmma(const void* x, const void* om, const void* wk,
                                      void* out, int N, int H, int W, int Cin,
                                      int Cout, void* stream) {
  if (Cin % 8 != 0 || Cout % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (Cout > 128) return launch_wgmma<256>(x, om, wk, out, N, H, W, Cin, Cout, stream);
  if (Cout > 64) return launch_wgmma<128>(x, om, wk, out, N, H, W, Cin, Cout, stream);
  return launch_wgmma<64>(x, om, wk, out, N, H, W, Cin, Cout, stream);
}

extern "C" int dcn_forward_f32(const void* x, const void* om, const void* w,
                               void* out, int N, int H, int W, int Cin,
                               int Cout, void* stream) {
  const int M = N * H * W;
  dim3 grid((M + BM - 1) / BM, (Cout + BN - 1) / BN);
  dcn_forward_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(om),
      static_cast<const float*>(w), static_cast<float*>(out), N, H, W, Cin, Cout);
  return static_cast<int>(cudaGetLastError());
}
