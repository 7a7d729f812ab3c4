// K4: VoVNet OSA concat-reduce, relu?((sum_i piece_i @ W_i) * scale + bias)
// without the concatenation, plus per-image float32 channel sums.
//
// Replaces transcar_tpu/ops/pallas_osa.py::osa_reduce.  The wrapper, the
// bound and the design are described in transcar_tpu_torch/ops/pallas_osa.py.
//
// Two tiles:
// - osa_reduce_bf16_wgmma: the Hopper tile of osa_wgmma.cuh (its reduce
//   form) for bfloat16 with C_i % 8 == 0, Cout % 8 == 0 and 16-byte
//   aligned bases: a persistent wgmma kernel fed by TMA, the affine, ReLU,
//   rounding and channel sums in its epilogue.
// - osa_reduce_bf16 / osa_reduce_f32: the tile of conv_tile.cuh (wmma /
//   CUDA-core FMAs) with one 1x1 segment per piece, for float32 and for
//   bfloat16 calls outside the shapes above.
//
// Layouts: piece_i [N,H,W,C_i]; W_i [C_i, Cout] (conv_tile.cuh: contiguous;
// the Hopper tile: a K-major view, element (c, o) at w_i + o * w_ld_i + c);
// scale / bias [Cout] float32, out [N,H,W,Cout], sums [N,Cout] float32
// (zeroed by the caller).

#include "conv_tile.cuh"
#include "osa_wgmma.cuh"

namespace {

template <int BN>
__global__ void __launch_bounds__(osa::THREADS, 1)
osa_reduce_wgmma_kernel(const __grid_constant__ osa::OsaParams p) {
  osa::osa_tile<BN, false>(p);
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
  if (n_pieces < 1 || n_pieces > osa::kMaxPieces || Cout % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bn = Cout % 256 == 0 ? 256 : 128;
  osa::OsaParams p{};
  p.n_pieces = n_pieces;
  const uint64_t hw = static_cast<uint64_t>(H) * W;
  for (int i = 0; i < n_pieces; ++i) {
    const uint64_t c = widths[i];
    if (c % 8 != 0 || w_ld[i] % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
    const uint64_t adims[3] = {c, hw, static_cast<uint64_t>(N)};
    const uint64_t astrides[2] = {c * 2, hw * c * 2};
    const uint32_t abox[3] = {osa::BK, osa::BM, 1};
    const uint64_t bdims[2] = {c, static_cast<uint64_t>(Cout)};
    const uint64_t bstrides[1] = {static_cast<uint64_t>(w_ld[i]) * 2};
    const uint32_t bbox[2] = {osa::BK, static_cast<uint32_t>(bn)};
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
  p.b_rows = bn;
  p.tiles_m = (H * W + osa::BM - 1) / osa::BM;
  p.tiles_n = (Cout + bn - 1) / bn;
  p.tiles = N * p.tiles_m * p.tiles_n;
  return bn == 256 ? osa::launch_tile<256>(osa_reduce_wgmma_kernel<256>, p, stream)
                   : osa::launch_tile<128>(osa_reduce_wgmma_kernel<128>, p, stream);
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
