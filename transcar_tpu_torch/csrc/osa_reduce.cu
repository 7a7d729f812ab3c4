// K4: VoVNet OSA concat-reduce, relu?((sum_i piece_i @ W_i) * scale + bias)
// without the concatenation, plus per-image float32 channel sums.
//
// Replaces transcar_tpu/ops/pallas_osa.py::osa_reduce.  The wrapper, the
// bound and the design are described in transcar_tpu_torch/ops/pallas_osa.py;
// the tile is conv_tile.cuh, with one 1x1 segment per piece.
//
// Layouts: piece_i [N,H,W,C_i], W_i [C_i, Cout], scale / bias [Cout]
// float32, out [N,H,W,Cout], sums [N,Cout] float32 (zeroed by the caller).

#include "conv_tile.cuh"

namespace {

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
