// K5: a whole VoVNet OSA block, the chain of 3x3 ConvBN-ReLU layers and
// the concat-free reduce with its per-image channel sums.
//
// Replaces transcar_tpu/ops/pallas_osa_block.py::osa_block_fused.  The
// wrapper, the bound and the design are described in
// transcar_tpu_torch/ops/pallas_osa_block.py.  One call issues
// n_convs + 1 device kernels of conv_tile.cuh: each chain conv (one 3x3
// segment, affine, ReLU, rounded to T as the TPU kernel rounds before the
// next conv) writes its output to a chain buffer, since the next conv
// needs its halo; then the reduce walks x and the chain buffers as K4 does.
//
// Layouts: x [N,H,W,C0]; conv_w[i] [9*Cin_i, Ch] (tap-major), conv_s[i] /
// conv_b[i] [Ch] float32; chain[i] [N,H,W,Ch] scratch; red_w[0] [C0, Cr],
// red_w[i>0] [Ch, Cr]; rs / rb [Cr] float32; out [N,H,W,Cr]; sums [N,Cr]
// float32 (zeroed by the caller).

#include "conv_tile.cuh"

namespace {

template <typename T>
int osa_block(const void* x, int c0, int n_convs, int ch,
              const void* const* conv_w, const float* const* conv_s,
              const float* const* conv_b, void* const* chain,
              const void* const* red_w, const float* rs, const float* rb,
              void* out, float* sums, int N, int H, int W, int cr, void* stream) {
  if (n_convs < 1 || n_convs + 1 > tck::kMaxSeg)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < n_convs; ++i) {
    tck::ConvGemm p{};
    p.nseg = 1;
    p.seg[0] = tck::Seg{i == 0 ? x : chain[i - 1], conv_w[i], i == 0 ? c0 : ch, 9, 0, 0};
    p.scale = conv_s[i];
    p.bias = conv_b[i];
    p.out = chain[i];
    p.N = N; p.H = H; p.W = W; p.Cout = ch;
    p.relu = 1;
    const int rc = tck::launch_conv_gemm<5, T>(p, stream);
    if (rc != 0) return rc;
  }
  tck::ConvGemm p{};
  p.nseg = n_convs + 1;
  p.seg[0] = tck::Seg{x, red_w[0], c0, 1, 0, 0};
  for (int i = 0; i < n_convs; ++i)
    p.seg[i + 1] = tck::Seg{chain[i], red_w[i + 1], ch, 1, 0, 0};
  p.scale = rs;
  p.bias = rb;
  p.out = out;
  p.sums = sums;
  p.N = N; p.H = H; p.W = W; p.Cout = cr;
  p.relu = 1;
  return tck::launch_conv_gemm<5, T>(p, stream);
}

}  // namespace

extern "C" int osa_block_bf16(const void* x, int c0, int n_convs, int ch,
                              const void* const* conv_w, const float* const* conv_s,
                              const float* const* conv_b, void* const* chain,
                              const void* const* red_w, const float* rs,
                              const float* rb, void* out, float* sums, int N,
                              int H, int W, int cr, void* stream) {
  return osa_block<tck::bf16>(x, c0, n_convs, ch, conv_w, conv_s, conv_b, chain,
                              red_w, rs, rb, out, sums, N, H, W, cr, stream);
}

extern "C" int osa_block_f32(const void* x, int c0, int n_convs, int ch,
                             const void* const* conv_w, const float* const* conv_s,
                             const float* const* conv_b, void* const* chain,
                             const void* const* red_w, const float* rs,
                             const float* rb, void* out, float* sums, int N,
                             int H, int W, int cr, void* stream) {
  return osa_block<float>(x, c0, n_convs, ch, conv_w, conv_s, conv_b, chain,
                          red_w, rs, rb, out, sums, N, H, W, cr, stream);
}
