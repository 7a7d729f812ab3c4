// K5: a whole VoVNet OSA block, the chain of 3x3 ConvBN-ReLU layers and
// the concat-free reduce with its per-image channel sums.
//
// Replaces transcar_tpu/ops/pallas_osa_block.py::osa_block_fused.  The
// wrapper, the bound and the design are described in
// transcar_tpu_torch/ops/pallas_osa_block.py.  Each chain conv (affine,
// ReLU, rounded to T as the TPU kernel rounds before the next conv) writes
// its output to a chain buffer, since the next conv needs its halo; then
// the reduce walks x and the chain buffers as K4 does.
//
// Two tiles:
// - osa_conv3x3_bf16_wgmma: one chain conv on the Hopper tile of
//   osa_wgmma.cuh (its conv form: a 4-D TMA map whose zero fill is the
//   padding), for bfloat16 with C % 8 == 0, Cout % 8 == 0 and 16-byte
//   aligned bases; the wrapper calls it once per chain conv and then K4's
//   osa_reduce_bf16_wgmma for the reduce.
// - osa_block_bf16 / osa_block_f32: the whole block in n_convs + 1 device
//   kernels of conv_tile.cuh (one 3x3 segment per chain conv, then the
//   reduce), for float32 and for bfloat16 calls outside the shapes above.
//
// Layouts: x [N,H,W,C0]; conv_w[i] [9*Cin_i, Ch] (tap-major; the Hopper
// tile: K-major [Ch, 3, 3, Cin_i]), conv_s[i] /
// conv_b[i] [Ch] float32; chain[i] [N,H,W,Ch] scratch; red_w[0] [C0, Cr],
// red_w[i>0] [Ch, Cr]; rs / rb [Cr] float32; out [N,H,W,Cr]; sums [N,Cr]
// float32 (zeroed by the caller).

#include "conv_tile.cuh"
#include "osa_wgmma.cuh"

namespace {

template <int BN>
__global__ void __launch_bounds__(osa::THREADS, 1)
osa_chain_wgmma_kernel(const __grid_constant__ osa::OsaParams p) {
  osa::osa_tile<BN, true>(p);
}

// The tile's pixel rectangle: bh x bw = 128 with the fewest pixels past
// the image (bw = 16 on 232 x 400, 64 on 29 x 50).
int tile_width(int H, int W) {
  int best = 128;
  long waste = -1;
  for (int bw : {128, 64, 32, 16}) {
    const int bh = osa::BM / bw;
    const long cover = static_cast<long>((H + bh - 1) / bh) * bh * ((W + bw - 1) / bw) * bw;
    if (waste < 0 || cover < waste) { waste = cover; best = bw; }
  }
  return best;
}

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

// One chain conv on the Hopper tile: out = round(relu(conv3x3(x, wk) *
// scale + bias)), x [N,H,W,C], wk [Cout, 3, 3, C] (K-major), out
// [N,H,W,Cout]; the caller guarantees the shapes above.
extern "C" int osa_conv3x3_bf16_wgmma(const void* x, int C, const void* wk,
                                      const float* scale, const float* bias, void* out,
                                      int N, int H, int W, int Cout, void* stream) {
  if (C % 8 != 0 || Cout % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int bn = Cout > 128 ? 256 : 128;
  osa::OsaParams p{};
  p.n_pieces = 1;
  p.b_rows = Cout < bn ? Cout : bn;
  p.width[0] = C;
  p.bw = tile_width(H, W);
  const uint64_t c = C;
  const uint64_t adims[4] = {c, static_cast<uint64_t>(W), static_cast<uint64_t>(H),
                             static_cast<uint64_t>(N)};
  const uint64_t astrides[3] = {c * 2, c * W * 2, c * W * H * 2};
  const uint32_t abox[4] = {osa::BK, static_cast<uint32_t>(p.bw),
                            static_cast<uint32_t>(osa::BM / p.bw), 1};
  const uint64_t bdims[3] = {c, 9, static_cast<uint64_t>(Cout)};
  const uint64_t bstrides[2] = {c * 2, c * 9 * 2};
  const uint32_t bbox[3] = {osa::BK, 1, static_cast<uint32_t>(p.b_rows)};
  if (!hop::make_map(&p.a[0], x, 4, adims, astrides, abox) ||
      !hop::make_map(&p.b[0], wk, 3, bdims, bstrides, bbox))
    return static_cast<int>(cudaErrorInvalidValue);
  p.scale = scale;
  p.bias = bias;
  p.out = static_cast<hop::bf16*>(out);
  p.Cout = Cout;
  p.relu = 1;
  p.H = H;
  p.W = W;
  p.tiles_w = (W + p.bw - 1) / p.bw;
  p.tiles_m = p.tiles_w * ((H + osa::BM / p.bw - 1) / (osa::BM / p.bw));
  p.tiles_n = (Cout + bn - 1) / bn;
  p.tiles = N * p.tiles_m * p.tiles_n;
  return bn == 256 ? osa::launch_tile<256>(osa_chain_wgmma_kernel<256>, p, stream)
                   : osa::launch_tile<128>(osa_chain_wgmma_kernel<128>, p, stream);
}

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
