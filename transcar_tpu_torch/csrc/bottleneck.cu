// K6: a stride-1 ResNet bottleneck, relu(bn3(conv3(relu(bn2(conv2(
// relu(bn1(conv1 x))))))) + identity-or-bnd(convd x)).
//
// Replaces transcar_tpu/ops/pallas_bottleneck.py::bottleneck_fused.  The
// wrapper, the bound and the design are described in
// transcar_tpu_torch/ops/pallas_bottleneck.py.  A call is three device
// kernels: conv1 (1x1, affine, ReLU) into h1 and conv2 (3x3, affine, ReLU)
// into h2, each rounded to T as the TPU kernel rounds them, then conv3 with
// the downsample product in a second float32 accumulator (or the identity
// read in float32), the residual add and the ReLU in its epilogue.
//
// Two tiles:
// - bottleneck_conv{1,2,3}_bf16_wgmma: the Hopper tile of osa_wgmma.cuh,
//   for bfloat16 with Cin, Cm and Cout multiples of 8 and 16-byte aligned
//   bases.  conv1 is its reduce form with one piece and no channel sums,
//   conv2 its 3x3 form (K5's chain conv), conv3 its reduce form on BN =
//   128 with the residual epilogue (kResid 1: identity, loaded by TMA
//   into the output slot; kResid 2: the downsample as a second piece into
//   its own accumulator).  Their BN = 128 tiles stage the output in shared
//   memory and store it by TMA (kStage).  The kernels are K6's own
//   instantiations, so a trace tells them from K4's and K5's.  conv1 and
//   conv2 run a 64-wide Cout tile for Cm = 64.
// - bottleneck_bf16 / bottleneck_f32: the tile of conv_tile.cuh, for
//   float32 and for bfloat16 calls outside the shapes above.  Any Cm: the
//   tile walks K in slices.
//
// Layouts: x [N,H,W,Cin]; every scale and bias [C] float32; h1, h2
// [N,H,W,Cm] scratch; out [N,H,W,Cout].  conv_tile.cuh: w1 [Cin,Cm], w2
// [9*Cm,Cm] (tap-major), w3 [Cm,Cout], wd [Cin,Cout] or null (identity,
// Cin == Cout).  The Hopper tile: K-major w1 [Cm,Cin], w2 [Cm,3,3,Cm], w3
// [Cout,Cm], wd [Cout,Cin] or null, each contiguous.

#include "conv_tile.cuh"
#include "osa_wgmma.cuh"

namespace {

// BN = 64 and 128 tiles stage their output in shared memory (osa_wgmma.cuh's
// kStage: two output slots fit beside the ring); BN = 256 ones store from
// the registers.
template <int BN>
constexpr bool kStaged = BN <= 128;

template <int BN, int kResid>
__global__ void __launch_bounds__(osa::THREADS, 1)
bottleneck_reduce_wgmma_kernel(const __grid_constant__ osa::OsaParams p) {
  osa::osa_tile<BN, false, kResid, kStaged<BN>>(p);
}

template <int BN>
__global__ void __launch_bounds__(osa::THREADS, 1)
bottleneck_conv3x3_wgmma_kernel(const __grid_constant__ osa::OsaParams p) {
  osa::osa_tile<BN, true, 0, kStaged<BN>>(p);
}

constexpr int kConv3BN = 128;    // conv3: room for a second accumulator

// conv1's and conv2's Cout tile: the whole Cm up to 128 (a 64-wide tile
// for Cm = 64 does half the tensor work of a 128-wide one), then 256.
int cm_tile(int cm, bool conv) {
  return cm <= 64 ? 64 : cm <= 128 ? 128 : conv || cm % 256 == 0 ? 256 : 128;
}

// The output map of a staged launch, then the launch.
template <int BN, typename Kernel>
int launch(Kernel kernel, osa::OsaParams& p, void* out, bool conv, int N, void* stream) {
  if (kStaged<BN> && !osa::slot_map(&p.o, out, p, conv, N))
    return static_cast<int>(cudaErrorInvalidValue);
  return osa::launch_tile<BN, kStaged<BN>>(kernel, p, stream);
}

template <typename T>
int bottleneck(const void* x, int cin, int cm, int cout, const void* w1,
               const float* s1, const float* b1, const void* w2, const float* s2,
               const float* b2, const void* w3, const float* s3, const float* b3,
               const void* wd, const float* sd, const float* bd, void* h1,
               void* h2, void* out, int N, int H, int W, void* stream) {
  if (wd == nullptr && cin != cout) return static_cast<int>(cudaErrorInvalidValue);
  tck::ConvGemm p{};
  p.N = N; p.H = H; p.W = W;
  p.nseg = 1;
  p.relu = 1;
  p.seg[0] = tck::Seg{x, w1, cin, 1, 0, 0};
  p.scale = s1; p.bias = b1; p.out = h1; p.Cout = cm;
  int rc = tck::launch_conv_gemm<6, T>(p, stream);
  if (rc != 0) return rc;
  p.seg[0] = tck::Seg{h1, w2, cm, 9, 0, 0};
  p.scale = s2; p.bias = b2; p.out = h2;
  rc = tck::launch_conv_gemm<6, T>(p, stream);
  if (rc != 0) return rc;
  p.seg[0] = tck::Seg{h2, w3, cm, 1, 0, 0};
  if (wd != nullptr) {
    p.nseg = 2;
    p.seg[1] = tck::Seg{x, wd, cin, 1, 1, 0};
    p.scale2 = sd; p.bias2 = bd;
  } else {
    p.resid = x;
  }
  p.scale = s3; p.bias = b3; p.out = out; p.Cout = cout;
  return tck::launch_conv_gemm<6, T>(p, stream);
}

}  // namespace

extern "C" int bottleneck_bf16(const void* x, int cin, int cm, int cout,
                               const void* w1, const float* s1, const float* b1,
                               const void* w2, const float* s2, const float* b2,
                               const void* w3, const float* s3, const float* b3,
                               const void* wd, const float* sd, const float* bd,
                               void* h1, void* h2, void* out, int N, int H, int W,
                               void* stream) {
  return bottleneck<tck::bf16>(x, cin, cm, cout, w1, s1, b1, w2, s2, b2, w3, s3,
                               b3, wd, sd, bd, h1, h2, out, N, H, W, stream);
}

extern "C" int bottleneck_f32(const void* x, int cin, int cm, int cout,
                              const void* w1, const float* s1, const float* b1,
                              const void* w2, const float* s2, const float* b2,
                              const void* w3, const float* s3, const float* b3,
                              const void* wd, const float* sd, const float* bd,
                              void* h1, void* h2, void* out, int N, int H, int W,
                              void* stream) {
  return bottleneck<float>(x, cin, cm, cout, w1, s1, b1, w2, s2, b2, w3, s3, b3,
                           wd, sd, bd, h1, h2, out, N, H, W, stream);
}

// conv1 on the Hopper tile: h1 = round(relu(x @ w1 * s1 + b1)), x
// [N,H,W,Cin], w1 [Cm,Cin]; no channel sums.
extern "C" int bottleneck_conv1_bf16_wgmma(const void* x, int cin, const void* w1,
                                           const float* s1, const float* b1, void* h1,
                                           int N, int H, int W, int cm, void* stream) {
  const int bn = cm_tile(cm, false);
  osa::OsaParams p{};
  const int rc = osa::reduce_params(&p, 1, &x, &w1, &cin, &cin, N, H, W, cm, bn);
  if (rc != 0) return rc;
  p.scale = s1;
  p.bias = b1;
  p.out = static_cast<hop::bf16*>(h1);
  p.relu = 1;
  if (bn == 64)
    return launch<64>(bottleneck_reduce_wgmma_kernel<64, 0>, p, h1, false, N, stream);
  return bn == 256
             ? launch<256>(bottleneck_reduce_wgmma_kernel<256, 0>, p, h1, false, N, stream)
             : launch<128>(bottleneck_reduce_wgmma_kernel<128, 0>, p, h1, false, N, stream);
}

// conv2 on the Hopper tile: h2 = round(relu(conv3x3(h1, w2) * s2 + b2)),
// w2 [Cm,3,3,Cm]; TMA's zero fill is the padding.
extern "C" int bottleneck_conv2_bf16_wgmma(const void* h1, int cm, const void* w2,
                                           const float* s2, const float* b2, void* h2,
                                           int N, int H, int W, void* stream) {
  const int bn = cm_tile(cm, true);
  osa::OsaParams p{};
  const int rc = osa::conv3x3_params(&p, h1, cm, w2, N, H, W, cm, bn);
  if (rc != 0) return rc;
  p.scale = s2;
  p.bias = b2;
  p.out = static_cast<hop::bf16*>(h2);
  p.relu = 1;
  if (bn == 64)
    return launch<64>(bottleneck_conv3x3_wgmma_kernel<64>, p, h2, true, N, stream);
  return bn == 256
             ? launch<256>(bottleneck_conv3x3_wgmma_kernel<256>, p, h2, true, N, stream)
             : launch<128>(bottleneck_conv3x3_wgmma_kernel<128>, p, h2, true, N, stream);
}

// conv3 on the Hopper tile: out = round(relu(h2 @ w3 * s3 + b3 + ident)),
// ident = x @ wd * sd + bd (wd [Cout,Cin], its own float32 accumulator) or,
// with wd null, x itself read in float32 (Cin == Cout).
extern "C" int bottleneck_conv3_bf16_wgmma(const void* h2, int cm, const void* w3,
                                           const float* s3, const float* b3,
                                           const void* x, int cin, const void* wd,
                                           const float* sd, const float* bd, void* out,
                                           int N, int H, int W, int cout, void* stream) {
  const bool ds = wd != nullptr;
  if (!ds && cin != cout) return static_cast<int>(cudaErrorInvalidValue);
  const void* pieces[2] = {h2, x};
  const void* weights[2] = {w3, wd};
  const int widths[2] = {cm, cin};
  osa::OsaParams p{};
  const int rc = osa::reduce_params(&p, ds ? 2 : 1, pieces, weights, widths, widths, N, H,
                              W, cout, kConv3BN);
  if (rc != 0) return rc;
  p.scale = s3;
  p.bias = b3;
  p.out = static_cast<hop::bf16*>(out);
  p.relu = 1;
  if (ds) {
    p.scale2 = sd;
    p.bias2 = bd;
    return launch<kConv3BN>(bottleneck_reduce_wgmma_kernel<kConv3BN, 2>, p, out, false,
                            N, stream);
  }
  if (!osa::slot_map(&p.r, x, p, false, N)) return static_cast<int>(cudaErrorInvalidValue);
  return launch<kConv3BN>(bottleneck_reduce_wgmma_kernel<kConv3BN, 1>, p, out, false, N,
                          stream);
}
