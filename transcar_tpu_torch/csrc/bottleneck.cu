// K6: a stride-1 ResNet bottleneck, relu(bn3(conv3(relu(bn2(conv2(
// relu(bn1(conv1 x))))))) + identity-or-bnd(convd x)).
//
// Replaces transcar_tpu/ops/pallas_bottleneck.py::bottleneck_fused.  The
// wrapper, the bound and the design are described in
// transcar_tpu_torch/ops/pallas_bottleneck.py.  One call issues three
// device kernels of conv_tile.cuh: conv1 (1x1, affine, ReLU) into h1 and
// conv2 (3x3, affine, ReLU) into h2, each rounded to T as the TPU kernel
// rounds them, then conv3 with the downsample product in a second float32
// accumulator (or the identity read in float32), the residual add and the
// ReLU in the epilogue.  Any Cm: the tile walks K in slices.
//
// Layouts: x [N,H,W,Cin]; w1 [Cin,Cm], w2 [9*Cm,Cm] (tap-major), w3
// [Cm,Cout], wd [Cin,Cout] or null (identity, Cin == Cout); every scale
// and bias [C] float32; h1, h2 [N,H,W,Cm] scratch; out [N,H,W,Cout].

#include "conv_tile.cuh"

namespace {

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
