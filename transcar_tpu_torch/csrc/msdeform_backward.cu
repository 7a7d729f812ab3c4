// Multi-scale deformable attention backward, float32 throughout: K8
// (d_attn and d_loc, one launch) and K9 (d_value: a source list, then the
// six launches of ordered_sum.cuh's gather).
//
// Replaces transcar_tpu/ops/pallas_msdeform.py::_bwd_taps_pair (K8, the
// Pallas _bwd_taps_kernel) and ::_bwd_value_pair (K9, _bwd_value_kernel).
// The wrapper, the bound and the design are described in
// transcar_tpu_torch/ops/pallas_msdeform.py.
//
// For the forward out[b, q, h*D + d] = sum_{l,p} a * s_d, with a =
// attn[b,q,h,l,p], the sample s = bilinear(value_l[b, :, :, h, :],
// loc[b,q,h,l,p]) = v00 w00 + v01 w01 + v10 w10 + v11 w11 (corner weights
// w00 = (1-ty)(1-tx), w01 = (1-ty) tx, w10 = ty (1-tx), w11 = ty tx; a
// corner off the map reads 0) and g = d_out[b, q, h*D : (h+1)*D]:
//
//   K8  d_attn[b,q,h,l,p]     = sum_d g_d s_d
//       d_loc[b,q,h,l,p, 0]   = a * sum_d g_d ds_d/dtx * W_l
//       d_loc[b,q,h,l,p, 1]   = a * sum_d g_d ds_d/dty * H_l
//         ds/dtx = (v01 - v00)(1-ty) + (v11 - v10) ty
//         ds/dty = (v10 - v00)(1-tx) + (v11 - v01) tx
//   K9  d_value[b, t, h, d] = sum over the (q, l, p, corner) landing on
//       token t, in that order, of (a * w_corner) * g_d
//
// tx = x - floor(x) is differentiated with floor's zero derivative, as
// autograd does: at an integer coordinate the derivative is the one-sided
// one towards the next cell.  A non-finite location gives NaN d_attn and
// d_loc and adds nothing to d_value.  Layouts (contiguous float32): value
// and d_value [B, S, H, D], loc and d_loc [B, Q, H, L, P, 2] (x, y), attn
// and d_attn [B, Q, H, L, P], d_out [B, Q, H, D]; d_value is written
// whole.
//
// K8 has two kernels:
// - msdeform_backward_taps_group_kernel, for D % 8 == 0, D <= 64 and
//   16-byte aligned rows (the pillar head's D = 32): one lane group per
//   sample (msdeform_gather.cuh; G = 4 lanes of 8 channels for D = 32, so
//   a warp holds 8 samples).  A warp owns up to kGroupQueries neighbouring
//   queries of one (batch, head), a block kGroupWarps such runs of one
//   head, and walks their samples level by level, 16 samples in flight:
//   each lane issues the loads of its samples' corner rows first (16-byte
//   loads), then forms the four dot products g . v_corner over its
//   channels, combines them into g.s, g.ds/dtx and g.ds/dty with the
//   sample's corner weights, and sums those over the group's lanes
//   (log2 G shuffle rounds).  The queries' gradient rows wait in shared
//   memory, read once; d_attn and d_loc leave as one store a group.
// - msdeform_backward_taps_kernel, for other D: one warp per (b, q, h);
//   lane i holds channels d = i, i + 32, ..., so every tap is one
//   coalesced read of D floats, and three warp-wide reductions a sample.
// K9 is a gather by target (ordered_sum.cuh), the JAX kernel's idea of
// gathering each value row from the queries that sample it, made exact
// for any location: msdeform_value_sources_kernel, one thread a sample,
// lists each of its on-map corners (source ((b Q + q) H + h) L P + l P + p
// times 4 plus the corner) with its value row and weight a * w_corner;
// then every value row sums its list in source order, coef * d_out row,
// and writes its D channels once, so d_value repeats bit for bit, as the
// TPU kernel's sequential grid does, for any D.

#include <cuda_runtime.h>

#include "msdeform_gather.cuh"
#include "ordered_sum.cuh"

namespace {

using msd::corners;
using msd::Corners;
using msd::kMaxLevels;
using msd::Levels;
using msd::make_levels;
using msd::small_div;

constexpr int kWarps = 8;          // warps per block

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(32 * kWarps)
msdeform_backward_taps_kernel(const float* __restrict__ value,
                              const float* __restrict__ loc,
                              const float* __restrict__ attn,
                              const float* __restrict__ d_out,
                              float* __restrict__ d_loc,
                              float* __restrict__ d_attn, Levels lv,
                              long long items, int S, int Q, int H, int D,
                              int L, int P) {
  const long long item = static_cast<long long>(blockIdx.x) * kWarps
                         + (threadIdx.x >> 5);             // (b, q, h)
  if (item >= items) return;                 // whole warps leave together
  const int lane = threadIdx.x & 31;
  const int h = static_cast<int>(item % H);
  const long long b = item / H / Q;
  const long long row = static_cast<long long>(H) * D;      // token stride
  const float* vb = value + b * S * row + static_cast<long long>(h) * D;
  const float2* loc_i = reinterpret_cast<const float2*>(loc) + item * L * P;
  const float* att_i = attn + item * L * P;
  const float* g_i = d_out + item * D;
  float2* dloc_i = reinterpret_cast<float2*>(d_loc) + item * L * P;
  float* dattn_i = d_attn + item * L * P;
  const float g0 = lane < D ? __ldg(g_i + lane) : 0.f;    // first 32 ch.

#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l >= L) break;
    const int hl = lv.h[l], wl = lv.w[l];
    const float* vl = vb + lv.start[l] * row;
    for (int p = 0; p < P; ++p) {
      const float2 uv = __ldg(loc_i + l * P + p);         // warp broadcast
      const float a = __ldg(att_i + l * P + p);
      const Corners c = corners(uv, hl, wl);
      float sg = 0.f, sx = 0.f, sy = 0.f;
      if (c.finite) {
        const float tx = c.tx, ty = c.ty;
        const long long t00 = c.tok * row;
        const long long t10 = t00 + wl * row;
        for (int d = lane; d - lane < D; d += 32) {
          const bool active = d < D;
          float v00 = 0.f, v01 = 0.f, v10 = 0.f, v11 = 0.f;
          if (active && c.v00) v00 = __ldg(vl + t00 + d);
          if (active && c.v01) v01 = __ldg(vl + t00 + row + d);
          if (active && c.v10) v10 = __ldg(vl + t10 + d);
          if (active && c.v11) v11 = __ldg(vl + t10 + row + d);
          const float g = d == lane ? g0 : (active ? __ldg(g_i + d) : 0.f);
          const float s = v00 * ((1.f - ty) * (1.f - tx))
                          + v01 * ((1.f - ty) * tx)
                          + v10 * (ty * (1.f - tx))
                          + v11 * (ty * tx);
          const float dx = (v01 - v00) * (1.f - ty) + (v11 - v10) * ty;
          const float dy = (v10 - v00) * (1.f - tx) + (v11 - v01) * tx;
          sg = fmaf(g, s, sg);
          sx = fmaf(g, dx, sx);
          sy = fmaf(g, dy, sy);
        }
      }
      sg = warp_sum(sg);
      sx = warp_sum(sx);
      sy = warp_sum(sy);
      if (lane == 0) {
        const float nan = __int_as_float(0x7fc00000);
        dattn_i[l * P + p] = c.finite ? sg : nan;
        dloc_i[l * P + p] = c.finite
            ? make_float2((a * sx) * static_cast<float>(wl),
                          (a * sy) * static_cast<float>(hl))
            : make_float2(nan, nan);
      }
    }
  }
}

constexpr int kGroupWarps = 8;     // warps per block of the group kernel
constexpr int kGroupQueries = 4;   // most neighbouring queries a warp owns
constexpr int kGroupMaxD = 64;

// K8 with one lane group of G lanes per sample (V float4 chunks a lane);
// a warp owns up to kGroupQueries neighbouring queries of one (batch,
// head) and walks their samples level by level.  Up to 16 samples in
// flight a warp, as register room allows (R rounds of 32 / G).
template <int G, int V>
__global__ void __launch_bounds__(32 * kGroupWarps)
msdeform_backward_taps_group_kernel(const float* __restrict__ value,
                                    const float* __restrict__ loc,
                                    const float* __restrict__ attn,
                                    const float* __restrict__ d_out,
                                    float* __restrict__ d_loc,
                                    float* __restrict__ d_attn, Levels lv,
                                    int q_blocks, int S, int Q, int H, int D,
                                    int L, int P) {
  constexpr int NG = 32 / G;                  // samples a warp holds at once
  constexpr int kRounds16 = 16 / NG > 0 ? 16 / NG : 1;  // rounds for 16 samples
  constexpr int R = kRounds16 < 4 / V ? kRounds16 : 4 / V;  // <= 4 chunks a corner
  constexpr int QW = kGroupQueries;
  __shared__ int s_h[kMaxLevels], s_w[kMaxLevels], s_start[kMaxLevels];
  __shared__ float4 s_g[kGroupWarps][QW * kGroupMaxD / 4];
  msd::stage_levels(lv, s_h, s_w, s_start);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gi = lane / G, j = lane % G;
  // block -> (b, run of kGroupWarps * QW queries, head), head fastest
  const int h = static_cast<int>(blockIdx.x % H);
  const int rest = static_cast<int>(blockIdx.x / H);
  const long long b = rest / q_blocks;
  const int q0 = ((rest % q_blocks) * kGroupWarps + warp) * QW;
  const int nq = min(QW, Q - q0);
  if (nq <= 0) return;                       // whole warps leave together

  // the gradient rows of the warp's queries, read once
  const int d4 = D / 4;
  const long long item0 = (b * Q + q0) * H + h;        // item of query q0
  float4* gs = s_g[warp];
  for (int e = lane; e < nq * d4; e += 32) {
    const int i = e / d4;
    gs[e] = __ldg(reinterpret_cast<const float4*>(
        d_out + (item0 + static_cast<long long>(i) * H) * D) + (e - i * d4));
  }
  __syncwarp();

  const long long row = static_cast<long long>(H) * D;       // token stride
  const float* vb = value + b * S * row + static_cast<long long>(h) * D;
  const float2* loc2 = reinterpret_cast<const float2*>(loc);
  float2* dloc2 = reinterpret_cast<float2*>(d_loc);
  const int LP = L * P, n = nq * LP;
  const float inv_p = 1.f / P, inv_qp = 1.f / (nq * P);
  for (int u0 = 0; u0 < n; u0 += NG * R) {
    float4 t[R][4][V];
    Corners c[R];
    float a[R];
    int hl[R], wl[R], gsl[R];
    long long sid[R];
    bool live[R];
    // every load of the R rounds first ...
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int u = u0 + r * NG + gi;
      live[r] = u < n;
      // slot u -> (query i of the warp's, sample s of its L * P),
      // level-major; l = s / P by division ran 1% faster than l = lu (H100)
      const int lu = small_div(u, inv_qp), rem = u - lu * nq * P;
      int i = small_div(rem, inv_p), s = lu * P + rem - i * P;
      if (!live[r]) i = s = 0;
      const int l = small_div(s, inv_p);
      sid[r] = (item0 + static_cast<long long>(i) * H) * LP + s;
      hl[r] = s_h[l];
      wl[r] = s_w[l];
      gsl[r] = i * d4;
      const float2 uv = live[r] ? __ldg(loc2 + sid[r]) : make_float2(0.f, 0.f);
      a[r] = live[r] ? __ldg(attn + sid[r]) : 0.f;
      c[r] = corners(uv, hl[r], wl[r]);
      msd::load_taps<G, V>(vb + static_cast<long long>(s_start[l]) * row, row,
                           wl[r], c[r], live[r], j, D, t[r]);
    }
    // ... then the products and the group sums
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float p00 = 0.f, p01 = 0.f, p10 = 0.f, p11 = 0.f;   // g . v_corner
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if (4 * (k * G + j) < D) {
          const float4 g = gs[gsl[r] + k * G + j];
          p00 = msd::dot4(g, t[r][0][k], p00);
          p01 = msd::dot4(g, t[r][1][k], p01);
          p10 = msd::dot4(g, t[r][2][k], p10);
          p11 = msd::dot4(g, t[r][3][k], p11);
        }
      }
      const float tx = c[r].tx, ty = c[r].ty;
      float sg = p00 * ((1.f - ty) * (1.f - tx)) + p01 * ((1.f - ty) * tx)
                 + p10 * (ty * (1.f - tx)) + p11 * (ty * tx);
      float sx = (p01 - p00) * (1.f - ty) + (p11 - p10) * ty;
      float sy = (p10 - p00) * (1.f - tx) + (p11 - p01) * tx;
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1) {
        sg += __shfl_xor_sync(0xffffffffu, sg, o);
        sx += __shfl_xor_sync(0xffffffffu, sx, o);
        sy += __shfl_xor_sync(0xffffffffu, sy, o);
      }
      if (j == 0 && live[r]) {
        const float nan = __int_as_float(0x7fc00000);
        d_attn[sid[r]] = c[r].finite ? sg : nan;
        dloc2[sid[r]] = c[r].finite
            ? make_float2((a[r] * sx) * static_cast<float>(wl[r]),
                          (a[r] * sy) * static_cast<float>(hl[r]))
            : make_float2(nan, nan);
      }
    }
  }
}

// K9's producer: a thread a sample (b, q, h, l, p) lists its four
// corners for the gather (ordered_sum.cuh): the value row (b, token, h)
// of a corner on the map, -1 for one off it or a non-finite location.
__global__ void __launch_bounds__(256)
msdeform_value_sources_kernel(const float* __restrict__ loc,
                              const float* __restrict__ attn, ordered::Gather g,
                              Levels lv, long long samples, int S, int Q, int H,
                              int L, int P) {
  const long long u = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (u >= samples) return;
  const int lp = static_cast<int>(u % (L * P));
  const long long item = u / (L * P);                   // (b, q, h)
  const int h = static_cast<int>(item % H);
  const long long b = item / H / Q;
  const int l = lp / P;
  const int hl = lv.h[l], wl = lv.w[l];
  const Corners c = corners(__ldg(reinterpret_cast<const float2*>(loc) + u), hl, wl);
  const float a = __ldg(attn + u);
  const float tx = c.tx, ty = c.ty;
  const float w[4] = {(1.f - ty) * (1.f - tx), (1.f - ty) * tx, ty * (1.f - tx), ty * tx};
  const bool on[4] = {c.v00, c.v01, c.v10, c.v11};
  const long long t00 = b * S + lv.start[l] + c.tok;    // token of corner 00
  const long long tok[4] = {t00, t00 + 1, t00 + wl, t00 + wl + 1};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool live = c.finite && on[k];
    ordered::list_source(g, u * 4 + k, live ? static_cast<int>(tok[k] * H + h) : -1,
                         live ? a * w[k] : 0.f);
  }
}

// The launch shape of K8's first kernel: blocks of kWarps warps over the
// B*Q*H items; 0 blocks for no items, -1 for an invalid shape.
long long launch_blocks(int B, int Q, int H, int D, int P,
                        long long* items) {
  if (B < 0 || Q < 0 || P < 1 || D < 1 || H < 1) return -1;
  *items = static_cast<long long>(B) * Q * H;
  const long long blocks = (*items + kWarps - 1) / kWarps;
  return blocks > 0x7fffffffLL ? -1 : blocks;
}

// The group kernel's launch: G lanes of V = 2 float4 chunks (8 channels)
// a sample, G the least power of two with 8 G >= D.
int launch_taps_group(const float* value, const float* loc, const float* attn,
                      const float* d_out, float* d_loc, float* d_attn,
                      const Levels& lv, int q_blocks, unsigned blocks, int S,
                      int Q, int H, int D, int L, int P, cudaStream_t stream) {
  const dim3 grid(blocks), block(32 * kGroupWarps);
  switch (D <= 8 ? 1 : D <= 16 ? 2 : D <= 32 ? 4 : 8) {
    case 1:
      msdeform_backward_taps_group_kernel<1, 2><<<grid, block, 0, stream>>>(
          value, loc, attn, d_out, d_loc, d_attn, lv, q_blocks, S, Q, H, D, L, P);
      break;
    case 2:
      msdeform_backward_taps_group_kernel<2, 2><<<grid, block, 0, stream>>>(
          value, loc, attn, d_out, d_loc, d_attn, lv, q_blocks, S, Q, H, D, L, P);
      break;
    case 4:
      msdeform_backward_taps_group_kernel<4, 2><<<grid, block, 0, stream>>>(
          value, loc, attn, d_out, d_loc, d_attn, lv, q_blocks, S, Q, H, D, L, P);
      break;
    default:
      msdeform_backward_taps_group_kernel<8, 2><<<grid, block, 0, stream>>>(
          value, loc, attn, d_out, d_loc, d_attn, lv, q_blocks, S, Q, H, D, L, P);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int msdeform_backward_taps_f32(
    const void* value, const void* loc, const void* attn, const void* d_out,
    void* d_loc, void* d_attn, int B, int S, int Q, int H, int D, int L,
    int P, const int* level_h, const int* level_w, const int* level_start,
    void* stream) {
  Levels lv;
  long long items = 0;
  const long long blocks = launch_blocks(B, Q, H, D, P, &items);
  if (blocks < 0 ||
      !make_levels(L, level_h, level_w, level_start, &lv))
    return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  msdeform_backward_taps_kernel<<<static_cast<unsigned>(blocks),
                                  32 * kWarps, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(attn), static_cast<const float*>(d_out),
      static_cast<float*>(d_loc), static_cast<float*>(d_attn), lv, items, S,
      Q, H, D, L, P);
  return static_cast<int>(cudaGetLastError());
}

// K8 on the lane-group kernel: D % 8 == 0, D <= 64, 16-byte aligned value
// and d_out; any other call returns cudaErrorInvalidValue.
extern "C" int msdeform_backward_taps_group_f32(
    const void* value, const void* loc, const void* attn, const void* d_out,
    void* d_loc, void* d_attn, int B, int S, int Q, int H, int D, int L,
    int P, const int* level_h, const int* level_w, const int* level_start,
    void* stream) {
  Levels lv;
  const auto misaligned = [](const void* p) {
    return reinterpret_cast<unsigned long long>(p) % 16 != 0;
  };
  if (B < 0 || Q < 0 || H < 1 || P < 1 || D < 8 || D % 8 != 0 ||
      D > kGroupMaxD || misaligned(value) || misaligned(d_out) ||
      !make_levels(L, level_h, level_w, level_start, &lv))
    return static_cast<int>(cudaErrorInvalidValue);
  const int per_block = kGroupWarps * kGroupQueries;
  const int q_blocks = (Q + per_block - 1) / per_block;
  const long long blocks = static_cast<long long>(B) * q_blocks * H;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  return launch_taps_group(
      static_cast<const float*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(attn), static_cast<const float*>(d_out),
      static_cast<float*>(d_loc), static_cast<float*>(d_attn), lv, q_blocks,
      static_cast<unsigned>(blocks), S, Q, H, D, L, P,
      static_cast<cudaStream_t>(stream));
}

// Bytes of workspace K9 needs: the gather's lists of B*Q*H*L*P*4 sources
// over B*S*H value rows.
extern "C" long long msdeform_backward_value_workspace(int B, int S, int Q, int H,
                                                       int L, int P) {
  const long long E = static_cast<long long>(B) * Q * H * L * P * 4;
  return static_cast<long long>(
      ordered::workspace_bytes(E, static_cast<int>(static_cast<long long>(B) * S * H)));
}

// K9: d_value [B, S, H, D] float32, written whole; `work` holds
// msdeform_backward_value_workspace() bytes, `zeroed` B*S*H zero int32
// (left zero).
extern "C" int msdeform_backward_value_f32(
    const void* loc, const void* attn, const void* d_out, void* d_value, void* work,
    void* zeroed, int B, int S, int Q, int H, int D, int L, int P, const int* level_h,
    const int* level_w, const int* level_start, void* stream) {
  Levels lv;
  const long long cells = static_cast<long long>(B) * S * H;
  const long long samples = static_cast<long long>(B) * Q * H * L * P;
  if (B < 0 || S < 0 || Q < 0 || H < 1 || D < 1 || P < 1 || cells >= (1ll << 31) ||
      samples * 4 >= (1ll << 31) || !make_levels(L, level_h, level_w, level_start, &lv))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const ordered::Gather g = ordered::carve(work, samples * 4, static_cast<int>(cells),
                                           static_cast<unsigned*>(zeroed), nullptr);
  if (samples > 0) {
    msdeform_value_sources_kernel<<<static_cast<unsigned>((samples + 255) / 256), 256, 0,
                                    st>>>(static_cast<const float*>(loc),
                                          static_cast<const float*>(attn), g, lv, samples,
                                          S, Q, H, L, P);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // value row (b, t, h) sums d_out row (b, q, h) = source / (L P 4)
  return ordered::gather_sum(g, static_cast<const float*>(d_out), D, L * P * 4,
                             static_cast<float*>(d_value), st);
}
