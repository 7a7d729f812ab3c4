// Multi-scale deformable attention backward, float32 throughout: K8
// (d_attn and d_loc) and K9 (d_value), two kernels and two launches.
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
//   K9  d_value[b, corner, h, d] += (g_d * a) * w_corner   (float atomics)
//
// tx = x - floor(x) is differentiated with floor's zero derivative, as
// autograd does: at an integer coordinate the derivative is the one-sided
// one towards the next cell.  A non-finite location gives NaN d_attn and
// d_loc and adds nothing to d_value.  Layouts (contiguous float32): value
// and d_value [B, S, H, D], loc and d_loc [B, Q, H, L, P, 2] (x, y), attn
// and d_attn [B, Q, H, L, P], d_out [B, Q, H, D]; d_value is zeroed by the
// caller.
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
// K9 has two kernels:
// - msdeform_backward_value_group_kernel, for D % 8 == 0, D <= 64 and
//   16-byte aligned d_out and d_value: one lane group per query, as K7,
//   but one float4 a lane (G = 8 lanes of 4 channels for D = 32, 4
//   neighbouring queries of one (batch, head) a warp), so that each
//   instruction of a group adds a whole 128-byte row, one L2 request a
//   row where K7's layout makes two.  The group reads its query's
//   gradient row once (V float4 a lane) and walks the query's samples
//   level by level, the locations and weights of R samples loaded ahead;
//   for each sample it computes the corners and their weights once and
//   adds (g a) w_corner into each corner row on the map with 16-byte
//   vector atomic adds (atomicAdd(float4 *, float4)): V a lane a corner,
//   where the first kernel makes 4 V scalar atomic adds.  The L2 adds
//   one 32-byte sector per operation either way, so those sector
//   operations, not instructions, pace it.
// - msdeform_backward_value_kernel, for other D: one warp per (b, q, h),
//   lanes over the channels; every tap is one coalesced atomic add of D
//   floats.

#include <cuda_runtime.h>

#include "msdeform_gather.cuh"

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

__global__ void __launch_bounds__(32 * kWarps)
msdeform_backward_value_kernel(const float* __restrict__ loc,
                               const float* __restrict__ attn,
                               const float* __restrict__ d_out,
                               float* __restrict__ d_value, Levels lv,
                               long long items, int S, int Q, int H, int D,
                               int L, int P) {
  const long long item = static_cast<long long>(blockIdx.x) * kWarps
                         + (threadIdx.x >> 5);             // (b, q, h)
  if (item >= items) return;
  const int lane = threadIdx.x & 31;
  const int h = static_cast<int>(item % H);
  const long long b = item / H / Q;
  const long long row = static_cast<long long>(H) * D;
  float* db = d_value + b * S * row + static_cast<long long>(h) * D;
  const float2* loc_i = reinterpret_cast<const float2*>(loc) + item * L * P;
  const float* att_i = attn + item * L * P;
  const float* g_i = d_out + item * D;
  const float g0 = lane < D ? __ldg(g_i + lane) : 0.f;

#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l >= L) break;
    const int hl = lv.h[l], wl = lv.w[l];
    float* dl = db + lv.start[l] * row;
    for (int p = 0; p < P; ++p) {
      const float2 uv = __ldg(loc_i + l * P + p);
      const float a = __ldg(att_i + l * P + p);
      const Corners c = corners(uv, hl, wl);
      if (!c.finite || !(c.v00 || c.v01 || c.v10 || c.v11)) continue;
      const float tx = c.tx, ty = c.ty;
      const float w00 = (1.f - ty) * (1.f - tx), w01 = (1.f - ty) * tx;
      const float w10 = ty * (1.f - tx), w11 = ty * tx;
      const long long t00 = c.tok * row;
      const long long t10 = t00 + wl * row;
      for (int d = lane; d - lane < D; d += 32) {
        if (d >= D) break;
        const float ga = (d == lane ? g0 : __ldg(g_i + d)) * a;
        if (c.v00) atomicAdd(dl + t00 + d, ga * w00);
        if (c.v01) atomicAdd(dl + t00 + row + d, ga * w01);
        if (c.v10) atomicAdd(dl + t10 + d, ga * w10);
        if (c.v11) atomicAdd(dl + t10 + row + d, ga * w11);
      }
    }
  }
}

constexpr int kValueWarps = 4;     // warps per block of K9's group kernel

// (g a) w, channel by channel: the value one corner of a sample adds
__device__ __forceinline__ float4 scaled(float4 ga, float w) {
  return make_float4(ga.x * w, ga.y * w, ga.z * w, ga.w * w);
}

// K9 with one lane group of G lanes per query (V float4 chunks a lane): a
// warp owns 32 / G neighbouring queries of one (batch, head); each group
// scatters its query's samples, R at a time, the locations and weights of
// the R loaded first.
template <int G, int V>
__global__ void __launch_bounds__(32 * kValueWarps)
msdeform_backward_value_group_kernel(const float* __restrict__ loc,
                                     const float* __restrict__ attn,
                                     const float* __restrict__ d_out,
                                     float* __restrict__ d_value, Levels lv,
                                     int q_blocks, int S, int Q, int H, int D,
                                     int L, int P) {
  constexpr int NG = 32 / G;                  // queries a warp holds
  constexpr int R = 4;                        // samples loaded ahead
  __shared__ int s_h[kMaxLevels], s_w[kMaxLevels], s_start[kMaxLevels];
  msd::stage_levels(lv, s_h, s_w, s_start);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gi = lane / G, j = lane % G;
  // block -> (b, run of kValueWarps * NG queries, head), head fastest
  const int h = static_cast<int>(blockIdx.x % H);
  const int rest = static_cast<int>(blockIdx.x / H);
  const long long b = rest / q_blocks;
  const int q0 = ((rest % q_blocks) * kValueWarps + warp) * NG;
  if (q0 >= Q) return;                       // whole warps leave together
  const bool live_q = q0 + gi < Q;
  const long long item = (b * Q + (live_q ? q0 + gi : q0)) * H + h;
  float4 g[V];                               // the query's gradient, read once
  msd::load_row<G, V>(d_out + item * D, live_q, j, D, g);
  const long long row = static_cast<long long>(H) * D;       // token stride
  float* db = d_value + b * S * row + static_cast<long long>(h) * D;
  const int LP = L * P;
  const float2* loc_i = reinterpret_cast<const float2*>(loc) + item * LP;
  const float* att_i = attn + item * LP;
  const float inv_p = 1.f / P;

  for (int s0 = 0; s0 < LP; s0 += R) {
    float2 uv[R];
    float a[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool live = live_q && s0 + r < LP;
      uv[r] = live ? __ldg(loc_i + s0 + r) : make_float2(0.f, 0.f);
      a[r] = live ? __ldg(att_i + s0 + r) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int s = s0 + r;
      if (s >= LP) break;                     // uniform over the warp
      const int l = small_div(s, inv_p), wl = s_w[l];
      const Corners c = corners(uv[r], s_h[l], wl);
      // a non-finite location, and a query past Q, add nothing
      if (!(live_q && c.finite)) continue;
      const float tx = c.tx, ty = c.ty;
      const float w00 = (1.f - ty) * (1.f - tx), w01 = (1.f - ty) * tx;
      const float w10 = ty * (1.f - tx), w11 = ty * tx;
      float* c00 = db + static_cast<long long>(s_start[l]) * row + c.tok * row;
      float* c10 = c00 + wl * row;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int ch = msd::chunk_channel<G>(k, j);
        if (ch >= D) continue;
        const float4 ga = make_float4(g[k].x * a[r], g[k].y * a[r], g[k].z * a[r],
                                      g[k].w * a[r]);
        if (c.v00) msd::red_add4(c00 + ch, scaled(ga, w00));
        if (c.v01) msd::red_add4(c00 + row + ch, scaled(ga, w01));
        if (c.v10) msd::red_add4(c10 + ch, scaled(ga, w10));
        if (c.v11) msd::red_add4(c10 + row + ch, scaled(ga, w11));
      }
    }
  }
}

// K9's group kernel launch for G lanes of V float4 chunks a query.
template <int G, int V>
int launch_value_group(const float* loc, const float* attn, const float* d_out,
                       float* d_value, const Levels& lv, int B, int S, int Q, int H,
                       int D, int L, int P, cudaStream_t stream) {
  const int per_block = kValueWarps * (32 / G);
  const int q_blocks = (Q + per_block - 1) / per_block;
  const long long blocks = static_cast<long long>(B) * q_blocks * H;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  msdeform_backward_value_group_kernel<G, V>
      <<<static_cast<unsigned>(blocks), 32 * kValueWarps, 0, stream>>>(
          loc, attn, d_out, d_value, lv, q_blocks, S, Q, H, D, L, P);
  return static_cast<int>(cudaGetLastError());
}

// The launch shape shared by K8 and K9: blocks of kWarps warps over the
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

extern "C" int msdeform_backward_value_f32(
    const void* loc, const void* attn, const void* d_out, void* d_value,
    int B, int S, int Q, int H, int D, int L, int P, const int* level_h,
    const int* level_w, const int* level_start, void* stream) {
  Levels lv;
  long long items = 0;
  const long long blocks = launch_blocks(B, Q, H, D, P, &items);
  if (blocks < 0 ||
      !make_levels(L, level_h, level_w, level_start, &lv))
    return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  msdeform_backward_value_kernel<<<static_cast<unsigned>(blocks),
                                   32 * kWarps, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(loc), static_cast<const float*>(attn),
      static_cast<const float*>(d_out), static_cast<float*>(d_value), lv,
      items, S, Q, H, D, L, P);
  return static_cast<int>(cudaGetLastError());
}

// K9 on the lane-group kernel: D % 8 == 0, D <= 64, 16-byte aligned d_out
// and d_value; any other call returns cudaErrorInvalidValue.  G is the
// least power of two with 4 G >= D (V = 1 chunk, 4 channels a lane), so
// that one instruction of a group adds a whole row: at D = 32 that took
// 0.85x the time of K7's G = 4 lanes of 8 channels, which add a row in
// two instructions of half a row each (H100).
extern "C" int msdeform_backward_value_group_f32(
    const void* loc, const void* attn, const void* d_out, void* d_value,
    int B, int S, int Q, int H, int D, int L, int P, const int* level_h,
    const int* level_w, const int* level_start, void* stream) {
  Levels lv;
  if (B < 0 || Q < 0 || H < 1 || P < 1 || D < 8 || D % 8 != 0 ||
      D > kGroupMaxD || !msd::aligned16(d_out) || !msd::aligned16(d_value) ||
      !make_levels(L, level_h, level_w, level_start, &lv))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto lc = static_cast<const float*>(loc);
  const auto at = static_cast<const float*>(attn);
  const auto g = static_cast<const float*>(d_out);
  const auto dv = static_cast<float*>(d_value);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (D <= 8 ? 2 : D <= 16 ? 4 : D <= 32 ? 8 : 16) {
    case 2:
      return launch_value_group<2, 1>(lc, at, g, dv, lv, B, S, Q, H, D, L, P, st);
    case 4:
      return launch_value_group<4, 1>(lc, at, g, dv, lv, B, S, Q, H, D, L, P, st);
    case 8:
      return launch_value_group<8, 1>(lc, at, g, dv, lv, B, S, Q, H, D, L, P, st);
    default:
      return launch_value_group<16, 1>(lc, at, g, dv, lv, B, S, Q, H, D, L, P, st);
  }
}
