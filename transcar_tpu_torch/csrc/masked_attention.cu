// Masked multi-head attention core, float32 throughout, online softmax.
//
// Replaces transcar_tpu/ops/pallas_attention.py::masked_mha_pallas.  The
// wrapper, the bound and the design are described in
// transcar_tpu_torch/ops/pallas_attention.py.
//
//   out[bh, q, :] = softmax_t(keep[b, q, t] ? scale * <q[bh,q], k[bh,t]>
//                                           : FLT_MIN_HALF) . v[bh, t, :]
//
// with b = bh / heads.  Layouts: q [BH, Q, HD], k/v [BH, T, HD], out
// [BH, Q, HD] float32 contiguous; keep [B, Q, T] uint8 (1 = visible).
// A fully-masked row gets finite values (a uniform average of v), which
// callers gate away.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int HD = 32;             // head dim (the flagship's 256 / 8)
constexpr int QT = 32;             // queries per block: one per lane
constexpr int NW = 4;              // warps per block; each takes a quarter
constexpr int NT = 32 * NW;        //   of every token chunk
constexpr int TC = 64;             // tokens per shared-memory chunk
constexpr int SUB = TC / NW;       // tokens per warp per chunk
constexpr int MS_LD = TC + 4;      // mask row stride: 17 words, odd, so the
                                   // 32 lanes' rows sit in distinct banks
// finfo(float32).min / 2, as transcar_tpu/ops/pallas_attention.py:26
constexpr float kNeg = -1.7014117331926443e38f;

__global__ void __launch_bounds__(NT)
masked_attention_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const uint8_t* __restrict__ keep,
                        float* __restrict__ out, int heads, int Q, int T,
                        float scale) {
  __shared__ __align__(16) float ks[TC * HD];
  __shared__ __align__(16) float vs[TC * HD];
  __shared__ uint8_t ms[QT * MS_LD];
  __shared__ float part_m[NW][QT], part_l[NW][QT];
  __shared__ float part_o[NW][QT][HD + 1];

  const int bh = blockIdx.x, b = bh / heads;
  const int q0 = blockIdx.y * QT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qi = q0 + lane;

  float qr[HD];
  if (qi < Q) {
    const float4* src = reinterpret_cast<const float4*>(
        q + (static_cast<size_t>(bh) * Q + qi) * HD);
#pragma unroll
    for (int d = 0; d < HD / 4; ++d) {
      float4 t = src[d];
      qr[4 * d] = t.x; qr[4 * d + 1] = t.y; qr[4 * d + 2] = t.z; qr[4 * d + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int d = 0; d < HD; ++d) qr[d] = 0.f;
  }

  // Running max, running sum and unnormalized output of this lane's query
  // over the tokens this warp has seen.
  float m = -INFINITY, l = 0.f, o[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) o[d] = 0.f;

  const size_t kv_base = static_cast<size_t>(bh) * T * HD;
  for (int t0 = 0; t0 < T; t0 += TC) {
    // Stage K, V and the mask tile; tokens past T load as masked zeros.
    for (int e = tid; e < TC * HD / 4; e += NT) {
      const int r = e / (HD / 4), c4 = e - r * (HD / 4);
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (t0 + r < T) {
        const size_t off = kv_base + static_cast<size_t>(t0 + r) * HD;
        kv = reinterpret_cast<const float4*>(k + off)[c4];
        vv = reinterpret_cast<const float4*>(v + off)[c4];
      }
      reinterpret_cast<float4*>(ks)[e] = kv;
      reinterpret_cast<float4*>(vs)[e] = vv;
    }
    for (int e = tid; e < QT * TC; e += NT) {
      const int r = e / TC, c = e - r * TC;
      const int qq = q0 + r, t = t0 + c;
      ms[r * MS_LD + c] = (qq < Q && t < T)
          ? keep[(static_cast<size_t>(b) * Q + qq) * T + t] : 0;
    }
    __syncthreads();

    float s[SUB];
    float cmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < SUB; ++j) {
      const int r = warp * SUB + j;
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc = fmaf(qr[d], ks[r * HD + d], acc);
      s[j] = ms[lane * MS_LD + r] ? acc * scale : kNeg;
      cmax = fmaxf(cmax, s[j]);
    }
    const float mn = fmaxf(m, cmax);
    const float alpha = expf(m - mn);           // 0 on the first chunk
    l *= alpha;
#pragma unroll
    for (int d = 0; d < HD; ++d) o[d] *= alpha;
#pragma unroll
    for (int j = 0; j < SUB; ++j) {
      const int r = warp * SUB + j;
      const float p = expf(s[j] - mn);
      l += p;
#pragma unroll
      for (int d = 0; d < HD; ++d) o[d] = fmaf(p, vs[r * HD + d], o[d]);
    }
    m = mn;
    __syncthreads();
  }

  // Merge the four warps' partial softmax states of each query.
  part_m[warp][lane] = m;
  part_l[warp][lane] = l;
#pragma unroll
  for (int d = 0; d < HD; ++d) part_o[warp][lane][d] = o[d];
  __syncthreads();
  for (int e = tid; e < QT * HD; e += NT) {
    const int r = e / HD, d = e - r * HD;
    if (q0 + r >= Q) continue;
    float mx = part_m[0][r];
#pragma unroll
    for (int w = 1; w < NW; ++w) mx = fmaxf(mx, part_m[w][r]);
    float sum = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = expf(part_m[w][r] - mx);
      sum += part_l[w][r] * f;
      acc += part_o[w][r][d] * f;
    }
    out[(static_cast<size_t>(bh) * Q + q0 + r) * HD + d] = acc / sum;
  }
}

}  // namespace

extern "C" int masked_attention_f32(const void* q, const void* k,
                                    const void* v, const void* keep,
                                    void* out, int batch_heads, int heads,
                                    int Q, int T, int head_dim, float scale,
                                    void* stream) {
  if (head_dim != HD) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(batch_heads, (Q + QT - 1) / QT);
  masked_attention_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const uint8_t*>(keep),
      static_cast<float*>(out), heads, Q, T, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tck_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
