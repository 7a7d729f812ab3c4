// Masked multi-head attention core (K2): float32 in and out, with both
// products on the tensor cores at float32 accuracy.
//
// Replaces transcar_tpu/ops/pallas_attention.py::masked_mha_pallas (the
// Pallas _kernel).  The wrapper and the bound are described in
// transcar_tpu_torch/ops/pallas_attention.py.
//
//   out[b, h, q, :] = softmax_t(keep[b, q, t] ? scale * <q[b,h,q], k[b,h,t]>
//                                             : kNeg) . v[b, h, t, :]
//
// with kNeg = finfo(float32).min / 2 and tokens t < T.  q, k, v and out
// are [B, H, L, 32] float32 views with unit stride along the head dim and
// 16-byte aligned rows (split_heads of a [B, L, H * 32] projection, and a
// [B, Q, H, 32] buffer for out); keep is [B, Q, T_keep] uint8 (1 =
// visible) with T_keep >= T a multiple of 4.  A fully-masked row averages
// v uniformly over the T tokens, as the plain version does.
//
// Design (FlashAttention-2's layout on Hopper's warpgroup products):
// - Products: wgmma m64n32k8 TF32 with float32 accumulators, each operand
//   split as hi = tf32_rna(x), lo = tf32_rna(x - hi) and a.b taken as
//   lo_a.hi_b + hi_a.lo_b + hi_a.hi_b (the dropped lo.lo is ~2^-22 of a
//   product), the counterpart of the TPU kernel's Precision.HIGHEST.
// - A block is TW warpgroups over the same 64 query rows of one (batch,
//   head).  Warpgroup th takes the token chunks th, th + TW, ... of CT =
//   32 tokens and runs on its own: its own cp.async ring (NS stages of K,
//   V and keep) and its own barrier, so the warpgroups drift apart and
//   one's softmax overlaps another's products and copies.  Their (max,
//   sum, output) states merge in shared memory at the end: 120 blocks of 4
//   warpgroups at the flagship's 8 heads x 900 queries.  The kernel is
//   bound by latency, not by the tensor cores, and four independent
//   warpgroups an SM hide more of it than two in lockstep.
// - Q is scaled by scale * log2(e) (the softmax runs on exp2), split and
//   stored once as K-major hi / lo tiles, the A operand of S = Q K^T.  A
//   chunk of K is split into hi / lo tiles [32 tokens][32 dims] and V into
//   V^T tiles [32 dims][32 tokens], K-major as wgmma takes TF32, under the
//   128-byte swizzle.
// - S (12 products a chunk) stays in registers; the online softmax keeps
//   a running max (quad-uniform, by shuffles) and a per-lane partial sum
//   per row.  The masked logit is set after the product; tokens past T
//   get -inf.
// - P's accumulator is P.V's A fragment as it stands: K tile row 8j + n
//   holds token 4n + j, so S's column group j gives lane t (= lane % 4)
//   tokens 8t + j and 8t + 4 + j (its 8 keep bytes of a row are one 8-byte
//   load); A columns t and t + 4 of P.V's k-step j take them, and V^T's
//   columns 8j .. 8j + 7 hold those tokens in that order.  V^T row 8n' + n
//   is head dim 8(n / 2) + 2n' + n % 2, so a lane ends with 8 contiguous
//   output dims of each of its rows.  P.V (12 products a chunk) sums each
//   chunk apart, added to the running output in float32: the tensor
//   cores' accumulate truncates, and one chain over all T tokens would
//   carry ~T / 8 * 3 truncations.
// Every chunk is computed, whatever its keep density: the time does not
// depend on the mask.

#include <cuda_runtime.h>

#include <cstdint>

#include "hopper_tile.cuh"

namespace {

constexpr int HD = 32;              // head dim (the flagship's 256 / 8)
constexpr int TW = 4;               // warpgroups of a block, along tokens
constexpr int NS = 3;               // stages in a warpgroup's cp.async ring
constexpr int QB = 64;              // queries per block (a warpgroup's rows)
constexpr int CT = 32;              // tokens per chunk
constexpr int NT = 128 * TW;
constexpr int RAW_BYTES = CT * HD * 4;              // raw K or V of a chunk
constexpr int STAGE_BYTES = 2 * RAW_BYTES + QB * CT;
constexpr int TILE_BYTES = CT * HD * 4;             // a 32 x 32 operand tile
constexpr int Q_BYTES = QB * HD * 4;                // Q hi (or lo)
constexpr int WG_BYTES = 4 * TILE_BYTES + NS * STAGE_BYTES;
constexpr int SMEM_BYTES = 1024 + 2 * Q_BYTES + TW * WG_BYTES;
constexpr int MERGE_LD = HD + 2;    // a row of the merge buffer: m, l, o
static_assert(WG_BYTES % 1024 == 0, "operand tiles on 1024-byte bounds");
static_assert((TW - 1) * QB * MERGE_LD * 4 <= SMEM_BYTES - 1024, "merge");
// finfo(float32).min / 2, as transcar_tpu/ops/pallas_attention.py:26
constexpr float kNeg = -1.7014117331926443e38f;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const uint8_t* keep;
  float* out;
  // element strides (batch, head, row) of q, k, v, out; keep (batch, row)
  long long qs[3], ks[3], vs[3], os[3], ms[2];
  int Q, T, T_keep;
  float qscale;                     // scale * log2(e)
};

// cp.async with zero-fill: `full` false copies nothing and writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The 128 threads of warpgroup th (barrier 0 is __syncthreads).
__device__ __forceinline__ void wg_sync(int th) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + th) : "memory");
}

// cvt.rna.tf32.f32 (round to nearest, ties away from zero) as an integer
// add of half a unit to the magnitude bits and a mask: the same values,
// fewer instructions.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// 2^x to 2 ulp; -inf gives 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// x = hi + lo to ~2^-22 of x, both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void split4(const float (&x)[4], float4& hi,
                                       float4& lo) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) split(x[i], h[i], l[i]);
  hi = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                   __uint_as_float(h[2]), __uint_as_float(h[3]));
  lo = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                   __uint_as_float(l[2]), __uint_as_float(l[3]));
}

#define TCK_D16                                                             \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),               \
      "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),           \
      "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),           \
      "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])

// D[64 x 32] (+)= A[64 x 8] * B[8 x 32], both K-major tiles in shared
// memory; TF32 in, float32 accumulators (16 a thread).
__device__ __forceinline__ void wgmma_ss(float (&d)[4][4], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n"
      "}\n"
      : TCK_D16
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 32] (+)= A[64 x 8] * B[8 x 32], A from registers, B a K-major
// tile; TF32 in, float32 accumulators (16 a thread).
__device__ __forceinline__ void wgmma_rs(float (&d)[4][4], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %20, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %21, p, 1, 1;\n"
      "}\n"
      : TCK_D16
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(desc_b));
}

#undef TCK_D16

// The 16-byte chunk c of a row r of 32 floats, under the 128-byte swizzle
// (TMA's and wgmma's; also the raw ring's layout, so that 8 lanes reading
// one chunk of 8 rows r = 8k .. 8k + 7 take apart banks).
__device__ __forceinline__ int swz(int r, int c) {
  return r * 8 + ((c ^ r) & 7);
}

// Chunk ci (tokens ci * CT ...) of K, V and keep into stage s % NS of the
// warpgroup's ring: its 128 threads.
__device__ __forceinline__ void issue_chunk(const Params& p, unsigned char* ring,
                                            const float* kb, const float* vb,
                                            const uint8_t* mb, int q0, int ci,
                                            int s, int tid) {
  const uint32_t base = hop::smem_u32(ring + (s % NS) * STAGE_BYTES);
  const int tok0 = ci * CT;
#pragma unroll
  for (int it = 0; it < CT * 8 / 128; ++it) {
    const int e = tid + 128 * it, r = e >> 3, c = e & 7, tok = tok0 + r;
    const bool in = tok < p.T;
    const uint32_t off = 16u * swz(r, c);
    cp_async16(base + off, in ? kb + tok * p.ks[2] + 4 * c : kb, in);
    cp_async16(base + RAW_BYTES + off, in ? vb + tok * p.vs[2] + 4 * c : vb,
               in);
  }
  const uint32_t mbase = base + 2 * RAW_BYTES;
#pragma unroll
  for (int it = 0; it < QB * CT / 4 / 128; ++it) {
    const int e = tid + 128 * it, r = e / (CT / 4), w = e % (CT / 4);
    const int tok = tok0 + 4 * w;
    const bool in = q0 + r < p.Q && tok < p.T_keep;
    cp_async4(mbase + 4u * e, in ? mb + r * p.ms[1] + tok : mb, in);
  }
}

// A chunk's K and V, split into the warpgroup's TF32 operand tiles with
// 16-byte stores and no bank conflicts: K hi / lo with token 4n + j at row
// 8j + n; V^T hi / lo with token 8t + 4h + j at column 8j + 4h + t and
// head dim 8(n / 2) + 2n' + n % 2 at row 8n' + n.  A V^T chunk is the 4
// columns 8j + 4h .. + 3 of a row, so a thread takes the 4 tokens t < 4 of
// one (j, h) and two dims, and writes two rows' chunks.
__device__ __forceinline__ void split_chunk(const unsigned char* st,
                                            unsigned char* tiles, int tid) {
  const float4* kr = reinterpret_cast<const float4*>(st);
  const float2* vr = reinterpret_cast<const float2*>(st + RAW_BYTES);
  float4* khi = reinterpret_cast<float4*>(tiles);
  float4* klo = khi + CT * 8;
  float4* vhi = klo + CT * 8;
  float4* vlo = vhi + HD * 8;
#pragma unroll
  for (int it = 0; it < CT * 8 / 128; ++it) {
    const int e = tid + 128 * it, tau = e >> 3, c = e & 7;
    const float4 x4 = kr[swz(tau, c)];
    const float x[4] = {x4.x, x4.y, x4.z, x4.w};
    float4 hi, lo;
    split4(x, hi, lo);
    const int rk = 8 * (tau & 3) + (tau >> 2);
    khi[swz(rk, c)] = hi;
    klo[swz(rk, c)] = lo;
  }
  const int j = (tid & 7) >> 1, h = tid & 1;
  const int half = (tid >> 3) & 1, c = tid >> 4;
  float y[2][4];                                  // [dim 4c + 2 half + i][t]
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float2 y2 = vr[2 * swz(8 * t + 4 * h + j, c) + half];
    y[0][t] = y2.x;
    y[1][t] = y2.y;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int d = 4 * c + 2 * half + i;
    const int rv = 8 * ((d >> 1) & 3) + 2 * (d >> 3) + (d & 1);
    float4 hi, lo;
    split4(y[i], hi, lo);
    vhi[swz(rv, 2 * j + h)] = hi;
    vlo[swz(rv, 2 * j + h)] = lo;
  }
}

// The keep mask after the product (tokens past T drop out), then the
// online softmax of one chunk: s becomes P = exp2(logit - running max), l
// is rescaled to the new max and alpha is what rescales the output.
__device__ __forceinline__ void softmax_chunk(
    const Params& p, const unsigned char* ms, int tok_w, int qw, int g, int t,
    float (&s)[4][4], float (&m)[2], float (&l)[2], float (&alpha)[2]) {
  const int r0 = 16 * qw + g;
  const uint2 k0 = reinterpret_cast<const uint2*>(ms + r0 * CT)[t];
  const uint2 k1 = reinterpret_cast<const uint2*>(ms + (r0 + 8) * CT)[t];
  const bool tail = tok_w + CT > p.T;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // byte j + 4 (i % 2) of the lane's 8 in row g (i < 2) or g + 8
      const uint32_t w = i == 0 ? k0.x : i == 1 ? k0.y : i == 2 ? k1.x : k1.y;
      float x = (w >> (8 * j)) & 0xffu ? s[j][i] : kNeg;
      if (tail && tok_w + 8 * t + j + 4 * (i & 1) >= p.T) x = -INFINITY;
      s[j][i] = x;
      mx[i >> 1] = fmaxf(mx[i >> 1], x);
    }
  }
  // Online softmax (the quad of a row holds all 32 tokens; at least
  // token tok_w < T, so the row max is finite).
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float mn = fmaxf(m[r], mx[r]);
    alpha[r] = exp2_approx(m[r] - mn);           // 0 on the first chunk
    m[r] = mn;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[j][i] = exp2_approx(s[j][i] - m[i >> 1]);
      l[i >> 1] += s[j][i];
    }
  }
}

// One chunk of a warpgroup: S = Q K^T, the online softmax, O = alpha O +
// P V.
__device__ __forceinline__ void compute_chunk(
    const Params& p, const unsigned char* ms, const unsigned char* tiles,
    const unsigned char* qtiles, int tok_w, int qw, int g, int t,
    float (&o)[4][4], float (&m)[2], float (&l)[2]) {
  const uint64_t dqh = hop::make_desc(qtiles, 16, 1024);
  const uint64_t dql = hop::make_desc(qtiles + Q_BYTES, 16, 1024);
  const uint64_t dkh = hop::make_desc(tiles, 16, 1024);
  const uint64_t dkl = hop::make_desc(tiles + TILE_BYTES, 16, 1024);
  const uint64_t dvh = hop::make_desc(tiles + 2 * TILE_BYTES, 16, 1024);
  const uint64_t dvl = hop::make_desc(tiles + 3 * TILE_BYTES, 16, 1024);

  // S: k-step kk is dims 8kk .. 8kk + 7, 32 bytes into each row.
  float s[4][4];
  hop::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t off = 32 * kk;
    wgmma_ss(s, hop::desc_add(dql, off), hop::desc_add(dkh, off), kk > 0);
    wgmma_ss(s, hop::desc_add(dqh, off), hop::desc_add(dkl, off), 1);
    wgmma_ss(s, hop::desc_add(dqh, off), hop::desc_add(dkh, off), 1);
  }
  hop::wgmma_commit();
  hop::wgmma_wait<0>();
  hop::fence_regs<16>(&s[0][0]);

  float alpha[2] = {1.f, 1.f};
  softmax_chunk(p, ms, tok_w, qw, g, t, s, m, l, alpha);

  // P V: k-step j takes S's column group j (A column t = S column 2t,
  // t + 4 = 2t + 1) and V^T's columns 8j .. 8j + 7.
  uint32_t ah[4][4], al[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    split(s[j][0], ah[j][0], al[j][0]);
    split(s[j][2], ah[j][1], al[j][1]);
    split(s[j][1], ah[j][2], al[j][2]);
    split(s[j][3], ah[j][3], al[j][3]);
  }
  float os[4][4] = {};             // this chunk's P V
  hop::wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t off = 32 * j;
    wgmma_rs(os, al[j], hop::desc_add(dvh, off), j > 0);
    wgmma_rs(os, ah[j], hop::desc_add(dvl, off), 1);
    wgmma_rs(os, ah[j], hop::desc_add(dvh, off), 1);
  }
  hop::wgmma_commit();
  hop::wgmma_wait<0>();
  hop::fence_regs<16>(&os[0][0]);
#pragma unroll
  for (int n = 0; n < 4; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      o[n][i] = fmaf(o[n][i], alpha[i >> 1], os[n][i]);
  }
}

__global__ void __launch_bounds__(NT, 1)
masked_attention_wgmma_kernel(const Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qw = warp & 3, th = warp >> 2;     // warp qw of warpgroup th
  const int g = lane >> 2, t = lane & 3, tid = threadIdx.x & 127;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * QB;
  const float* kb = p.k + b * p.ks[0] + h * p.ks[1];
  const float* vb = p.v + b * p.vs[0] + h * p.vs[1];
  const uint8_t* mb = p.keep + b * p.ms[0] + q0 * p.ms[1];
  unsigned char* qtiles = smem;
  unsigned char* tiles = smem + 2 * Q_BYTES + th * WG_BYTES;
  unsigned char* ring = tiles + 4 * TILE_BYTES;

  const int n_chunks = (p.T + CT - 1) / CT;
  const int mine = (n_chunks - th + TW - 1) / TW;   // chunks th, th + TW, ..
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < mine) issue_chunk(p, ring, kb, vb, mb, q0, th + TW * s, s, tid);
    cp_async_commit();
  }

  // Q, scaled and split into the K-major hi / lo tiles (rows past Q zero).
  {
    const float* qb = p.q + b * p.qs[0] + h * p.qs[1];
    float4* qhi = reinterpret_cast<float4*>(qtiles);
    float4* qlo = qhi + QB * 8;
    for (int e = threadIdx.x; e < QB * 8; e += NT) {
      const int r = e >> 3, c = e & 7;
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (q0 + r < p.Q) {
        const float4 x4 = *reinterpret_cast<const float4*>(
            qb + (q0 + r) * p.qs[2] + 4 * c);
        x[0] = x4.x * p.qscale;
        x[1] = x4.y * p.qscale;
        x[2] = x4.z * p.qscale;
        x[3] = x4.w * p.qscale;
      }
      float4 hi, lo;
      split4(x, hi, lo);
      qhi[swz(r, c)] = hi;
      qlo[swz(r, c)] = lo;
    }
    hop::fence_proxy_async();     // the Q tiles, for wgmma
    __syncthreads();
  }

  float o[4][4] = {}, m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int s = 0; s < mine; ++s) {
    const int ci = th + TW * s;
    cp_async_wait<NS - 2>();
    wg_sync(th);                  // chunk s landed; slot (s - 1) % NS free
    if (s + NS - 1 < mine)
      issue_chunk(p, ring, kb, vb, mb, q0, ci + TW * (NS - 1), s + NS - 1,
                  tid);
    cp_async_commit();
    const unsigned char* st = ring + (s % NS) * STAGE_BYTES;
    split_chunk(st, tiles, tid);
    hop::fence_proxy_async();     // the tiles, for wgmma
    wg_sync(th);
    compute_chunk(p, st + 2 * RAW_BYTES, tiles, qtiles, ci * CT, qw, g, t, o,
                  m, l);
  }
  cp_async_wait<0>();

  // Row sums over the quad, then the TW warpgroups' states merge.  A lane
  // holds dims 8t + 2n' + c (n' < 4, c < 2) of rows g and g + 8 in
  // o[n'][2r + c].  A warpgroup with no chunk (T <= 32 th) has m = -inf
  // and l = 0, and adds nothing.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (TW > 1) {
    __syncthreads();              // every warpgroup done with its smem
    float* buf = reinterpret_cast<float*>(smem);
    if (th > 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float* row = buf + ((th - 1) * QB + 16 * qw + g + 8 * r) * MERGE_LD;
        if (t == 0) {
          row[0] = m[r];
          row[1] = l[r];
        }
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          row[2 + 8 * t + 2 * n] = o[n][2 * r];
          row[3 + 8 * t + 2 * n] = o[n][2 * r + 1];
        }
      }
    }
    __syncthreads();
    if (th > 0) return;
#pragma unroll
    for (int w = 0; w < TW - 1; ++w) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float* row = buf + (w * QB + 16 * qw + g + 8 * r) * MERGE_LD;
        const float mn = fmaxf(m[r], row[0]);   // m[r] is finite
        const float f = exp2_approx(m[r] - mn);
        const float fw = exp2_approx(row[0] - mn);
        l[r] = l[r] * f + row[1] * fw;
        m[r] = mn;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          o[n][2 * r] = o[n][2 * r] * f + row[2 + 8 * t + 2 * n] * fw;
          o[n][2 * r + 1] = o[n][2 * r + 1] * f + row[3 + 8 * t + 2 * n] * fw;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * qw + g + 8 * r;
    if (row >= p.Q) continue;
    const float inv = 1.f / l[r];
    float4* dst = reinterpret_cast<float4*>(
        p.out + b * p.os[0] + h * p.os[1] + row * p.os[2] + 8 * t);
    dst[0] = make_float4(o[0][2 * r] * inv, o[0][2 * r + 1] * inv,
                         o[1][2 * r] * inv, o[1][2 * r + 1] * inv);
    dst[1] = make_float4(o[2][2 * r] * inv, o[2][2 * r + 1] * inv,
                         o[3][2 * r] * inv, o[3][2 * r + 1] * inv);
  }
}

}  // namespace

// strides: 14 element strides, (batch, head, row) of q, k, v and out, then
// (batch, row) of keep.
extern "C" int masked_attention_wgmma_f32(const void* q, const void* k,
                                          const void* v, const void* keep,
                                          void* out, const long long* strides,
                                          int B, int H, int Q, int T,
                                          int T_keep, int head_dim,
                                          float scale, void* stream) {
  if (head_dim != HD || Q < 1 || T < 1 || T_keep < T || T_keep % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      masked_attention_wgmma_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.keep = static_cast<const uint8_t*>(keep);
  p.out = static_cast<float*>(out);
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = strides[i];
    p.ks[i] = strides[3 + i];
    p.vs[i] = strides[6 + i];
    p.os[i] = strides[9 + i];
  }
  p.ms[0] = strides[12];
  p.ms[1] = strides[13];
  p.Q = Q;
  p.T = T;
  p.T_keep = T_keep;
  p.qscale = scale * kLog2e;
  dim3 grid((Q + QB - 1) / QB, H, B);
  masked_attention_wgmma_kernel<<<grid, NT, SMEM_BYTES,
                                  static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tck_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
