// K6 at B <= 8, K7 and K8: the interleaved-layout quantized GEMV, its dual
// projection and its gathered-expert GEMV, for sm_90a.  K6 above 8 rows
// (the prefill GEMM) is fast_il_gemm.cu.
//
// Replaces, in ggml_hexagon_tpu/ops/qmm_fast.py:
//  * K6: `_byte_kernel` (:510) and `_nibble_kernel` (:497, body `_nibble_y`
//    :432), launched through `pallas_call` in `_fast_call` (:663), with
//    `_kernel_x`, `_kernel_xg` and `_epilogue` (:376-411), in all four
//    modes: plain, normed (a fused RMSNorm), act (a fused silu(gate)*up over
//    a doubled input) and res (a residual added last), on planes with or
//    without a group bias;
//  * K7: `_dual_kernel` (:872, launched at :998): two interleaved
//    projections of one activation, each of either family, with its own
//    norm weight and its own bias, in one launch;
//  * K8: `kern` in `_indirect_call` (:1259, launched at :1285): the same
//    body on the rows of one expert, picked by an id.
//
// Planes: column j of the interleaved order holds the original column
// (j % G)*gs + j/G.  fq is int8 [n2, K] (byte family: Q8_0, the IQ4 LUT
// types, every type of more than 4 bits) or uint8 [n2, K/2] (nibble family:
// Q4_0, Q4_1, Q4_K; byte b holds column b in its low nibble and b + K/2 in
// its high one, and (K/2) % G == 0, so both take the scale of group b % G),
// or uint8 [n2, K/2] of the same packing holding 4-bit sign+magnitude codes
// (coded family: the i-quants and ternary, `cm` in the TPU kernels, a
// code-map id here; decoded by codes.cuh `decode4`, no group bias);
// fs bf16 [n2, G] group scales; the group bias is a stored plane fb bf16
// [n2, G] (the asymmetric types), or off * fs (off = -8 Q4_0, -16 Q5_0, -4
// Q3_K, -32 Q6_K), or absent.
//
// What bounds them: bytes (B <= 8, K7 and K8: each weight byte feeds B
// multiply-adds, 2B for a nibble byte).
//
// Numerics, the TPU kernels' contract (qmm_fast.py:319-521, 757-767): x is
// rounded to bf16 and interleaved; normed: inv = 1/sqrt(mean(x^2) + eps)
// over the f32 of that bf16 x, then bf16((x*inv)*wn_il); act: the input is
// the bf16 gate ++ up, both halves interleaved already, and silu(g)*u is
// computed in f32 and rounded to bf16.  Byte planes multiply the f32 x by
// the f32 weight q*scale; nibble and coded planes round q*scale to bf16 (q
// the decoded value on coded planes, exact in bf16); every product is
// summed in f32.  The bias is xg @ fb^T, or off * (xg @ fs^T), in f32,
// xg [B, G] being the activation's group sums: summed here from the bf16
// effective activation (xg_mode 2), or the caller's (xg_mode 1: in the
// normed mode the pre-norm sums, scaled here by inv).  The output is
// y + (bias + res), res an optional f32 row [B, n_res].
//
// Design:
//  * A pre-pass writes the effective activation in the planes' interleaved
//    column order: an elementwise interleave or silu(g)*u over the whole
//    grid, one block a row for the norm (its sum(x^2) first), nothing for a
//    pre-interleaved input.  Planes with a bias then take the group sums:
//    one more launch sums the activation's columns (xg_mode 2, 32 groups a
//    block), or the norm's block scales the caller's sums by inv, or the
//    kernel reads the caller's sums as they are.  The TPU kernel took the
//    interleave as an XLA op before its call, its prologues and group sums
//    inside its single K block.
//  * B <= 8 (K6), K7, K8: one warp a weight row, 16 weight bytes a lane a
//    step (one 16-byte load): 16 byte weights, or 32 nibble weights at
//    columns b..b+15 and b+K/2..b+K/2+15; then the lanes split the G bias
//    terms; warp shuffles end the row.
//  * K7: one grid over the rows of both parts, part a's first; a warp runs
//    the family, activation and bias of the part its row falls in.
//  * K8: grid (row blocks of one expert, P); each block reads ids[p] from
//    device memory, so the top-k never reaches the host and only the
//    selected experts' rows are read.  An id outside [0, E) writes a NaN row.
//  * Coded planes take the nibble body with the codes decoded four at a
//    time (low nibbles, then high ones, of each packed word) into signed
//    values before the scale: a third family beside byte and nibble, whose
//    id (`cm`) travels with each plane set, so K7's two parts keep their own.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "codes.cuh"

namespace {

constexpr int GEMV_WARPS = 8;
constexpr int PRE_THREADS = 256;

// pre-pass modes (the C entries' `mode`)
constexpr int MODE_PLAIN = 0, MODE_NORMED = 1, MODE_ACT = 2, MODE_PRE_IL = 3;

// One interleaved plane set and what its epilogue needs.
struct Planes {
  const uint8_t* fq;   // int8 [n2, K] or packed uint8 [n2, K/2]
  const uint16_t* fs;  // bf16 [n2, G]
  const uint16_t* fb;  // bf16 [n2, G], or null
  const float* xg;     // f32 [B, G] group sums, or null: no bias
  float off;           // the derived bias's offset (fb null)
  int n2, G, nib;
  int cm;              // code-map id of coded planes (nib set), else CM_NONE
};

__device__ __forceinline__ float bf2f(uint16_t v) {
  return __uint_as_float(((uint32_t)v) << 16);
}

__device__ __forceinline__ uint16_t f2bf(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float bf_round(float v) { return bf2f(f2bf(v)); }

__device__ __forceinline__ float byte_f(uint32_t word, int c) {
  return (float)(int8_t)(uint8_t)(word >> (8 * c));
}

__device__ __forceinline__ uint32_t byte_u(uint32_t word, int c) {
  return (word >> (8 * c)) & 0xffu;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// x_il[b, r*G + g] = x[b, g*gs + r]
__global__ void interleave_kernel(const uint16_t* __restrict__ x, int B, int K,
                                  int G, uint16_t* __restrict__ xil) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (size_t)B * K) return;
  const int b = (int)(e / K), j = (int)(e % K);
  const int gs = K / G;
  xil[e] = x[(size_t)b * K + (size_t)(j % G) * gs + j / G];
}

// One block a row: inv = 1/sqrt(mean(x^2) + eps), then
// x_il[b, j] = bf16((x[b, src(j)] * inv) * wn_il[j]); with xg_in (the
// caller's pre-norm group sums), xg_out[b, g] = xg_in[b, g] * inv.
__global__ void __launch_bounds__(PRE_THREADS) normed_kernel(
    const uint16_t* __restrict__ x, const float* __restrict__ wn, int K, int G,
    float eps, const float* __restrict__ xg_in, uint16_t* __restrict__ xil,
    float* __restrict__ xg_out) {
  __shared__ float red[PRE_THREADS / 32];
  __shared__ float bcast;
  const int b = blockIdx.x, t = threadIdx.x;
  const uint16_t* xr = x + (size_t)b * K;
  float ss = 0.f;
  for (int k = t; k < K; k += PRE_THREADS) {
    const float v = bf2f(xr[k]);
    ss += v * v;
  }
  ss = warp_sum(ss);
  if ((t & 31) == 0) red[t >> 5] = ss;
  __syncthreads();
  if (t == 0) {
    float s = 0.f;
    for (int w = 0; w < PRE_THREADS / 32; ++w) s += red[w];
    bcast = 1.f / sqrtf(s / (float)K + eps);
  }
  __syncthreads();
  const float inv = bcast;
  const int gs = K / G;
  for (int j = t; j < K; j += PRE_THREADS) {
    const float v = bf2f(xr[(size_t)(j % G) * gs + j / G]);
    xil[(size_t)b * K + j] = f2bf(v * inv * wn[j]);
  }
  if (xg_in != nullptr)
    for (int g = t; g < G; g += PRE_THREADS)
      xg_out[(size_t)b * G + g] = xg_in[(size_t)b * G + g] * inv;
}

// x [B, 2K] = gate ++ up, both interleaved: x_il[b, j] = bf16(silu(g) * u)
__global__ void act_kernel(const uint16_t* __restrict__ x, int B, int K,
                           uint16_t* __restrict__ xil) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (size_t)B * K) return;
  const size_t b = e / K, j = e % K;
  const float g = bf2f(x[b * 2 * K + j]);
  const float u = bf2f(x[b * 2 * K + K + j]);
  xil[e] = f2bf(g * (1.f / (1.f + expf(-g))) * u);
}

// The group sums of x_il, xg[b, g] = sum_r x_il[b, r*G + g]: grid
// (ceil(G/32), B); lane l of warp w sums rows r = w, w+8, ... of group
// 32*blockIdx.x + l (each warp reads 32 adjacent columns), and the eight
// warps' partials meet in shared memory.
__global__ void __launch_bounds__(PRE_THREADS) group_sums_kernel(
    const uint16_t* __restrict__ xil, int K, int G, float* __restrict__ xg) {
  constexpr int W = PRE_THREADS / 32;
  __shared__ float part[W][33];
  const int b = blockIdx.y, lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = blockIdx.x * 32 + lane;
  const int gs = K / G;
  float s = 0.f;
  if (g < G)
    for (int r = w; r < gs; r += W) s += bf2f(xil[(size_t)b * K + (size_t)r * G + g]);
  part[w][lane] = s;
  __syncthreads();
  if (w == 0 && g < G) {
    float t = 0.f;
    for (int i = 0; i < W; ++i) t += part[i][lane];
    xg[(size_t)b * G + g] = t;
  }
}

// One lane's share of NB row dots of x_il (row pitch ldx) against byte
// weight row `wrow` (K int8 values, scales `srow`): f32 weights.
template <int NB>
__device__ __forceinline__ void row_dots_byte(const uint16_t* __restrict__ xil,
                                              int ldx, const int8_t* __restrict__ wrow,
                                              const uint16_t* __restrict__ srow,
                                              int K, int G, int lane, float acc[NB]) {
#pragma unroll
  for (int b = 0; b < NB; ++b) acc[b] = 0.f;
  for (int j0 = lane * 16; j0 < K; j0 += 32 * 16) {
    const uint4 wv = __ldg(reinterpret_cast<const uint4*>(wrow + j0));
    const uint32_t ww[4] = {wv.x, wv.y, wv.z, wv.w};
    float w[16];
    int g = j0 % G;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      w[i] = byte_f(ww[i >> 2], i & 3) * bf2f(__ldg(srow + g));
      if (++g == G) g = 0;
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const uint4* xp = reinterpret_cast<const uint4*>(xil + (size_t)b * ldx + j0);
      const uint4 xa = __ldg(xp), xb = __ldg(xp + 1);
      const uint32_t xw[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
      float s = acc[b];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s = fmaf(bf2f(xw[i] & 0xffffu), w[2 * i], s);
        s = fmaf(bf2f(xw[i] >> 16), w[2 * i + 1], s);
      }
      acc[b] = s;
    }
  }
}

// The low and high nibbles of four packed bytes as decoded codes, one
// signed value a byte (coded planes).
__device__ __forceinline__ void decode_nibbles(uint32_t w, int cm, uint32_t& lo,
                                               uint32_t& hi) {
  lo = decode4(w & 0x0f0f0f0fu, cm, 3);
  hi = decode4((w >> 4) & 0x0f0f0f0fu, cm, 3);
}

// The same on a nibble weight row (K/2 packed bytes): byte p gives the
// weights of columns p and K/2 + p, each bf16(q * scale of group p % G);
// CODED: q is the decoded code (code map cm).
template <int NB, bool CODED>
__device__ __forceinline__ void row_dots_nib(const uint16_t* __restrict__ xil,
                                             int ldx, const uint8_t* __restrict__ wrow,
                                             const uint16_t* __restrict__ srow,
                                             int K, int G, int cm, int lane,
                                             float acc[NB]) {
#pragma unroll
  for (int b = 0; b < NB; ++b) acc[b] = 0.f;
  const int Kh = K / 2;
  for (int p0 = lane * 16; p0 < Kh; p0 += 32 * 16) {
    const uint4 wv = __ldg(reinterpret_cast<const uint4*>(wrow + p0));
    const uint32_t ww[4] = {wv.x, wv.y, wv.z, wv.w};
    uint32_t dl[4], dh[4];
    if constexpr (CODED) {
#pragma unroll
      for (int j = 0; j < 4; ++j) decode_nibbles(ww[j], cm, dl[j], dh[j]);
    }
    float wl[16], wh[16];
    int g = p0 % G;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float s = bf2f(__ldg(srow + g));
      if (++g == G) g = 0;
      if constexpr (CODED) {
        wl[i] = bf_round(byte_f(dl[i >> 2], i & 3) * s);
        wh[i] = bf_round(byte_f(dh[i >> 2], i & 3) * s);
      } else {
        const uint32_t q = byte_u(ww[i >> 2], i & 3);
        wl[i] = bf_round((float)(q & 15u) * s);
        wh[i] = bf_round((float)(q >> 4) * s);
      }
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const uint4* xl = reinterpret_cast<const uint4*>(xil + (size_t)b * ldx + p0);
      const uint4* xh = reinterpret_cast<const uint4*>(xil + (size_t)b * ldx + Kh + p0);
      const uint4 la = __ldg(xl), lb = __ldg(xl + 1), ha = __ldg(xh), hb = __ldg(xh + 1);
      const uint32_t lw[8] = {la.x, la.y, la.z, la.w, lb.x, lb.y, lb.z, lb.w};
      const uint32_t hw[8] = {ha.x, ha.y, ha.z, ha.w, hb.x, hb.y, hb.z, hb.w};
      float s = acc[b];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s = fmaf(bf2f(lw[i] & 0xffffu), wl[2 * i], s);
        s = fmaf(bf2f(lw[i] >> 16), wl[2 * i + 1], s);
        s = fmaf(bf2f(hw[i] & 0xffffu), wh[2 * i], s);
        s = fmaf(bf2f(hw[i] >> 16), wh[2 * i + 1], s);
      }
      acc[b] = s;
    }
  }
}

// Row n of P against NB rows of x_il: the dot products and the bias dots
// (xg @ fb^T or xg @ fs^T), warp-summed into every lane.  FAM: 2 coded
// planes, 1 nibble planes, 0 byte planes, -1 any (P.cm and P.nib read at
// run time, all bodies compiled in: more registers, so only K7, whose parts
// may differ, takes it).
template <int NB, int FAM>
__device__ __forceinline__ void row_eval(const uint16_t* __restrict__ xil, int ldx,
                                         const Planes& P, int K, size_t n, int lane,
                                         float dot[NB], float bias[NB]) {
  const int G = P.G;
  if (FAM == 2 || (FAM < 0 && P.cm))
    row_dots_nib<NB, true>(xil, ldx, P.fq + n * (size_t)(K / 2), P.fs + n * G, K, G,
                           P.cm, lane, dot);
  else if (FAM == 1 || (FAM < 0 && P.nib))
    row_dots_nib<NB, false>(xil, ldx, P.fq + n * (size_t)(K / 2), P.fs + n * G, K, G,
                            0, lane, dot);
  else
    row_dots_byte<NB>(xil, ldx, reinterpret_cast<const int8_t*>(P.fq) + n * (size_t)K,
                      P.fs + n * G, K, G, lane, dot);
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    dot[b] = warp_sum(dot[b]);
    bias[b] = 0.f;
  }
  if (P.xg != nullptr) {
    const uint16_t* brow = (P.fb != nullptr ? P.fb : P.fs) + n * G;
    for (int g = lane; g < G; g += 32) {
      const float f = bf2f(__ldg(brow + g));
#pragma unroll
      for (int b = 0; b < NB; ++b) bias[b] = fmaf(P.xg[(size_t)b * G + g], f, bias[b]);
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) bias[b] = warp_sum(bias[b]);
  }
}

// y + (bias + res), the TPU kernel's `_epilogue` order
__device__ __forceinline__ float finish(const Planes& P, float dot, float bias, float r) {
  const float once = P.xg == nullptr ? 0.f : (P.fb != nullptr ? bias : P.off * bias);
  return dot + (once + r);
}

template <int NB, int FAM>
__global__ void __launch_bounds__(GEMV_WARPS * 32) gemv_kernel(
    const uint16_t* __restrict__ xil, Planes P, int K,
    const float* __restrict__ res, int n_res, float* __restrict__ out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * GEMV_WARPS + warp;
  if (n >= P.n2) return;
  float dot[NB], bias[NB];
  row_eval<NB, FAM>(xil, K, P, K, n, lane, dot, bias);
  if (lane == 0) {
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const float r = (res != nullptr && n < n_res) ? res[(size_t)b * n_res + n] : 0.f;
      out[(size_t)b * P.n2 + n] = finish(P, dot[b], bias[b], r);
    }
  }
}

// K7: rows [0, A.n2) of the output row are part a's, the rest part b's
template <int NB>
__global__ void __launch_bounds__(GEMV_WARPS * 32) dual_kernel(
    const uint16_t* __restrict__ xil_a, const uint16_t* __restrict__ xil_b,
    Planes A, Planes Bq, int K, float* __restrict__ out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * GEMV_WARPS + warp;
  const int total = A.n2 + Bq.n2;
  if (n >= total) return;
  const bool in_a = n < A.n2;
  const Planes P = in_a ? A : Bq;
  float dot[NB], bias[NB];
  row_eval<NB, -1>(in_a ? xil_a : xil_b, K, P, K, in_a ? n : n - A.n2, lane, dot,
                   bias);
  if (lane == 0) {
#pragma unroll
    for (int b = 0; b < NB; ++b) out[(size_t)b * total + n] = finish(P, dot[b], bias[b], 0.f);
  }
}

// K8: grid (ceil(npe / GEMV_WARPS), P); row p of xil against rows
// ids[p]*npe + r of the stacked planes -> out[p, r]
template <int FAM>
__global__ void __launch_bounds__(GEMV_WARPS * 32) indirect_kernel(
    const uint16_t* __restrict__ xil, const int* __restrict__ ids, int npe,
    int n_exp, Planes P, int K, float* __restrict__ out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * GEMV_WARPS + warp;
  const int p = blockIdx.y;
  if (r >= npe) return;
  const int e = __ldg(ids + p);
  if (e < 0 || e >= n_exp) {
    if (lane == 0) out[(size_t)p * npe + r] = __int_as_float(0x7fc00000);
    return;
  }
  if (P.xg != nullptr) P.xg += (size_t)p * P.G;
  float dot[1], bias[1];
  row_eval<1, FAM>(xil + (size_t)p * K, K, P, K, (size_t)e * npe + r, lane, dot, bias);
  if (lane == 0) out[(size_t)p * npe + r] = finish(P, dot[0], bias[0], 0.f);
}

Planes make_planes(const void* fq, const void* fs, const void* fb, int n2, int G,
                   int nib, int cm, float off, const float* xg) {
  Planes P;
  P.fq = (const uint8_t*)fq;
  P.fs = (const uint16_t*)fs;
  P.fb = (const uint16_t*)fb;
  P.xg = xg;
  P.off = off;
  P.n2 = n2;
  P.G = G;
  P.nib = nib;
  P.cm = cm;
  return P;
}

// The pre-pass: the effective activation into xil (interleave, normed or
// act; nothing for a pre-interleaved input, whose xil is x) and the group
// sums the main kernel reads, returned in *xg_eff: the scratch xg (taken
// from xil, xg_mode 2, or the caller's sums times inv in the normed mode),
// the caller's xg_in as it is (xg_mode 1 otherwise), or null (no bias).
cudaError_t launch_prepass(int mode, const void* x, int B, int K, int G,
                           const float* wn, float eps, const float* xg_in,
                           int xg_mode, void* xil, float* xg,
                           const float** xg_eff, cudaStream_t s) {
  const size_t total = (size_t)B * K;
  const unsigned blocks = (unsigned)((total + 255) / 256);
  if (mode == MODE_PLAIN)
    interleave_kernel<<<blocks, 256, 0, s>>>((const uint16_t*)x, B, K, G, (uint16_t*)xil);
  else if (mode == MODE_ACT)
    act_kernel<<<blocks, 256, 0, s>>>((const uint16_t*)x, B, K, (uint16_t*)xil);
  else if (mode == MODE_NORMED)
    normed_kernel<<<B, PRE_THREADS, 0, s>>>((const uint16_t*)x, wn, K, G, eps,
                                             xg_mode == 1 ? xg_in : nullptr,
                                             (uint16_t*)xil, xg);
  *xg_eff = nullptr;
  if (xg_mode == 2) {
    group_sums_kernel<<<dim3((G + 31) / 32, B), PRE_THREADS, 0, s>>>(
        (const uint16_t*)xil, K, G, xg);
    *xg_eff = xg;
  } else if (xg_mode == 1) {
    *xg_eff = mode == MODE_NORMED ? xg : xg_in;
  }
  return cudaGetLastError();
}

template <int NB>
void launch_gemv(const uint16_t* xil, const Planes& P, int K, const float* res,
                 int n_res, float* out, cudaStream_t s) {
  const int blocks = (P.n2 + GEMV_WARPS - 1) / GEMV_WARPS;
  if (P.cm)
    gemv_kernel<NB, 2><<<blocks, GEMV_WARPS * 32, 0, s>>>(xil, P, K, res, n_res, out);
  else if (P.nib)
    gemv_kernel<NB, 1><<<blocks, GEMV_WARPS * 32, 0, s>>>(xil, P, K, res, n_res, out);
  else
    gemv_kernel<NB, 0><<<blocks, GEMV_WARPS * 32, 0, s>>>(xil, P, K, res, n_res, out);
}

template <int NB>
void launch_dual(const uint16_t* xa, const uint16_t* xb, const Planes& A,
                 const Planes& Bq, int K, float* out, cudaStream_t s) {
  const int rows = A.n2 + Bq.n2;
  dual_kernel<NB><<<(rows + GEMV_WARPS - 1) / GEMV_WARPS, GEMV_WARPS * 32, 0, s>>>(
      xa, xb, A, Bq, K, out);
}

// Whether (K, G), the family and the bias arguments of one plane set are
// taken (coded planes are packed and carry no bias).
bool bad_part(int nib, int cm, int K, int G, bool bias, int xg_mode,
              const float* xg_in, const float* xg) {
  return K % (nib ? 64 : 32) || G < 1 || K % G || bias != (xg_mode != 0) ||
         cm < CM_NONE || cm > CM_TERN || (cm && (!nib || bias)) ||
         xg_mode < 0 || xg_mode > 2 || (xg_mode == 1 && xg_in == nullptr) ||
         (bias && xg == nullptr);
}

}  // namespace

extern "C" {

const char* ght_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// K6 at B <= 8.  mode: 0 plain (x bf16 [B, K] in natural column order), 1 normed (the
// same x; wn f32 [K] interleaved, eps), 2 act (x bf16 [B, 2K], gate ++ up,
// both interleaved), 3 plain with x interleaved already (xil unused).
// nibble: fq uint8 [n2, K/2] packed, else int8 [n2, K]; cm: the code map of
// coded packed planes (0: none); fs bf16 [n2, G];
// the bias: fb bf16 [n2, G], or off * fs (fb null, off != 0), or none;
// xg_mode 1 takes the group sums xg_in f32 [B, G] (pre-norm in the normed
// mode), 2 takes them from the activation, 0 when there is no bias; res f32
// [B, n_res] or null; scratch xil bf16 [B, K] and xg f32 [B, G] (with a
// bias); out f32 [B, n2].
int fast_il_run(int mode, int nibble, int cm, const void* x, int B, int K, const void* fq,
                const void* fs, const void* fb, int n2, int G, float off,
                const float* xg_in, int xg_mode, const float* wn, float eps,
                const float* res, int n_res, void* xil, float* xg, float* out,
                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const bool bias = fb != nullptr || off != 0.f;
  if (B < 1 || B > 8 || n2 % 128 || mode < MODE_PLAIN || mode > MODE_PRE_IL ||
      (mode == MODE_NORMED && wn == nullptr) || n_res > n2 ||
      (mode != MODE_PRE_IL && xil == nullptr) ||
      bad_part(nibble, cm, K, G, bias, xg_mode, xg_in, xg))
    return (int)cudaErrorInvalidValue;
  if (mode == MODE_PRE_IL) xil = const_cast<void*>(x);
  const float* xg_eff;
  cudaError_t e = launch_prepass(mode, x, B, K, G, wn, eps, xg_in, xg_mode, xil, xg,
                                 &xg_eff, s);
  if (e != cudaSuccess) return (int)e;
  const Planes P = make_planes(fq, fs, fb, n2, G, nibble, cm, off, xg_eff);
  const uint16_t* xi = (const uint16_t*)xil;
  switch (B) {
    case 1: launch_gemv<1>(xi, P, K, res, n_res, out, s); break;
    case 2: launch_gemv<2>(xi, P, K, res, n_res, out, s); break;
    case 3: launch_gemv<3>(xi, P, K, res, n_res, out, s); break;
    case 4: launch_gemv<4>(xi, P, K, res, n_res, out, s); break;
    case 5: launch_gemv<5>(xi, P, K, res, n_res, out, s); break;
    case 6: launch_gemv<6>(xi, P, K, res, n_res, out, s); break;
    case 7: launch_gemv<7>(xi, P, K, res, n_res, out, s); break;
    default: launch_gemv<8>(xi, P, K, res, n_res, out, s); break;
  }
  return (int)cudaGetLastError();
}

// K7.  x bf16 [B <= 8, K] in natural column order; eps and, per part,
// wn_* f32 [K] interleaved like its planes (both null: no norm); per part
// the planes, family, code map, bias and group sums as in fast_il_run, scratch xil_*
// bf16 [B, K] and xg_* f32 [B, G_*]; out f32 [B, n2_a + n2_b].
int fast_dual_run(const void* x, int B, int K, float eps,
                  const float* wn_a, const void* fq_a, const void* fs_a,
                  const void* fb_a, int n2_a, int G_a, int nib_a, int cm_a, float off_a,
                  const float* xg_in_a, int xg_mode_a, void* xil_a, float* xg_a,
                  const float* wn_b, const void* fq_b, const void* fs_b,
                  const void* fb_b, int n2_b, int G_b, int nib_b, int cm_b, float off_b,
                  const float* xg_in_b, int xg_mode_b, void* xil_b, float* xg_b,
                  float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const bool bias_a = fb_a != nullptr || off_a != 0.f;
  const bool bias_b = fb_b != nullptr || off_b != 0.f;
  if (B < 1 || B > 8 || (wn_a == nullptr) != (wn_b == nullptr) || n2_a < 1 ||
      n2_b < 1 || xil_a == nullptr || xil_b == nullptr ||
      bad_part(nib_a, cm_a, K, G_a, bias_a, xg_mode_a, xg_in_a, xg_a) ||
      bad_part(nib_b, cm_b, K, G_b, bias_b, xg_mode_b, xg_in_b, xg_b))
    return (int)cudaErrorInvalidValue;
  const int mode = wn_a != nullptr ? MODE_NORMED : MODE_PLAIN;
  const float *xe_a, *xe_b;
  cudaError_t e = launch_prepass(mode, x, B, K, G_a, wn_a, eps, xg_in_a, xg_mode_a,
                                 xil_a, xg_a, &xe_a, s);
  if (e != cudaSuccess) return (int)e;
  e = launch_prepass(mode, x, B, K, G_b, wn_b, eps, xg_in_b, xg_mode_b, xil_b, xg_b,
                     &xe_b, s);
  if (e != cudaSuccess) return (int)e;
  const Planes A = make_planes(fq_a, fs_a, fb_a, n2_a, G_a, nib_a, cm_a, off_a, xe_a);
  const Planes Bq = make_planes(fq_b, fs_b, fb_b, n2_b, G_b, nib_b, cm_b, off_b, xe_b);
  const uint16_t* xa = (const uint16_t*)xil_a;
  const uint16_t* xb = (const uint16_t*)xil_b;
  switch (B) {
    case 1: launch_dual<1>(xa, xb, A, Bq, K, out, s); break;
    case 2: launch_dual<2>(xa, xb, A, Bq, K, out, s); break;
    case 3: launch_dual<3>(xa, xb, A, Bq, K, out, s); break;
    case 4: launch_dual<4>(xa, xb, A, Bq, K, out, s); break;
    case 5: launch_dual<5>(xa, xb, A, Bq, K, out, s); break;
    case 6: launch_dual<6>(xa, xb, A, Bq, K, out, s); break;
    case 7: launch_dual<7>(xa, xb, A, Bq, K, out, s); break;
    default: launch_dual<8>(xa, xb, A, Bq, K, out, s); break;
  }
  return (int)cudaGetLastError();
}

// K8.  x bf16 [P, K] in natural column order; ids int32 [P] on the card;
// stacked interleaved planes of n_exp*npe rows (family, code map, bias as
// in fast_il_run); xg_in f32 [P, G] the group sums of x where the planes carry
// a bias; scratch xil bf16 [P, K] and xg f32 [P, G]; out f32 [P, npe].
int fast_indirect_run(const void* x, int P, int K, const int* ids, int npe,
                      int n_exp, const void* fq, const void* fs, const void* fb,
                      int G, int nibble, int cm, float off, const float* xg_in, void* xil,
                      float* xg, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const bool bias = fb != nullptr || off != 0.f;
  const int xg_mode = bias ? 1 : 0;
  if (P < 1 || npe < 1 || n_exp < 1 || xil == nullptr ||
      bad_part(nibble, cm, K, G, bias, xg_mode, xg_in, xg))
    return (int)cudaErrorInvalidValue;
  const float* xg_eff;
  cudaError_t e = launch_prepass(MODE_PLAIN, x, P, K, G, nullptr, 0.f, xg_in, xg_mode,
                                 xil, xg, &xg_eff, s);
  if (e != cudaSuccess) return (int)e;
  const Planes Q = make_planes(fq, fs, fb, n_exp * npe, G, nibble, cm, off, xg_eff);
  dim3 grid((npe + GEMV_WARPS - 1) / GEMV_WARPS, P);
  if (cm)
    indirect_kernel<2><<<grid, GEMV_WARPS * 32, 0, s>>>(
        (const uint16_t*)xil, ids, npe, n_exp, Q, K, out);
  else if (nibble)
    indirect_kernel<1><<<grid, GEMV_WARPS * 32, 0, s>>>(
        (const uint16_t*)xil, ids, npe, n_exp, Q, K, out);
  else
    indirect_kernel<0><<<grid, GEMV_WARPS * 32, 0, s>>>(
        (const uint16_t*)xil, ids, npe, n_exp, Q, K, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
