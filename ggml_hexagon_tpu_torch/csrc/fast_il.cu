// K6 at B <= 8, K7 and K8: the interleaved-layout quantized GEMV, its dual
// projection and its gathered-expert GEMV, for sm_90a.  K6 above 8 rows
// (the prefill GEMM) is fast_il_gemm.cu.
//
// Replaces, in ggml_hexagon_tpu/ops/qmm_fast.py:
//  * K6: `_byte_kernel` (:510) and `_nibble_kernel` (:497, body `_nibble_y`
//    :432, `_byte_y` :464), launched through `pallas_call` in `_fast_call`
//    (:663), with `_kernel_x`, `_kernel_xg` and `_epilogue` (:376-411), in
//    all four modes: plain, normed (a fused RMSNorm), act (a fused
//    silu(gate)*up over a doubled input) and res (a residual added last),
//    on planes with or without a group bias;
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
// code-map id here, decoded by codes.cuh; no group bias); fs bf16 [n2, G]
// group scales; the group bias is a stored plane fb bf16 [n2, G] (the
// asymmetric types), or off * fs (off = -8 Q4_0, -16 Q5_0, -4 Q3_K, -32
// Q6_K), or absent.
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
// K6 at B <= 8 and K8 (il_gemv_kernel): what bounds them is bytes (each
// weight byte feeds at most 8 multiply-adds, 16 on packed planes).  One
// launch a call, a block of four consumer warps and one producer warp:
//  * The interleave makes the planes periodic: weight column p*G + g (g the
//    group, the "residue"; p the "period", 0 <= p < gs) is natural column
//    g*gs + p, and a packed byte at (p, g) holds natural columns g*gs + p
//    and g*gs + p + gs/2.  A residue block of GW groups (128 from G = 128
//    up, the last block ragged where 128 does not divide G; else 64 or 32
//    dividing G, else 16) is thus a contiguous run of natural columns, and
//    its scales serve every period: the planes are read as a 3-D tensor
//    [rows][periods][residues].  A stage is one box of GW residues x NP
//    periods x TR = 64 rows (16 KB), brought by TMA from one producer
//    thread with an evict-first L2 policy into a ring of 1-32 stages; past
//    G the box reads zeros.  Where G is a multiple of 8 but not of 16 (no
//    TMA pitch; odd periods start off 16-byte units), the producer warp
//    copies a stage's weights with 8-byte loads instead, as NP boxes of GW
//    x TR, one a period, zeros past G.  The first stage of each residue block (and of a tile's range)
//    also brings that block's fs (and fb) rows into one of two scale
//    regions, which the consumers free once the stage's mma have used them.
//  * Blocks are persistent: a block takes the tiles blockIdx.x, + nbx, ...
//    of one K split and builds that split's effective bf16 activation once,
//    in shared memory, straight from x: the natural columns of its groups
//    (copied, then normed with the sum of squares over the whole row taken
//    by every block in one fixed order, so every block gets the same inv)
//    or the interleaved ones (pre-interleaved, act: silu(gate)*up); then the
//    group sums of its groups (in the kernel, or the caller's times inv),
//    each split exactly into three bf16 parts.  The producer keeps one stage
//    in flight until the activation is built.  K splits are whole stages
//    (the host's picker, kernels.pick_il_gemv, sizes the splits, the ring
//    and the blocks to the SMs); the last block of a split tile sums the
//    splits' partials in split order (an int32 counter a tile in device
//    memory, reset by that block): no second launch, no float atomics.
//  * The dot products are bf16 mma.sync (m16n8k16, f32 sums) with the
//    weight rows as M (16 a warp), the activation rows as N (B <= 8; the
//    columns past B are dropped) and 16 residues of one period as K: a
//    thread's A fragment is 4 consecutive residues of its two rows, one
//    word of the staged box, and its scales (constant over the periods)
//    stay in registers for the whole residue block.  Nibble weights
//    bf16(q*s) come from one fma.rn.bf16x2 of (128 + q) (a byte permute of
//    the nibbles under 0x43) with s and -128*s; coded ones from the byte
//    permute decode of codes.cuh with zero point 64 (the code's value + 64,
//    so 0x43 over it is 192 + q in bf16) less 192, times s; byte weights
//    q*s (up to 16 significant bits) as two exact bf16 parts, hi = bf16(q*s)
//    and lo = q*s - hi, in two mma.  Each product is exact; each period's
//    partial sums start from zero in two accumulators (the tensor cores
//    truncate as they align a long running sum) and are added to the f32
//    total.  The group bias is three more mma a residue block, the bias
//    plane (fb, or fs for off * fs) against the three parts of the group
//    sums.
//  * A template instance per family (byte, nibble, coded, ternary) and
//    residue block width, chosen once a launch.
//  * K8 is the same kernel, one input row a grid.z index, its tiles' rows
//    starting at ids[p] * npe (read on the device, so the routing never
//    reaches the host); an id outside [0, E) gives a NaN row.
//
// K7 (dual_kernel): a pre-pass writes the effective activation in the
// planes' interleaved column order (an elementwise interleave, or one block
// a row for the norm, its sum(x^2) first) and, for planes with a bias, the
// group sums (one more launch, 32 groups a block, or the norm's block
// scales the caller's sums by inv); then one grid over the rows of both
// parts, part a's first, one warp a weight row, 16 weight bytes a lane a
// step, a warp running the family, activation and bias of the part its row
// falls in (the code map travels with each part).
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "codes.cuh"
#include "hopper.cuh"

namespace {

// ============================================================================
// K7
// ============================================================================

constexpr int GEMV_WARPS = 8;
constexpr int PRE_THREADS = 256;

// activation modes (the C entries' `mode`)
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
__device__ __forceinline__ void decode_nibbles_cm(uint32_t w, int cm, uint32_t& lo,
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
      for (int j = 0; j < 4; ++j) decode_nibbles_cm(ww[j], cm, dl[j], dh[j]);
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

// K7's pre-pass: the effective activation into xil (interleave, or normed)
// and the group sums the main kernel reads, returned in *xg_eff: the
// scratch xg (taken from xil, xg_mode 2, or the caller's sums times inv in
// the normed mode), the caller's xg_in as it is (xg_mode 1 otherwise), or
// null (no bias).
cudaError_t launch_prepass(int mode, const void* x, int B, int K, int G,
                           const float* wn, float eps, const float* xg_in,
                           int xg_mode, void* xil, float* xg,
                           const float** xg_eff, cudaStream_t s) {
  const size_t total = (size_t)B * K;
  const unsigned blocks = (unsigned)((total + 255) / 256);
  if (mode == MODE_PLAIN)
    interleave_kernel<<<blocks, 256, 0, s>>>((const uint16_t*)x, B, K, G, (uint16_t*)xil);
  else
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
void launch_dual(const uint16_t* xa, const uint16_t* xb, const Planes& A,
                 const Planes& Bq, int K, float* out, cudaStream_t s) {
  const int rows = A.n2 + Bq.n2;
  dual_kernel<NB><<<(rows + GEMV_WARPS - 1) / GEMV_WARPS, GEMV_WARPS * 32, 0, s>>>(
      xa, xb, A, Bq, K, out);
}

// Whether (K, G), the family and the bias arguments of one plane set are
// refused (coded planes are packed and carry no bias).
bool bad_planes(int nib, int cm, int K, int G, bool bias, int xg_mode, const float* xg_in) {
  return K % (nib ? 64 : 32) || G < 1 || K % G || bias != (xg_mode != 0) ||
         cm < CM_NONE || cm > CM_TERN || (cm && (!nib || bias)) ||
         xg_mode < 0 || xg_mode > 2 || (xg_mode == 1 && xg_in == nullptr);
}

// The same for a K7 part, with its group-sum scratch.
bool bad_part(int nib, int cm, int K, int G, bool bias, int xg_mode,
              const float* xg_in, const float* xg) {
  return bad_planes(nib, cm, K, G, bias, xg_mode, xg_in) || (bias && xg == nullptr);
}

// ============================================================================
// K6 at B <= 8 and K8: il_gemv_kernel
// ============================================================================

constexpr int NCW = 4;            // consumer warps, 16 weight rows each
constexpr int NCT = NCW * 32;     // consumer threads
constexpr int NTH = NCT + 32;     // and one producer warp
constexpr int TR = 16 * NCW;      // weight rows a block
constexpr int SMEM_MAX = 232448;  // shared memory a block may take

// plane families of il_gemv_kernel
constexpr int FAM_BYTE = 0, FAM_NIB = 1, FAM_CODED = 2, FAM_TERN = 3;

// bf16 pairs, the constants of fma.rn.bf16x2
constexpr uint32_t BF2_NEG0 = 0x80008000u;  // -0
constexpr uint32_t BF2_NEG1 = 0xbf80bf80u;  // -1
constexpr uint32_t BF2_ONE = 0x3f803f80u;   // 1
constexpr uint32_t BF2_M128 = 0xc300c300u;  // -128
constexpr uint32_t BF2_M192 = 0xc340c340u;  // -192

// How a launch cuts its planes (kernels.il_geo mirrors it): GW residues a
// residue block (128 from G = 128 up, the last block ragged where G is not
// a multiple of 128; else 64 or 32 dividing G, else 16, the last block
// ragged where 16 does not divide G), nrb blocks; nper weight periods (gs,
// or gs/2 on packed planes), NP of them a stage, spr stages a residue
// block, nst stages in all; wb the bytes of a stage's weight box (GW x NP x
// TR), fsb of a scale box (GW x TR bf16).  pp: G is not a multiple of 16,
// so a period's G bytes are no TMA pitch and odd periods start off 16-byte
// units; the producer warp then copies a stage's weights itself, 8 bytes a
// load, as NP boxes of GW x TR, one a period (zeros past G).
struct IlGeo {
  int GW, NP, nper, spr, nrb, nst, wb, fsb, pp;
};

bool il_geo(IlGeo* g, int K, int G, bool packed) {
  // G % 8: the scales' row pitch is whole 16-byte units, as TMA needs, and
  // the activation's interleaved columns come 8 to a 16-byte load
  if (G < 8 || G % 8 || K % G) return false;
  const int gs = K / G;
  g->GW = G >= 128 ? 128 : G % 64 == 0 ? 64 : G % 32 == 0 ? 32 : 16;
  g->pp = G % 16 != 0;
  // 8 natural columns (periods) a load; packed planes pair periods p, p + gs/2
  if (gs % (packed ? 16 : 8)) return false;
  g->nper = packed ? gs / 2 : gs;
  g->NP = 256 / g->GW < g->nper ? 256 / g->GW : g->nper;
  if (g->nper % g->NP) return false;
  g->spr = g->nper / g->NP;
  g->nrb = (G + g->GW - 1) / g->GW;
  g->nst = g->nrb * g->spr;
  g->wb = g->GW * TR * g->NP;
  g->fsb = g->GW * TR * 2;
  return true;
}

// The block's shared memory: the ring of ns slots of wb bytes (a weight
// box each), two scale regions of sb bytes (the fs box and, with a stored
// bias, the fb box of a residue block), then the activation of arb residue
// blocks ([block][period] slabs of NB x GW bf16), their group sums' three
// bf16 parts ([block][part] slabs), the norm's partials and factors, the
// last-block flag and the mbarriers: full[ns], empty[ns], scales_free[2],
// ready (the activation is built).
struct IlLayout {
  int scales, act, xgp, red, inv, flag, bars, total;
};

__host__ __device__ inline IlLayout il_layout(const IlGeo& g, int sb, int ns, int arb, int gs,
                                              int nb, bool bias) {
  IlLayout l;
  const int slab = nb * g.GW * 2;
  l.scales = ns * g.wb;
  l.act = l.scales + 2 * sb;
  l.xgp = l.act + align128(arb * gs * slab);
  l.red = l.xgp + (bias ? align128(arb * 3 * slab) : 0);
  l.inv = l.red + 4 * NCW * 8;
  l.flag = l.inv + 4 * 8;
  l.bars = align128(l.flag + 16);
  l.total = l.bars + 8 * (2 * ns + 3);
  return l;
}

struct IlArgs {
  const uint16_t* x;   // bf16 [rows, xstride]: natural order (modes 0, 1) or interleaved
  const unsigned char* fq;  // the weight planes [rows_w, G * nper] (copied by the warp when pp)
  const float* wn;     // f32 [K] interleaved (normed)
  const float* xg_in;  // f32 [rows, G] (xg_mode 1)
  const float* res;    // f32 [rows, n_res] or null
  float* out;          // f32 [rows, ncols]
  float* ws;           // f32 [ks, rows, ncols] (ks > 1)
  int* counters;       // one a tile and row group, zero between calls
  const int* ids;      // K8: the expert of each input row (grid.z), else null
  IlGeo g;
  int mode, NB, K, G, gs, xstride, xg_mode, n_res, ncols;
  int kn;              // the normed mode's mean divides by kn (K, or the
                       // unpadded K of planes whose groups were padded)
  int ntiles, ks, ns, sb, arb;  // tiles, splits, ring stages, scale-region bytes,
                                // residue blocks a split touches
  int fb, bias, cm, npe, n_exp, rows_w;
  float off, eps;
};

// pp: the weight bytes of stage (rb, pb) of the tile from plane row wrow,
// [period][row][residue], copied by the 32 lanes of the producer warp with
// 8-byte loads (G % 8 == 0), zeros past G and past the planes' last row.
template <int GW>
__device__ __forceinline__ void copy_stage(const IlArgs& a, unsigned char* dst, int rb, int pb,
                                           int wrow, int lane) {
  constexpr int UP = GW / 8;  // 8-byte units a period's residues
  constexpr int U = 8;        // loads in flight a lane
  const IlGeo& g = a.g;
  const long long wbytes = (long long)a.G * g.nper;  // a plane row
  const int upr = g.NP * UP, nu = TR * upr;
  for (int u0 = lane; u0 < nu; u0 += 32 * U) {
    uint2 v[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int u = u0 + 32 * k, row = u / upr, rem = u - row * upr, p = rem / UP;
      const int res = rb * GW + (rem - p * UP) * 8;
      v[k] = make_uint2(0u, 0u);
      if (u < nu && res < a.G && wrow + row < a.rows_w)
        v[k] = __ldcs(reinterpret_cast<const uint2*>(
            a.fq + (wrow + row) * wbytes + (long long)(pb * g.NP + p) * a.G + res));
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int u = u0 + 32 * k, row = u / upr, rem = u - row * upr, p = rem / UP;
      if (u < nu)
        *reinterpret_cast<uint2*>(dst + (p * TR + row) * GW + (rem - p * UP) * 8) = v[k];
    }
  }
}

struct IlMaps {
  CUtensorMap w, fs, fb;
};

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NCT) : "memory");
}

__device__ __forceinline__ uint32_t bfma2(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// NW words of shared memory
template <int NW>
__device__ __forceinline__ void lds_words(uint32_t (&w)[NW], const void* p) {
  if constexpr (NW >= 4) {
#pragma unroll
    for (int i = 0; i < NW / 4; ++i) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[i];
      w[4 * i] = v.x; w[4 * i + 1] = v.y; w[4 * i + 2] = v.z; w[4 * i + 3] = v.w;
    }
  } else if constexpr (NW == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}

// A slab (one period, or one group-sum part, of a residue block) holds, for
// thread t of the mma (its RT = GW/4 residues t*RT ...) and activation row
// n, HW-element pieces ((h*NB + n)*4 + t)*HW: a quarter-warp reads 128
// contiguous bytes.
template <int GW>
__device__ __forceinline__ int frag_off(int nb, int n, int r) {
  constexpr int RT = GW / 4, HW = RT < 8 ? RT : 8;
  const int t = r / RT, rr = r % RT, h = rr / HW;
  return ((h * nb + n) * 4 + t) * HW + rr % HW;
}

// Thread t's RT activation values of row n of a slab, as RT/2 bf16 pairs.
template <int GW>
__device__ __forceinline__ void lds_frag(uint32_t (&v)[GW / 8], const uint16_t* slab, int nb,
                                         int n, int t) {
  constexpr int RT = GW / 4, HW = RT < 8 ? RT : 8;
#pragma unroll
  for (int h = 0; h < RT / HW; ++h) {
    uint32_t part[HW / 2];
    lds_words<HW / 2>(part, slab + ((h * nb + n) * 4 + t) * HW);
#pragma unroll
    for (int i = 0; i < HW / 2; ++i) v[h * HW / 2 + i] = part[i];
  }
}

// Two int8 weights (the bytes `sel` puts in the low byte of each half, under
// 0x43) as exact bf16: 128 + (b & 127) less 128, or less 256 where b < 0.
__device__ __forceinline__ uint32_t i8pair(uint32_t w, uint32_t sel) {
  const uint32_t t = prmt(w, 0x43u, sel);
  return bfma2(t & 0xff80ff80u, BF2_NEG1, t & 0xff7fff7fu);
}

// The four bf16 pairs, under 0x43, of one packed word (four residues): the
// low nibbles' residues (0, 1) and (2, 3), then the high nibbles'.  Nibble
// planes: 128 + q; coded (and ternary) planes: 192 + value.
template <int FAM>
__device__ __forceinline__ void nib_pairs(uint32_t w, const Decoder& dc, uint32_t (&v)[4]) {
  if constexpr (FAM == FAM_NIB) {
    const uint32_t l = w & 0x0f0f0f0fu, h = (w >> 4) & 0x0f0f0f0fu;
    v[0] = prmt(l, 0x43u, 0x4140u);
    v[1] = prmt(l, 0x43u, 0x4342u);
    v[2] = prmt(h, 0x43u, 0x4140u);
    v[3] = prmt(h, 0x43u, 0x4342u);
  } else {
    uint32_t lo, hi;  // [b0 lo, b0 hi, b1 lo, b1 hi], [b2 lo, ...]: value + 64
    if constexpr (FAM == FAM_TERN) {
      const uint32_t l = w & 0x0f0f0f0fu, h = (w >> 4) & 0x0f0f0f0fu;  // value + 1
      lo = prmt(l, h, 0x5140u) + 0x3f3f3f3fu;
      hi = prmt(l, h, 0x7362u) + 0x3f3f3f3fu;
    } else {
      decode_nibbles(w, dc, lo, hi);
    }
    v[0] = prmt(lo, 0x43u, 0x4240u);
    v[1] = prmt(hi, 0x43u, 0x4240u);
    v[2] = prmt(lo, 0x43u, 0x4341u);
    v[3] = prmt(hi, 0x43u, 0x4341u);
  }
}

// bf16(q*s) of a pair under 0x43 (nibble planes: with m = -128*s).
template <int FAM>
__device__ __forceinline__ uint32_t nib_weight(uint32_t v, uint32_t s, uint32_t m) {
  if constexpr (FAM == FAM_NIB) return bfma2(v, s, m);
  return bfma2(bfma2(v, BF2_ONE, BF2_M192), s, BF2_NEG0);
}

// One period of a stage for one warp: d0 + d1 += its 16 rows' weights
// (words w0 of row gid, w1 of row gid + 8, with their scales s0, s1 and, on
// nibble planes, m0 = -128*s0, m1) times the activation pairs xa (packed
// planes' low nibbles) and xb (their high nibbles), NCH = GW/16 mma chunks
// of four residues a thread; the two sums take alternate mma, halving the
// chain of dependent mma.
template <int FAM, int GW>
__device__ __forceinline__ void period_mma(float (&d0)[4], float (&d1)[4],
                                           const uint32_t (&w0)[GW / 16],
                                           const uint32_t (&w1)[GW / 16],
                                           const uint32_t (&s0)[GW / 8],
                                           const uint32_t (&s1)[GW / 8],
                                           const uint32_t (&m0)[GW / 8],
                                           const uint32_t (&m1)[GW / 8],
                                           const uint32_t (&xa)[GW / 8],
                                           const uint32_t (&xb)[GW / 8], const Decoder& dc) {
#pragma unroll
  for (int ch = 0; ch < GW / 16; ++ch) {
    const int j = 2 * ch;
    if constexpr (FAM == FAM_BYTE) {
      const uint32_t q00 = i8pair(w0[ch], 0x4140u), q01 = i8pair(w0[ch], 0x4342u);
      const uint32_t q10 = i8pair(w1[ch], 0x4140u), q11 = i8pair(w1[ch], 0x4342u);
      const uint32_t h00 = bfma2(q00, s0[j], BF2_NEG0), h01 = bfma2(q01, s0[j + 1], BF2_NEG0);
      const uint32_t h10 = bfma2(q10, s1[j], BF2_NEG0), h11 = bfma2(q11, s1[j + 1], BF2_NEG0);
      mma16816(d0, h00, h10, h01, h11, xa[j], xa[j + 1]);
      mma16816(d1, bfma2(q00, s0[j], h00 ^ BF2_NEG0), bfma2(q10, s1[j], h10 ^ BF2_NEG0),
               bfma2(q01, s0[j + 1], h01 ^ BF2_NEG0), bfma2(q11, s1[j + 1], h11 ^ BF2_NEG0),
               xa[j], xa[j + 1]);
    } else {
      uint32_t v0[4], v1[4];
      nib_pairs<FAM>(w0[ch], dc, v0);
      nib_pairs<FAM>(w1[ch], dc, v1);
      mma16816(d0, nib_weight<FAM>(v0[0], s0[j], m0[j]), nib_weight<FAM>(v1[0], s1[j], m1[j]),
               nib_weight<FAM>(v0[1], s0[j + 1], m0[j + 1]),
               nib_weight<FAM>(v1[1], s1[j + 1], m1[j + 1]), xa[j], xa[j + 1]);
      mma16816(d1, nib_weight<FAM>(v0[2], s0[j], m0[j]), nib_weight<FAM>(v1[2], s1[j], m1[j]),
               nib_weight<FAM>(v0[3], s0[j + 1], m0[j + 1]),
               nib_weight<FAM>(v1[3], s1[j + 1], m1[j + 1]), xb[j], xb[j + 1]);
    }
  }
}

// Sums of squares of the NB activation rows, whole rows, in one fixed order
// (every block the same), into inv[b] = 1/sqrt(mean + eps).
__device__ __forceinline__ void row_norms(const IlArgs& a, int xrow, float* red, float* inv,
                                          int tid) {
  const int NB = a.NB, nck = a.K / 8, ntask = NB * nck;
  float ss[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int t0 = tid; t0 < ntask; t0 += 8 * NCT) {
    uint4 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int task = min(t0 + u * NCT, ntask - 1), b = task / nck;
      v[u] = *reinterpret_cast<const uint4*>(a.x + (size_t)(xrow + b) * a.xstride +
                                             (task - b * nck) * 8);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int task = t0 + u * NCT;
      if (task >= ntask) break;
      const uint32_t w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
      float q = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float lo = bf2f(w[i] & 0xffffu), hi = bf2f(w[i] >> 16);
        q += lo * lo;
        q += hi * hi;
      }
      const int b = task / nck;
#pragma unroll
      for (int bb = 0; bb < 8; ++bb)
        if (bb == b) ss[bb] += q;
    }
  }
  const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const float v = warp_sum(ss[b]);
    if (lane == 0 && b < NB) red[warp * 8 + b] = v;
  }
  consumers_sync();
  if (tid < NB) {
    const float v = red[tid] + red[8 + tid] + red[16 + tid] + red[24 + tid];
    inv[tid] = 1.f / sqrtf(v / (float)a.kn + a.eps);
  }
  consumers_sync();
}

// The effective bf16 activation of residue blocks [rb_lo, rb_lo + nrbt) into
// its slabs, and with a bias their group sums' three exact bf16 parts.
template <int GW>
__device__ __forceinline__ void build_act(const IlArgs& a, int xrow, int rb_lo, int nrbt,
                                          uint16_t* act, uint16_t* xgp, const float* inv,
                                          int tid) {
  constexpr int U = 8;  // loads in flight a thread
  const int NB = a.NB, gs = a.gs, G = a.G, K = a.K, slab = NB * GW;
  const int per_rb = gs * (GW / 8);  // 8-element runs of a residue block
  if (a.mode == MODE_PLAIN || a.mode == MODE_NORMED) {
    // natural columns, as they are: 8 periods of one residue a load
    const int cb = rb_lo * GW * gs, ntask = NB * nrbt * per_rb, nch = ntask / NB;
    for (int t0 = tid; t0 < ntask; t0 += U * NCT) {
      uint4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int task = min(t0 + u * NCT, ntask - 1), b = task / nch;
        const int c = cb + (task - b * nch) * 8;
        v[u] = c < K ? *reinterpret_cast<const uint4*>(a.x + (size_t)(xrow + b) * a.xstride + c)
                     : make_uint4(0u, 0u, 0u, 0u);  // past G: a ragged block's zeros
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int task = t0 + u * NCT;
        if (task >= ntask) break;
        const int b = task / nch, c = cb + (task - b * nch) * 8;
        const int gcol = c / gs, p0 = c - gcol * gs;
        uint16_t* dst =
            act + ((gcol / GW - rb_lo) * gs + p0) * slab + frag_off<GW>(NB, b, gcol % GW);
        const uint32_t w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
        for (int i = 0; i < 8; ++i) dst[i * slab] = (uint16_t)(w[i >> 1] >> (16 * (i & 1)));
      }
    }
    if (a.mode == MODE_NORMED) {
      // bf16((x * inv) * wn_il), 8 residues of one period a task, the norm
      // weight's 8 interleaved columns loaded once for every row
      consumers_sync();
      const int ntn = nrbt * per_rb;
      for (int task = tid; task < ntn; task += NCT) {
        const int rbl = task / per_rb, q = task - rbl * per_rb, p = q / (GW / 8);
        const int r0 = (q - p * (GW / 8)) * 8;
        if ((rb_lo + rbl) * GW + r0 >= G) continue;  // a ragged block's zeros
        const float4* wp =
            reinterpret_cast<const float4*>(a.wn + (size_t)p * G + (rb_lo + rbl) * GW + r0);
        const float4 w0 = __ldg(wp), w1 = __ldg(wp + 1);
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
        uint16_t* blk = act + (rbl * gs + p) * slab;
        for (int b = 0; b < NB; ++b) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            uint16_t* e = blk + frag_off<GW>(NB, b, r0 + i);
            *e = f2bf(bf2f(*e) * inv[b] * wv[i]);
          }
        }
      }
    }
  } else {
    // interleaved columns p*G + g: 8 residues of one period a load
    const int nch = nrbt * per_rb, ntask = NB * nch;
    for (int t0 = tid; t0 < ntask; t0 += U * NCT) {
      uint4 v[U], up[U] = {};
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int task = min(t0 + u * NCT, ntask - 1), b = task / nch, q = task - b * nch;
        const int rbl = q / per_rb, q2 = q - rbl * per_rb, p = q2 / (GW / 8);
        const int g0 = (rb_lo + rbl) * GW + (q2 - p * (GW / 8)) * 8;
        const uint16_t* src = a.x + (size_t)(xrow + b) * a.xstride + (size_t)p * G + g0;
        v[u] = make_uint4(0u, 0u, 0u, 0u);  // past G: a ragged block's zeros
        if (g0 < G) {
          v[u] = *reinterpret_cast<const uint4*>(src);
          if (a.mode == MODE_ACT) up[u] = *reinterpret_cast<const uint4*>(src + K);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int task = t0 + u * NCT;
        if (task >= ntask) break;
        const int b = task / nch, q = task - b * nch;
        const int rbl = q / per_rb, q2 = q - rbl * per_rb, p = q2 / (GW / 8);
        const int r0 = (q2 - p * (GW / 8)) * 8;
        uint16_t* dst = act + (rbl * gs + p) * slab;
        const uint32_t w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
        const uint32_t wu[4] = {up[u].x, up[u].y, up[u].z, up[u].w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          uint16_t e = (uint16_t)(w[i >> 1] >> (16 * (i & 1)));
          if (a.mode == MODE_ACT) {
            const float gv = bf2f(e), uv = bf2f((wu[i >> 1] >> (16 * (i & 1))) & 0xffffu);
            e = f2bf(gv * (1.f / (1.f + expf(-gv))) * uv);
          }
          dst[frag_off<GW>(NB, b, r0 + i)] = e;
        }
      }
    }
  }
  if (!a.bias) return;
  // the group sums of the block's groups, as three exact bf16 parts
  consumers_sync();  // the activation is complete
  for (int task = tid; task < nrbt * slab; task += NCT) {
    const int rbl = task / slab, q = task - rbl * slab, b = q / GW, r = q - b * GW;
    float s = 0.f;
    if (a.xg_mode == 2) {
      // four partial sums over the periods (gs % 8 == 0), then in order
      const uint16_t* col = act + rbl * gs * slab + frag_off<GW>(NB, b, r);
      float q[4] = {0.f, 0.f, 0.f, 0.f};
      for (int p = 0; p < gs; p += 4)
#pragma unroll
        for (int k = 0; k < 4; ++k) q[k] += bf2f(col[(p + k) * slab]);
      s = (q[0] + q[1]) + (q[2] + q[3]);
    } else if ((rb_lo + rbl) * GW + r < G) {
      s = a.xg_in[(size_t)(xrow + b) * G + (rb_lo + rbl) * GW + r];
      if (a.mode == MODE_NORMED) s *= inv[b];
    }
    const uint32_t p1 = __float_as_uint(s) & 0xffff0000u;
    const float r1 = s - __uint_as_float(p1);
    const uint32_t p2 = __float_as_uint(r1) & 0xffff0000u;
    const float r2 = r1 - __uint_as_float(p2);
    uint16_t* dst = xgp + rbl * 3 * slab + frag_off<GW>(NB, b, r);
    dst[0] = (uint16_t)(p1 >> 16);
    dst[slab] = (uint16_t)(p2 >> 16);
    dst[2 * slab] = (uint16_t)(__float_as_uint(r2) >> 16);
  }
}

// grid.x: blocks that take tiles of TR rows blockIdx.x, + gridDim.x, ...;
// grid.y: K splits; grid.z: row groups (K6: one of NB rows; K8: one input
// row each, ids non-null).  A block builds its split's activation once and
// streams its tiles' stages through one ring.
template <int FAM, int GW>
__global__ void __launch_bounds__(NTH, 2)
    il_gemv_kernel(const __grid_constant__ IlArgs a, const __grid_constant__ IlMaps maps) {
  constexpr int RT = GW / 4;  // residues a thread
  constexpr bool PACKED = FAM != FAM_BYTE;
  extern __shared__ __align__(128) unsigned char smem[];
  const IlGeo g = a.g;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int NB = a.NB, gs = a.gs, ns = a.ns, sb = a.sb;
  const int split = blockIdx.y, z = blockIdx.z;
  // this split's stages [s0, s1) of every tile, a whole number, and their
  // residue blocks
  const int s0 = (int)((long long)split * g.nst / a.ks);
  const int s1 = (int)((long long)(split + 1) * g.nst / a.ks);
  const int nps = s1 - s0;
  const int rb_lo = s0 / g.spr, nrbt = (s1 - 1) / g.spr - rb_lo + 1;
  const int ntile = (a.ntiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  bool valid = true;
  int wrow0 = 0;  // the plane row of tile 0
  if (a.ids != nullptr) {
    const int e = __ldg(a.ids + z);
    valid = e >= 0 && e < a.n_exp;
    wrow0 = valid ? e * a.npe : 0;
  }
  const int nst = valid ? ntile * nps : 0;
  const IlLayout L = il_layout(g, sb, ns, a.arb, gs, NB, a.bias);
  const uint32_t base = smem_u32(smem);
  const uint32_t bars = base + L.bars;  // full[ns], empty[ns], scales_free[2], ready
  const uint32_t sfree = bars + 16 * ns, ready = sfree + 16;
  uint16_t* act = reinterpret_cast<uint16_t*>(smem + L.act);
  uint16_t* xgp = reinterpret_cast<uint16_t*>(smem + L.xgp);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* inv = reinterpret_cast<float*>(smem + L.inv);
  int* flag = reinterpret_cast<int*>(smem + L.flag);

  if (tid == 0) {
    for (int s = 0; s < ns; ++s) {
      mbar_init(bars + 8 * s, 1);           // the producer's expected bytes
      mbar_init(bars + 8 * (ns + s), NCW);  // every consumer warp's release
    }
    mbar_init(sfree, NCW);
    mbar_init(sfree + 8, NCW);
    mbar_init(ready, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == NCW) {
    // ---- producer: one thread keeps the ring full (pp: the warp copies
    // the weights, its lane 0 then hands the stage over) ----
    if (lane == 0 || g.pp) {
      const uint64_t pol = evict_first_policy();
      int nsc = 0;  // scale stages so far
      for (int i = 0, slot = 0, par = 0, ti = 0, j = 0; i < nst; ++i) {
        // one stage in flight while the consumers build the activation,
        // whose loads then meet an idle L2
        if (i == 1) mbar_wait(ready, 0);
        if (i >= ns) mbar_wait(bars + 8 * (ns + slot), par ^ 1);
        const int s = s0 + j, rb = s / g.spr, pb = s - rb * g.spr;
        const int wrow = wrow0 + ((int)blockIdx.x + ti * (int)gridDim.x) * TR;
        const uint32_t full = bars + 8 * slot;
        const bool scales = j == 0 || pb == 0;
        const int r = nsc & 1;
        if (scales && nsc >= 2) mbar_wait(sfree + 8 * r, ((nsc >> 1) & 1) ^ 1);
        if (g.pp) {
          copy_stage<GW>(a, smem + slot * g.wb, rb, pb, wrow, lane);
          __syncwarp();  // the lanes' copies precede lane 0's arrival
        }
        if (lane == 0) {
          const int tx = (g.pp ? 0 : g.wb) + (scales ? sb : 0);
          if (tx) mbar_expect_tx(full, tx);
          else mbar_arrive(full);
          if (scales) {
            const uint32_t sdst = base + L.scales + r * sb;
            tma_load_2d(sdst, &maps.fs, rb * GW, wrow, full);
            if (a.fb) tma_load_2d(sdst + g.fsb, &maps.fb, rb * GW, wrow, full);
          }
          if (!g.pp) tma_load_3d_ef(base + slot * g.wb, &maps.w, rb * GW, pb * g.NP, wrow, full, pol);
        }
        if (scales) ++nsc;
        if (++slot == ns) slot = 0, par ^= 1;
        if (++j == nps) j = 0, ++ti;
      }
    }
    return;
  }

  // ---- the activation of the split's residue blocks, while the ring fills ----
  const int xrow = a.ids != nullptr ? z : 0;  // the block's first input row
  const int slab = NB * GW;                   // elements of a slab
  if (valid) {
    if (a.mode == MODE_NORMED) row_norms(a, xrow, red, inv, tid);
    build_act<GW>(a, xrow, rb_lo, nrbt, act, xgp, inv, tid);
  }
  consumers_sync();
  if (tid == 0) mbar_arrive(ready);

  // ---- the mma over the ring, tile after tile ----
  const int gid = lane >> 2, tq = lane & 3;
  const int nx = min(gid, NB - 1);  // columns past NB repeat the last row; dropped
  const int r0 = 16 * warp + gid;   // the thread's rows r0 and r0 + 8 of a tile
  // a stage's weight bytes: [row][period][residue], or [period][row][residue]
  const int rstep = g.pp ? GW : g.NP * GW, pstep = g.pp ? TR * GW : GW;
  const int rows = a.ids != nullptr ? (int)gridDim.z : NB;  // output rows
  const int nbo = a.ids != nullptr ? 1 : NB;                // this block's
  const float nan = __int_as_float(0x7fc00000);
  uint32_t s0r[RT / 2], s1r[RT / 2], m0[RT / 2] = {}, m1[RT / 2] = {};
  Decoder dc{};
  if constexpr (FAM == FAM_CODED) dc = decoder_of(a.cm, 3, 64u);
  int slot = 0, par = 0, nsc = 0;
  for (int ti = 0; ti < ntile; ++ti) {
    const int tile = (int)blockIdx.x + ti * (int)gridDim.x;
    float acc[4] = {0.f, 0.f, 0.f, 0.f}, cb[4] = {0.f, 0.f, 0.f, 0.f};
    for (int j = 0; j < (valid ? nps : 0); ++j) {
      const int s = s0 + j, rb = s / g.spr, pb = s - rb * g.spr, rbl = rb - rb_lo;
      int scale_region = -1;  // the scale region this stage loaded, freed after its mma
      mbar_wait(bars + 8 * slot, par);
      if (j == 0 || pb == 0) {
        // the residue block's scales, for all its periods
        const int r = nsc & 1;
        const uint16_t* fsr = reinterpret_cast<const uint16_t*>(smem + L.scales + r * sb);
        lds_words<RT / 2>(s0r, fsr + r0 * GW + RT * tq);
        lds_words<RT / 2>(s1r, fsr + (r0 + 8) * GW + RT * tq);
        if constexpr (FAM == FAM_NIB) {
#pragma unroll
          for (int k = 0; k < RT / 2; ++k) {
            m0[k] = bfma2(s0r[k], BF2_M128, BF2_NEG0);
            m1[k] = bfma2(s1r[k], BF2_M128, BF2_NEG0);
          }
        }
        if (pb == 0 && a.bias) {
          // the residue block's bias dot: fb (or fs) against the sums' parts
          uint32_t f0[RT / 2], f1[RT / 2];
          const uint16_t* fbr = a.fb ? fsr + g.fsb / 2 : fsr;
          lds_words<RT / 2>(f0, fbr + r0 * GW + RT * tq);
          lds_words<RT / 2>(f1, fbr + (r0 + 8) * GW + RT * tq);
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            uint32_t xq[RT / 2];
            lds_frag<GW>(xq, xgp + (rbl * 3 + q) * slab, NB, nx, tq);
#pragma unroll
            for (int ch = 0; ch < GW / 16; ++ch)
              mma16816(cb, f0[2 * ch], f1[2 * ch], f0[2 * ch + 1], f1[2 * ch + 1], xq[2 * ch],
                       xq[2 * ch + 1]);
          }
        }
        scale_region = r;
        ++nsc;
      }
      const unsigned char* st = smem + slot * g.wb;
      const uint16_t* xs = act + rbl * gs * slab;
      for (int p = 0; p < g.NP; ++p) {
        uint32_t w0[RT / 4], w1[RT / 4], xa[RT / 2], xb[RT / 2];
        lds_words<RT / 4>(w0, st + r0 * rstep + p * pstep + RT * tq);
        lds_words<RT / 4>(w1, st + (r0 + 8) * rstep + p * pstep + RT * tq);
        const int pg = pb * g.NP + p;
        lds_frag<GW>(xa, xs + pg * slab, NB, nx, tq);
        if constexpr (PACKED) lds_frag<GW>(xb, xs + (pg + g.nper) * slab, NB, nx, tq);
        float d0[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};
        period_mma<FAM, GW>(d0, d1, w0, w1, s0r, s1r, m0, m1, xa, xb, dc);
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k] += d0[k] + d1[k];
      }
      // the slot (and a scale region loaded here) is free once every lane's
      // values have fed its mma: a shared load still in flight must not
      // meet the next TMA copy
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(bars + 8 * (ns + slot));
        if (scale_region >= 0) mbar_arrive(sfree + 8 * scale_region);
      }
      if (++slot == ns) slot = 0, par ^= 1;
    }

    // ---- y + (bias + res), or the split's partial ----
    const int row0 = tile * TR;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int n = 2 * tq + (k & 1), row = row0 + r0 + 8 * (k >> 1);
      if (n >= nbo || row >= a.ncols) continue;  // a ragged last tile's rows
      const int orow = a.ids != nullptr ? z : n;
      const float bt = a.bias ? (a.fb ? cb[k] : a.off * cb[k]) : 0.f;
      if (a.ks == 1) {
        const float r =
            (a.res != nullptr && row < a.n_res) ? a.res[(size_t)orow * a.n_res + row] : 0.f;
        a.out[(size_t)orow * a.ncols + row] = valid ? acc[k] + (bt + r) : nan;
      } else {
        a.ws[((size_t)split * rows + orow) * a.ncols + row] = valid ? acc[k] + bt : nan;
      }
    }
    if (a.ks == 1) continue;
    __threadfence();
    consumers_sync();
    int* counter = a.counters + z * a.ntiles + tile;
    if (tid == 0) *flag = atomicAdd(counter, 1) == a.ks - 1;
    consumers_sync();
    if (*flag) {
      __threadfence();  // the other splits' partials are visible past this
      for (int e = tid; e < nbo * TR; e += NCT) {
        const int n = e / TR, row = row0 + e % TR, orow = a.ids != nullptr ? z : n;
        if (row >= a.ncols) continue;
        float v = 0.f;
        for (int q = 0; q < a.ks; ++q)
          v += __ldcg(a.ws + ((size_t)q * rows + orow) * a.ncols + row);
        if (a.res != nullptr && row < a.n_res) v += a.res[(size_t)orow * a.n_res + row];
        a.out[(size_t)orow * a.ncols + row] = v;
      }
      if (tid == 0) *counter = 0;  // ready for the next call
    }
    consumers_sync();  // the flag is read before the next tile writes it
  }
}

template <int FAM, int GW>
int il_launch(const IlArgs& a, const IlMaps& m, dim3 grid, int smem, cudaStream_t s) {
  static bool attr_set = false;
  auto kern = il_gemv_kernel<FAM, GW>;
  if (!attr_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  kern<<<grid, NTH, smem, s>>>(a, m);
  return (int)cudaGetLastError();
}

template <int FAM>
int il_launch_gw(const IlArgs& a, const IlMaps& m, dim3 grid, int smem, cudaStream_t s) {
  switch (a.g.GW) {
    case 128: return il_launch<FAM, 128>(a, m, grid, smem, s);
    case 64: return il_launch<FAM, 64>(a, m, grid, smem, s);
    case 32: return il_launch<FAM, 32>(a, m, grid, smem, s);
    default: return il_launch<FAM, 16>(a, m, grid, smem, s);
  }
}

// Checks the plan (ks splits, ns ring stages, nbx blocks along the tiles),
// makes the tensor maps of planes of rows_w rows and launches nbx x ks x
// rows_z blocks over a.ntiles tiles.
int il_run(IlArgs& a, int nibble, const void* fq, const void* fs, const void* fb, int rows_w,
           int nbx, int rows_z, cudaStream_t s) {
  if (a.ks < 1 || a.ks > a.g.nst || a.ns < 1 || a.ns > 32 || nbx < 1 || nbx > a.ntiles ||
      (a.ks > 1 && (a.ws == nullptr || a.counters == nullptr)) || fq == nullptr || fs == nullptr)
    return (int)cudaErrorInvalidValue;
  a.sb = a.g.fsb * (a.fb ? 2 : 1);
  a.arb = 0;  // residue blocks the widest split touches
  for (int y = 0; y < a.ks; ++y) {
    const int s0 = (int)((long long)y * a.g.nst / a.ks);
    const int s1 = (int)((long long)(y + 1) * a.g.nst / a.ks);
    const int t = (s1 - 1) / a.g.spr - s0 / a.g.spr + 1;
    a.arb = t > a.arb ? t : a.arb;
  }
  const IlLayout L = il_layout(a.g, a.sb, a.ns, a.arb, a.gs, a.NB, a.bias);
  if (L.total > SMEM_MAX) return (int)cudaErrorInvalidValue;
  IlMaps m;
  a.fq = (const unsigned char*)fq;
  a.rows_w = rows_w;
  // pp: no weight map, the producer warp copies the weights
  bool ok = a.g.pp || encode_map_3d(&m.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, fq, a.G, a.g.nper,
                                    rows_w, a.G, (long long)a.G * a.g.nper, a.g.GW, a.g.NP, TR);
  if (a.g.pp) m.w = CUtensorMap{};  // unused
  ok = ok && encode_map_2d(&m.fs, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, fs, a.G, rows_w,
                           (long long)a.G * 2, a.g.GW, TR, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (fb != nullptr)
    ok = ok && encode_map_2d(&m.fb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, fb, a.G, rows_w,
                             (long long)a.G * 2, a.g.GW, TR, CU_TENSOR_MAP_SWIZZLE_NONE);
  else
    m.fb = m.fs;  // unused
  if (!ok) return (int)cudaErrorInvalidValue;
  const dim3 grid(nbx, a.ks, rows_z);
  if (a.cm == CM_TERN) return il_launch_gw<FAM_TERN>(a, m, grid, L.total, s);
  if (a.cm != CM_NONE) return il_launch_gw<FAM_CODED>(a, m, grid, L.total, s);
  if (nibble) return il_launch_gw<FAM_NIB>(a, m, grid, L.total, s);
  return il_launch_gw<FAM_BYTE>(a, m, grid, L.total, s);
}

}  // namespace

extern "C" {

const char* ght_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// K6 at B <= 8, one launch.  mode: 0 plain (x bf16 [B, K] in natural column
// order), 1 normed (the same x; wn f32 [K] interleaved, eps), 2 act (x bf16
// [B, 2K], gate ++ up, both interleaved), 3 plain with x interleaved
// already.  nibble: fq uint8 [n2, K/2] packed, else int8 [n2, K]; cm: the
// code map of coded packed planes (0: none); fs bf16 [n2, G]; the bias: fb
// bf16 [n2, G], or off * fs (fb null, off != 0), or none; xg_mode 1 takes
// the group sums xg_in f32 [B, G] (pre-norm in the normed mode), 2 takes
// them from the activation, 0 when there is no bias; res f32 [B, n_res] or
// null.  The normed mode's mean of x^2 divides by kn (K, or the true K of
// planes whose groups the wrapper padded to a multiple of 8, x padded with
// zeros).  The plan (kernels.pick_il_gemv): ks splits of the stages (ws f32
// [ks, B, n2] when ks > 1), ns ring stages, nbx blocks along the tiles of
// 64 rows (the last one ragged); counters int32, one a tile, zero (each
// call leaves them so).
// out f32 [B, n2].
int fast_il_run(int mode, int nibble, int cm, const void* x, int B, int K, const void* fq,
                const void* fs, const void* fb, int n2, int G, float off, const float* xg_in,
                int xg_mode, const float* wn, float eps, int kn, const float* res, int n_res,
                int ks, int ns, int nbx, float* ws, int* counters, float* out, void* stream) {
  const bool bias = fb != nullptr || off != 0.f;
  IlArgs a{};
  if (B < 1 || B > 8 || n2 < 1 || mode < MODE_PLAIN || mode > MODE_PRE_IL ||
      (mode == MODE_NORMED && wn == nullptr) || n_res > n2 || x == nullptr ||
      out == nullptr || bad_planes(nibble, cm, K, G, bias, xg_mode, xg_in) ||
      kn < 1 || kn > K || !il_geo(&a.g, K, G, nibble != 0))
    return (int)cudaErrorInvalidValue;
  a.x = (const uint16_t*)x;
  a.wn = wn;
  a.kn = kn;
  a.xg_in = xg_in;
  a.res = res;
  a.out = out;
  a.ws = ws;
  a.counters = counters;
  a.mode = mode;
  a.NB = B;
  a.K = K;
  a.G = G;
  a.gs = K / G;
  a.xstride = mode == MODE_ACT ? 2 * K : K;
  a.xg_mode = xg_mode;
  a.n_res = res != nullptr ? n_res : 0;
  a.ncols = n2;
  a.ntiles = (n2 + TR - 1) / TR;
  a.ks = ks;
  a.ns = ns;
  a.fb = fb != nullptr;
  a.bias = bias;
  a.cm = cm;
  a.off = off;
  a.eps = eps;
  return il_run(a, nibble, fq, fs, fb, n2, nbx, 1, (cudaStream_t)stream);
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

// K8, one launch.  x bf16 [P, K] in natural column order; ids int32 [P] on
// the card; stacked interleaved planes of n_exp*npe rows (family, code map,
// bias as in fast_il_run); xg_in f32 [P, G] the group sums of x where the
// planes carry a bias; the plan as in fast_il_run (ws f32 [ks, P, npe],
// counters one a tile of an expert's rows and input row); out f32 [P, npe].
int fast_indirect_run(const void* x, int P, int K, const int* ids, int npe, int n_exp,
                      const void* fq, const void* fs, const void* fb, int G, int nibble, int cm,
                      float off, const float* xg_in, int ks, int ns, int nbx, float* ws,
                      int* counters, float* out, void* stream) {
  const bool bias = fb != nullptr || off != 0.f;
  IlArgs a{};
  if (P < 1 || P > 65535 || npe < 1 || n_exp < 1 || x == nullptr ||
      ids == nullptr || out == nullptr ||
      bad_planes(nibble, cm, K, G, bias, bias ? 1 : 0, xg_in) ||
      !il_geo(&a.g, K, G, nibble != 0))
    return (int)cudaErrorInvalidValue;
  a.x = (const uint16_t*)x;
  a.xg_in = xg_in;
  a.out = out;
  a.ws = ws;
  a.counters = counters;
  a.ids = ids;
  a.mode = MODE_PLAIN;
  a.NB = 1;
  a.K = K;
  a.G = G;
  a.gs = K / G;
  a.xstride = K;
  a.xg_mode = bias ? 1 : 0;
  a.ncols = npe;
  a.ntiles = (npe + TR - 1) / TR;
  a.ks = ks;
  a.ns = ns;
  a.fb = fb != nullptr;
  a.bias = bias;
  a.cm = cm;
  a.off = off;
  a.npe = npe;
  a.n_exp = n_exp;
  return il_run(a, nibble, fq, fs, fb, n_exp * npe, nbx, P, (cudaStream_t)stream);
}

}  // extern "C"
