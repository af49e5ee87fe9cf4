// The interleaved-layout quantized GEMV of K6 at B <= 8, K7 and K8, for
// sm_90a: its geometry, shared-memory layout, arguments and device steps
// (the stage copy, the norm, the activation build, a period's mma), which
// fast_il.cu (K6, K8: il_gemv_kernel, one template instance a family and
// residue block width) and fast_dual.cu (K7: il_dual_kernel, the same
// block over two plane sets) build their kernels from.
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
// K6 at B <= 8, K7 and K8 (il_gemv_kernel): what bounds them is bytes (each
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
//  * Blocks are persistent: a block takes the tiles bx, bx + nbx, ...
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
//    residue block width, chosen once a launch (K6, K8) or a block (K7): no
//    family branch reaches the inner loop.
//  * K8 is the same kernel, one input row a grid.z index, its tiles' rows
//    starting at ids[p] * npe (read on the device, so the routing never
//    reaches the host); an id outside [0, E) gives a NaN row.
//  * K7 (fast_dual.cu) runs the same block over two parts, the plane sets
//    a and b of one activation, each with its own family, width, tensor
//    maps, norm weight, bias and plan, in one launch.  It keeps a copy of
//    the block's body, taking the part's arguments, first tile, tile
//    stride and split as given: K6 on nibble planes ran 8-12% slower when
//    its kernel called that one body with its block indices.
#pragma once
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "codes.cuh"
#include "hopper.cuh"

namespace {

// activation modes (the C entries' `mode`)
constexpr int MODE_PLAIN = 0, MODE_NORMED = 1, MODE_ACT = 2, MODE_PRE_IL = 3;

__device__ __forceinline__ uint16_t f2bf(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Whether (K, G), the family and the bias arguments of one plane set are
// refused (coded planes are packed and carry no bias).
bool bad_planes(int nib, int cm, int K, int G, bool bias, int xg_mode, const float* xg_in) {
  return K % (nib ? 64 : 32) || G < 1 || K % G || bias != (xg_mode != 0) ||
         cm < CM_NONE || cm > CM_TERN || (cm && (!nib || bias)) ||
         xg_mode < 0 || xg_mode > 2 || (xg_mode == 1 && xg_in == nullptr);
}

// ============================================================================
// K6 at B <= 8, K7 and K8: il_gemv_kernel and il_dual_kernel
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

bool il_geo(IlGeo* g, int K, int G, bool packed, int gw_max = 128) {
  // G % 8: the scales' row pitch is whole 16-byte units, as TMA needs, and
  // the activation's interleaved columns come 8 to a 16-byte load
  if (G < 8 || G % 8 || K % G) return false;
  const int gs = K / G;
  g->GW = G >= 128 ? 128 : G % 64 == 0 ? 64 : G % 32 == 0 ? 32 : 16;
  if (g->GW > gw_max) g->GW = gw_max;  // K7's common width, 128 or 16
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
  float* out;          // f32 [rows, ncols] (K7: rows of ldo, from the part's first column)
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

// The body a plane set takes: its family.
int il_family(int cm, int nibble) {
  return cm == CM_TERN ? FAM_TERN : cm != CM_NONE ? FAM_CODED : nibble ? FAM_NIB : FAM_BYTE;
}

// Checks a launch's (or a K7 part's) plan (a.ks splits, a.ns ring stages,
// nbx blocks along the tiles) and planes (rows_w rows), and fills its
// scale-region and activation sizes and tensor maps.  Returns its shared
// memory a block, or -1.
int il_part(IlArgs& a, IlMaps& m, const void* fq, const void* fs, const void* fb, int rows_w,
            int nbx) {
  if (a.ks < 1 || a.ks > a.g.nst || a.ns < 1 || a.ns > 32 || nbx < 1 || nbx > a.ntiles ||
      (a.ks > 1 && (a.ws == nullptr || a.counters == nullptr)) || fq == nullptr || fs == nullptr)
    return -1;
  a.sb = a.g.fsb * (a.fb ? 2 : 1);
  a.arb = 0;  // residue blocks the widest split touches
  for (int y = 0; y < a.ks; ++y) {
    const int s0 = (int)((long long)y * a.g.nst / a.ks);
    const int s1 = (int)((long long)(y + 1) * a.g.nst / a.ks);
    const int t = (s1 - 1) / a.g.spr - s0 / a.g.spr + 1;
    a.arb = t > a.arb ? t : a.arb;
  }
  const IlLayout L = il_layout(a.g, a.sb, a.ns, a.arb, a.gs, a.NB, a.bias);
  if (L.total > SMEM_MAX) return -1;
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
  return ok ? L.total : -1;
}

}  // namespace
