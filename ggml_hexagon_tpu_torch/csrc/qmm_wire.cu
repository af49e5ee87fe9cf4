// K10: whole-K dequant x matmul over the wire planes of any QConfig, for
// sm_90a.
//
// Replaces ggml_hexagon_tpu/ops/qmatmul.py `_qmm_kernel`, launched through
// `pallas_call` in `_qmatmul_pallas` (entry `qmatmul_pallas`).
//
// What bounds it: bytes at the decode widths (B <= 8: the wire planes are
// read once, ~2 flops a weight byte per row), operations at B = 512
// (2*B*N*K bf16 flops against 2.4-8.5 bits a weight).
//
// The contract, both kernels: the weight dequantized in f32 with the TPU
// kernel's roundings (scale = d * sc, w = q * scale + bias, or (q +
// offset) * scale; no fused multiply-add; the IQ4 types take their table's
// values), rounded to the compute type (bf16, or f32), x rounded the same
// way, the products summed in f32.  The dequantized weight never exists in
// device memory.  One template instance per plane family (low/high bits,
// signed, LUT, super-block, asymmetry), chosen at compile time: a run-time
// branch in the inner loop cost K1/K3/K5 30-75%.
//
// B <= 8 in bf16 (wire_gemv_kernel, one launch a call): a streaming,
// split-K GEMV.
//  * Weight rows are the M of bf16 mma.sync m16n8k16 (swap-AB), 64 a tile;
//    the <= 8 activation rows are its N (columns past B repeat the last
//    row and are dropped).  Eight consumer warps: four row groups of 16,
//    each split into two halves that take alternate (unit, shift) items
//    and add their sums at the tile's end.
//  * The planes stream through a ring of stages by TMA from a producer
//    warp with an evict-first L2 policy.  A stage is HW consecutive
//    positions of the high plane (128, 64 or 32 dividing its row) and the
//    R low-plane boxes that share those high bytes (R = 4 for Q5_0, Q5_1,
//    Q5_K; 2 for Q6_K, Q3_K; 1 without a high plane), so each high byte is
//    fetched once with the low bytes it pairs with.  The scale planes' row
//    pitches are no TMA pitch (d of K = 11008 is 172 bytes, sc at gs = 32
//    344), so the producer's 32 lanes copy each stage's scale words with
//    4-byte cp.async into the same ring slot, arriving on its mbarrier.
//  * A thread decodes 16 weights of each of its two rows from one 16-byte
//    word of the stage at one shift: each code (with its high bits, or its
//    IQ4 value by a byte permute) becomes the f32 2^23 + code by one prmt,
//    then the exact subtraction, the scale and the bias in f32, one
//    rounding to bf16; the mma's k index maps the thread's 16 columns, and
//    the activation fragment is the same 16 columns, 32 contiguous bytes.
//  * Each block builds its K split's activation once, as bf16 in the
//    planes' run order, in shared memory; blocks are persistent (every
//    nbx-th tile of one split).  Splits are whole stages; the last block of
//    a split tile sums the splits' partials in split order (an int32
//    counter a tile, reset by that block): deterministic, no float atomics.
//    kernels.pick_wire_gemv sizes splits, ring and blocks to the SM count.
//
// Above 8 rows, and in f32 (qmm_wire_kernel): one block per 64 weight rows
// x 64 activation rows, 8 warps, K walked in steps of 64 columns: a thread
// dequantizes 16 columns of one row into shared memory, x is rounded the
// same way; bf16: WMMA 16x16x16 with f32 accumulators; f32: a 4x4 register
// tile a thread, f32 FMA.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include "codes.cuh"
#include "hopper.cuh"

using namespace nvcuda;

namespace {

constexpr int BN = 64;        // weight rows (outputs) a block
constexpr int BB = 64;        // activation rows a block
constexpr int KC = 64;        // logical columns a step
constexpr int NT = 256;
constexpr int LDH = KC + 8;   // bf16 tile pitch (elements)
constexpr int LDF = KC + 1;   // f32 tile pitch
constexpr int LDO = BN + 4;   // f32 output tile pitch

__constant__ float c_iq4nl[16] = {-127.f, -104.f, -83.f, -65.f, -49.f, -35.f,
                                  -22.f,  -10.f,  1.f,   13.f,  25.f,  38.f,
                                  53.f,   69.f,   89.f,  113.f};

enum Asym { A_NONE = 0, A_MIN = 1, A_MINSB = 2 };

struct Planes {
  const uint8_t* q;     // [n_pad, K*BL/8] (int8 [n_pad, K] when signed)
  const uint8_t* qh;    // [n_pad, K*BH/8]
  const float* d;       // [n_pad, K/256] (super-block) or [n_pad, K/gs]
  const int8_t* sc;     // [n_pad, K/gs]
  const float* dmin;    // [n_pad, K/256]
  const uint8_t* m8;    // minsb: [n_pad, K/gs]
  const float* mf;      // min:   [n_pad, K/gs]
  int K, gs_shift;
  float off;            // symmetric zero offset
};

// Dequantize this thread's 16 columns of row `row` for the step at low-plane
// byte j0 into w (tile-column order s*JT + qq*NB + t).
template <int BL, int BH, bool SIGNED, bool LUT, bool SUPER, int ASYM>
__device__ __forceinline__ void dequant16(const Planes& P, int row, int j0,
                                          int qq, float (&w)[16]) {
  constexpr int PER = 8 / BL;
  constexpr int JT = KC / PER;      // low-plane bytes a row a step
  constexpr int NB = JT / 4;        // of which this thread's
  constexpr int MASK = (1 << BL) - 1;
  const int K = P.K;
  const int Kp = K / PER;           // low-plane row pitch (bytes)
  const int G = K >> P.gs_shift;
  const uint32_t* src =
      reinterpret_cast<const uint32_t*>(P.q + (size_t)row * Kp + j0 + qq * NB);
  uint32_t words[NB / 4];
#pragma unroll
  for (int i = 0; i < NB / 4; ++i) words[i] = __ldg(src + i);
#pragma unroll
  for (int s = 0; s < PER; ++s) {
    const int cb = s * Kp + j0 + qq * NB;   // first column of the run
    const int g = cb >> P.gs_shift;
    float scale;
    if constexpr (SUPER) {
      scale = __fmul_rn(__ldg(P.d + (size_t)row * (K >> 8) + (cb >> 8)),
                        (float)__ldg(P.sc + (size_t)row * G + g));
    } else {
      scale = __ldg(P.d + (size_t)row * G + g);
    }
    float bias = 0.f;
    if constexpr (ASYM == A_MINSB) {
      bias = __fmul_rn(-__ldg(P.dmin + (size_t)row * (K >> 8) + (cb >> 8)),
                       (float)__ldg(P.m8 + (size_t)row * G + g));
    } else if constexpr (ASYM == A_MIN) {
      bias = __ldg(P.mf + (size_t)row * G + g);
    }
#pragma unroll
    for (int t = 0; t < NB; ++t) {
      const uint32_t byte = (words[t >> 2] >> (8 * (t & 3))) & 0xffu;
      float qf;
      if constexpr (SIGNED) {
        qf = (float)(int8_t)byte;
      } else {
        int v = (int)(byte >> (BL * s)) & MASK;
        if constexpr (BH != 0) {
          const int Kph = K * BH / 8;     // high-plane row pitch (bytes)
          const int c = cb + t;
          const int hb = __ldg(P.qh + (size_t)row * Kph + (c % Kph));
          v += ((hb >> (BH * (c / Kph))) & ((1 << BH) - 1)) << BL;
        }
        qf = LUT ? c_iq4nl[v] : (float)v;
      }
      float wv;
      if constexpr (ASYM == A_NONE) {
        wv = __fmul_rn(__fadd_rn(qf, P.off), scale);
      } else {
        wv = __fadd_rn(__fmul_rn(qf, scale), bias);
      }
      w[s * NB + t] = wv;
    }
  }
}

template <int BL, int BH, bool SIGNED, bool LUT, bool SUPER, int ASYM, bool F32>
__global__ void __launch_bounds__(NT) qmm_wire_kernel(
    const float* __restrict__ x, int B, Planes P, int n_pad,
    float* __restrict__ out) {
  constexpr int PER = 8 / BL;
  constexpr int JT = KC / PER;
  constexpr int NB = JT / 4;
  const int K = P.K;
  const int Kp = K / PER;
  const int n0 = blockIdx.x * BN, b0 = blockIdx.y * BB;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int rows = min(BB, B - b0);
  const int drow = tid >> 2, qq = tid & 3;   // dequant: a row, a quarter

  if constexpr (!F32) {
    __shared__ __align__(32) __nv_bfloat16 xs[BB * LDH];
    __shared__ __align__(32) __nv_bfloat16 ws[BN * LDH];
    __shared__ __align__(32) float os[BB * LDO];
    const int nf = warp & 3, mf0 = warp >> 2;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
    wmma::fill_fragment(acc[0], 0.f);
    wmma::fill_fragment(acc[1], 0.f);
    for (int j0 = 0; j0 < Kp; j0 += JT) {
      float w[16];
      dequant16<BL, BH, SIGNED, LUT, SUPER, ASYM>(P, n0 + drow, j0, qq, w);
#pragma unroll
      for (int s = 0; s < PER; ++s)
#pragma unroll
        for (int t = 0; t < NB; ++t)
          ws[drow * LDH + s * JT + qq * NB + t] = __float2bfloat16_rn(w[s * NB + t]);
#pragma unroll 4
      for (int e = tid; e < BB * KC; e += NT) {
        const int r = e / KC, i = e % KC;
        const int c = (i / JT) * Kp + j0 + (i % JT);
        const float xv = r < rows ? __ldg(x + (size_t)(b0 + r) * K + c) : 0.f;
        xs[r * LDH + i] = __float2bfloat16_rn(xv);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bf;
        wmma::load_matrix_sync(bf, ws + nf * 16 * LDH + kk, LDH);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int mf = mf0 + 2 * u;
          if (mf * 16 < rows) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
            wmma::load_matrix_sync(af, xs + mf * 16 * LDH + kk, LDH);
            wmma::mma_sync(acc[u], af, bf, acc[u]);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int mf = mf0 + 2 * u;
      wmma::store_matrix_sync(os + mf * 16 * LDO + nf * 16, acc[u], LDO,
                              wmma::mem_row_major);
    }
    __syncthreads();
    for (int e = tid; e < rows * BN; e += NT) {
      const int r = e / BN, n = e % BN;
      out[(size_t)(b0 + r) * n_pad + n0 + n] = os[r * LDO + n];
    }
  } else {
    __shared__ float xs[BB * LDF];
    __shared__ float ws[BN * LDF];
    const int tb = tid >> 4, tn = tid & 15;   // 4x4 outputs a thread
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
    for (int j0 = 0; j0 < Kp; j0 += JT) {
      float w[16];
      dequant16<BL, BH, SIGNED, LUT, SUPER, ASYM>(P, n0 + drow, j0, qq, w);
#pragma unroll
      for (int s = 0; s < PER; ++s)
#pragma unroll
        for (int t = 0; t < NB; ++t)
          ws[drow * LDF + s * JT + qq * NB + t] = w[s * NB + t];
#pragma unroll 4
      for (int e = tid; e < BB * KC; e += NT) {
        const int r = e / KC, i = e % KC;
        const int c = (i / JT) * Kp + j0 + (i % JT);
        xs[r * LDF + i] = r < rows ? __ldg(x + (size_t)(b0 + r) * K + c) : 0.f;
      }
      __syncthreads();
      if (tb * 4 < rows) {
#pragma unroll 8
        for (int i = 0; i < KC; ++i) {
          float av[4], bv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) av[a] = xs[(tb * 4 + a) * LDF + i];
#pragma unroll
          for (int c = 0; c < 4; ++c) bv[c] = ws[(tn * 4 + c) * LDF + i];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(av[a], bv[c], acc[a][c]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = tb * 4 + a;
      if (r < rows) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          out[(size_t)(b0 + r) * n_pad + n0 + tn * 4 + c] = acc[a][c];
      }
    }
  }
}

// ============================================================================
// B <= 8, bf16 compute: wire_gemv_kernel
// ============================================================================

constexpr int GV_NCW = 8;           // consumer warps: 4 row groups, two halves each
constexpr int GV_NCT = GV_NCW * 32;
constexpr int GV_NTH = GV_NCT + 32;  // and one producer warp
constexpr int GV_TR = 64;            // weight rows a tile
constexpr int GV_MAXB = 8;           // activation rows (the mma's N)
constexpr int SMEM_MAX = 232448;     // shared memory a block may take

// How the GEMV walks a family's planes (kernels.wire_geo mirrors it).  A
// low-plane row of Kp = K/per bytes holds column b + s*Kp of byte b at
// shift bl*s; a high-plane row of Kph = K*bh/8 bytes holds column c's high
// bits in byte c % Kph at shift bh*(c / Kph).  So high byte h serves the R
// = Kp/Kph low bytes h + r*Kph (r < R) at every shift: a stage takes HW
// consecutive high positions h0.. (128, 64 or 32, dividing Kph) as R low
// boxes of HW x 64 rows (at r*Kph + h0) and one high box (at h0), and with
// them every column they hold: per*R runs (s, r) of HW columns, the run's
// first column s*Kp + r*Kph + h0.  Families without a high plane take Kph
// = Kp, R = 1.  nst stages a tile; a K split takes whole stages, so it
// holds whole high bytes.  Each run's scales come as a record of nrec
// words: super-block types d (and dmin), then the words of sc (and m)
// covering its n = HW/gs groups (scw words); other types n words of d (and
// of m, min types), n = 1 where a group outgrows the run (gs = 256).  sb:
// the bytes of a ring slot (the boxes and 64 rows x per*R records).
struct WireGeo {
  int per, Kp, Kph, R, HW, lhw, nst, n, scw, nrec, box, sb;
};

__host__ __device__ inline int ilog2i(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

__host__ __device__ inline void wire_geo(WireGeo* g, int bl, int bh, bool sup, int asym, int K,
                                         int gs) {
  g->per = 8 / bl;
  g->Kp = K / g->per;
  g->Kph = bh ? K * bh / 8 : g->Kp;
  g->R = g->Kp / g->Kph;
  g->HW = g->Kph % 128 == 0 ? 128 : g->Kph % 64 == 0 ? 64 : 32;
  g->lhw = ilog2i(g->HW);
  g->nst = g->Kph / g->HW;
  g->n = g->HW >= gs ? g->HW / gs : 1;
  const int two = 1 + (asym != A_NONE);
  if (sup) {
    g->scw = (g->n + 3) / 4 + 1;
    g->nrec = (asym == A_MINSB ? 2 : 1) + g->scw * two;
  } else {
    g->scw = 0;
    g->nrec = g->n * two;
  }
  g->box = GV_TR * g->HW;
  g->sb = align128((g->R + (bh > 0)) * g->box + GV_TR * g->per * g->R * g->nrec * 4);
}

// The block's shared memory: ns ring slots, then the split's bf16
// activation (nb rows of per*R runs of lmax columns, pitch 16 more than a multiple of 128
// bytes: a quarter-warp's 16-byte loads of two rows meet no bank twice),
// the second halves' partial sums, the last-block flag and the mbarriers
// full[ns], empty[ns].
struct WireLayout {
  int act, pitch, red, flag, bars, total;
};

__host__ __device__ inline WireLayout wire_layout(const WireGeo& g, int ns, int lmax, int nb) {
  WireLayout l;
  l.act = ns * g.sb;
  l.pitch = align128(g.per * g.R * lmax * 2) + 16;
  l.red = l.act + align128(nb * l.pitch);
  l.flag = l.red + 4 * 32 * 4 * 4;
  l.bars = align128(l.flag + 16);
  l.total = l.bars + 8 * 2 * ns;
  return l;
}

struct WireArgs {
  const float* x;  // f32 [NB, K]
  Planes P;
  float* out;      // f32 [NB, n_pad]
  float* ws;       // f32 [ks, NB, n_pad] (ks > 1)
  int* counters;   // one a tile, zero between calls
  WireGeo g;
  int NB, n_pad, ntiles, ks, ns, lmax;
};

struct WireMaps {
  CUtensorMap lo, hi;
};

__device__ __forceinline__ void gv_consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(GV_NCT) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The IQ4 table plus 128, as bytes (prmt tables): 1, 24, ..., 241.
constexpr uint32_t IQ4T0 = 0x3f2d1801u, IQ4T1 = 0x766a5d4fu;
constexpr uint32_t IQ4T2 = 0xa6998d81u, IQ4T3 = 0xf1d9c5b5u;

// Four 4-bit codes (a byte each) -> their IQ4 values plus 128.
__device__ __forceinline__ uint32_t lut4(uint32_t v) {
  const uint32_t y = v | (v >> 4);  // bytes 0 and 2: two codes each
  const uint32_t sel = ((y & 0xffu) | ((y >> 8) & 0xff00u)) & 0x7777u;
  const uint32_t lo = prmt(IQ4T0, IQ4T1, sel), hi = prmt(IQ4T2, IQ4T3, sel);
  const uint32_t m = ((v >> 3) & 0x01010101u) * 0xffu;  // codes 8-15
  return (hi & m) | (lo & ~m);
}

// The 16 weights of one row's 16-byte unit at shift s (the high bits at
// hs), dequantized in f32 as the TPU kernel does (q + off, then times the
// scale; or q times the scale, plus the bias; no fused multiply-add) and
// rounded to bf16: A[2i], A[2i + 1] the pairs (4i, 4i + 1), (4i + 2, 4i + 3).
// Each code becomes the f32 2^23 + u (u its byte, biased by beta: 128 for
// signed bytes and the IQ4 table) by one prmt under 0x4b; qoff takes the
// 2^23 + beta off again (and adds off), exactly.
template <int BL, int BH, bool SIGNED, bool LUT, int ASYM>
__device__ __forceinline__ void decode16(const uint4& Lw, const uint4& Hw, int s, int hs,
                                         float scale, float bias, float qoff, uint32_t (&A)[8]) {
  constexpr uint32_t LM = ((1u << BL) - 1) * 0x01010101u;
  constexpr uint32_t HM = BH ? ((1u << BH) - 1) * 0x01010101u : 0u;
  const uint32_t Lv[4] = {Lw.x, Lw.y, Lw.z, Lw.w};
  const uint32_t Hv[4] = {Hw.x, Hw.y, Hw.z, Hw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t v;
    if constexpr (SIGNED) {
      v = Lv[i] ^ 0x80808080u;
    } else {
      v = (Lv[i] >> (BL * s)) & LM;
      if constexpr (BH != 0) v |= ((Hv[i] >> hs) & HM) << BL;
      if constexpr (LUT) v = lut4(v);
    }
    float w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float q = __fadd_rn(__uint_as_float(prmt(v, 0x4b00u, 0x5440u + e)), qoff);
      if constexpr (ASYM == A_NONE) {
        w[e] = __fmul_rn(q, scale);
      } else {
        w[e] = __fadd_rn(__fmul_rn(q, scale), bias);
      }
    }
    A[2 * i] = pack_bf16(w[0], w[1]);
    A[2 * i + 1] = pack_bf16(w[2], w[3]);
  }
}

// The scale (and bias) of a row's 16-column unit hu of the run whose first
// column is cs, from the run's record.
template <bool SUPER, int ASYM>
__device__ __forceinline__ void scale_of(const uint32_t* rec, const WireGeo& g, int cs, int hu,
                                         int lgs, float& scale, float& bias) {
  const int gl = g.HW >= (1 << lgs) ? (16 * hu) >> lgs : 0;
  if constexpr (SUPER) {
    constexpr int OSC = ASYM == A_MINSB ? 2 : 1;
    const int bi = ((cs >> lgs) & 3) + gl;
    const int sc = reinterpret_cast<const int8_t*>(rec + OSC)[bi];
    scale = __fmul_rn(__uint_as_float(rec[0]), (float)sc);
    if constexpr (ASYM == A_MINSB) {
      const int m = reinterpret_cast<const uint8_t*>(rec + OSC + g.scw)[bi];
      bias = __fmul_rn(-__uint_as_float(rec[1]), (float)m);
    }
  } else {
    scale = __uint_as_float(rec[gl]);
    if constexpr (ASYM == A_MIN) bias = __uint_as_float(rec[g.n + gl]);
  }
}

template <int BL, int BH, bool SIGNED, bool LUT, bool SUPER, int ASYM>
__global__ void __launch_bounds__(GV_NTH, 2)
    wire_gemv_kernel(const __grid_constant__ WireArgs a, const __grid_constant__ WireMaps maps) {
  constexpr int PER = 8 / BL;
  constexpr int HIGH = BH > 0;
  extern __shared__ __align__(128) unsigned char smem[];
  const WireGeo g = a.g;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ns = a.ns, split = blockIdx.y;
  const int K = a.P.K, lgs = a.P.gs_shift;
  // this split's stages [st0, st0 + nps) of every tile
  const int st0 = (int)((long long)split * g.nst / a.ks);
  const int nps = (int)((long long)(split + 1) * g.nst / a.ks) - st0;
  const int h_lo = st0 * g.HW;
  const int ntile = (a.ntiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const WireLayout L = wire_layout(g, ns, a.lmax, a.NB);
  const uint32_t base = smem_u32(smem);
  const uint32_t bars = base + L.bars;  // full[ns], empty[ns]
  const int nruns = PER * g.R;
  const int recoff = (g.R + HIGH) * g.box;  // a slot's records

  if (tid == 0) {
    for (int s = 0; s < ns; ++s) {
      mbar_init(bars + 8 * s, 33);              // the expected bytes and 32 lanes' copies
      mbar_init(bars + 8 * (ns + s), GV_NCW);  // every consumer warp's release
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == GV_NCW) {
    // ---- producer: lane 0 brings the boxes by TMA, every lane its rows'
    // scale records by 4-byte cp.async (their row pitches are no TMA
    // pitch), each lane's copies arriving on the stage's mbarrier ----
    const uint64_t pol = evict_first_policy();
    const int nst = ntile * nps;
    for (int i = 0, slot = 0, par = 0, ti = 0, j = 0; i < nst; ++i) {
      if (i >= ns) mbar_wait(bars + 8 * (ns + slot), par ^ 1);
      const int h0 = (st0 + j) * g.HW;
      const int wrow = ((int)blockIdx.x + ti * (int)gridDim.x) * GV_TR;
      const uint32_t full = bars + 8 * slot, sbase = base + slot * g.sb;
      if (lane == 0) {
        mbar_expect_tx(full, (g.R + HIGH) * g.box);
        for (int r = 0; r < g.R; ++r)
          tma_load_2d_ef(sbase + r * g.box, &maps.lo, r * g.Kph + h0, wrow, full, pol);
        if (HIGH) tma_load_2d_ef(sbase + g.R * g.box, &maps.hi, h0, wrow, full, pol);
      }
      for (int rr = lane; rr < GV_TR; rr += 32) {
        const size_t row = (size_t)(wrow + rr);
        for (int run = 0; run < nruns; ++run) {
          const int s = run / g.R, r = run - s * g.R;
          const int cs = s * g.Kp + r * g.Kph + h0;
          const uint32_t dst = sbase + recoff + (rr * nruns + run) * g.nrec * 4;
          const int g0 = cs >> lgs;
          if constexpr (SUPER) {
            const size_t db = row * (K >> 8) + (cs >> 8);
            cp_async4(dst, a.P.d + db);
            if constexpr (ASYM == A_MINSB) cp_async4(dst + 4, a.P.dmin + db);
            constexpr int OSC = ASYM == A_MINSB ? 8 : 4;
            const int w0 = g0 >> 2, w1 = (g0 + g.n - 1) >> 2;
            const uint32_t* scw =
                reinterpret_cast<const uint32_t*>(a.P.sc + row * (size_t)(K >> lgs));
            for (int w = w0; w <= w1; ++w) cp_async4(dst + OSC + 4 * (w - w0), scw + w);
            if constexpr (ASYM == A_MINSB) {
              const uint32_t* mw =
                  reinterpret_cast<const uint32_t*>(a.P.m8 + row * (size_t)(K >> lgs));
              for (int w = w0; w <= w1; ++w)
                cp_async4(dst + OSC + 4 * (g.scw + w - w0), mw + w);
            }
          } else {
            const size_t gb = row * (size_t)(K >> lgs) + g0;
            for (int e = 0; e < g.n; ++e) {
              cp_async4(dst + 4 * e, a.P.d + gb + e);
              if constexpr (ASYM == A_MIN) cp_async4(dst + 4 * (g.n + e), a.P.mf + gb + e);
            }
          }
        }
      }
      mbar_arrive_cp_async(full);
      if (++slot == ns) slot = 0, par ^= 1;
      if (++j == nps) j = 0, ++ti;
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // ---- the split's activation, bf16 in run order: run (s, r) holds columns
  // s*Kp + r*Kph + h for h in [h_lo, h_lo + nps*HW) ----
  unsigned char* act = smem + L.act;
  {
    const int q4 = nps * g.HW / 4, per_row = nruns * q4, nq = a.NB * per_row;
    constexpr int U = 8;  // loads in flight a thread
    for (int e0 = tid; e0 < nq; e0 += GV_NCT * U) {
      float4 v[U];
      int off[U];
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const int e = e0 + k * GV_NCT;
        off[k] = -1;
        if (e < nq) {
          const int n = e / per_row, rem = e - n * per_row, run = rem / q4, hq = rem - run * q4;
          const int s = run / g.R, r = run - s * g.R;
          const int col = s * g.Kp + r * g.Kph + h_lo + 4 * hq;
          v[k] = __ldg(reinterpret_cast<const float4*>(a.x + (size_t)n * K + col));
          off[k] = n * L.pitch + (run * a.lmax + 4 * hq) * 2;
        }
      }
#pragma unroll
      for (int k = 0; k < U; ++k)
        if (off[k] >= 0)
          *reinterpret_cast<uint2*>(act + off[k]) =
              make_uint2(pack_bf16(v[k].x, v[k].y), pack_bf16(v[k].z, v[k].w));
    }
  }
  gv_consumers_sync();

  // ---- the mma over the ring, tile after tile: warp w takes rows
  // 16*(w%4).. and the (unit, shift) items of parity w/4 ----
  const int gid = lane >> 2, tq = lane & 3;
  const int rg = warp & 3, half = warp >> 2;
  const int r0 = 16 * rg + gid, r1 = r0 + 8;
  const int nx = min(gid, a.NB - 1);  // columns past NB repeat the last row; dropped
  const int nhu = g.HW >> 4, lhu = g.lhw - 4;
  const int nitems = g.R * nhu / 4 * PER;  // (unit j, shift s) items of a thread
  constexpr float BETA = (SIGNED || LUT) ? 128.f : 0.f;
  const float qoff = ASYM == A_NONE ? __fsub_rn(a.P.off, 8388608.f + BETA) : -(8388608.f + BETA);
  float* red = reinterpret_cast<float*>(smem + L.red);
  int* flag = reinterpret_cast<int*>(smem + L.flag);
  int slot = 0, par = 0;
  for (int ti = 0; ti < ntile; ++ti) {
    const int tile = (int)blockIdx.x + ti * (int)gridDim.x;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int js = 0; js < nps; ++js) {
      const int h0 = (st0 + js) * g.HW;
      mbar_wait(bars + 8 * slot, par);
      const unsigned char* st = smem + slot * g.sb;
      const uint32_t* rec = reinterpret_cast<const uint32_t*>(st + recoff);
      // each stage's sums start from zero (the tensor cores truncate as they
      // align a long running sum) and join the f32 total
      float d0[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};
      for (int it = half; it < nitems; it += 2) {
        const int j = it / PER, s = it - j * PER;
        const int u = tq + 4 * j, r = u >> lhu, hu = u & (nhu - 1);
        const int run = s * g.R + r;
        const uint4 L0 = *reinterpret_cast<const uint4*>(st + r * g.box + r0 * g.HW + hu * 16);
        const uint4 L1 = *reinterpret_cast<const uint4*>(st + r * g.box + r1 * g.HW + hu * 16);
        uint4 H0 = make_uint4(0u, 0u, 0u, 0u), H1 = H0;
        if constexpr (HIGH) {
          H0 = *reinterpret_cast<const uint4*>(st + g.R * g.box + r0 * g.HW + hu * 16);
          H1 = *reinterpret_cast<const uint4*>(st + g.R * g.box + r1 * g.HW + hu * 16);
        }
        const int cs = s * g.Kp + r * g.Kph + h0;
        float sc0, sc1, b0 = 0.f, b1 = 0.f;
        scale_of<SUPER, ASYM>(rec + (r0 * nruns + run) * g.nrec, g, cs, hu, lgs, sc0, b0);
        scale_of<SUPER, ASYM>(rec + (r1 * nruns + run) * g.nrec, g, cs, hu, lgs, sc1, b1);
        uint32_t A0[8], A1[8];
        decode16<BL, BH, SIGNED, LUT, ASYM>(L0, H0, s, BH * run, sc0, b0, qoff, A0);
        decode16<BL, BH, SIGNED, LUT, ASYM>(L1, H1, s, BH * run, sc1, b1, qoff, A1);
        const uint4* xp = reinterpret_cast<const uint4*>(
            act + nx * L.pitch + (run * a.lmax + h0 - h_lo + 16 * hu) * 2);
        const uint4 X0 = xp[0], X1 = xp[1];
        mma16816(d0, A0[0], A1[0], A0[1], A1[1], X0.x, X0.y);
        mma16816(d1, A0[2], A1[2], A0[3], A1[3], X0.z, X0.w);
        mma16816(d0, A0[4], A1[4], A0[5], A1[5], X1.x, X1.y);
        mma16816(d1, A0[6], A1[6], A0[7], A1[7], X1.z, X1.w);
      }
      // the slot is free once every lane's values have fed its mma
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (ns + slot));
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[k] += d0[k] + d1[k];
      if (++slot == ns) slot = 0, par ^= 1;
    }

    // ---- the two halves' sums, then y or the split's partial ----
    if (half) {
#pragma unroll
      for (int k = 0; k < 4; ++k) red[(rg * 32 + lane) * 4 + k] = acc[k];
    }
    gv_consumers_sync();
    const int row0 = tile * GV_TR;
    if (!half) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int n = 2 * tq + (k & 1), row = row0 + r0 + 8 * (k >> 1);
        const float v = acc[k] + red[(rg * 32 + lane) * 4 + k];
        if (n >= a.NB) continue;
        if (a.ks == 1) a.out[(size_t)n * a.n_pad + row] = v;
        else a.ws[((size_t)split * a.NB + n) * a.n_pad + row] = v;
      }
    }
    if (a.ks > 1) {
      __threadfence();
      gv_consumers_sync();
      int* counter = a.counters + tile;
      if (tid == 0) *flag = atomicAdd(counter, 1) == a.ks - 1;
      gv_consumers_sync();
      if (*flag) {
        __threadfence();  // the other splits' partials are visible past this
        for (int e = tid; e < a.NB * GV_TR; e += GV_NCT) {
          const int n = e / GV_TR, row = row0 + e % GV_TR;
          float v = 0.f;
          for (int q = 0; q < a.ks; ++q)
            v += __ldcg(a.ws + ((size_t)q * a.NB + n) * a.n_pad + row);
          a.out[(size_t)n * a.n_pad + row] = v;
        }
        if (tid == 0) *counter = 0;  // ready for the next call
      }
    }
    gv_consumers_sync();  // red and the flag are read before the next tile writes them
  }
}

template <int BL, int BH, bool SIGNED, bool LUT, bool SUPER, int ASYM>
int gemv_launch(const WireArgs& a, const WireMaps& m, dim3 grid, int smem, cudaStream_t s) {
  static bool attr_set = false;
  auto kern = wire_gemv_kernel<BL, BH, SIGNED, LUT, SUPER, ASYM>;
  if (!attr_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  kern<<<grid, GV_NTH, smem, s>>>(a, m);
  return (int)cudaGetLastError();
}

template <int BL, int BH, bool SIGNED, bool LUT, bool SUPER, int ASYM>
cudaError_t launch(int f32, const float* x, int B, const Planes& P, int n_pad,
                   float* out, cudaStream_t s) {
  dim3 grid(n_pad / BN, (B + BB - 1) / BB);
  if (f32) {
    qmm_wire_kernel<BL, BH, SIGNED, LUT, SUPER, ASYM, true><<<grid, NT, 0, s>>>(
        x, B, P, n_pad, out);
  } else {
    qmm_wire_kernel<BL, BH, SIGNED, LUT, SUPER, ASYM, false><<<grid, NT, 0, s>>>(
        x, B, P, n_pad, out);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ght_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// x f32 [B, K] (rounded to bf16 in the kernel unless f32 != 0); the wire
// planes of one family (kernels._WIRE_FAMILIES): 0 signed int8 (Q8_0 and
// the expanded i-quants and ternary), 1 IQ4_NL, 2 IQ4_XS, 3 Q4_0, 4 Q4_1,
// 5 Q5_0, 6 Q5_1, 7 Q2_K, 8 Q3_K, 9 Q4_K, 10 Q5_K, 11 Q6_K; m is uint8
// (minsb) or f32 (min); out f32 [B, n_pad].
int qmm_wire_run(int fam, int f32, const float* x, int B, int K,
                 const void* q, const void* qh, const float* d,
                 const void* sc, const float* dmin, const void* m, int n_pad,
                 int gs, float off, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || K % 256 || n_pad % BN || (gs != 16 && gs != 32 && gs != 256))
    return (int)cudaErrorInvalidValue;
  Planes P{(const uint8_t*)q, (const uint8_t*)qh, d, (const int8_t*)sc, dmin,
           (const uint8_t*)m, (const float*)m, K, __builtin_ctz(gs), off};
  switch (fam) {
    case 0: return (int)launch<8, 0, true, false, false, A_NONE>(f32, x, B, P, n_pad, out, s);
    case 1: return (int)launch<4, 0, false, true, false, A_NONE>(f32, x, B, P, n_pad, out, s);
    case 2: return (int)launch<4, 0, false, true, true, A_NONE>(f32, x, B, P, n_pad, out, s);
    case 3: return (int)launch<4, 0, false, false, false, A_NONE>(f32, x, B, P, n_pad, out, s);
    case 4: return (int)launch<4, 0, false, false, false, A_MIN>(f32, x, B, P, n_pad, out, s);
    case 5: return (int)launch<4, 1, false, false, false, A_NONE>(f32, x, B, P, n_pad, out, s);
    case 6: return (int)launch<4, 1, false, false, false, A_MIN>(f32, x, B, P, n_pad, out, s);
    case 7: return (int)launch<2, 0, false, false, true, A_MINSB>(f32, x, B, P, n_pad, out, s);
    case 8: return (int)launch<2, 1, false, false, true, A_NONE>(f32, x, B, P, n_pad, out, s);
    case 9: return (int)launch<4, 0, false, false, true, A_MINSB>(f32, x, B, P, n_pad, out, s);
    case 10: return (int)launch<4, 1, false, false, true, A_MINSB>(f32, x, B, P, n_pad, out, s);
    case 11: return (int)launch<4, 2, false, false, true, A_NONE>(f32, x, B, P, n_pad, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K10 at B <= 8 in bf16: the arguments of qmm_wire_run (no f32 mode) and
// the plan of kernels.pick_wire_gemv: ks splits of the stages, ns ring
// slots, nbx persistent blocks along the tiles; ws f32 [ks, B, n_pad] (ks >
// 1) and the int32 tile counters (zero, left zero).
int qmm_wire_gemv_run(int fam, const float* x, int B, int K, const void* q, const void* qh,
                      const float* d, const void* sc, const float* dmin, const void* m,
                      int n_pad, int gs, float off, int ks, int ns, int nbx, float* ws,
                      int* counters, float* out, void* stream) {
  static const int fams[12][6] = {
      {8, 0, 1, 0, 0, A_NONE}, {4, 0, 0, 1, 0, A_NONE}, {4, 0, 0, 1, 1, A_NONE},
      {4, 0, 0, 0, 0, A_NONE}, {4, 0, 0, 0, 0, A_MIN},  {4, 1, 0, 0, 0, A_NONE},
      {4, 1, 0, 0, 0, A_MIN},  {2, 0, 0, 0, 1, A_MINSB}, {2, 1, 0, 0, 1, A_NONE},
      {4, 0, 0, 0, 1, A_MINSB}, {4, 1, 0, 0, 1, A_MINSB}, {4, 2, 0, 0, 1, A_NONE}};
  cudaStream_t s = (cudaStream_t)stream;
  if (fam < 0 || fam > 11 || B < 1 || B > GV_MAXB || K < 256 || K % 256 || n_pad < GV_TR ||
      n_pad % GV_TR || (gs != 16 && gs != 32 && gs != 256) || ns < 1 || ks < 1 || nbx < 1)
    return (int)cudaErrorInvalidValue;
  const int* f = fams[fam];
  WireArgs a{};
  wire_geo(&a.g, f[0], f[1], f[4] != 0, f[5], K, gs);
  if (ks > a.g.nst || (ks > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  a.x = x;
  a.P = Planes{(const uint8_t*)q, (const uint8_t*)qh, d, (const int8_t*)sc, dmin,
               (const uint8_t*)m, (const float*)m, K, __builtin_ctz(gs), off};
  a.out = out;
  a.ws = ws;
  a.counters = counters;
  a.NB = B;
  a.n_pad = n_pad;
  a.ntiles = n_pad / GV_TR;
  a.ks = ks;
  a.ns = ns;
  a.lmax = (a.g.nst + ks - 1) / ks * a.g.HW;
  const WireLayout L = wire_layout(a.g, ns, a.lmax, B);
  if (L.total > SMEM_MAX) return (int)cudaErrorInvalidValue;
  WireMaps maps{};
  if (!encode_map_2d(&maps.lo, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, a.g.Kp, n_pad, a.g.Kp, a.g.HW,
                     GV_TR, CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  if (f[1] && !encode_map_2d(&maps.hi, CU_TENSOR_MAP_DATA_TYPE_UINT8, qh, a.g.Kph, n_pad,
                             a.g.Kph, a.g.HW, GV_TR, CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(nbx < a.ntiles ? nbx : a.ntiles, ks);
  switch (fam) {
    case 0: return gemv_launch<8, 0, true, false, false, A_NONE>(a, maps, grid, L.total, s);
    case 1: return gemv_launch<4, 0, false, true, false, A_NONE>(a, maps, grid, L.total, s);
    case 2: return gemv_launch<4, 0, false, true, true, A_NONE>(a, maps, grid, L.total, s);
    case 3: return gemv_launch<4, 0, false, false, false, A_NONE>(a, maps, grid, L.total, s);
    case 4: return gemv_launch<4, 0, false, false, false, A_MIN>(a, maps, grid, L.total, s);
    case 5: return gemv_launch<4, 1, false, false, false, A_NONE>(a, maps, grid, L.total, s);
    case 6: return gemv_launch<4, 1, false, false, false, A_MIN>(a, maps, grid, L.total, s);
    case 7: return gemv_launch<2, 0, false, false, true, A_MINSB>(a, maps, grid, L.total, s);
    case 8: return gemv_launch<2, 1, false, false, true, A_NONE>(a, maps, grid, L.total, s);
    case 9: return gemv_launch<4, 0, false, false, true, A_MINSB>(a, maps, grid, L.total, s);
    case 10: return gemv_launch<4, 1, false, false, true, A_MINSB>(a, maps, grid, L.total, s);
    default: return gemv_launch<4, 2, false, false, true, A_NONE>(a, maps, grid, L.total, s);
  }
}


}  // extern "C"
