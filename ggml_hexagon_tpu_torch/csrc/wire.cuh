// The wire planes of K10 (ggml_hexagon_tpu/ops/qmatmul.py `_qmm_kernel`)
// as both of its kernels read them: qmm_wire.cu (the GEMV at B <= 8) and
// qmm_wire_gemm.cu (the GEMM above 8 rows).
//
// A low-plane row of Kp = K/per bytes (per = 8/bl values a byte) holds
// column b + s*Kp in byte b at shift bl*s; a high-plane row of Kph =
// K*bh/8 bytes holds column c's high bits in byte c % Kph at shift
// bh*(c / Kph).  So high byte h serves the R = Kp/Kph low bytes h + r*Kph
// at every shift, and a run of consecutive high positions h0.. with one
// (s, r) is a run of consecutive columns s*Kp + r*Kph + h0...  The scales
// come as a record a run: super-block types d (and dmin), then the scw
// words of sc (and of m) covering the run's n groups; other types n words
// of d (and of m, min types); n = 1 where a group outgrows the run.
//
// The contract both kernels hold: the weight dequantized in f32 with the
// TPU kernel's roundings (scale = d * sc; w = q * scale + bias, or (q +
// off) * scale; no fused multiply-add; the IQ4 types take their table's
// values), then rounded to the compute type (bf16, or kept in f32).
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

#include "codes.cuh"
#include "hopper.cuh"

namespace {

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

// The twelve plane families of the C entries (kernels._WIRE_FAMILIES):
// bits low, bits high, signed, LUT, super-block, asymmetry
constexpr int WIRE_FAMS[12][6] = {
    {8, 0, 1, 0, 0, A_NONE}, {4, 0, 0, 1, 0, A_NONE}, {4, 0, 0, 1, 1, A_NONE},
    {4, 0, 0, 0, 0, A_NONE}, {4, 0, 0, 0, 0, A_MIN},  {4, 1, 0, 0, 0, A_NONE},
    {4, 1, 0, 0, 0, A_MIN},  {2, 0, 0, 0, 1, A_MINSB}, {2, 1, 0, 0, 1, A_NONE},
    {4, 0, 0, 0, 1, A_MINSB}, {4, 1, 0, 0, 1, A_MINSB}, {4, 2, 0, 0, 1, A_NONE}};

// A run's record: its group count n (HW columns, groups of gs), the sc
// words scw and the record's words nrec.
__host__ __device__ inline void wire_record(int HW, int gs, bool sup, int asym, int* n, int* scw,
                                            int* nrec) {
  *n = HW >= gs ? HW / gs : 1;
  const int two = 1 + (asym != A_NONE);
  if (sup) {
    *scw = (*n + 3) / 4 + 1;
    *nrec = (asym == A_MINSB ? 2 : 1) + *scw * two;
  } else {
    *scw = 0;
    *nrec = *n * two;
  }
}

// The producer's copies of one row's record of the run whose first column
// is cs into dst (4-byte cp.async: the planes' row pitches, 4-344 bytes,
// are no TMA pitch).
template <bool SUPER, int ASYM>
__device__ __forceinline__ void copy_record(const Planes& P, size_t row, int cs, int n, int scw,
                                            uint32_t dst) {
  const int K = P.K, lgs = P.gs_shift;
  const int g0 = cs >> lgs;
  if constexpr (SUPER) {
    const size_t db = row * (K >> 8) + (cs >> 8);
    cp_async4(dst, P.d + db);
    if constexpr (ASYM == A_MINSB) cp_async4(dst + 4, P.dmin + db);
    constexpr int OSC = ASYM == A_MINSB ? 8 : 4;
    const int w0 = g0 >> 2, w1 = (g0 + n - 1) >> 2;
    const uint32_t* scw_ = reinterpret_cast<const uint32_t*>(P.sc + row * (size_t)(K >> lgs));
    for (int w = w0; w <= w1; ++w) cp_async4(dst + OSC + 4 * (w - w0), scw_ + w);
    if constexpr (ASYM == A_MINSB) {
      const uint32_t* mw = reinterpret_cast<const uint32_t*>(P.m8 + row * (size_t)(K >> lgs));
      for (int w = w0; w <= w1; ++w) cp_async4(dst + OSC + 4 * (scw + w - w0), mw + w);
    }
  } else {
    const size_t gb = row * (size_t)(K >> lgs) + g0;
    for (int e = 0; e < n; ++e) {
      cp_async4(dst + 4 * e, P.d + gb + e);
      if constexpr (ASYM == A_MIN) cp_async4(dst + 4 * (n + e), P.mf + gb + e);
    }
  }
}

// The scale (and bias) of a row's 16-column unit hu of the run (HW columns
// from cs) whose record is rec.
template <bool SUPER, int ASYM>
__device__ __forceinline__ void scale_of(const uint32_t* rec, int HW, int n, int scw, int cs,
                                         int hu, int lgs, float& scale, float& bias) {
  const int gl = HW >= (1 << lgs) ? (16 * hu) >> lgs : 0;
  if constexpr (SUPER) {
    constexpr int OSC = ASYM == A_MINSB ? 2 : 1;
    const int bi = ((cs >> lgs) & 3) + gl;
    const int sc = reinterpret_cast<const int8_t*>(rec + OSC)[bi];
    scale = __fmul_rn(__uint_as_float(rec[0]), (float)sc);
    if constexpr (ASYM == A_MINSB) {
      const int m = reinterpret_cast<const uint8_t*>(rec + OSC + scw)[bi];
      bias = __fmul_rn(-__uint_as_float(rec[1]), (float)m);
    }
  } else {
    scale = __uint_as_float(rec[gl]);
    if constexpr (ASYM == A_MIN) bias = __uint_as_float(rec[n + gl]);
  }
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

// The four weights of one 4-byte word of a row (its low bytes L at bit
// shift ls, the high bits H at hs), dequantized in f32 as the TPU kernel
// does (q + off, then times the scale; or q times the scale, plus the bias;
// no fused multiply-add).  Each code becomes the f32 2^23 + u (u its byte,
// biased by 128 for signed bytes and the IQ4 table) by one prmt under
// 0x4b; qoff takes the 2^23 (and the 128) off again, and adds off,
// exactly.
template <int BL, int BH, bool SIGNED, bool LUT, int ASYM>
__device__ __forceinline__ void decode4(uint32_t L, uint32_t H, int ls, int hs, float scale,
                                        float bias, float qoff, float (&w)[4]) {
  constexpr uint32_t LM = ((1u << BL) - 1) * 0x01010101u;
  constexpr uint32_t HM = BH ? ((1u << BH) - 1) * 0x01010101u : 0u;
  uint32_t v;
  if constexpr (SIGNED) {
    v = L ^ 0x80808080u;
  } else {
    v = (L >> ls) & LM;
    if constexpr (BH != 0) v |= ((H >> hs) & HM) << BL;
    if constexpr (LUT) v = lut4(v);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float q = __fadd_rn(__uint_as_float(prmt(v, 0x4b00u, 0x5440u + e)), qoff);
    if constexpr (ASYM == A_NONE) {
      w[e] = __fmul_rn(q, scale);
    } else {
      w[e] = __fadd_rn(__fmul_rn(q, scale), bias);
    }
  }
}

// qoff of decode4: off - 2^23 - beta (symmetric types), or -2^23 - beta.
template <bool SIGNED, bool LUT, int ASYM>
__device__ __forceinline__ float wire_qoff(float off) {
  constexpr float BETA = (SIGNED || LUT) ? 128.f : 0.f;
  return ASYM == A_NONE ? __fsub_rn(off, 8388608.f + BETA) : -(8388608.f + BETA);
}

}  // namespace
