// Device decode of the coded i-quant and ternary planes, shared by
// qp8_gemv.cu (K1, K2, K5), qp8_gemm.cu (K3), fast_il_gemm.cu (K6 above 8
// rows), ffn_fused.cu (K9) and fast_il.cu (K6 at B <= 8, K7, K8): decode4
// (one prmt a word, then a conditional negate) and the byte-permute
// Decoder (the alphabet and its negation as two prmt tables, the sign as a
// blend; K1/K2/K5 and K6/K8).
//
// Replaces ggml_hexagon_tpu/ops/qmm_qp8.py `_decode_cm` (:262, with its
// `_SHIFT_LUTS` :259) and ggml_hexagon_tpu/ops/qmm_fast.py `decode_codes`
// (:62), which the TPU kernels apply to every unpacked code before the dot.
//
// A code is a magnitude index c into the type's alphabet and a sign bit:
//   iq2    {0, 8, 25, 43}                  (IQ2_XXS, IQ2_XS, IQ2_S)
//   iq3xxs {4, 12, 20, 28, 36, 44, 52, 62} (IQ3_XXS)
//   iq3s   {1, 3, 5, ..., 15}              (IQ3_S)
//   iq1    {0, 1, 7, 9}                    (IQ1_S, IQ1_M)
//   tern   value + 1, no sign bit          (TQ1_0, TQ2_0)
// The t-planes' 2+1 layouts (iq2, iq1) carry c in bits 0-1 and the sign in
// bit 2; every other layout (the t-planes' 4+0 iq3 codes and all coded
// nibbles of the interleaved planes) carries c in bits 0-2 and the sign in
// bit 3.
//
// decode4 turns four codes, one a byte, into four signed int8 values in one
// word: the alphabet is a table of eight bytes in two registers, and one
// byte permute (prmt) looks the four magnitudes up at once; the sign is a
// per-byte conditional negate, (m ^ s) - s with s = 0x00 or 0xff.  Codes
// past an alphabet of four read its last entry, as the TPU's arithmetic
// decode does.
#pragma once
#include <stdint.h>

// code-map ids (kernels.CODE_MAPS)
constexpr int CM_NONE = 0, CM_IQ2 = 1, CM_IQ3XXS = 2, CM_IQ3S = 3, CM_IQ1 = 4,
              CM_TERN = 5;

// The alphabet of code map cm (not ternary) as eight bytes in two words,
// bytes 0-3 and 4-7; a caller may look it up once, outside its loop.
struct CodeAlphabet {
  uint32_t lo, hi;
};

__device__ __forceinline__ CodeAlphabet code_alphabet(int cm) {
  switch (cm) {
    case CM_IQ2: return {0x2B190800u, 0x2B2B2B2Bu};
    case CM_IQ3XXS: return {0x1C140C04u, 0x3E342C24u};
    case CM_IQ3S: return {0x07050301u, 0x0F0D0B09u};
    default: return {0x09070100u, 0x09090909u};  // iq1
  }
}

// decode4 with the alphabet given (tern: the ternary map, which has none).
__device__ __forceinline__ uint32_t decode4_with(uint32_t v, CodeAlphabet al, bool tern,
                                                 int sbit) {
  if (tern) return __vsub4(v, 0x01010101u);
  const uint32_t c = v & (sbit == 2 ? 0x03030303u : 0x07070707u);
  // one 3-bit selector a byte, packed into the low 16 bits of the selector
  const uint32_t sel = (c & 0x7u) | ((c >> 4) & 0x70u) | ((c >> 8) & 0x700u) |
                       ((c >> 12) & 0x7000u);
  const uint32_t mag = __byte_perm(al.lo, al.hi, sel);
  const uint32_t s = ((v >> sbit) & 0x01010101u) * 0xffu;
  return __vsub4(mag ^ s, s);
}

// v: four codes, one in each byte; sbit: the sign bit's position in a code
// (2 for the t-planes' 2+1 layouts, 3 otherwise).  Returns four int8 values.
__device__ __forceinline__ uint32_t decode4(uint32_t v, int cm, int sbit) {
  return decode4_with(v, code_alphabet(cm), cm == CM_TERN, sbit);
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t s) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(s));
  return r;
}

// The coded planes' decode, four codes a word: the magnitude index (bits
// 0-2, or 0-1 in the 2+1 layouts) picks a byte of the alphabet and of its
// negation (two byte permutes of tables set up once a block), the sign bit
// (3, or 2) blends the two; ternary is value + 1.  The same values as
// `decode4_with`, in about half its instructions (no __vsub4).  With a zero
// point z the tables hold z + a and z - a, so a code decodes to z + value
// (as a byte, modulo 256; qp8_gemv.cu takes z = 0, fast_il.cu z = 64).
struct Decoder {
  uint32_t plo, phi, nlo, nhi, cmask;
  int sup;   // shift that brings the sign bit to a byte's top bit
};

__device__ __forceinline__ Decoder decoder_of(int cm, int sbit, uint32_t zero = 0u) {
  Decoder d;
  const CodeAlphabet al = code_alphabet(cm);
  d.plo = d.phi = d.nlo = d.nhi = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = (al.lo >> (8 * i)) & 0xffu, hi = (al.hi >> (8 * i)) & 0xffu;
    d.plo |= ((zero + lo) & 0xffu) << (8 * i);
    d.phi |= ((zero + hi) & 0xffu) << (8 * i);
    d.nlo |= ((zero - lo) & 0xffu) << (8 * i);
    d.nhi |= ((zero - hi) & 0xffu) << (8 * i);
  }
  d.cmask = sbit == 2 ? 0x03030303u : 0x07070707u;
  d.sup = 7 - sbit;
  return d;
}

template <bool TERN>
__device__ __forceinline__ uint32_t decode(uint32_t v, const Decoder& d) {
  if constexpr (TERN) return (v + 0x7f7f7f7fu) ^ 0x80808080u;  // bytes 0..2 -> -1..1
  const uint32_t c = v & d.cmask;
  const uint32_t sel = prmt(c | (c >> 4), 0u, 0x4420u);  // four 3-bit indices
  const uint32_t pos = prmt(d.plo, d.phi, sel), neg = prmt(d.nlo, d.nhi, sel);
  const uint32_t m = prmt(v << d.sup, 0u, 0xba98u);  // 0xff where negative
  return (pos & ~m) | (neg & m);
}

// The eight 4-bit codes of a raw word (each byte: one group's code in its
// low nibble, the other's in its high one), decoded into two words of four
// bytes, [b0 lo, b0 hi, b1 lo, b1 hi] and the same for bytes 2 and 3.  The
// nibbles are the selectors themselves: a nibble's sign bit is prmt's
// sign-replicate flag, so the positive lookup reads the alphabet where the
// sign is clear, the negative one (signs flipped) its negation where it is
// set, and the byte msbs that carry the signs (raw's and raw << 4's) give
// the blend mask.
__device__ __forceinline__ void decode_nibbles(uint32_t raw, const Decoder& d, uint32_t& lo,
                                               uint32_t& hi) {
  const uint32_t x = raw ^ 0x88888888u, s4 = raw << 4;
  const uint32_t pl = prmt(d.plo, d.phi, raw), nl = prmt(d.nlo, d.nhi, x);
  const uint32_t ph = prmt(d.plo, d.phi, raw >> 16), nh = prmt(d.nlo, d.nhi, x >> 16);
  const uint32_t ml = prmt(raw, s4, 0x9d8cu), mh = prmt(raw, s4, 0xbfaeu);  // 0xff: negative
  lo = (pl & ~ml) | (nl & ml);
  hi = (ph & ~mh) | (nh & mh);
}
