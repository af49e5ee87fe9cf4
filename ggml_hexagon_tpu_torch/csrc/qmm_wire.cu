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
// Design (a simple, right first version; wgmma/TMA and a split K for
// small grids wait for later work):
//  * One block per 64 weight rows x 64 activation rows, 8 warps.  K is
//    walked in steps of 64 logical columns.  A step reads JT = 64/per
//    consecutive bytes of each row's low plane (per = 8/bits_lo values a
//    byte) and so takes the columns j0..j0+JT of each of the plane's `per`
//    row-planar parts: byte b holds column b in its lowest bits and column
//    b + K/per * s at shift bits_lo * s.  Every low-plane byte is read
//    once; the high plane (its own period K/per_hi) and the scales are
//    read per group run through L1.
//  * Each thread dequantizes 16 columns of one row in f32 with the TPU
//    kernel's roundings (scale = d * sc, w = q * scale + bias, or
//    (q + offset) * scale; no fused multiply-add), picking each column's
//    group scale by index where the TPU expands groups with a one-hot dot
//    (exact either way), then rounds w to the compute type into shared
//    memory.  The x tile is rounded the same way; the dequantized weight
//    never exists in device memory.
//  * bf16: WMMA 16x16x16 with f32 accumulators, warp w owning output
//    columns 16*(w%4) and row fragments w/4 and w/4+2 (fragments past the
//    batch skipped).  f32: a 4x4 register tile a thread, f32 FMA.
//  * One template instance per plane family (low/high bits, signed, LUT,
//    super-block, asymmetry), chosen at compile time: a run-time branch in
//    the inner loop cost K1/K3/K5 30-75%.  The rows run as given (the TPU
//    entry pads B to 8 for its sublane tile).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

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

}  // extern "C"
