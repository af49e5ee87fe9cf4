// K6 (byte planes): interleaved-layout quantized matmul, for sm_90a.
//
// Replaces ggml_hexagon_tpu/ops/qmm_fast.py `_byte_kernel` (with `_byte_y`),
// launched through `pallas_call` in `_fast_call`.  It serves the byte
// planes of the interleaved layout (Q8_0, and the IQ4 LUT types, whose
// values are stored as int8): fq int8 [n2, K] with column j holding the
// original column (j % G)*gs + j/G, fs bf16 [n2, G] group scales, no bias.
//
// What bounds it: bytes at decode (B <= 8: each int8 weight byte feeds B
// multiply-adds), operations at the 128- and 512-token prefill chunks (2*B
// operations a weight byte, past the card's bf16 ridge of ~295 from B=148).
//
// Numerics, the TPU kernel's contract (qmm_fast.py:464-494 and :768): x is
// rounded to bf16; at B <= 8 each product is f32 x times the f32 weight
// q*scale, summed in f32; above 8 rows q*scale is rounded to bf16 and the
// bf16 x bf16 products are summed in f32.
//
// Design (a simple, right first version; wgmma/TMA wait for later work):
//  * A pre-pass writes x in the planes' interleaved column order,
//    x_il[b, r*G + g] = x[b, g*gs + r], so both operands walk K alike.  The
//    TPU kernel took the same transpose as an XLA op before its call.
//  * B <= 8: one warp a weight row, 16 int8 weights a lane a step (one
//    16-byte load); each weight's f32 q*scale meets the B activations in
//    f32 multiply-adds; a warp-shuffle sum ends the row.
//  * B > 8: the tile scheme of K3 (csrc/qp8_gemm.cu): 128x128 output tiles,
//    8 warps of 64x32, bf16 WMMA 16x16x16 with f32 accumulators, K in steps
//    of 32; each step decodes the 128x32 weight tile into shared memory as
//    bf16(q*scale), k-contiguous, read as a column-major B operand.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 128, BN = 128, BK = 32, NT = 256;
constexpr int LDA = BK + 8;  // bf16 elements
constexpr int LDB = BK + 8;  // bf16 elements (B tile stored [BN][LDB])
constexpr int LDC = BN + 4;  // floats
constexpr int SMEM_TILES = BM * LDA * 2 + BN * LDB * 2;
constexpr int SMEM_C = BM * LDC * 4;
constexpr int SMEM_BYTES = SMEM_TILES > SMEM_C ? SMEM_TILES : SMEM_C;
constexpr int GEMV_WARPS = 8;

__device__ __forceinline__ float bf2f(uint16_t v) {
  return __uint_as_float(((uint32_t)v) << 16);
}

__device__ __forceinline__ float byte_f(uint32_t word, int c) {
  return (float)(int8_t)(uint8_t)(word >> (8 * c));
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

template <int NB>
__global__ void __launch_bounds__(GEMV_WARPS * 32) fast_byte_gemv_kernel(
    const uint16_t* __restrict__ xil, const int8_t* __restrict__ fq,
    const uint16_t* __restrict__ fs, int n2, int K, int G,
    float* __restrict__ out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * GEMV_WARPS + warp;
  if (n >= n2) return;
  const int8_t* wrow = fq + (size_t)n * K;
  const uint16_t* srow = fs + (size_t)n * G;
  float acc[NB];
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
      const uint4* xp = reinterpret_cast<const uint4*>(xil + (size_t)b * K + j0);
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
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const float v = warp_sum(acc[b]);
    if (lane == 0) out[(size_t)b * n2 + n] = v;
  }
}

__global__ void __launch_bounds__(NT) fast_byte_gemm_kernel(
    const __nv_bfloat16* __restrict__ xil, const int8_t* __restrict__ fq,
    const uint16_t* __restrict__ fs, int n2, int K, int G, int M,
    float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + BM * LDA;
  float* Cs = reinterpret_cast<float*>(smem);  // aliases the tiles after the K loop

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // load / decode slot: tile row tid/2, 16 k-columns at (tid%2)*16
  const int tr = tid >> 1, th = tid & 1;
  const int8_t* wrow = fq + (size_t)(n0 + tr) * K;
  const uint16_t* srow = fs + (size_t)(n0 + tr) * G;

  for (int k0 = 0; k0 < K; k0 += BK) {
    {
      uint4 v0 = make_uint4(0, 0, 0, 0), v1 = make_uint4(0, 0, 0, 0);
      if (m0 + tr < M) {
        const uint4* src = reinterpret_cast<const uint4*>(xil + (size_t)(m0 + tr) * K + k0 + th * 16);
        v0 = src[0];
        v1 = src[1];
      }
      uint4* dstp = reinterpret_cast<uint4*>(As + tr * LDA + th * 16);
      dstp[0] = v0;
      dstp[1] = v1;
    }
    {
      const int kb = k0 + th * 16;
      const uint4 wv = __ldg(reinterpret_cast<const uint4*>(wrow + kb));
      const uint32_t ww[4] = {wv.x, wv.y, wv.z, wv.w};
      uint32_t wb[8];
      int g = kb % G;
#pragma unroll
      for (int i = 0; i < 16; i += 2) {
        const float s0 = bf2f(__ldg(srow + g));
        if (++g == G) g = 0;
        const float s1 = bf2f(__ldg(srow + g));
        if (++g == G) g = 0;
        const uint32_t lo = __bfloat16_as_ushort(
            __float2bfloat16_rn(byte_f(ww[i >> 2], i & 3) * s0));
        const uint32_t hi = __bfloat16_as_ushort(
            __float2bfloat16_rn(byte_f(ww[(i + 1) >> 2], (i + 1) & 3) * s1));
        wb[i >> 1] = lo | (hi << 16);
      }
      uint4* dstp = reinterpret_cast<uint4*>(Bs + tr * LDB + th * 16);
      dstp[0] = make_uint4(wb[0], wb[1], wb[2], wb[3]);
      dstp[1] = make_uint4(wb[4], wb[5], wb[6], wb[7]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 64 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + (wn * 32 + j * 16) * LDB + kk, LDB);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 64 + i * 16) * LDC + wn * 32 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BM * BN; e += NT) {
    const int r = e / BN, c = e % BN;
    if (m0 + r < M) out[(size_t)(m0 + r) * n2 + n0 + c] = Cs[r * LDC + c];
  }
}

template <int NB>
void launch_gemv(const uint16_t* xil, const int8_t* fq, const uint16_t* fs,
                 int n2, int K, int G, float* out, cudaStream_t s) {
  fast_byte_gemv_kernel<NB><<<(n2 + GEMV_WARPS - 1) / GEMV_WARPS, GEMV_WARPS * 32, 0, s>>>(
      xil, fq, fs, n2, K, G, out);
}

}  // namespace

extern "C" {

const char* ght_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// x bf16 [B, K] in natural column order; fq int8 [n2, K] and fs bf16
// [n2, G] interleaved planes; xil scratch bf16 [B, K]; out f32 [B, n2].
int fast_byte_run(const void* x, int B, int K, const void* fq, const void* fs,
                  int n2, int G, void* xil, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || K % BK || K % G || n2 % BN) return (int)cudaErrorInvalidValue;
  const size_t total = (size_t)B * K;
  interleave_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      (const uint16_t*)x, B, K, G, (uint16_t*)xil);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const uint16_t* xi = (const uint16_t*)xil;
  const int8_t* q = (const int8_t*)fq;
  const uint16_t* sc = (const uint16_t*)fs;
  if (B <= 8) {
    switch (B) {
      case 1: launch_gemv<1>(xi, q, sc, n2, K, G, out, s); break;
      case 2: launch_gemv<2>(xi, q, sc, n2, K, G, out, s); break;
      case 3: launch_gemv<3>(xi, q, sc, n2, K, G, out, s); break;
      case 4: launch_gemv<4>(xi, q, sc, n2, K, G, out, s); break;
      case 5: launch_gemv<5>(xi, q, sc, n2, K, G, out, s); break;
      case 6: launch_gemv<6>(xi, q, sc, n2, K, G, out, s); break;
      case 7: launch_gemv<7>(xi, q, sc, n2, K, G, out, s); break;
      default: launch_gemv<8>(xi, q, sc, n2, K, G, out, s); break;
    }
    return (int)cudaGetLastError();
  }
  static bool attr_set = false;
  if (!attr_set) {
    e = cudaFuncSetAttribute(fast_byte_gemm_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid(n2 / BN, (B + BM - 1) / BM);
  fast_byte_gemm_kernel<<<grid, NT, SMEM_BYTES, s>>>(
      (const __nv_bfloat16*)xil, q, sc, n2, K, G, B, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
