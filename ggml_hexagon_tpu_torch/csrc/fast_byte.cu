// K6 (byte planes) and K8: interleaved-layout quantized matmul and its
// gathered-expert GEMV, for sm_90a.
//
// K6 replaces ggml_hexagon_tpu/ops/qmm_fast.py `_byte_kernel` (with
// `_kernel_x`, `_byte_y` and `_epilogue`), launched through `pallas_call` in
// `_fast_call`, in all four of its modes: plain, normed (a fused RMSNorm),
// act (a fused silu(gate)*up over a doubled input) and res (a residual added
// last).  K8 replaces `kern` in `_indirect_call` (the same body on the rows
// of one expert, picked by a scalar-prefetched id).  Both serve the byte
// planes of the interleaved layout (Q8_0, and the IQ4 LUT types, whose values
// are stored as int8): fq int8 [n2, K] with column j holding the original
// column (j % G)*gs + j/G, fs bf16 [n2, G] group scales, no bias.
//
// What bounds them: bytes at decode (B <= 8 and K8: each int8 weight byte
// feeds B multiply-adds), operations at the 128- and 512-token prefill chunks
// (2*B operations a weight byte, past the card's bf16 ridge of ~295 from
// B=148).
//
// Numerics, the TPU kernel's contract (qmm_fast.py:342-387, 464-494, 768): x
// is rounded to bf16 and interleaved; normed: inv = 1/sqrt(mean(x^2) + eps)
// over the f32 of that bf16 x, then bf16((x*inv)*wn_il); act: the input is
// the bf16 gate ++ up, both halves already interleaved, and silu(g)*u is
// computed in f32 and rounded to bf16.  At B <= 8 (and in K8) each product is
// f32 x times the f32 weight q*scale, summed in f32; above 8 rows q*scale is
// rounded to bf16 and the bf16 x bf16 products are summed in f32.  res adds
// an f32 row [B, n_res] to the first n_res columns last.
//
// Design (a simple, right first version; wgmma/TMA wait for later work):
//  * A pre-pass writes the effective activation in the planes' interleaved
//    column order, x_il[b, r*G + g] = x[b, g*gs + r], so both operands walk
//    K alike: an elementwise interleave (plain, and K8), one block a row
//    that reduces sum(x^2) and then writes the normed row (normed), an
//    elementwise silu(g)*u (act: its input is interleaved already).  The
//    plain mode with a pre-interleaved input has no pre-pass: the kernel
//    reads x itself.  The TPU kernel took the interleave as an XLA op
//    before its call and the prologues inside its single K block.
//  * B <= 8: one warp a weight row, 16 int8 weights a lane a step (one
//    16-byte load); each weight's f32 q*scale meets the B activations in
//    f32 multiply-adds; a warp-shuffle sum ends the row.
//  * K8: the same warp-per-row body for one input row p; grid (row blocks
//    of one expert, P), and each block reads ids[p] from device memory, so
//    the top-k never reaches the host and only the selected experts' rows
//    are read.  An id outside [0, E) writes a NaN row.
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
constexpr int NORM_THREADS = 256;

// pre-pass modes (the C entry's `mode`)
constexpr int MODE_PLAIN = 0, MODE_NORMED = 1, MODE_ACT = 2, MODE_PRE_IL = 3;

__device__ __forceinline__ float bf2f(uint16_t v) {
  return __uint_as_float(((uint32_t)v) << 16);
}

__device__ __forceinline__ uint16_t f2bf(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
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

// one block a row: inv = 1/sqrt(mean(x^2) + eps), then
// x_il[b, j] = bf16((x[b, src(j)] * inv) * wn_il[j])
__global__ void __launch_bounds__(NORM_THREADS) normed_kernel(
    const uint16_t* __restrict__ x, const float* __restrict__ wn, int K, int G,
    float eps, uint16_t* __restrict__ xil) {
  __shared__ float red[NORM_THREADS / 32];
  __shared__ float bcast;
  const int b = blockIdx.x, t = threadIdx.x;
  const uint16_t* xr = x + (size_t)b * K;
  float ss = 0.f;
  for (int k = t; k < K; k += NORM_THREADS) {
    const float v = bf2f(xr[k]);
    ss += v * v;
  }
  ss = warp_sum(ss);
  if ((t & 31) == 0) red[t >> 5] = ss;
  __syncthreads();
  if (t == 0) {
    float s = 0.f;
    for (int w = 0; w < NORM_THREADS / 32; ++w) s += red[w];
    bcast = 1.f / sqrtf(s / (float)K + eps);
  }
  __syncthreads();
  const float inv = bcast;
  const int gs = K / G;
  for (int j = t; j < K; j += NORM_THREADS) {
    const float v = bf2f(xr[(size_t)(j % G) * gs + j / G]);
    xil[(size_t)b * K + j] = f2bf(v * inv * wn[j]);
  }
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

// One lane's share of NB row dots against weight row `wrow` (K int8
// values, scales `srow`); the caller sums the lanes.
template <int NB>
__device__ __forceinline__ void row_dots(const uint16_t* __restrict__ xil,
                                         const int8_t* __restrict__ wrow,
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
  for (int b = 0; b < NB; ++b) acc[b] = warp_sum(acc[b]);
}

template <int NB>
__global__ void __launch_bounds__(GEMV_WARPS * 32) fast_byte_gemv_kernel(
    const uint16_t* __restrict__ xil, const int8_t* __restrict__ fq,
    const uint16_t* __restrict__ fs, int n2, int K, int G,
    const float* __restrict__ res, int n_res, float* __restrict__ out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * GEMV_WARPS + warp;
  if (n >= n2) return;
  float acc[NB];
  row_dots<NB>(xil, fq + (size_t)n * K, fs + (size_t)n * G, K, G, lane, acc);
  if (lane == 0) {
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const float r = (res != nullptr && n < n_res) ? res[(size_t)b * n_res + n] : 0.f;
      out[(size_t)b * n2 + n] = acc[b] + r;
    }
  }
}

// K8: grid (ceil(npe / GEMV_WARPS), P); row p of xil against rows
// ids[p]*npe + r of the stacked planes -> out[p, r]
__global__ void __launch_bounds__(GEMV_WARPS * 32) fast_indirect_kernel(
    const uint16_t* __restrict__ xil, const int* __restrict__ ids, int npe,
    int n_exp, const int8_t* __restrict__ fq, const uint16_t* __restrict__ fs,
    int K, int G, float* __restrict__ out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * GEMV_WARPS + warp;
  const int p = blockIdx.y;
  if (r >= npe) return;
  const int e = __ldg(ids + p);
  if (e < 0 || e >= n_exp) {
    if (lane == 0) out[(size_t)p * npe + r] = __int_as_float(0x7fc00000);
    return;
  }
  const size_t row = (size_t)e * npe + r;
  float acc[1];
  row_dots<1>(xil + (size_t)p * K, fq + row * K, fs + row * G, K, G, lane, acc);
  if (lane == 0) out[(size_t)p * npe + r] = acc[0];
}

__global__ void __launch_bounds__(NT) fast_byte_gemm_kernel(
    const __nv_bfloat16* __restrict__ xil, const int8_t* __restrict__ fq,
    const uint16_t* __restrict__ fs, int n2, int K, int G, int M,
    const float* __restrict__ res, int n_res, float* __restrict__ out) {
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
        const uint32_t lo = f2bf(byte_f(ww[i >> 2], i & 3) * s0);
        const uint32_t hi = f2bf(byte_f(ww[(i + 1) >> 2], (i + 1) & 3) * s1);
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
    const int m = m0 + r, n = n0 + c;
    if (m < M) {
      const float rv = (res != nullptr && n < n_res) ? res[(size_t)m * n_res + n] : 0.f;
      out[(size_t)m * n2 + n] = Cs[r * LDC + c] + rv;
    }
  }
}

template <int NB>
void launch_gemv(const uint16_t* xil, const int8_t* fq, const uint16_t* fs,
                 int n2, int K, int G, const float* res, int n_res, float* out,
                 cudaStream_t s) {
  fast_byte_gemv_kernel<NB><<<(n2 + GEMV_WARPS - 1) / GEMV_WARPS, GEMV_WARPS * 32, 0, s>>>(
      xil, fq, fs, n2, K, G, res, n_res, out);
}

// The interleaved pre-pass of K8 and K6's plain mode.
cudaError_t launch_interleave(const void* x, int B, int K, int G, void* xil,
                              cudaStream_t s) {
  const size_t total = (size_t)B * K;
  interleave_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      (const uint16_t*)x, B, K, G, (uint16_t*)xil);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ght_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// K6.  mode: 0 plain (x bf16 [B, K] in natural column order), 1 normed (the
// same x; wn f32 [K] interleaved, eps), 2 act (x bf16 [B, 2K], gate ++ up,
// both interleaved), 3 plain with x interleaved already (no pre-pass, xil
// unused).  fq int8 [n2, K] and fs bf16 [n2, G] interleaved planes; res f32
// [B, n_res] or null; xil scratch bf16 [B, K]; out f32 [B, n2].
int fast_byte_run(int mode, const void* x, int B, int K, const void* fq,
                  const void* fs, int n2, int G, const float* wn, float eps,
                  const float* res, int n_res, void* xil, float* out,
                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || K % BK || K % G || n2 % BN || mode < MODE_PLAIN || mode > MODE_PRE_IL ||
      (mode == MODE_NORMED && wn == nullptr) || n_res > n2)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSuccess;
  const size_t total = (size_t)B * K;
  if (mode == MODE_PLAIN) {
    e = launch_interleave(x, B, K, G, xil, s);
  } else if (mode == MODE_NORMED) {
    normed_kernel<<<B, NORM_THREADS, 0, s>>>((const uint16_t*)x, wn, K, G, eps,
                                             (uint16_t*)xil);
    e = cudaGetLastError();
  } else if (mode == MODE_ACT) {
    act_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
        (const uint16_t*)x, B, K, (uint16_t*)xil);
    e = cudaGetLastError();
  } else {
    xil = const_cast<void*>(x);
  }
  if (e != cudaSuccess) return (int)e;
  const uint16_t* xi = (const uint16_t*)xil;
  const int8_t* q = (const int8_t*)fq;
  const uint16_t* sc = (const uint16_t*)fs;
  if (B <= 8) {
    switch (B) {
      case 1: launch_gemv<1>(xi, q, sc, n2, K, G, res, n_res, out, s); break;
      case 2: launch_gemv<2>(xi, q, sc, n2, K, G, res, n_res, out, s); break;
      case 3: launch_gemv<3>(xi, q, sc, n2, K, G, res, n_res, out, s); break;
      case 4: launch_gemv<4>(xi, q, sc, n2, K, G, res, n_res, out, s); break;
      case 5: launch_gemv<5>(xi, q, sc, n2, K, G, res, n_res, out, s); break;
      case 6: launch_gemv<6>(xi, q, sc, n2, K, G, res, n_res, out, s); break;
      case 7: launch_gemv<7>(xi, q, sc, n2, K, G, res, n_res, out, s); break;
      default: launch_gemv<8>(xi, q, sc, n2, K, G, res, n_res, out, s); break;
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
      (const __nv_bfloat16*)xil, q, sc, n2, K, G, B, res, n_res, out);
  return (int)cudaGetLastError();
}

// K8.  x bf16 [P, K] in natural column order; ids int32 [P] on the card;
// fq int8 [n_exp*npe, K] and fs bf16 [n_exp*npe, G] stacked interleaved
// planes; xil scratch bf16 [P, K]; out f32 [P, npe].
int fast_indirect_run(const void* x, int P, int K, const int* ids, int npe,
                      int n_exp, const void* fq, const void* fs, int G,
                      void* xil, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (P < 1 || K % BK || K % G || npe < 1 || n_exp < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = launch_interleave(x, P, K, G, xil, s);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((npe + GEMV_WARPS - 1) / GEMV_WARPS, P);
  fast_indirect_kernel<<<grid, GEMV_WARPS * 32, 0, s>>>(
      (const uint16_t*)xil, ids, npe, n_exp, (const int8_t*)fq,
      (const uint16_t*)fs, K, G, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
