// K3: qp8 prefill GEMM (B > 8) over transposed qp8 planes, for sm_90a.
//
// Replaces ggml_hexagon_tpu/ops/qmm_qp8.py `_tpf_kernel`, launched through
// `pallas_call` in `_qp8_call(decode=False)`.
//
// What bounds it: operations at the main path's 512-token chunks
// (2*M*K*N bf16 flops against 4.5-6.5 bits per weight: ~1000 flops per
// weight byte at M=512, past the card's bf16 ridge of ~295); bytes at
// the 16- and 32-token buckets.
//
// Design (a simple, right first version; wgmma/TMA wait for later work):
//  * 128x128 output tiles, 8 warps of 64x32, bf16 WMMA 16x16x16 with f32
//    accumulators, K walked in steps of 32.
//  * Each step decodes a 32x128 weight tile from fq straight into shared
//    memory: unpack, multiply by the group scale, and round w*scale to
//    bf16, exactly as the TPU kernel does before its bf16 dot.  The
//    dequantized weight never exists in device memory.
//  * The affine bias (group sums of x times fb, or off*fs) is one f32
//    [M,G]x[G,N] product in the TPU kernel; here the group sums come from a
//    small pre-pass and each thread adds its columns' bias in f32 in the
//    epilogue, from shared-memory tiles of the sums.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 128, BN = 128, BK = 32, NT = 256;
constexpr int LDA = BK + 8;    // bf16 elements
constexpr int LDB = BN + 8;    // bf16 elements
constexpr int LDC = BN + 4;    // floats
constexpr int GCH = 32;        // groups per bias chunk
constexpr int SMEM_TILES = BM * LDA * 2 + BK * LDB * 2;
constexpr int SMEM_C = BM * LDC * 4;
constexpr int SMEM_BYTES = (SMEM_TILES > SMEM_C ? SMEM_TILES : SMEM_C) + BM * GCH * 4;

__device__ __forceinline__ float bf2f(uint16_t v) {
  return __uint_as_float(((uint32_t)v) << 16);
}

// xg[m, g] = sum of the gs bf16 values of x row m in group g (f32).
__global__ void group_sums_kernel(const uint16_t* __restrict__ x, int M, int K,
                                  int gs, float* __restrict__ xg) {
  const int G = K / gs;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= M * G) return;
  const int m = e / G, g = e % G;
  const uint16_t* p = x + (size_t)m * K + (size_t)g * gs;
  float s = 0.f;
  for (int i = 0; i < gs; ++i) s += bf2f(p[i]);
  xg[e] = s;
}

__global__ void __launch_bounds__(NT) qp8_gemm_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ fq,
    const uint16_t* __restrict__ fs, const uint16_t* __restrict__ fb, int n2,
    int bl, int bh, int gs, float off, int M, int K,
    const float* __restrict__ xg, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + BM * LDA;
  float* Cs = reinterpret_cast<float*>(smem);  // aliases the tiles after the K loop
  float* Xg = reinterpret_cast<float*>(smem + (SMEM_TILES > SMEM_C ? SMEM_TILES : SMEM_C));

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int rows_lo = K * bl / 8;
  const int rows_hi = K * bh / 8;
  const uint32_t mlo = ((1u << bl) - 1u) * 0x01010101u;
  const uint32_t mhi = ((1u << bh) - 1u) * 0x01010101u;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // A-tile load slot: row ar, 16 columns at ah*16
  const int ar = tid >> 1, ah = tid & 1;
  // B-tile decode slot: rows 4*rq..4*rq+3, columns 4*cq..4*cq+3
  const int cq = tid & 31, rq = tid >> 5;
  const int nB = n0 + cq * 4;

  for (int k0 = 0; k0 < K; k0 += BK) {
    {
      uint4 v0 = make_uint4(0, 0, 0, 0), v1 = make_uint4(0, 0, 0, 0);
      if (m0 + ar < M) {
        const uint4* src = reinterpret_cast<const uint4*>(x + (size_t)(m0 + ar) * K + k0 + ah * 16);
        v0 = src[0];
        v1 = src[1];
      }
      uint4* dstp = reinterpret_cast<uint4*>(As + ar * LDA + ah * 16);
      dstp[0] = v0;
      dstp[1] = v1;
    }
    {
      const int s_lo = k0 / rows_lo;
      const int lo_shift = bl * s_lo;
      const int lo_base = k0 - s_lo * rows_lo;
      int hi_shift = 0, hi_base = 0;
      if (bh) {
        const int s_hi = k0 / rows_hi;
        hi_shift = bh * s_hi;
        hi_base = rows_lo + k0 - s_hi * rows_hi;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rq * 4 + i;
        const uint32_t w = __ldg(reinterpret_cast<const unsigned int*>(fq + (size_t)(lo_base + r) * n2 + nB));
        uint32_t v = (w >> lo_shift) & mlo;
        if (bh) {
          const uint32_t h = __ldg(reinterpret_cast<const unsigned int*>(fq + (size_t)(hi_base + r) * n2 + nB));
          v |= ((h >> hi_shift) & mhi) << bl;
        }
        const int g = (k0 + r) / gs;
        const uint2 sraw = __ldg(reinterpret_cast<const uint2*>(fs + (size_t)g * n2 + nB));
        const float sc[4] = {bf2f(sraw.x & 0xffff), bf2f(sraw.x >> 16),
                             bf2f(sraw.y & 0xffff), bf2f(sraw.y >> 16)};
        uint32_t wb[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          wb[c] = __bfloat16_as_ushort(
              __float2bfloat16_rn((float)((v >> (8 * c)) & 0xffu) * sc[c]));
        *reinterpret_cast<uint2*>(Bs + r * LDB + cq * 4) =
            make_uint2(wb[0] | (wb[1] << 16), wb[2] | (wb[3] << 16));
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 64 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * LDB + wn * 32 + j * 16, LDB);
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

  if (fb != nullptr || off != 0.f) {
    const int G = K / gs;
    const int col = tid & (BN - 1), rh = tid >> 7;  // rows rh*64 .. rh*64+63
    float bsum[64];
#pragma unroll
    for (int r = 0; r < 64; ++r) bsum[r] = 0.f;
    for (int g0 = 0; g0 < G; g0 += GCH) {
      for (int e = tid; e < BM * GCH; e += NT) {
        const int r = e / GCH, gg = e % GCH;
        float v = 0.f;
        if (m0 + r < M && g0 + gg < G) v = xg[(size_t)(m0 + r) * G + g0 + gg];
        Xg[e] = v;
      }
      __syncthreads();
      float fbv[GCH];
#pragma unroll
      for (int gg = 0; gg < GCH; ++gg) {
        float f = 0.f;
        if (g0 + gg < G) {
          const size_t idx = (size_t)(g0 + gg) * n2 + n0 + col;
          f = fb != nullptr ? bf2f(fb[idx]) : off * bf2f(fs[idx]);
        }
        fbv[gg] = f;
      }
#pragma unroll
      for (int r = 0; r < 64; ++r) {
        const float* xr = Xg + (rh * 64 + r) * GCH;
        float s = bsum[r];
#pragma unroll
        for (int gg = 0; gg < GCH; ++gg) s += xr[gg] * fbv[gg];
        bsum[r] = s;
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 64; ++r) Cs[(rh * 64 + r) * LDC + col] += bsum[r];
    __syncthreads();
  }

  for (int e = tid; e < BM * BN; e += NT) {
    const int r = e / BN, c = e % BN;
    if (m0 + r < M) out[(size_t)(m0 + r) * n2 + n0 + c] = Cs[r * LDC + c];
  }
}

}  // namespace

extern "C" {

const char* ght_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// x bf16 [M, K]; fq/fs/fb t-planes of width n2; xg scratch f32 [M, K/gs]
// (written here when a bias applies); out f32 [M, n2].
int qp8_gemm_run(const void* x, const void* fq, const void* fs, const void* fb,
                 int n2, int bl, int bh, int gs, float off, int M, int K,
                 float* xg, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (K % BK || n2 % BN || (K * bl / 8) % BK || (bh && (K * bh / 8) % BK))
    return (int)cudaErrorInvalidValue;
  const bool bias = fb != nullptr || off != 0.f;
  if (bias) {
    const int total = M * (K / gs);
    group_sums_kernel<<<(total + 255) / 256, 256, 0, s>>>((const uint16_t*)x, M, K, gs, xg);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(qp8_gemm_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid(n2 / BN, (M + BM - 1) / BM);
  qp8_gemm_kernel<<<grid, NT, SMEM_BYTES, s>>>(
      (const __nv_bfloat16*)x, (const uint8_t*)fq, (const uint16_t*)fs,
      (const uint16_t*)fb, n2, bl, bh, gs, off, M, K, xg, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
