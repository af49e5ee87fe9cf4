// K1 / K2 / K5: qp8 decode GEMV (B <= 8) over transposed qp8 planes, for
// sm_90a.
//
// Replaces ggml_hexagon_tpu/ops/qmm_qp8.py `_qp8_decode_kernel` (K1, with
// the helpers `_qp8_prologue`, `_qp8_expand`, `_qp8_body`),
// `_qp8_dual_kernel` (K2) and `_qp8_indirect_kernel` (K5, the MoE
// MUL_MAT_ID GEMV), launched through `pallas_call` in `_qp8_call`,
// `_qp8_dual_call` and `_qp8_indirect_call`.
//
// What bounds it: bytes.  A decode GEMV reads every weight byte once
// (4.5 bits/weight for Q4_K, 6.5 for Q6_K with the bf16 scale planes) and
// does 2 int8 ops per weight, so at B <= 8 it sits two orders of magnitude
// below the card's int8 ridge point: the floor is the plane bytes over the
// memory rate.
//
// Design:
//  * A pre-pass (one block per batch row) computes the effective
//    activation (raw, RMSNorm*wn, or silu(gate)*up) and quantizes it to
//    int8 per 256-lane segment.  On the TPU this ran once at grid step 0
//    into scratch that later grid steps read; blocks of a CUDA grid run in
//    no order, so it is its own launch here.
//  * Threads own 4 adjacent output columns: the t-layout is contiguous
//    along n, so a warp reads one 128-byte line per plane row.  Four rows
//    give a 4x4 byte block that a byte-permute transposes into 4 packed
//    int8 x 4 weights, one per column, for __dp4a against the activation.
//  * The 8 warps of a block split K between them (and grid.y splits it
//    further when the plane is too narrow to fill the card); the partial
//    sums meet in shared memory and, across blocks, in a small finalize
//    pass that also adds the residual.
//  * Group scales are applied to the exact integer group partials, in the
//    order of the plain version: acc += P * (fs * xs) + fb * (s8 * xs).
//  * K5 is the same GEMV body, one input row per grid.z index, whose
//    lanes start at ids[p] * npe: the block reads the expert id from
//    device memory, so the routing never reaches the host and only the
//    selected experts' lanes stream from memory.  (The TPU kernel read the
//    ids by scalar prefetch and broadcast x to an 8-row tile; neither is
//    carried over.)  Planes are addressed with a row pitch `ld` apart from
//    the lane count, so an expert's lane slice of stacked planes needs no
//    copy.
//  * Coded planes (the i-quants and ternary: 2+1, 4+0 or 2+0 bits of
//    arithmetic codes) are decoded where the packed bytes are built, four
//    codes at a time (codes.cuh `decode4`), into signed int8 values; the
//    products reach 127 * 62 * 32 per group at most, well inside int32.
//    They carry no bias or offset.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "codes.cuh"

#define SEG 256
#define WARPS 8
#define COLS 128  // output columns per block (32 lanes x 4)

namespace {

__device__ __forceinline__ float bf2f(uint16_t v) {
  return __uint_as_float(((uint32_t)v) << 16);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// mode: 0 raw, 1 rmsnorm * wn, 2 silu(gate)*up
__global__ void __launch_bounds__(SEG) qp8_quant_kernel(
    const float* __restrict__ x, const float* __restrict__ wn, int K,
    int mode, float eps, int8_t* __restrict__ x8, float* __restrict__ xs) {
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  __shared__ float red[SEG / 32];
  __shared__ float bcast;
  const float* xr = x + (size_t)b * (mode == 2 ? 2 * K : K);
  float inv = 1.f;
  if (mode == 1) {
    float ss = 0.f;
    for (int k = t; k < K; k += SEG) {
      const float v = xr[k];
      ss += v * v;
    }
    ss = warp_sum(ss);
    if (lane == 0) red[warp] = ss;
    __syncthreads();
    if (t == 0) {
      float s = 0.f;
      for (int w = 0; w < SEG / 32; ++w) s += red[w];
      bcast = 1.f / sqrtf(s / (float)K + eps);
    }
    __syncthreads();
    inv = bcast;
    __syncthreads();
  }
  const int nseg = K / SEG;
  for (int sg = 0; sg < nseg; ++sg) {
    const int k = sg * SEG + t;
    float v;
    if (mode == 2) {
      const float g = xr[k];
      v = g * (1.f / (1.f + expf(-g))) * xr[K + k];
    } else if (mode == 1) {
      v = xr[k] * inv * wn[k];
    } else {
      v = xr[k];
    }
    float m = warp_max(fabsf(v));
    if (lane == 0) red[warp] = m;
    __syncthreads();
    if (t == 0) {
      float mm = red[0];
      for (int w = 1; w < SEG / 32; ++w) mm = fmaxf(mm, red[w]);
      bcast = mm;
    }
    __syncthreads();
    const float amax = bcast;
    __syncthreads();
    const float iscale = amax > 0.f ? 127.f / amax : 0.f;
    x8[(size_t)b * K + k] = (int8_t)__float2int_rn(v * iscale);
    if (t == 0) xs[(size_t)b * nseg + sg] = amax * (1.0f / 127.0f);
  }
}

struct Plane {
  const uint8_t* fq;
  const uint16_t* fs;  // bf16 bits
  const uint16_t* fb;  // bf16 bits or null
  int n2, ld, bl, bh, gs;  // lanes, row pitch of fq/fs/fb, packing
  float off;
  int cm;  // code-map id (codes.cuh), CM_NONE for uncoded planes
};

// 4x4 byte transpose: out[c] byte i = in[i] byte c.
__device__ __forceinline__ void transpose4(const uint32_t q[4], uint32_t col[4]) {
  const uint32_t t0 = __byte_perm(q[0], q[1], 0x5140);
  const uint32_t t1 = __byte_perm(q[2], q[3], 0x5140);
  const uint32_t t2 = __byte_perm(q[0], q[1], 0x7362);
  const uint32_t t3 = __byte_perm(q[2], q[3], 0x7362);
  col[0] = __byte_perm(t0, t1, 0x5410);
  col[1] = __byte_perm(t0, t1, 0x7632);
  col[2] = __byte_perm(t2, t3, 0x5410);
  col[3] = __byte_perm(t2, t3, 0x7632);
}

// grid.x: column blocks of plane A then plane B; grid.y: K splits;
// grid.z: row groups of NB rows (K5: one row each, ids non-null).
// rows = gridDim.z * NB output rows.  ksb == gridDim.y == 1: dst is the
// output [rows, dst_stride] (+ residual); else dst holds partials
// [ksb, rows, dst_stride].  CODED: a plane may carry codes (P.cm); the
// uncoded instance has no decode in its inner loop, which costs registers
// and unrolling even when never taken.
template <int NB, bool CODED>
__global__ void __launch_bounds__(WARPS * 32) qp8_gemv_kernel(
    Plane A, Plane Bp, int nblk_a, int K, const int8_t* __restrict__ x8,
    const float* __restrict__ xs, float* __restrict__ dst, int dst_stride,
    const float* __restrict__ res, int n_res, const int* __restrict__ ids,
    int npe, int n_exp) {
  __shared__ float red[WARPS][NB][COLS];
  const bool second = (int)blockIdx.x >= nblk_a;
  const Plane P = second ? Bp : A;
  const int cb = second ? (int)blockIdx.x - nblk_a : (int)blockIdx.x;
  const int out_col0 = (second ? A.n2 : 0) + cb * COLS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.z * NB;
  const int rows = gridDim.z * NB;
  int lane0 = 0;
  bool valid = true;
  if (ids != nullptr) {
    const int e = __ldg(ids + blockIdx.z);
    valid = e >= 0 && e < n_exp;
    lane0 = valid ? e * npe : 0;
  }
  x8 += (size_t)row0 * K;
  xs += (size_t)row0 * (K / SEG);
  const int n0 = lane0 + cb * COLS + lane * 4;
  const int rows_lo = K * P.bl / 8;
  const int U = P.bh ? K * P.bh / 8 : rows_lo;  // unit rows per shift slice
  const int E = K / U;                          // groups sharing a unit chunk
  const int nchunks = U / P.gs;
  const int nparts = gridDim.y * WARPS;
  const int part = blockIdx.y * WARPS + warp;
  const int cpp = (nchunks + nparts - 1) / nparts;
  const int c_beg = part * cpp;
  const int c_end = min(nchunks, c_beg + cpp);
  const uint32_t mlo = ((1u << P.bl) - 1u) * 0x01010101u;
  const uint32_t mhi = ((1u << P.bh) - 1u) * 0x01010101u;
  const int nseg = K / SEG;
  const bool bias = P.fb != nullptr || P.off != 0.f;
  const int* x8w = reinterpret_cast<const int*>(x8);
  const size_t ld = (size_t)P.ld;

  float acc[4][NB];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int b = 0; b < NB; ++b) acc[c][b] = 0.f;

  for (int ch = c_beg; ch < c_end; ++ch) {
    const int u0 = ch * P.gs;
    for (int j = 0; j < E; ++j) {
      const int k0 = j * U + u0;  // first element of group g
      const int g = k0 / P.gs;
      const int lo_row0 = k0 % rows_lo;
      const int lo_shift = P.bl * (k0 / rows_lo);
      const int hi_shift = P.bh * j;
      int pacc[4][NB];
      int sacc[NB];
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        sacc[b] = 0;
#pragma unroll
        for (int c = 0; c < 4; ++c) pacc[c][b] = 0;
      }
      for (int kk = 0; kk < P.gs; kk += 4) {
        uint32_t q[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t w = __ldg(reinterpret_cast<const unsigned int*>(
              P.fq + (size_t)(lo_row0 + kk + i) * ld + n0));
          uint32_t v = (w >> lo_shift) & mlo;
          if (P.bh) {
            const uint32_t h = __ldg(reinterpret_cast<const unsigned int*>(
                P.fq + (size_t)(rows_lo + u0 + kk + i) * ld + n0));
            v |= ((h >> hi_shift) & mhi) << P.bl;
          }
          q[i] = CODED && P.cm ? decode4(v, P.cm, P.bh ? 2 : 3) : v;
        }
        uint32_t col[4];
        transpose4(q, col);
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const int xw = __ldg(x8w + (((size_t)b * K + k0 + kk) >> 2));
#pragma unroll
          for (int c = 0; c < 4; ++c) pacc[c][b] = __dp4a((int)col[c], xw, pacc[c][b]);
          if (bias) sacc[b] = __dp4a(xw, 0x01010101, sacc[b]);
        }
      }
      const uint2 sraw = __ldg(reinterpret_cast<const uint2*>(P.fs + (size_t)g * ld + n0));
      float m[4] = {bf2f(sraw.x & 0xffff), bf2f(sraw.x >> 16),
                    bf2f(sraw.y & 0xffff), bf2f(sraw.y >> 16)};
      float fbv[4] = {0.f, 0.f, 0.f, 0.f};
      if (P.fb) {
        const uint2 braw = __ldg(reinterpret_cast<const uint2*>(P.fb + (size_t)g * ld + n0));
        fbv[0] = bf2f(braw.x & 0xffff);
        fbv[1] = bf2f(braw.x >> 16);
        fbv[2] = bf2f(braw.y & 0xffff);
        fbv[3] = bf2f(braw.y >> 16);
      } else if (P.off != 0.f) {
#pragma unroll
        for (int c = 0; c < 4; ++c) fbv[c] = P.off * m[c];
      }
      const int seg = k0 / SEG;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const float xsb = __ldg(xs + (size_t)b * nseg + seg);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[c][b] += (float)pacc[c][b] * (m[c] * xsb);
          if (bias) acc[c][b] += fbv[c] * ((float)sacc[b] * xsb);
        }
      }
    }
  }

#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[warp][b][lane * 4 + c] = acc[c][b];
  __syncthreads();
  for (int e = threadIdx.x; e < NB * COLS; e += WARPS * 32) {
    const int b = e / COLS, cl = e % COLS;
    const int r = row0 + b;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) v += red[w][b][cl];
    if (!valid) v = __int_as_float(0x7fc00000);  // NaN: expert id out of range
    if (gridDim.y == 1) {
      const int pc = cb * COLS + cl;  // column within plane A (res only for single launches)
      if (res != nullptr && pc < n_res) v += res[(size_t)r * n_res + pc];
      dst[(size_t)r * dst_stride + out_col0 + cl] = v;
    } else {
      dst[((size_t)blockIdx.y * rows + r) * dst_stride + out_col0 + cl] = v;
    }
  }
}

__global__ void qp8_finalize_kernel(const float* __restrict__ ws, int ksb,
                                    int NB, int ncols, const float* __restrict__ res,
                                    int n_res, float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= NB * ncols) return;
  const int b = e / ncols, cl = e % ncols;
  float v = 0.f;
  for (int s = 0; s < ksb; ++s) v += ws[((size_t)s * NB + b) * ncols + cl];
  if (res != nullptr && cl < n_res) v += res[(size_t)b * n_res + cl];
  out[e] = v;
}

template <int NB>
void launch_gemv(const Plane& A, const Plane& B, int nblk_a, int nblk, int K,
                 const int8_t* x8, const float* xs, float* dst, int dst_stride,
                 const float* res, int n_res, int ksb, cudaStream_t s) {
  dim3 grid(nblk, ksb);
  if (A.cm || B.cm)
    qp8_gemv_kernel<NB, true><<<grid, WARPS * 32, 0, s>>>(
        A, B, nblk_a, K, x8, xs, dst, dst_stride, res, n_res, nullptr, 0, 0);
  else
    qp8_gemv_kernel<NB, false><<<grid, WARPS * 32, 0, s>>>(
        A, B, nblk_a, K, x8, xs, dst, dst_stride, res, n_res, nullptr, 0, 0);
}

}  // namespace

extern "C" {

const char* ght_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// One call = prologue + GEMV (+ finalize when ksb > 1).  Plane B is used
// when n2_b > 0 (K2, the dual projection); its columns follow A's.
int qp8_gemv_run(const float* x, const float* wn, int mode, float eps, int NB,
                 int K, const void* fq_a, const void* fs_a, const void* fb_a,
                 int n2_a, int ld_a, int bl_a, int bh_a, int gs_a, float off_a,
                 int cm_a, const void* fq_b, const void* fs_b, const void* fb_b,
                 int n2_b, int ld_b, int bl_b, int bh_b, int gs_b, float off_b,
                 int cm_b, int8_t* x8,
                 float* xs, float* ws, int ksb, float* out, const float* res,
                 int n_res, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  qp8_quant_kernel<<<NB, SEG, 0, s>>>(x, wn, K, mode, eps, x8, xs);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  Plane A{(const uint8_t*)fq_a, (const uint16_t*)fs_a, (const uint16_t*)fb_a,
          n2_a, ld_a, bl_a, bh_a, gs_a, off_a, cm_a};
  Plane B{(const uint8_t*)(n2_b ? fq_b : fq_a), (const uint16_t*)(n2_b ? fs_b : fs_a),
          (const uint16_t*)(n2_b ? fb_b : fb_a), n2_b ? n2_b : n2_a,
          n2_b ? ld_b : ld_a, n2_b ? bl_b : bl_a, n2_b ? bh_b : bh_a,
          n2_b ? gs_b : gs_a, n2_b ? off_b : off_a, n2_b ? cm_b : cm_a};
  const int ncols = n2_a + n2_b;
  const int nblk_a = n2_a / COLS;
  const int nblk = ncols / COLS;
  float* dst = ksb > 1 ? ws : out;
  switch (NB) {
    case 1: launch_gemv<1>(A, B, nblk_a, nblk, K, x8, xs, dst, ncols, res, n_res, ksb, s); break;
    case 2: launch_gemv<2>(A, B, nblk_a, nblk, K, x8, xs, dst, ncols, res, n_res, ksb, s); break;
    case 3: launch_gemv<3>(A, B, nblk_a, nblk, K, x8, xs, dst, ncols, res, n_res, ksb, s); break;
    case 4: launch_gemv<4>(A, B, nblk_a, nblk, K, x8, xs, dst, ncols, res, n_res, ksb, s); break;
    case 5: launch_gemv<5>(A, B, nblk_a, nblk, K, x8, xs, dst, ncols, res, n_res, ksb, s); break;
    case 6: launch_gemv<6>(A, B, nblk_a, nblk, K, x8, xs, dst, ncols, res, n_res, ksb, s); break;
    case 7: launch_gemv<7>(A, B, nblk_a, nblk, K, x8, xs, dst, ncols, res, n_res, ksb, s); break;
    case 8: launch_gemv<8>(A, B, nblk_a, nblk, K, x8, xs, dst, ncols, res, n_res, ksb, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (ksb > 1) {
    const int total = NB * ncols;
    qp8_finalize_kernel<<<(total + 255) / 256, 256, 0, s>>>(ws, ksb, NB, ncols, res,
                                                            n_res, out);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// K5: one call = the raw-activation prologue for the P rows + the GEMV of
// row p against lanes [ids[p]*npe, (ids[p]+1)*npe) of the stacked planes
// (+ finalize when ksb > 1).  out [P, npe]; ws [ksb, P, npe].
int qp8_indirect_run(const float* x, int P, int K, const int* ids, int npe,
                     int n_exp, const void* fq, const void* fs, const void* fb,
                     int ld, int bl, int bh, int gs, float off, int cm, int8_t* x8,
                     float* xs, float* ws, int ksb, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (npe % COLS || P < 1 || P > 65535) return (int)cudaErrorInvalidValue;
  qp8_quant_kernel<<<P, SEG, 0, s>>>(x, nullptr, K, 0, 0.f, x8, xs);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const Plane A{(const uint8_t*)fq, (const uint16_t*)fs, (const uint16_t*)fb,
                npe, ld, bl, bh, gs, off, cm};
  dim3 grid(npe / COLS, ksb, P);
  float* dst = ksb > 1 ? ws : out;
  if (cm)
    qp8_gemv_kernel<1, true><<<grid, WARPS * 32, 0, s>>>(
        A, A, npe / COLS, K, x8, xs, dst, npe, nullptr, 0, ids, npe, n_exp);
  else
    qp8_gemv_kernel<1, false><<<grid, WARPS * 32, 0, s>>>(
        A, A, npe / COLS, K, x8, xs, dst, npe, nullptr, 0, ids, npe, n_exp);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (ksb > 1) {
    const int total = P * npe;
    qp8_finalize_kernel<<<(total + 255) / 256, 256, 0, s>>>(ws, ksb, P, npe, nullptr,
                                                            0, out);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // extern "C"
