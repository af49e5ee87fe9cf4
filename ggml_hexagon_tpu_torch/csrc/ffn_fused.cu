// K9: the whole-FFN megakernel of a decode step, for sm_90a.
//
// Replaces ggml_hexagon_tpu/ops/ffn_fused.py `_ffn_kernel` (:93, with
// `_phase_dot` :50 and `_side_bias` :84), launched through `pallas_call` in
// `_ffn_call` (:250).  One launch runs, for B <= 8 rows, the three phases
// that the split path runs as three K6 launches (wo residual mode, gate_up
// normed mode, down act mode; csrc/fast_il.cu):
//   phase A  h2 = x_a @ wo'^T + xg_a @ fb_wo^T + h                      f32
//   phase B  inv = 1/sqrt(mean(h2^2) + eps); xb = bf16(h2 * inv * wn),
//            xg_b the group sums of the f32 xb before its rounding;
//            gu = xb @ gate_up'^T + xg_b @ fb_gu^T                       f32
//   phase C  xd = bf16(silu(gate) * up), in f32;
//            out = (xd @ down'^T + bias) + h2                           f32
// wo and gate_up are nibble planes (Q4_K-class) with a stored fb; down is
// nibble (Q4_K stored fb, Q4_0 derived -8), byte (Q6_K derived -32, Q5_K
// stored fb) or coded (the i-quants, codes.cuh, no bias).  The down bias is
// xs @ bf16(tile(fb)) or off * (xs @ bf16(tile(fs))) with xs = bf16(xd_lo +
// xd_hi) on packed planes (the two halves a packed byte pairs), xd on byte
// planes.  Weights: bf16(q * scale) on nibble and coded planes, f32 q *
// scale on byte planes (the TPU kernel's f32 route at <= 8 rows); every
// product is summed in f32.
//
// What bounds it: bytes.  At Llama-3-8B widths a layer streams 10.5 MB of
// wo planes, 73.4 MB of gate_up and 36.7 MB (Q4_K) or 66.1 MB (Q6_K) of
// down, each weight byte feeding 2B multiply-adds at most.
//
// Design (a simple, right first version):
//  * One cooperative launch (cudaLaunchCooperativeKernel) of a persistent
//    grid, the blocks that fit on the card at once (the occupancy
//    calculator times the SM count), so the grid-wide barriers
//    (cooperative_groups grid.sync) cannot deadlock; a grid the card cannot
//    hold comes back as cudaErrorCooperativeLaunchTooLarge.  The TPU ran
//    its three phases in order on one core, carrying h2, xb and xd in VMEM
//    from step to step; here blocks run in no order, so the phases meet at
//    three barriers and the intermediates live in global scratch (h2, gu,
//    xd, and the down bias's group sums xsg), which the wrapper allocates.
//  * Phases A, B and C: one warp a weight row, rows dealt to the warps of
//    the grid in turn; each lane takes 16 weight bytes a step (K6's
//    GEMV body: 16 byte weights, or 32 nibble weights at columns b..b+15 and
//    b+K/2..b+K/2+15), then the lanes split the bias's G terms, and warp
//    shuffles end the row.
//  * After barrier 1 every block takes the rows' sum of squares of h2 and
//    writes its own xb (bf16) and xg_b into shared memory, which phase B
//    reads: B*d reads from L2 a block, where a distributed pass would cost
//    another barrier.
//  * After barrier 2 the grid builds xd in one distributed pass, a thread
//    a (row, down group): it writes the group's xd values and sums their xs
//    into xsg, which phase C's bias reads (the TPU kernel's repeated-tile
//    dot, summed in another order).  Barrier 3, then phase C.
//  * Scratch written during the launch is read with coherent loads (never
//    the read-only path); weights and inputs through __ldg.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <stdint.h>

#include "codes.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
// down plane families (kernels.py passes them)
constexpr int FAM_BYTE = 0, FAM_NIBBLE = 1, FAM_CODED = 2;

struct Args {
  const uint16_t* xa;   // bf16 [B, d], the attention output interleaved
  const float* xga;     // f32 [B, G], its group sums
  const float* hil;     // f32 [B, d], the residual interleaved
  const float* wn;      // f32 [d], the ffn norm weight interleaved
  float eps;
  const uint8_t* wo_q;  // uint8 [d, d/2]
  const uint16_t* wo_s; // bf16 [d, G]
  const uint16_t* wo_b; // bf16 [d, G]
  const uint8_t* gu_q;  // uint8 [2 n_ff, d/2]
  const uint16_t* gu_s; // bf16 [2 n_ff, G]
  const uint16_t* gu_b; // bf16 [2 n_ff, G]
  const uint8_t* dn_q;  // int8 [d, n_ff] or packed uint8 [d, n_ff/2]
  const uint16_t* dn_s; // bf16 [d, Gc]
  const uint16_t* dn_b; // bf16 [d, Gc], or null
  float dn_off;         // the derived bias's offset (dn_b null)
  int cm;               // code-map id of coded down planes
  int d, n_ff, G, Gc;
  float* h2;            // scratch f32 [B, d]
  float* gu;            // scratch f32 [B, 2 n_ff]
  uint16_t* xd;         // scratch bf16 [B, n_ff]
  float* xsg;           // scratch f32 [B, Gc] (down planes with a bias), or null
  float* out;           // f32 [B, d]
};

__device__ __forceinline__ float bf2f(uint16_t v) {
  return __uint_as_float(((uint32_t)v) << 16);
}

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

__device__ __forceinline__ float silu_mul(float g, float u) {
  return g * (1.f / (1.f + expf(-g))) * u;
}

// One lane's share of NB row dots of x (row pitch ldx; global or shared,
// plain loads) against byte weight row `wrow` (K int8 values, scales
// `srow` of G groups): f32 weights.
template <int NB>
__device__ __forceinline__ void dots_byte(const uint16_t* x, int ldx,
                                          const int8_t* __restrict__ wrow,
                                          const uint16_t* __restrict__ srow, int K,
                                          int G, int lane, float acc[NB]) {
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
      const uint4* xp = reinterpret_cast<const uint4*>(x + (size_t)b * ldx + j0);
      const uint4 xa = xp[0], xb = xp[1];
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

// The same on a packed weight row (K/2 bytes): byte p gives the weights of
// columns p and K/2 + p, each bf16(q * scale of group p % G); CODED: q is
// the decoded code (code map cm).
template <int NB, bool CODED>
__device__ __forceinline__ void dots_nib(const uint16_t* x, int ldx,
                                         const uint8_t* __restrict__ wrow,
                                         const uint16_t* __restrict__ srow, int K, int G,
                                         int cm, int lane, float acc[NB]) {
#pragma unroll
  for (int b = 0; b < NB; ++b) acc[b] = 0.f;
  const int Kh = K / 2;
  for (int p0 = lane * 16; p0 < Kh; p0 += 32 * 16) {
    const uint4 wv = __ldg(reinterpret_cast<const uint4*>(wrow + p0));
    const uint32_t ww[4] = {wv.x, wv.y, wv.z, wv.w};
    uint32_t dl[4], dh[4];
    if constexpr (CODED) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dl[j] = decode4(ww[j] & 0x0f0f0f0fu, cm, 3);
        dh[j] = decode4((ww[j] >> 4) & 0x0f0f0f0fu, cm, 3);
      }
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
      const uint4* xl = reinterpret_cast<const uint4*>(x + (size_t)b * ldx + p0);
      const uint4* xh = reinterpret_cast<const uint4*>(x + (size_t)b * ldx + Kh + p0);
      const uint4 la = xl[0], lb = xl[1], ha = xh[0], hb = xh[1];
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

// The dots warp-summed into every lane, and the bias dots xg @ brow (xg
// f32 [NB, G], global or shared), warp-summed too.
template <int NB>
__device__ __forceinline__ void row_end(const float* xg, const uint16_t* __restrict__ brow,
                                        int G, int lane, float dot[NB], float bias[NB]) {
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    dot[b] = warp_sum(dot[b]);
    bias[b] = 0.f;
  }
  if (xg == nullptr) return;
  for (int g = lane; g < G; g += 32) {
    const float f = bf2f(__ldg(brow + g));
#pragma unroll
    for (int b = 0; b < NB; ++b) bias[b] = fmaf(xg[(size_t)b * G + g], f, bias[b]);
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) bias[b] = warp_sum(bias[b]);
}

template <int NB, int FAM>
__global__ void __launch_bounds__(THREADS, 2) ffn_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[NB][WARPS];
  __shared__ float inv_s[NB];
  const int d = a.d, G = a.G, n_ff = a.n_ff, Gc = a.Gc;
  uint16_t* xb = reinterpret_cast<uint16_t*>(smem);                   // bf16 [NB, d]
  float* xgb = reinterpret_cast<float*>(smem + (size_t)NB * d * 2);   // f32 [NB, G]
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gw = blockIdx.x * WARPS + warp, nw = gridDim.x * WARPS;
  float dot[NB], bias[NB];

  // phase A: wo rows (in the il32 order), side bias, residual
  for (int n = gw; n < d; n += nw) {
    dots_nib<NB, false>(a.xa, d, a.wo_q + (size_t)n * (d / 2), a.wo_s + (size_t)n * G, d,
                        G, CM_NONE, lane, dot);
    row_end<NB>(a.xga, a.wo_b + (size_t)n * G, G, lane, dot, bias);
    if (lane == 0) {
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const size_t i = (size_t)b * d + n;
        a.h2[i] = (dot[b] + bias[b]) + a.hil[i];
      }
    }
  }
  grid.sync();

  // the norm, in every block: the rows' 1/sqrt(mean(h2^2) + eps), then xb
  // and its group sums (column r*G + g in group g) into shared memory
  {
    float ss[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) ss[b] = 0.f;
    for (int j = threadIdx.x; j < d; j += THREADS) {
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const float v = a.h2[(size_t)b * d + j];
        ss[b] += v * v;
      }
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const float s = warp_sum(ss[b]);
      if (lane == 0) red[b][warp] = s;
    }
    __syncthreads();
    if (threadIdx.x < NB) {
      float s = 0.f;
      for (int w = 0; w < WARPS; ++w) s += red[threadIdx.x][w];
      inv_s[threadIdx.x] = 1.f / sqrtf(s / (float)d + a.eps);
    }
    __syncthreads();
    for (int it = threadIdx.x; it < NB * G; it += THREADS) {
      const int b = it / G, g = it % G;
      const float inv = inv_s[b];
      const float* hr = a.h2 + (size_t)b * d;
      float s = 0.f;
      for (int j = g; j < d; j += G) {
        const float v = hr[j] * inv * __ldg(a.wn + j);
        xb[(size_t)b * d + j] = f2bf(v);
        s += v;
      }
      xgb[b * G + g] = s;
    }
    __syncthreads();
  }

  // phase B: gate_up rows against the block's xb, side bias
  for (int n = gw; n < 2 * n_ff; n += nw) {
    dots_nib<NB, false>(xb, d, a.gu_q + (size_t)n * (d / 2), a.gu_s + (size_t)n * G, d,
                        G, CM_NONE, lane, dot);
    row_end<NB>(xgb, a.gu_b + (size_t)n * G, G, lane, dot, bias);
    if (lane == 0) {
#pragma unroll
      for (int b = 0; b < NB; ++b) a.gu[(size_t)b * 2 * n_ff + n] = dot[b] + bias[b];
    }
  }
  grid.sync();

  // xd = bf16(silu(gate) * up) over the grid, a thread a (row, down group
  // g): the group's columns c = r*Gc + g of xs (and c + n_ff/2 on packed
  // planes), their xs summed into xsg when the down planes carry a bias
  {
    constexpr bool packed = FAM != FAM_BYTE;
    const int width = packed ? n_ff / 2 : n_ff;
    const int reps = width / Gc;
    const int nt = gridDim.x * THREADS;
    for (int it = blockIdx.x * THREADS + threadIdx.x; it < NB * Gc; it += nt) {
      const int b = it / Gc, g = it % Gc;
      const float* gr = a.gu + (size_t)b * 2 * n_ff;
      uint16_t* xr = a.xd + (size_t)b * n_ff;
      float s = 0.f;
      for (int r = 0; r < reps; ++r) {
        const int c = r * Gc + g;
        const uint16_t lo = f2bf(silu_mul(gr[c], gr[n_ff + c]));
        xr[c] = lo;
        float xs = bf2f(lo);
        if (packed) {
          const int c2 = c + width;
          const uint16_t hi = f2bf(silu_mul(gr[c2], gr[n_ff + c2]));
          xr[c2] = hi;
          xs = bf_round(xs + bf2f(hi));
        }
        s += xs;
      }
      if (a.xsg != nullptr) a.xsg[(size_t)b * Gc + g] = s;
    }
  }
  grid.sync();

  // phase C: down rows (in the il32 order), bias, + h2
  const uint16_t* bsrc = a.dn_b != nullptr ? a.dn_b : a.dn_s;
  for (int n = gw; n < d; n += nw) {
    if constexpr (FAM == FAM_BYTE)
      dots_byte<NB>(a.xd, n_ff, reinterpret_cast<const int8_t*>(a.dn_q) + (size_t)n * n_ff,
                    a.dn_s + (size_t)n * Gc, n_ff, Gc, lane, dot);
    else
      dots_nib<NB, FAM == FAM_CODED>(a.xd, n_ff, a.dn_q + (size_t)n * (n_ff / 2),
                                      a.dn_s + (size_t)n * Gc, n_ff, Gc, a.cm, lane, dot);
    row_end<NB>(a.xsg, bsrc + (size_t)n * Gc, Gc, lane, dot, bias);
    if (lane == 0) {
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        float y = dot[b];
        if (a.xsg != nullptr) y = y + (a.dn_b != nullptr ? bias[b] : a.dn_off * bias[b]);
        const size_t i = (size_t)b * d + n;
        a.out[i] = y + a.h2[i];
      }
    }
  }
}

template <int NB, int FAM>
cudaError_t launch(const Args& a, cudaStream_t s) {
  const void* kern = (const void*)ffn_kernel<NB, FAM>;
  const size_t smem = (size_t)NB * a.d * 2 + (size_t)NB * a.G * 4;
  // per instance: the shared memory granted, and the blocks an SM holds at
  // the shared memory last asked for
  static size_t granted = 48 * 1024, per_sm_at = 0;
  static int per_sm = 0;
  cudaError_t e;
  if (smem > granted) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    granted = smem;
  }
  if (per_sm_at != smem) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, smem);
    if (e != cudaSuccess) return e;
    per_sm_at = smem;
  }
  int dev, sms;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {const_cast<Args*>(&a)};
  e = cudaLaunchCooperativeKernel(kern, dim3(per_sm * sms), dim3(THREADS), args, smem, s);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int FAM>
cudaError_t launch_rows(int B, const Args& a, cudaStream_t s) {
  switch (B) {
    case 1: return launch<1, FAM>(a, s);
    case 2: return launch<2, FAM>(a, s);
    case 3: return launch<3, FAM>(a, s);
    case 4: return launch<4, FAM>(a, s);
    case 5: return launch<5, FAM>(a, s);
    case 6: return launch<6, FAM>(a, s);
    case 7: return launch<7, FAM>(a, s);
    default: return launch<8, FAM>(a, s);
  }
}

}  // namespace

extern "C" {

const char* ght_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// K9.  x_a bf16 [B <= 8, d] (the attention output in wo's interleaved
// column order), xg_a f32 [B, G] its group sums, h_il f32 [B, d] the
// residual interleaved, wn f32 [d] the ffn norm weight interleaved, eps;
// wo uint8 [d, d/2] and gate_up uint8 [2 n_ff, d/2] nibble planes, each with
// fs and fb bf16 [., G]; down planes of family dn_fam (0 byte int8 [d, n_ff],
// 1 nibble, 2 coded uint8 [d, n_ff/2]; cm its code map) with fs bf16
// [d, Gc] and the bias fb bf16 [d, Gc], or off * fs (fb null, off != 0), or
// none; scratch h2 f32 [B, d], gu f32 [B, 2 n_ff], xd bf16 [B, n_ff], xsg f32
// [B, Gc] (down planes with a bias, else null); out f32 [B, d], in the il32
// order of the permuted rows.
int ffn_fused_run(const void* x_a, const float* xg_a, const float* h_il, const float* wn,
                  float eps, int B, int d, int n_ff, int G, int Gc, const void* wo_q,
                  const void* wo_s, const void* wo_b, const void* gu_q, const void* gu_s,
                  const void* gu_b, const void* dn_q, const void* dn_s, const void* dn_b,
                  int dn_fam, int cm, float dn_off, float* h2, float* gu, void* xd,
                  float* xsg, float* out, void* stream) {
  const bool packed = dn_fam != FAM_BYTE;
  const bool bias = dn_b != nullptr || dn_off != 0.f;
  const int width = packed ? n_ff / 2 : n_ff;
  if (B < 1 || B > 8 || d < 64 || d % 64 || G < 1 || d % G || (d / 2) % G ||
      n_ff < 64 || n_ff % 64 || Gc < 1 || width % Gc || dn_fam < FAM_BYTE ||
      dn_fam > FAM_CODED || (dn_fam == FAM_CODED) != (cm != CM_NONE) || cm < CM_NONE ||
      cm > CM_TERN || (dn_fam == FAM_CODED && bias) || bias != (xsg != nullptr) ||
      wo_b == nullptr || gu_b == nullptr || x_a == nullptr || xg_a == nullptr ||
      h_il == nullptr || wn == nullptr || h2 == nullptr || gu == nullptr ||
      xd == nullptr || out == nullptr)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.xa = (const uint16_t*)x_a;
  a.xga = xg_a;
  a.hil = h_il;
  a.wn = wn;
  a.eps = eps;
  a.wo_q = (const uint8_t*)wo_q;
  a.wo_s = (const uint16_t*)wo_s;
  a.wo_b = (const uint16_t*)wo_b;
  a.gu_q = (const uint8_t*)gu_q;
  a.gu_s = (const uint16_t*)gu_s;
  a.gu_b = (const uint16_t*)gu_b;
  a.dn_q = (const uint8_t*)dn_q;
  a.dn_s = (const uint16_t*)dn_s;
  a.dn_b = (const uint16_t*)dn_b;
  a.dn_off = dn_off;
  a.cm = cm;
  a.d = d;
  a.n_ff = n_ff;
  a.G = G;
  a.Gc = Gc;
  a.h2 = h2;
  a.gu = gu;
  a.xd = (uint16_t*)xd;
  a.xsg = xsg;
  a.out = out;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (dn_fam == FAM_CODED)
    e = launch_rows<FAM_CODED>(B, a, s);
  else if (dn_fam == FAM_NIBBLE)
    e = launch_rows<FAM_NIBBLE>(B, a, s);
  else
    e = launch_rows<FAM_BYTE>(B, a, s);
  return (int)e;
}

}  // extern "C"
