// K4: fused single-token decode attention, for sm_90a.
//
// Replaces ggml_hexagon_tpu/ops/decode_attn.py `_kernel_single` (one KV
// chunk) and `_kernel` (online softmax over chunks), launched through
// `pallas_call` in `fused_decode_attention`.
//
// What bounds it: bytes.  Each (row, KV head) reads its pos live cache rows
// of K and V once (2 x pos x 128 x 2 bytes for a bf16 cache, half that
// for int8) and does ~4 flops per byte read.
//
// Design: one block per (batch row, KV head), 8 warps.
//  * The block ropes the fresh q heads of its group and the fresh k row
//    (NEOX pairing, cos/sin computed outside, as on the TPU) into shared
//    memory, scales q, and writes the roped k row and the v row out: the
//    caller writes them into the cache after the layer loop.
//  * Warp w walks the cache slots w, w+8, ... < pos; a lane holds 4 of the
//    128 head dims, so a slot row is one coalesced 256-byte (bf16) read and
//    a score is one warp reduction per query head.  Each warp keeps its
//    own online softmax (running max, denominator, accumulator) in f32.
//  * int8 KV: the per-row K scale multiplies the raw score and the per-row
//    V scale the probability (after the denominator took it), as the TPU
//    kernel does, so no dequantized cache exists.
//  * The warps' states merge in shared memory together with the fresh
//    row's self-term (it never touched the cache), then divide by the
//    denominator.  The TPU's block-diagonal q was a matrix-unit device and
//    is not carried over.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int D = 128;
constexpr int NW = 8;      // warps per block
constexpr int MAXG = 8;    // query heads per KV head
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float bf2f(uint16_t v) {
  return __uint_as_float(((uint32_t)v) << 16);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <bool QUANT>
__global__ void __launch_bounds__(NW * 32) decode_attn_kernel(
    const float* __restrict__ qkv, const void* __restrict__ kc,
    const void* __restrict__ vc, const float* __restrict__ kd,
    const float* __restrict__ vd, const int* __restrict__ pos,
    const float* __restrict__ cos_sin, int Hq, int Hkv, int S, int n_dims,
    float scale, int swa, float logit_cap, float* __restrict__ out,
    float* __restrict__ k_out, float* __restrict__ v_out) {
  const int b = blockIdx.x, h = blockIdx.y;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  __shared__ float qs[MAXG][D];
  __shared__ float kf[D], vf[D];
  __shared__ float s_self[MAXG];
  __shared__ float wm[NW][MAXG], wl[NW][MAXG];
  __shared__ float wacc[NW][MAXG][D];

  const int W = (Hq + 2 * Hkv) * D;
  const float* row = qkv + (size_t)b * W;
  const int half = n_dims / 2;
  const float* cs = cos_sin ? cos_sin + (size_t)b * 2 * half : nullptr;
  for (int e = tid; e < (G + 2) * D; e += NW * 32) {
    const int hh = e / D, d = e % D;
    const float* src = hh < G ? row + (size_t)(h * G + hh) * D
                       : hh == G ? row + (size_t)(Hq + h) * D
                                 : row + (size_t)(Hq + Hkv + h) * D;
    float v = src[d];
    if (hh <= G && cs != nullptr && d < n_dims) {
      if (d < half) {
        v = __fsub_rn(__fmul_rn(src[d], cs[d]), __fmul_rn(src[d + half], cs[half + d]));
      } else {
        const int j = d - half;
        v = __fadd_rn(__fmul_rn(src[j], cs[half + j]), __fmul_rn(src[d], cs[j]));
      }
    }
    if (hh < G) {
      qs[hh][d] = __fmul_rn(v, scale);
    } else if (hh == G) {
      kf[d] = v;
      k_out[((size_t)b * Hkv + h) * D + d] = v;
    } else {
      vf[d] = v;
      v_out[((size_t)b * Hkv + h) * D + d] = v;
    }
  }
  __syncthreads();

  const int p = min(pos[b], S);
  if (warp < G) {  // self-term score of the fresh row
    float part = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) part += qs[warp][lane * 4 + e] * kf[lane * 4 + e];
    float s = warp_sum(part);
    if (logit_cap != 0.f) s = tanhf(s / logit_cap) * logit_cap;
    if (lane == 0) s_self[warp] = s;
  }

  float m[MAXG], l[MAXG], acc[MAXG][4];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;
  }
  const size_t HD = (size_t)Hkv * D;
  for (int t = warp; t < p; t += NW) {
    if (swa && p - t >= swa) continue;
    const size_t off = ((size_t)b * S + t) * HD + (size_t)h * D + lane * 4;
    float kv4[4], vv4[4];
    if (QUANT) {
      const uint32_t kw = *reinterpret_cast<const uint32_t*>((const int8_t*)kc + off);
      const uint32_t vw = *reinterpret_cast<const uint32_t*>((const int8_t*)vc + off);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        kv4[e] = (float)(int8_t)(kw >> (8 * e));
        vv4[e] = (float)(int8_t)(vw >> (8 * e));
      }
    } else {
      const uint2 kw = *reinterpret_cast<const uint2*>((const uint16_t*)kc + off);
      const uint2 vw = *reinterpret_cast<const uint2*>((const uint16_t*)vc + off);
      kv4[0] = bf2f(kw.x & 0xffff); kv4[1] = bf2f(kw.x >> 16);
      kv4[2] = bf2f(kw.y & 0xffff); kv4[3] = bf2f(kw.y >> 16);
      vv4[0] = bf2f(vw.x & 0xffff); vv4[1] = bf2f(vw.x >> 16);
      vv4[2] = bf2f(vw.y & 0xffff); vv4[3] = bf2f(vw.y >> 16);
    }
    const float ks = QUANT ? kd[(size_t)b * S + t] : 1.f;
    const float vs = QUANT ? vd[(size_t)b * S + t] : 1.f;
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) part += qs[g][lane * 4 + e] * kv4[e];
      float s = warp_sum(part);
      if (QUANT) s = s * ks;
      if (logit_cap != 0.f) s = tanhf(s / logit_cap) * logit_cap;
      const float m_new = fmaxf(m[g], s);
      const float alpha = expf(m[g] - m_new);
      float pr = expf(s - m_new);
      l[g] = l[g] * alpha + pr;
      if (QUANT) pr = pr * vs;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][e] = acc[g][e] * alpha + pr * vv4[e];
      m[g] = m_new;
    }
  }
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      wm[warp][g] = m[g];
      wl[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) wacc[warp][g][lane * 4 + e] = acc[g][e];
  }
  __syncthreads();

  for (int e = tid; e < G * D; e += NW * 32) {
    const int g = e / D, d = e % D;
    float M = s_self[g];
    for (int w = 0; w < NW; ++w) M = fmaxf(M, wm[w][g]);
    const float p_self = expf(s_self[g] - M);
    float L = p_self;
    float A = p_self * vf[d];
    for (int w = 0; w < NW; ++w) {
      const float f = expf(wm[w][g] - M);
      L += wl[w][g] * f;
      A += wacc[w][g][d] * f;
    }
    out[(size_t)b * Hq * D + (size_t)(h * G + g) * D + d] = A / fmaxf(L, 1e-30f);
  }
}

}  // namespace

extern "C" {

const char* ght_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// qkv f32 [B, (Hq+2Hkv)*128]; caches [B, S, Hkv*128] bf16 (quant == 0) or
// int8 with f32 row scales kd/vd [B, S]; pos int32 [B]; cos_sin f32
// [B, n_dims] (cos ++ sin) or null for no rope.  Outputs f32: out
// [B, Hq*128], k_out/v_out [B, Hkv*128].
int decode_attn_run(const float* qkv, const void* kc, const void* vc,
                    const float* kd, const float* vd, const int* pos,
                    const float* cos_sin, int B, int Hq, int Hkv, int S,
                    int n_dims, float scale, int swa, float logit_cap,
                    int quant, float* out, float* k_out, float* v_out,
                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (Hq % Hkv || Hq / Hkv > MAXG || n_dims > D || n_dims % 2)
    return (int)cudaErrorInvalidValue;
  dim3 grid(B, Hkv);
  if (quant) {
    decode_attn_kernel<true><<<grid, NW * 32, 0, s>>>(
        qkv, kc, vc, kd, vd, pos, cos_sin, Hq, Hkv, S, n_dims, scale, swa,
        logit_cap, out, k_out, v_out);
  } else {
    decode_attn_kernel<false><<<grid, NW * 32, 0, s>>>(
        qkv, kc, vc, kd, vd, pos, cos_sin, Hq, Hkv, S, n_dims, scale, swa,
        logit_cap, out, k_out, v_out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
