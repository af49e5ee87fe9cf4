// K11 (masked flash attention) and K12 (single-token GQA cache
// attention), for sm_90a.
//
// K11 replaces ggml_hexagon_tpu/ops/attention.py `_flash_kernel`, launched
// through `pallas_call` in `flash_attention_pallas`.  What bounds it:
// operations.  Its contract is f32 arithmetic (f32 q, k, v products, f32
// scores, softmax and output), 4*B*H*T*S*D flops against the card's f32
// rate outside the tensor cores; the bytes (q, k, v, the mask as given,
// the output) are a few MB.
//
// Design (simple and right first; tensor-core scores wait for later work):
//  * One block per (batch*head, 32 query rows), 8 warps of 4 rows.  The
//    block walks the keys in tiles of 32 slots staged in shared memory as
//    f32 (k transposed and padded so a lane reads its slot's column free of
//    bank conflicts, v row-major).  A lane owns one slot of the tile for
//    the scores and 32-lane slices of the head dims for the output.
//  * An online softmax per row over the tiles (f32 running max,
//    denominator and accumulator), as the TPU kernel runs one per KV
//    chunk: the results agree to f32 rounding.  NEG_INF is the finite
//    -1e30 of the reference's additive mask, so a row whose slots are all
//    masked averages v, as on the TPU.
//  * The mask is read through its strides: a [1,1,T,S] mask (or any
//    broadcast) is never materialised to [B,H,T,S].
//
// K12 replaces ggml_hexagon_tpu/ops/attention.py `_decode_attn_kernel`,
// launched through `pallas_call` in `decode_attention_pallas`.  What bounds
// it: bytes, the live cache rows of K and V read once (the slots with
// idx <= pos, and pos - idx < swa), at ~2 flops a byte per query head.
//
// Design: the TPU cell takes one batch row and unrolls the KV heads; here
// the live slots of each (row, KV head) are split over enough blocks to
// cover the card (flash-decoding), each block's 8 warps walk their slots
// with a per-warp online softmax (a lane holds 4 of the 128 head dims, one
// coalesced row read a slot, a warp reduction per query head), merge in
// shared memory and write a partial (max, denominator, accumulator) per
// query head; a second small kernel merges the partials.  The G query
// heads of a group share each K and V row read.  Masked slots are skipped,
// which equals the TPU's softmax over every slot (exp(-1e30 - max) is 0),
// unless no slot is live: then every slot takes the -1e30 score and the
// result is the mean of v, as on the TPU.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float bf2f(uint16_t v) {
  return __uint_as_float(((uint32_t)v) << 16);
}

template <bool BF16>
__device__ __forceinline__ float ld(const void* p, size_t i) {
  if constexpr (BF16) {
    return bf2f(__ldg((const unsigned short*)p + i));
  } else {
    return __ldg((const float*)p + i);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---------------------------------------------------------------- K11

constexpr int FA_TQ = 32;            // query rows a block
constexpr int FA_KT = 32;            // key slots a tile
constexpr int FA_NW = 8;             // warps a block
constexpr int FA_RW = FA_TQ / FA_NW; // rows a warp
constexpr int FA_DMAX = 128;

constexpr int fa_smem(int D) {
  return (FA_TQ * D + D * (FA_KT + 1) + FA_KT * D) * 4;
}

template <bool BF16>
__global__ void __launch_bounds__(FA_NW * 32) flash_attn_kernel(
    const void* __restrict__ q, const void* __restrict__ k,
    const void* __restrict__ v, const float* __restrict__ mask,
    long long msb, long long msh, long long mst, long long mss, int H, int T,
    int S, int D, float scale, float* __restrict__ out) {
  extern __shared__ float sm[];
  float* qs = sm;                        // [TQ][D], q * scale
  float* ks = qs + FA_TQ * D;            // [D][KT + 1], transposed
  float* vs = ks + D * (FA_KT + 1);      // [KT][D]
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int t0 = blockIdx.x * FA_TQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nu = D / 32;
  const size_t qbase = (size_t)bh * T * D, kvbase = (size_t)bh * S * D;
  for (int e = tid; e < FA_TQ * D; e += FA_NW * 32) {
    const int t = t0 + e / D;
    qs[e] = t < T ? __fmul_rn(ld<BF16>(q, qbase + (size_t)t * D + e % D), scale)
                  : 0.f;
  }
  const float* mrow = mask + b * msb + h * msh;
  float m[FA_RW], l[FA_RW], acc[FA_RW][4];
#pragma unroll
  for (int r = 0; r < FA_RW; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[r][u] = 0.f;
  }
  for (int s0 = 0; s0 < S; s0 += FA_KT) {
    __syncthreads();   // the previous tile is consumed (and qs written)
    for (int e = tid; e < FA_KT * D; e += FA_NW * 32) {
      const int j = e / D, d = e % D, slot = s0 + j;
      const bool in = slot < S;
      ks[d * (FA_KT + 1) + j] = in ? ld<BF16>(k, kvbase + (size_t)slot * D + d) : 0.f;
      vs[e] = in ? ld<BF16>(v, kvbase + (size_t)slot * D + d) : 0.f;
    }
    __syncthreads();
    const int slot = s0 + lane;
    float sc[FA_RW];
#pragma unroll
    for (int r = 0; r < FA_RW; ++r) sc[r] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float kd = ks[d * (FA_KT + 1) + lane];
#pragma unroll
      for (int r = 0; r < FA_RW; ++r)
        sc[r] = fmaf(qs[(warp * FA_RW + r) * D + d], kd, sc[r]);
    }
    float p[FA_RW];
#pragma unroll
    for (int r = 0; r < FA_RW; ++r) {
      const int t = min(t0 + warp * FA_RW + r, T - 1);
      // slots past S take no part (p = 0); every tile holds one in range
      const float s = slot < S ? sc[r] + mrow[t * mst + slot * mss] : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(s));
      const float alpha = expf(m[r] - m_new);
      p[r] = expf(s - m_new);
      l[r] = l[r] * alpha + warp_sum(p[r]);
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[r][u] *= alpha;
      m[r] = m_new;
    }
    const int jmax = min(FA_KT, S - s0);
    for (int j = 0; j < jmax; ++j) {
      float vv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) vv[u] = u < nu ? vs[j * D + lane + 32 * u] : 0.f;
#pragma unroll
      for (int r = 0; r < FA_RW; ++r) {
        const float pj = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[r][u] = fmaf(pj, vv[u], acc[r][u]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < FA_RW; ++r) {
    const int t = t0 + warp * FA_RW + r;
    if (t >= T) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (u < nu) out[qbase + (size_t)t * D + lane + 32 * u] = acc[r][u] / den;
  }
}

// ---------------------------------------------------------------- K12

constexpr int DA_D = 128;
constexpr int DA_NW = 8;      // warps a block
constexpr int DA_MAXG = 8;    // query heads a KV head
constexpr int DA_PW = DA_D + 2;  // partial record: max, denominator, acc[D]

// The live slot range [lo, hi] of a row at pos; dead (no slot live): every
// slot, each with the score NEG_INF.
__device__ __forceinline__ void live_range(int p, int S, int swa, int& lo,
                                           int& hi, bool& dead) {
  hi = min(p, S - 1);
  lo = swa > 0 ? max(0, p - swa + 1) : 0;
  dead = hi < lo;
  if (dead) {
    lo = 0;
    hi = S - 1;
  }
}

template <bool BF16>
__global__ void __launch_bounds__(DA_NW * 32) decode_gqa_kernel(
    const float* __restrict__ qg, const void* __restrict__ kc,
    const void* __restrict__ vc, const int* __restrict__ pos, int Hkv, int G,
    int S, int nsplit, float scale, int swa, float logit_cap,
    float* __restrict__ part) {
  const int b = blockIdx.x, h = blockIdx.y, sp = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  __shared__ float qs[DA_MAXG][DA_D];
  __shared__ float wm[DA_NW][DA_MAXG], wl[DA_NW][DA_MAXG];
  __shared__ float wacc[DA_NW][DA_MAXG][DA_D];

  for (int e = tid; e < G * DA_D; e += DA_NW * 32)
    qs[e / DA_D][e % DA_D] =
        __fmul_rn(qg[((size_t)b * Hkv + h) * G * DA_D + e], scale);
  __syncthreads();

  int lo, hi;
  bool dead;
  live_range(pos[b], S, swa, lo, hi, dead);
  const int len = (hi - lo + nsplit) / nsplit;   // slots a split
  const int a0 = lo + sp * len, a1 = min(hi + 1, a0 + len);

  float m[DA_MAXG], l[DA_MAXG], acc[DA_MAXG][4];
#pragma unroll
  for (int g = 0; g < DA_MAXG; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;
  }
  const size_t HD = (size_t)Hkv * DA_D;
  for (int t = a0 + warp; t < a1; t += DA_NW) {
    const size_t off = ((size_t)b * S + t) * HD + (size_t)h * DA_D + lane * 4;
    float kv4[4], vv4[4];
    if constexpr (BF16) {
      const uint2 kw = __ldg(reinterpret_cast<const uint2*>((const uint16_t*)kc + off));
      const uint2 vw = __ldg(reinterpret_cast<const uint2*>((const uint16_t*)vc + off));
      kv4[0] = bf2f(kw.x & 0xffff); kv4[1] = bf2f(kw.x >> 16);
      kv4[2] = bf2f(kw.y & 0xffff); kv4[3] = bf2f(kw.y >> 16);
      vv4[0] = bf2f(vw.x & 0xffff); vv4[1] = bf2f(vw.x >> 16);
      vv4[2] = bf2f(vw.y & 0xffff); vv4[3] = bf2f(vw.y >> 16);
    } else {
      const float4 kw = __ldg(reinterpret_cast<const float4*>((const float*)kc + off));
      const float4 vw = __ldg(reinterpret_cast<const float4*>((const float*)vc + off));
      kv4[0] = kw.x; kv4[1] = kw.y; kv4[2] = kw.z; kv4[3] = kw.w;
      vv4[0] = vw.x; vv4[1] = vw.y; vv4[2] = vw.z; vv4[3] = vw.w;
    }
#pragma unroll
    for (int g = 0; g < DA_MAXG; ++g) {
      if (g >= G) break;
      float part_ = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) part_ += qs[g][lane * 4 + e] * kv4[e];
      float s = warp_sum(part_);
      if (logit_cap != 0.f) s = tanhf(s / logit_cap) * logit_cap;
      if (dead) s = NEG_INF;
      const float m_new = fmaxf(m[g], s);
      const float alpha = expf(m[g] - m_new);
      const float pr = expf(s - m_new);
      l[g] = l[g] * alpha + pr;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][e] = acc[g][e] * alpha + pr * vv4[e];
      m[g] = m_new;
    }
  }
#pragma unroll
  for (int g = 0; g < DA_MAXG; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      wm[warp][g] = m[g];
      wl[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) wacc[warp][g][lane * 4 + e] = acc[g][e];
  }
  __syncthreads();

  // the block's partial per query head: (max, denominator, acc[D])
  float* rec = part + (((size_t)b * Hkv + h) * nsplit + sp) * G * DA_PW;
  for (int e = tid; e < G * DA_D; e += DA_NW * 32) {
    const int g = e / DA_D, d = e % DA_D;
    float M = NEG_INF;
    for (int w = 0; w < DA_NW; ++w) M = fmaxf(M, wm[w][g]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < DA_NW; ++w) {
      const float f = expf(wm[w][g] - M);
      L += wl[w][g] * f;
      A += wacc[w][g][d] * f;
    }
    rec[g * DA_PW + 2 + d] = A;
    if (d == 0) {
      rec[g * DA_PW] = M;
      rec[g * DA_PW + 1] = L;
    }
  }
}

__global__ void __launch_bounds__(DA_D) decode_gqa_merge(
    const float* __restrict__ part, int Hkv, int G, int nsplit,
    float* __restrict__ out) {
  const int bh = blockIdx.x, g = blockIdx.y, d = threadIdx.x;
  const float* rec = part + (size_t)bh * nsplit * G * DA_PW + g * DA_PW;
  float M = NEG_INF;
  for (int sp = 0; sp < nsplit; ++sp) M = fmaxf(M, rec[(size_t)sp * G * DA_PW]);
  float L = 0.f, A = 0.f;
  for (int sp = 0; sp < nsplit; ++sp) {
    const float* r = rec + (size_t)sp * G * DA_PW;
    const float f = expf(r[0] - M);
    L += r[1] * f;
    A += r[2 + d] * f;
  }
  out[((size_t)bh * G + g) * DA_D + d] = A / fmaxf(L, 1e-30f);
}

}  // namespace

extern "C" {

const char* ght_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// K11: q [B,H,T,D], k/v [B,H,S,D], all f32 (bf16 != 0: all bf16), D a
// multiple of 32 up to 128; mask f32 read at b*msb + h*msh + t*mst + s*mss
// (elements); out f32 [B,H,T,D].
int flash_attn_run(const void* q, const void* k, const void* v,
                   const float* mask, long long msb, long long msh,
                   long long mst, long long mss, int B, int H, int T, int S,
                   int D, float scale, int bf16, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || H < 1 || T < 1 || S < 1 || D % 32 || D > FA_DMAX)
    return (int)cudaErrorInvalidValue;
  static bool attr_set[2] = {false, false};
  if (!attr_set[bf16 != 0]) {
    const cudaError_t e = cudaFuncSetAttribute(
        bf16 ? (const void*)flash_attn_kernel<true> : (const void*)flash_attn_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, fa_smem(FA_DMAX));
    if (e != cudaSuccess) return (int)e;
    attr_set[bf16 != 0] = true;
  }
  dim3 grid((T + FA_TQ - 1) / FA_TQ, B * H);
  if (bf16) {
    flash_attn_kernel<true><<<grid, FA_NW * 32, fa_smem(D), s>>>(
        q, k, v, mask, msb, msh, mst, mss, H, T, S, D, scale, out);
  } else {
    flash_attn_kernel<false><<<grid, FA_NW * 32, fa_smem(D), s>>>(
        q, k, v, mask, msb, msh, mst, mss, H, T, S, D, scale, out);
  }
  return (int)cudaGetLastError();
}

// K12: qg f32 [B,Hkv,G,128]; caches [B,S,Hkv,128] bf16 (bf16 != 0) or f32;
// pos int32 [B]; part f32 scratch [B,Hkv,nsplit,G,130]; out f32
// [B,Hkv,G,128].
int decode_attn_gqa_run(const float* qg, const void* kc, const void* vc,
                        const int* pos, int B, int Hkv, int G, int S,
                        int nsplit, float scale, int swa, float logit_cap,
                        int bf16, float* part, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || Hkv < 1 || G < 1 || G > DA_MAXG || S < 1 || nsplit < 1)
    return (int)cudaErrorInvalidValue;
  dim3 grid(B, Hkv, nsplit);
  if (bf16) {
    decode_gqa_kernel<true><<<grid, DA_NW * 32, 0, s>>>(
        qg, kc, vc, pos, Hkv, G, S, nsplit, scale, swa, logit_cap, part);
  } else {
    decode_gqa_kernel<false><<<grid, DA_NW * 32, 0, s>>>(
        qg, kc, vc, pos, Hkv, G, S, nsplit, scale, swa, logit_cap, part);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  decode_gqa_merge<<<dim3(B * Hkv, G), DA_D, 0, s>>>(part, Hkv, G, nsplit, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
