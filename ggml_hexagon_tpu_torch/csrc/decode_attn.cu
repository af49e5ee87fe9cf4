// K4: fused single-token decode attention, for sm_90a.
//
// Replaces ggml_hexagon_tpu/ops/decode_attn.py `_kernel_single` (one KV
// chunk) and `_kernel` (online softmax over chunks), launched through
// `pallas_call` in `fused_decode_attention`.
//
// What bounds it: bytes.  Each (row, KV head) reads its live cache rows of
// K and V once (2 x live x D x 2 bytes for a bf16 cache, half that for
// int8) and does ~4 flops per byte read.  At decode sizes the bytes are
// few (a step at pos 700 reads 2.9 MB in all), so what the card can reach
// is set by how many SMs take part and how little each waits (at the
// first positions of a cache the fixed cost of two launches dominates).
//
// Design (flash-decoding: split the live slots, merge the partials):
//  * A template instance a head width D (128, or 256 for Gemma-class
//    models) and cache type; a block has D threads (D / 32 warps), thread
//    d owning head dim d in the rope and in P.V.  Everything sized by the
//    row follows D: the K-row pitch, the partials' records, the merge.  A
//    bf16 cache at D = 256 takes 77 KB of shared memory a block (two
//    double-buffered 32-slot tiles of 512-byte K and V rows), past the 48
//    KB of static shared memory: that instance takes it as dynamic shared
//    memory, two blocks an SM; the others keep static arrays.
//  * Grid (nsplit, Hkv, B).  The host picks nsplit from the shapes alone
//    (kernels._pick_nsplit: two blocks an SM at B=1 for the 8B's 8 KV
//    heads); each block divides row b's live range [lo, pos[b]) (lo > 0
//    under a sliding window) on the card, so the host never reads pos.
//  * Every block ropes its group's fresh q heads (NEOX pairing, cos/sin
//    computed outside, as on the TPU) into shared memory and scales them.
//    Split 0 also ropes the fresh k row and writes k and v out (the caller
//    writes them into the cache after the layer loop), and writes the
//    fresh row's self-term as one more partial (max = its score,
//    denominator 1, accumulator = v): it never touched the cache.
//  * The block walks its slots in tiles of 32, double-buffered: the K and
//    V rows of the next tile arrive by 16-byte cp.async while the current
//    one is used (the first tile's copies go out before the rope).
//    Scores: warp w takes query heads w and w + D/32, lane t slot t, a
//    D-long dot over shared memory (K rows pitched 16 bytes past their
//    length, 16 or 80 mod 128, so the 16-byte reads of 8 neighbouring
//    lanes fall in 8 distinct bank groups at every row width).  One
//    online-softmax update per tile and head (one warp max and one warp
//    sum), then P.V with thread d owning head dim d of every head.
//  * int8 KV: the per-row K scale multiplies the raw score and the per-row
//    V scale the probability (after the denominator took it), as the TPU
//    kernel does, so no dequantized cache exists.  -1e30 stays the finite
//    "minus infinity".
//  * int4 KV (the q4_0 cache; the TPU kernel takes jnp.int4 caches): the
//    same math on 4-bit values packed two a byte, dim 2i in the low nibble
//    of byte i (models/llama.init_kv_cache): a row is D/2 bytes, D/32
//    16-byte cp.async chunks, and each nibble is sign-extended in
//    registers by a shift pair.  Half the int8 cache's bytes.
//  * Each block writes a partial (max, denominator, acc[D]) per head; a
//    second small kernel in the same entry merges the nsplit + 1 partials
//    of each (row, KV head) and divides, one block per query head.  It is
//    launched as a programmatic dependent (PDL), so its launch overlaps
//    the split kernel's run.  The TPU's block-diagonal q was a
//    matrix-unit device and is not carried over.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TS = 32;     // cache slots a tile
constexpr int MAXG = 8;    // query heads per KV head
constexpr float NEG_INF = -1e30f;

// partial record: max, denominator, acc[D]
__host__ __device__ constexpr int rec_width(int D) { return D + 2; }

// A split block's shared memory at head width D and cache BITS: K rows
// pitched RB + 16 bytes (RB the row's bytes), V rows RB, both double
// buffered; the group's scaled q heads, the fresh k row, a tile's
// probabilities and each head's rescale factor.
template <int D, int BITS>
struct SplitSmem {
  static constexpr int RB = D * BITS / 8;
  static constexpr int KP = RB + 16;
  alignas(16) unsigned char ks[2][TS * KP];
  alignas(16) unsigned char vs[2][TS * RB];
  alignas(16) float qs[MAXG][D];
  float kf[D];
  float ps[MAXG][TS];
  float alpha_s[MAXG];
};

template <int D, int BITS>
__host__ __device__ constexpr bool dynamic_smem() {
  return sizeof(SplitSmem<D, BITS>) > 48 * 1024;
}

__device__ __forceinline__ float bf2f(uint32_t v) { return __uint_as_float(v << 16); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// nibble k (bits 4k..4k+3) of w as a two's-complement value
__device__ __forceinline__ float nib(uint32_t w, int k) {
  return (float)((int32_t)(w << (28 - 4 * k)) >> 28);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// D: the head width (128 or 256); BITS: 16 (bf16 cache), 8 (int8) or 4
// (packed int4), each with its row scales kd/vd when below 16
template <int D, int BITS>
__global__ void __launch_bounds__(D) decode_attn_split_kernel(
    const float* __restrict__ qkv, const void* __restrict__ kc,
    const void* __restrict__ vc, const float* __restrict__ kd,
    const float* __restrict__ vd, const int* __restrict__ pos,
    const float* __restrict__ cos_sin, int Hq, int Hkv, int S, int n_dims,
    float scale, int swa, float logit_cap, int nsplit,
    float* __restrict__ part, float* __restrict__ k_out,
    float* __restrict__ v_out) {
  constexpr int NW = D / 32;                  // warps a block
  constexpr int PW = rec_width(D);
  constexpr bool QUANT = BITS < 16;
  using Sm = SplitSmem<D, BITS>;
  constexpr int RB = Sm::RB;                  // bytes a cache row
  constexpr int KP = Sm::KP;
  constexpr int VP = RB;
  constexpr int CH = RB / 16;                 // 16-byte chunks a row
  // the merge kernel's blocks may start now; they wait for this grid
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  Sm* sm;
  if constexpr (dynamic_smem<D, BITS>()) {
    extern __shared__ __align__(16) unsigned char dyn_smem[];
    sm = reinterpret_cast<Sm*>(dyn_smem);
  } else {
    __shared__ Sm st;
    sm = &st;
  }
  auto& ks = sm->ks;
  auto& vs = sm->vs;
  auto& qs = sm->qs;
  auto& kf = sm->kf;
  auto& ps = sm->ps;
  auto& alpha_s = sm->alpha_s;
  const int sp = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // this split's slots [a0, a1) of the live range [lo, p)
  const int p = min(pos[b], S);
  const int lo = swa > 0 ? max(0, p - swa + 1) : 0;
  const int n = max(0, p - lo);
  const int len = (n + nsplit - 1) / nsplit;
  const int a0 = lo + sp * len, a1 = min(p, a0 + len);
  const int ntile = a1 > a0 ? (a1 - a0 + TS - 1) / TS : 0;
  const size_t HD = (size_t)Hkv * D;

  auto load_tile = [&](int i, int buf) {
    const int t0 = a0 + i * TS;
    const int rows = min(TS, a1 - t0);
    for (int e = tid; e < rows * CH; e += NW * 32) {
      const int r = e / CH, c = e % CH;
      const size_t e0 = ((size_t)b * S + t0 + r) * HD + (size_t)h * D;
      const size_t off = (BITS == 4 ? e0 / 2 : e0 * (BITS / 8)) + 16 * c;
      cp_async16(&ks[buf][r * KP + 16 * c], (const unsigned char*)kc + off);
      cp_async16(&vs[buf][r * VP + 16 * c], (const unsigned char*)vc + off);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  if (ntile > 0) load_tile(0, 0);   // in flight while q is roped

  // thread d ropes dim d of the group's q heads (and, in split 0, of k)
  const int W = (Hq + 2 * Hkv) * D;
  const float* row = qkv + (size_t)b * W;
  const int half = n_dims / 2;
  const int d = tid;                       // NW * 32 == D
  const bool rot = cos_sin != nullptr && d < n_dims;
  const int pd = d < half ? d + half : d - half;   // its NEOX partner
  float cs_c = 1.f, cs_s = 0.f;
  if (rot) {
    const float* cs = cos_sin + (size_t)b * 2 * half;
    cs_c = cs[d < half ? d : pd];
    cs_s = cs[half + (d < half ? d : pd)];
  }
  const int nrope = sp == 0 ? G + 1 : G;   // split 0 also ropes k
#pragma unroll
  for (int hh = 0; hh < MAXG + 1; ++hh) {
    if (hh >= nrope) break;
    const float* src = hh < G ? row + (size_t)(h * G + hh) * D : row + (size_t)(Hq + h) * D;
    float v = src[d];
    if (rot) {
      v = d < half ? __fsub_rn(__fmul_rn(v, cs_c), __fmul_rn(src[pd], cs_s))
                   : __fadd_rn(__fmul_rn(src[pd], cs_s), __fmul_rn(v, cs_c));
    }
    if (hh < G) {
      qs[hh][d] = __fmul_rn(v, scale);
    } else {
      kf[d] = v;
      k_out[((size_t)b * Hkv + h) * D + d] = v;
    }
  }
  if (sp == 0) v_out[((size_t)b * Hkv + h) * D + d] = row[(size_t)(Hq + Hkv + h) * D + d];

  __syncthreads();   // q (and kf) ready

  float* rec = part + ((size_t)b * Hkv + h) * (nsplit + 1) * G * PW;
  if (sp == 0) {  // the fresh row's self-term, as partial nsplit
    constexpr int DL = D / 32;  // dims a lane
    for (int g = warp; g < G; g += NW) {
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < DL; ++e) s += qs[g][lane * DL + e] * kf[lane * DL + e];
      s = warp_sum(s);
      if (logit_cap != 0.f) s = tanhf(s / logit_cap) * logit_cap;
      if (lane == 0) {
        rec[((size_t)nsplit * G + g) * PW] = s;
        rec[((size_t)nsplit * G + g) * PW + 1] = 1.f;
      }
    }
    for (int e = tid; e < G * D; e += NW * 32)
      rec[((size_t)nsplit * G + e / D) * PW + 2 + e % D] =
          row[(size_t)(Hq + Hkv + h) * D + e % D];
  }

  // warp w scores heads w and w + NW (NW >= 4, so two cover MAXG)
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) acc[g] = 0.f;

  for (int i = 0; i < ntile; ++i) {
    const int buf = i & 1;
    if (i + 1 < ntile) {
      load_tile(i + 1, buf ^ 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const int t0 = a0 + i * TS;
    const int rows = min(TS, a1 - t0);
    const bool valid = lane < rows;
    const float ksl = QUANT && valid ? kd[(size_t)b * S + t0 + lane] : 1.f;
    const float vsl = QUANT && valid ? vd[(size_t)b * S + t0 + lane] : 1.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int g = warp + NW * j;
      if (g >= G) break;
      float s = 0.f;
      if (valid) {
        const float4* q4 = reinterpret_cast<const float4*>(qs[g]);
        const uint4* k16 = reinterpret_cast<const uint4*>(&ks[buf][lane * KP]);
        float sv[4] = {0.f, 0.f, 0.f, 0.f};   // four chains, not one
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const uint4 w = k16[c];
          const uint32_t ww[4] = {w.x, w.y, w.z, w.w};
          if constexpr (BITS == 4) {
            // word u of chunk c: dims 32c + 8u .. 32c + 8u + 7
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const float4 qa = q4[c * 8 + u * 2];
              const float4 qb = q4[c * 8 + u * 2 + 1];
              sv[u] += qa.x * nib(ww[u], 0) + qa.y * nib(ww[u], 1) +
                       qa.z * nib(ww[u], 2) + qa.w * nib(ww[u], 3) +
                       qb.x * nib(ww[u], 4) + qb.y * nib(ww[u], 5) +
                       qb.z * nib(ww[u], 6) + qb.w * nib(ww[u], 7);
            }
          } else if constexpr (BITS == 8) {
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const float4 qv = q4[c * 4 + u];
              sv[u] += qv.x * (float)(int8_t)(ww[u] & 0xff) +
                       qv.y * (float)(int8_t)((ww[u] >> 8) & 0xff) +
                       qv.z * (float)(int8_t)((ww[u] >> 16) & 0xff) +
                       qv.w * (float)(int8_t)(ww[u] >> 24);
            }
          } else {
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const float4 qv = q4[c * 2 + u];
              sv[(2 * c + u) & 3] += qv.x * bf2f(ww[2 * u] & 0xffffu) +
                                     qv.y * bf2f(ww[2 * u] >> 16) +
                                     qv.z * bf2f(ww[2 * u + 1] & 0xffffu) +
                                     qv.w * bf2f(ww[2 * u + 1] >> 16);
            }
          }
        }
        s = (sv[0] + sv[1]) + (sv[2] + sv[3]);
        if (QUANT) s = s * ksl;
        if (logit_cap != 0.f) s = tanhf(s / logit_cap) * logit_cap;
      } else {
        s = NEG_INF;
      }
      const float m_new = fmaxf(m[j], warp_max(s));
      const float alpha = expf(m[j] - m_new);
      float pr = valid ? expf(s - m_new) : 0.f;
      l[j] = l[j] * alpha + warp_sum(pr);
      m[j] = m_new;
      if (QUANT) pr = pr * vsl;
      ps[g][lane] = pr;
      if (lane == 0) alpha_s[g] = alpha;
    }
    __syncthreads();
    {
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g >= G) break;
        float a = acc[g] * alpha_s[g];
        for (int r = 0; r < rows; ++r) {
          float v;
          if constexpr (BITS == 4) v = nib(vs[buf][r * VP + (d >> 1)], d & 1);
          else if constexpr (BITS == 8) v = (float)(int8_t)vs[buf][r * VP + d];
          else v = bf2f(*reinterpret_cast<const uint16_t*>(&vs[buf][r * VP + 2 * d]));
          a += ps[g][r] * v;
        }
        acc[g] = a;
      }
    }
    __syncthreads();
  }

  float* mine = rec + (size_t)sp * G * PW;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int g = warp + NW * j;
    if (g < G && lane == 0) {
      mine[g * PW] = m[j];
      mine[g * PW + 1] = l[j];
    }
  }
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g >= G) break;
    mine[g * PW + 2 + tid] = acc[g];
  }

}

// out[b, (h*G + g)*D + d] from the nsplit + 1 partials of (b, h, g): the
// records' maxima and denominators are read in parallel, one a thread,
// then every thread sums its dim over the records.  Launched as a
// programmatic dependent of the split kernel: its blocks start while the
// splits run and wait here until their partials are complete and visible.
template <int D>
__global__ void __launch_bounds__(D) decode_attn_merge(
    const float* __restrict__ part, int G, int nrec, float* __restrict__ out) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  constexpr int PW = rec_width(D);
  const int bh = blockIdx.x, g = blockIdx.y, d = threadIdx.x;
  const int warp = d >> 5, lane = d & 31;
  extern __shared__ float wrec[];  // [nrec] weights of the records
  __shared__ float red[D / 32];
  const float* rec = part + (size_t)bh * nrec * G * PW + g * PW;
  const size_t RS = (size_t)G * PW;  // record stride
  float M = NEG_INF;
  for (int r = d; r < nrec; r += D) M = fmaxf(M, rec[r * RS]);
  M = warp_max(M);
  if (lane == 0) red[warp] = M;
  __syncthreads();
  M = red[0];
#pragma unroll
  for (int w = 1; w < D / 32; ++w) M = fmaxf(M, red[w]);
  __syncthreads();
  float L = 0.f;
  for (int r = d; r < nrec; r += D) {
    const float f = expf(rec[r * RS] - M);
    wrec[r] = f;
    L += rec[r * RS + 1] * f;
  }
  L = warp_sum(L);
  if (lane == 0) red[warp] = L;
  __syncthreads();
  L = 0.f;
#pragma unroll
  for (int w = 0; w < D / 32; ++w) L += red[w];
  float A = 0.f;
#pragma unroll 8
  for (int r = 0; r < nrec; ++r) A += rec[r * RS + 2 + d] * wrec[r];
  out[((size_t)bh * G + g) * D + d] = A / fmaxf(L, 1e-30f);
}

template <int D, int BITS>
int launch_split(dim3 grid, cudaStream_t s, const float* qkv, const void* kc, const void* vc,
                 const float* kd, const float* vd, const int* pos, const float* cos_sin, int Hq,
                 int Hkv, int S, int n_dims, float scale, int swa, float logit_cap, int nsplit,
                 float* part, float* k_out, float* v_out) {
  auto kern = decode_attn_split_kernel<D, BITS>;
  size_t smem = 0;
  if constexpr (dynamic_smem<D, BITS>()) {
    static bool attr_set = false;
    smem = sizeof(SplitSmem<D, BITS>);
    if (!attr_set) {
      const cudaError_t e =
          cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
      attr_set = true;
    }
  }
  kern<<<grid, D, smem, s>>>(qkv, kc, vc, kd, vd, pos, cos_sin, Hq, Hkv, S, n_dims, scale, swa,
                             logit_cap, nsplit, part, k_out, v_out);
  return (int)cudaGetLastError();
}

template <int D>
int run(int B, int Hq, int Hkv, int bits, int nsplit, cudaStream_t s, const float* qkv,
        const void* kc, const void* vc, const float* kd, const float* vd, const int* pos,
        const float* cos_sin, int S, int n_dims, float scale, int swa, float logit_cap,
        float* part, float* out, float* k_out, float* v_out) {
  const int G = Hq / Hkv;
  const dim3 grid(nsplit, Hkv, B);
  int e;
  if (bits == 4)
    e = launch_split<D, 4>(grid, s, qkv, kc, vc, kd, vd, pos, cos_sin, Hq, Hkv, S, n_dims, scale,
                           swa, logit_cap, nsplit, part, k_out, v_out);
  else if (bits == 8)
    e = launch_split<D, 8>(grid, s, qkv, kc, vc, kd, vd, pos, cos_sin, Hq, Hkv, S, n_dims, scale,
                           swa, logit_cap, nsplit, part, k_out, v_out);
  else
    e = launch_split<D, 16>(grid, s, qkv, kc, vc, kd, vd, pos, cos_sin, Hq, Hkv, S, n_dims,
                            scale, swa, logit_cap, nsplit, part, k_out, v_out);
  if (e != 0) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * Hkv, G);
  cfg.blockDim = dim3(D);
  cfg.dynamicSmemBytes = (nsplit + 1) * sizeof(float);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t ce =
      cudaLaunchKernelEx(&cfg, decode_attn_merge<D>, (const float*)part, G, nsplit + 1, out);
  if (ce != cudaSuccess) return (int)ce;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ght_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// qkv f32 [B, (Hq+2Hkv)*D], D the head width (128 or 256); caches [B, S,
// Hkv*D] bf16 (bits == 16) or int8 (bits == 8) with f32 row scales kd/vd
// [B, S], or [B, S, Hkv*D/2] bytes of packed int4 (bits == 4) with the same
// scales; pos int32 [B]; cos_sin f32 [B, n_dims] (cos ++ sin) or null for
// no rope; part f32 scratch [B, Hkv, nsplit + 1, G, D + 2].  Outputs f32:
// out [B, Hq*D], k_out/v_out [B, Hkv*D].
int decode_attn_run(const float* qkv, const void* kc, const void* vc,
                    const float* kd, const float* vd, const int* pos,
                    const float* cos_sin, int B, int Hq, int Hkv, int S, int D,
                    int n_dims, float scale, int swa, float logit_cap,
                    int bits, int nsplit, float* part, float* out,
                    float* k_out, float* v_out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || Hkv < 1 || Hq % Hkv || Hq / Hkv > MAXG || (D != 128 && D != 256) ||
      n_dims > D || n_dims % 2 || nsplit < 1 || (bits != 16 && bits != 8 && bits != 4))
    return (int)cudaErrorInvalidValue;
  if (D == 256)
    return run<256>(B, Hq, Hkv, bits, nsplit, s, qkv, kc, vc, kd, vd, pos, cos_sin, S, n_dims,
                    scale, swa, logit_cap, part, out, k_out, v_out);
  return run<128>(B, Hq, Hkv, bits, nsplit, s, qkv, kc, vc, kd, vd, pos, cos_sin, S, n_dims,
                  scale, swa, logit_cap, part, out, k_out, v_out);
}

}  // extern "C"
