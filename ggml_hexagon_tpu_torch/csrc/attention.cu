// K11 (masked flash attention) and K12 (single-token GQA cache
// attention), for sm_90a.
//
// K11 replaces ggml_hexagon_tpu/ops/attention.py `_flash_kernel`, launched
// through `pallas_call` in `flash_attention_pallas`.  What bounds it:
// operations.  Its contract is f32 attention (f32 q*scale, k and v
// products, f32 scores, softmax and output; the finite -1e30 mask value),
// 4*B*H*T*S*D multiply-add flops; the bytes (q, k, v, the mask as given,
// the output) are a few MB.
//
// Design (FlashAttention-2 on mma.sync):
//  * One block per (batch*head, 128 query rows), 8 warps of 16 rows.  q *
//    scale is staged once in shared memory (f32); k, v and the mask tile
//    come in tiles of 32 slots, double-buffered by cp.async (zeros past S;
//    the mask read through its strides, 16-byte copies where its rows are
//    contiguous: a [1,1,T,S] mask is never materialised).
//  * Scores and p.v are TF32 mma.sync m16n8k8 with f32 sums, each operand
//    split into big = rna(x) and small = rna(x - big): three products
//    (small*big, big*small, big*big), so each product is the f32 one to
//    about 2^-22.  bf16 k and v are exact in TF32: two products.  The
//    scores sum even and odd head-dim steps in two accumulators.
//  * An online softmax per row in registers (f32 running max, this
//    thread's part of the denominator, expf), as the TPU kernel runs one
//    per KV chunk: the results agree to f32 rounding.  A row whose slots
//    are all masked averages v (-1e30 is finite); slots past S take p = 0.
//  * p.v takes the score accumulators as its A fragments with no shuffle:
//    the mma's k index is permuted (k = t <-> slot 2t, k = t + 4 <-> slot
//    2t + 1, which is where the accumulator layout holds them) and v's
//    rows are read in the same order.
//
// K12 replaces ggml_hexagon_tpu/ops/attention.py `_decode_attn_kernel`,
// launched through `pallas_call` in `decode_attention_pallas`.  What bounds
// it: bytes, the live cache rows of K and V read once (the slots with
// idx <= pos, and pos - idx < swa), at ~2 flops a byte per query head.
//
// Design: the TPU cell takes one batch row and unrolls the KV heads; here
// one launch gives each (row, KV head) a thread-block cluster of nsplit
// blocks (kernels.pick_gqa_splits: one wave of clusters on the card, at
// most 8, from the shapes alone), and each block an equal share of the
// row's live slots, found on the card from pos (the position never reaches
// the host).  A block stages its share's k rows, then its v rows, in
// chunks of 128 slots through a ring of cp.async stages (all of a short
// share in flight at once: one DRAM round trip, not one a slot); it scores
// every staged slot (f32 q * scale against the f32 of the cache, four
// lanes a slot, each a quarter of the dims of every query head, summed by
// two shuffles), takes the max once a head, then p = exp(s - max), its sum,
// and p.v in one pass (a thread two head dims of every head over a quarter
// of the rows, the quarters summed at the end); a share above 512 slots
// runs in passes of 512, each rescaling the running sums once.  The block writes its record
// (max, denominator, accumulator a query head) into rank 0's shared memory
// through distributed shared memory; after one cluster barrier rank 0
// merges the records in rank order and writes the output, and the other
// blocks are done: no partials in device memory, no second launch, no
// counter.  The G query heads of a
// group share each staged row.  Masked slots are skipped, which equals the
// TPU's softmax over every slot (exp(-1e30 - max) is 0), unless no slot is
// live: then every slot takes the -1e30 score and the result is the mean of
// v, as on the TPU.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace cg = cooperative_groups;

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

constexpr int FA_TQ = 128;            // query rows a block, 16 a warp
constexpr int FA_KT = 32;             // key slots a tile
constexpr int FA_NW = FA_TQ / 16;     // warps a block
constexpr int FA_NT = FA_NW * 32;
constexpr int FA_MP = FA_KT + 8;      // mask tile pitch (floats)

// The block's shared memory: q * scale (FA_TQ rows of D f32, pitch D + 4),
// then two stages, double-buffered by cp.async, each the k and v tiles
// (FA_KT rows of D, pitch KP elements) and the mask tile (FA_TQ rows of
// FA_KT), then (f32 inputs) the small TF32 parts of the current k and v
// tiles, whose big parts replace the stage's values in place; the pitches
// keep a fragment's loads off any bank twice.
template <int D, bool BF16>
struct FaTile {
  static constexpr int ES = BF16 ? 2 : 4;
  static constexpr int QP = D + 4;
  static constexpr int Q = FA_TQ * QP * 4;
  static constexpr int KP = BF16 ? D + 8 : D + 4;
  static constexpr int KV = FA_KT * KP * ES;
  static constexpr int MASK = FA_TQ * FA_MP * 4;
  static constexpr int STAGE = 2 * KV + MASK;
  static constexpr int SMALL = BF16 ? 0 : 2 * KV;
  static constexpr int SMEM = Q + 2 * STAGE + SMALL;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, both TF32 (round to nearest, ties away): x - big is
// exact in f32, and what small drops is 2^-22 of x or less.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// d += A B, m16n8k8 TF32 (f32 sums): A 16 x 8 (a0: row g, k t; a1: row
// g + 8, k t; a2: row g, k t + 4; a3: row g + 8, k t + 4), B 8 x 8 (b0: k
// t, b1: k t + 4; column g).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <bool BF16>
__device__ __forceinline__ float lds_el(const void* base, int i) {
  if constexpr (BF16) {
    return bf2f(reinterpret_cast<const uint16_t*>(base)[i]);
  } else {
    return reinterpret_cast<const float*>(base)[i];
  }
}

// d += X Y with X (the A operand) split and Y (the B operand: elements e
// and e + off of the tile at `big`, and of its small parts at `small`):
// three TF32 products for f32 inputs (small terms first), two for bf16
// ones (exact in TF32: no small part).
template <bool BF16>
__device__ __forceinline__ void mma_3x(float (&d)[4], const uint32_t (&ab)[4],
                                       const uint32_t (&as)[4], const void* big,
                                       const void* small, int e, int off) {
  if constexpr (BF16) {
    const uint32_t b0 = __float_as_uint(lds_el<true>(big, e));
    const uint32_t b1 = __float_as_uint(lds_el<true>(big, e + off));
    mma_tf32(d, as, b0, b1);
    mma_tf32(d, ab, b0, b1);
  } else {
    const uint32_t* bb = reinterpret_cast<const uint32_t*>(big);
    const uint32_t* bs = reinterpret_cast<const uint32_t*>(small);
    mma_tf32(d, as, bb[e], bb[e + off]);
    mma_tf32(d, ab, bs[e], bs[e + off]);
    mma_tf32(d, ab, bb[e], bb[e + off]);
  }
}

template <int D, bool BF16>
__global__ void __launch_bounds__(FA_NT, 1) flash_attn_kernel(
    const void* __restrict__ q, const void* __restrict__ k, const void* __restrict__ v,
    const float* __restrict__ mask, long long msb, long long msh, long long mst, long long mss,
    int mvec, int H, int T, int S, float scale, float* __restrict__ out) {
  using Tl = FaTile<D, BF16>;
  constexpr int KP = Tl::KP, QP = Tl::QP, ND = D / 8;
  extern __shared__ __align__(16) unsigned char sm[];
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int t0 = blockIdx.x * FA_TQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const size_t qbase = (size_t)bh * T * D, kvbase = (size_t)bh * S * D;
  const float* mrow = mask + b * msb + h * msh;

  // q * scale (f32, as the reference rounds it); rows past T are zeros
  float* qs = reinterpret_cast<float*>(sm);
  for (int e = tid; e < FA_TQ * D; e += FA_NT) {
    const int r = e / D, d = e - r * D, t = t0 + r;
    qs[r * QP + d] = t < T ? __fmul_rn(ld<BF16>(q, qbase + (size_t)t * D + d), scale) : 0.f;
  }

  // one stage's copies: k and v rows (zeros past S), the mask tile (rows
  // past T repeat row T - 1; slots past S are not read)
  auto load_tile = [&](int stage, int s0) {
    unsigned char* st = sm + Tl::Q + stage * Tl::STAGE;
    constexpr int CPR = D * Tl::ES / 16;  // 16-byte chunks a row
    for (int c = tid; c < FA_KT * CPR; c += FA_NT) {
      const int j = c / CPR, cc = c - j * CPR, slot = s0 + j;
      const int bytes = slot < S ? 16 : 0;
      const size_t el = kvbase + (size_t)min(slot, S - 1) * D;
      const uint32_t dst = smem_addr(st) + j * KP * Tl::ES + cc * 16;
      cp_async16(dst, reinterpret_cast<const unsigned char*>(k) + el * Tl::ES + cc * 16, bytes);
      cp_async16(dst + Tl::KV, reinterpret_cast<const unsigned char*>(v) + el * Tl::ES + cc * 16,
                 bytes);
    }
    const uint32_t ms = smem_addr(st + 2 * Tl::KV);
    if (mvec) {
      for (int c = tid; c < FA_TQ * FA_KT / 4; c += FA_NT) {
        const int r = c / (FA_KT / 4), cc = c - r * (FA_KT / 4), slot = s0 + 4 * cc;
        const int t = min(t0 + r, T - 1);
        cp_async16(ms + (r * FA_MP + 4 * cc) * 4, mrow + t * mst + min(slot, S - 4),
                   slot < S ? 16 : 0);
      }
    } else {
      for (int c = tid; c < FA_TQ * FA_KT; c += FA_NT) {
        const int r = c / FA_KT, j = c - r * FA_KT, slot = s0 + j;
        if (slot < S) cp_async4(ms + (r * FA_MP + j) * 4, mrow + min(t0 + r, T - 1) * mst + slot * mss);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
  float o[ND][4];
#pragma unroll
  for (int dn = 0; dn < ND; ++dn)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[dn][c] = 0.f;

  const int ntiles = (S + FA_KT - 1) / FA_KT;
  load_tile(0, 0);
  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {
      load_tile((it + 1) & 1, (it + 1) * FA_KT);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    unsigned char* st = sm + Tl::Q + (it & 1) * Tl::STAGE;
    const void* ks = st;
    const void* vs = st + Tl::KV;
    const void* kss = sm + Tl::Q + 2 * Tl::STAGE;  // f32: the small parts
    const void* vss = sm + Tl::Q + 2 * Tl::STAGE + Tl::KV;
    const float* ms = reinterpret_cast<const float*>(st + 2 * Tl::KV);
    const int s0 = it * FA_KT;
    if constexpr (!BF16) {
      // split the k and v tiles once for every warp: big in place, small
      // beside
      float4* kv = reinterpret_cast<float4*>(st);
      float4* sp = reinterpret_cast<float4*>(sm + Tl::Q + 2 * Tl::STAGE);
      for (int c = tid; c < 2 * FA_KT * KP / 4; c += FA_NT) {
        const float4 x = kv[c];
        uint32_t b[4], s_[4];
        split_tf32(x.x, b[0], s_[0]);
        split_tf32(x.y, b[1], s_[1]);
        split_tf32(x.z, b[2], s_[2]);
        split_tf32(x.w, b[3], s_[3]);
        kv[c] = make_float4(__uint_as_float(b[0]), __uint_as_float(b[1]),
                            __uint_as_float(b[2]), __uint_as_float(b[3]));
        sp[c] = make_float4(__uint_as_float(s_[0]), __uint_as_float(s_[1]),
                            __uint_as_float(s_[2]), __uint_as_float(s_[3]));
      }
      __syncthreads();
    }

    // ---- scores: (q * scale) k^T, slots 8j + 2tq (+ 1) of rows g, g + 8;
    // even and odd head-dim steps in two accumulators (two chains of mma) ----
    float s[4][4], s2[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = s2[j][c] = 0.f;
    const float* qw = qs + (16 * warp + g) * QP + tq;
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      uint32_t ab[4], as[4];
      split_tf32(qw[8 * kk], ab[0], as[0]);
      split_tf32(qw[8 * QP + 8 * kk], ab[1], as[1]);
      split_tf32(qw[8 * kk + 4], ab[2], as[2]);
      split_tf32(qw[8 * QP + 8 * kk + 4], ab[3], as[3]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mma_3x<BF16>(kk & 1 ? s2[j] : s[j], ab, as, ks, kss,
                     (8 * j + g) * KP + 8 * kk + tq, 4);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] += s2[j][c];
    // ---- the mask (slots past S take no part: p = 0), online softmax ----
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int rl = 16 * warp + g + 8 * rr;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 mv = *reinterpret_cast<const float2*>(ms + rl * FA_MP + 8 * j + 2 * tq);
        const int slot = s0 + 8 * j + 2 * tq;
        s[j][2 * rr] = slot < S ? s[j][2 * rr] + mv.x : -INFINITY;
        s[j][2 * rr + 1] = slot + 1 < S ? s[j][2 * rr + 1] + mv.y : -INFINITY;
        mx = fmaxf(mx, fmaxf(s[j][2 * rr], s[j][2 * rr + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[rr], mx);
      const float alpha = expf(m_r[rr] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[j][2 * rr] = expf(s[j][2 * rr] - m_new);
        s[j][2 * rr + 1] = expf(s[j][2 * rr + 1] - m_new);
        sum += s[j][2 * rr] + s[j][2 * rr + 1];
      }
      l_r[rr] = l_r[rr] * alpha + sum;  // this thread's slots; the quad's sum at the end
#pragma unroll
      for (int dn = 0; dn < ND; ++dn) {
        o[dn][2 * rr] *= alpha;
        o[dn][2 * rr + 1] *= alpha;
      }
      m_r[rr] = m_new;
    }
    // ---- o += p v: the score accumulators are the A fragments, with the
    // k index permuted (k = tq <-> slot 8j + 2tq, k = tq + 4 <-> slot 8j +
    // 2tq + 1) and v's rows read in the same order ----
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t pb[4], ps[4];
      split_tf32(s[j][0], pb[0], ps[0]);
      split_tf32(s[j][2], pb[1], ps[1]);
      split_tf32(s[j][1], pb[2], ps[2]);
      split_tf32(s[j][3], pb[3], ps[3]);
      const int e = (8 * j + 2 * tq) * KP + g;
#pragma unroll
      for (int dn = 0; dn < ND; ++dn) mma_3x<BF16>(o[dn], pb, ps, vs, vss, e + 8 * dn, KP);
    }
    __syncthreads();  // the stage is consumed before the next copy refills it
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float l = l_r[rr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float den = fmaxf(l, 1e-30f);
    const int t = t0 + 16 * warp + g + 8 * rr;
    if (t >= T) continue;
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
      *reinterpret_cast<float2*>(out + qbase + (size_t)t * D + 8 * dn + 2 * tq) =
          make_float2(o[dn][2 * rr] / den, o[dn][2 * rr + 1] / den);
  }
}

template <int D, bool BF16>
int flash_launch(const void* q, const void* k, const void* v, const float* mask, long long msb,
                 long long msh, long long mst, long long mss, int mvec, int B, int H, int T,
                 int S, float scale, float* out, cudaStream_t s) {
  static bool attr_set = false;
  auto kern = flash_attn_kernel<D, BF16>;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, FaTile<D, BF16>::SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid((T + FA_TQ - 1) / FA_TQ, B * H);
  kern<<<grid, FA_NT, FaTile<D, BF16>::SMEM, s>>>(q, k, v, mask, msb, msh, mst, mss, mvec, H, T,
                                                   S, scale, out);
  return (int)cudaGetLastError();
}

template <bool BF16>
int flash_launch_d(int D, const void* q, const void* k, const void* v, const float* mask,
                   long long msb, long long msh, long long mst, long long mss, int mvec, int B,
                   int H, int T, int S, float scale, float* out, cudaStream_t s) {
  switch (D) {
    case 32: return flash_launch<32, BF16>(q, k, v, mask, msb, msh, mst, mss, mvec, B, H, T, S, scale, out, s);
    case 64: return flash_launch<64, BF16>(q, k, v, mask, msb, msh, mst, mss, mvec, B, H, T, S, scale, out, s);
    case 96: return flash_launch<96, BF16>(q, k, v, mask, msb, msh, mst, mss, mvec, B, H, T, S, scale, out, s);
    default: return flash_launch<128, BF16>(q, k, v, mask, msb, msh, mst, mss, mvec, B, H, T, S, scale, out, s);
  }
}

// ---------------------------------------------------------------- K12

constexpr int DA_D = 128;
constexpr int DA_NT = 256;     // threads a block (8 warps)
constexpr int DA_MAXG = 8;     // query heads a KV head
constexpr int DA_MAXC = 8;     // blocks a cluster (the portable limit): a
                               // (row, KV head)'s slot splits
constexpr int DA_CH = 128;     // cache slots a ring stage
constexpr int DA_SC = 512;     // slots a score pass

// A split's record: acc [MAXG][D], then its max m and denominator l a
// query head.
constexpr int DA_RECW = DA_MAXG * DA_D + 2 * DA_MAXG;

// The block's shared memory: q * scale [MAXG][D]; a pass's scores, then
// its p, [SC][MAXG] (a slot's heads together; after the last pass, the
// four row quarters' p.v partials [4][MAXG][D]); the running max m,
// denominator l and the pass's rescale alpha [MAXG] each; the cluster's
// records [MAXC][RECW] (rank 0's are the ones written, by every rank); then
// a ring of NS stages, each DA_CH cache rows (k or v) at a pitch of the row
// plus 64 bytes (bf16) or 16 (f32), which puts the 16-byte loads of a
// score step (two rows, four lanes each, a row's 64 or 128 contiguous
// bytes) on distinct banks.
template <bool BF16>
struct DaTile {
  static constexpr int ES = BF16 ? 2 : 4;
  static constexpr int UPR = DA_D * ES / 16;  // 16-byte units a row
  static constexpr int PITCH = DA_D * ES + (BF16 ? 64 : 16);
  static constexpr int STAGE = DA_CH * PITCH;
  static constexpr int NS = BF16 ? 3 : 2;
  static constexpr int Q = DA_MAXG * DA_D * 4;
  static constexpr int SC = DA_MAXG * DA_SC * 4;
  static constexpr int RUN = 4 * DA_MAXG * 4;
  static constexpr int RECS = DA_MAXC * DA_RECW * 4;
  static constexpr int RING = Q + SC + RUN + RECS;
  static constexpr int SMEM = RING + NS * STAGE;  // 176768 (bf16), 189056 (f32)
};

// The live slot range [lo, hi] of a row at pos; dead (no slot live): every
// slot, each with the score NEG_INF.  tests/test_torch_dual_k12.py mirrors it.
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

// Eight consecutive values of a staged row, as f32.
template <bool BF16>
__device__ __forceinline__ void lds_row8(const unsigned char* p, float (&v)[8]) {
  if constexpr (BF16) {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = bf2f(u[i] & 0xffffu);
      v[2 * i + 1] = bf2f(u[i] >> 16);
    }
  } else {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 16);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
}

// Where chunk c of a split of n slots lies: per score pass of up to DA_SC
// slots, its k chunks, then its v chunks, DA_CH slots each (the last one
// ragged).  pass0: the pass's first slot (relative); pn: its slots; nk: its
// k chunks; v: a v chunk; idx: the chunk's index among its kind; rows.
struct DaChunk {
  int pass0, pn, nk, v, idx, rows;
};

__device__ __forceinline__ DaChunk da_chunk(int c, int n) {
  constexpr int FULL = 2 * DA_SC / DA_CH;
  DaChunk k;
  const int pass = c / FULL, r = c - pass * FULL;
  k.pass0 = pass * DA_SC;
  k.pn = min(DA_SC, n - k.pass0);
  k.nk = (k.pn + DA_CH - 1) / DA_CH;
  k.v = r >= k.nk;
  k.idx = r - (k.v ? k.nk : 0);
  k.rows = min(DA_CH, k.pn - k.idx * DA_CH);
  return k;
}

// grid (nsplit, Hkv, B), one cluster of nsplit blocks a (row, KV head):
// block sp takes its share [a0, a1) of the row's live slots, stages them
// by cp.async, scores them, takes the pass's max once and accumulates
// p.v, and writes its record into rank 0's; rank 0 merges the cluster's
// records in rank order and writes the output.
template <bool BF16>
__global__ void __launch_bounds__(DA_NT) decode_gqa_kernel(
    const float* __restrict__ qg, const void* __restrict__ kc,
    const void* __restrict__ vc, const int* __restrict__ pos, int Hkv, int G,
    int S, float scale, int swa, float logit_cap, float* __restrict__ out) {
  using Tl = DaTile<BF16>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* sc = reinterpret_cast<float*>(smem + Tl::Q);
  float* rm = reinterpret_cast<float*>(smem + Tl::Q + Tl::SC);
  float* rl = rm + DA_MAXG;
  float* ralpha = rl + DA_MAXG;
  float* recs = reinterpret_cast<float*>(smem + Tl::Q + Tl::SC + Tl::RUN);
  const uint32_t ring = smem_addr(smem + Tl::RING);
  cg::cluster_group cluster = cg::this_cluster();
  const int nsplit = (int)cluster.num_blocks(), sp = (int)cluster.block_rank();
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // scores: four lanes a slot (row tid / 4), each a quarter of the dims
  // (8 of every 32, lane qd's), every query head; p.v: thread (dims 2*dp,
  // 2*dp + 1) every head over the rows rq, rq + 4, ...
  const int qd = tid & 3, dp = tid & 63, rq = tid >> 6;
  // every block of the cluster has started once this barrier completes
  // (waited on before the records are written into rank 0's memory)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  // q first: its loads fly while pos and the cache rows are fetched
  constexpr int QPT = DA_MAXG * DA_D / DA_NT;  // q values a thread
  float qv[QPT];
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    const int e = tid + i * DA_NT;
    qv[i] = e < G * DA_D ? qg[((size_t)b * Hkv + h) * G * DA_D + e] : 0.f;
  }

  // the share first, so that its copies are in flight before anything
  // else waits
  int lo, hi;
  bool dead;
  live_range(__ldg(pos + b), S, swa, lo, hi, dead);
  const int len = (hi - lo + nsplit) / nsplit;  // slots a split
  const int a0 = lo + sp * len, n = max(0, min(hi + 1, a0 + len) - a0);
  const int npass = (n + DA_SC - 1) / DA_SC;
  const int last = n - (npass - 1) * DA_SC;
  const int total = npass ? (npass - 1) * (2 * DA_SC / DA_CH) + 2 * ((last + DA_CH - 1) / DA_CH)
                          : 0;

  // the k or v rows of chunk c into its ring slot
  auto issue = [&](int c) {
    const DaChunk k = da_chunk(c, n);
    const unsigned char* src = reinterpret_cast<const unsigned char*>(k.v ? vc : kc);
    const uint32_t dst = ring + (c % Tl::NS) * Tl::STAGE;
    const int s0 = a0 + k.pass0 + k.idx * DA_CH;
    for (int e = tid; e < k.rows * Tl::UPR; e += DA_NT) {
      const int r = e / Tl::UPR, u = e - r * Tl::UPR;
      const size_t off = ((((size_t)b * S + s0 + r) * Hkv + h) * DA_D) * Tl::ES + u * 16;
      cp_async16(dst + r * Tl::PITCH + u * 16, src + off, 16);
    }
  };
  // the ring: chunk c in group c (NS - 1 groups always ahead, empty past
  // the last chunk), so every chunk of a short split is in flight at once
  for (int c = 0; c < Tl::NS - 1; ++c) {
    if (c < total) issue(c);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
#pragma unroll
  for (int i = 0; i < QPT; ++i) qs[tid + i * DA_NT] = __fmul_rn(qv[i], scale);
  if (tid < DA_MAXG) {
    rm[tid] = NEG_INF;
    rl[tid] = 0.f;
  }
  __syncthreads();  // qs, rm, rl

  float acc[DA_MAXG][2];
#pragma unroll
  for (int g = 0; g < DA_MAXG; ++g) acc[g][0] = acc[g][1] = 0.f;
  for (int c = 0; c < total; ++c) {
    if (c + Tl::NS - 1 < total) issue(c + Tl::NS - 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group %0;\n" ::"n"(Tl::NS - 1) : "memory");
    __syncthreads();
    const DaChunk k = da_chunk(c, n);
    const unsigned char* st = smem + Tl::RING + (c % Tl::NS) * Tl::STAGE;
    if (!k.v) {
      // 64 slots at a time, four lanes a slot
      for (int r0 = 0; r0 < k.rows; r0 += DA_NT / 4) {
        const int r = r0 + (tid >> 2);
        float s4[DA_MAXG];
#pragma unroll
        for (int g = 0; g < DA_MAXG; ++g) s4[g] = 0.f;
        if (r < k.rows) {
          // lane qd's dims 8*(4*j + qd) ... + 8, j = 0..3: a row's four lanes
          // read 32 (bf16) or 64 (f32) contiguous bytes a step
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int d = 8 * (4 * j + qd);
            float kv[8];
            lds_row8<BF16>(st + r * Tl::PITCH + d * Tl::ES, kv);
#pragma unroll
            for (int g = 0; g < DA_MAXG; ++g) {
              if (g < G) {
                const float4 qa = *reinterpret_cast<const float4*>(qs + g * DA_D + d);
                const float4 qb = *reinterpret_cast<const float4*>(qs + g * DA_D + d + 4);
                s4[g] = fmaf(qa.x, kv[0], s4[g]);
                s4[g] = fmaf(qa.y, kv[1], s4[g]);
                s4[g] = fmaf(qa.z, kv[2], s4[g]);
                s4[g] = fmaf(qa.w, kv[3], s4[g]);
                s4[g] = fmaf(qb.x, kv[4], s4[g]);
                s4[g] = fmaf(qb.y, kv[5], s4[g]);
                s4[g] = fmaf(qb.z, kv[6], s4[g]);
                s4[g] = fmaf(qb.w, kv[7], s4[g]);
              }
            }
          }
        }
        // the four lanes' sums (every lane of the warp takes part)
#pragma unroll
        for (int g = 0; g < DA_MAXG; ++g) {
          if (g < G) {
            float v = s4[g] + __shfl_xor_sync(0xffffffffu, s4[g], 1);
            v += __shfl_xor_sync(0xffffffffu, v, 2);
            if (logit_cap != 0.f) v = tanhf(v / logit_cap) * logit_cap;
            if (r < k.rows && qd == 0) sc[(k.idx * DA_CH + r) * DA_MAXG + g] = dead ? NEG_INF : v;
          }
        }
      }
      if (k.idx == k.nk - 1) {
        // the pass is scored: its max once a head, then p and its sum
        __syncthreads();
        if (warp < G) {
          float mx = NEG_INF;
          for (int t = lane; t < k.pn; t += 32) mx = fmaxf(mx, sc[t * DA_MAXG + warp]);
          mx = warp_max(mx);
          const float m_old = rm[warp], m_new = fmaxf(m_old, mx);
          float sum = 0.f;
          for (int t = lane; t < k.pn; t += 32) {
            const float p = expf(sc[t * DA_MAXG + warp] - m_new);
            sc[t * DA_MAXG + warp] = p;
            sum += p;
          }
          sum = warp_sum(sum);
          if (lane == 0) {
            const float alpha = expf(m_old - m_new);
            ralpha[warp] = alpha;
            rl[warp] = rl[warp] * alpha + sum;
            rm[warp] = m_new;
          }
        }
      }
    } else {
      if (k.idx == 0) {
        // the pass's rescale of the running sums
#pragma unroll
        for (int g = 0; g < DA_MAXG; ++g) {
          if (g < G) {
            acc[g][0] *= ralpha[g];
            acc[g][1] *= ralpha[g];
          }
        }
      }
      const float* pc = sc + k.idx * DA_CH * DA_MAXG;
      const unsigned char* vcol = st + dp * 2 * Tl::ES;
      for (int r = rq; r < k.rows; r += 4) {
        float v0, v1;
        if constexpr (BF16) {
          const uint32_t w = *reinterpret_cast<const uint32_t*>(vcol + r * Tl::PITCH);
          v0 = bf2f(w & 0xffffu);
          v1 = bf2f(w >> 16);
        } else {
          const float2 w = *reinterpret_cast<const float2*>(vcol + r * Tl::PITCH);
          v0 = w.x;
          v1 = w.y;
        }
        const float4 pa = *reinterpret_cast<const float4*>(pc + r * DA_MAXG);
        const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          acc[g][0] = fmaf(pv[g], v0, acc[g][0]);
          acc[g][1] = fmaf(pv[g], v1, acc[g][1]);
        }
        if (G > 4) {
          const float4 pb = *reinterpret_cast<const float4*>(pc + r * DA_MAXG + 4);
          const float pw[4] = {pb.x, pb.y, pb.z, pb.w};
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            acc[4 + g][0] = fmaf(pw[g], v0, acc[4 + g][0]);
            acc[4 + g][1] = fmaf(pw[g], v1, acc[4 + g][1]);
          }
        }
      }
    }
    __syncthreads();  // the slot and the pass's p are read before refilled
  }
  // the four row quarters' partials, summed in quarter order
  float* part = sc;
#pragma unroll
  for (int g = 0; g < DA_MAXG; ++g) {
    if (g < G) {
      part[(rq * DA_MAXG + g) * DA_D + 2 * dp] = acc[g][0];
      part[(rq * DA_MAXG + g) * DA_D + 2 * dp + 1] = acc[g][1];
    }
  }
  __syncthreads();
  // this split's record into rank 0's records, slot sp
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  float* rec = cluster.map_shared_rank(recs, 0) + sp * DA_RECW;
  for (int e = tid; e < G * DA_D; e += DA_NT)
    rec[e] = ((part[e] + part[DA_MAXG * DA_D + e]) + part[2 * DA_MAXG * DA_D + e]) +
             part[3 * DA_MAXG * DA_D + e];
  if (tid < G) {
    rec[DA_MAXG * DA_D + tid] = rm[tid];
    rec[DA_MAXG * DA_D + DA_MAXG + tid] = rl[tid];
  }
  cluster.sync();  // every record is in rank 0's memory
  if (sp != 0) return;
  for (int e = tid; e < G * DA_D; e += DA_NT) {
    const int g = e / DA_D;
    float M = NEG_INF;
    for (int r = 0; r < nsplit; ++r) M = fmaxf(M, recs[r * DA_RECW + DA_MAXG * DA_D + g]);
    float L = 0.f, A = 0.f;
    for (int r = 0; r < nsplit; ++r) {
      const float* rc = recs + r * DA_RECW;
      const float f = expf(rc[DA_MAXG * DA_D + g] - M);
      L += rc[DA_MAXG * DA_D + DA_MAXG + g] * f;
      A += rc[e] * f;
    }
    out[((size_t)b * Hkv + h) * G * DA_D + e] = A / fmaxf(L, 1e-30f);
  }
}

template <bool BF16>
int gqa_launch(const float* qg, const void* kc, const void* vc, const int* pos,
               int B, int Hkv, int G, int S, int nsplit, float scale, int swa,
               float logit_cap, float* out, cudaStream_t s) {
  using Tl = DaTile<BF16>;
  static bool attr_set = false;
  auto kern = decode_gqa_kernel<BF16>;
  if (!attr_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nsplit, Hkv, B);
  cfg.blockDim = dim3(DA_NT);
  cfg.dynamicSmemBytes = Tl::SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, qg, kc, vc, pos, Hkv, G, S, scale, swa,
                                           logit_cap, out);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ght_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// K11: q [B,H,T,D], k/v [B,H,S,D], all f32 (bf16 != 0: all bf16), D 32,
// 64, 96 or 128; mask f32 read at b*msb + h*msh + t*mst + s*mss
// (elements); out f32 [B,H,T,D].
int flash_attn_run(const void* q, const void* k, const void* v,
                   const float* mask, long long msb, long long msh,
                   long long mst, long long mss, int B, int H, int T, int S,
                   int D, float scale, int bf16, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || H < 1 || T < 1 || S < 1 || D % 32 || D < 32 || D > 128)
    return (int)cudaErrorInvalidValue;
  // the mask tile by 16-byte copies where its rows are contiguous and
  // 16-byte aligned
  const int mvec = mss == 1 && mst % 4 == 0 && msb % 4 == 0 && msh % 4 == 0 && S % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(mask) % 16 == 0;
  return bf16 ? flash_launch_d<true>(D, q, k, v, mask, msb, msh, mst, mss, mvec, B, H, T, S,
                                     scale, out, s)
              : flash_launch_d<false>(D, q, k, v, mask, msb, msh, mst, mss, mvec, B, H, T, S,
                                      scale, out, s);
}

// K12, one launch: qg f32 [B,Hkv,G,128]; caches [B,S,Hkv,128] bf16
// (bf16 != 0) or f32; pos int32 [B] on the card; nsplit blocks a cluster
// (kernels.pick_gqa_splits, 1-8); out f32 [B,Hkv,G,128].
int decode_attn_gqa_run(const float* qg, const void* kc, const void* vc,
                        const int* pos, int B, int Hkv, int G, int S,
                        int nsplit, float scale, int swa, float logit_cap,
                        int bf16, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || B > 65535 || Hkv < 1 || Hkv > 65535 || G < 1 || G > DA_MAXG || S < 1 ||
      nsplit < 1 || nsplit > DA_MAXC)
    return (int)cudaErrorInvalidValue;
  return bf16 ? gqa_launch<true>(qg, kc, vc, pos, B, Hkv, G, S, nsplit, scale, swa,
                                 logit_cap, out, s)
              : gqa_launch<false>(qg, kc, vc, pos, B, Hkv, G, S, nsplit, scale, swa,
                                  logit_cap, out, s);
}

}  // extern "C"
