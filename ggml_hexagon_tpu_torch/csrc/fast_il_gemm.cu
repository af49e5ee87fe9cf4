// K6's GEMM: the interleaved-layout quantized matmul above 8 rows (the
// prefill), on byte, nibble and coded planes, with or without a group
// bias, in every mode, for sm_90a.  fast_il.cu keeps K6's B <= 8 GEMV, K7
// and K8.
//
// Replaces, in ggml_hexagon_tpu/ops/qmm_fast.py, the B > 8 launches of
// `_byte_kernel` (:510) and `_nibble_kernel` (:497, body `_nibble_y`
// :432) through `pallas_call` in `_fast_call` (:663), with `_kernel_x`,
// `_kernel_xg` and `_epilogue` (:376-411).
//
// Planes (fast_il.cu has the full layout): column j of the interleaved
// order holds the original column (j % G)*gs + j/G and takes the scale
// fs[:, j % G]; fq is int8 [n2, K] (byte family) or uint8 [n2, K/2]
// (nibble and coded families: byte b holds columns b and K/2 + b, both of
// group b % G); the group bias is fb [n2, G], or off * fs, or absent.
//
// What bounds it: operations at the 128- and 512-token prefill chunks (2*M
// flops a weight, against 1 byte (byte planes) or half a byte (nibble and
// coded) a weight: past the card's bf16 ridge of ~295 from M = 148 and M =
// 74), bytes at the 16- and 32-token buckets.  In practice, at M = 512,
// the block's own pipeline, not the tensor cores: with its wgmmas replaced
// by a register XOR the kernel keeps about two thirds of its time.  Nor is
// it the L2 traffic of x (a 2-CTA cluster multicasting x to two lane tiles
// ran slower), nor ptxas's serialising of the wgmmas at the 256-token tile
// (a thread of this 12-warp block gets at most 168 registers, three warps
// sharing an SM quadrant's 16K, too few beside 128 accumulators: its C7512
// note, which K3 shares; a 176-token tile, not serialised, ran no faster).
// What is left, the consumers' decode and the ring's latency, is not
// measured apart.
//
// Design (K3's, qp8_gemm.cu, carried over to the interleaved planes):
//  * Swap-AB wgmma: the weight lanes are M (two consumer warpgroups of 64,
//    128 lanes a block), the tokens N (tiles of 32 for M <= 32, 128 for M
//    <= 128, else 256).  The weight goes to wgmma from registers (A),
//    decoded and rounded to bf16(q * scale) in place; it never exists in
//    shared or device memory as bf16.  x is the B operand, K-major in
//    shared memory.
//  * A stage is 64 columns of K: 64 plane bytes of a lane on byte planes
//    (columns k0..k0+63), 32 on packed planes (bytes p0..p0+31: columns
//    p0.. in their low nibbles and K/2 + p0.. in their high ones).  Its x
//    is one TMA box [N][64] (128-byte rows, 128-byte swizzle): the pre-pass
//    lays packed planes' two runs (p0.. and K/2 + p0..) side by side.
//  * A thread owns lanes a and a+1 (wgmma rows g and g+8, as in K3) and in
//    each 16-column step the columns 2t, 2t+1, 2t+8, 2t+9 (t = lane % 4).
//    The pre-pass writes x in a permuted order inside every 32-column run
//    (physical column 8t + 4s + q sits at step s's column 2t + (q & 1) +
//    8(q >> 1)), so that a thread's weights are 8 consecutive plane bytes
//    of a lane a run: one 8-byte load from shared memory, not eight 2-byte
//    ones, and one 16-byte load of their 8 consecutive scales.
//  * The layout's twist, one scale a column: 8 consecutive interleaved
//    columns take 8 consecutive groups, so a stage's columns k0.. take the
//    groups k0 % G onwards, 64 (byte) or 32 (packed) of them: one TMA box
//    of the scale plane where G is a multiple of that, else one box of 8
//    groups each (G % 8 == 0).  Each scale is thus loaded gs times over K,
//    2 bytes a weight on byte planes; the other option, a stage of R
//    groups at all gs shifts, loads each scale once but cuts a lane's
//    plane bytes into runs of 2-4 bytes.
//  * Every tile is a TMA box: x, the plane bytes ([128][64 or 32] with the
//    swizzle of that width), the scales, and the bias tiles.  One thread
//    of a producer warpgroup (its registers given to the consumers with
//    setmaxnreg) fills a ring of stages, each counted on its mbarrier; the
//    consumers decode stage i+1 while stage i's four wgmmas run, read the
//    boxes through the swizzle (at most 2-way bank conflicts) and release
//    a slot with one arrival a warp.  A producer of 128 threads copying
//    the plane bytes and scales in 16-byte pieces with cp.async ran
//    slower: the copies' address arithmetic, not the bytes, was the cost.
//  * The group bias runs as extra K-stages of the same pipeline into the
//    same accumulators: A is the fb tile (or bf16(off * fs), exact, off a
//    power of two; groups past G read as zeros), B the group sums split
//    exactly into three bf16 parts (hi + mid + lo == the f32 sum), permuted
//    like x.  Every product is exact in f32; only the order of the f32 sums
//    differs from an f32 dot.
//  * Where the output tiles alone leave SMs idle (the 8B's 4096-lane wo
//    and down, one Mixtral expert's slice), K is split over blocks (the
//    host picks the splits, kernels._gemm_splits); a small kernel sums the
//    partials in split order and adds the residual.
//  * The family (byte, nibble, coded) is a template parameter: a run-time
//    code-map branch once cost the uncoded kernels 30-75%.  Coded planes
//    decode four codes at a time (codes.cuh `decode4_with`, the alphabet
//    looked up once).
//  * Numerics, the TPU kernels' contract: every weight is
//    __float2bfloat16_rn(q * scale), rounded before the product; products
//    are summed in f32; the bias is f32; the residual is added last.  The
//    pre-pass computes the effective activation as fast_il.cu does
//    (interleave, RMSNorm, silu(g)*u, each rounded to bf16).
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "act.cuh"
#include "codes.cuh"
#include "hopper.cuh"

namespace {

constexpr int KT = 64;          // K columns a stage
constexpr int NCW = 8;          // consumer warps (two warpgroups)
constexpr int NTH = NCW * 32 + 128;  // and a producer warpgroup
constexpr int BNL = 128;        // weight lanes a block
constexpr int PRE_THREADS = 256;

// pre-pass modes (the C entry's `mode`) and plane families
constexpr int MODE_PLAIN = 0, MODE_NORMED = 1, MODE_ACT = 2, MODE_PRE_IL = 3;
constexpr int FAM_BYTE = 0, FAM_NIBBLE = 1, FAM_CODED = 2;

// A stage's weight area: the lanes' plane bytes, [128][WB] (WB-byte
// swizzle), then their scales: [128][SB] (SB = 2 bytes x the stage's 64 or
// 32 groups, SB-byte swizzle) where those groups are one box, else SC boxes
// [SC][128][16] of 8 groups each.  A bias stage holds its fb tile there
// instead, [128][128] (64 groups, 128-byte swizzle).  Every tile is a TMA
// box.
template <bool PACKED>
struct Geo {
  static constexpr int WB = PACKED ? 32 : 64;     // plane bytes a lane
  static constexpr int SC = PACKED ? 4 : 8;       // 8-group scale chunks a lane
  static constexpr int SB = 16 * SC;              // scale bytes a lane
  static constexpr int S_OFF = BNL * WB;
  static constexpr int WAREA = S_OFF + BNL * SB;
  static constexpr int AREA = WAREA > BNL * 128 ? WAREA : BNL * 128;
};

__host__ __device__ constexpr int xtile_bytes(int n) { return n * KT * 2; }
__host__ __device__ constexpr int stage_bytes(bool packed, int n) {
  return xtile_bytes(n) + (packed ? Geo<true>::AREA : Geo<false>::AREA);
}
__host__ __device__ constexpr int n_stages(bool packed, int n) {
  return n >= 256 ? 4 : n >= 128 ? (packed ? 7 : 5) : 8;
}
__host__ __device__ constexpr int smem_bytes(bool packed, int n) {
  return 1024 + n_stages(packed, n) * stage_bytes(packed, n) + 2 * n_stages(packed, n) * 8;
}
static_assert(stage_bytes(false, 32) % 1024 == 0 && stage_bytes(true, 32) % 1024 == 0 &&
              Geo<false>::S_OFF % 1024 == 0 && Geo<true>::S_OFF % 1024 == 0,
              "TMA boxes must stay 1024-aligned");
static_assert(smem_bytes(false, 256) <= 232448 && smem_bytes(false, 128) <= 232448 &&
              smem_bytes(false, 32) <= 232448 && smem_bytes(true, 256) <= 232448 &&
              smem_bytes(true, 128) <= 232448 && smem_bytes(true, 32) <= 232448,
              "ring exceeds the block's shared memory");

__device__ __forceinline__ uint16_t f2bf(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// Inside each 32-column run, physical column 8t + 4s + q goes to step s's
// column 2t + (q&1) + 8(q>>1) (the columns thread t holds in a wgmma A
// fragment).
__device__ __forceinline__ int perm32(int j) {
  const int p = j & 31, t = p >> 3, s = (p >> 2) & 1, q = p & 3;
  return (j & ~31) + 16 * s + 2 * t + (q & 1) + 8 * (q >> 1);
}

// x's position of interleaved column j: byte planes keep the order
// (perm32 inside each run); packed planes put the run of columns p.. (low
// nibbles of bytes p..) and that of K/2 + p.. (their high nibbles) side by
// side, so that every stage's x is one 64-column box.
__device__ __forceinline__ int x_pos(int j, int K, bool packed) {
  if (!packed) return perm32(j);
  const int half = j >= K / 2, p = j - half * (K / 2);
  return 64 * (p >> 5) + 32 * half + perm32(p & 31);
}

// One block a row b: the effective activation in the interleaved column
// order, permuted (x_pos) into xp [M, K]; then, with a bias, the group sums
// split into three bf16 parts in xgs [M, 3*Gp] (part p at p*Gp, groups
// permuted like x, zero from G to Gp).  mode: plain (x natural [M, K]),
// normed (the same, inv = 1/sqrt(sum(x^2) / kn + eps), then bf16((x * inv)
// * wn_il)), act (x [M, 2K] = gate ++ up, both interleaved: bf16(act(g) *
// u), act the ACT_* id `act`), pre_il (x interleaved already).  xg_mode 2 sums the bf16 effective
// activation; 1 takes the caller's xg_in [M, G] (times inv when normed).
__global__ void __launch_bounds__(PRE_THREADS) prepass_kernel(
    int mode, int act, bool packed, const uint16_t* __restrict__ x, int K, int G,
    const float* __restrict__ wn,
    float eps, int kn, const float* __restrict__ xg_in, int xg_mode, int Gp,
    uint16_t* __restrict__ xp, __nv_bfloat16* __restrict__ xgs) {
  __shared__ float red[PRE_THREADS / 32];
  __shared__ float bcast;
  const int b = blockIdx.x, t = threadIdx.x;
  const int gs = K / G;
  const uint16_t* xr = x + (size_t)b * (mode == MODE_ACT ? 2 * K : K);
  float inv = 1.f;
  if (mode == MODE_NORMED) {
    float ss = 0.f;
    for (int k = t; k < K; k += PRE_THREADS) {
      const float v = bf2f(xr[k]);
      ss += v * v;
    }
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if ((t & 31) == 0) red[t >> 5] = ss;
    __syncthreads();
    if (t == 0) {
      float s = 0.f;
      for (int w = 0; w < PRE_THREADS / 32; ++w) s += red[w];
      bcast = 1.f / sqrtf(s / (float)kn + eps);
    }
    __syncthreads();
    inv = bcast;
  }
  auto eff = [&](int j) -> uint16_t {
    if (mode == MODE_PRE_IL) return xr[j];
    if (mode == MODE_ACT) {
      const float g = bf2f(xr[j]), u = bf2f(xr[K + j]);
      if (act == ACT_GELU) return f2bf(act_mul<ACT_GELU>(g, u));
      if (act == ACT_RELU) return f2bf(act_mul<ACT_RELU>(g, u));
      return f2bf(act_mul<ACT_SILU>(g, u));
    }
    const uint16_t v = xr[(size_t)(j % G) * gs + j / G];
    return mode == MODE_NORMED ? f2bf(bf2f(v) * inv * wn[j]) : v;
  };
  uint16_t* xo = xp + (size_t)b * K;
  for (int j = t; j < K; j += PRE_THREADS) xo[x_pos(j, K, packed)] = eff(j);
  if (xg_mode == 0) return;
  __nv_bfloat16* row = xgs + (size_t)b * 3 * Gp;
  for (int g = t; g < Gp; g += PRE_THREADS) {
    float s = 0.f;
    if (g < G) {
      if (xg_mode == 2)
        for (int r = 0; r < gs; ++r) s += bf2f(eff(r * G + g));
      else
        s = xg_in[(size_t)b * G + g] * (mode == MODE_NORMED ? inv : 1.f);
    }
    const __nv_bfloat16 hi = __float2bfloat16_rn(s);
    const float r1 = s - __bfloat162float(hi);
    const __nv_bfloat16 mid = __float2bfloat16_rn(r1);
    const __nv_bfloat16 lo = __float2bfloat16_rn(r1 - __bfloat162float(mid));
    const int pg = perm32(g);
    row[pg] = hi;
    row[Gp + pg] = mid;
    row[2 * Gp + pg] = lo;
  }
}

struct Args {
  const uint8_t* fq;
  const uint16_t* fs;
  const float* res;     // f32 [M, n_res] or null (added here when ks == 1)
  float* out;           // [M, n2], or [ks, M, n2] partials when ks > 1
  int n2, K, G, Gp, M, ks, cm, n_res, bias;
  int stma;             // a stage's scales in one box (G % (8 * SC) == 0)
  bool use_off;         // the bias is off * fs (no fb)
  float off;
};

// A fragments of one stage for one thread: ra[4r + j] holds lane a's
// columns 2t+8(j&1).. of run r's step j/2, rb[] lane a+1's.
struct Frag {
  uint32_t ra[8], rb[8];
};

// Four bf16 pairs bf16(v_i * s_i) from eight values, one a byte of v0
// (values 0-3) and v1 (4-7), each 2^23 + byte read as a float less `bias`,
// and their eight bf16 scales in sv.
__device__ __forceinline__ void scale_pairs(uint32_t v0, uint32_t v1, uint4 sv, float bias,
                                            uint32_t* out) {
  const uint32_t vv[2] = {v0, v1};
  const uint32_t ss[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t v = vv[j >> 1];
    const int b = 2 * (j & 1);
    const float f0 = __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7650 + b)) - bias;
    const float f1 = __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7651 + b)) - bias;
    const __nv_bfloat162 p = __floats2bfloat162_rn(f0 * __uint_as_float(ss[j] << 16),
                                                   f1 * __uint_as_float(ss[j] & 0xffff0000u));
    out[j] = *reinterpret_cast<const uint32_t*>(&p);
  }
}

// Decode this thread's A fragments of weight stage `area`: its 8 plane
// bytes of a lane a run (byte planes: bytes 32r + 8t.. of run r; packed
// planes: bytes 8t.., low nibbles for run 0, high ones for run 1) times
// their 8 consecutive scales.
template <int FAM>
__device__ __forceinline__ void decode_weights(const unsigned char* area, int lp, int t,
                                               CodeAlphabet al, bool tern, bool stma,
                                               Frag& f) {
  using Gm = Geo<FAM != FAM_BYTE>;
  const unsigned char* sc = area + Gm::S_OFF;
  // chunk c (8 groups) of lane l's scales
  auto chunk = [&](int l, int c) {
    return *reinterpret_cast<const uint4*>(
        sc + (stma ? swizzled<Gm::SB>(l * Gm::SB + 16 * c) : 16 * (c * BNL + l)));
  };
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int l = lp + h;
    uint32_t* r = h ? f.rb : f.ra;
    if constexpr (FAM == FAM_BYTE) {
#pragma unroll
      for (int run = 0; run < 2; ++run) {
        const uint2 w = *reinterpret_cast<const uint2*>(
            area + swizzled<64>(l * 64 + 32 * run + 8 * t));
        // signed bytes, biased by 128 into the float's mantissa
        scale_pairs(w.x ^ 0x80808080u, w.y ^ 0x80808080u, chunk(l, 4 * run + t), 8388736.f,
                    r + 4 * run);
      }
    } else {
      const uint2 w = *reinterpret_cast<const uint2*>(area + swizzled<32>(l * 32 + 8 * t));
      const uint4 sv = chunk(l, t);
      uint32_t lo0 = w.x & 0x0f0f0f0fu, lo1 = w.y & 0x0f0f0f0fu;
      uint32_t hi0 = (w.x >> 4) & 0x0f0f0f0fu, hi1 = (w.y >> 4) & 0x0f0f0f0fu;
      float bias = 8388608.f;
      if constexpr (FAM == FAM_CODED) {
        lo0 = decode4_with(lo0, al, tern, 3) ^ 0x80808080u;
        lo1 = decode4_with(lo1, al, tern, 3) ^ 0x80808080u;
        hi0 = decode4_with(hi0, al, tern, 3) ^ 0x80808080u;
        hi1 = decode4_with(hi1, al, tern, 3) ^ 0x80808080u;
        bias = 8388736.f;
      }
      scale_pairs(lo0, lo1, sv, bias, r);       // run 0: the low nibbles
      scale_pairs(hi0, hi1, sv, bias, r + 4);   // run 1: the high nibbles
    }
  }
}

// A fragments of a bias stage: the fb tile (or bf16(off * fs)).
__device__ __forceinline__ void decode_bias(const unsigned char* area, int lp, int t,
                                            const Args& a, Frag& f) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t* r = h ? f.rb : f.ra;
#pragma unroll
    for (int run = 0; run < 2; ++run) {
      const uint4 v = *reinterpret_cast<const uint4*>(
          area + swizzled<128>((lp + h) * 128 + 64 * run + 16 * t));
      const uint32_t vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t u = vv[j];
        if (a.use_off) {
          const __nv_bfloat162 p = __floats2bfloat162_rn(a.off * bf2f(u & 0xffffu),
                                                         a.off * bf2f(u >> 16));
          u = *reinterpret_cast<const uint32_t*>(&p);
        }
        r[4 * run + j] = u;
      }
    }
  }
}

// The four 16-column wgmmas of a stage: x is [N][64] bf16, 128-byte rows
// with the 128-byte swizzle, as TMA wrote it.
template <int N>
__device__ __forceinline__ void issue_stage(float (&acc)[N / 2], const Frag& f, uint32_t xs) {
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < KT / 16; ++s) {
    const uint32_t frag[4] = {f.ra[2 * s], f.rb[2 * s], f.ra[2 * s + 1], f.rb[2 * s + 1]};
    wgmma_tile<N>(acc, frag, smem_desc(xs + 32 * s, 16, 1024, 1));
  }
  wgmma_commit();
}

// The block's tensor maps: x (xp), the group sums' parts (xgs), the plane
// bytes (fq), the scales (fs), the bias tile (fb, or fs for off * fs).
struct Maps {
  CUtensorMap x, g, w, s, b;
};

// Load stage st into ring slot `slot` (thread 0): x (or the group sums'
// part) by one box, the plane bytes and scales (or the fb tile) by one box
// each; the slot's full barrier counts their bytes.
template <int FAM, int N>
__device__ __forceinline__ void load_stage(const Args& a, const Maps& maps, int st,
                                           uint32_t xs, uint32_t full, int n0, int m0) {
  using Gm = Geo<FAM != FAM_BYTE>;
  constexpr int XT = xtile_bytes(N);
  const uint32_t area = xs + XT;
  const int nws = a.K / KT;
  if (st < nws) {
    const int b0 = st * Gm::WB;                  // first plane byte (= column)
    mbar_expect_tx(full, XT + BNL * (Gm::WB + Gm::SB));
    tma_load_2d(xs, &maps.x, st * KT, m0, full);   // x_pos's 64 columns
    tma_load_2d(area, &maps.w, b0, n0, full);
    if (a.stma) {  // the stage's groups b0 % G.. in one box
      tma_load_2d(area + Gm::S_OFF, &maps.s, b0 % a.G, n0, full);
    } else {       // box c: the 8 groups from (b0 + 8c) % G
#pragma unroll
      for (int c = 0; c < Gm::SC; ++c)
        tma_load_2d(area + Gm::S_OFF + c * BNL * 16, &maps.s, (b0 + 8 * c) % a.G, n0, full);
    }
  } else {  // the group sums' part p and the fb tile of groups g0..g0+63
            // (zeros past G)
    const int gq = a.Gp / KT, b = st - nws, p = b / gq, g0 = (b % gq) * KT;
    mbar_expect_tx(full, XT + BNL * 128);
    tma_load_2d(xs, &maps.g, p * a.Gp + g0, m0, full);
    tma_load_2d(area, &maps.b, g0, n0, full);
  }
}

template <int FAM, int N>
__global__ void __launch_bounds__(NTH, 1) il_gemm_kernel(const Args a,
                                                         const __grid_constant__ Maps maps) {
  constexpr bool PACKED = FAM != FAM_BYTE;
  constexpr int NS = n_stages(PACKED, N);
  constexpr int XT = xtile_bytes(N);
  constexpr int SB = stage_bytes(PACKED, N);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw0 = smem_u32(smem_raw);
  const uint32_t base = (raw0 + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw0);
  const uint32_t bars = base + NS * SB;  // full[NS], then empty[NS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * BNL, m0 = blockIdx.y * N;
  const int nws = a.K / KT;                      // weight stages
  const int nst = nws + (a.bias ? 3 * a.Gp / KT : 0);
  // this block's share of the stages (a split of K when ks > 1)
  const int per = (nst + a.ks - 1) / a.ks;
  const int s0 = blockIdx.z * per, ns = max(0, min(nst, s0 + per) - s0);

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(bars + 8 * s, 1);                // the producer's expected bytes
      mbar_init(bars + 8 * (NS + s), NCW);       // every consumer warp's release
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= NCW) {
    // ---- producer: one thread keeps the ring full, its warpgroup's
    // registers go to the consumers ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == NCW * 32)
      for (int i = 0; i < ns; ++i) {
        const int slot = i % NS;
        if (i >= NS) mbar_wait(bars + 8 * (NS + slot), ((i / NS) & 1) ^ 1);
        load_stage<FAM, N>(a, maps, s0 + i, base + slot * SB, bars + 8 * slot, n0, m0);
      }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");

  const int wg = warp >> 2, w = warp & 3;
  const int t = lane & 3;                            // this thread's column pairs
  const int lp = wg * 64 + w * 16 + 2 * (lane >> 2); // its lane pair (a, a+1)

  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;

  const CodeAlphabet al = code_alphabet(a.cm);   // looked up once
  const bool tern = a.cm == CM_TERN;
  // Stage i's products run while stage i+1 is decoded (two fragment sets).
  Frag fr[2];
  auto step = [&](int i, Frag& f) {
    const int st = s0 + i, slot = i % NS;
    mbar_wait(bars + 8 * slot, (i / NS) & 1);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const unsigned char* area = smem + slot * SB + XT;
    if (st < nws) decode_weights<FAM>(area, lp, t, al, tern, a.stma, f);
    else decode_bias(area, lp, t, a, f);
    issue_stage<N>(acc, f, base + slot * SB);
  };
  // a stage's slot is free once the products after it were issued (one
  // arrival a warp: its lanes passed the warpgroup's wait together)
  auto release = [&](int i) {
    if (lane == 0) mbar_arrive(bars + 8 * (NS + i % NS));
  };
  for (int i = 0; i < ns; i += 2) {
    step(i, fr[0]);
    if (i > 0) {
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      release(i - 1);
    }
    if (i + 1 < ns) {
      step(i + 1, fr[1]);
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      release(i);
    }
  }
  wgmma_wait0();

  // acc[4i + {0,1}]: lane a, tokens 8i + 2t + {0,1}; acc[4i + {2,3}]: lane a+1
  const int n = n0 + lp;
  float r0 = 0.f, r1 = 0.f;
  float* outp = a.out + (size_t)blockIdx.z * a.M * a.n2 + n;
  const bool res = a.ks == 1 && a.res != nullptr;
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int m = m0 + 8 * i + 2 * t + u;
      if (m >= a.M) continue;
      if (res) {
        r0 = n < a.n_res ? a.res[(size_t)m * a.n_res + n] : 0.f;
        r1 = n + 1 < a.n_res ? a.res[(size_t)m * a.n_res + n + 1] : 0.f;
      }
      *reinterpret_cast<float2*>(outp + (size_t)m * a.n2) =
          make_float2(acc[4 * i + u] + r0, acc[4 * i + 2 + u] + r1);
    }
  }
}

template <int FAM, int N>
int launch(const Args& a, const Maps& maps, cudaStream_t s) {
  constexpr bool PACKED = FAM != FAM_BYTE;
  static bool attr_set = false;
  auto kern = il_gemm_kernel<FAM, N>;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(PACKED, N));
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid(a.n2 / BNL, (a.M + N - 1) / N, a.ks);
  kern<<<grid, NTH, smem_bytes(PACKED, N), s>>>(a, maps);
  return (int)cudaGetLastError();
}

// The tensor maps of a launch with a token tile of N.
bool make_maps(Maps* m, const Args& a, const void* xp, const void* xgs, const void* fb,
               bool packed, int N) {
  const int wb = packed ? Geo<true>::WB : Geo<false>::WB;
  const int sg = packed ? 32 : 64;                 // a stage's groups
  const long long pitch = packed ? a.K / 2 : a.K;  // plane bytes a row
  bool ok = encode_map(&m->x, xp, a.K, a.M, a.K, KT, N) &&
            encode_map_2d(&m->w, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.fq, (int)pitch, a.n2,
                          pitch, wb, BNL, swizzle_of(wb));
  ok = ok && encode_map(&m->s, a.fs, a.G, a.n2, a.G, a.stma ? sg : 8, BNL);
  if (a.bias)
    ok = ok && encode_map(&m->g, xgs, 3 * a.Gp, a.M, 3 * a.Gp, KT, N) &&
         encode_map(&m->b, fb != nullptr ? fb : a.fs, a.G, a.n2, a.G, KT, BNL);
  else
    m->g = m->b = m->x;  // unused
  return ok;
}

template <int FAM>
int launch_n(const Args& a, const void* xp, const void* xgs, const void* fb,
             cudaStream_t s) {
  const int N = a.M <= 32 ? 32 : a.M <= 128 ? 128 : 256;
  Maps maps;
  if (!make_maps(&maps, a, xp, xgs, fb, FAM != FAM_BYTE, N))
    return (int)cudaErrorInvalidValue;
  if (N == 32) return launch<FAM, 32>(a, maps, s);
  if (N == 128) return launch<FAM, 128>(a, maps, s);
  return launch<FAM, 256>(a, maps, s);
}

}  // namespace

extern "C" {

const char* ght_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// K6's GEMM.  mode: 0 plain (x bf16 [M, K] in natural column order), 1
// normed (the same x; wn f32 [K] interleaved, eps), 2 act (x bf16 [M, 2K],
// gate ++ up, both interleaved; act(gate) * up with act an ACT_* id), 3
// plain with x interleaved already.
// family: 0 byte (fq int8 [n2, K]), 1 nibble, 2 coded (fq uint8 [n2, K/2];
// cm the code map of coded planes); fs bf16 [n2, G]; the bias: fb bf16
// [n2, G], or off * fs (fb null, off != 0), or none; xg_mode 1 takes the
// group sums xg_in f32 [M, G] (pre-norm in the normed mode), 2 takes them
// from the activation, 0 when there is no bias; res f32 [M, n_res] or
// null; scratch xp bf16 [M, K] and, with a bias, xgs bf16 [M, 3*Gp] (Gp =
// G rounded up to 64); ks splits of K, with ws f32 [ks, M, n2] when ks >
// 1; out f32 [M, n2].  K % 64 == 0 and G % 8 == 0.  The normed mode's mean
// of x^2 divides by kn (K, or the true K of planes whose groups the wrapper
// padded to a multiple of 8).
int fast_il_gemm_run(int mode, int act, int family, int cm, const void* x, int M, int K,
                     const void* fq, const void* fs, const void* fb, int n2, int G, float off,
                     const float* xg_in, int xg_mode, const float* wn, float eps, int kn,
                     const float* res, int n_res, void* xp, void* xgs, int ks, float* ws,
                     float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const bool bias = fb != nullptr || off != 0.f;
  const bool packed = family != FAM_BYTE;
  if (M < 1 || K % KT || G < 8 || G % 8 || K % G || (packed && (K / 2) % G) ||
      n2 % BNL || n_res < 0 || n_res > n2 || mode < MODE_PLAIN || mode > MODE_PRE_IL ||
      act < ACT_SILU || act > ACT_RELU ||
      (mode == MODE_NORMED && wn == nullptr) || family < FAM_BYTE || family > FAM_CODED ||
      (family == FAM_CODED) != (cm != CM_NONE) || cm < CM_NONE || cm > CM_TERN ||
      (cm && bias) || bias != (xg_mode != 0) || xg_mode < 0 || xg_mode > 2 ||
      (xg_mode == 1 && xg_in == nullptr) || (bias && xgs == nullptr) || xp == nullptr ||
      ks < 1 || (ks > 1 && ws == nullptr) || kn < 1 || kn > K)
    return (int)cudaErrorInvalidValue;
  const int Gp = (G + KT - 1) / KT * KT;
  prepass_kernel<<<M, PRE_THREADS, 0, s>>>(mode, act, packed, (const uint16_t*)x, K, G, wn,
                                           eps, kn, xg_in,
                                           xg_mode, Gp, (uint16_t*)xp, (__nv_bfloat16*)xgs);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  Args a;
  a.fq = (const uint8_t*)fq;
  a.fs = (const uint16_t*)fs;
  a.res = res;
  a.out = ks > 1 ? ws : out;
  a.n2 = n2;
  a.K = K;
  a.G = G;
  a.Gp = Gp;
  a.M = M;
  a.ks = ks;
  a.cm = cm;
  a.n_res = n_res;
  a.bias = bias;
  a.stma = G % (packed ? 32 : 64) == 0;
  a.use_off = fb == nullptr;
  a.off = off;
  const int rc = family == FAM_CODED    ? launch_n<FAM_CODED>(a, xp, xgs, fb, s)
                 : family == FAM_NIBBLE ? launch_n<FAM_NIBBLE>(a, xp, xgs, fb, s)
                                        : launch_n<FAM_BYTE>(a, xp, xgs, fb, s);
  if (rc != 0 || ks == 1) return rc;
  const size_t n4 = (size_t)M * n2 / 4;
  ksum_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, s>>>(
      (const float4*)ws, ks, n4, n2, res, n_res, (float4*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
