// K10 above 8 rows: the wire-plane dequant x matmul of any QConfig as a
// wgmma GEMM on weights decoded in registers, bf16 or f32 compute, for
// sm_90a.  qmm_wire.cu holds K10 at B <= 8.
//
// Replaces ggml_hexagon_tpu/ops/qmatmul.py `_qmm_kernel`, launched through
// `pallas_call` in `_qmatmul_pallas` (entry `qmatmul_pallas`), above 8 rows.
//
// What bounds it: operations at B = 512 (2*B*N*K flops against 2.4-8.5
// bits a weight; in f32 three TF32 products a multiply-add), bytes at the
// smallest batches.
//
// Design (K3's and K6's GEMM, qp8_gemm.cu and fast_il_gemm.cu, carried over
// to the wire planes):
//  * Swap-AB wgmma: the weight rows are M (two consumer warpgroups of 64,
//    128 rows a block), the tokens N (tiles of 32 for B <= 32, 128 for B
//    <= 128, else 256; 64 in f32).  Token rows past B are zeros from TMA
//    and never stored.  A thread owns rows a and a+1 (wgmma rows g and
//    g+8) and 8 consecutive columns of every 32-column chunk.
//  * The weight goes to wgmma from registers (A), decoded with the
//    contract of wire.cuh (decode4: one prmt to 2^23 + code, the exact
//    subtraction, the scale and the bias without FMA) and rounded to bf16
//    once; it never exists in device or shared memory.  f32: the decoded
//    weight and x are each split into two TF32 parts (big = rna(v), small =
//    rna(v - big)) and meet in three products, small*big + big*small +
//    big*big, as K11 does.  The tensor cores' sums of a chain of wgmmas
//    lose more than f32 rounding: against the plain twin's f32 product the
//    NMSE grew with the square of the chain (4.9e-11, 1.9e-10, 7.7e-10 at
//    16, 32, 64 stages of a 4096 x 4096 Q4_K weight on an H100 80GB HBM3),
//    so every PROMOTE chunks the accumulators are added into f32 registers
//    and restart from zero.
//  * A stage is 64 columns of K: for one low-plane box r (of R sharing a
//    high byte) the hw = 64/per consecutive high positions h0.., and with
//    them the per runs (s, r) of hw columns s*Kp + r*Kph + h0..  Its tiles
//    come by TMA from one producer thread: the low box [128][hw] and the
//    high box [128][hw] (the hw-byte swizzle; none at 16), x as one
//    [N][64] bf16 box (or four [N][32] f32 boxes, big and small).  The
//    scales: where every scale plane's row pitch is whole 16-byte units (K
//    a multiple of 1024 for the super-block types: the 8B's 4096 and
//    14336), one [128][16-byte] TMA box of each plane a run, holding the
//    run's groups; else (d of K = 11008 is 172 bytes a row, sc at gs = 32
//    344) the producer warpgroup's 128 threads copy one row's records each
//    (wire.cuh) by 4-byte cp.async into the same ring slot, arriving on
//    its mbarrier.  Row-strided 4-byte copies cost the 8B's gate at B =
//    512 0.080 of 0.272 ms on an H100 80GB HBM3.  A high plane's box is
//    fetched once for each of its R low boxes.
//  * x is rounded once, by a pre-pass launch, into the stages' run order,
//    permuted inside every 32-column chunk so that a thread's 8 columns are
//    its A fragment's k indices: one 8-byte load of plane bytes a row and
//    chunk (bf16: K6's permutation; TF32 k8 steps their own).
//  * The consumers decode a stage chunk by chunk (32 columns: two k16
//    wgmmas, or four k8 steps of three in f32), the next chunk while the
//    last one's wgmmas run, and release a slot with one arrival a warp.
//    The 256-token tile's 128 accumulators leave no registers for two
//    whole stages' fragments; ptxas still serialises its wgmmas (C7512),
//    and a 192-token tile that it does not serialise ran 30% slower at B
//    = 512 on an H100 (three token tiles decode the weights three times).
//  * Where the tiles leave SMs idle (kernels.pick_wire_gemm), K is split
//    over blocks, whole stages a split; the last block of a tile sums the
//    splits' partials in split order (an int32 counter a tile, reset by
//    that block): deterministic, no float atomics, no second launch.
//  * All twelve plane families are compile-time template instances, at
//    each token tile.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "codes.cuh"
#include "hopper.cuh"
#include "wire.cuh"

namespace {

constexpr int KT = 64;             // K columns a stage
constexpr int NCW = 8;             // consumer warps (two warpgroups)
constexpr int NCT = NCW * 32;
constexpr int NTH = NCT + 128;     // and a producer warpgroup
constexpr int BNL = 128;           // weight rows a block
constexpr int PRE_THREADS = 256;
constexpr int SMEM_MAX = 232448;   // shared memory a block may take
constexpr int F32_N = 64;          // the token tile of f32 compute
constexpr int PROMOTE = 8;         // f32: chunks a chain of wgmma sums

__host__ __device__ constexpr int align1024(int v) { return (v + 1023) & ~1023; }

// cvt.rna.tf32.f32, and an f32 value split into two TF32 parts: big =
// rna(x), small = rna(x - big) (three products big*big + big*small +
// small*big carry the f32 product to about 2^-21 relative).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// The token tile (wgmma's N) at B rows (kernels.wire_gemm_tile mirrors it).
__host__ __device__ inline int token_tile(int B, bool f32) {
  return f32 ? F32_N : B <= 32 ? 32 : B <= 128 ? 128 : 256;
}

// Whether every scale plane of a family at K has a TMA row pitch (whole
// 16-byte units): d and dmin f32 [K/256] or [K/gs], sc and m8 [K/gs].
__host__ __device__ inline bool tma_scales(int K, int gs, bool sup, int asym) {
  if (sup) return K % 1024 == 0 && (K / gs) % 16 == 0;
  return (K / gs) % 4 == 0;
}

// A family's stages (kernels.wire_gemm_geo mirrors it): per values a
// low-plane byte, Kp low and Kph high bytes a row, R = Kp/Kph, hw = 64/per
// high positions a stage, nh stages a low box r, nst = K/64 stages; a run's
// record (wire.cuh): n groups, scw sc words, nrec words; rtma: the scales
// come as TMA boxes, npl planes a run (super-block: d, sc, then dmin, m8;
// else d, then mf), each [128][16 bytes].  A ring slot of sb bytes: the x
// tile, the low box at lo, the high box at hi, the scales at rec (the 128
// rows' per records, or per*npl boxes), each region 1024-aligned.
struct GemmGeo {
  int per, Kp, Kph, R, hw, nh, nst, n, scw, nrec, rtma, npl;
  int lo, hi, rec, sb;
};

__host__ __device__ inline void gemm_geo(GemmGeo* g, int bl, int bh, bool sup, int asym, int K,
                                         int gs, int N, bool f32) {
  g->per = 8 / bl;
  g->Kp = K / g->per;
  g->Kph = bh ? K * bh / 8 : g->Kp;
  g->R = g->Kp / g->Kph;
  g->hw = KT / g->per;
  g->nh = g->Kph / g->hw;
  g->nst = K / KT;
  wire_record(g->hw, gs, sup, asym, &g->n, &g->scw, &g->nrec);
  g->lo = N * KT * (f32 ? 8 : 2);  // bf16 [N][64], or f32 [2][2][N][32]
  g->hi = g->lo + BNL * g->hw;
  g->rec = g->hi + (bh ? BNL * g->hw : 0);
  g->rtma = tma_scales(K, gs, sup, asym);
  g->npl = (sup ? 2 : 1) * (asym != A_NONE ? 2 : 1);
  g->sb = align1024(g->rec + (g->rtma ? g->per * g->npl * BNL * 16 : BNL * g->per * g->nrec * 4));
}

// The block's shared memory: 1024 bytes of alignment slack, ns ring slots,
// the mbarriers full[ns] and empty[ns], the last-block flag.
__host__ __device__ inline int gemm_smem(const GemmGeo& g, int ns) {
  return 1024 + ns * g.sb + 16 * ns + 16;
}

// Inside each 32-column chunk: physical column 8t + 4s + q goes to k16 step
// s's column 2t + (q&1) + 8(q>>1) (bf16, as K6's pre-pass), or 8t + 2s + e
// to k8 step s's column t + 4e (TF32): the k indices thread t holds in a
// wgmma A fragment.
__device__ __forceinline__ int perm_bf16(int p) {
  const int q = p & 31, t = q >> 3, s = (q >> 2) & 1, e = q & 3;
  return (p & ~31) + 16 * s + 2 * t + (e & 1) + 8 * (e >> 1);
}

__device__ __forceinline__ int perm_tf32(int p) {
  const int q = p & 31, t = q >> 3, s = (q >> 1) & 3, e = q & 1;
  return (p & ~31) + 8 * s + t + 4 * e;
}

// x f32 [B, K] -> xp in the stages' order (stage j's 64 columns at 64j,
// run s of hw columns after run s-1, permuted inside each 32-column chunk):
// bf16 [B, K], or f32 [2, B, K] (TF32 big part, then small part).  A
// thread takes 8 neighbouring columns of one row (blockIdx.y), which lie in
// one run: two 16-byte loads; bf16 stores them as four pairs.
__global__ void __launch_bounds__(PRE_THREADS) prepass_kernel(const float* __restrict__ x,
                                                              int B, int K, GemmGeo g,
                                                              int f32, void* __restrict__ xp) {
  const int j = 8 * (blockIdx.x * PRE_THREADS + threadIdx.x);
  if (j >= K) return;
  const int b = blockIdx.y;
  const int st = j / KT, p = j - st * KT;
  const int r = st / g.nh, h0 = (st - r * g.nh) * g.hw;
  const int s = p / g.hw, hh = p - s * g.hw;
  const float4* src =
      reinterpret_cast<const float4*>(x + (size_t)b * K + s * g.Kp + r * g.Kph + h0 + hh);
  const float4 v0 = src[0], v1 = src[1];
  const float v[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
  const size_t o = (size_t)b * K + st * KT;
  if (f32) {
    uint32_t* xo = reinterpret_cast<uint32_t*>(xp);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      uint32_t big, small;
      split_tf32(v[q], big, small);
      const size_t at = o + perm_tf32(p + q);
      xo[at] = big;
      xo[(size_t)B * K + at] = small;
    }
  } else {
    __nv_bfloat16* xo = reinterpret_cast<__nv_bfloat16*>(xp) + o;
#pragma unroll
    for (int q = 0; q < 8; q += 2)
      *reinterpret_cast<uint32_t*>(xo + perm_bf16(p + q)) = pack_bf16(v[q], v[q + 1]);
  }
}

struct GemmArgs {
  Planes P;
  float* out;      // f32 [B, n_pad]
  float* ws;       // f32 [ks, B, n_pad] (ks > 1)
  int* counters;   // one a tile, zero between calls
  GemmGeo g;
  int B, n_pad, ks, ns;
};

// x (bf16, or the TF32 big part), the TF32 small part, the low and high
// plane boxes, the scale planes' [128][16-byte] boxes (rtma): d, then sc
// (super-block) or mf, then dmin, then m8
struct GemmMaps {
  CUtensorMap x, xs, lo, hi, sp[4];
};

// A thread's A fragments of one 32-column chunk: bf16 (ra[j]: row a's
// columns 2j, 2j+1 of its 8; rb row a+1's), or f32 (big and small TF32
// parts of its 8 columns, rows a and a+1).
template <bool F32>
struct Frag {
  uint32_t ra[4], rb[4];
};
template <>
struct Frag<true> {
  uint32_t ba[8], bb[8], sa[8], sb[8];
};

// D[64 x 64] += A[64 x 8] (registers, TF32) * B[8 x 64] (shared, K-major, TF32)
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// The scale (and bias) of row l's columns from position hh of run s (its
// first column cs), from the stage's scales at sc: the records (wire.cuh)
// or the TMA boxes (rtma), read the same way from offsets selected here
// without a branch (so the loads of a stage's pieces can all be issued
// before their products are needed).
template <bool SUPER, int ASYM>
__device__ __forceinline__ void scale_at(const unsigned char* sc, const GemmGeo& g, int l, int s,
                                         int cs, int hh, int lgs, float& scale, float& bias) {
  constexpr int BOX = BNL * 16;                        // a scale box's bytes
  const bool tm = g.rtma;
  const int gl = g.hw >= (1 << lgs) ? hh >> lgs : 0;  // the group within the run
  const int str = tm ? 16 : g.per * g.nrec * 4;       // a row's stride
  const unsigned char* row = sc + (tm ? s * g.npl * BOX : s * g.nrec * 4) + l * str;
  if constexpr (SUPER) {
    constexpr int OSC = ASYM == A_MINSB ? 8 : 4;       // a record's sc bytes
    const int od = tm ? 4 * ((cs >> 8) & 3) : 0;
    const int os = tm ? BOX + ((cs >> lgs) & 15) + gl : OSC + ((cs >> lgs) & 3) + gl;
    scale = __fmul_rn(*reinterpret_cast<const float*>(row + od),
                      (float)*reinterpret_cast<const int8_t*>(row + os));
    if constexpr (ASYM == A_MINSB) {
      const int odm = tm ? 2 * BOX + od : 4;
      const int om = tm ? 2 * BOX + os : os + 4 * g.scw;
      bias = __fmul_rn(-*reinterpret_cast<const float*>(row + odm), (float)row[om]);
    }
  } else {
    const int od = 4 * ((tm ? (cs >> lgs) & 3 : 0) + gl);
    scale = *reinterpret_cast<const float*>(row + od);
    if constexpr (ASYM == A_MIN)
      bias = *reinterpret_cast<const float*>(row + od + (tm ? BOX : 4 * g.n));
  }
}

// Row l's 8 weights in chunk c of the stage in `st` that thread t holds
// (physical columns 32c + 8t..), in f32: the plane bytes at position hh of
// run s, the run's scale (and bias).
template <int BL, int BH, bool SIGNED, bool LUT, bool SUPER, int ASYM>
__device__ __forceinline__ void piece8(const unsigned char* st, const GemmGeo& g, int l, int c,
                                       int t, int r, int h0, int lgs, float qoff,
                                       float (&w)[8]) {
  constexpr int PER = 8 / BL;
  constexpr int HW = KT / PER;
  const int s = PER == 1 ? 0 : PER == 2 ? c : 2 * c + (t >> 1);
  const int hh = PER == 1 ? 32 * c + 8 * t : PER == 2 ? 8 * t : 8 * (t & 1);
  int o;
  if constexpr (HW == 16) o = l * 16 + hh;
  else o = swizzled<HW>(l * HW + hh);
  const uint2 Lw = *reinterpret_cast<const uint2*>(st + g.lo + o);
  uint2 Hw = make_uint2(0u, 0u);
  if constexpr (BH != 0) Hw = *reinterpret_cast<const uint2*>(st + g.hi + o);
  float scale, bias = 0.f;
  scale_at<SUPER, ASYM>(st + g.rec, g, l, s, s * g.Kp + r * g.Kph + h0, hh, lgs, scale, bias);
  const int hs = BH * (s * g.R + r);
  float w0[4], w1[4];
  decode4<BL, BH, SIGNED, LUT, ASYM>(Lw.x, Hw.x, BL * s, hs, scale, bias, qoff, w0);
  decode4<BL, BH, SIGNED, LUT, ASYM>(Lw.y, Hw.y, BL * s, hs, scale, bias, qoff, w1);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    w[e] = w0[e];
    w[4 + e] = w1[e];
  }
}

// The A fragments of rows lp and lp+1 in chunk c.
template <int BL, int BH, bool SIGNED, bool LUT, bool SUPER, int ASYM, bool F32>
__device__ __forceinline__ void decode_frag(const unsigned char* st, const GemmGeo& g, int lp,
                                            int c, int t, int r, int h0, int lgs, float qoff,
                                            Frag<F32>& f) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float w[8];
    piece8<BL, BH, SIGNED, LUT, SUPER, ASYM>(st, g, lp + h, c, t, r, h0, lgs, qoff, w);
    if constexpr (F32) {
      uint32_t* big = h ? f.bb : f.ba;
      uint32_t* small = h ? f.sb : f.sa;
#pragma unroll
      for (int q = 0; q < 8; ++q) split_tf32(w[q], big[q], small[q]);
    } else {
      uint32_t* ra = h ? f.rb : f.ra;
#pragma unroll
      for (int j = 0; j < 4; ++j) ra[j] = pack_bf16(w[2 * j], w[2 * j + 1]);
    }
  }
}

// The wgmmas of chunk c: bf16, its two k16 steps over x [N][64] (128-byte
// rows, 128-byte swizzle); f32, its four k8 steps, three products each,
// over the big and small x boxes [N][32].
template <bool F32, int N>
__device__ __forceinline__ void issue(float (&acc)[N / 2], const Frag<F32>& f, int c,
                                      uint32_t xs) {
  wgmma_fence();
  if constexpr (F32) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint32_t ab[4] = {f.ba[2 * s], f.bb[2 * s], f.ba[2 * s + 1], f.bb[2 * s + 1]};
      const uint32_t as[4] = {f.sa[2 * s], f.sb[2 * s], f.sa[2 * s + 1], f.sb[2 * s + 1]};
      const uint64_t db = smem_desc(xs + c * N * 128 + 32 * s, 16, 1024, 1);
      const uint64_t ds = smem_desc(xs + (2 + c) * N * 128 + 32 * s, 16, 1024, 1);
      wgmma_tf32_n64(acc, as, db);
      wgmma_tf32_n64(acc, ab, ds);
      wgmma_tf32_n64(acc, ab, db);
    }
  } else {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const uint32_t frag[4] = {f.ra[2 * s], f.rb[2 * s], f.ra[2 * s + 1], f.rb[2 * s + 1]};
      wgmma_tile<N>(acc, frag, smem_desc(xs + 32 * (2 * c + s), 16, 1024, 1));
    }
  }
  wgmma_commit();
}

// Pins the accumulators' reads and writes between the asm statements
// around it (a wgmma wait before, the next wgmma fence after).
template <int M>
__device__ __forceinline__ void fence_acc(float (&acc)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NCT) : "memory");
}

template <int BL, int BH, bool SIGNED, bool LUT, bool SUPER, int ASYM, bool F32, int N>
__global__ void __launch_bounds__(NTH, 1)
    wire_gemm_kernel(const __grid_constant__ GemmArgs a, const __grid_constant__ GemmMaps maps) {
  constexpr int PER = 8 / BL;
  constexpr int HIGH = BH > 0;
  // a stage is decoded and issued chunk by chunk: the 256-token tile's 128
  // accumulators leave too few registers for two whole stages' fragments
  constexpr int PIECES = 2;
  constexpr int XB = N * KT * (F32 ? 8 : 2);  // a stage's x bytes
  static_assert(!F32 || N == F32_N, "f32 runs the 64-token tile");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw0 = smem_u32(smem_raw);
  const uint32_t base = (raw0 + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw0);
  const GemmGeo g = a.g;
  const int ns = a.ns;
  const uint32_t bars = base + ns * g.sb;  // full[ns], empty[ns]
  int* flag = reinterpret_cast<int*>(smem + ns * g.sb + 16 * ns);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * BNL, m0 = blockIdx.y * N, split = blockIdx.z;
  // this split's stages [s0, s0 + nps)
  const int s0 = (int)((long long)split * g.nst / a.ks);
  const int nps = (int)((long long)(split + 1) * g.nst / a.ks) - s0;

  if (tid == 0) {
    for (int s = 0; s < ns; ++s) {
      mbar_init(bars + 8 * s, 1 + 128);     // the expected bytes and 128 threads' copies
      mbar_init(bars + 8 * (ns + s), NCW);  // every consumer warp's release
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= NCW) {
    // ---- producer: thread 0 brings the boxes by TMA (the scales too, with
    // rtma), every thread its row's records by 4-byte cp.async otherwise,
    // each thread arriving on the stage's mbarrier (no setmaxnreg: ptxas
    // allots a thread of this 12-warp block at most 168 registers either
    // way) ----
    const int pt = tid - NCT;
    const int row = n0 + pt;
    int r = s0 / g.nh, hi = s0 - r * g.nh;  // stage s0 + i: low box r, position hi
    for (int i = 0, slot = 0, par = 0; i < nps; ++i) {
      if (i >= ns) mbar_wait(bars + 8 * (ns + slot), par ^ 1);
      const int st = s0 + i, h0 = hi * g.hw;
      const uint32_t sbase = base + slot * g.sb, full = bars + 8 * slot;
      if (pt == 0) {
        mbar_expect_tx(full, XB + (1 + HIGH) * BNL * g.hw + (g.rtma ? PER * g.npl * BNL * 16 : 0));
        if constexpr (F32) {
          for (int c = 0; c < 2; ++c) {
            tma_load_2d(sbase + c * N * 128, &maps.x, st * KT + 32 * c, m0, full);
            tma_load_2d(sbase + (2 + c) * N * 128, &maps.xs, st * KT + 32 * c, m0, full);
          }
        } else {
          tma_load_2d(sbase, &maps.x, st * KT, m0, full);
        }
        tma_load_2d(sbase + g.lo, &maps.lo, r * g.Kph + h0, n0, full);
        if (HIGH) tma_load_2d(sbase + g.hi, &maps.hi, h0, n0, full);
        if (g.rtma) {
          // each run's groups in one 16-byte box a plane: d (and dmin) of
          // its super-block, or its groups' d (and mf); sc (and m8)
          const int lgs = a.P.gs_shift;
          for (int s = 0; s < PER; ++s) {
            const int cs = s * g.Kp + r * g.Kph + h0;
            const uint32_t b = sbase + g.rec + s * g.npl * (BNL * 16);
            const int cd = SUPER ? ((cs >> 8) & ~3) : ((cs >> lgs) & ~3);
            const int cg = (cs >> lgs) & ~15;
            tma_load_2d(b, &maps.sp[0], cd, n0, full);
            if (SUPER) tma_load_2d(b + BNL * 16, &maps.sp[1], cg, n0, full);
            if (ASYM == A_MIN) tma_load_2d(b + BNL * 16, &maps.sp[1], cd, n0, full);
            if (ASYM == A_MINSB) {
              tma_load_2d(b + 2 * BNL * 16, &maps.sp[2], cd, n0, full);
              tma_load_2d(b + 3 * BNL * 16, &maps.sp[3], cg, n0, full);
            }
          }
        }
      }
      if (!g.rtma && row < a.n_pad)
        for (int s = 0; s < PER; ++s)
          copy_record<SUPER, ASYM>(a.P, (size_t)row, s * g.Kp + r * g.Kph + h0, g.n, g.scw,
                                   sbase + g.rec + (pt * PER + s) * g.nrec * 4);
      mbar_arrive_cp_async(full);
      if (++slot == ns) slot = 0, par ^= 1;
      if (++hi == g.nh) hi = 0, ++r;
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  const int wg = warp >> 2, w = warp & 3;
  const int t = lane & 3;                             // this thread's columns
  const int lp = wg * 64 + w * 16 + 2 * (lane >> 2);  // its rows (a, a+1)
  const int lgs = a.P.gs_shift;
  const float qoff = wire_qoff<SIGNED, LUT, ASYM>(a.P.off);

  float acc[N / 2];
  float tot[F32 ? N / 2 : 1];  // f32: the sums of the finished chains
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  if constexpr (F32) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) tot[i] = 0.f;
  }

  // Step i's products run while step i+1 is decoded (two fragment sets).
  // The current stage's slot and parity, its low box r and position index
  // hi advance with the steps (no division a step).
  Frag<F32> fr[2];
  const int npc = nps * PIECES;
  int slot = 0, par = 0, r = s0 / g.nh, hi = s0 - r * g.nh, rel = 0;
  auto step = [&](int i, Frag<F32>& f) {
    const int c = i % PIECES;  // the stage's chunk
    if (c == 0) {
      if (i > 0) {
        if (++slot == ns) slot = 0, par ^= 1;
        if (++hi == g.nh) hi = 0, ++r;
      }
      mbar_wait(bars + 8 * slot, par);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    decode_frag<BL, BH, SIGNED, LUT, SUPER, ASYM, F32>(smem + slot * g.sb, g, lp, c, t, r,
                                                       hi * g.hw, lgs, qoff, f);
    issue<F32, N>(acc, f, c, base + slot * g.sb);
  };
  // a stage's slot is free once its last step's products were issued and
  // retired (one arrival a warp: its lanes passed the warpgroup's wait
  // together); stages are released in order
  auto release = [&](int i) {
    if (i % PIECES != PIECES - 1) return;
    if (lane == 0) mbar_arrive(bars + 8 * (ns + rel));
    if (++rel == ns) rel = 0;
  };
  for (int i = 0; i < npc; i += 2) {
    step(i, fr[0]);
    if (i > 0) {
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      release(i - 1);
    }
    if (i + 1 < npc) {
      step(i + 1, fr[1]);
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      release(i);
    }
    if constexpr (F32) {
      if ((i + 2) % PROMOTE == 0 && i + 2 < npc) {
        wgmma_wait0();
        fence_acc(acc);
#pragma unroll
        for (int j = 0; j < N / 2; ++j) tot[j] += acc[j], acc[j] = 0.f;
        fence_acc(acc);
      }
    }
  }
  wgmma_wait0();
  if constexpr (F32) {
    fence_acc(acc);
#pragma unroll
    for (int j = 0; j < N / 2; ++j) acc[j] = tot[j] + acc[j];
  }

  // acc[4i + {0,1}]: row a, tokens 8i + 2t + {0,1}; acc[4i + {2,3}]: row a+1
  const int n = n0 + lp;
  float* dst = a.ks > 1 ? a.ws + (size_t)split * a.B * a.n_pad : a.out;
  if (n < a.n_pad) {
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int m = m0 + 8 * i + 2 * t + u;
        if (m < a.B)
          *reinterpret_cast<float2*>(dst + (size_t)m * a.n_pad + n) =
              make_float2(acc[4 * i + u], acc[4 * i + 2 + u]);
      }
    }
  }
  if (a.ks > 1) {
    __threadfence();
    consumers_sync();
    int* counter = a.counters + blockIdx.y * gridDim.x + blockIdx.x;
    if (tid == 0) *flag = atomicAdd(counter, 1) == a.ks - 1;
    consumers_sync();
    if (*flag) {
      __threadfence();  // the other splits' partials are visible past this
      const int rows = min(N, a.B - m0), q4 = min(BNL, a.n_pad - n0) / 4;
      for (int e = tid; e < rows * q4; e += NCT) {
        const int m = m0 + e / q4, nn = n0 + 4 * (e % q4);
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int q = 0; q < a.ks; ++q) {
          const float4 p = __ldcg(reinterpret_cast<const float4*>(
              a.ws + ((size_t)q * a.B + m) * a.n_pad + nn));
          v.x += p.x; v.y += p.y; v.z += p.z; v.w += p.w;
        }
        *reinterpret_cast<float4*>(a.out + (size_t)m * a.n_pad + nn) = v;
      }
      if (tid == 0) *counter = 0;  // ready for the next call
    }
  }
}

template <int BL, int BH, bool SIGNED, bool LUT, bool SUPER, int ASYM, bool F32, int N>
int gemm_launch(const GemmArgs& a, const GemmMaps& m, cudaStream_t s) {
  static bool attr_set = false;
  auto kern = wire_gemm_kernel<BL, BH, SIGNED, LUT, SUPER, ASYM, F32, N>;
  if (!attr_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((a.n_pad + BNL - 1) / BNL, (a.B + N - 1) / N, a.ks);
  kern<<<grid, NTH, gemm_smem(a.g, a.ns), s>>>(a, m);
  return (int)cudaGetLastError();
}

template <int BL, int BH, bool SIGNED, bool LUT, bool SUPER, int ASYM>
int gemm_launch_n(bool f32, int N, const GemmArgs& a, const GemmMaps& m, cudaStream_t s) {
  if (f32) return gemm_launch<BL, BH, SIGNED, LUT, SUPER, ASYM, true, F32_N>(a, m, s);
  if (N == 32) return gemm_launch<BL, BH, SIGNED, LUT, SUPER, ASYM, false, 32>(a, m, s);
  if (N == 128) return gemm_launch<BL, BH, SIGNED, LUT, SUPER, ASYM, false, 128>(a, m, s);
  return gemm_launch<BL, BH, SIGNED, LUT, SUPER, ASYM, false, 256>(a, m, s);
}

}  // namespace

extern "C" {

const char* ght_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// K10 above 8 rows: the arguments of qmm_wire_gemv_run (fam, f32, x f32
// [B, K], the wire planes, n_pad, gs, off) and the plan of
// kernels.pick_wire_gemm: ks splits of the stages, ns ring slots; scratch
// xp (bf16 [B, K], or f32 [2, B, K] in f32), ws f32 [ks, B, n_pad] (ks >
// 1) and the int32 tile counters (zero, left zero); out f32 [B, n_pad].
int qmm_wire_gemm_run(int fam, int f32, const float* x, int B, int K, const void* q,
                      const void* qh, const float* d, const void* sc, const float* dmin,
                      const void* m, int n_pad, int gs, float off, int ks, int ns, void* xp,
                      float* ws, int* counters, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (fam < 0 || fam > 11 || B < 1 || K < 256 || K % 256 || n_pad < 64 || n_pad % 64 ||
      (gs != 16 && gs != 32 && gs != 256) || ns < 1 || ks < 1 || ks > K / KT ||
      xp == nullptr || (ks > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int* f = WIRE_FAMS[fam];
  const bool f3 = f32 != 0;
  const int N = token_tile(B, f3);
  GemmArgs a{};
  gemm_geo(&a.g, f[0], f[1], f[4] != 0, f[5], K, gs, N, f3);
  if (gemm_smem(a.g, ns) > SMEM_MAX) return (int)cudaErrorInvalidValue;
  a.P = Planes{(const uint8_t*)q, (const uint8_t*)qh, d, (const int8_t*)sc, dmin,
               (const uint8_t*)m, (const float*)m, K, __builtin_ctz(gs), off};
  a.out = out;
  a.ws = ws;
  a.counters = counters;
  a.B = B;
  a.n_pad = n_pad;
  a.ks = ks;
  a.ns = ns;
  GemmMaps maps{};
  bool ok;
  if (f3) {
    const char* xb = reinterpret_cast<const char*>(xp);
    ok = encode_map_2d(&maps.x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, xb, K, B, (long long)K * 4, 32,
                       N, CU_TENSOR_MAP_SWIZZLE_128B) &&
         encode_map_2d(&maps.xs, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, xb + (size_t)B * K * 4, K, B,
                       (long long)K * 4, 32, N, CU_TENSOR_MAP_SWIZZLE_128B);
  } else {
    ok = encode_map(&maps.x, xp, K, B, K, KT, N);
    maps.xs = maps.x;  // unused
  }
  ok = ok && encode_map_2d(&maps.lo, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, a.g.Kp, n_pad, a.g.Kp,
                           a.g.hw, BNL, swizzle_of(a.g.hw));
  if (f[1])
    ok = ok && encode_map_2d(&maps.hi, CU_TENSOR_MAP_DATA_TYPE_UINT8, qh, a.g.Kph, n_pad,
                             a.g.Kph, a.g.hw, BNL, swizzle_of(a.g.hw));
  else
    maps.hi = maps.lo;  // unused
  if (a.g.rtma) {
    // [n_pad][cols] planes of 4-byte (d, dmin, mf) or 1-byte (sc, m8)
    // values, boxes of 16 bytes x 128 rows
    const bool sup = f[4] != 0;
    const int cd = sup ? K / 256 : K / gs, cg = K / gs;
    const void* pl[4] = {d, sup ? sc : m, dmin, m};
    const bool wide[4] = {true, !sup, true, false};
    const int cols[4] = {cd, sup ? cg : cd, cd, cg};
    for (int i = 0; i < a.g.npl; ++i)
      ok = ok && encode_map_2d(&maps.sp[i],
                               wide[i] ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                       : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                               pl[i], cols[i], n_pad, (long long)cols[i] * (wide[i] ? 4 : 1),
                               wide[i] ? 4 : 16, BNL, CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  const dim3 pre((unsigned)((K / 8 + PRE_THREADS - 1) / PRE_THREADS), (unsigned)B);
  prepass_kernel<<<pre, PRE_THREADS, 0, s>>>(x, B, K, a.g, f32, xp);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  switch (fam) {
    case 0: return gemm_launch_n<8, 0, true, false, false, A_NONE>(f3, N, a, maps, s);
    case 1: return gemm_launch_n<4, 0, false, true, false, A_NONE>(f3, N, a, maps, s);
    case 2: return gemm_launch_n<4, 0, false, true, true, A_NONE>(f3, N, a, maps, s);
    case 3: return gemm_launch_n<4, 0, false, false, false, A_NONE>(f3, N, a, maps, s);
    case 4: return gemm_launch_n<4, 0, false, false, false, A_MIN>(f3, N, a, maps, s);
    case 5: return gemm_launch_n<4, 1, false, false, false, A_NONE>(f3, N, a, maps, s);
    case 6: return gemm_launch_n<4, 1, false, false, false, A_MIN>(f3, N, a, maps, s);
    case 7: return gemm_launch_n<2, 0, false, false, true, A_MINSB>(f3, N, a, maps, s);
    case 8: return gemm_launch_n<2, 1, false, false, true, A_NONE>(f3, N, a, maps, s);
    case 9: return gemm_launch_n<4, 0, false, false, true, A_MINSB>(f3, N, a, maps, s);
    case 10: return gemm_launch_n<4, 1, false, false, true, A_MINSB>(f3, N, a, maps, s);
    default: return gemm_launch_n<4, 2, false, false, true, A_NONE>(f3, N, a, maps, s);
  }
}

}  // extern "C"
