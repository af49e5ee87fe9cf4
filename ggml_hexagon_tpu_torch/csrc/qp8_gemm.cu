// K3: qp8 prefill GEMM (B > 8) over transposed qp8 planes, for sm_90a.
//
// Replaces ggml_hexagon_tpu/ops/qmm_qp8.py `_tpf_kernel`, launched through
// `pallas_call` in `_qp8_call(decode=False)`.
//
// What bounds it: operations at the main path's 512-token chunks
// (2*M*K*N bf16 flops against 4.5-6.5 bits per weight: ~1000 flops per
// weight byte at M=512, past the card's bf16 ridge of ~295); bytes at
// the 16- and 32-token buckets.  In practice, at M=512, also the
// L2-to-SM traffic of x: every block of 128 lanes reads all of its token
// tile of x, so x crosses from L2 n2/128 times.
//
// Design (Hopper: wgmma fed by a TMA/cp.async ring, warp-specialised):
//  * Swap-AB.  The weight lanes are wgmma's M side and the tokens its N
//    side: y^T[lanes, tokens] = W[lanes, K] x^T[K, tokens].  A block owns
//    128 lanes (two consumer warpgroups of 64) and N tokens (32 for
//    M <= 32, 128 for M <= 128, else 256: the 32- and 128-token buckets
//    run without padding to 256).  The weight is bf16 only after the
//    per-element decode and rounding, so it goes to wgmma from registers
//    (A operand), decoded and rounded in place, and never exists in
//    shared or device memory; x comes from shared memory (B operand,
//    K-major).  The other option, decoding into a bf16 B tile in shared
//    memory, would write and read every weight element once more through
//    shared memory and pad M=32 to 64-row tiles.
//  * A K-stage is 64 columns organised around the plane with the fewest
//    bits: R byte rows r0..r0+R of that plane (R = 64 / values a byte)
//    taken at all of their shifts, i.e. k = r0 + j + t*P (j < R, P the
//    plane's period).  Every fq byte of the stage (low and high plane) is
//    copied once, read from shared memory by the one thread that owns its
//    lane and unpacked once per output tile.  x's columns come in the
//    same order: one TMA copy per shift run t, an [N][R] block whose
//    R*2-byte rows carry the swizzle of that width (64 and 32 bytes;
//    none for 16), which is the operand layout wgmma reads.  The group
//    scales of the stage (one row per group it touches) are staged beside
//    the bytes and read once per 8-column chunk.
//  * A producer warpgroup (its registers given to the consumers with
//    setmaxnreg) fills a ring of stages: x by TMA, the plane bytes and
//    scales by 16-byte cp.async, each stage's mbarrier counting both.  The
//    two consumer warpgroups wait on it, decode their A fragments, issue
//    four m64nNk16 wgmmas, and decode the next stage into a second set of
//    fragments while those run; a stage is released once the products
//    after it were issued.
//  * Where the output tiles alone leave SMs idle (the 8B's 4096-lane wo
//    and down, Mixtral's experts), K is split over blocks (the host picks
//    the splits, kernels._gemm_splits) and a small kernel sums the
//    partials in split order.
//  * Every weight element is __float2bfloat16_rn(q * scale), rounded
//    before the product as the TPU kernel's w.astype(bf16) * sc does;
//    products go into f32 accumulators in registers.
//  * The affine bias (x's group sums times fb, or off*fs) is an f32
//    [M,G]x[G,N] product.  It runs as extra K-stages of the same
//    pipeline, into the same accumulators: A is the fb (or bf16(off*fs))
//    tile, B the group sums split exactly into three bf16 parts
//    (hi + mid + lo == the f32 sum), written by a small pre-pass.  Each
//    product is exact in f32, so only the order of the f32 sums differs
//    from an f32 dot.  No C tile goes through shared memory: each thread
//    stores its accumulators with 8-byte stores (8 threads cover 64
//    contiguous bytes of an output row).
//  * The planes' rows are addressed with a pitch `ld` apart from the lane
//    count n2, so the MoE prefill runs one expert's lane slice of the
//    stacked planes in place (no copy of ~35 GB of experts per chunk).
//  * Coded planes (the i-quants and ternary) decode their codes to signed
//    int8 values (codes.cuh `decode4_with`, the alphabet looked up once)
//    four at a time; a value (at most 62 in magnitude) is exact in bf16,
//    so bf16(q*scale) rounds as on the other planes.  The plane family
//    (low/high bits) and CODED are template parameters: a run-time branch
//    in the decode once cost the uncoded kernels 30-75%.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "codes.cuh"
#include "hopper.cuh"

namespace {

constexpr int KT = 64;          // K columns a stage
constexpr int NCW = 8;          // consumer warps (two warpgroups)
constexpr int NPT = 128;        // producer threads (one warpgroup)
constexpr int NTH = NCW * 32 + NPT;
constexpr int BNL = 128;        // weight lanes a block
constexpr int RP = 144;         // raw weight row pitch in shared memory
constexpr int FBP = 272;        // fb tile row pitch (64 groups x 128 lanes bf16)
constexpr int SCP = 256;        // scale row pitch
constexpr int SCL_OFF = 48 * RP;     // scales after at most 48 raw rows
constexpr int AREA = 64 * FBP;       // per-stage weight/bias area (bytes)

__host__ __device__ constexpr int xtile_bytes(int n) { return n * KT * 2; }
__host__ __device__ constexpr int stage_bytes(int n) { return xtile_bytes(n) + AREA; }
__host__ __device__ constexpr int n_stages(int n) { return n >= 256 ? 4 : n >= 128 ? 6 : 8; }
__host__ __device__ constexpr int smem_bytes(int n) {
  return 1024 + n_stages(n) * stage_bytes(n) + 2 * n_stages(n) * 8;
}
static_assert(stage_bytes(256) % 1024 == 0 && stage_bytes(128) % 1024 == 0 &&
              stage_bytes(32) % 1024 == 0, "x tiles must stay 1024-aligned");
static_assert(SCL_OFF + 8 * SCP <= AREA, "weight stage overflows its area");

// The x tile of a weight stage holds one block per shift run t, [N][R]
// bf16 rows of R*2 bytes, as TMA wrote them with the matching swizzle:
// 64-byte rows (R=32) and 32-byte rows (R=16) are swizzled atoms of 8 rows,
// 16-byte rows (R=8) are plain core matrices, the next run's block LBO
// bytes on.  Returns the descriptor of 16-column step s.
template <int R, int N>
__device__ __forceinline__ uint64_t weight_step_desc(uint32_t xs, int s) {
  const int c0 = 16 * s;                         // first column of the step
  const uint32_t addr = xs + (c0 / R) * N * R * 2 + (c0 % R) * 2;
  if constexpr (R == 32) return smem_desc(addr, 16, 8 * 64, 2);
  else if constexpr (R == 16) return smem_desc(addr, 16, 8 * 32, 3);
  else return smem_desc(addr, N * 16, 128, 0);
}

// The geometry of a plane family: BL low bits, BH high bits a value.
template <int BL, int BH>
struct Fam {
  static constexpr int PER_LO = 8 / BL;              // values a low byte
  static constexpr int PER_MIN = 8 / (BH ? BH : BL); // values a byte of the
                                                     // plane with fewest bits
  static constexpr int R = KT / PER_MIN;             // its byte rows a stage
  static constexpr int U = PER_MIN / PER_LO;         // low rows per such row
  static constexpr int JB = R / 8;                   // 8-column runs per shift
  static constexpr int LO_ROWS = U * R;
  static constexpr int ROWS = LO_ROWS + (BH ? R : 0);
  static_assert(R >= 8 && ROWS <= 48, "stage geometry");
};

// Column c of a stage (chunk cc = c / 8 of 8 consecutive k) maps to
// t = cc / JB (the shift run) and jb = cc % JB: k = r0 + 8*jb + (c%8) + t*P.

// xgs[m, p*Gp + g] = part p of the f32 sum of x row m over group g
// (hi, mid, lo: three bf16 values whose sum is the f32 sum exactly);
// zero for g >= G.
__global__ void group_sums_kernel(const uint16_t* __restrict__ x, int M, int K,
                                  int gs, int Gp, __nv_bfloat16* __restrict__ xgs) {
  const int G = K / gs;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= M * Gp) return;
  const int m = e / Gp, g = e % Gp;
  float s = 0.f;
  if (g < G) {
    const uint16_t* p = x + (size_t)m * K + (size_t)g * gs;
    for (int i = 0; i < gs; ++i) s += bf2f(p[i]);
  }
  const __nv_bfloat16 hi = __float2bfloat16_rn(s);
  const float r1 = s - __bfloat162float(hi);
  const __nv_bfloat16 mid = __float2bfloat16_rn(r1);
  const __nv_bfloat16 lo = __float2bfloat16_rn(r1 - __bfloat162float(mid));
  __nv_bfloat16* row = xgs + (size_t)m * 3 * Gp;
  row[g] = hi;
  row[Gp + g] = mid;
  row[2 * Gp + g] = lo;
}

struct Args {
  const __nv_bfloat16* x;
  const uint8_t* fq;
  const __nv_bfloat16* fs;
  const __nv_bfloat16* fb;   // null: the bias is off*fs (when bias)
  const __nv_bfloat16* xgs;  // [M, 3*Gp] (when bias)
  float* out;                // [M, n2], or [ks, M, n2] partials when ks > 1
  int n2, ld, gs, gs_shift, cm, M, K, G, Gp, ks;
  float off;
  int bias;
};

// A fragments of one stage for one thread: ra[cc] holds lane a's columns
// 8cc+e0 and 8cc+e0+1, rb[cc] lane a+1's.
struct Frag {
  uint32_t ra[8], rb[8];
};

// Decode this thread's A fragments of weight stage `area` (raw fq rows,
// then the stage's scale rows).
template <int BL, int BH, bool CODED>
__device__ __forceinline__ void decode_weights(const unsigned char* area, int lp, int e0,
                                               int HG, const Args& a, CodeAlphabet al,
                                               Frag& f) {
  using F = Fam<BL, BH>;
  constexpr uint32_t MLO = ((1u << BL) - 1u) * 0x01010101u;
  constexpr uint32_t MHI = BH ? ((1u << BH) - 1u) * 0x01010101u : 0u;
  uint32_t hw[F::JB];
  if constexpr (BH != 0) {
#pragma unroll
    for (int jb = 0; jb < F::JB; ++jb) {
      const int row = F::LO_ROWS + 8 * jb + e0;
      hw[jb] = *reinterpret_cast<const uint16_t*>(area + row * RP + lp) |
               ((uint32_t)*reinterpret_cast<const uint16_t*>(area + (row + 1) * RP + lp) << 16);
    }
  }
#pragma unroll
  for (int u = 0; u < F::U; ++u) {
#pragma unroll
    for (int jb = 0; jb < F::JB; ++jb) {
      const int row = u * F::R + 8 * jb + e0;
      // bytes: lane a col e0, lane b col e0, lane a col e0+1, lane b col e0+1
      const uint32_t lw =
          *reinterpret_cast<const uint16_t*>(area + row * RP + lp) |
          ((uint32_t)*reinterpret_cast<const uint16_t*>(area + (row + 1) * RP + lp) << 16);
#pragma unroll
      for (int s = 0; s < F::PER_LO; ++s) {
        const int t = u + F::U * s;
        const int cc = t * F::JB + jb;
        uint32_t v = (lw >> (BL * s)) & MLO;
        if constexpr (BH != 0) v |= ((hw[jb] >> (BH * t)) & MHI) << BL;
        // each byte into a float's low mantissa: 2^23 + byte (signed codes
        // biased by 128 first)
        float bias = 8388608.f;
        if constexpr (CODED) {
          v = decode4_with(v, al, a.cm == CM_TERN, BH ? 2 : 3) ^ 0x80808080u;
          bias = 8388736.f;
        }
        const float f0 = __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7650)) - bias;
        const float f1 = __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7651)) - bias;
        const float f2 = __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7652)) - bias;
        const float f3 = __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7653)) - bias;
        const int srow = t * HG + (F::R > a.gs ? (8 * jb) >> a.gs_shift : 0);
        const uint32_t sw =
            *reinterpret_cast<const uint32_t*>(area + SCL_OFF + srow * SCP + 2 * lp);
        const float sa = bf2f(sw & 0xffffu), sb = bf2f(sw >> 16);
        const __nv_bfloat162 pa = __floats2bfloat162_rn(f0 * sa, f2 * sa);
        const __nv_bfloat162 pb = __floats2bfloat162_rn(f1 * sb, f3 * sb);
        f.ra[cc] = *reinterpret_cast<const uint32_t*>(&pa);
        f.rb[cc] = *reinterpret_cast<const uint32_t*>(&pb);
      }
    }
  }
}

// A fragments of a bias stage: the fb tile (or bf16(off * fs)).
__device__ __forceinline__ void decode_bias(const unsigned char* area, int lp, int e0,
                                            const Args& a, Frag& f) {
  const bool use_off = a.fb == nullptr;
#pragma unroll
  for (int cc = 0; cc < 8; ++cc) {
    const int row = 8 * cc + e0;
    const uint32_t x0 = *reinterpret_cast<const uint32_t*>(area + row * FBP + 2 * lp);
    const uint32_t x1 = *reinterpret_cast<const uint32_t*>(area + (row + 1) * FBP + 2 * lp);
    uint32_t va = __byte_perm(x0, x1, 0x5410), vb = __byte_perm(x0, x1, 0x7632);
    if (use_off) {
      const __nv_bfloat162 pa = __floats2bfloat162_rn(a.off * bf2f(va & 0xffffu),
                                                      a.off * bf2f(va >> 16));
      const __nv_bfloat162 pb = __floats2bfloat162_rn(a.off * bf2f(vb & 0xffffu),
                                                      a.off * bf2f(vb >> 16));
      va = *reinterpret_cast<const uint32_t*>(&pa);
      vb = *reinterpret_cast<const uint32_t*>(&pb);
    }
    f.ra[cc] = va;
    f.rb[cc] = vb;
  }
}

// The four 16-column wgmmas of a stage: weight stages read x in their
// family's blocks, bias stages a plain [N][64] tile with the 128-byte
// swizzle.
template <int R, int N>
__device__ __forceinline__ void issue_stage(float (&acc)[N / 2], const Frag& f, uint32_t xs,
                                            bool weights) {
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < KT / 16; ++s) {
    const uint32_t frag[4] = {f.ra[2 * s], f.rb[2 * s], f.ra[2 * s + 1], f.rb[2 * s + 1]};
    const uint64_t desc = weights ? weight_step_desc<R, N>(xs, s)
                                  : smem_desc(xs + 32 * s, 16, 1024, 1);
    wgmma_tile<N>(acc, frag, desc);
  }
  wgmma_commit();
}

template <int BL, int BH, bool CODED, int N>
__global__ void __launch_bounds__(NTH, 1) qp8_gemm_kernel(
    const Args a, const __grid_constant__ CUtensorMap tmx,
    const __grid_constant__ CUtensorMap tmg) {
  using F = Fam<BL, BH>;
  constexpr int NS = n_stages(N);
  constexpr int SB = stage_bytes(N);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw0 = smem_u32(smem_raw);
  const uint32_t base = (raw0 + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw0);
  const uint32_t bars = base + NS * SB;  // full[NS], then empty[NS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * BNL, m0 = blockIdx.y * N;
  const int K = a.K;
  const int P_lo = K * BL / 8;                   // low plane's period (rows)
  const int P = BH ? K * BH / 8 : P_lo;          // fewest-bits plane's period
  const int nws = K / KT;                        // weight stages
  const int nst = nws + (a.bias ? 3 * a.Gp / KT : 0);
  // this block's share of the stages (a split of K when ks > 1)
  const int per = (nst + a.ks - 1) / a.ks;
  const int s0 = blockIdx.z * per, ns = max(0, min(nst, s0 + per) - s0);
  const int HG = F::R > a.gs ? F::R / a.gs : 1;  // scale rows per shift run

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(bars + 8 * s, NPT + 1);          // every producer thread's
                                                 // copies, and the TMA's bytes
      mbar_init(bars + 8 * (NS + s), NCW * 32);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= NCW) {
    // ---------------- producer warpgroup ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int pt = tid - NCW * 32;
    for (int i = 0; i < ns; ++i) {
      const int st = s0 + i, slot = i % NS;
      if (i >= NS) mbar_wait(bars + 8 * (NS + slot), ((i / NS) & 1) ^ 1);
      const uint32_t xs = base + slot * SB;
      const uint32_t area = xs + xtile_bytes(N);
      if (st < nws) {
        const int r0 = st * F::R;
        if (pt == 0) {  // x[m0.., r0 + t*P + j], one [N][R] block per run t
          mbar_expect_tx(bars + 8 * slot, xtile_bytes(N));
#pragma unroll
          for (int t = 0; t < F::PER_MIN; ++t)
            tma_load_2d(xs + t * N * F::R * 2, &tmx, r0 + t * P, m0, bars + 8 * slot);
        }
        for (int e = pt; e < F::ROWS * 8; e += NPT) {
          const int row = e >> 3, c = e & 7;
          const int grow = row < F::LO_ROWS ? r0 + (row % F::R) + (row / F::R) * P
                                            : P_lo + r0 + (row - F::LO_ROWS);
          cp_async16(area + row * RP + 16 * c, a.fq + (size_t)grow * a.ld + n0 + 16 * c, 16);
        }
        for (int e = pt; e < F::PER_MIN * HG * 16; e += NPT) {
          const int row = e >> 4, c = e & 15;
          const int g = ((r0 + (row / HG) * P) >> a.gs_shift) + row % HG;
          cp_async16(area + SCL_OFF + row * SCP + 16 * c,
                     a.fs + (size_t)g * a.ld + n0 + 8 * c, 16);
        }
      } else {
        const int b = st - nws, gq = a.Gp / KT;
        const int p = b / gq, g0 = (b % gq) * KT;
        if (pt == 0) {  // the group sums' part p, groups g0..g0+63
          mbar_expect_tx(bars + 8 * slot, xtile_bytes(N));
          tma_load_2d(xs, &tmg, p * a.Gp + g0, m0, bars + 8 * slot);
        }
        const __nv_bfloat16* fbp = a.fb != nullptr ? a.fb : a.fs;
        for (int e = pt; e < KT * 16; e += NPT) {
          const int row = e >> 4, c = e & 15;
          const int g = g0 + row;
          cp_async16(area + row * FBP + 16 * c,
                     fbp + (size_t)(g < a.G ? g : 0) * a.ld + n0 + 8 * c,
                     g < a.G ? 16 : 0);
        }
      }
      mbar_arrive_cp_async(bars + 8 * slot);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // ---------------- consumer warpgroups ----------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = warp >> 2, w = warp & 3;
  const int e0 = 2 * (lane & 3);                     // this thread's column pair
  const int lp = wg * 64 + w * 16 + 2 * (lane >> 2); // its lane pair (a, a+1)

  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;

  const CodeAlphabet al = code_alphabet(a.cm);   // looked up once
  // Stage i's products run while stage i+1 is decoded (two fragment sets);
  // a stage is released once the products after it were issued.
  Frag fr[2];
  auto step = [&](int i, Frag& f) {
    const int st = s0 + i, slot = i % NS;
    mbar_wait(bars + 8 * slot, (i / NS) & 1);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const unsigned char* area = smem + slot * SB + xtile_bytes(N);
    if (st < nws) decode_weights<BL, BH, CODED>(area, lp, e0, HG, a, al, f);
    else decode_bias(area, lp, e0, a, f);
    issue_stage<F::R, N>(acc, f, base + slot * SB, st < nws);
  };
  for (int i = 0; i < ns; i += 2) {
    step(i, fr[0]);
    if (i > 0) {
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      mbar_arrive(bars + 8 * (NS + (i - 1) % NS));
    }
    if (i + 1 < ns) {
      step(i + 1, fr[1]);
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      mbar_arrive(bars + 8 * (NS + i % NS));
    }
  }
  wgmma_wait0();

  // acc[4i + {0,1}]: lane a, tokens 8i + e0 + {0,1}; acc[4i + {2,3}]: lane a+1
  float* outp = a.out + (size_t)blockIdx.z * a.M * a.n2 + n0 + lp;
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    const int m = m0 + 8 * i + e0;
    if (m < a.M)
      *reinterpret_cast<float2*>(outp + (size_t)m * a.n2) = make_float2(acc[4 * i], acc[4 * i + 2]);
    if (m + 1 < a.M)
      *reinterpret_cast<float2*>(outp + (size_t)(m + 1) * a.n2) =
          make_float2(acc[4 * i + 1], acc[4 * i + 3]);
  }
}

template <int BL, int BH, bool CODED, int N>
int launch(const Args& a, cudaStream_t s) {
  using F = Fam<BL, BH>;
  static bool attr_set = false;
  auto kern = qp8_gemm_kernel<BL, BH, CODED, N>;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(N));
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  // x's [N][R] blocks (a weight stage's runs) and the group sums' [N][64]
  CUtensorMap tmx, tmg;
  if (!encode_map(&tmx, a.x, a.K, a.M, a.K, F::R, N)) return (int)cudaErrorInvalidValue;
  if (a.bias) {
    if (!encode_map(&tmg, a.xgs, 3 * a.Gp, a.M, 3 * a.Gp, KT, N))
      return (int)cudaErrorInvalidValue;
  } else {
    tmg = tmx;  // unused
  }
  dim3 grid(a.n2 / BNL, (a.M + N - 1) / N, a.ks);
  kern<<<grid, NTH, smem_bytes(N), s>>>(a, tmx, tmg);
  return (int)cudaGetLastError();
}

template <int BL, int BH, bool CODED>
int launch_n(const Args& a, cudaStream_t s) {
  if (a.M <= 32) return launch<BL, BH, CODED, 32>(a, s);
  if (a.M <= 128) return launch<BL, BH, CODED, 128>(a, s);
  return launch<BL, BH, CODED, 256>(a, s);
}

int launch_family(const Args& a, int bl, int bh, cudaStream_t s) {
  if (a.cm) {
    if (bl == 4 && bh == 0) return launch_n<4, 0, true>(a, s);   // iq3 codes
    if (bl == 2 && bh == 0) return launch_n<2, 0, true>(a, s);   // ternary
    if (bl == 2 && bh == 1) return launch_n<2, 1, true>(a, s);   // iq2, iq1
  } else {
    if (bl == 4 && bh == 0) return launch_n<4, 0, false>(a, s);  // Q4_K, Q4_0
    if (bl == 4 && bh == 1) return launch_n<4, 1, false>(a, s);  // Q5_K, Q5_0
    if (bl == 4 && bh == 2) return launch_n<4, 2, false>(a, s);  // Q6_K
    if (bl == 2 && bh == 0) return launch_n<2, 0, false>(a, s);  // Q2_K
    if (bl == 2 && bh == 1) return launch_n<2, 1, false>(a, s);  // Q3_K
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* ght_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// x bf16 [M, K]; fq/fs/fb t-planes of n2 lanes and row pitch ld, coded
// with code-map cm (0: uncoded); xg scratch of at least M * 3 * Gp bf16
// (Gp = K/gs rounded up to 64; written here when a bias applies); ks
// splits of K, with ws scratch f32 [ks, M, n2] when ks > 1; out f32
// [M, n2].
int qp8_gemm_run(const void* x, const void* fq, const void* fs, const void* fb,
                 int n2, int ld, int bl, int bh, int gs, float off, int cm,
                 int M, int K, void* xg, int ks, float* ws, float* out,
                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int bmin = bh ? bh : bl;
  const int R = KT * bmin / 8;
  if (M < 1 || K % KT || n2 % BNL || ld % 16 || gs < 8 || (gs & (gs - 1)) ||
      K % gs || (K * bmin / 8) % R || ks < 1 || (ks > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = (const __nv_bfloat16*)x;
  a.fq = (const uint8_t*)fq;
  a.fs = (const __nv_bfloat16*)fs;
  a.fb = (const __nv_bfloat16*)fb;
  a.xgs = (const __nv_bfloat16*)xg;
  a.out = ks > 1 ? ws : out;
  a.n2 = n2;
  a.ld = ld;
  a.gs = gs;
  a.gs_shift = __builtin_ctz(gs);
  a.cm = cm;
  a.M = M;
  a.K = K;
  a.G = K / gs;
  a.Gp = (a.G + KT - 1) / KT * KT;
  a.ks = ks;
  a.off = off;
  a.bias = fb != nullptr || off != 0.f;
  if (a.bias) {
    if (xg == nullptr) return (int)cudaErrorInvalidValue;
    const int total = M * a.Gp;
    group_sums_kernel<<<(total + 255) / 256, 256, 0, s>>>(
        (const uint16_t*)x, M, K, gs, a.Gp, (__nv_bfloat16*)xg);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int rc = launch_family(a, bl, bh, s);
  if (rc != 0 || ks == 1) return rc;
  const size_t n4 = (size_t)M * n2 / 4;
  ksum_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, s>>>(
      (const float4*)ws, ks, n4, n2, nullptr, 0, (float4*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
