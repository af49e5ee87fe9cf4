// K7: the interleaved dual QKV GEMV, for sm_90a, one launch a call.
//
// Replaces, in ggml_hexagon_tpu/ops/qmm_fast.py, `_dual_kernel` (:872,
// launched through `pallas_call` at :998): two interleaved projections of
// one activation, each of any family (byte, nibble, coded, ternary), with
// its own norm weight and its own group bias.  What bounds it is bytes, as
// K6's (il_gemv.cuh).
//
// Design: K6's block at B <= 8 (il_gemv.cuh's steps), over two parts, the
// plane sets a and b, each with its own family, tensor maps, norm weight,
// bias and plan (kernels.pick_il_dual shares the persistent blocks between the
// parts by their plane bytes): part a's blocks come first in grid.x, then
// part b's.  A block serves one part for its whole life: it picks its body
// once, from the part's family, and that body builds the part's activation
// as K6 does and writes its rows into the part's columns of the one output
// row.  Each part's arguments are a kernel parameter of their own, which
// the body reads as K6's reads its own (a run-time choice of one parameter
// block or another, read through a pointer, made the activation build read
// them again after each shared store, and a copy in registers spilled).
// So a kernel instance holds one body a part slot and family, 8 in all,
// and both parts take one residue block width: 128 groups where both
// parts' planes take it (the configurations' pairs), else 16 (il_geo's
// gw_max: every G that is a multiple of 8 stages at 16, the last block
// ragged): two instances.
#include "il_gemv.cuh"

namespace {

// One block of a part: fast_il.cu's il_gemv_kernel for K6's rows (B <= 8,
// no residual), a function of the part's arguments, its first tile bx, its
// tile stride nbx and its K split, writing rows of ldo outputs.  K6 keeps
// its own copy of this body: with one body for both, K6 on nibble planes
// ran 8-12% slower (the block indices moved into uniform registers).
template <int FAM, int GW>
__device__ __forceinline__ void dual_tiles(const IlArgs& a, const IlMaps& maps, int bx, int nbx,
                                           int split, int ldo) {
  constexpr int RT = GW / 4;  // residues a thread
  constexpr bool PACKED = FAM != FAM_BYTE;
  extern __shared__ __align__(128) unsigned char smem[];
  const IlGeo g = a.g;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int NB = a.NB, gs = a.gs, ns = a.ns, sb = a.sb;
  // this split's stages [s0, s1) of every tile, a whole number, and their
  // residue blocks
  const int s0 = (int)((long long)split * g.nst / a.ks);
  const int s1 = (int)((long long)(split + 1) * g.nst / a.ks);
  const int nps = s1 - s0;
  const int rb_lo = s0 / g.spr, nrbt = (s1 - 1) / g.spr - rb_lo + 1;
  const int ntile = (a.ntiles - bx + nbx - 1) / nbx;
  const int nst = ntile * nps;
  const IlLayout L = il_layout(g, sb, ns, a.arb, gs, NB, a.bias);
  const uint32_t base = smem_u32(smem);
  const uint32_t bars = base + L.bars;  // full[ns], empty[ns], scales_free[2], ready
  const uint32_t sfree = bars + 16 * ns, ready = sfree + 16;
  uint16_t* act = reinterpret_cast<uint16_t*>(smem + L.act);
  uint16_t* xgp = reinterpret_cast<uint16_t*>(smem + L.xgp);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* inv = reinterpret_cast<float*>(smem + L.inv);
  int* flag = reinterpret_cast<int*>(smem + L.flag);

  if (tid == 0) {
    for (int s = 0; s < ns; ++s) {
      mbar_init(bars + 8 * s, 1);           // the producer's expected bytes
      mbar_init(bars + 8 * (ns + s), NCW);  // every consumer warp's release
    }
    mbar_init(sfree, NCW);
    mbar_init(sfree + 8, NCW);
    mbar_init(ready, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == NCW) {
    // ---- producer: one thread keeps the ring full (pp: the warp copies
    // the weights, its lane 0 then hands the stage over) ----
    if (lane == 0 || g.pp) {
      const uint64_t pol = evict_first_policy();
      int nsc = 0;  // scale stages so far
      for (int i = 0, slot = 0, par = 0, ti = 0, j = 0; i < nst; ++i) {
        // one stage in flight while the consumers build the activation,
        // whose loads then meet an idle L2
        if (i == 1) mbar_wait(ready, 0);
        if (i >= ns) mbar_wait(bars + 8 * (ns + slot), par ^ 1);
        const int s = s0 + j, rb = s / g.spr, pb = s - rb * g.spr;
        const int wrow = (bx + ti * nbx) * TR;
        const uint32_t full = bars + 8 * slot;
        const bool scales = j == 0 || pb == 0;
        const int r = nsc & 1;
        if (scales && nsc >= 2) mbar_wait(sfree + 8 * r, ((nsc >> 1) & 1) ^ 1);
        if (g.pp) {
          copy_stage<GW>(a, smem + slot * g.wb, rb, pb, wrow, lane);
          __syncwarp();  // the lanes' copies precede lane 0's arrival
        }
        if (lane == 0) {
          const int tx = (g.pp ? 0 : g.wb) + (scales ? sb : 0);
          if (tx) mbar_expect_tx(full, tx);
          else mbar_arrive(full);
          if (scales) {
            const uint32_t sdst = base + L.scales + r * sb;
            tma_load_2d(sdst, &maps.fs, rb * GW, wrow, full);
            if (a.fb) tma_load_2d(sdst + g.fsb, &maps.fb, rb * GW, wrow, full);
          }
          if (!g.pp) tma_load_3d_ef(base + slot * g.wb, &maps.w, rb * GW, pb * g.NP, wrow, full, pol);
        }
        if (scales) ++nsc;
        if (++slot == ns) slot = 0, par ^= 1;
        if (++j == nps) j = 0, ++ti;
      }
    }
    return;
  }

  // ---- the activation of the split's residue blocks, while the ring fills ----
  const int slab = NB * GW;  // elements of a slab
  if (a.mode == MODE_NORMED) row_norms(a, 0, red, inv, tid);
  build_act<GW>(a, 0, rb_lo, nrbt, act, xgp, inv, tid);
  consumers_sync();
  if (tid == 0) mbar_arrive(ready);

  // ---- the mma over the ring, tile after tile ----
  const int gid = lane >> 2, tq = lane & 3;
  const int nx = min(gid, NB - 1);  // columns past NB repeat the last row; dropped
  const int r0 = 16 * warp + gid;   // the thread's rows r0 and r0 + 8 of a tile
  // a stage's weight bytes: [row][period][residue], or [period][row][residue]
  const int rstep = g.pp ? GW : g.NP * GW, pstep = g.pp ? TR * GW : GW;
  uint32_t s0r[RT / 2], s1r[RT / 2], m0[RT / 2] = {}, m1[RT / 2] = {};
  Decoder dc{};
  if constexpr (FAM == FAM_CODED) dc = decoder_of(a.cm, 3, 64u);
  int slot = 0, par = 0, nsc = 0;
  for (int ti = 0; ti < ntile; ++ti) {
    const int tile = bx + ti * nbx;
    float acc[4] = {0.f, 0.f, 0.f, 0.f}, cb[4] = {0.f, 0.f, 0.f, 0.f};
    for (int j = 0; j < nps; ++j) {
      const int s = s0 + j, rb = s / g.spr, pb = s - rb * g.spr, rbl = rb - rb_lo;
      int scale_region = -1;  // the scale region this stage loaded, freed after its mma
      mbar_wait(bars + 8 * slot, par);
      if (j == 0 || pb == 0) {
        // the residue block's scales, for all its periods
        const int r = nsc & 1;
        const uint16_t* fsr = reinterpret_cast<const uint16_t*>(smem + L.scales + r * sb);
        lds_words<RT / 2>(s0r, fsr + r0 * GW + RT * tq);
        lds_words<RT / 2>(s1r, fsr + (r0 + 8) * GW + RT * tq);
        if constexpr (FAM == FAM_NIB) {
#pragma unroll
          for (int k = 0; k < RT / 2; ++k) {
            m0[k] = bfma2(s0r[k], BF2_M128, BF2_NEG0);
            m1[k] = bfma2(s1r[k], BF2_M128, BF2_NEG0);
          }
        }
        if (pb == 0 && a.bias) {
          // the residue block's bias dot: fb (or fs) against the sums' parts
          uint32_t f0[RT / 2], f1[RT / 2];
          const uint16_t* fbr = a.fb ? fsr + g.fsb / 2 : fsr;
          lds_words<RT / 2>(f0, fbr + r0 * GW + RT * tq);
          lds_words<RT / 2>(f1, fbr + (r0 + 8) * GW + RT * tq);
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            uint32_t xq[RT / 2];
            lds_frag<GW>(xq, xgp + (rbl * 3 + q) * slab, NB, nx, tq);
#pragma unroll
            for (int ch = 0; ch < GW / 16; ++ch)
              mma16816(cb, f0[2 * ch], f1[2 * ch], f0[2 * ch + 1], f1[2 * ch + 1], xq[2 * ch],
                       xq[2 * ch + 1]);
          }
        }
        scale_region = r;
        ++nsc;
      }
      const unsigned char* st = smem + slot * g.wb;
      const uint16_t* xs = act + rbl * gs * slab;
      for (int p = 0; p < g.NP; ++p) {
        uint32_t w0[RT / 4], w1[RT / 4], xa[RT / 2], xb[RT / 2];
        lds_words<RT / 4>(w0, st + r0 * rstep + p * pstep + RT * tq);
        lds_words<RT / 4>(w1, st + (r0 + 8) * rstep + p * pstep + RT * tq);
        const int pg = pb * g.NP + p;
        lds_frag<GW>(xa, xs + pg * slab, NB, nx, tq);
        if constexpr (PACKED) lds_frag<GW>(xb, xs + (pg + g.nper) * slab, NB, nx, tq);
        float d0[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};
        period_mma<FAM, GW>(d0, d1, w0, w1, s0r, s1r, m0, m1, xa, xb, dc);
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k] += d0[k] + d1[k];
      }
      // the slot (and a scale region loaded here) is free once every lane's
      // values have fed its mma: a shared load still in flight must not
      // meet the next TMA copy
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(bars + 8 * (ns + slot));
        if (scale_region >= 0) mbar_arrive(sfree + 8 * scale_region);
      }
      if (++slot == ns) slot = 0, par ^= 1;
    }

    // ---- y + bias, or the split's partial ----
    const int row0 = tile * TR;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int n = 2 * tq + (k & 1), row = row0 + r0 + 8 * (k >> 1);
      if (n >= NB || row >= a.ncols) continue;  // a ragged last tile's rows
      const float bt = a.bias ? (a.fb ? cb[k] : a.off * cb[k]) : 0.f;
      if (a.ks == 1)
        a.out[(size_t)n * ldo + row] = acc[k] + bt;
      else
        a.ws[((size_t)split * NB + n) * a.ncols + row] = acc[k] + bt;
    }
    if (a.ks == 1) continue;
    __threadfence();
    consumers_sync();
    int* counter = a.counters + tile;
    if (tid == 0) *flag = atomicAdd(counter, 1) == a.ks - 1;
    consumers_sync();
    if (*flag) {
      __threadfence();  // the other splits' partials are visible past this
      for (int e = tid; e < NB * TR; e += NCT) {
        const int n = e / TR, row = row0 + e % TR;
        if (row >= a.ncols) continue;
        float v = 0.f;
        for (int q = 0; q < a.ks; ++q) v += __ldcg(a.ws + ((size_t)q * NB + n) * a.ncols + row);
        a.out[(size_t)n * ldo + row] = v;
      }
      if (tid == 0) *counter = 0;  // ready for the next call
    }
    consumers_sync();  // the flag is read before the next tile writes it
  }
}

// The two parts: part 0 takes the first nblk0 blocks of grid.x, part 1 the
// rest; a part's blocks are its nbx blocks along the tiles times its K
// splits; fam: its body; ldo: the output's row pitch, the parts' n2 summed.
struct IlDual {
  IlMaps m0, m1;
  IlArgs p0, p1;
  int nbx0, nbx1, fam0, fam1, nblk0, ldo;
};

template <int GW>
__device__ __forceinline__ void dual_part(const IlArgs& a, const IlMaps& m, int nbx, int fam,
                                          int blk, int ldo) {
  const int bx = blk % nbx, split = blk / nbx;
  switch (fam) {
    case FAM_BYTE: dual_tiles<FAM_BYTE, GW>(a, m, bx, nbx, split, ldo); break;
    case FAM_NIB: dual_tiles<FAM_NIB, GW>(a, m, bx, nbx, split, ldo); break;
    case FAM_CODED: dual_tiles<FAM_CODED, GW>(a, m, bx, nbx, split, ldo); break;
    default: dual_tiles<FAM_TERN, GW>(a, m, bx, nbx, split, ldo); break;
  }
}

template <int GW>
__global__ void __launch_bounds__(NTH, 2) il_dual_kernel(const __grid_constant__ IlDual L) {
  if ((int)blockIdx.x < L.nblk0)
    dual_part<GW>(L.p0, L.m0, L.nbx0, L.fam0, blockIdx.x, L.ldo);
  else
    dual_part<GW>(L.p1, L.m1, L.nbx1, L.fam1, (int)blockIdx.x - L.nblk0, L.ldo);
}

template <int GW>
int dual_launch(const IlDual& L, int blocks, int smem, cudaStream_t s) {
  static bool attr_set = false;
  auto kern = il_dual_kernel<GW>;
  if (!attr_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  kern<<<blocks, NTH, smem, s>>>(L);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ght_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// K7, one launch: two parts of one activation, B <= 8 rows.  Per part:
// x_* bf16 [B, K_*] in natural column order (x itself, or x with zero
// columns where the wrapper padded the part's groups to a multiple of 8;
// the normed mode's mean divides by kn, the true K), wn_* f32 [K_*]
// interleaved like its planes (both null: no norm), the planes, family,
// code map, bias and group sums as in fast_il_run, and its plan
// (kernels.pick_il_dual: ks_* splits, ns_* ring stages, nbx_* blocks along
// its tiles of 64 rows; ws_* f32 [ks_*, B, n2_*] when ks_* > 1).  counters
// int32, zero: part a's tiles, then part b's.  out f32 [B, n2_a + n2_b].
int fast_dual_run(int B, float eps, int kn,
                  const void* x_a, int K_a, const float* wn_a, const void* fq_a,
                  const void* fs_a, const void* fb_a, int n2_a, int G_a, int nib_a, int cm_a,
                  float off_a, const float* xg_a, int xg_mode_a, int ks_a, int ns_a, int nbx_a,
                  float* ws_a,
                  const void* x_b, int K_b, const float* wn_b, const void* fq_b,
                  const void* fs_b, const void* fb_b, int n2_b, int G_b, int nib_b, int cm_b,
                  float off_b, const float* xg_b, int xg_mode_b, int ks_b, int ns_b, int nbx_b,
                  float* ws_b, int* counters, float* out, void* stream) {
  struct Part {
    const void* x;
    int K;
    const float* wn;
    const void *fq, *fs, *fb;
    int n2, G, nib, cm;
    float off;
    const float* xg;
    int xg_mode, ks, ns, nbx;
    float* ws;
  };
  const Part parts[2] = {
      {x_a, K_a, wn_a, fq_a, fs_a, fb_a, n2_a, G_a, nib_a, cm_a, off_a, xg_a, xg_mode_a, ks_a,
       ns_a, nbx_a, ws_a},
      {x_b, K_b, wn_b, fq_b, fs_b, fb_b, n2_b, G_b, nib_b, cm_b, off_b, xg_b, xg_mode_b, ks_b,
       ns_b, nbx_b, ws_b}};
  if (B < 1 || B > 8 || (wn_a == nullptr) != (wn_b == nullptr) || out == nullptr || kn < 1)
    return (int)cudaErrorInvalidValue;
  const int mode = wn_a != nullptr ? MODE_NORMED : MODE_PLAIN;
  IlDual L{};
  IlArgs* args[2] = {&L.p0, &L.p1};
  IlMaps* maps[2] = {&L.m0, &L.m1};
  int* nbxs[2] = {&L.nbx0, &L.nbx1};
  int* fams[2] = {&L.fam0, &L.fam1};
  // the common residue block width: 128 where both parts take it, else 16
  int gw = 128;
  for (int q = 0; q < 2; ++q) {
    const Part& P = parts[q];
    IlGeo g;
    if (P.G < 128 || !il_geo(&g, P.K, P.G, P.nib != 0)) gw = 16;
  }
  int smem = 0, tile0 = 0;
  for (int q = 0; q < 2; ++q) {
    const Part& P = parts[q];
    IlArgs& a = *args[q];
    const bool bias = P.fb != nullptr || P.off != 0.f;
    if (P.x == nullptr || P.n2 < 1 || kn > P.K ||
        bad_planes(P.nib, P.cm, P.K, P.G, bias, P.xg_mode, P.xg) ||
        !il_geo(&a.g, P.K, P.G, P.nib != 0, gw))
      return (int)cudaErrorInvalidValue;
    a.x = (const uint16_t*)P.x;
    a.wn = P.wn;
    a.kn = kn;
    a.xg_in = P.xg;
    a.out = out + (q ? n2_a : 0);
    a.ws = P.ws;
    a.counters = counters == nullptr ? nullptr : counters + tile0;
    a.mode = mode;
    a.NB = B;
    a.K = P.K;
    a.G = P.G;
    a.gs = P.K / P.G;
    a.xstride = P.K;
    a.xg_mode = P.xg_mode;
    a.ncols = P.n2;
    a.ntiles = (P.n2 + TR - 1) / TR;
    a.ks = P.ks;
    a.ns = P.ns;
    a.fb = P.fb != nullptr;
    a.bias = bias;
    a.cm = P.cm;
    a.off = P.off;
    a.eps = eps;
    const int sm = il_part(a, *maps[q], P.fq, P.fs, P.fb, P.n2, P.nbx);
    *nbxs[q] = P.nbx;
    *fams[q] = il_family(P.cm, P.nib);
    if (sm < 0) return (int)cudaErrorInvalidValue;
    smem = sm > smem ? sm : smem;
    tile0 += a.ntiles;
  }
  L.ldo = n2_a + n2_b;
  L.nblk0 = L.nbx0 * L.p0.ks;
  const int blocks = L.nblk0 + L.nbx1 * L.p1.ks;
  return gw == 128 ? dual_launch<128>(L, blocks, smem, (cudaStream_t)stream)
                   : dual_launch<16>(L, blocks, smem, (cudaStream_t)stream);
}

}  // extern "C"
