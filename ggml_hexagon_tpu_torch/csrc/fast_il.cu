// K6 at B <= 8 and K8: the interleaved-layout quantized GEMV and its
// gathered-expert GEMV, for sm_90a, one il_gemv_kernel launch a call; the
// design, and what each replaces, is il_gemv.cuh's.  K6 above 8 rows (the
// prefill GEMM) is fast_il_gemm.cu; K7 (the dual projection) fast_dual.cu,
// which keeps its own copy of this kernel's body: with one body shared by
// both kernels, K6 on nibble planes ran 8-12% slower (another schedule).
#include "il_gemv.cuh"

namespace {

// grid.x: blocks that take tiles of TR rows blockIdx.x, + gridDim.x, ...;
// grid.y: K splits; grid.z: row groups (K6: one of NB rows; K8: one input
// row each, ids non-null).  A block builds its split's activation once and
// streams its tiles' stages through one ring.
template <int FAM, int GW>
__global__ void __launch_bounds__(NTH, 2)
    il_gemv_kernel(const __grid_constant__ IlArgs a, const __grid_constant__ IlMaps maps) {
  constexpr int RT = GW / 4;  // residues a thread
  constexpr bool PACKED = FAM != FAM_BYTE;
  extern __shared__ __align__(128) unsigned char smem[];
  const IlGeo g = a.g;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int NB = a.NB, gs = a.gs, ns = a.ns, sb = a.sb;
  const int split = blockIdx.y, z = blockIdx.z;
  // this split's stages [s0, s1) of every tile, a whole number, and their
  // residue blocks
  const int s0 = (int)((long long)split * g.nst / a.ks);
  const int s1 = (int)((long long)(split + 1) * g.nst / a.ks);
  const int nps = s1 - s0;
  const int rb_lo = s0 / g.spr, nrbt = (s1 - 1) / g.spr - rb_lo + 1;
  const int ntile = (a.ntiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  bool valid = true;
  int wrow0 = 0;  // the plane row of tile 0
  if (a.ids != nullptr) {
    const int e = __ldg(a.ids + z);
    valid = e >= 0 && e < a.n_exp;
    wrow0 = valid ? e * a.npe : 0;
  }
  const int nst = valid ? ntile * nps : 0;
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
        const int wrow = wrow0 + ((int)blockIdx.x + ti * (int)gridDim.x) * TR;
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
  const int xrow = a.ids != nullptr ? z : 0;  // the block's first input row
  const int slab = NB * GW;                   // elements of a slab
  if (valid) {
    if (a.mode == MODE_NORMED) row_norms(a, xrow, red, inv, tid);
    build_act<GW>(a, xrow, rb_lo, nrbt, act, xgp, inv, tid);
  }
  consumers_sync();
  if (tid == 0) mbar_arrive(ready);

  // ---- the mma over the ring, tile after tile ----
  const int gid = lane >> 2, tq = lane & 3;
  const int nx = min(gid, NB - 1);  // columns past NB repeat the last row; dropped
  const int r0 = 16 * warp + gid;   // the thread's rows r0 and r0 + 8 of a tile
  // a stage's weight bytes: [row][period][residue], or [period][row][residue]
  const int rstep = g.pp ? GW : g.NP * GW, pstep = g.pp ? TR * GW : GW;
  const int rows = a.ids != nullptr ? (int)gridDim.z : NB;  // output rows
  const int nbo = a.ids != nullptr ? 1 : NB;                // this block's
  const float nan = __int_as_float(0x7fc00000);
  uint32_t s0r[RT / 2], s1r[RT / 2], m0[RT / 2] = {}, m1[RT / 2] = {};
  Decoder dc{};
  if constexpr (FAM == FAM_CODED) dc = decoder_of(a.cm, 3, 64u);
  int slot = 0, par = 0, nsc = 0;
  for (int ti = 0; ti < ntile; ++ti) {
    const int tile = (int)blockIdx.x + ti * (int)gridDim.x;
    float acc[4] = {0.f, 0.f, 0.f, 0.f}, cb[4] = {0.f, 0.f, 0.f, 0.f};
    for (int j = 0; j < (valid ? nps : 0); ++j) {
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

    // ---- y + (bias + res), or the split's partial ----
    const int row0 = tile * TR;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int n = 2 * tq + (k & 1), row = row0 + r0 + 8 * (k >> 1);
      if (n >= nbo || row >= a.ncols) continue;  // a ragged last tile's rows
      const int orow = a.ids != nullptr ? z : n;
      const float bt = a.bias ? (a.fb ? cb[k] : a.off * cb[k]) : 0.f;
      if (a.ks == 1) {
        const float r =
            (a.res != nullptr && row < a.n_res) ? a.res[(size_t)orow * a.n_res + row] : 0.f;
        a.out[(size_t)orow * a.ncols + row] = valid ? acc[k] + (bt + r) : nan;
      } else {
        a.ws[((size_t)split * rows + orow) * a.ncols + row] = valid ? acc[k] + bt : nan;
      }
    }
    if (a.ks == 1) continue;
    __threadfence();
    consumers_sync();
    int* counter = a.counters + z * a.ntiles + tile;
    if (tid == 0) *flag = atomicAdd(counter, 1) == a.ks - 1;
    consumers_sync();
    if (*flag) {
      __threadfence();  // the other splits' partials are visible past this
      for (int e = tid; e < nbo * TR; e += NCT) {
        const int n = e / TR, row = row0 + e % TR, orow = a.ids != nullptr ? z : n;
        if (row >= a.ncols) continue;
        float v = 0.f;
        for (int q = 0; q < a.ks; ++q)
          v += __ldcg(a.ws + ((size_t)q * rows + orow) * a.ncols + row);
        if (a.res != nullptr && row < a.n_res) v += a.res[(size_t)orow * a.n_res + row];
        a.out[(size_t)orow * a.ncols + row] = v;
      }
      if (tid == 0) *counter = 0;  // ready for the next call
    }
    consumers_sync();  // the flag is read before the next tile writes it
  }
}

template <int FAM, int GW>
int il_launch(const IlArgs& a, const IlMaps& m, dim3 grid, int smem, cudaStream_t s) {
  static bool attr_set = false;
  auto kern = il_gemv_kernel<FAM, GW>;
  if (!attr_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  kern<<<grid, NTH, smem, s>>>(a, m);
  return (int)cudaGetLastError();
}

template <int FAM>
int il_launch_gw(const IlArgs& a, const IlMaps& m, dim3 grid, int smem, cudaStream_t s) {
  switch (a.g.GW) {
    case 128: return il_launch<FAM, 128>(a, m, grid, smem, s);
    case 64: return il_launch<FAM, 64>(a, m, grid, smem, s);
    case 32: return il_launch<FAM, 32>(a, m, grid, smem, s);
    default: return il_launch<FAM, 16>(a, m, grid, smem, s);
  }
}

// Checks the plan and planes (il_part) and launches nbx x a.ks x rows_z
// blocks over a.ntiles tiles.
int il_run(IlArgs& a, int nibble, const void* fq, const void* fs, const void* fb, int rows_w,
           int nbx, int rows_z, cudaStream_t s) {
  IlMaps m;
  const int smem = il_part(a, m, fq, fs, fb, rows_w, nbx);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(nbx, a.ks, rows_z);
  switch (il_family(a.cm, nibble)) {
    case FAM_TERN: return il_launch_gw<FAM_TERN>(a, m, grid, smem, s);
    case FAM_CODED: return il_launch_gw<FAM_CODED>(a, m, grid, smem, s);
    case FAM_NIB: return il_launch_gw<FAM_NIB>(a, m, grid, smem, s);
    default: return il_launch_gw<FAM_BYTE>(a, m, grid, smem, s);
  }
}

}  // namespace

extern "C" {

const char* ght_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// K6 at B <= 8, one launch.  mode: 0 plain (x bf16 [B, K] in natural column
// order), 1 normed (the same x; wn f32 [K] interleaved, eps), 2 act (x bf16
// [B, 2K], gate ++ up, both interleaved), 3 plain with x interleaved
// already.  nibble: fq uint8 [n2, K/2] packed, else int8 [n2, K]; cm: the
// code map of coded packed planes (0: none); fs bf16 [n2, G]; the bias: fb
// bf16 [n2, G], or off * fs (fb null, off != 0), or none; xg_mode 1 takes
// the group sums xg_in f32 [B, G] (pre-norm in the normed mode), 2 takes
// them from the activation, 0 when there is no bias; res f32 [B, n_res] or
// null.  The normed mode's mean of x^2 divides by kn (K, or the true K of
// planes whose groups the wrapper padded to a multiple of 8, x padded with
// zeros).  The plan (kernels.pick_il_gemv): ks splits of the stages (ws f32
// [ks, B, n2] when ks > 1), ns ring stages, nbx blocks along the tiles of
// 64 rows (the last one ragged); counters int32, one a tile, zero (each
// call leaves them so).
// out f32 [B, n2].
int fast_il_run(int mode, int nibble, int cm, const void* x, int B, int K, const void* fq,
                const void* fs, const void* fb, int n2, int G, float off, const float* xg_in,
                int xg_mode, const float* wn, float eps, int kn, const float* res, int n_res,
                int ks, int ns, int nbx, float* ws, int* counters, float* out, void* stream) {
  const bool bias = fb != nullptr || off != 0.f;
  IlArgs a{};
  if (B < 1 || B > 8 || n2 < 1 || mode < MODE_PLAIN || mode > MODE_PRE_IL ||
      (mode == MODE_NORMED && wn == nullptr) || n_res > n2 || x == nullptr ||
      out == nullptr || bad_planes(nibble, cm, K, G, bias, xg_mode, xg_in) ||
      kn < 1 || kn > K || !il_geo(&a.g, K, G, nibble != 0))
    return (int)cudaErrorInvalidValue;
  a.x = (const uint16_t*)x;
  a.wn = wn;
  a.kn = kn;
  a.xg_in = xg_in;
  a.res = res;
  a.out = out;
  a.ws = ws;
  a.counters = counters;
  a.mode = mode;
  a.NB = B;
  a.K = K;
  a.G = G;
  a.gs = K / G;
  a.xstride = mode == MODE_ACT ? 2 * K : K;
  a.xg_mode = xg_mode;
  a.n_res = res != nullptr ? n_res : 0;
  a.ncols = n2;
  a.ntiles = (n2 + TR - 1) / TR;
  a.ks = ks;
  a.ns = ns;
  a.fb = fb != nullptr;
  a.bias = bias;
  a.cm = cm;
  a.off = off;
  a.eps = eps;
  return il_run(a, nibble, fq, fs, fb, n2, nbx, 1, (cudaStream_t)stream);
}

// K8, one launch.  x bf16 [P, K] in natural column order; ids int32 [P] on
// the card; stacked interleaved planes of n_exp*npe rows (family, code map,
// bias as in fast_il_run); xg_in f32 [P, G] the group sums of x where the
// planes carry a bias; the plan as in fast_il_run (ws f32 [ks, P, npe],
// counters one a tile of an expert's rows and input row); out f32 [P, npe].
int fast_indirect_run(const void* x, int P, int K, const int* ids, int npe, int n_exp,
                      const void* fq, const void* fs, const void* fb, int G, int nibble, int cm,
                      float off, const float* xg_in, int ks, int ns, int nbx, float* ws,
                      int* counters, float* out, void* stream) {
  const bool bias = fb != nullptr || off != 0.f;
  IlArgs a{};
  if (P < 1 || P > 65535 || npe < 1 || n_exp < 1 || x == nullptr ||
      ids == nullptr || out == nullptr ||
      bad_planes(nibble, cm, K, G, bias, bias ? 1 : 0, xg_in) ||
      !il_geo(&a.g, K, G, nibble != 0))
    return (int)cudaErrorInvalidValue;
  a.x = (const uint16_t*)x;
  a.xg_in = xg_in;
  a.out = out;
  a.ws = ws;
  a.counters = counters;
  a.ids = ids;
  a.mode = MODE_PLAIN;
  a.NB = 1;
  a.K = K;
  a.G = G;
  a.gs = K / G;
  a.xstride = K;
  a.xg_mode = bias ? 1 : 0;
  a.ncols = npe;
  a.ntiles = (npe + TR - 1) / TR;
  a.ks = ks;
  a.ns = ns;
  a.fb = fb != nullptr;
  a.bias = bias;
  a.cm = cm;
  a.off = off;
  a.npe = npe;
  a.n_exp = n_exp;
  return il_run(a, nibble, fq, fs, fb, n_exp * npe, nbx, P, (cudaStream_t)stream);
}

}  // extern "C"
