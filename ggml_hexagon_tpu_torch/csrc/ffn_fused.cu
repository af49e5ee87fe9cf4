// K9: the whole-FFN megakernel of a decode step, for sm_90a, one persistent
// launch a call.
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
//   phase C  xd = bf16(act(gate) * up), in f32 (act silu, gelu or relu:
//            act.cuh's instance picked once a launch);
//            out = (xd @ down'^T + bias) + h2                           f32
// wo and gate_up are nibble planes (Q4_K-class) with a stored fb; down is
// nibble (Q4_K stored fb, Q4_0 derived -8), byte (Q6_K derived -32, Q5_K
// stored fb) or coded (the i-quants and ternary, codes.cuh, no bias).  The
// down bias is xs @ bf16(tile(fb)) or off * (xs @ bf16(tile(fs))) with xs =
// bf16(xd_lo + xd_hi) on packed planes (the two halves a packed byte pairs),
// xd on byte planes.  Weights: bf16(q * scale) on nibble and coded planes,
// the f32 q * scale on byte planes; every product is summed in f32.
//
// What bounds it: bytes.  At Llama-3-8B widths a layer streams 10.5 MB of
// wo planes, 73.4 MB of gate_up and 36.7 MB (Q4_K) or 66.1 MB (Q6_K) of
// down, each weight byte feeding B multiply-adds (2B on packed planes).
//
// Design: K6's block at B <= 8 (il_gemv.cuh's steps: four consumer warps
// and a producer warp, 64-row tiles, stages of GW residues x NP periods by
// TMA with an evict-first policy (the producer warp's 8-byte copies where G
// is not a multiple of 16), bf16 mma.sync m16n8k16 with the weight rows as M
// and the B <= 8 rows as N, byte weights as two exact bf16 parts, the group
// bias as three more mma against the group sums split into three exact bf16
// parts, split-K partials summed in split order by a tile's last block) over
// three parts, the phases, each with its own tensor maps, family, residue
// block width and plan (kernels.pick_ffn: its splits and its blocks along
// its tiles):
//  * One cooperative launch of a persistent grid, the blocks the card holds
//    at once (a grid it cannot hold is refused: cudaErrorCooperativeLaunch-
//    TooLarge), so a block that waits for another's tiles cannot deadlock.
//    Every block takes its phase-A tiles, then its phase-B tiles, then its
//    phase-C tiles (a phase's blocks are the first nbx x ks of the grid).
//  * One ring and one pair of scale regions serve the three phases; a
//    residue block's fb box travels through the ring as a stage of its own
//    (the consumers take its bias dot first and free the slot), so the
//    scale regions hold fs boxes only and the ring is 4 stages deep at B = 1
//    with two blocks an SM (2 with fb beside fs).  The
//    producer warp streams the block's stages of A, then B, then C with no
//    wait at a boundary: the weights depend on nothing the phases compute,
//    so while the consumers wait for the previous phase's results the next
//    phase's first stages are already in flight (the TPU kernel's reason to
//    exist, and what three launches cannot do).
//  * The phases meet at device counters, not at grid barriers: a block adds
//    its finished tiles of phase A (pairs of phase B) to a counter once
//    their outputs are stored (after the split sum) and fenced; a block's
//    consumers acquire that counter (ld.acquire.gpu) at the phase's count
//    before they build the next activation.  What other blocks wrote in
//    this launch is read with ld.global.cg (L2, never L1 or the read-only
//    path).  The last block to finish resets the phase counters and each
//    split tile's last block its tile counter: back-to-back launches and
//    CUDA-graph replays need no host step.
//  * What a phase hands on is what the next one's activation needs, so
//    that each block's build is one round of loads: phase A stores h2 (f32,
//    phase C's residual) and each tile's sums of squares of its rows, which
//    phase B adds in tile order (every block gets the same inv); phase B
//    takes gate tile p and up tile p + n_ff/64 in one block, the same
//    columns, and stores xd = bf16(act(gate) * up) itself (its rows are
//    never split).  The builds (each block only its split's residue blocks,
//    in K6's slab layout): phase A the interleaved bf16 x_a and the caller's
//    group sums; phase B xb = bf16((h2 * inv) * wn) and the group sums of
//    the f32 xb (partial sums of fixed period groups, added in order);
//    phase C the bf16 xd and the sums of xs.
//  * An instance a down family (byte, nibble, coded, ternary) and down
//    residue block width (128 from Gc = 128 up, else 16): 8; phases A and B
//    run the nibble body at width 128 (G % 128 == 0, supports_ffn_fused).
#include "il_gemv.cuh"

namespace {

// A launch: the phases' plane sets and plans, the scratch they hand on, and
// the block's shared-memory layout (byte offsets).
struct FfnLaunch {
  IlMaps ma, mb, mc;        // tensor maps: wo, gate_up, down
  IlArgs pa, pb, pc;        // phase A (wo), B (gate_up), C (down)
  int nbx_a, nbx_b, nbx_c;  // a phase's blocks along its tiles (B: its
                            // pairs); its blocks: nbx x its splits, the
                            // first of the grid
  const float* wn;          // f32 [d] the ffn norm weight, interleaved
  float* ssq;               // f32 [d / 64, 8]: phase A's tiles' sums of h2^2
  uint16_t* xd;             // bf16 [B, n_ff]: phase B's act(gate) * up (its
                            // ACT_* id pb.act)
  int* phase;               // int32 [3]: phase A's finished tiles, B's
                            // finished pairs, finished blocks
  int n_ff, gx;             // xd's width and groups (down's unpadded G)
  int ns, slotb, sbmax;     // ring stages, a slot's bytes, a scale region's
  int scales, act, tval, inv, flag, bars;  // shared-memory offsets
  int xgp_a, xgp_b, part_b, xgp_c;  // offsets in the activation region
};

// The ring's position, carried from phase to phase.
struct Ring {
  int slot, par, nsc;
};

// The stages [s0, s1) of a phase's split: whole stages of every tile.
__device__ __forceinline__ void split_range(const IlGeo& g, int ks, int split, int& s0, int& s1) {
  s0 = (int)((long long)split * g.nst / ks);
  s1 = (int)((long long)(split + 1) * g.nst / ks);
}

// The tile a block's ti-th tile of a phase is: bx, bx + nbx, ... or, paired
// (phase B), the gate tile p and the up tile p + npairs of its pairs p = bx,
// bx + nbx, ...
template <bool PAIRED>
__device__ __forceinline__ int tile_of(int ti, int bx, int nbx, int npairs) {
  if constexpr (PAIRED) return bx + (ti >> 1) * nbx + (ti & 1) * npairs;
  return bx + ti * nbx;
}

// The producer's stages of one phase (K6's producer loop); `sent` counts
// the block's stages over all phases.
template <int GW, bool PAIRED>
__device__ __forceinline__ void produce(const IlArgs& a, const IlMaps& maps, int nbx,
                                        const FfnLaunch& L, Ring& rg, int& sent, int lane) {
  extern __shared__ __align__(128) unsigned char smem[];
  const IlGeo g = a.g;
  const int blk = blockIdx.x, bx = blk % nbx, split = blk / nbx, npairs = a.ntiles / 2;
  int s0, s1;
  split_range(g, a.ks, split, s0, s1);
  const int nps = s1 - s0;
  const int ntile = PAIRED ? 2 * ((npairs - bx + nbx - 1) / nbx) : (a.ntiles - bx + nbx - 1) / nbx;
  const int nst = ntile * nps;
  const uint32_t base = smem_u32(smem), bars = base + L.bars;
  const uint32_t sfree = bars + 16 * L.ns, ready = sfree + 16;
  const uint64_t pol = evict_first_policy();
  // a slot of the ring is free for the block's next stage
  auto next_slot = [&]() {
    // one stage in flight while the consumers build phase A's activation
    if (sent == 1) mbar_wait(ready, 0);
    if (sent >= L.ns) mbar_wait(bars + 8 * (L.ns + rg.slot), rg.par ^ 1);
  };
  for (int i = 0, ti = 0, j = 0; i < nst; ++i) {
    const int s = s0 + j, rb = s / g.spr, pb = s - rb * g.spr;
    const int wrow = tile_of<PAIRED>(ti, bx, nbx, npairs) * TR;
    const bool scales = j == 0 || pb == 0;
    const int r = rg.nsc & 1;
    if (scales && rg.nsc >= 2) mbar_wait(sfree + 8 * r, ((rg.nsc >> 1) & 1) ^ 1);
    if (a.fb && pb == 0) {
      // the residue block's bias plane, a stage of its own
      next_slot();
      if (lane == 0) {
        const uint32_t full = bars + 8 * rg.slot;
        mbar_expect_tx(full, g.fsb);
        tma_load_2d(base + rg.slot * L.slotb, &maps.fb, rb * GW, wrow, full);
      }
      ++sent;
      if (++rg.slot == L.ns) rg.slot = 0, rg.par ^= 1;
    }
    next_slot();
    const uint32_t full = bars + 8 * rg.slot;
    if (g.pp) {
      copy_stage<GW>(a, smem + rg.slot * L.slotb, rb, pb, wrow, lane);
      __syncwarp();  // the lanes' copies precede lane 0's arrival
    }
    if (lane == 0) {
      const int tx = (g.pp ? 0 : g.wb) + (scales ? g.fsb : 0);
      if (tx) mbar_expect_tx(full, tx);
      else mbar_arrive(full);
      if (scales) tma_load_2d(base + L.scales + r * L.sbmax, &maps.fs, rb * GW, wrow, full);
      if (!g.pp)
        tma_load_3d_ef(base + rg.slot * L.slotb, &maps.w, rb * GW, pb * g.NP, wrow, full, pol);
    }
    ++sent;
    if (scales) ++rg.nsc;
    if (++rg.slot == L.ns) rg.slot = 0, rg.par ^= 1;
    if (++j == nps) j = 0, ++ti;
  }
}

// f32 s as three exact bf16 parts, a slab apart.
__device__ __forceinline__ void store_parts(uint16_t* dst, int slab, float s) {
  const uint32_t p1 = __float_as_uint(s) & 0xffff0000u;
  const float r1 = s - __uint_as_float(p1);
  const uint32_t p2 = __float_as_uint(r1) & 0xffff0000u;
  const float r2 = r1 - __uint_as_float(p2);
  dst[0] = (uint16_t)(p1 >> 16);
  dst[slab] = (uint16_t)(p2 >> 16);
  dst[2 * slab] = (uint16_t)(__float_as_uint(r2) >> 16);
}

// One tile's stages [s0, s0 + nps) for one warp, over the ring (K6's mma
// loop): acc the products, cb the bias dot (fb, or fs for off * fs).  Not
// inlined: phases A and B (and C on Q4_K-class downs) run one copy of this
// code, which each SM fetches once a launch: code a block runs once,
// straight through, costs its fetch (a build with its loads taken out ran
// about as long).
template <int FAM, int GW>
__device__ __noinline__ void tile_mma(const IlArgs& a, const FfnLaunch& L, int s0, int nps,
                                      const uint16_t* act, const uint16_t* xgp, Ring& rg,
                                      float (&acc_out)[4], float (&cb_out)[4]) {
  constexpr int RT = GW / 4;  // residues a thread
  constexpr bool PACKED = FAM != FAM_BYTE;
  extern __shared__ __align__(128) unsigned char smem[];
  const IlGeo g = a.g;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int NB = a.NB, gs = a.gs, ns = L.ns, rb_lo = s0 / g.spr;
  const int bias = a.bias, fb = a.fb, slotb = L.slotb;
  const unsigned char* scales = smem + L.scales;
  const int sbmax = L.sbmax;
  int slot = rg.slot, par = rg.par, nsc = rg.nsc;
  const uint32_t bars = smem_u32(smem) + L.bars, sfree = bars + 16 * ns;
  const int slab = NB * GW;  // elements of a slab
  const int gid = lane >> 2, tq = lane & 3;
  const int nx = min(gid, NB - 1);  // columns past NB repeat the last row; dropped
  const int r0 = 16 * warp + gid;   // the thread's rows r0 and r0 + 8 of a tile
  // a stage's weight bytes: [row][period][residue], or [period][row][residue]
  const int rstep = g.pp ? GW : g.NP * GW, pstep = g.pp ? TR * GW : GW;
  uint32_t s0r[RT / 2], s1r[RT / 2], m0[RT / 2] = {}, m1[RT / 2] = {};
  Decoder dc{};
  if constexpr (FAM == FAM_CODED) dc = decoder_of(a.cm, 3, 64u);
  // the sums in registers, stored to the caller's arrays once at the end
  float acc[4] = {0.f, 0.f, 0.f, 0.f}, cb[4] = {0.f, 0.f, 0.f, 0.f};
  // the residue block's bias dot: the bias plane (fb, or fs) against the
  // group sums' parts
  auto bias_dot = [&](const uint16_t* fbr, int rbl) {
    uint32_t f0[RT / 2], f1[RT / 2];
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
  };
  for (int j = 0; j < nps; ++j) {
    const int s = s0 + j, rb = s / g.spr, pb = s - rb * g.spr, rbl = rb - rb_lo;
    int scale_region = -1;  // the scale region this stage loaded, freed after its mma
    if (fb && pb == 0) {
      // the bias plane's stage: its dot, then the slot is free
      mbar_wait(bars + 8 * slot, par);
      bias_dot(reinterpret_cast<const uint16_t*>(smem + slot * slotb), rbl);
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (ns + slot));
      if (++slot == ns) slot = 0, par ^= 1;
    }
    mbar_wait(bars + 8 * slot, par);
    if (j == 0 || pb == 0) {
      // the residue block's scales, for all its periods
      const int r = nsc & 1;
      const uint16_t* fsr = reinterpret_cast<const uint16_t*>(scales + r * sbmax);
      lds_words<RT / 2>(s0r, fsr + r0 * GW + RT * tq);
      lds_words<RT / 2>(s1r, fsr + (r0 + 8) * GW + RT * tq);
      if constexpr (FAM == FAM_NIB) {
#pragma unroll
        for (int k = 0; k < RT / 2; ++k) {
          m0[k] = bfma2(s0r[k], BF2_M128, BF2_NEG0);
          m1[k] = bfma2(s1r[k], BF2_M128, BF2_NEG0);
        }
      }
      if (pb == 0 && bias && !fb) bias_dot(fsr, rbl);  // off * (xg @ fs)
      scale_region = r;
      ++nsc;
    }
    const unsigned char* st = smem + slot * slotb;
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
    // values have fed its mma
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(bars + 8 * (ns + slot));
      if (scale_region >= 0) mbar_arrive(sfree + 8 * scale_region);
    }
    if (++slot == ns) slot = 0, par ^= 1;
  }
  rg = Ring{slot, par, nsc};
#pragma unroll
  for (int k = 0; k < 4; ++k) acc_out[k] = acc[k], cb_out[k] = cb[k];
}

// Phase A's or C's tiles of this block: (y + bias) + res, or the split's
// partial and, in a tile's last block, the splits summed in split order, +
// res; with `ssq` (phase A), each finished tile's sums of squares of its
// rows' outputs, one a row, in row order.  Returns the tiles finished.
template <int FAM, int GW>
__device__ __forceinline__ int phase_tiles(const IlArgs& a, int nbx, const FfnLaunch& L,
                                           const uint16_t* act, const uint16_t* xgp, Ring& rg,
                                           float* ssq) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, NB = a.NB;
  const int blk = blockIdx.x, bx = blk % nbx, split = blk / nbx;
  int s0, s1;
  split_range(a.g, a.ks, split, s0, s1);
  const int ntile = (a.ntiles - bx + nbx - 1) / nbx;
  const int r0 = 16 * warp + (lane >> 2), tq = lane & 3;
  int* flag = reinterpret_cast<int*>(smem + L.flag);
  float* tval = reinterpret_cast<float*>(smem + L.tval);  // [8][TR] a tile's outputs
  int done = 0;
  for (int ti = 0; ti < ntile; ++ti) {
    const int tile = bx + ti * nbx, row0 = tile * TR;
    float acc[4], cb[4];
    tile_mma<FAM, GW>(a, L, s0, s1 - s0, act, xgp, rg, acc, cb);
    bool fin = a.ks == 1;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int n = 2 * tq + (k & 1), r = r0 + 8 * (k >> 1), row = row0 + r;
      if (n >= NB || row >= a.ncols) continue;  // a ragged last tile's rows
      const float bt = a.bias ? (a.fb ? cb[k] : a.off * cb[k]) : 0.f;
      const size_t o = (size_t)n * a.ncols + row;
      if (fin) {
        const float v = a.res != nullptr ? (acc[k] + bt) + __ldcg(a.res + o) : acc[k] + bt;
        a.out[o] = v;
        if (ssq != nullptr) tval[n * TR + r] = v;
      } else {
        a.ws[(size_t)split * NB * a.ncols + o] = acc[k] + bt;
      }
    }
    if (!fin) {
      __threadfence();
      consumers_sync();
      int* counter = a.counters + tile;
      if (tid == 0) *flag = atomicAdd(counter, 1) == a.ks - 1;
      consumers_sync();
      fin = *flag;
      if (fin) {
        __threadfence();  // the other splits' partials are visible past this
        for (int e = tid; e < NB * TR; e += NCT) {
          const int n = e / TR, r = e % TR, row = row0 + r;
          if (row >= a.ncols) continue;
          const size_t o = (size_t)n * a.ncols + row;
          float v = 0.f;
          for (int q = 0; q < a.ks; ++q) v += __ldcg(a.ws + (size_t)q * NB * a.ncols + o);
          v = a.res != nullptr ? v + __ldcg(a.res + o) : v;
          a.out[o] = v;
          if (ssq != nullptr) tval[n * TR + r] = v;
        }
        if (tid == 0) *counter = 0;  // ready for the next call
      }
    }
    if (fin) {
      ++done;
      if (ssq != nullptr) {
        consumers_sync();  // the tile's outputs are in tval
        if (tid < NB) {
          float v = 0.f;
          for (int r = 0; r < min(TR, a.ncols - row0); ++r) v += tval[tid * TR + r] * tval[tid * TR + r];
          ssq[tile * 8 + tid] = v;
        }
      }
    }
    if (a.ks > 1 || ssq != nullptr) consumers_sync();  // flag and tval read before reuse
  }
  return done;
}

// Phase B's pairs of this block: gate tile p and up tile p + npairs (rows
// of the gate and the up of the same down columns), then xd = bf16(act(gate)
// * up) of those columns (the kernel picks ACT's instance once).  Returns
// the pairs finished.
template <int ACT>
__device__ __forceinline__ int phase_pairs(const IlArgs& a, int nbx, const FfnLaunch& L,
                                           const uint16_t* act, const uint16_t* xgp, Ring& rg) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, NB = a.NB;
  const int npairs = a.ntiles / 2, r0 = 16 * warp + (lane >> 2), tq = lane & 3;
  int done = 0;
  for (int p = blockIdx.x; p < npairs; p += nbx) {
    float gate[4];
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      float acc[4], cb[4];
      tile_mma<FAM_NIB, 128>(a, L, 0, a.g.nst, act, xgp, rg, acc, cb);
      if (half == 0) {
#pragma unroll
        for (int k = 0; k < 4; ++k) gate[k] = acc[k] + cb[k];
        continue;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int n = 2 * tq + (k & 1), c = p * TR + r0 + 8 * (k >> 1);
        if (n < NB) L.xd[(size_t)n * L.n_ff + c] = f2bf(act_mul<ACT>(gate[k], acc[k] + cb[k]));
      }
    }
    ++done;
  }
  return done;
}

// The consumers' stores of a phase are fenced, then one thread adds the
// block's finished tiles (pairs) to the phase's counter.
__device__ __forceinline__ void release_tiles(int* counter, int done, int tid) {
  __threadfence();
  consumers_sync();
  if (tid == 0 && done) atomicAdd(counter, done);
}

// The consumers wait until a phase's counter reaches `target`; trap (a
// launch error, not a hang) if it never does.
__device__ __forceinline__ void acquire_tiles(const int* counter, int target, int tid) {
  if (tid == 0) {
    for (long long spin = 0;; ++spin) {
      int v;
      asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(counter) : "memory");
      if (v >= target) break;
      if (spin > (1ll << 26)) __trap();
      __nanosleep(64);
    }
  }
  consumers_sync();
}

// The bf16 slabs of residue blocks [rb_lo, rb_lo + nrbt) from an
// interleaved bf16 source: element (b, p, g) at x[b * ldx + p * gx + g],
// zero past gx groups (and past the planes' G); COHERENT: the source was
// written in this launch (ld.global.cg).
template <int GW, bool COHERENT>
__device__ __forceinline__ void build_pre(const IlArgs& a, const uint16_t* x, int ldx, int gx,
                                          int rb_lo, int nrbt, uint16_t* act, int tid) {
  constexpr int U = 4;  // loads in flight a thread
  const int NB = a.NB, gs = a.gs, slab = NB * GW;
  const int per_rb = gs * (GW / 8), nch = nrbt * per_rb, ntask = NB * nch;
  const bool vec = gx % 8 == 0;
  for (int t0 = tid; t0 < ntask; t0 += U * NCT) {
    uint4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int task = min(t0 + u * NCT, ntask - 1), b = task / nch, q = task - b * nch;
      const int rbl = q / per_rb, q2 = q - rbl * per_rb, p = q2 / (GW / 8);
      const int g0 = (rb_lo + rbl) * GW + (q2 - p * (GW / 8)) * 8;
      const uint4* src = reinterpret_cast<const uint4*>(x + (size_t)b * ldx + (size_t)p * gx + g0);
      v[u] = make_uint4(0u, 0u, 0u, 0u);
      if (vec && g0 < gx) v[u] = COHERENT ? __ldcg(src) : __ldg(src);
    }
#pragma unroll 1
    for (int u = 0; u < U; ++u) {
      const int task = t0 + u * NCT;
      if (task >= ntask) break;
      const int b = task / nch, q = task - b * nch;
      const int rbl = q / per_rb, q2 = q - rbl * per_rb, p = q2 / (GW / 8);
      const int r0 = (q2 - p * (GW / 8)) * 8, g0 = (rb_lo + rbl) * GW + r0;
      uint32_t w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
      if (!vec) {
        // gx % 8 != 0 (padded ternary planes): element loads, zeros past gx
        const uint16_t* src = x + (size_t)b * ldx + (size_t)p * gx + g0;
#pragma unroll 1
        for (int i = 0; i < 8; ++i)
          if (g0 + i < gx)
            w[i >> 1] |= (uint32_t)(COHERENT ? __ldcg(src + i) : __ldg(src + i)) << (16 * (i & 1));
      }
      uint16_t* dst = act + (rbl * gs + p) * slab;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        dst[frag_off<GW>(NB, b, r0 + i)] = (uint16_t)(w[i >> 1] >> (16 * (i & 1)));
    }
  }
}

// Phase A's activation: x_a's slabs and the caller's group sums as three
// bf16 parts (their lines prefetched into L2 first, so that both loads
// share one round trip).
__device__ __forceinline__ void build_a(const IlArgs& a, int rb_lo, int nrbt, uint16_t* act,
                                        uint16_t* xgp, int tid) {
  const int NB = a.NB, G = a.G, slab = NB * 128;
  const char* xg = reinterpret_cast<const char*>(a.xg_in);
  for (int i = tid * 128; i < NB * G * 4; i += NCT * 128)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(xg + i));
  build_pre<128, false>(a, a.x, a.xstride, G, rb_lo, nrbt, act, tid);
  for (int t = tid; t < NB * nrbt * 128; t += NCT) {
    const int b = t / (nrbt * 128), i = t - b * nrbt * 128, rbl = i / 128, r = i - rbl * 128;
    const int g = (rb_lo + rbl) * 128 + r;
    store_parts(xgp + rbl * 3 * slab + frag_off<128>(NB, b, r), slab,
                g < G ? __ldg(a.xg_in + (size_t)b * G + g) : 0.f);
  }
}

// HWP periods [p, p + HWP) (to pend) of four groups g0 .. g0 + 3 of an h2 row
// and of wn (zeros past G).  Two a load, in loops that are unrolled: an
// array indexed at run time lives in local memory, which the little L1
// beside two blocks' shared memory does not hold (phase B's build took
// 7.5 us so, 3.7 us in registers), and four a load made ptxas spill in
// tile_mma (k9_timeline).
constexpr int HWP = 2;
__device__ __forceinline__ void load_hw(const float* hr, const float* wn, int G, int g0, int p,
                                        int pend, float4 (&h)[HWP], float4 (&w)[HWP]) {
#pragma unroll
  for (int u = 0; u < HWP; ++u) {
    h[u] = w[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (g0 < G && p + u < pend) {
      h[u] = __ldcg(reinterpret_cast<const float4*>(hr + (size_t)(p + u) * G + g0));
      w[u] = __ldg(reinterpret_cast<const float4*>(wn + (size_t)(p + u) * G + g0));
    }
  }
}

// Phase B's activation (its one split holds every residue block): inv[b] =
// 1/sqrt(mean(h2^2) + eps) from phase A's tiles' sums of squares, added in
// one fixed order (every block the same), then xb = bf16((h2 * inv) * wn)
// into the slabs and the group sums of the f32 xb: thread (q, pg) sums groups
// 4q .. 4q + 3 over the periods of period group pg into `part`, and the
// parts are added in order, then split into three bf16 parts.  A thread's
// first h2 and wn loads are made before the sums of squares are added:
// both share one round trip.
__device__ __forceinline__ void build_b(const IlArgs& a, const FfnLaunch& L, const float* h2,
                                        uint16_t* act, uint16_t* xgp, float* part, int tid) {
  constexpr int GW = 128;
  extern __shared__ __align__(128) unsigned char smem[];
  float* tv = reinterpret_cast<float*>(smem + L.tval);
  float* inv = reinterpret_cast<float*>(smem + L.inv);
  const int NB = a.NB, d = a.K, G = a.G, gs = a.gs, slab = NB * GW, nta = L.pa.ntiles;
  const int W = a.g.nrb * GW, Q = W / 4;
  int PG = Q <= NCT / 4 ? 4 : Q <= NCT / 2 ? 2 : 1;
  while (gs % PG) PG >>= 1;
  const int ppg = gs / PG;
  float4 h[HWP], w[HWP];  // indexed only by unrolled loops: registers
  if (tid < Q * PG)
    load_hw(h2, L.wn, G, (tid % Q / (GW / 4)) * GW + (tid % Q % (GW / 4)) * 4, tid / Q * ppg,
            tid / Q * ppg + ppg, h, w);
#pragma unroll 4
  for (int i = tid; i < nta * NB; i += NCT) tv[i] = __ldcg(L.ssq + (i / NB) * 8 + i % NB);
  consumers_sync();
  if (tid < 32) {
    // row b's tiles' sums: lane l adds tiles l, l + 32, ..., then the lanes
    // by xor shuffles (one order, every block)
    for (int b = 0; b < NB; ++b) {
      float s = 0.f;
      for (int t = tid; t < nta; t += 32) s += tv[t * NB + b];
      s = warp_sum(s);
      if (tid == 0) inv[b] = 1.f / sqrtf(s / (float)a.kn + a.eps);
    }
  }
  consumers_sync();
  for (int t = tid; t < Q * PG; t += NCT) {
    const int q = t % Q, pg = t / Q, rbl = q / (GW / 4), r0 = (q - rbl * (GW / 4)) * 4;
    const int g0 = rbl * GW + r0, p0 = pg * ppg, pend = p0 + ppg;
    uint16_t* blk = act + rbl * gs * slab;
    for (int b = 0; b < NB; ++b) {
      const float* hr = h2 + (size_t)b * d;
      const float ib = inv[b];
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      for (int p = p0; p < pend; p += HWP) {
        if (t != tid || b != 0 || p != p0) load_hw(hr, L.wn, G, g0, p, pend, h, w);
#pragma unroll
        for (int u = 0; u < HWP; ++u) {
          if (p + u >= pend) break;
          const float v[4] = {h[u].x * ib * w[u].x, h[u].y * ib * w[u].y, h[u].z * ib * w[u].z,
                              h[u].w * ib * w[u].w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            blk[(p + u) * slab + frag_off<GW>(NB, b, r0 + k)] = f2bf(v[k]);
            s[k] += v[k];
          }
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) part[(pg * NB + b) * W + q * 4 + k] = s[k];
    }
  }
  consumers_sync();
  for (int t = tid; t < NB * W; t += NCT) {
    const int b = t / W, i = t - b * W, rbl = i / GW, r = i - rbl * GW;
    float s = 0.f;
    for (int pg = 0; pg < PG; ++pg) s += part[(pg * NB + b) * W + i];
    store_parts(xgp + rbl * 3 * slab + frag_off<GW>(NB, b, r), slab, s);
  }
}

// Phase C's activation: the bf16 xd of the split's residue blocks (zeros
// past gx groups), and with a bias the sums of xs (bf16(xd_lo + xd_hi) on
// packed planes, xd on byte planes) over the periods as three bf16 parts.
template <int GW, bool PACKED>
__device__ __forceinline__ void build_c(const IlArgs& a, const FfnLaunch& L, int rb_lo, int nrbt,
                                        uint16_t* act, uint16_t* xgp, int tid) {
  build_pre<GW, true>(a, L.xd, L.n_ff, L.gx, rb_lo, nrbt, act, tid);
  if (!a.bias) return;
  consumers_sync();  // the activation is complete
  const int NB = a.NB, gs = a.gs, slab = NB * GW;
  const int nper = PACKED ? gs / 2 : gs;  // the sums' terms
  for (int task = tid; task < nrbt * slab; task += NCT) {
    const int rbl = task / slab, q = task - rbl * slab, b = q / GW, r = q - b * GW;
    const uint16_t* col = act + rbl * gs * slab + frag_off<GW>(NB, b, r);
    float s4[4] = {0.f, 0.f, 0.f, 0.f};
    for (int p = 0; p < nper; p += 4) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (p + k >= nper) break;
        float v = bf2f(col[(p + k) * slab]);
        if constexpr (PACKED) v = bf2f(f2bf(v + bf2f(col[(p + k + nper) * slab])));
        s4[k] += v;
      }
    }
    store_parts(xgp + rbl * 3 * slab + frag_off<GW>(NB, b, r), slab,
                (s4[0] + s4[1]) + (s4[2] + s4[3]));
  }
}

// The residue blocks [rb_lo, rb_lo + nrbt) a phase's split touches.
__device__ __forceinline__ void split_blocks(const IlArgs& a, int nbx, int& rb_lo, int& nrbt) {
  int s0, s1;
  split_range(a.g, a.ks, (int)blockIdx.x / nbx, s0, s1);
  rb_lo = s0 / a.g.spr;
  nrbt = (s1 - 1) / a.g.spr - rb_lo + 1;
}

// FAM, GW: the down planes' body and residue block width.
template <int FAM, int GW>
__global__ void __launch_bounds__(NTH, 2) ffn_kernel(const __grid_constant__ FfnLaunch L) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, blk = blockIdx.x;
  const int ns = L.ns;
  const uint32_t bars = smem_u32(smem) + L.bars;  // full[ns], empty[ns], scales_free[2], ready
  const uint32_t sfree = bars + 16 * ns, ready = sfree + 16;
  const bool in_a = blk < L.nbx_a * L.pa.ks, in_b = blk < L.nbx_b, in_c = blk < L.nbx_c * L.pc.ks;

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
    // ---- producer: the block's stages of A, B and C, one ring, no wait at
    // a phase boundary (pp: the warp copies phase C's weights) ----
    if (lane == 0 || L.pc.g.pp) {
      Ring rg{0, 0, 0};
      int sent = 0;
      if (in_a) produce<128, false>(L.pa, L.ma, L.nbx_a, L, rg, sent, lane);
      if (in_b) produce<128, true>(L.pb, L.mb, L.nbx_b, L, rg, sent, lane);
      if (in_c) produce<GW, false>(L.pc, L.mc, L.nbx_c, L, rg, sent, lane);
    }
    return;
  }

  unsigned char* ar = smem + L.act;
  uint16_t* act = reinterpret_cast<uint16_t*>(ar);
  Ring rg{0, 0, 0};
  int rb_lo, nrbt;
  // ---- phase A: wo rows against the attention output, + h -> h2 ----
  int done = 0;
  if (in_a) {
    split_blocks(L.pa, L.nbx_a, rb_lo, nrbt);
    build_a(L.pa, rb_lo, nrbt, act, reinterpret_cast<uint16_t*>(ar + L.xgp_a), tid);
  }
  consumers_sync();
  if (tid == 0) mbar_arrive(ready);
  if (in_a)
    done = phase_tiles<FAM_NIB, 128>(L.pa, L.nbx_a, L, act,
                                     reinterpret_cast<uint16_t*>(ar + L.xgp_a), rg, L.ssq);
  release_tiles(L.phase, done, tid);
  // ---- phase B: the norm of h2, gate_up row pairs -> act(gate) * up ----
  if (in_b) {
    acquire_tiles(L.phase, L.pa.ntiles, tid);
    build_b(L.pb, L, L.pa.out, act, reinterpret_cast<uint16_t*>(ar + L.xgp_b),
            reinterpret_cast<float*>(ar + L.part_b), tid);
    consumers_sync();
    uint16_t* xgp_b = reinterpret_cast<uint16_t*>(ar + L.xgp_b);
    if (L.pb.act == ACT_GELU)
      done = phase_pairs<ACT_GELU>(L.pb, L.nbx_b, L, act, xgp_b, rg);
    else if (L.pb.act == ACT_RELU)
      done = phase_pairs<ACT_RELU>(L.pb, L.nbx_b, L, act, xgp_b, rg);
    else
      done = phase_pairs<ACT_SILU>(L.pb, L.nbx_b, L, act, xgp_b, rg);
    release_tiles(L.phase + 1, done, tid);
  }
  // ---- phase C: down rows + bias + h2 -> out ----
  if (in_c) {
    acquire_tiles(L.phase + 1, L.pb.ntiles / 2, tid);
    split_blocks(L.pc, L.nbx_c, rb_lo, nrbt);
    build_c<GW, FAM != FAM_BYTE>(L.pc, L, rb_lo, nrbt, act,
                                 reinterpret_cast<uint16_t*>(ar + L.xgp_c), tid);
    consumers_sync();
    phase_tiles<FAM, GW>(L.pc, L.nbx_c, L, act, reinterpret_cast<uint16_t*>(ar + L.xgp_c), rg,
                         nullptr);
  }
  // the last block to finish has seen every wait pass: it resets the phase
  // counters for the next launch
  if (tid == 0 && atomicAdd(L.phase + 2, 1) == (int)gridDim.x - 1) {
    L.phase[0] = 0;
    L.phase[1] = 0;
    L.phase[2] = 0;
  }
}

template <int FAM, int GW>
int ffn_launch(const FfnLaunch& L, int blocks, int smem, cudaStream_t s) {
  static bool attr_set = false;
  const void* kern = (const void*)ffn_kernel<FAM, GW>;
  if (!attr_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  void* args[] = {const_cast<FfnLaunch*>(&L)};
  const cudaError_t e = cudaLaunchCooperativeKernel(kern, dim3(blocks), dim3(NTH), args,
                                                    (size_t)smem, s);
  // a refused launch's error is read here, not by the next launch's check
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

template <int FAM>
int ffn_launch_gw(const FfnLaunch& L, int blocks, int smem, cudaStream_t s) {
  return L.pc.g.GW == 128 ? ffn_launch<FAM, 128>(L, blocks, smem, s)
                          : ffn_launch<FAM, 16>(L, blocks, smem, s);
}

// A phase's activation region: the touched residue blocks' slabs, then
// (with a bias) their group sums' three parts, then (phase B) the partial
// group sums of its period groups; returns its end, `xgp` the offset of the
// sums' parts.
int act_region(const IlArgs& a, bool partials, int& xgp) {
  const int slab = a.NB * a.g.GW * 2;
  xgp = align128(a.arb * a.gs * slab);
  int end = xgp + (a.bias ? align128(a.arb * 3 * slab) : 0);
  if (partials) end += 4 * a.NB * a.arb * a.g.GW * 4;
  return end;
}

}  // namespace

extern "C" {

const char* ght_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// K9, one launch.  x_a bf16 [B <= 8, d] (the attention output in wo's
// interleaved column order), xg_a f32 [B, G] its group sums, h_il f32 [B, d]
// the residual interleaved, wn f32 [d] the ffn norm weight interleaved, eps;
// wo uint8 [d, d/2] and gate_up uint8 [2 n_ff, d/2] nibble planes (G % 128
// == 0, G <= 512), each with fs and fb bf16 [., G]; down planes [d, .] of
// K_dn columns in Gc groups, family dn_fam (0 byte int8, 1 nibble, 2 coded
// uint8 packed; cm its code map) with fs bf16 [d, Gc] and the bias fb bf16
// [d, Gc], or off * fs (fb null, off != 0), or none; gx: the down planes'
// groups before kernels.padded_il_planes padded them to Gc (n_ff = K_dn /
// Gc * gx, gate_up's rows in their interleaved order).  The plan
// (kernels.pick_ffn): phase A's ks_a splits and nbx_a blocks along its
// tiles of 64 rows, phase B's nbx_b blocks along its pairs of tiles (never
// split), phase C's ks_c and nbx_c (ws_* f32 [ks_*, B, d] where ks_* > 1),
// ns ring stages, `blocks` persistent blocks (the card must hold them at
// once).  Scratch: h2 f32 [B, d], ssq f32 [d / 64, 8], xd bf16 [B, n_ff];
// counters int32, zero (each call leaves them so): phase A's tiles, C's,
// then 3.  out f32 [B, d], in the il32 order of the permuted rows.  act:
// phase B's activation, an ACT_* id.
int ffn_fused_run(int B, int d, int n_ff, int act, float eps, const void* x_a, const float* xg_a,
                  const float* h_il, const float* wn, int G, const void* wo_q, const void* wo_s,
                  const void* wo_b, const void* gu_q, const void* gu_s, const void* gu_b,
                  const void* dn_q, const void* dn_s, const void* dn_b, int K_dn, int Gc, int gx,
                  int dn_fam, int cm, float dn_off, int ks_a, int nbx_a, int nbx_b, int ks_c,
                  int nbx_c, int ns, int blocks, float* h2, float* ssq, void* xd, float* ws_a,
                  float* ws_c, int* counters, float* out, void* stream) {
  const bool packed = dn_fam != 0;
  const bool bias = dn_b != nullptr || dn_off != 0.f;
  if (B < 1 || B > 8 || d < 64 || d % 64 || n_ff < 1 || n_ff % TR || gx < 1 || Gc < gx ||
      act < ACT_SILU || act > ACT_RELU ||
      K_dn % Gc || n_ff != K_dn / Gc * gx || dn_fam < 0 || dn_fam > 2 ||
      (dn_fam == 2) != (cm != CM_NONE) || x_a == nullptr || xg_a == nullptr ||
      h_il == nullptr || wn == nullptr || wo_b == nullptr || gu_b == nullptr ||
      h2 == nullptr || ssq == nullptr || xd == nullptr || counters == nullptr ||
      out == nullptr || blocks < 1 || bad_planes(1, CM_NONE, d, G, true, 1, xg_a) ||
      bad_planes(packed, cm, K_dn, Gc, bias, bias ? 2 : 0, nullptr))
    return (int)cudaErrorInvalidValue;
  FfnLaunch L{};
  IlArgs& A = L.pa;
  IlArgs& Bp = L.pb;
  IlArgs& C = L.pc;
  // phases A and B at residue blocks of 128 groups, B's whole row a block's
  // activation (G <= 512: its group sums' threads, build_b)
  if (!il_geo(&A.g, d, G, true) || A.g.GW != 128 || G > 512 ||
      !il_geo(&C.g, K_dn, Gc, packed, Gc >= 128 ? 128 : 16))
    return (int)cudaErrorInvalidValue;
  Bp.g = A.g;
  const int nt_a = d / TR, nt_b = 2 * n_ff / TR, nt_c = d / TR;
  // what the phases share
  IlArgs* const phases[3] = {&A, &Bp, &C};
  for (IlArgs* p : phases) {
    p->NB = B;
    p->ns = ns;
    p->fb = 1;
    p->bias = 1;
    p->G = G;
    p->K = d;
    p->gs = d / G;
    p->ks = 1;
  }
  // phase A: the pre-interleaved x_a, the caller's sums, + h_il
  A.x = (const uint16_t*)x_a;
  A.xstride = d;
  A.xg_in = xg_a;
  A.res = h_il;
  A.out = h2;
  A.ncols = d;
  A.ntiles = nt_a;
  A.ks = ks_a;
  A.ws = ws_a;
  A.counters = counters;
  // phase B: the normed gate_up, its gate and up tiles in pairs
  Bp.eps = eps;
  Bp.act = act;
  Bp.kn = d;
  Bp.ncols = 2 * n_ff;
  Bp.ntiles = nt_b;
  // phase C: the down planes on xd, + h2
  C.K = K_dn;
  C.G = Gc;
  C.gs = K_dn / Gc;
  C.fb = dn_b != nullptr;
  C.bias = bias;
  C.cm = cm;
  C.off = dn_b != nullptr ? 0.f : dn_off;
  C.res = h2;
  C.out = out;
  C.ncols = d;
  C.ntiles = nt_c;
  C.ks = ks_c;
  C.ws = ws_c;
  C.counters = counters + nt_a;
  // il_part's own layout check holds fb boxes in the scale regions; here
  // they go through the ring (the layout below is checked in full)
  A.fb = Bp.fb = 0;
  C.fb = 0;
  if (il_part(A, L.ma, wo_q, wo_s, wo_b, d, nbx_a) < 0 ||
      il_part(Bp, L.mb, gu_q, gu_s, gu_b, 2 * n_ff, nbx_b) < 0 ||
      il_part(C, L.mc, dn_q, dn_s, dn_b, d, nbx_c) < 0 || nbx_a * ks_a > blocks ||
      nbx_b > nt_b / 2 || nbx_b > blocks || nbx_c * ks_c > blocks)
    return (int)cudaErrorInvalidValue;
  A.fb = Bp.fb = 1;
  C.fb = dn_b != nullptr;
  L.nbx_a = nbx_a;
  L.nbx_b = nbx_b;
  L.nbx_c = nbx_c;
  L.wn = wn;
  L.ssq = ssq;
  L.xd = (uint16_t*)xd;
  L.phase = counters + nt_a + nt_c;
  L.n_ff = n_ff;
  L.gx = gx;
  L.ns = ns;
  // the layout (kernels.ffn_smem mirrors it): the ring, two scale regions,
  // the activation region (the largest phase's), a tile's outputs (phase
  // A) or the tiles' sums of squares (phase B), the norm's factors, the
  // last-block flag, the mbarriers
  L.slotb = A.g.wb > C.g.wb ? A.g.wb : C.g.wb;
  L.sbmax = A.g.fsb > C.g.fsb ? A.g.fsb : C.g.fsb;  // fs boxes; fb's go through the ring
  L.scales = ns * L.slotb;
  L.act = L.scales + 2 * L.sbmax;
  int actx = act_region(A, false, L.xgp_a);
  int e = act_region(Bp, true, L.xgp_b);
  L.part_b = L.xgp_b + align128(Bp.arb * 3 * B * 128 * 2);
  actx = e > actx ? e : actx;
  e = act_region(C, false, L.xgp_c);
  actx = e > actx ? e : actx;
  L.tval = L.act + actx;
  L.inv = L.tval + 4 * (nt_a > TR ? nt_a : TR) * 8;
  L.flag = L.inv + 4 * 8;
  L.bars = align128(L.flag + 16);
  const int smem = L.bars + 8 * (2 * ns + 3);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (il_family(cm, packed)) {
    case FAM_TERN: return ffn_launch_gw<FAM_TERN>(L, blocks, smem, s);
    case FAM_CODED: return ffn_launch_gw<FAM_CODED>(L, blocks, smem, s);
    case FAM_NIB: return ffn_launch_gw<FAM_NIB>(L, blocks, smem, s);
    default: return ffn_launch_gw<FAM_BYTE>(L, blocks, smem, s);
  }
}

}  // extern "C"
